"""``run_sim --workload`` against the JAX package's run loop (CPU).

* With the reference's arrival tables injected chunk by chunk (as
  ``tests/test_torch_slice.py`` does), the port's CLI with ``--workload
  flash_crowd`` and with a JSON spec (a replayed trace with sizes, a rate
  timeline and price/carbon timelines) writes ``job_log.csv`` and the
  16-column ``cluster_log.csv`` byte for byte as the JAX package's
  ``run_simulation`` does with the JAX CLI's parameters, through the
  pipelined loop (one handoff to the CSV drain a chunk).
* The native writer's 16-column rows equal the JAX package's Python rows
  and the port's Python renderer, byte for byte.
* ``--workload-observe`` without ``--workload``, an unknown preset and a
  spec without signals under ``--workload-observe`` are refused with the
  reference's messages; the observed width reaches the card's envelope.
* A chsac_af run with observed signal timelines, stopped after its first
  updating chunk and resumed from its checkpoint, ends byte for byte and
  leaf for leaf (``signals.cost_usd`` and ``carbon_g`` included) as the
  uninterrupted run.
Tolerance: none (bytes and bits).
"""

import dataclasses
import importlib.util
import json
import os
import signal

import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_single_dc_fleet
from distributed_cluster_gpus_tpu.sim.io import CSVWriters as JWriters
from distributed_cluster_gpus_tpu_torch import bridge, run_sim
from distributed_cluster_gpus_tpu_torch.sim.io import CSVWriters as TWriters
from test_torch_slice import CHUNK, _jax_run_with_tables, _read

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = {
    "name": "trace_and_timeline",
    "streams": {
        "inference": {"kind": "trace",
                      "times": np.round(np.cumsum(np.random.RandomState(2)
                                                  .exponential(0.02, 600)),
                                        4).tolist(),
                      "sizes": np.random.RandomState(3)
                      .uniform(1.0, 40.0, 600).round(3).tolist()},
        "training": {"kind": "rate_timeline", "rates": [0.5, 0.0, 2.0],
                     "bin_s": 2.5, "periodic": True}},
    "signals": {"price": [0.11, 0.0, 0.27, 0.19],
                "carbon": [[310.0], [0.0], [520.0]], "bin_s": 1.5,
                "periodic": True},
}


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_run_sim", os.path.join(REPO, "run_sim.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _argv(workload, out, seed=4):
    return ["--algo", "carbon_cost", "--single-dc", "--duration", "40",
            "--log-interval", "0.2", "--seed", str(seed), "--chunk-steps",
            str(CHUNK), "--workload", workload, "--quiet", "--out", out]


@pytest.mark.parametrize("which", ["flash_crowd", "spec"])
def test_cli_csvs_byte_identical(which, tmp_path, monkeypatch):
    from distributed_cluster_gpus_tpu_torch.sim import io as tio

    workload = which
    if which == "spec":
        workload = str(tmp_path / "spec.json")
        with open(workload, "w") as f:
            json.dump(SPEC, f)
    handoffs = []
    submit = tio.AsyncCSVDrain.submit
    monkeypatch.setattr(tio.AsyncCSVDrain, "submit",
                        lambda self, em: (handoffs.append(1),
                                          submit(self, em)))
    jcli = _jax_cli()
    fj = build_single_dc_fleet()
    a = jcli.parse_args(_argv(workload, str(tmp_path / "jax")))
    pj = jcli.build_params(a)
    pj = dataclasses.replace(pj, workload=jcli.build_workload_spec(a, fj, pj))
    pj = jcli.finalize_queue_cap(pj, fj)
    sj, pre = _jax_run_with_tables(fj, pj, str(tmp_path / "jax"))
    argv = _argv(workload, str(tmp_path / "port")) + ["--device", "cpu"]
    params = run_sim.build_params(run_sim.parse_args(argv))
    assert params.workload is not None and params.queue_cap == 0
    st = run_sim.main(argv, pre_tables=pre)
    for name in ("job_log.csv", "cluster_log.csv"):
        a_, b_ = _read(tmp_path / "jax" / name), _read(tmp_path / "port" / name)
        assert a_.count(b"\n") > 10, name
        assert a_ == b_, name
    header = _read(tmp_path / "port" / "cluster_log.csv").split(b"\r\n")[0]
    assert header.endswith(b"price_usd_kwh,carbon_g_kwh")
    assert bridge.tree_mismatches(
        {k: np.asarray(getattr(sj.signals, k)) for k in ("cost_usd", "carbon_g")},
        {k: getattr(st.signals, k).numpy() for k in ("cost_usd", "carbon_g")}) == []
    assert float(st.signals.cost_usd.sum()) > 0.0
    assert len(handoffs) == len(pre) - 1 >= 2  # one handoff a chunk
    # the summary row and run_summary.json carry the totals
    from distributed_cluster_gpus_tpu.evaluation import _summarize as js
    from distributed_cluster_gpus_tpu_torch.evaluation import _summarize as ts

    rj, rt = js("carbon_cost", fj, sj).row(), ts("carbon_cost", fj, st).row()
    for k in ("energy_cost_usd", "carbon_kg"):
        assert rj[k] == rt[k], k


def test_native_writer_sixteen_columns(tmp_path):
    fleet = build_single_dc_fleet()
    ft = bridge.fleet_from_numpy(fleet)
    g = np.random.RandomState(5)
    rows = g.uniform(-5.0, 3e5, (7, ft.n_dc, 16)).astype(np.float32)
    rows[..., 14] = g.choice([0.0, 0.12345, 0.00005, 0.99995, 1e-7], (7, 1))
    rows[..., 15] = g.choice([0.0, -0.0, 412.345, 0.005, 2.5e5], (7, 1))
    rows[..., 2:9] = np.floor(rows[..., 2:9])
    idx = [0, 2, 3, 6]
    outs = {}
    for name, w in (("native", TWriters(str(tmp_path / "n"), ft, signal_cols=True)),
                    ("plain", TWriters(str(tmp_path / "p"), ft, plain=True,
                                       signal_cols=True)),
                    ("jax", JWriters(str(tmp_path / "j"), fleet,
                                     signal_cols=True, use_native=False))):
        w.write_cluster_chunk(rows, idx)
        outs[name] = _read(w.cluster_path)
    assert outs["native"] == outs["plain"] == outs["jax"]
    assert outs["native"].count(b"\r\n") == 1 + len(idx) * ft.n_dc


def _jax_refusal(jcli, argv, fleet):
    a = jcli.parse_args(argv)
    with pytest.raises(SystemExit) as e:
        jcli.build_workload_spec(a, fleet, jcli.build_params(a))
    return str(e.value.code)


def test_refusals_have_the_reference_messages(tmp_path):
    jcli = _jax_cli()
    fj = build_single_dc_fleet()
    no_sig = tmp_path / "nosig.json"
    no_sig.write_text(json.dumps({"streams": {"inference": {"kind": "poisson",
                                                            "rate": 1.0}}}))
    for extra in (["--workload-observe"], ["--workload", "diurnal"],
                  ["--workload", str(no_sig), "--workload-observe"]):
        argv = ["--single-dc", "--algo", "chsac_af", *extra]
        want = _jax_refusal(jcli, argv, fj)
        with pytest.raises(SystemExit) as e:
            run_sim.build_params(run_sim.parse_args(argv + ["--device", "cpu"]))
        assert str(e.value.code) == want, extra
    # the observed width: 58 on the paper fleet, inside B1's RL envelope
    a = run_sim.parse_args(["--algo", "chsac_af", "--workload",
                            "diurnal_flash_week", "--device", "cpu"])
    p = run_sim.build_params(a)
    assert p.signals_observed and p.obs_dim(8) == 58
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_fleet
    from distributed_cluster_gpus_tpu_torch.kernels.envelope import card_limits

    assert card_limits(build_fleet(), p) is None


def test_signal_run_resumes_byte_for_byte(tmp_path):
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_duo_fleet
    from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
    from distributed_cluster_gpus_tpu_torch.rl.train import train_chsac
    from distributed_cluster_gpus_tpu_torch.utils.shutdown import ShutdownFlag
    from distributed_cluster_gpus_tpu_torch.workload import workload_from_dict
    from test_torch_signals_engine import SHORT

    streams = dict(SHORT["streams"], inference=dict(
        SHORT["streams"]["inference"], rates=[30.0, 0.0, 50.0, 20.0]))
    spec = workload_from_dict(dict(SHORT, streams=streams, signals=dict(
        SHORT["signals"], observe=True)))
    fleet = build_duo_fleet()
    params = SimParams(algo="chsac_af", duration=2.0, log_interval=0.25,
                       job_cap=48, queue_cap=8, lat_window=64, seed=21,
                       rl_warmup=24, rl_batch=8, rl_buffer=128, workload=spec)

    def run(out, ckpt=None, shutdown=None, on_chunk=None):
        return train_chsac(fleet, params, out_dir=str(tmp_path / out),
                           chunk_steps=48, max_train_steps_per_chunk=3,
                           device="cpu", ckpt_dir=ckpt, ckpt_every_chunks=1,
                           shutdown=shutdown, on_chunk=on_chunk)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small runs: Python's overhead, not the cores
    try:
        full, agent_full, _ = run("full")
        flag = ShutdownFlag()

        def stop(chunk, state, history):
            if history:
                flag.trip(signal.SIGTERM)

        ck = str(tmp_path / "ck")
        run("part", ck, flag, stop)
        resumed, agent_res, _ = run("part", ck)
    finally:
        torch.set_num_threads(threads)
    for name in ("job_log.csv", "cluster_log.csv"):
        assert _read(tmp_path / "full" / name) == _read(tmp_path / "part" / name)
    assert bridge.tree_mismatches(bridge.state_to_numpy(full),
                                  bridge.state_to_numpy(resumed)) == []
    assert "signals" in bridge.state_to_numpy(resumed)
    assert agent_full.sac.step == agent_res.sac.step > 0
    assert float(resumed.signals.carbon_g.sum()) > 0.0
