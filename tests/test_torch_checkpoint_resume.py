"""A stopped and resumed ``train_chsac`` run against the same run left
uninterrupted: the port against itself, on the plain path (CPU).

For each clock (float32, and float64 with the reference's x64 numerics) the
duo fleet's chsac_af run is made three ways from one seed: uninterrupted;
stopped by a tripped shutdown flag after its first updating chunk (a
checkpoint every chunk); and resumed from that store.  The resumed run's
``job_log.csv`` and ``cluster_log.csv`` must be byte for byte the
uninterrupted run's, and its final SimState, learner (``sac_to_numpy``:
parameters, target, temperature, Adam states, CMDP state, step), replay
ring (rows, ``valid``, ``ptr``, ``size``, ``n_seen``) and agent key bitwise
equal.  Updates run on both sides of the restore.  On the float32 clock a
second resume starts from a store whose newest step is corrupt: the
verified fallback chain restores the step before it (before the warm-up
ended), the CSVs are truncated back to that step's watermark, and the run
still ends byte for byte the same.  A store another configuration wrote
(the float32 one, read by a float64 run) or whose steps all fail
verification is refused: the run never carries on from a fresh state.
"""

import json
import os
import shutil
import signal

import pytest
import torch

from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.configs.paper import build_duo_fleet
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.rl.train import train_chsac
from distributed_cluster_gpus_tpu_torch.utils.checkpoint import (
    latest_step, step_dirname, steps)
from distributed_cluster_gpus_tpu_torch.utils.shutdown import ShutdownFlag

CHUNK = 48
MAX_UPDATES = 4
#: four chunks; the warm-up ends in chunk 1, which updates, as do 2 and 3
RUN = dict(algo="chsac_af", duration=2.0, log_interval=0.25, job_cap=48,
           queue_cap=8, lat_window=64, seed=21, inf_rate=15.0, trn_rate=2.0,
           rl_warmup=24, rl_batch=8, rl_buffer=128)
CSVS = ("cluster_log.csv", "job_log.csv")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's runs are small and bound by Python's overhead: one
    torch thread each, so that the suite's parallel workers do not
    oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(clock):
    return SimParams(time_dtype=clock, **RUN)


def _run(fleet, params, out, ckpt=None, shutdown=None, on_chunk=None):
    return train_chsac(fleet, params, out_dir=out, chunk_steps=CHUNK,
                       max_train_steps_per_chunk=MAX_UPDATES, device="cpu",
                       ckpt_dir=ckpt, ckpt_every_chunks=1, shutdown=shutdown,
                       on_chunk=on_chunk)


def _leaves(state, agent):
    return {"sim": bridge.state_to_numpy(state),
            "sac": bridge.sac_to_numpy(agent.cfg, agent.sac),
            "replay": bridge.replay_to_numpy(agent.replay),
            "key": agent.key.numpy()}


_RUNS = {}


def _three_runs(clock, tmp_path_factory):
    """The clock's uninterrupted, stopped and resumed runs (once a module)."""
    if clock not in _RUNS:
        _RUNS[clock] = _make_runs(clock, tmp_path_factory)
    return _RUNS[clock]


@pytest.fixture(scope="module", params=["float32", "float64"])
def runs(request, tmp_path_factory):
    return _three_runs(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def runs32(tmp_path_factory):
    return _three_runs("float32", tmp_path_factory)


def _make_runs(clock, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"resume_{clock}")
    fleet, params = build_duo_fleet(), _params(clock)
    full = _run(fleet, params, str(d / "full"))
    flag = ShutdownFlag()

    def stop_after_first_update(chunk, state, history):
        if history:
            flag.trip(signal.SIGTERM)

    stopped = _run(fleet, params, str(d / "part"), str(d / "ck"), flag,
                   stop_after_first_update)
    stop_chunk = latest_step(str(d / "ck"), verified=True)
    summary = json.load(open(d / "part" / "run_summary.json"))
    if clock == "float32":  # the fallback chain's resume, set up before
        shutil.copytree(d / "part", d / "part_fb")
        shutil.copytree(d / "ck", d / "ck_fb")
    resumed = _run(fleet, params, str(d / "part"), str(d / "ck"))
    return dict(clock=clock, d=d, fleet=fleet, params=params, full=full,
                stopped=stopped, resumed=resumed, stop_chunk=stop_chunk,
                stop_summary=summary)


def test_resumed_csvs_are_byte_for_byte_the_uninterrupted_ones(runs):
    d = runs["d"]
    for name in CSVS:
        a, b = (d / "full" / name).read_bytes(), (d / "part" / name).read_bytes()
        assert a.count(b"\n") > 15, name
        assert a == b, name


def test_resumed_leaves_are_bitwise_the_uninterrupted_ones(runs):
    (sf, af, _), (sr, ar, _) = runs["full"], runs["resumed"]
    assert bool(sf.done) and bool(sr.done)
    assert bridge.tree_mismatches(_leaves(sf, af), _leaves(sr, ar)) == []
    if runs["clock"] == "float64":
        assert sr.t.dtype == sr.dc.energy_j.dtype == sr.arr_cum.dtype \
            == sr.jobs.t_start.dtype == sr.queues.recs.dtype == torch.float64


def test_updates_ran_on_both_sides_of_the_restore(runs):
    (_, a_stop, h_stop), (_, a_res, h_res) = runs["stopped"], runs["resumed"]
    assert a_stop.sac.step > 0, "no update before the stop"
    assert a_res.sac.step > a_stop.sac.step and h_res, "no update after it"
    assert runs["stop_chunk"] is not None
    assert runs["stop_summary"]["status"] == "interrupted"
    rs = json.load(open(runs["d"] / "part" / "run_summary.json"))
    assert rs["status"] == "completed"
    assert rs["n_events"] == int(runs["full"][0].n_events)


def test_fallback_past_a_corrupt_newest_step_restores_the_one_before(runs32):
    """The newest step's payload corrupted: the resume restores the step
    before (the warm-up not yet over there), truncates the CSVs to its
    watermark and re-runs the chunk; the end is byte for byte the same."""
    runs = runs32
    d = runs["d"]
    store = d / "ck_fb"
    newest = steps(str(store))[-1]
    with open(store / step_dirname(newest) / "sac.npz", "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    before = latest_step(str(store), verified=True)
    assert before == newest - 1
    state, agent, _ = _run(runs["fleet"], runs["params"], str(d / "part_fb"),
                           str(store))
    sf, af, _ = runs["full"]
    for name in CSVS:
        assert (d / "full" / name).read_bytes() == \
            (d / "part_fb" / name).read_bytes(), name
    assert bridge.tree_mismatches(_leaves(sf, af), _leaves(state, agent)) == []


def test_another_configurations_store_is_refused(runs32, tmp_path):
    """A float64 run does not restore the float32 run's store (the params
    fingerprint differs in ``time_dtype``), and a store whose committed
    steps all fail verification is refused, not read as empty."""
    runs = runs32
    d = runs["d"]
    with pytest.raises(RuntimeError, match="another configuration.*float64"):
        _run(runs["fleet"], _params("float64"), str(tmp_path / "o"),
             str(d / "ck"))
    bad = tmp_path / "bad"
    shutil.copytree(d / "ck", bad)
    for s in steps(str(bad)):
        os.remove(bad / step_dirname(s) / "COMMIT")
    with pytest.raises(RuntimeError, match="none of its .* committed steps"):
        _run(runs["fleet"], runs["params"], str(tmp_path / "o2"), str(bad))
