"""The port's whole slice against the JAX package's run loop (CPU).

* With the reference's own arrival tables injected chunk by chunk, the
  port's ``run_simulation`` (duo fleet) and its CLI (``run_sim --single-dc
  --device cpu``) write ``job_log.csv`` and ``cluster_log.csv`` byte for byte
  as the JAX ``run_simulation`` does.
* With the port's own tables (torch samplers, ulp-level differences; see
  ``tests/test_torch_ops.py``) the same run realizes the same arrival counts
  per stream, the same completions and drops, and ``_summarize`` agrees
  within 1e-4 relative (energy, latency means and p99s, energy per unit).
* Importing the port pulls in neither JAX nor the JAX package, and asking
  for CUDA where there is no GPU raises instead of running on the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet, build_single_dc_fleet
from distributed_cluster_gpus_tpu.evaluation import _summarize as j_summarize
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu.sim.io import run_simulation as j_run
from distributed_cluster_gpus_tpu_torch import bridge, run_sim
from distributed_cluster_gpus_tpu_torch.evaluation import _summarize as t_summarize
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.sim.engine import Engine
from distributed_cluster_gpus_tpu_torch.sim.io import run_simulation as t_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 256
DUO = dict(duration=25.0, log_interval=2.0, job_cap=32, queue_cap=256,
           lat_window=128, seed=9)


def _jax_run_with_tables(fleet, params, out_dir):
    """The JAX run loop, recording the arrival tables each chunk consumes.

    Each chunk's tables are a pure function of the state entering it, so
    they are regenerated (same jitted function) from the initial state and
    from every state the loop hands to ``on_chunk``."""
    eng = JEngine(fleet, params)
    tables = jax.jit(lambda s: eng.workload.tables(s, CHUNK))
    s0 = jinit(jax.random.key(params.seed), fleet, params, workload=eng.workload)
    recorded = [jax.device_get(tables(s0))]

    def hook(state, _emissions):
        recorded.append(jax.device_get(tables(state)))

    state = j_run(fleet, params, out_dir=out_dir, chunk_steps=CHUNK,
                  on_chunk=hook, state0=s0)
    return state, recorded


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def duo_runs(tmp_path_factory):
    """JAX and port runs of the same duo-fleet config, per algo."""
    out = {}
    for algo in ("default_policy", "joint_nf"):
        d = tmp_path_factory.mktemp(algo)
        fj = build_duo_fleet()
        sj, pre = _jax_run_with_tables(fj, JParams(algo=algo, **DUO), str(d / "jax"))
        ft = bridge.fleet_from_numpy(fj)
        pt = SimParams(algo=algo, **DUO)
        st_inj = t_run(ft, pt, out_dir=str(d / "inj"), chunk_steps=CHUNK,
                       device="cpu", pre_tables=pre)
        st_own = t_run(ft, pt, out_dir=str(d / "own"), chunk_steps=CHUNK,
                       device="cpu")
        out[algo] = (d, fj, sj, st_inj, st_own)
    return out


@pytest.mark.parametrize("algo", ["default_policy", "joint_nf"])
def test_csvs_byte_identical_with_reference_tables(duo_runs, algo):
    d, _, sj, st, _ = duo_runs[algo]
    for name in ("job_log.csv", "cluster_log.csv"):
        a, b = _read(d / "jax" / name), _read(d / "inj" / name)
        assert a.count(b"\n") > 10, name
        assert a == b, name
    assert int(st.n_events) == int(sj.n_events)


@pytest.mark.parametrize("algo", ["default_policy", "joint_nf"])
def test_own_tables_same_arrivals_and_summary(duo_runs, algo):
    _, fj, sj, _, st = duo_runs[algo]
    assert np.asarray(sj.arr_count).tolist() == st.arr_count.tolist()
    assert int(sj.jid_counter) == int(st.jid_counter)
    a = j_summarize(algo, fj, sj).row()
    b = t_summarize(algo, fj, st).row()
    for k in ("completed_inf", "completed_trn", "dropped"):
        assert a[k] == b[k], k
    for k in ("energy_kwh", "mean_lat_inf_s", "p99_lat_inf_s",
              "energy_per_unit_wh"):
        assert abs(a[k] - b[k]) <= 1e-4 * abs(a[k]), k


def test_cli_single_dc_byte_identical(tmp_path):
    argv = ["--algo", "joint_nf", "--single-dc", "--duration", "15",
            "--log-interval", "3", "--seed", "4", "--chunk-steps", str(CHUNK),
            "--device", "cpu", "--quiet", "--out", str(tmp_path / "port")]
    a = run_sim.parse_args(argv)
    params = run_sim.finalize_queue_cap(run_sim.build_params(a),
                                        bridge.fleet_from_numpy(build_single_dc_fleet()))
    jp = JParams(**{f.name: getattr(params, f.name)
                    for f in dataclasses.fields(params)})
    sj, pre = _jax_run_with_tables(build_single_dc_fleet(), jp, str(tmp_path / "jax"))
    st = run_sim.main(argv, pre_tables=pre)
    for name in ("job_log.csv", "cluster_log.csv"):
        assert _read(tmp_path / "jax" / name) == _read(tmp_path / "port" / name)
    assert int(st.n_finished.sum()) == int(np.asarray(sj.n_finished).sum()) > 0


def test_cli_refuses_unported(capsys):
    for argv, item in ((["--algo", "ppo"], "item 10"),
                       (["--algo", "chsac_af", "--offline-steps", "10"], "item 10"),
                       (["--queue-mode", "slab"], "item 13"),
                       (["--workload", "diurnal"], "item 4"),
                       (["--faults-mtbf=3"], None),
                       (["--duration", "2e5", "--campaign", "c"], "item 15")):
        with pytest.raises(SystemExit) as e:
            run_sim.parse_args(argv)
        assert e.value.code == 2
        if item:
            assert item in capsys.readouterr().err


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import distributed_cluster_gpus_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "need = ['rl.train', 'rl.agent', 'rl.sac', 'rl.nets', 'rl.replay', "
        "'rl.cmdp', 'rl.optim', 'kernels.replay_ingest', 'kernels.event_scan', "
        "'kernels.sac_update', 'kernels.adam', 'kernels.replay_sample']\n"
        "assert all(p.__name__ + '.' + n in names for n in need), names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'distributed_cluster_gpus_tpu')]\n"
        "print(len(bad), sorted(bad)[:5])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout


def test_cuda_request_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be observed")
    fleet = bridge.fleet_from_numpy(build_duo_fleet())
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(fleet, SimParams(**DUO))
    with pytest.raises(RuntimeError, match="cuda"):
        run_sim.main(["--duration", "1", "--out", "unused-out-dir"])
