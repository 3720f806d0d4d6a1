"""The float64 clock through the CLI and across rollout lanes (CPU).

* ``--time-dtype`` resolves as the reference's CLI resolves it: ``auto`` is
  float64 above 1e5 simulated seconds and float32 at or below.
* One ``--time-dtype float64`` run of the port's CLI (single-DC fleet)
  writes ``job_log.csv`` and ``cluster_log.csv`` byte for byte as the JAX
  CLI does with the same flags, given the JAX run's arrival tables.  The
  JAX CLI's ``build_params`` switches jax's x64 mode on for its whole
  process, so the JAX side runs in a subprocess of its own.
* R = 3 lanes of the port's lane-stacked engine under the float64 clock
  against ``jax.jit(jax.vmap(Engine._run_chunk))`` under x64, over two
  chunks of the reference's tables: every lane's state and emissions
  bitwise.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet, build_single_dc_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.parallel.rollout import batched_init as jbatched_init
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu_torch import bridge, run_sim
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams, n_lanes
from distributed_cluster_gpus_tpu_torch.sim.engine import Engine
from test_torch_rollout import LOAD, _leaf, _port_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 256


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_run_sim", os.path.join(REPO, "run_sim.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("given", ["auto", "float32", "float64"])
def test_time_dtype_resolves_as_the_reference(given):
    jcli = _jax_cli()
    for duration in (60.0, 1e5, 100000.5, 2e5, 604800.0):
        argv = ["--duration", str(duration), "--time-dtype", given]
        want = jcli.resolve_time_dtype(jcli.parse_args(argv))
        a = run_sim.parse_args(argv + ["--device", "cpu"])
        assert run_sim.resolve_time_dtype(a) == want, (given, duration)
        assert run_sim.build_params(a).time_dtype == want
        assert run_sim.build_params(a).x64 == (want == "float64")
    # the default is auto
    assert run_sim.build_params(run_sim.parse_args(["--duration", "2e5"])).x64


#: the JAX CLI's parameters and run, with each chunk's tables recorded
#: (test_torch_slice._jax_run_with_tables), in a process of its own
JAX_SIDE = r"""
import importlib.util, json, os, sys
import numpy as np
repo, out, argv = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, repo)
sys.path.insert(0, os.path.join(repo, "tests"))
import jax
jax.config.update("jax_platforms", "cpu")
spec = importlib.util.spec_from_file_location(
    "jax_run_sim", os.path.join(repo, "run_sim.py"))
jcli = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jcli)
from distributed_cluster_gpus_tpu.configs import build_single_dc_fleet
from test_torch_slice import _jax_run_with_tables
fj = build_single_dc_fleet()
a = jcli.parse_args(argv + ["--out", os.path.join(out, "jax")])
p = jcli.finalize_queue_cap(jcli.build_params(a), fj)
sj, pre = _jax_run_with_tables(fj, p, os.path.join(out, "jax"))
np.savez(os.path.join(out, "tables.npz"), **{
    f"{c}/{k}": np.asarray(v) for c, t in enumerate(pre) for k, v in t.items()})
print(json.dumps({"time_dtype": p.time_dtype, "queue_cap": p.queue_cap,
                  "x64": bool(jax.config.jax_enable_x64),
                  "n_finished": int(np.asarray(sj.n_finished).sum()),
                  "t": str(np.asarray(sj.t).dtype)}))
"""


def test_cli_float64_byte_identical(tmp_path):
    argv = ["--algo", "joint_nf", "--single-dc", "--duration", "15",
            "--log-interval", "3", "--seed", "4", "--time-dtype", "float64",
            "--chunk-steps", str(CHUNK)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", JAX_SIDE, REPO, str(tmp_path),
                          json.dumps(argv)], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert info["time_dtype"] == "float64" and info["x64"] and info["t"] == "float64"
    with np.load(tmp_path / "tables.npz") as z:
        n_chunks = 1 + max(int(k.split("/")[0]) for k in z.files)
        pre = [{k.split("/")[1]: z[k] for k in z.files
                if int(k.split("/")[0]) == c} for c in range(n_chunks)]
    port_argv = argv + ["--device", "cpu", "--quiet", "--out",
                        str(tmp_path / "port")]
    params = run_sim.finalize_queue_cap(
        run_sim.build_params(run_sim.parse_args(port_argv)),
        bridge.fleet_from_numpy(build_single_dc_fleet()))
    assert params.time_dtype == "float64" and params.queue_cap == info["queue_cap"]
    st = run_sim.main(port_argv, pre_tables=pre)
    assert st.t.dtype == torch.float64
    for name in ("job_log.csv", "cluster_log.csv"):
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert a.count(b"\n") > 5, name
        assert a == b, name
    assert int(st.n_finished.sum()) == info["n_finished"] > 0


def test_float64_lanes_bit_identical_to_jax_vmap():
    R, n_steps = 3, 200
    fj = build_duo_fleet()
    kw = dict(LOAD, algo="joint_nf", time_dtype="float64")
    with jax.enable_x64(True):
        eng_j = JEngine(fj, JParams(**kw))
        sj = jbatched_init(fj, eng_j.params, R, workload=eng_j.workload)
        run_j = jax.jit(jax.vmap(lambda s: eng_j._run_chunk(s, None, n_steps)))
        tables_j = jax.jit(jax.vmap(lambda s: eng_j.workload.tables(s, n_steps)))
        eng_t = Engine(bridge.fleet_from_numpy(fj), SimParams(**kw), device="cpu")
        st = bridge.state_from_numpy(bridge.tree_to_numpy(sj, _leaf), "cpu")
        assert n_lanes(st) == R and st.t.dtype == torch.float64
        for _ in range(2):
            pre = tables_j(sj)
            sj, em_j = run_j(sj)
            st, em_t = eng_t.run_chunk(
                st, n_steps,
                pre={k: torch.from_numpy(np.array(v)) for k, v in pre.items()})
            em_j = {k: np.asarray(v) for k, v in em_j.items()}
            em_t = {k: v.numpy() for k, v in em_t.items()}
            assert bridge.tree_mismatches(em_j, em_t) == []
        pt = bridge.state_to_numpy(st)
        jt = _port_fields(bridge.tree_to_numpy(sj, _leaf), pt)
    assert jt["t"].dtype == np.float64
    for r in range(R):
        assert bridge.tree_mismatches(bridge.tree_lane(jt, r),
                                      bridge.tree_lane(pt, r)) == [], r
    assert (st.queues.head.sum((1, 2)) > 0).all()
    assert len({int(x) for x in st.jid_counter}) > 1
