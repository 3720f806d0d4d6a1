"""The power-cap controllers and the power cap's other readers (CPU).

* ``cap_uniform`` and ``cap_greedy``: the port's plain step against the JAX
  engine's scan with the reference's arrival tables, bitwise over two
  chunks (``tests/test_torch_algos.py``'s harness), at caps low enough that
  a controller iterates more than once in a log tick, and cap_greedy meets
  atoms of equal rho (identical jobs), which the first job-major atom wins.
* The port's CLI with ``--algo cap_greedy --power-cap`` writes
  ``job_log.csv`` and ``cluster_log.csv`` byte for byte as the JAX run loop
  does with the JAX CLI's parameters for the same command line, the
  reference's arrival tables injected.
* ``chsac_af --power-cap``: the CMDP's power target is the cap (the JAX
  CLI's rule: ``--power-cap-constraint`` unset), and the Lagrange
  multipliers it drives follow the JAX package's.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_single_dc_fleet
from distributed_cluster_gpus_tpu.rl import cmdp as jcmdp
from distributed_cluster_gpus_tpu.rl import train as jtrain
from distributed_cluster_gpus_tpu_torch import bridge, run_sim
from distributed_cluster_gpus_tpu_torch.rl import cmdp as tcmdp
from distributed_cluster_gpus_tpu_torch.rl import train as ttrain

from test_torch_algos import _leaf, _port_fields, run_both
from test_torch_rl_learn_ops import LAM_ULP, _ulps
from test_torch_slice import _jax_run_with_tables, _read

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP_CASES = {
    # the duo fleet's 32 GPUs draw ~4.5-6 kW under this load
    "cap_uniform/duo": ("cap_uniform", "duo", dict(power_cap=4000.0)),
    "cap_greedy/duo": ("cap_greedy", "duo", dict(power_cap=4000.0)),
    "cap_greedy/single": ("cap_greedy", "single", dict(power_cap=12000.0)),
}


@pytest.mark.parametrize("case", list(CAP_CASES))
def test_cap_chunks_bit_identical(case):
    algo, fleet_name, extra = CAP_CASES[case]
    sj, st, ems, eng_t = run_both(algo, fleet_name, extra, False)
    pt = bridge.state_to_numpy(st)
    jt = _port_fields(bridge.tree_to_numpy(sj, _leaf), pt)
    assert bridge.tree_mismatches(jt, pt) == []
    for em_j, em_t in ems:
        assert bridge.tree_mismatches(em_j, em_t) == []
    # the controller ran, and more than once in some tick
    assert 0 < eng_t.ctl_ticks < eng_t.ctl_iters
    if algo == "cap_greedy":
        assert eng_t.ctl_ties > 0


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_run_sim", os.path.join(REPO, "run_sim.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_cap_greedy_byte_identical(tmp_path):
    argv = ["--algo", "cap_greedy", "--single-dc", "--duration", "15",
            "--log-interval", "3", "--seed", "4", "--inf-rate", "40",
            "--power-cap", "8000", "--chunk-steps", "256"]
    jcli = _jax_cli()
    ja = jcli.parse_args(argv + ["--out", str(tmp_path / "jax")])
    fj = build_single_dc_fleet()
    jp = jcli.finalize_queue_cap(jcli.build_params(ja), fj)
    port_argv = argv + ["--device", "cpu", "--quiet", "--out",
                        str(tmp_path / "port")]
    a = run_sim.parse_args(port_argv)
    params = run_sim.finalize_queue_cap(run_sim.build_params(a),
                                        bridge.fleet_from_numpy(fj))
    for f in dataclasses.fields(params):
        assert getattr(params, f.name) == getattr(jp, f.name), f.name
    sj, pre = _jax_run_with_tables(fj, jp, str(tmp_path / "jax"))
    st = run_sim.main(port_argv, pre_tables=pre)
    for name in ("job_log.csv", "cluster_log.csv"):
        assert _read(tmp_path / "jax" / name) == _read(tmp_path / "port" / name)
    assert int(st.n_finished.sum()) == int(np.asarray(sj.n_finished).sum()) > 0


def test_chsac_power_cap_reaches_the_cmdp():
    """``--algo chsac_af --power-cap 900`` through both CLIs' parameters and
    ``make_agent``: the CMDP's targets agree and the power target is the
    cap; 20 Lagrange updates on seeded cost batches (power around the cap)
    keep lambda within ``LAM_ULP`` ulp of the JAX package's, lambda for
    power rising from 0."""
    argv = ["--algo", "chsac_af", "--power-cap", "900", "--single-dc"]
    jcli = _jax_cli()
    jp = jcli.build_params(jcli.parse_args(argv))
    params = run_sim.build_params(run_sim.parse_args(argv + ["--device", "cpu"]))
    assert params.power_cap == jp.power_cap == 900.0
    assert params.power_cap_constraint is None
    fj = build_single_dc_fleet()
    cons_j = jtrain.make_agent(fj, jp).cfg.constraints
    cons_t = ttrain.make_agent(bridge.fleet_from_numpy(fj), params,
                               device="cpu").cfg.constraints
    assert [c.target for c in cons_t] == [c.target for c in cons_j]
    assert cons_t[1].name == "power" and cons_t[1].target == 900.0
    st_j, st_t = jcmdp.cmdp_init(cons_j), tcmdp.cmdp_init(cons_t, device="cpu")
    gains = tcmdp._gains(cons_t, device="cpu")
    upd_j = jax.jit(lambda s, c: jcmdp.update_lagrange(s, cons_j, c))
    rng = np.random.default_rng(3)
    lams = []
    for _ in range(20):
        costs = np.stack([rng.uniform(50, 400, 64), rng.uniform(700, 1300, 64),
                          rng.integers(0, 3, 64), rng.uniform(1e5, 1e6, 64)],
                         -1).astype(np.float32)
        st_j, err_j = upd_j(st_j, jnp.asarray(costs))
        st_t, err_t = tcmdp.update_lagrange(st_t, gains, torch.from_numpy(costs))
        for x, y in ((st_j.lam, st_t.lam), (st_j.integral, st_t.integral),
                     (err_j, err_t)):
            assert _ulps(np.asarray(x), y.numpy()).max() <= LAM_ULP
        lams.append(float(st_t.lam[1]))
    assert lams[-1] > lams[0] > 0
