"""The float64 clock's float64 arithmetic: the reference's sites against the
list the port keeps beside its plain step (CPU; traces only).

Under the float64 clock the JAX package switches jax's x64 mode on, which
widens more than the clock: unpinned draws and weak-typed promotions turn
float64 too.  This walks ``jax.make_jaxpr`` of ``Engine._step`` (a
heuristic, the eco sites' hour and chsac_af's acting step),
``WorkloadProgram.tables`` and ``init_clocks``, and ``sac_train_step``
inside ``jax.enable_x64(True)``, collects every equation whose output is
float64 (container primitives recursed into, data movement skipped) as
(primitive, the innermost frame outside jax), and holds the set equal to
``sim/step.py``'s tables (``X64_STEP`` and the rest), so a float64 site the
port does not handle is named here.  ``replay_add_chunk`` (B6a's reference)
has none.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jcore

from distributed_cluster_gpus_tpu.configs import build_duo_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.rl import cmdp as jcmdp
from distributed_cluster_gpus_tpu.rl import replay as jreplay
from distributed_cluster_gpus_tpu.rl import sac as jsac
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu_torch.sim import step as tstep
from test_torch_rl_engine import standin_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
#: primitives that move or select data, or hold sub-programs (recursed)
SKIP = {"convert_element_type", "broadcast_in_dim", "reshape", "squeeze",
        "expand_dims", "concatenate", "slice", "dynamic_slice",
        "dynamic_update_slice", "gather", "scatter", "copy", "copy_p",
        "select_n", "transpose", "iota", "pad", "rev", "stop_gradient",
        "jit", "pjit", "cond", "scan", "while", "closed_call",
        "custom_jvp_call", "custom_vjp_call", "remat", "checkpoint"}


def _site(eqn):
    """file:line of the innermost frame outside jax (relative to the repo,
    or to site-packages for a library such as optax)."""
    tb = eqn.source_info.traceback
    for fr in (tb.frames if tb is not None else ()):
        fn = fr.file_name
        if "/jax/" in fn or "/jaxlib/" in fn:
            continue
        rel = fn.replace(REPO, "")
        if "site-packages" + os.sep in rel:
            rel = rel.split("site-packages" + os.sep)[1]
        return f"{rel}:{fr.line_num}"
    return None


def float64_sites(jaxpr, out=None):
    out = set() if out is None else out
    for eqn in jaxpr.eqns:
        for v in eqn.params.values():
            for j in (v if isinstance(v, (list, tuple)) else (v,)):
                if isinstance(j, jcore.ClosedJaxpr):
                    float64_sites(j.jaxpr, out)
                elif isinstance(j, jcore.Jaxpr):
                    float64_sites(j, out)
        if eqn.primitive.name in SKIP:
            continue
        if any(getattr(o.aval, "dtype", None) == jnp.float64 for o in eqn.outvars):
            out.add((eqn.primitive.name, _site(eqn)))
    return out


def _engine(algo, **kw):
    fj = build_duo_fleet()
    p = JParams(algo=algo, time_dtype="float64", job_cap=8, queue_cap=4,
                lat_window=16, **kw)
    pa = standin_jax(fj.n_dc, p.max_gpus_per_job) if algo == "chsac_af" else None
    eng = JEngine(fj, p, policy_apply=pa)
    s = jinit(jax.random.key(1), fj, p, workload=eng.workload)
    return eng, s


def _step_sites(algo, **kw):
    with jax.enable_x64(True):
        eng, s = _engine(algo, **kw)
        pre = eng.workload.tables(s, 8)
        return float64_sites(jax.make_jaxpr(
            lambda s: eng._step(s, None, pre=pre))(s).jaxpr)


S = tstep
PROGRAMS = {
    "joint_nf": (lambda: _step_sites("joint_nf"),
                 (S.X64_STEP, S.X64_HEURISTIC)),
    "cap_greedy": (lambda: _step_sites("cap_greedy", power_cap=900.0),
                   (S.X64_STEP, S.X64_HEURISTIC)),
    "eco_route": (lambda: _step_sites("eco_route", eco_objective="cost"),
                  (S.X64_STEP, S.X64_HEURISTIC, S.X64_HOUR)),
    "chsac_af": (lambda: _step_sites("chsac_af"), (S.X64_STEP, S.X64_RL)),
}


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_step_sites_match(program):
    walk, tables = PROGRAMS[program]
    got = walk()
    want = tstep.x64_sites(*tables)
    assert got - want == set(), "float64 sites the port does not list"
    assert want - got == set(), "listed sites the reference no longer has"


def test_workload_sites_match():
    with jax.enable_x64(True):
        eng, s = _engine("default_policy")
        tab = float64_sites(jax.make_jaxpr(
            lambda s: eng.workload.tables(s, 8))(s).jaxpr)
        ini = float64_sites(jax.make_jaxpr(
            lambda k: eng.workload.init_clocks(k, jnp.float64))(
                jax.random.key(3)).jaxpr)
    assert tab == tstep.x64_sites(tstep.X64_TABLES)
    assert ini == tstep.x64_sites(tstep.X64_INIT_CLOCKS)


def test_update_sites_match():
    n_dc, n_g, obs = 2, 4, 13
    cfg = jsac.SACConfig(obs_dim=obs, n_dc=n_dc, n_g=n_g, n_quantiles=8,
                         latent=32, batch=8,
                         constraints=jcmdp.default_constraints(500.0))
    with jax.enable_x64(True):
        sac = jsac.sac_init(cfg, jax.random.key(6))
        rb = jreplay.replay_init(64, obs, n_dc, n_g, 4)
        upd = float64_sites(jax.make_jaxpr(
            lambda sc, r, k: jsac.sac_train_step(cfg, sc, r, k))(
                sac, rb, jax.random.key(4)).jaxpr)
        z = lambda shape, dt: jnp.zeros(shape, dt)  # noqa: E731
        tr = {"valid": jnp.ones(16, bool), "s0": z((16, obs), jnp.float32),
              "s1": z((16, obs), jnp.float32), "a_dc": z(16, jnp.int32),
              "a_g": z(16, jnp.int32), "r": z(16, jnp.float32),
              "costs": z((16, 4), jnp.float32), "mask_dc": jnp.ones((16, n_dc), bool),
              "mask_g": jnp.ones((16, n_g), bool),
              "mask_dc0": jnp.ones((16, n_dc), bool),
              "mask_g0": jnp.ones((16, n_g), bool)}
        ing = float64_sites(jax.make_jaxpr(jreplay.replay_add_chunk)(rb, tr).jaxpr)
    assert upd == tstep.x64_sites(tstep.X64_UPDATE)
    assert ing == set()
    # every listed site names the port's code that computes it
    for t in (tstep.X64_STEP, tstep.X64_HEURISTIC, tstep.X64_HOUR, tstep.X64_RL,
              tstep.X64_TABLES, tstep.X64_INIT_CLOCKS, tstep.X64_UPDATE):
        assert all(np.all([isinstance(p, str) for p in prims]) and where
                   for prims, where in t.values())
