"""The port's chsac_af engine against ``Engine._run_chunk``, bit for bit (CPU).

Both engines start from the JAX ``init_state`` (carried by the bridge),
consume the reference's own arrival tables, and act through the SAME
deterministic stand-in ``policy_apply``: ``randint`` on the halves of the
step's action key (as the real policy's categorical draws split it), kept
when the mask allows it and the first feasible action otherwise.  So the
step's three-way key split, the policy tail (B3's windowed p99, the
observation, the masks, the reserve for training decisions), the tail plan
and ``_commit_tail`` run exactly as with the real policy, while every value
stays + - * / on float32 and int32.  The final ``SimState`` leaves (the
slab's RL trace included), every emission row (``rl`` included) and the
CSV bytes drained from them must be identical, over two chunks on the duo
and single-DC fleets, a duo case with the options off their defaults
(inference reserve, GPU cap, no inference priority, reward weight) and the
duo load at ``max_gpus_per_job`` 64 and 128 (GPU-count masks and actions
as wide as B1's RL mode now acts with).

One stated exception: the observation's two queue-length features are
``log1p(q) / 4``, and XLA's CPU ``log1p`` (its own ``log(1 + x)``
polynomial) differs from torch's by an ulp for some integers (q = 6 is one).
The leaves that carry observations (``jobs.rl_obs0``, ``rl.s0``,
``rl.s1``) are therefore held to 1 ulp (``OBS_ULP``); the stand-in policy
does not read them, so everything else stays bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet, build_single_dc_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.sim import io as jio
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.ops import prng
from distributed_cluster_gpus_tpu_torch.sim import io as tio
from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

N_STEPS = 300
N_CHUNKS = 2
#: ulp bound on observation-carrying leaves (see the module docstring)
OBS_ULP = 1
OBS_LEAVES = {"jobs": ("rl_obs0",), "rl": ("s0", "s1")}
FLEETS = {"duo": build_duo_fleet, "single": build_single_dc_fleet,
          "duo_options": build_duo_fleet, "duo_g64": build_duo_fleet,
          "duo_g128": build_duo_fleet}
LOADS = {
    # 2 x 16 GPUs under 300 inference and 40 training arrivals/s with a
    # 64-slot slab: the slab fills (arrivals drop), xfers find their DC full
    # and queue in 3-deep rings (which overflow), finishes drain the rings
    "duo": dict(inf_mode="poisson", inf_rate=300.0, trn_rate=40.0, job_cap=64,
                queue_cap=3, log_interval=0.02),
    # 128 GPUs under 3000 + 3000 arrivals/s: the GPUs fill, the rings queue
    "single": dict(inf_mode="poisson", inf_rate=3000.0, trn_rate=3000.0,
                   job_cap=160, queue_cap=8, log_interval=0.003),
    "duo_options": dict(inf_rate=300.0, inf_amp=0.9, inf_period=2.0,
                        trn_rate=40.0, job_cap=64, queue_cap=3,
                        log_interval=0.02, inf_priority=False,
                        reserve_inf_gpus=4, max_gpus_per_job=4,
                        sla_p99_ms=80.0, rl_energy_weight=2.5),
}
# the duo load with GPU-count heads wider than a DC (16 GPUs): rows of 64
# and 128 masks, most of them infeasible
for _n_g in (64, 128):
    LOADS[f"duo_g{_n_g}"] = dict(LOADS["duo"], max_gpus_per_job=_n_g)


def standin_jax(n_dc, n_g):
    def apply(_pp, obs, m_dc, m_g, key):
        k1, k2 = jax.random.split(key)
        r_dc = jax.random.randint(k1, (), jnp.int32(0), jnp.int32(n_dc),
                                  dtype=jnp.int32)
        r_g = jax.random.randint(k2, (), jnp.int32(0), jnp.int32(n_g),
                                 dtype=jnp.int32)
        a_dc = jnp.where(m_dc[r_dc], r_dc, jnp.argmax(m_dc).astype(jnp.int32))
        a_g = jnp.where(m_g[r_g], r_g, jnp.argmax(m_g).astype(jnp.int32))
        return a_dc, a_g
    return apply


def standin_port(n_dc, n_g):
    def apply(_pp, obs, m_dc, m_g, key):
        ks = prng.split(key, 2)
        r_dc = prng.randint(ks[0], n_dc).to(torch.int64)
        r_g = prng.randint(ks[1], n_g).to(torch.int64)
        a_dc = torch.where(m_dc[r_dc], r_dc, torch.argmax(m_dc.to(torch.int32)))
        a_g = torch.where(m_g[r_g], r_g, torch.argmax(m_g.to(torch.int32)))
        return a_dc.to(torch.int32), a_g.to(torch.int32)
    return apply


def _leaf(x):
    if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x))
    return np.asarray(x)


def _port_fields(jtree, ptree):
    if isinstance(ptree, dict):
        return {k: _port_fields(jtree[k], ptree[k]) for k in ptree}
    return jtree


@pytest.fixture(scope="module", params=list(LOADS))
def runs(request, tmp_path_factory):
    fleet_name = request.param
    fj = FLEETS[fleet_name]()
    kw = dict(algo="chsac_af", duration=400.0, lat_window=64, seed=3,
              **LOADS[fleet_name])
    pj = JParams(**kw)
    n_g = pj.max_gpus_per_job
    eng_j = JEngine(fj, pj, policy_apply=standin_jax(fj.n_dc, n_g))
    sj = jinit(jax.random.key(3), fj, pj, workload=eng_j.workload)

    def chunk(state, pre):
        s, em = jax.lax.scan(lambda s, _: eng_j._step(s, None, pre=pre),
                             state, None, length=N_STEPS)
        return eng_j.workload.advance_carries(s, pre), em

    chunk_j = jax.jit(chunk)
    tables_j = jax.jit(lambda s: eng_j.workload.tables(s, N_STEPS))
    eng_t = Engine(bridge.fleet_from_numpy(fj), SimParams(**kw), device="cpu",
                   policy_apply=standin_port(fj.n_dc, n_g))
    st = bridge.state_from_numpy(bridge.tree_to_numpy(sj, _leaf), "cpu")
    d = tmp_path_factory.mktemp(fleet_name)
    wj = jio.CSVWriters(str(d / "jax"), fj)
    wt = tio.CSVWriters(str(d / "port"), eng_t.fleet)
    ems = []
    for _ in range(N_CHUNKS):
        pre = tables_j(sj)
        sj, em_j = chunk_j(sj, pre)
        pre_t = {k: torch.from_numpy(np.array(v)) for k, v in pre.items()}
        st, em_t = eng_t.run_chunk(st, N_STEPS, pre=pre_t)
        em_j = jax.device_get(em_j)
        jio.drain_emissions(em_j, wj)
        tio.drain_emissions(em_t, wt)
        ems.append((bridge.tree_to_numpy(em_j),
                    bridge.tree_to_numpy(em_t, bridge.tensor_leaf)))
    if hasattr(wj, "close"):
        wj.close()
    return fleet_name, sj, st, ems, d


def _split_obs(a, b, group):
    """Assert the observation leaves of ``group`` within OBS_ULP and drop
    them from both trees (in place)."""
    for name in OBS_LEAVES[group]:
        x, y = a[group].pop(name), b[group].pop(name)
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        d = np.abs(x.view(np.int32).astype(np.int64)
                   - y.view(np.int32).astype(np.int64))
        assert d.max(initial=0) <= OBS_ULP, name


def test_state_bit_identical(runs):
    _, sj, st, _, _ = runs
    pt = bridge.state_to_numpy(st)
    jt = _port_fields(bridge.tree_to_numpy(sj, _leaf), pt)
    assert "rl_obs0" in pt["jobs"]
    _split_obs(jt, pt, "jobs")
    assert bridge.tree_mismatches(jt, pt) == []
    assert int(st.n_events) == N_CHUNKS * N_STEPS


def test_emissions_bit_identical(runs):
    _, _, _, ems, _ = runs
    for em_j, em_t in ems:
        em_j = {k: dict(v) if isinstance(v, dict) else v for k, v in em_j.items()}
        em_t = {k: dict(v) if isinstance(v, dict) else v for k, v in em_t.items()}
        assert set(em_t) == set(em_j)
        assert set(em_t["rl"]) == set(em_j["rl"])
        _split_obs(em_j, em_t, "rl")
        assert bridge.tree_mismatches(em_j, em_t) == []


def test_csvs_byte_identical(runs):
    _, _, _, _, d = runs
    for name in ("job_log.csv", "cluster_log.csv"):
        a = (d / "jax" / name).read_bytes()
        b = (d / "port" / name).read_bytes()
        assert a.count(b"\n") > 10, name
        assert a == b, name


def test_loads_exercise_the_tail(runs):
    """Routes, ring drains through the policy, queue-on-full xfers, drops
    and completed transitions with masks all occur."""
    fleet_name, _, st, ems, _ = runs
    rl = np.concatenate([e[1]["rl"]["valid"] for e in ems])
    assert rl.sum() > 20, "too few completed transitions"
    assert int(st.queues.head.sum()) > 0, "no ring drain started a job"
    assert int(st.n_dropped) > 0, "neither the slab nor a ring ever filled"
    m_g = np.concatenate([e[1]["rl"]["mask_g"] for e in ems])
    # some row allows every count up to the largest DC's GPUs (all n_g of
    # them where a DC has as many), some row refuses some count
    widest = min(m_g.shape[-1], int(FLEETS[fleet_name]().total_gpus.max()))
    assert m_g.sum(-1).max() == widest and (~m_g).any(), "masks never varied"
