"""The heuristic algorithms past default_policy / joint_nf, bit for bit (CPU).

The port's plain step (B1's plain version) against the JAX engine's scan of
``Engine._step`` with the reference's arrival tables injected, as
``tests/test_torch_engine.py`` does for the first two algorithms: the final
``SimState`` leaves (the bandit's arms included) and every emission row
must be bitwise identical over two chunks, for ``carbon_cost``, ``debug``,
``bandit`` here, ``eco_route`` (its three objectives) and
``--router-weights`` routing in ``tests/test_torch_routing.py``, the
power-cap controllers, whose JAX programs compile slowly, in
``tests/test_torch_cap.py`` (the files run on separate test workers).

A second world (``world``) is the duo fleet with a price of 0 in hour 7 and
one DC of carbon intensity 0, its clocks bridged to just before t = 7 h:
the run crosses the hour boundary, so carbon_cost's admission turns from
the cost score to the carbon score (every cell of the carbon-0 DC scoring
0, the first cell wins) and eco routing's cost scores all become 0.

The bandit's ``log`` is XLA's CPU polynomial (``ops/bandit.py``), held to
``jnp.log`` here on every integer up to 2^20 and a sample of floats
(``scripts/check_bandit_log.py`` holds it on every float32 in [1, 2^24]).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet, build_single_dc_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.parallel.rollout import batched_init as jbatched_init
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams, n_lanes
from distributed_cluster_gpus_tpu_torch.ops.bandit import xla_log_f32
from distributed_cluster_gpus_tpu_torch.sim import algos
from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

N_STEPS = 300
N_CHUNKS = 2
LOADS = {
    # 32 GPUs flooded with short inference jobs, a 6-slot slab and 2-deep
    # rings: arrivals spill to the rings, rings drain and overflow
    "duo": dict(inf_mode="poisson", inf_rate=300.0, trn_rate=0.5, job_cap=6,
                queue_cap=2, log_interval=0.05),
    # 128 GPUs under 4000 arrivals/s: the rings queue and drain
    "single": dict(inf_mode="poisson", inf_rate=4000.0, trn_rate=5.0,
                   job_cap=32, queue_cap=64, log_interval=0.02),
}
#: the bridged world's start: a quarter second before hour 7 begins
T0 = 7 * 3600.0 - 0.25
WEIGHTS = (0.5, 2e-5, 0.3, 40.0, 0.25)

CASES = {
    "carbon_cost/duo": ("carbon_cost", "duo", {}, False),
    "carbon_cost/world": ("carbon_cost", "duo", {}, True),
    "debug/duo": ("debug", "duo", {}, False),
    # a GPU count past the grid's rows (XLA clamps the row) at a fixed
    # frequency, and a count the drain clamps to the free GPUs
    "debug/fixed": ("debug", "duo", dict(num_fixed_gpus=12, fixed_freq=0.75),
                    False),
    "debug/single": ("debug", "single", dict(num_fixed_gpus=3), False),
    "bandit/duo": ("bandit", "duo", {}, False),
    "bandit/single": ("bandit", "single", {}, False),
}


def _leaf(x):
    if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x))
    return np.asarray(x)


def _port_fields(jtree, ptree):
    """The JAX tree cut to the leaves the port carries."""
    if isinstance(ptree, dict):
        return {k: _port_fields(jtree[k], ptree[k]) for k in ptree}
    return jtree


def world_fleet():
    """The duo fleet with no price in hour 7 and DC 0 free of carbon."""
    fj = build_duo_fleet()
    price = np.array(fj.price_hourly, np.float32)
    price[7] = 0.0
    return dataclasses.replace(fj, price_hourly=price,
                               carbon=np.array([0.0, 400.0], np.float32))


def bridge_to(sj, t0, log_interval):
    """A fresh JAX state moved to clock ``t0``: the Poisson streams' next
    arrivals and the log tick shifted with it."""
    td = sj.t.dtype
    return sj.replace(t=jnp.asarray(t0, td),
                      next_arrival=sj.next_arrival + jnp.asarray(t0, td),
                      next_log_t=jnp.asarray(t0 + log_interval, td))


def run_both(algo, fleet_name, extra, world, seed=5):
    fj = world_fleet() if world else (
        build_duo_fleet() if fleet_name == "duo" else build_single_dc_fleet())
    kw = dict(algo=algo, duration=T0 + 400.0 if world else 400.0,
              lat_window=64, seed=seed, **LOADS[fleet_name], **extra)
    eng_j = JEngine(fj, JParams(**kw))
    sj = jinit(jax.random.key(seed), fj, eng_j.params, workload=eng_j.workload)
    if world:
        sj = bridge_to(sj, T0, kw["log_interval"])

    def chunk(state, pre):
        s, em = jax.lax.scan(lambda s, _: eng_j._step(s, None, pre=pre),
                             state, None, length=N_STEPS)
        return eng_j.workload.advance_carries(s, pre), em

    chunk_j = jax.jit(chunk)
    tables_j = jax.jit(lambda s: eng_j.workload.tables(s, N_STEPS))
    eng_t = Engine(bridge.fleet_from_numpy(fj), SimParams(**kw), device="cpu")
    st = bridge.state_from_numpy(bridge.tree_to_numpy(sj, _leaf), "cpu")
    ems = []
    for _ in range(N_CHUNKS):
        pre = tables_j(sj)
        sj, em_j = chunk_j(sj, pre)
        pre_t = {k: torch.from_numpy(np.array(v)) for k, v in pre.items()}
        st, em_t = eng_t.run_chunk(st, N_STEPS, pre=pre_t)
        ems.append(({k: np.asarray(v) for k, v in em_j.items()},
                    {k: v.numpy() for k, v in em_t.items()}))
    return sj, st, ems, eng_t


def check_case(algo, fleet_name, extra, world):
    """run_both's two runs bitwise equal, and the load doing its work."""
    sj, st, ems, eng_t = run_both(algo, fleet_name, extra, world)
    pt = bridge.state_to_numpy(st)
    jt = _port_fields(bridge.tree_to_numpy(sj, _leaf), pt)
    assert bridge.tree_mismatches(jt, pt) == []
    for em_j, em_t in ems:
        assert set(em_t) == set(em_j)
        assert bridge.tree_mismatches(em_j, em_t) == []
    # the loads exercise what they are meant to
    assert int(st.n_finished.sum()) > 20 and int(st.n_events) == N_CHUNKS * N_STEPS
    assert int(st.queues.head.sum()) > 0, "ring never drained"
    if world:
        assert float(st.t) > 7 * 3600.0, "the run never crossed the hour"
    if algo == "bandit":
        assert int(st.bandit.t) > int(st.bandit.N.sum()) > 0
        # every arm of the busy (dc, jtype) pairs explored, then UCB picks
        assert int((st.bandit.N[:, 0] > 1).sum()) > 0
    if extra.get("power_cap") and algo == "eco_route":
        assert (st.dc.cur_f_idx == 0).any()


@pytest.mark.parametrize("case", list(CASES))
def test_chunks_bit_identical(case):
    check_case(*CASES[case])


def test_world_reaches_both_carbon_cost_branches():
    """The bridged world's hours: a positive price before 7 h, none after,
    so carbon_cost scores cost, then carbon (DC 0's intensity 0: its first
    cell; DC 1's a real carbon minimum)."""
    fleet = bridge.fleet_from_numpy(world_fleet())
    E = torch.tensor(fleet.E_grid)
    price = torch.tensor(fleet.price_hourly)
    carbon = torch.tensor(fleet.carbon)
    for t, h in ((T0, 6), (7 * 3600.0 + 0.1, 7), (3599.999, 0), (86399.99, 23)):
        assert int(algos.hour_of(torch.tensor(t, dtype=torch.float32))) == h
    n6, f6 = algos.admit_carbon_cost(E, 1, 0, price[6], carbon[1])
    n7, f7 = algos.admit_carbon_cost(E, 0, 0, price[7], carbon[0])
    assert (int(n7), int(f7)) == (1, 0)  # all-zero scores: the first cell
    cost = E[1, 0] * (price[6] * algos.KWH)
    assert float(cost[int(n6) - 1, int(f6)]) == float(cost.min())


def test_bandit_lanes_bit_identical_to_jax_vmap():
    """R = 3 lanes of bandit against ``jax.jit(jax.vmap(_run_chunk))``."""
    R, n_steps = 3, 200
    fj = build_duo_fleet()
    kw = dict(LOADS["duo"], algo="bandit", duration=400.0, lat_window=64, seed=5)
    eng_j = JEngine(fj, JParams(**kw))
    sj = jbatched_init(fj, eng_j.params, R, workload=eng_j.workload)
    run_j = jax.jit(jax.vmap(lambda s: eng_j._run_chunk(s, None, n_steps)))
    tables_j = jax.jit(jax.vmap(lambda s: eng_j.workload.tables(s, n_steps)))
    eng_t = Engine(bridge.fleet_from_numpy(fj), SimParams(**kw), device="cpu")
    st = bridge.state_from_numpy(bridge.tree_to_numpy(sj, _leaf), "cpu")
    assert n_lanes(st) == R
    for _ in range(N_CHUNKS):
        pre = tables_j(sj)
        sj, em_j = run_j(sj)
        st, em_t = eng_t.run_chunk(
            st, n_steps, pre={k: torch.from_numpy(np.array(v)) for k, v in pre.items()})
        assert bridge.tree_mismatches({k: np.asarray(v) for k, v in em_j.items()},
                                      {k: v.numpy() for k, v in em_t.items()}) == []
    pt = bridge.state_to_numpy(st)
    jt = _port_fields(bridge.tree_to_numpy(sj, _leaf), pt)
    for r in range(R):
        assert bridge.tree_mismatches(bridge.tree_lane(jt, r),
                                      bridge.tree_lane(pt, r)) == [], r
    assert len({int(x) for x in st.bandit.t}) > 1  # the lanes differ


def test_bandit_log_is_xlas():
    """``xla_log_f32`` bit for bit ``jnp.log`` (XLA's CPU code): every
    integer 1..2^20 (the select counts a run reaches) and 2^20 random
    float32 in [1, 2^24]; torch's own log misses some of the integers."""
    f = jax.jit(jnp.log)
    ints = np.arange(1, 2 ** 20 + 1, dtype=np.float32)
    lo, hi = np.float32(1.0).view(np.int32), np.float32(2.0 ** 24).view(np.int32)
    rnd = np.random.default_rng(0).integers(lo, hi, 2 ** 20, dtype=np.int32)
    for x in (ints, rnd.view(np.float32)):
        want = np.asarray(f(x)).view(np.int32)
        got = xla_log_f32(torch.from_numpy(x)).numpy().view(np.int32)
        assert np.array_equal(want, got)
    torch_log = torch.log(torch.from_numpy(ints)).numpy().view(np.int32)
    assert (torch_log != np.asarray(f(ints)).view(np.int32)).sum() > 0
