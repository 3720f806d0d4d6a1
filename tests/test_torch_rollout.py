"""Batched rollouts in the port against the JAX package's vmap axis (CPU).

* ``parallel/rollout.batched_init`` gives the JAX ``batched_init`` key words
  bit for bit (lane 0 the un-split ``key(seed)``, lanes 1.. a folded split).
* R=3 lanes of the port's lane-stacked engine (the plain loop, lane by lane,
  B1's oracle) run against ``jax.jit(jax.vmap(eng._run_chunk))`` over two
  chunks, each chunk's tables taken from ``jax.vmap(eng.workload.tables)``
  and injected through ``pre=``: every lane's final ``SimState`` leaves and
  emissions are bitwise identical, for ``default_policy`` and ``joint_nf``.
* Every lane of a batched run equals the single-lane run of its key, and the
  lane-axis arrival tables (B2's plain version) equal each lane's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.parallel.rollout import batched_init as jbatched_init
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
from distributed_cluster_gpus_tpu_torch.models.structs import (
    SimParams, lane_state, n_lanes, stack_states, unstack_states)
from distributed_cluster_gpus_tpu_torch.parallel.rollout import (
    batched_init, replicated_init, rollout_keys)
from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

N_STEPS = 200
N_CHUNKS = 2
R = 3
# 32 GPUs flooded with short inference jobs, a 6-slot slab and 2-deep rings:
# arrivals spill to the rings, the rings drain and overflow
LOAD = dict(inf_mode="poisson", inf_rate=300.0, trn_rate=0.5, job_cap=6,
            queue_cap=2, log_interval=0.05, duration=400.0, lat_window=64,
            seed=5)


def _leaf(x):
    if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x))
    return np.asarray(x)


def _port_fields(jtree, ptree):
    if isinstance(ptree, dict):
        return {k: _port_fields(jtree[k], ptree[k]) for k in ptree}
    return jtree


@pytest.mark.parametrize("n", [1, 3])
def test_batched_init_keys_match_jax(n):
    fj = build_duo_fleet()
    sj = jbatched_init(fj, JParams(**LOAD), n)
    ft = bridge.fleet_from_numpy(fj)
    st = batched_init(ft, SimParams(**LOAD), n, device="cpu")
    assert n_lanes(st) == n
    for name in ("key", "arr_key"):
        want = np.asarray(jax.random.key_data(getattr(sj, name)))
        got = getattr(st, name).numpy().astype(np.uint32)
        assert want.shape == got.shape == (n, 2)
        assert np.array_equal(want, got), name
    # the lane keys themselves, before init_state splits them
    base = jax.random.key(LOAD["seed"])
    keys = base[None] if n == 1 else jnp.concatenate(
        [base[None], jax.random.split(jax.random.fold_in(base, 0x5eed), n - 1)])
    assert np.array_equal(rollout_keys(LOAD["seed"], n, "cpu").numpy().astype(np.uint32),
                          np.asarray(jax.random.key_data(keys)))


@pytest.mark.parametrize("algo", ["default_policy", "joint_nf"])
def test_lanes_bit_identical_to_jax_vmap(algo):
    fj = build_duo_fleet()
    kw = dict(LOAD, algo=algo)
    eng_j = JEngine(fj, JParams(**kw))
    sj = jbatched_init(fj, eng_j.params, R, workload=eng_j.workload)
    run_j = jax.jit(jax.vmap(lambda s: eng_j._run_chunk(s, None, N_STEPS)))
    tables_j = jax.jit(jax.vmap(lambda s: eng_j.workload.tables(s, N_STEPS)))
    eng_t = Engine(bridge.fleet_from_numpy(fj), SimParams(**kw), device="cpu")
    st = bridge.state_from_numpy(bridge.tree_to_numpy(sj, _leaf), "cpu")
    assert n_lanes(st) == R
    for _ in range(N_CHUNKS):
        pre = tables_j(sj)
        sj, em_j = run_j(sj)
        st, em_t = eng_t.run_chunk(
            st, N_STEPS, pre={k: torch.from_numpy(np.array(v)) for k, v in pre.items()})
        em_j = {k: np.asarray(v) for k, v in em_j.items()}
        em_t = {k: v.numpy() for k, v in em_t.items()}
        assert set(em_t) == set(em_j)
        assert bridge.tree_mismatches(em_j, em_t) == []
    pt = bridge.state_to_numpy(st)
    jt = _port_fields(bridge.tree_to_numpy(sj, _leaf), pt)
    for r in range(R):
        assert bridge.tree_mismatches(bridge.tree_lane(jt, r),
                                      bridge.tree_lane(pt, r)) == [], r
    # the load does what it is meant to in every lane, and the lanes differ
    assert (st.n_dropped > 0).all() and (st.queues.head.sum((1, 2)) > 0).all()
    assert len({int(x) for x in st.jid_counter}) > 1
    assert eng_t.stats["events"] == R * N_STEPS  # the last chunk's, all lanes


@pytest.mark.parametrize("algo", ["default_policy", "joint_nf"])
def test_each_lane_equals_its_single_lane_run(algo):
    ft = bridge.fleet_from_numpy(build_duo_fleet())
    params = SimParams(**dict(LOAD, algo=algo))
    eng = Engine(ft, params, device="cpu")
    st = batched_init(ft, params, R, workload=eng.workload, device="cpu")
    singles = unstack_states(st)
    ems = []
    for _ in range(N_CHUNKS):
        st, em = eng.run_chunk(st, N_STEPS)
        ems.append(em)
    launches = b1.event_scan.launches
    for r, s in enumerate(singles):
        for c in range(N_CHUNKS):
            s, em = eng.run_chunk(s, N_STEPS)
            for k, v in em.items():
                assert torch.equal(v, ems[c][k][r]), (r, c, k)
        assert bridge.tree_mismatches(bridge.state_to_numpy(lane_state(st, r)),
                                      bridge.state_to_numpy(s)) == [], r
    assert b1.event_scan.launches == launches  # the CPU launches no kernel


def test_lane_axis_tables_equal_single_lane_tables():
    ft = bridge.fleet_from_numpy(build_duo_fleet())
    params = SimParams(**dict(LOAD, inf_mode="sinusoid", inf_amp=0.9))
    eng = Engine(ft, params, device="cpu")
    st = batched_init(ft, params, R, workload=eng.workload, device="cpu")
    st, _ = eng.run_chunk(st, 64)  # move the cursors and clocks off draw 0
    whole = eng.workload.tables(st, 128)
    for r in range(R):
        one = eng.workload.tables(lane_state(st, r), 128)
        for k in ("sizes", "tnext", "cum", "c0"):
            assert torch.equal(whole[k][r], one[k]), (r, k)


def test_replicated_init_and_stacking():
    ft = bridge.fleet_from_numpy(build_duo_fleet())
    params = SimParams(**LOAD)
    st = replicated_init(ft, params, 2, device="cpu")
    a, b = unstack_states(st)
    assert bridge.tree_mismatches(bridge.state_to_numpy(a),
                                  bridge.state_to_numpy(b)) == []
    again = stack_states([a, b])
    assert bridge.tree_mismatches(bridge.state_to_numpy(again),
                                  bridge.state_to_numpy(st)) == []


def test_event_scan_wrapper_checks_its_inputs():
    ft = bridge.fleet_from_numpy(build_duo_fleet())
    params = SimParams(**LOAD)
    eng = Engine(ft, params, device="cpu")
    st = batched_init(ft, params, 2, workload=eng.workload, device="cpu")
    pre = eng.workload.tables(st, 16)
    with pytest.raises(ValueError, match="lane axis"):
        b1.event_scan(eng, lane_state(st, 0), pre, 16)
    st.jobs.spu = st.jobs.spu.double()
    with pytest.raises(TypeError, match="jobs.spu"):
        b1.event_scan(eng, st, pre, 16)
    # a slab over the card's shared memory is refused, never run otherwise
    b1.check_kernel_covers(eng)
    big = Engine(ft, SimParams(**dict(LOAD, job_cap=4096)), device="cpu")
    with pytest.raises(ValueError, match="shared memory"):
        b1.check_kernel_covers(big)


def test_entry_points_default_to_the_card():
    """Without a GPU the entry points refuse their default device instead of
    running on the CPU; asked for the CPU they run there."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be observed")
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.workload.compiler import compile_workload

    ft = bridge.fleet_from_numpy(build_duo_fleet())
    params = SimParams(**LOAD)
    tree = bridge.state_to_numpy(batched_init(ft, params, 2, device="cpu"))
    for call in (lambda: compile_workload(ft, params), lambda: prng.key(1),
                 lambda: bridge.state_from_numpy(tree),
                 lambda: batched_init(ft, params, 2),
                 lambda: replicated_init(ft, params, 2)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert prng.key(1, "cpu").device.type == "cpu"
    assert bridge.state_from_numpy(tree, "cpu").t.shape == (2,)
