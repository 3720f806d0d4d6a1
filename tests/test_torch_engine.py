"""The port's engine against the JAX engine, bit for bit (CPU).

Both engines start from the JAX ``init_state`` (carried over by the
bridge) and consume the SAME arrival tables: the JAX ``WorkloadProgram
.tables`` of each chunk, exported through numpy into the port's ``pre=``
seam.  With the transcendental samplers out of the picture every value
is + - * / on float32 and int32, so the final ``SimState`` leaves and every
emission row must be bitwise identical, for ``default_policy`` and
``joint_nf`` on the duo and single-DC fleets, over two chunks (so a chunk
boundary and ``advance_carries`` are crossed), plus one duo case with the
CLI's policy flags off their defaults.  The loads are chosen so the queue
rings fill, drain and (duo) drop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet, build_single_dc_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

N_STEPS = 300
N_CHUNKS = 2
FLEETS = {"duo": build_duo_fleet, "single": build_single_dc_fleet,
          "duo_options": build_duo_fleet}
LOADS = {
    # 32 GPUs flooded with short inference jobs, a 6-slot slab and 2-deep
    # rings: arrivals spill to the rings, rings drain and overflow
    "duo": dict(inf_mode="poisson", inf_rate=300.0, trn_rate=0.5, job_cap=6,
                queue_cap=2, log_interval=0.05),
    # 128 GPUs under 4000 arrivals/s: the rings queue and drain
    "single": dict(inf_mode="poisson", inf_rate=4000.0, trn_rate=5.0,
                   job_cap=32, queue_cap=64, log_interval=0.02),
    # the CLI's policy flags off their defaults, with sinusoid inference
    "duo_options": dict(inf_rate=300.0, inf_amp=0.9, inf_period=2.0,
                        trn_rate=0.5, job_cap=6, queue_cap=2,
                        log_interval=0.05, policy_name="perf_first",
                        inf_priority=False, reserve_inf_gpus=4,
                        max_gpus_per_job=4, dvfs_low=0.5, dvfs_high=0.9),
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


def run_both(algo, fleet_name, seed=5):
    fj = FLEETS[fleet_name]()
    kw = dict(algo=algo, duration=400.0, lat_window=64, seed=seed,
              **LOADS[fleet_name])
    eng_j = JEngine(fj, JParams(**kw))
    sj = jinit(jax.random.key(seed), fj, eng_j.params, workload=eng_j.workload)

    def chunk(state, pre):
        def body(s, _):
            return eng_j._step(s, None, pre=pre)

        s, em = jax.lax.scan(body, state, None, length=N_STEPS)
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


@pytest.mark.parametrize("fleet_name", ["duo", "single", "duo_options"])
@pytest.mark.parametrize("algo", ["default_policy", "joint_nf"])
def test_chunks_bit_identical(algo, fleet_name):
    sj, st, ems, eng_t = run_both(algo, fleet_name)
    pt = bridge.state_to_numpy(st)
    jt = _port_fields(bridge.tree_to_numpy(sj, _leaf), pt)
    assert bridge.tree_mismatches(jt, pt) == []
    for em_j, em_t in ems:
        assert set(em_t) == set(em_j)
        assert bridge.tree_mismatches(em_j, em_t) == []
    # the loads exercise what they are meant to
    q = st.queues
    assert int(q.tail.sum()) > 0 and int(q.head.sum()) > 0, "ring never drained"
    assert int(st.n_finished.sum()) > 20 and int(st.n_events) == N_CHUNKS * N_STEPS
    if fleet_name != "single":
        assert int(st.n_dropped) > 0, "the small rings never overflowed"
    # one host read per event head, plus drain flags and the chunk's key read
    assert N_STEPS < eng_t.stats["host_reads"] < 4 * N_STEPS


def test_done_tail_advances_key_like_reference():
    """A chunk that reaches the end keeps splitting the key on its no-op
    steps, as the scan does: the final key matches."""
    fj = build_duo_fleet()
    kw = dict(algo="default_policy", duration=3.0, job_cap=16, queue_cap=16,
              lat_window=16, seed=1)
    eng_j = JEngine(fj, JParams(**kw))
    sj = jinit(jax.random.key(1), fj, eng_j.params, workload=eng_j.workload)
    s0 = bridge.tree_to_numpy(sj, _leaf)
    pre = jax.jit(lambda s: eng_j.workload.tables(s, 128))(sj)

    def chunk(state, pre):
        s, em = jax.lax.scan(lambda s, _: eng_j._step(s, None, pre=pre),
                             state, None, length=128)
        return eng_j.workload.advance_carries(s, pre), em

    sj, em_j = jax.jit(chunk)(sj, pre)
    eng_t = Engine(bridge.fleet_from_numpy(fj), SimParams(**kw), device="cpu")
    st = bridge.state_from_numpy(s0, "cpu")
    st, em_t = eng_t.run_chunk(
        st, 128, pre={k: torch.from_numpy(np.array(v)) for k, v in pre.items()})
    assert bool(st.done) and eng_t.stats["events"] < 128
    pt = bridge.state_to_numpy(st)
    assert bridge.tree_mismatches(_port_fields(bridge.tree_to_numpy(sj, _leaf), pt),
                                  pt) == []
    assert bridge.tree_mismatches({k: np.asarray(v) for k, v in em_j.items()},
                                  {k: v.numpy() for k, v in em_t.items()}) == []


def test_unported_configs_raise():
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_duo_fleet as tduo

    fleet = tduo()
    for bad in (dict(algo="bandit", faults=object()),
                dict(algo="cap_greedy", superstep_k=2),
                dict(algo="chsac_af", elastic_scaling=True),
                dict(queue_mode="slab"), dict(superstep_k=4),
                dict(time_dtype="float64", faults=object()),
                dict(obs_enabled=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(fleet, dataclasses.replace(SimParams(), **bad), device="cpu")
