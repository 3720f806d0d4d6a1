"""The float64 clock: the port's plain step against the JAX engine under
x64, bit for bit (CPU).

``tests/test_torch_engine.py``'s harness with ``time_dtype="float64"``: the
JAX engine's scan of ``Engine._step`` runs inside ``jax.enable_x64(True)``
(the reference's CLI switches x64 on for the whole process; a context keeps
it to these programs), the port's plain step (B1's plain version) consumes
the reference's own arrival tables, and the final ``SimState`` leaves and
every emission row must be bitwise identical over two chunks, for
``default_policy``, ``joint_nf`` and ``cap_greedy`` on the duo and
single-DC fleets and for ``eco_route`` (cost objective, a power cap) on the
world of ``tests/test_torch_algos.py`` bridged to just before hour 7 of
day 7, so the clock crosses an hour boundary past 1e5 s.  Each program
starts once from ``init_state`` and once from a state bridged to t = 6.0e5
s, where a float32 clock's ulp is 1/16 s.

From that late state the float64 run's latencies are not multiples of
0.0625 s while a float32 run's are, on both sides alike (as the JAX
package's ``test_long_horizon_latency_resolution`` shows it for its own
engine).
"""

import jax
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
from test_torch_algos import _leaf, _port_fields, bridge_to, world_fleet

N_STEPS = 300
N_CHUNKS = 2
#: the bridged start: a float32 clock's ulp there is 2^-4 s
T_LATE = 6.0e5
#: the eco world's start: a quarter second before hour 7 of day 7
T_HOUR = 6 * 86400 + 7 * 3600.0 - 0.25
LOADS = {
    "duo": dict(inf_mode="poisson", inf_rate=300.0, trn_rate=0.5, job_cap=6,
                queue_cap=2, log_interval=0.05),
    "single": dict(inf_mode="poisson", inf_rate=4000.0, trn_rate=5.0,
                   job_cap=32, queue_cap=64, log_interval=0.02),
}
#: (algo, fleet, extra params, start); start None is init_state
CASES = {
    "default_policy/duo": ("default_policy", "duo", {}, None),
    "default_policy/single/late": ("default_policy", "single", {}, T_LATE),
    "joint_nf/single": ("joint_nf", "single", {}, None),
    "joint_nf/duo/late": ("joint_nf", "duo", {}, T_LATE),
    # the loads' fleets draw more than these caps (tests/test_torch_cap.py)
    "cap_greedy/duo": ("cap_greedy", "duo", dict(power_cap=4000.0), None),
    "cap_greedy/single/late": ("cap_greedy", "single",
                               dict(power_cap=12000.0), T_LATE),
    "eco_route/world/late": ("eco_route", "world",
                             dict(eco_objective="cost", power_cap=100.0),
                             T_HOUR),
}


def run_both(algo, fleet_name, extra, t0, td="float64", seed=5):
    """The JAX scan (under x64 for the float64 clock) and the port's plain
    step over N_CHUNKS chunks of the reference's tables, from init_state or
    from a state bridged to ``t0``."""
    fj = (world_fleet() if fleet_name == "world" else
          build_duo_fleet() if fleet_name == "duo" else build_single_dc_fleet())
    load = LOADS["duo" if fleet_name == "world" else fleet_name]
    kw = dict(algo=algo, duration=(t0 or 0.0) + 400.0, lat_window=64,
              seed=seed, time_dtype=td, **{**load, **extra})
    with jax.enable_x64(td == "float64"):
        eng_j = JEngine(fj, JParams(**kw))
        sj = jinit(jax.random.key(seed), fj, eng_j.params, workload=eng_j.workload)
        if t0 is not None:
            sj = bridge_to(sj, t0, kw["log_interval"])

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
        jt = _port_fields(bridge.tree_to_numpy(sj, _leaf),
                          bridge.state_to_numpy(st))
    return jt, st, ems, eng_t


@pytest.mark.parametrize("case", list(CASES))
def test_float64_chunks_bit_identical(case):
    algo, fleet_name, extra, t0 = CASES[case]
    jt, st, ems, eng_t = run_both(algo, fleet_name, extra, t0)
    pt = bridge.state_to_numpy(st)
    assert bridge.tree_mismatches(jt, pt) == []
    for em_j, em_t in ems:
        assert bridge.tree_mismatches(em_j, em_t) == []
    # the clock and every time-valued leaf are float64 on both sides
    for leaf in (st.t, st.t_first, st.next_log_t, st.next_arrival,
                 st.jobs.t_start, st.jobs.t_avail, st.dc.energy_j,
                 st.queues.recs):
        assert leaf.dtype == torch.float64
    assert jt["t"].dtype == np.float64 and jt["queues"]["recs"].dtype == np.float64
    # the loads exercise what they are meant to
    assert int(st.n_finished.sum()) > 20 and int(st.n_events) == N_CHUNKS * N_STEPS
    assert int(st.queues.head.sum()) > 0, "ring never drained"
    if t0 is not None:
        assert float(st.t) > t0
    if fleet_name == "world":
        assert float(st.t) > 6 * 86400 + 7 * 3600.0, "the run never crossed the hour"
    if algo == "cap_greedy":
        assert eng_t.ctl_ticks > 0, "the controller never fired"


@pytest.fixture(scope="module")
def late_runs():
    """default_policy on the duo fleet from t = 6e5 s in either clock, at
    20 inference arrivals a second and the CLI's 20 s log tick."""
    return {td: run_both("default_policy", "duo",
                         dict(inf_rate=20.0, log_interval=20.0), T_LATE, td=td)
            for td in ("float32", "float64")}


def _latencies(ems):
    lat = []
    for _, em_t in ems:
        rows = em_t["job"][em_t["job_valid"]]
        # finish - start in the clock's dtype, as the CSV's latency_s
        lat.append(rows[:, 10])
    return np.concatenate(lat).astype(np.float64)


def test_late_clock_resolves_latency_only_in_float64(late_runs):
    """A float32 clock at 6e5 s quantizes every latency to its 1/16 s ulp
    (the ms-scale service times vanish: t + dt rounds back to t); the
    float64 clock does not, and each side's job rows equal the reference's
    in both clocks."""
    for td, (jt, st, ems, _) in late_runs.items():
        for em_j, em_t in ems:
            assert bridge.tree_mismatches(em_j, em_t) == [], td
    lat32 = _latencies(late_runs["float32"][2])
    lat64 = _latencies(late_runs["float64"][2])
    assert lat32.size > 20 and lat64.size > 20
    on_grid = lambda x: np.all(np.mod(x, 0.0625) == 0.0)  # noqa: E731
    assert on_grid(lat32)
    assert not on_grid(lat64)
    assert (np.mod(lat64, 0.0625) != 0).mean() > 0.5
