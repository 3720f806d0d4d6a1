"""Signal timelines in the plain step, bit for bit against the JAX engine (CPU).

``tests/test_torch_algos.py``'s harness with a workload: the JAX engine's
scan of ``Engine._step`` and the port's plain step (B1's plain version)
consume the reference's own arrival tables, and the final ``SimState``
leaves (``signals.cost_usd`` and ``signals.carbon_g`` included) and every
emission row (the 16-column cluster rows) must be bitwise identical over
two chunks.  Workloads: the ``flash_crowd`` preset at a rate that fills the
duo fleet, ``legacy_signals`` (the static tables as timelines), and a JSON
spec with short bins (``SHORT``: a 0.2 s rate timeline, a 0.1 s price and
carbon timeline with a price-0 bin and a DC of carbon 0, so the run
crosses bins many times and carbon_cost turns between its cost and carbon
scores), and the arrival families' streams (``FAMILIES``: a trace, two
rate timelines with zero-rate bins, thinning at amp 2) under those
signals, whose tables, thinning's included, are the reference's
injected; on the float32 clock and under x64 on the float64 clock.  R = 3
lanes of a signal run equal three single runs, and the observed
timelines' features equal ``Engine._obs``'s.  Tolerance: none (bitwise).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu.workload import make_preset as jpreset
from distributed_cluster_gpus_tpu.workload import workload_from_dict as jdoc
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.models.structs import (SimParams,
                                                               stack_states)
from distributed_cluster_gpus_tpu_torch.sim.engine import Engine
from distributed_cluster_gpus_tpu_torch.workload import make_preset as tpreset
from distributed_cluster_gpus_tpu_torch.workload import workload_from_dict as tdoc
from test_torch_algos import _leaf, _port_fields
from test_torch_signals_gpu import families_doc

N_STEPS = 160
N_CHUNKS = 2
LOAD = dict(job_cap=6, queue_cap=4, log_interval=0.05, lat_window=64)
#: short bins: the rate timeline's 0.2 s, the signals' 0.1 s (a price-0 bin,
#: a DC of carbon 0)
SHORT = {
    "name": "short_bins",
    "streams": {
        "inference": {"kind": "rate_timeline", "rates": [300.0, 0.0, 500.0,
                                                          200.0],
                      "bin_s": 0.2, "periodic": True},
        "training": {"kind": "poisson", "rate": 2.0}},
    "signals": {"price": [0.12, 0.0, 0.31], "carbon": [[100.0, 0.0],
                                                       [420.0, 55.0],
                                                       [0.0, 310.0]],
                "bin_s": 0.1, "periodic": True},
}
#: the duo fleet's arrival families (``test_torch_workload_tables``'s
#: streams) under SHORT's signals
FAMILIES = dict(families_doc(2), signals=SHORT["signals"])
FAMILIES["streams"] = FAMILIES["streams"][:2]
WEIGHTS = (0.5, 2e-5, 0.3, 40.0, 0.25)
#: (algo, workload, extra params, clock)
CASES = {
    "default_policy/flash": ("default_policy", "flash", {}, "float32"),
    "joint_nf/legacy": ("joint_nf", "legacy", {}, "float32"),
    "carbon_cost/short": ("carbon_cost", "short", {}, "float32"),
    "eco_route/short/carbon": ("eco_route", "short",
                               dict(eco_objective="carbon"), "float32"),
    "bandit/short": ("bandit", "short", {}, "float32"),
    "carbon_cost/short/x64": ("carbon_cost", "short", {}, "float64"),
    "weighted/short/x64": ("default_policy", "short",
                           dict(router_weights=WEIGHTS), "float64"),
    "default_policy/families": ("default_policy", "families", {}, "float32"),
    "eco_route/families/x64": ("eco_route", "families", {}, "float64"),
}


def specs(name, fj, ft, observe=False):
    """The JAX and the port's WorkloadSpec of one workload."""
    if name == "flash":
        kw = dict(base_rate=300.0, observe=observe)
        return jpreset("flash_crowd", fj, **kw), tpreset("flash_crowd", ft, **kw)
    if name == "legacy":
        kw = dict(observe=observe)
        return (jpreset("legacy_signals", fj, params=JParams(**LOAD), **kw),
                tpreset("legacy_signals", ft, params=SimParams(**LOAD), **kw))
    base = FAMILIES if name == "families" else SHORT
    doc = dict(base, signals=dict(base["signals"], observe=observe))
    return jdoc(doc, n_ing=fj.n_ing), tdoc(doc, n_ing=ft.n_ing)


def make_pair(algo, wl, extra, td, observe=False, seed=5):
    fj = build_duo_fleet()
    ft = bridge.fleet_from_numpy(fj)
    sj_spec, st_spec = specs(wl, fj, ft, observe)
    kw = dict(algo=algo, duration=400.0, seed=seed, time_dtype=td,
              **LOAD, **extra)
    return (fj, JParams(workload=sj_spec, **kw),
            ft, SimParams(workload=st_spec, **kw))


def run_both(algo, wl, extra, td, seed=5):
    fj, pj, ft, pt = make_pair(algo, wl, extra, td, seed=seed)
    with jax.enable_x64(td == "float64"):
        eng_j = JEngine(fj, pj)
        sj = jinit(jax.random.key(seed), fj, pj, workload=eng_j.workload)

        def chunk(state, pre):
            s, em = jax.lax.scan(lambda s, _: eng_j._step(s, None, pre=pre),
                                 state, None, length=N_STEPS)
            return eng_j.workload.advance_carries(s, pre), em

        chunk_j = jax.jit(chunk)
        tables_j = jax.jit(lambda s: eng_j.workload.tables(s, N_STEPS))
        eng_t = Engine(ft, pt, device="cpu")
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
    return jt, st, ems


@pytest.mark.parametrize("case", list(CASES))
def test_signal_chunks_bit_identical(case):
    algo, wl, extra, td = CASES[case]
    jt, st, ems = run_both(algo, wl, extra, td)
    pt = bridge.state_to_numpy(st)
    # the signal sub-state's tree is the JAX package's (its checkpoint's)
    assert set(pt["signals"]) == set(jt["signals"]) == {"cost_usd", "carbon_g"}
    assert bridge.tree_mismatches(jt, pt) == []
    for em_j, em_t in ems:
        assert em_t["cluster"].shape[-1] == 16
        assert bridge.tree_mismatches(em_j, em_t) == []
    # the loads do their work: jobs finish (the families' runs cover 1.5-2.2
    # s, too short for their jobs: they consume the streams instead), cost
    # accrues, the clock is the run's, and the short bins are crossed
    if wl != "families":
        assert int(st.n_finished.sum()) > 20
    assert float(st.signals.cost_usd.sum()) > 0.0
    assert st.t.dtype == (torch.float64 if td == "float64" else torch.float32)
    if wl == "short":
        assert float(st.t) > 0.35, "the run never crossed the price-0 bin"
    if wl == "families":  # every stream fires; [1, 1] is the thinning one
        counts = st.arr_count.reshape(-1, 2)
        assert (counts > 1).all() and int(counts[1, 1]) > 10


def test_signal_lanes_equal_single_runs():
    """R = 3 lanes of a signal run (each its own seed) equal three single
    runs of the plain step, every leaf and emission bitwise."""
    from distributed_cluster_gpus_tpu_torch.sim.engine import init_state

    _, _, ft, pt = make_pair("eco_route", "short", dict(eco_objective="cost"),
                             "float32")
    eng = Engine(ft, pt, device="cpu")
    singles = [init_state(s, ft, pt, workload=eng.workload, device="cpu")
               for s in (3, 4, 5)]
    lanes = stack_states([dataclasses.replace(s) for s in singles])
    lanes = bridge.state_from_numpy(bridge.state_to_numpy(lanes), "cpu")
    for _ in range(N_CHUNKS):
        lanes, em_l = eng.run_chunk(lanes, N_STEPS)
        for r, s in enumerate(singles):
            singles[r], em_s = eng.run_chunk(s, N_STEPS)
            assert bridge.tree_mismatches(
                {k: v.numpy() for k, v in em_s.items()},
                {k: v[r].numpy() for k, v in em_l.items()}) == []
    pl = bridge.state_to_numpy(lanes)
    for r, s in enumerate(singles):
        assert bridge.tree_mismatches(bridge.tree_lane(pl, r),
                                      bridge.state_to_numpy(s)) == [], r
    assert float(lanes.signals.carbon_g.sum()) > 0.0


@pytest.mark.parametrize("td", ["float32", "float64"])
def test_observed_signals_equal_engine_obs(td):
    """The observation of an observed workload: the base 1 + 6 n_dc
    features and the price / 0.25 and carbon / 1000 of the sampled
    timelines, equal to ``Engine._obs`` at clocks across the short bins."""
    fj, pj, ft, pt = make_pair("chsac_af", "short", {}, td, observe=True)
    assert pt.obs_dim(ft.n_dc) == pj.obs_dim(fj.n_dc) == 1 + 7 * ft.n_dc + 1
    with jax.enable_x64(td == "float64"):
        eng_j = JEngine(fj, pj, policy_apply=lambda *a: (0, 0))
        sj = jinit(jax.random.key(2), fj, pj, workload=eng_j.workload)
        obs_j = jax.jit(eng_j._obs)
        eng_t = Engine(ft, pt, device="cpu", policy_apply=lambda *a: (0, 0))
        for t in (0.0, 0.05, 0.1, 0.25, 0.299999, 0.3, 86399.95, 1.2e5 + 0.07):
            sj_t = sj.replace(t=jax.numpy.asarray(t, sj.t.dtype))
            st = bridge.state_from_numpy(bridge.tree_to_numpy(sj_t, _leaf), "cpu")
            got = eng_t._obs(st)
            want = np.asarray(obs_j(sj_t))
            assert got.numpy().tobytes() == want.tobytes(), t
