"""The workload layer's kernels against their plain versions, on the card.

B2's trace, rate_timeline and thinning families (``csrc/arrival_tables.cu``)
against ``arrival_tables_reference``, and B1's signal instances
(``csrc/event_scan_sig.cu``, ``csrc/event_scan_sig64.cu``) against the plain
step, bitwise: a CUDA kernel has no CPU mode, so these tests carry the
``gpu`` marker and skip elsewhere.  No JAX import (run them with
``--noconftest`` on a machine without it):

    python -m pytest tests/test_torch_signals_gpu.py -q --noconftest -p no:cacheprovider

``chip_smoke.py`` phase (r) repeats these checks at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.configs.paper import (build_duo_fleet,
                                                              build_fleet)
from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
from distributed_cluster_gpus_tpu_torch.models.structs import (SimParams,
                                                               clone_state,
                                                               with_lane_axis)
from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state
from distributed_cluster_gpus_tpu_torch.workload import (make_preset,
                                                         workload_from_dict)
from distributed_cluster_gpus_tpu_torch.workload.compiler import compile_workload


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def families_doc(n_ing):
    """Every new family on one fleet: a trace with sizes, a trace without,
    an empty trace, periodic and finite rate timelines with zero-rate bins,
    thinning at amp 2 and -1.5; the other ingresses Poisson."""
    rng = np.random.RandomState(4)
    times = np.cumsum(rng.exponential(0.05, 300))
    kinds = [
        ({"kind": "trace", "times": times.tolist(),
          "sizes": rng.uniform(1, 50, 300).tolist()},
         {"kind": "rate_timeline", "rates": [2.0, 0.0, 5.0, 1.0], "bin_s": 1.7,
          "periodic": True}),
        ({"kind": "rate_timeline", "rates": [30.0, 0.0, 40.0], "bin_s": 2.0,
          "periodic": False},
         {"kind": "sinusoid", "rate": 20.0, "amp": 2.0, "period": 7.0,
          "phase_s": 1.3}),
        ({"kind": "trace", "times": times[::3].tolist()},
         {"kind": "sinusoid", "rate": 5.0, "amp": -1.5, "period": 3.0}),
        ({"kind": "trace", "times": []}, {"kind": "poisson", "rate": 3.0}),
    ]
    streams = [dict(ingress=i, inference=kinds[i % 4][0],
                    training=kinds[i % 4][1]) for i in range(n_ing)]
    return {"name": "families", "streams": streams}


def _tables_args(fleet, td, dev, R):
    spec = workload_from_dict(families_doc(fleet.n_ing), n_ing=fleet.n_ing)
    params = SimParams(workload=spec, time_dtype=td, job_cap=16, queue_cap=16,
                       seed=2)
    wt = compile_workload(fleet, params, dev)
    states = [init_state(s, fleet, params, workload=wt, device=dev)
              for s in range(2, 2 + R)]
    return wt, states


@pytest.mark.gpu
@pytest.mark.parametrize("td", ["float32", "float64"])
@pytest.mark.parametrize("fleet_fn,R,n", [(build_duo_fleet, 1, 1),
                                          (build_duo_fleet, 3, 517),
                                          (build_fleet, 1, 4096)])
def test_new_families_match_plain_version(cuda, td, fleet_fn, R, n):
    """Sizes, folds, next arrivals and the aux draws bitwise, two chunks
    (the second from the carried cursors, clocks and carries)."""
    wt, states = _tables_args(fleet_fn(), td, cuda, R)
    from distributed_cluster_gpus_tpu_torch.models.structs import stack_states

    st = stack_states(states) if R > 1 else with_lane_axis(states[0])
    S = wt.n_streams
    for chunk in range(2):
        shape = (R, S)
        args = (st.arr_key.reshape(R, 2).contiguous(),
                st.arr_count.reshape(shape).contiguous(),
                st.next_arrival.reshape(shape).contiguous(),
                st.arr_cum.reshape(shape).contiguous(),
                st.arr_epoch.reshape(shape).contiguous(), wt.family_t,
                wt.sparams)
        consts = wt.consts(st.t.dtype)
        before = b2.arrival_tables.launches
        out = b2.arrival_tables(*args, n, with_aux=True, consts=consts)
        assert b2.arrival_tables.launches == before + 1
        ref = b2.arrival_tables_reference(*args, n, with_aux=True, consts=consts)
        for k in ref:
            a, b = out[k], ref[k]
            same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() \
                else (a == b)
            assert bool(same.all()), (chunk, k, int((~same).sum()))
        # carry the state as the engine would, consuming n // 2 + 1 entries
        used = n // 2 + 1
        pre = dict(out, c0=args[1].clone())
        st.arr_count += used
        last = out["tnext"][..., used - 1].reshape(st.next_arrival.shape)
        st.next_arrival.copy_(last)
        wt.advance_carries(st, pre)


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
LOAD = dict(job_cap=6, queue_cap=4, log_interval=0.05, lat_window=64)
SIG_CASES = {
    "default_policy/flash": ("default_policy", "flash", {}, "float32"),
    "carbon_cost/short": ("carbon_cost", "short", {}, "float32"),
    "eco_route/short/cost": ("eco_route", "short",
                             dict(eco_objective="cost"), "float32"),
    "eco_route/short/carbon/x64": ("eco_route", "short",
                                   dict(eco_objective="carbon"), "float64"),
    "weighted/short": ("default_policy", "short",
                       dict(router_weights=(0.5, 2e-5, 0.3, 40.0, 0.25)),
                       "float32"),
    "joint_nf/flash/x64": ("joint_nf", "flash", {}, "float64"),
}


def _sig_params(fleet, algo, wl, extra, td, observe=False):
    if wl == "flash":
        spec = make_preset("flash_crowd", fleet, base_rate=300.0,
                           observe=observe)
    else:
        spec = workload_from_dict(dict(SHORT, signals=dict(
            SHORT["signals"], observe=observe)))
    return SimParams(algo=algo, duration=400.0, seed=5, time_dtype=td,
                     workload=spec, **{**LOAD, **extra})


def _mismatches(eng, st, n_steps, n_chunks, sac=None):
    other = clone_state(st)
    bad = []
    for c in range(n_chunks):
        pre = eng.workload.tables(st, n_steps)
        em_k, _ = b1.event_scan(eng, st, pre, n_steps, sac)
        em_r, _ = b1.event_scan_reference(eng, other, pre, n_steps, sac)
        eng.workload.advance_carries(st, pre)
        eng.workload.advance_carries(other, pre)
        for k in em_r:
            if isinstance(em_r[k], dict):
                bad += [f"chunk {c} em.{k}.{f}" for f in em_r[k]
                        if not torch.equal(em_k[k][f], em_r[k][f])]
            elif not torch.equal(em_k[k], em_r[k]):
                bad.append(f"chunk {c} em.{k}")
    return bad + bridge.tree_mismatches(bridge.state_to_numpy(other),
                                        bridge.state_to_numpy(st))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SIG_CASES))
def test_signal_instances_match_plain_step(cuda, case):
    """B1's signal builds against the plain step on the duo fleet, every
    leaf (the cost and carbon accumulators included) and emission (the
    16-column rows) bitwise, two chunks."""
    algo, wl, extra, td = SIG_CASES[case]
    fleet = build_duo_fleet()
    params = _sig_params(fleet, algo, wl, extra, td)
    eng = Engine(fleet, params, device=cuda)
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device=cuda))
    before = b1.event_scan.sig_launches
    assert _mismatches(eng, st, 300, 2) == []
    assert b1.event_scan.sig_launches == before + 2
    assert float(st.signals.cost_usd.sum()) > 0.0
    assert int(st.n_finished.sum()) > 20


@pytest.mark.gpu
@pytest.mark.parametrize("td", ["float32", "float64"])
def test_signal_rl_mode_observes_the_timelines(cuda, td):
    """RL mode with the observed timelines (obs_dim 1 + 7 n_dc + 1) against
    the plain step, the RL records included, bitwise."""
    from test_torch_kernels_gpu import _perturb

    from distributed_cluster_gpus_tpu_torch.rl.sac import make_policy_apply
    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent

    fleet = build_duo_fleet()
    params = _sig_params(fleet, "chsac_af", "short", dict(job_cap=32), td,
                         observe=True)
    assert params.obs_dim(fleet.n_dc) == 1 + 7 * fleet.n_dc + 1
    agent = make_agent(fleet, params, device=cuda)
    _perturb(agent.sac, 3)
    eng = Engine(fleet, params, device=cuda,
                 policy_apply=make_policy_apply(agent.cfg))
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device=cuda))
    assert _mismatches(eng, st, 300, 2, agent.sac) == []
    assert int(st.jobs.rl_valid.sum()) > 0


@pytest.mark.gpu
def test_select_action_on_the_card(cuda):
    """The agent's host call through B4's device code equals the plain
    policy's action for the same key, and advances the key as it does."""
    from test_torch_kernels_gpu import _perturb

    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent

    fleet = build_duo_fleet()
    params = _sig_params(fleet, "chsac_af", "short", dict(job_cap=32),
                         "float32", observe=True)
    agent = make_agent(fleet, params, device=cuda)
    _perturb(agent.sac, 9)
    eng = Engine(fleet, params, device=cuda, policy_apply=agent.policy_apply)
    g = torch.Generator().manual_seed(1)
    for _ in range(8):
        obs = torch.rand(params.obs_dim(fleet.n_dc), generator=g)
        m_dc = torch.rand(fleet.n_dc, generator=g) > 0.2
        m_g = torch.rand(params.max_gpus_per_job, generator=g) > 0.3
        m_dc[0] = m_g[0] = True
        key = agent.key.clone()
        got = agent.select_action(obs, m_dc, m_g, program=eng)
        from distributed_cluster_gpus_tpu_torch.ops import prng

        k = prng.split(key, 2)[1]
        a_dc, a_g = agent.policy_apply(agent.sac, obs.to(cuda), m_dc.to(cuda),
                                       m_g.to(cuda), k.to(cuda))
        assert got == {"dc": int(a_dc), "g": int(a_g)}
        assert agent.key.tolist() == prng.split(key, 2)[0].tolist()
