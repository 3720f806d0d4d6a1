"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU: a CUDA kernel has no CPU mode, so they
carry the ``gpu`` marker and skip elsewhere.  The file imports no JAX, so
it also runs on a machine that has only PyTorch (with ``--noconftest``,
since the suite's conftest imports JAX):

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest -p no:cacheprovider

``chip_smoke.py`` repeats these checks at the main path's shapes.
"""

import warnings

import pytest
import torch

from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.configs.paper import (
    build_duo_fleet, build_fleet, build_single_dc_fleet)
from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
from distributed_cluster_gpus_tpu_torch.models.structs import (
    SimParams, clone_state, with_lane_axis)
from distributed_cluster_gpus_tpu_torch.parallel.rollout import batched_init
from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state
from distributed_cluster_gpus_tpu_torch.workload.compiler import compile_workload

# the loads of tests/test_torch_engine.py (that file imports JAX): the rings
# fill, drain and (duo) drop
FLEETS = {"duo": build_duo_fleet, "single": build_single_dc_fleet,
          "duo_options": build_duo_fleet}
LOADS = {
    "duo": dict(inf_mode="poisson", inf_rate=300.0, trn_rate=0.5, job_cap=6,
                queue_cap=2, log_interval=0.05),
    "single": dict(inf_mode="poisson", inf_rate=4000.0, trn_rate=5.0,
                   job_cap=32, queue_cap=64, log_interval=0.02),
    "duo_options": dict(inf_rate=300.0, inf_amp=0.9, inf_period=2.0,
                        trn_rate=0.5, job_cap=6, queue_cap=2,
                        log_interval=0.05, policy_name="perf_first",
                        inf_priority=False, reserve_inf_gpus=4,
                        max_gpus_per_job=4, dvfs_low=0.5, dvfs_high=0.9),
}
N_STEPS = 300
# the block widths B1 is held at: the one the wrapper launches in each mode,
# and one warp
HEUR_WIDTHS = RL_WIDTHS = sorted({b1.THREADS, 32})


def kernel_vs_plain(eng, state, n_steps, n_chunks, threads=None):
    """Advance a lane-stacked state by the B1 kernel (``threads`` per lane,
    the wrapper's choice by default) and a copy of it by the plain version
    over the same tables; returns the bitwise mismatches of the states and
    the emissions (empty lists when identical)."""
    other = clone_state(state)
    bad = []
    for c in range(n_chunks):
        pre = eng.workload.tables(state, n_steps)
        em_k, _ = b1.event_scan(eng, state, pre, n_steps, threads=threads)
        em_r, _ = b1.event_scan_reference(eng, other, pre, n_steps)
        eng.workload.advance_carries(state, pre)
        eng.workload.advance_carries(other, pre)
        bad += [f"chunk {c} em.{k}" for k in em_r if not torch.equal(em_k[k], em_r[k])]
    bad += bridge.tree_mismatches(bridge.state_to_numpy(other),
                                  bridge.state_to_numpy(state))
    return bad


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _args(fleet, params, dev):
    wt = compile_workload(fleet, params, dev)
    st = init_state(params.seed, fleet, params, workload=wt, device=dev)
    S = wt.n_streams
    return (st.arr_key, st.arr_count.reshape(S), st.next_arrival.reshape(S),
            st.arr_cum.reshape(S), st.arr_epoch.reshape(S), wt.family_t,
            wt.sparams)


@pytest.mark.gpu
@pytest.mark.parametrize("fleet_fn,kw,n", [
    (build_duo_fleet, dict(), 512),
    (build_duo_fleet, dict(inf_mode="poisson", trn_mode="off"), 3000),
    (build_fleet, dict(inf_amp=1.0, inf_period=60.0), 4096),
])
def test_arrival_tables_kernel_matches_plain_version(cuda, fleet_fn, kw, n):
    """Key words and uniform draws bit-exact; sizes, next-arrival clocks
    and folds within 1e-6 relative (measured bit-identical on an H100)."""
    args = _args(fleet_fn(), SimParams(queue_cap=64, job_cap=32, seed=2, **kw), cuda)
    before = b2.arrival_tables.launches
    out = b2.arrival_tables(*args, n, with_aux=True)
    assert b2.arrival_tables.launches == before + 1
    ref = b2.arrival_tables_reference(*args, n, with_aux=True)
    torch.cuda.synchronize()
    assert torch.equal(out["aux_key"], ref["aux_key"])
    assert torch.equal(out["aux_u"], ref["aux_u"])
    for k in ("sizes", "tnext", "cum"):
        torch.testing.assert_close(out[k], ref[k], rtol=1e-6, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2047, 2048, 4096, 4097])
@pytest.mark.parametrize("lanes", [1, 32])
def test_arrival_tables_fold_edges_bitwise(cuda, lanes, n):
    """B2 at the fold's edges (one entry, a vector tail, whole vectors, a
    second staged tile), one lane and 32 in one launch: every output
    bitwise the plain version's."""
    fleet = build_fleet()
    params = SimParams(queue_cap=64, job_cap=32, seed=5, inf_amp=0.8)
    wt = compile_workload(fleet, params, cuda)
    st = batched_init(fleet, params, lanes, workload=wt, device=cuda)
    S = wt.n_streams
    args = [st.arr_key, st.arr_count.reshape(lanes, S).contiguous(),
            st.next_arrival.reshape(lanes, S).contiguous(),
            st.arr_cum.reshape(lanes, S).contiguous(),
            st.arr_epoch.reshape(lanes, S).contiguous(), wt.family_t,
            wt.sparams]
    if lanes == 1:
        args = [a[0] for a in args[:5]] + args[5:]
    out = b2.arrival_tables(*args, n, with_aux=True)
    ref = b2.arrival_tables_reference(*args, n, with_aux=True)
    torch.cuda.synchronize()
    for k, v in ref.items():
        assert _bits_equal(out[k], v), k


@pytest.mark.gpu
def test_arrival_tables_wrapper_rejects_mixed_devices(cuda):
    args = list(_args(build_duo_fleet(), SimParams(queue_cap=8, job_cap=8), cuda))
    args[2] = args[2].cpu()
    with pytest.raises(ValueError, match="expected"):
        b2.arrival_tables(*args, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("threads", HEUR_WIDTHS)
@pytest.mark.parametrize("fleet_name", ["duo", "single", "duo_options"])
@pytest.mark.parametrize("algo", ["default_policy", "joint_nf"])
def test_event_scan_kernel_matches_plain_version(cuda, algo, fleet_name, threads):
    """B1 against its plain version on the card, bitwise: final state
    leaves, key words, emissions; two chunks (a chunk boundary crossed);
    at the block width the wrapper launches and at one warp."""
    fleet = FLEETS[fleet_name]()
    params = SimParams(algo=algo, duration=400.0, lat_window=64, seed=5,
                       **LOADS[fleet_name])
    eng = Engine(fleet, params, device=cuda)
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device=cuda))
    before = b1.event_scan.launches
    assert kernel_vs_plain(eng, st, N_STEPS, 2, threads) == []
    assert b1.event_scan.launches == before + 2
    assert int(st.n_events.sum()) == 2 * N_STEPS and int(st.n_finished.sum()) > 20
    if fleet_name != "single":
        assert int(st.n_dropped.sum()) > 0


# B1's extended instance (tests/test_torch_algos.py and test_torch_cap.py
# hold these configurations against the JAX package): each admission,
# routing and control family, the cap controllers at caps they iterate under
EXT_CASES = {
    "carbon_cost": ("duo", "carbon_cost", {}),
    "debug": ("duo", "debug", dict(num_fixed_gpus=12, fixed_freq=0.75)),
    "debug_argmin": ("single", "debug", dict(num_fixed_gpus=3)),
    "bandit": ("single", "bandit", {}),
    "eco_energy_idle": ("duo", "eco_route", dict(power_cap=100.0)),
    "eco_carbon": ("duo", "eco_route", dict(eco_objective="carbon")),
    "eco_cost": ("duo", "eco_route", dict(eco_objective="cost")),
    "weighted": ("duo", "default_policy",
                 dict(router_weights=(0.5, 2e-5, 0.3, 40.0, 0.25))),
    "cap_uniform": ("duo", "cap_uniform", dict(power_cap=4000.0)),
    "cap_greedy": ("single", "cap_greedy", dict(power_cap=12000.0)),
}


def ext_kernel_vs_plain(eng, state, n_steps, n_chunks, threads=None):
    """``kernel_vs_plain`` for the extended instance, which also counts the
    cap controller's log ticks and iterations: (mismatches, [kernel's
    (ticks, iterations)], [the plain step's])."""
    other = clone_state(state)
    bad, ctl_k, ctl_r = [], [], []
    for c in range(n_chunks):
        pre = eng.workload.tables(state, n_steps)
        em_k, st_k = b1.event_scan(eng, state, pre, n_steps, threads=threads)
        em_r, st_r = b1.event_scan_reference(eng, other, pre, n_steps)
        eng.workload.advance_carries(state, pre)
        eng.workload.advance_carries(other, pre)
        bad += [f"chunk {c} em.{k}" for k in em_r if not torch.equal(em_k[k], em_r[k])]
        ctl_k += st_k["ctl"][:, :2].cpu().tolist()
        ctl_r += st_r["ctl"][:, :2].tolist()
    bad += bridge.tree_mismatches(bridge.state_to_numpy(other),
                                  bridge.state_to_numpy(state))
    return bad, ctl_k, ctl_r


@pytest.mark.gpu
@pytest.mark.parametrize("threads", HEUR_WIDTHS)
@pytest.mark.parametrize("case", list(EXT_CASES))
def test_event_scan_extended_instance_matches_plain_version(cuda, case, threads):
    """B1's extended instance against the plain step on the card, bitwise
    (state with the bandit's arms, key words, emissions) over two chunks,
    the controllers' ticks and iterations the plain step's; every launch
    counted as the extended instance's."""
    fleet_name, algo, kw = EXT_CASES[case]
    fleet = FLEETS[fleet_name]()
    params = SimParams(algo=algo, duration=400.0, lat_window=64, seed=5,
                       **LOADS[fleet_name], **kw)
    assert b1.ext_plan(params)[0]
    eng = Engine(fleet, params, device=cuda)
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device=cuda))
    before = (b1.event_scan.launches, b1.event_scan.ext_launches)
    bad, ctl_k, ctl_r = ext_kernel_vs_plain(eng, st, N_STEPS, 2, threads)
    assert bad == []
    assert ctl_k == ctl_r
    assert (b1.event_scan.launches, b1.event_scan.ext_launches) == (
        before[0] + 2, before[1] + 2)
    assert int(st.n_events.sum()) == 2 * N_STEPS and int(st.n_finished.sum()) > 20
    if algo.startswith("cap_"):
        ticks = sum(t for t, _ in ctl_k)
        assert 0 < ticks < sum(i for _, i in ctl_k)


@pytest.mark.gpu
def test_event_scan_extended_instance_lanes(cuda):
    """Four bandit lanes in one launch of the extended instance, each
    against the plain step, bitwise, run past the simulation's end."""
    fleet = build_duo_fleet()
    params = SimParams(algo="bandit", duration=3.0, job_cap=16, queue_cap=16,
                       lat_window=16, log_interval=0.5, seed=1, inf_rate=60.0)
    eng = Engine(fleet, params, device=cuda)
    st = batched_init(fleet, params, 4, workload=eng.workload, device=cuda)
    bad, _, _ = ext_kernel_vs_plain(eng, st, 512, 3)
    assert bad == []
    assert bool(st.done.all()) and int(st.bandit.t.min()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("threads", HEUR_WIDTHS)
@pytest.mark.parametrize("job_cap", [16, 100, 2048])
def test_event_scan_kernel_lanes_and_run_end(cuda, job_cap, threads):
    """Three lanes in one launch, run past the end of the simulation (the
    done tail only advances the key), against the plain version; slabs
    under a warp, not a multiple of the block, padded to a power of two,
    and over 48 KB of shared memory."""
    fleet = build_duo_fleet()
    params = SimParams(duration=3.0, job_cap=job_cap, queue_cap=16,
                       lat_window=16, log_interval=0.5, seed=1)
    eng = Engine(fleet, params, device=cuda)
    st = batched_init(fleet, params, 3, workload=eng.workload, device=cuda)
    assert kernel_vs_plain(eng, st, 512, 3, threads) == []
    assert bool(st.done.all())


@pytest.mark.gpu
@pytest.mark.parametrize("threads", [32])
@pytest.mark.parametrize("algo", ["default_policy", "chsac_af"])
def test_event_scan_kernel_more_dcs_than_warps(cuda, algo, threads):
    """The paper fleet's 8 DCs on a block of one warp (the warp sums every
    DC's power tree), job_cap 100 (not a multiple of the block), both
    modes, against the plain version bitwise over two chunks."""
    fleet = build_fleet()
    params = SimParams(algo=algo, duration=60.0, job_cap=100, queue_cap=8,
                       lat_window=64, inf_rate=30.0, trn_rate=2.0,
                       log_interval=0.5, seed=6)
    if algo == "chsac_af":
        eng, agent = _rl_engine(fleet, params, cuda)
        st = with_lane_axis(init_state(params.seed, fleet, params,
                                       workload=eng.workload, device=cuda))
        assert rl_kernel_vs_plain(eng, agent.sac, st, N_STEPS, 2, threads) == []
    else:
        eng = Engine(fleet, params, device=cuda)
        st = with_lane_axis(init_state(params.seed, fleet, params,
                                       workload=eng.workload, device=cuda))
        assert kernel_vs_plain(eng, st, N_STEPS, 2, threads) == []
    assert int(st.n_finished.sum()) > 20


@pytest.mark.gpu
def test_engine_on_the_card_runs_the_kernel(cuda):
    fleet = build_duo_fleet()
    params = SimParams(duration=5.0, job_cap=16, queue_cap=16, lat_window=16, seed=3)
    eng = Engine(fleet, params, device=cuda)
    st = init_state(params.seed, fleet, params, workload=eng.workload, device=cuda)
    before = b1.event_scan.launches
    st, em = eng.run_chunk(st, 256)
    assert b1.event_scan.launches == before + 1
    # the engine counts host reads only in the plain loop
    assert eng.stats["host_reads"] is None and eng.stats["events"] == int(st.n_events)
    assert em["t"].shape == (256,) and em["cluster"].shape == (256, 2, 14)


def _syncs(fn):
    """The synchronizing CUDA calls (host reads among them) ``fn()`` makes,
    as torch's sync debug mode reports them."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [w for w in seen if "synchroniz" in str(w.message)]


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["default_policy", "chsac_af"])
def test_event_scan_kernel_reads_nothing_back(cuda, algo):
    """The B1 wrapper, launch included, makes no synchronizing CUDA call in
    either mode: no host read inside the chunk (a scalar read is seen, so
    the count works)."""
    fleet = build_duo_fleet()
    params = SimParams(algo=algo, duration=5.0, job_cap=16, queue_cap=16,
                       lat_window=16, seed=3)
    sac = None
    if algo == "chsac_af":
        eng, agent = _rl_engine(fleet, params, cuda)
        sac = agent.sac
    else:
        eng = Engine(fleet, params, device=cuda)
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device=cuda))
    pre = eng.workload.tables(st, 256)
    b1.event_scan(eng, st, pre, 256, sac)  # first call: loads the library
    assert _syncs(lambda: b1.event_scan(eng, st, pre, 256, sac)) == []
    assert len(_syncs(lambda: int(st.n_events.sum()))) >= 1


@pytest.mark.gpu
def test_arrival_tables_kernel_lanes_match_plain_version(cuda):
    """B2 with R=3 lanes in one launch against its plain version."""
    fleet = build_fleet()
    params = SimParams(queue_cap=64, job_cap=32, seed=2)
    wt = compile_workload(fleet, params, cuda)
    st = batched_init(fleet, params, 3, workload=wt, device=cuda)
    S = wt.n_streams
    args = (st.arr_key, st.arr_count.reshape(3, S).contiguous(),
            st.next_arrival.reshape(3, S).contiguous(),
            st.arr_cum.reshape(3, S).contiguous(),
            st.arr_epoch.reshape(3, S).contiguous(), wt.family_t, wt.sparams)
    out = b2.arrival_tables(*args, 1024, with_aux=True)
    ref = b2.arrival_tables_reference(*args, 1024, with_aux=True)
    torch.cuda.synchronize()
    for k in ("aux_key", "aux_u", "sizes", "tnext", "cum"):
        assert torch.equal(out[k], ref[k]), k


# ---------------------------------------------------------------- chsac_af

# the loads of tests/test_torch_rl_engine.py: the slab and the rings fill,
# the policy routes and drains
RL_LOADS = {
    "duo": ("duo", dict(inf_mode="poisson", inf_rate=300.0, trn_rate=40.0,
                        job_cap=64, queue_cap=3, log_interval=0.02)),
    "single": ("single", dict(inf_mode="poisson", inf_rate=3000.0,
                              trn_rate=3000.0, job_cap=160, queue_cap=8,
                              log_interval=0.003)),
    "duo_options": ("duo", dict(inf_rate=300.0, inf_amp=0.9, inf_period=2.0,
                                trn_rate=40.0, job_cap=64, queue_cap=3,
                                log_interval=0.02, inf_priority=False,
                                reserve_inf_gpus=4, max_gpus_per_job=4,
                                sla_p99_ms=80.0, rl_energy_weight=2.5)),
    # GPU-count heads wider than a warp (a DC has 16 GPUs): B4 over
    # register slots and warps
    "duo_g64": ("duo", dict(inf_mode="poisson", inf_rate=300.0, trn_rate=40.0,
                            job_cap=64, queue_cap=3, log_interval=0.02,
                            max_gpus_per_job=64)),
    "duo_g254": ("duo", dict(inf_mode="poisson", inf_rate=300.0,
                             trn_rate=40.0, job_cap=64, queue_cap=3,
                             log_interval=0.02, max_gpus_per_job=254)),
}


def _perturb(sac, seed):
    """Seeded non-zero biases and perturbed kernels in every layer: flax's
    default init zeroes the biases, which would leave the bias add of the
    forward unchecked.  The shadows are refreshed after the write."""
    from distributed_cluster_gpus_tpu_torch.rl.sac import refresh_shadows

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # the parameters are trainable leaves
        for layer in sac.layers():
            for p, std in ((layer.kernel, 0.02), (layer.bias, 0.1)):
                p.add_((torch.randn(p.shape, generator=g) * std).to(p.device))
    refresh_shadows(sac)


def _rl_engine(fleet, params, dev, greedy=False):
    """An engine acting with the port's policy, its weights perturbed."""
    from distributed_cluster_gpus_tpu_torch.rl.sac import make_policy_apply
    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent

    agent = make_agent(fleet, params, device=dev)
    _perturb(agent.sac, params.seed)
    assert all(bool(l.bias.ne(0).all()) for l in agent.sac.layers())
    apply = make_policy_apply(agent.cfg, greedy=greedy)
    return Engine(fleet, params, device=dev, policy_apply=apply), agent


def _em_mismatches(a, b, where):
    bad = []
    for k in b:
        if isinstance(b[k], dict):
            bad += _em_mismatches(a[k], b[k], f"{where}.{k}")
        elif not torch.equal(a[k], b[k]):
            bad.append(f"{where}.{k}")
    return bad


def rl_kernel_vs_plain(eng, sac, state, n_steps, n_chunks, threads=None):
    other = clone_state(state)
    bad = []
    for c in range(n_chunks):
        pre = eng.workload.tables(state, n_steps)
        em_k, _ = b1.event_scan(eng, state, pre, n_steps, sac, threads=threads)
        em_r, _ = b1.event_scan_reference(eng, other, pre, n_steps, sac)
        eng.workload.advance_carries(state, pre)
        eng.workload.advance_carries(other, pre)
        bad += _em_mismatches(em_k, em_r, f"chunk {c} em")
    bad += bridge.tree_mismatches(bridge.state_to_numpy(other),
                                  bridge.state_to_numpy(state))
    return bad


@pytest.mark.gpu
@pytest.mark.parametrize("threads", RL_WIDTHS)
@pytest.mark.parametrize("greedy", [False, True], ids=["sampled", "greedy"])
@pytest.mark.parametrize("load", list(RL_LOADS))
def test_event_scan_rl_mode_matches_plain_version(cuda, load, greedy, threads):
    """B1 in RL mode (B3 and B4 inside the event loop) against the plain
    step on the card, bitwise: state leaves (the slab's RL trace included)
    and every emission (the RL records included), two chunks; at the block
    width the wrapper launches and at one warp."""
    fl, kw = RL_LOADS[load]
    fleet = FLEETS[fl]()
    params = SimParams(algo="chsac_af", duration=400.0, lat_window=64, seed=3,
                       **kw)
    eng, agent = _rl_engine(fleet, params, cuda, greedy)
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device=cuda))
    before = (b1.event_scan.launches, b1.event_scan.rl_launches)
    assert rl_kernel_vs_plain(eng, agent.sac, st, N_STEPS, 2, threads) == []
    assert (b1.event_scan.launches, b1.event_scan.rl_launches) == (
        before[0] + 2, before[1] + 2)
    assert int(st.jobs.rl_valid.sum()) > 0 and int(st.n_finished.sum()) > 20


@pytest.mark.gpu
@pytest.mark.parametrize("threads", RL_WIDTHS)
def test_event_scan_rl_mode_lanes_and_run_end(cuda, threads):
    """Two lanes past the end of the simulation in RL mode: the done steps
    repeat the final record, against the plain version."""
    fleet = build_duo_fleet()
    params = SimParams(algo="chsac_af", duration=2.0, job_cap=24, queue_cap=8,
                       lat_window=16, log_interval=0.5, seed=4)
    eng, agent = _rl_engine(fleet, params, cuda)
    st = batched_init(fleet, params, 2, workload=eng.workload, device=cuda)
    assert rl_kernel_vs_plain(eng, agent.sac, st, 512, 3, threads) == []
    assert bool(st.done.all())


@pytest.mark.gpu
@pytest.mark.parametrize("threads", RL_WIDTHS)
@pytest.mark.parametrize("job_cap", [1025, 2048])
def test_event_scan_rl_mode_large_slabs(cuda, job_cap, threads):
    """RL mode on the paper fleet at the published policy and W = 2,048
    with slabs past 1,024 slots, whose DC-summing warps keep scratch rows:
    job_cap 1,025 (one summing warp, so that block 0 keeps its slice) and
    the evaluation's 2,048 (block 0 gives up its slice, the other blocks
    hold the weights); bitwise against the plain version over two
    chunks."""
    fleet = build_fleet()
    params = SimParams(algo="chsac_af", duration=60.0, job_cap=job_cap,
                       queue_cap=8, lat_window=2048, inf_rate=30.0,
                       trn_rate=2.0, log_interval=0.5, seed=7)
    eng, agent = _rl_engine(fleet, params, cuda)
    _, widths = b1.policy_operands(eng, agent.sac, cuda)
    n_sum, cs, lead = b1.block_plan(eng, threads, widths)
    assert cs > 1 and lead == (job_cap == 1025)
    assert n_sum == 1 or job_cap == 2048
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device=cuda))
    assert rl_kernel_vs_plain(eng, agent.sac, st, N_STEPS, 2, threads) == []
    assert int(st.jobs.rl_valid.sum()) > 0 and int(st.n_finished.sum()) > 20


@pytest.mark.gpu
def test_event_scan_rl_mode_needs_the_ports_policy(cuda):
    """No fallback: a chsac_af state on the card without the policy's
    weights, or with a policy the kernel does not run, raises."""
    fleet = build_duo_fleet()
    params = SimParams(algo="chsac_af", duration=2.0, job_cap=16, queue_cap=8,
                       lat_window=16, seed=4)
    eng, agent = _rl_engine(fleet, params, cuda)
    st = init_state(params.seed, fleet, params, workload=eng.workload, device=cuda)
    with pytest.raises(ValueError, match="weights"):
        eng.run_chunk(st, 64)
    other = Engine(fleet, params, device=cuda,
                   policy_apply=lambda pp, o, md, mg, k: (k[0], k[1]))
    with pytest.raises(ValueError, match="own policy"):
        other.run_chunk(init_state(params.seed, fleet, params,
                                   workload=other.workload, device=cuda), 64,
                        policy_params=agent.sac)


@pytest.mark.gpu
@pytest.mark.parametrize("threads", RL_WIDTHS)
@pytest.mark.parametrize("fleet_fn,W", [(build_duo_fleet, 64), (build_fleet, 2048)])
def test_rl_tail_device_code_matches_plain_version(cuda, fleet_fn, W, threads):
    """B3 and B4 through the standalone launch: every ring's p99 and every
    row's log-probabilities bitwise, the sampled actions equal."""
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.rl.sac import policy_logp, select_action
    from distributed_cluster_gpus_tpu_torch.sim import algos

    fleet = fleet_fn()
    params = SimParams(algo="chsac_af", lat_window=W, seed=2)
    eng, agent = _rl_engine(fleet, params, cuda)
    g = torch.Generator().manual_seed(W)
    counts = [0, 1, 4, 5, W - 1, W, 3 * W + 7, W // 2]
    buf = torch.round(torch.empty((len(counts), W)).exponential_(
        4.0, generator=g) * 1000) / 1000
    buf[-1] = 0.5
    buf, cnt = buf.float().to(cuda), torch.tensor(counts, dtype=torch.int32,
                                                  device=cuda)
    cfg = agent.cfg
    M = 32
    obs = torch.rand((M, cfg.obs_dim), generator=g).to(cuda)
    m_dc = (torch.rand((M, cfg.n_dc), generator=g) < 0.6).to(cuda)
    m_g = (torch.rand((M, cfg.n_g), generator=g) < 0.6).to(cuda)
    m_dc[:, 0] = True
    m_g[:, -1] = True
    m_dc[0] = False
    m_dc[0, -1] = True
    keys = prng.split(prng.key(5, cuda), M).contiguous()
    out = b1.rl_tail_batch(eng, agent.sac, buf, cnt, obs, m_dc, m_g, keys,
                           threads=threads)
    ref = algos.windowed_percentile(buf, cnt, 99.0)
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out["p99"]), nan)
    assert torch.equal(out["p99"][~nan].view(torch.int32),
                       ref[~nan].view(torch.int32))
    l_dc, l_g = policy_logp(agent.sac, obs, m_dc, m_g)
    assert torch.equal(out["logp_dc"], l_dc) and torch.equal(out["logp_g"], l_g)
    for i in range(M):
        a = select_action(cfg, agent.sac, obs[i], m_dc[i], m_g[i], keys[i])
        assert (int(out["a_dc"][i]), int(out["a_g"][i])) == (int(a[0]), int(a[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("threads", RL_WIDTHS)
@pytest.mark.parametrize("greedy", [False, True], ids=["sampled", "greedy"])
@pytest.mark.parametrize("n_g", [33, 64, 128, 254])
def test_rl_tail_wide_gpu_count_heads(cuda, n_g, greedy, threads):
    """B4's GPU-count head past one warp (register slots, the Gumbels drawn
    by each warp for its slots, the first maximum across the warps) on the
    duo fleet up to n_dc + n_g = 256: log-probabilities bitwise, actions
    equal to the plain version's, rows with all but one action masked (the
    first, a middle, the last) and every action feasible."""
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.rl.sac import policy_logp, select_action

    fleet = build_duo_fleet()
    params = SimParams(algo="chsac_af", lat_window=64, seed=2,
                       max_gpus_per_job=n_g)
    eng, agent = _rl_engine(fleet, params, cuda, greedy)
    cfg = agent.cfg
    g = torch.Generator().manual_seed(n_g)
    M = 24
    obs = torch.rand((M, cfg.obs_dim), generator=g).to(cuda)
    m_dc = (torch.rand((M, cfg.n_dc), generator=g) < 0.6).to(cuda)
    m_g = (torch.rand((M, n_g), generator=g) < 0.5).to(cuda)
    m_dc[:, 0] = True
    m_g[:, 1] = True
    m_g[:3] = False
    m_g[0, 0] = m_g[1, n_g // 2] = m_g[2, n_g - 1] = True
    m_g[3] = True
    keys = prng.split(prng.key(9, cuda), M).contiguous()
    empty = torch.zeros((0, 64), device=cuda)
    out = b1.rl_tail_batch(eng, agent.sac, empty,
                           torch.zeros((0,), dtype=torch.int32, device=cuda),
                           obs, m_dc, m_g, keys, threads=threads)
    l_dc, l_g = policy_logp(agent.sac, obs, m_dc, m_g)
    assert _bits_equal(out["logp_dc"], l_dc) and _bits_equal(out["logp_g"], l_g)
    for i in range(M):
        a = select_action(cfg, agent.sac, obs[i], m_dc[i], m_g[i], keys[i],
                          greedy=greedy)
        assert (int(out["a_dc"][i]), int(out["a_g"][i])) == (int(a[0]), int(a[1]))
    assert [int(x) for x in out["a_g"][:3]] == [0, n_g // 2, n_g - 1]


def _window(g, N, p_valid, dev, obs_dim=13, n_dc=2, n_g=8):
    f32 = dict(generator=g)
    return {k: v.to(dev) for k, v in {
        "valid": torch.rand(N, **f32) < p_valid,
        "s0": torch.randn((N, obs_dim), **f32),
        "s1": torch.randn((N, obs_dim), **f32),
        "a_dc": torch.randint(0, n_dc, (N,), dtype=torch.int32, **f32),
        "a_g": torch.randint(0, n_g, (N,), dtype=torch.int32, **f32),
        "r": torch.randn(N, **f32), "costs": torch.randn((N, 4), **f32),
        "mask_dc": torch.rand((N, n_dc), **f32) < 0.5,
        "mask_g": torch.rand((N, n_g), **f32) < 0.5,
        "mask_dc0": torch.rand((N, n_dc), **f32) < 0.5,
        "mask_g0": torch.rand((N, n_g), **f32) < 0.5}.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["wrap", "all_valid", "none_valid", "overwrite"])
def test_replay_ingest_kernel_matches_plain_version(cuda, case):
    """B6a against `_add_window` on the card, every leaf bitwise after every
    window (wrap to 0, n_lost, size, ptr, n_seen)."""
    from distributed_cluster_gpus_tpu_torch.kernels import replay_ingest as b6
    from distributed_cluster_gpus_tpu_torch.rl import replay

    C, sizes, pv = {"wrap": (40, [9] * 7, 0.6), "all_valid": (40, [10] * 6, 1.0),
                    "none_valid": (40, [10] * 3, 0.0),
                    "overwrite": (37, [10] * 8, 0.9)}[case]
    g = torch.Generator().manual_seed(len(case))
    rk = replay.replay_init(C, 13, 2, 8, 4, device=cuda)
    rp = replay.replay_init(C, 13, 2, 8, 4, device=cuda)
    before = b6.replay_ingest.launches
    for N in sizes:
        tr = _window(g, N, pv, cuda)
        b6.replay_ingest(rk, tr)
        replay._add_window(rp, tr)
        assert bridge.tree_mismatches(
            bridge.tree_to_numpy(rp, bridge.tensor_leaf),
            bridge.tree_to_numpy(rk, bridge.tensor_leaf)) == [], N
    assert b6.replay_ingest.launches == before + len(sizes)


@pytest.mark.gpu
def test_replay_ingest_reads_nothing_back(cuda):
    from distributed_cluster_gpus_tpu_torch.kernels import replay_ingest as b6
    from distributed_cluster_gpus_tpu_torch.rl import replay

    rb = replay.replay_init(64, 13, 2, 8, 4, device=cuda)
    tr = _window(torch.Generator().manual_seed(0), 16, 0.5, cuda)
    b6.replay_ingest(rb, tr)  # first call: loads the library
    assert _syncs(lambda: b6.replay_ingest(rb, tr)) == []


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["slotring", "scatter"])
def test_replay_ingest_every_window_size(cuda, mode):
    """B6a in both layouts against its plain version: windows of 1, 4,096,
    8,193 (past the one-block kernel's old limit) and C = 40,000 rows (a
    count launch first: more than 32,768) into one ring, every leaf bitwise
    after each; the 4,096-row window without a ``done`` column (the kernel
    writes the ones), the others with one."""
    from distributed_cluster_gpus_tpu_torch.kernels import replay_ingest as b6
    from distributed_cluster_gpus_tpu_torch.rl import replay

    C = 40_000
    plain = replay._add_window if mode == "slotring" else replay._add_scatter
    g = torch.Generator().manual_seed(17)
    rk = replay.replay_init(C, 49, 8, 8, 4, device=cuda)
    rp = replay.replay_init(C, 49, 8, 8, 4, device=cuda)
    before = b6.replay_ingest.launches
    sizes = [1, 4096, 8193, C, 4096]
    for i, N in enumerate(sizes):
        tr = _window(g, N, 0.35, cuda, obs_dim=49, n_dc=8, n_g=8)
        if N != 4096:
            tr["done"] = (torch.rand(N, generator=g) < 0.5).float().to(cuda)
        b6.replay_ingest(rk, tr, mode)
        plain(rp, tr)
        assert bridge.tree_mismatches(
            bridge.tree_to_numpy(rp, bridge.tensor_leaf),
            bridge.tree_to_numpy(rk, bridge.tensor_leaf)) == [], (i, N)
    assert b6.replay_ingest.launches == before + len(sizes)
    if mode == "slotring":  # the C-row window overwrote valid rows
        assert int(rk.size) < int(rk.n_seen)
    else:  # scatter: size = min(n_seen, C)
        assert int(rk.size) == min(int(rk.n_seen), C)


# ------------------------------------------------ the update: B5a-c, B6b


def _bits_equal(a, b):
    views = {torch.float32: torch.int32, torch.bfloat16: torch.int16}

    def bits(x):
        v = views.get(x.dtype)
        return x if v is None else x.reshape(-1).view(v)

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        bits(a), bits(b))


def _bits_equal_nan(a, b):
    """The same elements NaN, bitwise equal elsewhere."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and _bits_equal(a[~na], b[~nb])


def _huber_inputs(dev, B, N, M, seed):
    """Seeded q [B, 2, N], target [B, M], taus [N]: |td| exactly at kappa
    (row 0, twin 0) and at 0 (the last row, twin 1), and td = -0.0 (a -0.0
    target against a +0.0 q)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 2, N), generator=g)
    tgt = torch.randn((B, M), generator=g) * 2
    n = min(N, M, 2)
    tgt[0, :n] = q[0, 0, :n] + 1.0
    tgt[-1, :n] = q[-1, 1, :n]
    q[0, 1, 0], tgt[0, 0] = 0.0, -0.0
    taus = (torch.arange(N, dtype=torch.float32) + 0.5) / N
    return q.to(dev), tgt.to(dev), taus.to(dev)


HUBER_B = [1, 3, 255, 256, 257, 4096]
HUBER_NM = [(8, 8), (1, 1), (7, 5), (32, 32), (33, 64), (64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("N,M", HUBER_NM)
@pytest.mark.parametrize("B", HUBER_B)
def test_quantile_huber_kernel_matches_plain_version(cuda, B, N, M):
    """B5a: loss and gradient bitwise over the kernel's shape envelope,
    |td| exactly at kappa and at 0, td = -0.0."""
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.rl.sac import quantile_huber_loss

    q, tgt, taus = _huber_inputs(cuda, B, N, M, B * 100 + N + M)
    before = b5.quantile_huber.launches
    loss_k, grad_k = b5.quantile_huber(q, tgt, taus)
    loss_p, grad_p = quantile_huber_loss(q, tgt, taus)
    assert _bits_equal(loss_k, loss_p) and _bits_equal(grad_k, grad_p)
    assert b5.quantile_huber.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M", [(3, 8, 8), (256, 32, 32), (257, 33, 64)])
def test_quantile_huber_kernel_nan_in_q(cuda, B, N, M):
    """B5a with one NaN quantile: the same elements NaN as the plain
    version's (the loss), the rest bitwise."""
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.rl.sac import quantile_huber_loss

    q, tgt, taus = _huber_inputs(cuda, B, N, M, B + N)
    q[B // 2, 1, N - 1] = float("nan")
    before = b5.quantile_huber.launches
    loss_k, grad_k = b5.quantile_huber(q, tgt, taus)
    loss_p, grad_p = quantile_huber_loss(q, tgt, taus)
    assert bool(torch.isnan(loss_p))
    assert _bits_equal_nan(loss_k, loss_p) and _bits_equal_nan(grad_k, grad_p)
    assert b5.quantile_huber.launches == before + 1


def _marginal_inputs(dev, B=9, n_dc=3, n_g=4, N=8, layout="heads", seed=0):
    g = torch.Generator().manual_seed(B + n_dc + N + 1000 * seed)
    A = n_dc * n_g
    if layout == "heads":
        q = torch.randn((B, 2, A, N), generator=g).to(dev)
    elif layout == "offset":  # rows that are not 16-byte aligned
        q = torch.randn((B, 2, A, N + 1), generator=g).to(dev)[..., 1:]
    else:  # the one-hot critic's [B, A, 2, N] product, viewed as [B, 2, A, N]
        q = torch.randn((B, A, 2, N), generator=g).to(dev).permute(0, 2, 1, 3)
    m_dc = torch.rand((B, n_dc), generator=g) < 0.6
    m_g = torch.rand((B, n_g), generator=g) < 0.6
    m_dc[:, 0] = True
    m_g[:, n_g - 1] = True
    m_dc[0] = False  # every DC masked: uniform
    m_g[min(1, B - 1)] = False  # every GPU count masked (row 0 too if B = 1)
    from distributed_cluster_gpus_tpu_torch.rl.nets import masked_log_softmax

    ldc = masked_log_softmax(torch.randn((B, n_dc), generator=g), m_dc)
    lg = masked_log_softmax(torch.randn((B, n_g), generator=g), m_g)
    rest = dict(r=torch.randn(B, generator=g),
                costs=torch.rand((B, 4), generator=g) * 900,
                lam=torch.tensor([0.4, 0.0, 2.0, 0.0]),
                targets=torch.tensor([500.0, 1e30, 0.0, 1e30]),
                done=(torch.arange(B) % 2).float(),
                log_alpha=torch.tensor(0.3))
    return q, ldc.to(dev), lg.to(dev), {k: v.to(dev) for k, v in rest.items()}


# heads x N of the actor's envelope (Ap x Np <= 8,192): 16 x 16 is Ap = 256
MARGINAL_SHAPES = [(3, 4, 8)] + [(d, c, n) for d, c in ((1, 1), (3, 4), (8, 8))
                                 for n in (1, 32, 64)] + [(16, 16, 1), (16, 16, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_dc,n_g,N", MARGINAL_SHAPES)
@pytest.mark.parametrize("B", [9, 1, 257])
@pytest.mark.parametrize("layout", ["heads", "onehot", "offset"])
def test_marginal_kernels_match_plain_versions(cuda, layout, B, n_dc, n_g, N):
    """B5b: the target and the actor term (value, H, gradients) bitwise,
    masked and all-masked heads, done in {0, 1}, both critics' layouts and
    rows that are not 16-byte aligned, over the actor's shape envelope; each
    a launch."""
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    q, ldc, lg, x = _marginal_inputs(cuda, B, n_dc, n_g, N, layout=layout)
    args = (q, ldc, lg, x["r"], x["costs"], x["lam"], x["targets"], x["done"],
            x["log_alpha"], 0.99)
    for k, p in zip(b5.marginal_target(*args), rsac.marginal_target(*args)):
        assert _bits_equal(k, p)
    before = b5.marginal_actor.launches
    out_k = b5.marginal_actor(q, ldc, lg, x["log_alpha"])
    out_p = rsac.marginal_actor(q, ldc, lg, x["log_alpha"])
    assert b5.marginal_actor.launches == before + 1
    for k, p in zip(out_k, out_p):
        assert _bits_equal(k, p) and bool(torch.isfinite(k).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n_dc,n_g", [(8, 8), (3, 65), (8, 64), (8, 128),
                                      (128, 8), (4, 252), (1, 255)])
@pytest.mark.parametrize("B", [1, 100, 256, 512, 4096])
def test_marginal_kernels_widened_envelope(cuda, B, n_dc, n_g):
    """B5b at the widened envelope (A up to 1,024, heads up to 256, batches
    to 4,096; the one-hot critic's layout, N = 32): the redesigned target
    at the plan's warp count and the widened actor term, bitwise."""
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    q, ldc, lg, x = _marginal_inputs(cuda, B, n_dc, n_g, 32, layout="onehot")
    args = (q, ldc, lg, x["r"], x["costs"], x["lam"], x["targets"], x["done"],
            x["log_alpha"], 0.99)
    before = b5.marginal_target.launches
    for k, p in zip(b5.marginal_target(*args), rsac.marginal_target(*args)):
        assert _bits_equal(k, p)
    assert b5.marginal_target.launches == before + 1
    for k, p in zip(b5.marginal_actor(q, ldc, lg, x["log_alpha"]),
                    rsac.marginal_actor(q, ldc, lg, x["log_alpha"])):
        assert _bits_equal(k, p) and bool(torch.isfinite(k).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n_dc,n_g,N", [(8, 8, 32), (3, 65, 32), (8, 128, 33)])
def test_marginal_target_negative_zeros_and_nan(cuda, n_dc, n_g, N):
    """The redesigned target keeps -0.0 through its trees (a row whose
    leaves pi (q - alpha log pi) are all -0.0, with r_eff = -0.0: with A a
    power of two its targets are -0.0 unless a level adds a +0.0 the plain
    tree does not; else the plain tree's own padding makes them +0.0) and
    propagates a NaN quantile (torch.minimum's rule) to that quantile's
    target only: bitwise the plain version.  The kernel reads log alpha, so
    the leaves are made -0.0 by underflow: log alpha -100 (alpha = exp of
    it, +0.0), log-probabilities of -60 a head (pi = +0.0) and q = -1."""
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    q, ldc, lg, x = _marginal_inputs(cuda, 9, n_dc, n_g, N, layout="heads")
    q[3] = -1.0
    ldc[3] = -60.0
    lg[3] = -60.0
    x["log_alpha"].fill_(-100.0)
    x["r"][3] = -0.0
    x["costs"][3] = 0.0
    q[4, 1, n_dc * n_g // 2, 5] = float("nan")
    args = (q, ldc, lg, x["r"], x["costs"], x["lam"], x["targets"], x["done"],
            x["log_alpha"], 0.99)
    got, want = b5.marginal_target(*args), rsac.marginal_target(*args)
    for k, p in zip(got, want):
        assert _bits_equal_nan(k, p)
    A = n_dc * n_g
    assert bool((torch.signbit(got[0][3]) == (A & (A - 1) == 0)).all())
    assert bool((got[0][3] == 0).all())
    assert bool(torch.isnan(got[0][4, 5])) and not bool(torch.isnan(got[0][4, 6]))


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_dc,n_g,N", [(600, 8, 8, 32), (8192, 8, 8, 32),
                                          (3, 1, 1, 8192), (5, 2, 2, 2048)])
def test_marginal_actor_kernel_long_trees(cuda, B, n_dc, n_g, N):
    """B5b's actor term where its trees stream through the registers: a
    batch tail of more than 16 values a lane (up to B = 8,192, the
    envelope's edge) and a tree over N of up to 256 a lane; bitwise."""
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    q, ldc, lg, x = _marginal_inputs(cuda, B, n_dc, n_g, N, layout="onehot")
    before = b5.marginal_actor.launches
    out_k = b5.marginal_actor(q, ldc, lg, x["log_alpha"])
    out_p = rsac.marginal_actor(q, ldc, lg, x["log_alpha"])
    assert b5.marginal_actor.launches == before + 1
    for k, p in zip(out_k, out_p):
        assert _bits_equal(k, p) and bool(torch.isfinite(k).all())


@pytest.mark.gpu
def test_loss_kernels_replay_in_a_cuda_graph(cuda):
    """B5a and B5b's actor term captured in one CUDA graph and replayed
    three times on new inputs: bitwise equal to the plain versions each
    time (the arrival count is reset, nothing stale carries over); the
    wrappers count the capture's launches only."""
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    q, tgt, taus = _huber_inputs(cuda, 256, 32, 32, 5)
    qa, ldc, lg, x = _marginal_inputs(cuda, 256, 8, 8, 32, layout="onehot")
    alpha = x["log_alpha"]  # the kernels read log alpha
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        b5.quantile_huber(q, tgt, taus)
        b5.marginal_actor(qa, ldc, lg, alpha)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (b5.quantile_huber.launches, b5.marginal_actor.launches)
    with torch.cuda.graph(graph):
        huber = b5.quantile_huber(q, tgt, taus)
        actor = b5.marginal_actor(qa, ldc, lg, alpha)
    assert (b5.quantile_huber.launches, b5.marginal_actor.launches) == (
        before[0] + 1, before[1] + 1)
    for i in range(3):
        nq, nt, _ = _huber_inputs(cuda, 256, 32, 32, 10 + i)
        na, nd, ng, _ = _marginal_inputs(cuda, 256, 8, 8, 32, layout="onehot",
                                         seed=i + 1)
        q.copy_(nq)
        tgt.copy_(nt)
        qa.copy_(na)
        ldc.copy_(nd)
        lg.copy_(ng)
        alpha.fill_(0.1 * (i + 1))
        graph.replay()
        torch.cuda.synchronize()
        for k, p in zip(huber, rsac.quantile_huber_loss(q, tgt, taus)):
            assert _bits_equal(k, p), i
        for k, p in zip(actor, rsac.marginal_actor(qa, ldc, lg, alpha)):
            assert _bits_equal(k, p), i
    assert (b5.quantile_huber.launches, b5.marginal_actor.launches) == (
        before[0] + 1, before[1] + 1)


def _tail_outputs(dev, K=4):
    """Fresh metric buffers and a seeded CMDP state for the tails."""
    from distributed_cluster_gpus_tpu_torch.rl.cmdp import CMDPState

    g = torch.Generator().manual_seed(K)
    st = CMDPState(lam=torch.rand(K, generator=g).to(dev),
                   integral=torch.rand(K, generator=g).to(dev),
                   prev_err=(torch.rand(K, generator=g) * 50).to(dev))
    return st, [torch.zeros((), device=dev) for _ in range(7)] + [
        torch.zeros(K, device=dev) for _ in range(2)] + [
        torch.zeros(1, device=dev)]


def _gains_of(dev):
    from distributed_cluster_gpus_tpu_torch.rl import cmdp

    return cmdp._gains((cmdp.ConstraintSpec("lat", 500.0, kd=0.02),
                        cmdp.ConstraintSpec("pow", 300.0, kp=0.1),
                        cmdp.ConstraintSpec("over", 0.0, lambda_max=1.0),
                        cmdp.ConstraintSpec("en", 1e30)), dev)


def _run_tails(fns, q, tgt, taus, take, qa, ldc, lg, x, gains, st, outs):
    """B5a with the taken action and q_mean, B5b's target with its PID tail,
    B5b's actor term with its temperature tail, through ``fns`` (the
    wrappers or the plain versions); returns every output."""
    from distributed_cluster_gpus_tpu_torch.rl.sac import PidTail, TempTail

    huber, target, actor = fns
    loss, qm, r_mean, a_loss, h, al_loss, _, lam, viol, al_grad = outs
    l_, dq = huber(q, tgt, taus, 1.0, take, loss, qm)
    tq, r_eff = target(qa, ldc, lg, x["r"], x["costs"], st.lam, gains[0],
                       x["done"], x["log_alpha"], 0.99,
                       PidTail(st, gains, r_mean, lam, viol))
    a_ = actor(qa, ldc, lg, x["log_alpha"], a_loss,
               TempTail(-3.0, h, al_loss, al_grad))
    return [l_, dq, tq, r_eff, *a_, st.lam, st.integral, st.prev_err, *outs]


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_dc,n_g,N", [(256, 8, 8, 32), (37, 3, 65, 32),
                                          (1, 1, 1, 8), (4096, 8, 8, 32)])
def test_update_tail_kernels_match_plain_versions(cuda, B, n_dc, n_g, N):
    """The update's tail folded into B5a (the heads critic's taken action,
    its gradient's scatter, q_mean), B5b's target (r_eff's mean, the PID
    step in place) and actor term (the entropy's mean, the temperature's
    loss and gradient): every output and the CMDP state bitwise against the
    plain versions."""
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    A = n_dc * n_g
    qa, ldc, lg, x = _marginal_inputs(cuda, B, n_dc, n_g, N, layout="heads")
    _, tgt, taus = _huber_inputs(cuda, B, N, N, B + A)
    g = torch.Generator().manual_seed(B)
    take = (torch.randint(0, n_dc, (B,), dtype=torch.int32, generator=g).to(cuda),
            torch.randint(0, n_g, (B,), dtype=torch.int32, generator=g).to(cuda),
            n_g)
    gains = _gains_of(cuda)
    res = []
    for fns in ((b5.quantile_huber, b5.marginal_target, b5.marginal_actor),
                (rsac.quantile_huber_loss, rsac.marginal_target,
                 rsac.marginal_actor)):
        st, outs = _tail_outputs(cuda)
        res.append(_run_tails(fns, qa, tgt, taus, take, qa, ldc, lg, x, gains,
                              st, outs))
    torch.cuda.synchronize()
    for i, (k, p) in enumerate(zip(*res)):
        assert _bits_equal(k, p), i
    assert bool((res[0][1] != 0).any()) and bool(torch.isfinite(res[0][-1]).all())


@pytest.mark.gpu
def test_update_tail_kernels_replay_in_a_cuda_graph(cuda):
    """The three tail kernels captured in one CUDA graph and replayed three
    times on new inputs: the PID state advances in place each replay, every
    output bitwise equal to the plain versions run as often."""
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    B, n_dc, n_g, N = 256, 8, 8, 32
    qa, ldc, lg, x = _marginal_inputs(cuda, B, n_dc, n_g, N, layout="heads")
    _, tgt, taus = _huber_inputs(cuda, B, N, N, 3)
    take = (torch.arange(B, dtype=torch.int32, device=cuda) % n_dc,
            torch.arange(B, dtype=torch.int32, device=cuda) % n_g, n_g)
    gains = _gains_of(cuda)
    st_k, outs_k = _tail_outputs(cuda)
    st_p, outs_p = _tail_outputs(cuda)
    kfns = (b5.quantile_huber, b5.marginal_target, b5.marginal_actor)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (and load) off the capture
        _run_tails(kfns, qa, tgt, taus, take, qa, ldc, lg, x, gains,
                   *_tail_outputs(cuda))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = _run_tails(kfns, qa, tgt, taus, take, qa, ldc, lg, x, gains,
                         st_k, outs_k)
    for i in range(3):
        na, nd, ng, nx = _marginal_inputs(cuda, B, n_dc, n_g, N,
                                          layout="heads", seed=i + 1)
        for dst, src in ((qa, na), (ldc, nd), (lg, ng), (x["costs"], nx["costs"]),
                         (x["r"], nx["r"])):
            dst.copy_(src)
        x["log_alpha"].fill_(-0.5 * (i + 1))
        graph.replay()
        want = _run_tails((rsac.quantile_huber_loss, rsac.marginal_target,
                           rsac.marginal_actor), qa, tgt, taus, take, qa, ldc,
                          lg, x, gains, st_p, outs_p)
        torch.cuda.synchronize()
        for j, (k, p) in enumerate(zip(got, want)):
            assert _bits_equal(k, p), (i, j)


@pytest.mark.gpu
def test_adam_alpha_exp_and_sample_casts(cuda):
    """B5c writes exp(log alpha) after its step (the alpha metric), and
    B6b's draw rounds the observations to bf16 and advances the update
    index once: each bitwise against its plain version."""
    from distributed_cluster_gpus_tpu_torch.kernels import replay_sample as b6b
    from distributed_cluster_gpus_tpu_torch.kernels.adam import (AdamGroup,
                                                                 adam_update)
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.rl import optim, replay

    res = []
    for plain in (False, True):
        p = torch.tensor([0.3], device=cuda)
        st = optim.adam_init(p)
        e = torch.zeros((), device=cuda)
        adam_update([AdamGroup(p, torch.tensor([-0.7], device=cuda), st,
                               clamp=0.31, exp_out=e)], optim.AdamConfig(),
                    plain=plain)
        res.append((p, e))
    assert _bits_equal(res[0][1], res[1][1]) and _bits_equal(res[0][0], res[1][0])
    assert _bits_equal(res[0][1], torch.exp(res[0][0]).reshape(()))
    rb = replay.replay_init(5000, 49, 8, 8, 4, device=cuda)
    replay.replay_add_chunk(rb, _window(torch.Generator().manual_seed(2), 4096,
                                        0.5, cuda, obs_dim=49, n_dc=8, n_g=8))
    key = prng.key(9, "cuda")
    outs = []
    for plain in (False, True):
        index = torch.tensor(7, dtype=torch.int32, device=cuda)
        outs.append(b6b.replay_sample(rb, key, 256, plain=plain, index=index,
                                      bf16_obs=True, advance=True))
        assert int(index) == 8
    for f in (*replay.ROW_FIELDS, "idx"):
        assert _bits_equal(outs[0][f], outs[1][f]), f
    assert outs[0]["s0"].dtype == torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["clip", "no_clip", "zero", "step1000_target",
                                  "alpha_clamp"])
def test_adam_kernel_matches_plain_version(cuda, case):
    """B5c: parameters, moments, count (and target) bitwise."""
    from distributed_cluster_gpus_tpu_torch.kernels.adam import (AdamGroup,
                                                                 adam_update)
    from distributed_cluster_gpus_tpu_torch.rl import optim

    g = torch.Generator().manual_seed(len(case))
    n = 1 if case == "alpha_clamp" else 70_001
    p = torch.randn(n, generator=g)
    grad = torch.randn(n, generator=g) * (0.2 if case == "clip" else 0.001)
    if case == "zero":
        grad.zero_()
    step = 999 if case == "step1000_target" else 0
    mu = torch.randn(n, generator=g) * 0.01 if step else torch.zeros(n)
    nu = torch.rand(n, generator=g) * 1e-4 if step else torch.zeros(n)
    tgt = torch.randn(n, generator=g) if case == "step1000_target" else None
    clamp = float(p[0]) - 1e-4 if case == "alpha_clamp" else None
    states, outs = [], []
    for kernel in (True, False):
        st = optim.AdamState(count=torch.tensor(step, dtype=torch.int32).to(cuda),
                             mu=mu.to(cuda), nu=nu.to(cuda))
        pp, tt = p.to(cuda), None if tgt is None else tgt.to(cuda)
        adam_update([AdamGroup(pp, grad.to(cuda), st, tt, tau=0.005,
                               clamp=clamp)], optim.AdamConfig(),
                    plain=not kernel)
        outs.append([pp, st.mu, st.nu] + ([] if tt is None else [tt]))
        states.append(st)
    for a, b in zip(*outs):
        assert _bits_equal(a, b)
    assert int(states[0].count) == int(states[1].count) == step + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 70_001, 287_808])
@pytest.mark.parametrize("case", ["clip", "no_clip", "nan"])
def test_adam_kernel_bf16_gradients_and_shadows(cuda, case, n):
    """B5c with B5g's casts inside: a bf16 gradient read and widened, the
    shadows of the new parameters and of the Polyak target written; every
    parameter, moment, target and shadow bitwise the plain version's (a
    NaN parameter's shadow too), and the shadows bf16 of what was
    written."""
    from distributed_cluster_gpus_tpu_torch.kernels.adam import (AdamGroup,
                                                                 adam_update)
    from distributed_cluster_gpus_tpu_torch.rl import optim

    g = torch.Generator().manual_seed(n + len(case))
    p = torch.randn(n, generator=g)
    if case == "nan":
        p[n // 2] = float("nan")
    grad = (torch.randn(n, generator=g) * (0.2 if case == "clip" else 0.001)
            ).to(torch.bfloat16)
    mu = torch.randn(n, generator=g) * 0.01
    nu = torch.rand(n, generator=g) * 1e-4
    tgt = torch.randn(n, generator=g)
    runs = []
    for plain in (False, True):
        st = optim.AdamState(torch.tensor(3, dtype=torch.int32).to(cuda),
                             mu.to(cuda), nu.to(cuda))
        gr = AdamGroup(p.to(cuda), grad.to(cuda), st, tgt.to(cuda), tau=0.005,
                       shadow=torch.empty(n, dtype=torch.bfloat16, device=cuda),
                       target_shadow=torch.empty(n, dtype=torch.bfloat16,
                                                 device=cuda))
        before = adam_update.launches
        adam_update([gr], optim.AdamConfig(), plain=plain)
        assert adam_update.launches == before + (0 if plain else 1)
        runs.append([gr.p, gr.st.mu, gr.st.nu, gr.target, gr.shadow,
                     gr.target_shadow])
    for a, b in zip(*runs):
        assert _bits_equal(a, b) or (case == "nan" and _bits_equal_nan(
            a.float(), b.float()))
    k = runs[0]
    assert _bits_equal_nan(k[4].float(), k[0].to(torch.bfloat16).float())
    assert _bits_equal(k[5], k[3].to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["onehot", "heads"])
def test_shadows_follow_every_update_path(cuda, arch):
    """The update keeps each bf16 shadow bf16 of its group (B5c writes them
    after the step): after eager kernel updates and after graph replays
    (the capture records the writes) every shadow equals ``bf16(flat)``
    bitwise, and the two paths stay bitwise equal."""
    from distributed_cluster_gpus_tpu_torch.rl.sac import SHADOWED

    a, b = _small_agent(cuda, arch), _small_agent(cuda, arch)
    for n in (1, 4):
        a.train_steps(n, n)
        b.train_steps(n, n, graph=False)
        torch.cuda.synchronize()
        for ag in (a, b):
            for grp in SHADOWED:
                assert _bits_equal(ag.sac.shadow[grp],
                                   ag.sac.flat[grp].to(torch.bfloat16)), grp
    assert a.graph_replays > 0
    assert _same_learner(a, b) == []


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["clip", "no_clip", "saturated"])
def test_adam_update_all_groups_matches_plain_version(cuda, case):
    """B5c over the update's four groups at their published sizes in one
    call (the critic with its Polyak target, log alpha with its clamp):
    every parameter, moment, count and the target bitwise; the clip on and
    off; the count at INT32_MAX stays there."""
    from distributed_cluster_gpus_tpu_torch.kernels.adam import (AdamGroup,
                                                                 adam_update)
    from distributed_cluster_gpus_tpu_torch.rl import optim

    g = torch.Generator().manual_seed(len(case) + 40)
    sizes = {"critic": 287_808, "actor": 69_904, "enc": 144_384, "alpha": 1}
    step = optim.INT32_MAX if case == "saturated" else 7
    clamp = 2.302585
    host = {}
    for grp, n in sizes.items():
        p = torch.randn(n, generator=g)
        if grp == "alpha":
            p.fill_(clamp - 1e-4)
        host[grp] = (p, torch.randn(n, generator=g) * (0.1 if case == "clip" else 1e-4),
                     torch.randn(n, generator=g) * 0.01,
                     torch.rand(n, generator=g) * 1e-4,
                     torch.randn(n, generator=g) if grp == "critic" else None)
    runs = []
    for plain in (False, True):
        groups = []
        for grp, (p, gr, mu, nu, tt) in host.items():
            st = optim.AdamState(torch.tensor(step, dtype=torch.int32).to(cuda),
                                 mu.to(cuda), nu.to(cuda))
            groups.append(AdamGroup(
                p.to(cuda), gr.to(cuda), st, None if tt is None else tt.to(cuda),
                tau=0.005, clamp=clamp if grp == "alpha" else None))
        before = adam_update.launches
        adam_update(groups, optim.AdamConfig(), plain=plain)
        assert adam_update.launches == before + (0 if plain else 1)
        runs.append(groups)
    for a, b in zip(*runs):
        for x, y in ((a.p, b.p), (a.st.mu, b.st.mu), (a.st.nu, b.st.nu),
                     (a.st.count, b.st.count)):
            assert _bits_equal(x, y)
        if a.target is not None:
            assert _bits_equal(a.target, b.target)
        assert int(a.st.count) == (step if case == "saturated" else step + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 256, 4096])
@pytest.mark.parametrize("ring", ["empty", "partial", "full", "wrapped_gaps",
                                  "one_valid", "multi_tile"])
def test_replay_sample_kernel_matches_plain_version(cuda, ring, batch):
    """B6b: indices and the 11 fields bitwise, for a sample key and for an
    update's key derived on the device from a chunk key and its index.
    Rings: empty, partly filled, full, wrapped with invalid holes, one valid
    row, and one of several 4,096-row tiles with its tail tile partial."""
    from distributed_cluster_gpus_tpu_torch.kernels import replay_sample as b6b
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.rl import replay

    C = 10_000 if ring == "multi_tile" else 300
    rb = replay.replay_init(C, 13, 2, 8, 4, device=cuda)
    g = torch.Generator().manual_seed(len(ring))
    sizes, pv = {"empty": ([], 0.0), "partial": ([60, 50], 0.8),
                 "full": ([75] * 5, 1.0), "wrapped_gaps": ([90] * 5, 0.7),
                 "one_valid": ([40], 0.0),
                 "multi_tile": ([2000] * 7, 0.4)}[ring]
    for N in sizes:
        tr = _window(g, N, pv, cuda)
        if ring == "one_valid":
            tr["valid"][7] = True
        replay.replay_add_chunk(rb, tr)
    if ring == "full":
        assert int(rb.size) == C
    key = prng.split(prng.key(5 + batch, cuda), 2)[0]
    index = torch.tensor(3, dtype=torch.int32, device=cuda)
    for idx_arg in (None, index):
        before = b6b.replay_sample.launches
        out_k = b6b.replay_sample(rb, key, batch, index=idx_arg)
        out_p = replay.replay_sample(rb, b6b.sample_key(key, idx_arg), batch)
        assert b6b.replay_sample.launches == before + 1
        for name in (*replay.ROW_FIELDS, "idx"):
            assert _bits_equal(out_k[name], out_p[name]), (name, idx_arg)


def _small_agent(dev, arch, obs_dim=13, n_dc=2, n_g=8, batch=64):
    from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF
    from distributed_cluster_gpus_tpu_torch.rl.replay import replay_add_chunk

    agent = CHSAC_AF(obs_dim=obs_dim, n_dc=n_dc, n_g_choices=n_g, batch=batch,
                     buffer_capacity=500, warmup=50, critic_arch=arch,
                     device=dev)
    g = torch.Generator().manual_seed(4)
    tr = _window(g, 300, 0.7, dev, obs_dim, n_dc, n_g)
    tr["done"] = (torch.rand(300, generator=g) < 0.5).float().to(dev)
    replay_add_chunk(agent.replay, tr)
    return agent


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["onehot", "heads"])
def test_update_kernel_path_matches_plain_path(cuda, arch):
    """Whole updates on the card from one state and key chain, the kernel
    path against the plain path (the matmuls deterministic), at widths
    whose rows cuBLAS cannot load 16 bytes at a time (13 observations, 2
    DCs: the first layer's 26-byte rows, the DC head's 4-byte ones).  There
    cuBLAS runs other product kernels than at aligned widths, and their
    sums differ from B5d's wgmma products in an element now and then (one
    bf16 ulp; ROADMAP queue C), so the learned states are held to the
    bounds the update's parity tests use (``bridge.sac_far_apart``); at
    aligned widths the two paths are bitwise equal (the next test)."""
    from distributed_cluster_gpus_tpu_torch import bridge

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, b = _small_agent(cuda, arch), _small_agent(cuda, arch)
        ma, na = a.train_steps(3, 4)
        mb, nb = b.train_steps(3, 4, plain=True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert na == nb == 3
    assert bridge.sac_far_apart(
        a.cfg, bridge.sac_to_numpy(a.cfg, b.sac),
        bridge.sac_to_numpy(a.cfg, a.sac), 3, (mb, ma)) == []


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["onehot", "heads"])
def test_update_kernel_path_bitwise_at_aligned_widths(cuda, arch):
    """Whole updates on the card from one state and key chain at widths
    whose every operand row is 16-byte aligned (16 observations, 8 DCs):
    the kernel path and the plain path leave every leaf and metric bitwise
    equal (B5d's products sum as cuBLAS's do there)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, b = (_small_agent(cuda, arch, 16, 8) for _ in range(2))
        ma, na = a.train_steps(3, 4)
        mb, nb = b.train_steps(3, 4, plain=True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert na == nb == 3
    for k in ma:
        assert _bits_equal(ma[k], mb[k]), k
    assert _same_learner(a, b) == []


#: the widened envelope's update shapes (batch, n_dc, n_g): an odd batch
#: with 3 + 65 heads' columns (rows TMA cannot load), and the paper fleet's
#: 8 DCs at --max-gpus-per-job 64 at batch 512 (A = 512, 72 columns)
WIDE_UPDATES = [(100, 3, 65), (512, 8, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_dc,n_g", WIDE_UPDATES)
@pytest.mark.parametrize("arch", ["onehot", "heads"])
def test_update_kernel_path_matches_plain_path_widened(cuda, arch, B, n_dc, n_g):
    """Whole updates beyond the published shape (batch and heads the
    kernels refused before the envelope was widened): the kernel path
    within the parity bounds of the plain path, as at the published
    shape, and the CUDA graph bitwise the eager kernel path."""
    from distributed_cluster_gpus_tpu_torch import bridge

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, b, c = (_small_agent(cuda, arch, 13, n_dc, n_g, B) for _ in range(3))
        ma, na = a.train_steps(3, 4)
        mb, nb = b.train_steps(3, 4, plain=True)
        mc, nc = c.train_steps(3, 4, graph=False)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert na == nb == nc == 3 and a.graph_captures == 1
    assert bridge.sac_far_apart(
        a.cfg, bridge.sac_to_numpy(a.cfg, b.sac),
        bridge.sac_to_numpy(a.cfg, a.sac), 3, (mb, ma)) == []
    assert all(_bits_equal(ma[k], mc[k]) for k in ma)
    assert _same_learner(a, c) == []


@pytest.mark.gpu
def test_train_steps_read_nothing_back(cuda):
    agent = _small_agent(cuda, "onehot")
    agent.ingest_chunk(_window(torch.Generator().manual_seed(9), 16, 0.5, cuda))
    agent.train_steps(1, 2)  # loads the libraries
    assert _syncs(lambda: agent.train_steps(2, 2)) == []


def _same_learner(a, b):
    """The bitwise mismatches between two agents' learned states: every
    flat buffer, log alpha, each group's Adam count and moments, the CMDP
    state and the last metrics."""
    bad = [n for n in a.sac.flat if not _bits_equal(a.sac.flat[n], b.sac.flat[n])]
    for grp in ("enc_opt", "actor_opt", "critic_opt", "alpha_opt"):
        sa, sb = getattr(a.sac, grp), getattr(b.sac, grp)
        bad += [(grp, f) for f in ("count", "mu", "nu")
                if not _bits_equal(getattr(sa, f), getattr(sb, f))]
    bad += [("cmdp", f) for f in ("lam", "integral", "prev_err")
            if not _bits_equal(getattr(a.sac.cmdp, f), getattr(b.sac.cmdp, f))]
    bad += [("metric", k) for k in a.sac.metrics
            if not _bits_equal(a.sac.metrics[k], b.sac.metrics[k])]
    if not _bits_equal(a.sac.log_alpha, b.sac.log_alpha) or a.sac.step != b.sac.step:
        bad.append("log_alpha/step")
    return bad


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["onehot", "heads"])
def test_update_graph_matches_eager_kernel_path(cuda, arch):
    """A chunk's updates as one captured CUDA graph replayed per update
    against the same updates run eagerly through the kernels: every leaf of
    the learned state and every metric bitwise, over two chunks (the second
    replays the graph of the first without capturing again)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, b = _small_agent(cuda, arch), _small_agent(cuda, arch)
        for n, max_steps in ((5, 8), (3, 4)):
            ma, na = a.train_steps(n, max_steps)
            mb, nb = b.train_steps(n, max_steps, graph=False)
            torch.cuda.synchronize()
            assert na == nb == n
            assert all(_bits_equal(ma[k], mb[k]) for k in ma)
            assert _same_learner(a, b) == []
    finally:
        torch.use_deterministic_algorithms(False)
    assert (a.graph_captures, a.graph_replays) == (1, 4 + 3)
    assert (b.graph_captures, b.graph_replays) == (0, 0)


@pytest.mark.gpu
def test_update_graph_recaptures_after_replacement(cuda):
    """Replacing what a captured update holds drops the graph: a new replay
    ring, a new learned state (weights loaded), a CMDP state replaced inside
    it; each next chunk captures again and stays bitwise equal to the eager
    path given the same replacements."""
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac
    from distributed_cluster_gpus_tpu_torch.rl.cmdp import cmdp_init

    a, b = _small_agent(cuda, "onehot"), _small_agent(cuda, "onehot")
    for agent in (a, b):
        agent.train_steps(2, 2, graph=agent is a)
    assert a.graph_captures == 1
    fresh = _small_agent(cuda, "onehot")
    replace = [
        lambda ag: setattr(ag, "replay", fresh.replay),
        lambda ag: setattr(ag, "sac", rsac.sac_init(ag.cfg, prng.key(11, "cpu"),
                                                    cuda)),
        lambda ag: setattr(ag.sac, "cmdp", cmdp_init(ag.cfg.constraints, cuda))]
    for i, swap in enumerate(replace):
        for agent in (a, b):
            swap(agent)
            agent.train_steps(3, 4, graph=agent is a)
        torch.cuda.synchronize()
        assert a.graph_captures == 2 + i
        assert _same_learner(a, b) == []


@pytest.mark.gpu
def test_checkpoint_resume_on_the_card_is_bitwise(cuda, tmp_path):
    """A chsac_af run on the card (B1 in RL mode, B2, B6a, the captured
    update) stopped after its first updating chunk, saved, and resumed from
    the store in a fresh agent: every later chunk and its updates are those
    of the run left uninterrupted (the CSV bytes, each chunk's last
    metrics, the final SimState, learner, ring and key bitwise), the
    restored agent's bf16 shadows are bf16 of its masters and its update
    was captured again as a graph and replayed."""
    from distributed_cluster_gpus_tpu_torch.rl.sac import SHADOWED
    from distributed_cluster_gpus_tpu_torch.rl.train import train_chsac
    from distributed_cluster_gpus_tpu_torch.utils.shutdown import ShutdownFlag

    fleet = build_duo_fleet()
    params = SimParams(algo="chsac_af", duration=2.0, log_interval=0.25,
                       job_cap=48, queue_cap=8, lat_window=64, seed=21,
                       inf_rate=15.0, trn_rate=2.0, rl_warmup=24, rl_batch=8,
                       rl_buffer=128)

    def run(out, ckpt=None, shutdown=None, on_chunk=None):
        return train_chsac(fleet, params, out_dir=str(tmp_path / out),
                           chunk_steps=48, max_train_steps_per_chunk=4,
                           device=cuda, ckpt_dir=ckpt, ckpt_every_chunks=1,
                           shutdown=shutdown, on_chunk=on_chunk)

    sf, af, hf = run("full")
    flag = ShutdownFlag()

    def stop_after_first_update(chunk, state, history):
        if history:
            flag.trip(15)

    ck = str(tmp_path / "ck")
    _, a_stop, h_stop = run("part", ck, flag, stop_after_first_update)
    sr, ar, hr = run("part", ck)
    torch.cuda.synchronize()
    assert 0 < a_stop.sac.step < ar.sac.step == af.sac.step
    assert ar.graph_captures >= 1 and ar.graph_replays > 0
    for name in ("cluster_log.csv", "job_log.csv"):
        assert (tmp_path / "full" / name).read_bytes() == \
            (tmp_path / "part" / name).read_bytes(), name
    assert len(h_stop) + len(hr) == len(hf)
    for m_full, m_res in zip(hf[len(h_stop):], hr):
        assert all(m_full[k].tobytes() == m_res[k].tobytes() for k in m_full)
    leaves = [{"sim": bridge.state_to_numpy(s),
               "sac": bridge.sac_to_numpy(a.cfg, a.sac),
               "replay": bridge.replay_to_numpy(a.replay),
               "key": a.key.numpy()} for s, a in ((sf, af), (sr, ar))]
    assert bridge.tree_mismatches(*leaves) == []
    for g in SHADOWED:
        assert _bits_equal(ar.sac.shadow[g], ar.sac.flat[g].to(torch.bfloat16))


@pytest.mark.gpu
def test_update_wrappers_reject_bad_operands(cuda):
    """No fallback: a CUDA operand of the wrong dtype, shape or layout
    raises instead of running the plain version."""
    from distributed_cluster_gpus_tpu_torch.kernels import replay_sample as b6b
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.kernels.adam import (AdamGroup,
                                                                 adam_update)
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.rl import optim, replay

    q = torch.randn((4, 2, 8), device=cuda)
    tgt, taus = torch.randn((4, 8), device=cuda), torch.rand(8, device=cuda)
    with pytest.raises(TypeError):
        b5.quantile_huber(q.double(), tgt, taus)
    q_all, ldc, lg, x = _marginal_inputs(cuda)
    with pytest.raises(ValueError):  # no unit stride over the quantiles
        b5.marginal_actor(q_all.transpose(2, 3), ldc, lg, x["log_alpha"])
    with pytest.raises(ValueError):  # a CPU operand beside CUDA ones
        b5.marginal_actor(q_all, ldc.cpu(), lg, x["log_alpha"])
    p = torch.randn(64, device=cuda)
    with pytest.raises(ValueError):
        adam_update([AdamGroup(p, torch.randn(128, device=cuda)[::2],
                               optim.adam_init(p))], optim.AdamConfig())
    rb = replay.replay_init(32, 13, 2, 8, 4, device=cuda)
    with pytest.raises(ValueError):  # the kernel reads the key on the card
        b6b.replay_sample(rb, prng.key(1, "cpu"), 8)


# ------------------------------------ the update's small regions: B5d-B5g


def _bf16_rows(g, R, N, dev, scale=1.0):
    """Seeded bf16 [R, N] with zeros, negative zeros and ties to even."""
    x = torch.randn((R, N), generator=g) * scale
    x.view(-1)[::7] = 0.0
    x.view(-1)[3::11] = -0.0
    return x.to(torch.bfloat16).to(dev)


@pytest.mark.gpu
def test_param_pack_kernel_matches_plain_version(cuda):
    """B5g's refresh: float32 -> bf16 (ties, subnormals, overflow,
    infinities, NaN), several buffers of odd sizes in one launch,
    bitwise."""
    from distributed_cluster_gpus_tpu_torch.kernels.param_pack import param_pack
    from distributed_cluster_gpus_tpu_torch.rl.optim import pack_plain

    g = torch.Generator().manual_seed(3)
    srcs = []
    for n in (1, 7, 8, 2049, 144_384):
        x = torch.randn(n, generator=g) * 1e3
        x[: min(n, 4)] = torch.tensor([1e-40, 3.4e38, float("inf"), float("nan")])[: min(n, 4)]
        if n > 100:
            x[10:60] = (torch.arange(50, dtype=torch.int32) << 16 | 0x8000).view(
                torch.float32)
        srcs.append(x.to(cuda))
    pairs_k = [(s_, torch.empty_like(s_, dtype=torch.bfloat16)) for s_ in srcs]
    pairs_p = [(s_, torch.empty_like(d)) for s_, d in pairs_k]
    before = param_pack.launches
    param_pack(pairs_k)
    assert param_pack.launches == before + 1
    pack_plain(pairs_p)
    for (_, dk), (_, dp) in zip(pairs_k, pairs_p):
        assert _bits_equal(dk, dp)


#: every forward layer of an update at the published shape (R, K, N): the
#: encoder (K = 49 observations: rows the threads load, TMA cannot), the
#: actor's hidden layer and heads, the critics' taken-action rows and the
#: one-hot critic's 16,384 all-actions rows, the heads critic's output;
#: and the small agents' narrow heads and unaligned inputs (N = 2, K = 266)
FWD_SHAPES = [(256, 49, 256), (256, 256, 256), (256, 256, 8), (256, 256, 32),
              (256, 272, 256), (256, 256, 2048), (16_384, 272, 256),
              (16_384, 256, 256), (16_384, 256, 32), (64, 266, 256), (64, 256, 2),
              # the widened envelope: any row count (a partial last tile),
              # batches up to 4,096, all-actions rows that are not a
              # multiple of a tile, the heads critic at A = 512
              (1, 49, 256), (100, 49, 256), (37, 272, 256), (512, 256, 256),
              (4096, 256, 256), (4096, 256, 32), (8_191, 256, 256),
              (20_000, 256, 32), (512, 256, 16_384)]
#: every fused dX backward (R, N, K' of each product): the hidden layers
#: (K' = 256), a critic twin's layer below its top (K' = 32), the heads
#: critic's (K' = 2,048), the actor's hidden layer (both heads, K' = 8 each)
#: and the small agent's (K' = 2)
DX_SHAPES = [(256, 256, (256,)), (256, 256, (32,)), (256, 256, (2048,)),
             (256, 256, (8, 8)), (64, 256, (2, 8)), (192, 256, (256,)),
             # the widened envelope: 1 to 4,096 rows (several 256-row tiles:
             # the bias gradient's tree finished by the last block), the
             # paper fleet's heads at --max-gpus-per-job 64, 3 x 65 heads
             # (rows TMA cannot load), the heads critic at A = 512
             (1, 256, (256,)), (100, 256, (256,)), (257, 256, (256,)),
             (512, 256, (256,)), (1000, 256, (32,)), (4096, 256, (256,)),
             (512, 256, (8, 64)), (100, 256, (3, 65)), (512, 256, (16_384,))]


def _small_ints(g, shape, dev, lo=-3, hi=4):
    """Small-integer bf16 operands: every float32 sum of their products is
    exact, in any order."""
    return torch.randint(lo, hi, shape, generator=g).to(torch.bfloat16).to(dev)


def _permutation(g, K, N, dev):
    """A bf16 [K, N] with one 1 in each column, at a seeded row: x @ it
    picks columns of x, exactly."""
    w = torch.zeros((K, N))
    w[torch.randint(0, K, (N,), generator=g), torch.arange(N)] = 1.0
    return w.to(torch.bfloat16).to(dev)


def _ulps(a, b):
    """The largest distance in bf16 ulps between two bf16 tensors (their bit
    patterns mapped to ordered integers)."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _fwd_inputs(kind, R, K, N, dev):
    g = torch.Generator().manual_seed(R + 7 * K + 13 * N)
    if kind == "exact":
        x, w = _small_ints(g, (R, K), dev), _small_ints(g, (K, N), dev)
    elif kind == "permutation":
        x, w = _bf16_rows(g, R, K, dev, 4.0), _permutation(g, K, N, dev)
    else:
        x, w = _bf16_rows(g, R, K, dev), _bf16_rows(g, K, N, dev, K ** -0.5)
    sign = torch.randint(0, 2, (N,), generator=g) * 2 - 1
    bias = (torch.randint(1, 7, (N,), generator=g) * 0.25 * sign).to(
        torch.bfloat16).to(dev)  # never 0: a zero product's sign drops out
    return x, w, bias


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "permutation"])
@pytest.mark.parametrize("R,K,N", FWD_SHAPES)
def test_dense_fwd_kernel_matches_plain_version(cuda, R, K, N, kind):
    """B5d forward (``dense_fwd_gemm``), one launch a layer: on operands
    whose products sum exactly in any order (small integers, or a
    permutation matrix, so the epilogue sees general values) the output,
    with and without the ReLU, and its float32 copy into a twin's strided
    slot are bitwise equal to the plain version (``torch.matmul`` and the
    epilogue)."""
    from distributed_cluster_gpus_tpu_torch.kernels.dense import dense_fwd

    x, w, bias = _fwd_inputs(kind, R, K, N, cuda)
    for relu in (False, True):
        outs = [torch.full((R, 2, N), 7.0, device=cuda) for _ in range(2)]
        before = dense_fwd.launches
        yk = dense_fwd(x, w, bias, relu, outs[0][:, 1])
        assert dense_fwd.launches == before + 1
        yp = dense_fwd(x, w, bias, relu, outs[1][:, 1], plain=True)
        assert _bits_equal(yk, yp) and _bits_equal(outs[0], outs[1])
    assert _bits_equal(dense_fwd(x, w, bias, False), dense_fwd(
        x, w, bias, False, plain=True))  # no float32 copy


@pytest.mark.gpu
@pytest.mark.parametrize("R,K,N", FWD_SHAPES)
def test_dense_fwd_kernel_within_an_ulp_on_random_operands(cuda, R, K, N):
    """B5d forward on random operands: every bf16 product (bias 0, no ReLU)
    within one bf16 ulp of the float64 product's rounding, as cuBLAS's
    ``torch.matmul`` is (float32 accumulation pinned, the tensor cores sum
    in their own order).  The operands are non-negative: a sum that cancels
    to a small fraction of its terms loses float32 bits in any order, and
    then neither product is within an ulp of the exact one."""
    from distributed_cluster_gpus_tpu_torch.kernels.dense import dense_fwd
    from distributed_cluster_gpus_tpu_torch.rl.nets import pin_f32_accumulation

    pin_f32_accumulation()
    x, w, _ = _fwd_inputs("random", R, K, N, cuda)
    x, w = x.abs(), w.abs()
    zero = torch.zeros(N, dtype=torch.bfloat16, device=cuda)
    out = torch.empty((R, N), device=cuda)
    y = dense_fwd(x, w, zero, False, out)
    ref = (x.double() @ w.double()).float().to(torch.bfloat16)
    assert _ulps(y, ref) <= 1 and _ulps(torch.matmul(x, w), ref) <= 1
    assert _bits_equal(out, y.float())


def _dx_inputs(kind, R, N, kcs, dev):
    g = torch.Generator().manual_seed(R + N + sum(kcs))
    out = []
    for kc in kcs:
        if kind == "exact":
            out += [_small_ints(g, (R, kc), dev), _small_ints(g, (N, kc), dev)]
        elif kind == "permutation":
            out += [_bf16_rows(g, R, kc, dev, 3.0),
                    _permutation(g, kc, N, dev).t().contiguous()]
        else:
            out += [_bf16_rows(g, R, kc, dev), _bf16_rows(g, N, kc, dev, kc ** -0.5)]
    y = _bf16_rows(g, R, N, dev)
    return out, y


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "permutation"])
@pytest.mark.parametrize("R,N,kcs", DX_SHAPES)
def test_dense_dx_kernel_matches_plain_version(cuda, R, N, kcs, kind):
    """B5d backward fused into the dX product (``dense_dx_gemm``), one
    launch: on exactly summed operands, G (with the ReLU's mask and
    without) and the bias gradient by the tree over the rows are bitwise
    equal to the plain version (``torch.matmul`` of each product, the
    rounded sum, the mask, the tree); R = 192 pads the tree to 256."""
    from distributed_cluster_gpus_tpu_torch.kernels.dense import dense_dx

    ops, y = _dx_inputs(kind, R, N, kcs, cuda)
    for mask in (y, None):
        dbs = [torch.empty(N, dtype=torch.bfloat16, device=cuda) for _ in range(2)]
        before = dense_dx.launches
        Gk = dense_dx(ops[0], ops[1], mask, dbs[0], *ops[2:])
        assert dense_dx.launches == before + 1
        Gp = dense_dx(ops[0], ops[1], mask, dbs[1], *ops[2:], plain=True)
        assert _bits_equal(Gk, Gp) and _bits_equal(dbs[0], dbs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("R,N,kcs", DX_SHAPES)
def test_dense_dx_kernel_within_an_ulp_on_random_operands(cuda, R, N, kcs):
    """B5d's dX on random non-negative operands (as in the forward's test):
    each product's bf16 rounding within one ulp of the float64 product's,
    as ``torch.matmul``'s is; the bias gradient bitwise the plain tree of
    the kernel's G."""
    from distributed_cluster_gpus_tpu_torch.kernels.dense import dense_dx
    from distributed_cluster_gpus_tpu_torch.ops.physics import tree_sum_last
    from distributed_cluster_gpus_tpu_torch.rl.nets import pin_f32_accumulation

    pin_f32_accumulation()
    ops, _ = _dx_inputs("random", R, N, kcs, cuda)
    ops = [t.abs() for t in ops]
    db = torch.empty(N, dtype=torch.bfloat16, device=cuda)
    G = dense_dx(ops[0], ops[1], None, db)
    ref = (ops[0].double() @ ops[1].double().t()).float().to(torch.bfloat16)
    assert _ulps(G, ref) <= 1 and _ulps(torch.matmul(ops[0], ops[1].t()), ref) <= 1
    assert _bits_equal(db, tree_sum_last(G.float().t()).to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("R", [64, 192, 256, 1, 100, 257, 512, 4096])
@pytest.mark.parametrize("N,kind", [(256, "bf16_relu"), (8, "f32_last"),
                                    (32, "f32_last"), (2048, "f32_last"),
                                    (256, "two_relu"), (3, "bf16_relu")])
def test_dense_backward_kernel_matches_plain_version(cuda, R, N, kind):
    """B5d backward of a top layer (``dense_bwd_kernel``): G (the mask, the
    bf16 cast of a float32 gradient from a twin's strided slot, the sum of
    two bf16 gradients) and the bias gradient by the tree over the rows,
    bitwise; R = 192 pads the tree to 256 rows, N = 3 takes the scalar
    loads; R > 256 spans several row tiles (the last block of a column
    group takes the tiles' levels from G)."""
    from distributed_cluster_gpus_tpu_torch.kernels.dense import dense_backward
    from distributed_cluster_gpus_tpu_torch.rl import nets

    g_ = torch.Generator().manual_seed(R * N)
    y = _bf16_rows(g_, R, N, cuda) if kind != "f32_last" else None
    g2 = _bf16_rows(g_, R, N, cuda) if kind == "two_relu" else None
    if kind == "f32_last":
        g = (torch.randn((R, 2, N), generator=g_) * 3).to(cuda)[:, 0]
    else:
        g = _bf16_rows(g_, R, N, cuda, 3.0)
    dbs = [torch.empty(N, dtype=torch.bfloat16, device=cuda) for _ in range(2)]
    before = dense_backward.launches
    Gk = dense_backward(g, y, dbs[0], g2)
    assert dense_backward.launches == before + 1
    Gp = nets.dense_backward(g, y, dbs[1], g2)
    assert _bits_equal(Gk, Gp.contiguous()) and _bits_equal(dbs[0], dbs[1])


#: the fused critic first layer's envelope (B, L, n_dc, n_g): A = 8, 15
#: and 64 joint actions at the small agents' and the published batch, and
#: a latent whose rows are not 16-byte aligned (13 floats, K = 19)
CRITIC_FIRST = [(64, 256, 2, 4), (256, 256, 2, 4), (64, 256, 3, 5),
                (256, 256, 3, 5), (64, 256, 8, 8), (256, 256, 8, 8),
                (64, 13, 2, 4)]


def _critic_first_inputs(kind, B, L, n_dc, n_g, N, dev, seed=0):
    """lat, the taken actions (one outside each head), kernel, bias:
    small integers (every sum exact in any order) or random values."""
    g = torch.Generator().manual_seed(B + L + 7 * n_dc + 13 * n_g + seed)
    K = L + n_dc + n_g
    if kind == "exact":
        lat = torch.randint(-3, 4, (B, L), generator=g).float()
        w = _small_ints(g, (K, N), dev)
    else:
        lat = torch.randn((B, L), generator=g) * 4
        w = _bf16_rows(g, K, N, dev, K ** -0.5)
    a_dc = torch.randint(0, n_dc, (B,), generator=g, dtype=torch.int32)
    a_g = torch.randint(0, n_g, (B,), generator=g, dtype=torch.int32)
    a_dc[1], a_g[2] = n_dc, -1  # no one where an action lies outside its head
    bias = _bf16_rows(g, 1, N, dev)[0]
    return lat.to(dev), a_dc.to(dev), a_g.to(dev), w, bias


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("B,L,n_dc,n_g", CRITIC_FIRST)
def test_critic_first_kernel_matches_plain_version(cuda, B, L, n_dc, n_g, kind):
    """B5e folded into B5d (``critic_first_gemm``), every joint action's
    rows and the taken actions' with their rows written out: on exactly
    summed operands bitwise the plain composition (``critic_input``, then
    ``torch.matmul`` and the epilogue); on random ones bitwise the layer
    ``dense_fwd`` gives on ``critic_input``'s rows (the same wgmma product);
    the rows bitwise always."""
    from distributed_cluster_gpus_tpu_torch.kernels.dense import (
        critic_first_fwd, dense_fwd)
    from distributed_cluster_gpus_tpu_torch.rl import nets

    lat, a_dc, a_g, w, bias = _critic_first_inputs(kind, B, L, n_dc, n_g, 256,
                                                   cuda)
    for acts in ((None, None), (a_dc, a_g)):
        before = critic_first_fwd.launches
        y, x0 = critic_first_fwd(lat, n_dc, n_g, w, bias, *acts, keep_rows=True)
        assert critic_first_fwd.launches == before + 1
        yp, x0p = critic_first_fwd(lat, n_dc, n_g, w, bias, *acts,
                                   keep_rows=True, plain=True)
        assert _bits_equal(x0, x0p)
        assert _bits_equal(y, dense_fwd(x0p, w, bias, True))
        if kind == "exact":
            assert _bits_equal(y, yp)
        y2, none = critic_first_fwd(lat, n_dc, n_g, w, bias, *acts)
        assert none is None and _bits_equal(y2, y)
    assert _bits_equal(x0p, nets.critic_input(lat, n_dc, n_g, a_dc, a_g))


@pytest.mark.gpu
@pytest.mark.parametrize("R", [256, 16_384])
def test_critic_first_kernel_every_plan(cuda, R):
    """The critic's first layer at each tile and ring the C entry point
    takes, as a ring of 1-4 stages cycles (W by TMA, every warp arriving on
    the stage's barrier after its rows) and with the whole K in the ring:
    the taken actions' rows from latents staged by TMA in k-tile boxes,
    every joint action's from latent atoms (no rows kept) or from staged
    latent rows (the rows kept); bitwise equal to one another and to the
    plain composition."""
    import ctypes

    from distributed_cluster_gpus_tpu_torch.kernels import build, dense

    B = R // 64 if R > 256 else R
    lat, a_dc, a_g, w, bias = _critic_first_inputs("exact", B, 256, 8, 8, 256,
                                                   cuda, seed=1)
    acts = (a_dc, a_g) if R == 256 else (None, None)
    want, rows = dense.critic_first_fwd(lat, 8, 8, w, bias, *acts,
                                        keep_rows=True, plain=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = build.bind("dense", "critic_first_launch",
                    [P, P, P, P, I, I, I, I, P, P, P, I, I, I, I, P])
    for keep in (True, False) if R > 256 else (True,):
        for bm, bn in ((128, 128), (64, 64), (128, 64), (64, 128), (128, 256)):
            for stages in (1, 2, 3, 4, 5):
                aux = dense.critic_aux(bm, 256, 1 if R == 256 else 64, R == 256,
                                       keep)
                if 1024 + max(stages * (bm + bn) * 128, bm * (bn + 8) * 2) + \
                        aux + stages * 8 + 16 + 2 * bn > dense.SMEM_MAX:
                    continue
                y = torch.full((R, 256), float("nan"), dtype=torch.bfloat16,
                               device=cuda)
                x0 = torch.full_like(rows, float("nan")) if keep else None
                rc = fn(lat.data_ptr(), *(None if t is None else t.data_ptr()
                                          for t in acts),
                        None if x0 is None else x0.data_ptr(), B, 256, 8, 8,
                        w.data_ptr(), bias.data_ptr(), y.data_ptr(), 256, bm, bn,
                        stages, build.stream_of(cuda))
                torch.cuda.synchronize()
                where = (keep, bm, bn, stages)
                assert rc == 0, where
                assert _bits_equal(y, want), where
                assert not keep or _bits_equal(x0, rows), where


def _heads_inputs(kind, R, n_dc, n_g, dev, seed=0):
    """hid [R, 256] and the heads' kernels and biases (small integers, or a
    permutation: the logits pick seeded entries of hid, exactly), masks
    with a fully masked row, one feasible entry and random ones."""
    g = torch.Generator().manual_seed(R + 7 * n_dc + 13 * n_g + seed)
    K = 256
    if kind == "exact":
        hid = _small_ints(g, (R, K), dev)
        ks = [_small_ints(g, (K, n), dev) for n in (n_dc, n_g)]
    else:
        hid = _bf16_rows(g, R, K, dev, 6.0)
        ks = [_permutation(g, K, n, dev) for n in (n_dc, n_g)]
    bs = [_bf16_rows(g, 1, n, dev)[0] for n in (n_dc, n_g)]
    masks = []
    for n in (n_dc, n_g):
        m = torch.rand((R, n), generator=g) < 0.6
        m[0] = False
        if R > 1:
            m[1] = False
            m[1, n - 1] = True
        masks.append(m.to(dev))
    return hid, ks, bs, masks


#: the heads' widths: the published 8 x 8, the small agents', and the
#: widened envelope's (72, 68, 136 and 256 columns: tiles of 128, 192, 256)
HEADS = [(8, 8), (2, 8), (3, 5), (1, 63), (8, 64), (3, 65), (8, 128),
         (128, 8), (1, 255)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "permutation", "nan"])
@pytest.mark.parametrize("n_dc,n_g", HEADS)
@pytest.mark.parametrize("R", [64, 256, 1, 100, 4096])
def test_actor_heads_kernel_matches_plain_version(cuda, R, n_dc, n_g, kind):
    """B5f's forward folded into the heads' product (``actor_heads_gemm``),
    one launch for both heads: the float32 logits and the masked
    log-probabilities bitwise the plain composition (two ``torch.matmul``
    layers, then ``masked_log_softmax``): a fully masked row, one feasible
    entry, random masks, and (``nan``) a NaN in hid, whose row's logits
    and log-probabilities are all NaN in both; any row count, heads up to
    256 columns together."""
    from distributed_cluster_gpus_tpu_torch.kernels.dense import actor_heads_fwd

    hid, (k_dc, k_g), (b_dc, b_g), (m_dc, m_g) = _heads_inputs(
        "permutation" if kind == "nan" else kind, R, n_dc, n_g, cuda)
    nan_row = min(2, R - 1)
    if kind == "nan":
        hid[nan_row] = float("nan")
        m_dc[nan_row] = m_g[nan_row] = True
    before = actor_heads_fwd.launches
    got = actor_heads_fwd(hid, k_dc, b_dc, k_g, b_g, m_dc, m_g)
    assert actor_heads_fwd.launches == before + 1
    want = actor_heads_fwd(hid, k_dc, b_dc, k_g, b_g, m_dc, m_g, plain=True)
    for k, p in zip(got, want):
        assert _bits_equal_nan(k, p)
    if kind == "nan":
        assert bool(torch.isnan(got[0][nan_row]).all()
                    and torch.isnan(got[1][nan_row]).all())
        assert not bool(torch.isnan(got[0][nan_row + 1:]).any())


@pytest.mark.gpu
def test_fused_inputs_replay_in_a_cuda_graph(cuda):
    """Both fused calls of an update captured in one CUDA graph (the
    critic's 16,384 rows built as the ring cycles, its taken-action rows
    written out, the heads and their log-softmax) and replayed 40 times on
    new inputs: bitwise the plain compositions every time (the rows' proxy
    fence and the stages' barriers hold replay after replay)."""
    from distributed_cluster_gpus_tpu_torch.kernels import dense

    lat, a_dc, a_g, w, bias = _critic_first_inputs("exact", 256, 256, 8, 8, 256,
                                                   cuda)
    hid, (k_dc, k_g), (b_dc, b_g), (m_dc, m_g) = _heads_inputs(
        "permutation", 256, 8, 8, cuda)

    def calls():
        return (dense.critic_first_fwd(lat, 8, 8, w, bias),
                dense.critic_first_fwd(lat, 8, 8, w, bias, a_dc, a_g,
                                       keep_rows=True),
                dense.actor_heads_fwd(hid, k_dc, b_dc, k_g, b_g, m_dc, m_g))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = calls()
    for i in range(40):
        nl, nd, ng, nw, nb = _critic_first_inputs("exact", 256, 256, 8, 8, 256,
                                                  cuda, seed=i + 1)
        nh, nk, nbs, nm = _heads_inputs("permutation", 256, 8, 8, cuda, seed=i + 1)
        for dst, src in ((lat, nl), (a_dc, nd), (a_g, ng), (w, nw), (bias, nb),
                         (hid, nh), (k_dc, nk[0]), (k_g, nk[1]), (b_dc, nbs[0]),
                         (b_g, nbs[1]), (m_dc, nm[0]), (m_g, nm[1])):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = (dense.critic_first_fwd(lat, 8, 8, w, bias, plain=True),
                dense.critic_first_fwd(lat, 8, 8, w, bias, a_dc, a_g,
                                       keep_rows=True, plain=True),
                dense.actor_heads_fwd(hid, k_dc, b_dc, k_g, b_g, m_dc, m_g,
                                      plain=True))
        got = [t for t in (*out[0], *out[1], *out[2]) if t is not None]
        ref = [t for t in (*want[0], *want[1], *want[2]) if t is not None]
        assert len(got) == len(ref) == 7
        assert all(_bits_equal(k, p) for k, p in zip(got, ref)), i


def _heads_grad_inputs(B, n_dc, n_g, dev, seed=0):
    """Both heads' logits (every other row large), masks (a fully masked
    row, one feasible entry, random ones) and dL/dlogp."""
    g = torch.Generator().manual_seed(B + 7 * n_dc + 13 * n_g + seed)
    heads = []
    for n in (n_dc, n_g):
        m = torch.rand((B, n), generator=g) < 0.6
        m[0] = False
        if B > 1:
            m[1] = False
            m[1, n - 1] = True
        logits = torch.randn((B, n), generator=g) * torch.where(
            torch.arange(B) % 2 == 0, 1.0, 40.0)[:, None]
        heads.append((logits.to(dev), m.to(dev),
                      torch.randn((B, n), generator=g).to(dev)))
    return heads


@pytest.mark.gpu
@pytest.mark.parametrize("n_dc,n_g", [(8, 8), (2, 8), (1, 64), (3, 65), (8, 64),
                                      (8, 128), (128, 8), (1, 255)])
@pytest.mark.parametrize("B", [256, 1, 100, 512, 4096])
def test_log_softmax_backward_kernel_matches_plain_version(cuda, B, n_dc, n_g):
    """B5f's backward fused with the heads' top-layer backward
    (``heads_backward``): both heads' bf16 gradients and bias gradients in
    one launch, bitwise the plain composition (``masked_log_softmax_
    backward``, then ``dense_backward``; CUDA's expf is torch's exp):
    random masks, fully masked rows, one feasible entry, large logits, at
    1 to 4,096 rows (several 256-row tiles: the bias
    gradients' trees finished by a last block) and heads up to 256
    entries."""
    from distributed_cluster_gpus_tpu_torch.kernels import log_softmax as b5f
    from distributed_cluster_gpus_tpu_torch.rl import nets

    (l0, m0, c0), (l1, m1, c1) = _heads_grad_inputs(B, n_dc, n_g, cuda)
    dbs = [torch.empty(n, dtype=torch.bfloat16, device=cuda)
           for n in (n_dc, n_g, n_dc, n_g)]
    before = b5f.heads_backward.launches
    got = b5f.heads_backward(l0, l1, m0, m1, c0, c1, dbs[0], dbs[1])
    assert b5f.heads_backward.launches == before + 1
    want = nets.heads_backward_plain(l0, l1, m0, m1, c0, c1, dbs[2], dbs[3])
    for k in range(2):
        assert _bits_equal(got[k], want[k]) and _bits_equal(dbs[k], dbs[k + 2])


@pytest.mark.gpu
def test_heads_backward_nan_logit(cuda):
    """A NaN logit: its row's gradient is NaN where the mask lets it
    through in both versions, every other row bitwise; the bias gradient
    of the columns the row reaches is NaN in both."""
    from distributed_cluster_gpus_tpu_torch.kernels import log_softmax as b5f
    from distributed_cluster_gpus_tpu_torch.rl import nets

    (l0, m0, c0), (l1, m1, c1) = _heads_grad_inputs(300, 8, 64, cuda, seed=3)
    l1[5, 7] = float("nan")
    m1[5] = True
    dbs = [torch.empty(n, dtype=torch.bfloat16, device=cuda)
           for n in (8, 64, 8, 64)]
    got = b5f.heads_backward(l0, l1, m0, m1, c0, c1, dbs[0], dbs[1])
    want = nets.heads_backward_plain(l0, l1, m0, m1, c0, c1, dbs[2], dbs[3])
    for k in range(2):
        assert _bits_equal_nan(got[k].float(), want[k].float())
        assert _bits_equal_nan(dbs[k].float(), dbs[k + 2].float())
    assert bool(torch.isnan(got[1][5].float()).all())


@pytest.mark.gpu
def test_heads_backward_replays_in_a_cuda_graph(cuda):
    """The fused heads' backward over several row tiles (its arrival counts
    reset by the last block) captured once and replayed 20 times on new
    inputs: bitwise the plain composition every time."""
    from distributed_cluster_gpus_tpu_torch.kernels import log_softmax as b5f
    from distributed_cluster_gpus_tpu_torch.rl import nets

    ins = [t for h in _heads_grad_inputs(600, 8, 72, cuda) for t in h]
    dbs = [torch.empty(n, dtype=torch.bfloat16, device=cuda) for n in (8, 72)]

    def calls():
        l0, m0, c0, l1, m1, c1 = ins
        return [b5f.heads_backward(l0, l1, m0, m1, c0, c1, *dbs)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = calls()
    for i in range(20):
        new = [t for h in _heads_grad_inputs(600, 8, 72, cuda, seed=i + 1)
               for t in h]
        for dst, src in zip(ins, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        l0, m0, c0, l1, m1, c1 = ins
        ref = [torch.empty_like(d) for d in dbs]
        want = nets.heads_backward_plain(l0, l1, m0, m1, c0, c1, *ref)
        for got in out:
            assert all(_bits_equal(k, p) for k, p in zip(got, want)), i
        assert all(_bits_equal(d, r) for d, r in zip(dbs, ref)), i


@pytest.mark.gpu
def test_fused_region_wrappers_reject_bad_operands(cuda):
    """No fallback: a CUDA operand of the wrong dtype, shape or layout
    raises instead of running the plain version."""
    from distributed_cluster_gpus_tpu_torch.kernels.dense import (
        actor_heads_fwd, critic_first_fwd, dense_backward, dense_dx, dense_fwd)
    from distributed_cluster_gpus_tpu_torch.kernels.log_softmax import \
        heads_backward
    from distributed_cluster_gpus_tpu_torch.kernels.param_pack import param_pack

    x = torch.zeros((64, 8), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((8, 8), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros(8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        dense_fwd(x, k.float(), b, True)
    with pytest.raises(ValueError):  # the float32 copy needs unit column stride
        dense_fwd(x, k, b, True, torch.zeros((8, 64), device=cuda).t())
    with pytest.raises(ValueError):  # no rows
        dense_fwd(x[:0], k, b, True)
    with pytest.raises(ValueError):  # x needs unit column stride
        dense_fwd(torch.zeros((8, 64), dtype=torch.bfloat16, device=cuda).t(),
                  k, b, True)
    with pytest.raises(ValueError):  # the bias gradient's tree: R <= 4,096
        dense_dx(torch.zeros((4097, 8), dtype=torch.bfloat16, device=cuda), k,
                 None, b)
    with pytest.raises(ValueError):  # a second gradient needs its kernel
        dense_dx(x, k, None, b, x)
    with pytest.raises(ValueError):
        dense_backward(x[:8].t(), None, b[:4])
    with pytest.raises(ValueError):
        dense_backward(torch.zeros((4097, 8), device=cuda), None, b)
    lat = torch.zeros((64, 3), device=cuda)
    w1 = torch.zeros((8, 16), dtype=torch.bfloat16, device=cuda)
    b1 = torch.zeros(16, dtype=torch.bfloat16, device=cuda)
    a64 = torch.zeros(64, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):  # the kernel reads int32 actions
        critic_first_fwd(lat, 2, 3, w1, b1, a64, a64)
    with pytest.raises(ValueError):  # no rows
        critic_first_fwd(lat[:0], 2, 3, w1, b1)
    with pytest.raises(ValueError):  # the kernel's depth is L + n_dc + n_g
        critic_first_fwd(lat, 2, 4, w1, b1)
    m8 = torch.ones((64, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):  # a CPU mask beside CUDA operands
        actor_heads_fwd(x, k, b, k, b, m8, m8.cpu())
    with pytest.raises(ValueError):  # no rows
        actor_heads_fwd(x[:0], k, b, k, b, m8[:0], m8[:0])
    wide = torch.zeros((8, 250), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # both heads in one tile of <= 256
        actor_heads_fwd(x, k, b, wide, wide[0], m8,
                        torch.ones((64, 250), dtype=torch.bool, device=cuda))
    db3, db2 = (torch.zeros(n, dtype=torch.bfloat16, device=cuda) for n in (3, 2))
    with pytest.raises(ValueError):  # a CPU mask beside CUDA operands
        heads_backward(torch.zeros((4, 3), device=cuda),
                       torch.zeros((4, 2), device=cuda),
                       torch.ones((4, 3), dtype=torch.bool, device=cuda),
                       torch.ones((4, 2), dtype=torch.bool).cpu(),
                       torch.zeros((4, 3), device=cuda),
                       torch.zeros((4, 2), device=cuda), db3, db2)
    with pytest.raises(ValueError):  # rows: 1 to 4,096
        heads_backward(*(torch.zeros((4097, n), device=cuda) for n in (3, 2)),
                       *(torch.ones((4097, n), dtype=torch.bool, device=cuda)
                         for n in (3, 2)),
                       *(torch.zeros((4097, n), device=cuda) for n in (3, 2)),
                       db3, db2)
    with pytest.raises(TypeError):
        param_pack([(torch.zeros(8, device=cuda), torch.zeros(8, device=cuda))])
    with pytest.raises(TypeError):  # the widening runs inside B5c
        param_pack([(torch.zeros(8, device=cuda, dtype=torch.bfloat16),
                     torch.zeros(8, device=cuda))])


@pytest.mark.gpu
def test_update_graph_recaptures_after_buffer_replacement(cuda):
    """Replacing a bf16 parameter shadow or a gradient staging buffer that a
    captured update holds drops the graph: the next chunk captures again
    and stays bitwise equal to the eager path given the same
    replacements (a new shadow filled by the refresh, as any write of the
    shadows outside the update must be)."""
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    a, b = _small_agent(cuda, "onehot"), _small_agent(cuda, "onehot")
    for agent in (a, b):
        agent.train_steps(2, 2, graph=agent is a)
    assert a.graph_captures == 1
    for i, (bufs, grp) in enumerate((("shadow", "critic"), ("shadow", "target"),
                                     ("stage", "enc"))):
        for agent in (a, b):
            d = getattr(agent.sac, bufs)
            d[grp] = torch.full_like(d[grp], float("nan"))
            if bufs == "shadow":  # a new shadow is filled by the refresh
                rsac.refresh_shadows(agent.sac)
            agent.train_steps(3, 4, graph=agent is a)
        torch.cuda.synchronize()
        assert a.graph_captures == 2 + i
        assert _same_learner(a, b) == []
        assert all(bool(torch.isfinite(v).all()) for v in a.sac.metrics.values())


# ----------------------------------------------- the float64 clock's kernels

#: a state bridged to t = 6.0e5 s, where a float32 clock's ulp is 1/16 s
T_LATE = 6.0e5
#: a quarter second before hour 7 of day 7: the eco sites' hour changes
T_HOUR = 6 * 86400 + 7 * 3600.0 - 0.25


def bridged(state, t0, log_interval):
    """A lane-stacked state moved to clock ``t0`` in place: the streams'
    next arrivals and epochs (the sinusoid's inversion anchors at its
    epoch) and the log tick shifted with it."""
    shift = torch.tensor(t0, dtype=state.t.dtype, device=state.t.device)
    state.t.fill_(t0)
    state.next_arrival.add_(shift)
    state.arr_epoch.add_(shift)
    state.next_log_t.fill_(t0 + log_interval)
    return state


def _f64(params, **kw):
    import dataclasses

    return dataclasses.replace(params, time_dtype="float64", **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("start", [None, T_LATE], ids=["init", "late"])
@pytest.mark.parametrize("threads", HEUR_WIDTHS)
@pytest.mark.parametrize("fleet_name", ["duo", "single"])
@pytest.mark.parametrize("algo", ["default_policy", "joint_nf"])
def test_event_scan_float64_matches_plain_version(cuda, algo, fleet_name,
                                                  threads, start):
    """B1's double instance (csrc/event_scan64.cu) against the plain step
    under the float64 clock, bitwise: state (double clock, slab time
    columns, accumulators, ring records), key words and emissions, two
    chunks, from init_state and from t = 6e5 s."""
    fleet = FLEETS[fleet_name]()
    params = _f64(SimParams(algo=algo, duration=(start or 0.0) + 400.0,
                            lat_window=64, seed=5, **LOADS[fleet_name]))
    eng = Engine(fleet, params, device=cuda)
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device=cuda))
    if start is not None:
        bridged(st, start, params.log_interval)
    assert st.t.dtype == torch.float64
    before = (b1.event_scan.launches, b1.event_scan.x64_launches)
    assert kernel_vs_plain(eng, st, N_STEPS, 2, threads) == []
    assert (b1.event_scan.launches, b1.event_scan.x64_launches) == (
        before[0] + 2, before[1] + 2)
    assert int(st.n_finished.sum()) > 20


@pytest.mark.gpu
@pytest.mark.parametrize("threads", HEUR_WIDTHS)
@pytest.mark.parametrize("case", ["eco_cost", "carbon_cost", "cap_greedy",
                                  "cap_uniform", "bandit"])
def test_event_scan_float64_extended_instance(cuda, case, threads):
    """The extended instance's double build, bitwise against the plain
    step, from just before hour 7 of day 7 (the hour of the eco sites
    changes past 1e5 s), the cap controllers firing as often."""
    fleet_name, algo, kw = EXT_CASES[case]
    fleet = FLEETS[fleet_name]()
    params = _f64(SimParams(algo=algo, duration=T_HOUR + 400.0, lat_window=64,
                            seed=5, **LOADS[fleet_name], **kw))
    eng = Engine(fleet, params, device=cuda)
    st = bridged(with_lane_axis(init_state(params.seed, fleet, params,
                                           workload=eng.workload, device=cuda)),
                 T_HOUR, params.log_interval)
    bad, ctl_k, ctl_r = ext_kernel_vs_plain(eng, st, N_STEPS, 2, threads)
    assert bad == [] and ctl_k == ctl_r
    assert float(st.t.max()) > T_HOUR
    if algo.startswith("cap_"):
        assert sum(t for t, _ in ctl_k) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("threads", RL_WIDTHS)
@pytest.mark.parametrize("n_g", [8, 128])
def test_event_scan_float64_rl_mode(cuda, n_g, threads):
    """RL mode's double build (B3, B4 and the tail commit in the event
    loop) bitwise against the plain step, from t = 6e5 s, at 8-wide and
    128-wide GPU-count heads (the two RL instances)."""
    fl, kw = RL_LOADS["duo"]
    fleet = FLEETS[fl]()
    params = _f64(SimParams(algo="chsac_af", duration=T_LATE + 400.0,
                            lat_window=64, seed=3,
                            **dict(kw, max_gpus_per_job=n_g)))
    eng, agent = _rl_engine(fleet, params, cuda)
    st = bridged(with_lane_axis(init_state(params.seed, fleet, params,
                                           workload=eng.workload, device=cuda)),
                 T_LATE, params.log_interval)
    before = b1.event_scan.x64_launches
    assert rl_kernel_vs_plain(eng, agent.sac, st, N_STEPS, 2, threads) == []
    assert b1.event_scan.x64_launches == before + 2
    assert int(st.jobs.rl_valid.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("threads", HEUR_WIDTHS)
def test_event_scan_float64_lanes_and_run_end(cuda, threads):
    """Three lanes of the double build in one launch, past the run's end,
    against the plain version."""
    fleet = build_duo_fleet()
    params = _f64(SimParams(duration=3.0, job_cap=100, queue_cap=16,
                            lat_window=16, log_interval=0.5, seed=1))
    eng = Engine(fleet, params, device=cuda)
    st = batched_init(fleet, params, 3, workload=eng.workload, device=cuda)
    assert kernel_vs_plain(eng, st, 512, 3, threads) == []
    assert bool(st.done.all())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2047, 4096, 4097])
@pytest.mark.parametrize("lanes", [1, 32])
def test_arrival_tables_float64_bitwise(cuda, lanes, n):
    """B2's double instance: every output (float32 sizes, float64 folds,
    next arrivals, key words and uniforms) bitwise the plain version's, one
    lane and 32 in one launch, from t = 6e5 s."""
    fleet = build_fleet()
    params = _f64(SimParams(queue_cap=64, job_cap=32, seed=5, inf_amp=0.8,
                            duration=7e5))
    wt = compile_workload(fleet, params, cuda)
    st = bridged(batched_init(fleet, params, lanes, workload=wt, device=cuda),
                 T_LATE, params.log_interval)
    S = wt.n_streams
    args = [st.arr_key, st.arr_count.reshape(lanes, S).contiguous(),
            st.next_arrival.reshape(lanes, S).contiguous(),
            st.arr_cum.reshape(lanes, S).contiguous(),
            st.arr_epoch.reshape(lanes, S).contiguous(), wt.family_t,
            wt.sparams]
    if lanes == 1:
        args = [a[0] for a in args[:5]] + args[5:]
    before = b2.arrival_tables.x64_launches
    out = b2.arrival_tables(*args, n, with_aux=True)
    assert b2.arrival_tables.x64_launches == before + 1
    ref = b2.arrival_tables_reference(*args, n, with_aux=True)
    torch.cuda.synchronize()
    assert out["cum"].dtype == out["tnext"].dtype == torch.float64
    for k, v in ref.items():
        assert _bits_equal(out[k], v), k


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 256, 4096])
@pytest.mark.parametrize("ring", ["partial", "wrapped_gaps", "multi_tile"])
def test_replay_sample_x64_kernel_matches_plain_version(cuda, ring, batch):
    """B6b's float64 draw (the float64 clock's update): indices and fields
    bitwise the plain version's under x64."""
    from distributed_cluster_gpus_tpu_torch.kernels import replay_sample as b6b
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.rl import replay

    C = 10_000 if ring == "multi_tile" else 300
    rb = replay.replay_init(C, 13, 2, 8, 4, device=cuda)
    g = torch.Generator().manual_seed(len(ring))
    sizes, pv = {"partial": ([60, 50], 0.8), "wrapped_gaps": ([90] * 5, 0.7),
                 "multi_tile": ([2000] * 7, 0.4)}[ring]
    for N in sizes:
        replay.replay_add_chunk(rb, _window(g, N, pv, cuda))
    key = prng.split(prng.key(5 + batch, cuda), 2)[0]
    index = torch.tensor(3, dtype=torch.int32, device=cuda)
    for idx_arg in (None, index):
        before = b6b.replay_sample.x64_launches
        out_k = b6b.replay_sample(rb, key, batch, index=idx_arg, x64=True)
        out_p = replay.replay_sample(rb, b6b.sample_key(key, idx_arg), batch,
                                     x64=True)
        assert b6b.replay_sample.x64_launches == before + 1
        for name in (*replay.ROW_FIELDS, "idx"):
            assert _bits_equal(out_k[name], out_p[name]), (name, idx_arg)


@pytest.mark.gpu
@pytest.mark.parametrize("step", [0, 1, 999, 4999])
def test_adam_x64_kernel_matches_plain_version(cuda, step):
    """B5c with the float64 bias corrections (optax under x64): parameters,
    moments and count bitwise the plain version's."""
    from distributed_cluster_gpus_tpu_torch.kernels.adam import (AdamGroup,
                                                                 adam_update)
    from distributed_cluster_gpus_tpu_torch.rl import optim

    g = torch.Generator().manual_seed(step)
    n = 70_001
    p = torch.randn(n, generator=g)
    grad = torch.randn(n, generator=g) * 0.01
    mu = torch.randn(n, generator=g) * 0.01 if step else torch.zeros(n)
    nu = torch.rand(n, generator=g) * 1e-4 if step else torch.zeros(n)
    outs = []
    for kernel in (True, False):
        st = optim.AdamState(count=torch.tensor(step, dtype=torch.int32).to(cuda),
                             mu=mu.to(cuda), nu=nu.to(cuda))
        pp = p.to(cuda)
        before = adam_update.x64_launches
        adam_update([AdamGroup(pp, grad.to(cuda), st)],
                    optim.AdamConfig(x64=True), plain=not kernel)
        assert adam_update.x64_launches == before + kernel
        outs.append([pp, st.mu, st.nu, st.count])
    for a, b in zip(*outs):
        assert _bits_equal(a, b)
