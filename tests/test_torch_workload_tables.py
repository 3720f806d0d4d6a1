"""B2's trace, rate_timeline and thinning families vs the JAX package (CPU).

The same initial state (the JAX ``init_state``, carried over by the bridge)
and the same spec (the duo fleet's four streams: a trace with sizes, a
periodic and a finite rate timeline with zero-rate bins, thinning at amp
2): the port's ``init_clocks`` and ``tables`` (B2's plain version) against
``WorkloadProgram``'s over three chunks, each chunk's state carried by both
sides alike, on the float32 clock and under x64 on the float64 clock.  The
port's own tables of every family on the paper fleet (traces with and
without sizes and an empty one, thinning at amp -1.5 too) are
chunk-invariant bit for bit.

Tolerances (``tests/test_torch_workload.py``'s): cursors and the
trace family exactly; sizes within 32 ulp (the samplers' ``pow``/``exp``);
folds within 1e-5 relative; next arrivals within 1e-4 * max(t, 1 s).  The
inversion of a rate timeline is exact given the same fold (its wrap's
remainder and base are XLA's fused multiply-adds, ``invert_timeline``).  A
thinning replay's acceptance test can flip when the port's ``log`` or
``sin`` differs from XLA's by an ulp, and a flip moves every later entry
of the stream: the test counts the flipped entries (the first entry of a
stream past the tolerance) and the entries after them, reports them, and
holds the count to what was measured on these seeds: no flip, so every
thinning entry of every chunk lies within the tolerance (amp 2 on both
clocks, and the legacy sinusoids' draws).
"""

import jax
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet as jduo
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu.workload import workload_from_dict as jdoc
from distributed_cluster_gpus_tpu.workload.compiler import WorkloadProgram as JW
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.configs.paper import build_fleet
from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.sim.engine import init_state
from distributed_cluster_gpus_tpu_torch.workload import workload_from_dict as tdoc
from distributed_cluster_gpus_tpu_torch.workload.compiler import WorkloadProgram as TW
from test_torch_signals_gpu import families_doc
from test_torch_workload import _leaf, _ulps

N = 96
N_CHUNKS = 3


def _close(a, b, rel):
    both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    with np.errstate(invalid="ignore"):
        return both_inf | (np.abs(a - b) <= rel * np.maximum(np.abs(a), 1.0))


def duo_doc():
    """The duo fleet's streams: a trace with sizes, a periodic rate
    timeline; a finite one, thinning at amp 2 (each with its zero-rate
    bins; ``families_doc``'s first two ingresses)."""
    doc = families_doc(2)
    return dict(doc, streams=doc["streams"][:2])


def _setup(td, seed=3):
    fj = jduo()
    ft = bridge.fleet_from_numpy(fj)
    doc = duo_doc()
    kw = dict(time_dtype=td, job_cap=16, queue_cap=16, seed=seed)
    sj_spec, st_spec = jdoc(doc, n_ing=fj.n_ing), tdoc(doc, n_ing=ft.n_ing)
    pj = JParams(workload=sj_spec, **kw)
    wj = JW(fj, pj, sj_spec)
    sj = jinit(jax.random.key(seed), fj, pj, workload=wj)
    wt = TW(ft, SimParams(workload=st_spec, **kw), st_spec, device="cpu")
    return fj, ft, wj, sj, wt


def _advance(tj, sj, st, wj, wt, used):
    """Both sides consume ``used`` entries of every stream (the engine's
    in-step clock advance: the clock becomes the last consumed entry)."""
    S = wt.n_streams
    tn = np.asarray(tj["tnext"])[:, used - 1]
    sj = sj.replace(arr_count=sj.arr_count + used,
                    next_arrival=jax.numpy.asarray(tn.reshape(sj.next_arrival.shape)))
    sj = wj.advance_carries(sj, tj)
    st.arr_count += used
    st.next_arrival.copy_(torch.from_numpy(np.array(tn)).reshape(st.next_arrival.shape))
    wt.advance_carries(st, {k: torch.from_numpy(np.array(v)) for k, v in tj.items()})
    assert S == st.arr_count.numel()
    return sj


@pytest.mark.parametrize("td", ["float32", "float64"])
def test_new_families_match_reference(td):
    with jax.enable_x64(td == "float64"):
        fj, ft, wj, sj, wt = _setup(td)
        st_port = init_state(3, ft, wt.params, workload=wt, device="cpu")
        for name in ("next_arrival", "arr_epoch"):
            a, b = np.asarray(getattr(sj, name)), getattr(st_port, name).numpy()
            assert _close(a, b, 1e-4).all(), name
        assert _close(np.asarray(sj.arr_cum), st_port.arr_cum.numpy(), 1e-5).all()
        # the trace and timeline clocks are exact (no sampler in them)
        fam = np.asarray(wt._codes).reshape(-1, 2)
        exact = (fam == b2.FAM_TRACE)
        assert (np.asarray(sj.next_arrival)[exact]
                == st_port.next_arrival.numpy()[exact]).all()
        tables_j = jax.jit(lambda s: wj.tables(s, N))
        st = bridge.state_from_numpy(bridge.tree_to_numpy(sj, _leaf), "cpu")
        fams = wt._codes
        assert sorted(fams) == [b2.FAM_TRACE, b2.FAM_RATE_TL, b2.FAM_RATE_TL,
                                b2.FAM_THIN]
        consts = wt.consts(wt.params.tdtype)
        flips, after = [], 0
        for c in range(N_CHUNKS):
            tj = tables_j(sj)
            tt = wt.tables(st, N)
            assert np.asarray(tj["c0"]).tobytes() == tt["c0"].numpy().tobytes()
            assert _ulps(tj["sizes"], tt["sizes"]).max() <= 32
            cj, ct = np.asarray(tj["cum"]), tt["cum"].numpy()
            nj, nt = np.asarray(tj["tnext"]), tt["tnext"].numpy()
            for s, f in enumerate(fams):
                if f == b2.FAM_THIN:
                    ok = _close(nj[s], nt[s], 1e-4)
                    if not ok.all():
                        first = int(np.argmin(ok))
                        flips.append((c, s, first))
                        after += N - first
                    continue
                assert _close(cj[s], ct[s], 1e-5).all(), (c, s)
                if f == b2.FAM_TRACE:
                    assert nj[s].tobytes() == nt[s].tobytes(), (c, s)
                else:
                    assert _close(nj[s], nt[s], 1e-4).all(), (c, s)
                if f == b2.FAM_RATE_TL:
                    # the reference's folds through the port's inversion
                    # give the reference's arrivals bit for bit (the
                    # inversion is not library math)
                    off, T, _, per = consts.meta[s].tolist()
                    got = b2.invert_timeline(
                        consts.cbuf[off:off + 2 * T + 3], T, bool(per),
                        torch.from_numpy(np.array(cj[s])))
                    assert got.numpy().tobytes() == nj[s].tobytes(), (c, s)
            sj = _advance(tj, sj, st, wj, wt, N // 2 + c)
        n_thin = sum(f == b2.FAM_THIN for f in fams)
        print(f"thinning flips ({td}): {len(flips)} of {n_thin * N_CHUNKS} "
              f"stream-chunks, {after} of {n_thin * N * N_CHUNKS} entries "
              f"after one: {flips}")
        assert flips == []


def test_thinning_on_legacy_sinusoids_matches_the_legacy_draws():
    """``inversion=False``: every sinusoid stream (|amp| <= 1 too) takes the
    thinning replay, as the reference's ``inversion=False`` tables do; the
    flips are counted as above and none is allowed."""
    from distributed_cluster_gpus_tpu.configs import build_duo_fleet as jduo
    from distributed_cluster_gpus_tpu.workload.compiler import compile_workload

    fj = jduo()
    ft = bridge.fleet_from_numpy(fj)
    kw = dict(inf_rate=40.0, inf_amp=0.8, inf_period=5.0, job_cap=16,
              queue_cap=16, seed=4)
    wj = compile_workload(fj, JParams(**kw))
    sj = jinit(jax.random.key(4), fj, wj.params, workload=wj)
    wt = TW(ft, SimParams(**kw), __import__(
        "distributed_cluster_gpus_tpu_torch.workload.compiler",
        fromlist=["legacy_spec"]).legacy_spec(SimParams(**kw)), device="cpu",
        inversion=False)
    assert b2.FAM_THIN in wt._codes
    st = bridge.state_from_numpy(bridge.tree_to_numpy(sj, _leaf), "cpu")
    tj = jax.jit(lambda s: wj.tables(s, N, inversion=False))(sj)
    tt = wt.tables(st, N)
    nj, nt = np.asarray(tj["tnext"]), tt["tnext"].numpy()
    flips = 0
    for s, f in enumerate(wt._codes):
        ok = _close(nj[s], nt[s], 1e-4)
        flips += int(not ok.all())
        if f == b2.FAM_THIN and ok.all():
            assert (nj[s] == nt[s]).mean() > 0.9, s
    print(f"legacy thinning flips: {flips} of {wt.n_streams} streams")
    assert flips == 0


@pytest.mark.parametrize("td", ["float32", "float64"])
def test_port_tables_chunk_invariant(td):
    """One table of 2n equals two tables of n bit for bit, every family on
    the paper fleet, when the carries advance between them as the engine
    advances them."""
    ft = build_fleet()
    spec = tdoc(families_doc(ft.n_ing), n_ing=ft.n_ing)
    params = SimParams(workload=spec, time_dtype=td, job_cap=16,
                       queue_cap=16, seed=11)
    wt = TW(ft, params, spec, device="cpu")
    st = init_state(11, ft, params, workload=wt, device="cpu")
    whole = wt.tables(st, 2 * N)
    first = wt.tables(st, N)
    st.arr_count += N
    st.next_arrival.copy_(first["tnext"][:, N - 1].reshape(st.next_arrival.shape))
    wt.advance_carries(st, first)
    second = wt.tables(st, N)
    # the fold is the carry of the poisson, sin_inv and timeline streams
    # (a trace's or thinning replay's is its clock, restarted each chunk)
    folds = torch.tensor([f in (b2.FAM_POISSON, b2.FAM_SIN_INV, b2.FAM_RATE_TL)
                          for f in wt._codes])
    for k in ("sizes", "tnext", "cum"):
        joined = torch.cat([first[k], second[k]], dim=1)
        rows = folds if k == "cum" else torch.ones_like(folds)
        assert joined[rows].numpy().tobytes() == whole[k][rows].numpy().tobytes(), k
    # a trace's cursor reads past its end as inf; an empty trace never fires
    fam = np.asarray(wt._codes)
    assert np.isinf(whole["tnext"].numpy()[fam == b2.FAM_TRACE][:, -1]).any()


def test_runtime_trace_override_is_refused():
    ft = bridge.fleet_from_numpy(jduo())
    spec = tdoc(duo_doc(), n_ing=2)
    params = SimParams(workload=spec, job_cap=16, queue_cap=16)
    wt = TW(ft, params, spec, device="cpu")
    st = init_state(3, ft, params, workload=wt, device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        wt.tables(st, 4, trace={0: None})
