"""The port's workload compiler (and the B2 plain version) vs the JAX one.

Same initial state (the JAX ``init_state``, carried over by the bridge),
same stream specs: the port's ``init_clocks``/``tables``/``advance_carries``
must agree with ``WorkloadProgram``'s within the sampler tolerances that
``tests/test_torch_ops.py`` measures (counts and cursors exactly), and the
port must be chunk-invariant bit for bit on its own.

Tolerances: sizes within 32 ulp (the LogNormal exp), the cumulative folds
within 1e-5 relative (sums of Exp draws that differ by <= 1 ulp each),
next-arrival clocks within 1e-4 * max(t, 1 s) (the sinusoid inversion).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet as jduo
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu.workload.compiler import compile_workload as jcompile
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.configs.paper import build_duo_fleet
from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.sim.engine import init_state
from distributed_cluster_gpus_tpu_torch.workload.compiler import compile_workload

N = 256
CONFIGS = {
    # the defaults: sinusoid inference (inversion) + poisson training
    "sin_inv+poisson": dict(),
    "poisson+poisson": dict(inf_mode="poisson", inf_rate=4.0),
    "sin_inv+off": dict(inf_amp=1.0, inf_period=60.0, trn_mode="off"),
}


def _leaf(x):
    if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x))
    return np.asarray(x)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _close_t(a, b):
    a, b = np.asarray(a), np.asarray(b)
    both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    with np.errstate(invalid="ignore"):
        ok = both_inf | (np.abs(a - b) <= 1e-4 * np.maximum(np.abs(a), 1.0))
    return bool(ok.all())


def _pair(cfg, seed):
    kw = dict(queue_cap=64, job_cap=32, seed=seed, **CONFIGS[cfg])
    fj = jduo()
    pj = JParams(**kw)
    sj = jinit(jax.random.key(seed), fj, pj)
    wj = jcompile(fj, pj)
    wt = compile_workload(build_duo_fleet(), SimParams(**kw), "cpu")
    return sj, wj, wt


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_init_clocks_match(cfg):
    for seed in (0, 5, 123):
        sj, wj, wt = _pair(cfg, seed)
        st = init_state(seed, build_duo_fleet(), wt.params, workload=wt,
                        device="cpu")
        assert (st.arr_key.numpy() == np.asarray(
            jax.random.key_data(sj.arr_key)).astype(np.int64)).all()
        assert (st.key.numpy() == np.asarray(
            jax.random.key_data(sj.key)).astype(np.int64)).all()
        for name in ("next_arrival", "arr_epoch"):
            assert _close_t(getattr(sj, name), getattr(st, name).numpy()), name
        assert np.asarray(sj.arr_cum).tobytes() == st.arr_cum.numpy().tobytes()


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_tables_and_advance_carries_match(cfg):
    sj, wj, wt = _pair(cfg, 7)
    st = bridge.state_from_numpy(bridge.tree_to_numpy(sj, _leaf), "cpu")
    tj = jax.jit(lambda s: wj.tables(s, N))(sj)
    tt = wt.tables(st, N)
    assert np.asarray(tj["c0"]).tobytes() == tt["c0"].numpy().tobytes()
    assert _ulps(tj["sizes"], tt["sizes"]).max() <= 32
    cj, ct = np.asarray(tj["cum"]), tt["cum"].numpy()
    fin = np.isfinite(cj)
    assert (np.isfinite(ct) == fin).all()
    assert np.all(np.abs(cj[fin] - ct[fin]) <= 1e-5 * np.maximum(np.abs(cj[fin]), 1.0))
    assert _close_t(tj["tnext"], tt["tnext"].numpy())

    # consume a different number of draws per stream, then commit the carry
    used = np.asarray([[3, 0], [N, 17]], np.int32)[: sj.arr_count.shape[0]]
    sj2 = sj.replace(arr_count=sj.arr_count + jnp.asarray(used))
    st.arr_count += torch.from_numpy(used)
    aj = np.asarray(wj.advance_carries(sj2, tj).arr_cum)
    pre_j = {k: torch.from_numpy(np.array(v)) for k, v in tj.items()}
    wt.advance_carries(st, pre_j)  # the JAX tables through the port: exact
    assert aj.tobytes() == st.arr_cum.numpy().tobytes()


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_port_tables_chunk_invariant(cfg):
    """One table of 2n equals two tables of n, bit for bit, when the carries
    advance between them as the engine advances them."""
    fleet = build_duo_fleet()
    params = SimParams(queue_cap=64, job_cap=32, seed=11, **CONFIGS[cfg])
    wt = compile_workload(fleet, params, "cpu")
    st = init_state(11, fleet, params, workload=wt, device="cpu")
    whole = wt.tables(st, 2 * N)
    first = wt.tables(st, N)
    S = wt.n_streams
    st.arr_count += N
    # in-step clock advance: the stream clock becomes its last table entry
    st.next_arrival.copy_(first["tnext"][:, N - 1].reshape(st.next_arrival.shape))
    wt.advance_carries(st, first)
    second = wt.tables(st, N)
    for k in ("sizes", "tnext", "cum"):
        joined = torch.cat([first[k], second[k]], dim=1)
        assert joined.numpy().tobytes() == whole[k].numpy().tobytes(), k
    assert S == 2 * fleet.n_ing


def test_wrapper_cpu_path_and_checks():
    fleet = build_duo_fleet()
    params = SimParams(queue_cap=64, job_cap=32, seed=2)
    wt = compile_workload(fleet, params, "cpu")
    st = init_state(2, fleet, params, workload=wt, device="cpu")
    S = wt.n_streams
    args = (st.arr_key, st.arr_count.reshape(S), st.next_arrival.reshape(S),
            st.arr_cum.reshape(S), st.arr_epoch.reshape(S), wt.family_t,
            wt.sparams)
    before = b2.arrival_tables.launches
    out = b2.arrival_tables(*args, 64, with_aux=True)
    ref = b2.arrival_tables_reference(*args, 64, with_aux=True)
    assert b2.arrival_tables.launches == before  # the CPU path launches nothing
    for k in ref:
        assert out[k].numpy().tobytes() == ref[k].numpy().tobytes(), k
    # aux outputs: each entry's k_gap words and its uniform draw
    from distributed_cluster_gpus_tpu_torch.ops import arrivals, prng

    _, k_gap = arrivals.stream_draw_keys(st.arr_key, 0, st.arr_count.reshape(S)[0] + 5)
    assert ref["aux_key"][0, 5].tolist() == k_gap.to(torch.int32).tolist()
    assert ref["aux_u"][0, 5].item() == prng.uniform(k_gap).item()
    with pytest.raises(TypeError):
        b2.arrival_tables(args[0].to(torch.int32), *args[1:], 64)
    with pytest.raises(ValueError):
        b2.arrival_tables(*args[:6], args[6][:, :3].contiguous(), 64)


def test_unported_kinds_raise():
    """Every stream kind is ported: a trace without times is refused with
    the reference's message, and a sinusoid with |amp| > 1 compiles to the
    thinning replay (tests/test_torch_workload_tables.py holds both)."""
    from distributed_cluster_gpus_tpu_torch.workload.spec import StreamSpec

    with pytest.raises(ValueError, match="trace stream needs a `times` array"):
        StreamSpec(kind="trace")
    params = dataclasses.replace(SimParams(), inf_amp=1.5)
    wt = compile_workload(build_duo_fleet(), params, "cpu")
    assert wt.families[0] == "thinning" and wt.families[1] == "poisson"
