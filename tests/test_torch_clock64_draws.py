"""The float64 clock's draws and arrival tables against jax under x64 (CPU).

Under the float64 clock the JAX package runs in jax's x64 mode, where every
unpinned draw is float64: ``random_bits`` draws 64 bits, ``(o0 << 32) | o1``
of the same threefry block whose 32-bit draw is ``o0 ^ o1``, and the
uniform takes their top 52 bits.  Held here:

* the 64 random bits, the float64 uniform (scalar and vector draws) and
  the replay sample's uniform vector: bitwise, for 4,096 keys;
* the float64 samplers, to the ulps measured against XLA's CPU code (the
  port's are torch's float64 ``log1p``, ``pow`` and ``exp`` and XLA's
  double ``erf_inv`` polynomial without fused multiply-adds,
  ``ops/prng.erfinv_f64``; ROADMAP queue C's standing difference):

      exponential (log1p)             EXP64_ULP    float64 ulps
      normal (erf_inv polynomial)     NORMAL64_ULP
      erf_inv on (-1, 1)              ERFINV64_ULP
      job sizes                       SIZE64_ULP (float64, before the
                                      cast), 0 float32 ulps once stored

* ``init_clocks`` and the port's own ``tables`` (B2's plain version) on the
  configurations of ``tests/test_torch_workload.py``, from ``init_state``
  and from a state bridged to t = 6.0e5 s: the float32 sizes bitwise, the
  cumulative folds and next arrivals within ``CLOCK64_ULP`` float64 ulps
  (sums of draws that differ by ``EXP64_ULP`` at most), the counts and
  cursors exactly; and the lane-stacked tables equal each lane's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet as jduo
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.ops import arrivals as jarr
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu.workload.compiler import compile_workload as jcompile
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams, stack_states
from distributed_cluster_gpus_tpu_torch.ops import arrivals as tarr
from distributed_cluster_gpus_tpu_torch.ops import prng
from distributed_cluster_gpus_tpu_torch.sim.engine import init_state
from distributed_cluster_gpus_tpu_torch.workload.compiler import compile_workload
from test_torch_algos import bridge_to
from test_torch_workload import CONFIGS, _leaf, _ulps

#: measured maxima over this file's draws (XLA CPU vs torch, float64)
EXP64_ULP = 128
NORMAL64_ULP = 32
ERFINV64_ULP = 24
SIZE64_ULP = 16
CLOCK64_ULP = 32
N_KEYS = 4096
N = 256


def _ulps64(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert (np.isinf(a) == np.isinf(b)).all()
    fin = np.isfinite(a)
    return np.abs(a[fin].view(np.int64) - b[fin].view(np.int64)).max(initial=0)


@pytest.fixture(scope="module")
def keys():
    with jax.enable_x64(True):
        kd = jax.vmap(lambda i: jax.random.key_data(
            jax.random.fold_in(jax.random.key(7), i)))(jnp.arange(N_KEYS))
    kd = np.asarray(kd)
    return kd, torch.from_numpy(kd.astype(np.int64))


def test_bits_and_uniform_bitwise(keys):
    kd, kt = keys
    with jax.enable_x64(True):
        ks = jax.vmap(jax.random.wrap_key_data)(kd)
        bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint64))(ks))
        u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k))(ks))
        u5 = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (5,)))(ks))
    hi, lo = prng.random_bits64(kt)
    got = (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(np.uint64)
    assert np.array_equal(bits, got)
    assert u.dtype == np.float64
    assert np.array_equal(u.view(np.int64), prng.uniform64(kt).numpy().view(np.int64))
    assert np.array_equal(u5.view(np.int64),
                          prng.uniform_vec64(kt, 5).numpy().view(np.int64))
    # the 32-bit draw is the same block's o0 ^ o1
    assert np.array_equal(prng.random_bits(kt).numpy(), (hi ^ lo).numpy())


def test_samplers_within_ulps(keys):
    kd, kt = keys
    with jax.enable_x64(True):
        ks = jax.vmap(jax.random.wrap_key_data)(kd)
        e = jax.vmap(lambda k: jax.random.exponential(k))(ks)
        z = jax.vmap(lambda k: jax.random.normal(k))(ks)
        sizes = [np.asarray(jax.jit(jax.vmap(
            lambda k, jt=jt: jarr.sample_job_size(k, jt)))(ks)) for jt in (0, 1)]
        rng = np.random.default_rng(0)
        v = np.concatenate([rng.random(100_000) * 2 - 1,
                            1 - rng.random(20_000) * 1e-12,
                            -1 + rng.random(20_000) * 1e-6, [0.0, 1.0, -1.0]])
        inv = np.asarray(jax.jit(jax.scipy.special.erfinv)(v))
    assert _ulps64(e, prng.exponential64(kt).numpy()) <= EXP64_ULP
    assert _ulps64(z, prng.normal64(kt).numpy()) <= NORMAL64_ULP
    assert _ulps64(inv, prng.erfinv_f64(torch.from_numpy(v)).numpy()) <= ERFINV64_ULP
    for jt in (0, 1):
        got = tarr.sample_job_size(kt, jt, torch.float64).numpy()
        assert sizes[jt].dtype == got.dtype == np.float64
        assert _ulps64(sizes[jt], got) <= SIZE64_ULP
        assert _ulps(sizes[jt].astype(np.float32), got.astype(np.float32)).max() == 0


def _states(cfg, t0):
    kw = dict(time_dtype="float64", duration=7e5, **cfg)
    with jax.enable_x64(True):
        fj = jduo()
        pj = JParams(**kw)
        wj = jcompile(fj, pj)
        sj = jinit(jax.random.key(3), fj, pj, workload=wj)
        if t0 is not None:
            sj = bridge_to(sj, t0, pj.log_interval)
        tj = jax.device_get(jax.jit(lambda s: wj.tables(s, N))(sj))
    ft = bridge.fleet_from_numpy(fj)
    pt = SimParams(**kw)
    st = bridge.state_from_numpy(bridge.tree_to_numpy(sj, _leaf), "cpu")
    return sj, tj, ft, pt, st


@pytest.mark.parametrize("t0", [None, 6.0e5])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_own_tables_within_ulps(name, t0):
    sj, tj, ft, pt, st = _states(CONFIGS[name], t0)
    tt = compile_workload(ft, pt, "cpu").tables(st, N)
    assert tt["sizes"].dtype == torch.float32
    assert tt["cum"].dtype == tt["tnext"].dtype == torch.float64
    assert _ulps(tj["sizes"], tt["sizes"].numpy()).max() == 0
    for k in ("cum", "tnext"):
        assert np.asarray(tj[k]).dtype == np.float64
        assert _ulps64(tj[k], tt[k].numpy()) <= CLOCK64_ULP, k
    assert np.array_equal(np.asarray(tj["c0"]), tt["c0"].numpy())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_clocks_within_ulps(name):
    sj, _, ft, pt, _ = _states(CONFIGS[name], None)
    st = init_state(3, ft, pt, device="cpu")
    for k in ("next_arrival", "arr_epoch", "arr_cum"):
        a, b = np.asarray(getattr(sj, k)), getattr(st, k).numpy()
        assert a.dtype == b.dtype == np.float64, k
        assert _ulps64(a, b) <= 2, k
    assert np.array_equal(np.asarray(sj.arr_count), st.arr_count.numpy())


def test_lane_tables_equal_each_lanes_own():
    _, _, ft, pt, st = _states(CONFIGS["sin_inv+poisson"], 6.0e5)
    wl = compile_workload(ft, pt, "cpu")
    lanes = [init_state(s, ft, pt, workload=wl, device="cpu") for s in (1, 2)]
    lanes.append(st)
    stacked = stack_states(lanes)
    tl = wl.tables(stacked, N)
    for r, s in enumerate(lanes):
        own = wl.tables(s, N)
        for k in ("sizes", "cum", "tnext", "c0"):
            assert torch.equal(tl[k][r], own[k]), (r, k)
    # the plain version keeps the clocks' dtype in its debug outputs too
    shape = (ft.n_ing * 2,)
    out = b2.arrival_tables_reference(
        st.arr_key, st.arr_count.reshape(shape), st.next_arrival.reshape(shape),
        st.arr_cum.reshape(shape), st.arr_epoch.reshape(shape), wl.family_t,
        wl.sparams, 8, with_aux=True)
    assert out["aux_u"].dtype == torch.float64
