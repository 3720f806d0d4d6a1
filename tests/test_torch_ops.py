"""The PyTorch port's pure ops held against the JAX package (CPU).

Physics, optimizer tables, fleet configs and the threefry key / bit
streams, ``uniform`` and ``randint`` must be BIT-equal.  The samplers that
go through a transcendental function carry a stated tolerance, measured
over 25,600 draws (400 seeds x 64 keys) and given here with headroom:

=========================  =========================  =================
sampler                    measured worst             bound asserted
=========================  =========================  =================
exponential (log1p)        1 ulp                      1 ulp
normal (XLA erf_inv poly)  3 ulp                      4 ulp
Pareto size (pow)          1 ulp                      2 ulp
LogNormal size (exp)       16 ulp (1.1e-6 relative)   32 ulp
sinusoid_gap_from_cum      2.4e-5 relative at the     |d| <= 1e-4 *
                           defaults, 5e-5 at amp 1    max(d, 1 s)
=========================  =========================  =================

log1p, pow, exp and cos differ by an ulp between XLA's CPU code and
torch's; the bisection of the sinusoid inversion turns such an ulp in the
integrated rate into a shift of the root proportional to 1/lambda.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import paper as jpaper
from distributed_cluster_gpus_tpu.ops import arrivals as jarr
from distributed_cluster_gpus_tpu.ops import physics as jphys
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.configs import paper as tpaper
from distributed_cluster_gpus_tpu_torch.ops import arrivals as tarr
from distributed_cluster_gpus_tpu_torch.ops import physics as tphys
from distributed_cluster_gpus_tpu_torch.ops import prng


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.fixture(scope="module")
def keys():
    """400 seeds x 64 split keys, as jax keys and as port key words."""
    seeds = np.random.default_rng(0).integers(0, 2**31 - 1, 400)
    kj = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.int32))
    kj = jax.vmap(lambda k: jax.random.split(k, 64))(kj).reshape(-1)
    kt = torch.stack([prng.key(int(s), "cpu") for s in seeds])
    kt = prng.split(kt, 64).reshape(-1, 2)
    return kj, kt


@pytest.mark.parametrize("builder", ["build_fleet", "build_single_dc_fleet",
                                     "build_duo_fleet"])
def test_fleet_tables_bit_equal(builder):
    fj = getattr(jpaper, builder)()
    ft = getattr(tpaper, builder)()
    assert ft.dc_names == fj.dc_names and ft.ingress_names == fj.ingress_names
    assert ft.default_f_idx == fj.default_f_idx
    for name in ("total_gpus", "p_idle", "p_peak", "p_sleep", "gpu_alpha",
                 "power_gating", "freq_levels", "carbon", "price_hourly",
                 "net_lat_s", "transfer_s", "T_grid", "P_grid", "E_grid"):
        a, b = np.asarray(getattr(fj, name)), np.asarray(getattr(ft, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for grp in ("power", "latency"):
        for a, b in zip(getattr(fj, grp), getattr(ft, grp)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), grp
    # the bridge rebuilds the same fleet from the JAX one
    fb = bridge.fleet_from_numpy(fj)
    assert fb.E_grid.tobytes() == ft.E_grid.tobytes()


def test_physics_bit_equal():
    rng = np.random.default_rng(1)
    n = rng.integers(0, 9, 4096).astype(np.int32)
    f = rng.choice(np.asarray(tpaper.FREQ_LEVELS, np.float32), 4096)
    co = rng.uniform(0.0005, 120.0, (6, 4096)).astype(np.float32)
    pj = jphys.PowerCoeffs(*co[:3])
    lj = jphys.LatencyCoeffs(*co[3:])
    pt = tphys.PowerCoeffs(*(torch.from_numpy(c) for c in co[:3]))
    lt = tphys.LatencyCoeffs(*(torch.from_numpy(c) for c in co[3:]))
    nt, ftt = torch.from_numpy(n), torch.from_numpy(f)
    for fj_, ft_ in ((jphys.gpu_power_w(f, pj), tphys.gpu_power_w(ftt, pt)),
                     (jphys.task_power_w(n, f, pj), tphys.task_power_w(nt, ftt, pt)),
                     (jphys.step_time_s(n, f, lj), tphys.step_time_s(nt, ftt, lt))):
        assert np.asarray(fj_).tobytes() == ft_.numpy().tobytes()
    # the fence keeps the reference's signed zeros: (-x) * 0 -> -0 + -0
    a = np.asarray([-3.0, 3.0, 0.0], np.float32)
    b = np.asarray([0.0, -0.0, -2.0], np.float32)
    pin = jax.jit(jphys.fmul_pinned)
    assert (np.asarray(pin(a, b)).tobytes()
            == tphys.fmul_pinned(torch.from_numpy(a), torch.from_numpy(b)).numpy().tobytes())


def test_threefry_keys_bits_randint_bit_equal(keys):
    kj, kt = keys
    assert (np.asarray(jax.random.key_data(kj)).astype(np.int64) == kt.numpy()).all()
    counts = np.random.default_rng(2).integers(0, 2**31, kt.shape[0])
    fj = jax.vmap(jax.random.fold_in)(kj, jnp.asarray(counts, jnp.uint32))
    ft = prng.fold_in(kt, torch.from_numpy(counts))
    assert (np.asarray(jax.random.key_data(fj)).astype(np.int64) == ft.numpy()).all()
    bj = jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(kj)
    assert (np.asarray(bj).astype(np.int64) == prng.random_bits(kt).numpy()).all()
    for n in (1, 2, 3, 8, 13):
        rj = jax.vmap(lambda k: jax.random.randint(
            k, (), jnp.int32(0), jnp.int32(n), dtype=jnp.int32))(kj)
        assert (np.asarray(rj) == prng.randint(kt, n).numpy()).all(), n
    # the host scalar forms the event loop uses
    for i in range(0, kt.shape[0], 997):
        k = tuple(kt[i].tolist())
        assert prng.split_int(k, 3) == [tuple(r) for r in prng.split(kt[i], 3).tolist()]
        assert prng.randint_int(k, 8) == int(prng.randint(kt[i], 8))


def test_uniform_bit_equal(keys):
    kj, kt = keys
    uj = jax.jit(jax.vmap(jax.random.uniform))(kj)
    assert np.asarray(uj).tobytes() == prng.uniform(kt).numpy().tobytes()


def test_exponential_normal_within_ulps(keys):
    kj, kt = keys
    ej = jax.jit(jax.vmap(jax.random.exponential))(kj)
    assert _ulps(ej, prng.exponential(kt)).max() <= 1
    nj = jax.jit(jax.vmap(jax.random.normal))(kj)
    assert _ulps(nj, prng.normal(kt)).max() <= 4


@pytest.mark.parametrize("jt,bound", [(0, 2), (1, 32)])
def test_sample_job_size_within_ulps(keys, jt, bound):
    kj, kt = keys
    sj = jax.jit(jax.vmap(lambda k: jarr.sample_job_size(k, jt)))(kj)
    assert _ulps(sj, tarr.sample_job_size(kt, jt)).max() <= bound


@pytest.mark.parametrize("rate,amp,period", [(6.0, 0.6, 300.0), (2.0, 1.0, 60.0),
                                             (0.5, -0.3, 1000.0), (10.0, 0.9, 3600.0)])
def test_sinusoid_gap_from_cum_within_tolerance(rate, amp, period):
    rng = np.random.default_rng(3)
    jp = jarr.ArrivalParams(mode=jnp.int32(2), rate=jnp.float32(rate),
                            amp=jnp.float32(amp), period=jnp.float32(period))
    gap = jax.jit(lambda a, x: jarr.sinusoid_gap_from_cum(jp, a, x))
    for _ in range(3):
        s = np.cumsum(rng.exponential(size=2048)).astype(np.float32)
        anchor = np.float32(rng.uniform(0, 50))
        dj = np.asarray(gap(anchor, s))
        dt = tarr.sinusoid_gap_from_cum(
            tarr.ArrivalParams(2, rate, amp, period), torch.tensor(anchor),
            torch.from_numpy(s)).numpy()
        assert np.all(np.abs(dj - dt) <= 1e-4 * np.maximum(dj, 1.0))


def test_lambda_t_and_tmod():
    t = np.linspace(0.0, 1000.0, 257, dtype=np.float32)
    for mode, rate, amp, period in ((2, 6.0, 0.6, 300.0), (1, 0.3, 0.0, 3600.0),
                                    (0, 1.0, 0.0, 10.0)):
        jp = jarr.ArrivalParams(mode=jnp.int32(mode), rate=jnp.float32(rate),
                                amp=jnp.float32(amp), period=jnp.float32(period))
        lj = np.asarray(jarr.lambda_t(jp, t))
        lt = tarr.lambda_t(tarr.ArrivalParams(mode, rate, amp, period),
                           torch.from_numpy(t)).numpy()
        assert _ulps(lj, lt).max() <= 2
    x = torch.tensor([-7.5, 7.5, -3.0, 0.0])
    assert tarr.tmod(x, 2.0).tolist() == [math.fmod(-7.5, 2.0) + 2.0, 1.5, 1.0, 0.0]
