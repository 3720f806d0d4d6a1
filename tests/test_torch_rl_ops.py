"""The chsac_af acting path's pure pieces against the JAX package (CPU).

Inputs are made with numpy from a seed and handed to both packages:

* B3's plain version, ``windowed_percentile``, bitwise over the ring's
  ``count`` edge cases (empty, one sample, below and at the 5-sample SLO
  gate, one short of full, full, wrapped);
* the observation and the action masks bitwise.  ``log1p`` enters the
  observation; torch's and XLA's may differ by an ulp, so the observation
  is held to 1 ulp and the test records how many entries needed it;
* ``min_n_for_sla`` bitwise;
* the categorical sampler: on identical float32 log-probabilities the
  action equals ``jax.random.categorical``'s, except where the two largest
  Gumbel-perturbed values lie within 4 ulp of each other (``torch.log``
  against XLA's), which the test counts and bounds;
* B6a's plain version, ``_add_window``, bitwise against the JAX
  ``_add_window`` (wrap, all valid, none valid, overwritten valid rows,
  ``n_lost``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet, build_single_dc_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.ops.optimizers import min_n_for_sla as j_min_n
from distributed_cluster_gpus_tpu.ops.physics import LatencyCoeffs as JLat
from distributed_cluster_gpus_tpu.rl import replay as jreplay
from distributed_cluster_gpus_tpu.sim import algos as jalgos
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.ops import prng
from distributed_cluster_gpus_tpu_torch.ops.optimizers import min_n_for_sla
from distributed_cluster_gpus_tpu_torch.ops.physics import LatencyCoeffs
from distributed_cluster_gpus_tpu_torch.rl import replay as treplay
from distributed_cluster_gpus_tpu_torch.sim import algos
from distributed_cluster_gpus_tpu_torch.sim.step import StepProgram

FLEETS = {"duo": build_duo_fleet, "single": build_single_dc_fleet}


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------- B3


@pytest.mark.parametrize("W", [64, 2048])
@pytest.mark.parametrize("count_case", ["0", "1", "4", "5", "W-1", "W", ">W"])
def test_windowed_percentile_bitwise(W, count_case):
    rng = np.random.default_rng(W + len(count_case))
    count = {"0": 0, "1": 1, "4": 4, "5": 5, "W-1": W - 1, "W": W,
             ">W": 3 * W + 7}[count_case]
    # latencies with ties (rounded to ms) and a heavy tail
    buf = np.round(rng.exponential(0.2, size=(2, W)), 3).astype(np.float32)
    buf[1] = rng.lognormal(-1.0, 1.0, size=W).astype(np.float32)
    cnt = np.array([count, max(count - 1, 0)], np.int32)
    j = jax.jit(jax.vmap(lambda b, c: jalgos.windowed_percentile(b, c, 99.0)))(
        buf, cnt)
    t = algos.windowed_percentile(torch.from_numpy(buf), torch.from_numpy(cnt),
                                  99.0)
    j, t = np.asarray(j), t.numpy()
    nan = np.isnan(j)
    assert np.array_equal(nan, np.isnan(t))
    assert np.array_equal(_bits(j)[~nan], _bits(t)[~nan])


def test_percentile_k_matches_reference_rule():
    for W in (16, 64, 512, 2048, 4096):
        assert algos.percentile_k(W) == min(W, int(np.ceil(0.01 * W)) + 2)
    assert algos.percentile_k(2048) == 23


# ---------------------------------------------------------------- obs / masks


def _prog(fleet_name, **kw):
    fj = FLEETS[fleet_name]()
    kw = dict(algo="chsac_af", lat_window=64, **kw)
    return fj, JParams(**kw), StepProgram(bridge.fleet_from_numpy(fj),
                                          SimParams(**kw), "cpu")


@pytest.mark.parametrize("fleet_name", ["duo", "single"])
def test_obs_within_one_ulp(fleet_name):
    fj, pj, prog = _prog(fleet_name)
    rng = np.random.default_rng(7)
    n_dc = fj.n_dc
    total = np.asarray(fj.total_gpus)
    n_off = 0
    for trial in range(40):
        t = np.float32(rng.uniform(0, 2e5) if trial % 2 else rng.uniform(0, 50))
        busy = rng.integers(0, total + 1).astype(np.int32)
        cur_f = rng.integers(0, fj.n_f, size=n_dc).astype(np.int32)
        q_inf = rng.integers(0, 5000, size=n_dc).astype(np.int32)
        q_trn = rng.integers(0, 50, size=n_dc).astype(np.int32)
        o_j = np.asarray(jax.jit(lambda *a: jalgos.rl_obs(fj, *a))(
            t, busy, cur_f, q_inf, q_trn))
        o_t = algos.rl_obs(prog.fleet, torch.tensor(t), torch.from_numpy(busy),
                           torch.from_numpy(cur_f), torch.from_numpy(q_inf),
                           torch.from_numpy(q_trn), prog.obs_consts).numpy()
        assert o_t.dtype == np.float32 and o_t.shape == o_j.shape
        d = np.abs(_bits(o_j).astype(np.int64) - _bits(o_t).astype(np.int64))
        assert d.max() <= 1, (trial, o_j, o_t)
        n_off += int((d > 0).sum())
    # only the log1p features may move, and then rarely
    assert n_off <= 40 * n_dc * 3 // 4


@pytest.mark.parametrize("reserve", [0, 3])
@pytest.mark.parametrize("fleet_name", ["duo", "single"])
def test_masks_bitwise(fleet_name, reserve):
    fj, pj, prog = _prog(fleet_name, max_gpus_per_job=8, sla_p99_ms=400.0)
    rng = np.random.default_rng(11 + reserve)
    total = np.asarray(fj.total_gpus)
    fn = jax.jit(lambda b, lb, lc, pp, r: jalgos.rl_masks(
        pj, fj, b, lb, lc, pp, r))
    for trial in range(30):
        busy = np.minimum(total, rng.integers(0, total + 1) + (trial % 3) * 5
                          ).astype(np.int32)
        lat_count = rng.integers(0, 9, size=2).astype(np.int32)
        p99 = rng.uniform(0.2, 0.5, size=2).astype(np.float32)
        buf = np.zeros((2, 64), np.float32)
        m_j = fn(busy, buf, lat_count, p99, reserve)
        m_t = algos.rl_masks(prog.params, prog.fleet, torch.from_numpy(busy),
                             torch.from_numpy(lat_count), torch.from_numpy(p99),
                             prog.total_gpus, reserve)
        for a, b in zip(m_j, m_t):
            assert np.array_equal(np.asarray(a), b.numpy()), trial


def test_min_n_for_sla_bitwise():
    fj = build_duo_fleet()
    rng = np.random.default_rng(3)
    lat = [np.asarray(a) for a in fj.latency]
    for trial in range(60):
        d, jt = int(rng.integers(fj.n_dc)), int(rng.integers(2))
        size = np.float32(rng.exponential(30.0))
        f = np.float32(fj.freq_levels[int(rng.integers(fj.n_f))])
        sla = float(rng.choice([50.0, 500.0, 5000.0]))
        a = j_min_n(size, f, JLat(*(x[d, jt] for x in lat)), sla, 8)
        b = min_n_for_sla(torch.tensor(size), torch.tensor(f),
                          LatencyCoeffs(*(torch.tensor(x[d, jt]) for x in lat)),
                          sla, 8)
        assert int(a) == int(b) and b.dtype == torch.int32


# ---------------------------------------------------------------- categorical


def test_categorical_matches_jax_outside_stated_margin():
    rng = np.random.default_rng(5)
    n_close = 0
    n = 400
    for i in range(n):
        width = 8
        logits = rng.normal(0, 2, size=width).astype(np.float32)
        mask = rng.random(width) < 0.7
        mask[rng.integers(width)] = True
        logp = np.where(mask, logits, np.float32(-1e9)).astype(np.float32)
        kj = jax.random.key(i)
        a_j = int(jax.random.categorical(kj, jnp.asarray(logp)))
        kw = np.asarray(jax.random.key_data(kj)).astype(np.int64)
        a_t = int(prng.categorical(torch.from_numpy(kw), torch.from_numpy(logp)))
        # the JAX draw's perturbed values, to measure the margin
        g = np.asarray(jax.random.gumbel(kj, (width,))) + logp
        top2 = np.sort(g)[-2:]
        close = abs(int(_bits(top2[1])) - int(_bits(top2[0]))) <= 4
        n_close += close
        if not close:
            assert a_t == a_j, i
    assert n_close <= n // 20


def test_gumbel_uniforms_bitwise():
    for i in range(20):
        kj = jax.random.key(100 + i)
        kw = torch.from_numpy(np.asarray(jax.random.key_data(kj)).astype(np.int64))
        u_j = np.asarray(jax.random.uniform(kj, (8,), jnp.float32,
                                            minval=jnp.finfo(jnp.float32).tiny,
                                            maxval=1.0))
        u_t = prng.uniform_vec(kw, 8, prng.TINY_F32, 1.0).numpy()
        assert np.array_equal(_bits(u_j), _bits(u_t))


# ---------------------------------------------------------------- B6a


def _window(rng, N, obs_dim, n_dc, n_g, p_valid):
    return {
        "valid": rng.random(N) < p_valid,
        "s0": rng.normal(size=(N, obs_dim)).astype(np.float32),
        "s1": rng.normal(size=(N, obs_dim)).astype(np.float32),
        "a_dc": rng.integers(0, n_dc, N).astype(np.int32),
        "a_g": rng.integers(0, n_g, N).astype(np.int32),
        "r": rng.normal(size=N).astype(np.float32),
        "costs": rng.normal(size=(N, 4)).astype(np.float32),
        "mask_dc": rng.random((N, n_dc)) < 0.5,
        "mask_g": rng.random((N, n_g)) < 0.5,
        "mask_dc0": rng.random((N, n_dc)) < 0.5,
        "mask_g0": rng.random((N, n_g)) < 0.5,
    }


@pytest.mark.parametrize("case", ["wrap", "all_valid", "none_valid",
                                  "overwrite", "chunk_gt_capacity",
                                  "window_gt_8192"])
def test_add_window_bitwise(case):
    C, obs_dim, n_dc, n_g = 40, 13, 2, 8
    max_window = treplay.INGEST_WINDOW
    if case == "window_gt_8192":  # windows of 9,000 rows (the kernel's old
        # limit was 8,192), wrapping onto valid rows at the fifth
        C, max_window = 40_000, 10_000
    rng = np.random.default_rng(len(case))
    rb_j = jreplay.replay_init(C, obs_dim, n_dc, n_g, 4)
    rb_t = treplay.replay_init(C, obs_dim, n_dc, n_g, 4, device="cpu")
    p_valid = {"all_valid": 1.0, "none_valid": 0.0,
               "window_gt_8192": 0.9}.get(case, 0.6)
    sizes = {"wrap": [9, 9, 9, 9, 9, 9], "overwrite": [10] * 9,
             "chunk_gt_capacity": [57, 23],
             "window_gt_8192": [9000] * 5}.get(case, [10, 10, 10])
    add_j = jax.jit(lambda rb, tr: jreplay.replay_add_chunk(rb, tr, max_window))
    for N in sizes:
        tr = _window(rng, N, obs_dim, n_dc, n_g, p_valid)
        rb_j = add_j(rb_j, {k: jnp.asarray(v) for k, v in tr.items()})
        treplay.replay_add_chunk(rb_t, {k: torch.from_numpy(v)
                                        for k, v in tr.items()}, max_window)
        jt = bridge.tree_to_numpy(rb_j)
        pt = bridge.tree_to_numpy(rb_t, bridge.tensor_leaf)
        assert bridge.tree_mismatches(jt, pt) == [], N
    if case in ("overwrite", "window_gt_8192"):
        assert int(rb_t.size) < int(rb_t.n_seen)
    if case == "none_valid":
        assert int(rb_t.n_seen) == 0 and int(rb_t.ptr) == 0


def test_replay_windows_follow_reference_split():
    assert treplay.windows(200_000, 4096) == [(0, 4096)]
    assert treplay.windows(40, 57) == [(17, 27), (27, 37), (37, 47), (47, 57)]
    assert treplay.windows(10_000, 9000) == [(0, 2500), (2500, 5000),
                                             (5000, 7500), (7500, 9000)]
