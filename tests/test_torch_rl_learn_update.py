"""One whole CHSAC-AF update against the JAX package's ``sac_train_step``,
and the port's analogues of ``tests/test_rl.py``'s SAC/CMDP tests (CPU).

The whole update runs at the published widths (256-wide encoder, actor and
critics, N = 32 quantiles, 8 x 8 joint actions, obs_dim 49) at batch 32, a
cut of the CLI's 256 (``--rl-batch``) that keeps the CPU compile short,
from a JAX ``SACState`` with seeded perturbed networks carried across by
``bridge.sac_from_flax``, on the same ring (seeded, ``done`` in {0, 1},
masked actions) and the same key:

* the sampled indices are bitwise equal (B6b);
* every metric is within ``METRIC_RTOL`` relative (or ``METRIC_ATOL``): the
  networks round each layer to bf16 and their products sum in another
  order than XLA's;
* every leaf of the updated state: the parameters within ``2 * lr`` (Adam's
  first step moves each element by about ``lr``, so where a gradient
  element sits near 0 its sign can flip between the two; the median
  difference is 0), the target critic within ``2 * lr * tau`` plus an ulp,
  log alpha and the counts equal, the moments within their gradient's
  spread (``MOMENT_RTOL`` of each leaf's largest value), lambda within
  ``LAM_ULP`` ulp.

The same bounds hold for one update at the card's widened envelope (batch
37, 3 x 65 joint actions: heads of 68 columns together), both critics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.rl import cmdp as jcmdp
from distributed_cluster_gpus_tpu.rl import replay as jreplay
from distributed_cluster_gpus_tpu.rl import sac as jsac
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.ops import prng as tprng
from distributed_cluster_gpus_tpu_torch.rl import cmdp as tcmdp
from distributed_cluster_gpus_tpu_torch.rl import replay as treplay
from distributed_cluster_gpus_tpu_torch.rl import sac as tsac

from test_torch_rl_learn_ops import (LAM_ULP, N_DC, N_G, OBS, _key_t,
                                     _perturbed, _ulps, _window, carried_pair)

METRIC_RTOL, METRIC_ATOL = 2e-3, 1e-4
MOMENT_RTOL = 0.05
#: log alpha after an update: Adam's step on a scalar whose gradient (the
#: entropy's batch mean) agrees to float32 rounding
ALPHA_ATOL = 1e-6
LR, TAU = 3e-4, 0.005


def _ring(seed=7, C=500, N=400):
    rng = np.random.default_rng(seed)
    w = _window(rng, N, 0.7)
    w["mask_dc"][:, 0] = True
    w["mask_g0"][:, 3] = True
    w["mask_dc0"][:4] = False  # every DC masked at s0: a uniform head
    rbj = jreplay.replay_add_chunk(jreplay.replay_init(C, OBS, N_DC, N_G, 4),
                                   {k: jnp.asarray(v) for k, v in w.items()})
    tree = bridge.tree_to_numpy(jax.device_get(rbj))
    return rbj, treplay.ReplayState(**{k: torch.tensor(np.array(v))
                                       for k, v in tree.items()})


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    else:
        yield path, np.asarray(tree)


@pytest.fixture(scope="module", params=["onehot", "heads"])
def updated(request):
    cj, ct, sj, st = carried_pair(request.param, seed=3)
    rbj, rbt = _ring()
    key = jax.random.key(42)
    sj2, mj = jax.jit(lambda s, r, k: jsac.sac_train_step(cj, s, r, k))(sj, rbj, key)
    mt = tsac.sac_train_step(ct, st, rbt, _key_t(key))
    return cj, ct, rbj, rbt, key, sj2, mj, st, mt


def test_update_samples_the_same_rows(updated):
    cj, ct, rbj, rbt, key, *_ = updated
    k = jax.random.split(key)[0]
    cdf = jnp.cumsum(rbj.valid.astype(jnp.float32))
    u = jax.random.uniform(k, (cj.batch,)) * jnp.maximum(cdf[-1], 1.0)
    want = np.asarray(jnp.clip(jnp.searchsorted(cdf, u, side="right"), 0,
                               rbj.valid.shape[0] - 1))
    got = treplay.replay_sample(rbt, _key_t(k), ct.batch)["idx"].numpy()
    assert np.array_equal(want, got)


def test_update_metrics_within_tolerance(updated):
    *_, mj, st, mt = updated
    assert set(mj) == set(mt)
    for k in mj:
        a, b = np.asarray(mj[k]), mt[k].numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), k
        assert np.all(np.abs(a - b) <= METRIC_RTOL * np.abs(a) + METRIC_ATOL), k


def test_update_state_leaves_within_bounds(updated):
    cj, ct, rbj, rbt, key, sj2, mj, st, mt = updated
    a = dict(_leaves(bridge.flax_sac_to_numpy(jax.tree.map(np.asarray, sj2))))
    b = dict(_leaves(bridge.sac_to_numpy(ct, st)))
    assert set(a) == set(b)
    for path, x in a.items():
        y = b[path]
        assert x.dtype == y.dtype and x.shape == y.shape, path
        d = np.abs(x.astype(np.float64) - y.astype(np.float64))
        group = path.split(".")[0]
        if group in ("enc_params", "actor_params", "critic_params"):
            assert d.max() <= 2 * LR and np.median(d) <= LR / 100, path
        elif group == "target_critic_params":
            assert np.all(d <= 2 * LR * TAU + np.spacing(np.abs(x))), path
        elif path.endswith(".count") or path in ("step", "log_alpha"):
            assert np.array_equal(x, y), path
        elif group == "cmdp":
            assert _ulps(x, y).max() <= LAM_ULP, path
        else:  # Adam's moments
            assert d.max() <= MOMENT_RTOL * max(np.abs(x).max(), 1e-30), path


# --------------------------- one update beyond the published widths

#: the card's widened envelope at an odd batch with heads wider than 64
#: together (3 + 65 entries, 195 joint actions), cut to a CPU size
WIDE_B, WIDE_DC, WIDE_G = 37, 3, 65


def _wide_ring(seed=8, C=300, N=260):
    rng = np.random.default_rng(seed)
    w = {"valid": rng.random(N) < 0.7,
         "s0": rng.normal(size=(N, OBS)).astype(np.float32),
         "s1": rng.normal(size=(N, OBS)).astype(np.float32),
         "a_dc": rng.integers(0, WIDE_DC, N).astype(np.int32),
         "a_g": rng.integers(0, WIDE_G, N).astype(np.int32),
         "r": rng.normal(size=N).astype(np.float32),
         "costs": (rng.random((N, 4)) * 800).astype(np.float32),
         "done": (rng.random(N) < 0.5).astype(np.float32)}
    for name, n in (("mask_dc", WIDE_DC), ("mask_g", WIDE_G),
                    ("mask_dc0", WIDE_DC), ("mask_g0", WIDE_G)):
        w[name] = rng.random((N, n)) < 0.7
        w[name][:, 0] = True
    w["mask_dc0"][:3] = False  # every DC masked at s0: a uniform head
    rbj = jreplay.replay_add_chunk(
        jreplay.replay_init(C, OBS, WIDE_DC, WIDE_G, 4),
        {k: jnp.asarray(v) for k, v in w.items()})
    tree = bridge.tree_to_numpy(jax.device_get(rbj))
    return rbj, treplay.ReplayState(**{k: torch.tensor(np.array(v))
                                       for k, v in tree.items()})


@pytest.fixture(scope="module", params=["onehot", "heads"])
def wide_updated(request):
    """One update of both packages at batch 37 with 3 x 65 joint actions,
    from a JAX ``SACState`` with seeded perturbed networks carried across."""
    arch = request.param
    kw = dict(obs_dim=OBS, n_dc=WIDE_DC, n_g=WIDE_G, batch=WIDE_B,
              critic_arch=arch)
    cj = jsac.SACConfig(**kw, constraints=jcmdp.default_constraints(500.0))
    ct = tsac.SACConfig(**kw, constraints=tcmdp.default_constraints(500.0))
    sj = jsac.sac_init(cj, jax.random.key(6))
    rng = np.random.default_rng(11)
    crit = _perturbed(sj.critic_params, rng)
    sj = jax.tree.map(jnp.asarray, sj.replace(
        enc_params=_perturbed(sj.enc_params, rng),
        actor_params=_perturbed(sj.actor_params, rng), critic_params=crit,
        target_critic_params=_perturbed(crit, rng)))
    st = bridge.sac_from_flax(ct, jax.tree.map(np.asarray, sj), device="cpu")
    rbj, rbt = _wide_ring()
    key = jax.random.key(43)
    sj2, mj = jax.jit(lambda s, r, k: jsac.sac_train_step(cj, s, r, k))(sj, rbj, key)
    mt = tsac.sac_train_step(ct, st, rbt, _key_t(key))
    return ct, sj2, mj, st, mt


def test_update_beyond_the_published_widths_within_tolerance(wide_updated):
    """The plain path at the widened envelope (an odd batch, heads of 68
    columns together, 195 joint actions; the card's kernels take it, the
    published shapes' kernels did not) against the JAX package's update:
    the metrics and every leaf within the published-width bounds above."""
    ct, sj2, mj, st, mt = wide_updated
    for k in mj:
        a, b = np.asarray(mj[k]), mt[k].numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), k
        assert np.all(np.abs(a - b) <= METRIC_RTOL * np.abs(a) + METRIC_ATOL), k
    a = dict(_leaves(bridge.flax_sac_to_numpy(jax.tree.map(np.asarray, sj2))))
    b = dict(_leaves(bridge.sac_to_numpy(ct, st)))
    assert set(a) == set(b)
    for path, x in a.items():
        y = b[path]
        assert x.dtype == y.dtype and x.shape == y.shape, path
        d = np.abs(x.astype(np.float64) - y.astype(np.float64))
        group = path.split(".")[0]
        if group in ("enc_params", "actor_params", "critic_params"):
            assert d.max() <= 2 * LR and np.median(d) <= LR / 100, path
        elif group == "target_critic_params":
            assert np.all(d <= 2 * LR * TAU + np.spacing(np.abs(x))), path
        elif path.endswith(".count") or path in ("step", "log_alpha"):
            assert np.array_equal(x, y), path
        elif group == "cmdp":
            assert _ulps(x, y).max() <= LAM_ULP, path
        else:  # Adam's moments
            assert d.max() <= MOMENT_RTOL * max(np.abs(x).max(), 1e-30), path


# ------------------------------------------ a chunk of updates: train_steps

#: updates asked for in one chunk, of at most CHUNK_MAX
CHUNK_N, CHUNK_MAX = 5, 8


@pytest.fixture(scope="module")
def chunk_updated():
    """Both agents' ``train_steps(CHUNK_N, CHUNK_MAX)`` from one carried
    learner (seeded perturbed networks, the one-hot critic; the single
    update above covers both critics) on one ring: the JAX package's one
    jitted scan of the chunk's updates against the port's eager loop, whose
    keys and update index live on the (CPU) device and whose CMDP state and
    metrics are written in place."""
    from distributed_cluster_gpus_tpu.rl.agent import CHSAC_AF as JAgent
    from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF as TAgent

    arch = "onehot"
    kw = dict(obs_dim=OBS, n_dc=N_DC, n_g_choices=N_G, batch=32, warmup=10,
              seed=9, critic_arch=arch, buffer_capacity=500)
    aj, at = JAgent(**kw), TAgent(**kw, device="cpu")
    _, _, sj, _ = carried_pair(arch, seed=4)
    aj.sac = sj
    at.sac = bridge.sac_from_flax(at.cfg, jax.tree.map(np.asarray, sj), "cpu")
    aj.replay, at.replay = _ring()
    lam_before = at.sac.cmdp.lam
    mj, nj = aj.train_steps(CHUNK_N, CHUNK_MAX)
    mt, nt = at.train_steps(CHUNK_N, CHUNK_MAX)
    return aj, at, mj, nj, mt, nt, lam_before


def test_train_steps_chunk_runs_the_reference_schedule(chunk_updated):
    aj, at, mj, nj, mt, nt, lam_before = chunk_updated
    assert nj == nt == CHUNK_N and at.sac.step == CHUNK_N
    assert np.array_equal(at.key.numpy(), np.asarray(
        jax.random.key_data(aj.key)).astype(np.int64))
    # in place: the CMDP state keeps its tensors, the metrics are copies
    assert at.sac.cmdp.lam is lam_before
    assert mt["lambda"].data_ptr() != at.sac.metrics["lambda"].data_ptr()
    assert int(at._uidx) == CHUNK_N


def test_train_steps_chunk_within_tolerance(chunk_updated):
    """After CHUNK_N updates: the metrics within the one update's bounds,
    every parameter within ``CHUNK_N * 2 * lr`` (a sign flip per update at
    most; after the first step Adam's moments carry the gradients' float32
    differences, so the median is held to ``CHUNK_N * lr / 100``), the
    target within ``tau * 2 * lr`` times 1 + 2 + ... + CHUNK_N (update j
    blends in parameters up to ``j * 2 * lr`` apart) plus an ulp per update
    (each Polyak step rounds), log alpha within
    ``CHUNK_N * ALPHA_ATOL``, the counts equal, the moments within
    ``CHUNK_N`` times one update's spread, lambda and the PID state within
    ``LAM_ULP`` ulp (the samples, hence the costs, are bitwise equal)."""
    aj, at, mj, nj, mt, nt, _ = chunk_updated
    for k in mj:
        a, b = np.asarray(mj[k]), mt[k].numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), k
        assert np.all(np.abs(a - b) <= METRIC_RTOL * np.abs(a) + METRIC_ATOL), k
    a = dict(_leaves(bridge.flax_sac_to_numpy(jax.tree.map(np.asarray, aj.sac))))
    b = dict(_leaves(bridge.sac_to_numpy(at.cfg, at.sac)))
    assert set(a) == set(b)
    for path, x in a.items():
        y = b[path]
        assert x.dtype == y.dtype and x.shape == y.shape, path
        d = np.abs(x.astype(np.float64) - y.astype(np.float64))
        group = path.split(".")[0]
        if group in ("enc_params", "actor_params", "critic_params"):
            assert d.max() <= CHUNK_N * 2 * LR, path
            assert np.median(d) <= CHUNK_N * LR / 100, path
        elif group == "target_critic_params":
            tri = CHUNK_N * (CHUNK_N + 1) // 2
            assert np.all(d <= tri * 2 * LR * TAU
                          + CHUNK_N * np.spacing(np.abs(x))), path
        elif path.endswith(".count") or path == "step":
            assert np.array_equal(x, y), path
        elif path == "log_alpha":
            assert d.max() <= CHUNK_N * ALPHA_ATOL, path
        elif group == "cmdp":
            assert _ulps(x, y).max() <= LAM_ULP, path
        else:  # Adam's moments: each update's gradient adds its spread
            assert d.max() <= CHUNK_N * MOMENT_RTOL * max(np.abs(x).max(),
                                                          1e-30), path


# ------------------------------------------ port analogues of test_rl.py


def small_cfg(**kw):
    kw = {"batch": 16, **kw}
    return tsac.SACConfig(obs_dim=19, n_dc=3, n_g=4, n_quantiles=8, latent=32,
                          constraints=tcmdp.default_constraints(500.0), **kw)


def fake_ring(cfg, n=128, seed=1, latency=None):
    g = torch.Generator().manual_seed(seed)
    rb = treplay.replay_init(256, cfg.obs_dim, cfg.n_dc, cfg.n_g, 4, device="cpu")
    costs = torch.randn((n, 4), generator=g).abs()
    if latency is not None:
        costs[:, 0] = latency
    treplay.replay_add_chunk(rb, {
        "valid": torch.ones(n, dtype=torch.bool),
        "s0": torch.randn((n, cfg.obs_dim), generator=g),
        "s1": torch.randn((n, cfg.obs_dim), generator=g),
        "a_dc": torch.randint(0, cfg.n_dc, (n,), generator=g, dtype=torch.int32),
        "a_g": torch.randint(0, cfg.n_g, (n,), generator=g, dtype=torch.int32),
        "r": torch.randn(n, generator=g), "costs": costs,
        "mask_dc": torch.ones((n, cfg.n_dc), dtype=torch.bool),
        "mask_g": torch.ones((n, cfg.n_g), dtype=torch.bool)})
    return rb


def _key(i):
    return torch.tensor([0, i], dtype=torch.int64)


class TestCMDP:
    def test_effective_reward(self):
        out = tcmdp.effective_reward(torch.tensor([1.0, 1.0]),
                                     torch.tensor([[600.0], [400.0]]),
                                     torch.tensor([0.1]), torch.tensor([500.0]))
        np.testing.assert_allclose(out.numpy(), [1.0 - 0.1 * 100.0, 1.0])

    def test_lambda_monotone_under_violation(self):
        cons = (tcmdp.ConstraintSpec("latency_p99", 500.0),)
        st, gains = tcmdp.cmdp_init(cons, "cpu"), tcmdp._gains(cons, "cpu")
        lams = []
        for _ in range(20):
            st, _ = tcmdp.update_lagrange(st, gains, torch.full((8, 1), 510.0))
            lams.append(float(st.lam[0]))
        assert all(b >= a for a, b in zip(lams, lams[1:]))
        assert lams[-1] > lams[0]
        st2, _ = tcmdp.update_lagrange(st, gains, torch.zeros((8, 1)))
        assert float(st2.lam[0]) <= lams[-1]

    def test_lambda_clamped(self):
        cons = (tcmdp.ConstraintSpec("x", 0.0, kp=100.0, lambda_max=10.0),)
        st, _ = tcmdp.update_lagrange(tcmdp.cmdp_init(cons, "cpu"),
                                      tcmdp._gains(cons, "cpu"),
                                      torch.full((4, 1), 1e9))
        assert float(st.lam[0]) == 10.0


@pytest.fixture(scope="module", params=["onehot", "heads"])
def small(request):
    cfg = small_cfg(critic_arch=request.param)
    return cfg, fake_ring(cfg)


def test_learner_entry_points_default_to_the_card(monkeypatch):
    """``sac_init``, ``cmdp_init`` and ``_gains`` run on the card unless
    asked for the CPU: without a GPU they raise, and never fall back."""
    cfg = small_cfg()
    cons = (tcmdp.ConstraintSpec("latency_p99", 500.0),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tsac.sac_init(cfg, tprng.key(0, "cpu")),
                 lambda: tcmdp.cmdp_init(cons), lambda: tcmdp._gains(cons)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert tcmdp.cmdp_init(cons, "cpu").lam.device.type == "cpu"
    assert tsac.sac_init(cfg, tprng.key(0, "cpu"),
                         "cpu").log_alpha.device.type == "cpu"


def _fresh(cfg, seed=0):
    return tsac.sac_init(cfg, tprng.key(seed, "cpu"), device="cpu")


def _maxdiff(a, b):
    return float((a - b).abs().max())


class TestSAC:
    def test_update_finite_and_advances(self, small):
        cfg, rb = small
        sac = _fresh(cfg)
        before = {k: v.clone() for k, v in sac.flat.items()}
        m = tsac.sac_train_step(cfg, sac, rb, _key(2))
        for k in ("critic_loss", "actor_loss", "alpha_loss", "entropy", "q_mean"):
            assert np.isfinite(float(m[k])), k
        assert sac.step == 1
        for g in ("critic", "actor", "enc"):
            assert _maxdiff(before[g], sac.flat[g]) > 0, g
        # the modules' parameters are views of the flat buffers
        assert torch.equal(sac.critic.layers[0].kernel.reshape(-1),
                           sac.flat["critic"][:sac.critic.layers[0].kernel.numel()])

    def test_target_polyak_lag(self, small):
        cfg, rb = small
        sac = _fresh(cfg)
        c0, t0 = sac.flat["critic"].clone(), sac.flat["target"].clone()
        tsac.sac_train_step(cfg, sac, rb, _key(2))
        d_online = _maxdiff(c0, sac.flat["critic"])
        d_target = _maxdiff(t0, sac.flat["target"])
        assert 0 < d_target < d_online

    def test_masked_actions_never_selected(self, small):
        cfg, _ = small
        sac = _fresh(cfg)
        pa = tsac.make_policy_apply(cfg)
        mask_dc = torch.tensor([False, True, False])
        mask_g = torch.tensor([True, False, False, False])
        for i in range(20):
            a_dc, a_g = pa(sac, torch.zeros(cfg.obs_dim), mask_dc, mask_g, _key(i))
            assert (int(a_dc), int(a_g)) == (1, 0)

    def test_lambda_raises_effective_penalty(self, small):
        cfg, _ = small
        rb = fake_ring(cfg, latency=5000.0)
        sac = _fresh(cfg)
        for i in range(5):
            m = tsac.sac_train_step(cfg, sac, rb, _key(i))
        assert float(m["lambda"][0]) > 0

    def test_taken_action_matches_all_actions_gather(self):
        cfg = small_cfg(critic_arch="heads")
        sac = _fresh(cfg)
        lat = torch.randn((5, cfg.latent), generator=torch.Generator().manual_seed(3))
        a_dc, a_g = torch.tensor([0, 1, 2, 1, 0]), torch.tensor([3, 0, 1, 2, 0])
        with torch.no_grad():
            q = sac.critic(lat, a_dc, a_g)
            q_all = sac.critic.all_actions(lat)
        assert torch.equal(q, q_all[torch.arange(5), :, a_dc * cfg.n_g + a_g])


class TestAlphaCap:
    def test_alpha_max_caps_temperature(self):
        # start above the cap: Adam moves log alpha by ~lr a step
        cfg = small_cfg(batch=32, alpha_init=5.0, alpha_max=1.0)
        rb = fake_ring(cfg, n=256, latency=3.6e6)
        sac = _fresh(cfg)
        m = tsac.sac_train_step(cfg, sac, rb, _key(2))
        assert float(torch.exp(sac.log_alpha)) <= 1.0 + 1e-5
        for i in range(20):
            m = tsac.sac_train_step(cfg, sac, rb, _key(3 + i))
        assert float(torch.exp(sac.log_alpha)) <= 1.0 + 1e-5
        assert float(m["alpha"]) <= 1.0 + 1e-5
        assert np.isfinite(float(m["critic_loss"]))
        with pytest.raises(ValueError, match="alpha_max"):
            small_cfg(alpha_max=0.0)

    def test_default_config_bounds_alpha(self):
        cfg = small_cfg(batch=32)
        assert cfg.alpha_max == 10.0
        rb = fake_ring(cfg, n=256, latency=3.6e6)
        sac = _fresh(cfg)
        for i in range(10):
            tsac.sac_train_step(cfg, sac, rb, _key(i))
        assert float(torch.exp(sac.log_alpha)) <= 10.0 + 1e-4
