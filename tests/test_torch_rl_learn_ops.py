"""The chsac_af learning half's pieces against the JAX package (CPU).

Inputs are made with numpy from a seed and handed to both packages; the
networks' weights are the JAX ``sac_init``'s, perturbed with seeded values
(flax's init zeroes the biases) and carried by ``bridge.sac_from_flax``.

* B6b's plain version, ``replay_sample``: the sampled indices and all 11
  fields bitwise, over empty, partial, wrapped and full rings and over the
  key chain of a whole ``train_steps`` call (256 keys).
* The CMDP: ``effective_reward`` within 1 ulp of the reward's scale (the
  four-term sum's order is the port's tree, XLA's its own) and
  ``update_lagrange`` over 20 updates from the same ring and keys (lambda
  does not depend on the networks): lambda within ``LAM_ULP`` ulp (the batch
  mean's order differs).
* The critics (one-hot and heads): ``__call__`` and ``all_actions`` within
  ``Q_ATOL``: both run bf16 operands and round each layer to bf16, but the
  matmul sums in the CPU BLAS's order and XLA's in its own.
* B5a's and B5b's plain versions: value and gradient against
  ``jax.value_and_grad`` of the JAX package's ``quantile_huber_loss`` and of
  the target and actor terms built from its ``_joint_policy`` (composed
  here; nothing in the JAX package changes), within ``F32_RTOL`` (float32
  sums in another order).
* ``clip_adam_update`` against optax from carried state, the clip on and
  off, steps 1 and 1,000: the moments within ``ADAM_ULP`` ulp (of their
  two terms, for the first moment, whose terms may cancel); the
  parameters within ``ADAM_STEP_RTOL`` of the learning rate plus an ulp of
  their own (XLA's float32 ``0.999 ** 1000`` is 26 ulp from the correctly
  rounded value the port takes, a relative 3e-6 of the step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_cluster_gpus_tpu.rl import cmdp as jcmdp
from distributed_cluster_gpus_tpu.rl import replay as jreplay
from distributed_cluster_gpus_tpu.rl import sac as jsac
from distributed_cluster_gpus_tpu.rl.nets import QuantileCritic as JQC
from distributed_cluster_gpus_tpu.rl.nets import QuantileCriticHeads as JQCH
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.ops import prng
from distributed_cluster_gpus_tpu_torch.rl import cmdp as tcmdp
from distributed_cluster_gpus_tpu_torch.rl import optim
from distributed_cluster_gpus_tpu_torch.rl import replay as treplay
from distributed_cluster_gpus_tpu_torch.rl import sac as tsac

#: lambda, integral and error of the PID step: ulps apart at most (the
#: batch mean's summation order is the port's tree, XLA's its own)
LAM_ULP = 8
#: critic quantiles: one differently rounded bf16 unit in a hidden layer
Q_ATOL = 0.02
#: value and gradient of B5a/B5b's plain versions (float32, other order)
F32_RTOL = 1e-5
#: clipped Adam against optax: the global norm's order (the clip scales
#: every element by max_norm / g_norm) and b^t's rounding
ADAM_ULP = 8
ADAM_STEP_RTOL = 1e-5

OBS, N_DC, N_G, N_Q = 49, 8, 8, 32


def _ulps(a, b):
    """Units in the last place between float32 arrays (sign-aware)."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(key(a) - key(b))


def _key_t(k):
    return torch.tensor(np.asarray(jax.random.key_data(k)).astype(np.int64))


# ---------------------------------------------------------------- B6b


def _window(rng, n, p_valid):
    return {"valid": rng.random(n) < p_valid,
            "s0": rng.normal(size=(n, OBS)).astype(np.float32),
            "s1": rng.normal(size=(n, OBS)).astype(np.float32),
            "a_dc": rng.integers(0, N_DC, n).astype(np.int32),
            "a_g": rng.integers(0, N_G, n).astype(np.int32),
            "r": rng.normal(size=n).astype(np.float32),
            "costs": (rng.random((n, 4)) * 800).astype(np.float32),
            "done": (rng.random(n) < 0.5).astype(np.float32),
            "mask_dc": rng.random((n, N_DC)) < 0.7,
            "mask_g": rng.random((n, N_G)) < 0.7,
            "mask_dc0": rng.random((n, N_DC)) < 0.7,
            "mask_g0": rng.random((n, N_G)) < 0.7}


RINGS = {  # capacity, window sizes, valid fraction
    "empty": (300, [], 0.0),
    "partial": (300, [120], 0.6),
    "wrapped": (300, [140, 140, 140], 0.7),
    "full": (256, [64] * 6, 1.0),
    "one_valid": (300, [40], 0.0),
}


def _rings(name):
    C, sizes, pv = RINGS[name]
    rng = np.random.default_rng(len(name) + C)
    rbj = jreplay.replay_init(C, OBS, N_DC, N_G, 4)
    for n in sizes:
        w = _window(rng, n, pv)
        if name == "one_valid":
            w["valid"][17] = True
        rbj = jreplay.replay_add_chunk(rbj, {k: jnp.asarray(v) for k, v in w.items()})
    tree = bridge.tree_to_numpy(jax.device_get(rbj))
    rbt = treplay.ReplayState(**{k: torch.tensor(np.array(v)) for k, v in tree.items()})
    return rbj, rbt


@pytest.fixture(scope="module")
def sample_j():
    return jax.jit(jreplay.replay_sample, static_argnums=2)


def _check_sample(sample_j, rbj, rbt, key, B):
    out_j = jax.device_get(sample_j(rbj, key, B))
    out_t = treplay.replay_sample(rbt, _key_t(key), B)
    cdf = np.cumsum(np.asarray(rbj.valid, np.float32))
    u = np.asarray(jax.random.uniform(key, (B,))) * max(cdf[-1], 1.0)
    idx = np.clip(np.searchsorted(cdf, u, side="right"), 0, len(cdf) - 1)
    assert np.array_equal(out_t["idx"].numpy(), idx)
    for name in treplay.ROW_FIELDS:
        a, b = np.asarray(out_j[name]), out_t[name].numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    return idx


@pytest.mark.parametrize("ring", list(RINGS))
def test_replay_sample_bitwise(sample_j, ring):
    rbj, rbt = _rings(ring)
    idx = _check_sample(sample_j, rbj, rbt, jax.random.key(5), 256)
    valid = np.asarray(rbj.valid)
    if ring == "empty":
        assert (idx == len(valid) - 1).all()
    else:
        assert valid[idx].all()
    if ring == "one_valid":
        assert len(set(idx.tolist())) == 1


def test_replay_sample_over_a_train_steps_key_chain(sample_j):
    """The keys one ``train_steps(256)`` call samples with: ``split(k,
    256)[i]`` then ``split(.)[0]``, in both packages."""
    rbj, rbt = _rings("wrapped")
    k = jax.random.split(jax.random.key(9))[1]
    keys_j = jax.random.split(k, 256)
    keys_t = prng.split(_key_t(k), 256)
    seen = set()
    for i in range(256):
        kj = jax.random.split(keys_j[i])[0]
        assert np.array_equal(_key_t(kj).numpy(), prng.split(keys_t[i], 2)[0].numpy())
        seen.update(_check_sample(sample_j, rbj, rbt, kj, 32).tolist())
    assert len(seen) > 150


# ---------------------------------------------------------------- CMDP


def test_effective_reward_matches():
    rng = np.random.default_rng(3)
    r = rng.normal(size=64).astype(np.float32)
    costs = (rng.random((64, 4)) * 900).astype(np.float32)
    lam = np.asarray([0.3, 1.5, 10.0, 0.0], np.float32)
    tgt = np.asarray([500.0, 600.0, 0.0, 1e30], np.float32)
    a = np.asarray(jcmdp.effective_reward(r, costs, lam, tgt))
    b = tcmdp.effective_reward(*(torch.tensor(x) for x in (r, costs, lam, tgt))).numpy()
    scale = np.abs(r) + np.abs(lam * np.maximum(costs - tgt, 0)).sum(-1)
    assert np.all(np.abs(a - b) <= np.spacing(scale.astype(np.float32)))


def test_lagrange_trajectory_matches_over_20_updates(sample_j):
    rbj, rbt = _rings("wrapped")
    cons_j = jcmdp.default_constraints(300.0, power_cap=500.0)
    cons_t = tcmdp.default_constraints(300.0, power_cap=500.0)
    st_j, st_t = jcmdp.cmdp_init(cons_j), tcmdp.cmdp_init(cons_t, device="cpu")
    gains = tcmdp._gains(cons_t, device="cpu")
    upd_j = jax.jit(lambda s, c: jcmdp.update_lagrange(s, cons_j, c))
    lams = []
    for i in range(20):
        k = jax.random.split(jax.random.key(100 + i))[0]
        costs = sample_j(rbj, k, 64)["costs"]
        st_j, err_j = upd_j(st_j, costs)
        st_t, err_t = tcmdp.update_lagrange(
            st_t, gains, treplay.replay_sample(rbt, _key_t(k), 64)["costs"])
        for x, y in ((st_j.lam, st_t.lam), (st_j.integral, st_t.integral),
                     (err_j, err_t)):
            assert _ulps(np.asarray(x), y.numpy()).max() <= LAM_ULP
        lams.append(float(st_t.lam[0]))
    assert lams[-1] > lams[0] > 0


# ---------------------------------------------------------------- critics


def _perturbed(tree, rng):
    return jax.tree.map(lambda a: (np.asarray(a) + rng.normal(
        0.0, 0.1 if a.ndim == 1 else 0.02, a.shape)).astype(np.float32), tree)


def _cfgs(arch, batch=32):
    cj = jsac.SACConfig(obs_dim=OBS, n_dc=N_DC, n_g=N_G, batch=batch,
                        critic_arch=arch,
                        constraints=jcmdp.default_constraints(500.0))
    ct = tsac.SACConfig(obs_dim=OBS, n_dc=N_DC, n_g=N_G, batch=batch,
                        critic_arch=arch,
                        constraints=tcmdp.default_constraints(500.0))
    return cj, ct


def carried_pair(arch, seed=0, batch=32):
    """(JAX config, port config, JAX SACState with perturbed networks, the
    port's SACState carried from it on the CPU)."""
    cj, ct = _cfgs(arch, batch)
    sj = jsac.sac_init(cj, jax.random.key(seed))
    rng = np.random.default_rng(seed + 5)
    crit = _perturbed(sj.critic_params, rng)
    sj = sj.replace(enc_params=_perturbed(sj.enc_params, rng),
                    actor_params=_perturbed(sj.actor_params, rng),
                    critic_params=crit,
                    target_critic_params=_perturbed(crit, rng))
    sj = jax.tree.map(jnp.asarray, sj)
    st = bridge.sac_from_flax(ct, jax.tree.map(np.asarray, sj), device="cpu")
    return cj, ct, sj, st


@pytest.mark.parametrize("arch", ["onehot", "heads"])
def test_critic_matches_flax(arch):
    cj, ct, sj, st = carried_pair(arch)
    assert not bridge.tree_mismatches(
        bridge.flax_sac_to_numpy(jax.tree.map(np.asarray, sj)),
        bridge.sac_to_numpy(ct, st))
    rng = np.random.default_rng(11)
    lat = np.maximum(rng.normal(size=(16, cj.latent)), 0).astype(np.float32)
    a_dc = rng.integers(0, N_DC, 16).astype(np.int32)
    a_g = rng.integers(0, N_G, 16).astype(np.int32)
    critic = (JQCH if arch == "heads" else JQC)(n_dc=N_DC, n_g=N_G, n_quantiles=N_Q)
    q_j = np.asarray(critic.apply(sj.critic_params, lat, a_dc, a_g))
    all_j = np.asarray(critic.apply(sj.critic_params, lat, method=critic.all_actions))
    with torch.no_grad():
        q_t = st.critic(torch.tensor(lat), torch.tensor(a_dc), torch.tensor(a_g))
        all_t = st.critic.all_actions(torch.tensor(lat))
    assert q_t.shape == (16, 2, N_Q) and all_t.shape == (16, 2, N_DC * N_G, N_Q)
    assert np.abs(q_j - q_t.numpy()).max() <= Q_ATOL
    assert np.abs(all_j - all_t.numpy()).max() <= Q_ATOL
    if arch == "heads":  # the taken action is a gather from the heads
        want = all_t[torch.arange(16), :, torch.tensor(a_dc * N_G + a_g).long()]
        assert torch.equal(q_t, want)


# ---------------------------------------------------------------- B5a, B5b


def _rel_close(a, b, rtol=F32_RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(a).max(), 1e-30)
    assert np.abs(a - b).max() <= rtol * scale


def test_quantile_huber_value_and_grad():
    rng = np.random.default_rng(13)
    B = 32
    q = rng.normal(size=(B, 2, N_Q)).astype(np.float32)
    tgt = rng.normal(size=(B, N_Q)).astype(np.float32) * 2
    tgt[0, :4] = q[0, 0, :4] + 1.0  # |td| exactly at kappa
    tgt[1, :4] = q[1, 1, :4]  # td exactly 0
    tgt[2, :4] = q[2, 0, :4] - 1.0
    taus = (np.arange(N_Q, dtype=np.float32) + 0.5) / N_Q

    def loss_j(qq):
        return (jsac.quantile_huber_loss(qq[:, 0], tgt, taus)
                + jsac.quantile_huber_loss(qq[:, 1], tgt, taus))

    v_j, g_j = jax.value_and_grad(loss_j)(jnp.asarray(q))
    v_t, g_t = tsac.quantile_huber_loss(torch.tensor(q), torch.tensor(tgt),
                                        torch.tensor(taus))
    _rel_close(v_j, v_t.numpy())
    _rel_close(g_j, g_t.numpy())


def _policy_inputs(rng, B, all_masked=False):
    def masked_logp(n, mask):
        x = np.where(mask, rng.normal(size=mask.shape), -1e9).astype(np.float32)
        return np.asarray(jax.nn.log_softmax(x, axis=-1))

    m_dc = rng.random((B, N_DC)) < 0.6
    m_g = rng.random((B, N_G)) < 0.6
    m_dc[:, 0] = True
    m_g[:, 1] = True
    if all_masked:
        m_dc[0] = False  # a head with every action masked: uniform
        m_g[1] = False
    m_dc[2] = False
    m_dc[2, 5] = True  # one feasible DC
    return masked_logp(N_DC, m_dc), masked_logp(N_G, m_g)


def _joint(ldc, lg):
    return jsac._joint_policy(None, ldc, lg)


@pytest.mark.parametrize("all_masked", [False, True], ids=["masked", "all_masked"])
def test_marginal_target_value(all_masked):
    rng = np.random.default_rng(17)
    B, A = 32, N_DC * N_G
    q = rng.normal(size=(B, 2, A, N_Q)).astype(np.float32)
    ldc, lg = _policy_inputs(rng, B, all_masked)
    r = rng.normal(size=B).astype(np.float32)
    costs = (rng.random((B, 4)) * 900).astype(np.float32)
    lam = np.asarray([0.4, 0.0, 2.0, 0.0], np.float32)
    tgt = np.asarray([500.0, 1e30, 0.0, 1e30], np.float32)
    done = (np.arange(B) % 2).astype(np.float32)
    # the port's region reads log alpha, as the JAX update derives alpha
    log_alpha = np.float32(np.log(0.3))
    alpha = jnp.exp(log_alpha)
    r_eff = jcmdp.effective_reward(r, costs, lam, tgt)
    logpi = _joint(ldc, lg)
    soft = jnp.min(q, axis=1) - alpha * logpi[:, :, None]
    v1 = jnp.sum(jnp.exp(logpi)[:, :, None] * soft, axis=1)
    want = r_eff[:, None] + 0.99 * (1.0 - done[:, None]) * v1
    tq, re = tsac.marginal_target(*(torch.tensor(x) for x in (
        q, ldc, lg, r, costs, lam, tgt, done, log_alpha)), 0.99)
    assert np.isfinite(tq.numpy()).all()
    _rel_close(want, tq.numpy())
    _rel_close(r_eff, re.numpy())
    assert np.array_equal(tq.numpy()[1::2], np.broadcast_to(
        re.numpy()[1::2, None], (B // 2, N_Q)))  # done rows: r_eff alone


@pytest.mark.parametrize("all_masked", [False, True], ids=["masked", "all_masked"])
def test_marginal_actor_value_and_grad(all_masked):
    rng = np.random.default_rng(19)
    B, A = 32, N_DC * N_G
    q = rng.normal(size=(B, 2, A, N_Q)).astype(np.float32)
    ldc, lg = _policy_inputs(rng, B, all_masked)
    log_alpha = np.float32(np.log(0.25))
    alpha = jnp.exp(log_alpha)

    def loss_j(ldc_, lg_):
        logpi = _joint(ldc_, lg_)
        pi = jnp.exp(logpi)
        qm = jnp.mean(jnp.min(q, axis=1), axis=-1)
        ent = -jnp.sum(pi * logpi, axis=-1)
        return -jnp.mean(jnp.sum(pi * qm, axis=-1) + alpha * ent), ent

    (v_j, ent_j), (gdc_j, gg_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(jnp.asarray(ldc), jnp.asarray(lg))
    v_t, ent_t, gdc_t, gg_t = tsac.marginal_actor(*(torch.tensor(x) for x in (
        q, ldc, lg, log_alpha)))
    for x in (v_t, ent_t, gdc_t, gg_t):
        assert np.isfinite(x.numpy()).all()
    _rel_close(v_j, v_t.numpy())
    _rel_close(ent_j, ent_t.numpy())
    _rel_close(gdc_j, gdc_t.numpy())
    _rel_close(gg_j, gg_t.numpy())
    # a masked action's pi * log pi is -0, never NaN; its gradient is 0
    logpi = (torch.tensor(ldc)[:, :, None] + torch.tensor(lg)[:, None, :]).reshape(B, -1)
    pl = torch.exp(logpi) * logpi
    assert bool(((pl == 0) | (logpi > -1e8)).all())
    assert (gdc_t.numpy()[2, [0, 1, 2, 3, 4, 6, 7]] == 0.0).all()


# ---------------------------------------------------------------- B5c


@pytest.mark.parametrize("clip", [False, True], ids=["no_clip", "clip"])
@pytest.mark.parametrize("step", [0, 999], ids=["step1", "step1000"])
def test_clip_adam_matches_optax(clip, step):
    rng = np.random.default_rng(29 + step)
    shapes = {"a": (300, 40), "b": (40,), "c": (17, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    scale = 0.2 if clip else 0.001
    grads = {k: (rng.normal(size=s) * scale).astype(np.float32)
             for k, s in shapes.items()}
    grads["b"][:5] = 0.0  # zero gradient elements
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(3e-4))
    st = tx.init(params)
    adam = st[1][0]
    mu = {k: (rng.normal(size=s) * 0.01).astype(np.float32) for k, s in shapes.items()}
    nu = {k: (rng.random(s) * 1e-4).astype(np.float32) for k, s in shapes.items()}
    if step:
        st = (st[0], (adam._replace(count=jnp.int32(step), mu=mu, nu=nu), st[1][1]))
    gnorm = float(optax.global_norm(grads))
    assert (gnorm > 5.0) == clip
    upd, st2 = jax.jit(tx.update)(grads, st, params)
    new_p = optax.apply_updates(params, upd)
    keys = sorted(shapes)

    def flat(tree):
        return torch.tensor(np.concatenate([np.asarray(tree[k]).reshape(-1)
                                            for k in keys]))

    p = flat(params)
    ost = optim.AdamState(count=torch.tensor(step, dtype=torch.int32),
                          mu=flat(mu) if step else torch.zeros_like(p),
                          nu=flat(nu) if step else torch.zeros_like(p))
    optim.clip_adam_update(p, flat(grads), ost, optim.AdamConfig())
    assert int(ost.count) == step + 1
    a2 = st2[1][0]
    # mu's two terms may cancel (XLA may fuse the sum): ulps of the terms
    g_c = flat(grads).numpy() * min(1.0, 5.0 / gnorm)
    terms = 0.1 * np.abs(g_c) + 0.9 * np.abs(flat(mu).numpy() if step else 0.0)
    assert np.all(np.abs(flat(a2.mu).numpy() - ost.mu.numpy())
                  <= ADAM_ULP * np.spacing(terms.astype(np.float32)))
    assert _ulps(flat(a2.nu).numpy(), ost.nu.numpy()).max() <= ADAM_ULP
    want = flat(new_p).numpy()
    assert np.all(np.abs(want - p.numpy()) <= ADAM_STEP_RTOL * 3e-4
                  + np.spacing(np.abs(want)))
    assert np.abs(want - flat(params).numpy()).max() > 1e-4  # it stepped


def test_sum_squares_blocked_order():
    """The plain global norm's blocked order against an exact sum."""
    rng = np.random.default_rng(31)
    for n in (1, 255, 256, 257, 16_384 * 3 + 5, 287_808, 1_048_577):
        g = rng.normal(size=n).astype(np.float32)
        k, r = optim.norm_layout(n)
        per = r * optim.THREADS * optim.VEC
        assert k * per >= n > (k - 1) * per and k <= optim.MAX_BLOCKS
        got = float(optim.sum_squares(torch.tensor(g)))
        want = float(np.sum(g.astype(np.float64) ** 2))
        assert abs(got - want) <= 1e-5 * want
