"""The SAC update's small fused regions (B5d-B5g) in the port against the
JAX package, on the CPU (where each wrapper runs its plain version), at
small widths and on the same numpy-seeded inputs:

* B5d, the Dense layers' training forward and their gradients by hand,
  against ``jax.value_and_grad`` (run op by op, as flax's bf16 ``Dense``
  rounds; ``jit`` lets XLA drop some of those roundings) of flax's bf16
  ``Dense`` + ReLU stacks (the
  JAX package's ``MLPStateEncoder`` and ``HybridActor``): outputs, input
  gradients and kernel gradients bitwise at the encoder's widths (both
  round each layer to bf16, and there their float32 sums agree), within a
  bf16 rounding below the actor's float32 log-softmax; the bias gradients within
  ``bias_grad_bound``: XLA's CPU reduction sums a bf16 gradient in bf16
  (each partial rounded), the port sums it in float32 by the fixed tree and
  rounds once, so the two differ by XLA's accumulation error (the port's
  within one bf16 rounding of the exact sum, which is also checked);
* B5e, the one-hot critic's input rows (the rows ``critic_first_fwd``
  keeps), bitwise against the rows the JAX package's ``QuantileCritic``
  feeds its first ``Dense`` (taken actions and ``all_actions``);
* B5f, the masked log-softmax (its plain version, which the heads' fused
  forward repeats) and its gradient against ``nn.log_softmax`` under the
  mask (``jax.vjp``), a fully masked head included, within ``LOGP_ULP`` ulp
  / ``GRAD_RTOL``; the fused heads' backward (``heads_backward``, both
  heads' gradients cast to bf16 with their bias gradients) bitwise the
  gradient's bf16 cast and its tree;
* B5g, the shadows' refresh: float32 -> bf16 bitwise equal to
  ``astype(bfloat16)`` (ties to even, subnormals, overflow to infinity).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.rl.nets import HybridActor as JActor
from distributed_cluster_gpus_tpu.rl.nets import MLPStateEncoder as JEnc
from distributed_cluster_gpus_tpu.rl.nets import QuantileCritic as JQC
from distributed_cluster_gpus_tpu_torch.kernels.dense import critic_first_fwd
from distributed_cluster_gpus_tpu_torch.kernels.log_softmax import \
    heads_backward
from distributed_cluster_gpus_tpu_torch.kernels.param_pack import param_pack
from distributed_cluster_gpus_tpu_torch.rl import nets

BF16 = torch.bfloat16
#: log-probabilities: float32 exp/log and a sum in another order
LOGP_ULP = 4
#: the log-softmax's gradient, relative to its largest magnitude
GRAD_RTOL = 1e-6
BF16_U = 2.0 ** -8  # bf16's unit roundoff
F32_U = 2.0 ** -24


def _perturbed(tree, rng, scale=0.1):
    return jax.tree.map(lambda a: (np.asarray(a) + rng.normal(
        0.0, scale, a.shape)).astype(np.float32), tree)


def _load(module, params):
    """flax ``params`` into the port's ``module`` (flax's names and
    layout)."""
    for name, layer in zip(nets.flax_names(module), nets.dense_layers(module)):
        p = params["params"][name]
        with torch.no_grad():
            layer.kernel.copy_(torch.from_numpy(np.asarray(p["kernel"])))
            layer.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))


def _staging(w):
    return [(torch.empty_like(k), torch.empty_like(b)) for k, b in w]


def _bf16_np(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF16)


def bias_grad_bound(G):
    """|XLA's bias gradient - the port's| per column of the layer's bf16
    gradient G [R, N]: XLA's sum of R bf16 terms in bf16 is within (R - 1)
    u sum|G| of the exact sum (u = 2^-8), the port's within u |sum| (its
    float32 tree's error far below)."""
    a = np.abs(G.to(torch.float32).numpy().astype(np.float64)).sum(0)
    return G.shape[0] * BF16_U * a + 1e-30


def _tree_np(x):
    """numpy's float32 halving tree over the last axis (zero-padded)."""
    x = np.asarray(x, np.float32)
    p = 1
    while p < x.shape[-1]:
        p *= 2
    x = np.concatenate([x, np.zeros(x.shape[:-1] + (p - x.shape[-1],),
                                    np.float32)], -1)
    while p > 1:
        p //= 2
        x = x[..., :p] + x[..., p:]
    return x[..., 0]


def _check_bias_grad(db_j, db_t, G):
    """The port's bias gradient is the tree's float32 sum of G over the rows
    rounded to bf16, within one bf16 rounding of the exact sum and within
    XLA's accumulation error of the JAX package's."""
    want = torch.from_numpy(_tree_np(G.to(torch.float32).numpy().T)).to(BF16)
    assert torch.equal(db_t.view(torch.int16), want.view(torch.int16))
    exact = G.to(torch.float32).numpy().astype(np.float64).sum(0)
    got = db_t.to(torch.float32).numpy()
    assert np.all(np.abs(got - exact) <= BF16_U * np.abs(exact)
                  + G.shape[0] * F32_U * np.abs(G.to(torch.float32).numpy()).sum(0))
    assert np.all(np.abs(np.asarray(db_j) - got) <= bias_grad_bound(G))


# ---------------------------------------------------------------- B5d


@pytest.mark.parametrize("B", [8, 33])
def test_dense_stack_value_and_grads_match_flax(B):
    """The encoder's stack (13 -> 24 -> 32 -> 16, a ReLU at every layer, the
    output widened to float32) forward and backward against ``jax.grad`` of
    L = sum(enc(obs) * ct) with respect to the parameters (each layer's
    input gradient feeds the next kernel gradient down, held bitwise);
    B = 33 rows pads the bias gradients' tree."""
    rng = np.random.default_rng(B)
    obs = rng.normal(size=(B, 13)).astype(np.float32)
    ct = rng.normal(size=(B, 16)).astype(np.float32)
    enc_j = JEnc(latent=16, hidden=(24, 32))
    pj = _perturbed(enc_j.init(jax.random.key(1), obs), rng)

    def loss(p, x):
        return jnp.sum(enc_j.apply(p, x) * ct)

    out_j = np.asarray(enc_j.apply(pj, obs))
    gp = jax.grad(loss)(pj, obs)

    enc_t = nets.MLPStateEncoder(13, latent=16, hidden=(24, 32))
    _load(enc_t, pj)
    w = nets.casts(enc_t)
    dw = _staging(w)
    lat, acts = enc_t.train_forward(torch.from_numpy(obs), w)
    assert torch.equal(lat, acts[-1].to(torch.float32))
    assert np.array_equal(out_j, lat.numpy())
    nets.mlp_backward(acts, w, dw, torch.from_numpy(ct), True)
    g = torch.from_numpy(ct).to(BF16)
    for k in reversed(range(3)):
        gj = gp["params"][f"Dense_{k}"]
        assert np.array_equal(np.asarray(gj["kernel"]),
                              dw[k][0].to(torch.float32).numpy()), k
        G = torch.where(acts[k + 1] > 0, g, torch.zeros_like(g))
        _check_bias_grad(gj["bias"], dw[k][1], G)
        g = torch.matmul(G, w[k][0].t())


@pytest.mark.parametrize("masks", ["random", "dc_all_masked", "one_feasible"])
def test_actor_value_and_grads_match_flax(masks):
    """The actor (hidden layer, two heads, masked log-softmax) forward and
    backward against ``jax.value_and_grad`` of L = sum(logp_dc * c_dc +
    logp_g * c_g) with respect to its parameters and the latent: the hidden
    layer sums its two heads' gradients (``g2``) in its B5d backward."""
    B, L, H, n_dc, n_g = 32, 16, 24, 5, 8
    rng = np.random.default_rng(len(masks))
    lat = _bf16_np(np.maximum(rng.normal(size=(B, L)), 0)).to(torch.float32).numpy()
    m_dc, m_g = rng.random((B, n_dc)) < 0.6, rng.random((B, n_g)) < 0.6
    m_dc[:, 0] = m_g[:, 1] = True
    if masks == "dc_all_masked":
        m_dc[::3] = False
    elif masks == "one_feasible":
        m_g[:] = False
        m_g[:, 2] = True
    c_dc = rng.normal(size=(B, n_dc)).astype(np.float32)
    c_g = rng.normal(size=(B, n_g)).astype(np.float32)
    act_j = JActor(n_dc=n_dc, n_g=n_g, hidden=H)
    pj = _perturbed(act_j.init(jax.random.key(2), lat, m_dc, m_g), rng, 0.3)

    def loss(p, x):
        lp_dc, lp_g = act_j.apply(p, x, m_dc, m_g)
        return jnp.sum(lp_dc * c_dc) + jnp.sum(lp_g * c_g), (lp_dc, lp_g)

    (_, (lp_dc, lp_g)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(pj, lat)

    act_t = nets.HybridActor(L, n_dc, n_g, hidden=H)
    _load(act_t, pj)
    w = nets.casts(act_t)
    dw = _staging(w)
    lat16 = torch.from_numpy(lat).to(BF16)
    md, mg = torch.from_numpy(m_dc), torch.from_numpy(m_g)
    ld_t, lg_t, saved = act_t.train_forward(lat16, md, mg, w)
    for a, b in ((lp_dc, ld_t), (lp_g, lg_t)):
        assert np.all(np.abs(np.asarray(a) - b.numpy()) <= LOGP_ULP * np.spacing(
            np.maximum(np.abs(np.asarray(a)), 1.0).astype(np.float32)))
    d_lat = act_t.train_backward(saved, torch.from_numpy(c_dc),
                                 torch.from_numpy(c_g), w, dw)
    # the gradients below the log-softmax agree to its float32 rounding,
    # which bf16 rounds away unless a value sits at a rounding boundary
    gx = np.asarray(gx)
    assert np.abs(gx - d_lat.to(torch.float32).numpy()).max() <= \
        2 * BF16_U * np.abs(gx).max()
    # each layer's bf16 gradient G: the heads' the logits' gradient rounded,
    # the hidden layer's their two products summed and masked by its ReLU
    _, hid, l_dc, l_g, _, _ = saved
    G = [None, *(nets.masked_log_softmax_backward(l_, m, torch.from_numpy(c)).to(
        BF16) for l_, m, c in ((l_dc, md, c_dc), (l_g, mg, c_g)))]
    dx = [torch.matmul(G[k], w[k][0].t()).to(torch.float32) for k in (1, 2)]
    G[0] = torch.where(hid > 0, (dx[0] + dx[1]).to(BF16), torch.zeros_like(hid))
    for k, name in enumerate(nets.flax_names(act_t)):
        gk = np.asarray(gp["params"][name]["kernel"])
        got = dw[k][0].to(torch.float32).numpy()
        assert np.abs(gk - got).max() <= 2 * BF16_U * np.abs(gk).max(), name
        _check_bias_grad(gp["params"][name]["bias"], dw[k][1], G[k])


# ---------------------------------------------------------------- B5e


def _first_dense_input(critic, params, *args, **kw):
    """The bf16 rows the JAX package's critic feeds its first Dense."""
    seen = []

    def grab(next_fun, a, k, context):
        if context.method_name == "__call__" and context.module.name == "Dense_0":
            seen.append(np.asarray(a[0].astype(jnp.bfloat16).astype(jnp.float32)))
        return next_fun(*a, **k)

    with nn.intercept_methods(grab):
        critic.apply(params, *args, **kw)
    return seen[0]


def test_critic_input_rows_match_flax(n_dc=3, n_g=4):
    """B5e's rows (those the critic's fused first layer keeps) bitwise
    against the JAX critic's concat and cast, for the taken actions and for
    ``all_actions``."""
    B, L = 6, 16
    rng = np.random.default_rng(n_dc)
    lat = rng.normal(size=(B, L)).astype(np.float32)
    a_dc = rng.integers(0, n_dc, B).astype(np.int32)
    a_g = rng.integers(0, n_g, B).astype(np.int32)
    critic = JQC(n_dc=n_dc, n_g=n_g, n_quantiles=4, hidden=(8, 8))
    params = critic.init(jax.random.key(0), lat, a_dc, a_g)
    k0 = _bf16_np(params["params"]["Dense_0"]["kernel"])
    b0 = _bf16_np(params["params"]["Dense_0"]["bias"])
    want = _first_dense_input(critic, params, lat, a_dc, a_g)
    _, got = critic_first_fwd(torch.from_numpy(lat), n_dc, n_g, k0, b0,
                              torch.from_numpy(a_dc), torch.from_numpy(a_g),
                              keep_rows=True)
    assert got.dtype == BF16 and np.array_equal(want, got.to(torch.float32).numpy())
    want = _first_dense_input(critic, params, lat, method=critic.all_actions)
    _, got = critic_first_fwd(torch.from_numpy(lat), n_dc, n_g, k0, b0,
                              keep_rows=True)
    assert got.shape == (B * n_dc * n_g, L + n_dc + n_g)
    assert np.array_equal(want, got.to(torch.float32).numpy())
    assert critic_first_fwd.launches == 0  # the plain version on the CPU


# ---------------------------------------------------------------- B5f


@pytest.mark.parametrize("n", [1, 5, 8])
def test_masked_log_softmax_and_grad_match_flax(n):
    """Both heads' masked log-softmax (the plain version the fused heads
    repeat) and B5f's backward in one call against flax's
    ``nn.log_softmax`` under the mask and its ``jax.vjp``: random masks, a
    fully masked row (a uniform head), one feasible entry, large logits."""
    B = 12
    rng = np.random.default_rng(n)
    logits = [(rng.normal(size=(B, n)) * s).astype(np.float32) for s in (1, 30)]
    masks = [rng.random((B, n)) < 0.6 for _ in range(2)]
    for m in masks:
        m[0] = False
        m[1] = False
        m[1, n - 1] = True
    cts = [rng.normal(size=(B, n)).astype(np.float32) for _ in range(2)]
    lp_t = [nets.masked_log_softmax(torch.from_numpy(x), torch.from_numpy(m))
            for x, m in zip(logits, masks)]
    dl_t = [nets.masked_log_softmax_backward(*(torch.from_numpy(v) for v in a))
            for a in zip(logits, masks, cts)]
    dbs = [torch.empty(n, dtype=BF16) for _ in range(2)]
    G_t = heads_backward(*(torch.from_numpy(x) for x in logits),
                         *(torch.from_numpy(m) for m in masks),
                         *(torch.from_numpy(c) for c in cts), *dbs)
    for k in range(2):
        def f(x, m=masks[k]):
            return nn.log_softmax(jnp.where(m, x, jnp.float32(-1e9)), axis=-1)

        lp_j, vjp = jax.vjp(f, logits[k])
        lp_j, (dl_j,) = np.asarray(lp_j), vjp(cts[k])
        assert np.all(np.abs(lp_j - lp_t[k].numpy()) <= LOGP_ULP * np.spacing(
            np.maximum(np.abs(lp_j), 1.0).astype(np.float32)))
        dl_j = np.asarray(dl_j)
        assert np.abs(dl_j - dl_t[k].numpy()).max() <= GRAD_RTOL * max(
            np.abs(dl_j).max(), 1.0)
        assert np.all(dl_t[k].numpy()[~masks[k]] == 0)
        want = dl_t[k].to(BF16)
        assert torch.equal(G_t[k].view(torch.int16), want.view(torch.int16))
        assert torch.equal(dbs[k].view(torch.int16), torch.from_numpy(_tree_np(
            want.to(torch.float32).numpy().T)).to(BF16).view(torch.int16))
    assert heads_backward.launches == 0


# ---------------------------------------------------------------- B5g


def test_pack_rounds_as_astype_bfloat16():
    """float32 -> bf16 bitwise equal to JAX's ``astype(bfloat16)`` (round to
    nearest even: ties both ways, subnormals, the largest finite values
    and their overflow to infinity).  (The widening back to float32 runs
    inside B5c: ``tests/test_torch_param_shadows.py``.)"""
    rng = np.random.default_rng(0)
    x = rng.normal(size=1000).astype(np.float32) * np.float32(1e3)
    ties = (np.arange(1, 200, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    edge = np.array([0.0, -0.0, 1e-40, -1e-42, 3.3895e38, 3.4e38, -3.4e38,
                     np.inf, -np.inf, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8],
                    np.float32)
    src = np.concatenate([x, ties, -ties, edge]).astype(np.float32)
    shadow = torch.empty(src.size, dtype=BF16)
    param_pack([(torch.from_numpy(src), shadow)])
    want = np.asarray(jnp.asarray(src).astype(jnp.bfloat16)).view(np.uint16)
    assert np.array_equal(shadow.view(torch.int16).numpy().view(np.uint16), want)
    assert param_pack.launches == 0
