"""The chsac_af policy (encoder + actor, 256 wide as published) against the
JAX package's with the same weights (CPU).

The JAX ``SACState``'s flax parameters are carried across by
``bridge.sac_from_flax``.  Both forwards run bf16 operands with float32
products, but the port sums each output's products by a fixed halving tree
(the recipe the B4 kernel repeats bit for bit) while XLA's CPU dot sums in
its own order; each layer's output is then rounded to bfloat16 (8 bits), so
one differently rounded hidden unit moves the logits by about a bf16 ulp of
their scale.  The stated tolerance is therefore ``LOGP_ATOL`` on every
log-probability, with feasible actions compared (masked ones sit at about
-1e9 on both sides and agree to float32 rounding of that).

The published 8 x 8 heads and the paper fleet at 128 GPU-count actions (the
widest head B1's RL mode acts with there) are both held.

The JAX package's initialisation zeroes every bias, so the carried weights
are first perturbed with seeded values (non-zero biases, shifted kernels)
on the JAX side: both forwards then add a bias in every layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.rl.cmdp import default_constraints as jconstraints
from distributed_cluster_gpus_tpu.rl.sac import SACConfig as JCfg
from distributed_cluster_gpus_tpu.rl.sac import _modules as jmodules
from distributed_cluster_gpus_tpu.rl.sac import sac_init as jsac_init
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.rl import nets
from distributed_cluster_gpus_tpu_torch.rl.cmdp import default_constraints
from distributed_cluster_gpus_tpu_torch.rl.sac import (SACConfig, make_policy_apply,
                                                       policy_logp, policy_weights,
                                                       sac_init, select_action)

#: |logp_port - logp_jax| on feasible actions (see the module docstring)
LOGP_ATOL = 0.01


def _cfgs(obs_dim, n_dc, n_g):
    return (JCfg(obs_dim=obs_dim, n_dc=n_dc, n_g=n_g,
                 constraints=jconstraints()),
            SACConfig(obs_dim=obs_dim, n_dc=n_dc, n_g=n_g,
                      constraints=default_constraints()))


def _perturbed(tree, rng):
    """``tree``'s arrays with seeded noise: 0.1 on biases, 0.02 on kernels."""
    return jax.tree.map(lambda a: (a + rng.normal(0.0, 0.1 if a.ndim == 1 else
                                                  0.02, a.shape)).astype(a.dtype),
                        tree)


@pytest.fixture(scope="module", params=[(13, 2, 8), (49, 8, 8), (49, 8, 128)],
                ids=["duo", "paper", "paper_g128"])
def pair(request):
    """(JAX config, port config, the JAX weights as numpy trees (perturbed),
    the port's SACState carried from them, JAX's jitted logp)."""
    obs_dim, n_dc, n_g = request.param
    cj, ct = _cfgs(obs_dim, n_dc, n_g)
    sj = jsac_init(cj, jax.random.key(17))
    rng = np.random.default_rng(23)
    enc_np = _perturbed(jax.tree.map(np.asarray, sj.enc_params), rng)
    act_np = _perturbed(jax.tree.map(np.asarray, sj.actor_params), rng)
    st = bridge.sac_from_flax(
        ct, jax.tree.map(np.asarray, sj).replace(enc_params=enc_np,
                                                 actor_params=act_np),
        device="cpu")
    enc, actor, _ = jmodules(cj)
    enc_p, act_p = jax.tree.map(jnp.asarray, (enc_np, act_np))

    @jax.jit
    def logp_j(obs, m_dc, m_g):
        lat = enc.apply(enc_p, obs)
        return actor.apply(act_p, lat, m_dc, m_g)

    return cj, ct, (enc_np, act_np), st, logp_j


def _inputs(rng, B, obs_dim, n_dc, n_g):
    obs = rng.uniform(0, 1, size=(B, obs_dim)).astype(np.float32)
    obs[:, 1::6] = rng.uniform(0.5, 1.2, size=obs[:, 1::6].shape)
    m_dc = rng.random((B, n_dc)) < 0.7
    m_g = rng.random((B, n_g)) < 0.6
    m_dc[np.arange(B), rng.integers(0, n_dc, B)] = True
    m_g[:, 0] = True
    # all but one masked
    m_dc[0] = False
    m_dc[0, n_dc - 1] = True
    m_g[1] = False
    m_g[1, 0] = True
    return obs, m_dc, m_g


def test_weights_carried_exactly(pair):
    cj, ct, (enc_np, _), st, _ = pair
    enc = enc_np["params"]
    for k, layer in enumerate(st.enc.layers):
        assert np.array_equal(layer.kernel.detach().numpy(),
                              enc[f"Dense_{k}"]["kernel"])
        assert np.array_equal(layer.bias.detach().numpy(), enc[f"Dense_{k}"]["bias"])
    assert all(np.all(l.bias.detach().numpy() != 0) for l in st.layers())
    ws = policy_weights(st, "cpu")
    assert len(ws) == 12 and ws[0].dtype == torch.bfloat16
    assert tuple(ws[0].shape) == (256, ct.obs_dim)  # [out, in]


def test_logp_within_stated_tolerance(pair):
    cj, ct, sj, st, logp_j = pair
    rng = np.random.default_rng(ct.obs_dim)
    obs, m_dc, m_g = _inputs(rng, 64, ct.obs_dim, ct.n_dc, ct.n_g)
    lj = [np.asarray(x) for x in logp_j(obs, m_dc, m_g)]
    lt = [x.numpy() for x in policy_logp(st, torch.from_numpy(obs),
                                          torch.from_numpy(m_dc),
                                          torch.from_numpy(m_g))]
    for a, b, m in zip(lj, lt, (m_dc, m_g)):
        assert b.dtype == np.float32
        assert np.max(np.abs(a[m] - b[m])) <= LOGP_ATOL
        assert np.all(b[~m] < -1e8) and np.all(a[~m] < -1e8)
        # a distribution: the feasible probabilities sum to one
        assert np.allclose(np.exp(np.where(m, b, -np.inf)).sum(-1), 1.0,
                           atol=1e-5)
    # the all-but-one-masked rows put all mass on the one action
    assert lt[0][0, ct.n_dc - 1] == 0.0 and lt[1][1, 0] == 0.0


def test_select_action_sampled_and_greedy(pair):
    cj, ct, sj, st, logp_j = pair
    rng = np.random.default_rng(1)
    obs, m_dc, m_g = _inputs(rng, 16, ct.obs_dim, ct.n_dc, ct.n_g)
    apply_s = make_policy_apply(ct)
    apply_g = make_policy_apply(ct, greedy=True)
    assert apply_s.kernel_mode == "sample" and apply_g.kernel_mode == "greedy"
    for i in range(16):
        key = torch.tensor([0, 1000 + i], dtype=torch.int64)
        a = apply_s(st, torch.from_numpy(obs[i]), torch.from_numpy(m_dc[i]),
                    torch.from_numpy(m_g[i]), key)
        assert all(x.dtype == torch.int32 for x in a)
        assert bool(torch.from_numpy(m_dc[i])[a[0]])
        assert bool(torch.from_numpy(m_g[i])[a[1]])
        # the same key gives the same action
        b = select_action(ct, st, torch.from_numpy(obs[i]),
                          torch.from_numpy(m_dc[i]), torch.from_numpy(m_g[i]), key)
        assert [int(x) for x in a] == [int(x) for x in b]
        g = apply_g(st, torch.from_numpy(obs[i]), torch.from_numpy(m_dc[i]),
                    torch.from_numpy(m_g[i]), key)
        lt = policy_logp(st, torch.from_numpy(obs[i:i + 1]),
                         torch.from_numpy(m_dc[i:i + 1]),
                         torch.from_numpy(m_g[i:i + 1]))
        assert int(g[0]) == int(torch.argmax(lt[0][0]))
        assert int(g[1]) == int(torch.argmax(lt[1][0]))


def test_init_is_flax_default_distribution():
    """The port's initialisation: lecun-normal kernels (a normal truncated
    at two standard deviations with variance 1/fan_in) and zero biases, as
    flax's Dense defaults, drawn from a threefry key (the JAX package's
    values to a few ulps: ``tests/test_torch_rl_init.py``)."""
    from distributed_cluster_gpus_tpu_torch.ops import prng

    _, ct = _cfgs(49, 8, 8)
    st = sac_init(ct, prng.key(0, "cpu"), "cpu")
    w = st.enc.layers[1].kernel
    assert tuple(w.shape) == (256, 256)
    assert abs(float(w.std()) - 1 / 16) < 0.004
    assert float(w.abs().max()) <= 2 / 16 / 0.8796 + 1e-6
    assert all(float(l.bias.abs().max()) == 0.0 for l in st.layers())
    st2 = sac_init(ct, prng.key(0, "cpu"), "cpu")
    assert torch.equal(st2.enc.layers[0].kernel, st.enc.layers[0].kernel)


def test_bf16_dense_recipe_is_tree_summed():
    """The recipe's summation order: the halving tree over K padded to a
    power of two, one bf16 rounding before the bias and one after."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, 49, generator=g).to(torch.bfloat16)
    k = torch.randn(49, 7, generator=g).to(torch.bfloat16)
    b = torch.randn(7, generator=g).to(torch.bfloat16)
    y = nets.bf16_dense(x, k, b)
    xp = torch.cat([x.float(), torch.zeros(5, 15)], -1)
    kp = torch.cat([k.float(), torch.zeros(15, 7)], 0)
    prod = xp[:, :, None] * kp  # [5, 64, 7]
    while prod.shape[1] > 1:
        h = prod.shape[1] // 2
        prod = prod[:, :h] + prod[:, h:]
    want = (prod[:, 0].to(torch.bfloat16).float() + b.float()).to(torch.bfloat16)
    assert torch.equal(y, want)


def test_kernel_operand_layout_reproduces_the_recipe(pair):
    """The B4 device code's arithmetic, emulated on the CPU: the wrapper's
    operands (each weight row in bit-reversed order, zero-padded to a power
    of two) summed as adjacent pairs level by level give the plain layer's
    halving-tree sums bit for bit, through the whole forward."""
    from distributed_cluster_gpus_tpu_torch.configs.paper import (build_duo_fleet,
                                                                  build_fleet)
    from distributed_cluster_gpus_tpu_torch.kernels.event_scan import (bitrev_perm,
                                                                       policy_operands)
    from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
    from distributed_cluster_gpus_tpu_torch.sim.step import StepProgram

    cj, ct, sj, st, _ = pair
    fleet = build_duo_fleet() if ct.n_dc == 2 else build_fleet()
    prog = StepProgram(fleet, SimParams(algo="chsac_af",
                                        max_gpus_per_job=ct.n_g), "cpu")
    ops, widths = policy_operands(prog, st, "cpu")
    assert widths == (256, 256, 256, 256)
    rng = np.random.default_rng(9)
    obs, m_dc, m_g = _inputs(rng, 8, ct.obs_dim, ct.n_dc, ct.n_g)

    def layer(x, k, relu):
        w, b = ops[2 * k].float(), ops[2 * k + 1]
        kp = w.shape[1]
        perm = bitrev_perm(kp)
        xs = torch.where(perm < x.shape[-1], x[:, perm.clamp(max=x.shape[-1] - 1)],
                         torch.zeros(()))
        p = xs[:, None, :] * w[None]  # [B, out, kp] in bit-reversed order
        while p.shape[-1] > 1:
            p = p[..., 0::2] + p[..., 1::2]
        y = (p[..., 0].to(torch.bfloat16).float() + b.float()).to(torch.bfloat16)
        y = y.float()
        return torch.where(y > 0, y, torch.zeros(())) if relu else y

    x = torch.from_numpy(obs).to(torch.bfloat16).float()
    for k in range(4):
        x = layer(x, k, True)
    logits = (layer(x, 4, False), layer(x, 5, False))
    want = policy_logp(st, torch.from_numpy(obs), torch.from_numpy(m_dc),
                       torch.from_numpy(m_g))
    got = (nets.masked_log_softmax(logits[0], torch.from_numpy(m_dc)),
           nets.masked_log_softmax(logits[1], torch.from_numpy(m_g)))
    for a, b in zip(want, got):
        assert torch.equal(a, b)
