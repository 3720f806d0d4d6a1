"""The update's two fused input layers (``kernels/dense.py``) on the CPU,
where each wrapper runs its plain composition, against the JAX package's
flax modules at duo-sized shapes, on numpy-seeded inputs and perturbed
weights carried across by ``bridge.sac_from_flax``:

* ``critic_first_fwd``, the one-hot critic's first layer with its input
  rows built inside it (B5e folded into B5d), on every joint action and on
  the taken actions, against ReLU of ``QuantileCritic``'s first ``Dense``
  (each twin's) on its concat: the rows bitwise, the layer within
  ``first_layer_bound`` (XLA's CPU dot sums the bf16 products in another
  order than torch's, so a product may round to the other bf16 neighbour);
* ``actor_heads_fwd``, the actor's two heads and their masked log-softmax
  in one call (B5f's forward folded into the heads' product), against
  ``HybridActor.__call__``'s log-probabilities within ``LOGP_TOL`` (queue
  C's tolerance: a logit's bf16 rounding differs where the two sums do),
  masks with one feasible action and with none included;
* the kernels' plans: the shapes they take and the ones they refuse.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.rl import cmdp as jcmdp
from distributed_cluster_gpus_tpu.rl import sac as jsac
from distributed_cluster_gpus_tpu.rl.nets import HybridActor as JActor
from distributed_cluster_gpus_tpu.rl.nets import QuantileCritic as JQC
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.kernels import dense
from distributed_cluster_gpus_tpu_torch.rl import cmdp as tcmdp
from distributed_cluster_gpus_tpu_torch.rl import nets
from distributed_cluster_gpus_tpu_torch.rl import sac as tsac

BF16 = torch.bfloat16
OBS, B = 13, 6
#: log-probabilities (ROADMAP queue C)
LOGP_TOL = 0.01
BF16_ULP = 2.0 ** -7  # a bf16 ulp relative to the value, at most


def first_layer_bound(p_exact, y):
    """|the port's first layer - the JAX package's| allowed per element:
    each side rounds its float32 sum of the products to bf16 (within an
    ulp of the exact product ``p_exact`` of each other), then rounds the
    bias added to it (an ulp of the output ``y``)."""
    return BF16_ULP * (np.abs(p_exact) + np.abs(y)) + 1e-30


def _perturbed(tree, rng):
    return jax.tree.map(lambda a: (np.asarray(a) + rng.normal(
        0.0, 0.1 if a.ndim == 1 else 0.02, a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module", params=[(2, 4), (3, 5), (8, 8)],
                ids=lambda p: f"{p[0]}x{p[1]}")
def pair(request):
    """(n_dc, n_g, the JAX SACState (numpy leaves, perturbed networks), the
    port's SACState carried from it on the CPU)."""
    n_dc, n_g = request.param
    cons = dict(constraints=jcmdp.default_constraints(500.0))
    cj = jsac.SACConfig(obs_dim=OBS, n_dc=n_dc, n_g=n_g, **cons)
    ct = tsac.SACConfig(obs_dim=OBS, n_dc=n_dc, n_g=n_g,
                        constraints=tcmdp.default_constraints(500.0))
    sj = jax.tree.map(np.asarray, jsac.sac_init(cj, jax.random.key(n_dc * n_g)))
    rng = np.random.default_rng(n_dc + 10 * n_g)
    crit = _perturbed(sj.critic_params, rng)
    sj = sj.replace(actor_params=_perturbed(sj.actor_params, rng),
                    critic_params=crit, target_critic_params=crit)
    return n_dc, n_g, sj, bridge.sac_from_flax(ct, sj, device="cpu")


def _first_dense(critic, params, twin, *args, **kw):
    """(the bf16 rows, the bf16 output) of the JAX critic's first Dense of
    ``twin`` (``Dense_0`` or ``Dense_3``)."""
    seen = {}
    name = f"Dense_{3 * twin}"

    def grab(next_fun, a, k, context):
        out = next_fun(*a, **k)
        if context.method_name == "__call__" and context.module.name == name:
            seen["x"] = np.asarray(a[0].astype(jnp.bfloat16).astype(jnp.float32))
            seen["y"] = np.asarray(out.astype(jnp.float32))
        return out

    with nn.intercept_methods(grab):
        critic.apply(params, *args, **kw)
    return seen["x"], seen["y"]


@pytest.mark.parametrize("rows", ["all_actions", "taken"])
def test_critic_first_layer_matches_flax(pair, rows):
    """Both twins' fused first layer (its plain composition): the rows it
    keeps bitwise the JAX critic's concat and cast, the layer ReLU(x0 W +
    b) within ``first_layer_bound`` of ReLU of flax's bf16 ``Dense``."""
    n_dc, n_g, sj, st = pair
    rng = np.random.default_rng(n_dc * 7 + len(rows))
    lat = np.maximum(rng.normal(size=(B, 256)), 0).astype(np.float32)
    a_dc = rng.integers(0, n_dc, B).astype(np.int32)
    a_g = rng.integers(0, n_g, B).astype(np.int32)
    critic = JQC(n_dc=n_dc, n_g=n_g)
    args, kw = ((lat,), {"method": critic.all_actions}) if rows == "all_actions" \
        else ((lat, a_dc, a_g), {})
    acts = () if rows == "all_actions" else (torch.from_numpy(a_dc),
                                             torch.from_numpy(a_g))
    w = nets.casts(st.critic)
    for twin in (0, 1):
        x_j, y_j = _first_dense(critic, sj.critic_params, twin, *args, **kw)
        kernel, bias = w[3 * twin]
        y, x0 = dense.critic_first_fwd(torch.from_numpy(lat), n_dc, n_g, kernel,
                                       bias, *acts, keep_rows=True)
        assert x0.dtype == BF16 and np.array_equal(x0.float().numpy(), x_j)
        want = np.maximum(y_j, 0)
        got = y.float().numpy()
        p_exact = x_j.astype(np.float64) @ kernel.float().numpy().astype(np.float64)
        assert np.all(np.abs(got - want) <= first_layer_bound(p_exact, want))
        assert np.mean(got != want) < 0.01  # most elements bitwise
    assert dense.critic_first_fwd.launches == 0  # the plain composition


def test_critic_first_layer_is_critic_input_then_dense(pair):
    """The plain composition is B5e's rows followed by B5d's plain forward
    with the ReLU, bitwise, and returns no rows unless asked."""
    n_dc, n_g, _, st = pair
    rng = np.random.default_rng(3)
    lat = torch.from_numpy(rng.normal(size=(B, 256)).astype(np.float32))
    kernel, bias = nets.casts(st.critic)[0]
    y, x0 = dense.critic_first_fwd(lat, n_dc, n_g, kernel, bias)
    assert x0 is None
    want = nets.dense_fwd_plain(nets.critic_input(lat, n_dc, n_g), kernel,
                                bias, True)
    assert torch.equal(y.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("masks", ["random", "one_feasible", "none_feasible"])
def test_actor_heads_match_flax(pair, masks):
    """The fused heads' plain composition against the JAX actor's
    log-probabilities within ``LOGP_TOL``; its logits are the bf16 heads'
    outputs widened to float32, the values B5f's backward reads."""
    n_dc, n_g, sj, st = pair
    rng = np.random.default_rng(n_dc * n_g + len(masks))
    lat = np.maximum(rng.normal(size=(B, 256)), 0).astype(np.float32)
    m_dc, m_g = rng.random((B, n_dc)) < 0.6, rng.random((B, n_g)) < 0.6
    m_dc[:, 0] = m_g[:, -1] = True
    if masks == "one_feasible":
        m_dc[:] = False
        m_dc[:, n_dc - 1] = True
    elif masks == "none_feasible":
        m_g[::2] = False
    lp_dc_j, lp_g_j = JActor(n_dc=n_dc, n_g=n_g).apply(sj.actor_params, lat,
                                                        m_dc, m_g)
    (k_h, b_h), (k_dc, b_dc), (k_g, b_g) = nets.casts(st.actor)
    hid = nets.dense_fwd_plain(torch.from_numpy(lat).to(BF16), k_h, b_h, True)
    md, mg = torch.from_numpy(m_dc), torch.from_numpy(m_g)
    lp_dc, lp_g, l_dc, l_g = dense.actor_heads_fwd(hid, k_dc, b_dc, k_g, b_g,
                                                   md, mg)
    for want, got in ((lp_dc_j, lp_dc), (lp_g_j, lp_g)):
        assert np.abs(np.asarray(want) - got.numpy()).max() <= LOGP_TOL
    for logits, kernel, bias in ((l_dc, k_dc, b_dc), (l_g, k_g, b_g)):
        assert torch.equal(logits, nets.dense_fwd_plain(hid, kernel, bias,
                                                        False).float())
    assert torch.equal(lp_dc, nets.masked_log_softmax(l_dc, md))
    assert dense.actor_heads_fwd.launches == 0  # the plain composition


# ----------------------------------------------------------------- plans

@pytest.mark.parametrize("R,L,n_dc,n_g,taken,w_tma,plan", [
    (16_384, 256, 8, 8, False, True, (128, 128, dense.CRITIC_STAGES)),
    (256, 256, 8, 8, True, True, (64, 64, 5)),      # the taken actions
    (1024, 256, 2, 8, False, True, (64, 64, 5)),    # 64 rows x 16 actions
    (16_384, 256, 8, 8, False, False, (128, 128, 5)),  # W by threads: all K
])
def test_critic_first_plan(R, L, n_dc, n_g, taken, w_tma, plan):
    assert dense.critic_plan(R, L, n_dc, n_g, 256, taken, w_tma) == plan
    bm, bn, stages = plan
    aux = dense.critic_aux(bm, L, n_dc * n_g, taken)
    assert 1024 + stages * ((bm + bn) * 128 + 8) + aux + 16 + 2 * bn \
        <= dense.SMEM_MAX


def test_critic_staging_covers_a_tiles_latents():
    """A tile of bm rows of every joint action spans at most (bm - 1) // A
    + 2 latent rows: the staging holds them (and bm actions, a barrier)."""
    for A in (1, 8, 15, 64, 200):
        for m0 in range(0, 4096, 64):
            rows = (m0 + 127) // A - m0 // A + 1
            assert rows <= min(128, 127 // A + 2)
    # 3 latent rows in float32 and bf16 (rows kept), 128 actions' slots,
    # four barriers, in 128-byte units; else 2 warpgroups' 4 latent atoms;
    # the taken actions: 64 rows in float32
    assert dense.critic_aux(128, 256, 64, False, keep_rows=True) == 5760
    assert dense.critic_aux(128, 256, 64, False) == 8 * 1024 + 1024 + 128
    assert dense.critic_aux(64, 256, 1, True) == 66176


@pytest.mark.parametrize("R,K,plan", [(256, 256, (64, 64, 4)),
                                      (64, 256, (64, 64, 4)),
                                      (16_384, 256, (64, 64, 4))])
def test_heads_plan(R, K, plan):
    """The published heads (8 + 8 columns): one 64 x 64 tile, the whole K
    in the ring, at every row count (the update's batch is at most 4,096)."""
    assert dense.heads_plan(R, K, 16) == plan


def test_fused_plans_refuse_what_the_kernels_do_not_take():
    """No rows; more than 256 heads' columns; a K the ring cannot hold.
    Any row count is taken (the last tile partial)."""
    with pytest.raises(ValueError, match="rows"):
        dense.heads_plan(0, 256, 16)
    with pytest.raises(ValueError, match="rows"):
        dense.critic_plan(0, 256, 2, 4, 256, False)
    with pytest.raises(ValueError, match="256"):
        dense.heads_plan(256, 256, 257)
    with pytest.raises(ValueError, match="ring"):
        dense.heads_plan(256, 4096, 16)
    assert dense.heads_plan(100, 256, 72) == (64, 128, 4)
    assert dense.critic_plan(6 * 8, 256, 2, 4, 256, False)[0] == 64
