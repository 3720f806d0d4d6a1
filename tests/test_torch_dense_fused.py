"""B5d's fused Dense kernels (``kernels/dense.py``): the Python the card's
path shares with the CPU, on the CPU.

* the tile plan per update shape (:func:`fwd_plan`, :func:`dx_plan`,
  :func:`heads_plan`): the tiles, the ring's stages, any row count (a
  backward up to 4,096), one tile of up to 256 heads' columns, and the
  refusal of an empty or larger shape, of an operand TMA cannot load whose
  K overflows the ring (shape logic alone: no card);
* which backward calls fuse into a dX product: one whole update at small
  widths, both critics, counts each wrapper's calls (30 forward layers, of
  them the one-hot critic's 6 first layers and the actor's 2 pairs of
  heads fused calls; 8 fused, 4 standalone backward calls, as
  ``chip_smoke.py::per_update`` expects on the card);
* the plain composition of ``dense_dx`` (products, rounding, mask, tree)
  and the new layer-by-layer backward, bitwise against the sequence the
  update ran before the fusion (B5d backward, then dW, then dX by
  ``torch.matmul``), at small widths and on a 256-row layer.
"""

import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu_torch.kernels import dense
from distributed_cluster_gpus_tpu_torch.rl import cmdp as tcmdp
from distributed_cluster_gpus_tpu_torch.rl import nets
from distributed_cluster_gpus_tpu_torch.rl import replay as treplay
from distributed_cluster_gpus_tpu_torch.rl import sac as tsac

BF16 = torch.bfloat16


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).to(BF16)


def _bits(a, b):
    v = {torch.float32: torch.int32, BF16: torch.int16}[a.dtype]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(v), b.contiguous().view(v))


# ------------------------------------------------------------ the tile plan

@pytest.mark.parametrize("R,K,N,plan", [
    (256, 49, 256, (64, 64, 1)),        # the encoder's first layer
    (256, 256, 256, (64, 64, 4)),       # a hidden layer
    (256, 256, 8, (64, 64, 4)),         # an actor head (a 64-wide tile)
    (256, 272, 256, (64, 64, 5)),       # the critic's taken-action rows
    (256, 256, 2048, (64, 64, 4)),      # the heads critic's output
    (16_384, 272, 256, (128, 128, 3)),  # all actions: 5 k-tiles, a ring of 3
    (16_384, 256, 256, (128, 128, 3)),
    (16_384, 256, 32, (128, 64, 3)),
])
def test_fwd_plan_per_update_shape(R, K, N, plan):
    assert dense.fwd_plan(R, K, N) == plan
    bm, bn, stages = plan
    assert 1024 + stages * ((bm + bn) * 128 + 8) + 16 + 2 * bn <= dense.SMEM_MAX


def test_fwd_plan_threads_load_what_tma_cannot():
    """An operand TMA cannot describe is loaded whole before the loop: its
    K must fit the ring."""
    assert dense.fwd_plan(256, 49, 256, x_tma=False) == (64, 64, 1)
    assert dense.fwd_plan(64, 266, 256, x_tma=False) == (64, 64, 5)
    assert dense.fwd_plan(16_384, 272, 256, x_tma=False) == (128, 128, 5)
    with pytest.raises(ValueError, match="ring"):
        dense.fwd_plan(16_384, 2048, 256, x_tma=False)


@pytest.mark.parametrize("kcs,stages", [((256,), 4), ((32,), 1), ((8, 8), 2),
                                        ((2048,), 6)])
def test_dx_plan_per_update_shape(kcs, stages):
    assert dense.dx_plan(256, kcs, [True] * len(kcs)) == stages
    tree = dense.DX_ROWS * (dense.DX_BN + 1) * 4
    assert 1024 + tree + stages * ((dense.DX_ROWS + dense.DX_BN) * 128 + 8) \
        <= dense.SMEM_MAX
    if sum(-(-k // 64) for k in kcs) > stages:
        with pytest.raises(ValueError, match="ring"):
            dense.dx_plan(256, kcs, [False] * len(kcs))


@pytest.mark.parametrize("R", [1, 32, 100, 257, 512, 4096, 16_383])
def test_plans_take_any_row_count(R):
    """Any R >= 1: the forward's last row tile is partial; the backward
    kernels tile their rows by 256, up to 4,096 (the bias gradient's tree
    over the tiles finished by the last block of a column group)."""
    assert dense.fwd_plan(R, 256, 256)[0] == (128 if R >= dense.BIG_ROWS else 64)
    assert dense.critic_plan(R, 256, 8, 8, 256, taken=R < 1024)
    assert dense.heads_plan(R, 256, 16) == (64, 64, 4)
    if R <= dense.MAX_ROWS:
        assert dense.dx_plan(R, (256,)) == 4
        assert dense.dx_plan(R, (8, 8), (False, False)) == 2


def test_rows_outside_the_envelope_are_refused():
    """No rows, or a backward over more than 4,096 (16 tiles of 256)."""
    for plan in (lambda R: dense.fwd_plan(R, 256, 256),
                 lambda R: dense.dx_plan(R, (256,)),
                 lambda R: dense.heads_plan(R, 256, 16)):
        with pytest.raises(ValueError, match="rows"):
            plan(0)
    with pytest.raises(ValueError, match="up to 4096"):
        dense.dx_plan(4097, (256,))
    with pytest.raises(ValueError, match="up to 4096"):
        dense._check_rows("dense_backward", 4097, dense.MAX_ROWS)


@pytest.mark.parametrize("n,bn", [(2, 64), (16, 64), (64, 64), (65, 128),
                                  (72, 128), (136, 192), (200, 256),
                                  (256, 256)])
def test_heads_plan_takes_one_tile_of_the_heads(n, bn):
    """Both heads side by side in one tile of n rounded up to 64 columns
    (one wgmma up to 256 wide), the whole K = 256 in the ring, within a
    block's shared memory; more than 256 columns are refused."""
    bm, got, stages = dense.heads_plan(256, 256, n)
    assert (bm, got, stages) == (64, bn, 4)
    ring = max(stages * (bm + bn) * 128, bm * (bn + 8) * 2)
    assert 1024 + ring + 8 * stages + 16 + 2 * bn <= dense.SMEM_MAX
    with pytest.raises(ValueError, match="256"):
        dense.heads_plan(256, 256, 257)


@pytest.mark.parametrize("B,n_dc,n_g", [(256, 8, 8), (512, 8, 64),
                                        (1024, 8, 128), (100, 3, 65),
                                        (4096, 8, 128), (1, 1, 1)])
def test_every_update_shape_of_the_envelope_has_a_plan(B, n_dc, n_g):
    """Every kernel call of an update at the widened envelope's edges (the
    paper fleet at --max-gpus-per-job 64 and 128, batches 1 to 4,096, heads
    of 72 and 136 columns, A = 1,024) fits its kernel's plan, with both
    critics."""
    from distributed_cluster_gpus_tpu_torch.kernels import envelope

    for arch in ("onehot", "heads"):
        assert envelope.update_refusals(B, n_dc, n_g, 1 + 6 * n_dc,
                                        critic_arch=arch) == []


# ------------------------------------------------- which backward calls fuse

def _small_update(arch):
    cfg = tsac.SACConfig(obs_dim=13, n_dc=2, n_g=4, n_quantiles=8, latent=32,
                         batch=16, critic_arch=arch,
                         constraints=tcmdp.default_constraints(500.0))
    sac = tsac.sac_init(cfg, torch.tensor([0, 3], dtype=torch.int64), "cpu")
    g = torch.Generator().manual_seed(2)
    n = 64
    rb = treplay.replay_init(128, cfg.obs_dim, cfg.n_dc, cfg.n_g, 4, device="cpu")
    treplay.replay_add_chunk(rb, {
        "valid": torch.ones(n, dtype=torch.bool),
        "s0": torch.randn((n, cfg.obs_dim), generator=g),
        "s1": torch.randn((n, cfg.obs_dim), generator=g),
        "a_dc": torch.randint(0, cfg.n_dc, (n,), generator=g, dtype=torch.int32),
        "a_g": torch.randint(0, cfg.n_g, (n,), generator=g, dtype=torch.int32),
        "r": torch.randn(n, generator=g), "costs": torch.randn((n, 4), generator=g).abs(),
        "done": torch.zeros(n),
        "mask_dc": torch.ones((n, cfg.n_dc), dtype=torch.bool),
        "mask_g": torch.ones((n, cfg.n_g), dtype=torch.bool),
        "mask_dc0": torch.ones((n, cfg.n_dc), dtype=torch.bool),
        "mask_g0": torch.ones((n, cfg.n_g), dtype=torch.bool)})
    return cfg, sac, rb


@pytest.mark.parametrize("arch", ["onehot", "heads"])
def test_update_fuses_eight_of_twelve_backward_calls(arch, monkeypatch):
    """One update's B5d calls: 30 forward layers (the one-hot critic's six
    first layers each one ``critic_first_fwd`` with its input rows, the
    actor's two heads one ``actor_heads_fwd`` per actor forward, the rest
    ``dense_fwd``), 8 hidden-layer gradients inside a dX product (each
    critic twin's two lower layers, the actor's hidden layer with both
    heads' products in one call, the encoder's three layers, the top one
    fed by the actor), 2 standalone top layers (the twins', from a float32
    gradient) and the actor's heads in the fused heads' backward, one call
    for both with their log-softmax's gradient."""
    from distributed_cluster_gpus_tpu_torch.kernels import log_softmax

    cfg, sac, rb = _small_update(arch)
    seen = {"dense_fwd": [], "critic_first_fwd": [], "actor_heads_fwd": [],
            "dense_dx": [], "dense_backward": [], "heads_backward": []}
    for name in seen:
        mod = log_softmax if name == "heads_backward" else dense
        orig = getattr(mod, name)

        def rec(*a, _name=name, _orig=orig, **kw):
            seen[_name].append(a)
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, name, rec)
    tsac.sac_train_step(cfg, sac, rb, torch.tensor([0, 9], dtype=torch.int64))
    first = 6 if arch == "onehot" else 0
    assert {k: len(v) for k, v in seen.items()} == {
        "dense_fwd": 26 - first, "critic_first_fwd": first,
        "actor_heads_fwd": 2, "dense_dx": 8, "dense_backward": 2,
        "heads_backward": 1}
    assert sum(len(a) == 6 for a in seen["dense_dx"]) == 1  # the actor's pair
    assert all(a[0].dtype == torch.float32 for a in seen["dense_backward"])
    assert all(a[0].dtype == BF16 for a in seen["dense_dx"])


# ------------------------------------- the plain composition, bitwise as before

def _old_grads(x, y, g, kernel, dkernel, dbias, g2=None, dx=True):
    """The update's layer gradient before the fusion: B5d's backward, then
    dW = x^T G and dX = G W^T by ``torch.matmul``."""
    G = nets.dense_backward(g, y, dbias, g2)
    torch.matmul(x.t(), G, out=dkernel)
    return torch.matmul(G, kernel.t()) if dx else None


@pytest.mark.parametrize("R,N,kcs", [(256, 256, (256,)), (8, 24, (32,)),
                                     (33, 24, (5, 3)), (256, 256, (8, 8))])
def test_dense_dx_plain_is_the_old_sequence(R, N, kcs):
    """``dense_dx`` on CPU tensors (its plain version): the products
    rounded to bf16, their float32 sum, the mask and the tree, bitwise the
    B5d backward of the layer below a ``torch.matmul`` dX."""
    rng = np.random.default_rng(R + N)
    ops = [t for kc in kcs for t in (_bf16(rng, R, kc), _bf16(rng, N, kc, scale=0.3))]
    y = _bf16(rng, R, N)
    for mask in (y, None):
        db_new, db_old = torch.empty(N, dtype=BF16), torch.empty(N, dtype=BF16)
        G = dense.dense_dx(ops[0], ops[1], mask, db_new, *ops[2:])
        ds = [torch.matmul(a, w.t()) for a, w in zip(ops[::2], ops[1::2])]
        G_old = nets.dense_backward(ds[0], mask, db_old, *ds[1:])
        assert _bits(G, G_old) and _bits(db_new, db_old)


@pytest.mark.parametrize("R", [8, 256])
def test_mlp_backward_is_the_old_sequence(R):
    """The encoder's gradient layer by layer (dX formed inside the layer
    below's backward) equals the old order, every kernel and bias gradient
    bitwise, from a float32 gradient and from the actor's (G, kernel)."""
    rng = np.random.default_rng(R)
    enc = nets.MLPStateEncoder(13, latent=16, hidden=(24, 32))
    for layer in enc.layers:
        with torch.no_grad():
            layer.kernel.copy_(torch.from_numpy(rng.normal(
                size=layer.kernel.shape).astype(np.float32)) * 0.4)
            layer.bias.copy_(torch.from_numpy(rng.normal(
                size=layer.bias.shape).astype(np.float32)) * 0.1)
    w = nets.casts(enc)
    obs = torch.from_numpy(rng.normal(size=(R, 13)).astype(np.float32))
    _, acts = enc.train_forward(obs, w)
    G_a = _bf16(rng, R, 40)
    k_a = _bf16(rng, 16, 40, scale=0.2)
    for g in (torch.from_numpy(rng.normal(size=(R, 16)).astype(np.float32)),
              (G_a, k_a)):
        dw_new = [(torch.empty_like(k), torch.empty_like(b)) for k, b in w]
        dw_old = [(torch.empty_like(k), torch.empty_like(b)) for k, b in w]
        enc.train_backward(acts, g, w, dw_new)
        up = g if isinstance(g, torch.Tensor) else torch.matmul(G_a, k_a.t())
        for i in reversed(range(3)):
            up = _old_grads(acts[i], acts[i + 1], up, w[i][0], *dw_old[i],
                            dx=i > 0)
        for (kn, bn), (ko, bo) in zip(dw_new, dw_old):
            assert _bits(kn, ko) and _bits(bn, bo)


def test_dense_fwd_plain_is_matmul_and_epilogue():
    """``dense_fwd`` on CPU tensors: ``torch.matmul`` then B5d's epilogue,
    the float32 copy into a strided slot included."""
    rng = np.random.default_rng(5)
    x, w, b = _bf16(rng, 64, 24), _bf16(rng, 24, 8), _bf16(rng, 8)
    out = torch.full((64, 2, 8), 7.0)
    y = dense.dense_fwd(x, w, b, True, out[:, 1])
    want = nets.dense_epilogue(torch.matmul(x, w), b, True)
    assert _bits(y, want) and _bits(out[:, 1], want.float())
    assert bool((out[:, 0] == 7.0).all())
