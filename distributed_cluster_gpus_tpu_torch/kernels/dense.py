"""B5d: each bf16 Dense layer of the SAC update as one hand-written Hopper
kernel with its epilogue fused, forward and backward, and their wrappers.

Replace what XLA fuses around flax's bf16 ``Dense`` in the JAX package's
``sac_train_step`` (``distributed_cluster_gpus_tpu/rl/sac.py:206-310``; the
layers at ``rl/nets.py:37-39, 58-61, 93-95, 149-150``):

* :func:`dense_fwd`, a forward layer: the bf16 product (wgmma, float32
  accumulation, rounded once), the bias, the ReLU and the float32 copy of a
  network's last layer, in one launch (``dense_fwd_gemm``);
* :func:`dense_dx`, a hidden layer's gradient: the product of the layer
  above's gradient with its kernel (dX), rounded, summed with a second such
  product where given (the actor's two heads), masked by the layer's ReLU,
  and the bias gradient by the halving tree over the rows, in one launch
  (``dense_dx_gemm``);
* :func:`dense_backward`, a network's top layer: the cast (and mask) of a
  float32 incoming gradient and its bias gradient (``dense_bwd_kernel``);
* :func:`critic_first_fwd`, the one-hot critic's first layer with its input
  rows (B5e: the concat and cast at ``rl/nets.py:85-87`` and the
  ``all_actions`` tiling at ``:98-112``) built inside the product from the
  latents and the actions (``critic_first_gemm``);
* :func:`actor_heads_fwd`, the actor's two heads and their masked
  log-softmax (B5f's forward, ``rl/nets.py:58-66``) in one launch
  (``actor_heads_gemm``).

``csrc/dense.cu``'s head note gives the design and bound; :func:`fwd_plan`,
:func:`heads_plan` and :func:`dx_plan` choose the tiles and the ring of
stages per shape.  The forward takes any R >= 1 rows (the last tile
partial); the backward kernels take 1 <= R <= ``MAX_ROWS``, a block a
256-row tile, whose bias gradient's tree over more than one tile the last
block of each column group finishes (counting on ``build.counters``);
the heads take up to ``HEADS_MAX`` columns together.

Each wrapper launches its kernel for tensors on the card (built on first
use) or raises, and runs its plain version (``rl/nets.py``: ``torch.matmul``
and the epilogue ops) for tensors on the CPU or with ``plain=True``; there
is no fallback.  Each counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

BF16, F32 = torch.bfloat16, torch.float32
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: a block's shared memory on the H100 (bytes); the ring's stages, their
#: mbarriers, the alignment slack and the forward tile's bias must fit it
#: (csrc/dense.cu ``fwd_smem``/``dx_smem``)
SMEM_MAX = 232_448
TILE = 64  # a k-tile's depth: one 128-byte swizzled row of bf16
#: forward: from this many rows on, 128-row tiles and a ring of at most
#: BIG_STAGES k-tiles
BIG_ROWS, BIG_STAGES = 8192, 3
#: the one-hot critic's first layer at BIG_ROWS rows and more: a ring of
#: at most this many k-tiles, whose rows the block builds as it cycles
CRITIC_STAGES = 2
#: the actor's heads side by side in one tile of 64, 128, 192 or 256
#: columns: n_dc + n_g at most this
HEADS_MAX = 256
#: the backward kernels: a block's row tile (dX: and its columns), and the
#: rows they take (16 tiles)
DX_ROWS, DX_BN = 256, 16
MAX_ROWS = 4096


def _check_rows(op, R, most=None):
    """Raise unless 1 <= R (<= ``most``)."""
    if R < 1 or (most is not None and R > most):
        bound = "" if most is None else f" up to {most}"
        raise ValueError(f"{op}: {R} rows; the kernel takes 1{bound}")


def _k_tiles(k):
    return -(-k // TILE)


def fwd_plan(R, K, N, x_tma=True, w_tma=True):
    """(bm, bn, stages) of :func:`dense_fwd` for x [R, K] times W [K, N]:
    from ``BIG_ROWS`` rows on, 128-row tiles (two warpgroups) 128 wide
    (64 for N < 256) with a ring of at most ``BIG_STAGES``, so that two
    blocks share an SM and one's epilogue overlaps the other's loads (the
    fastest of the tiles and rings timed at the one-hot critic's 16,384-row
    layers on the H100, PERF.md §6); below, 64 x 64 tiles with the whole K
    in flight (the 256-row layers want blocks, not reuse).  An operand that
    TMA cannot describe (``x_tma``/``w_tma`` False) is loaded by the
    block's threads, and then the whole K must fit the ring.  Raises for a
    shape the kernel does not take."""
    _check_rows("dense_fwd", R)
    if K < 1 or N < 1:
        raise ValueError(f"dense_fwd: empty product {R} x {K} x {N}")
    big = R >= BIG_ROWS
    bm = 128 if big else 64
    bn = 128 if big and N >= 256 else 64
    kt = _k_tiles(K)
    stages = min(kt, (SMEM_MAX - 1024 - 16 - 2 * bn) // ((bm + bn) * 128 + 8))
    if big and (x_tma and w_tma):
        stages = min(stages, BIG_STAGES)
    if not (x_tma and w_tma) and kt > stages:
        raise ValueError(f"dense_fwd: K = {K} with an operand TMA cannot "
                         f"load needs {kt} stages, the ring holds {stages}")
    return bm, bn, stages


def critic_aux(bm, L, A, taken, keep_rows=False):
    """Bytes a block of :func:`critic_first_fwd` stages behind its ring
    (csrc/dense.cu ``critic_aux``): the latent rows its ``bm`` rows use
    (every joint action: at most (bm - 1) // A + 2, as float32 and rounded
    to bf16, or, with A and L multiples of 64 and no rows kept, each
    warpgroup's latent k-tiles as 1,024-byte atoms; the taken actions: bm,
    float32 in 64-column boxes), its taken actions and the latents' four
    mbarriers."""
    def up(n, k):
        return -(-n // k) * k
    if not taken and not keep_rows and A % 64 == 0 and L % 64 == 0 and L <= 256:
        lat = bm // 64 * (L // 64) * 1024
    elif taken:
        lat = up(L, 64) * bm * 4
    else:
        rows = min(bm, (bm - 1) // A + 2)
        lat = up(rows * L * 4, 16) + up(rows * L * 2, 16)
    return up(up(lat, 16) + 8 * bm + 32, 128)


def critic_plan(R, L, n_dc, n_g, N, taken, w_tma=True, keep_rows=False):
    """(bm, bn, stages) of :func:`critic_first_fwd` for R rows of the
    critic (``taken``: the taken actions', else every joint action's) and
    its first layer's kernel [L + n_dc + n_g, N]: the tiles of
    :func:`fwd_plan`; from ``BIG_ROWS`` rows on a ring of at most
    ``CRITIC_STAGES`` whose rows are built as it cycles (the fastest of the
    tiles and rings timed on the H100, PERF.md §6), below the whole K in
    flight.  A kernel TMA cannot load needs the whole K in the ring.
    Raises for a shape the kernel does not take."""
    _check_rows("critic_first_fwd", R)
    big = R >= BIG_ROWS
    bm = 128 if big else 64
    bn = 128 if big and N >= 256 else 64
    kt = _k_tiles(L + n_dc + n_g)
    aux = critic_aux(bm, L, n_dc * n_g, taken, keep_rows)
    stages = min(kt, (SMEM_MAX - 1024 - 16 - 2 * bn - aux)
                 // ((bm + bn) * 128 + 8))
    if big and w_tma:
        stages = min(stages, CRITIC_STAGES)
    if stages < 1 or (not w_tma and kt > stages):
        raise ValueError(f"critic_first_fwd: K = {L + n_dc + n_g} beside "
                         f"{aux} bytes of latents does not fit the ring")
    return bm, bn, stages


def heads_plan(R, K, n):
    """(bm, bn, stages) of :func:`actor_heads_fwd` for x [R, K] and n = n_dc
    + n_g columns: 64-row tiles, one tile of bn = n rounded up to 64 (64,
    128, 192 or 256: one wgmma holds whole rows), the whole K in the ring
    (the heads' kernels are loaded by the block's threads), at least the
    epilogue's tile; raises for a shape it does not take."""
    _check_rows("actor_heads_fwd", R)
    if not 1 <= n <= HEADS_MAX:
        raise ValueError(f"actor_heads_fwd: heads of {n} entries together; "
                         f"the kernel takes 1 to {HEADS_MAX}")
    bm, bn, kt = 64, -(-n // 64) * 64, _k_tiles(K)
    ring = max(kt * (bm + bn) * 128, bm * (bn + 8) * 2)
    if K < 1 or 1024 + ring + kt * 8 + 16 + 2 * bn > SMEM_MAX:
        raise ValueError(f"actor_heads_fwd: K = {K} does not fit the ring")
    return bm, bn, kt


def dx_plan(R, kcs, tma=(True,)):
    """The ring's stages of :func:`dense_dx` for R rows and products of
    depths ``kcs`` (one or two), ``tma`` whether TMA loads every operand of
    each; raises for a shape the kernel does not take."""
    _check_rows("dense_dx", R, MAX_ROWS)
    if not 1 <= len(kcs) <= 2 or min(kcs) < 1:
        raise ValueError(f"dense_dx: products of depths {kcs}")
    kt = sum(_k_tiles(k) for k in kcs)
    tree = DX_ROWS * (DX_BN + 1) * 4
    stages = min(kt, (SMEM_MAX - 1024 - tree) // ((DX_ROWS + DX_BN) * 128 + 8))
    if not all(tma) and kt > stages:
        raise ValueError(f"dense_dx: depths {kcs} with an operand TMA cannot "
                         f"load need {kt} stages, the ring holds {stages}")
    return stages


def tma_ok(t) -> bool:
    """Whether TMA can describe the bf16 matrix ``t`` (rows 16-byte
    aligned): else the kernel's threads load it."""
    return t.data_ptr() % 16 == 0 and (t.stride(0) * 2) % 16 == 0


def _rows(op, name, t, dtype, dev, R, N):
    """The row stride of ``t``, a [R, N] ``dtype`` tensor on ``dev`` with a
    unit column stride."""
    if t.dtype != dtype or t.device != dev or tuple(t.shape) != (R, N) \
            or (N > 1 and t.stride(1) != 1):
        raise ValueError(f"{op}: {name} must be {dtype} [{R}, {N}] on {dev} "
                         "with unit column stride")
    return t.stride(0) if R > 1 else N


def dense_fwd(x, kernel, bias, relu: bool, out32=None, plain: bool = False):
    """B5d forward: the bf16 output [R, N] of ``x`` (bf16 [R, K], unit
    column stride) times ``kernel`` (bf16 [K, N]) with float32 accumulation,
    rounded once, the bf16 ``bias`` [N] added (in float32, rounded to bf16),
    the ReLU where ``relu``, and, where ``out32`` (float32 [R, N], any row
    stride) is given, its float32 copy."""
    if plain or not build.on_card("dense_fwd", x):
        from ..rl.nets import dense_fwd_plain
        return dense_fwd_plain(x, kernel, bias, relu, out32)
    op, dev = "dense_fwd", x.device
    R, K = x.shape
    N = kernel.shape[-1]
    ldx = _rows(op, "x", x, BF16, dev, R, K)
    build.check(op, "kernel", kernel, BF16, dev, (K, N))
    build.check(op, "bias", bias, BF16, dev, (N,))
    ld32 = 0 if out32 is None else _rows(op, "out32", out32, F32, dev, R, N)
    bm, bn, stages = fwd_plan(R, K, N, tma_ok(x), tma_ok(kernel))
    y = torch.empty((R, N), dtype=BF16, device=dev)
    fn = build.bind("dense", "dense_fwd_launch",
                    [P, LL, P, P, P, P, LL, I, I, I, I, I, I, I, P])
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), ldx, kernel.data_ptr(), bias.data_ptr(),
                y.data_ptr(), None if out32 is None else out32.data_ptr(),
                ld32, R, K, N, int(relu), bm, bn, stages, build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    dense_fwd.launches += 1
    return y


dense_fwd.launches = 0


def dense_dx(g, w, y, db, g2=None, w2=None, plain: bool = False):
    """B5d backward fused into the dX product: a hidden layer's bf16
    gradient G [R, N] from the layer above's gradient ``g`` (bf16 [R, K'],
    unit column stride) and kernel ``w`` (bf16 [N, K']): G = bf16(g w^T), or,
    with a second pair ``g2``, ``w2``, the two products each rounded to bf16
    and summed in float32; zero where the layer's output ``y`` (bf16 [R, N])
    is not positive (``y`` None: no mask); ``db`` (bf16 [N]) written with
    the halving tree of G's rows.  Returns G."""
    if plain or not build.on_card("dense_dx", g):
        from ..rl.nets import dense_dx_plain
        return dense_dx_plain(g, w, y, db, g2, w2)
    op, dev = "dense_dx", g.device
    R, kc = g.shape
    N = w.shape[0]
    ldg = _rows(op, "g", g, BF16, dev, R, kc)
    build.check(op, "w", w, BF16, dev, (N, kc))
    pairs, tma = [(g, w, ldg, kc)], [tma_ok(g) and tma_ok(w)]
    if (g2 is None) != (w2 is None):
        raise ValueError(f"{op}: a second gradient needs its kernel")
    if g2 is not None:
        kc2 = g2.shape[-1]
        ldg2 = _rows(op, "g2", g2, BF16, dev, R, kc2)
        build.check(op, "w2", w2, BF16, dev, (N, kc2))
        pairs.append((g2, w2, ldg2, kc2))
        tma.append(tma_ok(g2) and tma_ok(w2))
    if y is not None:
        build.check(op, "y", y, BF16, dev, (R, N))
    build.check(op, "db", db, BF16, dev, (N,))
    stages = dx_plan(R, [p[3] for p in pairs], tma)
    G = torch.empty((R, N), dtype=BF16, device=dev)
    # (g, ldg, w, ldw, K') of each product, zeros for a missing second one
    args = [v for a, b, lda, ka in pairs
            for v in (a.data_ptr(), lda, b.data_ptr(), b.stride(0), ka)]
    args += [None, 0, None, 0, 0] * (2 - len(pairs))
    fn = build.bind("dense", "dense_dx_launch",
                    [P, LL, P, LL, I, P, LL, P, LL, I, P, P, P, P, I, I, I, P])
    with torch.cuda.device(dev):
        rc = fn(*args, None if y is None else y.data_ptr(), G.data_ptr(),
                db.data_ptr(), build.counters(dev).data_ptr(), R, N, stages,
                build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    dense_dx.launches += 1
    return G


dense_dx.launches = 0


def dense_backward(g, y, db, g2=None, plain: bool = False):
    """B5d backward of a network's top layer: its bf16 gradient G [R, N]
    from the incoming ``g`` (bf16 [R, N], or float32 [R, N] with any row
    stride) plus, where given, a second bf16 ``g2``, masked by the layer's
    bf16 output ``y > 0`` where ``y`` is given (a ReLU layer); writes the
    bias gradient into ``db`` (bf16 [N]), the column sums of G by the
    halving tree over the rows.  Returns G."""
    if plain or not build.on_card("dense_backward", g):
        from ..rl.nets import dense_backward as plain_fn
        return plain_fn(g, y, db, g2)
    op, dev = "dense_backward", g.device
    R, N = g.shape
    _check_rows(op, R, MAX_ROWS)
    g_f32 = g.dtype == F32
    ldg = _rows(op, "g", g, F32 if g_f32 else BF16, dev, R, N)
    for name, t in (("g2", g2), ("y", y)):
        if t is not None:
            build.check(op, name, t, BF16, dev, (R, N))
    if g_f32 and g2 is not None:
        raise ValueError(f"{op}: a second gradient only beside a bf16 one")
    build.check(op, "db", db, BF16, dev, (N,))
    G = torch.empty((R, N), dtype=BF16, device=dev)
    fn = build.bind("dense", "dense_bwd_launch",
                    [P, I, LL, P, P, P, P, P, I, I, P])
    with torch.cuda.device(dev):
        rc = fn(g.data_ptr(), int(g_f32), ldg,
                None if g2 is None else g2.data_ptr(),
                None if y is None else y.data_ptr(), G.data_ptr(),
                db.data_ptr(), build.counters(dev).data_ptr(), R, N,
                build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    dense_backward.launches += 1
    return G


dense_backward.launches = 0


def critic_first_fwd(lat, n_dc: int, n_g: int, kernel, bias, a_dc=None,
                     a_g=None, keep_rows: bool = False, plain: bool = False):
    """The one-hot critic's first layer, ReLU(x0 kernel + bias) bf16 [rows,
    N], with x0 the critic's input rows (``rl/nets.py::critic_input``) built
    inside the product from ``lat`` (float32 [B, L]): every joint action a
    = a_dc * n_g + a_g in row b * A + a (``a_dc``, ``a_g`` None), or the
    taken actions ``a_dc``, ``a_g`` (int32 [B]) in row b; ``kernel`` bf16
    [L + n_dc + n_g, N], ``bias`` bf16 [N].  Returns (y, x0), x0 (bf16
    [rows, L + n_dc + n_g]) written where ``keep_rows``, else None."""
    if plain or not build.on_card("critic_first_fwd", lat):
        from ..rl.nets import critic_first_plain
        y, x0 = critic_first_plain(lat, n_dc, n_g, kernel, bias, a_dc, a_g)
        return y, x0 if keep_rows else None
    op, dev = "critic_first_fwd", lat.device
    B, L = lat.shape
    K, N = L + n_dc + n_g, kernel.shape[-1]
    build.check(op, "lat", lat, F32, dev, (B, L))
    build.check(op, "kernel", kernel, BF16, dev, (K, N))
    build.check(op, "bias", bias, BF16, dev, (N,))
    if (a_dc is None) != (a_g is None):
        raise ValueError(f"{op}: give both actions or neither")
    if a_dc is not None:
        build.check(op, "a_dc", a_dc, torch.int32, dev, (B,))
        build.check(op, "a_g", a_g, torch.int32, dev, (B,))
    R = B * n_dc * n_g if a_dc is None else B
    bm, bn, stages = critic_plan(R, L, n_dc, n_g, N, a_dc is not None,
                                 tma_ok(kernel), keep_rows)
    y = torch.empty((R, N), dtype=BF16, device=dev)
    x0 = torch.empty((R, K), dtype=BF16, device=dev) if keep_rows else None
    fn = build.bind("dense", "critic_first_launch",
                    [P, P, P, P, I, I, I, I, P, P, P, I, I, I, I, P])
    with torch.cuda.device(dev):
        rc = fn(lat.data_ptr(), None if a_dc is None else a_dc.data_ptr(),
                None if a_g is None else a_g.data_ptr(),
                None if x0 is None else x0.data_ptr(), B, L, n_dc, n_g,
                kernel.data_ptr(), bias.data_ptr(), y.data_ptr(), N, bm, bn,
                stages, build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    critic_first_fwd.launches += 1
    return y, x0


critic_first_fwd.launches = 0


def actor_heads_fwd(x, k_dc, b_dc, k_g, b_g, mask_dc, mask_g,
                    plain: bool = False):
    """The actor's two heads from its hidden layer's bf16 output ``x`` [R,
    K] (unit column stride): each head's logits, the bf16 product with its
    ``kernel`` [K, n] plus its bf16 bias (``dense_fwd`` without a ReLU),
    as float32, and their masked log-softmax under its bool mask [R, n],
    in one launch.  Returns (logp_dc, logp_g, l_dc, l_g), float32 [R, n]
    each.  n_dc + n_g at most ``HEADS_MAX`` (:func:`heads_plan`)."""
    if plain or not build.on_card("actor_heads_fwd", x):
        from ..rl.nets import actor_heads_plain
        return actor_heads_plain(x, k_dc, b_dc, k_g, b_g, mask_dc, mask_g)
    op, dev = "actor_heads_fwd", x.device
    R, K = x.shape
    n_dc, n_g = k_dc.shape[-1], k_g.shape[-1]
    ldx = _rows(op, "x", x, BF16, dev, R, K)
    for name, t, shape in (("k_dc", k_dc, (K, n_dc)), ("k_g", k_g, (K, n_g)),
                           ("b_dc", b_dc, (n_dc,)), ("b_g", b_g, (n_g,))):
        build.check(op, name, t, BF16, dev, shape)
    build.check(op, "mask_dc", mask_dc, torch.bool, dev, (R, n_dc))
    build.check(op, "mask_g", mask_g, torch.bool, dev, (R, n_g))
    bm, bn, stages = heads_plan(R, K, n_dc + n_g)
    outs = [torch.empty((R, n), dtype=F32, device=dev)
            for n in (n_dc, n_g, n_dc, n_g)]
    fn = build.bind("dense", "actor_heads_launch",
                    [P, LL, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                     P])
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), ldx, k_dc.data_ptr(), b_dc.data_ptr(),
                k_g.data_ptr(), b_g.data_ptr(), mask_dc.data_ptr(),
                mask_g.data_ptr(), outs[2].data_ptr(), outs[3].data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), R, K, n_dc, n_g, bm,
                bn, stages, build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    actor_heads_fwd.launches += 1
    return tuple(outs)


actor_heads_fwd.launches = 0
