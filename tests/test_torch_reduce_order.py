"""The warp trees of B5a and B5b's actor term keep the plain versions' order.

``csrc/reduce.cuh`` maps the fixed halving tree of ``ops/physics.py::
tree_sum_last`` onto a warp: element k of a tree at lane k % 32, register
k / 32; the levels of distance >= 32 as register adds (``tree_stream`` in
bit-reversed order, ``tree_static`` depth first, ``tree_strided``), the
levels below as ``__shfl_down_sync`` from half the padded length
(``warp_tree``); ``tree_regs`` takes ``tree_static`` up to 16 registers.  A
CUDA kernel has no CPU mode, so these tests replay that
dataflow step by step in float32 torch on the CPU (a shuffle as a gather
over the lane axis, with the hardware's rule that a lane reading past lane
31 keeps its own value) and hold it bitwise against ``tree_sum_last``, on
seeded data with -0.0 entries and magnitudes from 1e-8 to 1e8, and the two
kernels' whole mappings against their plain versions (``rl/sac.py``).  The
acting policy's GPU-count head in B1's RL mode (``csrc/event_scan.cu``
``head_sample``/``sample_heads``: action a at lane a % 32 of register slot
a / 32, the tree's levels of distance >= 32 in registers, each warp
drawing its own slots, the first maximum across the warps) is replayed the
same way against ``masked_log_softmax`` and the plain Gumbel-max.  The
gpu tests hold the kernels themselves on the card.
"""

import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu_torch.ops.physics import tree_sum_last
from distributed_cluster_gpus_tpu_torch.rl import sac as rsac
from distributed_cluster_gpus_tpu_torch.rl.nets import masked_log_softmax

F32 = torch.float32
LANES = 32
LANE = torch.arange(LANES)


def _pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _seeded(rng, shape):
    """float32 of both signs, magnitudes 1e-8..1e8, a tenth of them -0.0 or
    +0.0, and every fifth row all -0.0 (a tree that sums to -0.0 unless
    padding adds +0.0)."""
    x = rng.choice([-1.0, 1.0], size=shape) * 10.0 ** rng.uniform(-8, 8, size=shape)
    zeros = rng.random(shape) < 0.1
    x[zeros] = rng.choice([-0.0, 0.0], size=int(zeros.sum()))
    x = x.astype(np.float32)
    if x.ndim > 1:
        x[::5] = -0.0
    return torch.from_numpy(x)


# ------------------------------------------- reduce.cuh, replayed in torch


def shfl_down(v, h):
    """``__shfl_down_sync(full, v, h)`` over the last (lane) axis."""
    src = LANE + h
    return v[..., torch.where(src < LANES, src, LANE)]


def warp_tree(v, p):
    """``rd::warp_tree``: shuffle levels h = p/2 .. 1; the sum in lane 0."""
    h = p // 2
    while h > 0:
        v = v + shfl_down(v, h)
        h //= 2
    return v


def tree_static(leaf, P, S=1, base=0):
    """``rd::tree_static``: T(base, S) = T(base, 2S) + T(base + S, 2S)."""
    if S >= P:
        return leaf(base)
    return tree_static(leaf, P, 2 * S, base) + tree_static(leaf, P, 2 * S, base + S)


def tree_stream(R, leaf):
    """``rd::tree_stream``: leaves in bit-reversed order, subtree of 2^l
    leaves pending in slot l."""
    bits = 0
    while (1 << bits) < R:
        bits += 1
    slot = [None] * 9
    v = None
    for j in range(R):
        v = leaf(int(format(j, f"0{bits}b")[::-1], 2) if bits else 0)
        for lvl in range(9):
            if not (j >> lvl) & 1:
                slot[lvl] = v
                break
            v = slot[lvl] + v
    return v


def tree_regs(R, leaf):
    """``rd::tree_regs``: ``tree_static`` up to 16 leaves, else streamed."""
    return tree_static(leaf, R) if R <= 16 else tree_stream(R, leaf)


def tree_strided(x, s, P, used):
    """``rd::tree_strided`` on x [..., R, 32] (registers, lanes)."""
    x = x.clone()
    R = x.shape[-2]
    rd = R // 2
    while rd >= 1:
        if s <= 32 * rd < s * P:
            for r in range(R - rd):
                if r % (2 * rd) < rd:
                    x[..., r, :] = x[..., r, :] + x[..., r + rd, :]
        rd //= 2
    h = min(s * P, 32) // 2
    while h >= s:
        for r in range(min(used, R)):
            x[..., r, :] = x[..., r, :] + shfl_down(x[..., r, :], h)
        h //= 2
    return x


def lane_layout(x, R):
    """x [..., n] zero-padded to R * 32 as [..., R, 32]: element k at lane
    k % 32, register k / 32."""
    n = x.shape[-1]
    pad = torch.zeros(x.shape[:-1] + (R * LANES - n,), dtype=x.dtype)
    return torch.cat([x, pad], -1).reshape(x.shape[:-1] + (R, LANES))


def warp_sum(x, registers=tree_regs):
    """The kernels' tree over the last axis of x (any length): a lane's
    registers by ``registers``, then shuffles from the padded half."""
    P = _pow2(x.shape[-1])
    R = max(1, P // LANES)
    lanes = lane_layout(x, R)
    v = registers(R, lambda r: lanes[..., r, :])
    return warp_tree(v, min(P, LANES))[..., 0]


# ------------------------------------------------ (a) the lane layout


@pytest.mark.parametrize("registers", ["static", "stream"])
@pytest.mark.parametrize("lengths", [(1, 32), (33, 64), (65, 128), (129, 300)])
def test_lane_register_layout_keeps_the_tree(lengths, registers):
    """Element k at lane k % 32, register k / 32: register levels (unrolled
    depth first, or streamed in bit-reversed order), then shuffles from the
    padded half, for every length in the range."""
    form = {"static": lambda R, leaf: tree_static(leaf, R),
            "stream": tree_stream}[registers]
    rng = np.random.default_rng(lengths[0])
    for n in range(lengths[0], lengths[1] + 1):
        x = _seeded(rng, (10, n))
        assert _same_bits(warp_sum(x, form), tree_sum_last(x)), n


@pytest.mark.parametrize("P", [1, 2, 4, 8, 16, 32, 64])
def test_depth_first_register_tree_keeps_the_tree(P):
    """B5a's tree over j: leaves j < M (M in (P/2, P]), zero beyond, summed
    depth first at compile-time width P."""
    rng = np.random.default_rng(P)
    for M in range(P // 2 + 1, P + 1):
        x = _seeded(rng, (10, M))
        got = tree_static(lambda j: x[:, j] if j < M else torch.zeros(10), P)
        assert _same_bits(got, tree_sum_last(x)), M


def test_padding_a_short_tree_to_a_warp_changes_a_negative_zero():
    """Why the shuffles start at half the padded length: four -0.0 sum to
    -0.0 by the tree, and to +0.0 if padded to 32 lanes."""
    x = torch.full((1, 4), -0.0)
    lanes = lane_layout(x, 1)[:, 0]
    assert _same_bits(warp_tree(lanes, 4)[..., 0], tree_sum_last(x))
    assert not _same_bits(warp_tree(lanes, 32)[..., 0], tree_sum_last(x))


# --------------------------------- (c) the per-head trees in the warp


HEADS = [(1, 1), (3, 4), (8, 8), (16, 16), (2, 8), (5, 7), (4, 64), (64, 4),
         (33, 7)]


def head_trees(g, n_dc, n_g):
    """B5b actor's gradient trees as the kernel takes them: g [R, n_dc, n_g]
    at e = d * Gp + c of the padded [Dp, Gp] layout; per DC over the GPU
    counts (segments of Gp), per GPU count over the DCs (stride Gp)."""
    rows = g.shape[0]
    Gp, Dp = _pow2(n_g), _pow2(n_dc)
    E = Gp * Dp
    RE = max(1, E // LANES)
    pad = torch.zeros((rows, Dp, Gp))
    pad[:, :n_dc, :n_g] = g
    v = lane_layout(pad.reshape(rows, E), RE)
    vd = tree_strided(v, 1, Gp, RE).reshape(rows, -1)
    vg = tree_strided(v, Gp, Dp, RE).reshape(rows, -1)
    return vd[:, torch.arange(n_dc) * Gp], vg[:, torch.arange(n_g)]


@pytest.mark.parametrize("n_dc,n_g", HEADS)
def test_head_trees_in_the_warp_keep_the_tree(n_dc, n_g):
    rng = np.random.default_rng(n_dc * 100 + n_g)
    g = _seeded(rng, (12, n_dc * n_g)).reshape(12, n_dc, n_g)
    per_dc, per_g = head_trees(g, n_dc, n_g)
    assert _same_bits(per_dc, tree_sum_last(g))
    assert _same_bits(per_g, tree_sum_last(g.transpose(1, 2)))
    # the trees over A (a at lane a % 32, register a / 32)
    A = n_dc * n_g
    Ap = _pow2(A)
    RA = max(1, Ap // LANES)
    flat = g.reshape(12, A)
    got = tree_strided(lane_layout(flat, RA), 1, Ap, RA)[:, 0, 0]
    assert _same_bits(got, tree_sum_last(flat))


# --------------------------------------- the two kernels' whole mappings


def _count(n):
    return torch.tensor(float(n), dtype=F32)


def b5a_warps(q, target, taus, kappa=1.0):
    """``quantile_huber_kernel``'s dataflow: a warp per (b, t), lane i
    quantile i (and i + 32), the tree over j depth first, over i a register
    add and shuffles, the last warp's tree over b."""
    B, _, N = q.shape
    M = target.shape[1]
    Np, Mp = _pow2(N), _pow2(M)
    k, hk = torch.tensor(kappa, dtype=F32), torch.tensor(0.5 * kappa, dtype=F32)
    fM, fB = _count(M), _count(B)
    grad = torch.empty_like(q)

    def quantile(i):  # i [32] lanes -> [B, 2, 32]
        inn = i < N
        qv = torch.where(inn, q[:, :, i.clamp(max=N - 1)], torch.zeros(()))
        tau = torch.where(inn, taus[i.clamp(max=N - 1)], torch.zeros(()))

        def leaf(j):
            if j >= M:
                z = torch.zeros(qv.shape)
                return torch.stack([z, z])
            td = target[:, None, j, None] - qv
            a = td.abs()
            small = a <= k
            h = torch.where(small, 0.5 * (td * td), k * (a - hk))
            w = (tau - (td < 0).to(F32)).abs()
            dh = torch.where(small, td, torch.where(td > 0, k, -k))
            return torch.stack([w * h, w * dh])

        s = tree_static(leaf, Mp)
        g = -((s[1] / fM) / fB)
        grad[:, :, i[inn]] = g[:, :, inn]
        return torch.where(inn, s[0] / fM, torch.zeros(()))

    row = quantile(LANE)
    if Np > 32:
        row = row + quantile(LANE + 32)
    partial = warp_tree(row, min(Np, 32))[..., 0].t().reshape(-1)  # [t * B + b]
    Bp = _pow2(B)

    def tail(t):
        def leaf(r):
            kk = LANE + 32 * r
            return torch.where(kk < B, partial[t * B + kk.clamp(max=B - 1)],
                               torch.zeros(()))
        return warp_tree(tree_regs(max(1, Bp // 32), leaf), min(Bp, 32))[0]

    return tail(0) / fB + tail(1) / fB, grad


@pytest.mark.parametrize("B,N,M", [(1, 1, 1), (3, 7, 5), (37, 32, 32),
                                   (5, 33, 64), (40, 64, 64), (70, 8, 16)])
def test_b5a_warp_mapping_matches_plain_version(B, N, M):
    rng = np.random.default_rng(B + N + M)
    q = torch.from_numpy(rng.standard_normal((B, 2, N)).astype(np.float32))
    tgt = torch.from_numpy((rng.standard_normal((B, M)) * 2).astype(np.float32))
    n = min(N, M, 2)
    tgt[0, :n] = q[0, 0, :n] + 1.0  # |td| exactly at kappa
    tgt[-1, :n] = q[-1, 1, :n]      # and at 0
    q[0, 1, 0], tgt[0, 0] = 0.0, -0.0  # td = -0.0
    taus = (torch.arange(N, dtype=F32) + 0.5) / N
    loss_w, grad_w = b5a_warps(q, tgt, taus)
    loss_p, grad_p = rsac.quantile_huber_loss(q, tgt, taus)
    assert _same_bits(loss_w, loss_p) and _same_bits(grad_w, grad_p)


def float4_trees(qmin):
    """The actor's tree over N = 32 with 16-byte loads: four actions a warp
    load, lane 8k + l holding quantiles 4l..4l+3 of action k; shuffles at
    4, 2, 1 (distances 16, 8, 4), then (m0 + m2) + (m1 + m3); action k's sum
    in lane 8k."""
    B, A, _ = qmin.shape
    A4 = -(-A // 4) * 4
    pad = torch.zeros((B, A4 - A, 32))
    m = torch.cat([qmin, pad], 1).reshape(B, A4 // 4, 32, 4)  # lanes, v
    for h in (4, 2, 1):
        src = LANE + h
        m = m + m[:, :, torch.where(src < LANES, src, LANE), :]
    s = (m[..., 0] + m[..., 2]) + (m[..., 1] + m[..., 3])  # [B, A4/4, 32]
    return s[:, :, ::8].reshape(B, A4)[:, :A]


def b5b_actor_warps(q, logp_dc, logp_g, alpha, vec=False):
    """``marginal_actor_kernel``'s dataflow: per row, each action's tree
    over N in one warp, then one warp's trees over A and per head, the last
    block's tree over b."""
    B, _, A, N = q.shape
    n_dc, n_g = logp_dc.shape[1], logp_g.shape[1]
    Ap, Np = _pow2(A), _pow2(N)
    fN, fB = _count(N), _count(B)
    qmin = torch.minimum(q[:, 0], q[:, 1])  # [B, A, N]
    if vec:  # N = 32: a float4 a lane, four actions a warp load
        s = float4_trees(qmin)
    else:
        R = max(1, Np // 32)
        lanes = lane_layout(qmin, R)
        s = warp_tree(tree_regs(R, lambda r: lanes[..., r, :]),
                      min(Np, 32))[..., 0]
    qm = s / fN  # [B, A]
    logpi = (logp_dc[:, :, None] + logp_g[:, None, :]).reshape(B, A)
    pi = torch.exp(logpi)
    RA = max(1, Ap // 32)
    pl = tree_strided(lane_layout(pi * logpi, RA), 1, Ap, RA)[:, 0, 0]
    pq = tree_strided(lane_layout(pi * qm, RA), 1, Ap, RA)[:, 0, 0]
    g = (pi * (qm - alpha * (logpi + 1.0))).reshape(B, n_dc, n_g)
    per_dc, per_g = head_trees(g, n_dc, n_g)
    h = -pl
    val = pq + alpha * h
    Bp = _pow2(B)

    def leaf(r):
        kk = LANE + 32 * r
        return torch.where(kk < B, val[kk.clamp(max=B - 1)], torch.zeros(()))

    tot = warp_tree(tree_regs(max(1, Bp // 32), leaf), min(Bp, 32))[0]
    return -(tot / fB), h, -(per_dc / fB), -(per_g / fB)


@pytest.mark.parametrize("B,n_dc,n_g,N,vec", [
    (1, 1, 1, 1, False), (9, 3, 4, 8, False), (33, 8, 8, 32, False),
    (33, 8, 8, 32, True), (3, 16, 16, 32, True), (7, 3, 4, 32, True),
    (5, 3, 4, 64, False), (2, 1, 1, 8192, False), (40, 5, 7, 3, False)])
def test_b5b_actor_warp_mapping_matches_plain_version(B, n_dc, n_g, N, vec):
    rng = np.random.default_rng(B * n_dc + N)
    A = n_dc * n_g
    q = torch.from_numpy(rng.standard_normal((B, 2, A, N)).astype(np.float32))
    q[:, :, :, ::7] = -0.0
    m_dc = torch.from_numpy(rng.random((B, n_dc)) < 0.6)
    m_g = torch.from_numpy(rng.random((B, n_g)) < 0.6)
    m_dc[:, 0] = True
    m_g[:, -1] = True
    m_dc[0] = False  # every DC masked: a uniform head
    m_g[-1] = False
    ldc = masked_log_softmax(torch.from_numpy(
        rng.standard_normal((B, n_dc)).astype(np.float32)), m_dc)
    lg = masked_log_softmax(torch.from_numpy(
        rng.standard_normal((B, n_g)).astype(np.float32)), m_g)
    log_alpha = torch.tensor(0.3)  # the plain version reads log alpha
    got = b5b_actor_warps(q, ldc, lg, torch.exp(log_alpha), vec)
    want = rsac.marginal_actor(q, ldc, lg, log_alpha)
    for name, a, b in zip(("loss", "H", "dlogp_dc", "dlogp_g"), got, want):
        assert _same_bits(a, b), name


# ------------------------------ B5b's target: strided actions, warp tail


def target_tree(x, W):
    """``marginal_target_kernel``'s tree over the last axis of x [..., A]:
    warp w owns the actions a = w + W j, j < J = Ap / W; its tree over j
    (the levels of distance >= W) in the lane's registers as the leaves
    load (``tree_regs``: depth first up to 16, streamed above), then the
    last log2(W) levels over w in one warp (``tree_static``)."""
    A = x.shape[-1]
    Ap = _pow2(A)
    J = Ap // W
    zero = torch.zeros(x.shape[:-1])

    def warp(w):
        return tree_regs(J, lambda j: x[..., w + W * j] if w + W * j < A else zero)

    sums = [warp(w) for w in range(W)]
    return tree_static(lambda w: sums[w], W)


@pytest.mark.parametrize("W", [4, 8, 16, 32])
@pytest.mark.parametrize("A", [64, 72, 195, 512, 1024])
def test_target_warp_mapping_keeps_the_tree(A, W):
    """Strided ownership, the register levels and the cross-warp tail add
    exactly tree_sum_last's pairs: bitwise, with -0.0 rows (no padding
    beyond Ap turns them into +0.0) and NaN entries."""
    rng = np.random.default_rng(A + W)
    x = _seeded(rng, (6, A))
    x[1, ::17] = float("nan")
    assert _same_bits(target_tree(x, W), tree_sum_last(x))


def b5b_target_warps(q, logp_dc, logp_g, r, costs, lam, targets, done, alpha,
                     gamma, W):
    """``marginal_target_kernel``'s dataflow: the row's pi and alpha log pi
    once, each lane's leaves pi (min over the twins - alpha log pi) summed
    by :func:`target_tree`, r_eff's tree over the costs on every writing
    lane, then r_eff + gamma (1 - done) v."""
    B, _, A, N = q.shape
    logpi = (logp_dc[:, :, None] + logp_g[:, None, :]).reshape(B, A)
    pi, al = torch.exp(logpi), alpha * logpi
    qmin = torch.minimum(q[:, 0], q[:, 1])  # [B, A, N]
    leaves = pi[:, :, None] * (qmin - al[:, :, None])
    v = target_tree(leaves.transpose(1, 2), W)  # [B, N]
    x = costs - targets[None, :]
    viol = torch.where(torch.isnan(x), x, torch.maximum(x, torch.zeros(())))
    reff = r - tree_sum_last(lam[None, :] * viol)
    disc = torch.tensor(gamma, dtype=F32) * (1.0 - done)
    return reff[:, None] + disc[:, None] * v, reff


@pytest.mark.parametrize("B,n_dc,n_g,N", [(5, 8, 8, 32), (3, 8, 9, 32),
                                          (2, 3, 65, 32), (2, 8, 64, 32),
                                          (2, 8, 128, 32), (4, 1, 1, 33),
                                          (3, 5, 7, 64)])
def test_b5b_target_warp_mapping_matches_plain_version(B, n_dc, n_g, N):
    """The redesigned target's whole mapping at the plan's warp count
    (``sac_update.target_warps``) and at every other the kernel is built
    for, bitwise against ``rl/sac.py::marginal_target``: masked and
    all-masked heads (pi = 0, pi log pi = -0), -0.0 and NaN quantiles."""
    from distributed_cluster_gpus_tpu_torch.kernels.sac_update import target_warps

    rng = np.random.default_rng(B * n_g + N)
    A = n_dc * n_g
    q = torch.from_numpy(rng.standard_normal((B, 2, A, N)).astype(np.float32))
    q[:, :, :, ::7] = -0.0
    q[0, 1, A // 2, 3] = float("nan")
    m_dc = torch.from_numpy(rng.random((B, n_dc)) < 0.6)
    m_g = torch.from_numpy(rng.random((B, n_g)) < 0.6)
    m_dc[:, 0] = True
    m_g[:, -1] = True
    m_dc[0] = False
    ldc = masked_log_softmax(torch.from_numpy(
        rng.standard_normal((B, n_dc)).astype(np.float32)), m_dc)
    lg = masked_log_softmax(torch.from_numpy(
        rng.standard_normal((B, n_g)).astype(np.float32)), m_g)
    r = torch.from_numpy(rng.standard_normal(B).astype(np.float32))
    costs = torch.from_numpy((rng.random((B, 4)) * 900).astype(np.float32))
    lam = torch.tensor([0.4, 0.0, 2.0, 0.0])
    tg = torch.tensor([500.0, 1e30, 0.0, 1e30])
    done = (torch.arange(B) % 2).float()
    log_alpha = torch.tensor(0.3)  # the plain version reads log alpha
    args = (q, ldc, lg, r, costs, lam, tg, done, torch.exp(log_alpha), 0.99)
    want = rsac.marginal_target(*args[:8], log_alpha, 0.99)
    Ap = _pow2(A)
    for W in sorted({target_warps(A), *(w for w in (1, 2, 4, 8, 16, 32)
                                        if w <= Ap and Ap // w <= 256)}):
        got = b5b_target_warps(*args, W)
        for a, b in zip(got, want):
            assert _same_bits(a, b), W


# ------------------- the bias gradient's tree over tiles of 256 rows


def tiled_column_tree(G, R):
    """``rd::tiled_column_tree`` (and, for one tile, ``rd::column_tree``)
    over the rows of G [R, C]: rows zero-padded to P = pow2(R); over P > 256
    the levels of distance >= 256 add whole tiles elementwise (tile t + tile
    t + T/2), then one warp a column the tree inside the tile: lane l holds
    rows l + 32 k, the levels of distance >= 32 in registers, the rest by
    shuffles from the padded half."""
    C = G.shape[1]
    P = _pow2(R)
    T, rows = max(1, P // 256), min(P, 256)
    x = torch.zeros((T, 256, C))
    x.reshape(T * 256, C)[:R] = G
    h = T // 2
    while h >= 1:
        x[:h] = x[:h] + x[h:2 * h]
        h //= 2
    tile = x[0].t()  # [C, 256]
    v = torch.zeros((8, C, LANES))
    for k in range(8):
        idx = LANE + 32 * k
        v[k] = torch.where(idx < rows, tile[:, idx.clamp(max=255)], torch.zeros(()))
    h = 4
    while h >= 1:
        if 64 * h <= rows:
            for k in range(h):
                v[k] = v[k] + v[k + h]
        h //= 2
    return warp_tree(v[0], min(rows, 32))[..., 0]


@pytest.mark.parametrize("R", [1, 3, 64, 100, 256, 257, 512, 1000, 4096])
def test_tiled_column_tree_keeps_the_tree(R):
    """B5d's backward kernels and the heads' backward over R rows, one tile
    or several: bitwise tree_sum_last over the rows, -0.0 columns kept
    (rows past R are +0.0, as the plain tree pads)."""
    rng = np.random.default_rng(R)
    G = _seeded(rng, (R, 9))
    G[:, 3] = -0.0
    G = G.to(torch.bfloat16).to(F32)  # G is bf16: float(G) exact
    assert _same_bits(tiled_column_tree(G, R), tree_sum_last(G.t()))


# ------------------------- the heads' backward: a row by a lane segment


def segment_row_grad(logits, mask, g):
    """``row_grad`` of ``csrc/log_softmax.cu``: a row of n entries by a
    segment of s = min(P, 32) lanes, entry j at lane j % s, register j / s;
    the max by a xor butterfly, S and T by the register levels (distance
    >= s) then shuffles from the segment's padded half."""
    R, n = logits.shape
    P = _pow2(n)
    s, RJ = min(P, 32), max(1, P // 32)
    ok = torch.zeros((R, RJ, s), dtype=torch.bool)
    pad = torch.zeros((R, RJ * s), dtype=torch.bool)
    pad[:, :n] = True
    ok[:] = pad.reshape(R, RJ, s)

    def layout(x, fill):
        y = torch.full((R, RJ * s), fill, dtype=x.dtype)
        y[:, :n] = x
        return y.reshape(R, RJ, s)

    mk = layout(mask, False)
    x = torch.where(mk, layout(logits, 0.0), torch.where(
        ok, torch.tensor(-1e9), torch.tensor(float("-inf"))))
    gv = layout(g, 0.0)
    m = x.amax(dim=(1, 2), keepdim=True)  # a NaN-free row: any order
    e = torch.where(ok, torch.exp(x - m), torch.zeros(()))
    ts, tg = e.clone(), gv.clone()
    d = RJ // 2
    while d >= 1:
        ts[:, :d] = ts[:, :d] + ts[:, d:2 * d]
        tg[:, :d] = tg[:, :d] + tg[:, d:2 * d]
        d //= 2
    lane = torch.arange(s)
    o = s // 2
    S, T = ts[:, 0], tg[:, 0]
    while o >= 1:
        src = torch.where(lane + o < s, lane + o, lane)
        S, T = S + S[:, src], T + T[:, src]
        o //= 2
    ds = (-T[:, :1]) / S[:, :1]
    dl = torch.where(mk, gv + ds[:, :, None] * e, torch.zeros(()))
    return dl.reshape(R, RJ * s)[:, :n]


@pytest.mark.parametrize("n", [1, 3, 8, 33, 64, 65, 128, 200, 256])
def test_heads_backward_row_segments_keep_the_plain_order(n):
    """The fused heads' backward's row statistics on a lane segment, bitwise
    ``rl/nets.py::masked_log_softmax_backward``: random masks, a fully
    masked row, one feasible entry, large logits."""
    from distributed_cluster_gpus_tpu_torch.rl import nets

    rng = np.random.default_rng(n)
    R = 40
    logits = torch.from_numpy((rng.standard_normal((R, n)) * np.where(
        np.arange(R) % 2, 40.0, 1.0)[:, None]).astype(np.float32))
    mask = torch.from_numpy(rng.random((R, n)) < 0.6)
    mask[0] = False
    mask[1] = False
    mask[1, n - 1] = True
    g = torch.from_numpy(rng.standard_normal((R, n)).astype(np.float32))
    assert _same_bits(segment_row_grad(logits, mask, g),
                      nets.masked_log_softmax_backward(logits, mask, g))


def _source_int(name):
    """An ``int`` constant of ``csrc/log_softmax.cu``."""
    import os
    import re

    from distributed_cluster_gpus_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC_DIR, "log_softmax.cu")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


@pytest.mark.parametrize("P", [1, 2, 4, 8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("R", [256, 37])
def test_heads_backward_passes_cover_every_entry_once(P, R):
    """The fused heads' backward's work split, as the kernel indexes it
    (its warps a block from the source): a 256-row tile of a head padded to
    P entries, in passes of 32 / s rows a warp, kAhead passes at once,
    guarded as the kernel guards its loads: every (row, entry) of the R
    rows exactly once (a whole tile, or a last tile of 37 rows), none past
    them."""
    warps, tile = _source_int("kWarps"), 256
    RJ = max(1, P // 32)
    s, U = (P if RJ == 1 else 32), (1 if RJ >= 4 else 4 // RJ)
    rpw = 32 // s
    passes = (tile + warps * rpw - 1) // (warps * rpw)
    seen = {}
    for p0 in range(0, passes, U):
        for u in range(U):
            for warp in range(warps):
                for lane in range(32):
                    t = ((p0 + u) * warps + warp) * rpw + lane // s
                    if p0 + u < passes and t < tile and t < R:
                        for k in range(RJ):
                            j = (lane & (s - 1)) + s * k
                            seen[(t, j)] = seen.get((t, j), 0) + 1
    assert seen == {(t, j): 1 for t in range(R) for j in range(P)}


# ------------------------------- the acting heads of B1's RL mode, replayed

def acting_head(logits, mask, gum, NW, greedy=False):
    """``head_sample`` / ``sample_heads`` for one head of n <= 256 actions
    on NW warps: (logp [n], action).  ``gum`` [n] holds action a's Gumbel
    draw (counter a).  Slot s of a lane holds action 32 s + lane; every
    warp computes the log-softmax, warp w draws slots w, w + NW, ..., keeps
    a lane's first maximum over its slots (ascending), then the warp's by
    shuffles (a larger value, or an equal one at a lower index); the warps'
    first maxima are taken in warp order, strictly larger replacing."""
    n = logits.shape[0]
    kS = 1 if n <= 32 else 8
    a = torch.arange(kS * LANES).reshape(kS, LANES)
    on = a < n
    pad = torch.full((kS * LANES - n,), 0.0)
    x = torch.where(torch.cat([mask, pad.bool()]).reshape(kS, LANES),
                    torch.cat([logits, pad]).reshape(kS, LANES),
                    torch.full((kS, LANES), -1e9))
    x = torch.where(on, x, torch.full_like(x, -torch.inf))
    m = x.max()
    sh = x - m
    e = torch.where(on, torch.exp(sh), torch.zeros_like(sh))
    p = _pow2(n)
    hs = kS // 2
    while hs >= 1:
        if 64 * hs <= p:
            e = torch.cat([e[:hs] + e[hs:2 * hs], e[hs:]])
        hs //= 2
    e0 = e[0]
    half = min(p, 32) // 2
    while half >= 1:
        o = shfl_down(e0, half)
        e0 = torch.where(LANE < half, e0 + o, e0)
        half //= 2
    lse = torch.log(e0[0])
    lp = sh - lse
    v = lp if greedy else torch.cat([gum, pad]).reshape(kS, LANES) + lp
    cands = []
    for w in range(min(-(-n // 32), NW)):
        bv = torch.zeros(LANES)
        best = torch.full((LANES,), 1 << 30)
        for s_ in range(w, kS, NW):
            take = on[s_] & ((best == 1 << 30) | (v[s_] > bv))
            bv = torch.where(take, v[s_], bv)
            best = torch.where(take, a[s_], best)
        off = 16
        while off:
            src = LANE ^ off
            ov, ob = bv[src], best[src]
            take = (ob != 1 << 30) & ((best == 1 << 30) | (ov > bv)
                                      | ((ov == bv) & (ob < best)))
            bv, best = torch.where(take, ov, bv), torch.where(take, ob, best)
            off //= 2
        cands.append((bv[0], int(best[0])))
    bv, best = cands[0]
    for ov, ob in cands[1:]:
        if ob != 1 << 30 and (best == 1 << 30 or ov > bv):
            bv, best = ov, ob
    return lp.reshape(-1)[:n], best


@pytest.mark.parametrize("n", [1, 5, 8, 32, 33, 64, 100, 128, 200, 255])
@pytest.mark.parametrize("NW", [1, 8])
def test_acting_head_warps_match_plain_version(n, NW):
    """The widened acting head, replayed: every log-probability bitwise
    ``masked_log_softmax``'s, the sampled action the first argmax of Gumbel
    plus logp, the greedy one the first argmax of logp, on seeded logits
    with ties, masks with all but one action masked (the first, a middle
    and the last), and equal perturbed values (ties across warps)."""
    rng = np.random.default_rng(n * 16 + NW)
    rows = []
    for r in range(12):
        logits = torch.from_numpy(rng.normal(0, 2, n).astype(np.float32))
        if r % 3 == 0:
            logits = torch.round(logits)  # ties
        mask = torch.from_numpy(rng.random(n) < 0.6)
        mask[rng.integers(0, n)] = True
        gum = torch.from_numpy(rng.gumbel(size=n).astype(np.float32))
        if r in (1, 2, 3):
            mask[:] = False
            mask[(0, n // 2, n - 1)[r - 1]] = True
        if r == 4:
            logits[:] = 0.5
            mask[:] = True
            gum[:] = 1.0  # every perturbed value equal: action 0
        rows.append((logits, mask, gum))
    for logits, mask, gum in rows:
        want = masked_log_softmax(logits[None], mask[None])[0]
        for greedy in (False, True):
            lp, a = acting_head(logits, mask, gum, NW, greedy)
            assert _same_bits(lp, want)
            ref = want if greedy else gum + want
            assert a == int(torch.argmax(ref))
