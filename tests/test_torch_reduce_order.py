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
    alpha = torch.tensor(0.3)
    got = b5b_actor_warps(q, ldc, lg, alpha, vec)
    want = rsac.marginal_actor(q, ldc, lg, alpha)
    for name, a, b in zip(("loss", "H", "dlogp_dc", "dlogp_g"), got, want):
        assert _same_bits(a, b), name
