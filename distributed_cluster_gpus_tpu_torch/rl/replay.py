"""Device-resident replay ring: state, init and the windowed ingest.

Counterpart of ``distributed_cluster_gpus_tpu/rl/replay.py``'s
``ReplayState``, ``replay_init``, ``replay_add_chunk`` (``:103``) and
``_add_window`` (``:165``) in the default "slotring" layout: a chunk's
transitions are compacted valid-first (a stable partition, insertion order
kept) and written as ONE contiguous window at the ring pointer, wrapping to
0 when the window would run off the end; the pointer advances by the valid
rows only, so the invalid tail written past it is overwritten by the next
window.  The "scatter" layout (``_add_scatter``, ``:132``) writes each valid
row at the ring pointer plus its rank, modulo C, the whole chunk (its newest
C rows) in one pass; ``DCG_REPLAY_INGEST`` selects it, read at import as the
JAX package reads it (``:39``).  :func:`replay_sample` (``:212``) is B6b's
plain version (the kernel: ``kernels/replay_sample.py``).

:func:`_add_window` and :func:`_add_scatter` are B6a's plain versions;
``replay_add_chunk`` ingests each window through
``kernels/replay_ingest.replay_ingest``, which launches the B6a kernel for a
replay on the card (no host read) and runs the plain version for one on the
CPU.  The state is updated in place.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import torch

from ..device import resolve_device
from ..ops import prng

#: max rows per contiguous write window
INGEST_WINDOW = 4096
#: the ingest layout, read at import as the JAX package reads it:
#: "slotring" (the default) or "scatter"
INGEST_MODE = os.environ.get("DCG_REPLAY_INGEST", "slotring")

#: the row fields of a transition, in the ring's (and the kernel's) order
ROW_FIELDS = ("s0", "s1", "a_dc", "a_g", "r", "costs", "done", "mask_dc",
              "mask_g", "mask_dc0", "mask_g0")


@dataclasses.dataclass
class ReplayState:
    """Ring of capacity C (every row leaf has leading axis C).  ``valid``
    marks rows holding a real transition, ``size`` counts them, ``ptr`` is
    the next write offset and ``n_seen`` the valid rows ever ingested (the
    warm-up gate reads it)."""

    s0: torch.Tensor  # [C, obs_dim] f32
    s1: torch.Tensor  # [C, obs_dim] f32
    a_dc: torch.Tensor  # [C] int32
    a_g: torch.Tensor  # [C] int32
    r: torch.Tensor  # [C] f32
    costs: torch.Tensor  # [C, n_costs] f32
    done: torch.Tensor  # [C] f32 (1.0 = terminal; single-step episodes)
    mask_dc: torch.Tensor  # [C, n_dc] bool: masks at s1
    mask_g: torch.Tensor  # [C, n_g] bool
    mask_dc0: torch.Tensor  # [C, n_dc] bool: masks when the action was taken
    mask_g0: torch.Tensor  # [C, n_g] bool
    valid: torch.Tensor  # [C] bool
    ptr: torch.Tensor  # int32
    size: torch.Tensor  # int32
    n_seen: torch.Tensor  # int32


def replay_init(capacity: int, obs_dim: int, n_dc: int, n_g: int,
                n_costs: int, device="cuda") -> ReplayState:
    """An empty ring on ``device`` (the card unless the caller asks for the
    CPU)."""
    if capacity > (1 << 24):
        raise ValueError(
            f"replay capacity {capacity} exceeds 2^24, which the float32 "
            "sampling CDF cannot index; lower --rl-buffer")
    dev = resolve_device(device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    f32, i32, b = torch.float32, torch.int32, torch.bool
    C = capacity
    return ReplayState(
        s0=z((C, obs_dim), f32), s1=z((C, obs_dim), f32),
        a_dc=z((C,), i32), a_g=z((C,), i32), r=z((C,), f32),
        costs=z((C, n_costs), f32),
        done=torch.ones((C,), dtype=f32, device=dev),
        mask_dc=z((C, n_dc), b), mask_g=z((C, n_g), b),
        mask_dc0=z((C, n_dc), b), mask_g0=z((C, n_g), b),
        valid=z((C,), b), ptr=z((), i32), size=z((), i32), n_seen=z((), i32))


def window_rows(tr: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A window's source rows by ROW_FIELDS name (``done`` defaults to
    ones, the s0 masks to the s1 masks, as the JAX ingest defaults them)."""
    rows = dict(tr)
    if "done" not in rows:
        rows["done"] = torch.ones(tr["valid"].shape, dtype=torch.float32,
                                  device=tr["valid"].device)
    rows.setdefault("mask_dc0", tr["mask_dc"])
    rows.setdefault("mask_g0", tr["mask_g"])
    return rows


def _add_window(rb: ReplayState, tr: Dict[str, torch.Tensor]) -> None:
    """B6a's plain version: one window of N <= C rows into the ring, in
    place.  Valid rows land at ``start + rank`` and the invalid rows after
    them in order (the JAX package's stable ``argsort`` of ``~valid``),
    where ``start`` is ``ptr``, or 0 when the window would run past C;
    ``n_lost`` counts the valid rows the window overwrites.  Reads the ring
    pointer on the host (the kernel reads it on the device)."""
    C = rb.valid.shape[0]
    rows = window_rows(tr)
    valid = rows["valid"].to(torch.bool)
    N = int(valid.shape[0])
    perm = torch.argsort((~valid).to(torch.int8), stable=True)
    n_new = int(valid.sum())
    ptr = int(rb.ptr)
    start = ptr if ptr + N <= C else 0
    n_lost = int(rb.valid[start:start + N].sum())
    for name in ROW_FIELDS:
        dst = getattr(rb, name)
        dst[start:start + N] = rows[name].index_select(0, perm).to(dst.dtype)
    rb.valid[start:start + N] = torch.arange(N, device=valid.device) < n_new
    rb.ptr.fill_(start + n_new)
    rb.size.fill_(int(rb.size) - n_lost + n_new)
    rb.n_seen.fill_(int(rb.n_seen) + n_new)


def _add_scatter(rb: ReplayState, tr: Dict[str, torch.Tensor]) -> None:
    """B6a's plain version in the "scatter" layout: the N <= C rows of
    ``tr`` into the ring in one pass, in place.  The valid row of rank k
    (in insertion order) lands at ``(ptr + k) % C``, invalid rows are
    dropped, ``valid`` is set at every written row, ``ptr`` advances by the
    valid rows modulo C, ``size`` is ``min(size + n_new, C)`` and ``n_seen``
    grows by n_new (the JAX package's ``_add_scatter``).  Reads the ring
    pointer on the host (the kernel reads it on the device)."""
    C = rb.valid.shape[0]
    rows = window_rows(tr)
    valid = rows["valid"].to(torch.bool)
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    n_new = int(valid.sum())
    ptr = int(rb.ptr)
    idx = (ptr + rank[valid]) % C
    for name in ROW_FIELDS:
        dst = getattr(rb, name)
        dst[idx] = rows[name][valid].to(dst.dtype)
    rb.valid[idx] = True
    rb.ptr.fill_((ptr + n_new) % C)
    rb.size.fill_(min(int(rb.size) + n_new, C))
    rb.n_seen.fill_(int(rb.n_seen) + n_new)


def windows(C: int, N: int, max_window: int = INGEST_WINDOW):
    """The (lo, hi) row ranges ``replay_add_chunk`` ingests a chunk of N
    rows in (the newest C rows when N > C)."""
    first = N - C if N > C else 0
    n = N - first
    w = min(max_window, n, max(1, C // 4))
    return [(first + k, first + min(k + w, n)) for k in range(0, n, w)]


def replay_add_chunk(rb: ReplayState, tr: Dict[str, torch.Tensor],
                     max_window: int = INGEST_WINDOW) -> ReplayState:
    """Ingest one chunk's RL emission stream (leading axis N; keys
    {valid, s0, s1, a_dc, a_g, r, costs, mask_dc, mask_g, mask_dc0,
    mask_g0}) in the :data:`INGEST_MODE` layout: "slotring" in windows of
    at most ``max_window`` rows (and at most C // 4, so a small ring keeps
    most of its rows live), "scatter" in one pass of the newest C rows.  In
    place; returns ``rb``."""
    from ..kernels.replay_ingest import replay_ingest

    C = rb.valid.shape[0]
    N = int(tr["valid"].shape[0])
    if INGEST_MODE == "scatter":
        first = N - C if N > C else 0
        replay_ingest(rb, {k: v[first:] for k, v in tr.items()}, "scatter")
        return rb
    for lo, hi in windows(C, N, max_window):
        replay_ingest(rb, {k: v[lo:hi] for k, v in tr.items()})
    return rb


def replay_sample(rb: ReplayState, key, batch: int,
                  bf16_obs: bool = False, x64: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """B6b's plain version: ``batch`` rows drawn uniformly over the valid
    rows by the inverse CDF, as the JAX package draws them: ``cdf =
    cumsum(valid)`` (float32, exact below 2^24 rows), ``u = uniform(key,
    (batch,)) * max(cdf[-1], 1)``, ``idx = clip(searchsorted(cdf, u,
    right), 0, C - 1)`` (an empty ring, or ``u`` rounding up to the total,
    gives row C - 1), then the rows of every ROW_FIELDS leaf at ``idx``
    (``s0`` and ``s1`` rounded to bf16 with ``bf16_obs``: the encoder's
    input cast).  With ``x64`` (the float64 clock's run, jax under
    ``jax_enable_x64``) the uniform is float64, drawn from 64 bits, and
    ``u`` and the search run in float64.  ``key`` is the sample's threefry key (int64 [2]).
    Returns the rows by field name and ``idx`` (int32 [batch])."""
    C = rb.valid.shape[0]
    cdf = torch.cumsum(rb.valid.to(torch.float32), 0)
    total = torch.clamp_min(cdf[-1], 1.0)
    if x64:
        u = prng.uniform_vec64(key.to(cdf.device), batch) * total.double()
        idx = torch.clamp(torch.searchsorted(cdf.double(), u, right=True), 0,
                          C - 1)
    else:
        u = prng.uniform_vec(key.to(cdf.device), batch) * total
        idx = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, C - 1)
    out = {name: getattr(rb, name).index_select(0, idx) for name in ROW_FIELDS}
    if bf16_obs:
        for name in ("s0", "s1"):
            out[name] = out[name].to(torch.bfloat16)
    out["idx"] = idx.to(torch.int32)
    return out
