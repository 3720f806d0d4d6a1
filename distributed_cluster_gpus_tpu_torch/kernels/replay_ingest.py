"""B6a: the replay ingest — a hand-written CUDA kernel and its wrapper.

Replaces the XLA-fused ingest of the JAX package's replay ring
(``distributed_cluster_gpus_tpu/rl/replay.py``, reached through
``replay_add_chunk``, ``:103``): ``_add_window`` (``:165``), a window of a
chunk's transitions compacted valid-first and written as one contiguous
ring window (the default "slotring" layout), and ``_add_scatter``
(``:132``), the valid rows scattered at the ring pointer (the "scatter"
layout).  ``csrc/replay_ingest.cu``'s head note gives its design and bound.

:func:`replay_ingest` is the wrapper ``rl.replay.replay_add_chunk`` calls
once per window.  A replay on the CPU takes the plain version,
``rl.replay._add_window`` or ``rl.replay._add_scatter``; a replay on the
card launches the kernel (built on first use; one launch, two for a window
of more than 32,768 rows, counted as one call), which reads the ring
pointer on the device and updates ``ptr``, ``size`` and ``n_seen`` there —
no host read — or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

_argtypes = None
#: per device, the kernel's zeroed words (the blocks' arrivals with their
#: n_lost shares, 64-bit; the count launch's ticket), left zero by every
#: launch
_state = {}
#: the constant word of a field the window may leave out (``done``: 1.0f)
FILLS = {"done": 0x3F800000}


def _lib():
    global _argtypes
    from . import build

    lib = build.load("replay_ingest")
    if _argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.replay_ingest_launch.argtypes = [P, P, P, P, I, P, P, P, P, P, I,
                                             I, I, P, P, P]
        lib.replay_ingest_launch.restype = ctypes.c_int
        lib.replay_ingest_scratch.argtypes = [I]
        lib.replay_ingest_scratch.restype = I
        _argtypes = True
    return lib


def _state_of(dev):
    t = _state.get(dev)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("replay_ingest: the first launch on a device "
                               "must run eagerly, not under graph capture")
        t = _state[dev] = torch.zeros(4, dtype=torch.int32, device=dev)
    return t


def _check(name, t, dtype, lead, device):
    if not torch.is_tensor(t) or t.dtype != dtype:
        raise TypeError(f"replay_ingest: {name} must be a {dtype} tensor")
    if t.device != device:
        raise ValueError(f"replay_ingest: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dim() < 1 or t.shape[0] != lead or not t.is_contiguous():
        raise ValueError(f"replay_ingest: {name} must be contiguous with "
                         f"leading axis {lead}")


def replay_ingest(rb, tr, mode: str = "slotring") -> None:
    """Ingest one window ``tr`` (leading axis N <= C) into ``rb`` in place,
    in the ``mode`` layout ("slotring" or "scatter"): the kernel for a
    replay on the card, ``rl.replay._add_window`` / ``_add_scatter`` for one
    on the CPU.  Counts each kernel call in ``replay_ingest.launches``."""
    from ..rl.replay import ROW_FIELDS, _add_scatter, _add_window

    if mode not in ("slotring", "scatter"):
        raise ValueError(f"replay_ingest: mode {mode!r}: 'slotring' or "
                         "'scatter'")
    dev = rb.valid.device
    if dev.type == "cpu":
        (_add_window if mode == "slotring" else _add_scatter)(rb, tr)
        return
    if dev.type != "cuda":
        raise ValueError(f"replay_ingest: unsupported device {dev}")
    C = int(rb.valid.shape[0])
    rows = dict(tr)
    rows.setdefault("mask_dc0", tr["mask_dc"])
    rows.setdefault("mask_g0", tr["mask_g"])
    N = int(rows["valid"].shape[0])
    if not 1 <= N <= C:
        raise ValueError(f"replay_ingest: window of {N} rows for a ring of {C}")
    _check("valid", rows["valid"], torch.bool, N, dev)
    _check("rb.valid", rb.valid, torch.bool, C, dev)
    for k in ("ptr", "size", "n_seen"):
        t = getattr(rb, k)
        if t.dtype != torch.int32 or t.shape != () or t.device != dev:
            raise ValueError(f"replay_ingest: rb.{k} must be an int32 scalar "
                             f"on {dev}")
    src, dst, row_bytes, fill = [], [], [], []
    for name in ROW_FIELDS:
        d, s = getattr(rb, name), rows.get(name)
        _check(f"rb.{name}", d, d.dtype, C, dev)
        if s is None and name in FILLS:  # the kernel writes the constant
            src.append(0)
        else:
            _check(name, s, d.dtype, N, dev)
            if tuple(s.shape[1:]) != tuple(d.shape[1:]):
                raise ValueError(f"replay_ingest: {name} rows are "
                                 f"{tuple(s.shape[1:])}, the ring's "
                                 f"{tuple(d.shape[1:])}")
            src.append(s.data_ptr())
        dst.append(d.data_ptr())
        row_bytes.append(d.element_size() * (d.numel() // C))
        fill.append(FILLS.get(name, 0))
    n = len(ROW_FIELDS)
    lib = _lib()
    scratch = torch.empty(max(1, lib.replay_ingest_scratch(N)),
                          dtype=torch.int32, device=dev)
    state = _state_of(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.replay_ingest_launch(
            (ctypes.c_uint64 * n)(*src), (ctypes.c_uint64 * n)(*dst),
            (ctypes.c_int * n)(*row_bytes), (ctypes.c_uint32 * n)(*fill), n,
            rows["valid"].data_ptr(), rb.valid.data_ptr(), rb.ptr.data_ptr(),
            rb.size.data_ptr(), rb.n_seen.data_ptr(), N, C,
            int(mode == "scatter"), scratch.data_ptr(), state.data_ptr(),
            stream)
    if rc != 0:
        why = {-1: "a bad field table",
               -2: "a window the kernel does not take"}.get(
                   rc, f"cudaError {rc}")
        raise RuntimeError(f"replay_ingest kernel launch failed: {why}")
    replay_ingest.launches += 1


replay_ingest.launches = 0
