"""B6a: the replay ingest window — a hand-written CUDA kernel and its wrapper.

Replaces the XLA-fused ``_add_window`` of the JAX package's replay ring
(``distributed_cluster_gpus_tpu/rl/replay.py:165``, reached through
``replay_add_chunk``, ``:103``): a window of a chunk's transitions compacted
valid-first and written as one contiguous ring window.  ``csrc/
replay_ingest.cu``'s head note gives its design and bound.

:func:`replay_ingest` is the wrapper ``rl.replay.replay_add_chunk`` calls
once per window.  A replay on the CPU takes the plain version,
``rl.replay._add_window``; a replay on the card launches the kernel (built
on first use), which reads the ring pointer on the device and updates
``ptr``, ``size`` and ``n_seen`` there — no host read — or raises.  There is
no fallback.
"""

from __future__ import annotations

import ctypes

import torch

_argtypes = None


def _lib():
    global _argtypes
    from . import build

    lib = build.load("replay_ingest")
    if _argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.replay_ingest_launch.argtypes = [P, P, P, I, P, P, P, P, P, I, I,
                                             P]
        lib.replay_ingest_launch.restype = ctypes.c_int
        _argtypes = True
    return lib


def _check(name, t, dtype, lead, device):
    if not torch.is_tensor(t) or t.dtype != dtype:
        raise TypeError(f"replay_ingest: {name} must be a {dtype} tensor")
    if t.device != device:
        raise ValueError(f"replay_ingest: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dim() < 1 or t.shape[0] != lead or not t.is_contiguous():
        raise ValueError(f"replay_ingest: {name} must be contiguous with "
                         f"leading axis {lead}")


def replay_ingest(rb, tr) -> None:
    """Ingest one window ``tr`` (leading axis N <= C) into ``rb`` in place:
    the kernel for a replay on the card, ``rl.replay._add_window`` for one on
    the CPU.  Counts each kernel launch in ``replay_ingest.launches``."""
    from ..rl.replay import ROW_FIELDS, _add_window, window_rows

    dev = rb.valid.device
    if dev.type == "cpu":
        _add_window(rb, tr)
        return
    if dev.type != "cuda":
        raise ValueError(f"replay_ingest: unsupported device {dev}")
    C = int(rb.valid.shape[0])
    rows = window_rows(tr)
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
    src, dst, row_bytes = [], [], []
    for name in ROW_FIELDS:
        d, s = getattr(rb, name), rows[name]
        _check(f"rb.{name}", d, d.dtype, C, dev)
        _check(name, s, d.dtype, N, dev)
        if tuple(s.shape[1:]) != tuple(d.shape[1:]):
            raise ValueError(f"replay_ingest: {name} rows are {tuple(s.shape[1:])}, "
                             f"the ring's {tuple(d.shape[1:])}")
        src.append(s.data_ptr())
        dst.append(d.data_ptr())
        row_bytes.append(d.element_size() * (d.numel() // C))
    n = len(ROW_FIELDS)
    c_src = (ctypes.c_uint64 * n)(*src)
    c_dst = (ctypes.c_uint64 * n)(*dst)
    c_rb = (ctypes.c_int * n)(*row_bytes)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.replay_ingest_launch(
            c_src, c_dst, c_rb, n, rows["valid"].data_ptr(),
            rb.valid.data_ptr(), rb.ptr.data_ptr(), rb.size.data_ptr(),
            rb.n_seen.data_ptr(), N, C, stream)
    if rc != 0:
        why = {-1: "a field table of the wrong length",
               -2: "a window longer than the kernel takes"}.get(
                   rc, f"cudaError {rc}")
        raise RuntimeError(f"replay_ingest kernel launch failed: {why}")
    replay_ingest.launches += 1


replay_ingest.launches = 0
