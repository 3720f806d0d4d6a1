"""B6b: the replay sample — a hand-written CUDA kernel and its wrapper.

Replaces the XLA-fused ``replay_sample`` of the JAX package's replay ring
(``distributed_cluster_gpus_tpu/rl/replay.py:212``): a uniform draw of a
batch over the valid rows by the inverse CDF, and the gather of the drawn
rows.  ``csrc/replay_sample.cu``'s head note gives its design and bound.

:func:`replay_sample` is the wrapper ``rl.sac.sac_train_step`` calls once
per update.  A replay on the card launches the kernel (built on first use;
two launches, counted as one call in ``replay_sample.launches``), which
counts the validity bytes, draws and gathers into a batch the wrapper
allocates, with no host read: the key (and the update index) are read from
device memory, so a captured update replays with the next update's key.
Asked to, the draw launch also rounds the observations to bf16 as it copies
them (the encoder's input cast) and advances the update index once every
draw has read it (the update's own step of its index).  A replay on the
CPU, or ``plain=True``, runs ``rl.replay.replay_sample`` (and the index's
``add_``).  There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build

_argtypes = None
_tickets = {}


def _lib():
    global _argtypes
    lib = build.load("replay_sample")
    if _argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.replay_sample_launch.argtypes = [P, P, P, P, I, P, I, I, P, P, I,
                                             I, P, P, P, P]
        lib.replay_sample_launch.restype = ctypes.c_int
        lib.replay_sample_tiles.argtypes = [I]
        lib.replay_sample_tiles.restype = I
        _argtypes = True
    return lib


def _ticket(dev):
    """The two kernels' tickets on ``dev`` (zero, and left zero by every
    launch), allocated once per device."""
    t = _tickets.get(dev)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("replay_sample: the first launch on a device "
                               "must run eagerly, not under graph capture")
        t = _tickets[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    return t


def sample_key(key: torch.Tensor, index: Optional[torch.Tensor] = None):
    """The sample key of :func:`replay_sample`'s arguments, as tensor ops on
    ``key``'s device: ``key`` itself, or with ``index`` the update chain's
    ``split(fold_in(key, index))[0]``."""
    from ..ops import prng

    if index is None:
        return key
    return prng.split(prng.fold_in(key, index.to(key.device)), 2)[0]


def replay_sample(rb, key: torch.Tensor, batch: int, plain: bool = False,
                  index: Optional[torch.Tensor] = None,
                  bf16_obs: bool = False, advance: bool = False,
                  x64: bool = False) -> Dict[str, torch.Tensor]:
    """``batch`` rows of ``rb`` drawn with a threefry key (int64 [2] on the
    ring's device): the sample key ``key``, or, given ``index`` (an int32
    0-d tensor there), the key of update ``index`` of the chunk key ``key``
    (:func:`sample_key`); the rows by ``ROW_FIELDS`` name and ``idx``
    (int32 [batch]), as ``rl.replay.replay_sample`` returns them (``s0``
    and ``s1`` in bf16 with ``bf16_obs``).  With ``advance`` the index is
    incremented after the draw.  ``x64`` draws the float64 uniform of the
    float64 clock's run (the kernel's double instance of the draw)."""
    from ..rl import replay as rp

    dev = rb.valid.device
    if advance and index is None:
        raise ValueError("replay_sample: advance needs an update index")
    if plain or dev.type == "cpu":
        out = rp.replay_sample(rb, sample_key(key, index), batch, bf16_obs,
                               x64)
        if advance:
            index.add_(1)
        return out
    if dev.type != "cuda":
        raise ValueError(f"replay_sample: unsupported device {dev}")
    op = "replay_sample"
    build.check(op, "key", key, torch.int64, dev, (2,))
    if index is not None:
        build.check(op, "index", index, torch.int32, dev, ())
    C = int(rb.valid.shape[0])
    build.check(op, "rb.valid", rb.valid, torch.bool, dev, (C,))
    if rb.valid.data_ptr() % 16:
        raise ValueError(f"{op}: rb.valid must be 16-byte aligned")
    out, src, dst, row_bytes, cast = {}, [], [], [], []
    for name in rp.ROW_FIELDS:
        s = getattr(rb, name)
        build.check(op, f"rb.{name}", s, s.dtype, dev)
        if s.shape[0] != C:
            raise ValueError(f"{op}: rb.{name} has {s.shape[0]} rows for a "
                             f"ring of {C}")
        c = bf16_obs and name in ("s0", "s1")
        if c and s.dtype != torch.float32:
            raise TypeError(f"{op}: rb.{name} must be float32 to cast")
        d = torch.empty((batch,) + tuple(s.shape[1:]),
                        dtype=torch.bfloat16 if c else s.dtype, device=dev)
        out[name] = d
        src.append(s.data_ptr())
        dst.append(d.data_ptr())
        row_bytes.append(s.element_size() * (s.numel() // C))
        cast.append(int(c))
    idx = torch.empty(batch, dtype=torch.int32, device=dev)
    out["idx"] = idx
    n = len(src)
    lib = _lib()
    scratch = torch.empty(2 * lib.replay_sample_tiles(C) + 1, dtype=torch.int32,
                          device=dev)
    ticket = _ticket(dev)
    with torch.cuda.device(dev):
        rc = lib.replay_sample_launch(
            (ctypes.c_uint64 * n)(*src), (ctypes.c_uint64 * n)(*dst),
            (ctypes.c_int * n)(*row_bytes), (ctypes.c_int * n)(*cast), n,
            rb.valid.data_ptr(), C, batch, key.data_ptr(),
            None if index is None else index.data_ptr(), int(advance),
            int(x64), idx.data_ptr(), scratch.data_ptr(), ticket.data_ptr(),
            build.stream_of(dev))
    if rc != 0:
        why = {-1: "a bad field table",
               -2: "a batch or ring the kernel does not take"}.get(
                   rc, f"cudaError {rc}")
        raise RuntimeError(f"replay_sample kernel launch failed: {why}")
    replay_sample.launches += 1
    replay_sample.x64_launches += bool(x64)
    return out


replay_sample.launches = 0
#: calls of the float64 draw (the float64 clock's run)
replay_sample.x64_launches = 0
