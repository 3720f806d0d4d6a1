"""B6b: the replay sample — a hand-written CUDA kernel and its wrapper.

Replaces the XLA-fused ``replay_sample`` of the JAX package's replay ring
(``distributed_cluster_gpus_tpu/rl/replay.py:212``): a uniform draw of a
batch over the valid rows by the inverse CDF, and the gather of the drawn
rows.  ``csrc/replay_sample.cu``'s head note gives its design and bound.

:func:`replay_sample` is the wrapper ``rl.sac.sac_train_step`` calls once
per update.  A replay on the card launches the kernel (built on first use),
which scans the validity bitmap, draws and gathers into a batch the wrapper
allocates, with no host read: the sample key's two words, computed on the
host, are launch arguments.  A replay on the CPU, or ``plain=True``, runs
``rl.replay.replay_sample``.  There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build

_argtypes = None


def _lib():
    global _argtypes
    lib = build.load("replay_sample")
    if _argtypes is None:
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.replay_sample_launch.argtypes = [P, P, P, I, P, I, I, U, U, P, P]
        lib.replay_sample_launch.restype = ctypes.c_int
        _argtypes = True
    return lib


def replay_sample(rb, key: torch.Tensor, batch: int,
                  plain: bool = False) -> Dict[str, torch.Tensor]:
    """``batch`` rows of ``rb`` drawn with the threefry ``key`` (int64 [2];
    on the CPU for the kernel, whose launch takes its words): the rows by
    ``ROW_FIELDS`` name and ``idx`` (int32 [batch]), as
    ``rl.replay.replay_sample`` returns them."""
    from ..rl import replay as rp

    dev = rb.valid.device
    if plain or dev.type == "cpu":
        return rp.replay_sample(rb, key, batch)
    if dev.type != "cuda":
        raise ValueError(f"replay_sample: unsupported device {dev}")
    if key.device.type != "cpu" or key.shape != (2,):
        raise ValueError("replay_sample: the key must be an int64 [2] tensor on "
                         "the CPU (its words are launch arguments)")
    C = int(rb.valid.shape[0])
    build.check("replay_sample", "rb.valid", rb.valid, torch.bool, dev, (C,))
    out, src, dst, row_bytes = {}, [], [], []
    for name in rp.ROW_FIELDS:
        s = getattr(rb, name)
        build.check("replay_sample", f"rb.{name}", s, s.dtype, dev)
        if s.shape[0] != C:
            raise ValueError(f"replay_sample: rb.{name} has {s.shape[0]} rows "
                             f"for a ring of {C}")
        d = torch.empty((batch,) + tuple(s.shape[1:]), dtype=s.dtype, device=dev)
        out[name] = d
        src.append(s.data_ptr())
        dst.append(d.data_ptr())
        row_bytes.append(s.element_size() * (s.numel() // C))
    idx = torch.empty(batch, dtype=torch.int32, device=dev)
    out["idx"] = idx
    n = len(src)
    k0, k1 = (int(w) for w in key.tolist())
    with torch.cuda.device(dev):
        rc = _lib().replay_sample_launch(
            (ctypes.c_uint64 * n)(*src), (ctypes.c_uint64 * n)(*dst),
            (ctypes.c_int * n)(*row_bytes), n, rb.valid.data_ptr(), C, batch,
            k0, k1, idx.data_ptr(), build.stream_of(dev))
    if rc != 0:
        why = {-1: "a bad field table",
               -2: "a batch or ring the kernel does not take"}.get(
                   rc, f"cudaError {rc}")
        raise RuntimeError(f"replay_sample kernel launch failed: {why}")
    replay_sample.launches += 1
    return out


replay_sample.launches = 0
