"""B5c: clipped Adam with the Polyak target and the alpha clamp — a
hand-written CUDA kernel and its wrapper.

Replaces the XLA-fused optimizer step of the JAX package's
``sac_train_step`` (``distributed_cluster_gpus_tpu/rl/sac.py:279-288`` and
``:300-302``: optax's ``clip_by_global_norm`` + ``adam`` of ``_tx``,
``:117``, the critic's Polyak target and ``log_alpha``'s cap) for one
parameter group held in one flat buffer.  ``csrc/adam.cu``'s head note
gives its design and bound.

:func:`adam_step` is the wrapper ``rl.sac.sac_train_step`` calls once per
group and update.  A group on the card launches the kernel (built on first
use; two launches, counted as one call in ``adam_step.launches``) or
raises; a group on the CPU, or ``plain=True``, runs
``rl.optim.clip_adam_update``.  There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_argtypes = None
#: grid of the elementwise pass: enough blocks to cover the card's 132 SMs
#: several times over, fewer for a small group
APPLY_BLOCKS = 132 * 8


def _lib():
    global _argtypes
    lib = build.load("adam")
    if _argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.adam_launch.argtypes = [P, P, P, P, P, LL, P, P, P, I, I, P, I, I, P]
        lib.adam_launch.restype = ctypes.c_int
        _argtypes = True
    return lib


def adam_step(p: torch.Tensor, g: torch.Tensor, st, cfg,
              target: Optional[torch.Tensor] = None, tau: float = 0.0,
              clamp: Optional[float] = None, plain: bool = False) -> None:
    """One clipped-Adam step of the flat group ``p`` with gradient ``g`` and
    state ``st`` (``rl.optim.AdamState``) under ``cfg`` (``rl.optim.
    AdamConfig``), in place; the Polyak ``target`` (with ``tau``) and the
    ``clamp`` as ``rl.optim.clip_adam_update`` takes them."""
    from ..rl.optim import THREADS, clip_adam_update, f32, norm_layout

    dev = p.device
    if plain or dev.type == "cpu":
        clip_adam_update(p, g, st, cfg, target=target, tau=tau, clamp=clamp)
        return
    if dev.type != "cuda":
        raise ValueError(f"adam_step: unsupported device {dev}")
    n = p.numel()
    op = "adam_step"
    f32t = torch.float32
    for name, t in (("p", p), ("g", g), ("mu", st.mu), ("nu", st.nu)):
        build.check(op, name, t, f32t, dev, (n,))
    if target is not None:
        build.check(op, "target", target, f32t, dev, (n,))
    build.check(op, "count", st.count, torch.int32, dev, ())
    k, r = norm_layout(n)
    partial = torch.empty(k, dtype=f32t, device=dev)
    count_new = torch.empty((), dtype=torch.int32, device=dev)
    consts = (ctypes.c_float * 10)(*cfg.constants(), f32(1.0 - tau), f32(tau),
                                   0.0 if clamp is None else f32(clamp))
    flags = (target is not None) | ((clamp is not None) << 1)
    blocks = min(APPLY_BLOCKS, -(-n // THREADS))
    with torch.cuda.device(dev):
        rc = _lib().adam_launch(
            p.data_ptr(), g.data_ptr(), st.mu.data_ptr(), st.nu.data_ptr(),
            0 if target is None else target.data_ptr(), n,
            st.count.data_ptr(), partial.data_ptr(), count_new.data_ptr(),
            k, r, consts, flags, blocks, build.stream_of(dev))
    if rc != 0:
        why = "a bad layout" if rc == -1 else f"cudaError {rc}"
        raise RuntimeError(f"adam_step kernel launch failed: {why}")
    adam_step.launches += 1


adam_step.launches = 0
