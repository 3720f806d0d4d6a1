"""B5g: the bf16 parameter shadows of the SAC update — a hand-written CUDA
kernel and its wrapper.

Replaces the casts XLA fuses into the JAX package's ``sac_train_step``
(``distributed_cluster_gpus_tpu/rl/sac.py:206-310``): flax's bf16 ``Dense``
rounds each float32 parameter to bf16 before its product.  Inside an update
the casts run in B5c's launches (``kernels/adam.py``); this kernel fills
the shadows outside it (``rl/sac.py::refresh_shadows``).
``csrc/param_pack.cu``'s head note gives the design and bound.

:func:`param_pack` rounds a list of flat float32 buffers to bf16 (to
nearest even) in one launch, for tensors on the card (built on first use)
or raises; on the CPU or with ``plain=True`` it runs
``rl/optim.py::pack_plain``.  There is no fallback.  It counts its launches
in ``param_pack.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import build

#: the most buffers one launch converts
MAX_GROUPS = 8


def param_pack(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               plain: bool = False) -> None:
    """``dst.copy_(src)`` for each (src, dst) pair of flat buffers of one
    size, float32 -> bf16, in one launch."""
    dev = pairs[0][0].device
    if plain or not build.on_card("param_pack", pairs[0][0]):
        from ..rl.optim import pack_plain
        return pack_plain(pairs)
    op = "param_pack"
    if len(pairs) > MAX_GROUPS:
        raise ValueError(f"{op}: at most {MAX_GROUPS} buffers a launch")
    n_g = len(pairs)
    ptrs = (ctypes.c_uint64 * (2 * n_g))()
    ns = (ctypes.c_longlong * n_g)()
    for i, (src, dst) in enumerate(pairs):
        n = src.numel()
        kinds = (src.dtype, dst.dtype)
        if kinds != (torch.float32, torch.bfloat16):
            raise TypeError(f"{op}: pair {i} converts {kinds[0]} to {kinds[1]}, "
                            "not float32 to bfloat16")
        build.check(op, "src", src, src.dtype, dev, (n,))
        build.check(op, "dst", dst, dst.dtype, dev, (n,))
        if src.data_ptr() % 16 or dst.data_ptr() % 16:
            raise ValueError(f"{op}: pair {i} must be 16-byte aligned")
        ptrs[2 * i:2 * i + 2] = [src.data_ptr(), dst.data_ptr()]
        ns[i] = n
    fn = build.bind("param_pack", "param_pack_launch",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(ptrs, ns, n_g, build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    param_pack.launches += 1


param_pack.launches = 0
