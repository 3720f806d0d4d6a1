"""B5e: the one-hot critic's input rows — a hand-written CUDA kernel and
its wrapper.

Replaces the concat and cast XLA fuses ahead of the JAX package's
``QuantileCritic`` (``distributed_cluster_gpus_tpu/rl/nets.py:85-87``) and
its ``all_actions`` tiling (``:98-112``).  ``csrc/critic_input.cu``'s head
note gives the design and bound.  :func:`critic_input` launches the kernel
for tensors on the card (built on first use) or raises, and runs
``rl/nets.py::critic_input`` for tensors on the CPU or with ``plain=True``;
there is no fallback.  It counts its launches in
``critic_input.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

P, I = ctypes.c_void_p, ctypes.c_int


def critic_input(lat, n_dc: int, n_g: int, a_dc=None, a_g=None,
                 plain: bool = False):
    """x0 bf16 [rows, L + n_dc + n_g] from ``lat`` (float32 [B, L]): every
    joint action a = a_dc * n_g + a_g in row b * A + a (``a_dc``, ``a_g``
    None), or the taken actions ``a_dc``, ``a_g`` (int32 [B]) in row b."""
    if plain or not build.on_card("critic_input", lat):
        from ..rl.nets import critic_input as plain_fn
        return plain_fn(lat, n_dc, n_g, a_dc, a_g)
    op, dev = "critic_input", lat.device
    B, L = lat.shape
    build.check(op, "lat", lat, torch.float32, dev, (B, L))
    if (a_dc is None) != (a_g is None):
        raise ValueError(f"{op}: give both actions or neither")
    if a_dc is not None:
        build.check(op, "a_dc", a_dc, torch.int32, dev, (B,))
        build.check(op, "a_g", a_g, torch.int32, dev, (B,))
    rows = B * n_dc * n_g if a_dc is None else B
    x0 = torch.empty((rows, L + n_dc + n_g), dtype=torch.bfloat16, device=dev)
    fn = build.bind("critic_input", "critic_input_launch",
                    [P, P, P, P, I, I, I, I, P])
    with torch.cuda.device(dev):
        rc = fn(lat.data_ptr(), None if a_dc is None else a_dc.data_ptr(),
                None if a_g is None else a_g.data_ptr(), x0.data_ptr(), B, L,
                n_dc, n_g, build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    critic_input.launches += 1
    return x0


critic_input.launches = 0
