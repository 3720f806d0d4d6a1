"""B5f's backward: the gradient of the masked log-softmax of the actor's two
heads — a hand-written CUDA kernel and its wrapper.

Replaces the gradient of ``nn.log_softmax`` under the masks as XLA fuses it
in the JAX package's actor (``distributed_cluster_gpus_tpu/rl/nets.py:62-66``)
inside ``sac_train_step``.  The forward runs inside the heads' product
(``kernels/dense.py::actor_heads_fwd``).  ``csrc/log_softmax.cu``'s head
note gives the design and bound.  :func:`log_softmax2_backward` launches the
kernel for tensors on the card (built on first use) or raises, and runs the
plain version (``rl/nets.py::masked_log_softmax_backward``, a head at a
time) for tensors on the CPU or with ``plain=True``; there is no fallback.
It counts its launches in ``log_softmax2_backward.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

F32 = torch.float32
P, I = ctypes.c_void_p, ctypes.c_int


def log_softmax2_backward(l_dc, l_g, mask_dc, mask_g, g_dc, g_g,
                          plain: bool = False):
    """(dL/dl_dc, dL/dl_g) from the heads' logits and masks and dL/dlogp of
    each (float32 [B, n]), in one launch."""
    if plain or not build.on_card("log_softmax2_backward", l_dc):
        from ..rl.nets import masked_log_softmax_backward as bwd
        return bwd(l_dc, mask_dc, g_dc), bwd(l_g, mask_g, g_g)
    op, dev = "log_softmax2_backward", l_dc.device
    B = l_dc.shape[0]
    args, outs = [], []
    for k, (logits, mask, g) in enumerate(((l_dc, mask_dc, g_dc),
                                           (l_g, mask_g, g_g))):
        n = logits.shape[-1]
        build.check(op, f"logits{k}", logits, F32, dev, (B, n))
        build.check(op, f"mask{k}", mask, torch.bool, dev, (B, n))
        build.check(op, f"g{k}", g, F32, dev, (B, n))
        out = torch.empty((B, n), dtype=F32, device=dev)
        outs.append(out)
        args += [logits.data_ptr(), mask.data_ptr(), g.data_ptr(),
                 out.data_ptr(), n]
    fn = build.bind("log_softmax", "log_softmax_backward_launch",
                    [P, P, P, P, I, P, P, P, P, I, I, P])
    with torch.cuda.device(dev):
        rc = fn(*args, B, build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    log_softmax2_backward.launches += 1
    return tuple(outs)


log_softmax2_backward.launches = 0
