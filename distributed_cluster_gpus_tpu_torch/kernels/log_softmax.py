"""B5f: the masked log-softmax of the actor's two heads, forward and
backward — a hand-written CUDA kernel and its wrappers.

Replaces ``nn.log_softmax`` under the masks as XLA fuses it in the JAX
package's actor (``distributed_cluster_gpus_tpu/rl/nets.py:62-66``) inside
``sac_train_step``, and its gradient.  ``csrc/log_softmax.cu``'s head note
gives the design and bound.  Each wrapper launches the kernel for tensors on
the card (built on first use) or raises, and runs the plain versions
(``rl/nets.py::masked_log_softmax`` and ``masked_log_softmax_backward``, a
head at a time) for tensors on the CPU or with ``plain=True``; there is no
fallback.  Each counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

F32 = torch.float32
P, I = ctypes.c_void_p, ctypes.c_int


def _launch(op, backward, heads, grads=None):
    """One launch over both heads ((logits, mask) each; ``grads`` dL/dlogp
    each for the backward); returns the two outputs."""
    dev = heads[0][0].device
    B = heads[0][0].shape[0]
    args, outs = [], []
    for k, (logits, mask) in enumerate(heads):
        n = logits.shape[-1]
        build.check(op, f"logits{k}", logits, F32, dev, (B, n))
        build.check(op, f"mask{k}", mask, torch.bool, dev, (B, n))
        g = None
        if backward:
            g = grads[k]
            build.check(op, f"g{k}", g, F32, dev, (B, n))
        out = torch.empty((B, n), dtype=F32, device=dev)
        outs.append(out)
        args += [logits.data_ptr(), mask.data_ptr(),
                 None if g is None else g.data_ptr(), out.data_ptr(), n]
    fn = build.bind("log_softmax", "log_softmax_launch",
                    [I, P, P, P, P, I, P, P, P, P, I, I, P])
    with torch.cuda.device(dev):
        rc = fn(int(backward), *args, B, build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    return outs


def log_softmax2(l_dc, l_g, mask_dc, mask_g, plain: bool = False):
    """(logp_dc, logp_g): both heads' masked log-probabilities (float32 [B,
    n] logits, bool masks) in one launch."""
    if plain or not build.on_card("log_softmax2", l_dc):
        from ..rl.nets import masked_log_softmax
        return masked_log_softmax(l_dc, mask_dc), masked_log_softmax(l_g, mask_g)
    out = _launch("log_softmax2", False, ((l_dc, mask_dc), (l_g, mask_g)))
    log_softmax2.launches += 1
    return tuple(out)


log_softmax2.launches = 0


def log_softmax2_backward(l_dc, l_g, mask_dc, mask_g, g_dc, g_g,
                          plain: bool = False):
    """(dL/dl_dc, dL/dl_g) from the heads' logits and masks and dL/dlogp of
    each (float32 [B, n]), in one launch."""
    if plain or not build.on_card("log_softmax2_backward", l_dc):
        from ..rl.nets import masked_log_softmax_backward as bwd
        return bwd(l_dc, mask_dc, g_dc), bwd(l_g, mask_g, g_g)
    out = _launch("log_softmax2_backward", True,
                  ((l_dc, mask_dc), (l_g, mask_g)), (g_dc, g_g))
    log_softmax2_backward.launches += 1
    return tuple(out)


log_softmax2_backward.launches = 0
