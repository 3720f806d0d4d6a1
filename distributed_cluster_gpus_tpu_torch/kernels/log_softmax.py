"""B5f's backward fused with the actor heads' top-layer backward: the
gradient of the masked log-softmax of both heads, its bf16 cast and the
heads' bias gradients — a hand-written CUDA kernel and its wrapper.

Replaces the gradient of ``nn.log_softmax`` under the masks and of the
heads' bf16 ``Dense`` bias as XLA fuses them in the JAX package's actor
(``distributed_cluster_gpus_tpu/rl/nets.py:58-66``) inside
``sac_train_step``.  The forward runs inside the heads' product
(``kernels/dense.py::actor_heads_fwd``).  ``csrc/log_softmax.cu``'s head
note gives the design and bound.  :func:`heads_backward` launches the
kernel for tensors on the card (built on first use) or raises, and runs the
plain version (``rl/nets.py::heads_backward_plain``) for tensors on the CPU
or with ``plain=True``; there is no fallback.  It counts its launches in
``heads_backward.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

F32, BF16 = torch.float32, torch.bfloat16
P, I = ctypes.c_void_p, ctypes.c_int
#: the kernel's envelope: a head's entries and the rows
MAX_HEAD, MAX_ROWS = 256, 4096


def heads_backward(l_dc, l_g, mask_dc, mask_g, g_dc, g_g, db_dc, db_g,
                   plain: bool = False):
    """(G_dc, G_g), each head's bf16 gradient [B, n] = bf16(dL/dlogits) from
    its float32 logits, bool mask and dL/dlogp (``g``) [B, n]; writes each
    head's bias gradient into ``db_dc``, ``db_g`` (bf16 [n]), the tree over
    the rows.  One launch for both heads."""
    if plain or not build.on_card("heads_backward", l_dc):
        from ..rl.nets import heads_backward_plain
        return heads_backward_plain(l_dc, l_g, mask_dc, mask_g, g_dc, g_g,
                                    db_dc, db_g)
    op, dev = "heads_backward", l_dc.device
    B = l_dc.shape[0]
    if not 1 <= B <= MAX_ROWS:
        raise ValueError(f"{op}: {B} rows; the kernel takes 1 to {MAX_ROWS}")
    args, outs = [], []
    for k, (logits, mask, g, db) in enumerate(((l_dc, mask_dc, g_dc, db_dc),
                                               (l_g, mask_g, g_g, db_g))):
        n = logits.shape[-1]
        if not 1 <= n <= MAX_HEAD:
            raise ValueError(f"{op}: a head of {n} entries; the kernel takes "
                             f"1 to {MAX_HEAD}")
        build.check(op, f"logits{k}", logits, F32, dev, (B, n))
        build.check(op, f"mask{k}", mask, torch.bool, dev, (B, n))
        build.check(op, f"g{k}", g, F32, dev, (B, n))
        build.check(op, f"db{k}", db, BF16, dev, (n,))
        G = torch.empty((B, n), dtype=BF16, device=dev)
        outs.append(G)
        args += [logits.data_ptr(), mask.data_ptr(), g.data_ptr(),
                 G.data_ptr(), db.data_ptr(), n]
    fn = build.bind("log_softmax", "heads_backward_launch",
                    [P, P, P, P, P, I, P, P, P, P, P, I, P, I, P])
    with torch.cuda.device(dev):
        rc = fn(*args, build.counters(dev).data_ptr(), B, build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    heads_backward.launches += 1
    return tuple(outs)


heads_backward.launches = 0
