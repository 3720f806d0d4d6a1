"""B5d: the epilogues of the SAC update's bf16 Dense layers, forward and
backward — a hand-written CUDA kernel and its wrappers.

Replace what XLA fuses around the products of flax's bf16 ``Dense`` in the
JAX package's ``sac_train_step``
(``distributed_cluster_gpus_tpu/rl/sac.py:206-310``; the layers at
``rl/nets.py:37-39, 58-61, 93-95, 149-150``): the bias add, the ReLU and the
float32 copy of a network's last layer, and in the gradient the ReLU's mask,
the bf16 cast of a float32 incoming gradient and the bias gradient.
``csrc/dense.cu``'s head note gives the design and bound.  The products stay
bf16 ``torch.matmul``; ``rl/nets.py::dense_forward`` / ``dense_backward``
put the layer together.

Each wrapper launches the kernel for tensors on the card (built on first
use) or raises, and runs its plain version (``rl/nets.py``) for tensors on
the CPU or with ``plain=True``; there is no fallback.  Each counts its
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

BF16, F32 = torch.bfloat16, torch.float32
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _rows(op, name, t, dtype, dev, R, N):
    """The row stride of ``t``, a [R, N] ``dtype`` tensor on ``dev`` with a
    unit column stride."""
    if t.dtype != dtype or t.device != dev or tuple(t.shape) != (R, N) \
            or (N > 1 and t.stride(1) != 1):
        raise ValueError(f"{op}: {name} must be {dtype} [{R}, {N}] on {dev} "
                         "with unit column stride")
    return t.stride(0) if R > 1 else N


def dense_epilogue(y, bias, relu: bool, out32=None, plain: bool = False):
    """B5d forward, in place on the product ``y`` (bf16 [R, N]): the bf16
    ``bias`` [N] added (in float32, rounded to bf16), the ReLU where
    ``relu``, and, where ``out32`` (float32 [R, N], any row stride) is given,
    its float32 copy; returns ``y``."""
    if plain or not build.on_card("dense_epilogue", y):
        from ..rl.nets import dense_epilogue as plain_fn
        return plain_fn(y, bias, relu, out32)
    op, dev = "dense_epilogue", y.device
    R, N = y.shape
    build.check(op, "y", y, BF16, dev, (R, N))
    build.check(op, "bias", bias, BF16, dev, (N,))
    ld = 0 if out32 is None else _rows(op, "out32", out32, F32, dev, R, N)
    fn = build.bind("dense", "dense_fwd_launch", [P, P, P, LL, I, I, I, P])
    with torch.cuda.device(dev):
        rc = fn(y.data_ptr(), bias.data_ptr(),
                None if out32 is None else out32.data_ptr(), ld, R, N,
                int(relu), build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    dense_epilogue.launches += 1
    return y


dense_epilogue.launches = 0


def dense_backward(g, y, db, g2=None, plain: bool = False):
    """B5d backward: the layer's bf16 gradient G [R, N] from the incoming
    ``g`` (bf16 [R, N], or float32 [R, N] with any row stride at a network's
    last layer) plus, where given, a second bf16 ``g2``, masked by the
    layer's bf16 output ``y > 0`` where ``y`` is given (a ReLU layer); writes
    the bias gradient into ``db`` (bf16 [N]), the column sums of G by the
    halving tree over the rows.  Returns G."""
    if plain or not build.on_card("dense_backward", g):
        from ..rl.nets import dense_backward as plain_fn
        return plain_fn(g, y, db, g2)
    op, dev = "dense_backward", g.device
    R, N = g.shape
    g_f32 = g.dtype == F32
    ldg = _rows(op, "g", g, F32 if g_f32 else BF16, dev, R, N)
    for name, t in (("g2", g2), ("y", y)):
        if t is not None:
            build.check(op, name, t, BF16, dev, (R, N))
    if g_f32 and g2 is not None:
        raise ValueError(f"{op}: a second gradient only beside a bf16 one")
    build.check(op, "db", db, BF16, dev, (N,))
    G = torch.empty((R, N), dtype=BF16, device=dev)
    fn = build.bind("dense", "dense_bwd_launch", [P, I, LL, P, P, P, P, I, I, P])
    with torch.cuda.device(dev):
        rc = fn(g.data_ptr(), int(g_f32), ldg,
                None if g2 is None else g2.data_ptr(),
                None if y is None else y.data_ptr(), G.data_ptr(),
                db.data_ptr(), R, N, build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    dense_backward.launches += 1
    return G


dense_backward.launches = 0
