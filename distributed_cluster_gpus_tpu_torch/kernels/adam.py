"""B5c: clipped Adam with the Polyak target and the alpha clamp — a
hand-written CUDA kernel and its wrapper.

Replaces the XLA-fused optimizer step of the JAX package's
``sac_train_step`` (``distributed_cluster_gpus_tpu/rl/sac.py:279-288`` and
``:300-302``: optax's ``clip_by_global_norm`` + ``adam`` of ``_tx``,
``:117``, the critic's Polyak target and ``log_alpha``'s cap) for every
parameter group of an update, each held in one flat buffer; and B5g, the
update's bf16 casts: a group's gradient may be bf16 (widened as it is
read) and the step writes the group's bf16 shadow (and the target's); and
log alpha's group writes ``exp`` of the new value (the update's alpha
metric).  ``csrc/adam.cu``'s head note gives its design and bound.

:func:`adam_update` is the wrapper ``rl.sac.sac_train_step`` calls once
per update with its four groups.  Groups on the card launch the kernel
(built on first use; two launches for all the groups, counted as one call
in ``adam_update.launches``) or raise; groups on the CPU, or
``plain=True``, run ``rl.optim.clip_adam_update`` on each.  There is no
fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch

from . import build

_argtypes = None


@dataclasses.dataclass
class AdamGroup:
    """One group of an update: the flat parameters ``p``, their gradient
    ``g`` (float32 or bf16), their ``rl.optim.AdamState`` ``st``, and
    optionally the Polyak ``target`` (with ``tau``), the ``clamp`` after
    the step, the bf16 ``shadow`` of ``p`` and ``target_shadow`` of the
    target that the step rewrites, and ``exp_out``, which receives
    ``exp(p)`` after the step."""

    p: torch.Tensor
    g: torch.Tensor
    st: object
    target: Optional[torch.Tensor] = None
    tau: float = 0.0
    clamp: Optional[float] = None
    shadow: Optional[torch.Tensor] = None
    target_shadow: Optional[torch.Tensor] = None
    exp_out: Optional[torch.Tensor] = None


def _lib():
    global _argtypes
    lib = build.load("adam")
    if _argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.adam_launch.argtypes = [P, P, P, P, P, I, P, I, P, P, P, P]
        lib.adam_launch.restype = ctypes.c_int
        _argtypes = True
    return lib


def adam_update(groups: Sequence[AdamGroup], cfg, plain: bool = False) -> None:
    """One clipped-Adam step of every group under ``cfg``
    (``rl.optim.AdamConfig``), in place, each as
    ``rl.optim.clip_adam_update`` steps it; the groups share ``tau`` (the
    critic's target is the only one)."""
    from ..rl.optim import clip_adam_update, f32, norm_layout

    dev = groups[0].p.device
    if plain or dev.type == "cpu":
        for gr in groups:
            clip_adam_update(gr.p, gr.g, gr.st, cfg, target=gr.target,
                             tau=gr.tau, clamp=gr.clamp, shadow=gr.shadow,
                             target_shadow=gr.target_shadow,
                             exp_out=gr.exp_out)
        return
    if dev.type != "cuda":
        raise ValueError(f"adam_update: unsupported device {dev}")
    op = "adam_update"
    f32t = torch.float32
    taus = {gr.tau for gr in groups if gr.target is not None}
    if len(taus) > 1 or len(groups) > 8:
        raise ValueError("adam_update: at most 8 groups, one Polyak tau")
    tau = taus.pop() if taus else 0.0
    n_g = len(groups)
    ptrs = (ctypes.c_uint64 * (9 * n_g))()
    ns = (ctypes.c_longlong * n_g)()
    kr = (ctypes.c_int * (2 * n_g))()
    flags = (ctypes.c_int * n_g)()
    clamps = (ctypes.c_float * n_g)()
    n_blocks = 0
    bf16 = torch.bfloat16
    for i, gr in enumerate(groups):
        n = gr.p.numel()
        g16 = gr.g.dtype == bf16
        if gr.target_shadow is not None and gr.target is None:
            raise ValueError(f"{op}: a target shadow needs its target")
        for name, t, dt in (
                ("p", gr.p, f32t), ("g", gr.g, bf16 if g16 else f32t),
                ("mu", gr.st.mu, f32t), ("nu", gr.st.nu, f32t),
                ("target", gr.target, f32t), ("shadow", gr.shadow, bf16),
                ("target_shadow", gr.target_shadow, bf16),
                ("exp_out", gr.exp_out, f32t)):
            if t is None:
                continue
            build.check(op, name, t, dt, dev,
                        (n,) if name != "exp_out" else tuple(t.shape))
            if name == "exp_out" and t.numel() != n:
                raise ValueError(f"{op}: exp_out must hold {n} elements")
            if t.data_ptr() % (8 if dt == bf16 else 16):
                raise ValueError(f"{op}: {name} must be "
                                 f"{8 if dt == bf16 else 16}-byte aligned")
        build.check(op, "count", gr.st.count, torch.int32, dev, ())
        k, r = norm_layout(n)
        ptrs[9 * i:9 * i + 9] = [
            gr.p.data_ptr(), gr.g.data_ptr(), gr.st.mu.data_ptr(),
            gr.st.nu.data_ptr(),
            0 if gr.target is None else gr.target.data_ptr(),
            gr.st.count.data_ptr(),
            0 if gr.shadow is None else gr.shadow.data_ptr(),
            0 if gr.target_shadow is None else gr.target_shadow.data_ptr(),
            0 if gr.exp_out is None else gr.exp_out.data_ptr()]
        ns[i], kr[2 * i], kr[2 * i + 1] = n, k, r
        flags[i] = ((gr.target is not None) | ((gr.clamp is not None) << 1)
                    | (g16 << 2))
        clamps[i] = 0.0 if gr.clamp is None else f32(gr.clamp)
        n_blocks += k
    consts = (ctypes.c_float * 9)(*cfg.constants(), f32(1.0 - tau), f32(tau))
    # the float64 clock's run: the bias corrections' double decays
    decays = (ctypes.c_double * 2)(cfg.b1, cfg.b2)
    partial = torch.empty(n_blocks, dtype=f32t, device=dev)
    bc = torch.empty(2 * n_g, dtype=f32t, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().adam_launch(ptrs, ns, kr, flags, clamps, n_g, consts,
                                int(cfg.x64), decays, partial.data_ptr(),
                                bc.data_ptr(), build.stream_of(dev))
    if rc != 0:
        why = "a bad group table" if rc == -1 else f"cudaError {rc}"
        raise RuntimeError(f"adam_update kernel launch failed: {why}")
    adam_update.launches += 1
    adam_update.x64_launches += bool(cfg.x64)


adam_update.launches = 0
#: calls with the float64 bias corrections (the float64 clock's run)
adam_update.x64_launches = 0
