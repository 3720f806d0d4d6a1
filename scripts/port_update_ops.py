"""List the plain-torch ops one learning update of the PyTorch port runs
outside its kernels' wrappers, by the port's source line that issued them.

On the CPU every kernel wrapper runs its plain version; this script counts
only the ops dispatched outside the wrappers (B5a-B5g, B6b, the fused Dense
layers), which on the card are the update's own plain-torch launches (the
dW products are ``aten.mm``; a ``copy_`` or ``clone`` of a tensor on one
device is a device copy, not a kernel).  One update of the learning CLI's
agent (paper-fleet widths, obs_dim 49, 8 x 8 heads) at batch 8, through the
agent's per-update step (the update index on the device), after one update
that warms it up.

    python scripts/port_update_ops.py [--root CHECKOUT] [--critic-arch heads]

``--root`` imports the port from another checkout (a parent's ``git
archive``) to list its ops the same way.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import functools
import os
import sys
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

PKG = "distributed_cluster_gpus_tpu_torch"
#: dispatcher ops that launch nothing (views, allocations)
NO_LAUNCH = {
    "aten.empty.memory_format", "aten.empty_strided.default",
    "aten.view.default", "aten._unsafe_view.default", "aten.t.default",
    "aten.transpose.int", "aten.slice.Tensor", "aten.select.int",
    "aten.expand.default", "aten.detach.default", "aten.alias.default",
    "aten.unsqueeze.default", "aten.squeeze.dim", "aten.as_strided.default",
    "aten.lift_fresh.default", "aten.reshape.default",
    "aten.permute.default", "aten.empty_like.default"}
COPIES = {"aten.copy_.default", "aten.clone.default"}
#: the wrappers whose work is a kernel on the card: (module, names)
WRAPPERS = (("sac_update", ("quantile_huber", "marginal_target",
                            "marginal_actor")),
            ("adam", ("adam_update",)), ("replay_sample", ("replay_sample",)),
            ("dense", ("dense_fwd", "dense_dx", "dense_backward",
                       "critic_first_fwd", "actor_heads_fwd")),
            ("log_softmax", ("heads_backward",)))


def count_ops(arch: str = "onehot"):
    """{(op, port source line): count} of one update's ops outside the
    kernels' wrappers, with the ``arch`` critic."""
    import importlib

    depth = [0]
    log = collections.Counter()

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if depth[0] == 0 and name not in NO_LAUNCH:
                site = None
                for fr in reversed(traceback.extract_stack()[:-1]):
                    if PKG in fr.filename and "ops/physics" not in fr.filename:
                        site = (fr.filename.split(PKG + "/")[1]
                                + f":{fr.lineno}")
                        break
                log[(name, site)] += 1
            return out

    def quiet(fn):
        @functools.wraps(fn)
        def w(*a, **k):
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        return w

    for mod, names in WRAPPERS:
        m = importlib.import_module(f"{PKG}.kernels.{mod}")
        for n in names:
            if hasattr(m, n):
                setattr(m, n, quiet(getattr(m, n)))
    from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF

    ag = CHSAC_AF(49, 8, 8, batch=8, warmup=1, critic_arch=arch, device="cpu")
    rng = np.random.default_rng(0)
    N = 64
    ag.ingest_chunk({
        "valid": torch.tensor(rng.random(N) < 0.7),
        "s0": torch.tensor(rng.normal(size=(N, 49)).astype(np.float32)),
        "s1": torch.tensor(rng.normal(size=(N, 49)).astype(np.float32)),
        "a_dc": torch.tensor(rng.integers(0, 8, N).astype(np.int32)),
        "a_g": torch.tensor(rng.integers(0, 8, N).astype(np.int32)),
        "r": torch.tensor(rng.normal(size=N).astype(np.float32)),
        "costs": torch.tensor((rng.random((N, 4)) * 800).astype(np.float32)),
        "mask_dc": torch.ones(N, 8, dtype=torch.bool),
        "mask_g": torch.ones(N, 8, dtype=torch.bool)})
    ag.train_steps(1, 1)  # sets the device-side key chain up, warms up
    with Mode():
        ag._update(False)
    return dict(log)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--critic-arch", default="onehot",
                    choices=("onehot", "heads"))
    a = ap.parse_args()
    root = a.root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.abspath(root))
    ops = count_ops(a.critic_arch)
    kinds = collections.Counter()
    for (name, site), n in sorted(ops.items(), key=lambda kv: (kv[0][1] or "",
                                                              kv[0][0])):
        kind = ("copy" if name in COPIES else
                "matmul" if name.startswith("aten.mm") else "kernel")
        kinds[kind] += n
        print(f"{n:3d} {kind:6s} {name:32s} {site}")
    print(f"{a.critic_arch}: {kinds['kernel']} plain-torch kernels, "
          f"{kinds['copy']} copies, {kinds['matmul']} matmuls (the dW "
          "products) in one update outside the kernels' wrappers")


if __name__ == "__main__":
    main()
