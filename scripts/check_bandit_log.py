"""Hold the port's float32 log (the bandit's ``ln t``) to XLA's on every
float32 in [1, 2^24].

    JAX_PLATFORMS=cpu python scripts/check_bandit_log.py [--step-bits 23]

``distributed_cluster_gpus_tpu_torch/ops/bandit.py::xla_log_f32`` writes out
the polynomial XLA's CPU code evaluates for ``jnp.log``; this script runs
both over every float32 bit pattern from 1.0 to 2^24 (201,326,593 values,
in blocks of 2^STEP_BITS) and prints the count and the first of any that
differ, with torch's own ``log`` beside it for scale.  CPU only; about three
minutes on one core.
"""

import argparse
import os
import sys
import time

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from distributed_cluster_gpus_tpu_torch.ops.bandit import xla_log_f32  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step-bits", type=int, default=23)
    a = ap.parse_args()
    log_j = jax.jit(jnp.log)
    lo = int(np.float32(1.0).view(np.int32))
    hi = int(np.float32(2.0 ** 24).view(np.int32))
    step = 1 << a.step_bits
    t0 = time.time()
    n = bad = bad_torch = 0
    first = None
    for s in range(lo, hi + 1, step):
        bits = np.arange(s, min(s + step, hi + 1), dtype=np.int32)
        x = bits.view(np.float32)
        want = np.asarray(log_j(x)).view(np.int32)
        got = xla_log_f32(torch.from_numpy(x)).numpy().view(np.int32)
        diff = want != got
        if first is None and diff.any():
            first = float(x[np.argmax(diff)])
        bad += int(diff.sum())
        bad_torch += int((torch.log(torch.from_numpy(x)).numpy().view(np.int32)
                          != want).sum())
        n += len(bits)
    print(f"{n} float32 values in [1, 2^24]: xla_log_f32 differs from jnp.log "
          f"at {bad} (first {first}); torch.log at {bad_torch}; "
          f"{time.time() - t0:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
