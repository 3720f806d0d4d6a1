"""Phase timers and the progress line of the host loops.

Counterpart of ``PhaseTimer`` (``distributed_cluster_gpus_tpu/obs/trace.py:
37-92``) and ``sim_progress`` (``:232``).  Every host loop of the port
(``sim/io.py::run_simulation``, ``rl/train.py::train_chsac``) times its
phases through a :class:`PhaseTimer`: ``dispatch``, ``rollout``, ``io``
and ``io_render`` (the drain worker's render time) in the pipelined loop;
``rollout``, ``io``, ``ingest`` and ``train`` in the serial ones.  A phase
with a fence ends when the device work behind the fence's tensors has
finished, so the device time lands in the phase that waited for it.  The
chrome-trace export is ROADMAP queue A item 12's.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def block_until_ready(x) -> None:
    """Wait for the device work queued so far behind the CUDA tensors of
    ``x`` (a tensor, or a dict, list or tuple of them): an event recorded
    on each of their devices' current stream and synchronized.  CPU
    tensors are ready when they exist."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class PhaseTimer:
    """Wall seconds (``totals``) and entries (``counts``) per phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        """Time the enclosed block.  ``fence`` is a zero-argument callable
        returning the tensor(s) to wait for, called when the block exits (a
        tensor taken before the block would be the state before it)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                block_until_ready(fence())
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add_span(self, name: str, seconds: float) -> None:
        """Add a span measured elsewhere (the drain worker's render time)."""
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values()) or 1.0
        return "\n".join(
            f"{name:>12s}: {secs:8.3f}s ({100 * secs / total:5.1f}%) "
            f"x{self.counts[name]}"
            for name, secs in rows)


def sim_progress(t: float, end: float, extra: str = "",
                 width: int = 40) -> str:
    """One-line progress string over simulated time (the reference's)."""
    frac = min(1.0, max(0.0, t / max(end, 1e-9)))
    filled = int(frac * width)
    bar = "#" * filled + "-" * (width - filled)
    return f"[{bar}] sim {t:,.0f}/{end:,.0f}s ({100 * frac:5.1f}%) {extra}"
