"""Declarative workload scenario specs: one arrival stream per (ingress, jtype).

Counterpart of the parts of ``distributed_cluster_gpus_tpu/workload/spec.py``
that ``workload.compiler.legacy_spec`` builds: :class:`StreamSpec` for the
synthetic kinds (``off``, ``poisson``, ``sinusoid``) and
:class:`WorkloadSpec` without energy signals.  Trace replay, rate
timelines, signal timelines and JSON spec files are ROADMAP queue A item 4.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

STREAM_KINDS = ("off", "poisson", "sinusoid", "trace", "rate_timeline")
PORTED_KINDS = ("off", "poisson", "sinusoid")


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One arrival stream (one (ingress, jtype) lane of the clock matrix)."""

    kind: str = "off"
    rate: float = 0.0
    amp: float = 0.0
    period: float = 3600.0
    phase_s: float = 0.0

    def __post_init__(self):
        if self.kind not in STREAM_KINDS:
            raise ValueError(
                f"unknown stream kind {self.kind!r}; choices: {STREAM_KINDS}")
        if self.kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"stream kind {self.kind!r} is not ported yet (ROADMAP "
                "queue A item 4: trace and rate_timeline streams)")

    def mean_rate(self) -> float:
        """Long-run arrivals/s (queue-ring sizing)."""
        if self.kind == "poisson":
            return max(0.0, self.rate)
        if self.kind == "sinusoid":
            if abs(self.amp) <= 1.0:
                return max(0.0, self.rate)
            ph = np.linspace(0.0, 2 * np.pi, 512, endpoint=False)
            return float(np.maximum(
                0.0, self.rate * (1.0 + self.amp * np.sin(ph))).mean())
        return 0.0


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Arrival streams: an (inference, training) StreamSpec pair broadcast
    over every ingress.  Per-ingress pairs are ROADMAP queue A item 4."""

    streams: Tuple[StreamSpec, StreamSpec]
    name: str = "custom"

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def resolve(self, n_ing: int) -> Tuple[Tuple[StreamSpec, StreamSpec], ...]:
        """Per-(ingress, jtype) stream matrix as an [n_ing] tuple of pairs."""
        inf, trn = self.streams
        return tuple((inf, trn) for _ in range(n_ing))

    def mean_rate(self, n_ing: int) -> float:
        return sum(st.mean_rate()
                   for pair in self.resolve(n_ing) for st in pair)
