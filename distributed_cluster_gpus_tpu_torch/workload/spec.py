"""Declarative workload scenario specs: arrival streams + energy signals.

Counterpart of ``distributed_cluster_gpus_tpu/workload/spec.py`` (pure
numpy, kept here as the port's own copy).  A :class:`WorkloadSpec` is one
arrival :class:`StreamSpec` per (ingress, jtype) stream plus an optional
:class:`SignalSpec` of time-varying energy-price and carbon-intensity
timelines, which the eco admission and routing, the log rows and the RL
observation read.  ``workload.compiler.WorkloadProgram`` turns it into the
per-chunk arrival tables (B2, ``kernels/arrival_tables.py``) and
``workload.signals.compile_signals`` into device timelines.

Stream kinds: ``off``; ``poisson``; ``sinusoid`` (|amp| <= 1 by
time-change inversion, |amp| > 1 by the sequential thinning replay);
``trace`` (explicit arrival ``times``, optional ``sizes``); and
``rate_timeline`` (a piecewise-constant rate over ``bin_s`` bins, inverted
from its integrated rate).  Specs hold numpy arrays, so they hash and
compare by identity, as ``FleetSpec`` does: build one per run and reuse it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

STREAM_KINDS = ("off", "poisson", "sinusoid", "trace", "rate_timeline")

#: jtype axis order everywhere in the engine: 0 = inference, 1 = training
JTYPE_NAMES = ("inference", "training")


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One arrival stream (one (ingress, jtype) lane of the clock matrix)."""

    kind: str = "off"
    # poisson / sinusoid
    rate: float = 0.0  # mean arrivals/s (sinusoid: carrier rate)
    amp: float = 0.0
    period: float = 3600.0
    phase_s: float = 0.0  # sinusoid phase offset (multi-region staggering)
    # trace
    times: Optional[np.ndarray] = None  # [N] absolute s, non-decreasing
    sizes: Optional[np.ndarray] = None  # [N] work units (optional)
    # rate_timeline
    rates: Optional[np.ndarray] = None  # [T] arrivals/s, piecewise constant
    bin_s: float = 3600.0
    periodic: bool = False  # wrap the timeline instead of clamping to 0

    def __post_init__(self):
        if self.kind not in STREAM_KINDS:
            raise ValueError(
                f"unknown stream kind {self.kind!r}; choices: {STREAM_KINDS}")
        if self.kind == "trace" and self.times is None:
            raise ValueError("trace stream needs a `times` array")
        if self.kind == "rate_timeline" and self.rates is None:
            raise ValueError("rate_timeline stream needs a `rates` array")

    def mean_rate(self) -> float:
        """Long-run arrivals/s (queue-ring sizing; 0 for exhausted traces)."""
        if self.kind == "poisson":
            return max(0.0, self.rate)
        if self.kind == "sinusoid":
            # mean of max(0, r(1+a sin)) over a period; for |a|<=1 it is r
            if abs(self.amp) <= 1.0:
                return max(0.0, self.rate)
            ph = np.linspace(0.0, 2 * np.pi, 512, endpoint=False)
            return float(np.maximum(
                0.0, self.rate * (1.0 + self.amp * np.sin(ph))).mean())
        if self.kind == "rate_timeline":
            return float(np.asarray(self.rates, np.float64).mean())
        if self.kind == "trace":
            t = np.asarray(self.times, np.float64)
            if t.size < 2:
                return 0.0
            span = float(t[-1] - t[0])
            return t.size / span if span > 0 else 0.0
        return 0.0


@dataclasses.dataclass(frozen=True)
class SignalSpec:
    """Time-varying energy price + carbon intensity timelines.

    Both are piecewise-constant over ``bin_s``-wide bins starting at
    t=0; ``periodic=True`` wraps (a 24 h tariff repeats daily — the
    legacy `FleetSpec.price_hourly` semantics), else the last bin
    extends.  ``carbon`` is [T, n_dc] (or [n_dc] for a constant map,
    the legacy `FleetSpec.carbon` semantics).  ``observe=True`` appends
    the sampled price + per-DC carbon to the RL observation vector
    (grows `SimParams.obs_dim` by 1 + n_dc).
    """

    price: Optional[np.ndarray] = None  # [T] USD/kWh
    carbon: Optional[np.ndarray] = None  # [T, n_dc] or [n_dc] gCO2/kWh
    bin_s: float = 3600.0
    periodic: bool = True
    observe: bool = False

    def __post_init__(self):
        if self.price is None and self.carbon is None:
            raise ValueError("SignalSpec needs a price and/or carbon array")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """The full scenario: arrival streams per (ingress, jtype) + signals.

    ``streams`` is either a 2-tuple ``(inference, training)`` broadcast
    over every ingress (the legacy shape), or an [n_ing]-tuple of such
    pairs (multi-region scenarios — per-ingress diurnal phases, regional
    flash crowds).  `resolve(n_ing)` normalizes to the full matrix.
    """

    streams: Tuple  # (inf, trn) | ((inf, trn), ... per ingress)
    signals: Optional[SignalSpec] = None
    name: str = "custom"

    # identity hash/eq (FleetSpec convention): specs carry numpy arrays
    # and ride hashable SimParams — build once, reuse.
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def resolve(self, n_ing: int) -> Tuple[Tuple[StreamSpec, StreamSpec], ...]:
        """Per-(ingress, jtype) stream matrix as an [n_ing] tuple of pairs."""
        s = self.streams
        if len(s) == 2 and isinstance(s[0], StreamSpec):
            return tuple((s[0], s[1]) for _ in range(n_ing))
        if len(s) != n_ing:
            raise ValueError(
                f"workload {self.name!r}: {len(s)} per-ingress stream pairs "
                f"for a fleet with {n_ing} ingresses")
        out = []
        for pair in s:
            if len(pair) != 2:
                raise ValueError(
                    f"workload {self.name!r}: each ingress needs an "
                    "(inference, training) StreamSpec pair")
            out.append((pair[0], pair[1]))
        return tuple(out)

    def mean_rate(self, n_ing: int) -> float:
        """Aggregate arrivals/s across all streams (auto_queue_cap input)."""
        return sum(st.mean_rate()
                   for pair in self.resolve(n_ing) for st in pair)


# ---------------------------------------------------------------------------
# JSON spec files
# ---------------------------------------------------------------------------

def _stream_from_dict(d: dict, where: str) -> StreamSpec:
    known = {"kind", "rate", "amp", "period", "phase_s", "times", "sizes",
             "rates", "bin_s", "periodic"}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"{where}: unknown stream keys {sorted(unknown)}")
    kw = dict(d)
    for arr_key in ("times", "sizes", "rates"):
        if kw.get(arr_key) is not None:
            kw[arr_key] = np.asarray(kw[arr_key], np.float64)
    return StreamSpec(**kw)


def workload_from_dict(doc: dict, n_ing: Optional[int] = None) -> WorkloadSpec:
    """Build a WorkloadSpec from a parsed JSON document.

    Schema:

    .. code-block:: json

        {"name": "...",
         "streams": {"inference": {...}, "training": {...}}
          | [{"ingress": "gw-..." | 0, "inference": {...}, "training": {...}}],
         "signals": {"price": [...], "carbon": [[...]] ,
                     "bin_s": 3600, "periodic": true, "observe": false}}

    The list form needs ``n_ing`` (and covers every ingress exactly
    once when entries carry integer indices; `load_workload_json`
    resolves ingress *names* against a fleet first).
    """
    known = {"name", "streams", "signals"}
    unknown = set(doc) - known
    if unknown:
        raise ValueError(f"unknown top-level keys {sorted(unknown)}")
    if "streams" not in doc:
        raise ValueError("spec needs a 'streams' section")
    name = doc.get("name", "custom")
    raw = doc["streams"]
    if isinstance(raw, dict):
        unknown = set(raw) - {"inference", "training"}
        if unknown:
            raise ValueError(
                f"{name}: unknown stream-section keys {sorted(unknown)} "
                "(expected 'inference'/'training' — a typo here would "
                "silently drop the stream)")
        streams = (
            _stream_from_dict(raw.get("inference", {"kind": "off"}),
                              f"{name}/inference"),
            _stream_from_dict(raw.get("training", {"kind": "off"}),
                              f"{name}/training"),
        )
    else:
        if n_ing is None:
            raise ValueError("per-ingress stream list needs the fleet shape "
                             "(n_ing) to resolve against")
        pairs = [None] * n_ing
        for i, entry in enumerate(raw):
            unknown = set(entry) - {"ingress", "inference", "training"}
            if unknown:
                raise ValueError(
                    f"{name}: stream entry {i} has unknown keys "
                    f"{sorted(unknown)} (expected ingress/inference/"
                    "training)")
            idx = entry.get("ingress", i)
            if not isinstance(idx, int) or not 0 <= idx < n_ing:
                raise ValueError(
                    f"{name}: stream entry {i} has unresolved ingress "
                    f"{entry.get('ingress')!r} (need an index in "
                    f"[0, {n_ing}))")
            if pairs[idx] is not None:
                raise ValueError(f"{name}: duplicate streams for ingress {idx}")
            pairs[idx] = (
                _stream_from_dict(entry.get("inference", {"kind": "off"}),
                                  f"{name}/ing{idx}/inference"),
                _stream_from_dict(entry.get("training", {"kind": "off"}),
                                  f"{name}/ing{idx}/training"),
            )
        off = StreamSpec(kind="off")
        streams = tuple(p if p is not None else (off, off) for p in pairs)
    signals = None
    if doc.get("signals") is not None:
        sd = dict(doc["signals"])
        unknown = set(sd) - {"price", "carbon", "bin_s", "periodic", "observe"}
        if unknown:
            raise ValueError(f"unknown signal keys {sorted(unknown)}")
        for k in ("price", "carbon"):
            if sd.get(k) is not None:
                sd[k] = np.asarray(sd[k], np.float64)
        signals = SignalSpec(**sd)
    return WorkloadSpec(streams=streams, signals=signals, name=name)


def load_workload_json(path: str, fleet=None) -> WorkloadSpec:
    """Load a spec file, resolving ingress names against ``fleet``."""
    with open(path) as f:
        doc = json.load(f)
    n_ing = None
    if fleet is not None:
        n_ing = fleet.n_ing
        raw = doc.get("streams")
        if isinstance(raw, list):
            for entry in raw:
                ing = entry.get("ingress")
                if isinstance(ing, str):
                    if ing not in fleet.ingress_names:
                        raise ValueError(
                            f"{path}: unknown ingress {ing!r}; fleet has "
                            f"{', '.join(fleet.ingress_names)}")
                    entry["ingress"] = fleet.ingress_names.index(ing)
    spec = workload_from_dict(doc, n_ing=n_ing)
    if doc.get("name") is None:
        spec = dataclasses.replace(spec, name=path)
    return spec
