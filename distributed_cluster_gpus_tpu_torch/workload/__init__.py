"""workload/: compiled arrival streams and time-varying energy signals.

Declarative scenario specs (``spec.WorkloadSpec``: synthetic Poisson or
sinusoid streams, replayed traces, piecewise rate timelines, the presets,
price and carbon signal timelines) become the per-chunk arrival tables the
event scan reads by cursor (``compiler.WorkloadProgram``, B2 on the card)
and the device timelines the eco decisions, log rows and RL observation
sample (``signals.CompiledSignals``).
"""

from .compiler import WorkloadProgram, compile_workload, legacy_spec
from .presets import PRESETS, make_preset
from .signals import CompiledSignals, compile_signals, legacy_signals
from .spec import (
    STREAM_KINDS,
    SignalSpec,
    StreamSpec,
    WorkloadSpec,
    load_workload_json,
    workload_from_dict,
)

__all__ = [
    "WorkloadProgram", "compile_workload", "legacy_spec",
    "PRESETS", "make_preset",
    "CompiledSignals", "compile_signals", "legacy_signals",
    "STREAM_KINDS", "SignalSpec", "StreamSpec", "WorkloadSpec",
    "load_workload_json", "workload_from_dict",
]
