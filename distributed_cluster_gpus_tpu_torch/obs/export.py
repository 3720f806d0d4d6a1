"""``run_summary.json``: the machine-readable end-of-run record.

Counterpart of the sink-less part of ``distributed_cluster_gpus_tpu/obs/
export.py``: :func:`write_run_summary`, :func:`write_status_summary`
(``:159-230``) and :func:`host_phase_seconds` (``:270``), with the
reference's schema.  The totals come from the port's
``evaluation._summarize``; the metric section is empty and the watchdog
fields are null, because the port carries no telemetry yet (the
streaming exporters, the watchdog and the in-loop telemetry are ROADMAP
queue A item 12).  The host loops write it when a run stops early
(``status="interrupted"`` after SIGTERM/SIGINT), with their phase split.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.jsonio import dump_json_atomic

SUMMARY_FILE = "run_summary.json"
SUMMARY_SCHEMA = "dcg.run_summary.v1"

#: run_summary.json ``status`` values: a run either completed, was
#: deliberately aborted by a run-health gate, or was interrupted by
#: SIGTERM/SIGINT and shut down gracefully
RUN_STATUSES = ("completed", "aborted", "interrupted")


def _scalar(x):
    return x.item() if torch.is_tensor(x) else np.asarray(x).item()


def write_run_summary(path: str, *, algo: str, fleet, state,
                      status: str = "completed",
                      host_phases: Optional[Dict] = None) -> Dict:
    """Write the end-of-run record to ``path``; returns it.

    ``totals`` is ``evaluation._summarize(algo, fleet, state).row()``
    itself, so the record and an evaluation of the same state never
    disagree.  ``status`` says how the run ended (:data:`RUN_STATUSES`).
    ``host_phases`` is the host loop's wall seconds by phase
    (:func:`host_phase_seconds`)."""
    from ..evaluation import _summarize

    if status not in RUN_STATUSES:
        raise ValueError(f"unknown run status {status!r}; choices: "
                         f"{RUN_STATUSES}")
    summary = {
        "schema": SUMMARY_SCHEMA,
        "algo": algo,
        "status": status,
        "sim_t_s": float(_scalar(state.t)),
        "n_events": int(_scalar(state.n_events)),
        "totals": _summarize(algo, fleet, state).row(),
        "watchdog": {"mode": "off", "violations": None,
                     "pressure": None},
        "host_phases": {k: round(float(v), 6)
                        for k, v in sorted((host_phases or {}).items())},
        "final_metrics": {},
    }
    dump_json_atomic(path, summary)
    return summary


def write_status_summary(out_dir: str, *, algo: str, fleet, state,
                         status: str,
                         host_phases: Optional[Dict] = None) -> str:
    """``run_summary.json`` in ``out_dir`` for a run without exporters: the
    graceful-shutdown path must leave a machine-readable status.  Returns
    the path written."""
    path = os.path.join(out_dir, SUMMARY_FILE)
    write_run_summary(path, algo=algo, fleet=fleet, state=state,
                      status=status,
                      host_phases=host_phases)
    return path


def host_phase_seconds(timer=None, csv_render_s: Optional[float] = None
                       ) -> Dict[str, float]:
    """A host loop's wall-time split for ``run_summary.json``.

    ``timer`` is the loop's ``obs.trace.PhaseTimer`` (dispatch, rollout,
    io, ingest, train, the trainer's checkpoint saves and restore), each
    phase as ``<phase>_s``; ``csv_render_s`` is the CSV drain worker's
    render time, measured off the loop's path, added to ``io_render_s``."""
    out: Dict[str, float] = {}
    if timer is not None:
        out = {f"{name}_s": secs for name, secs in timer.totals.items()}
    if csv_render_s is not None:
        out["io_render_s"] = out.get("io_render_s", 0.0) + csv_render_s
    return out
