"""Host-side emission drain and the serial run loop.

Counterpart of ``distributed_cluster_gpus_tpu/sim/io.py``: ``cluster_log.csv``
and ``job_log.csv`` in the reference's schemas and formatting (the Python
rendering path, which the JAX package's tests pin byte-identical to its
native writer), ``drain_emissions`` and a serial ``run_simulation`` that
stops at a chunk boundary when a shutdown flag trips (``utils/shutdown.py``)
and then writes ``run_summary.json`` with ``status="interrupted"``.  The
writers' byte offsets are the checkpoints' CSV watermark: a resumed run
truncates both files back to them and appends.  The pipelined background
drain and the telemetry sink are ROADMAP queue A items 7 and 12.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.structs import FleetSpec, SimParams, SimState
from .engine import Engine, init_state
from .step import CLUSTER_COLS, JOB_COLS

CLUSTER_HEADER = [
    "time_s", "dc", "freq", "busy", "free", "run_total", "run_inf", "run_train",
    "q_inf", "q_train", "util_inst", "util_avg", "acc_job_unit", "power_W",
    "energy_kJ",
]
JOB_HEADER = [
    "jid", "ingress", "type", "size", "dc", "f_used", "n_gpus", "net_lat_s",
    "start_s", "finish_s", "latency_s", "preempt_count", "T_pred", "P_pred",
    "E_pred",
]


class CSVWriters:
    """cluster_log.csv + job_log.csv in ``out_dir`` (reference formatting).

    ``append=True`` keeps existing rows and writes headers only for files
    that do not exist yet: a run resumed from a checkpoint keeps the log
    prefix written before it stopped."""

    def __init__(self, out_dir: str, fleet: FleetSpec, append: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.fleet = fleet
        self.cluster_path = os.path.join(out_dir, "cluster_log.csv")
        self.job_path = os.path.join(out_dir, "job_log.csv")
        for path, header in ((self.cluster_path, CLUSTER_HEADER),
                             (self.job_path, JOB_HEADER)):
            if append and os.path.exists(path):
                continue
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(header)

    # The byte offsets after the last drained chunk are a watermark: a
    # resumed run truncates both files back to the offsets its checkpoint
    # recorded, dropping rows a stopped or crashed run appended past its
    # last checkpoint (those chunks run again and would appear twice).

    def offsets(self) -> Dict[str, int]:
        return {"cluster": os.path.getsize(self.cluster_path),
                "job": os.path.getsize(self.job_path)}

    def truncate_to(self, offsets: Dict[str, int]) -> None:
        for path, key in ((self.cluster_path, "cluster"),
                          (self.job_path, "job")):
            size = os.path.getsize(path)
            want = int(offsets[key])
            if 0 < want < size:
                os.truncate(path, want)

    def _cluster_row(self, w, row: np.ndarray, name: str):
        c = dict(zip(CLUSTER_COLS, row))
        w.writerow([
            f"{c['time_s']:.3f}", name, f"{c['freq']:.2f}",
            int(c["busy"]), int(c["free"]), int(c["run_total"]),
            int(c["run_inf"]), int(c["run_train"]),
            int(c["q_inf"]), int(c["q_train"]),
            f"{c['util_inst']:.4f}", f"{c['util_avg']:.4f}",
            f"{c['acc_job_unit']:.4f}",
            f"{c['power_W']:.2f}", f"{c['energy_kJ']:.4f}",
        ])

    def _job_row(self, w, row: np.ndarray):
        c = dict(zip(JOB_COLS, row))
        jtype = "inference" if int(c["type"]) == 0 else "training"
        w.writerow([
            int(c["jid"]),
            self.fleet.ingress_names[int(c["ingress"])],
            jtype, f"{c['size']:.4f}",
            self.fleet.dc_names[int(c["dc"])],
            f"{c['f_used']:.3f}", int(c["n_gpus"]),
            f"{c['net_lat_s']:.4f}",
            f"{c['start_s']:.6f}", f"{c['finish_s']:.6f}",
            f"{c['latency_s']:.6f}", int(c["preempt_count"]),
            f"{c['T_pred']:.6f}", f"{c['P_pred']:.2f}", f"{c['E_pred']:.2f}",
        ])

    def write_cluster_chunk(self, cluster: np.ndarray, idxs) -> None:
        with open(self.cluster_path, "a", newline="") as f:
            w = csv.writer(f)
            for i in idxs:
                for d, name in enumerate(self.fleet.dc_names):
                    self._cluster_row(w, cluster[i, d], name)

    def write_job_chunk(self, jobs: np.ndarray, idxs) -> None:
        with open(self.job_path, "a", newline="") as f:
            w = csv.writer(f)
            for i in idxs:
                self._job_row(w, jobs[i])


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def drain_emissions(emissions: Dict, writers: Optional[CSVWriters]) -> Dict[str, int]:
    """Filter one chunk of per-step emissions and write the valid rows.

    Returns {"cluster_rows": ..., "job_rows": ...}.  Only the rows that are
    written are copied to the host."""
    cl_valid = _host(emissions["cluster_valid"])
    job_valid = _host(emissions["job_valid"])
    cl_idx = np.nonzero(cl_valid)[0]
    job_idx = np.nonzero(job_valid)[0]
    stats = {"cluster_rows": int(len(cl_idx)), "job_rows": int(len(job_idx))}
    if writers is None:
        return stats
    if len(cl_idx):
        rows = _host(emissions["cluster"][torch.as_tensor(cl_idx)]
                     if torch.is_tensor(emissions["cluster"])
                     else np.asarray(emissions["cluster"])[cl_idx])
        writers.write_cluster_chunk(rows, range(len(cl_idx)))
    if len(job_idx):
        rows = _host(emissions["job"][torch.as_tensor(job_idx)]
                     if torch.is_tensor(emissions["job"])
                     else np.asarray(emissions["job"])[job_idx])
        writers.write_job_chunk(rows, range(len(job_idx)))
    return stats


def sim_progress(t: float, end: float, extra: str = "",
                 width: int = 40) -> str:
    """The reference's one-line progress string over simulated time
    (``distributed_cluster_gpus_tpu/obs/trace.py:232``)."""
    frac = min(1.0, max(0.0, t / max(end, 1e-9)))
    filled = int(frac * width)
    bar = "#" * filled + "-" * (width - filled)
    return f"[{bar}] sim {t:,.0f}/{end:,.0f}s ({100 * frac:5.1f}%) {extra}"


def run_simulation(fleet: FleetSpec, params: SimParams,
                   out_dir: Optional[str] = None, chunk_steps: int = 4096,
                   max_chunks: int = 10_000, device="cuda",
                   pre_tables: Optional[Sequence[Dict]] = None,
                   on_chunk=None, state0: Optional[SimState] = None,
                   engine: Optional[Engine] = None,
                   progress: bool = False, shutdown=None) -> SimState:
    """Serial host loop: run chunks until the simulation clock passes its end.

    ``pre_tables`` injects each chunk's arrival tables in order (the test
    seam that feeds the reference's tables); None builds them per chunk.
    ``on_chunk(state, emissions, engine)`` is called after each chunk's
    drain.  ``progress`` prints the reference's line after each chunk (the
    simulated-time bar and the event count).  ``shutdown`` (a
    ``utils.shutdown.ShutdownFlag``): once it trips, the loop stops after
    the chunk in flight has drained, so the CSVs are a byte prefix of the
    uninterrupted run's, and writes ``run_summary.json`` with
    ``status="interrupted"`` into ``out_dir``.  Returns the final SimState
    (on ``device``)."""
    engine = engine if engine is not None else Engine(fleet, params, device=device)
    state = (state0 if state0 is not None
             else init_state(params.seed, fleet, params,
                             workload=engine.workload, device=engine.device))
    writers = CSVWriters(out_dir, fleet) if out_dir else None
    for c in range(max_chunks):
        pre = None
        if pre_tables is not None:
            pre = {k: torch.tensor(np.asarray(v), device=engine.device)
                   for k, v in pre_tables[c].items()}
        state, emissions = engine.run_chunk(state, chunk_steps, pre=pre)
        drain_emissions(emissions, writers)
        if on_chunk is not None:
            on_chunk(state, emissions, engine)
        if progress:
            print(sim_progress(float(state.t), params.duration,
                               extra=f"events={int(state.n_events)}"))
        if bool(state.done):
            break
        if shutdown is not None and shutdown.requested:
            if out_dir:
                from ..obs.export import write_status_summary

                write_status_summary(out_dir, algo=params.algo, fleet=fleet,
                                     state=state, status="interrupted")
            break
    return state
