"""Host side of the run loop: the CSV writers, the drain and the loops.

Counterpart of ``distributed_cluster_gpus_tpu/sim/io.py``: ``cluster_log.csv``
and ``job_log.csv`` in the reference's schemas and formatting, rendered by
the native writer (``csrc/csv_writer.cpp`` through ``utils/native.py``;
the Python renderer stays as its plain version, byte for byte the same),
``drain_emissions`` over host arrays, the bounded background drain
(``AsyncLineDrain``, ``AsyncCSVDrain``) and ``run_simulation``: pipelined
(chunk N+1 dispatched before chunk N's rows are rendered, on the drain's
worker) without a hook, serial with one.  A shutdown flag
(``utils/shutdown.py``) stops either loop after the chunk in flight has
drained, so the CSVs are a byte prefix of the uninterrupted run's, and
``run_summary.json`` says ``status="interrupted"`` with the loop's phase
split.  The writers' byte offsets are the checkpoints' CSV watermark: a
resumed run truncates both files back to them and appends.  The telemetry
sink is ROADMAP queue A item 12's.
"""

from __future__ import annotations

import csv
import ctypes
import errno
import os
import queue
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.structs import FleetSpec, SimParams, SimState
from ..obs.trace import PhaseTimer, sim_progress
from .engine import Engine, init_state
from .step import CLUSTER_COLS, JOB_COLS, SIGNAL_CLUSTER_COLS

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

    Rows render through the native writer (``utils/native.py``; a failed
    build raises).  ``plain=True`` renders through Python's ``csv`` module
    instead: the plain version the tests hold the native writer to.
    ``append=True`` keeps existing rows and writes headers only for files
    that do not exist yet: a run resumed from a checkpoint keeps the log
    prefix written before it stopped.  ``signal_cols`` appends the signal
    timelines' two columns (``SIGNAL_CLUSTER_COLS``) to the cluster rows."""

    def __init__(self, out_dir: str, fleet: FleetSpec, append: bool = False,
                 plain: bool = False, signal_cols: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.fleet = fleet
        self.signal_cols = signal_cols
        self.cols = CLUSTER_COLS + (SIGNAL_CLUSTER_COLS if signal_cols else ())
        self.cluster_path = os.path.join(out_dir, "cluster_log.csv")
        self.job_path = os.path.join(out_dir, "job_log.csv")
        self._lib = None
        if not plain:
            from ..utils.native import csv_writer_lib

            self._lib = csv_writer_lib()
        self._dc_blob = "\n".join(fleet.dc_names).encode()
        self._ing_blob = "\n".join(fleet.ingress_names).encode()
        cluster_header = CLUSTER_HEADER + (list(SIGNAL_CLUSTER_COLS)
                                           if signal_cols else [])
        for path, header in ((self.cluster_path, cluster_header),
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
        c = dict(zip(self.cols, row))
        out = [
            f"{c['time_s']:.3f}", name, f"{c['freq']:.2f}",
            int(c["busy"]), int(c["free"]), int(c["run_total"]),
            int(c["run_inf"]), int(c["run_train"]),
            int(c["q_inf"]), int(c["q_train"]),
            f"{c['util_inst']:.4f}", f"{c['util_avg']:.4f}",
            f"{c['acc_job_unit']:.4f}",
            f"{c['power_W']:.2f}", f"{c['energy_kJ']:.4f}",
        ]
        if self.signal_cols:
            out += [f"{c['price_usd_kwh']:.4f}", f"{c['carbon_g_kwh']:.2f}"]
        w.writerow(out)

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

    def _native(self, fn, path: str, rows: np.ndarray, *args) -> None:
        n = fn(path.encode(), rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               *args)
        if n < 0:
            err = ctypes.get_errno() or errno.EIO
            raise OSError(err, f"native CSV writer: {os.strerror(err)}", path)

    def write_cluster_chunk(self, cluster: np.ndarray, idxs) -> None:
        """Append the log ticks ``idxs`` of one chunk's [n, n_dc, 14] rows
        ([n, n_dc, 16] with ``signal_cols``)."""
        if self._lib is None:
            with open(self.cluster_path, "a", newline="") as f:
                w = csv.writer(f)
                for i in idxs:
                    for d, name in enumerate(self.fleet.dc_names):
                        self._cluster_row(w, cluster[i, d], name)
            return
        rows = np.ascontiguousarray(np.asarray(cluster)[np.asarray(idxs)],
                                    np.float32)
        if rows.shape[1:] != (self.fleet.n_dc, len(self.cols)):
            raise ValueError(f"cluster rows of shape {rows.shape[1:]}, "
                             f"expected {(self.fleet.n_dc, len(self.cols))}")
        self._native(self._lib.write_cluster_rows, self.cluster_path, rows,
                     rows.shape[0], rows.shape[1], self._dc_blob,
                     len(self.cols))

    def write_job_chunk(self, jobs: np.ndarray, idxs) -> None:
        """Append the rows ``idxs`` of one chunk's [n, 15] job rows."""
        if self._lib is None:
            with open(self.job_path, "a", newline="") as f:
                w = csv.writer(f)
                for i in idxs:
                    self._job_row(w, jobs[i])
            return
        rows = np.ascontiguousarray(np.asarray(jobs)[np.asarray(idxs)],
                                    np.float32)
        if rows.shape[1:] != (len(JOB_COLS),):
            raise ValueError(f"job rows of shape {rows.shape[1:]}, expected "
                             f"{(len(JOB_COLS),)}")
        self._native(self._lib.write_job_rows, self.job_path, rows,
                     rows.shape[0], self._ing_blob, self._dc_blob)


#: the emission fields the CSV drain reads
CSV_FIELDS = ("cluster_valid", "job_valid", "cluster", "job")


def drain_emissions(emissions: Dict, writers: Optional[CSVWriters]) -> Dict[str, int]:
    """Filter one chunk of per-step emissions on the host; write the valid
    rows.  Host arrays (:meth:`HostChunk.emissions`) pass through; tensors
    come to the host in one batched copy.  Returns {"cluster_rows": ...,
    "job_rows": ...}."""
    em = {k: emissions[k] for k in CSV_FIELDS}
    if torch.is_tensor(em["cluster_valid"]):
        em = HostChunk(em).emissions()
    cl_idx = np.nonzero(em["cluster_valid"])[0]
    job_idx = np.nonzero(em["job_valid"])[0]
    if writers is not None:
        if len(cl_idx):
            writers.write_cluster_chunk(em["cluster"], cl_idx)
        if len(job_idx):
            writers.write_job_chunk(em["job"], job_idx)
    return {"cluster_rows": int(len(cl_idx)), "job_rows": int(len(job_idx))}


class HostChunk:
    """Tensors of one chunk copied to the host as soon as they are queued:
    the CSV fields and, in the pipelined loop, its scalars (``done``,
    ``t``, ``n_events``; :meth:`of`).

    On the card the copies are queued on the current stream into pinned
    buffers (``non_blocking``) and an event is recorded after them, so they
    run when the chunk's kernels have finished and before the next chunk's
    launches: the state is advanced in place, and the next dispatch
    overwrites ``done``, ``t`` and ``n_events``.  :meth:`wait` waits on
    that event, not on the device.  On the CPU the copies are made at
    once."""

    @classmethod
    def of(cls, emissions: Dict, state: SimState) -> "HostChunk":
        return cls({**{k: emissions[k] for k in CSV_FIELDS}, "done": state.done,
                    "t": state.t, "n_events": state.n_events})

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        dev = tensors["cluster_valid"].device
        pinned = dev.type == "cuda"
        self.host = {}
        for k, v in tensors.items():
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=pinned)
            h.copy_(v, non_blocking=pinned)
            self.host[k] = h
        self._event = None
        if pinned:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))

    def wait(self) -> "HostChunk":
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self

    def emissions(self) -> Dict[str, np.ndarray]:
        return {k: self.wait().host[k].numpy() for k in CSV_FIELDS}

    def scalar(self, name: str):
        return self.wait().host[name].item()


class AsyncLineDrain:
    """Bounded background renderer: one worker thread, FIFO.

    The worker runs ``drain_fn(item)`` for each submitted host-side item in
    order (so the output is byte for byte a serial drain's).  The queue
    holds at most ``MAXSIZE`` items: a loop that outruns the disk blocks
    in :meth:`submit` instead of buffering without bound.  A worker error
    is re-raised on the next :meth:`submit`, :meth:`flush` or
    :meth:`close`: a failed write must not silently truncate the output.

    ``render_seconds`` sums the worker's wall time (the host io the
    pipelined ``run_simulation`` hides behind the device); ``rows`` sums
    the counter dicts ``drain_fn`` returns.

    Transient IO errors (EINTR: a signal landed mid-write, such as the
    graceful-shutdown SIGTERM; EAGAIN/EWOULDBLOCK: a saturated pipe or
    mount) are retried ``IO_RETRIES`` times with exponential backoff; any
    other error (ENOSPC, EIO, a render bug) propagates at once.  A retry
    runs ``drain_fn`` from the top, so after a partial write it may repeat
    the interrupted row."""

    #: errnos worth retrying: the call was interrupted, not refused
    TRANSIENT_ERRNOS = frozenset(
        {errno.EINTR, errno.EAGAIN, errno.EWOULDBLOCK})
    #: the queue's bound, in items
    MAXSIZE = 4
    #: retries of a transient error, and the first retry's backoff
    IO_RETRIES = 3
    IO_BACKOFF_S = 0.05
    #: what a deferred error and the worker thread are called
    NAME = "line drain"

    def __init__(self, drain_fn):
        self._drain_fn = drain_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=self.MAXSIZE)
        self._err: Optional[BaseException] = None
        self._abort = False
        self.io_retry_count = 0
        self.render_seconds = 0.0
        self.rows: Dict[str, int] = {}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=self.NAME.replace(" ", "-"))
        self._worker.start()

    def _render_with_retry(self, item):
        for attempt in range(self.IO_RETRIES + 1):
            try:
                return self._drain_fn(item)
            except OSError as e:
                if (e.errno not in self.TRANSIENT_ERRNOS
                        or attempt == self.IO_RETRIES):
                    raise
                self.io_retry_count += 1
                time.sleep(self.IO_BACKOFF_S * (2 ** attempt))

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                # the sentinel is accounted too: a flush() after close()
                # returns instead of joining a queue that cannot drain
                self._q.task_done()
                return
            t0 = time.perf_counter()
            try:
                if self._err is None and not self._abort:
                    stats = self._render_with_retry(item)
                    for k, v in (stats or {}).items():
                        self.rows[k] = self.rows.get(k, 0) + v
            except BaseException as e:  # noqa: BLE001 - handed to the loop
                self._err = e
            finally:
                self.render_seconds += time.perf_counter() - t0
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(f"background {self.NAME} failed") from err

    def submit(self, item) -> None:
        """Enqueue one host-side item."""
        self._check()
        self._q.put(item)

    def flush(self) -> None:
        """Block until every submitted item is rendered (a byte watermark
        read while items are queued would miss rows written moments
        later); a deferred worker error surfaces here."""
        self._q.join()
        self._check()

    def close(self, abort: bool = False) -> None:
        """Render what is queued, stop the worker, re-raise a deferred
        error.  ``abort=True`` (the caller is unwinding an exception): the
        queued items are dropped, and a deferred error is swallowed so it
        cannot replace the exception in flight."""
        if abort:
            self._abort = True
        self._q.put(None)
        self._worker.join()
        if not abort:
            self._check()


class AsyncCSVDrain(AsyncLineDrain):
    """:class:`AsyncLineDrain` rendering emission chunks into the CSVs:
    ``drain_fn(emissions, writers)``, :func:`drain_emissions` by default."""

    NAME = "CSV drain"

    def __init__(self, writers: Optional[CSVWriters], drain_fn=None):
        self.writers = writers
        fn = drain_fn or drain_emissions
        super().__init__(lambda em: fn(em, writers))
        self.rows = {"cluster_rows": 0, "job_rows": 0}


def run_simulation(fleet: FleetSpec, params: SimParams,
                   out_dir: Optional[str] = None, chunk_steps: int = 4096,
                   max_chunks: int = 10_000, device="cuda",
                   pre_tables: Optional[Sequence[Dict]] = None,
                   on_chunk=None, state0: Optional[SimState] = None,
                   engine: Optional[Engine] = None,
                   progress: bool = False, shutdown=None,
                   timer: Optional[PhaseTimer] = None) -> SimState:
    """Host loop: run chunks until the simulation clock passes its end.

    Pipelined without ``on_chunk``: chunk N+1 is dispatched before chunk
    N's rows are rendered, and the rendering runs on a bounded background
    worker (:class:`AsyncCSVDrain`), so a chunk's wall is about the larger
    of the device's chunk and the host's render, plus the dispatch.  Each
    chunk's CSV fields and scalars are copied to the host as it is
    dispatched (:class:`HostChunk`); the loop waits on those copies, not on
    the device, before it decides on the next dispatch (``done``).  The
    emission stream and the final state are the serial loop's (same
    chunks, same order; the worker is FIFO), so the CSV bytes are too.

    With ``on_chunk(state, emissions, engine)``, called after each chunk's
    drain, the loop is serial, as the reference's hooked loop is.
    ``pre_tables`` injects each chunk's arrival tables in order (the test
    seam that feeds the reference's tables); None builds them per chunk.
    ``progress`` prints the reference's line after each chunk (the
    simulated-time bar and the event count) and the timer's summary at
    exit.  ``timer`` (an ``obs.trace.PhaseTimer``, a new one if None)
    takes the phases: "dispatch" (enqueueing a chunk), "rollout" (waiting
    for it), "io" (the handoff to the worker) and "io_render" (the
    worker's render seconds, off the loop's path); the serial loop's are
    "rollout" (fenced on the state) and "io".  ``shutdown`` (a
    ``utils.shutdown.ShutdownFlag``): once it trips, the loop stops after
    the chunk in flight has drained, so the CSVs are a byte prefix of the
    uninterrupted run's, and writes ``run_summary.json`` with
    ``status="interrupted"`` and the phase split into ``out_dir``.  Any
    exception drops the worker's queue and propagates.  Returns the final
    SimState (on ``device``)."""
    engine = engine if engine is not None else Engine(fleet, params, device=device)
    state = (state0 if state0 is not None
             else init_state(params.seed, fleet, params,
                             workload=engine.workload, device=engine.device))
    writers = (CSVWriters(out_dir, fleet,
                          signal_cols=engine.signals is not None)
               if out_dir else None)
    timer = PhaseTimer() if timer is None else timer

    def tables(c):
        if pre_tables is None:
            return None
        return {k: torch.tensor(np.asarray(v), device=engine.device)
                for k, v in pre_tables[c].items()}

    def interrupted() -> bool:
        return shutdown is not None and shutdown.requested

    def write_status(status: str) -> None:
        if out_dir:
            from ..obs.export import host_phase_seconds, write_status_summary

            write_status_summary(out_dir, algo=params.algo, fleet=fleet,
                                 state=state, status=status,
                                 host_phases=host_phase_seconds(timer))

    def report(t, n_events):
        if progress:
            print(sim_progress(t, params.duration, extra=f"events={n_events}"))

    if on_chunk is not None:
        status = "completed"
        for c in range(max_chunks):
            with timer.phase("rollout", fence=lambda: state.t):
                state, emissions = engine.run_chunk(state, chunk_steps,
                                                    pre=tables(c))
            with timer.phase("io"):
                drain_emissions(emissions, writers)
            on_chunk(state, emissions, engine)
            report(float(state.t), int(state.n_events))
            if bool(state.done):
                break
            if interrupted():
                status = "interrupted"
                break
        if status != "completed":
            write_status(status)
        if progress:
            print(timer.summary())
        return state

    drainer = AsyncCSVDrain(writers)
    prev: Optional[HostChunk] = None
    status = "completed"
    try:
        for c in range(max_chunks):
            with timer.phase("dispatch"):
                state, emissions = engine.run_chunk(state, chunk_steps,
                                                    pre=tables(c))
                host = HostChunk.of(emissions, state)
            if prev is not None:
                # chunk N-1's copies finished in its rollout wait
                with timer.phase("io"):
                    drainer.submit(prev.emissions())
            prev = host
            # waits for the chunk just dispatched: the device's time, the
            # previous chunk's render running on the worker meanwhile
            with timer.phase("rollout"):
                done = bool(host.scalar("done"))
            report(host.scalar("t"), host.scalar("n_events"))
            if done:
                break
            if interrupted():
                status = "interrupted"
                break
        if prev is not None:
            with timer.phase("io"):
                drainer.submit(prev.emissions())
    except BaseException:
        # already unwinding: drop the queue, and keep a deferred writer
        # error from replacing the exception in flight
        drainer.close(abort=True)
        raise
    else:
        drainer.close()
    finally:
        timer.add_span("io_render", drainer.render_seconds)
    if status != "completed":
        write_status(status)
    if progress:
        print(timer.summary())
    return state
