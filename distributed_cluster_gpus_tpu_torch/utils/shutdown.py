"""Graceful SIGTERM/SIGINT shutdown for the host loops.

Counterpart of ``distributed_cluster_gpus_tpu/utils/shutdown.py`` (a copy).
A preempted job, a Ctrl-C or a scheduler's eviction should not strand
buffered CSV rows, half-written checkpoints or a missing
``run_summary.json``.  The contract:

* :func:`graceful_shutdown` installs signal handlers that only SET A
  FLAG (:class:`ShutdownFlag`): no exception is thrown into arbitrary
  stack frames, so kernel launches, checkpoint saves and CSV writes are
  never interrupted mid-operation.
* The host loops (``sim.io.run_simulation``, ``rl.train.train_chsac``)
  poll the flag once per chunk boundary; when it is set they stop, flush
  the CSVs, save a final checkpoint (the trainer), and write
  ``run_summary.json`` with ``status="interrupted"``.
* The CLI (``run_sim.py``) then exits nonzero (``128 + signum``, the
  shell convention), so schedulers and wrappers see the interruption.

A second signal while the first is still flushing falls through to the
previous handler (default: kill), the escape hatch when a flush hangs.
:func:`defer_signals` carves out the one place that escape hatch must
not fire mid-operation: the checkpoint commit
(``utils.checkpoint.save_checkpoint``) holds SIGTERM/SIGINT until the
staged step has been renamed into place, so the operator's second signal
kills the process *between* commits, never inside one.  (SIGKILL cannot
be deferred: the atomic commit makes that crash safe; the deferral makes
it rare.)
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Optional


class ShutdownFlag:
    """Latched shutdown request set by a signal handler.

    ``requested`` flips True at the first signal; ``signum`` records
    which one.  ``exit_code`` follows the shell convention (128 +
    signum).  Thread-safe by virtue of the GIL (single latched write).
    """

    def __init__(self):
        self.requested = False
        self.signum: Optional[int] = None

    def trip(self, signum: int) -> None:
        self.requested = True
        if self.signum is None:
            self.signum = signum

    @property
    def exit_code(self) -> int:
        return 128 + self.signum if self.signum is not None else 0

    def __bool__(self) -> bool:
        return self.requested


@contextlib.contextmanager
def defer_signals(signums=(signal.SIGTERM, signal.SIGINT)):
    """Defer delivery of ``signums`` for the duration of the block.

    Used around critical sections that must not be killed mid-operation
    by a signal's *default* disposition — after `graceful_shutdown`'s
    first latched signal re-installs the previous handler, a second
    SIGTERM would terminate the process wherever it happens to be,
    including inside a checkpoint commit.

    The deferral is Python-level, not an OS sigmask: a temporary handler
    records arrivals, and on exit the previous disposition is restored
    and each recorded signal is re-delivered to it — a callable handler
    is invoked, ``SIG_DFL`` is re-raised via ``os.kill`` (taking the
    default path, e.g. terminate — *between* commits now), ``SIG_IGN``
    drops.  This works in multi-threaded processes: CPython runs signal handlers on the main thread regardless
    of which thread the kernel picked, so masking only the main thread's
    sigmask would NOT stop delivery — recording at the handler layer
    does.  Off the main thread (where ``signal.signal`` is forbidden)
    this is a no-op; the commit stays crash-consistent either way, the
    deferral just makes the mid-commit kill not happen when avoidable.
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    pending = []
    prev = {}

    def record(signum, frame):
        # record EVERY arrival (no dedup): under graceful_shutdown the
        # first SIGTERM latches and the second must still reach the
        # restored default disposition — the operator's escape hatch
        pending.append(signum)

    for s in signums:
        try:
            prev[s] = signal.signal(s, record)
        except (ValueError, OSError):  # unsupported signal on platform
            pass
    try:
        yield
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        for signum in pending:
            # re-deliver through the disposition CURRENT at this point —
            # a latch handler that swaps itself out on the first
            # delivery (graceful_shutdown) leaves the second delivery to
            # the default path, exactly as live delivery would
            h = signal.getsignal(signum)
            if callable(h):
                h(signum, None)
            elif h == signal.SIG_DFL:
                import os

                os.kill(os.getpid(), signum)
            # SIG_IGN (or None: handler installed by non-Python code):
            # drop — we cannot meaningfully re-deliver


@contextlib.contextmanager
def graceful_shutdown(signums=(signal.SIGTERM, signal.SIGINT)):
    """Context manager yielding a :class:`ShutdownFlag` armed on entry.

    The FIRST delivery of each signal latches the flag; the handler
    then re-installs the previous disposition, so a SECOND delivery
    (operator insists) takes the default path — typically terminating a
    flush that wedged.  Handlers are restored on exit.  Outside the
    main thread (where CPython forbids ``signal.signal``) this yields
    an inert flag instead of failing, so library callers can pass a
    flag unconditionally.
    """
    flag = ShutdownFlag()
    if threading.current_thread() is not threading.main_thread():
        yield flag
        return
    prev = {}

    def handler(signum, frame):
        flag.trip(signum)
        # one graceful chance: the next delivery acts like we never
        # caught it (default disposition = terminate the flush too)
        signal.signal(signum, prev[signum])

    for s in signums:
        prev[s] = signal.signal(s, handler)
    try:
        yield flag
    finally:
        for s, h in prev.items():
            # only restore if our handler is still installed (it swaps
            # itself out after the first delivery)
            if signal.getsignal(s) is handler:
                signal.signal(s, h)
