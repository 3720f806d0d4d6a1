"""The port's pipelined host loop, its drain and its phase timer (CPU).

The contracts of ``tests/test_io_pipeline.py`` against the port's
``sim/io.py``: the bounded FIFO drain overlaps a slow writer, forwards a
worker's error to the next ``submit``/``flush``/``close``, drops its queue
on ``close(abort=True)`` without raising, retries EINTR/EAGAIN with backoff
within a budget and fails at once on any other ``OSError``.  Then the loop:
``run_simulation`` without a hook (pipelined: chunk N+1 dispatched before
chunk N is rendered on the worker) writes the serial loop's CSV bytes and
ends in its state, bit for bit, over several chunks; its timer records the
reference's phases; a shutdown flag stops it after the chunk in flight
with the CSVs a byte prefix of the uninterrupted run's; and an exception
in a dispatch takes the abort path.  The duo fleet, short horizons, on
the CPU (the plain path).
"""

import errno
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.obs.export import \
    host_phase_seconds as ref_host_phases
from distributed_cluster_gpus_tpu.obs.trace import PhaseTimer as RefTimer
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.configs.paper import build_duo_fleet
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.obs.export import host_phase_seconds
from distributed_cluster_gpus_tpu_torch.obs.trace import (PhaseTimer,
                                                          block_until_ready)
from distributed_cluster_gpus_tpu_torch.sim import engine as tengine
from distributed_cluster_gpus_tpu_torch.sim import io as tio
from distributed_cluster_gpus_tpu_torch.utils.shutdown import ShutdownFlag

PIPE_KW = dict(algo="joint_nf", duration=12.0, log_interval=1.0,
               inf_mode="sinusoid", inf_rate=2.0, trn_mode="poisson",
               trn_rate=0.2, job_cap=64, lat_window=128, seed=7,
               queue_cap=128)
CHUNK = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small runs bound by Python's overhead: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def duo():
    return build_duo_fleet()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# the drain
# ---------------------------------------------------------------------------

def test_async_drain_overlaps_slow_writer():
    """The submitting side's io phase is far below the worker's render
    total when the writer is slow: the render runs while the loop 'computes'
    (sleeps, standing in for the device)."""
    RENDER_S, CHUNKS = 0.05, 6
    rendered = []

    def slow_drain(em, writers):
        time.sleep(RENDER_S)
        rendered.append(em["i"])
        return {"job_rows": 1}

    drainer = tio.AsyncCSVDrain(None, drain_fn=slow_drain)
    timer = PhaseTimer()
    t0 = time.perf_counter()
    for i in range(CHUNKS):
        with timer.phase("io"):
            drainer.submit({"i": i})
        time.sleep(RENDER_S)
    drainer.close()
    wall = time.perf_counter() - t0
    assert rendered == list(range(CHUNKS))  # FIFO
    assert drainer.render_seconds >= RENDER_S * CHUNKS * 0.9
    assert timer.totals["io"] < 0.5 * drainer.render_seconds
    assert wall < 2 * RENDER_S * CHUNKS - RENDER_S
    assert drainer.rows == {"cluster_rows": 0, "job_rows": CHUNKS}


def test_async_drain_propagates_worker_errors():
    def boom(em, writers):
        raise ValueError("disk full")

    drainer = tio.AsyncCSVDrain(None, drain_fn=boom)
    drainer.submit({})
    with pytest.raises(RuntimeError, match="background CSV drain"):
        for _ in range(10):
            time.sleep(0.02)
            drainer.submit({})
        drainer.close()


def test_flush_waits_for_the_queue_and_raises_a_deferred_error():
    seen = []

    def slow(item):
        time.sleep(0.03)
        seen.append(item)
        if item == "bad":
            raise ValueError("render bug")

    drain = tio.AsyncLineDrain(slow)
    for i in range(3):
        drain.submit(i)
    drain.flush()
    assert seen == [0, 1, 2]
    drain.submit("bad")
    with pytest.raises(RuntimeError, match="background line drain"):
        drain.flush()
    drain.close()


def test_abort_drops_the_queue_and_swallows_errors():
    RENDER_S = 0.15
    seen = []

    def slow_then_boom(item):
        time.sleep(RENDER_S)
        seen.append(item)
        raise ValueError("disk full")

    drain = tio.AsyncLineDrain(slow_then_boom)
    for i in range(4):
        drain.submit(i)
    t0 = time.perf_counter()
    drain.close(abort=True)  # must not raise
    assert time.perf_counter() - t0 < 3 * RENDER_S
    assert len(seen) < 4


def test_counters_and_the_two_argument_signature():
    got = []

    def fn(em, writers):
        got.append((em, writers))
        return {"cluster_rows": 3}

    sentinel = object()
    drainer = tio.AsyncCSVDrain(sentinel, drain_fn=fn)
    drainer.submit({"x": 1})
    drainer.close()
    assert got == [({"x": 1}, sentinel)]
    assert drainer.rows == {"cluster_rows": 3, "job_rows": 0}


def test_the_queue_is_bounded():
    """A loop that outruns the writer blocks in submit at MAXSIZE."""
    gate = []
    started = threading.Event()

    def blocked(item):
        started.set()
        while not gate:
            time.sleep(0.005)

    assert tio.AsyncLineDrain.MAXSIZE == 4
    drain = tio.AsyncLineDrain(blocked)
    t0 = time.perf_counter()
    drain.submit(0)
    assert started.wait(5.0)  # the first item is in the worker
    for i in range(1, 5):  # four queued
        drain.submit(i)
    assert time.perf_counter() - t0 < 0.5

    done = threading.Event()
    threading.Thread(target=lambda: (drain.submit(5), done.set()),
                     daemon=True).start()
    assert not done.wait(0.2), "a sixth item must wait for room"
    gate.append(1)
    assert done.wait(5.0)
    drain.close()


def test_many_drains_under_a_short_switch_interval_keep_order_and_counts():
    """More drains than cores, each fed from its own thread, with the
    interpreter switching threads every microsecond: every drain renders
    its items in order and counts each once."""
    import sys

    n_drains, n_items = 2 * (os.cpu_count() or 4), 300
    seen = [[] for _ in range(n_drains)]
    drains = [tio.AsyncLineDrain(
        lambda item, out=out: (out.append(item), {"rows": 1})[1])
        for out in seen]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        feeders = [threading.Thread(
            target=lambda d=d: [d.submit(i) for i in range(n_items)])
            for d in drains]
        for t in feeders:
            t.start()
        for t in feeders:
            t.join(timeout=60)
            assert not t.is_alive()
        for d in drains:
            d.close()
    finally:
        sys.setswitchinterval(old)
    for d, out in zip(drains, seen):
        assert out == list(range(n_items))
        assert d.rows == {"rows": n_items}


@pytest.mark.parametrize("code, retries, calls, raises", [
    (errno.EINTR, 3, 3, False),   # two EINTRs, then it writes
    (errno.EAGAIN, 3, 3, False),
    (errno.EINTR, 2, 3, True),    # the budget: 1 attempt + 2 retries
    (errno.ENOSPC, 3, 1, True),   # not transient: one attempt
])
def test_transient_io_errors_are_retried_within_a_budget(code, retries, calls,
                                                         raises, monkeypatch):
    monkeypatch.setattr(tio.AsyncLineDrain, "IO_RETRIES", retries)
    monkeypatch.setattr(tio.AsyncLineDrain, "IO_BACKOFF_S", 0.001)
    seen = []

    def flaky(item):
        seen.append(item)
        if code == errno.ENOSPC or raises or len(seen) <= 2:
            raise OSError(code, os.strerror(code))
        return {"rows": 1}

    drain = tio.AsyncLineDrain(flaky)
    drain.submit("chunk")
    if raises:
        with pytest.raises(RuntimeError, match="background line drain"):
            drain.close()
    else:
        drain.close()
        assert drain.rows == {"rows": 1}
        assert drain.io_retry_count == 2
    assert len(seen) == calls


# ---------------------------------------------------------------------------
# the timer
# ---------------------------------------------------------------------------

def test_phase_timer_matches_the_references():
    """Totals, counts, add_span and the summary's text are the
    reference's; host_phase_seconds reads them as the reference's does."""
    ours, ref = PhaseTimer(), RefTimer()
    x = torch.ones(3)
    for name, fence in (("rollout", lambda: x), ("io", None),
                        ("rollout", lambda: {"a": [x]})):
        with ours.phase(name, fence=fence):
            time.sleep(0.002)
        ref.totals[name] += ours.totals[name] - ref.totals[name]
        ref.counts[name] += 1
    ours.add_span("io_render", 0.25)
    ref.add_span("io_render", 0.25)
    assert dict(ours.counts) == {"rollout": 2, "io": 1, "io_render": 1}
    assert dict(ours.totals) == dict(ref.totals)
    assert ours.summary() == ref.summary()
    assert host_phase_seconds(ours, 0.5) == ref_host_phases(ref, 0.5)
    assert host_phase_seconds(ours) == ref_host_phases(ref)
    block_until_ready([x, {"y": x}])  # CPU tensors: ready


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _serial_by_hand(fleet, params, out):
    """Dispatch, then drain, chunk after chunk: the reference's oracle."""
    eng = tengine.Engine(fleet, params, device="cpu")
    st = tengine.init_state(params.seed, fleet, params, workload=eng.workload,
                            device="cpu")
    writers = tio.CSVWriters(out, fleet)
    n = 0
    while True:
        st, em = eng.run_chunk(st, CHUNK)
        tio.drain_emissions(em, writers)
        n += 1
        if bool(st.done):
            return st, n


@pytest.fixture(scope="module")
def runs(duo, tmp_path_factory):
    """The same run three ways: pipelined (no hook), the hooked serial
    loop, and dispatch-then-drain by hand."""
    root = tmp_path_factory.mktemp("pipeline")
    params = SimParams(**PIPE_KW)
    out = {}
    timer = PhaseTimer()
    out["pipelined"] = (tio.run_simulation(
        duo, params, out_dir=str(root / "pipelined"), chunk_steps=CHUNK,
        device="cpu", timer=timer), timer)
    hooked, stimer = [], PhaseTimer()
    out["serial"] = (tio.run_simulation(
        duo, params, out_dir=str(root / "serial"), chunk_steps=CHUNK,
        device="cpu", timer=stimer,
        on_chunk=lambda st, em, eng: hooked.append(1)), stimer)
    st, n = _serial_by_hand(duo, params, str(root / "by_hand"))
    out["by_hand"] = (st, n)
    return root, out, len(hooked)


def test_pipelined_loop_writes_the_serial_bytes(runs):
    root, out, n_hooked = runs
    n_chunks = out["by_hand"][1]
    assert n_chunks >= 3 and n_hooked == n_chunks
    for name in ("cluster_log.csv", "job_log.csv"):
        want = _read(root / "by_hand" / name)
        assert want.count(b"\n") > 10, name
        assert _read(root / "pipelined" / name) == want, name
        assert _read(root / "serial" / name) == want, name


def _same_bits(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same_bits(a[k], b[k], f"{where}.{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert (a.shape, a.dtype) == (b.shape, b.dtype), where
    assert a.tobytes() == b.tobytes(), where


def test_pipelined_loop_ends_in_the_serial_state(runs):
    _, out, _ = runs
    want = bridge.state_to_numpy(out["by_hand"][0])
    for loop in ("pipelined", "serial"):
        assert bool(out[loop][0].done)
        _same_bits(bridge.state_to_numpy(out[loop][0]), want, loop)


def test_timers_record_each_loops_phases(runs):
    _, out, _ = runs
    n_chunks = out["by_hand"][1]
    pipe, serial = out["pipelined"][1], out["serial"][1]
    assert set(pipe.totals) == {"dispatch", "rollout", "io", "io_render"}
    assert pipe.counts["dispatch"] == pipe.counts["rollout"] == n_chunks
    assert pipe.counts["io"] == n_chunks  # N-1 handoffs and the tail's
    assert pipe.counts["io_render"] == 1
    assert set(serial.totals) == {"rollout", "io"}
    assert serial.counts["rollout"] == serial.counts["io"] == n_chunks


def _trip_at(monkeypatch, flag, k):
    """Trip ``flag`` while chunk ``k`` (0-based) is dispatched."""
    orig, seen = tengine.Engine.run_chunk, []

    def run_chunk(self, *a, **kw):
        seen.append(1)
        if len(seen) == k + 1:
            flag.trip(signal.SIGTERM)
        return orig(self, *a, **kw)

    monkeypatch.setattr(tengine.Engine, "run_chunk", run_chunk)
    return seen


def test_shutdown_through_the_pipelined_loop_leaves_a_byte_prefix(
        duo, runs, tmp_path, monkeypatch):
    """The flag trips during chunk 1's dispatch: the loop stops after that
    chunk in flight has drained, so the CSVs are exactly the first two
    chunks' rows (a strict prefix of the whole run's), and
    run_summary.json says "interrupted" with the pipelined loop's phases."""
    root, out, _ = runs
    params = SimParams(**PIPE_KW)
    flag = ShutdownFlag()
    seen = _trip_at(monkeypatch, flag, 1)
    part = str(tmp_path / "part")
    st = tio.run_simulation(duo, params, out_dir=part, chunk_steps=CHUNK,
                            device="cpu", shutdown=flag)
    assert len(seen) == 2 and not bool(st.done)
    assert int(st.n_events) == 2 * CHUNK
    monkeypatch.undo()
    two = str(tmp_path / "two")
    tio.run_simulation(duo, params, out_dir=two, chunk_steps=CHUNK,
                       device="cpu", max_chunks=2)
    for name in ("cluster_log.csv", "job_log.csv"):
        got, full = _read(os.path.join(part, name)), _read(root / "pipelined"
                                                           / name)
        assert 0 < len(got) < len(full) and full.startswith(got), name
        assert got == _read(os.path.join(two, name)), name
    rs = json.load(open(os.path.join(part, "run_summary.json")))
    assert rs["status"] == "interrupted" and rs["n_events"] == 2 * CHUNK
    assert set(rs["host_phases"]) == {"dispatch_s", "rollout_s", "io_s",
                                      "io_render_s"}
    assert not os.path.exists(os.path.join(two, "run_summary.json"))


def test_a_dispatch_error_takes_the_abort_path(duo, tmp_path, monkeypatch):
    """An exception in chunk 2's dispatch propagates as itself (the worker's
    queue dropped, no writer error in its place) and leaves no summary."""
    params = SimParams(**PIPE_KW)
    orig, seen = tengine.Engine.run_chunk, []

    def run_chunk(self, *a, **kw):
        seen.append(1)
        if len(seen) == 3:
            raise KeyboardInterrupt
        return orig(self, *a, **kw)

    monkeypatch.setattr(tengine.Engine, "run_chunk", run_chunk)
    out = str(tmp_path / "abort")
    with pytest.raises(KeyboardInterrupt):
        tio.run_simulation(duo, params, out_dir=out, chunk_steps=CHUNK,
                           device="cpu")
    assert not os.path.exists(os.path.join(out, "run_summary.json"))


def test_a_writer_error_surfaces_from_the_loop(duo, tmp_path, monkeypatch):
    params = SimParams(**PIPE_KW)

    def broken(em, writers):
        raise OSError(errno.ENOSPC, "no space left on device")

    monkeypatch.setattr(tio, "drain_emissions", broken)
    with pytest.raises(RuntimeError, match="background CSV drain") as e:
        tio.run_simulation(duo, params, out_dir=str(tmp_path / "w"),
                           chunk_steps=CHUNK, device="cpu")
    assert isinstance(e.value.__cause__, OSError)
