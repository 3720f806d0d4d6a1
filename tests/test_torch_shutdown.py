"""Graceful SIGTERM/SIGINT shutdown of the port's host loops and CLI.

The contract of ``tests/test_shutdown.py`` against the port: the flag and
handler mechanics of ``utils/shutdown.py`` (a copy of the reference's);
``sim.io.run_simulation`` stopped by a tripped flag writes CSVs that are a
byte prefix of the uninterrupted run's and ``run_summary.json`` with
status "interrupted"; ``rl.train.train_chsac`` saves an off-cadence
checkpoint of the chunk it stops at; and the CLI in a subprocess exits
128 + SIGTERM.  Everything runs on the CPU (the plain path) at small
sizes: the duo fleet, short horizons.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu_torch.configs.paper import build_duo_fleet
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.sim import io as tio
from distributed_cluster_gpus_tpu_torch.utils.shutdown import (
    ShutdownFlag, defer_signals, graceful_shutdown)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DUO_KW = dict(algo="default_policy", duration=30.0, log_interval=5.0,
              inf_mode="poisson", inf_rate=2.0, trn_mode="poisson",
              trn_rate=0.1, job_cap=128, queue_cap=256, seed=11)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's runs are small and bound by Python's overhead: one
    torch thread each, so that the suite's parallel workers do not
    oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def duo_fleet():
    return build_duo_fleet()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _wait_for(cond, timeout=2.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# flag + handler mechanics
# ---------------------------------------------------------------------------

def test_shutdown_flag_latches_and_exit_code():
    f = ShutdownFlag()
    assert not f and f.exit_code == 0
    f.trip(signal.SIGTERM)
    f.trip(signal.SIGINT)  # a second signal keeps the first signum
    assert f and f.signum == signal.SIGTERM
    assert f.exit_code == 128 + signal.SIGTERM


def test_graceful_shutdown_catches_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    with graceful_shutdown() as flag:
        assert not flag.requested
        os.kill(os.getpid(), signal.SIGTERM)  # would kill us if uncaught
        _wait_for(lambda: flag.requested)
        assert flag.requested and flag.signum == signal.SIGTERM
        # the handler swapped itself out: a second delivery takes the
        # previous disposition (the operator's escape hatch)
        assert signal.getsignal(signal.SIGTERM) is before
    assert signal.getsignal(signal.SIGTERM) is before


def test_defer_signals_blocks_delivery_until_exit():
    """A signal sent inside the deferred block (with a live worker thread,
    which the kernel may hand the signal to) is delivered only when the
    block exits."""
    stop = threading.Event()
    worker = threading.Thread(target=stop.wait, daemon=True)
    worker.start()
    got = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
    try:
        with defer_signals((signal.SIGTERM,)):
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.05)
            assert got == [], "delivery must be deferred inside the block"
        _wait_for(lambda: got)
        assert got == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)
        stop.set()
        worker.join()


def test_defer_signals_redelivers_every_arrival_sequentially():
    got = []

    def second(signum, frame):
        got.append("second")

    def latch(signum, frame):
        got.append("latch")
        signal.signal(signum, second)

    prev = signal.signal(signal.SIGTERM, latch)
    try:
        with defer_signals((signal.SIGTERM,)):
            os.kill(os.getpid(), signal.SIGTERM)
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.05)
            assert got == []
        assert got == ["latch", "second"]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_signal_helpers_are_inert_off_the_main_thread():
    out = {}

    def worker():
        with defer_signals():
            out["deferred"] = True
        with graceful_shutdown() as flag:
            out["flag"] = flag

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert out["deferred"] and not out["flag"].requested


def test_save_checkpoint_defers_signal_across_commit(tmp_path, monkeypatch):
    """A SIGTERM raised mid-commit (at the rename) is held until the step
    is committed, then delivered."""
    from distributed_cluster_gpus_tpu_torch.utils.checkpoint import (
        latest_step, save_checkpoint, verify_checkpoint)

    got = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
    real_rename = os.rename
    fired = []

    def rename_with_signal(src, dst):
        if not fired:
            fired.append(True)
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.02)
            assert got == [], "the signal must be deferred mid-commit"
        return real_rename(src, dst)

    try:
        monkeypatch.setattr(os, "rename", rename_with_signal)
        d = save_checkpoint(str(tmp_path), 1, a=np.arange(4))
        monkeypatch.setattr(os, "rename", real_rename)
        verify_checkpoint(d)
        assert latest_step(str(tmp_path), verified=True) == 1
        _wait_for(lambda: got)
        assert got == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


# ---------------------------------------------------------------------------
# host loops: stop at the chunk boundary, flush, stamp the status
# ---------------------------------------------------------------------------

def test_run_simulation_sigterm_writes_a_byte_prefix(duo_fleet, tmp_path):
    """SIGTERM raised from inside chunk 1 stops the serial loop at that
    boundary: the CSVs are a byte PREFIX of the uninterrupted run's, and
    run_summary.json says "interrupted" with the totals of the state."""
    from distributed_cluster_gpus_tpu_torch.evaluation import _summarize
    from distributed_cluster_gpus_tpu_torch.utils.jsonio import clean_nan

    params = SimParams(**DUO_KW)
    full = str(tmp_path / "full")
    tio.run_simulation(duo_fleet, params, out_dir=full, chunk_steps=64,
                       device="cpu")
    assert not os.path.exists(os.path.join(full, "run_summary.json"))

    part = str(tmp_path / "part")
    chunks = []

    def on_chunk(state, emissions, engine):
        chunks.append(1)
        if len(chunks) == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    with graceful_shutdown() as flag:
        state = tio.run_simulation(duo_fleet, params, out_dir=part,
                                   chunk_steps=64, device="cpu",
                                   on_chunk=on_chunk, shutdown=flag)
    assert flag.requested and len(chunks) == 2
    assert not bool(state.done)
    for name in ("cluster_log.csv", "job_log.csv"):
        partial, complete = _read(f"{part}/{name}"), _read(f"{full}/{name}")
        assert 0 < len(partial) < len(complete), name
        assert complete.startswith(partial), name
    rs = json.load(open(os.path.join(part, "run_summary.json")))
    assert rs["status"] == "interrupted" and rs["algo"] == "default_policy"
    assert rs["schema"] == "dcg.run_summary.v1"
    assert rs["n_events"] == int(state.n_events) == 128
    # the totals are evaluation's (a NaN latency of an empty window: null)
    assert rs["totals"] == clean_nan(
        _summarize("default_policy", duo_fleet, state).row())


def test_trainer_sigterm_saves_checkpoint_and_status(duo_fleet, tmp_path):
    """train_chsac stopped by the flag after chunk 0 saves an off-cadence
    checkpoint of chunk 0 (every 50 chunks otherwise) and stamps the
    interrupted summary."""
    from distributed_cluster_gpus_tpu_torch.rl.train import train_chsac
    from distributed_cluster_gpus_tpu_torch.utils.checkpoint import (
        latest_step, verify_checkpoint)

    params = SimParams(**{**DUO_KW, "algo": "chsac_af", "rl_warmup": 64,
                          "rl_batch": 16, "rl_buffer": 256, "lat_window": 64,
                          "job_cap": 32, "queue_cap": 32})
    out, ck = str(tmp_path / "run"), str(tmp_path / "ck")
    flag = ShutdownFlag()

    def on_chunk(chunk, state, history):
        if chunk == 0:
            flag.trip(signal.SIGTERM)

    state, agent, _ = train_chsac(duo_fleet, params, out_dir=out,
                                  chunk_steps=64, ckpt_dir=ck,
                                  ckpt_every_chunks=50, on_chunk=on_chunk,
                                  shutdown=flag, device="cpu")
    assert not bool(state.done) and int(state.n_events) == 64
    assert latest_step(ck, verified=True) == 0
    man = verify_checkpoint(os.path.join(ck, "step_0000000000"))
    assert man["trees"] == ["csv", "key", "replay", "sac", "sim"]
    assert man["metadata"]["chunk"] == 0
    rs = json.load(open(os.path.join(out, "run_summary.json")))
    assert rs["status"] == "interrupted" and rs["algo"] == "chsac_af"
    assert os.path.exists(os.path.join(out, "project.log"))


# ---------------------------------------------------------------------------
# the CLI in a subprocess: exits 128 + SIGTERM with its artifacts
# ---------------------------------------------------------------------------

def test_cli_sigterm_exits_143(tmp_path):
    """The port CLI on the CPU, SIGTERM once a chunk has drained: exit code
    143, the reference's "interrupted by signal" line, an "interrupted"
    run_summary.json, a project.log, and CSVs that end on a whole row."""
    out = str(tmp_path / "cli")
    cmd = [sys.executable, "-m", "distributed_cluster_gpus_tpu_torch.run_sim",
           "--device", "cpu", "--algo", "default_policy", "--single-dc",
           "--duration", "86400", "--log-interval", "5", "--inf-mode",
           "poisson", "--inf-rate", "2", "--trn-mode", "off",
           "--chunk-steps", "64", "--time-dtype", "float32", "--out", out,
           "--quiet"]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    cl = os.path.join(out, "cluster_log.csv")
    try:
        deadline = time.time() + 300
        while time.time() < deadline and proc.poll() is None:
            if os.path.exists(cl) and os.path.getsize(cl) > 256:
                break
            time.sleep(0.05)
        assert proc.poll() is None, proc.stdout.read().decode(errors="replace")
        proc.send_signal(signal.SIGTERM)
        text, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = text.decode(errors="replace")
    assert proc.returncode == 128 + signal.SIGTERM, (proc.returncode, text)
    assert "interrupted by signal 15: artifacts flushed, exiting 143" in text
    rs = json.load(open(os.path.join(out, "run_summary.json")))
    assert rs["status"] == "interrupted" and 0 < rs["sim_t_s"] < 86400
    assert "interrupted by signal" in _read(
        os.path.join(out, "project.log")).decode()
    for name in ("cluster_log.csv", "job_log.csv"):
        data = _read(os.path.join(out, name))
        assert data.endswith(b"\n"), name
    rows = _read(cl).decode().splitlines()[1:]
    times = [float(r.split(",")[0]) for r in rows]
    assert len(times) > 1 and times == sorted(times)
