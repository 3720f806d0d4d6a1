"""The port's CLI reports as the reference's does (CPU, duo fleet).

Without ``--quiet`` the reference's ``run_sim.py`` passes ``progress=True``
to ``run_simulation`` (a simulated-time bar and the event count after every
chunk) and ``verbose=True`` to ``train_chsac`` (the bar, the replay ring's
size and the last update's critic loss and lambda, or "warming up").  The
port's CLI prints the same lines, made by its copy of the reference's
``sim_progress``; with ``--quiet`` it prints nothing.
"""

import re

import numpy as np
import pytest

from distributed_cluster_gpus_tpu.obs.trace import sim_progress as ref_progress
from distributed_cluster_gpus_tpu_torch import run_sim
from distributed_cluster_gpus_tpu_torch.configs import paper
from distributed_cluster_gpus_tpu_torch.rl import train as ttrain
from distributed_cluster_gpus_tpu_torch.sim import engine as tengine
from distributed_cluster_gpus_tpu_torch.sim import io as tio

DURATION = 0.6
ARGS = ["--device", "cpu", "--duration", str(DURATION), "--chunk-steps", "64",
        "--job-cap", "48", "--inf-rate", "40", "--trn-rate", "4",
        "--log-interval", "0.5"]
# learning from the second chunk on, a few dozen updates at batch 8
CHSAC = ["--algo", "chsac_af", "--rl-warmup", "20", "--rl-batch", "8"]
# acting only: the training line is still printed without --quiet
CHSAC_ACTING = ["--algo", "chsac_af", "--rl-warmup", "1000000"]
BAR = re.compile(r"^\[[#-]{40}\] sim ")


@pytest.mark.parametrize("t, end, extra", [
    (0.0, 3600.0, ""), (1234.5678, 3600.0, "events=17"), (3600.0, 3600.0, "x"),
    (4000.0, 600.0, "replay=3 warming up"), (2.0, 0.0, ""), (-1.0, 10.0, "e"),
    (599.99, 600.0, "replay=12 critic_loss=0.0042 lambda=[0. 1.]")])
def test_progress_line_matches_reference(t, end, extra):
    assert tio.sim_progress(t, end, extra) == ref_progress(t, end, extra)


def _run(monkeypatch, capsys, argv, tmp_path):
    """Run the port's CLI on the duo fleet; returns (stdout lines, final
    state, chunks run, train_chsac's (agent, history) or None)."""
    monkeypatch.setattr(paper, "build_fleet", paper.build_duo_fleet)
    chunks, learned = [], []
    orig_chunk, orig_train = tengine.Engine.run_chunk, ttrain.train_chsac

    def run_chunk(self, *a, **kw):
        chunks.append(1)
        return orig_chunk(self, *a, **kw)

    def train_chsac(*a, **kw):
        out = orig_train(*a, **kw)
        learned.append(out[1:])
        return out

    monkeypatch.setattr(tengine.Engine, "run_chunk", run_chunk)
    monkeypatch.setattr(ttrain, "train_chsac", train_chsac)
    capsys.readouterr()
    state = run_sim.main(argv + ["--out", str(tmp_path / "out")])
    lines = capsys.readouterr().out.splitlines()
    return lines, state, len(chunks), (learned[0] if learned else None)


def test_cli_prints_the_reference_progress_lines(monkeypatch, capsys, tmp_path):
    lines, state, n_chunks, _ = _run(
        monkeypatch, capsys, ARGS + ["--algo", "default_policy"], tmp_path)
    bars = [ln for ln in lines if BAR.match(ln)]
    assert len(bars) == n_chunks >= 2
    for ln in bars:
        assert re.fullmatch(r".* events=\d+", ln), ln
    assert bars[-1] == ref_progress(float(state.t), DURATION,
                                    extra=f"events={int(state.n_events)}")
    assert lines[-1].startswith("done: ")


def test_cli_prints_the_reference_training_lines(monkeypatch, capsys, tmp_path):
    lines, state, n_chunks, (agent, hist) = _run(
        monkeypatch, capsys, ARGS + CHSAC, tmp_path)
    bars = [ln for ln in lines if BAR.match(ln)]
    assert len(bars) == n_chunks >= 2
    warm = [ln for ln in bars if ln.endswith("warming up")]
    trained = [ln for ln in bars if "critic_loss=" in ln]
    assert warm and trained and len(warm) + len(trained) == n_chunks
    assert bars.index(trained[0]) == len(warm)  # warm-up first, then updates
    for ln in bars:
        assert re.fullmatch(r".* replay=\d+ (warming up|critic_loss=-?\d+\.\d{4} "
                            r"lambda=\[.*\])", ln), ln
    m = hist[-1]
    want = ref_progress(float(state.t), DURATION, extra=(
        f"replay={int(agent.replay.size)} "
        f"critic_loss={float(m['critic_loss']):.4f} "
        f"lambda={np.asarray(m['lambda'])}"))
    assert bars[-1] == want


@pytest.mark.parametrize("algo", ["default_policy", "chsac_af"])
def test_cli_quiet_prints_nothing(monkeypatch, capsys, tmp_path, algo):
    argv = ARGS + (CHSAC_ACTING if algo == "chsac_af" else ["--algo", algo])
    lines, _, n_chunks, _ = _run(monkeypatch, capsys, argv + ["--quiet"],
                                 tmp_path)
    assert n_chunks >= 2 and lines == []
