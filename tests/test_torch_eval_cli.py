"""The port's comparison CLI (``python -m distributed_cluster_gpus_tpu_torch.eval``).

* Every path the port does not run yet is refused at parse time, before any
  run and before any file is written, with the ROADMAP item in the message:
  ``--warmstart``, ``--ppo-scale``, ``--critic-arch``, ``ppo`` in a
  config's set, chsac_af at ``--rollouts`` > 1 on configs 4, 4s and 5, and
  (``--device cuda``) a (config, algorithm) outside the kernels' limits.
* ``--config 1 --duration 20 --device cpu --json`` writes the repo
  ``eval.py``'s JSON: the same keys at every level, the same run shape,
  its rows within the stated tolerance for the port's own arrival
  tables (1e-4 relative, ROADMAP queue C), and ``scripts/merge_eval.py``
  merges it with a second seed's file.
* The CLI's byte identity with the JAX CLI (``tests/test_torch_slice.py``)
  runs through the pipelined loop.
"""

import json
import math
import os
import runpy
import subprocess
import sys

import pytest
import torch

from distributed_cluster_gpus_tpu_torch import eval as port_eval
from distributed_cluster_gpus_tpu_torch import evaluation as tev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4  # the stated tolerance of the port's own arrival tables
C1 = ["--config", "1", "--duration", "20", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv, words", [
    (["--warmstart"], ["--warmstart", "item 10"]),
    (["--ppo-scale", "64"], ["--ppo-scale", "item 10"]),
    (["--critic-arch", "heads"], ["--critic-arch", "item 10"]),
    (["--config", "5", "--rollouts", "1"], ["ppo", "item 10"]),
    (["--all", "--rollouts", "1"], ["config 5's ppo", "item 10"]),
    (["--config", "4"], ["--rollouts 8", "item 10", "--rollouts 1 runs"]),
    (["--config", "4s", "--rollouts", "2"], ["config 4s", "item 10"]),
    (["--config", "5", "--algos", "chsac_af"], ["config 5", "item 10"]),
])
def test_unported_paths_are_refused_before_anything_runs(
        argv, words, tmp_path, capsys, monkeypatch):
    ran = []
    monkeypatch.setattr(tev, "run_algo", lambda *a, **k: ran.append(a))
    out = tmp_path / "out.json"
    with pytest.raises(SystemExit) as e:
        port_eval.main(argv + ["--device", "cpu", "--json", str(out)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    for w in words:
        assert w in err, (w, err)
    assert not ran and not out.exists() and os.listdir(tmp_path) == []


def test_the_card_refuses_a_config_past_b1s_limits(tmp_path, capsys,
                                                   monkeypatch):
    """On the card each (config, algorithm) goes through run_sim's check
    before anything runs: a slab past B1's shared memory is refused with
    the limit, and nothing is written."""
    import dataclasses

    real = tev.baseline_config

    def wide(n, duration):
        spec = real(n, duration)
        spec["base"] = dataclasses.replace(spec["base"], job_cap=4096)
        return spec

    monkeypatch.setattr(tev, "baseline_config", wide)
    out = tmp_path / "out.json"
    with pytest.raises(SystemExit) as e:
        port_eval.main(["--config", "3", "--json", str(out)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "config 3: default_policy with job_cap 4096 does not fit B1's " \
        "shared memory" in err and "job_cap <= 2656" in err
    assert not out.exists()


def test_nothing_is_refused_on_the_card_at_the_published_configs():
    for n in ("1", "2", "3", "3c", "3s"):
        a = port_eval.parse_args(["--config", n])
        assert [m for m, _ in a.plan] == [n]
    a = port_eval.parse_args(["--config", "4", "--rollouts", "1"])
    assert a.plan[0][1]["algos"][-1] == "chsac_af"


def test_cuda_without_a_card_raises_before_a_run(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be observed")
    ran = []
    monkeypatch.setattr(tev, "run_algo", lambda *a, **k: ran.append(a))
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="cuda"):
        port_eval.main(["--config", "1", "--json", str(out)])
    assert not ran and not out.exists()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """config 1 at 20 s: the port's JSON at seeds 123 and 124, and the
    repo eval.py's (the JAX package) at seed 123."""
    d = tmp_path_factory.mktemp("eval")
    port_eval.main(C1 + ["--json", str(d / "c1.json")])
    port_eval.main(C1 + ["--seed0", "124", "--json", str(d / "c1_s124.json")])
    ref = tmp_path_factory.mktemp("ref") / "c1.json"
    argv = sys.argv
    try:
        sys.argv = ["eval.py", "--config", "1", "--duration", "20",
                    "--json", str(ref)]
        runpy.run_path(os.path.join(REPO, "eval.py"), run_name="__main__")
    finally:
        sys.argv = argv
    return d, {name: json.load(open(p)) for name, p in (
        ("port", d / "c1.json"), ("port124", d / "c1_s124.json"),
        ("ref", ref))}


def _keys(x):
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(v) for v in x]
    return None


def _close(a, b, where):
    if isinstance(b, dict):
        for k in b:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(b, float) and not isinstance(a, str):
        assert abs(a - b) <= REL * abs(b), f"{where}: {a} vs {b}"
    else:
        assert a == b, where


def test_json_has_the_references_structure(artifacts):
    _, j = artifacts
    assert list(j["port"]) == list(j["ref"]) == ["config1"]
    assert _keys(j["port"]) == _keys(j["ref"])
    assert j["port"]["config1"]["run_shape"] == j["ref"]["config1"]["run_shape"]
    # strict JSON: the NaN training latencies are nulls
    row = j["port"]["config1"]["per_seed"]["123"][0]
    assert row["mean_lat_trn_s"] is None and row["algo"] == "debug"
    _close(j["port"]["config1"]["per_seed"], j["ref"]["config1"]["per_seed"],
           "per_seed")


def test_merge_eval_reads_the_ports_json(artifacts, tmp_path):
    d, j = artifacts
    out = tmp_path / "merged.json"
    proc = subprocess.run([sys.executable, "scripts/merge_eval.py", "--dir",
                           str(d), "--out", str(out)], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "warning" not in proc.stdout, proc.stdout
    merged = json.load(open(out))["config1"]
    assert sorted(merged["per_seed"]) == ["123", "124"]
    agg = merged["aggregate"][0]
    assert agg["algo"] == "debug" and agg["n_seeds"] == 2
    e = [j[k]["config1"]["per_seed"][s][0]["energy_kwh"]
         for k, s in (("port", "123"), ("port124", "124"))]
    assert math.isclose(agg["energy_kwh_mean"], sum(e) / 2, rel_tol=1e-12)


def test_the_port_cli_prints_the_reference_lines(capsys):
    port_eval.main(C1)
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["=== BASELINE config 1", "  -- seed 123"]
    assert [ln.split(":")[0].strip() for ln in lines[2:]] == [
        "debug", "default_policy"]
