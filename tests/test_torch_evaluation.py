"""The port's comparison harness against the JAX package's (CPU).

``baseline_config`` 1-5 and ``variant_config`` 3c/3s/4s build the JAX
package's fleets (every array), ``SimParams`` (every field, the auto
``queue_cap`` included) and algorithm sets.  ``compare`` and
``compare_seeds`` on the single-DC fleet (``default_policy`` and
``joint_nf``, 30 s, seeds 7 and 8) give the JAX package's rows: the
completions and drops exactly, every float within the stated tolerance
for the port's own arrival tables, 1e-4 relative (their ``log1p``,
``pow`` and ``exp`` differ from XLA's CPU code by about an ulp, ROADMAP
queue C), a NaN where the reference has one; the aggregate's keys
(mean, sd, ``_n_finite``) and the ``run_shape`` stamp are the reference's.
The paths that wait for ROADMAP queue A item 10 raise and name it.
"""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu import evaluation as jev
from distributed_cluster_gpus_tpu.configs import \
    build_single_dc_fleet as jax_single_dc
from distributed_cluster_gpus_tpu.models import SimParams as JaxParams
from distributed_cluster_gpus_tpu_torch import evaluation as tev
from distributed_cluster_gpus_tpu_torch.configs.paper import \
    build_single_dc_fleet
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams

#: the stated tolerance for a summary made from the port's own tables
REL = 1e-4
EXACT = ("algo", "completed_inf", "completed_trn", "dropped")
BASE_KW = dict(algo="joint_nf", duration=30.0, log_interval=10.0,
               inf_mode="poisson", inf_rate=3.0, trn_mode="poisson",
               trn_rate=0.05, job_cap=128, queue_cap=1024)
ALGOS = ["default_policy", "joint_nf"]
SEEDS = [7, 8]
LINE = re.compile(r"^  \s*[a-z_]+: +\d+\.\d{2} kWh, p99_inf +(nan|\d+\.\d{4})s, "
                  r"done \d+\+\d+, Wh/unit \d+\.\d{4}$")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_tree(a, b, where):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same_tree(getattr(a, f.name), getattr(b, f.name),
                       f"{where}.{f.name}")
        return
    if isinstance(a, (np.ndarray, list, tuple)) or hasattr(a, "shape"):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, where
        assert a.tobytes() == b.tobytes(), where
        return
    assert a == b, where


def _same_spec(ours, ref, where):
    assert ours["algos"] == ref["algos"], where
    _same_tree(ours["fleet"], ref["fleet"], f"{where} fleet")
    for f in dataclasses.fields(ours["base"]):
        assert getattr(ours["base"], f.name) == getattr(ref["base"], f.name), \
            f"{where} {f.name}"
    assert ours["base"].queue_cap == ref["base"].queue_cap > 1024 - 1


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_baseline_config_is_the_references(n):
    _same_spec(tev.baseline_config(n, 600.0), jev.baseline_config(n, 600.0),
               f"config {n}")


@pytest.mark.parametrize("name", ["3c", "3s", "4s"])
def test_variant_config_is_the_references(name):
    _same_spec(tev.variant_config(name, 300.0),
               jev.variant_config(name, 300.0), f"variant {name}")


def test_unknown_configs_raise():
    with pytest.raises(ValueError, match="unknown BASELINE config 6"):
        tev.baseline_config(6, 60.0)
    with pytest.raises(ValueError, match="unknown variant config"):
        tev.variant_config("9x", 60.0)


def _row_agrees(ours, ref, where):
    assert list(ours) == list(ref), where
    for k in ours:
        a, b = ours[k], ref[k]
        if k in EXACT or k.startswith("n_seeds"):
            assert a == b, f"{where} {k}"
        elif isinstance(b, float) and math.isnan(b):
            assert isinstance(a, float) and math.isnan(a), f"{where} {k}"
        else:
            assert abs(a - b) <= REL * abs(b), f"{where} {k}: {a} vs {b}"


@pytest.fixture(scope="module")
def both():
    """compare_seeds of both packages, verbose, with their printed lines."""
    import contextlib
    import io

    out = {}
    for name, mod, fleet, params in (
            ("jax", jev, jax_single_dc(), JaxParams(**BASE_KW)),
            ("port", tev, build_single_dc_fleet(), SimParams(**BASE_KW))):
        kw = {} if name == "jax" else {"device": "cpu"}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = mod.compare_seeds(fleet, params, ALGOS, SEEDS,
                                    chunk_steps=1024, verbose=True, **kw)
        out[name] = (res, buf.getvalue().splitlines())
    return out


def test_compare_seeds_rows_agree_with_the_jax_package(both):
    ours, ref = both["port"][0], both["jax"][0]
    assert list(ours["per_seed"]) == list(ref["per_seed"]) == ["7", "8"]
    for sd in ref["per_seed"]:
        for a, b in zip(ours["per_seed"][sd], ref["per_seed"][sd]):
            _row_agrees(a, b, f"seed {sd} {b['algo']}")


def test_aggregate_and_run_shape_are_the_references(both):
    ours, ref = both["port"][0], both["jax"][0]
    assert ours["run_shape"] == ref["run_shape"]
    assert [list(a) for a in ours["aggregate"]] == \
        [list(a) for a in ref["aggregate"]]
    for a, b in zip(ours["aggregate"], ref["aggregate"]):
        _row_agrees(a, b, f"aggregate {b['algo']}")
        # no training job finished in 30 s: the sd of a NaN sample is NaN
        # and the finite count is stated
        assert a["mean_lat_trn_s_n_finite"] == 0
        assert math.isnan(a["mean_lat_trn_s_sd"])
        assert a["energy_kwh_sd"] > 0


def test_compare_prints_the_references_lines(both):
    ours, ref = both["port"][1], both["jax"][1]
    assert len(ours) == len(ref) == len(SEEDS) * (1 + len(ALGOS))
    for a, b in zip(ours, ref):
        if b.startswith("  -- seed"):
            assert a == b
        else:
            assert LINE.match(a) and LINE.match(b), (a, b)
            assert a.split(":")[0] == b.split(":")[0]


def test_compare_alone_gives_the_per_seed_rows(both):
    """``compare`` on one seed gives compare_seeds' rows for that seed
    (the port's own, and the reference's within the tolerance)."""
    rows = tev.compare(build_single_dc_fleet(),
                       SimParams(**{**BASE_KW, "seed": 8}), ["joint_nf"],
                       chunk_steps=1024, verbose=False, device="cpu")
    assert repr([r.row() for r in rows]) == repr(
        [both["port"][0]["per_seed"]["8"][1]])
    _row_agrees(rows[0].row(), both["jax"][0]["per_seed"]["8"][1], "compare")


def test_summarize_carries_extra_and_no_unported_keys():
    from distributed_cluster_gpus_tpu_torch.sim.engine import init_state

    fleet = build_single_dc_fleet()
    params = SimParams(**BASE_KW)
    st = init_state(0, fleet, params, device="cpu")
    row = tev._summarize("joint_nf", fleet, st, {"train_steps": 3}).row()
    assert row["train_steps"] == 3
    assert list(row)[:10] == ["algo", "energy_kwh", "completed_inf",
                              "completed_trn", "dropped", "mean_lat_inf_s",
                              "p99_lat_inf_s", "mean_lat_trn_s",
                              "p99_lat_trn_s", "energy_per_unit_wh"]
    assert len(row) == 11
    assert tev.fault_metrics(fleet, st) == tev.signal_metrics(st) == \
        tev.obs_metrics(st) == {}


@pytest.mark.parametrize("kw", [dict(rollouts=8), dict(init_sac=object()),
                                dict(sac_steps_per_chunk=4)])
def test_the_distributed_trainer_paths_name_item_10(kw):
    params = SimParams(**{**BASE_KW, "algo": "chsac_af"})
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        tev.run_algo(build_single_dc_fleet(), params, device="cpu", **kw)


def test_heuristic_with_a_warm_start_is_refused_as_the_reference():
    with pytest.raises(ValueError, match="only supported for chsac_af"):
        tev.run_algo(build_single_dc_fleet(), SimParams(**BASE_KW),
                     init_sac=object(), device="cpu")


def test_ppo_is_refused_before_anything_runs(capsys):
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        tev.compare(build_single_dc_fleet(), SimParams(**BASE_KW),
                    ["joint_nf", "ppo"], device="cpu")
    assert capsys.readouterr().out == ""
