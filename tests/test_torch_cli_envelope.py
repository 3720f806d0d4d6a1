"""The CLI refuses, at parse time, every setting B1 cannot run on the card.

B1 (the event scan) keeps a lane's slab in one block's shared memory and
takes at most 32 DCs, 32 ingresses and 32 frequency levels
(``kernels/event_scan.py``).  On the card (``--device cuda``, the default)
``run_sim.parse_args`` holds every ``--algo`` to those limits before
anything is written, for either clock, with the limit in the message
(``slab_limit_text``): the heuristics' instances take job_cap <= 2,656 on
the float32 clock and 1,991 on the float64 one, RL mode 2,351 and 1,780 at
``lat_window`` 2,048.  At the limit nothing is refused; on the CPU (the
plain path) nothing is.  Shape logic alone: no card.
"""

import os

import pytest

from distributed_cluster_gpus_tpu_torch import run_sim
from distributed_cluster_gpus_tpu_torch.kernels import event_scan

HEURISTICS = ("default_policy", "joint_nf", "cap_uniform", "cap_greedy",
              "bandit", "carbon_cost", "eco_route", "debug")
#: the clock flags: float32 and float64 by name, and float64 by auto (a
#: horizon past 1e5 s)
CLOCKS = {"float32": ("--time-dtype", "float32"),
          "float64": ("--time-dtype", "float64"),
          "auto64": ("--duration", "200000")}
W = 2048  # SimParams.lat_window


def _limit(rl, clock):
    return event_scan.max_job_cap(W, rl, 8, clock != "float32")


def _argv(algo, job_cap, clock, *extra):
    return ["--algo", algo, "--job-cap", str(job_cap), *CLOCKS[clock], *extra]


def test_the_limits_are_the_kernels():
    assert [_limit(False, c) for c in ("float32", "float64")] == [2656, 1991]
    assert [_limit(True, c) for c in ("float32", "float64")] == [2351, 1780]


@pytest.mark.parametrize("clock", list(CLOCKS))
@pytest.mark.parametrize("algo", HEURISTICS)
def test_a_heuristic_past_b1s_shared_memory_is_refused_at_parse_time(
        algo, clock, capsys):
    J = _limit(False, clock)
    a = run_sim.parse_args(_argv(algo, J, clock))
    assert a.job_cap == J and a.device == "cuda"
    with pytest.raises(SystemExit) as e:
        run_sim.parse_args(_argv(algo, J + 1, clock))
    assert e.value.code == 2
    err = capsys.readouterr().err
    want = event_scan.slab_limit_text(W, False, 8, clock != "float32")
    assert f"{algo} with --job-cap {J + 1} does not fit B1's shared memory" in err
    assert want in err and f"job_cap <= {J}" in err


@pytest.mark.parametrize("clock", list(CLOCKS))
def test_chsac_af_past_rl_modes_shared_memory_is_refused(clock, capsys):
    J = _limit(True, clock)
    run_sim.parse_args(_argv("chsac_af", J, clock))
    with pytest.raises(SystemExit) as e:
        run_sim.parse_args(_argv("chsac_af", J + 1, clock))
    assert e.value.code == 2
    assert event_scan.slab_limit_text(W, True, 8, clock != "float32") in \
        capsys.readouterr().err


def test_the_refusal_comes_before_any_file_is_written(tmp_path, capsys):
    out = tmp_path / "never"
    with pytest.raises(SystemExit) as e:
        run_sim.main(["--algo", "joint_nf", "--job-cap", "5000", "--out",
                      str(out)])
    assert e.value.code == 2 and not os.path.exists(out)
    assert "job_cap <= 2656" in capsys.readouterr().err


def test_a_fleet_past_b1s_widths_is_refused(monkeypatch, capsys):
    """More DCs than B1 takes (a fleet the CLI cannot build today: the limit
    is checked on the fleet the run would use)."""
    from distributed_cluster_gpus_tpu_torch.configs import paper

    duo = paper.build_duo_fleet()
    wide = duo.__class__(**{**duo.__dict__,
                            "dc_names": tuple(f"dc{i}" for i in range(33))})
    monkeypatch.setattr(paper, "build_fleet", lambda: wide)
    with pytest.raises(SystemExit) as e:
        run_sim.parse_args(["--algo", "default_policy"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "33 DCs" in err and "at most 32 DCs, 32 ingresses and 32 frequency" in err


@pytest.mark.parametrize("algo", HEURISTICS + ("chsac_af",))
def test_nothing_is_refused_on_the_cpu(algo):
    a = run_sim.parse_args(_argv(algo, 100_000, "float64", "--device", "cpu"))
    assert a.job_cap == 100_000
