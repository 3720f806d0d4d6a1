"""The learning update's envelope on the card, and its refusal at once.

The card's update kernels take batches 1 to 4,096, heads of up to 256
entries with n_dc + n_g <= 256 and n_dc x n_g <= 1,024 joint actions
(``kernels/envelope.py``).  The CLI (``run_sim.parse_args``, which also
holds the heads to what B1's RL mode acts with: n_dc + n_g <= 256, the
same) and
``CHSAC_AF`` check a configuration against every kernel's plan and limit
before anything runs: inside the envelope nothing is refused; outside it
they raise at once with the envelope in the message, never after the
warm-up and never by falling back to the plain path; on the CPU (the plain
path, which has no envelope) nothing is refused.  Shape logic alone: no
card.
"""

import pytest

from distributed_cluster_gpus_tpu_torch import run_sim
from distributed_cluster_gpus_tpu_torch.kernels import dense, envelope, event_scan
from distributed_cluster_gpus_tpu_torch.kernels.sac_update import target_warps
from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF

#: the envelope's edges: odd batches, 512 and 4,096 rows, the paper fleet
#: at --max-gpus-per-job 64 (72 heads' columns, A = 512) and 128 (136
#: columns, A = 1,024), one action
INSIDE = [(1, 8, 8), (37, 3, 65), (100, 8, 64), (256, 8, 8), (512, 8, 64),
          (1024, 8, 128), (4096, 8, 128), (4096, 1, 1), (255, 128, 8),
          (3, 4, 252), (7, 1, 255)]
#: just outside: a batch past 4,096, more than 1,024 joint actions, heads
#: of more than 256 columns together
OUTSIDE = [(4097, 8, 8), (256, 8, 129), (256, 1, 256), (256, 129, 8),
           (256, 33, 32), (0, 8, 8)]


def _argv(B, n_g, *extra):
    return ["--algo", "chsac_af", "--rl-batch", str(B), "--max-gpus-per-job",
            str(n_g), *extra]


@pytest.mark.parametrize("B,n_dc,n_g", INSIDE)
@pytest.mark.parametrize("arch", ["onehot", "heads"])
def test_the_envelope_has_a_kernel_for_every_call(B, n_dc, n_g, arch):
    assert envelope.update_refusals(B, n_dc, n_g, 1 + 6 * n_dc,
                                    critic_arch=arch) == []
    envelope.check_update(B, n_dc, n_g, 1 + 6 * n_dc, critic_arch=arch)


@pytest.mark.parametrize("B,n_dc,n_g", OUTSIDE)
def test_just_outside_the_envelope_is_refused_with_it(B, n_dc, n_g):
    with pytest.raises(ValueError) as e:
        envelope.check_update(B, n_dc, n_g, 1 + 6 * n_dc)
    assert envelope.ENVELOPE in str(e.value)


def test_the_plans_take_the_widened_shapes():
    """Odd and large row counts, heads of 72 and 136 columns, A = 1,024 all
    have plans (and B5b's target a warp count: a warp per 4 padded actions,
    at most 32 warps)."""
    for R in (1, 37, 255, 257, 512, 1000, 4096):
        dense.fwd_plan(R, 256, 256)
        dense.dx_plan(R, (256,))
        dense.dx_plan(R, (8, 64), (True, True))
    assert dense.heads_plan(512, 256, 72)[1] == 128
    assert dense.heads_plan(1024, 256, 136)[1] == 192
    assert dense.critic_plan(4096 * 1024, 256, 8, 128, 256, False)[0] == 128
    assert dense.critic_plan(4096, 256, 8, 128, 256, True, keep_rows=True)
    for A, W in ((1, 1), (8, 2), (64, 16), (72, 32), (195, 32), (512, 32),
                 (1024, 32)):
        assert target_warps(A) == W


@pytest.mark.parametrize("B,n_g", [(100, 32), (100, 64), (300, 128)])
def test_cli_takes_a_widened_setting_on_the_card(B, n_g):
    """Settings the card runs end to end: odd batches over several row
    tiles, up to the paper fleet's widest GPU-count head (128: 8 x 128
    joint actions, 136 heads' columns), which B1's RL mode acts with and
    the update learns with."""
    a = run_sim.parse_args(_argv(B, n_g))
    assert (a.rl_batch, a.max_gpus_per_job, a.device) == (B, n_g, "cuda")
    a = run_sim.parse_args(_argv(4096, n_g, "--critic-arch", "heads"))
    assert a.critic_arch == "heads"


@pytest.mark.parametrize("B,n_g", [(4097, 8), (256, 129), (256, 250)])
def test_cli_refuses_outside_the_envelope_at_parse_time(B, n_g, capsys):
    """Outside the update's envelope (a batch past 4,096, more than 1,024
    joint actions on the paper fleet): refused before anything runs, with
    both envelopes in the message."""
    with pytest.raises(SystemExit) as e:
        run_sim.parse_args(_argv(B, n_g))
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert envelope.ENVELOPE in err and "outside the card's envelope" in err
    assert event_scan.RL_ENVELOPE in err


def test_b1_refuses_more_than_256_heads_on_a_small_fleet(capsys):
    """B1's RL mode acts with n_dc + n_g <= 256: on the single-DC fleet 255
    GPU-count actions are taken and 256 refused, by the kernel's check and
    by the CLI at parse time (B1's check, with both envelopes in the
    message)."""
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_single_dc_fleet
    from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

    obs = SimParams(algo="chsac_af").obs_dim(1)
    assert event_scan.rl_covers(obs, 1, 255)
    assert not event_scan.rl_covers(obs, 1, 256)
    assert not event_scan.rl_covers(obs, 33, 8)
    run_sim.parse_args(_argv(256, 255, "--single-dc"))

    def act(pp, o, md, mg, k):
        return k[0], k[1]

    act.kernel_mode = "sample"
    eng = Engine(build_single_dc_fleet(), SimParams(
        algo="chsac_af", max_gpus_per_job=256, job_cap=64, queue_cap=8),
        device="cpu", policy_apply=act)
    with pytest.raises(ValueError, match="n_dc \\+ n_g <= 256"):
        event_scan.check_kernel_covers(eng)
    with pytest.raises(SystemExit) as e:
        run_sim.parse_args(_argv(256, 256, "--single-dc"))
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert event_scan.RL_ENVELOPE in err and envelope.ENVELOPE in err


def test_cli_refuses_nothing_on_the_cpu():
    """The plain path has no envelope; nor do the heuristic algorithms."""
    a = run_sim.parse_args(_argv(5000, 300, "--device", "cpu"))
    assert (a.rl_batch, a.max_gpus_per_job) == (5000, 300)
    a = run_sim.parse_args(_argv(100, 64, "--device", "cpu"))
    assert (a.rl_batch, a.max_gpus_per_job) == (100, 64)
    run_sim.parse_args(["--algo", "joint_nf", "--rl-batch", "5000"])


def test_the_agent_refuses_outside_the_envelope_on_the_card():
    """``CHSAC_AF`` on a CUDA device checks before it allocates anything
    (here, with no card, the check comes before the device's)."""
    with pytest.raises(ValueError) as e:
        CHSAC_AF(obs_dim=49, n_dc=8, n_g_choices=129, batch=256,
                 device="cuda")
    assert envelope.ENVELOPE in str(e.value)
    with pytest.raises(ValueError, match="outside the card's envelope"):
        CHSAC_AF(obs_dim=49, n_dc=8, n_g_choices=8, batch=4097,
                 device="cuda:0")


def test_the_agent_refuses_nothing_on_the_cpu():
    agent = CHSAC_AF(obs_dim=7, n_dc=1, n_g_choices=300, batch=5000,
                     buffer_capacity=16, device="cpu")
    assert agent.cfg.batch == 5000 and agent.device.type == "cpu"
