"""The update's bf16 parameter shadows stay the casts of their groups (CPU).

The networks' products in an update read bf16 shadows of the float32
parameter groups (``SACState.shadow``), the JAX package's casts at the head
of its update.  B5c writes them after each step (B5g's casts folded into
its launches), so every update starts from ``shadow == bf16(flat)``;
``assemble`` fills them once, and ``refresh_shadows`` after any other write
of the parameters.  A stale shadow would show only as a parity failure of
the next update, so these tests hold ``shadow == bf16(flat)`` bitwise after
every path that writes ``flat``: ``sac_init``, an update of the plain path
(both critics), ``bridge.sac_from_flax`` and an outside write followed by
the refresh.  They also hold B5c's plain version reading a bf16 gradient
against widening it first (the gpu tests hold the kernels, eager and in the
CUDA graph).
"""

import jax
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.rl import cmdp as jcmdp
from distributed_cluster_gpus_tpu.rl import sac as jsac
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.ops import prng
from distributed_cluster_gpus_tpu_torch.rl import optim
from distributed_cluster_gpus_tpu_torch.rl import sac as rsac
from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF
from distributed_cluster_gpus_tpu_torch.rl.cmdp import default_constraints
from distributed_cluster_gpus_tpu_torch.rl.replay import replay_add_chunk

BF16 = torch.bfloat16
OBS, N_DC, N_G = 13, 2, 5


def _bits(x):
    return x.contiguous().view({torch.float32: torch.int32,
                                BF16: torch.int16}[x.dtype])


def stale_shadows(sac):
    """The groups whose shadow is not bf16 of their float32 buffer."""
    return [g for g in rsac.SHADOWED
            if not torch.equal(_bits(sac.shadow[g]), _bits(sac.flat[g].to(BF16)))]


def _cfg(arch="onehot"):
    return rsac.SACConfig(obs_dim=OBS, n_dc=N_DC, n_g=N_G, batch=8,
                          critic_arch=arch,
                          constraints=default_constraints(500.0))


def test_assemble_fills_the_shadows():
    sac = rsac.sac_init(_cfg(), prng.key(3, "cpu"), "cpu")
    assert stale_shadows(sac) == []
    assert all(bool(sac.shadow[g].ne(0).any()) for g in rsac.SHADOWED)


def _window(g, N):
    return {"valid": torch.rand(N, generator=g) < 0.7,
            "s0": torch.randn((N, OBS), generator=g),
            "s1": torch.randn((N, OBS), generator=g),
            "a_dc": torch.randint(0, N_DC, (N,), dtype=torch.int32, generator=g),
            "a_g": torch.randint(0, N_G, (N,), dtype=torch.int32, generator=g),
            "r": torch.randn(N, generator=g),
            "costs": torch.rand((N, 4), generator=g) * 900,
            "mask_dc": torch.rand((N, N_DC), generator=g) < 0.6,
            "mask_g": torch.rand((N, N_G), generator=g) < 0.6,
            "mask_dc0": torch.rand((N, N_DC), generator=g) < 0.6,
            "mask_g0": torch.rand((N, N_G), generator=g) < 0.6,
            "done": (torch.rand(N, generator=g) < 0.3).float()}


@pytest.mark.parametrize("arch", ["onehot", "heads"])
def test_updates_keep_the_shadows(arch):
    """After each update of the plain path every shadow is bf16 of its
    group's new parameters (the target's after the Polyak step)."""
    agent = CHSAC_AF(obs_dim=OBS, n_dc=N_DC, n_g_choices=N_G, batch=8,
                     buffer_capacity=64, warmup=8, critic_arch=arch,
                     device="cpu")
    replay_add_chunk(agent.replay, _window(torch.Generator().manual_seed(5), 48))
    before = {g: agent.sac.flat[g].clone() for g in rsac.SHADOWED}
    for _ in range(2):
        _, n = agent.train_steps(1, 1)
        assert n == 1 and stale_shadows(agent.sac) == []
    assert all(not torch.equal(before[g], agent.sac.flat[g])
               for g in rsac.SHADOWED)


def test_sac_from_flax_fills_the_shadows():
    cj = jsac.SACConfig(obs_dim=OBS, n_dc=N_DC, n_g=N_G,
                        constraints=jcmdp.default_constraints(500.0))
    sj = jsac.sac_init(cj, jax.random.key(2))
    rng = np.random.default_rng(6)
    sj = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.asarray(a).dtype)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a), sj)
    st = bridge.sac_from_flax(_cfg(), sj, device="cpu")
    assert stale_shadows(st) == []
    assert bool(st.shadow["target"].ne(0).any())


def test_an_outside_write_goes_through_the_refresh():
    """Perturbing the parameters leaves the shadows stale until
    ``refresh_shadows``."""
    sac = rsac.sac_init(_cfg(), prng.key(4, "cpu"), "cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for layer in sac.layers():
            layer.bias.add_(torch.randn(layer.bias.shape, generator=g))
    assert stale_shadows(sac) == ["enc", "actor"]
    rsac.refresh_shadows(sac)
    assert stale_shadows(sac) == []


@pytest.mark.parametrize("n", [1, 3, 4, 1001])
@pytest.mark.parametrize("target", [False, True])
def test_b5c_reads_bf16_gradients_as_widened(n, target):
    """B5c's plain version given a bf16 gradient steps the group exactly as
    given that gradient widened to float32 first (parameters, moments,
    count, target bitwise; the clip on), and its shadows are bf16 of the
    new parameters and target."""
    g = torch.Generator().manual_seed(n)
    p = torch.randn(n, generator=g)
    grad = (torch.randn(n, generator=g) * 3).to(BF16)
    grad[0] = -0.0
    mu = torch.randn(n, generator=g) * 0.01
    nu = torch.rand(n, generator=g) * 1e-4
    tgt = torch.randn(n, generator=g) if target else None
    cfg = optim.AdamConfig()
    runs = []
    for gr in (grad, grad.to(torch.float32)):
        st = optim.AdamState(torch.tensor(4, dtype=torch.int32), mu.clone(),
                             nu.clone())
        pp, tt = p.clone(), None if tgt is None else tgt.clone()
        sh = torch.empty(n, dtype=BF16)
        tsh = None if tgt is None else torch.empty(n, dtype=BF16)
        optim.clip_adam_update(pp, gr, st, cfg, target=tt, tau=0.005,
                               shadow=sh, target_shadow=tsh)
        runs.append([pp, st.mu, st.nu, st.count] + ([] if tt is None else [tt]))
        assert torch.equal(_bits(sh), _bits(pp.to(BF16)))
        if tt is not None:
            assert torch.equal(_bits(tsh), _bits(tt.to(BF16)))
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.equal(runs[0][0], p)
