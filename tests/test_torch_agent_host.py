"""The agent's host calls and the optional CMDP constraints vs the JAX agent (CPU).

A JAX ``CHSAC_AF`` and the port's, at the observed-signal width (obs_dim
58: the paper fleet's 49 features and the workload's price and 8 carbon
intensities), 8 x 8 joint actions, batch 16, with the CLI's optional
constraints set (``--energy_budget_j`` and ``--power-cap-constraint``
through ``constraints_from_params``); the port's learner carries the JAX
agent's perturbed networks (``bridge.sac_from_flax``) and both replay rings
take the same seeded window, its power and energy costs around their
targets:

* the agents' key chains are equal word for word, and ``select_action``
  gives the JAX agent's action for each of 12 seeded observations (the
  policy's log-probabilities within ``tests/test_torch_rl_policy.py``'s
  ``LOGP_ATOL``; a near-tied Gumbel draw would show as a differing
  action);
* ``train_step`` is None before the warm-up on both sides; after it, three
  updates: every metric within the one-update bounds of
  ``tests/test_torch_rl_learn_update.py`` (``METRIC_RTOL``,
  ``METRIC_ATOL``), the key chains equal, and the CMDP rows of the energy
  budget and the power target (with latency and GPU overcommit) within
  that file's bounds: lambda to ``LAM_ULP`` and the integral to
  ``INT_ULP`` ulp after each update, lambda rising from 0 on both
  constrained rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.rl.agent import CHSAC_AF as JAgent
from distributed_cluster_gpus_tpu.rl import sac as jsac
from distributed_cluster_gpus_tpu.rl.cmdp import constraints_from_params as jcons
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF as TAgent
from distributed_cluster_gpus_tpu_torch.rl.cmdp import constraints_from_params as tcons
from distributed_cluster_gpus_tpu_torch.rl.sac import policy_logp
from test_torch_rl_learn_ops import _perturbed, _ulps
from test_torch_rl_policy import LOGP_ATOL

OBS, N_DC, N_G, BATCH = 58, 8, 8, 16
#: the bounds for one update (tests/test_torch_rl_learn_update.py)
METRIC_RTOL, METRIC_ATOL = 2e-3, 1e-4
LAM_ULP, INT_ULP = 1, 4
CONS = dict(sla_p99_ms=500.0, energy_budget_j=5.0e5, power_cap_constraint=900.0)


def _window(seed=5, n=200):
    rng = np.random.default_rng(seed)
    costs = np.stack([rng.uniform(100, 900, n), rng.uniform(600, 1400, n),
                      rng.integers(0, 3, n), rng.uniform(2e5, 9e5, n)],
                     -1).astype(np.float32)
    w = {"valid": rng.random(n) < 0.8,
         "s0": rng.normal(size=(n, OBS)).astype(np.float32),
         "s1": rng.normal(size=(n, OBS)).astype(np.float32),
         "a_dc": rng.integers(0, N_DC, n).astype(np.int32),
         "a_g": rng.integers(0, N_G, n).astype(np.int32),
         "r": rng.normal(size=n).astype(np.float32), "costs": costs,
         "done": (rng.random(n) < 0.3).astype(np.float32),
         "mask_dc": rng.random((n, N_DC)) < 0.7,
         "mask_g": rng.random((n, N_G)) < 0.7,
         "mask_dc0": rng.random((n, N_DC)) < 0.7,
         "mask_g0": rng.random((n, N_G)) < 0.7}
    w["mask_dc"][:, 0] = w["mask_dc0"][:, 0] = True
    w["mask_g"][:, 0] = w["mask_g0"][:, 0] = True
    return w


@pytest.fixture(scope="module")
def agents():
    cj = jcons(JParams(**CONS))
    ct = tcons(SimParams(**CONS))
    assert [c.target for c in cj] == [c.target for c in ct] == \
        [500.0, 900.0, 0.0, 5.0e5]
    kw = dict(batch=BATCH, warmup=120, seed=13, buffer_capacity=400)
    ja = JAgent(OBS, N_DC, N_G, constraints=cj, **kw)
    ta = TAgent(OBS, N_DC, N_G, constraints=ct, device="cpu", **kw)
    assert ta.key.tolist() == np.asarray(
        jax.random.key_data(ja.key)).astype(np.int64).tolist()
    rng = np.random.default_rng(2)
    sj = ja.sac
    crit = _perturbed(sj.critic_params, rng)
    ja.sac = jax.tree.map(jnp.asarray, sj.replace(
        enc_params=_perturbed(sj.enc_params, rng),
        actor_params=_perturbed(sj.actor_params, rng), critic_params=crit,
        target_critic_params=_perturbed(crit, rng)))
    ta.sac = bridge.sac_from_flax(ta.cfg, jax.tree.map(np.asarray, ja.sac),
                                  device="cpu")
    return ja, ta


def test_select_action_matches_the_jax_agent(agents):
    ja, ta = agents
    rng = np.random.default_rng(9)
    for _ in range(12):
        obs = rng.normal(size=OBS).astype(np.float32)
        m_dc = rng.random(N_DC) < 0.6
        m_g = rng.random(N_G) < 0.6
        m_dc[rng.integers(N_DC)] = m_g[rng.integers(N_G)] = True
        got = ta.select_action(obs, m_dc, m_g)
        want = ja.select_action(obs, m_dc, m_g)
        assert got == want
        assert ta.key.tolist() == np.asarray(
            jax.random.key_data(ja.key)).astype(np.int64).tolist()
        enc, actor, _ = jsac._modules(ja.cfg)
        lj = actor.apply(ja.sac.actor_params,
                         enc.apply(ja.sac.enc_params, jnp.asarray(obs)[None]),
                         jnp.asarray(m_dc)[None], jnp.asarray(m_g)[None])
        with torch.no_grad():
            lt = policy_logp(ta.sac, torch.from_numpy(obs)[None],
                             torch.from_numpy(m_dc)[None],
                             torch.from_numpy(m_g)[None])
        for a, b, m in zip(lj, lt, (m_dc, m_g)):
            a, b = np.asarray(a)[0][m], b.numpy()[0][m]
            assert np.abs(a - b).max() <= LOGP_ATOL


def test_train_step_and_the_constraints_rows(agents):
    ja, ta = agents
    assert ja.train_step() is None and ta.train_step() is None
    w = _window()
    ja.ingest_chunk({k: jnp.asarray(v) for k, v in w.items()})
    ta.ingest_chunk({k: torch.from_numpy(v) for k, v in w.items()})
    assert ja.ready and ta.ready
    lam0 = None
    for step in range(3):
        mj = ja.train_step()
        mt = ta.train_step()
        assert set(mj) == set(mt)
        for k in mj:
            a, b = np.asarray(mj[k]), mt[k].numpy()
            assert a.shape == b.shape and np.isfinite(b).all(), (step, k)
            assert np.all(np.abs(a - b) <= METRIC_RTOL * np.abs(a)
                          + METRIC_ATOL), (step, k)
        cm_j, cm_t = ja.sac.cmdp, ta.sac.cmdp
        assert _ulps(np.asarray(cm_j.lam), cm_t.lam.numpy()).max() <= LAM_ULP, step
        assert _ulps(np.asarray(cm_j.integral),
                     cm_t.integral.numpy()).max() <= INT_ULP, step
        assert ta.key.tolist() == np.asarray(
            jax.random.key_data(ja.key)).astype(np.int64).tolist()
        if lam0 is None:
            lam0 = cm_t.lam.clone()
    lam = ta.sac.cmdp.lam
    # the power target and the energy budget are live: their rows moved
    assert float(lam[1]) > 0.0 and float(lam[3]) > 0.0
    assert float(lam[3]) >= float(lam0[3])
    assert ta.sac.step == 3
