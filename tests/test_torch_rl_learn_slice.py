"""The chsac_af learning slice end to end against the JAX package (CPU).

Both ``train_chsac`` loops run the duo fleet with a small ``--rl-warmup``,
so that updates start after the first chunks: the same initial learner
(the JAX agent's whole ``SACState`` carried by ``bridge.sac_from_flax``),
the same agent key chain, the reference's arrival tables injected chunk by
chunk, one update per new transition up to ``MAX_UPDATES`` a chunk at
batch ``BATCH`` (cuts of the CLI's 256 and 256 that keep the CPU run
short; the networks keep their published widths).

How far the comparison runs:

* every emission of every chunk up to and including the first chunk that
  updates is held as ``tests/test_torch_rl_slice.py`` holds the acting
  loop: bitwise, the observations to 1 ulp (their ``log1p`` features).
  Those chunks act with the same initial weights; later chunks act with
  updated weights that agree with the JAX package's only to the stated
  bounds (``tests/test_torch_rl_learn_update.py``), so their actions may
  legitimately differ and are not compared;
* the updates executed per chunk (``n_done``) are equal on every chunk up
  to and including the first that updates (the warm-up gate and the
  schedule read the same transitions);
* the first updating chunk's last metrics are within the whole update's
  stated tolerance, lambda within ``LAM_ULP`` ulp (lambda depends only on
  the sampled costs, which are bitwise equal while the rings are).
"""

import jax
import numpy as np
import pytest

from distributed_cluster_gpus_tpu.configs import build_duo_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.rl import train as jtrain
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.rl import train as ttrain

from test_torch_rl_learn_ops import LAM_ULP, _ulps
from test_torch_rl_learn_update import METRIC_ATOL, METRIC_RTOL
from test_torch_rl_slice import _cat, _first_divergence, _record

CHUNK = 256
BATCH = 32
MAX_UPDATES = 6
RUN = dict(algo="chsac_af", duration=4.0, log_interval=0.5, job_cap=48,
           queue_cap=8, lat_window=64, seed=21, inf_rate=40.0, trn_rate=4.0,
           rl_warmup=100, rl_batch=BATCH)


def _counting(agent, store):
    orig = agent.train_steps

    def train_steps(n_train, max_steps=256):
        m, n = orig(n_train, max_steps)
        store.append(n)
        return m, n

    agent.train_steps = train_steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("rl_learn_slice")
    fj = build_duo_fleet()
    pj = JParams(**RUN)
    agent_j = jtrain.make_agent(fj, pj)
    ft, pt = bridge.fleet_from_numpy(fj), SimParams(**RUN)
    agent_t = ttrain.make_agent(ft, pt, device="cpu")
    agent_t.sac = bridge.sac_from_flax(
        agent_t.cfg, jax.tree.map(np.asarray, agent_j.sac), device="cpu")
    assert np.array_equal(agent_t.key.numpy(), np.asarray(
        jax.random.key_data(agent_j.key)).astype(np.int64))
    eng = JEngine(fj, pj, policy_apply=agent_j.policy_apply)
    tables = jax.jit(lambda s: eng.workload.tables(s, CHUNK))
    s0 = jinit(jax.random.key(pj.seed), fj, pj, workload=eng.workload)
    pre = [jax.device_get(tables(s0))]
    em_j, em_t, n_j, n_t = [], [], [], []
    _counting(agent_j, n_j)
    _counting(agent_t, n_t)
    orig_j, rec_j = _record(jtrain, em_j)
    orig_t, rec_t = _record(ttrain, em_t)
    jtrain.drain_emissions, ttrain.drain_emissions = rec_j, rec_t
    try:
        _, agent_j, hist_j = jtrain.train_chsac(
            fj, pj, out_dir=str(d / "jax"), chunk_steps=CHUNK, agent=agent_j,
            max_train_steps_per_chunk=MAX_UPDATES,
            on_chunk=lambda c, s, h: pre.append(jax.device_get(tables(s))))
        _, agent_t, hist_t = ttrain.train_chsac(
            ft, pt, out_dir=str(d / "port"), chunk_steps=CHUNK, agent=agent_t,
            max_train_steps_per_chunk=MAX_UPDATES, device="cpu",
            pre_tables=pre)
    finally:
        jtrain.drain_emissions, ttrain.drain_emissions = orig_j, orig_t
    em_j = [bridge.tree_to_numpy(jax.device_get(e)) for e in em_j]
    em_t = [bridge.tree_to_numpy(e, bridge.tensor_leaf) for e in em_t]
    return em_j, em_t, n_j, n_t, hist_j, hist_t, agent_t


def test_learning_loop_matches_up_to_its_first_update(runs):
    em_j, em_t, n_j, n_t, hist_j, hist_t, agent_t = runs
    first = next(i for i, n in enumerate(n_j) if n > 0)
    assert first >= 1, "warm-up ended in the first chunk: nothing to compare"
    assert len(n_t) > first and n_t[:first + 1] == n_j[:first + 1]
    k = first + 1
    a, b = _cat(em_j[:k]), _cat(em_t[:k])
    n = a["t"].shape[0]
    assert _first_divergence(a, b) == n == k * CHUNK
    # the port kept updating and acting after that
    assert sum(n_t) > n_t[first] and agent_t.sac.step == sum(n_t)
    assert len(hist_t) == sum(1 for x in n_t if x > 0)


def test_first_updates_within_tolerance(runs):
    em_j, em_t, n_j, n_t, hist_j, hist_t, agent_t = runs
    mj, mt = hist_j[0], hist_t[0]
    assert set(mj) == set(mt)
    for key in mj:
        a, b = np.asarray(mj[key]), np.asarray(mt[key])
        assert np.isfinite(b).all(), key
        if key == "lambda":
            assert _ulps(a, b).max() <= LAM_ULP
        else:
            assert np.all(np.abs(a - b) <= METRIC_RTOL * np.abs(a)
                          + METRIC_ATOL), key
    for m in hist_t:
        assert all(np.isfinite(v).all() for v in m.values())
        assert float(m["alpha"]) <= 10.0


def test_cli_learns_on_the_cpu(tmp_path):
    """The CLI's chsac_af path with updates due (warm-up cut to 180 and the
    batch to 8 to keep the CPU run short) and ``--critic-arch heads`` (the
    default critic's loop is the one the tests above hold)."""
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.rl import agent as tagent

    steps = []
    orig = tagent.CHSAC_AF.train_steps

    def counting(self, n_train, max_steps=256):
        m, n = orig(self, n_train, max_steps)
        steps.append((n, self.cfg.critic_arch))
        return m, n

    tagent.CHSAC_AF.train_steps = counting
    try:
        st = run_sim.main(["--algo", "chsac_af", "--device", "cpu",
                           "--duration", "0.5", "--inf-rate", "80",
                           "--rl-batch", "8", "--rl-warmup", "180",
                           "--chunk-steps", "256", "--critic-arch", "heads",
                           "--out", str(tmp_path), "--quiet"])
    finally:
        tagent.CHSAC_AF.train_steps = orig
    assert bool(st.done) and sum(n for n, _ in steps) > 0
    assert {a for _, a in steps} == {"heads"}
    assert (tmp_path / "job_log.csv").exists()
