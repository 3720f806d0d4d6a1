"""The chsac_af acting slice end to end against the JAX package (CPU).

Both ``train_chsac`` loops run the duo fleet with ``--rl-warmup`` above the
run's transitions (act, never update), the REAL policy with the same
weights (the JAX agent's flax parameters carried by ``bridge.sac_from_flax``)
and the reference's own arrival tables injected chunk by chunk.  The policy
is held to a tolerance (``tests/test_torch_rl_policy.py``: |dlogp| <=
LOGP_ATOL, a different summation order than XLA's CPU dot), so an action may
legitimately differ where the Gumbel-perturbed top two of a head lie within
``MARGIN`` = 2 * LOGP_ATOL of each other.  The test finds, from the JAX
run's own keys and observations, the first step where any head's margin is
that small, and holds every emission (the RL records included, the
observations to 1 ulp as in ``tests/test_torch_rl_engine.py``) bitwise up
to that step; where the runs first differ at all must lie at or after it.
The prefix checked (every step before the first difference, with the CSV
rows drained from it) is the whole run here: the runs never differ.  The replay rings hold
the prefix's transitions alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.rl import train as jtrain
from distributed_cluster_gpus_tpu.rl.sac import _modules as jmodules
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.rl import train as ttrain

from test_torch_rl_policy import LOGP_ATOL

CHUNK = 256
MARGIN = 2 * LOGP_ATOL
RUN = dict(algo="chsac_af", duration=6.0, log_interval=0.5, job_cap=48,
           queue_cap=8, lat_window=64, seed=21, inf_rate=40.0, trn_rate=4.0,
           rl_warmup=10 ** 9)
OBS_KEYS = ("s0", "s1")


def _record(mod, store):
    orig = mod.drain_emissions

    def drain(emissions, writers):
        store.append(emissions)
        return orig(emissions, writers)

    return orig, drain


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("rl_slice")
    fj = build_duo_fleet()
    pj = JParams(**RUN)
    agent_j = jtrain.make_agent(fj, pj)
    eng = JEngine(fj, pj, policy_apply=agent_j.policy_apply)
    tables = jax.jit(lambda s: eng.workload.tables(s, CHUNK))
    s0 = jinit(jax.random.key(pj.seed), fj, pj, workload=eng.workload)
    pre = [jax.device_get(tables(s0))]
    em_j, em_t = [], []
    orig_j, rec_j = _record(jtrain, em_j)
    orig_t, rec_t = _record(ttrain, em_t)
    jtrain.drain_emissions, ttrain.drain_emissions = rec_j, rec_t
    try:
        # train_every_n above any chunk's transitions: no update is asked for
        sj, agent_j, _ = jtrain.train_chsac(
            fj, pj, out_dir=str(d / "jax"), chunk_steps=CHUNK,
            train_every_n=10 ** 9, agent=agent_j,
            on_chunk=lambda c, s, h: pre.append(jax.device_get(tables(s))))
        ft = bridge.fleet_from_numpy(fj)
        pt = SimParams(**RUN)
        agent_t = ttrain.make_agent(ft, pt, device="cpu")
        to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        agent_t.sac = bridge.sac_from_flax(agent_t.cfg, to_np(agent_j.sac),
                                           device="cpu")
        st, agent_t, hist = ttrain.train_chsac(
            ft, pt, out_dir=str(d / "port"), chunk_steps=CHUNK, agent=agent_t,
            device="cpu", pre_tables=pre)
    finally:
        jtrain.drain_emissions, ttrain.drain_emissions = orig_j, orig_t
    em_j = [bridge.tree_to_numpy(jax.device_get(e)) for e in em_j]
    em_t = [bridge.tree_to_numpy(e, bridge.tensor_leaf) for e in em_t]
    return d, fj, s0, agent_j, sj, agent_t, st, hist, em_j, em_t


def _cat(ems):
    out = {}
    for k in ems[0]:
        if isinstance(ems[0][k], dict):
            out[k] = _cat([e[k] for e in ems])
        else:
            out[k] = np.concatenate([e[k] for e in ems])
    return out


def _first_close_step(s0, agent_j, rl, log_tick):
    """The first step that may consult the policy (any but a log tick) whose
    action draw, as JAX makes it, has a head whose two largest
    Gumbel-perturbed log-probabilities lie within MARGIN."""
    n = rl["s1"].shape[0]

    def body(key, _):
        key, _k_ev, k_act = jax.random.split(key, 3)
        return key, k_act

    _, k_act = jax.lax.scan(body, s0.key, None, length=n)
    enc, actor, _ = jmodules(agent_j.cfg)
    lat = enc.apply(agent_j.sac.enc_params, rl["s1"])
    logp = actor.apply(agent_j.sac.actor_params, lat, rl["mask_dc"], rl["mask_g"])

    def margins(k, lp_dc, lp_g):
        k1, k2 = jax.random.split(k)
        out = []
        for kk, lp in ((k1, lp_dc), (k2, lp_g)):
            v = jnp.sort(jax.random.gumbel(kk, lp.shape) + lp)
            out.append(v[-1] - v[-2])
        return jnp.minimum(*out)

    m = np.asarray(jax.vmap(margins)(k_act, *logp))
    close = np.nonzero((m <= MARGIN) & ~log_tick)[0]
    return int(close[0]) if len(close) else n


def _first_divergence(a, b):
    """The first step where any emission leaf differs (observations beyond
    1 ulp), or the run's length."""
    n = a["t"].shape[0]
    same = np.ones(n, bool)
    for tree_a, tree_b in ((a, b), (a["rl"], b["rl"])):
        for key in tree_a:
            if isinstance(tree_a[key], dict):
                continue
            x, y = tree_a[key], tree_b[key]
            assert x.dtype == y.dtype and x.shape == y.shape, key
            if key in OBS_KEYS and tree_a is a["rl"]:
                dv = np.abs(x.view(np.int32).astype(np.int64)
                            - y.view(np.int32).astype(np.int64))
                ok = dv <= 1
            else:
                ok = x == y
            same &= ok.reshape(n, -1).all(-1)
    bad = np.nonzero(~same)[0]
    return int(bad[0]) if len(bad) else n


def test_acting_slice_matches_reference_up_to_stated_margin(runs):
    d, fj, s0, agent_j, sj, agent_t, st, hist, em_j, em_t = runs
    assert hist == [] and agent_t.sac.step == 0
    assert len(em_j) == len(em_t) >= 2
    a, b = _cat(em_j), _cat(em_t)
    n = a["t"].shape[0]
    k_tie = _first_close_step(s0, agent_j, a["rl"], a["cluster_valid"])
    k = _first_divergence(a, b)
    # every emission (observations to 1 ulp) matches until the first draw
    # the stated tolerance cannot decide, and any divergence comes after one
    assert k >= k_tie, f"emissions differ at step {k}, before any near tie"
    assert k == n, f"the runs differ from step {k} of {n}"
    # CSV rows drained from the checked steps are identical
    n_job = int(a["job_valid"][:k].sum())
    n_cl = int(a["cluster_valid"][:k].sum()) * fj.n_dc
    for name, rows in (("job_log.csv", n_job), ("cluster_log.csv", n_cl)):
        la = (d / "jax" / name).read_bytes().splitlines()
        lb = (d / "port" / name).read_bytes().splitlines()
        assert rows > 5 and la[:rows + 1] == lb[:rows + 1], name
    # the run acted: routes and completed transitions happened
    assert a["rl"]["valid"][:k].sum() > 20


def test_replay_rings_hold_the_same_transitions(runs):
    """Each chunk is one ingest window here, so the ring's first rows are the
    checked prefix's valid transitions in order: equal on both sides, and
    each ring's n_seen counts its own run's valid records."""
    d, fj, s0, agent_j, sj, agent_t, st, hist, em_j, em_t = runs
    rj = bridge.tree_to_numpy(jax.device_get(agent_j.replay))
    rt = bridge.tree_to_numpy(agent_t.replay, bridge.tensor_leaf)
    a, b = _cat(em_j), _cat(em_t)
    n_pre = int(a["rl"]["valid"][:_first_divergence(a, b)].sum())
    assert n_pre > 20
    assert int(rj["n_seen"]) == int(a["rl"]["valid"].sum())
    assert int(rt["n_seen"]) == int(b["rl"]["valid"].sum())
    for key in rj:
        if rj[key].ndim == 0:
            continue
        x, y = rj[key][:n_pre], rt[key][:n_pre]
        if key in OBS_KEYS:
            dv = np.abs(x.view(np.int32).astype(np.int64)
                        - y.view(np.int32).astype(np.int64))
            assert dv.max(initial=0) <= 1, key
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y), key
