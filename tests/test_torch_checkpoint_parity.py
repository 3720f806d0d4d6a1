"""The port's checkpoints against the JAX package's (CPU).

Both ``train_chsac`` loops run the duo fleet of ``tests/
test_torch_rl_learn_slice.py`` with a checkpoint every chunk: the same
initial learner (the JAX agent's ``SACState`` carried by
``bridge.sac_from_flax``), the reference's arrival tables injected chunk by
chunk, for two chunks (the warm-up ends in the second, which updates).

* **The trees.**  The JAX package's store is read back with its own
  ``restore_checkpoint`` and put in the bridge's layouts; the port's store
  with the port's.  At every chunk they hold the same trees under the same
  names, and agree to queue C's stated tolerances: the SimState and the
  replay ring bitwise except the observation features (``jobs.rl_obs0``,
  ``s0``, ``s1``: 1 ulp, XLA's ``log1p``); the learner bitwise before the
  first update and within the update's parity bounds after it
  (``bridge.sac_far_apart``); the agent key and the CSV byte watermark
  exactly.
* **Carried across.**  The JAX checkpoint of chunk 0 (before any update),
  carried into a port store through the bridge, resumes in the port to the
  same CSV bytes as the JAX package's own resume from that checkpoint,
  through the first updating chunk.  Later chunks act with weights that
  agree only to those bounds, so they are not compared.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.rl import train as jtrain
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu.utils import checkpoint as jck
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.rl import train as ttrain
from distributed_cluster_gpus_tpu_torch.utils import checkpoint as tck

CHUNK = 256
MAX_UPDATES = 6
N_CHUNKS = 2
RUN = dict(algo="chsac_af", duration=4.0, log_interval=0.5, job_cap=48,
           queue_cap=8, lat_window=64, seed=21, inf_rate=40.0, trn_rate=4.0,
           rl_warmup=100, rl_batch=32)
#: the observation features (``jobs.rl_obs0``, the ring's ``s0``, ``s1``)
#: are held to 1 ulp (ROADMAP queue C)
OBS_ULP = 1
CSVS = ("cluster_log.csv", "job_log.csv")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's runs are small and bound by Python's overhead: one
    torch thread each, so that the suite's parallel workers do not
    oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(x):
    if jax.numpy.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x))
    return np.asarray(x)


def _port_fields(jtree, ptree):
    """The JAX tree's leaves the port carries (no fault, telemetry or
    signal sub-states)."""
    if isinstance(ptree, dict):
        return {k: _port_fields(jtree[k], ptree[k]) for k in ptree}
    return jtree


def _count_updates(agent, store):
    orig = agent.train_steps

    def train_steps(n_train, max_steps=256):
        m, n = orig(n_train, max_steps)
        store.append(n)
        return m, n

    agent.train_steps = train_steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_parity")
    fj, pj = build_duo_fleet(), JParams(**RUN)
    agent_j = jtrain.make_agent(fj, pj)
    ft, pt = bridge.fleet_from_numpy(fj), SimParams(**RUN)
    agent_t = ttrain.make_agent(ft, pt, device="cpu")
    agent_t.sac = bridge.sac_from_flax(
        agent_t.cfg, jax.tree.map(np.asarray, agent_j.sac), device="cpu")
    eng = JEngine(fj, pj, policy_apply=agent_j.policy_apply)
    tables = jax.jit(lambda s: eng.workload.tables(s, CHUNK))
    s0 = jinit(jax.random.key(pj.seed), fj, pj, workload=eng.workload)
    pre = [jax.device_get(tables(s0))]
    n_j, n_t = [], []
    _count_updates(agent_j, n_j)
    _count_updates(agent_t, n_t)
    jtrain.train_chsac(
        fj, pj, out_dir=str(d / "jax"), chunk_steps=CHUNK, agent=agent_j,
        max_train_steps_per_chunk=MAX_UPDATES, max_chunks=N_CHUNKS,
        ckpt_dir=str(d / "jck"), ckpt_every_chunks=1,
        on_chunk=lambda c, s, h: pre.append(jax.device_get(tables(s))))
    ttrain.train_chsac(
        ft, pt, out_dir=str(d / "port"), chunk_steps=CHUNK, agent=agent_t,
        max_train_steps_per_chunk=MAX_UPDATES, max_chunks=N_CHUNKS,
        ckpt_dir=str(d / "pck"), ckpt_every_chunks=1, device="cpu",
        pre_tables=pre)
    # the JAX store read back by the JAX package, against a live template
    tmpl = jtrain.make_agent(fj, pj)
    like = {"sac": tmpl.sac, "replay": tmpl.replay, "key": tmpl.key,
            "sim": s0, "csv": {"cluster": 0, "job": 0}}
    jtrees = []
    for step in range(N_CHUNKS):
        out = jck.restore_checkpoint(str(d / "jck"), step, like=like)
        jtrees.append({
            "sac": bridge.flax_sac_to_numpy(jax.tree.map(np.asarray, out["sac"])),
            "replay": bridge.tree_to_numpy(out["replay"]),
            "key": _leaf(out["key"]),
            "sim": bridge.tree_to_numpy(out["sim"], _leaf),
            "csv": {k: np.int64(v) for k, v in out["csv"].items()}})
    return dict(d=d, fj=fj, pj=pj, ft=ft, pt=pt, pre=pre, n_j=list(n_j),
                n_t=list(n_t), jtrees=jtrees, cfg=agent_t.cfg, agent_j=agent_j)


def _split_ulps(a, b, path):
    """Assert the leaf at ``path`` within OBS_ULP in both trees and drop it."""
    *parents, name = path
    for p in parents:
        a, b = a[p], b[p]
    x, y = a.pop(name), b.pop(name)
    assert x.dtype == y.dtype == np.float32 and x.shape == y.shape, path
    d = np.abs(x.view(np.int32).astype(np.int64)
               - y.view(np.int32).astype(np.int64))
    assert d.max(initial=0) <= OBS_ULP, path


def test_the_warm_up_ends_in_the_last_chunk(runs):
    assert runs["n_j"] == runs["n_t"] and runs["n_j"][0] == 0 < runs["n_j"][-1]


def test_both_stores_hold_the_same_trees(runs):
    d = runs["d"]
    for step in range(N_CHUNKS):
        jm = jck.verify_checkpoint(str(d / "jck" / jck.step_dirname(step)))
        tm = tck.verify_checkpoint(str(d / "pck" / tck.step_dirname(step)))
        assert jm["trees"] == tm["trees"] == ["csv", "key", "replay", "sac", "sim"]
        assert tm["metadata"]["chunk"] == jm["metadata"]["chunk"] == step


@pytest.mark.parametrize("step", range(N_CHUNKS))
def test_checkpoint_trees_match_the_jax_package(runs, step):
    jt = runs["jtrees"][step]
    pt = tck.restore_checkpoint(str(runs["d"] / "pck"), step)
    sim_j = _port_fields(jt["sim"], pt["sim"])
    sim_t = pt["sim"]
    _split_ulps(sim_j, sim_t, ("jobs", "rl_obs0"))
    assert bridge.tree_mismatches(sim_j, sim_t) == []
    rep_j, rep_t = dict(jt["replay"]), dict(pt["replay"])
    for name in ("s0", "s1"):
        _split_ulps(rep_j, rep_t, (name,))
    assert bridge.tree_mismatches(rep_j, rep_t) == []
    assert int(rep_t["n_seen"]) > 0
    assert jt["key"].dtype == pt["key"].dtype == np.uint32
    assert bridge.tree_mismatches(
        {"key": jt["key"], "csv": jt["csv"]},
        {"key": pt["key"], "csv": pt["csv"]}) == []
    n = int(pt["sac"]["step"])
    assert n == sum(runs["n_t"][:step + 1])
    if n == 0:
        assert bridge.tree_mismatches(jt["sac"], pt["sac"]) == []
    else:
        assert bridge.sac_far_apart(runs["cfg"], jt["sac"], pt["sac"], n) == []


def test_a_jax_checkpoint_carried_into_the_port_resumes_to_the_same_bytes(
        runs, tmp_path):
    """Chunk 0's JAX checkpoint: the JAX package resumes from its own store,
    the port from the same trees written into a port store through the
    bridge; both write chunk 1 (which acts with the restored weights and
    then updates) after the checkpoint's watermark, byte for byte alike."""
    d = runs["d"]
    jstore, pstore = tmp_path / "jck0", tmp_path / "pck0"
    shutil.copytree(d / "jck" / jck.step_dirname(0),
                    jstore / jck.step_dirname(0))
    for side in ("jres", "pres"):
        os.makedirs(tmp_path / side)
        for name in CSVS:  # the whole run's rows: the resume truncates
            shutil.copy(d / "jax" / name, tmp_path / side / name)
    jt = runs["jtrees"][0]
    ft, pt = runs["ft"], runs["pt"]
    sim = _port_fields(jt["sim"], tck.restore_checkpoint(
        str(d / "pck"), 0, names=["sim"])["sim"])
    fp = tck.config_fingerprint(ft, pt)
    tck.save_checkpoint(str(pstore), 0,
                        metadata=ttrain._ckpt_metadata(ft, pt, fp, 0),
                        sac=jt["sac"], replay=jt["replay"], key=jt["key"],
                        sim=sim, csv=jt["csv"])
    # the JAX run's agent (its update program compiled): the resume
    # replaces its learner, ring and key with the checkpoint's
    jtrain.train_chsac(runs["fj"], runs["pj"], out_dir=str(tmp_path / "jres"),
                       chunk_steps=CHUNK, max_train_steps_per_chunk=MAX_UPDATES,
                       max_chunks=N_CHUNKS, ckpt_dir=str(jstore),
                       ckpt_every_chunks=1, agent=runs["agent_j"])
    _, agent, _ = ttrain.train_chsac(
        ft, pt, out_dir=str(tmp_path / "pres"), chunk_steps=CHUNK,
        max_train_steps_per_chunk=MAX_UPDATES, max_chunks=N_CHUNKS,
        ckpt_dir=str(pstore), ckpt_every_chunks=1, device="cpu",
        pre_tables=runs["pre"])
    assert agent.sac.step == runs["n_t"][1] > 0
    for name in CSVS:
        a = (tmp_path / "jres" / name).read_bytes()
        b = (tmp_path / "pres" / name).read_bytes()
        assert a == b, name
        assert a == (d / "jax" / name).read_bytes(), name
        assert len(a) > int(jt["csv"]["cluster" if name[0] == "c" else "job"])
