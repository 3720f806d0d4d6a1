"""A signal run's checkpoints against the JAX package's (CPU).

``tests/test_torch_checkpoint_parity.py``'s harness on a run with signal
timelines: both ``train_chsac`` loops run its duo fleet under a spec of
its Poisson streams and price and carbon timelines of 0.5 s bins
(``SPEC``: the chunk crosses two of them), observed (obs_dim 1 + 7 n_dc +
1), one chunk with a checkpoint, the reference's arrival tables
injected, the warm-up not reached (so no update).  The JAX package's store
read back by its own ``restore_checkpoint`` and the port's by the port's
hold the same trees under the same names: the SimState with its
``signals`` sub-tree (``cost_usd`` and ``carbon_g``, float32 [n_dc]) and
the replay ring bitwise except the observation features (1 ulp, as
there), the learner, the agent key and the CSV byte watermark exactly.
"""

import jax
import numpy as np
import torch

from distributed_cluster_gpus_tpu.configs import build_duo_fleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.rl import train as jtrain
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu.utils import checkpoint as jck
from distributed_cluster_gpus_tpu.workload import workload_from_dict as jdoc
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.rl import train as ttrain
from distributed_cluster_gpus_tpu_torch.utils import checkpoint as tck
from distributed_cluster_gpus_tpu_torch.workload import workload_from_dict as tdoc
from test_torch_checkpoint_parity import (CHUNK, RUN, _leaf, _port_fields,
                                          _split_ulps)

#: RUN with a warm-up the chunk does not reach
SIG_RUN = dict(RUN, rl_warmup=10_000)
SPEC = {
    "name": "ckpt_signals",
    "streams": {"inference": {"kind": "poisson", "rate": RUN["inf_rate"]},
                "training": {"kind": "poisson", "rate": RUN["trn_rate"]}},
    "signals": {"price": [0.12, 0.31, 0.07], "carbon": [[420.0, 55.0],
                                                        [100.0, 310.0],
                                                        [250.0, 0.0]],
                "bin_s": 0.5, "periodic": True, "observe": True},
}


def test_signal_run_checkpoint_trees_match_the_jax_package(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check(tmp_path)
    finally:
        torch.set_num_threads(n)


def _check(d):
    fj = build_duo_fleet()
    ft = bridge.fleet_from_numpy(fj)
    pj = JParams(workload=jdoc(SPEC), **SIG_RUN)
    pt = SimParams(workload=tdoc(SPEC), **SIG_RUN)
    assert pt.obs_dim(ft.n_dc) == pj.obs_dim(fj.n_dc) == 1 + 7 * ft.n_dc + 1
    agent_j = jtrain.make_agent(fj, pj)
    agent_t = ttrain.make_agent(ft, pt, device="cpu")
    agent_t.sac = bridge.sac_from_flax(
        agent_t.cfg, jax.tree.map(np.asarray, agent_j.sac), device="cpu")
    eng = JEngine(fj, pj, policy_apply=agent_j.policy_apply)
    s0 = jinit(jax.random.key(pj.seed), fj, pj, workload=eng.workload)
    pre = [jax.device_get(jax.jit(
        lambda s: eng.workload.tables(s, CHUNK))(s0))]
    jtrain.train_chsac(fj, pj, out_dir=str(d / "jax"), chunk_steps=CHUNK,
                       agent=agent_j, max_chunks=1, ckpt_dir=str(d / "jck"),
                       ckpt_every_chunks=1)
    ttrain.train_chsac(ft, pt, out_dir=str(d / "port"), chunk_steps=CHUNK,
                       agent=agent_t, max_chunks=1, ckpt_dir=str(d / "pck"),
                       ckpt_every_chunks=1, device="cpu", pre_tables=pre)
    jm = jck.verify_checkpoint(str(d / "jck" / jck.step_dirname(0)))
    tm = tck.verify_checkpoint(str(d / "pck" / tck.step_dirname(0)))
    assert jm["trees"] == tm["trees"] == ["csv", "key", "replay", "sac", "sim"]
    assert tm["metadata"]["workload"] == jm["metadata"]["workload"]
    tmpl = jtrain.make_agent(fj, pj)
    out = jck.restore_checkpoint(str(d / "jck"), 0, like={
        "sac": tmpl.sac, "replay": tmpl.replay, "key": tmpl.key, "sim": s0,
        "csv": {"cluster": 0, "job": 0}})
    pt_trees = tck.restore_checkpoint(str(d / "pck"), 0)
    sim_j = _port_fields(bridge.tree_to_numpy(out["sim"], _leaf),
                         pt_trees["sim"])
    sim_t = pt_trees["sim"]
    sig_j, sig_t = sim_j["signals"], sim_t["signals"]
    assert set(sig_j) == set(sig_t) == {"cost_usd", "carbon_g"}
    for name in sig_t:
        assert sig_j[name].dtype == sig_t[name].dtype == np.float32
        assert sig_t[name].shape == (ft.n_dc,) and (sig_t[name] > 0).all()
    _split_ulps(sim_j, sim_t, ("jobs", "rl_obs0"))
    assert bridge.tree_mismatches(sim_j, sim_t) == []
    rep_j = dict(bridge.tree_to_numpy(out["replay"]))
    rep_t = dict(pt_trees["replay"])
    for name in ("s0", "s1"):
        _split_ulps(rep_j, rep_t, (name,))
    assert bridge.tree_mismatches(rep_j, rep_t) == []
    assert float(sim_t["t"]) > 1.0  # two bins crossed
    assert int(rep_t["n_seen"]) > 0 and int(pt_trees["sac"]["step"]) == 0
    assert bridge.tree_mismatches(
        bridge.flax_sac_to_numpy(jax.tree.map(np.asarray, out["sac"])),
        pt_trees["sac"]) == []
    assert bridge.tree_mismatches(
        {"key": _leaf(out["key"]),
         "csv": {k: np.int64(v) for k, v in out["csv"].items()}},
        {"key": pt_trees["key"], "csv": pt_trees["csv"]}) == []
    for name in ("cluster_log.csv", "job_log.csv"):
        assert ((d / "jax" / name).read_bytes()
                == (d / "port" / name).read_bytes()), name
