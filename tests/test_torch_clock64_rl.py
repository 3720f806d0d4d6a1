"""The float64 clock's chsac_af against the JAX package under x64 (CPU).

* Acting: ``tests/test_torch_rl_engine.py``'s harness (the deterministic
  stand-in policy on both sides, the reference's own arrival tables) with
  ``time_dtype="float64"``, the JAX scan inside ``jax.enable_x64(True)``,
  over two chunks from ``init_state`` on the duo fleet and from states
  bridged to t = 6.0e5 s on the duo and single-DC fleets: the state and
  every emission bitwise, the observation leaves to ``OBS_ULP`` (XLA's
  ``log1p`` of the queue features, as that file states; the time feature is
  the float64 ``rem`` times XLA's float64 reciprocal of the day, bitwise).
* The update's float64 regions: B5c's bias corrections (optax under x64
  computes ``1 - decay**count`` in float64 and rounds once) bitwise at
  every count 1..5,000 of both decays; B6b's float64 uniform (64 random
  bits, ``u * total`` and the search in float64) gives the reference's rows
  for a set of keys; and one whole update at the published widths (batch
  32) holds to ``tests/test_torch_rl_learn_update.py``'s tolerances with
  ``SACConfig.x64`` on the port's side and the JAX update under x64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu.rl import replay as jreplay
from distributed_cluster_gpus_tpu.rl import sac as jsac
from distributed_cluster_gpus_tpu.sim.engine import Engine as JEngine
from distributed_cluster_gpus_tpu.sim.engine import init_state as jinit
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.rl import optim as toptim
from distributed_cluster_gpus_tpu_torch.rl import replay as treplay
from distributed_cluster_gpus_tpu_torch.rl import sac as tsac
from distributed_cluster_gpus_tpu_torch.sim.engine import Engine
from test_torch_algos import bridge_to
from test_torch_rl_engine import (FLEETS, LOADS, _leaf, _port_fields,
                                  _split_obs, standin_jax, standin_port)
from test_torch_rl_learn_ops import LAM_ULP, _key_t, _ulps, carried_pair
from test_torch_rl_learn_update import (LR, METRIC_ATOL, METRIC_RTOL,
                                        MOMENT_RTOL, TAU, _leaves, _ring)

N_STEPS = 300
N_CHUNKS = 2
T_LATE = 6.0e5
CASES = {"duo": ("duo", None), "duo/late": ("duo", T_LATE),
         "single/late": ("single", T_LATE)}


@pytest.fixture(scope="module", params=list(CASES))
def acting(request):
    fleet_name, t0 = CASES[request.param]
    fj = FLEETS[fleet_name]()
    kw = dict(algo="chsac_af", duration=(t0 or 0.0) + 400.0, lat_window=64,
              seed=3, time_dtype="float64", **LOADS[fleet_name])
    with jax.enable_x64(True):
        pj = JParams(**kw)
        n_g = pj.max_gpus_per_job
        eng_j = JEngine(fj, pj, policy_apply=standin_jax(fj.n_dc, n_g))
        sj = jinit(jax.random.key(3), fj, pj, workload=eng_j.workload)
        if t0 is not None:
            sj = bridge_to(sj, t0, kw["log_interval"])

        def chunk(state, pre):
            s, em = jax.lax.scan(lambda s, _: eng_j._step(s, None, pre=pre),
                                 state, None, length=N_STEPS)
            return eng_j.workload.advance_carries(s, pre), em

        chunk_j = jax.jit(chunk)
        tables_j = jax.jit(lambda s: eng_j.workload.tables(s, N_STEPS))
        eng_t = Engine(bridge.fleet_from_numpy(fj), SimParams(**kw),
                       device="cpu", policy_apply=standin_port(fj.n_dc, n_g))
        st = bridge.state_from_numpy(bridge.tree_to_numpy(sj, _leaf), "cpu")
        ems = []
        for _ in range(N_CHUNKS):
            pre = tables_j(sj)
            sj, em_j = chunk_j(sj, pre)
            pre_t = {k: torch.from_numpy(np.array(v)) for k, v in pre.items()}
            st, em_t = eng_t.run_chunk(st, N_STEPS, pre=pre_t)
            ems.append((bridge.tree_to_numpy(jax.device_get(em_j)),
                        bridge.tree_to_numpy(em_t, bridge.tensor_leaf)))
        jt = bridge.tree_to_numpy(sj, _leaf)
    return t0, jt, st, ems


def test_float64_acting_bit_identical(acting):
    t0, jt, st, ems = acting
    pt = bridge.state_to_numpy(st)
    jt = _port_fields(jt, pt)
    _split_obs(jt, pt, "jobs")
    assert bridge.tree_mismatches(jt, pt) == []
    for em_j, em_t in ems:
        em_j = {k: dict(v) if isinstance(v, dict) else v for k, v in em_j.items()}
        em_t = {k: dict(v) if isinstance(v, dict) else v for k, v in em_t.items()}
        _split_obs(em_j, em_t, "rl")
        assert bridge.tree_mismatches(em_j, em_t) == []
    assert st.t.dtype == torch.float64 and st.queues.recs.dtype == torch.float64
    assert int(st.n_events) == N_CHUNKS * N_STEPS
    rl = np.concatenate([e[1]["rl"]["valid"] for e in ems])
    assert rl.sum() > 20, "too few completed transitions"
    if t0 is not None:
        assert float(st.t) > t0


def test_bias_correction_x64_bitwise():
    """optax's ``1 - decay**count`` under x64 (float64, rounded once to
    float32) at every count 1..5,000, both Adam decays."""
    counts = np.arange(1, 5001, dtype=np.int32)
    for decay in (0.9, 0.999):
        with jax.enable_x64(True):
            want = np.asarray(jax.jit(jax.vmap(
                lambda c: (1 - decay ** c).astype(jnp.float32)))(counts))
        got = toptim.bias_correction(decay, torch.from_numpy(counts),
                                     x64=True).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(want.view(np.int32), got.view(np.int32)), decay
    # the float32 clock's correction differs from it somewhere
    c = torch.from_numpy(counts)
    assert not torch.equal(toptim.bias_correction(0.999, c),
                           toptim.bias_correction(0.999, c, x64=True))


def test_replay_sample_x64_rows():
    """B6b's plain version under x64: the rows ``jax.random.uniform`` in
    float64 picks (64 random bits, ``u * total`` and the search in
    float64), for 24 keys on a ring with invalid rows."""
    rbj, rbt = _ring(seed=4, C=700, N=640)
    B = 97
    with jax.enable_x64(True):
        for s in range(24):
            key = jax.random.key(100 + s)
            cdf = jnp.cumsum(rbj.valid.astype(jnp.float32))
            u = jax.random.uniform(key, (B,)) * jnp.maximum(cdf[-1], 1.0)
            assert u.dtype == jnp.float64
            want = np.asarray(jnp.clip(jnp.searchsorted(cdf, u, side="right"),
                                       0, rbj.valid.shape[0] - 1))
            got = treplay.replay_sample(rbt, _key_t(key), B, x64=True)
            assert np.array_equal(want, got["idx"].numpy()), s
            rows = jax.device_get(jreplay.replay_sample(rbj, key, B))
            for name in ("s0", "a_dc", "r", "mask_g"):
                assert np.array_equal(np.asarray(rows[name]),
                                      got[name].numpy()), (s, name)


@pytest.fixture(scope="module")
def updated_x64():
    cj, ct, sj, st = carried_pair("onehot", seed=3)
    ct = dataclasses.replace(ct, x64=True)
    rbj, rbt = _ring()
    key = jax.random.key(42)
    with jax.enable_x64(True):
        sj2, mj = jax.jit(lambda s, r, k: jsac.sac_train_step(cj, s, r, k))(
            sj, rbj, key)
        mj = jax.device_get(mj)
        sj2 = jax.device_get(sj2)
    mt = tsac.sac_train_step(ct, st, rbt, _key_t(key))
    return cj, ct, sj2, mj, st, mt


def test_whole_update_x64_within_tolerance(updated_x64):
    """One whole update at the published widths, the JAX update under x64
    against the port's with ``SACConfig.x64``, held as
    ``tests/test_torch_rl_learn_update.py`` holds the float32 clock's."""
    cj, ct, sj2, mj, st, mt = updated_x64
    assert set(mj) == set(mt)
    for k in mj:
        a, b = np.asarray(mj[k]), mt[k].numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), k
        assert np.all(np.abs(a - b) <= METRIC_RTOL * np.abs(a) + METRIC_ATOL), k
    a = dict(_leaves(bridge.flax_sac_to_numpy(jax.tree.map(np.asarray, sj2))))
    b = dict(_leaves(bridge.sac_to_numpy(ct, st)))
    assert set(a) == set(b)
    for path, x in a.items():
        y = b[path]
        assert x.dtype == y.dtype and x.shape == y.shape, path
        d = np.abs(x.astype(np.float64) - y.astype(np.float64))
        group = path.split(".")[0]
        if group in ("enc_params", "actor_params", "critic_params"):
            assert d.max() <= 2 * LR and np.median(d) <= LR / 100, path
        elif group == "target_critic_params":
            assert np.all(d <= 2 * LR * TAU + np.spacing(np.abs(x))), path
        elif path.endswith(".count") or path in ("step", "log_alpha"):
            assert np.array_equal(x, y), path
        elif group == "cmdp":
            assert _ulps(x, y).max() <= LAM_ULP, path
        else:  # Adam's moments
            assert d.max() <= MOMENT_RTOL * max(np.abs(x).max(), 1e-30), path
