"""The update's tail (R1d) and B6a's scatter layout against the JAX package,
and the kernels' tail dataflow against their plain versions (CPU).

The update's small tail runs inside its region kernels' batch tails on the
card (``rl/sac.py`` module note); their plain versions are held here:

* the temperature loss with its hand-written gradient
  (``rl/sac.py::temperature``) against ``jax.value_and_grad`` of the JAX
  update's ``alpha_loss_fn`` (``distributed_cluster_gpus_tpu/rl/sac.py:
  268-273``, composed here as written there: it is local to
  ``sac_train_step``), and the entropy's mean against ``jnp.mean``: within
  ``F32_RTOL`` (float32 sums over the batch in the tree's order, XLA's in
  its own);
* the PID step (``rl/sac.py::pid_tail``) over ``PID_STEPS`` steps against
  ``rl/cmdp.py:65 update_lagrange``: lambda, the integral and the last
  error within ``LAM_ULP`` ulp (the batch mean's order differs), and
  ``r_eff``'s mean within ``F32_RTOL``;
* B5a's ``q_mean`` and, for the heads critic, the taken action's gather
  and its gradient's scatter (``quantile_huber_loss``'s ``take``) against
  ``jnp.mean`` and ``jax.value_and_grad`` through ``take_along_axis``,
  within ``F32_RTOL``;
* no ``torch.autograd`` call in the update: ``torch.autograd.grad`` and
  ``Tensor.backward`` patched to raise around one update of each path;
* the kernels' tails, replayed step by step in torch (a warp's tree over b
  as ``tests/test_torch_reduce_order.py`` replays it), bitwise against the
  plain versions;
* B6a's plain ``_add_scatter`` bitwise against the JAX ``_add_scatter``
  (``distributed_cluster_gpus_tpu/rl/replay.py:132``) on seeded chunks
  (wrapping, N = C, none valid, all valid), calling both directly, and
  ``replay_add_chunk`` in the scatter layout (``INGEST_MODE`` patched)
  against the JAX chunk cut to its newest C rows.

The gpu tests hold the kernels themselves on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu.rl import cmdp as jcmdp
from distributed_cluster_gpus_tpu.rl import replay as jreplay
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.kernels import replay_sample as b6b
from distributed_cluster_gpus_tpu_torch.ops import prng
from distributed_cluster_gpus_tpu_torch.ops.physics import tree_sum_last
from distributed_cluster_gpus_tpu_torch.rl import cmdp as tcmdp
from distributed_cluster_gpus_tpu_torch.rl import replay as treplay
from distributed_cluster_gpus_tpu_torch.rl import sac as tsac

from test_torch_reduce_order import LANE, _pow2, _same_bits, tree_regs, warp_tree
from test_torch_rl_learn_ops import (F32_RTOL, LAM_ULP, N_DC, N_G, OBS, _ulps,
                                     _window)

PID_STEPS = 5
TARGET_ENTROPY = -3.0


def _rel_close(a, b, rtol=F32_RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rtol * max(np.abs(a).max(), 1e-30)


def _count(n):
    return torch.tensor(float(n), dtype=torch.float32)


# ------------------------------------------- the plain tail against JAX


@pytest.mark.parametrize("B", [256, 37])
def test_temperature_matches_jax_value_and_grad(B):
    rng = np.random.default_rng(B)
    ent = (rng.random(B) * 4).astype(np.float32)
    log_alpha = np.float32(np.log(0.2))

    def alpha_loss_fn(la):  # distributed_cluster_gpus_tpu/rl/sac.py:268-271
        return jnp.mean(jnp.exp(la)
                        * jax.lax.stop_gradient(ent + TARGET_ENTROPY))

    v_j, g_j = jax.value_and_grad(alpha_loss_fn)(jnp.float32(log_alpha))
    h_t, v_t, g_t = tsac.temperature(torch.tensor(ent), torch.tensor(log_alpha),
                                     TARGET_ENTROPY)
    _rel_close(v_j, v_t.numpy())
    _rel_close(g_j, g_t.numpy())
    _rel_close(jnp.mean(ent), h_t.numpy())


def test_pid_tail_matches_update_lagrange():
    rng = np.random.default_rng(5)
    B = 256
    cons_j = jcmdp.default_constraints(500.0, power_cap=3e5)
    cons_t = tcmdp.default_constraints(500.0, power_cap=3e5)
    gains = tcmdp._gains(cons_t, "cpu")
    st_j = jcmdp.cmdp_init(cons_j)
    st_t = tcmdp.cmdp_init(cons_t, "cpu")
    outs = [torch.zeros(()), torch.zeros(4), torch.zeros(4)]
    for _ in range(PID_STEPS):
        costs = (rng.random((B, 4)) * np.array([900, 4e5, 2, 1e6])).astype(
            np.float32)
        r = rng.normal(size=B).astype(np.float32)
        lam_before = st_t.lam.clone()
        r_eff = tcmdp.effective_reward(torch.tensor(r), torch.tensor(costs),
                                       lam_before, gains[0])
        want_reff = jcmdp.effective_reward(r, costs, np.asarray(st_j.lam),
                                           np.asarray(gains[0]))
        st_j, viol_j = jcmdp.update_lagrange(st_j, cons_j, costs)
        tsac.pid_tail(tsac.PidTail(st_t, gains, *outs), r_eff,
                      torch.tensor(costs))
        for name in ("lam", "integral", "prev_err"):
            assert _ulps(getattr(st_j, name),
                         getattr(st_t, name).numpy()).max() <= LAM_ULP, name
        assert np.array_equal(outs[1].numpy(), st_t.lam.numpy())
        assert _ulps(viol_j, outs[2].numpy()).max() <= LAM_ULP
        _rel_close(jnp.mean(want_reff), outs[0].numpy())
    assert float(st_t.lam[0]) > 0.0 and float(st_t.integral[2]) > 0.0


@pytest.mark.parametrize("take", [False, True], ids=["onehot", "heads"])
def test_critic_loss_take_and_q_mean(take):
    rng = np.random.default_rng(23)
    B, N = 32, 32
    A = N_DC * N_G
    q_all = rng.normal(size=(B, 2, A, N)).astype(np.float32)
    a_dc = rng.integers(0, N_DC, B).astype(np.int32)
    a_g = rng.integers(0, N_G, B).astype(np.int32)
    tgt = (rng.normal(size=(B, N)) * 2).astype(np.float32)
    taus = (np.arange(N, dtype=np.float32) + 0.5) / N
    idx = (a_dc * N_G + a_g)[:, None, None, None]
    from distributed_cluster_gpus_tpu.rl import sac as jsac

    def loss_j(qq):
        if take:
            qq = jnp.take_along_axis(qq, jnp.asarray(idx), axis=2)[:, :, 0]
        return (jsac.quantile_huber_loss(qq[:, 0], tgt, taus)
                + jsac.quantile_huber_loss(qq[:, 1], tgt, taus)), jnp.mean(qq)

    q_in = q_all if take else np.take_along_axis(q_all, idx, axis=2)[:, :, 0]
    (v_j, qm_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(q_in))
    loss_out, qm_out = torch.zeros(()), torch.zeros(())
    v_t, g_t = tsac.quantile_huber_loss(
        torch.tensor(q_in), torch.tensor(tgt), torch.tensor(taus), 1.0,
        (torch.tensor(a_dc), torch.tensor(a_g), N_G) if take else None,
        loss_out, qm_out)
    assert v_t is loss_out and g_t.shape == q_in.shape
    _rel_close(v_j, v_t.numpy())
    _rel_close(g_j, g_t.numpy())
    _rel_close(qm_j, qm_out.numpy())
    if take:  # every action but the taken one has a zero gradient
        keep = np.zeros(q_in.shape, bool)
        np.put_along_axis(keep, np.broadcast_to(idx, (B, 2, 1, N)), True,
                          axis=2)
        assert (g_t.numpy()[~keep] == 0.0).all()


@pytest.fixture(scope="module")
def small_agent():
    from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF

    ag = CHSAC_AF(OBS, N_DC, N_G, buffer_capacity=256, batch=8, warmup=1,
                  device="cpu")
    ag.ingest_chunk({k: torch.from_numpy(v) for k, v in
                     _window(np.random.default_rng(3), 64, 0.7).items()})
    return ag


@pytest.mark.parametrize("plain", [False, True], ids=["kernel_path", "plain"])
def test_update_takes_no_autograd(monkeypatch, small_agent, plain):
    import inspect

    src = inspect.getsource(tsac.sac_train_step)
    assert "torch.autograd" not in src and ".backward(" not in src

    def refuse(*a, **k):
        raise AssertionError("the update called autograd")

    monkeypatch.setattr(torch.autograd, "grad", refuse)
    monkeypatch.setattr(torch.Tensor, "backward", refuse)
    m, n = small_agent.train_steps(1, 1, plain=plain)
    assert n == 1 and all(bool(torch.isfinite(v).all()) for v in m.values())
    assert int(small_agent._uidx) == 1  # B6b's draw advanced the index


def test_sample_casts_and_advances():
    rng = np.random.default_rng(9)
    rb = treplay.replay_init(300, OBS, N_DC, N_G, 4, device="cpu")
    treplay.replay_add_chunk(rb, {k: torch.from_numpy(v)
                                  for k, v in _window(rng, 200, 0.6).items()})
    key, index = prng.key(4, "cpu"), torch.tensor(3, dtype=torch.int32)
    want = treplay.replay_sample(rb, b6b.sample_key(key, index), 16)
    got = b6b.replay_sample(rb, key, 16, index=index, bf16_obs=True,
                            advance=True)
    assert int(index) == 4
    for name in treplay.ROW_FIELDS:
        w = want[name].to(torch.bfloat16) if name in ("s0", "s1") else want[name]
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name


# --------------------------- the kernels' tail dataflow, replayed in torch


def batch_tree(vals):
    """A warp's tree over b of vals [B] (element k at lane k % 32, register
    k / 32; the register levels by ``tree_regs``, then the shuffles from
    half the padded length), as every batch tail takes it: lane 0's sum."""
    B = vals.shape[0]
    Bp = _pow2(B)

    def leaf(r):
        kk = LANE + 32 * r
        return torch.where(kk < B, vals[kk.clamp(max=B - 1)], torch.zeros(()))

    return warp_tree(tree_regs(max(1, Bp // 32), leaf), min(Bp, 32))[0]


def row_sums(q):
    """B5a's per-(b, t) sum of the taken quantiles: lane i quantile i (and
    i + 32), the register level of distance 32 and the shuffles."""
    N = q.shape[-1]
    Np = _pow2(N)

    def lanes(i):
        return torch.where(i < N, q[:, :, i.clamp(max=N - 1)], torch.zeros(()))

    v = lanes(LANE)
    if Np > 32:
        v = v + lanes(LANE + 32)
    return warp_tree(v, min(Np, 32))[..., 0]  # [B, 2]


@pytest.mark.parametrize("B,N", [(1, 1), (37, 32), (256, 32), (300, 64),
                                 (4096, 32)])
def test_tail_kernels_dataflow_matches_plain_versions(B, N):
    rng = np.random.default_rng(B + N)
    # B5a's q_mean
    q = torch.from_numpy((rng.standard_normal((B, 2, N)) * 10).astype(np.float32))
    q[0, 0, 0] = -0.0
    rows = row_sums(q)
    got = (batch_tree(rows[:, 0]) + batch_tree(rows[:, 1])) / _count(2 * B * N)
    qm = torch.zeros(())
    tsac.quantile_huber_loss(q, torch.zeros(B, 4), torch.full((N,), 0.5),
                             q_mean_out=qm)
    assert _same_bits(got, qm)
    # B5b actor term's temperature tail
    ent = torch.from_numpy((rng.random(B) * 4).astype(np.float32))
    la = torch.tensor(np.float32(np.log(0.37)))
    e = torch.exp(la)
    x = ent + np.float32(TARGET_ENTROPY)
    fb = _count(B)
    got = (batch_tree(ent) / fb, batch_tree(e * x) / fb,
           batch_tree(x * (1.0 / fb)) * e)
    for a, b in zip(got, tsac.temperature(ent, la, TARGET_ENTROPY)):
        assert _same_bits(a, b)
    # B5b target's PID tail: the means by the warp tree, the step op for op
    costs = torch.from_numpy((rng.random((B, 4)) * 900).astype(np.float32))
    r_eff = torch.from_numpy(rng.standard_normal(B).astype(np.float32))
    gains = tcmdp._gains(tcmdp.default_constraints(500.0, power_cap=400.0),
                         "cpu")
    st = tcmdp.cmdp_init(tcmdp.default_constraints(500.0), "cpu")
    st.integral.copy_(torch.tensor([0.5, 0.0, 1.25, 0.0]))
    st.prev_err.copy_(torch.tensor([3.0, 0.0, 0.0, 1.0]))
    tgt, kp, ki, kd, lmax = gains
    err = torch.stack([batch_tree(torch.clamp_min(costs[:, c] - tgt[c], 0.0))
                       for c in range(4)]) / fb
    integral = st.integral + err
    lam = torch.minimum(torch.clamp_min(
        kp * err + ki * integral + kd * (err - st.prev_err), 0.0), lmax)
    outs = [torch.zeros(()), torch.zeros(4), torch.zeros(4)]
    tsac.pid_tail(tsac.PidTail(st, gains, *outs), r_eff, costs)
    assert _same_bits(batch_tree(r_eff) / fb, outs[0])
    for a, b in ((lam, st.lam), (integral, st.integral), (err, st.prev_err),
                 (lam, outs[1]), (err, outs[2])):
        assert _same_bits(a, b)


def test_batch_tree_is_the_plain_tree():
    rng = np.random.default_rng(0)
    for B in (1, 3, 32, 33, 255, 4096):
        v = torch.from_numpy(rng.standard_normal(B).astype(np.float32))
        assert _same_bits(batch_tree(v), tree_sum_last(v))


# ------------------------------------------------ B6a, the scatter layout


SCATTER = {  # capacity, chunk sizes, valid fraction
    "wrap": (100, [70, 90, 60], 0.6),
    "n_equals_c": (100, [100, 100], 0.5),
    "none_valid": (100, [40, 100], 0.0),
    "all_valid": (100, [64, 64, 100], 1.0),
}


@pytest.mark.parametrize("case", sorted(SCATTER))
def test_add_scatter_bitwise(case):
    C, sizes, pv = SCATTER[case]
    rng = np.random.default_rng(len(case) + C)
    rb_j = jreplay.replay_init(C, OBS, N_DC, N_G, 4)
    rb_t = treplay.replay_init(C, OBS, N_DC, N_G, 4, device="cpu")
    add_j = jax.jit(jreplay._add_scatter)
    for N in sizes:
        w = _window(rng, N, pv)
        rb_j = add_j(rb_j, {k: jnp.asarray(v) for k, v in w.items()})
        treplay._add_scatter(rb_t, {k: torch.from_numpy(v) for k, v in w.items()})
        assert bridge.tree_mismatches(
            bridge.tree_to_numpy(jax.device_get(rb_j)),
            bridge.tree_to_numpy(rb_t, bridge.tensor_leaf)) == [], N
    if case == "none_valid":
        assert int(rb_t.n_seen) == 0 and int(rb_t.ptr) == 0


def test_scatter_chunk_keeps_the_newest_rows(monkeypatch):
    monkeypatch.setattr(treplay, "INGEST_MODE", "scatter")
    C = 100
    rng = np.random.default_rng(31)
    w = _window(rng, 260, 0.7)
    rb_j = jreplay._add_scatter(jreplay.replay_init(C, OBS, N_DC, N_G, 4),
                                {k: jnp.asarray(v[-C:]) for k, v in w.items()})
    rb_t = treplay.replay_init(C, OBS, N_DC, N_G, 4, device="cpu")
    treplay.replay_add_chunk(rb_t, {k: torch.from_numpy(v) for k, v in w.items()})
    assert bridge.tree_mismatches(bridge.tree_to_numpy(jax.device_get(rb_j)),
                                  bridge.tree_to_numpy(rb_t, bridge.tensor_leaf)) == []
