"""CHSAC-AF facade: policy, replay ingest, the warm-up gate and the updates.

Counterpart of ``distributed_cluster_gpus_tpu/rl/agent.py``'s ``CHSAC_AF``.
It holds the learned state (``rl/sac.py``), the replay ring (``rl/
replay.py``) on the agent's device and the static ``SACConfig``; the engine
acts through ``policy_apply`` with ``sac`` as its parameters, and
:meth:`CHSAC_AF.train_steps` runs a chunk's updates (``sac_train_step``)
with the JAX package's key chain, bit for bit.  The reference's host
conveniences are here too: :meth:`CHSAC_AF.select_action` (one action,
through B4's device code on the card) and :meth:`CHSAC_AF.train_step` (one
update once warmed up).  On the card the update is
one CUDA graph, captured once and replayed once per update: the port's
counterpart of the JAX package's one jitted scan of a chunk's updates
(``_build_fused``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..kernels.envelope import check_config
from ..ops import prng
from .cmdp import N_COSTS, default_constraints
from .replay import ROW_FIELDS, ReplayState, replay_add_chunk, replay_init
from .sac import (SACConfig, SACState, make_policy_apply, sac_init,
                  sac_train_step)

#: the agent's key chain is decorrelated from the simulation's (which also
#: starts from key(seed)) by this fold, as in the JAX package
AGENT_FOLD = 0x7A31


class CHSAC_AF:
    """Constrained hybrid-action SAC with action-feasibility masks."""

    def __init__(self, obs_dim: int, n_dc: int, n_g_choices: int,
                 sla_p99_ms: float = 500.0,
                 power_cap: Optional[float] = None,
                 energy_budget_j: Optional[float] = None,
                 buffer_capacity: int = 200_000,
                 batch: int = 256,
                 warmup: int = 1_000,
                 seed: int = 0,
                 constraints=None,
                 critic_arch: str = "onehot",
                 x64: bool = False,
                 device="cuda"):
        self.cfg = SACConfig(
            obs_dim=obs_dim, n_dc=n_dc, n_g=n_g_choices, batch=batch,
            constraints=(constraints if constraints is not None else
                         default_constraints(sla_p99_ms, power_cap,
                                             energy_budget_j)),
            critic_arch=critic_arch, x64=x64)
        if torch.device(device).type == "cuda":
            # the card's update kernels take a stated envelope: refuse
            # outside it now, not at the first update after the warm-up
            check_config(self.cfg)
        self.device = resolve_device(device)
        self.warmup = warmup
        # the agent's threefry chain and its initial weights, both the JAX
        # package's: key, k_init = split(fold_in(key(seed), AGENT_FOLD))
        ks = prng.split(prng.fold_in(prng.key(seed, "cpu"), AGENT_FOLD), 2)
        self.key = ks[0].clone()
        # the update's device-side key chain and its CUDA graph
        # (train_steps); the graph counters say how the updates ran
        self._ukey = self._uidx = self._gstream = None
        self._graph = self._graph_sig = None
        self.graph_captures = self.graph_replays = 0
        self.sac: SACState = sac_init(self.cfg, ks[1].clone(), self.device)
        self.replay = replay_init(
            buffer_capacity, obs_dim, n_dc, n_g_choices, N_COSTS, self.device)
        self.policy_apply = make_policy_apply(self.cfg)

    @property
    def replay(self) -> ReplayState:
        return self._replay

    @replay.setter
    def replay(self, rb: ReplayState) -> None:
        self._replay = rb
        self._warm = None  # read the gate again
        self.drop_graph()

    @property
    def sac(self) -> SACState:
        return self._sac

    @sac.setter
    def sac(self, st: SACState) -> None:
        """A new learned state (``bridge.sac_from_flax`` loading weights, a
        fresh ``sac_init``): the captured update held the old one's tensors,
        so it is dropped and captured again at the next update."""
        self._sac = st
        self.drop_graph()

    def drop_graph(self) -> None:
        """Forget the captured update (its memory pool is freed)."""
        g = self._graph
        self._graph, self._graph_sig = None, None
        if g is not None:
            g.reset()

    def select_action(self, obs, mask_dc, mask_g,
                      program=None) -> Dict[str, int]:
        """One action for one observation and its masks (the reference's
        host convenience; the engine acts inside the event loop): the
        agent's key splits as the reference's does, ``self.key, k =
        split(key)``, and the DC head samples with ``split(k)[0]``, the
        GPU count with ``split(k)[1]``.  On the card the action comes from
        B4's device code (``kernels.event_scan.rl_tail_batch``, one row),
        which reads its constants from ``program``, the step program the
        agent acts in (the ``sim.engine.Engine`` built with this agent's
        ``policy_apply``); on the CPU from the plain policy."""
        dev = self.device
        if dev.type == "cuda" and program is None:
            raise ValueError(
                "select_action on the card acts through B1's RL-mode device "
                "code: pass program=, the engine the agent acts in")
        ks = prng.split(self.key, 2)
        self.key, k = ks[0].clone(), ks[1].clone()
        obs = torch.as_tensor(obs, dtype=torch.float32, device=dev)
        m_dc = torch.as_tensor(mask_dc, dtype=torch.bool, device=dev)
        m_g = torch.as_tensor(mask_g, dtype=torch.bool, device=dev)
        if dev.type == "cuda":
            from ..kernels.event_scan import rl_tail_batch

            out = rl_tail_batch(
                program, self.sac,
                torch.zeros((0, 1), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev),
                obs.reshape(1, -1).contiguous(),
                m_dc.reshape(1, -1).contiguous(),
                m_g.reshape(1, -1).contiguous(), k.reshape(1, 2).to(dev))
            a_dc, a_g = out["a_dc"][0], out["a_g"][0]
        else:
            a_dc, a_g = self.policy_apply(self.sac, obs, m_dc, m_g, k)
        return {"dc": int(a_dc), "g": int(a_g)}

    def train_step(self) -> Optional[Dict[str, torch.Tensor]]:
        """One SAC + CMDP update once warmed up, else None (the reference's
        ``train_step``): ``self.key, k = split(key)``, the update drawing
        its sample with ``split(k)[0]``; on the card through the update's
        kernels, on the CPU through their plain versions.  Returns a copy
        of the update's metrics."""
        if not self.ready:
            return None
        ks = prng.split(self.key, 2)
        self.key, k = ks[0].clone(), ks[1]
        sac_train_step(self.cfg, self.sac, self.replay, k.to(self.device))
        return {name: v.clone() for name, v in self.sac.metrics.items()}

    def ingest_chunk(self, rl_emissions: Dict[str, torch.Tensor]) -> None:
        """Write one chunk's RL transition stream into the replay ring (the
        B6a kernel on the card, one launch per window; no host read inside
        it), then read the warm-up gate once for the chunk's updates."""
        replay_add_chunk(self.replay, rl_emissions)
        self._warm = self.ready

    @property
    def ready(self) -> bool:
        """Warmed up: ``n_seen`` (monotone, unlike ``size``) reached the
        warm-up count.  One host read."""
        return int(self.replay.n_seen) >= self.warmup

    def _graph_signature(self):
        """The addresses of every tensor a captured update reads or writes:
        if any was replaced since the capture, the graph is stale."""
        st, rb = self.sac, self.replay
        ts = [*st.flat.values(), *st.shadow.values(), *st.stage.values(),
              *st.metrics.values(), st.log_alpha, st.alpha_grad,
              st.consts.taus, *st.consts.gains, self._ukey, self._uidx,
              st.cmdp.lam, st.cmdp.integral, st.cmdp.prev_err,
              *(p for m in (st.enc, st.actor, st.critic, st.target_critic)
                for p in m.parameters()),
              *(getattr(rb, f) for f in ROW_FIELDS), rb.valid]
        for opt in (st.enc_opt, st.actor_opt, st.critic_opt, st.alpha_opt):
            ts += [opt.count, opt.mu, opt.nu]
        return (id(st), id(rb), id(st.cmdp), tuple(t.data_ptr() for t in ts))

    def _update(self, plain: bool) -> None:
        """One update of the chunk: its key is update ``_uidx`` of the
        chunk key ``_ukey``, both read on the device; the update advances
        the index (on the device, inside B6b's draw)."""
        sac_train_step(self.cfg, self.sac, self.replay, self._ukey,
                       plain=plain, index=self._uidx)

    def _capture(self) -> None:
        """Capture one update as a CUDA graph on the agent's side stream,
        after one eager update there (a real update: the chunk's first,
        which also warms the stream up for cuBLAS).  Capture
        records the update's launches without running them, so the host's
        step count is restored.  A failed capture raises."""
        dev = self.device
        if self._gstream is None:
            self._gstream = torch.cuda.Stream(dev)
        s = self._gstream
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            self._update(False)
        torch.cuda.current_stream(dev).wait_stream(s)
        g = torch.cuda.CUDAGraph()
        step = self.sac.step
        with torch.cuda.graph(g, stream=s):
            self._update(False)
        self.sac.step = step
        self._graph, self._graph_sig = g, self._graph_signature()
        self.graph_captures += 1

    def train_steps(self, n_train: int, max_steps: int = 256,
                    plain: bool = False, graph: bool = True,
                    ) -> Tuple[Optional[Dict[str, torch.Tensor]], int]:
        """Up to ``min(n_train, max_steps)`` SAC updates once warmed up;
        returns (a copy of the last update's metrics or None, updates
        executed).  The key chain is the JAX package's: ``self.key, k =
        split(key)``; update i of the chunk uses ``split(k, max_steps)[i]``
        (``fold_in(k, i)``), whatever the number of updates run.  ``k``'s
        words are written to the device once a chunk (by fills, so the host
        neither copies nor waits) and the update index lives there, so
        nothing is read back from the card; the gate is the one
        :meth:`ingest_chunk` read.

        On the card (``plain`` and ``graph`` at their defaults) the update
        runs as a CUDA graph: captured once (the first update runs eagerly
        before the capture) and replayed once per update; a graph whose
        tensors were replaced is captured again.  ``graph=False`` runs every
        update eagerly through the kernels, ``plain=True`` through their
        plain versions; on the CPU updates are eager."""
        ks = prng.split(self.key, 2)
        self.key, k = ks[0].clone(), ks[1]
        if self._warm is None:  # a ring set since the last ingest: read once
            self._warm = self.ready
        n_done = min(n_train, max_steps) if self._warm and n_train > 0 else 0
        if n_done == 0:
            return None, 0
        dev = self.device
        if self._ukey is None:
            self._ukey = torch.zeros(2, dtype=torch.int64, device=dev)
            self._uidx = torch.zeros((), dtype=torch.int32, device=dev)
        for i, word in enumerate(k.tolist()):  # fills: no copy, no sync
            self._ukey[i].fill_(word)
        self._uidx.zero_()
        if dev.type == "cuda" and graph and not plain:
            if self._graph is not None and \
                    self._graph_sig != self._graph_signature():
                self.drop_graph()
            n_eager = 0
            if self._graph is None:
                self._capture()
                n_eager = 1
            for _ in range(n_done - n_eager):
                self._graph.replay()
            self.sac.step += n_done - n_eager
            self.graph_replays += n_done - n_eager
        else:
            for _ in range(n_done):
                self._update(plain)
        return {name: v.clone() for name, v in self.sac.metrics.items()}, n_done
