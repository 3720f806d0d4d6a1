"""The workload compiler: scenario specs -> per-chunk pregenerated tables.

Counterpart of ``distributed_cluster_gpus_tpu/workload/compiler.py``.
:class:`WorkloadProgram` owns every arrival draw of a run: ``init_clocks``
primes each stream with draw #0, ``tables`` pregenerates the next ``n``
arrivals of every stream before a chunk's events run (on the card through
the B2 kernel, ``kernels/arrival_tables.py``), and ``advance_carries``
commits the cumulative-sum carries the chunk consumed.  Every value is a
pure function of (seed, stream, draw index) with left-fold carries, so any
chunking realizes the same arrivals bit for bit.

Stream kind -> family: ``off``, ``poisson`` (gap fold ``t' = t + Exp/rate``)
and ``sinusoid`` with |amp| <= 1 (``sin_inv``: epoch-anchored inversion of
the integrated rate).  Thinning replay (|amp| > 1), traces and rate
timelines raise ``NotImplementedError`` (ROADMAP queue A item 4).
"""

from __future__ import annotations

import torch

from ..kernels.arrival_tables import (FAM_OFF, FAM_POISSON, FAM_SIN_INV,
                                      arrival_tables)
from ..ops import prng
from ..ops.arrivals import (MODE_OFF, MODE_POISSON, MODE_SINUSOID,
                            ArrivalParams, next_interarrival)
from .spec import StreamSpec, WorkloadSpec

_FAMILY_CODE = {"off": FAM_OFF, "poisson": FAM_POISSON, "sin_inv": FAM_SIN_INV}


def legacy_spec(params) -> WorkloadSpec:
    """The synthetic two-stream workload a plain SimParams describes (the
    training stream has period 3600 and amp 0, as in the reference)."""
    return WorkloadSpec(
        streams=(
            StreamSpec(kind=params.inf_mode, rate=params.inf_rate,
                       amp=params.inf_amp, period=params.inf_period),
            StreamSpec(kind=params.trn_mode, rate=params.trn_rate,
                       amp=0.0, period=3600.0),
        ),
        name="legacy_params")


def compile_workload(fleet, params, device="cpu") -> "WorkloadProgram":
    """(fleet, SimParams) -> the run's WorkloadProgram on ``device``."""
    spec = params.workload if params.workload is not None else legacy_spec(params)
    return WorkloadProgram(fleet, params, spec, device=device)


class WorkloadProgram:
    """Compiled workload for one (fleet, params, spec) on one device."""

    def __init__(self, fleet, params, spec: WorkloadSpec, device="cpu"):
        self.fleet = fleet
        self.params = params
        self.spec = spec
        self.device = torch.device(device)
        self.streams = spec.resolve(fleet.n_ing)
        # flat stream order is ing * 2 + jt (the clock-matrix layout and the
        # key-fold chain's stream id)
        self.flat = tuple(self.streams[i][j]
                          for i in range(fleet.n_ing) for j in (0, 1))
        self.n_streams = len(self.flat)
        self.families = tuple(self._family(st) for st in self.flat)
        self.family_t = torch.tensor([_FAMILY_CODE[f] for f in self.families],
                                     dtype=torch.int32, device=self.device)
        self.sparams = torch.tensor(
            [[st.rate, st.amp, st.period, st.phase_s] for st in self.flat],
            dtype=torch.float32, device=self.device)

    @staticmethod
    def _family(st: StreamSpec) -> str:
        if st.kind == "sinusoid":
            if abs(st.amp) > 1.0:
                raise NotImplementedError(
                    "sinusoid streams with |amp| > 1 need the sequential "
                    "thinning replay, not ported yet (ROADMAP queue A item 4)")
            return "sin_inv"
        return st.kind

    def uses_cum(self) -> torch.Tensor:
        """[S] bool: streams whose fold carry is the cumulative Exp sum."""
        return self.family_t == FAM_SIN_INV

    @staticmethod
    def _arr_p(st: StreamSpec) -> ArrivalParams:
        mode = {"off": MODE_OFF, "poisson": MODE_POISSON,
                "sinusoid": MODE_SINUSOID}[st.kind]
        return ArrivalParams(mode=mode, rate=st.rate, amp=st.amp,
                             period=st.period)

    def init_clocks(self, arr_key, tdtype=torch.float32):
        """{"next_arrival", "arr_cum", "arr_epoch"} — [n_ing, 2] tensors.

        Draw #0 of every stream uses the unsplit fold key
        ``fold_in(fold_in(arr_key, s), 0)`` and the thinning draw, as the
        reference's ``init_state`` does."""
        if tdtype != torch.float32:
            raise NotImplementedError(
                "the float64 clock is not ported yet (ROADMAP queue A item 6)")
        t0s = []
        for s, st in enumerate(self.flat):
            k0 = prng.fold_in(prng.fold_in(arr_key, s), 0)
            t0s.append(next_interarrival(k0, self._arr_p(st), st.phase_s)
                       .reshape(()))
        shape = (self.fleet.n_ing, 2)
        t0 = torch.stack(t0s).reshape(shape)
        return {"next_arrival": t0,
                "arr_cum": torch.zeros(shape, dtype=tdtype, device=arr_key.device),
                "arr_epoch": t0.clone()}

    def tables(self, state, n_steps: int):
        """Pregenerate the next ``n_steps`` arrivals of every stream.

        Returns {"sizes": [S, n] f32, "tnext": [S, n], "cum": [S, n],
        "c0": [S] i32}: the engine reads ``sizes``/``tnext`` by cursor and
        `advance_carries` commits ``cum`` after the chunk."""
        S = self.n_streams
        c0 = state.arr_count.reshape(S).contiguous()
        out = arrival_tables(
            state.arr_key.contiguous(), c0,
            state.next_arrival.reshape(S).contiguous(),
            state.arr_cum.reshape(S).contiguous(),
            state.arr_epoch.reshape(S).contiguous(),
            self.family_t, self.sparams, n_steps)
        out["c0"] = c0.clone()
        return out

    def advance_carries(self, state, pre):
        """Move ``arr_cum`` to the fold value of the last table entry each
        sin_inv stream consumed (poisson clocks advanced in-step).  Updates
        ``state.arr_cum`` in place."""
        mask = self.uses_cum()
        S = self.n_streams
        n = pre["cum"].shape[1]
        consumed = state.arr_count.reshape(S) - pre["c0"]
        idx = torch.clamp(consumed - 1, 0, n - 1).to(torch.int64)
        picked = pre["cum"][torch.arange(S, device=idx.device), idx]
        newc = torch.where(mask & (consumed > 0), picked,
                           state.arr_cum.reshape(S))
        state.arr_cum.copy_(newc.reshape(state.arr_cum.shape))
        return state
