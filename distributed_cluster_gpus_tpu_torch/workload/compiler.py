"""The workload compiler: scenario specs -> per-chunk pregenerated tables.

Counterpart of ``distributed_cluster_gpus_tpu/workload/compiler.py``.
:class:`WorkloadProgram` owns every arrival draw of a run: ``init_clocks``
primes each stream with draw #0, ``tables`` pregenerates the next ``n``
arrivals of every stream before a chunk's events run (on the card through
the B2 kernel, ``kernels/arrival_tables.py``), and ``advance_carries``
commits the cumulative-sum carries the chunk consumed.  Every value is a
pure function of (seed, stream, draw index) with left-fold carries, so any
chunking realizes the same arrivals bit for bit.  ``tables`` and
``advance_carries`` take a single state or a lane-stacked one (leaves
[R, ...]); with lanes, one B2 launch builds every lane's tables.

Stream kind -> family: ``off``, ``poisson`` (gap fold ``t' = t + Exp/rate``),
``sinusoid`` with |amp| <= 1 (``sin_inv``: epoch-anchored inversion of the
integrated rate), ``sinusoid`` with |amp| > 1 (``thinning``: the
sequential replay of the rejection loop), ``trace`` (cursor gathers of the
replayed times and sizes) and ``rate_timeline`` (``S' = S + Exp`` fold and
the inversion of the piecewise-linear integrated rate).  A run whose
workload declares price or carbon timelines also carries them here
(``signals``, :func:`~.signals.compile_signals`).

The reference's ``DCG_ARRIVAL_PREGEN=0`` switch (thinning for every
sinusoid, the legacy draw chain) has no environment counterpart: the
thinning family serves |amp| > 1, and the plain tables take the
reference's ``inversion=False`` argument so a test can hold the thinning
replay against the legacy draws on |amp| <= 1 streams too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.arrival_tables import (CONST_FAMILIES, CUM_FAMILIES, FAM_OFF,
                                      FAM_POISSON, FAM_RATE_TL, FAM_SIN_INV,
                                      FAM_THIN, FAM_TRACE, M_OFF,
                                      arrival_tables, invert_timeline,
                                      pack_consts)
from ..ops import prng
from ..ops.arrivals import (MODE_OFF, MODE_POISSON, MODE_SINUSOID,
                            ArrivalParams, next_interarrival)
from .signals import compile_signals
from .spec import StreamSpec, WorkloadSpec

_FAMILY_CODE = {"off": FAM_OFF, "poisson": FAM_POISSON, "sin_inv": FAM_SIN_INV,
                "trace": FAM_TRACE, "rate_timeline": FAM_RATE_TL,
                "thinning": FAM_THIN}


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
        signals=None, name="legacy_params")


def compile_workload(fleet, params, device="cuda") -> "WorkloadProgram":
    """(fleet, SimParams) -> the run's WorkloadProgram on ``device`` (the
    card unless the caller asks for the CPU)."""
    spec = params.workload if params.workload is not None else legacy_spec(params)
    return WorkloadProgram(fleet, params, spec, device=device)


class WorkloadProgram:
    """Compiled workload for one (fleet, params, spec) on one device.

    ``inversion=False`` (tests only) compiles every sinusoid stream to the
    thinning replay, as the reference's ``inversion=False`` tables do."""

    def __init__(self, fleet, params, spec: WorkloadSpec, device="cuda",
                 inversion: bool = True):
        self.fleet = fleet
        self.params = params
        self.spec = spec
        self.inversion = inversion
        self.device = resolve_device(device)
        self.streams = spec.resolve(fleet.n_ing)
        # flat stream order is ing * 2 + jt (the clock-matrix layout and the
        # key-fold chain's stream id)
        self.flat = tuple(self.streams[i][j]
                          for i in range(fleet.n_ing) for j in (0, 1))
        self.n_streams = len(self.flat)
        self.signals = compile_signals(spec.signals, fleet, self.device)
        for s, st in enumerate(self.flat):
            self._check_stream(s, st)
        self.families = tuple(self._family(st) for st in self.flat)
        codes = [_FAMILY_CODE[f] for f in self.families]
        self.family_t = torch.tensor(codes, dtype=torch.int32,
                                     device=self.device)
        self.sparams = torch.tensor(
            [[st.rate, st.amp, st.period, st.phase_s] for st in self.flat],
            dtype=torch.float32, device=self.device)
        self._uses_cum = torch.tensor([c in CUM_FAMILIES for c in codes],
                                      device=self.device)
        # the trace / timeline / thinning constants, packed once per clock
        self._codes = codes
        self._consts = {}

    @staticmethod
    def _check_stream(s: int, st: StreamSpec) -> None:
        """The reference's checks of trace and timeline constants."""
        if st.kind == "trace":
            times = np.asarray(st.times, np.float64).reshape(-1)
            if times.size and np.any(np.diff(times) < 0):
                raise ValueError(
                    f"trace stream {s}: times must be non-decreasing")
            if st.sizes is not None:
                sizes = np.asarray(st.sizes, np.float32).reshape(-1)
                if sizes.shape != times.shape:
                    raise ValueError(
                        f"trace stream {s}: {sizes.shape[0]} sizes for "
                        f"{times.shape[0]} times")
        elif st.kind == "rate_timeline":
            rates = np.asarray(st.rates, np.float64).reshape(-1)
            if rates.size == 0 or np.any(~np.isfinite(rates)) \
                    or np.any(rates < 0):
                raise ValueError(
                    f"rate_timeline stream {s}: rates must be finite "
                    "and >= 0")
            if st.periodic and rates.sum() <= 0:
                raise ValueError(
                    f"rate_timeline stream {s}: periodic timeline "
                    "needs a positive total rate")

    def _family(self, st: StreamSpec) -> str:
        if st.kind == "sinusoid":
            if abs(st.amp) > 1.0 or not self.inversion:
                return "thinning"
            return "sin_inv"
        return st.kind  # off | poisson | trace | rate_timeline

    def consts(self, tdtype):
        """The packed per-stream constants (``kernels.arrival_tables.
        pack_consts``) for the clock's dtype, or None when no stream needs
        them."""
        if not any(c in CONST_FAMILIES for c in self._codes):
            return None
        if tdtype not in self._consts:
            self._consts[tdtype] = pack_consts(self._codes, self.flat, tdtype,
                                               self.device)
        return self._consts[tdtype]

    def uses_cum(self) -> torch.Tensor:
        """[S] bool: streams whose fold carry is the cumulative Exp sum."""
        return self._uses_cum

    @staticmethod
    def _arr_p(st: StreamSpec) -> ArrivalParams:
        mode = {"off": MODE_OFF, "poisson": MODE_POISSON,
                "sinusoid": MODE_SINUSOID}[st.kind]
        return ArrivalParams(mode=mode, rate=st.rate, amp=st.amp,
                             period=st.period)

    def init_clocks(self, arr_key, tdtype=torch.float32):
        """{"next_arrival", "arr_cum", "arr_epoch"} — [n_ing, 2] tensors in
        the clock's dtype ``tdtype`` (whose draws are float64 under the
        float64 clock).

        Draw #0 of every stream uses the unsplit fold key
        ``fold_in(fold_in(arr_key, s), 0)``, as the reference's
        ``init_state`` does: the thinning draw for off, poisson and
        sinusoid streams; a trace starts at its first time (inf when
        empty); a timeline at the inversion of its first Exp draw, which
        is also its cumulative carry."""
        dev = arr_key.device
        x64 = tdtype == torch.float64
        consts = self.consts(tdtype)
        t0s, cums = [], []
        for s, st in enumerate(self.flat):
            k0 = prng.fold_in(prng.fold_in(arr_key, s), 0)
            cum = torch.zeros((), dtype=tdtype, device=dev)
            if st.kind in ("off", "poisson", "sinusoid"):
                t0 = next_interarrival(k0, self._arr_p(st), st.phase_s, tdtype)
            elif st.kind == "trace":
                off, length = consts.meta[s, M_OFF].item(), len(st.times)
                t0 = (consts.cbuf[off] if length
                      else torch.tensor(math.inf, dtype=tdtype, device=dev))
            else:  # rate_timeline: e0, then its inversion
                e0 = (prng.exponential64(k0) if x64
                      else prng.exponential(k0)).to(tdtype)
                off = consts.meta[s, M_OFF].item()
                T = len(np.asarray(st.rates).reshape(-1))
                t0 = invert_timeline(consts.cbuf[off:off + 2 * T + 3], T,
                                     bool(st.periodic), e0.reshape(1))[0]
                cum = e0
            t0s.append(t0.reshape(()).to(tdtype))
            cums.append(cum.reshape(()).to(tdtype))
        shape = (self.fleet.n_ing, 2)
        t0 = torch.stack(t0s).reshape(shape)
        return {"next_arrival": t0,
                "arr_cum": torch.stack(cums).reshape(shape),
                "arr_epoch": t0.clone()}

    def tables(self, state, n_steps: int, trace=None):
        """Pregenerate the next ``n_steps`` arrivals of every stream.

        Returns {"sizes": [S, n] f32, "tnext": [S, n], "cum": [S, n] (both
        in the clock's dtype), "c0": [S] i32} (a leading [R] for a
        lane-stacked state): the engine reads ``sizes``/``tnext`` by
        cursor and `advance_carries` commits ``cum`` after the chunk.  The
        reference's runtime trace override (``trace=``, the digital twin's
        ingest hook) is ROADMAP queue A item 16 and raises here."""
        if trace is not None:
            raise NotImplementedError(
                "runtime trace overrides (the digital twin's ingest) are not "
                "ported yet (ROADMAP queue A item 16)")
        shape = tuple(state.arr_count.shape[:-2]) + (self.n_streams,)
        c0 = state.arr_count.reshape(shape).contiguous()
        out = arrival_tables(
            state.arr_key.contiguous(), c0,
            state.next_arrival.reshape(shape).contiguous(),
            state.arr_cum.reshape(shape).contiguous(),
            state.arr_epoch.reshape(shape).contiguous(),
            self.family_t, self.sparams, n_steps,
            consts=self.consts(state.t.dtype))
        out["c0"] = c0.clone()
        return out

    def advance_carries(self, state, pre):
        """Move ``arr_cum`` to the fold value of the last table entry each
        sin_inv or rate_timeline stream consumed (the other clocks advanced
        in-step).  Updates ``state.arr_cum`` in place."""
        mask = self.uses_cum()
        shape = tuple(state.arr_count.shape[:-2]) + (self.n_streams,)
        n = pre["cum"].shape[-1]
        consumed = state.arr_count.reshape(shape) - pre["c0"].reshape(shape)
        idx = torch.clamp(consumed - 1, 0, n - 1).to(torch.int64)
        picked = torch.gather(pre["cum"].reshape(shape + (n,)), -1,
                              idx[..., None])[..., 0]
        newc = torch.where(mask & (consumed > 0), picked,
                           state.arr_cum.reshape(shape))
        state.arr_cum.copy_(newc.reshape(state.arr_cum.shape))
        return state
