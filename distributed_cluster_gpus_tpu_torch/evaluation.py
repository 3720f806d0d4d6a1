"""Run summaries: energy, completions, drops and sojourn-time statistics.

Counterpart of ``Summary``, ``_lat_stats`` and ``_summarize`` in
``distributed_cluster_gpus_tpu/evaluation.py``.  The reduction reads the
final state once on the host; the p99 is the exact linear-interpolation
percentile over the latency window's valid prefix, evaluated in float32
as the reference's ``windowed_percentile`` evaluates it.  The comparison
harness (``run_algo``, ``compare``, the config builders) is ROADMAP queue A
item 7's remaining work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class Summary:
    algo: str
    energy_kwh: float
    completed_inf: int
    completed_trn: int
    dropped: int
    mean_lat_inf_s: float
    p99_lat_inf_s: float
    mean_lat_trn_s: float
    p99_lat_trn_s: float
    energy_per_unit_wh: float
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    def row(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def windowed_percentile(buf_row: np.ndarray, count: int, q: float) -> float:
    """Linear-interpolation percentile over the first ``min(count, W)``
    entries of a latency ring row, in float32."""
    W = buf_row.shape[0]
    m = int(min(count, W))
    vals = np.sort(np.asarray(buf_row[:m], np.float32))
    mf = max(m, 1)
    pos = np.float32(q / 100.0) * np.float32(mf - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, mf - 1)
    frac = pos - np.float32(lo)
    s_lo, s_hi = vals[lo], vals[hi]
    return float(s_lo * (np.float32(1.0) - frac) + s_hi * frac)


def _lat_stats(lat_buf: np.ndarray, lat_count: np.ndarray, jt: int):
    """(mean, p99) sojourn seconds of job type ``jt`` over the window."""
    m = int(min(lat_count[jt], lat_buf.shape[1]))
    if m == 0:
        return float("nan"), float("nan")
    mean = float(np.mean(lat_buf[jt, :m]))
    p99 = (windowed_percentile(lat_buf[jt], int(lat_count[jt]), 99.0)
           if m >= 5 else float("nan"))
    return mean, p99


def _summarize(algo: str, fleet, state) -> Summary:
    lat_buf = _np(state.lat.buf)
    lat_count = _np(state.lat.count)
    mean_inf, p99_inf = _lat_stats(lat_buf, lat_count, 0)
    mean_trn, p99_trn = _lat_stats(lat_buf, lat_count, 1)
    units = float(_np(state.units_finished).sum())
    kwh = float(_np(state.dc.energy_j).sum()) / 3.6e6
    n_fin = _np(state.n_finished)
    return Summary(
        algo=algo,
        energy_kwh=kwh,
        completed_inf=int(n_fin[0]),
        completed_trn=int(n_fin[1]),
        dropped=int(_np(state.n_dropped)),
        mean_lat_inf_s=mean_inf,
        p99_lat_inf_s=p99_inf,
        mean_lat_trn_s=mean_trn,
        p99_lat_trn_s=p99_trn,
        energy_per_unit_wh=kwh * 1000.0 / max(units, 1e-9),
    )
