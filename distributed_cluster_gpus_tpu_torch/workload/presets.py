"""Canonical workload scenarios: diurnal fleets, flash crowds, surges.

Counterpart of ``distributed_cluster_gpus_tpu/workload/presets.py`` (pure
numpy).  Every preset builds a plain :class:`~.spec.WorkloadSpec`, the same
object a JSON spec file loads into, so the CLI (``run_sim --workload
NAME``) and the tests take scenarios from one registry (:data:`PRESETS`).

Rates are per stream (per ingress, per jtype); the paper fleet has 8
ingresses, so the aggregate arrivals are about 8x the inference figure.
"""

from __future__ import annotations

import numpy as np

from .spec import SignalSpec, StreamSpec, WorkloadSpec

DAY_S = 86400.0
WEEK_S = 7 * DAY_S


def diurnal_rates(base: float, peak_ratio: float = 3.0, n_bins: int = 24,
                  phase_h: float = 0.0) -> np.ndarray:
    """[n_bins] arrivals/s: a smooth day curve peaking at ``peak_ratio`` x
    the trough, mean ~= base, shifted by ``phase_h`` hours (regional
    offsets)."""
    h = (np.arange(n_bins) + 0.5) * (24.0 / n_bins) + phase_h
    shape = 1.0 + (peak_ratio - 1.0) / (peak_ratio + 1.0) * np.sin(
        2.0 * np.pi * (h - 10.0) / 24.0)
    return np.maximum(0.0, base * shape / shape.mean())


def add_flash_crowd(rates: np.ndarray, bin_s: float, t0_s: float,
                    dur_s: float, mult: float) -> np.ndarray:
    """Overlay one flash-crowd window (``mult`` x rate) on a timeline."""
    out = np.asarray(rates, np.float64).copy()
    b0 = int(t0_s // bin_s)
    b1 = max(b0 + 1, int(np.ceil((t0_s + dur_s) / bin_s)))
    out[b0:b1] *= mult
    return out


def _weekly_price(fleet) -> np.ndarray:
    """[168] USD/kWh: the paper's daily tariff tiled over a week with a
    weekend off-peak discount — a genuinely time-varying price the
    static hourly table cannot express."""
    day = np.asarray(fleet.price_hourly, np.float64)
    week = np.tile(day, 7)
    week[5 * 24:] *= 0.8  # weekend discount
    return week


def _diurnal_carbon(fleet, n_bins: int = 24) -> np.ndarray:
    """[n_bins, n_dc] gCO2/kWh: per-DC carbon swinging around the static
    map (solar dip mid-day, fossil peak in the evening).  DCs without
    carbon data stay at 0 (the preserved reference quirk)."""
    base = np.asarray(fleet.carbon, np.float64)
    h = (np.arange(n_bins) + 0.5) * (24.0 / n_bins)
    swing = 1.0 + 0.35 * np.sin(2.0 * np.pi * (h - 4.0) / 24.0)
    return np.maximum(0.0, base[None, :] * swing[:, None])


def flash_crowd(fleet, *, base_rate: float = 4.0, spike_mult: float = 10.0,
                horizon_s: float = 7200.0, bin_s: float = 300.0,
                observe: bool = False) -> WorkloadSpec:
    """A two-hour probe: steady inference + one 10x flash crowd
    mid-horizon, light Poisson training, legacy-equivalent signals."""
    n_bins = int(np.ceil(horizon_s / bin_s))
    rates = np.full(n_bins, base_rate, np.float64)
    rates = add_flash_crowd(rates, bin_s, 0.4 * horizon_s,
                            0.1 * horizon_s, spike_mult)
    return WorkloadSpec(
        streams=(
            StreamSpec(kind="rate_timeline", rates=rates, bin_s=bin_s),
            StreamSpec(kind="poisson", rate=0.05),
        ),
        signals=SignalSpec(price=None, carbon=_diurnal_carbon(fleet),
                           bin_s=3600.0, periodic=True, observe=observe),
        name="flash_crowd")


def diurnal_flash_week(fleet, *, base_rate: float = 0.15,
                       trn_rate: float = 0.01,
                       observe: bool = True) -> WorkloadSpec:
    """The week-horizon capacity-planning scenario: per-region diurnal
    inference peaks staggered by each ingress's longitude band, two flash crowds (a Monday spike and
    a weekend event), training surges correlated with (lagging) the
    inference bursts, weekly price tariff and diurnal per-DC carbon —
    all observable by the routers and RL policy."""
    bin_s = 3600.0
    n_bins = int(WEEK_S // bin_s)
    # rough longitude-band phase per paper-world ingress order:
    # US, US, EU, EU, APAC, APAC, SA, ME (see configs.paper)
    phases = {"US": -8.0, "EU": 0.0, "APAC": 8.0, "SA": -5.0, "ME": 3.0}
    regions = ["US", "US", "EU", "EU", "APAC", "APAC", "SA", "ME"]
    pairs = []
    for i in range(fleet.n_ing):
        region = regions[i % len(regions)]
        day = diurnal_rates(base_rate, peak_ratio=4.0, n_bins=24,
                            phase_h=phases[region])
        inf_rates = np.tile(day, n_bins // 24 + 1)[:n_bins]
        # flash crowds: Monday 18:00 spike everywhere, Saturday event in
        # the US/EU lanes only
        inf_rates = add_flash_crowd(inf_rates, bin_s, 0 * DAY_S + 18 * 3600,
                                    2 * 3600, 6.0)
        if region in ("US", "EU"):
            inf_rates = add_flash_crowd(inf_rates, bin_s,
                                        5 * DAY_S + 12 * 3600, 3 * 3600, 4.0)
        # correlated training surge: retrain waves lag the inference
        # bursts by ~6 h at a scaled-down rate
        trn_rates = np.full(n_bins, trn_rate, np.float64)
        trn_rates += 0.08 * np.roll(inf_rates - inf_rates.mean(), 6).clip(0)
        pairs.append((
            StreamSpec(kind="rate_timeline", rates=inf_rates, bin_s=bin_s),
            StreamSpec(kind="rate_timeline", rates=trn_rates.clip(0),
                       bin_s=bin_s),
        ))
    return WorkloadSpec(
        streams=tuple(pairs),
        signals=SignalSpec(price=_weekly_price(fleet),
                           carbon=_diurnal_carbon(fleet),
                           bin_s=bin_s, periodic=True, observe=observe),
        name="diurnal_flash_week")


def legacy_signals_only(fleet, *, observe: bool = False,
                        params=None) -> WorkloadSpec:
    """The legacy synthetic arrival fields with the legacy price/carbon
    tables lifted into explicit timelines — for A/B-ing the signal path
    (time-varying columns/accruals on the exact legacy workload)."""
    from .compiler import legacy_spec

    if params is None:
        from ..models.structs import SimParams

        params = SimParams()
    base = legacy_spec(params)
    return WorkloadSpec(
        streams=base.streams,
        signals=SignalSpec(price=np.asarray(fleet.price_hourly, np.float64),
                           carbon=np.asarray(fleet.carbon, np.float64)[None, :],
                           bin_s=3600.0, periodic=True, observe=observe),
        name="legacy_signals")


PRESETS = {
    "flash_crowd": flash_crowd,
    "diurnal_flash_week": diurnal_flash_week,
    "legacy_signals": legacy_signals_only,
}


def make_preset(name: str, fleet, **kw) -> WorkloadSpec:
    if name not in PRESETS:
        raise ValueError(
            f"unknown workload preset {name!r}; choices: "
            f"{', '.join(sorted(PRESETS))}")
    return PRESETS[name](fleet, **kw)
