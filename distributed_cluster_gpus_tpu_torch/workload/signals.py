"""Time-varying price and carbon signal timelines, sampled on the device.

Counterpart of ``distributed_cluster_gpus_tpu/workload/signals.py``.  A
compiled signal set is two device tensors and their bins; a sample is one
multiply, a floor, a wrap or clamp and one gather, in the clock's dtype.
The static paper world (the fleet's 24-entry hourly price and its constant
per-DC carbon) is expressible exactly: a periodic 24-bin hourly price
timeline samples to ``price_hourly[hour]`` and a [1, n_dc] carbon timeline
is the constant map.

The bin of a time ``t`` is ``floor(t * fl(1 / bin_s))``: XLA rewrites the
reference's ``t / bin_s`` (a division by a constant) into a multiply by the
reciprocal rounded to the clock's dtype (read from its optimized CPU HLO),
so the port multiplies by that reciprocal too (:meth:`CompiledSignals.
inv_value`, which the kernels take as an operand).  A periodic
timeline wraps the bin with ``jnp.mod``'s semantics (the divisor's sign),
then every bin is clipped into the table.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.arrivals import tmod
from .spec import SignalSpec


@dataclasses.dataclass(frozen=True)
class CompiledSignals:
    """Device timelines for one (spec, fleet) pair on one device.

    ``price`` [T_p] USD/kWh and ``carbon`` [T_c, n_dc] gCO2/kWh (float32)
    are piecewise-constant from t = 0, each over its own bin width (a spec
    that declares one half keeps the fleet's hourly table for the other);
    ``periodic`` wraps at the timeline's length, else the last bin extends.
    ``observe`` extends the RL observation by 1 + n_dc features."""

    price: torch.Tensor  # [T_p] f32
    carbon: torch.Tensor  # [T_c, n_dc] f32
    price_bin_s: float
    carbon_bin_s: float
    price_periodic: bool
    carbon_periodic: bool
    observe: bool
    #: the bins' reciprocals by (half, dtype), built once (``inv_bin``)
    _inv: dict = dataclasses.field(default_factory=dict, compare=False,
                                   repr=False)

    def inv_value(self, which: str, dtype) -> float:
        """fl(1 / bin_s) of the ``price`` or ``carbon`` half, rounded to
        ``dtype`` (float32 or float64), on the host: the reciprocal XLA
        multiplies by (numpy's float32 division rounds once, as the
        card's does)."""
        bin_s = self.price_bin_s if which == "price" else self.carbon_bin_s
        if dtype == torch.float64:
            return 1.0 / bin_s
        return float(np.float32(1.0) / np.float32(bin_s))

    def inv_bin(self, which: str, dtype) -> torch.Tensor:
        """:meth:`inv_value` as a 0-d tensor on the timelines' device."""
        key = (which, dtype)
        if key not in self._inv:
            self._inv[key] = torch.tensor(self.inv_value(which, dtype),
                                          dtype=dtype, device=self.price.device)
        return self._inv[key]

    @staticmethod
    def _bin(t, inv, n_bins: int, periodic: bool):
        # the bin in the clock's dtype: a float64 week-scale t cast to
        # float32 first would move events near a boundary into the next bin
        idx = torch.floor(t * inv)
        if periodic:
            idx = tmod(idx, torch.tensor(float(n_bins), dtype=idx.dtype,
                                         device=idx.device))
        return torch.clamp(idx, 0, n_bins - 1).to(torch.int64)

    def price_bin(self, t):
        return self._bin(t, self.inv_bin("price", t.dtype),
                         int(self.price.shape[0]), self.price_periodic)

    def carbon_bin(self, t):
        return self._bin(t, self.inv_bin("carbon", t.dtype),
                         int(self.carbon.shape[0]), self.carbon_periodic)

    def price_at(self, t):
        """USD/kWh at simulated time ``t`` (0-d f32; ``t`` a 0-d tensor in
        the clock's dtype)."""
        return self.price[self.price_bin(t)]

    def carbon_at(self, t):
        """[n_dc] gCO2/kWh at simulated time ``t``."""
        return self.carbon[self.carbon_bin(t)]


def compile_signals(spec: Optional[SignalSpec], fleet,
                    device="cuda") -> Optional[CompiledSignals]:
    """SignalSpec -> CompiledSignals on ``device`` (None spec -> None:
    signals off).  A half the spec leaves out falls back to the fleet's
    static table with its own hourly bins and daily wrap, so a spec that
    varies only the price keeps the static carbon map (and vice versa)."""
    if spec is None:
        return None
    dev = resolve_device(device)
    n_dc = fleet.n_dc
    price_bin_s = carbon_bin_s = float(spec.bin_s)
    price_periodic = carbon_periodic = bool(spec.periodic)
    if spec.price is not None:
        price = np.asarray(spec.price, np.float32).reshape(-1)
    else:
        # the fallback keeps its hourly bins and daily wrap: resampling the
        # 24-entry tariff onto another bin_s would stretch the day
        price = np.asarray(fleet.price_hourly, np.float32)
        price_bin_s, price_periodic = 3600.0, True
    if spec.carbon is not None:
        carbon = np.asarray(spec.carbon, np.float32)
        if carbon.ndim == 1:
            carbon = carbon[None, :]
        if carbon.shape[-1] != n_dc:
            raise ValueError(
                f"carbon timeline has {carbon.shape[-1]} DC columns for a "
                f"{n_dc}-DC fleet")
    else:
        carbon = np.asarray(fleet.carbon, np.float32)[None, :]
        carbon_bin_s, carbon_periodic = 3600.0, True  # constant map
    return CompiledSignals(
        price=torch.tensor(price, device=dev),
        carbon=torch.tensor(np.ascontiguousarray(carbon), device=dev),
        price_bin_s=price_bin_s, carbon_bin_s=carbon_bin_s,
        price_periodic=price_periodic, carbon_periodic=carbon_periodic,
        observe=bool(spec.observe))


def legacy_signals(fleet, observe: bool = False,
                   device="cuda") -> CompiledSignals:
    """The static paper world as timelines: a periodic hourly price and the
    constant per-DC carbon, through :func:`compile_signals` (the one
    construction path the engine uses)."""
    return compile_signals(
        SignalSpec(price=np.asarray(fleet.price_hourly, np.float64),
                   carbon=np.asarray(fleet.carbon, np.float64),
                   bin_s=3600.0, periodic=True, observe=observe), fleet,
        device)
