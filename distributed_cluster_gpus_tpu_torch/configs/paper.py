"""The paper world: fleet, DVFS coefficients, WAN topology, carbon, prices.

Counterpart of ``distributed_cluster_gpus_tpu/configs/paper.py`` (the
constants and the three fleet builders): 8 DCs (1,488 GPUs across 8 GPU
models), a shared 8-level DVFS ladder, per-(DC, jtype) power/latency
coefficients, 8 ingress gateways over a WAN latency graph, carbon intensity
for 3 DCs and an hourly energy price.  The fleet is host numpy, like the
reference's; its (n, f) grids are computed with the port's torch physics.
"""

from __future__ import annotations

import numpy as np

from ..models.structs import FleetSpec, N_JTYPE
from ..network import Graph, precompute_net_matrices
from ..ops.optimizers import nf_energy_table
from ..ops.physics import LatencyCoeffs, PowerCoeffs

FREQ_LEVELS = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

# name -> (p_idle, p_peak, p_sleep, alpha)
GPU_TYPES = {
    "A100-SXM4": (50.0, 400.0, 30.0, 3.0),
    "A100-PCIe": (45.0, 300.0, 28.0, 3.0),
    "H100-SXM5": (55.0, 700.0, 35.0, 3.0),
    "H100-PCIe": (45.0, 350.0, 28.0, 3.0),
    "H200-SXM": (60.0, 700.0, 38.0, 3.0),
    "H200-PCIe": (55.0, 600.0, 35.0, 3.0),
    "L4": (15.0, 72.0, 8.0, 3.0),
    "T4": (10.0, 70.0, 6.0, 3.0),
    "A10": (20.0, 150.0, 10.0, 3.0),
    "A30": (25.0, 165.0, 12.0, 3.0),
    "A40": (40.0, 300.0, 25.0, 3.0),
    "L40": (35.0, 300.0, 20.0, 3.0),
    "L40S": (40.0, 350.0, 25.0, 3.0),
}

# dc -> (gpu model, count)
FLEET = {
    "us-west": ("H100-PCIe", 16),
    "us-east": ("A100-PCIe", 32),
    "eu-west": ("L40S", 256),
    "eu-central": ("H100-SXM5", 16),
    "ap-southeast": ("L4", 128),
    "ap-northeast": ("H200-PCIe", 16),
    "sa-east": ("A30", 512),
    "me-central": ("A10", 512),
}

# (dc, jtype) -> ((alpha_p, beta_p, gamma_p), (alpha_t, beta_t, gamma_t))
COEFFS = {
    ("us-west", "training"): ((75.0, 80.0, 110.0), (0.0045, 0.032, 0.0012)),
    ("us-west", "inference"): ((95.0, 20.0, 97.0), (0.0090, 0.0018, 0.0007)),
    ("us-east", "training"): ((65.0, 60.0, 90.0), (0.0050, 0.038, 0.0014)),
    ("us-east", "inference"): ((85.0, 18.0, 80.0), (0.0080, 0.0020, 0.0009)),
    ("eu-west", "training"): ((55.0, 40.0, 70.0), (0.0060, 0.045, 0.0018)),
    ("eu-west", "inference"): ((70.0, 15.0, 60.0), (0.0050, 0.020, 0.0010)),
    ("eu-central", "training"): ((90.0, 85.0, 120.0), (0.0042, 0.030, 0.0011)),
    ("eu-central", "inference"): ((100.0, 22.0, 100.0), (0.0085, 0.0017, 0.0007)),
    ("ap-southeast", "training"): ((45.0, 20.0, 40.0), (0.0065, 0.060, 0.0022)),
    ("ap-southeast", "inference"): ((40.0, 12.0, 35.0), (0.0045, 0.025, 0.0012)),
    ("ap-northeast", "training"): ((95.0, 90.0, 125.0), (0.0040, 0.029, 0.0010)),
    ("ap-northeast", "inference"): ((105.0, 25.0, 105.0), (0.0080, 0.0016, 0.0006)),
    ("sa-east", "training"): ((50.0, 35.0, 65.0), (0.0062, 0.050, 0.0019)),
    ("sa-east", "inference"): ((65.0, 14.0, 55.0), (0.0055, 0.022, 0.0011)),
    ("me-central", "training"): ((40.0, 25.0, 50.0), (0.0068, 0.055, 0.0023)),
    ("me-central", "inference"): ((55.0, 12.0, 45.0), (0.0050, 0.023, 0.0012)),
}

# the 1-DC debug topology: us-west with 128 x H100-PCIe
SINGLE_DC_COEFFS = {
    ("us-west", "training"): ((75.0, 80.0, 110.0), (0.0005, 0.05, 0.0003)),
    ("us-west", "inference"): ((95.0, 20.0, 97.0), (0.002, 0.004, 0.0001)),
}

# Symmetric ingress<->DC latencies (ms). Each entry adds both directions.
WAN_EDGES_MS = [
    ("gw-us-west", "us-west", 12),
    ("gw-us-west", "us-east", 70),
    ("gw-us-west", "eu-central", 110),
    ("gw-us-west", "ap-southeast", 150),
    ("gw-us-east", "us-east", 10),
    ("gw-us-east", "us-west", 70),
    ("gw-us-east", "eu-west", 90),
    ("gw-us-east", "sa-east", 110),
    ("gw-eu-west", "eu-west", 10),
    ("gw-eu-west", "eu-central", 20),
    ("gw-eu-west", "us-east", 90),
    ("gw-eu-west", "ap-northeast", 190),
    ("gw-eu-central", "eu-central", 10),
    ("gw-eu-central", "me-central", 60),
    ("gw-eu-central", "ap-southeast", 170),
    ("gw-ap-southeast", "ap-southeast", 8),
    ("gw-ap-southeast", "ap-northeast", 60),
    ("gw-ap-southeast", "eu-central", 170),
    ("gw-ap-northeast", "ap-northeast", 8),
    ("gw-ap-northeast", "us-west", 130),
    ("gw-ap-northeast", "eu-west", 190),
    ("gw-sa-east", "sa-east", 12),
    ("gw-sa-east", "us-east", 110),
    ("gw-sa-east", "eu-west", 150),
    ("gw-me-central", "me-central", 10),
    ("gw-me-central", "eu-central", 60),
    ("gw-me-central", "ap-southeast", 120),
]

INGRESS_REGIONS = {
    "gw-us-west": "US",
    "gw-us-east": "US",
    "gw-eu-west": "EU",
    "gw-eu-central": "EU",
    "gw-ap-southeast": "APAC",
    "gw-ap-northeast": "APAC",
    "gw-sa-east": "SA",
    "gw-me-central": "ME",
}

CARBON_INTENSITY = {  # gCO2/kWh; DCs not listed default to 0.0
    "us-west": 350.0,
    "eu-central": 220.0,
    "ap-southeast": 500.0,
}

JTYPE_NAMES = ("inference", "training")


def energy_price_hourly() -> np.ndarray:
    """USD/kWh by hour of day: off-peak 0.12, peak 0.20, evening 0.16."""
    price = np.empty(24, dtype=np.float32)
    price[0:7] = 0.12
    price[7:19] = 0.20
    price[19:24] = 0.16
    return price


def _build_spec(fleet, coeffs, edges, ingress_regions, carbon, n_max: int) -> FleetSpec:
    dc_names = tuple(fleet.keys())
    ingress_names = tuple(ingress_regions.keys())
    n_dc = len(dc_names)

    gpu_names, totals, p_idle, p_peak, p_sleep, alpha = [], [], [], [], [], []
    for dc in dc_names:
        gpu, count = fleet[dc]
        pi, pp, ps, al = GPU_TYPES[gpu]
        gpu_names.append(gpu)
        totals.append(count)
        p_idle.append(pi)
        p_peak.append(pp)
        p_sleep.append(ps)
        alpha.append(al)

    pw = np.zeros((n_dc, N_JTYPE, 3), dtype=np.float32)
    lt = np.zeros((n_dc, N_JTYPE, 3), dtype=np.float32)
    for d, dc in enumerate(dc_names):
        for j, jt in enumerate(JTYPE_NAMES):
            pw[d, j], lt[d, j] = coeffs[(dc, jt)]
    power = PowerCoeffs(pw[..., 0], pw[..., 1], pw[..., 2])
    latency = LatencyCoeffs(lt[..., 0], lt[..., 1], lt[..., 2])

    g = Graph()
    for u, v, ms in edges:
        g.add_edge(u, v, ms)
        g.add_edge(v, u, ms)
    net = precompute_net_matrices(g, list(ingress_names), list(dc_names))

    freq = np.asarray(FREQ_LEVELS, dtype=np.float32)
    T, P, E = nf_energy_table(n_max, freq, power, latency)

    return FleetSpec(
        dc_names=dc_names,
        ingress_names=ingress_names,
        gpu_names=tuple(gpu_names),
        total_gpus=np.asarray(totals, dtype=np.int32),
        p_idle=np.asarray(p_idle, dtype=np.float32),
        p_peak=np.asarray(p_peak, dtype=np.float32),
        p_sleep=np.asarray(p_sleep, dtype=np.float32),
        gpu_alpha=np.asarray(alpha, dtype=np.float32),
        power_gating=np.ones(n_dc, dtype=bool),
        freq_levels=freq,
        default_f_idx=len(FREQ_LEVELS) - 1,  # default_freq = 1.0
        power=power,
        latency=latency,
        carbon=np.asarray([carbon.get(dc, 0.0) for dc in dc_names], dtype=np.float32),
        price_hourly=energy_price_hourly(),
        net_lat_s=net["net_lat_s"].astype(np.float32),
        transfer_s=net["transfer_s"].astype(np.float32),
        T_grid=T.numpy(),
        P_grid=P.numpy(),
        E_grid=E.numpy(),
    )


def build_fleet(n_max: int = 8) -> FleetSpec:
    """The canonical 8-DC / 8-ingress paper world."""
    return _build_spec(FLEET, COEFFS, WAN_EDGES_MS, INGRESS_REGIONS, CARBON_INTENSITY, n_max)


def build_single_dc_fleet(n_max: int = 8) -> FleetSpec:
    """The 1-DC debug world: us-west with 128 x H100-PCIe, one gateway."""
    fleet = {"us-west": ("H100-PCIe", 128)}
    edges = [("gw-us-west", "us-west", 12)]
    regions = {"gw-us-west": "US"}
    return _build_spec(fleet, SINGLE_DC_COEFFS, edges, regions, {}, n_max)


def build_duo_fleet(n_max: int = 4) -> FleetSpec:
    """The tiny 2-DC / 2-ingress world of the reference's fault/obs suites."""
    fleet = {"us-west": ("H100-PCIe", 16), "us-east": ("A100-PCIe", 16)}
    edges = [e for e in WAN_EDGES_MS
             if e[0] in ("gw-us-west", "gw-us-east")
             and e[1] in ("us-west", "us-east")]
    regions = {k: v for k, v in INGRESS_REGIONS.items()
               if k in ("gw-us-west", "gw-us-east")}
    return _build_spec(fleet, COEFFS, edges, regions, {}, n_max)
