"""WAN topology: directed latency graph + all-pairs shortest-path precompute.

Host-side numpy, a copy of ``distributed_cluster_gpus_tpu/network.py``:
the graph is tiny (16 nodes in the paper world), so shortest paths are
solved once at config time and the engine only gathers from the resulting
[n_ingress, n_dc] matrices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Edge:
    to: str
    latency_ms: float
    capacity_gbps: float = math.inf
    cost_per_gb: float = 0.0


@dataclass
class Graph:
    """Directed WAN graph keyed by node name (ingress or DC)."""

    adj: Dict[str, List[Edge]] = field(default_factory=dict)
    _apsp: Optional[tuple] = field(default=None, repr=False, compare=False)

    def add_edge(self, u: str, v: str, latency_ms: float,
                 capacity_gbps: float = math.inf, cost_per_gb: float = 0.0) -> None:
        self.adj.setdefault(u, []).append(Edge(v, latency_ms, capacity_gbps, cost_per_gb))
        self._apsp = None

    def _all_pairs(self):
        """Dense Floyd–Warshall over the whole graph (strict-improvement
        updates) with a next-hop matrix for path replay.

        Returns (names, index, dist_ms, nxt, cap, edge_cost)."""
        if self._apsp is not None:
            return self._apsp
        names = list(dict.fromkeys(
            [u for u in self.adj]
            + [e.to for es in self.adj.values() for e in es]))
        index = {n: i for i, n in enumerate(names)}
        n = len(names)
        lat = np.full((n, n), np.inf)
        cap = np.zeros((n, n))
        edge_cost = np.zeros((n, n))
        for u, edges in self.adj.items():
            for e in edges:
                i, j = index[u], index[e.to]
                if e.latency_ms < lat[i, j]:  # keep the best parallel edge
                    lat[i, j] = e.latency_ms
                    cap[i, j] = e.capacity_gbps
                    edge_cost[i, j] = e.cost_per_gb
        dist = lat.copy()
        np.fill_diagonal(dist, 0.0)
        nxt = np.where(np.isfinite(lat), np.arange(n)[None, :], -1)
        np.fill_diagonal(nxt, np.arange(n))
        for k in range(n):
            via = dist[:, k, None] + dist[None, k, :]
            better = via < dist
            dist = np.where(better, via, dist)
            nxt = np.where(better, nxt[:, k, None], nxt)
        self._apsp = (names, index, dist, nxt, cap, edge_cost)
        return self._apsp

    def shortest_path_latency(self, src: str, dst: str) -> Tuple[float, List[str], float, float]:
        """(latency_s, path_nodes, bottleneck_gbps, sum_cost_per_gb);
        bottleneck 0.0 means unconstrained, unreachable is (inf, [], 0, inf)."""
        names, index, dist, nxt, cap, edge_cost = self._all_pairs()
        s, d = index.get(src), index.get(dst)
        if s is None or d is None or not math.isfinite(dist[s, d]):
            return math.inf, [], 0.0, math.inf
        path, bottleneck, cost_sum = [src], math.inf, 0.0
        i = s
        while i != d:
            j = int(nxt[i, d])
            bottleneck = min(bottleneck, cap[i, j])
            cost_sum += edge_cost[i, j]
            path.append(names[j])
            i = j
        return (dist[s, d] / 1000.0, path,
                0.0 if bottleneck is math.inf else bottleneck, cost_sum)


def precompute_net_matrices(
    graph: Graph,
    ingress_names: List[str],
    dc_names: List[str],
    payload_gb: Tuple[float, float] = (0.05, 5.0),
):
    """All-pairs (ingress -> DC) network constants as numpy arrays:
    ``net_lat_s`` [n_ing, n_dc], ``transfer_s`` [n_ing, n_dc, 2],
    ``bottleneck_gbps`` and ``cost_per_gb`` [n_ing, n_dc]."""
    n_ing, n_dc = len(ingress_names), len(dc_names)
    net_lat = np.full((n_ing, n_dc), np.inf, dtype=np.float64)
    bneck = np.zeros((n_ing, n_dc), dtype=np.float64)
    cost = np.full((n_ing, n_dc), np.inf, dtype=np.float64)
    xfer = np.full((n_ing, n_dc, 2), np.inf, dtype=np.float64)
    for i, ing in enumerate(ingress_names):
        for d, dc in enumerate(dc_names):
            lat_s, path, bn, c = graph.shortest_path_latency(ing, dc)
            net_lat[i, d] = lat_s
            bneck[i, d] = bn
            cost[i, d] = c
            if math.isinf(lat_s):
                continue
            for j, gb in enumerate(payload_gb):
                extra = gb / bn if bn > 0.0 else 0.0
                xfer[i, d, j] = lat_s + extra
    return {
        "net_lat_s": net_lat,
        "transfer_s": xfer,
        "bottleneck_gbps": bneck,
        "cost_per_gb": cost,
    }


@dataclass(frozen=True)
class RouterPolicy:
    """DC-scoring weight vector for ingress routing (``--router-weights``):
    ``sim.algos.route_weighted`` sends an arrival to the DC of least
    :meth:`score`."""

    w_latency: float = 1.0
    w_energy: float = 0.0
    w_carbon: float = 0.0
    w_cost: float = 0.0
    w_queue: float = 0.0

    def score(self, latency_s, energy_j, carbon_g, cost_usd, queue_len):
        """Lower is better; per-DC tensors.  The five weighted terms are
        summed left to right, as the JAX package's expression is."""
        return (self.w_latency * latency_s + self.w_energy * energy_j
                + self.w_carbon * carbon_g + self.w_cost * cost_usd
                + self.w_queue * queue_len)
