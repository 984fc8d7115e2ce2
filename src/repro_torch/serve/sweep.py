"""Batched (μ, ε) parameter sweeps over one index (port of
``repro.serve.sweep``; the sharded ``mesh=`` mode waits for the sharded
slice).

  * :func:`sweep`       — batched queries for explicit (μ, ε) pairs;
  * :func:`grid_sweep`  — the full μ × ε cartesian grid;
  * :func:`sweep_stats` — per-setting cluster count / coverage /
    modularity, the table a "which parameters should I use?" user reads.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.graph import CSRGraph
from repro_torch.core.index import ScanIndex
from repro_torch.core.quality import modularity
from repro_torch.core.query import ClusterResult, query_batch


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """One row per (μ, ε) setting; arrays are host-side numpy."""

    mus: np.ndarray         # int32[B]
    epss: np.ndarray        # float32[B]
    labels: np.ndarray      # int32[B, n]
    is_core: np.ndarray     # bool[B, n]
    n_clusters: np.ndarray  # int32[B]

    def __len__(self) -> int:
        return len(self.mus)

    def result(self, i: int) -> ClusterResult:
        """The i-th setting's answer as a plain ClusterResult."""
        return ClusterResult(labels=self.labels[i], is_core=self.is_core[i],
                             n_clusters=self.n_clusters[i])


def sweep(index: ScanIndex, g: CSRGraph,
          mus: Sequence[int], epss: Sequence[float]) -> SweepResult:
    """Batched queries for paired parameter vectors."""
    mus = np.asarray(mus, np.int32).reshape(-1)
    epss = np.asarray(epss, np.float32).reshape(-1)
    if mus.shape != epss.shape:
        raise ValueError(f"mus {mus.shape} and epss {epss.shape} must match")
    res = query_batch(index, g, mus, epss)
    return SweepResult(
        mus=mus, epss=epss,
        labels=res.labels.cpu().numpy(),
        is_core=res.is_core.cpu().numpy(),
        n_clusters=res.n_clusters.cpu().numpy(),
    )


def grid_sweep(index: ScanIndex, g: CSRGraph,
               mu_values: Sequence[int],
               eps_values: Sequence[float]) -> SweepResult:
    """Full cartesian μ × ε grid, μ-major row order."""
    mu_grid, eps_grid = np.meshgrid(
        np.asarray(mu_values, np.int32),
        np.asarray(eps_values, np.float32), indexing="ij")
    return sweep(index, g, mu_grid.reshape(-1), eps_grid.reshape(-1))


def sweep_stats(index: ScanIndex, g: CSRGraph,
                mu_values: Sequence[int],
                eps_values: Sequence[float]) -> list[dict]:
    """Per-setting summary rows: ``mu, eps, n_clusters, n_cores, coverage,
    modularity`` (coverage = fraction of vertices assigned to a cluster;
    modularity follows the §7.3.4 singleton convention)."""
    res = grid_sweep(index, g, mu_values, eps_values)
    rows = []
    for i in range(len(res)):
        labels = res.labels[i]
        rows.append({
            "mu": int(res.mus[i]),
            "eps": float(res.epss[i]),
            "n_clusters": int(res.n_clusters[i]),
            "n_cores": int(res.is_core[i].sum()),
            "coverage": float((labels >= 0).mean()) if g.n else 0.0,
            "modularity": modularity(g, labels),
        })
    return rows
