"""Cluster queries against the SCAN index (port of ``repro.core.query``).

Given (μ, ε):
  1. cores         — prefix of CO[μ] with θ ≥ ε              (Algorithm 3)
  2. similar edges — ε-similar half-edges between cores       (Alg. 5)
  3. clusters      — connectivity over core–core ε-similar edges
  4. borders       — non-core neighbors attach to the most similar
                     ε-similar core, ties to the lower core id (Algorithm 4)

A batch of settings runs as one connectivity problem over disjoint copies
of the vertex set (setting b owns ids [b·n, (b+1)·n)), which is the
reference's ``vmap`` written out: settings are independent and min-label
propagation is monotone, so a copy that converged early is a fixed point
and extra rounds change nothing. Only the active half-edges of each
setting enter the batch, and settings are grouped so that a group's
edge slots stay within ``QUERY_GROUP_BYTES``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.connectivity import connected_components
from repro_torch.core.graph import CSRGraph
from repro_torch.core.index import ScanIndex, get_cores

# device bytes one group of settings may spend on per-edge temporaries
QUERY_GROUP_BYTES = 8 << 30
# bytes per half-edge slot of one setting (masks, compacted int64 ends,
# gathered labels) and per vertex slot (labels, masks, border scratch)
_EDGE_SLOT_BYTES = 40
_VERTEX_SLOT_BYTES = 48


@dataclasses.dataclass(frozen=True, eq=False)
class ClusterResult:
    labels: torch.Tensor      # int32[n]; component id (min core id) or -1
    is_core: torch.Tensor     # bool[n]
    n_clusters: torch.Tensor  # int32 scalar


def _query_group(index: ScanIndex, g: CSRGraph, mus, epss):
    """(labels int32[G, n], is_core bool[G, n], n_clusters int32[G])."""
    n = index.n
    dev = index.edge_sims.device
    eu, ev, esim = g.edge_u.long(), g.nbrs.long(), index.edge_sims
    is_core = torch.stack([get_cores(index, mu, eps)
                           for mu, eps in zip(mus, epss)])
    cc_u, cc_v, b_u, b_v, b_s = [], [], [], [], []
    for b, eps in enumerate(epss):
        sim_ok = esim >= torch.tensor(eps, dtype=torch.float32, device=dev)
        core_u = is_core[b][eu]
        core_v = is_core[b][ev]
        sel = torch.nonzero(sim_ok & core_u & core_v).flatten()
        cc_u.append(eu[sel] + b * n)
        cc_v.append(ev[sel] + b * n)
        # candidate border half-edges: u core, v non-core, σ ≥ ε
        sel = torch.nonzero(sim_ok & core_u & ~core_v).flatten()
        b_u.append(eu[sel])
        b_v.append(ev[sel] + b * n)
        b_s.append(esim[sel])
    big_n = len(mus) * n
    flat_core = is_core.reshape(-1)
    labels0 = connected_components(big_n, torch.cat(cc_u), torch.cat(cc_v),
                                   vertex_mask=flat_core)
    base = (torch.arange(len(mus), dtype=torch.int64, device=dev) * n)[:, None]
    labels0 = labels0.view(len(mus), n) - base
    labels = torch.where(is_core, labels0, torch.full_like(labels0, -1))

    b_u, b_v, b_s = torch.cat(b_u), torch.cat(b_v), torch.cat(b_s)
    best_sim = torch.full((big_n,), -1.0, dtype=torch.float32, device=dev)
    best_sim = best_sim.scatter_reduce(0, b_v, b_s, "amax", include_self=True)
    at_best = best_sim[b_v]
    tie = (b_s >= at_best) & (at_best > -1.0)
    best_core = torch.full((big_n,), n, dtype=torch.int64, device=dev)
    best_core = best_core.scatter_reduce(0, b_v[tie], b_u[tie], "amin",
                                         include_self=True).view(len(mus), n)
    has_border = best_core < n
    border_label = torch.gather(labels0, 1, torch.clamp(best_core, 0, n - 1))
    labels = torch.where(~is_core & has_border, border_label, labels)

    own = torch.arange(n, dtype=torch.int64, device=dev)
    n_clusters = (is_core & (labels == own)).sum(dim=1)
    return labels.to(torch.int32), is_core, n_clusters.to(torch.int32)


def query(index: ScanIndex, g: CSRGraph, mu, eps) -> ClusterResult:
    """SCAN clustering for parameters (μ, ε) from the index."""
    labels, is_core, n_clusters = _query_group(index, g, [int(mu)],
                                               [float(eps)])
    return ClusterResult(labels=labels[0], is_core=is_core[0],
                         n_clusters=n_clusters[0])


def query_batch(index: ScanIndex, g: CSRGraph,
                mus: Sequence[int], epss: Sequence[float]) -> ClusterResult:
    """Answer a batch of (μ, ε) settings: labels int32[B, n], is_core
    bool[B, n], n_clusters int32[B]. Settings run in groups bounded by
    ``QUERY_GROUP_BYTES``; results do not depend on the grouping."""
    mus = np.atleast_1d(np.asarray(mus, np.int32)).tolist()
    epss = np.atleast_1d(np.asarray(epss, np.float32)).tolist()
    if len(mus) != len(epss):
        raise ValueError(f"{len(mus)} mus vs {len(epss)} epss")
    per = _EDGE_SLOT_BYTES * g.m2 + _VERTEX_SLOT_BYTES * g.n
    size = max(1, QUERY_GROUP_BYTES // max(per, 1))
    parts = [_query_group(index, g, mus[s: s + size], epss[s: s + size])
             for s in range(0, len(mus), size)]
    return ClusterResult(labels=torch.cat([p[0] for p in parts]),
                         is_core=torch.cat([p[1] for p in parts]),
                         n_clusters=torch.cat([p[2] for p in parts]))


def hubs_outliers(g: CSRGraph, labels: torch.Tensor):
    """Classify unclustered vertices (paper §4.3).

    hub     — neighbors in ≥ 2 distinct clusters
    outlier — unclustered, neighbors in ≤ 1 cluster
    Returns (is_hub bool[n], is_outlier bool[n]).
    """
    n = labels.shape[0]
    eu = g.edge_u.long()
    nbr_label = labels[g.nbrs.long()]
    valid = nbr_label >= 0
    lo = torch.full((n,), n, dtype=labels.dtype, device=labels.device)
    lo = lo.scatter_reduce(0, eu, torch.where(valid, nbr_label,
                                              torch.full_like(nbr_label, n)),
                           "amin", include_self=True)
    hi = torch.full((n,), -1, dtype=labels.dtype, device=labels.device)
    hi = hi.scatter_reduce(0, eu, torch.where(valid, nbr_label,
                                              torch.full_like(nbr_label, -1)),
                           "amax", include_self=True)
    unclustered = labels < 0
    is_hub = unclustered & (hi > lo) & (hi >= 0)
    return is_hub, unclustered & ~is_hub
