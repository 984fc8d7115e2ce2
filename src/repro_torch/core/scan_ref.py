"""Sequential reference SCAN — the correctness oracle (port of
``repro.core.scan_ref``, reading the port's :class:`CSRGraph`).

A direct numpy/python transcription of the SCAN definitions (paper §3.1):
per-edge similarity by explicit set intersection, core determination, BFS
structural-reachability clustering, deterministic border attachment
(most-similar core, ties to lower id), hub/outlier classification.
O(m·Δ) time — test scale only.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.graph import CSRGraph


def _arrays(g: CSRGraph):
    return (g.offsets.cpu().numpy(), g.nbrs.cpu().numpy(),
            g.wgts.cpu().numpy(), g.edge_u.cpu().numpy())


def _neigh(off, nbrs, v):
    return nbrs[off[v]: off[v + 1]]


def similarities_ref(g: CSRGraph, measure: str = "cosine") -> np.ndarray:
    """σ per half-edge (graph order), via explicit closed-set intersection."""
    off, nbrs, wgts, eu = _arrays(g)
    n = g.n

    wmap: Dict[Tuple[int, int], float] = {}
    for i in range(g.m2):
        wmap[(int(eu[i]), int(nbrs[i]))] = float(wgts[i])

    def wfun(a, b):  # weight of N̄(a) at element b; w(a,a)=1
        return 1.0 if a == b else wmap[(a, b)]

    norms = np.zeros(n)
    for v in range(n):
        s = 1.0 + sum(wmap[(v, int(x))] ** 2 for x in _neigh(off, nbrs, v))
        norms[v] = np.sqrt(s)

    sims = np.zeros(g.m2, dtype=np.float64)
    for i in range(g.m2):
        u, v = int(eu[i]), int(nbrs[i])
        nu = set(map(int, _neigh(off, nbrs, u))) | {u}
        nv = set(map(int, _neigh(off, nbrs, v))) | {v}
        shared = nu & nv
        if measure == "cosine":
            dot = sum(wfun(u, x) * wfun(v, x) for x in shared)
            sims[i] = dot / (norms[u] * norms[v])
        elif measure == "jaccard":
            sims[i] = len(shared) / len(nu | nv)
        else:
            raise ValueError(measure)
    return sims.astype(np.float32)


def scan_ref(
    g: CSRGraph,
    mu: int,
    eps: float,
    measure: str = "cosine",
    sims: np.ndarray | None = None,
):
    """Full SCAN clustering. Returns dict with labels / is_core / is_hub /
    is_outlier (labels = min core id of the cluster, -1 unclustered)."""
    off, nbrs, _, eu = _arrays(g)
    n = g.n
    if sims is None:
        sims = similarities_ref(g, measure)
    sims = np.asarray(sims)

    eps = np.float32(eps)  # match the parallel path's f32 threshold exactly
    smap: Dict[Tuple[int, int], float] = {}
    for i in range(g.m2):
        smap[(int(eu[i]), int(nbrs[i]))] = np.float32(sims[i])

    # ε-neighborhood sizes over closed neighborhoods (self always counts)
    is_core = np.zeros(n, dtype=bool)
    for v in range(n):
        cnt = 1  # σ(v,v) = 1 ≥ ε
        for x in _neigh(off, nbrs, v):
            if smap[(v, int(x))] >= eps:
                cnt += 1
        is_core[v] = cnt >= mu

    # BFS over cores through ε-similar core-core edges
    labels = np.full(n, -1, dtype=np.int64)
    comp = {}
    for s in range(n):
        if not is_core[s] or s in comp:
            continue
        group = [s]
        comp[s] = s
        q = deque([s])
        while q:
            u = q.popleft()
            for x in _neigh(off, nbrs, u):
                x = int(x)
                if is_core[x] and x not in comp and smap[(u, x)] >= eps:
                    comp[x] = s
                    group.append(x)
                    q.append(x)
        rep = min(group)
        for u in group:
            labels[u] = rep

    # border vertices: non-core, ε-similar to a core → most similar core,
    # ties to lower core id
    for v in range(n):
        if is_core[v]:
            continue
        best = None
        for x in _neigh(off, nbrs, v):
            x = int(x)
            if is_core[x] and smap[(v, x)] >= eps:
                cand = (-smap[(v, x)], x)
                if best is None or cand < best:
                    best = cand
        if best is not None:
            labels[v] = labels[best[1]]

    # hubs / outliers among unclustered
    is_hub = np.zeros(n, dtype=bool)
    is_outlier = np.zeros(n, dtype=bool)
    for v in range(n):
        if labels[v] >= 0:
            continue
        neigh_clusters = {int(labels[int(x)]) for x in _neigh(off, nbrs, v)}
        neigh_clusters.discard(-1)
        if len(neigh_clusters) >= 2:
            is_hub[v] = True
        else:
            is_outlier[v] = True

    return dict(
        labels=labels,
        is_core=is_core,
        is_hub=is_hub,
        is_outlier=is_outlier,
        sims=sims,
    )
