"""Clustering quality measures (port of ``repro.core.quality``).

Unclustered vertices (label < 0) are treated as singleton clusters,
matching the paper's §7.3.4 convention. ``modularity`` does its O(m)
counting in torch on the graph's device and finishes with the
reference's numpy expression over the per-cluster sums, so unweighted
results are bit-identical to the reference; the rest is numpy, as in the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph


def _canonical_labels(labels: np.ndarray) -> np.ndarray:
    """Map labels to [0, C); each unclustered vertex becomes its own cluster."""
    labels = np.asarray(labels).copy()
    n = len(labels)
    un = labels < 0
    labels[un] = n + np.arange(np.sum(un))
    _, out = np.unique(labels, return_inverse=True)
    return out


def _canonical_labels_t(labels: torch.Tensor) -> torch.Tensor:
    """:func:`_canonical_labels` in torch (same sorted cluster order)."""
    labels = labels.long().clone()
    n = labels.shape[0]
    un = labels < 0
    labels[un] = n + torch.arange(int(un.sum()), device=labels.device)
    return torch.unique(labels, sorted=True, return_inverse=True)[1]


def modularity(g: CSRGraph, labels, weighted: bool = False) -> float:
    """Newman modularity Q = Σ_c (e_c/m - (d_c/2m)²) (weighted form optional).

    Per-cluster sums are accumulated in float64: unweighted they are
    integer counts, exact in any order. Weighted sums on CUDA use atomics,
    so their last bits may vary from run to run."""
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.array(labels))
    lab = labels.to(g.device)
    if weighted:
        w32 = g.wgts
        two_m = float(g.wgts.cpu().numpy().sum())   # the reference's sum
    else:
        w32 = torch.ones(g.m2, dtype=torch.float64, device=g.device)
        two_m = float(g.m2)
    if two_m == 0:
        return 0.0
    canon = _canonical_labels_t(lab)
    c = int(canon.max()) + 1
    cu = canon[g.edge_u.long()]
    cv = canon[g.nbrs.long()]
    same = torch.where(cu == cv, w32, torch.zeros_like(w32)).double()
    within = torch.zeros(c, dtype=torch.float64, device=g.device)
    within.index_add_(0, cu, same)
    deg = torch.zeros(c, dtype=torch.float64, device=g.device)
    deg.index_add_(0, cu, w32.double())
    within, deg = within.cpu().numpy(), deg.cpu().numpy()
    return float(np.sum(within / two_m - (deg / two_m) ** 2))


def core_precision_recall(approx_cores: np.ndarray,
                          exact_cores: np.ndarray) -> tuple:
    """(precision, recall) of an approximate core set against the exact one.
    Empty sets: precision is 1.0 when nothing was predicted, recall is 1.0
    when nothing was there to find."""
    approx = np.asarray(approx_cores, dtype=bool)
    exact = np.asarray(exact_cores, dtype=bool)
    if approx.shape != exact.shape:
        raise ValueError(f"shapes differ: {approx.shape} vs {exact.shape}")
    tp = float(np.sum(approx & exact))
    n_approx = float(approx.sum())
    n_exact = float(exact.sum())
    precision = tp / n_approx if n_approx else 1.0
    recall = tp / n_exact if n_exact else 1.0
    return precision, recall


def adjusted_rand_index(labels_a: np.ndarray, labels_b: np.ndarray) -> float:
    """ARI between two clusterings (paper §7.2 formula)."""
    a = _canonical_labels(labels_a)
    b = _canonical_labels(labels_b)
    n = len(a)
    if len(b) != n:
        raise ValueError(f"label lengths differ: {n} vs {len(b)}")
    # the contingency table's nonzero cells only: unclustered vertices are
    # singleton clusters, so a dense [ca, cb] table is O(n²) at scale.
    # comb2 of each count is an integer (exact in float64), so the sums
    # equal the reference's dense ones.
    cb = int(b.max()) + 1
    cells = np.unique(a.astype(np.int64) * cb + b, return_counts=True)[1]

    def comb2(x):
        x = np.asarray(x, dtype=np.float64)
        return x * (x - 1) / 2.0

    sum_ij = comb2(cells).sum()
    sum_a = comb2(np.bincount(a)).sum()
    sum_b = comb2(np.bincount(b)).sum()
    total = comb2(np.array([n]))[0]
    if total == 0:
        return 1.0
    expected = sum_a * sum_b / total
    max_index = (sum_a + sum_b) / 2.0
    if max_index == expected:
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))
