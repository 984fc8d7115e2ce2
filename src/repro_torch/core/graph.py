"""Graph representation for the SCAN engine (port of ``repro.core.graph``).

CSR over torch tensors, kept in the reference's storage types so content
fingerprints match across the two packages:

  * ``offsets``  int32[n+1]  — row starts into the half-edge arrays.
  * ``nbrs``     int32[m2]   — neighbor vertex ids, each row sorted ascending.
  * ``wgts``     float32[m2] — edge weights (1.0 for unweighted graphs).
  * ``edge_u``   int32[m2]   — source vertex of each half-edge.

Ids widen to int64 only where they index. The generators are the
reference's numpy code verbatim, so one seed gives a byte-identical CSR in
both packages; deduplication and CSR ordering run in torch on the target
device (the same total orders as the reference's ``np.unique`` /
``np.lexsort``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without CUDA raises: the
    port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class CSRGraph:
    """Symmetric CSR graph; ``n``/``m2`` are python ints."""

    offsets: torch.Tensor  # int32[n+1]
    nbrs: torch.Tensor     # int32[m2], row-sorted ascending
    wgts: torch.Tensor     # float32[m2]
    edge_u: torch.Tensor   # int32[m2]
    n: int
    m2: int

    @property
    def m(self) -> int:
        return self.m2 // 2

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def degrees(self) -> torch.Tensor:
        """Open-neighborhood degrees |N(v)|, int32[n]."""
        return torch.diff(self.offsets)

    def closed_degrees(self) -> torch.Tensor:
        """Closed-neighborhood sizes |N̄(v)| = deg(v) + 1."""
        return self.degrees() + 1


def _csr_from_pairs(n: int, a: torch.Tensor, b: torch.Tensor,
                    w: torch.Tensor) -> CSRGraph:
    """Dedup (first weight wins), drop self-loops, symmetrize, CSR-order."""
    keep = a != b
    a, b, w = a[keep], b[keep], w[keep]
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    # np.unique(key, return_index=True): first occurrence of each key, in
    # key order — a stable sort keeps the lowest original index first
    skey, perm = torch.sort(lo * n + hi, stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    pick = perm[first]
    lo, hi, w = lo[pick], hi[pick], w[pick]
    u = torch.cat([lo, hi])
    v = torch.cat([hi, lo])
    ww = torch.cat([w, w])
    # (u, v) pairs are unique, so any sort by the packed key is np.lexsort
    order = torch.argsort(u * n + v)
    u, v, ww = u[order], v[order], ww[order]
    counts = torch.bincount(u, minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=u.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return CSRGraph(offsets=offsets.to(torch.int32),
                    nbrs=v.to(torch.int32).contiguous(),
                    wgts=ww.to(torch.float32).contiguous(),
                    edge_u=u.to(torch.int32).contiguous(),
                    n=int(n), m2=int(u.shape[0]))


def from_edge_list(
    n: int,
    edges: Sequence[Tuple[int, int]] | np.ndarray,
    weights: Optional[Sequence[float] | np.ndarray] = None,
    *,
    device=None,
) -> CSRGraph:
    """Build a CSRGraph from an undirected edge list.

    Deduplicates edges (keeping the first weight), drops self-loops,
    symmetrizes.
    """
    device = resolve_device(device)
    if n > 2 ** 31:
        raise ValueError(
            f"n={n} exceeds 2**31: vertex ids must fit in 31 bits")
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if weights is None:
        weights = np.ones(len(edges), dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)
    if len(weights) != len(edges):
        raise ValueError("weights length must match edges length")
    e = torch.as_tensor(edges, device=device)
    w = torch.as_tensor(weights, device=device)
    return _csr_from_pairs(int(n), e[:, 0], e[:, 1], w)


def to_dense(g: CSRGraph, closed: bool = False,
             weighted: bool = True) -> torch.Tensor:
    """Dense adjacency float32[n, n]. ``closed`` adds the identity (w=1)."""
    a = torch.zeros((g.n, g.n), dtype=torch.float32, device=g.device)
    vals = g.wgts if weighted else torch.ones_like(g.wgts)
    a[g.edge_u.long(), g.nbrs.long()] = vals
    if closed:
        a = a + torch.eye(g.n, dtype=torch.float32, device=g.device)
    return a


def random_graph(
    n: int,
    avg_degree: float,
    *,
    seed: int = 0,
    weighted: bool = False,
    planted_clusters: int = 0,
    p_in_over_p_out: float = 8.0,
    device=None,
) -> CSRGraph:
    """Synthetic test graphs (numpy sampling, as in the reference).

    ``planted_clusters > 0`` draws a planted-partition graph; otherwise
    G(n, p). The sampler keeps ``n·avg_degree`` undirected edge draws, so
    the resulting average degree is about ``2·avg_degree``.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    target_m = int(n * avg_degree / 2)
    if planted_clusters > 1:
        labels = rng.integers(0, planted_clusters, size=n)
        frac_in = p_in_over_p_out / (p_in_over_p_out + 1.0)
        m_in = int(target_m * frac_in)
        m_out = target_m - m_in
        edges = []
        for _ in range(4):  # oversample, dedup later
            u = rng.integers(0, n, size=2 * m_in)
            shift = rng.integers(1, max(2, n // planted_clusters), size=2 * m_in)
            order = np.argsort(labels, kind="stable")
            pos = np.searchsorted(labels[order], labels[u])
            cnt = np.bincount(labels, minlength=planted_clusters)
            v = order[(pos + shift % np.maximum(cnt[labels[u]], 1))]
            ok = labels[v] == labels[u]
            edges.append(np.stack([u[ok], v[ok]], axis=1))
        e_in = np.concatenate(edges)[: 2 * m_in]
        u = rng.integers(0, n, size=2 * m_out)
        v = rng.integers(0, n, size=2 * m_out)
        e_out = np.stack([u, v], axis=1)
        e = np.concatenate([e_in, e_out])
    else:
        u = rng.integers(0, n, size=3 * target_m)
        v = rng.integers(0, n, size=3 * target_m)
        e = np.stack([u, v], axis=1)
    e = e[e[:, 0] != e[:, 1]][: 2 * target_m]
    w = rng.uniform(0.1, 1.0, size=len(e)).astype(np.float32) if weighted else None
    return from_edge_list(n, e, w, device=device)


def power_law_graph(
    n: int,
    alpha: float = 2.1,
    *,
    avg_degree: float = 8.0,
    seed: int = 0,
    weighted: bool = False,
    hub_degree: int = 0,
    device=None,
) -> CSRGraph:
    """Chung–Lu-style power-law graph (numpy sampling, as in the
    reference). ``hub_degree > 0`` additionally wires vertex 0 to that
    many distinct random vertices."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-1.0 / (alpha - 1.0))
    p = w / w.sum()
    target_m = int(n * avg_degree / 2)
    u = rng.choice(n, size=3 * target_m, p=p)
    v = rng.choice(n, size=3 * target_m, p=p)
    e = np.stack([u, v], axis=1)
    e = e[e[:, 0] != e[:, 1]][: 2 * target_m]
    if hub_degree > 0:
        others = rng.permutation(np.arange(1, n))[: min(hub_degree, n - 1)]
        hub_e = np.stack([np.zeros(len(others), np.int64), others], axis=1)
        e = np.concatenate([e, hub_e])
    wgt = (rng.uniform(0.1, 1.0, size=len(e)).astype(np.float32)
           if weighted else None)
    return from_edge_list(n, e, wgt, device=device)


def hub_ring_graph(
    n: int,
    hub_degree: int,
    *,
    seed: int = 0,
    weighted: bool = False,
    device=None,
) -> CSRGraph:
    """Star-with-ring: vertex 0 is a hub wired to ``hub_degree`` spokes,
    all other vertices form a ring."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    ring = np.stack([np.arange(1, n), np.concatenate(
        [np.arange(2, n), [1]])], axis=1)
    spokes = rng.permutation(np.arange(1, n))[: min(hub_degree, n - 1)]
    star = np.stack([np.zeros(len(spokes), np.int64), spokes], axis=1)
    e = np.concatenate([ring, star])
    w = (rng.uniform(0.1, 1.0, size=len(e)).astype(np.float32)
         if weighted else None)
    return from_edge_list(n, e, w, device=device)


def graph_from_dense(a: np.ndarray, weighted: bool = True, *,
                     device=None) -> CSRGraph:
    """Build from a dense symmetric adjacency (testing convenience)."""
    a = np.asarray(a)
    n = a.shape[0]
    iu, iv = np.nonzero(np.triu(a, k=1))
    w = a[iu, iv].astype(np.float32) if weighted else None
    return from_edge_list(n, np.stack([iu, iv], axis=1), w, device=device)
