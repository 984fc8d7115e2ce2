"""SCAN index construction (port of ``repro.core.index``).

The GS*-Index pair as flat segmented tensors:

* neighbor order NO — the closed adjacency (each row = v plus its
  neighbors, σ(v,v)=1) sorted within each row by (−σ, ¬self, nbr);
* core order CO — every NO slot at row position μ ≥ 2, sorted by
  (μ, −θ, v), with ``co_offsets`` giving each μ's segment.

Both are the reference's total orders, reached with one stable sort each
on a packed int64 key. For σ ∈ [0, 1] the float32 bit pattern is monotone
in σ, so ``0x3F800000 − bits(σ)`` orders σ descending. NO: the self slot
always leads its row (σ=1 and ¬self=0), and the CSR edge slots are already
(row, nbr)-ordered, so a stable sort of the edges on (row, −σ) gives the
rest. CO: NO order is already v-ascending, so a stable sort of the edge
slots on (μ, −θ) gives (μ, −θ, v).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lsh as lsh_mod
from repro_torch.core import similarity as sim_mod
from repro_torch.core.graph import CSRGraph

_ONE_BITS = 0x3F800000          # float32 bits of 1.0
_LOW_BITS = 30                  # _ONE_BITS < 2**30


@dataclasses.dataclass(frozen=True, eq=False)
class ScanIndex:
    """GS*-Index analogue; tensors on the graph's device."""

    offsets_c: torch.Tensor    # int32[n+1]  row starts (offsets[v] + v)
    no_nbrs: torch.Tensor      # int32[m2c]
    no_sims: torch.Tensor      # float32[m2c]
    no_self: torch.Tensor      # bool[m2c]   marks the self slot
    co_offsets: torch.Tensor   # int32[max_cdeg+2]  segment start per μ
    co_vertex: torch.Tensor    # int32[m2]
    co_theta: torch.Tensor     # float32[m2]
    cdeg: torch.Tensor         # int32[n] closed degrees
    edge_sims: torch.Tensor    # float32[m2] σ per half-edge (graph order)
    n: int
    m2c: int
    max_cdeg: int

    def core_threshold(self, mu: int) -> torch.Tensor:
        """θ(v, μ) for all v, float32[n]; -inf where |N̄(v)| < μ."""
        slot = self.offsets_c[:-1].long() + (int(mu) - 1)
        valid = self.cdeg >= mu
        theta = self.no_sims[torch.clamp(slot, 0, max(self.m2c - 1, 0))]
        return torch.where(valid, theta,
                           torch.full_like(theta, float("-inf")))


def _desc_bits(sims: torch.Tensor) -> torch.Tensor:
    """int64 key component that sorts σ ∈ [0, 1] descending."""
    bits = (sims + 0.0).view(torch.int32).long()      # + 0.0 folds -0.0
    return _ONE_BITS - bits


def _build_orders(offsets, edge_u, nbrs, sims, n: int):
    """NO and CO from one stable sort each (see the module docstring)."""
    dev = sims.device
    m2 = sims.shape[0]
    rows = edge_u.long()
    perm = torch.sort((rows << _LOW_BITS) | _desc_bits(sims),
                      stable=True).indices
    rows_s = rows[perm]
    sims_s = sims[perm]

    offsets_c = offsets + torch.arange(n + 1, dtype=offsets.dtype,
                                       device=dev)
    m2c = m2 + n
    self_pos = offsets_c[:-1].long()
    edge_pos = torch.arange(m2, dtype=torch.int64, device=dev) + rows_s + 1
    no_nbrs = torch.empty(m2c, dtype=torch.int32, device=dev)
    no_sims = torch.empty(m2c, dtype=torch.float32, device=dev)
    no_self = torch.zeros(m2c, dtype=torch.bool, device=dev)
    no_nbrs[self_pos] = torch.arange(n, dtype=torch.int32, device=dev)
    no_sims[self_pos] = 1.0
    no_self[self_pos] = True
    no_nbrs[edge_pos] = nbrs[perm]
    no_sims[edge_pos] = sims_s
    cdeg = torch.diff(offsets) + 1

    # core order: edge slot at closed position j of row v has μ = j - start + 1
    mu = edge_pos - self_pos[rows_s] + 1
    perm2 = torch.sort((mu << _LOW_BITS) | _desc_bits(sims_s),
                       stable=True).indices
    co_vertex = rows_s[perm2].to(torch.int32)
    co_theta = sims_s[perm2]
    co_mu = mu[perm2]
    return (offsets_c, no_nbrs, no_sims, no_self, cdeg, co_vertex, co_theta,
            co_mu)


def build_index(
    g: CSRGraph,
    measure: str = "cosine",
    *,
    approx: Optional[str] = None,   # None | "simhash" | "minhash" | "kpartition"
    samples: int = 64,
    seed: int = 0,
    degree_heuristic: bool = True,
    sims=None,   # precomputed σ override (testing)
) -> ScanIndex:
    """Construct the SCAN index (exact or LSH-approximate similarities) on
    the graph's device."""
    if sims is None:
        if approx is None:
            sims = sim_mod.compute_similarities(g, measure)
        else:
            sims = lsh_mod.approximate_similarities(
                g, measure=measure, method=approx, samples=samples,
                seed=seed, degree_heuristic=degree_heuristic)
    if not isinstance(sims, torch.Tensor):
        sims = torch.from_numpy(np.array(sims, dtype=np.float32))
    sims = torch.clamp(sims.to(device=g.device, dtype=torch.float32),
                       0.0, 1.0)

    (offsets_c, no_nbrs, no_sims, no_self, cdeg, co_vertex, co_theta,
     co_mu) = _build_orders(g.offsets, g.edge_u, g.nbrs, sims, g.n)
    max_cdeg = int(cdeg.max()) if g.n else 1
    counts = torch.bincount(co_mu, minlength=max_cdeg + 1)
    co_offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                             device=g.device)
    co_offsets[1:] = torch.cumsum(counts, 0)
    return ScanIndex(
        offsets_c=offsets_c, no_nbrs=no_nbrs, no_sims=no_sims,
        no_self=no_self, co_offsets=co_offsets.to(torch.int32),
        co_vertex=co_vertex, co_theta=co_theta, cdeg=cdeg, edge_sims=sims,
        n=g.n, m2c=g.m2 + g.n, max_cdeg=max_cdeg)


def co_core_prefix(index: ScanIndex, mu: int, eps: float) -> Tuple[int, int]:
    """(lo, end): the CO[μ] slot range [lo, end) holding every core for
    (μ, ε). CO[μ] is θ-descending, so ``end`` is a searchsorted over the
    −θ segment: the count of slots with −θ ≤ −ε, i.e. θ ≥ ε (ties at
    θ = ε included), as the reference's bisection finds it."""
    mu = int(mu)
    top = index.max_cdeg
    lo = int(index.co_offsets[min(max(mu, 0), top)])
    hi = int(index.co_offsets[min(max(mu + 1, 0), top + 1)])
    if index.co_theta.numel() == 0 or hi <= lo:
        return lo, lo
    eps_t = torch.tensor([eps], dtype=torch.float32,
                         device=index.co_theta.device)
    found = torch.searchsorted(-index.co_theta[lo:hi], -eps_t, right=True)
    return lo, lo + int(found)


def get_cores(index: ScanIndex, mu: int, eps: float) -> torch.Tensor:
    """bool[n] core mask via the CO[μ] prefix (paper Algorithm 3)."""
    mask = torch.zeros(index.n, dtype=torch.bool,
                       device=index.co_vertex.device)
    if not 2 <= int(mu) <= index.max_cdeg:
        return mask
    lo, end = co_core_prefix(index, mu, eps)
    mask[index.co_vertex[lo:end].long()] = True
    return mask
