"""Public wrappers around the kernels, dispatched per call (port of the
``masked_gram`` / ``bucket_probe`` / ``simhash`` / ``hamming`` part of
``repro.kernels.ops``; ``attention`` comes with the LM slice).

Each resolves its lane through the :class:`ExecutionPolicy` from the
operands' device (``ref`` = the plain PyTorch version, ``hopper`` = the
CUDA kernel; an explicit ``lane=`` wins) and counts the decision.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.backend.policy import LANE_REF, default_policy
from repro_torch.core.graph import CSRGraph, to_dense
from repro_torch.kernels.bucket_probe import bucket_probe, bucket_probe_plain
from repro_torch.kernels.hamming import hamming_cosine, hamming_cosine_plain
from repro_torch.kernels.simhash import simhash_pack, simhash_pack_plain
from repro_torch.kernels.triangle_count import masked_gram, masked_gram_plain


def _resolve(op: str, device, lane: Optional[str]) -> str:
    pol = default_policy()
    lane = pol.lane(op, device, forced=lane)
    pol.note(op, lane)
    return lane


def edge_similarities_gram(
    g: CSRGraph, measure: str = "cosine",
    *, lane: Optional[str] = None,
) -> torch.Tensor:
    """Exact σ per half-edge via the masked-gram product (triangle_count
    op): the dense σ oracle, for graphs whose adjacency fits in memory."""
    lane = _resolve("triangle_count", g.device, lane)
    weighted = measure == "cosine"
    w = to_dense(g, closed=True, weighted=weighted)
    mask = (to_dense(g, closed=True, weighted=False) > 0).to(torch.float32)
    gram = masked_gram_plain if lane == LANE_REF else masked_gram
    prod = gram(w, mask)
    eu, ev = g.edge_u.long(), g.nbrs.long()
    dots = prod[eu, ev]
    if measure == "cosine":
        norms = torch.sqrt(torch.diagonal(prod))
        return dots / (norms[eu] * norms[ev])
    cdeg = g.closed_degrees().to(torch.float32)
    union = cdeg[eu] + cdeg[ev] - dots
    return dots / union


def bucket_probe_stats(
    rows_p: torch.Tensor,   # int32[e, P] sorted probe rows (pad id = n)
    w_p: torch.Tensor,      # float32[e, P]
    rows_t: torch.Tensor,   # int32[e, T] sorted target rows (pad id = n)
    w_t: torch.Tensor,      # float32[e, T]
    n: int,                 # vertex count (ids ≥ n are padding)
    *,
    lane: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(shared weighted dot, shared count) per edge via the bucket_probe
    op. Rows follow the kernel's contract: sorted, pads (id ``n``) last."""
    lane = _resolve("bucket_probe", rows_p.device, lane)
    probe = bucket_probe_plain if lane == LANE_REF else bucket_probe
    return probe(rows_p, w_p, rows_t, w_t, n)


def simhash_sketches_kernel(
    g: CSRGraph, samples: int, seed: int = 0,
    *, lane: Optional[str] = None,
) -> torch.Tensor:
    """Packed SimHash sketches uint32[n, ceil(k/32)] via the simhash op:
    the dense form, sign(W̄·R) over the closed weighted adjacency, for
    graphs whose adjacency fits in memory. R is the sparse path's
    projections (:func:`repro_torch.core.lsh.projections`), with the
    samples padded to a multiple of 128 and the padding columns zeroed, so
    both endpoints agree on padded bits."""
    from repro_torch.core import lsh      # lsh imports this module

    lane = _resolve("simhash", g.device, lane)
    w = to_dense(g, closed=True, weighted=True)
    k_pad = max((samples + 127) // 128 * 128, 128)
    r = lsh.projections(seed, 0, k_pad // 32, g.n, g.device)
    r[:, samples:] = 0.0
    pack = simhash_pack_plain if lane == LANE_REF else simhash_pack
    return pack(w, r)[:, : (samples + 31) // 32]


def simhash_edge_similarity_kernel(
    sketches: torch.Tensor, eu: torch.Tensor, ev: torch.Tensor,
    samples: int, *, lane: Optional[str] = None,
) -> torch.Tensor:
    """σ̂ per edge from packed sketches via the hamming op."""
    lane = _resolve("hamming", sketches.device, lane)
    eu = eu.to(device=sketches.device, dtype=torch.int32).contiguous()
    ev = ev.to(device=sketches.device, dtype=torch.int32).contiguous()
    compare = hamming_cosine_plain if lane == LANE_REF else hamming_cosine
    return compare(sketches, eu, ev, samples)
