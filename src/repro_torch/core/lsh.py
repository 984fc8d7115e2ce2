"""LSH-approximate similarities (port of ``repro.core.lsh``; paper §5, §6.3).

* SimHash (cosine, weighted or unweighted): sketch(v) = sign(N̄_w(v) · R),
  R ∈ ℝ^{n×k} i.i.d. N(0,1), as ``r + Σ_{x∈N(v)} w(v,x)·r[x]`` over the CSR
  rows (a sorted segmented sum: deterministic on CUDA, where
  ``index_add_``'s atomics would change sign bits near 0 from run to run).
  Bits pack into uint32 words; per-edge comparison is the ``hamming`` op
  (:func:`repro_torch.kernels.ops.simhash_edge_similarity_kernel`), the
  ``hamming_cosine`` CUDA kernel on the card.
  Estimate: θ̂ = π·(#differing bits)/k, σ̂ = cos(θ̂) — Theorem 5.2.
* MinHash (Jaccard, unweighted): k independent random permutations πᵢ;
  sketch(v)ᵢ = min_{x∈N̄(v)} πᵢ(x). Estimate: the fraction of matching
  coordinates — Theorem 5.3.
* k-partition MinHash (one-permutation hashing, §6.3): one permutation, k
  buckets, per-bucket min over N̄(v); empty buckets densified by circular
  borrowing (rotation).

Degree heuristic (§6.3): only edges whose *both* endpoints have closed
degree above a threshold (k for cosine, 3k/2 for Jaccard) keep their
sketched σ̂; every other edge gets exact σ from the bucketed engine
(:meth:`SimilarityPlan.edge_sims`, the ``bucket_probe`` kernel on the
card), computed only on that subset.

Randomness. The reference draws from ``jax.random`` threefry, which torch
cannot reproduce, so the port draws its own: one private function per
sketch kind (:func:`_word_projections`, :func:`_permutation`,
:func:`_kpartition_permutation`), each from a ``torch.Generator`` on the
graph's device, seeded from ``(seed, word)`` or ``(seed, i)`` by a fixed
integer mix. A chunk never changes a bit. CPU and CUDA generators give
different streams, so the port's approximate sketches, σ̂ and fingerprints
are specific to the package and to the device type.

``chunk`` is a memory knob only (the sketches are invariant to it). By
default it is the most columns whose per-chunk gather over the half-edges
fits :data:`SKETCH_BUDGET_BYTES`, but never less than one quantum (one
32-sample word for SimHash): the budget is a target, not a cap. At
com-LiveJournal scale one word's ``r[nbrs]`` gather is 2m·32·4 B ≈ 8.9 GB,
twice the budget.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core import similarity as sim_mod
from repro_torch.core.graph import CSRGraph
from repro_torch.kernels import ops
from repro_torch.kernels.hamming import hamming_cosine_plain
from repro_torch.kernels.simhash import pack_bits

# working-set target of one sketch chunk (the [2m, chunk] gather dominates);
# a chunk never drops below one quantum, so a large graph may exceed it
SKETCH_BUDGET_BYTES = 1 << 32

_INT32_MAX = 2 ** 31 - 1
_MASK64 = (1 << 64) - 1
# stream tags: one generator stream family per sketch kind
_SIMHASH, _MINHASH, _KPARTITION = 1, 2, 3


# --------------------------------------------------------------------------
# the port's own draws (the parity tests replace these with the reference's)
# --------------------------------------------------------------------------
def _stream_seed(seed: int, kind: int, index: int) -> int:
    """64-bit generator seed for draw ``index`` of sketch ``kind``: a
    splitmix64 finalizer over the packed (seed, kind, index)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + kind * 0xD1B54A32D192ED03
         + int(index) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _generator(seed: int, kind: int, index: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(_stream_seed(seed, kind, index))
    return gen


def _word_projections(seed: int, word: int, n: int, device) -> torch.Tensor:
    """SimHash projections of samples 32·word … 32·word+31: f32[n, 32]."""
    gen = _generator(seed, _SIMHASH, word, device)
    return torch.randn((n, 32), generator=gen, device=device,
                       dtype=torch.float32)


def _permutation(seed: int, i: int, n: int, device) -> torch.Tensor:
    """MinHash permutation ``i`` of the vertex ids: int32[n]."""
    gen = _generator(seed, _MINHASH, i, device)
    return torch.randperm(n, generator=gen, device=device).to(torch.int32)


def _kpartition_permutation(seed: int, n: int, device) -> torch.Tensor:
    """The one k-partition permutation of the vertex ids: int32[n]."""
    gen = _generator(seed, _KPARTITION, 0, device)
    return torch.randperm(n, generator=gen, device=device).to(torch.int32)


def projections(seed: int, word0: int, words: int, n: int,
                device) -> torch.Tensor:
    """Projection columns of words ``word0 … word0+words-1``:
    f32[n, 32·words]."""
    return torch.cat([_word_projections(seed, word0 + j, n, device)
                      for j in range(words)], dim=1)


def _auto_chunk(g: CSRGraph, quantum: int) -> int:
    """Largest multiple of ``quantum`` sample columns whose [2m + 3n]
    4-byte working set fits :data:`SKETCH_BUDGET_BYTES`; one quantum when
    not even that fits, so the budget can be exceeded."""
    per_col = 4 * (g.m2 + 3 * g.n) or 1
    return max(SKETCH_BUDGET_BYTES // per_col // quantum, 1) * quantum


# --------------------------------------------------------------------------
# SimHash
# --------------------------------------------------------------------------
def simhash_sketches(g: CSRGraph, samples: int, seed: int = 0,
                     *, chunk: Optional[int] = None) -> torch.Tensor:
    """Packed sketches uint32[n, ceil(k/32)] of closed weighted
    neighborhoods. Each 32-sample word draws its projections from
    ``(seed, word)``, so the bits do not depend on ``chunk``."""
    if chunk is None:
        chunk = _auto_chunk(g, 32)
    if chunk % 32 != 0 or chunk <= 0:
        raise ValueError(f"chunk must be a positive multiple of 32: {chunk}")
    k_pad = (samples + 31) // 32 * 32
    words = [_simhash_chunk(g, seed, w0 // 32, min(chunk, k_pad - w0),
                            samples - w0)
             for w0 in range(0, k_pad, chunk)]
    return torch.cat([w.view(torch.int32) for w in words],
                     dim=1).view(torch.uint32)


def _simhash_chunk(g: CSRGraph, seed: int, word0: int, kw: int,
                   valid: int) -> torch.Tensor:
    r = projections(seed, word0, kw // 32, g.n, g.device)
    cols = torch.arange(kw, device=g.device)
    if valid < kw:   # padding samples: zero projections, bits masked below
        r[:, max(valid, 0):] = 0.0
    if g.m2:
        terms = r[g.nbrs.long()]
        terms.mul_(g.wgts[:, None])
        seg = torch.segment_reduce(terms, "sum", lengths=g.degrees().long(),
                                   axis=0)
        del terms
        s = r + seg
    else:
        s = r
    return pack_bits((s >= 0.0) & (cols < max(valid, 0)))


def simhash_edge_similarity(sketches: torch.Tensor, eu, ev,
                            samples: int) -> torch.Tensor:
    """cos(π·hamming/k) per edge from packed sketches (the plain
    comparison; :func:`approximate_similarities` dispatches the kernel)."""
    dev = sketches.device
    return hamming_cosine_plain(
        sketches, torch.as_tensor(eu, device=dev).to(torch.int32),
        torch.as_tensor(ev, device=dev).to(torch.int32), samples)


# --------------------------------------------------------------------------
# standard MinHash — k independent uniformly random permutations (§2.1.2)
# --------------------------------------------------------------------------
def minhash_sketches(g: CSRGraph, samples: int, seed: int = 0,
                     *, chunk: Optional[int] = None) -> torch.Tensor:
    """Sketches int32[n, k]: sketch(v)ᵢ = min_{x∈N̄(v)} πᵢ(x). Permutation
    ``i`` is drawn from ``(seed, i)``, so ``chunk`` never changes a
    sketch."""
    if chunk is None:
        chunk = _auto_chunk(g, 1)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive: {chunk}")
    dev = g.device
    eu, nb = g.edge_u.long(), g.nbrs.long()
    out = []
    for s0 in range(0, samples, chunk):
        kc = min(chunk, samples - s0)
        perms = torch.stack([_permutation(seed, s0 + i, g.n, dev)
                             for i in range(kc)], dim=1)          # [n, kc]
        mins = torch.full((g.n, kc), _INT32_MAX, dtype=torch.int32,
                          device=dev)
        if g.m2:
            mins.scatter_reduce_(0, eu[:, None].expand(-1, kc), perms[nb],
                                 "amin")
        out.append(torch.minimum(mins, perms))
    return torch.cat(out, dim=1)


def _match_fraction(sketches: torch.Tensor, eu, ev) -> torch.Tensor:
    """Fraction of equal coordinates per edge, float32: count × f32(1/k),
    the reference's compiled ``jnp.mean`` (XLA turns the division by the
    constant k into that product)."""
    dev = sketches.device
    eu = torch.as_tensor(eu, device=dev).long()
    ev = torch.as_tensor(ev, device=dev).long()
    k = sketches.shape[1]
    inv_k = torch.reciprocal(torch.tensor(float(k), dtype=torch.float32,
                                          device=dev))
    out = torch.empty(eu.shape[0], dtype=torch.float32, device=dev)
    step = max(SKETCH_BUDGET_BYTES // (16 * max(k, 1)), 1)   # edges a slab
    for s in range(0, eu.shape[0], step):
        same = sketches[eu[s: s + step]] == sketches[ev[s: s + step]]
        out[s: s + step] = same.sum(dim=1).to(torch.float32) * inv_k
    return out


def minhash_edge_similarity(sketches: torch.Tensor, eu, ev) -> torch.Tensor:
    return _match_fraction(sketches, eu, ev)


# --------------------------------------------------------------------------
# k-partition MinHash (one-permutation hashing + rotation densification)
# --------------------------------------------------------------------------
def kpartition_sketches(g: CSRGraph, samples: int,
                        seed: int = 0) -> torch.Tensor:
    """Sketches int32[n, k]. The (value, borrow distance) encoding is the
    reference's int32 one, ``val + (n+1)·dist``, so it needs
    ``(n+1)·k < 2³¹``."""
    n, k = g.n, int(samples)
    if (n + 1) * k >= 2 ** 31:
        raise ValueError(
            f"kpartition needs (n+1)·k < 2^31 for its int32 encoding; "
            f"n={n}, k={k}")
    dev = g.device
    perm = _kpartition_permutation(seed, n, dev)
    big = torch.tensor(_INT32_MAX, dtype=torch.int32, device=dev)

    def bucket_val(px: torch.Tensor):
        return (px.long() * k) // n, px

    bk_n, val_n = bucket_val(perm[g.nbrs.long()])
    bk_s, val_s = bucket_val(perm)
    flat = torch.full((n * k,), _INT32_MAX, dtype=torch.int32, device=dev)
    flat.scatter_reduce_(0, g.edge_u.long() * k + bk_n, val_n, "amin")
    flat.scatter_reduce_(0, torch.arange(n, device=dev) * k + bk_s, val_s,
                         "amin")
    val = flat.view(n, k)
    dist = torch.where(val == big, big, torch.zeros_like(val))
    s = 1
    while s < k:
        cand_val = torch.roll(val, -s, dims=1)
        cand_dist = torch.roll(dist, -s, dims=1)
        take = (val == big) & (cand_val != big)
        val = torch.where(take, cand_val, val)
        dist = torch.where(take, cand_dist + s, dist)
        s <<= 1
    return val + (n + 1) * dist


def kpartition_edge_similarity(sketches: torch.Tensor, eu,
                               ev) -> torch.Tensor:
    return _match_fraction(sketches, eu, ev)


# --------------------------------------------------------------------------
# combined approximate-σ entry point with the §6.3 degree heuristic
# --------------------------------------------------------------------------
def exact_edge_mask(g: CSRGraph, measure: str, samples: int) -> torch.Tensor:
    """bool[m2]: the edges §6.3 computes exactly, those with an endpoint of
    closed degree ≤ k (cosine) or 3k/2 (Jaccard)."""
    thr = samples if measure == "cosine" else (3 * samples) // 2
    high = g.closed_degrees() > thr
    return ~(high[g.edge_u.long()] & high[g.nbrs.long()])


def trace_span(tracer):
    """``tracer.span``, or a no-op span factory when ``tracer`` is None."""
    if tracer is not None:
        return tracer.span
    return lambda *args, **attrs: contextlib.nullcontext()


def approximate_similarities(
    g: CSRGraph,
    *,
    measure: str = "cosine",
    method: str = "simhash",
    samples: int = 64,
    seed: int = 0,
    degree_heuristic: bool = True,
    lane: Optional[str] = None,
    tracer=None,
) -> torch.Tensor:
    """σ̂ per half-edge, float32[m2] on the graph's device, clipped to
    [0, 1]. Sketch *construction* is always the sparse torch path; the
    sketch *comparison* resolves its lane from the device (the
    ``hamming_cosine`` kernel on CUDA), and the exact subset goes through
    the bucketed engine (the ``bucket_probe`` kernel on CUDA). ``lane``
    forces both. ``tracer``: any object with a ``span(name, **attrs)``
    context manager, or None; spans ``lsh.sketch``, ``lsh.compare`` and
    ``lsh.exact`` wrap the three stages."""
    span = trace_span(tracer)
    if method == "simhash":
        if measure != "cosine":
            raise ValueError("simhash approximates cosine similarity")
        with span("lsh.sketch", method=method, samples=samples):
            sk = simhash_sketches(g, samples, seed)
        with span("lsh.compare", edges=g.m2):
            approx = ops.simhash_edge_similarity_kernel(
                sk, g.edge_u, g.nbrs, samples, lane=lane)
    elif method in ("minhash", "kpartition"):
        if measure != "jaccard":
            raise ValueError("minhash approximates jaccard similarity")
        with span("lsh.sketch", method=method, samples=samples):
            sk = (minhash_sketches(g, samples, seed) if method == "minhash"
                  else kpartition_sketches(g, samples, seed))
        with span("lsh.compare", edges=g.m2):
            approx = _match_fraction(sk, g.edge_u, g.nbrs)
    else:
        raise ValueError(f"unknown LSH method {method!r}")
    del sk

    if not degree_heuristic:
        return torch.clamp(approx, 0.0, 1.0)
    idx = torch.nonzero(exact_edge_mask(g, measure, samples)).flatten()
    if idx.numel() == 0:
        return torch.clamp(approx, 0.0, 1.0)   # pure-LSH path: no plan
    with span("lsh.exact", edges=int(idx.numel())):
        exact = sim_mod.plan_for(g).edge_sims(
            g.edge_u[idx], g.nbrs[idx], g.wgts[idx], measure=measure,
            lane=lane)
    approx[idx] = exact
    return torch.clamp(approx, 0.0, 1.0)
