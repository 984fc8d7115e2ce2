"""Exact structural similarity σ (port of ``repro.core.similarity``).

The degree-bucketed engine of the reference, on torch tensors on the
graph's device:

* **Degree classes** — vertices fall into power-of-two open-degree classes
  (widths 8, 16, …, capped at the hub tile, 2048); each class is one padded
  block ``[K_c, w_c]`` of sorted neighbor rows (pad id ``n``, a final
  all-pad sentinel row, ``K_c`` rounded up to a power of two).
* **Hub-row splitting** — a vertex wider than the hub tile occupies
  ⌈deg/hub_tile⌉ consecutive tile rows; a chunk gathers them back into one
  sorted row.
* **Edge routing** — each edge probes from its min-(degree, id) side into
  the other side's row. Edges group by (probe class, probe tiles, target
  class, target tiles); each group runs in chunks of at most
  ``CHUNK_ELEMS`` gathered row elements.

Per chunk, ``ops.bucket_probe_stats`` picks the lane through the
:class:`ExecutionPolicy`: on CUDA the ``bucket_probe`` kernel answers
every chunk of every group (no width cutoff); on the CPU, or with an explicit ``lane="ref"``, the plain
searchsorted version does. Both return only (dot, count); σ comes from the
one epilogue, :func:`_sigma_epilogue`, in torch ops. Routing, the chunk
loop's indices and the output stay on the device; the host sees only the
group sizes.

Precision: unweighted dots, counts and norms² are small integers, exact in
float32 under any summation order, so unweighted σ is bit-identical to the
reference and to the dense oracle. Weighted sums agree to float32
resolution. ``closed_norms`` uses a segmented reduction (deterministic on
CUDA, unlike ``index_add_``'s atomics), so weighted σ is bit-stable from
run to run.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.backend.padding import pow2_bucket, pow2ceil
from repro_torch.backend.policy import default_policy
from repro_torch.core.graph import CSRGraph, to_dense
from repro_torch.kernels import ops
from repro_torch.kernels.triangle_count import ieee_fp32_matmul

MEASURES = ("cosine", "jaccard")

# smallest degree-class width: classes are 8, 16, 32, … (pow2)
BUCKET_FLOOR = 8
# storage tile width: rows wider than this split into HUB_TILE-wide tiles
HUB_TILE = 2048
# per-chunk element budget for the transient gathered row matrices
CHUNK_ELEMS = 1 << 22


def _log2_ceil(x: torch.Tensor) -> torch.Tensor:
    """⌈log2 max(x, 1)⌉ elementwise, int64 (float64 log2 is exact on the
    powers of two, as in the reference's numpy)."""
    return torch.ceil(torch.log2(torch.clamp(x, min=1).double())).long()


def _routing_tables(deg: torch.Tensor, n: int, hub_tile: int):
    """Degree → bucketing: (widths, vclass, vtiles), one class rule."""
    dev = deg.device
    if not n:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return (), empty, empty
    k = _log2_ceil(deg)
    w_full = torch.clamp(torch.bitwise_left_shift(torch.ones_like(k), k),
                         min=BUCKET_FLOOR)
    w_cap = torch.clamp(w_full, max=hub_tile)
    vtiles = torch.where(w_full > hub_tile, -(-deg // hub_tile),
                         torch.ones_like(deg)).to(torch.int32)
    widths = tuple(int(w) for w in torch.unique(w_cap).tolist())
    vclass = torch.searchsorted(
        torch.tensor(widths, dtype=torch.int64, device=dev),
        w_cap).to(torch.int32)
    return widths, vclass, vtiles


def closed_norms(g: CSRGraph) -> torch.Tensor:
    """sqrt(Σ_{x∈N̄(v)} w(v,x)²) with w(v,v)=1, float32[n]. A segmented
    reduction over the CSR rows: deterministic on CUDA."""
    if g.m2 == 0:
        return torch.ones(g.n, dtype=torch.float32, device=g.device)
    sq = torch.segment_reduce(g.wgts ** 2, "sum",
                              lengths=g.degrees().long())
    return torch.sqrt(sq + 1.0)


@dataclasses.dataclass(frozen=True, eq=False)
class SimilarityPlan:
    """Bucketed similarity operands for one graph, on its device.

    Per degree class ``c``: ``nbr_blocks[c]`` int32[K_c, w_c] and
    ``wgt_blocks[c]`` float32[K_c, w_c]. Vertex routing tables (device
    tensors): ``vclass`` (class id), ``vrow`` (first tile row), ``vtiles``
    (tile count), ``deg`` (open degree, int64).
    """

    n: int
    m2: int
    hub_tile: int
    widths: Tuple[int, ...]
    nbr_blocks: Tuple[torch.Tensor, ...]
    wgt_blocks: Tuple[torch.Tensor, ...]
    vclass: torch.Tensor   # int32[n]
    vrow: torch.Tensor     # int32[n]
    vtiles: torch.Tensor   # int32[n]
    deg: torch.Tensor      # int64[n]
    norms: torch.Tensor    # float32[n]
    cdeg: torch.Tensor     # int32[n]
    # observability of the most recent edge_sims call (stat slots, written
    # via object.__setattr__): kernel groups and group chunks it ran
    last_groups: int = 0
    last_chunks: int = 0

    @staticmethod
    def build(g: CSRGraph,
              hub_tile: Optional[int] = None) -> "SimilarityPlan":
        if hub_tile is None:
            hub_tile = default_policy().profile.hub_tile
        dev = g.device
        n = g.n
        offsets = g.offsets.long()
        deg = torch.diff(offsets)
        widths, vclass, vtiles = _routing_tables(deg, n, hub_tile)
        eu = g.edge_u.long()
        pos = torch.arange(g.m2, dtype=torch.int64, device=dev) - offsets[eu]
        eclass = vclass[eu]

        vrow = torch.zeros(n, dtype=torch.int32, device=dev)
        nbr_blocks: List[torch.Tensor] = []
        wgt_blocks: List[torch.Tensor] = []
        for ci, w in enumerate(widths):
            members = torch.nonzero(vclass == ci).flatten()
            tiles = vtiles[members].long()
            vrow[members] = (torch.cumsum(tiles, 0) - tiles).to(torch.int32)
            # sentinel pad row at the end; rows rounded up to a power of two
            k_pad = pow2ceil(int(tiles.sum()) + 1)
            nb = torch.full((k_pad, w), n, dtype=torch.int32, device=dev)
            wb = torch.zeros((k_pad, w), dtype=torch.float32, device=dev)
            sel = torch.nonzero(eclass == ci).flatten()
            if sel.numel():
                p = pos[sel]
                r = vrow[eu[sel]].long() + p // w
                c = p % w
                nb[r, c] = g.nbrs[sel]
                wb[r, c] = g.wgts[sel]
            nbr_blocks.append(nb)
            wgt_blocks.append(wb)

        return SimilarityPlan(
            n=n, m2=g.m2, hub_tile=hub_tile, widths=widths,
            nbr_blocks=tuple(nbr_blocks), wgt_blocks=tuple(wgt_blocks),
            vclass=vclass, vrow=vrow, vtiles=vtiles, deg=deg,
            norms=closed_norms(g), cdeg=g.closed_degrees())

    @property
    def device(self) -> torch.device:
        return self.deg.device

    def operand_bytes(self) -> int:
        """Persistent similarity-operand footprint (neighbor + weight
        blocks + norms + closed degrees) in bytes — O(m + n)."""
        total = sum(int(b.numel()) * (4 + 4) for b in self.nbr_blocks)
        return total + 8 * self.n

    def route(self, eu: torch.Tensor, ev: torch.Tensor):
        """Probe side (min (deg, id)) per edge and the per-edge group key
        (probe class, log2 probe tiles^, target class, log2 target
        tiles^). Returns (pu, pv, keys), int64 tensors."""
        du, dv = self.deg[eu], self.deg[ev]
        swap = (dv < du) | ((dv == du) & (ev < eu))
        pu = torch.where(swap, ev, eu)
        pv = torch.where(swap, eu, ev)
        keys = (((self.vclass[pu].long() * 64
                  + _log2_ceil(self.vtiles[pu])) * 64
                 + self.vclass[pv].long()) * 64
                + _log2_ceil(self.vtiles[pv]))
        return pu, pv, keys

    def group_count(self, eu, ev) -> int:
        """Number of distinct (class-pair, tile-shape) kernel groups an
        edge subset routes to."""
        eu, ev = _as_ids(eu, self.device), _as_ids(ev, self.device)
        if eu.numel() == 0:
            return 0
        return int(torch.unique(self.route(eu, ev)[2]).numel())

    def chunks(self, eu: torch.Tensor, ev: torch.Tensor,
               chunk: int = 1 << 16):
        """The engine's work list: for every chunk of every (class pair,
        tile shape) group, yield ``(group, sub, operands)`` — the group's
        ordinal, the chunk's positions in ``eu``/``ev`` and the kernel
        operands ``(rows_p, w_p, rows_t, w_t)`` gathered from the blocks
        (sorted rows, pad id ``n``). ``eu``/``ev`` are int64 tensors on the
        plan's device."""
        if eu.numel() == 0:
            return
        pu, pv, keys = self.route(eu, ev)
        skeys, order = torch.sort(keys, stable=True)
        gkeys, counts = torch.unique_consecutive(skeys, return_counts=True)
        start = 0
        for group, (key, count) in enumerate(zip(gkeys.tolist(),
                                                 counts.tolist())):
            idx = order[start: start + count]
            start += count
            # key = ((cp·64 + log2 sp)·64 + ct)·64 + log2 st, as route() packs it
            rest, lst = divmod(key, 64)
            rest, ct = divmod(rest, 64)
            cp, lsp = divmod(rest, 64)
            sp, st = 1 << lsp, 1 << lst
            pe = sp * self.widths[cp]
            te = st * self.widths[ct]
            cap = max(CHUNK_ELEMS // max(pe + te, 1), 1)
            cap = 1 << (cap.bit_length() - 1)
            csize = min(pow2_bucket(count), max(min(chunk, cap), 1))
            for s in range(0, count, csize):
                sub = idx[s: s + csize]
                cpu_, cpv = pu[sub], pv[sub]
                rows_p, w_p = _gather_tiled_rows(
                    self.nbr_blocks[cp], self.wgt_blocks[cp],
                    self.vrow[cpu_], self.vtiles[cpu_], sp)
                rows_t, w_t = _gather_tiled_rows(
                    self.nbr_blocks[ct], self.wgt_blocks[ct],
                    self.vrow[cpv], self.vtiles[cpv], st)
                yield group, sub, (rows_p, w_p, rows_t, w_t)

    def edge_sims(
        self,
        eu,
        ev,
        ew,
        measure: str = "cosine",
        chunk: int = 1 << 16,
        lane: Optional[str] = None,
    ) -> torch.Tensor:
        """σ (or triangle counts with measure='_count') for an edge subset.

        Every chunk of every group goes through ``ops.bucket_probe_stats``,
        which picks the lane for the plan's device (an explicit ``lane=``
        wins): ``hopper`` launches the ``bucket_probe`` kernel, ``ref`` runs
        the plain version on the same gathered rows.
        """
        if measure not in MEASURES + ("_count",):
            raise ValueError(f"measure must be one of {MEASURES}")
        dev = self.device
        eu, ev = _as_ids(eu, dev), _as_ids(ev, dev)
        ew = torch.as_tensor(ew, dtype=torch.float32, device=dev)
        out_dt = torch.int32 if measure == "_count" else torch.float32
        out = torch.empty(eu.numel(), dtype=out_dt, device=dev)
        groups = chunks = 0
        for group, sub, operands in self.chunks(eu, ev, chunk):
            groups = group + 1
            dot, cnt = ops.bucket_probe_stats(*operands, self.n, lane=lane)
            out[sub] = _sigma_epilogue(dot, cnt, eu[sub], ev[sub], ew[sub],
                                       self.norms, self.cdeg, measure)
            chunks += 1
        object.__setattr__(self, "last_groups", groups)
        object.__setattr__(self, "last_chunks", chunks)
        return out


def _as_ids(x, device) -> torch.Tensor:
    """Edge endpoint ids as int64 on ``device`` (tensor or array-like)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def _gather_tiled_rows(block_n, block_w, first, cnt, s: int):
    """Reassemble [c, s·w] sorted rows from ``s`` consecutive tile rows per
    entry (tiles beyond ``cnt`` map to the all-pad sentinel row)."""
    k_sent = block_n.shape[0] - 1
    w = block_n.shape[1]
    t = torch.arange(s, dtype=torch.int64, device=first.device)[None, :]
    first = first.long()[:, None]
    idx = torch.where(t < cnt.long()[:, None], first + t,
                      torch.full_like(t, k_sent))
    c = idx.shape[0]
    return (block_n[idx].reshape(c, s * w), block_w[idx].reshape(c, s * w))


def _sigma_epilogue(shared_dot, shared_cnt, eu, ev, ew, norms, cdeg,
                    measure: str):
    """Shared-dot/count → σ: the one implementation every lane shares."""
    if measure == "_count":
        return shared_cnt.to(torch.int32)
    if measure == "cosine":
        # closed-neighborhood dot: open shared dot + x=u and x=v terms
        closed_dot = shared_dot + 2.0 * ew
        return closed_dot / (norms[eu] * norms[ev])
    if measure == "jaccard":
        c = shared_cnt.to(torch.float32) + 2.0       # + {u, v}
        union = cdeg[eu].to(torch.float32) + cdeg[ev].to(torch.float32) - c
        return c / union
    raise ValueError(f"unknown measure {measure!r}")


# ---------------------------------------------------------------------------
# plan cache (one plan per live graph object)
# ---------------------------------------------------------------------------
_PLAN_CACHE: Dict[Tuple[int, int], Tuple[object, SimilarityPlan]] = {}


def _evict_plan(key, ref) -> None:
    """Finalizer: drop a cache entry when its graph dies — only if the slot
    still belongs to that graph (ids are reused)."""
    ent = _PLAN_CACHE.get(key)
    if ent is not None and ent[0] is ref:
        del _PLAN_CACHE[key]


def plan_for(g: CSRGraph,
             hub_tile: Optional[int] = None) -> SimilarityPlan:
    """The bucketed :class:`SimilarityPlan` for ``g``, cached per live
    graph object and evicted by a ``weakref.finalize`` on the graph, so a
    plan never outlives its graph."""
    if hub_tile is None:
        hub_tile = default_policy().profile.hub_tile
    key = (id(g), hub_tile)
    ent = _PLAN_CACHE.get(key)
    if ent is not None and ent[0]() is g:
        return ent[1]
    plan = SimilarityPlan.build(g, hub_tile)
    ref = weakref.ref(g)
    _PLAN_CACHE[key] = (ref, plan)
    weakref.finalize(g, _evict_plan, key, ref)
    return plan


def plan_cache_size() -> int:
    """Live entry count of the per-graph plan cache (leak detection)."""
    return len(_PLAN_CACHE)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def edge_similarities_subset(
    g: CSRGraph,
    eu,
    ev,
    ew,
    measure: str = "cosine",
    chunk: int = 1 << 16,
    *,
    lane: Optional[str] = None,
) -> torch.Tensor:
    """Exact σ for an arbitrary subset of edges (endpoint arrays)."""
    if measure not in MEASURES:
        raise ValueError(f"measure must be one of {MEASURES}")
    return plan_for(g).edge_sims(eu, ev, ew, measure, chunk, lane=lane)


def compute_similarities(
    g: CSRGraph, measure: str = "cosine", chunk: int = 1 << 16,
    *, lane: Optional[str] = None,
) -> torch.Tensor:
    """Exact σ for every half-edge, float32[m2], on the graph's device."""
    return edge_similarities_subset(g, g.edge_u, g.nbrs, g.wgts, measure,
                                    chunk, lane=lane)


def triangle_counts(g: CSRGraph) -> torch.Tensor:
    """|N(u) ∩ N(v)| per half-edge, via the bucketed probe engine."""
    return plan_for(g).edge_sims(g.edge_u, g.nbrs, g.wgts, "_count")


def compute_similarities_dense(g: CSRGraph,
                               measure: str = "cosine") -> torch.Tensor:
    """Small-graph oracle via the closed adjacency product (TF32 off)."""
    weighted = measure == "cosine"
    adj_c = to_dense(g, closed=True, weighted=weighted)
    with ieee_fp32_matmul():
        prod = adj_c @ adj_c.T
    eu, ev = g.edge_u.long(), g.nbrs.long()
    dots = prod[eu, ev]
    if measure == "cosine":
        norms = torch.sqrt(torch.diagonal(prod))
        return dots / (norms[eu] * norms[ev])
    cdeg = g.closed_degrees()
    union = cdeg[eu].to(torch.float32) + cdeg[ev].to(torch.float32) - dots
    return dots / union
