"""Connectivity via min-label propagation + pointer jumping (port of
``repro.core.connectivity``).

Every vertex carries a label (its own id); each round scatter-mins
neighbor labels over the active edges, then pointer-jumps twice
(``labels = labels[labels]``), until a round changes nothing. Inactive
edges would only ever propose ``n``, which never wins the min, so the
active edges are compacted once up front: the per-round label sequence,
and so the fixed point, are those of the reference. The all-reduce variant
for sharded edges comes with the sharded slice.
"""
from __future__ import annotations

from typing import Optional

import torch


def connected_components(
    n: int,
    eu: torch.Tensor,                      # [E] edge endpoints (half-edges fine)
    ev: torch.Tensor,                      # [E]
    edge_mask: Optional[torch.Tensor] = None,   # bool[E] active edges
    vertex_mask: Optional[torch.Tensor] = None,  # bool[n] active vertices
) -> torch.Tensor:
    """Labels int64[n]: min vertex id of the component (meaningful where
    ``vertex_mask``); inactive vertices keep label = own id."""
    if edge_mask is not None:
        sel = torch.nonzero(edge_mask).flatten()
        eu, ev = eu[sel], ev[sel]
    eu, ev = eu.long(), ev.long()
    dev = eu.device
    labels = torch.arange(n, dtype=torch.int64, device=dev)
    if vertex_mask is None:
        vertex_mask = torch.ones(n, dtype=torch.bool, device=dev)
    big = torch.full((n,), n, dtype=torch.int64, device=dev)
    while True:
        prop = big.scatter_reduce(0, eu, labels[ev], "amin",
                                  include_self=True)
        new = torch.where(vertex_mask, torch.minimum(labels, prop), labels)
        new = new[new]
        new = new[new]
        if torch.equal(new, labels):
            return new
        labels = new
