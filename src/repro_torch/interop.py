"""State across the two packages as plain numpy dicts.

Keys are the reference's field names (``_GRAPH_FIELDS`` / ``_INDEX_FIELDS``
of ``repro.serve.store``), so a dict filled from either package's objects
builds the other's: the tests feed the reference's graph and σ into the
port this way, and the port never sees a JAX object.

An approximate index crosses the same way: its arrays are an index's
arrays, and its :class:`IndexProvenance` travels as the store's
``provenance`` leaf, the tag's JSON as uint8 bytes (the same JSON in both
packages).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.approx import EXACT_PROVENANCE, IndexProvenance
from repro_torch.core.graph import CSRGraph, resolve_device
from repro_torch.core.index import ScanIndex

GRAPH_FIELDS = ("offsets", "nbrs", "wgts", "edge_u")
INDEX_FIELDS = ("offsets_c", "no_nbrs", "no_sims", "no_self", "co_offsets",
                "co_vertex", "co_theta", "cdeg", "edge_sims")
PROVENANCE_FIELD = "provenance"

_GRAPH_DTYPES = {"offsets": np.int32, "nbrs": np.int32, "wgts": np.float32,
                 "edge_u": np.int32}
_INDEX_DTYPES = {"offsets_c": np.int32, "no_nbrs": np.int32,
                 "no_sims": np.float32, "no_self": np.bool_,
                 "co_offsets": np.int32, "co_vertex": np.int32,
                 "co_theta": np.float32, "cdeg": np.int32,
                 "edge_sims": np.float32}


def _to_tensor(a, dtype, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype != dtype:
        raise TypeError(f"expected {np.dtype(dtype)}, got {arr.dtype}")
    return torch.from_numpy(arr.copy()).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def graph_from_arrays(arrays: Dict[str, np.ndarray], *,
                      device=None) -> CSRGraph:
    """CSRGraph from ``offsets/nbrs/wgts/edge_u`` arrays."""
    device = resolve_device(device)
    t = {f: _to_tensor(arrays[f], _GRAPH_DTYPES[f], device)
         for f in GRAPH_FIELDS}
    return CSRGraph(**t, n=int(t["offsets"].shape[0]) - 1,
                    m2=int(t["nbrs"].shape[0]))


def graph_to_arrays(g: CSRGraph) -> Dict[str, np.ndarray]:
    return {f: _to_numpy(getattr(g, f)) for f in GRAPH_FIELDS}


def index_from_arrays(arrays: Dict[str, np.ndarray], *,
                      device=None) -> ScanIndex:
    """ScanIndex from the reference's index leaves; the python-int fields
    follow from the array shapes."""
    device = resolve_device(device)
    t = {f: _to_tensor(arrays[f], _INDEX_DTYPES[f], device)
         for f in INDEX_FIELDS}
    return ScanIndex(**t, n=int(t["cdeg"].shape[0]),
                     m2c=int(t["no_nbrs"].shape[0]),
                     max_cdeg=int(t["co_offsets"].shape[0]) - 2)


def index_to_arrays(index: ScanIndex,
                    provenance: Optional[IndexProvenance] = None
                    ) -> Dict[str, np.ndarray]:
    """The index leaves, plus the ``provenance`` leaf when given."""
    out = {f: _to_numpy(getattr(index, f)) for f in INDEX_FIELDS}
    if provenance is not None:
        out[PROVENANCE_FIELD] = provenance_to_leaf(provenance)
    return out


def provenance_to_leaf(provenance: IndexProvenance) -> np.ndarray:
    """The store's encoding of a provenance tag: its JSON as uint8."""
    return np.frombuffer(provenance.to_json().encode(), dtype=np.uint8)


def provenance_from_arrays(arrays: Dict[str, np.ndarray]) -> IndexProvenance:
    """The tag in the ``provenance`` leaf; without one the index is exact
    (as the store reads snapshots that predate the leaf)."""
    raw = arrays.get(PROVENANCE_FIELD)
    if raw is None:
        return EXACT_PROVENANCE
    return IndexProvenance.from_json(bytes(np.asarray(raw, np.uint8)).decode())
