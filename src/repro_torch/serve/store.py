"""Index content fingerprint (port of the fingerprint in
``repro.serve.store``; snapshots, catalogs and the delta log come with the
persistence slice)."""
from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.core.graph import CSRGraph
from repro_torch.core.index import ScanIndex


def index_fingerprint(index: ScanIndex, g: CSRGraph) -> str:
    """sha256 over (graph structure, edge similarities): the raw bytes of
    int32 ``offsets``/``nbrs`` and float32 ``wgts``/``edge_sims``, so the
    same content hashes the same in both packages."""
    h = hashlib.sha256()
    h.update(f"n={g.n};m2={g.m2}".encode())
    for t in (g.offsets, g.nbrs, g.wgts, index.edge_sims):
        h.update(np.ascontiguousarray(t.cpu().numpy()).tobytes())
    return h.hexdigest()
