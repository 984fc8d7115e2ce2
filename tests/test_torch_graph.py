"""Port graphs vs the reference: one seed, byte-identical CSR arrays."""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core import graph as rg
from repro_torch import interop
from repro_torch.core import graph as tg


CPU = {"device": "cpu"}


def ref_arrays(g):
    return {f: np.asarray(getattr(g, f)) for f in interop.GRAPH_FIELDS}


def assert_same_csr(gr, gt):
    assert (gr.n, gr.m2) == (gt.n, gt.m2)
    want, got = ref_arrays(gr), interop.graph_to_arrays(gt)
    for f in interop.GRAPH_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        assert got[f].tobytes() == want[f].tobytes(), f


GENERATORS = [
    ("random_graph", (300, 6.0), dict(seed=1)),
    ("random_graph", (200, 5.0), dict(seed=2, weighted=True)),
    ("random_graph", (400, 8.0), dict(seed=3, planted_clusters=8)),
    ("power_law_graph", (500, 2.1), dict(seed=4, hub_degree=100)),
    ("power_law_graph", (300, 2.3), dict(seed=5, avg_degree=6.0,
                                         weighted=True)),
    ("hub_ring_graph", (80, 60), {}),
    ("hub_ring_graph", (50, 30), dict(seed=6, weighted=True)),
]


@pytest.mark.parametrize("fn,args,kw", GENERATORS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(GENERATORS)])
def test_generators_byte_identical(fn, args, kw):
    gr = getattr(rg, fn)(*args, **kw)
    gt = getattr(tg, fn)(*args, **kw, **CPU)
    assert_same_csr(gr, gt)
    np.testing.assert_array_equal(gt.closed_degrees().numpy(),
                                  np.asarray(gr.closed_degrees()))


def test_from_edge_list_dedup_self_loops_first_weight():
    edges = [(0, 1), (1, 0), (2, 2), (3, 1), (0, 1), (4, 3), (1, 3)]
    weights = [0.5, 0.7, 0.9, 0.25, 0.125, 1.0, 0.75]
    assert_same_csr(rg.from_edge_list(6, edges, weights),
                    tg.from_edge_list(6, edges, weights, **CPU))
    got = tg.from_edge_list(6, edges, weights, **CPU)
    assert got.wgts[0].item() == 0.5                 # first (0,1) weight kept


def test_from_edge_list_random_multigraph():
    rng = np.random.default_rng(7)
    e = rng.integers(0, 40, size=(300, 2))
    w = rng.uniform(0.1, 1.0, size=300).astype(np.float32)
    assert_same_csr(rg.from_edge_list(40, e, w),
                    tg.from_edge_list(40, e, w, **CPU))
    assert_same_csr(rg.from_edge_list(40, e), tg.from_edge_list(40, e, **CPU))


def test_empty_and_isolated():
    assert_same_csr(rg.from_edge_list(5, np.zeros((0, 2), np.int64)),
                    tg.from_edge_list(5, np.zeros((0, 2), np.int64), **CPU))
    assert_same_csr(rg.from_edge_list(7, [(5, 6)]),
                    tg.from_edge_list(7, [(5, 6)], **CPU))


def test_from_edge_list_validates():
    with pytest.raises(ValueError):
        tg.from_edge_list(2 ** 31 + 1, [(0, 1)], **CPU)
    with pytest.raises(ValueError):
        tg.from_edge_list(4, [(0, 1)], [0.5, 0.5], **CPU)


@pytest.mark.parametrize("weighted", [False, True])
def test_graph_from_dense(weighted):
    rng = np.random.default_rng(8)
    a = rng.uniform(0.1, 1.0, (30, 30)) * (rng.random((30, 30)) < 0.2)
    a = np.triu(a, 1)
    a = (a + a.T).astype(np.float32)
    assert_same_csr(rg.graph_from_dense(a, weighted),
                    tg.graph_from_dense(a, weighted, **CPU))


@pytest.mark.parametrize("closed,weighted", [(False, True), (True, True),
                                             (True, False)])
def test_to_dense(closed, weighted):
    gr = rg.random_graph(60, 5.0, seed=9, weighted=True)
    gt = tg.random_graph(60, 5.0, seed=9, weighted=True, **CPU)
    np.testing.assert_array_equal(
        tg.to_dense(gt, closed, weighted).numpy(),
        np.asarray(rg.to_dense(gr, closed, weighted)))


def test_interop_graph_round_trip():
    gr = rg.power_law_graph(200, 2.1, seed=10, weighted=True, hub_degree=50)
    gt = interop.graph_from_arrays(ref_arrays(gr), **CPU)
    assert_same_csr(gr, gt)
    again = interop.graph_from_arrays(interop.graph_to_arrays(gt), **CPU)
    assert_same_csr(gr, again)
    bad = dict(ref_arrays(gr), nbrs=np.asarray(gr.nbrs).astype(np.int64))
    with pytest.raises(TypeError):
        interop.graph_from_arrays(bad, **CPU)


def test_tensors_are_storage_types():
    g = tg.random_graph(50, 4.0, seed=11, weighted=True, **CPU)
    assert g.offsets.dtype == g.nbrs.dtype == g.edge_u.dtype == torch.int32
    assert g.wgts.dtype == torch.float32
    assert g.m == g.m2 // 2
