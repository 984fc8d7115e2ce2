"""Port σ vs the reference's degree-bucketed engine, on the reference
tests' graphs. Bars: unweighted σ bit-identical (every intermediate is a
small integer), weighted σ ``rtol=2e-5, atol=1e-6`` (float sums in
another order); the port is bit-deterministic against itself."""
import gc

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core import graph as rg
from repro.core import similarity as rs
from repro.kernels import ops as rops
from repro_torch.core import graph as tg
from repro_torch.core import similarity as ts
from repro_torch.kernels import ops

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                     # pragma: no cover
    given = None


CPU = {"device": "cpu"}

# the reference's CASES (tests/test_bucketed_similarity.py), as recipes
CASES = [
    ("random_graph", (40, 5.0), dict(seed=1), "cosine"),
    ("random_graph", (40, 5.0), dict(seed=1), "jaccard"),
    ("random_graph", (64, 7.0), dict(seed=2, weighted=True), "cosine"),
    ("hub_ring_graph", (60, 45), {}, "cosine"),
    ("hub_ring_graph", (60, 45), {}, "jaccard"),
    ("power_law_graph", (150, 2.1), dict(seed=3, hub_degree=64), "jaccard"),
    ("power_law_graph", (150, 2.1), dict(seed=4, weighted=True,
                                         hub_degree=64), "cosine"),
]


def pair(fn, args, kw):
    return getattr(rg, fn)(*args, **kw), getattr(tg, fn)(*args, **kw, **CPU)


def assert_sigma(got, want, weighted):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    if weighted:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn,args,kw,measure", CASES,
                         ids=[f"{c[0]}-{c[3]}-{i}" for i, c in enumerate(CASES)])
def test_sigma_matches_reference(fn, args, kw, measure):
    gr, gt = pair(fn, args, kw)
    assert_sigma(ts.compute_similarities(gt, measure),
                 rs.compute_similarities(gr, measure),
                 kw.get("weighted", False))


@pytest.mark.parametrize("fn,args,kw,measure", CASES[:3],
                         ids=["cos", "jac", "cos-w"])
def test_dense_oracle_and_gram_match_reference(fn, args, kw, measure):
    gr, gt = pair(fn, args, kw)
    weighted = kw.get("weighted", False)
    dense = ts.compute_similarities_dense(gt, measure)
    assert_sigma(dense, rs.compute_similarities_dense(gr, measure), weighted)
    gram = ops.edge_similarities_gram(gt, measure)
    assert_sigma(gram, rops.edge_similarities_gram(gr, measure, lane="ref"),
                 weighted)
    if not weighted:   # bucketed ≡ dense ≡ gram, bit for bit
        bucketed = ts.compute_similarities(gt, measure)
        assert torch.equal(bucketed, dense) and torch.equal(bucketed, gram)


def test_forced_hub_tiling_matches_reference():
    gr, gt = pair("hub_ring_graph", (80, 60), {})
    tiled_t = ts.plan_for(gt, hub_tile=16)
    tiled_r = rs.plan_for(gr, hub_tile=16)
    assert int(tiled_t.vtiles.max()) > 1                 # splitting engaged
    got = tiled_t.edge_sims(gt.edge_u, gt.nbrs, gt.wgts, "cosine")
    want = tiled_r.edge_sims(gr.edge_u, gr.nbrs, gr.wgts, "cosine")
    assert_sigma(got, want, False)
    assert torch.equal(got, ts.compute_similarities(gt, "cosine"))


@pytest.mark.parametrize("hub_tile", [16, 2048])
def test_plan_layout_matches_reference(hub_tile):
    gr, gt = pair("power_law_graph", (150, 2.1),
                  dict(seed=4, weighted=True, hub_degree=64))
    pr, pt = rs.SimilarityPlan.build(gr, hub_tile), \
        ts.SimilarityPlan.build(gt, hub_tile)
    assert pt.widths == pr.widths
    for f in ("vclass", "vrow", "vtiles"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      getattr(pr, f))
    for a, b in zip(pt.nbr_blocks + pt.wgt_blocks,
                    pr.nbr_blocks + pr.wgt_blocks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pt.operand_bytes() == pr.operand_bytes()
    eu, ev = gt.edge_u.numpy(), gt.nbrs.numpy()
    assert pt.group_count(eu, ev) == pr.group_count(eu, ev)
    np.testing.assert_allclose(pt.norms.numpy(), np.asarray(pr.norms),
                               rtol=1e-6)


def test_closed_norms_exact_unweighted():
    gr, gt = pair("power_law_graph", (150, 2.1), dict(seed=3, hub_degree=64))
    np.testing.assert_array_equal(ts.closed_norms(gt).numpy(),
                                  np.asarray(rs.closed_norms(gr)))


def test_triangle_counts_match_reference():
    gr, gt = pair("power_law_graph", (150, 2.1), dict(seed=3, hub_degree=64))
    got = ts.triangle_counts(gt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(rs.triangle_counts(gr)))


def test_subset_equals_full_slice():
    _, g = pair("power_law_graph", (150, 2.1),
                dict(seed=4, weighted=True, hub_degree=64))
    full = ts.compute_similarities(g, "cosine")
    sel = np.random.default_rng(5).choice(g.m2, size=g.m2 // 3,
                                          replace=False)
    sub = ts.edge_similarities_subset(g, g.edge_u[sel], g.nbrs[sel],
                                      g.wgts[sel], "cosine")
    assert torch.equal(sub, full[sel])


def test_chunked_equals_unchunked_and_deterministic():
    _, g = pair("random_graph", (64, 7.0), dict(seed=2, weighted=True))
    whole = ts.compute_similarities(g, "cosine")
    chunked = ts.compute_similarities(g, "cosine", chunk=4)
    assert ts.plan_for(g).last_chunks > ts.plan_for(g).last_groups
    assert torch.equal(whole, chunked)
    assert torch.equal(whole, ts.compute_similarities(g, "cosine"))


def test_every_chunk_dispatches_through_bucket_probe_stats():
    from repro_torch.backend.policy import default_policy

    _, g = pair("random_graph", (64, 7.0), dict(seed=2, weighted=True))
    counts = default_policy().counts
    before = counts.get("bucket_probe.ref", 0)
    ts.compute_similarities(g, "cosine", chunk=4)
    assert counts["bucket_probe.ref"] - before == ts.plan_for(g).last_chunks


def test_reference_pallas_lane_in_the_comparison(monkeypatch):
    monkeypatch.setenv("REPRO_LANE", "pallas-interpret")
    gr, gt = pair("hub_ring_graph", (60, 45), {})
    assert_sigma(ts.compute_similarities(gt, "jaccard"),
                 rs.compute_similarities(gr, "jaccard"), False)


def test_ref_lane_is_explicit_and_equal():
    _, g = pair("random_graph", (40, 5.0), dict(seed=1))
    assert torch.equal(ts.compute_similarities(g, lane="ref"),
                       ts.compute_similarities(g))
    with pytest.raises(ValueError):
        ts.compute_similarities(g, lane="hopper")    # CPU tensors: no kernel


def test_plan_cache_evicts_with_graph():
    gc.collect()               # earlier tests' cyclic garbage must not count
    before = ts.plan_cache_size()
    g = tg.random_graph(30, 4.0, seed=9, **CPU)
    ts.plan_for(g)
    assert ts.plan_cache_size() == before + 1
    assert ts.plan_for(g) is ts.plan_for(g)
    del g
    gc.collect()
    assert ts.plan_cache_size() == before


def test_empty_graph():
    g = tg.from_edge_list(4, np.zeros((0, 2), np.int64), **CPU)
    out = ts.compute_similarities(g)
    assert out.shape == (0,) and out.dtype == torch.float32


if given is not None:
    @settings(max_examples=15, deadline=None)
    @given(st.integers(2, 40).flatmap(lambda n: st.tuples(
        st.just(n),
        st.lists(st.tuples(st.integers(0, n - 1), st.integers(0, n - 1)),
                 min_size=1, max_size=120),
        st.sampled_from(["cosine", "jaccard"]))))
    def test_hypothesis_port_vs_reference(case):
        n, edges, measure = case
        gr = rg.from_edge_list(n, edges)
        gt = tg.from_edge_list(n, edges, **CPU)
        assert_sigma(ts.compute_similarities(gt, measure),
                     rs.compute_similarities(gr, measure), False)
