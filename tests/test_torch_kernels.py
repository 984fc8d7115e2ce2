"""Plain versions of the port's kernels vs the reference's Pallas kernels
(interpret mode) and pure-jnp oracles, on the reference tests' shapes.

Bars: counts and unweighted dots bit-identical, weighted dots
``rtol=1e-6`` (sums taken in another order); masked gram at the
reference's own ``rtol=2e-4, atol=2e-3`` for gaussian W, bit-identical for
0/1 adjacency (integer sums are exact in any order); packed SimHash words
and Hamming distances bit-identical, σ̂ within 1 ULP (``torch.cos`` and
XLA's cos differ by an ULP on some inputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as rg
from repro.kernels import ops as rops
from repro.kernels import ref as kref
from repro.kernels.bucket_probe import bucket_probe as ref_bucket_probe
from repro.kernels.hamming import hamming_cosine as ref_hamming_cosine
from repro.kernels.simhash import simhash_pack as ref_simhash_pack
from repro.kernels.triangle_count import masked_gram as ref_masked_gram
from repro_torch.core import graph as tg
from repro_torch.kernels import bucket_probe as bp_mod
from repro_torch.kernels import ops
from repro_torch.kernels.bucket_probe import bucket_probe_plain
from repro_torch.kernels.hamming import hamming_cosine_plain
from repro_torch.kernels.simhash import simhash_pack_plain
from repro_torch.kernels.triangle_count import masked_gram_plain


def probe_rows(rng, e, width, n_ids, fill):
    """Sorted rows of distinct ids in [0, n_ids), padded at the tail."""
    rows = np.full((e, width), fill, np.int32)
    for i in range(e):
        k = int(rng.integers(0, min(width, n_ids) + 1))
        rows[i, :k] = np.sort(rng.choice(n_ids, size=k, replace=False))
    return rows


def both_pads(rows, n, ref_pad):
    """The port keeps pad id n; the Pallas kernel wants negative pads."""
    return rows, np.where(rows >= n, ref_pad, rows).astype(np.int32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("e,p,t,be,bt", [(64, 8, 32, 32, 16),
                                         (128, 16, 64, 64, 64),
                                         (32, 8, 128, 32, 32)])
def test_bucket_probe_plain_vs_pallas_and_oracle(e, p, t, be, bt, weighted):
    rng = np.random.default_rng(e + p + t)
    n = 64
    pp, pr = both_pads(probe_rows(rng, e, p, n, n), n, -1)
    tp, tr = both_pads(probe_rows(rng, e, t, n, n), n, -2)
    if weighted:
        w_p = rng.uniform(0.1, 1.0, (e, p)).astype(np.float32)
        w_t = rng.uniform(0.1, 1.0, (e, t)).astype(np.float32)
    else:
        w_p = np.ones((e, p), np.float32)
        w_t = np.ones((e, t), np.float32)
    dot, cnt = bucket_probe_plain(torch.from_numpy(pp), torch.from_numpy(w_p),
                                  torch.from_numpy(tp), torch.from_numpy(w_t),
                                  n)
    args = tuple(jnp.asarray(x) for x in (pr, w_p, tr, w_t))
    k_dot, k_cnt = ref_bucket_probe(*args, be=be, bt=bt, interpret=True)
    o_dot, o_cnt = kref.bucket_probe_ref(*args)
    for want_dot, want_cnt in ((k_dot, k_cnt), (o_dot, o_cnt)):
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
        if weighted:
            np.testing.assert_allclose(dot.numpy(), np.asarray(want_dot),
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(dot.numpy(), np.asarray(want_dot))


def test_bucket_probe_plain_slabs_are_invisible(monkeypatch):
    rng = np.random.default_rng(3)
    n = 500
    rows_p = torch.from_numpy(probe_rows(rng, 50, 16, n, n))
    rows_t = torch.from_numpy(probe_rows(rng, 50, 256, n, n))
    w_p = torch.from_numpy(rng.uniform(0.1, 1, (50, 16)).astype(np.float32))
    w_t = torch.from_numpy(rng.uniform(0.1, 1, (50, 256)).astype(np.float32))
    whole = bucket_probe_plain(rows_p, w_p, rows_t, w_t, n)
    monkeypatch.setattr(bp_mod, "_PLAIN_CHUNK_ELEMS", 300)   # 1 edge a slab
    sliced = bucket_probe_plain(rows_p, w_p, rows_t, w_t, n)
    assert torch.equal(whole[0], sliced[0]) and torch.equal(whole[1],
                                                            sliced[1])


@pytest.mark.parametrize("weighted", [False, True])
def test_bucket_probe_stats_vs_reference(weighted):
    rng = np.random.default_rng(11)
    e, p, t, n = 64, 8, 48, 64
    rows_p = probe_rows(rng, e, p, n, n)
    rows_t = probe_rows(rng, e, t, n, n)
    if weighted:
        w_p = rng.uniform(0.1, 1.0, (e, p)).astype(np.float32)
        w_t = rng.uniform(0.1, 1.0, (e, t)).astype(np.float32)
    else:
        w_p = np.ones((e, p), np.float32)
        w_t = np.ones((e, t), np.float32)
    want_dot, want_cnt = rops.bucket_probe_stats(
        jnp.asarray(rows_p), jnp.asarray(w_p), jnp.asarray(rows_t),
        jnp.asarray(w_t), n, lane="ref")
    dot, cnt = ops.bucket_probe_stats(
        torch.from_numpy(rows_p), torch.from_numpy(w_p),
        torch.from_numpy(rows_t), torch.from_numpy(w_t), n)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    if weighted:
        np.testing.assert_allclose(dot.numpy(), np.asarray(want_dot),
                                   rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(dot.numpy(), np.asarray(want_dot))


@pytest.mark.parametrize("n,block", [(128, 128), (256, 128), (256, 64),
                                     (384, 128)])
def test_masked_gram_plain_vs_pallas(n, block):
    rng = np.random.default_rng(n + block)
    w = rng.standard_normal((n, n)).astype(np.float32)
    m = (rng.random((n, n)) < 0.15).astype(np.float32)
    got = masked_gram_plain(torch.from_numpy(w), torch.from_numpy(m))
    want = ref_masked_gram(jnp.asarray(w), jnp.asarray(m), bm=block,
                           bn=block, bk=block, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-3)


def test_masked_gram_plain_exact_on_adjacency():
    g = rg.random_graph(128, 6.0, seed=12)
    w = np.array(rg.to_dense(g, closed=True, weighted=False))
    m = (w > 0).astype(np.float32)
    got = masked_gram_plain(torch.from_numpy(w), torch.from_numpy(m))
    want = ref_masked_gram(jnp.asarray(w), jnp.asarray(m), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("measure,weighted", [("cosine", False),
                                              ("jaccard", False),
                                              ("cosine", True)])
def test_edge_similarities_gram_vs_reference(measure, weighted):
    gr = rg.random_graph(150, 6.0, seed=1, weighted=weighted)
    gt = tg.random_graph(150, 6.0, seed=1, weighted=weighted, device="cpu")
    want = np.asarray(rops.edge_similarities_gram(gr, measure, lane="ref"))
    got = ops.edge_similarities_gram(gt, measure).numpy()
    if weighted:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def f32_ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(a - b)))


@pytest.mark.parametrize("e,words,k", [(1024, 4, 128), (2048, 8, 256),
                                       (1024, 1, 32)])
def test_hamming_cosine_plain_vs_pallas(e, words, k):
    rng = np.random.default_rng(e + words)
    su = rng.integers(0, 2 ** 32, size=(e, words), dtype=np.uint32)
    sv = rng.integers(0, 2 ** 32, size=(e, words), dtype=np.uint32)
    sk = torch.from_numpy(np.concatenate([su, sv]).view(np.int32)) \
        .view(torch.uint32)
    eu = torch.arange(e, dtype=torch.int32)
    sim, diff = hamming_cosine_plain(sk, eu, eu + e, k, return_diff=True)
    np.testing.assert_array_equal(diff.numpy(),
                                  np.bitwise_count(su ^ sv).sum(axis=1))
    want = ref_hamming_cosine(jnp.asarray(su), jnp.asarray(sv), samples=k,
                              be=512, interpret=True)
    oracle = jax.jit(kref.hamming_cosine_ref, static_argnums=2)(
        jnp.asarray(su), jnp.asarray(sv), k)
    assert f32_ulps(sim.numpy(), want) <= 1
    assert f32_ulps(sim.numpy(), oracle) <= 1


@pytest.mark.parametrize("n,k", [(128, 128), (256, 256), (128, 384)])
def test_simhash_pack_plain_vs_pallas(n, k):
    rng = np.random.default_rng(n + k)
    w = rng.standard_normal((n, n)).astype(np.float32)
    r = rng.standard_normal((n, k)).astype(np.float32)
    got = u32(simhash_pack_plain(torch.from_numpy(w), torch.from_numpy(r)))
    want = ref_simhash_pack(jnp.asarray(w), jnp.asarray(r), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        got, np.asarray(kref.simhash_pack_ref(jnp.asarray(w), jnp.asarray(r))))


@pytest.mark.parametrize("samples", [64, 200])
def test_simhash_sketches_kernel_vs_reference(monkeypatch, samples):
    """The dense form with the reference's R injected: the port reads R
    a word (32 columns) at a time from the reference's one draw."""
    from repro_torch.core import lsh as tl

    gr = rg.random_graph(150, 6.0, seed=7, weighted=True)
    gt = tg.random_graph(150, 6.0, seed=7, weighted=True, device="cpu")
    key = jax.random.PRNGKey(5)
    k_pad = max((samples + 127) // 128 * 128, 128)
    r = np.array(jax.random.normal(key, (gr.n, k_pad), dtype=jnp.float32))
    monkeypatch.setattr(
        tl, "_word_projections", lambda seed, word, n, device:
        torch.from_numpy(r[:, 32 * word: 32 * word + 32].copy()))
    want = np.asarray(rops.simhash_sketches_kernel(gr, samples, key,
                                                   lane="ref"))
    got = ops.simhash_sketches_kernel(gt, samples, seed=0)
    assert got.shape == want.shape
    np.testing.assert_array_equal(u32(got), want)
    sim = ops.simhash_edge_similarity_kernel(got, gt.edge_u, gt.nbrs,
                                             samples)
    ref_sim = rops.simhash_edge_similarity_kernel(
        jnp.asarray(want), gr.edge_u, gr.nbrs, samples, lane="ref")
    diff = np.bitwise_count(want[np.asarray(gr.edge_u)]
                            ^ want[np.asarray(gr.nbrs)]).sum(axis=1)
    np.testing.assert_array_equal(
        hamming_cosine_plain(got, gt.edge_u, gt.nbrs, samples,
                             return_diff=True)[1].numpy(), diff)
    if samples & (samples - 1) == 0:   # XLA folds π/k into one constant
        assert f32_ulps(sim.numpy(), ref_sim) <= 1
