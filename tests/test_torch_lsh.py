"""LSH sketches of the port (``repro_torch.core.lsh``) against the JAX
reference, and on the port's own generators.

Parity: the port's draw functions are replaced by the reference's own
draws (the same ``jax.random`` calls, handed over as numpy), and then the
packed SimHash words, the MinHash and k-partition sketches and the integer
Hamming distances must be bit-identical. σ̂ = cos(π·d/k) is held to 1 ULP
(``torch.cos`` and XLA's cos differ by an ULP on some inputs) at sample
counts that are powers of two; at other counts XLA folds π/k into one
constant and θ itself moves by an ULP, so there only the distances are
compared.

The port's own RNG: the Theorem 5.2 / 5.3 classification bounds, chunk
invariance, determinism, and §6.3 exactness on low-degree edges, mirroring
``tests/test_lsh.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as rg
from repro.core import lsh as rl
from repro_torch.core import graph as tg
from repro_torch.core import lsh as tl
from repro_torch.core.index import build_index
from repro_torch.core.quality import adjusted_rand_index
from repro_torch.core.query import query
from repro_torch.core.similarity import compute_similarities
from repro_torch.kernels.hamming import hamming_cosine_plain


def u32(t: torch.Tensor) -> np.ndarray:
    """uint32 tensor → numpy uint32 (through an int32 view)."""
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


def ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(a - b))) if a.size else 0


def inject_reference_draws(monkeypatch, key):
    """Make the port draw exactly what the reference draws from ``key``."""
    def word_projections(seed, word, n, device):
        r = jax.random.normal(jax.random.fold_in(key, word), (n, 32),
                              dtype=jnp.float32)
        return torch.from_numpy(np.array(r)).to(device)

    def permutation(seed, i, n, device):
        p = jax.random.permutation(jax.random.fold_in(key, i), n)
        return torch.from_numpy(np.array(p, np.int32)).to(device)

    def kpartition_permutation(seed, n, device):
        p = jax.random.permutation(key, n)
        return torch.from_numpy(np.array(p, np.int32)).to(device)

    monkeypatch.setattr(tl, "_word_projections", word_projections)
    monkeypatch.setattr(tl, "_permutation", permutation)
    monkeypatch.setattr(tl, "_kpartition_permutation",
                        kpartition_permutation)


def graphs(n, deg, seed, weighted=False):
    return (rg.random_graph(n, deg, seed=seed, weighted=weighted),
            tg.random_graph(n, deg, seed=seed, weighted=weighted,
                            device="cpu"))


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("samples", [64, 256, 600, 40])
def test_simhash_sketches_match_reference(monkeypatch, weighted, samples):
    key = jax.random.PRNGKey(13)
    inject_reference_draws(monkeypatch, key)
    gr, gt = graphs(60, 6.0, 31, weighted)
    want = np.asarray(rl.simhash_sketches(gr, samples, key))
    sk = tl.simhash_sketches(gt, samples, seed=0)
    np.testing.assert_array_equal(u32(sk), want)
    # Hamming distances bit-identical; σ̂ within 1 ULP at power-of-two k
    sim, diff = hamming_cosine_plain(sk, gt.edge_u, gt.nbrs, samples,
                                     return_diff=True)
    x = want[np.asarray(gr.edge_u)] ^ want[np.asarray(gr.nbrs)]
    np.testing.assert_array_equal(diff.numpy(),
                                  np.bitwise_count(x).sum(axis=1))
    ref_sim = np.asarray(rl.simhash_edge_similarity(
        jnp.asarray(want), gr.edge_u, gr.nbrs, samples))
    if samples & (samples - 1) == 0:
        assert ulps(sim.numpy(), ref_sim) <= 1
        np.testing.assert_array_equal(
            tl.simhash_edge_similarity(sk, gt.edge_u, gt.nbrs,
                                       samples).numpy(), sim.numpy())


def test_minhash_sketches_match_reference(monkeypatch):
    key = jax.random.PRNGKey(14)
    inject_reference_draws(monkeypatch, key)
    gr, gt = graphs(40, 5.0, 32)
    want = np.asarray(rl.minhash_sketches(gr, 100, key))
    got = tl.minhash_sketches(gt, 100, seed=0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tl.minhash_edge_similarity(got, gt.edge_u, gt.nbrs).numpy(),
        np.asarray(rl.minhash_edge_similarity(jnp.asarray(want), gr.edge_u,
                                              gr.nbrs)))


@pytest.mark.parametrize("samples", [128, 37])
def test_kpartition_sketches_match_reference(monkeypatch, samples):
    key = jax.random.PRNGKey(2)
    inject_reference_draws(monkeypatch, key)
    gr, gt = graphs(80, 10.0, 24)
    want = np.asarray(rl.kpartition_sketches(gr, samples, key))
    got = tl.kpartition_sketches(gt, samples, seed=0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tl.kpartition_edge_similarity(got, gt.edge_u, gt.nbrs).numpy(),
        np.asarray(rl.kpartition_edge_similarity(jnp.asarray(want),
                                                 gr.edge_u, gr.nbrs)))


def test_kpartition_raises_above_int32_encoding_limit():
    g = tg.random_graph(64, 2.0, device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        tl.kpartition_sketches(g, 2 ** 31 // 65 + 1)


# ------------------------------------------------------- the port's own RNG
def test_simhash_classification_bound():
    """Theorem 5.2: with k ≥ π²·ln(nm)/(2δ²), every edge with exact cosine
    outside (ε−δ, ε+√(1−ε²)δ) is classified correctly w.h.p."""
    g = tg.random_graph(60, 8.0, seed=21, device="cpu")
    eps, delta = 0.5, 0.25
    k = int(np.ceil(np.pi ** 2 * np.log(g.n * g.m) / (2 * delta ** 2)))
    exact = compute_similarities(g, "cosine").numpy()
    sk = tl.simhash_sketches(g, k, seed=0)
    approx = tl.simhash_edge_similarity(sk, g.edge_u, g.nbrs, k).numpy()
    lo, hi = eps - delta, eps + np.sqrt(1 - eps ** 2) * delta
    outside = (exact <= lo) | (exact >= hi)
    assert not (((exact >= eps) != (approx >= eps)) & outside).any()


def test_minhash_classification_bound():
    """Theorem 5.3: k ≥ ln(nm)/(2δ²) ⇒ edges outside (ε−δ, ε+δ) are
    classified correctly w.h.p."""
    g = tg.random_graph(60, 8.0, seed=22, device="cpu")
    eps, delta = 0.4, 0.2
    k = int(np.ceil(np.log(g.n * g.m) / (2 * delta ** 2)))
    exact = compute_similarities(g, "jaccard").numpy()
    sk = tl.minhash_sketches(g, k, seed=1)
    approx = tl.minhash_edge_similarity(sk, g.edge_u, g.nbrs).numpy()
    outside = (exact <= eps - delta) | (exact >= eps + delta)
    assert not (((exact >= eps) != (approx >= eps)) & outside).any()


def test_minhash_unbiased():
    g = tg.random_graph(30, 6.0, seed=23, device="cpu")
    exact = compute_similarities(g, "jaccard").numpy()
    ests = [tl.minhash_edge_similarity(tl.minhash_sketches(g, 128, 100 + t),
                                       g.edge_u, g.nbrs).numpy()
            for t in range(6)]
    assert np.max(np.abs(np.mean(ests, axis=0) - exact)) < 0.12


def test_kpartition_reasonable():
    g = tg.random_graph(80, 10.0, seed=24, device="cpu")
    exact = compute_similarities(g, "jaccard").numpy()
    sk = tl.kpartition_sketches(g, 128, seed=2)
    approx = tl.kpartition_edge_similarity(sk, g.edge_u, g.nbrs).numpy()
    assert np.mean(np.abs(approx - exact)) < 0.12


def test_approx_clustering_quality():
    """Clusterings from approximate σ recover the exact-σ clustering on a
    planted-partition graph (paper §7.3.4 ARI experiment, miniature)."""
    g = tg.random_graph(120, 10.0, seed=26, planted_clusters=5, device="cpu")
    exact = query(build_index(g, "cosine"), g, 3, 0.4)
    approx = query(build_index(g, "cosine", approx="simhash", samples=512,
                               seed=4), g, 3, 0.4)
    ari = adjusted_rand_index(exact.labels.numpy(), approx.labels.numpy())
    assert ari > 0.8, f"ARI {ari}"


def test_simhash_chunk_invariance():
    g = tg.random_graph(50, 6.0, seed=31, weighted=True, device="cpu")
    samples = 600
    ref = tl.simhash_sketches(g, samples, 13, chunk=512)
    for chunk in (64, 32, 640, None):
        assert torch.equal(tl.simhash_sketches(g, samples, 13, chunk=chunk)
                           .view(torch.int32), ref.view(torch.int32)), chunk
    with pytest.raises(ValueError, match="multiple of 32"):
        tl.simhash_sketches(g, samples, 13, chunk=48)


def test_minhash_chunk_invariance():
    g = tg.random_graph(40, 5.0, seed=32, device="cpu")
    ref = tl.minhash_sketches(g, 100, 14, chunk=64)
    for chunk in (7, 100, 256, None):
        assert torch.equal(tl.minhash_sketches(g, 100, 14, chunk=chunk),
                           ref), chunk


def test_sketches_deterministic_and_seeded():
    g = tg.random_graph(40, 5.0, seed=27, device="cpu")
    a = tl.simhash_sketches(g, 96, 9).view(torch.int32)
    assert torch.equal(a, tl.simhash_sketches(g, 96, 9).view(torch.int32))
    assert not torch.equal(a, tl.simhash_sketches(g, 96, 10)
                           .view(torch.int32))
    assert torch.equal(tl.kpartition_sketches(g, 64, 3),
                       tl.kpartition_sketches(g, 64, 3))


@pytest.mark.parametrize("method,samples,seed", [("simhash", 64, 3),
                                                 ("simhash", 17, 5),
                                                 ("minhash", 40, 1),
                                                 ("kpartition", 24, 8)])
def test_degree_heuristic_exact_on_low_degree_edges(method, samples, seed):
    """§6.3: every edge with a low-degree endpoint gets the exact engine's
    σ bit for bit, on the port's own draws."""
    g = tg.power_law_graph(200, seed=seed, device="cpu")
    measure = "cosine" if method == "simhash" else "jaccard"
    exact = compute_similarities(g, measure).numpy()
    approx = tl.approximate_similarities(
        g, measure=measure, method=method, samples=samples, seed=seed)
    low = tl.exact_edge_mask(g, measure, samples).numpy()
    assert low.any() and not low.all()
    np.testing.assert_array_equal(approx.numpy()[low], exact[low])
    assert float(approx.min()) >= 0.0 and float(approx.max()) <= 1.0


def test_approximate_similarities_rejects_bad_method_and_measure():
    g = tg.random_graph(20, 3.0, device="cpu")
    with pytest.raises(ValueError, match="cosine"):
        tl.approximate_similarities(g, measure="jaccard", method="simhash")
    with pytest.raises(ValueError, match="jaccard"):
        tl.approximate_similarities(g, measure="cosine", method="minhash")
    with pytest.raises(ValueError, match="unknown"):
        tl.approximate_similarities(g, method="bogus")
