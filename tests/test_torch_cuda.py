"""The port's CUDA kernels on the card, against their plain versions and
against the port's CPU lane (which the other ``test_torch_*`` files hold
against the JAX reference). Marked ``cuda``: they skip where no GPU is
present (decided inside the fixture, never at import time). The file
imports no JAX, so it runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import graph as tg
from repro_torch.core import similarity as ts
from repro_torch.kernels import _build, ops
from repro_torch.core import lsh as tl
from repro_torch.kernels.bucket_probe import bucket_probe, bucket_probe_plain
from repro_torch.kernels.hamming import (
    cosine_of_diff, hamming_cosine, hamming_cosine_plain, theta_of_diff,
)
from repro_torch.kernels.simhash import simhash_pack, simhash_pack_plain
from repro_torch.kernels.triangle_count import masked_gram, masked_gram_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def sorted_rows(rng, e, width, n):
    rows = np.full((e, width), n, np.int32)
    for i in range(e):
        k = int(rng.integers(0, min(width, n) + 1))
        rows[i, :k] = np.sort(rng.choice(n, size=k, replace=False))
    return rows


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("e,p,t", [(1, 8, 8), (333, 16, 64), (64, 64, 2048)])
def test_bucket_probe_kernel_vs_plain(cuda, e, p, t, weighted):
    rng = np.random.default_rng(e + p + t)
    n = 3000
    args = [torch.from_numpy(sorted_rows(rng, e, p, n)),
            torch.from_numpy(rng.uniform(0.1, 1, (e, p)).astype(np.float32)),
            torch.from_numpy(sorted_rows(rng, e, t, n)),
            torch.from_numpy(rng.uniform(0.1, 1, (e, t)).astype(np.float32))]
    if not weighted:
        args[1], args[3] = torch.ones_like(args[1]), torch.ones_like(args[3])
    args = [a.to(cuda) for a in args]
    before = _build.launch_counts()["bucket_probe"]
    dot, cnt = bucket_probe(*args, n)
    assert _build.launch_counts()["bucket_probe"] == before + 1
    pdot, pcnt = bucket_probe_plain(*args, n)
    assert torch.equal(cnt, pcnt)
    if weighted:
        torch.testing.assert_close(dot, pdot, rtol=1e-6, atol=0.0)
    else:
        assert torch.equal(dot, pdot)


@pytest.mark.parametrize("n", [1, 100, 256])
def test_masked_gram_kernel_vs_plain(cuda, n):
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    m = torch.from_numpy((rng.random((n, n)) < 0.2).astype(np.float32))
    got = masked_gram(w.to(cuda), m.to(cuda))
    torch.testing.assert_close(got, masked_gram_plain(w.to(cuda), m.to(cuda)),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("measure", ["cosine", "jaccard"])
def test_sigma_on_card_matches_cpu_lane(cuda, measure):
    g_cpu = tg.power_law_graph(300, 2.1, seed=3, hub_degree=120,
                               device="cpu")
    gt = tg.power_law_graph(300, 2.1, seed=3, hub_degree=120, device=cuda)
    got = ts.compute_similarities(gt, measure)
    assert torch.equal(got.cpu(), ts.compute_similarities(g_cpu, measure))
    assert torch.equal(got, ts.compute_similarities(gt, measure, lane="ref"))
    assert torch.equal(got, ops.edge_similarities_gram(gt, measure))


def test_forced_hub_tiling_on_card(cuda):
    g = tg.hub_ring_graph(80, 60, device=cuda)
    plan = ts.plan_for(g, hub_tile=16)
    assert int(plan.vtiles.max()) > 1
    got = plan.edge_sims(g.edge_u, g.nbrs, g.wgts, "cosine")
    assert torch.equal(got, plan.edge_sims(g.edge_u, g.nbrs, g.wgts,
                                           "cosine", lane="ref"))


def test_weighted_norms_bit_stable_on_card(cuda):
    g = tg.random_graph(5000, 10.0, seed=4, weighted=True, device=cuda)
    assert torch.equal(ts.closed_norms(g), ts.closed_norms(g))
    a = ts.compute_similarities(g)
    assert torch.equal(a, ts.compute_similarities(g))


def f32_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    a = a.view(torch.int32).long()
    b = b.view(torch.int32).long()
    return int((a - b).abs().max()) if a.numel() else 0


@pytest.mark.parametrize("words,samples", [(1, 32), (3, 96), (4, 128),
                                           (8, 256), (8, 250), (32, 1024)])
def test_hamming_cosine_kernel_vs_plain(cuda, words, samples):
    """σ̂ bit-identical (same IEEE ops, same cosf), so diff identical too
    (its samples + 1 levels of σ̂ are distinct); σ̂ within 2 ULP of the
    float64 cosine of the same float32 θ̂ (cosf's bound)."""
    gen = torch.Generator(device=cuda).manual_seed(words)
    n, e = 5000, 70001
    sk = torch.randint(-2 ** 31, 2 ** 31, (n, words), generator=gen,
                       device=cuda, dtype=torch.int64).to(torch.int32)
    sk = sk.view(torch.uint32)
    eu = torch.randint(0, n, (e,), generator=gen, device=cuda,
                       dtype=torch.int32)
    ev = torch.randint(0, n, (e,), generator=gen, device=cuda,
                       dtype=torch.int32)
    before = _build.launch_counts()["hamming_cosine"]
    sim = hamming_cosine(sk, eu, ev, samples)
    assert _build.launch_counts()["hamming_cosine"] == before + 1
    psim, pdiff = hamming_cosine_plain(sk, eu, ev, samples, return_diff=True)
    levels = cosine_of_diff(torch.arange(samples + 1, device=cuda,
                                         dtype=torch.int32), samples)
    assert levels.unique().numel() == samples + 1
    assert torch.equal(sim.view(torch.int32), psim.view(torch.int32))
    exact = torch.cos(theta_of_diff(pdiff, samples).double()).float()
    assert f32_ulps(sim, exact) <= 2
    assert torch.equal(hamming_cosine(sk, eu, ev, samples), sim)


@pytest.mark.parametrize("n,k", [(1, 32), (100, 96), (256, 256),
                                 (300, 384)])
def test_simhash_pack_kernel_vs_plain_on_exact_inputs(cuda, n, k):
    """0/1 W and R on a 2⁻⁸ grid in [−4, 4]: every partial sum is exact,
    so the words are bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    w = (torch.rand((n, n), generator=gen, device=cuda) < 0.1).float()
    w += torch.eye(n, device=cuda)
    r = torch.randint(-1024, 1025, (n, k), generator=gen, device=cuda) / 256
    got = simhash_pack(w, r.float())
    assert got.shape == (n, k // 32)
    assert torch.equal(got.view(torch.int32),
                       simhash_pack_plain(w, r.float()).view(torch.int32))


def test_simhash_pack_kernel_vs_plain_outside_error_bound(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    n, k = 512, 256
    w = torch.rand((n, n), generator=gen, device=cuda) * \
        (torch.rand((n, n), generator=gen, device=cuda) < 0.05)
    r = torch.randn((n, k), generator=gen, device=cuda)
    got = simhash_pack(w, r).view(torch.int32)
    want = simhash_pack_plain(w, r).view(torch.int32)
    s = w.double() @ r.double()
    bound = n * 2.0 ** -24 * (w.double().abs() @ r.double().abs())
    shifts = torch.arange(32, device=cuda)
    bit = lambda x: ((x.long()[:, :, None] >> shifts) & 1).reshape(n, k)
    safe = s.abs() > bound
    assert torch.equal(bit(got)[safe], bit(want)[safe])


@pytest.mark.parametrize("weighted", [False, True])
def test_sketches_bit_stable_on_card(cuda, weighted):
    g = tg.power_law_graph(3000, 2.1, seed=5, weighted=weighted,
                           device=cuda)
    a = tl.simhash_sketches(g, 256, 3).view(torch.int32)
    assert torch.equal(a, tl.simhash_sketches(g, 256, 3).view(torch.int32))
    assert torch.equal(a, tl.simhash_sketches(g, 256, 3, chunk=32)
                       .view(torch.int32))
    assert torch.equal(tl.minhash_sketches(g, 64, 3),
                       tl.minhash_sketches(g, 64, 3, chunk=7))


def test_approximate_similarities_on_card(cuda):
    g = tg.power_law_graph(3000, 2.1, seed=6, hub_degree=600, device=cuda)
    before = _build.launch_counts()
    got = tl.approximate_similarities(g, samples=64, seed=1)
    after = _build.launch_counts()
    assert after["hamming_cosine"] == before["hamming_cosine"] + 1
    assert after["bucket_probe"] > before["bucket_probe"]
    ref = tl.approximate_similarities(g, samples=64, seed=1, lane="ref")
    assert torch.equal(got, ref)
    low = tl.exact_edge_mask(g, "cosine", 64)
    assert torch.equal(got[low], ts.compute_similarities(g)[low])
