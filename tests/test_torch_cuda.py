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
from repro_torch.kernels.bucket_probe import bucket_probe, bucket_probe_plain
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
