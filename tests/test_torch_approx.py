"""The port's approximate-index path (``approximate_similarities``,
``ApproxIndexBuilder``, provenance, interop, CLI) against the JAX
reference, and its clustering quality on the port's own generators.

Parity runs with the reference's draws injected (see
``tests/test_torch_lsh.py``): §6.3's exact edges equal the reference's
bit for bit (weighted within ``rtol=2e-5``), sketched σ̂ within 1 ULP, and
an index built from the reference's σ̂ equals the reference's index array
for array. The quality grids mirror ``tests/test_approx_quality.py`` with
its floors.
"""
import contextlib
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import approx as ra
from repro.core import build_index as ref_build_index
from repro.core import graph as rg
from repro.core import lsh as rl
from repro_torch import interop
from repro_torch.core import approx as ta
from repro_torch.core import graph as tg
from repro_torch.core import lsh as tl
from repro_torch.core.index import build_index
from repro_torch.core.quality import (adjusted_rand_index,
                                      core_precision_recall)
from repro_torch.core.query import query_batch
from repro_torch.serve import index_fingerprint
from test_torch_lsh import inject_reference_draws, ulps

ROOT = Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}

CASES = [
    ("power_law_graph", (200, 2.1), dict(seed=5, hub_degree=90), "cosine",
     "simhash", 64),
    ("power_law_graph", (200, 2.1), dict(seed=6, hub_degree=90,
                                         weighted=True), "cosine",
     "simhash", 64),
    ("hub_ring_graph", (120, 70), dict(seed=3), "cosine", "simhash", 32),
    ("power_law_graph", (200, 2.1), dict(seed=7, hub_degree=90), "jaccard",
     "minhash", 40),
    ("power_law_graph", (200, 2.1), dict(seed=8, hub_degree=90), "jaccard",
     "kpartition", 40),
]
IDS = ["simhash", "simhash-weighted", "simhash-hubring", "minhash",
       "kpartition"]


def pair(fn, args, kw):
    return getattr(rg, fn)(*args, **kw), getattr(tg, fn)(*args, **kw, **CPU)


@pytest.mark.parametrize("heuristic", [True, False])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_approximate_similarities_match_reference(monkeypatch, case,
                                                  heuristic):
    fn, args, kw, measure, method, samples = case
    key = jax.random.PRNGKey(11)
    inject_reference_draws(monkeypatch, key)
    gr, gt = pair(fn, args, kw)
    want = np.asarray(rl.approximate_similarities(
        gr, measure=measure, method=method, samples=samples, key=key,
        degree_heuristic=heuristic))
    got = tl.approximate_similarities(
        gt, measure=measure, method=method, samples=samples,
        degree_heuristic=heuristic).numpy()
    exact = (tl.exact_edge_mask(gt, measure, samples).numpy() if heuristic
             else np.zeros(gt.m2, bool))
    assert heuristic is False or exact.any()
    if kw.get("weighted"):
        np.testing.assert_allclose(got[exact], want[exact], rtol=2e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(got[exact], want[exact])
    if method == "simhash":
        assert ulps(got[~exact], want[~exact]) <= 1
    else:
        np.testing.assert_array_equal(got[~exact], want[~exact])


@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_index_from_reference_sigma_hat_bit_identical(case):
    fn, args, kw, measure, method, samples = case
    gr, gt = pair(fn, args, kw)
    ir = ref_build_index(gr, measure, approx=method, samples=samples,
                         key=jax.random.PRNGKey(4))
    it = build_index(gt, measure, sims=np.asarray(ir.edge_sims))
    got = interop.index_to_arrays(it)
    for f in interop.INDEX_FIELDS:
        assert got[f].tobytes() == np.asarray(getattr(ir, f)).tobytes(), f
    assert (it.n, it.m2c, it.max_cdeg) == (ir.n, ir.m2c, ir.max_cdeg)


def test_reference_approx_index_and_provenance_cross_over():
    gr, gt = pair("power_law_graph", (200, 2.1), dict(seed=5, hub_degree=90))
    ir, prov = ra.build_approx_index(gr, samples=64, seed=3)
    arrays = {f: np.asarray(getattr(ir, f)) for f in interop.INDEX_FIELDS}
    arrays["provenance"] = np.frombuffer(prov.to_json().encode(), np.uint8)
    it = interop.index_from_arrays(arrays, **CPU)
    got_prov = interop.provenance_from_arrays(arrays)
    assert got_prov == ta.IndexProvenance.for_params(
        ta.ApproxParams(samples=64, seed=3))
    assert got_prov.describe() == prov.describe()
    back = interop.index_to_arrays(it, got_prov)
    for f in interop.INDEX_FIELDS:
        assert back[f].tobytes() == arrays[f].tobytes(), f
    assert back["provenance"].tobytes() == arrays["provenance"].tobytes()
    assert interop.provenance_from_arrays(
        interop.index_to_arrays(it)) == ta.EXACT_PROVENANCE
    from repro.serve import index_fingerprint as ref_fingerprint
    assert index_fingerprint(it, gt) == ref_fingerprint(ir, gr)


@pytest.mark.parametrize("spec", ["simhash", "simhash:256", "minhash:128:7",
                                  "kpartition:64:-2"])
def test_params_parse_spec_and_provenance_json_match_reference(spec):
    got, want = ta.ApproxParams.parse(spec), ra.ApproxParams.parse(spec)
    assert got.spec() == want.spec() and got.measure == want.measure
    for p in (ta.IndexProvenance.for_params(got),
              ta.IndexProvenance.for_params(
                  ta.ApproxParams(got.method, got.samples, got.seed, False)),
              ta.EXACT_PROVENANCE):
        rp = ra.IndexProvenance.from_json(p.to_json())
        assert rp.to_json() == p.to_json()
        assert rp.describe() == p.describe()
        assert ta.IndexProvenance.from_json(rp.to_json()) == p
    assert ta.EXACT_PROVENANCE.to_json() == ra.EXACT_PROVENANCE.to_json()


@pytest.mark.parametrize("spec", ["", "bogus:4", "simhash:x", "simhash:0",
                                  "simhash:1:2:3"])
def test_params_reject_bad_specs(spec):
    with pytest.raises(ValueError):
        ta.ApproxParams.parse(spec)
    with pytest.raises(ValueError):
        ra.ApproxParams.parse(spec)


def test_builder_measure_mismatch_and_tracer_spans():
    with pytest.raises(ValueError, match="estimates"):
        ta.ApproxIndexBuilder("jaccard", ta.ApproxParams("simhash"))

    class Tracer:
        def __init__(self):
            self.names = []

        def span(self, name, **attrs):
            self.names.append(name)
            return contextlib.nullcontext()

    g = tg.power_law_graph(200, seed=5, hub_degree=90, **CPU)
    tracer = Tracer()
    index, prov = ta.ApproxIndexBuilder(
        "cosine", ta.ApproxParams(samples=64)).build(g, tracer=tracer)
    assert tracer.names == ["index.approx_build", "lsh.sketch",
                            "lsh.compare", "lsh.exact", "index.orders"]
    plain, _ = ta.build_approx_index(g, samples=64)
    assert torch.equal(index.edge_sims, plain.edge_sims)
    assert prov.describe() == "approx(simhash, k=64, seed=0+degree-heuristic)"
    assert torch.equal(build_index(g, approx="simhash", samples=64).edge_sims,
                       plain.edge_sims)


# ------------------------------------------------------ quality (own RNG)
MUS = (2, 3, 4)
EPSS = (0.2, 0.35, 0.5, 0.65, 0.8)
# the reference's floors were set on one draw of its RNG (its seed 0), and
# at k=64 single draws of either RNG scatter around them on power_law, so
# the port's heuristic grid holds the floors on the mean over 20 draws
HEURISTIC_SEEDS = range(20)


def grid_results(index, g):
    mu, eps = np.meshgrid(np.asarray(MUS, np.int32),
                          np.asarray(EPSS, np.float32), indexing="ij")
    res = query_batch(index, g, mu.reshape(-1), eps.reshape(-1))
    return res.labels.numpy(), res.is_core.numpy()


def grid_quality(exact, approx):
    """(mean ARI, share of settings with ARI ≥ 0.8, mean core precision,
    mean core recall) of the approximate grid against the exact one."""
    (lab_e, core_e), (lab_a, core_a) = exact, approx
    aris = np.asarray([adjusted_rand_index(e, a)
                       for e, a in zip(lab_e, lab_a)])
    pr = np.asarray([core_precision_recall(a, e)
                     for e, a in zip(core_e, core_a)])
    return (float(aris.mean()), float(np.mean(aris >= 0.8)),
            float(pr[:, 0].mean()), float(pr[:, 1].mean()))


def quality_graphs():
    return (("power_law", tg.power_law_graph(400, seed=2, hub_degree=120,
                                             **CPU)),
            ("hub_ring", tg.hub_ring_graph(150, 80, seed=3, **CPU)))


def test_quality_grid_with_degree_heuristic():
    floors = {"power_law": (0.80, 0.60, 0.80, 0.90),
              "hub_ring": (0.95, 0.90, 0.95, 0.95)}
    for name, g in quality_graphs():
        exact = grid_results(build_index(g, "cosine"), g)
        draws = []
        for seed in HEURISTIC_SEEDS:
            idx_a, prov = ta.build_approx_index(g, samples=64, seed=seed)
            assert prov.is_approx and prov.samples == 64
            draws.append(grid_quality(exact, grid_results(idx_a, g)))
        got = np.mean(draws, axis=0)
        for value, floor in zip(got, floors[name]):
            assert value >= floor, (name, got)


def test_quality_grid_pure_sketch():
    floors = {"power_law": (0.55, 0.65, 0.90),
              "hub_ring": (0.70, 0.75, 0.90)}
    for name, g in quality_graphs():
        idx_a, _ = ta.build_approx_index(g, samples=1024, seed=0,
                                         degree_heuristic=False)
        ari, _, prec, rec = grid_quality(
            grid_results(build_index(g, "cosine"), g), grid_results(idx_a, g))
        for value, floor in zip((ari, prec, rec), floors[name]):
            assert value >= floor, (name, ari, prec, rec)


def test_cli_sweep_approx():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.scan_serve", "sweep",
         "--device", "cpu", "--approx", "simhash:64", "--n", "512"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"built approx\(simhash, k=64, seed=0\+degree-heuristic"
                     r"\) index in [0-9.]+s \(n=512, ", out.stdout)
    rows = [ln for ln in out.stdout.splitlines()
            if re.match(r"^\s+\d+\s+\d\.\d\d\s", ln)]
    assert len(rows) == 27
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.scan_serve", "sweep",
         "--device", "cpu", "--approx", "minhash:64", "--n", "64"],
        env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "estimates" in bad.stderr
