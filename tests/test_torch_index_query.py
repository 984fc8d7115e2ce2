"""Port index, queries, sweeps, fingerprint and CLI vs the reference.

Index parity feeds the reference's σ into the port (``sims=``), so the NO
and CO orders are compared on identical keys; every array must then match
bit for bit, as must labels, core masks, cluster counts and sweep rows."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core import build_index as ref_build_index
from repro.core import co_core_prefix as ref_co_core_prefix
from repro.core import graph as rg
from repro.core import hubs_outliers as ref_hubs_outliers
from repro.core import query as ref_query
from repro.core import query_batch as ref_query_batch
from repro.core import quality as rq
from repro.core.connectivity import connected_components as ref_cc
from repro.core.scan_ref import scan_ref as ref_scan_ref
from repro.serve import index_fingerprint as ref_fingerprint
from repro.serve import sweep_stats as ref_sweep_stats
from repro_torch import interop
from repro_torch.core import graph as tg
from repro_torch.core import quality as tq
from repro_torch.core.connectivity import connected_components
from repro_torch.core.index import build_index, co_core_prefix
from repro_torch.core.query import hubs_outliers, query, query_batch
from repro_torch.core.scan_ref import scan_ref
from repro_torch.serve import index_fingerprint, sweep_stats

ROOT = Path(__file__).resolve().parents[1]


CPU = {"device": "cpu"}

GRAPHS = [
    ("random_graph", (120, 6.0), dict(seed=1), "cosine"),
    ("random_graph", (100, 8.0), dict(seed=2, planted_clusters=5), "jaccard"),
    ("random_graph", (90, 6.0), dict(seed=3, weighted=True), "cosine"),
    ("power_law_graph", (150, 2.1), dict(seed=4, hub_degree=64), "cosine"),
]
IDS = ["random-cos", "planted-jac", "weighted-cos", "powerlaw-cos"]


def pair(fn, args, kw):
    return getattr(rg, fn)(*args, **kw), getattr(tg, fn)(*args, **kw, **CPU)


def ref_index_arrays(index):
    return {f: np.asarray(getattr(index, f)) for f in interop.INDEX_FIELDS}


@pytest.fixture(scope="module", params=GRAPHS, ids=IDS)
def built(request):
    """(reference graph, reference index, port graph, port index built
    from the reference's σ)."""
    fn, args, kw, measure = request.param
    gr, gt = pair(fn, args, kw)
    ir = ref_build_index(gr, measure)
    it = build_index(gt, measure, sims=np.asarray(ir.edge_sims))
    return gr, ir, gt, it


def test_index_arrays_bit_identical(built):
    gr, ir, gt, it = built
    want = ref_index_arrays(ir)
    got = interop.index_to_arrays(it)
    for f in interop.INDEX_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        assert got[f].tobytes() == want[f].tobytes(), f
    assert (it.n, it.m2c, it.max_cdeg) == (ir.n, ir.m2c, ir.max_cdeg)


def test_port_sigma_index_bit_identical_unweighted():
    gr, gt = pair("power_law_graph", (150, 2.1), dict(seed=4, hub_degree=64))
    want = ref_index_arrays(ref_build_index(gr, "cosine"))
    got = interop.index_to_arrays(build_index(gt, "cosine"))
    for f in interop.INDEX_FIELDS:
        assert got[f].tobytes() == want[f].tobytes(), f


def test_interop_index_round_trip(built):
    _, ir, _, it = built
    back = interop.index_from_arrays(ref_index_arrays(ir), **CPU)
    assert (back.n, back.m2c, back.max_cdeg) == (it.n, it.m2c, it.max_cdeg)
    for f in interop.INDEX_FIELDS:
        assert torch.equal(getattr(back, f), getattr(it, f)), f


def grid(index):
    mus = [0, 1, 2, 3, 5, index.max_cdeg, index.max_cdeg + 1]
    epss = [0.0, 0.2, 0.35, 0.5, 0.7, 1.0]
    mu_g, eps_g = np.meshgrid(np.asarray(mus, np.int32),
                              np.asarray(epss, np.float32), indexing="ij")
    return mu_g.reshape(-1), eps_g.reshape(-1)


def test_core_prefix_and_threshold(built):
    _, ir, _, it = built
    mus, epss = grid(it)
    for mu, eps in zip(mus[::3], epss[::3]):
        lo, end = co_core_prefix(it, int(mu), float(eps))
        rlo, rend = ref_co_core_prefix(ir, mu, eps)
        assert (lo, end) == (int(rlo), int(rend))
    for mu in (1, 2, 4, it.max_cdeg + 1):
        np.testing.assert_array_equal(it.core_threshold(mu).numpy(),
                                      np.asarray(ir.core_threshold(mu)))


def test_query_batch_bit_identical(built):
    gr, ir, gt, it = built
    mus, epss = grid(it)
    want = ref_query_batch(ir, gr, mus, epss)
    got = query_batch(it, gt, mus, epss)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.is_core.numpy(),
                                  np.asarray(want.is_core))
    np.testing.assert_array_equal(got.n_clusters.numpy(),
                                  np.asarray(want.n_clusters))
    for i in range(len(mus)):
        hub, out = hubs_outliers(gt, got.labels[i])
        rhub, rout = ref_hubs_outliers(gr, want.labels[i])
        np.testing.assert_array_equal(hub.numpy(), np.asarray(rhub))
        np.testing.assert_array_equal(out.numpy(), np.asarray(rout))


def test_query_groups_do_not_change_results(built, monkeypatch):
    _, _, gt, it = built
    mus, epss = grid(it)
    whole = query_batch(it, gt, mus, epss)
    q_mod = sys.modules["repro_torch.core.query"]
    monkeypatch.setattr(q_mod, "QUERY_GROUP_BYTES", 1)   # one setting a group
    split = query_batch(it, gt, mus, epss)
    assert torch.equal(whole.labels, split.labels)
    assert torch.equal(whole.n_clusters, split.n_clusters)


@pytest.mark.parametrize("mu,eps", [(2, 0.3), (3, 0.5), (4, 0.0), (2, 1.0)])
def test_single_query_and_scan_ref(built, mu, eps):
    gr, ir, gt, it = built
    got = query(it, gt, mu, eps)
    want = ref_query(ir, gr, mu, eps)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.n_clusters) == int(want.n_clusters)
    sims = np.asarray(ir.edge_sims)
    oracle = scan_ref(gt, mu, eps, sims=sims)
    ref_oracle = ref_scan_ref(gr, mu, eps, sims=sims)
    for key in ("labels", "is_core", "is_hub", "is_outlier"):
        np.testing.assert_array_equal(oracle[key], ref_oracle[key])
    np.testing.assert_array_equal(got.labels.numpy(), oracle["labels"])
    np.testing.assert_array_equal(got.is_core.numpy(), oracle["is_core"])


def test_sweep_stats_rows_equal(built):
    gr, ir, gt, it = built
    mus, epss = [2, 3, 5], [0.2, 0.4, 0.6]
    assert sweep_stats(it, gt, mus, epss) == \
        ref_sweep_stats(ir, gr, mus, epss)


def test_fingerprint_equal(built):
    gr, ir, gt, it = built
    assert index_fingerprint(it, gt) == ref_fingerprint(ir, gr)


@pytest.mark.parametrize("weighted", [False, True])
def test_quality_measures(weighted):
    gr, gt = pair("random_graph", (100, 8.0),
                  dict(seed=2, planted_clusters=5, weighted=True))
    labels = np.asarray(ref_query(ref_build_index(gr), gr, 2, 0.3).labels)
    assert tq.modularity(gt, labels, weighted) == \
        rq.modularity(gr, labels, weighted)
    other = np.where(labels % 3 == 0, -1, labels)
    assert tq.adjusted_rand_index(labels, other) == \
        rq.adjusted_rand_index(labels, other)
    assert tq.core_precision_recall(labels >= 0, other >= 0) == \
        rq.core_precision_recall(labels >= 0, other >= 0)


def test_connected_components_matches_reference():
    rng = np.random.default_rng(13)
    n, e = 200, 600
    eu = rng.integers(0, n, e).astype(np.int32)
    ev = rng.integers(0, n, e).astype(np.int32)
    em = rng.random(e) < 0.5
    vm = rng.random(n) < 0.8
    got = connected_components(n, torch.from_numpy(eu), torch.from_numpy(ev),
                               torch.from_numpy(em), torch.from_numpy(vm))
    want = ref_cc(n, eu, ev, em, vm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def table_rows(text):
    return [ln for ln in text.splitlines()
            if re.match(r"^\s+\d+\s+\d\.\d\d\s", ln)]


def test_cli_sweep_prints_reference_rows():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    args = ["sweep", "--n", "512"]
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.scan_serve", *args,
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert port.returncode == 0, port.stderr
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.scan_serve", *args], env=env,
        capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    rows = table_rows(port.stdout)
    assert len(rows) == 27 and rows == table_rows(ref.stdout)
    fp = re.compile(r"fingerprint=([0-9a-f]{12})")
    assert fp.search(port.stdout).group(1) == fp.search(ref.stdout).group(1)
