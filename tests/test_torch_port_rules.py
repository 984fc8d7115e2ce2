"""Rules of the PyTorch port: no JAX and nothing of ``repro`` inside it,
CUDA by default with no silent CPU fallback, kernels that raise instead of
falling back, and lanes that follow the operand's device."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (test files import both packages; JAX stays on CPU)
import numpy as np
import pytest
import torch

from repro.backend.profile import AutotuneProfile as RefProfile
from repro_torch import interop
from repro_torch.backend import (
    LANE_HOPPER, LANE_REF, AutotuneProfile, ExecutionPolicy,
)
from repro_torch.core import graph as tg
from repro_torch.kernels import _build, ops
from repro_torch.kernels.bucket_probe import bucket_probe, bucket_probe_plain
from repro_torch.kernels.hamming import hamming_cosine, hamming_cosine_plain
from repro_torch.kernels.simhash import simhash_pack, simhash_pack_plain
from repro_torch.kernels.triangle_count import masked_gram, masked_gram_plain
from repro_torch.launch import scan_serve

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PKG = SRC / "repro_torch"

_IMPORT_CHECK = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20       # every module imported


_BANNED = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_never_imports_jax_or_reference(path):
    assert not _BANNED.findall(path.read_text())


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    lambda: tg.random_graph(16, 2.0),
    lambda: tg.power_law_graph(32, avg_degree=2.0),
    lambda: tg.hub_ring_graph(16, 5),
    lambda: tg.from_edge_list(4, [(0, 1), (1, 2)]),
    lambda: tg.graph_from_dense(np.ones((3, 3))),
    lambda: interop.graph_from_arrays(interop.graph_to_arrays(
        tg.from_edge_list(3, [(0, 1)], device="cpu"))),
    lambda: scan_serve.main(["sweep", "--n", "16"]),
    lambda: scan_serve.main(["sweep", "--n", "16", "--approx", "simhash:32"]),
], ids=["random_graph", "power_law_graph", "hub_ring_graph",
        "from_edge_list", "graph_from_dense", "graph_from_arrays", "cli",
        "cli-approx"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, make):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_cpu_opt_in_runs():
    g = tg.random_graph(16, 2.0, device="cpu")
    assert g.device.type == "cpu" and g.nbrs.dtype == torch.int32


def test_kernel_build_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build.build()
    with pytest.raises(RuntimeError):
        _build.function("bucket_probe", "bucket_probe_launch", [])


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["masked_gram"])


def test_wrappers_on_cpu_tensors_use_plain_version_and_count_nothing():
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.sort(rng.choice(50, (4, 8), replace=False)
                                   .reshape(4, 8), axis=1).astype(np.int32))
    w = torch.ones((4, 8))
    before = _build.launch_counts()
    d1, c1 = bucket_probe(ids, w, ids, w, 50)
    d2, c2 = bucket_probe_plain(ids, w, ids, w, 50)
    assert torch.equal(d1, d2) and torch.equal(c1, c2)
    a = torch.from_numpy(rng.standard_normal((5, 5)).astype(np.float32))
    m = torch.ones((5, 5))
    assert torch.equal(masked_gram(a, m), masked_gram_plain(a, m))
    sk = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (6, 2),
                                       dtype=np.int64).astype(np.int32))
    sk = sk.view(torch.uint32)
    eu = torch.tensor([0, 1, 5], dtype=torch.int32)
    ev = torch.tensor([2, 1, 3], dtype=torch.int32)
    assert torch.equal(hamming_cosine(sk, eu, ev, 64),
                       hamming_cosine_plain(sk, eu, ev, 64))
    r = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    assert torch.equal(simhash_pack(a, r).view(torch.int32),
                       simhash_pack_plain(a, r).view(torch.int32))
    assert _build.launch_counts() == before


def test_wrappers_reject_bad_operands():
    ids = torch.zeros((4, 8), dtype=torch.int64)
    w = torch.ones((4, 8))
    with pytest.raises(TypeError):
        bucket_probe(ids, w, ids, w, 10)
    with pytest.raises(ValueError):
        masked_gram(torch.ones((3, 4)), torch.ones((3, 4)))
    sk = torch.zeros((4, 2), dtype=torch.int32)
    e = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        hamming_cosine(sk, e, e, 64)                 # sketches not uint32
    with pytest.raises(TypeError):
        hamming_cosine(sk.view(torch.uint32), e.long(), e.long(), 64)
    with pytest.raises(ValueError):
        simhash_pack(torch.ones((4, 4)), torch.ones((4, 40)))   # k % 32


def test_policy_lane_follows_device():
    pol = ExecutionPolicy()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert pol.lane("bucket_probe", cpu) == LANE_REF
    assert pol.lane("triangle_count", cpu) == LANE_REF
    assert pol.lane("bucket_probe", cuda) == LANE_HOPPER
    assert pol.lane("bucket_probe", cuda, forced="ref") == LANE_REF
    assert pol.lane("query", cuda) == LANE_REF          # no kernel: clamps
    assert pol.lane("query", cuda, forced="hopper") == LANE_REF
    with pytest.raises(ValueError):
        pol.lane("bucket_probe", cpu, forced="hopper")  # no silent fallback
    with pytest.raises(ValueError):
        pol.lane("bucket_probe", cpu, forced="pallas-compiled")
    for op in ("simhash", "hamming"):
        assert pol.lane(op, cpu) == LANE_REF
        assert pol.lane(op, cuda) == LANE_HOPPER
        with pytest.raises(ValueError):
            pol.lane(op, cpu, forced="hopper")
    pol.note("bucket_probe", LANE_REF, 3)
    assert pol.counts == {"bucket_probe.ref": 3}


def test_forced_hopper_on_cpu_tensors_raises_in_the_wrappers():
    g = tg.random_graph(16, 3.0, device="cpu")
    with pytest.raises(ValueError, match="hopper"):
        ops.simhash_sketches_kernel(g, 32, lane="hopper")
    sk = ops.simhash_sketches_kernel(g, 32)
    with pytest.raises(ValueError, match="hopper"):
        ops.simhash_edge_similarity_kernel(sk, g.edge_u, g.nbrs, 32,
                                           lane="hopper")


def test_profile_matches_reference_defaults_and_round_trips():
    assert AutotuneProfile().to_json() == RefProfile().to_json()
    tuned = AutotuneProfile(hub_tile=512, platform="h100")
    assert AutotuneProfile.from_json(tuned.to_json()) == tuned
    assert RefProfile.from_json(tuned.to_json()).hub_tile == 512
