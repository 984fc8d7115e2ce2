"""Approximate-first index construction with provenance (port of
``repro.core.approx``; paper §5–§6.3).

Sketch every closed neighborhood once, estimate σ per edge by sketch
comparison, and fall back to exact σ only on edges with a low-degree
endpoint (§6.3). The resulting :class:`~repro_torch.core.index.ScanIndex`
is queryable at once and provably close (Theorems 5.2/5.3).

An approximate index is content-wise a different artifact from the exact
index of the same graph (its ``edge_sims`` differ, so its fingerprint
differs), so every build carries an :class:`IndexProvenance` tag: exact vs
approx, sketch method, sample count, sketch seed. Its JSON is the
reference's, byte for byte, so a tag written by either package reads in
the other. The port's sketches come from its own generators
(:mod:`repro_torch.core.lsh`), so the same params give a different
approximate index in each package (and on each device type).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import torch

from repro_torch.core.graph import CSRGraph
from repro_torch.core.index import ScanIndex, build_index
from repro_torch.core.lsh import approximate_similarities, trace_span

#: methods and the similarity measure each one estimates
_METHOD_MEASURE = {
    "simhash": "cosine",
    "minhash": "jaccard",
    "kpartition": "jaccard",
}


@dataclasses.dataclass(frozen=True)
class ApproxParams:
    """Sketch configuration for one approximate build. ``seed`` pins the
    projections / permutations, so two builds with identical params on one
    device type give bit-identical sketches, σ̂ and fingerprints."""

    method: str = "simhash"       # simhash | minhash | kpartition
    samples: int = 256
    seed: int = 0
    degree_heuristic: bool = True

    def __post_init__(self):
        if self.method not in _METHOD_MEASURE:
            raise ValueError(
                f"unknown LSH method {self.method!r}; "
                f"expected one of {sorted(_METHOD_MEASURE)}")
        if self.samples <= 0:
            raise ValueError(f"samples must be positive, got {self.samples}")

    @property
    def measure(self) -> str:
        """The similarity measure this sketch method estimates."""
        return _METHOD_MEASURE[self.method]

    @classmethod
    def parse(cls, spec: str) -> "ApproxParams":
        """Parse the CLI form ``method[:samples[:seed]]``
        (``"simhash:256"``, ``"minhash:128:7"``)."""
        parts = spec.split(":")
        if not 1 <= len(parts) <= 3 or not parts[0]:
            raise ValueError(
                f"bad approx spec {spec!r}; expected method[:samples[:seed]]")
        method = parts[0]
        try:
            samples = int(parts[1]) if len(parts) > 1 else 256
            seed = int(parts[2]) if len(parts) > 2 else 0
        except ValueError:
            raise ValueError(
                f"bad approx spec {spec!r}; samples/seed must be integers"
            ) from None
        return cls(method=method, samples=samples, seed=seed)

    def spec(self) -> str:
        return f"{self.method}:{self.samples}:{self.seed}"


@dataclasses.dataclass(frozen=True)
class IndexProvenance:
    """How an index's ``edge_sims`` were produced; the default instance
    (:data:`EXACT_PROVENANCE`) names an exact build."""

    kind: str = "exact"                # "exact" | "approx"
    method: Optional[str] = None
    samples: int = 0
    seed: int = 0
    degree_heuristic: bool = True

    @property
    def is_approx(self) -> bool:
        return self.kind == "approx"

    def describe(self) -> str:
        if not self.is_approx:
            return "exact"
        dh = "+degree-heuristic" if self.degree_heuristic else ""
        return f"approx({self.method}, k={self.samples}, seed={self.seed}{dh})"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "IndexProvenance":
        data = json.loads(payload)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    @classmethod
    def for_params(cls, params: ApproxParams) -> "IndexProvenance":
        return cls(kind="approx", method=params.method,
                   samples=params.samples, seed=params.seed,
                   degree_heuristic=params.degree_heuristic)


EXACT_PROVENANCE = IndexProvenance()


class ApproxIndexBuilder:
    """Build a queryable :class:`ScanIndex` from LSH-sketched similarities.
    ``measure`` must match what ``params.method`` estimates (simhash →
    cosine, minhash/kpartition → jaccard); a mismatch raises here."""

    def __init__(self, measure: str = "cosine",
                 params: ApproxParams = ApproxParams()):
        if params.measure != measure:
            raise ValueError(
                f"method {params.method!r} estimates {params.measure!r} "
                f"similarity, not {measure!r}")
        self.measure = measure
        self.params = params

    @property
    def provenance(self) -> IndexProvenance:
        return IndexProvenance.for_params(self.params)

    def similarities(self, g: CSRGraph, *, tracer=None) -> torch.Tensor:
        """The sketched per-half-edge σ̂ (exact on §6.3 heuristic edges)."""
        p = self.params
        return approximate_similarities(
            g, measure=self.measure, method=p.method, samples=p.samples,
            seed=p.seed, degree_heuristic=p.degree_heuristic, tracer=tracer)

    def build(self, g: CSRGraph, *,
              tracer=None) -> Tuple[ScanIndex, IndexProvenance]:
        """→ (approximate index, its provenance tag). ``tracer``: any
        object with a ``span(name, **attrs)`` context manager, or None;
        the build runs in an ``index.approx_build`` span, the sort stage
        in ``index.orders``, and the σ̂ stages in the spans of
        :func:`approximate_similarities`."""
        p = self.params
        span = trace_span(tracer)
        with span("index.approx_build", method=p.method, samples=p.samples,
                  seed=p.seed, n=g.n, m=g.m):
            sims = self.similarities(g, tracer=tracer)
            with span("index.orders"):
                index = build_index(g, self.measure, sims=sims)
        return index, self.provenance


def build_approx_index(
    g: CSRGraph,
    *,
    measure: str = "cosine",
    method: str = "simhash",
    samples: int = 256,
    seed: int = 0,
    degree_heuristic: bool = True,
) -> Tuple[ScanIndex, IndexProvenance]:
    """One-shot convenience wrapper over :class:`ApproxIndexBuilder`."""
    params = ApproxParams(method=method, samples=samples, seed=seed,
                          degree_heuristic=degree_heuristic)
    return ApproxIndexBuilder(measure, params).build(g)
