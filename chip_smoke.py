#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines as it ends:

1. device — the card's name and count, and ``nvidia-smi``'s name and
   power limit; no GPU fails at once.
2. build — all four CUDA kernels from ``src/repro_torch/csrc`` for sm_90a
   (one ``nvcc`` each, in parallel), with ``-Xptxas -v``'s lines.
3. graphs — (a) com-LiveJournal scale, ``random_graph(3997962, 8.675,
   seed=0)`` (m ≈ 34.7M, average degree ≈ 17.35); (b) skew,
   ``power_law_graph(262144, 2.1, avg_degree=16)``, whose hubs span up to
   64 tiles of 2048; (c) ``random_graph(8192, 16, seed=1)`` for the dense
   σ oracle; (d) ``random_graph(32768, 8.675, seed=2, weighted=True)`` for
   the dense sketch (W̄ = 4 GiB).
4. bucket_probe vs its plain version on the card: the first chunk of
   every (class pair, tile shape) group of (a) and (b), plus synthetic
   sorted rows; unweighted and weighted. Count and unweighted dot
   bit-identical, weighted dot rtol 1e-6. Timed at the dominant group's
   shape of (a).
5. masked_gram vs its plain version: n = 4096 gaussian W (rtol 2e-4,
   atol 2e-3) and the 0/1 closed adjacency of (c) (bit-identical); timed
   beside ``torch.matmul`` with TF32 off.
6. main path — graph → ``build_index`` → ``sweep_stats`` over
   μ ∈ {2, 4, 8} × ε ∈ linspace(0.1, 0.9, 9), on (a) and then on (b),
   each with the launch counts set to 0 just before and read just after.
   Checks: every σ chunk went through the kernel; σ on a fixed sample of
   2^20 edges equals the plain lane bit for bit; weighted ``closed_norms``
   is bit-stable; cores equal the direct threshold test; every core's
   label is a core.
7. oracle — bucketed σ equals masked-gram σ bit for bit on (c); its
   launches are counted and printed apart from the main path's.
8. hamming_cosine vs its plain version: random sketches at e = 2^24 with
   1, 4, 8 and 32 words, and (a)'s k = 256 sketches over all its edges.
   diff and σ̂ bit-identical, σ̂ within 2 ULP of the float64 cosine of the
   same float32 θ̂. Timed at (a)'s shape.
9. dense sketch — ``ops.simhash_sketches_kernel`` on (d), k = 256,
   counted on its own; simhash_pack vs its plain version: bit-identical on
   exact inputs (0/1 W̄, R on a 2⁻⁸ grid), and on gaussian R every bit
   whose |W̄·R| exceeds the forward error bound n·2⁻²⁴·(W̄·|R|) agrees with
   the plain version and with the sparse sketch path. Timed beside
   ``torch.matmul`` with TF32 off.
10. approximate path — ``ApproxIndexBuilder("cosine", simhash:256)`` →
    ``sweep_stats`` on (a) (degree heuristic on) and on (b) (on, and off:
    pure sketch), each counted on its own, with stage seconds and peak
    memory. Checks: hamming_cosine launched; bucket_probe launched once
    per exact-subset chunk; two sketch runs bit-identical; sketched σ̂
    equals the plain comparison; §6.3's exact σ equals the main path's;
    cores equal θ ≥ ε. On (b), ARI and core precision / recall against
    the exact index are printed, not gated.

The last two lines are the kernels' JSON record (``launches`` is the
count on each kernel's own main path, named by ``main_path``;
``launches_by_path`` gives every path's) and ``{"ok": true, "device":
{...}}``. Every failed check raises, so the script exits non-zero with no
result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM FP32 (non-tensor), NVIDIA data sheet
MUS = [2, 4, 8]
EPSS = [float(x) for x in np.linspace(0.1, 0.9, 9)]
SAMPLE_EDGES = 1 << 20


class CheckFailed(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------- phases
def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(smi)
    return {"kind": name, "count": count, "smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import _build

    out = subprocess.run([_build.nvcc_path(), "--version"],
                         capture_output=True, text=True, timeout=60)
    log(f"[build] {out.stdout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    infos = _build.build()
    log(f"[build] {len(infos)} kernels for sm_90a in "
        f"{time.perf_counter() - t0:.2f}s wall")
    for info in infos.values():
        log(f"[build] {info.name}: {info.seconds:.2f}s -> "
            f"{Path(info.path).relative_to(ROOT)}")
        for line in info.ptxas:
            log(f"[ptxas] {info.name}: {line}")


def phase_graphs() -> dict:
    from repro_torch.core import power_law_graph, random_graph

    graphs, secs = {}, {}
    graphs["a"], secs["a"] = timed(
        lambda: random_graph(3997962, 8.675, seed=0, device="cuda"))
    graphs["b"], secs["b"] = timed(
        lambda: power_law_graph(262144, 2.1, avg_degree=16, seed=0,
                                device="cuda"))
    graphs["c"], secs["c"] = timed(
        lambda: random_graph(8192, 16, seed=1, device="cuda"))
    graphs["d"], secs["d"] = timed(
        lambda: random_graph(32768, 8.675, seed=2, weighted=True,
                             device="cuda"))
    for k, g in graphs.items():
        deg = g.degrees()
        log(f"[graphs] ({k}) n={g.n} m={g.m} avg_degree={2 * g.m / g.n:.3f} "
            f"max_degree={int(deg.max())} build_s={secs[k]:.3f}")
    return {"graphs": graphs, "build_s": secs}


def _probe_compare(ops, n, weighted, gen, errs) -> None:
    from repro_torch.kernels.bucket_probe import bucket_probe, bucket_probe_plain

    rows_p, w_p, rows_t, w_t = ops
    if weighted:
        w_p = torch.rand(w_p.shape, generator=gen, device="cuda") * 0.9 + 0.1
        w_t = torch.rand(w_t.shape, generator=gen, device="cuda") * 0.9 + 0.1
    dot, cnt = bucket_probe(rows_p, w_p, rows_t, w_t, n)
    pdot, pcnt = bucket_probe_plain(rows_p, w_p, rows_t, w_t, n)
    sync()
    shape = f"e={rows_p.shape[0]} P={rows_p.shape[1]} T={rows_t.shape[1]}"
    check(torch.equal(cnt, pcnt), f"bucket_probe count differs ({shape})")
    check(bool(torch.isfinite(dot).all()), f"non-finite dot ({shape})")
    if weighted:
        torch.testing.assert_close(dot, pdot, rtol=1e-6, atol=0.0,
                                   msg=f"weighted dot ({shape})")
        errs.append(float((dot - pdot).abs().max()))
    else:
        check(torch.equal(dot, pdot), f"unweighted dot differs ({shape})")


def _synthetic_rows(gen, e, width, n):
    """Sorted rows of distinct ids < n, pad id n after a random length."""
    ids = torch.randint(0, n, (e, width), generator=gen, device="cuda")
    ids = torch.sort(ids, dim=1).values
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    length = torch.randint(0, width + 1, (e, 1), generator=gen, device="cuda")
    pad = dup | (torch.arange(width, device="cuda")[None, :] >= length)
    ids = torch.sort(torch.where(pad, n, ids), dim=1).values
    return ids.to(torch.int32).contiguous(), torch.ones(
        (e, width), device="cuda")


def phase_bucket_probe(graphs: dict) -> dict:
    from repro_torch.core.similarity import SimilarityPlan
    from repro_torch.kernels.bucket_probe import bucket_probe, bucket_probe_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs: list = []
    compared = 0
    for key in ("a", "b"):
        g = graphs[key]
        plan = SimilarityPlan.build(g)
        sizes, firsts = [], []
        for group, sub, ops in plan.chunks(g.edge_u.long(), g.nbrs.long()):
            if group == len(sizes):          # a group's first chunk
                sizes.append(0)
                firsts.append(ops)
                for weighted in (False, True):
                    _probe_compare(ops, g.n, weighted, gen, errs)
                    compared += 1
            sizes[group] += sub.numel()
        log(f"[bucket_probe] ({key}) {len(sizes)} groups compared, "
            f"max tiles={int(plan.vtiles.max())}")
        if key == "a":
            top = max(range(len(sizes)), key=sizes.__getitem__)
            dominant = (sizes[top], firsts[top], g.n)
        del plan, firsts
    for e, p, t, n in ((4096, 64, 4096, 1 << 20), (256, 2048, 131072, 262144),
                       (1000, 37, 53, 5000)):
        rows_p, w_p = _synthetic_rows(gen, e, p, n)
        rows_t, w_t = _synthetic_rows(gen, e, t, n)
        for weighted in (False, True):
            _probe_compare((rows_p, w_p, rows_t, w_t), n, weighted, gen, errs)
            compared += 1
    log(f"[bucket_probe] {compared} comparisons vs plain passed "
        f"(cnt and unweighted dot bit-identical, weighted dot rtol 1e-6, "
        f"max |dot diff| {max(errs):.3e})")

    count, ops, n = dominant
    rows_p, w_p, rows_t, w_t = ops
    e, p, t = rows_p.shape[0], rows_p.shape[1], rows_t.shape[1]
    ms = cuda_ms(lambda: bucket_probe(*ops, n), reps=50)
    plain_ms = cuda_ms(lambda: bucket_probe_plain(*ops, n), reps=10)
    # every input element read once, every output written once
    nbytes = e * (p + t) * (4 + 4) + e * (4 + 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[bucket_probe] dominant group of (a): {count} edges, chunk "
        f"e={e} P={p} T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms (bytes: {nbytes})")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def phase_masked_gram(graphs: dict) -> dict:
    from repro_torch.core.graph import to_dense
    from repro_torch.kernels.triangle_count import (
        ieee_fp32_matmul, masked_gram, masked_gram_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    n = 4096
    w = torch.randn((n, n), generator=gen, device="cuda")
    mask = (torch.rand((n, n), generator=gen, device="cuda") < 0.15).float()
    got = masked_gram(w, mask)
    want = masked_gram_plain(w, mask)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-3,
                               msg="masked_gram n=4096 weighted")
    err = float((got - want).abs().max())
    g = graphs["c"]
    adj = to_dense(g, closed=True, weighted=False)
    check(torch.equal(masked_gram(adj, (adj > 0).float()),
                      masked_gram_plain(adj, (adj > 0).float())),
          "masked_gram differs on the 0/1 closed adjacency")
    log(f"[masked_gram] n={n} gaussian: max |diff| {err:.3e} "
        f"(rtol 2e-4, atol 2e-3); n={g.n} adjacency: bit-identical")

    ms = cuda_ms(lambda: masked_gram(w, mask), reps=10)
    plain_ms = cuda_ms(lambda: masked_gram_plain(w, mask), reps=10)
    with ieee_fp32_matmul():
        library_ms = cuda_ms(lambda: torch.matmul(w, w.T), reps=10)
    flop_ms = 2 * n ** 3 / FP32_FLOP_PER_S * 1e3
    byte_ms = 3 * n * n * 4 / HBM_BYTES_PER_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    log(f"[masked_gram] n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, torch.matmul (TF32 off) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms (operations {flop_ms:.4f}, bytes {byte_ms:.4f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": library_ms}


def _main_path_graph(key: str, g, build_s: float) -> dict:
    """Drive graph → ``build_index`` → ``sweep_stats`` on one graph, with
    the launch counts set to 0 just before and read just after; then check
    the result. Returns this path's launch counts."""
    from repro_torch.core import build_index, closed_norms, plan_for
    from repro_torch.core.similarity import (
        compute_similarities, edge_similarities_subset,
    )
    from repro_torch.kernels import _build
    from repro_torch.serve import sweep_stats

    _build.reset_launch_counts()
    sims, sigma_s = timed(lambda: compute_similarities(g))
    plan = plan_for(g)
    groups, chunks = plan.last_groups, plan.last_chunks
    index, orders_s = timed(lambda: build_index(g, sims=sims))
    rows, sweep_s = timed(lambda: sweep_stats(index, g, MUS, EPSS))
    counts = _build.launch_counts()

    log(f"[main] ({key}) n={g.n} m={g.m} operand_bytes={plan.operand_bytes()}"
        f" groups={groups} chunks={chunks} launches={counts} "
        f"graph_s={build_s:.3f} sigma_s={sigma_s:.3f} "
        f"orders_s={orders_s:.3f} sweep_s={sweep_s:.3f} max_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}")
    with_cores = sum(r["n_cores"] > 0 for r in rows)
    log(f"[main] ({key}) settings with cores: {with_cores} of {len(rows)}")
    for r in rows:
        if (r["mu"], round(r["eps"], 2)) in ((2, 0.2), (4, 0.3), (8, 0.5)):
            log(f"[main] ({key}) mu={r['mu']} eps={r['eps']:.2f} "
                f"n_clusters={r['n_clusters']} n_cores={r['n_cores']} "
                f"coverage={r['coverage']:.4f} Q={r['modularity']:.4f}")
    check(counts["bucket_probe"] == chunks > 0,
          f"({key}) {counts['bucket_probe']} bucket_probe launches for "
          f"{chunks} group chunks")
    check(groups > 0 and (key != "b" or int(plan.vtiles.max()) > 1),
          f"({key}) hub tiling not engaged")
    check(bool(torch.isfinite(sims).all()) and float(sims.min()) >= 0
          and float(sims.max()) <= 1.0 + 1e-6, f"({key}) σ out of range")

    # σ on a fixed edge sample, recomputed by the plain lane on the card
    gen = torch.Generator(device="cuda").manual_seed(3)
    k = min(SAMPLE_EDGES, g.m2)
    sample = torch.randperm(g.m2, generator=gen, device="cuda")[:k]
    ref = edge_similarities_subset(g, g.edge_u[sample], g.nbrs[sample],
                                   g.wgts[sample], lane="ref")
    check(torch.equal(ref, sims[sample]),
          f"({key}) kernel σ differs from the plain lane on {k} edges")

    # weighted norms: the segmented reduction must not change bits
    gw = dataclasses.replace(
        g, wgts=torch.rand(g.m2, generator=gen, device="cuda") * 0.9 + 0.1)
    check(torch.equal(closed_norms(gw), closed_norms(gw)),
          f"({key}) weighted closed_norms not bit-stable")

    res = _check_sweep(key, index, g, rows)
    log(f"[main] ({key}) checks passed: launches == chunks, {k}-edge σ "
        f"sample == plain lane, weighted norms bit-stable, cores == θ ≥ ε "
        f"and core labels are cores for {len(res)} settings")
    return {"counts": counts, "index": index}


def _check_sweep(key: str, index, g, rows):
    """The sweep rows agree with the grid sweep; every setting's cores are
    θ ≥ ε and every core's label is a core. Returns the grid sweep."""
    from repro_torch.serve import grid_sweep

    res = grid_sweep(index, g, MUS, EPSS)
    check([r["n_clusters"] for r in rows] == res.n_clusters.tolist(),
          f"({key}) sweep rows disagree with the grid sweep")
    for i, (mu, eps) in enumerate(zip(res.mus, res.epss)):
        direct = (index.core_threshold(int(mu)) >= float(eps)).cpu().numpy()
        check(np.array_equal(res.is_core[i], direct),
              f"({key}) cores differ from θ ≥ ε at mu={mu} eps={eps}")
        labels, core = res.labels[i], res.is_core[i]
        check(bool(core[labels[core]].all()) if core.any() else True,
              f"({key}) a core's label is not a core at mu={mu} eps={eps}")
    return res


def phase_main(graphs: dict, build_s: dict) -> dict:
    """The main path on (a) and (b), each counted on its own; returns
    ``{path: {"counts": launch counts, "index": its index}}``."""
    per_path = {}
    for key in ("a", "b"):
        torch.cuda.reset_peak_memory_stats()
        per_path[key] = _main_path_graph(key, graphs[key], build_s[key])
    return per_path


# ------------------------------------------------------ the approximate path
def f32_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 units in the last place."""
    d = a.view(torch.int32).long() - b.view(torch.int32).long()
    return int(d.abs().max()) if d.numel() else 0


def _hamming_compare(sk, eu, ev, samples: int, label: str) -> float:
    """Kernel vs plain on one input; returns the largest |σ̂ difference|.
    The kernel writes σ̂ alone; σ̂ bit-identical to the plain version's
    means diff identical too, because the samples + 1 levels of σ̂ are
    distinct floats (checked here)."""
    from repro_torch.kernels.hamming import (
        cosine_of_diff, hamming_cosine, hamming_cosine_plain, theta_of_diff,
    )

    levels = cosine_of_diff(torch.arange(samples + 1, device=sk.device,
                                         dtype=torch.int32), samples)
    check(levels.unique().numel() == samples + 1,
          f"σ̂ levels are not one-to-one with diff at samples={samples}")
    sim = hamming_cosine(sk, eu, ev, samples)
    psim, pdiff = hamming_cosine_plain(sk, eu, ev, samples, return_diff=True)
    sync()
    check(torch.equal(sim.view(torch.int32), psim.view(torch.int32)),
          f"hamming σ̂ differs from the plain version ({label})")
    # cosf's bound: the float64 cosine of the same float32 argument θ̂
    exact = torch.cos(theta_of_diff(pdiff, samples).double()).float()
    ulp = f32_ulps(sim, exact)
    check(ulp <= 2, f"hamming σ̂ {ulp} ULP from the float64 cosine ({label})")
    log(f"[hamming_cosine] {label}: σ̂ (so diff) bit-identical to plain, "
        f"σ̂ within {ulp} ULP of float64 cos(θ̂)")
    return float((sim - psim).abs().max()) if sim.numel() else 0.0


def phase_hamming(graphs: dict) -> dict:
    """hamming_cosine vs its plain version: random sketches at e = 2^24,
    words ∈ {1, 4, 8, 32}, and (a)'s own k = 256 sketches over all of its
    edges; timed at (a)'s shape."""
    from repro_torch.core.lsh import simhash_sketches
    from repro_torch.kernels.hamming import hamming_cosine, hamming_cosine_plain

    gen = torch.Generator(device="cuda").manual_seed(4)
    e, n = 1 << 24, 1 << 20
    errs = []
    for words in (1, 4, 8, 32):
        sk = torch.randint(-2 ** 31, 2 ** 31, (n, words), generator=gen,
                           device="cuda", dtype=torch.int64)
        sk = sk.to(torch.int32).view(torch.uint32)
        eu = torch.randint(0, n, (e,), generator=gen, device="cuda",
                           dtype=torch.int32)
        ev = torch.randint(0, n, (e,), generator=gen, device="cuda",
                           dtype=torch.int32)
        errs.append(_hamming_compare(sk, eu, ev, 32 * words,
                                     f"random e={e} words={words}"))
    del sk, eu, ev
    g = graphs["a"]
    sk = simhash_sketches(g, 256, 0)
    errs.append(_hamming_compare(sk, g.edge_u, g.nbrs, 256,
                                 f"(a) sketches e={g.m2} words={sk.shape[1]}"))
    ms = cuda_ms(lambda: hamming_cosine(sk, g.edge_u, g.nbrs, 256), reps=20)
    plain_ms = cuda_ms(
        lambda: hamming_cosine_plain(sk, g.edge_u, g.nbrs, 256), reps=3)
    # the bound: what the function must move, two ids read and σ̂ written
    # per edge (12 B) and the sketch table read once
    row_bytes = 4 * sk.shape[1]
    nbytes = g.m2 * 12 + g.n * row_bytes
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # for reference, not the bound: every ev row read as its own sectors
    # (random in CSR order), the eu rows once
    gather_bytes = nbytes + g.m2 * row_bytes
    gather_ms = gather_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[hamming_cosine] (a) shape e={g.m2} words={sk.shape[1]}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"(bytes: {nbytes}), random-gather time {gather_ms:.4f} ms "
        f"(bytes: {gather_bytes})")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def _bits(words: torch.Tensor) -> torch.Tensor:
    """uint32[n, w] → int64[n, 32w] of 0/1 (bit s of word j at 32j+s)."""
    shifts = torch.arange(32, device=words.device)
    x = words.view(torch.int32).long()[:, :, None] >> shifts
    return (x & 1).reshape(words.shape[0], -1)


def phase_dense_sketch(g) -> tuple:
    """simhash_pack vs its plain version on (d), and the dense sketch path
    (``ops.simhash_sketches_kernel``) counted on its own. Returns (kernel
    record, launch counts of the path)."""
    from repro_torch.core.graph import to_dense
    from repro_torch.core.lsh import projections, simhash_sketches
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.simhash import simhash_pack, simhash_pack_plain
    from repro_torch.kernels.triangle_count import ieee_fp32_matmul

    n, k = g.n, 256
    _build.reset_launch_counts()
    dense, dense_s = timed(lambda: ops.simhash_sketches_kernel(g, k, 0))
    counts = _build.launch_counts()
    check(counts["simhash_pack"] >= 1,
          f"(d) the dense sketch path launched no simhash_pack: {counts}")
    check(tuple(dense.shape) == (n, k // 32), "(d) dense sketch shape")

    # exact inputs: 0/1 closed adjacency, R on a 2^-8 grid in [-4, 4]
    gen = torch.Generator(device="cuda").manual_seed(5)
    w01 = to_dense(g, closed=True, weighted=False)
    rq = torch.randint(-1024, 1025, (n, k), generator=gen,
                       device="cuda").float() / 256
    check(torch.equal(simhash_pack(w01, rq).view(torch.int32),
                      simhash_pack_plain(w01, rq).view(torch.int32)),
          "(d) simhash_pack differs on exact inputs")
    del w01, rq

    # gaussian R (the path's own), weighted closed adjacency
    w = to_dense(g, closed=True, weighted=True)
    r = projections(0, 0, k // 32, n, "cuda")
    got = simhash_pack(w, r)
    check(torch.equal(got.view(torch.int32), dense.view(torch.int32)),
          "(d) simhash_pack != ops.simhash_sketches_kernel on equal inputs")
    want = simhash_pack_plain(w, r)
    w64 = w.double()
    s = w64 @ r.double()
    bound = n * 2.0 ** -24 * (w64 @ r.double().abs())   # w ≥ 0
    del w64
    safe = s.abs() > bound
    b_got, b_want = _bits(got), _bits(want)
    # the error measure of a sign bit: |bit difference| outside the bound
    err = float((b_got[safe] - b_want[safe]).abs().max())
    check(err == 0.0,
          "(d) simhash_pack bits differ outside the forward error bound")
    inside = int((b_got != b_want).sum())
    sparse = _bits(simhash_sketches(g, k, 0))
    check(torch.equal(sparse[safe], b_got[safe]),
          "(d) dense sketch != sparse sketch outside the error bound")
    log(f"[simhash_pack] (d) n={n} k={k}: exact inputs bit-identical; "
        f"gaussian: all {int(safe.sum())} bits outside the bound agree with "
        f"plain and with the sparse path, {inside} of "
        f"{int((~safe).sum())} inside it differ from plain, "
        f"{int((sparse != b_got).sum())} from the sparse path; dense path "
        f"{dense_s:.3f}s, launches {counts}")
    del s, bound, safe, b_got, b_want, sparse

    ms = cuda_ms(lambda: simhash_pack(w, r), reps=5)
    plain_ms = cuda_ms(lambda: simhash_pack_plain(w, r), reps=5)
    with ieee_fp32_matmul():
        library_ms = cuda_ms(lambda: torch.matmul(w, r), reps=5)
    flop_ms = 2 * n * n * k / FP32_FLOP_PER_S * 1e3
    byte_ms = (4 * n * n + 4 * n * k + n * k // 8) / HBM_BYTES_PER_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    log(f"[simhash_pack] n={n} k={k}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.matmul (TF32 off) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms (operations {flop_ms:.4f}, bytes "
        f"{byte_ms:.4f})")
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
           "library_ms": library_ms}
    return rec, counts


class StageTracer:
    """Seconds per span name; synchronises the card at each edge."""

    def __init__(self):
        self.seconds: dict = {}

    @contextlib.contextmanager
    def span(self, name, **attrs):
        sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


def _approx_path(key: str, g, exact_sims, heuristic: bool) -> dict:
    """Drive ``ApproxIndexBuilder("cosine", simhash:256)`` → ``sweep_stats``
    on one graph, with the launch counts set to 0 just before and read
    just after; then check it. Returns its counts and its index."""
    from repro_torch.core import ApproxIndexBuilder, ApproxParams, plan_for
    from repro_torch.core.lsh import exact_edge_mask, simhash_sketches
    from repro_torch.kernels import _build
    from repro_torch.kernels.hamming import hamming_cosine_plain
    from repro_torch.serve import sweep_stats

    params = dataclasses.replace(ApproxParams.parse("simhash:256"),
                                 degree_heuristic=heuristic)
    tracer = StageTracer()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    (index, prov), build_s = timed(
        lambda: ApproxIndexBuilder("cosine", params).build(g, tracer=tracer))
    chunks = plan_for(g).last_chunks if heuristic else 0
    rows, sweep_s = timed(lambda: sweep_stats(index, g, MUS, EPSS))
    counts = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    exact = (exact_edge_mask(g, "cosine", params.samples) if heuristic
             else torch.zeros(g.m2, dtype=torch.bool, device="cuda"))
    sketched = ~exact
    st = tracer.seconds
    log(f"[approx] ({key}) {prov.describe()}: n={g.n} m={g.m} "
        f"sketched_share={float(sketched.float().mean()):.6f} "
        f"exact_chunks={chunks} launches={counts} build_s={build_s:.3f} "
        f"sketch_s={st.get('lsh.sketch', 0.0):.3f} "
        f"hamming_s={st.get('lsh.compare', 0.0):.3f} "
        f"exact_subset_s={st.get('lsh.exact', 0.0):.3f} "
        f"orders_s={st.get('index.orders', 0.0):.3f} "
        f"sweep_s={sweep_s:.3f} max_mem_gb={peak_gb:.2f}")
    check(counts["hamming_cosine"] >= 1,
          f"({key}) the approximate path launched no hamming_cosine")
    check(counts["bucket_probe"] == chunks,
          f"({key}) {counts['bucket_probe']} bucket_probe launches for "
          f"{chunks} exact-subset chunks")
    sk = simhash_sketches(g, params.samples, params.seed)
    check(torch.equal(sk.view(torch.int32),
                      simhash_sketches(g, params.samples, params.seed)
                      .view(torch.int32)),
          f"({key}) two sketch runs differ")
    idx = torch.nonzero(sketched).flatten()
    plain = torch.clamp(hamming_cosine_plain(
        sk, g.edge_u[idx], g.nbrs[idx], params.samples), 0.0, 1.0)
    check(torch.equal(index.edge_sims[idx], plain),
          f"({key}) sketched σ̂ != hamming_cosine_plain σ̂")
    check(torch.equal(index.edge_sims[exact], exact_sims[exact]),
          f"({key}) §6.3 exact σ != the main path's σ")
    res = _check_sweep(key, index, g, rows)
    log(f"[approx] ({key}) checks passed: hamming launched, bucket_probe "
        f"launches == exact chunks, sketches bit-stable, {idx.numel()} "
        f"sketched σ̂ == plain, {int(exact.sum())} exact σ == main path, "
        f"cores == θ ≥ ε for {len(res)} settings")
    return {"counts": counts, "index": index, "sweep": res}


def _quality(key: str, exact_res, approx_res) -> None:
    from repro_torch.core.quality import (
        adjusted_rand_index, core_precision_recall,
    )

    aris = np.asarray([adjusted_rand_index(e, a) for e, a in
                       zip(exact_res.labels, approx_res.labels)])
    pr = np.asarray([core_precision_recall(a, e) for e, a in
                     zip(exact_res.is_core, approx_res.is_core)])
    log(f"[approx] ({key}) quality vs the exact index over {len(aris)} "
        f"settings: mean ARI {aris.mean():.4f}, ARI >= 0.8 share "
        f"{np.mean(aris >= 0.8):.4f}, core precision {pr[:, 0].mean():.4f}, "
        f"core recall {pr[:, 1].mean():.4f}")


def phase_approx(graphs: dict, main: dict) -> dict:
    """The approximate path on (a) (degree heuristic on) and on (b) with
    the heuristic on and off; returns ``{path: launch counts}``."""
    from repro_torch.serve import grid_sweep

    per_path = {}
    out = _approx_path("a", graphs["a"], main["a"]["index"].edge_sims, True)
    per_path["approx_a"] = out["counts"]
    del out
    exact_b = main["b"]["index"]
    exact_res = grid_sweep(exact_b, graphs["b"], MUS, EPSS)
    for path, heuristic in (("approx_b", True), ("approx_b_pure", False)):
        out = _approx_path(path.replace("approx_", ""), graphs["b"],
                           exact_b.edge_sims, heuristic)
        per_path[path] = out["counts"]
        _quality(path, exact_res, out["sweep"])
    return per_path


def phase_oracle(graph) -> None:
    """Bucketed σ (``bucket_probe``) against masked-gram σ on (c). Its
    launches are counted apart from the main path's."""
    from repro_torch.core.similarity import compute_similarities
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import edge_similarities_gram

    _build.reset_launch_counts()
    for measure in ("cosine", "jaccard"):
        bucketed = compute_similarities(graph, measure)
        dense = edge_similarities_gram(graph, measure)
        check(torch.equal(bucketed, dense),
              f"(c) bucketed σ != masked-gram σ for {measure}")
    counts = _build.launch_counts()
    check(counts["bucket_probe"] > 0 and counts["masked_gram"] > 0,
          f"(c) the cross-check skipped a kernel: {counts}")
    log(f"[oracle] (c) n={graph.n} m={graph.m}: bucketed σ == masked-gram σ "
        f"bit for bit (cosine, jaccard); launches {counts}")


def main() -> None:
    t0 = time.perf_counter()
    device = phase_device()
    import repro_torch  # noqa: F401  (fails in a checkout without src/)

    phase_build()
    inputs = phase_graphs()
    graphs = inputs["graphs"]
    probe = phase_bucket_probe(graphs)
    gram = phase_masked_gram(graphs)
    main_paths = phase_main(graphs, inputs["build_s"])
    phase_oracle(graphs["c"])
    hamming = phase_hamming(graphs)
    pack, dense_counts = phase_dense_sketch(graphs["d"])
    per_path = {p: out["counts"] for p, out in main_paths.items()}
    per_path.update(phase_approx(graphs, main_paths))
    per_path["dense_sketch"] = dense_counts
    # launches: each kernel's own main path (bucket_probe and masked_gram:
    # the exact path on (a); hamming_cosine: the approximate path on (a);
    # simhash_pack: the dense sketch path), every path's count beside it
    kernels = [
        dict(name="bucket_probe", route="cuda",
             source="src/repro_torch/csrc/bucket_probe.cu",
             replaces="src/repro/kernels/bucket_probe.py:73",
             main_path="a", **probe),
        dict(name="masked_gram", route="cuda",
             source="src/repro_torch/csrc/masked_gram.cu",
             replaces="src/repro/kernels/triangle_count.py:62",
             main_path="a", **gram),
        dict(name="hamming_cosine", route="cuda",
             source="src/repro_torch/csrc/hamming_cosine.cu",
             replaces="src/repro/kernels/hamming.py:50",
             main_path="approx_a", **hamming),
        dict(name="simhash_pack", route="cuda",
             source="src/repro_torch/csrc/simhash_pack.cu",
             replaces="src/repro/kernels/simhash.py:61",
             main_path="dense_sketch", **pack),
    ]
    for k in kernels:
        k["launches"] = per_path[k["main_path"]][k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in per_path.items()}
    for path in ("approx_a", "approx_b", "approx_b_pure"):
        check(per_path[path]["hamming_cosine"] >= 1,
              f"{path}: no hamming_cosine launch")
    check(per_path["dense_sketch"]["simhash_pack"] >= 1,
          "dense_sketch: no simhash_pack launch")
    log(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)


if __name__ == "__main__":
    main()
