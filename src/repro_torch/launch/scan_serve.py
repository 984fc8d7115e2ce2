"""SCAN sweep launcher (port of the ``sweep`` subcommand of
``repro.launch.scan_serve``).

Build the index of a synthetic graph, exact or LSH-approximate, and print
a (μ, ε) parameter-sweep table, the same table the reference CLI prints:

    # on the GPU (the default device)
    PYTHONPATH=src python -m repro_torch.launch.scan_serve sweep \\
        --n 8192 --avg-degree 16 --mus 2,4,8 --epss 0.2:0.8:7

    # the approximate (SimHash, 256 samples) index
    PYTHONPATH=src python -m repro_torch.launch.scan_serve sweep \\
        --n 8192 --approx simhash:256

    # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.scan_serve sweep \\
        --device cpu --n 512

``--device`` defaults to ``cuda``; without CUDA the command fails rather
than running on the CPU. The ``serve``, ``update`` and ``fleet``
subcommands, ``--load``/``--save`` and ``--shards`` are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def parse_values(spec: str, kind):
    """``"2,4,8"`` → list, or ``"0.1:0.9:5"`` → linspace."""
    if ":" in spec:
        lo, hi, num = spec.split(":")
        return [kind(v) for v in np.linspace(float(lo), float(hi), int(num))]
    return [kind(v) for v in spec.split(",")]


def get_index(args):
    import torch

    from repro_torch.core import (
        ApproxIndexBuilder, ApproxParams, build_index, random_graph,
    )
    from repro_torch.serve import index_fingerprint

    g = random_graph(args.n, args.avg_degree, seed=args.seed,
                     weighted=args.weighted,
                     planted_clusters=args.clusters, device=args.device)
    t0 = time.time()
    if args.approx:
        builder = ApproxIndexBuilder(args.measure,
                                     ApproxParams.parse(args.approx))
        index, provenance = builder.build(g)
        kind = provenance.describe()
    else:
        index, kind = build_index(g, args.measure), "exact"
    if g.device.type == "cuda":
        torch.cuda.synchronize(g.device)
    fp = index_fingerprint(index, g)
    print(f"built {kind} index in {time.time() - t0:.2f}s "
          f"(n={g.n}, m={g.m}, seed={args.seed}, fingerprint={fp[:12]}, "
          f"device={g.device})")
    return index, g, fp


def cmd_sweep(args):
    from repro_torch.serve import sweep_stats

    index, g, _ = get_index(args)
    mus = parse_values(args.mus, int)
    epss = parse_values(args.epss, float)
    t0 = time.time()
    rows = sweep_stats(index, g, mus, epss)
    dt = time.time() - t0
    print(f"\n{len(rows)} (μ, ε) settings in one batched query "
          f"({dt:.2f}s)")
    print(f"{'mu':>4} {'eps':>6} {'clusters':>9} {'cores':>7} "
          f"{'coverage':>9} {'modularity':>11}")
    for r in rows:
        print(f"{r['mu']:>4} {r['eps']:>6.2f} {r['n_clusters']:>9} "
              f"{r['n_cores']:>7} {r['coverage']:>9.3f} "
              f"{r['modularity']:>11.4f}")
    best = max(rows, key=lambda r: r["modularity"])
    print(f"best modularity: mu={best['mu']} eps={best['eps']:.2f} "
          f"Q={best['modularity']:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("sweep", help="build an index, sweep a (μ, ε) grid")
    p.set_defaults(fn=cmd_sweep)
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--avg-degree", type=float, default=16.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clusters", type=int, default=0)
    p.add_argument("--weighted", action="store_true")
    p.add_argument("--measure", default="cosine",
                   choices=("cosine", "jaccard"))
    p.add_argument("--approx", metavar="METHOD[:K[:SEED]]",
                   help="build the LSH-sketched (approximate) index, e.g. "
                   "simhash:256 or minhash:128:7")
    p.add_argument("--mus", default="2,4,8")
    p.add_argument("--epss", default="0.1:0.9:9")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to opt out)")
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
