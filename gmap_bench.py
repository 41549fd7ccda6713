#!/usr/bin/env python3
"""The GMAP cDNA workload of chip_smoke.py, and tpumap's result on it.

`gmap_queries` makes tools/bench_gmap.make_queries' cDNAs (2-5 exons of
100-399 bp, introns of 200-4,999 bp, from random positions of the bench
genome, seed 7), keeping each one's exons as truth; `grade_gmap` gives
the found fraction and the share of queries whose exon count equals the
truth and whose exon ends all lie within 10 bp of it. Neither imports
JAX or tpumap: chip_smoke.py grades the port with them.

Run as a script, it aligns the cDNAs with tpumap's align_queries_bulk
(JAX on the CPU) over the bench genome's k=14 index under .bench_data/
(built there by chip_smoke.py, or here if missing) and prints tpumap's
grades, the floor chip_smoke.py holds the port to. With --port it then
runs the port on the card over the same queries and counts the queries
whose exon chains differ from tpumap's.

Usage: python3 gmap_bench.py [-n 2048] [--port]
"""
import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
N_GMAP = 2048
SEED = 7


def gmap_queries(db, n: int = N_GMAP, seed: int = SEED):
    """(cDNA sequences, truth): make_queries' draws, and each query's
    exons as [(start, end)) univcoords in genome order."""
    rng = np.random.default_rng(seed)
    g = db.get_seq(0, db.genome_length)
    queries, truth = [], []
    for _ in range(n):
        ne = int(rng.integers(2, 6))
        pos = int(rng.integers(0, db.genome_length - 100000))
        parts, exons = [], []
        for _ in range(ne):
            el = int(rng.integers(100, 400))
            parts.append(g[pos:pos + el])
            exons.append((pos, pos + el))
            pos += el + int(rng.integers(200, 5000))
        queries.append("".join(parts))
        truth.append(exons)
    return queries, truth


def exon_spans(hit):
    """A hit's exons as sorted [(start, end)) univcoords, or None."""
    if hit is None:
        return None
    chain, off = hit
    return sorted((off + e.gstart, off + e.gend) for e in chain.exons)


def grade_gmap(hits, truth):
    """(found fraction, exon-structure share): a query's structure is
    right when its exon count equals the truth's and every exon end lies
    within 10 bp of the truth's."""
    found = right = 0
    for hit, exons in zip(hits, truth):
        spans = exon_spans(hit)
        if spans is None:
            continue
        found += 1
        right += len(spans) == len(exons) and all(
            abs(a - c) <= 10 and abs(b - d) <= 10
            for (a, b), (c, d) in zip(spans, exons))
    return found / len(truth), right / len(truth)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=N_GMAP)
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the card and compare")
    args = ap.parse_args()
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    from tools import bench_data
    from tpumap.cli.gmap_cli import align_queries_bulk
    from tpumap.index import GenomeDB, build_db
    from tpumap.index.device import DeviceIndex
    from tpumap.utils import dna

    bench_data.ROOT = ROOT / ".bench_data"
    gfa, _rfa = bench_data.ensure_files()
    dbdir = bench_data.ROOT / "db_k14"
    if (dbdir / "meta.json").exists():
        db = GenomeDB.load(str(dbdir))
    else:
        db = build_db(gfa, name="bench", k=14, interval=3)
        db.save(str(dbdir))
    queries, truth = gmap_queries(db, args.n)
    enc = [dna.encode(q) for q in queries]
    t0 = time.perf_counter()
    want = align_queries_bulk(db, DeviceIndex.from_host(db), enc)
    dt = time.perf_counter() - t0
    found, right = grade_gmap(want, truth)
    print(json.dumps({"engine": "tpumap, JAX on the CPU", "queries": args.n,
                      "found": found, "exon_structure": right,
                      "floor": round(right - 0.01, 4), "wall_s": dt}),
          flush=True)
    if not args.port:
        return 0
    import torch
    from tpumap_torch.cli import gmap_cli
    from tpumap_torch.index.device import DeviceIndex as TDeviceIndex
    tindex = TDeviceIndex.from_host(db, "cuda")
    gmap_cli.align_queries_bulk(db, tindex, enc[:256])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = gmap_cli.align_queries_bulk(db, tindex, enc)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    found, right = grade_gmap(got, truth)
    differ = [i for i, (a, b) in enumerate(zip(want, got))
              if exon_spans(a) != exon_spans(b)
              or (a is not None and a[0].strand != b[0].strand)]
    print(json.dumps({"engine": "tpumap_torch on " +
                      torch.cuda.get_device_name(0), "queries": args.n,
                      "found": found, "exon_structure": right,
                      "wall_s": dt, "differ_from_tpumap": len(differ),
                      "first_differing": differ[:10]}), flush=True)
    for i in differ[:3]:
        print(json.dumps({"query": i, "tpumap": exon_spans(want[i]),
                          "port": exon_spans(got[i]),
                          "truth": truth[i]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
