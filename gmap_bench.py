#!/usr/bin/env python3
"""The GMAP cDNA workloads of chip_smoke.py, and tpumap's result on them.

`gmap_queries` makes tools/bench_gmap.make_queries' cDNAs (2-5 exons of
100-399 bp, introns of 200-4,999 bp, from random positions of the bench
genome, seed 7), keeping each one's exons as truth; `grade_gmap` gives
the found fraction and the share of queries whose exon count equals the
truth and whose exon ends all lie within 10 bp of it. `chimera_queries`
joins the leading exons of one of those cDNAs to the trailing exons of
another whose locus lies more than 1 Mbp away (seed 11);
`grade_chimeras` gives the share reported as two pieces, each at its
part's locus, that meet within 10 bp of the join. None of them imports
JAX or tpumap: chip_smoke.py grades the port with them.

Run as a script, it aligns the cDNAs with tpumap (JAX on the CPU) over
the bench genome's k=14 index under .bench_data/ (built there by
chip_smoke.py, or here if missing) and prints tpumap's grades, the
floors chip_smoke.py holds the port to:
- by default the bulk path, align_queries_bulk (gmap -n 1);
- --paths: the default path, align_query_paths(npaths=5) one query at a
  time as gmap's main runs it, graded on each query's first path, with
  the distribution of paths a query;
- --chimeras: align_query_chimera(chimera_margin=30) over the chimeras;
these two in -j worker processes (default 8), each query in one.
With --port it then runs the port on the card over the same queries and
counts the queries whose paths (strand, offset and exon spans of each)
differ from tpumap's.

Usage: python3 gmap_bench.py [-n 2048] [--paths] [--chimeras] [-j 8]
                             [--port]
"""
import argparse
import collections
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
N_GMAP = 2048
SEED = 7
N_CHIMERA = 256
CHIMERA_SEED = 11
CHIMERA_MARGIN = 30     # gmap -x of the chimera workload
NPATHS = 5              # gmap -n, its default


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


def chimera_queries(queries, truth, n: int = N_CHIMERA,
                    seed: int = CHIMERA_SEED):
    """(chimeric cDNA sequences, truth): each joins the leading 1 to
    ne - 1 exons of one cDNA of gmap_queries to the trailing 1 to ne - 1
    exons of another, the two loci more than 1 Mbp apart. truth: (the
    leading exons, the trailing exons, the join: the query position of
    the first trailing base)."""
    rng = np.random.default_rng(seed)
    seqs, ctruth = [], []
    while len(seqs) < n:
        a, b = (int(x) for x in rng.integers(0, len(queries), 2))
        ta, tb = truth[a], truth[b]
        if max(ta[0][0], tb[0][0]) - min(ta[-1][1], tb[-1][1]) <= 1_000_000:
            continue
        lead = ta[:int(rng.integers(1, len(ta)))]
        trail = tb[len(tb) - int(rng.integers(1, len(tb))):]
        join = sum(e - s for s, e in lead)
        tail = sum(e - s for s, e in trail)
        seqs.append(queries[a][:join] + queries[b][len(queries[b]) - tail:])
        ctruth.append((lead, trail, join))
    return seqs, ctruth


def exon_spans(hit):
    """A hit's exons as sorted [(start, end)) univcoords, or None."""
    if hit is None:
        return None
    chain, off = hit
    return sorted((off + e.gstart, off + e.gend) for e in chain.exons)


def path_key(paths):
    """What a user reads of a query's paths: each one's strand, offset
    and exon spans, in order."""
    return [(c.strand, off, exon_spans((c, off))) for c, off in paths]


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


def grade_paths(paths, truth):
    """grade_gmap on each query's first path, and the number of queries
    by their number of paths."""
    found, right = grade_gmap([p[0] if p else None for p in paths], truth)
    return found, right, dict(sorted(collections.Counter(
        len(p) for p in paths).items()))


def query_span(chain, qlen: int):
    """A chain's covered [start, end) in the query's own orientation."""
    qs = min(e.qstart for e in chain.exons)
    qe = max(e.qend for e in chain.exons)
    return (qlen - qe, qlen - qs) if chain.strand else (qs, qe)


def grade_chimeras(pieces, seqs, ctruth):
    """The share of chimeras reported as two pieces in query order, the
    first overlapping its leading exons' locus and the second its
    trailing exons', whose breakpoint (the midpoint of the first piece's
    end and the second's start, gmap's breakpoint) lies within 10 bp of
    the join."""
    right = 0
    for ps, seq, (lead, trail, join) in zip(pieces, seqs, ctruth):
        if len(ps) != 2:
            continue
        qlen = len(seq)
        at = [max(a, lo) < min(b, hi) for (a, b), (lo, hi) in zip(
            ((s[0][0], s[-1][1]) for s in (exon_spans(p) for p in ps)),
            ((lead[0][0], lead[-1][1]), (trail[0][0], trail[-1][1])))]
        bp = (query_span(ps[0][0], qlen)[1]
              + query_span(ps[1][0], qlen)[0]) // 2
        right += all(at) and abs(bp - join) <= 10
    return right / len(ctruth)


def run_each(fn, encoded):
    """fn over each encoded query, one at a time: (results, seconds)."""
    t0 = time.perf_counter()
    out = [fn(qc, qn) for qc, qn in encoded]
    return out, time.perf_counter() - t0


_WORKER = {}


def _tpumap_init(dbdir):
    """A worker process's tpumap: the bench db and its index (JAX on the
    CPU, one XLA thread: the workers share the cores)."""
    from tpumap.index import GenomeDB
    from tpumap.index.device import DeviceIndex
    db = GenomeDB.load(dbdir)
    _WORKER.update(db=db, index=DeviceIndex.from_host(db))


def _tpumap_run(job):
    """One worker's share of a tpumap run: (path, [(i, result)])."""
    from tpumap.cli import gmap_cli
    from tpumap.gmap.chimera import align_query_chimera
    from tpumap.gmap.engine import GmapConfig
    from tpumap.gmap.stage1 import Stage1Config
    path, items = job
    db, index = _WORKER["db"], _WORKER["index"]
    if path == "paths":
        return [(i, gmap_cli.align_query_paths(db, index, qc, qn,
                                               npaths=NPATHS))
                for i, (qc, qn) in items]
    return [(i, align_query_chimera(db, index, qc, qn, GmapConfig(),
                                    Stage1Config(),
                                    chimera_margin=CHIMERA_MARGIN))
            for i, (qc, qn) in items]


def run_tpumap(path, encoded, dbdir, jobs):
    """tpumap's per-query path ("paths") or chimera path ("chimeras")
    over the encoded queries in jobs worker processes, each query on
    one of them (round robin, in chunks of 8): (results in query order,
    seconds)."""
    import multiprocessing as mp
    import os
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_cpu_multi_thread_eigen=false").strip()
    items = list(enumerate(encoded))
    chunks = [(path, items[i:i + 8]) for i in range(0, len(items), 8)]
    out = [None] * len(encoded)
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(jobs, _tpumap_init,
                                      (dbdir,)) as pool:
        for part in pool.imap_unordered(_tpumap_run, chunks):
            for i, res in part:
                out[i] = res
    return out, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=N_GMAP)
    ap.add_argument("--paths", action="store_true",
                    help="the default path (-n 5) instead of the bulk one")
    ap.add_argument("--chimeras", action="store_true",
                    help="the chimera path (-x 30) over the chimeras")
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the card and compare")
    ap.add_argument("-j", "--jobs", type=int, default=8,
                    help="tpumap worker processes of --paths and "
                         "--chimeras")
    args = ap.parse_args()
    import os
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    from tools import bench_data
    from tpumap.cli import gmap_cli as jcli
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
    cseqs, ctruth = chimera_queries(*gmap_queries(db, N_GMAP))
    cenc = [dna.encode(q) for q in cseqs]
    bulk = not (args.paths or args.chimeras)
    want = {}
    if bulk:
        t0 = time.perf_counter()
        want["bulk"] = jcli.align_queries_bulk(db, DeviceIndex.from_host(db),
                                               enc)
        dt = time.perf_counter() - t0
        found, right = grade_gmap(want["bulk"], truth)
        print(json.dumps({"engine": "tpumap, JAX on the CPU", "path":
                          "bulk (-n 1)", "queries": args.n, "found": found,
                          "exon_structure": right,
                          "floor": round(right - 0.01, 4), "wall_s": dt}),
              flush=True)
    if args.paths:
        want["paths"], dt = run_tpumap("paths", enc, str(dbdir), args.jobs)
        found, right, dist = grade_paths(want["paths"], truth)
        print(json.dumps({"engine": "tpumap, JAX on the CPU", "path":
                          f"per query (-n {NPATHS})", "queries": args.n,
                          "found": found, "exon_structure": right,
                          "floor": round(right - 0.01, 4),
                          "paths_per_query": dist, "wall_s": dt}),
              flush=True)
    if args.chimeras:
        want["chimeras"], dt = run_tpumap("chimeras", cenc, str(dbdir),
                                          args.jobs)
        share = grade_chimeras(want["chimeras"], cseqs, ctruth)
        print(json.dumps({"engine": "tpumap, JAX on the CPU", "path":
                          f"chimeras (-x {CHIMERA_MARGIN})",
                          "queries": len(cseqs), "chimeras_right": share,
                          "floor": round(share - 0.01, 4), "wall_s": dt}),
              flush=True)
    if not args.port:
        return 0
    import torch
    from tpumap_torch.cli import gmap_cli
    from tpumap_torch.gmap import chimera, engine, stage1
    from tpumap_torch.index.build import GenomeDB as TGenomeDB
    from tpumap_torch.index.device import DeviceIndex as TDeviceIndex
    db = TGenomeDB.load(str(dbdir))
    tindex = TDeviceIndex.from_host(db, "cuda")
    runs = {
        "bulk": lambda e: ([gmap_cli.align_queries_bulk(db, tindex, e)], 0),
        "paths": lambda e: run_each(
            lambda qc, qn: gmap_cli.align_query_paths(db, tindex, qc, qn,
                                                      npaths=NPATHS), e),
        "chimeras": lambda e: run_each(
            lambda qc, qn: chimera.align_query_chimera(
                db, tindex, qc, qn, engine.GmapConfig(),
                stage1.Stage1Config(), chimera_margin=CHIMERA_MARGIN), e)}
    for name, ref in want.items():
        e = cenc if name == "chimeras" else enc
        runs[name](e[:64])               # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = runs[name](e)[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if name == "bulk":
            got = got[0]
            keys = [(exon_spans(a), a and a[0].strand) for a in ref], \
                [(exon_spans(b), b and b[0].strand) for b in got]
            grades = dict(zip(("found", "exon_structure"),
                              grade_gmap(got, truth)))
        else:
            keys = [path_key(p) for p in ref], [path_key(p) for p in got]
            grades = (dict(chimeras_right=grade_chimeras(got, cseqs, ctruth))
                      if name == "chimeras" else
                      dict(zip(("found", "exon_structure", "paths_per_query"),
                               grade_paths(got, truth))))
        differ = [i for i, (a, b) in enumerate(zip(*keys)) if a != b]
        print(json.dumps({"engine": "tpumap_torch on " +
                          torch.cuda.get_device_name(0), "path": name,
                          "queries": len(e), **grades, "wall_s": dt,
                          "differ_from_tpumap": len(differ),
                          "first_differing": differ[:10]}), flush=True)
        for i in differ[:3]:
            print(json.dumps({"path": name, "query": i,
                              "tpumap": keys[0][i], "port": keys[1][i]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
