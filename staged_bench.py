#!/usr/bin/env python3
"""The staged-path workloads of chip_smoke.py, and tpumap's results on
them.

The helpers grade and build the workloads without importing JAX or
tpumap (chip_smoke.py grades the port with them): `grade_rna` gives the
mapped fraction and the junction precision and recall of RNA reads
against the generator's truth, `grade_pe` the concordant fraction and
the share of pairs whose mates lie within 10 bp of the plan,
`fusion_reads` the synthetic fusion reads of the rna_fusions phase and
`fusions_found` how many came out as fusion records at their loci,
`genes_map` the bench genes as a genes map IIT's FASTA-format lines.

Run as a script, it runs the four staged phases' workloads through
tpumap (JAX on the CPU) over the bench genome's k=14 index under
.bench_data/ (built there by chip_smoke.py, or here if missing), at
AlignConfig(top_k=4, max_occ=4): rna_twopass (two_pass_align over the
first n RNA reads at batch 16,384; each pass graded apart, pass 2 the
staged path), rna_fusions (the first 16,384 RNA reads and 512 fusion
reads with novel splicing and fusions), rna_tr (the first 16,384 RNA
reads with novel splicing and the bench genes' transcriptome) and
pe_tr (the first 8,192 PE pairs with the transcriptome), and prints
tpumap's grades: the floors chip_smoke.py holds the port to. With
--port it then runs the port on the card over the same workloads and
compares its SAM bytes with tpumap's.

Usage: python3 staged_bench.py [-n 50000] [--port]
"""
import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
BATCH = 16384           # RNA reads a batch (bench.py's RNA leg)
PE_BATCH = 8192         # pairs a batch (bench.py's PE leg)
PAIRMAX = 1000
N_FUSION = 512          # synthetic fusion reads of rna_fusions
FUSION_SEED = 4242
MAX_INTRON = 200_000    # align_records' default
_COMP = str.maketrans("ACGT", "TGCA")


def junctions(pos: int, cigar: str):
    """Genomic (donor, acceptor) pairs of a record (bench.py
    _cigar_junctions; the bench genome is one chromosome)."""
    js, cur, num = [], pos - 1, 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
            continue
        if ch == "N":
            js.append((cur, cur + num))
        if ch in "MDN=X":
            cur += num
        num = 0
    return js


def grade_rna(sam_bytes: bytes, truth):
    """(mapped fraction, junction precision, junction recall) against
    the generator's truth, as bench.py grades the RNA leg."""
    lines = sam_bytes.decode().splitlines()
    if len(lines) != len(truth):
        raise AssertionError(f"{len(lines)} SAM lines for {len(truth)} reads")
    tp = fp = fn = mapped = 0
    for line, (tjs, _start) in zip(lines, truth):
        f = line.split("\t", 6)
        pjs = set(junctions(int(f[3]), f[5]))
        mapped += not int(f[1]) & 4
        tp += len(pjs & tjs)
        fp += len(pjs - tjs)
        fn += len(tjs - pjs)
    return (mapped / len(truth), tp / max(tp + fp, 1),
            tp / max(tp + fn, 1))


def grade_pe(sam_bytes: bytes, bench_data, n=None):
    """(concordant fraction as bench.py:323-326 computes it, fraction of
    the first n pairs of the plan (all by default) whose mates both lie
    within 10 bp of the plan: mate 1 forward at the fragment start, mate
    2 reverse at start + length - 100)."""
    plan = bench_data.pe_read_plan()[:n]
    first = conc = 0
    near = np.zeros((len(plan), 2), bool)
    for line in sam_bytes.decode().splitlines():
        f = line.split("\t", 6)
        flag = int(f[1])
        if flag & 0x900:
            continue
        if flag & 0x40:
            first += 1
            conc += bool(flag & 2)
        if flag & 4:
            continue
        i = int(f[0].split("/")[0][1:])
        start, fl, _s1, _s2 = plan[i]
        mate2 = bool(flag & 0x80)
        want = start + fl - bench_data.READ_LEN if mate2 else start
        near[i, int(mate2)] = (abs(int(f[3]) - 1 - want) <= 10
                               and bool(flag & 16) == mate2)
    return conc / max(first, 1), float(near.all(axis=1).mean())


def fusion_reads(db, n: int = N_FUSION):
    """n reads of 60 + 40 bases from two loci of the genome more than
    MAX_INTRON apart, every other one with its 40 bases reverse
    complemented (an inversion): ([(name, sequence)], truth [(a, b,
    inverted)] with a and b the pieces' 0-based leftmost coordinates)."""
    rng = np.random.default_rng(FUSION_SEED)
    glen = db.genome_length
    reads, truth = [], []
    for i in range(n):
        a = int(rng.integers(0, glen - 100))
        b = int(rng.integers(0, glen - 100))
        while abs(b - a) <= MAX_INTRON + 100:
            b = int(rng.integers(0, glen - 100))
        inv = i % 2 == 1
        tail = db.get_seq(b, 40)
        reads.append((f"fu{i}", db.get_seq(a, 60)
                      + (tail.translate(_COMP)[::-1] if inv else tail)))
        truth.append((a, b, inv))
    return reads, truth


def fusions_found(sam_bytes: bytes, truth):
    """Fusion reads that came out as a primary and a supplementary record
    whose positions are the two pieces' loci (within 10 bp)."""
    recs = {}
    for line in sam_bytes.decode().splitlines():
        f = line.split("\t", 6)
        if f[0].startswith("fu"):
            recs.setdefault(int(f[0][2:]), []).append((int(f[1]),
                                                       int(f[3]) - 1))
    found = 0
    for i, (a, b, _inv) in enumerate(truth):
        got = sorted(recs.get(i, []), key=lambda t: t[1])
        found += (len(got) == 2
                  and sum(bool(fl & 0x800) for fl, _p in got) == 1
                  and all(abs(p - x) <= 10
                          for (_f, p), x in zip(got, sorted((a, b)))))
    return found


def rna_fusion_lines(sam_bytes: bytes) -> bytes:
    """The RNA reads' primary lines of an rna_fusions run (no fusion
    read, no supplementary record)."""
    return b"".join(ln + b"\n" for ln in sam_bytes.split(b"\n")
                    if ln and not ln.startswith(b"fu")
                    and not int(ln.split(b"\t", 2)[1]) & 0x800)


def genes_map(bench_data):
    """The bench genes (plus strand, chr1) as a genes map IIT's
    FASTA-format lines (gff3_genes | iit_store's input)."""
    lines = []
    for g, exons in enumerate(bench_data.gene_table()):
        s0, (se, ne) = exons[0][0], exons[-1]
        lines += [f">TR{g} chr1:{s0 + 1}..{se + ne} gene", f"GENE{g} NM_{g}"]
        lines += [f"{s + 1} {s + n}" for s, n in exons]
    return lines


def sam_of(recs) -> bytes:
    return b"".join(r.lines().encode() for r in recs)


def two_passes(twopass_mod, driver_mod, *args, **kw):
    """two_pass_align with each pass's align_records call recorded:
    [(SAM bytes, wall s)] for passes 1 and 2, and the learned tables."""
    inner, passes, tables = driver_mod.align_records, [], {}

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = inner(*a, **k)
        passes.append((sam_of(out), time.perf_counter() - t0))
        tables["known_indels"] = k.get("known_indels")
        return out
    driver_mod.align_records = timed
    try:
        _recs, ks = twopass_mod.two_pass_align(*args, **kw)
    finally:
        driver_mod.align_records = inner
    return passes, ks, tables["known_indels"]


def run_workloads(pkg, db, index, tr_index, bench_data, n_twopass):
    """The four workloads through one package (pkg: its modules): a
    list of (workload, SAM bytes, wall s, grades)."""
    rna = list(pkg.read_fasta(bench_data.ensure_rna_files()[1]))
    truth = bench_data.rna_truth()
    cfg = pkg.AlignConfig(top_k=4, max_occ=4)
    out = []
    passes, ks, ki = two_passes(pkg.twopass, pkg.driver, db, index,
                                rna[:n_twopass], cfg, batch_size=BATCH)
    for k, (sam, dt) in enumerate(passes):
        out.append((f"rna_twopass pass {k + 1}", sam, dt, dict(zip(
            ("mapped_frac", "junction_precision", "junction_recall"),
            grade_rna(sam, truth[:n_twopass])))))
    out[-1][3].update(known_splicing_sites=ks.nsites,
                      known_indel_sites=0 if ki is None else ki.nsites)
    fu, ftruth = fusion_reads(db)
    reads = rna[:BATCH] + [pkg.Record(n, "", s) for n, s in fu]
    t0 = time.perf_counter()
    sam = sam_of(pkg.driver.align_records(
        db, index, reads, cfg, novelsplicing=True, find_fusions=True,
        batch_size=BATCH))
    g = dict(zip(("mapped_frac", "junction_precision", "junction_recall"),
                 grade_rna(rna_fusion_lines(sam), truth[:BATCH])))
    g["fusions_found"] = fusions_found(sam, ftruth)
    out.append(("rna_fusions", sam, time.perf_counter() - t0, g))
    trans = pkg.build_transcriptome(db, pkg.build_iit(pkg.parse_map_fasta(
        genes_map(bench_data))))
    t0 = time.perf_counter()
    sam = sam_of(pkg.driver.align_records(
        db, index, rna[:BATCH], cfg, novelsplicing=True, batch_size=BATCH,
        tr=(trans, tr_index(trans.trdb))))
    out.append(("rna_tr", sam, time.perf_counter() - t0, dict(zip(
        ("mapped_frac", "junction_precision", "junction_recall"),
        grade_rna(sam, truth[:BATCH])))))
    f1, f2 = bench_data.ensure_pe_files()
    pairs = list(zip(pkg.read_fasta(f1), pkg.read_fasta(f2)))[:PE_BATCH]
    t0 = time.perf_counter()
    sam = b"".join(sam_of(p) for p in pkg.paired.align_paired_records(
        db, index, pairs, cfg, batch_size=PE_BATCH, pairmax=PAIRMAX,
        tr=(trans, None)))
    out.append(("pe_tr", sam, time.perf_counter() - t0, dict(zip(
        ("concordant_frac", "pairs_within_10bp"),
        grade_pe(sam, bench_data, PE_BATCH)))))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=50_000,
                    help="RNA reads of the two-pass workload")
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the card and compare")
    args = ap.parse_args()
    import os
    import types
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    from tools import bench_data
    from tpumap.gsnap import driver, paired, twopass
    from tpumap.gsnap.engine import AlignConfig
    from tpumap.gsnap.transcriptome import build_transcriptome
    from tpumap.index import GenomeDB, build_db
    from tpumap.index.device import DeviceIndex
    from tpumap.io.fasta import Record, read_fasta
    from tpumap.io.iit import build_iit, parse_map_fasta

    bench_data.ROOT = ROOT / ".bench_data"
    gfa, _rfa = bench_data.ensure_files()
    dbdir = bench_data.ROOT / "db_k14"
    if (dbdir / "meta.json").exists():
        db = GenomeDB.load(str(dbdir))
    else:
        db = build_db(gfa, name="bench", k=14, interval=3)
        db.save(str(dbdir))
    pkg = types.SimpleNamespace(
        driver=driver, paired=paired, twopass=twopass,
        AlignConfig=AlignConfig, build_transcriptome=build_transcriptome,
        Record=Record, read_fasta=read_fasta, build_iit=build_iit,
        parse_map_fasta=parse_map_fasta)
    want = run_workloads(pkg, db, DeviceIndex.from_host(db),
                         DeviceIndex.from_host, bench_data, args.n)
    for name, _sam, dt, g in want:
        print(json.dumps({"engine": "tpumap, JAX on the CPU",
                          "workload": name, "wall_s": dt, **g}), flush=True)
    if not args.port:
        return 0
    import torch
    from tpumap_torch.gsnap import driver as tdriver
    from tpumap_torch.gsnap import paired as tpaired
    from tpumap_torch.gsnap import twopass as ttwopass
    from tpumap_torch.gsnap.engine import AlignConfig as TAlignConfig
    from tpumap_torch.gsnap.transcriptome import \
        build_transcriptome as tbuild
    from tpumap_torch.index.device import DeviceIndex as TDeviceIndex
    from tpumap_torch.io import fasta as tfasta
    from tpumap_torch.io import iit as tiit
    tpkg = types.SimpleNamespace(
        driver=tdriver, paired=tpaired, twopass=ttwopass,
        AlignConfig=TAlignConfig, build_transcriptome=tbuild,
        Record=tfasta.Record, read_fasta=tfasta.read_fasta,
        build_iit=tiit.build_iit, parse_map_fasta=tiit.parse_map_fasta)
    got = run_workloads(tpkg, db, TDeviceIndex.from_host(db, "cuda"),
                        lambda d: TDeviceIndex.from_host(d, "cuda"),
                        bench_data, args.n)
    for (name, sam, dt, g), (_n, wsam, _w, _g) in zip(got, want):
        lines, wlines = sam.splitlines(), wsam.splitlines()
        differ = [i for i, (a, b) in enumerate(zip(lines, wlines)) if a != b]
        print(json.dumps({"engine": "tpumap_torch on "
                          + torch.cuda.get_device_name(0), "workload": name,
                          "wall_s": dt, **g, "sam_identical": sam == wsam,
                          "lines_differing": len(differ)
                          + abs(len(lines) - len(wlines))}), flush=True)
        for i in differ[:3]:
            print(json.dumps({"line": i, "tpumap": wlines[i].decode(),
                              "port": lines[i].decode()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
