#!/usr/bin/env python3
"""End to end of one tree of the PyTorch port on some of chip_smoke.py's
phases, for A/B comparisons of two trees on one NVIDIA GPU.

Imports tpumap_torch from TREE (default: this checkout) and drives each
PHASE on chip_smoke.py's bench data (its .bench_data/ beside this
script, built there if missing) as chip_smoke.py does: rna (the 50,000
RNA reads, novelsplicing=True, batch 16,384), rna_known (the same with
the bench genes' junctions as known sites) or snp (the 50,000 DNA reads
with the alt alleles in, snp_tolerant=True on the mode db, batch
32,768). A phase runs one warm-up call, then RUNS timed runs of all the
reads (reads/s and chip_smoke's accuracy floors), then the device time
of one batch with the parts of K5, K3, K6a and K6b (torch.profiler),
then a host profile (cProfile) of one batch: its wall time and the
functions that took the most of it. With --kernels it first runs K6a's
rows at the path's fragment lengths and all of K6b's
(chip_smoke.scan_fragment_rows and scan_exact_rows: exact against the
plain version, device ms per launch). With --sass DIR it first reads the
tree's kernel library with cuobjdump: for each window-scan kernel
(K6a-c) its instruction count and a hash of its instructions, with each
scan's SASS written to DIR. JAX and tpumap are blocked, as in
chip_smoke.py. Each tree runs in its own process, so an A/B comparison
alternates processes:

    for t in A B B A; do python3 phase_ab.py --tree $t --phase rna snp; done

Usage: python3 phase_ab.py [--tree DIR] [--phase [P ...]] [--kernels]
                           [--sass DIR] [--runs N] [--top N]
"""
import argparse
import cProfile
import hashlib
import io
import pathlib
import pstats
import re
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
# every K6a instance of this tree and of earlier ones, and K6b
PARTS = (("K5", "chain_kernel"), ("K3", "traceback_kernel"),
         ("K6a", "localscan_kernel<0"), ("K6b", "exact_sites_kernel"))


def sass_report(lib: str, out_dir: pathlib.Path, tag: str, smi: str):
    """cuobjdump -sass of the kernel library: each window-scan kernel's
    instruction count and the hash of its instructions (addresses left
    out), to see that a change left an instance's SASS as it was. Each
    scan's SASS goes to out_dir/{tag}_{kernel}.sass."""
    import chip_smoke as cs
    from tpumap_torch import kernels
    tool = pathlib.Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    for part in text.split("Function : ")[1:]:
        name = cs.kernel_name(part.split(None, 1)[0])
        if not name.startswith(("localscan_kernel", "exact_sites_kernel")):
            continue
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part)
        digest = hashlib.sha256(
            "\n".join(t.strip() for t in ins).encode()).hexdigest()[:16]
        fname = re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_")
        (out_dir / f"{tag}_{fname}.sass").write_text(part)
        cs.log(f"sass {tag} {name}: {len(ins)} instructions, hash "
               f"{digest} [{smi}]")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE),
                    help="checkout whose tpumap_torch is timed")
    ap.add_argument("--phase", nargs="*", default=["rna"],
                    choices=["rna", "rna_known", "snp"])
    ap.add_argument("--kernels", action="store_true",
                    help="first K6a's and K6b's rows at the path's "
                    "fragment lengths")
    ap.add_argument("--sass", metavar="DIR",
                    help="first the window scans' SASS, written to DIR")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--top", type=int, default=15,
                    help="functions of the host profile to print")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs          # blocks jax and tpumap on import
    sys.path.insert(0, str(tree))    # tpumap_torch from the tree
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("phase_ab: no CUDA device\n")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    from tpumap_torch import kernels
    from tpumap_torch.gsnap.driver import align_records
    from tpumap_torch.gsnap.engine import AlignConfig
    from tpumap_torch.index.device import DeviceIndex
    from tpumap_torch.io.fasta import read_fasta
    import tpumap_torch
    pkg = pathlib.Path(tpumap_torch.__file__).resolve().parent
    if pkg.parent != tree:
        raise AssertionError(f"tpumap_torch imported from {pkg}, not {tree}")

    lib = kernels.build()
    if args.sass:
        sass_report(lib._name, pathlib.Path(args.sass), tree.name, smi)
    if not (args.kernels or args.phase):
        return 0
    bench_data, db, rfa = cs.load_index(smi)
    index = DeviceIndex.from_host(db, "cuda")
    if args.kernels:
        rows = cs.scan_fragment_rows(index) + cs.scan_exact_rows(index)
        for r in rows:
            if r["max_abs_err"] != 0:
                raise AssertionError(f"{r['name']} disagrees with its plain "
                                     f"version at {r['shape']}")
        cs.log(f"tree {tree.name}:")
        cs.profile_rows(rows, smi, {})

    for phase in args.phase:
        config = AlignConfig(top_k=4, max_occ=4)
        gdb, idx, batch, kw = db, index, cs.RB, {"novelsplicing": True}
        if phase == "snp":
            mdb, coords, alts = cs.load_mode_index(bench_data, db, smi)
            gdb, idx, batch, kw = mdb, DeviceIndex.from_host(mdb, "cuda"), \
                cs.B, {}
            config = AlignConfig(snp_tolerant=True, top_k=4, max_occ=4)
            reads, n_alt = cs.snp_reads(bench_data, coords, alts)

            def check(sam):
                return cs.check_snp(sam, bench_data, n_alt)
        else:
            _gfa, rna_rfa = bench_data.ensure_rna_files()
            reads = list(read_fasta(rna_rfa))
            truth = bench_data.rna_truth()
            if phase == "rna_known":
                kw["known"] = cs.gene_known(bench_data)

            def check(sam):
                return cs.check_rna(sam, truth)

        def run(items, sink):
            align_records(gdb, idx, items, config, batch_size=batch,
                          sink=sink, **kw)
            torch.cuda.synchronize()

        t0 = time.perf_counter()
        run(reads[:batch], io.BytesIO().write)
        cs.log(f"tree {tree.name}: {phase} warm-up "
               f"{time.perf_counter() - t0:.2f} s [{smi}]")
        walls = []
        for i in range(args.runs):
            buf = io.BytesIO()
            t0 = time.perf_counter()
            run(reads, buf.write)
            dt = time.perf_counter() - t0
            walls.append(dt * 1e3 / -(-len(reads) // batch))
            cs.log(f"tree {tree.name}: {phase} run {i}: {len(reads)} reads "
                   f"at batch {batch} in {dt:.3f} s = "
                   f"{len(reads) / dt:.1f} reads/s, "
                   f"{check(buf.getvalue())} [{smi}]")
        cs.profile_batch(f"tree {tree.name}: {phase}",
                         lambda: run(reads[:batch], io.BytesIO().write),
                         min(walls), smi, PARTS)

        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        run(reads[:batch], io.BytesIO().write)
        prof.disable()
        dt = time.perf_counter() - t0
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(
            args.top)
        cs.log(f"tree {tree.name}: host profile of one {phase} batch of "
               f"{batch} reads, {dt * 1e3:.1f} ms of wall under cProfile "
               f"[{smi}]")
        cs.log(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
