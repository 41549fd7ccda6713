#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpumap_torch) on one NVIDIA GPU.

Runs the port's main paths through the fused ladder and the native SAM
emitter — single-end DNA at the repo's headline DNA size, single-end RNA
with novel splicing and with known splicing (-s) at the bench's RNA
size, paired-end DNA at the bench's PE size, paired RNA through the
mate repair, and bisulfite (cmet) and SNP-tolerant DNA at the DNA size
— and GMAP's bulk path over 2,048 cDNAs, and fails (exit code != 0) if
any phase fails:

1. card name and power limit; build the CUDA kernels from csrc/ (each
   kernel instance's ptxas registers, stack and spills; no K5 instance,
   not the K2 instance of the indel band, not K3, no K6a instance and
   not K6b, no K7a instance nor K7b function may have a stack frame or
   spills); the port's native host library must load; the latency of a
   chain of
   dependent shared-memory loads (one and two a step, one thread), for
   the floor of K3's walk, and of a dependent first-maximum reduction
   (one warp with shuffles only, and blocks of 64-512 threads), for the
   floor of K7a's DP;
2. the chr21-scale bench genome (46.7 Mbp, tools/bench_data.py) and
   its k=14, interval-3 index, uploaded to the card;
3. every kernel at its main-path shapes against its plain PyTorch
   version on the same CUDA tensors: exact equality, the wrapper's and
   the plain version's median time per call, the kernel's device time
   per launch, and the bound of the work (the larger of its bytes over
   the HBM rate and its operations over their pipe's rate; with the
   mate rescue's K1 at [512, 1000], K5 with known-site masks at R =
   8,192 and 14 lanes, K5 on 64 reads of 7,169-7,680 bases at L = 7,680
   and 14 lanes (past pathdp.chain_max_len: its choice table in global
   memory; one plain run), K3 at R = 256, Lq = 512 and at R = 32,
   Lq = 7,680 (one plain run), K6a at the mate repair's W = 1,024 and
   with the path's fragment lengths, 6-16, over the bench genome and over
   a poly-A genome with all-A fragments, and K6b with the splice-end
   review's fragment lengths (with and without its empty rows, and at 3
   and 10 bases alone) over the bench genome and with all-A fragments
   over the poly-A genome);
4. DNA end to end: one warm-up call, then align_records over all 50,000
   100-bp reads at batch size 32,768 with launch counters reset just
   before; reads/s, aligned fraction and agreement with the generator's
   truth (>= 99% within 10 bp on the truth strand); the DNA kernels
   (K1-K3) must have launched;
5. RNA end to end: the bench's 50,000 RNA reads (40% spliced) with
   novelsplicing=True at batch size 16,384, one warm-up call, then the
   timed run with launch counters reset; reads/s, mapped fraction and
   junction precision and recall against the generator's truth (>= 0.99
   mapped, >= 0.99 precision, >= 0.95 recall); all seven kernels must
   have launched;
6. RNA with known splicing: the same 50,000 reads with novelsplicing=True
   and the bench genes' junctions as a KnownSplicing, batch 16,384, one
   warm-up call, then the timed run; reads/s and the floors of 5; all
   seven kernels must have launched (K5 with 14 lanes and known-site
   masks);
7. paired-end DNA: the bench's 20,000 FR pairs (tools/bench_data.py),
   8,192 pairs per batch, pairmax 1,000, one warm-up call, then the
   timed run; reads/s (2 x pairs), the concordant fraction as bench.py
   computes it and the pairs whose mates both lie within 10 bp of the
   plan (>= 0.99 each); the DNA kernels (K1-K3) must have launched;
8. paired RNA through the mate repair: 512 pairs from the bench genes
   (mate 1 inside an exon, mate 2 the reverse complement of a read
   across the gene's next junction, introns of 200 or 1,000 bp),
   novelsplicing=True, pairmax 2,000; the rescue and the repair must
   have run (K1 at [512, 2000], K6a at W = 2,000, K5), and all seven
   kernels launched;
9. bisulfite (cmet) end to end on a second index, the k=14 db with its
   ct and ga tables and a SNP index of ~155,000 SNPs (one per 300 bp,
   the density of a common-SNP catalogue), cached under
   .bench_data/db_k14_modes/: the 50,000 DNA reads with every C turned
   into T unless a G follows it (a directional library, CpGs
   methylated), mode cmet-stranded, max_occ 32, batch 32,768, one
   warm-up call, then the timed run; reads/s, aligned fraction and
   within 10 bp of truth (>= 0.274 and 0.270: tpumap's semantics, see
   check_cmet); K1 must have launched;
10. SNP-tolerant end to end on that index: the 50,000 DNA reads of the
   plan regenerated with every SNP they cover set to its alt allele;
   reads/s, aligned fraction, within 10 bp (>= 0.99 each), and the sum
   of XV:i: over the primary lines against the alt alleles in the reads
   (>= 0.95); K1 must have launched;
11. the first 2,048 DNA reads, the first 512 RNA reads (novel, and with
   known splicing), the first 2,048 PE pairs, the 512 repair pairs, the
   first 2,048 cmet and SNP reads, the first 512 RNA reads as cmet with
   novel splicing and 512 PE pairs as cmet (both mates C->T) through the
   port on the CPU (plain versions) and on the GPU with the same
   batching: byte-identical SAM; and the first 256 GMAP cDNAs of 12:
   byte-identical GFF3 (-f 3 and -f 2);
12. GMAP end to end on the k=14 index: 2,048 cDNAs made as
   tools/bench_gmap.make_queries makes them (gmap_bench.py, seed 7, 2-5
   exons of 100-399 bp, introns of 200-4,999 bp), one warm-up call on
   the first 256, then align_queries_bulk over all 2,048 with launch
   counters reset; queries/s, the found fraction (>= 0.99) and the
   share whose exon count equals the truth with every exon end within
   10 bp (>= GMAP_FLOOR, tpumap's own share less 0.01); K7a and K7b
   must have launched. Their rows (phase 3's columns) come after it, at
   the shapes of its largest calls (logged from its timed run), of the
   80-exon 8-kbp query of tests/test_gmap_e2e.py (S = 512, Rp =
   131,072), and of poly-A windows under keep_overabundant.

Phase 3 also holds K1 against its plain version on the mode index: in
each base space at the mode rung's [32,768, 8] x 8, ref-OR-alt at the
SNP standard path's [65,536, 8] x 3, and cmet with SNPs at [32,768, 8]
x 8.

Every profile waits until the timed runs and the GPU half of 11 are
over: each kernel row's device time per call (torch.profiler, all the
kernel's functions; K7b's library call, torch.sort, is timed the same
way beside its CUDA-event time), K7a's gap-cost table fill, and one
batch of phases 4-7, 9 and 10 (its device time and the parts of K5, K3,
each K6a instance and K6b against the timed run's wall time per batch)
and the GMAP call (with the parts of K7a and K7b),
and K3's walk floor (its longest walk times the chain's step); then the
fragment lengths that reach K6a and K6b in one batch of RNA, RNA -s and
the repair (with K6b's active share and counts). After the runs: each
kernel's launches per batch on each path (from kernels.LAUNCHES). The
line before the last is the kernel table as JSON; the last line is {"ok": true,
"device": {...}}. JAX and tpumap are blocked: the port must run without
either. Bench data and the index go under .bench_data/ in the checkout.
Usage: python3 chip_smoke.py
"""
import contextlib
import ctypes
import io
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
from functools import partial

sys.modules["jax"] = None          # any JAX import now raises
sys.modules["tpumap"] = None       # and any import of tpumap or tpumap.*

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
B = 32768
N_CPU = 2048
RB = 16384              # RNA batch (bench.py's RNA leg)
N_CPU_RNA = 512
PB = 8192               # pairs per PE batch (bench.py's PE leg)
PAIRMAX = 1000
N_CPU_PE = 2048
N_REPAIR = 512          # paired RNA pairs through the mate repair
SNP_EVERY = 300         # bp per SNP of the SNP index
CMET = "cmet-stranded"
INVALID = 0xFFFFFFFF
# K6b's integer operations a window word at fragment length f are
# 2 f + EXACT_OPS: f - 1 funnel shifts and f xor-ors for the match mask,
# a funnel shift to align the window, a LOP3 for the fold (its shift can
# issue on the FMA pipe as a doubling), and for each two words a LOP3
# that merges their masks and an add of the popcount
EXACT_OPS = 2
# rows reaching K6b by fragment length (0-10) in one RNA, one RNA -s and
# one PE repair batch together, as frag_lengths logs them on the H100
PATH_LENGTHS = (4571, 0, 0, 6, 0, 6, 2, 4, 5, 8, 6)
# the H100 SXM's peak rates for the bound of a kernel's work: HBM3 at
# 3.35 TB/s (NVIDIA's H100 data sheet), int32 ALU operations at 132 SMs
# x 64 INT32 lanes x 1.98 GHz boost (NVIDIA's Hopper white paper), and
# popcounts, which issue on a pipe of their own, at 16 a clock per SM
# (CUDA C Programming Guide, arithmetic instructions, compute capability
# 9.0). A shift or a doubling can issue on the FMA pipe as a multiply,
# so the operation counts leave it out.
HBM_BPS = 3.35e12
INT_OPS = 132 * 64 * 1.98e9
POPC_OPS = 132 * 16 * 1.98e9
DNA_KERNELS = ("verify_diagonals", "banded_align", "traceback")
GSNAP_KERNELS = DNA_KERNELS + ("chain_dp", "scan_fragment",
                               "scan_exact_sites", "scan_fragment_runs")
GMAP_KERNELS = ("chain_segments", "region_anchors")
GMAP_WARM = 256         # cDNAs of the GMAP warm-up call and of the CPU run
# the exon-structure floor of the GMAP phase: tpumap's own share on the
# same 2,048 cDNAs, 0.923828125 (gmap_bench.py, JAX on the CPU of the
# H100 machine), less 0.01
GMAP_FLOOR = 0.913828125
# K7b's four kernels, launched in turn by each call
K7B_FUNCS = ("region_anchors_count_kernel", "region_anchors_scan_kernel",
             "region_anchors_place_kernel", "region_anchors_fill_kernel")
# each kernel's source, the TPU function it replaces, and the names of
# its __global__ functions (for its device time in the profile), each
# launched once a call but K7a's gap-cost table fill, which runs once a
# device (its time logged apart)
SOURCES = {
    "verify_diagonals": ("tpumap_torch/csrc/verify.cu",
                         "tools/pallas_verify_experiment.py:100",
                         ("verify_kernel",)),
    "banded_align": ("tpumap_torch/csrc/dp.cu", "tpumap/ops/dp.py:53",
                     ("banded_kernel",)),
    "traceback": ("tpumap_torch/csrc/traceback.cu", "tpumap/ops/dp.py:154",
                  ("traceback_kernel",)),
    "chain_dp": ("tpumap_torch/csrc/chain.cu", "tpumap/ops/pathdp.py:110",
                 ("chain_kernel",)),
    "scan_fragment": ("tpumap_torch/csrc/localscan.cu",
                      "tpumap/ops/localscan.py:68", ("localscan_kernel",)),
    "scan_exact_sites": ("tpumap_torch/csrc/localscan.cu",
                         "tpumap/ops/localscan.py:118",
                         ("exact_sites_kernel",)),
    "scan_fragment_runs": ("tpumap_torch/csrc/localscan.cu",
                           "tpumap/ops/localscan.py:148",
                           ("localscan_kernel",)),
    "chain_segments": ("tpumap_torch/csrc/gmapchain.cu",
                       "tpumap/ops/chain.py:166",
                       ("chain_segments_kernel", "chain_gap_table_kernel")),
    "region_anchors": ("tpumap_torch/csrc/gmapchain.cu",
                       "tpumap/ops/chain.py:63", K7B_FUNCS),
}


# A chain of dependent shared-memory loads in one thread, for the floor
# of K3's walk: each step reads LOADS 16-bit entries in turn, each the
# byte offset of the next read (K3's step reads a cell, then a decode-
# table entry); clock64 around the chain gives its cycles.
CHAIN_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <int LOADS>
__global__ void chain(const uint16_t* init, int n, int steps,
                      long long* cycles, uint32_t* sink) {
  extern __shared__ __align__(16) unsigned char buf[];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    ((uint16_t*)buf)[i] = init[i];
  __syncthreads();
  if (threadIdx.x) return;
  uint32_t p = 0;
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s)
#pragma unroll
    for (int l = 0; l < LOADS; ++l) p = *(const uint16_t*)(buf + p);
  cycles[0] = clock64() - t0;
  sink[0] = p;
}
extern "C" int smem_chain(const void* init, int n, int steps, int loads,
                          void* cycles, void* sink) {
  auto k = loads == 1 ? chain<1> : chain<2>;
  k<<<1, 128, 2 * n>>>((const uint16_t*)init, n, steps, (long long*)cycles,
                       (uint32_t*)sink);
  return (int)cudaGetLastError();
}
// A first-maximum DP's step without its arithmetic: steps dependent
// block-wide first-maximum reductions in one block, each thread's
// candidate read
// from the score the step before wrote (shuffles in the warps, one
// thread over the warp maxima, two barriers)
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}
__global__ void reduce_chain(int steps, long long* cycles, float* sink) {
  __shared__ float score[1024];
  __shared__ float rv[32];
  __shared__ int ri[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  score[t] = (float)(t * 7 % 13);
  __syncthreads();
  const long long t0 = clock64();
  for (int j = 0; j < steps; ++j) {
    float v = __fsub_rn(score[t], 0.01f * (float)(t & 7));
    int i = t;
    for (int off = 16; off; off >>= 1) {
      const float v2 = __shfl_down_sync(0xFFFFFFFFu, v, off);
      const int i2 = __shfl_down_sync(0xFFFFFFFFu, i, off);
      better(v, i, v2, i2);
    }
    if (lane == 0) { rv[warp] = v; ri[warp] = i; }
    __syncthreads();
    if (t == 0) {
      float bv = rv[0];
      int bi = ri[0];
      for (int x = 1; x < nw; ++x) better(bv, bi, rv[x], ri[x]);
      score[(j + bi) % blockDim.x] = bv + 1.0f;
    }
    __syncthreads();
  }
  if (t == 0) { cycles[0] = clock64() - t0; sink[0] = score[0]; }
}
// the same step in one warp, shuffles only (K7a's step: a problem a
// warp): each lane's score in a register, an xor-shuffle first maximum
// that every lane gets, the step's lane keeping it
__global__ void warp_chain(int steps, long long* cycles, float* sink) {
  const int t = threadIdx.x;
  float score = (float)(t * 7 % 13);
  const long long t0 = clock64();
  for (int j = 0; j < steps; ++j) {
    float v = __fsub_rn(score, 0.01f * (float)(t & 7));
    int i = t;
    for (int off = 16; off; off >>= 1) {
      const float v2 = __shfl_xor_sync(0xFFFFFFFFu, v, off);
      const int i2 = __shfl_xor_sync(0xFFFFFFFFu, i, off);
      better(v, i, v2, i2);
    }
    if (t == ((j + i) & 31)) score = v + 1.0f;
  }
  if (t == 0) cycles[0] = clock64() - t0;
  sink[t] = score;
}
extern "C" int block_reduce(int threads, int steps, void* cycles,
                            void* sink) {
  if (threads == 32)
    warp_chain<<<1, 32>>>(steps, (long long*)cycles, (float*)sink);
  else
    reduce_chain<<<1, threads>>>(steps, (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}
"""


def log(*a):
    print(*a, flush=True)


def start_chain_build():
    """Start nvcc on CHAIN_SRC (beside the kernels' build); returns the
    library's path and the process."""
    from tpumap_torch import kernels
    out = ROOT / "tpumap_torch" / "_build" / "chain_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "chain.cu").write_text(CHAIN_SRC)
    lib = out / "libchain.so"
    return lib, subprocess.Popen(
        [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
         str(out / "chain.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def shared_chain_ns(lib, proc, smi):
    """{loads: ns per step} of a chain of dependent shared-memory loads,
    one or two a step, in one thread over 2^18 steps of a random cycle
    through 2,048 entries (CUDA events around the launch; clock64's
    cycles a step logged beside)."""
    msg = proc.communicate()[0]
    if proc.returncode:
        raise AssertionError(f"nvcc failed on the chain probe:\n{msg}")
    fn = ctypes.CDLL(str(lib)).smem_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    n, steps = 2048, 1 << 18
    perm = np.random.default_rng(5).permutation(n)
    nxt = np.empty(n, np.uint16)
    nxt[perm] = 2 * np.roll(perm, -1)       # byte offset of the next entry
    init = torch.from_numpy(nxt.view(np.int16)).cuda()
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = {}
    for loads in (1, 2):
        def run():
            if fn(init.data_ptr(), n, steps, loads, cycles.data_ptr(),
                  sink.data_ptr()):
                raise AssertionError("the chain probe did not launch")
        out[loads] = cuda_ms(run, 5) * 1e6 / steps
        log(f"shared-memory chain, {loads} dependent load(s) a step: "
            f"{out[loads]:.2f} ns, {int(cycles) / steps:.1f} cycles a step "
            f"[{smi}]")
    return out


def block_reduce_ns(lib, smi):
    """{threads: ns per step} of a chain of dependent block-wide
    first-maximum reductions in one warp with shuffles only (CHAIN_SRC's
    warp_chain) and in one block of 64, 128, 256 and 512 threads
    (reduce_chain) over 4,096 steps (CUDA events around the launch;
    clock64's cycles a step logged beside). The one-warp step is the
    floor of a K7a step at any S."""
    fn = ctypes.CDLL(str(lib)).block_reduce
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    steps = 4096
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, dtype=torch.float32, device="cuda")
    out = {}
    for threads in (32, 64, 128, 256, 512):
        def run():
            if fn(threads, steps, cycles.data_ptr(), sink.data_ptr()):
                raise AssertionError("the reduction probe did not launch")
        out[threads] = cuda_ms(run, 5) * 1e6 / steps
        log(f"dependent first-maximum reduction, {threads} threads: "
            f"{out[threads]:.2f} ns, {int(cycles) / steps:.1f} cycles a "
            f"dependent step [{smi}]")
    return out


def frag_lengths(name, one_batch, smi):
    """The fragment lengths that reach K6a and K6b in one batch, counted
    on the device around each call. K6a: the calls (rows, window, top_k)
    and the rows' shares by length (0, 1-5, 6-15, 16). K6b: the calls,
    the rows, the active share (length > 0), the shares by length (0,
    1-2, 3-5, 6-10, 11-16) and the mean and largest count of exact
    placements of an active row."""
    from tpumap_torch.ops import localscan
    inner, inner_b = localscan.scan_fragment, localscan.scan_exact_sites
    calls, calls_b = [], []
    hist = torch.zeros(17, dtype=torch.int64, device="cuda")
    hist_b = torch.zeros(17, dtype=torch.int64, device="cuda")
    counts = []

    def counted(genome, ws, frag, flen, window, max_frag, top_k=4):
        calls.append((ws.shape[0], window, top_k))
        hist.add_(torch.bincount(flen.clamp(0, 16).to(torch.int64),
                                 minlength=17))
        return inner(genome, ws, frag, flen, window, max_frag, top_k)

    def counted_b(genome, ws, frag, flen, window, max_frag, top_k=8):
        calls_b.append((ws.shape[0], window, top_k))
        hist_b.add_(torch.bincount(flen.clamp(0, 16).to(torch.int64),
                                   minlength=17))
        pos, count = inner_b(genome, ws, frag, flen, window, max_frag, top_k)
        counts.append(count[flen > 0])
        return pos, count

    localscan.scan_fragment = counted
    localscan.scan_exact_sites = counted_b
    try:
        one_batch()
    finally:
        localscan.scan_fragment = inner
        localscan.scan_exact_sites = inner_b
    h = hist.cpu().numpy()
    n = max(int(h.sum()), 1)
    log(f"{name}: K6a calls of one batch (rows, window, top_k) {calls}; "
        f"rows by fragment length: 0 {h[0] / n:.4f}, 1-5 "
        f"{h[1:6].sum() / n:.4f}, 6-15 {h[6:16].sum() / n:.4f}, 16 "
        f"{h[16] / n:.4f} of {int(h.sum())}; each length {h.tolist()} "
        f"[{smi}]")
    h = hist_b.cpu().numpy()
    n = max(int(h.sum()), 1)
    c = (torch.cat(counts).to(torch.float64) if counts
         else torch.zeros(0, dtype=torch.float64))
    log(f"{name}: K6b calls of one batch (rows, window, top_k) {calls_b}; "
        f"{int(h.sum())} rows, active {1 - h[0] / n:.4f}; by fragment "
        f"length: 0 {h[0] / n:.4f}, 1-2 {h[1:3].sum() / n:.4f}, 3-5 "
        f"{h[3:6].sum() / n:.4f}, 6-10 {h[6:11].sum() / n:.4f}, 11-16 "
        f"{h[11:].sum() / n:.4f}; each length {h.tolist()}; exact "
        f"placements an active row: mean "
        f"{float(c.mean()) if c.numel() else 0.0:.2f}, most "
        f"{int(c.max()) if c.numel() else 0} [{smi}]")


def ptxas_report(build_log: str) -> dict:
    """{kernel instance: (registers, stack bytes, spill store bytes, spill
    load bytes)} from nvcc's -Xptxas -v output."""
    out, cur = {}, None
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            cur = kernel_name(ln.split("'")[1])
            out[cur] = [0, 0, 0, 0]
        elif cur and "bytes stack frame" in ln:
            n = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[cur][1:] = n[:3]
        elif cur and "Used" in ln and "registers" in ln:
            out[cur][0] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return {k: tuple(v) for k, v in out.items()}


def kernel_name(mangled: str) -> str:
    """verify_kernel<1, 0> for a mangled kernel template instance."""
    m = re.search(r"\d+([a-z_]+_kernel)(?:I((?:L[a-z]\d+E)+)E)?", mangled)
    if m is None:
        return mangled
    args = re.findall(r"L[a-z](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def max_abs_err(got, want) -> float:
    if isinstance(got, dict):
        return max(max_abs_err(got[k], want[k]) for k in want)
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"dtype/shape {got.dtype}{tuple(got.shape)} "
                             f"vs {want.dtype}{tuple(want.shape)}")
    return float((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def tensor_bytes(x) -> int:
    if isinstance(x, dict):
        return sum(tensor_bytes(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, timed with CUDA
    events after one warm-up run: what a caller pays per call, the
    wrapper's host work included."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profile_ms(fn, reps: int = 1) -> dict:
    """{kernel name: device ms} over reps runs of fn() under
    torch.profiler: each device-side event (kernels, copies, memsets)
    counted once, with its number of launches under ("n", name)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
            out[("n", e.key)] = out.get(("n", e.key), 0) + e.count
    return out


def device_ms(fn, reps: int, symbols):
    """Device milliseconds per call of a kernel whose __global__
    functions (each launched once a call) have names holding symbols,
    over reps runs of fn() after one warm-up run (their device time over
    the calls the profile holds, each function's launches counted
    apart), and each function's part of it; (None, {}) if three
    profiles in a row hold none (the profiler drops a kernel's events at
    times)."""
    fn()
    for _ in range(3):
        prof = profile_ms(fn, reps)
        names = [k for k in prof if isinstance(k, str)
                 and any(s in k for s in symbols)]
        n = max(sum(prof[("n", k)] for k in names if s in k)
                for s in symbols)
        if n:
            return (sum(prof[k] for k in names) / n,
                    {s: sum(prof[k] for k in names if s in k) / n
                     for s in symbols})
    return None, {}


def call_device_ms(fn, reps: int):
    """Device milliseconds per call of fn(), every kernel, copy and
    memset it launches, over reps calls after one warm-up call; None if
    three profiles in a row hold none."""
    fn()
    for _ in range(3):
        total = sum(v for k, v in profile_ms(fn, reps).items()
                    if isinstance(k, str))
        if total:
            return total / reps
    return None


def measure(name, shape, fn, plain_fn, reps, plain_reps, in_bytes, nops,
            popc=0):
    """One kernel row: the kernel against its plain version on the same
    inputs (max |difference|); the median time per call of the kernel's
    wrapper ("ms") and of the plain version ("plain_ms"; with plain_reps
    1, the time of the one plain call that gave the comparison), CUDA
    events around each call, host work included; and the bound of the
    work: the larger of the bytes it must move (in_bytes read once, its
    outputs written once) over HBM_BPS and its operations, each pipe
    apart: nops integer operations over INT_OPS, popc popcounts over
    POPC_OPS. The kernel's device time per launch ("device_ms") comes
    later, from profile_rows, with every other profile after the timed
    runs."""
    got = fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    want = plain_fn()
    b.record()
    b.synchronize()
    err = max_abs_err(got, want)
    t_bytes = (in_bytes + tensor_bytes(got)) / HBM_BPS * 1e3
    t_ops = max(nops / INT_OPS, popc / POPC_OPS) * 1e3
    return {"name": name, "shape": shape, "max_abs_err": err,
            "ms": cuda_ms(fn, reps),
            "plain_ms": (a.elapsed_time(b) if plain_reps == 1
                         else cuda_ms(plain_fn, plain_reps)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fn": fn, "reps": reps}


def verify_work(index, packed, diags, snp=False):
    """K1's bytes read (reads, N masks, lengths, diagonals, and each valid
    lane's genome window, N-bit window and, with SNPs, alt window), its
    integer operations (4 per lane word: align, xor, the fold and mask as
    one LOP3, the add) and its popcounts (1 per lane word)."""
    n, W = packed.shape
    lanes = int((diags != INVALID).sum())
    win = lanes * (W + 1) * 4 * (2 if snp else 1)
    if index.genome_has_n:
        win += lanes * (W // 2 + 1) * 4
    return (tensor_bytes((packed, packed, diags)) + 4 * n + win,
            lanes * W * 4, lanes * W)


def chain_work(inp, lengths):
    """K5's bytes read (all of chain_inputs' tensors and the lengths) and
    the operations this run's rows need: per active step, ~6 per
    transition between valid lanes (the jump sum, its compare, the best
    and its argument, the transition's select and bonus) and ~6 per
    valid lane (extend/open/jump choice, H, the row maximum)."""
    R, K, L = inp["s"].shape
    valid = (inp["diags"] != INVALID).sum(1)
    steps = torch.clamp(lengths, 0, L).to(torch.int64)
    ops = 6 * int((steps * valid * (valid + 1)).sum())
    return tensor_bytes(inp) + tensor_bytes(lengths), ops


def exact_work(g, ws, frag, flen, window):
    """K6b's bytes read (as scan_work) and the operations of its
    bit-parallel test, per window word of 16 offsets of each active row
    of fragment length f (at most F): 2 f + EXACT_OPS integer operations
    and half a popcount (see EXACT_OPS)."""
    F = frag.shape[1]
    f = torch.clamp(flen, 0, F).to(torch.int64)
    act = flen > 0
    words = window // 16 + (window % 16 > 0)
    nbytes = scan_work(g, ws, frag, flen, window, 0)[0]
    return (nbytes, int((2 * f[act] + EXACT_OPS).sum()) * words,
            int(act.sum()) * words // 2)


def window_words(g, ws, flen, window):
    """The genome words that the active rows' windows read, each counted
    once: a row reads window // 16 + 3 words from its start word, which
    is clamped as tpumap's dynamic slice clamps it (csrc/localscan.cu),
    and the windows of nearby rows overlap."""
    from tpumap_torch.index.device import SAFE_PAD_WORDS
    glen = g.shape[0]
    nraw = window // 16 + 3
    w0 = (ws if flen is None else ws[flen > 0]) >> 4
    if w0.numel() == 0:
        return 0
    zext = nraw - 1 >= 16 and nraw > SAFE_PAD_WORDS
    if nraw - 1 >= 16:
        w0 = w0.clamp(max=max(glen if zext else glen - nraw, 0))
    w0 = w0.sort().values
    # past the genome a row reads zeros (zext) or its last word again
    end = (w0 + nraw).clamp(max=glen)
    start = w0 if zext else w0.clamp(max=glen - 1)
    prev = torch.cat([start[:1], end[:-1]])
    return int((end - torch.maximum(start, prev)).clamp(min=0).sum())


def scan_work(g, ws, frag, flen, window, per_pos, popc_per_pos=0):
    """K6's bytes read (the genome words of the active rows' windows,
    window_words, and each row's start, fragment and length), per_pos
    integer operations and popc_per_pos popcounts per window position of
    each active row (rows with an empty fragment scan nothing)."""
    R = ws.shape[0]
    active = R if flen is None else int((flen > 0).sum())
    return (4 * window_words(g, ws, flen, window)
            + tensor_bytes((ws, frag, flen)),
            active * window * per_pos, active * window * popc_per_pos)


def load_index(smi):
    from tools import bench_data
    from tpumap_torch.index.build import GenomeDB, build_db
    bench_data.ROOT = ROOT / ".bench_data"
    t0 = time.perf_counter()
    gfa, rfa = bench_data.ensure_files()
    dbdir = bench_data.ROOT / "db_k14"
    if (dbdir / "meta.json").exists():
        db = GenomeDB.load(str(dbdir))
    else:
        db = build_db(gfa, name="bench", k=14, interval=3)
        db.save(str(dbdir))
    log(f"bench data + k=14 index ready in {time.perf_counter() - t0:.1f} s"
        f" (genome {db.genome_length} bp) [{smi}]")
    return bench_data, db, rfa


def load_mode_index(bench_data, db, smi):
    """The bench db with its ct and ga tables and a SNP index (cached
    under .bench_data/db_k14_modes/); returns (db, snp coords, alts).
    The SNPs (one per SNP_EVERY bp, none on the planted GT/AG intron
    bases) come from a seeded generator, each alt = ref + 1..3 mod 4."""
    from tpumap_torch.index.build import GenomeDB
    from tpumap_torch.ops.mode import add_mode_index
    rng = np.random.default_rng(300)
    glen = bench_data.GENOME_LEN
    coords = np.sort(rng.choice(glen, glen // SNP_EVERY, replace=False))
    planted = [p for exons in bench_data.gene_table()
               for (a, n), (b, _m) in zip(exons, exons[1:])
               for p in (a + n, a + n + 1, b - 2, b - 1)]
    coords = coords[~np.isin(coords, planted)]
    ref = db.get_codes(0, glen)[coords]
    alts = ((ref + rng.integers(1, 4, len(coords))) % 4).astype(np.uint8)
    t0 = time.perf_counter()
    dbdir = bench_data.ROOT / "db_k14_modes"
    if (dbdir / "meta.json").exists():
        mdb = GenomeDB.load(str(dbdir))
    else:
        mdb = GenomeDB.load(str(bench_data.ROOT / "db_k14"))
        for space in ("ct", "ga"):
            add_mode_index(mdb, space)
        mdb.add_snp_index(coords, alts)
        mdb.save(str(dbdir))
    log(f"mode db (ct, ga, {len(coords)} SNPs) ready in "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    return mdb, coords, alts


def snp_reads(bench_data, coords, alts):
    """The DNA reads of bench_data.read_plan() from the genome with the
    alt alleles in, substitutions and strand flip after, as
    _write_dna_reads makes them; and the alt alleles left in them."""
    from tpumap_torch.io.fasta import Record
    codes = bench_data.genome_codes()
    codes[coords] = alts
    starts, strands, subs = bench_data.read_plan()
    L = bench_data.READ_LEN
    lo = np.searchsorted(coords, starts)
    hi = np.searchsorted(coords, starts + L)
    reads, n_alt = [], 0
    for i in range(len(starts)):
        s = codes[starts[i]:starts[i] + L].copy()
        for j, b in subs[i]:
            s[j] = b
        at = coords[lo[i]:hi[i]]
        n_alt += int((s[at - starts[i]] == alts[lo[i]:hi[i]]).sum())
        if strands[i]:
            s = 3 - s[::-1]
        reads.append(Record(f"r{i}", "", bench_data._codes_to_str(s)))
    return reads, n_alt


def cmet(text: str, cpg: bool = True) -> str:
    """A read text as a directional bisulfite library reads it: C->T,
    except a C before a G with cpg (a methylated CpG)."""
    return re.sub("C(?!G)" if cpg else "C", "T", text)


def mode_kernel_rows(mindex, rng, reads_at):
    """K1 on the mode index: each base space at the mode rung's shape
    ([32,768, 8] x 8 per strand, reads with the space's conversions),
    ref-OR-alt at the SNP standard path's [65,536, 8] x 3 and cmet with
    SNPs at [32,768, 8] x 8 (reads cut from the alternate genome)."""
    from tpumap_torch.gsnap.engine import ENDS_K, ENDS_VERIFY_K
    from tpumap_torch.ops import pack, verify
    dev = mindex.device
    rows = []
    # the base each space converts: ct C->T, ga G->A, ag A->G, tc T->C
    cases = [("ct", False, B, ENDS_K, 1), ("ga", False, B, ENDS_K, 2),
             ("ag", False, B, ENDS_K, 0), ("tc", False, B, ENDS_K, 3),
             (None, True, 2 * B, ENDS_VERIFY_K, None),
             ("ct", True, B, ENDS_K, 1)]
    for space, snp, n, C, conv in cases:
        d, codes = reads_at(n)
        if snp:
            codes = verify.extract_codes_window(
                mindex.genomealt_packed, torch.from_numpy(d).to(dev),
                128).cpu().numpy()
            codes[:, 100:] = 0
        if conv is not None:
            hit = (codes == conv) & (rng.random(codes.shape) < 0.8)
            codes[hit] = (conv + 2) % 4
        diags = np.stack([d + rng.integers(-2, 3, n) * (c > 0)
                          for c in range(C)], 1)
        diags[rng.random(diags.shape) < 0.1] = 0xFFFFFFFF
        packed = pack.pack_reads(torch.from_numpy(codes).to(dev))
        lengths = torch.full((n,), 100, dtype=torch.int32, device=dev)
        args = (mindex, packed, torch.zeros_like(packed), lengths,
                torch.from_numpy(diags).to(dev), False, True)
        kw = dict(space=space, snp=snp)
        label = {(None, True): "snp", ("ct", True): "ct + snp"}.get(
            (space, snp), space)
        rows.append(measure(
            "verify_diagonals", f"[{n}, 8] x {C} ({label})",
            partial(verify.verify_diagonals, *args, **kw),
            partial(verify.verify_diagonals_plain, *args, **kw), 50, 10,
            *verify_work(mindex, packed, args[4], snp)))
    return rows


def kernel_phase(index, gpu, known, mindex):
    """Each kernel at its main-path shapes vs its plain version."""
    from tpumap_torch.gsnap.engine import ENDS_VERIFY_K
    from tpumap_torch.gsnap.params import INDEL_BAND, INDEL_MARGIN
    from tpumap_torch.ops import dp, pack, verify

    rng = np.random.default_rng(2024)
    dev = index.device
    glen = index.genome_length
    rows = []

    def reads_at(n, L=128):
        """n reads cut from the genome at random diagonals, 1% subs."""
        d = rng.integers(0, glen - 200, n).astype(np.int64)
        codes = verify.extract_codes_window(
            index.genome_packed, torch.from_numpy(d).to(dev), L).cpu().numpy()
        mut = rng.random(codes.shape) < 0.01
        codes[mut] = rng.integers(0, 4, int(mut.sum()))
        codes[:, 100:] = 0
        return d, codes

    for n, C in ((2 * B, ENDS_VERIFY_K), (512, 4)):
        d, codes = reads_at(n)
        diags = np.stack([d + rng.integers(-2, 3, n) * (c > 0)
                          for c in range(C)], 1)
        diags[rng.random(diags.shape) < 0.1] = 0xFFFFFFFF
        ct = torch.from_numpy(codes).to(dev)
        packed = pack.pack_reads(ct)
        nmask = torch.zeros_like(packed)
        lengths = torch.full((n,), 100, dtype=torch.int32, device=dev)
        dt = torch.from_numpy(diags).to(dev)
        args = (index, packed, nmask, lengths, dt, False, True)
        rows.append(measure(
            "verify_diagonals", f"[{n}, 8] x {C}",
            partial(verify.verify_diagonals, *args),
            partial(verify.verify_diagonals_plain, *args), 50, 10,
            *verify_work(index, packed, dt)))

    R = 2048
    d, codes = reads_at(R)
    for r in range(0, R, 4):            # plant 1-6 bp indels
        p, n_ = int(rng.integers(20, 80)), int(rng.integers(1, 7))
        row = codes[r, :100]
        codes[r, :100] = (np.concatenate([row[:p], row[p + n_:],
                                          row[:n_]]) if r % 8 else
                          np.concatenate([row[:p], row[p - n_:p],
                                          row[p:100 - n_]]))
    ct = torch.from_numpy(codes).to(dev)
    li = torch.full((R,), 100, dtype=torch.int32, device=dev)
    gstart = torch.clamp(torch.from_numpy(d).to(dev), min=INDEL_MARGIN) \
        - INDEL_MARGIN
    gcodes = verify.extract_codes_window(index.genome_packed, gstart,
                                         128 + INDEL_BAND + INDEL_MARGIN)
    glens = torch.full((R,), gcodes.shape[1], dtype=torch.int32, device=dev)
    bargs = (ct, li, gcodes, glens, INDEL_BAND)
    # ~12 int ops per cell of the band: the affine-gap recurrences (two
    # gap maxima, the diagonal score, the cell maximum) and the
    # direction bits
    W = 2 * INDEL_BAND + 1
    rows.append(measure(
        "banded_align", f"R={R}, Lq=128, Lg={gcodes.shape[1]}, "
        f"band={INDEL_BAND}", partial(dp.banded_align, *bargs),
        partial(dp.banded_align_plain, *bargs), 20, 3,
        tensor_bytes(bargs[:4]), int(li.sum()) * W * 12))

    got = dp.banded_align(*bargs)
    Rt = 256
    targs = (got["dirs"][:Rt].contiguous(), li[:Rt],
             got["end_k"][:Rt].contiguous(), INDEL_BAND)
    S = dp.traceback(*targs)[0].shape[1]
    # the walk reads one direction byte per step of each row's S steps
    # (~6 int ops a step: decode, move, run-length) and its row's length
    # and end
    rows.append(measure(
        "traceback", f"R={Rt}, S={S}, 12 runs",
        partial(dp.traceback, *targs), partial(dp.traceback_plain, *targs),
        50, 3, Rt * S + tensor_bytes(targs[1:3]), Rt * S * 6))
    rows[-1]["walk_steps"] = log_walk(dp.traceback(*targs)[0],
                                      f"R={Rt}, Lq=128")
    rows += traceback_rows(index)
    rows += rna_kernel_rows(index, rng, reads_at)
    rows += pe_known_kernel_rows(index, rng, reads_at, known)
    rows += mode_kernel_rows(mindex, rng, reads_at)
    rows.append(long_chain_row(index, rng, known))
    for r in rows:
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} disagrees with its plain "
                                 f"version at {r['shape']}")
    return rows


def log_walk(ops, shape):
    """The mean and the most steps K3's walk took a problem (its ops
    before T_END); returns the most: the longest dependent chain, which
    all problems walking at once cannot end before."""
    from tpumap_torch.ops import dp
    steps = (ops != dp.T_END).sum(dim=1, dtype=torch.float64)
    log(f"K3 at {shape}: {float(steps.mean()):.1f} walk steps a problem on "
        f"average, {int(steps.max())} at most")
    return int(steps.max())


def traceback_rows(index):
    """K3 at R = 256, Lq = 512 and at R = 32, Lq = 7,680 (a direction
    table past shared memory; one plain run): tables from K2 over reads
    cut from the genome with 1% substitutions and a 1-6 base indel every
    ~150 bases (deletions and insertions of one size in turn, so the
    diagonal stays in the band), qlens from 3/4 Lq to Lq; the long rows
    must have more than 12 runs. Bounds as the R = 256, Lq = 128 row.
    Its own generator, so the rows after it draw the same inputs as
    before it was added."""
    from tpumap_torch.gsnap.params import INDEL_BAND
    from tpumap_torch.ops import dp, verify
    rng = np.random.default_rng(7680)
    dev = index.device
    rows = []
    for R, Lq, plain_reps in ((256, 512, 3), (32, 7680, 1)):
        Lg = Lq + INDEL_BAND + 8
        starts = rng.integers(0, index.genome_length - Lg, R)
        g = verify.extract_codes_window(
            index.genome_packed, torch.from_numpy(starts).to(dev),
            Lg).cpu().numpy()
        q = np.zeros((R, Lq), np.uint8)
        for r in range(R):
            parts, p = [], 4
            cuts = np.arange(100, Lq - 50, 150) + rng.integers(0, 50)
            sizes = rng.integers(1, 7, len(cuts))
            for m, c in enumerate(cuts):
                parts.append(g[r, p:c])
                n = int(sizes[m - m % 2])
                if m % 2 == 0:
                    p = c + n                   # deletion from the read
                else:
                    parts.append(rng.integers(0, 4, n).astype(np.uint8))
                    p = c
            parts.append(g[r, p:])
            q[r] = np.concatenate(parts)[:Lq]
        mut = rng.random(q.shape) < 0.01
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        qlens = torch.from_numpy(
            rng.integers(3 * Lq // 4, Lq + 1, R).astype(np.int32)).to(dev)
        gt = torch.from_numpy(g).to(dev)
        fwd = dp.banded_align(torch.from_numpy(q).to(dev), qlens, gt,
                              torch.full((R,), Lg, dtype=torch.int32,
                                         device=dev), INDEL_BAND)
        targs = (fwd["dirs"], qlens, fwd["end_k"], INDEL_BAND)
        S = Lq + 2 * INDEL_BAND
        row = measure("traceback", f"R={R}, Lq={Lq}, S={S}",
                      partial(dp.traceback, *targs),
                      partial(dp.traceback_plain, *targs), 20, plain_reps,
                      R * S + tensor_bytes(targs[1:3]), R * S * 6)
        out = dp.traceback(*targs)
        row["walk_steps"] = log_walk(out[0], f"R={R}, Lq={Lq}")
        nruns = int(out[4].max())
        if Lq > 1000 and nruns <= dp.MAXRUNS:
            raise AssertionError(f"K3 at Lq={Lq}: at most {nruns} runs")
        rows.append(row)
    return rows


def profile_rows(rows, gpu, chain_ns, symbols=None):
    """Each kernel row's device time per call (its functions as SOURCES
    names them, or as symbols, {kernel: names}, does), then its log
    line; for
    K3's rows also the floor of the walk: its longest walk times the
    measured step of a chain of dependent shared-memory loads
    (chain_ns[1]: one load a step, the cell, which any design that keeps
    the cells in shared memory pays; chain_ns[2]: the cell, then a
    decode-table entry, as K3 reads them)."""
    for r in rows:
        syms = (symbols or {}).get(r["name"], SOURCES[r["name"]][2])
        dev, parts = device_ms(r.pop("fn"), r.pop("reps"), syms)
        r["device_ms"] = dev
        log(f"kernel {r['name']:17s} {r['shape']:34s} "
            f"max_abs_err={r['max_abs_err']:g} kernel {r['ms']:.4f} ms "
            f"per call ("
            + ("device time not measured" if dev is None else
               f"{dev:.4f} on the device") +
            f")  plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), share of bound "
            f"{r['bound_ms'] / (dev or r['ms']):.3f}  [{gpu}]")
        if len(syms) > 1 and dev is not None:
            log("  device ms a call by function: " + ", ".join(
                f"{s} {v:.4f}" for s, v in parts.items()))
        if "library_fn" in r:
            lib = r["library_device_ms"] = call_device_ms(
                r.pop("library_fn"), 10)
            log(f"  library call {r['library_ms']:.4f} ms per call (CUDA "
                f"events, as the kernel's {r['ms']:.4f}), "
                + ("device time not measured" if lib is None else
                   f"{lib:.4f} on the device (all its kernels, as the "
                   f"kernel's {dev or float('nan'):.4f})") + f"  [{gpu}]")
        if "reduce_floor_ms" in r:
            f = r["reduce_floor_ms"]
            log(f"  K7a floor at {r['shape']}: S dependent one-warp "
                f"reductions in waves of resident warps = {f:.4f} ms, "
                f"share {f / (dev or r['ms']):.3f}  [{gpu}]")
        if "walk_steps" in r:
            n = r["walk_steps"]
            one, two = (n * chain_ns[k] / 1e6 for k in (1, 2))
            r["walk_floor_ms"] = one
            log(f"  K3 walk floor at {r['shape']}: {n} steps x "
                f"{chain_ns[1]:.2f} ns (one dependent shared load) = "
                f"{one:.4f} ms, share {one / (dev or r['ms']):.3f}; x "
                f"{chain_ns[2]:.2f} ns (cell, then table) = {two:.4f} ms, "
                f"share {two / (dev or r['ms']):.3f}  [{gpu}]")


# kernel instances whose device time per batch is logged: K5, K3, K6a's
# two (a kept list of 4 keys, of 8) and K6b
BATCH_PARTS = (("K5", ("chain_kernel",)), ("K3", ("traceback_kernel",)),
               ("K6a<4>", ("localscan_kernel<0, 4>",)),
               ("K6a<8>", ("localscan_kernel<0, 8>",)),
               ("K6b", ("exact_sites_kernel",)))
GMAP_PARTS = (("K7a", SOURCES["chain_segments"][2]),
              ("K7b", SOURCES["region_anchors"][2]))


def profile_batch(name, one_batch, wall, smi, parts=BATCH_PARTS):
    """The device time of one batch (every kernel, copy and memset) and
    the parts of each (label, kernel names) of parts, against the timed
    run's wall time per batch."""
    prof = profile_ms(one_batch)
    dev = sum(v for k, v in prof.items() if isinstance(k, str))
    parts = ", ".join(
        f"{label} {sum(v for k, v in prof.items() if isinstance(k, str) and any(s in k for s in syms)):.4f}"
        for label, syms in parts)
    log(f"{name} device time of one batch "
        + (f"{dev:.3f} ms ({parts}) against {wall:.1f} ms of wall per "
           f"batch in the timed run: idle {1 - dev / wall:.3f}" if dev else
           "not measured (the profile holds no device events)")
        + f" [{smi}]")


def rna_kernel_rows(index, rng, reads_at):
    """K5 and K6a-c at the RNA path's shapes (ladder.py: chain passes
    R = 8,192 and 2,048, K = 8, L = 128; salvage scans R = 2,048; review
    scan R = 1,536; 65,536-bp windows) against their plain versions."""
    from tpumap_torch.ops import localscan, pathdp, verify

    dev = index.device
    glen = index.genome_length
    rows = []

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for R in (8192, 2048):
        d, codes = reads_at(R)
        # a junction or indel at query q in half the rows: bases from q
        # on come from diagonal d + jump
        half = np.arange(0, R, 2)
        q = rng.integers(20, 80, len(half))
        jump = rng.choice([-3, 4, 300, 5000], len(half))
        moved = verify.extract_codes_window(
            index.genome_packed, ints(d[half] + jump), 100).cpu().numpy()
        codes[half, :100] = np.where(np.arange(100)[None, :] >= q[:, None],
                                     moved, codes[half, :100])
        cands = np.stack([d, d + 4, d - 3, d + 300, d + 5000]
                         + [rng.integers(0, glen, R) for _ in range(3)], 1)
        cands[rng.random(cands.shape) < 0.25] = 0xFFFFFFFF
        lengths = ints(np.full(R, 100, np.int32))
        inp = pathdp.chain_inputs(index, ints(codes),
                                  torch.zeros(codes.shape, dtype=torch.bool,
                                              device=dev),
                                  lengths, ints(cands), pathdp.PathScoring())
        rows.append(measure(
            "chain_dp", f"R={R}, K=8, L=128",
            partial(pathdp.chain_dp, inp, lengths),
            partial(pathdp.chain_dp_plain, inp, lengths), 20, 2,
            *chain_work(inp, lengths)))

    W = 65536

    def scan_inputs(R, F):
        ws = rng.integers(0, glen, R).astype(np.int64)
        ws[:2] = [glen - 100, glen + 10_000]          # clamped windows
        at = np.minimum(ws + rng.integers(0, W, R), glen - 16)
        frag = verify.extract_codes_window(index.genome_packed, ints(at), F)
        flen = rng.integers(0, F + 1, R).astype(np.int32)
        return ints(ws), frag.contiguous(), ints(flen)

    # ops per window position: for the fragment's mismatch count and its
    # top-k, 4 integer operations (align two words, xor, the fold and
    # length mask as one LOP3, the min) and a popcount (K6b's rows, in
    # scan_exact_rows, count its own: exact_work); 3 for a run length (align, xor, compare: the run's
    # end is the highest set bit of the xor, or the lowest on a
    # bit-reversed window, so the least xor orders the offsets and only
    # the few that can reach the top need a bit scan)
    g = index.genome_packed
    ws, frag, flen = scan_inputs(2048, 16)
    args = (g, ws, frag, flen, W, 16, 4)
    rows.append(measure(
        "scan_fragment", "R=2048, W=65536, F=16, top 4",
        partial(localscan.scan_fragment, *args),
        partial(localscan.scan_fragment_plain, *args), 20, 2,
        *scan_work(g, ws, frag, flen, W, 4, 1)))
    ws, frag, _ = scan_inputs(2048, 16)
    for suffix in (True, False):
        args = (g, ws, frag, W, 8, suffix)
        rows.append(measure(
            "scan_fragment_runs",
            f"R=2048, W=65536, top 8, {'suffix' if suffix else 'prefix'}",
            partial(localscan.scan_fragment_runs, *args),
            partial(localscan.scan_fragment_runs_plain, *args), 20, 2,
            *scan_work(g, ws, frag, None, W, 3)))
    return rows + scan_fragment_rows(index) + scan_exact_rows(index)


def scan_fragment_rows(index):
    """K6a at R = 2,048, W = 65,536, top 4 with fragment lengths of 6-16
    bases, the ones the path sends (ladder.py and paired.py send 0 below
    MIN_FRAG = 6): over the bench genome, and over a poly-A genome with
    all-A fragments, where every offset ties at count 0. Bounds as the
    first K6a row. Its own generator."""
    from tpumap_torch.ops import localscan, verify
    rng = np.random.default_rng(616)
    dev = index.device
    R, W, F = 2048, 65536, 16
    polya = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    rows = []
    for label, g, glen in (
            ("bench genome", index.genome_packed, index.genome_length),
            ("poly-A", polya, 16 * polya.shape[0])):
        ws = rng.integers(0, glen - W, R).astype(np.int64)
        at = ws + rng.integers(0, W - F, R)
        frag = verify.extract_codes_window(
            g, torch.from_numpy(at).to(dev), F).contiguous()
        flen = torch.from_numpy(
            rng.integers(6, F + 1, R).astype(np.int32)).to(dev)
        args = (g, torch.from_numpy(ws).to(dev), frag, flen, W, F, 4)
        rows.append(measure(
            "scan_fragment", f"R={R}, W={W}, F=6-16, top 4 ({label})",
            partial(localscan.scan_fragment, *args),
            partial(localscan.scan_fragment_plain, *args), 20, 2,
            *scan_work(g, args[1], frag, flen, W, 4, 1)))
    return rows


def scan_exact_rows(index):
    """K6b at R = 1,536, W = 65,536, F = 10, top 8 over the bench genome:
    first with lengths 0-10 drawn uniformly (its main row), then with the
    fragment lengths of the splice-end review (PATH_LENGTHS: 99% of the
    rows have none), with its active rows' lengths alone (3-10), and with
    every row of 3 bases and of 10; and with the active rows' lengths
    over a poly-A genome with all-A fragments, where every offset of
    every row hits. Bounds from exact_work. Its own generator."""
    from tpumap_torch.ops import localscan, verify
    rng = np.random.default_rng(818)
    dev = index.device
    R, W, F = 1536, 65536, 10
    polya = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    mix = np.asarray(PATH_LENGTHS, np.float64)
    active = mix * (np.arange(len(mix)) > 0)
    bench = (index.genome_packed, index.genome_length)
    rows = []
    for label, (g, glen), p in (
            ("the path's lengths", bench, mix),
            ("the path's active lengths", bench, active),
            ("all 3 bases", bench, np.eye(F + 1)[3]),
            ("all 10 bases", bench, np.eye(F + 1)[10]),
            ("the path's active lengths, poly-A",
             (polya, 16 * polya.shape[0]), active)):
        ws = rng.integers(0, glen - W, R).astype(np.int64)
        at = ws + rng.integers(0, W - F, R)
        frag = verify.extract_codes_window(
            g, torch.from_numpy(at).to(dev), F).contiguous()
        flen = torch.from_numpy(
            rng.choice(len(p), R, p=p / p.sum()).astype(np.int32)).to(dev)
        args = (g, torch.from_numpy(ws).to(dev), frag, flen, W, F, 8)
        rows.append(measure(
            "scan_exact_sites", f"R={R}, W={W}, F={F}, top 8, {label}",
            partial(localscan.scan_exact_sites, *args),
            partial(localscan.scan_exact_sites_plain, *args), 20, 2,
            *exact_work(g, args[1], frag, flen, W)))
    # first, the row of lengths 0-10 drawn uniformly, with two windows
    # clamped at the genome's end
    g, glen = bench
    ws = rng.integers(0, glen, R).astype(np.int64)
    ws[:2] = [glen - 100, glen + 10_000]
    at = np.minimum(ws + rng.integers(0, W, R), glen - 16)
    frag = verify.extract_codes_window(
        g, torch.from_numpy(at).to(dev), F).contiguous()
    flen = torch.from_numpy(rng.integers(0, F + 1, R).astype(np.int32)).to(dev)
    args = (g, torch.from_numpy(ws).to(dev), frag, flen, W, F, 8)
    rows.insert(0, measure(
        "scan_exact_sites", f"R={R}, W={W}, F={F}, top 8",
        partial(localscan.scan_exact_sites, *args),
        partial(localscan.scan_exact_sites_plain, *args), 20, 2,
        *exact_work(g, args[1], frag, flen, W)))
    return rows


def known_chain_inputs(index, rng, known, R, L, lens, l0s):
    """chain_inputs of R reads of lens bases across bench junctions (known
    sites), the junction l0s bases in (at most the donor's coordinate),
    against 14 lanes: the junction's two diagonals and random or INVALID
    ones; known-site masks from the bench genes, at least one site bit a
    row."""
    from tpumap_torch.gsnap.knownsplicing import known_to_device
    from tpumap_torch.ops import pathdp, verify
    dev = index.device
    K = 14

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    jn = np.asarray(known.junctions, np.int64)
    pick = jn[rng.integers(0, len(jn), R)]
    l0 = np.minimum(rng.integers(*l0s, R), pick[:, 0])
    da, db_ = pick[:, 0] - l0, pick[:, 1] - l0
    a = verify.extract_codes_window(index.genome_packed, ints(da), L)
    b = verify.extract_codes_window(index.genome_packed, ints(db_), L)
    qs = torch.arange(L, device=dev)[None, :]
    lengths = ints(lens.astype(np.int32))
    codes = torch.where(qs < ints(l0)[:, None], a, b)
    codes[qs >= lengths[:, None]] = 0
    cands = np.concatenate([np.stack([da, db_], 1),
                            rng.integers(0, index.genome_length,
                                         (R, K - 2))], 1)
    cands[:, 2:][rng.random((R, K - 2)) < 0.5] = 0xFFFFFFFF
    inp = pathdp.chain_inputs(index, codes.contiguous(),
                              torch.zeros(codes.shape, dtype=torch.bool,
                                          device=dev),
                              lengths, ints(cands), pathdp.PathScoring(),
                              known=known_to_device(known, dev))
    if not bool((inp["known"] != 0).flatten(1).any(dim=1).all()):
        raise AssertionError("K5 known rows without a site bit")
    return inp, lengths


def long_chain_row(index, rng, known):
    """K5 on 64 reads of 7,169-7,680 bases (the 7,680 bucket) at 14
    lanes: past chain_max_len(14), so the choice table lives in global
    memory; one plain run (it steps L times)."""
    from tpumap_torch.ops import pathdp
    R, L = 64, 7680
    inp, lengths = known_chain_inputs(index, rng, known, R, L,
                                      rng.integers(7169, L + 1, R),
                                      (2000, 5001))
    if L <= pathdp.chain_max_len(14):
        raise AssertionError("the long K5 row fits shared memory")
    return measure(
        "chain_dp", f"R={R}, K=14, L={L}, known sites, global table",
        partial(pathdp.chain_dp, inp, lengths),
        partial(pathdp.chain_dp_plain, inp, lengths), 5, 1,
        *chain_work(inp, lengths))


def pe_known_kernel_rows(index, rng, reads_at, known):
    """The new shapes and inputs of the paired and known-splicing paths:
    K1 over the mate rescue's [512, 1000] window diagonals, K5 at
    R = 8,192 with 14 lanes (the cascade's 8 and 6 partner diagonals) and
    known-site masks from the bench genes, at least one site bit per row,
    and K6a at the mate repair's R = 512, W = 1,024."""
    from tpumap_torch.ops import localscan, pack, pathdp, verify

    dev = index.device
    glen = index.genome_length
    rows = []

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    R, W = 512, PAIRMAX
    d, codes = reads_at(R)
    base = np.maximum(d - rng.integers(0, W, R), 0)
    base[:2] = [glen - 300, 2 ** 32 - 400]          # past the end, wrapping
    packed = pack.pack_reads(ints(codes))
    lengths = torch.full((R,), 100, dtype=torch.int32, device=dev)
    diags = (ints(base)[:, None] + torch.arange(W, device=dev)) & 0xFFFFFFFF
    args = (index, packed, torch.zeros_like(packed), lengths, diags)
    rows.append(measure(
        "verify_diagonals", f"[{R}, 8] x {W} (rescue)",
        partial(verify.verify_diagonals, *args),
        partial(verify.verify_diagonals_plain, *args), 50, 10,
        *verify_work(index, packed, diags)))

    R, L = 8192, 128
    inp, lengths = known_chain_inputs(index, rng, known, R, L,
                                      np.full(R, 100), (20, 81))
    rows.append(measure(
        "chain_dp", f"R={R}, K=14, L={L}, known sites",
        partial(pathdp.chain_dp, inp, lengths),
        partial(pathdp.chain_dp_plain, inp, lengths), 20, 2,
        *chain_work(inp, lengths)))

    R, W = 512, 1024
    ws = rng.integers(0, glen, R).astype(np.int64)
    ws[:2] = [glen - 100, glen + 5000]
    at = np.minimum(ws + rng.integers(0, W, R), glen - 16)
    frag = verify.extract_codes_window(index.genome_packed, ints(at), 16)
    flen = ints(np.where(rng.random(R) < 0.9, 16, 0).astype(np.int32))
    args = (index.genome_packed, ints(ws), frag.contiguous(), flen, W, 16, 4)
    rows.append(measure(
        "scan_fragment", f"R={R}, W={W}, F=16, top 4 (repair)",
        partial(localscan.scan_fragment, *args),
        partial(localscan.scan_fragment_plain, *args), 20, 5,
        *scan_work(args[0], args[1], args[2], flen, W, 4, 1)))
    return rows


def gene_known(bench_data):
    """The bench genes' junctions as a KnownSplicing: donor = exon start +
    exon length, acceptor = the next exon's start, sense +1 (the bench
    genome is one chromosome, so these are univcoords)."""
    from tpumap_torch.gsnap.knownsplicing import KnownSplicing
    don, acc = [], []
    for exons in bench_data.gene_table():
        for (s0, n0), (s1, _n1) in zip(exons, exons[1:]):
            don.append(s0 + n0)
            acc.append(s1)
    return KnownSplicing.from_junctions(don, acc, np.ones(len(don)))


def repair_pairs(bench_data, db, n):
    """n FR pairs from the bench genes whose third intron is 200 or
    1,000 bp: mate 1 is 100 bp forward inside the third exon, mate 2 the
    reverse complement of a 100-bp read across that exon's junction."""
    from tpumap_torch.io.fasta import Record
    from tpumap_torch.utils import dna
    rng = np.random.default_rng(17)
    genes = [g for g in bench_data.gene_table()
             if g[3][0] - (g[2][0] + g[2][1]) in (200, 1000)]

    def seq(a, m):
        return "".join("ACGT"[c] for c in db.get_codes(a, m))
    pairs = []
    for i in range(n):
        (s2, n2), (s3, _n3) = genes[i % len(genes)][2:4]
        u = int(rng.integers(0, 101))
        l0 = int(rng.integers(30, 71))
        m2 = seq(s2 + n2 - l0, l0) + seq(s3, 100 - l0)
        pairs.append((Record(f"m{i}/1", "", seq(s2 + u, 100)),
                      Record(f"m{i}/2", "", dna.revcomp(m2))))
    return pairs


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


def grade(sam_bytes: bytes, bench_data):
    """(aligned fraction, fraction within 10 bp of truth on its strand)."""
    starts, strands, _subs = bench_data.read_plan()
    n = len(starts)
    aligned = near = 0
    for line in sam_bytes.decode().splitlines():
        f = line.split("\t", 6)
        flag = int(f[1])
        if flag & 0x900:
            continue
        if flag & 4:
            continue
        aligned += 1
        i = int(f[0][1:])
        if (abs(int(f[3]) - 1 - int(starts[i])) <= 10
                and bool(flag & 16) == bool(strands[i])):
            near += 1
    return aligned / n, near / n


@contextlib.contextmanager
def k7_calls():
    """Record each K7 wrapper call (the kernel's name and its arguments,
    tensors by reference) while the block runs."""
    from tpumap_torch.ops import chain
    ra, cc = chain.region_anchors, chain.chain_compact
    calls = []

    def rec_ra(*args, **kw):
        calls.append(("region_anchors", args + (kw.get(
            "keep_overabundant", False),)))
        return ra(*args, **kw)

    def rec_cc(*args):
        calls.append(("chain_segments", args))
        return cc(*args)
    chain.region_anchors, chain.chain_compact = rec_ra, rec_cc
    try:
        yield calls
    finally:
        chain.region_anchors, chain.chain_compact = ra, cc


def gmap_phase(db, index, smi, jobs):
    """Phase 12: 2,048 bench cDNAs through align_queries_bulk after a
    warm-up call on the first GMAP_WARM; returns the timed run's launch
    counts, its K7 calls, the queries and their encodings."""
    from gmap_bench import N_GMAP, SEED, gmap_queries, grade_gmap
    from tools.bench_gmap import make_queries
    from tpumap_torch import kernels
    from tpumap_torch.cli import gmap_cli
    from tpumap_torch.utils import dna

    queries, truth = gmap_queries(db, N_GMAP, SEED)
    if queries != make_queries(db, N_GMAP, SEED):
        raise AssertionError("gmap_queries differs from make_queries")
    enc = [dna.encode(q) for q in queries]
    t0 = time.perf_counter()
    gmap_cli.align_queries_bulk(db, index, enc[:GMAP_WARM])
    torch.cuda.synchronize()
    log(f"GMAP warm-up ({GMAP_WARM} cDNAs) {time.perf_counter() - t0:.2f} s "
        f"[{smi}]")
    kernels.reset_launches()
    with k7_calls() as calls:
        t0 = time.perf_counter()
        hits = gmap_cli.align_queries_bulk(db, index, enc)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    found, right = grade_gmap(hits, truth)
    shapes = [(n, tuple(a[0].shape) if n == "region_anchors"
               else tuple(a[0]["valid"].shape)) for n, a in calls]
    log(f"GMAP end to end: {N_GMAP} cDNAs in one call in {dt:.3f} s = "
        f"{N_GMAP / dt:.1f} queries/s, found {found:.4f}, exon structure "
        f"{right:.4f} (floor {GMAP_FLOOR}), launches={launches}; K7 calls "
        f"(kernel, [problems, window] or [problems, segments]): {shapes} "
        f"[{smi}]")
    jobs.append(("GMAP", lambda: gmap_cli.align_queries_bulk(db, index, enc),
                 dt * 1e3))
    if found < 0.99 or right < GMAP_FLOOR:
        raise AssertionError(f"GMAP: found {found:.4f} (floor 0.99), exon "
                             f"structure {right:.4f} (floor {GMAP_FLOOR})")
    missing = [k for k in GMAP_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"GMAP: kernels never launched: {missing}")
    return launches, calls, queries, enc


def gmap_kernel_rows(db, index, calls, reduce_ns):
    """K7b and K7a against their plain versions on the inputs of the GMAP
    run's calls with the most problems and with the widest window (most
    segments), of the 80-exon 8-kbp query of tests/test_gmap_e2e.py
    (exons of 100 bp every 1,100 bp of the bench genome: Rp = 131,072, S
    = 512), and of 64 poly-A windows of 32,768 bp (lengths 16,384-32,768)
    with an all-A query under keep_overabundant at max_occ 128."""
    from tpumap_torch.cli import gmap_cli
    from tpumap_torch.ops import chain
    from tpumap_torch.utils import dna

    dev = index.device
    g = db.get_seq(1_000_000, 80 * 1100)
    q = "".join(g[1100 * e:1100 * e + 100] for e in range(80))
    with k7_calls() as long_calls:
        hit = gmap_cli.align_queries_bulk(db, index, [dna.encode(q)])[0]
    log(f"80-exon query: {0 if hit is None else len(hit[0].exons)} exons, "
        f"K7 calls {[(n, tuple(a[0].shape) if n == 'region_anchors' else tuple(a[0]['valid'].shape)) for n, a in long_calls]}")
    ra = [a for n, a in calls if n == "region_anchors"]
    cc = [a for n, a in calls if n == "chain_segments"]
    picks = [("most problems", max(ra, key=lambda a: a[0].shape[0])),
             ("widest window", max(ra, key=lambda a: a[0].shape[1])),
             ("80 exons", max((a for n, a in long_calls
                               if n == "region_anchors"),
                              key=lambda a: a[0].shape[1]))]
    rng = np.random.default_rng(64)
    N, R, Q = 64, 32768, 512
    lens = torch.from_numpy(rng.integers(R // 2, R + 1, N)).to(dev)
    rv = torch.arange(R, device=dev)[None, :] < lens[:, None]
    qo, qv = chain.rolled_oligos(
        torch.zeros((N, Q), dtype=torch.uint8, device=dev),
        torch.ones((N, Q), dtype=torch.bool, device=dev), 8)
    picks.append(("poly-A, keep", (torch.zeros((N, R), dtype=torch.uint8,
                                               device=dev), rv, qo, qv, 8,
                                   128, True)))
    rows, seen = [], set()
    for label, args in picks:
        if id(args) in seen:
            continue
        seen.add(id(args))
        r_codes, r_valid, qolig, qvalid, k, max_occ, keep = args
        N, R = r_codes.shape
        Q = qolig.shape[1]
        # the function needs ~5 integer operations a window position (the
        # rolling oligo, its valid flag, a count, a scatter) and 4 an
        # anchor lane (the lookup and the diag); no table scan
        row = measure(
            "region_anchors", f"{label}: N={N}, Rp={R}, Q={Q}, "
            f"max_occ={max_occ}" + (", keep" if keep else ""),
            lambda a=args: chain.region_anchors(*a)[0::2],
            lambda a=args: chain.region_anchors_plain(*a)[0::2], 10, 1,
            tensor_bytes((r_codes, r_valid, qvalid)) + 4 * qolig.numel(),
            N * (5 * R + 4 * Q * max_occ))
        olig = chain.region_oligos(r_codes, r_valid, k)
        row["library_fn"] = lambda o=olig: torch.sort(o, dim=1, stable=True)
        row["library_ms"] = cuda_ms(row["library_fn"], 10)
        rows.append(row)
    picks = [("most problems", max(cc, key=lambda a: a[0]["valid"].shape[0])),
             ("most segments", max(cc, key=lambda a: a[0]["valid"].shape[1])),
             ("80 exons", max((a for n, a in long_calls
                               if n == "chain_segments"),
                              key=lambda a: a[0]["valid"].shape[1]))]
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    seen = set()
    for label, args in picks:
        if id(args) in seen:
            continue
        seen.add(id(args))
        segs = args[0]
        N, S = segs["valid"].shape
        row = measure("chain_segments", f"{label}: N={N}, S={S}, "
                      f"M={min(S, args[1])}",
                      lambda a=args: chain.chain_compact(*a),
                      lambda a=args: chain.chain_compact_plain(*a), 20, 1,
                      tensor_bytes(segs), 0)
        # the floor: S dependent first-maximum steps a problem at the
        # least width the probe measures (one warp, shuffles only), in
        # waves of as many problems as the card holds warps (64 an SM)
        floor = -(-N // (nsm * 64)) * S * reduce_ns[min(reduce_ns)] / 1e6
        row["reduce_floor_ms"] = floor
        if floor > row["bound_ms"]:
            row["bound_ms"], row["bound_by"] = floor, "operations"
        rows.append(row)
    for r in rows:
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} disagrees with its plain "
                                 f"version at {r['shape']}")
    return rows


def gap_table_fill(args, smi):
    """The device time of K7a's one fill of its gap-cost table (a
    device's first chain_compact call at a max_intron), each profiled
    call on args (a GMAP call's chain_compact arguments) refilling it."""
    from tpumap_torch.ops import chain

    def refill():
        chain._gap_tables.clear()
        chain.chain_compact(*args)
    fill = device_ms(refill, 3, ("chain_gap_table_kernel",))[0]
    log(f"K7a's gap-cost table fill (once a device, max_intron "
        f"{args[2]:,}): " + ("device time not measured" if fill is None
                             else f"{fill:.4f} ms on the device")
        + f"  [{smi}]")


def gmap_layers(db, index, queries, enc, smi):
    """One more GMAP call of all the cDNAs with the host wall time of its
    layers summed: stage 1 (find_regions_bulk, both passes, each ending
    in its copy to the host), the chain stage's enqueue (window groups
    dispatched), the wait for the chain results with the windows'
    host codes (align_cdna_windows_finish less refine_chain),
    refine_chain, and then the GFF3 emission (-f 3) of the hits."""
    from tpumap_torch.cli import gmap_cli
    from tpumap_torch.gmap import engine
    from tpumap_torch.io.fasta import Record
    spent = {"stage 1": 0.0, "chain enqueue": 0.0, "finish": 0.0,
             "refine_chain": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
        return run
    saved = [(gmap_cli, "find_regions_bulk"),
             (gmap_cli, "align_cdna_windows_dispatch"),
             (engine, "align_cdna_windows_dispatch"),
             (gmap_cli, "align_cdna_windows_finish"),
             (engine, "align_cdna_windows_finish"), (engine, "refine_chain")]
    keys = ["stage 1", "chain enqueue", "chain enqueue", "finish", "finish",
            "refine_chain"]
    old = [getattr(m, n) for m, n in saved]
    for (m, n), key, fn in zip(saved, keys, old):
        setattr(m, n, timed(key, fn))
    try:
        t0 = time.perf_counter()
        hits = gmap_cli.align_queries_bulk(db, index, enc)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for (m, n), fn in zip(saved, old):
            setattr(m, n, fn)
    recs = [Record(f"q{i}", "", s) for i, s in enumerate(queries)]
    t0 = time.perf_counter()
    gmap_cli.write_hits(db, "gff3_match_cdna", io.StringIO(), "bench", recs,
                        enc, hits)
    emit = time.perf_counter() - t0
    wait = spent["finish"] - spent["refine_chain"]
    other = total - spent["stage 1"] - spent["chain enqueue"] - spent["finish"]
    log(f"GMAP host layers of one {len(enc)}-cDNA call ({total * 1e3:.1f} "
        f"ms): stage 1 {spent['stage 1'] * 1e3:.1f} ms, chain enqueue "
        f"{spent['chain enqueue'] * 1e3:.1f}, wait for the chains and the "
        f"windows' host codes {wait * 1e3:.1f}, refine_chain "
        f"{spent['refine_chain'] * 1e3:.1f}, the rest (rounds, retries) "
        f"{other * 1e3:.1f}; GFF3 emission of the hits {emit * 1e3:.1f} ms "
        f"[{smi}]")


def gmap_gff3(db, index, queries, enc):
    """GFF3 (-f 3 and -f 2 bodies) of the first GMAP_WARM cDNAs, one
    align_queries_bulk call as gmap_cli.main makes for a batch."""
    from tpumap_torch.cli import gmap_cli
    from tpumap_torch.io.fasta import Record
    recs = [Record(f"q{i}", "", s) for i, s in enumerate(queries[:GMAP_WARM])]
    enc = enc[:GMAP_WARM]
    hits = gmap_cli.align_queries_bulk(db, index, enc)
    out = []
    for fmt in ("gff3_match_cdna", "gff3_gene"):
        buf = io.StringIO()
        gmap_cli.write_hits(db, fmt, buf, "bench", recs, enc, hits)
        out.append(buf.getvalue())
    return out


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gpu = torch.cuda.get_device_name(0)
    log(smi)

    from tpumap_torch import kernels, native
    from tpumap_torch.gsnap.driver import align_records
    from tpumap_torch.gsnap.engine import AlignConfig
    from tpumap_torch.gsnap.paired import align_paired_records
    from tpumap_torch.index.device import DeviceIndex
    from tpumap_torch.io.fasta import Record, read_fasta

    t0 = time.perf_counter()
    chain_lib, chain_proc = start_chain_build()
    kernels.build()
    log(f"kernel build {time.perf_counter() - t0:.1f} s [{smi}]")
    ptxas = ptxas_report(kernels.build_log)
    for name, (regs, stack, st, ld) in ptxas.items():
        log(f"  ptxas {name}: {regs} registers, {stack} bytes stack, "
            f"{st} + {ld} bytes spill stores + loads")
    chain = {k: v for k, v in ptxas.items() if k.startswith("chain_kernel")}
    if not chain:
        raise AssertionError("no ptxas report of K5 in the build log")
    if any(v[1] or v[2] or v[3] for v in chain.values()):
        raise AssertionError(f"K5 instances with stack or spills: {chain}")
    # K2's instance at the indel band: ceil((2 * band + 1) / 32) cells a
    # lane
    from tpumap_torch.gsnap.params import INDEL_BAND
    k2 = f"banded_kernel<{-(-(2 * INDEL_BAND + 1) // 32)}>"
    k7 = ([f"chain_segments_kernel<{p}>" for p in (1, 2, 4, 8, 16, 32)]
          + ["chain_gap_table_kernel"]
          + [f"region_anchors_count_kernel<{g}>" for g in (0, 1)]
          + ["region_anchors_scan_kernel", "region_anchors_place_kernel"]
          + [f"region_anchors_fill_kernel<{v}>" for v in (1, 4)])
    for name in (k2, "traceback_kernel", "localscan_kernel<0, 4>",
                 "localscan_kernel<0, 8>", "exact_sites_kernel", *k7):
        if name not in ptxas or any(ptxas[name][1:]):
            raise AssertionError(f"{name}: no ptxas report, or stack or "
                                 f"spills: {ptxas.get(name)}")
    if native.get_lib() is None:
        raise AssertionError("the port's native host library is not loaded")
    log("native host library loaded")
    chain_ns = shared_chain_ns(chain_lib, chain_proc, smi)
    reduce_ns = block_reduce_ns(chain_lib, smi)

    bench_data, db, rfa = load_index(smi)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = DeviceIndex.from_host(db, "cuda")
    torch.cuda.synchronize()
    log(f"index upload {time.perf_counter() - t0:.2f} s, "
        f"{index.nbytes() / 1e9:.3f} GB on the device [{smi}]")
    known = gene_known(bench_data)
    mdb, snp_coords, snp_alts = load_mode_index(bench_data, db, smi)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mindex = DeviceIndex.from_host(mdb, "cuda")
    torch.cuda.synchronize()
    log(f"mode index upload {time.perf_counter() - t0:.2f} s, "
        f"{mindex.nbytes() / 1e9:.3f} GB on the device [{smi}]")

    rows = kernel_phase(index, smi, known, mindex)

    config = AlignConfig(top_k=4, max_occ=4)
    cmet_config = AlignConfig(mode=CMET, top_k=4, max_occ=32)
    snp_config = AlignConfig(snp_tolerant=True, top_k=4, max_occ=4)

    def single(cfg=config, gdb=db, **kw):
        def run(idx, items, batch, sink, stats=None):
            align_records(gdb, idx, items, cfg, batch_size=batch,
                          sink=sink, stats=stats, **kw)
        return run

    def paired(cfg=config, gdb=db, **kw):
        def run(idx, items, batch, sink, stats=None):
            align_paired_records(gdb, idx, items, cfg, batch_size=batch,
                                 sink=sink, stats=stats, **kw)
        return run

    # every profile (kernel device times, one batch of each phase) waits
    # until the timed runs are over, so none of them runs after one
    jobs = []
    reads = list(read_fasta(rfa))
    dna_launches = run_e2e("DNA", reads, B, smi, index, single(),
                           lambda buf: check_dna(buf, bench_data),
                           DNA_KERNELS, jobs)
    _gfa, rna_rfa = bench_data.ensure_rna_files()
    rna_reads = list(read_fasta(rna_rfa))
    truth = bench_data.rna_truth()
    rna_launches = run_e2e("RNA", rna_reads, RB, smi, index,
                           single(novelsplicing=True),
                           lambda buf: check_rna(buf, truth), GSNAP_KERNELS,
                           jobs)
    known_launches = run_e2e("RNA -s", rna_reads, RB, smi, index,
                             single(novelsplicing=True, known=known),
                             lambda buf: check_rna(buf, truth),
                             GSNAP_KERNELS, jobs)
    f1, f2 = bench_data.ensure_pe_files()
    pe_pairs = list(zip(read_fasta(f1), read_fasta(f2)))
    pe_launches = run_e2e("PE", pe_pairs, PB, smi, index,
                          paired(pairmax=PAIRMAX),
                          lambda buf: check_pe(buf, bench_data),
                          DNA_KERNELS, jobs, reads_per_item=2)
    rep_pairs = repair_pairs(bench_data, db, N_REPAIR)
    rep_run = paired(novelsplicing=True, pairmax=2000)
    kernels.reset_launches()
    rep_stats = {}
    gbuf = io.BytesIO()
    rep_run(index, rep_pairs, N_REPAIR, gbuf.write, rep_stats)
    torch.cuda.synchronize()
    rep_launches = dict(kernels.LAUNCHES)
    log(f"PE RNA repair: {N_REPAIR} pairs, stats={rep_stats}, "
        f"launches={rep_launches} [{smi}]")
    if not (rep_stats.get("repair_rows", 0) > 0
            and rep_stats.get("repaired", 0) > 0):
        raise AssertionError("PE RNA: the pairs never reached the repair")
    missing = [k for k in GSNAP_KERNELS if rep_launches[k] <= 0]
    if missing:
        raise AssertionError(f"PE RNA repair: never launched: {missing}")

    cmet_reads = [Record(r.accession, "", cmet(r.sequence)) for r in reads]
    cmet_run = single(cmet_config, mdb)
    cmet_launches = run_e2e("cmet", cmet_reads, B, smi, mindex, cmet_run,
                            lambda buf: check_cmet(buf, bench_data),
                            ("verify_diagonals",), jobs)
    s_reads, n_alt = snp_reads(bench_data, snp_coords, snp_alts)
    snp_run = single(snp_config, mdb)
    snp_launches = run_e2e("SNP", s_reads, B, smi, mindex, snp_run,
                           lambda buf: check_snp(buf, bench_data, n_alt),
                           ("verify_diagonals",), jobs)
    gmap_launches, k7, gmap_q, gmap_enc = gmap_phase(db, index, smi, jobs)
    rows += gmap_kernel_rows(db, index, k7, reduce_ns)
    gap_args = next(a for n, a in k7 if n == "chain_segments")
    del k7

    # GPU vs CPU (plain versions) on the first reads, same batching; the
    # last four on the mode index
    cmet_rna = [Record(r.accession, "", cmet(r.sequence))
                for r in rna_reads[:N_CPU_RNA]]
    cmet_pairs = [(Record(a.accession, "", cmet(a.sequence, cpg=False)),
                   Record(b.accession, "", cmet(b.sequence, cpg=False)))
                  for a, b in pe_pairs[:N_CPU_RNA]]
    subsets = [("DNA", reads[:N_CPU], single(), False),
               ("RNA", rna_reads[:N_CPU_RNA], single(novelsplicing=True),
                False),
               ("RNA -s", rna_reads[:N_CPU_RNA],
                single(novelsplicing=True, known=known), False),
               ("PE", pe_pairs[:N_CPU_PE], paired(pairmax=PAIRMAX), False),
               ("PE RNA repair", rep_pairs, rep_run, False),
               ("cmet", cmet_reads[:N_CPU], cmet_run, True),
               ("SNP", s_reads[:N_CPU], snp_run, True),
               ("cmet RNA", cmet_rna,
                single(cmet_config, mdb, novelsplicing=True), True),
               ("cmet PE", cmet_pairs,
                paired(cmet_config, mdb, pairmax=PAIRMAX), True)]
    gpu_sam = []
    for _name, sub, run, modes in subsets:
        gbuf = io.BytesIO()
        run(mindex if modes else index, sub, len(sub), gbuf.write)
        gpu_sam.append(gbuf.getvalue())
    gpu_gff = gmap_gff3(db, index, gmap_q, gmap_enc)
    gmap_layers(db, index, gmap_q, gmap_enc, smi)
    profile_rows(rows, smi, chain_ns)
    gap_table_fill(gap_args, smi)
    del gap_args
    for job in jobs:
        profile_batch(*job, smi, GMAP_PARTS if job[0] == "GMAP"
                      else BATCH_PARTS)
        if job[0] in ("RNA", "RNA -s"):
            frag_lengths(job[0], job[1], smi)
    frag_lengths("PE RNA repair", lambda: rep_run(
        index, rep_pairs, N_REPAIR, io.BytesIO().write), smi)
    del index, mindex, jobs
    torch.cuda.empty_cache()
    cpu_index = DeviceIndex.from_host(db, "cpu")
    cpu_mindex = DeviceIndex.from_host(mdb, "cpu")
    for (name, sub, run, modes), want in zip(subsets, gpu_sam):
        t0 = time.perf_counter()
        cbuf = io.BytesIO()
        run(cpu_mindex if modes else cpu_index, sub, len(sub), cbuf.write)
        same = cbuf.getvalue() == want
        log(f"{name}: CPU plain run of {len(sub)} items in "
            f"{time.perf_counter() - t0:.1f} s: SAM byte-identical to the "
            f"GPU run: {same} ({len(want)} bytes) [{smi}]")
        if not same:
            raise AssertionError(f"{name}: CPU and GPU SAM differ")
    t0 = time.perf_counter()
    cpu_gff = gmap_gff3(db, cpu_index, gmap_q, gmap_enc)
    for fmt, c, g in zip(("-f 3", "-f 2"), cpu_gff, gpu_gff):
        log(f"GMAP {fmt}: CPU plain run of {GMAP_WARM} cDNAs (both formats "
            f"{time.perf_counter() - t0:.1f} s): GFF3 byte-identical to the "
            f"GPU run: {c == g} ({len(g)} bytes) [{smi}]")
        if c != g or g.count("\n") < GMAP_WARM:
            raise AssertionError(f"GMAP {fmt}: CPU and GPU GFF3 differ")
    if "jax" in sys.modules and sys.modules["jax"] is not None:
        raise AssertionError("JAX was imported")
    loaded = [m for m in sys.modules if m.split(".")[0] == "tpumap"
              and sys.modules[m] is not None]
    if loaded:
        raise AssertionError(f"tpumap was imported: {loaded}")

    phases = {"dna": dna_launches, "rna": rna_launches,
              "rna_known": known_launches, "pe": pe_launches,
              "pe_repair": rep_launches, "cmet": cmet_launches,
              "snp": snp_launches, "gmap": gmap_launches}
    n_batches = {"dna": -(-len(reads) // B), "rna": -(-len(rna_reads) // RB),
                 "rna_known": -(-len(rna_reads) // RB),
                 "pe": -(-len(pe_pairs) // PB), "pe_repair": 1,
                 "cmet": -(-len(cmet_reads) // B),
                 "snp": -(-len(s_reads) // B), "gmap": 1}
    per_batch = {name: {ph: launches[name] / n_batches[ph]
                        for ph, launches in phases.items()}
                 for name in SOURCES}
    log("launches per batch (" + ", ".join(
        f"{ph} {n}" for ph, n in n_batches.items()) + " batches):")
    for name, pb in per_batch.items():
        log(f"  {name:18s} " + "  ".join(f"{ph} {v:g}"
                                         for ph, v in pb.items()))

    # one entry per kernel, at its first (largest) main-path shape, with
    # all its rows; launches from the RNA run, which drives all seven
    # GSNAP kernels, or from the GMAP run (K7a, K7b), and each phase's
    # launches per batch beside them (a GMAP batch: the 2,048-cDNA call).
    # No single PyTorch call computes any of the GSNAP kernels' or K7a's
    # functions (library_ms null); K7b's is the stable sort of the
    # window's (oligo, position) pairs that region_index computes
    # (library_ms by CUDA events, as ms; library_device_ms as device_ms).
    table, seen = [], set()
    for r in rows:
        name = r["name"]
        if name in seen:
            continue
        seen.add(name)
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": (gmap_launches if name in GMAP_KERNELS
                         else rna_launches)[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows
                               if x["name"] == name),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": r["shape"],
            "rows": [{k: x[k] for k in ("shape", "max_abs_err", "ms",
                                        "device_ms", "plain_ms", "bound_ms",
                                        "bound_by", "walk_floor_ms",
                                        "reduce_floor_ms", "library_ms",
                                        "library_device_ms")
                      if k in x}
                     for x in rows if x["name"] == name],
            "launches_per_batch": per_batch[name]})
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_e2e(name, items, batch, smi, index, run, check, must_launch, jobs,
            reads_per_item=1):
    """One warm-up batch, then all items (reads or pairs) with the launch
    counters reset just before; check(sam bytes) -> a log string (raises
    on failure). Returns the launch counts of the timed run, and
    appends to jobs what profile_batch needs later (the phase, a run of
    one batch, the timed run's wall ms per batch)."""
    from tpumap_torch import kernels
    t0 = time.perf_counter()
    run(index, items[:batch], batch, io.BytesIO().write)
    torch.cuda.synchronize()
    log(f"{name} warm-up {time.perf_counter() - t0:.2f} s [{smi}]")
    kernels.reset_launches()
    buf = io.BytesIO()
    stats = {}
    t0 = time.perf_counter()
    run(index, items, batch, buf.write, stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    nreads = reads_per_item * len(items)
    log(f"{name} end to end: {nreads} reads at batch {batch} in "
        f"{dt:.3f} s = {nreads / dt:.1f} reads/s, "
        f"{check(buf.getvalue())}, launches={launches}, stats={stats} "
        f"[{smi}]")
    jobs.append((name, lambda: run(index, items[:batch], batch,
                                   io.BytesIO().write),
                 dt * 1e3 / -(-len(items) // batch)))
    missing = [k for k in must_launch if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched: {missing}")
    return launches


def grade_pe(sam_bytes: bytes, bench_data):
    """(concordant fraction as bench.py:323-326 computes it, fraction of
    pairs whose mates both lie within 10 bp of the plan: mate 1 forward
    at the fragment start, mate 2 reverse at start + length - 100)."""
    plan = bench_data.pe_read_plan()
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


def check_dna(sam_bytes, bench_data):
    aligned, near = grade(sam_bytes, bench_data)
    if aligned < 0.99 or near < 0.99:
        raise AssertionError(f"DNA accuracy below 0.99: aligned {aligned}, "
                             f"near truth {near}")
    return f"aligned_frac={aligned:.5f}, within 10 bp of truth={near:.5f}"


def check_pe(sam_bytes, bench_data):
    conc, near = grade_pe(sam_bytes, bench_data)
    msg = (f"concordant_frac={conc:.5f}, pairs within 10 bp of truth="
           f"{near:.5f}")
    if conc < 0.99 or near < 0.99:
        raise AssertionError(f"PE accuracy below 0.99: {msg}")
    return msg


def check_cmet(sam_bytes, bench_data):
    """Floors 0.01 under the measured 0.28422 aligned and 0.28084 within
    10 bp, tpumap's own figures: in the ct/ga space at max_occ 32 the
    ends rung keeps the 8 smallest of up to 192 candidate diagonals, so
    most reads miss their true one, and the prevalent rung takes only
    512 of a batch's 32,768 rows (the port's CPU run matches tpumap's SAM
    byte for byte on such reads)."""
    aligned, near = grade(sam_bytes, bench_data)
    msg = f"aligned_frac={aligned:.5f}, within 10 bp of truth={near:.5f}"
    if aligned < 0.274 or near < 0.270:
        raise AssertionError(f"cmet accuracy below its floor: {msg}")
    return msg


def check_snp(sam_bytes, bench_data, n_alt):
    """grade() and the alt alleles the primary lines report in XV:i:
    against those in the reads."""
    aligned, near = grade(sam_bytes, bench_data)
    xv = 0
    for line in sam_bytes.decode().splitlines():
        f = line.split("\t")
        if not int(f[1]) & 0x904:
            xv += sum(int(t[5:]) for t in f[11:] if t.startswith("XV:i:"))
    frac = xv / max(n_alt, 1)
    msg = (f"aligned_frac={aligned:.5f}, within 10 bp of truth={near:.5f}, "
           f"XV alt alleles {xv} of {n_alt} in the reads = {frac:.5f}")
    if aligned < 0.99 or near < 0.99 or frac < 0.95:
        raise AssertionError(f"SNP accuracy below its floor: {msg}")
    return msg


def check_rna(sam_bytes, truth):
    mapped, prec, rec = grade_rna(sam_bytes, truth)
    msg = (f"mapped_frac={mapped:.5f}, junction precision={prec:.5f}, "
           f"junction recall={rec:.5f}")
    if mapped < 0.99 or prec < 0.99 or rec < 0.95:
        raise AssertionError(f"RNA accuracy below its floor: {msg}")
    return msg


if __name__ == "__main__":
    sys.exit(main())
