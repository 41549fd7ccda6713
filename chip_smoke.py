#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpumap_torch) on one NVIDIA GPU.

Runs the port's main paths through the fused ladder and the native SAM
emitter — single-end DNA at the repo's headline DNA size, single-end RNA
with novel splicing and with known splicing (-s) at the bench's RNA
size, paired-end DNA at the bench's PE size, paired RNA through the
mate repair, and bisulfite (cmet) and SNP-tolerant DNA at the DNA size
— GMAP's bulk path over 2,048 cDNAs and its default path (-n 5) and
chimeras as gmap's main runs them, and GSNAP's staged path (two-pass,
fusions, the transcriptome rung single and paired), and fails (exit code
!= 0) if any phase fails:

1. card name and power limit; build the CUDA kernels from csrc/ (each
   kernel instance's ptxas registers, stack and spills; no K5 instance,
   not the K2 instance of the indel band, not K3, no K6a instance and
   not K6b, no K7a instance nor K7b function, no K8 instance and not K4
   may have a stack frame or spills); the port's native host library
   must load; the latency of a chain of dependent shared-memory loads
   (one and two a step, one thread), for the floor of K3's walk, and of
   a dependent first-maximum reduction
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
   over the poly-A genome, K8 (the ends rung's lanes) at the DNA rung's
   32,768 reads in standard mode (max_occ 4) and at cmet's (max_occ 32),
   and K4 (end trimming) at B = 32,768, L = 128 with and without quals,
   then the same four at the gsnap CLI's 1,024 reads, each with the
   device time of the torch ops it replaces, its plain version, and
   K8's with its sorts alone and a bound over 32-byte sectors);
4. DNA end to end: one warm-up call, then align_records over all 50,000
   100-bp reads at batch size 32,768 with launch counters reset just
   before; reads/s, aligned fraction and agreement with the generator's
   truth (>= 99% within 10 bp on the truth strand); the DNA kernels
   (K1-K3, K8 and K4) must have launched;
5. RNA end to end: the bench's 50,000 RNA reads (40% spliced) with
   novelsplicing=True at batch size 16,384, one warm-up call, then the
   timed run with launch counters reset; reads/s, mapped fraction and
   junction precision and recall against the generator's truth (>= 0.99
   mapped, >= 0.99 precision, >= 0.95 recall); all nine GSNAP kernels
   must have launched;
6. RNA with known splicing: the same 50,000 reads with novelsplicing=True
   and the bench genes' junctions as a KnownSplicing, batch 16,384, one
   warm-up call, then the timed run; reads/s and the floors of 5; all
   nine GSNAP kernels must have launched (K5 with 14 lanes and known-site
   masks);
7. paired-end DNA: the bench's 20,000 FR pairs (tools/bench_data.py),
   8,192 pairs per batch, pairmax 1,000, one warm-up call, then the
   timed run; reads/s (2 x pairs), the concordant fraction as bench.py
   computes it and the pairs whose mates both lie within 10 bp of the
   plan (>= 0.99 each); the DNA kernels (K1-K3, K8, K4) must have
   launched;
8. paired RNA through the mate repair: 512 pairs from the bench genes
   (mate 1 inside an exon, mate 2 the reverse complement of a read
   across the gene's next junction, introns of 200 or 1,000 bp),
   novelsplicing=True, pairmax 2,000; the rescue and the repair must
   have run (K1 at [512, 2000], K6a at W = 2,000, K5), and all nine
   GSNAP kernels launched;
9. bisulfite (cmet) end to end on a second index, the k=14 db with its
   ct and ga tables and a SNP index of ~155,000 SNPs (one per 300 bp,
   the density of a common-SNP catalogue), cached under
   .bench_data/db_k14_modes/: the 50,000 DNA reads with every C turned
   into T unless a G follows it (a directional library, CpGs
   methylated), mode cmet-stranded, max_occ 32, batch 32,768, one
   warm-up call, then the timed run; reads/s, aligned fraction and
   within 10 bp of truth (>= 0.274 and 0.270: tpumap's semantics, see
   check_cmet); K1, K8 and K4 must have launched;
10. SNP-tolerant end to end on that index: the 50,000 DNA reads of the
   plan regenerated with every SNP they cover set to its alt allele;
   reads/s, aligned fraction, within 10 bp (>= 0.99 each), and the sum
   of XV:i: over the primary lines against the alt alleles in the reads
   (>= 0.95); K1, K8 and K4 must have launched;
11. the first 2,048 DNA reads, the first 256 RNA reads (novel, and with
   known splicing), the first 2,048 PE pairs, the 512 repair pairs, the
   first 2,048 cmet and SNP reads, the first 256 RNA reads as cmet with
   novel splicing and 256 PE pairs as cmet (both mates C->T), and the
   four staged subsets of 13 through the port on the CPU (plain
   versions) and on the GPU with the same batching: byte-identical SAM;
   the first 256 GMAP cDNAs of 12: byte-identical GFF3 (-f 3 and -f 2);
   and gmap_cli.main on the first 32 (-f 3, -A, -S, -f 9, -f samse) and on
   the first 16 chimeras of 14 (-x 30 -f 1), --device cpu and the card:
   byte-identical output;
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

13. GSNAP's staged path (after 8; staged_bench.py holds the workloads
   and tpumap's grades on them): rna_twopass, two_pass_align over the
   50,000 RNA reads at batch 16,384 (pass 1 fused, pass 2 staged with
   the learned KnownSplicing and KnownIndels; each pass timed, graded
   and its launches counted; pass 2 must launch K1, K2, K3, K5, K6a and
   K6b, and its kernels' largest calls give their "staged" rows);
   rna_fusions, the first 16,384 RNA reads and 512 synthetic fusion
   reads (60 + 40 bases from loci more than 200,000 bp apart, half
   inverted) with fusions, the fusion records at their loci counted;
   rna_tr and pe_tr, the first 16,384 RNA reads and 8,192 PE pairs with
   the transcriptome of the 400 bench genes (built with the port's
   build_iit and build_transcriptome); each with its launches per batch,
   one staged batch's host layers and device time; floors TWOPASS_,
   FUSIONS_ and TR_FLOORS where tpumap's own grades are below the RNA
   cells'; CPU == GPU SAM on 256 reads of each (128 pairs).
14. GMAP as users run it (after 12): align_query_paths(npaths=5), one
   query at a time as gmap's main runs it by default, over the 2,048
   cDNAs of 12 (N_PATHS) after a warm-up on 64, launch counters reset
   first: queries/s, the found fraction and the exon structure of each
   query's first path (floors PATHS_FOUND_FLOOR and PATHS_FLOOR), the
   queries by their number of paths, and K7a's and K7b's launches a
   query (both must have launched); then align_query_chimera
   (chimera_margin=30) over gmap_bench's 256 chimeras (the leading exons
   of one cDNA of 12 joined to the trailing exons of another more than
   1 Mbp away): the share reported as two pieces at their loci meeting
   within 10 bp of the join (floor CHIMERA_FLOOR). K7b's and K7a's rows
   at the path's largest call and at its commonest shape at one problem
   (N = 1), each with its calls a query; one pass's host layers over
   512 cDNAs (find_regions, the chain stage's enqueue and wait,
   refine_chain, main's emission) and the device time and idle share of
   256 cDNAs. Then K7a's wide kernel (past 1,024 segments a problem,
   launched by no bench path) against its plain version at S = 1,025
   and 2,048, N = 1 and one wave (64 problems an SM), in phase 3's
   columns.
15. GSNAP as users run it (after 14): gsnap_cli.main in process with
   argument lists, output to a file with -o, each run timed whole (db
   load and index upload included) beside its --time reads/sec line.
   Its inputs come from the port's own tools: the 400 bench genes as
   GFF3 through gff3_splicesites (gff3_introns) and iit_cli store
   (their KnownSplicing must hold gene_known's 1,200 junctions), the
   genes map through iit_cli store and trindex_cli (transcriptome
   benchtr). Runs, each with its host layers (db load, index upload,
   reading, the aligner's call, record shaping, SAM text): the bare
   command over the 50,000 DNA reads (the record path at batch 1,024,
   graded as 4, K1-K3, K8 and K4 must launch), the same with --sam-use-0M 0
   (tpumap's stream) and with --batch-size 32768, the 20,000 PE pairs
   (the floors of 7), -N 1 -s bench_splicesites.iit over the 50,000 RNA
   reads (the floors of 5, all nine GSNAP kernels), -N 1 -c benchtr
   over the first 16,384 RNA reads (TR_FLOORS); the device time and idle share
   of the bare command; --check (0); and the card against --device cpu
   byte for byte (stdout and every file written) on the first 2,048 DNA
   reads with CLI_CPU_LISTS, on 512 RNA reads with -N 1 -s and on 512
   pairs, each at least a line a read (m8: 0.99 of them).
16. Several devices, large genomes, several processes (after 15; the
   machine's distinct cards where a grid asks for more than one and the
   machine has them, each card's work issued in turn from the one host
   thread; else cuda:0 repeated, whose shards run on it in turn):
   a. a MeshContext of data axis 2, and of 4 where the machine has four
      cards (parallel/pipeline.py: row-parallel stages split over the
      devices, every compaction ranked once)
      through align_records over the 50,000 DNA reads at batch 32,768
      and the 50,000 RNA reads with novel splicing at 16,384,
      align_paired_records over 2,048 pairs and align_queries_bulk over
      the 2,048 cDNAs of 12 (-f 3 GFF3): each byte-identical to the same
      call without device_ctx, its rate beside the single-device one's,
      its launches a card beside the single device's, K1-K3, K8, K4
      (RNA: all nine GSNAP kernels; GMAP: K7a and K7b) launched; with
      two cards or more one DNA batch through each grid traced
      (torch.profiler): each card's busy ms and idle share, their sum,
      the union of the cards' busy intervals, each card's ms busy while
      no other card was, and peer access between the cards;
   b. the index-sharded aligners (parallel/sharded.py) at 1 x 4
      (make_sharded_aligner) and 2 x 2 (make_sharded_full_aligner with
      splicing and salvage) over the 50,000 DNA reads in calls of 8,192:
      mapped and within 10 bp of truth >= 0.99 (K1, and the full
      aligner's K4, launched); the full aligner over
      the first 16,384 RNA reads, its accepted chain rows' junction
      precision and recall logged (no floor); CPU == card on every
      result array for the first 2,048 DNA and 512 RNA reads;
   c. a large=True build of the bench genome (uint64 positions, cached
      under .bench_data/db_k14_large; DeviceIndex must refuse it) in 4
      windows overlapping by 1,024 bases (parallel/large.py, a window
      index each): the 50,000 DNA reads rebased to uint64 univcoords
      within 10 bp of truth >= 0.99, CPU == card on 2,048;
   d. two processes in a gloo group (torch.distributed on the host),
      each on its own card where the machine has two (gsnap's --device
      cuda: card rank modulo the cards, and for --two-pass LOCAL_RANK
      as torchrun sets it; each process logs its card and its peak
      bytes a card, which must be its own card's alone), else sharing
      the card: gsnap_cli.main -O over the first
      8,192 DNA reads with no --part, process 0's file byte-identical
      to the one-process run's and process 1's empty; --two-pass over
      the first 16,384 RNA reads (--pass1-min-support 1), the two
      processes' --splices-dump and --indels-dump (the gathered tables)
      equal and junctions learned. A failing worker fails the run.
   K1's rows at the sharded cascade's and a window's shape (phase 3's
   columns) join the kernel table. With cards besides cuda:0, each
   kernel wrapper's call of the most rows on each such card in 16a-c is
   run again there against its plain version (exact), and every kernel
   launched on such a card must have had such a call.

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
and the GMAP call and 256 cDNAs of 14 (with the parts of K7a and K7b),
and K3's walk floor (its longest walk times the chain's step); then the
fragment lengths that reach K6a and K6b in one batch of RNA, RNA -s and
the repair (with K6b's active share and counts). After the runs: each
kernel's launches per batch on each path (from kernels.LAUNCHES; for
phase 15's runs a batch is the CLI's 1,024 reads or pairs). The
line before the last is the kernel table as JSON; the last line is {"ok": true,
"device": {...}}. JAX and tpumap are blocked: the port must run without
either. Bench data and the index go under .bench_data/ in the checkout.
With --rows it stops after the build and runs K8's and K4's rows alone
(no result line); --tree DIR imports DIR's tpumap_torch instead of this
checkout's, so two trees' K8 and K4 can be compared in one call, one
process a tree. With --phase16 it stops after the build and runs the
bench data, the index and phase 16 alone (--tree DIR: DIR's phase-16
functions on DIR's tpumap_torch), ending with the result line; run on a
machine with four cards, it takes them all.
Usage: python3 chip_smoke.py [--rows | --phase16] [--tree DIR]
"""
import collections
import contextlib
import ctypes
import io
import json
import os
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

from staged_bench import (N_FUSION, fusion_reads, fusions_found, genes_map,
                          grade_pe, grade_rna, rna_fusion_lines)

ROOT = pathlib.Path(__file__).resolve().parent
B = 32768
N_CPU = 2048
RB = 16384              # RNA batch (bench.py's RNA leg)
N_CPU_RNA = 256         # RNA reads of the CPU == card SAM checks (512
                        # until a run of 1,143 s, near the limit)
PB = 8192               # pairs per PE batch (bench.py's PE leg)
GROUP = 1024            # the gsnap CLI's reads a group (K8's, K4's rows)
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
# K8 and K4 run in every GSNAP cascade (the ends rung; the trim stage)
ENDS_KERNELS = ("end_lanes", "trim_stage")
DNA_KERNELS = ("verify_diagonals", "banded_align", "traceback") \
    + ENDS_KERNELS
GSNAP_KERNELS = DNA_KERNELS + ("chain_dp", "scan_fragment",
                               "scan_exact_sites", "scan_fragment_runs")
GMAP_KERNELS = ("chain_segments", "region_anchors")
GMAP_WARM = 256         # cDNAs of the GMAP warm-up call and of the CPU run
# the exon-structure floor of the GMAP phase: tpumap's own share on the
# same 2,048 cDNAs, 0.923828125 (gmap_bench.py, JAX on the CPU of the
# H100 machine), less 0.01
GMAP_FLOOR = 0.913828125
# phase 14: cDNAs of the default path's timed run, of its warm-up, and
# chimeras of the CPU == card check
N_PATHS = 2048
GMAP_PATHS_WARM = 64
N_CHIM_CPU = 16
# its floors: tpumap's own grades on the same cDNAs and chimeras
# (gmap_bench.py --paths --chimeras, JAX on the CPU of the H100
# machine) less 0.01 where they lie below 0.99: found 1.0, the first
# path's exon structure 0.92431640625, chimeras 0.9765625
PATHS_FOUND_FLOOR = 0.99
PATHS_FLOOR = 0.91431640625
CHIMERA_FLOOR = 0.9665625
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
    "end_lanes": ("tpumap_torch/csrc/ends.cu", "tpumap/gsnap/engine.py:277",
                  ("end_lanes_kernel",)),
    "trim_stage": ("tpumap_torch/csrc/trim.cu", "tpumap/gsnap/engine.py:458",
                   ("trim_kernel",)),
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
            "fn": fn, "reps": reps, "plain_fn": plain_fn}


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


def reads_from(index, rng):
    """reads_at(n, L=128): n reads cut from the genome at random
    diagonals, 1% substitutions, bases past 100 zero: (diagonals,
    codes)."""
    from tpumap_torch.ops import verify
    dev = index.device
    glen = index.genome_length

    def reads_at(n, L=128):
        d = rng.integers(0, glen - 200, n).astype(np.int64)
        codes = verify.extract_codes_window(
            index.genome_packed, torch.from_numpy(d).to(dev), L).cpu().numpy()
        mut = rng.random(codes.shape) < 0.01
        codes[mut] = rng.integers(0, 4, int(mut.sum()))
        codes[:, 100:] = 0
        return d, codes
    return reads_at


def kernel_phase(index, gpu, known, mindex):
    """Each kernel at its main-path shapes vs its plain version."""
    from tpumap_torch.gsnap.engine import ENDS_VERIFY_K
    from tpumap_torch.gsnap.params import INDEL_BAND, INDEL_MARGIN
    from tpumap_torch.ops import dp, pack, verify

    rng = np.random.default_rng(2024)
    dev = index.device
    rows = []
    reads_at = reads_from(index, rng)

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
    rows += ends_trim_rows(index, mindex, rng, reads_at)
    rows.append(long_chain_row(index, rng, known))
    for r in rows:
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} disagrees with its plain "
                                 f"version at {r['shape']}")
    return rows


def strand_reads(rng, reads_at, n, conv=None):
    """n reads of 100 bases at L = 128 (reads_at), every other one
    reverse-complemented; with conv (a code), 80% of that base in each
    read's own text turned into conv + 2 (cmet: C -> T). Returns
    (diagonals, codes, strands)."""
    d, codes = reads_at(n)
    strand = np.arange(n) % 2
    codes[1::2, :100] = 3 - codes[1::2, 99::-1]
    if conv is not None:
        hit = (codes == conv) & (rng.random(codes.shape) < 0.8)
        hit[:, 100:] = False
        codes[hit] = (conv + 2) % 4
    return d, codes, strand.astype(np.int32)


def ends_work(index, codes, lengths, cfg):
    """K8's bytes read, each input word once (each read's end bases and
    length; each end k-mer's two offsets and its live positions; in
    standard mode each row's probe word and two genome words a valid
    lane of the 8), the same in 32-byte sectors (a sector a k-mer's
    offsets, ceil(live / 8) a k-mer's positions, one a probe lane; the
    contiguous reads as their sectors), its integer operations (4 a
    k-mer base, 2 a live lane in each of the K selection rounds, 8 a
    probe lane) and popcounts (one a probe lane)."""
    from tpumap_torch.gsnap import engine
    from tpumap_torch.ops.mode import MODE_SPACES
    from tpumap_torch.ops.seed import _take_clip
    k, iv, occ = index.k, engine._ends_iv(index), cfg.max_occ
    NE = 2 * iv
    ok = (lengths >= k)[:, None]
    n_ok = int(ok.sum())
    live, valid = 0, 0
    pos_sectors = 0
    for (offsets, positions), oligos, q in engine.end_kmers(
            index, codes, lengths, cfg):
        start = _take_clip(offsets, oligos)
        cnt = _take_clip(offsets, oligos + 1) - start
        n = torch.where(ok & (cnt > 0) & (cnt <= occ), cnt, 0)
        live += int(n.sum())
        pos_sectors += int(((n + 7) // 8).sum())
        lanes = engine._dedup_lanes(engine._end_diags(
            offsets, positions, oligos, q, occ, ok[..., None]),
            engine.ENDS_K)
        valid += int((lanes != INVALID).sum())
    standard = MODE_SPACES[cfg.mode] == (None, None)
    B = codes.shape[0]
    span = 2 * (k + iv - 1)
    code_bytes = int(torch.clamp(lengths, 0, span).sum())
    nbytes = (code_bytes + 4 * B + 8 * 2 * NE * n_ok + 4 * live
              + ((4 * 2 * B + 8 * valid) if standard else 0))
    sectors = (32 * (-(-code_bytes // 32) + -(-4 * B // 32))
               + 32 * (2 * NE * n_ok + pos_sectors)
               + ((32 * (-(-8 * B // 32) + valid)) if standard else 0))
    K = min(engine.ENDS_K, NE * occ)
    nops = 2 * NE * n_ok * k * 4 + 2 * K * live + (8 * valid if standard
                                                   else 0)
    return nbytes, sectors, nops, valid if standard else 0


def trim_work(index, lengths, diag, got, quals, snp):
    """K4's bytes read, each input word once (a row's codes and N flags
    below its length, its length, strand and diagonal, the W + 1 genome
    words and W / 2 + 2 N-bitmap words of a valid row's window, with
    the alternate genome twice the genome words, and with quals the
    quals of the kept interval), its integer operations (~60 a row word:
    16 bases packed at 3 each, the xor, fold, masks and compress; ~20 a
    mismatch: the scans' three walks; 3 a kept quality) and popcounts
    (6 a row word)."""
    B = lengths.shape[0]
    L = int(lengths.max())
    W = (L + 15) // 16
    n_valid = int((diag != INVALID).sum())
    nbytes = 2 * int(lengths.sum()) + 16 * B + n_valid * 4 * (
        (W + 1) * (2 if snp else 1)
        + ((W // 2 + 2) if index.genome_has_n else 0))
    kept = int((got["trim_qend"] - got["trim_qstart"]).sum())
    if quals:
        nbytes += kept
    words = int(((lengths + 15) // 16).sum())
    nops = words * 60 + 20 * int(got["trim_nmm"].sum()) + (
        3 * kept if quals else 0)
    return nbytes, nops, words * 6


def ends_trim_rows(index, mindex, rng, reads_at):
    """K8 at the DNA ends rung's shape (32,768 reads, standard mode,
    max_occ 4: 24 lanes a strand, the probe keeping 3) and at cmet's
    (max_occ 32: 192 lanes a strand in its space's table), K4 at B =
    32,768, L = 128 with and without quals; then the same four on the
    first 1,024 of those rows (the gsnap CLI's group size, less than one
    wave of warps). Each row also holds the device time of the torch ops
    that the kernel replaces (its plain version; for K8 also its
    _dedup_lanes sorts alone) and, for K8, the bound over 32-byte
    sectors."""
    from tpumap_torch.gsnap import engine
    from tpumap_torch.ops import pack
    dev = index.device
    rows = []
    ends_in = []
    for label, idx, cfg, conv in (
            ("DNA", index, engine.AlignConfig(top_k=4, max_occ=4), None),
            ("cmet", mindex, engine.AlignConfig(mode=CMET, top_k=4,
                                                max_occ=32), 1)):
        _d, codes, _s = strand_reads(rng, reads_at, B, conv)
        ends_in.append((label, idx, cfg, conv, codes))
    d, codes, strand = strand_reads(rng, reads_at, B)
    diag = d.astype(np.int64)
    diag[rng.random(B) < 0.01] = INVALID
    quals = rng.integers(0, 41, codes.shape).astype(np.uint8)
    for n in (B, GROUP):
        for label, idx, cfg, conv, c in ends_in:
            ct = torch.from_numpy(c[:n]).to(dev)
            lengths = torch.full((n,), 100, dtype=torch.int32, device=dev)
            packed = pack.pack_reads(ct)
            packed2 = (torch.cat([packed, pack.revcomp_packed(packed,
                                                              lengths)])
                       if conv is None else None)
            args = (idx, ct, lengths, cfg, packed2)
            nbytes, sectors, nops, popc = ends_work(idx, ct, lengths, cfg)
            row = measure("end_lanes", f"[{n}] {label}, max_occ "
                          f"{cfg.max_occ}", partial(engine.end_lanes, *args),
                          partial(engine.end_lanes_plain, *args), 50, 5,
                          nbytes, nops, popc)
            out_bytes = tensor_bytes(row["fn"]())
            row["bound_sectors_ms"] = (sectors + out_bytes) / HBM_BPS * 1e3
            ok = (lengths >= idx.k)[:, None, None]
            raw = [engine._end_diags(*t, o, q, cfg.max_occ, ok)
                   for t, o, q in engine.end_kmers(idx, ct, lengths, cfg)]
            row["replaced_fn"] = row["plain_fn"]
            row["sorts_fn"] = partial(lambda r: [engine._dedup_lanes(
                x, engine.ENDS_K) for x in r], raw)
            rows.append(row)
        ct, st, dg = (torch.from_numpy(a[:n]).to(dev)
                      for a in (codes, strand, diag))
        nm = torch.zeros(ct.shape, dtype=torch.bool, device=dev)
        lengths = torch.full((n,), 100, dtype=torch.int32, device=dev)
        qt = torch.from_numpy(quals[:n]).to(dev)
        cfg = engine.AlignConfig(top_k=4, max_occ=4)
        res = {"strand": st, "diag": dg}
        for q in (None, qt):
            args = (index, ct, nm, lengths, res, cfg)
            fn = partial(engine._trim_stage, *args, quals=q)
            plain = partial(engine.trim_stage_plain, *args, quals=q)
            nbytes, nops, popc = trim_work(index, lengths, dg, fn(),
                                           q is not None, False)
            row = measure("trim_stage", f"B={n}, L=128, "
                          + ("quals" if q is not None else "no quals"), fn,
                          plain, 50, 5, nbytes, nops, popc)
            row["replaced_fn"] = plain
            rows.append(row)
    return rows


def rows_phase(smi):
    """chip_smoke.py --rows [--tree DIR]: K8's and K4's rows alone
    (ends_trim_rows with each one's device time, on the bench index and
    the mode index), for A/B comparisons of two trees' kernels in one
    call: with --tree, DIR's tpumap_torch is the one imported. Prints
    the rows as JSON; no result line."""
    from tpumap_torch.index.device import DeviceIndex
    _bench_data, db, _rfa = load_index(smi)
    index = DeviceIndex.from_host(db, "cuda")
    mdb, _c, _a = load_mode_index(_bench_data, db, smi)
    mindex = DeviceIndex.from_host(mdb, "cuda")
    rng = np.random.default_rng(2024)
    rows = ends_trim_rows(index, mindex, rng, reads_from(index, rng))
    for r in rows:
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} disagrees with its plain "
                                 f"version at {r['shape']}")
    profile_rows(rows, smi, (0.0, 0.0, 0.0))
    log(json.dumps({"rows": [{k: v for k, v in r.items()
                              if not callable(v)} for r in rows]}))
    return 0


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
        syms = r.pop("symbols", None) or (symbols or {}).get(
            r["name"], SOURCES[r["name"]][2])
        r.pop("plain_fn", None)
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
        for key, what in (("replaced", "the torch ops the kernel replaces "
                           "(its plain version)"),
                          ("sorts", "the plain version's _dedup_lanes "
                           "sorts alone")):
            if f"{key}_fn" in r:
                ms = r[f"{key}_device_ms"] = call_device_ms(
                    r.pop(f"{key}_fn"), 5)
                log(f"  {what}: " + ("device time not measured"
                                     if ms is None else
                                     f"{ms:.4f} ms on the device")
                    + f"  [{gpu}]")
        if "bound_sectors_ms" in r:
            log(f"  bound over 32-byte sectors {r['bound_sectors_ms']:.4f} "
                f"ms, share {r['bound_sectors_ms'] / (dev or r['ms']):.3f}"
                f"  [{gpu}]")
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
               ("K6b", ("exact_sites_kernel",)),
               ("K8", ("end_lanes_kernel",)), ("K4", ("trim_kernel",)))
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
    return launches, calls, queries, truth, enc


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
        if id(args) not in seen:
            seen.add(id(args))
            rows.append(k7b_row(label, args))
    picks = [("most problems", max(cc, key=lambda a: a[0]["valid"].shape[0])),
             ("most segments", max(cc, key=lambda a: a[0]["valid"].shape[1])),
             ("80 exons", max((a for n, a in long_calls
                               if n == "chain_segments"),
                              key=lambda a: a[0]["valid"].shape[1]))]
    seen = set()
    for label, args in picks:
        if id(args) not in seen:
            seen.add(id(args))
            rows.append(k7a_row(label, args, reduce_ns))
    return check_rows(rows)


def check_rows(rows):
    for r in rows:
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} disagrees with its plain "
                                 f"version at {r['shape']}")
    return rows


def k7b_row(label, args):
    """K7b's row on a recorded call's arguments, with the stable
    torch.sort of the windows' (oligo, position) pairs as its library
    call."""
    from tpumap_torch.ops import chain
    r_codes, r_valid, qolig, qvalid, k, max_occ, keep = args
    N, R = r_codes.shape
    Q = qolig.shape[1]
    # the function needs ~5 integer operations a window position (the
    # rolling oligo, its valid flag, a count, a scatter) and 4 an anchor
    # lane (the lookup and the diag); no table scan
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
    return row


def k7a_row(label, args, reduce_ns):
    """K7a's row on a recorded call's arguments; its bound is at least
    the floor of S dependent first-maximum steps a problem at the least
    width the probe measures (one warp, shuffles only), in waves of as
    many problems as the card holds warps (64 an SM)."""
    from tpumap_torch.ops import chain
    segs = args[0]
    N, S = segs["valid"].shape
    row = measure("chain_segments", f"{label}: N={N}, S={S}, "
                  f"M={min(S, args[1])}",
                  lambda a=args: chain.chain_compact(*a),
                  lambda a=args: chain.chain_compact_plain(*a), 20, 1,
                  tensor_bytes(segs), 0)
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    floor = -(-N // (nsm * 64)) * S * reduce_ns[min(reduce_ns)] / 1e6
    row["reduce_floor_ms"] = floor
    if floor > row["bound_ms"]:
        row["bound_ms"], row["bound_by"] = floor, "operations"
    return row


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
    refine_chain, and then main -n 1 -f 3 on these cDNAs given the
    call's hits: reading the FASTA and the GFF3 emission."""
    from unittest import mock

    from tpumap_torch.cli import gmap_cli
    from tpumap_torch.gmap import engine
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
    qfa = write_fasta("gmap_bulk_all.fa", "q", queries[:len(enc)])
    with db_patched(db, index), mock.patch.object(
            gmap_cli, "align_queries_bulk", lambda *a, **kw: hits):
        t0 = time.perf_counter()
        gmap_main_text(["-n", "1", "--input-buffer-size", str(len(enc)),
                        "-D", "db", "-f", "3", str(qfa), "--device",
                        index.device.type])
        emit = time.perf_counter() - t0
    wait = spent["finish"] - spent["refine_chain"]
    other = total - spent["stage 1"] - spent["chain enqueue"] - spent["finish"]
    log(f"GMAP host layers of one {len(enc)}-cDNA call ({total * 1e3:.1f} "
        f"ms): stage 1 {spent['stage 1'] * 1e3:.1f} ms, chain enqueue "
        f"{spent['chain enqueue'] * 1e3:.1f}, wait for the chains and the "
        f"windows' host codes {wait * 1e3:.1f}, refine_chain "
        f"{spent['refine_chain'] * 1e3:.1f}, the rest (rounds, retries) "
        f"{other * 1e3:.1f}; main -n 1 -f 3 reading and GFF3 emission of "
        f"the hits {emit * 1e3:.1f} ms [{smi}]")


def gmap_gff3(db, index, queries):
    """GFF3 (-f 3 and -f 2) of the first GMAP_WARM cDNAs through main's
    bulk path (-n 1: one align_queries_bulk call for the batch), on the
    device of index, with the echoed --device taken out."""
    qfa = write_fasta("gmap_bulk_q.fa", "q", queries[:GMAP_WARM])
    dev = index.device.type
    out = []
    with db_patched(db, index):
        for fmt in ("3", "2"):
            out.append(gmap_main_text(
                ["-n", "1", "-D", "db", "-f", fmt, str(qfa), "--device",
                 dev]).replace(f" --device {dev}", ""))
    return out


def gmap_main_text(argv):
    """gmap_cli.main(argv)'s stdout. main prints a failure it expects as
    one line on stderr and returns 2 (clean_errors): that raises here."""
    from tpumap_torch.cli import gmap_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gmap_cli.main(argv)
    if rc not in (None, 0):
        raise AssertionError(f"gmap main {' '.join(argv)} returned {rc}")
    return buf.getvalue()


def write_fasta(name, prefix, seqs):
    """seqs as a FASTA file under .bench_data/ (records prefix0, ...)."""
    path = ROOT / ".bench_data" / name
    path.write_text("".join(f">{prefix}{i}\n{s}\n"
                            for i, s in enumerate(seqs)))
    return path


# ------------------------------------------------- GMAP as users run it

@contextlib.contextmanager
def k7_picks():
    """Count the shape of each K7 wrapper call while the block runs
    ([problems, window] for K7b, [problems, segments] for K7a) and keep
    the arguments (tensors by reference) of each kernel's largest call
    (most problems, then the widest) and of each shape at one problem:
    {"shapes": {kernel: Counter}, "largest": {kernel: (shape, args)},
    "single": {(kernel, shape): args}}."""
    from tpumap_torch.ops import chain
    ra, cc = chain.region_anchors, chain.chain_compact
    picks = {"shapes": {n: collections.Counter() for n in GMAP_KERNELS},
             "largest": {}, "single": {}}

    def keep(name, shape, args):
        picks["shapes"][name][shape] += 1
        if shape > picks["largest"].get(name, ((0, 0),))[0]:
            picks["largest"][name] = (shape, args)
        if shape[0] == 1:
            picks["single"].setdefault((name, shape), args)

    def rec_ra(*args, **kw):
        keep("region_anchors", tuple(args[0].shape),
             args + (kw.get("keep_overabundant", False),))
        return ra(*args, **kw)

    def rec_cc(*args):
        keep("chain_segments", tuple(args[0]["valid"].shape), args)
        return cc(*args)
    chain.region_anchors, chain.chain_compact = rec_ra, rec_cc
    try:
        yield picks
    finally:
        chain.region_anchors, chain.chain_compact = ra, cc


def gmap_paths_phase(db, index, queries, truth, enc, smi, jobs):
    """Phase 14: align_query_paths(npaths=5), gmap's default path, one
    query at a time as main runs it, over the first N_PATHS bench cDNAs
    after a warm-up on GMAP_PATHS_WARM, the launch counters reset just
    before; then align_query_chimera(chimera_margin=30) over
    gmap_bench's N_CHIMERA chimeras. Returns the launch counts of both
    runs, the K7 picks of the paths run and the chimeras."""
    from gmap_bench import (CHIMERA_MARGIN, N_CHIMERA, NPATHS,
                            chimera_queries, grade_chimeras, grade_paths)
    from tpumap_torch import kernels
    from tpumap_torch.cli import gmap_cli
    from tpumap_torch.gmap import chimera, engine, stage1
    from tpumap_torch.utils import dna

    def paths_of(batch):
        return [gmap_cli.align_query_paths(db, index, qc, qn, npaths=NPATHS)
                for qc, qn in batch]

    def chimeras_of(batch):
        return [chimera.align_query_chimera(
            db, index, qc, qn, engine.GmapConfig(), stage1.Stage1Config(),
            chimera_margin=CHIMERA_MARGIN) for qc, qn in batch]

    t0 = time.perf_counter()
    paths_of(enc[:GMAP_PATHS_WARM])
    torch.cuda.synchronize()
    log(f"GMAP -n {NPATHS} warm-up ({GMAP_PATHS_WARM} cDNAs) "
        f"{time.perf_counter() - t0:.2f} s [{smi}]")
    n = N_PATHS
    kernels.reset_launches()
    with k7_picks() as picks:
        t0 = time.perf_counter()
        paths = paths_of(enc[:n])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    found, right, dist = grade_paths(paths, truth[:n])
    log(f"GMAP -n {NPATHS} end to end: {n} cDNAs one at a time in "
        f"{dt:.3f} s = {n / dt:.1f} queries/s, found {found:.4f} (floor "
        f"{PATHS_FOUND_FLOOR}), exon structure of the first path "
        f"{right:.4f} (floor {PATHS_FLOOR}), queries by paths {dist}, "
        f"launches a query " + ", ".join(
            f"{k} {launches[k] / n:.3f}" for k in GMAP_KERNELS)
        + "; K7 calls by shape: " + "; ".join(
            f"{k} {dict(picks['shapes'][k].most_common())}"
            for k in GMAP_KERNELS) + f" [{smi}]")
    jobs.append((f"GMAP -n {NPATHS}", lambda: paths_of(enc[:GMAP_WARM]),
                 dt * 1e3 * GMAP_WARM / n))
    if found < PATHS_FOUND_FLOOR or right < PATHS_FLOOR:
        raise AssertionError(f"GMAP -n {NPATHS}: found {found:.4f} (floor "
                             f"{PATHS_FOUND_FLOOR}), exon structure "
                             f"{right:.4f} (floor {PATHS_FLOOR})")
    missing = [k for k in GMAP_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"GMAP -n {NPATHS}: never launched: {missing}")

    cseqs, ctruth = chimera_queries(queries, truth)
    cenc = [dna.encode(q) for q in cseqs]
    chimeras_of(cenc[:16])
    kernels.reset_launches()
    t0 = time.perf_counter()
    pieces = chimeras_of(cenc)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    claunches = dict(kernels.LAUNCHES)
    share = grade_chimeras(pieces, cseqs, ctruth)
    log(f"GMAP -x {CHIMERA_MARGIN}: {N_CHIMERA} chimeras in {dt:.3f} s = "
        f"{N_CHIMERA / dt:.1f} queries/s, two pieces at their loci meeting "
        f"within 10 bp of the join {share:.4f} (floor {CHIMERA_FLOOR}), "
        f"queries by pieces "
        f"{dict(sorted(collections.Counter(map(len, pieces)).items()))}, "
        f"launches a query " + ", ".join(
            f"{k} {claunches[k] / N_CHIMERA:.3f}" for k in GMAP_KERNELS)
        + f" [{smi}]")
    if share < CHIMERA_FLOOR:
        raise AssertionError(f"GMAP -x {CHIMERA_MARGIN}: {share:.4f} "
                             f"below the floor {CHIMERA_FLOOR}")
    missing = [k for k in GMAP_KERNELS if claunches[k] <= 0]
    if missing:
        raise AssertionError(f"GMAP -x: never launched: {missing}")
    return launches, claunches, picks, cseqs


def gmap_paths_rows(picks, reduce_ns, n):
    """K7b and K7a against their plain versions on the arguments of the
    paths run's largest call of each and of its commonest shape at one
    problem (N = 1), each row with that shape's calls a query."""
    rows = []
    for name, make in (("region_anchors", k7b_row),
                       ("chain_segments", partial(k7a_row,
                                                  reduce_ns=reduce_ns))):
        counts = picks["shapes"][name]
        shape, args = picks["largest"][name]
        one = max((s for s in counts if s[0] == 1), key=counts.get)
        for label, s, a in (("-n 5 largest", shape, args),
                            ("-n 5 commonest at N=1", one,
                             picks["single"][(name, one)])):
            row = make(label, a)
            row["calls_per_query"] = counts[s] / n
            rows.append(row)
    return check_rows(rows)


def gmap_paths_layers(db, index, queries, enc, smi):
    """One more -n 5 pass over enc with the host wall time of its layers
    summed: find_regions (both passes of a query, each ending in its
    copy to the host), the align_cdna_regions calls split into the
    chain stage's enqueue (_chain_pipeline_batch), the wait for its
    result (_chains), refine_chain and the rest (the regions' codes
    from the host genome, padding); then main -f 3 on these cDNAs
    given the pass's paths: reading the FASTA and the GFF3 emission."""
    from unittest import mock

    from gmap_bench import NPATHS
    from tpumap_torch.cli import gmap_cli
    from tpumap_torch.gmap import engine
    spent = collections.Counter()

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
        return run
    saved = [(gmap_cli, "find_regions"), (gmap_cli, "align_cdna_regions"),
             (engine, "_chain_pipeline_batch"), (engine, "_chains"),
             (engine, "refine_chain")]
    with contextlib.ExitStack() as stack:
        for m, name in saved:
            stack.enter_context(mock.patch.object(
                m, name, timed(name, getattr(m, name))))
        t0 = time.perf_counter()
        paths = [gmap_cli.align_query_paths(db, index, qc, qn,
                                            npaths=NPATHS)
                 for qc, qn in enc]
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    it = iter(paths)
    qfa = write_fasta("gmap_paths_q.fa", "q", queries[:len(enc)])
    with db_patched(db, index), mock.patch.object(
            gmap_cli, "align_query_paths", lambda *a, **kw: next(it)):
        t0 = time.perf_counter()
        gmap_main_text(["-D", "db", "-f", "3", str(qfa), "--device",
                        index.device.type])
        emit = time.perf_counter() - t0
    rest = (spent["align_cdna_regions"] - spent["_chain_pipeline_batch"]
            - spent["_chains"] - spent["refine_chain"])
    log(f"GMAP -n {NPATHS} host layers of one {len(enc)}-cDNA pass "
        f"({total * 1e3:.1f} ms): find_regions "
        f"{spent['find_regions'] * 1e3:.1f} ms; align_cdna_regions "
        f"{spent['align_cdna_regions'] * 1e3:.1f} (chain enqueue "
        f"{spent['_chain_pipeline_batch'] * 1e3:.1f}, wait "
        f"{spent['_chains'] * 1e3:.1f}, refine_chain "
        f"{spent['refine_chain'] * 1e3:.1f}, the regions' host codes and "
        f"padding {rest * 1e3:.1f}); the rest (sort, dedup) "
        f"{(total - spent['find_regions'] - spent['align_cdna_regions']) * 1e3:.1f}"
        f"; main -f 3 reading and GFF3 emission of the pass's paths "
        f"{emit * 1e3:.1f} ms [{smi}]")


@contextlib.contextmanager
def db_patched(db, index):
    """gmap_cli.main loads this db and index whatever its -D and
    --device say (the bench db and its index are already in memory)."""
    from unittest import mock

    from tpumap_torch.cli import gmap_cli
    with mock.patch.object(gmap_cli.GenomeDB, "load", lambda *_a: db), \
            mock.patch.object(gmap_cli.DeviceIndex, "from_host",
                              lambda *_a: index):
        yield


# main's argument lists held CPU == card: on the first N_GMAP_MAIN cDNAs,
# and -x 30 -f 1 on the first N_CHIM_CPU chimeras. 32 and 16, not 128
# and 64: at those the lists took 149 s (their CPU runs 101 s) of a
# 1,143-s run on one H100 host, too near the run's 1,200-s limit (at 256
# cDNAs, 234 s of a 1,101.6-s run)
N_GMAP_MAIN = 32
GMAP_MAIN_RUNS = (["-f", "3"], ["-A"], ["-S"], ["-f", "9"], ["-f", "samse"],
                  ["-x", "30", "-f", "1"])


def gmap_main_runs(db, index, queries, cseqs):
    """gmap_cli.main's stdout for each of GMAP_MAIN_RUNS on the device
    of index, with the echoed --device taken out, and its seconds."""
    qfa = write_fasta("gmap_main_q.fa", "q", queries[:N_GMAP_MAIN])
    cfa = write_fasta("gmap_main_chim.fa", "c", cseqs[:N_CHIM_CPU])
    dev = index.device.type
    out = []
    with db_patched(db, index):
        for extra in GMAP_MAIN_RUNS:
            t0 = time.perf_counter()
            text = gmap_main_text(["-D", "db", *extra, str(
                cfa if "-x" in extra else qfa), "--device", dev])
            out.append((text.replace(f" --device {dev}", ""),
                        time.perf_counter() - t0))
    return out


# ------------------------------------------------------------ staged path

# the staged path's kernels: name -> (module, plain version)
STAGED_WRAPPERS = (("verify_diagonals", "tpumap_torch.ops.verify",
                    "verify_diagonals_plain"),
                   ("banded_align", "tpumap_torch.ops.dp",
                    "banded_align_plain"),
                   ("traceback", "tpumap_torch.ops.dp", "traceback_plain"),
                   ("chain_dp", "tpumap_torch.ops.pathdp", "chain_dp_plain"),
                   ("scan_fragment", "tpumap_torch.ops.localscan",
                    "scan_fragment_plain"),
                   ("scan_exact_sites", "tpumap_torch.ops.localscan",
                    "scan_exact_sites_plain"))
STAGED_KERNELS = tuple(n for n, _m, _p in STAGED_WRAPPERS)
# kernel instances whose device time per staged batch is logged
STAGED_PARTS = (("K1", ("verify_kernel",)), ("K2", ("banded_kernel",)),
                ("K3", ("traceback_kernel",)), ("K5", ("chain_kernel",)),
                ("K6a", ("localscan_kernel<0, 4>",)),
                ("K6b", ("exact_sites_kernel",)))
# (mapped, junction precision, junction recall) floors: the RNA cells',
# and the staged phases' where tpumap's own grades on the same reads are
# below those, tpumap's less 0.01 (staged_bench.py: tpumap with JAX on
# the CPU of the H100 machine, its SAM byte-identical to the port's on
# all four workloads). The staged chain stage finds fewer junctions than
# the fused ladder's, and the transcriptome rung places reads that run
# past an exon end as spliced, in both packages.
RNA_FLOORS = (0.99, 0.99, 0.95)
TWOPASS_FLOORS = (0.99, 0.99, 0.92978)    # tpumap pass 2: recall 0.93978
FUSIONS_FLOORS = (0.99, 0.99, 0.60884)    # tpumap: recall 0.61884
TR_FLOORS = (0.97975, 0.94821, 0.86820)   # tpumap: 0.98975, 0.95821, 0.87820


@contextlib.contextmanager
def staged_calls():
    """Record each call of the staged path's kernel wrappers (name, args,
    kwargs; tensors by reference) while the block runs."""
    import importlib
    calls, saved = [], []
    for name, modname, _plain in STAGED_WRAPPERS:
        mod = importlib.import_module(modname)
        inner = getattr(mod, name)

        def rec(*a, _n=name, _f=inner, **kw):
            calls.append((_n, a, kw))
            return _f(*a, **kw)
        saved.append((mod, name, inner))
        setattr(mod, name, rec)
    try:
        yield calls
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)


def staged_kernel_rows(index, calls):
    """Each staged-path kernel against its plain version on the inputs
    of its call with the most rows in the recorded run (the first batch
    of pass 2 of rna_twopass), bounds as the kernel's other rows."""
    import importlib
    rows = []
    for name, modname, plain in STAGED_WRAPPERS:
        mine = [(a, kw) for n, a, kw in calls if n == name]
        if not mine:
            raise AssertionError(f"staged path: {name} never called")
        first = (lambda a: a[1]) if name == "verify_diagonals" else \
            (lambda a: a[0]["s"] if name == "chain_dp" else
             a[1] if name.startswith("scan") else a[0])
        a, kw = max(mine, key=lambda c: first(c[0]).shape[0])
        mod = importlib.import_module(modname)
        fn = partial(getattr(mod, name), *a, **kw)
        pfn = partial(getattr(mod, plain), *a, **kw)
        if name == "verify_diagonals":
            packed, diags = a[1], a[4]
            shape = f"staged: [{packed.shape[0]}, {packed.shape[1]}] x " \
                f"{diags.shape[1]}"
            work = verify_work(index, packed, diags)
        elif name == "banded_align":
            q, ql, g = a[0], a[1], a[2]
            W = 2 * a[4] + 1
            shape = f"staged: R={q.shape[0]}, Lq={q.shape[1]}, " \
                f"Lg={g.shape[1]}, band={a[4]}"
            work = (tensor_bytes(a[:4]), int(ql.sum()) * W * 12)
        elif name == "traceback":
            dirs = a[0]
            R, S = dirs.shape[0], dirs.shape[1] + 2 * a[3]
            shape = f"staged: R={R}, S={S}"
            work = (R * S + tensor_bytes(a[1:3]), R * S * 6)
        elif name == "chain_dp":
            R, K, L = a[0]["s"].shape
            shape = f"staged: R={R}, K={K}, L={L}"
            work = chain_work(a[0], a[1])
        elif name == "scan_fragment":
            g, ws, frag, flen, W, F = a[:6]
            shape = f"staged salvage: R={ws.shape[0]}, W={W}, F={F}"
            work = scan_work(g, ws, frag, flen, W, 4, 1)
        else:
            g, ws, frag, flen, W, F = a[:6]
            shape = f"staged review: R={ws.shape[0]}, W={W}, F={F}"
            work = exact_work(g, ws, frag, flen, W)
        rows.append(measure(name, shape, fn, pfn, 20, 1, *work))
        if rows[-1]["max_abs_err"] != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {shape}")
    return rows


def staged_fusion_reads(db):
    """staged_bench.fusion_reads as the port's Records, and their truth."""
    from tpumap_torch.io.fasta import Record
    reads, truth = fusion_reads(db)
    return [Record(n, "", s) for n, s in reads], truth


def check_rna_fusions(sam_bytes, truth, ftruth):
    """The RNA reads' primary records graded as check_rna (floors
    FUSIONS_FLOORS), and the fusion reads found at their loci (logged,
    no floor)."""
    msg = check_rna(rna_fusion_lines(sam_bytes), truth, FUSIONS_FLOORS)
    return (f"{msg}, fusion reads at their loci "
            f"{fusions_found(sam_bytes, ftruth)} of {len(ftruth)}")


def bench_transcriptome(bench_data, db):
    """The bench genes (staged_bench.genes_map) through the port's
    parse_map_fasta and build_iit, and their Transcriptome (trindex's
    defaults: k from the transcripts' total length, interval 1)."""
    from tpumap_torch.gsnap.transcriptome import build_transcriptome
    from tpumap_torch.io.iit import build_iit, parse_map_fasta
    return build_transcriptome(db, build_iit(parse_map_fasta(
        genes_map(bench_data))))


def twopass_phase(db, index, config, reads, truth, smi, jobs):
    """rna_twopass: two_pass_align over the RNA reads at batch RB, each
    pass's align_records call timed, graded and its launches counted
    apart (pass 1 the fused path, pass 2 the staged path with the learned
    KnownSplicing and KnownIndels); the staged kernels' calls of pass 2
    recorded for their rows. Returns (pass 2 launches, its calls, the
    learned tables)."""
    from tpumap_torch import kernels
    from tpumap_torch.gsnap import driver
    from tpumap_torch.gsnap.twopass import two_pass_align
    inner, passes = driver.align_records, []

    def timed(*a, **kw):
        kernels.reset_launches()
        t0 = time.perf_counter()
        if kw.get("known_indels") is not None:
            with staged_calls() as calls:
                out = inner(*a, **kw)
        else:
            calls, out = None, inner(*a, **kw)
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0, dict(kernels.LAUNCHES),
                       out, calls, kw.get("known_indels")))
        return out
    # warm-up: one staged batch
    from tpumap_torch.gsnap.knownindels import KnownIndels
    t0 = time.perf_counter()
    inner(db, index, reads[:RB], config, novelsplicing=True, batch_size=RB,
          known_indels=KnownIndels(np.zeros(0, np.uint64),
                                   np.zeros(0, np.int32),
                                   np.zeros(0, np.int64)),
          sink=io.BytesIO().write)
    torch.cuda.synchronize()
    log(f"RNA two-pass warm-up (one staged batch) "
        f"{time.perf_counter() - t0:.2f} s [{smi}]")
    driver.align_records = timed
    try:
        t0 = time.perf_counter()
        _recs, ks = two_pass_align(db, index, reads, config, batch_size=RB)
        dt = time.perf_counter() - t0
    finally:
        driver.align_records = inner
    (dt1, l1, out1, _, _), (dt2, l2, out2, calls, ki) = passes
    if ki is None:
        raise AssertionError("RNA two-pass: pass 1 learned no indel, so "
                             "pass 2 did not take the staged path")
    nb = -(-len(reads) // RB)
    for k, (dti, li, outi) in enumerate(((dt1, l1, out1), (dt2, l2, out2))):
        sam = b"".join(r.lines().encode() for r in outi)
        msg = check_rna(sam, truth, TWOPASS_FLOORS) if k else \
            ", ".join(f"{n}={v:.5f}" for n, v in zip(
                ("mapped_frac", "junction precision", "junction recall"),
                grade_rna(sam, truth)))
        log(f"RNA two-pass pass {k + 1} ({'staged' if k else 'fused'}): "
            f"{len(reads)} reads at batch {RB} in {dti:.3f} s = "
            f"{len(reads) / dti:.1f} reads/s, {msg}, launches={li} [{smi}]")
    log(f"RNA two-pass: {dt:.3f} s in all; learned KnownSplicing "
        f"{ks.nsites} sites ({len(ks.junctions)} junctions), KnownIndels "
        f"{ki.nsites} sites [{smi}]")
    missing = [k for k in STAGED_KERNELS if l2[k] <= 0]
    if missing:
        raise AssertionError(f"RNA two-pass pass 2: kernels never launched: "
                             f"{missing}")
    jobs.append(("RNA two-pass pass 2", lambda: inner(
        db, index, reads[:RB], config, novelsplicing=True, batch_size=RB,
        known=ks, known_indels=ki, sink=io.BytesIO().write), dt2 * 1e3 / nb))
    return l2, calls, ks, ki


def staged_layers(name, db, index, run, smi):
    """Host time of one staged batch by layer (wrappers around the
    driver's functions, host clock, no synchronisation added): encode
    (make_batch), cascade enqueue, cascade wait (the device program's
    rest and its copy to the host), tr rung, staged refine
    (refine_unsolved: its host work and its own launches, which it waits
    for), and emission with the rest of the loop."""
    from tpumap_torch.gsnap import driver, ladder, paired
    acc = {}
    wrapped = []

    def wrap(mod, attr, label):
        inner = getattr(mod, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0
            return out
        wrapped.append((mod, attr, inner))
        setattr(mod, attr, timed)

    def wrap_fetch(mod):
        inner = mod.start_fetch

        def start(dev):
            wait = inner(dev)

            def timed_wait():
                t0 = time.perf_counter()
                out = wait()
                acc["cascade wait"] = (acc.get("cascade wait", 0.0)
                                       + time.perf_counter() - t0)
                return out
            return timed_wait
        wrapped.append((mod, "start_fetch", inner))
        mod.start_fetch = start
    for mod in (driver, paired):
        wrap(mod, "make_batch", "encode")
        wrap(mod, "align_batch_cascaded_packed", "cascade enqueue")
        wrap(mod, "refine_unsolved", "staged refine")
    wrap(ladder, "align_batch_full", "cascade enqueue")
    wrap(driver, "_tr_rung", "tr rung")
    wrap_fetch(ladder)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for mod, attr, inner in wrapped:
            setattr(mod, attr, inner)
    acc["emission and the rest"] = total - sum(acc.values())
    log(f"{name}: one batch {total * 1e3:.1f} ms of host time: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in acc.items()) + f" [{smi}]")



# ------------------------------------------------- GSNAP as users run it

N_CLI_TR = 16384        # RNA reads of the -c run (the staged rna_tr's)
N_CLI_CPU = 2048        # DNA reads of the CPU == card lists
N_CLI_CPU_RNA = 512     # RNA reads and pairs of the CPU == card lists
# main's argument lists held CPU == card on the first N_CLI_CPU DNA reads
# ({OUT}: a directory of the run's own)
CLI_CPU_LISTS = ((), ("--sam-use-0M", "0"), ("-A", "default"),
                 ("-A", "m8"), ("--split-output", "{OUT}/s"),
                 ("--failed-input", "{OUT}/failed.fa"))


def cli_inputs(bench_data, db, smi):
    """Phase 15's inputs made by the port's own tools: the 400 bench
    genes as GFF3 (gene, mRNA and exon lines on chr1), through
    gff3_splicesites and iit_cli store (bench_splicesites.iit) and
    through gff3_introns (bench_introns.iit); the genes map
    (staged_bench.genes_map) through iit_cli store and trindex_cli
    (transcriptome benchtr under the db directory). The splice-site
    map's KnownSplicing must hold gene_known's 1,200 donors and
    acceptors, the intron map's all of gene_known (its junctions too).
    Returns the directory of the files."""
    from tpumap_torch.cli import converters, iit_cli, trindex_cli
    from tpumap_torch.gsnap.knownsplicing import KnownSplicing
    from tpumap_torch.io.iit import IIT
    t0 = time.perf_counter()
    d = bench_data.ROOT / "cli"
    d.mkdir(exist_ok=True)
    gff = ["##gff-version 3"]
    for g, exons in enumerate(bench_data.gene_table()):
        lo, hi = exons[0][0] + 1, exons[-1][0] + exons[-1][1]
        gff += [f"chr1\tbench\tgene\t{lo}\t{hi}\t.\t+\t.\tID=G{g}",
                f"chr1\tbench\tmRNA\t{lo}\t{hi}\t.\t+\t.\tID=T{g};Parent=G{g}"]
        gff += [f"chr1\tbench\texon\t{s + 1}\t{s + n}\t.\t+\t.\tParent=T{g}"
                for s, n in exons]
    (d / "bench_genes.gff3").write_text("\n".join(gff) + "\n")
    for conv, name in ((converters.gff3_splicesites_main,
                        "bench_splicesites"),
                       (converters.gff3_introns_main, "bench_introns")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            conv([str(d / "bench_genes.gff3")])
        (d / f"{name}.txt").write_text(buf.getvalue())
        if iit_cli.store_main(["-o", str(d / name), str(d / f"{name}.txt")]):
            raise AssertionError(f"iit_cli store of {name} failed")
    want = gene_known(bench_data)
    sites = KnownSplicing.from_splicing_iit(
        IIT.read(str(d / "bench_splicesites.iit")), db)
    introns = KnownSplicing.from_splicing_iit(
        IIT.read(str(d / "bench_introns.iit")), db)
    same = (len(want.junctions) == 1200
            and np.array_equal(sites.donor, want.donor)
            and np.array_equal(sites.acceptor, want.acceptor)
            and not len(sites.antidonor) and not len(sites.antiacceptor)
            and all(np.array_equal(getattr(introns, f), getattr(want, f))
                    for f in ("donor", "acceptor", "antidonor",
                              "antiacceptor", "junctions",
                              "anti_junctions")))
    log(f"port-built maps: bench_splicesites.iit {len(sites.donor)} "
        f"donors, {len(sites.acceptor)} acceptors; bench_introns.iit "
        f"{len(introns.junctions)} junctions; equal to gene_known's "
        f"{len(want.junctions)}: {same}")
    if not same:
        raise AssertionError("the port-built splice maps differ from "
                             "gene_known")
    (d / "bench_genes.txt").write_text("\n".join(genes_map(bench_data))
                                       + "\n")
    if iit_cli.store_main(["-o", str(d / "bench_genes"),
                           str(d / "bench_genes.txt")]):
        raise AssertionError("iit_cli store of bench_genes failed")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = trindex_cli.main(["-D", str(bench_data.ROOT / "db_k14"), "-c",
                               "benchtr", str(d / "bench_genes.iit")])
    if rc:
        raise AssertionError(f"trindex_cli failed: {err.getvalue()}")
    log(f"{err.getvalue().strip()}; the phase's inputs made in "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    return d


def gsnap_main(argv):
    """(return code, seconds, stdout, stderr) of gsnap_cli.main(argv),
    the card synchronised before the clock stops. Fails the run where
    align_records_isolated caught a failure: a group retried read by
    read, or a read reported as unmapped, with main's return still 0."""
    from tpumap_torch.cli import gsnap_cli
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = gsnap_cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    caught = [ln for ln in err.getvalue().splitlines()
              if "retrying reads individually" in ln
              or "reported as unmapped" in ln]
    if caught:
        raise AssertionError(f"gsnap main {argv}: {len(caught)} failures "
                             f"caught by align_records_isolated, the "
                             f"first: {caught[0]}")
    return rc, dt, out.getvalue(), err.getvalue()


def primary_lines(sam_bytes: bytes) -> bytes:
    """The SAM body's primary lines: no header, secondary or
    supplementary line."""
    return b"".join(ln for ln in sam_bytes.splitlines(keepends=True)
                    if ln[:1] != b"@"
                    and not int(ln.split(b"\t", 2)[1]) & 0x900)


@contextlib.contextmanager
def cli_layers(acc):
    """Host seconds of gsnap_cli.main's layers into acc while the block
    runs (wrappers on the host clock, no synchronisation added): the db
    load, the index upload, reading and preprocessing (the
    preprocess_reads or preprocess_pairs generator, read_seqs inside
    it), align_records_isolated or align_paired_records, record shaping
    (apply_sam_options, the work of main's shape) and SAM text (lines()
    of the Python and of the bulk emitter's records)."""
    from tpumap_torch.cli import gsnap_cli
    from tpumap_torch.io import sam, sam_bulk

    def add(label, t0):
        acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0

    outer = []      # a layer called inside another counts for the outer

    def timed(inner, label):
        def f(*a, **kw):
            if outer:
                return inner(*a, **kw)
            outer.append(label)
            t0 = time.perf_counter()
            try:
                return inner(*a, **kw)
            finally:
                add(label, t0)
                outer.pop()
        return f

    def timed_gen(inner, label):
        def f(*a, **kw):
            it = inner(*a, **kw)
            while True:
                t0 = time.perf_counter()
                try:
                    x = next(it)
                except StopIteration:
                    add(label, t0)
                    return
                add(label, t0)
                yield x
        return f
    patches = [(gsnap_cli.GenomeDB, "load", "db load", timed),
               (gsnap_cli.DeviceIndex, "from_host", "index upload", timed),
               (gsnap_cli, "preprocess_reads", "reading and preprocessing",
                timed_gen),
               (gsnap_cli, "preprocess_pairs", "reading and preprocessing",
                timed_gen),
               (gsnap_cli, "align_records_isolated",
                "align_records_isolated", timed),
               (gsnap_cli, "align_paired_records", "align_paired_records",
                timed),
               (sam, "apply_sam_options", "record shaping", timed),
               (sam.SamRecord, "lines", "SAM text", timed),
               (sam_bulk.RawSamRecord, "lines", "SAM text", timed)]
    saved = [(obj, attr, obj.__dict__[attr]) for obj, attr, _l, _w in patches]
    for obj, attr, label, wrap in patches:
        raw = obj.__dict__[attr]
        kind = type(raw) if isinstance(raw, (classmethod, staticmethod)) \
            else None
        setattr(obj, attr, kind(wrap(raw.__func__, label)) if kind
                else wrap(raw, label))
    try:
        yield acc
    finally:
        for obj, attr, orig in saved:
            setattr(obj, attr, orig)


def cli_timed(label, argv, smi, must_launch, check):
    """One timed gsnap_cli.main run with --time and -o to a file, the
    launch counters reset just before: the whole run's seconds (db load
    and index upload included) beside --time's reads/sec line, the
    grade of the output (check(SAM bytes)), the launches and the host
    layers (cli_layers). Returns (seconds, launches)."""
    from tpumap_torch import kernels
    out = ROOT / ".bench_data" / "cli" / f"{label.replace(' ', '_')}.sam"
    acc = {}
    kernels.reset_launches()
    with cli_layers(acc):
        rc, dt, _o, err = gsnap_main(argv + ["--time", "-o", str(out)])
    launches = dict(kernels.LAUNCHES)
    if rc:
        raise AssertionError(f"gsnap main {label} returned {rc}: {err}")
    body = out.read_bytes()
    rate = re.search(r"Aligned (\d+) reads in ([\d.]+) s \(([\d.]+) "
                     r"reads/sec\)", err)
    log(f"gsnap main {label}: {' '.join(argv[2:])}: {dt:.3f} s whole "
        f"(load and upload included); --time: "
        + (f"{rate.group(1)} reads in {rate.group(2)} s, {rate.group(3)} "
           f"reads/sec" if rate else "no reads/sec line")
        + f"; {check(body)}; launches={launches} [{smi}]")
    log(f"gsnap main {label} host layers: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in acc.items())
        + f", the rest {dt - sum(acc.values()):.3f} s of {dt:.3f} s [{smi}]")
    missing = [k for k in must_launch if launches[k] <= 0]
    if missing or not rate:
        raise AssertionError(f"gsnap main {label}: kernels never launched: "
                             f"{missing}, or no --time line")
    return dt, launches


def cli_cpu_card(argv, n, smi, min_lines):
    """gsnap_cli.main on the card and with --device cpu (the db loaded
    once for both): stdout and every file the run writes byte for byte,
    and at least min_lines lines in all."""
    from unittest import mock

    from tpumap_torch.cli import gsnap_cli
    from tpumap_torch.index.build import GenomeDB
    root = ROOT / ".bench_data" / "cli"
    db = GenomeDB.load(argv[1])
    got = []
    with mock.patch.object(gsnap_cli.GenomeDB, "load", lambda *_a: db):
        for dev in ("cuda", "cpu"):
            d = root / f"cmp_{dev}"
            if d.exists():
                for p in d.iterdir():
                    p.unlink()
            d.mkdir(exist_ok=True)
            a = [x.replace("{OUT}", str(d)) for x in argv] + ["--device",
                                                              dev]
            rc, dt, out, err = gsnap_main(a)
            if rc:
                raise AssertionError(f"gsnap main {a} returned {rc}: {err}")
            # the echoed command line names the run's directory and device
            files = {p.name: p.read_bytes().replace(str(d).encode(), b"")
                     .replace(f" --device {dev}".encode(), b"")
                     for p in sorted(d.iterdir())}
            got.append((out.replace(str(d), "").replace(
                f" --device {dev}", ""), files, dt))
    (gout, gfiles, gdt), (cout, cfiles, cdt) = got
    lines = gout.count("\n") + sum(v.count(b"\n") for v in gfiles.values())
    same = gout == cout and gfiles == cfiles
    log(f"gsnap main {' '.join(argv[2:-1])} on {n}: card {gdt:.2f} s, CPU "
        f"plain run {cdt:.1f} s: stdout and {len(gfiles)} files "
        f"byte-identical: {same} ({lines} lines) [{smi}]")
    if not same or lines < min_lines:
        raise AssertionError(f"gsnap main {argv}: CPU and card differ, or "
                             f"fewer than {min_lines} lines")


def gsnap_cli_phase(bench_data, db, rfa, rna_rfa, pe_files, truth, smi):
    """Phase 15: GSNAP as users run it, gsnap_cli.main in-process with
    argument lists. Returns the launches of the DNA, PE and RNA -N 1 -s
    runs ({"dna", "pe", "rna_known": launches})."""
    from tpumap_torch.cli import gsnap_cli
    from tpumap_torch.io.fasta import read_fasta
    d = cli_inputs(bench_data, db, smi)
    dbdir = str(bench_data.ROOT / "db_k14")
    base = ["-D", dbdir, "-d", "bench"]
    reads = list(read_fasta(rfa))
    rna = list(read_fasta(rna_rfa))

    def head(name, recs):
        """The records as a FASTA file under .bench_data/cli/."""
        path = d / name
        path.write_text("".join(f">{r.accession}\n{r.sequence}\n"
                                for r in recs))
        return path
    sub = {"dna_warm": head("dna_1024.fa", reads[:1024]),
           "dna_cpu": head("dna_cpu.fa", reads[:N_CLI_CPU]),
           "rna_tr": head("rna_tr.fa", rna[:N_CLI_TR]),
           "rna_cpu": head("rna_cpu.fa", rna[:N_CLI_CPU_RNA])}
    pe_cpu = [head(f"pe_cpu_{m}.fa", list(read_fasta(f))[:N_CLI_CPU_RNA])
              for m, f in zip((1, 2), pe_files)]
    rc, dt, _o, err = gsnap_main(base + [str(sub["dna_warm"]), "-o",
                                         str(d / "warm.sam")])
    if rc:
        raise AssertionError(f"gsnap main warm-up returned {rc}: {err}")
    log(f"gsnap main warm-up on 1,024 DNA reads: {dt:.2f} s [{smi}]")

    def dna(body):
        return check_dna(primary_lines(body), bench_data)
    runs = {}
    dt_dna, runs["dna"] = cli_timed(
        "DNA", base + [str(rfa)], smi, DNA_KERNELS, dna)
    cli_timed("DNA --sam-use-0M 0", base + ["--sam-use-0M", "0", str(rfa)],
              smi, DNA_KERNELS, dna)
    cli_timed("DNA --batch-size 32768", base + ["--batch-size", "32768",
                                                str(rfa)], smi, DNA_KERNELS,
              dna)
    runs["pe"] = cli_timed(
        "PE", base + [str(f) for f in pe_files], smi, DNA_KERNELS,
        lambda body: check_pe(primary_lines(body), bench_data))[1]
    runs["rna_known"] = cli_timed(
        "RNA -N 1 -s", base + ["-N", "1", "-s",
                               str(d / "bench_splicesites.iit"),
                               str(rna_rfa)], smi, GSNAP_KERNELS,
        lambda body: check_rna(primary_lines(body), truth))[1]
    cli_timed("RNA -N 1 -c benchtr", base + ["-N", "1", "-c", "benchtr",
                                             str(sub["rna_tr"])], smi,
              DNA_KERNELS[:1], lambda body: check_rna(
                  primary_lines(body), truth[:N_CLI_TR], TR_FLOORS))
    # the device time and the wall of one more run of the default
    # command, both under the profiler (which slows the host: the timed
    # run's wall is given beside them)
    wall = []
    dev = profile_ms(lambda: wall.append(gsnap_main(
        base + [str(rfa), "-o", str(d / "profiled.sam")])[1]))
    dev_ms = sum(v for k, v in dev.items() if isinstance(k, str))
    log(f"gsnap main DNA default, profiled run: device time {dev_ms:.1f} "
        f"ms of {wall[0] * 1e3:.1f} ms of wall: idle "
        f"{1 - dev_ms / (wall[0] * 1e3):.3f} (the timed run's wall "
        f"{dt_dna * 1e3:.1f} ms) [{smi}]" if dev_ms else
        f"gsnap main DNA default: device time not measured (the profile "
        f"holds no device events) [{smi}]")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = gsnap_cli.main(["--check"])
    log(f"gsnap main --check: {rc} ({err.getvalue().strip()!r}) [{smi}]")
    if rc != 0:
        raise AssertionError("gsnap main --check failed on the card")
    # CPU == card, byte for byte
    for extra in CLI_CPU_LISTS:
        cli_cpu_card(base + list(extra) + [str(sub["dna_cpu"])], N_CLI_CPU,
                     smi, int(0.99 * N_CLI_CPU) if "m8" in extra
                     else N_CLI_CPU)
    cli_cpu_card(base + ["-N", "1", "-s", str(d / "bench_splicesites.iit"),
                         str(sub["rna_cpu"])], N_CLI_CPU_RNA, smi,
                 N_CLI_CPU_RNA)
    cli_cpu_card(base + [str(p) for p in pe_cpu], N_CLI_CPU_RNA, smi,
                 2 * N_CLI_CPU_RNA)
    return runs


def k7a_wide_rows(reduce_ns):
    """K7a's wide kernel (past 1,024 segments a problem; its arrays in
    a global scratch) against its plain version at S = 1,025 and 2,048,
    every segment valid, at N = 1 and at one wave of the one-warp floor's
    model (64 problems an SM), with the bound of S one-warp steps at the
    probe's step (k7a_row). No bench path has more than 512 segments a
    problem, so it launches there 0 times."""
    rng = np.random.default_rng(1025)
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for S in (1025, 2048):
        for N in (1, nsm * 64):
            starts = rng.integers(0, 4000, (N, S))
            lens = rng.integers(0, 120, (N, S))
            d = ((1 << 20) + rng.integers(0, 4000, (N, 1))
                 + np.where(rng.random((N, S)) < 0.7, starts * 3,
                            rng.integers(-500, 60_000, (N, S))))
            segs = {k: torch.from_numpy(np.ascontiguousarray(
                v, dtype=np.int32)).cuda() for k, v in (
                ("diag", d), ("qstart", starts), ("qend", starts + lens),
                ("weight", rng.integers(1, 40, (N, S))))}
            segs["valid"] = torch.ones((N, S), dtype=torch.bool,
                                       device="cuda")
            row = k7a_row("wide kernel", (segs, 128, 500_000), reduce_ns)
            row["symbols"] = ("chain_segments_wide_kernel",)
            rows.append(row)
    return check_rows(rows)


# ------------------------------------------------ phase 16: multi-device

N_MESH_PE = 2048        # PE pairs of the device_ctx run
SHARD_B = 8192          # reads a call of the sharded aligners
N_SHARD_RNA = 16384     # RNA reads of the index-sharded full aligner
N_SHARD_CPU = 2048      # DNA reads of the sharded CPU == card checks
N_SHARD_CPU_RNA = 512   # RNA reads of the same
N_WINDOWS = 4           # genome windows of the large-genome path
WINDOW_OVERLAP = 1024
N_MP_DNA = 8192         # DNA reads of the two-process -O run
N_MP_RNA = 16384        # RNA reads of the two-process --two-pass run

# one process of a two-process gloo group: rank and the gsnap argument
# list ("{rank}" replaced) from the command line. gsnap's --device cuda
# puts the process on card LOCAL_RANK, or rank modulo the cards; the
# process then prints the card it ran on and the bytes it allocated on
# each card
MP_WORKER = r"""
import json
import sys
sys.modules["jax"] = None
sys.modules["tpumap"] = None
import torch
import torch.distributed as tdist
addr, rank = sys.argv[1], int(sys.argv[2])
tdist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=2,
                         rank=rank)
from tpumap_torch.cli import gsnap_cli
rc = gsnap_cli.main([a.replace("{rank}", str(rank)) for a in sys.argv[3:]])
tdist.destroy_process_group()
print(json.dumps({"rank": rank, "card": torch.cuda.current_device(),
                  "peak_bytes": [torch.cuda.max_memory_allocated(i) for i
                                 in range(torch.cuda.device_count())]}))
sys.exit(rc or 0)
"""


def grid_devices(n):
    """n devices for a grid: the machine's distinct cards where it has n,
    else cuda:0 n times (shards that share the card run on it in turn)."""
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def mesh_axes():
    """16a's data axes: 2, and 4 where the machine has four cards."""
    return (2, 4) if torch.cuda.device_count() >= 4 else (2,)


def card_launches():
    """{card: {kernel: launches}} of the kernels launched since the last
    reset, zeros left out."""
    from tpumap_torch import kernels
    return {f"cuda:{c}": {k: n for k, n in v.items() if n}
            for c, v in sorted(kernels.CARD_LAUNCHES.items())}


# (kernel, card) of every launch on a card but cuda:0 in phase 16's
# timed runs (note_cards after each)
CARDS_SEEN = set()


def note_cards():
    from tpumap_torch import kernels
    CARDS_SEEN.update((k, c) for c, v in kernels.CARD_LAUNCHES.items()
                      for k, n in v.items() if n and c)


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed_call(fn):
    """(fn(), seconds), every card synchronised before either clock
    read."""
    sync_all()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return out, time.perf_counter() - t0


def _merged(iv):
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for s_, e in sorted(iv):
        if out and s_ <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s_, e])
    return out


def _covered(merged, starts, s_, e):
    """The length of [s_, e] that the merged intervals (with their starts)
    cover."""
    import bisect
    i = max(bisect.bisect_right(starts, s_) - 1, 0)
    tot = 0.0
    while i < len(merged) and merged[i][0] < e:
        tot += max(0.0, min(e, merged[i][1]) - max(s_, merged[i][0]))
        i += 1
    return tot


def card_busy(label, fn, smi):
    """One call of fn (after one untraced) traced with torch.profiler: each
    card's busy ms (the union of its kernels', copies' and memsets'
    intervals) and idle share of the call's wall time, their sum, the
    union of all cards' busy intervals, and per card the ms it was busy
    while no other card was (with the kernels that took most of it):
    the work that still runs in turn. Copies between cards carry no
    card in the trace: they stay out of the cards' sums and union and
    are logged on their own. Also which cards reach each other by peer
    access."""
    fn()
    sync_all()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync_all()
        wall = (time.perf_counter() - t0) * 1e3
    path = ROOT / ".bench_data" / "card_busy_trace.json"
    prof.export_chrome_trace(str(path))
    per, between = collections.defaultdict(list), []
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            ts = float(e["ts"])
            iv = (ts, ts + float(e["dur"]), e.get("name", "?"))
            card = e.get("args", {}).get("device")
            if card is None:
                between.append(iv)
            else:
                per[int(card)].append(iv)
    path.unlink()
    if not per:
        log(f"{label}, traced: no device events in the trace (device time "
            f"not measured) [{smi}]")
        return
    merged = {d: _merged([(a, b) for a, b, _n in v]) for d, v in per.items()}
    busy = {d: sum(b - a for a, b in m) / 1e3
            for d, m in sorted(merged.items())}
    total = sum(busy.values())
    union = sum(b - a for a, b in _merged(
        [(a, b) for v in per.values() for a, b, _n in v])) / 1e3
    alone, names = {}, {}
    for d, v in sorted(per.items()):
        others = _merged([(a, b) for o, w in per.items() if o != d
                          for a, b, _n in w])
        starts = [m[0] for m in others]
        by = collections.Counter()
        for a, b, n in v:
            by[n[:60]] += (b - a - _covered(others, starts, a, b)) / 1e3
        alone[d] = sum(by.values())
        names[d] = [(n, round(t, 3)) for n, t in by.most_common(3)]
    between_ms = sum(b - a for a, b in _merged(
        [(a, b) for a, b, _n in between])) / 1e3
    n = torch.cuda.device_count()
    peers = [f"{i}->{j}" for i in range(n) for j in range(n)
             if i != j and torch.cuda.can_device_access_peer(i, j)]
    log(f"{label}, traced (profiler on): wall {wall:.2f} ms; busy ms a card "
        + ", ".join(f"cuda:{d} {t:.3f} (idle {1 - t / wall:.3f})"
                    for d, t in busy.items())
        + f"; sum {total:.3f} ms, union of the cards' busy intervals "
        f"{union:.3f} ms (union / sum {union / total:.3f}); busy while no "
        f"other card was, ms: "
        + ", ".join(f"cuda:{d} {alone[d]:.3f} (most: {names[d]})"
                    for d in busy)
        + f"; copies between cards (no card in the trace, left out above): "
        f"{len(between)}, {between_ms:.3f} ms "
        f"{sorted({n for _a, _b, n in between})[:3]}; peer access: "
        f"{peers or 'none'} [{smi}]")


def gff3_text(db, hits, enc):
    """-f 3 GFF3 of bulk hits (query names q0, q1, ...)."""
    from tpumap_torch.io import gff3
    out = []
    for i, h in enumerate(hits):
        if h is None:
            continue
        c, off = h
        ci = db.chrnum(off + c.exons[0].gstart)
        out.append(gff3.match_cdna(
            c, f"q{i}", db.chrom_names[ci], "tpumap",
            chrom_offset=off - int(db.chrom_offsets[ci]),
            qlen=len(enc[i][0])))
    return "".join(out)


def split_layers(label, fn, smi):
    """One call of fn by layer: its wall ms, its device ms (every kernel,
    copy and memset) and, of that, the concatenations and copies that
    gather the shards' rows (the all-gathers of tpumap's programs) and
    K1's; the host's share (the loop over shards, the wrappers, the
    copies to the host) is the rest of the wall."""
    fn()
    _r, wall = timed_call(fn)
    prof = profile_ms(fn)
    names = [k for k in prof if isinstance(k, str)]
    dev = sum(prof[k] for k in names)
    gather = sum(prof[k] for k in names
                 if "CatArray" in k or ("Memcpy" in k and "DtoD" in k))
    k1 = sum(prof[k] for k in names if "verify_kernel" in k)
    wall *= 1e3
    log(f"{label}, one call by layer: wall {wall:.2f} ms, device "
        + (f"{dev:.3f} ms (gathers {gather:.3f}, K1 {k1:.3f}), idle "
           f"{1 - dev / wall:.3f}" if dev else "time not measured")
        + f" [{smi}]")


def mesh_phase(db, index, config, reads, rna_reads, pe_pairs, enc, smi):
    """16a: align_records (DNA at batch 32,768; RNA with novel splicing
    at 16,384), align_paired_records (2,048 pairs) and
    align_queries_bulk (2,048 cDNAs, GFF3) with a MeshContext of data
    axis 2, and of data axis 4 where the machine has four cards, each
    byte-identical to the same call without device_ctx; rates beside the
    single-device call's, launches a card beside the single device's.
    With two cards or more, one DNA batch through each grid is traced
    (card_busy). Returns each run's launches (at data axis 4 under the
    case's name and " x4")."""
    from tpumap_torch import kernels
    from tpumap_torch.cli import gmap_cli
    from tpumap_torch.gsnap.driver import align_records
    from tpumap_torch.gsnap.paired import align_paired_records
    from tpumap_torch.parallel import mesh, pipeline

    def gsnap(fn, batch, **kw):
        def run(idx, c, items):
            buf = io.BytesIO()
            fn(db, idx, items, config, batch_size=batch, sink=buf.write,
               device_ctx=c, **kw)
            return buf.getvalue()
        return run

    def gmap(idx, c, items):
        return gff3_text(db, gmap_cli.align_queries_bulk(
            db, idx, items, device_ctx=c), items)
    cases = (("DNA", reads, gsnap(align_records, B), 1, DNA_KERNELS, B),
             ("RNA", rna_reads, gsnap(align_records, RB, novelsplicing=True),
              1, GSNAP_KERNELS, RB),
             ("PE", pe_pairs[:N_MESH_PE],
              gsnap(align_paired_records, PB, pairmax=PAIRMAX), 2,
              DNA_KERNELS, N_MESH_PE),
             ("GMAP", enc, gmap, 1, GMAP_KERNELS, GMAP_WARM))
    out, single = {}, {}
    for axis in mesh_axes():
        devs = grid_devices(axis)
        ctx, dt = timed_call(lambda: pipeline.MeshContext(
            mesh.make_mesh(devices=devs), db))
        log(f"16a: MeshContext over {[str(d) for d in devs]}: "
            f"{len(ctx.indexes)} index copies placed in {dt:.2f} s [{smi}]")
        for name, items, run, per, must, warm in cases:
            run(ctx.index, ctx, items[:warm])   # warm-up through the grid
            if name not in single:
                kernels.reset_launches()
                want, t1 = timed_call(lambda: run(index, None, items))
                single[name] = (want, t1, sum(kernels.LAUNCHES.values()))
            want, t1, one = single[name]
            kernels.reset_launches()
            ctx.rows.split = ctx.rows.whole = 0
            got, t2 = timed_call(lambda: run(ctx.index, ctx, items))
            launches = dict(kernels.LAUNCHES)
            note_cards()
            cards = {f"cuda:{c}": sum(v.values())
                     for c, v in sorted(kernels.CARD_LAUNCHES.items())}
            n = per * len(items)
            unit = "queries" if name == "GMAP" else "reads"
            log(f"16a {name} through the MeshContext of data axis {axis}: "
                f"{n} {unit} in {t2:.3f} s = {n / t2:.1f} {unit}/s (single "
                f"device {t1:.3f} s = {n / t1:.1f}); byte-identical to the "
                f"single-device call: {got == want} ({len(want)} bytes); "
                f"stage calls split {ctx.rows.split}, whole "
                f"{ctx.rows.whole}; launches={launches}; launches a card "
                f"{cards} (single device {one}) [{smi}]")
            if got != want:
                raise AssertionError(f"16a {name}: the MeshContext's output "
                                     f"differs from the single-device "
                                     f"call's")
            missing = [k for k in must if launches[k] <= 0]
            if missing or not ctx.rows.split:
                raise AssertionError(f"16a {name}: never launched "
                                     f"{missing}, or no stage split "
                                     f"({ctx.rows.split})")
            out[name if axis == 2 else f"{name} x{axis}"] = launches

        def dna_batch(idx, c):
            return lambda: align_records(db, idx, reads[:B], config,
                                         batch_size=B,
                                         sink=io.BytesIO().write,
                                         device_ctx=c)
        if axis == 2:
            split_layers(f"16a DNA batch of {B}, single device",
                         dna_batch(index, None), smi)
        split_layers(f"16a DNA batch of {B}, MeshContext"
                     + (f" of data axis {axis}" if axis != 2 else ""),
                     dna_batch(ctx.index, ctx), smi)
        if len(set(devs)) > 1:
            card_busy(f"16a DNA batch of {B}, MeshContext of data axis "
                      f"{axis}", dna_batch(ctx.index, ctx), smi)
        del ctx
    return out


@contextlib.contextmanager
def k1_calls():
    """Record each K1 wrapper call's arguments while the block runs."""
    from tpumap_torch.ops import verify
    vd = verify.verify_diagonals
    calls = []

    def rec(*args, **kw):
        calls.append(args)
        return vd(*args, **kw)
    verify.verify_diagonals = rec
    try:
        yield calls
    finally:
        verify.verify_diagonals = vd


def encode(records, B_):
    """codes, nmask and lengths of records in a batch of B_ rows (128)."""
    from tpumap_torch.gsnap.driver import make_batch
    b = make_batch(records, B_, 128)
    return {k: b[k] for k in ("codes", "nmask", "lengths")}


def batched(align, arrays, records, per_batch):
    """align over records in batches of SHARD_B rows (the tail padded);
    per_batch(result, records of the batch, first read) for each."""
    for s in range(0, len(records), SHARD_B):
        chunk = records[s:s + SHARD_B]
        per_batch(align(arrays, encode(chunk, SHARD_B)), chunk, s)


def near_truth(bench_data, diags, strands, mapped):
    """(mapped fraction, within 10 bp of truth on its strand) of the DNA
    reads' results (univcoords)."""
    starts, tstrands, _subs = bench_data.read_plan()
    n = len(starts)
    near = (mapped & (np.abs(diags.astype(np.int64) - starts[:n]) <= 10)
            & (strands == tstrands[:n].astype(np.int64)))
    return float(mapped.mean()), float(near.mean())


def dna_grade(label, res_iter, bench_data, smi, extra=""):
    """Collect (diag univcoords, strand, mapped) over all DNA reads and
    apply the 0.99 floors."""
    d, s, m = (np.concatenate(x) for x in zip(*res_iter))
    mapped, near = near_truth(bench_data, d, s, m)
    log(f"{label}: mapped {mapped:.5f}, within 10 bp of truth {near:.5f}"
        f"{extra} [{smi}]")
    if mapped < 0.99 or near < 0.99:
        raise AssertionError(f"{label}: below 0.99")


def same_results(label, cpu, card, smi):
    """CPU == card, every result array."""
    same = sorted(cpu) == sorted(card) and all(
        torch.equal(cpu[k].cpu(), card[k].cpu()) for k in cpu)
    log(f"{label}: CPU == card on every result array: {same} "
        f"({len(cpu)} arrays) [{smi}]")
    if not same:
        raise AssertionError(f"{label}: CPU and card results differ")


def k1_row(label, call):
    """K1 against its plain version on one recorded call's inputs."""
    from tpumap_torch.ops import verify
    li, packed = call[0], call[1]
    return measure("verify_diagonals", label,
                   partial(verify.verify_diagonals, *call),
                   partial(verify.verify_diagonals_plain, *call), 50, 10,
                   *verify_work(li, packed, call[4]))


def sharded_phase(bench_data, db, config, reads, rna_reads, truth, smi):
    """16b: make_sharded_aligner at 1 x 4 and make_sharded_full_aligner
    at 2 x 2 over the 50,000 DNA reads (floors 0.99), the full aligner
    over the first 16,384 RNA reads (junctions logged), CPU == card on
    2,048 DNA and 512 RNA reads; K1's row at the sharded cascade's shape.
    Returns ({run: launches}, [K1 row])."""
    from tpumap_torch import kernels
    from tpumap_torch.ops import pathdp
    from tpumap_torch.parallel import mesh, sharded
    cpu4 = [torch.device("cpu")] * 4
    launches, rows = {}, []
    sc = pathdp.PathScoring(max_intron=200_000)
    fkw = dict(scoring=sc, splicing=True, salvage=True,
               r_chain=SHARD_B // 4, r_salv=SHARD_B // 64,
               r_indel=SHARD_B // 8)
    for label, shards, make, kw in (
            ("1 x 4", 4, sharded.make_sharded_aligner, {}),
            ("2 x 2 full", 2, sharded.make_sharded_full_aligner, fkw)):
        (arrays, align), dt = timed_call(lambda: make(
            mesh.make_mesh(4, index_shards=shards,
                           devices=grid_devices(4)), db, config, **kw))
        log(f"16b {label}: the index in {shards} oligo shards placed in "
            f"{dt:.2f} s [{smi}]")
        got = []
        kernels.reset_launches()
        with k1_calls() as calls:
            _r, dt = timed_call(lambda: batched(
                align, arrays, reads, lambda r, ch, _s: got.append(
                    (r["diag"][:len(ch)].cpu().numpy(),
                     r["strand"][:len(ch)].cpu().numpy().astype(np.int64),
                     r["mapped"][:len(ch)].cpu().numpy()))))
        launches[f"sharded {label} DNA"] = dict(kernels.LAUNCHES)
        per_card = card_launches()
        note_cards()
        if label == "1 x 4":
            rows.append(k1_row(f"sharded cascade (1 x 4): [{SHARD_B}, "
                               f"{config.top_k}]", calls[0]))
        del calls
        dna_grade(f"16b {label} over {len(reads)} DNA reads", got,
                  bench_data, smi, f", {len(reads) / dt:.1f} reads/s, "
                  f"launches={launches[f'sharded {label} DNA']}, a card "
                  f"{per_card}")
        # the full aligner trims (K4); neither has the ends rung
        need = ("verify_diagonals",) + (("trim_stage",) if kw else ())
        missing = [k for k in need if kernels.LAUNCHES[k] <= 0]
        if missing:
            raise AssertionError(f"16b {label}: never launched: {missing}")
        batch = encode(reads[:SHARD_B], SHARD_B)
        split_layers(f"16b {label} ({shards} index shards), {SHARD_B} "
                     f"reads", lambda: align(arrays, batch), smi)
        if torch.cuda.device_count() >= 4:
            card_busy(f"16b {label}, {SHARD_B} reads",
                      lambda: align(arrays, batch), smi)
        cpu_arrays, cpu_align = make(mesh.make_mesh(
            4, index_shards=shards, devices=cpu4), db, config, **kw)
        sub = encode(reads[:N_SHARD_CPU], N_SHARD_CPU)
        same_results(f"16b {label}, {N_SHARD_CPU} DNA reads",
                     cpu_align(cpu_arrays, sub), align(arrays, sub), smi)
        if label == "2 x 2 full":
            sub = encode(rna_reads[:N_SHARD_CPU_RNA], N_SHARD_CPU_RNA)
            same_results(f"16b {label}, {N_SHARD_CPU_RNA} RNA reads",
                         cpu_align(cpu_arrays, sub), align(arrays, sub), smi)
            tp = fp = fn = 0
            kernels.reset_launches()

            def score(r, ch, s):
                nonlocal tp, fp, fn
                pred = [set() for _ in ch]
                sel = r["ch_sel"].cpu().numpy()
                idx = r["ch_idx"].cpu().numpy()
                ns = r["ch_nsegs"].cpu().numpy()
                sq = r["ch_segq"].cpu().numpy().astype(np.int64)
                sd = r["ch_segd"].cpu().numpy()
                for c in np.nonzero(sel)[0]:
                    i = int(idx[c])
                    if i < len(ch):
                        pred[i] = {(int(sd[c, t] + sq[c, t + 1]),
                                    int(sd[c, t + 1] + sq[c, t + 1]))
                                   for t in range(int(ns[c]) - 1)}
                for i, pj in enumerate(pred):
                    tj = truth[s + i][0]
                    tp += len(pj & tj)
                    fp += len(pj - tj)
                    fn += len(tj - pj)
            _r, dt = timed_call(lambda: batched(
                align, arrays, rna_reads[:N_SHARD_RNA], score))
            launches[f"sharded {label} RNA"] = dict(kernels.LAUNCHES)
            note_cards()
            log(f"16b {label} over {N_SHARD_RNA} RNA reads: "
                f"{N_SHARD_RNA / dt:.1f} reads/s, junction precision "
                f"{tp / max(tp + fp, 1):.5f}, recall "
                f"{tp / max(tp + fn, 1):.5f} (the device's accepted chain "
                f"rows; no floor), launches="
                f"{launches[f'sharded {label} RNA']} [{smi}]")
        del arrays, align, cpu_arrays, cpu_align
    return launches, rows


def large_phase(bench_data, config, reads, smi):
    """16c: a large=True (uint64 positions) build of the bench genome,
    cached under .bench_data/db_k14_large, in N_WINDOWS windows
    overlapping by WINDOW_OVERLAP on a 1 x N_WINDOWS grid: the 50,000 DNA
    reads rebased to uint64 (floors 0.99), CPU == card on 2,048, K1's
    row at a window's shape. Returns (launches, [K1 row])."""
    from tpumap_torch import kernels
    from tpumap_torch.index.build import GenomeDB, build_db
    from tpumap_torch.index.device import DeviceIndex
    from tpumap_torch.parallel import large, mesh
    t0 = time.perf_counter()
    dbdir = bench_data.ROOT / "db_k14_large"
    if (dbdir / "meta.json").exists():
        dbl = GenomeDB.load(str(dbdir))
    else:
        gfa, _rfa = bench_data.ensure_files()
        dbl = build_db(gfa, name="bench_large", k=14, interval=3, large=True)
        dbl.save(str(dbdir))
    if dbl.positions.dtype != np.uint64:
        raise AssertionError("16c: the large build's positions are not "
                             "uint64")
    try:
        DeviceIndex.from_host(dbl, "cuda")
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("16c: DeviceIndex took a uint64 db")
    t1 = time.perf_counter()
    parts = large.shard_genome_host(dbl, N_WINDOWS, WINDOW_OVERLAP)
    t2 = time.perf_counter()
    arrays, align, bases = large.make_genome_sharded_aligner(
        mesh.make_mesh(N_WINDOWS, index_shards=N_WINDOWS,
                       devices=grid_devices(N_WINDOWS)), dbl, config,
        WINDOW_OVERLAP, parts=parts)
    torch.cuda.synchronize()
    log(f"16c: large=True build ready in {t1 - t0:.1f} s (positions "
        f"{dbl.positions.dtype}; DeviceIndex refuses it: {refusal!r}); "
        f"{N_WINDOWS} windows (bases {bases.tolist()}) indexed in "
        f"{t2 - t1:.1f} s, on the card in {time.perf_counter() - t2:.1f} s "
        f"[{smi}]")
    got = []
    kernels.reset_launches()
    with k1_calls() as calls:
        _r, dt = timed_call(lambda: batched(
            align, arrays, reads, lambda r, ch, _s: got.append(
                (large.rebase_results(r, bases)[:len(ch)],
                 r["strand"][:len(ch)].cpu().numpy().astype(np.int64),
                 r["mapped"][:len(ch)].cpu().numpy()))))
    launches = dict(kernels.LAUNCHES)
    per_card = card_launches()
    note_cards()
    row = k1_row(f"genome window (1 x {N_WINDOWS}): [{SHARD_B}, "
                 f"{config.top_k}]", calls[0])
    del calls
    if got[0][0].dtype != np.uint64:
        raise AssertionError("16c: rebase_results is not uint64")
    dna_grade(f"16c windows over {len(reads)} DNA reads", got, bench_data,
              smi, f", {len(reads) / dt:.1f} reads/s, launches={launches}, "
              f"a card {per_card}")
    batch = encode(reads[:SHARD_B], SHARD_B)
    split_layers(f"16c {N_WINDOWS} windows, {SHARD_B} reads",
                 lambda: align(arrays, batch), smi)
    if torch.cuda.device_count() >= N_WINDOWS:
        card_busy(f"16c {N_WINDOWS} windows, {SHARD_B} reads",
                  lambda: align(arrays, batch), smi)
    cpu_arrays, cpu_align, _b = large.make_genome_sharded_aligner(
        mesh.make_mesh(N_WINDOWS, index_shards=N_WINDOWS,
                       devices=[torch.device("cpu")] * N_WINDOWS), dbl,
        config, WINDOW_OVERLAP, parts=parts)
    sub = encode(reads[:N_SHARD_CPU], N_SHARD_CPU)
    same_results(f"16c windows, {N_SHARD_CPU} DNA reads",
                 cpu_align(cpu_arrays, sub), align(arrays, sub), smi)
    return launches, [row]


def run_pair(argv, timeout=600, local_rank=False):
    """gsnap_cli.main(argv) in two processes of a gloo group on this
    host, each on its own card where the machine has two (card rank
    modulo the cards; with local_rank, LOCAL_RANK set to the rank as
    torchrun sets it), else both on the one card; fails the run where
    either fails, or where two cards are there and the processes did not
    each run on, and allocate only on, card rank. Returns each process's
    report (MP_WORKER)."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", MP_WORKER, f"127.0.0.1:{port}", str(r)]
        + argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, **({"LOCAL_RANK": str(r)} if local_rank
                                else {})))
        for r in range(2)]
    reports = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode:
                raise AssertionError(f"16d: process {r} of {argv} returned "
                                     f"{p.returncode}: "
                                     f"{err.decode()[-2000:]}")
            reports.append(json.loads(out.decode().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if torch.cuda.device_count() >= 2:
        for r, rep in enumerate(reports):
            if rep["card"] != r or [i for i, b in enumerate(
                    rep["peak_bytes"]) if b] != [r]:
                raise AssertionError(f"16d: process {r} did not run on "
                                     f"card {r} alone: {rep}")
    return reports


def two_process_phase(bench_data, reads, rna_reads, smi):
    """16d: two processes in a gloo group, each on its own card where the
    machine has two (run_pair), else sharing the one: gsnap -O over
    the first 8,192 DNA reads with no --part (each takes its rank's
    shard), process 0's file byte-identical to the one-process run's and
    process 1's empty; --two-pass over the first 16,384 RNA reads (with
    LOCAL_RANK set where there are two cards), both processes'
    --splices-dump and --indels-dump equal (pass 1 learns a junction
    from one read, so each process's half teaches some)."""
    where = ("each on its own card" if torch.cuda.device_count() >= 2
             else "sharing the card")

    def cards(reports):
        return "; ".join(f"process {r['rank']} ran on cuda:{r['card']}, "
                         f"peak bytes a card {r['peak_bytes']}"
                         for r in reports)
    d = bench_data.ROOT / "multi"
    d.mkdir(exist_ok=True)
    dbdir = str(bench_data.ROOT / "db_k14")
    for name, recs in (("dna.fa", reads[:N_MP_DNA]),
                       ("rna.fa", rna_reads[:N_MP_RNA])):
        (d / name).write_text("".join(f">{r.accession}\n{r.sequence}\n"
                                      for r in recs))
    base = ["-D", dbdir, "-O", "--no-sam-headers", str(d / "dna.fa")]
    rc, t1, _o, err = gsnap_main(base + ["-o", str(d / "one.sam")])
    if rc:
        raise AssertionError(f"16d: the one-process run returned {rc}: "
                             f"{err}")
    reps, t2 = timed_call(lambda: run_pair(base + ["-o",
                                                   str(d / "p{rank}.sam")]))
    one = (d / "one.sam").read_bytes()
    p0, p1 = ((d / f"p{r}.sam").read_bytes() for r in range(2))
    log(f"16d gsnap -O, {N_MP_DNA} DNA reads: one process {t1:.2f} s, two "
        f"processes {where} {t2:.2f} s (whole runs, start-up "
        f"included); process 0's file byte-identical to the one-process "
        f"run's: {p0 == one} ({len(one)} bytes), process 1's empty: "
        f"{p1 == b''}; {cards(reps)} [{smi}]")
    if p0 != one or p1 != b"" or one.count(b"\n") < N_MP_DNA:
        raise AssertionError("16d: the merged -O output differs")
    reps, t3 = timed_call(lambda: run_pair(
        ["-D", dbdir, "-N", "1", "--two-pass", "--pass1-min-support", "1",
         "--splices-dump",
         str(d / "s{rank}"), "--indels-dump", str(d / "i{rank}"), "-o",
         str(d / "tp{rank}.sam"), str(d / "rna.fa")],
        local_rank=torch.cuda.device_count() >= 2))
    sizes = []
    for kind in ("s", "i"):
        a, b = (np.load(d / f"{kind}{r}.npz") for r in range(2))
        same = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[f], b[f]) for f in a.files)
        sizes.append(f"{kind}: {[len(a[f]) for f in a.files]} equal {same}")
        if not same or (kind == "s" and not len(a["junctions"])):
            raise AssertionError(f"16d: the two processes' {kind} dumps "
                                 f"differ, or no junction was learned")
    log(f"16d gsnap --two-pass, {N_MP_RNA} RNA reads in two processes "
        f"{where}: {t3:.2f} s; the gathered tables each process dumped: "
        f"{'; '.join(sizes)}; {cards(reps)} [{smi}]")


# each hand kernel's wrapper and plain version: (kernel, module, wrapper,
# plain version); sharded.py calls K4's wrapper by its own name
CARD_WRAPPERS = (
    ("verify_diagonals", "tpumap_torch.ops.verify", "verify_diagonals",
     "verify_diagonals_plain"),
    ("banded_align", "tpumap_torch.ops.dp", "banded_align",
     "banded_align_plain"),
    ("traceback", "tpumap_torch.ops.dp", "traceback", "traceback_plain"),
    ("chain_dp", "tpumap_torch.ops.pathdp", "chain_dp", "chain_dp_plain"),
    ("scan_fragment", "tpumap_torch.ops.localscan", "scan_fragment",
     "scan_fragment_plain"),
    ("scan_exact_sites", "tpumap_torch.ops.localscan", "scan_exact_sites",
     "scan_exact_sites_plain"),
    ("scan_fragment_runs", "tpumap_torch.ops.localscan",
     "scan_fragment_runs", "scan_fragment_runs_plain"),
    ("chain_segments", "tpumap_torch.ops.chain", "chain_compact",
     "chain_compact_plain"),
    ("region_anchors", "tpumap_torch.ops.chain", "region_anchors",
     "region_anchors_plain"),
    ("end_lanes", "tpumap_torch.gsnap.engine", "end_lanes",
     "end_lanes_plain"),
    ("trim_stage", "tpumap_torch.gsnap.engine", "_trim_stage",
     "trim_stage_plain"),
    ("trim_stage", "tpumap_torch.parallel.sharded", "_trim_stage", None))


def _first_tensor(x):
    """The first tensor among x's arguments, dicts and tuples, or None."""
    if isinstance(x, torch.Tensor):
        return x
    vals = (x.values() if isinstance(x, dict)
            else x if isinstance(x, (tuple, list)) else ())
    for v in vals:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


@contextlib.contextmanager
def other_card_calls():
    """While the block runs, keep the arguments (tensors by reference) of
    each kernel wrapper's call with the most rows on each card but
    cuda:0: {(kernel, card): (rows, args, kwargs)}."""
    import importlib
    calls, saved = {}, []
    for name, modname, attr, _plain in CARD_WRAPPERS:
        mod = importlib.import_module(modname)
        inner = getattr(mod, attr)

        def rec(*a, _n=name, _f=inner, **kw):
            t = _first_tensor((a, kw))
            if t is not None and t.is_cuda and t.device.index:
                rows = t.shape[0] if t.ndim else 1
                key = (_n, t.device.index)
                if key not in calls or calls[key][0] < rows:
                    calls[key] = (rows, a, kw)
            return _f(*a, **kw)
        saved.append((mod, attr, inner))
        setattr(mod, attr, rec)
    try:
        yield calls
    finally:
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)


def other_card_check(calls, smi):
    """Each recorded call again on its card, the wrapper (its kernel)
    against its plain version on the same inputs: exact equality. Every
    kernel launched on a card but cuda:0 in phase 16's timed runs
    (CARDS_SEEN) must have a recorded call there, and where the machine
    has more cards than cuda:0, each card but cuda:0 of 16a's widest
    grid must have launched."""
    import importlib
    plain = {n: (m, a, p) for n, m, a, p in CARD_WRAPPERS if p}
    for (name, card), (rows, a, kw) in sorted(calls.items()):
        modname, attr, pname = plain[name]
        mod = importlib.import_module(modname)
        with torch.cuda.device(card):
            got = getattr(mod, attr)(*a, **kw)
            want = getattr(mod, pname)(*a, **kw)
        if name == "region_anchors":
            got, want = got[0::2], want[0::2]
        err = max_abs_err(got, want)
        log(f"16: {name} on cuda:{card}, its call of the most rows there "
            f"({rows}): max_abs_err {err} against its plain version on "
            f"cuda:{card} [{smi}]")
        if err:
            raise AssertionError(f"16: {name} on cuda:{card} disagrees with "
                                 f"its plain version")
    cards = range(1, max(len(set(grid_devices(a))) for a in mesh_axes()))
    missing = sorted(CARDS_SEEN - set(calls)) + [
        c for c in cards if not any(sc == c for _k, sc in CARDS_SEEN)]
    if missing:
        raise AssertionError(f"16: launches on these cards with no recorded "
                             f"call, or cards with no launch: {missing}")
    log(f"16: {len(calls)} kernel calls on cards but cuda:0 equal their "
        f"plain versions there; launched there: {sorted(CARDS_SEEN)} "
        f"[{smi}]")


def phase16(bench_data, db, index, config, reads, rna_reads, pe_pairs,
            gmap_enc, truth, smi):
    """Phase 16 (16a-d), every kernel call on a card but cuda:0 held
    against its plain version there; (launches of 16a, 16b, 16c; K1's
    rows of 16b and 16c)."""
    t16 = time.perf_counter()
    with other_card_calls() as calls:
        mesh_launches = mesh_phase(db, index, config, reads, rna_reads,
                                   pe_pairs, gmap_enc, smi)
        shard_launches, shard_rows = sharded_phase(
            bench_data, db, config, reads, rna_reads, truth, smi)
        win_launches, win_rows = large_phase(bench_data, config, reads, smi)
    other_card_check(calls, smi)
    del calls
    two_process_phase(bench_data, reads, rna_reads, smi)
    log(f"phase 16 in {time.perf_counter() - t16:.1f} s [{smi}]")
    return mesh_launches, shard_launches, win_launches, shard_rows + win_rows


def phase16_alone(smi, tree):
    """chip_smoke.py --phase16 [--tree DIR]: the bench data, the index
    and GMAP's cDNAs, then phase 16 alone (this file's phase16; with
    --tree, DIR's chip_smoke.py's phase-16 functions as its main calls
    them, each tree in a process of its own, for A/B comparisons).
    Logs K1's rows; the last line is the result line."""
    from gmap_bench import N_GMAP, SEED, gmap_queries
    from tpumap_torch.gsnap.engine import AlignConfig
    from tpumap_torch.index.device import DeviceIndex
    from tpumap_torch.io.fasta import read_fasta
    from tpumap_torch.utils import dna
    bench_data, db, rfa = load_index(smi)
    index = DeviceIndex.from_host(db, "cuda")
    reads = list(read_fasta(rfa))
    _gfa, rna_rfa = bench_data.ensure_rna_files()
    rna_reads = list(read_fasta(rna_rfa))
    truth = bench_data.rna_truth()
    f1, f2 = bench_data.ensure_pe_files()
    pe_pairs = list(zip(read_fasta(f1), read_fasta(f2)))
    enc = [dna.encode(q) for q in gmap_queries(db, N_GMAP, SEED)[0]]
    config = AlignConfig(top_k=4, max_occ=4)
    log(f"phase 16's inputs ready [{smi}]")
    if tree is None:
        *_l, rows = phase16(bench_data, db, index, config, reads, rna_reads,
                            pe_pairs, enc, truth, smi)
    else:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "tree_chip_smoke", pathlib.Path(tree) / "chip_smoke.py")
        cs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cs)
        t16 = time.perf_counter()
        cs.mesh_phase(db, index, config, reads, rna_reads, pe_pairs, enc,
                      smi)
        _s, rows = cs.sharded_phase(bench_data, db, config, reads,
                                    rna_reads, truth, smi)
        _w, wrows = cs.large_phase(bench_data, config, reads, smi)
        rows += wrows
        cs.two_process_phase(bench_data, reads, rna_reads, smi)
        log(f"phase 16 in {time.perf_counter() - t16:.1f} s [{smi}]")
    log(json.dumps({"phase16_k1_rows": [
        {k: v for k, v in r.items() if not callable(v)} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main():
    t_all = time.perf_counter()
    argv = sys.argv[1:]
    if "--tree" in argv:                # tpumap_torch from another tree
        sys.path.insert(0, str(pathlib.Path(
            argv[argv.index("--tree") + 1]).resolve()))
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gpu = torch.cuda.get_device_name(0)
    log(smi)

    def mark(what):
        """Where the run's time goes (its limit is 1,200 s)."""
        log(f"{what}: {time.perf_counter() - t_all:.1f} s into the run "
            f"[{smi}]")

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
    if "--rows" in argv:
        chain_proc.communicate()
        return rows_phase(smi)
    if "--phase16" in argv:
        chain_proc.communicate()
        return phase16_alone(smi, argv[argv.index("--tree") + 1]
                             if "--tree" in argv else None)
    chain = {k: v for k, v in ptxas.items() if k.startswith("chain_kernel")}
    if not chain:
        raise AssertionError("no ptxas report of K5 in the build log")
    if any(v[1] or v[2] or v[3] for v in chain.values()):
        raise AssertionError(f"K5 instances with stack or spills: {chain}")
    # K2's instance at the indel band: ceil((2 * band + 1) / 32) cells a
    # lane
    from tpumap_torch.gsnap.params import INDEL_BAND
    k2 = f"banded_kernel<{-(-(2 * INDEL_BAND + 1) // 32)}>"
    # K7a's instances (segments a lane, gaps past its table) and wide
    # kernel; K7b's (32-bit slot table, 32-bit counts)
    k7 = ([f"chain_segments_kernel<{p}, {b}>" for p in (1, 2, 4, 8, 16, 32)
           for b in (0, 1)]
          + [f"chain_segments_wide_kernel<{b}>" for b in (0, 1)]
          + ["chain_gap_table_kernel"]
          + [f"region_anchors_count_kernel<{g}, {w}>" for g in (0, 1)
             for w in (0, 1)]
          + [f"region_anchors_{f}_kernel<{w}>" for f in ("scan", "place")
             for w in (0, 1)]
          + [f"region_anchors_fill_kernel<{v}>" for v in (1, 4)])
    # K8's scratch path and register paths (lanes a thread, reads a
    # warp, probe), K4's warp a row and segments of 1-32 lanes a row
    k8k4 = ([f"end_lanes_kernel<{p}>" for p in ("0, 1, 0", "1, 1, 0",
                                                "1, 1, 1", "1, 2, 0",
                                                "1, 2, 1", "8, 1, 0",
                                                "8, 1, 1")]
            + [f"trim_kernel<{s}>" for s in (0, 1, 2, 4, 8, 16, 32)])
    for name in (k2, "traceback_kernel", "localscan_kernel<0, 4>",
                 "localscan_kernel<0, 8>", "exact_sites_kernel", *k7,
                 *k8k4):
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

    mark("bench data, indexes and probes ready")
    rows = kernel_phase(index, smi, known, mindex)
    mark("kernel rows done")

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

    # the staged path: two-pass, fusions, the transcriptome rung single
    # and paired
    tw_launches, tw_calls, tw_ks, tw_ki = twopass_phase(
        db, index, config, rna_reads, truth, smi, jobs)
    rows += staged_kernel_rows(index, tw_calls)
    del tw_calls
    fu_reads, fu_truth = staged_fusion_reads(db)
    fus_launches = run_e2e(
        "RNA fusions", rna_reads[:RB] + fu_reads, RB, smi, index,
        single(novelsplicing=True, find_fusions=True),
        lambda buf: check_rna_fusions(buf, truth[:RB], fu_truth),
        STAGED_KERNELS[:4], jobs)
    t0 = time.perf_counter()
    trans = bench_transcriptome(bench_data, db)
    tr_index = {"cuda": DeviceIndex.from_host(trans.trdb, "cuda")}
    torch.cuda.synchronize()
    log(f"transcriptome of {trans.ntranscripts} bench genes: "
        f"{trans.trdb.genome_length} bp, k={trans.trdb.k}, built and on "
        f"the card in {time.perf_counter() - t0:.2f} s [{smi}]")

    def single_tr(idx, items, batch, sink, stats=None):
        dtype = idx.device.type
        if dtype not in tr_index:
            tr_index[dtype] = DeviceIndex.from_host(trans.trdb, dtype)
        align_records(db, idx, items, config, batch_size=batch, sink=sink,
                      stats=stats, novelsplicing=True,
                      tr=(trans, tr_index[dtype]))
    tr_launches = run_e2e("RNA tr", rna_reads[:RB], RB, smi, index,
                          single_tr,
                          lambda buf: check_rna(buf, truth[:RB], TR_FLOORS),
                          GSNAP_KERNELS, jobs)
    pe_tr_run = paired(pairmax=PAIRMAX, tr=(trans, None))
    pe_tr_launches = run_e2e("PE tr", pe_pairs[:PB], PB, smi, index,
                             pe_tr_run,
                             lambda buf: check_pe(buf, bench_data, PB),
                             STAGED_KERNELS[:3], jobs, reads_per_item=2)

    cmet_reads = [Record(r.accession, "", cmet(r.sequence)) for r in reads]
    cmet_run = single(cmet_config, mdb)
    cmet_launches = run_e2e("cmet", cmet_reads, B, smi, mindex, cmet_run,
                            lambda buf: check_cmet(buf, bench_data),
                            ("verify_diagonals",) + ENDS_KERNELS, jobs)
    s_reads, n_alt = snp_reads(bench_data, snp_coords, snp_alts)
    snp_run = single(snp_config, mdb)
    snp_launches = run_e2e("SNP", s_reads, B, smi, mindex, snp_run,
                           lambda buf: check_snp(buf, bench_data, n_alt),
                           ("verify_diagonals",) + ENDS_KERNELS, jobs)
    mark("GSNAP phases done")
    gmap_launches, k7, gmap_q, gmap_truth, gmap_enc = gmap_phase(
        db, index, smi, jobs)
    rows += gmap_kernel_rows(db, index, k7, reduce_ns)
    gap_args = next(a for n, a in k7 if n == "chain_segments")
    del k7
    paths_launches, chim_launches, picks, cseqs = gmap_paths_phase(
        db, index, gmap_q, gmap_truth, gmap_enc, smi, jobs)
    rows += gmap_paths_rows(picks, reduce_ns, N_PATHS)
    del picks
    rows += k7a_wide_rows(reduce_ns)
    mark("GMAP phases done")
    cli_runs = gsnap_cli_phase(bench_data, db, rfa, rna_rfa, (f1, f2), truth,
                               smi)
    mark("gsnap CLI phase done")
    # phase 16: several devices, large genomes, several processes
    mesh_launches, shard_launches, win_launches, p16_rows = phase16(
        bench_data, db, index, config, reads, rna_reads, pe_pairs, gmap_enc,
        truth, smi)
    rows += p16_rows

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
                paired(cmet_config, mdb, pairmax=PAIRMAX), True),
               ("RNA two-pass pass 2", rna_reads[:N_CPU_RNA],
                single(novelsplicing=True, known=tw_ks, known_indels=tw_ki),
                False),
               ("RNA fusions", rna_reads[:N_CPU_RNA - 128] + fu_reads[:128],
                single(novelsplicing=True, find_fusions=True), False),
               ("RNA tr", rna_reads[:N_CPU_RNA], single_tr, False),
               ("PE tr", pe_pairs[:N_CPU_RNA // 2], pe_tr_run, False)]
    gpu_sam = []
    for _name, sub, run, modes in subsets:
        gbuf = io.BytesIO()
        run(mindex if modes else index, sub, len(sub), gbuf.write)
        gpu_sam.append(gbuf.getvalue())
    gpu_gff = gmap_gff3(db, index, gmap_q)
    gpu_main = gmap_main_runs(db, index, gmap_q, cseqs)
    gmap_layers(db, index, gmap_q, gmap_enc, smi)
    gmap_paths_layers(db, index, gmap_q, gmap_enc[:2 * GMAP_WARM], smi)
    mark("card runs of the CPU == card checks and GMAP layers done")
    profile_rows(rows, smi, chain_ns)
    gap_table_fill(gap_args, smi)
    del gap_args
    staged = ("RNA two-pass pass 2", "RNA fusions", "RNA tr", "PE tr")
    for job in jobs:
        profile_batch(*job, smi, GMAP_PARTS if job[0].startswith("GMAP")
                      else STAGED_PARTS if job[0] in staged else BATCH_PARTS)
        if job[0] in ("RNA", "RNA -s", "RNA two-pass pass 2"):
            frag_lengths(job[0], job[1], smi)
        if job[0] in staged:
            staged_layers(job[0], db, index, job[1], smi)
    frag_lengths("PE RNA repair", lambda: rep_run(
        index, rep_pairs, N_REPAIR, io.BytesIO().write), smi)
    mark("profiles done")
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
    cpu_gff = gmap_gff3(db, cpu_index, gmap_q)
    for fmt, c, g in zip(("-f 3", "-f 2"), cpu_gff, gpu_gff):
        log(f"GMAP {fmt}: CPU plain run of {GMAP_WARM} cDNAs (both formats "
            f"{time.perf_counter() - t0:.1f} s): GFF3 byte-identical to the "
            f"GPU run: {c == g} ({len(g)} bytes) [{smi}]")
        if c != g or g.count("\n") < GMAP_WARM:
            raise AssertionError(f"GMAP {fmt}: CPU and GPU GFF3 differ")
    cpu_main = gmap_main_runs(db, cpu_index, gmap_q, cseqs)
    for extra, (c, ct), (g, gt) in zip(GMAP_MAIN_RUNS, cpu_main, gpu_main):
        nq = N_CHIM_CPU if "-x" in extra else N_GMAP_MAIN
        log(f"GMAP main {' '.join(extra)} on {nq} cDNAs: CPU plain run "
            f"{ct:.1f} s, card {gt:.2f} s: byte-identical: {c == g} "
            f"({len(g)} bytes) [{smi}]")
        if c != g or g.count("\n") < nq:
            raise AssertionError(f"GMAP main {' '.join(extra)}: CPU and "
                                 f"card output differ")
    mark("CPU runs of the CPU == card checks done")
    if "jax" in sys.modules and sys.modules["jax"] is not None:
        raise AssertionError("JAX was imported")
    loaded = [m for m in sys.modules if m.split(".")[0] == "tpumap"
              and sys.modules[m] is not None]
    if loaded:
        raise AssertionError(f"tpumap was imported: {loaded}")

    phases = {"dna": dna_launches, "rna": rna_launches,
              "rna_known": known_launches, "pe": pe_launches,
              "pe_repair": rep_launches, "cmet": cmet_launches,
              "snp": snp_launches, "gmap": gmap_launches,
              "gmap_paths": paths_launches, "gmap_chimeras": chim_launches,
              "rna_twopass": tw_launches, "rna_fusions": fus_launches,
              "rna_tr": tr_launches, "pe_tr": pe_tr_launches,
              "cli_dna": cli_runs["dna"], "cli_pe": cli_runs["pe"],
              "cli_rna_known": cli_runs["rna_known"],
              "mesh_dna": mesh_launches["DNA"],
              "mesh_rna": mesh_launches["RNA"],
              "mesh_pe": mesh_launches["PE"],
              "mesh_gmap": mesh_launches["GMAP"],
              "sharded_1x4": shard_launches["sharded 1 x 4 DNA"],
              "sharded_2x2_dna": shard_launches["sharded 2 x 2 full DNA"],
              "sharded_2x2_rna": shard_launches["sharded 2 x 2 full RNA"],
              "windows": win_launches}
    n_batches = {"dna": -(-len(reads) // B), "rna": -(-len(rna_reads) // RB),
                 "rna_known": -(-len(rna_reads) // RB),
                 "pe": -(-len(pe_pairs) // PB), "pe_repair": 1,
                 "cmet": -(-len(cmet_reads) // B),
                 "snp": -(-len(s_reads) // B), "gmap": 1,
                 "gmap_paths": N_PATHS, "gmap_chimeras": len(cseqs),
                 "rna_twopass": -(-len(rna_reads) // RB),
                 "rna_fusions": -(-(RB + N_FUSION) // RB), "rna_tr": 1,
                 "pe_tr": 1, "cli_dna": -(-len(reads) // 1024),
                 "cli_pe": -(-len(pe_pairs) // 1024),
                 "cli_rna_known": -(-len(rna_reads) // 1024),
                 "mesh_dna": -(-len(reads) // B),
                 "mesh_rna": -(-len(rna_reads) // RB),
                 "mesh_pe": -(-N_MESH_PE // PB), "mesh_gmap": 1,
                 "sharded_1x4": -(-len(reads) // SHARD_B),
                 "sharded_2x2_dna": -(-len(reads) // SHARD_B),
                 "sharded_2x2_rna": -(-N_SHARD_RNA // SHARD_B),
                 "windows": -(-len(reads) // SHARD_B)}
    per_batch = {name: {ph: launches[name] / n_batches[ph]
                        for ph, launches in phases.items()}
                 for name in SOURCES}
    log("launches per batch (" + ", ".join(
        f"{ph} {n}" for ph, n in n_batches.items()) + " batches):")
    for name, pb in per_batch.items():
        log(f"  {name:18s} " + "  ".join(f"{ph} {v:g}"
                                         for ph, v in pb.items()))

    # one entry per kernel, at its first (largest) main-path shape, with
    # all its rows; launches from the RNA run, which drives all nine
    # GSNAP kernels, or from the GMAP run (K7a, K7b), and each phase's
    # launches per batch beside them (a GMAP batch: the 2,048-cDNA call;
    # on gmap_paths and gmap_chimeras a batch is one query).
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
                                        "library_device_ms",
                                        "calls_per_query",
                                        "replaced_device_ms",
                                        "sorts_device_ms",
                                        "bound_sectors_ms")
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


def check_dna(sam_bytes, bench_data):
    aligned, near = grade(sam_bytes, bench_data)
    if aligned < 0.99 or near < 0.99:
        raise AssertionError(f"DNA accuracy below 0.99: aligned {aligned}, "
                             f"near truth {near}")
    return f"aligned_frac={aligned:.5f}, within 10 bp of truth={near:.5f}"


def check_pe(sam_bytes, bench_data, n=None):
    conc, near = grade_pe(sam_bytes, bench_data, n)
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


def check_rna(sam_bytes, truth, floors=RNA_FLOORS):
    mapped, prec, rec = grade_rna(sam_bytes, truth)
    msg = (f"mapped_frac={mapped:.5f}, junction precision={prec:.5f}, "
           f"junction recall={rec:.5f}")
    if any(v < f for v, f in zip((mapped, prec, rec), floors)):
        raise AssertionError(f"RNA accuracy below its floor: {msg}")
    return msg


if __name__ == "__main__":
    sys.exit(main())
