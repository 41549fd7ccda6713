"""tpumap_torch gsnap: short-read alignment CLI (port of
tpumap/cli/gsnap_cli.py, every option of its parser and its defaults).

    python -m tpumap_torch.cli.gsnap_cli -D DIR/NAME [options] r1.fq [r2.fq]

Mirrors the behaviorally-meaningful subset of the reference gsnap flags
(src/gsnap.c:581-742), as tpumap's main does: -D/-d database, -A output
format (sam/m8/default), -N novel splicing, -s known splicing, -c
transcriptome, -v SNPs, --mode cmet/atoi/ttoc, --two-pass, --part
modular input sharding (src/inbuffer.c:96-124), --failed-input
(src/gsnap.c:725), --split-output per-category files (src/gsnap.c:720-
726), --time (src/gmap.c:4777), single or paired input files. The run is
on the card unless --device cpu asks for the CPU; --part takes its shard
from the option alone (a process group's default shard is ROADMAP item
15).
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from tpumap_torch import __version__
from tpumap_torch.cli._errors import clean_errors
from tpumap_torch.gsnap.driver import (METHODS, align_records,
                                       align_records_isolated)
from tpumap_torch.gsnap.engine import AlignConfig
from tpumap_torch.gsnap.paired import align_paired_records
from tpumap_torch.index.build import GenomeDB
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io import sam
from tpumap_torch.io.fasta import (ReadOptions, check_pair_names,
                                   preprocess_pairs, preprocess_reads,
                                   read_seqs)
from tpumap_torch.parallel import distributed
from tpumap_torch.utils.trace import Recorder, recording


def stats_recording(on: bool):
    """--stats: a Recorder installed for the alignment, or nothing."""
    return recording(Recorder()) if on else contextlib.nullcontext()


def write_stats(rec: Recorder | None) -> None:
    """--stats: each method's reads with its share of the reads that have
    a method, then every other counter, then each span's calls, self and
    total time (utils/trace.py)."""
    if rec is None:
        return
    out = sys.stderr
    methods = {k: v for k, v in rec.counters.items() if k in METHODS}
    total = sum(methods.values()) or 1
    for m, c in sorted(methods.items(), key=lambda kv: -kv[1]):
        out.write(f"method {m}: {c} ({100.0 * c / total:.1f}%)\n")
    for k in sorted(set(rec.counters) - set(methods)):
        out.write(f"counter {k}: {rec.counters[k]}\n")
    for name in sorted(rec.calls, key=lambda n: -rec.self_ns[n]):
        out.write(f"span {name}: {rec.calls[name]} calls, self "
                  f"{rec.self_ns[name] / 1e6:.3f} ms, total "
                  f"{rec.total_ns[name] / 1e6:.3f} ms\n")


def run_check() -> int:
    """--check: verify the port's runtime assumptions (the analog of the
    reference's compiler-assumption self-check, gmapindex -9 / gsnap
    --check): torch with a CUDA device, the kernels' build, and the
    numpy integer arithmetic the coordinates rely on."""
    import numpy as np
    ok = True
    if torch.cuda.is_available():
        sys.stderr.write(f"torch {torch.__version__}: "
                         f"{torch.cuda.get_device_name(0)} "
                         f"({torch.cuda.device_count()} device(s))\n")
        try:
            from tpumap_torch import kernels
            kernels.build()
            sys.stderr.write("CUDA kernels built and loaded\n")
        except Exception as exc:   # pragma: no cover - environment specific
            sys.stderr.write(f"CUDA kernels unavailable: {exc}\n")
            ok = False
    else:
        sys.stderr.write(f"torch {torch.__version__}: no CUDA device\n")
        ok = False
    # univcoord arithmetic relies on uint32 wraparound and 8-byte uint64
    assert (np.array([2**32 - 1], np.uint32)
            + np.array([1], np.uint32))[0] == 0
    assert np.dtype(np.uint64).itemsize == 8
    sys.stderr.write("numpy integer assumptions ok\n")
    sys.stderr.write("check: ok\n" if ok else "check: FAILED\n")
    return 0 if ok else 1


def parse_part(spec: str) -> tuple[int, int]:
    i, _, n = spec.partition("/")
    i, n = int(i), int(n)
    if not 0 <= i < n:
        raise ValueError(f"bad --part {spec}: need 0 <= i < n")
    return i, n


class OutputRouter:
    """Output file management: single stream, or per-category files when
    --split-output is set (the reference's Outbuffer split-output mode).

    Categories follow src/samflags.h: nomapping, unpaired_uniq,
    unpaired_mult, concordant_uniq, concordant_mult, halfmapping_uniq,
    unpaired (paired-end both-unpaired).
    """

    def __init__(self, split_base: str | None, default_out, append=False):
        self.split_base = split_base
        self.default = default_out
        self.append = append
        self.files = {}

    def get(self, category: str):
        if not self.split_base:
            return self.default
        if category not in self.files:
            mode = "a" if self.append else "w"
            self.files[category] = open(
                f"{self.split_base}.{category}", mode)
        return self.files[category]

    def close(self):
        for f in self.files.values():
            f.close()

    @staticmethod
    def single_category(rec: sam.SamRecord) -> str:
        if rec.flag & 4:
            return "nomapping"
        return "unpaired_uniq" if rec.mapq > 0 else "unpaired_mult"

    @staticmethod
    def paired_category(r1: sam.SamRecord, r2: sam.SamRecord) -> str:
        m1, m2 = not (r1.flag & 4), not (r2.flag & 4)
        if not m1 and not m2:
            return "nomapping"
        if m1 != m2:
            return "halfmapping_uniq"
        if r1.flag & 2:
            return ("concordant_uniq" if min(r1.mapq, r2.mapq) > 0
                    else "concordant_mult")
        return "unpaired_uniq"


@clean_errors
def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="tpumap_torch-gsnap")
    ap.add_argument("-D", "--dir", help="database directory")
    ap.add_argument("-d", "--db", help="database name (informational)")
    ap.add_argument("-A", "--format", default="sam",
                    choices=["sam", "m8", "default", "standard", "gsnap"],
                    help="output format (note: the reference defaults to "
                         "its native format; tpumap_torch-gsnap defaults to "
                         "sam — use -A default for the native format)")
    ap.add_argument("-N", "--novelsplicing", type=int, default=0)
    ap.add_argument("-c", "--use-transcriptome", dest="use_transcriptome",
                    help="transcriptome index name (built with "
                         "tpumap-trindex) for transcriptome-guided "
                         "alignment")
    ap.add_argument("-s", "--use-splicing", dest="use_splicing",
                    help="known splice sites/introns map (.iit from "
                         "iit_store, or .npz from --splices-dump)")
    ap.add_argument("-v", "--use-snps", dest="use_snps", action="store_true",
                    help="SNP-tolerant alignment (db must be prepared with "
                         "tpumap-snpindex)")
    ap.add_argument("--mode", default="standard",
                    choices=["standard", "cmet-stranded", "atoi-stranded",
                             "ttoc-stranded"])
    ap.add_argument("--two-pass", action="store_true", dest="two_pass",
                    help="learn splice sites in pass 1, realign in pass 2")
    ap.add_argument("--splices-dump", dest="splices_dump",
                    help="write learned splice sites (.npz) after pass 1")
    ap.add_argument("--splices-read", dest="splices_read",
                    help="read previously learned splice sites (.npz)")
    ap.add_argument("-n", "--npaths", type=int, default=100,
                    help="maximum alignments to report per read "
                         "(co-optimal extras are flagged secondary; "
                         "reference default 100, src/gsnap.c:523)")
    ap.add_argument("--pairmax", type=int, default=None,
                    help="max genomic span for a concordant pair "
                         "(overrides --pairmax-dna/--pairmax-rna)")
    ap.add_argument("--pairmax-dna", dest="pairmax_dna", type=int,
                    default=2000,
                    help="pairmax when splicing is off (src/gsnap.c:378)")
    ap.add_argument("--pairmax-rna", dest="pairmax_rna", type=int,
                    default=200_000,
                    help="pairmax when -N/-s splicing is on")
    ap.add_argument("--pairexpect", type=int, default=1000,
                    help="expected insert length; tie-breaks equal-score "
                         "pairings (src/gsnap.c:383)")
    ap.add_argument("--pairdev", type=int, default=100,
                    help="allowed insert-length deviation: scales the "
                         "concordance insert penalty and bounds "
                         "ambiguous-splice-end mate arbitration "
                         "(src/gsnap.c:384)")
    ap.add_argument("--max-intron", type=int, default=None,
                    help="max intron length for novel splices")
    ap.add_argument("-w", "--localsplicedist", dest="max_intron",
                    type=int, help="alias for --max-intron "
                                   "(src/gsnap.c shortsplicedist)")
    ap.add_argument("-Y", "--max-insertions", dest="max_insertions",
                    type=int, default=6,
                    help="max insertion length (src/gsnap.c:407)")
    ap.add_argument("-Z", "--max-deletions", dest="max_deletions",
                    type=int, default=9,
                    help="max deletion length (src/gsnap.c:408)")
    ap.add_argument("--indel-endlength", dest="indel_endlength", type=int,
                    default=4,
                    help="min matched length at ends flanking an indel "
                         "(src/gsnap.c min_indel_end_matches)")
    ap.add_argument("--query-unk-mismatch", dest="query_unk_mismatch",
                    type=int, default=0, choices=[0, 1],
                    help="count query N bases as mismatches")
    ap.add_argument("--genome-unk-mismatch", dest="genome_unk_mismatch",
                    type=int, default=1, choices=[0, 1],
                    help="count genome N bases as mismatches")
    ap.add_argument("--min-coverage", dest="min_coverage", type=float,
                    default=0.0,
                    help="drop alignments covering less than this "
                         "fraction of the read")
    ap.add_argument("--find-dna-chimeras", dest="find_dna_chimeras",
                    type=int, default=None, choices=[0, 1],
                    help="distant splicing with poor sites "
                         "(alias of --find-fusions)")
    ap.add_argument("--use-localdb", dest="use_localdb", type=int,
                    default=1, choices=[0, 1],
                    help="enable the regional salvage scan "
                         "(localdb equivalent)")
    ap.add_argument("--merge-distant-samechr", dest="merge_distant_samechr",
                    action="store_true",
                    help="report colinear same-chromosome distant splices "
                         "as one SAM line with an N gap")
    ap.add_argument("--pass1-min-support", dest="pass1_min_support",
                    type=int, default=20,
                    help="reads required to learn an intron in --two-pass "
                         "pass 1 (src/gsnap.c:381)")
    ap.add_argument("--resolve-inner", dest="resolve_inner", type=int,
                    default=1,
                    help="resolve soft-clipping on the insides of "
                         "paired-end reads: dovetail overhangs past the "
                         "mate's distal boundary are soft-clipped "
                         "(src/pathpair-eval.c:410; default 1)")
    ap.add_argument("-V", "--snpsdir", dest="snpsdir", default=None,
                    help="accepted for compatibility; the SNP index "
                         "lives inside the database directory")
    ap.add_argument("--splicingdir", dest="splicingdir", default=None,
                    help="directory holding the -s splicing map")
    ap.add_argument("--chrsubset", dest="chrsubset", default=None,
                    help="restrict reported alignments to this "
                         "chromosome")
    # accepted-for-compatibility long tail (obsolete/deprecated/unused
    # reference options; see src/gsnap.c)
    ap.add_argument("--end-detail", default=None,
                    help="deprecated in the reference; accepted and "
                         "ignored")
    ap.add_argument("--split-simple", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("--show-univdiagonal", dest="show_univdiagonal",
                    action="store_true",
                    help="tag each alignment with its univdiagonal "
                         "(XU:i)")
    ap.add_argument("--show-refdiff", action="store_true",
                    help="accepted for compatibility (SNP-tolerant "
                         "output always shows reference differences)")
    ap.add_argument("--print-snps", action="store_true",
                    help="accepted for compatibility (marked 'not fully "
                         "implemented' in the reference)")
    ap.add_argument("--md-report-snps", action="store_true",
                    help="accepted for compatibility (MD is always "
                         "reference-based; XW/XV carry SNP-explained "
                         "counts)")
    ap.add_argument("--only-tr-consistent", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("-e", "--use-mask", default=None,
                    help="accepted for compatibility")
    ap.add_argument("--cmetdir", default=None,
                    help="accepted for compatibility; mode indexes live "
                         "inside the database directory")
    ap.add_argument("--atoidir", default=None,
                    help="accepted for compatibility; mode indexes live "
                         "inside the database directory")
    ap.add_argument("--transcriptdir", default=None,
                    help="directory holding the -c transcriptome "
                         "(default: <db>.transcripts in the database "
                         "directory)")
    ap.add_argument("-k", "--kmer", type=int, default=None,
                    help="db k-mer size (validated against the database)")
    ap.add_argument("--sampling", type=int, default=None,
                    help="accepted for compatibility")
    ap.add_argument("--expand-offsets", type=int, default=None,
                    help="accepted for compatibility")
    ap.add_argument("--noexceptions", action="store_true",
                    help="accepted for compatibility (failures always "
                         "produce a one-line error)")
    ap.add_argument("--use-shared-memory", type=int, default=None,
                    help="N/A: the index is HBM/host-RAM resident")
    ap.add_argument("--preload-shared-memory", action="store_true",
                    help="N/A: the index is HBM/host-RAM resident")
    ap.add_argument("--unload-shared-memory", action="store_true",
                    help="N/A: the index is HBM/host-RAM resident")
    ap.add_argument("--unload", default=None,
                    help="accepted for compatibility")
    ap.add_argument("--use-sarray", type=int, default=None,
                    help="obsolete in the reference; accepted and ignored")
    ap.add_argument("--terminal-threshold", type=int, default=None,
                    help="obsolete in the reference; accepted and ignored")
    ap.add_argument("--trim-mismatch-score", type=int, default=None,
                    help="accepted for compatibility: the reference "
                         "also ignores this option (src/gsnap.c:2544 is "
                         "commented out) and hard-codes -3 "
                         "(src/genomebits_trim.c:25), as does the trim "
                         "kernel here (ops/pathdp.trim_ends)")
    ap.add_argument("-M", "--suboptimal-levels", dest="suboptimal_levels",
                    type=int, default=0,
                    help="accepted for compatibility (marked 'not "
                         "currently implemented' in the reference too)")
    ap.add_argument("--indels-dump", dest="indels_dump", default=None,
                    help="write the learned indel table (.npz) after "
                         "--two-pass pass 1")
    ap.add_argument("--indels-read", dest="indels_read", default=None,
                    help="read a previously learned indel table (.npz); "
                         "reads overlapping known sites get DP "
                         "refinement at a lower mismatch trigger")
    ap.add_argument("--no-soft-clips", action="store_true",
                    help="disable end trimming; mismatches are counted "
                         "over the whole query (src/gsnap.c:697)")
    ap.add_argument("--extend-soft-clips", action="store_true",
                    help="print terminal soft clips as aligned (M) "
                         "bases, recomputing MD/NM (src/gsnap.c:698)")
    ap.add_argument("--tallydir", default=None,
                    help="disabled in the reference; accepted and ignored")
    ap.add_argument("--use-tally", default=None,
                    help="disabled in the reference; accepted and ignored")
    ap.add_argument("--runlengthdir", default=None,
                    help="disabled in the reference; accepted and ignored")
    ap.add_argument("--use-runlength", default=None,
                    help="disabled in the reference; accepted and ignored")
    ap.add_argument("--transcriptdb", dest="use_transcriptome_alias",
                    default=None,
                    help="alias for -c/--use-transcriptome")
    ap.add_argument("--transcriptome-mode", default=None,
                    help="accepted for compatibility")
    ap.add_argument("-m", "--max-mismatches", dest="max_mismatches",
                    type=float, default=0.10,
                    help="maximum mismatches as a fraction of read length "
                         "(gsnap -m)")
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--no-sam-headers", action="store_true")
    ap.add_argument("--read-group-id", dest="rg_id")
    ap.add_argument("--read-group-name", dest="rg_name")
    ap.add_argument("--read-group-library", dest="rg_library")
    ap.add_argument("--read-group-platform", dest="rg_platform")
    ap.add_argument("--orientation", default="FR",
                    choices=["FR", "RF", "FF"],
                    help="paired-end orientation (src/gsnap.c:591)")
    # runtime / output management (src/inbuffer.c, src/outbuffer.c)
    ap.add_argument("-q", "--part", help="process only fraction i/n of the "
                    "input (modular sharding, e.g. 0/4)")
    ap.add_argument("--interleaved", action="store_true",
                    help="single input file with read 1/read 2 "
                         "alternating (src/gsnap.c:612)")
    # input preprocessing (src/shortread.c options)
    ap.add_argument("--gunzip", action="store_true",
                    help="accepted for compatibility; compression is "
                         "auto-detected")
    ap.add_argument("--bunzip2", action="store_true",
                    help="accepted for compatibility; compression is "
                         "auto-detected")
    ap.add_argument("--read-files-command", dest="read_files_command",
                    help="read input via the stdout of `COMMAND file`")
    ap.add_argument("--barcode-length", dest="barcode_length", type=int,
                    default=0, help="strip this many bases from the start "
                                    "of every read")
    ap.add_argument("--endtrim-length", dest="endtrim_length", type=int,
                    default=0, help="strip this many bases from the end "
                                    "of every read")
    ap.add_argument("--fastq-id-start", dest="fastq_id_start", type=int,
                    default=1, help="first space-delimited header field "
                                    "of the read identifier (1-based)")
    ap.add_argument("--fastq-id-end", dest="fastq_id_end", type=int,
                    default=1, help="last header field of the identifier")
    ap.add_argument("-a", "--adapter-strip", dest="adapter_strip",
                    default="off", choices=["off", "paired"],
                    help="paired: detect read-through and trim adapters "
                         "(src/shortread.c chop_primers)")
    ap.add_argument("--clip-overlap", dest="clip_overlap",
                    action="store_true",
                    help="soft-clip the overlapping region of "
                         "overlapping paired-end alignments")
    ap.add_argument("--merge-overlap", dest="merge_overlap",
                    action="store_true",
                    help="merge overlapping paired-end alignments into "
                         "a single end (beta, all-M alignments only)")
    ap.add_argument("--filter-chastity", dest="filter_chastity",
                    default="off", choices=["off", "either", "both"],
                    help="skip reads failing the Illumina chastity flag")
    ap.add_argument("--force-single-end", dest="force_single_end",
                    action="store_true",
                    help="treat two input files as single-end, not paired")
    ap.add_argument("--allow-pe-name-mismatch",
                    dest="allow_pe_name_mismatch", action="store_true",
                    help="do not require paired accession names to match")
    ap.add_argument("--quality-protocol", dest="quality_protocol",
                    choices=["sanger", "illumina"],
                    help="illumina = -J 64 -j -31; sanger = -J 33 -j 0")
    ap.add_argument("-J", "--quality-zero-score", dest="quality_zero",
                    type=int, default=None,
                    help="ASCII value where FASTQ quality scores are zero")
    ap.add_argument("-j", "--quality-print-shift", dest="quality_shift",
                    type=int, default=None,
                    help="shift output FASTQ quality scores by this amount")
    ap.add_argument("-o", "--output", "--output-file", help="output file "
                    "(default stdout)")
    ap.add_argument("--append-output", action="store_true")
    # output filters (src/outbuffer.c / src/gsnap.c output options)
    ap.add_argument("--nofails", action="store_true",
                    help="exclude failed (unmapped) alignments from output")
    ap.add_argument("--failsonly", action="store_true",
                    help="print only failed alignments")
    ap.add_argument("-Q", "--quiet-if-excessive", dest="quiet_if_excessive",
                    action="store_true",
                    help="print nothing (nomapping line) when more than "
                         "--npaths paths are found")
    ap.add_argument("--only-concordant", dest="only_concordant",
                    action="store_true",
                    help="print only concordant paired alignments")
    ap.add_argument("--omit-concordant-uniq", dest="omit_concordant_uniq",
                    action="store_true")
    ap.add_argument("--omit-concordant-mult", dest="omit_concordant_mult",
                    action="store_true")
    ap.add_argument("--omit-softclipped", dest="omit_softclipped",
                    action="store_true",
                    help="drop alignments whose CIGAR contains soft clips")
    ap.add_argument("--order-among-best", dest="order_among_best",
                    default="genomic", choices=["genomic", "random"],
                    help="tie-break order among equally-scoring paths "
                         "(this implementation is deterministic: genomic)")
    ap.add_argument("-O", "--ordered", action="store_true",
                    help="print output in input order; with --part the "
                         "shard's records are written in their global "
                         "input order (Outbuffer_thread_ordered role, "
                         "src/outbuffer.c:1387); single-process output "
                         "is always ordered")
    ap.add_argument("-t", "--nthreads", type=int, default=None,
                    help="accepted for compatibility; parallelism comes "
                         "from device batching, not worker threads")
    ap.add_argument("-B", "--batch", default=None,
                    help="accepted for compatibility; the index is always "
                         "fully resident (HBM/host RAM)")
    ap.add_argument("--input-buffer-size", dest="batch_size_alias",
                    type=int, default=None,
                    help="alias for --batch-size (reads per device batch)")
    ap.add_argument("--output-buffer-size", type=int, default=None,
                    help="accepted for compatibility; output is streamed")
    ap.add_argument("--maxsearch", type=int, default=None,
                    help="cap on candidate paths searched per read")
    # SAM options (src/gsnap.c:686-717)
    ap.add_argument("--sam-extended-cigar", dest="sam_extended_cigar",
                    action="store_true",
                    help="use X/= CIGAR codes instead of M")
    ap.add_argument("--sam-multiple-primaries",
                    dest="sam_multiple_primaries", action="store_true",
                    help="equally good alignments all marked primary")
    ap.add_argument("--sam-sparse-secondaries",
                    dest="sam_sparse_secondaries", action="store_true",
                    help="secondary alignments use * for SEQ and QUAL")
    ap.add_argument("--sam-use-0M", dest="sam_use_0m", type=int, default=1,
                    help="1 (default): allow 0M CIGAR entries; 0: strip")
    ap.add_argument("--sam-hardclip-use-S", dest="sam_hardclip_use_s",
                    action="store_true",
                    help="accepted for compatibility; this implementation "
                         "never hard-clips")
    ap.add_argument("--sam-headers-batch", dest="sam_headers_batch",
                    type=int, default=None,
                    help="print SAM headers only for this --part batch")
    ap.add_argument("--force-xs-dir", dest="force_xs_dir",
                    action="store_true",
                    help="replace XS:A:? with XS:A:+")
    ap.add_argument("--action-if-cigar-error", dest="cigar_action",
                    default="warning",
                    choices=["ignore", "warning", "noprint", "abort"],
                    help="what to do when CIGAR and SEQ lengths disagree")
    ap.add_argument("--add-paired-nomappers", dest="add_paired_nomappers",
                    action="store_true",
                    help="accepted for compatibility; paired output "
                         "always emits both ends")
    ap.add_argument("--paired-flag-means-concordant",
                    dest="paired_flag_means_concordant", type=int,
                    default=0,
                    help="1: SAM 0x1 set only for concordant pairs")
    ap.add_argument("--split-output", dest="split_output",
                    help="basename for per-category output files")
    ap.add_argument("--failed-input", dest="failed_input",
                    help="write unaligned reads to this FASTA/FASTQ file")
    ap.add_argument("--find-fusions", action="store_true",
                    dest="find_fusions",
                    help="search for distant/translocation split reads "
                         "(emitted as primary + supplementary with SA tags)")
    ap.add_argument("--10x-well-position", dest="well_position",
                    type=int, default=4,
                    help="colon-separated accession field appended to "
                         "CB (0 disables; default 4)")
    ap.add_argument("--10x-whitelist", dest="whitelist",
                    help="10x cell-barcode whitelist; read 1 = barcode+UMI, "
                         "read 2 is aligned and tagged CR/CY/CB/UR/UY")
    ap.add_argument("--show-method", action="store_true",
                    dest="show_method",
                    help="tag each alignment with the method that solved "
                         "it (YM:Z:tr|sub|indel|splice|fusion)")
    ap.add_argument("--stats", action="store_true",
                    help="print the per-method solve-rate histogram to "
                         "stderr")
    ap.add_argument("--time", action="store_true", dest="timing",
                    help="print alignment timing to stderr")
    ap.add_argument("--version", action="version",
                    version="tpumap_torch-gsnap " + __version__
                            + " (capability reference: GSNAP 2024-02-22)")
    ap.add_argument("--check", action="store_true",
                    help="check runtime assumptions and exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index, the transcriptome "
                         "index and every call (default cuda: in a "
                         "torch.distributed group, card LOCAL_RANK or "
                         "the rank modulo the cards; cpu runs the plain "
                         "versions)")
    ap.add_argument("reads", nargs="?", help="FASTA/FASTQ file (read 1)")
    ap.add_argument("reads2", nargs="?", help="read-2 file for paired-end")
    args = ap.parse_args(argv)

    if args.check:
        return run_check()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tpumap_torch-gsnap: no CUDA device (pass "
                         "--device cpu to run the plain versions)")
    device = distributed.process_device(device)
    if args.use_transcriptome_alias and not args.use_transcriptome:
        args.use_transcriptome = args.use_transcriptome_alias
    if args.reads is None:
        ap.error("need an input FASTA/FASTQ file")
    if args.dir is None:
        ap.error("need -D/--dir (database directory)")
    if args.quality_protocol:
        if args.quality_zero is not None or args.quality_shift is not None:
            ap.error("cannot combine --quality-protocol with -J/-j")
        if args.quality_protocol == "illumina":
            args.quality_zero, args.quality_shift = 64, -31
        else:
            args.quality_zero, args.quality_shift = 33, 0
    read_opts = ReadOptions(
        barcode_length=args.barcode_length,
        endtrim_length=args.endtrim_length,
        fastq_id_start=args.fastq_id_start,
        fastq_id_end=args.fastq_id_end,
        filter_chastity=args.filter_chastity,
        quality_shift=args.quality_shift or 0,
        quality_zero=(args.quality_zero if args.quality_zero is not None
                      else 33))
    if read_opts.fastq_id_end < read_opts.fastq_id_start:
        ap.error("--fastq-id-end must be >= --fastq-id-start")
    if args.batch_size_alias:
        args.batch_size = args.batch_size_alias
    # splicing-dependent defaults (src/gsnap.c pairmax_dna/pairmax_rna)
    splicing_on = bool(args.novelsplicing or args.use_splicing
                       or args.two_pass or args.splices_read)
    if args.pairmax is None:
        args.pairmax = args.pairmax_rna if splicing_on else args.pairmax_dna
    if args.max_intron is None:
        args.max_intron = 200_000
    if args.find_dna_chimeras is not None:
        args.find_fusions = bool(args.find_dna_chimeras)
    if (args.splicingdir and args.use_splicing
            and "/" not in args.use_splicing):
        import os
        args.use_splicing = os.path.join(args.splicingdir,
                                         args.use_splicing)
    known_indels = None
    if args.indels_read:
        from tpumap_torch.gsnap.knownindels import KnownIndels
        known_indels = KnownIndels.load(args.indels_read)
    knob_kw = dict(max_insertions=args.max_insertions,
                   max_deletions=args.max_deletions,
                   indel_endlength=args.indel_endlength,
                   use_localdb=bool(args.use_localdb),
                   known_indels=known_indels)

    def nh_of(rec) -> int:
        return next((int(t[5:]) for t in rec.tags
                     if t.startswith("NH:i:")), 1)

    def maybe_excessive(rec):
        """-Q/--quiet-if-excessive: a read with more than --npaths paths
        found is reported as nomapping (src/gsnap.c output options);
        --chrsubset likewise voids alignments outside the subset."""
        if (args.chrsubset and not rec.flag & 4
                and rec.rname != args.chrsubset):
            return sam.unmapped_record(rec.qname, rec.seq, rec.qual)
        if args.quiet_if_excessive and nh_of(rec) > args.npaths:
            ex = sam.unmapped_record(rec.qname, rec.seq, rec.qual)
            ex.tags.append("XQ:i:0")
            return ex
        return rec

    def cat_ok(cat: str, rec) -> bool:
        if args.failsonly:
            return cat == "nomapping"
        if args.nofails and cat == "nomapping":
            return False
        if args.only_concordant and not cat.startswith("concordant"):
            return False
        if args.omit_concordant_uniq and cat == "concordant_uniq":
            return False
        if args.omit_concordant_mult and cat == "concordant_mult":
            return False
        if args.omit_softclipped and "S" in rec.cigar:
            return False
        if args.min_coverage > 0 and not rec.flag & 4 and rec.seq != "*":
            aligned = sum(n for n, op in sam._cigar_ops(rec.cigar)
                          if op in "MI=X")
            if aligned < args.min_coverage * len(rec.seq):
                return False
        return True

    def shape(rec):
        if args.extend_soft_clips:
            sam.extend_soft_clips(db, rec)
        if args.show_univdiagonal and not rec.flag & 4 \
                and rec.rname in db.chrom_names:
            ud = (int(db.chrom_offsets[db.chrom_names.index(rec.rname)])
                  + rec.pos - 1)
            rec.tags.append(f"XU:i:{ud}")
        return sam.apply_sam_options(
            rec, extended_cigar_p=args.sam_extended_cigar,
            use_0m=bool(args.sam_use_0m), force_xs_dir=args.force_xs_dir,
            sparse_secondaries=args.sam_sparse_secondaries,
            multiple_primaries=args.sam_multiple_primaries,
            cigar_action=args.cigar_action)

    db = GenomeDB.load(args.dir)
    if args.kmer is not None and args.kmer != db.k:
        raise ValueError(f"database was built with -k {db.k}, "
                         f"not {args.kmer}")
    index = DeviceIndex.from_host(db, device)
    if args.use_snps and (db.mode_indexes is None
                          or "snp" not in db.mode_indexes):
        sys.stderr.write("error: -v requires a SNP-tolerant database "
                         "(run tpumap-snpindex first)\n")
        return 2
    cfg_kw = {}
    if args.maxsearch is not None:
        cfg_kw["top_k"] = max(1, min(32, args.maxsearch))
    if args.min_coverage > 0:
        cfg_kw["min_coverage"] = args.min_coverage
    config = AlignConfig(mode=args.mode, snp_tolerant=args.use_snps,
                         max_mismatch_frac=args.max_mismatches,
                         query_unk_mismatch=bool(args.query_unk_mismatch),
                         genome_unk_mismatch=bool(args.genome_unk_mismatch),
                         soft_clips=not args.no_soft_clips,
                         **cfg_kw)

    tr = None
    if args.use_transcriptome:
        import os
        from tpumap_torch.gsnap.transcriptome import Transcriptome
        trdir = os.path.join(args.transcriptdir or
                             os.path.join(args.dir,
                                          f"{db.name}.transcripts"),
                             args.use_transcriptome)
        transcriptome = Transcriptome.load(trdir)
        tr = (transcriptome,
              DeviceIndex.from_host(transcriptome.trdb, device))

    known = None
    if args.splices_read:
        from tpumap_torch.gsnap.knownsplicing import KnownSplicing
        known = KnownSplicing.load(args.splices_read)
    if args.use_splicing:
        from tpumap_torch.gsnap.knownsplicing import KnownSplicing
        if args.use_splicing.endswith(".npz"):
            ks = KnownSplicing.load(args.use_splicing)
        else:
            from tpumap_torch.io.iit import IIT
            ks = KnownSplicing.from_splicing_iit(IIT.read(args.use_splicing), db)
        known = ks

    if args.output:
        out = open(args.output, "a" if args.append_output else "w")
    else:
        out = sys.stdout
    router = OutputRouter(args.split_output, out,
                          append=args.append_output)
    failed = open(args.failed_input, "w") if args.failed_input else None

    def write_failed(rec):
        if failed is None:
            return
        if rec.quality:
            failed.write(f"@{rec.accession}\n{rec.sequence}\n+\n"
                         f"{rec.quality}\n")
        else:
            failed.write(f">{rec.accession}\n{rec.sequence}\n")

    def headers_to(fh_set):
        if args.sam_headers_batch is not None and (
                part is None or part[0] != args.sam_headers_batch):
            return
        if args.format == "sam" and not args.no_sam_headers:
            h = sam.header(db, "tpumap-gsnap " + " ".join(argv),
                           rg=args.rg_id, rg_name=args.rg_name,
                           rg_library=args.rg_library,
                           rg_platform=args.rg_platform)
            for f in fh_set:
                f.write(h)

    def tag_rg(recs):
        if args.rg_id:
            for r in recs:
                r.tags.append(f"RG:Z:{args.rg_id}")
        return recs

    part = parse_part(args.part) if args.part else None
    if part is None:
        # multi-process data parallelism: in a torch.distributed group
        # each process takes its rank's shard of the input
        if distributed.nprocs() > 1:
            part = (distributed.rank(), distributed.nprocs())

    # gsnap --ordered in a multi-process run: record every output chunk
    # with its global input ordinal, gather them, process 0 writes the
    # merged stream (parallel/outmerge.py)
    merge = None
    out_real, router_real = out, router
    if args.ordered and part is not None and part[1] > 1:
        from tpumap_torch.parallel.outmerge import MergeRouter, OrderedMerge
        merge = OrderedMerge(part)
        out = merge.file(None)
        router = MergeRouter(merge)
    _mi = merge.iter if merge is not None else (lambda it: it)

    def finish_output():
        if merge is not None:
            merge.finalize(lambda cat, text:
                           (out_real if cat is None
                            else router_real.get(cat)).write(text))
        router_real.close()
        if failed is not None:
            failed.close()
        if args.output:
            out_real.close()

    def shard(it):
        for i, item in enumerate(it):
            if part is None or i % part[1] == part[0]:
                yield item

    t0 = time.perf_counter()
    nreads = 0

    if args.whitelist:
        # 10x single-cell mode (src/single-cell.c): read 1 carries the
        # barcodes, only read 2 is aligned
        from tpumap_torch.gsnap.single_cell import SingleCell
        if not args.reads2:
            sys.stderr.write("error: --10x-whitelist needs read-1 and "
                             "read-2 files\n")
            return 2
        sc = SingleCell.from_file(args.whitelist)
        # read 1 carries barcodes: preprocessing applies to read 2 only
        pairs = list(shard(zip(
            read_seqs(args.reads, args.read_files_command),
            preprocess_reads(read_seqs(args.reads2,
                                       args.read_files_command),
                             read_opts))))
        nreads = len(pairs)
        for r1, _r2 in pairs:
            sc.observe(r1.sequence)
        records = [r2 for _r1, r2 in pairs]
        results = align_records(db, index, records, config,
                                novelsplicing=bool(args.novelsplicing),
                                max_intron=args.max_intron,
                                batch_size=args.batch_size, known=known,
                                tr=tr, **knob_kw)
        headers_to({out})
        for (r1, r2), s in _mi(zip(pairs, results)):
            s.tags.extend(sc.sam_tags(r1.sequence, r1.quality,
                                      accession=r1.accession,
                                      wellpos=args.well_position))
            shape(s)
            out.write(s.line() + "\n")
            if s.flag & 4:
                write_failed(r2)
    elif (args.reads2 and not args.force_single_end) or args.interleaved:
        if args.interleaved:
            it = read_seqs(args.reads, args.read_files_command)
            raw_pairs = zip(it, it)
        else:
            raw_pairs = zip(read_seqs(args.reads, args.read_files_command),
                            read_seqs(args.reads2,
                                      args.read_files_command))
        pairs = list(shard(preprocess_pairs(raw_pairs, read_opts)))
        if args.adapter_strip == "paired":
            from tpumap_torch.io.fasta import strip_adapters_pair
            pairs = [strip_adapters_pair(r1, r2) for r1, r2 in pairs]
        if not args.allow_pe_name_mismatch:
            for r1, r2 in pairs:
                if not check_pair_names(r1, r2):
                    raise ValueError(
                        f"paired accessions {r1.accession!r} and "
                        f"{r2.accession!r} do not match (use "
                        f"--allow-pe-name-mismatch to override)")
        nreads = 2 * len(pairs)
        with stats_recording(args.stats) as rec:
            results = list(align_paired_records(
                db, index, pairs, config, pairmax=args.pairmax,
                batch_size=args.batch_size,
                novelsplicing=bool(args.novelsplicing),
                max_intron=args.max_intron, known=known,
                orientation=args.orientation, pairexpect=args.pairexpect,
                pairdev=args.pairdev, tr=tr,
                resolve_inner=args.resolve_inner != 0,
                **knob_kw))
        write_stats(rec)
        for s1, s2 in results:
            if args.paired_flag_means_concordant and not (s1.flag & 2):
                s1.flag &= ~1
                s2.flag &= ~1
        cats = ({OutputRouter.paired_category(s1, s2)
                 for s1, s2 in results
                 if cat_ok(OutputRouter.paired_category(s1, s2), s1)}
                if args.split_output else set())
        headers_to({router.get(c) for c in cats} or {out})
        if args.format in ("default", "standard", "gsnap"):
            from tpumap_torch.io.gsnapfmt import native_alignment
            for (r1, r2), (s1, s2) in _mi(zip(pairs, results)):
                for rr, ss in ((r1, s1), (r2, s2)):
                    hdr = ss.seq if ss.seq != "*" else rr.sequence
                    out.write(native_alignment(db, hdr, rr.accession, ss))
                if (s1.flag & 4) and (s2.flag & 4):
                    write_failed(r1)
                    write_failed(r2)
            finish_output()
            return 0
        for (r1, r2), (s1, s2) in _mi(zip(pairs, results)):
            if (s1.flag & 4) and (s2.flag & 4):
                write_failed(r1)
                write_failed(r2)
            if args.merge_overlap:
                merged = sam.merge_overlap_pair(db, s1, s2)
                if merged is not None:
                    mcat = OutputRouter.single_category(merged)
                    if cat_ok(mcat, merged):
                        tag_rg((merged,))
                        shape(merged)
                        router.get(mcat).write(merged.line() + "\n")
                    continue
            if args.clip_overlap:
                sam.clip_overlap_pair(db, s1, s2)
            cat = OutputRouter.paired_category(s1, s2)
            if not (cat_ok(cat, s1) and cat_ok(cat, s2)):
                continue
            tag_rg((s1, s2))
            shape(s1)
            shape(s2)
            f = router.get(cat)
            f.write(s1.line() + "\n")
            f.write(s2.line() + "\n")
    else:
        # native tokenizer fast path feeds the batch arrays directly; the
        # Record list is still materialized for SAM output (names/quals)
        import itertools
        inputs = read_seqs(args.reads, args.read_files_command)
        if args.reads2:   # --force-single-end: both files, single-end
            inputs = itertools.chain(
                inputs, read_seqs(args.reads2, args.read_files_command))
        records = list(shard(preprocess_reads(inputs, read_opts)))
        nreads = len(records)
        # plain single-end SAM runs STREAM: native blob emission straight
        # to the output file, no per-record Python objects (the default
        # `tpumap-gsnap -D db reads.fq > out.sam` path).  Any option that
        # reshapes/filters/tags records per-row keeps the record path.
        plain_stream = (
            args.format == "sam" and not args.two_pass
            and not args.split_output and not args.failed_input
            and not args.failsonly and not args.nofails
            and not args.only_concordant
            and not args.omit_concordant_uniq
            and not args.omit_concordant_mult
            and not args.omit_softclipped and args.min_coverage == 0
            and not args.quiet_if_excessive and not args.chrsubset
            and not args.extend_soft_clips and not args.show_univdiagonal
            and not args.sam_extended_cigar and not args.sam_use_0m
            and not args.force_xs_dir and not args.sam_sparse_secondaries
            and not args.sam_multiple_primaries
            and args.cigar_action in ("warning", "ignore")
            and not args.rg_id and merge is None
            and not args.show_method)
        if plain_stream:
            headers_to({out})
            out.flush()         # text-layer bytes precede buffer writes
            if hasattr(out, "buffer"):
                bsink = out.buffer.write
            else:
                bsink = lambda b: out.write(bytes(b).decode())  # noqa
            with stats_recording(args.stats) as rec:
                align_records_isolated(
                    db, index, records, config,
                    novelsplicing=bool(args.novelsplicing),
                    max_intron=args.max_intron,
                    batch_size=args.batch_size, known=known,
                    tr=tr, find_fusions=args.find_fusions,
                    npaths=args.npaths,
                    merge_distant_samechr=args.merge_distant_samechr,
                    sink=bsink, **knob_kw)
            write_stats(rec)
            if args.timing:
                dt = time.perf_counter() - t0
                sys.stderr.write(
                    f"Aligned {nreads} reads in {dt:.3f} s "
                    f"({nreads / max(dt, 1e-9):.1f} reads/sec)\n")
            finish_output()
            return 0
        if args.two_pass:
            from tpumap_torch.gsnap.twopass import two_pass_align
            results, _ks = two_pass_align(db, index, records, config,
                                          max_intron=args.max_intron,
                                          batch_size=args.batch_size,
                                          splices_dump=args.splices_dump,
                                          indels_dump=args.indels_dump,
                                          min_support=args.pass1_min_support,
                                          tr=tr)
        else:
            with stats_recording(args.stats) as rec:
                results = align_records_isolated(
                    db, index, records, config,
                    novelsplicing=bool(args.novelsplicing),
                    max_intron=args.max_intron,
                    batch_size=args.batch_size, known=known,
                    tr=tr, find_fusions=args.find_fusions,
                    npaths=args.npaths,
                    show_method=args.show_method,
                    merge_distant_samechr=args.merge_distant_samechr,
                    **knob_kw)
            write_stats(rec)
        if args.format in ("default", "standard", "gsnap"):
            from tpumap_torch.io.gsnapfmt import native_alignment
            for rec, s in _mi(zip(records, results)):
                s = maybe_excessive(s)
                hdr_seq = s.seq if s.seq != "*" else rec.sequence
                out.write(native_alignment(db, hdr_seq, rec.accession, s))
                if s.flag & 4:
                    write_failed(rec)
        elif args.format == "m8":
            from tpumap_torch.io.m8 import m8_line
            for rec, s in _mi(zip(records, results)):
                if s.flag & 4:
                    write_failed(rec)
                    continue
                nm = next((int(t.split(":")[2]) for t in s.tags
                           if t.startswith("NM:i:")), 0)
                diag = (int(db.chrom_offsets[db.chrom_names.index(s.rname)])
                        + s.pos - 1)
                out.write(m8_line(db, rec.accession, diag,
                                  1 if s.flag & 16 else 0,
                                  len(rec.sequence), nm) + "\n")
        else:
            shaped = []
            for rec, s in zip(records, results):
                s = maybe_excessive(s)
                shaped.append((rec, s, OutputRouter.single_category(s)))
            cats = ({c for _r, s, c in shaped if cat_ok(c, s)}
                    if args.split_output else set())
            headers_to({router.get(c) for c in cats} or {out})
            for rec, s, cat in _mi(shaped):
                if s.flag & 4:
                    write_failed(rec)
                if not cat_ok(cat, s):
                    continue
                tag_rg([s] + list(s.secondaries or ()))
                shape(s)
                router.get(cat).write(s.lines())

    if args.timing:
        dt = time.perf_counter() - t0
        sys.stderr.write(f"Aligned {nreads} reads in {dt:.3f} s "
                         f"({nreads / max(dt, 1e-9):.1f} reads/sec)\n")
    finish_output()
    return 0


if __name__ == "__main__":
    sys.exit(main())
