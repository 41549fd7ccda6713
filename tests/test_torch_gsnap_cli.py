"""GSNAP as users run it: the port's gsnap CLI against tpumap's, JAX on
the CPU and the port's plain versions (--device cpu).

Function level, value for value and string for string, on the worlds of
test_input_options, test_overlap_options, test_gsnap_native_format and
test_single_cell:
- io/fasta.py's read preprocessing (ReadOptions, chastity_fail,
  apply_read_options, preprocess_reads, preprocess_pairs,
  check_pair_names, strip_adapters_pair);
- io/sam.py's record surgery (extend_soft_clips, ref_consumed,
  recompute_md, clip_record_left, clip_overlap_pair, merge_overlap_pair);
- driver.align_records_isolated's quarantine, with and without a sink;
- io/gsnapfmt.py (-A default), io/m8.py (-A m8), gsnap/single_cell.py
  and parallel/outmerge.py (one process, and a simulated group of two).

main, byte for byte but for the echoed command line (the port's ends in
--device cpu): one parametrised test over argument lists on
torch_workloads.gsnap_cli_world, with the return code, the files a case
writes (.npz by value) and, where named, stderr compared too.
"""
import dataclasses
import functools
import io
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from tpumap.cli import gsnap_cli as jcli
from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import single_cell as jsingle_cell
from tpumap.index import build_db as jbuild_db
from tpumap.io import fasta as jfasta
from tpumap.io import gsnapfmt as jgsnapfmt
from tpumap.io import m8 as jm8
from tpumap.io import sam as jsam
from tpumap.parallel import outmerge as joutmerge
from tpumap_torch.cli import gsnap_cli
from tpumap_torch.gsnap import driver, single_cell
from tpumap_torch.index.build import build_db
from tpumap_torch.io import fasta, gsnapfmt, m8, sam
from tpumap_torch.parallel import outmerge
from tpumap_torch.utils import dna
from torch_workloads import mend_tlen
from torch_workloads import gsnap_cli_world

torch.set_num_threads(2)


def rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def both(*records):
    """(tpumap's Record copies, the port's) of (accession, description,
    sequence, quality) tuples."""
    return ([jfasta.Record(*r) for r in records],
            [fasta.Record(*r) for r in records])


def astuples(recs):
    return [dataclasses.astuple(r) for r in recs]


# ------------------------------------------------ read preprocessing

READS = [("SRR001666.1", "071112_SLXA s7:5:1:817:345 length=36",
          "NNNNACGTACGTTTGA", "####IIIIIIIIJJhh"),
         ("a/1", "1:Y:0:CTTGTA", "ACGTACGTAC", "hhhhhhhhhh"),
         ("b/1", "1:N:0:CTTGTA", "ACGTAC", None),
         ("c", "comment", "ACGT", "IIII"),
         ("d", "", "", "")]


@pytest.mark.parametrize("opts", [
    dict(), dict(barcode_length=4, endtrim_length=2),
    dict(fastq_id_start=2, fastq_id_end=2),
    dict(fastq_id_start=1, fastq_id_end=3),
    dict(quality_shift=-31, quality_zero=64), dict(endtrim_length=30),
    dict(filter_chastity="either"), dict(filter_chastity="both",
                                         barcode_length=1)],
    ids=["none", "trim", "id2", "id13", "illumina", "endtrim_all",
         "chastity", "chastity_both"])
def test_read_preprocessing_matches(opts):
    """test_input_options' reads through both packages' preprocessing."""
    jr, tr = both(*READS)
    want = astuples(jfasta.preprocess_reads(iter(jr),
                                            jfasta.ReadOptions(**opts)))
    assert astuples(fasta.preprocess_reads(
        iter(tr), fasta.ReadOptions(**opts))) == want
    assert fasta.ReadOptions(**opts).active == \
        jfasta.ReadOptions(**opts).active
    jr, tr = both(*READS)
    assert [fasta.chastity_fail(r) for r in tr] == \
        [jfasta.chastity_fail(r) for r in jr]
    pairs = [(READS[i], READS[j]) for i, j in
             ((1, 2), (1, 1), (2, 3), (3, 2), (0, 4))]
    jp = [(jfasta.Record(*a), jfasta.Record(*b)) for a, b in pairs]
    tp = [(fasta.Record(*a), fasta.Record(*b)) for a, b in pairs]
    want = [(dataclasses.astuple(a), dataclasses.astuple(b)) for a, b in
            jfasta.preprocess_pairs(iter(jp), jfasta.ReadOptions(**opts))]
    assert [(dataclasses.astuple(a), dataclasses.astuple(b)) for a, b in
            fasta.preprocess_pairs(iter(tp),
                                   fasta.ReadOptions(**opts))] == want


def test_pair_names_and_adapters_match():
    """check_pair_names on test_input_options' names; strip_adapters_pair
    on test_overlap_options' read-through and plain pairs, and a pair too
    short to test."""
    for a, b in (("x/1", "x/2"), ("x", "x"), ("x", "y"), ("x.1", "x.2"),
                 ("x/1", "y/2"), ("x/3", "x/4")):
        assert fasta.check_pair_names(fasta.Record(a, "", "A"),
                                      fasta.Record(b, "", "A")) == \
            jfasta.check_pair_names(jfasta.Record(a, "", "A"),
                                    jfasta.Record(b, "", "A"))
    adapter = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    rng = np.random.default_rng(3)
    frag = rand_seq(rng, 60)
    long_frag = rand_seq(np.random.default_rng(5), 300)
    cases = [((frag + adapter[:40], "I" * 93),
              (dna.revcomp(frag) + adapter[:40], "J" * 93)),
             ((long_frag[:100], None), (dna.revcomp(long_frag)[:100], None)),
             ((frag[:40] + adapter[:20], None),
              (dna.revcomp(frag[:40]) + adapter[:25], "K" * 65)),
             (("ACGTACGT", None), ("ACGT", None))]
    for (s1, q1), (s2, q2) in cases:
        want = jfasta.strip_adapters_pair(jfasta.Record("a", "", s1, q1),
                                          jfasta.Record("a", "", s2, q2))
        got = fasta.strip_adapters_pair(fasta.Record("a", "", s1, q1),
                                        fasta.Record("a", "", s2, q2))
        assert astuples(got) == astuples(want)


# ------------------------------------------------------ record surgery

@pytest.fixture(scope="module")
def ovl_dbs(tmp_path_factory):
    """test_overlap_options' 9 kbp genome, built by both packages."""
    d = tmp_path_factory.mktemp("ovl")
    rng = np.random.default_rng(31)
    seq = rand_seq(rng, 9000)
    (d / "g.fa").write_text(">chr1\n" + seq + "\n")
    kw = dict(name="g", k=12, interval=3)
    return jbuild_db(d / "g.fa", **kw), build_db(d / "g.fa", **kw), seq


def rec_pair(seq, qname, flag, pos, cigar, qual="*", tags=()):
    kw = dict(qname=qname, flag=flag, rname="chr1", pos=pos, mapq=40,
              cigar=cigar, seq=seq, qual=qual, tags=list(tags))
    return jsam.SamRecord(**kw), sam.SamRecord(**kw)


def test_record_surgery_matches(ovl_dbs):
    """extend_soft_clips (both ends, a clip past the chromosome start),
    ref_consumed, recompute_md, clip_record_left (through an intron and
    a deletion, and one that leaves nothing), clip_overlap_pair and
    merge_overlap_pair (overlapping, disjoint, spliced) on the overlap
    world."""
    jdb, tdb, seq = ovl_dbs
    mut = seq[1990:2000].lower().upper()[::-1] + seq[2000:2080]
    cases = [("8S82M", 2001, mut), ("80M10S", 3001, seq[3000:3090]),
             ("5S80M", 3, seq[0:85]), ("4S20M100N30M3S", 4001,
                                       "ACGT" + seq[4000:4020]
                                       + seq[4120:4150] + "TTT")]
    for cigar, pos, s in cases:
        j, t = rec_pair(s, "q", 0, pos, cigar, tags=["NM:i:0", "XS:A:+"])
        jsam.extend_soft_clips(jdb, j)
        sam.extend_soft_clips(tdb, t)
        assert t.line() == j.line()
    for cigar in ("50M", "20M100N30M", "10S40M2D8M", "5M2I5M"):
        assert sam.ref_consumed(cigar) == jsam.ref_consumed(cigar)
    for cigar, clip in (("50M", 10), ("20M100N30M", 25), ("10S20M3D20M", 22),
                        ("3S10M2I10M", 12), ("20M", 20), ("5M5D5M", 5)):
        j, t = rec_pair("A" * 60, "q", 0, 100, cigar)
        jr, tr = jsam.clip_record_left(j, clip), sam.clip_record_left(t,
                                                                       clip)
        assert (tr is None) == (jr is None)
        assert t.line() == j.line()
    j, t = rec_pair(seq[500:560], "q", 0, 501, "30M1D29M")
    jsam.recompute_md(jdb, j)
    sam.recompute_md(tdb, t)
    assert t.line() == j.line()
    pairs = [((2000, 2080), (2040, 2120), "80M", "80M"),
             ((3000, 3080), (3050, 3130), "80M", "80M"),
             ((5000, 5080), (6000, 6080), "80M", "80M"),
             ((7000, 7080), (6990, 7070), "80M", "80M"),
             ((4000, 4080), (4060, 4140), "40M20N40M", "80M")]
    for (a0, a1), (b0, b1), c1, c2 in pairs:
        for op in ("clip", "merge"):
            j1, t1 = rec_pair(seq[a0:a1], "p", 99, a0 + 1, c1, "I" * 80)
            j2, t2 = rec_pair(seq[b0:b1], "p", 147, b0 + 1, c2, "J" * 80)
            if op == "clip":
                jsam.clip_overlap_pair(jdb, j1, j2)
                sam.clip_overlap_pair(tdb, t1, t2)
                assert (t1.line(), t2.line()) == (j1.line(), j2.line())
            else:
                jm = jsam.merge_overlap_pair(jdb, j1, j2)
                tm = sam.merge_overlap_pair(tdb, t1, t2)
                assert (tm is None) == (jm is None)
                if jm is not None:
                    assert tm.line() == jm.line()


def test_align_records_isolated_matches(monkeypatch):
    """test_runtime's poison batch: the group fails, the retry runs read
    by read and the poison read comes back unmapped, with the same
    records, streamed bytes and stderr lines in both packages."""
    reads = [(f"r{i}", "", "ACGT" * 20, None) for i in range(10)]

    def poisoned(mod):
        def run(db_, index_, records, *a, sink=None, **kw):
            if len(records) > 1 and any(r.accession == "r6"
                                        for r in records):
                raise RuntimeError("poison read in batch")
            if records[0].accession == "r6":
                raise ValueError("poison read")
            recs = [mod.SamRecord(r.accession, 0, "chr1", 7, 40, "80M",
                                  seq=r.sequence) for r in records]
            if sink is None:
                return recs
            sink("".join(x.lines() for x in recs).encode())
            return []
        return run

    monkeypatch.setattr(jdriver, "align_records", poisoned(jsam))
    monkeypatch.setattr(driver, "align_records", poisoned(sam))
    for streaming in (False, True):
        got = []
        for mod, fa in ((jdriver, jfasta), (driver, fasta)):
            err, chunks = io.StringIO(), []
            with redirect_stderr(err):
                out = mod.align_records_isolated(
                    None, None, [fa.Record(*r) for r in reads],
                    batch_size=4, sink=chunks.append if streaming else None)
            got.append(("".join(r.lines() for r in out), b"".join(chunks),
                        err.getvalue()))
        assert got[1] == got[0]
        assert "r6" in got[0][2] and ("\t4\t" in got[0][0] or streaming)


# ------------------------------------------------ formats, 10x, merge

@pytest.fixture(scope="module")
def native_dbs(tmp_path_factory):
    """test_gsnap_native_format's 9 kbp genome, built by both packages."""
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(53)
    genome = rand_seq(rng, 9000)
    (d / "g.fa").write_text(">chr1\n" + genome + "\n")
    kw = dict(name="g", k=12, interval=3)
    return jbuild_db(d / "g.fa", **kw), build_db(d / "g.fa", **kw), genome


def test_native_format_and_m8_match(native_dbs):
    """native_alignment on test_gsnap_native_format's cases (plain, a
    mismatch, minus strand, a 3-base deletion, no hit) and on a splice
    (sense and antisense), an insertion and soft clips; m8_line on both
    strands and a trimmed span."""
    jdb, tdb, g = native_dbs
    s = list(g[1000:1100])
    s[30] = {"A": "C", "C": "A", "G": "T", "T": "G"}[s[30]]
    mm = "".join(s)
    cases = [(g[2000:2100], 0, 2001, "100M", []),
             (mm, 0, 1001, "100M", ["NM:i:1"]),
             (g[1000:1100], 16, 1001, "100M", ["NH:i:2"]),
             (g[1000:1050] + g[1053:1103], 0, 1001, "50M3D50M", []),
             ("AC" * 50, 4, 0, "*", []),
             (g[3000:3040] + g[3240:3300], 0, 3001, "40M200N60M",
              ["XS:A:+"]),
             (g[3000:3040] + g[3240:3300], 16, 3001, "40M200N60M",
              ["XS:A:-"]),
             (g[4000:4050] + "TT" + g[4050:4098], 0, 4001, "50M2I48M", []),
             ("GG" + g[5002:5095] + "CCCCC", 16, 5003, "2S93M5S", [])]
    for seq, flag, pos, cigar, tags in cases:
        kw = dict(qname="q", flag=flag, rname="chr1" if pos else "*",
                  pos=pos, mapq=40, cigar=cigar, seq=seq, tags=tags)
        want = jgsnapfmt.native_alignment(jdb, seq, "acc",
                                          jsam.SamRecord(**kw))
        assert gsnapfmt.native_alignment(tdb, seq, "acc",
                                         sam.SamRecord(**kw)) == want
    for diag, strand, qlen, nm, qs, qe in ((1000, 0, 100, 0, 0, None),
                                           (2000, 1, 100, 3, 0, None),
                                           (100, 0, 80, 1, 5, 70),
                                           (8800, 1, 100, 2, 10, 95)):
        assert m8.m8_line(tdb, "q", diag, strand, qlen, nm, qs, qe) == \
            jm8.m8_line(jdb, "q", diag, strand, qlen, nm, qs, qe)


def test_single_cell_matches(tmp_path):
    """test_single_cell's whitelist: a confirmed barcode, the correction
    posterior after dataset priors, an unconfirmable barcode, the well
    position field, and a whitelist read from a file."""
    wl = ["AAAACCCCGGGGTTTT", "ACGTACGTACGTACGT", "TTTTGGGGCCCCAAAA"]
    (tmp_path / "wl.txt").write_text("".join(b + "-1\n" for b in wl))
    scs = [(jsingle_cell.SingleCell(wl), single_cell.SingleCell(wl)),
           (jsingle_cell.SingleCell.from_file(str(tmp_path / "wl.txt")),
            single_cell.SingleCell.from_file(str(tmp_path / "wl.txt")))]
    for jsc, tsc in scs:
        for bc, n in ((wl[0], 100), (wl[1], 2)):
            for _ in range(n):
                jsc.observe(bc + "X" * 12)
                tsc.observe(bc + "X" * 12)
        for read, qual, acc, wp in (
                (wl[0] + "AACCGGTTAACC", "I" * 28, "a:1:2:3:9", 4),
                ("TAAACCCCGGGGTTTT" + "A" * 12, "#" + "I" * 27, "b", 4),
                ("CCAACCCCGGGGTTTT" + "A" * 12, "I" * 28, "c:1", 0),
                (wl[2] + "GATTACAGATTA", None, None, 4)):
            assert tsc.sam_tags(read, qual, accession=acc, wellpos=wp) == \
                jsc.sam_tags(read, qual, accession=acc, wellpos=wp)


def test_ordered_merge_matches(monkeypatch):
    """OrderedMerge and MergeRouter in one process write the chunks in
    global input order, headers first, as tpumap's; in a group of two
    (simulated: every gather returns this process's array twice) rank 0
    writes tpumap's merged stream and rank 1 nothing."""
    def run(part):
        got = []
        for mod in (joutmerge, outmerge):
            merge = mod.OrderedMerge(part)
            router = mod.MergeRouter(merge)
            merge.file(None).write("@HD\n")
            router.get("unpaired_uniq").write("@HD split\n")
            for i in mod.OrderedMerge.iter(merge, [5, 1, 3]):
                router.get("nomapping" if i == 1
                           else "unpaired_uniq").write(f"r{i}\n")
                merge.file(None).write(f"d{i}\n")
            router.close()
            out = []
            ret = merge.finalize(lambda cat, text: out.append((cat, text)))
            got.append((ret, out))
        return got

    got = run((1, 3))
    assert got[1] == got[0] and got[0][0]
    import jax
    from jax.experimental import multihost_utils as mh
    from tpumap.parallel import distributed as jdist
    monkeypatch.setattr(jdist, "_nprocs", lambda: 2)
    monkeypatch.setattr(joutmerge, "_nprocs", lambda: 2)
    monkeypatch.setattr(mh, "process_allgather",
                        lambda x: np.stack([np.asarray(x)] * 2))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)

    def all_gather(out, x):
        for o in out:
            o.copy_(x)
    monkeypatch.setattr(torch.distributed, "all_gather", all_gather)
    for r in (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda: r)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda: r)
        got = run((r, 2))
        assert got[1] == got[0]
        assert got[0][0] == (r == 0) and bool(got[0][1]) == (r == 0)


# ------------------------------------------------------------- main

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return gsnap_cli_world(tmp_path_factory.mktemp("gsnapcli"))


def run_main(main, argv):
    """(return code, stdout, stderr) of one main run; an argparse exit
    gives its code."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc = ("exit", exc.code)
    return rc, out.getvalue(), err.getvalue()


def read_files(d):
    files = {}
    for p in sorted(d.iterdir()):
        if p.suffix == ".npz":
            with np.load(p) as z:
                files[p.name] = {k: z[k] for k in z.files}
        else:
            files[p.name] = p.read_bytes()
    return files


def assert_main_parity(world, argv, tmp_path, stderr=False, pairmax=None):
    """tpumap's main and the port's (--device cpu) on argv with the
    world's paths: the same return code and stdout but for the echoed
    command line, the same files under each package's {OUT} directory,
    and with stderr=True the same stderr (a function: stderr(tpumap's,
    the port's) checks the two). With pairmax, tpumap's stdout is first
    given the port's TLEN of pairs with a gapped or spliced mate
    (mend_tlen), which must change at least one pair."""
    def args_for(pkg):
        (tmp_path / pkg).mkdir()
        keys = dict(world, OUT=str(tmp_path / pkg))
        return [a.format(**keys) for a in argv]
    jargv, targv = args_for("j"), args_for("t") + ["--device", "cpu"]
    jecho, techo = " ".join(jargv), " ".join(targv)
    jrc, want, jerr = run_main(jcli.main, jargv)
    trc, got, terr = run_main(gsnap_cli.main, targv)
    assert trc == jrc, terr
    if pairmax is not None:
        mended, changed = mend_tlen(want.encode(), pairmax)
        assert changed >= 1
        want = mended.decode()
    assert got.replace(techo, jecho) == want
    if callable(stderr):
        stderr(jerr, terr)
    elif stderr:
        assert terr == jerr
    jfiles, tfiles = read_files(tmp_path / "j"), read_files(tmp_path / "t")
    assert sorted(tfiles) == sorted(jfiles)
    for name, w in jfiles.items():
        g = tfiles[name]
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), name
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(
                    g[k], w[k]), (name, k)
        else:
            assert g.replace(techo.encode(), jecho.encode()) == w, name
    return jrc, want, jerr


D, SE, PE = ["-D", "{D}"], ["{R}"], ["{R1}", "{R2}"]
CASES = {
    # the bare command and the stream it does not take by default
    "default": D + SE,
    "sam_use_0m_0": D + ["--sam-use-0M", "0"] + SE,
    "n1": D + ["-n", "1"] + SE,
    "n3_stream": D + ["-n", "3", "--sam-use-0M", "0"] + SE,
    "time": D + ["--time"] + SE,
    "output_file": D + ["-o", "{OUT}/out.sam"] + SE,
    "append_output": D + ["-o", "{OUT}/out.sam", "--append-output"] + SE,
    "gzip": D + ["{RGZ}"],
    "read_files_command": D + ["--read-files-command", "cat"] + SE,
    # paired end
    "paired": D + PE,
    "interleaved": D + ["--interleaved", "{RI}"],
    "force_single_end": D + ["--force-single-end"] + PE,
    "paired_opts": D + ["--pairmax", "500", "--pairexpect", "300",
                        "--pairdev", "50", "--resolve-inner", "0"] + PE,
    "orientation_rf": D + ["--orientation", "RF"] + PE,
    "paired_n1": D + ["-n", "1", "--sam-use-0M", "0"] + PE,
    # splicing, the staged path, modes
    "novel": D + ["-N", "1"] + SE,
    "known_iit": D + ["-s", "{SS}"] + SE,
    "known_npz": D + ["-s", "{SSNPZ}"] + SE,
    "splicingdir": D + ["--splicingdir", "{ROOT}", "-s", "ss.iit"] + SE,
    "splices_read": D + ["--splices-read", "{SSNPZ}"] + SE,
    "paired_novel_known": D + ["-N", "1", "-s", "{SS}"] + PE,
    "two_pass": D + ["--two-pass", "--pass1-min-support", "1",
                     "--splices-dump", "{OUT}/sp.npz",
                     "--indels-dump", "{OUT}/in.npz"] + SE,
    "indels_read": D + ["--indels-read", "{INDELS}"] + SE,
    "transcriptome": D + ["-c", "tr"] + SE,
    "transcriptome_paired": D + ["--transcriptdb", "tr",
                                 "--transcriptdir", "{D}/g.transcripts"] + PE,
    "snp": ["-D", "{SNPD}", "-v"] + SE,
    "snp_missing": D + ["-v"] + SE,
    "cmet": ["-D", "{CMETD}", "--mode", "cmet-stranded"] + SE,
    "fusions": D + ["--find-fusions"] + SE,
    "fusions_merge": D + ["--find-dna-chimeras", "1",
                          "--merge-distant-samechr", "-N", "1"] + SE,
    "knobs": D + ["-m", "0.05", "-Y", "2", "-Z", "3", "--indel-endlength",
                  "6", "--query-unk-mismatch", "1", "--genome-unk-mismatch",
                  "0", "--maxsearch", "8", "--use-localdb", "0", "-w",
                  "5000", "-N", "1"] + SE,
    "no_soft_clips": D + ["--no-soft-clips"] + SE,
    # formats
    "native": D + ["-A", "default"] + SE,
    "native_paired": D + ["-A", "standard", "--failed-input",
                          "{OUT}/f.fq"] + PE,
    "m8": D + ["-A", "m8", "--failed-input", "{OUT}/f.fq"] + SE,
    # sharding and files
    "part": D + ["--part", "1/3"] + SE,
    "part_ordered": D + ["-q", "0/2", "-O"] + SE,
    "part_ordered_split": D + ["--part", "1/2", "-O", "--split-output",
                               "{OUT}/s"] + PE,
    "sam_headers_batch": D + ["--part", "0/2", "--sam-headers-batch",
                              "1"] + SE,
    "split_output": D + ["--split-output", "{OUT}/s"] + SE,
    "split_paired": D + ["--split-output", "{OUT}/s"] + PE,
    "failed_input": D + ["--failed-input", "{OUT}/f.fq"] + SE,
    "failed_input_paired": D + ["--failed-input", "{OUT}/f.fq"] + PE,
    # output filters
    "nofails": D + ["--nofails"] + SE,
    "failsonly": D + ["--failsonly"] + SE,
    "quiet_if_excessive": D + ["-Q", "-n", "1"] + SE,
    "omit_softclipped": D + ["--omit-softclipped"] + SE,
    "min_coverage": D + ["--min-coverage", "0.95"] + SE,
    "chrsubset": D + ["--chrsubset", "chr2"] + SE,
    "only_concordant": D + ["--only-concordant"] + PE,
    "omit_concordant": D + ["--omit-concordant-uniq",
                            "--omit-concordant-mult"] + PE,
    "paired_flag_means_concordant": D + [
        "--paired-flag-means-concordant", "1"] + PE,
    # SAM options
    "extended_cigar": D + ["--sam-extended-cigar", "--force-xs-dir",
                           "-N", "1"] + SE,
    "secondaries": D + ["--sam-sparse-secondaries",
                        "--sam-multiple-primaries"] + SE,
    "cigar_action": D + ["--action-if-cigar-error", "noprint"] + SE,
    "show_univdiagonal": D + ["--show-univdiagonal", "-k", "12"] + SE,
    "extend_soft_clips": D + ["--extend-soft-clips"] + SE,
    "no_sam_headers": D + ["--no-sam-headers"] + PE,
    "compat": D + ["-t", "4", "-B", "5", "--use-sarray", "0",
                   "--sampling", "3", "--input-buffer-size", "1024",
                   "--split-simple", "--print-snps", "-M", "2"] + SE,
    # overlaps and read preprocessing
    "clip_overlap": D + ["--clip-overlap"] + PE,
    "merge_overlap": D + ["--merge-overlap"] + PE,
    "adapter_strip": D + ["-a", "paired"] + PE,
    "barcode_endtrim": D + ["--barcode-length", "6", "--endtrim-length",
                            "4"] + SE,
    "fastq_id": D + ["--fastq-id-start", "1", "--fastq-id-end", "2"] + SE,
    "chastity_either": D + ["--filter-chastity", "either"] + PE,
    "chastity_both": D + ["--filter-chastity", "both"] + PE,
    "chastity_single": D + ["--filter-chastity", "both"] + SE,
    "quality_protocol": D + ["--quality-protocol", "illumina"] + SE,
    "quality_shift": D + ["-J", "33", "-j", "2"] + PE,
    "pe_name_mismatch": D + ["{R1}", "{R2BAD}"],
    "allow_pe_name_mismatch": D + ["--allow-pe-name-mismatch", "{R1}",
                                   "{R2BAD}"],
    # 10x, methods, read groups
    "tenx": D + ["--10x-whitelist", "{WL}", "{SC1}", "{SC2}"],
    "tenx_wellpos": D + ["--10x-whitelist", "{WL}",
                         "--10x-well-position", "0", "{SC1}", "{SC2}"],
    "tenx_single": D + ["--10x-whitelist", "{WL}", "{SC1}"],
    "show_method": D + ["--show-method", "-N", "1", "--find-fusions"] + SE,
    "stats": D + ["--stats"] + SE,
    "stats_stream": D + ["--stats", "--sam-use-0M", "0"] + SE,
    "read_groups": D + ["--read-group-id", "g1", "--read-group-name", "s1",
                        "--read-group-library", "lib",
                        "--read-group-platform", "ILLUMINA"] + SE,
    "read_groups_paired": D + ["--read-group-id", "g2"] + PE,
    # rejected by both parsers
    "kmer_mismatch": D + ["-k", "14"] + SE,
    "bad_part": D + ["--part", "3/2"] + SE,
    "no_reads": D,
    "no_db": SE,
    "quality_conflict": D + ["--quality-protocol", "sanger", "-J",
                             "64"] + SE,
    "fastq_id_order": D + ["--fastq-id-start", "2", "--fastq-id-end",
                           "1"] + SE,
    "bad_mode": D + ["--mode", "cmet"] + SE,
    "missing_reads": D + ["{ROOT}/none.fq"],
}
STDERR = {"show_method", "tenx", "tenx_single", "snp_missing",
          "pe_name_mismatch", "kmer_mismatch", "bad_part", "missing_reads"}
STATS = {"stats", "stats_stream"}
# the paired cases whose output holds a proper pair with a gapped or
# spliced mate, and their pairmax (gsnap's --pairmax-rna default with -N)
GAPPED_PAIRS = {"paired_novel_known": 200000}


def stats_lines(err: str):
    """--stats' stderr: ({method: (reads, share)}, {counter: value},
    {span: calls})."""
    methods, counters, spans = {}, {}, {}
    for ln in err.splitlines():
        kind, _, rest = ln.partition(" ")
        name, _, val = rest.partition(": ")
        if kind == "method":
            c, pct = val.split(" (")
            methods[name] = (int(c), float(pct.rstrip("%)")))
        elif kind == "counter":
            counters[name] = int(val)
        elif kind == "span":
            spans[name] = int(val.split(" calls")[0])
    return methods, counters, spans


def assert_stats_match(jerr: str, terr: str) -> None:
    """The port's --stats against tpumap's: the same reads a method;
    tpumap prints its overflow counter as a method line, the port as a
    counter beside the others, and shares over the methods alone."""
    jm, _, _ = stats_lines(jerr)
    tm, tc, ts = stats_lines(terr)
    assert jm.pop("stage2_overflow")[0] == tc["stage2_overflow"]
    assert {k: c for k, (c, _p) in tm.items()} == \
        {k: c for k, (c, _p) in jm.items()}
    assert sum(p for _c, p in tm.values()) == pytest.approx(
        100.0, abs=0.05 * len(tm))
    assert tc["reads"] == sum(c for c, _p in tm.values())
    assert ts["enqueue"] == tc["batches"]


@pytest.mark.parametrize("case", list(CASES))
def test_main_parity(world, tmp_path, case):
    keys = dict(world, ROOT=str(__import__("pathlib").Path(world["R"])
                                .parent))
    rc, out, _err = assert_main_parity(
        keys, CASES[case], tmp_path,
        stderr=assert_stats_match if case in STATS else case in STDERR,
        pairmax=GAPPED_PAIRS.get(case))
    if rc == 0 and case not in ("failsonly", "chrsubset", "only_concordant",
                                "omit_concordant", "no_sam_headers",
                                "part_ordered_split", "output_file",
                                "append_output", "split_output",
                                "split_paired"):
        body = [ln for ln in out.splitlines() if ln and ln[0] != "@"]
        assert body, case


@pytest.mark.parametrize("stream", [False, True])
def test_stats_shares_over_the_methods(world, monkeypatch, stream):
    """--stats where a counter is not zero (stage 2 cut to 2 rows a batch
    overflows): the method shares sum to 100%, the counters print on
    lines of their own, and each span its calls."""
    from tpumap_torch.gsnap import engine, ladder
    monkeypatch.setattr(ladder, "align_batch_cascaded_packed",
                        functools.partial(engine.align_batch_cascaded_packed,
                                          stage2_rows=2))
    rc, _out, err = run_main(
        gsnap_cli.main, ["-D", world["D"], "--stats"]
        + (["--sam-use-0M", "0"] if stream else [])
        + [world["R"], "--device", "cpu"])
    assert rc == 0
    methods, counters, spans = stats_lines(err)
    assert counters["stage2_overflow"] > 0
    assert methods and not set(methods) & set(counters)
    assert sum(p for _c, p in methods.values()) == pytest.approx(
        100.0, abs=0.05 * len(methods))
    assert sum(c for c, _p in methods.values()) == counters["reads"]
    assert spans["enqueue"] == spans["refine"] == counters["batches"]


def test_sam_use_0m_0_writes_fewer_secondaries(world, tmp_path):
    """tpumap's plain stream (--sam-use-0M 0) drops the -n secondaries
    that the default record path prints for the duplicated segment's
    reads; the port copies both (test_main_parity's default and
    sam_use_0m_0 cases hold the bytes)."""
    counts = []
    for extra in ([], ["--sam-use-0M", "0"]):
        rc, out, _err = run_main(gsnap_cli.main, ["-D", world["D"]] + extra
                                 + [world["R"], "--device", "cpu"])
        assert rc == 0
        counts.append(sum(1 for ln in out.splitlines()
                          if ln[:1] != "@" and int(ln.split("\t")[1]) & 256))
    assert counts[0] > 0 and counts[1] == 0


def test_main_needs_a_card_or_cpu(world):
    """Without --device cpu, main runs on the card, and exits with a
    clear message where there is none; --version names the port."""
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            gsnap_cli.main(["-D", world["D"], world["R"]])
    with pytest.raises(SystemExit) as exc, redirect_stdout(io.StringIO()) \
            as buf:
        gsnap_cli.main(["--version"])
    assert exc.value.code == 0
    assert buf.getvalue().startswith("tpumap_torch-gsnap 0.1.0")
