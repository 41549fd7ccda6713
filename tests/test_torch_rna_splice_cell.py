"""GSNAP RNA-seq with novel splicing (-N 1) through the port's normal
path, at test size: the deployment of the benchmark's rna_mrna_se100
cell (configs/gsnap_rna_chr1.json, traffic/mrna_se100.json).

F4: the chain DP can end a path with a segment shorter than the
insertion junction after it (a one-base segment between a deletion and
an insertion of the same length), which no CIGAR states; path_record
raised on it, as tpumap's does. The chain stages now mend such a path
where they accept it (driver._mend_overrun). Pinned here with the reads
that showed it: r0000036990 of block 9 of seed 0 (found on the
configuration cut to 400 genes) and r0000001539 of the judged block
below, on the configuration cut to 47 genes, the smallest of its
generator that holds the first; hand-built paths through the helper
and the fused acceptance; one 4,096-read block of the cell's traffic
judged by the benchmark's plain reference against its control; and the
splice layer's counters through stats=, a Recorder and gsnap_cli
--stats. No JAX here."""
import io
import json
import pathlib
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from tpumap_torch.cli import gsnap_cli
from tpumap_torch.gsnap import driver, engine
from tpumap_torch.index.build import build_db_from_seqs
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io import sam
from tpumap_torch.io.fasta import Record, read_seqs
from tpumap_torch.utils import trace

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))
CELL = "rna_mrna_se100"
GENES = 47
SPLICE_COUNTERS = ("chain_ins_refused", "review_rows", "review_spliced",
                   "path_rows")
# name -> (the read as sent, the line's FLAG, POS and CIGAR once mended)
F4_READS = {
    "r0000036990": (
        "CCCTGCGGCATTCATCCCATATTGTTTTAACGCTTATCACGCGGGCGGCGCGATTTTTAGGAGT"
        "CTCCTAGGTAGCGCGATTCAAAGCTGCAGTCCGCCT",
        16, 5371774, "27M5000N19M5I49M"),
    "r0000001539": (
        "TAGGCCTCAAATGGCCCCCTTAGAGCCATGCACAAGTTGAAGTAATGAACGTTAAGTTGAAATC"
        "CAGCAATAGAACTATCACACATGCGTGGATTTTGCA",
        16, 845025, "30M6I64M"),
}
JUDGED_SEED = 2**31 + 26


def _cfg():
    cfg = json.loads((BENCH / "configs" / "gsnap_rna_chr1.json").read_text())
    cfg.update({"genome_bp": GENES * 116750})
    cfg["genes"] = dict(cfg["genes"], count=GENES)
    return cfg


def _run(db, index, records, cfg, sink, **kw):
    """The SAM text of align_records as the cell runs it, in sink or list
    mode."""
    if sink:
        out = []
        assert driver.align_records(
            db, index, records, engine.AlignConfig(**cfg["align"]),
            novelsplicing=cfg["novelsplicing"], max_intron=cfg["max_intron"],
            batch_size=cfg["batch_size"], sink=out.append, **kw) == []
        text = b"".join(bytes(c) for c in out)
    else:
        text = "".join(r.lines() for r in driver.align_records(
            db, index, records, engine.AlignConfig(**cfg["align"]),
            novelsplicing=cfg["novelsplicing"], max_intron=cfg["max_intron"],
            batch_size=cfg["batch_size"], **kw)).encode()
    return text


@pytest.fixture(scope="module")
def world():
    """The configuration's genome cut to 47 genes (5,487,250 bp), its k =
    14, interval 3 index on the CPU."""
    from harness import genome
    cfg = _cfg()
    spec = genome.genome_spec(cfg)
    codes, genes = genome.genome_codes(spec), genome.gene_table(spec)
    db = build_db_from_seqs([(cfg["contig"], genome.codes_to_text(codes))],
                            name="genome", k=cfg["k"],
                            interval=cfg["interval"])
    return cfg, codes, genes, db, DeviceIndex.from_host(db, "cpu")


def _check(line: bytes, read: str, codes, contig: bytes):
    from reference import samcheck
    sent = samcheck.codes_of(read.encode())
    return samcheck.check(samcheck.parse(line), sent, codes, contig)


@pytest.mark.parametrize("sink", [True, False])
def test_f4_reads_align_through_their_mended_paths(world, sink):
    """Each read's chain path is mended where it is accepted (counted in
    chain_ins_refused), and its line is the read's true alignment, its
    CIGAR, NM and MD borne out by the genome."""
    cfg, codes, _genes, db, index = world
    stats = {}
    recs = [Record(n, "", s) for n, (s, *_r) in F4_READS.items()]
    text = _run(db, index, recs, cfg, sink, stats=stats)
    assert stats["chain_ins_refused"] == len(F4_READS)
    assert stats["path_rows"] == len(F4_READS)
    lines = text.decode().splitlines()
    assert len(lines) == len(F4_READS)
    for line, (name, (seq, flag, pos, cigar)) in zip(lines, F4_READS.items()):
        f = line.split("\t")
        assert (f[0], int(f[1]), int(f[3]), f[5]) == (name, flag, pos, cigar)
        why, score, _span = _check(line.encode(), seq, codes, b"chr1")
        assert why is None and score > 0


def test_f4_reads_raise_without_the_mend(world, monkeypatch):
    """The fault itself: the unmended path reaches path_record, which
    refuses to write a segment shorter than its insertion."""
    cfg, _codes, _genes, db, index = world
    monkeypatch.setattr(driver, "_mend_overrun", lambda s: False)
    for name, (seq, *_r) in F4_READS.items():
        with pytest.raises(ValueError, match=f"segment .* of {name}"):
            _run(db, index, [Record(name, "", seq)], cfg, True)


# ------------------------------------------------------ hand-built paths

D = 3000
# name -> (segs, q_start, (mended segs, mended q_start) or None, CIGAR)
HAND = {
    # a 3-base insertion after a 2-base segment: the segment goes, the
    # exon before it runs on to the insertion's far side (an intron)
    "ins3_after_seg2": ([(0, D), (40, D + 1000), (42, D + 997)], 0,
                        ([(0, D), (42, D + 997)], 0), "42M997N58M"),
    # F4 as the chain DP gave it: a deletion and an insertion of 5 around
    # one base; the segments either side share a diagonal and join
    "flip_flop": ([(0, D), (27, D + 5000), (51, D + 4995), (91, D + 5000),
                   (92, D + 4995)], 0,
                  ([(0, D), (27, D + 5000), (51, D + 4995)], 0),
                  "27M5000N19M5I49M"),
    # two overruns in a row: each dropped segment leaves the one before it
    # overrunning, down to the first exon
    "cascade": ([(0, D), (30, D + 100), (32, D + 98), (33, D + 95)], 0,
                ([(0, D), (33, D + 95)], 0), "33M95N67M"),
    # the first segment overrun: its bases are soft clipped
    "first_segment": ([(3, D), (5, D - 4)], 3, ([(5, D - 4)], 5), "5S95M"),
    # an insertion its segment holds: left as it is
    "held": ([(0, D), (50, D - 2)], 0, None, "48M2I50M"),
}


@pytest.fixture(scope="module")
def hand_db():
    rng = np.random.default_rng(2626)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 12000))
    return g, build_db_from_seqs([("chrH", g)], name="h", k=12, interval=3)


def _path(case):
    segs, q_start, _want, _cigar = HAND[case]
    return {"segs": list(segs), "q_start": q_start, "q_end": 100,
            "strand": 0, "score": 640, "nmm": 0}


def _read_of(g: str, segs, q_start, q_end=100) -> str:
    """A read that the path states exactly: each segment's bases from the
    genome at its diagonal, inserted and clipped bases A."""
    out = ["A"] * q_end
    for j, (q0, d) in enumerate(segs):
        q1 = segs[j + 1][0] if j + 1 < len(segs) else q_end
        n_ins = max(d - segs[j + 1][1], 0) if j + 1 < len(segs) else 0
        for q in range(max(q0, q_start), q1 - n_ins):
            out[q] = g[d + q]
    return "".join(out)


@pytest.mark.parametrize("case", list(HAND))
def test_mend_overrun_on_hand_built_paths(hand_db, case):
    """_mend_overrun mends the paths that overrun and leaves one that does
    not; path_record raises on the path before the mend and writes the
    mended path with a CIGAR, NM and MD that the genome bears out."""
    g, db = hand_db
    segs, q_start, want, cigar = HAND[case]
    s = _path(case)
    assert driver._mend_overrun(s) == (want is not None)
    if want is not None:
        assert (s["segs"], s["q_start"]) == want
        with pytest.raises(ValueError, match="insertion"):
            sam.path_record(db, "h", "A" * 100, None, segs, q_start, 100, 0,
                            40)
    assert not driver._mend_overrun(dict(s))
    read = _read_of(g, s["segs"], s["q_start"])
    rec = sam.path_record(db, "h", read, None, s["segs"], s["q_start"],
                          100, 0, 40, min_intron=driver.MIN_INTRON)
    assert rec.cigar == cigar
    from reference import samcheck
    line = rec.lines().rstrip("\n").encode()
    why, _score, _span = samcheck.check(
        samcheck.parse(line), samcheck.codes_of(read.encode()),
        samcheck.codes_of(g.encode()), b"chrH")
    assert why is None


def test_fused_acceptance_mends_a_hand_built_row():
    """Two chain rows of the fused ladder's result as the host receives
    them: the overrunning one is mended in splice_result and counted;
    neither goes to the native emitter's array rows (both hold an
    insertion); the other path is as the ladder gave it."""
    S = 8
    rows = [HAND["ins3_after_seg2"][0], HAND["held"][0]]
    segq = np.zeros((2, S), np.int16)
    segd = np.zeros((2, S), np.int64)
    for r, segs in enumerate(rows):
        segq[r, :len(segs)] = [q for q, _ in segs]
        segd[r, :len(segs)] = [d for _, d in segs]
    res = {"diag": np.array([D, D], np.uint32),
           "strand": np.zeros(2, np.int8),
           "ch_sel": np.array([True, True]), "ch_idx": np.arange(2),
           "ch_segq": segq, "ch_segd": segd,
           "ch_nsegs": np.array([3, 2], np.uint8),
           "ch_qstart": np.zeros(2, np.int16),
           "ch_qend": np.full(2, 100, np.int16),
           "ch_score": np.full(2, 700, np.int16),
           "ch_nmm": np.zeros(2, np.int16),
           "in_sel": np.zeros(0, bool), "nmismatch": np.zeros(2, np.int32)}
    stats = {}
    with trace.counting(stats):
        dp, sp = driver._fused_acceptance(
            {}, res, None, False, 2, np.full(2, 100, np.int32), 6, 9, 4)
    assert dp == {} and stats["chain_ins_refused"] == 1
    assert sp[0]["segs"] == HAND["ins3_after_seg2"][2][0]
    assert sp[1]["segs"] == HAND["held"][0]
    assert not res["sp_sel"].any()


def test_fused_acceptance_refuses_a_path_past_its_segment_slots():
    """F5: the chain DP keeps 8 segments a path and reports how many it
    walked; past 8 the first ones are lost (their slots read INT32_MIN
    and INVALID). An accepted path of 9 is refused and counted, and a
    row of 9 that the ladder did not accept is no fault either (the
    short-exon test read its slot 9 before: IndexError, as in tpumap)."""
    S = 8
    segq = np.zeros((3, S), np.int16)
    segd = np.zeros((3, S), np.int64)
    segq[:2] = np.arange(0, 80, 10)
    segd[:2] = D + 1000 * np.arange(S)
    segq[:2, 0] = np.iinfo(np.int16).min
    segd[:2, 0] = 0xFFFFFFFF
    segq[2, :2], segd[2, :2] = (0, 60), (D, D + 500)
    res = {"diag": np.full(3, D, np.uint32), "strand": np.zeros(3, np.int8),
           "ch_sel": np.array([True, False, True]), "ch_idx": np.arange(3),
           "ch_segq": segq, "ch_segd": segd,
           "ch_nsegs": np.array([S + 1, S + 1, 2], np.uint8),
           "ch_qstart": np.array([-32768, -32768, 0], np.int16),
           "ch_qend": np.full(3, 100, np.int16),
           "ch_score": np.full(3, 700, np.int16),
           "ch_nmm": np.zeros(3, np.int16),
           "in_sel": np.zeros(0, bool), "nmismatch": np.zeros(3, np.int32)}
    stats = {}
    with trace.counting(stats):
        _dp, sp = driver._fused_acceptance(
            {}, res, None, True, 3, np.full(3, 100, np.int32), 6, 9, 4)
    assert stats["chain_segs_refused"] == 1
    assert list(sp) == [2] and sp[2]["segs"] == [(0, D), (60, D + 500)]


def test_staged_chains_refuse_a_path_past_its_segment_slots(world,
                                                             monkeypatch):
    """F5 on the staged path (fusions on): the chain DP's first row made
    to report 9 segments is refused and counted; both reads still get a
    line that the genome bears out."""
    from tpumap_torch.ops import pathdp
    cfg, codes, _genes, db, index = world
    real = pathdp.chain_solve

    def nine(*args, **kw):
        out = real(*args, **kw)
        out["nsegs"][0] = pathdp.MAX_SEGMENTS + 1
        return out
    monkeypatch.setattr(pathdp, "chain_solve", nine)
    stats = {}
    recs = [Record(n, "", s) for n, (s, *_r) in F4_READS.items()]
    text = _run(db, index, recs, cfg, True, stats=stats, find_fusions=True)
    assert stats["chain_segs_refused"] == 1
    lines = text.splitlines()
    assert len(lines) == len(F4_READS)
    for line, (seq, *_r) in zip(lines, F4_READS.values()):
        assert _check(line, seq, codes, b"chr1")[0] is None


# -------------------------------------- the cell's traffic, judged


@pytest.fixture(scope="module")
def judged(world):
    """One 4,096-read block of mrna_se100 (block 0 of seed 2**31 + 26)
    through the cell's path, the SAM to a sink, with a Recorder installed
    and stats= both receiving the counts."""
    from harness import traffic
    cfg, codes, genes, db, index = world
    mix = json.loads((BENCH / "traffic" / "mrna_se100.json").read_text())
    block = traffic.make_block(codes, genes, mix, JUDGED_SEED, 0)
    recs = list(read_seqs(io.StringIO(block["fasta"][0].decode())))
    stats = {}
    rec = trace.Recorder()
    with trace.recording(rec):
        text = _run(db, index, recs, cfg, True, stats=stats)
    return block, text, stats, rec


def test_block_judged_by_the_reference_and_the_control(world, judged):
    """The port's lines: no bad record and worse_share under the cell's
    limit; the control (the reference's ungapped aligner) on the same
    block over it, by at least five times the limit."""
    from reference import judge
    from reference.control import control_sam
    cfg, codes, _genes, _db, _index = world
    block, text, _stats, _rec = judged
    limit = json.loads((BENCH / "cells" / f"{CELL}.json").read_text()
                       )["limits"]["worse_share"]
    genome_t = torch.from_numpy(codes)
    args = (cfg["k"], cfg["interval"], cfg["pairmax"])
    got = judge.judge(codes, genome_t, b"chr1", [block], [text], False, *args)
    ctl = judge.judge(codes, genome_t, b"chr1", [block],
                      [control_sam(codes, genome_t, b"chr1", [block], False,
                                   *args)], False, *args)
    assert got["sample"] == ctl["sample"] == 4096
    assert got["bad_records"] == 0, got["problems"]
    assert got["worse_share"] < limit, got["worse_examples"]
    assert ctl["worse_share"] >= 5 * limit


def test_block_counters_reach_stats_and_a_recorder(judged):
    """The splice layer's counters on the cell's traffic: the same in
    stats= and a Recorder; the review span once a batch; F4's read of
    this block mended; the Python path rows among the Python rows."""
    _block, _text, stats, rec = judged
    assert rec.counters == stats
    assert stats["batches"] == 4 and stats["reads"] == 4096
    assert set(SPLICE_COUNTERS) <= set(stats)
    assert stats["chain_ins_refused"] == 1
    assert rec.calls["splice_review"] == stats["batches"]
    assert 0 < stats["review_rows"] < stats["reads"]
    assert 0 < stats["path_rows"] <= stats["rows_python"]
    assert stats["splice"] >= 0.3 * stats["reads"]


# ------------------------------------------------------ gsnap --stats


def test_gsnap_cli_stats_prints_the_splice_counters(world, tmp_path):
    """gsnap_cli -N 1 --stats over the F4 reads on windows of the
    configuration's genome around them (k = 12): the splice counters it
    prints are those of align_records(stats=) and of a Recorder on the
    same reads, and the splice_review span is printed."""
    cfg, codes, _genes, _db, _index = world
    from harness import genome
    wins = {"chrA": (5371773 - 4000, 5376867 + 4000),
            "chrB": (845024 - 4000, 845124 + 4000)}
    db = build_db_from_seqs(
        [(c, genome.codes_to_text(codes[a:b])) for c, (a, b) in wins.items()],
        name="w", k=12, interval=3)
    db.save(str(tmp_path / "db"))
    reads = [(n, s) for n, (s, *_r) in F4_READS.items()]
    (tmp_path / "r.fa").write_text("".join(f">{n}\n{s}\n" for n, s in reads))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = gsnap_cli.main(["-D", str(tmp_path / "db"), "-N", "1",
                             "--stats", "--device", "cpu",
                             str(tmp_path / "r.fa")])
    assert rc in (0, None)
    printed, spans = {}, set()
    for ln in err.getvalue().splitlines():
        kind, _, rest = ln.partition(" ")
        name, _, val = rest.partition(": ")
        if kind in ("counter", "method"):
            printed[name] = int(val.split()[0])
        elif kind == "span":
            spans.add(name)
    stats = {}
    rec = trace.Recorder()
    with trace.recording(rec):
        driver.align_records(db, DeviceIndex.from_host(db, "cpu"),
                             [Record(n, "", s) for n, s in reads],
                             engine.AlignConfig(), novelsplicing=True,
                             stats=stats)
    for k in SPLICE_COUNTERS:
        assert printed[k] == stats[k] == rec.counters[k], k
    assert printed["chain_ins_refused"] == len(F4_READS)
    assert "splice_review" in spans
    body = [ln.split("\t") for ln in out.getvalue().splitlines()
            if ln and ln[0] != "@"]
    assert sorted(f[5] for f in body) == sorted(
        c for *_r, c in F4_READS.values())
