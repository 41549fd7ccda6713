"""A pair's TLEN and proper-pair bit in the port, measured on the mates'
aligned bases (SAM v1.6, 1.4: from the leftmost to the rightmost aligned
base of the two mates): where the mate that ends the pair is gapped,
spliced or soft-clipped, its end is its POS plus the reference length of
its CIGAR, not its start plus the read's length.

Hand-built pairs on a small genome (an insertion, a deletion, a deletion
on the reverse first mate, a spliced and clipped mate, a dovetail and a
plain pair), each held to the span of its own lines and to pairmax at the
span's edge; 1,024 pairs of the benchmark's wgsim_pe100 traffic on its CPU
test genome, judged by the benchmark's plain reference
(benchmark/reference/judge.py); and the pair counters of
align_paired_records(stats=) and gsnap_cli --stats. No JAX here."""
import io
import json
import pathlib
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from tpumap_torch.cli import gsnap_cli
from tpumap_torch.gsnap import engine, paired
from tpumap_torch.index.build import build_db_from_seqs
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io.fasta import Record, read_seqs
from tpumap_torch.utils import dna
from torch_workloads import aligned_span

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))
RNA = dict(novelsplicing=True, max_intron=10_000)
PAIR_COUNTERS = ("pairs", "pairs_concordant", "pairs_exhaustive",
                 "pairs_proper", "tlen_from_alignment")


def _other(b: str) -> str:
    return "ACGT"[("ACGT".index(b) + 2) % 4]


def _hand_genome():
    rng = np.random.default_rng(2222)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 40000))
    # an intron, GT..AG, over [20200, 20400)
    return g[:20200] + "GT" + g[20202:20398] + "AG" + g[20400:]


def _hand_pairs(g):
    """name -> (mate 1, mate 2, run keywords, the CIGAR op that makes
    the special mate)."""
    q = 2400
    ins = g[q:q + 91] + _other(g[q + 90]) + _other(g[q + 91]) + \
        g[q + 91:q + 98]
    junk = "".join(_other(c) for c in g[20430:20440])
    return {
        # mate 2 ends the pair with two inserted bases
        "insertion": (g[2000:2100], dna.revcomp(ins), {}, "2I"),
        # mate 2 ends the pair with a deleted base
        "deletion": (g[6000:6100], dna.revcomp(g[6430:6456]
                                               + g[6457:6531]), {}, "1D"),
        # mate 1, reverse, ends the pair with three deleted bases
        "first_mate": (dna.revcomp(g[10380:10430] + g[10433:10483]),
                       g[10000:10100], {}, "3D"),
        # mate 2 spliced over the intron, its last 10 bases clipped
        "spliced_clipped": (g[19800:19900], dna.revcomp(
            g[20140:20200] + g[20400:20430] + junk), RNA, "200N"),
        # plain pairs, the native emitter's: a dovetail (both clipped)
        # and a pair inside its insert
        "dovetail": (g[30000:30100], dna.revcomp(g[29980:30080]), {}, None),
        "plain": (g[33000:33100], dna.revcomp(g[33300:33400]), {}, None),
    }


@pytest.fixture(scope="module")
def hand():
    g = _hand_genome()
    db = build_db_from_seqs([("chrT", g)], name="t", k=12, interval=3)
    return db, DeviceIndex.from_host(db, "cpu"), _hand_pairs(g)


def _lines(db, index, pairs, pairmax, sink=True, stats=None, **kw):
    recs = [(Record(f"h{i}", "", a), Record(f"h{i}", "", b))
            for i, (a, b) in enumerate(pairs)]
    if sink:
        out = []
        paired.align_paired_records(db, index, recs, engine.AlignConfig(),
                                    pairmax=pairmax, sink=out.append,
                                    stats=stats, **kw)
        text = b"".join(bytes(c) for c in out).decode()
    else:
        text = "".join(a.lines() + b.lines() for a, b in
                       paired.align_paired_records(
                           db, index, recs, engine.AlignConfig(),
                           pairmax=pairmax, stats=stats, **kw))
    return [ln.split("\t") for ln in text.splitlines()]


def _pair_span(f1, f2):
    """The mates' span and mate 1's TLEN sign from their own lines."""
    (s1, e1), (s2, e2) = aligned_span(f1), aligned_span(f2)
    return max(e1, e2) - min(s1, s2), (1 if s1 <= s2 else -1)


@pytest.mark.parametrize("sink", [True, False])
@pytest.mark.parametrize("name", list(_hand_pairs(_hand_genome())))
def test_tlen_is_the_span_of_the_mates_own_lines(hand, name, sink):
    db, index, pairs = hand
    a, b, kw, op = pairs[name]
    stats = {}
    f1, f2 = _lines(db, index, [(a, b)], 2000 if kw else 1000, sink,
                    stats=stats, **kw)
    assert int(f1[1]) & 0x2 and int(f2[1]) & 0x2
    cigars = f1[5] + f2[5]
    if op is None:
        assert "I" not in cigars and "D" not in cigars and "N" not in cigars
        assert stats["rows_native"] == 2
        assert stats.get("tlen_from_alignment", 0) == 0
    else:
        assert op in cigars
        assert stats["tlen_from_alignment"] == 1
    span, sign = _pair_span(f1, f2)
    assert (int(f1[8]), int(f2[8])) == (sign * span, -sign * span)
    assert stats["pairs_proper"] == 1
    if name == "dovetail":
        assert (f1[5], f2[5]) == ("80M20S", "20S80M") and span == 80


@pytest.mark.parametrize("name", list(_hand_pairs(_hand_genome())))
def test_proper_pair_bit_at_pairmax(hand, name):
    """Proper with TLEN the span where pairmax is the span; neither where
    the span is pairmax + 1, every other field as it was."""
    db, index, pairs = hand
    a, b, kw, _op = pairs[name]
    f1, f2 = _lines(db, index, [(a, b)], 2000 if kw else 1000, **kw)
    span, sign = _pair_span(f1, f2)
    at = _lines(db, index, [(a, b)], span, **kw)
    past = _lines(db, index, [(a, b)], span - 1, **kw)
    assert at == [f1, f2]
    for f, g in zip(past, at):
        assert int(f[1]) == int(g[1]) & ~0x2 and f[8] == "0"
        assert f[:1] + f[2:8] + f[9:] == g[:1] + g[2:8] + g[9:]


# ------------------------------------------------- the benchmark's traffic

@pytest.fixture(scope="module")
def judged():
    """1,024 wgsim_pe100 pairs (seed 2**31 + 7) on the benchmark's CPU
    test genome (its configuration cut to 2 Mbp, k = 10), through the
    cell's path: the configuration's AlignConfig, pairmax 1000, one batch
    of 1,024 pairs, the SAM to a sink."""
    from harness import genome, traffic
    cfg = json.loads((BENCH / "configs" / "gsnap_dna_pe_chr1.json"
                      ).read_text())
    cfg.update({"genome_bp": 2_000_000, "k": 10})
    cfg["genes"] = dict(cfg["genes"], count=2_000_000 // 116750 - 1)
    spec = genome.genome_spec(cfg)
    codes, genes = genome.genome_codes(spec), genome.gene_table(spec)
    db = build_db_from_seqs([(cfg["contig"], genome.codes_to_text(codes))],
                            name="genome", k=cfg["k"],
                            interval=cfg["interval"])
    mix = json.loads((BENCH / "traffic" / "wgsim_pe100.json").read_text())
    block = traffic.make_block(codes, genes, mix, 2147483655, 0, n=1024)
    r1, r2 = (list(read_seqs(io.StringIO(t.decode()))) for t in
              block["fasta"])
    stats, out = {}, []
    paired.align_paired_records(
        db, DeviceIndex.from_host(db, "cpu"), list(zip(r1, r2)),
        engine.AlignConfig(**cfg["align"]), pairmax=cfg["pairmax"],
        batch_size=cfg["pair_batch_size"],
        novelsplicing=cfg["novelsplicing"], max_intron=cfg["max_intron"],
        sink=out.append, stats=stats)
    return cfg, codes, block, b"".join(bytes(c) for c in out), stats


def test_wgsim_pairs_judged_by_the_reference(judged):
    """No bad record: every TLEN, mate field and proper-pair bit as the
    SAM specification and pairmax give them (the port before the repair
    read 25 bad pairs here, each with an indel in a mate)."""
    from reference import judge
    cfg, codes, block, text, _stats = judged
    out = judge.judge(codes, torch.from_numpy(codes), cfg["contig"].encode(),
                      [block], [text], True, cfg["k"], cfg["interval"],
                      cfg["pairmax"])
    assert out["sample"] == 2048
    assert out["bad_records"] == 0, out["problems"]


def test_wgsim_pairs_tlen_plain_and_gapped(judged):
    """The native emitter's plain pairs and the Python records' gapped
    ones alike: each proper pair's TLEN is the span of its lines."""
    _cfg, _codes, _block, text, stats = judged
    lines = [ln.split("\t") for ln in text.decode().splitlines()]
    gapped = plain = 0
    for f1, f2 in zip(lines[0::2], lines[1::2]):
        if not int(f1[1]) & 0x2:
            continue
        span, sign = _pair_span(f1, f2)
        assert (int(f1[8]), int(f2[8])) == (sign * span, -sign * span)
        if any(op in f1[5] + f2[5] for op in "IDN"):
            gapped += 1
        else:
            plain += 1
    assert gapped >= 10 and plain >= 900
    assert stats["rows_native"] >= 2 * plain


def test_wgsim_pair_counters(judged):
    _cfg, _codes, _block, text, stats = judged
    flags = [int(ln.split(b"\t")[1]) for ln in text.splitlines()]
    assert stats["pairs"] == 1024 and stats["reads"] == 2048
    assert stats["pairs_proper"] == sum(f & 0x2 > 0 for f in flags) // 2
    assert 0 < stats["tlen_from_alignment"] <= stats["pairs_proper"]
    assert stats["pairs_exhaustive"] <= stats["pairs"] - stats[
        "pairs_concordant"]
    assert stats["pairs_concordant"] >= 1000


def test_gsnap_cli_stats_prints_the_pair_counters(hand, tmp_path):
    """gsnap_cli --stats on a paired run: the pair counters, the rescue
    span, pairs_proper the lines with 0x2 over two."""
    db, _index, pairs = hand
    db.save(str(tmp_path / "db"))
    dna_pairs = [p for p in pairs.values() if not p[2]]
    for k in (0, 1):
        (tmp_path / f"r{k + 1}.fa").write_text("".join(
            f">h{i}\n{p[k]}\n" for i, p in enumerate(dna_pairs)))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = gsnap_cli.main(["-D", str(tmp_path / "db"), "--stats",
                             "--pairmax", "1000", "--device", "cpu",
                             str(tmp_path / "r1.fa"), str(tmp_path / "r2.fa")])
    assert rc in (0, None)
    counters = {}
    spans = set()
    for ln in err.getvalue().splitlines():
        kind, _, rest = ln.partition(" ")
        name, _, val = rest.partition(": ")
        if kind == "counter":
            counters[name] = int(val)
        elif kind == "span":
            spans.add(name)
    assert set(PAIR_COUNTERS) <= set(counters)
    body = [ln.split("\t") for ln in out.getvalue().splitlines()
            if ln and ln[0] != "@"]
    proper = sum(int(f[1]) & 0x2 > 0 and not int(f[1]) & 0x900 for f in body)
    assert counters["pairs"] == len(dna_pairs)
    assert counters["pairs_proper"] == proper // 2 == len(dna_pairs)
    assert counters["tlen_from_alignment"] == 3
    assert "pair" in spans
