"""The block parse of FASTA (`io.fasta.read_fasta`) against the line loop
it replaces on the bulk path (`_read_fasta_lines`): equal records, in
the same order, on crafted texts through a StringIO, through files read
in blocks small enough that records straddle them, through gzip and
through `read_seqs`; the line loop itself against tpumap's reader; and
the counters `parse_bulk` and `parse_lines` on the benchmark's traffic
and on multi-line records."""
import dataclasses
import gc
import gzip
import io
import json
import pathlib
import sys

import pytest

from tpumap.io import fasta as jfasta
from tpumap_torch.io import fasta
from tpumap_torch.utils import trace

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

SINGLE = "".join(f">r{i:04d}\n{'ACGTN'[i % 5] * (90 + i % 20)}\n"
                 for i in range(60))
MULTI = "".join(f">c{i} chrom {i}\n{'ACGT' * 15}\n{'TTGCA' * 9}\nNNNN\n"
                for i in range(12))

TEXTS = {
    "single_line": SINGLE,
    "descriptions": ">r1 1:N:0:ACGT\nACGT\n>r2 2:Y:0:ACGT extra\nGGTT\n",
    "header_spaces": ">  r1 lead\nACGT\n>r2 trail  \nCC\n>r3  x y\nAA\n",
    "sequence_spaces": ">r1 d\n AC GT \n>r2\nTT\n",
    "blank_sequence_line": ">r1\n   \n>r2\nAC\n",
    "tabs": ">r1\tdesc\nACGT\n>r2\nAC\tGT\t\n",
    "crlf": ">r1 d\r\nACGT\r\n>r2\r\nGG\r\n",
    "lone_cr": ">r1\nAC\rGT\n>r2\nTT\n",
    "blank_lines": ">r1\nACGT\n\n>r2\nGG\n\n\n",
    "leading_text": "junk line\n\n>r1\nACGT\n>r2\nCC\n",
    "leading_blank": "\n>r1\nACGT\n",
    "multi_line": MULTI,
    "empty_sequence": ">r1\n>r2\nACGT\n>r3\n",
    "bare_header": ">\nACGT\n>r2\nCC\n",
    "no_final_newline": ">r1\nACGT\n>r2\nGGCC",
    "header_only_at_end": ">r1\nACGT\n>r2",
    "lowercase": ">r1\nacgtnACGT\n>r2\nggcc\n",
    "ns": ">r1\nNNNNACGTNNNN\n>r2\nN\n",
    "non_ascii_header": ">r1 caf\u00e9\nACGT\n>r\u00e92\nGG\n",
    "non_ascii_space": ">r1\u00a0\nACGT\n>r2\n\u2003GG\u2028\n",
    "gt_in_header": ">r1>x\nACGT\n>>r2\nGG\n",
    "gt_sequence_shift": ">a\n>b\nAC\nGT\n",
    "gt_sequence_line": ">a\n>b\n>c\nAC\n",
    "control_whitespace": ">r1\x1c\nAC\x0b\n>r2\x0c\nGG\x1f\n",
    "one_line": ">r1",
    "empty": "",
    "turns_multi_line": SINGLE + MULTI,
    "multi_then_single": MULTI + SINGLE,
    "long_record": ">long\n" + "ACGT" * 500 + "\n" + SINGLE,
}
# characters a file block is read in: records straddle blocks, and some
# are longer than a block
BLOCKS = [1, 7, 150, 333, 1000, 1 << 22]


def _lines(text: str) -> list:
    return list(fasta._read_fasta_lines(io.StringIO(text)))


@pytest.mark.parametrize("name", TEXTS)
def test_stringio_equals_line_loop(name):
    text = TEXTS[name]
    want = _lines(text)
    assert [dataclasses.astuple(r) for r in want] == [
        dataclasses.astuple(r) for r in jfasta.read_fasta(io.StringIO(text))]
    assert list(fasta.read_fasta(io.StringIO(text))) == want
    assert list(fasta.read_seqs(io.StringIO(text))) == want


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", TEXTS)
def test_file_blocks_equal_line_loop(name, block, tmp_path, monkeypatch):
    path = tmp_path / "r.fa"
    path.write_bytes(TEXTS[name].encode())
    with open(path) as fh:
        want = list(fasta._read_fasta_lines(fh))
    monkeypatch.setattr(fasta, "_BLOCK", block)
    assert list(fasta.read_fasta(path)) == want
    assert list(fasta.read_fasta(str(path))) == want
    assert list(fasta.read_seqs(path)) == want


@pytest.mark.parametrize("block", [7, 1 << 22])
def test_gzip_and_stream_equal_line_loop(block, tmp_path, monkeypatch):
    text = TEXTS["turns_multi_line"] + TEXTS["descriptions"]
    gz = tmp_path / "r.fa.gz"
    gz.write_bytes(gzip.compress(text.encode()))
    monkeypatch.setattr(fasta, "_BLOCK", block)
    want = _lines(text)
    assert list(fasta.read_fasta(gz)) == want
    assert list(fasta.read_seqs(gz)) == want
    # a stream that is not a StringIO reads in blocks too
    with gzip.open(gz, "rt") as fh:
        assert list(fasta.read_fasta(fh)) == want


def test_partly_read_records_keep_their_order(tmp_path, monkeypatch):
    """Records come a block at a time, so a caller that stops early has
    the records before it, as from the line loop."""
    path = tmp_path / "r.fa"
    path.write_text(SINGLE)
    monkeypatch.setattr(fasta, "_BLOCK", 300)
    it = fasta.read_fasta(path)
    assert [next(it) for _ in range(3)] == _lines(SINGLE)[:3]
    it.close()


def _counts(text: str) -> dict:
    with trace.recording(rec := trace.Recorder()):
        n = len(list(fasta.read_seqs(io.StringIO(text))))
    return {"n": n, "bulk": rec.counters.get("parse_bulk", 0),
            "lines": rec.counters.get("parse_lines", 0)}


@pytest.fixture(scope="module")
def traffic_texts():
    """The benchmark's FASTA texts, 1,024 single-end reads and 1,024
    pairs, on its configuration's genome cut to 2 Mbp."""
    from harness import genome, traffic
    cfg = json.loads((BENCH / "configs" / "gsnap_dna_chr1.json"
                      ).read_text())
    cfg.update({"genome_bp": 2_000_000})
    cfg["genes"] = dict(cfg["genes"], count=2_000_000 // 116750 - 1)
    spec = genome.genome_spec(cfg)
    codes, genes = genome.genome_codes(spec), genome.gene_table(spec)
    out = {}
    for mix in ("wgsim_se100", "wgsim_pe100"):
        spec_mix = json.loads((BENCH / "traffic" / f"{mix}.json"
                               ).read_text())
        block = traffic.make_block(codes, genes, spec_mix, 2147483659, 3,
                                   truth=False, n=1024)
        out[mix] = [t.decode("ascii") for t in block["fasta"]]
    return out


@pytest.mark.parametrize("mix", ["wgsim_se100", "wgsim_pe100"])
def test_benchmark_traffic_parses_in_bulk(traffic_texts, mix):
    texts = traffic_texts[mix]
    assert len(texts) == (2 if mix == "wgsim_pe100" else 1)
    for text in texts:
        assert _counts(text) == {"n": 1024, "bulk": 1024, "lines": 0}
        assert list(fasta.read_seqs(io.StringIO(text))) == _lines(text)


def test_multi_line_text_takes_the_line_loop():
    assert _counts(MULTI) == {"n": 12, "bulk": 0, "lines": 12}
    # a block that turns multi-line sends it and the rest to the loop
    assert _counts(SINGLE + MULTI) == {"n": 72, "bulk": 0, "lines": 72}


def test_counters_split_at_the_first_multi_line_block(tmp_path, monkeypatch):
    path = tmp_path / "r.fa"
    path.write_text(SINGLE + MULTI)
    monkeypatch.setattr(fasta, "_BLOCK", len(SINGLE) - 1)
    with trace.recording(rec := trace.Recorder()):
        got = list(fasta.read_fasta(path))
    assert got == _lines(SINGLE + MULTI)
    bulk = rec.counters["parse_bulk"]
    assert 0 < bulk < 60
    assert rec.counters["parse_lines"] == 72 - bulk


def test_record_has_slots():
    rec = fasta.Record("r1", "d", "ACGT")
    assert not hasattr(rec, "__dict__")
    with pytest.raises(AttributeError):
        rec.other = 1
    rec.accession, rec.quality = "r2", "IIII"
    assert (rec.header, len(rec), rec.quality) == ("r2 d", 4, "IIII")


def test_collector_state_is_kept():
    """The bulk path pauses the cyclic collector while it builds a
    block's records, never across a yield, and leaves it as it found
    it."""
    assert gc.isenabled()
    it = fasta.read_fasta(io.StringIO(SINGLE))
    next(it)
    assert gc.isenabled()
    assert len(list(it)) == 59 and gc.isenabled()
    gc.disable()
    try:
        assert list(fasta.read_fasta(io.StringIO(SINGLE))) == _lines(SINGLE)
        assert not gc.isenabled()
    finally:
        gc.enable()
