"""The plain reference: its seeds find the true place on a tiny genome,
its SAM reading accepts true lines and refuses altered ones, the
judge's numbers, and the control at a test's size."""
import numpy as np
import pytest
import torch

from harness import genome, traffic
from reference import control, judge, samcheck, seeds
from tests.tiny import tiny_cell


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cell = tiny_cell(tmp_path_factory.mktemp("g"))
    spec = genome.genome_spec(cell["config"])
    return genome.genome_codes(spec), genome.gene_table(spec)


def _mix(name):
    import json
    import pathlib
    return json.loads((pathlib.Path(__file__).resolve().parents[1]
                       / "traffic" / f"{name}.json").read_text())


def test_imports_nothing_of_the_program():
    import ast
    import pathlib
    for f in (pathlib.Path(__file__).resolve().parents[1]
              / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.partition(".")[0] not in (
                    "tpumap_torch", "tpumap", "jax", "jaxlib", "harness"), \
                    (f.name, n)


def test_seeds_recover_the_truth(world):
    codes, genes = world
    b = traffic.make_block(codes, genes, _mix("wgsim_se100"), 9, 2, n=512)
    t = b["truth"][0]
    score, best = seeds.best_ungapped(torch.from_numpy(codes),
                                      torch.from_numpy(b["reads"][0]), 10, 3)
    plain = (t["ins_ev"] + t["del_ev"]) == 0
    assert (best[plain, 0] == t["strand"][plain]).all()
    # the best clipped alignment starts at or after the true start
    assert (best[plain, 1] >= t["pos0"][plain]).all()
    assert (best[plain, 1] <= t["pos0"][plain] + 100).all()
    assert (score[plain] >= 100 - 4 * t["nmm"][plain] - 30).all()


def _truth_line(codes, sent, t, i):
    """A SAM line of the read's true ungapped alignment."""
    s = int(t["strand"][i])
    q = 3 - sent[::-1] if s else sent
    p = int(t["pos0"][i])
    md, nm = control._md_nm(q, codes[p:p + len(q)])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return b"\t".join([b"r%010d" % i, b"%d" % (16 if s else 0), b"chr1",
                       b"%d" % (p + 1), b"40", b"%dM" % len(q), b"*", b"0",
                       b"0", acgt[q].tobytes(), b"*", b"NM:i:%d" % nm,
                       b"MD:Z:" + md])


def test_check_accepts_truth_and_refuses_alterations(world):
    codes, genes = world
    b = traffic.make_block(codes, genes, _mix("wgsim_se100"), 9, 0, n=256)
    t, reads = b["truth"][0], b["reads"][0]
    plain = (t["ins_ev"] + t["del_ev"] == 0) & (t["nmm"] > 0)
    i = int(np.nonzero(plain)[0][0])
    line = _truth_line(codes, reads[i], t, i)
    why, score, _span = samcheck.check(samcheck.parse(line), reads[i],
                                       codes, b"chr1")
    assert why is None
    assert score == 100 - 4 * int(t["nmm"][i])
    f = line.split(b"\t")
    moved = b"\t".join(f[:3] + [b"%d" % (int(f[3]) + 1)] + f[4:])
    assert samcheck.check(samcheck.parse(moved), reads[i], codes,
                          b"chr1")[0]
    wrong_nm = line.replace(b"NM:i:", b"NM:i:9")
    assert samcheck.check(samcheck.parse(wrong_nm), reads[i], codes,
                          b"chr1")[0]
    other = reads[(i + 1) % len(reads)]
    assert samcheck.check(samcheck.parse(line), other, codes, b"chr1")[0]


@pytest.mark.parametrize("mix,lo", [("wgsim_se100", 0.005),
                                    ("mrna_se100", 0.2),
                                    ("wgsim_pe100", 0.005)])
def test_control_is_not_correct(world, mix, lo):
    """The ungapped control at a test's size: well-formed lines, and
    worse on the reads with indels or junctions."""
    codes, genes = world
    m = _mix(mix)
    pairs = "pairs" in m
    blocks = [traffic.make_block(codes, genes, m, 21, b, n=1024)
              for b in (1, 4)]
    g = torch.from_numpy(codes)
    text = control.control_sam(codes, g, b"chr1", blocks, pairs, 10, 3,
                               1000)
    out = judge.judge(codes, g, b"chr1", blocks, [text], pairs, 10, 3, 1000)
    assert out["bad_records"] == 0, out["problems"]
    assert out["worse_share"] > lo


def test_judge_counts_missing_and_doubled_reads(world):
    codes, genes = world
    m = _mix("wgsim_se100")
    blocks = [traffic.make_block(codes, genes, m, 21, 0, n=256)]
    g = torch.from_numpy(codes)
    text = control.control_sam(codes, g, b"chr1", blocks, False, 10, 3,
                                1000)
    lines = text.split(b"\n")[:-1]
    base = judge.judge(codes, g, b"chr1", blocks, [text], False, 10, 3, 1000)
    half = b"\n".join(lines[::2]) + b"\n"
    out = judge.judge(codes, g, b"chr1", blocks, [half], False, 10, 3, 1000)
    assert out["bad_records"] == base["bad_records"] + 128
    twice = judge.judge(codes, g, b"chr1", blocks, [text, text], False, 10,
                        3, 1000)
    assert twice["bad_records"] == 256


def _pair_lines(text):
    """{read name: [mate 1's fields, mate 2's fields]} of a SAM text."""
    out = {}
    for line in text.split(b"\n"):
        if line:
            f = line.split(b"\t")
            out.setdefault(f[0], [None, None])[0 if int(f[1]) & 0x40
                                               else 1] = f
    return out


def _join(pairs):
    return b"".join(b"\t".join(f) + b"\n" for fs in pairs.values()
                    for f in fs)


def _proper_cleared(pairs):
    for fs in pairs.values():
        for f in fs:
            f[1] = b"%d" % (int(f[1]) & ~0x2)


def _tlen_off_by_one(pairs):
    for fs in pairs.values():
        for f in fs:
            t = int(f[8])
            f[8] = b"%d" % (t + (t > 0) - (t < 0))


def _tlen_zeroed(pairs):
    for fs in pairs.values():
        for f in fs:
            f[8] = b"0"


@pytest.mark.parametrize("plant", [None, _proper_cleared, _tlen_off_by_one,
                                   _tlen_zeroed])
def test_judge_holds_the_pair_fields(world, plant):
    """The pair layer's fields: the reference's own pairs (TLEN from the
    mates' spans, the proper-pair bit where they face each other within
    pairmax) pass; every pair with its proper-pair bit cleared, or its
    TLEN one base off or 0 on a proper pair, is a bad record."""
    codes, genes = world
    blocks = [traffic.make_block(codes, genes, _mix("wgsim_pe100"), 21, 0,
                                 n=256)]
    g = torch.from_numpy(codes)
    text = control.control_sam(codes, g, b"chr1", blocks, True, 10, 3, 1000)
    pairs = _pair_lines(text)
    proper = sum(int(fs[0][1]) & 0x2 > 0 for fs in pairs.values())
    assert proper > 200
    if plant is not None:
        plant(pairs)
    out = judge.judge(codes, g, b"chr1", blocks, [_join(pairs)], True, 10,
                      3, 1000)
    assert out["bad_records"] == (0 if plant is None else proper), \
        out["problems"]
