"""A whole run but the look for a card, on the CPU at a test's size
(tests/tiny.py), with the timed path broken underneath: `correct` must
come out false for each fault a cell can have (half of a batch's reads
left out; an answer altered where it is produced), and true without."""
import pathlib

import pytest
import torch

from harness import runner
from tests.tiny import tiny_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _drop_half(b: bytes) -> bytes:
    lines = b.split(b"\n")
    return b"\n".join(x for i, x in enumerate(lines)
                      if i % 2 == 0 or not x)


def _move_one_base(b: bytes) -> bytes:
    out = []
    for line in b.split(b"\n"):
        f = line.split(b"\t")
        if len(f) > 3 and f[3] not in (b"0", b"1"):
            f[3] = b"%d" % (int(f[3]) + 1)
        out.append(b"\t".join(f))
    return b"\n".join(out)


def _one_base_changed(b: bytes) -> bytes:
    """A base of every read's SEQ changed, as if the emitter lost it."""
    out = []
    for line in b.split(b"\n"):
        f = line.split(b"\t")
        if len(f) > 9 and len(f[9]) > 50:
            s = bytearray(f[9])
            s[50] = ord("A") if s[50] != ord("A") else ord("C")
            f[9] = bytes(s)
        out.append(b"\t".join(f))
    return b"\n".join(out)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("faults")


@pytest.mark.parametrize("cell", ["dna_se100"])
@pytest.mark.parametrize("fault,correct", [
    (None, True), (_drop_half, False), (_move_one_base, False),
    (_one_base_changed, False)])
def test_fault_makes_the_run_incorrect(tmp, cell, fault, correct):
    c = tiny_cell(tmp, cell)
    res, checks = runner.run(ROOT, c, 2**31 + 101, 0.5, False,
                             torch.device("cpu"), lambda m: None,
                             sink_fault=fault)
    assert res["correct"] is correct, checks
    assert list(res["checks"]) == ["bad_records", "worse_share"]
    assert list(res)[-1] == "checks"
