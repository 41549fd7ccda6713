"""The port's chain DP on long rows against tpumap (JAX on CPU).

K5 keeps a row's choice table in shared memory up to
pathdp.chain_max_len(K) steps (7,194 at 14 or 16 lanes) and in a global
scratch past that; its plain version, which the card tests hold it to,
takes any length. Here the plain version meets tpumap's chain_solve on
the same numpy inputs at K = 14 lanes and L = 7,680 steps (the bucket of
a 7,169-base read): a spliced read, an unspliced one with mismatches, one
with a deletion and one with an insertion, each against partner and
random diagonals and INVALID lanes. Every quantity is an integer, so
values and dtypes must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.ops import pathdp as jpathdp
from tpumap.utils import dna
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import pathdp
from torch_workloads import write_fasta

torch.set_num_threads(1)
INVALID = 0xFFFFFFFF
K, L = 14, 7680
GLEN = 40_000
DONOR, ACCEPTOR = 12_000, 13_500      # a GT..AG intron of 1,500 bp


@pytest.fixture(scope="module")
def long_rows(tmp_path_factory):
    d = tmp_path_factory.mktemp("longchain")
    rng = np.random.default_rng(7169)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, GLEN))
    seq = (seq[:DONOR] + "GT" + seq[DONOR + 2:ACCEPTOR - 2] + "AG"
           + seq[ACCEPTOR:])
    db = build_db(write_fasta(d / "g.fa", seq), name="g", k=12, interval=3)
    a = DONOR - 3000
    reads = [
        # spliced: 3,000 bases before the donor, 4,169 after the acceptor
        (seq[a:DONOR] + seq[ACCEPTOR:ACCEPTOR + 4169],
         [a, a + (ACCEPTOR - DONOR)]),
        # unspliced, the full 7,680 steps, with substitutions below
        (seq[20_000:20_000 + L], [20_000]),
        # a 5-bp deletion after 3,000 bases
        (seq[25_000:28_000] + seq[28_005:32_200], [25_000, 25_005]),
        # a 3-bp insertion after 2,000 bases
        (seq[1000:3000] + "ACG" + seq[3000:8000], [1000, 997]),
    ]
    R = len(reads)
    codes = np.zeros((R, L), np.uint8)
    lengths = np.zeros(R, np.int32)
    diags = np.full((R, K), INVALID, np.int64)
    for i, (read, ds) in enumerate(reads):
        c = dna.encode(read)[0]
        codes[i, :len(c)] = c
        lengths[i] = len(c)
        diags[i, :len(ds)] = ds
        # partner diagonals, random ones and INVALID lanes
        diags[i, 4:8] = np.asarray(ds[0]) + [300, -2, 8, 20_000]
        diags[i, 8:12] = rng.integers(0, GLEN - L, 4)
    sub = rng.random((R, L)) < 0.004
    codes[sub] = (codes[sub] + 1) % 4
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    nmask = np.zeros((R, L), bool)
    want = jpathdp.chain_solve(
        JaxIndex.from_host(db), jnp.asarray(codes), jnp.asarray(nmask),
        jnp.asarray(lengths), jnp.asarray(diags.astype(np.uint32)),
        scoring=jpathdp.PathScoring())
    lt = torch.from_numpy(lengths)
    inp = pathdp.chain_inputs(
        DeviceIndex.from_host(db, "cpu"), torch.from_numpy(codes),
        torch.from_numpy(nmask), lt, torch.from_numpy(diags),
        pathdp.PathScoring())
    assert tuple(inp["s"].shape) == (R, K, L)
    assert L > pathdp.chain_max_len(K)
    got = pathdp.chain_dp_plain(inp, lt, pathdp.PathScoring())
    return {k: np.asarray(v) for k, v in want.items()}, got, reads


@pytest.mark.parametrize("row", range(4))
def test_long_rows_plain_match_tpumap(long_rows, row):
    want, got, reads = long_rows
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = want[key][row], got[key][row].numpy()
        if a.dtype == np.uint32:
            assert b.dtype == np.int64, (key, b.dtype)
            b = b.astype(np.uint32)
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=key)
    # the spliced, deletion and insertion rows start on their first
    # diagonal and reach their second (mismatch clusters may add detours)
    ds = reads[row][1]
    if len(ds) == 2:
        n = int(want["nsegs"][row])
        assert n >= 2
        assert int(want["seg_diag"][row][0]) == ds[0]
        assert ds[1] in [int(x) for x in want["seg_diag"][row][:n]]
