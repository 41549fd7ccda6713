"""Plain versions of K3, K6a and K6b against tpumap (JAX on CPU) at the
kernels' edges.

K3 (`dp.traceback_plain`, with its run-length encoding) against
`tpumap.ops.dp.traceback` plus the ladder's runs
(`tpumap/gsnap/ladder.py:505-523`): direction tables past one row tile
(Lq = 512), rows with qlens 0 and Lq, end lanes 0 and W - 1, and
transcripts of more than 12 runs. K6a (`localscan.scan_fragment_plain`)
against `tpumap.ops.localscan.scan_fragment`: a batch whose fragment
lengths are all 0, all-A fragments over a poly-A stretch (thousands of
offsets score 0), and top_k 1 and 8. K6b
(`localscan.scan_exact_sites_plain`) against
`tpumap.ops.localscan.scan_exact_sites`: fragments of 3-10 bases (the
lengths the splice-end review sends), all-A fragments over the poly-A
stretch (thousands of hits a row), windows of 1,000 and 1,031 bases
(not a multiple of 16), top_k 1 and 8, rows with fewer hits than top_k,
a batch whose lengths are all 0, and windows clamped at the genome's
end. Every quantity is an integer, so there is no tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import ladder_runs_numpy, same
from tpumap.ops import dp as jdp
from tpumap.ops import localscan as jlocalscan
from tpumap_torch.ops import dp, localscan, verify
from tpumap_torch.ops.u32 import INVALID

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def dp_dirs(rng, R, Lq, band):
    """Direction tables of the plain banded DP over reads with an indel
    every 64 bases (deletions and insertions of 3 in turn)."""
    Lg = Lq + band + 4
    g = rng.integers(0, 4, (R, Lg)).astype(np.uint8)
    q = g[:, 4:4 + Lq].copy()
    for r in range(R):
        for m, p in enumerate(range(32, Lq - 32, 64)):
            if (r + m) % 2:
                q[r, p:] = np.concatenate([q[r, p + 3:], q[r, :3]])
            else:
                q[r, p + 3:] = q[r, p:Lq - 3].copy()
    mut = rng.random((R, Lq)) < 0.03
    q[mut] = rng.integers(0, 4, int(mut.sum()))
    out = dp.banded_align_plain(t(q), torch.full((R,), Lq, dtype=torch.int32),
                                t(g), torch.full((R,), Lg, dtype=torch.int32),
                                band)
    return out["dirs"].numpy(), out["end_k"].numpy()


@pytest.mark.parametrize("Lq,band,dirs_from", [
    (512, 32, "dp"), (200, 8, "dp"), (130, 16, "random"), (37, 1, "random"),
])
def test_traceback_edges_match_tpumap(Lq, band, dirs_from):
    rng = np.random.default_rng(Lq + band)
    R = 10
    W = 2 * band + 1
    if dirs_from == "dp":
        dirs, end_k = dp_dirs(rng, R, Lq, band)
    else:        # any bytes: long DEL walks, many runs, k out of range
        dirs = rng.integers(0, 32, (R, Lq, W)).astype(np.uint8)
        end_k = rng.integers(0, W, R).astype(np.int32)
    qlens = rng.integers(Lq // 2, Lq + 1, R).astype(np.int32)
    qlens[:2] = [0, Lq]
    end_k[2:4] = [0, W - 1]
    jops, jk = jdp.traceback(jnp.asarray(dirs), jnp.asarray(qlens),
                             jnp.asarray(end_k), band)
    ops, k_final, run_op, run_len, nruns = dp.traceback_plain(
        t(dirs), t(qlens), t(end_k), band)
    same(jops, ops)
    same(jk, k_final)
    wop, wlen, wn = ladder_runs_numpy(np.asarray(jops))
    np.testing.assert_array_equal(wop, run_op.numpy())
    np.testing.assert_array_equal(wlen, run_len.numpy().view(np.uint16))
    np.testing.assert_array_equal(wn, nruns.numpy())
    assert nruns[0] == 0 and (ops[0] == dp.T_END).all()
    if Lq >= 512 or dirs_from == "random":
        assert int(nruns.max()) > dp.MAXRUNS


@pytest.fixture(scope="module")
def poly_a_genome():
    """6,000 random packed words with a poly-A stretch at words
    1,000-1,399 (bases 16,000-22,399), plus tpumap's zero pad; uint32
    (tpumap) and int32 bit patterns (the port)."""
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2 ** 32, 6000, dtype=np.uint64).astype(np.uint32)
    words[1000:1400] = 0
    g = np.concatenate([words, np.zeros(4352, np.uint32)])
    return g, t(g.view(np.int32)), 6000 * 16


@pytest.mark.parametrize("case,top_k", [
    ("no_lengths", 4), ("poly_a", 4), ("poly_a", 8), ("random", 1),
    ("random", 8),
])
def test_scan_fragment_edges_match_tpumap(poly_a_genome, case, top_k):
    g, gt, glen = poly_a_genome
    rng = np.random.default_rng(top_k)
    R, F, W = 12, 16, 65536
    ws = rng.integers(0, glen, R).astype(np.int64)
    ws[:2] = [glen - 100, 2 ** 32 - 40]
    at = np.minimum(ws + rng.integers(0, W, R), glen - F)
    frag = verify.extract_codes_window(gt, t(at), F).numpy()
    flen = rng.integers(1, F + 1, R).astype(np.int32)
    if case == "no_lengths":
        flen[:] = 0
    elif case == "poly_a":
        ws[2:8] = 16_000 - rng.integers(0, 400, 6)
        frag[2:8] = 0
        flen[2:8] = F
    want = jlocalscan.scan_fragment(jnp.asarray(g),
                                    jnp.asarray(ws.astype(np.uint32)),
                                    jnp.asarray(frag), jnp.asarray(flen), W,
                                    F, top_k)
    got = localscan.scan_fragment_plain(gt, t(ws), t(frag), t(flen), W, F,
                                        top_k)
    for a, b in zip(want, got):
        same(a, b)
    if case == "no_lengths":     # offsets 0 .. top_k - 1, count 0
        assert (got[1] == 0).all()
        assert torch.equal(got[0], (t(ws)[:, None]
                                    + torch.arange(top_k)) & 0xFFFFFFFF)
    elif case == "poly_a":
        assert (got[1][2:8] == 0).all()


@pytest.mark.parametrize("case,window,top_k", [
    ("path", 65536, 8), ("path", 65536, 1), ("poly_a", 65536, 8),
    ("poly_a", 65536, 1), ("path", 1000, 8), ("path", 1031, 1),
    ("no_lengths", 65536, 8),
])
def test_scan_exact_sites_edges_match_tpumap(poly_a_genome, case, window,
                                             top_k):
    g, gt, glen = poly_a_genome
    rng = np.random.default_rng(window + top_k)
    R, F = 12, 10
    ws = rng.integers(0, glen, R).astype(np.int64)
    ws[:2] = [glen - 100, 2 ** 32 - 40]          # clamped at the end
    at = np.minimum(ws + rng.integers(0, window, R), glen - F)
    frag = verify.extract_codes_window(gt, t(at), F).numpy()
    flen = rng.integers(3, F + 1, R).astype(np.int32)
    flen[2:4] = [3, F]
    if case == "no_lengths":
        flen[:] = 0
    elif case == "poly_a":
        ws[2:8] = 16_000 - rng.integers(0, 400, 6)
        frag[2:8] = 0
        flen[2:8] = F
    want = jlocalscan.scan_exact_sites(jnp.asarray(g),
                                       jnp.asarray(ws.astype(np.uint32)),
                                       jnp.asarray(frag), jnp.asarray(flen),
                                       window, F, top_k)
    got = localscan.scan_exact_sites_plain(gt, t(ws), t(frag), t(flen),
                                           window, F, top_k)
    for a, b in zip(want, got):
        same(a, b)
    pos, count = got
    if case == "no_lengths":
        assert (count == 0).all() and (pos == INVALID).all()
    elif case == "poly_a":
        # every offset of the stretch hits: thousands a row
        assert (count[2:8] > 1000).all()
    else:
        assert ((count > 0) & (count < top_k)).any() or top_k == 1
        assert (count[(pos[:, -1] == INVALID)] < top_k).all()
