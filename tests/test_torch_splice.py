"""The port's RNA path (novel splicing) against tpumap (JAX on CPU).

The same numpy inputs go through tpumap and through the port's plain
versions: the wide extract_packed_window (with its dynamic-slice clamp
and zero extension), the three window scans, the chain DP on
tests/test_pathdp.py's cases, and the fused ladder's result dict with
splicing and salvage on must be exactly equal in values and dtypes;
align_records(novelsplicing=True) must give byte-identical SAM on the
stream workload, also where JAX cannot be imported
(tests/test_torch_splice_worlds.py holds the splice-ends, salvage and
localscan worlds). Every quantity is an integer, so there is no
tolerance.
"""
import dataclasses
import io
import pathlib
import subprocess
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import engine as jengine
from tpumap.gsnap import ladder as jladder
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.io.fasta import Record
from tpumap.ops import localscan as jlocalscan
from tpumap.ops import pathdp as jpathdp
from tpumap.ops import verify as jverify
from tpumap.utils import dna
from tpumap.utils.fetch import device_fetch, widen_ints
from tpumap_torch.cli import gsnap_cli
from tpumap_torch.gsnap import driver, engine, ladder
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import localscan, pathdp, verify
from torch_workloads import (NO_TPUMAP, emit_modes, mixed_workload, sam_text,
                             tie_rows, write_fasta)

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
INVALID = 0xFFFFFFFF
CFG = dict(top_k=4, max_occ=8)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(want, got):
    """tpumap's uint32 arrays against the port's int64 values; every
    other dtype exactly."""
    a = np.asarray(want)
    b = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if a.dtype == np.uint32:
        assert b.dtype == np.int64, b.dtype
        b = b.astype(np.uint32)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def genome():
    """A random packed genome of 5,000 words plus tpumap's zero pad, as
    uint32 (tpumap) and int32 bit patterns (the port)."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    g = np.concatenate([words, np.zeros(4352, np.uint32)])
    return g, t(g.view(np.int32)), 5000 * 16


@pytest.mark.parametrize("nwords", [16, 4098, 4400])
def test_wide_extract_packed_window(genome, nwords):
    """The dynamic-slice path: in-genome starts, starts whose window
    passes the padded end (clamped back by dynamic_slice), and windows
    wider than SAFE_PAD_WORDS (zero-extended)."""
    g, gt, glen = genome
    rng = np.random.default_rng(nwords)
    starts = np.concatenate([
        rng.integers(0, glen, 6), [0, 15, 17, glen - 5, glen + 100,
                                   (len(g) - 3) * 16 + 7, 2 ** 32 - 1]]
    ).astype(np.uint32)
    want = jverify.extract_packed_window(jnp.asarray(g), jnp.asarray(starts),
                                         nwords)
    got = verify.extract_packed_window(gt, t(starts.astype(np.int64)),
                                       nwords)
    same(want, got)


def scan_inputs(genome, R=24, F=16):
    """Window starts (some past the genome end, clamped), fragments cut
    from the genome inside each window (some mutated), lengths with
    zeros."""
    g, _gt, glen = genome
    rng = np.random.default_rng(R + F)
    ws = rng.integers(0, glen, R).astype(np.uint32)
    ws[:3] = [glen - 100, glen + 5000, 2 ** 32 - 40]
    codes = ((g[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
             ).astype(np.uint8).reshape(-1)
    frag = np.zeros((R, F), np.uint8)
    for r in range(R):
        p = min(int(ws[r]) + int(rng.integers(0, 60000)), glen - F)
        frag[r] = codes[p:p + F]
        if r % 3 == 1:
            frag[r, rng.integers(0, F)] ^= 1
    flen = rng.integers(0, F + 1, R).astype(np.int32)
    flen[3:6] = 0
    return ws, frag, flen


@pytest.mark.parametrize("which", ["fragment", "exact", "runs_suffix",
                                   "runs_prefix"])
def test_window_scans(genome, which):
    g, gt, _glen = genome
    W = 65536
    F = 10 if which == "exact" else 16
    ws, frag, flen = scan_inputs(genome, F=F)
    jg = jnp.asarray(g)
    if which == "fragment":
        want = jlocalscan.scan_fragment(jg, jnp.asarray(ws), jnp.asarray(frag),
                                        jnp.asarray(flen), W, F, 4)
        got = localscan.scan_fragment(gt, t(ws.astype(np.int64)), t(frag),
                                      t(flen), W, F, 4)
    elif which == "exact":
        # a pattern repeated at several offsets: counts above 1
        frag[6:9] = frag[6]
        ws[6:9] = ws[6]
        want = jlocalscan.scan_exact_sites(jg, jnp.asarray(ws),
                                           jnp.asarray(frag),
                                           jnp.asarray(flen), W, F, 8)
        got = localscan.scan_exact_sites(gt, t(ws.astype(np.int64)),
                                         t(frag), t(flen), W, F, 8)
        assert np.asarray(want[1])[3:6].tolist() == [0, 0, 0]
        assert np.asarray(want[1]).max() >= 1
    else:
        suffix = which == "runs_suffix"
        want = jlocalscan.scan_fragment_runs(jg, jnp.asarray(ws),
                                             jnp.asarray(frag), W, 8, suffix)
        got = localscan.scan_fragment_runs(gt, t(ws.astype(np.int64)),
                                           t(frag), W, 8, suffix)
    for a, b in zip(want, got):
        same(a, b)


# ---------------------------------------------------------------- chain DP

@pytest.fixture(scope="module")
def chain_world(tmp_path_factory):
    """tests/test_pathdp.py's genome (two GT..AG introns) and its cases,
    solved by both packages in one batch, with and without qualities;
    plus tie-heavy rows (torch_workloads.tie_rows) on 1,000 bases of ACGT
    repeated appended to the genome."""
    d = tmp_path_factory.mktemp("tchain")
    rng = np.random.default_rng(7)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 8000))
    seq = (seq[:2000] + "GT" + seq[2002:2298] + "AG"
           + seq[2300:3000] + "GT" + seq[3002:3498] + "AG" + seq[3500:])
    db = build_db(write_fasta(d / "g.fa", seq + "ACGT" * 250), name="g",
                  k=12, interval=3)
    ins = "C" if seq[740] != "C" else "G"
    ins2 = "A" if seq[2330] != "A" else "T"
    tail = "".join("ACGT"[i] for i in np.random.default_rng(3).integers(
        0, 4, 20))
    cases = {
        "one_intron": (seq[1960:2000] + seq[2300:2360], [1960, 2260]),
        "two_introns": (seq[1970:2000] + seq[2960:3000] + seq[3500:3550],
                        [1970, 2930, 3430]),
        "deletion": (seq[975:1000] + seq[1005:1030], [975, 980]),
        "soft_clip_tail": (seq[600:680] + tail, [600]),
        "middle_insertion": (seq[700:740] + ins * 2 + seq[740:790],
                             [700, 698]),
        "intron_plus_insertion": (seq[1960:2000] + seq[2300:2330] + ins2 * 2
                                  + seq[2330:2380], [1960, 2260, 2258]),
    }
    rows = []
    for name, (read, ds) in cases.items():
        rows.append((name, dna.encode(read)[0], ds))
    # the random oracle cases of test_chain_random_vs_oracle
    rng = np.random.default_rng(11)
    for k in range(24):
        L = int(rng.integers(40, 90))
        start = int(rng.integers(100, 7000))
        read = list(seq[start:start + L])
        for _ in range(int(rng.integers(0, 6))):
            read[int(rng.integers(0, L))] = "ACGT"[rng.integers(0, 4)]
        ds = [start] + [int(rng.integers(100, 7000))
                        for _ in range(int(rng.integers(1, 5)) - 1)]
        rows.append((f"random{k}", dna.encode("".join(read))[0],
                     list(dict.fromkeys(ds))))
    tcodes, tlens, tdiags = tie_rows(np.random.default_rng(13),
                                     8000 + 4 * np.arange(2, 50, 6), 8, 128)
    for i in range(len(tlens)):
        rows.append((f"ties{i}", tcodes[i, :tlens[i]], tdiags[i].tolist()))
    # quality weighting: sparse low-quality tail mismatches
    c = dna.encode(seq[700:780])[0].copy()
    c[np.arange(70, 78, 3)] ^= 1
    rows.append(("quality", c, [700]))
    rows.append(("no_candidate", dna.encode(seq[100:180])[0], []))
    R, L, K = len(rows), 128, 8
    codes = np.zeros((R, L), np.uint8)
    lengths = np.zeros(R, np.int32)
    diags = np.full((R, K), INVALID, np.uint32)
    for i, (_n, c, ds) in enumerate(rows):
        codes[i, :len(c)] = c
        lengths[i] = len(c)
        diags[i, :len(ds)] = ds
    nmask = np.zeros((R, L), bool)
    nmask[5, 10] = True
    quals = np.full((R, L), 30, np.uint8)
    quals[-2, np.arange(70, 78, 3)] = 2
    quals[7, :40] = rng.integers(0, 41, 40)
    ji, ti = JaxIndex.from_host(db), DeviceIndex.from_host(db, "cpu")
    out = {}
    for with_quals in (False, True):
        q = quals if with_quals else None
        want = jpathdp.chain_solve(
            ji, jnp.asarray(codes), jnp.asarray(nmask), jnp.asarray(lengths),
            jnp.asarray(diags), scoring=jpathdp.PathScoring(),
            with_quals=with_quals,
            quals=jnp.asarray(quals) if with_quals else None)
        got = pathdp.chain_solve(
            ti, t(codes), t(nmask), t(lengths), t(diags.astype(np.int64)),
            scoring=pathdp.PathScoring(), with_quals=with_quals,
            quals=t(q) if with_quals else None)
        out[with_quals] = ({k: np.asarray(v) for k, v in want.items()}, got)
    return [r[0] for r in rows], out


CHAIN_CASES = ["one_intron", "two_introns", "deletion", "soft_clip_tail",
               "middle_insertion", "intron_plus_insertion", "random",
               "quality", "no_candidate", "ties"]


@pytest.mark.parametrize("with_quals", [False, True])
@pytest.mark.parametrize("case", CHAIN_CASES)
def test_chain_solve_matches(chain_world, case, with_quals):
    names, out = chain_world
    want, got = out[with_quals]
    rows = [i for i, n in enumerate(names) if n.startswith(case)]
    assert sorted(want) == sorted(got)
    for key in want:
        same(want[key][rows], got[key][rows])
    if case == "two_introns":
        assert want["nsegs"][rows[0]] == 3
    if case == "quality":       # the low-quality tail is kept with quals
        assert want["q_end"][rows[0]] == (80 if with_quals else 70)
    if case == "ties":          # switch junctions, and more than S segments
        assert (want["nsegs"][rows] >= 2).all()
        assert (want["nsegs"][rows] > 8).any()


def test_path_scoring_fields_match():
    a = [(f.name, f.default) for f in dataclasses.fields(
        jpathdp.PathScoring)]
    b = [(f.name, f.default) for f in dataclasses.fields(pathdp.PathScoring)]
    assert a == b


# ------------------------------------------------------- ladder and SAM

@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The stream workload and tpumap's SAM for it (batches of 32)."""
    db, reads, _gfa = mixed_workload(tmp_path_factory.mktemp("tsplice"))
    ji = JaxIndex.from_host(db)
    want = sam_text(jdriver.align_records(
        db, ji, reads, jengine.AlignConfig(**CFG), novelsplicing=True,
        batch_size=32))
    return db, ji, DeviceIndex.from_host(db, "cpu"), reads, want


def test_align_batch_full_splicing_dict_matches(mixed):
    """Every cascade, ch_*, amb_*, in_* and sec_* key of the fused
    ladder with splicing and salvage on, on the workload's spliced,
    indel, unmapped and N reads (align_records' batch shape)."""
    db, ji, ti, reads, _want = mixed
    B, L = 32, 128
    batch = jdriver.make_batch(reads[40:72], B, L)
    args = (L, None, True, True, B, B, B)
    want = widen_ints(device_fetch(jladder.align_batch_full(
        ji, jdriver._pack_batch(batch), jengine.AlignConfig(**CFG),
        *[jpathdp.PathScoring() if a is None else a for a in args])))
    got = ladder.fetch_result(ladder.align_batch_full(
        ti, driver._to_device(batch, "cpu"), engine.AlignConfig(**CFG),
        *[pathdp.PathScoring() if a is None else a for a in args]))
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(want[key]), np.asarray(got[key])
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert want["ch_sel"].any() and (want["ch_nsegs"] >= 2).any()
    assert "amb_pos" in want


def port_sam(db, ti, reads, sink, **kw):
    cfg = engine.AlignConfig(**CFG)
    if not sink:
        return sam_text(driver.align_records(db, ti, reads, cfg, **kw))
    chunks = []
    assert driver.align_records(db, ti, reads, cfg, sink=chunks.append,
                                **kw) == []
    return b"".join(bytes(c) for c in chunks)


@pytest.mark.parametrize("sink", [False, True])
def test_stream_workload_novelsplicing_sam(mixed, sink):
    db, _ji, ti, reads, want = mixed
    stats = {}
    got = port_sam(db, ti, reads, sink, novelsplicing=True, batch_size=32,
                   stats=stats)
    assert got == want
    assert sum(stats.get(m, 0) for m in driver.METHODS) == len(reads) \
        and stats["splice"] > 0 and stats["reads"] == len(reads)


def test_list_and_stream_mode_emit_alike_with_paths(mixed):
    """With novel splicing the one C call also writes the chain's path
    rows (spliced and deletion CIGARs): list mode's records are the
    stream mode's bytes, row for row."""
    db, _ji, ti, reads, _want = mixed
    kinds = emit_modes(db, ti, reads, engine.AlignConfig(**CFG),
                       novelsplicing=True, batch_size=32)
    assert set(kinds) == {"unmapped", "ungapped", "path"}


def test_rna_path_runs_without_jax(mixed, tmp_path):
    """The port's RNA path in a process where neither JAX nor
    tpumap can be imported gives tpumap's SAM."""
    want = mixed[4]
    script = NO_TPUMAP + f"""
import pathlib
sys.path[:0] = [{str(REPO)!r}, {str(REPO / "tests")!r}]
import torch
torch.set_num_threads(1)
from torch_workloads import mixed_workload
from tpumap_torch.gsnap.driver import align_records
from tpumap_torch.gsnap.engine import AlignConfig
from tpumap_torch.index.device import DeviceIndex
db, reads, _ = mixed_workload(pathlib.Path({str(tmp_path)!r}), port=True)
align_records(db, DeviceIndex.from_host(db, "cpu"), reads,
              AlignConfig(top_k=4, max_occ=8), novelsplicing=True,
              batch_size=32, sink=sys.stdout.buffer.write)
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.split(".")[0] == "tpumap"]
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert r.stdout == want


def test_main_on_cpu_and_no_silent_fallback(mixed, tmp_path, monkeypatch):
    """gsnap_cli.main runs on the CPU only when asked (--device cpu),
    and refuses the default cuda device where there is none."""
    db, _ji, ti, reads, _want = mixed
    db.save(str(tmp_path / "db"))
    rfa = tmp_path / "reads.fa"
    rfa.write_text("".join(f">{r.accession}\n{r.sequence}\n" for r in reads))
    argv = ["-D", str(tmp_path / "db"), str(rfa), "--device", "cpu",
            "--batch-size", "32", "-N", "1", "--max-intron", "200000",
            "-n", "1"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        gsnap_cli.main(argv)
    body = [ln for ln in buf.getvalue().splitlines()
            if not ln.startswith("@")]
    want = sam_text(driver.align_records(
        db, ti, [Record(r.accession, "", r.sequence) for r in reads],
        novelsplicing=True, batch_size=32)).decode().splitlines()
    assert body == want and any("N" in ln.split("\t")[5] for ln in body)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        gsnap_cli.main(argv[:3])
