"""The port's multi-process paths (parallel/distributed.py,
parallel/outmerge.py) against tpumap's: two processes in a gloo group
(each where JAX and tpumap cannot be imported) learn different tables
and must hold tpumap's gathered union, as two jax.distributed processes
running tpumap's worker (tests/test_distributed_twopass.py) do;
tpumap's two-process `gsnap -O` run (tests/test_ordered_merge.py) with
the port's CLI, whose merged file must equal a one-process run's bytes
(the port's and tpumap's) while the other process writes nothing; and
`gsnap --two-pass` in two processes, whose dumped tables must equal a
one-process run's.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

from test_distributed_twopass import WORKER as JAX_WORKER
from torch_workloads import NO_TPUMAP

REPO = pathlib.Path(__file__).resolve().parent.parent

# tpumap's worker with torch.distributed (gloo) in place of
# jax.distributed and the port's modules in place of tpumap's
TORCH_WORKER = NO_TPUMAP + r"""
import json
import numpy as np
import torch.distributed as tdist

addr, nproc, pid, outdir = sys.argv[1:5]
tdist.init_process_group("gloo", init_method=f"tcp://{addr}",
                         world_size=int(nproc), rank=int(pid))

from tpumap_torch.gsnap.knownindels import KnownIndels
from tpumap_torch.gsnap.knownsplicing import KnownSplicing
from tpumap_torch.parallel import distributed as dist

base = 10_000 * (int(pid) + 1)
ks = KnownSplicing.from_junctions(
    np.asarray([base, base + 500], dtype=np.uint64),
    np.asarray([base + 100, base + 700], dtype=np.uint64),
    np.asarray([1, -1], dtype=np.int32))
ki = KnownIndels(np.asarray([base + 5, 77_777], dtype=np.uint64),
                 np.asarray([3, -2], dtype=np.int32),
                 np.asarray([2, 1], dtype=np.int64))
stats = {"mean": 300.0 + 100 * int(pid), "sdev": 10.0, "n": 50.0}

ks2 = dist.allgather_knownsplicing(ks)
ki2 = dist.allgather_knownindels(ki)
st2 = dist.allreduce_insertlengths(stats)

out = {
    "junctions": ks2.junctions.tolist(),
    "anti": ks2.anti_junctions.tolist(),
    "indel_coords": ki2.coords.tolist(),
    "indel_counts": ki2.counts.tolist(),
    "insert_mean": st2["mean"],
    "insert_n": st2["n"],
}
with open(f"{outdir}/p{pid}.json", "w") as f:
    json.dump(out, f)
tdist.destroy_process_group()
"""

# tpumap's -O worker with the port's CLI (on the CPU) in a gloo group
CLI_WORKER = NO_TPUMAP + r"""
import torch.distributed as tdist

addr, nproc, pid, dbdir, reads, outdir = sys.argv[1:7]
tdist.init_process_group("gloo", init_method=f"tcp://{addr}",
                         world_size=int(nproc), rank=int(pid))
from tpumap_torch.cli import gsnap_cli

rc = gsnap_cli.main(["-D", dbdir, "--batch-size", "32", "-O",
                     "--no-sam-headers", "--device", "cpu",
                     "-o", f"{outdir}/p{pid}.sam", reads])
tdist.destroy_process_group()
sys.exit(rc or 0)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(script, args_of, timeout):
    """Two worker processes; each must exit 0."""
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{REPO / 'tests'}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, str(script), *args_of(pid)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for pid in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_two_process_tables_match_tpumap(tmp_path):
    got = {}
    for name, src, addr in (
            ("jax", JAX_WORKER, f"127.0.0.1:{_free_port()}"),
            ("torch", TORCH_WORKER, f"127.0.0.1:{_free_port()}")):
        d = tmp_path / name
        d.mkdir()
        script = d / "worker.py"
        script.write_text(src)
        _run_group(script, lambda pid: [addr, "2", str(pid), str(d)], 300)
        got[name] = [json.loads((d / f"p{pid}.json").read_text())
                     for pid in range(2)]
    assert got["torch"][0] == got["torch"][1]
    assert got["torch"] == got["jax"]
    o = got["torch"][0]
    assert sorted(o["junctions"]) == [[10000, 10100], [20000, 20100]]
    assert o["indel_counts"][o["indel_coords"].index(77777)] == 2
    assert abs(o["insert_mean"] - 350.0) < 1e-6 and o["insert_n"] == 100.0


def test_two_process_ordered_merge(tmp_path):
    from tpumap.cli import gsnap_cli as jgsnap_cli
    from tpumap_torch.cli import gsnap_cli
    from tpumap_torch.index.build import build_db

    rng = np.random.default_rng(17)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 20000))
    (tmp_path / "g.fa").write_text(">chr1\n" + seq + "\n")
    reads = []
    for i in range(101):          # odd count: uneven shards and a tail
        p = int(rng.integers(0, 19000 - 100))
        reads.append(f">r{i:03d}\n{seq[p:p + 100]}\n")
    (tmp_path / "reads.fa").write_text("".join(reads))
    db = build_db(tmp_path / "g.fa", name="om", k=12, interval=3)
    db.save(str(tmp_path / "omdb"))
    common = ["-D", str(tmp_path / "omdb"), "--batch-size", "32",
              "--no-sam-headers"]
    assert not gsnap_cli.main(common + [
        "--device", "cpu", "-o", str(tmp_path / "single.sam"),
        str(tmp_path / "reads.fa")])
    assert not jgsnap_cli.main(common + [
        "-o", str(tmp_path / "tpumap.sam"), str(tmp_path / "reads.fa")])

    script = tmp_path / "worker.py"
    script.write_text(CLI_WORKER)
    addr = f"127.0.0.1:{_free_port()}"
    _run_group(script, lambda pid: [addr, "2", str(pid),
                                    str(tmp_path / "omdb"),
                                    str(tmp_path / "reads.fa"),
                                    str(tmp_path)], 600)
    single = (tmp_path / "single.sam").read_bytes()
    assert single == (tmp_path / "tpumap.sam").read_bytes()
    assert single.count(b"\n") == 101
    assert (tmp_path / "p0.sam").read_bytes() == single
    assert (tmp_path / "p1.sam").read_bytes() == b""


TWOPASS_WORKER = NO_TPUMAP + r"""
import torch.distributed as tdist

addr, nproc, pid, dbdir, reads, outdir = sys.argv[1:7]
tdist.init_process_group("gloo", init_method=f"tcp://{addr}",
                         world_size=int(nproc), rank=int(pid))
from tpumap_torch.cli import gsnap_cli

rc = gsnap_cli.main(["-D", dbdir, "-N", "1", "--two-pass", "--device", "cpu",
                     "--splices-dump", f"{outdir}/s{pid}.txt",
                     "--indels-dump", f"{outdir}/i{pid}.txt",
                     "-o", f"{outdir}/p{pid}.sam", reads])
tdist.destroy_process_group()
sys.exit(rc or 0)
"""


def test_two_process_two_pass_gathers_the_tables(tmp_path):
    """--two-pass in a group of two, no --part: each process learns from
    its half of the reads, and after the gather both dump the tables a
    one-process run learns from all of them."""
    from tpumap_torch.cli import gsnap_cli
    from tpumap_torch.index.build import build_db

    rng = np.random.default_rng(77)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 60000))
    juncs = ((10300, 12000), (30300, 31500))
    for x, y in juncs:
        g[x], g[x + 1], g[y - 2], g[y - 1] = "G", "T", "A", "G"
    seq = "".join(g)
    (tmp_path / "g.fa").write_text(">chr1\n" + seq + "\n")
    reads = []
    for r in range(40):
        a, b = juncs[r % 2]
        split = int(rng.integers(25, 75))
        reads.append(f">r{r:03d}\n{seq[a - split:a]}"
                     f"{seq[b:b + 100 - split]}\n")
    for r in range(20):
        p = int(rng.integers(40000, 59000))
        reads.append(f">u{r:03d}\n{seq[p:p + 100]}\n")
    (tmp_path / "reads.fa").write_text("".join(reads))
    build_db(tmp_path / "g.fa", name="tp", k=12,
             interval=3).save(str(tmp_path / "tpdb"))
    assert not gsnap_cli.main([
        "-D", str(tmp_path / "tpdb"), "-N", "1", "--two-pass", "--device",
        "cpu", "--splices-dump", str(tmp_path / "s.txt"), "--indels-dump",
        str(tmp_path / "i.txt"), "-o", str(tmp_path / "one.sam"),
        str(tmp_path / "reads.fa")])
    script = tmp_path / "worker.py"
    script.write_text(TWOPASS_WORKER)
    addr = f"127.0.0.1:{_free_port()}"
    _run_group(script, lambda pid: [addr, "2", str(pid),
                                    str(tmp_path / "tpdb"),
                                    str(tmp_path / "reads.fa"),
                                    str(tmp_path)], 600)
    assert len(np.load(tmp_path / "s.txt.npz")["junctions"]) == 2
    for kind in ("s", "i"):
        one = np.load(tmp_path / f"{kind}.txt.npz")
        for pid in range(2):
            got = np.load(tmp_path / f"{kind}{pid}.txt.npz")
            assert sorted(got.files) == sorted(one.files)
            for f in one.files:
                np.testing.assert_array_equal(got[f], one[f], err_msg=f)
