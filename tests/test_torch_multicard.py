"""The port on several distinct devices, on the CPU: which card a process
of a torch.distributed group takes (parallel/distributed.process_device
and the CLIs' --device), the order in which the per-device loops issue
their work (every device's chunk is called before the loop reads a
result), the grids of distinct devices against the same grid on one
device, and the int32 refusal of indexes past 2^31 positions beside
tpumap's int32 cast that reads the table's first position there.

Distinct devices are `cpu:0` .. `cpu:3`: torch keys them apart, and they
run the plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumap_torch.cli import gmap_cli, gsnap_cli
from tpumap_torch.gsnap.driver import align_records, make_batch
from tpumap_torch.gsnap.engine import AlignConfig
from tpumap_torch.index.build import build_db
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import pathdp
from tpumap_torch.parallel import (distributed, large, mesh, pipeline,
                                   sharded)
from torch_workloads import mixed_workload, sam_text

DISTINCT = [torch.device("cpu", i) for i in range(4)]
SHARED = [torch.device("cpu")] * 4


# ------------------------------------------------- which card a process takes

@pytest.fixture
def cards(monkeypatch):
    """A group of `nprocs` processes on a machine with `n` cards: set the
    returned dict's nprocs, rank and n; set_device calls are recorded."""
    state = {"nprocs": 1, "rank": 0, "n": 4, "set": []}
    monkeypatch.setattr(distributed, "nprocs", lambda: state["nprocs"])
    monkeypatch.setattr(distributed, "rank", lambda: state["rank"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: state["n"])
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: state["set"].append(torch.device(d)))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    return state


def test_local_rank_picks_the_card(cards, monkeypatch):
    cards.update(nprocs=4, rank=3)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.process_device("cuda") == torch.device("cuda", 1)
    assert cards["set"] == [torch.device("cuda", 1)]


@pytest.mark.parametrize("rank,n,card", [(0, 4, 0), (1, 4, 1), (5, 4, 1),
                                         (3, 2, 1), (1, 1, 0)])
def test_rank_modulo_cards_without_local_rank(cards, rank, n, card):
    cards.update(nprocs=8, rank=rank, n=n)
    assert distributed.process_device("cuda") == torch.device("cuda", card)
    assert cards["set"] == [torch.device("cuda", card)]


@pytest.mark.parametrize("asked,want", [("cuda:2", torch.device("cuda", 2)),
                                        ("cpu", torch.device("cpu"))])
def test_an_explicit_device_wins(cards, monkeypatch, asked, want):
    cards.update(nprocs=2, rank=1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.process_device(asked) == want
    assert cards["set"] == ([want] if want.type == "cuda" else [])


@pytest.mark.parametrize("local,asked", [("4", "cuda"), (None, "cuda:7")])
def test_a_missing_card_raises(cards, monkeypatch, local, asked):
    cards.update(nprocs=2, rank=1)
    if local is not None:
        monkeypatch.setenv("LOCAL_RANK", local)
    with pytest.raises(RuntimeError, match="does not exist"):
        distributed.process_device(asked)
    assert cards["set"] == []


@pytest.mark.parametrize("asked", ["cuda", "cuda:3", "cpu"])
def test_no_group_changes_nothing(cards, monkeypatch, asked):
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert distributed.process_device(asked) == torch.device(asked)
    assert cards["set"] == []


class _Placed(Exception):
    """Stops a CLI where it places the index."""


@pytest.mark.parametrize("cli", ["gsnap", "gmap"])
@pytest.mark.parametrize("nprocs,argv,want", [
    (2, [], torch.device("cuda", 1)),
    (2, ["--device", "cuda:0"], torch.device("cuda", 0)),
    (2, ["--device", "cpu"], torch.device("cpu")),
    (1, [], torch.device("cuda"))])
def test_cli_places_the_index_on_the_process_card(cards, monkeypatch,
                                                   tmp_path, cli, nprocs,
                                                   argv, want):
    """gsnap's and gmap's main: the index goes to the card process_device
    gives rank 1 of a two-process group, made current first."""
    mod = {"gsnap": gsnap_cli, "gmap": gmap_cli}[cli]
    cards.update(nprocs=nprocs, rank=1)

    class StubDB:
        k = 15

    def placed(db, device):
        raise _Placed(torch.device(device), list(cards["set"]))
    monkeypatch.setattr(mod.GenomeDB, "load", lambda path: StubDB())
    monkeypatch.setattr(mod.DeviceIndex, "from_host", placed)
    reads = tmp_path / "r.fa"
    reads.write_text(">r\nACGT\n")
    with pytest.raises(_Placed) as got:
        mod.main(["-D", str(tmp_path), *argv, str(reads)])
    device, current = got.value.args
    assert device == want
    assert current == ([want] if want.index is not None and nprocs > 1
                       else [])


# ------------------------------------- the order of the per-device loops

def test_row_split_calls_every_chunk_before_a_read(monkeypatch):
    """RowSplit.map over four distinct devices calls each chunk once, in
    the grid's order, with its device's index, and reads no result
    before every chunk has been called; the result rows come back in
    order."""
    order = []
    cat = pipeline._cat

    def logged_cat(parts, device):
        order.append(("read", None))
        return cat(parts, device)
    monkeypatch.setattr(pipeline, "_cat", logged_cat)

    def fn(ix, rows):
        order.append(("call", ix))
        return rows * 2 + int(rows[0])          # a host read in the chunk
    rs = pipeline.RowSplit(DISTINCT, {d: d.index for d in DISTINCT})
    got = rs.map(fn, torch.arange(8))
    assert order == [("call", i) for i in range(4)] + [("read", None)]
    assert torch.equal(got, torch.tensor([0, 2, 6, 8, 12, 14, 18, 20]))
    assert rs.split == 1 and rs.whole == 0


def test_row_split_repeated_devices_run_in_grid_order():
    """A grid whose devices repeat calls its chunks in the grid's order,
    each with the index of its own device."""
    devs = [DISTINCT[0], DISTINCT[1], DISTINCT[0], DISTINCT[1]]
    seen = []

    def fn(ix, rows):
        seen.append((ix, int(rows[0])))
        return rows + 1
    rs = pipeline.RowSplit(devs, {d: d.index for d in DISTINCT})
    got = rs.map(fn, torch.arange(8))
    assert seen == [(d.index, 2 * i) for i, d in enumerate(devs)]
    assert torch.equal(got, torch.arange(1, 9))


class _Logged(dict):
    """A dict result that logs each read of a value."""

    def __init__(self, order, **kw):
        super().__init__(**kw)
        self.order = order

    def __getitem__(self, key):
        self.order.append(("read", key))
        return super().__getitem__(key)


def test_run_data_shards_calls_every_shard_before_a_read():
    """_run_data_shards over a 4 x 1 grid of distinct devices calls every
    data shard's body, in order on its row's devices, before it reads
    any shard's result; the shards' rows come back in order."""
    grid = mesh.make_mesh(4, devices=DISTINCT)
    order = []

    def body(i, row_devs, b):
        assert row_devs == [DISTINCT[i]]
        order.append(("call", i))
        return _Logged(order, x=b["x"] + int(b["x"][0]))
    got = sharded._run_data_shards(grid, {"x": torch.arange(8)}, body)
    first_read = next(j for j, o in enumerate(order) if o[0] == "read")
    assert order[:first_read] == [("call", i) for i in range(4)]
    assert torch.equal(got["x"], torch.tensor([0, 1, 4, 5, 8, 9, 12, 13]))


# --------------------- grids of distinct devices against one device's grid

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return mixed_workload(tmp_path_factory.mktemp("multicard"), port=True)


@pytest.mark.parametrize("novel", [False, True])
def test_mesh_context_on_four_distinct_devices(world, novel):
    """align_records through a MeshContext of data axis 4 on distinct
    devices writes the single-device run's SAM, every stage split."""
    db, reads, _gfa = world
    cfg = AlignConfig(top_k=4, max_occ=8)
    want = sam_text(align_records(db, DeviceIndex.from_host(db, "cpu"),
                                  reads, cfg, batch_size=32,
                                  novelsplicing=novel))
    ctx = pipeline.MeshContext(mesh.make_mesh(devices=DISTINCT), db)
    assert list(ctx.indexes) == DISTINCT
    got = sam_text(align_records(db, ctx.index, reads, cfg, batch_size=32,
                                 novelsplicing=novel, device_ctx=ctx))
    assert got == want
    assert ctx.rows.split > 0


@pytest.mark.parametrize("shape,full", [((1, 4), False), ((2, 2), True)])
def test_sharded_on_distinct_devices(world, shape, full):
    """The oligo-sharded aligners at 1 x 4 and 2 x 2 (the full ladder, with
    pairs) on distinct devices give the one-device grid's arrays."""
    db, reads, _gfa = world
    cfg = AlignConfig(top_k=4, max_occ=8)
    make = (sharded.make_sharded_full_aligner if full
            else sharded.make_sharded_aligner)
    kw = dict(scoring=pathdp.PathScoring(max_intron=5000), salvage=True,
              paired=True, pairmax=1000) if full else {}
    b = make_batch(reads[:64], 64, 128)
    batch = {k: b[k] for k in ("codes", "nmask", "lengths")}
    out = []
    for devices in (SHARED, DISTINCT):
        arrays, align = make(mesh.make_mesh(4, index_shards=shape[1],
                                            devices=devices), db, cfg, **kw)
        out.append(align(arrays, batch))
    assert sorted(out[0]) == sorted(out[1])
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


def test_genome_windows_on_distinct_devices(world):
    """Four genome windows of a uint64 build on four distinct devices: the
    one-device grid's results and the same uint64 univcoords."""
    db, reads, gfa = world
    dbl = build_db(gfa, name="g64", k=db.k, interval=db.interval, large=True)
    cfg = AlignConfig(top_k=4, max_occ=8)
    b = make_batch(reads[:64], 64, 128)
    batch = {k: b[k] for k in ("codes", "nmask", "lengths")}
    parts = large.shard_genome_host(dbl, 4, 256)
    out = []
    for devices in (SHARED, DISTINCT):
        arrays, align, bases = large.make_genome_sharded_aligner(
            mesh.make_mesh(4, index_shards=4, devices=devices), dbl, cfg,
            256, parts=parts)
        out.append(align(arrays, batch))
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k
    coords = large.rebase_results(out[1], bases)
    assert coords.dtype == np.uint64
    np.testing.assert_array_equal(coords,
                                  large.rebase_results(out[0], bases))


# ------------------------------------- indexes past 2^31 positions

def test_offsets_past_int32_are_refused_where_tpumap_reads_position_0():
    """The port refuses a k-mer table whose offsets reach 2^31 (its
    device tables are int32); tpumap casts the looked-up offset to int32
    (gsnap/engine.py:212, :307, ops/seed.py:64, ops/chain.py:100) and
    gathers with mode="clip", so there it reads positions[0]."""
    offsets = np.asarray([0, 5, 2 ** 31], np.uint32)
    arrays = {"genome_packed": np.zeros(8, np.uint32),
              "genome_nmask": np.zeros(8, np.uint32), "offsets": offsets,
              "positions": np.zeros(8, np.uint32),
              "chrom_offsets": np.zeros(1, np.uint32), "genome_length": 64,
              "k": 1, "genome_has_n": False, "interval": 3}
    with pytest.raises(ValueError, match="int32"):
        DeviceIndex.from_jax_arrays(arrays, "cpu")
    arrays["offsets"] = np.asarray([0, 5, 2 ** 31 - 1], np.uint32)
    DeviceIndex.from_jax_arrays(arrays, "cpu")            # the last it takes
    parts = {"offsets": np.stack([offsets, offsets])}
    with pytest.raises(ValueError, match="int32"):
        sharded._place_shards(mesh.make_mesh(2, index_shards=2,
                                             devices=SHARED[:2]),
                              parts, ("offsets",))
    # tpumap's gather: start.astype(int32)[..., None] + lane, then
    # jnp.take(positions, idx, mode="clip")
    positions = jnp.arange(100, 116, dtype=jnp.uint32)
    start = jnp.asarray([2 ** 31 + 3], jnp.uint32)
    idx = start.astype(jnp.int32)[..., None] + jnp.arange(4,
                                                          dtype=jnp.int32)
    got = np.asarray(jnp.take(positions, idx, mode="clip"))
    assert got.tolist() == [[100, 100, 100, 100]]
