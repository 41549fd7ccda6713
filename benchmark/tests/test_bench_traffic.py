"""The read generator: deterministic by seed, wgsim's rates within
sampling error, the RNA mixes' shares, pairs' outer distance."""
import numpy as np
import pytest

from harness import genome, traffic
from tests.tiny import tiny_cell


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cell = tiny_cell(tmp_path_factory.mktemp("g"))
    spec = genome.genome_spec(cell["config"])
    return genome.genome_codes(spec), genome.gene_table(spec)


def _mix(name):
    import json
    return json.loads((traffic_dir() / f"{name}.json").read_text())


def traffic_dir():
    import pathlib
    return pathlib.Path(__file__).resolve().parents[1] / "traffic"


@pytest.mark.parametrize("mix", ["wgsim_se100", "wgsim_pe100",
                                 "mrna_se100", "total_rna_se100"])
def test_same_seed_same_reads(world, mix):
    codes, genes = world
    m = _mix(mix)
    a = traffic.make_block(codes, genes, m, 2**31 + 7, 5, n=512)
    b = traffic.make_block(codes, genes, m, 2**31 + 7, 5, truth=False,
                           n=512)
    c = traffic.make_block(codes, genes, m, 2**31 + 8, 5, n=512)
    assert a["fasta"] == b["fasta"]
    assert a["fasta"] != c["fasta"]
    assert all(len(t) == 512 * (1 + 11 + 1 + 100 + 1) for t in a["fasta"])


def test_genome_fixed_and_genes_planted(world):
    codes, genes = world
    donor = genes[:, :-1, 0] + genes[:, :-1, 1]
    acc = genes[:, 1:, 0]
    assert (codes[donor] == 2).all() and (codes[donor + 1] == 3).all()
    assert (codes[acc - 2] == 0).all() and (codes[acc - 1] == 2).all()
    assert (genes[1:, 0, 0] > genes[:-1, -1, 0] + genes[:-1, -1, 1]).all()


def test_wgsim_rates(world):
    codes, genes = world
    m = _mix("wgsim_se100")
    ts = [traffic.make_block(codes, genes, m, 11, b, n=4096)["truth"][0]
          for b in range(4)]
    nmm = np.concatenate([t["nmm"] for t in ts])
    indel = np.concatenate([(t["ins_ev"] + t["del_ev"]) > 0 for t in ts])
    n = len(nmm)
    # substitutions: 2% errors plus 0.085% mutations a base, less the
    # quarter-ish of hits that land on a base hit twice or on an inserted
    # base; 100 bases a read
    rate = nmm.mean() / 100
    assert abs(rate - 0.02085) < 4 * np.sqrt(0.021 / (100 * n)) + 0.0005
    # reads with an indel: 1 - (1 - 0.00015)^~98
    p = 1 - (1 - 0.001 * 0.15) ** 98
    assert abs(indel.mean() - p) < 4 * np.sqrt(p * (1 - p) / n)
    lens = np.concatenate([t["ins_b"] + t["del_b"] for t in ts])[indel]
    ev = np.concatenate([t["ins_ev"] + t["del_ev"] for t in ts])[indel]
    # geometric lengths with extension 0.3: mean 1 / 0.7
    assert abs((lens / ev).mean() - 1 / 0.7) < 0.25


def test_pairs_outer_distance(world):
    codes, genes = world
    b = traffic.make_block(codes, genes, _mix("wgsim_pe100"), 3, 0, n=4096)
    t1, t2 = b["truth"]
    frag = t1["frag"]
    assert abs(frag.mean() - 500) < 3 and abs(frag.std() - 50) < 3
    # FR: one mate forward, one reverse, spanning the fragment
    assert (t1["strand"] != t2["strand"]).all()
    span = np.maximum(t1["end"], t2["end"]) + 1 - np.minimum(t1["pos0"],
                                                             t2["pos0"])
    plain = (t1["ins_b"] + t1["del_b"] + t2["ins_b"] + t2["del_b"]) == 0
    assert (span[plain] == frag[plain]).all()


@pytest.mark.parametrize("mix,spliced", [("mrna_se100", 0.4),
                                         ("total_rna_se100", 0.1)])
def test_rna_shares(world, mix, spliced):
    codes, genes = world
    t = traffic.make_block(codes, genes, _mix(mix), 4, 1, n=4096)["truth"][0]
    got = (t["junctions"][:, 0, 0] >= 0).mean()
    assert abs(got - spliced) < 4 * np.sqrt(spliced * (1 - spliced) / 4096)
    js = t["junctions"][t["junctions"][:, :, 0] >= 0]
    assert (codes[js[:, 0]] == 2).all() and (codes[js[:, 1] - 1] == 2).all()
