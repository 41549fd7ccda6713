"""The paired-end cell dna_pe100: the manifest gives it the pair layer's
two metrics and gives dna_se100 neither, the port has the function that
rescue_ms wraps by name, and a traced run of the cell on the CPU at a
test's size is correct and reads both."""
import pathlib

import torch

from harness import manifest, runner
from tests.tiny import tiny_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
PAIR = {"pair_ms", "rescue_ms"}


def test_manifest_gives_the_pair_metrics_to_the_pair_cell_alone():
    pe = manifest.cell(ROOT, "dna_pe100")
    assert pe["cell"]["config"] == "gsnap_dna_pe_chr1"
    assert "pairs" in pe["traffic"] and pe["cell"]["chips"] == 1
    names = {m["name"] for m in pe["per_layer"]}
    assert PAIR <= names
    for m in pe["per_layer"]:
        if m["name"] in PAIR:
            assert m["layer"] == "pair layer" and m["workloads"] == [
                "dna_pe100"]
    se = manifest.cell(ROOT, "dna_se100")
    assert not PAIR & {m["name"] for m in se["per_layer"]}
    # every other per-layer metric is the single-end cell's too
    assert names - PAIR == {m["name"] for m in se["per_layer"]}


def test_rescue_ms_wraps_the_ports_rescue():
    from tpumap_torch.gsnap import paired
    mod = manifest.metric_reader("rescue_ms")
    assert mod.SPANS == [("tpumap_torch.gsnap.paired", "_rescue")]
    assert callable(paired._rescue) and paired._rescue.__name__ == "_rescue"


def test_traced_cpu_run_of_the_pair_cell(tmp_path):
    c = tiny_cell(tmp_path, "dna_pe100")
    res, checks = runner.run(ROOT, c, 2**31 + 207, 0.5, True,
                             torch.device("cpu"), lambda m: None)
    m = res["metrics"]
    for name in PAIR | {"enqueue_ms", "emit_ms", "refine_ms"}:
        assert m[name]["value"] > 0, name
    assert m["pair_ms"]["unit"] == m["rescue_ms"]["unit"] == "ms/batch"
    assert checks["bad_records"][0] == 0
    assert res["correct"], res["checks"]
