"""A cell at a size that a CPU test holds: a 2-Mbp genome with 16 genes,
k = 10, batches of 256 reads or 128 pairs, blocks of 128; the real
cells' files with their sizes cut."""
from __future__ import annotations

import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def tiny_cell(tmp: pathlib.Path, cell: str = "dna_se100",
              genome_bp: int = 2_000_000) -> dict:
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = {x["name"]: x for x in man["workloads"]}[cell]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    cfg.update({"genome_bp": genome_bp, "k": 10,
                "batch_size": 256, "pair_batch_size": 128,
                "batches_per_chunk": 2, "reads_per_block": 128})
    cfg["genes"] = dict(cfg["genes"], count=genome_bp // 116750 - 1)
    cfg_path = tmp / f"{cfg['name']}.json"
    cfg_path.write_text(json.dumps(cfg))
    mix_path = HERE / "traffic" / f"{w['traffic']}.json"

    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return {"cell": w, "config": cfg, "config_path": cfg_path,
            "traffic": json.loads(mix_path.read_text()),
            "traffic_path": mix_path,
            "limits": json.loads((HERE / "cells" / f"{cell}.json"
                                  ).read_text())["limits"],
            "end_to_end": [m for m in man["end_to_end"] if mine(m)],
            "per_layer": [m for m in man["per_layer"] if mine(m)]}
