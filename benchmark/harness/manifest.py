"""Finding a cell's files by the names in BENCHMARK.json: its
configuration (configs/<config>.json, named by the manifest's "file"),
its traffic mix (traffic/<traffic>.json), its limits (cells/<cell>.json),
each per-layer metric's reader (metrics/<metric>.py) and each hand
kernel's work count (kernels/<launch name>.py)."""
from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]      # benchmark/


def load(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(root: pathlib.Path, name: str) -> dict:
    """{"cell", "config", "traffic", "limits", "end_to_end", "per_layer"}
    of the cell `name`; the metrics are those the cell reports."""
    man = load(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return {
        "cell": w,
        "config": cfg,
        "config_path": root / conf["file"],
        "traffic": json.loads((HERE / "traffic" / f"{w['traffic']}.json"
                               ).read_text()),
        "traffic_path": HERE / "traffic" / f"{w['traffic']}.json",
        "limits": json.loads((HERE / "cells" / f"{name}.json").read_text()
                             )["limits"],
        "end_to_end": [m for m in man["end_to_end"] if mine(m)],
        "per_layer": [m for m in man["per_layer"] if mine(m)],
    }


def _module(path: pathlib.Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_{prefix}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return _module(HERE / "metrics" / f"{name}.py", "metric")


def kernel_work(launch_name: str):
    """The work count of a hand kernel, or None where it has none."""
    path = HERE / "kernels" / f"{launch_name}.py"
    return _module(path, "kernel") if path.exists() else None
