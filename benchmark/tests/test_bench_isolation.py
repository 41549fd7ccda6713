"""The isolation from JAX and the JAX package: compared by top-level
module name whole, so tpumap_torch passes and tpumap does not; and the
run's refusals without a card."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from harness import isolation

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("mods,found", [
    ({"tpumap_torch": 1, "tpumap_torch.gsnap.driver": 1}, []),
    ({"tpumap": 1}, ["tpumap"]),
    ({"tpumap.gsnap": 1, "numpy": 1}, ["tpumap.gsnap"]),
    ({"jax": 1, "jaxlib.xla": 1, "flax": 1}, ["flax", "jax", "jaxlib.xla"]),
    ({"jax_something": 1, "tpumapper": 1}, []),
    ({"jax": None}, []),
])
def test_loaded_compares_top_level_names_whole(mods, found):
    assert isolation.loaded(mods) == found


def test_block_refuses_jax_and_tpumap_but_not_the_port():
    code = ("import sys; sys.path.insert(0, 'benchmark');"
            "from harness import isolation; isolation.block();"
            "import tpumap_torch.io.fasta\n"
            "for m in ('tpumap', 'jax', 'tpumap.gsnap'):\n"
            "    try:\n"
            "        __import__(m)\n"
            "    except ImportError:\n"
            "        pass\n"
            "    else:\n"
            "        raise SystemExit(m + ' imported')\n"
            "print(isolation.loaded())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dna_se100",
         "--seed", "3000000011", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


def _no_result(r):
    lines = r.stdout.strip().splitlines()
    if lines:
        with pytest.raises(ValueError):
            json.loads(lines[-1])


def test_run_fails_without_a_card():
    r = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    _no_result(r)


def test_run_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0
    _no_result(r)
