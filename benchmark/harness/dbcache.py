"""The index cache: the port's own index build (index.build.build_db_from_seqs)
makes the k-mer index of the configuration's genome once per checkout,
GenomeDB.save writes it under benchmark/.cache/db-<key>/, and every
later run loads it with GenomeDB.load, as gsnap loads what gmap_build
wrote. The key holds the genome's specification, k, the interval and a
hash of the index code's sources, so a change to that code builds anew.
The cache is written to a directory of its own and renamed into place,
so a run that is cut leaves no half cache."""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import time

from harness import genome

INDEX_SOURCES = ("tpumap_torch/index/build.py", "tpumap_torch/utils/dna.py")


def cache_key(root: pathlib.Path, cfg: dict) -> str:
    h = hashlib.sha256()
    h.update(json.dumps({"genome": genome.genome_spec(cfg), "k": cfg["k"],
                         "interval": cfg["interval"]},
                        sort_keys=True).encode())
    for rel in INDEX_SOURCES:
        h.update((root / rel).read_bytes())
    return h.hexdigest()[:16]


def load_or_build(root: pathlib.Path, cache: pathlib.Path, cfg: dict,
                  log) -> tuple:
    """(GenomeDB, built: bool). Builds and caches the index when the
    cache has none for this key."""
    from tpumap_torch.index.build import GenomeDB, build_db_from_seqs
    final = cache / f"db-{cache_key(root, cfg)}"
    if (final / "meta.json").exists():
        return GenomeDB.load(str(final)), False
    t0 = time.perf_counter()
    spec = genome.genome_spec(cfg)
    seq = genome.codes_to_text(genome.genome_codes(spec))
    db = build_db_from_seqs([(cfg["contig"], seq)], name="genome",
                            k=cfg["k"], interval=cfg["interval"])
    del seq
    log(f"index built in {time.perf_counter() - t0:.1f} s")
    tmp = cache / f"db-{final.name[3:]}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    cache.mkdir(parents=True, exist_ok=True)
    db.save(str(tmp))
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    # older keys' caches: changed index code leaves them behind
    for old in cache.glob("db-*"):
        if old != final:
            shutil.rmtree(old, ignore_errors=True)
    return db, True
