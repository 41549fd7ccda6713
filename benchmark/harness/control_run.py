"""The control at a cell's own size: the reference's ungapped aligner
(reference/control.py) in the program's place, judged by the function
that judges a run (runner.compare) over the sample that a run of the cell
would judge, drawn from each seed among a window's first chunks; on the
card where there is one; one JSON line a seed.

    python3 benchmark/harness/control_run.py --workload CELL --seed N [N ...]
"""
from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    import argparse
    import json
    import time
    here = pathlib.Path(__file__).resolve().parents[1]
    from harness import isolation, manifest, runner, window
    isolation.block()
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--chunks", type=int, default=12,
                    help="the window's chunks the sample is drawn from")
    args = ap.parse_args(argv)
    cell = manifest.cell(here.parent, args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    first = window.FIRST_CHUNK
    for seed in args.seed:
        t0 = time.perf_counter()
        kept = dict.fromkeys(window.kept_chunks(seed, first,
                                                first + args.chunks))
        out = runner.compare(cell, kept, seed, dev, lambda m: None,
                             control=True)
        lim = cell["limits"]
        print(json.dumps({"control": args.workload, "seed": seed,
                          "sample": out["sample"],
                          "bad_records": out["bad_records"],
                          "worse_share": out["worse_share"],
                          "fails": any(out[k] > lim[k] for k in lim),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
