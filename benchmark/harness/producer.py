"""The read producer: a process of its own that makes a traffic mix's
reads from a run's --seed and writes them as FASTA text to its standard
output, a chunk at a time, ahead of the aligner (as `zcat reads.fq.gz |
gsnap` streams them). A chunk is `blocks` blocks of `block` reads (or
pairs); producer `index` of `stride` makes chunks index, index + stride,
... Each chunk is a header of two little-endian uint64 lengths (mate 1's
text, mate 2's text or 0) and the texts. It stops when the
reader closes the pipe.

    python3 producer.py CONFIG.json TRAFFIC.json SEED INDEX STRIDE BLOCKS BLOCK
"""
from __future__ import annotations

import json
import os
import pathlib
import struct
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from harness import genome, traffic  # noqa: E402


def chunk_texts(codes, genes, mix, seed, chunk, blocks, n):
    parts = [traffic.make_block(codes, genes, mix, seed, b, truth=False, n=n)
             for b in range(chunk * blocks, (chunk + 1) * blocks)]
    texts = [b"".join(p["fasta"][m] for p in parts)
             for m in range(len(parts[0]["fasta"]))]
    return texts + [b""] * (2 - len(texts))


def main(argv) -> int:
    cfg_path, mix_path, seed, index, stride, blocks, n = argv
    cfg = json.loads(pathlib.Path(cfg_path).read_text())
    mix = json.loads(pathlib.Path(mix_path).read_text())
    spec = genome.genome_spec(cfg)
    codes = genome.genome_codes(spec)
    genes = genome.gene_table(spec)
    out = os.fdopen(sys.stdout.fileno(), "wb", buffering=0)
    c = int(index)
    try:
        while True:
            t1, t2 = chunk_texts(codes, genes, mix, int(seed), c,
                                 int(blocks), int(n))
            out.write(struct.pack("<QQ", len(t1), len(t2)))
            out.write(t1)
            out.write(t2)
            c += int(stride)
    except (BrokenPipeError, ConnectionResetError):
        return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
