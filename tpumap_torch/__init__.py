"""tpumap_torch — the PyTorch/CUDA port of tpumap for NVIDIA Hopper.

The package mirrors tpumap's layout and function names. Device work is
plain torch ops plus hand-written CUDA kernels (`csrc/`, built with nvcc
for sm_90a at first use, see `kernels.py`); every kernel wrapper keeps a
plain PyTorch version beside it, which is what runs for CPU tensors.

Package layout:
  tpumap_torch.index   GenomeDB (host build/load) and its DeviceIndex
  tpumap_torch.ops     pack / verify / seed / trim / banded DP / chain DP /
                       window scans / GMAP anchor chaining
  tpumap_torch.gsnap   cascade, fused ladder, host driver (single and
                       paired end, novel and known splicing)
  tpumap_torch.gmap    GMAP cDNA alignment: stage 1, the chain stage's
                       device half, the host exon refinement, chimeras
  tpumap_torch.cli     the entry points: gsnap_cli and gmap_cli (every
                       option of tpumap's gsnap and gmap), and the tools
                       that make their inputs (build_cli, iit_cli,
                       snpindex_cli, modeindex_cli, trindex_cli,
                       converters)
  tpumap_torch.io      FASTA/FASTQ and read preprocessing, IIT maps (read
                       and write), SAM records and bulk emitters, GSNAP's
                       native format and m8, GFF3, GMAP's PSL/SAM
                       printers and its alignment text (alignfmt)
  tpumap_torch.parallel  gsnap -O's ordered output merge (one process)
  tpumap_torch/data/   the MaxEnt splice-model tables (a copy of
                       tpumap/data/maxent_tables.npz)
  tpumap_torch.native  the C++ tokenizer and SAM emitters (g++ at first use)
  tpumap_torch.utils   DNA encoding, result-dict wire dtypes

It imports torch, numpy and the standard library, and nothing of tpumap:
the host modules it shares with tpumap are copies that keep tpumap's
names. Its entry points run on the card unless the caller asks for the
CPU.
"""

__version__ = "0.1.0"
