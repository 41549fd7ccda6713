"""tpumap_torch — the PyTorch/CUDA port of tpumap for NVIDIA Hopper.

The package mirrors tpumap's layout and function names. Device work is
plain torch ops plus hand-written CUDA kernels (`csrc/`, built with nvcc
for sm_90a at first use, see `kernels.py`); every kernel wrapper keeps a
plain PyTorch version beside it, which is what runs for CPU tensors.

Package layout:
  tpumap_torch.index   DeviceIndex built from tpumap's host GenomeDB
  tpumap_torch.ops     pack / verify / seed / trim / banded DP / chain DP /
                       window scans
  tpumap_torch.gsnap   cascade, fused ladder, host driver (single and
                       paired end, novel and known splicing)

It imports torch and numpy, and of tpumap only the modules that load
without JAX (index.build, io, native, utils.dna, utils.fetch,
gsnap.params, gsnap.spliceends, gsnap.knownsplicing).
"""

__version__ = "0.1.0"
