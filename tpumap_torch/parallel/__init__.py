"""Multi-process helpers of the port (the single-process part of
tpumap.parallel so far)."""
