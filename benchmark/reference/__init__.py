"""The plain reference: NumPy and PyTorch only. It imports nothing of the
program (tpumap_torch) and nothing of JAX; it is given the genome and the
reads that the benchmark made, and it reads the program's SAM only to
judge it."""
