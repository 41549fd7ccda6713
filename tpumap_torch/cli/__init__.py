"""Command-line entry points of the port (tpumap/cli's counterparts)."""
