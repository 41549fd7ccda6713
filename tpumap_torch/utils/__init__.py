"""Host utilities of the port (copies of tpumap.utils)."""
