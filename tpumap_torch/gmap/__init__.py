"""GMAP cDNA -> genome spliced alignment (port of tpumap/gmap)."""
