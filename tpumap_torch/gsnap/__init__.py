"""GSNAP cascade, fused ladder and host driver of the port, single and
paired end."""
