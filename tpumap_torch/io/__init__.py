"""FASTA/FASTQ input, IIT maps and SAM output of the port (copies of
the tpumap.io modules it reaches)."""
