"""Several devices and several processes (port of tpumap.parallel): the
device grid (mesh), the data-parallel MeshContext (pipeline), the
index-sharded and genome-window aligners (sharded, large), the gloo
gathers of the two-pass tables (distributed) and the ordered output
merge (outmerge)."""
