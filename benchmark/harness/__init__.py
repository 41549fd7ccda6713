"""The benchmark's general code: generators, the timed window, tracing,
the index cache and the comparison. Nothing here is specific to one
configuration, traffic mix or metric; those are data files and small
modules that the harness finds by name."""
