"""The port's functions that a per-layer metric of its program spans
wraps by name (metrics/<metric>.py SPANS). A port from before those spans
(no tpumap_torch.utils.trace) has none of them: the metric wraps nothing
and reads nothing. A port that has the spans has every listed function,
or the metric's import fails: a renamed or inlined function stops the
traced run instead of silencing the metric."""
from __future__ import annotations

import importlib
import importlib.util


def where_present(targets: list) -> list:
    """targets [(module name, attribute)] where the port has its program
    spans; [] where it has none. Raises AttributeError where it has them
    and lacks a listed function."""
    if importlib.util.find_spec("tpumap_torch.utils.trace") is None:
        return []
    for modname, attr in targets:
        if not callable(getattr(importlib.import_module(modname), attr,
                                None)):
            raise AttributeError(
                f"{modname}.{attr}: a function this metric wraps by name "
                f"is not in the port")
    return list(targets)
