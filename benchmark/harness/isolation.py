"""Keeping JAX and the JAX package out of a run: an import hook that
refuses them, and a look at sys.modules once the window has closed. A
module is compared by its top-level name (the part before the first
dot) whole, since the port's name, tpumap_torch, begins with the JAX
package's."""
from __future__ import annotations

import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "flax", "tpumap")


def top(name: str) -> str:
    return name.partition(".")[0]


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if top(fullname) in BLOCKED:
            raise ImportError(f"{fullname} is not to be imported by the "
                              f"benchmark of the port")
        return None


def block() -> None:
    if not any(isinstance(f, _Refuse) for f in sys.meta_path):
        sys.meta_path.insert(0, _Refuse())


def loaded(modules=None) -> list:
    """The blocked modules present in `modules` (sys.modules)."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if top(m) in BLOCKED
                  and mods[m] is not None)
