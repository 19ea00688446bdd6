"""One registry of the kernel wrappers' launch counters.

Each kernel module keeps its counters as module globals (`cull.launches`,
`raster.bwd_packed_launches`, ...), to which its wrapper adds one where it
launches its kernel and nowhere else, and names them here when it is
imported (`register`). A CUDA graph's replay runs no Python, so no wrapper
sees it: `utils/graphs.py` reads the counters' rise across a capture
(`snapshot`), takes it back, since a capture launches nothing, and adds it
once per replay (`add`).
"""

from __future__ import annotations

import sys

# "<module>.<global>" -> (the module's full name, the global).
_counters: dict = {}


def register(module: str, *names: str) -> None:
    """Name the launch counters `names` of the module `module` (its
    `__name__`)."""
    for name in names:
        _counters[f"{module.rsplit('.', 1)[1]}.{name}"] = (module, name)


def snapshot() -> dict:
    """Every registered counter's value, by "<module>.<global>"."""
    return {key: getattr(sys.modules[mod], name)
            for key, (mod, name) in _counters.items()}


def rise(before: dict, after: dict) -> dict:
    """The counters that rose from `before` to `after`, and by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add(delta: dict, times: int = 1) -> None:
    """Add `times` times `delta` (a `rise`) to the counters."""
    for key, d in delta.items():
        mod, name = _counters[key]
        module = sys.modules[mod]
        setattr(module, name, getattr(module, name) + times * d)
