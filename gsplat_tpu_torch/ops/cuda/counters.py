"""One table of launch counts by name.

The names are the kernel table's (`PERF.md` §6): K1 and K2 on a float32 or
a packed stream, K3's seven stages, K4-K13 (K7 as "K7.chunked" where its
channels need more than one walk), the probes P1-P4, the stage marks of
`utils/trace.py` and the collectives of `parallel/sharding.py`.
A launch counts under exactly one name, after its launch succeeded
(`_build.kernel`), a collective where it is issued (`bump`); a total is a
sum of names.

A CUDA graph's replay runs no Python, so no wrapper sees it:
`utils/graphs.py` reads the table's rise across a capture (`snapshot`,
`rise`), takes it back, since a capture launches nothing, and adds it once
per replay (`add`).
"""

from __future__ import annotations

NAMES = ("K1", "K1.packed", "K2", "K2.packed", "K3.mask", "K3.compact",
         "K3.rank", "K3.count", "K3.emit", "K3.tier_count", "K3.tier_emit",
         "K4", "K5", "K6", "K7",
         "K7.chunked", "K8", "K9", "K10", "K11", "K12", "K13", "P1", "P2",
         "P3", "P4", "mark", "collectives")

_table = dict.fromkeys(NAMES, 0)


def bump(name: str, n: int = 1) -> None:
    """Add n to the count of `name` (one of NAMES)."""
    if name not in _table:
        raise KeyError(f"no launch count named {name!r}")
    _table[name] += n


def snapshot() -> dict:
    """Every count, by name."""
    return dict(_table)


def rise(before: dict, after: dict) -> dict:
    """The counts that rose from `before` to `after`, and by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add(delta: dict, times: int = 1) -> None:
    """Add `times` times `delta` (a `rise`) to the counts."""
    for name, d in delta.items():
        bump(name, times * d)


def reset() -> None:
    """Every count to 0."""
    for name in _table:
        _table[name] = 0
