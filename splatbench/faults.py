"""Faults planted in the program, for the readings that the limits of
`correct` are set from and for the tests that see `correct` come out
false. The benchmark's own runs never plant one.

- "stale_replays": every call of the captured train step after its first
  reads the first call's cameras and targets. On a card the first call is
  the step's eager warm-up and the later ones are its graph's replays, so
  the fault is confined to the replays: their inputs are never copied
  into the graph's buffers.
"""

from __future__ import annotations

import contextlib

PROGRAM_FAULTS = ("stale_replays",)


@contextlib.contextmanager
def stale_replays(kind: str = "train_step"):
    """Within the block, the `utils/graphs.py` caches of `kind` hand every
    call after their first the first call's copied inputs."""
    from gsplat_tpu_torch.utils import graphs

    real = graphs.Captured.__call__
    first = {}

    def call(self, key, inputs, body, held=0, mesh=None):
        if self.kind == kind:
            kept = first.setdefault(id(self),
                                    [t.detach().clone() for t in inputs])
            inputs = list(inputs[:held]) + kept[held:]
        return real(self, key, inputs, body, held, mesh)

    graphs.Captured.__call__ = call
    try:
        yield
    finally:
        graphs.Captured.__call__ = real


def planted(name: str | None):
    """The context that plants program fault `name` (none for None)."""
    if name is None:
        return contextlib.nullcontext()
    if name not in PROGRAM_FAULTS:
        raise ValueError(f"no program fault {name!r}: {PROGRAM_FAULTS}")
    return stale_replays()
