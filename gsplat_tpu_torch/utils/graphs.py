"""Capture once, replay on every call: CUDA graphs in the role of `jax.jit`.

The JAX package dispatches a frame (`render_jit`), a loss and its gradients
(`render_loss_and_grad`) and a train step each as one compiled program,
traced once per static configuration and input shapes. The port's
counterpart is a CUDA graph. `Captured` keys a body on its static
configuration and on its inputs' shapes, dtypes and device (the port's
`static_argnames`), and on a CUDA device:

- on the first call for a key it runs the body eagerly on a side stream
  (the warm-up: the kernels are built and loaded, lazy state such as
  Adam's moments is created, so no `nvcc` runs inside a capture) and
  returns that call's outputs; it then captures the body with
  `torch.cuda.graph`;
- on a later call it replays the graph and returns fresh copies of the
  outputs, as `jax.jit` returns new arrays: a caller that keeps frame t
  does not see it overwritten by frame t + 1.

The graph reads its inputs at fixed addresses. The last inputs (a camera,
a target) are copied into buffers of the cache's own (`copy_`) where the
caller's tensor does not lie in them. The first `held` inputs (a served
scene) are read where they lie: their addresses and strides are part of
the key, so a scene that stays in place (in-place updates included) is
never copied, and a new scene object is a new entry. The cache holds no
reference to a held input: when its storage is freed, the entries that
read it go, their graphs with them. A body that updates state in place
(the train step's parameters, gradients and Adam moments) keeps that state
at fixed addresses, which the graph reads and writes on every replay.

The graphs of one kind ("render", "loss_and_grad", "train_step") share one
memory pool per device, and a `Captured` keeps at most `MAX_ENTRIES` graphs,
dropping the least recently used: graphs of nine bench configurations and a
train step do not each hold their own intermediates. Outputs are copied out
right after their replay, so a later replay of another graph of the pool
may reuse their memory.

A capture or replay that fails raises; on a CUDA device nothing runs the
body eagerly instead. For inputs on the CPU the same copy-in, body and
copy-out run eagerly (the plain version the CPU tests use), only because the
caller passed CPU tensors.

Launch counts: a replay runs no Python, so the kernel wrappers' counters
(`ops/cuda/counters.py`) would see the warm-up alone. A capture records the
counters' rise during the capture (taken back, since a capture launches
nothing), and each replay adds it again: the counters stay the number of
launches the card ran.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import weakref
from typing import Callable, Sequence

import torch

from gsplat_tpu_torch.ops.cuda import counters

# Graphs one `Captured` keeps, the least recently used dropped first.
MAX_ENTRIES = 4

# Captures made so far, per kind.
captures: collections.Counter = collections.Counter()

_pools: dict = {}
_warm_streams: dict = {}
# Entries evicted while a capture was under way, released after it.
_evicted_in_capture: list = []


def _evict(entries: collections.OrderedDict, key) -> None:
    """Drop an entry whose held input's storage was freed. A collection
    can free a scene in the middle of another graph's capture: the entry
    (its graph) is then kept until that capture ends."""
    entry = entries.pop(key, None)
    if (entry is not None and entry.graph is not None
            and torch.cuda.is_current_stream_capturing()):
        _evicted_in_capture.append(entry)


def _tree_map(fn: Callable, x):
    """fn applied to every tensor of a nest of tuples, lists, dicts and
    dataclasses (other leaves kept)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _tree_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def _clone(out):
    return _tree_map(lambda t: t.clone(), out)


@dataclasses.dataclass
class Entry:
    """One key's buffers of the copied inputs and, on CUDA, its graph, the
    graph's static outputs and the kernel launches one replay makes
    (`counters.rise`)."""

    buffers: list
    graph: object = None
    outputs: object = None
    launches: dict = dataclasses.field(default_factory=dict)
    capture_s: float = 0.0


class Captured:
    """A body captured once per static key and replayed on later calls.

    `__call__(key, inputs, body, held=0)`: `key` is the hashable static
    configuration, `inputs` the tensors the body reads (all on one device;
    the first `held` of them read where they lie), and `body(*tensors)`
    computes the outputs (a nest of tensors) from the held inputs and the
    buffers; it is called only to warm up and to capture."""

    def __init__(self, kind: str):
        self.kind = kind
        self.entries: collections.OrderedDict = collections.OrderedDict()

    def __call__(self, key, inputs: Sequence[torch.Tensor], body: Callable,
                 held: int = 0):
        devices = {t.device for t in inputs}
        if len(devices) != 1:
            raise ValueError(f"{self.kind}: the inputs lie on {devices}, "
                             "not on one device")
        (device,) = devices
        full_key = (key, device,
                    tuple((tuple(t.shape), t.dtype) for t in inputs),
                    tuple((t.data_ptr(), t.stride()) for t in inputs[:held]))
        entry = self.entries.get(full_key)
        if entry is None:
            entry = Entry(buffers=[t.detach().clone() for t in inputs[held:]])
            args = [t.detach() for t in inputs[:held]] + entry.buffers
            if device.type == "cuda":
                out = self._warm_up(args, body, device)
                self._capture(entry, args, body, device)
            else:
                out = _clone(body(*args))
            self.entries[full_key] = entry
            for t in inputs[:held]:
                weakref.finalize(t.untyped_storage(), _evict, self.entries,
                                 full_key).atexit = False
            while len(self.entries) > MAX_ENTRIES:
                self.entries.popitem(last=False)
            return out
        self.entries.move_to_end(full_key)
        with torch.no_grad():
            for buf, t in zip(entry.buffers, inputs[held:]):
                if t.data_ptr() != buf.data_ptr() or t.stride() != buf.stride():
                    buf.copy_(t)
        if entry.graph is None:
            return _clone(body(*[t.detach() for t in inputs[:held]],
                               *entry.buffers))
        entry.graph.replay()
        counters.add(entry.launches)
        return _clone(entry.outputs)

    def _warm_up(self, args: list, body: Callable, device):
        """The body run eagerly on a side stream: the call's outputs."""
        with torch.cuda.device(device):
            current = torch.cuda.current_stream(device)
            side = _warm_streams.get(device)
            if side is None:
                side = _warm_streams[device] = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = _clone(body(*args))
            current.wait_stream(side)
        return out

    def _capture(self, entry: Entry, args: list, body: Callable,
                 device) -> None:
        with torch.cuda.device(device):
            pool = _pools.get((self.kind, device))
            if pool is None:
                pool = _pools[(self.kind, device)] = \
                    torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            before = counters.snapshot()
            with torch.cuda.graph(graph, pool=pool):
                outputs = body(*args)
            _evicted_in_capture.clear()
            entry.launches = counters.rise(before, counters.snapshot())
            counters.add(entry.launches, -1)
            entry.capture_s = time.perf_counter() - t0
        entry.graph, entry.outputs = graph, outputs
        captures[self.kind] += 1
