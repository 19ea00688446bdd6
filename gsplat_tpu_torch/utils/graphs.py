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
  `torch.cuda.graph` on that same stream, so that state kept per stream
  (cuBLAS's workspace) exists before the capture and is not taken from
  the graphs' pool, which would then hold it past its graph;
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

Launch counts: a replay runs no Python, so the table of launch counts
(`ops/cuda/counters.py`) would see the warm-up alone. A capture records the
table's rise during the capture (taken back, since a capture launches
nothing), and each replay adds it again: the counts stay the number of
launches the card ran. The captured graph's nodes are counted by type once
(`Entry.nodes`): the launches of one replay, those no wrapper counts too.

Stages inside a replay (`utils/trace.py`): the body's `trace.stage`s
enqueue marks while it is captured, between the graph's first and last
mark. While recording is on (a `torch.profiler` session, or
`trace.recording()`), a call keeps its host spans: the copy in
(`graphs.<kind>.copy_in`), the replay's launch (`.launch`) and the copy of
the outputs (`.copy_out`), or the eager body's (`.body`).

On a mesh (`parallel/sharding.py`): a body may issue the port's
collectives. The multi-device programs of the JAX package (a `jax.jit` of
a `shard_map`) become one graph per rank, collectives inside, where the
mesh's backend is NCCL, whose collectives are kernels on the card that a
graph records. On gloo the same body runs eagerly on every call, chosen
from the backend (`captures_on`) and not after a failure: gloo's
collectives on CUDA tensors copy through host memory and wait for the
stream, which no capture can hold. A capture or replay that fails on NCCL
raises. The warm-up runs the collectives eagerly first, so that NCCL's
communicators and connections exist before the capture, and the capture
is made in `thread_local` mode wherever a process group is up: torch's
NCCL watchdog thread queries the events of earlier collectives while the
main thread captures, which a `global` capture may refuse (on an H100 with
NCCL 2.28.9 captures in all three modes replayed; `thread_local` is the
one that never depends on the watchdog's timing).

Every rank must warm up, capture and replay the same program at the same
call, or one rank's collectives wait for another's that never come. The
rule that ensures it: on a mesh, hit, miss and eviction depend only on
values the ranks share. The key is the static configuration, the mesh
(an object every rank makes at the same call) and the inputs' shapes and
dtypes, never an address; every input is
copied into the entry's buffers (nothing is held, so a new scene at
another address is the same entry, read anew); no entry is evicted by a
weak reference (a collection runs when each process pleases), only by the
LRU bound, in call order. Ranks that make the same calls (the collectives
already require it) then hit, miss and evict alike. A miss on a mesh of
several ranks is preceded by one host-side check that every rank misses on
the same key (`check_ranks_agree`, an all_gather of its digest): ranks that
disagree raise there, together, instead of capturing different programs.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
import weakref
from typing import Callable, Sequence

import torch

from gsplat_tpu_torch.ops.cuda import counters
from gsplat_tpu_torch.utils import trace

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


def captures_on(device: torch.device, mesh=None) -> bool:
    """Whether a body on `device` is captured: on a CUDA device, alone or
    on a mesh of one process or whose backend is NCCL; never on the CPU,
    and never on gloo (its collectives synchronise with the host)."""
    if device.type != "cuda":
        return False
    return mesh is None or not mesh.distributed or mesh.backend == "nccl"


def _capture_mode() -> str:
    """`thread_local` where a process group (and its watchdog thread) is up,
    else torch's default, `global`."""
    dist = torch.distributed
    return ("thread_local" if dist.is_available() and dist.is_initialized()
            else "global")


def check_ranks_agree(description: str, mesh) -> None:
    """Raise on every rank of the mesh unless every rank passes the same
    description: an all_gather of its digest over the whole mesh (a
    collective, so every rank must call it at the same point)."""
    digest = hashlib.sha256(description.encode()).digest()[:8]
    mine = torch.frombuffer(bytearray(digest), dtype=torch.int64).to(
        mesh.device)
    seen = [torch.empty_like(mine) for _ in range(mesh.size)]
    torch.distributed.all_gather(seen, mine)
    seen = torch.cat(seen).tolist()
    if len(set(seen)) != 1:
        raise RuntimeError(
            f"the ranks disagree on a captured program's key: rank "
            f"{mesh.rank} has {description!r}; the digests of ranks "
            f"0..{mesh.size - 1} are {seen}")


@dataclasses.dataclass
class Entry:
    """One key's buffers of the copied inputs and, on CUDA, its graph, the
    graph's static outputs, the kernel launches one replay makes
    (`counters.rise`) and the graph's nodes by type (`trace.graph_nodes`)."""

    buffers: list
    graph: object = None
    outputs: object = None
    launches: dict = dataclasses.field(default_factory=dict)
    nodes: dict = dataclasses.field(default_factory=dict)
    capture_s: float = 0.0


class Captured:
    """A body captured once per static key and replayed on later calls.

    `__call__(key, inputs, body, held=0, mesh=None)`: `key` is the hashable
    static configuration, `inputs` the tensors the body reads (all on one
    device; the first `held` of them read where they lie), and
    `body(*tensors)` computes the outputs (a nest of tensors) from the held
    inputs and the buffers; it is called only to warm up and to capture,
    or on every call where nothing is captured. `mesh`: the mesh whose
    collectives the body issues; every input is then copied (`held` must
    be 0), and the key holds no address (the module docstring's rule)."""

    def __init__(self, kind: str):
        self.kind = kind
        self.entries: collections.OrderedDict = collections.OrderedDict()

    def __call__(self, key, inputs: Sequence[torch.Tensor], body: Callable,
                 held: int = 0, mesh=None):
        devices = {t.device for t in inputs}
        if len(devices) != 1:
            raise ValueError(f"{self.kind}: the inputs lie on {devices}, "
                             "not on one device")
        if mesh is not None and held:
            raise ValueError(f"{self.kind}: on a mesh every input is copied "
                             "(held must be 0)")
        (device,) = devices
        shapes = tuple((tuple(t.shape), t.dtype) for t in inputs)
        full_key = (key, device, shapes,
                    mesh if mesh is not None else
                    tuple((t.data_ptr(), t.stride()) for t in inputs[:held]))
        entry = self.entries.get(full_key)
        if entry is None:
            if mesh is not None and mesh.distributed:
                check_ranks_agree(repr((self.kind, key, shapes, device.type,
                                        mesh.axis_names, mesh.axis_sizes)),
                                  mesh)
            entry = Entry(buffers=[t.detach().clone() for t in inputs[held:]])
            args = [t.detach() for t in inputs[:held]] + entry.buffers
            if captures_on(device, mesh):
                out = self._warm_up(args, body, device)
                self._capture(entry, args, body, device)
            else:
                with trace.call(self.kind, device, False).span("body"):
                    out = _clone(body(*args))
            self.entries[full_key] = entry
            for t in inputs[:held]:
                weakref.finalize(t.untyped_storage(), _evict, self.entries,
                                 full_key).atexit = False
            while len(self.entries) > MAX_ENTRIES:
                self.entries.popitem(last=False)
            return out
        self.entries.move_to_end(full_key)
        if entry.graph is None:
            with trace.call(self.kind, device, False).span("body"):
                self._copy_in(entry, inputs[held:])
                return _clone(body(*[t.detach() for t in inputs[:held]],
                                   *entry.buffers))
        call = trace.call(self.kind, device, True, entry.nodes)
        with call.span(trace.COPY_IN):
            self._copy_in(entry, inputs[held:])
        with call.span("launch"):
            entry.graph.replay()
        counters.add(entry.launches)
        with call.span(trace.COPY_OUT):
            return _clone(entry.outputs)

    @staticmethod
    def _copy_in(entry: Entry, inputs) -> None:
        """The copied inputs into the entry's buffers, where they do not lie
        in them already."""
        with torch.no_grad():
            for buf, t in zip(entry.buffers, inputs):
                if t.data_ptr() != buf.data_ptr() or t.stride() != buf.stride():
                    buf.copy_(t)

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
            trace.prepare(device)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.perf_counter()
            before = counters.snapshot()
            with torch.cuda.graph(graph, pool=pool,
                                  stream=_warm_streams[device],
                                  capture_error_mode=_capture_mode()):
                with trace.capturing(device):
                    outputs = body(*args)
            _evicted_in_capture.clear()
            entry.launches = counters.rise(before, counters.snapshot())
            counters.add(entry.launches, -1)
            entry.nodes = trace.graph_nodes(graph)
            graph.instantiate()
            entry.capture_s = time.perf_counter() - t0
        entry.graph, entry.outputs = graph, outputs
        captures[self.kind] += 1
