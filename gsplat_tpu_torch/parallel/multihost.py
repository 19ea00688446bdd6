"""Process-group set-up and helpers (port of
`gsplat_tpu.parallel.multihost`), and a launcher of one process per rank.

A multi-card run is one process per card, started by `torchrun`:

    torchrun --standalone --nproc-per-node 4 -m gsplat_tpu_torch.cli bench \\
        --sharded-tiles 4 --dist-backend nccl

`initialize` reads torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT) and brings up the process group on the backend the caller
names; with no environment and no arguments it is a no-op, as the JAX
function is in one process. The backend is never chosen here: NCCL for one
card per rank, gloo on the CPU; several ranks sharing one card run on
either.

Several NCCL ranks on one card: NCCL refuses two ranks of one host on one
GPU ("Duplicate GPU detected"), the host being its hash of the host name.
With `launch(..., share_card=True)` each rank sets, before the group comes
up, NCCL_HOSTID=rank<k> (a host hash of its own, so NCCL takes the ranks
for hosts of their own), NCCL_SOCKET_IFNAME=lo and NCCL_IB_DISABLE=1 (they
talk over NCCL's socket transport on the loopback): `share_card_env`. On
an H100 (NCCL 2.28.9) two such ranks came up ("nNodes 2 localRanks 1",
channels "via NET/Socket"), ran all_reduce, all_gather and
all_to_all_single eagerly, and replayed them from CUDA graphs captured in
each of the `thread_local`, `global` and `relaxed` modes; their
`destroy_process_group` did not return, so `launch` ends such ranks with
`os._exit` once their results are written. The loopback's TCP carries
every byte, so their times are not those of NVLink.

`launch` starts `nprocs` ranks of a function with the spawn start method
(never fork after CUDA) through `torch.multiprocessing`, joins them with a
time limit (one failed rank, or the limit, stops every rank and raises) and
hands back each rank's result.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import time

import torch

from gsplat_tpu_torch.parallel.sharding import Mesh, make_mesh

# Seconds a collective may wait before the process group gives up.
DEFAULT_TIMEOUT_S = 600


def share_card_env(rank: int) -> dict:
    """The environment under which NCCL takes rank `rank` for a host of its
    own, so that several ranks may share one card (the module docstring)."""
    return {"NCCL_HOSTID": f"rank{rank}", "NCCL_SOCKET_IFNAME": "lo",
            "NCCL_IB_DISABLE": "1"}


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Bring up the process group. World size and rank come from the
    arguments, else from torchrun's environment; init_method defaults to
    `env://` (MASTER_ADDR, MASTER_PORT). A no-op when a group is already up,
    or for one process with neither an init_method nor MASTER_ADDR. The
    backend must be named ('nccl' or 'gloo'). `device`, a CUDA device,
    becomes the process's current device."""
    dist = torch.distributed
    if dist.is_initialized():
        return
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            if world_size == 1:
                return  # one process: nothing to bring up
            raise ValueError(
                f"initialize: world size {world_size} needs an init_method "
                "or torchrun's MASTER_ADDR / MASTER_PORT")
        init_method = "env://"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"initialize: name the backend, 'nccl' or 'gloo' "
                         f"(got {backend!r})")
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: a bare 'cuda' under torchrun becomes
    cuda:LOCAL_RANK (one card per rank); an indexed device, e.g. cuda:0 for
    several ranks sharing one card over gloo, is kept."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and \
            "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def global_mesh(axis_sizes: dict[str, int], device="cuda") -> Mesh:
    """The mesh over every rank of the process group."""
    return make_mesh(axis_sizes, device)


def _world() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_local_batch(global_batch: int) -> tuple[int, int]:
    """(local_batch, offset) of this process's slice of a data-parallel
    batch."""
    n, r = _world()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} "
                         "processes")
    local = global_batch // n
    return local, r * local


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0)."""
    return _world()[1] == 0


# ---- the launcher ---------------------------------------------------------


def _rank_main(rank, nprocs, fn, args, backend, init_method, device,
               timeout_s, out_dir, share_card):
    if share_card:
        os.environ.update(share_card_env(rank))
    initialize(backend, init_method, nprocs, rank, device, timeout_s)
    try:
        result = fn(rank, *args)
    except SystemExit as e:
        # torch.multiprocessing hands an exception's traceback to the
        # parent, but of an exit only its code.
        raise RuntimeError(f"rank {rank} exited: {e}") from e
    path = os.path.join(out_dir, f"rank_{rank:05d}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    if share_card and backend == "nccl":
        # The group's teardown does not return for NCCL ranks sharing a
        # card; the result is written, so the process ends here.
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    torch.distributed.destroy_process_group()


def launch(fn, nprocs: int, args=(), *, backend: str, out_dir: str,
           init_method: str | None = None, device=None,
           timeout_s: float = DEFAULT_TIMEOUT_S,
           share_card: bool = False) -> list:
    """Run fn(rank, *args) in `nprocs` spawned processes, each a rank of one
    process group on `backend`, and return [rank 0's result, ...]. fn and
    args are pickled, so fn must be importable by name from a module that
    does not import what the children must not load. out_dir receives the
    results (and, without an init_method, the `file://` rendezvous store).
    Every rank is stopped, and RuntimeError raised, as soon as one fails
    or when timeout_s passes. share_card: each rank sets
    `share_card_env(rank)`, so that NCCL ranks may share one card."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"rank_{r:05d}.pkl") for r in range(nprocs)]
    if init_method is None:
        store = os.path.join(os.path.abspath(out_dir), "store")
        paths.append(store)
        init_method = f"file://{store}"
    for p in paths:
        if os.path.exists(p):
            os.unlink(p)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, (nprocs, fn, args, backend, init_method, device,
                     timeout_s, out_dir, share_card), nprocs, join=False,
        start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"launch failed: ranks did not finish "
                                   f"within {timeout_s} s")
    except (torch.multiprocessing.ProcessRaisedException,
            torch.multiprocessing.ProcessExitedException) as e:
        raise RuntimeError(f"launch failed:\n{e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    results = []
    for p in paths[:nprocs]:
        with open(p, "rb") as f:
            results.append(pickle.load(f))
    return results
