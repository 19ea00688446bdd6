"""Config-5 memory, run on the card: the port of
`scripts/probe_config5_memory.py`.

BASELINE config 5 is a 6M-Gaussian capture at 4K, Gaussian-sharded over 16
devices (`parallel/gaussian_sharded.py`, `parallel/gaussian_train.py`). The
JAX script compiles that train step ahead of time and prints the compiler's
memory figures. Here the step runs, and the figures are the card's own
allocator statistics:

    python -m gsplat_tpu_torch.config5_memory                  # --mode proxy
    python -m gsplat_tpu_torch.config5_memory --mode ranks [--ranks 2] \\
        [--n-total 6000000]
    python -m gsplat_tpu_torch.config5_memory --device cpu --n-total 2048 \\
        --width 256 --height 128 --max-intersections 65536 [--mode ranks]

--mode proxy, the script's strategy B: the captured single-device step
(`make_train_step`) at one shard's shapes (N_TOTAL / D Gaussians, the whole
3840x2048 target, ssim_weight 0): one warm-up and capture, then STEPS
replays. Then the eager body (`make_eager_train_step`) takes as many steps
from a second copy of the same state, measured apart (the captured step
dropped and the cache emptied between the two). The fragment exchange's
bytes are added analytically, by the script's formula.

--mode ranks, the counterpart of the script's strategy A (the multi-device
program with its collectives): `make_gaussian_sharded_train_step` over
--ranks ranks sharing the card (NCCL, `multihost.launch(share_card=True)`;
gloo on the CPU), the --n-total scene split by rows. The per-source stream
capacity and the per-destination capacity are measured first, not taken
from the script's 16-shard constants: 1.15x the largest demand, each shard
binned in turn in this process before the ranks come up
(`measure_capacities`). Each rank runs the captured step, then the eager
body from the same state, and reports its memory and ms.

The memory fields carry the names of JAX's `memory_analysis()` where the
meaning matches:
  argument_size_in_bytes  the step's state: parameters, Adam's moments and
                          counts, the cameras and the targets;
  output_size_in_bytes    what the step returns, and the gradients it
                          leaves in the parameters' .grad (JAX returns a new
                          state; the port writes it in place);
  peak_memory_in_bytes    torch.cuda.max_memory_allocated over the steps,
                          above the allocation before the state was made;
  temp_size_in_bytes      the peak less the arguments and the outputs;
  max_memory_reserved     what the caching allocator held at most (graph
                          pools included).
On the CPU no allocator keeps these statistics: each field is null, and the
run is otherwise the same.

The scene is `random_scene` seeded 0, SH degree 3, as the script's
`random_scene(key(0), N, sh_degree=3)`, with one cut of the workload: every
log-scale moved by LOG_SCALE_SHIFT, -ln 2. random_scene's scales are drawn
for the 1920-wide bench frame; at 3840 wide each splat spans twice the
pixels, and some rects then pass the config's max_tiles_per_gaussian of 64,
which the binning truncates and flags as overflow. The shift halves each
splat's extent, so that it covers at 4K the tiles it covers at 1080p: about
a quarter of the fragments the script's draw makes, and a lighter load
than the script's capacities size for. `config5_scene(n, dev, 0.0)` is the
script's own draw; `proxy` and `ranks` take the shift for a measurement
of it (chip_smoke.py's phase 21), and every report counts the scene's
rects past K_max (`kmax_pressure`).

Prints one JSON object: the script's keys (`config`, `mode`, `memory`,
`a2a_wire_bytes_analytic`) and `device` (the card's name and power limit
from nvidia-smi), with the steps' report beside them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import tempfile
import time

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops.binning import bin_gaussians
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.ops.projection import project_gaussians
from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS
from gsplat_tpu_torch.utils.bench import bench_scene, device_name

# The script's constants (scripts/probe_config5_memory.py:29-46): 6M
# splats, 16 shards, 3840x2048 (64 tile rows, divisible by 16 shards), and
# the per-(source, destination) fragment capacity it sizes for 16 shards.
N_TOTAL, D = 6_000_000, 16
N_SHARD = N_TOTAL // D
W, H = 3840, 2048
PER_DEST_CAP = 550_000
# Its RenderConfig, less `impl`, which selects the TPU rasterizer and has no
# counterpart in the port (config.py).
CONFIG5 = dict(
    width=W, height=H, tile_size=32, max_intersections=8_800_000,
    max_tiles_per_gaussian=64, block_size=32, max_per_tile=8192,
    binning="packed", pallas_block_size=128,
    stream_format="packed16", gather_backward="bf16", grad_readout="bf16",
    segment_sum="pallas",
)
LR = 1e-2
# Replays after the warm-up and capture; the eager body takes as many steps
# plus one.
STEPS = 3
# Capacity headroom over the largest measured demand (the bench's
# suggested_max_intersections rule), and the stream capacity's rounding.
HEADROOM = 1.15
CAP_ALIGN = 2048
LOG_SCALE_SHIFT = -math.log(2.0)
# Seconds the ranks of --mode ranks may take.
RANKS_TIMEOUT_S = 1800
MEMORY_FIELDS = ("argument_size_in_bytes", "output_size_in_bytes",
                 "peak_memory_in_bytes", "temp_size_in_bytes",
                 "max_memory_reserved")


def config5_cfg(width: int = W, height: int = H,
                max_intersections: int | None = None) -> RenderConfig:
    """The script's config, at another size for the reduced runs."""
    kw = dict(CONFIG5, width=width, height=height)
    if max_intersections is not None:
        kw["max_intersections"] = max_intersections
    return RenderConfig(**kw)


def config5_scene(n: int, device, shift: float = LOG_SCALE_SHIFT
                  ) -> GaussianScene:
    """random_scene(n, SH 3) from a generator seeded 0 on `device` (the
    bench's scene), its log-scales moved by `shift` (the module
    docstring)."""
    scene = bench_scene(n, device=device)
    if shift:
        scene = dataclasses.replace(scene,
                                    log_scales=scene.log_scales + shift)
    return scene


def a2a_wire_bytes_analytic(d: int = D, per_dest: int = PER_DEST_CAP) -> int:
    """The script's formula: per rank, the packed16 wire's 5 payload rows
    and the key row forward and 5 rows back, D blocks of per_dest int32."""
    return (6 + 5) * d * per_dest * 4


def device_report(device) -> dict:
    """{"name", "power_limit"} of nvidia-smi's line; "cpu" off the card."""
    name, _, limit = device_name(device).partition(",")
    return {"name": name.strip(), "power_limit": limit.strip() or None}


def kmax_pressure(scene: GaussianScene, cam: Camera,
                  cfg: RenderConfig) -> dict:
    """Visible splats whose tile rect passes K_max (the binning truncates
    them and flags overflow), and the largest rect, at one camera."""
    with torch.no_grad():
        proj = project_gaussians(scene, cam, cfg)
        r = proj.rect
        area = (torch.clamp_min(r[:, 2] - r[:, 0], 0)
                * torch.clamp_min(r[:, 3] - r[:, 1], 0))
        area = torch.where(proj.mask, area, 0)
    return {"visible": int(proj.mask.sum()),
            "over_kmax": int((area > cfg.max_tiles_per_gaussian).sum()),
            "max_rect_tiles": int(area.max()),
            "kmax": cfg.max_tiles_per_gaussian}


def _rows(scene: GaussianScene, lo: int, hi: int) -> GaussianScene:
    return GaussianScene(**{f.name: getattr(scene, f.name)[lo:hi]
                            for f in dataclasses.fields(scene)})


def measure_capacities(scene: GaussianScene, cams, cfg: RenderConfig,
                       d: int) -> dict:
    """The stream capacities of a Gaussian-sharded run of `scene` over d
    row shards: each source's intersections at each camera (one shard
    binned at a time), the per-source capacity HEADROOM x their largest,
    rounded up to CAP_ALIGN; then `fragment_occupancy` at that capacity, the
    per-destination capacity its largest suggestion (HEADROOM x the largest
    (source, destination) segment). Returns {"demand" [view][source],
    "max_intersections", "per_dest_capacity", "occupancy" (per view)}."""
    from gsplat_tpu_torch.parallel.gaussian_sharded import (
        _src_cfg_for,
        fragment_occupancy,
    )

    n = scene.num_gaussians
    if n % d:
        raise ValueError(f"{n} Gaussians not divisible by {d} shards")
    src_cfg = _src_cfg_for(cfg)
    demand = []
    for cam in cams:
        row = []
        for s in range(d):
            with torch.no_grad():
                proj = project_gaussians(_rows(scene, s * n // d,
                                               (s + 1) * n // d), cam, src_cfg)
                row.append(int(bin_gaussians(proj, src_cfg).num_intersections))
            del proj
        demand.append(row)
    cap = int(max(max(r) for r in demand) * HEADROOM)
    cap += (-cap) % CAP_ALIGN
    sized = dataclasses.replace(cfg, max_intersections=cap)
    occ = [fragment_occupancy(scene, cam, sized, d) for cam in cams]
    return {"demand": demand, "max_intersections": cap,
            "per_dest_capacity": max(o["suggested_per_dest_capacity"]
                                     for o in occ),
            "occupancy": [{k: o[k] for k in ("max_segment",
                                              "total_intersections",
                                              "per_dest_totals")}
                          for o in occ]}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _allocated(dev) -> int:
    _sync(dev)
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def _fresh_stats(dev) -> int:
    """Empty the cache, reset the peaks; the allocation now."""
    if dev.type == "cuda":
        _sync(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return _allocated(dev)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _flat(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return []


def state_bytes(optimizer, cams, targets) -> int:
    """The step's state: parameters, Adam's moments and counts, cameras and
    targets."""
    params = [g["params"][0] for g in optimizer.param_groups]
    moments = [t for p in params for t in _flat(optimizer.state.get(p, {}))]
    cam_t = [getattr(c, f.name) for c in cams for f in dataclasses.fields(c)]
    return _nbytes(params + moments + cam_t + [targets]
                   + ([optimizer.count] if getattr(optimizer, "count", None)
                      is not None else []))


def memory_fields(dev, base: int, args: int, outs: int) -> dict:
    """The memory fields (module docstring); null off the card."""
    if dev.type != "cuda":
        return dict.fromkeys(MEMORY_FIELDS)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    return {"argument_size_in_bytes": args, "output_size_in_bytes": outs,
            "peak_memory_in_bytes": peak,
            "temp_size_in_bytes": peak - args - outs,
            "max_memory_reserved": torch.cuda.max_memory_reserved(dev)}


def _copy(scene: GaussianScene) -> GaussianScene:
    return GaussianScene(**{f.name: getattr(scene, f.name).detach().clone()
                            for f in dataclasses.fields(scene)})


def run_steps(step, train: GaussianScene, cams, targets, n: int,
              on_step=None) -> dict:
    """n steps of `step` on `train`, view i % len(cams) at step i, each but
    the first timed (a host clock around a synchronised step, and CUDA
    events on the card). The single-device and tile-sharded contract
    (loss, aux, (tap, visible)) or the Gaussian-sharded one (metrics,
    (tap, visible)); on_step(tap, visible) sees every step's. Returns the
    losses, whether any step overflowed, whether every loss (and every
    step's gradients, where the contract reports them) stayed finite, the
    last step's tap gradients and visibility, the final parameters and the
    medians (host_ms; device_ms, None off the card)."""
    dev = train.means.device
    losses, overflow, finite, host, device = [], [], [], [], []
    for i in range(n):
        v = i % len(cams)
        _sync(dev)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = step(train, [cams[v]], targets[v:v + 1])
        if dev.type == "cuda":
            end.record()
        _sync(dev)
        if i:
            host.append((time.perf_counter() - t0) * 1e3)
            if dev.type == "cuda":
                device.append(start.elapsed_time(end))
        if len(out) == 2:
            metrics, (tap, vis) = out
            loss = metrics["loss"]
        else:
            loss, metrics, (tap, vis) = out
            finite.append(metrics["grads_finite"])
        overflow.append(metrics["overflow"])
        losses.append(loss)
        if on_step is not None:
            on_step(tap, vis)
    losses = torch.stack(losses).detach()
    return dict(
        losses=losses, tap=tap.detach().clone(), visible=vis.clone(),
        params={f: getattr(train, f).detach().clone() for f in SCENE_FIELDS},
        overflow=bool(torch.stack(overflow).any()),
        finite=bool(torch.isfinite(losses).all()) and all(
            bool(f) for f in finite),
        host_ms=statistics.median(host) if host else None,
        device_ms=statistics.median(device) if device else None)


def fresh_run(make_step, init: GaussianScene, cams, targets, n: int) -> dict:
    """`run_steps` of make_step(optimizer) from a copy of `init`, the
    allocator's cache emptied and its peaks reset first: the run, its
    memory fields, and the step and its state (for later checks)."""
    from gsplat_tpu_torch.train.loop import make_optimizer

    dev = init.means.device
    base = _fresh_stats(dev)
    train = _copy(init)
    opt = make_optimizer(train, LR)
    step = make_step(opt)
    run = run_steps(step, train, cams, targets, n)
    grads = [getattr(train, f).grad for f in SCENE_FIELDS]
    run["memory"] = memory_fields(
        dev, base, state_bytes(opt, cams, targets[:len(cams)]),
        _nbytes([run["tap"], run["visible"]] + grads))
    return dict(run, step=step, train=train)


def run_pairs(a: dict, b: dict) -> dict:
    """The outputs of two runs, paired by name."""
    return dict(losses=(a["losses"], b["losses"]), tap_grads=(a["tap"], b["tap"]),
                visible=(a["visible"], b["visible"]),
                **{f"param {f}": (a["params"][f], b["params"][f])
                   for f in a["params"]})


def differing(pairs: dict) -> dict:
    """The pairs (name: (a, b)) that are not bit-identical, each with its
    largest difference and whether it is within rtol 5e-3 / atol 1e-5."""
    out = {}
    for name, (a, b) in pairs.items():
        if torch.equal(a, b):
            continue
        a, b = a.double(), b.double()
        out[name] = dict(max_abs=float((a - b).abs().max()),
                         within=bool(torch.allclose(a, b, rtol=5e-3,
                                                    atol=1e-5)))
    return out


def compare_runs(eager: dict, captured: dict) -> dict:
    """The captured run against the eager one, and each run's report."""
    differ = differing(run_pairs(captured, eager))
    return {"bit_identical": not differ, "differ": differ,
            "losses": captured["losses"].tolist(),
            "eager_losses": eager["losses"].tolist(),
            "overflow": eager["overflow"] or captured["overflow"],
            "finite": eager["finite"] and captured["finite"],
            "replay_ms": captured["host_ms"], "eager_ms": eager["host_ms"]}


def proxy_inputs(n: int, cfg: RenderConfig, dev,
                 shift: float = LOG_SCALE_SHIFT) -> tuple:
    """The proxy's scene (`config5_scene`), camera (Camera.default) and
    target of zeros (the script's)."""
    scene = config5_scene(n, dev, shift)
    cam = Camera.default(cfg.width, cfg.height, device=dev)
    return scene, cam, torch.zeros(
        (1, cfg.padded_height, cfg.padded_width, 3), device=dev)


def proxy_run(inputs: tuple, cfg: RenderConfig, captured: bool) -> dict:
    """STEPS + 1 steps of the captured step (`make_train_step`) or of its
    eager body (`make_eager_train_step`), ssim_weight 0, from a copy of the
    proxy's scene; the step dropped after (its graph and pool with it)."""
    from gsplat_tpu_torch.train.loop import make_eager_train_step, make_train_step

    scene, cam, targets = inputs
    make = make_train_step if captured else make_eager_train_step
    run = fresh_run(lambda opt: make(cfg, opt, 0.0), scene, [cam], targets,
                    STEPS + 1)
    del run["step"], run["train"]
    return run


def proxy(n: int, cfg: RenderConfig, dev,
          shift: float = LOG_SCALE_SHIFT) -> dict:
    """Strategy B: the single-device step at one shard's shapes, captured
    then eager (module docstring), and the scene's K_max pressure."""
    inputs = proxy_inputs(n, cfg, dev, shift)
    captured = proxy_run(inputs, cfg, True)
    eager = proxy_run(inputs, cfg, False)
    return {"memory": captured["memory"], "eager_memory": eager["memory"],
            "steps": compare_runs(eager, captured),
            "kmax_pressure": kmax_pressure(*inputs[:2], cfg)}


def sharded_run(cfg: RenderConfig, mesh, local: GaussianScene, cams, bands,
                per_dest: int, n: int, captured: bool,
                ssim_weight: float = 0.0) -> dict:
    """`fresh_run` of this rank's Gaussian-sharded step, captured
    (`make_gaussian_sharded_train_step`) or its eager body, from a copy of
    `local`."""
    from gsplat_tpu_torch.parallel import gaussian_train as gt

    make = (gt.make_gaussian_sharded_train_step if captured
            else gt.make_eager_gaussian_sharded_train_step)
    cap = local.num_gaussians * mesh.size_of("gauss")
    return fresh_run(lambda opt: make(cfg, mesh, opt, cap,
                                      ssim_weight=ssim_weight,
                                      per_dest_capacity=per_dest),
                     local, cams, bands, n)


def rank_steps(rank: int, n_total: int, cfg: RenderConfig, per_dest: int,
               shift: float, device: str) -> dict:
    """One rank of --mode ranks: this rank's rows of the scene, STEPS + 1
    steps of the captured Gaussian-sharded step, then as many of the eager
    body from the same state, at targets of zero (the script's), one view
    (Camera.default)."""
    from gsplat_tpu_torch.parallel.gaussian_sharded import shard_scene
    from gsplat_tpu_torch.parallel.sharding import local_tile_cfg, make_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    d = torch.distributed.get_world_size()
    mesh = make_mesh({"gauss": d}, dev)
    local = shard_scene(config5_scene(n_total, dev, shift), mesh)
    cams = [Camera.default(cfg.width, cfg.height, device=dev)]
    bands = torch.zeros((1, local_tile_cfg(cfg, d).height, cfg.padded_width,
                         3), device=dev)
    runs = {}
    for captured in (True, False):
        runs[captured] = sharded_run(cfg, mesh, local, cams, bands, per_dest,
                                     STEPS + 1, captured)
        del runs[captured]["step"], runs[captured]["train"]
    return {"rank": mesh.rank, "memory": runs[True]["memory"],
            "eager_memory": runs[False]["memory"],
            "steps": compare_runs(runs[False], runs[True])}


def ranks(n_total: int, d: int, cfg: RenderConfig, dev,
          shift: float = LOG_SCALE_SHIFT) -> dict:
    """Strategy A's counterpart: capacities measured here, then d ranks
    (module docstring)."""
    from gsplat_tpu_torch.parallel import multihost
    from gsplat_tpu_torch.parallel.gaussian_sharded import exchange_bytes

    scene = config5_scene(n_total, dev, shift)
    cam = Camera.default(cfg.width, cfg.height, device=dev)
    pressure = kmax_pressure(scene, cam, cfg)
    caps = measure_capacities(scene, [cam], cfg, d)
    del scene
    _fresh_stats(dev)
    print(f"[config5_memory] per-source capacity {caps['max_intersections']}"
          f", per-destination capacity {caps['per_dest_capacity']} (demand "
          f"per source {caps['demand']})", file=sys.stderr, flush=True)
    sized = dataclasses.replace(cfg, max_intersections=caps["max_intersections"])
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        res = multihost.launch(
            rank_steps, d,
            (n_total, sized, caps["per_dest_capacity"], shift, str(dev)),
            backend=backend, out_dir=tmp, device=str(dev),
            timeout_s=RANKS_TIMEOUT_S, share_card=backend == "nccl")
    wire = exchange_bytes(sized, d, caps["per_dest_capacity"])
    return {"memory": [r["memory"] for r in res],
            "eager_memory": [r["eager_memory"] for r in res],
            "steps": [dict(r["steps"], rank=r["rank"]) for r in res],
            "a2a_wire_bytes_analytic": a2a_wire_bytes_analytic(
                d, caps["per_dest_capacity"]),
            "exchange_bytes_per_step": wire, "capacity": caps,
            "kmax_pressure": pressure, "backend": backend}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("gsplat_tpu_torch.config5_memory")
    ap.add_argument("--mode", default="proxy", choices=["proxy", "ranks"])
    ap.add_argument("--ranks", type=int, default=2,
                    help="ranks of --mode ranks, sharing the card")
    ap.add_argument("--n-total", type=int, default=N_TOTAL)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--max-intersections", type=int,
                    default=CONFIG5["max_intersections"],
                    help="the proxy's stream capacity (--mode ranks "
                         "measures its own)")
    ap.add_argument("--device", default="cuda",
                    help="ranks: NCCL ranks sharing the card, or gloo ranks "
                         "on the CPU")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", 0)
    cfg = config5_cfg(args.width, args.height, args.max_intersections)
    out = {"config": {"n_total": args.n_total, "shards": D,
                      "n_shard": args.n_total // D,
                      "resolution": f"{cfg.width}x{cfg.height}",
                      "per_dest_capacity": PER_DEST_CAP,
                      "max_intersections": cfg.max_intersections,
                      "log_scale_shift": LOG_SCALE_SHIFT}}
    if args.mode == "proxy":
        out["mode"] = "per-shard-proxy-1dev"
        res = proxy(args.n_total // D, cfg, dev)
        out["a2a_wire_bytes_analytic"] = a2a_wire_bytes_analytic()
    else:
        out["mode"] = f"gaussian-sharded-{args.ranks}-ranks"
        out["config"].update(shards=args.ranks,
                             n_shard=args.n_total // args.ranks)
        res = ranks(args.n_total, args.ranks, cfg, dev)
        out["config"].update(
            per_dest_capacity=res["capacity"]["per_dest_capacity"],
            max_intersections=res["capacity"]["max_intersections"])
    out.update(res)
    out["device"] = device_report(dev)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
