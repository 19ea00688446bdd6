"""Rank bodies of the port's multi-process tests (`test_torch_sharding.py`,
`test_torch_gaussian_sharded.py`, `test_torch_parallel_jit.py`). They run
in spawned processes, one per rank of a gloo process group on the CPU, so
this module imports torch and the port only, never JAX. Each body runs
every case of one world size and returns plain numpy results; the test
modules hold them against the JAX package."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gsplat_tpu_torch import RenderConfig
from gsplat_tpu_torch.convert import (
    camera_from_numpy,
    scene_from_numpy,
    scene_to_numpy,
)
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.parallel.sharding import make_mesh

CPU = "cpu"


def failing_rank(rank: int, how: str) -> int:
    """Rank 1 fails as `how` says ('raise', 'exit' or 'hang'); every other
    rank waits for it in a collective."""
    if rank == 1:
        if how == "raise":
            raise ValueError("rank 1 raised")
        if how == "exit":
            raise SystemExit("rank 1 exited")
        time.sleep(3600)
    torch.distributed.barrier()
    return rank


def _scene(d) -> GaussianScene:
    return scene_from_numpy(**d, device=CPU)


def _grads(scene: GaussianScene) -> dict:
    return {f: getattr(scene, f).grad.detach().numpy().copy()
            for f in ("means", "log_scales", "quats", "opacity_logits", "sh")}


def _leaves(scene: GaussianScene) -> GaussianScene:
    return GaussianScene(**{k: torch.from_numpy(v.copy()).requires_grad_(True)
                            for k, v in scene_to_numpy(scene).items()})


def _cfg(inp, **kw) -> RenderConfig:
    return RenderConfig(**dict(inp["cfg"], **kw))


# ---- tile-sharded ---------------------------------------------------------


def _render_tiles(inp, mesh, cam):
    from gsplat_tpu_torch.parallel.sharding import render_tile_sharded

    img, trans, ovf = render_tile_sharded(_scene(inp["scene_render"]), cam,
                                          _cfg(inp), mesh)
    return {"image": img.numpy(), "trans": trans.numpy(),
            "overflow": bool(ovf)}


def _tile_grads(inp, mesh, cam, key, **kw):
    """d mean|image - target| / d scene through render_tile_sharded."""
    from gsplat_tpu_torch.parallel.sharding import render_tile_sharded

    scene = _leaves(_scene(inp[f"scene_{key}"]))
    img, _, ovf = render_tile_sharded(scene, cam, _cfg(inp, **kw), mesh)
    target = torch.from_numpy(inp[f"target_{key}"])
    torch.mean(torch.abs(img - target)).backward()
    return {"image": img.detach().numpy(), "overflow": bool(ovf),
            "grads": _grads(scene)}


def _sharded_steps(inp, mesh, cam, key, steps, lr, batch, ssim_weight,
                   **kw):
    """`steps` sharded train steps on `batch` copies of one view; returns
    the losses, the first step's all-reduced gradients and tap gradients,
    aux flags, and the final scene."""
    from gsplat_tpu_torch.parallel.train_step import (
        make_sharded_train_step,
        shard_batch,
    )
    from gsplat_tpu_torch.train.loop import make_optimizer

    cfg = _cfg(inp, **kw)
    scene = _scene(inp[f"scene_{key}"])
    opt = make_optimizer(scene, lr)
    step = make_sharded_train_step(cfg, mesh, opt, ssim_weight=ssim_weight)
    target = torch.from_numpy(inp[f"target_{key}"])
    targets = torch.nn.functional.pad(
        target, (0, 0, 0, cfg.padded_width - cfg.width, 0,
                 cfg.padded_height - cfg.height))[None].repeat(batch, 1, 1, 1)
    cams, bands = shard_batch([cam] * batch, targets, mesh)
    out = {"loss": []}
    for i in range(steps):
        loss, aux, (tap, visible) = step(scene, cams, bands)
        out["loss"].append(float(loss))
        if i == 0:
            out["grads"] = _grads(scene)
            out["tap"] = tap.numpy().copy()
            out["visible"] = visible.numpy().copy()
            out["overflow"] = bool(aux["overflow"])
            out["num_intersections"] = int(aux["num_intersections"])
    out["scene"] = scene_to_numpy(scene)
    return out


def _fit_mesh(inp, mesh, cam, out_dir):
    """fit(mesh=...) with densification and checkpoints; what this rank
    printed comes back too (only the primary rank logs)."""
    import contextlib
    import io

    from gsplat_tpu_torch.train.loop import fit

    cfg = _cfg(inp, binning="tiered")
    scene = _scene(inp["scene_fit"]).pad_to(192)
    target = torch.from_numpy(inp["target_fit"])
    ckpt = os.path.join(out_dir, "fit_ckpt")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trained, metrics = fit(
            scene, [cam, cam], torch.stack([target, target]), cfg, steps=12,
            lr=5e-2, batch=2, ssim_weight=0.2, seed=0, log_every=4,
            densify_every=4, densify_until=8, densify_grad_threshold=1e-5,
            checkpoint_every=6, checkpoint_dir=ckpt, mesh=mesh)
    return {"metrics": metrics, "scene": scene_to_numpy(trained),
            "printed": printed.getvalue(),
            "ckpts": sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []}


def sharding_world(rank, world, inp, out_dir):
    """Every tile-sharded case of one world size (2 or 4 ranks)."""
    torch.set_num_threads(1)
    cam = camera_from_numpy(**inp["cam"], device=CPU)
    tiles = make_mesh({"tiles": world}, CPU)
    out = {"render": _render_tiles(inp, tiles, cam)}
    if world == 2:
        return out
    grid = make_mesh({"data": 2, "tiles": 2}, CPU)
    out["tiered_grads"] = _tile_grads(inp, tiles, cam, "tiered",
                                      binning="tiered")
    out["packed16"] = _tile_grads(inp, tiles, cam, "p16", binning="tiered",
                                  stream_format="packed16")
    out["l1_loss"] = _sharded_steps(inp, grid, cam, "loss", 1, 0.0, 2, 0.0)
    out["ssim_2"] = _sharded_steps(inp, grid, cam, "ssim", 1, 0.0, 2, 0.2)
    out["ssim_4"] = _sharded_steps(inp, tiles, cam, "ssim", 1, 0.0, 2, 0.2)
    out["train"] = _sharded_steps(inp, grid, cam, "train", 11, 5e-2, 4, 0.2)
    out["train16"] = _sharded_steps(inp, grid, cam, "train16", 6, 1e-2, 4,
                                    0.0, binning="tiered",
                                    stream_format="packed16")
    out["fit"] = _fit_mesh(inp, grid, cam, out_dir)
    from gsplat_tpu_torch.utils.bench import run_bench

    out["bench"] = run_bench(
        num_gaussians=2000, width=64, height=64, impl="jnp", mode="fwd_bwd",
        iters=1, tile_size=8, max_intersections=1 << 12, block_size=8,
        max_per_tile=256, sharded_tiles=4, ssim_weight=0.2, device=CPU)
    return out


# ---- Gaussian-sharded -----------------------------------------------------


def _render_gauss(inp, mesh, cam, key, per_dest_capacity=None, **kw):
    from gsplat_tpu_torch.parallel.gaussian_sharded import (
        render_gaussian_sharded,
        shard_scene,
    )

    img, trans, ovf = render_gaussian_sharded(
        shard_scene(_scene(inp[f"scene_{key}"]), mesh), cam, _cfg(inp, **kw),
        mesh, per_dest_capacity=per_dest_capacity)
    return {"image": img.numpy(), "trans": trans.numpy(),
            "overflow": bool(ovf)}


def _gauss_grads(inp, mesh, cam, key, loss, **kw):
    """This shard's d loss / d scene through render_gaussian_sharded, loss
    'l1' (mean |image - target|) or 'sq' (mean image^2)."""
    from gsplat_tpu_torch.parallel.gaussian_sharded import (
        render_gaussian_sharded,
        shard_scene,
    )

    local = _leaves(shard_scene(_scene(inp[f"scene_{key}"]), mesh))
    img, _, ovf = render_gaussian_sharded(local, cam, _cfg(inp, **kw), mesh)
    if loss == "l1":
        value = torch.mean(torch.abs(img - torch.from_numpy(inp["target_grad"])))
    else:
        value = torch.mean(img ** 2)
    value.backward()
    return {"image": img.detach().numpy(), "overflow": bool(ovf),
            "grads": _grads(local)}


def _gauss_step(inp, mesh, cam, **kw):
    """One Gaussian-sharded train step (lr 1e-2, L1 + 0.2 DSSIM) from the
    padded training fixture."""
    from gsplat_tpu_torch.parallel.gaussian_train import (
        make_gaussian_sharded_train_step,
        shard_train_state,
    )
    from gsplat_tpu_torch.parallel.sharding import local_tile_cfg

    cfg = _cfg(inp, **kw)
    scene = _scene(inp["scene_train"])
    local, opt = shard_train_state(scene, mesh, lr=1e-2)
    step = make_gaussian_sharded_train_step(cfg, mesh, opt,
                                            scene.num_gaussians,
                                            ssim_weight=0.2)
    lcfg = local_tile_cfg(cfg, mesh.size_of("gauss"))
    k = mesh.index("gauss")
    target = torch.from_numpy(inp["target_train"])[None]
    band = target[:, k * lcfg.height:(k + 1) * lcfg.height]
    m, (tap, visible) = step(local, [cam], band)
    return {"loss": float(m["loss"]), "overflow": bool(m["overflow"]),
            "scene": scene_to_numpy(local), "tap": tap.numpy().copy(),
            "visible": visible.numpy().copy()}


def _gauss_fit(inp, mesh, cam, out_dir):
    from gsplat_tpu_torch.parallel.gaussian_train import fit_gaussian_sharded

    trained, metrics = fit_gaussian_sharded(
        _scene(inp["scene_fit"]), [cam],
        torch.from_numpy(inp["target_fit"])[None], _cfg(inp), mesh,
        steps=24, lr=5e-2, log_every=4, densify_every=8,
        densify_grad_threshold=1e-5, densify_until=16)
    ckpt = os.path.join(out_dir, "fit_ckpt")
    fit_gaussian_sharded(
        _scene(inp["scene_fit"]), [cam],
        torch.from_numpy(inp["target_fit"])[None], _cfg(inp), mesh,
        steps=4, lr=1e-2, log_every=2, checkpoint_path=ckpt,
        checkpoint_every=4)
    return {"metrics": metrics, "rows": trained.num_gaussians,
            "ckpt_files": sorted(os.listdir(ckpt))}


def _gauss_ckpt(inp, mesh, cam, out_dir):
    """A per-shard checkpoint after two steps, restored into a fresh shard
    bit for bit; and a shard-layout mismatch refused."""
    from gsplat_tpu_torch.parallel.gaussian_train import (
        load_sharded_checkpoint,
        make_gaussian_sharded_train_step,
        save_sharded_checkpoint,
        shard_train_state,
    )
    from gsplat_tpu_torch.utils.checkpoint import checkpoint_arrays

    cfg = _cfg(inp)
    scene = _scene(inp["scene_train"])
    local, opt = shard_train_state(scene, mesh, lr=1e-2)
    step = make_gaussian_sharded_train_step(cfg, mesh, opt,
                                            scene.num_gaussians)
    k, d = mesh.index("gauss"), mesh.size_of("gauss")
    h = cfg.padded_height // d
    band = torch.from_numpy(inp["target_train"])[None, k * h:(k + 1) * h]
    for _ in range(2):
        step(local, [cam], band)
    path = os.path.join(out_dir, "ckpt")
    save_sharded_checkpoint(path, local, opt, 7, mesh)
    fresh, fresh_opt = shard_train_state(scene, mesh, lr=1e-2)
    restored_step = load_sharded_checkpoint(path, fresh, fresh_opt, mesh)
    a = checkpoint_arrays(local, opt, 7)
    b = checkpoint_arrays(fresh, fresh_opt, restored_step)
    same = sorted(a) == sorted(b) and all(np.array_equal(a[n], b[n]) for n in a)
    refused = ""
    try:
        smaller = shard_train_state(scene.pad_to(scene.num_gaussians + d), mesh)
        load_sharded_checkpoint(path, *smaller, mesh)
    except ValueError as e:
        refused = str(e)
    with np.load(os.path.join(path, f"shard_{k:05d}.npz")) as z:
        rows = {n: z[n].shape[0] for n in z.files}
    return {"same": same, "step": restored_step, "refused": refused,
            "files": sorted(os.listdir(path)), "rows": rows}


def gaussian_world(rank, world, inp, out_dir):
    """Every Gaussian-sharded case of one world size (2 or 4 ranks)."""
    torch.set_num_threads(1)
    cam = camera_from_numpy(**inp["cam"], device=CPU)
    mesh = make_mesh({"gauss": world}, CPU)
    out = {"render": _render_gauss(inp, mesh, cam, "render")}
    if world == 2:
        out["overflow"] = _render_gauss(inp, mesh, cam, "ovf",
                                        per_dest_capacity=8)["overflow"]
        return out
    p16 = dict(stream_format="packed16", gather_backward="bf16",
               grad_readout="bf16", segment_sum="pallas")
    out["grads"] = _gauss_grads(inp, mesh, cam, "grad", "l1")
    out["grads16"] = _gauss_grads(inp, mesh, cam, "grad", "l1", **p16)
    out["bf16"] = _gauss_grads(inp, mesh, cam, "frag", "sq",
                               fragment_format="bf16")
    out["f32"] = _gauss_grads(inp, mesh, cam, "frag", "sq")
    out["render16"] = _render_gauss(inp, mesh, cam, "p16", **p16)
    out["step"] = _gauss_step(inp, mesh, cam)
    out["step16"] = _gauss_step(inp, mesh, cam, **p16)
    out["fit"] = _gauss_fit(inp, mesh, cam, out_dir)
    out["ckpt"] = _gauss_ckpt(inp, mesh, cam, out_dir)
    from gsplat_tpu_torch.utils.bench import run_bench

    out["bench"] = run_bench(
        num_gaussians=2000, width=64, height=64, impl="jnp", mode="fwd_bwd",
        iters=1, tile_size=8, max_intersections=1 << 12, block_size=8,
        max_per_tile=256, binning="packed", gaussian_shards=4,
        fragment_format="bf16", device=CPU)
    return out


# ---- the captured multi-device programs (eager on gloo) --------------------


def _bits_equal(a, b) -> bool:
    """Equal tensors, or nests or dataclasses of them, bit for bit."""
    import dataclasses

    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and bool(torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bits_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_bits_equal, a, b))
    if dataclasses.is_dataclass(a):
        return all(_bits_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


def _jit_frames(render_jit, render_eager, scene, cams, cfg, mesh, **kw):
    """The cameras in turn, twice, through the *_jit render and the eager
    one: the jit frames, whether each equals the eager one bit for bit, and
    the cache's entries after."""
    frames, same = [], []
    for _ in range(2):
        for cam in cams:
            got = render_jit(scene, cam, cfg, mesh, **kw)
            with torch.no_grad():
                want = render_eager(scene, cam, cfg, mesh, **kw)
            same.append(_bits_equal(got, want))
            frames.append([t.numpy() for t in got])
    return {"frames": frames[:len(cams)], "same": same}


def _step_runs(make_step, make_eager, scene_np, shard, steps, degrees,
               targets, cams):
    """`steps` steps of the captured-entry step and of its eager body, each
    from its own copy of the scene: their outputs bit for bit, every
    gradient's and the tap's storage across the entry's steps, and the
    first step's outputs (for JAX)."""
    from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS
    from gsplat_tpu_torch.train.loop import make_optimizer

    runs = {}
    for name, make in (("entry", make_step), ("eager", make_eager)):
        scene = shard(_scene(scene_np))
        opt = make_optimizer(scene, 1e-2)
        step = make(opt)
        outs, ptrs = [], []
        for i in range(steps):
            args = (scene, cams, targets)
            if degrees is not None:
                args += (degrees[i],)
            outs.append(step(*args))
            ptrs.append([getattr(scene, f).grad.data_ptr()
                         for f in SCENE_FIELDS])
        runs[name] = (outs, scene_to_numpy(scene), ptrs, step)
    (e_outs, e_scene, ptrs, step), (g_outs, g_scene, _, _) = (
        runs["entry"], runs["eager"])
    return {"same": [_bits_equal(a, b) for a, b in zip(e_outs, g_outs)],
            "scene_same": all(np.array_equal(e_scene[f], g_scene[f])
                              for f in e_scene),
            "grad_ptrs_kept": all(p == ptrs[0] for p in ptrs),
            "entries": len(step.graphs.entries),
            "first": e_outs[0], "scene": e_scene}


def _tile_steps(inp, mesh, cam):
    from gsplat_tpu_torch.parallel.train_step import (
        _sharded_step_body,
        make_eager_sharded_train_step,
        make_sharded_train_step,
        shard_batch,
    )
    from gsplat_tpu_torch.train.loop import make_optimizer

    cfg = _cfg(inp)
    target = torch.nn.functional.pad(
        torch.from_numpy(inp["target_step"]),
        (0, 0, 0, cfg.padded_width - cfg.width, 0,
         cfg.padded_height - cfg.height))[None]
    cams, bands = shard_batch([cam], target, mesh)
    out = _step_runs(
        lambda opt: make_sharded_train_step(cfg, mesh, opt),
        lambda opt: make_eager_sharded_train_step(cfg, mesh, opt),
        inp["scene_step"], lambda s: s, 3, (0, 1, 1), bands, cams)
    loss, aux, (tap, visible) = out.pop("first")
    out["first"] = {"loss": float(loss), "tap": tap.numpy(),
                    "visible": visible.numpy(),
                    "overflow": bool(aux["overflow"])}
    # The tap leaf's gradient keeps its storage too.
    body, band_mask, params = _sharded_step_body(
        cfg, mesh, make_optimizer(_scene(inp["scene_step"]), 1e-2), 0.2,
        "data", "tiles")
    scene = GaussianScene(*params)
    tap_ptrs = []
    for _ in range(2):
        body(scene, cams, bands)
        tap_ptrs.append(body.tap.grad.data_ptr())
    out["tap_ptr_kept"] = tap_ptrs[0] == tap_ptrs[1]
    return out


def _gauss_steps(inp, mesh, cam):
    from gsplat_tpu_torch.parallel.gaussian_sharded import shard_scene
    from gsplat_tpu_torch.parallel.gaussian_train import (
        _gaussian_step_body,
        make_eager_gaussian_sharded_train_step,
        make_gaussian_sharded_train_step,
    )
    from gsplat_tpu_torch.parallel.sharding import local_tile_cfg
    from gsplat_tpu_torch.train.loop import make_optimizer

    cfg = _cfg(inp)
    cap = inp["scene_train"]["means"].shape[0]
    lcfg = local_tile_cfg(cfg, mesh.size_of("gauss"))
    k = mesh.index("gauss")
    band = torch.from_numpy(inp["target_train"])[
        None, k * lcfg.height:(k + 1) * lcfg.height]
    out = _step_runs(
        lambda opt: make_gaussian_sharded_train_step(cfg, mesh, opt, cap),
        lambda opt: make_eager_gaussian_sharded_train_step(cfg, mesh, opt,
                                                           cap),
        inp["scene_train"], lambda s: shard_scene(s, mesh), 3, None, band,
        [cam])
    m, (tap, visible) = out.pop("first")
    out["first"] = {"loss": float(m["loss"]), "tap": tap.numpy(),
                    "visible": visible.numpy(),
                    "overflow": bool(m["overflow"])}
    local = shard_scene(_scene(inp["scene_train"]), mesh)
    body, _ = _gaussian_step_body(cfg, mesh, make_optimizer(local, 1e-2),
                                  cap, 0.2, "gauss", None)
    tap_ptrs = []
    for _ in range(2):
        body(local, [cam], band)
        tap_ptrs.append(body.tap.grad.data_ptr())
    out["tap_ptr_kept"] = tap_ptrs[0] == tap_ptrs[1]
    # The densify program against its eager body, on this shard after the
    # steps, with an accumulator that triggers splits and clones.
    from gsplat_tpu_torch.parallel.gaussian_train import (
        make_eager_gaussian_sharded_densify,
        make_gaussian_sharded_densify,
    )
    from gsplat_tpu_torch.train.densify import DensifyState

    shard = shard_scene(_scene(inp["scene_train"]), mesh)
    rows = shard.num_gaussians
    g = torch.Generator().manual_seed(k)
    dstate = DensifyState(
        grad_accum=torch.rand((rows,), generator=g) * 1e-3,
        count=torch.tensor(4, dtype=torch.int32),
        visit_count=torch.randint(0, 5, (rows,), generator=g,
                                  dtype=torch.int32))
    kw = dict(grad_threshold=1e-4)
    dens = make_gaussian_sharded_densify(mesh, **kw)
    got = [dens(shard, dstate) for _ in range(2)]
    want = make_eager_gaussian_sharded_densify(mesh, **kw)(shard, dstate)
    out["densify_same"] = [_bits_equal(x, want) for x in got]
    out["densify_entries"] = len(dens.graphs.entries)
    out["densify_stats"] = {k2: int(v) for k2, v in want[3].items()}
    return out


def _agreement(mesh, rank):
    """The rank-agreement rule: a miss on the same key passes the check; a
    key that differs between the ranks raises on every rank, before any
    warm-up."""
    from gsplat_tpu_torch.utils.graphs import Captured, check_ranks_agree

    out = {}
    check_ranks_agree("same", mesh)
    cache = Captured("agreement")
    x = torch.ones(3)
    out["agreed"] = cache("k", [x], lambda t: t * 2, mesh=mesh).tolist()
    ran = []
    try:
        cache(("k", rank), [x], lambda t: ran.append(1) or t, mesh=mesh)
        out["disagreed"] = "no error"
    except RuntimeError as e:
        out["disagreed"] = str(e)
    out["body_ran"] = bool(ran)
    return out


def parallel_jit_world(rank, world, inp, out_dir):
    """The *_jit renders, the steps and the densify program on a gloo mesh
    (their eager route) against the eager functions, and the rank-agreement
    rule."""
    from gsplat_tpu_torch.parallel.gaussian_sharded import (
        render_gaussian_sharded,
        render_gaussian_sharded_jit,
        shard_scene,
    )
    from gsplat_tpu_torch.parallel.sharding import (
        render_tile_sharded,
        render_tile_sharded_jit,
    )

    torch.set_num_threads(1)
    cams = [camera_from_numpy(**c, device=CPU) for c in inp["cams"]]
    tiles = make_mesh({"tiles": world}, CPU)
    gauss = make_mesh({"gauss": world}, CPU)
    scene = _scene(inp["scene_render"])
    out = {"agreement": _agreement(tiles, rank)}
    out["tile_f32"] = _jit_frames(render_tile_sharded_jit,
                                  render_tile_sharded, scene, cams,
                                  _cfg(inp), tiles)
    out["tile_p16"] = _jit_frames(
        render_tile_sharded_jit, render_tile_sharded, scene, cams,
        _cfg(inp, binning="tiered", stream_format="packed16"), tiles)
    local = shard_scene(scene, gauss)
    out["gauss_f32"] = _jit_frames(render_gaussian_sharded_jit,
                                   render_gaussian_sharded, local, cams,
                                   _cfg(inp), gauss)
    out["gauss_p16"] = _jit_frames(
        render_gaussian_sharded_jit, render_gaussian_sharded, local, cams,
        _cfg(inp, stream_format="packed16", fragment_format="bf16"), gauss,
        per_dest_capacity=2048)
    out["tile_steps"] = _tile_steps(inp, tiles, cams[0])
    out["gauss_steps"] = _gauss_steps(inp, gauss, cams[0])
    return out
