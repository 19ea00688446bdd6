#!/usr/bin/env python3
"""Time builds of the blend kernels K1 and K2, of the segmented suffix
sums K4 and K5, or of the probes P3 and P4, from several source trees side
by side on one CUDA card.

    python3 scripts/time_blend_builds.py [--kernels blend|segsum|probes]
        [--csrc DIR ...] [--rounds N] [--out F]

The first build is the package's own `gsplat_tpu_torch/csrc`; each --csrc
DIR adds one, from a directory holding the same sources with the same C
interface (a parent commit's `gsplat_tpu_torch/csrc`, unpacked with `git
archive`): `raster_fwd.cu` and `raster_bwd.cu` with `--kernels blend` (the
default), `segsum.cu` and `segsum_packed.cu` with `--kernels segsum`,
`probe_gather.cu` and `probe_coldma.cu` with `--kernels probes`. Every
build is compiled with the package's nvcc flags, all at once, and launched
through the package's wrappers (`ops/cuda/raster.py`, `ops/cuda/segsum.py`,
`ops/cuda/probes.py`) with its libraries loaded in place of the package's.

Streams, on chip_smoke.py's bench config (1920x1080, tile 32, 1M Gaussians
at SH 3, seed 0, the four views of `chip_smoke.views`). Blend: view 0 of the
random scene as float32 and packed4 (chip_smoke.py's K1 and K2 phases), and
every view of the realistic scene with the jumbo ladder, packed4: the frames
of the `serve packed4 realistic` path. K2 takes N(0, 1) upstream gradients
(seed 1) and the first build's K1 outputs, and writes bf16 pairs on a packed
stream. For each build and stream it prints K1's largest difference from the
first build, K2's largest and its relative L2 difference (K2's sums may add
in another order). Segsum: the package's K2 gradients on view 0 of each
scene, sorted gid-major as the gather backward sorts them (chip_smoke.py's
phases 6 and 7): the random scene at depth 64 (K4 on K2's float32
gradients, K5 on its packed4 bf16 pairs) and the realistic scene at depth
2048 (K5 on K2's pairs, K4 on them unpacked to float32). For each build it
prints K4's and K5's largest difference from the first build and whether
their output is bit-identical to it. Probes: chip_smoke.py's in-range
inputs of phase 10 (`chip_smoke.probe_inputs`: P3 at (8, 512), P4 on an
(8, 2^20) table at (2048, 128)); for each build it prints whether P3's and
P4's outputs are bit-identical to the first build's (in-range indices only:
builds before the index rules of `ops/cuda/probes.py` gave NaN outside
[0, C) and [0, n)). Then, for every stream and build, CUDA-event means over
20 launches in every round (the probes queued behind a spin kernel with
`micro_kernel_costs.timeit`, beside the launch floor, torch.cuda._sleep(0)
timed the same way, and P4 also as the median of 10 launches each after a
512 MB write that flushes the L2), the builds in alternating order from
round to round; the card's name and power limit, and one JSON line of the
times. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (the bench config, views and timer)

SOURCES = {"blend": ("raster_fwd", "raster_bwd"),
           "segsum": ("segsum", "segsum_packed"),
           "probes": ("probe_gather", "probe_coldma")}


def build(dirs, sources) -> list[dict]:
    """[{source: loaded library}] for each directory, one nvcc per source,
    all started together."""
    from gsplat_tpu_torch.ops.cuda import _build

    nvcc = _build._nvcc()
    procs = []
    for i, d in enumerate(dirs):
        out = _build.BUILD_ROOT / "blend_builds" / str(i)
        out.mkdir(parents=True, exist_ok=True)
        for name in sources:
            lib = out / f"lib{name}.so"
            procs.append((i, name, lib, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(lib),
                 str(Path(d) / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs: list[dict] = [{} for _ in dirs]
    for i, name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {dirs[i]}/{name}.cu:\n{log}")
        libs[i][name] = ctypes.CDLL(str(lib))
    return libs


def streams(dev, realistic_views: int = 4) -> list:
    """[(tag, cfg, stream, ranges, sorted_gidk)] of the bench config's
    streams: the random view 0 (float32, packed4), then the first
    `realistic_views` realistic views (packed4)."""
    import torch

    from gsplat_tpu_torch import RenderConfig, random_scene, realistic_scene
    from gsplat_tpu_torch.ops import binning, stream16
    from gsplat_tpu_torch.ops.projection import project_gaussians

    cfg = RenderConfig(**chip_smoke.BENCH)
    cfg4 = RenderConfig(**dict(chip_smoke.BENCH, **chip_smoke.DEFAULT))
    rcfg = RenderConfig(**dict(chip_smoke.BENCH, **chip_smoke.DEFAULT,
                               **chip_smoke.JUMBO))
    cams = chip_smoke.views(cfg.width, cfg.height, dev)
    out = []
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(0)
        scene = random_scene(chip_smoke.NUM_GAUSSIANS, sh_degree=3,
                             generator=gen, device=dev)
        proj = project_gaussians(scene, cams[0], cfg)
        b = binning.bin_gaussians(proj, cfg)
        out.append(("random f32 view 0", cfg,
                    binning.gather_features(proj, b, cfg), b.ranges,
                    b.sorted_gidk))
        out.append(("random packed4 view 0", cfg4, stream16.gather_packed(
            binning.features_f32(proj, cfg4), b.sorted_gid, cfg4), b.ranges,
            b.sorted_gidk))
        del scene, proj, b
        gen = torch.Generator(device=dev).manual_seed(0)
        scene = realistic_scene(chip_smoke.NUM_GAUSSIANS, sh_degree=3,
                                generator=gen, device=dev)
        for v, cam in enumerate(cams[:realistic_views]):
            proj = project_gaussians(scene, cam, rcfg)
            b = binning.bin_gaussians(proj, rcfg)
            if bool(b.overflow):
                raise SystemExit(f"realistic view {v} overflows the capacity")
            out.append((f"realistic packed4 view {v}", rcfg,
                        stream16.gather_packed(binning.features_f32(proj, rcfg),
                                               b.sorted_gid, rcfg), b.ranges,
                        b.sorted_gidk))
    return out


def upstream(cfg, gen):
    """N(0, 1) upstream gradients of the tiled image and transmittance."""
    import torch

    dev = gen.device
    return (torch.randn((cfg.num_tiles, 3, cfg.pixels_per_tile), generator=gen,
                        device=dev),
            torch.randn((cfg.num_tiles, cfg.pixels_per_tile), generator=gen,
                        device=dev))


def events(fn):
    """A timer of fn: its CUDA-event mean over 20 launches, in ms."""
    return lambda: chip_smoke.cuda_ms(fn, 20)


def blend_calls(dev, libs, dirs, gen) -> dict:
    """{stream tag: [{"k1": timer, "k2": timer} per build]}, after printing
    each build's difference from the first."""
    from gsplat_tpu_torch.ops.bf16_pairs import unpack_bf16_pairs
    from gsplat_tpu_torch.ops.cuda import _build, raster

    out = {}
    for tag, cfg, stream, ranges, _ in streams(dev):
        pack = cfg.stream_format != "f32"
        g_col, g_tt = upstream(cfg, gen)
        _build._libs.update(libs[0])
        col0, tr0 = raster.raster_tiles_cuda(stream, ranges, cfg)
        b_tot = ((g_col * col0).sum(1) + g_tt * tr0).contiguous()
        calls, d0 = [], None
        for i, lib in enumerate(libs):

            def k1(lib=lib, stream=stream, ranges=ranges, cfg=cfg):
                _build._libs.update(lib)
                return raster.raster_tiles_cuda(stream, ranges, cfg)

            def k2(lib=lib, stream=stream, ranges=ranges, cfg=cfg,
                   g_col=g_col, b_tot=b_tot, pack=pack):
                _build._libs.update(lib)
                return raster.raster_bwd_cuda(stream, ranges, g_col, b_tot,
                                              cfg, pack_out=pack)

            col, tr = k1()
            d = unpack_bf16_pairs(k2(), 9) if pack else k2()
            d0 = d if d0 is None else d0
            diff1 = max(float((col - col0).abs().max()),
                        float((tr - tr0).abs().max()))
            rel2 = float((d - d0).norm() / d0.norm().clamp_min(1e-30))
            print(f"[{tag}] build {i} ({dirs[i]}): K1 max abs difference "
                  f"from build 0 {diff1}; K2 max abs difference "
                  f"{float((d - d0).abs().max())}, relative L2 {rel2}",
                  flush=True)
            calls.append({"k1": events(k1), "k2": events(k2)})
        out[tag] = calls
    _build._libs.update(libs[0])
    return out


def segsum_calls(dev, libs, dirs, gen) -> dict:
    """{stream tag: [{"segsum": timer, "segsum_packed": timer} per
    build]} on K2's gradients of random view 0 (depth 64) and realistic view
    0 (depth 2048), after printing each build's difference from the first."""
    import torch

    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.bf16_pairs import unpack_bf16_pairs
    from gsplat_tpu_torch.ops.cuda import _build, raster, segsum

    grads = {}
    for tag, cfg, stream, ranges, gidk in streams(dev, realistic_views=1):
        g_col, g_tt = upstream(cfg, gen)
        col, tr = raster.raster_tiles_cuda(stream, ranges, cfg)
        d = raster.raster_bwd_cuda(
            stream, ranges, g_col, ((g_col * col).sum(1) + g_tt * tr).contiguous(),
            cfg, pack_out=cfg.stream_format != "f32")
        kmax = binning.kmax_eff(cfg)
        s_key, perm = torch.sort(torch.where(gidk >= 0, gidk, 2**31 - 1))
        rows = (s_key >> binning._kbits(kmax)).to(torch.int32)
        scene = tag.split()[0]
        grads.setdefault(scene, {"kmax": kmax, "rows": rows})[
            "segsum_packed" if d.dtype == torch.int32 else "segsum"] = \
            d.index_select(1, perm).contiguous()
    out = {}
    for scene, g in grads.items():
        if "segsum" not in g:
            g["segsum"] = unpack_bf16_pairs(g["segsum_packed"],
                                            binning.NUM_FEATURES).contiguous()
        tag = f"{scene} view 0 depth {segsum.doubling_depth(g['kmax'])}"
        launch = {"segsum": segsum.segmented_suffix_sum_cuda,
                  "segsum_packed": segsum.segmented_suffix_sum_packed_cuda}
        calls, first = [], {}
        for i, lib in enumerate(libs):
            fns, what = {}, []
            for name, fn in launch.items():

                def call(lib=lib, fn=fn, x=g[name], rows=g["rows"],
                         kmax=g["kmax"]):
                    _build._libs.update(lib)
                    return fn(x, rows, kmax)

                got = call()
                ref = first.setdefault(name, got)
                if name == "segsum_packed":
                    f = 2 * got.shape[0]
                    diff = float((unpack_bf16_pairs(got, f)
                                  - unpack_bf16_pairs(ref, f)).abs().max())
                else:
                    diff = float((got - ref).abs().max())
                same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
                what.append(f"{name} max abs difference from build 0 {diff}, "
                            f"bit-identical {same}")
                fns[name] = events(call)
            print(f"[{tag}] build {i} ({dirs[i]}): {'; '.join(what)}",
                  flush=True)
            calls.append(fns)
        out[tag] = calls
    _build._libs.update(libs[0])
    return out


def probes_calls(dev, libs, dirs, gen) -> dict:
    """{tag: [{name: timer} per build]} of P3 (with the launch floor beside
    it) and P4 (warm and after a flush) on chip_smoke.probe_inputs, after
    printing whether each build's outputs are bit-identical to the
    first's."""
    import torch

    from gsplat_tpu_torch import micro_kernel_costs as mkc
    from gsplat_tpu_torch.ops.cuda import _build, probes

    tab, idx, table, cols = chip_smoke.probe_inputs(dev)
    p3, p4 = [], []
    first = []
    for i, lib in enumerate(libs):

        def gather(lib=lib):
            _build._libs.update(lib)
            return probes.lane_gather_cuda(tab, idx)

        def copy(lib=lib):
            _build._libs.update(lib)
            return probes.column_copy_cuda(table, cols)

        got = (gather(), copy())
        first = first or got
        same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(got, first)]
        print(f"[probes] build {i} ({dirs[i]}): P3 {tuple(got[0].shape)} "
              f"bit-identical to build 0 {same[0]}; P4 {tuple(got[1].shape)} "
              f"bit-identical to build 0 {same[1]}", flush=True)
        p3.append({"probe_gather": lambda f=gather: mkc.timeit(dev, f, 20)[0],
                   "launch_floor": lambda: mkc.timeit(
                       dev, lambda: torch.cuda._sleep(0), 20)[0]})
        p4.append({"probe_coldma": lambda f=copy: mkc.timeit(dev, f, 20)[0],
                   "probe_coldma_cold": lambda f=copy: statistics.median(
                       chip_smoke.cold_ms(f, dev))})
    _build._libs.update(libs[0])
    return {"P3 (8, 512)": p3, "P4 (2048, 128) of (8, 2^20)": p4}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", choices=sorted(SOURCES), default="blend",
                    help="the pair of kernels to build and time")
    ap.add_argument("--csrc", action="append", default=[],
                    help="a directory of the same sources to time")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", help="JSON file for the numbers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_blend_builds: needs a CUDA card", file=sys.stderr)
        return 1
    from gsplat_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda", 0)
    card = chip_smoke.gpu_line()
    dirs = [str(_build.CSRC), *args.csrc]
    libs = build(dirs, SOURCES[args.kernels])
    gen = torch.Generator(device=dev).manual_seed(1)
    make_calls = {"blend": blend_calls, "segsum": segsum_calls,
                  "probes": probes_calls}[args.kernels]
    times = {}
    for tag, calls in make_calls(dev, libs, dirs, gen).items():
        for r in range(args.rounds):
            order = range(len(libs)) if r % 2 == 0 else reversed(range(len(libs)))
            for i in order:
                t = times.setdefault(tag, {}).setdefault(i, {})
                for name, timer in calls[i].items():
                    t.setdefault(name, []).append(timer())
        _build._libs.update(libs[0])
    for tag, by_build in times.items():
        for i, t in by_build.items():
            print(f"[{tag}] build {i}: " + ", ".join(
                f"{name} ms {v} (median {statistics.median(v)})"
                for name, v in t.items()), flush=True)
    if args.kernels == "blend":
        for i in range(len(libs)):
            frame = sum(statistics.median(t[i]["k1"])
                        for tag, t in times.items()
                        if tag.startswith("realistic"))
            print(f"[realistic packed4] build {i}: K1 over the four views "
                  f"{frame} ms (sum of medians)", flush=True)
    print(card, flush=True)
    result = {"card": card, "kernels": args.kernels, "builds": dirs,
              "times": {tag: {str(i): t for i, t in by.items()}
                        for tag, by in times.items()}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
