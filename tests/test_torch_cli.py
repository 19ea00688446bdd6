"""The port's command line (`python -m gsplat_tpu_torch.cli`) on the CPU
(`--device cpu`): info, render, bench, train and warmup smoke runs, and its
helpers against the JAX command's field by field."""

import argparse
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu import cli as jcli  # noqa: E402
from gsplat_tpu.io.ply import save_ply as jax_save_ply  # noqa: E402
from gsplat_tpu_torch import cli  # noqa: E402
from gsplat_tpu_torch.config import RenderConfig  # noqa: E402
from gsplat_tpu_torch.io.ply import load_ply  # noqa: E402
from gsplat_tpu_torch.utils.image import read_png, to_uint8  # noqa: E402


def _common(size=64, binning="packed"):
    return [
        "--width", str(size), "--height", str(size), "--tile-size", "8",
        "--max-intersections", str(1 << 13), "--block-size", "8",
        "--max-per-tile", "256", "--impl", "jnp", "--binning", binning,
    ]


CPU = ["--device", "cpu"]


def test_cli_info_matches_jax(tmp_path, capsys):
    assert cli.main(["info", "synthetic", "--synthetic-n", "200"] + CPU) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["num_gaussians"] == 200 and stats["sh_degree"] == 3
    ply = str(tmp_path / "s.ply")
    jax_save_ply(jax_random_scene(jax.random.key(1), 90, sh_degree=2), ply)
    assert cli.main(["info", ply] + CPU) == 0
    got = json.loads(capsys.readouterr().out)
    assert jcli.main(["info", ply]) == 0
    want = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    for k in ("num_gaussians", "sh_degree", "bbox_min", "bbox_max"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["mean_scale"], want["mean_scale"],
                               rtol=1e-6)


def test_cli_render_ply_matches_jax(tmp_path):
    """A JAX-written PLY rendered by both commands: PNGs within one level
    of 255 (the float images agree to 1e-4; a level boundary may fall
    between them)."""
    ply = str(tmp_path / "scene.ply")
    jax_save_ply(jax_random_scene(jax.random.key(3), 150, sh_degree=1), ply)
    ours, theirs = str(tmp_path / "p_{}.png"), str(tmp_path / "j_{}.png")
    assert cli.main(["render", ply, "--output", ours] + _common() + CPU) == 0
    assert jcli.main(["render", ply, "--output", theirs] + _common()) == 0
    a = to_uint8(read_png(ours.replace("{}", "default"))).astype(int)
    b = to_uint8(read_png(theirs.replace("{}", "default"))).astype(int)
    assert a.shape == (64, 64, 3) and a.max() > 0
    assert np.abs(a - b).max() <= 1


def test_cli_render_orbit_viewer_preset_and_cameras(tmp_path, capsys):
    out = str(tmp_path / "o_{}.png")
    assert cli.main(["render", "synthetic", "--synthetic-n", "300",
                     "--orbit", "2", "--viewer-preset", "--pad-bucket",
                     "--width", "96", "--height", "64", "--output", out]
                    + CPU) == 0
    text = capsys.readouterr().out
    assert "padded to capacity bucket 300" not in text  # 300 is a bucket
    for i in range(2):
        img = read_png(out.replace("{}", f"orbit_{i:03d}"))
        assert img.shape == (64, 96, 3)
    cams = tmp_path / "cameras.json"
    cams.write_text(json.dumps([{
        "id": 0, "img_name": "cam0", "width": 64, "height": 64,
        "position": [0.0, 0.0, -1.0], "rotation": np.eye(3).tolist(),
        "fx": 64.0, "fy": 64.0}]))
    assert cli.main(["render", "synthetic", "--synthetic-n", "250",
                     "--pad-bucket", "--cameras", str(cams),
                     "--camera-index", "0", "--output", out]
                    + _common() + CPU) == 0
    assert "padded to capacity bucket 300" in capsys.readouterr().out
    assert read_png(out.replace("{}", "cam0")).max() > 0


def test_cli_bench_smoke_and_profile(tmp_path, capsys):
    assert cli.main(["bench", "--synthetic-n", "300", "--mode", "fwd",
                     "--iters", "2", "--tier-spec", "4:0,8:2,16:6,32:25,64:50"]
                    + _common(binning="tiered") + CPU) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["unit"] == "it/s" and result["details"]["device"] == "cpu"
    prof = tmp_path / "prof"
    assert cli.main(["bench", "--synthetic-n", "300", "--mode", "fwd_bwd",
                     "--iters", "1", "--profile", str(prof)]
                    + _common() + CPU) == 0
    assert (prof / "trace.json").stat().st_size > 0
    # One process, no process group: the sharded bench needs 2 ranks.
    with pytest.raises(ValueError, match="mesh needs 2 ranks"):
        cli.main(["bench", "--synthetic-n", "300", "--sharded-tiles", "2"]
                 + _common() + CPU)


def test_cli_train_smoke(tmp_path, capsys):
    out = str(tmp_path / "trained.ply")
    assert cli.main(["train", "--synthetic-n", "200", "--steps", "3",
                     "--views", "2", "--out", out] + _common() + CPU) == 0
    scene = load_ply(out, device="cpu")
    assert scene.num_gaussians == 200
    assert np.all(np.isfinite(scene.means.numpy()))


def test_cli_train_init_is_placed_on_the_target(tmp_path, capsys):
    """`cli train --steps 0` saves its init unchanged: the port's
    random_scene drawn from seed + 1, moved by `place_init` onto the
    target (random_scene from seed): centred on its centre, with its
    90th-percentile radius, an affine image of the drawn cloud. For a cloud
    centred on the origin with a 90th-percentile radius of 1,
    `place_init` is the JAX command's map (gsplat_tpu/train/loop.py,
    `train_from_cli`: means * radius / 2.5 + center)."""
    from gsplat_tpu_torch.models.gaussians import random_scene
    from gsplat_tpu_torch.train.loop import place_init

    out = str(tmp_path / "init.ply")
    assert cli.main(["train", "--synthetic-n", "200", "--steps", "0",
                     "--views", "2", "--seed", "3", "--out", out]
                    + _common() + CPU) == 0

    def cloud(seed):
        return random_scene(200, 3, generator=torch.Generator().manual_seed(
            seed), device="cpu").means.numpy().astype(np.float64)

    def p90(m):
        return np.percentile(np.linalg.norm(m - m.mean(0), axis=-1), 90)

    target, drawn = cloud(3), cloud(4)
    got = load_ply(out, device="cpu").means.numpy().astype(np.float64)
    center = target.mean(0)
    np.testing.assert_allclose(got.mean(0), center, atol=1e-5)
    np.testing.assert_allclose(p90(got), p90(target), rtol=1e-5)
    np.testing.assert_allclose(
        got, (drawn - drawn.mean(0)) * (p90(target) / p90(drawn)) + center,
        rtol=1e-5, atol=1e-5)

    m = np.random.default_rng(0).normal(size=(300, 3))
    m -= m.mean(0)
    m /= p90(m)
    c, r = np.array([0.5, -1.0, 4.0]), 7.0
    np.testing.assert_allclose(
        place_init(torch.from_numpy(m).float(), c, r).numpy(),
        m * r / 2.5 + c, rtol=1e-5, atol=1e-5)


def test_cli_train_full_surface(tmp_path, capsys):
    """Every training feature on at once from the command line (the JAX
    command's test): densify with the big-splat prune, opacity reset, SH
    warm-up, position-lr decay, SSIM, batch 2, held-out PSNR, metrics CSV,
    checkpoints, the staged capacity, overflow_policy raise; then a resume
    from the step-4 checkpoint."""
    out = str(tmp_path / "trained.ply")
    csv_path = str(tmp_path / "metrics.csv")
    argv = [
        "train", "--synthetic-n", "150", "--steps", "8", "--views", "3",
        "--out", out, "--batch", "2", "--ssim-weight", "0.2",
        "--densify-every", "4", "--capacity", "300",
        "--densify-until", "6", "--densify-max-scale", "1.0",
        "--opacity-reset-every", "6", "--overflow-policy", "raise",
        "--sh-warmup-every", "2", "--position-lr-final-ratio", "0.01",
        "--holdout-views", "2", "--eval-every", "4",
        "--metrics-csv", csv_path, "--sh-degree", "1",
        "--checkpoint-every", "4",
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--retighten-capacity", "1.3",
    ] + _common(48, binning="tiered") + CPU
    assert cli.main(argv) == 0
    assert load_ply(out, device="cpu").num_gaussians == 300
    text = capsys.readouterr().out
    assert "held-out" in text and "staged capacity: tightening" in text
    with open(csv_path) as f:
        header = f.readline().strip().split(",")
        rows = [line.strip().split(",") for line in f]
    assert "holdout_psnr" in header and "train_psnr" in header
    col = header.index("holdout_psnr")
    vals = [r[col] for r in rows if len(r) > col and r[col]]
    assert vals and all(np.isfinite(float(v)) for v in vals)
    assert cli.main(argv + ["--resume", str(tmp_path / "ckpt" /
                                            "ckpt_000004.npz"),
                            "--metrics-csv", str(tmp_path / "m2.csv")]) == 0
    assert "resumed from" in capsys.readouterr().out


def test_cli_warmup_smoke(capsys):
    assert cli.main(["warmup", "--buckets", "100,150", "--width", "64",
                     "--height", "64"] + CPU) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == ["bucket 100",
                                                       "bucket 150"]


def test_bucket_matches_jax():
    for n in [1, 2, 9, 10, 11, 149, 150, 151, 999, 123_456, 600_001,
              1_000_000, 1_250_000, 7_654_321]:
        assert cli._bucket(n) == jcli._bucket(n), n


def _same_fields(cfg, jcfg):
    for f in RenderConfig.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f


@pytest.mark.parametrize("max_i", [1 << 22, 123])
def test_viewer_preset_cfg_matches_jax(max_i):
    ns = argparse.Namespace(viewer_preset=True, max_intersections=max_i,
                            sh_degree=3)
    cfg = cli._build_cfg(ns, 800, 600)
    _same_fields(cfg, jcli._build_cfg(ns, 800, 600))
    assert cfg.max_intersections == (2_330_000 if max_i == 1 << 22 else 123)


def test_build_cfg_from_flags_matches_jax():
    argv = ["render", "x.ply"] + _common(binning="tiered") + [
        "--gather-backward", "bf16", "--grad-readout", "bf16",
        "--segment-sum", "pallas", "--stream-format", "packed4",
        "--max-tiles-per-gaussian", "32", "--sh-degree", "2"]
    args = cli.build_parser().parse_args(argv)
    jp = argparse.ArgumentParser()
    jsub = jp.add_subparsers(dest="cmd")
    jr = jsub.add_parser("render")
    jr.add_argument("ply")
    jcli._common_flags(jr)
    jargs = jp.parse_args(argv)
    cfg = cli._build_cfg(args, 64, 64)
    _same_fields(cfg, jcli._build_cfg(jargs, 64, 64))
    assert args.device == "cuda"  # the default: the card
    args = cli.build_parser().parse_args(argv + ["--tier-spec", "4:0,8:2"])
    assert cli._build_cfg(args, 64, 64).tier_spec == ((4, 0), (8, 2))


def test_cli_bad_subcommand():
    with pytest.raises(SystemExit):
        cli.main(["frobnicate"])
