"""The bench and binning's capacity reports of the port against the JAX
package (CPU): `tier_occupancy` and `diagnose_overflow` on overflowing
configs, `run_bench`'s result keys and readings, and the single-device
'scatter' binning (stream, image and gradients)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.io.ply import save_ply as jax_save_ply  # noqa: E402
from gsplat_tpu.models.gaussians import realistic_scene as jax_realistic_scene  # noqa: E402
from gsplat_tpu.ops import binning as jbinning  # noqa: E402
from gsplat_tpu.ops.projection import project_gaussians as jax_project  # noqa: E402
from gsplat_tpu.render.pipeline import render as jax_render  # noqa: E402
from gsplat_tpu.utils.bench import run_bench as jax_run_bench  # noqa: E402
from gsplat_tpu_torch import RenderConfig, render  # noqa: E402
from gsplat_tpu_torch.bench import main as bench_main  # noqa: E402
from gsplat_tpu_torch.bench import preset  # noqa: E402
from gsplat_tpu_torch.convert import camera_from_numpy, scene_from_numpy  # noqa: E402
from gsplat_tpu_torch.ops import binning  # noqa: E402
from gsplat_tpu_torch.ops.projection import project_gaussians  # noqa: E402
from gsplat_tpu_torch.render.pipeline import render_loss_and_grad  # noqa: E402
from gsplat_tpu_torch.utils.bench import run_bench  # noqa: E402

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
SMALL = dict(width=64, height=64, tile_size=8, block_size=8, max_per_tile=512)
# The repo's tolerances: images (tests/test_pallas.py) and scene gradients.
IMG_RTOL, IMG_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-5


def to_port(jscene, jcam):
    scene = scene_from_numpy(
        *(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS), device="cpu")
    cam = camera_from_numpy(
        *(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS), device="cpu")
    return scene, cam


@pytest.mark.parametrize("kind, kw, causes", [
    # Tight pools and a stream past its capacity.
    ("random", dict(binning="tiered", max_tiles_per_gaussian=4,
                    tier_spec=((2, 0), (4, 40)), max_intersections=256),
     {"pool", "stream"}),
    # Rects past a K_max of 1 tile.
    ("random", dict(binning="tiered", max_tiles_per_gaussian=1,
                    tier_spec=((1, 0),), max_intersections=1 << 14),
     {"rect>K_max"}),
    # The jumbo tiers with budgets too small for the heavy tail, and a rect
    # past K_jumbo.
    ("realistic", dict(binning="tiered", max_tiles_per_gaussian=4,
                       tier_spec=((2, 0), (4, 8)), max_tiles_jumbo=8,
                       jumbo_tier_spec=((6, 3), (8, 1)),
                       max_intersections=1 << 14),
     {"rect>K_jumbo", "jumbo-budget(upper-bound)"}),
])
def test_tier_occupancy_and_diagnose_overflow_match_jax(kind, kw, causes):
    make = jax_realistic_scene if kind == "realistic" else jax_random_scene
    jscene = make(jax.random.key(6), 300, sh_degree=1)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    jcfg = JaxConfig(**SMALL, **kw, impl="jnp")
    cfg = RenderConfig(**SMALL, **kw)
    want = jbinning.diagnose_overflow(jax_project(jscene, jcam, jcfg), jcfg)
    with torch.no_grad():
        proj = project_gaussians(scene, cam, cfg)
        got = binning.diagnose_overflow(proj, cfg)
        assert bool(render(scene, cam, cfg).overflow)
    assert got == want
    assert set(got["causes"]) == causes
    assert binning.tier_occupancy(proj, cfg) == jbinning.tier_occupancy(
        jax_project(jscene, jcam, jcfg), jcfg)


def test_run_bench_matches_jax_keys_and_readings(tmp_path):
    """The same PLY through both benches: the same keys, metric, overflow
    reading and intersections; the port's device named."""
    path = tmp_path / "scene.ply"
    jax_save_ply(jax_random_scene(jax.random.key(2), 300, sh_degree=3), path)
    kw = dict(SMALL, num_gaussians=0, mode="fwd", iters=1,
              max_intersections=1 << 13, binning="tiered", ply=str(path))
    want = jax_run_bench(**kw)
    got = run_bench(**kw, device="cpu")
    assert set(got) == set(want)
    assert set(got["details"]) == set(want["details"])
    assert got["metric"] == want["metric"]
    for k in ("num_intersections", "overflow", "overflow_cause",
              "suggested_max_intersections", "impl"):
        assert got["details"][k] == want["details"][k], k
    assert got["details"]["device"] == "cpu"
    assert got["value"] > 0 and got["unit"] == "it/s"

    # fwd_bwd, overflowing: the cause is classified.
    got = run_bench(**dict(kw, mode="fwd_bwd", max_intersections=64),
                    device="cpu")
    assert got["details"]["overflow"]
    assert got["details"]["overflow_cause"] == ["stream"]


def test_run_bench_refuses_the_sharded_benches():
    """In one process with no process group, a sharded bench is refused:
    its mesh needs a rank per shard (tests/test_torch_sharding.py and
    tests/test_torch_gaussian_sharded.py run them on gloo ranks)."""
    for kw in (dict(sharded_tiles=2), dict(gaussian_shards=2)):
        with pytest.raises(ValueError, match="mesh needs 2 ranks"):
            run_bench(num_gaussians=10, width=16, height=16, device="cpu",
                      **kw)


def test_package_bench_presets_and_line(capsys):
    card = preset("realistic", exact_grads=True, mode="fwd", device="cuda")
    assert (card["width"], card["height"], card["num_gaussians"]) == \
        (1920, 1080, 1_000_000)
    assert card["stream_format"] == "f32" and card["max_tiles_jumbo"] == 2048
    default = preset(device="cuda")
    assert default["stream_format"] == "packed4"
    assert default["gather_backward"] == "bf16" and "max_tiles_jumbo" not in default
    # The CPU preset at a smaller scene, to keep the smoke run short.
    import gsplat_tpu_torch.bench as pb

    small = dict(pb.SMALL)
    try:
        pb.SMALL.update(num_gaussians=500, width=64, height=64, iters=1)
        assert bench_main(["--device", "cpu", "--mode", "fwd"]) == 0
    finally:
        pb.SMALL.clear()
        pb.SMALL.update(small)
    out, err = capsys.readouterr()
    import json

    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) >= {"metric", "value", "unit", "vs_baseline"}
    assert json.loads(err.strip().splitlines()[-1])["device"] == "cpu"


def _scatter_cfgs():
    kw = dict(SMALL, max_intersections=1 << 13, max_tiles_per_gaussian=64,
              binning="scatter")
    return JaxConfig(**kw, impl="jnp"), RenderConfig(**kw)


def test_scatter_stream_matches_jax():
    jscene = jax_random_scene(jax.random.key(8), 150, sh_degree=2)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    jcfg, cfg = _scatter_cfgs()
    jb = jbinning.bin_gaussians(jax_project(jscene, jcam, jcfg), jcfg)
    with torch.no_grad():
        b = binning.bin_gaussians(project_gaussians(scene, cam, cfg), cfg)
    n = int(jb.num_intersections)
    assert int(b.num_intersections) == n and n > 0
    assert bool(b.overflow) == bool(jb.overflow) is False
    np.testing.assert_array_equal(b.ranges.numpy(), np.asarray(jb.ranges))
    np.testing.assert_array_equal(b.sorted_tile.numpy(),
                                  np.asarray(jb.sorted_tile))
    np.testing.assert_array_equal(b.sorted_gid.numpy()[:n],
                                  np.asarray(jb.sorted_gid)[:n])
    assert b.sorted_gidk is None and b.gauss_counts is None

    # Past the capacity: the flag, and the first max_I candidates kept.
    small = RenderConfig(**dict(SMALL, max_intersections=64,
                                max_tiles_per_gaussian=64, binning="scatter"))
    with torch.no_grad():
        b = binning.bin_gaussians(project_gaussians(scene, cam, small), small)
    jsmall = JaxConfig(**dict(SMALL, max_intersections=64,
                              max_tiles_per_gaussian=64, binning="scatter"))
    jb = jbinning.bin_gaussians(jax_project(jscene, jcam, jsmall), jsmall)
    assert bool(b.overflow) and bool(jb.overflow)
    np.testing.assert_array_equal(b.ranges.numpy(), np.asarray(jb.ranges))
    np.testing.assert_array_equal(b.sorted_tile.numpy(),
                                  np.asarray(jb.sorted_tile))


def test_scatter_image_and_gradients_match_jax():
    jscene = jax_random_scene(jax.random.key(8), 150, sh_degree=2)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    jcfg, cfg = _scatter_cfgs()
    target = np.random.default_rng(9).uniform(size=(64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        out = render(scene, cam, cfg)
    jout = jax_render(jscene, jcam, jcfg)
    np.testing.assert_allclose(out.image.numpy(), np.asarray(jout.image),
                               rtol=IMG_RTOL, atol=IMG_ATOL)
    loss, grads = render_loss_and_grad(scene, cam, torch.from_numpy(target),
                                       cfg)
    jl, jg = jax.value_and_grad(
        lambda s: jnp.mean(jnp.abs(jax_render(s, jcam, jcfg).image - target))
    )(jscene)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(getattr(grads, f).numpy(),
                                   np.asarray(getattr(jg, f)),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f)
