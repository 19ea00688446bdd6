"""End-to-end forward render of the port against the JAX package (CPU), the
golden fixtures, the device rules, and the import boundary of the port."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.render.pipeline import render as jax_render  # noqa: E402
from gsplat_tpu_torch import (  # noqa: E402
    Camera,
    GaussianScene,
    RenderConfig,
    random_scene,
    render,
)
from gsplat_tpu_torch.convert import camera_from_numpy, scene_from_numpy  # noqa: E402
from gsplat_tpu_torch.ops.cuda import _build, counters, cull  # noqa: E402
from gsplat_tpu_torch.ops.projection import project_gaussians  # noqa: E402
from gsplat_tpu_torch.ops.raster_torch import rasterize_dense_oracle  # noqa: E402
from gsplat_tpu_torch.render.pipeline import STAGES  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
          max_tiles_per_gaussian=64, block_size=8, max_per_tile=512,
          pallas_block_size=32)
# The configuration of the JAX package's golden render (test_render.py).
GOLDEN_KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 14,
                 max_tiles_per_gaussian=64, block_size=8, max_per_tile=512)


def to_port(jscene, jcam):
    scene = scene_from_numpy(
        *(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS), device="cpu")
    cam = camera_from_numpy(
        *(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS), device="cpu")
    return scene, cam


def psnr(img, ref):
    mse = float(np.mean((img - ref) ** 2))
    return 10 * np.log10(max(ref.max(), 1.0) ** 2 / max(mse, 1e-12))


JAX_PALLAS = dict(impl="pallas", pallas_interpret=True)
JAX_JNP = dict(impl="jnp")


@pytest.mark.parametrize("kw, jax_impls", [
    # The bench's binning against both JAX rasterizers; the other modes
    # against the jnp one (the JAX tests hold Pallas to jnp themselves).
    (dict(KW, binning="tiered", tier_spec=((4, 0), (8, 2), (16, 6), (32, 25),
                                           (64, 50))), (JAX_PALLAS, JAX_JNP)),
    (dict(KW, binning="tiered", tier_spec=(8, 5, 16)), (JAX_JNP,)),
    (dict(KW, binning="packed"), (JAX_JNP,)),
    (dict(KW, binning="sort"), (JAX_JNP,)),
])
def test_render_matches_jax(kw, jax_impls):
    jscene = jax_random_scene(jax.random.key(8), 250, sh_degree=3)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    out = render(scene, cam, RenderConfig(**kw))
    assert out.image.shape == (64, 64, 3) and out.transmittance.shape == (64, 64)
    assert not bool(out.overflow) and int(out.num_intersections) > 0
    assert float(out.image.max()) > 0.01
    for extra in jax_impls:
        jout = jax_render(jscene, jcam, JaxConfig(**kw, **extra))
        assert int(out.num_intersections) == int(jout.num_intersections)
        assert bool(out.overflow) == bool(jout.overflow)
        np.testing.assert_array_equal(out.gauss_counts.numpy(),
                                      np.asarray(jout.gauss_counts))
        np.testing.assert_allclose(out.image.numpy(), np.asarray(jout.image),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out.transmittance.numpy(),
                                   np.asarray(jout.transmittance),
                                   rtol=1e-4, atol=1e-6)


def test_nan_opacity_render_without_cull_matches_jax():
    """At tile_culling=False no cull drops a Gaussian with a NaN opacity
    before the blend; every pair of it is skipped (its alpha stays NaN and
    fails alpha >= alpha_min), in the port as in the JAX jnp render: the
    image is finite and equal at the image tolerance."""
    jscene = jax_random_scene(jax.random.key(8), 250, sh_degree=3)
    nan = np.zeros(250, bool)
    nan[::7] = True
    jscene = jscene.replace(opacity_logits=jnp.where(
        nan, jnp.nan, jscene.opacity_logits))
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    kw = dict(KW, binning="tiered", tile_culling=False)
    out = render(scene, cam, RenderConfig(**kw))
    jout = jax_render(jscene, jcam, JaxConfig(**kw, **JAX_JNP))
    assert int(out.num_intersections) == int(jout.num_intersections) > 0
    assert bool(torch.isfinite(out.image).all())
    np.testing.assert_allclose(out.image.numpy(), np.asarray(jout.image),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.transmittance.numpy(),
                               np.asarray(jout.transmittance),
                               rtol=1e-4, atol=1e-6)
    # The NaN Gaussians were binned, so the blend met their pairs.
    assert int(out.gauss_counts[torch.from_numpy(nan)].sum()) > 0


def test_undersized_capacity_overflows_like_jax():
    kw = dict(KW, binning="tiered", max_intersections=128)
    jscene = jax_random_scene(jax.random.key(8), 250, sh_degree=0)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    out = render(scene, cam, RenderConfig(**kw))
    jout = jax_render(jscene, jcam, JaxConfig(**kw))
    assert bool(out.overflow) and bool(jout.overflow)
    assert int(out.num_intersections) == int(jout.num_intersections) > 128
    assert bool(torch.isfinite(out.image).all())


def test_render_matches_dense_oracle():
    jscene = jax_random_scene(jax.random.key(12), 120, sh_degree=1)
    scene, cam = to_port(jscene, JaxCamera.default(48, 40))
    cfg = RenderConfig(**dict(KW, width=48, height=40, binning="tiered"))
    out = render(scene, cam, cfg)
    img, trans = rasterize_dense_oracle(project_gaussians(scene, cam, cfg), cfg)
    torch.testing.assert_close(out.image, img, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out.transmittance, trans, rtol=1e-4, atol=1e-5)


def test_background_composites_through_transmittance():
    jscene = jax_random_scene(jax.random.key(8), 100, sh_degree=0)
    scene, cam = to_port(jscene, JaxCamera.default(64, 64))
    cfg = RenderConfig(**KW)
    bg = torch.tensor([0.2, 0.5, 1.0])
    plain = render(scene, cam, cfg)
    over = render(scene, cam, cfg, background=bg)
    torch.testing.assert_close(
        over.image, plain.image + plain.transmittance[..., None] * bg)


def test_golden_fixture_is_jax_random_scene():
    """tests/golden/scene_42_300.npz holds the JAX package's
    random_scene(key(42), 300, sh_degree=3), the scene of render_64.npz."""
    want = jax_random_scene(jax.random.key(42), 300, sh_degree=3)
    with np.load(GOLDEN / "scene_42_300.npz") as d:
        assert sorted(d.files) == sorted(SCENE_FIELDS)
        for f in SCENE_FIELDS:
            np.testing.assert_array_equal(d[f], np.asarray(getattr(want, f)),
                                          err_msg=f)


def test_golden_render_above_55db():
    with np.load(GOLDEN / "scene_42_300.npz") as d:
        scene = scene_from_numpy(**{k: d[k] for k in d.files}, device="cpu")
    golden = np.load(GOLDEN / "render_64.npz")["image"].astype(np.float32)
    out = render(scene, Camera.default(64, 64, device="cpu"),
                 RenderConfig(**GOLDEN_KW))
    assert psnr(out.image.numpy(), golden) > 55.0
    # The bench's binning mode renders the same image.
    tiered = render(scene, Camera.default(64, 64, device="cpu"),
                    RenderConfig(**GOLDEN_KW, binning="tiered"))
    assert psnr(tiered.image.numpy(), golden) > 55.0


@pytest.mark.parametrize("fmt", ["packed16", "packed4"])
def test_packed_streams_are_a_later_slice(fmt):
    """The packed streams, which the port now runs: `render` takes
    them on the CPU through the plain walk of the unpacked stream, counts
    no launch, and renders the float32 stream's image to the quantisation
    (tests/test_stream16.py: bf16 conic and opacity, 11/11/10-bit colour);
    tests/test_torch_stream16.py holds them to JAX."""
    scene = random_scene(50, 0, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    cam = Camera.default(64, 64, device="cpu")
    before = counters.snapshot()
    out = render(scene, cam, RenderConfig(**KW, stream_format=fmt))
    assert counters.rise(before, counters.snapshot()) == {}
    ref = render(scene, cam, RenderConfig(**KW))
    assert not bool(out.overflow) and float(out.image.max()) > 0.01
    assert float((out.image - ref.image).abs().max()) < 0.05


def test_render_needs_no_gradients():
    """With no input requiring grad, render records no graph (the serving
    path); a scene field that requires grad makes the image differentiable."""
    scene = random_scene(80, 1, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    out = render(scene, Camera.default(64, 64, device="cpu"),
                 RenderConfig(**KW))
    assert not out.image.requires_grad and out.image.grad_fn is None
    scene.means.requires_grad_(True)
    out = render(scene, Camera.default(64, 64, device="cpu"),
                 RenderConfig(**KW))
    assert out.image.requires_grad
    with torch.no_grad():
        out = render(scene, Camera.default(64, 64, device="cpu"),
                     RenderConfig(**KW))
    assert not out.image.requires_grad


def test_render_opens_one_profiler_span_per_stage():
    """scripts/profile_torch_render.py reads each stage's time on the card
    from these spans of `render` itself."""
    scene = random_scene(80, 1, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(scene, Camera.default(64, 64, device="cpu"),
               RenderConfig(**KW, binning="tiered"))
    spans = sorted((e for e in prof.events() if e.name in STAGES),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in spans] == list(STAGES)


@pytest.mark.parametrize("call", [
    lambda: random_scene(10),
    lambda: Camera.default(64, 64),
    lambda: Camera.create(np.eye(4), 64, 64, 64.0, 64.0),
    lambda: scene_from_numpy(*(np.zeros((2, 3)) for _ in range(5))),
    lambda: camera_from_numpy(*(np.eye(4) for _ in range(3)), np.zeros(3),
                              np.ones(2), np.ones(2), 0.2),
])
def test_entry_points_default_to_the_card(call):
    """Without a card, an entry point at its default device raises: nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        call()


def test_kernel_wrappers_take_plain_versions_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch; any other
    device that is not CUDA raises."""
    scene = random_scene(80, 1, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    before = counters.snapshot()
    render(scene, Camera.default(64, 64, device="cpu"),
           RenderConfig(**KW, binning="tiered"))
    assert counters.rise(before, counters.snapshot()) == {}
    meta = torch.zeros((cull.NUM_ROWS, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        cull.cull_mask_from_params(meta, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cull.cull_mask_cuda(torch.zeros((cull.NUM_ROWS, 4)), 8, 8)


def test_kernels_build_on_first_use_only(monkeypatch):
    """Importing the port builds nothing; without nvcc the first launch
    raises and names the toolkit."""
    assert _build._libs == {}
    assert sorted(p.name for p in _build._sources()) == [
        "cull.cu", "feat_bwd.cu", "feat_fwd.cu", "probe_coldma.cu",
        "probe_gather.cu", "probe_transc.cu",
        "probe_tricumsum.cu", "project.cu", "raster_bwd.cu", "raster_fwd.cu", "segsum.cu",
        "segsum_packed.cu", "trace_mark.cu"]
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "gsplat_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_render.py",
              ROOT / "scripts" / "profile_torch_train.py",
              ROOT / "scripts" / "profile_torch_train_default.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "gsplat_tpu"), \
                f"{path.relative_to(ROOT)} imports {mod}"


def test_scene_container_matches_jax_fields():
    from gsplat_tpu.models.gaussians import GaussianScene as JaxScene

    assert [f.name for f in dataclasses.fields(GaussianScene)] == \
        list(SCENE_FIELDS)
    assert set(SCENE_FIELDS) <= {f.name for f in dataclasses.fields(JaxScene)}
