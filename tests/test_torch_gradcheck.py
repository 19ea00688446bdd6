"""BASELINE config 1's gradient checks on the port (the counterpart of
tests/test_gradcheck.py), on the CPU: autodiff through the port's whole
pipeline against central finite differences of the port's own loss, the
tiled gradients against the dense oracle's, and no NaN from aligned padding
slots. The scenes are the JAX test's, drawn by JAX and carried across as
numpy arrays; eps and the tolerances are the JAX test's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu_torch import RenderConfig  # noqa: E402
from gsplat_tpu_torch.convert import camera_from_numpy, scene_from_numpy  # noqa: E402
from gsplat_tpu_torch.ops.projection import project_gaussians  # noqa: E402
from gsplat_tpu_torch.ops.raster_torch import rasterize_dense_oracle  # noqa: E402
from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS, render_loss  # noqa: E402

CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
CFG = RenderConfig(
    width=32, height=32, tile_size=8, max_intersections=1 << 12,
    max_tiles_per_gaussian=32, block_size=8, max_per_tile=128,
)
EPS = 1e-3


def _port(jscene, size):
    scene = scene_from_numpy(*(np.asarray(getattr(jscene, f))
                               for f in SCENE_FIELDS), device="cpu")
    jcam = JaxCamera.default(size, size)
    cam = camera_from_numpy(*(np.asarray(getattr(jcam, f))
                              for f in CAM_FIELDS), device="cpu")
    return scene, cam


def _setup():
    """The JAX test's 24-Gaussian SH-1 scene (key 11) and target (key 12)."""
    scene, cam = _port(jax_random_scene(jax.random.key(11), 24, sh_degree=1),
                       CFG.width)
    target = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.key(12), (CFG.height, CFG.width, 3))))
    return scene, cam, target


def _grads(loss_fn, scene) -> dict:
    leaves = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in SCENE_FIELDS}
    loss = loss_fn(dataclasses.replace(scene, **leaves))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {f: g.numpy() for f, g in zip(SCENE_FIELDS, grads)}


def test_grad_finite_and_nonzero():
    scene, cam, target = _setup()
    g = _grads(lambda s: render_loss(s, cam, target, CFG), scene)
    for name, arr in g.items():
        assert np.all(np.isfinite(arr)), f"non-finite grad in {name}"
        assert np.any(arr != 0.0), f"all-zero grad in {name}"


@pytest.mark.parametrize("field", ["means", "opacity_logits", "sh",
                                   "log_scales", "quats"])
def test_grad_matches_finite_differences(field):
    """Four random coordinates of the field (the JAX test's draws, seed 0,
    in its field order), each analytic derivative against the central
    difference of the port's own float32 loss."""
    scene, cam, target = _setup()
    g = _grads(lambda s: render_loss(s, cam, target, CFG), scene)
    rng = np.random.default_rng(0)
    order = ["means", "opacity_logits", "sh", "log_scales", "quats"]
    for f in order[:order.index(field) + 1]:
        flat_size = getattr(scene, f).numel()
        picks = rng.choice(flat_size, size=4, replace=False)
    base = getattr(scene, field).numpy().astype(np.float64)
    flat = base.reshape(-1)
    for idx in picks:
        bump = np.zeros_like(flat)
        bump[idx] = EPS
        pert = bump.reshape(base.shape).astype(np.float32)

        def loss_at(values):
            s = dataclasses.replace(scene, **{
                field: torch.from_numpy(values.astype(np.float32))})
            with torch.no_grad():
                return float(render_loss(s, cam, target, CFG))

        fd = (loss_at(base + pert) - loss_at(base - pert)) / (2 * EPS)
        an = g[field].reshape(-1)[idx]
        # f32 forward -> FD noise floor ~1e-4/eps; tolerate both scales.
        assert abs(fd - an) < 5e-3 + 0.05 * abs(fd), (
            f"{field}[{idx}]: fd={fd:.6f} analytic={an:.6f}")


def test_tiled_and_oracle_grads_agree():
    scene, cam, target = _setup()

    def loss_oracle(s):
        img, _ = rasterize_dense_oracle(project_gaussians(s, cam, CFG), CFG)
        return torch.mean(torch.abs(img - target))

    g1 = _grads(lambda s: render_loss(s, cam, target, CFG), scene)
    g2 = _grads(loss_oracle, scene)
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(g1[f], g2[f], rtol=5e-3, atol=1e-5,
                                   err_msg=f)


def test_no_nan_grads_with_aligned_padding_slots():
    """stream_align pads every tile's segment with slots that gather the
    zero column (opacity exactly 0); no NaN may come of them (the JAX
    test's regression: d_op = moments / opacity on such lanes)."""
    cfg = RenderConfig(width=64, height=64, tile_size=8,
                       max_intersections=1 << 13, max_tiles_per_gaussian=64,
                       block_size=8, max_per_tile=256, binning="tiered",
                       tier_spec=(8, 5, 64), stream_align=16,
                       pallas_block_size=32)
    scene, cam = _port(jax_random_scene(jax.random.key(0), 150, sh_degree=1),
                       64)
    target = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.key(1), (64, 64, 3))))
    g = _grads(lambda s: render_loss(s, cam, target, cfg), scene)
    for name, arr in g.items():
        assert np.all(np.isfinite(arr)), name
        assert np.any(arr != 0.0), name
