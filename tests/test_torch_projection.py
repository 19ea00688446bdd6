"""Projection, SH, camera and scene container of the port against the JAX
package on the same numpy inputs (CPU)."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.ops import camera as jcam  # noqa: E402
from gsplat_tpu.ops import projection as jproj  # noqa: E402
from gsplat_tpu.ops.sh import eval_sh as jax_eval_sh  # noqa: E402
from gsplat_tpu_torch import RenderConfig, random_scene  # noqa: E402
from gsplat_tpu_torch.convert import camera_from_numpy, scene_from_numpy  # noqa: E402
from gsplat_tpu_torch.ops import camera as tcam  # noqa: E402
from gsplat_tpu_torch.ops import projection as tproj  # noqa: E402
from gsplat_tpu_torch.ops.sh import eval_sh  # noqa: E402

CFG = dict(width=64, height=64, tile_size=8, max_intersections=1 << 14,
           max_tiles_per_gaussian=64, block_size=8, max_per_tile=256)
SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")


def to_port(jscene, jcamera):
    scene = scene_from_numpy(
        *(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS), device="cpu"
    )
    cam = camera_from_numpy(
        *(np.asarray(getattr(jcamera, f)) for f in CAM_FIELDS), device="cpu"
    )
    return scene, cam


def assert_projected_close(p, j, radius_bound=None):
    for f in ("mask", "rect", "counts", "overflow"):
        np.testing.assert_array_equal(
            getattr(p, f).numpy(), np.asarray(getattr(j, f)), err_msg=f
        )
    for f in ("uv", "depth", "color", "opacity"):
        np.testing.assert_allclose(
            getattr(p, f).numpy(), np.asarray(getattr(j, f)), rtol=1e-5,
            atol=1e-6, err_msg=f,
        )
    # Conic and radius on the Gaussians that survive the cull. A culled one
    # (behind the camera, off screen) keeps whatever its off-diagonal's
    # cancellation gives (measured 6e-5 relative between the packages) and
    # is read nowhere: its counts and rect, compared exactly above, are 0.
    keep = np.asarray(j.mask)
    np.testing.assert_allclose(
        p.conic.numpy()[keep], np.asarray(j.conic)[keep], rtol=1e-5,
        atol=1e-6, err_msg="conic",
    )
    got, want = p.radius.numpy()[keep], np.asarray(j.radius)[keep]
    if radius_bound is not None:
        # The screen-radius clamp shrinks a footprint until 3 sigma lands
        # exactly on the bound, so radius = ceil(bound +- 1 ulp): one f32
        # rounding apart, the two packages take bound or bound + 1 there.
        # Elsewhere the radius is exact.
        at_bound = (want == radius_bound) | (want == radius_bound + 1)
        assert np.all(np.isin(got[at_bound], (radius_bound, radius_bound + 1)))
        got, want = got[~at_bound], want[~at_bound]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg="radius")


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_projection_matches_jax(degree):
    jscene = jax_random_scene(jax.random.key(3 + degree), 300, sh_degree=degree)
    jcamera = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcamera)
    p = tproj.project_gaussians(scene, cam, RenderConfig(**CFG))
    j = jproj.project_gaussians(jscene, jcamera, JaxConfig(**CFG))
    assert bool(p.mask.any())
    assert_projected_close(p, j)


def test_projection_screen_radius_clamp_matches_jax():
    kw = dict(CFG, max_screen_radius=6.0, max_tiles_per_gaussian=4)
    jscene = jax_random_scene(jax.random.key(11), 200, sh_degree=1)
    jscene = jscene.replace(log_scales=jscene.log_scales + 2.0)
    jcamera = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcamera)
    p = tproj.project_gaussians(scene, cam, RenderConfig(**kw))
    j = jproj.project_gaussians(jscene, jcamera, JaxConfig(**kw))
    assert int((np.asarray(j.radius) == 6.0).sum()) > 10  # the clamp bites
    assert_projected_close(p, j, radius_bound=6.0)


def test_projection_off_center_camera_matches_jax():
    """A look_at camera with points behind it and outside the frustum."""
    view = jcam.look_at((1.5, -0.5, -1.0), (0.0, 0.3, 4.0))
    jcamera = JaxCamera.create(view, 64, 48, 60.0, 50.0)
    cam = tcam.Camera.create(view, 64, 48, 60.0, 50.0, device="cpu")
    jscene = jax_random_scene(jax.random.key(5), 300, sh_degree=2)
    scene, _ = to_port(jscene, jcamera)
    kw = dict(CFG, height=48)
    p = tproj.project_gaussians(scene, cam, RenderConfig(**kw))
    j = jproj.project_gaussians(jscene, jcamera, JaxConfig(**kw))
    assert not bool(p.mask.all())
    assert_projected_close(p, j)


def test_uv_tap_zero_leaves_projection_unchanged():
    jscene = jax_random_scene(jax.random.key(1), 50, sh_degree=0)
    scene, cam = to_port(jscene, JaxCamera.default(64, 64))
    cfg = RenderConfig(**CFG)
    a = tproj.project_gaussians(scene, cam, cfg)
    b = tproj.project_gaussians(scene, cam, cfg, uv_tap=torch.zeros(50, 2))
    torch.testing.assert_close(a.uv, b.uv, rtol=0, atol=0)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(size=(100, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(100, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    got = eval_sh(torch.from_numpy(sh), torch.from_numpy(dirs), degree)
    want = jax_eval_sh(jnp.asarray(sh), jnp.asarray(dirs), degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_eval_sh_rejects_bad_degree():
    with pytest.raises(ValueError):
        eval_sh(torch.zeros(1, 4, 3), torch.zeros(1, 3), 4)
    with pytest.raises(ValueError):
        eval_sh(torch.zeros(1, 4, 3), torch.zeros(1, 3), 2)


def test_rotation_and_cov3d_match_jax():
    rng = np.random.default_rng(0)
    quats = rng.normal(size=(64, 4)).astype(np.float32)
    log_scales = rng.uniform(-3, 0, size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tproj.quat_to_rotmat(torch.from_numpy(quats)).numpy(),
        np.asarray(jproj.quat_to_rotmat(jnp.asarray(quats))), rtol=1e-5,
        atol=1e-6,
    )
    np.testing.assert_allclose(
        tproj.compute_cov3d(torch.from_numpy(log_scales),
                            torch.from_numpy(quats), 1.5).numpy(),
        np.asarray(jproj.compute_cov3d(jnp.asarray(log_scales),
                                       jnp.asarray(quats), 1.5)),
        rtol=1e-5, atol=1e-7,
    )


def _assert_camera_equal(c, j):
    for f in CAM_FIELDS:
        np.testing.assert_array_equal(getattr(c, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("make", [
    lambda m: m.Camera.default(800, 600),
    lambda m: m.Camera.create(m.look_at((1.0, 2.0, -3.0), (0.0, 0.0, 4.0)),
                              320, 240, 300.0, 280.0, znear=0.1, zfar=50.0),
    lambda m: m.Camera.from_rt(np.eye(3) * [1, -1, -1], (0.5, 0.2, -4.0),
                               128, 96, 100.0, 90.0),
])
def test_cameras_match_jax(make):
    _assert_camera_equal(make(_Port), make(jcam))


class _Port:
    """The port's camera module with device='cpu' bound."""

    look_at = staticmethod(tcam.look_at)

    class Camera:
        @staticmethod
        def default(*a, **k):
            return tcam.Camera.default(*a, **k, device="cpu")

        @staticmethod
        def create(*a, **k):
            return tcam.Camera.create(*a, **k, device="cpu")

        @staticmethod
        def from_rt(*a, **k):
            return tcam.Camera.from_rt(*a, **k, device="cpu")


def test_orbit_and_fov_helpers_match_jax():
    got = tcam.orbit_cameras((0, 0, 4), 3.0, 5, 64, 64, 60.0, 60.0,
                             device="cpu")
    want = jcam.orbit_cameras((0, 0, 4), 3.0, 5, 64, 64, 60.0, 60.0)
    for c, j in zip(got, want):
        _assert_camera_equal(c, j)
    assert tcam.focal2fov(500.0, 800) == jcam.focal2fov(500.0, 800)
    assert math.isclose(tcam.fov2focal(tcam.focal2fov(500.0, 800), 800), 500.0)
    np.testing.assert_array_equal(tcam.perspective_matrix(0.2, 10.0, 1.0, 0.8),
                                  jcam.perspective_matrix(0.2, 10.0, 1.0, 0.8))


def test_random_scene_distributions_and_seed():
    g = torch.Generator().manual_seed(7)
    s = random_scene(4000, sh_degree=2, generator=g, device="cpu")
    assert s.means.shape == (4000, 3) and s.sh.shape == (4000, 9, 3)
    assert s.num_gaussians == 4000 and s.sh_degree == 2
    z = s.means[:, 2]
    assert float(z.min()) >= 2.0 and float(z.max()) <= 6.0
    assert bool((s.means[:, :2].abs() <= z[:, None] / 2.0 + 1e-6).all())
    assert float(s.log_scales.min()) >= -4.5 and float(s.log_scales.max()) <= -2.5
    torch.testing.assert_close(s.quats.norm(dim=-1), torch.ones(4000))
    assert float(s.opacity_logits.min()) >= -1.0
    assert float(s.opacity_logits.max()) <= 3.0
    assert float(s.sh[:, 0].min()) >= 0.0 and float(s.sh[:, 0].max()) <= 2.0
    assert abs(float(s.sh[:, 1:].std()) - 0.1) < 0.01
    again = random_scene(4000, sh_degree=2,
                         generator=torch.Generator().manual_seed(7),
                         device="cpu")
    for f in SCENE_FIELDS:
        torch.testing.assert_close(getattr(s, f), getattr(again, f),
                                   rtol=0, atol=0)


def test_pad_to_matches_jax():
    jscene = jax_random_scene(jax.random.key(2), 10, sh_degree=1)
    scene, _ = to_port(jscene, JaxCamera.default(8, 8))
    got, want = scene.pad_to(16), jscene.pad_to(16)
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    with pytest.raises(ValueError):
        scene.pad_to(4)


def test_projected_dataclass_fields_match_jax():
    assert [f.name for f in dataclasses.fields(tproj.ProjectedGaussians)] == [
        "mask", "uv", "conic", "depth", "color", "opacity", "radius", "rect",
        "counts", "overflow",
    ]
