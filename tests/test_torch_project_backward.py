"""The projection's hand-derived backward (`project_backward`, the plain
version of kernel K9) against autograd of the plain forward
(`_project_plain`), and `project_gaussians` as one autograd function on CPU
tensors (CPU)."""

import sys
from pathlib import Path

import pytest
import torch

from gsplat_tpu_torch import Camera, RenderConfig, random_scene
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops import projection as P

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
# The repo's scene-gradient tolerance.
RTOL, ATOL = 5e-3, 1e-5
CFG = dict(width=64, height=64, tile_size=8, max_intersections=1 << 14,
           max_tiles_per_gaussian=64, block_size=8, max_per_tile=256)


def _upstream(n, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g) for shape in
            ((n, 2), (n, 3), (n, 3), (n,))]


def _autograd(scene, cam, cfg, upstream, uv_tap=None):
    """Autograd of the plain forward: the five fields' gradients, and the
    tap's."""
    leaves = [getattr(scene, f).detach().clone().requires_grad_(True)
              for f in FIELDS]
    tap = None if uv_tap is None else uv_tap.clone().requires_grad_(True)
    p = P._project_plain(GaussianScene(*leaves), cam, cfg, tap)
    inputs = leaves + ([] if tap is None else [tap])
    return torch.autograd.grad([p.uv, p.conic, p.color, p.opacity], inputs,
                               upstream)


def _assert_chain(scene, cam, cfg, upstream, uv_tap=None):
    want = _autograd(scene, cam, cfg, upstream, uv_tap)
    got = P.project_backward(scene, cam, cfg, *upstream)
    for name, a, b in zip(FIELDS, got, want):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, msg=name)
    if uv_tap is not None:  # the tap's gradient is uv's
        torch.testing.assert_close(want[5], upstream[0], rtol=0, atol=0)


@pytest.mark.parametrize("tap", [False, True], ids=["no_tap", "tap"])
@pytest.mark.parametrize("max_screen_radius", [0.0, 6.0])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_backward_matches_autograd(degree, max_screen_radius, tap):
    scene = random_scene(300, sh_degree=degree,
                         generator=torch.Generator().manual_seed(degree),
                         device="cpu")
    if max_screen_radius:  # splats large enough for the clamp to bite
        scene = GaussianScene(scene.means, scene.log_scales + 2.0,
                              scene.quats, scene.opacity_logits, scene.sh)
    cfg = RenderConfig(**CFG, max_screen_radius=max_screen_radius)
    cam = Camera.default(64, 64, device="cpu")
    p = P._project_plain(scene, cam, cfg)
    assert bool(p.mask.any()) and not bool(p.mask.all())
    if max_screen_radius:
        assert int((p.radius == max_screen_radius).sum()) > 10
    uv_tap = torch.zeros(300, 2) if tap else None
    _assert_chain(scene, cam, cfg, _upstream(300, 7 + degree), uv_tap)


@pytest.mark.parametrize("lowpass", [0.3, 0.0])
def test_backward_on_every_branch(lowpass):
    """chip_smoke's edge scene: behind the camera, before the near plane,
    outside the frustum with txy clamped, opacity under alpha_min, colour
    clamped at 0, rects past K_max, a zero view direction, and at a zero
    low-pass zero covariances (det = 0)."""
    scene = cs.projection_edge_scene("cpu")
    cam = cs.projection_edge_camera("cpu")
    cfg = cs.projection_edge_config(lowpass=lowpass)
    t: dict = {}
    p = P._project_plain(scene, cam, cfg, terms=t)
    k = 16
    group = {g: slice(i * k, (i + 1) * k)
             for i, g in enumerate(cs.EDGE_GROUPS)}
    tz = t["p_view"][:, 2]
    u = t["p_view"][:, :2] / t["tz_safe"][:, None]
    det = t["c"][0] * t["c"][2] - t["c"][1] * t["c"][1]
    assert bool(p.mask[group["visible"]].all())
    assert bool((tz[group["behind"]] < 0).all())
    assert bool(((tz > 0) & (tz < 0.2))[group["before_near"]].all())
    assert not bool(t["in_frustum"][group["outside"]].any())
    assert bool((u.abs() > t["lim_xy"]).any())
    assert bool((p.opacity[group["faint"]] < cfg.alpha_min).all())
    assert bool((t["color_raw"][group["dark"]] < 0).all())
    assert bool(p.overflow) and int(p.counts.max()) == 16
    assert bool((t["rel_norm"][-2:] == 0).all())
    if lowpass == 0:
        assert bool((det[group["degenerate"]] == 0).all())
        assert not bool(p.mask[group["degenerate"]].any())
    _assert_chain(scene, cam, cfg, _upstream(scene.num_gaussians, 3),
                  torch.zeros(scene.num_gaussians, 2))


def test_backward_is_zero_without_upstream_gradients():
    """Gaussians whose four upstream gradients are all zero (no slot,
    behind the camera, culled) get zeros; the rest the full chain."""
    scene = cs.projection_edge_scene("cpu")
    cam = cs.projection_edge_camera("cpu")
    cfg = cs.projection_edge_config()
    p = P._project_plain(scene, cam, cfg)
    up = _upstream(scene.num_gaussians, 5)
    keep = p.mask
    masked = [torch.where(keep.view(-1, *([1] * (g.dim() - 1))), g,
                          torch.zeros_like(g)) for g in up]
    full = P.project_backward(scene, cam, cfg, *up)
    got = P.project_backward(scene, cam, cfg, *masked)
    for a, b in zip(got, full):
        assert bool((a[~keep] == 0).all())
        assert torch.equal(a[keep], b[keep])


def test_project_gaussians_runs_the_plain_versions_on_cpu():
    """On CPU tensors the autograd function's forward is `_project_plain`
    bit for bit, its backward `project_backward` and uv's gradient the
    tap's; depth and radius carry none, and a render without gradients
    keeps no graph."""
    scene = random_scene(200, sh_degree=3,
                         generator=torch.Generator().manual_seed(9),
                         device="cpu")
    cam = Camera.default(64, 64, device="cpu")
    cfg = RenderConfig(**CFG)
    leaves = GaussianScene(*(getattr(scene, f).clone().requires_grad_(True)
                             for f in FIELDS))
    tap = torch.zeros(200, 2, requires_grad=True)
    q = P.project_gaussians(leaves, cam, cfg, uv_tap=tap)
    p = P._project_plain(scene, cam, cfg)
    for f in P.PROJECTED_FIELDS:
        assert torch.equal(getattr(q, f), getattr(p, f)), f
    assert not (q.depth.requires_grad or q.radius.requires_grad)
    up = _upstream(200, 11)
    got = torch.autograd.grad(
        [q.uv, q.conic, q.color, q.opacity],
        [getattr(leaves, f) for f in FIELDS] + [tap], up)
    want = P.project_backward(scene, cam, cfg, *up)
    for a, b in zip(got[:5], want):
        assert torch.equal(a, b)
    assert torch.equal(got[5], up[0])
    with torch.no_grad():
        assert P.project_gaussians(leaves, cam, cfg).uv.grad_fn is None


def test_phase_23_comparisons_see_a_difference():
    """chip_smoke's K8 and K9 comparisons pass the plain version against
    itself and fail a copy one ulp off on 1% of uv, one rect off, or one
    gradient off by 1%."""
    import dataclasses

    scene = cs.projection_edge_scene("cpu")
    cam = cs.projection_edge_camera("cpu")
    cfg = cs.projection_edge_config()
    p = P._project_plain(scene, cam, cfg)
    assert cs.compare_projected(p, p)["ok"]
    uv = p.uv.clone()
    uv.view(-1)[::50] = torch.nextafter(uv.view(-1)[::50],
                                       torch.tensor(float("inf")))
    off = cs.compare_projected(dataclasses.replace(p, uv=uv), p)
    assert not off["ok"] and off["uv_ulps"] == 1 and off["uv"] < 0.999
    rect = p.rect.clone()
    rect[0, 0] += 1
    assert not cs.compare_projected(dataclasses.replace(p, rect=rect), p)["ok"]
    grads = P.project_backward(scene, cam, cfg,
                               *_upstream(scene.num_gaussians, 2))
    assert cs.compare_projection_grads(grads, grads)["ok"]
    bent = [g.clone() for g in grads]
    i = int(bent[0].abs().argmax())
    bent[0].view(-1)[i] *= 1.01
    assert not cs.compare_projection_grads(bent, grads)["ok"]
