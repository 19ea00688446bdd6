"""2D Gaussian splatting on the port's normal path (`SurfelScene`, `render`,
`render_jit`, `make_train_step`, `fit`, the CLI's `train --surfels`), held
on the CPU to the benchmark's plain reference
(`splatbench/reference/surfels.py`) on seeded random surfels: 200 at 64 x
48, tile 16. The image, alpha, normal, depth and distortion maps, the three
losses and every field's gradient; the binning drops no pair that reaches
alpha_min; a fronto-parallel surfel meets each pixel's ray where the
closed form puts it; and a GaussianScene's and a FeatureScene's train
steps dispatch the operations they dispatched before surfels came.
Imports no JAX."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gsplat_tpu_torch import Camera
from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import (
    SurfelScene,
    as_surfels,
    random_scene,
    with_features,
)
from gsplat_tpu_torch.ops import surfels as S
from gsplat_tpu_torch.render.pipeline import render, render_jit
from gsplat_tpu_torch.train.loop import (
    LAMBDA_DIST,
    LAMBDA_NORMAL,
    fit,
    make_eager_train_step,
    make_optimizer,
    make_train_step,
)
from gsplat_tpu_torch.train.losses import rgb_loss, surfel_regularizers

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from splatbench.reference import surfels as RS  # noqa: E402
from splatbench.reference import train as RT  # noqa: E402

W, H, N = 64, 48, 200
RC = dict(width=W, height=H, tile_size=16, block_size=16,
          max_intersections=1 << 14, max_per_tile=512,
          max_tiles_per_gaussian=12, binning="tiered",
          tier_spec=((2, 0), (4, 2), (12, 4)), max_tiles_jumbo=0,
          jumbo_tier_spec=(), scale_modifier=1.0, sh_degree=3,
          alpha_clamp=0.99, alpha_min=1.0 / 255.0, transmittance_min=1e-4)
TRAIN = dict(lr=0.01, lr_scales=dict(means=0.016, log_scales=0.5, quats=0.1,
                                     opacity_logits=5.0, sh=0.25),
             betas=[0.9, 0.999], eps=1e-8, ssim_weight=0.2)
SURF = dict(filter_inv_square=S.FILTER_INV_SQUARE, near=S.DEPTH_NEAR,
            far=S.DEPTH_FAR, lambda_dist=LAMBDA_DIST,
            lambda_normal=LAMBDA_NORMAL)
CFG = RenderConfig(**RC)


def _scene(seed: int = 0) -> SurfelScene:
    gen = torch.Generator().manual_seed(seed)
    return as_surfels(random_scene(N, 3, gen, device="cpu",
                                   scale_range=(-3.0, -1.5)))


def _camera(turn: float = 0.0) -> Camera:
    c, s = np.cos(turn), np.sin(turn)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    view[:3, 3] = [0.3 * s, 0.0, 0.0]
    return Camera.create(view, W, H, fx=float(W), fy=float(W), device="cpu")


def _ref_cam(cam: Camera) -> dict:
    return dict(view=cam.view, full_proj=cam.full_proj, cam_pos=cam.cam_pos,
                focal=cam.focal, tan_fov=cam.tan_fov, znear=cam.znear)


def _fields(scene) -> dict:
    return {f: getattr(scene, f) for f in RS.FIELDS}


def _target(seed: int = 1) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((H, W, 3), generator=gen)


@pytest.mark.parametrize("turn", [0.0, 0.3])
def test_plain_maps_match_the_reference(turn):
    scene, cam = _scene(), _camera(turn)
    out = render(scene, cam, CFG)
    ref = RS.render(_fields(scene), _ref_cam(cam), RC, SURF)
    assert float(out.alpha.max()) > 0.5  # the frame is not empty
    for name, atol in (("image", 2e-6), ("alpha", 2e-6), ("normals", 2e-6),
                       ("depth", 1e-4), ("distortion", 5e-7)):
        got = getattr(out, name)
        assert got.shape == ref[name].shape, name
        torch.testing.assert_close(got, ref[name], atol=atol, rtol=1e-5,
                                   msg=name)
    assert not bool(out.overflow)


def test_three_losses_match_the_reference():
    scene, cam = _scene(), _camera()
    target = _target()
    out = render(scene, cam, CFG)
    ref = RS.render(_fields(scene), _ref_cam(cam), RC, SURF)
    torch.testing.assert_close(rgb_loss(out.image, target, 0.2),
                               RT.loss_fn(ref["image"], target, 0.2),
                               atol=1e-7, rtol=1e-6)
    for ld, ln in ((1.0, 0.0), (0.0, 1.0)):
        got = surfel_regularizers(out.normals, out.depth, out.distortion,
                                  out.alpha, cam.focal, ld, ln)
        want = RS.loss_fn(ref, target, _ref_cam(cam), dict(TRAIN, ssim_weight=0.0),
                          dict(SURF, lambda_dist=ld, lambda_normal=ln)) \
            - RT.loss_fn(ref["image"], target, 0.0)
        torch.testing.assert_close(got, want, atol=1e-7, rtol=1e-5)
        assert float(got) > 0.0


def test_gradient_of_every_field_matches_the_reference():
    scene, cam = _scene(), _camera(0.3)
    target = _target()
    ref_loss, ref_grads = RS.loss_and_grads(
        {k: v.clone() for k, v in _fields(scene).items()}, _ref_cam(cam),
        target, RC, TRAIN, SURF)
    opt = make_optimizer(scene, lr=TRAIN["lr"])
    step = make_eager_train_step(CFG, opt, ssim_weight=0.2)
    loss, aux, (tap, visible) = step(scene, [cam], target[None])
    assert abs(float(loss) - ref_loss) <= 1e-6 * ref_loss
    assert not bool(aux["overflow"]) and bool(aux["grads_finite"])
    assert bool(visible.any()) and tap.shape == (N, 2)
    for f in RS.FIELDS:
        g, r = getattr(scene, f).grad, ref_grads[f]
        assert float(r.norm()) > 0.0, f
        gap = float((g - r).norm() / r.norm())
        assert gap < 1e-4, (f, gap)


def test_the_binning_drops_no_pair_that_reaches_alpha_min():
    """Every (pixel, surfel) pair of a dense evaluation whose alpha reaches
    alpha_min in front of `near` lies in a tile the surfel was binned to."""
    from gsplat_tpu_torch.ops.binning import bin_gaussians

    for turn in (0.0, 0.3, -0.4):
        scene, cam = _scene(3), _camera(turn)
        proj = S.project_surfels(scene, cam, CFG)
        binned = bin_gaussians(proj, CFG)
        table = S.surfel_table(proj).detach()
        ys, xs = torch.meshgrid(torch.arange(H).float(),
                                torch.arange(W).float(), indexing="ij")
        px, py = xs.reshape(-1, 1), ys.reshape(-1, 1)
        _, z, alpha, _ = S._pair_terms(table[None], px, py, CFG)
        reach = (alpha >= CFG.alpha_min) & (z >= S.DEPTH_NEAR) \
            & proj.mask[None]
        pix, gid = torch.nonzero(reach, as_tuple=True)
        assert gid.numel() > 100
        tile = (py[pix, 0].long() // 16) * CFG.tiles_x + px[pix, 0].long() // 16
        # The binned (tile, surfel) pairs.
        ranges = binned.ranges.long()
        tiles = torch.repeat_interleave(torch.arange(CFG.num_tiles),
                                        ranges[1:] - ranges[:-1])
        gids = binned.sorted_gid[:int(ranges[-1])].long()
        have = set(zip(tiles.tolist(), gids.tolist()))
        missing = [p for p in zip(tile.tolist(), gid.tolist())
                   if p not in have]
        assert not missing, missing[:5]
        # The cull keeps fewer slots than the rects hold.
        assert int(binned.num_intersections) < int(proj.counts[
            proj.mask].sum())


def test_a_fronto_parallel_surfel_meets_each_ray_in_closed_form():
    """A surfel facing the camera at depth d with axes along the image's:
    pixel (x, y) meets its plane at u = ((x - W/2) d / fx - p_x) / s_u, v
    likewise; its depth is d and its normal faces the camera."""
    d, p, su, sv = 3.0, (0.2, -0.1), 0.05, 0.08
    scene = SurfelScene(
        means=torch.tensor([[p[0], p[1], d]]),
        log_scales=torch.log(torch.tensor([[su, sv]])),
        quats=torch.tensor([[1.0, 0.0, 0.0, 0.0]]),
        opacity_logits=torch.tensor([2.0]), sh=torch.zeros((1, 16, 3)))
    cam = _camera()
    proj = S.project_surfels(scene, cam, CFG)
    torch.testing.assert_close(proj.normal, torch.tensor([[0.0, 0.0, -1.0]]))
    table = S.surfel_table(proj)
    fx = float(cam.focal[0])
    cx, cy = float(W) * (0.5 + p[0] / d), float(H) / 2 + fx * p[1] / d
    torch.testing.assert_close(proj.center, torch.tensor([[cx, cy]]))
    xs = torch.tensor([cx - 3.0, cx, cx + 2.0, cx + 1.0])[:, None]
    ys = torch.tensor([cy + 1.0, cy, cy - 2.0, cy + 3.0])[:, None]
    rho, z, _, surf = S._pair_terms(table[None], xs, ys, CFG)
    u = ((xs - W / 2) * d / fx - p[0]) / su
    v = ((ys - H / 2) * d / fx - p[1]) / sv
    rho_f = S.FILTER_INV_SQUARE * ((xs - cx) ** 2 + (ys - cy) ** 2)
    want = torch.minimum(u * u + v * v, rho_f)
    torch.testing.assert_close(rho, want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(z, torch.full_like(z, d), rtol=1e-5, atol=0)
    assert bool(surf[(u * u + v * v < rho_f)].all())


def test_render_jit_and_the_captured_step_run_on_the_cpu():
    scene, cam = _scene(), _camera()
    a = render(scene, cam, CFG)
    b = render_jit(scene, cam, CFG)
    for name in ("image", "normals", "depth", "distortion", "alpha"):
        torch.testing.assert_close(getattr(b, name), getattr(a, name))
    opt = make_optimizer(scene, lr=0.01)
    step = make_train_step(CFG, opt, ssim_weight=0.2)
    target = _target()[None]
    first = float(step(scene, [cam], target)[0])
    for _ in range(4):
        loss = float(step(scene, [cam], target)[0])
    assert np.isfinite(loss) and loss < first


def test_fit_trains_surfels_and_refuses_densification():
    scene, cams = _scene(), [_camera(0.0), _camera(0.3)]
    targets = torch.stack([_target(1), _target(2)])
    trained, metrics = fit(scene, cams, targets, CFG, steps=3, log_every=1)
    assert isinstance(trained, SurfelScene)
    assert trained.log_scales.shape == (N, 2)
    assert all(np.isfinite(m["loss"]) for m in metrics)
    with pytest.raises(ValueError, match="SurfelScene"):
        fit(scene, cams, targets, CFG, steps=3, densify_every=1)


def test_cli_train_surfels_runs(tmp_path):
    from gsplat_tpu_torch import cli

    out = tmp_path / "s.pt"
    rc = cli.main(["train", "--synthetic-n", "150", "--steps", "2",
                   "--views", "2", "--width", "32", "--height", "32",
                   "--tile-size", "8", "--block-size", "8",
                   "--max-per-tile", "256", "--device", "cpu", "--surfels",
                   "--out", str(out)])
    assert rc == 0
    fields = torch.load(out)
    assert fields["log_scales"].shape == (150, 2)


class _Ops(TorchDispatchMode):
    """Counts the aten operations dispatched."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


# The aten operations of the second eager train step of a GaussianScene
# and of a FeatureScene (`_step_ops`; the first also makes Adam's state),
# counted on the tree before surfels came (3107 and 3320), then again when
# the tiered binning came to compact before its sort (153 more each: its
# plain tier count and emit on CPU tensors).
STEP_OPS = {"gaussians": 3260, "features": 3473}


def _step_ops(kind: str) -> int:
    gen = torch.Generator().manual_seed(5)
    scene = random_scene(N, 3, gen, device="cpu", scale_range=(-3.0, -1.5))
    if kind == "features":
        scene = with_features(scene, 8, 16, gen)
    opt = make_optimizer(scene, lr=0.01)
    step = make_eager_train_step(CFG, opt, ssim_weight=0.2)
    kw = {} if kind == "gaussians" else dict(
        teachers=torch.rand((1, 16, 12, 16), generator=gen))
    step(scene, [_camera()], _target()[None], **kw)
    with _Ops() as ops:
        step(scene, [_camera()], _target()[None], **kw)
    return ops.n


@pytest.mark.parametrize("kind", sorted(STEP_OPS))
def test_3dgs_steps_dispatch_the_operations_they_did(kind):
    assert _step_ops(kind) == STEP_OPS[kind]


@pytest.mark.parametrize("field,value", [("stream_format", "packed4"),
                                         ("gather_backward", "bf16"),
                                         ("grad_readout", "bf16")])
def test_render_refuses_a_stream_the_surfels_do_not_read(field, value):
    """The blend reads a float32 table by slot id and sums float32 slot
    gradients: a configuration that selects another stream or a bf16
    gradient path is refused, not ignored."""
    extra = dict(segment_sum="pallas", grad_readout="bf16") \
        if field == "gather_backward" else {}
    cfg = RenderConfig(**dict(RC, **extra, **{field: value}))
    with pytest.raises(ValueError, match="surfels"):
        render(_scene(), _camera(), cfg)


def test_surfel_weights_go_with_a_surfel_optimizer():
    """The step knows a SurfelScene's optimizer by what `make_optimizer`
    made it for, not by a shape, and refuses the regularisers' weights
    for any other scene."""
    from gsplat_tpu_torch.train.loop import trains_surfels

    gen = torch.Generator().manual_seed(5)
    gauss = random_scene(N, 3, gen, device="cpu", scale_range=(-3.0, -1.5))
    opt = make_optimizer(gauss, lr=0.01)
    assert not trains_surfels(opt)
    for kw in (dict(lambda_dist=1.0), dict(lambda_normal=0.1)):
        for make in (make_train_step, make_eager_train_step):
            with pytest.raises(ValueError, match="SurfelScene"):
                make(CFG, opt, 0.2, **kw)
    assert trains_surfels(make_optimizer(_scene(), lr=0.01))


def test_chip_smoke_surfel_row_walk_is_the_frames():
    """chip_smoke.py's phase 24 holds K10 and K11 on one tile row to the
    plain walk of each of its tiles (`plain_surfel_row`). On the CPU,
    where the blend is the plain walk of the whole frame, the row's tiles
    give the frame's maps on that row and autograd's table gradient from
    upstream gradients zero outside the row; `compare_surfel_row` passes
    them and fails a normal map 1e-3 off."""
    import chip_smoke as cs
    from gsplat_tpu_torch.ops.binning import bin_gaussians

    scene, cam = _scene(3), _camera(0.3)
    with torch.no_grad():
        proj = S.project_surfels(scene, cam, CFG)
        b = bin_gaussians(proj, CFG)
        table = S.surfel_table(proj)
    leaf = table.clone().requires_grad_(True)
    outs = S.blend_surfels_plain(leaf, b.sorted_gid, b.ranges, CFG)
    gen = torch.Generator().manual_seed(5)
    ups = [torch.randn(o.shape, generator=gen) for o in outs]
    row = cs.heaviest_row_index(b.ranges, CFG)
    ups_row = cs.row_only(ups, row, CFG)
    (have,) = torch.autograd.grad(outs, leaf, ups_row)
    outs = [o.detach() for o in outs]
    plain = cs.plain_surfel_row(table, b.sorted_gid, b.ranges, ups_row, row,
                                CFG)
    res = cs.compare_surfel_row(outs, have, plain)
    assert res["ok"], res
    assert max(res["maps"]) < 1e-6 and max(res["columns"]) < 1e-5, res
    assert float(have.abs().max()) > 0.0
    outs[2] = outs[2] + 1e-3
    assert not cs.compare_surfel_row(outs, have, plain)["ok"]


def test_chip_smoke_surfel_projection_check():
    """Phase 24's K12 check passes the plain projection against itself
    and fails a homography 1e-4 off or a depth one rounding off."""
    import dataclasses

    import chip_smoke as cs

    with torch.no_grad():
        p = S.project_surfels(_scene(3), _camera(0.3), CFG)
    assert cs.compare_surfel_projection(p, p)["ok"]
    off = dataclasses.replace(p, transform=p.transform * (1.0 + 1e-4))
    assert not cs.compare_surfel_projection(off, p)["ok"]
    off = dataclasses.replace(p, depth=torch.nextafter(
        p.depth, torch.full_like(p.depth, float("inf"))))
    assert not cs.compare_surfel_projection(off, p)["ok"]


@pytest.mark.parametrize("turn", [0.0, 0.3, -0.4])
def test_the_reference_bins_by_a_bound_of_its_own(turn):
    """The reference's lists (`reference/surfels.bin_tiles`) hold every
    (pixel, surfel) pair of a dense evaluation whose alpha reaches
    alpha_min; their maps are those of the program's lists (the pairs only
    they hold leave every sum as it is); and a pair the program's binning
    drops, planted by cutting each proxy rect's last tile column, shows
    in them."""
    from splatbench.reference import render as RR

    from gsplat_tpu_torch.ops.binning import bin_gaussians

    scene, cam = _scene(3), _camera(turn)
    rc = dict(RC, surfel_filter=SURF["filter_inv_square"])
    with torch.no_grad():
        proj = RS.project(_fields(scene), _ref_cam(cam), rc)
        own = RS.bin_tiles(proj, rc)
        prog = RR.bin_tiles(proj, rc)
        table = S.surfel_table(S.project_surfels(scene, cam, CFG))
    # Dense: every pair that reaches alpha_min is in the reference's lists.
    ys, xs = torch.meshgrid(torch.arange(H).float(), torch.arange(W).float(),
                            indexing="ij")
    px, py = xs.reshape(-1, 1), ys.reshape(-1, 1)
    _, z, alpha, _ = S._pair_terms(table[None], px, py, CFG)
    reach = (alpha >= CFG.alpha_min) & (z >= S.DEPTH_NEAR) \
        & proj["valid_own"][None]
    pix, gid = torch.nonzero(reach, as_tuple=True)
    assert gid.numel() > 100
    tile = (py[pix, 0].long() // 16) * CFG.tiles_x + px[pix, 0].long() // 16
    tiles = torch.repeat_interleave(torch.arange(CFG.num_tiles),
                                    own["counts"])
    have = set(zip(tiles.tolist(), own["gid"].tolist()))
    assert all(p in have for p in zip(tile.tolist(), gid.tolist()))
    # Pairs the program does not list are there, and change no map.
    assert int((~own["listed"]).sum()) > 0
    assert int(own["listed"].sum()) <= own["slots"] == prog["gid"].numel()
    tab = proj["table"]
    want = RS.maps_of(tab, dict(prog, listed=torch.ones_like(
        prog["gid"], dtype=torch.bool)), rc, SURF)
    # (Their blocks of slots fall apart where the extra pairs come: the
    # products and sums round apart.)
    torch.testing.assert_close(RS.maps_of(tab, own, rc, SURF), want,
                               atol=2e-6, rtol=1e-5)
    # A proxy that drops pairs: the reference still applies them.
    cut = dict(proj, rect=proj["rect"].clone())
    cut["rect"][:, 2] = torch.maximum(cut["rect"][:, 0] + 1,
                                      cut["rect"][:, 2] - 1)
    short = RR.bin_tiles(cut, rc)
    assert short["gid"].numel() < prog["gid"].numel()
    dropped = RS.maps_of(tab, dict(short, listed=torch.ones_like(
        short["gid"], dtype=torch.bool)), rc, SURF)
    assert float((dropped - want).abs().max()) > 1e-3
    torch.testing.assert_close(
        RS.maps_of(tab, RS.bin_tiles(cut, rc), rc, SURF), want, atol=2e-6,
        rtol=1e-5)
