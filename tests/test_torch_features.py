"""Feature 3DGS on the port's normal path (`FeatureScene`, `render`,
`render_jit`, `make_train_step`, `fit`, the CLI's `train --features`),
held on the CPU to the benchmark's plain reference
(`splatbench/reference/features.py`) on seeded random weights: 2,000
Gaussians at 64 x 48, C = 128 features, a decoder to 512 channels, 12 x 16
teachers. A scene without features keeps its path: the colour of a feature
scene is the plain scene's bit for bit, and the blend's backward with a
zero feature gradient gives the plain backward's slot gradients. The
captured step's replay runs on a card where one is present. Imports no
JAX."""

import sys
from pathlib import Path

import pytest
import torch

from gsplat_tpu_torch import Camera
from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import (
    FeatureScene,
    GaussianScene,
    realistic_scene,
    with_features,
)
from gsplat_tpu_torch.ops.binning import NUM_FEATURES
from gsplat_tpu_torch.ops.blend import blend_block, blend_block_bwd, init_carry
from gsplat_tpu_torch.render.pipeline import render, render_jit
from gsplat_tpu_torch.train.loop import (
    DECODER_LR,
    FEATURE_LR,
    FEATURE_WEIGHT,
    fit,
    make_eager_train_step,
    make_optimizer,
    make_train_step,
)
from gsplat_tpu_torch.train.losses import decoded_l1

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from splatbench import gen  # noqa: E402
from splatbench.reference import features as RF  # noqa: E402
from splatbench.reference import render as RR  # noqa: E402

W, H, N, C, D, TEACHER_HW = 64, 48, 2000, 128, 512, (12, 16)
FIELDS = RF.FIELDS
# The packed4 stream with bf16-pair slot gradients (the garden cell's), and
# the float32 stream with float32 ones.
CONFIGS = {
    "packed4": dict(binning="tiered", tier_spec=((4, 0), (8, 2), (16, 6),
                                                 (64, 8)),
                    stream_format="packed4", gather_backward="bf16",
                    grad_readout="bf16", segment_sum="pallas"),
    "f32": dict(binning="packed", stream_format="f32"),
}
RC_COMMON = dict(width=W, height=H, tile_size=8, max_intersections=1 << 16,
                 max_tiles_per_gaussian=64, block_size=8, max_per_tile=512,
                 max_tiles_jumbo=0, jumbo_tier_spec=(), scale_modifier=1.0,
                 sh_degree=3, frustum_ndc_limit=1.1, lowpass=0.3,
                 radius_sigma=3.0, eigen_clamp=0.1, alpha_clamp=0.99,
                 alpha_min=1.0 / 255.0, transmittance_min=1e-4,
                 max_screen_radius=0.0)
TRAIN = dict(lr=0.01, lr_scales=dict(means=0.016, log_scales=0.5, quats=0.1,
                                     opacity_logits=5.0, sh=0.25),
             betas=[0.9, 0.999], eps=1e-8, ssim_weight=0.2)
FEAT = dict(gamma=FEATURE_WEIGHT, lr=FEATURE_LR, decoder_lr=DECODER_LR)


def _rc(name):
    rc = dict(RC_COMMON, **CONFIGS[name])
    rc.setdefault("tier_spec", (8, 5, 16))
    rc.setdefault("gather_backward", "variadic")
    rc.setdefault("grad_readout", "f32")
    rc.setdefault("segment_sum", "doubling")
    return rc


def _cfg(rc):
    keys = {f for f in RenderConfig.__dataclass_fields__}
    return RenderConfig(**{k: v for k, v in rc.items() if k in keys})


def _fields(seed=3):
    g = torch.Generator().manual_seed(seed)
    scene = with_features(realistic_scene(N, 3, generator=g, device="cpu"),
                          C, D, generator=g)
    fields = {f: getattr(scene, f) for f in FIELDS}
    fields["decoder_bias"] = 0.05 * torch.randn(D, generator=g)
    return fields


def _view(seed=3):
    return gen.view_matrices(dict(layout="disk", count=4, radius=0.1,
                                  turn=0.05, center=[0.7, 0.7]))[seed % 4]


def _inputs(seed=3):
    g = torch.Generator().manual_seed(seed + 100)
    target = torch.rand((H, W, 3), generator=g)
    teacher = torch.randn((D,) + TEACHER_HW, generator=g).to(torch.bfloat16)
    return target, teacher


def _cam(view):
    return Camera.create(view, W, H, fx=float(W), fy=float(H), znear=0.01,
                         zfar=100.0, device="cpu")


@pytest.mark.parametrize("fmt", sorted(CONFIGS))
def test_maps_agree_with_the_reference(fmt):
    rc = _rc(fmt)
    fields = _fields()
    view = _view()
    with torch.no_grad():
        out = render(FeatureScene(**fields), _cam(view), _cfg(rc))
    ref = RF.render(fields, RR.camera(view, W, H, "cpu"), rc)
    assert out.features.shape == (H, W, C)
    assert not bool(out.overflow)
    assert float(out.features.abs().max()) > 1e-2
    assert float((out.features - ref["features"]).abs().max()) < 1e-5
    assert float((out.image - ref["image"]).abs().max()) < 1e-5


@pytest.mark.parametrize("fmt", sorted(CONFIGS))
def test_step_loss_and_gradients_agree_with_the_reference(fmt):
    """One step of the captured step's body (eager on the CPU): its loss,
    and the gradient of every field, the decoder's included, against the
    reference's."""
    rc = _rc(fmt)
    fields = _fields()
    view = _view()
    target, teacher = _inputs()
    scene = FeatureScene(**{k: v.clone() for k, v in fields.items()})
    opt = make_optimizer(scene, lr=TRAIN["lr"])
    step = make_train_step(_cfg(rc), opt, ssim_weight=TRAIN["ssim_weight"])
    loss, aux, _ = step(scene, [_cam(view)], target[None], 3,
                        teachers=teacher[None])
    ref_loss, ref_grads = RF.loss_and_grads(
        fields, RR.camera(view, W, H, "cpu"), target, teacher, rc, TRAIN,
        FEAT)
    assert bool(aux["grads_finite"]) and not bool(aux["overflow"])
    assert abs(float(loss) - ref_loss) <= 1e-6 * abs(ref_loss)
    for f in FIELDS:
        got, want = getattr(scene, f).grad, ref_grads[f]
        gap = float(torch.linalg.vector_norm(got - want)
                    / torch.linalg.vector_norm(want))
        assert gap < 2e-3, (f, gap)


def test_feature_loss_is_the_decoded_l1():
    fields = _fields()
    fmap = torch.randn((H, W, C), generator=torch.Generator().manual_seed(1))
    _, teacher = _inputs()
    got = decoded_l1(fmap.permute(2, 0, 1)[None], teacher,
                     fields["decoder_weight"], fields["decoder_bias"])
    want = RF.feature_loss(fmap, teacher, fields["decoder_weight"],
                           fields["decoder_bias"])
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


def test_render_jit_carries_the_feature_map():
    rc = _rc("packed4")
    scene = FeatureScene(**_fields())
    cam = _cam(_view())
    with torch.no_grad():
        want = render(scene, cam, _cfg(rc))
    got = render_jit(scene, cam, _cfg(rc))
    assert torch.equal(got.features, want.features)
    assert torch.equal(got.image, want.image)
    plain = render_jit(GaussianScene(**{f: getattr(scene, f) for f in
                                        RF.SCENE_FIELDS}), cam, _cfg(rc))
    assert plain.features is None


@pytest.mark.parametrize("fmt", sorted(CONFIGS))
def test_a_scene_without_features_keeps_its_path(fmt):
    """The colour and transmittance of a feature scene are the plain
    scene's bit for bit; a plain scene's train step refuses teachers, a
    feature scene's needs them."""
    rc = _rc(fmt)
    fields = _fields()
    cam = _cam(_view())
    plain = GaussianScene(**{f: fields[f] for f in RF.SCENE_FIELDS})
    with torch.no_grad():
        a = render(plain, cam, _cfg(rc))
        b = render(FeatureScene(**fields), cam, _cfg(rc))
    assert torch.equal(a.image, b.image)
    assert torch.equal(a.transmittance, b.transmittance)
    assert a.features is None
    scene = GaussianScene(**{k: v.clone() for k, v in
                             plain.__dict__.items()})
    step = make_eager_train_step(_cfg(rc), make_optimizer(scene))
    target, teacher = _inputs()
    step(scene, [cam], target[None], 3)
    with pytest.raises(ValueError):
        step(scene, [cam], target[None], 3, teachers=teacher[None])
    fstep = make_eager_train_step(_cfg(rc), make_optimizer(
        FeatureScene(**{k: v.clone() for k, v in fields.items()})))
    with pytest.raises(ValueError):
        fstep(FeatureScene(**fields), [cam], target[None], 3)


def test_blend_block_with_zero_feature_gradient_is_the_plain_block():
    """The plain walk's block with C feature rows under the stream: its
    colour rows and, with no gradient on the features, its 9 slot gradients
    are the block's without them, bit for bit."""
    g = torch.Generator().manual_seed(5)
    t, p, gs = 3, 16, 8
    feat = torch.rand((t, NUM_FEATURES, gs), generator=g)
    feat[:, 0:2] *= 4.0
    feat[:, 2:5] = feat[:, 2:5] * 0.5 + torch.tensor([1.0, 0.0, 1.0])[:, None]
    extra = torch.randn((t, 7, gs), generator=g)
    px = torch.arange(p, dtype=torch.float32)[None, :, None] % 4
    py = torch.div(torch.arange(p), 4, rounding_mode="floor").float()[
        None, :, None]
    cfg = RenderConfig(width=4, height=4, tile_size=4, block_size=8,
                       max_per_tile=8)
    rng = torch.ones((t, 1, gs), dtype=torch.bool)
    plain, _ = blend_block(init_carry(p, (t,)), feat, px, py, rng, cfg)
    wide, _ = blend_block(init_carry(p, (t,), channels=10),
                          torch.cat([feat, extra], 1), px, py, rng, cfg)
    assert torch.equal(plain.color, wide.color[:, :3])
    g_col = torch.randn((t, 3, p), generator=g)
    b_tot = (g_col * plain.color).sum(1)[..., None]
    d_plain, *_ = blend_block_bwd(init_carry(p, (t,)), feat, px, py, rng,
                                  g_col, b_tot, torch.zeros((t, p, 1)), cfg)
    g_wide = torch.cat([g_col, torch.zeros((t, 7, p))], 1)
    d_wide, *_ = blend_block_bwd(init_carry(p, (t,)),
                                 torch.cat([feat, extra], 1), px, py, rng,
                                 g_wide, b_tot, torch.zeros((t, p, 1)), cfg)
    assert torch.equal(d_plain, d_wide[:, :NUM_FEATURES])
    assert d_wide.shape[1] == NUM_FEATURES + 7


def test_optimizer_groups_of_a_feature_scene():
    scene = FeatureScene(**_fields())
    opt = make_optimizer(scene, lr=0.01)
    names = [grp["name"] for grp in opt.param_groups]
    assert names == list(FIELDS)
    rates = {grp["name"]: grp["lr"] for grp in opt.param_groups}
    assert rates["features"] == FEATURE_LR
    assert rates["decoder_weight"] == rates["decoder_bias"] == DECODER_LR


def test_rates_and_gamma_come_from_the_caller():
    """make_optimizer's feature and decoder rates and the step's gamma
    (`feature_weight`) are the caller's: the step's loss and gradients
    against the reference's at a configuration's own values."""
    rc = _rc("f32")
    fields = _fields()
    view = _view()
    target, teacher = _inputs()
    feat = dict(gamma=0.5, lr=2e-3, decoder_lr=3e-4)
    scene = FeatureScene(**{k: v.clone() for k, v in fields.items()})
    opt = make_optimizer(scene, lr=TRAIN["lr"], feature_lr=feat["lr"],
                         decoder_lr=feat["decoder_lr"])
    rates = {grp["name"]: grp["lr"] for grp in opt.param_groups}
    assert rates == RF.rates(TRAIN, feat)
    step = make_eager_train_step(_cfg(rc), opt, TRAIN["ssim_weight"],
                                 feature_weight=feat["gamma"])
    loss, _, _ = step(scene, [_cam(view)], target[None], 3,
                      teachers=teacher[None])
    ref_loss, ref_grads = RF.loss_and_grads(
        fields, RR.camera(view, W, H, "cpu"), target, teacher, rc, TRAIN,
        feat)
    assert abs(float(loss) - ref_loss) <= 1e-6 * abs(ref_loss)
    got, want = scene.decoder_weight.grad, ref_grads["decoder_weight"]
    assert float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want)) < 1e-5


@pytest.mark.parametrize("fmt", sorted(CONFIGS))
def test_chip_smoke_tile_row_walk_is_the_frames(fmt):
    """chip_smoke.py's phase 22 holds K6 and K7 on one tile row to the
    plain walks of that row alone (`plain_feature_band`). On the CPU, where
    `feat_fwd` and `feat_bwd` are the plain walks of the whole frame, the
    row's walk gives the frame's outputs on that row (from upstream
    gradients zero outside it), and `compare_features` passes them and
    fails a feature map 1e-4 off."""
    import chip_smoke as cs
    from gsplat_tpu_torch.ops.binning import (
        bin_gaussians,
        features_f32,
        gather_stream,
    )
    from gsplat_tpu_torch.ops.cuda import features as FE
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.raster_torch import _image_to_tiles
    from gsplat_tpu_torch.ops.stream16 import gather_packed

    cfg = _cfg(_rc(fmt))
    scene = FeatureScene(**_fields())
    with torch.no_grad():
        proj = project_gaussians(scene, _cam(_view()), cfg)
        b = bin_gaussians(proj, cfg)
        feats = features_f32(proj, cfg)
        stream = (gather_stream(feats, b, cfg) if fmt == "f32"
                  else gather_packed(feats, b.sorted_gid, cfg))
    args = (stream, b.ranges, b.sorted_gid)
    col, tr, fm = FE.feat_fwd(*args, scene.features, cfg)
    g = torch.Generator().manual_seed(5)
    grads = [torch.randn(x.shape, generator=g) for x in (col, tr, fm)]
    row = cs.heaviest_row_index(b.ranges, cfg)
    bc, bt, bf = cs.band_only(*grads, row, cfg)
    dgeo, dtab = FE.feat_bwd(*args, b.sorted_gidk, scene.features, bc, col,
                             bt, tr, bf, fm, cfg)
    p = cs.plain_feature_band(*args, b.sorted_gidk, scene.features, bc, bt,
                              bf, row, cfg)
    s0, s1 = p["slots"]
    t0, t1 = row * cfg.tiles_x, (row + 1) * cfg.tiles_x
    k = dict(colors=col[t0:t1], trans=tr[t0:t1],
             fmap=_image_to_tiles(fm, cfg)[t0:t1], dgeo=dgeo[:, s0:s1],
             dtable=dtab)
    assert s1 > s0 and p["applied"] > 0 and float(dtab.abs().max()) > 0
    assert int((dgeo[:, :s0] != 0).sum() + (dgeo[:, s1:] != 0).sum()) == 0
    for name in ("colors", "trans", "fmap", "dtable"):
        assert torch.equal(k[name], p[name]), name
    # The row walked alone sums its backward in another block order.
    assert float((k["dgeo"] - p["dgeo"]).abs().max()) <= \
        1e-6 * float(p["dgeo"].abs().max())
    assert cs.compare_features(k, p)["ok"]
    assert not cs.compare_features(dict(k, fmap=k["fmap"] + 1e-4), p)["ok"]


def test_fit_trains_the_features_and_the_decoder():
    rc = _rc("packed4")
    fields = _fields()
    cams = [_cam(_view(s)) for s in range(2)]
    target, teacher = _inputs()
    start = FeatureScene(**fields)
    trained, metrics = fit(start, cams, torch.stack([target, target]),
                           _cfg(rc), steps=2, log_every=1, on_metrics=dict,
                           teachers=torch.stack([teacher, teacher]))
    assert isinstance(trained, FeatureScene) and len(metrics) == 2
    for f in RF.FEATURE_FIELDS:
        assert not torch.equal(getattr(trained, f), fields[f]), f
    with pytest.raises(ValueError):
        fit(start, cams, torch.stack([target, target]), _cfg(rc), steps=1)


def test_cli_train_with_features(tmp_path):
    from gsplat_tpu_torch import cli

    out = tmp_path / "t.ply"
    rc = cli.main(["train", "--synthetic-n", "200", "--steps", "1",
                   "--views", "1", "--width", "32", "--height", "32",
                   "--tile-size", "8", "--block-size", "8",
                   "--max-per-tile", "256", "--device", "cpu", "--features",
                   "16", "--out", str(out)])
    assert rc == 0
    saved = torch.load(f"{out}.features.pt")
    assert saved["features"].shape == (200, 16)
    assert saved["decoder_weight"].shape == (512, 16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_captured_step_replays_on_the_card(cuda_device):
    """The captured step (a CUDA graph, K6 and K7 inside) replayed: the
    replays' losses and gradients of every field against the reference's
    at the same parameters."""
    from gsplat_tpu_torch.utils import graphs

    rc = _rc("packed4")
    fields = {k: v.to(cuda_device) for k, v in _fields().items()}
    view = _view()
    target, teacher = (x.to(cuda_device) for x in _inputs())
    scene = FeatureScene(**{k: v.clone() for k, v in fields.items()})
    opt = make_optimizer(scene, lr=TRAIN["lr"])
    step = make_train_step(_cfg(rc), opt, ssim_weight=TRAIN["ssim_weight"])
    cam = Camera.create(view, W, H, fx=float(W), fy=float(H), znear=0.01,
                        zfar=100.0, device=cuda_device)
    before = graphs.captures["train_step"]
    for _ in range(3):
        now = {f: getattr(scene, f).detach().clone() for f in FIELDS}
        loss, aux, _ = step(scene, [cam], target[None], 3,
                            teachers=teacher[None])
        ref_loss, ref_grads = RF.loss_and_grads(
            now, RR.camera(view, W, H, cuda_device), target, teacher, rc,
            TRAIN, FEAT)
        assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
        for f in FIELDS:
            got, want = getattr(scene, f).grad, ref_grads[f]
            gap = float(torch.linalg.vector_norm(got - want)
                        / torch.linalg.vector_norm(want))
            assert gap < 5e-3, (f, gap)
    assert graphs.captures["train_step"] == before + 1


@pytest.mark.card
def test_two_captured_feature_steps_in_one_process(cuda_device):
    """Two feature steps made one after the other capture two graphs into
    the train steps' one pool, the decoder's cuBLAS GEMMs inside both; the
    second replays the reference's loss as the first."""
    from gsplat_tpu_torch.utils import graphs

    rc = _rc("packed4")
    view = _view()
    target, teacher = (x.to(cuda_device) for x in _inputs())
    cam = Camera.create(view, W, H, fx=float(W), fy=float(H), znear=0.01,
                        zfar=100.0, device=cuda_device)
    before = graphs.captures["train_step"]
    for seed in (3, 4):
        fields = {k: v.to(cuda_device) for k, v in _fields(seed).items()}
        scene = FeatureScene(**{k: v.clone() for k, v in fields.items()})
        step = make_train_step(_cfg(rc), make_optimizer(scene, lr=0.01),
                               ssim_weight=TRAIN["ssim_weight"])
        for _ in range(2):
            now = {f: getattr(scene, f).detach().clone() for f in FIELDS}
            loss, aux, _ = step(scene, [cam], target[None], 3,
                                teachers=teacher[None])
        ref_loss, _ = RF.loss_and_grads(
            now, RR.camera(view, W, H, cuda_device), target, teacher, rc,
            TRAIN, FEAT)
        assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
        del step, scene
    assert graphs.captures["train_step"] == before + 2


def test_kernel_launch_counters_are_registered():
    """K6's and K7's launches count in `ops/cuda/counters.py` (a replay
    adds its graph's); the plain path on the CPU launches neither."""
    from gsplat_tpu_torch.ops.cuda import counters

    before = counters.snapshot()
    assert {"K6", "K7"} <= set(before)
    with torch.no_grad():
        render(FeatureScene(**_fields()), _cam(_view()), _cfg(_rc("f32")))
    assert counters.rise(before, counters.snapshot()) == {}
