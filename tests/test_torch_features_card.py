"""On a CUDA card: K6 and K7, the blend of the colour and 128 feature
channels and its backward (`csrc/feat_fwd.cu`, `csrc/feat_bwd.cu`), held
to the port's plain walks on small frames and to the benchmark's plain
reference (`splatbench/reference/features.py`) on a 1080p view of the
garden configuration. Imports no JAX; skips without a card. On a machine
without JAX, run it without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_features_card.py -q
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from gsplat_tpu_torch import Camera
from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import (
    FeatureScene,
    random_scene,
    realistic_scene,
    with_features,
)
from gsplat_tpu_torch.ops.binning import (
    bin_gaussians,
    features_f32,
    gather_stream,
)
from gsplat_tpu_torch.ops.cuda import features as FE
from gsplat_tpu_torch.ops.cuda import raster as RA
from gsplat_tpu_torch.ops.projection import project_gaussians
from gsplat_tpu_torch.ops.stream16 import gather_packed
from gsplat_tpu_torch.render.pipeline import render
from gsplat_tpu_torch.train.loop import make_optimizer, make_train_step

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from splatbench import gen, port  # noqa: E402
from splatbench.reference import features as RF  # noqa: E402
from splatbench.reference import render as RR  # noqa: E402

C, D = 128, 512
# Gaussians of the 1080p view: garden's statistics at a third of its count,
# to keep the reference's pass short.
N_1080P = 300_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _stream(scene, cfg, dev):
    cam = Camera.default(cfg.width, cfg.height, device=dev)
    with torch.no_grad():
        proj = project_gaussians(scene, cam, cfg)
        binned = bin_gaussians(proj, cfg)
        feats = features_f32(proj, cfg)
        stream = (gather_stream(feats, binned, cfg)
                  if cfg.stream_format == "f32"
                  else gather_packed(feats, binned.sorted_gid, cfg))
    return binned, stream


def _small_frame(dev, fmt, ts, channels):
    """A 192x128 frame of 3000 random Gaussians with `channels` features,
    binned and gathered at tile size ts in stream format fmt."""
    g = torch.Generator(dev).manual_seed(1)
    scene = with_features(random_scene(3000, 3, generator=g, device=dev),
                          channels, 64, generator=g)
    cfg = RenderConfig(width=192, height=128, tile_size=ts,
                       max_intersections=1 << 20, block_size=ts,
                       max_per_tile=8192 // ts * ts, binning="packed",
                       stream_format=fmt,
                       gather_backward="bf16" if fmt != "f32" else "variadic",
                       grad_readout="bf16" if fmt != "f32" else "f32",
                       segment_sum="pallas")
    b, stream = _stream(scene, cfg, dev)
    return cfg, b, stream, scene.features, g


@pytest.mark.card
@pytest.mark.parametrize("channels", [1, 40, C, "above"])
@pytest.mark.parametrize("fmt,ts", [("f32", 8), ("packed4", 16),
                                    ("packed16", 32)])
def test_kernels_against_the_plain_walks(cuda_device, fmt, ts, channels):
    """K6's colour is K1's bit for bit and its map the plain walk's; K7's
    slot and table gradients the plain re-walk's, and K2's with no feature
    gradient: at one channel, at 40 (a pass of 64 partly filled), at the
    cell's 128 and at a C past K7's on-chip budget (walked in passes)."""
    if channels == "above":
        channels = FE._K7_PASS_CHANNELS() + 72
    cfg, b, stream, table, g = _small_frame(cuda_device, fmt, ts, channels)
    gid = b.sorted_gid
    col, tr, fm = FE.feat_fwd_cuda(stream, b.ranges, gid, table, cfg)
    k1c, k1t = RA.raster_tiles_cuda(stream, b.ranges, cfg)
    assert torch.equal(col, k1c) and torch.equal(tr, k1t)
    cpu = [x.cpu() for x in (stream, b.ranges, gid, table)]
    pc, pt, pf = FE.feat_fwd(*cpu, cfg)
    assert float((fm.cpu() - pf).abs().max()) < 1e-6
    gc = torch.randn(col.shape, device=cuda_device, generator=g)
    gt = torch.randn(tr.shape, device=cuda_device, generator=g)
    gf = torch.randn(fm.shape, device=cuda_device, generator=g)
    dgeo, dtab = FE.feat_bwd(stream, b.ranges, gid, b.sorted_gidk, table, gc,
                             col, gt, tr, gf, fm, cfg)
    pd, ptab = FE.feat_bwd(cpu[0], cpu[1], cpu[2], b.sorted_gidk.cpu(),
                           cpu[3], gc.cpu(), pc, gt.cpu(), pt, gf.cpu(), pf,
                           cfg)
    assert float((dgeo.cpu() - pd).abs().max() / pd.abs().max()) < 1e-5
    assert float((dtab.cpu() - ptab).abs().max() / ptab.abs().max()) < 1e-5
    dgeo0, dtab0 = FE.feat_bwd(stream, b.ranges, gid, b.sorted_gidk, table,
                               gc, col, gt, tr, torch.zeros_like(gf), fm, cfg)
    k2 = RA.raster_bwd(stream, b.ranges, gc, col, gt, tr, cfg)
    assert float((dgeo0 - k2).abs().max() / k2.abs().max()) < 1e-5
    assert float(dtab0.abs().max()) == 0.0


def _garden_1080p(dev):
    cfg = json.loads((ROOT / "splatbench" / "configs" /
                      "garden-1m-1080p.json").read_text())
    rc = cfg["render"]
    g = torch.Generator(dev).manual_seed(7)
    scene = with_features(realistic_scene(N_1080P, 3, generator=g, device=dev),
                          C, D, generator=g)
    fields = {f: getattr(scene, f) for f in RF.FIELDS}
    view = gen.view_matrices(dict(layout="disk", count=160, radius=0.1,
                                  turn=0.05, center=[0.7, 0.7]))[11]
    return rc, fields, view


@pytest.mark.card
def test_1080p_view_against_the_reference(cuda_device):
    """The garden configuration's 1080p view: the feature map and image,
    and the step's loss and every field's gradient, against the reference."""
    rc, fields, view = _garden_1080p(cuda_device)
    cfg = port.render_config(rc)
    cam = port.camera(view, rc["width"], rc["height"], cuda_device)
    rcam = RR.camera(view, rc["width"], rc["height"], cuda_device)
    with torch.no_grad():
        out = render(FeatureScene(**fields), cam, cfg)
    ref = RF.render(fields, rcam, rc)
    assert not bool(out.overflow)
    d = out.features - ref["features"]
    rmse, worst = float(torch.sqrt(torch.mean(d * d))), float(d.abs().max())
    assert rmse < 1e-6 and worst < 1e-3, (rmse, worst)
    g = torch.Generator(cuda_device).manual_seed(8)
    target = torch.rand((rc["height"], rc["width"], 3), device=cuda_device,
                        generator=g)
    teacher = torch.randn((D, 270, 480), device=cuda_device,
                          generator=g).to(torch.bfloat16)
    tc = dict(lr=0.01, lr_scales=dict(means=0.016, log_scales=0.5, quats=0.1,
                                      opacity_logits=5.0, sh=0.25),
              ssim_weight=0.2)
    fc = dict(gamma=1.0, lr=1e-3, decoder_lr=1e-4)
    ref_loss, ref_grads = RF.loss_and_grads(fields, rcam, target, teacher, rc,
                                            tc, fc)
    scene = FeatureScene(**{k: v.clone() for k, v in fields.items()})
    step = make_train_step(cfg, make_optimizer(scene), 0.2)
    loss, aux, _ = step(scene, [cam], target[None], 3, teachers=teacher[None])
    assert bool(aux["grads_finite"]) and not bool(aux["overflow"])
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss), (
        float(loss), ref_loss)
    gaps = {f: float(torch.linalg.vector_norm(getattr(scene, f).grad
                                              - ref_grads[f])
                     / torch.linalg.vector_norm(ref_grads[f]))
            for f in RF.FIELDS}
    assert max(gaps.values()) < 2e-2, gaps


def _k7_inputs(dev, channels):
    """The feature cell's layout on the small frame (32x32 tiles, packed4):
    K7's stream inputs and N(0, 1) upstream gradients."""
    cfg, b, stream, table, g = _small_frame(dev, "packed4", 32, channels)
    col, tr, fm = FE.feat_fwd_cuda(stream, b.ranges, b.sorted_gid, table, cfg)
    gc = torch.randn(col.shape, device=dev, generator=g)
    gt = torch.randn(tr.shape, device=dev, generator=g)
    gf = torch.randn(fm.shape, device=dev, generator=g)
    b_total = ((gc * col).sum(1) + gt * tr).contiguous()
    return (stream, b.ranges, b.sorted_gid, table, gc, b_total, gf, fm, cfg)


@pytest.mark.card
@pytest.mark.parametrize("channels", [C, "above"])
def test_k7_slot_gradients_are_the_same_bit_for_bit(cuda_device, channels):
    """Two K7 launches on one stream: the slot gradients (summed in a fixed
    warp and cluster order) equal bit for bit; the table gradient (atomic
    adds in the card's order) within 1e-6 of its largest."""
    if channels == "above":
        channels = FE._K7_PASS_CHANNELS() + 72
    args = _k7_inputs(cuda_device, channels)
    dgeo1, dtab1 = FE.feat_bwd_cuda(*args)
    dgeo2, dtab2 = FE.feat_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert float(dgeo1.abs().max()) > 0.0
    assert torch.equal(dgeo1, dgeo2)
    gap = float((dtab1 - dtab2).abs().max() / dtab1.abs().max())
    assert gap <= 1e-6, gap


@pytest.mark.card
def test_k7_chunked_counts_only_past_the_budget(cuda_device):
    """A launch at the cell's 128 channels walks once and counts under "K7";
    one past the on-chip budget walks in passes and counts under
    "K7.chunked"."""
    from gsplat_tpu_torch.ops.cuda import counters

    assert FE._K7_PASS_CHANNELS() >= C
    for channels, name in ((C, "K7"),
                           (FE._K7_PASS_CHANNELS() + 72, "K7.chunked")):
        args = _k7_inputs(cuda_device, channels)
        before = counters.snapshot()
        FE.feat_bwd_cuda(*args)
        assert counters.rise(before, counters.snapshot()) == {name: 1}
