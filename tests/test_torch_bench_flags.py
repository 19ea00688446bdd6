"""The port's bench against the root `bench.py`, flag for flag (CPU): the
`run_bench` arguments both make for each flag set, on the accelerator's
configuration and off it; and the repair of the host copies inside a frame
(`project_gaussians` and `pack_stream` bit-identical to their old
formulas)."""

import importlib.util
import inspect
import json
import pathlib
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import gsplat_tpu.utils.bench as jax_bench_utils  # noqa: E402
import gsplat_tpu_torch.bench as port_bench  # noqa: E402
import gsplat_tpu_torch.utils.bench as port_bench_utils  # noqa: E402
from gsplat_tpu_torch import RenderConfig  # noqa: E402
from gsplat_tpu_torch.models.gaussians import random_scene  # noqa: E402
from gsplat_tpu_torch.ops import projection, stream16  # noqa: E402
from gsplat_tpu_torch.ops.binning import features_f32  # noqa: E402
from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs  # noqa: E402
from gsplat_tpu_torch.ops.camera import Camera  # noqa: E402
from gsplat_tpu_torch.train import losses  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
root_bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(root_bench)

FLAG_SETS = [
    [],
    ["--viewer"],
    ["--viewer", "--kmax", "64"],
    ["--scene", "realistic"],
    ["--exact-grads"],
    ["--gather-backward", "bf16"],
    ["--gather-backward", "c64", "--exact-grads"],
    ["--tier-spec", "4:0,8:2,16:6,32:25,64:50,128:60"],
    ["--tier-spec", "8,5,64"],
    ["--stream-format", "f32", "--gaussian-sharded", "2"],
    ["--gaussian-sharded", "2", "--per-dest-capacity", "5000",
     "--ssim-weight", "0.2"],
    ["--sharded-tiles", "2", "--data-shards", "2"],
    ["--ssim-weight", "0.2"],
    ["--mode", "fwd", "--segment-sum", "doubling", "--slot-gather", "c64",
     "--matmul-precision", "default"],
    ["--viewer", "--stream-format", "packed16", "--mode", "fwd_bwd"],
]


def _recorder(calls):
    def run_bench(**kw):
        calls.append(kw)
        return {"metric": "m", "value": 1.0, "unit": "it/s",
                "vs_baseline": 0.03, "details": {}}
    return run_bench


def _root_calls(flags, backend, monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jax_bench_utils, "run_bench", _recorder(calls))
    monkeypatch.setattr(sys, "argv", ["bench.py", *flags])
    root_bench.main()
    return calls


def _port_calls(flags, device, monkeypatch):
    calls = []
    monkeypatch.setattr(port_bench_utils, "run_bench", _recorder(calls))
    assert port_bench.main([*flags, "--device", device]) == 0
    for kw in calls:
        assert str(kw.pop("device")) == device
        kw.pop("dist_backend", None)
    return calls


@pytest.mark.parametrize("flags", FLAG_SETS, ids=" ".join)
@pytest.mark.parametrize("backend, device", [("tpu", "cuda"), ("cpu", "cpu")])
def test_bench_kwargs_match_the_root_bench(flags, backend, device,
                                           monkeypatch, tmp_path, capsys):
    """The same run_bench calls, with the same arguments in the same order
    (apart from the port's own device and dist_backend), and the same
    line."""
    want = _root_calls(flags, backend, monkeypatch, tmp_path)
    root_out = capsys.readouterr()
    got = _port_calls(flags, device, monkeypatch)
    port_out = capsys.readouterr()
    assert [list(kw.items()) for kw in got] == \
        [list(kw.items()) for kw in want]
    assert json.loads(port_out.out.splitlines()[-1]) == \
        json.loads(root_out.out.splitlines()[-1])
    viewer_ignored = "--viewer" in flags and backend == "cpu"
    assert ("--viewer is a" in port_out.err) == viewer_ignored
    assert ("--viewer is a" in root_out.err) == viewer_ignored


def test_viewer_and_headline_runs():
    """--viewer is the viewer's frame with the jumbo tiers to 1024; the
    default headline's second run is the realistic scene with the jumbo
    ladder, --scene realistic runs it without."""
    args = port_bench.build_parser().parse_args(["--viewer"])
    kw = port_bench.build_kwargs(args, torch.device("cuda"))
    assert (kw["width"], kw["height"], kw["mode"], kw["iters"]) == \
        (800, 800, "fwd", 30)
    assert kw["max_tiles_per_gaussian"] == 32
    assert kw["max_tiles_jumbo"] == 1024
    assert kw["max_intersections"] == 2_330_000
    assert not port_bench.default_headline(args, torch.device("cuda"))
    args = port_bench.build_parser().parse_args(["--scene", "realistic"])
    kw = port_bench.build_kwargs(args, torch.device("cuda"))
    assert kw["scene_kind"] == "realistic" and "max_tiles_jumbo" not in kw
    assert port_bench.preset("realistic", jumbo=True)["max_tiles_jumbo"] \
        == 2048
    args = port_bench.build_parser().parse_args([])
    assert port_bench.default_headline(args, torch.device("cuda"))
    assert not port_bench.default_headline(args, torch.device("cpu"))


# ---- no host copy inside a frame: the values are the old formulas' ----

OLD_PIX = ("    pix = uv * torch.tensor([cfg.width, cfg.height], "
           "dtype=torch.float32,\n                            "
           "device=uv.device)\n")


def _old_project_gaussians():
    """The projection's plain version (the body of project_gaussians on
    CPU tensors) as it was, with the image size a tensor built on every
    call."""
    src = inspect.getsource(projection._project_plain)
    src, n = re.subn(r"    pix = torch\.stack\(\[.*?\], -1\)\n", OLD_PIX, src,
                     flags=re.S)
    assert n == 1
    space = dict(vars(projection))
    exec(compile(src, projection.__file__, "exec"), space)
    return space["_project_plain"]


def _bits(t):
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


@pytest.mark.parametrize("fmt", ["f32", "packed16", "packed4"])
def test_frame_without_host_copies_is_bit_identical(fmt):
    gen = torch.Generator().manual_seed(5)
    scene = random_scene(400, sh_degree=2, generator=gen, device="cpu")
    scene.log_scales += 1.0  # rects of several tiles
    cfg = RenderConfig(width=96, height=80, tile_size=16,
                       max_intersections=1 << 14, block_size=16,
                       max_per_tile=512, binning="tiered",
                       stream_format=fmt, max_screen_radius=20.0)
    cam = Camera.default(96, 80, device="cpu")
    with torch.no_grad():
        new = projection.project_gaussians(scene, cam, cfg)
        old = _old_project_gaussians()(scene, cam, cfg)
    for f in ("mask", "uv", "conic", "depth", "color", "opacity", "radius",
              "rect", "counts", "overflow"):
        a, b = getattr(new, f), getattr(old, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(_bits(a), _bits(b)), f
    assert int((new.rect[:, 2] - new.rect[:, 0]).max()) > 1
    if fmt == "f32":
        return
    feats = features_f32(new, cfg)
    packed = stream16.pack_stream(feats, cfg)
    if fmt == "packed4":
        want = pack_bf16_pairs(feats[[2, 3, 4, 8]])
        assert torch.equal(packed[1:3], want)
    else:
        assert torch.equal(packed[1:], pack_bf16_pairs(feats[2:9]))
    assert packed.dtype == torch.int32


def test_ssim_window_is_made_once_per_device():
    a = losses._gaussian_window(torch.device("cpu"))
    assert losses._gaussian_window(torch.device("cpu")) is a
    np.testing.assert_array_equal(a.numpy(), losses._gaussian_window_np())
