"""On a CUDA card: K8, the projection and SH colour, and K9, its backward
(`csrc/project.cu`), against their plain versions run on the card: K8's
outputs against `_project_plain`'s within chip_smoke's stated share of
bits (`compare_projected`), K9's gradients, through `project_gaussians`'
autograd function, against autograd of `_project_plain` at the
scene-gradient tolerance (`compare_projection_grads`), zeros where the
upstream gradients are zero; one K8 a frame and a step, one K9 a step, on
captured calls. Imports no JAX; skips without a card. On a machine without
JAX, run it without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_project_card.py -q -s
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from gsplat_tpu_torch import Camera, RenderConfig, random_scene
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops import projection as P
from gsplat_tpu_torch.ops.cuda import counters

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
N = 300_000


@pytest.fixture
def cuda_device():
    """cuda:0, or a skip where there is no card (decided here, not while the
    module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _bench_cfg(**kw):
    from gsplat_tpu_torch import bench

    card = {k: v for k, v in bench.CARD.items()
            if k not in ("num_gaussians", "impl", "mode", "iters")}
    return RenderConfig(**dict(card, **bench.DEFAULT, **kw))


def _case(name, degree, device):
    """(scene, camera, cfg) of a case: the bench's 1080p view of a random
    scene at each SH degree, with the screen-radius clamp, or chip_smoke's
    edge scene (every branch) at the default and a zero low-pass."""
    if name.startswith("edge"):
        cfg = cs.projection_edge_config(
            lowpass=0.0 if name == "edge_lowpass0" else 0.3)
        return (cs.projection_edge_scene(device),
                cs.projection_edge_camera(device), cfg)
    scene = random_scene(N, degree, generator=torch.Generator(
        device).manual_seed(degree), device=device)
    cfg = _bench_cfg()
    if name == "clamped":
        cfg = _bench_cfg(max_screen_radius=48.0)
        scene = GaussianScene(scene.means, scene.log_scales + 1.5,
                              scene.quats, scene.opacity_logits, scene.sh)
    return scene, Camera.default(cfg.width, cfg.height, device=device), cfg


CASES = [("random", d) for d in range(4)] + [
    ("clamped", 3), ("edge", 3), ("edge_lowpass0", 3)]


@pytest.mark.card
@pytest.mark.parametrize("name,degree", CASES)
def test_kernels_against_the_plain_versions(cuda_device, name, degree):
    scene, cam, cfg = _case(name, degree, cuda_device)
    n = scene.num_gaussians
    tap = torch.zeros(n, 2, device=cuda_device)
    before = counters.snapshot()
    with torch.no_grad():
        k = P.project_gaussians(scene, cam, cfg, uv_tap=tap)
        p = P._project_plain(scene, cam, cfg, tap)
    fwd = cs.compare_projected(k, p)
    gen = torch.Generator(cuda_device).manual_seed(degree)
    up = [torch.randn(s, generator=gen, device=cuda_device)
          for s in ((n, 2), (n, 3), (n, 3), (n,))]

    def grads(project, upstream):
        leaves = [getattr(scene, f).detach().clone().requires_grad_(True)
                  for f in FIELDS]
        t = tap.clone().requires_grad_(True)
        q = project(GaussianScene(*leaves), cam, cfg, t)
        return torch.autograd.grad([q.uv, q.conic, q.color, q.opacity],
                                   leaves + [t], upstream)

    got = grads(P.project_gaussians, up)
    want = grads(P._project_plain, up)
    exact = cs.float64_grads([getattr(scene, f) for f in FIELDS], cam, cfg,
                             up)
    bwd = cs.compare_projection_grads(got[:5], want[:5], exact)
    masked = [torch.where(k.mask.view(-1, *([1] * (g.dim() - 1))), g,
                          torch.zeros_like(g)) for g in up]
    got_m = grads(P.project_gaussians, masked)
    print(f"{name} (SH {degree}, {n} Gaussians, {int(k.mask.sum())} "
          f"visible): K8 {json.dumps(fwd)}; K9 {json.dumps(bwd)}")
    assert counters.rise(before, counters.snapshot()) == {"K8": 3, "K9": 2}
    assert fwd["ok"] and bwd["ok"]
    assert torch.equal(got[5], up[0]) and torch.equal(got_m[5], masked[0])
    for a, b in zip(got_m[:5], got[:5]):
        assert bool((a[~k.mask] == 0).all())
        assert torch.equal(a[k.mask], b[k.mask])


@pytest.mark.card
def test_one_launch_a_frame_and_a_step(cuda_device):
    """A captured frame launches K8 once; a captured train step K8 and K9
    once a view, replay or capture."""
    from gsplat_tpu_torch.render.pipeline import render_jit
    from gsplat_tpu_torch.train.loop import make_optimizer, make_train_step

    scene, cam, cfg = _case("random", 3, cuda_device)
    before = counters.snapshot()
    for _ in range(3):
        render_jit(scene, cam, cfg)
    rose = counters.rise(before, counters.snapshot())
    assert (rose.get("K8"), rose.get("K9")) == (3, None)
    target = torch.zeros((1, cfg.height, cfg.width, 3), device=cuda_device)
    step = make_train_step(cfg, make_optimizer(scene, lr=1e-3),
                           ssim_weight=0.2)
    for _ in range(3):
        loss, aux, _ = step(scene, [cam], target)
    assert bool(aux["grads_finite"]) and not bool(aux["overflow"])
    rose = counters.rise(before, counters.snapshot())
    assert (rose["K8"], rose["K9"]) == (6, 3)
    (entry,) = step.graphs.entries.values()
    assert entry.launches.get("K8") == 1
    assert entry.launches.get("K9") == 1
