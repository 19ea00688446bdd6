"""The reference training step: the render of `reference/render.py`, the
L1 + DSSIM loss of 3D Gaussian splatting (Kerbl et al. 2023: (1 - w) L1 +
w (1 - SSIM), SSIM over an 11 x 11 Gaussian window of sigma 1.5, zero
padding, variances clamped at 0), its gradient, and Adam with one rate per
scene field, in plain PyTorch and float32 (TF32 off).

The gradient of the blend is taken slot by slot (one slot per (tile,
Gaussian) pair of the binned lists) and summed per Gaussian; where the
configuration states bf16 slot gradients (`gather_backward`) and a bf16
read-out (`grad_readout`), each slot's gradient and each Gaussian's sum
are rounded to bf16, as stated. Through the stream's quantisation the
gradient passes straight.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from splatbench.frozen import SCENE_FIELDS
from splatbench.reference import render as R

WINDOW, SIGMA = 11, 1.5
C1, C2 = 0.01 ** 2, 0.03 ** 2


def _window(device) -> torch.Tensor:
    x = np.arange(WINDOW) - WINDOW // 2
    g = np.exp(-(x ** 2) / (2 * SIGMA ** 2))
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=device)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable zero-padded Gaussian blur of every plane of (1, C, H, W)."""
    c = x.shape[1]
    w = _window(x.device)
    x = F.conv2d(x, w.reshape(1, 1, WINDOW, 1).repeat(c, 1, 1, 1),
                 padding=(WINDOW // 2, 0), groups=c)
    return F.conv2d(x, w.reshape(1, 1, 1, WINDOW).repeat(c, 1, 1, 1),
                    padding=(0, WINDOW // 2), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images."""
    planes = torch.stack([a, b, a * a, b * b, a * b])  # (5, H, W, C)
    h, w, c = a.shape
    x = planes.permute(0, 3, 1, 2).reshape(1, 5 * c, h, w)
    mu_a, mu_b, e_aa, e_bb, e_ab = _blur(x).reshape(5, c, h, w)
    var_a = torch.clamp_min(e_aa - mu_a * mu_a, 0.0)
    var_b = torch.clamp_min(e_bb - mu_b * mu_b, 0.0)
    cov = e_ab - mu_a * mu_b
    s = ((2 * mu_a * mu_b + C1) * (2 * cov + C2)) / (
        (mu_a * mu_a + mu_b * mu_b + C1) * (var_a + var_b + C2))
    return s.mean()


def loss_fn(pred: torch.Tensor, target: torch.Tensor,
            ssim_weight: float) -> torch.Tensor:
    l1 = (pred - target).abs().mean()
    if ssim_weight == 0.0:
        return l1
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim(pred, target))


class Adam:
    """Adam (Kingma and Ba 2015) with one rate per scene field."""

    def __init__(self, params: dict, rates: dict, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.rates = params, rates
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: dict) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            denom = torch.sqrt(self.v[k] / c2) + self.eps
            self.params[k] = self.params[k] - self.rates[k] * (self.m[k] / c1) / denom


def loss_and_grads(params: dict, cam: dict, target: torch.Tensor, rc: dict,
                   tc: dict, dtype=torch.float32, rows: int | None = None,
                   order: str = "unrolled") -> tuple[float, dict]:
    """The step's loss and d loss / d each scene field; `rows`, when
    given, takes the loss over the image's first rows alone (a fault the
    comparison must catch: half of the batch left out); `order`: the
    projection's (`render.project`)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad(), R.full_fp32():
        proj = R.project(leaves, cam, rc, order)
        values = R.straight_through(proj["feats"], rc)
        binned = R.bin_tiles(proj, rc)
        vals = values.detach()
        image = R.image_of(vals, binned, rc, dtype).requires_grad_(True)
        loss = loss_fn(image[:rows], target[:rows], tc["ssim_weight"])
        (g_image,) = torch.autograd.grad(loss, image)
        bf16_slots = rc.get("gather_backward") == "bf16"
        dvals = R.render_vjp(vals, binned, g_image, rc, dtype,
                             torch.bfloat16 if bf16_slots else None)
        if rc.get("grad_readout") == "bf16":
            dvals = dvals.to(torch.bfloat16).float()
        grads = torch.autograd.grad(values, list(leaves.values()), dvals,
                                    allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
             for k, g in zip(leaves, grads)}
    return float(loss.detach()), grads


def run(scene: dict, cams: list, targets: torch.Tensor, rc: dict, tc: dict,
        dtype=torch.float32, rows: int | None = None,
        order: str = "unrolled") -> dict:
    """len(cams) steps from `scene`, one view a step: each step's loss, the
    first step's gradient norm per field and the norm of each field's
    change over all the steps."""
    params = {k: scene[k].detach().clone() for k in SCENE_FIELDS}
    start = {k: v.clone() for k, v in params.items()}
    opt = Adam(params, {k: tc["lr"] * tc["lr_scales"][k] for k in params},
               tuple(tc["betas"]), tc["eps"])
    losses, grad1 = [], None
    for cam, target in zip(cams, targets):
        loss, grads = loss_and_grads(opt.params, cam, target, rc, tc, dtype,
                                     rows, order)
        losses.append(loss)
        if grad1 is None:
            grad1 = {k: float(torch.linalg.vector_norm(g))
                     for k, g in grads.items()}
        opt.step(grads)
    change = {k: float(torch.linalg.vector_norm(opt.params[k] - start[k]))
              for k in params}
    return dict(losses=losses, grad_norms=grad1, change_norms=change)
