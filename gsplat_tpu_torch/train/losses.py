"""Training losses: L1 + DSSIM, the standard 3DGS objective (port of
`gsplat_tpu.train.losses`). Images are (H, W, C), as in the JAX package.

SSIM blurs its five moment images with a depthwise separable 11x11 Gaussian
window, all moments in one grouped convolution per axis. The blur runs in
full float32 whatever the caller's global flags say: TF32 keeps about three
decimal digits, and blur(a^2) - blur(a)^2 then loses to cancellation an
error far above the c2 = 9e-4 stabilizer (in the JAX package a bf16 blur
drove the SSIM denominator through zero and killed two training runs; see
`gsplat_tpu/train/losses.py::_blur`). cuDNN convolutions default to TF32,
so `_Blur` sets `allow_tf32=False` around its forward and around its
backward, which autograd would otherwise run outside any such context.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

WINDOW_SIZE = 11
WINDOW_SIGMA = 1.5


@functools.lru_cache()
def _gaussian_window_np(size: int = WINDOW_SIZE,
                        sigma: float = WINDOW_SIGMA) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype("float32")


def _fp32_convs():
    """cuDNN's flags as they are, with TF32 off."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _blur_nchw(x: torch.Tensor) -> torch.Tensor:
    """Separable zero-padded Gaussian blur of every channel of (1, C, H, W)."""
    c = x.shape[1]
    w = torch.from_numpy(_gaussian_window_np()).to(x.device)
    size = w.shape[0]
    with _fp32_convs():
        x = F.conv2d(x, w.reshape(1, 1, size, 1).repeat(c, 1, 1, 1),
                     padding=(size // 2, 0), groups=c)
        return F.conv2d(x, w.reshape(1, 1, 1, size).repeat(c, 1, 1, 1),
                        padding=(0, size // 2), groups=c)


class _Blur(torch.autograd.Function):
    """The blur is self-adjoint (a symmetric window, zero padding), so its
    backward is the same full-f32 blur of the incoming gradient."""

    @staticmethod
    def forward(ctx, x):
        return _blur_nchw(x)

    @staticmethod
    def backward(ctx, g):
        return _blur_nchw(g.contiguous())


def _blur(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> the same shape, each (H, W) plane blurred."""
    h, w, c = img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2).reshape(1, -1, h, w)
    y = _Blur.apply(x.contiguous())
    return y.reshape(-1, c, h, w).permute(0, 2, 3, 1).reshape(img.shape)


SSIM_HALO = 5  # 11x11 window reach: rows this far outside a region affect it


def ssim_map(a: torch.Tensor, b: torch.Tensor, c1: float = 0.01**2,
             c2: float = 0.03**2) -> torch.Tensor:
    """Per-pixel SSIM map over an (H, W, C) pair in [0, 1] (zero-padded
    window statistics at the borders)."""
    mu_a, mu_b, e_aa, e_bb, e_ab = _blur(torch.stack([a, b, a * a, b * b, a * b]))
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    # True variances are >= 0; the clamp removes the cancellation tail so
    # the denominator is >= c1 * c2 > 0 for any input. torch.maximum, not
    # clamp_min: like JAX's maximum it splits the gradient at a tie.
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    sigma_aa = torch.maximum(e_aa - mu_aa, zero)
    sigma_bb = torch.maximum(e_bb - mu_bb, zero)
    sigma_ab = e_ab - mu_ab
    return ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2)
    )


def ssim(a: torch.Tensor, b: torch.Tensor, c1: float = 0.01**2,
         c2: float = 0.03**2) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) pair in [0, 1]."""
    return torch.mean(ssim_map(a, b, c1, c2))


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def rgb_loss(pred: torch.Tensor, target: torch.Tensor,
             ssim_weight: float = 0.2) -> torch.Tensor:
    """(1 - w) L1 + w DSSIM, the graphdeco 3DGS training objective."""
    if ssim_weight == 0.0:
        return l1(pred, target)
    return (1.0 - ssim_weight) * l1(pred, target) + ssim_weight * (
        1.0 - ssim(pred, target)
    )


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-10))
