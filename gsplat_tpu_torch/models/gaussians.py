"""Scene container: a struct of (N, ...) tensors of Gaussian parameters.

Same five fields, layouts and parameterization as
`gsplat_tpu.models.gaussians.GaussianScene`: scales stored as log(scale),
opacity as a logit, rotation as an unnormalized (w, x, y, z) quaternion,
color as SH coefficients (N, K, 3).

`FeatureScene` adds Feature 3DGS's fields (Zhou et al. 2024,
arXiv:2312.03203): a view-independent feature vector per Gaussian, blended
beside the colour, and the 1x1 decoder that maps a rendered feature map to
the teacher's channels.

`SurfelScene` holds 2D Gaussian splatting's surfels (Huang et al. 2024,
arXiv:2403.17888): the same five fields, with two log-scales a surfel, the
scales of its two tangent axes (the first two columns of the rotation).
"""

from __future__ import annotations

import dataclasses
import math

import torch


def num_sh_coeffs(degree: int) -> int:
    """(degree+1)**2."""
    if degree not in (0, 1, 2, 3):
        raise ValueError(f"Unsupported SH degree: {degree}")
    return (degree + 1) ** 2


@dataclasses.dataclass
class GaussianScene:
    means: torch.Tensor           # (N, 3) world-space positions
    log_scales: torch.Tensor      # (N, 3)
    quats: torch.Tensor           # (N, 4) (w, x, y, z), unnormalized
    opacity_logits: torch.Tensor  # (N,)
    sh: torch.Tensor              # (N, K, 3), K = (sh_degree+1)**2

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round(math.sqrt(self.sh.shape[1]))) - 1

    def pad_to(self, capacity: int) -> "GaussianScene":
        """Pad to a static capacity with Gaussians that never contribute:
        opacity logit -30 (sigmoid ~ 0), log-scale -10, identity rotation."""
        n = self.num_gaussians
        if capacity < n:
            raise ValueError("capacity < current size")
        pad = capacity - n

        def _pad(x, fill):
            return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)], 0)

        quats = _pad(self.quats, 0.0)
        quats[n:, 0] = 1.0
        return GaussianScene(
            means=_pad(self.means, 0.0),
            log_scales=_pad(self.log_scales, -10.0),
            quats=quats,
            opacity_logits=_pad(self.opacity_logits, -30.0),
            sh=_pad(self.sh, 0.0),
        )


@dataclasses.dataclass
class FeatureScene(GaussianScene):
    """A GaussianScene whose Gaussians carry C features each (`features`,
    (N, C) float32, rendered as an (H, W, C) map beside the image), with
    the decoder of the map to the teacher's D channels: decoder_weight (D,
    C) and decoder_bias (D,), a 1x1 convolution."""

    features: torch.Tensor = None         # (N, C)
    decoder_weight: torch.Tensor = None   # (D, C)
    decoder_bias: torch.Tensor = None     # (D,)

    def pad_to(self, capacity: int) -> "FeatureScene":
        """GaussianScene.pad_to, the padding Gaussians' features zero."""
        base = GaussianScene.pad_to(self, capacity)
        pad = capacity - self.num_gaussians
        features = torch.cat(
            [self.features, self.features.new_zeros(
                (pad, self.features.shape[1]))])
        return FeatureScene(**{f.name: getattr(base, f.name)
                               for f in dataclasses.fields(GaussianScene)},
                            features=features,
                            decoder_weight=self.decoder_weight,
                            decoder_bias=self.decoder_bias)


@dataclasses.dataclass
class SurfelScene(GaussianScene):
    """2D Gaussian splatting's surfels: means (N, 3), log_scales (N, 2) of
    the tangent axes t_u, t_v (the first two columns of R(quats); the
    normal is t_u x t_v), quats (N, 4), opacity_logits (N,) and sh (N, K,
    3), as GaussianScene's."""

    def pad_to(self, capacity: int) -> "SurfelScene":
        """GaussianScene.pad_to, with two log-scales a surfel."""
        return SurfelScene(**vars(GaussianScene.pad_to(self, capacity)))


def as_surfels(scene: GaussianScene) -> SurfelScene:
    """The surfels of a scene of 3D Gaussians: each Gaussian's first two
    log-scales and its quaternion as they are (the third axis becomes the
    normal)."""
    return SurfelScene(means=scene.means, log_scales=scene.log_scales[:, :2],
                       quats=scene.quats, opacity_logits=scene.opacity_logits,
                       sh=scene.sh)


# The fields FeatureScene adds, in order.
FEATURE_FIELDS = ("features", "decoder_weight", "decoder_bias")


def with_features(scene: GaussianScene, channels: int, out_channels: int,
                  generator: torch.Generator | None = None,
                  std: float = 0.1) -> FeatureScene:
    """`scene` with C = `channels` features per Gaussian drawn N(0, std^2)
    and a decoder to `out_channels`, its weight drawn as torch's default
    1x1 convolution's (uniform within 1 / sqrt(C)) and its bias zero; the
    draws on the scene's device (`generator`, when given, lives there)."""
    dev = scene.means.device
    kw = dict(device=dev, generator=generator, dtype=torch.float32)
    bound = 1.0 / math.sqrt(channels)
    return FeatureScene(
        **{f.name: getattr(scene, f.name)
           for f in dataclasses.fields(GaussianScene)},
        features=std * torch.randn((scene.num_gaussians, channels), **kw),
        decoder_weight=(torch.rand((out_channels, channels), **kw) * 2 - 1)
        * bound,
        decoder_bias=torch.zeros((out_channels,), dtype=torch.float32,
                                 device=dev))


def random_scene(
    num: int,
    sh_degree: int = 3,
    generator: torch.Generator | None = None,
    device="cuda",
    extent: float = 1.0,
    depth_range: tuple = (2.0, 6.0),
    scale_range: tuple = (-4.5, -2.5),
) -> GaussianScene:
    """Synthetic scene in front of the origin-looking-+z camera, with the
    distributions of `gsplat_tpu.models.gaussians.random_scene`. The values
    differ from JAX's (another generator); `generator`, when given, must
    live on `device`."""
    device = torch.device(device)
    kw = dict(device=device, generator=generator, dtype=torch.float32)

    def uniform(shape, lo, hi):
        return torch.rand(shape, **kw) * (hi - lo) + lo

    xy = uniform((num, 2), -extent, extent)
    z = uniform((num, 1), depth_range[0], depth_range[1])
    means = torch.cat([xy * z / depth_range[0], z], dim=-1)
    log_scales = uniform((num, 3), scale_range[0], scale_range[1])
    quats = torch.randn((num, 4), **kw)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opacity_logits = uniform((num,), -1.0, 3.0)
    k = num_sh_coeffs(sh_degree)
    dc = uniform((num, 1, 3), 0.0, 2.0)
    sh = torch.cat([dc, 0.1 * torch.randn((num, k - 1, 3), **kw)], dim=1)
    return GaussianScene(
        means=means,
        log_scales=log_scales,
        quats=quats,
        opacity_logits=opacity_logits,
        sh=sh,
    )


def realistic_scene(
    num: int,
    sh_degree: int = 3,
    generator: torch.Generator | None = None,
    device="cuda",
    extent: float = 1.0,
    depth_range: tuple = (2.0, 20.0),
    log_scale_mu: float = -4.2,
    log_scale_sigma: float = 1.0,
    aniso_sigma: float = 0.6,
    fat_fraction: float = 0.02,
    fat_log_scale_mu: float = -1.6,
) -> GaussianScene:
    """Heavy-tailed synthetic scene with the distributions of
    `gsplat_tpu.models.gaussians.realistic_scene`, the statistics of trained
    captures: log-normal scales with per-axis anisotropy and a
    `fat_fraction` of huge splats (they stress the tier budgets and need
    the jumbo tiers), bimodal opacity (35% at logit U(-4, -1), 65% at
    U(0.5, 6)), and log-uniform depth. The values differ from JAX's;
    `generator`, when given, must live on `device`."""
    device = torch.device(device)
    kw = dict(device=device, generator=generator, dtype=torch.float32)

    def uniform(shape, lo, hi):
        return torch.rand(shape, **kw) * (hi - lo) + lo

    z = depth_range[0] * torch.exp(
        torch.rand((num, 1), **kw) * math.log(depth_range[1] / depth_range[0]))
    xy = uniform((num, 2), -extent, extent)
    means = torch.cat([xy * z / depth_range[0], z], dim=-1)

    base = log_scale_mu + log_scale_sigma * torch.randn((num, 1), **kw)
    fat = torch.rand((num, 1), **kw) < fat_fraction
    base = torch.where(
        fat, fat_log_scale_mu + 0.5 * torch.randn((num, 1), **kw), base)
    log_scales = base + aniso_sigma * torch.randn((num, 3), **kw)

    quats = torch.randn((num, 4), **kw)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)

    low = uniform((num,), -4.0, -1.0)
    high = uniform((num,), 0.5, 6.0)
    opacity_logits = torch.where(torch.rand((num,), **kw) < 0.35, low, high)

    k = num_sh_coeffs(sh_degree)
    sh = uniform((num, 1, 3), 0.0, 2.0)
    if k > 1:
        sh = torch.cat([sh, 0.1 * torch.randn((num, k - 1, 3), **kw)], dim=1)
    return GaussianScene(
        means=means,
        log_scales=log_scales,
        quats=quats,
        opacity_logits=opacity_logits,
        sh=sh,
    )
