"""The gather's scatter-free backward of the port (key sort, segmented
suffix sum, run-start read) against the JAX package's `_gather_slots` VJP
on the same numpy inputs (CPU), with JAX's segment_sum 'doubling' and
'pallas' (its kernel in interpret mode). The port has one segment sum for
both: K4, here its plain version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.ops import binning as jbin  # noqa: E402
from gsplat_tpu.ops.projection import project_gaussians as jax_project  # noqa: E402
from gsplat_tpu_torch import RenderConfig  # noqa: E402
from gsplat_tpu_torch.convert import camera_from_numpy, scene_from_numpy  # noqa: E402
from gsplat_tpu_torch.ops import binning as tbin  # noqa: E402
from gsplat_tpu_torch.ops.projection import project_gaussians  # noqa: E402

KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
          max_tiles_per_gaussian=64, block_size=8, max_per_tile=512,
          pallas_block_size=32)
LADDER = ((4, 0), (8, 2), (16, 6), (32, 25), (64, 50))
MODES = {
    "tiered": dict(binning="tiered", tier_spec=LADDER),
    "legacy": dict(binning="tiered", tier_spec=(8, 5, 16)),
    "packed": dict(binning="packed"),
    "sort": dict(binning="sort"),
}
SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")


def both(mode):
    """One JAX random scene projected and binned by both packages."""
    kw = dict(KW, **MODES[mode])
    jscene = jax_random_scene(jax.random.key(11), 250, sh_degree=2)
    jcam = JaxCamera.default(64, 64)
    jproj = jax_project(jscene, jcam, JaxConfig(**kw))
    jb = jbin.bin_gaussians(jproj, JaxConfig(**kw))
    scene = scene_from_numpy(
        *(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS), device="cpu")
    cam = camera_from_numpy(
        *(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS), device="cpu")
    cfg = RenderConfig(**kw)
    proj = project_gaussians(scene, cam, cfg)
    return jproj, jb, proj, tbin.bin_gaussians(proj, cfg), cfg


@pytest.mark.parametrize("mode", list(MODES))
def test_gauss_offsets_match_jax(mode):
    _, jb, _, tb, _ = both(mode)
    np.testing.assert_array_equal(tb.gauss_offsets.numpy(),
                                  np.asarray(jb.gauss_offsets))
    np.testing.assert_array_equal(tb.gauss_counts.numpy(),
                                  np.asarray(jb.gauss_counts))


@pytest.fixture(scope="module")
def slots():
    """The JAX stream metadata of the bench ladder, random per-Gaussian
    features and random slot gradients, as numpy."""
    _, jb, _, _, cfg = both("tiered")
    rng = np.random.default_rng(3)
    meta = {k: np.array(getattr(jb, k)) for k in
            ("sorted_gid", "sorted_gidk", "gauss_offsets", "gauss_counts")}
    feats = rng.normal(size=(9, meta["gauss_counts"].shape[0])).astype(np.float32)
    dslot = rng.normal(size=(9, cfg.max_intersections)).astype(np.float32)
    return meta, feats, dslot, tbin.kmax_eff(cfg)


@pytest.mark.parametrize("strategy", ["variadic", "permute", "c64"])
@pytest.mark.parametrize("segment_sum", ["doubling", "pallas"])
def test_gather_backward_matches_jax_vjp(slots, strategy, segment_sum):
    """JAX's three f32 strategies and its two segment sums are one path in
    the port."""
    meta, feats, dslot, kmax = slots
    j_segsum = "pallas_interpret" if segment_sum == "pallas" else segment_sum
    args = [jnp.asarray(meta[k]) for k in
            ("sorted_gid", "sorted_gidk", "gauss_offsets", "gauss_counts")]
    _, vjp = jax.vjp(
        lambda f: jbin._gather_slots(kmax, strategy, "f32", j_segsum, f, *args),
        jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(dslot))
    got = tbin.gather_slots_bwd(
        torch.from_numpy(dslot), torch.from_numpy(meta["sorted_gidk"]),
        torch.from_numpy(meta["gauss_offsets"]),
        torch.from_numpy(meta["gauss_counts"]), kmax)
    assert np.abs(got.numpy()).max() > 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("segment_sum", ["doubling", "pallas"])
def test_gather_features_differentiates_through_the_slot_sort(segment_sum):
    """Forward: the JAX gather's values. Backward through autograd: JAX's
    VJP of gather_features on the same projection."""
    jproj, jb, proj, tb, cfg = both("tiered")
    jcfg = JaxConfig(**KW, **MODES["tiered"], segment_sum=segment_sum,
                     pallas_interpret=True)
    cfg = RenderConfig(**KW, **MODES["tiered"], segment_sum=segment_sum)
    dslot = np.random.default_rng(4).normal(
        size=(9, cfg.max_intersections)).astype(np.float32)
    feats = tbin.features_f32(proj, cfg).detach().requires_grad_(True)
    proj_f = type(proj)(**{**vars(proj)})
    # Route the gather through the leaf `feats`: uv, conic, colour and
    # opacity are its rows.
    proj_f.uv = torch.stack([feats[0] / cfg.width, feats[1] / cfg.height], 1)
    proj_f.conic = feats[2:5].T
    proj_f.color = feats[5:8].T
    proj_f.opacity = feats[8]
    out = tbin.gather_features(proj_f, tb, cfg)
    (got,) = torch.autograd.grad(out, feats, torch.from_numpy(dslot))
    jfeats = jbin.features_f32(jproj, jcfg)
    want_out, vjp = jax.vjp(
        lambda f: jbin._gather_slots(
            tbin.kmax_eff(cfg), "variadic", "f32",
            "pallas_interpret" if segment_sum == "pallas" else "doubling",
            f, jb.sorted_gid, jb.sorted_gidk, jb.gauss_offsets,
            jb.gauss_counts), jfeats)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(dslot))[0]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt", [dict(grad_readout="bf16"),
                                 dict(gather_backward="bf16",
                                      grad_readout="bf16",
                                      segment_sum="pallas")])
def test_bf16_gradient_paths_are_slice_3(opt):
    """The bf16 gradient paths, which the port now runs: the read-out
    rounded to bf16, and the 'bf16' strategy (slot gradients as bf16 pairs
    through the sort and the packed segment sum, K5's plain version). Both
    against JAX's `_gather_slots` VJP with the same options: the read-out
    over JAX's doubling (the port's order of sums) bit for bit; the bf16
    strategy, which JAX runs through its packed Pallas kernel (interpreted)
    whose carry across blocks sums in another order, within 1e-5 + 1e-2 of
    each row's largest value."""
    _, _, proj, tb, _ = both("tiered")
    cfg = RenderConfig(**KW, **MODES["tiered"], **opt)
    dslot = np.random.default_rng(6).normal(
        size=(9, cfg.max_intersections)).astype(np.float32)
    feats = tbin.features_f32(proj, cfg).detach().requires_grad_(True)
    proj_f = type(proj)(**{**vars(proj)})
    proj_f.uv = torch.stack([feats[0] / cfg.width, feats[1] / cfg.height], 1)
    proj_f.conic = feats[2:5].T
    proj_f.color = feats[5:8].T
    proj_f.opacity = feats[8]
    out = tbin.gather_features(proj_f, tb, cfg)
    (got,) = torch.autograd.grad(out, feats, torch.from_numpy(dslot))
    args = [jnp.asarray(getattr(tb, k).numpy()) for k in
            ("sorted_gid", "sorted_gidk", "gauss_offsets", "gauss_counts")]
    _, vjp = jax.vjp(
        lambda f: jbin._gather_slots(
            tbin.kmax_eff(cfg), cfg.gather_backward, cfg.grad_readout,
            "pallas_interpret" if cfg.gather_backward == "bf16"
            else "doubling", f, *args),
        jnp.asarray(feats.detach().numpy()))
    want = np.asarray(vjp(jnp.asarray(dslot))[0])
    got = got.numpy()
    assert np.abs(got).max() > 1.0
    if cfg.gather_backward == "bf16":
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert (np.abs(got - want) <= 1e-5 + 1e-2 * scale).all()
    else:
        np.testing.assert_array_equal(got, want)
    # The read-out's values are bf16 values.
    np.testing.assert_array_equal(
        got, torch.from_numpy(got).to(torch.bfloat16).float().numpy())
