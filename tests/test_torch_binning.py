"""Cull mask (plain version of kernel K3) and tiered/packed/sort binning of
the port against the JAX package on the same numpy inputs (CPU). The JAX
cull runs as the JAX package's own tests run it: the Pallas kernel in
interpret mode."""

import dataclasses

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
from gsplat_tpu.ops.pallas.cull import cull_mask_from_params as jax_cull_rows  # noqa: E402
from gsplat_tpu.ops.pallas.cull import cull_params as jax_cull_params  # noqa: E402
from gsplat_tpu.ops.pallas.cull import tile_cull_mask_pallas  # noqa: E402
from gsplat_tpu.ops.projection import project_gaussians as jax_project  # noqa: E402
from gsplat_tpu_torch import Camera, RenderConfig, random_scene  # noqa: E402
from gsplat_tpu_torch.convert import camera_from_numpy, scene_from_numpy  # noqa: E402
from gsplat_tpu_torch.ops import binning as tbin  # noqa: E402
from gsplat_tpu_torch.ops.cuda import cull  # noqa: E402
from gsplat_tpu_torch.models.gaussians import GaussianScene  # noqa: E402
from gsplat_tpu_torch.ops.projection import project_gaussians  # noqa: E402

import tiered_oracle  # noqa: E402

BASE = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
            max_tiles_per_gaussian=64, block_size=8, max_per_tile=512,
            pallas_block_size=32)


# The scenes of the cull's parity tests.
CULL_SCENES = [
    BASE,
    dict(BASE, tile_size=32, max_tiles_per_gaussian=16, block_size=8,
         max_per_tile=256, pallas_block_size=128),
    dict(BASE, width=48, height=40, tile_size=8, max_tiles_per_gaussian=32),
]


def both(kw, key=7, n=400, degree=1, scale_shift=0.0):
    """Port and JAX projections of one JAX random scene, and both configs."""
    jscene = jax_random_scene(jax.random.key(key), n, sh_degree=degree)
    if scale_shift:
        jscene = jscene.replace(log_scales=jscene.log_scales + scale_shift)
    jcam = JaxCamera.default(kw["width"], kw["height"])
    scene = scene_from_numpy(
        *(np.asarray(getattr(jscene, f)) for f in
          ("means", "log_scales", "quats", "opacity_logits", "sh")),
        device="cpu",
    )
    cam = camera_from_numpy(
        *(np.asarray(getattr(jcam, f)) for f in
          ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
           "znear")),
        device="cpu",
    )
    cfg, jcfg = RenderConfig(**kw), JaxConfig(**kw, impl="pallas",
                                              pallas_interpret=True)
    return (project_gaussians(scene, cam, cfg), cfg,
            jax_project(jscene, jcam, jcfg), jcfg)


@pytest.mark.parametrize("kw", CULL_SCENES)
def test_cull_mask_matches_jax_pallas(kw):
    """The plain mask equals the Pallas (interpret) kernel's mask exactly on
    the same parameters. No lane flips at the tau threshold here; were one
    to, it would have to sit within |qmin - tau| <= 1e-5 |tau| (an f32
    rounding of the quadratic), and this test would say so."""
    proj, cfg, jproj, jcfg = both(kw, scale_shift=1.0)
    params = cull.cull_params(proj, cfg)
    np.testing.assert_allclose(
        params.numpy(), np.asarray(jax_cull_params(jproj, jcfg)), rtol=1e-5,
        atol=1e-5,
    )
    got = cull.cull_mask_plain(params, cfg.max_tiles_per_gaussian,
                               cfg.tile_size)
    want = np.asarray(tile_cull_mask_pallas(jproj, jcfg))
    assert got.shape == want.shape and 0 < int(got.sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), want)
    # The CPU wrapper takes the plain version, and the jnp twin agrees.
    np.testing.assert_array_equal(
        cull.tile_cull_mask(proj, cfg).numpy(),
        np.asarray(jbin._rect_cull_mask(
            jproj, dataclasses.replace(jcfg, impl="jnp"), jproj.mask.shape[0],
            cfg.max_tiles_per_gaussian,
            jnp.maximum(jproj.rect[:, 2] - jproj.rect[:, 0], 1),
        )),
    )


@pytest.mark.parametrize("tile_culling", [True, False])
@pytest.mark.parametrize("kw", CULL_SCENES)
def test_compaction_matches_jax_row_sort(kw, tile_culling):
    """The base tiers' compact_k and counts (K3's compact stage; its plain
    route here) equal the JAX package's compaction bit for bit:
    sort(where(_rect_cull_mask, k, kmax), axis=1) and the row sums."""
    proj, cfg, jproj, jcfg = both(dict(kw, tile_culling=tile_culling),
                                  scale_shift=1.0)
    kmax = cfg.max_tiles_per_gaussian
    valid = jbin._rect_cull_mask(
        jproj, jcfg, jproj.mask.shape[0], kmax,
        jnp.maximum(jproj.rect[:, 2] - jproj.rect[:, 0], 1))
    want = jnp.sort(jnp.where(valid, jnp.arange(kmax, dtype=jnp.int32)[None],
                              kmax), axis=1)
    compact, counts = tbin._compact_candidates(proj, cfg)
    assert compact.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(compact.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(valid.sum(axis=1, dtype=jnp.int32)))
    assert 0 < int(counts.sum()) < counts.numel() * kmax
    if tile_culling:  # the plain compact route of the kernel's stage
        got = cull.cull_compact_plain(cull.cull_params(proj, cfg), kmax,
                                      cfg.tile_size)
        assert all(torch.equal(g, w) for g, w in zip(got, (compact, counts)))


def test_unculled_compaction_is_not_sorted(monkeypatch):
    """Without the cull the surviving k are 0 .. counts - 1, already in
    order: the compaction takes where(k < counts, k, kmax) as it is, with
    no sort, and it equals the sorted route bit for bit."""
    proj, cfg, _, _ = both(dict(BASE, tile_culling=False), scale_shift=1.0)
    kmax = cfg.max_tiles_per_gaussian
    k = torch.arange(kmax, dtype=torch.int32)[None, :]
    valid = k < proj.counts[:, None]
    want = torch.sort(torch.where(valid, k, kmax), dim=1).values
    monkeypatch.setattr(torch, "sort", None)
    compact, counts = tbin._compact_candidates(proj, cfg)
    assert torch.equal(compact, want)
    assert torch.equal(counts, valid.sum(dim=1, dtype=torch.int32))


def test_plain_cull_keeps_nans_like_jax():
    """Hand-made rows with a NaN in each of the ten parameters: the plain
    mask (which K3 is held to on the card) equals the JAX cull's, which
    keeps NaNs through its minima and clamps. A NaN centre, threshold,
    origin, width or bound drops every lane; a NaN conic term keeps only
    the lanes whose tile holds the centre (qmin is 0 there)."""
    rng = np.random.default_rng(0)
    n, per = 120, 12
    p = np.zeros((cull.NUM_ROWS, n), np.float32)
    p[cull.R_GX], p[cull.R_GY] = rng.uniform(8, 56, (2, n))
    p[cull.R_A], p[cull.R_C] = rng.uniform(1e-3, 5e-2, (2, n))
    p[cull.R_B] = rng.uniform(-5e-3, 5e-3, n)
    p[cull.R_TAU] = rng.uniform(1.0, 8.0, n)
    p[cull.R_X0] = np.floor(p[cull.R_GX] / 8) - 1
    p[cull.R_Y0] = np.floor(p[cull.R_GY] / 8) - 1
    p[cull.R_W], p[cull.R_COUNT] = 3.0, 9.0
    for f in range(cull.NUM_ROWS):
        p[f, f * per:(f + 1) * per] = np.nan
    got = cull.cull_mask_plain(torch.from_numpy(p), 16, 8)
    want = np.asarray(jax_cull_rows(jnp.asarray(p), 16, 8, True))
    np.testing.assert_array_equal(got.numpy(), want)
    kept = got.reshape(cull.NUM_ROWS, per, 16).sum(dim=(1, 2)).tolist()
    conic = (cull.R_A, cull.R_B, cull.R_C)
    assert all((kept[f] > 0) == (f in conic) for f in range(cull.NUM_ROWS))
    assert all(kept[f] <= per for f in conic)  # one centre tile per row
    # The other stages' plain routes on the same rows.
    compact, counts = cull.cull_compact_plain(torch.from_numpy(p), 16, 8)
    mask, krank, counts_r = cull.cull_rank_plain(torch.from_numpy(p), 16, 8)
    assert torch.equal(mask, got) and torch.equal(counts, counts_r)
    assert torch.equal(krank, torch.cumsum(got, 1, dtype=torch.int32) - 1)


def test_cull_on_unsupported_device_raises():
    params = torch.zeros((10, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        cull.cull_mask_from_params(params, 8, 8)


def _per_tile_multisets(sorted_gid, ranges):
    g, r = np.asarray(sorted_gid), np.asarray(ranges)
    return [sorted(g[r[t]:r[t + 1]].tolist()) for t in range(len(r) - 1)]


def assert_binned_equal(b, jb, exact_ranges=True):
    assert int(b.num_intersections) == int(jb.num_intersections)
    assert bool(b.overflow) == bool(jb.overflow)
    np.testing.assert_array_equal(b.gauss_counts.numpy(),
                                  np.asarray(jb.gauss_counts))
    if exact_ranges:
        np.testing.assert_array_equal(b.ranges.numpy(), np.asarray(jb.ranges))
        # Both sorts are unstable: compare each tile's segment as a
        # multiset of Gaussian ids (and of gid << kbits | k values).
        assert _per_tile_multisets(b.sorted_gid, b.ranges) == \
            _per_tile_multisets(jb.sorted_gid, jb.ranges)
        assert _per_tile_multisets(b.sorted_gidk, b.ranges) == \
            _per_tile_multisets(jb.sorted_gidk, jb.ranges)
        np.testing.assert_array_equal(b.sorted_tile.numpy(),
                                      np.asarray(jb.sorted_tile))


@pytest.mark.parametrize("kw", [
    dict(BASE, binning="tiered", tier_spec=(8, 5, 16)),
    dict(BASE, binning="tiered", tier_spec=((4, 0), (8, 2), (16, 6),
                                            (32, 25), (64, 50))),
    dict(BASE, binning="tiered", tier_spec=((64, 0),)),
    dict(BASE, binning="packed"),
    dict(BASE, binning="sort"),
    dict(BASE, binning="tiered", tile_culling=False),
])
def test_binning_matches_jax(kw):
    proj, cfg, jproj, jcfg = both(kw, scale_shift=0.5)
    b = tbin.bin_gaussians(proj, cfg)
    jb = jbin.bin_gaussians(jproj, jcfg)
    assert not bool(b.overflow) and int(b.num_intersections) > 0
    assert_binned_equal(b, jb)


def test_sort_binning_orders_by_exact_depth():
    proj, cfg, _, _ = both(dict(BASE, binning="sort"))
    b = tbin.bin_gaussians(proj, cfg)
    r = b.ranges.numpy()
    depth = proj.depth.numpy()
    for t in range(cfg.num_tiles):
        gids = b.sorted_gid.numpy()[r[t]:r[t + 1]]
        assert np.all(np.diff(depth[gids]) >= 0)


def test_tiered_pool_budget_overflows_like_jax():
    """An undersized pool budget must overflow in both packages with the
    same totals. Which of the tied overflowing rows are dropped depends on
    each package's unstable ranking sort, so ranges are not compared."""
    kw = dict(BASE, binning="tiered", tier_spec=(2, 400, 400))
    proj, cfg, jproj, jcfg = both(kw, scale_shift=0.8)
    b = tbin.bin_gaussians(proj, cfg)
    jb = jbin.bin_gaussians(jproj, jcfg)
    assert bool(b.overflow)
    assert_binned_equal(b, jb, exact_ranges=False)


def test_capacity_overflow_like_jax():
    """A stream too small for the candidates: the flag, the total and the
    per-Gaussian counts as the JAX package's. The slots kept differ: the
    first max_intersections candidates in emission order where the JAX
    package keeps the lowest keys (held in
    `test_tiered_capacity_overflow_keeps_the_first_candidates`)."""
    kw = dict(BASE, binning="tiered", max_intersections=64)
    proj, cfg, jproj, jcfg = both(kw)
    b = tbin.bin_gaussians(proj, cfg)
    jb = jbin.bin_gaussians(jproj, jcfg)
    assert bool(b.overflow) and int(b.num_intersections) > 64
    assert_binned_equal(b, jb, exact_ranges=False)


def test_gather_features_matches_jax():
    kw = dict(BASE, binning="tiered")
    proj, cfg, jproj, jcfg = both(kw)
    b = tbin.bin_gaussians(proj, cfg)
    feats = tbin.gather_features(proj, b, cfg)
    assert feats.shape == (tbin.NUM_FEATURES, cfg.max_intersections)
    np.testing.assert_allclose(
        tbin.features_f32(proj, cfg).numpy(),
        np.asarray(jbin.features_f32(jproj, jcfg)), rtol=1e-5, atol=1e-5,
    )
    # Slot s holds the features of Gaussian sorted_gid[s].
    total = int(b.num_intersections)
    want = tbin.features_f32(proj, cfg)[:, b.sorted_gid[:total].long()]
    torch.testing.assert_close(feats[:, :total], want, rtol=0, atol=0)
    # A -1 gid reads the zero column.
    b.sorted_gid[:3] = -1
    assert float(tbin.gather_features(proj, b, cfg)[:, :3].abs().max()) == 0.0


def test_depth_keys_match_jax_u32_keys():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.2, 50.0, size=500).astype(np.float32)
    tile = rng.integers(0, 2040, size=500).astype(np.int32)
    got = tbin.pack_tile_depth_key(torch.from_numpy(tile),
                                   torch.from_numpy(depth), 2040)
    want = np.asarray(jbin.pack_tile_depth_key(jnp.asarray(tile),
                                               jnp.asarray(depth), 2040))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert tbin.depth_bits_for(2040) == jbin.depth_bits_for(2040)
    with pytest.raises(ValueError):
        tbin.pack_tile_depth_key(torch.from_numpy(tile),
                                 torch.from_numpy(depth), 1 << 21)


@pytest.mark.parametrize("spec", [
    (8, 5, 16), (4, 2, 8), (64, 5, 16),
    ((4, 0), (8, 2), (16, 6), (32, 25), (64, 50)),
    ((8, 0), (32, 4)), ((128, 0),),
])
def test_tier_plan_matches_jax(spec):
    for kmax, n in ((64, 1000), (16, 10), (128, 1_000_000)):
        assert tbin._normalize_tier_plan(spec, kmax, n) == \
            jbin._normalize_tier_plan(spec, kmax, n)


def test_rect_divmod_matches_jax():
    k = np.arange(0, 2048, dtype=np.int32)[None, :]
    w = np.arange(1, 70, dtype=np.int32)[:, None]
    q, r = tbin._rect_divmod(torch.from_numpy(k), torch.from_numpy(w))
    jq, jr = jbin._rect_divmod(jnp.asarray(k), jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(q.numpy(), k // w)


def test_rect_divmod_is_integer_division_exhaustively():
    """floor((k + 0.5) / w) in float32 is k // w for every k < 4096 and
    w <= 4096, and so is K3's multiply by ceil(2^24 / w) (csrc/cull.cu:
    ((k << 8) * m) >> 32, exact since k w < 2^24), which the kernel takes
    for an integral w in that range instead of the division."""
    k = torch.arange(4096, dtype=torch.int32)[None, :]
    for w0 in range(1, 4097, 512):
        w = torch.arange(w0, w0 + 512, dtype=torch.int32)[:, None]
        q, r = tbin._rect_divmod(k, w)
        want = torch.div(k, w, rounding_mode="floor")
        assert torch.equal(q, want) and torch.equal(r, k - want * w)
        magic = ((1 << 24) + w.long() - 1) // w.long()
        assert torch.equal(((k.long() << 8) * magic) >> 32, want.long())


def test_scatter_binning_is_a_later_slice():
    """binning='scatter', which came in a later slice (one device): the
    same stream as JAX's scatter binning on the same projection, with and
    without a stream too small for it."""
    for max_i in (BASE["max_intersections"], 64):
        kw = dict(BASE, binning="scatter", max_intersections=max_i)
        proj, cfg, jproj, jcfg = both(kw)
        with torch.no_grad():
            b = tbin.bin_gaussians(proj, cfg)
        jb = jbin.bin_gaussians(jproj, jcfg)
        n = min(int(jb.num_intersections), max_i)
        assert int(b.num_intersections) == int(jb.num_intersections) > 0
        assert bool(b.overflow) == bool(jb.overflow) == (max_i == 64)
        np.testing.assert_array_equal(b.ranges.numpy(), np.asarray(jb.ranges))
        np.testing.assert_array_equal(b.sorted_tile.numpy(),
                                      np.asarray(jb.sorted_tile))
        np.testing.assert_array_equal(b.sorted_gid.numpy()[:n],
                                      np.asarray(jb.sorted_gid)[:n])


SHARD_KW = [
    dict(BASE, binning="tiered", tier_spec=((4, 0), (8, 2), (16, 6),
                                            (32, 25), (64, 50))),
    dict(BASE, binning="packed"),
    dict(BASE, binning="sort"),
    dict(BASE, binning="tiered", tile_culling=False),
    # The jumbo tiers of tests/test_torch_jumbo.py's config.
    dict(BASE, binning="tiered", max_tiles_per_gaussian=8,
         tier_spec=((4, 0), (8, 2)), max_tiles_jumbo=64,
         jumbo_tier_spec=((16, 16), (32, 8), (64, 8))),
]


@pytest.mark.parametrize("band,bands", [(0, 4), (2, 4), (1, 2)])
@pytest.mark.parametrize("kw", SHARD_KW)
def test_shard_local_binning_matches_jax(kw, band, bands):
    """bin_gaussians(tile_start, num_local_tiles), the sharded paths'
    binning, equals JAX's on every route: the local stream, its ranges and
    the per-Gaussian counts within the band (the gather backward's runs)."""
    proj, cfg, jproj, jcfg = both(kw, scale_shift=0.5)
    n_local = cfg.num_tiles // bands
    t0 = band * n_local
    b = tbin.bin_gaussians(proj, cfg, tile_start=t0, num_local_tiles=n_local)
    jb = jbin.bin_gaussians(jproj, jcfg, tile_start=t0,
                            num_local_tiles=n_local)
    assert b.ranges.shape[0] == n_local + 1 and int(b.num_intersections) > 0
    assert_binned_equal(b, jb)
    # The band's counts are at most the whole grid's, and differ somewhere.
    whole = tbin.bin_gaussians(proj, cfg).gauss_counts
    assert bool((b.gauss_counts <= whole).all())
    assert not torch.equal(b.gauss_counts, whole)


def test_shard_local_scatter_binning_matches_jax():
    kw = dict(BASE, binning="scatter")
    proj, cfg, jproj, jcfg = both(kw)
    n_local = cfg.num_tiles // 2
    with torch.no_grad():
        b = tbin.bin_gaussians(proj, cfg, tile_start=n_local,
                               num_local_tiles=n_local)
    jb = jbin.bin_gaussians(jproj, jcfg, tile_start=n_local,
                            num_local_tiles=n_local)
    n = int(jb.num_intersections)
    assert int(b.num_intersections) == n > 0
    np.testing.assert_array_equal(b.ranges.numpy(), np.asarray(jb.ranges))
    np.testing.assert_array_equal(b.sorted_tile.numpy(),
                                  np.asarray(jb.sorted_tile))
    np.testing.assert_array_equal(b.sorted_gid.numpy()[:n],
                                  np.asarray(jb.sorted_gid)[:n])


@pytest.mark.parametrize("kw", [dict(BASE, binning="tiered", stream_align=4),
                                dict(BASE, binning="scatter", stream_align=8)])
def test_stream_align_matches_jax(kw):
    """stream_align > 1 (`_align_stream`): every segment padded to a
    multiple of the alignment with gid -1 slots, as in JAX."""
    proj, cfg, jproj, jcfg = both(kw, scale_shift=0.5)
    with torch.no_grad():
        b = tbin.bin_gaussians(proj, cfg)
    jb = jbin.bin_gaussians(jproj, jcfg)
    r = b.ranges.numpy()
    np.testing.assert_array_equal(r, np.asarray(jb.ranges))
    assert np.all(np.diff(r) % cfg.stream_align == 0) and int(b.ranges[-1]) > 0
    np.testing.assert_array_equal(b.sorted_tile.numpy(),
                                  np.asarray(jb.sorted_tile))
    assert _per_tile_multisets(b.sorted_gid, b.ranges) == \
        _per_tile_multisets(jb.sorted_gid, jb.ranges)
    assert bool(b.overflow) == bool(jb.overflow) is False


@pytest.mark.parametrize("max_i", [4096, 200])
def test_align_stream_matches_jax(max_i):
    """_align_stream alone on a hand-made sorted stream with empty tiles,
    with room to spare and cut short (total_padded > max_i), with the
    candidate stream carried along: every output equal to JAX's."""
    rng = np.random.default_rng(0)
    n_tiles, align = 40, 8
    counts = rng.integers(0, 12, n_tiles) * (rng.random(n_tiles) < 0.7)
    tiles = np.repeat(np.arange(n_tiles), counts).astype(np.int32)
    total = tiles.shape[0]
    s_tile = np.full((max_i,), n_tiles, np.int32)
    s_tile[:min(total, max_i)] = tiles[:max_i]
    s_gid = rng.integers(0, 500, max_i).astype(np.int32)
    s_cand = rng.integers(0, 1 << 20, max_i).astype(np.int32)
    ranges = np.searchsorted(s_tile, np.arange(n_tiles + 1)).astype(np.int32)
    got = tbin._align_stream(*(torch.from_numpy(a) for a in (
        s_tile, s_gid, ranges)), max_i, n_tiles, align,
        torch.from_numpy(s_cand))
    want = jbin._align_stream(jnp.asarray(s_tile), jnp.asarray(s_gid),
                              jnp.asarray(ranges), max_i, n_tiles, align,
                              jnp.asarray(s_cand))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert (int(got[3]) > max_i) == (max_i == 200)


def dense_packed(proj, cfg, tile_start=None, n_local=None):
    """The packed route as the lane grid: every Gaussian's K_max rect-walk
    candidates (N, K_max), int64 keys with SENTINEL_KEY where the cull or
    the band drops a lane, one stable sort of all N * K_max keys, its first
    max_intersections kept."""
    max_i = cfg.max_intersections
    n_tiles = cfg.num_tiles if n_local is None else n_local
    kb = tbin._kbits(tbin.kmax_eff(cfg))
    tile, gidk, valid = tbin._candidate_tiles(proj, cfg, n_tiles, tile_start)
    counts = valid.sum(dim=1, dtype=torch.int32)
    total = counts.sum(dtype=torch.int32)
    key = tbin.pack_tile_depth_key(
        tile, proj.depth[:, None].expand(tile.shape), cfg.num_tiles)
    key = torch.where(valid, key, tbin.SENTINEL_KEY).reshape(-1)
    order = torch.sort(key, stable=True).indices[:max_i]
    s_tile = torch.clamp_max(key[order] >> tbin.depth_bits_for(cfg.num_tiles),
                             n_tiles).to(torch.int32)
    s_gidk = gidk.reshape(-1)[order]
    s_gidk = torch.where(s_tile < n_tiles, s_gidk, -1)
    return tbin.BinnedGaussians(
        sorted_tile=s_tile,
        sorted_gid=torch.where(s_gidk >= 0, s_gidk >> kb, 0),
        ranges=tbin._tile_ranges(s_tile, n_tiles),
        num_intersections=total,
        overflow=proj.overflow | (total > max_i),
        sorted_gidk=s_gidk,
        gauss_counts=counts,
        gauss_offsets=(torch.cumsum(counts, 0) - counts).to(torch.int32),
        keys_sorted=key.numel(),
    ), valid


BINNED_FIELDS = ("sorted_tile", "sorted_gid", "ranges", "num_intersections",
                 "overflow", "sorted_gidk", "gauss_counts", "gauss_offsets")


@pytest.mark.parametrize("band,bands", [(None, 1), (0, 4), (2, 4), (1, 2)])
@pytest.mark.parametrize("tile_culling", [True, False])
def test_packed_binning_equals_the_dense_lane_grid(tile_culling, band, bands):
    """The packed route (K3's count stage, the exclusive scan, its emit
    stage, a stable sort of max_intersections slots) equals the stable sort
    of the whole (N, K_max) lane grid bit for bit in every field, on the
    full frame and on the bands of the sharded paths, with the cull and
    without: kept lanes in candidate order tie as the grid's lanes do.
    Depths rounded to quarters make many keys tie."""
    kw = dict(BASE, binning="packed", tile_culling=tile_culling)
    proj, cfg, _, _ = both(kw, scale_shift=0.5)
    proj = dataclasses.replace(proj, depth=torch.round(proj.depth * 4) / 4)
    if band is None:
        args = {}
    else:
        n_local = cfg.num_tiles // bands
        args = dict(tile_start=band * n_local, num_local_tiles=n_local)
    got = tbin.bin_gaussians(proj, cfg, **args)
    want, _ = dense_packed(proj, cfg, args.get("tile_start"),
                           args.get("num_local_tiles"))
    assert not bool(got.overflow) and int(got.num_intersections) > 0
    for f in BINNED_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and torch.equal(g, w), f
    assert got.keys_sorted == cfg.max_intersections < want.keys_sorted
    # Tied keys occur, so the tie order is tested, not vacuous.
    key = tbin.pack_tile_depth_key(got.sorted_tile, proj.depth[
        got.sorted_gid.long()], cfg.num_tiles)[:int(got.num_intersections)]
    assert int((key[1:] == key[:-1]).sum()) > 10


def test_packed_capacity_overflow_keeps_the_first_candidates():
    """A stream too small for the candidates: overflow and the total as the
    lane grid's and the JAX package's; the slots kept are the first
    max_intersections candidates in Gaussian order (the grid keeps the
    lowest keys), distinct, valid, and in (tile, depth) order."""
    kw = dict(BASE, binning="packed", max_intersections=64)
    proj, cfg, jproj, jcfg = both(kw, scale_shift=0.5)
    got = tbin.bin_gaussians(proj, cfg)
    want, valid = dense_packed(proj, cfg)
    jb = jbin.bin_gaussians(jproj, jcfg)
    assert bool(got.overflow) and bool(want.overflow) and bool(jb.overflow)
    assert int(got.num_intersections) == int(want.num_intersections) == \
        int(jb.num_intersections) > 64
    for f in ("gauss_counts", "gauss_offsets"):
        assert torch.equal(getattr(got, f), getattr(want, f))
    kb = tbin._kbits(tbin.kmax_eff(cfg))
    n, kmax = valid.shape
    lanes = (torch.arange(n)[:, None] << kb) | torch.arange(kmax)
    first = lanes[valid][:64]            # row-major: candidate order
    assert torch.equal(torch.sort(got.sorted_gidk).values,
                       torch.sort(first.to(torch.int32)).values)
    assert bool((got.sorted_tile < cfg.num_tiles).all())
    key = tbin.pack_tile_depth_key(got.sorted_tile,
                                   proj.depth[got.sorted_gid.long()],
                                   cfg.num_tiles)
    assert bool((key[1:] >= key[:-1]).all())
    assert int(got.ranges[-1]) == 64
    assert not torch.equal(got.sorted_gidk, want.sorted_gidk)


TIER_LADDERS = {"legacy": (8, 5, 16),
                "bench": ((4, 0), (8, 2), (16, 6), (32, 25), (64, 50))}
# Jumbo tiers past a base K_max of 16 on the 8 x 8 tile grid.
TIER_JUMBO = dict(max_tiles_per_gaussian=16, max_tiles_jumbo=64,
                  jumbo_tier_spec=((32, 24), (48, 12), (64, 8)))


def tier_case(ladder, jumbo, tile_culling, **kw):
    """The port's projection of a random scene of 400 Gaussians, 30 of them
    large and opaque (every base tier, every pool and, with the jumbo tiers,
    two of them hold candidates), its depths rounded to quarters so that
    many keys tie; and its tiered config."""
    cfg = RenderConfig(**dict(BASE, binning="tiered",
                              tier_spec=TIER_LADDERS[ladder],
                              tile_culling=tile_culling,
                              **(TIER_JUMBO if jumbo else {}), **kw))
    scene = random_scene(400, 1, generator=torch.Generator().manual_seed(7),
                         device="cpu")
    log_scales = scene.log_scales + 1.0
    log_scales[:30] = -0.5
    opacity = scene.opacity_logits.clone()
    opacity[:30] = 1.0
    scene = GaussianScene(scene.means, log_scales, scene.quats, opacity,
                          scene.sh)
    proj = project_gaussians(scene, Camera.default(64, 64, device="cpu"), cfg)
    proj = dataclasses.replace(proj, depth=torch.round(proj.depth * 4) / 4)
    return proj, cfg


@pytest.mark.parametrize("band,bands", [(None, 1), (0, 4), (2, 4), (1, 2)])
@pytest.mark.parametrize("tile_culling", [True, False])
@pytest.mark.parametrize("jumbo", [False, True])
@pytest.mark.parametrize("ladder", ["legacy", "bench"])
def test_tiered_binning_equals_the_lane_grids(ladder, jumbo, tile_culling,
                                              band, bands):
    """The tiered route (K3's tier count, the exclusive scan, its tier
    emit, a stable sort of max_intersections slots) equals the stable sort
    of every tier's lane grid, concatenated (`tiered_oracle.dense_tiered`,
    the route before it compacted), bit for bit in every field, on the full
    frame and on the sharded paths' bands, with the cull and without, with
    the jumbo tiers and without. Before the sort, the slots hold the grids'
    valid lanes in their concatenation order: the plain tier stages."""
    proj, cfg = tier_case(ladder, jumbo, tile_culling)
    n_tiles, t0 = cfg.num_tiles, None
    args = {}
    if band is not None:
        n_tiles = cfg.num_tiles // bands
        t0 = band * n_tiles
        args = dict(tile_start=t0, num_local_tiles=n_tiles)
    got = tbin.bin_gaussians(proj, cfg, **args)
    want, key, gidk = tiered_oracle.dense_tiered(proj, cfg, t0, n_tiles)
    assert not bool(got.overflow) and int(got.num_intersections) > 0
    for f in BINNED_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and torch.equal(g, w), f
    assert got.keys_sorted == cfg.max_intersections
    total = int(got.num_intersections)
    skey = tbin.pack_tile_depth_key(got.sorted_tile, proj.depth[
        got.sorted_gid.long()], cfg.num_tiles)[:total]
    assert int((skey[1:] == skey[:-1]).sum()) > 10  # ties are tested
    valid = key != tbin.SENTINEL_KEY
    ckey, cgidk, ctotal, _, _ = tbin._tiered_candidates(proj, cfg, n_tiles, t0)
    assert int(ctotal) == total == int(valid.sum())
    assert torch.equal(ckey[:total], key[valid])
    assert torch.equal(cgidk[:total], gidk[valid])
    assert bool((ckey[total:] == tbin.SENTINEL_KEY).all())
    assert bool((cgidk[total:] == -1).all())
    if band is None:  # every kind of tier emits
        rows, _, _ = tbin._tier_rows(proj, cfg, n_tiles)
        per_row = cull.cull_tier_count(rows).split([t[3] for t in rows.tiers])
        kept = {}
        for (kind, *_), c in zip(rows.tiers, per_row):
            kept[kind] = kept.get(kind, 0) + int(c.sum())
        assert all(kept.values()) and len(kept) == 2 + jumbo


def test_tiered_capacity_overflow_keeps_the_first_candidates():
    """A stream too small for the candidates: overflow and the total as the
    lane grids' and the JAX package's; the slots kept are the first
    max_intersections candidates in emission order (the grids keep the
    lowest keys), distinct, valid, and in (tile, depth) order."""
    kw = dict(BASE, binning="tiered", tier_spec=TIER_LADDERS["bench"],
              max_intersections=64)
    proj, cfg, jproj, jcfg = both(kw, scale_shift=0.5)
    got = tbin.bin_gaussians(proj, cfg)
    want, key, gidk = tiered_oracle.dense_tiered(proj, cfg)
    jb = jbin.bin_gaussians(jproj, jcfg)
    assert bool(got.overflow) and bool(want.overflow) and bool(jb.overflow)
    assert int(got.num_intersections) == int(want.num_intersections) == \
        int(jb.num_intersections) > 64
    for f in ("gauss_counts", "gauss_offsets"):
        assert torch.equal(getattr(got, f), getattr(want, f))
    valid = key != tbin.SENTINEL_KEY
    first = gidk[valid][:64]             # concatenation order
    assert torch.equal(torch.sort(got.sorted_gidk).values,
                       torch.sort(first).values)
    assert torch.unique(got.sorted_gidk).numel() == 64
    assert bool((got.sorted_tile < cfg.num_tiles).all())
    skey = tbin.pack_tile_depth_key(got.sorted_tile,
                                    proj.depth[got.sorted_gid.long()],
                                    cfg.num_tiles)
    assert bool((skey[1:] >= skey[:-1]).all())
    assert int(got.ranges[-1]) == 64
    assert not torch.equal(got.sorted_gidk, want.sorted_gidk)
    ckey, cgidk, _, _, _ = tbin._tiered_candidates(proj, cfg, cfg.num_tiles)
    assert torch.equal(ckey, key[valid][:64])
    assert torch.equal(cgidk, first)


@pytest.mark.parametrize("fault", [None, "count", "emit", "short"])
def test_chip_smoke_tier_stage_check(monkeypatch, fault):
    """chip_smoke's check of the tier count and tier emit
    (`check_tier_stages`), with the plain stages counted as the kernels are
    standing in for the kernels, passes them on the bench ladder with the
    jumbo tiers, and exits on a row's count one off, on one emitted gidk
    changed, and on a stream cut short that loses its last slot."""
    import chip_smoke as cs

    from gsplat_tpu_torch.ops.cuda import counters

    proj, cfg = tier_case("bench", True, True)

    def count(rows):
        counters.bump("K3.tier_count")
        out = cull.cull_tier_count_plain(rows)
        if fault == "count":
            out[int(out.argmax())] -= 1
        return out

    def emit(rows, offsets, slots, sentinel):
        counters.bump("K3.tier_emit")
        keys, gidk = cull.cull_tier_emit_plain(rows, offsets, slots, sentinel)
        written = int((gidk >= 0).sum())
        if fault == "emit":
            gidk[written // 2] ^= 1
        if fault == "short" and written == slots:
            keys[-1], gidk[-1] = sentinel, -1
        return keys, gidk

    def launch(rows, row_counts, offsets, slots, keys, gidk):
        k, g = emit(rows, offsets, slots, tbin.SENTINEL_KEY)
        keys.copy_(k)
        gidk.copy_(g)

    monkeypatch.setattr(cull, "cull_tier_count_cuda", count)
    monkeypatch.setattr(cull, "cull_tier_emit_cuda", emit)
    monkeypatch.setattr(cull, "_tier_launch", launch)
    monkeypatch.setattr(cs, "timed_once", lambda fn: (fn(), 0.0))
    monkeypatch.setattr(cs, "cuda_ms",
                        lambda fn, iters: [fn() for _ in range(iters + 1)]
                        and 0.0)
    if fault is None:
        out = cs.check_tier_stages(proj, cfg, "cpu", short=8)
        assert out["frame"]["jumbo_kept"] > 0
        assert out["band"]["kept"] > 8
        for v in ("frame", "band"):
            assert out[v]["emit"]["short"]["written"] == out[v]["kept"] - 8
    else:
        with pytest.raises(SystemExit, match="differs"):
            cs.check_tier_stages(proj, cfg, "cpu", short=8)


def random_cull_rows(n, kmax, seed):
    """(10, n) K3 parameter rows of random splats on a 12 x 10 tile grid of
    8-pixel tiles: rects inside the grid, walk bounds up to kmax."""
    rng = np.random.default_rng(seed)
    p = np.zeros((cull.NUM_ROWS, n), np.float32)
    w = rng.integers(1, 12, n)
    h = rng.integers(1, 10, n)
    x0 = rng.integers(0, 12 - w + 1)
    y0 = rng.integers(0, 10 - h + 1)
    p[cull.R_GX] = (x0 + w * rng.uniform(0, 1, n)) * 8
    p[cull.R_GY] = (y0 + h * rng.uniform(0, 1, n)) * 8
    p[cull.R_A], p[cull.R_C] = rng.uniform(1e-3, 5e-2, (2, n))
    p[cull.R_B] = rng.uniform(-5e-3, 5e-3, n)
    p[cull.R_TAU] = rng.uniform(-1.0, 8.0, n)
    p[cull.R_X0], p[cull.R_Y0], p[cull.R_W] = x0, y0, w
    p[cull.R_COUNT] = np.minimum(w * h, kmax)
    return torch.from_numpy(p)


@pytest.mark.parametrize("cull_on", [True, False])
@pytest.mark.parametrize("kmax", [16, 64, 100])
def test_count_and_emit_stages_plain(kmax, cull_on):
    """The plain count and emit stages (what K3's count and emit stages are
    held to on the card) against the mask, a cumsum and a loop over the
    rows: ballots, counts, and every slot's key and gidk, with a band and a
    stream that cuts the last rows."""
    tiles_x, ts, depth_bits, kb = 12, 8, 24, 7
    params = random_cull_rows(300, kmax, seed=kmax)
    tile_lo, tile_hi = 24, 96
    ballots, counts = cull.cull_count_plain(params, kmax, ts, cull_on,
                                            tiles_x, tile_lo, tile_hi)
    k = np.arange(kmax)
    w = params[cull.R_W].numpy().astype(np.int64)
    x0 = params[cull.R_X0].numpy().astype(np.int64)
    y0 = params[cull.R_Y0].numpy().astype(np.int64)
    tile = (y0[:, None] + k // w[:, None]) * tiles_x + x0[:, None] \
        + k % w[:, None]
    if cull_on:
        mask = cull.cull_mask_plain(params, kmax, ts).numpy()
    else:
        mask = k[None, :] < params[cull.R_COUNT].numpy()[:, None]
    mask = mask & (tile >= tile_lo) & (tile < tile_hi)
    assert 0 < mask.sum() < mask[:, 0].size * kmax
    np.testing.assert_array_equal(cull.mask_from_ballots(ballots, kmax)
                                  .numpy(), mask)
    np.testing.assert_array_equal(counts.numpy(), mask.sum(1))
    assert ballots.shape == (300, (kmax + 31) // 32)
    assert torch.equal(cull.ballots_from_mask(torch.from_numpy(mask)),
                       ballots)
    offsets = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    depth_q = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1 << depth_bits, 300))
    max_slots = int(counts.sum()) - 7
    keys, gidk = cull.cull_emit_plain(params, ballots, offsets, depth_q,
                                      kmax, tiles_x, tile_lo, depth_bits,
                                      kb, max_slots, tbin.SENTINEL_KEY)
    want_keys = np.full(max_slots, tbin.SENTINEL_KEY, np.int64)
    want_gidk = np.full(max_slots, -1, np.int32)
    slot = 0
    for g in range(300):
        for kk in np.nonzero(mask[g])[0]:
            if slot < max_slots:
                want_keys[slot] = ((tile[g, kk] - tile_lo) << depth_bits) \
                    | int(depth_q[g])
                want_gidk[slot] = (g << kb) | kk
            slot += 1
    np.testing.assert_array_equal(keys.numpy(), want_keys)
    np.testing.assert_array_equal(gidk.numpy(), want_gidk)
    # The kernels' wrappers refuse a CPU tensor; the dispatcher takes the
    # plain versions for it.
    with pytest.raises(ValueError, match="CUDA"):
        cull.cull_count_cuda(params, kmax, ts, cull_on, tiles_x, 0, 120)
    with pytest.raises(ValueError, match="CUDA"):
        cull.cull_emit_cuda(params, ballots, offsets, depth_q, kmax, tiles_x,
                            0, depth_bits, kb, 8, tbin.SENTINEL_KEY)
    got = cull.cull_count_from_params(params, kmax, ts, cull_on, tiles_x,
                                      tile_lo, tile_hi)
    assert all(torch.equal(a, b) for a, b in zip(got, (ballots, counts)))


def test_ballot_words_hold_every_bit():
    """Bit 31 of a word (a negative int32) and a last partial word survive
    the plain round trip."""
    mask = torch.from_numpy(np.random.default_rng(3).random((40, 70)) < 0.5)
    mask[:, 31] = True
    words = cull.ballots_from_mask(mask)
    assert words.dtype == torch.int32 and bool((words[:, 0] < 0).all())
    assert torch.equal(cull.mask_from_ballots(words, 70), mask)
