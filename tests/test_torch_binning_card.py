"""On a CUDA card: the tiered binning's tier count and tier emit (K3's
`cull_kernel_tier`, `csrc/cull.cu`) against what they replaced. On the
garden cell's 1M scene (the bench ladder and the jumbo tiers) at 8 poses of
`splatbench/traffic/train.json`'s disk, and on the 2dgs cell's surfel
proxy, `bin_gaussians` equals `tiered_oracle.dense_tiered` (every tier's
lane grid and one stable sort, run on the card) in every field; a bin
launches the tier count and the tier emit once each and sorts
max_intersections keys; the two stages equal their plain versions run on
the card on the same rows, on the whole grid and on a band, and with a
stream that cuts the candidates short. Imports no JAX; skips without a
card. On a machine without JAX, run it without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_binning_card.py -q -s
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT, ROOT / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import tiered_oracle  # noqa: E402
from gsplat_tpu_torch.models.gaussians import SurfelScene  # noqa: E402
from gsplat_tpu_torch.ops import binning as tbin  # noqa: E402
from gsplat_tpu_torch.ops.cuda import counters, cull  # noqa: E402
from gsplat_tpu_torch.ops.projection import project_gaussians  # noqa: E402
from gsplat_tpu_torch.ops.surfels import project_surfels  # noqa: E402
from splatbench import gen, port  # noqa: E402

SEED = 3124000001
# 8 of the 160 poses of the disk, spread over it.
POSES = tuple(range(0, 160, 20))
FIELDS = ("sorted_tile", "sorted_gid", "ranges", "num_intersections",
          "overflow", "sorted_gidk", "gauss_counts", "gauss_offsets")


def _json(*parts):
    return json.loads(ROOT.joinpath("splatbench", *parts).read_text())


@pytest.fixture(scope="module")
def card():
    """cuda:0, or a skip where there is no card (decided here, not while the
    module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _cell(card, name):
    """(fields of the cell's scene, cfg, the disk's cameras by pose)."""
    config = _json("configs", f"{name}.json")
    rc = config["render"]
    views = gen.view_matrices(_json("traffic", "train.json")["poses"])
    cams = {i: port.camera(views[i], rc["width"], rc["height"], card)
            for i in POSES}
    return gen.make_scene(config, SEED, card), port.render_config(rc), cams


@pytest.fixture(scope="module")
def garden(card):
    fields, cfg, cams = _cell(card, "garden-1m-1080p")
    return port.scene(fields), cfg, cams


def _bin_against_the_grids(proj, cfg, what):
    """bin_gaussians against dense_tiered, every field; one tier count and
    one tier emit; the sort's length."""
    before = counters.snapshot()
    got = tbin.bin_gaussians(proj, cfg)
    rose = counters.rise(before, counters.snapshot())
    want, key, _ = tiered_oracle.dense_tiered(proj, cfg)
    total = int(got.num_intersections)
    print(f"{what}: {total} candidates, {got.keys_sorted} keys sorted "
          f"({100 * total / got.keys_sorted:.2f}%), the lane grids "
          f"{key.numel()} ({100 * total / key.numel():.2f}%); K3 {rose}")
    assert not bool(got.overflow) and total > 0
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and torch.equal(g, w), f"{what}: {f}"
    assert got.keys_sorted == cfg.max_intersections < key.numel()
    assert rose.get("K3.tier_count") == rose.get("K3.tier_emit") == 1
    assert not rose.get("K3.count") and not rose.get("K3.emit")


@pytest.mark.card
@pytest.mark.parametrize("pose", POSES)
def test_garden_poses_equal_the_lane_grids(garden, pose):
    scene, cfg, cams = garden
    with torch.no_grad():
        proj = project_gaussians(scene, cams[pose], cfg)
        _bin_against_the_grids(proj, cfg, f"garden pose {pose}")


@pytest.mark.card
def test_surfel_proxy_equals_the_lane_grids(card):
    fields, cfg, cams = _cell(card, "2dgs-garden-1m-1080p")
    fields["log_scales"] = fields["log_scales"][:, :2].contiguous()
    scene = SurfelScene(**fields)
    with torch.no_grad():
        proj = project_surfels(scene, cams[POSES[0]], cfg)
        _bin_against_the_grids(proj, cfg, "2dgs surfel proxy")


def _ms(fn, reps=20):
    """fn's mean time on the card, ms, by CUDA events after one warm call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.card
@pytest.mark.parametrize("band", [None, (1, 4), (2, 3)])
def test_stages_equal_their_plain_versions(garden, band):
    """The tier count and emit against their plain versions run on the card
    on the same rows: the whole grid, a band (its count walks each row), and
    a stream 1000 slots short of the candidates. Prints each stage's time
    (the emit's with and without its wrapper's two fills) beside its bytes'
    bound at 3.35 TB/s: 12 B a kept slot and 4 B a row's count read."""
    scene, cfg, cams = garden
    n_local, t0 = cfg.num_tiles, None
    if band is not None:
        n_local = cfg.num_tiles // band[1]
        t0 = band[0] * n_local
    with torch.no_grad():
        proj = project_gaussians(scene, cams[POSES[3]], cfg)
        rows, _, _ = tbin._tier_rows(proj, cfg, n_local, t0)
        counts = cull.cull_tier_count_cuda(rows)
        assert torch.equal(counts, cull.cull_tier_count_plain(rows))
        offsets = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        total = int(counts.sum())
        for slots in (cfg.max_intersections, total - 1000):
            got = cull.cull_tier_emit_cuda(rows, offsets, slots,
                                           tbin.SENTINEL_KEY)
            want = cull.cull_tier_emit_plain(rows, offsets, slots,
                                             tbin.SENTINEL_KEY)
            kept = int((got[1] >= 0).sum())
            print(f"band {band}: {len(counts)} rows, {total} candidates, "
                  f"{kept} of {slots} slots written")
            assert kept == min(total, slots) > 0
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        keys, gidk = cull.cull_tier_emit_cuda(
            rows, offsets, cfg.max_intersections, tbin.SENTINEL_KEY)
        count_ms = _ms(lambda: cull.cull_tier_count_cuda(rows))
        emit_ms = _ms(lambda: cull.cull_tier_emit_cuda(
            rows, offsets, cfg.max_intersections, tbin.SENTINEL_KEY))
        kernel_ms = _ms(lambda: cull._tier_launch(
            rows, None, offsets, cfg.max_intersections, keys, gidk))
        bound_ms = (12 * total + 4 * len(counts)) / 3.35e9
        print(f"band {band}: tier count {count_ms:.4f} ms, tier emit "
              f"{kernel_ms:.4f} ms ({emit_ms:.4f} with the fills), bound "
              f"{bound_ms:.4f} ms")
