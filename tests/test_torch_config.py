"""Port config vs the JAX RenderConfig: same fields and defaults (minus the
TPU-only ones), same validation, and the CUDA blend kernel's own limit."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu_torch import RenderConfig  # noqa: E402
from gsplat_tpu_torch.config import MAX_PIXELS_PER_TILE, MAX_TIERS, cdiv  # noqa: E402

# Fields that select TPU machinery with no counterpart in the port.
DROPPED = {"impl", "pallas_interpret"}


def test_fields_and_defaults_match_jax():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    for name in DROPPED:
        jax_fields.pop(name)
    assert port_fields == jax_fields
    # Field order is kept too, so positional reading of either is the same.
    assert [f.name for f in dataclasses.fields(RenderConfig)] == [
        f.name for f in dataclasses.fields(JaxConfig) if f.name not in DROPPED
    ]


@pytest.mark.parametrize("kw", [
    {},
    dict(width=1920, height=1080, tile_size=32),
    dict(width=48, height=40, tile_size=8),
    dict(width=1, height=1, tile_size=1, block_size=1, max_per_tile=1),
])
def test_derived_properties_match_jax(kw):
    a, b = RenderConfig(**kw), JaxConfig(**kw)
    for prop in ("tiles_x", "tiles_y", "num_tiles", "pixels_per_tile",
                 "padded_width", "padded_height"):
        assert getattr(a, prop) == getattr(b, prop), prop


@pytest.mark.parametrize("kw", [
    dict(max_per_tile=100, block_size=16),
    dict(tile_size=0),
    dict(binning="radix"),
    dict(gather_backward="atomic"),
    dict(grad_readout="f16"),
    dict(segment_sum="scan"),
    dict(gather_backward="bf16"),
    dict(matmul_precision="tf32"),
    dict(stream_format="bf16"),
    dict(slot_gather="i64"),
    dict(fragment_format="f16"),
    dict(stream_format="packed16", binning="scatter"),
    dict(max_tiles_jumbo=256),
    dict(max_tiles_jumbo=32, binning="tiered"),
    dict(max_tiles_jumbo=4096, binning="tiered"),
    dict(max_tiles_jumbo=256, binning="tiered"),
    dict(max_tiles_jumbo=256, binning="tiered", jumbo_tier_spec=((512, 8),)),
    dict(quant_ranges=(0.0, 1.0)),
    dict(stream_format="packed4", slot_gather="c64"),
    dict(stream_format="packed16", width=9000),
])
def test_invalid_configs_raise_in_both(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        RenderConfig(**kw)


def test_valid_jumbo_config_accepted():
    kw = dict(binning="tiered", max_tiles_jumbo=1024,
              jumbo_tier_spec=((256, 8192), (512, 2048), (1024, 512)))
    JaxConfig(**kw)
    RenderConfig(**kw)


def test_blend_kernel_thread_limit_replaces_vmem_guard():
    # tile 32 with the TPU-illegal Pallas block of 256 is fine here: the
    # CUDA blend kernels' limit is a 32x32 tile.
    RenderConfig(width=64, height=64, tile_size=32, pallas_block_size=256,
                 block_size=8, max_per_tile=256)
    assert MAX_PIXELS_PER_TILE == 1024
    with pytest.raises(ValueError, match="1024"):
        RenderConfig(width=128, height=128, tile_size=64, block_size=8,
                     max_per_tile=256)


def test_tier_kernel_limit_on_the_ladder():
    """The tiered binning's CUDA tier count and emit take at most MAX_TIERS
    tiers, base and jumbo together (the implicit last base tier counted):
    RenderConfig refuses more, and counts jumbo tiers only with
    max_tiles_jumbo."""
    assert MAX_TIERS == 32
    ladder = tuple((k, 0) for k in range(2, 66, 2))  # 32 tiers to K 64
    RenderConfig(binning="tiered", max_tiles_per_gaussian=64,
                 tier_spec=ladder, jumbo_tier_spec=((128, 8),))
    with pytest.raises(ValueError, match="33 tiers"):
        RenderConfig(binning="tiered", max_tiles_per_gaussian=64,
                     tier_spec=ladder, max_tiles_jumbo=128,
                     jumbo_tier_spec=((128, 8),))
    with pytest.raises(ValueError, match="33 tiers"):  # the implicit one
        RenderConfig(binning="tiered", max_tiles_per_gaussian=66,
                     tier_spec=ladder)
    RenderConfig(binning="packed", max_tiles_per_gaussian=66,
                 tier_spec=ladder)


@pytest.mark.parametrize("field", sorted(DROPPED))
def test_tpu_only_fields_are_gone(field):
    with pytest.raises(TypeError):
        RenderConfig(**{field: "pallas" if field == "impl" else True})


def test_cdiv():
    assert [cdiv(a, 8) for a in (0, 1, 8, 9, 1080)] == [0, 1, 1, 2, 135]
