"""Static render configuration of the PyTorch port.

Field for field the `gsplat_tpu.config.RenderConfig` of the JAX package, with
the same defaults, so a config means the same render in both packages. Two
fields are dropped because they select TPU machinery that has no counterpart
here: `impl` (jnp or Pallas rasterizer) and `pallas_interpret`. The port has
one path: its kernel wrappers launch the CUDA kernel for a CUDA tensor and
run the plain PyTorch version for a CPU tensor.

The TPU VMEM guard of the JAX config (pixels_per_tile * pallas_block_size)
is replaced by the CUDA blend kernels' own limit: a tile of at most 32x32
pixels, which they walk with 2 pixels of a column per thread, in at most 16
warps (each a 32x2 strip at tile 32; csrc/blend.cuh).
"""

from __future__ import annotations

import dataclasses

# The blend kernels' largest tile, 32x32: 16 warps, each a 32x2 strip
# (csrc/blend.cuh); their C entry points refuse a larger tile.
MAX_PIXELS_PER_TILE = 1024


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def parse_tier_spec(text: str) -> tuple:
    """A --tier-spec flag: '4:0,8:2,16:6' -> ((4, 0), (8, 2), (16, 6)); the
    legacy '8,5,16' -> (8, 5, 16) (the forms of the root bench's flag)."""
    return tuple(tuple(int(y) for y in x.split(":")) if ":" in x else int(x)
                 for x in text.split(","))


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Image / tiling.
    width: int = 800
    height: int = 800
    tile_size: int = 16

    # Static capacity of the (tile, depth)-keyed intersection stream; an
    # overflow flag reports a frame that needed more.
    max_intersections: int = 1 << 18
    # Static bound on tiles touched per Gaussian (rect area cap).
    max_tiles_per_gaussian: int = 64
    # Gaussians blended per block by the plain tiled rasterizer.
    block_size: int = 16
    # Per-tile cap of the JAX jnp rasterizer (multiple of block_size). The
    # port's plain walk, like the CUDA kernel, has no per-tile cap: it walks
    # to the longest segment actually present.
    max_per_tile: int = 2048

    # Splatting constants.
    scale_modifier: float = 1.0
    sh_degree: int = 3
    frustum_ndc_limit: float = 1.1
    lowpass: float = 0.3
    radius_sigma: float = 3.0
    eigen_clamp: float = 0.1
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    transmittance_min: float = 1e-4

    # 'sort' | 'packed' | 'tiered' | 'scatter' (see gsplat_tpu.config).
    binning: str = "sort"
    # Upper bound on the projected 3-sigma screen radius in pixels (0 = off).
    max_screen_radius: float = 0.0
    # Exact ellipse-tile culling of rect candidates (CUDA kernel K3).
    tile_culling: bool = True
    # 'tiered' binning shape: legacy (K0, div1, div2) or ((k_hi, div), ...).
    tier_spec: tuple = (8, 5, 16)
    # Jumbo tiers for heavy-tailed scenes: splats whose rect exceeds
    # max_tiles_per_gaussian are enumerated in full, up to max_tiles_jumbo
    # tiles, on budgeted rows (ops/binning.py::_jumbo_candidates).
    max_tiles_jumbo: int = 0
    jumbo_tier_spec: tuple = ()
    # Gaussian block of the TPU blend kernel. Kept for config parity; the
    # CUDA blend kernel stages Gaussians in batches of one per pixel thread.
    pallas_block_size: int = 256
    # Optional per-tile segment alignment of the sorted stream (0/1 = off).
    stream_align: int = 0
    # Gather backward: 'variadic', 'permute' and 'c64' are one float32 path
    # in the port (ops/binning.py::_GatherSlots); 'bf16' rounds the slot
    # gradients to bf16 pairs and sums them with kernel K5 (with a packed
    # stream, kernel K2 writes the pairs itself).
    gather_backward: str = "variadic"
    grad_readout: str = "f32"
    # 'doubling' and 'pallas' are one path in the port: kernel K4 on the
    # card, its plain version on the CPU (see `ops.binning.gather_slots_bwd`).
    segment_sum: str = "doubling"
    fragment_format: str = "f32"
    # Selects nothing in the port: the CUDA blend has no matmul (the TPU
    # kernels' triangular-cumsum matmul passes have no counterpart), and the
    # SSIM blur runs in full float32 whatever it says (train/losses.py).
    matmul_precision: str = "highest"
    # Forward feature stream: 'f32', or the int32 'packed16' / 'packed4'
    # streams of ops/stream16.py, which K1 and K2 unpack in the kernel.
    stream_format: str = "f32"
    quant_ranges: tuple | None = None
    # Selects nothing in the port: 'c64' moves the same bits as 'i32'
    # (tests/test_stream16.py:100-130), so the packed gather is one int32
    # index_select (ops/stream16.py::gather_packed).
    slot_gather: str = "i32"

    # ---- derived (static) ----
    @property
    def tiles_x(self) -> int:
        return cdiv(self.width, self.tile_size)

    @property
    def tiles_y(self) -> int:
        return cdiv(self.height, self.tile_size)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def pixels_per_tile(self) -> int:
        return self.tile_size * self.tile_size

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile_size

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile_size

    def __post_init__(self):
        if self.max_per_tile % self.block_size != 0:
            raise ValueError("max_per_tile must be a multiple of block_size")
        if self.tile_size < 1:
            raise ValueError("tile_size must be positive")
        if self.binning not in ("sort", "scatter", "packed", "tiered"):
            raise ValueError(f"unknown binning mode {self.binning!r}")
        if self.gather_backward not in ("variadic", "permute", "c64", "bf16"):
            raise ValueError(
                f"unknown gather_backward {self.gather_backward!r}"
            )
        if self.grad_readout not in ("f32", "bf16"):
            raise ValueError(f"unknown grad_readout {self.grad_readout!r}")
        if self.segment_sum not in ("doubling", "pallas"):
            raise ValueError(f"unknown segment_sum {self.segment_sum!r}")
        if self.gather_backward == "bf16" and (
            self.segment_sum != "pallas" or self.grad_readout != "bf16"
        ):
            raise ValueError(
                "gather_backward='bf16' keeps the gradient stream pair-"
                "packed end-to-end; it requires segment_sum='pallas' and "
                "grad_readout='bf16'"
            )
        if self.matmul_precision not in ("default", "high", "highest"):
            raise ValueError(
                f"unknown matmul_precision {self.matmul_precision!r}"
            )
        if self.stream_format not in ("f32", "packed16", "packed4"):
            raise ValueError(f"unknown stream_format {self.stream_format!r}")
        if self.slot_gather not in ("i32", "c64"):
            raise ValueError(f"unknown slot_gather {self.slot_gather!r}")
        if self.fragment_format not in ("f32", "bf16"):
            raise ValueError(
                f"unknown fragment_format {self.fragment_format!r}"
            )
        if self.stream_format in ("packed16", "packed4") and self.binning == "scatter":
            raise ValueError(
                "stream_format='packed16' needs the gidk stream for its "
                "fused backward; binning='scatter' does not produce one"
            )
        if self.max_tiles_jumbo:
            if self.binning != "tiered":
                raise ValueError(
                    "max_tiles_jumbo requires binning='tiered' (the jumbo "
                    "ladder extends the tiered candidate pools)"
                )
            if self.max_tiles_jumbo <= self.max_tiles_per_gaussian:
                raise ValueError(
                    "max_tiles_jumbo must exceed max_tiles_per_gaussian"
                )
            if self.max_tiles_jumbo > 2048:
                raise ValueError(
                    "max_tiles_jumbo > 2048 leaves < 20 gid bits in the "
                    "int32 gidk packing"
                )
            if not self.jumbo_tier_spec:
                raise ValueError(
                    "max_tiles_jumbo needs a jumbo_tier_spec ladder, e.g. "
                    "((256, 8192), (512, 2048), (1024, 512))"
                )
            ks = [k for k, _ in self.jumbo_tier_spec]
            if ks != sorted(ks) or ks[-1] != self.max_tiles_jumbo:
                raise ValueError(
                    "jumbo_tier_spec k_hi values must ascend and end at "
                    f"max_tiles_jumbo ({self.max_tiles_jumbo}); got {ks}"
                )
        if self.quant_ranges is not None and (
            not isinstance(self.quant_ranges, tuple)
            or len(self.quant_ranges) != 4
        ):
            raise ValueError(
                "quant_ranges must be a (lox, sx, loy, sy) tuple"
            )
        if self.stream_format == "packed4" and self.slot_gather == "c64":
            raise ValueError(
                "slot_gather='c64' pairs exactly 5 packed rows; the "
                "4-row 'packed4' stream has nothing to pair"
            )
        if self.stream_format in ("packed16", "packed4") and max(
            self.width, self.height
        ) > 8192:
            raise ValueError(
                "stream_format='packed16' quantizes means to u16 over "
                "1.1x the image extent; beyond 8192 px that is coarser "
                "than 1/8 px -- use stream_format='f32'"
            )
        if self.pixels_per_tile > MAX_PIXELS_PER_TILE:
            raise ValueError(
                f"pixels_per_tile = {self.pixels_per_tile} exceeds the CUDA "
                f"blend kernels' {MAX_PIXELS_PER_TILE} (a 32x32 tile); use "
                "tile_size <= 32"
            )
