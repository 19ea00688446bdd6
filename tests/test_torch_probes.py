"""The port's cost probes (`gsplat_tpu_torch/ops/cuda/probes.py`, the CPU
side of kernels P1-P4) against the TPU kernels of
`scripts/micro_kernel_costs.py` run by Pallas in interpret mode, on inputs
made with numpy from a seed; P2's precisions also against a float64
emulation of their bf16 passes."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from gsplat_tpu.ops.blend import make_triangular as jax_make_triangular  # noqa: E402
from gsplat_tpu_torch import micro_kernel_costs  # noqa: E402
from gsplat_tpu_torch.ops.cuda import counters, probes  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
G = 128


@pytest.fixture(scope="module")
def tpu_script():
    """scripts/micro_kernel_costs.py as a module (it is a script, not part
    of a package)."""
    spec = importlib.util.spec_from_file_location(
        "micro_kernel_costs_tpu", ROOT / "scripts" / "micro_kernel_costs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _neg_normal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (-np.abs(rng.standard_normal(shape)) * scale).astype(np.float32)


def _assert_close_rel(got, want):
    """|jax - port| <= 1e-6 |jax| + 1e-7: XLA's CPU code and torch round
    the float32 chains at a few places differently (an ulp or two)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert bool((np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-7).all()), \
        float(np.max(np.abs(got - want) / (np.abs(want) + 1e-30)))


# ---------------------------------------------------------------------- P1

@pytest.mark.parametrize("mode", list(probes.TRANSC_MODES))
def test_transc_matches_tpu_kernel(tpu_script, mode):
    """P1 at (256, 1024), two (128, 1024) blocks of the script's grid."""
    x = _neg_normal((256, 1024), 0)
    spec = pl.BlockSpec((128, 1024), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    want = pl.pallas_call(
        functools.partial(tpu_script._transc_kernel, mode=mode),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        grid=(2,), in_specs=[spec], out_specs=spec, interpret=True,
    )(jnp.asarray(x))
    got = probes.transc(torch.from_numpy(x), mode)
    assert got.dtype == torch.float32
    _assert_close_rel(got.numpy(), want)


def test_fast_polynomials_match_tpu_script(tpu_script):
    """fast_exp and fast_log1p_neg on the script's own accuracy inputs
    (micro_kernel_costs.py:109-112), made here with numpy."""
    xs = _neg_normal((8, 128), 1, scale=4.0)
    _assert_close_rel(probes.fast_exp(torch.from_numpy(xs)).numpy(),
                      tpu_script.fast_exp(jnp.asarray(xs)))
    aa = np.linspace(0.0, 0.99, 1024, dtype=np.float32).reshape(8, 128)
    _assert_close_rel(probes.fast_log1p_neg(torch.from_numpy(aa)).numpy(),
                      tpu_script.fast_log1p_neg(jnp.asarray(aa)))


def test_transc_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        probes.transc(torch.zeros(4), "exp2")


# ---------------------------------------------------------------------- P2

def test_make_triangular_matches_jax():
    np.testing.assert_array_equal(probes.make_triangular(G).numpy(),
                                  np.asarray(jax_make_triangular(G)))


def test_tricumsum_highest_matches_tpu_kernel(tpu_script):
    """On the CPU JAX computes jnp.dot in full float32 whatever the
    precision, so only HIGHEST can be held to the TPU kernel directly."""
    x = _neg_normal((2, 1024, G), 2, scale=0.05)
    want = pl.pallas_call(
        functools.partial(tpu_script._cumsum_kernel,
                          prec=jax.lax.Precision.HIGHEST),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        grid=(2,),
        in_specs=[pl.BlockSpec((1, 1024, G), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((G, G), lambda i: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1024, G), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(x), jax_make_triangular(G))
    got = probes.tri_cumsum(torch.from_numpy(x), "highest").numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def _bf16_np(v):
    """float32 -> nearest bf16 (ties to even), as float32."""
    b = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _emulated_passes(x, tri, parts):
    """The TPU's float32 matmul at 1, 2 or 3 bf16 parts per operand: the
    products of parts i.j with i + j < parts (1, 3 or 6 of them), in
    float64."""
    def split(v):
        out, rest = [], v.astype(np.float32)
        for _ in range(parts):
            out.append(_bf16_np(rest))
            rest = (rest - out[-1]).astype(np.float32)
        return [p.astype(np.float64) for p in out]

    xs, ts = split(x), split(tri)
    return sum(xs[i] @ ts[j] for i in range(parts) for j in range(parts)
               if i + j < parts)


@pytest.mark.parametrize("precision, parts", [("default", 1), ("high", 2),
                                              ("highest", 3)])
def test_tricumsum_precisions_match_the_pass_emulation(precision, parts):
    """Each precision within 1e-5 of a float64 emulation of its passes (the
    float32 sums differ in order only); `default` is also within 2^-8 of
    the running sum of |x| from the exact cumsum (one bf16 rounding of each
    term)."""
    x = _neg_normal((2, 1024, G), 3, scale=0.05)
    tri = np.asarray(jax_make_triangular(G))
    got = probes.tri_cumsum(torch.from_numpy(x), precision).numpy()
    np.testing.assert_allclose(got, _emulated_passes(x, tri, parts), rtol=0,
                               atol=1e-5)
    exact = np.cumsum(x.astype(np.float64), axis=-1)
    if precision == "default":
        scale = np.cumsum(np.abs(x.astype(np.float64)), axis=-1)
        assert bool((np.abs(got - exact) <= 2.0 ** -8 * scale).all())
        assert np.abs(got - exact).max() > 1e-4  # one pass is not f32
    else:
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)


def test_tricumsum_passes_are_the_tpu_definition():
    """PASSES holds the products i.j with i + j < parts, each once,
    smallest terms (largest i + j) first and hi.hi last."""
    for name, parts in (("default", 1), ("high", 2), ("highest", 3)):
        passes = probes.PASSES[name]
        assert sorted(passes) == sorted(
            (i, j) for i in range(parts) for j in range(parts)
            if i + j < parts)
        order = [i + j for i, j in passes]
        assert order == sorted(order, reverse=True) and passes[-1] == (0, 0)


# ---------------------------------------------------------------------- P3

def _gather_kernel(tab_ref, idx_ref, o_ref):
    # micro_kernel_costs.py:156-159 (a closure inside bench_gather).
    o_ref[...] = jnp.take_along_axis(
        tab_ref[...], idx_ref[...], axis=-1
    )


def test_lane_gather_matches_tpu_kernel_bit_for_bit():
    rng = np.random.default_rng(4)
    tab = rng.standard_normal((8, 512)).astype(np.float32)
    idx = rng.integers(0, 512, size=(8, 512)).astype(np.int32)
    want = pl.pallas_call(
        _gather_kernel,
        out_shape=jax.ShapeDtypeStruct((8, 512), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(tab), jnp.asarray(idx))
    got = probes.lane_gather(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _edge_indices(seed, **shape):
    """chip_smoke.probe_edge_indices, the edge indices the card's check
    feeds P3 and P4, so that those inputs are held to JAX here."""
    import chip_smoke

    return chip_smoke.probe_edge_indices(seed, **shape)


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("seed, rows, cols", [(0, 8, 512), (1, 3, 37)])
def test_lane_gather_edge_indices_match_tpu_kernel(seed, rows, cols):
    """P3's plain route on every edge of its index rule (-1, C, -C - 1,
    10^6, -C, -2^31, 2^31 - 1, 0, C - 1 in each row, the rest in [-2C, 2C))
    against the TPU kernel in interpret mode: the same bits, NaN only where
    JAX has NaN (an index outside [-C, C))."""
    idx, _ = _edge_indices(seed, rows=rows, cols=cols, n=4096, blocks=1)
    tab = np.random.default_rng(seed).standard_normal(
        (rows, cols)).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        _gather_kernel,
        out_shape=jax.ShapeDtypeStruct((rows, cols), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(tab), jnp.asarray(idx)))
    got = probes.lane_gather(torch.from_numpy(tab),
                             torch.from_numpy(idx)).numpy()
    outside = (idx < -cols) | (idx >= cols)
    assert outside.any() and ((idx < 0) & ~outside).any()
    np.testing.assert_array_equal(np.isnan(want), outside)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------- P4

def _column_copy_tpu(idx, table):
    """bench_dma's kernel (micro_kernel_costs.py:201-236) at a small n and
    block count; percol_kernel_wrap is a closure there, copied verbatim."""
    nblocks = idx.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(nblocks,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, 8, G), lambda i, idx: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[
            pltpu.VMEM((8, G), jnp.float32),
            pltpu.SemaphoreType.DMA((16,)),
        ],
    )

    def percol_kernel_wrap(idx_ref, tab_hbm, o_ref, buf, sems):
        i = pl.program_id(0)

        def body(j, _):
            c = pltpu.make_async_copy(
                tab_hbm.at[:, pl.ds(idx_ref[i, j], 1)],
                buf.at[:, pl.ds(j, 1)],
                sems.at[j % 16],
            )
            c.start()
            c.wait()
            return 0

        jax.lax.fori_loop(0, G, body, 0)
        o_ref[0] = buf[...]

    k = pl.pallas_call(
        percol_kernel_wrap,
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((nblocks, 8, G), jnp.float32),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",),
        ),
        interpret=True,
    )
    return np.asarray(k(jnp.asarray(idx), jnp.asarray(table)))


def test_column_copy_matches_tpu_kernel_bit_for_bit():
    rng = np.random.default_rng(5)
    n = 4096
    table = rng.standard_normal((8, n)).astype(np.float32)
    idx = rng.integers(0, n, size=(4, G)).astype(np.int32)
    want = _column_copy_tpu(idx, table)
    got = probes.column_copy(torch.from_numpy(table), torch.from_numpy(idx))
    assert tuple(got.shape) == (4, 8, G)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed, n, blocks", [(0, 4096, 4), (1, 1000, 3)])
def test_column_copy_edge_indices_match_tpu_kernel(seed, n, blocks):
    """P4's plain route on every edge of its index rule (-1, -2, n, n + 5,
    10^6, -n, -n - 1, -2^31, 2^31 - 1, 0, n - 1 in each block, the rest in
    [-2n, 2n)) against the TPU kernel in interpret mode: the same bits (a
    negative index wraps once, then clamps into [0, n - 1]) and no NaN."""
    _, idx = _edge_indices(seed, n=n, blocks=blocks, g=G)
    table = np.random.default_rng(seed).standard_normal(
        (8, n)).astype(np.float32)
    want = _column_copy_tpu(idx, table)
    got = probes.column_copy(torch.from_numpy(table),
                             torch.from_numpy(idx)).numpy()
    assert ((idx >= n) | (idx < -n)).any() and ((idx < 0) & (idx >= -n)).any()
    assert not np.isnan(want).any()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_probe_edge_indices_hold_every_edge_in_each_row():
    """The seeded edge indices: int32, the stated shapes, every edge value
    in each P3 row and each P4 block, and the same arrays for one seed."""
    rows, cols, n, blocks, g = 3, 40, 1000, 5, 16
    i3, i4 = _edge_indices(7, rows=rows, cols=cols, n=n, blocks=blocks, g=g)
    assert i3.dtype == i4.dtype == np.int32
    assert i3.shape == (rows, cols) and i4.shape == (blocks, g)
    lo, hi = -2 ** 31, 2 ** 31 - 1
    for row in i3:
        assert {-1, cols, -cols - 1, 10 ** 6, -cols, lo, hi, 0,
                cols - 1} <= set(row.tolist())
    for block in i4:
        assert {-1, -2, n, n + 5, 10 ** 6, -n, -n - 1, lo, hi, 0,
                n - 1} <= set(block.tolist())
    j3, j4 = _edge_indices(7, rows=rows, cols=cols, n=n, blocks=blocks, g=g)
    np.testing.assert_array_equal(i3, j3)
    np.testing.assert_array_equal(i4, j4)


# ------------------------------------------------------ wrappers, entry point

def _cpu_inputs():
    x = torch.from_numpy(_neg_normal((4, G), 6))
    tab = torch.zeros((8, 512))
    idx = torch.zeros((8, 512), dtype=torch.int32)
    return x, tab, idx


def test_dispatchers_take_the_plain_route_on_the_cpu():
    """CPU tensors never reach a build or a launch: the counts stay."""
    x, tab, idx = _cpu_inputs()
    before = counters.snapshot()
    probes.transc(x, "exact3")
    probes.tri_cumsum(x, "high")
    probes.lane_gather(tab, idx)
    probes.column_copy(tab, idx[:2, :G])
    assert counters.rise(before, counters.snapshot()) == {}


def test_kernel_wrappers_refuse_cpu_and_malformed_tensors():
    x, tab, idx = _cpu_inputs()
    for call in (lambda: probes.transc_cuda(x, "exact"),
                 lambda: probes.tricumsum_cuda(x, "default"),
                 lambda: probes.lane_gather_cuda(tab, idx),
                 lambda: probes.column_copy_cuda(tab, idx)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="float32"):
        probes.lane_gather_cuda(tab.double(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        probes.transc_cuda(x.t(), "exact")
    meta = torch.zeros((4, G), device="meta")
    with pytest.raises(ValueError, match="device"):
        probes.tri_cumsum(meta, "default")
    with pytest.raises(ValueError, match="device"):
        probes.transc(meta, "mults")


def test_entry_point_prints_every_probe_on_the_cpu(capsys):
    assert micro_kernel_costs.main(
        ["all", "--device", "cpu"], transc=dict(rows=16, cols=256),
        prec=dict(blocks=2, p=64), dma=dict(n=4096, nblocks=4)) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    for mode in probes.TRANSC_MODES:
        assert sum(ln.startswith(f"transc {mode} ") for ln in lines) == 1
    assert sum(ln.startswith("fast_exp max rel err") for ln in lines) == 1
    for name in probes.PASSES:
        assert sum(ln.startswith(f"tri-cumsum {name} ") for ln in lines) == 1
    assert "lane gather from shared memory: correct=True" in lines
    assert sum(ln.startswith("per-column copy gather:") for ln in lines) == 1
    assert len(lines) == 11


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        micro_kernel_costs.main(["gather"])
