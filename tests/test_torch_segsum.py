"""The segmented suffix sums of the port (the plain doubling, the CPU side of
kernel K4, and its bf16-pair twin, the CPU side of K5) against the JAX
package's Pallas kernels in interpret mode and a numpy per-run reduction,
on the data of tests/test_pallas.py:173-206, on runs of up to 2048 slots
(kmax 2048, the exact step with the jumbo tiers) and on chip_smoke.py's
hand-made run layouts, which the CUDA kernels meet on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu.ops.pallas.segsum import segmented_suffix_sum as jax_segsum  # noqa: E402
from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs, unpack_bf16_pairs  # noqa: E402
from gsplat_tpu_torch.ops.cuda import counters, segsum  # noqa: E402

KMAX, F = 16, 5


@pytest.fixture(scope="module")
def runs():
    """Sorted run ids with gaps (runs of 1..kmax slots, crossing block
    edges) and an invalid tail longer than kmax carrying zeros, as in the
    JAX package's test."""
    rng = np.random.default_rng(0)
    ids = np.cumsum(rng.integers(1, 4, size=300))
    lengths = rng.integers(1, KMAX + 1, size=300)
    rows = np.repeat(ids, lengths).astype(np.int32)
    m = rows.shape[0]
    rows = np.concatenate([rows, np.full(50, (2**31 - 1) >> 7, np.int32)])
    x = rng.normal(size=(F, rows.shape[0])).astype(np.float32)
    x[:, m:] = 0.0
    ref = np.zeros_like(x)
    start = 0
    for ln in lengths:
        seg = x[:, start : start + ln]
        ref[:, start : start + ln] = np.cumsum(seg[:, ::-1], axis=1)[:, ::-1]
        start += ln
    return x, rows, m, ref


@pytest.mark.parametrize("block_size", [256, 2048])
def test_plain_segsum_matches_jax_kernel_and_naive(runs, block_size):
    """The port returns (F, M); the TPU kernel pads M to its block size, so
    its output is cut to the first M lanes (the pad lanes hold 0)."""
    x, rows, m, ref = runs
    got = segsum.segmented_suffix_sum(torch.from_numpy(x),
                                      torch.from_numpy(rows), KMAX).numpy()
    want = np.asarray(jax_segsum(jnp.asarray(x), jnp.asarray(rows), kmax=KMAX,
                                 block_size=block_size, interpret=True))
    assert got.shape == x.shape
    assert want.shape[1] % block_size == 0 and not want[:, x.shape[1]:].any()
    np.testing.assert_allclose(got[:, :m], ref[:, :m], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want[:, : x.shape[1]], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kmax, depth", [(1, 1), (2, 2), (3, 4), (16, 16),
                                         (64, 64)])
def test_long_runs_are_summed_as_deep_as_the_doubling(kmax, depth):
    """The plain doubling sums a run longer than kmax (out of contract
    unless it carries zeros) `doubling_depth(kmax)` slots deep. The kernels
    sum every run of at most that depth whole, as the doubling does; on a
    longer run they may reach further, which the pipeline's one such run,
    the all-zero invalid tail, cannot show."""
    assert segsum.doubling_depth(kmax) == depth
    x = torch.arange(1.0, 101.0)[None, :]
    rows = torch.zeros(100, dtype=torch.int32)
    got = segsum.segmented_suffix_sum(x, rows, kmax)[0]
    want = [float(x[0, j : j + depth].sum()) for j in range(100)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_non_finite_values_stay_in_their_run():
    """The doubling selects with torch.where: a NaN slot poisons its own
    run's sums, not a neighbouring run's (NaN * 0 would be NaN)."""
    x = torch.ones((2, 8))
    x[:, 5] = float("nan")
    rows = torch.tensor([0, 0, 0, 1, 1, 2, 2, 2], dtype=torch.int32)
    got = segsum.segmented_suffix_sum(x, rows, 4)
    np.testing.assert_array_equal(got[:, :5].numpy(), [[3, 2, 1, 2, 1]] * 2)
    assert bool(torch.isnan(got[:, 5]).all())


def test_segsum_wrapper_checks_its_inputs(runs):
    x, rows, _, _ = runs
    with pytest.raises(ValueError, match="device"):
        segsum.segmented_suffix_sum(torch.zeros((2, 4), device="meta"),
                                    torch.zeros(4, dtype=torch.int32,
                                                device="meta"), 4)
    # The launcher takes CUDA tensors only: a CPU tensor never reaches a
    # build or a launch, and the plain path counts no launch.
    with pytest.raises(ValueError, match="CUDA"):
        segsum.segmented_suffix_sum_cuda(torch.from_numpy(x),
                                         torch.from_numpy(rows), KMAX)
    before = counters.snapshot()
    segsum.segmented_suffix_sum(torch.from_numpy(x), torch.from_numpy(rows),
                                KMAX)
    assert counters.rise(before, counters.snapshot()) == {}


def _pairs_and_runs(n_runs, max_len, seed, tail=50):
    """bf16 pairs (P = 5) over sorted runs of 1..max_len slots, the (8|0)
    opacity pairing included (row 9 is zero, so pair 4 has a zero high
    half), and an invalid tail carrying zeros."""
    rng = np.random.default_rng(seed)
    ids = np.cumsum(rng.integers(1, 4, size=n_runs))
    rows = np.repeat(ids, rng.integers(1, max_len + 1, size=n_runs))
    m = rows.shape[0]
    rows = np.concatenate([rows, np.full(tail, (2**31 - 1) >> 11)]).astype(
        np.int32)
    x = rng.normal(size=(10, rows.shape[0])).astype(np.float32)
    x[9] = 0.0
    x[:, m:] = 0.0
    return pack_bf16_pairs(torch.from_numpy(x)), rows


def _jax_packed(xp, rows, kmax, block_size):
    want = jax_segsum(jnp.asarray(xp.numpy()), jnp.asarray(rows), kmax=kmax,
                      block_size=block_size, interpret=True, packed=True)
    return np.array(want)[:, : rows.shape[0]]


@pytest.mark.parametrize("kmax, max_len, block_size", [
    (16, 16, 8192),     # one block
    (2048, 2048, 32768),  # one block, runs up to 2048 slots long
])
def test_packed_plain_segsum_is_bit_exact_with_jax_kernel(kmax, max_len,
                                                          block_size):
    """K5's plain version sums in the order of the TPU kernel's in-block
    doubling and rounds the same way: over one block the int32 words are
    equal. The zero-high opacity pairs keep their low halves."""
    xp, rows = _pairs_and_runs(300 if kmax == 16 else 12, max_len, 2)
    assert rows.shape[0] <= block_size
    got = segsum.segmented_suffix_sum(xp, torch.from_numpy(rows), kmax)
    assert got.dtype == torch.int32 and got.shape == xp.shape
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_packed(xp, rows, kmax, block_size))
    opacity = got[4].numpy()
    assert (opacity & np.int32(-65536) == 0).all() and (opacity != 0).any()


def test_packed_plain_segsum_across_blocks_within_one_bf16_ulp():
    """With runs crossing the TPU kernel's block edges its carry adds in
    another order: the halves agree to one bf16 ulp (2^-7 relative to the
    bf16 value's exponent)."""
    xp, rows = _pairs_and_runs(300, 16, 3)
    got = segsum.segmented_suffix_sum(xp, torch.from_numpy(rows), 16)
    want = torch.from_numpy(_jax_packed(xp, rows, 16, 256))
    a, b = unpack_bf16_pairs(got, 10), unpack_bf16_pairs(want, 10)
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
    assert bool(((a - b).abs() <= ulp).all())
    assert float((got == want).float().mean()) > 0.9


def test_packed_segsum_wrapper_checks_its_inputs(runs):
    x, rows, _, _ = runs
    xp = pack_bf16_pairs(torch.from_numpy(x))
    # A float32 stream of pairs is refused before any launch or build.
    with pytest.raises(ValueError, match="int32"):
        segsum.segmented_suffix_sum_packed_cuda(xp.view(torch.float32),
                                                torch.from_numpy(rows), KMAX)
    with pytest.raises(ValueError, match="CUDA"):
        segsum.segmented_suffix_sum_packed_cuda(xp, torch.from_numpy(rows),
                                                KMAX)
    before = counters.snapshot()
    out = segsum.segmented_suffix_sum(xp, torch.from_numpy(rows), KMAX)
    assert counters.rise(before, counters.snapshot()) == {}
    assert out.dtype == torch.int32


def _per_run(x, rows):
    """Per-run reverse cumulative sums in float64, run by run: a NaN stays
    in its run."""
    x = np.asarray(x, np.float64)
    out = np.zeros_like(x)
    edges = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1], True])
    for a, b in zip(edges[:-1], edges[1:]):
        out[:, a:b] = np.cumsum(x[:, a:b][:, ::-1], axis=1)[:, ::-1]
    return out


def _within_span(got, want, x, rows, ulp=False):
    """|got - want| <= 1e-6 + 1e-5 times the summed span's absolute sum
    (chip_smoke.py's tolerance for K4 and K5), or within one bf16 ulp of
    the larger value with `ulp`; NaNs at the same places."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    scale = _per_run(np.abs(np.nan_to_num(x)), rows)
    err = np.abs(np.nan_to_num(got) - np.nan_to_num(want))
    tol = 1e-6 + 1e-5 * scale
    if ulp:
        big = np.maximum(np.abs(np.nan_to_num(got)), np.abs(np.nan_to_num(want)))
        tol = np.maximum(tol, np.exp2(np.floor(np.log2(np.maximum(big, 1e-30)))
                                      - 7))
    assert (err <= tol).all(), float((err / tol).max())


def test_plain_segsum_matches_jax_at_kmax_2048_across_blocks():
    """The exact step with the jumbo tiers sums at kmax 2048: runs of up to
    2048 slots that cross the TPU kernel's 2048-lane blocks, then a zero
    tail longer than 2048 (the invalid slots), through the plain doubling
    against the JAX kernel and a per-run numpy reduction."""
    rng = np.random.default_rng(7)
    lengths = rng.integers(1, 2049, size=24)
    lengths[:3] = (2048, 2047, 2048)
    ids = np.cumsum(rng.integers(1, 4, size=lengths.size))
    rows = np.repeat(ids, lengths)
    m = rows.size
    rows = np.concatenate([rows, np.full(2500, 2**31 - 1)]).astype(np.int32)
    x = rng.normal(size=(9, rows.size)).astype(np.float32)
    x[:, m:] = 0.0
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    ends = np.r_[starts[1:], rows.size]
    assert ((starts // 2048) != ((ends - 1) // 2048)).sum() >= 10
    got = segsum.segmented_suffix_sum(torch.from_numpy(x),
                                      torch.from_numpy(rows), 2048).numpy()
    want = np.asarray(jax_segsum(jnp.asarray(x), jnp.asarray(rows), kmax=2048,
                                 block_size=2048, interpret=True))
    assert not want[:, rows.size:].any()
    _within_span(got, want[:, : rows.size], x, rows)
    _within_span(got, _per_run(x, rows), x, rows)
    assert not got[:, m:].any()


@pytest.mark.parametrize("packed", [False, True], ids=["f32", "pairs"])
@pytest.mark.parametrize("kmax", [2048, 64])
def test_hand_made_layouts_match_jax_and_numpy(kmax, packed):
    """chip_smoke.py's hand-made run layouts (the ones K4 and K5 meet on the
    card: runs starting and ending on the scan's warp, round and chunk
    edges, a run of kmax across a chunk edge, M not a multiple of 2048, a
    zero tail longer than the depth, a NaN in one run) through the plain
    versions: against the JAX kernel with the NaN set to 0, since JAX masks
    by a product (a NaN would leak into the run to its left) and its bf16
    rounding does not keep NaNs; and against a per-run numpy reduction with
    the NaN, which must stay in its run. Pairs: within one bf16 ulp, as the
    TPU kernel's carry adds in another order across its blocks."""
    import chip_smoke

    rows, x10, (first, stop) = chip_smoke.segsum_layout(kmax)
    nan_col = first + (stop - first) // 2
    assert np.isnan(x10[:9, nan_col]).all() and rows.size % 2048
    clean = np.nan_to_num(x10)
    if packed:
        xp, xp_clean = (pack_bf16_pairs(torch.from_numpy(v)) for v in (x10, clean))
        got = segsum.segmented_suffix_sum(xp, torch.from_numpy(rows), kmax)
        got_clean = segsum.segmented_suffix_sum(xp_clean,
                                                torch.from_numpy(rows), kmax)
        jax_clean = torch.from_numpy(_jax_packed(xp_clean, rows, kmax, 2048))
        vals = unpack_bf16_pairs(got, 10).numpy()
        _within_span(unpack_bf16_pairs(got_clean, 10).numpy(),
                     unpack_bf16_pairs(jax_clean, 10).numpy(),
                     unpack_bf16_pairs(xp_clean, 10).numpy(), rows, ulp=True)
        x_in = unpack_bf16_pairs(xp, 10).numpy()
    else:
        x_in = x10[:9]
        got = segsum.segmented_suffix_sum(torch.from_numpy(x_in.copy()),
                                          torch.from_numpy(rows), kmax)
        got_clean = segsum.segmented_suffix_sum(
            torch.from_numpy(clean[:9].copy()), torch.from_numpy(rows), kmax)
        want = np.asarray(jax_segsum(jnp.asarray(clean[:9]), jnp.asarray(rows),
                                     kmax=kmax, interpret=True))
        _within_span(got_clean.numpy(), want[:, : rows.size], clean[:9], rows)
        vals = got.numpy()
    _within_span(vals, _per_run(x_in, rows), x_in, rows, ulp=packed)
    nan_cols = np.flatnonzero(np.isnan(vals).any(0))
    np.testing.assert_array_equal(nan_cols, np.arange(first, nan_col + 1))
