"""The segmented suffix sum of the port (the plain doubling, the CPU side of
kernel K4) against the JAX package's Pallas kernel in interpret mode and a
numpy per-run reduction, on the data of tests/test_pallas.py:173-206."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu.ops.pallas.segsum import segmented_suffix_sum as jax_segsum  # noqa: E402
from gsplat_tpu_torch.ops.cuda import segsum  # noqa: E402

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
    """A run longer than kmax (out of contract unless it carries zeros) is
    summed `doubling_depth(kmax)` slots deep; the kernel walks the same
    depth, so the two versions agree even there."""
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
    before = segsum.launches
    segsum.segmented_suffix_sum(torch.from_numpy(x), torch.from_numpy(rows),
                                KMAX)
    assert segsum.launches == before
