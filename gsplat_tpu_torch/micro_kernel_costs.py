"""The four cost probes of `scripts/micro_kernel_costs.py`, on an NVIDIA GPU
through the port's probe kernels (`ops/cuda/probes.py`):

1. transcendental cost: exact exp / log1p against multiplies only and
   against bit-trick polynomials, elementwise over 2^29 float32 values
   shaped like the blend's inner loop (P1, `csrc/probe_transc.cu`);
2. the triangular cumsum x @ tri on the tensor cores at the TPU's DEFAULT /
   HIGH / HIGHEST precisions: 1, 3 or 6 bf16 passes (P2,
   `csrc/probe_tricumsum.cu`);
3. a lane gather from a table held in shared memory (P3,
   `csrc/probe_gather.cu`);
4. one copy per column from an (8, 2^20) table, 128 columns per block: the
   cost model of a feature gather inside the blend kernel (P4,
   `csrc/probe_coldma.cu`).

    python -m gsplat_tpu_torch.micro_kernel_costs [exp|prec|gather|dma|all] [--device cpu]

On the card (the default) the kernels run, timed with CUDA events after one
warm-up call; with `--device cpu` the plain PyTorch versions run, timed with
the host clock. Without a card and without `--device cpu` it raises. The
shapes are the TPU script's; the bench_* functions take smaller ones as
arguments.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from gsplat_tpu_torch.ops.cuda import probes

P, G = 1024, 128
BLOCKS = 4096  # ~0.5G lane elements
ITERS = 20
DMA_ITERS = 5
# Clock cycles of the spin kernel that holds the card while the timed
# launches are queued (some milliseconds).
SPIN_CYCLES = 10_000_000


def timeit(device, fn, iters: int):
    """(ms per call, the output of a warm-up call) over `iters` calls after
    two warm-up calls, so that the allocator already holds the blocks the
    timed calls take: CUDA events on the card, the host clock on the CPU.
    On the card the calls queue behind a spin kernel, so the events time
    the kernels back to back even where one is shorter than its launch
    from Python."""
    out = fn()
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        torch.cuda._sleep(SPIN_CYCLES)  # torch's spin kernel (private API)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3, out


def _gen(device, seed: int):
    return torch.Generator(device=device).manual_seed(seed)


def bench_transc(device, rows: int = BLOCKS * P // 8, cols: int = G * 8,
                 iters: int = ITERS) -> None:
    x = -torch.randn((rows, cols), generator=_gen(device, 0),
                     device=device).abs()
    for mode in probes.TRANSC_MODES:
        ms, _ = timeit(device, lambda: probes.transc(x, mode), iters)
        print(f"transc {mode:8s}: {ms:9.4f} ms "
              f"({x.numel() / ms / 1e6:.2f} Gelem/s)")
    # accuracy of the polynomials (micro_kernel_costs.py:108-114)
    xs = -torch.randn((8, 128), generator=_gen(device, 1),
                      device=device).abs() * 4
    err_e = ((probes.fast_exp(xs) - torch.exp(xs)).abs() / torch.exp(xs)).max()
    aa = torch.linspace(0.0, 0.99, 1024, device=device).reshape(8, 128)
    err_l = (probes.fast_log1p_neg(aa) - torch.log1p(-aa)).abs().max()
    print(f"fast_exp max rel err {float(err_e):.2e}, "
          f"fast_log1p max abs err {float(err_l):.2e}")


def bench_precision(device, blocks: int = BLOCKS, p: int = P,
                    iters: int = ITERS) -> None:
    x = -torch.randn((blocks, p, G), generator=_gen(device, 0),
                     device=device).abs() * 0.05
    ref = torch.cumsum(x[:4], dim=-1)
    for name in probes.PASSES:
        ms, out = timeit(device, lambda: probes.tri_cumsum(x, name), iters)
        err = (out[:4] - ref).abs().max()
        print(f"tri-cumsum {name:8s}: {ms:9.4f} ms "
              f"({blocks * p * G * G / ms / 1e9:.1f} GMAC/ms) "
              f"max abs err vs f32 cumsum {float(err):.2e}")
        del out


def bench_gather(device) -> None:
    tab = torch.randn((8, 512), generator=_gen(device, 0), device=device)
    idx = torch.randint(0, 512, (8, 512), generator=_gen(device, 1),
                        device=device, dtype=torch.int32)
    out = probes.lane_gather(tab, idx)
    ok = bool(torch.equal(out, probes.lane_gather_plain(tab, idx)))
    print(f"lane gather from shared memory: correct={ok}")


def bench_dma(device, n: int = 1 << 20, nblocks: int = 2048,
              iters: int = DMA_ITERS) -> None:
    table = torch.randn((8, n), generator=_gen(device, 0), device=device)
    idx = torch.randint(0, n, (nblocks, G), generator=_gen(device, 1),
                        device=device, dtype=torch.int32)
    ms, _ = timeit(device, lambda: probes.column_copy(table, idx), iters)
    ncols = nblocks * G
    print(f"per-column copy gather: {ms:.4f} ms for {ncols} columns "
          f"-> {ms * 1e6 / ncols:.4f} ns/column")


def main(argv=None, *, transc=None, prec=None, dma=None) -> int:
    """Run the probes named on the command line. `transc`, `prec` and `dma`
    are keyword arguments of bench_transc, bench_precision and bench_dma
    (smaller shapes); the command line sets none of them."""
    ap = argparse.ArgumentParser(
        prog="python -m gsplat_tpu_torch.micro_kernel_costs",
        description="The TPU cost probes as CUDA kernels.")
    ap.add_argument("what", nargs="?", default="all",
                    choices=("exp", "prec", "gather", "dma", "all"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain PyTorch versions")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("micro_kernel_costs: no CUDA card; pass "
                               "--device cpu for the plain versions")
        device = torch.device("cuda", torch.cuda.current_device())
        print(f"device: {torch.cuda.get_device_name(device)} (kernels)")
    else:
        print("device: cpu (plain PyTorch versions)")
    if args.what in ("exp", "all"):
        bench_transc(device, **(transc or {}))
    if args.what in ("prec", "all"):
        bench_precision(device, **(prec or {}))
    if args.what in ("gather", "all"):
        bench_gather(device)
    if args.what in ("dma", "all"):
        bench_dma(device, **(dma or {}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
