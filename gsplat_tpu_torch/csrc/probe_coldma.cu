// P4: the per-column copy probe, the cost model of an in-kernel feature
// gather.
//
// Replaces the TPU kernel scripts/micro_kernel_costs.py::bench_dma's
// percol_kernel_wrap (pallas_call at :229): for block i and column j,
// out[i][r][j] = table[r][idx[i][j]], r < F, with table (F, n) float32 in
// device memory and idx (B, G) int32 (F = 8, n = 2^20, B = 2048, G = 128 in
// the script). On the TPU each column was one DMA of an (8, 1) slice into
// VMEM, issued and waited one at a time.
//
// What bounds it on an H100: bytes, counted in the 32-byte sectors device
// memory delivers. A column of a row-major (8, n) table is 8 scattered 4-byte
// words, each in its own sector; columns that share a sector need it once.
// So the least the card must move is 32 bytes per distinct (row, sector) the
// indices touch, plus idx (1.05 MB) and out (8.39 MB): at the script's shape
// 262,144 random columns touch about 113k of each row's 131,072 sectors, some
// 38 MB, 0.011 ms at 3.35 TB/s (chip_smoke.py counts this run's sectors). The
// table is 32 MiB and fits in the 50 MB L2, so launches after the first can
// run under that bound. Design: one CTA per block i and one thread per column
// j; each thread issues F 4-byte cp.async.ca copies (rows 0..F-1 of its
// column) into an (F, G) shared buffer, then cp.async.commit_group /
// wait_group 0 and __syncthreads, and the block goes out as F coalesced rows
// of G floats. Why not TMA: a TMA box's inner extent must be at least 16
// bytes, and one column of the table is 4 bytes per row. Bit-exact (a copy);
// an index outside [0, n) gives NaN instead of a read past the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d),
               "l"(src));
}

__global__ void coldma_kernel(const float* __restrict__ table,
                              const int32_t* __restrict__ idx,
                              float* __restrict__ out, int64_t n, int f,
                              int g) {
  extern __shared__ float buf[];  // (f, g)
  const int64_t i = blockIdx.x;
  const int j = threadIdx.x;
  const int32_t c = idx[i * g + j];
  if ((uint32_t)c < (uint64_t)n) {
    for (int r = 0; r < f; ++r) cp_async4(buf + r * g + j, table + r * n + c);
  } else {
    for (int r = 0; r < f; ++r) buf[r * g + j] = __int_as_float(0x7fc00000);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  float* o = out + i * f * g;
  for (int r = 0; r < f; ++r) o[r * g + j] = buf[r * g + j];
}

}  // namespace

extern "C" int gsplat_probe_coldma(const float* table, const int32_t* idx,
                                   float* out, int64_t n, int f, int64_t b,
                                   int g, void* stream) {
  if (b > 0 && g > 0 && f > 0) {
    const size_t smem = (size_t)f * g * sizeof(float);
    coldma_kernel<<<(unsigned)b, g, smem, (cudaStream_t)stream>>>(
        table, idx, out, n, f, g);
  }
  return (int)cudaGetLastError();
}
