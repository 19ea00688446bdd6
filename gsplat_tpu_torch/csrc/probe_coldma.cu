// P4: the per-column copy probe, the cost model of an in-kernel feature
// gather.
//
// Replaces the TPU kernel scripts/micro_kernel_costs.py::bench_dma's
// percol_kernel_wrap (pallas_call at :229): for block i and column j,
// out[i][r][j] = table[r][c(idx[i][j])], r < F, with table (F, n) float32
// in device memory and idx (B, G) int32 (F = 8, n = 2^20, B = 2048, G = 128
// in the script). On the TPU each column was one DMA of an (8, 1) slice
// into VMEM, issued and waited one at a time. Indices follow the
// reference's `pl.ds(idx, 1)`: c(j) = j + n for j < 0 (once, in 64 bits, so
// -2^31 + n cannot overflow), then clamped into [0, n - 1]. No index gives
// NaN; the plain version (ops/cuda/probes.py) applies the same rule.
//
// What bounds it on an H100: bytes, counted in the 32-byte sectors device
// memory delivers. A column of a row-major (8, n) table is 8 scattered 4-byte
// words, each in its own sector; columns that share a sector need it once.
// So the least the card must move is 32 bytes per distinct (row, sector) the
// indices touch, plus idx (1.05 MB) and out (8.39 MB): at the script's shape
// 262,144 random columns touch about 113k of each row's 131,072 sectors, some
// 38 MB, 0.011 ms at 3.35 TB/s (chip_smoke.py counts this run's sectors). The
// table is 32 MiB and fits in the 50 MB L2, so launches after the first can
// run under that bound.
//
// Design: nothing is staged. Where G % 4 == 0 (and idx is 16-byte aligned)
// a thread owns 4 consecutive columns of one block, read as one 16-byte
// index load; otherwise one column. It issues all its table loads -- F rows
// x its columns, in chunks of kRows rows -- before any store, as independent
// `ld.global.cg` loads (__ldcg: cached in L2 only, so the scattered words
// allocate nothing in L1, which nothing would read again), and writes each
// row straight out as one 16-byte streaming store (__stcs) into
// out[i][r][j..j+3]. For fixed (i, r) those are contiguous in j, so the 32
// threads of a warp (G / 4 = 32 groups of a block at the script's G) store
// 512 contiguous bytes per row. No shared memory, no cp.async, no barrier:
// a thread's stores wait only on its own loads. The grid is a grid-stride
// loop over (block, column group) of at most kCtasPerSm CTAs of kThreads per
// SM: 4 x 256 threads is half an SM's 2048, which __launch_bounds__ holds to
// 64 registers a thread (the 32 loaded values, 4 column offsets and the
// addresses), and each of them keeps kRows x 4 = 32 independent loads in
// flight, some 32K per SM, more than the latency of L2 or device memory
// needs; at the script's shape 65,536 groups fill 256 CTAs, so every thread
// takes one group and the stride loop only serves larger shapes. Bit-exact
// (a copy). Why not TMA: a TMA box's inner extent must be at least 16 bytes,
// and one column of the table is 4 bytes per row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 4;
constexpr int kRows = 8;

__device__ __forceinline__ int64_t column(int32_t j, int64_t n) {
  int64_t c = j;
  if (c < 0) c += n;
  return c < 0 ? 0 : (c >= n ? n - 1 : c);
}

template <int V>
struct Cols;
template <>
struct Cols<1> {
  __device__ static void load(const int32_t* idx, int64_t at, int64_t n,
                              int64_t* c) {
    c[0] = column(__ldg(idx + at), n);
  }
  __device__ static void store(float* o, const float* v) { __stcs(o, v[0]); }
};
template <>
struct Cols<4> {
  __device__ static void load(const int32_t* idx, int64_t at, int64_t n,
                              int64_t* c) {
    const int4 j = __ldg(reinterpret_cast<const int4*>(idx + at));
    c[0] = column(j.x, n);
    c[1] = column(j.y, n);
    c[2] = column(j.z, n);
    c[3] = column(j.w, n);
  }
  __device__ static void store(float* o, const float* v) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
  }
};

// V columns per thread; `groups` = g / V per block, `items` = b * groups.
template <int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
coldma_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
              float* __restrict__ out, int64_t n, int f, int g, int groups,
              int64_t items) {
  for (int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x; w < items;
       w += (int64_t)gridDim.x * kThreads) {
    const int64_t i = w / groups;
    const int j = (int)(w - i * groups) * V;
    int64_t c[V];
    Cols<V>::load(idx, i * g + j, n, c);
    float* o = out + i * f * g + j;
    for (int r0 = 0; r0 < f; r0 += kRows) {
      float v[kRows][V];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (r0 + k < f) {
          const float* row = table + (int64_t)(r0 + k) * n;
#pragma unroll
          for (int q = 0; q < V; ++q) v[k][q] = __ldcg(row + c[q]);
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (r0 + k < f) Cols<V>::store(o + (int64_t)(r0 + k) * g, v[k]);
      }
    }
  }
}

}  // namespace

extern "C" int gsplat_probe_coldma(const float* table, const int32_t* idx,
                                   float* out, int64_t n, int f, int64_t b,
                                   int g, void* stream) {
  if (b > 0 && g > 0 && f > 0) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const bool vec = g % 4 == 0 && (uintptr_t)idx % 16 == 0 &&
                     (uintptr_t)out % 16 == 0;
    const int groups = vec ? g / 4 : g;
    const int64_t items = b * groups;
    const int64_t need = (items + kThreads - 1) / kThreads;
    const int64_t most = (int64_t)(sms > 0 ? sms : 1) * kCtasPerSm;
    const unsigned ctas = (unsigned)(need < most ? need : most);
    if (vec) {
      coldma_kernel<4><<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
          table, idx, out, n, f, g, groups, items);
    } else {
      coldma_kernel<1><<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
          table, idx, out, n, f, g, groups, items);
    }
  }
  return (int)cudaGetLastError();
}
