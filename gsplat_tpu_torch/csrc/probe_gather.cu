// P3: the lane-gather probe, take_along_axis from a table in fast memory.
//
// Replaces the TPU kernel `k` of scripts/micro_kernel_costs.py::bench_gather
// (pallas_call at :164): out[r][c] = tab[r][idx[r][c]] for tab (R, C)
// float32 and idx (R, C) int32, which on the TPU asked whether Mosaic can
// gather along lanes from VMEM at all. Indices follow the reference's
// `jnp.take_along_axis`: an index j in [-C, 0) reads tab[r][j + C], one in
// [0, C) reads tab[r][j], and any other gives NaN (the quiet NaN
// 0x7fc00000). The plain version (ops/cuda/probes.py) applies the same rule.
//
// What bounds it on an H100: the launch. It moves 3 x 16 KB = 49,152 bytes
// at the script's (8, 512) (table and indices read, output written), 0.015
// us at 3.35 TB/s, and does no arithmetic; a launch alone takes some
// microseconds, and what the kernel adds on top is its chain of dependent
// memory round trips. Design: one CTA per row (R CTAs on R SMs), so each
// CTA stages only its own row in shared memory. Every thread issues all of
// its loads -- its pieces of the table row and of the index row, 16 bytes
// each where C % 4 == 0 -- before it stores anything, so a CTA waits for
// one round trip to device memory, then the CTA's only __syncthreads; after
// it each element costs one shared read and its share of a coalesced
// (16-byte where C % 4 == 0) store. No division: a thread's units are
// threadIdx.x + k * blockDim.x of its own row. It copies values and is
// bit-exact.
//
// Limits: a row of at most kMaxCols = 12,288 floats (48 KB of shared
// memory, no opt-in), which the launcher refuses above with
// cudaErrorInvalidValue; at most 1024 threads of kMaxValues / V units each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCols = 12 * 1024;
// Values per thread that the loads hold in registers across the barrier:
// kMaxCols over kMaxThreads.
constexpr int kMaxValues = kMaxCols / kMaxThreads;

__device__ __forceinline__ float pick(const float* s, int j, int cols) {
  // j in [-cols, 0) wraps once; no overflow, since cols > 0 and j + cols is
  // only formed for j < 0.
  const int w = j < 0 ? j + cols : j;
  return (unsigned)w < (unsigned)cols ? s[w] : __int_as_float(0x7fc00000);
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using F = float;
  using I = int32_t;
  __device__ static F gather(const float* s, I j, int cols) {
    return pick(s, j, cols);
  }
  __device__ static void put(float* s, int u, F v) { s[u] = v; }
};
template <>
struct Vec<4> {
  using F = float4;
  using I = int4;
  __device__ static F gather(const float* s, I j, int cols) {
    return make_float4(pick(s, j.x, cols), pick(s, j.y, cols),
                       pick(s, j.z, cols), pick(s, j.w, cols));
  }
  __device__ static void put(float* s, int u, F v) {
    reinterpret_cast<float4*>(s)[u] = v;
  }
};

// One CTA per row; V values per unit (V = 4: float4 / int4 loads and
// stores), `units` = cols / V units per row, at most kMaxValues / V a thread.
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
gather_kernel(const float* __restrict__ tab, const int32_t* __restrict__ idx,
              float* __restrict__ out, int cols) {
  using T = Vec<V>;
  constexpr int kUnits = kMaxValues / V;
  extern __shared__ __align__(16) float s[];
  const int units = cols / V;
  const int64_t row = (int64_t)blockIdx.x * cols;
  const auto* t = reinterpret_cast<const typename T::F*>(tab + row);
  const auto* x = reinterpret_cast<const typename T::I*>(idx + row);
  auto* o = reinterpret_cast<typename T::F*>(out + row);
  typename T::F v[kUnits];
  typename T::I j[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = threadIdx.x + k * blockDim.x;
    if (u < units) {
      v[k] = __ldg(t + u);
      j[k] = __ldg(x + u);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = threadIdx.x + k * blockDim.x;
    if (u < units) T::put(s, u, v[k]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = threadIdx.x + k * blockDim.x;
    if (u < units) o[u] = T::gather(s, j[k], cols);
  }
}

}  // namespace

extern "C" int gsplat_probe_gather(const float* tab, const int32_t* idx,
                                   float* out, int rows, int cols,
                                   void* stream) {
  if (cols > kMaxCols) return (int)cudaErrorInvalidValue;
  if (rows > 0 && cols > 0) {
    // 16-byte units where every row starts on a 16-byte boundary.
    const bool vec = cols % 4 == 0 && ((uintptr_t)tab | (uintptr_t)idx |
                                       (uintptr_t)out) % 16 == 0;
    const int units = vec ? cols / 4 : cols;
    const int threads = units < kMaxThreads ? (units + 31) / 32 * 32
                                            : kMaxThreads;
    const size_t smem = (size_t)cols * sizeof(float);
    if (vec) {
      gather_kernel<4><<<rows, threads, smem, (cudaStream_t)stream>>>(
          tab, idx, out, cols);
    } else {
      gather_kernel<1><<<rows, threads, smem, (cudaStream_t)stream>>>(
          tab, idx, out, cols);
    }
  }
  return (int)cudaGetLastError();
}
