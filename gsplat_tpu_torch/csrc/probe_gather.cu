// P3: the lane-gather probe, take_along_axis from a table in fast memory.
//
// Replaces the TPU kernel `k` of scripts/micro_kernel_costs.py::bench_gather
// (pallas_call at :164): out[r][c] = tab[r][idx[r][c]] for tab (R, C)
// float32 and idx (R, C) int32, which on the TPU asked whether Mosaic can
// gather along lanes from VMEM at all. Here the question is answered by
// construction: one CTA stages the whole table in shared memory (8 x 512
// float32 = 16 KB at the script's shape) and every thread reads the entries
// it needs from there. An entry outside [0, C) gives NaN instead of a read
// past the row (the plain version raises there).
//
// What bounds it on an H100: the launch. It moves 3 x 16 KB = 49,152 bytes
// (table and indices read, output written), 0.015 us at 3.35 TB/s, and does
// no arithmetic; a kernel launch alone takes some microseconds. Design: one
// CTA of 512 threads, coalesced loads of the table into shared memory, one
// __syncthreads, then one coalesced index load, one shared read and one
// coalesced store per element. It copies values and is bit-exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ tab, const int32_t* __restrict__ idx,
              float* __restrict__ out, int rows, int cols) {
  extern __shared__ float s[];
  const int n = rows * cols;
  for (int i = threadIdx.x; i < n; i += kThreads) s[i] = tab[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int j = idx[i];
    const int row = i / cols;
    out[i] = (unsigned)j < (unsigned)cols ? s[row * cols + j]
                                          : __int_as_float(0x7fc00000);
  }
}

}  // namespace

extern "C" int gsplat_probe_gather(const float* tab, const int32_t* idx,
                                   float* out, int rows, int cols,
                                   void* stream) {
  if (rows > 0 && cols > 0) {
    const size_t smem = (size_t)rows * cols * sizeof(float);
    gather_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(tab, idx, out,
                                                               rows, cols);
  }
  return (int)cudaGetLastError();
}
