// K5: segmented suffix sum over the gid-major gradient stream of bf16 pairs.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/segsum.py::_kernel_packed.
// It is K4 (segsum.cu) over (P, M) int32 lanes that each hold two bf16
// values in the layout of gsplat_tpu_torch/ops/bf16_pairs.py (row 2i in the
// low 16 bits, row 2i+1 in the high 16 bits):
//   out[p, j] = pack(rne(sum_k lo(x[p, k])), rne(sum_k hi(x[p, k]))),
//   k >= j, k < j + depth, rows[k] == rows[j],
// with both halves summed in float32 and rounded back to bf16 to nearest
// even (__float2bfloat16_rn, equal to the TPU kernel's _rne_bf16_bits for
// finite values). depth is kmax rounded up to a power of two, the reach of
// the plain version's doubling (ops/cuda/segsum.py).
//
// Denormals: a pair whose high half is zero (the opacity row, paired with a
// zero pad row) is the bit pattern of an f32 denormal. Words are therefore
// read and written as integers only; the floats are the unpacked halves
// u << 16 and u & 0xFFFF0000, and the build flushes no denormal
// (ops/cuda/_build.py uses neither --use_fast_math nor -ftz=true).
//
// What bounds it on an H100: bytes. It must read the pairs (P M 4 bytes)
// and the run ids (M 4 bytes) and write the pairs (P M 4 bytes): 180 MB,
// about 0.054 ms, at the bench shape (P = 5, M = 4.1M); the adds are two per
// element. Design: K4's, one thread per position j, which walks right while
// the run id matches, at most depth steps, and sums both halves of each of
// the P rows over that span; neighbouring threads read neighbouring
// addresses, so the loads coalesce and the re-reads of a run hit in cache.
// No carry crosses blocks (runs are at most kmax long), unlike the TPU
// kernel's right-to-left carry. The cost is the sum over runs of L^2 / 2
// reads: small at kmax 64, but with the jumbo tiers (kmax 2048) the long
// runs of big splats and the invalid tail, one run in which every position
// walks the full depth, dominate it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"

namespace {

using gsplat::hi_half;
using gsplat::lo_half;
using gsplat::pack_pair;

__global__ void segsum_packed_kernel(const int32_t* __restrict__ x,
                                     const int32_t* __restrict__ rows,
                                     int64_t m, int p, int depth,
                                     int32_t* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int32_t row = rows[j];
  const int64_t last = j + depth < m ? j + depth : m;
  int64_t k_end = j + 1;
  while (k_end < last && rows[k_end] == row) ++k_end;
  for (int r = 0; r < p; ++r) {
    const uint32_t* xr = reinterpret_cast<const uint32_t*>(x + r * m);
    float lo = 0.f, hi = 0.f;
    for (int64_t k = j; k < k_end; ++k) {
      const uint32_t u = xr[k];
      lo = __fadd_rn(lo, lo_half(u));
      hi = __fadd_rn(hi, hi_half(u));
    }
    out[r * m + j] = pack_pair(lo, hi);
  }
}

}  // namespace

extern "C" int gsplat_segsum_packed(const int32_t* x, const int32_t* rows,
                                    int64_t m, int p, int depth, int32_t* out,
                                    void* stream) {
  const int threads = 256;
  if (m > 0) {
    const int64_t blocks = (m + threads - 1) / threads;
    segsum_packed_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(x, rows, m, p, depth, out);
  }
  return (int)cudaGetLastError();
}
