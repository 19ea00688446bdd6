// K5: segmented suffix sum over the gid-major gradient stream of bf16 pairs.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/segsum.py::_kernel_packed.
// It is the bf16-pair instantiation of the reverse segmented scan in
// segscan.cuh, which K4 (segsum.cu) shares: (P, M) int32 lanes that each
// hold two bf16 values in the layout of gsplat_tpu_torch/ops/bf16_pairs.py
// (row 2i in the low 16 bits, row 2i+1 in the high 16 bits), E = 2P
// float32 values per position:
//   out[p, j] = pack(rne(sum_k lo(x[p, k])), rne(sum_k hi(x[p, k]))),
//   k >= j, rows[k] == rows[j],
// with both halves summed in float32 and rounded back to bf16 to nearest
// even once (__float2bfloat16_rn, equal to the TPU kernel's _rne_bf16_bits
// for finite values). P is 1 to kMaxPairs; any other P returns
// cudaErrorInvalidValue.
//
// Contract (ops/cuda/segsum.py): every run of at most depth slots (kmax
// rounded up to a power of two, the reach of the plain version's doubling)
// is summed whole, as the doubling sums it. The one longer run is the
// pipeline's invalid-slot tail, whose values are zero: its sums are zero
// however far they reach.
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
// int32 lane. The design (segscan.cuh): 2048 positions per block, walked
// from the right in rounds of 256 with a warp shuffle scan, the warps'
// heads added in warp order from shared memory and a carry from round to
// round; the one run that crosses into the next chunk is summed from that
// chunk's head by the block itself, so no block waits for another and a
// relaunch gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"
#include "segscan.cuh"

namespace {

constexpr int kMaxPairs = 8;

// P int32 words per position, each two bf16 halves.
template <int P>
struct Bf16Pairs {
  using Word = int32_t;
  static constexpr int E = 2 * P;
  static __device__ __forceinline__ void load(const int32_t* __restrict__ x,
                                              int64_t m, int64_t pos,
                                              float* v) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const uint32_t u = (uint32_t)x[r * m + pos];
      v[2 * r] = gsplat::lo_half(u);
      v[2 * r + 1] = gsplat::hi_half(u);
    }
  }
  static __device__ __forceinline__ void store(int32_t* __restrict__ out,
                                               int64_t m, int64_t pos,
                                               const float* v) {
#pragma unroll
    for (int r = 0; r < P; ++r)
      out[r * m + pos] = gsplat::pack_pair(v[2 * r], v[2 * r + 1]);
  }
};

}  // namespace

extern "C" int gsplat_segsum_packed(const int32_t* x, const int32_t* rows,
                                    int64_t m, int p, int depth, int32_t* out,
                                    void* stream) {
  return (int)gsplat::segscan::launch<Bf16Pairs, kMaxPairs>(
      p, x, rows, m, depth, out, (cudaStream_t)stream);
}
