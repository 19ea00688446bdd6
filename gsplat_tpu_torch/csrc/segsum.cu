// K4: segmented suffix sum over the gid-major float32 gradient stream.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/segsum.py::_kernel. After
// the gather backward sorts the per-slot gradients by gid << kbits | k, each
// Gaussian's slots form one contiguous run; this kernel computes
//   out[f, j] = sum_{k >= j, rows[k] == rows[j]} x[f, k]
// for the (F, M) float32 stream, so every run's total sits at its first
// slot. It is the float32 instantiation of the reverse segmented scan in
// segscan.cuh, which K5 (segsum_packed.cu) shares: E = F values per
// position, loaded and stored as float. F is 1 to kMaxRows (the exact step
// uses 9, binning.NUM_FEATURES); any other F returns cudaErrorInvalidValue.
// The output is (F, M): the TPU kernel's padding of M to its block size has
// no counterpart.
//
// Contract (ops/cuda/segsum.py): every run of at most depth slots (kmax
// rounded up to a power of two, the reach of the plain version's doubling)
// is summed whole, as the doubling sums it. The one longer run is the
// pipeline's invalid-slot tail, whose values are zero: its sums are zero
// however far they reach.
//
// What bounds it on an H100: bytes. It must read the stream (F M 4 bytes)
// and the run ids (M 4 bytes) and write (F M 4 bytes): (2 F M + M) x 4 =
// 311 MB, about 0.093 ms, at the bench shape (F = 9, M = 4.1M); the adds
// are one per element. The design (segscan.cuh): 2048 positions per block,
// walked from the right in rounds of 256 with a warp shuffle scan, the
// warps' heads added in warp order from shared memory and a carry from
// round to round, so the stream is read once, in linear time whatever the
// run lengths (the walk it replaced, one thread per position re-summing its
// run to the right, read L^2 / 2 values per run of L and walked the whole
// depth at every position of the invalid tail). The one run that crosses
// into the next chunk is summed from that chunk's head by the block itself,
// so no block waits for another, there are no atomics, and a relaunch gives
// the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segscan.cuh"

namespace {

constexpr int kMaxRows = 16;

// F float32 rows, one value of each per position.
template <int F>
struct F32Rows {
  using Word = float;
  static constexpr int E = F;
  static __device__ __forceinline__ void load(const float* __restrict__ x,
                                              int64_t m, int64_t pos,
                                              float* v) {
#pragma unroll
    for (int r = 0; r < F; ++r) v[r] = x[r * m + pos];
  }
  static __device__ __forceinline__ void store(float* __restrict__ out,
                                               int64_t m, int64_t pos,
                                               const float* v) {
#pragma unroll
    for (int r = 0; r < F; ++r) out[r * m + pos] = v[r];
  }
};

}  // namespace

extern "C" int gsplat_segsum(const float* x, const int32_t* rows, int64_t m,
                             int f, int depth, float* out, void* stream) {
  return (int)gsplat::segscan::launch<F32Rows, kMaxRows>(
      f, x, rows, m, depth, out, (cudaStream_t)stream);
}
