// K5: segmented suffix sum over the gid-major gradient stream of bf16 pairs.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/segsum.py::_kernel_packed.
// It is K4 (segsum.cu) over (P, M) int32 lanes that each hold two bf16
// values in the layout of gsplat_tpu_torch/ops/bf16_pairs.py (row 2i in the
// low 16 bits, row 2i+1 in the high 16 bits):
//   out[p, j] = pack(rne(sum_k lo(x[p, k])), rne(sum_k hi(x[p, k]))),
//   k >= j, rows[k] == rows[j],
// with both halves summed in float32 and rounded back to bf16 to nearest
// even once (__float2bfloat16_rn, equal to the TPU kernel's _rne_bf16_bits
// for finite values). Runs are at most depth slots long (depth: kmax
// rounded up to a power of two, the reach of the plain version's doubling,
// ops/cuda/segsum.py), and the kernel sums each such run whole, as the
// doubling does. The one longer run is the pipeline's invalid-slot tail,
// whose values are zero: its sums are zero however far they reach.
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
// element. Design: a reverse segmented scan in linear time. A block of 8
// warps owns a chunk of 2048 consecutive positions and walks it from the
// right in rounds of 256, warp w holding positions 32 w .. 32 w + 31 of the
// round, one per lane (the loads and stores coalesce):
//   - within a warp, a Hillis-Steele suffix scan by shuffles, five steps,
//     each adding the lane 2^i to the right where it holds the same run id
//     (ids are sorted, so equal ids are one contiguous run);
//   - across the round's warps, each warp's head sums go to shared memory,
//     and a warp adds to its last run's lanes the heads of the warps to its
//     right that continue that run, in warp order;
//   - across rounds, the running carry: the full sum at the first position
//     of the round to the right, added where the run id matches.
// The chunk's first carry is the head of the next chunk's part of the run
// that crosses the boundary, which the block reads itself (at most depth - 1
// slots, since a run is at most depth long): no block waits for another,
// and no atomics. Every sum is formed in an order fixed by the data alone,
// so a relaunch gives the same bits. The stream is read once, plus the
// boundary runs (the whole next chunk only inside a run longer than a
// chunk: the tail and the jumbo splats' runs at depth 2048).

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"

namespace {

using gsplat::hi_half;
using gsplat::lo_half;
using gsplat::pack_pair;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRounds = 8;
constexpr int kChunk = kThreads * kRounds;  // positions per block
constexpr int kMaxPairs = 8;
constexpr int kNoRun = -1;      // carry id when nothing carries
constexpr int kPastEnd = -2;    // run id of a lane past the stream

template <int P>
__global__ void __launch_bounds__(kThreads)
segsum_packed_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ rows, int64_t m, int depth,
                     int32_t* __restrict__ out) {
  constexpr int E = 2 * P;  // float32 halves per position
  __shared__ float s_part[kWarps][E];
  __shared__ float s_head[2][kWarps][E];
  __shared__ int s_key[2][kWarps];
  __shared__ int s_tail[2];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t c0 = (int64_t)blockIdx.x * kChunk;
  const int64_t c1 = c0 + kChunk < m ? c0 + kChunk : m;

  // The carry into the chunk: the sum over positions >= c1 of the run that
  // holds c1 - 1 (its matching slots are a prefix of the rest).
  float carry[E];
#pragma unroll
  for (int e = 0; e < E; ++e) carry[e] = 0.f;
  int carry_rid = kNoRun;
  if (c1 < m && rows[c1] == rows[c1 - 1]) {  // the same for the whole block
    const int run = rows[c1 - 1];
    const int64_t lim = c1 + depth - 1 < m ? c1 + depth - 1 : m;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int64_t s = c1; s < lim; s += kThreads) {
      const int64_t pos = s + threadIdx.x;
      const bool match = pos < lim && rows[pos] == run;
      if (match) {
#pragma unroll
        for (int r = 0; r < P; ++r) {
          const uint32_t u = (uint32_t)x[r * m + pos];
          acc[2 * r] = __fadd_rn(acc[2 * r], lo_half(u));
          acc[2 * r + 1] = __fadd_rn(acc[2 * r + 1], hi_half(u));
        }
      }
      if (__syncthreads_count(match) < kThreads) break;
    }
    // A butterfly gives every lane the same sum; then the warps in order.
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float v = acc[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
      if (lane == 0) s_part[warp][e] = v;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float v = s_part[0][e];
      for (int w = 1; w < kWarps; ++w) v = __fadd_rn(v, s_part[w][e]);
      carry[e] = v;
    }
    carry_rid = run;
  }

  for (int q = kRounds - 1; q >= 0; --q) {
    const int64_t base = c0 + (int64_t)q * kThreads;
    if (base >= c1) continue;  // the last chunk's empty rounds
    const int64_t pos = base + threadIdx.x;
    const bool valid = pos < c1;
    const int key = valid ? rows[pos] : kPastEnd;
    float v[E];
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const uint32_t u = valid ? (uint32_t)x[r * m + pos] : 0u;
      v[2 * r] = lo_half(u);
      v[2 * r + 1] = hi_half(u);
    }

    // The warp's suffix scan: lane l ends with its run's sum over lanes
    // l .. 31.
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool same =
          __shfl_down_sync(kFull, key, d) == key && lane + d < 32;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float t = __shfl_down_sync(kFull, v[e], d);
        if (same) v[e] = __fadd_rn(v[e], t);
      }
    }

    const int buf = q & 1;
    if (lane == 0) {
      s_key[buf][warp] = key;
#pragma unroll
      for (int e = 0; e < E; ++e) s_head[buf][warp][e] = v[e];
    }
    if (threadIdx.x == kThreads - 1) s_tail[buf] = key;
    __syncthreads();

    // The sum, right of warp w's end, of the run `run`: the heads of the
    // warps that continue it, then the carry if it spans the round.
    const int tail = s_tail[buf];
    auto beyond = [&](int w, int run, float* acc) {
      int w2 = w + 1;
      for (; w2 < kWarps && s_key[buf][w2] == run; ++w2) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[e] = __fadd_rn(acc[e], s_head[buf][w2][e]);
      }
      if (w2 == kWarps && tail == run && carry_rid == run) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = __fadd_rn(acc[e], carry[e]);
      }
    };

    const int last = __shfl_sync(kFull, key, 31);
    float add[E];
#pragma unroll
    for (int e = 0; e < E; ++e) add[e] = 0.f;
    beyond(warp, last, add);
    if (key == last) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = __fadd_rn(v[e], add[e]);
    }
    if (valid) {
#pragma unroll
      for (int r = 0; r < P; ++r)
        out[r * m + pos] = pack_pair(v[2 * r], v[2 * r + 1]);
    }

    // The carry into the round to the left: the full sum at this round's
    // first position, formed as warp 0 formed it there.
    const int first = s_key[buf][0];
    float next[E];
#pragma unroll
    for (int e = 0; e < E; ++e) next[e] = 0.f;
    beyond(0, first, next);
#pragma unroll
    for (int e = 0; e < E; ++e) carry[e] = __fadd_rn(s_head[buf][0][e], next[e]);
    carry_rid = first;
  }
}

}  // namespace

extern "C" int gsplat_segsum_packed(const int32_t* x, const int32_t* rows,
                                    int64_t m, int p, int depth, int32_t* out,
                                    void* stream) {
  if (p < 1 || p > kMaxPairs) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    const unsigned blocks = (unsigned)((m + kChunk - 1) / kChunk);
    cudaStream_t s = (cudaStream_t)stream;
    switch (p) {
#define GSPLAT_SEGSUM_P(N)                                                  \
  case N:                                                                   \
    segsum_packed_kernel<N><<<blocks, kThreads, 0, s>>>(x, rows, m, depth,  \
                                                        out);               \
    break;
      GSPLAT_SEGSUM_P(1) GSPLAT_SEGSUM_P(2) GSPLAT_SEGSUM_P(3)
      GSPLAT_SEGSUM_P(4) GSPLAT_SEGSUM_P(5) GSPLAT_SEGSUM_P(6)
      GSPLAT_SEGSUM_P(7) GSPLAT_SEGSUM_P(8)
#undef GSPLAT_SEGSUM_P
    }
  }
  return (int)cudaGetLastError();
}
