// The reverse segmented scan shared by K4 (segsum.cu, float32 rows) and K5
// (segsum_packed.cu, bf16 pairs): one kernel template over a lane codec.
//
// It computes, for sorted run ids rows (M,) and a stream of M positions
// that each hold E float32 values,
//   out[e, j] = sum_{k >= j, rows[k] == rows[j]} x[e, k],
// every run of at most `depth` slots summed whole. The one longer run the
// pipeline makes is its invalid-slot tail, whose values are zero: its sums
// are zero however far they reach.
//
// A codec says how a position's E values are stored:
//   struct Codec {
//     using Word = ...;            // the element type of x and out
//     static constexpr int E = ...;  // float32 values per position
//     // v[0..E) from position pos of the (rows, m) array x
//     static __device__ void load(const Word* x, int64_t m, int64_t pos,
//                                 float* v);
//     static __device__ void store(Word* out, int64_t m, int64_t pos,
//                                  const float* v);
//   };
// Every sum below is a __fadd_rn of one value e with another value e, in
// an order fixed by the run ids alone; the codec only converts.
//
// The design, for a card on which blocks run in no order and nothing
// carries from one to the next. A block of 8 warps owns a chunk of 2048
// consecutive positions and walks it from the right in rounds of 256,
// warp w holding positions 32 w .. 32 w + 31 of the round, one per lane
// (the loads and stores coalesce):
//   - within a warp, a Hillis-Steele suffix scan by shuffles, five steps,
//     each adding the lane 2^i to the right where it holds the same run id
//     (ids are sorted, so equal ids are one contiguous run);
//   - across the round's warps, each warp's head sums go to shared memory,
//     and a warp adds to its last run's lanes the heads of the warps to its
//     right that continue that run, in warp order;
//   - across rounds, the running carry: the full sum at the first position
//     of the round to the right, added where the run id matches.
// What crosses blocks: only the run that holds the chunk's last position
// and goes on into the next chunk. The block reads that run's head in the
// next chunk itself (at most depth - 1 slots, since a run is at most depth
// long) and sums it as its first carry: no block waits for another, and
// there are no atomics. So every output is formed by the same additions in
// the same order whatever order the blocks run in, and a relaunch on the
// same inputs gives the same bits. The stream is read once, plus those
// boundary heads (a whole next chunk only inside a run longer than a chunk:
// the invalid tail, and the jumbo splats' runs at depth 2048).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gsplat {
namespace segscan {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRounds = 8;
constexpr int kChunk = kThreads * kRounds;  // positions per block
constexpr int kNoRun = -1;      // carry id when nothing carries
constexpr int kPastEnd = -2;    // run id of a lane past the stream

template <class Codec>
__global__ void __launch_bounds__(kThreads)
segscan_kernel(const typename Codec::Word* __restrict__ x,
               const int32_t* __restrict__ rows, int64_t m, int depth,
               typename Codec::Word* __restrict__ out) {
  constexpr int E = Codec::E;
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
        float t[E];
        Codec::load(x, m, pos, t);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = __fadd_rn(acc[e], t[e]);
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
    if (valid) {
      Codec::load(x, m, pos, v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = 0.f;
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
    if (valid) Codec::store(out, m, pos, v);

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

// Launch the scan with Codec<n> for 1 <= n <= kMaxN, or return
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch.
template <template <int> class Codec, int kMaxN, int N = 1>
cudaError_t launch(int n, const typename Codec<1>::Word* x,
                   const int32_t* rows, int64_t m, int depth,
                   typename Codec<1>::Word* out, cudaStream_t stream) {
  if constexpr (N > kMaxN) {
    return cudaErrorInvalidValue;
  } else {
    if (n != N)
      return launch<Codec, kMaxN, N + 1>(n, x, rows, m, depth, out, stream);
    if (m > 0) {
      const unsigned blocks = (unsigned)((m + kChunk - 1) / kChunk);
      segscan_kernel<Codec<N>><<<blocks, kThreads, 0, stream>>>(
          x, rows, m, depth, out);
    }
    return cudaGetLastError();
  }
}

}  // namespace segscan
}  // namespace gsplat
