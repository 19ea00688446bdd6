// K7: the backward of K6, the colour and C feature channels blended with one
// set of weights (Feature 3DGS, Zhou et al. 2024, arXiv:2312.03203).
//
// Per pixel, with g the colour's gradient, g_F the feature map's and g_T the
// final transmittance's, K2's suffix-sum identity holds over all 3 + C
// channels:
//   dw_i    = g . rgb_i + g_F . f_i                     (dL/dw of a pair)
//   b_total = g . colour + g_T T_final + g_F . F_final
//   da_i    = dw_i T_i - (b_total - sum_{j <= i} dw_j w_j) / (1 - alpha_i)
// and the geometry, opacity and colour gradients of a slot follow from da
// as in K2. The feature table's gradient of a slot is sum_p w_i(p) g_F(p)
// over the tile's pixels (w = 0 where a pixel does not apply it).
//
// Layout: a tile's pixels are walked once for all C channels. A pixel's
// g_F at C = 128 takes 512 B, a 32x32 tile's 512 KB: more than one SM
// holds. So a tile is a cluster of CTAs (Hopper's thread-block clusters) of
// 256 pixels each, a 32x32 tile 4 CTAs of 8 rows on 4 SMs, each holding its
// pixels' g_F for every channel of the pass in shared memory (128 KB at
// C = 128); a tile of at most 256 pixels is a cluster of one. Every CTA
// walks the tile's whole list in batches of 32 Gaussians, a pixel a lane
// (a warp an 8x4 block of pixels in tiles of 8, 16 and 32, else 32 pixels
// row-major), with K2's decisions (blend.cuh's pair_power, eval_pair and
// power floor), kWalk Gaussians a step: the slot terms of the step's
// Gaussians are summed across the warp in one halving exchange of 32
// values a lane. A batch's stream slots, ids and features are loaded into
// registers while the batch before it is worked on.
//
// The channel work. Where the walk reaches them, pixels apply most
// Gaussians of a batch (on the feature cell's view, 31 of a warp's 32
// lanes, where any applies), so the channel work of a batch is two dense
// products on the CUDA cores, each thread a register tile of 4 pixels x 8
// Gaussians or 8 Gaussians x 4 channels:
//   before the walk, D = g_F f^T (256 pixels x 32 Gaussians), the dots
//   g_F . f_i that the walk's dw needs;
//   after it, S = W^T g_F (32 Gaussians x C), the table sums, where W holds
//   the walk's weights w (written over D, pixel by pixel, as it goes).
// Each product is summed in a fixed order (S's pixel ranges added in
// order), so the CTA's sums are the same from run to run. Channels past the
// on-chip budget, kMaxChannels, are walked in passes of kMaxChannels in the
// same launch (da is linear in the channels' gradients; the colour goes
// with the first pass); the wrapper counts such a launch as "K7.chunked".
// A pass of at most 32 channels leaves room for two CTAs an SM.
//
// The combine: per batch each CTA sums its warps' slot partials in warp
// order; after a cluster barrier, CTA r of the cluster reads the slot sums
// of every CTA of the cluster through distributed shared memory, adds them
// in rank order for the slots j = r (mod cluster size), chains them into
// the stream features' gradients and writes them to `dgeo` (9, max_I)
// float32 (later passes add to them), which the wrapper zero-fills; a slot
// is written by the same thread in every pass, so `dgeo` is the same bit
// for bit from run to run. The table sums of the cluster's CTAs are added
// in rank order the same way, a share of the (slot, channel) entries a
// CTA, and go onto each Gaussian's row of `dfeat` (N, C) float32 by one
// atomic add per (slot, channel) with a nonzero sum, one per tile: the rows
// of a Gaussian that lies in several tiles are summed in the order the card
// runs the tiles, not bit for bit the same from run to run. The sums read
// across the cluster are double buffered by batch parity, so one cluster
// barrier a batch suffices; a CTA whose pixels are all done still arrives
// at each barrier, with zeros, and the cluster leaves the walk when every
// CTA's pixels are done.
//
// What bounds it: on the feature cell's view (an H100), in this order, the
// two products (about 1.3 ms each at about 55% of the FP32 rate: 2 x 2 C
// operations per (pixel, Gaussian) pair of every batch the walk enters,
// applied or not, 128 FMAs to 12 shared-memory loads), the slot terms and
// their exchange (1.1 ms), the reads of g_F and F_final (1.1 ms for 2 GB at
// 1080p and C = 128: one CTA an SM, so nothing hides them), and the walk's
// decisions, barriers and combine. Every product is an FP32 FMA on the
// CUDA cores; the operations the benchmark counts, 4 C per applied pair,
// bound it at 1.15 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace gsplat;

constexpr int kPix = 256;  // pixels a CTA, a lane each
constexpr int kWarps = kPix / 32;
constexpr int kMaxCluster = 4;  // CTAs of a 32x32 tile
constexpr int kBatch = 32;
constexpr int kWalk = 4;  // Gaussians a step of the walk: 8 terms each
constexpr int kMaxChannels = 128;
constexpr int kSums = 9;
enum { S_DX, S_DY, S_DXX, S_DXY, S_DYY, S_R, S_G, S_B, S_OP };

// A CTA's shared memory for a pass of KW channels: 221 KB at KW = 128,
// 133 KB at 64, 89 KB at 32. Rows of g_F and of dw are 16-byte chunks
// stored at chunk ^ (row & 7) (`swz`), so that a warp's 16-byte loads of
// one chunk of 8 consecutive rows, or of every chunk of one row, meet no
// bank twice.
template <int KW>
struct Smem {
  float gf[kPix][KW];            // the pass's g_F, a row a pixel
  float f[kBatch][KW];           // the batch's features
  float dw[kPix][kBatch];        // the dots g_F . f_j, then the weights w_j
  float fsum[2][kBatch][KW];     // the CTA's table sums, by parity
  float part[kWarps][kBatch][kSums];
  float csum[2][kBatch][kSums];  // the CTA's slot sums, by parity
  Staged batch[kBatch];
  int32_t gid[kBatch];           // the batch's Gaussian ids
  int done[2];                   // every pixel of the CTA done
};

// The word of column c of a swizzled row `row`.
__device__ __forceinline__ int swz(int row, int c) {
  return ((c >> 2) ^ (row & 7)) << 2 | (c & 3);
}

// blend.cuh's halving_sum (lane l gets the sum of value l / (32 / N)), its
// steps template instances, so that the compiler unrolls it at any N.
template <int N, int OFF = 16>
__device__ __forceinline__ float exchange_sum(float (&v)[N], int lane) {
  constexpr int kHalf = N * OFF / 32;  // values kept at this step
  if constexpr (kHalf > 0) {
    const bool hi = lane & OFF;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float keep = hi ? v[i + kHalf] : v[i];
      const float send = hi ? v[i] : v[i + kHalf];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
  }
  if constexpr (OFF > 1)
    return exchange_sum<N, OFF / 2>(v, lane);
  else
    return v[0];
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 acc) {
  return make_float4(fmaf(a, b.x, acc.x), fmaf(a, b.y, acc.y),
                     fmaf(a, b.z, acc.z), fmaf(a, b.w, acc.w));
}

// Channels c .. c + 3 of a row of C floats at p (p points at channel c),
// zero past C or where !ok; VEC: one 16-byte load (C a multiple of 4).
template <bool VEC>
__device__ __forceinline__ float4 load_chunk(const float* __restrict__ p,
                                             int c, int channels, bool ok) {
  if (VEC)
    return ok && c < channels ? __ldg(reinterpret_cast<const float4*>(p))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = ok && c + i < channels ? __ldg(p + i) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Pixel i of CTA `rank` of a ts x ts tile: (x, y) in the tile, and whether
// it lies in the tile. In tiles of 8, 16 and 32 a warp takes an 8x4 block
// (a CTA of a 32x32 tile its 8 rows), so that a Gaussian meets fewer warps;
// other sizes go row-major, 256 pixels a CTA.
__device__ __forceinline__ bool tile_pixel(int rank, int i, int ts, int& x,
                                           int& y) {
  if (ts == 8 || ts == 16 || ts == 32) {
    const int per_row = ts >> 3;  // 8x4 blocks a row of blocks
    const int w = i >> 5, l = i & 31;
    x = (w % per_row) * 8 + (l & 7);
    y = rank * (kPix / ts) + (w / per_row) * 4 + (l >> 3);
    return y < ts;
  }
  const int pix = rank * kPix + i;
  x = pix % ts;
  y = pix / ts;
  return pix < ts * ts;
}

// The pass's channels of g_F of the warp's 32 pixels (rows warp * 32 ..)
// into gf, a row `KW / 4` lanes of 16-byte chunks, up to 16 chunks a lane
// in flight; returns the lane's pixel's g_F . F_final over the pass's
// channels, each row's sum taken across its lanes in a butterfly.
template <bool VEC, int KW>
__device__ __forceinline__ float load_pass(float (*gf)[KW],
                                           const float* __restrict__ g_feat,
                                           const float* __restrict__ f_final,
                                           int channels, int c0, int rank,
                                           int ts, int tx0, int ty0,
                                           int width, int height) {
  constexpr int kChunks = KW / 4;
  constexpr int kGroup = kChunks < 16 ? kChunks : 16;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float bt = 0.f;
  for (int step0 = 0; step0 < kChunks; step0 += kGroup) {
    float4 g[kGroup], f[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int e = lane + 32 * (step0 + u);
      const int row = warp * 32 + e / kChunks, c = c0 + 4 * (e % kChunks);
      int x, y;
      const bool ok = tile_pixel(rank, row, ts, x, y) && tx0 + x < width &&
                      ty0 + y < height;
      const int64_t at = ((int64_t)(ty0 + y) * width + tx0 + x) * channels + c;
      g[u] = load_chunk<VEC>(g_feat + at, c, channels, ok);
      f[u] = load_chunk<VEC>(f_final + at, c, channels, ok);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int step = step0 + u, e = lane + 32 * step;
      const int row = warp * 32 + e / kChunks, k = e % kChunks;
      *reinterpret_cast<float4*>(&gf[row][swz(row, 4 * k)]) = g[u];
      float s = fmaf(g[u].w, f[u].w,
                     fmaf(g[u].z, f[u].z, fmaf(g[u].y, f[u].y,
                                               g[u].x * f[u].x)));
#pragma unroll
      for (int off = kChunks / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(full, s, off);
      const float row_sum = __shfl_sync(full, s, (lane * kChunks) & 31);
      if (((lane * kChunks) >> 5) == step) bt = row_sum;
    }
  }
  return bt;
}

template <int FMT, int KW>
__global__ void __launch_bounds__(kPix, KW == 32 ? 2 : 1)
feat_bwd_kernel(const void* __restrict__ stream, int64_t max_i,
                const int32_t* __restrict__ ranges,
                const int32_t* __restrict__ gid,
                const float* __restrict__ feat, int channels,
                const float* __restrict__ g_color,
                const float* __restrict__ b_total,
                const float* __restrict__ g_feat,
                const float* __restrict__ f_final, int tile_offset,
                int tiles_x, int ts, int width, int height, BlendParams bp,
                Quant q, float* __restrict__ dgeo,
                float* __restrict__ dfeat) {
  constexpr int kChunks = KW / 4;        // 16-byte chunks a row
  constexpr int kSplits = 64 / kChunks;  // pixel ranges of S's threads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<KW>& sm = *reinterpret_cast<Smem<KW>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned full = 0xffffffffu;
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  Smem<KW>* peer[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    peer[r] = cluster.map_shared_rank(&sm, r < cs ? r : 0);
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  const int t = blockIdx.x / cs;
  const int p = ts * ts;
  const int gt = t + tile_offset;
  const int tx0 = (gt % tiles_x) * ts;
  const int ty0 = (gt / tiles_x) * ts;
  const float ox = (float)tx0;
  const float oy = (float)ty0;
  const int start = ranges[t];
  const int end = ranges[t + 1];
  const int passes = (channels + KW - 1) / KW;
  int x, y;
  const bool in_tile = tile_pixel(rank, lin, ts, x, y);
  const int pix = y * ts + x;
  const float xr = (float)x, yr = (float)y;
  // D's threads: pixels dp + 64 u, Gaussians 8 dj + v; S's: Gaussians
  // 8 sj + v, channels 4 sc .. 4 sc + 3, over pixel range `split`.
  const int dp = lin & 63, dj = lin >> 6;
  const int sc = lin % kChunks, sj = (lin / kChunks) & 3;
  const int split = lin / (4 * kChunks);
  int parity = 0;

  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = pass * KW;
    // A batch's staging is loaded into registers while the batch before it
    // is worked on: its slots' stream features and ids (a slot a thread),
    // then its feature chunks (kEach a thread, by the ids).
    constexpr int kEach = kBatch * kChunks / kPix;
    float nv[kFeatures];
    int32_t nid = 0, nrow[kEach];
    float4 nf[kEach];
    const auto load_ids = [&](int b, int nb) {
      if (lin < nb) {
        load_slot<FMT>(stream, max_i, (int64_t)b + lin, q, nv);
        nid = __ldg(gid + b + lin);
      }
#pragma unroll
      for (int u = 0; u < kEach; ++u) {
        const int j = (lin + kPix * u) / kChunks;
        nrow[u] = j < nb ? __ldg(gid + b + j) : 0;
      }
    };
    const auto load_features = [&](int nb) {
#pragma unroll
      for (int u = 0; u < kEach; ++u) {
        const int i = lin + kPix * u, j = i / kChunks;
        const int c = c0 + 4 * (i % kChunks);
        const float* row = feat + (int64_t)nrow[u] * channels + c;
        nf[u] = (channels & 3) == 0
                    ? load_chunk<true>(row, c, channels, j < nb)
                    : load_chunk<false>(row, c, channels, j < nb);
      }
    };
    if (start < end) {
      load_ids(start, min(kBatch, end - start));
      load_features(min(kBatch, end - start));
    }
    float g0 = 0.f, g1 = 0.f, g2 = 0.f, bt = 0.f;
    if (pass == 0 && in_tile) {
      const float* gc = g_color + (int64_t)t * 3 * p;
      g0 = gc[pix];
      g1 = gc[p + pix];
      g2 = gc[2 * p + pix];
      bt = b_total[(int64_t)t * p + pix];
    }
    // The warp's pixels' g_F into shared memory, and each pixel's
    // g_F . F_final.
    bt += (channels & 3) == 0
              ? load_pass<true, KW>(sm.gf, g_feat, f_final, channels, c0,
                                    rank, ts, tx0, ty0, width, height)
              : load_pass<false, KW>(sm.gf, g_feat, f_final, channels, c0,
                                     rank, ts, tx0, ty0, width, height);
    bool live = in_tile;
    float trans = 1.f, accum_b = 0.f;
    int done = !live;
    for (int b0 = start; b0 < end; b0 += kBatch) {
      const int n = min(kBatch, end - b0);
      const int nn = min(kBatch, end - b0 - kBatch);  // the next batch's
      __syncthreads();  // the last batch's local reads are done
      if (lin < n) {
        sm.batch[lin] = stage(nv, ox, oy, bp);
        sm.gid[lin] = nid;
      }
#pragma unroll
      for (int u = 0; u < kEach; ++u) {
        const int i = lin + kPix * u;
        *reinterpret_cast<float4*>(&sm.f[i / kChunks][4 * (i % kChunks)]) =
            nf[u];
      }
      {
        float4* part = reinterpret_cast<float4*>(&sm.part[warp][0][0]);
        for (int i = lane; i < kSums * kBatch / 4; i += 32)
          part[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
      if (nn > 0) load_ids(b0 + kBatch, nn);
      // D = g_F f^T: each thread 4 pixels x 8 Gaussians.
      if (8 * dj < n) {
        float acc[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
        }
#pragma unroll 4
        for (int k = 0; k < kChunks; ++k) {
          float4 g[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = dp + 64 * u;
            g[u] = *reinterpret_cast<const float4*>(&sm.gf[i][swz(i, 4 * k)]);
          }
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            const float4 f =
                *reinterpret_cast<const float4*>(&sm.f[8 * dj + v][4 * k]);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[u][v] = fmaf(g[u].w, f.w,
                               fmaf(g[u].z, f.z,
                                    fmaf(g[u].y, f.y,
                                         fmaf(g[u].x, f.x, acc[u][v]))));
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = dp + 64 * u;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float4*>(&sm.dw[i][swz(i, 8 * dj + 4 * h)]) =
                make_float4(acc[u][4 * h], acc[u][4 * h + 1],
                            acc[u][4 * h + 2], acc[u][4 * h + 3]);
        }
      }
      if (nn > 0) load_features(nn);
      bool took_part = __any_sync(full, !done);
      __syncthreads();
      // The walk, a pixel a lane, kWalk Gaussians at a time: dw's dot of
      // each pair in, its weight out (0 where the pixel does not apply the
      // Gaussian); the slot terms of the kWalk Gaussians summed across the
      // warp in one halving exchange.
      for (int j0 = 0; j0 < n; j0 += kWalk) {
        float w_out[kWalk];
#pragma unroll
        for (int u = 0; u < kWalk; ++u) w_out[u] = 0.f;
        if (took_part) {  // warp-uniform
          float v[kWalk * 8], v8[kWalk];
          bool any = false;
#pragma unroll
          for (int u = 0; u < kWalk; ++u) {
            v8[u] = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) v[8 * u + i] = 0.f;
            const int j = j0 + u;
            if (j < n) {  // warp-uniform
              const float dot = sm.dw[lin][swz(lin, j)];
              const float4 geo = sm.batch[j].geo;
              const float4 geo2 = sm.batch[j].geo2;
              const Column col = column_terms(xr, geo.x, geo.z, geo.w);
              Pair r;
              const float power = pair_power(col, yr, geo.y, geo2.x, r);
              if (live && power >= geo2.z) {  // else the pair skips: no exp
                const int outcome = eval_pair(power, geo2.y, trans, bp, r);
                live = outcome != kStop;
                if (outcome == kApply) {
                  const float w = __fmul_rn(r.alpha, trans);
                  const float4 rgb = sm.batch[j].rgb;
                  const float dwj = g0 * rgb.x + g1 * rgb.y + g2 * rgb.z + dot;
                  const float acc = accum_b + dwj * w;
                  const float da = dwj * trans - (bt - acc) / (1.f - r.alpha);
                  const bool grad = r.alpha_u < bp.alpha_clamp;
                  const float dpower = da * r.alpha_u;
                  const float px = dpower * r.dx;
                  const float py = dpower * r.dy;
                  v[8 * u + S_DX] = grad ? px : 0.f;
                  v[8 * u + S_DY] = grad ? py : 0.f;
                  v[8 * u + S_DXX] = grad ? px * r.dx : 0.f;
                  v[8 * u + S_DXY] = grad ? px * r.dy : 0.f;
                  v[8 * u + S_DYY] = grad ? py * r.dy : 0.f;
                  v[8 * u + S_R] = g0 * w;
                  v[8 * u + S_G] = g1 * w;
                  v[8 * u + S_B] = g2 * w;
                  v8[u] = grad ? da * r.e : 0.f;
                  accum_b = acc;
                  trans = r.test_t;
                  w_out[u] = w;
                  any = true;
                }
              }
            }
          }
          if (__any_sync(full, any)) {  // warp-uniform
            // Lane l holds value l / (32 / (8 kWalk)) of v: term l % 8 of
            // Gaussian j0 + l / 8 at kWalk = 4.
            constexpr int kLanes = 32 / (8 * kWalk);  // lanes a value
            const float s = exchange_sum<kWalk * 8>(v, lane);
            const float s8 = exchange_sum<kWalk>(v8, lane);
            const int val = lane / kLanes, j = j0 + val / 8;
            if (j < n && lane % kLanes == 0) {
              sm.part[warp][j][val % 8] = s;
              if (val % 8 == 0) sm.part[warp][j][S_OP] = s8;
            }
          }
          done = !live;
          took_part = !__all_sync(full, done);
        }
#pragma unroll
        for (int u = 0; u < kWalk; ++u)
          if (j0 + u < n) sm.dw[lin][swz(lin, j0 + u)] = w_out[u];
      }
      const int cta_done = __syncthreads_and(done);
      // S = W^T g_F: each thread 8 Gaussians x 4 channels over its range
      // of pixels, the ranges then added in order.
      float4 acc[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (8 * sj < n) {
        const int i0 = split * (kPix / kSplits);
#pragma unroll 8
        for (int i = i0; i < i0 + kPix / kSplits; ++i) {
          const float4 g =
              *reinterpret_cast<const float4*>(&sm.gf[i][swz(i, 4 * sc)]);
          const float4 w0 =
              *reinterpret_cast<const float4*>(&sm.dw[i][swz(i, 8 * sj)]);
          const float4 w1 =
              *reinterpret_cast<const float4*>(&sm.dw[i][swz(i, 8 * sj + 4)]);
          acc[0] = fma4(w0.x, g, acc[0]);
          acc[1] = fma4(w0.y, g, acc[1]);
          acc[2] = fma4(w0.z, g, acc[2]);
          acc[3] = fma4(w0.w, g, acc[3]);
          acc[4] = fma4(w1.x, g, acc[4]);
          acc[5] = fma4(w1.y, g, acc[5]);
          acc[6] = fma4(w1.z, g, acc[6]);
          acc[7] = fma4(w1.w, g, acc[7]);
        }
      }
      __syncthreads();  // dw is free: it takes the ranges' sums
      float* range_sums = &sm.dw[0][0];  // [kSplits][kBatch][KW]
#pragma unroll
      for (int v = 0; v < 8; ++v)
        *reinterpret_cast<float4*>(
            &range_sums[(split * kBatch + 8 * sj + v) * KW + 4 * sc]) =
            acc[v];
      __syncthreads();
      for (int e = lin; e < kBatch * KW; e += kPix) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < kSplits; ++r) s += range_sums[r * kBatch * KW + e];
        (&sm.fsum[parity][0][0])[e] = s;
      }
      // The CTA's slot sums: its warps' partials in warp order.
      for (int j = lin; j < n; j += kPix) {
        float sum[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) sum[k] = 0.f;
        for (int w = 0; w < kWarps; ++w) {
#pragma unroll
          for (int k = 0; k < kSums; ++k) sum[k] += sm.part[w][j][k];
        }
#pragma unroll
        for (int k = 0; k < kSums; ++k) sm.csum[parity][j][k] = sum[k];
      }
      if (lin == 0) sm.done[parity] = cta_done;
      cluster.sync();
      // The cluster's slot sums, CTA `rank` taking slots rank, rank + cs,
      // ...: the CTAs' sums in rank order, chained per Gaussian and added
      // to the slot's gradients.
      for (int j = rank + cs * lin; j < n; j += cs * kPix) {
        float o[kMaxCluster][kSums];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
#pragma unroll
          for (int k = 0; k < kSums; ++k)
            o[r][k] = r < cs ? peer[r]->csum[parity][j][k] : 0.f;
        }
        float sum[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k)
          sum[k] = ((o[0][k] + o[1][k]) + o[2][k]) + o[3][k];
        const float4 geo = sm.batch[j].geo;
        const float ca = geo.z, cb = geo.w, cc = sm.batch[j].geo2.x;
        float d[kFeatures];
        d[F_GX] = ca * sum[S_DX] + cb * sum[S_DY];
        d[F_GY] = cc * sum[S_DY] + cb * sum[S_DX];
        d[F_CA] = -0.5f * sum[S_DXX];
        d[F_CB] = -sum[S_DXY];
        d[F_CC] = -0.5f * sum[S_DYY];
        d[F_R] = sum[S_R];
        d[F_G] = sum[S_G];
        d[F_B] = sum[S_B];
        d[F_OP] = sum[S_OP];
        const int64_t s = (int64_t)b0 + j;
#pragma unroll
        for (int f = 0; f < kFeatures; ++f) {
          if (pass == 0)
            dgeo[f * max_i + s] = d[f];
          else
            dgeo[f * max_i + s] += d[f];
        }
      }
      // The cluster's table sums, CTA `rank` taking every cs-th run of
      // kPix entries (slot, channel): the CTAs' sums in rank order, added
      // to the Gaussian's row once. Every remote load of a run is issued
      // before its adds.
      constexpr int kRuns = 4;
      const int stride = cs * kPix;
      for (int e0 = rank * kPix + lin; e0 < n * KW; e0 += kRuns * stride) {
        float o[kRuns][kMaxCluster];
#pragma unroll
        for (int u = 0; u < kRuns; ++u) {
          const int e = e0 + u * stride;
#pragma unroll
          for (int r = 0; r < kMaxCluster; ++r)
            o[u][r] = r < cs && e < n * KW
                          ? (&peer[r]->fsum[parity][0][0])[e]
                          : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kRuns; ++u) {
          const int e = e0 + u * stride;
          const int j = e / KW, c = e % KW;
          const float sum = ((o[u][0] + o[u][1]) + o[u][2]) + o[u][3];
          if (e < n * KW && c0 + c < channels && sum != 0.f)
            atomicAdd(&dfeat[(int64_t)sm.gid[j] * channels + c0 + c], sum);
        }
      }
      bool all_done = true;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        all_done = all_done && (r >= cs || peer[r]->done[parity]);
      parity ^= 1;
      if (all_done) break;
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

template <int FMT, int KW>
cudaError_t launch(const void* stream, int64_t max_i, const int32_t* ranges,
                   const int32_t* gid, const float* feat, int channels,
                   int num_tiles, const float* g_color, const float* b_total,
                   const float* g_feat, const float* f_final, int tile_offset,
                   int tiles_x, int tile_size, int width, int height,
                   BlendParams bp, Quant q, float* dgeo, float* dfeat,
                   cudaStream_t st) {
  // The shared memory passes the 48 KB a launch gets by default: asked for
  // once per instantiation, before any launch (so never inside a capture).
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        feat_bwd_kernel<FMT, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem<KW>));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  // CTAs of a tile's cluster.
  const int cs = (tile_size * tile_size + kPix - 1) / kPix;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(num_tiles * cs);
  config.blockDim = dim3(kPix);
  config.dynamicSmemBytes = sizeof(Smem<KW>);
  config.stream = st;
  config.attrs = &attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, feat_bwd_kernel<FMT, KW>, stream, max_i, ranges, gid, feat,
      channels, g_color, b_total, g_feat, f_final, tile_offset, tiles_x,
      tile_size, width, height, bp, q, dgeo, dfeat);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_format(int channels, const void* stream, int64_t max_i,
                          const int32_t* ranges, const int32_t* gid,
                          const float* feat, int num_tiles,
                          const float* g_color, const float* b_total,
                          const float* g_feat, const float* f_final,
                          int tile_offset, int tiles_x, int tile_size,
                          int width, int height, BlendParams bp, Quant q,
                          float* dgeo, float* dfeat, cudaStream_t st) {
#define GSPLAT_FEAT_BWD(KW)                                                \
  launch<FMT, KW>(stream, max_i, ranges, gid, feat, channels, num_tiles,   \
                  g_color, b_total, g_feat, f_final, tile_offset, tiles_x, \
                  tile_size, width, height, bp, q, dgeo, dfeat, st)
  // The narrowest pass that holds C, so that a small C leaves the SM room
  // for a second CTA.
  if (channels <= 32) return GSPLAT_FEAT_BWD(32);
  if (channels <= 64) return GSPLAT_FEAT_BWD(64);
  return GSPLAT_FEAT_BWD(kMaxChannels);
#undef GSPLAT_FEAT_BWD
}

}  // namespace

// Channels one walk takes: a larger C walks once per kMaxChannels.
extern "C" int gsplat_feat_bwd_pass_channels() { return kMaxChannels; }

// dgeo (9, max_i) and dfeat (N, channels), both float32, must be
// zero-filled by the caller: the kernel adds to them. g_color (T, 3, P) and
// b_total (T, P) are K2's inputs for the colour (b_total without the
// features' share); g_feat and f_final are the (height, width, channels)
// gradient of the feature map and the map K6 wrote.
extern "C" int gsplat_feat_bwd(const void* stream, int fmt, int64_t max_i,
                               const int32_t* ranges, const int32_t* gid,
                               const float* feat, int channels, int num_tiles,
                               const float* g_color, const float* b_total,
                               const float* g_feat, const float* f_final,
                               int tile_offset, int tiles_x, int tile_size,
                               int width, int height, float alpha_clamp,
                               float alpha_min, float t_min, float lox,
                               float inv_sx, float loy, float inv_sy,
                               float rg_step, float b_step, float* dgeo,
                               float* dfeat, void* cuda_stream) {
  if (tile_size < 1 || tile_size > 32 || channels < 1)
    return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const gsplat::BlendParams bp{alpha_clamp, alpha_min, t_min};
  const gsplat::Quant q{lox, inv_sx, loy, inv_sy, rg_step, b_step};
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GSPLAT_FEAT_BWD(F)                                                  \
  launch_format<F>(channels, stream, max_i, ranges, gid, feat, num_tiles,   \
                   g_color, b_total, g_feat, f_final, tile_offset, tiles_x, \
                   tile_size, width, height, bp, q, dgeo, dfeat, st)
  switch (fmt) {
    case gsplat::kF32:
      return (int)GSPLAT_FEAT_BWD(gsplat::kF32);
    case gsplat::kPacked16:
      return (int)GSPLAT_FEAT_BWD(gsplat::kPacked16);
    case gsplat::kPacked4:
      return (int)GSPLAT_FEAT_BWD(gsplat::kPacked4);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GSPLAT_FEAT_BWD
}
