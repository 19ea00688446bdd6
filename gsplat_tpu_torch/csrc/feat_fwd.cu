// K6: the per-tile front-to-back blend of the colour and of C feature
// channels per Gaussian (Feature 3DGS's N-dimensional rasterizer: Zhou et
// al. 2024, arXiv:2312.03203).
//
// Each Gaussian carries, besides the 9 stream features K1 blends, a row of C
// float32 features in an (N, C) table, read by the slot's Gaussian id (the
// gid of the gidk stream): the stream itself is not widened. A pixel's
// feature is blended with the colour's own weights,
//   F(p) = sum_i f_i alpha_i(p) T_i(p),
// under K1's rules and decisions (blend.cuh's pair_power, eval_pair and
// power floor): the same pairs are skipped, applied and stop a pixel.
//
// Layout: K1's multi-pixel walk (one CTA per warp, a warp a 32x2 strip of
// a 32x32 tile, 2 pixels of a column per thread), once per chunk of 32
// feature channels: 128 float32 accumulators per pixel do not fit in
// registers at two pixels a thread, 2 x 32 do. A CTA is (tile, strip,
// chunk); it stages batches of 32 Gaussians as K1 does, plus their chunk of
// features (32 x 32 floats, one coalesced 128-byte row a Gaussian), and adds
// w f to its 64 accumulators for every Gaussian some pixel of the warp
// applies (a warp-uniform test, so the lanes stay converged). Chunk 0 also
// writes the colour and the final transmittance, as K1 does (T, 3, P) and
// (T, P); every chunk writes its channels of the feature map straight into
// the (H, W, C) image, pixels outside the image left out.
//
// What bounds it: arithmetic, 2 C FP32 operations per applied pair on top
// of K1's test of each walked pair, which every chunk repeats; the feature
// map (1 GB at 1080p and C = 128) is written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"

namespace {

using namespace gsplat;

constexpr int PPT = kPixelsPerThread;
// Feature channels per chunk: one per lane.
constexpr int kChunk = 32;

template <int FMT>
__global__ void __launch_bounds__(32, 16)
feat_fwd_kernel(const void* __restrict__ stream, int64_t max_i,
                const int32_t* __restrict__ ranges,
                const int32_t* __restrict__ gid,
                const float* __restrict__ feat, int channels,
                int tile_offset, int tiles_x, int ts, int warps, int chunks,
                int width, int height, BlendParams bp, Quant q,
                float* __restrict__ out_color, float* __restrict__ out_trans,
                float* __restrict__ out_feat) {
  __shared__ Staged s_batch[32];
  __shared__ __align__(16) float s_f[32][kChunk];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  const int chunk = blockIdx.x % chunks;
  const int strip = blockIdx.x / chunks;
  const int t = strip / warps;
  const int lin = (strip % warps) * 32 + lane;
  const int p = ts * ts;
  const int c0 = chunk * kChunk;
  const bool has_c = c0 + lane < channels;

  const int gt = t + tile_offset;
  const int tx0 = (gt % tiles_x) * ts;
  const int ty0 = (gt / tiles_x) * ts;
  const float ox = (float)tx0;
  const float oy = (float)ty0;
  const int x = lin % ts;
  const int row0 = (lin / ts) * PPT;
  const int rows = max(0, min(PPT, ts - row0));
  const float xr = (float)x;
  const int start = ranges[t];
  const int end = ranges[t + 1];

  float trans[PPT], c0v[PPT], c1v[PPT], c2v[PPT];
  float acc[PPT][kChunk];
  bool live[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    trans[k] = 1.f;
    c0v[k] = c1v[k] = c2v[k] = 0.f;
    live[k] = k < rows;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) acc[k][c] = 0.f;
  }
  int done = rows == 0;
  float v[kFeatures];
  int g_next = 0;
  if (start + lane < end) {
    load_slot<FMT>(stream, max_i, start + lane, q, v);
    g_next = gid[start + lane];
  }
  for (int b0 = start; b0 < end; b0 += 32) {
    if (__all_sync(full, done)) break;
    const int n = min(32, end - b0);
    const int g_mine = g_next;
    __syncwarp();
    if (lane < n) s_batch[lane] = stage(v, ox, oy, bp);
    // The batch's chunk of features: Gaussian j's row by lane.
    for (int j = 0; j < n; ++j) {
      const int g = __shfl_sync(full, g_mine, j);
      s_f[j][lane] = has_c ? feat[(int64_t)g * channels + c0 + lane] : 0.f;
    }
    __syncwarp();
    if (b0 + 32 + lane < end) {
      load_slot<FMT>(stream, max_i, (int64_t)b0 + 32 + lane, q, v);
      g_next = gid[b0 + 32 + lane];
    }
    // A warp-uniform loop: the warp's votes below need every lane.
    for (int j = 0; j < n; ++j) {
      const float4 geo = s_batch[j].geo;
      const float4 geo2 = s_batch[j].geo2;
      const Column col = column_terms(xr, geo.x, geo.z, geo.w);
      Pair pr[PPT];
      float power[PPT];
      bool near = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        power[k] = pair_power(col, (float)(row0 + k), geo.y, geo2.x, pr[k]);
        near = near || (live[k] && power[k] >= geo2.z);
      }
      if (!__any_sync(full, near)) continue;  // no live pixel reaches it
      const float4 rgb = s_batch[j].rgb;
      bool any_live = false, any_app = false;
      float w[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int outcome =
            near ? eval_pair(power[k], geo2.y, trans[k], bp, pr[k]) : kSkip;
        const bool apply = live[k] && outcome == kApply;
        live[k] = live[k] && outcome != kStop;
        any_live = any_live || live[k];
        any_app = any_app || apply;
        const float wk = __fmul_rn(pr[k].alpha, trans[k]);
        w[k] = apply ? wk : 0.f;
        c0v[k] = apply ? __fadd_rn(c0v[k], __fmul_rn(rgb.x, wk)) : c0v[k];
        c1v[k] = apply ? __fadd_rn(c1v[k], __fmul_rn(rgb.y, wk)) : c1v[k];
        c2v[k] = apply ? __fadd_rn(c2v[k], __fmul_rn(rgb.z, wk)) : c2v[k];
        trans[k] = apply ? pr[k].test_t : trans[k];
      }
      if (__any_sync(full, any_app)) {
#pragma unroll
        for (int c = 0; c < kChunk; c += 4) {
          const float4 f = *reinterpret_cast<const float4*>(&s_f[j][c]);
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            acc[k][c] = fmaf(w[k], f.x, acc[k][c]);
            acc[k][c + 1] = fmaf(w[k], f.y, acc[k][c + 1]);
            acc[k][c + 2] = fmaf(w[k], f.z, acc[k][c + 2]);
            acc[k][c + 3] = fmaf(w[k], f.w, acc[k][c + 3]);
          }
        }
      }
      done = !any_live;
      if (__all_sync(full, done)) break;
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (k >= rows) continue;
    const int px = (row0 + k) * ts + x;
    if (chunk == 0) {
      float* col = out_color + (int64_t)t * 3 * p;
      col[px] = c0v[k];
      col[p + px] = c1v[k];
      col[2 * p + px] = c2v[k];
      out_trans[(int64_t)t * p + px] = trans[k];
    }
    const int gx = tx0 + x, gy = ty0 + row0 + k;
    if (gx >= width || gy >= height) continue;
    float* o = out_feat + ((int64_t)gy * width + gx) * channels + c0;
    const int nc = min(kChunk, channels - c0);
    if (nc == kChunk && (channels % 4) == 0) {
#pragma unroll
      for (int c = 0; c < kChunk; c += 4)
        *reinterpret_cast<float4*>(o + c) =
            make_float4(acc[k][c], acc[k][c + 1], acc[k][c + 2],
                        acc[k][c + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (c < nc) o[c] = acc[k][c];
    }
  }
}

template <int FMT>
cudaError_t launch(const void* stream, int64_t max_i, const int32_t* ranges,
                   const int32_t* gid, const float* feat, int channels,
                   int num_tiles, int tile_offset, int tiles_x, int tile_size,
                   int width, int height, BlendParams bp, Quant q,
                   float* out_color, float* out_trans, float* out_feat,
                   cudaStream_t st) {
  const int warps = walk_threads(tile_size) / 32;
  const int chunks = (channels + kChunk - 1) / kChunk;
  feat_fwd_kernel<FMT><<<num_tiles * warps * chunks, 32, 0, st>>>(
      stream, max_i, ranges, gid, feat, channels, tile_offset, tiles_x,
      tile_size, warps, chunks, width, height, bp, q, out_color, out_trans,
      out_feat);
  return cudaGetLastError();
}

}  // namespace

// out_feat is the (height, width, channels) feature map of the frame whose
// tiles [tile_offset, tile_offset + num_tiles) the ranges describe; feat is
// the (N, channels) float32 table, gid the stream's Gaussian id per slot.
extern "C" int gsplat_feat_fwd(const void* stream, int fmt, int64_t max_i,
                               const int32_t* ranges, const int32_t* gid,
                               const float* feat, int channels, int num_tiles,
                               int tile_offset, int tiles_x, int tile_size,
                               int width, int height, float alpha_clamp,
                               float alpha_min, float t_min, float lox,
                               float inv_sx, float loy, float inv_sy,
                               float rg_step, float b_step, float* out_color,
                               float* out_trans, float* out_feat,
                               void* cuda_stream) {
  if (tile_size < 1 || tile_size > 32 || channels < 1)
    return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const gsplat::Quant q{lox, inv_sx, loy, inv_sy, rg_step, b_step};
  const gsplat::BlendParams bp{alpha_clamp, alpha_min, t_min};
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GSPLAT_FEAT_FWD(F)                                                  \
  launch<F>(stream, max_i, ranges, gid, feat, channels, num_tiles,          \
            tile_offset, tiles_x, tile_size, width, height, bp, q, out_color, \
            out_trans, out_feat, st)
  switch (fmt) {
    case gsplat::kF32:
      return (int)GSPLAT_FEAT_FWD(gsplat::kF32);
    case gsplat::kPacked16:
      return (int)GSPLAT_FEAT_FWD(gsplat::kPacked16);
    case gsplat::kPacked4:
      return (int)GSPLAT_FEAT_FWD(gsplat::kPacked4);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GSPLAT_FEAT_FWD
}
