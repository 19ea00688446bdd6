// K1: per-tile front-to-back blend of the depth-sorted feature stream.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/raster.py::_fwd_kernel. Tile
// t walks its segment [ranges[t], ranges[t+1]) of the (9, max_I) float32
// feature stream (rows gx, gy, conic a/b/c, r/g/b, opacity) and blends it
// front to back into its pixels with the rules of gsplat_tpu/ops/blend.py:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy, skip unless power <= 0;
//   alpha = min(0.99, op * exp(min(power, 0))), skip unless alpha >= 1/255;
//   stop the pixel for good when T (1 - alpha) < 1e-4, that Gaussian
//   excluded; else C += c alpha T, T *= 1 - alpha.
// It writes per tile the colour (3, P) and the final transmittance (P). The
// stream is the float32 one or a packed int32 one (packed16, packed4:
// gsplat_tpu_torch/ops/stream16.py), a template parameter; a packed slot is
// unpacked where the batch is staged into shared memory (blend.cuh's
// load_slot), as the TPU kernel unpacks its VMEM block (raster.py:56-63).
//
// What bounds it on an H100: arithmetic. Each (pixel, Gaussian) pair the
// data needs costs about 20 FP32 operations and one exp, against one read of
// the stream (148 MB at the bench shape, tens of microseconds), so the
// bound is the walked pairs over the FP32 rate. A first design, one thread
// per pixel and one CTA per tile, ran 14x that bound: nine 4-byte shared
// loads, the quadratic and the exp on every pair a 32-pixel warp walked
// (73% of them then skipped for alpha < 1/255), and 1024-thread CTAs whose
// finished warps waited at each batch's barrier for the tile's slowest
// pixel. The design is blend.cuh's multi-pixel walk, shared with K2:
//   - one CTA per warp: a warp owns 2 pixels in each of 32 columns (a
//     32x2 strip of a 32x32 tile), stages its own batches of
//     32 Gaussians as 48-byte records (the next batch's slots loaded into
//     registers while the current one is walked) and leaves when its own
//     pixels are done, so no warp waits on another;
//   - per Gaussian a thread forms the column factors (a dx) dx and b dx once
//     and each pixel's power, then skips the exp unless some live pixel's
//     power reaches the Gaussian's power floor (exact: below it no pair
//     reaches alpha_min); the pixels' exps and tests then run side by side,
//     branch-free, with eval_pair's decisions (blend.cuh).
// There is no cross-CTA state: the TPU kernel's block-0 read-modify-write
// has no counterpart here.
//
// The serial product T (1 - alpha) rounds differently from the plain
// version's exp(cumsum(log1p(-alpha))); a pixel whose T lands on the 1e-4
// threshold can flip, so kernel and plain agree to a stated tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"

namespace {

using namespace gsplat;

// Pixels of one column per thread (blend.cuh's walk).
constexpr int PPT = kPixelsPerThread;

// One CTA per warp: warp `w` of tile `t` (blockIdx.x = t * warps + w) owns
// the pixels of threads 32 w ... 32 w + 31 of the tile (blend.cuh's walk),
// stages its own batches of 32 Gaussians (the next batch's slots are
// loaded into registers while the current one is walked) and leaves as
// soon as its own pixels are done.
template <int FMT>
__global__ void __launch_bounds__(32, 32)
raster_fwd_kernel(const void* __restrict__ stream, int64_t max_i,
                  const int32_t* __restrict__ ranges, int tile_offset,
                  int tiles_x, int ts, int warps, BlendParams bp, Quant q,
                  float* __restrict__ out_color,
                  float* __restrict__ out_trans) {
  __shared__ Staged s_batch[32];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  const int t = blockIdx.x / warps;
  const int lin = (blockIdx.x % warps) * 32 + lane;
  const int p = ts * ts;

  const int gt = t + tile_offset;
  const float ox = (float)((gt % tiles_x) * ts);
  const float oy = (float)((gt / tiles_x) * ts);
  // This thread's column and first row, relative to the tile origin.
  const int x = lin % ts;
  const int row0 = (lin / ts) * PPT;
  const int rows = max(0, min(PPT, ts - row0));
  const float xr = (float)x;
  const int start = ranges[t];
  const int end = ranges[t + 1];

  float trans[PPT], c0[PPT], c1[PPT], c2[PPT];
  bool live[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    trans[k] = 1.f;
    c0[k] = c1[k] = c2[k] = 0.f;
    live[k] = k < rows;
  }
  int done = rows == 0;
  float v[kFeatures];
  if (start + lane < end) load_slot<FMT>(stream, max_i, start + lane, q, v);
  for (int b0 = start; b0 < end; b0 += 32) {
    if (__all_sync(full, done)) break;
    const int n = min(32, end - b0);
    __syncwarp();
    if (lane < n) s_batch[lane] = stage(v, ox, oy, bp);
    __syncwarp();
    if (b0 + 32 + lane < end)
      load_slot<FMT>(stream, max_i, (int64_t)b0 + 32 + lane, q, v);
    for (int j = 0; j < n && !done; ++j) {
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
      if (!near) continue;  // every live pixel skips: no exp
      const float4 rgb = s_batch[j].rgb;
      bool any_live = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int outcome = eval_pair(power[k], geo2.y, trans[k], bp, pr[k]);
        const bool apply = live[k] && outcome == kApply;
        live[k] = live[k] && outcome != kStop;
        any_live = any_live || live[k];
        const float w = __fmul_rn(pr[k].alpha, trans[k]);
        c0[k] = apply ? __fadd_rn(c0[k], __fmul_rn(rgb.x, w)) : c0[k];
        c1[k] = apply ? __fadd_rn(c1[k], __fmul_rn(rgb.y, w)) : c1[k];
        c2[k] = apply ? __fadd_rn(c2[k], __fmul_rn(rgb.z, w)) : c2[k];
        trans[k] = apply ? pr[k].test_t : trans[k];
      }
      done = !any_live;
    }
  }
  float* col = out_color + (int64_t)t * 3 * p;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (k < rows) {
      const int px = (row0 + k) * ts + x;
      col[px] = c0[k];
      col[p + px] = c1[k];
      col[2 * p + px] = c2[k];
      out_trans[(int64_t)t * p + px] = trans[k];
    }
  }
}

template <int FMT>
cudaError_t launch(const void* stream, int64_t max_i, const int32_t* ranges,
                   int num_tiles, int tile_offset, int tiles_x, int tile_size,
                   BlendParams bp, Quant q, float* out_color,
                   float* out_trans, cudaStream_t st) {
  const int warps = walk_threads(tile_size) / 32;
  raster_fwd_kernel<FMT><<<num_tiles * warps, 32, 0, st>>>(
      stream, max_i, ranges, tile_offset, tiles_x, tile_size, warps, bp, q,
      out_color, out_trans);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gsplat_raster_fwd(const void* stream, int fmt, int64_t max_i,
                                 const int32_t* ranges, int num_tiles,
                                 int tile_offset, int tiles_x, int tile_size,
                                 float alpha_clamp, float alpha_min,
                                 float t_min, float lox, float inv_sx,
                                 float loy, float inv_sy, float rg_step,
                                 float b_step, float* out_color,
                                 float* out_trans, void* cuda_stream) {
  if (tile_size < 1 || tile_size > 32) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const gsplat::Quant q{lox, inv_sx, loy, inv_sy, rg_step, b_step};
  const gsplat::BlendParams bp{alpha_clamp, alpha_min, t_min};
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GSPLAT_FWD(F)                                                   \
  launch<F>(stream, max_i, ranges, num_tiles, tile_offset, tiles_x,     \
            tile_size, bp, q, out_color, out_trans, st)
  switch (fmt) {
    case gsplat::kF32:
      return (int)GSPLAT_FWD(gsplat::kF32);
    case gsplat::kPacked16:
      return (int)GSPLAT_FWD(gsplat::kPacked16);
    case gsplat::kPacked4:
      return (int)GSPLAT_FWD(gsplat::kPacked4);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GSPLAT_FWD
}

// The pixels of one column each thread walks (blend.cuh's kPixelsPerThread):
// the rows of a warp's strip at tile 32, for code that models the walk.
extern "C" int gsplat_raster_pixels_per_thread() {
  return gsplat::kPixelsPerThread;
}
