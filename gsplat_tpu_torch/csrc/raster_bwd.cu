// K2: per-slot gradients of the 9 stream features, the backward of K1.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/raster.py::_bwd_kernel (its
// block math is gsplat_tpu/ops/blend.py::blend_block_bwd). Tile t re-walks
// its segment [ranges[t], ranges[t+1]) front to back with K1's decisions
// (blend.cuh's eval_pair) and, per pixel, the suffix-sum identity:
//   b_total = sum_c g_colour[c] colour[c] + g_T T_final   (from K1's outputs)
//   dw      = sum_c g_colour[c] rgb[c]                      (dL/dw of a pair)
//   accum_b = running sum of dw w over the pairs applied so far (inclusive)
//   da      = dw T_before - (b_total - accum_b) / (1 - alpha)
//   dpower  = da alpha_u [alpha_u < clamp],  d_op = da e [alpha_u < clamp]
// The final-transmittance term of b_total has the same -1/(1 - alpha)
// suffix structure as the colour path, so it folds into the same sum. d_op
// is a product, never the JAX package's m[0] / opacity: a zero-feature slot
// (zero opacity) gives 0, not 0/0, with no guard needed. The 9 gradients of
// a slot are sums over the tile's pixels of
//   dpower dx, dpower dy, dpower dx^2, dpower dx dy, dpower dy^2,
//   g_colour[c] w (c = r, g, b), da e,
// chained afterwards per Gaussian into d gx = a S_dx + b S_dy, d gy =
// c S_dy + b S_dx, d a = -S_dxx / 2, d b = -S_dxy, d c = -S_dyy / 2.
//
// What bounds it on an H100: arithmetic. Each (pixel, Gaussian) pair a pixel
// walks costs about 20 FP32 operations (the forward test), each pair it
// applies about 33 more (the gradient terms and their pixel sums); it moves
// the stream twice (read and write, 148 MB each at the bench shape) and the
// per-pixel gradients once. Design: blend.cuh's multi-pixel walk, as K1's
// (2 pixels of one column per thread, the power-floor skip, eval_pair's
// decisions), so that the two kernels' decisions cannot drift, in one CTA
// per tile: the slot sums need every pixel of the tile. Per Gaussian each
// thread sums its pixels' 9 terms in registers in pixel order; a warp any
// of whose pixels applied the Gaussian reduces the terms across its lanes
// in 14 shuffles (blend.cuh's halving_sum: a halving exchange of 8 terms, a
// butterfly of the ninth) and writes one partial per term to shared
// memory. Batches hold kBatch Gaussians; every warp zero-fills its partials
// per batch, a warp whose pixels are all done leaves the batch, and after
// the batch the tile's sums add the warps' partials in warp order, so the
// result does not depend on scheduling: no atomics, deterministic. Each
// slot lies in exactly one tile's segment, so a CTA writes only its own
// slots: there is no cross-CTA state, and the TPU kernel's block-0
// read-modify-write (only there for TPU DMA alignment) has no counterpart.
// The CTA leaves the walk when every pixel is done, as K1's warps do; the
// wrapper zero-fills the output, so slots past an early exit and the
// invalid tail [ranges[T], max_I) stay exactly 0.
//
// Formats: the stream is read in any of K1's formats (blend.cuh's load_slot,
// a template parameter). With a packed stream and gather_backward='bf16' the
// kernel writes its gradients as 5 int32 rows of bf16 pairs (0|1) (2|3)
// (4|5) (6|7) (8|0) (blend.cuh's pack_pair, rounding to nearest even), as
// the TPU kernel's _pack_grad_block does (raster.py:79-99, :294-295); K5
// then sums them without unpacking the stream in device memory. The (8|0)
// pair has a zero high half, an f32 denormal bit pattern, so it is written
// as an integer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"

namespace {

using namespace gsplat;

// Pixels of one column per thread (blend.cuh's walk).
constexpr int PPT = kPixelsPerThread;

// Gaussians staged per batch: 64 at 16 warps (the partials take 36 KB).
constexpr int kBatch = 1024 / kMaxWarps;
constexpr int kSums = 9;     // pixel sums per Gaussian
constexpr int kPairs = (kFeatures + 1) / 2;  // rows of the packed output
enum { S_DX, S_DY, S_DXX, S_DXY, S_DYY, S_R, S_G, S_B, S_OP };

template <int FMT, bool PACK_OUT>
__global__ void __launch_bounds__(kMaxWarps * 32)
raster_bwd_kernel(const void* __restrict__ stream, int64_t max_i,
                  const int32_t* __restrict__ ranges,
                  const float* __restrict__ g_color,
                  const float* __restrict__ b_total, int tile_offset,
                  int tiles_x, int ts, BlendParams bp, Quant q,
                  void* __restrict__ dfeat) {
  __shared__ Staged s_batch[kBatch];
  // Per (warp, Gaussian) partials, term last: the 8 lanes that write one
  // Gaussian's terms, and the threads that sum one Gaussian each, hit
  // distinct banks.
  __shared__ __align__(16) float s_part[kMaxWarps][kBatch][kSums];
  const unsigned full = 0xffffffffu;
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  const int nwarps = blockDim.x >> 5;
  const int t = blockIdx.x;
  const int p = ts * ts;

  const int gt = t + tile_offset;
  const float ox = (float)((gt % tiles_x) * ts);
  const float oy = (float)((gt / tiles_x) * ts);
  const int x = lin % ts;
  const int row0 = (lin / ts) * PPT;
  const int rows = max(0, min(PPT, ts - row0));
  const float xr = (float)x;
  const int start = ranges[t];
  const int end = ranges[t + 1];

  float g0[PPT], g1[PPT], g2[PPT], bt[PPT], trans[PPT], accum_b[PPT];
  bool live[PPT];
  const float* gc = g_color + (int64_t)t * 3 * p;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    live[k] = k < rows;
    const int px = live[k] ? (row0 + k) * ts + x : 0;
    g0[k] = live[k] ? gc[px] : 0.f;
    g1[k] = live[k] ? gc[p + px] : 0.f;
    g2[k] = live[k] ? gc[2 * p + px] : 0.f;
    bt[k] = live[k] ? b_total[(int64_t)t * p + px] : 0.f;
    trans[k] = 1.f;
    accum_b[k] = 0.f;
  }
  int done = rows == 0;
  for (int b0 = start; b0 < end; b0 += kBatch) {
    // Barrier before the batch overwrites shared memory, and early exit of
    // the whole CTA once every pixel has terminated.
    if (__syncthreads_and(done)) break;
    const int n = min(kBatch, end - b0);
    for (int i = lin; i < n; i += blockDim.x) {
      s_batch[i] = stage_slot<FMT>(stream, max_i, (int64_t)b0 + i, q, ox, oy,
                                   bp);
    }
    // Each warp zero-fills its partials and, while any of its pixels is
    // live, walks the batch and writes those of the Gaussians it applies.
    {
      float4* part = reinterpret_cast<float4*>(&s_part[warp][0][0]);
      for (int i = lane; i < kSums * kBatch / 4; i += 32)
        part[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const bool took_part = __any_sync(full, !done);
    __syncthreads();
    for (int j = 0; took_part && j < n; ++j) {
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
      // The 8 terms S_DX ... S_B, and the opacity term apart.
      float v[8], v8[1] = {0.f};
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
      bool any_app = false;
      if (near) {  // else every live pixel skips: no exp
        const float4 rgb = s_batch[j].rgb;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          // Every pixel's terms are formed and those of the pixels that
          // apply the pair are added, in pixel order, with no branch.
          Pair& r = pr[k];
          const int outcome = eval_pair(power[k], geo2.y, trans[k], bp, r);
          const bool app = live[k] && outcome == kApply;
          live[k] = live[k] && outcome != kStop;
          any_app = any_app || app;
          const float w = __fmul_rn(r.alpha, trans[k]);
          const float dw = g0[k] * rgb.x + g1[k] * rgb.y + g2[k] * rgb.z;
          const float acc = accum_b[k] + dw * w;
          const float da = dw * trans[k] - (bt[k] - acc) / (1.f - r.alpha);
          const bool grad = app && r.alpha_u < bp.alpha_clamp;
          const float dpower = da * r.alpha_u;
          const float px = dpower * r.dx;
          const float py = dpower * r.dy;
          v[S_DX] += grad ? px : 0.f;
          v[S_DY] += grad ? py : 0.f;
          v[S_DXX] += grad ? px * r.dx : 0.f;
          v[S_DXY] += grad ? px * r.dy : 0.f;
          v[S_DYY] += grad ? py * r.dy : 0.f;
          v[S_R] += app ? g0[k] * w : 0.f;
          v[S_G] += app ? g1[k] * w : 0.f;
          v[S_B] += app ? g2[k] * w : 0.f;
          v8[0] += grad ? da * r.e : 0.f;
          accum_b[k] = app ? acc : accum_b[k];
          trans[k] = app ? r.test_t : trans[k];
        }
      }
      if (__any_sync(full, any_app)) {  // warp-uniform
        // Lane l ends with term l / 4; every lane with the opacity term.
        const float s = halving_sum<8>(v, lane);
        const float s8 = halving_sum<1>(v8, lane);
        if (lane % 4 == 0) s_part[warp][j][lane / 4] = s;
        if (lane == 0) s_part[warp][j][S_OP] = s8;
      }
      bool all_done = true;
#pragma unroll
      for (int k = 0; k < PPT; ++k) all_done = all_done && !live[k];
      done = all_done;
      if (__all_sync(full, done)) break;
    }
    __syncthreads();
    // The tile's sums: the warps' partials added in warp order (nine
    // independent chains); then the chain rule per Gaussian.
    for (int j = lin; j < n; j += blockDim.x) {
      float sum[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) sum[k] = 0.f;
#pragma unroll 4
      for (int w = 0; w < nwarps; ++w) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) sum[k] += s_part[w][j][k];
      }
      const float4 geo = s_batch[j].geo;
      const float ca = geo.z, cb = geo.w, cc = s_batch[j].geo2.x;
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
      if (PACK_OUT) {
        // bf16 pairs (0|1) (2|3) (4|5) (6|7) (8|0), the pairing of the TPU
        // kernel's _pack_grad_block (raster.py:79-99).
        int32_t* out = static_cast<int32_t*>(dfeat);
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          out[i * max_i + s] =
              pack_pair(d[2 * i], 2 * i + 1 < kFeatures ? d[2 * i + 1] : 0.f);
        }
      } else {
        float* out = static_cast<float*>(dfeat);
#pragma unroll
        for (int f = 0; f < kFeatures; ++f) out[f * max_i + s] = d[f];
      }
    }
  }
}

template <int FMT, bool PACK_OUT>
void launch(const void* stream, int64_t max_i, const int32_t* ranges,
            int num_tiles, const float* g_color, const float* b_total,
            int tile_offset, int tiles_x, int tile_size, BlendParams bp,
            Quant q, void* dfeat, cudaStream_t st) {
  raster_bwd_kernel<FMT, PACK_OUT>
      <<<num_tiles, walk_threads(tile_size), 0, st>>>(
          stream, max_i, ranges, g_color, b_total, tile_offset, tiles_x,
          tile_size, bp, q, dfeat);
}

}  // namespace

// dfeat must be zero-filled by the caller: the kernel writes only the slots
// its tiles walk. It is (9, max_i) float32, or with pack_out (5, max_i)
// int32 bf16 pairs.
extern "C" int gsplat_raster_bwd(const void* stream, int fmt, int64_t max_i,
                                 const int32_t* ranges, int num_tiles,
                                 const float* g_color, const float* b_total,
                                 int tile_offset, int tiles_x, int tile_size,
                                 float alpha_clamp, float alpha_min,
                                 float t_min, float lox, float inv_sx,
                                 float loy, float inv_sy, float rg_step,
                                 float b_step, int pack_out, void* dfeat,
                                 void* cuda_stream) {
  if (tile_size < 1 || tile_size > 32) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    const gsplat::BlendParams bp{alpha_clamp, alpha_min, t_min};
    const gsplat::Quant q{lox, inv_sx, loy, inv_sy, rg_step, b_step};
    cudaStream_t st = (cudaStream_t)cuda_stream;
#define GSPLAT_BWD(F, P)                                                   \
  launch<F, P>(stream, max_i, ranges, num_tiles, g_color, b_total,         \
               tile_offset, tiles_x, tile_size, bp, q, dfeat, st)
    if (fmt == gsplat::kF32 && !pack_out) {
      GSPLAT_BWD(gsplat::kF32, false);
    } else if (fmt == gsplat::kPacked16 && pack_out) {
      GSPLAT_BWD(gsplat::kPacked16, true);
    } else if (fmt == gsplat::kPacked16) {
      GSPLAT_BWD(gsplat::kPacked16, false);
    } else if (fmt == gsplat::kPacked4 && pack_out) {
      GSPLAT_BWD(gsplat::kPacked4, true);
    } else if (fmt == gsplat::kPacked4) {
      GSPLAT_BWD(gsplat::kPacked4, false);
    } else {
      return (int)cudaErrorInvalidValue;
    }
#undef GSPLAT_BWD
  }
  return (int)cudaGetLastError();
}
