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
// per-pixel gradients once. Design: one CTA per tile and one thread per
// pixel (blockDim is P rounded up to a warp; threads past P only join the
// barriers and shuffles). The segment is staged through shared memory in
// batches of 32 Gaussians. Per Gaussian, each warp sums its 32 pixels' 9
// terms with shuffles (skipped when no pixel of the warp applied the pair)
// and writes one partial per warp to shared memory; after the batch, the
// partials are summed in warp order, so the result does not depend on
// scheduling: no atomics, deterministic. Each slot lies in exactly one
// tile's segment, so a CTA writes only its own slots: there is no cross-CTA
// state, and the TPU kernel's block-0 read-modify-write (only there for TPU
// DMA alignment) has no counterpart. The CTA leaves the walk when every
// pixel is done, as K1 does; the wrapper zero-fills the output, so slots
// past an early exit and the invalid tail [ranges[T], max_I) stay exactly 0.
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

constexpr int kBatch = 32;     // Gaussians staged per batch
constexpr int kMaxWarps = 32;  // 1024 threads: a 32x32 tile
constexpr int kSums = 9;       // pixel sums per Gaussian
constexpr int kPairs = (kFeatures + 1) / 2;  // rows of the packed output
enum { S_DX, S_DY, S_DXX, S_DXY, S_DYY, S_R, S_G, S_B, S_OP };

template <int FMT, bool PACK_OUT>
__global__ void __launch_bounds__(1024, 1)
raster_bwd_kernel(const void* __restrict__ stream, int64_t max_i,
                  const int32_t* __restrict__ ranges,
                  const float* __restrict__ g_color,
                  const float* __restrict__ b_total, int p, int tile_offset,
                  int tiles_x, int ts, BlendParams bp, Quant q,
                  void* __restrict__ dfeat) {
  __shared__ float s_feat[kFeatures][kBatch];
  __shared__ float s_part[kMaxWarps][kSums][kBatch];
  __shared__ float s_sum[kSums][kBatch];
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  const int nwarps = blockDim.x >> 5;
  const int t = blockIdx.x;

  const int gt = t + tile_offset;
  const float ox = (float)((gt % tiles_x) * ts);
  const float oy = (float)((gt / tiles_x) * ts);
  const float xr = (float)(lin % ts);
  const float yr = (float)(lin / ts);
  const int start = ranges[t];
  const int end = ranges[t + 1];

  const bool pixel = lin < p;
  float g0 = 0.f, g1 = 0.f, g2 = 0.f, bt = 0.f;
  if (pixel) {
    const float* gc = g_color + (int64_t)t * 3 * p;
    g0 = gc[lin];
    g1 = gc[p + lin];
    g2 = gc[2 * p + lin];
    bt = b_total[(int64_t)t * p + lin];
  }
  float trans = 1.f, accum_b = 0.f;
  int done = pixel ? 0 : 1;
  for (int b0 = start; b0 < end; b0 += kBatch) {
    // Barrier before the batch overwrites shared memory, and early exit of
    // the whole CTA once every pixel has terminated.
    if (__syncthreads_and(done)) break;
    const int n = min(kBatch, end - b0);
    // The first warp stages the batch, one slot per lane.
    if (lin < kBatch) {
      float v[kFeatures];
      if (lin < n) {
        load_slot<FMT>(stream, max_i, (int64_t)b0 + lin, q, v);
        v[F_GX] = __fsub_rn(v[F_GX], ox);
        v[F_GY] = __fsub_rn(v[F_GY], oy);
      } else {
#pragma unroll
        for (int f = 0; f < kFeatures; ++f) v[f] = 0.f;
      }
#pragma unroll
      for (int f = 0; f < kFeatures; ++f) s_feat[f][lin] = v[f];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float v[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) v[k] = 0.f;
      bool applied = false;
      if (!done) {
        Pair pr;
        const int outcome = eval_pair(
            xr, yr, s_feat[F_GX][j], s_feat[F_GY][j], s_feat[F_CA][j],
            s_feat[F_CB][j], s_feat[F_CC][j], s_feat[F_OP][j], trans, bp, pr);
        if (outcome == kStop) {
          done = 1;
        } else if (outcome == kApply) {
          applied = true;
          const float w = __fmul_rn(pr.alpha, trans);
          const float dw = g0 * s_feat[F_R][j] + g1 * s_feat[F_G][j] +
                           g2 * s_feat[F_B][j];
          accum_b += dw * w;
          const float da =
              dw * trans - (bt - accum_b) / (1.f - pr.alpha);
          if (pr.alpha_u < bp.alpha_clamp) {
            const float dpower = da * pr.alpha_u;
            const float px = dpower * pr.dx;
            const float py = dpower * pr.dy;
            v[S_DX] = px;
            v[S_DY] = py;
            v[S_DXX] = px * pr.dx;
            v[S_DXY] = px * pr.dy;
            v[S_DYY] = py * pr.dy;
            v[S_OP] = da * pr.e;
          }
          v[S_R] = g0 * w;
          v[S_G] = g1 * w;
          v[S_B] = g2 * w;
          trans = pr.test_t;
        }
      }
      // The warp's sum of each term; a warp none of whose pixels applied
      // the pair has nothing to sum and writes its zeros.
      if (__any_sync(0xffffffffu, applied)) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) s_part[warp][k][j] = v[k];
      }
    }
    __syncthreads();
    // The tile's sums: the warps' partials added in warp order.
    for (int idx = lin; idx < kSums * kBatch; idx += blockDim.x) {
      const int k = idx / kBatch, j = idx % kBatch;
      if (j < n) {
        float acc = 0.f;
        for (int w = 0; w < nwarps; ++w) acc += s_part[w][k][j];
        s_sum[k][j] = acc;
      }
    }
    __syncthreads();
    if (lin < n) {
      const int j = lin;
      const float sdx = s_sum[S_DX][j], sdy = s_sum[S_DY][j];
      const float ca = s_feat[F_CA][j], cb = s_feat[F_CB][j],
                  cc = s_feat[F_CC][j];
      float d[kFeatures];
      d[F_GX] = ca * sdx + cb * sdy;
      d[F_GY] = cc * sdy + cb * sdx;
      d[F_CA] = -0.5f * s_sum[S_DXX][j];
      d[F_CB] = -s_sum[S_DXY][j];
      d[F_CC] = -0.5f * s_sum[S_DYY][j];
      d[F_R] = s_sum[S_R][j];
      d[F_G] = s_sum[S_G][j];
      d[F_B] = s_sum[S_B][j];
      d[F_OP] = s_sum[S_OP][j];
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
  const int p = tile_size * tile_size;
  const int threads = (p + 31) / 32 * 32;
  raster_bwd_kernel<FMT, PACK_OUT><<<num_tiles, threads, 0, st>>>(
      stream, max_i, ranges, g_color, b_total, p, tile_offset, tiles_x,
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
  const int p = tile_size * tile_size;
  const int threads = (p + 31) / 32 * 32;
  if (threads > kMaxWarps * 32) return (int)cudaErrorInvalidValue;
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
