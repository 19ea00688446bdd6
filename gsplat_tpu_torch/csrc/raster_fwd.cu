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
// pair arithmetic is blend.cuh's eval_pair, shared with the backward K2.
// The stream is the float32 one or a packed int32 one (packed16, packed4:
// gsplat_tpu_torch/ops/stream16.py), a template parameter; a packed slot is
// unpacked where the batch is staged into shared memory (blend.cuh's
// load_slot), as the TPU kernel unpacks its VMEM block (raster.py:56-63).
//
// What bounds it on an H100: arithmetic. Each (pixel, Gaussian) pair the
// data needs costs about 20 FP32 operations and one exp, against one read of
// the stream (148 MB at the bench shape, tens of microseconds), so the
// bound is the evaluated pairs over the FP32 rate. Design: one CTA per tile
// and one thread per pixel, each running the serial per-pixel loop; the
// tile's segment is staged through shared memory in batches of one Gaussian
// per thread (coalesced row loads, broadcast reads in the loop). The CTA
// reads its own ranges (no scalar prefetch) and leaves the walk as soon as
// every pixel is done (__syncthreads_and). There is no cross-CTA state: the
// TPU kernel's block-0 read-modify-write has no counterpart here.
//
// The serial product T (1 - alpha) rounds differently from the plain
// version's exp(cumsum(log1p(-alpha))); a pixel whose T lands on the 1e-4
// threshold can flip, so kernel and plain agree to a stated tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"

namespace {

using namespace gsplat;

template <int FMT>
__global__ void raster_fwd_kernel(const void* __restrict__ stream,
                                  int64_t max_i,
                                  const int32_t* __restrict__ ranges,
                                  int tile_offset, int tiles_x, int ts,
                                  BlendParams bp, Quant q,
                                  float* __restrict__ out_color,
                                  float* __restrict__ out_trans) {
  extern __shared__ float smem[];  // kFeatures rows of blockDim.x Gaussians
  const int p = blockDim.x;  // pixels per tile = Gaussians per batch
  const int lin = threadIdx.x;
  const int t = blockIdx.x;
  float* s_gxr = smem;  // Gaussian centres relative to the tile origin
  float* s_gyr = smem + p;
  float* s_a = smem + 2 * p;
  float* s_b = smem + 3 * p;
  float* s_c = smem + 4 * p;
  float* s_r = smem + 5 * p;
  float* s_g = smem + 6 * p;
  float* s_bl = smem + 7 * p;
  float* s_op = smem + 8 * p;

  const int gt = t + tile_offset;
  const float ox = (float)((gt % tiles_x) * ts);
  const float oy = (float)((gt / tiles_x) * ts);
  // Pixel centre relative to the tile origin (integer pixel coordinates).
  const float xr = (float)(lin % ts);
  const float yr = (float)(lin / ts);
  const int start = ranges[t];
  const int end = ranges[t + 1];

  float trans = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  int done = 0;
  for (int b0 = start; b0 < end; b0 += p) {
    // Barrier before the batch overwrites shared memory, and early exit
    // of the whole CTA once every pixel has terminated.
    if (__syncthreads_and(done)) break;
    const int n = min(p, end - b0);
    if (lin < n) {
      float v[kFeatures];
      load_slot<FMT>(stream, max_i, (int64_t)b0 + lin, q, v);
      s_gxr[lin] = __fsub_rn(v[F_GX], ox);
      s_gyr[lin] = __fsub_rn(v[F_GY], oy);
      s_a[lin] = v[F_CA];
      s_b[lin] = v[F_CB];
      s_c[lin] = v[F_CC];
      s_r[lin] = v[F_R];
      s_g[lin] = v[F_G];
      s_bl[lin] = v[F_B];
      s_op[lin] = v[F_OP];
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < n; ++j) {
      Pair pr;
      const int outcome = eval_pair(xr, yr, s_gxr[j], s_gyr[j], s_a[j],
                                    s_b[j], s_c[j], s_op[j], trans, bp, pr);
      if (outcome == kSkip) continue;
      if (outcome == kStop) {
        done = 1;
        break;
      }
      const float w = __fmul_rn(pr.alpha, trans);
      c0 = __fadd_rn(c0, __fmul_rn(s_r[j], w));
      c1 = __fadd_rn(c1, __fmul_rn(s_g[j], w));
      c2 = __fadd_rn(c2, __fmul_rn(s_bl[j], w));
      trans = pr.test_t;
    }
  }
  float* col = out_color + (int64_t)t * 3 * p;
  col[lin] = c0;
  col[p + lin] = c1;
  col[2 * p + lin] = c2;
  out_trans[(int64_t)t * p + lin] = trans;
}

// One 1024-thread CTA per SM: with its templated staging ptxas gives the
// kernel 32 registers instead of 40, so two CTAs fit an SM, and at the
// bench shape (tile 32) that ran the same per-pair loop 17% slower than one
// (0.90 against 0.77 ms on an H100). A shared-memory carveout of a quarter
// of the SM (a 64 KB partition) holds one 37 KB CTA of a 32x32 tile and
// still several CTAs of a smaller tile.
constexpr int kSmemCarveoutPercent = 25;

template <int FMT>
cudaError_t launch(const void* stream, int64_t max_i, const int32_t* ranges,
                   int num_tiles, int tile_offset, int tiles_x, int tile_size,
                   BlendParams bp, Quant q, float* out_color,
                   float* out_trans, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      raster_fwd_kernel<FMT>, cudaFuncAttributePreferredSharedMemoryCarveout,
      kSmemCarveoutPercent);
  if (err != cudaSuccess) return err;
  const int p = tile_size * tile_size;
  const size_t smem = (size_t)kFeatures * p * sizeof(float);
  raster_fwd_kernel<FMT><<<num_tiles, p, smem, st>>>(
      stream, max_i, ranges, tile_offset, tiles_x, tile_size, bp, q,
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
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const gsplat::Quant q{lox, inv_sx, loy, inv_sy, rg_step, b_step};
  const gsplat::BlendParams bp{alpha_clamp, alpha_min, t_min};
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GSPLAT_FWD(F)                                                      \
  launch<F>(stream, max_i, ranges, num_tiles, tile_offset, tiles_x,        \
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
