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
// as in K2. da is linear in the channels' gradients: it is the sum over any
// split of the channels of the same expression taken over each part. So the
// feature channels are taken in chunks of 64, one pass of the walk per
// chunk (the colour in the first), each adding its share of da's terms to
// the slot sums: one walk's decisions (blend.cuh's eval_pair, K1's and K6's)
// in every pass, and no pass needs more than its chunk of g_F in registers.
//
// Layout: one CTA per tile (the slot sums need every pixel of it), 512
// threads of one pixel each (a chunk of g_F takes 64 registers a pixel, so
// a 32x32 tile is walked in two passes of 512 pixels), batches of 32
// Gaussians staged in shared memory with their chunk of features. Per
// Gaussian a thread takes the dot product g_F . f of its pixel from
// registers; a warp any of whose pixels applies the Gaussian sums the 9
// slot terms across its lanes as K2 does (blend.cuh's halving exchange),
// and the feature gradient sum_p g_F(p) w(p) with a lane per channel (two
// per lane), over the pixels that applied it alone (the warp's ballot),
// reading the pixels' g_F from a shared copy of the pass's chunk. A pass
// adds its 9 slot sums, chained into the stream features' gradients, to
// `dgeo` (9, max_I) float32, which the wrapper zero-fills: the warps'
// partials in warp order, and the same thread adds to the same slot in
// every pass, in pass order, so they are deterministic. The feature sums
// of the warps meet in shared memory by atomic adds and go onto each
// Gaussian's row of `dfeat` (N, C) float32 by one atomic add per (slot,
// channel) with a nonzero sum: the feature gradient is summed in the order
// the card runs it, not bit for bit the same from run to run.
//
// What bounds it: arithmetic, K2's work per walked and applied pair in each
// chunk's pass, plus 4 C FP32 operations per applied pair (the dot product
// g_F . f and the products g_F w), against reads of g_F and F_final (1 GB
// each at 1080p and C = 128) and the feature table.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"

namespace {

using namespace gsplat;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;
constexpr int kChunk = 64;
constexpr int kPerLane = kChunk / 32;  // channels a lane sums
constexpr int kSums = 9;
enum { S_DX, S_DY, S_DXX, S_DXY, S_DYY, S_R, S_G, S_B, S_OP };

struct Smem {
  Staged batch[kBatch];
  float f[kBatch][kChunk];
  float part[kWarps][kBatch][kSums];
  float fsum[kBatch][kChunk];
  float gf[kWarps][32][kChunk + 1];  // the pass's g_F, a row a pixel
};

template <int FMT>
__global__ void __launch_bounds__(kThreads, 1)
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const unsigned full = 0xffffffffu;
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  const int nwarps = blockDim.x >> 5;
  const int t = blockIdx.x;
  const int p = ts * ts;
  const int gt = t + tile_offset;
  const int tx0 = (gt % tiles_x) * ts;
  const int ty0 = (gt / tiles_x) * ts;
  const float ox = (float)tx0;
  const float oy = (float)ty0;
  const int start = ranges[t];
  const int end = ranges[t + 1];
  const int chunks = (channels + kChunk - 1) / kChunk;
  const int halves = (p + blockDim.x - 1) / blockDim.x;

  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int c0 = chunk * kChunk;
    for (int h = 0; h < halves; ++h) {
      const int pix = h * blockDim.x + lin;
      bool live = pix < p;
      const int x = live ? pix % ts : 0;
      const int y = live ? pix / ts : 0;
      const float xr = (float)x, yr = (float)y;
      const bool in_img = live && tx0 + x < width && ty0 + y < height;
      // This pixel's chunk of g_F, and its share of b_total.
      float gf[kChunk];
      float bt = 0.f;
      const int64_t at = ((int64_t)(ty0 + y) * width + tx0 + x) * channels + c0;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const bool ok = in_img && c0 + c < channels;
        gf[c] = ok ? g_feat[at + c] : 0.f;
        bt += ok ? gf[c] * f_final[at + c] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) sm.gf[warp][lane][c] = gf[c];
      float g0 = 0.f, g1 = 0.f, g2 = 0.f;
      if (chunk == 0 && live) {
        const float* gc = g_color + (int64_t)t * 3 * p;
        g0 = gc[pix];
        g1 = gc[p + pix];
        g2 = gc[2 * p + pix];
        bt += b_total[(int64_t)t * p + pix];
      }
      float trans = 1.f, accum_b = 0.f;
      int done = !live;
      for (int b0 = start; b0 < end; b0 += kBatch) {
        if (__syncthreads_and(done)) break;
        const int n = min(kBatch, end - b0);
        for (int i = lin; i < n; i += blockDim.x)
          sm.batch[i] =
              stage_slot<FMT>(stream, max_i, (int64_t)b0 + i, q, ox, oy, bp);
        for (int i = lin; i < n * kChunk; i += blockDim.x) {
          const int j = i / kChunk, c = i % kChunk;
          sm.f[j][c] = c0 + c < channels
                           ? feat[(int64_t)gid[b0 + j] * channels + c0 + c]
                           : 0.f;
        }
        for (int i = lin; i < kBatch * kChunk; i += blockDim.x)
          (&sm.fsum[0][0])[i] = 0.f;
        {
          float4* part = reinterpret_cast<float4*>(&sm.part[warp][0][0]);
          for (int i = lane; i < kSums * kBatch / 4; i += 32)
            part[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const bool took_part = __any_sync(full, !done);
        __syncthreads();
        for (int j = 0; took_part && j < n; ++j) {
          const float4 geo = sm.batch[j].geo;
          const float4 geo2 = sm.batch[j].geo2;
          const Column col = column_terms(xr, geo.x, geo.z, geo.w);
          Pair r;
          const float power = pair_power(col, yr, geo.y, geo2.x, r);
          float v[8], v8[1] = {0.f};
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = 0.f;
          bool app = false;
          float w_app = 0.f;
          if (live && power >= geo2.z) {  // else the pair skips: no exp
            const int outcome = eval_pair(power, geo2.y, trans, bp, r);
            app = outcome == kApply;
            live = outcome != kStop;
            const float4 rgb = sm.batch[j].rgb;
            const float w = __fmul_rn(r.alpha, trans);
            float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int c = 0; c < kChunk; c += 4) {
              const float4 f = *reinterpret_cast<const float4*>(&sm.f[j][c]);
              dot[0] = fmaf(gf[c], f.x, dot[0]);
              dot[1] = fmaf(gf[c + 1], f.y, dot[1]);
              dot[2] = fmaf(gf[c + 2], f.z, dot[2]);
              dot[3] = fmaf(gf[c + 3], f.w, dot[3]);
            }
            const float dwf = (dot[0] + dot[1]) + (dot[2] + dot[3]);
            const float dw = g0 * rgb.x + g1 * rgb.y + g2 * rgb.z + dwf;
            const float acc = accum_b + dw * w;
            const float da = dw * trans - (bt - acc) / (1.f - r.alpha);
            const bool grad = app && r.alpha_u < bp.alpha_clamp;
            const float dpower = da * r.alpha_u;
            const float px = dpower * r.dx;
            const float py = dpower * r.dy;
            v[S_DX] = grad ? px : 0.f;
            v[S_DY] = grad ? py : 0.f;
            v[S_DXX] = grad ? px * r.dx : 0.f;
            v[S_DXY] = grad ? px * r.dy : 0.f;
            v[S_DYY] = grad ? py * r.dy : 0.f;
            v[S_R] = app ? g0 * w : 0.f;
            v[S_G] = app ? g1 * w : 0.f;
            v[S_B] = app ? g2 * w : 0.f;
            v8[0] = grad ? da * r.e : 0.f;
            w_app = app ? w : 0.f;
            accum_b = app ? acc : accum_b;
            trans = app ? r.test_t : trans;
          }
          if (__any_sync(full, app)) {  // warp-uniform
            const float s = halving_sum<8>(v, lane);
            const float s8 = halving_sum<1>(v8, lane);
            if (lane % 4 == 0) sm.part[warp][j][lane / 4] = s;
            if (lane == 0) sm.part[warp][j][S_OP] = s8;
            // sum_p g_F(p) w(p) over the warp's applying pixels, in pixel
            // order; lane l takes channels l, l + 32, ...
            float fs[kPerLane];
#pragma unroll
            for (int k = 0; k < kPerLane; ++k) fs[k] = 0.f;
            for (unsigned m = __ballot_sync(full, app); m; m &= m - 1) {
              const int q = __ffs(m) - 1;
              const float wq = __shfl_sync(full, w_app, q);
#pragma unroll
              for (int k = 0; k < kPerLane; ++k)
                fs[k] = fmaf(wq, sm.gf[warp][q][lane + 32 * k], fs[k]);
            }
#pragma unroll
            for (int k = 0; k < kPerLane; ++k)
              if (fs[k] != 0.f) atomicAdd(&sm.fsum[j][lane + 32 * k], fs[k]);
          }
          done = !live;
          if (__all_sync(full, done)) break;
        }
        __syncthreads();
        // The pass's slot sums: the warps' partials in warp order, chained
        // per Gaussian and added to the slot's gradients.
        for (int j = lin; j < n; j += blockDim.x) {
          float sum[kSums];
#pragma unroll
          for (int k = 0; k < kSums; ++k) sum[k] = 0.f;
          for (int w = 0; w < nwarps; ++w) {
#pragma unroll
            for (int k = 0; k < kSums; ++k) sum[k] += sm.part[w][j][k];
          }
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
          for (int f = 0; f < kFeatures; ++f) dgeo[f * max_i + s] += d[f];
        }
        for (int i = lin; i < n * kChunk; i += blockDim.x) {
          const int j = i / kChunk, c = i % kChunk;
          const float sum = sm.fsum[j][c];
          if (c0 + c < channels && sum != 0.f)
            atomicAdd(&dfeat[(int64_t)gid[b0 + j] * channels + c0 + c], sum);
        }
      }
    }
  }
}

template <int FMT>
cudaError_t launch(const void* stream, int64_t max_i, const int32_t* ranges,
                   const int32_t* gid, const float* feat, int channels,
                   int num_tiles, const float* g_color, const float* b_total,
                   const float* g_feat, const float* f_final, int tile_offset,
                   int tiles_x, int tile_size, int width, int height,
                   BlendParams bp, Quant q, float* dgeo, float* dfeat,
                   cudaStream_t st) {
  // The shared memory passes the 48 KB a launch gets by default: asked for
  // once per format, before any launch (so never inside a capture).
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        feat_bwd_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int p = tile_size * tile_size;
  const int threads = min(kThreads, (p + 31) / 32 * 32);
  feat_bwd_kernel<FMT><<<num_tiles, threads, sizeof(Smem), st>>>(
      stream, max_i, ranges, gid, feat, channels, g_color, b_total, g_feat,
      f_final, tile_offset, tiles_x, tile_size, width, height, bp, q, dgeo,
      dfeat);
  return cudaGetLastError();
}

}  // namespace

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
  launch<F>(stream, max_i, ranges, gid, feat, channels, num_tiles, g_color, \
            b_total, g_feat, f_final, tile_offset, tiles_x, tile_size,      \
            width, height, bp, q, dgeo, dfeat, st)
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
