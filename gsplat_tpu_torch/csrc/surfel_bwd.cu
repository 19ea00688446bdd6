// K11: the per-slot gradients of K10's surfel blend, its backward.
//
// It replaces no TPU kernel; its plain version is autograd of
// `ops/surfels.py::_walk_plain`. Tile t re-walks its list front to back
// with K10's decisions (surfel.cuh's eval_surfel) and, per pixel, the
// suffix-sum identity of K2 (raster_bwd.cu) over every map K10 writes:
//   dw    = g_C . rgb + g_N . n + g_D z
//           + g_dist (m^2 A_F + M2_F - 2 m M1_F)   (dL/dw of a pair;
//             A_F, M1_F, M2_F the pixel's final sums, K10's aux)
//   b_tot = g_C . C + g_N . N + g_D D + 2 g_dist dist + g_T T_final
//   accum = running sum of dw w over the pairs applied so far (inclusive)
//   da    = dw T_before - (b_tot - accum) / (1 - alpha)
// The distortion is sum_{j<i} w_i w_j (m_i - m_j)^2 = A_F M2_F - M1_F^2,
// so its derivative in w_i is m_i^2 A_F + M2_F - 2 m_i M1_F and in m_i
// 2 w_i (m_i A_F - M1_F): both need the final sums, a second dependency
// along the list that K2 does not have, read from K10's aux. Then per pair
//   d alpha_u = da [alpha_u < clamp]; d op = d alpha_u e;
//   d rho = -d alpha_u alpha_u / 2;
//   d z = g_D w + g_dist 2 w (m A_F - M1_F) m'(z);
// and through the intersection where the surfel term won: (u, v) = (c_0,
// c_1) / c_2, c = h_u x h_v, z = T_2 . (u, v, 1), into the 9 entries of T;
// where the filter won, rho_f = F |c - p|^2 into the centre and z = T_22.
// The colour and the normal take g_C w and g_N w.
//
// The 18 gradients of a slot (the table's columns: T, c, rgb, op, n) are
// sums over the tile's pixels: per surfel each thread sums its pixels'
// terms in registers, a warp any of whose pixels applied it reduces them
// across its lanes (blend.cuh's halving_sum: an exchange of 16 terms and
// one of 2) into one partial a warp, and after the batch the tile's sums
// add the warps' partials in warp order: no atomics, the same bits on
// every launch. Batches hold 32 surfels (the partials take 36 KB). Each
// slot lies in one tile's list, so a CTA writes only its own slots; the
// wrapper zero-fills the output, so slots past an early exit stay 0. The
// gather backward then sums each surfel's slots (K4, 9 rows at a time).
//
// What bounds it: arithmetic, about 45 FP32 operations a walked pair (the
// forward test) and 112 more an applied one (the chain through the cross
// product, the 18 pixel sums), and the reductions' shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"
#include "surfel.cuh"

namespace {

using namespace gsplat;

constexpr int PPT = kPixelsPerThread;
constexpr int kBatch = 32;
constexpr int kSums = kSurfelCols;  // 18
enum {
  G_T00 = 0, G_T01, G_T02, G_T10, G_T11, G_T12, G_T20, G_T21, G_T22,
  G_CX, G_CY, G_R, G_G, G_B, G_OP, G_NX, G_NY, G_NZ
};

// K10's maps (colour, trans, normal, depth sum, distortion, aux) and the
// gradients of the first five, by value.
struct SurfelMaps {
  const float* map[6];
  const float* grad[5];
};

// The per-pixel inputs of the backward.
struct PixelGrad {
  float gc[3], gn[3], gd, gdist;
  float af, m1f, m2f;  // the final sums
  float btot;
};

__global__ void __launch_bounds__(kMaxWarps * 32)
splat2d_blend_bwd_kernel(const float* __restrict__ table,
                         const int32_t* __restrict__ gid,
                         const int32_t* __restrict__ ranges, int64_t max_i,
                         int tiles_x, int ts, int width, int height,
                         SurfelParams sp, SurfelMaps mg,
                         float* __restrict__ dslot) {
  __shared__ StagedSurfel s_batch[kBatch];
  __shared__ __align__(16) float s_part[kMaxWarps][kBatch][kSums];
  const int tile = blockIdx.x;
  const int lin = threadIdx.x;
  const int lane = lin & 31, warp = lin >> 5;
  const int nwarps = blockDim.x >> 5;
  const int col = lin % ts;
  const int row0 = (lin / ts) * PPT;
  const int xi = (tile % tiles_x) * ts + col;
  const int yi0 = (tile / tiles_x) * ts + row0;
  const float x = (float)xi;
  const float* color = mg.map[0];
  const float* tfin = mg.map[1];
  const float* normal = mg.map[2];
  const float* dsum = mg.map[3];
  const float* dist = mg.map[4];
  const float* aux = mg.map[5];
  const float* const* grads = mg.grad;

  PixelGrad pg[PPT];
  float trans[PPT], accum[PPT];
  bool done[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int yi = yi0 + p;
    done[p] = row0 + p >= ts || xi >= width || yi >= height;
    trans[p] = 1.0f;
    accum[p] = 0.0f;
    PixelGrad& q = pg[p];
    if (done[p]) {
      q = PixelGrad{};
      continue;
    }
    const int64_t pix = (int64_t)yi * width + xi;
    float b = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      q.gc[k] = grads[0][3 * pix + k];
      q.gn[k] = grads[2][3 * pix + k];
      b += q.gc[k] * color[3 * pix + k] + q.gn[k] * normal[3 * pix + k];
    }
    q.gd = grads[3][pix];
    q.gdist = grads[4][pix];
    q.af = aux[3 * pix];
    q.m1f = aux[3 * pix + 1];
    q.m2f = aux[3 * pix + 2];
    q.btot = b + q.gd * dsum[pix] + 2.0f * q.gdist * dist[pix]
             + grads[1][pix] * tfin[pix];
  }

  const int start = ranges[tile], end = ranges[tile + 1];
  for (int b0 = start; b0 < end; b0 += kBatch) {
    bool mine = true;
#pragma unroll
    for (int p = 0; p < PPT; ++p) mine = mine && done[p];
    if (__syncthreads_and(mine)) break;
    const int n = min(kBatch, end - b0);
    if (lin < n) s_batch[lin] = stage_surfel(table, __ldg(gid + b0 + lin));
    // Every warp's partials start at 0 (lane l clears surfel l's).
#pragma unroll
    for (int k = 0; k < kSums; ++k) s_part[warp][lane][k] = 0.0f;
    __syncthreads();
    bool warp_done = __all_sync(0xffffffffu, mine);
    for (int j = 0; j < n && !warp_done; ++j) {
      const StagedSurfel s = s_batch[j];
      const SurfelGeo g = surfel_geo(s);
      float rgb[3], nv[3];
      surfel_rgb_normal(s, rgb, nv);
      float hu[3];
      column_hu(g, x, hu);
      float v[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) v[k] = 0.0f;
      bool applied = false;
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        if (done[p]) continue;
        const float y = (float)(yi0 + p);
        SurfelPair pr;
        const int out = eval_surfel(g, hu, x, y, trans[p], sp, pr);
        if (out == kSurfelStop) {
          done[p] = true;
          continue;
        }
        if (out != kSurfelApply) continue;
        applied = true;
        const PixelGrad& q = pg[p];
        const float t_before = trans[p];
        const float w = __fmul_rn(pr.alpha, t_before);
        const float m = depth_m(pr.z, sp);
        const float dw = q.gc[0] * rgb[0] + q.gc[1] * rgb[1] + q.gc[2] * rgb[2]
                         + q.gn[0] * nv[0] + q.gn[1] * nv[1] + q.gn[2] * nv[2]
                         + q.gd * pr.z
                         + q.gdist * (m * m * q.af + q.m2f - 2.0f * m * q.m1f);
        accum[p] += dw * w;
        const float da = dw * t_before
                         - (q.btot - accum[p]) / (1.0f - pr.alpha);
        trans[p] = pr.test_t;
        const float dau = pr.alpha_u < sp.alpha_clamp ? da : 0.0f;
        v[G_OP] += dau * pr.e;
        const float drho = -0.5f * dau * pr.alpha_u;
        const float dmdz = sp.m_scale * sp.near / (pr.z * pr.z);
        const float dz = q.gd * w
                         + q.gdist * 2.0f * w * (m * q.af - q.m1f) * dmdz;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          v[G_R + k] += q.gc[k] * w;
          v[G_NX + k] += q.gn[k] * w;
        }
        if (pr.surf) {
          const float gu = drho * 2.0f * pr.u + dz * g.t2[0];
          const float gv = drho * 2.0f * pr.v + dz * g.t2[1];
          v[G_T20] += dz * pr.u;
          v[G_T21] += dz * pr.v;
          v[G_T22] += dz;
          const float inv = 1.0f / pr.c[2];
          const float gc0 = gu * inv, gc1 = gv * inv;
          const float gc2 = -(gu * pr.u + gv * pr.v) * inv;
          const float* hv = pr.hv;
          // c = h_u x h_v: d h_u = h_v x g_c, d h_v = g_c x h_u.
          const float dhu[3] = {hv[1] * gc2 - hv[2] * gc1,
                                hv[2] * gc0 - hv[0] * gc2,
                                hv[0] * gc1 - hv[1] * gc0};
          const float dhv[3] = {gc1 * hu[2] - gc2 * hu[1],
                                gc2 * hu[0] - gc0 * hu[2],
                                gc0 * hu[1] - gc1 * hu[0]};
          // h_u = x T_2 - T_0, h_v = y T_2 - T_1.
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            v[G_T00 + k] -= dhu[k];
            v[G_T10 + k] -= dhv[k];
            v[G_T20 + k] += x * dhu[k] + y * dhv[k];
          }
        } else {
          const float f2 = 2.0f * sp.filter_inv_square * drho;
          v[G_CX] += f2 * pr.dx;
          v[G_CY] += f2 * pr.dy;
          v[G_T22] += dz;
        }
      }
      if (__any_sync(0xffffffffu, applied)) {
        float lo[16], hi[2];
#pragma unroll
        for (int k = 0; k < 16; ++k) lo[k] = v[k];
        hi[0] = v[16];
        hi[1] = v[17];
        const float s16 = halving_sum<16>(lo, lane);
        const float s2 = halving_sum<2>(hi, lane);
        if ((lane & 1) == 0) s_part[warp][j][lane >> 1] = s16;
        if ((lane & 15) == 0) s_part[warp][j][16 + (lane >> 4)] = s2;
      }
      mine = true;
#pragma unroll
      for (int p = 0; p < PPT; ++p) mine = mine && done[p];
      warp_done = __all_sync(0xffffffffu, mine);
    }
    __syncthreads();
    // The tile's sums, the warps' partials added in warp order.
    for (int e = lin; e < n * kSums; e += blockDim.x) {
      const int j = e / kSums, k = e - j * kSums;
      float sum = 0.0f;
      for (int wi = 0; wi < nwarps; ++wi) sum += s_part[wi][j][k];
      dslot[(int64_t)k * max_i + b0 + j] = sum;
    }
  }
}

}  // namespace

// table (N, 18); gid (max_I,) int32; ranges (num_tiles + 1,); maps: K10's
// colour, trans, normal, depth sum, distortion, aux; grads: those of the
// first five; dslot (18, max_I) float32, zero-filled by the caller.
extern "C" int gsplat_surfel_bwd(const float* table, const int32_t* gid,
                                 const int32_t* ranges, int64_t max_i,
                                 int num_tiles, int tiles_x, int ts,
                                 int width, int height, float alpha_clamp,
                                 float alpha_min, float t_min,
                                 float filter_inv_square, float near,
                                 float m_scale, const float* const* maps,
                                 const float* const* grads, float* dslot,
                                 void* cuda_stream) {
  if (ts < 1 || ts * ts > 1024) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const SurfelParams sp{alpha_clamp, alpha_min, t_min, filter_inv_square,
                        near, m_scale};
  SurfelMaps mg;
  for (int k = 0; k < 6; ++k) mg.map[k] = maps[k];
  for (int k = 0; k < 5; ++k) mg.grad[k] = grads[k];
  splat2d_blend_bwd_kernel<<<num_tiles, walk_threads(ts), 0,
                             (cudaStream_t)cuda_stream>>>(
      table, gid, ranges, max_i, tiles_x, ts, width, height, sp, mg, dslot);
  return (int)cudaGetLastError();
}
