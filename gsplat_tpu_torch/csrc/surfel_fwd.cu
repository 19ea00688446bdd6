// K10: the blend of 2D Gaussian splatting's surfels (Huang et al. 2024,
// arXiv:2403.17888): per pixel, front to back over its tile's list, the
// ray-splat intersection with the object-space low-pass filter
// (surfel.cuh's eval_surfel), accumulating the colour, the normal map
// sum w n, the depth sum sum w z and the distortion
// sum_i w_i (m_i^2 A_i + M2_i - 2 m_i M1_i), A, M1, M2 the running sums of
// w, w m and w m^2 over the pairs before (the authors' one-walk form of
// sum_{j<i} w_i w_j (m_i - m_j)^2).
//
// It replaces no TPU kernel. Its plain version is
// `ops/surfels.py::_walk_plain`. The surfels are read from the (N, 18)
// float32 table (ops/surfels.py::surfel_table) by each slot's id.
//
// Design: one CTA a tile, blend.cuh's walk layout (2 pixels of a column a
// thread, 512 threads at tile 32); a batch of one surfel a thread is staged
// in shared memory as five 16-byte records, then every thread walks it for
// its pixels, the column's h_u formed once a surfel. A pixel outside the
// image is done from the start; the CTA leaves the list when every pixel
// is. Outputs, image-shaped: colour (H, W, 3), final transmittance (H, W),
// normal sum (H, W, 3), depth sum (H, W), distortion (H, W), and for K11
// the final (A, M1, M2) (H, W, 3).
//
// What bounds it: arithmetic, about 45 FP32 operations a walked pair and
// 29 more an applied one; its bytes are the table rows of the slots, the
// ids and the maps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"
#include "surfel.cuh"

namespace {

using namespace gsplat;

constexpr int PPT = kPixelsPerThread;

__global__ void __launch_bounds__(kMaxWarps * 32)
splat2d_blend_fwd_kernel(const float* __restrict__ table,
                         const int32_t* __restrict__ gid,
                         const int32_t* __restrict__ ranges, int tiles_x,
                         int ts, int width, int height, SurfelParams sp,
                         float* __restrict__ out_color,
                         float* __restrict__ out_trans,
                         float* __restrict__ out_normal,
                         float* __restrict__ out_dsum,
                         float* __restrict__ out_dist,
                         float* __restrict__ out_aux) {
  extern __shared__ StagedSurfel s_batch[];
  const int tile = blockIdx.x;
  const int lin = threadIdx.x;
  const int nthreads = blockDim.x;
  const int col = lin % ts;
  const int row0 = (lin / ts) * PPT;
  const int xi = (tile % tiles_x) * ts + col;
  const int yi0 = (tile / tiles_x) * ts + row0;
  const float x = (float)xi;

  float trans[PPT], rgb[PPT][3], nrm[PPT][3], dsum[PPT], dist[PPT];
  float acc[PPT], m1[PPT], m2[PPT];
  bool done[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    trans[p] = 1.0f;
    dsum[p] = dist[p] = acc[p] = m1[p] = m2[p] = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[p][k] = nrm[p][k] = 0.0f;
    done[p] = row0 + p >= ts || xi >= width || yi0 + p >= height;
  }

  const int start = ranges[tile], end = ranges[tile + 1];
  for (int b0 = start; b0 < end; b0 += nthreads) {
    bool mine = true;
#pragma unroll
    for (int p = 0; p < PPT; ++p) mine = mine && done[p];
    // Barrier before the batch overwrites shared memory; the CTA leaves
    // when every pixel is done.
    if (__syncthreads_and(mine)) break;
    const int n = min(nthreads, end - b0);
    if (lin < n) s_batch[lin] = stage_surfel(table, __ldg(gid + b0 + lin));
    __syncthreads();
    for (int j = 0; j < n && !mine; ++j) {
      const StagedSurfel st = s_batch[j];
      const SurfelGeo g = surfel_geo(st);
      float rgbj[3], nj[3];
      surfel_rgb_normal(st, rgbj, nj);
      float hu[3];
      column_hu(g, x, hu);
      mine = true;
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        if (!done[p]) {
          SurfelPair pr;
          const int out = eval_surfel(g, hu, x, (float)(yi0 + p), trans[p],
                                      sp, pr);
          if (out == kSurfelStop) {
            done[p] = true;
          } else if (out == kSurfelApply) {
            const float w = __fmul_rn(pr.alpha, trans[p]);
            const float m = depth_m(pr.z, sp);
            const float wm = __fmul_rn(w, m);
            dist[p] = __fadd_rn(
                dist[p],
                __fmul_rn(w, __fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(m, m),
                                                           acc[p]),
                                                 m2[p]),
                                       __fmul_rn(__fmul_rn(2.0f, m), m1[p]))));
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              rgb[p][k] = __fadd_rn(rgb[p][k], __fmul_rn(w, rgbj[k]));
              nrm[p][k] = __fadd_rn(nrm[p][k], __fmul_rn(w, nj[k]));
            }
            dsum[p] = __fadd_rn(dsum[p], __fmul_rn(w, pr.z));
            acc[p] = __fadd_rn(acc[p], w);
            m1[p] = __fadd_rn(m1[p], wm);
            m2[p] = __fadd_rn(m2[p], __fmul_rn(wm, m));
            trans[p] = pr.test_t;
          }
        }
        mine = mine && done[p];
      }
    }
  }

#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int yi = yi0 + p;
    if (row0 + p >= ts || xi >= width || yi >= height) continue;
    const int64_t pix = (int64_t)yi * width + xi;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      out_color[3 * pix + k] = rgb[p][k];
      out_normal[3 * pix + k] = nrm[p][k];
    }
    out_trans[pix] = trans[p];
    out_dsum[pix] = dsum[p];
    out_dist[pix] = dist[p];
    out_aux[3 * pix] = acc[p];
    out_aux[3 * pix + 1] = m1[p];
    out_aux[3 * pix + 2] = m2[p];
  }
}

}  // namespace

// table (N, 18) float32; gid (max_I,) int32; ranges (num_tiles + 1,);
// out: colour, trans, normal, depth sum, distortion, aux (A, M1, M2).
extern "C" int gsplat_surfel_fwd(const float* table, const int32_t* gid,
                                 const int32_t* ranges, int num_tiles,
                                 int tiles_x, int ts, int width, int height,
                                 float alpha_clamp, float alpha_min,
                                 float t_min, float filter_inv_square,
                                 float near, float m_scale,
                                 float* const* out, void* cuda_stream) {
  if (ts < 1 || ts * ts > 1024) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const int threads = walk_threads(ts);
  const SurfelParams sp{alpha_clamp, alpha_min, t_min, filter_inv_square,
                        near, m_scale};
  splat2d_blend_fwd_kernel<<<num_tiles, threads,
                             threads * sizeof(StagedSurfel),
                             (cudaStream_t)cuda_stream>>>(
      table, gid, ranges, tiles_x, ts, width, height, sp, out[0], out[1],
      out[2], out[3], out[4], out[5]);
  return (int)cudaGetLastError();
}
