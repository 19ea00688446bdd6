// The ray-splat pair arithmetic of 2D Gaussian splatting shared by K10
// (surfel_fwd.cu) and K11 (surfel_bwd.cu), and their staged surfel record.
//
// K11 re-walks each tile and must make K10's skip and stop decisions bit
// for bit (its suffix sums start from K10's outputs), so both evaluate a
// pair through eval_surfel, whose products, sums and quotients are
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: nvcc contracts none of
// them into an FMA, in either translation unit. The order of operations
// is the plain version's (gsplat_tpu_torch/ops/surfels.py::_pair_terms):
//   h_u = x T_2 - T_0, h_v = y T_2 - T_1, c = h_u x h_v;
//   rho_f = F ((c_x - x)^2 + (c_y - y)^2);
//   the surfel term wins where c_2 != 0 and c_0^2 + c_1^2 <= rho_f c_2^2:
//   u = c_0 / c_2, v = c_1 / c_2, rho = u^2 + v^2, z = (u T_20 + v T_21) +
//   T_22; else rho = rho_f, z = T_22;
//   alpha = min(clamp, op exp(-rho / 2)); skip unless z >= near and alpha
//   >= alpha_min; test_t = T (1 - alpha); stop the pixel where test_t <
//   t_min.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gsplat {

// Columns of the surfel table (ops/surfels.py): T (9, row-major), c (2),
// the colour (3), the opacity, the normal (3).
constexpr int kSurfelCols = 18;

// A surfel staged in shared memory as five 16-byte records, its table row
// in order: (T00 T01 T02 T10) (T11 T12 T20 T21) (T22 cx cy r) (g b op nx)
// (ny nz 0 0).
struct StagedSurfel {
  float4 q[5];
};

__device__ __forceinline__ StagedSurfel stage_surfel(
    const float* __restrict__ table, int64_t gid) {
  const float2* row = reinterpret_cast<const float2*>(table + gid * kSurfelCols);
  float v[20];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float2 p = __ldg(row + k);
    v[2 * k] = p.x;
    v[2 * k + 1] = p.y;
  }
  v[18] = v[19] = 0.0f;
  StagedSurfel s;
#pragma unroll
  for (int k = 0; k < 5; ++k)
    s.q[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  return s;
}

struct SurfelParams {
  float alpha_clamp;
  float alpha_min;
  float t_min;
  float filter_inv_square;
  float near;       // pairs nearer than this are skipped
  float m_scale;    // far / (far - near): m = m_scale (1 - near / z)
};

// The surfel's homography rows and centre, read from a staged record.
struct SurfelGeo {
  float t0[3], t1[3], t2[3];
  float cx, cy, op;
};

__device__ __forceinline__ SurfelGeo surfel_geo(const StagedSurfel& s) {
  SurfelGeo g;
  g.t0[0] = s.q[0].x; g.t0[1] = s.q[0].y; g.t0[2] = s.q[0].z;
  g.t1[0] = s.q[0].w; g.t1[1] = s.q[1].x; g.t1[2] = s.q[1].y;
  g.t2[0] = s.q[1].z; g.t2[1] = s.q[1].w; g.t2[2] = s.q[2].x;
  g.cx = s.q[2].y; g.cy = s.q[2].z; g.op = s.q[3].z;
  return g;
}

// The colour and the normal of a staged surfel.
__device__ __forceinline__ void surfel_rgb_normal(const StagedSurfel& s,
                                                  float rgb[3], float n[3]) {
  rgb[0] = s.q[2].w; rgb[1] = s.q[3].x; rgb[2] = s.q[3].y;
  n[0] = s.q[3].w; n[1] = s.q[4].x; n[2] = s.q[4].y;
}

// h_u = x T_2 - T_0: the terms of a pair that depend on its column only.
__device__ __forceinline__ void column_hu(const SurfelGeo& g, float x,
                                          float hu[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) hu[k] = __fsub_rn(__fmul_rn(x, g.t2[k]), g.t0[k]);
}

enum SurfelOutcome { kSurfelSkip = 0, kSurfelApply = 1, kSurfelStop = 2 };

// One evaluated pair: every term the backward re-uses.
struct SurfelPair {
  float hv[3], c[3];
  float u, v, dx, dy;
  bool surf;       // the surfel term won over the filter
  float z;         // the pair's depth
  float e;         // exp(-rho / 2)
  float alpha_u;   // op e, before the clamp
  float alpha;
  float test_t;
};

__device__ __forceinline__ int eval_surfel(const SurfelGeo& g,
                                           const float hu[3], float x,
                                           float y, float trans,
                                           const SurfelParams& sp,
                                           SurfelPair& pr) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    pr.hv[k] = __fsub_rn(__fmul_rn(y, g.t2[k]), g.t1[k]);
  pr.c[0] = __fsub_rn(__fmul_rn(hu[1], pr.hv[2]), __fmul_rn(hu[2], pr.hv[1]));
  pr.c[1] = __fsub_rn(__fmul_rn(hu[2], pr.hv[0]), __fmul_rn(hu[0], pr.hv[2]));
  pr.c[2] = __fsub_rn(__fmul_rn(hu[0], pr.hv[1]), __fmul_rn(hu[1], pr.hv[0]));
  pr.dx = __fsub_rn(g.cx, x);
  pr.dy = __fsub_rn(g.cy, y);
  const float rho_f = __fmul_rn(
      sp.filter_inv_square,
      __fadd_rn(__fmul_rn(pr.dx, pr.dx), __fmul_rn(pr.dy, pr.dy)));
  const float ss = __fadd_rn(__fmul_rn(pr.c[0], pr.c[0]),
                             __fmul_rn(pr.c[1], pr.c[1]));
  pr.surf = pr.c[2] != 0.0f &&
            ss <= __fmul_rn(rho_f, __fmul_rn(pr.c[2], pr.c[2]));
  float rho;
  if (pr.surf) {
    pr.u = __fdiv_rn(pr.c[0], pr.c[2]);
    pr.v = __fdiv_rn(pr.c[1], pr.c[2]);
    rho = __fadd_rn(__fmul_rn(pr.u, pr.u), __fmul_rn(pr.v, pr.v));
    pr.z = __fadd_rn(__fadd_rn(__fmul_rn(pr.u, g.t2[0]), __fmul_rn(pr.v, g.t2[1])),
                     g.t2[2]);
  } else {
    pr.u = pr.v = 0.0f;
    rho = rho_f;
    pr.z = g.t2[2];
  }
  pr.e = expf(__fmul_rn(-0.5f, rho));
  pr.alpha_u = __fmul_rn(g.op, pr.e);
  pr.alpha = pr.alpha_u > sp.alpha_clamp ? sp.alpha_clamp : pr.alpha_u;
  pr.test_t = __fmul_rn(trans, __fsub_rn(1.0f, pr.alpha));
  const bool pass = pr.z >= sp.near && pr.alpha >= sp.alpha_min;
  return pass ? (pr.test_t < sp.t_min ? kSurfelStop : kSurfelApply)
              : kSurfelSkip;
}

// The distortion's depth in [0, 1].
__device__ __forceinline__ float depth_m(float z, const SurfelParams& sp) {
  return __fmul_rn(sp.m_scale, __fsub_rn(1.0f, __fdiv_rn(sp.near, z)));
}

}  // namespace gsplat
