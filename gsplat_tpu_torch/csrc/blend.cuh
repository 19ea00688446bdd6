// Per-(pixel, Gaussian) forward arithmetic shared by K1 (raster_fwd.cu) and
// K2 (raster_bwd.cu).
//
// K2 re-walks each tile and must make K1's skip and terminate decisions bit
// for bit: its suffix sums are b_total - (running prefix), and b_total is
// formed from K1's outputs, so a pair that one kernel applies and the other
// skips would subtract inconsistent sums. Both kernels therefore evaluate a
// pair through this one function, whose products and sums are written with
// __fmul_rn/__fadd_rn/__fsub_rn so that nvcc cannot contract them into FMAs
// differently in the two translation units. The order of operations is the
// plain version's (gsplat_tpu_torch/ops/blend.py::_block_weights):
//   power = -0.5 ((a dx) dx + (c dy) dy) - (b dx) dy, skip unless power <= 0;
//   alpha = min(clamp, op * exp(min(power, 0))), skip unless alpha >= min;
//   test_t = T (1 - alpha); stop the pixel when test_t < t_min.

#pragma once

#include <cuda_runtime.h>

namespace gsplat {

constexpr int kFeatures = 9;
enum { F_GX, F_GY, F_CA, F_CB, F_CC, F_R, F_G, F_B, F_OP };

enum PairOutcome { kSkip = 0, kApply = 1, kStop = 2 };

struct BlendParams {
  float alpha_clamp;
  float alpha_min;
  float t_min;
};

// The terms of one evaluated pair that the backward re-uses.
struct Pair {
  float dx, dy;    // pixel centre minus Gaussian centre
  float e;         // exp(min(power, 0))
  float alpha_u;   // opacity * e, before the clamp
  float alpha;     // min(alpha_clamp, alpha_u)
  float test_t;    // trans * (1 - alpha): the transmittance after the pair
};

// xr, yr and gxr, gyr are relative to the tile origin, as in the plain
// version. Returns kSkip, kApply or kStop; `pr` is complete for kApply.
__device__ __forceinline__ int eval_pair(float xr, float yr, float gxr,
                                         float gyr, float ca, float cb,
                                         float cc, float op, float trans,
                                         const BlendParams& bp, Pair& pr) {
  pr.dx = __fsub_rn(xr, gxr);
  pr.dy = __fsub_rn(yr, gyr);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, pr.dx), pr.dx),
                               __fmul_rn(__fmul_rn(cc, pr.dy), pr.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(cb, pr.dx), pr.dy));
  if (!(power <= 0.f)) return kSkip;  // also skips a NaN power
  pr.e = expf(fminf(power, 0.f));
  pr.alpha_u = __fmul_rn(op, pr.e);
  pr.alpha = fminf(bp.alpha_clamp, pr.alpha_u);
  if (!(pr.alpha >= bp.alpha_min)) return kSkip;
  pr.test_t = __fmul_rn(trans, __fsub_rn(1.f, pr.alpha));
  if (pr.test_t < bp.t_min) return kStop;
  return kApply;
}

}  // namespace gsplat
