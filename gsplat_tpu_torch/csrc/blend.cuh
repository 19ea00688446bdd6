// Per-(pixel, Gaussian) forward arithmetic shared by K1 (raster_fwd.cu) and
// K2 (raster_bwd.cu), and the read of one slot of the sorted stream in each
// stream format.
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
//
// Stream formats (gsplat_tpu_torch/ops/stream16.py, the port of
// gsplat_tpu/ops/stream16.py): kF32 is the (9, max_I) float32 stream;
// kPacked16 and kPacked4 are int32 rows, unpacked by load_slot as
// stream16.py::unpack_block unpacks them, product then sum with
// __fmul_rn/__fadd_rn (no FMA), so the kernels blend the same float32
// values as the plain version:
//   row 0: gx | gy << 16, u16 fixed point: g = q * inv_s + lo;
//   kPacked16 rows 1-4: bf16 pairs (ca|cb), (cc|r), (g|b), (op|0);
//   kPacked4 rows 1-2: bf16 pairs (ca|cb), (cc|op); row 3: r, g, b as
//   11/11/10-bit fixed point, c = q * step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gsplat {

constexpr int kFeatures = 9;
enum { F_GX, F_GY, F_CA, F_CB, F_CC, F_R, F_G, F_B, F_OP };

enum StreamFormat { kF32 = 0, kPacked16 = 1, kPacked4 = 2 };

// The dequantisation constants of stream16.py::quant_params and
// PACKED4_COLOR_RANGE, as the float32 values the plain version multiplies
// and adds.
struct Quant {
  float lox, inv_sx, loy, inv_sy;
  float rg_step, b_step;  // packed4 colours: range / 2047, range / 1023
};

__device__ __forceinline__ float lo_half(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_half(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// The 9 float32 features (F_* order) of slot s of a stream of format FMT
// whose rows are max_i apart. Packed words stay integers; only their
// unpacked halves are floats.
template <int FMT>
__device__ __forceinline__ void load_slot(const void* stream, int64_t max_i,
                                          int64_t s, const Quant& q,
                                          float v[kFeatures]) {
  if (FMT == kF32) {
    const float* f = static_cast<const float*>(stream);
#pragma unroll
    for (int i = 0; i < kFeatures; ++i) v[i] = f[i * max_i + s];
    return;
  }
  const uint32_t* w = static_cast<const uint32_t*>(stream);
  const uint32_t w0 = w[s], w1 = w[max_i + s], w2 = w[2 * max_i + s],
                 w3 = w[3 * max_i + s];
  v[F_GX] = __fadd_rn(__fmul_rn((float)(int)(w0 & 0xFFFFu), q.inv_sx), q.lox);
  v[F_GY] = __fadd_rn(__fmul_rn((float)(int)(w0 >> 16), q.inv_sy), q.loy);
  v[F_CA] = lo_half(w1);
  v[F_CB] = hi_half(w1);
  v[F_CC] = lo_half(w2);
  if (FMT == kPacked16) {
    const uint32_t w4 = w[4 * max_i + s];
    v[F_R] = hi_half(w2);
    v[F_G] = lo_half(w3);
    v[F_B] = hi_half(w3);
    v[F_OP] = lo_half(w4);
  } else {
    v[F_OP] = hi_half(w2);
    v[F_R] = __fmul_rn((float)(int)(w3 & 0x7FFu), q.rg_step);
    v[F_G] = __fmul_rn((float)(int)((w3 >> 11) & 0x7FFu), q.rg_step);
    v[F_B] = __fmul_rn((float)(int)((w3 >> 22) & 0x3FFu), q.b_step);
  }
}

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

// One int32 bf16 pair (gsplat_tpu_torch/ops/bf16_pairs.py): lo in the low
// 16 bits, hi in the high, each rounded to nearest even (for finite values
// the TPU kernels' _rne_bf16_bits).
__device__ __forceinline__ int32_t pack_pair(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return (int32_t)(l | (h << 16));
}

}  // namespace gsplat
