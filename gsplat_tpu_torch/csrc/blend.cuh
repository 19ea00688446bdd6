// Per-(pixel, Gaussian) forward arithmetic shared by K1 (raster_fwd.cu) and
// K2 (raster_bwd.cu), the multi-pixel walk's layout and warp-level skip,
// and the read of one slot of the sorted stream in each stream format.
//
// K2 re-walks each tile and must make K1's skip and terminate decisions bit
// for bit: its suffix sums are b_total - (running prefix), and b_total is
// formed from K1's outputs, so a pair that one kernel applies and the other
// skips would subtract inconsistent sums. Both kernels therefore evaluate a
// pair through pair_power and eval_pair, whose products and sums are
// written with __fmul_rn/__fadd_rn/__fsub_rn so that nvcc cannot contract
// them into FMAs differently in the two translation units, and skip only
// what eval_pair would skip (power_floor). The order of operations is the
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
  float alpha;     // min(alpha_clamp, alpha_u), a NaN kept
  float test_t;    // trans * (1 - alpha): the transmittance after the pair
};

// The factors of a pair that depend on the pixel's column only: a thread
// that walks several pixels of one column forms them once per Gaussian.
struct Column {
  float dx;     // pixel centre minus Gaussian centre, x
  float adxdx;  // (a dx) dx
  float bdx;    // b dx
};

__device__ __forceinline__ Column column_terms(float xr, float gxr, float ca,
                                               float cb) {
  Column c;
  c.dx = __fsub_rn(xr, gxr);
  c.adxdx = __fmul_rn(__fmul_rn(ca, c.dx), c.dx);
  c.bdx = __fmul_rn(cb, c.dx);
  return c;
}

// A pair is evaluated in two steps, the power and then the rest, so that a
// warp can test every pixel's power against the Gaussian's power floor
// (Staged::geo2.z) and skip the exp where no pixel can reach alpha_min.
// xr, yr and gxr, gyr are relative to the tile origin, as in the plain
// version; `col` is column_terms(xr, gxr, ca, cb). The products and sums
// are those of the plain version, in its order:
//   quad = (a dx) dx + (c dy) dy;  power = -0.5 quad - (b dx) dy.
__device__ __forceinline__ float pair_power(const Column& col, float yr,
                                            float gyr, float cc, Pair& pr) {
  pr.dx = col.dx;
  pr.dy = __fsub_rn(yr, gyr);
  const float quad =
      __fadd_rn(col.adxdx, __fmul_rn(__fmul_rn(cc, pr.dy), pr.dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(col.bdx, pr.dy));
}

// The rest of the pair from its power: kSkip, kApply or kStop; `pr` is
// complete for kApply. Every term is formed before the decision is
// selected, with no branch, so that the several pixels of one thread
// evaluate side by side (their exps overlap); the terms of a skipped pair
// are never used.
__device__ __forceinline__ int eval_pair(float power, float op, float trans,
                                         const BlendParams& bp, Pair& pr) {
  pr.e = expf(fminf(power, 0.f));
  pr.alpha_u = __fmul_rn(op, pr.e);
  // A select, not fminf: fminf drops a NaN (a NaN opacity would become
  // alpha_clamp and be applied), where the plain version's clamp_max keeps
  // it and the test below then skips the pair. Same value on finite input.
  pr.alpha = pr.alpha_u > bp.alpha_clamp ? bp.alpha_clamp : pr.alpha_u;
  pr.test_t = __fmul_rn(trans, __fsub_rn(1.f, pr.alpha));
  // !(power <= 0) also skips a NaN power.
  const bool pass = power <= 0.f && pr.alpha >= bp.alpha_min;
  return pass ? (pr.test_t < bp.t_min ? kStop : kApply) : kSkip;
}

// The power floor of a Gaussian: a pair whose power (pair_power's, the
// value eval_pair takes) lies below it cannot reach alpha_min, so a warp
// none of whose live pixels reaches the floor skips the Gaussian without
// an exp. alpha_u = op e >= alpha_min needs e >= alpha_min / op, i.e.
// power >= -tau, tau = log(op / alpha_min); the floor is -tau with tau
// widened by 1e-3 for the log, exp and product roundings (below it alpha_u
// < 0.9991 alpha_min), so the skip is exact. A tau that is not finite, or
// an opacity below alpha_min, gives -inf and +inf (never and always skip:
// op e <= op < alpha_min). Its plain copy is
// gsplat_tpu_torch/ops/raster_torch.py::power_floor.
__device__ __forceinline__ float power_floor(float op, const BlendParams& bp) {
  const float inf = __int_as_float(0x7f800000);
  if (op < bp.alpha_min) return inf;
  const float tau = logf(op / bp.alpha_min) + 1e-3f;
  return tau < inf ? -tau : -inf;  // a NaN tau gives -inf
}

// A staged Gaussian: three 16-byte records in shared memory. The walk reads
// the geometry (two loads) for every pixel's power, and the colour only
// where it goes on to evaluate the pair.
struct Staged {
  float4 geo;   // gxr, gyr, ca, cb
  float4 geo2;  // cc, op, power floor, 0
  float4 rgb;   // r, g, b, 0
};

// The staged record of a slot's features v (load_slot's), for the tile at
// origin (ox, oy).
__device__ __forceinline__ Staged stage(const float v[kFeatures], float ox,
                                        float oy, const BlendParams& bp) {
  Staged g;
  g.geo = make_float4(__fsub_rn(v[F_GX], ox), __fsub_rn(v[F_GY], oy),
                      v[F_CA], v[F_CB]);
  g.geo2 = make_float4(v[F_CC], v[F_OP], power_floor(v[F_OP], bp), 0.f);
  g.rgb = make_float4(v[F_R], v[F_G], v[F_B], 0.f);
  return g;
}

// Stage slot s of the stream for the tile at origin (ox, oy).
template <int FMT>
__device__ __forceinline__ Staged stage_slot(const void* stream, int64_t max_i,
                                             int64_t s, const Quant& q,
                                             float ox, float oy,
                                             const BlendParams& bp) {
  float v[kFeatures];
  load_slot<FMT>(stream, max_i, s, q, v);
  return stage(v, ox, oy, bp);
}

// The multi-pixel walk of K1 and K2. Thread `lin` of a tile owns
// kPixelsPerThread pixels of one column, x = lin % ts and rows
// (lin / ts) kPixelsPerThread ... + kPixelsPerThread - 1 (those past the
// tile are never live): a 32x32 tile is 512 threads, each warp a 32x2
// strip; an 8x8 tile is one warp.
constexpr int kPixelsPerThread = 2;

// Threads of the walk of a ts x ts tile, in whole warps.
__host__ __device__ constexpr int walk_threads(int ts) {
  return (ts * ((ts + kPixelsPerThread - 1) / kPixelsPerThread) + 31) / 32 *
         32;
}

// Warps of the largest tile, 32x32.
constexpr int kMaxWarps = walk_threads(32) / 32;

// The warp's sums of N values per lane (N a power of two up to 32), in a
// halving exchange: at xor 16, 8, ... a lane keeps half of its values and
// trades the other half with its partner, then the last value is summed in
// a butterfly. N - 1 + (5 - log2 N) shuffles; lane l returns the sum of
// value l / (32 / N), and the two lanes of each exchange add in the same
// order, so every lane's result is a fixed function of the inputs.
template <int N>
__device__ __forceinline__ float halving_sum(float (&v)[N], int lane) {
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int half = N * off / 32;  // values kept at this step (0: one left)
    if (half > 0) {
      const bool hi = lane & off;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float keep = hi ? v[i + half] : v[i];
        const float send = hi ? v[i] : v[i + half];
        v[i] = keep + __shfl_xor_sync(full, send, off);
      }
    } else {
      v[0] += __shfl_xor_sync(full, v[0], off);
    }
  }
  return v[0];
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
