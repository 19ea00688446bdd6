// P1: the transcendental-cost probe, elementwise over float32 x <= 0.
//
// Replaces the TPU kernel scripts/micro_kernel_costs.py::_transc_kernel
// (pallas_call at :96, in bench_transc). Four modes, each the same chain of
// the blend's inner loop:
//   mults   e = x x + x;  l = 1 - 0.5 e;  out = e + l l  (multiplies only)
//   exact   e = exp(x);   l = log1p(-0.5 e);  out = e + l
//   exact3  e = exp(x);   l = log1p(-0.5 e);  out = exp(l) + e  (2 exp, 1 log1p)
//   fast3   exact3 with fast_exp and fast_log1p_neg, the script's bit-trick
//           polynomials (:62, :76)
// What it answers on this card: what precise expf / log1pf cost against
// multiplies, since K1 and K2 evaluate the same expf per pixel-Gaussian pair
// (csrc/blend.cuh).
//
// What bounds it on an H100: bytes. At the script's shape (524,288 x 1,024,
// 2^29 elements) it must read and write 2 GiB each, 4.295e9 bytes, 1.282 ms
// at 3.35 TB/s. The FP32 operations per element, counted in the SASS of
// this file (scripts/probe_kernel_report.py: FADD, FMUL, FMNMX, FRND and 2 x
// FFMA of the kernel over the 17 elements of its loop and tail), are 7.4
// (mults), 44.7 (exact), 55.9 (exact3) and 40.2 (fast3), at most 0.45 ms at
// 67 TFLOP/s; exact and exact3 also issue 1.2 and 2.4 MUFU per element, at
// most 0.31 ms at the SFU rate (16 per SM per clock). So every mode is bound
// by bytes, and the probe shows transcendental cost only where it no longer
// hides under the memory stream. Design: a grid-stride loop over float4 (16-byte)
// loads and stores, four independent loads in flight per thread, one block
// of 256 threads for each 256 threads an SM holds (8 per SM); the mode is a
// template parameter. A tail of n mod 4 elements is done one by one.
//
// Exactness: exact and exact3 call the precise expf and log1pf (no __expf,
// no fast-math), as K1 does. mults and fast3 are written with __fmul_rn,
// __fadd_rn and __fsub_rn, which nvcc never contracts into FMAs, in the
// operation order of the plain PyTorch version
// (gsplat_tpu_torch/ops/cuda/probes.py::transc_plain), with its float32
// constants written as exact hex literals, so they equal it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kMults = 0, kExact = 1, kExact3 = 2, kFast3 = 3 };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// micro_kernel_costs.py::fast_exp: exp2 split into exponent and fraction.
__device__ __forceinline__ float fast_exp(float x) {
  const float y = fmaxf(mul(x, 0x1.715476p+0f), -125.0f);  // x * LOG2E
  const float yi = floorf(y);
  const float yf = sub(y, yi);
  const float p = add(1.0f, mul(yf, add(0x1.63f06ep-1f,        // 0.6951937
                        mul(yf, add(0x1.d4048cp-3f,            // 0.2285243
                        mul(yf, 0x1.4095f2p-4f))))));          // 0.0782680
  return mul(__int_as_float(((int)yi + 127) << 23), p);
}

// micro_kernel_costs.py::fast_log1p_neg: log1p(-a) from u = 1 - a.
__device__ __forceinline__ float fast_log1p_neg(float a) {
  const float u = fmaxf(sub(1.0f, a), 0x1.4484cp-100f);  // 1e-30
  const int bits = __float_as_int(u);
  const int e = ((bits >> 23) & 0xFF) - 127;
  const float m = __int_as_float((bits & 0x7FFFFF) | (127 << 23));
  const float t = sub(m, 1.0f);
  const float lm = mul(t, add(0x1.715476p+0f,                 // 1.4426950
                     mul(t, add(-0x1.6fb0b6p-1f,              // -0.7181451
                     mul(t, add(0x1.d18f3ep-2f,               // 0.4546480
                     mul(t, -0x1.1c3196p-2f)))))));           // -0.2775329
  return mul(add((float)e, lm), 0x1.62e43p-1f);                // * ln 2
}

template <int kMode>
__device__ __forceinline__ float probe(float x) {
  if (kMode == kMults) {
    const float e = add(mul(x, x), x);
    const float l = sub(1.0f, mul(0.5f, e));
    return add(e, mul(l, l));
  } else if (kMode == kExact) {
    const float e = expf(x);
    return add(e, log1pf(mul(-0.5f, e)));
  } else if (kMode == kExact3) {
    const float e = expf(x);
    return add(expf(log1pf(mul(-0.5f, e))), e);
  } else {
    const float e = fast_exp(x);
    return add(fast_exp(fast_log1p_neg(mul(0.5f, e))), e);
  }
}

template <int kMode>
__device__ __forceinline__ float4 probe4(float4 v) {
  return make_float4(probe<kMode>(v.x), probe<kMode>(v.y), probe<kMode>(v.z),
                     probe<kMode>(v.w));
}

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
transc_kernel(const float* __restrict__ x, float* __restrict__ out,
              int64_t n) {
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ out4 = reinterpret_cast<float4*>(out);
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t base = tid; base < n4; base += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      if (i < n4) v[u] = x4[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      if (i < n4) out4[i] = probe4<kMode>(v[u]);
    }
  }
  for (int64_t i = 4 * n4 + tid; i < n; i += stride) out[i] = probe<kMode>(x[i]);
}

}  // namespace

extern "C" int gsplat_probe_transc(const float* x, float* out, int64_t n,
                                   int mode, void* stream) {
  if (n > 0) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int64_t want = (n / 4 + kThreads - 1) / kThreads + 1;
    const int64_t cap = (int64_t)sms * (2048 / kThreads);
    const unsigned blocks = (unsigned)(want < cap ? want : cap);
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
      case kMults: transc_kernel<kMults><<<blocks, kThreads, 0, s>>>(x, out, n); break;
      case kExact: transc_kernel<kExact><<<blocks, kThreads, 0, s>>>(x, out, n); break;
      case kExact3: transc_kernel<kExact3><<<blocks, kThreads, 0, s>>>(x, out, n); break;
      case kFast3: transc_kernel<kFast3><<<blocks, kThreads, 0, s>>>(x, out, n); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
