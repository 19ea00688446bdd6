// K3: exact ellipse-tile cull mask of the tiled binning's rect walk.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/cull.py::_cull_kernel. For
// Gaussian row r and rect-walk index k < kmax it takes the tile
// (x0 + k mod w, y0 + k div w), finds the minimum of the conic quadratic
// q = A dx^2 + 2B dx dy + C dy^2 over that tile's pixel centres (0 if the
// centre is inside, else the minimum over the 4 edges of the clamped 1-D
// minimiser), and keeps the lane iff qmin <= tau and k < count.
//
// What bounds it on an H100: the (N, kmax) mask it writes. At the bench
// shape (N = 1M, kmax = 64) that is 64 MB of output against 40 MB of
// parameters, and 70 FP32 operations per lane (k div/mod w 5, tile origin 2,
// pixel-rect offsets 8, inside test 4, four edges of 11, min and tests 7)
// plus 5 per row (-b/a, -b/c, 2b, which each lane here repeats); both bounds
// are tens of microseconds. Design: one thread per (row, k) lane, consecutive threads on
// consecutive k of one row, so the one-byte mask stores coalesce and the ten
// parameter loads of a row are shared by its kmax lanes through L1. kmax is
// a runtime argument: the jumbo tiers run the kernel on their gathered rows
// with kmax = max_tiles_jumbo, up to 2048. The mask is written as 0/1 bytes
// straight into the (N, kmax) bool tensor: no f32 mask and no transpose as
// on the TPU.
//
// Exactness: every product, sum and quotient goes through __fmul_rn,
// __fadd_rn, __fsub_rn and __fdiv_rn, which nvcc never contracts into FMAs,
// in the operation order of the plain PyTorch version
// (gsplat_tpu_torch/ops/cuda/cull.py::cull_mask_plain). Each rounds like one
// PyTorch elementwise op, so the kernel's mask equals the plain one bit for
// bit on the same parameters.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Parameter rows of the (10, N) float32 input (cull.py::cull_params).
enum { R_GX, R_GY, R_A, R_B, R_C, R_TAU, R_X0, R_Y0, R_W, R_COUNT };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// a*dx*dx + (2b)*dx*dy + c*dy*dy, left to right as Python evaluates it.
__device__ __forceinline__ float quad(float a, float b2, float c, float dx,
                                      float dy) {
  return add(add(mul(mul(a, dx), dx), mul(mul(b2, dx), dy)),
             mul(mul(c, dy), dy));
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void cull_kernel(const float* __restrict__ params,
                            uint8_t* __restrict__ out, int64_t n, int kmax,
                            float ts) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n * kmax) return;
  int64_t r = lane / kmax;
  float k = (float)(int)(lane - r * kmax);

  float gx = params[R_GX * n + r];
  float gy = params[R_GY * n + r];
  float a = params[R_A * n + r];
  float b = params[R_B * n + r];
  float c = params[R_C * n + r];
  float tau = params[R_TAU * n + r];
  float x0 = params[R_X0 * n + r];
  float y0 = params[R_Y0 * n + r];
  float w = params[R_W * n + r];
  float count = params[R_COUNT * n + r];

  // k div w via exact f32 division ((k + 0.5) / w is never integral).
  float ky = floorf(__fdiv_rn(add(k, 0.5f), w));
  float kx = sub(k, mul(ky, w));
  float tx = add(x0, kx);
  float ty = add(y0, ky);

  float dx0 = sub(mul(tx, ts), gx);
  float dx1 = add(dx0, sub(ts, 1.0f));
  float dy0 = sub(mul(ty, ts), gy);
  float dy1 = add(dy0, sub(ts, 1.0f));
  bool inside = (dx0 <= 0.f) && (0.f <= dx1) && (dy0 <= 0.f) && (0.f <= dy1);

  float nb_over_a = __fdiv_rn(-b, fmaxf(a, 1e-12f));
  float nb_over_c = __fdiv_rn(-b, fmaxf(c, 1e-12f));
  float b2 = mul(2.0f, b);

  // Edges dx = d (minimise over dy) and dy = d (minimise over dx).
  float ex0 = quad(a, b2, c, dx0, clip(mul(nb_over_c, dx0), dy0, dy1));
  float ex1 = quad(a, b2, c, dx1, clip(mul(nb_over_c, dx1), dy0, dy1));
  float ey0 = quad(a, b2, c, clip(mul(nb_over_a, dy0), dx0, dx1), dy0);
  float ey1 = quad(a, b2, c, clip(mul(nb_over_a, dy1), dx0, dx1), dy1);
  float qmin = fminf(fminf(ex0, ex1), fminf(ey0, ey1));
  if (inside) qmin = 0.f;

  out[lane] = (qmin <= tau) && (k < count);
}

}  // namespace

extern "C" int gsplat_cull(const float* params, uint8_t* out, int64_t n,
                           int kmax, float tile_size, void* stream) {
  int64_t lanes = n * (int64_t)kmax;
  if (lanes > 0) {
    const int threads = 256;
    int64_t blocks = (lanes + threads - 1) / threads;
    cull_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        params, out, n, kmax, tile_size);
  }
  return (int)cudaGetLastError();
}
