// The device code K8 and K9 (project.cu) share with K12 and K13
// (surfel_project.cu): one thread a Gaussian or surfel in blocks of
// kThreads, the camera staged in shared memory, the float32 operations
// rounded one at a time, the clamps that let a NaN through, the block's SH
// rows staged through shared memory, and the SH basis and colour. It is
// included inside an anonymous namespace, after <cuda_runtime.h> and
// <stdint.h>.

#pragma once

constexpr int kThreads = 128;
// view (16), full_proj (16), cam_pos (3), focal (2), tan_fov (2), znear (1)
constexpr int kCamFloats = 40;
constexpr int kView = 0, kProj = 16, kPos = 32, kFocal = 35, kTan = 37,
              kZnear = 39;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
__device__ __forceinline__ float sqr(float a) { return __fsqrt_rn(a); }
// torch.clamp_min / clamp_max / clamp / minimum: a NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// The SH constants of `ops/sh.py`, each rounded to float32 from its double.
#define F32(x) static_cast<float>(x)
__device__ __constant__ float kC0 = F32(0.28209479177387814);
__device__ __constant__ float kC1 = F32(0.4886025119029199);
__device__ __constant__ float kC2[5] = {
    F32(1.0925484305920792), F32(-1.0925484305920792),
    F32(0.31539156525252005), F32(-1.0925484305920792),
    F32(0.5462742152960396)};
__device__ __constant__ float kC3[7] = {
    F32(-0.5900435899266435), F32(2.890611442640554),
    F32(-0.4570457994644658), F32(0.3731763325901154),
    F32(-0.4570457994644658), F32(1.445305721320277),
    F32(-0.5900435899266435)};

// Shared-memory row stride of COLS floats: odd, so that the 32 threads of a
// warp, each at the same column of its own row, hit 32 banks.
template <int COLS>
__host__ __device__ constexpr int stride() { return COLS | 1; }

// The block's `rows` rows of a (N, COLS) float32 array, from row `row0`,
// into shared memory: the chunk is contiguous, so consecutive threads load
// consecutive floats.
template <int COLS>
__device__ __forceinline__ void stage_in(const float* __restrict__ src,
                                         int row0, int rows, float* s) {
  const float* p = src + (int64_t)row0 * COLS;
  for (int e = threadIdx.x; e < rows * COLS; e += kThreads) {
    const int r = e / COLS;
    s[r * stride<COLS>() + (e - r * COLS)] = __ldg(p + e);
  }
}

// The reverse: shared-memory rows out to the (N, COLS) array.
template <int COLS>
__device__ __forceinline__ void stage_out(const float* s, int row0, int rows,
                                          float* __restrict__ dst) {
  float* p = dst + (int64_t)row0 * COLS;
  for (int e = threadIdx.x; e < rows * COLS; e += kThreads) {
    const int r = e / COLS;
    p[e] = s[r * stride<COLS>() + (e - r * COLS)];
  }
}

__device__ __forceinline__ void stage_camera(
    const float* view, const float* full_proj, const float* cam_pos,
    const float* focal, const float* tan_fov, const float* znear, float* s) {
  const int t = threadIdx.x;
  if (t < 16) {
    s[kView + t] = view[t];
    s[kProj + t] = full_proj[t];
  } else if (t < 19) {
    s[kPos + t - 16] = cam_pos[t - 16];
  } else if (t < 21) {
    s[kFocal + t - 19] = focal[t - 19];
    s[kTan + t - 19] = tan_fov[t - 19];
  } else if (t == 21) {
    s[kZnear] = znear[0];
  }
}

// Row r of a row-major affine matrix applied to p, as `_affine` sums it.
__device__ __forceinline__ float affine(const float* m, int r, const float p[3]) {
  const float* row = m + 4 * r;
  return add(add(add(mul(p[0], row[0]), mul(p[1], row[1])), mul(p[2], row[2])),
             row[3]);
}

// The SH basis of degree DEG at the unit direction d, as `eval_sh` forms
// each coefficient's factor; b[1..3] are unused (degree 1 sums first).
template <int DEG>
struct Basis {
  float x, y, z, xx, yy, zz, xy, xz, yz;
  float b[16];

  __device__ __forceinline__ explicit Basis(const float d[3]) {
    x = d[0];
    y = d[1];
    z = d[2];
    b[0] = kC0;
    if constexpr (DEG >= 2) {
      xx = mul(x, x);
      yy = mul(y, y);
      zz = mul(z, z);
      xy = mul(x, y);
      xz = mul(x, z);
      yz = mul(y, z);
      b[4] = mul(kC2[0], xy);
      b[5] = mul(kC2[1], yz);
      b[6] = mul(kC2[2], sub(sub(mul(2.0f, zz), xx), yy));
      b[7] = mul(kC2[3], xz);
      b[8] = mul(kC2[4], sub(xx, yy));
    }
    if constexpr (DEG >= 3) {
      const float four = sub(sub(mul(4.0f, zz), xx), yy);
      b[9] = mul(mul(kC3[0], y), sub(mul(3.0f, xx), yy));
      b[10] = mul(mul(kC3[1], xy), z);
      b[11] = mul(mul(kC3[2], y), four);
      b[12] = mul(mul(kC3[3], z),
                  sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      b[13] = mul(mul(kC3[4], x), four);
      b[14] = mul(mul(kC3[5], z), sub(xx, yy));
      b[15] = mul(mul(kC3[6], x), sub(xx, mul(3.0f, yy)));
    }
  }

  // eval_sh's colour channel ch before the clamp: coefficients c (3 floats
  // a coefficient), + 0.5.
  __device__ __forceinline__ float colour(const float* c, int ch) const {
    float r = mul(kC0, c[ch]);
    if constexpr (DEG >= 1) {
      float s = add(mul(-y, c[3 + ch]), mul(z, c[6 + ch]));
      s = sub(s, mul(x, c[9 + ch]));
      r = add(r, mul(kC1, s));
    }
    if constexpr (DEG >= 2) {
      float s = mul(b[4], c[12 + ch]);
#pragma unroll
      for (int k = 5; k < 9; ++k) s = add(s, mul(b[k], c[3 * k + ch]));
      r = add(r, s);
    }
    if constexpr (DEG >= 3) {
      float s = mul(b[9], c[27 + ch]);
#pragma unroll
      for (int k = 10; k < 16; ++k) s = add(s, mul(b[k], c[3 * k + ch]));
      r = add(r, s);
    }
    return add(r, 0.5f);
  }
};
