// K8: the per-Gaussian projection and SH colour, and K9, its backward.
//
// They replace no TPU kernel: the JAX package computes the projection with
// jnp ops that XLA fuses (`gsplat_tpu/ops/projection.py`). Their plain
// version is `ops/projection.py` (`_project_plain`, `project_backward`),
// which as PyTorch ops ran as a few hundred elementwise kernels over
// strided (N,), (N, 3, 3) and (N, 16, 3) operands, and their autograd graph.
//
// K8 is one thread a Gaussian. It reads the five scene fields and the camera
// and writes the fields of `ProjectedGaussians`: uv (with the densification
// tap), conic, depth, colour, opacity, radius, the tile rect, the tile count
// and the mask; `overflow` is one byte, zeroed by the wrapper, that a warp
// sets when one of its Gaussians' rects passes K_max. Every intermediate
// (the view and clip transforms, J, T = J W, the rotation, Sigma, the 16 SH
// basis values) lives in registers.
//
// K9 takes the gradients of uv (N, 2), conic (N, 3), colour (N, 3) and
// opacity (N,), recomputes the forward of its Gaussian in registers with
// K8's own code (so every branch -- the frustum, the txy clamp, det > 0, the
// colour's clamp at 0 -- goes the way K8 went), and writes the gradients of
// means, log-scales, quaternions, opacity logits and SH: the chain of the
// plain version's autograd, term for term (`project_backward` writes the
// same chain in PyTorch ops). A Gaussian whose incoming gradients are all 0
// gets zeros, whatever its intermediates.
//
// What bounds them: bytes. At SH degree 3 K8 reads 236 B a Gaussian (means
// 12, log-scales 12, quaternion 16, opacity logit 4, SH 192) and writes 65;
// its ~400 FP32 operations a Gaussian are far below the card's ratio of 20
// FP32 operations a byte. K9 reads the 236 B and 36 B of gradients and
// writes 236 B. The SH rows dominate: a block's rows are one contiguous
// chunk, which its threads load (and K9 stores) with coalesced 4-byte
// accesses through shared memory, each row at an odd stride so that a
// thread's walk along its own row is free of bank conflicts.
//
// Numerics: K8 evaluates the plain version's float32 expressions in its
// order, each operation rounded alone (__fmul_rn, __fadd_rn, ... , which
// nvcc never contracts into an FMA; PyTorch runs each op as its own
// kernel): a scalar over a tensor is a reciprocal times it (`1.0 / t`), a
// tensor over a host scalar a product by the scalar's reciprocal rounded
// to float32 (PyTorch's CUDA division), a Python constant its float32 rounding, the
// clamps let NaN through, and `torch.linalg.norm` sums the squares as
// PyTorch's CUDA reduction pairs them: (x0^2 + x2^2) + (x1^2 + x3^2) for 4
// entries (a lane an entry, the warp's shuffles at offsets 2 then 1) and
// (x0^2 + x2^2) + x1^2 for 3 (two lanes). K9 is held to
// the scene-gradient tolerance, not bits: it contracts freely.

#include <cuda_runtime.h>
#include <stdint.h>

// The RenderConfig scalars K8 and K9 read, as the wrapper rounds them.
struct GsplatProjectConfig {
  float ndc_limit;          // frustum_ndc_limit
  float lowpass;
  float eigen_clamp;
  float radius_sigma;
  float max_screen_radius;  // 0: no screen-radius clamp
  float alpha_min;
  float inv_alpha_min;      // 1 / alpha_min, rounded to float32
  float scale_modifier;
  float width;
  float height;
  float inv_tile;           // 1 / tile_size, rounded to float32
  int tiles_x;
  int tiles_y;
  int kmax;                 // max_tiles_per_gaussian
};

namespace {

#include "project_common.cuh"

// One Gaussian's forward, every value the backward reads.
struct Forward {
  float pos[3], pv[3], ph[2], inv_w;
  bool in_frustum;
  float tz_s, u[2], lim[2], txy[2], inv_tz, inv_tz2, fx, fy;
  float t0[3], t1[3];
  float nq, qn[4], rot[3][3], s2[3], sig[3][3];
  float c00, c01, c11;   // before the screen-radius shrink
  bool valid;            // in the frustum and det > 0
  float f;               // the shrink (1 without the clamp)
  float k00, k01, k11;   // after it
  float inv_det, lambda1;
  float op;
  float rel[3], dn, dir[3];
};

// quad(u, v) = u Sigma v as `project_gaussians` sums it (Python's `sum`
// starts from 0).
__device__ __forceinline__ float quad(const float s[3][3], const float u[3],
                                      const float v[3]) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float si = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) si = add(si, mul(s[i][j], v[j]));
    acc = add(acc, mul(u[i], si));
  }
  return acc;
}

__device__ __forceinline__ void forward(
    Forward& F, const float* __restrict__ means,
    const float* __restrict__ log_scales, const float* __restrict__ quats,
    float logit, int64_t i, const float* cam, const GsplatProjectConfig& cfg) {
#pragma unroll
  for (int k = 0; k < 3; ++k) F.pos[k] = __ldg(means + 3 * i + k);
  // View and clip transforms, frustum, uv.
#pragma unroll
  for (int r = 0; r < 3; ++r) F.pv[r] = affine(cam + kView, r, F.pos);
  F.ph[0] = affine(cam + kProj, 0, F.pos);
  F.ph[1] = affine(cam + kProj, 1, F.pos);
  F.inv_w = rcp(add(affine(cam + kProj, 3, F.pos), F32(1e-7)));
  const float tz = F.pv[2];
  F.in_frustum = tz > cam[kZnear] &&
                 fabsf(mul(F.ph[0], F.inv_w)) < cfg.ndc_limit &&
                 fabsf(mul(F.ph[1], F.inv_w)) < cfg.ndc_limit;
  // EWA: J at the clamped txy, T = J W.
  F.tz_s = F.in_frustum ? tz : 1.0f;
  F.fx = cam[kFocal];
  F.fy = cam[kFocal + 1];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    F.lim[k] = mul(F32(1.3), cam[kTan + k]);
    F.u[k] = dvd(F.pv[k], F.tz_s);
    F.txy[k] = mul(clamp(F.u[k], -F.lim[k], F.lim[k]), F.tz_s);
  }
  F.inv_tz = rcp(F.tz_s);
  F.inv_tz2 = mul(F.inv_tz, F.inv_tz);
  const float ja = mul(F.fx, F.inv_tz);
  const float jb = mul(mul(-F.fx, F.txy[0]), F.inv_tz2);
  const float jc = mul(F.fy, F.inv_tz);
  const float jd = mul(mul(-F.fy, F.txy[1]), F.inv_tz2);
  const float* w = cam + kView;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    F.t0[k] = add(mul(ja, w[k]), mul(jb, w[8 + k]));
    F.t1[k] = add(mul(jc, w[4 + k]), mul(jd, w[8 + k]));
  }
  // Sigma = R diag(s^2) R^T.
  float q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __ldg(quats + 4 * i + k);
  F.nq = sqr(add(add(mul(q[0], q[0]), mul(q[2], q[2])),
                 add(mul(q[1], q[1]), mul(q[3], q[3]))));
#pragma unroll
  for (int k = 0; k < 4; ++k) F.qn[k] = dvd(q[k], F.nq);
  const float qw = F.qn[0], qx = F.qn[1], qy = F.qn[2], qz = F.qn[3];
  F.rot[0][0] = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  F.rot[0][1] = mul(2.0f, sub(mul(qx, qy), mul(qw, qz)));
  F.rot[0][2] = mul(2.0f, add(mul(qx, qz), mul(qw, qy)));
  F.rot[1][0] = mul(2.0f, add(mul(qx, qy), mul(qw, qz)));
  F.rot[1][1] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  F.rot[1][2] = mul(2.0f, sub(mul(qy, qz), mul(qw, qx)));
  F.rot[2][0] = mul(2.0f, sub(mul(qx, qz), mul(qw, qy)));
  F.rot[2][1] = mul(2.0f, add(mul(qy, qz), mul(qw, qx)));
  F.rot[2][2] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float s = mul(expf(__ldg(log_scales + 3 * i + k)), cfg.scale_modifier);
    F.s2[k] = mul(s, s);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = a; b < 3; ++b) {
      float acc = mul(mul(F.s2[0], F.rot[a][0]), F.rot[b][0]);
      acc = add(acc, mul(mul(F.s2[1], F.rot[a][1]), F.rot[b][1]));
      acc = add(acc, mul(mul(F.s2[2], F.rot[a][2]), F.rot[b][2]));
      F.sig[a][b] = F.sig[b][a] = acc;
    }
  }
  F.c00 = add(quad(F.sig, F.t0, F.t0), cfg.lowpass);
  F.c01 = quad(F.sig, F.t0, F.t1);
  F.c11 = add(quad(F.sig, F.t1, F.t1), cfg.lowpass);
  const float det = sub(mul(F.c00, F.c11), mul(F.c01, F.c01));
  F.valid = F.in_frustum && det > 0.0f;
  float det_s = F.valid ? det : 1.0f;
  const float mid = mul(0.5f, add(F.c00, F.c11));
  F.lambda1 = add(mid, sqr(clamp_min(sub(mul(mid, mid), det_s), cfg.eigen_clamp)));
  F.f = 1.0f;
  F.k00 = F.c00;
  F.k01 = F.c01;
  F.k11 = F.c11;
  if (cfg.max_screen_radius != 0.0f) {
    const float r_raw = mul(cfg.radius_sigma, sqr(F.lambda1));
    F.f = clamp_max(dvd(cfg.max_screen_radius, clamp_min(r_raw, F32(1e-6))), 1.0f);
    F.f = mul(F.f, F.f);
    F.k00 = mul(F.c00, F.f);
    F.k01 = mul(F.c01, F.f);
    F.k11 = mul(F.c11, F.f);
    det_s = mul(mul(det_s, F.f), F.f);
    F.lambda1 = mul(F.lambda1, F.f);
  }
  F.inv_det = rcp(det_s);
  F.op = dvd(1.0f, add(1.0f, expf(-logit)));
  // View direction.
#pragma unroll
  for (int k = 0; k < 3; ++k) F.rel[k] = sub(F.pos[k], cam[kPos + k]);
  F.dn = sqr(add(add(mul(F.rel[0], F.rel[0]), mul(F.rel[2], F.rel[2])),
                 mul(F.rel[1], F.rel[1])));
  const float dnc = clamp_min(F.dn, F32(1e-12));
#pragma unroll
  for (int k = 0; k < 3; ++k) F.dir[k] = dvd(F.rel[k], dnc);
}

template <int KC, int DEG>
__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(int n, const float* __restrict__ means,
                   const float* __restrict__ log_scales,
                   const float* __restrict__ quats,
                   const float* __restrict__ opacity_logits,
                   const float* __restrict__ sh,
                   const float* __restrict__ uv_tap, const float* view,
                   const float* full_proj, const float* cam_pos,
                   const float* focal, const float* tan_fov,
                   const float* znear, GsplatProjectConfig cfg,
                   float* __restrict__ out_uv, float* __restrict__ out_conic,
                   float* __restrict__ out_depth,
                   float* __restrict__ out_color,
                   float* __restrict__ out_opacity,
                   float* __restrict__ out_radius, int4* __restrict__ out_rect,
                   int* __restrict__ out_counts, bool* __restrict__ out_mask,
                   bool* __restrict__ overflow) {
  extern __shared__ float s_sh[];
  __shared__ float s_cam[kCamFloats];
  const int row0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - row0);
  stage_camera(view, full_proj, cam_pos, focal, tan_fov, znear, s_cam);
  stage_in<KC>(sh, row0, rows, s_sh);
  __syncthreads();
  bool over = false;
  if ((int)threadIdx.x < rows) {
    const int64_t i = row0 + threadIdx.x;
    Forward F;
    forward(F, means, log_scales, quats, __ldg(opacity_logits + i), i, s_cam,
            cfg);
    float uv[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      uv[k] = add(mul(mul(F.ph[k], F.inv_w), 0.5f), 0.5f);
      if (uv_tap != nullptr) uv[k] = add(uv[k], __ldg(uv_tap + 2 * i + k));
    }
    const float radius = ceilf(mul(cfg.radius_sigma, sqr(F.lambda1)));
    // The tile rect: the circle's, cut to the AABB of {q <= tau}.
    const float tau = mul(2.0f, logf(clamp_min(mul(F.op, cfg.inv_alpha_min),
                                               F32(1e-12))));
    const float rtau = sqr(clamp_min(tau, 0.0f));
    float ext[2] = {
        minimum(radius, ceilf(mul(rtau, sqr(clamp_min(F.k00, 0.0f))))),
        minimum(radius, ceilf(mul(rtau, sqr(clamp_min(F.k11, 0.0f)))))};
    if (!(F.op > cfg.alpha_min)) ext[0] = ext[1] = -1.0f;
    const float pix[2] = {mul(uv[0], cfg.width), mul(uv[1], cfg.height)};
    const float grid[2] = {(float)cfg.tiles_x, (float)cfg.tiles_y};
    int lo[2], hi[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float a = floorf(mul(sub(pix[k], ext[k]), cfg.inv_tile));
      const float b = add(floorf(mul(add(pix[k], ext[k]), cfg.inv_tile)), 1.0f);
      lo[k] = __float2int_rz(clamp(a, 0.0f, grid[k]));
      hi[k] = __float2int_rz(clamp(b, 0.0f, grid[k]));
    }
    int area = max(hi[0] - lo[0], 0) * max(hi[1] - lo[1], 0);
    if (!F.valid) area = 0;
    over = area > cfg.kmax;

    const Basis<DEG> basis(F.dir);
    const float* c = s_sh + threadIdx.x * stride<KC>();
    reinterpret_cast<float2*>(out_uv)[i] = make_float2(uv[0], uv[1]);
    out_conic[3 * i] = mul(F.k11, F.inv_det);
    out_conic[3 * i + 1] = mul(-F.k01, F.inv_det);
    out_conic[3 * i + 2] = mul(F.k00, F.inv_det);
    out_depth[i] = F.pv[2];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      out_color[3 * i + ch] = clamp_min(basis.colour(c, ch), 0.0f);
    out_opacity[i] = F.op;
    out_radius[i] = radius;
    out_rect[i] = make_int4(lo[0], lo[1], hi[0], hi[1]);
    out_counts[i] = min(area, cfg.kmax);
    out_mask[i] = F.valid && area > 0;
  }
  if (__any_sync(0xffffffffu, over) && (threadIdx.x & 31) == 0) *overflow = true;
}

template <int KC, int DEG>
__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(int n, const float* __restrict__ means,
                   const float* __restrict__ log_scales,
                   const float* __restrict__ quats,
                   const float* __restrict__ opacity_logits,
                   const float* __restrict__ sh, const float* view,
                   const float* full_proj, const float* cam_pos,
                   const float* focal, const float* tan_fov,
                   const float* znear, GsplatProjectConfig cfg,
                   const float* __restrict__ g_uv,
                   const float* __restrict__ g_conic,
                   const float* __restrict__ g_color,
                   const float* __restrict__ g_opacity,
                   float* __restrict__ d_means,
                   float* __restrict__ d_log_scales,
                   float* __restrict__ d_quats,
                   float* __restrict__ d_opacity_logits,
                   float* __restrict__ d_sh) {
  extern __shared__ float s_sh[];
  __shared__ float s_cam[kCamFloats];
  const int row0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - row0);
  stage_camera(view, full_proj, cam_pos, focal, tan_fov, znear, s_cam);
  stage_in<KC>(sh, row0, rows, s_sh);
  __syncthreads();
  if ((int)threadIdx.x < rows) {
    const int64_t i = row0 + threadIdx.x;
    float* c = s_sh + threadIdx.x * stride<KC>();
    const float gu[2] = {__ldg(g_uv + 2 * i), __ldg(g_uv + 2 * i + 1)};
    float gk[3], gcol[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gk[k] = __ldg(g_conic + 3 * i + k);
      gcol[k] = __ldg(g_color + 3 * i + k);
    }
    const float gop = __ldg(g_opacity + i);
    float gp[3] = {0.0f, 0.0f, 0.0f}, gls[3] = {0.0f, 0.0f, 0.0f};
    float gq[4] = {0.0f, 0.0f, 0.0f, 0.0f}, gol = 0.0f;
    const bool live = gu[0] != 0.0f || gu[1] != 0.0f || gk[0] != 0.0f ||
                      gk[1] != 0.0f || gk[2] != 0.0f || gcol[0] != 0.0f ||
                      gcol[1] != 0.0f || gcol[2] != 0.0f || gop != 0.0f;
    if (live) {
      const float logit = __ldg(opacity_logits + i);
      Forward F;
      forward(F, means, log_scales, quats, logit, i, s_cam, cfg);
      const float* cam = s_cam;

      // Colour: the clamp at 0 passes where colour + 0.5 >= 0 (torch's
      // clamp_min backward); then the SH coefficients and the direction.
      const Basis<DEG> B(F.dir);
      float gres[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        gres[ch] = B.colour(c, ch) >= 0.0f ? gcol[ch] : 0.0f;
      float v[16];  // sum over channels of g_res * coefficient
#pragma unroll
      for (int k = 0; k < (DEG + 1) * (DEG + 1); ++k)
        v[k] = gres[0] * c[3 * k] + gres[1] * c[3 * k + 1] + gres[2] * c[3 * k + 2];
      float gd[3] = {0.0f, 0.0f, 0.0f};
      const float x = B.x, y = B.y, z = B.z;
      if constexpr (DEG >= 1) {
        gd[0] -= kC1 * v[3];
        gd[1] -= kC1 * v[1];
        gd[2] += kC1 * v[2];
      }
      if constexpr (DEG >= 2) {
        gd[0] += kC2[0] * y * v[4] - 2.0f * kC2[2] * x * v[6] + kC2[3] * z * v[7]
                 + 2.0f * kC2[4] * x * v[8];
        gd[1] += kC2[0] * x * v[4] + kC2[1] * z * v[5] - 2.0f * kC2[2] * y * v[6]
                 - 2.0f * kC2[4] * y * v[8];
        gd[2] += kC2[1] * y * v[5] + 4.0f * kC2[2] * z * v[6] + kC2[3] * x * v[7];
      }
      if constexpr (DEG >= 3) {
        const float xx = x * x, yy = y * y, zz = z * z;
        gd[0] += kC3[0] * 6.0f * x * y * v[9] + kC3[1] * y * z * v[10]
                 - kC3[2] * 2.0f * x * y * v[11] - kC3[3] * 6.0f * x * z * v[12]
                 + kC3[4] * (4.0f * zz - 3.0f * xx - yy) * v[13]
                 + kC3[5] * 2.0f * x * z * v[14]
                 + kC3[6] * (3.0f * xx - 3.0f * yy) * v[15];
        gd[1] += kC3[0] * (3.0f * xx - 3.0f * yy) * v[9] + kC3[1] * x * z * v[10]
                 + kC3[2] * (4.0f * zz - xx - 3.0f * yy) * v[11]
                 - kC3[3] * 6.0f * y * z * v[12] - kC3[4] * 2.0f * x * y * v[13]
                 - kC3[5] * 2.0f * y * z * v[14] - kC3[6] * 6.0f * x * y * v[15];
        gd[2] += kC3[1] * x * y * v[10] + kC3[2] * 8.0f * y * z * v[11]
                 + kC3[3] * (6.0f * zz - 3.0f * xx - 3.0f * yy) * v[12]
                 + kC3[4] * 8.0f * x * z * v[13] + kC3[5] * (xx - yy) * v[14];
      }
      // The coefficients' gradients, in place of the coefficients.
#pragma unroll
      for (int k = 0; k < KC / 3; ++k) {
        float bk = 0.0f;
        if (k == 0) bk = kC0;
        else if (k == 1 && DEG >= 1) bk = -kC1 * y;
        else if (k == 2 && DEG >= 1) bk = kC1 * z;
        else if (k == 3 && DEG >= 1) bk = -kC1 * x;
        else if (k < (DEG + 1) * (DEG + 1)) bk = B.b[k];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) c[3 * k + ch] = bk * gres[ch];
      }
      // dir = rel / max(|rel|, 1e-12).
      const float dnc = fmaxf(F.dn, 1e-12f);
      const float dot = gd[0] * F.rel[0] + gd[1] * F.rel[1] + gd[2] * F.rel[2];
      const float gn = F.dn >= 1e-12f ? -dot / (dnc * dnc) : 0.0f;
      const float gn_over = F.dn > 0.0f ? gn / F.dn : 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) gp[k] = gd[k] / dnc + F.rel[k] * gn_over;

      // Opacity.
      gol = gop * F.op * (1.0f - F.op);

      // Conic = (k11, -k01, k00) / det_s, k = f c, det_s = f^2 det where
      // valid (else 1).
      const float ginv = gk[0] * F.k11 - gk[1] * F.k01 + gk[2] * F.k00;
      const float gdet = F.valid ? -ginv * F.inv_det * F.inv_det * F.f * F.f : 0.0f;
      const float g00 = gk[2] * F.inv_det * F.f + gdet * F.c11;
      const float g01 = -gk[1] * F.inv_det * F.f - 2.0f * gdet * F.c01;
      const float g11 = gk[0] * F.inv_det * F.f + gdet * F.c00;
      // c00 = t0 S t0, c01 = t0 S t1, c11 = t1 S t1.
      float st0[3], st1[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        st0[a] = F.sig[a][0] * F.t0[0] + F.sig[a][1] * F.t0[1] + F.sig[a][2] * F.t0[2];
        st1[a] = F.sig[a][0] * F.t1[0] + F.sig[a][1] * F.t1[1] + F.sig[a][2] * F.t1[2];
      }
      float gt0[3], gt1[3], ms[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        gt0[a] = 2.0f * g00 * st0[a] + g01 * st1[a];
        gt1[a] = 2.0f * g11 * st1[a] + g01 * st0[a];
#pragma unroll
        for (int b = 0; b < 3; ++b)  // M = g00 t0 t0' + g01 t0 t1' + g11 t1 t1'
          ms[a][b] = g00 * F.t0[a] * F.t0[b] + g01 * F.t0[a] * F.t1[b]
                     + g11 * F.t1[a] * F.t1[b];
      }
      // Sigma = R S2 R': g_R = (M + M') R S2, g_s2 = diag(R' M R).
      float grot[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float acc = 0.0f;
#pragma unroll
          for (int b = 0; b < 3; ++b) acc += (ms[a][b] + ms[b][a]) * F.rot[b][k];
          grot[a][k] = acc * F.s2[k];
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int b = 0; b < 3; ++b) acc += F.rot[a][k] * ms[a][b] * F.rot[b][k];
        }
        gls[k] = 2.0f * F.s2[k] * acc;  // s2 = (exp(ls) m)^2
      }
      // R of the unit quaternion (w, x, y, z), then its normalisation.
      const float qw = F.qn[0], qx = F.qn[1], qy = F.qn[2], qz = F.qn[3];
      float gqn[4];
      gqn[0] = 2.0f * (-qz * grot[0][1] + qy * grot[0][2] + qz * grot[1][0]
                       - qx * grot[1][2] - qy * grot[2][0] + qx * grot[2][1]);
      gqn[1] = 2.0f * (qy * grot[0][1] + qz * grot[0][2] + qy * grot[1][0]
                       - 2.0f * qx * grot[1][1] - qw * grot[1][2] + qz * grot[2][0]
                       + qw * grot[2][1] - 2.0f * qx * grot[2][2]);
      gqn[2] = 2.0f * (-2.0f * qy * grot[0][0] + qx * grot[0][1] + qw * grot[0][2]
                       + qx * grot[1][0] + qz * grot[1][2] - qw * grot[2][0]
                       + qz * grot[2][1] - 2.0f * qy * grot[2][2]);
      gqn[3] = 2.0f * (-2.0f * qz * grot[0][0] - qw * grot[0][1] + qx * grot[0][2]
                       + qw * grot[1][0] - 2.0f * qz * grot[1][1] + qy * grot[1][2]
                       + qx * grot[2][0] + qy * grot[2][1]);
      const float qdot = gqn[0] * qw + gqn[1] * qx + gqn[2] * qy + gqn[3] * qz;
#pragma unroll
      for (int k = 0; k < 4; ++k) gq[k] = (gqn[k] - F.qn[k] * qdot) / F.nq;

      // T = J W; J = [fx/tz, 0, -fx tx/tz^2; 0, fy/tz, -fy ty/tz^2].
      const float* w = cam + kView;
      float gja = 0.0f, gjb = 0.0f, gjc = 0.0f, gjd = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gja += gt0[k] * w[k];
        gjb += gt0[k] * w[8 + k];
        gjc += gt1[k] * w[4 + k];
        gjd += gt1[k] * w[8 + k];
      }
      const float gtxy[2] = {-F.fx * F.inv_tz2 * gjb, -F.fy * F.inv_tz2 * gjd};
      const float ginv_tz2 = -F.fx * F.txy[0] * gjb - F.fy * F.txy[1] * gjd;
      const float ginv_tz = F.fx * gja + F.fy * gjc + 2.0f * F.inv_tz * ginv_tz2;
      float gtz = -ginv_tz * F.inv_tz * F.inv_tz;
      float gpv[3];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        // txy = clamp(u, -lim, lim) tz_s, u = pv / tz_s.
        const float cl = clamp(F.u[k], -F.lim[k], F.lim[k]);
        gtz += gtxy[k] * cl;
        const float gu_k = (F.u[k] >= -F.lim[k] && F.u[k] <= F.lim[k])
                               ? gtxy[k] * F.tz_s : 0.0f;
        gpv[k] = gu_k / F.tz_s;
        gtz -= gu_k * F.u[k] / F.tz_s;
      }
      gpv[2] = F.in_frustum ? gtz : 0.0f;
      // uv = 0.5 ph inv_w + 0.5, inv_w = 1 / (w + 1e-7).
      const float gph[2] = {0.5f * gu[0] * F.inv_w, 0.5f * gu[1] * F.inv_w};
      const float gw = -(0.5f * gu[0] * F.ph[0] + 0.5f * gu[1] * F.ph[1])
                       * F.inv_w * F.inv_w;
      const float* pm = cam + kProj;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gp[k] += gpv[0] * w[k] + gpv[1] * w[4 + k] + gpv[2] * w[8 + k]
                 + gph[0] * pm[k] + gph[1] * pm[4 + k] + gw * pm[12 + k];
    } else {
#pragma unroll
      for (int k = 0; k < KC; ++k) c[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d_means[3 * i + k] = gp[k];
      d_log_scales[3 * i + k] = gls[k];
    }
    reinterpret_cast<float4*>(d_quats)[i] = make_float4(gq[0], gq[1], gq[2], gq[3]);
    d_opacity_logits[i] = gol;
  }
  __syncthreads();
  stage_out<KC>(s_sh, row0, rows, d_sh);
}

template <int KC>
size_t sh_bytes() { return (size_t)kThreads * stride<KC>() * sizeof(float); }

template <int KC, int DEG>
cudaError_t launch_fwd(int n, const float* const* in, const float* uv_tap,
                       const float* const* camera,
                       const GsplatProjectConfig& cfg, void* const* out,
                       cudaStream_t st) {
  project_fwd_kernel<KC, DEG><<<(n + kThreads - 1) / kThreads, kThreads,
                                sh_bytes<KC>(), st>>>(
      n, in[0], in[1], in[2], in[3], in[4], uv_tap, camera[0], camera[1],
      camera[2], camera[3], camera[4], camera[5], cfg, (float*)out[0],
      (float*)out[1], (float*)out[2], (float*)out[3], (float*)out[4],
      (float*)out[5], (int4*)out[6], (int*)out[7], (bool*)out[8],
      (bool*)out[9]);
  return cudaGetLastError();
}

template <int KC, int DEG>
cudaError_t launch_bwd(int n, const float* const* in,
                       const float* const* camera,
                       const GsplatProjectConfig& cfg, const float* const* grad,
                       float* const* out, cudaStream_t st) {
  project_bwd_kernel<KC, DEG><<<(n + kThreads - 1) / kThreads, kThreads,
                                sh_bytes<KC>(), st>>>(
      n, in[0], in[1], in[2], in[3], in[4], camera[0], camera[1], camera[2],
      camera[3], camera[4], camera[5], cfg, grad[0], grad[1], grad[2],
      grad[3], out[0], out[1], out[2], out[3], out[4]);
  return cudaGetLastError();
}

}  // namespace

// The scene's coefficients a Gaussian (1, 4, 9 or 16) and the degree the
// colour is evaluated at (at most the scene's) pick the instance.
#define GSPLAT_PROJECT_DISPATCH(CALL)                                        \
  switch (coeffs * 4 + degree) {                                             \
    case 1 * 4 + 0: return (int)CALL(3, 0);                                  \
    case 4 * 4 + 0: return (int)CALL(12, 0);                                 \
    case 4 * 4 + 1: return (int)CALL(12, 1);                                 \
    case 9 * 4 + 0: return (int)CALL(27, 0);                                 \
    case 9 * 4 + 1: return (int)CALL(27, 1);                                 \
    case 9 * 4 + 2: return (int)CALL(27, 2);                                 \
    case 16 * 4 + 0: return (int)CALL(48, 0);                                \
    case 16 * 4 + 1: return (int)CALL(48, 1);                                \
    case 16 * 4 + 2: return (int)CALL(48, 2);                                \
    case 16 * 4 + 3: return (int)CALL(48, 3);                                \
    default: return (int)cudaErrorInvalidValue;                              \
  }

// in: means, log_scales, quats, opacity_logits, sh; camera: view,
// full_proj, cam_pos, focal, tan_fov, znear (device pointers); out: uv,
// conic, depth, color, opacity, radius, rect, counts, mask, overflow.
extern "C" int gsplat_project_fwd(int n, int coeffs, int degree,
                                  const float* const* in, const float* uv_tap,
                                  const float* const* camera,
                                  GsplatProjectConfig cfg, void* const* out,
                                  void* cuda_stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GSPLAT_FWD(KC, DEG) launch_fwd<KC, DEG>(n, in, uv_tap, camera, cfg, out, st)
  GSPLAT_PROJECT_DISPATCH(GSPLAT_FWD)
#undef GSPLAT_FWD
}

// grad: uv, conic, color, opacity gradients; out: means, log_scales,
// quats, opacity_logits, sh gradients.
extern "C" int gsplat_project_bwd(int n, int coeffs, int degree,
                                  const float* const* in,
                                  const float* const* camera,
                                  GsplatProjectConfig cfg,
                                  const float* const* grad, float* const* out,
                                  void* cuda_stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GSPLAT_BWD(KC, DEG) launch_bwd<KC, DEG>(n, in, camera, cfg, grad, out, st)
  GSPLAT_PROJECT_DISPATCH(GSPLAT_BWD)
#undef GSPLAT_BWD
}
