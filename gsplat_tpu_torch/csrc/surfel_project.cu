// K12: the surfel projection of 2D Gaussian splatting (Huang et al. 2024,
// arXiv:2403.17888), and K13, its backward.
//
// They replace no TPU kernel. Their plain version is
// `ops/surfels.py::_project_surfels_plain` (and its autograd), which K12
// follows operation for operation: every product and sum rounded alone
// (project_common.cuh's mul, add, ...; nvcc contracts none into an FMA),
// so that the binning's inputs -- the centre's view depth (the sort key),
// the tile rect and the cull's conic -- are those of the plain version and
// of the benchmark's reference.
//
// K12 is one thread a surfel. It reads the five scene fields (two
// log-scales a surfel) and the camera, and writes what the blend reads:
// the homography T = K [W | t] [s_u t_u, s_v t_v, p] (9 floats, row-major;
// K the intrinsics x = fx x_v / z + W / 2), the projected centre c =
// (T_02, T_12) / T_22, the SH colour (K8's code, project_common.cuh), the
// opacity and the view-space normal W t_w flipped to face the camera; and
// the binning's proxy: the surfel's reachable region (the image of the
// disk u^2 + v^2 <= tau under T, tau = 2 ln(o / alpha_min), with the
// low-pass filter's disk about c) bounded by one ellipse, its centre as
// uv, its tau-scaled inverse covariance as the conic, its bounding box's
// tile rect, the tile count and the mask; `overflow` is one byte, zeroed
// by the wrapper, that a warp sets when a rect passes K_max.
//
// K13 takes the gradients of T (9), c (2), the colour (3), the opacity and
// the normal (3), recomputes its surfel's forward in registers (so every
// branch goes as K12's went), folds c's gradient into T's, and writes the
// gradients of the means, the two log-scales, the quaternion, the opacity
// logit and the SH coefficients: T's chain through K and W to the scaled
// tangent axes and the centre, the normal's to the rotation's third
// column, the rotation's to the quaternion, the colour's to SH (K9's
// code). A surfel whose incoming gradients are all 0 gets zeros.
//
// What bounds them: bytes. At SH degree 3 K12 reads 232 B a surfel and
// writes 128; K13 reads the 232 B and 72 B of gradients and writes 232 B.

#include <cuda_runtime.h>
#include <stdint.h>

// The RenderConfig scalars K12 and K13 read, as the wrapper rounds them.
struct GsplatSurfelConfig {
  float alpha_min;
  float inv_alpha_min;      // 1 / alpha_min, rounded to float32
  float scale_modifier;
  float half_width;         // W / 2: the principal point
  float half_height;
  float inv_width;          // 1 / W, rounded to float32
  float inv_height;
  float inv_tile;           // 1 / tile_size, rounded to float32
  float filter_inv_square;  // the low-pass filter's 1 / sigma^2
  float grow;               // the proxy's relative widening
  float margin;             // and its margin in pixels
  int tiles_x;
  int tiles_y;
  int kmax;                 // max_tiles_per_gaussian
};

namespace {

#include "project_common.cuh"

// One surfel's forward, every value the backward reads.
struct Surfel {
  float pos[3], pv[3];
  float nq, qn[4], rot[3][3];
  float s[2];
  float ax[3][3];  // ax[k][i]: component i of W R[:, k]
  float t[3][3];   // T, row-major
  float z_s;       // T_22 where in front of znear, else 1
  float c[2];
  float flip;      // the normal's sign
  float op;
  float rel[3], dn, dir[3];
};

__device__ __forceinline__ void surfel_forward(
    Surfel& F, const float* __restrict__ means,
    const float* __restrict__ log_scales, const float* __restrict__ quats,
    float logit, int64_t i, const float* cam, const GsplatSurfelConfig& cfg) {
#pragma unroll
  for (int k = 0; k < 3; ++k) F.pos[k] = __ldg(means + 3 * i + k);
#pragma unroll
  for (int r = 0; r < 3; ++r) F.pv[r] = affine(cam + kView, r, F.pos);
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
  for (int k = 0; k < 2; ++k)
    F.s[k] = mul(expf(__ldg(log_scales + 2 * i + k)), cfg.scale_modifier);
  const float* w = cam + kView;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
      F.ax[k][r] = add(add(mul(w[4 * r], F.rot[0][k]),
                           mul(w[4 * r + 1], F.rot[1][k])),
                       mul(w[4 * r + 2], F.rot[2][k]));
  }
  // M's columns: s_u W t_u, s_v W t_v, p_view; T = K M.
  float m[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    m[r][0] = mul(F.ax[0][r], F.s[0]);
    m[r][1] = mul(F.ax[1][r], F.s[1]);
    m[r][2] = F.pv[r];
  }
  const float fx = cam[kFocal], fy = cam[kFocal + 1];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    F.t[0][k] = add(mul(fx, m[0][k]), mul(cfg.half_width, m[2][k]));
    F.t[1][k] = add(mul(fy, m[1][k]), mul(cfg.half_height, m[2][k]));
    F.t[2][k] = m[2][k];
  }
  const float tz = F.pv[2];
  F.z_s = tz > cam[kZnear] ? tz : 1.0f;
  F.c[0] = dvd(F.t[0][2], F.z_s);
  F.c[1] = dvd(F.t[1][2], F.z_s);
  const float dot = add(add(mul(F.ax[2][0], F.pv[0]), mul(F.ax[2][1], F.pv[1])),
                        mul(F.ax[2][2], F.pv[2]));
  F.flip = dot < 0.0f ? 1.0f : -1.0f;
  F.op = dvd(1.0f, add(1.0f, expf(-logit)));
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
splat2d_project_fwd_kernel(
    int n, const float* __restrict__ means,
    const float* __restrict__ log_scales, const float* __restrict__ quats,
    const float* __restrict__ opacity_logits, const float* __restrict__ sh,
    const float* view, const float* full_proj, const float* cam_pos,
    const float* focal, const float* tan_fov, const float* znear,
    GsplatSurfelConfig cfg, float* __restrict__ out_t,
    float* __restrict__ out_c, float* __restrict__ out_color,
    float* __restrict__ out_opacity, float* __restrict__ out_normal,
    bool* __restrict__ out_mask, float* __restrict__ out_uv,
    float* __restrict__ out_conic, float* __restrict__ out_depth,
    float* __restrict__ out_radius, int4* __restrict__ out_rect,
    int* __restrict__ out_counts, bool* __restrict__ overflow) {
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
    Surfel F;
    surfel_forward(F, means, log_scales, quats, __ldg(opacity_logits + i), i,
                   s_cam, cfg);
    // The binning proxy (ops/surfels.py::binning_proxy), in a frame
    // centred on c: the dual conic T diag(tau, tau, -1) T^T.
    const float tau = mul(2.0f, logf(clamp_min(mul(F.op, cfg.inv_alpha_min),
                                               F32(1e-12))));
    const float a0 = sub(F.t[0][0], mul(F.c[0], F.t[2][0]));
    const float a1 = sub(F.t[0][1], mul(F.c[0], F.t[2][1]));
    const float b0 = sub(F.t[1][0], mul(F.c[1], F.t[2][0]));
    const float b1 = sub(F.t[1][1], mul(F.c[1], F.t[2][1]));
    const float c0 = F.t[2][0], c1 = F.t[2][1], c2 = F.t[2][2];
    const float d00 = mul(tau, add(mul(a0, a0), mul(a1, a1)));
    const float d01 = mul(tau, add(mul(a0, b0), mul(a1, b1)));
    const float d11 = mul(tau, add(mul(b0, b0), mul(b1, b1)));
    const float d02 = mul(tau, add(mul(a0, c0), mul(a1, c1)));
    const float d12 = mul(tau, add(mul(b0, c0), mul(b1, c1)));
    const float d22 = sub(mul(tau, add(mul(c0, c0), mul(c1, c1))), mul(c2, c2));
    const bool bounded = d22 < 0.0f;
    const float d22s = bounded ? d22 : -1.0f;
    const float ex = dvd(d02, d22s), ey = dvd(d12, d22s);
    const float sxx = sub(mul(ex, ex), dvd(d00, d22s));
    const float syy = sub(mul(ey, ey), dvd(d11, d22s));
    const float sxy = sub(mul(ex, ey), dvd(d01, d22s));
    const float rf = sqr(dvd(clamp_min(tau, 0.0f), cfg.filter_inv_square));
    const float r = add(add(sqr(add(mul(ex, ex), mul(ey, ey))), rf), cfg.margin);
    const float r2 = mul(r, r);
    const float fxx = mul(add(sxx, r2), cfg.grow);
    const float fyy = mul(add(syy, r2), cfg.grow);
    const float fxy = mul(sxy, cfg.grow);
    const float det = sub(mul(fxx, fyy), mul(fxy, fxy));
    const float det_s = det > 0.0f ? det : 1.0f;
    const float ext[2] = {ceilf(sqr(clamp_min(fxx, 0.0f))),
                          ceilf(sqr(clamp_min(fyy, 0.0f)))};
    const float pix[2] = {add(F.c[0], ex), add(F.c[1], ey)};
    const float grid[2] = {(float)cfg.tiles_x, (float)cfg.tiles_y};
    int lo[2], hi[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float a = floorf(mul(sub(pix[k], ext[k]), cfg.inv_tile));
      const float b = add(floorf(mul(add(pix[k], ext[k]), cfg.inv_tile)), 1.0f);
      lo[k] = __float2int_rz(clamp(a, 0.0f, grid[k]));
      hi[k] = __float2int_rz(clamp(b, 0.0f, grid[k]));
    }
    const bool valid = bounded && F.pv[2] > s_cam[kZnear] &&
                       F.op > cfg.alpha_min && det > 0.0f &&
                       isfinite(pix[0]) && isfinite(pix[1]);
    int area = max(hi[0] - lo[0], 0) * max(hi[1] - lo[1], 0);
    if (!valid) area = 0;
    over = area > cfg.kmax;

#pragma unroll
    for (int r0 = 0; r0 < 3; ++r0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) out_t[9 * i + 3 * r0 + k] = F.t[r0][k];
    }
    reinterpret_cast<float2*>(out_c)[i] = make_float2(F.c[0], F.c[1]);
    const Basis<DEG> basis(F.dir);
    const float* cf = s_sh + threadIdx.x * stride<KC>();
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      out_color[3 * i + ch] = clamp_min(basis.colour(cf, ch), 0.0f);
      out_normal[3 * i + ch] = mul(F.ax[2][ch], F.flip);
    }
    out_opacity[i] = F.op;
    out_mask[i] = valid && area > 0;
    reinterpret_cast<float2*>(out_uv)[i] =
        make_float2(mul(pix[0], cfg.inv_width), mul(pix[1], cfg.inv_height));
    out_conic[3 * i] = dvd(mul(tau, fyy), det_s);
    out_conic[3 * i + 1] = dvd(mul(-tau, fxy), det_s);
    out_conic[3 * i + 2] = dvd(mul(tau, fxx), det_s);
    out_depth[i] = F.pv[2];
    out_radius[i] = fmaxf(ext[0], ext[1]);
    out_rect[i] = make_int4(lo[0], lo[1], hi[0], hi[1]);
    out_counts[i] = min(area, cfg.kmax);
  }
  if (__any_sync(0xffffffffu, over) && (threadIdx.x & 31) == 0) *overflow = true;
}

// The SH colour's backward (K9's): the coefficients' gradients into c (in
// place of the coefficients), and the direction's gradient gd.
template <int KC, int DEG>
__device__ __forceinline__ void sh_backward(const Basis<DEG>& B, float* c,
                                            const float gcol[3], float gd[3]) {
  float gres[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    gres[ch] = B.colour(c, ch) >= 0.0f ? gcol[ch] : 0.0f;
  float v[16];
#pragma unroll
  for (int k = 0; k < (DEG + 1) * (DEG + 1); ++k)
    v[k] = gres[0] * c[3 * k] + gres[1] * c[3 * k + 1] + gres[2] * c[3 * k + 2];
  gd[0] = gd[1] = gd[2] = 0.0f;
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
}

template <int KC, int DEG>
__global__ void __launch_bounds__(kThreads)
splat2d_project_bwd_kernel(
    int n, const float* __restrict__ means,
    const float* __restrict__ log_scales, const float* __restrict__ quats,
    const float* __restrict__ opacity_logits, const float* __restrict__ sh,
    const float* view, const float* full_proj, const float* cam_pos,
    const float* focal, const float* tan_fov, const float* znear,
    GsplatSurfelConfig cfg, const float* __restrict__ g_t,
    const float* __restrict__ g_c, const float* __restrict__ g_color,
    const float* __restrict__ g_opacity, const float* __restrict__ g_normal,
    float* __restrict__ d_means, float* __restrict__ d_log_scales,
    float* __restrict__ d_quats, float* __restrict__ d_opacity_logits,
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
    float gt[3][3], gcen[2], gcol[3], gn[3];
    bool live = false;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gt[r][k] = __ldg(g_t + 9 * i + 3 * r + k);
        live |= gt[r][k] != 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gcol[k] = __ldg(g_color + 3 * i + k);
      gn[k] = __ldg(g_normal + 3 * i + k);
      live |= gcol[k] != 0.0f || gn[k] != 0.0f;
    }
    gcen[0] = __ldg(g_c + 2 * i);
    gcen[1] = __ldg(g_c + 2 * i + 1);
    const float gop = __ldg(g_opacity + i);
    live |= gcen[0] != 0.0f || gcen[1] != 0.0f || gop != 0.0f;
    float gp[3] = {0.0f, 0.0f, 0.0f}, gls[2] = {0.0f, 0.0f};
    float gq[4] = {0.0f, 0.0f, 0.0f, 0.0f}, gol = 0.0f;
    if (live) {
      Surfel F;
      surfel_forward(F, means, log_scales, quats, __ldg(opacity_logits + i),
                     i, s_cam, cfg);
      const float* cam = s_cam;
      const float* w = cam + kView;
      // Colour and direction.
      const Basis<DEG> B(F.dir);
      float gd[3];
      sh_backward<KC, DEG>(B, c, gcol, gd);
      const float dnc = fmaxf(F.dn, 1e-12f);
      const float dotd = gd[0] * F.rel[0] + gd[1] * F.rel[1] + gd[2] * F.rel[2];
      const float gnorm = F.dn >= 1e-12f ? -dotd / (dnc * dnc) : 0.0f;
      const float gn_over = F.dn > 0.0f ? gnorm / F.dn : 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) gp[k] = gd[k] / dnc + F.rel[k] * gn_over;
      gol = gop * F.op * (1.0f - F.op);
      // c = (T_02, T_12) / z_s: its gradient into T (z_s = T_22 in front).
      gt[0][2] += gcen[0] / F.z_s;
      gt[1][2] += gcen[1] / F.z_s;
      if (F.pv[2] > cam[kZnear])
        gt[2][2] -= (gcen[0] * F.c[0] + gcen[1] * F.c[1]) / F.z_s;
      // T = K M: M's gradient.
      const float fx = cam[kFocal], fy = cam[kFocal + 1];
      float gm[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gm[0][k] = fx * gt[0][k];
        gm[1][k] = fy * gt[1][k];
        gm[2][k] = cfg.half_width * gt[0][k] + cfg.half_height * gt[1][k]
                   + gt[2][k];
      }
      // Column 2, p_view = W p + t.
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gp[k] += w[k] * gm[0][2] + w[4 + k] * gm[1][2] + w[8 + k] * gm[2][2];
      // Columns 0 and 1: s W R[:, k]; the normal: flip W R[:, 2]. ga[k]
      // is the gradient of W R[:, k].
      float ga[3][3];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int r = 0; r < 3; ++r) ga[k][r] = gm[r][k] * F.s[k];
        gls[k] = (gm[0][k] * F.ax[k][0] + gm[1][k] * F.ax[k][1]
                  + gm[2][k] * F.ax[k][2]) * F.s[k];
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) ga[2][r] = gn[r] * F.flip;
      float grot[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          grot[a][k] = w[a] * ga[k][0] + w[4 + a] * ga[k][1]
                       + w[8 + a] * ga[k][2];
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
    } else {
#pragma unroll
      for (int k = 0; k < KC; ++k) c[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) d_means[3 * i + k] = gp[k];
    reinterpret_cast<float2*>(d_log_scales)[i] = make_float2(gls[0], gls[1]);
    reinterpret_cast<float4*>(d_quats)[i] = make_float4(gq[0], gq[1], gq[2], gq[3]);
    d_opacity_logits[i] = gol;
  }
  __syncthreads();
  stage_out<KC>(s_sh, row0, rows, d_sh);
}

template <int KC>
size_t sh_bytes() { return (size_t)kThreads * stride<KC>() * sizeof(float); }

template <int KC, int DEG>
cudaError_t launch_fwd(int n, const float* const* in,
                       const float* const* camera,
                       const GsplatSurfelConfig& cfg, void* const* out,
                       cudaStream_t st) {
  splat2d_project_fwd_kernel<KC, DEG><<<(n + kThreads - 1) / kThreads,
                                        kThreads, sh_bytes<KC>(), st>>>(
      n, in[0], in[1], in[2], in[3], in[4], camera[0], camera[1], camera[2],
      camera[3], camera[4], camera[5], cfg, (float*)out[0], (float*)out[1],
      (float*)out[2], (float*)out[3], (float*)out[4], (bool*)out[5],
      (float*)out[6], (float*)out[7], (float*)out[8], (float*)out[9],
      (int4*)out[10], (int*)out[11], (bool*)out[12]);
  return cudaGetLastError();
}

template <int KC, int DEG>
cudaError_t launch_bwd(int n, const float* const* in,
                       const float* const* camera,
                       const GsplatSurfelConfig& cfg, const float* const* grad,
                       float* const* out, cudaStream_t st) {
  splat2d_project_bwd_kernel<KC, DEG><<<(n + kThreads - 1) / kThreads,
                                        kThreads, sh_bytes<KC>(), st>>>(
      n, in[0], in[1], in[2], in[3], in[4], camera[0], camera[1], camera[2],
      camera[3], camera[4], camera[5], cfg, grad[0], grad[1], grad[2],
      grad[3], grad[4], out[0], out[1], out[2], out[3], out[4]);
  return cudaGetLastError();
}

}  // namespace

// The scene's coefficients a surfel (1, 4, 9 or 16) and the degree the
// colour is evaluated at pick the instance.
#define GSPLAT_SURFEL_DISPATCH(CALL)                                         \
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

// in: means, log_scales (N, 2), quats, opacity_logits, sh; camera: view,
// full_proj, cam_pos, focal, tan_fov, znear; out: T, c, colour, opacity,
// normal, mask, uv, conic, depth, radius, rect, counts, overflow.
extern "C" int gsplat_surfel_project_fwd(int n, int coeffs, int degree,
                                         const float* const* in,
                                         const float* const* camera,
                                         GsplatSurfelConfig cfg,
                                         void* const* out, void* cuda_stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GSPLAT_FWD(KC, DEG) launch_fwd<KC, DEG>(n, in, camera, cfg, out, st)
  GSPLAT_SURFEL_DISPATCH(GSPLAT_FWD)
#undef GSPLAT_FWD
}

// grad: T, c, colour, opacity, normal gradients; out: means, log_scales,
// quats, opacity_logits, sh gradients.
extern "C" int gsplat_surfel_project_bwd(int n, int coeffs, int degree,
                                         const float* const* in,
                                         const float* const* camera,
                                         GsplatSurfelConfig cfg,
                                         const float* const* grad,
                                         float* const* out,
                                         void* cuda_stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GSPLAT_BWD(KC, DEG) launch_bwd<KC, DEG>(n, in, camera, cfg, grad, out, st)
  GSPLAT_SURFEL_DISPATCH(GSPLAT_BWD)
#undef GSPLAT_BWD
}
