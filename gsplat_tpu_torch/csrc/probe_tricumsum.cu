// P2: the precision-pass probe, a triangular cumsum on the tensor cores.
//
// Replaces the TPU kernel scripts/micro_kernel_costs.py::_cumsum_kernel
// (pallas_call at :134, in bench_precision): out = x @ tri for float32 x of
// shape (rows, 128) and tri = make_triangular(128) (tri[k][n] = 1 if k <= n),
// a running sum along the last axis, computed as the TPU computes a float32
// matmul at each precision: x and tri split into bf16 parts, the products of
// parts summed in float32.
//   default  1 pass:  hi.hi
//   high     3 passes on a two-way split (lo = bf16(x - hi)):
//            hi.lo, lo.hi, hi.hi
//   highest  6 passes on a three-way split (mid = bf16(x - hi),
//            lo = bf16(x - hi - mid)): hi.lo, lo.hi, mid.mid, hi.mid,
//            mid.hi, hi.hi
// (x part . tri part, smallest terms first, as
// gsplat_tpu_torch/ops/cuda/probes.py::PASSES). tri is 0/1, so its parts
// below hi are exactly 0; the kernel issues those passes all the same, with
// zero B fragments, because the probe measures what the passes cost. ptxas
// treats an mma as a pure function and merges identical ones: the n-tiles
// right of the diagonal add the same product A.1 to accumulators that start
// equal, and a first build issued 79 / 222 / 459 of the 128 / 384 / 768 mma
// a strip needs. So each accumulator starts from its own multiple of the
// kernel argument `zero` (0 at run time, which ptxas cannot see), and the
// zero B fragments are `zero` too: every mma of the dense product is issued,
// as the TPU's matrix unit does them.
//
// What bounds it on an H100: bytes at every precision. At the script's shape
// (4096 x 1024 rows of 128) it must read and write 2 GiB each, 4.295e9 bytes,
// 1.282 ms at 3.35 TB/s. The tensor-core work is 2 x 4,194,304 x 128 x 128 =
// 1.374e11 FLOP per pass, 0.139 ms at 989 TFLOP/s dense bf16: 0.139 / 0.417 /
// 0.834 ms for 1 / 3 / 6 passes. The split adds at most 2 float32
// subtractions per element. Design: every element of x is read once for all
// passes. Each warp owns a 16-row strip: it copies the strip (8 KB) into
// shared memory with 16-byte cp.async, then for each of the 8 k-steps of 16
// reads its A fragment (row-major 16x16) from shared memory, splits it into
// bf16 parts in registers (__float2bfloat16_rn, float32 rests, exact), and
// issues mma.sync.m16n8k16 (bf16 in, f32 accumulate) for the 16 n-tiles of 8
// columns, every pass into the same 64 float32 accumulators. B (tri) is
// built from indices: a 16x8 block of tri is all 0 left of the diagonal, all
// 1 right of it, and one of two fixed patterns on it, computed once per
// lane. The accumulators go back through the same shared strip and out as
// coalesced 16-byte stores. The shared rows are padded to 136 floats, so the
// 8-byte fragment reads and writes are free of bank conflicts. Plain
// mma.sync: no wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kG = 128;            // columns of x, and tri is kG x kG
constexpr int kStride = kG + 8;    // floats per shared row
constexpr int kRows = 16;          // rows of a warp's strip
constexpr int kWarps = 4;          // warps per CTA
constexpr uint32_t kOne = 0x3F80;  // bf16 1.0

// (x part, tri part) of pass p of a precision with `passes` passes: parts 0
// hi, 1 mid (the two-way split's lo), 2 lo. probes.py::PASSES.
__host__ __device__ constexpr int x_part(int passes, int p) {
  return passes == 1 ? 0
       : passes == 3 ? (p == 1 ? 1 : 0)
       : (p == 1 ? 2 : (p == 2 || p == 4) ? 1 : 0);
}
__host__ __device__ constexpr int t_part(int passes, int p) {
  return passes == 1 ? 0
       : passes == 3 ? (p == 0 ? 1 : 0)
       : (p == 0 ? 2 : (p == 2 || p == 3) ? 1 : 0);
}
__host__ __device__ constexpr int num_parts(int passes) {
  return passes == 1 ? 1 : passes == 3 ? 2 : 3;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 h) {
  return (uint32_t)__bfloat16_as_ushort(h);
}

// Two elements (the lower k in the low half) of x split into kParts bf16
// parts, packed as the mma's A registers.
template <int kParts>
__device__ __forceinline__ void split_pair(float v0, float v1,
                                           uint32_t (&a)[3]) {
#pragma unroll
  for (int i = 0; i < kParts; ++i) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(v0);
    const __nv_bfloat16 h1 = __float2bfloat16_rn(v1);
    a[i] = bits(h0) | (bits(h1) << 16);
    v0 = __fsub_rn(v0, __bfloat162float(h0));
    v1 = __fsub_rn(v1, __bfloat162float(h1));
  }
}

// tri[k][n] for the pair (k, k + 1) at column n, as a bf16 pair.
__device__ __forceinline__ uint32_t tri_pair(int k, int n) {
  return (k <= n ? kOne : 0u) | ((k + 1 <= n ? kOne : 0u) << 16);
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

template <int kPasses>
__global__ void __launch_bounds__(kWarps * 32)
tricumsum_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int64_t rows, uint32_t zero) {
  constexpr int kParts = num_parts(kPasses);
  __shared__ __align__(16) float smem[kWarps][kRows * kStride];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t row0 = ((int64_t)blockIdx.x * kWarps + warp) * kRows;
  if (row0 >= rows) return;
  float* s = smem[warp];

  // The strip into shared memory: lane l copies 16 bytes of each row; rows
  // past the end are zero-filled.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool valid = row0 + r < rows;
    cp_async16(s + r * kStride + lane * 4,
               x + (valid ? (row0 + r) * kG + lane * 4 : 0), valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncwarp();

  // tri's blocks on the diagonal (n-tile 2kk and 2kk + 1 of k-step kk), the
  // same for every kk: B rows k = tig*2 (+1) and tig*2 + 8 (+1), column gid.
  const uint32_t d0[2] = {tri_pair(tig * 2, gid), tri_pair(tig * 2 + 8, gid)};
  const uint32_t d1[2] = {tri_pair(tig * 2, gid + 8),
                          tri_pair(tig * 2 + 8, gid + 8)};
  const uint32_t ones = kOne | (kOne << 16);

  // +0.0f each, from products ptxas cannot prove equal (see the note).
  float acc[kG / 8][4];
#pragma unroll
  for (int nt = 0; nt < kG / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[nt][i] = __uint_as_float(zero * (uint32_t)(4 * nt + i + 1));

#pragma unroll
  for (int kk = 0; kk < kG / 16; ++kk) {
    // A fragment: rows gid and gid + 8, columns tig*2 (+1) and tig*2 + 8
    // (+1) of this k-step, split into parts.
    const float* top = s + gid * kStride + kk * 16 + tig * 2;
    const float* bottom = top + 8 * kStride;
    const float2 v0 = *reinterpret_cast<const float2*>(top);
    const float2 v1 = *reinterpret_cast<const float2*>(bottom);
    const float2 v2 = *reinterpret_cast<const float2*>(top + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(bottom + 8);
    uint32_t a0[3], a1[3], a2[3], a3[3];
    split_pair<kParts>(v0.x, v0.y, a0);
    split_pair<kParts>(v1.x, v1.y, a1);
    split_pair<kParts>(v2.x, v2.y, a2);
    split_pair<kParts>(v3.x, v3.y, a3);
#pragma unroll
    for (int nt = 0; nt < kG / 8; ++nt) {
      uint32_t b0 = zero, b1 = zero;  // left of the diagonal: tri is 0
      if (nt == 2 * kk) {
        b0 = d0[0]; b1 = d0[1];
      } else if (nt == 2 * kk + 1) {
        b0 = d1[0]; b1 = d1[1];
      } else if (nt > 2 * kk + 1) {
        b0 = b1 = ones;
      }
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int xp = x_part(kPasses, p);
        const bool t_hi = t_part(kPasses, p) == 0;  // tri's other parts are 0
        mma(acc[nt], a0[xp], a1[xp], a2[xp], a3[xp], t_hi ? b0 : zero,
            t_hi ? b1 : zero);
      }
    }
  }

  // Accumulators (rows gid and gid + 8, columns nt*8 + tig*2 (+1)) back
  // into the strip, then out row by row.
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < kG / 8; ++nt) {
    float* c = s + gid * kStride + nt * 8 + tig * 2;
    *reinterpret_cast<float2*>(c) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(c + 8 * kStride) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r < rows)
      *reinterpret_cast<float4*>(out + (row0 + r) * kG + lane * 4) =
          *reinterpret_cast<const float4*>(s + r * kStride + lane * 4);
  }
}

}  // namespace

extern "C" int gsplat_probe_tricumsum(const float* x, float* out,
                                      int64_t rows, int passes,
                                      void* stream) {
  if (rows > 0) {
    const int64_t strips = (rows + kRows - 1) / kRows;
    const unsigned blocks = (unsigned)((strips + kWarps - 1) / kWarps);
    cudaStream_t s = (cudaStream_t)stream;
    switch (passes) {
      case 1: tricumsum_kernel<1><<<blocks, kWarps * 32, 0, s>>>(x, out, rows, 0u); break;
      case 3: tricumsum_kernel<3><<<blocks, kWarps * 32, 0, s>>>(x, out, rows, 0u); break;
      case 6: tricumsum_kernel<6><<<blocks, kWarps * 32, 0, s>>>(x, out, rows, 0u); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
