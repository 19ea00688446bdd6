// K3: exact ellipse-tile cull of the tiled binning's rect walk, fused with
// the per-row compaction that consumes it.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/cull.py::_cull_kernel and,
// in its compact stage, the XLA row sort that follows it
// (compact_k = sort(where(mask, k, kmax)), gsplat_tpu/ops/binning.py:359).
// For Gaussian row r and rect-walk index k < kmax it takes the tile
// (x0 + k mod w, y0 + k div w), finds the minimum of the conic quadratic
// q = A dx^2 + 2B dx dy + C dy^2 over that tile's pixel centres (0 if the
// centre is inside, else the minimum over the 4 edges of the clamped 1-D
// minimiser), and keeps the lane iff qmin <= tau and k < count. One row walk
// serves three output stages (`Stage`):
//   mask     the (N, kmax) bool mask (the 'sort' oracle);
//   compact  compact_k (N, kmax) int32, each row's kept k ascending padded
//            with kmax, and counts (N,) int32 (the base tiers);
//   rank     the mask, krank (N, kmax) int32 = cumsum(mask, 1) - 1, and
//            counts (the jumbo grid).
// A copy of the walk in its own kernel, `cull_kernel_count`, is the count
// stage: each row's kept lanes as ballot words, ballots (N, ceil(kmax / 32))
// uint32 (bit k % 32 of word k / 32), and counts (N,) int32, the first half
// of the 'packed' route; optionally without the cull (k < count alone, for
// tile_culling=False), and keeping only the lanes whose tile id y * tiles_x
// + x lies in [tile_lo, tile_hi) (a band of the sharded paths; the whole
// grid else). Its own kernel leaves the three stages' code, and so their
// instructions, as they were.
// A second kernel, `cull_kernel_emit` (named under K3's prefix, as the
// profiler's readers find K3), is the route's second half: it reads the
// count stage's ballots, not the cull, and writes each kept lane at rank j
// of row g into slot offsets[g] + j of a max_slots stream, if that is below
// max_slots: key = (tile - tile_lo) << depth_bits | depth_q[g] (int64) and
// gidk = g << kb | k (int32). The caller fills the stream first (with the
// sentinel key, -1) and sorts it after; in lane order (Gaussian-major, k
// ascending) the stable sort gives the ties of a stable sort of every lane.
// A third kernel, `cull_kernel_tier`, is the tiered route's count and emit:
// it runs no cull either, and reads what the compact and rank stages wrote
// (compact_k, the jumbo grid's mask and krank). Its rows are the tiers'
// rows in the order the tiered route emits them (base tiers in ladder
// order, then the jumbo tiers); counted, scanned by the caller and emitted
// at their offsets, the kept lanes are those of every tier's (rows, width)
// lane grid, concatenated, in that order, so a stable sort of the
// max_slots keys ties as the stable sort of every grid's lanes did.
//
// What bounds it on an H100: the bytes it writes. At the bench shape (N =
// 1M, kmax = 64) the compact stage writes 256 MB of compact_k and 4 MB of
// counts and reads 40 MB of parameters: 0.090 ms at 3.35 TB/s, against
// 0.067 ms for the FP32 operations (70 per lane: k div/mod w 5, tile origin
// 2, pixel-rect offsets 8, inside test 4, four edges of 11, min and tests
// 7; 5 per row: -b/a, -b/c, 2b). The mask stage writes kmax bytes a row,
// the rank stage kmax bytes and 4 kmax bytes a row (152 MB on the jumbo
// grid of 14,848 x 2048). The count stage writes only 4 + kmax / 8 bytes a
// row, so the operations bound it: at bicycle's 6M x 64 = 384M lanes, 27
// GFLOP, 0.40 ms at 67 TFLOP/s, against 288 MB (0.086 ms); it takes 0.92
// ms, the mask stage's walk of the same lanes 0.67. The emit stage runs no
// cull; the bytes bound it: 12 B a kept slot and 24 B a row of parameters,
// offset and depth key read, 8 B of ballots (0.12 ms at bicycle's 17.1M
// slots); 0.55 ms with the caller's fill. Keeping the ballots (48 MB at
// bicycle) spares the emit a second walk of the cull, which alone costs
// more than the whole emit (PERF.md, K3 count and emit; an H100 80GB HBM3
// at 700 W). The tiered count reads 4 B a base row (no band) and a jumbo
// row's lanes; the tiered emit writes 12 B a kept slot and reads 16 to 32 B
// of compact_k a base row, 5 B a jumbo lane.
//
// Design: a warp walks rows one after another, in chunks of 32 lanes
// (consecutive k). The warp's lanes first load up to 32 rows' parameters
// (lane i row i: the loads coalesce) and form each row's terms once, the two
// per-row quotients -b/a and -b/c included; the walk then takes row j's
// terms from lane j by shuffle. Chunks past the row's walk bound (k >=
// count) test nothing: every lane there fails. A chunk's kept lanes are a
// __ballot_sync; a kept lane's place in the compacted row is the running
// count of the earlier chunks plus the popcount of the ballot below it, so
// the compact stage stores each kept k once at its place and fills the rest
// of the row with kmax: the row sort, the where and the sum that read the
// mask before are gone; the count stage stores the ballot itself (one word
// a chunk, from lane 0), held to 64 registers as the mask stage is. Rows
// per warp: 32 at kmax 64 (the parameter loads of a row are shared by 32
// rows' walks), down to 1 at kmax 2048 (so the jumbo grid still has a warp
// per row). The emit is a thread a row instead, walking its stored words'
// set bits in k order: a row keeps about 3 of its 64 lanes at bicycle, and
// a warp that shuffled each row's terms to 32 lanes to write them took
// 0.84 ms where a thread a row takes 0.55.
//
// Exactness: every product, sum and quotient goes through __fmul_rn,
// __fadd_rn, __fsub_rn and __fdiv_rn, which nvcc never contracts into FMAs,
// in the operation order of the plain PyTorch version
// (gsplat_tpu_torch/ops/cuda/cull.py::cull_mask_plain), so the kept lanes
// equal the plain ones bit for bit; the compaction, the ranks and the slots
// are integer counts, and a tile id is y * tiles_x + x of the walk's
// integral x and y. k div w is the plain version's floor((k + 0.5) / w); where
// w is an integer in [1, 4096] and kmax <= 4096 it is the same integer by a
// multiply with ceil(2^24 / w) (exact since k w < 2^24; both are pinned by
// tests/test_torch_binning.py), else the f32 division itself. Minima and
// clamps keep NaNs (min.NaN / max.NaN) as torch.minimum and torch.clamp do:
// a NaN centre, conic, bound or walk width drops the lane as in the plain
// version, where fminf / fmaxf would drop the NaN and keep the lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Parameter rows of the (10, N) float32 input (cull.py::cull_params).
enum { R_GX, R_GY, R_A, R_B, R_C, R_TAU, R_X0, R_Y0, R_W, R_COUNT };
// Output stages (cull.py::STAGES).
enum Stage { kMask = 0, kCompact = 1, kRank = 2 };

constexpr unsigned kFull = 0xffffffffu;
// k div w by the multiply for k < kMagicLimit and integral w <= kMagicLimit.
constexpr int kMagicLimit = 4096;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// NaN if either operand is NaN, as torch.minimum / torch.maximum.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.clamp(x, lo, hi): NaN if any of the three is.
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

// a*dx*dx + (2b)*dx*dy + c*dy*dy, left to right as Python evaluates it.
__device__ __forceinline__ float quad(float a, float b2, float c, float dx,
                                      float dy) {
  return add(add(mul(mul(a, dx), dx), mul(mul(b2, dx), dy)),
             mul(mul(c, dy), dy));
}

// One row's parameters and the terms the test needs once per row.
struct Row {
  float gx, gy, a, b2, c, tau, x0, y0, w, count;
  float nb_over_a, nb_over_c;  // -b / max(a, 1e-12), -b / max(c, 1e-12)
  uint32_t magic;              // ceil(2^24 / w) for an integral w, else 0
};

__device__ __forceinline__ Row load_row(const float* __restrict__ params,
                                        int64_t n, int64_t r, int kmax) {
  Row q;
  q.gx = params[R_GX * n + r];
  q.gy = params[R_GY * n + r];
  q.a = params[R_A * n + r];
  const float b = params[R_B * n + r];
  q.c = params[R_C * n + r];
  q.tau = params[R_TAU * n + r];
  q.x0 = params[R_X0 * n + r];
  q.y0 = params[R_Y0 * n + r];
  q.w = params[R_W * n + r];
  q.count = params[R_COUNT * n + r];
  q.nb_over_a = __fdiv_rn(-b, max_nan(q.a, 1e-12f));
  q.nb_over_c = __fdiv_rn(-b, max_nan(q.c, 1e-12f));
  q.b2 = mul(2.0f, b);
  const bool int_w = q.w >= 1.f && q.w <= (float)kMagicLimit &&
                     q.w == floorf(q.w) && kmax <= kMagicLimit;
  const uint32_t w = int_w ? (uint32_t)q.w : 1u;
  q.magic = int_w ? ((1u << 24) + w - 1u) / w : 0u;
  return q;
}

// Row j of the warp's rows, from lane j.
__device__ __forceinline__ Row shfl_row(const Row& m, int j) {
  Row q;
  q.gx = __shfl_sync(kFull, m.gx, j);
  q.gy = __shfl_sync(kFull, m.gy, j);
  q.a = __shfl_sync(kFull, m.a, j);
  q.b2 = __shfl_sync(kFull, m.b2, j);
  q.c = __shfl_sync(kFull, m.c, j);
  q.tau = __shfl_sync(kFull, m.tau, j);
  q.x0 = __shfl_sync(kFull, m.x0, j);
  q.y0 = __shfl_sync(kFull, m.y0, j);
  q.w = __shfl_sync(kFull, m.w, j);
  q.count = __shfl_sync(kFull, m.count, j);
  q.nb_over_a = __shfl_sync(kFull, m.nb_over_a, j);
  q.nb_over_c = __shfl_sync(kFull, m.nb_over_c, j);
  q.magic = __shfl_sync(kFull, m.magic, j);
  return q;
}

// The lane test of rect-walk index k of row q.
__device__ __forceinline__ bool keep(const Row& q, int k, float ts,
                                     float ts1) {
  const float kf = (float)k;
  // k div w: floor((k + 0.5) / w), the same integer as k * magic >> 24.
  const float ky = q.magic
      ? (float)__umulhi((uint32_t)k << 8, q.magic)
      : floorf(__fdiv_rn(add(kf, 0.5f), q.w));
  const float kx = sub(kf, mul(ky, q.w));
  const float tx = add(q.x0, kx);
  const float ty = add(q.y0, ky);

  const float dx0 = sub(mul(tx, ts), q.gx);
  const float dx1 = add(dx0, ts1);
  const float dy0 = sub(mul(ty, ts), q.gy);
  const float dy1 = add(dy0, ts1);
  const bool inside =
      (dx0 <= 0.f) && (0.f <= dx1) && (dy0 <= 0.f) && (0.f <= dy1);

  // Edges dx = d (minimise over dy) and dy = d (minimise over dx).
  const float ex0 =
      quad(q.a, q.b2, q.c, dx0, clip(mul(q.nb_over_c, dx0), dy0, dy1));
  const float ex1 =
      quad(q.a, q.b2, q.c, dx1, clip(mul(q.nb_over_c, dx1), dy0, dy1));
  const float ey0 =
      quad(q.a, q.b2, q.c, clip(mul(q.nb_over_a, dy0), dx0, dx1), dy0);
  const float ey1 =
      quad(q.a, q.b2, q.c, clip(mul(q.nb_over_a, dy1), dx0, dx1), dy1);
  float qmin = min_nan(min_nan(ex0, ex1), min_nan(ey0, ey1));
  if (inside) qmin = 0.f;
  return (qmin <= q.tau) && (kf < q.count);
}

template <int STAGE>
__global__ void cull_kernel(const float* __restrict__ params, int64_t n,
                            int kmax, float ts, int rows_per_warp,
                            uint8_t* __restrict__ mask,
                            int32_t* __restrict__ idx,
                            int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t r0 =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * rows_per_warp;
  if (r0 >= n) return;  // the whole warp
  const int rows = (int)(n - r0 < rows_per_warp ? n - r0 : rows_per_warp);
  Row mine = {};
  if (lane < rows) mine = load_row(params, n, r0 + lane, kmax);
  const float ts1 = sub(ts, 1.0f);
  const int chunks = (kmax + 31) >> 5;
  const unsigned below_me = (1u << lane) - 1u;

  for (int j = 0; j < rows; ++j) {
    const Row q = shfl_row(mine, j);
    const int64_t base = (r0 + j) * (int64_t)kmax;
    int carry = 0;  // kept lanes of the earlier chunks
    for (int c = 0; c < chunks; ++c) {
      // Past the walk bound no lane is kept (nor for a NaN count).
      const bool walk = (float)(c << 5) < q.count;
      if (STAGE == kCompact && !walk) break;
      const int k = (c << 5) + lane;
      const bool kept = walk && k < kmax && keep(q, k, ts, ts1);
      if (STAGE == kMask) {
        if (k < kmax) mask[base + k] = kept;
        continue;
      }
      const unsigned ballot = __ballot_sync(kFull, kept);
      const int before = carry + __popc(ballot & below_me);
      if (STAGE == kCompact) {
        if (kept) idx[base + before] = k;
      } else if (k < kmax) {
        mask[base + k] = kept;
        idx[base + k] = before + (int)kept - 1;
      }
      carry += __popc(ballot);
    }
    if (STAGE == kCompact) {
      for (int p = lane; p < kmax; p += 32)
        if (p >= carry) idx[base + p] = kmax;
    }
    if (STAGE != kMask && lane == 0) counts[r0 + j] = carry;
  }
}


// The tile (tx, ty) of rect-walk index k of row q: the first steps of keep.
__device__ __forceinline__ void walk_tile(const Row& q, int k, float& tx,
                                          float& ty) {
  const float kf = (float)k;
  const float ky = q.magic
      ? (float)__umulhi((uint32_t)k << 8, q.magic)
      : floorf(__fdiv_rn(add(kf, 0.5f), q.w));
  const float kx = sub(kf, mul(ky, q.w));
  tx = add(q.x0, kx);
  ty = add(q.y0, ky);
}

// The tile id y * tiles_x + x of a walk tile (integers, exact in float).
__device__ __forceinline__ int tile_id(float tx, float ty, int tiles_x) {
  return __float2int_rz(ty) * tiles_x + __float2int_rz(tx);
}

// The count stage: cull_kernel's row walk, without the cull on request,
// keeping the lanes of the band's tiles and each chunk's ballot. Held to 64
// registers (4 blocks of 256 threads an SM, as the mask stage gets).
__global__ void __launch_bounds__(256, 4)
    cull_kernel_count(const float* __restrict__ params, int64_t n, int kmax,
                      float ts, int rows_per_warp, int cull, int tiles_x,
                      int tile_lo, int tile_hi,
                      uint32_t* __restrict__ ballots,
                      int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t r0 =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * rows_per_warp;
  if (r0 >= n) return;  // the whole warp
  const int rows = (int)(n - r0 < rows_per_warp ? n - r0 : rows_per_warp);
  Row mine = {};
  if (lane < rows) mine = load_row(params, n, r0 + lane, kmax);
  const float ts1 = sub(ts, 1.0f);
  const int chunks = (kmax + 31) >> 5;

  for (int j = 0; j < rows; ++j) {
    const Row q = shfl_row(mine, j);
    int carry = 0;  // kept lanes of the row
    for (int c = 0; c < chunks; ++c) {
      const int k = (c << 5) + lane;
      bool kept = (float)(c << 5) < q.count && k < kmax &&
                  (cull ? keep(q, k, ts, ts1) : (float)k < q.count);
      if (kept) {
        float tx, ty;
        walk_tile(q, k, tx, ty);
        const int t = tile_id(tx, ty, tiles_x);
        kept = t >= tile_lo && t < tile_hi;
      }
      const unsigned ballot = __ballot_sync(kFull, kept);
      if (lane == 0) ballots[(r0 + j) * chunks + c] = ballot;
      carry += __popc(ballot);
    }
    if (lane == 0) counts[r0 + j] = carry;
  }
}

// The 'packed' route's emit: a thread a row, which walks the set bits of
// its ballot words in k order; its slot starts at the row's offset and
// steps by one a kept lane. No shuffles: every row is its own thread.
__global__ void cull_kernel_emit(const float* __restrict__ params,
                                 const uint32_t* __restrict__ ballots,
                                 const int32_t* __restrict__ offsets,
                                 const int64_t* __restrict__ depth_q,
                                 int64_t n, int kmax, int tiles_x,
                                 int tile_lo, int depth_bits, int kb,
                                 int64_t max_slots,
                                 int64_t* __restrict__ keys,
                                 int32_t* __restrict__ gidk) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int chunks = (kmax + 31) >> 5;
  Row q;
  q.x0 = params[R_X0 * n + g];
  q.y0 = params[R_Y0 * n + g];
  q.w = params[R_W * n + g];
  // ceil(2^24 / w) for an integral w, as load_row computes it.
  const bool int_w = q.w >= 1.f && q.w <= (float)kMagicLimit &&
                     q.w == floorf(q.w) && kmax <= kMagicLimit;
  const uint32_t w = int_w ? (uint32_t)q.w : 1u;
  q.magic = int_w ? ((1u << 24) + w - 1u) / w : 0u;
  const int64_t dq = depth_q[g];
  int64_t slot = offsets[g];
  for (int c = 0; c < chunks; ++c) {
    uint32_t ballot = ballots[g * chunks + c];
    for (; ballot != 0u && slot < max_slots; ++slot) {
      const int k = (c << 5) + __ffs(ballot) - 1;
      ballot &= ballot - 1u;
      float tx, ty;
      walk_tile(q, k, tx, ty);
      const int64_t t = tile_id(tx, ty, tiles_x) - tile_lo;
      keys[slot] = (t << depth_bits) | dq;
      gidk[slot] = (int32_t)((g << kb) | k);
    }
  }
}

// The tiered route's rows, in emission order: the base tiers (dense: row i
// is Gaussian i; pool: row i is ids_pool[i]) in ladder order, then the
// jumbo tiers (row j is ids_r[j] and row j of the rank stage's grid).
// Tier t holds the rows [start[t], start[t + 1]) and the lanes [k_lo[t],
// k_hi[t]) of each. RenderConfig refuses a ladder of more tiers
// (config.py, MAX_TIERS).
constexpr int kMaxTiers = 32;
enum TierKind { kDense = 0, kPool = 1, kJumbo = 2 };
struct Tiers {
  int64_t start[kMaxTiers + 1];
  int k_lo[kMaxTiers], k_hi[kMaxTiers], kind[kMaxTiers];
  int num, num_base;  // tiers; of them base tiers, which come first
};

// What the tiered count and emit read of a row's Gaussian: its walk's
// origin, width and k div w multiplier, as load_row has them.
__device__ __forceinline__ Row walk_row(const float* __restrict__ params,
                                        int64_t n, int64_t g, int kmax) {
  Row q;
  q.x0 = params[R_X0 * n + g];
  q.y0 = params[R_Y0 * n + g];
  q.w = params[R_W * n + g];
  const bool int_w = q.w >= 1.f && q.w <= (float)kMagicLimit &&
                     q.w == floorf(q.w) && kmax <= kMagicLimit;
  const uint32_t w = int_w ? (uint32_t)q.w : 1u;
  q.magic = int_w ? ((1u << 24) + w - 1u) / w : 0u;
  return q;
}

// The tiered route's count (row_counts set: each row's kept lanes) and emit
// (row_counts null: each kept lane at slot offsets[row] + its rank in the
// row, those below max_slots). A base row keeps its lanes k in [k_lo,
// min(k_hi, counts[g])), the tile of walk index compact_k[g, k], gidk g << kb
// | k; a jumbo row the lanes k in [k_lo, k_hi) that the rank stage's mask
// holds, the tile of walk index k, gidk g << kb | krank[j, k]. With a band
// only the lanes whose tile lies in [tile_lo, tile_hi) are kept. key = (tile
// - tile_lo) << depth_bits | depth_q[g]. Base rows are a thread each (a
// dense row has 4 to 8 lanes), jumbo rows a warp each (up to 1024 lanes,
// read 32 at a time): the first base_blocks blocks take the base rows.
__global__ void __launch_bounds__(256) cull_kernel_tier(
    const Tiers tiers, const float* __restrict__ params, int64_t n,
    const int64_t* __restrict__ depth_q, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ compact_k, int kmax,
    const int64_t* __restrict__ ids_pool, const int64_t* __restrict__ ids_r,
    const uint8_t* __restrict__ maskj, const int32_t* __restrict__ krank,
    int jumbo, int tiles_x, int band, int tile_lo, int tile_hi,
    int depth_bits, int kb, unsigned base_blocks,
    int32_t* __restrict__ row_counts, const int32_t* __restrict__ offsets,
    int64_t max_slots, int64_t* __restrict__ keys,
    int32_t* __restrict__ gidk) {
  const bool count = row_counts != nullptr;
  if (blockIdx.x < base_blocks) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= tiers.start[tiers.num_base]) return;
    int t = 0;
    while (r >= tiers.start[t + 1]) ++t;
    const int64_t i = r - tiers.start[t];
    const int64_t g = tiers.kind[t] == kDense ? i : ids_pool[i];
    const int k_lo = tiers.k_lo[t];
    const int k_hi = min(tiers.k_hi[t], counts[g]);
    if (count && !band) {
      row_counts[r] = max(k_hi - k_lo, 0);
      return;
    }
    const Row q = walk_row(params, n, g, kmax);
    const int64_t dq = count ? 0 : depth_q[g];
    int64_t slot = count ? 0 : offsets[r];
    int kept = 0;
    for (int k = k_lo; k < k_hi; ++k) {
      float tx, ty;
      walk_tile(q, compact_k[g * kmax + k], tx, ty);
      const int tile = tile_id(tx, ty, tiles_x);
      if (band && (tile < tile_lo || tile >= tile_hi)) continue;
      ++kept;
      if (count) continue;
      if (slot >= max_slots) break;
      keys[slot] = ((int64_t)(tile - tile_lo) << depth_bits) | dq;
      gidk[slot] = (int32_t)((g << kb) | k);
      ++slot;
    }
    if (count) row_counts[r] = kept;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int64_t r = tiers.start[tiers.num_base] +
      (((int64_t)(blockIdx.x - base_blocks) * blockDim.x + threadIdx.x) >> 5);
  if (r >= tiers.start[tiers.num]) return;  // the whole warp
  int t = tiers.num_base;
  while (r >= tiers.start[t + 1]) ++t;
  const int64_t j = r - tiers.start[t];
  const int64_t g = ids_r[j];
  const Row q = walk_row(params, n, g, jumbo);
  const int64_t dq = count ? 0 : depth_q[g];
  const int64_t slot0 = count ? 0 : offsets[r];
  const unsigned below_me = (1u << lane) - 1u;
  int carry = 0;  // kept lanes of the earlier chunks
  for (int c = tiers.k_lo[t]; c < tiers.k_hi[t]; c += 32) {
    if (!count && slot0 + carry >= max_slots) break;
    const int k = c + lane;
    bool kept = k < tiers.k_hi[t] && maskj[j * jumbo + k];
    int tile = 0;
    if (kept) {
      float tx, ty;
      walk_tile(q, k, tx, ty);
      tile = tile_id(tx, ty, tiles_x);
      kept = !band || (tile >= tile_lo && tile < tile_hi);
    }
    const unsigned ballot = __ballot_sync(kFull, kept);
    const int64_t slot = slot0 + carry + __popc(ballot & below_me);
    if (!count && kept && slot < max_slots) {
      keys[slot] = ((int64_t)(tile - tile_lo) << depth_bits) | dq;
      gidk[slot] = (int32_t)((g << kb) | krank[j * jumbo + k]);
    }
    carry += __popc(ballot);
  }
  if (count && lane == 0) row_counts[r] = carry;
}

// Warps of the row walk: rows per warp 32 at kmax 64 (the parameter loads
// of a row are shared by 32 rows' walks), down to 1 at kmax 2048 (so the
// jumbo grid still has a warp per row); 256 threads a block.
constexpr int kThreads = 256;

__host__ int walk_rows_per_warp(int kmax) {
  const int chunks = (kmax + 31) / 32;
  const int r = 64 / chunks;
  return r < 1 ? 1 : r > 32 ? 32 : r;
}

__host__ unsigned walk_blocks(int64_t n, int rows_per_warp) {
  const int64_t warps = (n + rows_per_warp - 1) / rows_per_warp;
  return (unsigned)((warps * 32 + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int gsplat_cull(const float* params, int64_t n, int kmax,
                           float tile_size, int stage, uint8_t* mask,
                           int32_t* idx, int32_t* counts, void* stream) {
  if (stage < kMask || stage > kRank) return (int)cudaErrorInvalidValue;
  if (n > 0 && kmax > 0) {
    const int rows_per_warp = walk_rows_per_warp(kmax);
    const unsigned blocks = walk_blocks(n, rows_per_warp);
    cudaStream_t s = (cudaStream_t)stream;
    if (stage == kMask)
      cull_kernel<kMask><<<blocks, kThreads, 0, s>>>(
          params, n, kmax, tile_size, rows_per_warp, mask, idx, counts);
    else if (stage == kCompact)
      cull_kernel<kCompact><<<blocks, kThreads, 0, s>>>(
          params, n, kmax, tile_size, rows_per_warp, mask, idx, counts);
    else
      cull_kernel<kRank><<<blocks, kThreads, 0, s>>>(
          params, n, kmax, tile_size, rows_per_warp, mask, idx, counts);
  }
  return (int)cudaGetLastError();
}

extern "C" int gsplat_cull_count(const float* params, int64_t n, int kmax,
                                 float tile_size, int cull, int tiles_x,
                                 int tile_lo, int tile_hi, uint32_t* ballots,
                                 int32_t* counts, void* stream) {
  if (n > 0 && kmax > 0) {
    const int rows_per_warp = walk_rows_per_warp(kmax);
    cull_kernel_count<<<walk_blocks(n, rows_per_warp), kThreads, 0,
                        (cudaStream_t)stream>>>(
        params, n, kmax, tile_size, rows_per_warp, cull, tiles_x, tile_lo,
        tile_hi, ballots, counts);
  }
  return (int)cudaGetLastError();
}

extern "C" int gsplat_cull_emit(const float* params, const uint32_t* ballots,
                                const int32_t* offsets, const int64_t* depth_q,
                                int64_t n, int kmax, int tiles_x, int tile_lo,
                                int depth_bits, int kb, int64_t max_slots,
                                int64_t* keys, int32_t* gidk, void* stream) {
  if (n > 0 && kmax > 0 && max_slots > 0) {
    cull_kernel_emit<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                       0, (cudaStream_t)stream>>>(
        params, ballots, offsets, depth_q, n, kmax, tiles_x, tile_lo,
        depth_bits, kb, max_slots, keys, gidk);
  }
  return (int)cudaGetLastError();
}

// table: the tiers' row starts (num_tiers + 1), then their k_lo, k_hi and
// kinds (num_tiers each), read on the host. row_counts set: the count;
// else the emit into keys and gidk, which the caller has filled.
extern "C" int gsplat_cull_tier(const int64_t* table, int num_tiers,
                                int num_base, const float* params, int64_t n,
                                const int64_t* depth_q, const int32_t* counts,
                                const int32_t* compact_k, int kmax,
                                const int64_t* ids_pool, const int64_t* ids_r,
                                const uint8_t* maskj, const int32_t* krank,
                                int jumbo, int tiles_x, int band, int tile_lo,
                                int tile_hi, int depth_bits, int kb,
                                int32_t* row_counts, const int32_t* offsets,
                                int64_t max_slots, int64_t* keys,
                                int32_t* gidk, void* stream) {
  if (num_tiers < 1 || num_tiers > kMaxTiers || num_base < 0 ||
      num_base > num_tiers)
    return (int)cudaErrorInvalidValue;
  Tiers tiers = {};
  for (int t = 0; t <= num_tiers; ++t) tiers.start[t] = table[t];
  for (int t = 0; t < num_tiers; ++t) {
    tiers.k_lo[t] = (int)table[num_tiers + 1 + t];
    tiers.k_hi[t] = (int)table[2 * num_tiers + 1 + t];
    tiers.kind[t] = (int)table[3 * num_tiers + 1 + t];
  }
  tiers.num = num_tiers;
  tiers.num_base = num_base;
  const int64_t base_rows = tiers.start[num_base];
  const int64_t jumbo_rows = tiers.start[num_tiers] - base_rows;
  const int64_t base_blocks = (base_rows + kThreads - 1) / kThreads;
  const int64_t blocks = base_blocks + (jumbo_rows * 32 + kThreads - 1) /
                                           kThreads;
  if (blocks > 0 && (row_counts != nullptr || max_slots > 0)) {
    cull_kernel_tier<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
        tiers, params, n, depth_q, counts, compact_k, kmax, ids_pool, ids_r,
        maskj, krank, jumbo, tiles_x, band, tile_lo, tile_hi, depth_bits, kb,
        (unsigned)base_blocks, row_counts, offsets, max_slots, keys, gidk);
  }
  return (int)cudaGetLastError();
}
