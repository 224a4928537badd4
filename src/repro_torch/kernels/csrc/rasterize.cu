// Tile rasterizer for Hopper (sm_90a): full, prefix (stop-at-k) and resume
// modes, the slot-batched form of the serving tick, and the miss-compacted
// resume.
//
// Replaces the TPU kernels in src/repro/kernels/rasterize.py:
//   * _kernel          (called through rasterize_pallas)       -> rasterize_kernel
//   * _kernel_slots    (called through rasterize_slots_pallas) -> rasterize_kernel
//                                                                on a (tile, slot) grid
//   * _kernel_compact  (called through rasterize_compact_pallas)
//                                                             -> rasterize_compact_kernel
//                                                                (explicit or home lanes)
//
// What bounds rasterize_kernel on an H100: instructions per walked
// pixel-Gaussian pair, not bytes.  A Gaussian's 40 bytes of features are
// read once per tile, but every pixel of a warp that still works pays the
// pair's ~60-70 lane-instructions for it: un-fused __fmul_rn/__fadd_rn
// arithmetic, an accurate expf and the bookkeeping.  chip_smoke.py prints,
// for phase A and the serving slots, the pairs in the chunks the blocks
// walk and the pairs the reference examines (n_iter), both from the
// kernel's outputs, and the candidate pairs that the cull below leaves as
// its plain mirror (tile_cull_plain) predicts them.  On the main path's
// 1920x1080 frame of 1M Gaussians they are 355,024,896 / 179,671,959 /
// 63,396,256, and on a serving tick of 4 slots 1,513,635,840 / 750,232,716
// / 257,300,352: the cull leaves under a fifth of the walked pairs.
// chip_smoke.py's bound (bytes, or 14 operations per examined pair) reads
// 'bytes'.
//
// Design:
//   * one block per 16x16 tile (per (tile, slot) in the serving tick), one
//     thread per pixel; each chunk of Gaussians is staged cooperatively in
//     shared memory, so a feature is read from device memory once per tile;
//   * a per-chunk band cull (below): while staging, the first `chunk`
//     threads classify each Gaussian; then each warp (two pixel rows of the
//     tile, a 16x2 band) tests every Gaussian of the chunk against its band
//     and keeps a 32-bit ballot of candidates per 32 Gaussians;
//   * a pixel walks only its warp's candidates, in list order, through
//     integrate_one, exactly the per-Gaussian arithmetic of the reference
//     (`_seq_chunk` in the JAX package, rasterize_plain here).  A culled
//     Gaussian changes nothing but n_iter, so the runs of culled Gaussians
//     between two candidates add their examined count in bulk (a popcount
//     of the culled valid ids at or past the pixel's start);
//   * a pixel that becomes done inside a chunk (transmittance at its floor
//     or, in prefix mode, a full record) stops walking it: the reference's
//     remaining steps change nothing and examine nothing;
//   * the early exit is a block-wide vote (__syncthreads_or) on the same
//     condition as the reference loop, so the kernel counts chunks exactly as
//     the reference does; the walk starts at the block minimum of the live
//     pixels' start positions.  Culling changes no pixel's state after a
//     chunk, so it changes neither the vote nor the chunk count.
// Two further steps were measured and not kept (PERF.md): skipping expf for
// a candidate pair whose power lies below ln(K / op) (after the band cull
// few warps lie wholly outside an ellipse), and prefetching the next chunk
// with cp.async while one is walked (blocks walk few chunks, and the other
// blocks of an SM hide the staging).
//
// The cull.  Lemma: if the band test below says "culled", then for every
// pixel centre of the band the kernel's own float arithmetic gives
// alpha <= 1/255, power > 0 or gid < 0, so the pair is not significant.
// Let K = float32(1/255), u = 2^-24, and for a pixel centre (px, py) let
// dx = px - mx, dy = py - my exactly, A = a dx^2, C = c dy^2, B = b dx dy,
// q = A + C + 2B (so the exact power is -q/2).
//   1. gid < 0: not valid.  Culled.
//   2. op * (1 + 2^-21) <= K (or op is NaN): with power <= 0, expf returns
//      at most 1 + 2^-23 (2 ulps, CUDA's bound for expf), so
//      op * expf(power) <= K and its rounding stays <= K.  Culled.
//   3. Otherwise the geometric test, only when every input is finite,
//      op <= 1, a > 0, c > 0 and b^2 <= (1 - 2^-11)^2 a c, i.e.
//      1 - |rho| >= 2^-11 with rho = b / sqrt(a c) (the normalised conic's
//      condition number (1 + |rho|) / (1 - |rho|) is below 2^12).  Anything
//      else is never culled by geometry.
//      a. Significant means op * expf(power_f) > K for the computed
//         power_f; expf's 2-ulp error (a factor <= 1 + 2^-22 for results
//         above K / op >= K, which are normal) gives
//         power_f > ln(K / op) - 2^-21.
//      b. power_f has 6 roundings on the A and C terms (dx, dx, two
//         products, the sum, the final difference; -0.5 is exact) and 5 on
//         B, so |power_f - (-q/2)| <= g6 (A/2 + C/2 + |B|) <= g6 (A + C),
//         g6 = 6u / (1 - 6u), using |B| <= (A + C) / 2 (b^2 < a c).
//         Subnormal absolute errors add under 2^-140.
//      c. q >= (1 - |rho|)(A + C): in coordinates (sqrt(a) dx, sqrt(c) dy)
//         the normalised conic's eigenvalues are 1 +- |rho|.
//      d. So q (1 - beta) < 2 (ln(op / K) + eta) with eta = 2^-20 (covers
//         2^-21 and the subnormal terms) and beta = 2 g6 / (1 - |rho|)
//         <= 12u 2^11 (1 + 2^-20) < 2^-9.  A pixel can only be significant
//         where q < R^2 = 2 (ln(op / K) + eta) / (1 - 2^-9).
//      e. The band's pixel centres lie in the rectangle [x0 + 0.5, x0 + 15.5]
//         x [y0 + 0.5, y0 + 1.5] (y0 the band's first row).  q is convex
//         with its minimum at the mean, so over the rectangle its minimum is
//         0 if the mean lies inside, else on an edge, where the 1-D minimum
//         is the clamped vertex: dy = clamp(-b dx / c), dx = clamp(-b dy / a).
//         The Gaussian is culled when that minimum >= R^2 (1 + 2^-20).
//      The class (steps 1-3, R^2, -b/c, -b/a) and step e are computed in
//      double: their own rounding (relative ~2^-50 after the conditioning
//      limit) sits far inside the 2^-20 pad.  The plain mirror of this
//      predicate, tile_cull_plain in rasterize.py, uses the same double
//      expressions; the CPU tests hold it against the reference's float32
//      per-pair arithmetic on the 256 centres of a tile.
//
// Why not tensor cores: the quadratic form written as a product on
// wgmma/mma (TF32, or float32 accumulated in another order) changes power
// by ulps, which flips alpha > 1/255 decisions, and those are integer
// outputs (records, counts, chunks).  The per-pair arithmetic stays scalar
// float32 in the reference's order.
//
// The slot-batched form (_kernel_slots) walks one tile of all S serving
// slots.  On the TPU one program holds every slot's lanes of a tile, and its
// loop runs until no lane of any slot remains, so the trip count it reports
// (chunks [T, 1]) is shared by the slots; RCStats.chunks_prefix scales it by
// S and FrameStats.saved_frac reads it.  Here the slots are decoupled: grid
// (T, S), one block per (tile, slot), the same rasterize_kernel body, so the
// per-pixel operation order is phase A's by construction.  The shared count
// is recovered exactly, without coupling the blocks:
//   * every lane starts at chunk 0 (the slot wrappers take no start_iter:
//     phase A and the full pass begin at the front), so the TPU loop and
//     each block start together, or a block with no live lane stops at once;
//   * a lane's "remaining" test (live, trans > 1e-4, chunk < ncap and, in
//     prefix mode, count < k) is monotone in the chunk index: trans only
//     falls, the count only rises, and past a slot's own ncap every id is -1
//     (ncap is one past the last valid id), so nothing can revive it;
//   * so the chunks a finished slot rides along on the TPU are no-ops for
//     its lanes, each lane's state equals its own block's, and the shared
//     count is the largest per-block count of the tile: each block does
//     atomicMax of its count into chunks[t], which the wrapper zero-fills.
//     An integer max does not depend on the order the atomics run in.
//
// rasterize_compact_kernel is phase B over the miss-compacted lanes.  The
// lanes of a [T, P] frame are ordered live first (a stable partition, in
// ops.py) and grouped 256 to a lane tile, as in the JAX package: the trip
// count it reports is per lane tile.  One body, compact_tile<kHome>, serves
// two addressings:
//   * explicit lanes (rasterize_compact_launch, the JAX package's
//     contract): each lane of CT lane tiles carries its pixel centre,
//     source tile, chunk cap, start and live flag, and its state in and out
//     sits at its own index;
//   * home lanes (rasterize_compact_home_launch, the phase-B path): lane j
//     is pixel home[j] of the frame, live iff j < n_live (read on the
//     device); its pixel centre and source tile follow from home[j]; it
//     reads phase A's state there and writes its result there, its counts
//     added to phase A's.  A grid-stride loop walks only the lane tiles
//     below n_live: no dead lane is read or written.  The wrapper's outputs
//     start as copies of phase A's acc, trans, count, n_sig and n_iter; a
//     live lane holds a full record (count >= k, as phase B's lanes do), so
//     its record and iter_at_k never change and are phase A's own tensors.
//
// Each lane walks alone, with no block barrier in the walk: from its own
// start chunk, kBatch = 4 Gaussians at a time (four independent alpha
// chains; the next four's features, color included, in flight as 16-byte
// loads, which needs 16-byte aligned feature arrays and a chunk that is a
// multiple of 4), until its transmittance reaches the floor or it passes
// its cap.  The lane tile's trip count is then recovered exactly:
//
//   The coupled loop (the JAX kernel; rasterize_compact_plain) starts at
//   c0 = min(min over live lanes of start // chunk, K / chunk) and runs
//   while c < K / chunk and some lane "remains": live, trans > 1e-4 and
//   c < ncap.  Each lane's remaining test, over c >= c0, holds up to a
//   chunk f and fails from f on, and f depends on that lane alone:
//   (i) before its start a lane changes nothing (its positions are not
//   allowed, so nothing is examined or added), so its test there reads its
//   initial trans; (ii) trans only falls (a contribution multiplies it by
//   1 - alpha, alpha in (1/255, 0.99]), and a NaN trans fails at once and
//   stays NaN (`active` is false, so no pair contributes); (iii) past its
//   ncap every id of its source tile is -1 (ncap is one past the last
//   valid id; for explicit lanes the wrapper states it as a condition), so
//   nothing revives it.  So the loop ends at min(K / chunk, max(c0, max f))
//   and counts max(0, max f - c0) chunks; the chunks a lane rides along on
//   past its f change nothing, so its state equals its own walk's.
//   A lane's f: c0 if it is dead or its trans starts at or below the
//   floor or NaN; else min(e, cap), cap = min(ncap, K / chunk) and e one
//   past the chunk in which its own walk saturated, else cap.  The kernel
//   takes stop = 0 for the first kind and stop = min(e, cap) for the rest;
//   the count max(0, max stop - c0) is then the same (f = c0 adds 0), a
//   warp max (__reduce_max_sync) atomicMax'd into chunks[t], which the
//   wrapper zeroes.  The edge cases: a lane whose start chunk equals its
//   ncap (iter_at_k can be ncap * chunk) walks nothing and stops at cap =
//   its start chunk, as the loop does; a lane whose ncap lies below c0
//   gives a negative difference, floored; dead lanes inside a live lane
//   tile give 0 and do not enter c0; c0 clamped to K / chunk (every live
//   lane starting at K) gives 0 whatever the stops; a lane tile with no
//   live lane gives 0 (explicit: c0 = K / chunk; home: never walked).
//   compact_lane_stops_plain and compact_chunks_plain in rasterize.py
//   mirror this count; the CPU tests hold it against the JAX kernel's
//   chunks and show that it fails without the floor or with each lane's
//   own start chunk in place of c0.
//
// What bounds it: the sequence of the longest lanes, not bytes (under a
// tenth of its time, chip_smoke.py's bound).  A lane's pairs are a chain
// through its transmittance, and a warp walks as long as its longest lane
// (chip_smoke.py's counters: up to ~900 Gaussians); the warps of a lane
// tile read 4-10 source tiles' lists at their own positions, so each load
// touches several cache lines.  Measured on the card and not kept
// (PERF.md): loading a color only for a contributing pair (a dependent
// load inside the walk), starting every lane of a warp at the warp's first
// chunk, staging a warp's source tiles in shared memory, prefetching the
// lists ahead into L1 or L2, and 1, 2 or 8 Gaussians at a time.
//
// Integer outputs (records, counts, chunks) depend on float comparisons, so
// the arithmetic is written with explicit round-to-nearest intrinsics (no
// FMA contraction), in the reference's expression order, with expf (not
// __expf).  The library is also built with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaSig = 0.003921569f;   // float32(1 / 255)
constexpr float kTransEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

// The cull's constants (see the lemma above).
constexpr double kOpFloorFactor = 1.0 + 0x1p-21;   // step 2
constexpr double kRhoMax = 1.0 - 0x1p-11;          // step 3, conditioning
constexpr double kEta = 0x1p-20;                   // step 3d
constexpr double kBeta = 0x1p-9;                   // step 3d
constexpr double kPad = 1.0 + 0x1p-20;             // step 3e
constexpr int kCulled = 0, kTest = 1, kKept = 2;   // per-Gaussian classes

struct PixelState {
  float acc0, acc1, acc2, trans;
  int cnt, nsig, niter, itk;
};

// One Gaussian's alpha at one pixel centre, and whether the pair is valid
// (power <= 0, gid >= 0): the part of integrate_one that does not depend on
// the pixel's state.
__device__ __forceinline__ float pair_alpha(float px, float py, float gmx,
                                            float gmy, float ca, float cb,
                                            float cc, float op, int gid,
                                            bool* valid) {
  const float dx = __fsub_rn(px, gmx);
  const float dy = __fsub_rn(py, gmy);
  // -0.5 * (a*dx*dx + c*dy*dy) - b*dx*dy, left to right as written
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(cb, dx), dy));
  const float alpha = __fmul_rn(op, expf(power));
  *valid = (power <= 0.0f) && (gid >= 0);
  return alpha > kAlphaMax ? kAlphaMax : alpha;   // NaN propagates, as minimum
}

// The rest of integrate_one: the pixel's update by a pair of the given
// alpha.  `color()` gives the Gaussian's color; it is called only for a pair
// that contributes.
template <bool kRecord = true, class Color>
__device__ __forceinline__ void apply_pair(
    PixelState& s, int* rec, float alpha, bool valid, const Color& color,
    int gid, int abs_pos, int start, bool live, int k_record, bool stop_at_k) {
  const bool allowed = (abs_pos >= start) && live;
  const bool active = s.trans > kTransEps;
  bool sig = (alpha > kAlphaSig) && valid && allowed;
  bool examined = active && (gid >= 0) && allowed;
  if (stop_at_k) {
    sig = sig && (s.cnt < k_record);
    examined = examined && (s.cnt < k_record);
  }
  if (sig && active) {
    const float3 col = color();
    const float w = __fmul_rn(s.trans, alpha);
    s.acc0 = __fadd_rn(s.acc0, __fmul_rn(w, col.x));
    s.acc1 = __fadd_rn(s.acc1, __fmul_rn(w, col.y));
    s.acc2 = __fadd_rn(s.acc2, __fmul_rn(w, col.z));
    s.trans = __fmul_rn(s.trans, __fsub_rn(1.0f, alpha));
    if (kRecord && s.cnt < k_record) rec[s.cnt] = gid;
    if (s.cnt + 1 >= k_record && s.cnt < k_record) s.itk = abs_pos + 1;
    s.cnt += 1;
    s.nsig += 1;
  }
  s.niter += examined ? 1 : 0;
}

// One Gaussian's update of one pixel.  Mirrors rasterize_plain step by step.
template <class Color>
__device__ __forceinline__ void integrate_one(
    PixelState& s, int* rec, float px, float py, float gmx, float gmy,
    float ca, float cb, float cc, const Color& color, float op,
    int gid, int abs_pos, int start, bool live, int k_record, bool stop_at_k) {
  bool valid;
  const float alpha = pair_alpha(px, py, gmx, gmy, ca, cb, cc, op, gid, &valid);
  apply_pair(s, rec, alpha, valid, color, gid, abs_pos, start, live, k_record,
             stop_at_k);
}

// Steps 1-3 of the cull for one Gaussian: kCulled, kKept, or kTest with the
// squared radius threshold r2 (padded) and the edge-vertex slopes.
__device__ __forceinline__ int cull_class(
    float mx, float my, float ca, float cb, float cc, float op, int gid,
    double* r2, double* nbc, double* nba) {
  if (gid < 0) return kCulled;
  const double o = op;
  if (!(o * kOpFloorFactor > static_cast<double>(kAlphaSig))) return kCulled;
  if (!(o <= 1.0) || !isfinite(mx) || !isfinite(my) || !isfinite(ca) ||
      !isfinite(cb) || !isfinite(cc))
    return kKept;
  const double a = ca, b = cb, c = cc;
  if (!(a > 0.0) || !(c > 0.0) || !(b * b <= kRhoMax * kRhoMax * (a * c)))
    return kKept;
  *r2 = 2.0 * (log(o / static_cast<double>(kAlphaSig)) + kEta) /
        (1.0 - kBeta) * kPad;
  *nbc = -b / c;
  *nba = -b / a;
  return kTest;
}

__device__ __forceinline__ double conic_q(double a, double b, double c,
                                          double u, double v) {
  return a * u * u + 2.0 * b * u * v + c * v * v;
}

// Step e: can a kTest Gaussian be significant anywhere in the rectangle
// [xl, xl + w] x [yl, yl + h] of pixel centres?
__device__ __forceinline__ bool rect_may_contribute(
    double mx, double my, double a, double b, double c, double r2, double nbc,
    double nba, double xl, double yl, double w, double h) {
  const double u0 = xl - mx, u1 = u0 + w;
  const double v0 = yl - my, v1 = v0 + h;
  if (u0 <= 0.0 && u1 >= 0.0 && v0 <= 0.0 && v1 >= 0.0) return true;
  double q = conic_q(a, b, c, u0, fmin(fmax(nbc * u0, v0), v1));
  q = fmin(q, conic_q(a, b, c, u1, fmin(fmax(nbc * u1, v0), v1)));
  q = fmin(q, conic_q(a, b, c, fmin(fmax(nba * v0, u0), u1), v0));
  q = fmin(q, conic_q(a, b, c, fmin(fmax(nba * v1, u0), u1), v1));
  return !(q >= r2);
}

// bits n..31 set (all for n <= 0, none for n >= 32)
__device__ __forceinline__ unsigned bits_from(int n) {
  return n <= 0 ? kFull : (n >= 32 ? 0u : (kFull << n));
}

__device__ __forceinline__ int block_min(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  int m = scratch[0];
  for (int i = 1; i < kWarps; ++i) m = min(m, scratch[i]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ void load_state(
    PixelState& s, size_t q, const float* acc0, const float* trans0,
    const int* rec0, const int* cnt0, int* rec, int k_record, int k_total) {
  s.acc0 = acc0[q * 3 + 0];
  s.acc1 = acc0[q * 3 + 1];
  s.acc2 = acc0[q * 3 + 2];
  s.trans = trans0[q];
  s.cnt = cnt0[q];
  s.nsig = 0;
  s.niter = 0;
  s.itk = k_total;
  for (int j = 0; j < k_record; ++j) rec[q * k_record + j] = rec0[q * k_record + j];
}

__device__ __forceinline__ void store_state(
    const PixelState& s, size_t q, float* acc, float* trans, int* cnt,
    int* nsig, int* niter, int* itk) {
  acc[q * 3 + 0] = s.acc0;
  acc[q * 3 + 1] = s.acc1;
  acc[q * 3 + 2] = s.acc2;
  trans[q] = s.trans;
  cnt[q] = s.cnt;
  nsig[q] = s.nsig;
  niter[q] = s.niter;
  itk[q] = s.itk;
}

// shared memory of rasterize_kernel per Gaussian of a chunk: r2, -b/c, -b/a
// (double); mean 2, conic 3, color 3, opacity (float); id, class (int)
constexpr size_t kSmemPerGaussian =
    3 * sizeof(double) + 9 * sizeof(float) + 2 * sizeof(int);

__global__ void __launch_bounds__(kPix) rasterize_kernel(
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ color, const float* __restrict__ opacity,
    const int* __restrict__ ids,
    const float* __restrict__ acc0, const float* __restrict__ trans0,
    const int* __restrict__ rec0, const int* __restrict__ cnt0,
    const int* __restrict__ start_iter, const int* __restrict__ live_in,
    const int* __restrict__ ncap,
    float* __restrict__ acc, float* __restrict__ trans, int* __restrict__ rec,
    int* __restrict__ cnt, int* __restrict__ nsig, int* __restrict__ niter,
    int* __restrict__ itk, int* __restrict__ chunks,
    int k_total, int tiles_x, int k_record, int chunk, int stop_at_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_r2 = reinterpret_cast<double*>(smem);
  double* s_nbc = s_r2 + chunk;
  double* s_nba = s_nbc + chunk;
  float* s_mx = reinterpret_cast<float*>(s_nba + chunk);
  float* s_my = s_mx + chunk;
  float* s_ca = s_my + chunk;
  float* s_cb = s_ca + chunk;
  float* s_cc = s_cb + chunk;
  float* s_r = s_cc + chunk;
  float* s_g = s_r + chunk;
  float* s_b = s_g + chunk;
  float* s_op = s_b + chunk;
  int* s_id = reinterpret_cast<int*>(s_op + chunk);
  int* s_cls = s_id + chunk;
  __shared__ int scratch[kWarps];

  // grid (T, S): tile t of slot blockIdx.y, row = slot * T + t of the
  // [S * T, ...] operands (S = 1 outside the serving tick)
  const int t = blockIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.y) * gridDim.x + t;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const size_t q = row * kPix + p;
  const int x0 = (t % tiles_x) * kTile;
  const int y0 = (t / tiles_x) * kTile;
  const float px = static_cast<float>(x0 + (p % kTile)) + 0.5f;
  const float py = static_cast<float>(y0 + (p / kTile)) + 0.5f;
  // this warp's band: pixel rows 2w and 2w + 1 of the tile
  const double band_x = x0 + 0.5;
  const double band_y = y0 + 2 * (p >> 5) + 0.5;
  const bool live = live_in[q] != 0;
  const int start = start_iter == nullptr ? 0 : start_iter[q];
  const bool stop = stop_at_k != 0;

  PixelState s;
  load_state(s, q, acc0, trans0, rec0, cnt0, rec, k_record, k_total);
  int* my_rec = rec + q * k_record;

  const int nc = min(k_total / chunk, ncap[row]);
  int c = min(block_min(live ? start : k_total, scratch) / chunk, nc);
  int nchunks = 0;
  const size_t tile_base = row * k_total;
  while (true) {
    const bool done = !live || (s.trans <= kTransEps) ||
                      (stop && s.cnt >= k_record);
    const int any_left = __syncthreads_or(!done);
    if (!(c < nc) || !any_left) break;
    for (int j = p; j < chunk; j += kPix) {
      const size_t g = tile_base + static_cast<size_t>(c) * chunk + j;
      const float mx = mean2d[g * 2 + 0], my = mean2d[g * 2 + 1];
      const float ca = conic[g * 3 + 0], cb = conic[g * 3 + 1];
      const float cc = conic[g * 3 + 2], op = opacity[g];
      const int gid = ids[g];
      s_mx[j] = mx;
      s_my[j] = my;
      s_ca[j] = ca;
      s_cb[j] = cb;
      s_cc[j] = cc;
      s_r[j] = color[g * 3 + 0];
      s_g[j] = color[g * 3 + 1];
      s_b[j] = color[g * 3 + 2];
      s_op[j] = op;
      s_id[j] = gid;
      s_cls[j] = cull_class(mx, my, ca, cb, cc, op, gid, s_r2 + j, s_nbc + j,
                            s_nba + j);
    }
    __syncthreads();
    // a warp whose pixels are all dead, saturated or (in prefix mode) full
    // changes nothing in this chunk, so it skips the chunk.  `going` is
    // integrate_one's `active` and prefix test, so a NaN transmittance
    // (neither done nor active) examines nothing, as in the reference.
    bool going = live && s.trans > kTransEps && !(stop && s.cnt >= k_record);
    if (__any_sync(kFull, going)) {
      const int chunk_pos = c * chunk;
      for (int g0 = 0; g0 < chunk; g0 += 32) {
        // the warp's candidates among Gaussians g0 .. g0 + 31, and the valid
        // ids it culled
        const int i = g0 + lane;
        bool keep = false, valid = false;
        if (i < chunk) {
          valid = s_id[i] >= 0;
          const int cls = s_cls[i];
          keep = cls == kKept ||
                 (cls == kTest &&
                  rect_may_contribute(s_mx[i], s_my[i], s_ca[i], s_cb[i],
                                      s_cc[i], s_r2[i], s_nbc[i], s_nba[i],
                                      band_x, band_y, kTile - 1, 1.0));
        }
        const unsigned cand = __ballot_sync(kFull, keep);
        const unsigned culled = __ballot_sync(kFull, valid && !keep);
        if (!going) continue;
        // a culled valid id at or past the pixel's start is examined while
        // the pixel goes on, and changes nothing else
        const unsigned counted = culled & bits_from(start - (chunk_pos + g0));
        unsigned todo = cand;
        int next = 0;
        while (todo) {
          const int j = __ffs(todo) - 1;
          todo &= todo - 1;
          s.niter += __popc(counted & bits_from(next) & ~bits_from(j));
          next = j + 1;
          const int k = g0 + j;
          integrate_one(s, my_rec, px, py, s_mx[k], s_my[k], s_ca[k], s_cb[k],
                        s_cc[k],
                        [&] { return make_float3(s_r[k], s_g[k], s_b[k]); },
                        s_op[k], s_id[k], chunk_pos + k, start, live, k_record,
                        stop);
          if (!(s.trans > kTransEps) || (stop && s.cnt >= k_record)) {
            going = false;   // the rest of the chunk changes nothing
            break;
          }
        }
        if (going) s.niter += __popc(counted & bits_from(next));
      }
    }
    __syncthreads();
    ++c;
    ++nchunks;
  }
  store_state(s, q, acc, trans, cnt, nsig, niter, itk);
  // chunks is zeroed by the wrapper; with one slot the max is the count
  if (p == 0 && nchunks > 0) atomicMax(chunks + t, nchunks);
}

// The operands of rasterize_compact_kernel.  Explicit lanes (the JAX
// package's contract): every lane of the CT lane tiles carries its pixel
// centre, source tile, chunk cap, start and live flag, and its state in and
// out sits at its own index.  Home lanes (the phase-B path): lane j of the
// compacted order is home[j] of the [T * P] frame, live iff j < n_live; its
// pixel centre and source tile follow from home[j], t_img and tiles_x, its
// state in is phase A's at home[j], and its result, combined with phase A's
// counts, is written back there; no other lane is read or written.
struct CompactArgs {
  const float* mean2d;    // features [T, K, ...] of the source tiles
  const float* conic;
  const float* color;
  const float* opacity;
  const int* ids;
  const float* px;        // explicit: [CT * P] each
  const float* py;
  const int* src;
  const int* ncap;
  const int* live;
  const int* home;        // home: [T * P], n_live (a device scalar) and the
  const int* n_live;      // source tiles' chunk caps [T]
  const int* tile_ncap;
  const float* acc0;      // state in (home: phase A's; start_iter is its
  const float* trans0;    // iter_at_k, and nsig0 / niter0 its counts)
  const int* rec0;
  const int* cnt0;
  const int* start_iter;
  const int* nsig0;
  const int* niter0;
  float* acc;             // state out, indexed like the state in (home:
  float* trans;           // no record or iter_at_k)
  int* rec;
  int* cnt;
  int* nsig;
  int* niter;
  int* itk;
  int* chunks;            // [lane tiles], zero on entry
  int k_total, k_record, chunk, tiles_x, t_img;
};

// Gaussians a lane takes at once: their alphas are computed side by side,
// and their features, color included, arrive in 16-byte loads.
constexpr int kBatch = 4;

// The features of kBatch consecutive Gaussians of one list.
struct Batch {
  float mx[kBatch], my[kBatch], ca[kBatch], cb[kBatch], cc[kBatch];
  float op[kBatch];
  int gid[kBatch];
  float r[kBatch], g[kBatch], b[kBatch];
};

// Gaussians g .. g + 3, g a multiple of 4: with 16-byte aligned feature
// arrays every span below is 16-byte aligned (the wrappers check the
// arrays).  conic and color hold a0 b0 c0 a1 | b1 c1 a2 b2 | c2 a3 b3 c3.
__device__ __forceinline__ void load_batch(const CompactArgs& a, size_t g,
                                           Batch& b) {
  const float4* m = reinterpret_cast<const float4*>(a.mean2d + g * 2);
  const float4 m0 = __ldg(m), m1 = __ldg(m + 1);
  b.mx[0] = m0.x; b.my[0] = m0.y; b.mx[1] = m0.z; b.my[1] = m0.w;
  b.mx[2] = m1.x; b.my[2] = m1.y; b.mx[3] = m1.z; b.my[3] = m1.w;
  const float4* c = reinterpret_cast<const float4*>(a.conic + g * 3);
  const float4 c0 = __ldg(c), c1 = __ldg(c + 1), c2 = __ldg(c + 2);
  b.ca[0] = c0.x; b.cb[0] = c0.y; b.cc[0] = c0.z;
  b.ca[1] = c0.w; b.cb[1] = c1.x; b.cc[1] = c1.y;
  b.ca[2] = c1.z; b.cb[2] = c1.w; b.cc[2] = c2.x;
  b.ca[3] = c2.y; b.cb[3] = c2.z; b.cc[3] = c2.w;
  const float4 o = __ldg(reinterpret_cast<const float4*>(a.opacity + g));
  b.op[0] = o.x; b.op[1] = o.y; b.op[2] = o.z; b.op[3] = o.w;
  const int4 i = __ldg(reinterpret_cast<const int4*>(a.ids + g));
  b.gid[0] = i.x; b.gid[1] = i.y; b.gid[2] = i.z; b.gid[3] = i.w;
  const float4* k = reinterpret_cast<const float4*>(a.color + g * 3);
  const float4 k0 = __ldg(k), k1 = __ldg(k + 1), k2 = __ldg(k + 2);
  b.r[0] = k0.x; b.g[0] = k0.y; b.b[0] = k0.z;
  b.r[1] = k0.w; b.g[1] = k1.x; b.b[1] = k1.y;
  b.r[2] = k1.z; b.g[2] = k1.w; b.b[2] = k2.x;
  b.r[3] = k2.y; b.g[3] = k2.z; b.b[3] = k2.w;
}

// One lane's walk from its own start chunk up to its cap `cap` (at most
// K / chunk).  Returns the chunk at which the lane's remaining test first
// fails: one past the chunk in which its transmittance reached the floor,
// else `cap`.  The next batch is loaded while this one is applied in list
// order.  kRecord: whether the walk may write the lane's record (home lanes
// hold a full record, so theirs never changes).
template <bool kRecord>
__device__ __forceinline__ int walk_lane(PixelState& s, int* rec,
                                         const CompactArgs& a, int src,
                                         float px, float py, int start,
                                         int cap) {
  const int end = cap * a.chunk;
  int pos = start / a.chunk * a.chunk;
  if (pos >= end) return cap;
  const size_t base = static_cast<size_t>(src) * a.k_total;
  Batch next;
  load_batch(a, base + pos, next);
  for (; pos < end; pos += kBatch) {
    const Batch cur = next;
    if (pos + kBatch < end) load_batch(a, base + pos + kBatch, next);
    float alpha[kBatch];
    bool valid[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      alpha[j] = pair_alpha(px, py, cur.mx[j], cur.my[j], cur.ca[j], cur.cb[j],
                            cur.cc[j], cur.op[j], cur.gid[j], &valid[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      apply_pair<kRecord>(
          s, rec, alpha[j], valid[j],
          [&] { return make_float3(cur.r[j], cur.g[j], cur.b[j]); },
          cur.gid[j], pos + j, start, true, a.k_record, false);
      if (!(s.trans > kTransEps)) return (pos + j) / a.chunk + 1;
    }
  }
  return cap;
}

// Walks one lane tile t (the lanes 256 t .. 256 t + 255 of the compacted
// order).
template <bool kHome>
__device__ __forceinline__ void compact_tile(const CompactArgs& a, int t,
                                             size_t n_live, int* scratch) {
  const int p = threadIdx.x;
  const size_t q = static_cast<size_t>(t) * kPix + p;
  const bool live = kHome ? q < n_live : a.live[q] != 0;
  size_t h = q;   // where the lane's state lives
  int src = 0, lane_cap = 0, start = a.k_total;
  float px = 0.0f, py = 0.0f;
  if (!kHome) {
    px = a.px[q];
    py = a.py[q];
    src = a.src[q];
    lane_cap = a.ncap[q];
    start = a.start_iter[q];
  } else if (live) {
    h = static_cast<size_t>(a.home[q]);
    src = static_cast<int>(h / kPix);
    const int pix = static_cast<int>(h % kPix);
    const int tim = src % a.t_img;
    px = static_cast<float>((tim % a.tiles_x) * kTile + pix % kTile) + 0.5f;
    py = static_cast<float>((tim / a.tiles_x) * kTile + pix / kTile) + 0.5f;
    lane_cap = a.tile_ncap[src];
    start = a.start_iter[h];
  }

  PixelState s;
  int* my_rec = kHome ? nullptr : a.rec + h * a.k_record;
  if (!kHome) {
    load_state(s, q, a.acc0, a.trans0, a.rec0, a.cnt0, a.rec, a.k_record,
               a.k_total);
  } else if (live) {
    s.acc0 = a.acc0[h * 3 + 0];
    s.acc1 = a.acc0[h * 3 + 1];
    s.acc2 = a.acc0[h * 3 + 2];
    s.trans = a.trans0[h];
    s.cnt = a.cnt0[h];
    s.nsig = 0;
    s.niter = 0;
    s.itk = a.k_total;
  }

  const int nc_total = a.k_total / a.chunk;
  const int c0 =
      min(block_min(live ? start : a.k_total, scratch) / a.chunk, nc_total);
  int stop = 0;
  if (live && s.trans > kTransEps)
    stop = walk_lane<!kHome>(s, my_rec, a, src, px, py, start,
                             min(lane_cap, nc_total));
  // the lane tile's trip count: the largest stop of its lanes past c0
  const int warp_stop = __reduce_max_sync(kFull, stop);
  if ((p & 31) == 0 && warp_stop > c0) atomicMax(a.chunks + t, warp_stop - c0);

  if (!kHome) {
    store_state(s, q, a.acc, a.trans, a.cnt, a.nsig, a.niter, a.itk);
  } else if (live) {
    a.acc[h * 3 + 0] = s.acc0;
    a.acc[h * 3 + 1] = s.acc1;
    a.acc[h * 3 + 2] = s.acc2;
    a.trans[h] = s.trans;
    a.cnt[h] = s.cnt;
    a.nsig[h] = a.nsig0[h] + s.nsig;
    a.niter[h] = a.niter0[h] + s.niter;
  }
}

// A grid-stride loop over the lane tiles: explicit lanes walk all
// `num_lane_tiles`; home lanes only those that hold a live lane (their
// lanes are packed live first), so no block is spent on the others, whose
// chunks stay 0.
template <bool kHome>
__global__ void __launch_bounds__(kPix) rasterize_compact_kernel(
    const CompactArgs a, int num_lane_tiles) {
  __shared__ int scratch[kWarps];
  const size_t n_live = kHome ? static_cast<size_t>(*a.n_live) : 0;
  const int tiles = kHome ? static_cast<int>((n_live + kPix - 1) / kPix)
                          : num_lane_tiles;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    compact_tile<kHome>(a, t, n_live, scratch);
}

// Blocks of the compact kernel's grid: 8 for each of an H100's 132 SMs,
// more than they hold at once, never more than there are lane tiles; the
// grid-stride loop takes the rest.
constexpr int kCompactGrid = 132 * 8;

template <bool kHome>
int launch_compact(const CompactArgs& a, int num_lane_tiles, void* stream) {
  const int grid = num_lane_tiles < kCompactGrid ? num_lane_tiles : kCompactGrid;
  rasterize_compact_kernel<kHome>
      <<<grid, kPix, 0, static_cast<cudaStream_t>(stream)>>>(a, num_lane_tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch_tiles(
    const void* mean2d, const void* conic, const void* color,
    const void* opacity, const void* ids, const void* acc0,
    const void* trans0, const void* rec0, const void* cnt0,
    const void* start_iter, const void* live, const void* ncap, void* acc,
    void* trans, void* rec, void* cnt, void* nsig, void* niter, void* itk,
    void* chunks, int num_tiles, int num_slots, int k_total, int tiles_x,
    int k_record, int chunk, int stop_at_k, void* stream) {
  const size_t smem = static_cast<size_t>(chunk) * kSmemPerGaussian;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rasterize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(num_tiles, num_slots);
  rasterize_kernel<<<grid, kPix, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean2d), static_cast<const float*>(conic),
      static_cast<const float*>(color), static_cast<const float*>(opacity),
      static_cast<const int*>(ids), static_cast<const float*>(acc0),
      static_cast<const float*>(trans0), static_cast<const int*>(rec0),
      static_cast<const int*>(cnt0), static_cast<const int*>(start_iter),
      static_cast<const int*>(live), static_cast<const int*>(ncap),
      static_cast<float*>(acc), static_cast<float*>(trans),
      static_cast<int*>(rec), static_cast<int*>(cnt), static_cast<int*>(nsig),
      static_cast<int*>(niter), static_cast<int*>(itk),
      static_cast<int*>(chunks), k_total, tiles_x, k_record, chunk, stop_at_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both tile walks publish their trip count by atomicMax: chunks [T] must be
// zero on entry.
int rasterize_launch(
    const void* mean2d, const void* conic, const void* color,
    const void* opacity, const void* ids, const void* acc0,
    const void* trans0, const void* rec0, const void* cnt0,
    const void* start_iter, const void* live, const void* ncap, void* acc,
    void* trans, void* rec, void* cnt, void* nsig, void* niter, void* itk,
    void* chunks, int num_tiles, int k_total, int tiles_x, int k_record,
    int chunk, int stop_at_k, void* stream) {
  return launch_tiles(mean2d, conic, color, opacity, ids, acc0, trans0, rec0,
                      cnt0, start_iter, live, ncap, acc, trans, rec, cnt,
                      nsig, niter, itk, chunks, num_tiles, 1, k_total,
                      tiles_x, k_record, chunk, stop_at_k, stream);
}

// Slot-batched walk: operands [S, T, ...]; every lane starts at chunk 0;
// chunks [T] receives the trip count shared by the slots (see above).
int rasterize_slots_launch(
    const void* mean2d, const void* conic, const void* color,
    const void* opacity, const void* ids, const void* acc0,
    const void* trans0, const void* rec0, const void* cnt0,
    const void* live, const void* ncap, void* acc, void* trans, void* rec,
    void* cnt, void* nsig, void* niter, void* itk, void* chunks,
    int num_tiles, int num_slots, int k_total, int tiles_x, int k_record,
    int chunk, int stop_at_k, void* stream) {
  return launch_tiles(mean2d, conic, color, opacity, ids, acc0, trans0, rec0,
                      cnt0, nullptr, live, ncap, acc, trans, rec, cnt, nsig,
                      niter, itk, chunks, num_tiles, num_slots, k_total,
                      tiles_x, k_record, chunk, stop_at_k, stream);
}

// Explicit lanes: operands [CT, P, ...]; chunks [CT] must be zero on entry.
int rasterize_compact_launch(
    const void* mean2d, const void* conic, const void* color,
    const void* opacity, const void* ids, const void* px, const void* py,
    const void* src, const void* ncap, const void* acc0, const void* trans0,
    const void* rec0, const void* cnt0, const void* start_iter,
    const void* live, void* acc, void* trans, void* rec, void* cnt,
    void* nsig, void* niter, void* itk, void* chunks, int num_lane_tiles,
    int k_total, int k_record, int chunk, void* stream) {
  CompactArgs a{};
  a.mean2d = static_cast<const float*>(mean2d);
  a.conic = static_cast<const float*>(conic);
  a.color = static_cast<const float*>(color);
  a.opacity = static_cast<const float*>(opacity);
  a.ids = static_cast<const int*>(ids);
  a.px = static_cast<const float*>(px);
  a.py = static_cast<const float*>(py);
  a.src = static_cast<const int*>(src);
  a.ncap = static_cast<const int*>(ncap);
  a.live = static_cast<const int*>(live);
  a.acc0 = static_cast<const float*>(acc0);
  a.trans0 = static_cast<const float*>(trans0);
  a.rec0 = static_cast<const int*>(rec0);
  a.cnt0 = static_cast<const int*>(cnt0);
  a.start_iter = static_cast<const int*>(start_iter);
  a.acc = static_cast<float*>(acc);
  a.trans = static_cast<float*>(trans);
  a.rec = static_cast<int*>(rec);
  a.cnt = static_cast<int*>(cnt);
  a.nsig = static_cast<int*>(nsig);
  a.niter = static_cast<int*>(niter);
  a.itk = static_cast<int*>(itk);
  a.chunks = static_cast<int*>(chunks);
  a.k_total = k_total;
  a.k_record = k_record;
  a.chunk = chunk;
  return launch_compact<false>(a, num_lane_tiles, stream);
}

// Home lanes over the [T, P] frame: phase A's state and counts in; acc,
// trans, count, n_sig and n_iter out, the counts combined with phase A's
// (every lane that is not live must already hold phase A's state there).
// Live lanes hold a full record, so their record and iter_at_k do not
// change and are not written.  chunks [T] must be zero on entry.
int rasterize_compact_home_launch(
    const void* mean2d, const void* conic, const void* color,
    const void* opacity, const void* ids, const void* tile_ncap,
    const void* acc0, const void* trans0, const void* cnt0, const void* nsig0,
    const void* niter0, const void* itk0, const void* home,
    const void* n_live, void* acc, void* trans, void* cnt, void* nsig,
    void* niter, void* chunks, int num_tiles, int k_total, int tiles_x,
    int t_img, int k_record, int chunk, void* stream) {
  CompactArgs a{};
  a.mean2d = static_cast<const float*>(mean2d);
  a.conic = static_cast<const float*>(conic);
  a.color = static_cast<const float*>(color);
  a.opacity = static_cast<const float*>(opacity);
  a.ids = static_cast<const int*>(ids);
  a.tile_ncap = static_cast<const int*>(tile_ncap);
  a.acc0 = static_cast<const float*>(acc0);
  a.trans0 = static_cast<const float*>(trans0);
  a.cnt0 = static_cast<const int*>(cnt0);
  a.nsig0 = static_cast<const int*>(nsig0);
  a.niter0 = static_cast<const int*>(niter0);
  a.start_iter = static_cast<const int*>(itk0);
  a.home = static_cast<const int*>(home);
  a.n_live = static_cast<const int*>(n_live);
  a.acc = static_cast<float*>(acc);
  a.trans = static_cast<float*>(trans);
  a.cnt = static_cast<int*>(cnt);
  a.nsig = static_cast<int*>(nsig);
  a.niter = static_cast<int*>(niter);
  a.chunks = static_cast<int*>(chunks);
  a.k_total = k_total;
  a.k_record = k_record;
  a.chunk = chunk;
  a.tiles_x = tiles_x;
  a.t_img = t_img;
  return launch_compact<true>(a, num_tiles, stream);
}

const char* rasterize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
