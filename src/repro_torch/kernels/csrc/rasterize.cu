// Tile rasterizer for Hopper (sm_90a): full, prefix (stop-at-k) and resume
// modes, the slot-batched form of the serving tick, and the miss-compacted
// resume.
//
// Replaces the TPU kernels in src/repro/kernels/rasterize.py:
//   * _kernel          (called through rasterize_pallas)
//   * _kernel_slots    (called through rasterize_slots_pallas)
//   * _kernel_compact  (called through rasterize_compact_pallas)
//
// What bounds it on an H100: memory, on the main path's data.  A Gaussian's
// 40 bytes of features are read once per tile and cost each pixel that
// still examines it one exp and ~14 float operations, so a chunk in which
// all 256 pixels work is bound by operations (~90 per byte, above the
// card's ~20).  But in phase A most pixels of a walked chunk have already
// filled their record or saturated, and phase B walks only miss lanes, so
// on the main path's frames the pairs examined per byte read stay under
// that ridge: the least time is that of reading the features the tiles
// need and writing every pixel's state (chip_smoke.py's bound, computed
// from each run's counts, reads 'bytes' for both kernels).
//
// Design (right and simple first):
//   * one block per 16x16 tile, one thread per pixel (256 threads);
//   * rasterize_kernel stages each chunk of Gaussians cooperatively in shared
//     memory (10 words per Gaussian), so a feature is read from device memory
//     once per tile;
//   * each thread walks the chunk in exactly the per-Gaussian order of the
//     reference (`_seq_chunk` in the JAX package, rasterize_plain here);
//   * the early exit is a block-wide vote (__syncthreads_or) on the same
//     condition as the reference loop, so the kernel counts chunks exactly as
//     the reference does; the walk starts at the block minimum of the live
//     pixels' start positions;
//   * rasterize_compact_kernel gives every lane its own pixel center, source
//     tile and chunk cap, and reads its source tile's features from device
//     memory directly (lanes are packed source-tile-major, so neighbouring
//     lanes mostly read the same addresses).
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
// Bound: the same as phase A, bytes (chip_smoke.py's bound counts the
// feature chunks the walked (slot, tile) pairs read and every lane's output
// state).
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
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaSig = 0.003921569f;   // float32(1 / 255)
constexpr float kTransEps = 1e-4f;

struct PixelState {
  float acc0, acc1, acc2, trans;
  int cnt, nsig, niter, itk;
};

// One Gaussian's update of one pixel.  Mirrors rasterize_plain step by step.
__device__ __forceinline__ void integrate_one(
    PixelState& s, int* rec, float px, float py, float gmx, float gmy,
    float ca, float cb, float cc, float cr, float cg, float cbl, float op,
    int gid, int abs_pos, int start, bool live, int k_record, bool stop_at_k) {
  const float dx = __fsub_rn(px, gmx);
  const float dy = __fsub_rn(py, gmy);
  // -0.5 * (a*dx*dx + c*dy*dy) - b*dx*dy, left to right as written
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(cb, dx), dy));
  float alpha = __fmul_rn(op, expf(power));
  alpha = alpha > kAlphaMax ? kAlphaMax : alpha;   // NaN propagates, as minimum
  const bool valid = (power <= 0.0f) && (gid >= 0);
  const bool allowed = (abs_pos >= start) && live;
  const bool active = s.trans > kTransEps;
  bool sig = (alpha > kAlphaSig) && valid && allowed;
  bool examined = active && (gid >= 0) && allowed;
  if (stop_at_k) {
    sig = sig && (s.cnt < k_record);
    examined = examined && (s.cnt < k_record);
  }
  if (sig && active) {
    const float w = __fmul_rn(s.trans, alpha);
    s.acc0 = __fadd_rn(s.acc0, __fmul_rn(w, cr));
    s.acc1 = __fadd_rn(s.acc1, __fmul_rn(w, cg));
    s.acc2 = __fadd_rn(s.acc2, __fmul_rn(w, cbl));
    s.trans = __fmul_rn(s.trans, __fsub_rn(1.0f, alpha));
    if (s.cnt < k_record) rec[s.cnt] = gid;
    if (s.cnt + 1 >= k_record && s.cnt < k_record) s.itk = abs_pos + 1;
    s.cnt += 1;
    s.nsig += 1;
  }
  s.niter += examined ? 1 : 0;
}

__device__ __forceinline__ int block_min(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  int m = scratch[0];
  for (int i = 1; i < kPix / 32; ++i) m = min(m, scratch[i]);
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
  extern __shared__ float smem[];
  float* s_mx = smem;
  float* s_my = s_mx + chunk;
  float* s_ca = s_my + chunk;
  float* s_cb = s_ca + chunk;
  float* s_cc = s_cb + chunk;
  float* s_r = s_cc + chunk;
  float* s_g = s_r + chunk;
  float* s_b = s_g + chunk;
  float* s_op = s_b + chunk;
  int* s_id = reinterpret_cast<int*>(s_op + chunk);
  __shared__ int scratch[kPix / 32];

  // grid (T, S): tile t of slot blockIdx.y, row = slot * T + t of the
  // [S * T, ...] operands (S = 1 outside the serving tick)
  const int t = blockIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.y) * gridDim.x + t;
  const int p = threadIdx.x;
  const size_t q = row * kPix + p;
  const float px = static_cast<float>((t % tiles_x) * kTile + (p % kTile)) + 0.5f;
  const float py = static_cast<float>((t / tiles_x) * kTile + (p / kTile)) + 0.5f;
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
      s_mx[j] = mean2d[g * 2 + 0];
      s_my[j] = mean2d[g * 2 + 1];
      s_ca[j] = conic[g * 3 + 0];
      s_cb[j] = conic[g * 3 + 1];
      s_cc[j] = conic[g * 3 + 2];
      s_r[j] = color[g * 3 + 0];
      s_g[j] = color[g * 3 + 1];
      s_b[j] = color[g * 3 + 2];
      s_op[j] = opacity[g];
      s_id[j] = ids[g];
    }
    __syncthreads();
    // a pixel that is dead, saturated or (in prefix mode) full changes
    // nothing in this chunk, so it skips the walk
    if (!done) {
      for (int i = 0; i < chunk; ++i) {
        integrate_one(s, my_rec, px, py, s_mx[i], s_my[i], s_ca[i], s_cb[i],
                      s_cc[i], s_r[i], s_g[i], s_b[i], s_op[i], s_id[i],
                      c * chunk + i, start, live, k_record, stop);
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

__global__ void __launch_bounds__(kPix) rasterize_compact_kernel(
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ color, const float* __restrict__ opacity,
    const int* __restrict__ ids,
    const float* __restrict__ px_in, const float* __restrict__ py_in,
    const int* __restrict__ src_in, const int* __restrict__ ncap_in,
    const float* __restrict__ acc0, const float* __restrict__ trans0,
    const int* __restrict__ rec0, const int* __restrict__ cnt0,
    const int* __restrict__ start_iter, const int* __restrict__ live_in,
    float* __restrict__ acc, float* __restrict__ trans, int* __restrict__ rec,
    int* __restrict__ cnt, int* __restrict__ nsig, int* __restrict__ niter,
    int* __restrict__ itk, int* __restrict__ chunks,
    int k_total, int k_record, int chunk) {
  __shared__ int scratch[kPix / 32];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const size_t q = static_cast<size_t>(t) * kPix + p;
  const float px = px_in[q];
  const float py = py_in[q];
  const size_t src_base = static_cast<size_t>(src_in[q]) * k_total;
  const int lane_cap = ncap_in[q];
  const bool live = live_in[q] != 0;
  const int start = start_iter[q];

  PixelState s;
  load_state(s, q, acc0, trans0, rec0, cnt0, rec, k_record, k_total);
  int* my_rec = rec + q * k_record;

  const int nc_total = k_total / chunk;
  int c = min(block_min(live ? start : k_total, scratch) / chunk, nc_total);
  int nchunks = 0;
  while (true) {
    const bool remaining = live && (s.trans > kTransEps) && (c < lane_cap);
    const int any_left = __syncthreads_or(remaining);
    if (!(c < nc_total) || !any_left) break;
    // a dead or saturated lane changes nothing in this chunk
    if (live && s.trans > kTransEps) {
      for (int i = 0; i < chunk; ++i) {
        const size_t g = src_base + static_cast<size_t>(c) * chunk + i;
        integrate_one(s, my_rec, px, py, mean2d[g * 2 + 0], mean2d[g * 2 + 1],
                      conic[g * 3 + 0], conic[g * 3 + 1], conic[g * 3 + 2],
                      color[g * 3 + 0], color[g * 3 + 1], color[g * 3 + 2],
                      opacity[g], ids[g], c * chunk + i, start, live, k_record,
                      false);
      }
    }
    ++c;
    ++nchunks;
  }
  store_state(s, q, acc, trans, cnt, nsig, niter, itk);
  if (p == 0) chunks[t] = nchunks;
}

int launch_tiles(
    const void* mean2d, const void* conic, const void* color,
    const void* opacity, const void* ids, const void* acc0,
    const void* trans0, const void* rec0, const void* cnt0,
    const void* start_iter, const void* live, const void* ncap, void* acc,
    void* trans, void* rec, void* cnt, void* nsig, void* niter, void* itk,
    void* chunks, int num_tiles, int num_slots, int k_total, int tiles_x,
    int k_record, int chunk, int stop_at_k, void* stream) {
  const size_t smem = static_cast<size_t>(chunk) * 10 * sizeof(float);
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

int rasterize_compact_launch(
    const void* mean2d, const void* conic, const void* color,
    const void* opacity, const void* ids, const void* px, const void* py,
    const void* src, const void* ncap, const void* acc0, const void* trans0,
    const void* rec0, const void* cnt0, const void* start_iter,
    const void* live, void* acc, void* trans, void* rec, void* cnt,
    void* nsig, void* niter, void* itk, void* chunks, int num_lane_tiles,
    int k_total, int k_record, int chunk, void* stream) {
  rasterize_compact_kernel<<<num_lane_tiles, kPix, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean2d), static_cast<const float*>(conic),
      static_cast<const float*>(color), static_cast<const float*>(opacity),
      static_cast<const int*>(ids), static_cast<const float*>(px),
      static_cast<const float*>(py), static_cast<const int*>(src),
      static_cast<const int*>(ncap), static_cast<const float*>(acc0),
      static_cast<const float*>(trans0), static_cast<const int*>(rec0),
      static_cast<const int*>(cnt0), static_cast<const int*>(start_iter),
      static_cast<const int*>(live), static_cast<float*>(acc),
      static_cast<float*>(trans), static_cast<int*>(rec),
      static_cast<int*>(cnt), static_cast<int*>(nsig),
      static_cast<int*>(niter), static_cast<int*>(itk),
      static_cast<int*>(chunks), k_total, k_record, chunk);
  return static_cast<int>(cudaGetLastError());
}

const char* rasterize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
