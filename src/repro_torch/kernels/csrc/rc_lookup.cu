// LuminCache probe for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rc_lookup.py::_kernel (called
// through rc_lookup_pallas), which re-expressed the way gather as a one-hot
// matrix product for the TPU's matrix unit, and, in its fused mode, also the
// LRU touch that the JAX package runs after that kernel as a separate step
// (radiance_cache.touch_all_groups): one launch is the whole probe.
//
// What bounds it on an H100: memory.  A record reads its k ids (20 B at
// k = 5), one set's tags and one way's value, does a few integer multiplies
// for the set index and up to W*k compares, and writes hit, value and way
// (and its set index): a few operations per byte, and the ids and outputs
// stream while the probed sets mostly stay in L2.  So the design keeps the
// bytes it moves to those and takes the separate steps out:
//
//  * Records read where they lie.  Thread q takes record q of the
//    slot-major batch (group g, then record j = v * B + p of viewer v,
//    pixel p) from the viewer-major [V, G, B, k] ids, at record
//    (v * G + g) * B + p there: no slot-major copy of the ids is made.
//    With V = 1 that is the identity.  The index arithmetic is 32-bit and,
//    when the block lies in one (group, viewer) run of B records, divides
//    only once per block.
//  * The set index is the uint32 hash of radiance_cache.set_index (mode
//    'hash', kept in lockstep with _mix_index) or the int32 bit
//    concatenation with abs (mode 'bitconcat'), exactly as before.
//  * The first matching way, as argmax takes it (way 0 and its value when
//    nothing matches).  Ways are compared in order and the walk stops at a
//    match; a way stops at its first differing id.  Then the chosen way's
//    value alone is read.  Reading the whole set in 16-byte loads and
//    choosing without a branch, and staging the ids and values through
//    shared memory in 16-byte loads and stores, were each slower on the
//    card (PERF.md, Findings).
//  * The touch (fused mode).  A live record that hits does
//    atomicMax(age[g, set, way], clock[g] + 1 + j) on a copy of age that the
//    wrapper made, and the first record of each group writes clock[g] + V*B.
//    This equals the reference's scatter_reduce(amax) exactly: max commutes,
//    a miss or a dead record scatters nothing, and the reference's -1 for
//    those never wins because age >= 0.  Whole groups of records can hit one
//    slot, so the lanes of a warp that touch one slot first agree
//    (__match_any_sync) and only the highest of them, whose j is the
//    largest, issues the atomic.  That is the same maximum while clock + V*B
//    stays below 2^31, so that no touch age wraps.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__constant__ uint32_t kMix[5] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                 0x27D4EB2Fu, 0x165667B1u};

struct Args {
  const int* tags;             // [G, S, W, k]
  const float* values;         // [G, S, W, 3]
  const int* ids;              // [V, G, B, k], viewer-major
  const unsigned char* live;   // [V] or [V, G], or null: every record live
  int* age;                    // [G, S, W], touched in place; null: lookup only
  const int* clock;            // [G]
  int* clock_out;              // [G]
  unsigned char* hit;          // [V, G, B]
  float* value;                // [V, G, B, 3]
  int* sidx;                   // [V, G, B], or null
  int* way;                    // [V, G, B]
  int groups, viewers, batch, n_sets, n_ways;
  int set_mask;                // n_sets - 1 when n_sets is a power of two, else 0
  int bitconcat, index_shift, per_id_bits;
  int live_per_group;
};

template <int K>
__device__ __forceinline__ int set_of(const int (&id)[K], const Args& a) {
  if (a.bitconcat) {
    const int mask = (1 << a.per_id_bits) - 1;
    int idx = 0;
#pragma unroll
    for (int i = 0; i < K; ++i)
      idx += ((id[i] >> a.index_shift) & mask) * (1 << (a.per_id_bits * i));
    idx = idx < 0 ? -idx : idx;
    return a.set_mask ? idx & a.set_mask : idx % a.n_sets;
  }
  uint32_t h = (static_cast<uint32_t>(id[0]) + 3u) * kMix[0];
#pragma unroll
  for (int i = 1; i < K; ++i) {
    const uint32_t m = (static_cast<uint32_t>(id[i]) + 3u) * kMix[i % 5];
    h = (h ^ m) * 0x9E3779B1u;
  }
  h ^= h >> 15;
  return static_cast<int>(a.set_mask ? h & static_cast<uint32_t>(a.set_mask)
                                     : h % static_cast<uint32_t>(a.n_sets));
}

template <int K>
__global__ void __launch_bounds__(kThreads) rc_lookup_kernel(const Args a) {
  // 32-bit index arithmetic: the wrapper checks G*V*B < 2^31.  The block's
  // first record q0 is group bg's record bj = bv * B + bp; when the block
  // lies in one (group, viewer) run of B records (bp + count <= B) its
  // records sit consecutively from r0 in the viewer-major layout.
  const int t = threadIdx.x;
  const uint32_t vb = static_cast<uint32_t>(a.viewers) * a.batch;
  const uint32_t q0 = blockIdx.x * kThreads;
  const uint32_t n = static_cast<uint32_t>(a.groups) * vb;
  const int count = static_cast<int>(n - q0 < kThreads ? n - q0 : kThreads);
  const uint32_t bg = q0 / vb;
  const uint32_t bj = q0 - bg * vb;
  const uint32_t bv = bj / a.batch;
  const uint32_t bp = bj - bv * a.batch;
  const uint32_t r0 = (bv * a.groups + bg) * a.batch + bp;

  // this thread's record: group g, record j = v * B + p of the slot-major
  // batch, found at r in the viewer-major records (a thread past the end
  // takes the block's first record and stores nothing)
  const bool active = t < count;
  uint32_t g = bg, j = bj + t, v = bv, r = r0 + t;
  if (bp + count > static_cast<uint32_t>(a.batch) || !active) {
    const uint32_t q = q0 + (active ? t : 0);
    g = q / vb;
    j = q - g * vb;
    v = j / a.batch;
    r = (v * a.groups + g) * a.batch + (j - v * a.batch);
  }

  int id[K];
#pragma unroll
  for (int i = 0; i < K; ++i) id[i] = __ldg(a.ids + size_t{r} * K + i);
  const int sidx = set_of<K>(id, a);
  const size_t set = size_t{g} * a.n_sets + sidx;

  int way = 0;
  bool hit = false;
  for (int w = 0; w < a.n_ways && !hit; ++w) {
    const int* tag = a.tags + (set * a.n_ways + w) * K;
    bool match = true;
#pragma unroll
    for (int i = 0; i < K; ++i) match = match && __ldg(tag + i) == id[i];
    if (match) {
      hit = true;
      way = w;
    }
  }
  const float* val = a.values + (set * a.n_ways + way) * 3;
  const float v0 = __ldg(val), v1 = __ldg(val + 1), v2 = __ldg(val + 2);

  // -- the LRU touch (fused mode)
  if (a.age != nullptr) {
    bool live = active && hit;
    if (a.live != nullptr)
      live = live && a.live[a.live_per_group ? v * a.groups + g : v] != 0;
    // int32 wrap-around as the reference's int32 sum
    const int touch_age = static_cast<int>(static_cast<uint32_t>(a.clock[g]) + 1u + j);
    const unsigned slot = live ? static_cast<unsigned>(set * a.n_ways + way) : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, slot);
    if (live && (31 - __clz(peers)) == (t & 31)) atomicMax(a.age + slot, touch_age);
    if (active && j == 0)
      a.clock_out[g] = static_cast<int>(static_cast<uint32_t>(a.clock[g]) + vb);
  }

  if (active) {
    a.hit[r] = hit ? 1 : 0;
    a.way[r] = way;
    if (a.sidx != nullptr) a.sidx[r] = sidx;
    a.value[size_t{r} * 3] = v0;
    a.value[size_t{r} * 3 + 1] = v1;
    a.value[size_t{r} * 3 + 2] = v2;
  }
}

template <int K>
int launch(const Args& a, unsigned blocks, cudaStream_t stream) {
  rc_lookup_kernel<K><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Probe V viewers' records of every group.  Lookup only when `age` is null
// (then `live`, `clock` and `clock_out` are unused); otherwise the LRU touch
// lands in `age` (a copy the caller owns) and `clock_out` receives the
// advanced clock.  `sidx` may be null.  k must be 1..8 and G*V*B and G*S*W
// below 2^31 (the wrapper checks).
int rc_lookup_launch(const void* tags, const void* values, const void* ids,
                     const void* live, void* age, const void* clock,
                     void* clock_out, void* hit, void* value, void* sidx,
                     void* way, int groups, int viewers, int batch, int n_sets,
                     int n_ways, int k, int bitconcat, int index_shift,
                     int per_id_bits, int live_per_group, void* stream) {
  const Args a{static_cast<const int*>(tags), static_cast<const float*>(values),
               static_cast<const int*>(ids), static_cast<const unsigned char*>(live),
               static_cast<int*>(age), static_cast<const int*>(clock),
               static_cast<int*>(clock_out), static_cast<unsigned char*>(hit),
               static_cast<float*>(value), static_cast<int*>(sidx),
               static_cast<int*>(way), groups, viewers, batch, n_sets, n_ways,
               (n_sets & (n_sets - 1)) == 0 ? n_sets - 1 : 0, bitconcat,
               index_shift, per_id_bits, live_per_group};
  const long long n = static_cast<long long>(groups) * viewers * batch;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(a, blocks, s);
    case 2: return launch<2>(a, blocks, s);
    case 3: return launch<3>(a, blocks, s);
    case 4: return launch<4>(a, blocks, s);
    case 5: return launch<5>(a, blocks, s);
    case 6: return launch<6>(a, blocks, s);
    case 7: return launch<7>(a, blocks, s);
    case 8: return launch<8>(a, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rc_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
