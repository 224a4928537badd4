// LuminCache probe for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rc_lookup.py::_kernel (called
// through rc_lookup_pallas), which re-expressed the way gather as a one-hot
// matrix product for the TPU's matrix unit.
//
// What bounds it on an H100: memory.  Each query reads its k record ids and
// the W ways' tags and values of one set, does a few integer multiplies for
// the set index and W*k compares, and writes hit, value, set and way: a few
// operations per byte.  The GPU gathers directly, so there is no one-hot
// product: one thread per query computes the set index with uint32
// arithmetic (identical to the hash in radiance_cache.set_index, or the
// bit-concatenation index), reads the set's ways, and takes the first
// matching way, as argmax does.  The LRU touch stays a separate step
// (radiance_cache.touch_all_groups).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ uint32_t kMix[5] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                 0x27D4EB2Fu, 0x165667B1u};

__global__ void rc_lookup_kernel(
    const int* __restrict__ tags, const float* __restrict__ values,
    const int* __restrict__ ids, unsigned char* __restrict__ hit_out,
    float* __restrict__ val_out, int* __restrict__ sidx_out,
    int* __restrict__ way_out, int groups, int n_sets, int n_ways, int k,
    int batch, int bitconcat, int index_shift, int per_id_bits) {
  const long long qi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (qi >= static_cast<long long>(groups) * batch) return;
  const int g = static_cast<int>(qi / batch);
  const int* q = ids + qi * k;

  int sidx;
  if (bitconcat) {
    const int mask = (1 << per_id_bits) - 1;
    int idx = 0;
    for (int i = 0; i < k; ++i)
      idx += ((q[i] >> index_shift) & mask) * (1 << (per_id_bits * i));
    sidx = (idx < 0 ? -idx : idx) % n_sets;
  } else {
    uint32_t h = (static_cast<uint32_t>(q[0]) + 3u) * kMix[0];
    for (int i = 1; i < k; ++i) {
      const uint32_t m = (static_cast<uint32_t>(q[i]) + 3u) * kMix[i % 5];
      h = (h ^ m) * 0x9E3779B1u;
    }
    h ^= h >> 15;
    sidx = static_cast<int>(h % static_cast<uint32_t>(n_sets));
  }

  const size_t set_base = (static_cast<size_t>(g) * n_sets + sidx) * n_ways;
  int way = 0;
  bool hit = false;
  for (int w = 0; w < n_ways && !hit; ++w) {
    const int* tag = tags + (set_base + w) * k;
    bool match = true;
    for (int i = 0; i < k; ++i) match = match && (tag[i] == q[i]);
    if (match) {
      hit = true;
      way = w;
    }
  }
  const float* v = values + (set_base + way) * 3;
  hit_out[qi] = hit ? 1 : 0;
  val_out[qi * 3 + 0] = v[0];
  val_out[qi * 3 + 1] = v[1];
  val_out[qi * 3 + 2] = v[2];
  sidx_out[qi] = sidx;
  way_out[qi] = way;
}

}  // namespace

extern "C" {

int rc_lookup_launch(const void* tags, const void* values, const void* ids,
                     void* hit, void* value, void* sidx, void* way, int groups,
                     int n_sets, int n_ways, int k, int batch, int bitconcat,
                     int index_shift, int per_id_bits, void* stream) {
  const long long n = static_cast<long long>(groups) * batch;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  rc_lookup_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tags), static_cast<const float*>(values),
      static_cast<const int*>(ids), static_cast<unsigned char*>(hit),
      static_cast<float*>(value), static_cast<int*>(sidx),
      static_cast<int*>(way), groups, n_sets, n_ways, k, batch, bitconcat,
      index_shift, per_id_bits);
  return static_cast<int>(cudaGetLastError());
}

const char* rc_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
