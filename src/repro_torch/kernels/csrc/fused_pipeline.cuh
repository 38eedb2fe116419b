// Device functions of the fused-pipeline kernel (kernels/fused_pipeline.py).
//
// A generated region source includes this header, defines its row function,
// then includes fused_kernels.cuh, which holds the two kernel templates: a
// dictionary terminal (an open-addressing accumulator in the terminal
// family's probe layout) and a scalar Reduce.  Hashes are bit-identical to
// repro/dicts/base.py:_mix/hash1/hash2 (uint32 arithmetic).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fp {

constexpr int EMPTY_KEY = (int)0x80000000;
constexpr int PAD_KEY = 0x7fffffff;
constexpr int BUCKET = 8;  // ht_twochoice bucket width
constexpr int ST_BLOCK = 128;  // st_blocked leaf width

// One probed dictionary: the family's key-side slabs plus the payload slabs
// aligned to slab positions (float lanes fv[cap, nf], int32 lanes iv[cap, ni]).
struct Dict {
  const int* keys;
  const int* bm;  // st_blocked block maxima (nb entries), else unused
  const float* fv;
  const int* iv;
  int cap;
  int nb;
  int nf;
  int ni;
};

__device__ __forceinline__ uint32_t mix(int x, uint32_t mult) {
  uint32_t h = (uint32_t)x * mult;
  h ^= h >> 15;
  h *= 2654435769u;
  h ^= h >> 13;
  return h;
}
__device__ __forceinline__ int hash1(int k, int cap) {
  return (int)(mix(k, 2654435761u) & (uint32_t)(cap - 1));
}
__device__ __forceinline__ int hash2(int k, int cap) {
  return (int)(mix(k, 2246822519u) & (uint32_t)(cap - 1));
}

// probe sequences: ht_linear (KIND 0) and ht_twochoice (KIND 1)
template <int KIND>
__device__ __forceinline__ int probe_slot(int k, int t, int cap) {
  if (KIND == 0) return (hash1(k, cap) + t) & (cap - 1);
  const int nb = cap / BUCKET;
  if (t < BUCKET) return hash1(k, nb) * BUCKET + t;
  const int b2 = hash2(k, nb) * BUCKET;
  if (t < 2 * BUCKET) return b2 + (t - BUCKET);
  return (b2 + t) & (cap - 1);
}

// resident finds: slab position of q, or -1
template <int KIND>
__device__ __forceinline__ int find_hash(const Dict& d, int q, int max_probes) {
  for (int t = 0; t < max_probes; ++t) {
    const int s = probe_slot<KIND>(q, t, d.cap);
    const int cur = d.keys[s];
    if (cur == q) return s;
    if (cur == EMPTY_KEY) return -1;
  }
  return -1;
}

// base.lower_bound_pow2: min(count of keys < q, L - 1) over a pow2 slab
__device__ __forceinline__ int lower_bound_pow2(const int* keys, int L, int q) {
  int pos = 0;
  for (int bit = L >> 1; bit; bit >>= 1) {
    if (keys[pos + bit - 1] < q) pos += bit;
  }
  return pos;
}

__device__ __forceinline__ int find_st_sorted(const Dict& d, int q) {
  const int pos = lower_bound_pow2(d.keys, d.cap, q);
  return d.keys[pos] == q ? pos : -1;
}

// st_blocked: the leaf is the first block whose max is >= q (binary search
// over the sorted maxima, clamped), then the count of leaf keys below q
__device__ __forceinline__ int find_st_blocked(const Dict& d, int q) {
  int lo = 0, hi = d.nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (d.bm[mid] < q) lo = mid + 1; else hi = mid;
  }
  const int blk = min(lo, d.nb - 1);
  const int base = blk * ST_BLOCK;
  lo = 0;
  hi = ST_BLOCK;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (d.keys[base + mid] < q) lo = mid + 1; else hi = mid;
  }
  const int pos = min(base + lo, d.cap - 1);
  return d.keys[pos] == q ? pos : -1;
}

// JAX/torch floor-mod ("%"), not C's truncating remainder
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ float floor_mod(float a, float b) {
  const float r = fmodf(a, b);
  return (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) ? r + b : r;
}
// wrapping int32 arithmetic (two's complement, as XLA and torch)
__device__ __forceinline__ int add_w(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int sub_w(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int mul_w(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

// semiring lane combines: 0 sum, 1 min, 2 max, and their identities
__device__ __forceinline__ float ident(int op) {
  return op == 0 ? 0.0f : (op == 1 ? INFINITY : -INFINITY);
}
__device__ __forceinline__ float combine(int op, float a, float b) {
  return op == 0 ? a + b : (op == 1 ? fminf(a, b) : fmaxf(a, b));
}
__device__ __forceinline__ void atomic_min_f(float* addr, float v) {
  int* a = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(a);
  while (v < __int_as_float(old)) {
    const int prev = atomicCAS(a, old, __float_as_int(v));
    if (prev == old) break;
    old = prev;
  }
}
__device__ __forceinline__ void atomic_max_f(float* addr, float v) {
  int* a = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(a);
  while (v > __int_as_float(old)) {
    const int prev = atomicCAS(a, old, __float_as_int(v));
    if (prev == old) break;
    old = prev;
  }
}
__device__ __forceinline__ void atomic_combine(int op, float* addr, float v) {
  if (op == 0) atomicAdd(addr, v);
  else if (op == 1) atomic_min_f(addr, v);
  else atomic_max_f(addr, v);
}

// Claim-or-find k's slot in the accumulator (probe layout KIND): an EMPTY
// slot is claimed with atomicCAS; a CAS that loses to the same key joins
// it, one that loses to another key probes on.  -1 past max_probes (the
// reference drops such rows too).
template <int KIND>
__device__ __forceinline__ int acc_slot(int* keys, int cap, int k, int max_probes) {
  for (int t = 0; t < max_probes; ++t) {
    const int s = probe_slot<KIND>(k, t, cap);
    int cur = *reinterpret_cast<volatile int*>(keys + s);
    if (cur == EMPTY_KEY) {
      cur = atomicCAS(keys + s, EMPTY_KEY, k);
      if (cur == EMPTY_KEY) return s;
    }
    if (cur == k) return s;
  }
  return -1;
}

}  // namespace fp
