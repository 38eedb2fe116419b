// Open-addressing claim tables on Hopper: what the fused pipeline's
// dictionary terminals (fused_kernels.cuh) and the hash build (hash_build.cu)
// share.  Hashes are bit-identical to repro/dicts/base.py:_mix/hash1/hash2
// (uint32 arithmetic); the probe layouts are ht_linear's (KIND 0) and
// ht_twochoice's (KIND 1).
//
// A claim table is a key array of EMPTY slots and value lanes beside it,
// in device memory or in a block's shared memory.  A row claims the first
// slot of its key's probe chain that holds its key or is EMPTY (atomicCAS);
// a CAS lost to the same key joins it, one lost to another key probes on;
// past max_probes the row is dropped, as the reference drops it.  Within one
// launch a slot goes from EMPTY to a key once and never back, so every row
// of a key stops at the same slot and a key is kept or dropped whole.
//
// Before a warp touches a table it aggregates: __match_any_sync finds the
// lanes whose live rows share a key, shuffles fold their value lanes into
// the group's first lane, and that lane alone claims and combines once.
// Rows of one key arrive together in the main paths' streams (lineitem in
// l_orderkey order, Q1's four groups), so a warp makes a few claims where it
// made 32.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fp {

constexpr int EMPTY_KEY = (int)0x80000000;
constexpr int BUCKET = 8;  // ht_twochoice bucket width
constexpr unsigned FULL_WARP = 0xffffffffu;

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
// one lane's combine into a table (device or shared memory)
__device__ __forceinline__ void atomic_combine(int op, float* addr, float v) {
  if (op == 0) atomicAdd(addr, v);
  else if (op == 1) atomic_min_f(addr, v);
  else atomic_max_f(addr, v);
}

// Claim-or-find k's slot in a table of cap slots (probe layout KIND),
// walking its chain from probe t0 (0: its home slot); -1 past max_probes.
// The first read of a slot is a plain load (cached in L1 for a table in
// device memory), not a volatile one: a slot goes from EMPTY to a key once
// and never back within a launch, so a stale read can only say EMPTY, and
// the atomicCAS that follows then returns the key really there.
template <int KIND>
__device__ __forceinline__ int acc_slot(int* keys, int cap, int k, int max_probes, int t0 = 0) {
  for (int t = t0; t < max_probes; ++t) {
    const int s = probe_slot<KIND>(k, t, cap);
    int cur = keys[s];
    if (cur == EMPTY_KEY) {
      cur = atomicCAS(keys + s, EMPTY_KEY, k);
      if (cur == EMPTY_KEY) return s;
    }
    if (cur == k) return s;
  }
  return -1;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// The lanes of this warp whose live rows carry this lane's key (itself
// included); a dead lane's group is itself alone.  live_lanes is the warp's
// ballot of live.  Every lane of the warp calls it.
__device__ __forceinline__ unsigned warp_peers(unsigned live_lanes, bool live, int key) {
  const unsigned same = __match_any_sync(FULL_WARP, key);
  return live ? (same & live_lanes) : (1u << lane_id());
}

// whether this lane leads its group (the group's lowest lane)
__device__ __forceinline__ bool leads(unsigned peers) {
  return (peers & ((1u << lane_id()) - 1u)) == 0;
}

// Fold each group's values into its leader: a tree over the group's ranks.
// Each round a lane combines the value of its next higher peer still in
// play, then the lanes of odd rank leave play: log2 of the largest group's
// size rounds, none when every group is one lane.  op(j) is lane j's
// combine.  Every lane of the warp calls it.
template <int N, typename Op>
__device__ __forceinline__ void warp_fold(unsigned peers, float (&v)[N], Op op) {
  const int lane = lane_id();
  unsigned rest = peers & (0xfffffffeu << lane);  // peers above this lane
  int rank = __popc(peers & ((1u << lane) - 1u));
  while (__any_sync(FULL_WARP, rest != 0)) {
    const int src = __ffs(rest) - 1;  // -1 when none: the shuffle's value is then unused
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float x = __shfl_sync(FULL_WARP, v[j], src & 31);
      if (src >= 0) v[j] = combine(op(j), v[j], x);
    }
    rest &= __ballot_sync(FULL_WARP, (rank & 1) == 0);
    rank >>= 1;
  }
}

}  // namespace fp
