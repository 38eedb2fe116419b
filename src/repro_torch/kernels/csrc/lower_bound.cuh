// Lower-bound searches over a sorted int32 key array, shared by the merge
// lookup and the sorted lookup.
#pragma once

#include <cuda_runtime.h>

namespace lb {

// The first index in [lo, hi) whose key is >= q, or hi if none, found by the
// 32 lanes of a warp together: each round every lane reads one of 32 evenly
// spaced keys of the bracket, a ballot counts the keys below q (a prefix of
// the lanes, since the keys are sorted) and the bracket shrinks to one
// spacing.  ceil(log32(hi - lo)) rounds: 5 over 2^22 keys, where one thread
// needs 22 dependent loads.  Every lane of the warp calls it with the same
// arguments and gets the same result.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ keys, int lo, int hi, int q) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int pos = lo + (lane + 1) * step - 1;
    const bool below = pos < hi && __ldg(keys + pos) < q;
    const int cnt = __popc(__ballot_sync(0xffffffffu, below));
    const int nlo = lo + cnt * step;
    hi = min(hi, nlo + step - 1);  // the first spaced key >= q, if any, bounds the answer
    lo = nlo;
  }
  return lo;
}

// The first index in [lo, hi) of k whose key is >= q, or hi: plain binary
// search, for k in shared or global memory.
__device__ __forceinline__ int lower_bound(const int* k, int lo, int hi, int q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The first index in [cur, cnt) of k whose key is >= q, or cnt, given that
// every key before cur is < q: a gallop from cur (cur, cur+1, cur+3, cur+7,
// ...) until a key >= q or the end, then a binary search of the last gap.
// A probe equal to or just after the previous one costs one or two reads.
__device__ __forceinline__ int gallop(const int* k, int cur, int cnt, int q) {
  int lo = cur, step = 1;
  while (lo < cnt && k[lo] < q) {
    const int probe = lo + step;
    if (probe >= cnt) return lower_bound(k, lo + 1, cnt, q);
    if (k[probe] >= q) return lower_bound(k, lo + 1, probe, q);
    lo = probe + 1;
    step <<= 1;
  }
  return lo;
}

}  // namespace lb
