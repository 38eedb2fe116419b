// Sorted lookup: probes in any order into a sorted dictionary, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/sorted_lookup.py:sorted_lookup
// (the st_* lookup when the probe sequence is unordered; ordered probes take
// the merge lookup).  There the sorted key array stays in VMEM and each grid
// step runs a branchless binary search for a 512-query tile, C.bit_length()
// rounds of vector gathers.  Its semantic definition is
// repro/kernels/ref.py:sorted_lookup: the lower bound of the query, clamped
// to C - 1, a compare, and the value row where the keys are equal (zeros
// elsewhere).  Here one thread owns one query and runs the same fixed-round
// search: lo, hi start at 0, C; a round reads keys[min(mid, C - 1)] and moves
// lo or hi without a branch.  C.bit_length() rounds shrink any bracket of C
// keys to one index, so C need not be a power of two.  The PAD tail keeps
// every read in range; a query equal to PAD finds a PAD slot, whose value
// row is zero, as in the reference.
//
// What bounds it on an H100: latency of dependent loads, then bytes.  Every
// round is a 4-byte load whose address depends on the last one (23 rounds at
// C = 2^22); the first rounds touch a few keys every
// thread shares (they stay in L1 and L2), the last ones scattered sectors.
// Queries stream in and value rows and found flags stream out, coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
sorted_lookup_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                     const int* __restrict__ qs, float* __restrict__ out_vals,
                     bool* __restrict__ out_found, long long n, int C, int V, int rounds) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int q = qs[i];
  int lo = 0, hi = C;
  for (int r = 0; r < rounds; ++r) {
    const int mid = (lo + hi) >> 1;
    const bool right = __ldg(keys + min(mid, C - 1)) < q;
    lo = right ? mid + 1 : lo;
    hi = right ? hi : mid;
  }
  const int idx = min(lo, C - 1);
  const bool found = keys[idx] == q;
  float* out = out_vals + i * V;
  if (found) {
    const float* row = vals + (long long)idx * V;
    for (int j = 0; j < V; ++j) out[j] = row[j];
  } else {
    for (int j = 0; j < V; ++j) out[j] = 0.0f;
  }
  out_found[i] = found;
}

}  // namespace

// ptrs: keys, vals, queries, out_vals, out_found; ints: n, C, V, rounds
extern "C" int sorted_lookup_launch(void** ptrs, long long* ints, void* stream) {
  const long long n = ints[0];
  const int C = (int)ints[1], V = (int)ints[2], rounds = (int)ints[3];
  const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  sorted_lookup_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)ptrs[0], (const float*)ptrs[1], (const int*)ptrs[2],
      (float*)ptrs[3], (bool*)ptrs[4], n, C, V, rounds);
  return (int)cudaGetLastError();
}
