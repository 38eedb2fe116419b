// Merge lookup: non-decreasing probes into a sorted dictionary, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/merge_lookup.py:merge_lookup
// (the paper's hinted lookup).  There the host computes one table window per
// 512-query block, checks coverage once for the whole call and picks the
// whole-call fallback with lax.cond.  Here every block finds its own window
// (one binary search for its first query), checks its own coverage (one for
// its last query) and, if the window misses, its queries binary-search the
// whole table instead: the same function, decided per block.
//
// What bounds it on an H100: bytes.  Each block stages its 2*WINDOW keys and
// values (16 KB + 16*V KB) in shared memory and runs log2(2*WINDOW) rounds of
// shared-memory binary search per query; the table streams once from device
// memory (neighbouring windows overlap and hit in L2), the queries stream
// once and the outputs are written once.  Out-of-range lanes of the last
// block probe EMPTY, as the reference pads its queries.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QUERY_BLOCK = 512;
constexpr int WINDOW = 2048;
constexpr int W2 = 2 * WINDOW;
constexpr int EMPTY_KEY = (int)0x80000000;

// first index in [0, C] whose key is >= q (side="left")
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int C, int q) {
  int lo = 0, hi = C;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (keys[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index in [0, C] whose key is > q (side="right")
__device__ __forceinline__ int upper_bound(const int* __restrict__ keys, int C, int q) {
  int lo = 0, hi = C;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (keys[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(QUERY_BLOCK)
merge_lookup_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                    const int* __restrict__ qs, float* __restrict__ out_vals,
                    bool* __restrict__ out_found, long long n, int C, int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tk = reinterpret_cast<int*>(smem);
  float* tv = reinterpret_cast<float*>(tk + W2);
  __shared__ int s_base, s_ok;

  const long long b0 = (long long)blockIdx.x * QUERY_BLOCK;
  const long long last = min(b0 + QUERY_BLOCK, n) - 1;
  if (threadIdx.x == 0) {
    int lo = lower_bound(keys, C, qs[b0]);
    int hi = upper_bound(keys, C, qs[last]);
    int srow = min(lo / WINDOW, max(C / WINDOW - 2, 0));
    s_base = srow * WINDOW;
    s_ok = hi <= s_base + W2;
  }
  __syncthreads();
  const int base = s_base;
  const bool ok = s_ok;
  if (ok) {
    for (int j = threadIdx.x; j < W2; j += blockDim.x) tk[j] = keys[base + j];
    const long long nv = (long long)W2 * V;
    const float* src = vals + (long long)base * V;
    for (long long j = threadIdx.x; j < nv; j += blockDim.x) tv[j] = src[j];
  }
  __syncthreads();

  const long long i = b0 + threadIdx.x;
  const int q = i < n ? qs[i] : EMPTY_KEY;
  const float* row;
  bool found;
  if (ok) {
    // the reference's fixed-round search over the window
    int lo = 0, hi = W2;
#pragma unroll
    for (int r = 0; r < 13; ++r) {  // (2*WINDOW - 1).bit_length()
      int mid = (lo + hi) >> 1;
      bool right = tk[min(mid, W2 - 1)] < q;
      lo = right ? mid + 1 : lo;
      hi = right ? hi : mid;
    }
    int idx = min(lo, W2 - 1);
    found = tk[idx] == q;
    row = tv + (long long)idx * V;
  } else {
    int idx = min(lower_bound(keys, C, q), C - 1);
    found = keys[idx] == q;
    row = vals + (long long)idx * V;
  }
  if (i < n) {
    for (int j = 0; j < V; ++j) out_vals[i * V + j] = found ? row[j] : 0.0f;
    out_found[i] = found;
  }
}

}  // namespace

// ptrs: keys, vals, queries, out_vals, out_found; ints: n, C, V
extern "C" int merge_lookup_launch(void** ptrs, long long* ints, void* stream) {
  const long long n = ints[0];
  const int C = (int)ints[1], V = (int)ints[2];
  const size_t smem = (size_t)W2 * sizeof(int) + (size_t)W2 * V * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      merge_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + QUERY_BLOCK - 1) / QUERY_BLOCK);
  merge_lookup_kernel<<<grid, QUERY_BLOCK, smem, (cudaStream_t)stream>>>(
      (const int*)ptrs[0], (const float*)ptrs[1], (const int*)ptrs[2],
      (float*)ptrs[3], (bool*)ptrs[4], n, C, V);
  return (int)cudaGetLastError();
}
