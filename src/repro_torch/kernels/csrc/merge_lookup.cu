// Merge lookup: non-decreasing probes into a sorted dictionary, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/merge_lookup.py:merge_lookup
// (the paper's hinted lookup).  There the host computes one table window per
// 512-query block, checks coverage once for the whole call and picks the
// whole-call fallback with lax.cond.  Its semantic definition is
// repro/kernels/ref.py:merge_lookup: the lower bound of each query, clamped
// to C - 1, a key compare, and the value row where the key matches (zeros
// for a miss).
//
// What bounds it on an H100: bytes, the stream of queries in and value rows
// and found flags out (84,055,817 probes at V = 3: 1.43 GB, 0.43 ms at
// 3.35 TB/s).  The sorted probes touch few keys: at the in-DB ML shape about
// 72 probes share a key, so a 4,096-probe tile reads some 60 keys.  The
// first design staged a fixed 4,096-key window (and its values) for every
// 512 probes after two serial full-table searches by one thread, and that
// prologue, not the bytes, set its time.  This design:
//
// * Ranges in a first launch.  merge_ranges_kernel gives every TILE-probe
//   tile its key range, one warp a tile boundary (a 32-ary search, 5 rounds
//   at C = 2^22), all tiles in parallel: bounds[t] is the lower bound of the
//   tile's first probe, bounds[T] that of the last probe.  Tile t's probes
//   all have their lower bound in [bounds[t], bounds[t + 1]].
// * Range-sized staging.  A block copies only keys[start .. end] of its tile
//   (end included: a compare reads it) into shared memory; value rows are
//   not staged, since a tile's found rows are non-decreasing and their
//   gathers coalesce.  A tile whose range exceeds STAGE keys (sparse probes)
//   searches the same range in global memory: the same function, decided
//   per tile.
// * A cursor per thread.  A thread owns PER consecutive probes, loaded as
//   two int4, binary-searches its first in the range and gallops from there
//   for the rest (lb::gallop): one or two reads a probe when probes are
//   dense.
// * Coalesced stores.  Found flags leave packed, 8 bytes a thread; the
//   matched row indices go to shared memory and the tile's [len, V] value
//   block leaves as 16-byte vectors, consecutive threads on consecutive
//   addresses.
// * A persistent grid of a few blocks an SM walks the tiles.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lower_bound.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int PER = 8;                 // consecutive probes a thread owns
constexpr int TILE = THREADS * PER;    // probes a block takes at once
constexpr int STAGE = 4096;            // keys of a tile's range that fit shared memory
constexpr int RANGE_WARPS = 8;         // tile boundaries a block of the first launch searches

__global__ void __launch_bounds__(RANGE_WARPS * 32)
merge_ranges_kernel(const int* __restrict__ keys, const int* __restrict__ qs, int* __restrict__ bounds,
                    long long n, int C, long long T) {
  const long long b = (long long)blockIdx.x * RANGE_WARPS + (threadIdx.x >> 5);
  if (b > T) return;  // whole warps leave together
  const int q = qs[min(b * TILE, n - 1)];
  const int lo = lb::warp_lower_bound(keys, 0, C, q);
  if ((threadIdx.x & 31) == 0) bounds[b] = lo;
}

// V as a constant for V <= 8 (divisions fold; a few percent faster than V
// at run time at both main-path shapes), 0 for any V at run time
template <int VT>
__global__ void __launch_bounds__(THREADS)
merge_lookup_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                    const int* __restrict__ qs, const int* __restrict__ bounds,
                    float* __restrict__ out_vals, bool* __restrict__ out_found,
                    long long n, int C, int Vrt, long long T) {
  __shared__ __align__(16) int sk[STAGE];  // the tile's staged keys
  __shared__ int sidx[TILE];               // each probe's matched row, -1 for a miss
  const int V = VT > 0 ? VT : Vrt;
  const int tid = threadIdx.x;
  const bool q_aligned = (reinterpret_cast<uintptr_t>(qs) & 15) == 0;
  const bool f_aligned = (reinterpret_cast<uintptr_t>(out_found) & 7) == 0;
  const bool v_aligned = (reinterpret_cast<uintptr_t>(out_vals) & 15) == 0;

  for (long long t = blockIdx.x; t < T; t += gridDim.x) {
    const int start = min(bounds[t], C - 1);
    const int end = min(bounds[t + 1], C - 1);
    const int cnt = end - start + 1;
    const bool staged = cnt <= STAGE;
    if (staged)
      for (int j = tid; j < cnt; j += THREADS) sk[j] = __ldg(keys + start + j);

    const long long r0 = t * TILE;
    const long long row = r0 + (long long)tid * PER;
    int q[PER];
    if (q_aligned && row + PER <= n) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(qs + row));
      const int4 b = __ldg(reinterpret_cast<const int4*>(qs + row) + 1);
      q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
      q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
    } else {
#pragma unroll
      for (int p = 0; p < PER; ++p) q[p] = row + p < n ? __ldg(qs + row + p) : qs[n - 1];
    }
    __syncthreads();

    const int* k = staged ? sk : keys + start;
    uint64_t packed = 0;
    int cur = 0;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      cur = p == 0 ? lb::lower_bound(k, 0, cnt, q[0]) : lb::gallop(k, cur, cnt, q[p]);
      const int idx = min(cur, cnt - 1);
      const bool hit = k[idx] == q[p];
      sidx[tid * PER + p] = hit ? start + idx : -1;
      packed |= (uint64_t)hit << (8 * p);
    }
    if (f_aligned && row + PER <= n) {
      *reinterpret_cast<uint64_t*>(out_found + row) = packed;
    } else {
      for (int p = 0; p < PER && row + p < n; ++p) out_found[row + p] = (packed >> (8 * p)) & 1;
    }
    __syncthreads();

    // the tile's [len, V] block of value rows, 16 bytes a thread a step
    const int len = (int)min((long long)TILE, n - r0);
    const int total = len * V;
    float* o = out_vals + r0 * V;
    const int vec = v_aligned ? total >> 2 : 0;
    for (int e4 = tid; e4 < vec; e4 += THREADS) {
      int e = e4 * 4;
      int r = e / V, c = e - r * V;
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = sidx[r];
        w[j] = i >= 0 ? __ldg(vals + (long long)i * V + c) : 0.0f;
        if (++c == V) { c = 0; ++r; }
      }
      reinterpret_cast<float4*>(o)[e4] = make_float4(w[0], w[1], w[2], w[3]);
    }
    for (int e = vec * 4 + tid; e < total; e += THREADS) {
      const int r = e / V, c = e - r * V;
      const int i = sidx[r];
      o[e] = i >= 0 ? __ldg(vals + (long long)i * V + c) : 0.0f;
    }
    __syncthreads();  // sk and sidx are the next tile's
  }
}

// a persistent grid: as many blocks as fit the card at once, or one a tile
template <int VT>
cudaError_t launch_lookup(cudaStream_t stream, void** ptrs, const int* bounds,
                          long long n, int C, int V, long long T) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, merge_lookup_kernel<VT>, THREADS, 0);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(T < resident ? T : resident);
  merge_lookup_kernel<VT><<<grid, THREADS, 0, stream>>>(
      (const int*)ptrs[0], (const float*)ptrs[1], (const int*)ptrs[2], bounds,
      (float*)ptrs[3], (bool*)ptrs[4], n, C, V, T);
  return cudaGetLastError();
}

}  // namespace

// ptrs: keys, vals, queries, out_vals, out_found, bounds (T + 1 int32 of
// scratch); ints: n, C, V.  Two launches on the stream: the tile ranges,
// then the lookup.
extern "C" int merge_lookup_launch(void** ptrs, long long* ints, void* stream) {
  const long long n = ints[0];
  const int C = (int)ints[1], V = (int)ints[2];
  const long long T = (n + TILE - 1) / TILE;
  cudaStream_t s = (cudaStream_t)stream;
  int* bounds = (int*)ptrs[5];
  const unsigned rgrid = (unsigned)((T + 1 + RANGE_WARPS - 1) / RANGE_WARPS);
  merge_ranges_kernel<<<rgrid, RANGE_WARPS * 32, 0, s>>>((const int*)ptrs[0], (const int*)ptrs[2], bounds, n, C, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (V) {
    case 1: return (int)launch_lookup<1>(s, ptrs, bounds, n, C, V, T);
    case 2: return (int)launch_lookup<2>(s, ptrs, bounds, n, C, V, T);
    case 3: return (int)launch_lookup<3>(s, ptrs, bounds, n, C, V, T);
    case 4: return (int)launch_lookup<4>(s, ptrs, bounds, n, C, V, T);
    case 5: return (int)launch_lookup<5>(s, ptrs, bounds, n, C, V, T);
    case 6: return (int)launch_lookup<6>(s, ptrs, bounds, n, C, V, T);
    case 7: return (int)launch_lookup<7>(s, ptrs, bounds, n, C, V, T);
    case 8: return (int)launch_lookup<8>(s, ptrs, bounds, n, C, V, T);
    default: return (int)launch_lookup<0>(s, ptrs, bounds, n, C, V, T);
  }
}
