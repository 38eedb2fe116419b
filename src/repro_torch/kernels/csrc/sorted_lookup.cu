// Sorted lookup: probes in any order into a sorted dictionary, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/sorted_lookup.py:sorted_lookup
// (the st_* lookup when the probe sequence is unordered; ordered probes take
// the merge lookup).  There the sorted key array stays in VMEM and each grid
// step runs a branchless binary search for a 512-query tile, C.bit_length()
// rounds of vector gathers.  Its semantic definition is
// repro/kernels/ref.py:sorted_lookup: the lower bound of the query, clamped
// to C - 1, a compare, and the value row where the keys are equal (zeros
// elsewhere).  A query equal to PAD finds a PAD slot, whose value row is
// zero, as in the reference.
//
// What bounds it on an H100: scattered loads, one 32-byte sector and one
// L1 request per probe per round, and their dependent chain.  The first
// design ran C.bit_length() rounds over the whole array (23 at C = 2^22):
// with shuffled probes the rounds after about the tenth land on scattered
// sectors of the 16.8 MB array (served from L2), and each warp-wide load of
// 32 distinct lines costs the SM's L1 one request a lane.  The bytes a
// lookup must move (each probe, output and live key once) would take a
// twentieth of that time; no search of random probes comes near it.  This
// design moves the search's top levels on chip and cuts the loads a probe
// makes in global memory:
//
// * A sample in shared memory.  sample_kernel (one small launch) counts the
//   live keys L (the lower bound of PAD, one 32-ary warp search a block) and
//   writes every S-th key of [0, L), S the least power of two that leaves at
//   most SAMPLE_KEYS samples (192 KB; S = 32 at SF 1's 1,500,000 live keys of
//   4,194,304).  Each persistent block of the search copies the sample into
//   shared memory once, with 16-byte loads, swizzled so that one round's
//   mids, spaced by powers of two, fall into different banks.
// * Rounds on chip, then one bucket in global memory.  A probe's lower bound
//   b in the sample brackets its lower bound in the keys to the S - 1 keys
//   after sample b - 1: (S - 1).bit_length() rounds there, 5 at S = 32 (one
//   128-byte line), against 23 over the whole array.  Probes past the live
//   keys land on L, the first PAD slot.
// * No load for the compare.  A round that moves hi keeps the key it read,
//   and the bracket's first hi is sample b (or the PAD slot), so the key at
//   the lower bound is known when the rounds end.
// * The whole table on chip when it fits.  For C <= SAMPLE_KEYS the search
//   stages the keys themselves as the sample (S = 1, L = C): every round
//   runs in shared memory and there is no sample launch.
// * Staging only where probes pay for it.  Each block stages up to 192 KB,
//   so a launch whose blocks would search fewer probes than BLOCK, or than
//   1/16 of the keys they stage, takes the first design instead
//   (global_lookup_kernel; sorted_lookup.py:search_path decides).  On an
//   H100 (tools/lookup_timings.py) that search wins at the installation
//   sweep's cells up to 2^16 keys and loses from 2^17 keys with shuffled
//   probes; small tables under millions of probes stage.
// * Each thread runs PPT = 2 probes' searches interleaved, one block of
//   1,024 threads an SM.  PPT = 2 was faster than 4 and 8 at every staged
//   shape; PPT = 1 was 1.5-5 % faster, except with ordered probes into a
//   sampled table, where it was 15 % slower (tools/lookup_timings.py).
// * Ordered probes lose.  Where the lanes of a warp search neighbouring
//   probes, the first design's loads broadcast and hit in L1, and it beats
//   the staged search (by 11 % at the sweep's 2^21 cell, 44 % at 2^17);
//   the wrapper cannot see the order without a pass over the probes.
//
// Every round is branchless and fixed in number, as in the reference: lo,
// hi move by a compare, and a read past the bracket is clamped in range.
// Reading each bucket as whole 128-byte lines (8 lanes a probe, shuffles
// and a count) was tried and not kept: it helped shuffled probes only at
// S = 32 and slowed ordered ones, whose lanes share a bucket and so
// broadcast the rounds' loads.  An Eytzinger layout would make the top
// rounds contiguous too, but it would change SortedTable's layout; the
// sample keeps the dictionary as it is and adds no state to it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lower_bound.cuh"

namespace {

constexpr int BLOCK = 1024;
constexpr int PPT = 2;                // probes a thread searches at once
constexpr int GLOBAL_BLOCK = 256;     // the global search's threads a block
constexpr int SAMPLE_KEYS = 49152;    // keys of the on-chip sample (196,608 B)
constexpr int SAMPLE_THREADS = 256;
constexpr int PAD_KEY = 0x7fffffff;

// hdr = {L, S, M}: the live keys, the stride, the samples
__global__ void __launch_bounds__(SAMPLE_THREADS)
sample_kernel(const int* __restrict__ keys, int C, int* __restrict__ sample, int* __restrict__ hdr) {
  __shared__ int s_live;
  if (threadIdx.x < 32) {
    const int live = lb::warp_lower_bound(keys, 0, C, PAD_KEY);
    if (threadIdx.x == 0) s_live = live;
  }
  __syncthreads();
  const int L = s_live;
  int S = 1;
  while ((L + S - 1) / S > SAMPLE_KEYS) S <<= 1;
  const int M = (L + S - 1) / S;
  const int j = blockIdx.x * SAMPLE_THREADS + threadIdx.x;
  if (j < M) sample[j] = __ldg(keys + (long long)j * S);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    hdr[0] = L;
    hdr[1] = S;
    hdr[2] = M;
  }
}

__device__ __forceinline__ int bit_length(int x) { return 32 - __clz(x); }

// Where sample j sits in shared memory: its 32-word row, its bank permuted
// by the higher bits of j.  A search's mids in one round are spaced by
// powers of two, so unpermuted they fall into one bank (a 32-way conflict
// for shuffled probes); permuted they spread over the banks.
__device__ __forceinline__ int swizzle(int j) { return j ^ (((j >> 5) ^ (j >> 10) ^ (j >> 15)) & 31); }

__global__ void __launch_bounds__(BLOCK, 1)
sorted_lookup_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                     const int* __restrict__ qs, float* __restrict__ out_vals,
                     bool* __restrict__ out_found, const int* __restrict__ src,
                     const int* __restrict__ hdr, long long n, int C, int V, int L, int S, int M) {
  extern __shared__ int ss[];  // the sample, swizzled, in rows of 32
  if (hdr != nullptr) {
    L = hdr[0];
    S = hdr[1];
    M = hdr[2];
  }
  int vec = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    vec = M / 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int j = threadIdx.x; j < vec; j += BLOCK) {
      const int4 w = __ldg(s4 + j);
      ss[swizzle(4 * j)] = w.x;
      ss[swizzle(4 * j + 1)] = w.y;
      ss[swizzle(4 * j + 2)] = w.z;
      ss[swizzle(4 * j + 3)] = w.w;
    }
  }
  for (int j = 4 * vec + threadIdx.x; j < M; j += BLOCK) ss[swizzle(j)] = __ldg(src + j);
  __syncthreads();
  const int top = bit_length(M);       // rounds over the sample
  const int bottom = bit_length(S - 1);  // rounds over one bucket

  // the grid takes PPT slices of gridDim.x * BLOCK probes a step; a block
  // its BLOCK-probe part of each, so that small batches still fill the card
  const long long slice = (long long)gridDim.x * BLOCK;
  const long long first = (long long)blockIdx.x * BLOCK + threadIdx.x;
  for (long long base = 0; base < n; base += slice * PPT) {
    // slices wholly past n are not searched (a small batch fills fewer)
    const int slices = (int)min((long long)PPT, (n - base + slice - 1) / slice);
    int q[PPT], lo[PPT], hi[PPT], khi[PPT];  // khi: the key at hi, once known
    bool has_hi[PPT];
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const long long i = base + p * slice + first;
      q[p] = i < n ? __ldg(qs + i) : PAD_KEY;
      lo[p] = 0;
      hi[p] = M;
    }
    for (int r = 0; r < top; ++r) {
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        if (p >= slices) break;
        const int mid = (lo[p] + hi[p]) >> 1;
        const bool right = ss[swizzle(min(mid, M - 1))] < q[p];
        lo[p] = right ? mid + 1 : lo[p];
        hi[p] = right ? hi[p] : mid;
      }
    }
#pragma unroll
    for (int p = 0; p < PPT; ++p) {  // sample b brackets the keys to ((b - 1) S, min(b S, L)]
      const int b = min(lo[p], M);
      lo[p] = b > 0 ? (b - 1) * S + 1 : 0;
      hi[p] = b > 0 ? min(b * S, L) : 0;
      // the key at hi: sample b, or the first PAD slot; none past a table without PAD
      has_hi[p] = b < M || L < C;
      khi[p] = b < M ? ss[swizzle(b)] : PAD_KEY;
    }
    for (int r = 0; r < bottom; ++r) {
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        if (p >= slices) break;
        const int mid = (lo[p] + hi[p]) >> 1;
        const int k = __ldg(keys + min(mid, C - 1));
        const bool right = k < q[p];
        lo[p] = right ? mid + 1 : lo[p];
        hi[p] = right ? hi[p] : mid;
        khi[p] = right ? khi[p] : k;
        has_hi[p] = has_hi[p] || !right;
      }
    }
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const long long i = base + p * slice + first;
      if (i >= n) continue;
      // lo converged on hi, whose key is known: no load for the compare
      const int idx = min(lo[p], C - 1);
      const bool found = has_hi[p] && khi[p] == q[p];
      float* out = out_vals + i * V;
      const float* row = vals + (long long)idx * V;
      for (int j = 0; j < V; ++j) out[j] = found ? __ldg(row + j) : 0.0f;
      out_found[i] = found;
    }
  }
}

// The first design, for a launch whose probes are too few to pay for
// staging: one thread a probe, C.bit_length() branchless rounds over the
// whole array in global memory (the top rounds' keys, shared by every
// thread, stay in L1 and L2), then a load for the compare.
__global__ void __launch_bounds__(GLOBAL_BLOCK)
global_lookup_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                     const int* __restrict__ qs, float* __restrict__ out_vals,
                     bool* __restrict__ out_found, long long n, int C, int V) {
  const long long i = (long long)blockIdx.x * GLOBAL_BLOCK + threadIdx.x;
  if (i >= n) return;
  const int q = __ldg(qs + i);
  int lo = 0, hi = C;
  for (int r = bit_length(C); r > 0; --r) {
    const int mid = (lo + hi) >> 1;
    const bool right = __ldg(keys + min(mid, C - 1)) < q;
    lo = right ? mid + 1 : lo;
    hi = right ? hi : mid;
  }
  const int idx = min(lo, C - 1);
  const bool found = __ldg(keys + idx) == q;
  float* out = out_vals + i * V;
  const float* row = vals + (long long)idx * V;
  for (int j = 0; j < V; ++j) out[j] = found ? __ldg(row + j) : 0.0f;
  out_found[i] = found;
}

}  // namespace

// ptrs: keys, vals, queries, out_vals, out_found, scratch (the sample and its
// header, 4 + SAMPLE_KEYS int32, for path 2; else null); ints: n, C, V,
// path.  Path 0: the global search (one launch); 1: the whole table staged
// (C <= SAMPLE_KEYS, one launch); 2: the sample launch, then the search
// over it.  The wrapper chooses the path (sorted_lookup.py:search_path).
extern "C" int sorted_lookup_launch(void** ptrs, long long* ints, void* stream) {
  const long long n = ints[0];
  const int C = (int)ints[1], V = (int)ints[2], path = (int)ints[3];
  cudaStream_t s = (cudaStream_t)stream;
  const int* keys = (const int*)ptrs[0];
  int* scratch = (int*)ptrs[5];
  if (path == 0) {
    const unsigned grid = (unsigned)((n + GLOBAL_BLOCK - 1) / GLOBAL_BLOCK);
    global_lookup_kernel<<<grid, GLOBAL_BLOCK, 0, s>>>(
        keys, (const float*)ptrs[1], (const int*)ptrs[2], (float*)ptrs[3], (bool*)ptrs[4], n, C, V);
    return (int)cudaGetLastError();
  }
  if ((path == 1) != (scratch == nullptr) || (path == 1 && C > SAMPLE_KEYS) || path > 2)
    return (int)cudaErrorInvalidValue;
  const int* src = keys;
  const int* hdr = nullptr;
  int smem_keys = C;
  if (path == 2) {
    // header first, so that the sample starts 16-byte aligned
    smem_keys = SAMPLE_KEYS;
    hdr = scratch;
    src = scratch + 4;
    sample_kernel<<<SAMPLE_KEYS / SAMPLE_THREADS, SAMPLE_THREADS, 0, s>>>(keys, C, scratch + 4, scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = (size_t)(smem_keys + 31) / 32 * 32 * sizeof(int);  // whole swizzled rows
  cudaError_t err = cudaFuncSetAttribute(sorted_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(SAMPLE_KEYS * sizeof(int)));
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (n + BLOCK - 1) / BLOCK;  // one block an SM, fewer for a small batch
  const unsigned grid = (unsigned)(blocks < sms ? blocks : sms);
  sorted_lookup_kernel<<<grid, BLOCK, smem, s>>>(
      keys, (const float*)ptrs[1], (const int*)ptrs[2], (float*)ptrs[3], (bool*)ptrs[4],
      src, hdr, n, C, V, C, 1, C);
  return (int)cudaGetLastError();
}
