// Segment reduce: per-run sums over sorted int32 keys, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_reduce.py:segment_reduce
// (the sort-based group-by of in-DB ML).  Its semantic definition is
// repro/kernels/ref.py:segment_reduce: a run end is a live row (key != PAD)
// whose global successor differs (PAD after the last row); the run's total
// is written at its end row, every other row gets zeros, PAD rows are never
// summed.  The TPU kernel walks its grid in order and carries the open run
// of one tile into the next in scratch memory.  Blocks of a GPU grid run in
// parallel and in no order, so the carry becomes a separate pass:
//
//   1. tile_kernel, one 1024-thread block per 1024-row tile, one row per
//      thread: a segmented inclusive scan per value lane (warp shuffles, then
//      one shared-memory combine across the 32 warps) gives every run end
//      its total inside the tile, computed directly rather than as a
//      difference of prefix sums, which cancels badly on long runs.  The
//      block also writes its tile's tail: first and last key, whether the
//      last run is still open, the row of its first run end and the partial
//      sums of its last run.
//   2. carry_kernel, one block: a segmented scan over the tiles' tails gives
//      each tile the partial sums of the run that enters it from earlier
//      tiles, and adds them to the tile's first run end (that end closes the
//      entering run, since the tile's rows up to it all hold the entering
//      key).  A run that spans many tiles, all keys equal included, is
//      carried through every tile it covers.
//
// What bounds it on an H100: bytes.  Keys (4 B) and values (4V B) are read
// once and sums (4V B) and end flags (1 B) written once: 29 B a row at V=3.
// The tile's values are staged in shared memory with coalesced loads and
// its sums leave the same way, so lanes of a row never stride the device
// memory.  The carry pass touches O(n / 1024) words.  All row offsets are
// 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;       // rows per tile = threads per block
constexpr int CARRY_ITEMS = 8;   // tiles per thread in the carry pass
constexpr int PAD_KEY = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

// Segmented inclusive scan of (head, value) pairs across one warp:
// (g, y) then (f, x) combine to (g | f, f ? x : y + x).
__device__ __forceinline__ void warp_seg_scan(int& f, float& x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(FULL, x, d);
    const int g = __shfl_up_sync(FULL, f, d);
    if (lane >= d) {
      if (!f) x += y;
      f |= g;
    }
  }
}

// The same scan across a block of TILE threads.  ``f`` becomes the
// inclusive head flag (a head from the block's first thread up to this
// one); the return value is the inclusive segmented sum.
__device__ float block_seg_scan(int& f, float x, int* s_f, float* s_x) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_seg_scan(f, x);
  if (lane == 31) {
    s_f[warp] = f;
    s_x[warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
    int wf = s_f[lane];
    float wx = s_x[lane];
    warp_seg_scan(wf, wx);
    s_f[lane] = wf;
    s_x[lane] = wx;
  }
  __syncthreads();
  if (warp > 0) {
    if (!f) x += s_x[warp - 1];
    f |= s_f[warp - 1];
  }
  __syncthreads();  // s_f / s_x are reused by the next call
  return x;
}

__global__ void __launch_bounds__(TILE)
tile_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
            float* __restrict__ sums, bool* __restrict__ ends, long long n, int V,
            int* __restrict__ first_key, int* __restrict__ last_key,
            int* __restrict__ open, int* __restrict__ first_end,
            float* __restrict__ tail) {
  extern __shared__ float sv[];  // [TILE * V]: the tile's values, then its sums
  __shared__ int s_f[32];
  __shared__ float s_x[32];
  __shared__ int s_first_end;

  const long long base = (long long)blockIdx.x * TILE;
  const int t = threadIdx.x;
  const long long i = base + t;
  const int rows = (int)min((long long)TILE, n - base);
  const long long off = base * V;
  for (int j = t; j < rows * V; j += TILE) sv[j] = vals[off + j];
  if (t == 0) s_first_end = TILE;

  const int k = i < n ? keys[i] : PAD_KEY;
  const int nk = i + 1 < n ? keys[i + 1] : PAD_KEY;
  const int pk = t == 0 ? 0 : (i - 1 < n ? keys[i - 1] : PAD_KEY);
  const bool live = k != PAD_KEY;
  const bool end = live && k != nk;
  const int head = t == 0 || pk != k;
  __syncthreads();
  if (end) atomicMin(&s_first_end, t);

  for (int j = 0; j < V; ++j) {
    int f = head;
    const float v = (live && t < rows) ? sv[t * V + j] : 0.0f;
    const float x = block_seg_scan(f, v, s_f, s_x);
    if (t < rows) sv[t * V + j] = end ? x : 0.0f;  // only this thread reads this slot
    if (t == TILE - 1) tail[(long long)blockIdx.x * V + j] = x;
  }
  __syncthreads();
  for (int j = t; j < rows * V; j += TILE) sums[off + j] = sv[j];
  if (i < n) ends[i] = end;
  if (t == 0) {
    first_key[blockIdx.x] = k;
    first_end[blockIdx.x] = s_first_end;
  }
  if (t == TILE - 1) {
    last_key[blockIdx.x] = k;
    open[blockIdx.x] = live && !end;
  }
}

// Tile b starts a new segment of the carry scan unless the run open at the
// end of tile b-1 covers all of tile b.
__device__ __forceinline__ int tile_head(long long b, const int* __restrict__ first_key,
                                         const int* __restrict__ last_key,
                                         const int* __restrict__ open) {
  return b == 0 || !(open[b - 1] && first_key[b] == last_key[b]);
}

__global__ void __launch_bounds__(TILE)
carry_kernel(const int* __restrict__ first_key, const int* __restrict__ last_key,
             const int* __restrict__ open, const int* __restrict__ first_end,
             const float* __restrict__ tail, float* __restrict__ sums, long long T, int V) {
  __shared__ int s_f[32];
  __shared__ float s_x[32];
  __shared__ int s_if[TILE];
  __shared__ float s_ix[TILE];
  __shared__ float s_carry;  // scan value at the last tile of the previous chunk

  const int t = threadIdx.x;
  const long long span = (long long)TILE * CARRY_ITEMS;
  for (int j = 0; j < V; ++j) {
    if (t == 0) s_carry = 0.0f;
    __syncthreads();
    for (long long c0 = 0; c0 < T; c0 += span) {
      const long long b0 = c0 + (long long)t * CARRY_ITEMS;
      int f = 0;
      float x = 0.0f;
      for (int q = 0; q < CARRY_ITEMS && b0 + q < T; ++q) {
        const long long b = b0 + q;
        const int h = tile_head(b, first_key, last_key, open);
        const float v = tail[b * V + j];
        x = h ? v : x + v;
        f |= h;
      }
      x = block_seg_scan(f, x, s_f, s_x);
      s_if[t] = f;
      s_ix[t] = x;
      __syncthreads();
      const float carry = s_carry;
      // scan value at the tile just before this thread's first tile
      float run = t == 0 ? carry : (s_if[t - 1] ? s_ix[t - 1] : s_ix[t - 1] + carry);
      for (int q = 0; q < CARRY_ITEMS && b0 + q < T; ++q) {
        const long long b = b0 + q;
        if (b > 0 && open[b - 1] && first_end[b] < TILE) {
          sums[(b * TILE + first_end[b]) * V + j] += run;
        }
        const float v = tail[b * V + j];
        run = tile_head(b, first_key, last_key, open) ? v : run + v;
      }
      __syncthreads();
      if (t == TILE - 1) s_carry = f ? x : x + carry;
      __syncthreads();
    }
  }
}

}  // namespace

// ptrs: keys, vals, sums, ends, first_key, last_key, open, first_end, tail
// ints: n, V.  Returns the cudaGetLastError() of the launches.
extern "C" int segment_reduce_launch(void** ptrs, long long* ints, void* stream) {
  const long long n = ints[0];
  const int V = (int)ints[1];
  const long long T = (n + TILE - 1) / TILE;
  const size_t smem = (size_t)TILE * V * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int* first_key = (int*)ptrs[4];
  int* last_key = (int*)ptrs[5];
  int* open = (int*)ptrs[6];
  int* first_end = (int*)ptrs[7];
  float* tail = (float*)ptrs[8];
  tile_kernel<<<(unsigned)T, TILE, smem, s>>>(
      (const int*)ptrs[0], (const float*)ptrs[1], (float*)ptrs[2], (bool*)ptrs[3], n, V,
      first_key, last_key, open, first_end, tail);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || T < 2) return (int)err;
  carry_kernel<<<1, TILE, 0, s>>>(first_key, last_key, open, first_end, tail,
                                  (float*)ptrs[2], T, V);
  return (int)cudaGetLastError();
}
