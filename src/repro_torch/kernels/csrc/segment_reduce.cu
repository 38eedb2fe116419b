// Segment reduce: per-run sums over sorted int32 keys, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_reduce.py:segment_reduce
// (the sort-based group-by of in-DB ML).  Its semantic definition is
// repro/kernels/ref.py:segment_reduce: a run end is a live row (key != PAD)
// whose global successor differs (PAD after the last row); the run's total
// is written at its end row, every other row gets zeros, PAD rows are never
// summed.  The TPU kernel walks its grid in order and carries the open run
// of one tile into the next in scratch memory.  Blocks of a GPU grid run in
// parallel and in no order, so the carry becomes a single-pass scan with
// decoupled look-back, in one launch:
//
//   * each block claims the next tile of 4,096 rows (256 threads x 16 rows)
//     from a global counter, so every lower tile belongs to a block that is
//     already running and the look-back always makes progress;
//   * it stages the tile's [rows, V] values in shared memory with 16-byte
//     coalesced loads (each thread's 16 rows padded by one 16-byte unit, so
//     that the threads' 16-byte reads of their rows do not collide in banks)
//     and reads its 16 keys with 16-byte loads, plus the next key for the
//     last row's end flag; sums leave the same way;
//   * each thread sums its rows serially, run by run, writing the total at
//     every run end after its first; then one block-wide segmented scan of
//     the threads' (has_end, tail[V]) carries all V lanes in one operator,
//     so the block's barriers do not grow with V;
//   * across tiles a tile's descriptor is (has_end, tail[V]), tail the sum
//     of the rows after its last run end, combined as
//     cur.has_end ? cur : (prev.has_end | cur.has_end, prev.tail + cur.tail).
//     The block publishes its aggregate, walks back over its predecessors'
//     descriptors (aggregates, or an inclusive prefix, which ends the walk;
//     so does the first descriptor with a run end) and publishes its
//     inclusive prefix.  Writers store the values, __threadfence(), then a
//     release store of the status word; readers take an acquire load of the
//     status before the values.  The carry is added to the tile's first run
//     end; no key is compared across tiles, since a row that is not an end
//     has a successor with the same key (a PAD tail adds 0).
//
// Every run total is a direct sum of its rows, never a difference of prefix
// sums, which cancels badly on long runs.
//
// What bounds it on an H100: bytes.  Keys (4 B) and values (4V B) are read
// once and sums (4V B) and end flags (1 B) written once: 29 B a row at V=3.
// The look-back touches O(n / 4096) words.  The ragged last tile (and
// inputs not 16-byte aligned) take plain loads and stores.  All row
// offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, ROWS = 16, TILE = THREADS * ROWS, WARPS = THREADS / 32;
constexpr int MAX_V = 13;  // (4V + 1) * 4 KB of staged values fit the 227 KB of one block
constexpr int PAD_KEY = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned AGGREGATE = 1u, INCLUSIVE = 2u, HAS_END = 256u;  // status word

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

template <int V>
__device__ __forceinline__ void publish(unsigned* status, float* slot, long long b, unsigned kind, int has_end,
                                        const float (&x)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) __stcg(slot + b * V + j, x[j]);
  __threadfence();
  st_release(status + b, kind | (has_end ? HAS_END : 0u));
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(float4& v, int c, float y) {
  if (c == 0) v.x = y;
  else if (c == 1) v.y = y;
  else if (c == 2) v.z = y;
  else v.w = y;
}

// four end flags as four bytes
__device__ __forceinline__ unsigned flag_bytes(unsigned m) {
  return (m & 1u) | ((m >> 1 & 1u) << 8) | ((m >> 2 & 1u) << 16) | ((m >> 3 & 1u) << 24);
}

template <int V>
__global__ void __launch_bounds__(THREADS)
segment_kernel(const int* __restrict__ keys, const float* __restrict__ vals, float* __restrict__ sums,
               bool* __restrict__ ends, long long n, int aligned, int* __restrict__ counter,
               unsigned* __restrict__ status, float* __restrict__ agg, float* __restrict__ inc) {
  constexpr int U = 4 * V;       // 16-byte units of values a thread owns (16 rows)
  constexpr int STRIDE = U + 1;  // ... and their stride in shared memory
  extern __shared__ float4 sv4[];  // THREADS * STRIDE units
  float* sv = reinterpret_cast<float*>(sv4);
  __shared__ long long s_tile;
  __shared__ int s_wf[WARPS];
  __shared__ float s_wx[WARPS][V];
  __shared__ float s_carry[V];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const long long b = s_tile;
  const long long base = b * TILE;
  const long long left = n - base;  // rows of this tile and after
  const bool whole = aligned && left >= TILE;

  // the tile's values into shared memory, unit u of the tile at u + u / U
  if (whole) {
    const float4* g4 = reinterpret_cast<const float4*>(vals + base * V);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = t + i * THREADS;
      sv4[u + u / U] = g4[u];
    }
  } else {
    const long long lim = left * V;
    for (int e = t; e < TILE * V; e += THREADS) sv[e + 4 * ((e >> 2) / U)] = e < lim ? vals[base * V + e] : 0.f;
  }
  // this thread's 16 keys and the key after them
  const long long r0 = base + (long long)t * ROWS;
  int kr[ROWS];
  if (whole) {
    const int4* k4 = reinterpret_cast<const int4*>(keys + r0);
#pragma unroll
    for (int i = 0; i < ROWS / 4; ++i) {
      const int4 x = k4[i];
      kr[4 * i] = x.x;
      kr[4 * i + 1] = x.y;
      kr[4 * i + 2] = x.z;
      kr[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) kr[i] = r0 + i < n ? keys[r0 + i] : PAD_KEY;
  }
  const int nxt = r0 + ROWS < n ? keys[r0 + ROWS] : PAD_KEY;
  __syncthreads();

  // serial segmented sum of the thread's rows, read and written 16 bytes at
  // a time: totals at every end after the first; `first` holds the rows up
  // to the first end, `acc` those after the last
  float4* my = sv4 + t * STRIDE;
  float acc[V], first[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = first[j] = 0.f;
  int first_end = -1;
  unsigned emask = 0;
  float4 in = make_float4(0.f, 0.f, 0.f, 0.f), out = in;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int k = kr[i], nk = i + 1 < ROWS ? kr[i + 1] : nxt;
    const bool live = k != PAD_KEY, end = live && k != nk;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int fi = i * V + j;  // float fi of the thread's rows: lane fi % 4 of unit fi / 4
      if ((fi & 3) == 0) in = my[fi >> 2];
      acc[j] += live ? lane_of(in, fi & 3) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int fi = i * V + j;
      set_lane(out, fi & 3, end ? acc[j] : 0.f);
      if ((fi & 3) == 3) my[fi >> 2] = out;
    }
    if (end) {
      emask |= 1u << i;
      if (first_end < 0) {
        first_end = i;
#pragma unroll
        for (int j = 0; j < V; ++j) first[j] = acc[j];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.f;
    }
  }

  // block-wide segmented scan of (has_end, tail): inclusive within the warp
  int f = first_end >= 0;
  float x[V];
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = acc[j];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int pf = __shfl_up_sync(FULL, f, d);
    float px[V];
#pragma unroll
    for (int j = 0; j < V; ++j) px[j] = __shfl_up_sync(FULL, x[j], d);
    if (lane >= d) {
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = f ? x[j] : px[j] + x[j];
      f |= pf;
    }
  }
  int ef = __shfl_up_sync(FULL, f, 1);  // exclusive within the warp
  float ex[V];
#pragma unroll
  for (int j = 0; j < V; ++j) ex[j] = __shfl_up_sync(FULL, x[j], 1);
  if (lane == 0) {
    ef = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) ex[j] = 0.f;
  }
  if (lane == 31) {
    s_wf[warp] = f;
#pragma unroll
    for (int j = 0; j < V; ++j) s_wx[warp][j] = x[j];
  }
  __syncthreads();
  // the warps before this one, and the whole tile's aggregate
  int wf = 0, af = 0;
  float wx[V], ax[V];
#pragma unroll
  for (int j = 0; j < V; ++j) wx[j] = ax[j] = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w == warp) {
      wf = af;
#pragma unroll
      for (int j = 0; j < V; ++j) wx[j] = ax[j];
    }
    const int sf = s_wf[w];
#pragma unroll
    for (int j = 0; j < V; ++j) ax[j] = sf ? s_wx[w][j] : ax[j] + s_wx[w][j];
    af |= sf;
  }
  // the rows since the last run end before this thread, inside the tile
  const int tf = wf | ef;
  float tx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) tx[j] = ef ? ex[j] : wx[j] + ex[j];

  // decoupled look-back: the carry into this tile from the tiles before it
  if (t == 0) {
    float e[V];
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = 0.f;
    if (b == 0) {
      publish<V>(status, inc, 0, INCLUSIVE, af, ax);
    } else {
      publish<V>(status, agg, b, AGGREGATE, af, ax);
      int eflag = 0;
      for (long long p = b - 1;; --p) {
        unsigned w = ld_acquire(status + p);
        for (uint32_t spins = 0; w == 0u; ++spins) {  // a predecessor that never publishes traps
          if (spins == (1u << 28)) __trap();
          w = ld_acquire(status + p);
        }
        const float* src = (w & 3u) == INCLUSIVE ? inc : agg;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float y = __ldcg(src + p * V + j);
          e[j] = eflag ? e[j] : y + e[j];
        }
        eflag |= (w & HAS_END) != 0u;
        if ((w & 3u) == INCLUSIVE || eflag) break;
      }
      float ix[V];
#pragma unroll
      for (int j = 0; j < V; ++j) ix[j] = af ? ax[j] : e[j] + ax[j];
      publish<V>(status, inc, b, INCLUSIVE, af | eflag, ix);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) s_carry[j] = e[j];
  }
  __syncthreads();

  // the thread's first run end closes the run that enters it
  if (first_end >= 0) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      reinterpret_cast<float*>(my)[first_end * V + j] = (tf ? tx[j] : s_carry[j] + tx[j]) + first[j];
  }
  __syncthreads();
  if (whole) {
    float4* o4 = reinterpret_cast<float4*>(sums + base * V);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = t + i * THREADS;
      o4[u] = sv4[u + u / U];
    }
    *reinterpret_cast<uint4*>(ends + r0) =
        make_uint4(flag_bytes(emask), flag_bytes(emask >> 4), flag_bytes(emask >> 8), flag_bytes(emask >> 12));
  } else {
    const long long lim = left * V;
    for (int e = t; e < TILE * V && e < lim; e += THREADS) sums[base * V + e] = sv[e + 4 * ((e >> 2) / U)];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      if (r0 + i < n) ends[r0 + i] = (emask >> i) & 1u;
  }
}

template <int V>
int run(void** ptrs, long long n, cudaStream_t s) {
  const long long tiles = (n + TILE - 1) / TILE;
  const int smem = THREADS * (4 * V + 1) * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(segment_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int aligned = ((reinterpret_cast<uintptr_t>(ptrs[0]) | reinterpret_cast<uintptr_t>(ptrs[1]) |
                        reinterpret_cast<uintptr_t>(ptrs[2]) | reinterpret_cast<uintptr_t>(ptrs[3])) & 15u) == 0;
  int* scratch = (int*)ptrs[4];  // [0]: the tile counter, [1 .. tiles]: status words
  segment_kernel<V><<<(unsigned)tiles, THREADS, smem, s>>>(
      (const int*)ptrs[0], (const float*)ptrs[1], (float*)ptrs[2], (bool*)ptrs[3], n, aligned, scratch,
      (unsigned*)(scratch + 1), (float*)ptrs[5], (float*)ptrs[6]);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: keys, vals, sums, ends, scratch (int32, 1 + tiles words, zeroed),
// aggregates and inclusive prefixes (float32, tiles x V each).  ints: n, V
// (1 .. 13).  Returns the cudaGetLastError() of the launch.
extern "C" int segment_reduce_launch(void** ptrs, long long* ints, void* stream) {
  const long long n = ints[0];
  const int V = (int)ints[1];
  cudaStream_t s = (cudaStream_t)stream;
  switch (V) {
    case 1: return run<1>(ptrs, n, s);
    case 2: return run<2>(ptrs, n, s);
    case 3: return run<3>(ptrs, n, s);
    case 4: return run<4>(ptrs, n, s);
    case 5: return run<5>(ptrs, n, s);
    case 6: return run<6>(ptrs, n, s);
    case 7: return run<7>(ptrs, n, s);
    case 8: return run<8>(ptrs, n, s);
    case 9: return run<9>(ptrs, n, s);
    case 10: return run<10>(ptrs, n, s);
    case 11: return run<11>(ptrs, n, s);
    case 12: return run<12>(ptrs, n, s);
    case MAX_V: return run<MAX_V>(ptrs, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
