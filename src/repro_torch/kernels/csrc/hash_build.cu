// Hash build: batched insert-aggregate into an empty ht_linear table, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/hash_build.py:hash_build.
// There the table lives in VMEM scratch carried across the sequential grid;
// each step inserts one 1024-row tile in bounded probe rounds, settling
// claims on EMPTY slots by scatter-max arbitration on the row id, re-checking
// losers for the same key and adding the winners' and hitters' values; rows
// still pending after max_probes rounds are dropped.  Its semantic twin is
// dicts/base.py:generic_insert into an empty table.  Blocks of a GPU grid run
// in parallel, so nothing carries between them, and a block's shared memory
// (227 KB) holds a few thousand slots, not a table of millions.
//
// What bounds it on an H100: bytes, and then claims and atomics at hashed
// slots: rows of one key serialize on its slot, so duplicate-heavy batches
// are bound by same-address atomics in L2, and a 4,194,304-slot table is
// 33.5 MB of scattered claims plus the fill that empties it first.  Three
// paths, picked per launch by kernels/hash_build.py:build_path:
//
// * global: a thread a row; the warp folds its rows by key (claim_table.cuh:
//   __match_any_sync, shuffles) and one lane a key claims its slot in the
//   table in device memory (fp::acc_slot<0>) and adds its lanes.  The
//   wrapper fills the table with EMPTY keys and zero values first.
// * private: the table fits a block's shared memory (keys and lanes): each
//   block claims and sums its rows in a private copy (same probe layout, so
//   a key's private chain is no longer than in the global table; a row whose
//   chain runs past max_probes there claims in device memory directly) and
//   at the end flushes each occupied slot once, one claim a key.  For the
//   sweep's duplicate-heavy batches (up to 8,192 rows a key) the same-address
//   atomics then stay on chip.
// * partitioned: slots are cut into slices of S slots (S·(1+V)·4 bytes fit
//   shared memory).  A count launch makes a histogram of the rows by
//   hash1(k) / S, a scan launch turns it into slice offsets, a scatter launch
//   writes keys and value rows in slice order (invalid rows left out).  Then
//   one block a slice builds it in shared memory (linear probing inside the
//   slice, no wrap) and writes the whole slice out coalesced, EMPTY keys and
//   zero lanes included: the table needs no fill.  A key whose chain runs
//   off its slice's end goes to an overflow list with the probes it used;
//   a last launch claims those keys in the written table from the next
//   slice's first slot on (wrapping at C), within the remaining max_probes.
//   The chain of every key then still runs from hash1(k) with no EMPTY slot
//   before its key (overflow claims only fill EMPTY slots), so hash_probe
//   and the fused finds read the table as the reference lays it out.
//
// Every path keeps a key whole: slots go from EMPTY to a key once and never
// back, so the rows of a key that meet the same chain stop at the same slot
// or all run past max_probes.  Float32 sums fold in the order the atomics
// land, not the reference's.
#include "claim_table.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int ROWS = 4096;  // rows a count / scatter block takes
constexpr int PER = ROWS / BLOCK;
constexpr int SLICE_BLOCK = 1024;  // threads a slice block (more rows in flight a slice)
constexpr int OVERFLOW_GRID = 132;

// Fold a group's value rows into its leader, VC lanes at a time, and add
// them at acc (the leader's slot row, nullptr where there is none); with
// store, write them instead (an overflow record).  Every lane calls it.
template <int VC>
__device__ __forceinline__ void fold_add(unsigned peers, const float* row, int V, float* acc, bool store) {
  for (int j0 = 0; j0 < V; j0 += VC) {
    float v[VC];
#pragma unroll
    for (int j = 0; j < VC; ++j) v[j] = (row != nullptr && j0 + j < V) ? row[j0 + j] : 0.0f;
    fp::warp_fold(peers, v, [](int) { return 0; });
    if (acc == nullptr) continue;
#pragma unroll
    for (int j = 0; j < VC; ++j) {
      if (j0 + j >= V) break;
      if (store) acc[j0 + j] = v[j];
      else atomicAdd(acc + j0 + j, v[j]);
    }
  }
}

template <int VC>
__global__ void __launch_bounds__(BLOCK)
global_kernel(const int* __restrict__ ks, const float* __restrict__ vs, const bool* __restrict__ valid,
              int* tkeys, float* tvals, long long n, int C, int V, int max_probes) {
  const int lane = fp::lane_id();
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long w = (long long)blockIdx.x * BLOCK + threadIdx.x - lane; w < n; w += stride) {
    const long long i = w + lane;
    const bool live = i < n && (valid == nullptr || valid[i]);
    const int k = live ? ks[i] : 0;
    const unsigned peers = fp::warp_peers(__ballot_sync(fp::FULL_WARP, live), live, k);
    float* acc = nullptr;
    if (live && fp::leads(peers)) {
      const int s = fp::acc_slot<0>(tkeys, C, k, max_probes);
      if (s >= 0) acc = tvals + (long long)s * V;  // else dropped, as the reference drops it
    }
    fold_add<VC>(peers, live ? vs + i * V : nullptr, V, acc, false);
  }
}

// Dynamic shared memory: [C keys] [C * V lanes]
template <int VC>
__global__ void __launch_bounds__(BLOCK)
private_kernel(const int* __restrict__ ks, const float* __restrict__ vs, const bool* __restrict__ valid,
               int* tkeys, float* tvals, long long n, int C, int V, int max_probes) {
  extern __shared__ int sm[];
  int* pk = sm;
  float* pv = reinterpret_cast<float*>(sm + C);
  for (int t = threadIdx.x; t < C; t += BLOCK) pk[t] = fp::EMPTY_KEY;
  for (int t = threadIdx.x; t < C * V; t += BLOCK) pv[t] = 0.0f;
  __syncthreads();
  const int lane = fp::lane_id();
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long w = (long long)blockIdx.x * BLOCK + threadIdx.x - lane; w < n; w += stride) {
    const long long i = w + lane;
    const bool live = i < n && (valid == nullptr || valid[i]);
    const int k = live ? ks[i] : 0;
    const unsigned peers = fp::warp_peers(__ballot_sync(fp::FULL_WARP, live), live, k);
    float* acc = nullptr;
    if (live && fp::leads(peers)) {
      int s = fp::acc_slot<0>(pk, C, k, max_probes);
      if (s >= 0) {
        acc = pv + s * V;
      } else {  // the private chain ran past max_probes: claim in device memory
        s = fp::acc_slot<0>(tkeys, C, k, max_probes);
        if (s >= 0) acc = tvals + (long long)s * V;
      }
    }
    fold_add<VC>(peers, live ? vs + i * V : nullptr, V, acc, false);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < C; t += BLOCK) {
    const int k = pk[t];
    if (k == fp::EMPTY_KEY) continue;
    const int s = fp::acc_slot<0>(tkeys, C, k, max_probes);
    if (s < 0) continue;
    for (int j = 0; j < V; ++j) atomicAdd(tvals + (long long)s * V + j, pv[t * V + j]);
  }
}

// the slice of a key: its home slot's, hash1(k) >> shift (S = 2^shift)
__device__ __forceinline__ int slice_of(int k, int C, int shift) { return fp::hash1(k, C) >> shift; }

// Dynamic shared memory: [nslices] counts.  Block b counts rows [b * ROWS, (b + 1) * ROWS).
__global__ void __launch_bounds__(BLOCK)
count_kernel(const int* __restrict__ ks, const bool* __restrict__ valid, long long n, int C, int shift,
             int nslices, int* counts) {
  extern __shared__ int hist[];
  for (int t = threadIdx.x; t < nslices; t += BLOCK) hist[t] = 0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * ROWS;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const long long i = r0 + r * BLOCK + threadIdx.x;
    if (i < n && (valid == nullptr || valid[i])) atomicAdd(hist + slice_of(ks[i], C, shift), 1);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nslices; t += BLOCK) {
    if (hist[t] != 0) atomicAdd(counts + t, hist[t]);
  }
}

// One block of 1,024 threads: offs[s] = rows of slices before s (offs[nslices]
// = all rows), cursor[s] = offs[s].
__global__ void __launch_bounds__(1024)
scan_kernel(const int* __restrict__ counts, int nslices, int* offs, int* cursor) {
  __shared__ int warp_sums[32];
  const int per = (nslices + 1023) / 1024;
  const int lo = threadIdx.x * per;
  int sum = 0;
  for (int t = lo; t < min(lo + per, nslices); ++t) sum += counts[t];
  const int lane = fp::lane_id(), warp = threadIdx.x >> 5;
  int incl = sum;  // inclusive scan of the threads' sums: warps, then the warps' totals
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(fp::FULL_WARP, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(fp::FULL_WARP, w, off);
      if (lane >= off) w += x;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int t = lo; t < min(lo + per, nslices); ++t) {
    offs[t] = run;
    cursor[t] = run;
    run += counts[t];
  }
  if (threadIdx.x == 1023) offs[nslices] = run;
}

// Dynamic shared memory: [nslices] counts, then [nslices] bases.  Block b
// scatters rows [b * ROWS, (b + 1) * ROWS) into slice order: one cursor
// reservation a (block, slice), a row's place is its rank among the block's
// rows of its slice.
__global__ void __launch_bounds__(BLOCK)
scatter_kernel(const int* __restrict__ ks, const float* __restrict__ vs, const bool* __restrict__ valid,
               long long n, int C, int shift, int nslices, int V, int* cursor, int* sk, float* sv) {
  extern __shared__ int sh[];
  int* hist = sh;
  int* base = sh + nslices;
  for (int t = threadIdx.x; t < nslices; t += BLOCK) hist[t] = 0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * ROWS;
  int key[PER], slice[PER], rank[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const long long i = r0 + r * BLOCK + threadIdx.x;
    slice[r] = -1;
    if (i < n && (valid == nullptr || valid[i])) {
      key[r] = ks[i];
      slice[r] = slice_of(key[r], C, shift);
      rank[r] = atomicAdd(hist + slice[r], 1);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nslices; t += BLOCK) {
    if (hist[t] != 0) base[t] = atomicAdd(cursor + t, hist[t]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    if (slice[r] < 0) continue;
    const long long i = r0 + r * BLOCK + threadIdx.x;
    const long long at = (long long)base[slice[r]] + rank[r];
    sk[at] = key[r];
    for (int j = 0; j < V; ++j) sv[at * V + j] = vs[i * V + j];
  }
}

// Dynamic shared memory: [S keys] [S * V lanes].  Block b builds slice b
// (slots [b * S, (b + 1) * S)) from its rows sk/sv[offs[b], offs[b + 1]).
template <int VC>
__global__ void __launch_bounds__(SLICE_BLOCK)
slice_kernel(const int* __restrict__ sk, const float* __restrict__ sv, const int* __restrict__ offs, int C,
             int S, int V, int max_probes, int* tkeys, float* tvals, int* ov_count, int* ov_keys, int* ov_t,
             float* ov_vals) {
  extern __shared__ int sm[];
  int* pk = sm;
  float* pv = reinterpret_cast<float*>(sm + S);
  for (int t = threadIdx.x; t < S; t += SLICE_BLOCK) pk[t] = fp::EMPTY_KEY;
  for (int t = threadIdx.x; t < S * V; t += SLICE_BLOCK) pv[t] = 0.0f;
  __syncthreads();
  const long long first = (long long)blockIdx.x * S;
  const long long lo = offs[blockIdx.x], hi = offs[blockIdx.x + 1];
  const int lane = fp::lane_id();
  for (long long w = lo + threadIdx.x - lane; w < hi; w += SLICE_BLOCK) {
    const long long i = w + lane;
    const bool live = i < hi;
    const int k = live ? sk[i] : 0;
    const unsigned peers = fp::warp_peers(__ballot_sync(fp::FULL_WARP, live), live, k);
    float* acc = nullptr;
    bool store = false;
    if (live && fp::leads(peers)) {
      const int h = (int)(fp::hash1(k, C) - first);  // home slot within the slice
      int t = 0;
      for (; t < max_probes && h + t < S; ++t) {
        int cur = pk[h + t];
        if (cur == fp::EMPTY_KEY) cur = atomicCAS(pk + h + t, fp::EMPTY_KEY, k);
        if (cur == fp::EMPTY_KEY || cur == k) {
          acc = pv + (h + t) * V;
          break;
        }
      }
      if (acc == nullptr && t < max_probes) {  // the chain ran off the slice's end
        const int o = atomicAdd(ov_count, 1);
        ov_keys[o] = k;
        ov_t[o] = t;
        acc = ov_vals + (long long)o * V;
        store = true;
      }  // else dropped past max_probes, as the reference drops it
    }
    fold_add<VC>(peers, live ? sv + i * V : nullptr, V, acc, store);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < S; t += SLICE_BLOCK) tkeys[first + t] = pk[t];
  for (int t = threadIdx.x; t < S * V; t += SLICE_BLOCK) tvals[first * V + t] = pv[t];
}

// The overflow list: each key claims in the written table from the probe it
// reached (the next slice's first slot), within the remaining max_probes.
__global__ void __launch_bounds__(BLOCK)
overflow_kernel(const int* __restrict__ ov_count, const int* __restrict__ ov_keys, const int* __restrict__ ov_t,
                const float* __restrict__ ov_vals, int* tkeys, float* tvals, int C, int V, int max_probes) {
  const int m = *ov_count;
  for (int o = blockIdx.x * BLOCK + threadIdx.x; o < m; o += gridDim.x * BLOCK) {
    const int s = fp::acc_slot<0>(tkeys, C, ov_keys[o], max_probes, ov_t[o]);
    if (s < 0) continue;
    for (int j = 0; j < V; ++j) atomicAdd(tvals + (long long)s * V + j, ov_vals[(long long)o * V + j]);
  }
}

// blocks of kernel k resident at once with smem bytes of dynamic shared memory
template <typename K>
cudaError_t resident(K k, size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, BLOCK, smem);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return e;
}

template <int VC>
int launch(void** ptrs, long long* ints, cudaStream_t st) {
  const long long n = ints[0];
  const int C = (int)ints[1], V = (int)ints[2], max_probes = (int)ints[3], path = (int)ints[4];
  const long long want = ints[5];
  const int* ks = (const int*)ptrs[0];
  const float* vs = (const float*)ptrs[1];
  const bool* valid = (const bool*)ptrs[2];
  int* tkeys = (int*)ptrs[3];
  float* tvals = (float*)ptrs[4];
  cudaError_t e;
  int res = 0;
  if (path == 0) {  // global
    if ((e = resident(global_kernel<VC>, 0, &res)) != cudaSuccess) return (int)e;
    const unsigned grid = (unsigned)(want < res ? want : res);
    global_kernel<VC><<<grid, BLOCK, 0, st>>>(ks, vs, valid, tkeys, tvals, n, C, V, max_probes);
    return (int)cudaGetLastError();
  }
  if (path == 1) {  // private
    const size_t smem = (size_t)C * (1 + V) * 4;
    if ((e = resident(private_kernel<VC>, smem, &res)) != cudaSuccess) return (int)e;
    const unsigned grid = (unsigned)(want < res ? want : res);
    private_kernel<VC><<<grid, BLOCK, smem, st>>>(ks, vs, valid, tkeys, tvals, n, C, V, max_probes);
    return (int)cudaGetLastError();
  }
  // partitioned: ptrs continue with counts (zeroed, nslices + 1: the last is
  // the overflow count), offs, cursor, sk, sv, ov_keys, ov_t, ov_vals
  const int shift = (int)ints[6];
  const int S = 1 << shift, nslices = C / S;
  int* counts = (int*)ptrs[5];
  int* offs = (int*)ptrs[6];
  int* cursor = (int*)ptrs[7];
  int* sk = (int*)ptrs[8];
  float* sv = (float*)ptrs[9];
  int* ov_keys = (int*)ptrs[10];
  int* ov_t = (int*)ptrs[11];
  float* ov_vals = (float*)ptrs[12];
  const unsigned tiles = (unsigned)((n + ROWS - 1) / ROWS);
  const size_t hist = (size_t)nslices * 4;
  if ((e = cudaFuncSetAttribute(count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)hist)) != cudaSuccess)
    return (int)e;
  count_kernel<<<tiles, BLOCK, hist, st>>>(ks, valid, n, C, shift, nslices, counts);
  scan_kernel<<<1, 1024, 0, st>>>(counts, nslices, offs, cursor);
  if ((e = cudaFuncSetAttribute(scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(2 * hist))) !=
      cudaSuccess)
    return (int)e;
  scatter_kernel<<<tiles, BLOCK, 2 * hist, st>>>(ks, vs, valid, n, C, shift, nslices, V, cursor, sk, sv);
  const size_t smem = (size_t)S * (1 + V) * 4;
  if ((e = cudaFuncSetAttribute(slice_kernel<VC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return (int)e;
  slice_kernel<VC><<<nslices, SLICE_BLOCK, smem, st>>>(sk, sv, offs, C, S, V, max_probes, tkeys, tvals,
                                                  counts + nslices, ov_keys, ov_t, ov_vals);
  overflow_kernel<<<OVERFLOW_GRID, BLOCK, 0, st>>>(counts + nslices, ov_keys, ov_t, ov_vals, tkeys, tvals, C, V,
                                                    max_probes);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: keys, vals, valid (or null), table keys, table vals, [partitioned:
// scratch as launch() lists it]; ints: n, C, V, max_probes, path (0 global,
// 1 private, 2 partitioned), blocks wanted, [partitioned: log2 S]
extern "C" int hash_build_launch(void** ptrs, long long* ints, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return ints[2] == 1 ? launch<1>(ptrs, ints, st) : launch<4>(ptrs, ints, st);
}
