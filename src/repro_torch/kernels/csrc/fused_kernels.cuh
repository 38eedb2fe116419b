// The fused-pipeline kernels.  The generated region source defines, before
// including this file: `struct Args` (with a `long long n` row count),
// `constexpr int NV` (value lanes), `__device__ int lane_op(int j)` (0 sum,
// 1 min, 2 max) and `__device__ bool row(const Args&, long long i, int& key,
// float* v, const fp::Part& pt)`, which evaluates one row of the region and
// returns its liveness (`pt` is the radix tile's partition; unused
// otherwise).
//
// It also defines `constexpr bool PRIV`: whether the block keeps a private
// copy of the accumulator's value lanes in dynamic shared memory; and
// `constexpr int RD`: the radix-partitioned dictionary (-1 when none).
//
// The terminal is the hot spot.  A dictionary terminal claims accumulator
// slots and combines lanes as claim_table.cuh does it: each warp first folds
// its live rows by key (__match_any_sync, shuffles), so one lane a distinct
// key claims its slot and combines its NV lanes once (atomicAdd for sum,
// CAS loops on the float bit pattern for min/max).  A small accumulator
// (PRIV: capacity x lanes <= PRIV_FLOATS) is claimed first in a
// block-private table in shared memory, keys beside the value lanes in the
// accumulator's own probe layout; a key whose private chain runs past
// max_probes goes straight to the accumulator in device memory.  At the end
// each block flushes its occupied private slots: one claim and NV atomics a
// key.  The grid is the blocks resident at once, so each block's
// initialization and flush are paid over many rows.  Q1 folds four groups
// over millions of rows; with one float32 atomicAdd a row into a slot whose
// sum has grown to 1e9, most of each addend rounds away (Q1 at TPC-H SF 10
// drifted by 0.4 %), and the block's partial sums keep that error small.
// A scalar Reduce combines per thread, then per warp (shuffles), then per
// block (shared memory), and issues one atomic per lane per block.
//
// Radix mode (the reference's grid over routed tiles, each step co-resident
// with the one dictionary block its rows probe): block b walks the tiles
// [b * tiles_per_cta, (b + 1) * tiles_per_cta) of the routed stream, reads
// each tile's partition id once and, when STAGE, copies that partition's
// key slab (and st_blocked directory) into shared memory whenever the id
// changes (ids are nondecreasing, so a block restages at most once per
// partition it meets).  Without STAGE the block reads the slab in device
// memory through L2.  With a partitioned terminal a row claims its slot in
// its partition's [cap] slice of the [P, cap] accumulator; several blocks
// share a partition, so claims and sums stay atomic.
#pragma once
#include "fused_pipeline.cuh"

constexpr int TILE = 1024;  // rows a radix tile holds (kernels/fused_pipeline.py: ROW_BLOCK)

// One row a lane into the terminal: the warp folds its live rows by key and
// each group's leader claims and combines once, in the block's private
// table (pkeys / pvals, when P) unless its chain there runs past
// max_probes, else in the accumulator (keys / vals).  Every lane of the
// warp calls it.
template <int KIND, bool P>
__device__ __forceinline__ void accumulate(bool live, int key, float (&v)[NV], int* keys, float* vals, int cap,
                                           int max_probes, int* pkeys, float* pvals) {
  const unsigned live_lanes = __ballot_sync(fp::FULL_WARP, live);
  if (live_lanes == 0) return;  // no row of the warp reaches the terminal
  const unsigned peers = fp::warp_peers(live_lanes, live, key);
  fp::warp_fold(peers, v, [](int j) { return lane_op(j); });
  if (!live || !fp::leads(peers)) return;
  float* acc = nullptr;
  if (P) {
    const int s = fp::acc_slot<KIND>(pkeys, cap, key, max_probes);
    if (s >= 0) acc = pvals + s * NV;
  }
  if (acc == nullptr) {
    const int s = fp::acc_slot<KIND>(keys, cap, key, max_probes);
    if (s < 0) return;  // dropped past max_probes, as the reference drops it
    acc = vals + (long long)s * NV;
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) fp::atomic_combine(lane_op(j), acc + j, v[j]);
}

// the private table: EMPTY keys, lane identities
__device__ __forceinline__ void priv_init(int* pkeys, float* pvals, int cap) {
  for (int t = threadIdx.x; t < cap * NV; t += blockDim.x) pvals[t] = fp::ident(lane_op(t % NV));
  for (int t = threadIdx.x; t < cap; t += blockDim.x) pkeys[t] = fp::EMPTY_KEY;
  __syncthreads();
}

// each occupied private slot into the accumulator: one claim, NV combines
template <int KIND>
__device__ __forceinline__ void priv_flush(const int* pkeys, const float* pvals, int* keys, float* vals, int cap,
                                           int max_probes) {
  __syncthreads();
  for (int t = threadIdx.x; t < cap; t += blockDim.x) {
    const int k = pkeys[t];
    if (k == fp::EMPTY_KEY) continue;
    const int s = fp::acc_slot<KIND>(keys, cap, k, max_probes);
    if (s < 0) continue;
#pragma unroll
    for (int j = 0; j < NV; ++j) fp::atomic_combine(lane_op(j), vals + (long long)s * NV + j, pvals[t * NV + j]);
  }
}

// Dynamic shared memory: PRIV: [cap * NV value lanes] [cap keys]
template <int KIND>
__global__ void __launch_bounds__(256) fp_dict_kernel(Args a, int* out_keys, float* out_vals,
                                                      int cap, int max_probes) {
  extern __shared__ float priv[];
  int* pkeys = reinterpret_cast<int*>(priv + cap * NV);
  if (PRIV) priv_init(pkeys, priv, cap);
  const fp::Part none{0, nullptr, nullptr};
  const int lane = fp::lane_id();
  const long long stride = (long long)gridDim.x * blockDim.x;
  // a warp takes 32 consecutive rows a step; the loop's bound is the warp's
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x - lane; w < a.n; w += stride) {
    const long long i = w + lane;
    int key = 0;
    float v[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] = 0.0f;
    const bool live = i < a.n && row(a, i, key, v, none);
    accumulate<KIND, PRIV>(live, key, v, out_keys, out_vals, cap, max_probes, pkeys, priv);
  }
  if (PRIV) priv_flush<KIND>(pkeys, priv, out_keys, out_vals, cap, max_probes);
}

// per-thread partials -> warp -> block -> one atomic per lane
__device__ __forceinline__ void block_combine(float* acc, float* out) {
  __shared__ float part[8][NV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float x = acc[j];
    for (int off = 16; off; off >>= 1) x = fp::combine(lane_op(j), x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) part[warp][j] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float x = lane < (int)(blockDim.x >> 5) ? part[lane][j] : fp::ident(lane_op(j));
      for (int off = 16; off; off >>= 1) x = fp::combine(lane_op(j), x, __shfl_down_sync(0xffffffffu, x, off));
      if (lane == 0) fp::atomic_combine(lane_op(j), out + j, x);
    }
  }
}

__global__ void __launch_bounds__(256) fp_sum_kernel(Args a, float* out) {
  float acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = fp::ident(lane_op(j));
  const fp::Part none{0, nullptr, nullptr};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    int key;
    float v[NV];
    if (!row(a, i, key, v, none)) continue;
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = fp::combine(lane_op(j), acc[j], v[j]);
  }
  block_combine(acc, out);
}

// Move to partition p of dictionary RD: point pt at its block, staging the
// block in shared memory first when STAGE.  Every thread of the block calls
// it with the same p.
template <bool STAGE>
__device__ __forceinline__ void enter_part(const Args& a, int p, fp::Part& pt, int* slab) {
  const fp::Dict& d = a.dict[RD < 0 ? 0 : RD];  // RD >= 0 wherever this is instantiated
  const int* keys = d.keys + (long long)p * d.lp;
  const int* bm = d.bm + (long long)p * d.nbp;
  pt.p = p;
  if (STAGE) {
    __syncthreads();  // every thread is done with the previous block
    for (int j = threadIdx.x; j < d.lp; j += blockDim.x) slab[j] = keys[j];
    for (int j = threadIdx.x; j < d.nbp; j += blockDim.x) slab[d.lp + j] = bm[j];
    __syncthreads();
    pt.keys = slab;
    pt.bm = slab + d.lp;
  } else {
    pt.keys = keys;
    pt.bm = bm;
  }
}

// Dynamic shared memory: [PRIV: cap * NV value lanes, cap keys] [staged slab]
template <int KIND, bool STAGE, bool PART_TERM>
__global__ void __launch_bounds__(256) fp_radix_dict_kernel(Args a, const int* tile_part, long long n_tiles,
                                                            int tiles_per_cta, int* out_keys, float* out_vals,
                                                            int cap, int max_probes) {
  extern __shared__ float smem[];
  constexpr bool P_ACC = PRIV && !PART_TERM;
  float* priv = smem;
  int* pkeys = reinterpret_cast<int*>(smem + (P_ACC ? cap * NV : 0));
  int* slab = pkeys + (P_ACC ? cap : 0);
  if (P_ACC) priv_init(pkeys, priv, cap);
  fp::Part pt{-1, nullptr, nullptr};
  const long long t0 = (long long)blockIdx.x * tiles_per_cta;
  const long long t1 = min(t0 + tiles_per_cta, n_tiles);
  for (long long t = t0; t < t1; ++t) {
    const int p = tile_part[t];
    if (p != pt.p) enter_part<STAGE>(a, p, pt, slab);
    int* keys = PART_TERM ? out_keys + (long long)p * cap : out_keys;
    float* vals = PART_TERM ? out_vals + (long long)p * cap * NV : out_vals;
    for (int r = threadIdx.x; r < TILE; r += blockDim.x) {  // TILE is a multiple of the block: warps stay whole
      int key = 0;
      float v[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) v[j] = 0.0f;
      const bool live = row(a, t * TILE + r, key, v, pt);
      accumulate<KIND, P_ACC>(live, key, v, keys, vals, cap, max_probes, pkeys, priv);
    }
  }
  if (P_ACC) priv_flush<KIND>(pkeys, priv, out_keys, out_vals, cap, max_probes);
}

template <bool STAGE>
__global__ void __launch_bounds__(256) fp_radix_sum_kernel(Args a, const int* tile_part, long long n_tiles,
                                                           int tiles_per_cta, float* out) {
  extern __shared__ float smem[];
  int* slab = reinterpret_cast<int*>(smem);
  float acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = fp::ident(lane_op(j));
  fp::Part pt{-1, nullptr, nullptr};
  const long long t0 = (long long)blockIdx.x * tiles_per_cta;
  const long long t1 = min(t0 + tiles_per_cta, n_tiles);
  for (long long t = t0; t < t1; ++t) {
    const int p = tile_part[t];
    if (p != pt.p) enter_part<STAGE>(a, p, pt, slab);
    for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
      int key;
      float v[NV];
      if (!row(a, t * TILE + r, key, v, pt)) continue;
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[j] = fp::combine(lane_op(j), acc[j], v[j]);
    }
  }
  block_combine(acc, out);
}
