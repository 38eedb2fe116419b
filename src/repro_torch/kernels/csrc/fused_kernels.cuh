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
// The terminal is the hot spot: a dictionary terminal claims accumulator
// slots with atomicCAS and combines lanes with atomicAdd (sum) or CAS loops
// on the float bit pattern (min/max); a scalar Reduce combines per thread,
// then per warp (shuffles), then per block (shared memory), and issues one
// atomic per lane per block.  A small accumulator (PRIV) combines each row
// into the block's shared copy and adds the block's partials to device
// memory once at the end: with a few groups over tens of millions of rows,
// one float32 atomicAdd per row into a slot whose sum has grown to 1e9
// rounds away most of each addend (Q1 at TPC-H SF 10 drifted by 0.4 %).
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

template <int KIND>
__global__ void __launch_bounds__(256) fp_dict_kernel(Args a, int* out_keys, float* out_vals,
                                                      int cap, int max_probes) {
  extern __shared__ float priv[];  // [cap * NV] when PRIV
  if (PRIV) {
    for (int t = threadIdx.x; t < cap * NV; t += blockDim.x) priv[t] = fp::ident(lane_op(t % NV));
    __syncthreads();
  }
  float* acc = PRIV ? priv : out_vals;
  const fp::Part none{0, nullptr, nullptr};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    int key;
    float v[NV];
    if (!row(a, i, key, v, none)) continue;
    const int s = fp::acc_slot<KIND>(out_keys, cap, key, max_probes);
    if (s < 0) continue;
#pragma unroll
    for (int j = 0; j < NV; ++j) fp::atomic_combine(lane_op(j), acc + (long long)s * NV + j, v[j]);
  }
  if (PRIV) {
    __syncthreads();
    for (int t = threadIdx.x; t < cap * NV; t += blockDim.x) {
      const int op = lane_op(t % NV);
      if (priv[t] != fp::ident(op)) fp::atomic_combine(op, out_vals + t, priv[t]);
    }
  }
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

// Dynamic shared memory: [PRIV value lanes (cap * NV floats)] [staged slab]
template <int KIND, bool STAGE, bool PART_TERM>
__global__ void __launch_bounds__(256) fp_radix_dict_kernel(Args a, const int* tile_part, long long n_tiles,
                                                            int tiles_per_cta, int* out_keys, float* out_vals,
                                                            int cap, int max_probes) {
  extern __shared__ float smem[];
  constexpr bool P_ACC = PRIV && !PART_TERM;
  float* priv = smem;
  int* slab = reinterpret_cast<int*>(smem + (P_ACC ? cap * NV : 0));
  if (P_ACC) {
    for (int t = threadIdx.x; t < cap * NV; t += blockDim.x) priv[t] = fp::ident(lane_op(t % NV));
    __syncthreads();
  }
  fp::Part pt{-1, nullptr, nullptr};
  const long long t0 = (long long)blockIdx.x * tiles_per_cta;
  const long long t1 = min(t0 + tiles_per_cta, n_tiles);
  for (long long t = t0; t < t1; ++t) {
    const int p = tile_part[t];
    if (p != pt.p) enter_part<STAGE>(a, p, pt, slab);
    int* keys = PART_TERM ? out_keys + (long long)p * cap : out_keys;
    float* acc = PART_TERM ? out_vals + (long long)p * cap * NV : (P_ACC ? priv : out_vals);
    for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
      int key;
      float v[NV];
      if (!row(a, t * TILE + r, key, v, pt)) continue;
      const int s = fp::acc_slot<KIND>(keys, cap, key, max_probes);
      if (s < 0) continue;
#pragma unroll
      for (int j = 0; j < NV; ++j) fp::atomic_combine(lane_op(j), acc + (long long)s * NV + j, v[j]);
    }
  }
  if (P_ACC) {
    __syncthreads();
    for (int t = threadIdx.x; t < cap * NV; t += blockDim.x) {
      const int op = lane_op(t % NV);
      if (priv[t] != fp::ident(op)) fp::atomic_combine(op, out_vals + t, priv[t]);
    }
  }
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
