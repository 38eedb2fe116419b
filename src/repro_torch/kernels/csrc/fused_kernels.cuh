// The fused-pipeline kernels.  The generated region source defines, before
// including this file: `struct Args` (with a `long long n` row count),
// `constexpr int NV` (value lanes), `__device__ int lane_op(int j)` (0 sum,
// 1 min, 2 max) and `__device__ bool row(const Args&, long long i, int& key,
// float* v)`, which evaluates one row of the region and returns its liveness.
//
// It also defines `constexpr bool PRIV`: whether the block keeps a private
// copy of the accumulator's value lanes in dynamic shared memory.
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
#pragma once
#include "fused_pipeline.cuh"

template <int KIND>
__global__ void __launch_bounds__(256) fp_dict_kernel(Args a, int* out_keys, float* out_vals,
                                                      int cap, int max_probes) {
  extern __shared__ float priv[];  // [cap * NV] when PRIV
  if (PRIV) {
    for (int t = threadIdx.x; t < cap * NV; t += blockDim.x) priv[t] = fp::ident(lane_op(t % NV));
    __syncthreads();
  }
  float* acc = PRIV ? priv : out_vals;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    int key;
    float v[NV];
    if (!row(a, i, key, v)) continue;
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

__global__ void __launch_bounds__(256) fp_sum_kernel(Args a, float* out) {
  float acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = fp::ident(lane_op(j));
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    int key;
    float v[NV];
    if (!row(a, i, key, v)) continue;
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = fp::combine(lane_op(j), acc[j], v[j]);
  }
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

