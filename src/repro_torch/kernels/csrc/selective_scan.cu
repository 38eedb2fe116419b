// Selective scan: the time recurrence of a Mamba layer, on Hopper.
//
// Replaces no pallas_call: the reference scans time with lax.scan, one token
// a step (repro/models/mamba.py:65-97), one compiled loop on the TPU.  Each
// step, for every (batch row b, channel c) and state lane n < ds:
//
//   h[n] = exp(dt·A[c][n])·h[n] + (dt·x)·B[t][n]      y[b][t][c] = Σ_n h[n]·C[t][n]
//
// with exp(dt·A), dt·x and (dt·x)·B rounded to the input dtype where the
// reference's operands in that dtype round them (mamba.py:83-84), and h and
// the sum in float32.
//
// What bounds it on an H100: at jamba's width (B = 1, T = 8,192, d_in =
// 16,384, ds = 16) the bytes are 2 × 268 MB of bf16 x and dt in and 537 MB
// of float32 y out, about 0.3 ms at 3.35 TB/s; the work is ds exponentials
// and a few FMAs a lane a step, on a chain that is sequential in t.  This
// first design is simple and right, not fast:
//
// * one thread a (b, channel) keeps its h[ds] and its row of A in registers
//   (ds a template parameter: 4, 8 or 16);
// * a block of 128 channels of one batch row walks time in tiles of 32
//   steps: the tile's B and C rows (shared by every channel of the row) and
//   the block's dt and x columns are staged in shared memory, loaded with
//   consecutive threads on consecutive channels, and y is stored the same
//   way;
// * B = 1 at full width gives 128 blocks for 132 SMs, 4 warps an SM: the
//   chain's latency is not hidden (PERF.md records the time).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;  // channels a block (kernels/selective_scan.py: BLOCK)
constexpr int TILE = 32;    // time steps staged at once (kernels/selective_scan.py: TILE)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// the value rounded to T (identity for float32)
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <int DS, typename T>
__global__ void __launch_bounds__(BLOCK) selective_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ h0, float* __restrict__ y, float* __restrict__ hT,
    int n_t, int d_in) {
  __shared__ float s_b[TILE][DS];
  __shared__ float s_c[TILE][DS];
  __shared__ float s_dt[TILE][BLOCK];
  __shared__ float s_x[TILE][BLOCK];

  const int b = blockIdx.y;
  const int ch = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = ch < d_in;
  float a[DS], h[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    a[n] = live ? A[(size_t)ch * DS + n] : 0.f;
    h[n] = (live && h0 != nullptr) ? h0[((size_t)b * d_in + ch) * DS + n] : 0.f;
  }
  const size_t row = (size_t)b * n_t;  // this batch row's first step

  for (int t0 = 0; t0 < n_t; t0 += TILE) {
    const int nt = min(TILE, n_t - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * DS; i += BLOCK) {
      const size_t off = (row + t0) * DS + i;
      s_b[i / DS][i % DS] = to_f(Bm[off]);
      s_c[i / DS][i % DS] = to_f(Cm[off]);
    }
    if (live) {
      for (int j = 0; j < nt; ++j) {
        const size_t off = (row + t0 + j) * d_in + ch;
        s_dt[j][threadIdx.x] = to_f(dt[off]);
        s_x[j][threadIdx.x] = to_f(x[off]);
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nt; ++j) {
      const float d = s_dt[j][threadIdx.x];
      const float dx = rnd<T>(d * s_x[j][threadIdx.x]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < DS; ++n) {
        const float da = rnd<T>(expf(rnd<T>(d * a[n])));
        const float u = rnd<T>(dx * s_b[j][n]);
        h[n] = da * h[n] + u;
        acc += h[n] * s_c[j][n];
      }
      y[(row + t0 + j) * d_in + ch] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < DS; ++n) hT[((size_t)b * d_in + ch) * DS + n] = h[n];
  }
}

template <int DS, typename T>
void launch(void** p, int n_b, int n_t, int d_in, cudaStream_t st) {
  const dim3 grid((d_in + BLOCK - 1) / BLOCK, n_b);
  selective_scan_kernel<DS, T><<<grid, BLOCK, 0, st>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
      static_cast<const T*>(p[3]), static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<float*>(p[6]), static_cast<float*>(p[7]), n_t, d_in);
}

template <typename T>
int launch_ds(void** p, int n_b, int n_t, int d_in, int ds, cudaStream_t st) {
  switch (ds) {
    case 4: launch<4, T>(p, n_b, n_t, d_in, st); break;
    case 8: launch<8, T>(p, n_b, n_t, d_in, st); break;
    case 16: launch<16, T>(p, n_b, n_t, d_in, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// ptrs: x, dt, B, C, A, h0 (or null), y, h_T; ints: B, T, d_in, ds, dtype (0 bf16, 1 float32)
extern "C" int selective_scan_launch(void** ptrs, long long* ints, void* stream) {
  const int n_b = (int)ints[0], n_t = (int)ints[1], d_in = (int)ints[2], ds = (int)ints[3];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_b == 0 || d_in == 0) return 0;
  const int err = ints[4] == 0 ? launch_ds<__nv_bfloat16>(ptrs, n_b, n_t, d_in, ds, st)
                               : launch_ds<float>(ptrs, n_b, n_t, d_in, ds, st);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
