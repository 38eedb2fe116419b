// Selective scan, backward: the gradients of the Mamba scan of
// selective_scan.cu, on Hopper.
//
// Replaces no pallas_call: the reference trains the scan by JAX autodiff
// through its lax.scan over time (repro/models/mamba.py:95).  With, for
// every (batch row b, channel c) and state lane n < ds,
//
//   a_t = rnd(exp(z_t)), z_t = rnd(dt_t·A[c][n]),  v_t = rnd(dt_t·x_t),  u_t = rnd(v_t·B_t[n])
//   h_t = a_t·h_{t-1} + u_t                           y_t[c] = Σ_n h_t[n]·C_t[n]
//
// (rnd: rounding to the streams' dtype, as the forward and its twin round),
// the walk runs from t = T-1 down to 0 with g = dL/dh carried from dh_T:
//
//   g      = dy_t[c]·C_t[n] + g                       dL/dh_t
//   dC_t  += Σ_c dy_t[c]·h_t[n]                       dB_t += Σ_c rnd(g)·v_t
//   dv     = rnd(Σ_n rnd(g)·B_t[n])                   dx_t = rnd(dv·dt_t)
//   dz     = rnd(rnd(g·h_{t-1})·exp(z_t))             dA   += Σ_{b,t} dz·dt_t
//   ddt_t  = rnd(Σ_n dz·A[c][n] + dv·x_t)             g    = g·a_t    (after t = 0: dh0)
//
// Each gradient is rounded where the twin's autograd rounds it (at every
// cast of the forward), so in float32 the two differ in summation order
// only.  Elementwise products and sums are written with __fmul_rn /
// __fadd_rn, as autograd forms them, so that no contraction moves a value
// that is rounded next.
//
// h at each step: the first pass walks the scan forward and writes h at the
// start of every CHUNK steps (float32, 16 steps apart; at jamba's width, B =
// 1, T = 8,192, d_in = 16,384, ds = 16, 512 × 16,384 × 16 × 4 B = 537 MB of
// scratch); the second walks the chunks from the last, recomputes the
// chunk's 16 states into registers from its checkpoint and walks them back.
// The first pass is this kernel's own and not the forward's: the forward
// kernel (the inference path) stays as it is and writes
// nothing more, and the backward takes only the forward's inputs and the
// output gradients, so it is held against its twin on the same inputs.  It
// costs one more pass of the exponentials (three a lane-step in all).
// Chunks of 16 and not the forward's 32-step tiles: 17 states of 4 lanes
// are 68 registers a thread, which keeps two 256-thread blocks an SM.
//
// What bounds it on an H100 at jamba's width: bytes, x, dt, dx and ddt at
// 268 MB each in bf16 and dy at 537 MB of float32, 1.61 GB, 0.48 ms at 3.35
// TB/s; exponentials, 2.15·10⁹ lane-steps, 0.51 ms of SFU at one a
// lane-step.  This first design recomputes: three exponentials and about
// sixty other instructions a lane-step, issue-bound as the forward is.
//
// The thread map is the forward's: G = ds/4 threads a (b, channel), each
// holding 4 state lanes; warp w holds lanes (w % G)·4 .. of 32 consecutive
// channels; blocks of BLOCK channels of one batch row.  The sums:
//
// * over the lanes of a channel (dv, Σ_n dz·A): each thread's 4 lanes in
//   registers, the G threads' partials in shared memory, added in lane
//   order after the chunk;
// * over the channels (dB, dC): each step's 8 values a thread (dB and dC of
//   its 4 lanes) summed over the warp's 32 channels by five exchanges
//   (warp_sum8), the block's two warps of channels added in order after
//   the chunk, then each block's partial written to pB / pC and the blocks
//   added in block order by a second launch (selective_scan_bwd_sum_kernel);
// * dA over (b, t): in registers over t, the batch rows added in row order
//   by the second launch.
//
// No atomics: every sum has one order, so two launches on the same inputs
// give bitwise-equal gradients.  The wrapper pads d_in to a multiple of 8
// channels with zero inputs, A, h0, dy and dh_T, whose gradients are zero
// and cut off.  Launch geometry: kernels/selective_scan.py,
// launch_geometry (the forward's).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int STATES = 4;           // state lanes a thread (kernels/selective_scan.py: STATES)
constexpr int BLOCK = 64;           // channels a block (kernels/selective_scan.py: BLOCK)
constexpr int CHUNK = 16;           // steps between checkpoints (kernels/selective_scan.py: BWD_TILE)
constexpr int ALIGN = 8;            // the width's multiple (kernels/selective_scan.py: ALIGN)
constexpr int GROUPS = BLOCK / 32;  // warps of channels holding one set of lanes
constexpr int MIN_BLOCKS = 2;       // blocks an SM the walk's registers are budgeted for
constexpr int SUM_THREADS = 256;    // threads a block of the summing launch
constexpr int SUM_BLOCKS = 4096;    // its most blocks (a grid-stride loop)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __float2bfloat16_rn(v);
}

// the value rounded to T (identity for float32)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// exp(dt·A) of one lane as the forward forms it, unrounded (e) and rounded
// to T (a): bf16 rounds the argument and takes CUDA's expf, float32 takes
// ex2.approx of dt·(A·log2 e) (``an`` is A·log2 e there)
template <typename T>
__device__ __forceinline__ void decay(float d, float an, float& e, float& a) {
  if constexpr (std::is_same<T, float>::value) {
    e = ex2(d * an);
    a = e;
  } else {
    e = expf(rnd<T>(d * an));
    a = rnd<T>(e);
  }
}

// The warp's sums of 8 values a lane: after five exchanges lane L holds the
// sum over the 32 lanes of value (L >> 2) & 7 (the four lanes L & ~3 ..
// L | 3 hold the same).  Each of the first three exchanges halves the values
// a lane carries; every sum is formed in one fixed order.
__device__ __forceinline__ float warp_sum8(const float (&v)[8], int lane) {
  constexpr unsigned FULL = 0xffffffffu;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float r[4], s[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)  // r[i]: value i + 4·b4 over lanes L, L ^ 16
    r[i] = (b4 ? v[i + 4] : v[i]) + __shfl_xor_sync(FULL, b4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)  // s[i]: value i + 2·b3 + 4·b4 over 4 lanes
    s[i] = (b3 ? r[i + 2] : r[i]) + __shfl_xor_sync(FULL, b3 ? r[i] : r[i + 2], 8);
  float q = (b2 ? s[1] : s[0]) + __shfl_xor_sync(FULL, b2 ? s[0] : s[1], 4);  // over 8 lanes
  q += __shfl_xor_sync(FULL, q, 2);
  q += __shfl_xor_sync(FULL, q, 1);
  return q;
}

template <int DS>
constexpr size_t smem_bytes() {
  return (4 * CHUNK * BLOCK                    // dt, rnd(dt·x), x and dy of a chunk
          + 2 * CHUNK * DS                     // B and C
          + 2 * (DS / STATES) * CHUNK * BLOCK  // each thread's Σ over its lanes of rnd(g)·B and dz·A
          + CHUNK * GROUPS * 2 * DS)           // each warp's Σ over its channels of dB and dC
         * sizeof(float);
}

template <int DS, typename T>
__global__ void __launch_bounds__(BLOCK * DS / STATES, MIN_BLOCKS) selective_scan_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ h0, const float* __restrict__ dy,
    const float* __restrict__ dhT, float* __restrict__ ck, T* __restrict__ dx, T* __restrict__ ddt,
    float* __restrict__ pB, float* __restrict__ pC, float* __restrict__ pA, float* __restrict__ dh0, int n_t,
    int d) {
  static_assert(STATES == 4 && DS % STATES == 0 && BLOCK % 32 == 0, "4 lanes a thread, whole warps of channels");
  constexpr int G = DS / STATES;  // threads a channel
  constexpr int NT = BLOCK * G;   // threads a block
  extern __shared__ __align__(16) float sm[];
  float* s_d = sm;                          // [CHUNK][BLOCK] dt
  float* s_v = s_d + CHUNK * BLOCK;         // [CHUNK][BLOCK] rnd(dt·x)
  float* s_x = s_v + CHUNK * BLOCK;         // [CHUNK][BLOCK] x
  float* s_dy = s_x + CHUNK * BLOCK;        // [CHUNK][BLOCK] dy
  float* s_b = s_dy + CHUNK * BLOCK;        // [CHUNK][DS]
  float* s_c = s_b + CHUNK * DS;            // [CHUNK][DS]
  float* s_pv = s_c + CHUNK * DS;           // [G][CHUNK][BLOCK]
  float* s_pa = s_pv + G * CHUNK * BLOCK;   // [G][CHUNK][BLOCK]
  float* s_red = s_pa + G * CHUNK * BLOCK;  // [CHUNK][GROUPS][2·DS]: dB's DS lanes, then dC's

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = warp % G, grp = warp / G, c = lane + 32 * grp;
  const int ch0 = blockIdx.x * BLOCK, ch = ch0 + c, b = blockIdx.y;
  const bool live = ch < d;
  const size_t row0 = (size_t)b * n_t;                             // this batch row's first step
  const size_t state0 = ((size_t)b * d + ch) * DS + g * STATES;    // this thread's lanes in [B][d][DS]
  const int n_ck = (n_t + CHUNK - 1) / CHUNK;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto ck_at = [&](int k) { return ck + (((size_t)b * n_ck + k) * d + ch) * DS + g * STATES; };

  // a chunk's inputs, widened, zero past n_t and past d
  auto stage = [&](int t0, int nt, bool back) {
    for (int i = tid; i < CHUNK * BLOCK; i += NT) {
      const int r = i / BLOCK, cc = ch0 + i % BLOCK;
      const bool in = r < nt && cc < d;
      const size_t off = in ? (row0 + t0 + r) * d + cc : 0;
      const float dv = in ? to_f(dt[off]) : 0.f, xv = in ? to_f(x[off]) : 0.f;
      s_d[i] = dv;
      s_v[i] = rnd<T>(dv * xv);
      if (back) {
        s_x[i] = xv;
        s_dy[i] = in ? dy[off] : 0.f;
      }
    }
    for (int i = tid; i < CHUNK * DS; i += NT) {
      const bool in = i / DS < nt;
      const size_t off = in ? (row0 + t0) * DS + i : 0;
      s_b[i] = in ? to_f(Bm[off]) : 0.f;
      if (back) s_c[i] = in ? to_f(Cm[off]) : 0.f;
    }
  };

  float am[STATES], ae[STATES], h[STATES];
  {
    const float4 av = live ? *reinterpret_cast<const float4*>(A + (size_t)ch * DS + g * STATES) : zero;
    const float4 hv = (live && h0 != nullptr) ? *reinterpret_cast<const float4*>(h0 + state0) : zero;
    am[0] = av.x, am[1] = av.y, am[2] = av.z, am[3] = av.w;
    h[0] = hv.x, h[1] = hv.y, h[2] = hv.z, h[3] = hv.w;
#pragma unroll
    for (int n = 0; n < STATES; ++n) ae[n] = std::is_same<T, float>::value ? am[n] * LOG2E : am[n];
  }
  const float* bs = s_b + g * STATES;
  const float* cs = s_c + g * STATES;

  // pass 1: h at the start of every chunk
  for (int k = 0; k < n_ck; ++k) {
    if (live) *reinterpret_cast<float4*>(ck_at(k)) = make_float4(h[0], h[1], h[2], h[3]);
    if (k + 1 == n_ck) break;  // the last chunk's end state is not needed
    __syncthreads();           // the previous chunk is consumed
    stage(k * CHUNK, CHUNK, false);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < CHUNK; ++j) {
      const float dd = s_d[j * BLOCK + c], v = s_v[j * BLOCK + c];
      const float4 bv = *reinterpret_cast<const float4*>(bs + j * DS);
      const float bb[STATES] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int n = 0; n < STATES; ++n) {
        float e, a;
        decay<T>(dd, ae[n], e, a);
        h[n] = fmaf(a, h[n], rnd<T>(v * bb[n]));
      }
    }
  }

  // pass 2: the chunks from the last, each recomputed from its checkpoint
  // and walked back
  float gs[STATES], dA[STATES];
  {
    const float4 gv = (live && dhT != nullptr) ? *reinterpret_cast<const float4*>(dhT + state0) : zero;
    gs[0] = gv.x, gs[1] = gv.y, gs[2] = gv.z, gs[3] = gv.w;
#pragma unroll
    for (int n = 0; n < STATES; ++n) dA[n] = 0.f;
  }
  for (int k = n_ck - 1; k >= 0; --k) {
    const int t0 = k * CHUNK, nt = min(CHUNK, n_t - t0);
    __syncthreads();  // the previous chunk's sums have been read
    stage(t0, nt, true);
    float hs[CHUNK + 1][STATES];  // hs[j + 1]: h after the chunk's step j; hs[0] the checkpoint
    {
      const float4 hv = live ? *reinterpret_cast<const float4*>(ck_at(k)) : zero;
      hs[0][0] = hv.x, hs[0][1] = hv.y, hs[0][2] = hv.z, hs[0][3] = hv.w;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (j < nt) {
        const float dd = s_d[j * BLOCK + c], v = s_v[j * BLOCK + c];
        const float4 bv = *reinterpret_cast<const float4*>(bs + j * DS);
        const float bb[STATES] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int n = 0; n < STATES; ++n) {
          float e, a;
          decay<T>(dd, ae[n], e, a);
          hs[j + 1][n] = fmaf(a, hs[j][n], rnd<T>(v * bb[n]));
        }
      }
    }
#pragma unroll
    for (int j = CHUNK - 1; j >= 0; --j) {
      if (j < nt) {
        const float dd = s_d[j * BLOCK + c], v = s_v[j * BLOCK + c], gy = s_dy[j * BLOCK + c];
        const float4 bv = *reinterpret_cast<const float4*>(bs + j * DS);
        const float4 cv = *reinterpret_cast<const float4*>(cs + j * DS);
        const float bb[STATES] = {bv.x, bv.y, bv.z, bv.w}, cn[STATES] = {cv.x, cv.y, cv.z, cv.w};
        float vals[2 * STATES];  // dB's contributions of the 4 lanes, then dC's
        float pv = 0.f, pa = 0.f;
#pragma unroll
        for (int n = 0; n < STATES; ++n) {
          float e, a;
          decay<T>(dd, ae[n], e, a);
          const float gn = __fadd_rn(__fmul_rn(gy, cn[n]), gs[n]);  // dL/dh_t
          vals[STATES + n] = __fmul_rn(gy, hs[j + 1][n]);
          const float gu = rnd<T>(gn);  // dL/du_t
          vals[n] = __fmul_rn(gu, v);
          pv = fmaf(gu, bb[n], pv);
          const float dz = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(gn, hs[j][n])), e));  // dL/dz_t
          pa = fmaf(dz, am[n], pa);
          dA[n] = fmaf(dz, dd, dA[n]);
          gs[n] = __fmul_rn(gn, a);  // dL/dh_{t-1} from this step
        }
        s_pv[(g * CHUNK + j) * BLOCK + c] = pv;
        s_pa[(g * CHUNK + j) * BLOCK + c] = pa;
        const float q = warp_sum8(vals, lane);
        if ((lane & 3) == 0) {
          const int idx = (lane >> 2) & 7;
          s_red[(j * GROUPS + grp) * 2 * DS + (idx < STATES ? g * STATES + idx : DS + g * STATES + idx - STATES)] = q;
        }
      }
    }
    __syncthreads();  // the chunk's partial sums are in
    // dx and ddt: each channel's G partials added in lane order
    for (int i = tid; i < nt * BLOCK; i += NT) {
      const int j = i / BLOCK, q = i % BLOCK, cc = ch0 + q;
      float sv = s_pv[j * BLOCK + q], sa = s_pa[j * BLOCK + q];
#pragma unroll
      for (int gg = 1; gg < G; ++gg) {
        sv += s_pv[(gg * CHUNK + j) * BLOCK + q];
        sa += s_pa[(gg * CHUNK + j) * BLOCK + q];
      }
      const float dv = rnd<T>(sv);  // dL/d rnd(dt·x)
      if (cc < d) {
        const size_t off = (row0 + t0 + j) * d + cc;
        dx[off] = from_f<T>(__fmul_rn(dv, s_d[i]));
        ddt[off] = from_f<T>(__fadd_rn(sa, __fmul_rn(dv, s_x[i])));
      }
    }
    // the block's dB and dC over its channels: the warps of channels added in order
    for (int i = tid; i < nt * 2 * DS; i += NT) {
      const int j = i / (2 * DS), m = i % (2 * DS);
      float s = s_red[j * GROUPS * 2 * DS + m];
#pragma unroll
      for (int w = 1; w < GROUPS; ++w) s += s_red[(j * GROUPS + w) * 2 * DS + m];
      float* dst = m < DS ? pB : pC;
      dst[(((size_t)blockIdx.x * gridDim.y + b) * n_t + t0 + j) * DS + m % DS] = s;
    }
  }
  if (live) {
    if (dh0 != nullptr) *reinterpret_cast<float4*>(dh0 + state0) = make_float4(gs[0], gs[1], gs[2], gs[3]);
    *reinterpret_cast<float4*>(pA + state0) = make_float4(dA[0], dA[1], dA[2], dA[3]);
  }
}

// dB and dC: the blocks' partial sums added in block order and rounded to
// T; dA: the batch rows' partial sums added in row order (float32)
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS) selective_scan_bwd_sum_kernel(
    const float* __restrict__ pB, const float* __restrict__ pC, const float* __restrict__ pA, T* __restrict__ dB,
    T* __restrict__ dC, float* __restrict__ dA, int parts, long long n_bc, int n_b, long long n_a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < n_bc; i += stride) {
    float sb = 0.f, sc = 0.f;
    for (int p = 0; p < parts; ++p) {
      sb += pB[p * n_bc + i];
      sc += pC[p * n_bc + i];
    }
    dB[i] = from_f<T>(sb);
    dC[i] = from_f<T>(sc);
  }
  for (long long i = first; i < n_a; i += stride) {
    float s = 0.f;
    for (int r = 0; r < n_b; ++r) s += pA[r * n_a + i];
    dA[i] = s;
  }
}

template <int DS, typename T>
int launch(void** p, int n_b, int n_t, int d, int blocks_x, int threads, cudaStream_t st) {
  constexpr int NT = BLOCK * DS / STATES;
  if (threads != NT || blocks_x != (d + BLOCK - 1) / BLOCK || d % ALIGN != 0) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<DS>();
  cudaError_t e = cudaFuncSetAttribute(selective_scan_bwd_kernel<DS, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  selective_scan_bwd_kernel<DS, T><<<dim3(blocks_x, n_b), NT, smem, st>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
      static_cast<const T*>(p[3]), static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const float*>(p[6]), static_cast<const float*>(p[7]), static_cast<float*>(p[8]),
      static_cast<T*>(p[9]), static_cast<T*>(p[10]), static_cast<float*>(p[11]), static_cast<float*>(p[12]),
      static_cast<float*>(p[13]), static_cast<float*>(p[14]), n_t, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_bc = (long long)n_b * n_t * DS, n_a = (long long)d * DS;
  const long long most = n_bc > n_a ? n_bc : n_a;
  const long long want = (most + SUM_THREADS - 1) / SUM_THREADS;
  const int blocks = (int)(want < 1 ? 1 : (want > SUM_BLOCKS ? SUM_BLOCKS : want));
  selective_scan_bwd_sum_kernel<T><<<blocks, SUM_THREADS, 0, st>>>(
      static_cast<const float*>(p[11]), static_cast<const float*>(p[12]), static_cast<const float*>(p[13]),
      static_cast<T*>(p[15]), static_cast<T*>(p[16]), static_cast<float*>(p[17]), blocks_x, n_bc, n_b, n_a);
  return 0;
}

template <typename T>
int launch_ds(void** p, int n_b, int n_t, int d, int ds, int blocks_x, int threads, cudaStream_t st) {
  switch (ds) {
    case 4: return launch<4, T>(p, n_b, n_t, d, blocks_x, threads, st);
    case 8: return launch<8, T>(p, n_b, n_t, d, blocks_x, threads, st);
    case 16: return launch<16, T>(p, n_b, n_t, d, blocks_x, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ptrs: x, dt, B, C, A (float32), h0 (or null), dy (float32), dh_T (or
// null), the checkpoints [B][ceil(T / 16)][width][ds], dx, ddt, the block
// partials of dB and dC [blocks_x][B][T][ds] and of dA [B][width][ds], dh0
// (or null), dB, dC, dA [width][ds]; ints as selective_scan_launch's: B, T,
// width (d_in padded to a multiple of 8), ds, dtype (0 bf16, 1 float32),
// blocks along the channels, threads a block.  Two launches: the walk, then
// the fixed-order sums.
extern "C" int selective_scan_backward_launch(void** ptrs, long long* ints, void* stream) {
  const int n_b = (int)ints[0], n_t = (int)ints[1], d = (int)ints[2], ds = (int)ints[3];
  const int blocks_x = (int)ints[5], threads = (int)ints[6];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_b == 0 || d == 0) return 0;
  const int err = ints[4] == 0 ? launch_ds<__nv_bfloat16>(ptrs, n_b, n_t, d, ds, blocks_x, threads, st)
                               : launch_ds<float>(ptrs, n_b, n_t, d, ds, blocks_x, threads, st);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// the walk's dynamic shared memory a block at ds states (0 for another ds)
extern "C" int selective_scan_backward_smem(int ds) {
  switch (ds) {
    case 4: return (int)smem_bytes<4>();
    case 8: return (int)smem_bytes<8>();
    case 16: return (int)smem_bytes<16>();
    default: return 0;
  }
}
