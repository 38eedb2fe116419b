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
// of float32 y out, 0.32 ms at 3.35 TB/s; the work is 2.15·10⁹ lane-steps
// (T·d_in·ds), each an exponential on the SFU (16 a clock an SM: 0.51 ms at
// 1.98 GHz) and, in bf16, about eighteen instructions with the three
// roundings and the accurate expf: instruction issue, on a chain sequential
// in t.  The first design (one thread a channel, 4 warps an SM on 128 SMs)
// left the chain's latency unhidden.  This one:
//
// * G = ds/4 threads serve one (b, channel), each keeping 4 state lanes of h
//   and of A in registers.  Warp w holds lanes (w % G)·4 .. of 32
//   consecutive channels, so B and C are the same for the whole warp (read
//   as broadcasts) and no shuffle is needed: each thread stores its partial
//   y of the step in shared memory, and after the tile the group's G partials
//   are added in order and leave in 16-byte coalesced stores.  At jamba's
//   width: 65,536 threads, 2,048 warps, two 256-thread blocks an SM.  (A
//   group of 4 neighbouring lanes summed by __shfl_xor_sync ran slower, in
//   float32 by a quarter: PERF.md, row 9);
// * a block of BLOCK channels of one batch row walks time in tiles of TILE
//   steps through a two-stage ring: the next tile's dt and x columns (16
//   bytes a thread) and B and C rows (8 bytes) arrive by cp.async while the
//   current tile is consumed.  A pass over the landed tile forms dt and
//   rnd(dt·x) once a channel a step (float2) and widens B and C to float;
// * each step reads the next step's inputs before it stores its partial
//   sum, so no shared load waits behind the step's whole chain;
// * two lanes are rounded by one packed conversion (cvt.rn.bf16x2.f32:
//   round to nearest even, as the single conversion) and unpacked by a shift
//   and a mask.  bf16 keeps CUDA's accurate expf, which the twin's torch.exp
//   runs too: a cheaper exponential would flip the bf16 rounding of some of
//   the 2·10⁹ values and move h by a bf16 ulp.  float32 takes ex2.approx of
//   dt·(A·log2 e), within a few ulps.
//
// The wrapper pads d_in to a multiple of 8 channels, so that every 16-byte
// chunk of a row is whole and aligned; the last block's chunks past d_in are
// zero-filled and never stored.  Launch geometry: kernels/selective_scan.py,
// launch_geometry (and block_lanes, this kernel's thread map).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int STATES = 4;   // state lanes a thread (kernels/selective_scan.py: STATES)
constexpr int BLOCK = 64;   // channels a block (kernels/selective_scan.py: BLOCK)
constexpr int TILE = 32;    // time steps a tile (kernels/selective_scan.py: TILE)
constexpr int ALIGN = 8;    // the width's multiple (kernels/selective_scan.py: ALIGN)
constexpr int UNROLL = 4;   // steps of a full tile unrolled together
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// the value rounded to T (identity for float32)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __bfloat162float(__float2bfloat16_rn(v));
}

// two values rounded to bf16 by one packed conversion, widened back
__device__ __forceinline__ float2 rnd_pair(float lo, float hi) {
  unsigned bits;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(bits) : "f"(hi), "f"(lo));
  return make_float2(__uint_as_float(bits << 16), __uint_as_float(bits & 0xffff0000u));
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool whole) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(whole ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// two state lanes of one step: h = exp(dt·a)·h + (dt·x)·b, acc += h·c
template <typename T>
__device__ __forceinline__ void lane_pair(float d, float dx, float a0, float a1, float b0, float b1, float c0,
                                          float c1, float& h0, float& h1, float& acc) {
  if constexpr (std::is_same<T, float>::value) {
    h0 = fmaf(ex2(d * a0), h0, dx * b0);  // a is A·log2 e here
    h1 = fmaf(ex2(d * a1), h1, dx * b1);
  } else {
    const float2 arg = rnd_pair(d * a0, d * a1);
    const float2 da = rnd_pair(expf(arg.x), expf(arg.y));
    const float2 u = rnd_pair(dx * b0, dx * b1);
    h0 = fmaf(da.x, h0, u.x);
    h1 = fmaf(da.y, h1, u.y);
  }
  acc = fmaf(h0, c0, acc);
  acc = fmaf(h1, c1, acc);
}

template <int DS, typename T>
constexpr size_t smem_bytes() {
  return DS / STATES * TILE * BLOCK * sizeof(float)  // the group's partial y of the current tile
         + (TILE + 1) * BLOCK * sizeof(float2)        // (dt, rnd(dt·x)) of the current tile, a spare row
         + 2 * (TILE + 1) * DS * sizeof(float)        // B and C widened, a spare row each
         + 2 * 2 * TILE * BLOCK * sizeof(T)           // the ring: dt and x as they arrive
         + 2 * 2 * TILE * DS * sizeof(T);             // the ring: B and C
}

template <int DS, typename T>
__global__ void __launch_bounds__(BLOCK * DS / STATES, 2) selective_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ h0, float* __restrict__ y, float* __restrict__ hT,
    int n_t, int d) {
  static_assert(STATES == 4 && DS % STATES == 0 && BLOCK % 32 == 0, "4 lanes a thread, whole warps of channels");
  constexpr int G = DS / STATES;          // threads a channel
  constexpr int NT = BLOCK * G;           // threads a block
  constexpr int E = 16 / sizeof(T);       // elements of a 16-byte chunk of dt / x
  constexpr int ROW = BLOCK / E;          // chunks of a block's row of dt / x
  constexpr int BC = 8 / sizeof(T);       // elements of an 8-byte chunk of B / C
  constexpr int YROW = BLOCK / 4;         // 16-byte chunks of a block's row of y
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_part = reinterpret_cast<float*>(smem);                     // [G][TILE][BLOCK]
  float2* s_dd = reinterpret_cast<float2*>(s_part + G * TILE * BLOCK);  // [TILE + 1][BLOCK]
  float* s_b = reinterpret_cast<float*>(s_dd + (TILE + 1) * BLOCK);   // [TILE + 1][DS]
  float* s_c = s_b + (TILE + 1) * DS;                                 // [TILE + 1][DS]
  T* r_dt = reinterpret_cast<T*>(s_c + (TILE + 1) * DS);              // [2][TILE][BLOCK]
  T* r_x = r_dt + 2 * TILE * BLOCK;                                   // [2][TILE][BLOCK]
  T* r_b = r_x + 2 * TILE * BLOCK;                                    // [2][TILE][DS]
  T* r_c = r_b + 2 * TILE * DS;                                       // [2][TILE][DS]

  // warp w serves state lanes g·STATES .. of 32 channels: g is uniform in a
  // warp, so B and C are read as broadcasts and the group's sum needs no shuffle
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = warp % G, c = tid % 32 + 32 * (warp / G);
  const int ch0 = blockIdx.x * BLOCK;
  const bool live = ch0 + c < d;
  const size_t row0 = (size_t)blockIdx.y * n_t;  // this batch row's first step
  const int n_tiles = (n_t + TILE - 1) / TILE;

  auto load = [&](int k) {  // tile k into ring stage k & 1
    const int p = k & 1, t0 = k * TILE, nt = min(TILE, n_t - t0);
    for (int i = tid; i < nt * ROW; i += NT) {
      const int r = i / ROW, q = i % ROW, cc = ch0 + q * E;
      const bool whole = cc < d;
      const size_t off = whole ? (row0 + t0 + r) * d + cc : 0;
      const int o = (p * TILE + r) * BLOCK + q * E;
      cp_async16(r_dt + o, dt + off, whole);
      cp_async16(r_x + o, x + off, whole);
    }
    for (int i = tid; i < nt * DS / BC; i += NT) {
      const size_t off = (row0 + t0) * DS + i * BC;
      cp_async8(r_b + p * TILE * DS + i * BC, Bm + off);
      cp_async8(r_c + p * TILE * DS + i * BC, Cm + off);
    }
  };

  float a[STATES], h[STATES];
  {
    const size_t lane0 = (size_t)(ch0 + c) * DS + g * STATES;
    const float4 av = live ? *reinterpret_cast<const float4*>(A + lane0) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 hv = (live && h0 != nullptr)
                          ? *reinterpret_cast<const float4*>(h0 + (size_t)blockIdx.y * d * DS + lane0)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    a[0] = av.x, a[1] = av.y, a[2] = av.z, a[3] = av.w;
    h[0] = hv.x, h[1] = hv.y, h[2] = hv.z, h[3] = hv.w;
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int n = 0; n < STATES; ++n) a[n] *= LOG2E;
    }
  }
  float* part = s_part + g * TILE * BLOCK + c;
  const float2* dd = s_dd + c;
  const float* bs = s_b + g * STATES;
  const float* cs = s_c + g * STATES;

  load(0);
  cp_commit();
  if (n_tiles > 1) load(1);
  cp_commit();
  for (int k = 0; k < n_tiles; ++k) {
    const int p = k & 1, t0 = k * TILE, nt = min(TILE, n_t - t0);
    cp_wait_one();  // tile k has landed (tile k + 1 may be in flight)
    __syncthreads();  // ... for every thread; tile k - 1 is consumed
    for (int i = tid; i < nt * BLOCK; i += NT) {
      const int o = p * TILE * BLOCK + i;
      const float dv = to_f(r_dt[o]), xv = to_f(r_x[o]);
      s_dd[i] = make_float2(dv, rnd<T>(dv * xv));
    }
    for (int i = tid; i < nt * DS; i += NT) {
      s_b[i] = to_f(r_b[p * TILE * DS + i]);
      s_c[i] = to_f(r_c[p * TILE * DS + i]);
    }
    __syncthreads();  // tile k widened; its ring stage is free
    if (k + 2 < n_tiles) load(k + 2);
    cp_commit();

    // each step reads the next step's inputs before it stores its partial
    // sum: a load after the store would wait for the step's whole chain (the
    // compiler keeps shared loads behind a shared store they may alias); the
    // spare row takes the read past the tile's last step
    float2 q = dd[0];
    float4 bv = *reinterpret_cast<const float4*>(bs), cv = *reinterpret_cast<const float4*>(cs);
    auto step = [&](int j) {
      const float2 qn = dd[(j + 1) * BLOCK];
      const float4 bn = *reinterpret_cast<const float4*>(bs + (j + 1) * DS);
      const float4 cn = *reinterpret_cast<const float4*>(cs + (j + 1) * DS);
      float acc = 0.f;
      lane_pair<T>(q.x, q.y, a[0], a[1], bv.x, bv.y, cv.x, cv.y, h[0], h[1], acc);
      lane_pair<T>(q.x, q.y, a[2], a[3], bv.z, bv.w, cv.z, cv.w, h[2], h[3], acc);
      part[j * BLOCK] = acc;
      q = qn, bv = bn, cv = cn;
    };
    if (nt == TILE) {
#pragma unroll (UNROLL)
      for (int j = 0; j < TILE; ++j) step(j);
    } else {
      for (int j = 0; j < nt; ++j) step(j);
    }
    __syncthreads();  // the tile's partial sums are in
    for (int i = tid; i < nt * YROW; i += NT) {  // y = the group's partials added, 16 bytes a thread
      const int r = i / YROW, q = i % YROW, cc = ch0 + q * 4;
      float4 v = *reinterpret_cast<const float4*>(s_part + r * BLOCK + q * 4);
#pragma unroll
      for (int gg = 1; gg < G; ++gg) {
        const float4 w = *reinterpret_cast<const float4*>(s_part + (gg * TILE + r) * BLOCK + q * 4);
        v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
      }
      if (cc < d) *reinterpret_cast<float4*>(y + (row0 + t0 + r) * d + cc) = v;
    }
  }
  if (live)
    *reinterpret_cast<float4*>(hT + (size_t)blockIdx.y * d * DS + (size_t)(ch0 + c) * DS + g * STATES) =
        make_float4(h[0], h[1], h[2], h[3]);
}

template <int DS, typename T>
int launch(void** p, int n_b, int n_t, int d, int blocks_x, int threads, cudaStream_t st) {
  constexpr int NT = BLOCK * DS / STATES;
  if (threads != NT || blocks_x != (d + BLOCK - 1) / BLOCK || d % ALIGN != 0) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<DS, T>();
  const cudaError_t e = cudaFuncSetAttribute(selective_scan_kernel<DS, T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  selective_scan_kernel<DS, T><<<dim3(blocks_x, n_b), NT, smem, st>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
      static_cast<const T*>(p[3]), static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<float*>(p[6]), static_cast<float*>(p[7]), n_t, d);
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

// ptrs: x, dt, B, C, A, h0 (or null), y, h_T; ints: B, T, width (d_in padded
// to a multiple of 8), ds, dtype (0 bf16, 1 float32), blocks along the
// channels, threads a block (kernels/selective_scan.py: launch_geometry)
extern "C" int selective_scan_launch(void** ptrs, long long* ints, void* stream) {
  const int n_b = (int)ints[0], n_t = (int)ints[1], d = (int)ints[2], ds = (int)ints[3];
  const int blocks_x = (int)ints[5], threads = (int)ints[6];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_b == 0 || d == 0) return 0;
  const int err = ints[4] == 0 ? launch_ds<__nv_bfloat16>(ptrs, n_b, n_t, d, ds, blocks_x, threads, st)
                               : launch_ds<float>(ptrs, n_b, n_t, d, ds, blocks_x, threads, st);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
