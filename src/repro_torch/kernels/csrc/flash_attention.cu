// Flash attention on Hopper: online-softmax attention with GQA, causal and
// sliding-window masks.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:flash_attention.
// The TPU kernel walks a sequential grid (batch·head, query tile, key tile)
// and carries the running max m, the running sum l and the float32
// accumulator in VMEM scratch from one key tile to the next.  Blocks of a
// GPU grid run in parallel and in no order, so here one block owns one
// (query head, query tile, batch row) and the key tiles become a loop inside
// it; m, l and the accumulator live in registers.  A key tile that
// causality or the window masks out for the whole query tile is skipped, as
// the TPU kernel's pl.when(diag_ok & win_ok) skips it.  GQA: query head h
// reads KV head h / group from its own rows, never a repeated copy; the
// query heads of one group are neighbouring blocks (blockIdx.x), so they
// stage the same K/V tiles at about the same time and device memory serves
// each tile about once per KV head, the rest from L2.
//
// bfloat16 (the serving path): 4 warps, 64 query rows (16 a warp), 64-key
// tiles of K and V staged in shared memory with rows padded by 16 bytes
// against bank conflicts.  S = Q K^T and O += P V run on the tensor cores
// with mma.sync m16n8k16 (bf16 in, float32 accumulate); the S fragments are
// reused in registers as the A operand of the PV product.  The online
// softmax runs on the accumulator fragments, a row's 64 values spread over
// the 4 lanes of a quad.  float32: the same loop in plain FMA over 32-row,
// 16-key tiles, so that its sums stay in float32 (the tensor cores would
// round the inputs to TF32).
//
// Semantics kept exactly: query row r sits at key position r + Tk - Tq;
// causal masks col <= row, the window col > row - window, and col < Tk
// always; masked logits are -1e30; p and the rescale alpha are 0 while the
// running max is <= -5e29; a row with no visible key divides by 1 and
// returns 0; the scale multiplies the float32 logits; p is rounded to the
// value type before the PV product, the sum l is not.
//
// What bounds it on an H100: operations.  Causal attention at T = 8192,
// 24 query heads over 8 KV heads, D = 128 does about 4.1e11 floating-point
// operations against 1.3e8 bytes of Q, K, V and O, far above the ridge
// (about 295 bf16 operations a byte).
// This first version keeps every key tile's loads in the loop body (no
// cp.async pipeline, no wgmma, no TMA); those are for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float DEAD = -5e29f;  // NEG_INF / 2: the running max of a row that saw no key yet

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot;  // strides in elements
  int group, Tq, Tk, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int row, int col, const Params& p) {
  return col < p.Tk && (!p.causal || col <= row) && (p.window <= 0 || col > row - p.window);
}

// whether the [row0, row0 + rows) x [col0, col0 + cols) tile is masked whole
// (row0 a key position); uniform over the block
__device__ __forceinline__ bool skipped(int row0, int rows, int col0, int cols, const Params& p) {
  return (p.causal && col0 > row0 + rows - 1) || (p.window > 0 && col0 + cols - 1 <= row0 - p.window);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even); lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two neighbouring bf16 of a row of Q, 0 past the last row
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* Q, int row, int col, const Params& p) {
  return row < p.Tq ? *reinterpret_cast<const uint32_t*>(Q + (long long)row * p.sqt + col) : 0u;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(128) attn_bf16_kernel(Params p) {
  constexpr int BQ = 64, BK = 64, LD = D + 8;  // LD: shared row stride in elements
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];

  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest causal rows start first
  const int hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int q_off = p.Tk - p.Tq;
  const int tile_row0 = qt * BQ;
  const int r0 = tile_row0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const __nv_bfloat16* Q = (const __nv_bfloat16*)p.q + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* K = (const __nv_bfloat16*)p.k + b * p.skb + hk * p.skh;
  const __nv_bfloat16* V = (const __nv_bfloat16*)p.v + b * p.svb + hk * p.svh;
  __nv_bfloat16* O = (__nv_bfloat16*)p.o + b * p.sob + h * p.soh;

  // the warp's 16 query rows as A fragments, all of D
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = q_pair(Q, r0, kk * 16 + 2 * t, p);
    qa[kk][1] = q_pair(Q, r0 + 8, kk * 16 + 2 * t, p);
    qa[kk][2] = q_pair(Q, r0, kk * 16 + 8 + 2 * t, p);
    qa[kk][3] = q_pair(Q, r0 + 8, kk * 16 + 8 + 2 * t, p);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int n_kv = (p.Tk + BK - 1) / BK;
  for (int j = 0; j < n_kv; ++j) {
    const int col0 = j * BK;
    if (skipped(tile_row0 + q_off, BQ, col0, BK, p)) continue;
    __syncthreads();  // every warp is done with the previous tile
    constexpr int CH = D / 8;  // 16-byte chunks a row
    for (int c = threadIdx.x; c < BK * CH; c += 128) {
      const int r = c / CH, x = (c % CH) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (col0 + r < p.Tk) {
        kv = *reinterpret_cast<const uint4*>(K + (long long)(col0 + r) * p.skt + x);
        vv = *reinterpret_cast<const uint4*>(V + (long long)(col0 + r) * p.svt + x);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + x) = kv;
      *reinterpret_cast<uint4*>(vs + r * LD + x) = vv;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys a warp, float32
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, online softmax; element e of a fragment is row r0 + 8*(e>>1)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8 + q_off;
        const int col = col0 + n * 8 + 2 * t + (e & 1);
        const float x = visible(row, col, p) ? s[n][e] * p.scale : NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      alpha[hf] = m_new <= DEAD ? 0.f : expf(m[hf] - m_new);
      m[hf] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mr = m[e >> 1];
        const float pv = mr <= DEAD ? 0.f : expf(s[n][e] - mr);
        s[n][e] = pv;
        rs[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 1);
      rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 2);
      l[hf] = l[hf] * alpha[hf] + rs[hf];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // O += P V: P (rounded to bf16) from the S fragments, V from shared memory
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* vr = vs + (kk * 16 + 2 * t) * LD + dn * 8 + g;
        mma_bf16(acc[dn], a, pack_raw(vr[0], vr[LD]), pack_raw(vr[8 * LD], vr[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + hf * 8;
    if (row >= p.Tq) continue;
    const float denom = l[hf] == 0.f ? 1.f : l[hf];
    __nv_bfloat16* orow = O + (long long)row * p.sot + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack_bf16(acc[dn][2 * hf] / denom, acc[dn][2 * hf + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: plain FMA
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(128) attn_f32_kernel(Params p) {
  constexpr int BQ = 32, BK = 16;
  __shared__ float qs[BQ][D + 1];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ps[BQ][BK + 1];

  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int hk = h / p.group;
  const int row = threadIdx.x >> 2, quad = threadIdx.x & 3;  // a row's 4 lanes form a quad
  const int q_off = p.Tk - p.Tq;
  const int tile_row0 = qt * BQ;
  const int pos = tile_row0 + row + q_off;  // key position of this thread's query row
  const float* Q = (const float*)p.q + b * p.sqb + h * p.sqh;
  const float* K = (const float*)p.k + b * p.skb + hk * p.skh;
  const float* V = (const float*)p.v + b * p.svb + hk * p.svh;
  float* O = (float*)p.o + b * p.sob + h * p.soh;

  for (int c = threadIdx.x; c < BQ * D; c += 128) {
    const int r = c / D, x = c % D;
    qs[r][x] = tile_row0 + r < p.Tq ? Q[(long long)(tile_row0 + r) * p.sqt + x] : 0.f;
  }
  float m = NEG_INF, l = 0.f, acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  const int n_kv = (p.Tk + BK - 1) / BK;
  for (int j = 0; j < n_kv; ++j) {
    const int col0 = j * BK;
    if (skipped(tile_row0 + q_off, BQ, col0, BK, p)) continue;
    __syncthreads();
    for (int c = threadIdx.x; c < BK * D; c += 128) {
      const int r = c / D, x = c % D;
      const bool in = col0 + r < p.Tk;
      ks[r][x] = in ? K[(long long)(col0 + r) * p.skt + x] : 0.f;
      vs[r][x] = in ? V[(long long)(col0 + r) * p.svt + x] : 0.f;
    }
    __syncthreads();

    // this thread's 4 keys of its row: quad*4 .. quad*4 + 3
    float sv[4], mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kc = quad * 4 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qs[row][d], ks[kc][d], dot);
      sv[c] = visible(pos, col0 + kc, p) ? dot * p.scale : NEG_INF;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const bool dead = m_new <= DEAD;
    const float alpha = dead ? 0.f : expf(m - m_new);
    m = m_new;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float pv = dead ? 0.f : expf(sv[c] - m);
      ps[row][quad * 4 + c] = pv;
      rs += pv;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * alpha + rs;
    __syncwarp();  // the quad's row of p is written (a quad lies in one warp)
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const int d = quad + 4 * i;
      float a = acc[i] * alpha;
#pragma unroll
      for (int kc = 0; kc < BK; ++kc) a = fmaf(ps[row][kc], vs[kc][d], a);
      acc[i] = a;
    }
  }

  if (tile_row0 + row < p.Tq) {
    const float denom = l == 0.f ? 1.f : l;
    float* orow = O + (long long)(tile_row0 + row) * p.sot;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) orow[quad + 4 * i] = acc[i] / denom;
  }
}

template <int D>
int launch(const Params& p, int B, int H, int bf16, cudaStream_t s) {
  if (bf16) {
    attn_bf16_kernel<D><<<dim3(H, (p.Tq + 63) / 64, B), 128, 0, s>>>(p);
  } else {
    attn_f32_kernel<D><<<dim3(H, (p.Tq + 31) / 32, B), 128, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: q, k, v, o.  ints: B, H, Hkv, Tq, Tk, D, causal, window, dtype
// (0 bfloat16, 1 float32), then the (batch, head, row) strides in elements
// of q, k, v and o.  Returns the cudaGetLastError() of the launch.
extern "C" int flash_attention_launch(void** ptrs, long long* ints, void* stream) {
  const int B = (int)ints[0], H = (int)ints[1], Hkv = (int)ints[2], D = (int)ints[5];
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.o = ptrs[3];
  p.group = H / Hkv;
  p.Tq = (int)ints[3];
  p.Tk = (int)ints[4];
  p.causal = (int)ints[6];
  p.window = (int)ints[7];
  p.scale = (float)(1.0 / sqrt((double)D));
  const long long* st = ints + 9;
  p.sqb = st[0]; p.sqh = st[1]; p.sqt = st[2];
  p.skb = st[3]; p.skh = st[4]; p.skt = st[5];
  p.svb = st[6]; p.svh = st[7]; p.svt = st[8];
  p.sob = st[9]; p.soh = st[10]; p.sot = st[11];
  const int bf16 = ints[8] == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(p, B, H, bf16, s);
    case 64: return launch<64>(p, B, H, bf16, s);
    case 128: return launch<128>(p, B, H, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
