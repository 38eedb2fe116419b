// Flash attention on Hopper: online-softmax attention with GQA, causal and
// sliding-window masks.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:flash_attention.
// The TPU kernel walks a sequential grid (batch·head, query tile, key tile)
// and carries the running max m, the running sum l and the float32
// accumulator in VMEM scratch from one key tile to the next.  Blocks of a
// GPU grid run in parallel and in no order, so here one block owns one
// (query head, query tile, batch row) and the key tiles become a loop inside
// it; m, l and the accumulator live in registers.  GQA: query head h reads
// KV head h / group from its own rows, never a repeated copy; the query
// heads of one group are neighbouring blocks (blockIdx.x), so they read the
// same K/V tiles at about the same time, mostly from L2.  The longest causal
// rows start first (blockIdx.y counts query tiles from the end).
//
// Which kernel serves which (dtype, D):
//
//   bfloat16, D = 64, 128 or 160 (every config of the port): attn_wgmma_kernel.
//     A block of 384 threads owns 128 query rows: warpgroup 0 is the producer
//     (one thread issues TMA loads; the warpgroup gives its registers back
//     with setmaxnreg), warpgroups 1 and 2 each own 64 rows.  The producer
//     brings the Q tile in once and K and V tiles of BK keys (128 at D = 64
//     and 128) into a two-stage ring in shared memory, through TMA (cp.async.bulk.tensor) on
//     rank-4 maps over (D, T, head, batch) with the caller's strides, so a
//     head split of a projection needs no copy and rows past Tq or Tk are
//     filled with zeros.  Boxes are 64 columns (128 bytes) wide in 128-byte
//     swizzle, so a D = 128 tile is two boxes.  D = 160 (pixtral) takes
//     three boxes, 192 columns, of which TMA fills the 32 past D with zeros:
//     at BK = 128 the Q tile and two stages of K and V would need 240 KB, over
//     the 227 KB a block may have, so D = 160 runs BK = 64 keys a stage (144
//     KB).  Its S = Q K^T stops at column 160 (10 k16 steps); its O += P V is
//     one m64n192 wgmma whose last 32 columns are zeros and never stored.
//     mbarriers carry the ring: a full barrier per stage for K and one for V (TMA's transaction count),
//     an empty barrier per stage that every consumer warp arrives on.
//     S = Q K^T is wgmma m64nBKk16 with both operands in shared memory (K
//     is [keys, D], K-major); O += P V is wgmma with P from registers (the
//     m64 accumulator layout of S is the A-fragment layout, so p packs to
//     bf16 in place) and V from shared memory with the transpose bit (V is
//     [keys, D], MN-major).  The softmax works in base 2 with scale·log2(e)
//     folded into one FMA and ex2.approx on the special-function unit (the
//     library exp2f measured far slower).  Each key tile is
//     classified per warpgroup by tile_class: masked whole (skipped),
//     visible whole (no per-element mask), or masked (the diagonal,
//     window-edge and ragged col >= Tk tiles, the only ones that test each
//     element).  An intra-warpgroup pipeline (S of tile j issued beside PV
//     of tile j - 1) measured slower and is not used.
//   bfloat16, D = 16 (the reduced test models): attn_bf16_kernel, mma.sync
//     m16n8k16 over 64 x 64 tiles staged through registers.
//   float32, any D: attn_f32_kernel, plain FMA over 32 x 16 tiles, so that
//     its sums stay float32 (the tensor cores would round the inputs to TF32).
//
// Semantics kept exactly: query row r sits at key position r + Tk - Tq;
// causal masks col <= row, the window col > row - window, and col < Tk
// always; a masked logit counts as -1e30 (the running max starts there);
// p and the rescale alpha are 0 while the running max is <= -5e29; a row
// with no visible key divides by 1 and returns 0; the scale multiplies the
// float32 logits (in the wgmma kernel as scale·log2(e), with ex2); p is
// rounded to the value type before the PV product, the sum l is not.
//
// What bounds it on an H100: operations.  Causal attention at T = 8192,
// 24 query heads over 8 KV heads, D = 128 does about 4.1e11 floating-point
// operations against 1.3e8 bytes of Q, K, V and O, far above the ridge
// (about 295 bf16 operations a byte); the wgmma kernel keeps the tensor
// cores fed from shared memory while TMA fills the next stage.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float DEAD = -5e29f;  // NEG_INF / 2: the running max of a row that saw no key yet
constexpr int SKIP = 0, FULL = 1, MASKED = 2;  // tile classes

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

// The class of the [row0, row0 + rows) x [col0, col0 + cols) tile (row0 a
// key position): SKIP when no pair is visible (causality or the window masks
// it whole), FULL when every pair is, MASKED otherwise.  The same rule is
// kernels/flash_attention.py:tile_class.
__device__ __forceinline__ int tile_class(int row0, int rows, int col0, int cols, const Params& p) {
  if ((p.causal && col0 > row0 + rows - 1) || (p.window > 0 && col0 + cols - 1 <= row0 - p.window)) return SKIP;
  if (col0 + cols <= p.Tk && (!p.causal || col0 + cols - 1 <= row0) &&
      (p.window <= 0 || col0 > row0 + rows - 1 - p.window))
    return FULL;
  return MASKED;
}

// two floats rounded to bf16 (round to nearest even); lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bfloat16 at D = 64 and 128: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BQ = 128, STAGES = 2, THREADS = 384;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

template <int D>
struct Layout {  // byte offsets from a 1024-byte aligned base
  static constexpr int BK = D > 128 ? 64 : 128;  // keys a stage: 227 KB hold no 128-key stages at D = 160
  static constexpr int BOXES = (D + 63) / 64;     // 64-column boxes a row
  static constexpr int DP = 64 * BOXES;           // columns staged: D, or 192 at D = 160 (zeros past D)
  static constexpr int Q_BOX = BQ * 128;  // one 64-column box of the Q tile
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;  // one stage of K (or of V)
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, then per stage k_full, v_full and empty; 1024 bytes of slack to align the base
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `phase` has completed; a wait that never
// ends (a broken ring) traps, so that the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    if (spins == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
    if (done) return;
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptors over 128-byte swizzled boxes (rows of 128 bytes, 8-row
// atoms of 1024 bytes).  K-major (Q, K): the leading offset is unused (1),
// 8-row groups 1024 bytes apart; a k16 step inside a box adds 32 bytes to
// the start.  MN-major (V, transposed): 64-column chunks `lbo` bytes apart,
// 8-key groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] = A[64 x 16] B[16 x 128] (+ D when accumulate), A and B from
// shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] = A[64 x 16] B[16 x 64] (+ D when accumulate), A and B from
// shared memory (S at BK = 64)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] (registers) B[16 x 128] (shared memory, transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] (registers) B[16 x 64] (shared memory, transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 192] += A[64 x 16] (registers) B[16 x 192] (shared memory, transposed):
// P V at D = 160, whose V tile is three boxes, the last 32 columns zeros
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit (flush-to-zero; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The key tiles [j_lo, j_hi) that a block of `rows` query rows from key
// position row0 visits: every tile that tile_class does not skip (causality
// bounds the last, the window the first).
template <int BK>
__device__ __forceinline__ void visited_tiles(int row0, int rows, const Params& p, int& j_lo, int& j_hi) {
  const int last = p.causal ? min(p.Tk - 1, row0 + rows - 1) : p.Tk - 1;
  j_hi = last < 0 ? 0 : last / BK + 1;
  j_lo = p.window > 0 ? max(0, row0 - p.window + 1) / BK : 0;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<D>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF, bars = base + L::BAR_OFF;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest causal rows start first
  const int tile_row0 = qt * BQ;
  const int row_first = tile_row0 + p.Tk - p.Tq;  // key position of the tile's first row
  int j_lo, j_hi;
  visited_tiles<BK>(row_first, BQ, p, j_lo, j_hi);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int x = 0; x < L::BOXES; ++x) tma_load(q_s + x * L::Q_BOX, &tq, q_full, 64 * x, tile_row0, h, b);
      const int hk = h / p.group;
      for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
        mbar_expect_tx(k_full(s), L::KV_BYTES);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x)
          tma_load(k_s + s * L::KV_BYTES + x * L::KV_BOX, &tk, k_full(s), 64 * x, j * BK, hk, b);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x)
          tma_load(v_s + s * L::KV_BYTES + x * L::KV_BOX, &tv, v_full(s), 64 * x, j * BK, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = (threadIdx.x >> 7) - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;  // accumulator fragment coordinates
    const int rw = row_first + 64 * cw;     // key position of the warpgroup's first row
    const float sl2 = p.scale * 1.4426950408889634f;
    const uint32_t q_w = q_s + cw * 64 * 128;

    float o[L::DP / 2];  // past D / 2: the zero columns of a D = 160 tile, never stored
#pragma unroll
    for (int i = 0; i < L::DP / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8; l is this thread's part

    mbar_wait(q_full, 0);
    for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int c0 = j * BK;
      const int cls = tile_class(rw, 64, c0, BK, p);  // uniform over the warpgroup
      mbar_wait(k_full(s), ph);
      if (cls != SKIP) {
        // S = Q K^T, 64 x BK float32 (the k16 steps stop at D)
        float sc[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // 64-column box kk / 4, k16 step kk % 4 inside it
          wgmma_ss(sc, desc(q_w + (kk >> 2) * L::Q_BOX + (kk & 3) * 32, 16),
                   desc(k_s + s * L::KV_BYTES + (kk >> 2) * L::KV_BOX + (kk & 3) * 32, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);

        // element i of the fragment: row g + 8 * ((i >> 1) & 1) of the warp's 16,
        // column 8 * (i >> 2) + 2 * t + (i & 1)
        if (cls == MASKED) {
          const int row = rw + 16 * warp + g;
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int col = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
            if (!visible(row + 8 * ((i >> 1) & 1), col, p)) sc[i] = -INFINITY;
          }
        }

        // online softmax in base 2: logits are s * scale * log2(e)
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < BK / 2; i += 4) {
          mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float n0 = fmaxf(m0, mx0 * sl2), n1 = fmaxf(m1, mx1 * sl2);
        const bool dead0 = n0 <= DEAD, dead1 = n1 <= DEAD;
        const float a0 = dead0 ? 0.f : ex2(m0 - n0), a1 = dead1 ? 0.f : ex2(m1 - n1);
        m0 = n0;
        m1 = n1;
        float rs0 = 0.f, rs1 = 0.f;
        uint32_t pa[BK / 16][4];  // P as the A operand, rounded to bf16
#pragma unroll
        for (int i = 0; i < BK / 2; i += 4) {
          const float p0 = dead0 ? 0.f : ex2(fmaf(sc[i], sl2, -n0));
          const float p1 = dead0 ? 0.f : ex2(fmaf(sc[i + 1], sl2, -n0));
          const float p2 = dead1 ? 0.f : ex2(fmaf(sc[i + 2], sl2, -n1));
          const float p3 = dead1 ? 0.f : ex2(fmaf(sc[i + 3], sl2, -n1));
          rs0 += p0 + p1;
          rs1 += p2 + p3;
          // columns 8n .. 8n + 7 are k-step n / 2, its low (even n) or high half
          const int kk = i >> 3, hi = (i >> 2) & 1;
          pa[kk][2 * hi] = pack_bf16(p0, p1);
          pa[kk][2 * hi + 1] = pack_bf16(p2, p3);
        }
        l0 = l0 * a0 + rs0;
        l1 = l1 * a1 + rs1;
#pragma unroll
        for (int i = 0; i < L::DP / 2; i += 4) {
          o[i] *= a0;
          o[i + 1] *= a0;
          o[i + 2] *= a1;
          o[i + 3] *= a1;
        }

        // O += P V, one wgmma of N = DP a k16 step
        mbar_wait(v_full(s), ph);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(o, pa[kk], desc(v_s + s * L::KV_BYTES + kk * 16 * 128, L::KV_BOX));
        wgmma_commit();
        wgmma_wait();
        fence_regs(o);
      } else {
        mbar_wait(v_full(s), ph);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float dn0 = l0 == 0.f ? 1.f : l0, dn1 = l1 == 0.f ? 1.f : l1;
    const int row0 = tile_row0 + 64 * cw + 16 * warp + g;
    __nv_bfloat16* O = (__nv_bfloat16*)p.o + b * p.sob + h * p.soh + 2 * t;
    if (row0 < p.Tq) {
      __nv_bfloat16* orow = O + (long long)row0 * p.sot;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4)
        *reinterpret_cast<uint32_t*>(orow + 2 * i) = pack_bf16(o[i] / dn0, o[i + 1] / dn0);
    }
    if (row0 + 8 < p.Tq) {
      __nv_bfloat16* orow = O + (long long)(row0 + 8) * p.sot;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4)
        *reinterpret_cast<uint32_t*>(orow + 2 * i) = pack_bf16(o[i + 2] / dn1, o[i + 3] / dn1);
    }
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bfloat16 at D = 16: mma.sync (the reduced test models' head dim)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two neighbouring bf16 of a row of Q, 0 past the last row
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* Q, int row, int col, const Params& p) {
  return row < p.Tq ? *reinterpret_cast<const uint32_t*>(Q + (long long)row * p.sqt + col) : 0u;
}

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
    if (tile_class(tile_row0 + q_off, BQ, col0, BK, p) == SKIP) continue;
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
    if (tile_class(tile_row0 + q_off, BQ, col0, BK, p) == SKIP) continue;
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry point
// (no link against libcuda needed)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A rank-4 map over (D, T, heads, batch) of bf16 with the given element
// strides; boxes of 64 columns x `rows` rows in 128-byte swizzle.  Rows past
// T, and columns past D (the third box of a D = 160 row), read as zeros.  A dimension of extent 1 gets a harmless stride (its
// coordinate is always 0), so an expanded view's stride 0 is never passed.
bool make_map(CUtensorMap* map, const void* ptr, int D, int T, int heads, int batch, long long st, long long sh,
              long long sb, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  if (heads == 1) sh = st * T;
  if (batch == 1) sb = sh * heads;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const Params& p, int B, int H, int Hkv, cudaStream_t s) {
  constexpr int BK = wg::Layout<D>::BK;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, D, p.Tq, H, B, p.sqt, p.sqh, p.sqb, wg::BQ) ||
      !make_map(&tk, p.k, D, p.Tk, Hkv, B, p.skt, p.skh, p.skb, BK) ||
      !make_map(&tv, p.v, D, p.Tk, Hkv, B, p.svt, p.svh, p.svb, BK))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = wg::Layout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(wg::attn_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wg::attn_wgmma_kernel<D><<<dim3(H, (p.Tq + wg::BQ - 1) / wg::BQ, B), wg::THREADS, smem, s>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Params& p, int B, int H, cudaStream_t s) {
  attn_f32_kernel<D><<<dim3(H, (p.Tq + 31) / 32, B), 128, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: q, k, v, o.  ints: B, H, Hkv, Tq, Tk, D, causal, window, dtype
// (0 bfloat16, 1 float32), then the (batch, head, row) strides in elements
// of q, k, v and o.  bfloat16 at D = 64, 128 or 160 takes the wgmma kernel,
// bfloat16 at D = 16 the mma.sync kernel, float32 the FMA kernel.  Returns
// the cudaGetLastError() of the launch (cudaErrorInvalidValue for a shape
// no kernel takes or a tensor map the driver refuses).
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
  cudaStream_t s = (cudaStream_t)stream;
  if (ints[8] == 0) {
    switch (D) {
      case 16:
        attn_bf16_kernel<16><<<dim3(H, (p.Tq + 63) / 64, B), 128, 0, s>>>(p);
        return (int)cudaGetLastError();
      case 64: return launch_wgmma<64>(p, B, H, Hkv, s);
      case 128: return launch_wgmma<128>(p, B, H, Hkv, s);
      case 160: return launch_wgmma<160>(p, B, H, Hkv, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return launch_f32<16>(p, B, H, s);
    case 64: return launch_f32<64>(p, B, H, s);
    case 128: return launch_f32<128>(p, B, H, s);
    case 160: return launch_f32<160>(p, B, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory a block of the wgmma kernel asks for at head
// dim D (64, 128 or 160), or -1.
extern "C" int flash_attention_wgmma_smem(int D) {
  return D == 64 ? wg::Layout<64>::SMEM : D == 128 ? wg::Layout<128>::SMEM : D == 160 ? wg::Layout<160>::SMEM : -1;
}
