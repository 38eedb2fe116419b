// Device functions of the fused-pipeline kernel (kernels/fused_pipeline.py).
//
// A generated region source includes this header, defines its row function,
// then includes fused_kernels.cuh, which holds the two kernel templates: a
// dictionary terminal (an open-addressing accumulator in the terminal
// family's probe layout, claimed as claim_table.cuh claims) and a scalar
// Reduce.  Hashes and probe layouts come from claim_table.cuh.
#pragma once
#include "claim_table.cuh"

namespace fp {

constexpr int ST_BLOCK = 128;  // st_blocked leaf width

// One probed dictionary: the family's key-side slabs plus the payload slabs
// aligned to slab positions (float lanes fv[cap, nf], int32 lanes iv[cap, ni]).
// A radix-partitioned dictionary is stacked: keys [P, lp], bm [P, nbp],
// fv [P, lp, nf], iv [P, lp, ni]; cap stays the whole table's capacity (the
// hash modulus) and cp = cap / P is the global slot stride between blocks.
struct Dict {
  const int* keys;
  const int* bm;  // st_blocked block maxima (nb entries, nbp a block), else unused
  const float* fv;
  const int* iv;
  int cap;
  int nb;
  int nf;
  int ni;
  int lp;
  int cp;
  int nbp;
};

// The partition a radix tile probes: its id and its block's key slab and
// directory, in shared memory when staged, else in device memory.
struct Part {
  int p;
  const int* keys;
  const int* bm;
};

// One column read through an encoded stream (the storage layer's chunk
// encodings, as csrc/decode.cu decodes them), or a raw 4-byte column.  The
// encoded kinds' ids are kernels/decode.py's KINDS.
enum { ENC_BITPACK = 0, ENC_FOR = 1, ENC_DICT = 2, ENC_RLE = 3, ENC_RAW = 4 };
struct Enc {
  const unsigned* a;  // packed words | RLE run values [nt, runs] | raw rows
  const unsigned* b;  // dictionary values | RLE run ends [nt, runs] (int32)
  long long n;        // encoded rows: row i reads row min(i, n - 1)
  int kind;
  int bits;
  int ref;
  int block;
  int runs;
};

// resident finds: slab position of q, or -1
template <int KIND>
__device__ __forceinline__ int find_hash(const Dict& d, int q, int max_probes) {
  for (int t = 0; t < max_probes; ++t) {
    const int s = probe_slot<KIND>(q, t, d.cap);
    const int cur = d.keys[s];
    if (cur == q) return s;
    if (cur == EMPTY_KEY) return -1;
  }
  return -1;
}

// base.lower_bound_pow2: min(count of keys < q, L - 1) over a pow2 slab
__device__ __forceinline__ int lower_bound_pow2(const int* keys, int L, int q) {
  int pos = 0;
  for (int bit = L >> 1; bit; bit >>= 1) {
    if (keys[pos + bit - 1] < q) pos += bit;
  }
  return pos;
}

__device__ __forceinline__ int find_st_sorted(const Dict& d, int q) {
  const int pos = lower_bound_pow2(d.keys, d.cap, q);
  return d.keys[pos] == q ? pos : -1;
}

// st_blocked: the leaf is the first block whose max is >= q (binary search
// over the nb sorted maxima, clamped), then the count of leaf keys below q,
// over a slab of L keys (a whole table or one partition block)
__device__ __forceinline__ int find_blocked(const int* keys, const int* bm, int L, int nb, int q) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (bm[mid] < q) lo = mid + 1; else hi = mid;
  }
  const int blk = min(lo, nb - 1);
  const int base = blk * ST_BLOCK;
  lo = 0;
  hi = ST_BLOCK;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[base + mid] < q) lo = mid + 1; else hi = mid;
  }
  const int pos = min(base + lo, L - 1);
  return keys[pos] == q ? pos : -1;
}

__device__ __forceinline__ int find_st_blocked(const Dict& d, int q) {
  return find_blocked(d.keys, d.bm, d.cap, d.nb, q);
}

// radix mode: finds local to one partition's block (positions are local)
__device__ __forceinline__ int find_linear_part(const Dict& d, const Part& pt, int q, int max_probes) {
  const bool full = d.lp == d.cap;  // one partition: the whole table, chains wrap
  const int h0 = hash1(q, d.cap) - (full ? 0 : pt.p * d.cp);
  for (int t = 0; t < max_probes; ++t) {
    const int s = full ? ((h0 + t) & (d.cap - 1)) : h0 + t;
    if (s < 0 || s >= d.lp) return -1;  // outside the block reads as EMPTY
    const int cur = pt.keys[s];
    if (cur == q) return s;
    if (cur == EMPTY_KEY) return -1;
  }
  return -1;
}
__device__ __forceinline__ int find_sorted_part(const Dict& d, const Part& pt, int q) {
  const int pos = lower_bound_pow2(pt.keys, d.lp, q);
  return pt.keys[pos] == q ? pos : -1;
}
__device__ __forceinline__ int find_blocked_part(const Dict& d, const Part& pt, int q) {
  return find_blocked(pt.keys, pt.bm, d.lp, d.nbp, q);
}

// one row of an encoded column as its 32-bit pattern, exactly as
// csrc/decode.cu's decode_kernel computes it
__device__ __forceinline__ unsigned enc_bits(const Enc& e, long long i) {
  const long long r = i < e.n ? i : e.n - 1;
  if (e.kind == ENC_RAW) return e.a[r];
  if (e.kind == ENC_RLE) {
    const long long t = r / e.block;
    const int off = (int)(r % e.block);
    const int* ends = reinterpret_cast<const int*>(e.b) + t * e.runs;
    int lo = 0, hi = e.runs;  // first run whose end is > off
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ends[mid] <= off) lo = mid + 1; else hi = mid;
    }
    return e.a[t * e.runs + lo];
  }
  const int vpw = 32 / e.bits;
  const unsigned mask = e.bits == 32 ? 0xffffffffu : ((1u << e.bits) - 1u);
  const unsigned code = (e.a[r / vpw] >> ((int)(r % vpw) * e.bits)) & mask;
  if (e.kind == ENC_DICT) return e.b[code];
  return code + (unsigned)e.ref;  // ref is 0 for bitpack
}
__device__ __forceinline__ int enc_i32(const Enc& e, long long i) { return (int)enc_bits(e, i); }
__device__ __forceinline__ float enc_f32(const Enc& e, long long i) { return __uint_as_float(enc_bits(e, i)); }

// JAX/torch floor-mod ("%"), not C's truncating remainder
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ float floor_mod(float a, float b) {
  const float r = fmodf(a, b);
  return (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) ? r + b : r;
}
// wrapping int32 arithmetic (two's complement, as XLA and torch)
__device__ __forceinline__ int add_w(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int sub_w(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int mul_w(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

}  // namespace fp
