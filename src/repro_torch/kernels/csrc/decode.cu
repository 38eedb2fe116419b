// Decode: one encoded column chunk back to its int32 / float32 rows, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode.py:pallas_decode (its
// three pallas_calls: RLE, dictionary, bitpack / frame-of-reference).  There
// the grid walks 1024-row tiles in order, each step's encoded slice is
// pipelined HBM -> VMEM by its BlockSpec and decoded in-register.  Here every
// thread decodes one output row on its own; nothing is carried between rows,
// so the blocks need no order and no shared state.
//
// The storage invariants (repro_torch/data/storage.py) make every row's
// source a fixed place: bit widths are 1/2/4/8/16, so a value never straddles
// a 32-bit word and row r sits in word r / (32 / bits) at bit offset
// (r % (32 / bits)) * bits; RLE run tables are per tile, ends strictly
// increasing within the tile and padded with ``block``.
//
//   bitpack / FOR  shift and mask the word's uint32 bit pattern; FOR adds the
//                  frame reference in int32 (wrap-free by construction);
//   dict           unpack the code, then copy the dictionary's 4-byte value;
//   RLE            the run of row r in tile t = r / block is the count of
//                  ends[t, :] <= r % block (an upper bound by binary search
//                  over the tile's R ends); copy values[t, run].
//
// Rows n .. out_rows-1 repeat row n-1 (the padded final chunk).  Values are
// moved as 32-bit patterns, so a float32 column decodes bit for bit.
//
// What bounds it on an H100: bytes.  The encoded payload is read once
// (neighbouring threads share words, served by L1) and 4 bytes a row are
// written once, coalesced.  The bound is (encoded bytes + 4 B * out_rows) /
// 3.35 TB/s.  One launch per column per chunk; fusing a chunk's columns into
// one launch is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
enum Kind { BITPACK = 0, FOR = 1, DICT = 2, RLE = 3 };

__device__ __forceinline__ unsigned unpack(const unsigned* __restrict__ words,
                                           long long r, int bits) {
  const int vpw = 32 / bits;
  const unsigned w = words[r / vpw];
  const unsigned mask = bits == 32 ? 0xffffffffu : ((1u << bits) - 1u);
  return (w >> ((int)(r % vpw) * bits)) & mask;
}

__global__ void __launch_bounds__(THREADS)
decode_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
              unsigned* __restrict__ out, long long n, long long out_rows,
              int kind, int bits, int ref, int block, int runs) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= out_rows) return;
  const long long r = i < n ? i : n - 1;  // the padded tail repeats row n-1
  unsigned v;
  if (kind == RLE) {
    // a = run values [nt, runs], b = run ends [nt, runs] (int32)
    const long long t = r / block;
    const int off = (int)(r % block);
    const int* ends = reinterpret_cast<const int*>(b) + t * runs;
    int lo = 0, hi = runs;  // first run whose end is > off
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ends[mid] <= off) lo = mid + 1; else hi = mid;
    }
    v = a[t * runs + lo];
  } else {
    // a = packed words; b = dictionary values (dict only)
    const unsigned code = unpack(a, r, bits);
    if (kind == DICT) v = b[code];
    else v = code + (unsigned)ref;  // ref is 0 for bitpack
  }
  out[i] = v;
}

}  // namespace

// ptrs: a (words or RLE values), b (dict values, RLE ends, or unused), out
// ints: kind, n, out_rows, bits, ref, block, runs
extern "C" int decode_launch(void** ptrs, long long* ints, void* stream) {
  const long long n = ints[1], out_rows = ints[2];
  if (out_rows <= 0) return 0;
  const unsigned grid = (unsigned)((out_rows + THREADS - 1) / THREADS);
  decode_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)ptrs[0], (const unsigned*)ptrs[1], (unsigned*)ptrs[2],
      n, out_rows, (int)ints[0], (int)ints[3], (int)ints[4], (int)ints[5],
      (int)ints[6]);
  return (int)cudaGetLastError();
}
