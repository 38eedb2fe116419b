// Decode: one encoded column chunk back to its int32 / float32 rows, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode.py:pallas_decode (its
// three pallas_calls: RLE, dictionary, bitpack / frame-of-reference).  There
// the grid walks 1024-row tiles in order, each step's encoded slice is
// pipelined HBM -> VMEM by its BlockSpec and decoded in-register.
//
// The storage invariants (repro_torch/data/storage.py) make every row's
// source a fixed place: bit widths are 1/2/4/8/16, so a value never straddles
// a 32-bit word and row r sits in word r >> log2(32 / bits) at bit offset
// (r & (32 / bits - 1)) * bits (tiles are whole words, so the tiling does
// not enter); RLE run tables are per tile, ends strictly increasing within
// the tile and padded with ``block``.
//
//   bitpack / FOR  shift and mask the word's uint32 bit pattern; FOR adds the
//                  frame reference in int32 (wrap-free by construction);
//   dict           unpack the code, then copy the dictionary's 4-byte value;
//   RLE            the run of row r in tile t is the count of ends[t, :] <=
//                  r mod block; copy values[t, run].
//
// Rows n .. out_rows-1 repeat row n-1 (the padded final chunk).  Values are
// moved as 32-bit patterns, so a float32 column decodes bit for bit.
//
// What bounds it on an H100: bytes.  The encoded payload is read once and 4
// bytes a row are written once: (encoded bytes + 4 B * out_rows) / 3.35
// TB/s, 1.4-1.6 us for a 1,048,576-row chunk, so fixed costs (launch, grid
// ramp, tail) weigh as much as the bytes.  The design:
//
// * a thread writes four rows at a step with one 16-byte store; every index
//   is 32-bit and, with the bit width a template parameter, every divide
//   and modulo a shift and a mask (out_rows < 2^31 and block a power of two
//   are checked by kernels/decode.py);
// * the four rows of a step share one packed word (two for 16 bits), loaded
//   once;
// * RLE: a block stages one tile's run ends and values in shared memory,
//   then each thread finds its first row's run by a binary search there and
//   walks forward for the next three;
// * grids are the resident blocks (2,048 threads an SM), each thread
//   looping over the rows with a grid stride.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // the packed kernel's block
constexpr int RLE_THREADS = 128;  // the RLE kernel's: a 1024-row tile takes two steps a thread
constexpr int BLOCKS_PER_SM = 2048 / THREADS;  // the grid's blocks an SM (the resident ones)
enum Kind { BITPACK = 0, FOR = 1, DICT = 2, RLE = 3 };

template <int BITS>
__device__ __forceinline__ unsigned field(unsigned w, unsigned r) {
  constexpr unsigned VPW = 32 / BITS, MASK = (1u << BITS) - 1u;
  return (w >> ((r & (VPW - 1u)) * BITS)) & MASK;
}

template <int BITS>
__host__ __device__ constexpr int log2_vpw() {
  return BITS == 1 ? 5 : BITS == 2 ? 4 : BITS == 4 ? 3 : BITS == 8 ? 2 : 1;
}

template <int KIND>
__device__ __forceinline__ unsigned finish(unsigned code, const unsigned* __restrict__ dict, unsigned ref) {
  if constexpr (KIND == DICT) return __ldg(dict + code);
  else return code + ref;  // ref is 0 for bitpack
}

// the codes of rows r0 .. r0+3, each clamped to n - 1
template <int BITS>
__device__ __forceinline__ void codes4(const unsigned* __restrict__ words, unsigned r0, unsigned n, unsigned* c) {
  constexpr int LV = log2_vpw<BITS>();
  if (r0 + 3u < n) {
    if constexpr (BITS == 16) {
      const unsigned w0 = __ldg(words + (r0 >> 1)), w1 = __ldg(words + (r0 >> 1) + 1);
      c[0] = w0 & 0xffffu;
      c[1] = w0 >> 16;
      c[2] = w1 & 0xffffu;
      c[3] = w1 >> 16;
    } else {
      const unsigned w = __ldg(words + (r0 >> LV));
#pragma unroll
      for (int k = 0; k < 4; ++k) c[k] = field<BITS>(w, r0 + k);
    }
  } else if (r0 >= n) {  // the padded tail: row n - 1 four times
    const unsigned r = n - 1;
    c[0] = c[1] = c[2] = c[3] = field<BITS>(__ldg(words + (r >> LV)), r);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned r = min(r0 + k, n - 1);
      c[k] = field<BITS>(__ldg(words + (r >> LV)), r);
    }
  }
}

__device__ __forceinline__ void store4(unsigned* __restrict__ out, unsigned r0, unsigned out_rows, uint4 v) {
  if (r0 + 3u < out_rows) {
    *reinterpret_cast<uint4*>(out + r0) = v;
  } else {
    out[r0] = v.x;
    if (r0 + 1u < out_rows) out[r0 + 1] = v.y;
    if (r0 + 2u < out_rows) out[r0 + 2] = v.z;
  }
}

template <int KIND, int BITS>
__global__ void __launch_bounds__(THREADS)
packed_kernel(const unsigned* __restrict__ words, const unsigned* __restrict__ dict, unsigned* __restrict__ out,
              unsigned n, unsigned out_rows, unsigned ref) {
  const unsigned groups = (out_rows + 3u) >> 2;
  for (unsigned g = blockIdx.x * THREADS + threadIdx.x; g < groups; g += gridDim.x * THREADS) {
    unsigned c[4];
    codes4<BITS>(words, g << 2, n, c);
    store4(out, g << 2, out_rows,
           make_uint4(finish<KIND>(c[0], dict, ref), finish<KIND>(c[1], dict, ref),
                      finish<KIND>(c[2], dict, ref), finish<KIND>(c[3], dict, ref)));
  }
}

// values, ends: [nt, runs]; one block a tile at a time, the tile's runs
// staged in dynamic shared memory (runs * 8 bytes)
__global__ void __launch_bounds__(RLE_THREADS)
rle_kernel(const unsigned* __restrict__ values, const int* __restrict__ ends, unsigned* __restrict__ out,
           unsigned n, unsigned out_rows, int lb, int runs) {
  extern __shared__ int stage[];
  int* s_end = stage;
  unsigned* s_val = reinterpret_cast<unsigned*>(stage + runs);
  const unsigned block = 1u << lb;
  const unsigned nt = (n + block - 1u) >> lb;  // encoded tiles
  const unsigned tiles = (unsigned)(((unsigned long long)out_rows + block - 1u) >> lb);  // with the padded tail's
  for (unsigned t = blockIdx.x; t < tiles; t += gridDim.x) {
    const unsigned src = min(t, nt - 1u);  // a tile past the encoded ones repeats row n - 1
    __syncthreads();  // the previous tile's readers are done with the stage
    for (int j = threadIdx.x; j < runs; j += RLE_THREADS) {
      s_end[j] = __ldg(ends + (size_t)src * runs + j);
      s_val[j] = __ldg(values + (size_t)src * runs + j);
    }
    __syncthreads();
    const unsigned base = t << lb, src_base = src << lb;
    for (unsigned o = threadIdx.x * 4u; o < block; o += RLE_THREADS * 4u) {
      const unsigned r0 = base + o;
      if (r0 >= out_rows) break;
      int lo = 0, hi = runs;  // the first run whose end is > the first row's offset
      const int off0 = (int)(min(r0, n - 1u) - src_base);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_end[mid] <= off0) lo = mid + 1; else hi = mid;
      }
      lo = min(lo, runs - 1);  // a tile's last end covers its last row
      unsigned v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int off = (int)(min(r0 + k, n - 1u) - src_base);
        while (lo < runs - 1 && s_end[lo] <= off) ++lo;
        v[k] = s_val[lo];
      }
      store4(out, r0, out_rows, make_uint4(v[0], v[1], v[2], v[3]));
    }
  }
}

int resident_grid(long long work_blocks, int blocks_per_sm) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long cap = (long long)sms * blocks_per_sm;
  return (int)(work_blocks < cap ? (work_blocks > 0 ? work_blocks : 1) : cap);
}

template <int KIND>
void launch_packed(int bits, const unsigned* a, const unsigned* b, unsigned* out, unsigned n, unsigned out_rows,
                   unsigned ref, cudaStream_t st) {
  const int grid = resident_grid(((long long)out_rows + 4LL * THREADS - 1) / (4LL * THREADS), BLOCKS_PER_SM);
  switch (bits) {
    case 1: packed_kernel<KIND, 1><<<grid, THREADS, 0, st>>>(a, b, out, n, out_rows, ref); break;
    case 2: packed_kernel<KIND, 2><<<grid, THREADS, 0, st>>>(a, b, out, n, out_rows, ref); break;
    case 4: packed_kernel<KIND, 4><<<grid, THREADS, 0, st>>>(a, b, out, n, out_rows, ref); break;
    case 8: packed_kernel<KIND, 8><<<grid, THREADS, 0, st>>>(a, b, out, n, out_rows, ref); break;
    default: packed_kernel<KIND, 16><<<grid, THREADS, 0, st>>>(a, b, out, n, out_rows, ref); break;
  }
}

}  // namespace

// ptrs: a (words or RLE values), b (dict values, RLE ends, or unused), out
// ints: kind, n, out_rows, bits, ref, log2(block), runs
// (checked by kernels/decode.py: 1 <= n <= out_rows < 2^31, bits 1/2/4/8/16,
// block a power of two >= 32, runs * 8 bytes within 48 KB)
extern "C" int decode_launch(void** ptrs, long long* ints, void* stream) {
  const int kind = (int)ints[0], bits = (int)ints[3], lb = (int)ints[5], runs = (int)ints[6];
  const unsigned n = (unsigned)ints[1], out_rows = (unsigned)ints[2], ref = (unsigned)(int)ints[4];
  if (out_rows == 0) return 0;
  const unsigned* a = (const unsigned*)ptrs[0];
  const unsigned* b = (const unsigned*)ptrs[1];
  unsigned* out = (unsigned*)ptrs[2];
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case BITPACK: launch_packed<BITPACK>(bits, a, b, out, n, out_rows, 0u, st); break;
    case FOR: launch_packed<FOR>(bits, a, b, out, n, out_rows, ref, st); break;
    case DICT: launch_packed<DICT>(bits, a, b, out, n, out_rows, 0u, st); break;
    default: {
      const long long tiles = ((long long)out_rows + (1LL << lb) - 1) >> lb;
      rle_kernel<<<resident_grid(tiles, 2048 / RLE_THREADS), RLE_THREADS, (size_t)runs * 8, st>>>(
          a, (const int*)b, out, n, out_rows, lb, runs);
    }
  }
  return (int)cudaGetLastError();
}
