// Hash probe: batched lookups into an ht_linear table, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/hash_probe.py:hash_probe.
// There the table (keys and values) is pinned in VMEM and each grid step
// probes a 512-query tile: one full-width vector gather and compare a round,
// rounds until every lane of the tile has hit or reached an EMPTY slot, at
// most max_probes (128, the family's build bound).  Its semantic definition
// is repro/kernels/ref.py:hash_probe: linear probing from hash1(q) until the
// key or EMPTY, wrapping mod C, and the value row of a hit (zeros for a miss).
//
// What bounds it on an H100: scattered 32-byte sectors.  Queries stream in
// and value rows and found flags stream out, coalesced; every probe is a
// dependent 4-byte load at a hashed slot (one sector) and a hit gathers a
// 4V-byte row (another).  Measured on the card (PERF.md, §6): shuffled
// at SF 1's shape a launch moves 12 M scattered sectors in 138 us, and the
// value gather costs what its sectors cost, not a round trip: loading the
// home slot's value row beside its key (one round trip for a home hit)
// doubled the sectors of every miss (the sweep's 2^21-key miss cells
// 118 -> 209 us) and won 5 % on hits.  So the design spends no speculative
// sector:
//
// * one thread a query, 32-bit indices; the chain from the home slot one
//   slot a load (the slots past the home one are mostly in the sector L1
//   already holds; reading the chain four aligned slots a load cost 0.2-0.4
//   us on the sweep's small cells and up to 19 % on its ordered misses),
//   then the value row of the slot that holds the key;
// * cache policy, where the table is larger than a quarter of L2
//   (kernels/hash_probe.py:probe_path): queries are loaded and outputs
//   stored as streams (ld/st .cs, evict-first), the table is read under an
//   L2 evict_last policy (createpolicy + .L2::cache_hint), so the 54 MB of
//   streams at SF 1 push less of the table out of L2 (8 % at SF 1); on
//   tables of a few MB the hints cost up to 6 %, and plain loads serve;
// * value rows of V > 1 lanes are gathered and written by the warp together:
//   lane l of pass u writes element u·32 + l of the warp's 32·V contiguous
//   outputs (coalesced), taking its row's slot by a shuffle; a lane issues
//   all its row loads before its stores.
#include "claim_table.cuh"

namespace {

constexpr int BLOCK = 256;

// HINTS: streams evict-first, the table evict-last
template <bool HINTS>
__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t p = 0;
  if constexpr (HINTS) asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

template <bool HINTS>
__device__ __forceinline__ int ld_keep(const int* p, uint64_t pol) {
  if constexpr (!HINTS) return __ldg(p);
  int v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

template <bool HINTS>
__device__ __forceinline__ float ld_keep(const float* p, uint64_t pol) {
  if constexpr (!HINTS) return __ldg(p);
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

template <bool HINTS>
__device__ __forceinline__ int ld_stream(const int* p) {
  if constexpr (HINTS) return __ldcs(p);
  else return *p;
}

template <bool HINTS>
__device__ __forceinline__ void st_stream(float* p, float v) {
  if constexpr (HINTS) __stcs(p, v);
  else *p = v;
}

template <bool HINTS>
__device__ __forceinline__ void st_stream(bool* p, bool v) {
  if constexpr (HINTS) asm volatile("st.global.cs.u8 [%0], %1;" ::"l"(p), "h"((unsigned short)v));
  else *p = v;
}

// The slot of q on its chain from its home slot h, or -1: the first slot
// that holds q or is EMPTY decides, within max_probes slots.
template <bool HINTS>
__device__ __forceinline__ int resolve(const int* __restrict__ keys, int q, int h, int mask, int max_probes,
                                       uint64_t pol) {
  for (int t = 0; t < max_probes; ++t) {
    const int s = (h + t) & mask;
    const int cur = ld_keep<HINTS>(keys + s, pol);
    if (cur == q) return s;
    if (cur == fp::EMPTY_KEY) return -1;
  }
  return -1;
}

// VT > 0: V = VT lanes; VT = 0: V given at run time.  Every thread of a warp
// takes part in the V > 1 row shuffles, those past n too (their rows are
// not written).
template <int VT, bool HINTS>
__global__ void __launch_bounds__(BLOCK)
hash_probe_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                  const int* __restrict__ qs, float* __restrict__ out_vals,
                  bool* __restrict__ out_found, int n, int C, int v_rt, int max_probes) {
  const uint64_t pol = keep_policy<HINTS>();
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  int s = -1;
  if (i < n) {
    const int q = ld_stream<HINTS>(qs + i);
    s = resolve<HINTS>(keys, q, fp::hash1(q, C), C - 1, max_probes, pol);
    if constexpr (VT == 1) st_stream<HINTS>(out_vals + i, s >= 0 ? ld_keep<HINTS>(vals + s, pol) : 0.0f);
    st_stream<HINTS>(out_found + i, s >= 0);
  }
  if constexpr (VT != 1) {
    const int V = VT > 0 ? VT : v_rt;
    const int lane = threadIdx.x & 31;
    const int wbase = i - lane;  // the warp's first query
    float* out = out_vals + (long long)wbase * V;
    if constexpr (VT > 1) {
      float v[VT];
#pragma unroll
      for (int u = 0; u < VT; ++u) {
        const int j = u * 32 + lane, r = j / VT, c = j - r * VT;
        const int sr = __shfl_sync(fp::FULL_WARP, s, r);
        v[u] = sr >= 0 ? ld_keep<HINTS>(vals + (long long)sr * VT + c, pol) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < VT; ++u) {
        if (wbase + (u * 32 + lane) / VT < n) st_stream<HINTS>(out + u * 32 + lane, v[u]);
      }
    } else {
      for (int u = 0; u < V; ++u) {
        const int j = u * 32 + lane, r = j / V, c = j - r * V;
        const int sr = __shfl_sync(fp::FULL_WARP, s, r);
        if (wbase + r < n) {
          st_stream<HINTS>(out + j, sr >= 0 ? ld_keep<HINTS>(vals + (long long)sr * V + c, pol) : 0.0f);
        }
      }
    }
  }
}

template <int VT>
void launch(void** ptrs, int n, int C, int V, int max_probes, bool hints, cudaStream_t stream) {
  const unsigned grid = (unsigned)(((long long)n + BLOCK - 1) / BLOCK);
  auto kernel = hints ? hash_probe_kernel<VT, true> : hash_probe_kernel<VT, false>;
  kernel<<<grid, BLOCK, 0, stream>>>((const int*)ptrs[0], (const float*)ptrs[1], (const int*)ptrs[2], (float*)ptrs[3],
                                     (bool*)ptrs[4], n, C, V, max_probes);
}

}  // namespace

// ptrs: keys, vals, queries, out_vals, out_found; ints: n, C, V, max_probes,
// hints (n < 2^31 and C a power of two, checked by kernels/hash_probe.py;
// hints as probe_path picks)
extern "C" int hash_probe_launch(void** ptrs, long long* ints, void* stream) {
  const int n = (int)ints[0], C = (int)ints[1], V = (int)ints[2], max_probes = (int)ints[3];
  const bool hints = ints[4] != 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (V) {
    case 1: launch<1>(ptrs, n, C, V, max_probes, hints, st); break;
    case 2: launch<2>(ptrs, n, C, V, max_probes, hints, st); break;
    case 3: launch<3>(ptrs, n, C, V, max_probes, hints, st); break;
    case 4: launch<4>(ptrs, n, C, V, max_probes, hints, st); break;
    case 5: launch<5>(ptrs, n, C, V, max_probes, hints, st); break;
    case 6: launch<6>(ptrs, n, C, V, max_probes, hints, st); break;
    case 7: launch<7>(ptrs, n, C, V, max_probes, hints, st); break;
    case 8: launch<8>(ptrs, n, C, V, max_probes, hints, st); break;
    default: launch<0>(ptrs, n, C, V, max_probes, hints, st); break;
  }
  return (int)cudaGetLastError();
}
