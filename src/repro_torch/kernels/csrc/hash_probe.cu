// Hash probe: batched lookups into an ht_linear table, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/hash_probe.py:hash_probe.
// There the table (keys and values) is pinned in VMEM and each grid step
// probes a 512-query tile: one full-width vector gather and compare a round,
// rounds until every lane of the tile has hit or reached an EMPTY slot, at
// most max_probes (128, the family's build bound).  Its semantic definition
// is repro/kernels/ref.py:hash_probe.  Here one thread owns one query and
// walks its own probe chain, hash1(q) + t mod C, with the fused pipeline's
// resident find (fp::find_hash<0>, fused_pipeline.cuh): a thread stops at
// its own hit or EMPTY slot, so no lane waits for the slowest one of its
// tile and no host round trip decides when the rounds end.  A miss gives a
// zero value row.
//
// What bounds it on an H100: bytes, read as scattered sectors.  Queries
// stream in and value rows and found flags stream out, coalesced; every
// probe is a dependent 4-byte load at a hashed slot (one 32-byte sector) and
// a hit gathers a 4V-byte value row.  At half load most chains end after one
// or two slots.  A 4,194,304-slot V = 1 table (33.5 MB of keys and values)
// fits the 50 MB L2, so after the first touch the scattered loads are served
// from L2.
#include "fused_pipeline.cuh"

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
hash_probe_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                  const int* __restrict__ qs, float* __restrict__ out_vals,
                  bool* __restrict__ out_found, long long n, int C, int V, int max_probes) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const fp::Dict d{keys, nullptr, vals, nullptr, C, 0, V, 0};
  const int s = fp::find_hash<0>(d, qs[i], max_probes);
  float* out = out_vals + i * V;
  if (s >= 0) {
    const float* row = vals + (long long)s * V;
    for (int j = 0; j < V; ++j) out[j] = row[j];
  } else {
    for (int j = 0; j < V; ++j) out[j] = 0.0f;
  }
  out_found[i] = s >= 0;
}

}  // namespace

// ptrs: keys, vals, queries, out_vals, out_found; ints: n, C, V, max_probes
extern "C" int hash_probe_launch(void** ptrs, long long* ints, void* stream) {
  const long long n = ints[0];
  const int C = (int)ints[1], V = (int)ints[2], max_probes = (int)ints[3];
  const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  hash_probe_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)ptrs[0], (const float*)ptrs[1], (const int*)ptrs[2],
      (float*)ptrs[3], (bool*)ptrs[4], n, C, V, max_probes);
  return (int)cudaGetLastError();
}
