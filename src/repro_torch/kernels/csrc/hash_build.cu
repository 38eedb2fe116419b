// Hash build: batched insert-aggregate into an empty ht_linear table, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/hash_build.py:hash_build.
// There the table lives in VMEM scratch carried across the sequential grid;
// each step inserts one 1024-row tile in bounded probe rounds, settling
// claims on EMPTY slots by scatter-max arbitration on the row id, re-checking
// losers for the same key and adding the winners' and hitters' values; rows
// still pending after max_probes rounds are dropped.  Its semantic twin is
// dicts/base.py:generic_insert into an empty table.  Blocks of a GPU grid
// run in parallel, so nothing carries between them: the table is in device
// memory, filled with EMPTY keys and zero values by the wrapper, and one
// thread owns one row.  It claims its slot with the fused pipeline's
// accumulator claim (fp::acc_slot<0>, fused_pipeline.cuh): an EMPTY slot is
// taken with atomicCAS, a CAS that loses to the same key joins it, one that
// loses to another key probes on, and past max_probes the row is dropped.
// Slots go from EMPTY to a key once and never back, so every row of a key
// stops at the same slot: the first of its chain that holds the key.  The
// row's sum lanes are then added with atomicAdd; float32 sums fold in the
// order the atomics land, not the reference's.
//
// What bounds it on an H100: bytes, then atomics.  Keys (4 B) and values (4V
// B) stream in once, coalesced; the table (4 + 4V B a slot) is written by
// the fill and the claims.  Every row costs a CAS or a load at a hashed slot
// and V atomicAdds at the same slot; rows of one key serialize on its slot,
// so heavily duplicated inputs are bound by same-address atomics in L2.
#include "fused_pipeline.cuh"

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
hash_build_kernel(const int* __restrict__ ks, const float* __restrict__ vs,
                  const bool* __restrict__ valid, int* tkeys, float* tvals,
                  long long n, int C, int V, int max_probes) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  if (valid != nullptr && !valid[i]) return;
  const int s = fp::acc_slot<0>(tkeys, C, ks[i], max_probes);
  if (s < 0) return;  // dropped after max_probes, as the reference drops it
  const float* row = vs + i * V;
  float* acc = tvals + (long long)s * V;
  for (int j = 0; j < V; ++j) atomicAdd(acc + j, row[j]);
}

}  // namespace

// ptrs: keys, vals, valid (or null), table keys, table vals;
// ints: n, C, V, max_probes
extern "C" int hash_build_launch(void** ptrs, long long* ints, void* stream) {
  const long long n = ints[0];
  const int C = (int)ints[1], V = (int)ints[2], max_probes = (int)ints[3];
  const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  hash_build_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)ptrs[0], (const float*)ptrs[1], (const bool*)ptrs[2],
      (int*)ptrs[3], (float*)ptrs[4], n, C, V, max_probes);
  return (int)cudaGetLastError();
}
