// Grouped most-specific-concept selection for Hopper (sm_90a).
//
// Replaces the TPU kernel msc_select_pallas (src/repro/kernels/
// msc_select.py): conc and bounds are [G, K] candidate concept ids and
// their subsumption bounds, -1 padded.  Slot j of group g is kept iff it is
// valid (conc >= 0), no valid candidate of its group lies strictly inside
// (conc[g, j], bounds[g, j]), and no earlier slot of the group holds the
// same id — ref_msc_select's contract.
//
// What bounds it on the H100: device memory at the K a real dataset has
// (an instance rarely has more than a few dozen candidate types).  Each
// slot is read once (8 B: its id and bound) and writes one byte of keep
// mask; the K^2 compares per group run on shared memory.
//
// Design: the TPU kernel builds a (groups, K, K) bool cube in VMEM.  Here
// one CTA stages a tile of whole groups (max(1, 256 / K) of them) in
// shared memory with coalesced loads, and one thread per (group, slot)
// walks its group's K slots with exactly the reference's comparisons, so
// K is a runtime size with no warp-per-group assumption: K > 256 gives one
// group per CTA and threads loop over its slots.  A group too wide for the
// 48 KB of default shared memory (K > 6,144) is read where it lies.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageSlots = 6144;  // conc + bounds staged: 48 KB

__global__ void __launch_bounds__(kThreads)
msc_select_kernel(const int32_t* __restrict__ conc,
                  const int32_t* __restrict__ bounds, int64_t G, int K,
                  int gpb, int staged, uint8_t* __restrict__ keep) {
  extern __shared__ int32_t smem[];
  const int64_t g0 = (int64_t)blockIdx.x * gpb;
  const int ng = G - g0 < gpb ? (int)(G - g0) : gpb;
  const int slots = ng * K;  // a CTA's slots fit 32 bits: max(K, 256)
  const int32_t* cs = conc + g0 * K;
  const int32_t* bs = bounds + g0 * K;
  if (staged) {
    int32_t* sc = smem;
    int32_t* sb = smem + (int64_t)gpb * K;
    for (int i = threadIdx.x; i < slots; i += kThreads) {
      sc[i] = __ldg(cs + i);
      sb[i] = __ldg(bs + i);
    }
    cs = sc;
    bs = sb;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < slots; idx += kThreads) {
    const int g = idx / K;
    const int j = idx - g * K;
    const int32_t* row = cs + g * K;
    const int32_t c1 = row[j];
    const int32_t b1 = bs[idx];
    bool drop = false;
    for (int k = 0; k < K; ++k) {
      const int32_t c2 = row[k];
      const bool strict_desc = c2 > c1 && c2 < b1;
      const bool dup = c2 == c1 && j > k;
      drop = drop || (c2 >= 0 && (strict_desc || dup));
    }
    keep[g0 * K + idx] = c1 >= 0 && !drop;
  }
}

}  // namespace

// conc, bounds: contiguous int32[G, K]; keep: uint8[G, K] (torch.bool).
// Requires G >= 1 and K >= 1.
extern "C" int msc_select(const void* conc, const void* bounds, long long G,
                          int K, void* keep, void* stream) {
  const int gpb = K >= kThreads ? 1 : kThreads / K;
  const int staged = (long long)gpb * K <= kStageSlots;
  const size_t smem = staged ? 2 * (size_t)gpb * K * sizeof(int32_t) : 0;
  const unsigned grid = (unsigned)((G + gpb - 1) / gpb);
  msc_select_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(conc), static_cast<const int32_t*>(bounds),
      G, K, gpb, staged, static_cast<uint8_t*>(keep));
  return (int)cudaGetLastError();
}
