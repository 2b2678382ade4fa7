// RDFS closure expansion through the prefix encoding, for Hopper (sm_90a).
//
// Replaces the TPU kernel closure_expand_pallas (src/repro/kernels/
// closure_expand.py): for each query concept id, the lower bound of the id
// in sorted_ids (clipped to the last slot) and, where that slot holds the
// id, its row of anc_table[C, D]; a miss gives a row of -1 —
// ref_closure_expand's contract.
//
// What bounds it on the H100: device memory.  Per query it reads one id
// (4 B) and writes a D-wide row (4 D B); the searches run in shared memory
// and the ancestor table (C rows) stays in L1/L2.
//
// Design: the TPU kernel keeps sorted_ids and anc_table resident in VMEM
// and walks a block of queries in lock step.  Here each CTA stages
// sorted_ids in shared memory once when it fits (at most kStageMax ids, as
// the member sets of stream_compact.cu are staged) and searches device
// memory through the read-only cache when it does not.  A CTA is
// persistent over 256-query tiles: one thread per query searches and
// leaves its ancestor row number (or -1) in shared memory; then the
// threads copy the tile's [256, D] output, consecutive threads on
// consecutive d of the same rows, so the writes of the whole tile are one
// contiguous, coalesced stretch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageMax = 8192;  // sorted ids staged per CTA: 32 KB
constexpr int kMaxGrid = 1024;   // persistent CTAs: about 8 per SM

__global__ void __launch_bounds__(kThreads)
closure_expand_kernel(const int32_t* __restrict__ conc, int64_t n,
                      const int32_t* __restrict__ ids, int C, int staged,
                      const int32_t* __restrict__ anc, int D,
                      int32_t* __restrict__ out) {
  extern __shared__ int32_t staged_ids[];
  __shared__ int row_of[kThreads];  // ancestor row per query; -1 = a miss
  const int32_t* sid = ids;
  if (staged) {
    for (int i = threadIdx.x; i < C; i += kThreads) staged_ids[i] = __ldg(ids + i);
    sid = staged_ids;
  }
  __syncthreads();
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t r0 = t * kThreads;
    const int64_t q = r0 + threadIdx.x;
    if (q < n) {
      const int32_t v = __ldg(conc + q);
      int lo = 0, hi = C;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sid[mid] < v) lo = mid + 1; else hi = mid;
      }
      const int pos = lo < C ? lo : C - 1;
      row_of[threadIdx.x] = sid[pos] == v ? pos : -1;
    }
    __syncthreads();
    // offsets inside a tile fit 32 bits: no 64-bit division per element
    const int rows = n - r0 < kThreads ? (int)(n - r0) : kThreads;
    const int total = rows * D;
    int32_t* dst = out + r0 * D;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int r = e / D;
      const int pos = row_of[r];
      dst[e] = pos >= 0 ? __ldg(anc + (int64_t)pos * D + (e - r * D)) : -1;
    }
    __syncthreads();  // row_of is rewritten by the next tile
  }
}

}  // namespace

// conc: contiguous int32[n]; ids: sorted int32[C]; anc: contiguous
// int32[C, D]; out: int32[n, D].  Requires n, C and D >= 1, and
// 256 * D < 2^31.
extern "C" int closure_expand(const void* conc, long long n, const void* ids,
                              int C, const void* anc, int D, void* out,
                              void* stream) {
  const int staged = C <= kStageMax;
  const size_t smem = staged ? (size_t)C * sizeof(int32_t) : 0;
  const long long tiles = (n + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(tiles < kMaxGrid ? tiles : kMaxGrid);
  closure_expand_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(conc), n, static_cast<const int32_t*>(ids),
      C, staged, static_cast<const int32_t*>(anc), D,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
