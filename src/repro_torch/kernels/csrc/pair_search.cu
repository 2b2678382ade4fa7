// Lexicographic (hi, lo) binary search for Hopper (sm_90a).
//
// Replaces the TPU kernel pair_search_pallas (src/repro/kernels/
// pair_search.py): for each query pair, the left insertion point in a table
// sorted lexicographically by (hi, lo) — ref_pair_search's contract.
//
// What bounds it on the H100: the chain of ceil(log2 T) + 1 dependent loads
// each query makes into the table (latency), then the query bytes (8 B in,
// 4 B out).  The table is not streamed: a search touches log2 T rows of it.
//
// Design: the TPU kernel keeps both table planes resident in VMEM and walks
// all queries of a block in lock step.  Here one thread owns one query and
// binary-searches the table in device memory; thousands of independent
// searches in flight hide each other's load latency, and the top levels of
// every search hit the same rows, which stay in L1/L2.  The key planes are
// read by stride straight from the permuted [T, 3] store rows (the columns
// index.key_cols names), so a probe never copies the table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pair_search_kernel(const int32_t* __restrict__ t_hi,
                   const int32_t* __restrict__ t_lo, int64_t t_stride,
                   int64_t T, const int32_t* __restrict__ qhi,
                   const int32_t* __restrict__ qlo, int64_t nq,
                   int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nq) return;
  const int32_t h = qhi[i];
  const int32_t l = qlo[i];
  int64_t lo = 0, hi = T;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int32_t mh = __ldg(t_hi + mid * t_stride);
    const int32_t ml = __ldg(t_lo + mid * t_stride);
    if (mh < h || (mh == h && ml < l)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[i] = (int32_t)lo;
}

}  // namespace

// t_hi, t_lo: int32 table planes with ``t_stride`` elements between rows;
// qhi, qlo: contiguous int32[nq]; out: int32[nq].  Requires nq >= 1.
extern "C" int pair_search(const void* t_hi, const void* t_lo,
                           long long t_stride, long long T, const void* qhi,
                           const void* qlo, long long nq, void* out,
                           void* stream) {
  const unsigned grid = (unsigned)((nq + kThreads - 1) / kThreads);
  pair_search_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(t_hi), static_cast<const int32_t*>(t_lo),
      t_stride, T, static_cast<const int32_t*>(qhi),
      static_cast<const int32_t*>(qlo), nq, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
