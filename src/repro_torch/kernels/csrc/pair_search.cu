// Lexicographic (hi, lo) binary search for Hopper (sm_90a).
//
// Replaces the TPU kernel pair_search_pallas (src/repro/kernels/
// pair_search.py): for each query pair, the left insertion point in a table
// sorted lexicographically by (hi, lo) — ref_pair_search's contract.  Two
// entry points share one kernel:
//   * pair_search — the lower bound of (qhi, qlo);
//   * pair_range  — the lower bounds of (qhi, qlo) and (qhi, qlo + 1) in one
//     launch, the + 1 wrapping in int32 as torch's add does: the start and
//     end of the rows an INL probe matches (core/query.py::_inl_ranges).
//
// What bounds it on the H100: the chain of dependent loads each search
// makes into the table (latency), then the query bytes (8 B in, 4 B out per
// bound).  The table is not streamed: a search touches log2 T rows of it.
//
// Design: the TPU kernel keeps both table planes resident in VMEM.  Here
// each CTA of 128 threads stages a sample of the table into shared memory:
// every step-th (hi, lo) key, step = ceil(T / 2048), at most 2,048 keys
// (16 KB), read by stride straight from the permuted [T, 3] store rows (the
// columns index.key_cols names), so a probe never copies the table.  A
// thread then searches the sample in shared memory (11 steps) and the one
// window of step - 1 rows between two sampled keys in device memory: at
// T = 137,457 that is 7 dependent device loads, not 18; at T <= 2,048 the
// whole table is staged and a search loads nothing more.  The end bound of
// pair_range starts from the start's sample slot and row, as its key is
// the next one up (unless qlo + 1 wraps, when it searches the whole range).
// CTAs of 128 threads spread a few thousand probes over more SMs; the grid
// is capped and loops, so a large batch does not re-stage the sample once
// per 128 queries.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSample = 2048;  // staged keys: 16 KB of shared memory
constexpr int kMaxGrid = 132 * 8;

struct Table {
  const int32_t* hi;
  const int32_t* lo;
  int64_t stride;  // int32 elements between consecutive rows
  int64_t T;
  int64_t step;  // rows between two sampled keys
  int ns;        // sampled keys: rows 0, step, 2 * step, ... < T
};

__device__ __forceinline__ bool less(int32_t ah, int32_t al, int32_t bh,
                                     int32_t bl) {
  return ah < bh || (ah == bh && al < bl);
}

// Lower bound of (h, l) in the table.  Its sample slot (the number of
// sampled keys below it) is searched in [*slot, ns] of the staged sample,
// its row in the window the slot leaves, never below ``floor``; both
// bounds must hold for the true answer.  Leaves the slot in ``*slot``.
__device__ __forceinline__ int64_t lower_bound(const Table& t,
                                               const int32_t* s_hi,
                                               const int32_t* s_lo, int32_t h,
                                               int32_t l, int* slot,
                                               int64_t floor) {
  int a = *slot, b = t.ns;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (less(s_hi[mid], s_lo[mid], h, l)) a = mid + 1; else b = mid;
  }
  *slot = a;
  // rows before the window are below (h, l); the row at its end is not
  int64_t lo = a == 0 ? 0 : (int64_t)(a - 1) * t.step + 1;
  int64_t hi = a == t.ns ? t.T : (int64_t)a * t.step;
  if (lo < floor) lo = floor;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int32_t mh = __ldg(t.hi + mid * t.stride);
    const int32_t ml = __ldg(t.lo + mid * t.stride);
    if (less(mh, ml, h, l)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool Range>
__global__ void __launch_bounds__(kThreads)
pair_search_kernel(Table t, const int32_t* __restrict__ qhi,
                   const int32_t* __restrict__ qlo, int64_t nq,
                   int32_t* __restrict__ starts, int32_t* __restrict__ ends) {
  __shared__ int32_t s_hi[kSample];
  __shared__ int32_t s_lo[kSample];
  for (int j = threadIdx.x; j < t.ns; j += kThreads) {
    const int64_t row = (int64_t)j * t.step * t.stride;
    s_hi[j] = __ldg(t.hi + row);
    s_lo[j] = __ldg(t.lo + row);
  }
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < nq;
       i += (int64_t)gridDim.x * kThreads) {
    const int32_t h = qhi[i];
    const int32_t l = qlo[i];
    int slot = 0;
    const int64_t s = lower_bound(t, s_hi, s_lo, h, l, &slot, 0);
    starts[i] = (int32_t)s;
    if constexpr (Range) {
      const int32_t l1 = (int32_t)((uint32_t)l + 1u);  // wraps like torch's
      int64_t e;
      if (l1 > l) {  // the next key up: at or past the start
        e = lower_bound(t, s_hi, s_lo, h, l1, &slot, s);
      } else {  // qlo = INT32_MAX: (h, INT32_MIN) lies below (h, l)
        int from = 0;
        e = lower_bound(t, s_hi, s_lo, h, l1, &from, 0);
      }
      ends[i] = (int32_t)e;
    }
  }
}

template <bool Range>
int launch(const void* t_hi, const void* t_lo, long long t_stride,
           long long T, const void* qhi, const void* qlo, long long nq,
           void* starts, void* ends, void* stream) {
  Table t;
  t.hi = static_cast<const int32_t*>(t_hi);
  t.lo = static_cast<const int32_t*>(t_lo);
  t.stride = t_stride;
  t.T = T;
  t.step = (T + kSample - 1) / kSample;
  t.ns = (int)((T + t.step - 1) / t.step);
  long long grid = (nq + kThreads - 1) / kThreads;
  if (grid > kMaxGrid) grid = kMaxGrid;
  pair_search_kernel<Range><<<(unsigned)grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const int32_t*>(qhi), static_cast<const int32_t*>(qlo),
      nq, static_cast<int32_t*>(starts), static_cast<int32_t*>(ends));
  return (int)cudaGetLastError();
}

}  // namespace

// t_hi, t_lo: int32 table planes (T >= 1 rows) with ``t_stride`` elements
// between rows; qhi, qlo: contiguous int32[nq], nq >= 1; out: int32[nq].
extern "C" int pair_search(const void* t_hi, const void* t_lo,
                           long long t_stride, long long T, const void* qhi,
                           const void* qlo, long long nq, void* out,
                           void* stream) {
  return launch<false>(t_hi, t_lo, t_stride, T, qhi, qlo, nq, out, nullptr,
                       stream);
}

// pair_search's arguments; starts, ends: int32[nq], the lower bounds of
// (qhi, qlo) and (qhi, qlo + 1).
extern "C" int pair_range(const void* t_hi, const void* t_lo,
                          long long t_stride, long long T, const void* qhi,
                          const void* qlo, long long nq, void* starts,
                          void* ends, void* stream) {
  return launch<true>(t_hi, t_lo, t_stride, T, qhi, qlo, nq, starts, ends,
                      stream);
}
