// Merge-path gather map of two lex-sorted (hi, lo) runs, for Hopper (sm_90a).
//
// Replaces both TPU kernels of src/repro/kernels/merge_sorted.py:
//   * merge_path_partitioned_pallas (with _diag_splits), the branch
//     ops.merge_gather takes when both runs reach ``block`` rows — the one
//     pair_search_windowed runs for every INL probe of a table past
//     INL_RESIDENT_MAX rows;
//   * merge_path_pallas, the branch for a run shorter than ``block``.
// Contract (ref_merge_sorted): out[i] < n means merged slot i holds A[out[i]];
// out[i] >= n means it holds B[out[i] - n]; equal keys place A first.
//
// What bounds it on the H100: device memory.  Every key of both runs is read
// once (8 B) and every slot of the map written once (4 B): 12 B per merged
// row.  The searches are a log2(block) loop over shared memory per slot.
//
// Design: step 1 (diag_splits) binary-searches the merge path once per tile
// boundary diagonal in device memory — the TPU's _diag_splits, one thread
// per boundary.  Step 2 (merge_tiles) gives each CTA one tile of ``block``
// output slots: it copies the tile's A run [a0, a1) and B run [b0, b1) —
// each at most ``block`` long — into shared memory, then every thread
// places its slots with a merge-path search local to the tile.  The TPU
// kernel needs both runs >= block only because its DMA windows have a fixed
// length; here a CTA copies exactly its runs, so one kernel serves both of
// ops.merge_gather's branches.  Keys are read by stride, so the table side
// can be two columns of the permuted [T, 3] store rows without a copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlock = 1024;  // shared-memory window per run and plane

struct Keys {
  const int32_t* hi;
  const int32_t* lo;
  int64_t stride;  // int32 elements between consecutive keys
  __device__ __forceinline__ int32_t h(int64_t i) const {
    return __ldg(hi + i * stride);
  }
  __device__ __forceinline__ int32_t l(int64_t i) const {
    return __ldg(lo + i * stride);
  }
};

__device__ __forceinline__ bool le_pair(int32_t ah, int32_t al, int32_t bh,
                                        int32_t bl) {
  return ah < bh || (ah == bh && al <= bl);
}

// A-side split of diagonal d: the smallest ia in [max(0, d-m), min(d, n)]
// with NOT (A[ia] <= B[d-ia-1]) — ties resolve A before B.
__global__ void __launch_bounds__(kThreads)
diag_splits(Keys a, int64_t n, Keys b, int64_t m, int block, int64_t nb,
            int64_t* splits) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t > nb) return;
  const int64_t d = t * block < n + m ? t * block : n + m;
  int64_t lo = d - m > 0 ? d - m : 0;
  int64_t hi = d < n ? d : n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int64_t jb = d - mid - 1;
    if (le_pair(a.h(mid), a.l(mid), b.h(jb), b.l(jb))) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  splits[t] = lo;
}

__global__ void __launch_bounds__(kThreads)
merge_tiles(Keys a, int64_t n, Keys b, int64_t m, int block,
            const int64_t* __restrict__ splits, int32_t* __restrict__ out) {
  __shared__ int32_t wa_hi[kMaxBlock], wa_lo[kMaxBlock];
  __shared__ int32_t wb_hi[kMaxBlock], wb_lo[kMaxBlock];
  const int64_t t = blockIdx.x;
  const int64_t a0 = splits[t];
  const int64_t a1 = splits[t + 1];
  const int64_t d0 = t * block;
  const int64_t d1 = d0 + block < n + m ? d0 + block : n + m;
  const int64_t b0 = d0 - a0;
  const int len_a = (int)(a1 - a0);
  const int len_b = (int)(d1 - d0) - len_a;
  for (int j = threadIdx.x; j < len_a; j += kThreads) {
    wa_hi[j] = a.h(a0 + j);
    wa_lo[j] = a.l(a0 + j);
  }
  for (int j = threadIdx.x; j < len_b; j += kThreads) {
    wb_hi[j] = b.h(b0 + j);
    wb_lo[j] = b.l(b0 + j);
  }
  __syncthreads();
  const int count = (int)(d1 - d0);
  for (int j = threadIdx.x; j < count; j += kThreads) {
    int lo = j - len_b > 0 ? j - len_b : 0;
    int hi = j < len_a ? j : len_a;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int jb = j - mid - 1;
      if (le_pair(wa_hi[mid], wa_lo[mid], wb_hi[jb], wb_lo[jb])) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int ia = lo;
    const int ib = j - ia;
    const bool take_a =
        ia < len_a &&
        (ib >= len_b || le_pair(wa_hi[ia], wa_lo[ia], wb_hi[ib], wb_lo[ib]));
    out[d0 + j] = take_a ? (int32_t)(a0 + ia) : (int32_t)(n + b0 + ib);
  }
}

}  // namespace

// A, B: int32 key planes with their strides; splits: int64[nb + 1] scratch
// with nb = ceil((n + m) / block); out: int32[n + m].  Requires n + m >= 1
// and 1 <= block <= 1024.
extern "C" int merge_path(const void* a_hi, const void* a_lo,
                          long long a_stride, long long n, const void* b_hi,
                          const void* b_lo, long long b_stride, long long m,
                          int block, void* splits, void* out, void* stream) {
  if (block < 1 || block > kMaxBlock) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Keys a{static_cast<const int32_t*>(a_hi),
               static_cast<const int32_t*>(a_lo), a_stride};
  const Keys b{static_cast<const int32_t*>(b_hi),
               static_cast<const int32_t*>(b_lo), b_stride};
  const int64_t nb = (n + m + block - 1) / block;
  int64_t* sp = static_cast<int64_t*>(splits);
  diag_splits<<<(unsigned)((nb + kThreads) / kThreads), kThreads, 0, s>>>(
      a, n, b, m, block, nb, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_tiles<<<(unsigned)nb, kThreads, 0, s>>>(a, n, b, m, block, sp,
                                                static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
