// LiteMat interval triple filter for Hopper (sm_90a).
//
// Replaces the TPU kernel interval_filter_pallas (src/repro/kernels/
// interval_filter.py): for every row, plo <= p < phi && olo <= o < ohi —
// ref_interval_filter's contract, with no compaction.
//
// What bounds it on the H100: device memory.  Per row it reads p and o
// (4 B each) and writes one byte of mask: 9 B, no arithmetic to speak of.
//
// Design: the TPU kernel streams block-sized column tiles through VMEM and
// stores an int32 mask, the TPU's natural store width.  Here one thread
// owns one row and writes the bool mask (torch.bool, one byte) that the
// ops wrapper returns, so no int32 mask is written and cast afterwards.
// p and o are read by stride straight from the [N, 3] store rows, as the
// compaction kernels read them; the four bounds are runtime arguments, so
// a new query's constants launch the same kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
interval_filter_kernel(const int32_t* __restrict__ p,
                       const int32_t* __restrict__ o, int64_t stride,
                       int64_t n, int32_t plo, int32_t phi, int32_t olo,
                       int32_t ohi, uint8_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t pv = __ldg(p + i * stride);
  const int32_t ov = __ldg(o + i * stride);
  out[i] = pv >= plo && pv < phi && ov >= olo && ov < ohi;
}

}  // namespace

// p, o: int32 columns with ``stride`` elements between rows; out: uint8[n]
// (torch.bool).  Requires n >= 1.
extern "C" int interval_filter(const void* p, const void* o, long long stride,
                               int plo, int phi, int olo, int ohi,
                               long long n, void* out, void* stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  interval_filter_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(p), static_cast<const int32_t*>(o), stride,
      n, plo, phi, olo, ohi, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
