// Tile-local stable stream compaction for Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/stream_compact.py:
//   * stream_compact_pallas           (compaction of a precomputed 0/1 mask)
//   * masked_interval_compact_pallas  (plo <= p < phi && olo <= o < ohi &&
//                                      alive, fused with the compaction)
// One templated kernel serves both; the predicate is the template parameter.
//
// Contract (ref_stream_compact): tile t covers rows [t*block, (t+1)*block).
// Its output slice local[t*block : (t+1)*block] holds the global indices of
// the tile's matching rows in ascending order, INVALID (INT32_MAX) behind
// them, and counts[t] is the tile's match count.  Rows >= n are padding and
// never match, so the caller passes the unpadded columns.
//
// What bounds it on the H100: device memory.  Per row it reads the mask
// (1 B), or p and o (4 B each, by stride from the [N, 3] store rows) plus
// alive (1 B), and writes one int32 of local output: 5 B or 13 B a row, no
// arithmetic to speak of.
//
// Design: the TPU body builds a (chunk, chunk) one-hot cube because the TPU
// has no vector scatter.  Here each row is one thread: a warp ballot and a
// popcount give the row's rank inside its warp, a scan of the 16 warp
// counts in shared memory gives the warp's offset inside the 512-row chunk,
// and a running offset carries the chunks of a tile (4096-row tiles take
// eight).  Each matching row then writes its index straight to its slot;
// the tile ends with one pass writing INVALID behind the matches.  Reads of
// consecutive rows by consecutive threads coalesce; p and o are read in
// place from the store rows so a scan never copies a column.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kInvalid = 0x7fffffff;

struct MaskPred {
  const uint8_t* mask;
  __device__ __forceinline__ bool operator()(int64_t i) const {
    return __ldg(mask + i) != 0;
  }
};

struct MaskedIntervalPred {
  const int32_t* p;
  const int32_t* o;
  int64_t stride;  // int32 elements between consecutive rows of p and o
  const uint8_t* alive;
  int32_t plo, phi, olo, ohi;
  __device__ __forceinline__ bool operator()(int64_t i) const {
    const int32_t pv = __ldg(p + i * stride);
    const int32_t ov = __ldg(o + i * stride);
    return pv >= plo && pv < phi && ov >= olo && ov < ohi &&
           __ldg(alive + i) != 0;
  }
};

template <typename Pred>
__global__ void __launch_bounds__(kThreads)
compact_tiles(Pred pred, int64_t n, int block, int32_t* local,
              int32_t* counts) {
  __shared__ int warp_counts[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile0 = (int64_t)blockIdx.x * block;
  int32_t* out = local + tile0;
  int running = 0;  // matches of this tile's earlier chunks
  for (int c = 0; c < block; c += kThreads) {
    const int j = c + (int)threadIdx.x;
    const int64_t row = tile0 + j;
    const bool hit = j < block && row < n && pred(row);
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = warp_counts[w];
      before += w < warp ? v : 0;
      total += v;
    }
    if (hit) {
      out[running + before + __popc(ballot & ((1u << lane) - 1u))] =
          (int32_t)row;
    }
    running += total;
    __syncthreads();  // warp_counts is rewritten by the next chunk
  }
  for (int j = running + (int)threadIdx.x; j < block; j += kThreads) {
    out[j] = kInvalid;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = running;
}

}  // namespace

// mask: uint8[n] (torch.bool); local: int32[nb * block]; counts: int32[nb].
extern "C" int stream_compact_mask(const void* mask, long long n, int block,
                                   int nb, void* local, void* counts,
                                   void* stream) {
  MaskPred pred{static_cast<const uint8_t*>(mask)};
  compact_tiles<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pred, n, block, static_cast<int32_t*>(local),
      static_cast<int32_t*>(counts));
  return (int)cudaGetLastError();
}

// p, o: int32 columns with ``stride`` elements between rows (3 for the
// columns of an [N, 3] store); alive: uint8[n] (torch.bool).
extern "C" int masked_interval_compact(const void* p, const void* o,
                                       long long stride, const void* alive,
                                       int plo, int phi, int olo, int ohi,
                                       long long n, int block, int nb,
                                       void* local, void* counts,
                                       void* stream) {
  MaskedIntervalPred pred{static_cast<const int32_t*>(p),
                          static_cast<const int32_t*>(o), stride,
                          static_cast<const uint8_t*>(alive),
                          plo, phi, olo, ohi};
  compact_tiles<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pred, n, block, static_cast<int32_t*>(local),
      static_cast<int32_t*>(counts));
  return (int)cudaGetLastError();
}
