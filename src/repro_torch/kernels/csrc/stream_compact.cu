// Stable stream compaction for Hopper (sm_90a): two kernels.
//
// 1. compact_lookback — the global compaction of a 0/1 mask in one pass,
//    replacing stream_compact_pallas (src/repro/kernels/stream_compact.py).
//    It writes ops.compact_indices' contract itself: take[r] = the index of
//    the r-th set row for r < min(total, cap), 0 behind; ok[r] = r < total;
//    total = the number of set rows.  Described below, before its code.
//
// 2. compact_tiles — tile-local compaction fused with a predicate,
//    replacing four TPU kernels of the same file:
//   * interval_compact_pallas         (plo <= p < phi && olo <= o < ohi,
//                                      fused with the compaction)
//   * masked_interval_compact_pallas  (the same predicate && alive)
//   * member_compact_pallas           (the rewrite-mode type pattern: the
//                                      subject stream (p == tid && o in mem)
//                                      || p in dom and, if has_rng, the
//                                      object stream p in rng, each && alive
//                                      && s != INVALID, each compacted)
//   * dual_compact_pallas             (two precomputed 0/1 masks over the
//                                      same rows, each compacted into its
//                                      own stream in one pass)
// One templated kernel serves all four: the predicate and the number of
// output streams are template parameters.
//
// Contract (ref_stream_compact), per stream: tile t covers rows
// [t*block, (t+1)*block).  Its output slice local[t*block : (t+1)*block]
// holds the global indices of the tile's matching rows in ascending order,
// INVALID (INT32_MAX) behind them, and counts[t] is the tile's match count.
// Rows >= n are padding and never match, so the caller passes the unpadded
// columns.
//
// What bounds it on the H100: device memory.  Per row it reads two masks
// (2 B), or p and o (4 B each, by stride from the [N, 3]
// store rows), plus alive (1 B) in the masked form, or s, p, o and alive
// (13 B), and writes one int32 of local output per stream: no arithmetic
// to speak of.  The member sets' binary searches run in shared memory.
//
// Design: the TPU body builds a (chunk, chunk) one-hot cube because the TPU
// has no vector scatter.  Here each row is one thread: a warp ballot and a
// popcount give the row's rank inside its warp, a scan of the 16 warp
// counts in shared memory gives the warp's offset inside the 512-row chunk,
// and a running offset carries the chunks of a tile (4096-row tiles take
// eight).  Each matching row then writes its index straight to its slot;
// the tile ends with one pass writing INVALID behind the matches.  Reads of
// consecutive rows by consecutive threads coalesce; s, p and o are read in
// place from the store rows so a scan never copies a column.
//
// The member sets of K4 are sorted and INT32_MAX-padded to a power of two
// (query.py::_pad_set).  Each CTA stages a set of at most kStageMax ids into
// shared memory once, as the TPU keeps them resident in VMEM; a larger set
// (a deep ontology's concept with thousands of subsumees) is searched where
// it lies, in device memory through the read-only cache.  A search is the
// lower bound of the value (log2(K) + 1 steps), as _in_set_tile's is: the
// value is a member iff the slot it lands on holds it and it is not INVALID,
// so an all-padding set matches nothing and INVALID never matches a pad.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kInvalid = 0x7fffffff;
constexpr int kStageMax = 2048;  // ids staged per set: 8 KB of shared memory

// Two masks over the same rows: stream 0 compacts a, stream 1 compacts b.
struct DualMaskPred {
  static constexpr int kStreams = 2;
  const uint8_t* a;
  const uint8_t* b;
  __device__ __forceinline__ void stage(int32_t*) {}
  __device__ __forceinline__ void operator()(int64_t i, bool* hit) const {
    hit[0] = __ldg(a + i) != 0;
    hit[1] = __ldg(b + i) != 0;
  }
};

// plo <= p < phi && olo <= o < ohi, and && alive when Masked.
template <bool Masked>
struct IntervalPred {
  static constexpr int kStreams = 1;
  const int32_t* p;
  const int32_t* o;
  int64_t stride;  // int32 elements between consecutive rows of p and o
  const uint8_t* alive;  // read only when Masked
  int32_t plo, phi, olo, ohi;
  __device__ __forceinline__ void stage(int32_t*) {}
  __device__ __forceinline__ void operator()(int64_t i, bool* hit) const {
    const int32_t pv = __ldg(p + i * stride);
    const int32_t ov = __ldg(o + i * stride);
    bool m = pv >= plo && pv < phi && ov >= olo && ov < ohi;
    if constexpr (Masked) m = m && __ldg(alive + i) != 0;
    hit[0] = m;
  }
};

// A sorted, INT32_MAX-padded id set of k (a power of two) entries.
struct IdSet {
  const int32_t* ids;  // device memory, or shared memory once staged
  int k;

  // Copy the set into shared memory at ``smem`` if it fits; returns the
  // number of int32 slots taken there (0 when it stays in device memory).
  __device__ __forceinline__ int stage(int32_t* smem) {
    if (k > kStageMax) return 0;
    for (int i = threadIdx.x; i < k; i += blockDim.x) smem[i] = __ldg(ids + i);
    ids = smem;
    return k;
  }

  __device__ __forceinline__ bool contains(int32_t v) const {
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ids[mid] < v) lo = mid + 1; else hi = mid;
    }
    const int pos = lo < k ? lo : k - 1;
    return ids[pos] == v && v != kInvalid;
  }
};

template <bool HasDom, bool HasRng>
struct MemberPred {
  static constexpr int kStreams = HasRng ? 2 : 1;
  const int32_t* s;
  const int32_t* p;
  const int32_t* o;
  int64_t stride;  // int32 elements between consecutive rows of s, p, o
  const uint8_t* alive;
  int32_t tid;
  IdSet mem, dom, rng;

  // Run by every thread of the CTA before the first row; a barrier follows.
  __device__ __forceinline__ void stage(int32_t* smem) {
    int used = mem.stage(smem);
    if constexpr (HasDom) used += dom.stage(smem + used);
    if constexpr (HasRng) rng.stage(smem + used);
  }

  __device__ __forceinline__ void operator()(int64_t i, bool* hit) const {
    const int32_t sv = __ldg(s + i * stride);
    const int32_t pv = __ldg(p + i * stride);
    const int32_t ov = __ldg(o + i * stride);
    const bool valid = sv != kInvalid && __ldg(alive + i) != 0;
    bool ms = pv == tid && mem.contains(ov);
    if constexpr (HasDom) ms = ms || dom.contains(pv);
    hit[0] = ms && valid;
    if constexpr (HasRng) hit[1] = valid && rng.contains(pv);
  }
};

template <int NS>
struct Outputs {
  int32_t* local[NS];
  int32_t* counts[NS];
};

template <typename Pred>
__global__ void __launch_bounds__(kThreads)
compact_tiles(Pred pred, int64_t n, int block, Outputs<Pred::kStreams> out) {
  constexpr int NS = Pred::kStreams;
  extern __shared__ int32_t staged[];
  __shared__ int warp_counts[NS][kWarps];
  pred.stage(staged);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile0 = (int64_t)blockIdx.x * block;
  int running[NS];  // matches of this tile's earlier chunks, per stream
#pragma unroll
  for (int st = 0; st < NS; ++st) running[st] = 0;
  for (int c = 0; c < block; c += kThreads) {
    const int j = c + (int)threadIdx.x;
    const int64_t row = tile0 + j;
    bool hit[NS];
#pragma unroll
    for (int st = 0; st < NS; ++st) hit[st] = false;
    if (j < block && row < n) pred(row, hit);
    unsigned ballot[NS];
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      ballot[st] = __ballot_sync(0xffffffffu, hit[st]);
      if (lane == 0) warp_counts[st][warp] = __popc(ballot[st]);
    }
    __syncthreads();
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int v = warp_counts[st][w];
        before += w < warp ? v : 0;
        total += v;
      }
      if (hit[st]) {
        out.local[st][tile0 + running[st] + before +
                      __popc(ballot[st] & ((1u << lane) - 1u))] = (int32_t)row;
      }
      running[st] += total;
    }
    __syncthreads();  // warp_counts is rewritten by the next chunk
  }
#pragma unroll
  for (int st = 0; st < NS; ++st) {
    for (int j = running[st] + (int)threadIdx.x; j < block; j += kThreads) {
      out.local[st][tile0 + j] = kInvalid;
    }
    if (threadIdx.x == 0) out.counts[st][blockIdx.x] = running[st];
  }
}

template <typename Pred>
int launch(const Pred& pred, long long n, int block, int nb,
           Outputs<Pred::kStreams> out, size_t smem_bytes, void* stream) {
  compact_tiles<Pred><<<nb, kThreads, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(pred, n, block,
                                                            out);
  return (int)cudaGetLastError();
}

template <bool HasDom, bool HasRng>
int launch_member(const int32_t* s, const int32_t* p, const int32_t* o,
                  long long stride, const uint8_t* alive, int tid, IdSet mem,
                  IdSet dom, IdSet rng, long long n, int block, int nb,
                  int32_t* local_s, int32_t* counts_s, int32_t* local_o,
                  int32_t* counts_o, void* stream) {
  using Pred = MemberPred<HasDom, HasRng>;
  Pred pred{s, p, o, stride, alive, tid, mem, dom, rng};
  Outputs<Pred::kStreams> out;
  out.local[0] = local_s;
  out.counts[0] = counts_s;
  if constexpr (HasRng) {
    out.local[1] = local_o;
    out.counts[1] = counts_o;
  }
  size_t staged = mem.k <= kStageMax ? mem.k : 0;
  if (HasDom && dom.k <= kStageMax) staged += dom.k;
  if (HasRng && rng.k <= kStageMax) staged += rng.k;
  return launch(pred, n, block, nb, out, staged * sizeof(int32_t), stream);
}

// ---------------------------------------------------------------------------
// compact_lookback: the single-pass global compaction (Merrill & Garland's
// decoupled look-back, the scheme of CUB's DeviceSelect::Flagged).
//
// What bounds it on the H100: device memory — n B of mask read, 4 B of take
// and 1 B of ok written per output slot (cap of each), 4 B of total.
//
// Design: the TPU kernel compacts per tile and leaves the stitch of the
// tiles to ops.py; on Hopper that stitch cost about eighteen small torch
// launches after the kernel.  Here one launch writes the final arrays.
//   * Tiles: 256 threads x 2 chunks x 16 rows = 8,192 rows.  In each
//     4,096-row chunk a thread reads its 16 rows as one aligned 16-byte
//     load; the two loads are in flight together.  The per-chunk counts
//     (each <= 4,096) ride in one 64-bit word of 16-bit fields through one
//     warp scan (__shfl_up_sync) and one scan of the 8 warp totals in
//     shared memory.  After the look-back each chunk's set rows are staged
//     in order in shared memory and written out.  A tile pays a few
//     microseconds of latency (ticket, load, fences, look-back) however
//     few rows it holds, so a tile of one chunk is slow on a sparse mask;
//     a tile of four is slow on a dense run of rows (a store compacted in
//     POS order holds each predicate's rows together), whose write-out it
//     serialises.  Two chunks sit between (PERF.md has the times).
//   * Staging: a thread's 16 rows are consecutive, so on a dense run the
//     32 lanes of a warp write ranks 16 apart; one padding word after
//     every 16 (slot r + r / 16) puts them in 32 different banks.
//   * Order: a tile takes its id from an atomicAdd ticket, not blockIdx, so
//     a CTA waits only on tiles that running CTAs hold: forward progress.
//   * Look-back: one 64-bit status word per tile, the flag (aggregate or
//     inclusive prefix) in the high half and the count in the low half, so
//     a reader never sees one without the other; it is published after
//     __threadfence() with a volatile store.  Warp 0 reads the 32 tiles
//     before its own at a time, waits until each has a flag, and sums the
//     counts back to the nearest inclusive prefix (a ballot finds it).
//   * Writes: each chunk's staged rows go out coalesced to its take/ok
//     slots below cap; the last ticket writes total.
//     take and ok are zeroed by the entry point beforehand (memsets on the
//     same stream), so slots past total read 0 / false.
//   * The predicate is a template parameter (Pred::bits gives the 16 rows'
//     hits of a thread), so a fused scan predicate is one more struct.
// Rows are addressed as virtual rows v = row + shift, shift being the mask
// pointer's offset from a 16-byte boundary (a view such as keep[1:]), so
// every thread's 16 rows are one aligned load; the segments holding the
// ragged head (v < shift) and tail (row >= n) load byte by byte.
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kRowsPerThread = 16;
constexpr int kChunkRows = kScanThreads * kRowsPerThread;  // 4,096
constexpr int kChunks = 2;
constexpr int kTileRows = kChunks * kChunkRows;  // 8,192
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;  // status flags
constexpr unsigned long long kPrefix = 2ull << 32;

// Four mask bytes -> 4 bits (bit k set iff byte k is non-zero).
__device__ __forceinline__ unsigned nibble(unsigned w) {
  const unsigned m = __vcmpne4(w, 0u) & 0x08040201u;
  return (m | m >> 8 | m >> 16 | m >> 24) & 0xfu;
}

struct MaskBits {
  const uint8_t* mask;
  int64_t n;
  int shift;  // virtual rows before row 0
  // Hits of virtual rows v0 .. v0 + 15 (v0 a multiple of 16) as 16 bits.
  __device__ __forceinline__ unsigned bits(int64_t v0) const {
    const int64_t r0 = v0 - shift;
    if (r0 >= 0 && r0 + kRowsPerThread <= n) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(mask + r0));
      return nibble(w.x) | nibble(w.y) << 4 | nibble(w.z) << 8 |
             nibble(w.w) << 12;
    }
    unsigned b = 0;
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int64_t r = r0 + k;
      if (r >= 0 && r < n && __ldg(mask + r) != 0) b |= 1u << k;
    }
    return b;
  }
};

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long v) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(word) = v;
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

// The exclusive prefix of ``tile`` (>= 1), by warp 0: sums the counts of
// the tiles before it back to the nearest inclusive prefix.
__device__ unsigned look_back(const unsigned long long* status, int tile,
                              int lane) {
  unsigned excl = 0;
  for (int last = tile - 1;; last -= 32) {
    const int t = last - lane;
    unsigned long long s = kPrefix;  // before tile 0: a prefix of 0
    do {
      if (t >= 0) s = peek(status + t);
    } while (!__all_sync(kFull, (s >> 32) != 0));
    const unsigned pre = __ballot_sync(kFull, (s >> 32) == (kPrefix >> 32));
    const int stop = pre ? __ffs(pre) - 1 : 31;
    unsigned c = lane <= stop ? (unsigned)s : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(kFull, c, d);
    excl += c;
    if (pre) return excl;
  }
}

template <typename Pred>
__global__ void __launch_bounds__(kScanThreads)
compact_lookback(Pred pred, int64_t nv, int ntiles, int64_t cap,
                 int32_t* __restrict__ take, uint8_t* __restrict__ ok,
                 int32_t* __restrict__ total,
                 unsigned long long* __restrict__ status,
                 unsigned* __restrict__ ticket) {
  __shared__ int32_t s_rows[kChunkRows + kChunkRows / 16];  // padded
  __shared__ unsigned long long s_warp[kScanWarps];
  __shared__ int s_tile;
  __shared__ unsigned s_excl;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base =
      (int64_t)tile * kTileRows + threadIdx.x * kRowsPerThread;
  unsigned bits[kChunks];  // the thread's 16 rows of each chunk
  unsigned long long packed = 0;  // their counts, 16 bits per chunk
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t v0 = base + (int64_t)c * kChunkRows;
    bits[c] = v0 < nv ? pred.bits(v0) : 0u;
    packed |= (unsigned long long)__popc(bits[c]) << (16 * c);
  }
  unsigned long long incl = packed;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned long long before = 0, aggp = 0;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) {
    const unsigned long long x = s_warp[w];
    before += w < warp ? x : 0ull;
    aggp += x;
  }
  const unsigned long long mine = before + incl - packed;  // ranks in chunks
  int agg = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    agg += (int)((aggp >> (16 * c)) & 0xffffu);
  }
  if (warp == 0) {
    unsigned excl = 0;
    if (tile == 0) {
      if (lane == 0) publish(status, kPrefix | (unsigned)agg);
    } else {
      if (lane == 0) publish(status + tile, kAggregate | (unsigned)agg);
      excl = look_back(status, tile, lane);
      if (lane == 0) publish(status + tile, kPrefix | (excl + (unsigned)agg));
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  int64_t start = s_excl;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    int rank = (int)((mine >> (16 * c)) & 0xffffu);
    const int64_t r0 = base + (int64_t)c * kChunkRows - pred.shift;
    unsigned b = bits[c];
    while (b) {
      s_rows[rank + (rank >> 4)] = (int32_t)(r0 + __ffs(b) - 1);
      ++rank;
      b &= b - 1;
    }
    __syncthreads();
    const int tc = (int)((aggp >> (16 * c)) & 0xffffu);
    for (int j = threadIdx.x; j < tc; j += kScanThreads) {
      const int64_t r = start + j;
      if (r < cap) {
        take[r] = s_rows[j + (j >> 4)];
        ok[r] = 1;
      }
    }
    start += tc;
    __syncthreads();  // s_rows takes the next chunk
  }
  if (tile == ntiles - 1 && threadIdx.x == 0) *total = (int32_t)start;
}

template <typename Pred>
int launch_lookback(const Pred& pred, long long nv, long long cap,
                    void* take, void* ok, void* total, void* scratch,
                    long long scratch_words, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = nv > 0 ? (nv + kTileRows - 1) / kTileRows : 1;
  if (tiles + 1 > scratch_words || cap < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(take, 0, (size_t)cap * 4, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(ok, 0, (size_t)cap, st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, (size_t)(tiles + 1) * 8, st);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  compact_lookback<Pred><<<(unsigned)tiles, kScanThreads, 0, st>>>(
      pred, nv, (int)tiles, cap, static_cast<int32_t*>(take),
      static_cast<uint8_t*>(ok), static_cast<int32_t*>(total), words + 1,
      reinterpret_cast<unsigned*>(words));
  return (int)cudaGetLastError();
}

}  // namespace

// mask: uint8[n] (torch.bool), any alignment, n < 2**31; take: int32[cap];
// ok: uint8[cap]; total: int32[1]; scratch: scratch_words >= ceil((n + 15)
// / 8192) + 1 int64 words.
extern "C" int compact_mask(const void* mask, long long n, long long cap,
                            void* take, void* ok, void* total, void* scratch,
                            long long scratch_words, void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int shift = (int)(reinterpret_cast<uintptr_t>(m) & 15);
  MaskBits pred{m, n, shift};
  return launch_lookback(pred, n + shift, cap, take, ok, total, scratch,
                         scratch_words, stream);
}

// p, o: int32 columns with ``stride`` elements between rows (3 for the
// columns of an [N, 3] store); alive: uint8[n] (torch.bool).
extern "C" int masked_interval_compact(const void* p, const void* o,
                                       long long stride, const void* alive,
                                       int plo, int phi, int olo, int ohi,
                                       long long n, int block, int nb,
                                       void* local, void* counts,
                                       void* stream) {
  IntervalPred<true> pred{static_cast<const int32_t*>(p),
                          static_cast<const int32_t*>(o), stride,
                          static_cast<const uint8_t*>(alive),
                          plo, phi, olo, ohi};
  Outputs<1> out{{static_cast<int32_t*>(local)}, {static_cast<int32_t*>(counts)}};
  return launch(pred, n, block, nb, out, 0, stream);
}

// masked_interval_compact without the alive column.
extern "C" int interval_compact(const void* p, const void* o, long long stride,
                                int plo, int phi, int olo, int ohi,
                                long long n, int block, int nb, void* local,
                                void* counts, void* stream) {
  IntervalPred<false> pred{static_cast<const int32_t*>(p),
                           static_cast<const int32_t*>(o), stride, nullptr,
                           plo, phi, olo, ohi};
  Outputs<1> out{{static_cast<int32_t*>(local)}, {static_cast<int32_t*>(counts)}};
  return launch(pred, n, block, nb, out, 0, stream);
}

// mask_a, mask_b: uint8[n] (torch.bool); stream a -> local_a/counts_a,
// stream b -> local_b/counts_b, each int32[nb * block] / int32[nb].
extern "C" int dual_compact(const void* mask_a, const void* mask_b,
                            long long n, int block, int nb, void* local_a,
                            void* counts_a, void* local_b, void* counts_b,
                            void* stream) {
  DualMaskPred pred{static_cast<const uint8_t*>(mask_a),
                    static_cast<const uint8_t*>(mask_b)};
  Outputs<2> out;
  out.local[0] = static_cast<int32_t*>(local_a);
  out.counts[0] = static_cast<int32_t*>(counts_a);
  out.local[1] = static_cast<int32_t*>(local_b);
  out.counts[1] = static_cast<int32_t*>(counts_b);
  return launch(pred, n, block, nb, out, 0, stream);
}

// s, p, o: int32 columns with ``stride`` elements between rows; alive:
// uint8[n] (torch.bool); mem/dom/rng: sorted INT32_MAX-padded int32 sets of
// mem_k/dom_k/rng_k (powers of two) entries.  The object stream
// (local_o/counts_o) is written only when has_rng.
extern "C" int member_compact(const void* s, const void* p, const void* o,
                              long long stride, const void* alive, int tid,
                              const void* mem, int mem_k, const void* dom,
                              int dom_k, const void* rng, int rng_k,
                              int has_dom, int has_rng, long long n, int block,
                              int nb, void* local_s, void* counts_s,
                              void* local_o, void* counts_o, void* stream) {
  const int32_t* sc = static_cast<const int32_t*>(s);
  const int32_t* pc = static_cast<const int32_t*>(p);
  const int32_t* oc = static_cast<const int32_t*>(o);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  IdSet ms{static_cast<const int32_t*>(mem), mem_k};
  IdSet ds{static_cast<const int32_t*>(dom), dom_k};
  IdSet rs{static_cast<const int32_t*>(rng), rng_k};
  int32_t* ls = static_cast<int32_t*>(local_s);
  int32_t* cs = static_cast<int32_t*>(counts_s);
  int32_t* lo = static_cast<int32_t*>(local_o);
  int32_t* co = static_cast<int32_t*>(counts_o);
  if (has_dom && has_rng)
    return launch_member<true, true>(sc, pc, oc, stride, al, tid, ms, ds, rs,
                                     n, block, nb, ls, cs, lo, co, stream);
  if (has_dom)
    return launch_member<true, false>(sc, pc, oc, stride, al, tid, ms, ds, rs,
                                      n, block, nb, ls, cs, lo, co, stream);
  if (has_rng)
    return launch_member<false, true>(sc, pc, oc, stride, al, tid, ms, ds, rs,
                                      n, block, nb, ls, cs, lo, co, stream);
  return launch_member<false, false>(sc, pc, oc, stride, al, tid, ms, ds, rs,
                                     n, block, nb, ls, cs, lo, co, stream);
}
