// Stable stream compaction for Hopper (sm_90a): two kernels.
//
// 1. compact_lookback — a global compaction in one pass, fused with a
//    predicate, that writes ops' contract itself, per output stream:
//    take[r] = the index of the r-th matching row for r < min(total, cap),
//    0 behind; ok[r] = r < total; total = the number of matching rows.
//    Described below, before its code.  Four TPU kernels of
//    src/repro/kernels/stream_compact.py become its predicates:
//   * stream_compact_pallas           (MaskBits<1>: a precomputed 0/1 mask)
//   * dual_compact_pallas             (MaskBits<2>: two precomputed 0/1
//                                      masks over the same rows, each
//                                      compacted into its own stream)
//   * masked_interval_compact_pallas  (IntervalPred<true>: plo <= p < phi
//                                      && olo <= o < ohi && alive)
//   * member_compact_pallas           (MemberPred: the rewrite-mode type
//                                      pattern: the subject stream (p ==
//                                      tid && o in mem) || p in dom and, if
//                                      has_rng, the object stream p in rng,
//                                      each && alive && s != INVALID)
//    The first also runs with a member axis — what jax.vmap of the TPU
//    kernel computes: B compactions of one shape and one cap in one
//    launch, one CTA per (member, tile), each member with its own
//    look-back state (compact_mask_batched: B masks).
//
// 2. compact_lookback_group — the third and fourth over a member axis
//    whose members share one store (masked_interval_compact_batched: B
//    bounds; member_compact_batched: B member sets): one CTA per (group,
//    tile), a group being up to kGroup members, reads the tile's rows once
//    and compacts them for every member of its group, so a batch of B
//    reads the store ceil(B / kGroup) times.  Described before its code.
//
// 3. compact_tiles — tile-local compaction fused with a predicate,
//    replacing one TPU kernel of the same file:
//   * interval_compact_pallas         (IntervalPred<false>: the interval
//                                      predicate without alive)
//    Contract (ref_stream_compact): tile t covers rows [t*block,
//    (t+1)*block).  Its output slice local[t*block : (t+1)*block] holds
//    the global indices of the tile's matching rows in ascending order,
//    INVALID (INT32_MAX) behind them, and counts[t] is the tile's match
//    count; kernels/ops.py stitches the tiles.  Rows >= n are padding and
//    never match, so the caller passes the unpadded columns.
//
// What bounds both on the H100: device memory.  Per row they read a mask
// (1 B per stream), or p and o (by stride from the [N, 3] store rows, so
// every 32-byte sector of the rows: 12 B) plus alive (1 B), or s, p, o and
// alive (13 B); no arithmetic to speak of.  The member sets are read from
// shared memory.
//
// compact_tiles' design: the TPU body builds a (chunk, chunk) one-hot cube
// because the TPU has no vector scatter.  Here each row is one thread: a
// warp ballot and a popcount give the row's rank inside its warp, a scan of
// the 16 warp counts in shared memory gives the warp's offset inside the
// 512-row chunk, and a running offset carries the chunks of a tile.  Each
// matching row then writes its index straight to its slot; the tile ends
// with one pass writing INVALID behind the matches.
//
// The member sets of K4 are sorted and INT32_MAX-padded to a power of two
// (query.py::_pad_set).  Each CTA stages a set of at most kStageMax ids into
// shared memory once, as the TPU keeps them resident in VMEM; a larger set
// (a deep ontology's concept with thousands of subsumees) is searched where
// it lies, in device memory.  IdSet::contains_batch keeps _in_set_tile's
// contract: a value is a member iff the set holds it and it is not INVALID,
// so an all-padding set matches nothing and INVALID never matches a pad.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

// Opts a kernel into ``bytes`` of dynamic shared memory on the calling
// thread's current device, once per device: the attribute belongs to the
// device and is shared by the process's threads, so it is set once to the
// most any launch takes and never lowered under another thread's launch.
// One object per kernel.
struct SmemOptIn {
  static constexpr int kMaxDevices = 64;
  std::once_flag once[kMaxDevices];
  cudaError_t result[kMaxDevices] = {};

  template <class K>
  cudaError_t operator()(K kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::call_once(once[dev], [&] {
      result[dev] = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    });
    return result[dev];
  }
};

constexpr int kThreads = 512;  // compact_tiles' CTA
constexpr int kWarps = kThreads / 32;
constexpr int32_t kInvalid = 0x7fffffff;
constexpr int kStageMax = 2048;  // ids staged per set: 8 KB of shared memory
constexpr int kLinearMax = 16;  // sets up to this many slots: no search
constexpr unsigned kFull = 0xffffffffu;

// compact_lookback's tile (described before its code): 256 threads x 2
// chunks x 16 rows, a warp's 16-row groups covering 512 consecutive rows.
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kRowsPerThread = 16;
constexpr int kWarpRows = 32 * kRowsPerThread;  // 512
constexpr int kChunkRows = kScanThreads * kRowsPerThread;  // 4,096
constexpr int kChunks = 2;
constexpr int kTileRows = kChunks * kChunkRows;  // 8,192
constexpr int kBatch = 8;  // warp_bits' steps in flight at once

// Four mask bytes -> 4 bits (bit k set iff byte k is non-zero).
__device__ __forceinline__ unsigned nibble(unsigned w) {
  const unsigned m = __vcmpne4(w, 0u) & 0x08040201u;
  return (m | m >> 8 | m >> 16 | m >> 24) & 0xfu;
}

// Bits of rows r0 .. r0 + 15 (r0 >= 0) of a 0/1 byte column that are set
// and < n: one 16-byte load where the rows are whole and aligned, else
// byte by byte.
__device__ __forceinline__ unsigned mask16(const uint8_t* m, int64_t r0,
                                           int64_t n) {
  const uint8_t* a = m + r0;
  if (r0 + kRowsPerThread <= n && (reinterpret_cast<uintptr_t>(a) & 15) == 0) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(a));
    return nibble(w.x) | nibble(w.y) << 4 | nibble(w.z) << 8 |
           nibble(w.w) << 12;
  }
  unsigned h = 0;
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (r0 + k < n && __ldg(a + k) != 0) h |= 1u << k;
  }
  return h;
}

// Bits of rows r0 .. r0 + 15 (any r0) of a 0/1 byte column at any
// alignment that are set and lie in [0, n).  Whole rows off a 16-byte
// boundary are read as the two aligned 16-byte words that hold them (32
// bits, shifted by the offset): both lie in the 16-byte blocks of the
// rows, so no load leaves the column's pages.  Whole aligned rows take
// mask16's one load; the ragged head and tail go byte by byte.
__device__ __forceinline__ unsigned mask16_any(const uint8_t* m, int64_t r0,
                                               int64_t n) {
  if (r0 < 0 || r0 + kRowsPerThread > n) {
    unsigned h = 0;
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int64_t r = r0 + k;
      if (r >= 0 && r < n && __ldg(m + r) != 0) h |= 1u << k;
    }
    return h;
  }
  const int off = (int)(reinterpret_cast<uintptr_t>(m + r0) & 15);
  if (off == 0) return mask16(m, r0, n);
  const uint4* w = reinterpret_cast<const uint4*>(m + r0 - off);
  const uint4 lo = __ldg(w), hi = __ldg(w + 1);
  const unsigned all = nibble(lo.x) | nibble(lo.y) << 4 | nibble(lo.z) << 8 |
                       nibble(lo.w) << 12 | nibble(hi.x) << 16 |
                       nibble(hi.y) << 20 | nibble(hi.z) << 24 |
                       nibble(hi.w) << 28;
  return (all >> off) & 0xffffu;
}

// The hits of a lane's 16 rows v0 .. v0 + 15, per stream, for a predicate
// over strided columns ANDed with alive; called by all 32 lanes of a warp
// together, v0 being the warp's first row w0 (< n) plus 16 * lane.  Read
// row by row, a lane's 16 rows would put the warp's 32 loads of one
// instruction into 32 separate 192-byte spans of an [N, 3] store.  Instead,
// in step k the warp reads rows w0 + 32k .. w0 + 32k + 31, one per lane (a
// coalesced load of each column).  The steps go in batches of kBatch: the
// loads of a batch are issued before any is used, so a warp keeps kBatch
// in flight per column (all 16 at once took more registers and ran slower
// on K2, PERF.md).  The predicate tests a batch's rows
// together (Pred::test: bit k for the batch's step k), one ballot per step
// and stream gathers the warp's hits, and lane l keeps the half-word of
// step l / 2 that holds its own rows 16l .. 16l + 15.  alive is read for
// the lane's own rows (mask16), which also drops rows >= n; a row past the
// end reads row n - 1 in its step.
template <typename Pred>
__device__ __forceinline__ void warp_bits(const Pred& pred, int64_t v0,
                                          unsigned* b) {
  constexpr int NS = Pred::kStreams;
  const int lane = threadIdx.x & 31;
  const int64_t w0 = v0 - kRowsPerThread * lane;
#pragma unroll
  for (int st = 0; st < NS; ++st) b[st] = 0u;
#pragma unroll
  for (int h = 0; h < kRowsPerThread; h += kBatch) {
    typename Pred::Rows rows;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int64_t i = w0 + 32 * (h + k) + lane;
      pred.load(rows, k, i < pred.n ? i : pred.n - 1);
    }
    unsigned hits[NS];
    pred.test(rows, hits);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        const unsigned w = __ballot_sync(kFull, (hits[st] >> k) & 1u);
        if ((lane >> 1) == h + k) b[st] = (lane & 1) ? w >> 16 : w & 0xffffu;
      }
    }
  }
  const unsigned live = mask16(pred.alive, v0, pred.n);
#pragma unroll
  for (int st = 0; st < NS; ++st) b[st] &= live;
}

// plo <= p < phi && olo <= o < ohi, and && alive when Masked.  compact_tiles
// tests it row by row (K8); compact_lookback 16 rows a lane (K2, Masked).
template <bool Masked>
struct IntervalPred {
  static constexpr int kStreams = 1;
  static constexpr int shift = 0;  // rows are not shifted (see MaskBits)
  const int32_t* p;
  const int32_t* o;
  int64_t stride;  // int32 elements between consecutive rows of p and o
  const uint8_t* alive;  // read only when Masked
  int32_t plo, phi, olo, ohi;
  int64_t n;
  __device__ __forceinline__ void stage(int32_t*) {}
  __device__ __forceinline__ bool in_range(int32_t pv, int32_t ov) const {
    return pv >= plo && pv < phi && ov >= olo && ov < ohi;
  }
  // Row by row, for compact_tiles (K8).
  __device__ __forceinline__ bool operator()(int64_t i) const {
    static_assert(!Masked, "compact_tiles takes the predicate without alive");
    return in_range(__ldg(p + i * stride), __ldg(o + i * stride));
  }

  struct Rows {
    int32_t p[kBatch], o[kBatch];
  };
  __device__ __forceinline__ void load(Rows& r, int k, int64_t i) const {
    r.p[k] = __ldg(p + i * stride);
    r.o[k] = __ldg(o + i * stride);
  }
  __device__ __forceinline__ void test(const Rows& r, unsigned* hits) const {
    unsigned h = 0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      h |= (unsigned)in_range(r.p[k], r.o[k]) << k;
    }
    hits[0] = h;
  }
  __device__ __forceinline__ void bits(int64_t v0, unsigned* b) const {
    warp_bits(*this, v0, b);
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

  // Bit j set iff v[j] is a member (want's bits only), for kBatch values
  // at once.  A set of at most kLinearMax slots (a rewrite's domain and
  // range sets hold a few predicates) is compared member by member up to
  // its first padding slot, each member read once for the batch.  A larger
  // one takes a branch-free search of log2(k) steps for the last slot <=
  // v, the searches interleaved step by step so their loads overlap; a
  // member lands on itself.  INVALID is never a member, so an all-padding
  // set matches nothing (_in_set_tile's contract).
  __device__ __forceinline__ unsigned contains_batch(const int32_t* v,
                                                     unsigned want) const {
    if (k <= kLinearMax) {
      unsigned m = 0;
      for (int j = 0; j < k; ++j) {
        const int32_t e = ids[j];
        if (e == kInvalid) break;  // sorted: padding only from here
#pragma unroll
        for (int r = 0; r < kBatch; ++r) m |= (unsigned)(v[r] == e) << r;
      }
      return m & want;
    }
    int pos[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) pos[j] = 0;
    for (int step = k >> 1; step > 0; step >>= 1) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        pos[j] += ids[pos[j] + step] <= v[j] ? step : 0;
      }
    }
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      m |= (unsigned)(ids[pos[j]] == v[j] && v[j] != kInvalid) << j;
    }
    return m & want;
  }
};

// K4: stream 0 the subject stream, stream 1 (HasRng) the object stream.
template <bool HasDom, bool HasRng>
struct MemberPred {
  static constexpr int kStreams = HasRng ? 2 : 1;
  static constexpr int shift = 0;
  const int32_t* s;
  const int32_t* p;
  const int32_t* o;
  int64_t stride;  // int32 elements between consecutive rows of s, p, o
  const uint8_t* alive;
  int32_t tid;
  IdSet mem, dom, rng;
  int64_t n;

  // Run by every thread of the CTA before the first row; a barrier
  // follows.
  __device__ __forceinline__ void stage(int32_t* smem) {
    int used = mem.stage(smem);
    if constexpr (HasDom) used += dom.stage(smem + used);
    if constexpr (HasRng) rng.stage(smem + used);
  }

  struct Rows {
    int32_t s[kBatch], p[kBatch], o[kBatch];
  };
  __device__ __forceinline__ void load(Rows& r, int k, int64_t i) const {
    r.s[k] = __ldg(s + i * stride);
    r.p[k] = __ldg(p + i * stride);
    r.o[k] = __ldg(o + i * stride);
  }
  // mem is searched only for the rows with p == tid, and not at all when
  // none of the batch has it (the common case).
  __device__ __forceinline__ void test(const Rows& r, unsigned* hits) const {
    unsigned valid = 0, typed = 0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      valid |= (unsigned)(r.s[k] != kInvalid) << k;
      typed |= (unsigned)(r.p[k] == tid) << k;
    }
    unsigned ms = typed ? mem.contains_batch(r.o, typed) : 0u;
    if constexpr (HasDom) ms |= dom.contains_batch(r.p, ~0u);
    hits[0] = ms & valid;
    if constexpr (HasRng) hits[1] = rng.contains_batch(r.p, ~0u) & valid;
  }
  __device__ __forceinline__ void bits(int64_t v0, unsigned* b) const {
    warp_bits(*this, v0, b);
  }

  // Shared memory ``stage`` takes, in bytes (one member's sets).
  size_t staged_bytes() const {
    size_t k = mem.k <= kStageMax ? mem.k : 0;
    if (HasDom && dom.k <= kStageMax) k += dom.k;
    if (HasRng && rng.k <= kStageMax) k += rng.k;
    return k * sizeof(int32_t);
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
  int running = 0;  // matches of this tile's earlier chunks
  for (int c = 0; c < block; c += kThreads) {
    const int j = c + (int)threadIdx.x;
    const int64_t row = tile0 + j;
    const bool hit = j < block && row < n && pred(row);
    const unsigned ballot = __ballot_sync(kFull, hit);
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
      local[tile0 + running + before +
            __popc(ballot & ((1u << lane) - 1u))] = (int32_t)row;
    }
    running += total;
    __syncthreads();  // warp_counts is rewritten by the next chunk
  }
  for (int j = running + (int)threadIdx.x; j < block; j += kThreads) {
    local[tile0 + j] = kInvalid;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = running;
}

// ---------------------------------------------------------------------------
// compact_lookback: the single-pass global compaction (Merrill & Garland's
// decoupled look-back, the scheme of CUB's DeviceSelect::Flagged), with one
// or two output streams.
//
// What bounds it on the H100: device memory — the predicate's bytes per row
// (1 B per mask; 13 B for K2's and K4's store rows, every sector of p and o
// or of s, p and o, and alive), 4 B of take and 1 B of ok written per
// output slot (cap of each per stream), 4 B of total per stream.
//
// Design: the TPU kernels compact per tile and leave the stitch of the
// tiles to ops.py; on Hopper that stitch cost about eight small torch
// launches per stream after the kernel.  Here one launch writes the final
// arrays.
//   * Tiles: 256 threads x 2 chunks x 16 rows = 8,192 rows.  The predicate
//     gives each thread the hits of 16 consecutive rows of each chunk as 16
//     bits per stream (Pred::bits): a mask thread reads its 16 rows as one
//     aligned 16-byte load, a warp over store rows reads 32 consecutive
//     rows per step and transposes the ballots (warp_bits).  The per-chunk
//     counts (each <= 4,096) ride in one 64-bit word of 16-bit fields, one
//     per (stream, chunk) — four at most — through one warp scan
//     (__shfl_up_sync) and one scan of the 8 warp totals in shared memory:
//     no field can carry into the next.  After the look-back each chunk's
//     matching rows are staged in order in shared memory and written out.
//     A tile pays a few microseconds of latency (ticket, load, fences,
//     look-back) however few rows it holds, so a tile of one chunk is slow
//     on a sparse mask; a tile of four is slow on a dense run of rows (a
//     store compacted in POS order holds each predicate's rows together),
//     whose write-out it serialises.  Two chunks sit between.
//   * Staging: a thread's 16 rows are consecutive, so on a dense run the
//     32 lanes of a warp write ranks 16 apart; one padding word after
//     every 16 (slot r + r / 16) puts them in 32 different banks.
//   * Order: a tile takes its id from an atomicAdd ticket, not blockIdx, so
//     a CTA waits only on tiles that running CTAs hold: forward progress.
//     One CTA per tile: a persistent grid (resident CTAs taking tiles by
//     ticket, the next ticket in flight) and tiles of four chunks both ran
//     K2 and K4 slower (PERF.md).
//   * Look-back: per stream, one 64-bit status word per tile, the flag
//     (aggregate or inclusive prefix) in the high half and the count in the
//     low half, so a reader never sees one without the other; it is
//     published after __threadfence() with a volatile store.  Warp st looks
//     back for stream st (two streams: warps 0 and 1 at once), reading the
//     32 tiles before its own at a time, waiting until each has a flag, and
//     summing the counts back to the nearest inclusive prefix (a ballot
//     finds it).  All eight warps reading 256 tiles a step were slower.
//   * Writes: each chunk's staged rows go out coalesced to its take/ok
//     slots below cap (a tile whose stream starts at or past cap skips
//     them); the last ticket writes total.  take, ok, total and the
//     look-back state lie in one buffer that the entry point zeroes
//     beforehand (one memset on the same stream), so slots past total
//     read 0 / false.
// Rows are addressed as virtual rows v = row + shift.  For a mask (the
// first of K7's two), shift is the pointer's offset from a 16-byte boundary
// (a view such as keep[1:]), so every thread's 16 rows are one aligned
// load; the segments holding the ragged head (v < shift) and tail (row >=
// n) load byte by byte.  Strided columns are read 4 bytes at a time, at any
// alignment, with shift 0.

// K1 and K7: NS precomputed 0/1 masks over the same rows, stream st
// compacting mask[st].  Rows are shifted by mask[0]'s offset, so its whole
// rows are one aligned load; another mask is read at its own alignment:
// one load too where its offset is mask[0]'s, else two (mask16_any).
template <int NS>
struct MaskBits {
  static constexpr int kStreams = NS;
  const uint8_t* mask[NS];
  int64_t n;
  int64_t member_stride;  // bytes between two members' masks (K1 batched)
  int shift;  // virtual rows before row 0: the host's, or select's
  __device__ __forceinline__ int64_t rows() const { return n + shift; }
  // Member b's masks; the shift follows mask[0]'s alignment.
  __device__ __forceinline__ void select(int b) {
#pragma unroll
    for (int st = 0; st < NS; ++st) mask[st] += (int64_t)b * member_stride;
    shift = (int)(reinterpret_cast<uintptr_t>(mask[0]) & 15);
  }
  __device__ __forceinline__ void stage(int32_t*) {}
  // Hits of virtual rows v0 .. v0 + 15 (v0 a multiple of 16), 16 bits a mask.
  __device__ __forceinline__ void bits(int64_t v0, unsigned* b) const {
#pragma unroll
    for (int st = 0; st < NS; ++st) b[st] = mask16_any(mask[st], v0 - shift, n);
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

constexpr unsigned long long kAggregate = 1ull << 32;  // status flags
constexpr unsigned long long kPrefix = 2ull << 32;

// The exclusive prefix of ``tile`` (>= 1), by one warp: sums the counts of
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

// The 16-bit field ``f`` of a packed count word.
__device__ __forceinline__ int field(unsigned long long w, int f) {
  return (int)((w >> (16 * f)) & 0xffffu);
}

template <int NS>
struct LookbackOut {
  // Member b's stream st is output stream j = st * members + b.
  int32_t* take;  // int32[NS * members * cap]: stream j's slots at j * cap
  uint8_t* ok;  // uint8[NS * members * cap], laid out as take
  int32_t* total;  // int32[NS * members]
  unsigned long long* status;  // stream j's ntiles words at j * ntiles
  unsigned* ticket;
};

// One CTA per (member, tile).  With a member axis (Members: K1's masks)
// tickets are decoded member-major (member b holds tickets b * ntiles ..
// b * ntiles + ntiles - 1, its tiles in order), so a tile looks back only
// over earlier tickets of its own member: CTAs that are running or done,
// as for one member.  Pred::select then points the predicate at the
// member's masks before any row is read, and its virtual rows replace nv.
// Without it (the solo entries) the predicate stays in the kernel's
// parameter space, as the member axis's runtime fields would cost the solo
// kernels registers and occupancy.
template <typename Pred, bool Members>
__global__ void __launch_bounds__(kScanThreads)
compact_lookback(Pred pred, int64_t nv, int ntiles, int members, int64_t cap,
                 LookbackOut<Pred::kStreams> out) {
  constexpr int NS = Pred::kStreams;
  static_assert(NS * kChunks <= 4, "the counts share one 64-bit word");
  extern __shared__ int32_t s_sets[];  // the member sets (MemberPred)
  __shared__ int32_t s_rows[kChunkRows + kChunkRows / 16];  // padded
  __shared__ unsigned long long s_warp[kScanWarps];
  __shared__ int s_tile;
  __shared__ unsigned s_excl[NS];
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(out.ticket, 1u);
  if constexpr (!Members) pred.stage(s_sets);
  __syncthreads();
  int member = 0, tile = s_tile;
  if constexpr (Members) {
    member = s_tile / ntiles;
    tile = s_tile - member * ntiles;
    pred.select(member);
    nv = pred.rows();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base =
      (int64_t)tile * kTileRows + threadIdx.x * kRowsPerThread;
  unsigned bits[kChunks][NS];  // the thread's 16 rows of each chunk
  unsigned long long packed = 0;  // their counts, field st * kChunks + c
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t v0 = base + (int64_t)c * kChunkRows;
#pragma unroll
    for (int st = 0; st < NS; ++st) bits[c][st] = 0u;
    // the warp's first row: the test is warp-uniform, as warp_bits needs
    if (v0 - kRowsPerThread * lane < nv) pred.bits(v0, bits[c]);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      packed |= (unsigned long long)__popc(bits[c][st])
                << (16 * (st * kChunks + c));
    }
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
  if (warp < NS) {
    const int st = warp;
    unsigned agg = 0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) agg += (unsigned)field(aggp, st * kChunks + c);
    unsigned long long* status =
        out.status + (Members ? (int64_t)st * members + member : st) * ntiles;
    unsigned excl = 0;
    if (tile == 0) {
      if (lane == 0) publish(status, kPrefix | agg);
    } else {
      if (lane == 0) publish(status + tile, kAggregate | agg);
      excl = look_back(status, tile, lane);
      if (lane == 0) publish(status + tile, kPrefix | (excl + agg));
    }
    if (lane == 0) s_excl[st] = excl;
  }
  __syncthreads();
#pragma unroll
  for (int st = 0; st < NS; ++st) {
    // the output stream
    const int64_t j = Members ? (int64_t)st * members + member : st;
    int64_t start = s_excl[st];
    int32_t* take = out.take + j * cap;
    uint8_t* ok = out.ok + j * cap;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int f = st * kChunks + c;
      const int tc = field(aggp, f);
      if (start < cap) {  // block-uniform
        int rank = field(mine, f);
        const int64_t r0 = base + (int64_t)c * kChunkRows - pred.shift;
        unsigned b = bits[c][st];
        while (b) {
          s_rows[rank + (rank >> 4)] = (int32_t)(r0 + __ffs(b) - 1);
          ++rank;
          b &= b - 1;
        }
        __syncthreads();
        for (int jj = threadIdx.x; jj < tc; jj += kScanThreads) {
          const int64_t r = start + jj;
          if (r < cap) {
            take[r] = s_rows[jj + (jj >> 4)];
            ok[r] = 1;
          }
        }
        __syncthreads();  // s_rows takes the next chunk
      }
      start += tc;
    }
    if (tile == ntiles - 1 && threadIdx.x == 0) out.total[j] = (int32_t)start;
  }
}

// The look-back outputs inside the entry's buffer (see the entries below).
template <int NS>
LookbackOut<NS> lookback_out(void* take, void* ok, void* total,
                             void* scratch) {
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  return {static_cast<int32_t*>(take), static_cast<uint8_t*>(ok),
          static_cast<int32_t*>(total), words + 1,
          reinterpret_cast<unsigned*>(words)};
}

// Zero the outputs and the look-back state (one buffer of zero_bytes that
// starts at take and holds ok, total and scratch), then launch one CTA per
// (member, tile); nv is the most virtual rows a member has.  Members: the
// batched entries' instantiation (any number of members, 1 included).
template <bool Members, typename Pred>
int launch_lookback(const Pred& pred, long long members, long long nv,
                    long long cap, void* take, void* ok, void* total,
                    void* scratch, long long scratch_words,
                    long long zero_bytes, size_t smem_bytes, void* stream) {
  constexpr int NS = Pred::kStreams;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = nv > 0 ? (nv + kTileRows - 1) / kTileRows : 1;
  if (members < 1 || (!Members && members != 1) ||
      NS * members * tiles + 1 > scratch_words || cap < 0 || zero_bytes < 0 ||
      members * tiles >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(take, 0, (size_t)zero_bytes, st);
  if (err != cudaSuccess) return (int)err;
  compact_lookback<Pred, Members><<<(unsigned)(members * tiles), kScanThreads,
                                    smem_bytes, st>>>(
      pred, nv, (int)tiles, (int)members, cap,
      lookback_out<NS>(take, ok, total, scratch));
  return (int)cudaGetLastError();
}

// The most virtual rows of ``members`` masks of n rows, member_stride bytes
// apart from ``m``: n plus the largest offset from 16 bytes among them.
long long mask_rows(const uint8_t* m, long long members, long long n,
                    long long member_stride) {
  int shift = 0;
  for (long long b = 0; b < members; ++b) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(m + b * member_stride);
    const int s = (int)(at & 15);
    shift = s > shift ? s : shift;
    if (member_stride % 16 == 0) break;  // every member at one offset
  }
  return n + shift;
}

// ---------------------------------------------------------------------------
// compact_lookback_group: the look-back compaction for a group of members
// over one shared store (K2 and K4 batched), one read of each tile's rows.
//
// What bounds it on the H100: device memory once more — 13 B a row of
// the store, read once for up to kGroup members, and 5 B per output slot
// of each (member, stream) — as long as the per-member work stays under
// the read.  That work is a fixed cost per (member, tile) — its look-back
// chain, its turn in the member loop — plus the tests and ballots of the
// members whose rows the warp may hold (PERF.md §6: the per-member
// cost, not the tests, sets the batched K2's time past a few members).
//
// Design: compact_lookback's tile (256 threads x 2 chunks x 16 rows) with
// one chain of look-back state per (member, stream) — a chain, below.
//   * Tickets are decoded group-major (group g holds tickets g * ntiles ..
//     (g + 1) * ntiles - 1, its tiles in order): a tile looks back only on
//     smaller tickets of its own group, running or done (forward
//     progress, as for one member).
//   * Rows: a warp reads 32 consecutive rows a step, kBatch steps in
//     flight (warp_bits' loads), alive and the row's bound with them, so
//     a dead row or one past the end is no hit of any member.  The batch's
//     rows stay in registers while every member of the group is tested on
//     them (GP::test; what the members share once, GP::prepare).  A store
//     holds each predicate's rows together, so a warp's batch meets few
//     members: GP::may_match compares the batch's range of p (and of o,
//     K2), two redux a column, with the member's and skips the member
//     outright.  A member with no hit takes one vote; else kBatch ballots
//     give each lane the bits of its own 16 rows (lane l keeps the
//     half-word of step l / 2, as in warp_bits) and the warp's count.
//     Bits (16 per chain, chunk and thread; dynamic shared memory sized by
//     the group) and warp counts start at 0 and only a member with hits
//     writes them, so no per-member state lives in registers: the members
//     are a runtime loop, and kGroup costs shared memory, not registers.
//   * Counts: one thread per (chain, chunk) turns the 8 warp counts into
//     exclusive warp offsets and the chunk's count.  The chains are
//     independent: warp w looks back chains w, w + 8, ... after its lanes
//     published all of their aggregates at once.
//   * Writes: per (chain, chunk) with matches, below cap: a warp with
//     matches scans its lanes' counts (__shfl_up_sync), stages its rows in
//     s_rows (padded, as compact_lookback) and the CTA writes them
//     coalesced.  Two barriers per (chain, chunk) with matches; none for
//     the rest.  Packing several segments into one staging round (two
//     barriers a round) ran slower on K2 (PERF.md §6).
//   * K2's bounds (int32[B, 4], device memory) are staged per group; a
//     test is two subtractions and two unsigned compares (p - plo < phi -
//     plo, the width 0 for an empty range).  K4's sets get a key per
//     member and set (SetKey): one that spans under 64 ids — a rewrite's
//     domain and range predicates, a class with few subclasses — is
//     tested as a 64-bit mask; a larger one is searched (IdSet), staged
//     for the group's leading ``staged`` members if at most kStageMax ids,
//     as many as kGroupStageBytes holds (member_compact_batched works it
//     out from the sets' widths), in device memory for the others.
// Outputs, status words and scratch are laid out as compact_lookback's
// with a member axis: member b's stream st is output stream st * B + b.
constexpr int kGroup = 16;  // members a CTA compacts over one read of rows
constexpr int kGroupStageBytes = 64 * 1024;  // a group's staged sets

// Dynamic shared memory of the bits: gsz members x NS streams x kChunks x
// kScanThreads half-words.
template <int NS>
__host__ __device__ constexpr size_t group_bits_bytes(long long gsz) {
  return (size_t)gsz * NS * kChunks * kScanThreads * sizeof(uint16_t);
}

// The least and the largest of the warp's kBatch * 32 values v.
__device__ __forceinline__ int2 warp_range(const int32_t* v) {
  int lo = v[0], hi = v[0];
#pragma unroll
  for (int k = 1; k < kBatch; ++k) {
    lo = min(lo, v[k]);
    hi = max(hi, v[k]);
  }
  return make_int2(__reduce_min_sync(kFull, lo), __reduce_max_sync(kFull, hi));
}

// K2 for a group: member first + m's bounds at params[first + m].
struct IntervalGroup {
  static constexpr int kStreams = 1;
  const int32_t* p;
  const int32_t* o;
  int64_t stride;  // int32 elements between consecutive rows of p and o
  const uint8_t* alive;
  int64_t n;
  const int4* params;  // int32[members, 4] (plo, phi, olo, ohi)
  const int4* bounds;  // the group's, staged (stage)
  static size_t staged_bytes(long long gsz) { return gsz * sizeof(int4); }
  static constexpr size_t kMaxStaged = kGroup * sizeof(int4);
  struct Rows {
    int32_t p[kBatch], o[kBatch];
  };
  struct Pre {
    int2 p, o;  // the warp's ranges of p and o in the batch
  };
  __device__ __forceinline__ void stage(uint8_t* smem, int first, int count) {
    int4* s = reinterpret_cast<int4*>(smem);
    for (int m = threadIdx.x; m < count; m += blockDim.x)
      s[m] = __ldg(params + first + m);
    bounds = s;
  }
  __device__ __forceinline__ void load(Rows& r, int k, int64_t i) const {
    r.p[k] = __ldg(p + i * stride);
    r.o[k] = __ldg(o + i * stride);
  }
  __device__ __forceinline__ Pre prepare(const Rows& r) const {
    return {warp_range(r.p), warp_range(r.o)};
  }
  // Whether some row of the warp's batch may match member m: its box of p
  // and o meets the member's (warp-uniform).
  __device__ __forceinline__ bool may_match(Pre pre, int m) const {
    const int4 b = bounds[m];
    return pre.p.y >= b.x && pre.p.x < b.y && pre.o.y >= b.z && pre.o.x < b.w;
  }
  // plo <= p < phi && olo <= o < ohi, as p - plo < phi - plo unsigned
  // (0 for an empty range)
  __device__ __forceinline__ void test(const Rows& r, Pre, int m,
                                       unsigned* hits) const {
    const int4 b = bounds[m];
    const unsigned pw = b.y > b.x ? (unsigned)b.y - (unsigned)b.x : 0u;
    const unsigned ow = b.w > b.z ? (unsigned)b.w - (unsigned)b.z : 0u;
    unsigned h = 0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      h |= (unsigned)(((unsigned)r.p[k] - (unsigned)b.x < pw) &
                      ((unsigned)r.o[k] - (unsigned)b.z < ow))
           << k;
    }
    hits[0] = h;
  }
};

// A member set's key, by one warp: its least and largest ids and, when they
// lie under 64 apart (a rewrite's domain and range predicates, a class with
// few subclasses), the set as a 64-bit mask over lo .. lo + 63 ("small"),
// tested in a few instructions a row; an all-padding set is small with an
// empty mask.  A larger set is searched (IdSet), its hi an upper bound.
struct SetKey {
  int lo, hi;
  unsigned long long mask;
  __device__ __forceinline__ bool small() const {
    return (unsigned)hi - (unsigned)lo < 64u;
  }
  // Whether [lo, hi] meets the warp's range r of values.
  __device__ __forceinline__ bool meets(int2 r) const {
    return r.y >= lo && r.x <= hi;
  }
  // Bit j set iff v[j] is in the set (want's bits only); small keys only.
  __device__ __forceinline__ unsigned contains_batch(const int32_t* v,
                                                     unsigned want) const {
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const unsigned d = (unsigned)v[j] - (unsigned)lo;
      m |= (unsigned)(d < 64u && ((mask >> (d & 63u)) & 1ull)) << j;
    }
    return m & want;
  }
};

// The key of a sorted INT32_MAX-padded set of k ids, by a whole warp: the
// first 64 slots read at once, their real ids ORed into the mask.
__device__ __forceinline__ SetKey set_key(const int32_t* ids, int k) {
  const int lane = threadIdx.x & 31;
  const int32_t v0 = lane < k ? __ldg(ids + lane) : kInvalid;
  const int32_t v1 = lane + 32 < k ? __ldg(ids + lane + 32) : kInvalid;
  const bool more = k > 64 && __ldg(ids + 64) != kInvalid;
  const int lo = __shfl_sync(kFull, v0, 0);
  if (lo == kInvalid) return {0, 0, 0ull};  // all padding: matches nothing
  const int hi = __reduce_max_sync(
      kFull, max(v0 != kInvalid ? v0 : lo, v1 != kInvalid ? v1 : lo));
  if (more || (unsigned)hi - (unsigned)lo >= 64u)
    return {lo, more ? kInvalid - 1 : hi, 0ull};
  const unsigned long long bits =
      (v0 != kInvalid ? 1ull << (v0 - lo) : 0ull) |
      (v1 != kInvalid ? 1ull << (v1 - lo) : 0ull);
  const unsigned mlo = __reduce_or_sync(kFull, (unsigned)bits);
  const unsigned mhi = __reduce_or_sync(kFull, (unsigned)(bits >> 32));
  return {lo, hi, (unsigned long long)mhi << 32 | mlo};
}

// K4 for a group: member first + m's sets at mem + (first + m) * mem_k etc.
template <bool HasDom, bool HasRng>
struct MemberGroup {
  static constexpr int kStreams = HasRng ? 2 : 1;
  const int32_t* s;
  const int32_t* p;
  const int32_t* o;
  int64_t stride;  // int32 elements between consecutive rows of s, p, o
  const uint8_t* alive;
  int64_t n;
  int32_t tid;
  const int32_t* mem;  // [members, mem_k], device memory; dom, rng alike
  const int32_t* dom;
  const int32_t* rng;
  int mem_k, dom_k, rng_k;
  int staged;  // leading members of a group whose sets are staged
  const int32_t* sets;  // the staged sets (stage)
  const SetKey* keys;  // each member's mem, dom and rng keys (stage)
  int first;

  // Staged ints a member: its sets of at most kStageMax ids, mem's first,
  // then dom's, then rng's.
  __host__ __device__ int mem_ints() const {
    return mem_k <= kStageMax ? mem_k : 0;
  }
  __host__ __device__ int dom_ints() const {
    return HasDom && dom_k <= kStageMax ? dom_k : 0;
  }
  __host__ __device__ int member_ints() const {
    return mem_ints() + dom_ints() +
           (HasRng && rng_k <= kStageMax ? rng_k : 0);
  }
  // The leading members of a group whose sets fit kGroupStageBytes.
  int staged_members() const {
    const int per = member_ints() * (int)sizeof(int32_t);
    return per == 0 || kGroupStageBytes / per >= kGroup
               ? kGroup
               : kGroupStageBytes / per;
  }
  size_t staged_bytes(long long gsz) const {
    return 3 * kGroup * sizeof(SetKey) +
           (size_t)(staged < gsz ? staged : gsz) * member_ints() *
               sizeof(int32_t);
  }
  static constexpr size_t kMaxStaged =
      3 * kGroup * sizeof(SetKey) + kGroupStageBytes;

  struct Rows {
    int32_t s[kBatch], p[kBatch], o[kBatch];
  };
  struct Pre {
    unsigned valid, typed;
    int2 p;  // the warp's range of p in the batch
    bool any_typed;  // some row of the warp's batch has p == tid
  };
  // The group's set keys (3 * kGroup at smem: member m's mem, dom and rng
  // at 3m .. 3m + 2), one warp a set, then the leading ``staged`` members'
  // sets.
  __device__ __forceinline__ void stage(uint8_t* smem, int first_,
                                        int count) {
    SetKey* key = reinterpret_cast<SetKey*>(smem);
    for (int i = threadIdx.x >> 5; i < 3 * count; i += kScanWarps) {
      const int64_t b = first_ + i / 3;
      const int which = i % 3;
      if (which == 1 && !HasDom) continue;
      if (which == 2 && !HasRng) continue;
      const SetKey kv = which == 0   ? set_key(mem + b * mem_k, mem_k)
                        : which == 1 ? set_key(dom + b * dom_k, dom_k)
                                     : set_key(rng + b * rng_k, rng_k);
      if ((threadIdx.x & 31) == 0) key[i] = kv;
    }
    keys = key;
    int32_t* out =
        reinterpret_cast<int32_t*>(smem + 3 * kGroup * sizeof(SetKey));
    const int mi = mem_ints(), di = dom_ints(), per = member_ints();
    const int ns = staged < count ? staged : count;
    for (int i = threadIdx.x; i < ns * per; i += blockDim.x) {
      const int m = i / per, r = i - m * per;
      const int64_t b = first_ + m;
      out[i] = r < mi        ? __ldg(mem + b * mem_k + r)
               : r < mi + di ? __ldg(dom + b * dom_k + (r - mi))
                             : __ldg(rng + b * rng_k + (r - mi - di));
    }
    sets = out;
    first = first_;
  }
  // Member m's set of width k, staged at ``off`` ints into its slice.
  __device__ __forceinline__ IdSet set_of(const int32_t* ids, int k, int m,
                                          int off) const {
    if (m < staged && k <= kStageMax)
      return {sets + m * member_ints() + off, k};
    return {ids + (int64_t)(first + m) * k, k};
  }
  __device__ __forceinline__ void load(Rows& r, int k, int64_t i) const {
    r.s[k] = __ldg(s + i * stride);
    r.p[k] = __ldg(p + i * stride);
    r.o[k] = __ldg(o + i * stride);
  }
  __device__ __forceinline__ Pre prepare(const Rows& r) const {
    Pre pre{0u, 0u, warp_range(r.p), false};
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      pre.valid |= (unsigned)(r.s[k] != kInvalid) << k;
      pre.typed |= (unsigned)(r.p[k] == tid) << k;
    }
    pre.any_typed = __any_sync(kFull, pre.typed);
    return pre;
  }
  // Whether some row of the warp's batch may match member m: a typed row,
  // or the warp's p range meets the ids of m's dom or rng (warp-uniform).
  __device__ __forceinline__ bool may_match(Pre pre, int m) const {
    return pre.any_typed || (HasDom && keys[3 * m + 1].meets(pre.p)) ||
           (HasRng && keys[3 * m + 2].meets(pre.p));
  }
  // MemberPred::test for member m; mem is tested only for typed rows, dom
  // and rng only where the warp's p range meets the set's ids
  // (warp-uniform).
  __device__ __forceinline__ void test(const Rows& r, Pre pre, int m,
                                       unsigned* hits) const {
    unsigned ms = 0u;
    if (pre.typed) {
      const SetKey km = keys[3 * m];
      ms = km.small() ? km.contains_batch(r.o, pre.typed)
                      : set_of(mem, mem_k, m, 0).contains_batch(r.o, pre.typed);
    }
    if constexpr (HasDom) {
      const SetKey kd = keys[3 * m + 1];
      if (kd.meets(pre.p))
        ms |= kd.small() ? kd.contains_batch(r.p, ~0u)
                         : set_of(dom, dom_k, m, mem_ints())
                               .contains_batch(r.p, ~0u);
    }
    hits[0] = ms & pre.valid;
    if constexpr (HasRng) {
      const SetKey kr = keys[3 * m + 2];
      hits[1] = 0u;
      if (kr.meets(pre.p))
        hits[1] = (kr.small() ? kr.contains_batch(r.p, ~0u)
                              : set_of(rng, rng_k, m, mem_ints() + dom_ints())
                                    .contains_batch(r.p, ~0u)) &
                  pre.valid;
    }
  }
};

template <typename GP>
__global__ void __launch_bounds__(kScanThreads)
compact_lookback_group(GP pred, int ntiles, int members, int64_t cap,
                       LookbackOut<GP::kStreams> out) {
  constexpr int NS = GP::kStreams;
  constexpr int kChains = kGroup * NS;  // chain q: member q / NS, stream q % NS
  static_assert(kChains <= 4 * kScanWarps, "four chains a warp at most");
  extern __shared__ __align__(16) uint8_t s_dyn[];  // bits, then GP's
  __shared__ int32_t s_rows[kChunkRows + kChunkRows / 16];  // padded
  __shared__ int s_cnt[kChains * kChunks][kScanWarps];  // (chain, chunk)
  __shared__ int s_tot[kChains * kChunks];
  __shared__ unsigned s_excl[kChains];
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(out.ticket, 1u);
  __syncthreads();
  const int group = s_tile / ntiles;
  const int tile = s_tile - group * ntiles;
  const int first = group * kGroup;
  const int count = members - first < kGroup ? members - first : kGroup;
  const int nchains = count * NS;
  const int gsz = members < kGroup ? members : kGroup;
  uint16_t* s_bits = reinterpret_cast<uint16_t*>(s_dyn);  // [f][thread]
  pred.stage(s_dyn + group_bits_bytes<NS>(gsz), first, count);
  // bits and counts start at 0: a member with no match writes neither
  for (int i = threadIdx.x; i < nchains * kChunks * kScanThreads / 8;
       i += kScanThreads)
    reinterpret_cast<uint4*>(s_dyn)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < nchains * kChunks * kScanWarps;
       i += kScanThreads)
    (&s_cnt[0][0])[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n = pred.n;

  // -- the rows, read once: every member's bits and warp counts --
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t w0 = (int64_t)tile * kTileRows + (int64_t)c * kChunkRows +
                       warp * kWarpRows;
    if (w0 >= n) continue;  // warp-uniform: no rows, counts stay 0
#pragma unroll
    for (int h = 0; h < kRowsPerThread; h += kBatch) {
      typename GP::Rows rows;
      unsigned live = 0;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int64_t i = w0 + 32 * (h + k) + lane;
        const int64_t ic = i < n ? i : n - 1;
        pred.load(rows, k, ic);
        live |= (unsigned)(i < n && __ldg(pred.alive + ic) != 0) << k;
      }
      const typename GP::Pre pre = pred.prepare(rows);
      const int step = lane >> 1;  // the step holding the lane's own rows
      const bool mine = step >= h && step < h + kBatch;
      for (int m = 0; m < count; ++m) {
        if (!pred.may_match(pre, m)) continue;  // warp-uniform
        unsigned hits[NS];
        pred.test(rows, pre, m, hits);
#pragma unroll
        for (int st = 0; st < NS; ++st) {
          const int f = (m * NS + st) * kChunks + c;
          const unsigned hm = hits[st] & live;
          if (!__any_sync(kFull, hm)) continue;
          unsigned b = 0u;
          int wc = 0;
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const unsigned w = __ballot_sync(kFull, (hm >> k) & 1u);
            wc += __popc(w);
            b = step == h + k ? w : b;
          }
          b = (lane & 1) ? b >> 16 : b & 0xffffu;
          if (mine) s_bits[f * kScanThreads + threadIdx.x] = (uint16_t)b;
          if (lane == 0) s_cnt[f][warp] += wc;
        }
      }
    }
  }
  __syncthreads();
  // -- warp counts -> exclusive warp offsets and chunk counts --
  for (int f = threadIdx.x; f < nchains * kChunks; f += kScanThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kScanWarps; ++w) {
      const int v = s_cnt[f][w];
      s_cnt[f][w] = run;
      run += v;
    }
    s_tot[f] = run;
  }
  __syncthreads();
  // -- look-back: lanes publish the warp's chains' aggregates, then the
  // warp looks back one chain at a time --
  {
    const int q = warp + kScanWarps * lane;
    if (q < nchains) {
      unsigned agg = 0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) agg += (unsigned)s_tot[q * kChunks + c];
      const int64_t j = (int64_t)(q % NS) * members + first + q / NS;
      publish(out.status + j * ntiles + tile,
              (tile == 0 ? kPrefix : kAggregate) | agg);
      if (tile == 0) {
        s_excl[q] = 0;
        if (ntiles == 1) out.total[j] = (int32_t)agg;
      }
    }
  }
  if (tile > 0) {
    for (int q = warp; q < nchains; q += kScanWarps) {
      unsigned agg = 0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) agg += (unsigned)s_tot[q * kChunks + c];
      const int64_t j = (int64_t)(q % NS) * members + first + q / NS;
      unsigned long long* status = out.status + j * ntiles;
      const unsigned excl = look_back(status, tile, lane);
      if (lane == 0) {
        publish(status + tile, kPrefix | (excl + agg));
        s_excl[q] = excl;
        if (tile == ntiles - 1) out.total[j] = (int32_t)(excl + agg);
      }
    }
  }
  __syncthreads();
  for (int q = 0; q < nchains; ++q) {
    const int64_t j = (int64_t)(q % NS) * members + first + q / NS;
    int64_t start = s_excl[q];
    int32_t* take = out.take + j * cap;
    uint8_t* ok = out.ok + j * cap;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int f = q * kChunks + c;
      const int tc = s_tot[f];
      if (tc > 0 && start < cap) {
        const int wpre = s_cnt[f][warp];
        const int wend = warp + 1 < kScanWarps ? s_cnt[f][warp + 1] : tc;
        if (wend > wpre) {
          unsigned b = s_bits[f * kScanThreads + threadIdx.x];
          const int own = __popc(b);
          int incl = own;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += y;
          }
          int rank = wpre + incl - own;
          const int64_t r0 = (int64_t)tile * kTileRows + (int64_t)c * kChunkRows + threadIdx.x * kRowsPerThread;
          while (b) {
            s_rows[rank + (rank >> 4)] = (int32_t)(r0 + __ffs(b) - 1);
            ++rank;
            b &= b - 1;
          }
        }
        __syncthreads();
        for (int jj = threadIdx.x; jj < tc; jj += kScanThreads) {
          const int64_t r = start + jj;
          if (r < cap) {
            take[r] = s_rows[jj + (jj >> 4)];
            ok[r] = 1;
          }
        }
        __syncthreads();
      }
      start += tc;
    }
  }
}

// Zero the outputs and the look-back state as launch_lookback does, then
// launch one CTA per (group, tile); pred_smem: the bytes GP stages for a
// group of min(members, kGroup).  Each kernel opts in once per device,
// when first launched there, to the most dynamic shared memory any launch
// of it takes (SmemOptIn).
template <typename GP>
int launch_group(const GP& pred, long long members, long long n,
                 long long cap, void* take, void* ok, void* total,
                 void* scratch, long long scratch_words, long long zero_bytes,
                 size_t pred_smem, void* stream) {
  constexpr int NS = GP::kStreams;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = n > 0 ? (n + kTileRows - 1) / kTileRows : 1;
  const long long groups = (members + kGroup - 1) / kGroup;
  const long long gsz = members < kGroup ? members : kGroup;
  constexpr size_t kMaxSmem = group_bits_bytes<NS>(kGroup) + GP::kMaxStaged;
  static SmemOptIn opt_in;
  const cudaError_t opted = opt_in(compact_lookback_group<GP>, (int)kMaxSmem);
  if (opted != cudaSuccess) return (int)opted;
  const size_t smem = group_bits_bytes<NS>(gsz) + pred_smem;
  if (members < 1 || NS * members * tiles + 1 > scratch_words || cap < 0 ||
      cap >= (1ll << 31) || zero_bytes < 0 || groups * tiles >= (1ll << 31) ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(take, 0, (size_t)zero_bytes, st);
  if (err != cudaSuccess) return (int)err;
  compact_lookback_group<GP><<<(unsigned)(groups * tiles), kScanThreads, smem,
                               st>>>(pred, (int)tiles, (int)members, cap,
                                     lookback_out<NS>(take, ok, total,
                                                      scratch));
  return (int)cudaGetLastError();
}

// Calls f(std::bool_constant<has_dom>, std::bool_constant<has_rng>).
template <typename F>
int with_branches(int has_dom, int has_rng, F f) {
  if (has_dom && has_rng) return f(std::true_type{}, std::true_type{});
  if (has_dom) return f(std::true_type{}, std::false_type{});
  if (has_rng) return f(std::false_type{}, std::true_type{});
  return f(std::false_type{}, std::false_type{});
}

}  // namespace

// The look-back entries (compact_mask, dual_compact_mask,
// masked_interval_compact, member_compact and the batched entries of the
// first, third and fourth, the last two through compact_lookback_group)
// share their output arguments: one buffer of
// zero_bytes starting at take, which the entry zeroes, holds take
// (int32[S * B * cap]), ok (uint8[S * B * cap]), total (int32[S * B]) and
// scratch (scratch_words >= S * B * ceil((n + 15) / 8192) + 1 int64 words:
// the ticket, then each output stream's tile status words), S being the
// number of output streams per member and B the number of members (1 for
// the solo entries); member b's stream st is output stream st * B + b.

// mask: uint8[n] (torch.bool), any alignment, n < 2**31.
extern "C" int compact_mask(const void* mask, long long n, long long cap,
                            void* take, void* ok, void* total, void* scratch,
                            long long scratch_words, long long zero_bytes,
                            void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int shift = (int)(reinterpret_cast<uintptr_t>(m) & 15);
  MaskBits<1> pred{{m}, n, 0, shift};
  return launch_lookback<false>(pred, 1, n + shift, cap, take, ok, total,
                                scratch, scratch_words, zero_bytes, 0, stream);
}

// K1 over a member axis: members masks of n rows, member b's at mask +
// b * member_stride bytes (each at any alignment), compacted in one launch.
extern "C" int compact_mask_batched(const void* mask, long long members,
                                    long long n, long long member_stride,
                                    long long cap, void* take, void* ok,
                                    void* total, void* scratch,
                                    long long scratch_words,
                                    long long zero_bytes, void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  MaskBits<1> pred{{m}, n, member_stride, 0};
  return launch_lookback<true>(pred, members,
                               mask_rows(m, members, n, member_stride), cap,
                               take, ok, total, scratch, scratch_words,
                               zero_bytes, 0, stream);
}

// mask_a, mask_b: uint8[n] (torch.bool), each at any alignment, n < 2**31;
// stream 0 compacts mask_a, stream 1 mask_b.
extern "C" int dual_compact_mask(const void* mask_a, const void* mask_b,
                                 long long n, long long cap, void* take,
                                 void* ok, void* total, void* scratch,
                                 long long scratch_words, long long zero_bytes,
                                 void* stream) {
  const uint8_t* a = static_cast<const uint8_t*>(mask_a);
  const int shift = (int)(reinterpret_cast<uintptr_t>(a) & 15);
  MaskBits<2> pred{{a, static_cast<const uint8_t*>(mask_b)}, n, 0, shift};
  return launch_lookback<false>(pred, 1, n + shift, cap, take, ok, total,
                                scratch, scratch_words, zero_bytes, 0, stream);
}

// p, o: int32 columns with ``stride`` elements between rows (3 for the
// columns of an [N, 3] store); alive: uint8[n] (torch.bool).
extern "C" int masked_interval_compact(const void* p, const void* o,
                                       long long stride, const void* alive,
                                       int plo, int phi, int olo, int ohi,
                                       long long n, long long cap, void* take,
                                       void* ok, void* total, void* scratch,
                                       long long scratch_words,
                                       long long zero_bytes, void* stream) {
  IntervalPred<true> pred{static_cast<const int32_t*>(p),
                          static_cast<const int32_t*>(o), stride,
                          static_cast<const uint8_t*>(alive),
                          plo, phi, olo, ohi, n};
  return launch_lookback<false>(pred, 1, n, cap, take, ok, total, scratch,
                                scratch_words, zero_bytes, 0, stream);
}

// K2 over a member axis: one store (p, o, alive as above) shared by the
// members, member b's bounds (plo, phi, olo, ohi) at params[4b .. 4b + 3]
// in device memory (int32, 16-byte aligned), staged by its group's CTAs.
extern "C" int masked_interval_compact_batched(
    const void* p, const void* o, long long stride, const void* alive,
    const void* params, long long members, long long n, long long cap,
    void* take, void* ok, void* total, void* scratch, long long scratch_words,
    long long zero_bytes, void* stream) {
  IntervalGroup pred{static_cast<const int32_t*>(p),
                     static_cast<const int32_t*>(o), stride,
                     static_cast<const uint8_t*>(alive), n,
                     static_cast<const int4*>(params), nullptr};
  return launch_group(pred, members, n, cap, take, ok, total, scratch,
                      scratch_words, zero_bytes,
                      IntervalGroup::staged_bytes(members < kGroup ? members
                                                                   : kGroup),
                      stream);
}

// masked_interval_compact's predicate without the alive column, compacted
// per tile: local int32[nb * block], counts int32[nb].
extern "C" int interval_compact(const void* p, const void* o, long long stride,
                                int plo, int phi, int olo, int ohi,
                                long long n, int block, int nb, void* local,
                                void* counts, void* stream) {
  IntervalPred<false> pred{static_cast<const int32_t*>(p),
                           static_cast<const int32_t*>(o), stride, nullptr,
                           plo, phi, olo, ohi, n};
  compact_tiles<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pred, n, block, static_cast<int32_t*>(local),
      static_cast<int32_t*>(counts));
  return (int)cudaGetLastError();
}

// s, p, o: int32 columns with ``stride`` elements between rows; alive:
// uint8[n] (torch.bool); mem/dom/rng: sorted INT32_MAX-padded int32 sets of
// mem_k/dom_k/rng_k (powers of two) entries.  Stream 0 is the subject
// stream; the object stream (stream 1) exists only when has_rng.
extern "C" int member_compact(const void* s, const void* p, const void* o,
                              long long stride, const void* alive, int tid,
                              const void* mem, int mem_k, const void* dom,
                              int dom_k, const void* rng, int rng_k,
                              int has_dom, int has_rng, long long n,
                              long long cap, void* take, void* ok,
                              void* total, void* scratch,
                              long long scratch_words, long long zero_bytes,
                              void* stream) {
  const int32_t* sc = static_cast<const int32_t*>(s);
  const int32_t* pc = static_cast<const int32_t*>(p);
  const int32_t* oc = static_cast<const int32_t*>(o);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  const IdSet ms{static_cast<const int32_t*>(mem), mem_k};
  const IdSet ds{static_cast<const int32_t*>(dom), dom_k};
  const IdSet rs{static_cast<const int32_t*>(rng), rng_k};
  return with_branches(has_dom, has_rng, [&](auto d, auto r) {
    MemberPred<decltype(d)::value, decltype(r)::value> pred{
        sc, pc, oc, stride, al, tid, ms, ds, rs, n};
    return launch_lookback<false>(pred, 1, n, cap, take, ok, total, scratch,
                                  scratch_words, zero_bytes,
                                  pred.staged_bytes(), stream);
  });
}

// K4 over a member axis: one store (s, p, o, alive, tid as above) shared by
// the members; mem/dom/rng hold one set per member, [members, mem_k] etc.
// contiguous.  A group's CTAs stage the sets of as many of its leading
// members as kGroupStageBytes holds and search the others' in device
// memory.
extern "C" int member_compact_batched(
    const void* s, const void* p, const void* o, long long stride,
    const void* alive, int tid, const void* mem, int mem_k, const void* dom,
    int dom_k, const void* rng, int rng_k, int has_dom, int has_rng,
    long long members, long long n, long long cap, void* take, void* ok,
    void* total, void* scratch, long long scratch_words, long long zero_bytes,
    void* stream) {
  const long long gsz = members < kGroup ? members : kGroup;
  return with_branches(has_dom, has_rng, [&](auto d, auto r) {
    MemberGroup<decltype(d)::value, decltype(r)::value> pred{
        static_cast<const int32_t*>(s), static_cast<const int32_t*>(p),
        static_cast<const int32_t*>(o), stride,
        static_cast<const uint8_t*>(alive), n, tid,
        static_cast<const int32_t*>(mem), static_cast<const int32_t*>(dom),
        static_cast<const int32_t*>(rng), mem_k, dom_k, rng_k, 0, nullptr,
        nullptr, 0};
    pred.staged = pred.staged_members();
    return launch_group(pred, members, n, cap, take, ok, total, scratch,
                        scratch_words, zero_bytes, pred.staged_bytes(gsz),
                        stream);
  });
}
