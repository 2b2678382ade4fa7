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
// mask; the K^2 compares per group are a few integer instructions each.
// A slot whose id is valid makes the reference's validity test of the
// other candidate redundant: c2 > c1 >= 0 or c2 == c1 >= 0 is valid.  So
// slot j is dropped iff some slot k has c1 < c2 < b1, or c2 == c1 and k < j.
//
// Design: the TPU kernel builds a (groups, K, K) bool cube in VMEM.  Here
// two kernels, chosen by K:
//   * msc_tile<KT, Exact> for K <= 32: K is a template parameter, exact for
//     K <= 8 (the widths real data has: LUBM's instances have 6 candidate
//     slots), a bucket of 16 or 32 beyond, whose padding slots read as -1
//     (which drops nothing).  No division by K, and the compares unroll in
//     registers.  A CTA of 256 threads takes a tile of whole groups, at
//     most 2,048 slots: it reads the tile's ids and bounds with coalesced
//     16-byte loads, all of a thread's (up to four) issued before any is
//     used, and stores them in shared memory slot-major (row k of the tile
//     holds slot k of each group, padded by one word so that consecutive
//     groups sit in consecutive banks).  One thread owns a group (K <= 8),
//     or KT / 8 lanes share one, each testing 8 of its slots: it reads the
//     group's ids into registers and runs each slot's compares against
//     them.  The keep bytes gather in shared memory in the output's order
//     and leave as 16-byte stores.  A tile off 16-byte alignment (a view)
//     is read and written 4 and 1 bytes at a time.
//   * msc_wide for K > 32: one CTA stages max(1, 256 / K) whole groups in
//     shared memory and one thread per (group, slot) walks the K slots with
//     exactly the reference's comparisons; a group too wide for the 48 KB
//     of default shared memory (K > 6,144) is read where it lies.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageSlots = 6144;  // msc_wide: conc + bounds staged: 48 KB

// Lanes per group, slots per lane and groups per tile of msc_tile<KT>.
template <int KT>
struct TileShape {
  static constexpr int kLanes = KT <= 8 ? 1 : KT / 8;
  static constexpr int kSlots = KT / kLanes;  // <= 8
  static constexpr int kGroups = kThreads / kLanes;
  static constexpr int kStride = kGroups + 1;  // a slot row in shared memory
  static constexpr int kVec = (kGroups * KT + 4 * kThreads - 1) / (4 * kThreads);
  static_assert(KT <= 8 || KT % 8 == 0, "buckets are multiples of 8");
};

template <int KT, bool Exact>
__global__ void __launch_bounds__(kThreads)
msc_tile(const int32_t* __restrict__ conc, const int32_t* __restrict__ bounds,
         int64_t G, int k_rt, int vec, uint8_t* __restrict__ keep) {
  using T = TileShape<KT>;
  static_assert(Exact == (T::kLanes == 1), "exact widths take a lane each");
  __shared__ int32_t s_c[KT * T::kStride];
  __shared__ int32_t s_b[KT * T::kStride];
  __shared__ __align__(16) uint8_t s_keep[KT * T::kGroups];
  const int K = Exact ? KT : k_rt;
  // slot i of the tile is slot i % K of group i / K; a bucket divides by a
  // multiply (exact for i < 2**20 / 32 and K <= 32)
  const unsigned kdiv = Exact ? 0u : (1u << 20) / (unsigned)K + 1u;
  const int64_t g0 = (int64_t)blockIdx.x * T::kGroups;
  const int ng = G - g0 < T::kGroups ? (int)(G - g0) : T::kGroups;
  const int slots = ng * K;
  const int64_t s0 = g0 * K;

  auto put = [&](int i, int32_t c, int32_t b) {
    const int g = Exact ? i / KT : (int)(((unsigned)i * kdiv) >> 20);
    const int at = (i - g * K) * T::kStride + g;
    s_c[at] = c;
    s_b[at] = b;
  };
  const int nv = vec ? slots >> 2 : 0;  // whole 16-byte words of the tile
  int4 cw[T::kVec], bw[T::kVec];
#pragma unroll
  for (int u = 0; u < T::kVec; ++u) {
    const int v = (int)threadIdx.x + u * kThreads;
    if (v < nv) {
      cw[u] = __ldg(reinterpret_cast<const int4*>(conc + s0) + v);
      bw[u] = __ldg(reinterpret_cast<const int4*>(bounds + s0) + v);
    }
  }
#pragma unroll
  for (int u = 0; u < T::kVec; ++u) {
    const int v = (int)threadIdx.x + u * kThreads;
    if (v < nv) {
      put(4 * v, cw[u].x, bw[u].x);
      put(4 * v + 1, cw[u].y, bw[u].y);
      put(4 * v + 2, cw[u].z, bw[u].z);
      put(4 * v + 3, cw[u].w, bw[u].w);
    }
  }
  for (int i = 4 * nv + (int)threadIdx.x; i < slots; i += kThreads) {
    put(i, __ldg(conc + s0 + i), __ldg(bounds + s0 + i));
  }
  __syncthreads();

  const int gl = (int)threadIdx.x / T::kLanes;  // the group in the tile
  const int part = (int)threadIdx.x % T::kLanes;
  if (gl < ng) {
    int32_t cv[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      cv[k] = (Exact || k < K) ? s_c[k * T::kStride + gl] : -1;
    }
#pragma unroll
    for (int jj = 0; jj < T::kSlots; ++jj) {
      const int j = part * T::kSlots + jj;
      if (!Exact && j >= K) break;
      int32_t c1;
      if constexpr (Exact) {
        c1 = cv[jj];
      } else {
        c1 = s_c[j * T::kStride + gl];
      }
      const int32_t b1 = s_b[j * T::kStride + gl];
      bool drop = false;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int32_t c2 = cv[k];
        drop |= ((c2 > c1) & (c2 < b1)) | ((c2 == c1) & (k < j));
      }
      s_keep[gl * K + j] = c1 >= 0 && !drop;
    }
  }
  __syncthreads();

  uint8_t* out = keep + s0;
  const int nb = vec ? slots >> 4 : 0;
  for (int v = (int)threadIdx.x; v < nb; v += kThreads) {
    reinterpret_cast<uint4*>(out)[v] = reinterpret_cast<const uint4*>(s_keep)[v];
  }
  for (int i = 16 * nb + (int)threadIdx.x; i < slots; i += kThreads) {
    out[i] = s_keep[i];
  }
}

__global__ void __launch_bounds__(kThreads)
msc_wide(const int32_t* __restrict__ conc, const int32_t* __restrict__ bounds,
         int64_t G, int K, int gpb, int staged, uint8_t* __restrict__ keep) {
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

template <int KT, bool Exact>
int launch_tile(const int32_t* conc, const int32_t* bounds, long long G, int K,
                uint8_t* keep, cudaStream_t stream) {
  constexpr int TG = TileShape<KT>::kGroups;
  const int vec = ((reinterpret_cast<uintptr_t>(conc) |
                    reinterpret_cast<uintptr_t>(bounds) |
                    reinterpret_cast<uintptr_t>(keep)) & 15) == 0;
  msc_tile<KT, Exact><<<(unsigned)((G + TG - 1) / TG), kThreads, 0, stream>>>(
      conc, bounds, G, K, vec, keep);
  return (int)cudaGetLastError();
}

}  // namespace

// conc, bounds: contiguous int32[G, K]; keep: uint8[G, K] (torch.bool).
// Requires G >= 1 and K >= 1.
extern "C" int msc_select(const void* conc, const void* bounds, long long G,
                          int K, void* keep, void* stream) {
  const int32_t* c = static_cast<const int32_t*>(conc);
  const int32_t* b = static_cast<const int32_t*>(bounds);
  uint8_t* out = static_cast<uint8_t*>(keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_tile<1, true>(c, b, G, K, out, st);
    case 2: return launch_tile<2, true>(c, b, G, K, out, st);
    case 3: return launch_tile<3, true>(c, b, G, K, out, st);
    case 4: return launch_tile<4, true>(c, b, G, K, out, st);
    case 5: return launch_tile<5, true>(c, b, G, K, out, st);
    case 6: return launch_tile<6, true>(c, b, G, K, out, st);
    case 7: return launch_tile<7, true>(c, b, G, K, out, st);
    case 8: return launch_tile<8, true>(c, b, G, K, out, st);
    default: break;
  }
  if (K <= 16) return launch_tile<16, false>(c, b, G, K, out, st);
  if (K <= 32) return launch_tile<32, false>(c, b, G, K, out, st);
  const int gpb = K >= kThreads ? 1 : kThreads / K;
  const int staged = (long long)gpb * K <= kStageSlots;
  const size_t smem = staged ? 2 * (size_t)gpb * K * sizeof(int32_t) : 0;
  const unsigned grid = (unsigned)((G + gpb - 1) / gpb);
  msc_wide<<<grid, kThreads, smem, st>>>(c, b, G, K, gpb, staged, out);
  return (int)cudaGetLastError();
}
