// RDFS closure expansion through the prefix encoding, for Hopper (sm_90a).
//
// Replaces the TPU kernel closure_expand_pallas (src/repro/kernels/
// closure_expand.py): for each query concept id, the lower bound of the id
// in sorted_ids (clipped to the last slot) and, where that slot holds the
// id, its row of anc_table[C, D]; a miss gives a row of -1 —
// ref_closure_expand's contract.
//
// What bounds it on the H100: device memory.  Per query it reads one id
// (4 B) and writes a D-wide row (4 D B): 5/6 of the bytes are writes at
// D = 5.  Past the staged ids, the table's reads in L2: 16-byte requests
// scattered over it, a few a query.
//
// Design: the TPU kernel keeps sorted_ids and anc_table resident in VMEM
// and walks a block of queries in lock step.  Here two kernels, chosen by D:
//   * closure_expand_quads<DT, Exact, Sampled> for D <= 32: D is a template
//     parameter, exact up to 8 (LUBM's closure depth is 5), a bucket of 16
//     or 32 beyond (the real D bounds the loops; nothing past it is
//     written).  Each CTA stages sorted_ids in shared memory, whole up to
//     8,192 ids, else (Sampled) every step-th id, step a multiple of 4 and
//     as small as 96 KB of keys allow (12 at 213,000 ids), and anc_table
//     when it fits (C D <= 4,096); that is its one __syncthreads.  Then
//     each thread takes four consecutive queries a step, grid-stride over a
//     grid that fills the card, its next 16-byte load of ids issued before
//     the current four are searched.  The four searches interleave: a fixed
//     ceil(log2) branch-free steps over the staged keys; then, when
//     sampled, the step ids between two staged keys are read as 16-byte
//     words, all in flight at once, and counted, so a query waits on one
//     round trip to device memory, not on a chain of them.  A thread's four
//     rows are 16 D bytes, 16-byte aligned in out: it assembles them word
//     by word (no division: the row and column of each element are
//     counted, and constant when D is exact; rows of D % 4 == 0 are read
//     as whole words) into its warp's part of shared memory, and the warp,
//     after a __syncwarp, stores its 32 threads' 512 D contiguous bytes,
//     each warp store 512 contiguous bytes, marked streaming (evict
//     first: the kernel never reads them back).  A view of the ids off 16-byte
//     alignment reads each four ids with scalar loads, so the stores stay
//     aligned; the n % 4 last queries go one a thread.
//   * closure_expand_wide for D > 32: persistent over 256-query tiles (a
//     grid that fills the card), one thread per query searches (the same
//     staging) and leaves its row number in shared memory, then the CTA
//     copies the tile's [256, D] output, consecutive threads on
//     consecutive elements.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

// Opts a kernel into the most dynamic shared memory the device grants a
// block, less the kernel's static shared memory, on the calling thread's
// current device, once per device: the attribute belongs to the device and
// is shared by the process's threads, so it is set once, to what any launch
// may take, and never lowered under another thread's launch.  One object
// per kernel.
struct SmemOptIn {
  static constexpr int kMaxDevices = 64;
  std::once_flag once[kMaxDevices];
  cudaError_t result[kMaxDevices] = {};

  template <class K>
  cudaError_t operator()(K kernel) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::call_once(once[dev], [&] {
      int most = 0;
      cudaFuncAttributes fa;
      cudaError_t e = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            most - (int)fa.sharedSizeBytes);
      result[dev] = e;
    });
    return result[dev];
  }
};

constexpr int kThreads = 256;
constexpr int kStageMax = 8192;     // sorted ids staged whole up to here
constexpr int kSampleMax = 24576;   // past it, staged keys: at most 96 KB
constexpr int kAncStage = 4096;     // anc_table staged when C D fits: 16 KB

// The sorted ids and the ancestor table, as a CTA searches them.
struct Table {
  const int32_t* ids;  // sorted int32[C] in device memory
  const int32_t* anc;  // int32[C, D] in device memory
  int C;
  int step;        // ids between two staged keys: 1 (every id is staged)
                   // or a multiple of 4 (a window is whole 16-byte words)
  int ns;          // staged keys: ids 0, step, 2 step, ... < C
  int steps;       // ceil(log2 ns): the search of the staged keys
  int ids_vec;     // ids is 16-byte aligned: a window is read as int4s
  int anc_staged;  // anc_table is in shared memory
  int anc_vec;     // anc_table (where it lies) is 16-byte aligned
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Stage the keys (and anc_table, if it fits) in shared memory.
__device__ __forceinline__ void stage(const Table& t, int D, int32_t* s_keys,
                                      int32_t* s_anc) {
  for (int i = threadIdx.x; i < t.ns; i += blockDim.x) {
    s_keys[i] = __ldg(t.ids + (int64_t)i * t.step);
  }
  if (t.anc_staged) {
    for (int i = threadIdx.x; i < t.C * D; i += blockDim.x) {
      s_anc[i] = __ldg(t.anc + i);
    }
  }
}

// The lower bounds of Q queries at once, clipped to C - 1: pos[k] is the
// slot where sorted_ids holds v[k], else -1.  Each search of the staged
// keys runs the same fixed number of branch-free steps (lb in [base, base
// + len]: probe base + len / 2), so the Q chains of shared-memory loads are
// independent and interleave.  When Sampled, a staged keys lie below v[k]:
// its lower bound is in the window of step ids from the last of them, (a -
// 1) step, read whole, counting the ids below v[k] and looking for v[k]
// itself (ids past C count as neither).  Staged key a, just past the
// window, is the one other id that can hold v[k].
template <int Q, bool Sampled>
__device__ __forceinline__ void search(const Table& t, const int32_t* s_keys,
                                       const int32_t (&v)[Q], int (&pos)[Q]) {
  int a[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) a[k] = 0;
  int len = t.ns;
  for (int s = 0; s < t.steps; ++s) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < Q; ++k) a[k] += s_keys[a[k] + half] < v[k] ? half : 0;
    len -= half;
  }
  int lb[Q];
  bool eq[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    a[k] += s_keys[a[k]] < v[k];
    lb[k] = a[k];
    eq[k] = false;
  }
  if constexpr (Sampled) {
    int w0[Q];  // the window's first id, below v[k] (none below: a = 0)
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      w0[k] = a[k] == 0 ? 0 : (a[k] - 1) * t.step;
      lb[k] = w0[k];
    }
    const int4* ids4 = reinterpret_cast<const int4*>(t.ids);
#pragma unroll 2
    for (int j = 0; j < t.step; j += 4) {
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const int i = w0[k] + j;
        int4 x;
        if (t.ids_vec) {
          x = __ldg(ids4 + (min(i, t.C - 1) >> 2));
        } else {
          x = make_int4(__ldg(t.ids + min(i, t.C - 1)),
                        __ldg(t.ids + min(i + 1, t.C - 1)),
                        __ldg(t.ids + min(i + 2, t.C - 1)),
                        __ldg(t.ids + min(i + 3, t.C - 1)));
        }
        const int32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = a[k] > 0 && i + e < t.C;
          lb[k] += in && xs[e] < v[k];
          eq[k] |= in && xs[e] == v[k];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const bool hit =
        eq[k] || (a[k] < t.ns && s_keys[min(a[k], t.ns - 1)] == v[k]);
    pos[k] = hit ? min(lb[k], t.C - 1) : -1;
  }
}

template <int Q>
__device__ __forceinline__ void search_any(const Table& t,
                                           const int32_t* s_keys,
                                           const int32_t (&v)[Q],
                                           int (&pos)[Q]) {
  if (t.step > 1) {
    search<Q, true>(t, s_keys, v, pos);
  } else {
    search<Q, false>(t, s_keys, v, pos);
  }
}

// A thread's four rows (ancestor rows pos[0..3], or -1s) as D 16-byte
// words.  The row r and column c of each element are counted, not divided
// out; with D exact and the loop unrolled both are constants.  With
// D % 4 == 0 a word is four ids of one row, read as one 16-byte word.
template <int DT, bool Exact>
__device__ __forceinline__ void emit_rows(int4* dst, int D, const int (&pos)[4],
                                          const int32_t* anc, int anc_vec) {
  int r = 0, c = 0;
  const bool whole = (D & 3) == 0 && anc_vec;
#pragma unroll (Exact ? DT : 1)
  for (int w = 0; w < D; ++w) {
    if (whole) {
      const int p = r == 0 ? pos[0] : r == 1 ? pos[1] : r == 2 ? pos[2] : pos[3];
      dst[w] = p >= 0 ? *reinterpret_cast<const int4*>(anc + p * D + c)
                      : make_int4(-1, -1, -1, -1);
      if ((c += 4) == D) {
        c = 0;
        ++r;
      }
      continue;
    }
    int32_t e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = r == 0 ? pos[0] : r == 1 ? pos[1] : r == 2 ? pos[2] : pos[3];
      e[k] = p >= 0 ? anc[p * D + c] : -1;
      if (++c == D) {
        c = 0;
        ++r;
      }
    }
    dst[w] = make_int4(e[0], e[1], e[2], e[3]);
  }
}

template <int DT, bool Exact, bool Sampled>
__global__ void __launch_bounds__(kThreads)
closure_expand_quads(const int32_t* __restrict__ conc, int64_t n, int vec,
                     Table t, int d_rt, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  const int D = Exact ? DT : d_rt;
  int32_t* s_keys = smem;
  int32_t* s_anc = smem + round4(t.ns);
  int4* s_rows = reinterpret_cast<int4*>(
      s_anc + (t.anc_staged ? round4(t.C * D) : 0));
  stage(t, D, s_keys, s_anc);
  __syncthreads();
  const int32_t* anc = t.anc_staged ? s_anc : t.anc;
  const int lane = threadIdx.x & 31;
  int4* w_rows = s_rows + (threadIdx.x >> 5) * 32 * D;  // the warp's rows
  int4* out4 = reinterpret_cast<int4*>(out);

  const int64_t nq = n >> 2;  // whole quads; quad g is queries 4g .. 4g + 3
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  auto load = [&](int64_t g) {
    if (g >= nq) return make_int4(0, 0, 0, 0);
    if (vec) return __ldg(reinterpret_cast<const int4*>(conc) + g);
    const int32_t* p = conc + 4 * g;
    return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  };
  int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int4 cur = load(g);
  // the warp's first quad bounds the loop, so every lane reaches the
  // __syncwarps; lanes past nq search and write nothing
  for (int64_t g0 = g - lane; g0 < nq; g0 += stride, g += stride) {
    const int4 nxt = load(g + stride);
    const int32_t v[4] = {cur.x, cur.y, cur.z, cur.w};
    int pos[4];
    search<4, Sampled>(t, s_keys, v, pos);
    emit_rows<DT, Exact>(w_rows + lane * D, D, pos, anc, t.anc_vec);
    __syncwarp();
    const int words = (nq - g0 < 32 ? (int)(nq - g0) : 32) * D;
    int4* dst = out4 + g0 * D;
    for (int i = lane; i < words; i += 32) __stcs(dst + i, w_rows[i]);
    __syncwarp();  // w_rows is rewritten by the next step
    cur = nxt;
  }
  // the last n % 4 queries, one a thread of CTA 0
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const int64_t q = 4 * nq + threadIdx.x;
    const int32_t v[1] = {__ldg(conc + q)};
    int pos[1];
    search<1, Sampled>(t, s_keys, v, pos);
    for (int c = 0; c < D; ++c) {
      out[q * D + c] = pos[0] >= 0 ? anc[pos[0] * D + c] : -1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
closure_expand_wide(const int32_t* __restrict__ conc, int64_t n, Table t,
                    int D, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int row_of[kThreads];  // ancestor row per query; -1 = a miss
  stage(t, D, smem, nullptr);
  __syncthreads();
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t r0 = tile * kThreads;
    const int64_t q = r0 + threadIdx.x;
    if (q < n) {
      const int32_t v[1] = {__ldg(conc + q)};
      int pos[1];
      search_any<1>(t, smem, v, pos);
      row_of[threadIdx.x] = pos[0];
    }
    __syncthreads();
    // offsets inside a tile fit 32 bits: no 64-bit division per element
    const int rows = n - r0 < kThreads ? (int)(n - r0) : kThreads;
    const int total = rows * D;
    int32_t* dst = out + r0 * D;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int r = e / D;
      const int pos = row_of[r];
      dst[e] = pos >= 0 ? __ldg(t.anc + (int64_t)pos * D + (e - r * D)) : -1;
    }
    __syncthreads();  // row_of is rewritten by the next tile
  }
}

int ceil_log2(int x) { return x <= 1 ? 0 : 32 - __builtin_clz((unsigned)(x - 1)); }

Table make_table(const void* ids, const void* anc, int C, int D, bool wide) {
  Table t;
  t.ids = static_cast<const int32_t*>(ids);
  t.anc = static_cast<const int32_t*>(anc);
  t.C = C;
  t.step = C <= kStageMax ? 1 : round4((C + kSampleMax - 1) / kSampleMax);
  t.ns = (C + t.step - 1) / t.step;
  t.steps = ceil_log2(t.ns);
  t.ids_vec = (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  t.anc_staged = !wide && (long long)C * D <= kAncStage;
  t.anc_vec = t.anc_staged || (reinterpret_cast<uintptr_t>(anc) & 15) == 0;
  return t;
}

// The CTAs of ``kernel`` that fill the current device (at least one a
// multiprocessor), or -1 when it cannot be granted ``smem`` bytes of
// dynamic shared memory: past 48 KB, ``opt_in`` (the kernel's) opts it
// into the device's most, once per device.
template <class K>
long long fill_grid(K kernel, size_t smem, SmemOptIn& opt_in) {
  if (smem > 48 * 1024 && opt_in(kernel) != cudaSuccess) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  return (long long)(per_sm > 0 ? per_sm : 1) * sms;
}

template <int DT, bool Exact, bool Sampled>
int launch(const int32_t* conc, long long n, const Table& t, int D,
           int32_t* out, cudaStream_t stream) {
  auto kernel = closure_expand_quads<DT, Exact, Sampled>;
  // the keys, anc_table if staged, and each thread's four rows
  const size_t smem = sizeof(int32_t) * (round4(t.ns) +
                                         (t.anc_staged ? round4(t.C * D) : 0)) +
                      (size_t)kThreads * D * sizeof(int4);
  static SmemOptIn opt_in;
  const long long fill = fill_grid(kernel, smem, opt_in);
  if (fill < 0) return (int)cudaErrorInvalidValue;
  const long long quads = n >> 2;
  const long long need = quads > 0 ? (quads + kThreads - 1) / kThreads : 1;
  const unsigned grid = (unsigned)(need < fill ? need : fill);
  const int vec = (reinterpret_cast<uintptr_t>(conc) & 15) == 0;
  kernel<<<grid, kThreads, smem, stream>>>(conc, n, vec, t, D, out);
  return (int)cudaGetLastError();
}

template <int DT, bool Exact>
int launch_quads(const int32_t* conc, long long n, const Table& t, int D,
                 int32_t* out, cudaStream_t stream) {
  return t.step > 1 ? launch<DT, Exact, true>(conc, n, t, D, out, stream)
                    : launch<DT, Exact, false>(conc, n, t, D, out, stream);
}

}  // namespace

// conc: contiguous int32[n]; ids: sorted int32[C]; anc: contiguous
// int32[C, D]; out: int32[n, D], 16-byte aligned.  Requires n, C and
// D >= 1, C D < 2^31 and, for D > 32, 256 D < 2^31.
extern "C" int closure_expand(const void* conc, long long n, const void* ids,
                              int C, const void* anc, int D, void* out,
                              void* stream) {
  const int32_t* q = static_cast<const int32_t*>(conc);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Table t = make_table(ids, anc, C, D, D > 32);
  switch (D) {
    case 1: return launch_quads<1, true>(q, n, t, D, o, st);
    case 2: return launch_quads<2, true>(q, n, t, D, o, st);
    case 3: return launch_quads<3, true>(q, n, t, D, o, st);
    case 4: return launch_quads<4, true>(q, n, t, D, o, st);
    case 5: return launch_quads<5, true>(q, n, t, D, o, st);
    case 6: return launch_quads<6, true>(q, n, t, D, o, st);
    case 7: return launch_quads<7, true>(q, n, t, D, o, st);
    case 8: return launch_quads<8, true>(q, n, t, D, o, st);
    default: break;
  }
  if (D <= 16) return launch_quads<16, false>(q, n, t, D, o, st);
  if (D <= 32) return launch_quads<32, false>(q, n, t, D, o, st);
  const size_t smem = sizeof(int32_t) * round4(t.ns);
  const long long tiles = (n + kThreads - 1) / kThreads;
  static SmemOptIn opt_in;
  const long long fill = fill_grid(closure_expand_wide, smem, opt_in);
  if (fill < 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles < fill ? tiles : fill);
  closure_expand_wide<<<grid, kThreads, smem, st>>>(q, n, t, D, o);
  return (int)cudaGetLastError();
}
