// Front-tier queue kernels for the tiered3 pending-event set, for Hopper.
//
// window_extract replaces the Pallas kernel
//   src/repro/kernels/queue_front.py::window_extract (pl.pallas_call at :130)
// front_merge replaces the Pallas kernel
//   src/repro/kernels/queue_front.py::front_merge (pl.pallas_call at :249)
//
// Both are bit-identical to the plain PyTorch versions in
// src/repro_torch/kernels/queue_front.py: every operation is an f32
// compare, an f32 add (t + lookahead), a min, a copy, or integer
// counting.  Built without --use_fast_math so the add and the inf
// compares stay IEEE.
//
// What bounds them on an H100: at front_cap F = 256, window width k = 4
// and R = 4 emit rows, a call reads about 7 KB and writes about 7 KB --
// about 15 KB, or 5 ns of HBM time at 3.35 TB/s.  The arithmetic is a
// few thousand integer compares.  Both kernels are therefore bound by
// latency: the launch, and then the chain of dependent steps inside the
// one block a call runs.  The design shortens that chain:
//  * Every load that does not depend on a result (the front slots a
//    thread will write, the window's slots, the lookahead table, the
//    emit rows) is issued first, together: one memory latency.
//  * window_extract: the take rule runs in one warp, recomputed by every
//    warp from the same k <= 32 slots, so no warp waits on another: the
//    window bound t + la sits in a register (la picked from the table by
//    a shuffle), the exclusive cummin is a 5-step __shfl_up_sync scan
//    with fminf, the prefix-AND a __ballot_sync and __ffs.  No shared
//    memory and no barrier.  The pop shifts by length <= 32, so each
//    thread holds its own slot and the one 32 slots on, and takes its
//    output from a lane of either by shuffle.
//  * front_merge, R <= 32 emit rows: each warp holds the R row keys in
//    its lanes and ranks them by shuffles.  The insertion points are
//    counted the other way round: every thread holds one front time,
//    and each warp counts its times <= each row's time with
//    __ballot_sync + __popc; the per-warp counts meet in shared memory
//    (the one barrier).  Each slot then finds the rows inserted before
//    it and at it from the R positions by shuffle, and takes its value
//    from its own slot, the slot 32 back (insertions shift by <= R), or
//    the inserted row, all already in registers.  More rows, or a front
//    wider than a block, take a general kernel with the keys staged in
//    shared memory once (two barriers).
//  * Arg rows of W = 4 floats move as one 16-byte load and store where
//    the pointers allow.
//
// Two modes serve the spill policy and streamed arrivals.
//  * window_extract's lex fence: a candidate is valid only if its
//    (time, seq) key is strictly lex-before (bound_t, bound_seq), two
//    0-d device scalars read with the window's slots.  A closed run
//    passes (inf, INT32_MAX): one kernel signature, no host read.
//  * front_merge's lex placement (lex != 0): a row's insertion point is
//    the count of occupied front slots strictly lex-before its (time,
//    seq) key, where the default counts front times <= its time, capped
//    at front_n.  Reabsorbed rows carry seqs older than queued ones, so
//    a time tie needs the seq.  The same ballot counts either predicate.
//
// Plain C interface, loaded with ctypes; each launcher takes its
// tensors' pointers in one array and returns cudaGetLastError() right
// after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int32_t kI32Max = 2147483647;
constexpr int kMaxWindow = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegW = 4;  // arg widths up to this are held in registers
constexpr int kExtractThreads = 256;  // window_extract loops past them
constexpr int kMergeSlots = 512;      // F + R the one-slot-a-thread merge takes

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// One slot of the four front columns; NA > 0 keeps its args in registers
// (W <= NA), NA == 0 leaves them in memory.
template <int NA>
struct Slot {
  float t;
  int32_t y, s;
  float a[NA > 0 ? NA : 1];
};

// Slot i of (t, y, a, s), or the free-slot sentinels (inf, -1, 0,
// INT32_MAX) outside [0, n).
template <int NA>
__device__ __forceinline__ Slot<NA> load_slot(
    const float* __restrict__ t, const int32_t* __restrict__ y,
    const float* __restrict__ a, const int32_t* __restrict__ s, int i,
    int n, int W, bool vec) {
  Slot<NA> x;
  if (i >= 0 && i < n) {
    x.t = t[i];
    x.y = y[i];
    x.s = s[i];
    if constexpr (NA > 0) {
      if (vec) {
        const float4 v = reinterpret_cast<const float4*>(a)[i];
        x.a[0] = v.x;
        x.a[1] = v.y;
        x.a[2] = v.z;
        x.a[3] = v.w;
      } else {
#pragma unroll
        for (int w = 0; w < NA; ++w) x.a[w] = w < W ? a[i * W + w] : 0.0f;
      }
    }
  } else {
    x.t = INFINITY;
    x.y = -1;
    x.s = kI32Max;
#pragma unroll
    for (int w = 0; w < (NA > 0 ? NA : 1); ++w) x.a[w] = 0.0f;
  }
  return x;
}

template <int NA>
__device__ __forceinline__ Slot<NA> shfl_slot(const Slot<NA>& x, int src) {
  Slot<NA> r;
  r.t = __shfl_sync(kFull, x.t, src);
  r.y = __shfl_sync(kFull, x.y, src);
  r.s = __shfl_sync(kFull, x.s, src);
#pragma unroll
  for (int w = 0; w < NA; ++w) r.a[w] = __shfl_sync(kFull, x.a[w], src);
  return r;
}

// x or y, both already computed by every lane: pick(c, shfl_slot(..),
// shfl_slot(..)) runs both shuffles on the whole warp, where a ?: would
// run one of them on part of it.
template <int NA>
__device__ __forceinline__ Slot<NA> pick(bool first, const Slot<NA>& x,
                                         const Slot<NA>& y) {
  return first ? x : y;
}

// Writes slot i.  With NA == 0 the args are copied from row `arow` of
// `asrc` (nullptr: zeros).
template <int NA>
__device__ __forceinline__ void store_slot(
    float* __restrict__ t, int32_t* __restrict__ y, float* __restrict__ a,
    int32_t* __restrict__ s, int i, int W, bool vec, const Slot<NA>& x,
    const float* asrc, int arow) {
  t[i] = x.t;
  y[i] = x.y;
  s[i] = x.s;
  if constexpr (NA > 0) {
    if (vec) {
      reinterpret_cast<float4*>(a)[i] =
          make_float4(x.a[0], x.a[1], x.a[2], x.a[3]);
    } else {
#pragma unroll
      for (int w = 0; w < NA; ++w)
        if (w < W) a[i * W + w] = x.a[w];
    }
  } else {
    for (int w = 0; w < W; ++w)
      a[i * W + w] = asrc ? asrc[(long long)arow * W + w] : 0.0f;
  }
}

// --------------------------------------------------------------------
// window_extract: the §III-B take rule over the first k front slots,
// then the prefix pop (every front column shifted left by `length`).
// One block; thread i writes slot i (looping past the block).
// --------------------------------------------------------------------
template <int NA>
__global__ void __launch_bounds__(kExtractThreads) window_extract_kernel(
    const float* __restrict__ f_times, const int32_t* __restrict__ f_types,
    const float* __restrict__ f_args, const int32_t* __restrict__ f_seqs,
    const float* __restrict__ lookaheads, const float* __restrict__ bound_t,
    const int32_t* __restrict__ bound_seq, int num_types, float t_cap,
    int F, int W, int k,
    float* __restrict__ ts, int32_t* __restrict__ tys,
    float* __restrict__ args, int32_t* __restrict__ length_out,
    float* __restrict__ nt, int32_t* __restrict__ ny,
    float* __restrict__ na, int32_t* __restrict__ ns) {
  const int lane = threadIdx.x & 31;
  const bool vec_in = NA > 0 && W == kRegW && aligned16(f_args);
  const bool vec_out = NA > 0 && W == kRegW && aligned16(na);

  // Issued together: the window's slots, the fence, the lookahead table,
  // and the two slots this thread's first output comes from.
  float t = INFINITY;
  int32_t y = -1, sq = kI32Max;
  if (lane < k) {
    t = f_times[lane];
    y = f_types[lane];
    sq = f_seqs[lane];
  }
  const float bt = bound_t[0];
  const int32_t bs = bound_seq[0];
  const float la_lane = lane < num_types ? lookaheads[lane] : 0.0f;
  int i = threadIdx.x;
  Slot<NA> cur = load_slot<NA>(f_times, f_types, f_args, f_seqs, i, F, W,
                               vec_in);
  Slot<NA> nxt = load_slot<NA>(f_times, f_types, f_args, f_seqs, i + 32, F,
                               W, vec_in);

  // The take rule, in this warp's registers; the fence cuts the
  // candidates to those lex-before (bt, bs).
  const bool valid = lane < k && y >= 0 && (t < bt || (t == bt && sq < bs));
  const int tyc = min(max(y, 0), num_types - 1);
  float la;
  if (num_types <= 32) {
    la = __shfl_sync(kFull, la_lane, tyc);
  } else {
    la = lane < k ? lookaheads[tyc] : 0.0f;
  }
  float cm = valid ? t + la : INFINITY;  // window bound, then its cummin
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, cm, off);
    if (lane >= off) cm = fminf(cm, o);
  }
  float t_max = __shfl_up_sync(kFull, cm, 1);  // exclusive: lanes before
  if (lane == 0) t_max = INFINITY;
  const bool ok = valid && t <= fminf(t_max, t_cap);
  // Prefix-AND: the window ends at the first rejected lane (lanes >= k
  // are rejected, so length <= k).
  const unsigned bad = ~__ballot_sync(kFull, ok);
  const int len = bad ? __ffs(bad) - 1 : 32;

  if (threadIdx.x < k) {  // warp 0: its slot i is window slot i
    const bool take = lane < len;
    ts[lane] = take ? t : 0.0f;
    tys[lane] = take ? y : 0;
    for (int w = 0; w < W; ++w) {
      float v = 0.0f;
      if constexpr (NA > 0) {
#pragma unroll
        for (int u = 0; u < NA; ++u)
          if (u == w) v = cur.a[u];
      } else {
        v = f_args[lane * W + w];
      }
      args[lane * W + w] = take ? v : 0.0f;
    }
  }
  if (threadIdx.x == 0) length_out[0] = len;

  // Prefix pop: slot i takes slot i + len (len <= 32), from lane
  // lane + len of this warp's own slots or of the slots 32 on; past F
  // both hold the sentinels.
  const int src = (lane + len) & 31;
  for (;;) {
    const Slot<NA> x = pick(lane + len < 32, shfl_slot(cur, src),
                            shfl_slot(nxt, src));
    if (i < F) {
      const int from = i + len;
      store_slot(nt, ny, na, ns, i, W, vec_out, x,
                 from < F ? f_args : nullptr, from);
    }
    i += blockDim.x;
    if (i - lane >= F) break;  // warp-uniform
    cur = load_slot<NA>(f_times, f_types, f_args, f_seqs, i, F, W, vec_in);
    nxt = load_slot<NA>(f_times, f_types, f_args, f_seqs, i + 32, F, W,
                        vec_in);
  }
}

// --------------------------------------------------------------------
// front_merge: counting-merge of R emit rows into the sorted front.
// Output columns are F + R wide; slots [F, F + R) are the evicted tail.
// --------------------------------------------------------------------

// Row a comes after row b in (time, seq, index) order.
__device__ __forceinline__ bool lex_after(float ta, int32_t sa, int ia,
                                          float tb, int32_t sb, int ib) {
  return (ta > tb) || (ta == tb && (sa > sb || (sa == sb && ia > ib)));
}

// R <= 32 and F + R <= blockDim.x: thread i writes output slot i.
template <int NA>
__global__ void __launch_bounds__(kMergeSlots) front_merge_warp_kernel(
    const float* __restrict__ f_times, const int32_t* __restrict__ f_types,
    const float* __restrict__ f_args, const int32_t* __restrict__ f_seqs,
    const int32_t* __restrict__ front_n_ptr,
    const float* __restrict__ t_r, const int32_t* __restrict__ ty_r,
    const float* __restrict__ arg_r, const int32_t* __restrict__ seq_r,
    const uint8_t* __restrict__ to_front, int F, int R, int W, int lex,
    float* __restrict__ mt, int32_t* __restrict__ my,
    float* __restrict__ ma, int32_t* __restrict__ ms) {
  // [warp][row]: the warp's front times <= the row's time
  __shared__ int s_cnt[kMergeSlots / 32][32];
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int FE = F + R;

  // Issued together: this thread's slot, the slot 32 back, the rows
  // (lane j holds row j) and front_n.
  const Slot<NA> cur = load_slot<NA>(f_times, f_types, f_args, f_seqs, i, F,
                                     W, NA > 0 && W == kRegW &&
                                                aligned16(f_args));
  const Slot<NA> prv = load_slot<NA>(f_times, f_types, f_args, f_seqs,
                                     i - 32, F, W,
                                     NA > 0 && W == kRegW &&
                                         aligned16(f_args));
  const Slot<NA> row = load_slot<NA>(t_r, ty_r, arg_r, seq_r, lane, R, W,
                                     NA > 0 && W == kRegW &&
                                         aligned16(arg_r));
  const bool in = lane < R && to_front[lane] != 0;
  const int front_n = front_n_ptr[0];
  // Rows not bound for the front get the (inf, INT32_MAX) key: last.
  const float rt = in ? row.t : INFINITY;
  const int32_t rs = in ? row.s : kI32Max;

  // Lex rank of row `lane` among the R rows, and this warp's count of
  // front times <= each row's time (lex: occupied front keys strictly
  // lex-before the row's key).
  int rank = 0, cnt = 0;
  const bool live = lex ? i < front_n : i < F;
  for (int j = 0; j < R; ++j) {
    const float tj = __shfl_sync(kFull, rt, j);
    const int32_t sj = __shfl_sync(kFull, rs, j);
    rank += lex_after(rt, rs, lane, tj, sj, j);
    const bool before = lex ? (cur.t < tj || (cur.t == tj && cur.s < sj))
                            : cur.t <= tj;
    const int c = __popc(__ballot_sync(kFull, live && before));
    if (lane == j) cnt = c;
  }
  if (lane < R) s_cnt[warp][lane] = cnt;
  __syncthreads();

  // Row `lane`'s merged position: searchsorted-right into the front,
  // capped at the live occupancy (lex: the count itself), plus its rank.
  int pos = FE + R;
  if (in) {
    int older = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) older += s_cnt[w][lane];
    pos = (lex ? older : min(older, front_n)) + rank;
  }
  // Rows inserted before slot i, and the row inserted at it.
  int before = 0, hit = -1;
  for (int j = 0; j < R; ++j) {
    const int p = __shfl_sync(kFull, pos, j);
    before += p < i;
    hit = p == i ? j : hit;
  }
  // Otherwise slot i takes front slot i - before (before <= R <= 32):
  // lane - before of this warp's slots, or of the slots 32 back.
  const int src = (lane - before) & 31;
  const Slot<NA> shifted = pick(lane >= before, shfl_slot(cur, src),
                                shfl_slot(prv, src));
  const Slot<NA> inserted = shfl_slot(row, hit & 31);
  if (i < FE) {
    const bool vec_out = NA > 0 && W == kRegW && aligned16(ma);
    if (hit >= 0) {
      store_slot(mt, my, ma, ms, i, W, vec_out, inserted, arg_r, hit);
    } else {
      const int from = i - before;
      store_slot(mt, my, ma, ms, i, W, vec_out, shifted,
                 from < F ? f_args : nullptr, from);
    }
  }
}

// Any R <= 1024 and any F: the row keys staged in shared memory once.
__global__ void __launch_bounds__(1024) front_merge_kernel(
    const float* __restrict__ f_times, const int32_t* __restrict__ f_types,
    const float* __restrict__ f_args, const int32_t* __restrict__ f_seqs,
    const int32_t* __restrict__ front_n_ptr,
    const float* __restrict__ t_r, const int32_t* __restrict__ ty_r,
    const float* __restrict__ arg_r, const int32_t* __restrict__ seq_r,
    const uint8_t* __restrict__ to_front, int F, int R, int W, int lex,
    float* __restrict__ mt, int32_t* __restrict__ my,
    float* __restrict__ ma, int32_t* __restrict__ ms) {
  extern __shared__ int smem[];
  float* s_t = reinterpret_cast<float*>(smem);  // masked row times
  int* s_s = smem + R;                           // masked row seqs
  int* s_cnt = smem + 2 * R;                     // front keys before row's
  int* s_rank = smem + 3 * R;                    // rank; -1: not inserted
  const int tid = threadIdx.x, lane = tid & 31, nthreads = blockDim.x;
  const int FE = F + R;
  const int front_n = front_n_ptr[0];

  for (int j = tid; j < R; j += nthreads) {
    const bool in = to_front[j] != 0;
    s_t[j] = in ? t_r[j] : INFINITY;
    s_s[j] = in ? seq_r[j] : kI32Max;
    s_cnt[j] = 0;
  }
  __syncthreads();
  for (int j = tid; j < R; j += nthreads) {
    int rank = 0;
    for (int o = 0; o < R; ++o)
      rank += lex_after(s_t[j], s_s[j], j, s_t[o], s_s[o], o);
    s_rank[j] = to_front[j] != 0 ? rank : -1;
  }
  // Front times <= each row's time; lex: occupied front keys strictly
  // lex-before each row's key.
  const int live_n = lex ? front_n : F;
  for (int base = tid - lane; base < F; base += nthreads) {
    const int f = base + lane;
    const float ft = f < F ? f_times[f] : INFINITY;
    const int32_t fs = f < F ? f_seqs[f] : kI32Max;
    for (int j = 0; j < R; ++j) {
      const bool before = lex ? (ft < s_t[j] || (ft == s_t[j] && fs < s_s[j]))
                              : ft <= s_t[j];
      const unsigned b = __ballot_sync(kFull, f < live_n && before);
      if (lane == 0 && b) atomicAdd(&s_cnt[j], __popc(b));
    }
  }
  __syncthreads();
  for (int i = tid; i < FE; i += nthreads) {
    int before = 0, hit = -1;
    for (int j = 0; j < R; ++j) {
      const int rank = s_rank[j];
      const int cnt = lex ? s_cnt[j] : min(s_cnt[j], front_n);
      const int p = rank >= 0 ? cnt + rank : FE + R;
      before += p < i;
      hit = p == i ? j : hit;
    }
    if (hit >= 0) {
      const Slot<0> x = load_slot<0>(t_r, ty_r, arg_r, seq_r, hit, R, W,
                                     false);
      store_slot(mt, my, ma, ms, i, W, false, x, arg_r, hit);
    } else {
      const int from = i - before;
      const Slot<0> x = load_slot<0>(f_times, f_types, f_args, f_seqs, from,
                                     F, W, false);
      store_slot(mt, my, ma, ms, i, W, false, x,
                 from < F ? f_args : nullptr, from);
    }
  }
}

int round_warps(int n) {
  const int rounded = (n + 31) / 32 * 32;
  return rounded < 1024 ? rounded : 1024;
}

}  // namespace

// ptrs: f_times, f_types, f_args, f_seqs, lookaheads, bound_t,
// bound_seq, then the outputs ts, tys, args, length, nt, ny, na, ns (one
// array, so that a call from Python converts one argument, not fifteen).
extern "C" int window_extract_launch(void* const* ptrs, int num_types,
                                     float t_cap, int F, int W, int k,
                                     void* stream) {
  if (k < 1 || k > kMaxWindow || k > F || W < 1 || num_types < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = F < kExtractThreads ? round_warps(F) : kExtractThreads;
  cudaStream_t s = (cudaStream_t)stream;
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  auto n = [&](int i) { return static_cast<int32_t*>(ptrs[i]); };
  if (W <= kRegW)
    window_extract_kernel<kRegW><<<1, threads, 0, s>>>(
        f(0), n(1), f(2), n(3), f(4), f(5), n(6), num_types, t_cap, F, W, k,
        f(7), n(8), f(9), n(10), f(11), n(12), f(13), n(14));
  else
    window_extract_kernel<0><<<1, threads, 0, s>>>(
        f(0), n(1), f(2), n(3), f(4), f(5), n(6), num_types, t_cap, F, W, k,
        f(7), n(8), f(9), n(10), f(11), n(12), f(13), n(14));
  return (int)cudaGetLastError();
}

// ptrs: f_times, f_types, f_args, f_seqs, front_n, t_r, ty_r, arg_r,
// seq_r, to_front, then the outputs mt, my, ma, ms.  lex != 0 places the
// rows by full (time, seq) keys.
extern "C" int front_merge_launch(void* const* ptrs, int F, int R, int W,
                                  int lex, void* stream) {
  if (R < 1 || R > 1024 || F < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  auto n = [&](int i) { return static_cast<int32_t*>(ptrs[i]); };
  const uint8_t* to_front = static_cast<const uint8_t*>(ptrs[9]);
  const int FE = F + R;
  if (R <= 32 && FE <= kMergeSlots) {
    const int threads = round_warps(FE);
    if (W <= kRegW)
      front_merge_warp_kernel<kRegW><<<1, threads, 0, s>>>(
          f(0), n(1), f(2), n(3), n(4), f(5), n(6), f(7), n(8), to_front, F,
          R, W, lex, f(10), n(11), f(12), n(13));
    else
      front_merge_warp_kernel<0><<<1, threads, 0, s>>>(
          f(0), n(1), f(2), n(3), n(4), f(5), n(6), f(7), n(8), to_front, F,
          R, W, lex, f(10), n(11), f(12), n(13));
  } else {
    front_merge_kernel<<<1, round_warps(FE), 4 * R * sizeof(int), s>>>(
        f(0), n(1), f(2), n(3), n(4), f(5), n(6), f(7), n(8), to_front, F, R,
        W, lex, f(10), n(11), f(12), n(13));
  }
  return (int)cudaGetLastError();
}
