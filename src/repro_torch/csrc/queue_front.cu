// Front-tier queue kernels for the tiered3 pending-event set, for Hopper.
//
// window_extract replaces the Pallas kernel
//   src/repro/kernels/queue_front.py::window_extract (pl.pallas_call at :130)
// front_merge replaces the Pallas kernel
//   src/repro/kernels/queue_front.py::front_merge (pl.pallas_call at :249)
//
// Both are bit-identical to the plain PyTorch versions in
// src/repro_torch/kernels/queue_front.py: every operation is an f32
// compare, an f32 add (t + lookahead), a copy, or integer counting.
// Built without --use_fast_math so the add and the inf compares stay
// IEEE.
//
// What bounds them on an H100: at front_cap F = 256, window width k = 4
// and R = 4 emit rows, a call reads about 7 KB and writes about 7 KB --
// about 15 KB, or 5 ns of HBM time at 3.35 TB/s.  The arithmetic is a
// few thousand integer compares.  Both kernels are therefore bound by
// launch latency (a few microseconds), not by bytes or operations.  The
// design answers that by doing each step's work in ONE launch of ONE
// block: one launch per super-step for each kernel, no host-side
// padding or concatenation around it, and every intermediate (window
// bounds, ranks, insertion points) kept in shared memory.  Fusing the
// two kernels, or capturing a super-step in a CUDA graph, is the next
// step and is not done here.
//
// Plain C interface, loaded with ctypes.  Each launcher returns
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int32_t kI32Max = 2147483647;
constexpr int kMaxWindow = 32;

// --------------------------------------------------------------------
// window_extract: the §III-B take rule over the first k front slots,
// then the prefix pop (every front column shifted left by `length`).
// --------------------------------------------------------------------
__global__ void window_extract_kernel(
    const float* __restrict__ f_times, const int32_t* __restrict__ f_types,
    const float* __restrict__ f_args, const int32_t* __restrict__ f_seqs,
    const float* __restrict__ lookaheads, int num_types, float t_cap,
    int F, int W, int k,
    float* __restrict__ ts, int32_t* __restrict__ tys,
    float* __restrict__ args, int32_t* __restrict__ length_out,
    float* __restrict__ nt, int32_t* __restrict__ ny,
    float* __restrict__ na, int32_t* __restrict__ ns) {
  __shared__ float s_win[kMaxWindow];
  __shared__ int s_ok[kMaxWindow];
  __shared__ int s_len;
  const int tid = threadIdx.x;

  float t = 0.0f;
  int y = -1;
  bool valid = false;
  if (tid < k) {
    t = f_times[tid];
    y = f_types[tid];
    valid = y >= 0;
    const int tyc = min(max(y, 0), num_types - 1);
    s_win[tid] = valid ? t + lookaheads[tyc] : INFINITY;
  }
  __syncthreads();
  if (tid < k) {
    // Exclusive cummin of the window bounds: t_max before lane tid.
    float t_max = INFINITY;
    for (int j = 0; j < tid; ++j) t_max = fminf(t_max, s_win[j]);
    s_ok[tid] = valid && (t <= fminf(t_max, t_cap));
  }
  __syncthreads();
  if (tid == 0) {
    // Prefix-AND: the window ends at the first rejected lane.
    int len = 0;
    while (len < k && s_ok[len]) ++len;
    s_len = len;
    length_out[0] = len;
  }
  __syncthreads();
  const int len = s_len;
  if (tid < k) {
    const bool take = tid < len;
    ts[tid] = take ? t : 0.0f;
    tys[tid] = take ? y : 0;
    for (int w = 0; w < W; ++w)
      args[tid * W + w] = take ? f_args[tid * W + w] : 0.0f;
  }
  // Prefix pop: slot i takes slot i + len; past the end, the free-slot
  // sentinels (inf, -1, 0, INT32_MAX).
  for (int i = tid; i < F; i += blockDim.x) {
    const int src = i + len;
    if (src < F) {
      nt[i] = f_times[src];
      ny[i] = f_types[src];
      ns[i] = f_seqs[src];
      for (int w = 0; w < W; ++w) na[i * W + w] = f_args[src * W + w];
    } else {
      nt[i] = INFINITY;
      ny[i] = -1;
      ns[i] = kI32Max;
      for (int w = 0; w < W; ++w) na[i * W + w] = 0.0f;
    }
  }
}

// --------------------------------------------------------------------
// front_merge: counting-merge of R emit rows into the sorted front.
// Output columns are F + R wide; slots [F, F + R) are the evicted tail.
// --------------------------------------------------------------------
__global__ void front_merge_kernel(
    const float* __restrict__ f_times, const int32_t* __restrict__ f_types,
    const float* __restrict__ f_args, const int32_t* __restrict__ f_seqs,
    const int32_t* __restrict__ front_n_ptr,
    const float* __restrict__ t_r, const int32_t* __restrict__ ty_r,
    const float* __restrict__ arg_r, const int32_t* __restrict__ seq_r,
    const uint8_t* __restrict__ to_front, int F, int R, int W,
    float* __restrict__ mt, int32_t* __restrict__ my,
    float* __restrict__ ma, int32_t* __restrict__ ms) {
  extern __shared__ int smem[];
  int* s_order = smem;      // s_order[rank] = row
  int* s_pos = smem + R;    // merged position of the rank-th row
  const int tid = threadIdx.x;
  const int FE = F + R;

  if (tid < R) {
    // Lex rank by (time, seq, index); rows not bound for the front get
    // the (inf, INT32_MAX) key so they rank last.
    const bool in_i = to_front[tid] != 0;
    const float ti = in_i ? t_r[tid] : INFINITY;
    const int32_t si = in_i ? seq_r[tid] : kI32Max;
    int rank = 0;
    for (int j = 0; j < R; ++j) {
      const bool in_j = to_front[j] != 0;
      const float tj = in_j ? t_r[j] : INFINITY;
      const int32_t sj = in_j ? seq_r[j] : kI32Max;
      const bool before = (ti > tj) || (ti == tj && si > sj) ||
                          (ti == tj && si == sj && tid > j);
      rank += before;
    }
    s_order[rank] = tid;
  }
  __syncthreads();
  if (tid < R) {
    // searchsorted(f_times, rt, right) as a count over the sorted
    // front, capped at the live occupancy.
    const int row = s_order[tid];
    const bool ins = to_front[row] != 0;
    const float rt = ins ? t_r[row] : INFINITY;
    int older = 0;
    for (int f = 0; f < F; ++f) older += f_times[f] <= rt;
    older = min(older, front_n_ptr[0]);
    s_pos[tid] = ins ? older + tid : FE + R;
  }
  __syncthreads();
  for (int i = tid; i < FE; i += blockDim.x) {
    int ins_before = 0;
    int ins_upto = 0;
    for (int r = 0; r < R; ++r) {
      ins_before += s_pos[r] < i;
      ins_upto += s_pos[r] <= i;
    }
    if (ins_upto > ins_before) {
      const int row = s_order[min(max(ins_before, 0), R - 1)];
      mt[i] = t_r[row];
      my[i] = ty_r[row];
      ms[i] = seq_r[row];
      for (int w = 0; w < W; ++w) ma[i * W + w] = arg_r[row * W + w];
    } else {
      const int src = min(max(i - ins_before, 0), FE - 1);
      if (src < F) {
        mt[i] = f_times[src];
        my[i] = f_types[src];
        ms[i] = f_seqs[src];
        for (int w = 0; w < W; ++w) ma[i * W + w] = f_args[src * W + w];
      } else {
        mt[i] = INFINITY;
        my[i] = -1;
        ms[i] = kI32Max;
        for (int w = 0; w < W; ++w) ma[i * W + w] = 0.0f;
      }
    }
  }
}

int block_threads(int n) {
  const int rounded = (n + 31) / 32 * 32;
  return rounded < 1024 ? rounded : 1024;
}

}  // namespace

extern "C" int window_extract_launch(
    const float* f_times, const int32_t* f_types, const float* f_args,
    const int32_t* f_seqs, const float* lookaheads, int num_types,
    float t_cap, int F, int W, int k, float* ts, int32_t* tys, float* args,
    int32_t* length, float* nt, int32_t* ny, float* na, int32_t* ns,
    void* stream) {
  if (k < 1 || k > kMaxWindow || k > F) return (int)cudaErrorInvalidValue;
  window_extract_kernel<<<1, block_threads(F + k), 0,
                          (cudaStream_t)stream>>>(
      f_times, f_types, f_args, f_seqs, lookaheads, num_types, t_cap, F, W,
      k, ts, tys, args, length, nt, ny, na, ns);
  return (int)cudaGetLastError();
}

extern "C" int front_merge_launch(
    const float* f_times, const int32_t* f_types, const float* f_args,
    const int32_t* f_seqs, const int32_t* front_n, const float* t_r,
    const int32_t* ty_r, const float* arg_r, const int32_t* seq_r,
    const uint8_t* to_front, int F, int R, int W, float* mt, int32_t* my,
    float* ma, int32_t* ms, void* stream) {
  const int threads = block_threads(F + R);
  if (R < 1 || R > threads) return (int)cudaErrorInvalidValue;
  front_merge_kernel<<<1, threads, 2 * R * sizeof(int),
                       (cudaStream_t)stream>>>(
      f_times, f_types, f_args, f_seqs, front_n, t_r, ty_r, arg_r, seq_r,
      to_front, F, R, W, mt, my, ma, ms);
  return (int)cudaGetLastError();
}
