// Mamba selective scan (the SSM recurrence of a mamba mixer), for Hopper.
//
// mamba_scan replaces the Pallas kernel
//   src/repro/kernels/mamba_scan.py::mamba_scan_pallas
//   (pl.pallas_call at :87)
// and computes the recurrence its oracle writes down
// (src/repro/kernels/ref.py::mamba_scan_ref), per channel (b, i):
//
//   h_t[n] = exp(dt_t * A[i,n]) * h_{t-1}[n] + xdt_t * B_t[n],   h_0 = 0
//   y_t    = sum_n C_t[n] * h_t[n]
//
// xdt and dt are [B,T,I], bc (B_t) and cc (C_t) are [B,T,N], a is [I,N]
// (negative), y is [B,T,I] f32, and the final state h_T goes to h_out,
// [B,I,N] f32.  The Pallas kernel drops h_T; the model's prefill needs it
// for the decode cache, and the thread already holds it.
//
// On the TPU the grid (B, I/block_i, chunks) walks the chunk axis in
// order with h [block_i, N] in VMEM scratch.  Hopper's blocks run in
// parallel with nothing carried between them, so here one thread owns one
// channel (b, i) and walks T itself:
//  * h[0:N] and A[i, 0:N] live in registers (N = 4, 8 or 16, a template
//    argument); no thread reads another's state, so a token needs no
//    barrier;
//  * consecutive threads take consecutive i, so the reads of xdt and dt
//    and the writes of y are coalesced; a thread loads a whole tile of its
//    xdt/dt values into registers before it walks the tile, so kTile
//    loads are in flight at once;
//  * a block stages kTile rows of bc and cc for its b in shared memory
//    (one barrier pair a tile); every channel of the block reads them as
//    broadcasts;
//  * 64 threads a block: at B 1 and I 16384 that is 256 blocks on 132 SMs.
// Every decay factor is exp(dt * A) <= 1 for dt >= 0 and A < 0: nothing
// is clipped and nothing overflows, however large dt is.  Inputs are f32
// or bf16 (a: f32 or the inputs' type) and are read through their
// strides (the last dim contiguous), so bc and cc may be column slices of
// the model's x_proj output.  Every product and sum is f32; no fast math
// (expf is the accurate one).  T may be any length: no chunk, no padding.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the
// tensor cores): bytes.  At the serving prefill (B 1, T 16, I 16384,
// N 16, f32) it moves 5.24 MB (xdt, dt, y: 3 MB; a and h_T: 2 MB): 1.6 us.
// At T 2048 it moves 405 MB: 121 us; its 2048 * 16384 * 16 = 5.4e8 expf
// take about 0.13 ms on the special-function units, the same order.  What
// holds this design back at the serving shape is the serial walk: T
// dependent steps of N exp/fma chains in each thread.
//
// Plain C interface, loaded with ctypes.  The launcher returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // channels a block
constexpr int kTile = 16;      // tokens staged per barrier pair

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Element strides of the [B, T] dims of one [B,T,*] operand.
struct Strides2 {
  long long b, t;
};

struct ScanArgs {
  const void* xdt;
  const void* dt;
  const void* bc;
  const void* cc;
  const void* a;
  float* y;
  float* h_out;
  int T, I;
  Strides2 sx, sd, sb, sc, sy;
  long long sa;   // a's row stride
};

template <typename In, typename TA, int N>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(ScanArgs p) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < p.I;

  __shared__ float s_b[kTile][N];
  __shared__ float s_c[kTile][N];

  const In* xdt = static_cast<const In*>(p.xdt) + b * p.sx.b + i;
  const In* dt = static_cast<const In*>(p.dt) + b * p.sd.b + i;
  const In* bc = static_cast<const In*>(p.bc) + b * p.sb.b;
  const In* cc = static_cast<const In*>(p.cc) + b * p.sc.b;
  float* y = p.y + b * p.sy.b + i;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? to_f32(static_cast<const TA*>(p.a)[i * p.sa + n]) : 0.f;
    h[n] = 0.f;
  }

  for (int t0 = 0; t0 < p.T; t0 += kTile) {
    const int nt = min(kTile, p.T - t0);
    __syncthreads();   // every thread has walked the previous tile
    for (int e = threadIdx.x; e < nt * N; e += kThreads) {
      const int j = e / N;
      const int n = e - j * N;
      const long long t = t0 + j;
      s_b[j][n] = to_f32(bc[t * p.sb.t + n]);
      s_c[j][n] = to_f32(cc[t * p.sc.t + n]);
    }
    __syncthreads();
    if (!live) continue;
    float xs[kTile], ds[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < nt) {
        const long long t = t0 + j;
        xs[j] = to_f32(xdt[t * p.sx.t]);
        ds[j] = to_f32(dt[t * p.sd.t]);
      }
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < nt) {
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float decay = expf(ds[j] * a[n]);
          h[n] = fmaf(decay, h[n], xs[j] * s_b[j][n]);
          acc = fmaf(h[n], s_c[j][n], acc);
        }
        y[(t0 + j) * p.sy.t] = acc;
      }
    }
  }

  if (live) {
    float4* ho = reinterpret_cast<float4*>(
        p.h_out + ((long long)b * p.I + i) * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      ho[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

template <typename In, typename TA, int N>
int launch_n(const ScanArgs& p, int B, cudaStream_t stream) {
  const dim3 grid((p.I + kThreads - 1) / kThreads, B);
  mamba_scan_kernel<In, TA, N><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename In, typename TA>
int launch_t(const ScanArgs& p, int B, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch_n<In, TA, 4>(p, B, stream);
    case 8: return launch_n<In, TA, 8>(p, B, stream);
    case 16: return launch_n<In, TA, 16>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xdt, dt, bc and cc alike); a_dtype
// the same code for a (float32, or dtype).
// strides (elements, last dims 1): xdt, dt, bc, cc and y as (b, t) each,
// then a's row stride: 11 values.  h_out is a contiguous [B,I,N].
extern "C" int mamba_scan_launch(int dtype, int a_dtype, const void* xdt,
                                 const void* dt, const void* bc,
                                 const void* cc, const void* a, float* y,
                                 float* h_out, int B, int T, int I, int N,
                                 const long long* strides, void* stream) {
  if (B < 1 || T < 1 || I < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (a_dtype != 0 && a_dtype != dtype) return (int)cudaErrorInvalidValue;
  ScanArgs p;
  p.xdt = xdt;
  p.dt = dt;
  p.bc = bc;
  p.cc = cc;
  p.a = a;
  p.y = y;
  p.h_out = h_out;
  p.T = T;
  p.I = I;
  Strides2* dims[5] = {&p.sx, &p.sd, &p.sb, &p.sc, &p.sy};
  for (int d = 0; d < 5; ++d) {
    dims[d]->b = strides[2 * d];
    dims[d]->t = strides[2 * d + 1];
  }
  p.sa = strides[10];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_t<float, float>(p, B, N, s);
  if (dtype == 1 && a_dtype == 0)
    return launch_t<__nv_bfloat16, float>(p, B, N, s);
  if (dtype == 1) return launch_t<__nv_bfloat16, __nv_bfloat16>(p, B, N, s);
  return (int)cudaErrorInvalidValue;
}
