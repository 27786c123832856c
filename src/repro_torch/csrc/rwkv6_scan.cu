// RWKV6 WKV scan of the rwkv6 time-mix, for Hopper.
//
// rwkv6_scan replaces the Pallas kernel
//   src/repro/kernels/rwkv6_scan.py::rwkv6_scan_pallas
//   (pl.pallas_call at :92)
// and computes the recurrence its oracle writes down
// (src/repro/kernels/ref.py::rwkv6_scan_ref), per (b, h):
//
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,     w_t = exp(logw_t),  S_0 = 0
//
// r/k/v/logw are [B,H,T,K] (V == K), u is [H,K], y is [B,H,T,K] f32, and
// the final state S_T goes to s_out, [B,H,K,K] f32 (k rows, v columns).
// The Pallas kernel drops S_T; the model's prefill needs it for the
// decode cache, and the block already holds it.
//
// On the TPU the grid (B, H, chunks) walks the chunk axis in order with
// the [K,K] state in VMEM, and each chunk is two MXU products over exact
// pair decays.  Hopper's blocks run in parallel with nothing carried
// between them, so here one block owns one (b, h) and walks T itself:
//  * K threads (K = 16, 32 or 64, a template argument); thread v keeps
//    the column S[:, v] in registers (64 floats at K = 64);
//  * a tile of up to kTile tokens of r, k, w = exp(logw), r * u and v is
//    staged in shared memory (thread i loads element i of each token, so
//    the loads are coalesced), then every thread walks the tile: per
//    token it reads the staged rows as broadcasts and does
//      y[v]  = sum_k r[k] S[k,v] + (sum_k r[k] u[k] k[k]) v[v]
//      S[k,v] = w[k] S[k,v] + k[k] v[v]
//    No thread reduces across another, so a token needs no barrier; a
//    tile needs two.
//  * Every decay factor is exp(logw) <= 1 for logw <= 0: nothing is
//    clipped and nothing overflows, however strong the decay.
// Inputs are f32 or bf16 and are read through their strides (the last
// dim contiguous), so the model's [B,T,H,K] -> [B,H,T,K] transpose is a
// view.  Every product and sum is f32; no fast math (expf is the IEEE
// one).  T may be any length: no padding, no chunk constraint.
//
// What bounds it on an H100 (3.35 TB/s): bytes.  At B = 1, H = 32,
// T = 2048, K = 64 in f32 it reads 67 MB and writes 17 MB of y: 25 us of
// HBM time; its 5 K^2 flops a token and head (1.3 GFLOP) take 20 us at
// 67 TFLOP/s on the CUDA cores.  At the serving prefill (T <= 16) it
// moves about 1 MB, well under 1 us.  What holds this design back is
// not that: B * H = 32 blocks on 132 SMs, each with T serial steps of
// about K^2 instructions a warp.  A chunked tensor-core form (the TPU's
// intra-chunk products on wgmma, the state carried across chunks) is
// later work.
//
// Plain C interface, loaded with ctypes.  The launcher returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;   // tokens staged per barrier pair

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Element strides of the [B, H, T] dims of one [B,H,T,K] operand.
struct Strides3 {
  long long b, h, t;
};

struct ScanArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* logw;
  const void* u;
  float* y;
  float* s_out;
  int H, T;
  Strides3 sr, sk, sv, sw, sy;
  long long su;   // u's row stride
};

template <typename In, int K>
__global__ void __launch_bounds__(K) rwkv6_scan_kernel(ScanArgs a) {
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int i = threadIdx.x;   // column v of S, and the element staged

  __shared__ __align__(16) float s_r[kTile][K];
  __shared__ __align__(16) float s_k[kTile][K];
  __shared__ __align__(16) float s_w[kTile][K];
  __shared__ __align__(16) float s_ru[kTile][K];
  __shared__ float s_v[kTile][K];

  const In* r = static_cast<const In*>(a.r) + b * a.sr.b + h * a.sr.h + i;
  const In* kk = static_cast<const In*>(a.k) + b * a.sk.b + h * a.sk.h + i;
  const In* v = static_cast<const In*>(a.v) + b * a.sv.b + h * a.sv.h + i;
  const In* lw = static_cast<const In*>(a.logw) + b * a.sw.b + h * a.sw.h + i;
  float* y = a.y + b * a.sy.b + h * a.sy.h + i;
  const float u_i = to_f32(static_cast<const In*>(a.u)[h * a.su + i]);

  float S[K];
#pragma unroll
  for (int j = 0; j < K; ++j) S[j] = 0.f;

  for (int t0 = 0; t0 < a.T; t0 += kTile) {
    const int n = min(kTile, a.T - t0);
    __syncthreads();   // every thread has walked the previous tile
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const long long t = t0 + j;
      const float rv = to_f32(r[t * a.sr.t]);
      s_r[j][i] = rv;
      s_ru[j][i] = rv * u_i;
      s_k[j][i] = to_f32(kk[t * a.sk.t]);
      s_w[j][i] = expf(to_f32(lw[t * a.sw.t]));
      s_v[j][i] = to_f32(v[t * a.sv.t]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float vj = s_v[j][i];
      const float4* r4 = reinterpret_cast<const float4*>(s_r[j]);
      const float4* k4 = reinterpret_cast<const float4*>(s_k[j]);
      const float4* w4 = reinterpret_cast<const float4*>(s_w[j]);
      const float4* ru4 = reinterpret_cast<const float4*>(s_ru[j]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};   // sum_k r[k] S[k, v]
      float bonus = 0.f;                     // sum_k r[k] u[k] k[k]
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = ru4[q];
        const float rs[4] = {rq.x, rq.y, rq.z, rq.w};
        const float ks[4] = {kq.x, kq.y, kq.z, kq.w};
        const float ws[4] = {wq.x, wq.y, wq.z, wq.w};
        const float us[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 4 * q + e;
          acc[e] = fmaf(rs[e], S[row], acc[e]);
          bonus = fmaf(us[e], ks[e], bonus);
          S[row] = fmaf(ws[e], S[row], ks[e] * vj);
        }
      }
      y[(t0 + j) * a.sy.t] =
          fmaf(bonus, vj, (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }

  float* s_out = a.s_out + (long long)bh * K * K + i;
#pragma unroll
  for (int j = 0; j < K; ++j) s_out[j * K] = S[j];
}

template <typename In, int K>
int launch_k(const ScanArgs& a, int B, cudaStream_t stream) {
  rwkv6_scan_kernel<In, K><<<B * a.H, K, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_t(const ScanArgs& a, int B, int K, cudaStream_t stream) {
  switch (K) {
    case 16: return launch_k<In, 16>(a, B, stream);
    case 32: return launch_k<In, 32>(a, B, stream);
    case 64: return launch_k<In, 64>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, logw and u alike).
// strides (elements, last dim 1): r, k, v, logw and y as (b, h, t) each,
// then u's row stride: 16 values.  s_out is a contiguous [B,H,K,K].
extern "C" int rwkv6_scan_launch(int dtype, const void* r, const void* k,
                                 const void* v, const void* logw,
                                 const void* u, float* y, float* s_out,
                                 int B, int H, int T, int K,
                                 const long long* strides, void* stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  ScanArgs a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.logw = logw;
  a.u = u;
  a.y = y;
  a.s_out = s_out;
  a.H = H;
  a.T = T;
  Strides3* dims[5] = {&a.sr, &a.sk, &a.sv, &a.sw, &a.sy};
  for (int d = 0; d < 5; ++d) {
    dims[d]->b = strides[3 * d];
    dims[d]->h = strides[3 * d + 1];
    dims[d]->t = strides[3 * d + 2];
  }
  a.su = strides[15];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_t<float>(a, B, K, s);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a, B, K, s);
  return (int)cudaErrorInvalidValue;
}
