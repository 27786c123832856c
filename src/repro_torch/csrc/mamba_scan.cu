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
// for the decode cache.
//
// What bounds it on an H100.  At T 2048 (B 1, I 16384, N 16, f32) it
// moves 405 MB: 120.9 us at 3.35 TB/s; its B*T*I*N = 5.37e8 exps take
// 128.4 us on the special-function units (16 an SM a clock): the exps
// bound it, the bytes close behind.  At the serving prefill (T 16) the
// bytes are 5.24 MB, 1.57 us.  Each state element also costs five issue
// slots a token (dt * A, the exp, xdt * B, the state fma, the C fma), and
// every shared-memory access costs the SM about two cycles a warp.
//
// On the TPU the grid (B, I/block_i, chunks) walks the chunk axis in
// order with h [block_i, N] in VMEM scratch.  Hopper's blocks run in
// parallel with nothing carried between them, so each channel walks T
// itself (no split over T: B*I*N = 262,144 independent chains at B 1
// fill the card).  The design it replaces (one thread a channel, 64
// threads a block: 4 warps an SM, nothing to hide an expf's latency;
// 0.87 ms at T 2048) is redesigned so:
//  * N is split over kLanes = 4 lanes, N / 4 states each: B 1, I 16384
//    is 2,048 warps, about 16 an SM, each lane with N / 4 independent
//    chains.  A token's B and C are one 16-byte shared load each, the
//    same for the warp's 8 channels.
//  * y's sum over the lanes is deferred: per token a lane writes its
//    partial to shared memory, and the block sums them once a tile and
//    writes y 128 bytes a token (two shuffle levels a token cost 18%
//    more at T 2048; two channels a lane, 13% more).
//  * A is scaled by log2(e) once, when it is loaded, so each decay is one
//    exp2 of one product, on the special-function unit (MUFU.EX2, the
//    instruction exp2f uses, with its error); results below 2^-126 are
//    flushed to 0 rather than rescaled, which changes h by under
//    1.2e-38 |h|.
//  * A block owns kChannels = 32 channels of one b (128 threads).  A
//    2-stage cp.async ring brings tile n+1 (the block's xdt and dt rows,
//    the B and C rows) while tile n is walked.  The wrapper picks the
//    copy widths (16, 8 or 4 bytes; a plain copy for 2-byte aligned
//    bf16) from the pointers and strides, one for the [B,T,I] streams
//    and one for the B/C rows, which are column slices of the model's
//    x_proj output.  The last block's channels past I are zero-filled
//    and never written.
// Every decay factor is exp(dt * A) <= 1 for dt >= 0 and A < 0: nothing
// is clipped and nothing overflows, however large dt is.  Inputs are f32
// or bf16 (a: f32 or the inputs' type) and are read through their strides
// (the last dim contiguous).  Every product and sum is f32; no fast-math
// flag.  T may be any length: the last tile is short, nothing is padded.
//
// Plain C interface, loaded with ctypes.  The launcher checks the plan
// it is given and returns cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;      // channels a block
constexpr int kLanes = 4;          // lanes a channel: N split over them
constexpr int kThreads = kChannels * kLanes;   // 128: 8 channels a warp
constexpr int kTile = 32;          // tokens a tile of the cp.async ring
static_assert(kChannels == 32, "a row of xdt/dt is 1 << 5 elements");
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// NS consecutive values of a shared row as f32 (NS = 1, 2 or 4; p is
// aligned to NS elements).
template <int NS>
__device__ __forceinline__ void load_ns(const float* p, float* out) {
  if constexpr (NS == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (NS == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = *p;
  }
}
template <int NS>
__device__ __forceinline__ void load_ns(const __nv_bfloat16* p, float* out) {
  if constexpr (NS == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(x.x); out[1] = bf16_hi(x.x);
    out[2] = bf16_lo(x.y); out[3] = bf16_hi(x.y);
  } else if constexpr (NS == 2) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    out[0] = bf16_lo(x); out[1] = bf16_hi(x);
  } else {
    out[0] = __bfloat162float(*p);
  }
}

// cp.async of `bytes` (16, 8 or 4) of which the first `valid` are read
// from src and the rest zero-filled.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, int valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(s), "l"(src), "r"(valid));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(s), "l"(src), "r"(valid));
      break;
    default:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(s), "l"(src), "r"(valid));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A copy plan: rows of `elems` elements in chunks of `bytes` (16, 8 or 4
// by cp.async; the element size: a plain copy, for 2-byte aligned bf16).
// Chunks a row and elements a chunk are powers of two, so a chunk's
// place is two shifts and a mask, with no division.
struct CopyPlan {
  int bytes, pshift, cshift;   // log2 of elements a chunk, chunks a row
};

template <typename In>
__device__ __forceinline__ CopyPlan copy_plan(int elems, int bytes) {
  const int per = bytes / static_cast<int>(sizeof(In));
  const int pshift = __ffs(per) - 1;
  return {bytes, pshift, __ffs(elems >> pshift) - 1};
}

// n rows, of which the first `live` elements exist: row j from
// src + j * stride into dst + (j << rshift).  Elements past `live` are
// zero-filled and never read.
template <typename In>
__device__ __forceinline__ void copy_rows(In* dst, const In* src,
                                          long long stride, int n,
                                          int rshift, int live, CopyPlan cp) {
  constexpr int size = static_cast<int>(sizeof(In));
  const int mask = (1 << cp.cshift) - 1;
  const int per = 1 << cp.pshift;
  for (int e = threadIdx.x; e < (n << cp.cshift); e += kThreads) {
    const int j = e >> cp.cshift;
    const int c = (e & mask) << cp.pshift;
    const int valid = min(max(live - c, 0), per) * size;
    const In* s = src + j * stride + (valid > 0 ? c : 0);
    if (cp.bytes >= 4)
      cp_async(dst + (j << rshift) + c, s, cp.bytes, valid);
    else
      dst[(j << rshift) + c] = valid > 0 ? *s : In(0.f);
  }
}

// 2^x by the special-function unit, results below 2^-126 flushed to 0:
// the same instruction (MUFU.EX2) and error as exp2f, without exp2f's
// rescaling of the subnormal range.  A decay there is under 1.2e-38 and
// changes h by less than 1.2e-38 |h|.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
  int T, I, i_blocks, copy_x, copy_bc;
  Strides2 sx, sd, sb, sc, sy;
  long long sa;   // a's row stride
};

template <typename In, typename TA, int N>
__global__ void __launch_bounds__(kThreads, 4) mamba_scan_kernel(ScanArgs p) {
  constexpr int NS = N / kLanes;       // states a lane: 1, 2 or 4
  __shared__ __align__(16) In s_x[2][kTile][kChannels];
  __shared__ __align__(16) In s_d[2][kTile][kChannels];
  __shared__ __align__(16) In s_b[2][kTile][N];
  __shared__ __align__(16) In s_c[2][kTile][N];
  // Each lane's partial sum of y, [token][channel][lane], summed once a
  // tile.
  __shared__ __align__(16) float s_y[kTile][kChannels][kLanes];

  const int ib = blockIdx.x % p.i_blocks;
  const int b = blockIdx.x / p.i_blocks;
  const int i0 = ib * kChannels;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c = (tid >> 5) * 8 + (lane & 7);   // channel in the block
  const int q = lane >> 3;                     // lane in the channel
  const int i = i0 + c;
  const bool live = i < p.I;
  const int live_ch = min(kChannels, p.I - i0);

  const In* xdt = static_cast<const In*>(p.xdt) + b * p.sx.b + i0;
  const In* dt = static_cast<const In*>(p.dt) + b * p.sd.b + i0;
  const In* bc = static_cast<const In*>(p.bc) + b * p.sb.b;
  const In* cc = static_cast<const In*>(p.cc) + b * p.sc.b;

  float a2[NS], h[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    a2[s] = live ? to_f32(static_cast<const TA*>(p.a)[i * p.sa + q * NS + s])
                       * kLog2e
                 : 0.f;
    h[s] = 0.f;
  }

  constexpr int kNShift = N == 4 ? 2 : N == 8 ? 3 : 4;
  const CopyPlan x_cp = copy_plan<In>(kChannels, p.copy_x);
  const CopyPlan bc_cp = copy_plan<In>(N, p.copy_bc);
  const int ntiles = (p.T + kTile - 1) / kTile;
  auto issue = [&](int tile) {
    const int t0 = tile * kTile;
    const int n = min(kTile, p.T - t0);
    const int st = tile & 1;
    copy_rows(&s_x[st][0][0], xdt + t0 * p.sx.t, p.sx.t, n, 5, live_ch,
              x_cp);
    copy_rows(&s_d[st][0][0], dt + t0 * p.sd.t, p.sd.t, n, 5, live_ch,
              x_cp);
    copy_rows(&s_b[st][0][0], bc + t0 * p.sb.t, p.sb.t, n, kNShift, N,
              bc_cp);
    copy_rows(&s_c[st][0][0], cc + t0 * p.sc.t, p.sc.t, n, kNShift, N,
              bc_cp);
    cp_async_commit();
  };

  issue(0);
  for (int tile = 0; tile <= ntiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();   // tile landed; every thread walked the previous one
    if (tile + 1 < ntiles) issue(tile + 1);
    if (tile > 0) {    // y of tile-1: the lanes' partials summed
      const int t0 = (tile - 1) * kTile;
      const int n = min(kTile, p.T - t0);
      float* yt = p.y + b * p.sy.b + i0 + t0 * p.sy.t;
      for (int e = tid; e < n * kChannels; e += kThreads) {
        const int j = e >> 5;
        const int ch = e & (kChannels - 1);
        const float4 v = *reinterpret_cast<const float4*>(&s_y[j][ch][0]);
        if (ch < live_ch) yt[j * p.sy.t + ch] = (v.x + v.y) + (v.z + v.w);
      }
      __syncthreads();   // the partials are free
    }
    if (tile == ntiles) break;

    const int t0 = tile * kTile;
    const int n = min(kTile, p.T - t0);
    const int st = tile & 1;
    auto step = [&](int j) {
      const float x = to_f32(s_x[st][j][c]);
      const float d = to_f32(s_d[st][j][c]);
      float bv[NS], cv[NS];
      load_ns<NS>(&s_b[st][j][q * NS], bv);
      load_ns<NS>(&s_c[st][j][q * NS], cv);
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float decay = exp2_ftz(d * a2[s]);
        h[s] = fmaf(decay, h[s], x * bv[s]);
        acc = fmaf(cv[s], h[s], acc);
      }
      s_y[j][c][q] = acc;
    };
    if (n == kTile) {
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) step(j);
    } else {
#pragma unroll 4
      for (int j = 0; j < n; ++j) step(j);
    }
  }

  if (live) {
    float* ho = p.h_out + (static_cast<long long>(b) * p.I + i) * N + q * NS;
    if constexpr (NS == 4) {
      *reinterpret_cast<float4*>(ho) = make_float4(h[0], h[1], h[2], h[3]);
    } else if constexpr (NS == 2) {
      *reinterpret_cast<float2*>(ho) = make_float2(h[0], h[1]);
    } else {
      ho[0] = h[0];
    }
  }
}

template <typename In, typename TA, int N>
int launch_n(const ScanArgs& p, int B, cudaStream_t stream) {
  if (p.i_blocks != (p.I + kChannels - 1) / kChannels)
    return (int)cudaErrorInvalidValue;
  const long long grid = static_cast<long long>(B) * p.i_blocks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mamba_scan_kernel<In, TA, N><<<(unsigned)grid, kThreads, 0, stream>>>(p);
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

bool copy_ok(const void* ptr, const long long* strides, int size,
             int bytes) {
  if (bytes != 16 && bytes != 8 && bytes != 4 && bytes != size) return false;
  if (reinterpret_cast<uintptr_t>(ptr) % bytes != 0) return false;
  return strides[0] * size % bytes == 0 && strides[1] * size % bytes == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xdt, dt, bc and cc alike); a_dtype
// the same code for a (float32, or dtype).
// i_blocks: blocks over I (ceil(I / 32)); copy_x, copy_bc: the cp.async
// widths of the xdt/dt and the bc/cc rows (16, 8 or 4; 2 for bf16 rows
// copied with plain loads): every pointer and stride of those operands
// must be a multiple of theirs, and N elements of copy_bc.
// strides (elements, last dims 1): xdt, dt, bc, cc and y as (b, t) each,
// then a's row stride: 11 values.  h_out is a contiguous [B,I,N].
extern "C" int mamba_scan_launch(int dtype, int a_dtype, const void* xdt,
                                 const void* dt, const void* bc,
                                 const void* cc, const void* a, float* y,
                                 float* h_out, int B, int T, int I, int N,
                                 int i_blocks, int copy_x, int copy_bc,
                                 const long long* strides, void* stream) {
  if (B < 1 || T < 1 || I < 1) return (int)cudaErrorInvalidValue;
  if ((dtype != 0 && dtype != 1) || (a_dtype != 0 && a_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  const int size = dtype == 0 ? 4 : 2;
  if (!copy_ok(xdt, strides, size, copy_x) ||
      !copy_ok(dt, strides + 2, size, copy_x) ||
      !copy_ok(bc, strides + 4, size, copy_bc) ||
      !copy_ok(cc, strides + 6, size, copy_bc) || N * size % copy_bc != 0)
    return (int)cudaErrorInvalidValue;
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
  p.i_blocks = i_blocks;
  p.copy_x = copy_x;
  p.copy_bc = copy_bc;
  Strides2* dims[5] = {&p.sx, &p.sd, &p.sb, &p.sc, &p.sy};
  for (int d = 0; d < 5; ++d) {
    dims[d]->b = strides[2 * d];
    dims[d]->t = strides[2 * d + 1];
  }
  p.sa = strides[10];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_t<float, float>(p, B, N, s);
  if (a_dtype == 0) return launch_t<__nv_bfloat16, float>(p, B, N, s);
  return launch_t<__nv_bfloat16, __nv_bfloat16>(p, B, N, s);
}
