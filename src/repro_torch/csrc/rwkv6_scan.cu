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
// decode cache.
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s f32 on the CUDA
// cores).  At the serving prefill (B 1, H 32, K 64, T 16, f32) it moves
// 1.19 MB: 0.355 us.  At T 2048 it moves 84.4 MB: 25.2 us of bytes,
// against 20.3 us for its 5 K^2 + 4 K flops a token and head (1.36
// GFLOP).  Bytes bound it, and the CUDA cores come close behind.
//
// On the TPU the grid (B, H, chunks) walks the chunk axis in order with
// the [K,K] state in VMEM, and each chunk is two MXU products over exact
// pair decays.  That chunked form does not pay here: it adds L*L*K exact
// pair-decay exps a chunk, it cannot be factorized into two products
// (after the model's clamp log w reaches -e^4 = -54.6 a token, and exp of
// a two-token sum overflows f32 once inverted), and its products would
// need 3xTF32 to hold the 1e-4 gate.  The sequential form's work already
// fits under the byte bound, so this kernel keeps it and spreads it over
// the card (the design it replaces: 32 blocks of 64 threads at B 1, each
// thread walking a whole column, 0.73 ms at T 2048):
//  * Columns of S are independent: S[:, v] and y[v] read only column v
//    and the token's r, k, w and u rows.  A block owns kCols = 16
//    columns of one (b, h), so a head is K / 16 blocks and B 1, H 32,
//    K 64 is 128 blocks on 132 SMs.
//  * The K rows of a column are split over kRowLanes = 8 row lanes: a
//    walker thread holds K / 8 rows of one column in registers (rows
//    4g..4g+3 and 32+4g..32+4g+3 of row lane g at K 64); a half-warp
//    holds the 16 columns of one row lane, so its r, k and w rows are
//    16-byte shared loads of two addresses a warp.  The walk keeps one
//    token's operands loaded ahead of the state chain.
//  * The sum over k is off the chain: per token a walker writes its
//    partial r . S[:, v] to shared memory, and the 8 partials of a
//    (token, column) are summed once a tile, with the bonus term.
//  * Warp specialization: 4 walker warps only walk; 4 helper warps keep
//    the cp.async ring kAhead = 2 tiles ahead of the tile they prepare
//    (4 and 6 measured the same), compute
//    w = exp(log w) and the bonus (sum_k r u k) once per token and
//    block, and sum the partials into y.  One barrier a tile.
//  * The wrapper picks the copy width (16, 8 or 4 bytes) from the
//    alignment of the pointers and strides; bf16 rows that are only
//    2-byte aligned are copied with plain loads.
// What holds it back now: one walker warp a scheduler, whose chain of
// shared loads and fmas a token the helpers' work cannot fill, and the
// shared-memory pipe (a 16-byte load a warp costs two cycles of the SM).
// Every decay factor is exp(logw) <= 1 for logw <= 0: nothing is clipped
// and nothing overflows, however strong the decay.  Inputs are f32 or
// bf16 and are read through their strides (the last dim contiguous), so
// the model's [B,T,H,K] -> [B,H,T,K] transpose is a view.  Every product
// and sum is f32; no fast math (expf is the accurate one).  T may be any
// length: the last tile is short, nothing is padded.
//
// Plain C interface, loaded with ctypes.  The launcher checks the plan
// it is given and returns cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;          // tokens a tile of the cp.async ring
constexpr int kAhead = 2;          // tiles in flight ahead of the walk
constexpr int kStages = kAhead + 2;   // ring stages: + the walk's, + the sum's
constexpr int kCols = 16;          // columns of S a block
constexpr int kRowLanes = 8;       // lanes over the K rows of a column
constexpr int kWalkers = kCols * kRowLanes;   // 128: warps 0-3 walk
constexpr int kHelpers = 128;                 // warps 4-7 load and sum
constexpr int kThreads = kWalkers + kHelpers;
// A half-warp of walkers holds the 16 columns of one row lane, so a
// warp's row loads read two addresses.  Partials [token][row lane]
// [column]: a warp's stores and the sums' loads (16 columns of two
// tokens) fall in distinct banks.
constexpr int kPartRow = kCols;
constexpr int kPartTok = kRowLanes * kCols + 16;
static_assert(kHelpers / kRowLanes == kTile, "a bonus sum a thread group");

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

// Q consecutive values of a shared row as f32, Q = 2 or 4; p is aligned
// to Q elements.
template <int Q>
__device__ __forceinline__ void load_q(const float* p, float* out) {
  if constexpr (Q == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
}
template <int Q>
__device__ __forceinline__ void load_q(const __nv_bfloat16* p, float* out) {
  if constexpr (Q == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(x.x); out[1] = bf16_hi(x.x);
    out[2] = bf16_lo(x.y); out[3] = bf16_hi(x.y);
  } else {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    out[0] = bf16_lo(x); out[1] = bf16_hi(x);
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(s), "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                   :: "r"(s), "l"(src));
      break;
    default:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(s), "l"(src));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// n rows: row j from src + j * stride into dst + (j << rshift), by the
// kHelpers threads (t is this thread's index among them).
template <typename In>
__device__ __forceinline__ void copy_rows(In* dst, const In* src,
                                          long long stride, int n,
                                          int rshift, CopyPlan cp, int t) {
  const int mask = (1 << cp.cshift) - 1;
  for (int e = t; e < (n << cp.cshift); e += kHelpers) {
    const int j = e >> cp.cshift;
    const int c = (e & mask) << cp.pshift;
    if (cp.bytes >= 4)
      cp_async(dst + (j << rshift) + c, src + j * stride + c, cp.bytes);
    else
      dst[(j << rshift) + c] = src[j * stride + c];
  }
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
  int H, T, col_groups, copy_bytes;
  Strides3 sr, sk, sv, sw, sy;
  long long su;   // u's row stride
};

template <typename In, int K>
constexpr int smem_bytes() {
  return kStages * kTile * (3 * K + kCols) * static_cast<int>(sizeof(In)) +
         (2 * kTile * K + 2 * kTile * kPartTok + 3 * kTile) * 4;
}

// The block: 4 walker warps and 4 helper warps, one barrier a tile.  In
// the round of tile t:
//   walkers: walk tile t (its r, k, v from the ring, w from s_w[t & 1]),
//            writing each row lane's partials to s_part[t & 1];
//   helpers: wait for tile t+1 and issue tile t+kAhead into the stage
//            tile t-2 used; compute tile t+1's w = exp(log w) and bonus;
//            sum the row lanes' partials of tile t-1 into y, with the
//            bonus.
// Shared: the cp.async ring (kStages stages of r, k, log w rows and the
// block's 16 columns of v), w and the partials (two tiles each), and the
// bonus (three tiles).
template <typename In, int K>
__global__ void __launch_bounds__(kThreads, 2) rwkv6_scan_kernel(ScanArgs a) {
  constexpr int RK = K / kRowLanes;        // rows a walker: 2, 4 or 8
  constexpr int Q = RK < 4 ? RK : 4;       // rows a shared load: 2 or 4
  constexpr int kStage = kTile * (3 * K + kCols);   // elements a stage
  constexpr int kShift = K == 16 ? 4 : K == 32 ? 5 : 6;

  extern __shared__ __align__(16) unsigned char smem[];
  In* raw = reinterpret_cast<In*>(smem);
  float* s_w =
      reinterpret_cast<float*>(smem + kStages * kStage * sizeof(In));
  float* s_part = s_w + 2 * kTile * K;
  float* s_bonus = s_part + 2 * kTile * kPartTok;   // [3][kTile]

  const int cg = blockIdx.x % a.col_groups;
  const int bh = blockIdx.x / a.col_groups;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int c0 = cg * kCols;
  const int tid = threadIdx.x;
  const bool walker = tid < kWalkers;
  const int ht = tid - kWalkers;                 // index among the helpers
  const int g = (tid >> 4) & (kRowLanes - 1);    // a walker's row lane
  const int col = tid & (kCols - 1);             // ... and column
  const int pj = (ht >> 3) & (kTile - 1);        // a helper's bonus token
  const int pg = ht & (kRowLanes - 1);           // ... and row lane

  const In* r = static_cast<const In*>(a.r) + b * a.sr.b + h * a.sr.h;
  const In* kk = static_cast<const In*>(a.k) + b * a.sk.b + h * a.sk.h;
  const In* lw = static_cast<const In*>(a.logw) + b * a.sw.b + h * a.sw.h;
  const In* v = static_cast<const In*>(a.v) + b * a.sv.b + h * a.sv.h + c0;
  float* y = a.y + b * a.sy.b + h * a.sy.h + c0;
  const CopyPlan rows_cp = copy_plan<In>(K, a.copy_bytes);
  const CopyPlan v_cp = copy_plan<In>(kCols, a.copy_bytes);
  const int ntiles = (a.T + kTile - 1) / kTile;
  auto stage = [&](int tile) { return raw + (tile % kStages) * kStage; };
  auto tokens = [&](int tile) { return min(kTile, a.T - tile * kTile); };
  if (!walker) {
    // Helpers: u at the rows of row lane pg, for the bonus sum.
    float u_g[RK];
#pragma unroll
    for (int e = 0; e < RK; ++e) {
      const int row = e / Q * (kRowLanes * Q) + pg * Q + e % Q;
      u_g[e] = to_f32(static_cast<const In*>(a.u)[h * a.su + row]);
    }
    // One copy group a tile; past the last tile the group is empty, so
    // that the groups pending always count the same.
    auto issue = [&](int tile) {
      if (tile < ntiles) {
        const int t0 = tile * kTile;
        const int n = tokens(tile);
        In* st = stage(tile);
        copy_rows(st, r + t0 * a.sr.t, a.sr.t, n, kShift, rows_cp, ht);
        copy_rows(st + kTile * K, kk + t0 * a.sk.t, a.sk.t, n, kShift,
                  rows_cp, ht);
        copy_rows(st + 2 * kTile * K, lw + t0 * a.sw.t, a.sw.t, n, kShift,
                  rows_cp, ht);
        copy_rows(st + 3 * kTile * K, v + t0 * a.sv.t, a.sv.t, n, 4, v_cp,
                  ht);
      }
      cp_async_commit();
    };
    // w = exp(log w) and the bonus of a landed tile, once a token.
    auto prep = [&](int tile) {
      const int n = tokens(tile);
      const In* st = stage(tile);
      const In* t_lw = st + 2 * kTile * K;
      float* w = s_w + (tile & 1) * kTile * K;
      for (int e = 4 * ht; e < (n << kShift); e += 4 * kHelpers) {
        float x[4];
        load_q<4>(t_lw + e, x);
        *reinterpret_cast<float4*>(w + e) =
            make_float4(expf(x[0]), expf(x[1]), expf(x[2]), expf(x[3]));
      }
      // thread (pj, pg): sum_k r u k over row lane pg's rows of token pj,
      // then over the row lanes.
      float rv[RK], kv[RK];
      float bonus = 0.f;
#pragma unroll
      for (int e = 0; e < RK; e += Q) {
        const int row = e / Q * (kRowLanes * Q) + pg * Q;
        load_q<Q>(st + pj * K + row, rv + e);
        load_q<Q>(st + kTile * K + pj * K + row, kv + e);
      }
#pragma unroll
      for (int e = 0; e < RK; ++e) bonus = fmaf(rv[e] * u_g[e], kv[e], bonus);
#pragma unroll
      for (int off = 1; off < kRowLanes; off <<= 1)
        bonus += __shfl_xor_sync(0xffffffffu, bonus, off);
      if (pg == 0 && pj < n) s_bonus[(tile % 3) * kTile + pj] = bonus;
    };
#pragma unroll
    for (int t = 0; t < kAhead; ++t) issue(t);
    cp_async_wait<kAhead - 1>();                        // tile 0 landed
    asm volatile("bar.sync 1, %0;" :: "n"(kHelpers));
    prep(0);
    __syncthreads();
    for (int tile = 0; tile <= ntiles; ++tile) {
      cp_async_wait<kAhead - 2>();   // tile+1 landed (this thread's copies)
      issue(tile + kAhead);          // into the stage tile-2 used
      // The other helpers' copies of tile+1 are visible after a barrier
      // among the helpers alone (named barrier 1).
      asm volatile("bar.sync 1, %0;" :: "n"(kHelpers));
      if (tile + 1 < ntiles) prep(tile + 1);
      if (tile > 0) {      // the deferred sum over the row lanes into y
        const int t0 = (tile - 1) * kTile;
        const int n = tokens(tile - 1);
        const In* t_v = stage(tile - 1) + 3 * kTile * K;
        const float* part = s_part + ((tile - 1) & 1) * kTile * kPartTok;
        const float* bonus = s_bonus + ((tile - 1) % 3) * kTile;
        for (int e = ht; e < n * kCols; e += kHelpers) {
          const int j = e >> 4;
          const int c = e & (kCols - 1);
          const float* p = part + j * kPartTok + c;
          float q[kRowLanes];
#pragma unroll
          for (int i = 0; i < kRowLanes; ++i) q[i] = p[i * kPartRow];
          const float s = ((q[0] + q[1]) + (q[2] + q[3])) +
                          ((q[4] + q[5]) + (q[6] + q[7]));
          y[(t0 + j) * a.sy.t + c] =
              fmaf(bonus[j], to_f32(t_v[j * kCols + c]), s);
        }
      }
      __syncthreads();   // the round's work is done
    }
    return;
  }

  // Walkers: RK rows of column `col` of S, token by token.
  float S[RK];
#pragma unroll
  for (int e = 0; e < RK; ++e) S[e] = 0.f;

  // This walker's operands of one token: its RK rows of r, k and w, and
  // v at its column.
  struct Tok {
    float r[RK], k[RK], w[RK], v;
  };
  auto load_tok = [&](const In* st, const float* w, int j, Tok& o) {
#pragma unroll
    for (int e = 0; e < RK; e += Q) {
      const int row = e / Q * (kRowLanes * Q) + g * Q;
      load_q<Q>(st + j * K + row, o.r + e);
      load_q<Q>(st + kTile * K + j * K + row, o.k + e);
      load_q<Q>(w + j * K + row, o.w + e);
    }
    o.v = to_f32(st[3 * kTile * K + j * kCols + col]);
  };
  auto step = [&](float* part, int j, const Tok& o) {
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int e = 0; e < RK; ++e) {
      if (e & 1)
        acc1 = fmaf(o.r[e], S[e], acc1);
      else
        acc0 = fmaf(o.r[e], S[e], acc0);
      S[e] = fmaf(o.w[e], S[e], o.k[e] * o.v);
    }
    part[j * kPartTok + g * kPartRow + col] = acc0 + acc1;
  };

  __syncthreads();   // tile 0 landed, its w ready
  for (int tile = 0; tile <= ntiles; ++tile) {
    if (tile < ntiles) {   // one token's operands ahead of the chain
      const int n = tokens(tile);
      const In* st = stage(tile);
      const float* w = s_w + (tile & 1) * kTile * K;
      float* part = s_part + (tile & 1) * kTile * kPartTok;
      Tok x0, x1;
      load_tok(st, w, 0, x0);
      if (n == kTile) {
#pragma unroll
        for (int j = 0; j < kTile; j += 2) {
          load_tok(st, w, j + 1, x1);
          step(part, j, x0);
          if (j + 2 < kTile) load_tok(st, w, j + 2, x0);
          step(part, j + 1, x1);
        }
      } else {
#pragma unroll 1
        for (int j = 0; j < n; j += 2) {
          if (j + 1 < n) load_tok(st, w, j + 1, x1);
          step(part, j, x0);
          if (j + 2 < n) load_tok(st, w, j + 2, x0);
          if (j + 1 < n) step(part, j + 1, x1);
        }
      }
    }
    __syncthreads();   // the round's work is done
  }

  float* s_out = a.s_out + (static_cast<long long>(bh) * K) * K + c0 + col;
#pragma unroll
  for (int e = 0; e < RK; ++e) {
    const int row = e / Q * (kRowLanes * Q) + g * Q + e % Q;
    s_out[row * K] = S[e];
  }
}

template <typename In, int K>
int launch_k(const ScanArgs& a, int B, cudaStream_t stream) {
  if (a.col_groups * kCols != K) return (int)cudaErrorInvalidValue;
  const long long grid = static_cast<long long>(B) * a.H * a.col_groups;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<In, K>();
  static bool opted_in = false;   // once per instantiation
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<In, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  rwkv6_scan_kernel<In, K><<<(unsigned)grid, kThreads, smem, stream>>>(a);
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

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, logw and u alike).
// col_groups: blocks a head (K / 16); copy_bytes: the cp.async width
// (16, 8 or 4; 2 for bf16 rows copied with plain loads): every pointer
// and stride of r, k, v and logw must be a multiple of it.
// strides (elements, last dim 1): r, k, v, logw and y as (b, h, t) each,
// then u's row stride: 16 values.  s_out is a contiguous [B,H,K,K].
extern "C" int rwkv6_scan_launch(int dtype, const void* r, const void* k,
                                 const void* v, const void* logw,
                                 const void* u, float* y, float* s_out,
                                 int B, int H, int T, int K, int col_groups,
                                 int copy_bytes, const long long* strides,
                                 void* stream) {
  if (B < 1 || H < 1 || T < 1 || col_groups < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int size = dtype == 0 ? 4 : 2;
  if (copy_bytes != 16 && copy_bytes != 8 && copy_bytes != 4 &&
      copy_bytes != size)
    return (int)cudaErrorInvalidValue;
  const void* streams[4] = {r, k, v, logw};
  for (int d = 0; d < 4; ++d) {
    if (!aligned(streams[d], copy_bytes)) return (int)cudaErrorInvalidValue;
    for (int s = 0; s < 3; ++s)
      if (strides[3 * d + s] * size % copy_bytes != 0)
        return (int)cudaErrorInvalidValue;
  }
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
  a.col_groups = col_groups;
  a.copy_bytes = copy_bytes;
  Strides3* dims[5] = {&a.sr, &a.sk, &a.sv, &a.sw, &a.sy};
  for (int d = 0; d < 5; ++d) {
    dims[d]->b = strides[3 * d];
    dims[d]->h = strides[3 * d + 1];
    dims[d]->t = strides[3 * d + 2];
  }
  a.su = strides[15];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_t<float>(a, B, K, s);
  return launch_t<__nv_bfloat16>(a, B, K, s);
}
