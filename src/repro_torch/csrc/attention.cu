// Attention kernels of the LM serving path, for Hopper.
//
// flash_attention replaces the Pallas kernel
//   src/repro/kernels/flash_attention.py::flash_attention_pallas
//   (pl.pallas_call at :108)
// decode_attention replaces the Pallas kernel
//   src/repro/kernels/decode_attention.py::decode_attention_pallas
//   (pl.pallas_call at :112)
//
// Both follow the Pallas kernels' arithmetic: scores are dot(q, k) * scale
// in f32, masked keys get -1e30 (not -inf), and the running (m, l, acc)
// online softmax is kept in f32 with acc / max(l, 1e-30) at the end.
// Inputs are f32 or bf16; every product and sum is f32, and the output
// is rounded once to the input type.  No fast math: expf is the IEEE
// one.  The plain versions they are held to are
// src/repro_torch/kernels/ref.py (full score matrices in f32).
//
// Layout: the kernels read the model's layout through strides (the last
// dim must be contiguous), so the [B,T,H,D] <-> [B,H,T,D] transposes of
// the JAX wrappers (kernels/ops.py) copy nothing here.
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s dense bf16) at the
// serving path's shapes (stablelm-12b: H = 32, KV = 8, D = 160, bf16):
//  * flash_attention at a prefill of T = S = 32 (the prompt bucket) moves
//    0.82 MB (q, k, v read once, o written once): 0.24 us of HBM time;
//    its 11 MFLOP (causal half) take 0.01 us.  Bound by bytes, and in
//    practice by the launch.  At T = S = 2048 it needs 43 GFLOP against
//    52 MB: 44 us of tensor-core time, so operations bound it there.
//  * decode_attention at B = 4, S = 256 reads at most 2.6 MB of cache
//    (less: keys past lengths[b] are never read): 0.8 us.  Bound by
//    bytes; the whole decode step is bound by the 24.3 GB weight read.
// What the design does about it: this is the simple, correct tiling.
// Each block stages K/V tiles once in shared memory (f32, rows padded
// by one float so column walks hit distinct banks) and reuses them for
// every query row of the block -- for decode, for all G = H / KV query
// heads of a KV group, so each cache row is read from HBM once per
// group.  Causal key tiles wholly in the future, and decode keys at or
// past lengths[b], are never loaded.  The products run on the CUDA cores
// in f32, not on the tensor cores; wgmma/TMA tiles and split-K
// flash-decoding (decode runs only B * KV = 32 blocks on 132 SMs) are
// later work.
//
// Plain C interface, loaded with ctypes.  Each launcher returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHeadDim = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// --------------------------------------------------------------------
// flash_attention: one block per (q tile, head, batch).  128 threads;
// query row `row` of the tile is served by the 4 threads of one lane
// quad (`sub` = 0..3): each holds 8 of the tile's 32 key columns of the
// score tile and every 4th head-dim column of the row's accumulator.
// --------------------------------------------------------------------
constexpr int kFlashThreads = 128;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 32;  // keys per tile
constexpr int kColsPerThread = kBK / 4;

size_t flash_smem_bytes(int D) {
  const int DP = D + 1;
  return sizeof(float) * (size_t)(kBQ * DP + 2 * kBK * DP + kBQ * (kBK + 1));
}

template <typename T, int PT>  // PT >= ceil(D / 4): accumulator columns
__global__ void __launch_bounds__(kFlashThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int KV, int Tq,
    int S, int D, long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh,
    long long ost, int causal, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* sQ = smem;            // [kBQ][DP]
  float* sK = sQ + kBQ * DP;   // [kBK][DP]
  float* sV = sK + kBK * DP;   // [kBK][DP]
  float* sP = sV + kBK * DP;   // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qpos = q0 + row;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  for (int i = tid; i < kBQ * D; i += kFlashThreads) {
    const int r = i / D, d = i - r * D;
    sQ[r * DP + d] = q0 + r < Tq ? to_f32(qb[(q0 + r) * qst + d]) : 0.0f;
  }

  float m = kNegInf, l = 0.0f;
  float acc[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) acc[j] = 0.0f;

  // Causal: key tiles wholly in the future of the whole query tile are
  // skipped (the Pallas kernel's `needed` rule at this tiling).
  const int s_end = causal ? min(S, q0 + kBQ) : S;
  const int nk = (s_end + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and sQ is loaded)
    for (int i = tid; i < kBK * D; i += kFlashThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = k0 + r < S;
      sK[r * DP + d] = in ? to_f32(kb[(k0 + r) * kss + d]) : 0.0f;
      sV[r * DP + d] = in ? to_f32(vb[(k0 + r) * vss + d]) : 0.0f;
    }
    __syncthreads();

    float sc[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) sc[j] = 0.0f;
    const float* qrow = sQ + row * DP;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        sc[j] += qd * sK[(sub + 4 * j) * DP + d];
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int kpos = k0 + sub + 4 * j;
      const bool valid = kpos < S && (!causal || qpos >= kpos);
      sc[j] = valid ? sc[j] * scale : kNegInf;
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const float p = expf(sc[j] - m_new);
      sP[row * (kBK + 1) + sub + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's p values come from its own lane quad

    const float* prow = sP + row * (kBK + 1);
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int d = sub + 4 * j;
      if (d < D) {
        float pv = 0.0f;
        for (int c = 0; c < kBK; ++c) pv += prow[c] * sV[c * DP + d];
        acc[j] = acc[j] * corr + pv;
      }
    }
  }

  if (qpos < Tq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + b * osb + h * osh + qpos * ost;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int d = sub + 4 * j;
      if (d < D) orow[d] = from_f32<T>(acc[j] / denom);
    }
  }
}

// --------------------------------------------------------------------
// decode_attention: one block per (KV head, batch row) serves the G
// query heads of that group.  Key tiles of 32 rows; warp w runs the
// online-softmax update of heads w, w + 4, ...; the [G, D] accumulator
// lives in shared memory.
// --------------------------------------------------------------------
constexpr int kDecodeThreads = 128;
constexpr int kDecodeBK = 32;  // one key per lane in the softmax update

size_t decode_smem_bytes(int G, int D) {
  const int DP = D + 1;
  return sizeof(float) * (size_t)(G * DP + 2 * kDecodeBK * DP +
                                  G * (kDecodeBK + 1) + G * D + 3 * G);
}

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ lengths,
    T* __restrict__ o, int H, int KV, int S, int D, long long qsb,
    long long qsh, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int DP = D + 1;
  float* sQ = smem;                        // [G][DP]
  float* sK = sQ + G * DP;                 // [BK][DP]
  float* sV = sK + kDecodeBK * DP;         // [BK][DP]
  float* sP = sV + kDecodeBK * DP;         // [G][BK + 1]
  float* sAcc = sP + G * (kDecodeBK + 1);  // [G][D]
  float* sM = sAcc + G * D;                // [G]
  float* sL = sM + G;                      // [G]
  float* sCorr = sL + G;                   // [G]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  // Keys at or past lengths[b] are never read: a length of 0 leaves the
  // output 0, as the Pallas kernel (every block skipped) gives it.
  const int len = min(max(lengths[b], 0), S);

  const T* qb = q + b * qsb + (long long)(kvh * G) * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  for (int i = tid; i < G * D; i += kDecodeThreads) {
    const int g = i / D, d = i - g * D;
    sQ[g * DP + d] = to_f32(qb[g * qsh + d]);
    sAcc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kDecodeThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.0f;
  }

  const int nk = (len + kDecodeBK - 1) / kDecodeBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kDecodeBK;
    __syncthreads();
    for (int i = tid; i < kDecodeBK * D; i += kDecodeThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = k0 + r < len;
      sK[r * DP + d] = in ? to_f32(kb[(k0 + r) * kss + d]) : 0.0f;
      sV[r * DP + d] = in ? to_f32(vb[(k0 + r) * vss + d]) : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < G * kDecodeBK; i += kDecodeThreads) {
      const int g = i / kDecodeBK, c = i - g * kDecodeBK;
      const float* qrow = sQ + g * DP;
      const float* krow = sK + c * DP;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s += qrow[d] * krow[d];
      sP[g * (kDecodeBK + 1) + c] = k0 + c < len ? s * scale : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kDecodeThreads / 32) {
      float* prow = sP + g * (kDecodeBK + 1);
      const float s = prow[lane];
      float mx = s;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      prow[lane] = p;
      float psum = p;
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sCorr[g] = corr;
        sL[g] = sL[g] * corr + psum;
        sM[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kDecodeThreads) {
      const int g = i / D, d = i - g * D;
      const float* prow = sP + g * (kDecodeBK + 1);
      float pv = 0.0f;
      for (int c = 0; c < kDecodeBK; ++c) pv += prow[c] * sV[c * DP + d];
      sAcc[i] = sAcc[i] * sCorr[g] + pv;
    }
  }
  __syncthreads();
  T* ob = o + b * osb + (long long)(kvh * G) * osh;
  for (int i = tid; i < G * D; i += kDecodeThreads) {
    const int g = i / D, d = i - g * D;
    ob[g * osh + d] = from_f32<T>(sAcc[i] / fmaxf(sL[g], 1e-30f));
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int PT>
int flash_launch_t(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Tq, int S, int D,
                   const long long* st, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = flash_smem_bytes(D);
  cudaError_t err = allow_smem(flash_attention_kernel<T, PT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, PT><<<grid, kFlashThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, Tq, S, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int flash_launch_d(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Tq, int S, int D,
                   const long long* st, int causal, float scale,
                   cudaStream_t stream) {
  if (D <= 64)
    return flash_launch_t<T, 16>(q, k, v, o, B, H, KV, Tq, S, D, st, causal,
                                 scale, stream);
  if (D <= 128)
    return flash_launch_t<T, 32>(q, k, v, o, B, H, KV, Tq, S, D, st, causal,
                                 scale, stream);
  if (D <= 160)
    return flash_launch_t<T, 40>(q, k, v, o, B, H, KV, Tq, S, D, st, causal,
                                 scale, stream);
  return flash_launch_t<T, 64>(q, k, v, o, B, H, KV, Tq, S, D, st, causal,
                               scale, stream);
}

template <typename T>
int decode_launch_t(const void* q, const void* k, const void* v,
                    const int32_t* lengths, void* o, int B, int H, int KV,
                    int S, int D, const long long* st, float scale,
                    cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(H / KV, D);
  cudaError_t err = allow_smem(decode_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KV, B);
  decode_attention_kernel<T><<<grid, kDecodeThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, H, KV, S, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int H, int KV, int D) {
  return KV >= 1 && H >= KV && H % KV == 0 && D >= 16 && D % 16 == 0 &&
         D <= kMaxHeadDim;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides (elements, last dim 1):
// q (b, h, t), k (b, kv, s), v (b, kv, s), o (b, h, t).
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int H, int KV, int Tq, int S,
                                      int D, const long long* strides,
                                      int causal, float scale,
                                      void* stream) {
  if (!shape_ok(H, KV, D) || B < 1 || Tq < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return flash_launch_d<float>(q, k, v, o, B, H, KV, Tq, S, D, strides,
                                 causal, scale, s);
  if (dtype == 1)
    return flash_launch_d<__nv_bfloat16>(q, k, v, o, B, H, KV, Tq, S, D,
                                         strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// strides (elements, last dim 1): q (b, h), k (b, kv, s), v (b, kv, s),
// o (b, h).
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const int32_t* lengths, void* o,
                                       int B, int H, int KV, int S, int D,
                                       const long long* strides,
                                       float scale, void* stream) {
  if (!shape_ok(H, KV, D) || B < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return decode_launch_t<float>(q, k, v, lengths, o, B, H, KV, S, D,
                                  strides, scale, s);
  if (dtype == 1)
    return decode_launch_t<__nv_bfloat16>(q, k, v, lengths, o, B, H, KV, S,
                                          D, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a launch needs, so the wrapper can refuse a shape
// the card cannot hold before launching.
extern "C" long long flash_attention_smem_bytes(int D) {
  return (long long)flash_smem_bytes(D);
}

extern "C" long long decode_attention_smem_bytes(int G, int D) {
  return (long long)decode_smem_bytes(G, D);
}
