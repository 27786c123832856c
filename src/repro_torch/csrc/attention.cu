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
// online softmax is kept in f32 with acc / max(l, 1e-30) at the end.  The
// output is rounded once to the input type.  The plain versions they are
// held to are src/repro_torch/kernels/ref.py (full score matrices in f32)
// and, for the split-K merge, decode_attention_split_plain.
//
// Layout: the kernels read the model's layout through strides (the last
// dim must be contiguous), so the [B,T,H,D] <-> [B,H,T,D] transposes of
// the JAX wrappers (kernels/ops.py) copy nothing here.
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s dense bf16) at the
// serving path's shapes (stablelm-12b: H = 32, KV = 8, D = 160, bf16):
//  * flash_attention at a prefill of T = S = 32 (the prompt bucket) moves
//    0.82 MB: 0.24 us of HBM time, so bytes and in practice the launch
//    bound it.  At T = S = 2048 it needs 43 GFLOP against 52 MB: 44 us of
//    tensor-core time, so operations bound it there.
//  * decode_attention at B = 4, S = 256 reads at most 2.6 MB of cache
//    (less: keys past lengths[b] are never read): 0.8 us.  Bound by
//    bytes, about G FLOP a byte against the 295 where the tensor cores
//    would matter.
//
// What the designs do about it:
//  * flash_attention, bf16: a block owns 128 rows of one KV group with
//    the G = H / KV query heads stacked in M (row r is head kv*G + r % G
//    at position r / G), so every K/V tile read serves all G heads and a
//    short prompt still fills a 64-row wgmma tile.  Two consumer
//    warpgroups each own 64 rows.  S = Q K^T runs on wgmma m64n64k16
//    (Q and K from shared memory, K-major, D / 16 k-steps), the online
//    softmax runs on the accumulator fragment in registers, and P is the
//    register A operand of O += P V with V read MN-major from shared
//    memory, on wgmma m64nNk16 over pieces of N that sum to D (one piece
//    at 64, 80, 128 and 160; at most three, 256 = 160 + 80 + 16), so
//    every head dim from 16 to 256 in steps of 16 runs here, spill-free
//    (hubert-xlarge's 80 on m64n80k16).  P goes in as three bf16 terms
//    (hi + mid + lo, f32 precision): rounding P once to bf16, as
//    FlashAttention does, put 38,770 of the 131,072 bf16 outputs of
//    jamba's prefill an ulp off the f32 plain version, two terms 206,
//    three 14, about as many as the plain version itself misrounds
//    (scripts/torch_flash_pterms.py), at twice the tensor-core work of
//    one term.  K/V tiles of 64 keys come through a 2-stage ring filled
//    by 16-byte cp.async, the copy of tile k+1 in flight while tile k is
//    multiplied.  Shared
//    memory holds the canonical no-swizzle core-matrix layout (8 rows x
//    16 bytes contiguous) that the wgmma descriptors name.  Key tiles
//    wholly in the future of the whole query tile are skipped; rows at
//    t >= T are never written.
//  * flash_attention, f32: the exact-f32 route the Pallas kernel
//    describes, on the CUDA cores (32x32 score tiles, K/V staged in
//    shared memory as f32).
//  * decode_attention: split-K flash-decoding.  The grid is (splits,
//    KV x head chunks, B): each block serves up to 8 query heads of its
//    group over one key range of the cache, so B * KV = 32 groups still
//    fill the 132 SMs.  The wrapper chooses splits from S, B, KV and the
//    SM count, never from lengths.  K/V rows move as 16-byte cp.async
//    copies into a 2-stage ring of 32-key tiles; each of 8 warps scores
//    4 keys of a tile for all heads at once (lanes split D, and one
//    transposed butterfly of 31 shuffles sums the 32 dot products) and
//    keeps its own (m, l, acc); the block merges its warps, and a second
//    kernel merges the splits in f32 (merging in the last block of each
//    group after an atomic counter, in one launch, measured slower).
//    Keys at or past lengths[b] are never read; a split that starts past
//    them writes m = -1e30, l = 0, and a sequence of length 0 comes out 0.
//
// Plain C interface, loaded with ctypes.  attention_init() sets the
// shared-memory limits once, when the library loads, so that a launch
// makes no other CUDA call and can be captured in a CUDA graph.  Each
// launcher returns cudaGetLastError() right after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHeadDim = 256;
constexpr float kLog2e = 1.4426950408889634f;

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

// ---- asynchronous copies and wgmma --------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false nothing is read and the
// 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Shared-memory writes of the generic proxy (cp.async included) become
// visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins the accumulator registers in program order around the asynchronous
// wgmma (no read of them may move above the wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, the
// leading-dimension byte offset (between core matrices along K) and the
// stride-dimension byte offset (between core matrices along M or N), each
// in 16-byte units; layout type 0 (bits 62-63) = no swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}
// The f32 values of the low and high bf16 halves of a packed pair.
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// wgmma m64nNk16, bf16 inputs, f32 accumulators.  The accumulator
// fragment of a thread (warp w of the warpgroup, lane l) holds, in d[4 j +
// e], row 16 w + l / 4 + 8 (e / 2) and column 8 j + 2 (l % 4) + e % 2.
// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory,
// both K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] * B[16 x N], A in registers (bf16 pairs), B
// from shared memory, MN-major (transposed); d holds the N / 2
// accumulators of the fragment.  N is 16, 32, 64, 80, 128 or 160.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        " %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 80) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39},"
        " {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        " %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 160) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
        " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
        " {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N < 0, "no wgmma form for this width");
  }
}

// --------------------------------------------------------------------
// flash_attention, f32: one block per (32-row q tile, head, batch), 128
// threads; query row `row` of the tile is served by the 4 threads of one
// lane quad (`sub` = 0..3): each holds 8 of the tile's 32 key columns of
// the score tile and every 4th head-dim column of the row's accumulator.
// --------------------------------------------------------------------
constexpr int kFlashThreads = 128;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 32;  // keys per tile
constexpr int kColsPerThread = kBK / 4;

size_t flash_smem_bytes(int D) {
  const int DP = D + 1;
  return sizeof(float) * (size_t)(kBQ * DP + 2 * kBK * DP + kBQ * (kBK + 1));
}

template <int PT>  // PT >= ceil(D / 4): accumulator columns
__global__ void __launch_bounds__(kFlashThreads) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int H, int KV,
    int Tq, int S, int D, long long qsb, long long qsh, long long qst,
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

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;
  for (int i = tid; i < kBQ * D; i += kFlashThreads) {
    const int r = i / D, d = i - r * D;
    sQ[r * DP + d] = q0 + r < Tq ? qb[(q0 + r) * qst + d] : 0.0f;
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
      sK[r * DP + d] = in ? kb[(k0 + r) * kss + d] : 0.0f;
      sV[r * DP + d] = in ? vb[(k0 + r) * vss + d] : 0.0f;
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
    float* orow = o + b * osb + h * osh + qpos * ost;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int d = sub + 4 * j;
      if (d < D) orow[d] = acc[j] / denom;
    }
  }
}

// --------------------------------------------------------------------
// flash_attention, bf16: wgmma.  One block per (128 stacked rows, KV
// group, batch); 256 threads = two warpgroups of 64 rows each.
// --------------------------------------------------------------------
constexpr int kWgRows = 128;     // stacked query rows per block
constexpr int kWgKeys = 64;      // keys per K/V tile
constexpr int kWgThreads = 256;  // two consumer warpgroups
// bf16 terms P is split into for the P V product: 3 keeps f32 precision;
// a build with -DFLASH_P_TERMS=1 or 2 trades it for time
// (scripts/torch_flash_pterms.py measures both).
#ifndef FLASH_P_TERMS
#define FLASH_P_TERMS 3
#endif
constexpr int kPTerms = FLASH_P_TERMS;
static_assert(kPTerms >= 1 && kPTerms <= 3, "P is 1 to 3 bf16 terms");

size_t wgmma_smem_bytes(int D) {  // Q, then 2 stages of (K, V), bf16
  return 2 * (size_t)D * (kWgRows + 4 * kWgKeys);
}

// Byte offset of the 16-byte chunk (row, dc) of a [rows x D] bf16 tile in
// the no-swizzle core-matrix layout: a core matrix is 8 rows x 16 bytes,
// contiguous; row groups lie 128 bytes apart and chunk columns rows * 16
// bytes apart.
__device__ __forceinline__ uint32_t tile_off(int row, int dc, int rows) {
  return (row & 7) * 16 + (row >> 3) * 128 + dc * rows * 16;
}

// The P V product's N = D is split into pieces of the widths that have a
// wgmma_rs form, widest first: at most three (256 = 160 + 80 + 16).
__host__ __device__ constexpr int pv_piece(int rem) {
  return rem >= 160 ? 160 : rem >= 128 ? 128 : rem >= 80 ? 80
       : rem >= 64 ? 64 : rem >= 32 ? 32 : rem >= 16 ? 16 : 0;
}

// O[:, Off, Off + Rem) += P V[:, Off, Off + Rem): one wgmma per piece, V
// tile columns Off / 8 core matrices in (kWgKeys * 16 bytes apart).
template <int Off, int Rem>
__device__ __forceinline__ void pv_product(float* acc, const uint32_t (&a)[4],
                                           uint32_t v_addr) {
  constexpr int n = pv_piece(Rem);
  static_assert(n > 0, "D must be a multiple of 16");
  wgmma_rs<n>(acc + Off / 2, a,
              make_desc(v_addr + (Off / 8) * kWgKeys * 16, 128, kWgKeys * 16));
  if constexpr (Rem > n) pv_product<Off + n, Rem - n>(acc, a, v_addr);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int H, int KV, int Tq, int S, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long ost, int causal, float scale_log2) {
  static_assert(D % 16 == 0 && D <= 256, "D: a multiple of 16, at most 256");
  constexpr int kDc = D / 8;                      // 16-byte chunks a row
  constexpr uint32_t kQBytes = kWgRows * D * 2;
  constexpr uint32_t kTileBytes = kWgKeys * D * 2;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t sQ = smem_addr(wg_smem);
  const uint32_t sKV = sQ + kQBytes;  // stage st: K at +2 st tiles, V after

  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wwarp = warp & 3;
  // Blocks start in reverse, so the causal tiles with the most keys go
  // first.
  const int R0 = (gridDim.x - 1 - blockIdx.x) * kWgRows;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rows_total = Tq * G;

  // Copies: copy c moves row 8 (m / kDc) + c % 8, chunk m % kDc of core
  // matrix m = c / 8, so 8 lanes write one core matrix (conflict-free) and
  // a warp reads 64 contiguous bytes of each of 8 rows.
  const int rl = lane & 7;
  for (int c = tid; c < kWgRows * kDc; c += kWgThreads) {
    const int m = c >> 3, row = (m / kDc) * 8 + rl, dc = m % kDc;
    const int R = R0 + row;
    const bool in = R < rows_total;
    const int t = in ? R / G : 0, g = in ? R - (R / G) * G : 0;
    cp_async16(sQ + tile_off(row, dc, kWgRows),
               q + b * qsb + (long long)(kvh * G + g) * qsh +
                   (long long)t * qst + dc * 8,
               in);
  }
  cp_async_commit();

  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;
  auto load_kv = [&](int kt, int st) {
    const uint32_t dK = sKV + st * 2 * kTileBytes, dV = dK + kTileBytes;
    for (int c = tid; c < kWgKeys * kDc; c += kWgThreads) {
      const int m = c >> 3, row = (m / kDc) * 8 + rl, dc = m % kDc;
      const int s = kt * kWgKeys + row;
      const bool in = s < S;  // keys past S are zero-filled, never read
      const long long sr = in ? s : 0;
      cp_async16(dK + tile_off(row, dc, kWgKeys), kb + sr * kss + dc * 8, in);
      cp_async16(dV + tile_off(row, dc, kWgKeys), vb + sr * vss + dc * 8, in);
    }
  };

  // This thread's two accumulator rows (wgmma fragment: rows lane / 4 and
  // lane / 4 + 8 of its warp's 16) and their positions.
  const int rA = R0 + wg * 64 + wwarp * 16 + (lane >> 2);
  const int tA = rA / G, tB = (rA + 8) / G;
  const int t_min = R0 / G;
  const int t_max = min(Tq - 1, (R0 + kWgRows - 1) / G);
  // Causal: key tiles wholly in the future of the whole tile are skipped.
  const int s_end = causal ? min(S, t_max + 1) : S;
  const int nk = (s_end + kWgKeys - 1) / kWgKeys;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  load_kv(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile kt have landed (this thread's part)
    fence_proxy_async();
    __syncthreads();     // ... and every thread's part

    const uint32_t dK = sKV + (kt & 1) * 2 * kTileBytes, dV = dK + kTileBytes;
    const int k0 = kt * kWgKeys;

    // S = Q K^T: A = Q rows [64 wg, 64 wg + 64), B = K, both K-major.
    float sc[kWgKeys / 2];
#pragma unroll
    for (int i = 0; i < kWgKeys / 2; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint64_t da = make_desc(sQ + wg * 1024 + ks * 2 * kWgRows * 16,
                                    kWgRows * 16, 128);
      const uint64_t db = make_desc(dK + ks * 2 * kWgKeys * 16,
                                    kWgKeys * 16, 128);
      wgmma_ss(sc, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Online softmax on the fragment, in the log2 domain: element e is row
    // (e & 2 ? B : A), key k0 + 8 (e / 4) + 2 (lane % 4) + (e & 1).
    const bool need_mask =
        k0 + kWgKeys > S || (causal && k0 + kWgKeys - 1 > t_min);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int e = 0; e < kWgKeys / 2; ++e) {
      float x = sc[e] * scale_log2;
      if (need_mask) {
        const int key = k0 + (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
        const int t = (e & 2) ? tB : tA;
        if (key >= S || (causal && key > t)) x = kNegInf;
      }
      sc[e] = x;
      if (e & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int e = 0; e < kWgKeys / 2; ++e) {
      const float p = exp2f(sc[e] - ((e & 2) ? mn1 : mn0));
      sc[e] = p;
      if (e & 2) ps1 += p; else ps0 += p;
    }
    l0 = l0 * c0 + ps0;  // this thread's columns; the quad sums at the end
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? c1 : c0;

    // P as the register A operand: the accumulator layout of S is the
    // A-fragment layout, 16 keys (8 registers) per k-step.  P goes in as
    // kPTerms bf16 terms (p = hi + mid + lo to f32 precision), each a
    // product with the same V tile: one bf16 rounding of P alone moves
    // the bf16 output off the f32 result often enough to change a model's
    // downstream choices.
    uint32_t pa[kPTerms][kWgKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgKeys / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p0 = sc[8 * kk + 2 * r], p1 = sc[8 * kk + 2 * r + 1];
#pragma unroll
        for (int term = 0; term < kPTerms; ++term) {
          pa[term][kk][r] = pack_bf16(p0, p1);
          p0 -= bf16_lo(pa[term][kk][r]);
          p1 -= bf16_hi(pa[term][kk][r]);
        }
      }
    }

    // O += P V: B = V tile, MN-major (d contiguous); K steps of 16 keys.
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kWgKeys / 16; ++kk) {
#pragma unroll
      for (int term = 0; term < kPTerms; ++term)
        pv_product<0, D>(acc, pa[term][kk], dV + kk * 256);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // stage kt & 1 is read; the next loads may refill it
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const int col = 2 * (lane & 3);
  if (tA < Tq) {
    __nv_bfloat16* orow =
        o + b * osb + (long long)(kvh * G + rA % G) * osh + (long long)tA * ost;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
          pack_bf16(acc[4 * j] / den0, acc[4 * j + 1] / den0);
  }
  if (tB < Tq) {
    __nv_bfloat16* orow = o + b * osb +
                          (long long)(kvh * G + (rA + 8) % G) * osh +
                          (long long)tB * ost;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
          pack_bf16(acc[4 * j + 2] / den1, acc[4 * j + 3] / den1);
  }
}

// --------------------------------------------------------------------
// decode_attention: split-K.  Block (split, KV group x head chunk, b), 4
// warps; a 2-stage cp.async ring of 32-key tiles, 8 keys a warp, taken 4
// at a time; lane j of a warp holds head-dim elements j, j + 32, ...
// --------------------------------------------------------------------
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecKeys = 32;   // keys per tile
constexpr int kDecHeads = 8;   // query heads per block, at most
constexpr int kDecStep = kDecKeys / kDecWarps;  // keys a warp scores at once
static_assert(kDecStep * kDecHeads == 32, "a warp reduces 32 dot products");

template <typename T>
size_t decode_smem_bytes(int D) {
  const size_t ring = 2 * 2 * (size_t)kDecKeys * D * sizeof(T);
  const size_t parts = sizeof(float) * kDecWarps * kDecHeads * (D + 2);
  return ring > parts ? ring : parts;  // the warps' partials reuse the ring
}

// One level of a transposed butterfly over 32 values a lane: lanes with
// bit O set keep the upper half of v[0, 2 O) and hand the lower half to
// their partner, which keeps the lower; each adds what it receives.
// After the levels 16, 8, 4, 2, 1, lane L holds the warp's sum of v[L].
template <int O>
__device__ __forceinline__ void butterfly_level(float (&v)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <typename T, int NJ>  // NJ >= ceil(D / 32)
__global__ void __launch_bounds__(kDecThreads, 1) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ lengths,
    T* __restrict__ o, float* __restrict__ ws, int H, int KV, int S, int D,
    int chunk, long long qsb, long long qsh,
    long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh,
    float scale_log2) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  T* ring = reinterpret_cast<T*>(dec_smem);  // stage st: K, then V
  const int G = H / KV;
  const int gchunks = (G + kDecHeads - 1) / kDecHeads;
  const int split = blockIdx.x, splits = gridDim.x;
  const int kvh = blockIdx.y / gchunks;
  const int gc = blockIdx.y - kvh * gchunks;
  const int b = blockIdx.z;
  const int h0 = kvh * G + gc * kDecHeads;
  const int ng = min(kDecHeads, G - gc * kDecHeads);
  const int len = min(max(lengths[b], 0), S);
  const int kbeg = split * chunk;
  const int kend = min(kbeg + chunk, len);
  const int nt = kend > kbeg ? (kend - kbeg + kDecKeys - 1) / kDecKeys : 0;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Lane L keeps the running (m, l) of head L % 8; acc[g][j] is head g at
  // d = lane + 32 j.
  float qr[kDecHeads][NJ], acc[kDecHeads][NJ];
  float mh = kNegInf, lh = 0.0f;
#pragma unroll
  for (int g = 0; g < kDecHeads; ++g) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      qr[g][j] = g < ng && d < D ? to_f32(q[b * qsb + (h0 + g) * qsh + d])
                                 : 0.0f;
      acc[g][j] = 0.0f;
    }
  }

  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte copy
  const int cpr = D / kPer;             // copies per row
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  auto load = [&](int t, int st) {
    const int k0 = kbeg + t * kDecKeys;
    const int rows = min(kDecKeys, kend - k0);  // keys past kend: not read
    T* sk = ring + st * 2 * kDecKeys * D;
    T* sv = sk + kDecKeys * D;
    for (int i = tid; i < rows * cpr; i += kDecThreads) {
      const int r = i / cpr, c = (i - r * cpr) * kPer;
      cp_async16(smem_addr(sk + r * D + c), kb + (long long)(k0 + r) * kss + c,
                 true);
      cp_async16(smem_addr(sv + r * D + c), vb + (long long)(k0 + r) * vss + c,
                 true);
    }
  };

  if (nt > 0) load(0, 0);
  cp_async_commit();
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) load(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* sk = ring + (t & 1) * 2 * kDecKeys * D;
    const T* sv = sk + kDecKeys * D;
    const int nkeys = min(kDecKeys, kend - (kbeg + t * kDecKeys));
    // Warp w scores keys c0 .. c0 + 3 of the tile for all heads at once.
    const int c0 = warp * kDecStep;
    if (c0 < nkeys) {  // warp-uniform
      float v32[kDecStep * kDecHeads];  // lane's partial dot of (key, head)
      float vv[kDecStep][NJ];           // V rows of the step, lane's slice
#pragma unroll
      for (int kk = 0; kk < kDecStep; ++kk) {
        const int c = c0 + kk;
        float kr[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          const bool in = c < nkeys && d < D;
          kr[j] = in ? to_f32(sk[c * D + d]) : 0.0f;
          vv[kk][j] = in ? to_f32(sv[c * D + d]) : 0.0f;
        }
#pragma unroll
        for (int g = 0; g < kDecHeads; ++g) {
          float dot = 0.0f;
          if (g < ng) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) dot += qr[g][j] * kr[j];
          }
          v32[kk * kDecHeads + g] = dot;
        }
      }
      // Transposed butterfly: 31 shuffles leave lane L with the whole sum
      // of value L, key c0 + L / 8 and head L % 8 (not 5 per value).
      butterfly_level<16>(v32, lane);
      butterfly_level<8>(v32, lane);
      butterfly_level<4>(v32, lane);
      butterfly_level<2>(v32, lane);
      butterfly_level<1>(v32, lane);
      // Online softmax of head L % 8 over the step's 4 keys (lanes L, L ^ 8,
      // L ^ 16, L ^ 24), in the log2 domain.
      const bool valid = (lane % kDecHeads) < ng &&
                         c0 + lane / kDecHeads < nkeys;
      const float x = valid ? v32[0] * scale_log2 : kNegInf;
      float mx = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float mn = fmaxf(mh, mx);
      const float corr = exp2f(mh - mn);
      const float p = exp2f(x - mn);
      float ps = p + __shfl_xor_sync(0xffffffffu, p, 8);
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
      lh = lh * corr + ps;
      mh = mn;
      // acc = acc * corr + P V, each head's corr and p fetched from the lane
      // that holds them.
#pragma unroll
      for (int g = 0; g < kDecHeads; ++g) {
        if (g < ng) {
          const float cg = __shfl_sync(0xffffffffu, corr, g);
          float pk[kDecStep];
#pragma unroll
          for (int kk = 0; kk < kDecStep; ++kk)
            pk[kk] = __shfl_sync(0xffffffffu, p, kk * kDecHeads + g);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float a = acc[g][j] * cg;
#pragma unroll
            for (int kk = 0; kk < kDecStep; ++kk) a += pk[kk] * vv[kk][j];
            acc[g][j] = a;
          }
        }
      }
    }
    __syncthreads();  // stage t & 1 is read; the next loads may refill it
  }
  cp_async_wait<0>();
  __syncthreads();

  // Merge the warps' (m, l, acc) in shared memory (over the ring).
  float* part = reinterpret_cast<float*>(dec_smem);  // [warp][head][D + 2]
#pragma unroll
  for (int g = 0; g < kDecHeads; ++g) {
    if (g < ng) {
      float* pw = part + (warp * kDecHeads + g) * (D + 2);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        if (d < D) pw[d] = acc[g][j];
      }
      if (lane == g) {  // lane g holds head g's (m, l)
        pw[D] = mh;
        pw[D + 1] = lh;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < ng * D; i += kDecThreads) {
    const int g = i / D, d = i - g * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      M = fmaxf(M, part[(w * kDecHeads + g) * (D + 2) + D]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float* pw = part + (w * kDecHeads + g) * (D + 2);
      const float e = exp2f(pw[D] - M);  // -1e30 - M underflows to 0
      L += pw[D + 1] * e;
      A += pw[d] * e;
    }
    if (splits == 1) {
      o[b * osb + (h0 + g) * osh + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
    } else {
      float* w = ws + (((long long)b * H + h0 + g) * splits + split) * (D + 2);
      w[d] = A;
      if (d == 0) {
        w[D] = M;
        w[D + 1] = L;
      }
    }
  }
}

// The f32 merge of the splits' partials: one block per (head, batch row).
template <typename T>
__global__ void __launch_bounds__(128) decode_merge_kernel(
    const float* __restrict__ ws, T* __restrict__ o, int H, int D,
    int splits, long long osb, long long osh) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* w = ws + ((long long)b * H + h) * splits * (D + 2);
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, w[s * (D + 2) + D]);
  float L = 0.0f;
  for (int s = 0; s < splits; ++s)
    L += w[s * (D + 2) + D + 1] * exp2f(w[s * (D + 2) + D] - M);
  const float den = fmaxf(L, 1e-30f);  // a length-0 row: 0 / 1e-30 = 0
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float A = 0.0f;
    for (int s = 0; s < splits; ++s)
      A += w[s * (D + 2) + d] * exp2f(w[s * (D + 2) + D] - M);
    o[b * osb + h * osh + d] = from_f32<T>(A / den);
  }
}

// ---- launchers ----------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int PT>
int flash_f32_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int Tq, int S, int D,
                     const long long* st, int causal, float scale,
                     cudaStream_t stream) {
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<PT>
      <<<grid, kFlashThreads, flash_smem_bytes(D), stream>>>(
          (const float*)q, (const float*)k, (const float*)v, (float*)o, H,
          KV, Tq, S, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
          st[7], st[8], st[9], st[10], st[11], causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int flash_bf16_launch(const void* q, const void* k, const void* v, void* o,
                      int B, int H, int KV, int Tq, int S,
                      const long long* st, int causal, float scale,
                      cudaStream_t stream) {
  const int rows = Tq * (H / KV);
  const dim3 grid((rows + kWgRows - 1) / kWgRows, KV, B);
  flash_wgmma_kernel<D><<<grid, kWgThreads, wgmma_smem_bytes(D), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, H, KV, Tq, S, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

// The bf16 wgmma kernel at every head dim the wrappers take (16 to 256
// in steps of 16): ptxas reports no spills at any of them (140
// registers at 16, 193 at 80, 245 at 256; the O accumulator alone is
// D / 2 a thread).
template <int... Ds>
struct WgmmaDims {
  static cudaError_t allow() {
    cudaError_t e = cudaSuccess;
    ((e = e == cudaSuccess
              ? allow_smem(flash_wgmma_kernel<Ds>, wgmma_smem_bytes(Ds))
              : e),
     ...);
    return e;
  }
  static int launch(int d, const void* q, const void* k, const void* v,
                    void* o, int B, int H, int KV, int Tq, int S,
                    const long long* st, int causal, float scale,
                    cudaStream_t s) {
    int status = (int)cudaErrorInvalidValue;
    ((d == Ds ? (status = flash_bf16_launch<Ds>(q, k, v, o, B, H, KV, Tq, S,
                                                 st, causal, scale, s))
              : 0),
     ...);
    return status;
  }
};
using FlashWgmma = WgmmaDims<16, 32, 48, 64, 80, 96, 112, 128, 144, 160, 176,
                             192, 208, 224, 240, 256>;

template <typename T, int NJ>
int decode_launch_t(const void* q, const void* k, const void* v,
                    const int32_t* lengths, void* o, float* ws, int B, int H,
                    int KV, int S, int D, int splits, int chunk,
                    const long long* st, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const dim3 grid(splits, KV * ((G + kDecHeads - 1) / kDecHeads), B);
  decode_split_kernel<T, NJ>
      <<<grid, kDecThreads, decode_smem_bytes<T>(D), stream>>>(
          (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, ws, H, KV,
          S, D, chunk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
          st[8], st[9], scale * kLog2e);
  if (splits > 1)
    decode_merge_kernel<T><<<dim3(H, B), 128, 0, stream>>>(
        ws, (T*)o, H, D, splits, st[8], st[9]);
  return (int)cudaGetLastError();
}

template <typename T>
int decode_launch_d(const void* q, const void* k, const void* v,
                    const int32_t* lengths, void* o, float* ws, int B, int H,
                    int KV, int S, int D, int splits, int chunk,
                    const long long* st, float scale, cudaStream_t stream) {
  if (D <= 64)
    return decode_launch_t<T, 2>(q, k, v, lengths, o, ws, B, H, KV, S, D,
                                 splits, chunk, st, scale, stream);
  if (D <= 128)
    return decode_launch_t<T, 4>(q, k, v, lengths, o, ws, B, H, KV, S, D,
                                 splits, chunk, st, scale, stream);
  if (D <= 160)
    return decode_launch_t<T, 5>(q, k, v, lengths, o, ws, B, H, KV, S, D,
                                 splits, chunk, st, scale, stream);
  return decode_launch_t<T, 8>(q, k, v, lengths, o, ws, B, H, KV, S, D,
                               splits, chunk, st, scale, stream);
}

bool shape_ok(int H, int KV, int D) {
  return KV >= 1 && H >= KV && H % KV == 0 && D >= 16 && D % 16 == 0 &&
         D <= kMaxHeadDim;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Every row a cp.async copy starts must be 16-byte aligned.
bool strides_aligned(const long long* st, int n, int elem) {
  for (int i = 0; i < n; ++i)
    if ((st[i] * elem) % 16) return false;
  return true;
}

}  // namespace

// Shared-memory limits of every kernel, set once when the library loads
// (a launch then makes no other CUDA call, and a CUDA graph can capture
// it).  Returns the first error, or 0.
extern "C" int attention_init() {
  cudaError_t e[13] = {
      allow_smem(flash_attention_kernel<16>, flash_smem_bytes(64)),
      allow_smem(flash_attention_kernel<32>, flash_smem_bytes(128)),
      allow_smem(flash_attention_kernel<40>, flash_smem_bytes(160)),
      allow_smem(flash_attention_kernel<64>, flash_smem_bytes(256)),
      FlashWgmma::allow(),
      allow_smem(decode_split_kernel<float, 2>, decode_smem_bytes<float>(64)),
      allow_smem(decode_split_kernel<float, 4>,
                 decode_smem_bytes<float>(128)),
      allow_smem(decode_split_kernel<float, 5>,
                 decode_smem_bytes<float>(160)),
      allow_smem(decode_split_kernel<float, 8>,
                 decode_smem_bytes<float>(256)),
      allow_smem(decode_split_kernel<__nv_bfloat16, 2>,
                 decode_smem_bytes<__nv_bfloat16>(64)),
      allow_smem(decode_split_kernel<__nv_bfloat16, 4>,
                 decode_smem_bytes<__nv_bfloat16>(128)),
      allow_smem(decode_split_kernel<__nv_bfloat16, 5>,
                 decode_smem_bytes<__nv_bfloat16>(160)),
      allow_smem(decode_split_kernel<__nv_bfloat16, 8>,
                 decode_smem_bytes<__nv_bfloat16>(256)),
  };
  for (cudaError_t x : e)
    if (x != cudaSuccess) return (int)x;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  strides (elements, last dim 1):
// q (b, h, t), k (b, kv, s), v (b, kv, s), o (b, h, t).  bf16 needs
// 16-byte-aligned rows.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int H, int KV, int Tq, int S,
                                      int D, const long long* strides,
                                      int causal, float scale,
                                      void* stream) {
  if (!shape_ok(H, KV, D) || B < 1 || Tq < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (D <= 64)
      return flash_f32_launch<16>(q, k, v, o, B, H, KV, Tq, S, D, strides,
                                  causal, scale, s);
    if (D <= 128)
      return flash_f32_launch<32>(q, k, v, o, B, H, KV, Tq, S, D, strides,
                                  causal, scale, s);
    if (D <= 160)
      return flash_f32_launch<40>(q, k, v, o, B, H, KV, Tq, S, D, strides,
                                  causal, scale, s);
    return flash_f32_launch<64>(q, k, v, o, B, H, KV, Tq, S, D, strides,
                                causal, scale, s);
  }
  if (dtype != 1 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !strides_aligned(strides, 9, 2))
    return (int)cudaErrorInvalidValue;
  return FlashWgmma::launch(D, q, k, v, o, B, H, KV, Tq, S, strides, causal,
                            scale, s);
}

// strides (elements, last dim 1): q (b, h), k (b, kv, s), v (b, kv, s),
// o (b, h).  The cache's S rows are cut into `splits` ranges of `chunk`
// keys, which must cover [0, S) with none empty; with splits > 1,
// `workspace` holds B * H * splits * (D + 2) floats and a second kernel
// merges the splits.  k and v rows must be 16-byte aligned.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const int32_t* lengths, void* o,
                                       float* workspace, int B, int H,
                                       int KV, int S, int D, int splits,
                                       int chunk, const long long* strides,
                                       float scale, void* stream) {
  if (!shape_ok(H, KV, D) || B < 1 || S < 1 || splits < 1 || chunk < 1 ||
      (long long)(splits - 1) * chunk >= S ||
      (long long)splits * chunk < S || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  if (!aligned16(k) || !aligned16(v) || !strides_aligned(strides + 2, 6, elem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return decode_launch_d<float>(q, k, v, lengths, o, workspace, B, H, KV,
                                  S, D, splits, chunk, strides, scale, s);
  if (dtype == 1)
    return decode_launch_d<__nv_bfloat16>(q, k, v, lengths, o, workspace, B,
                                          H, KV, S, D, splits, chunk,
                                          strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a launch needs, so the wrapper can refuse a shape
// the card cannot hold before launching.
extern "C" long long flash_attention_smem_bytes(int dtype, int D) {
  return (long long)(dtype == 0 ? flash_smem_bytes(D) : wgmma_smem_bytes(D));
}

extern "C" long long decode_attention_smem_bytes(int dtype, int D) {
  return (long long)(dtype == 0 ? decode_smem_bytes<float>(D)
                                : decode_smem_bytes<__nv_bfloat16>(D));
}
