#!/usr/bin/env python3
"""Where the scan kernels' time goes on one card: variants of their
sources, timed beside them.

    python3 scripts/torch_scan_probe.py        # from the repository root

Each variant is the committed source (``src/repro_torch/csrc``) with a
few lines replaced, built with the same ``nvcc`` flags into
``src/repro_torch/_build/variants/`` and launched through the port's own
wrapper (its library swapped in); every time is ``device_ms``, calls
captured in a CUDA graph (``chip_smoke.py``'s ``_device_ms``), f32:

* ``rwkv6_scan`` at rwkv6-1.6b's heads (B 1, K 64, T 2048): as
  committed; with the helpers issuing no copies after the first ring (the
  walk reads stale tiles: the time without loads); with the walk doing
  its arithmetic only (no shared loads or stores); and as committed at H
  16 and 8 (fewer blocks, the same work each).
* ``mamba_scan`` at jamba's (B 1, N 16, T 2048): as committed; with
  ``exp2f`` for the decay instead of the flushing ``ex2``; and as
  committed at I 8192 and 4096.
* the shared-memory pipe: SM cycles (at the card's maximum SM clock) per
  warp-wide 16-byte load when the warp reads 1, 2, 4, 8 or 32 distinct
  16-byte words, and per 4-byte load.

A variant whose lines no longer match the source stops the script.
Prints one line per measurement and the card's ``nvidia-smi`` name and
power limit.  The variants compute wrong outputs on purpose; only the
committed kernels are checked, by ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

RWKV_VARIANTS = {
    "no loads after the first ring": [
        ("      issue(tile + kAhead);",
         "      if (tile < 0) issue(tile + kAhead);")],
    "walk arithmetic only": [
        ("      load_q<Q>(st + j * K + row, o.r + e);\n"
         "      load_q<Q>(st + kTile * K + j * K + row, o.k + e);\n"
         "      load_q<Q>(w + j * K + row, o.w + e);\n",
         "      for (int i = 0; i < Q; ++i) {\n"
         "        o.r[e + i] = 0.01f * (j + i + row);\n"
         "        o.k[e + i] = 0.02f * (j - i);\n"
         "        o.w[e + i] = 0.5f + 0.001f * (j * i);\n"
         "      }\n"),
        ("    o.v = to_f32(st[3 * kTile * K + j * kCols + col]);",
         "    o.v = 0.3f * j + col;"),
        ("    part[j * kPartTok + g * kPartRow + col] = acc0 + acc1;",
         "    if (acc0 + acc1 == 1234.5f) part[j] = 0.f;")],
}
MAMBA_VARIANTS = {
    "exp2f decay": [("const float decay = exp2_ftz(d * a2[s]);",
                     "const float decay = exp2f(d * a2[s]);")],
}

LDS_BENCH = r"""
#include <cuda_runtime.h>
// pattern: distinct 16-byte words a warp reads (1, 2, 4, 8, 32); 0: a
// 4-byte load, 8 distinct words.
__global__ void bench(int* out, int pattern, int iters) {
  __shared__ float4 buf[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int idx = pattern == 0 ? lane & 7 : lane % pattern;
  int acc = 0;
  const float* f = reinterpret_cast<const float*>(buf);
  if (pattern > 0) {
#pragma unroll 8
    for (int it = 0; it < iters; ++it) {
      const float4 x = buf[(idx + (it & 15) * 32) & 1023];
      acc ^= __float_as_int(x.x) ^ __float_as_int(x.w);
    }
  } else {
#pragma unroll 8
    for (int it = 0; it < iters; ++it)
      acc ^= __float_as_int(f[(idx + (it & 15) * 32) & 4095]);
  }
  if (acc == 0x12345678) out[0] = acc;
}
extern "C" int bench_launch(int* out, int pattern, int iters, int blocks,
                            int threads, void* stream) {
  bench<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, pattern, iters);
  return (int)cudaGetLastError();
}
"""


def build_variant(name: str, source: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name}.cu"
    src.write_text(source)
    lib = out / f"lib{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def variant(kernel: str, tag: str, subs) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    source = (_build.CSRC / f"{kernel}.cu").read_text()
    for old, new in subs:
        if old not in source:
            raise SystemExit(f"{kernel} variant {tag!r}: the source no "
                             f"longer has {old!r}")
        source = source.replace(old, new)
    slug = "".join(ch if ch.isalnum() else "_" for ch in tag)
    return build_variant(f"{kernel}_{slug}", source)


def timed(module, entry: str, lib, fn) -> float:
    import chip_smoke as cs

    keep = module._lib()
    if lib is not None:
        getattr(lib, entry).argtypes = getattr(keep, entry).argtypes
        getattr(lib, entry).restype = ctypes.c_int
        module._LIB = lib
    try:
        return cs._device_ms(fn, 10)
    finally:
        module._LIB = keep


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import rwkv6_scan as rs

    if not torch.cuda.is_available():
        print("torch_scan_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)

    xs = cs.rwkv_inputs(gen, 1, 32, 2048, 64, torch.float32)
    run = (lambda: rs.rwkv6_scan_cuda(*xs))
    print(f"rwkv6_scan H32 T2048 committed device_ms="
          f"{timed(rs, 'rwkv6_scan_launch', None, run):.6f}", flush=True)
    for tag, subs in RWKV_VARIANTS.items():
        lib = variant("rwkv6_scan", tag, subs)
        print(f"rwkv6_scan H32 T2048 {tag} device_ms="
              f"{timed(rs, 'rwkv6_scan_launch', lib, run):.6f}", flush=True)
    for H in (16, 8):
        xh = cs.rwkv_inputs(gen, 1, H, 2048, 64, torch.float32)
        d = timed(rs, "rwkv6_scan_launch", None,
                  lambda: rs.rwkv6_scan_cuda(*xh))
        print(f"rwkv6_scan H{H} T2048 committed ({H * 4} blocks) "
              f"device_ms={d:.6f}", flush=True)

    xs = cs.mamba_inputs(gen, 1, 2048, 16384, 16, torch.float32)
    run = (lambda: ms.mamba_scan_cuda(*xs))
    print(f"mamba_scan I16384 T2048 committed device_ms="
          f"{timed(ms, 'mamba_scan_launch', None, run):.6f}", flush=True)
    for tag, subs in MAMBA_VARIANTS.items():
        lib = variant("mamba_scan", tag, subs)
        print(f"mamba_scan I16384 T2048 {tag} device_ms="
              f"{timed(ms, 'mamba_scan_launch', lib, run):.6f}", flush=True)
    for I in (8192, 4096):
        xi = cs.mamba_inputs(gen, 1, 2048, I, 16, torch.float32)
        d = timed(ms, "mamba_scan_launch", None,
                  lambda: ms.mamba_scan_cuda(*xi))
        print(f"mamba_scan I{I} T2048 committed ({I // 32} blocks) "
              f"device_ms={d:.6f}", flush=True)

    lib = build_variant("ldsbench", LDS_BENCH)
    lib.bench_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    iters, blocks, threads = 4096, sms * 8, 256
    for pattern in (1, 2, 4, 8, 32, 0):
        def launch():
            lib.bench_launch(out.data_ptr(), pattern, iters, blocks, threads,
                             torch.cuda.current_stream().cuda_stream)
        launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            launch()
        end.record()
        end.synchronize()
        ms_ = start.elapsed_time(end) / 5
        loads = iters * blocks * threads // 32 / sms     # a SM's warp loads
        what = ("4-byte load, 8 words" if pattern == 0 else
                f"16-byte load, {pattern} distinct words")
        print(f"shared {what}: {ms_ * 1e-3 * float(clock) * 1e6 / loads:.3f} "
              f"SM cycles a load at the {clock} MHz maximum clock",
              flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
