#!/usr/bin/env python3
"""Peak rate of warp-level ``mma.sync`` on TF32 tiles on this card.

    python3 tools/mma_sync_tf32_peak.py

The float32 flash kernel (``src/repro_torch/kernels/csrc/flash_attention.cu``)
runs its three TF32 products on ``mma.sync.m16n8k8``, not on ``wgmma``; the
card's published TF32 peak (495 TFLOP/s on an H100 SXM) is ``wgmma``'s.  This
times a kernel that does nothing but ``mma.sync`` m16n8k8 TF32 products from
registers, with 1, 4 or 8 independent accumulators a warp and 4 to 16 warps a
block, and prints the TFLOP/s of each, with the card's name and power limit.
The library is built with ``nvcc`` into ``build/tools/`` and needs a CUDA
card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels._build import nvcc  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int C>
__global__ void mma_loop(float* out, int iters) {
  float d[C][4] = {};
  const uint32_t a[4] = {0x3f800000u + threadIdx.x, 0x3f000000u,
                         0x3e800000u, 0x3f800000u};
  const uint32_t b0 = 0x3c000000u + threadIdx.x, b1 = 0x3c800000u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int blocks, int threads, int iters,
                   int chains) {
  if (chains == 1) mma_loop<1><<<blocks, threads>>>(out, iters);
  else if (chains == 4) mma_loop<4><<<blocks, threads>>>(out, iters);
  else mma_loop<8><<<blocks, threads>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "mma_loop.cu", out_dir / "libmma_loop.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 4 * 512, device="cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for chains in (1, 4, 8):
        for warps in (4, 8, 16):
            blocks, iters = sms * 4, 4000
            if lib.run(buf.data_ptr(), blocks, 32 * warps, 10, chains):
                raise RuntimeError("launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.run(buf.data_ptr(), blocks, 32 * warps, iters, chains)
            end.record()
            end.synchronize()
            flop = blocks * warps * chains * iters * 2 * 16 * 8 * 8
            tflops = flop / (start.elapsed_time(end) * 1e-3) / 1e12
            print(f"mma.sync m16n8k8 tf32: {chains} accumulators a warp, "
                  f"{warps} warps a block: {tflops:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
