"""The bf16 wgmma rate on the card by the wgmma's n, the number of
warpgroups and the shared-memory layout of its operands.

    python -m parrot_tts_tpu_torch.scripts.exp_wgmma_rate [--iters N]

Run from the root of the checkout, on a machine with a CUDA card and
nvcc. Row 6's bf16 mode (`csrc/fused_mrf.cu::mrf_kernel_bf16`) issues
m64nCk16 products with C = 16, 32 or 64 output channels; this measures
what one such product costs the tensor cores when nothing else runs. One
block per SM (132 blocks) of W warpgroups; each warpgroup issues, per
step, a 64-deep reduction (4 k-steps of 16) into each of U accumulators
of 64 x n, commits the step and waits for the one before it (two steps in
flight), for `iters` steps. Both operands are K-major bf16 in shared
memory, read through descriptors, in the no-swizzle layout (8 x 16-byte
core matrices, the fused MRF's) or the 128-byte swizzle. "branch" puts
each unit's products behind a test the block agrees on (always taken),
as the fused MRF skips rounds past a conv's rows; "branch1" does so with
one k-step per unit, as the fused MRF at C = 16. Printed per
case: ms (CUDA events), TFLOP/s against the 989 TFLOP/s peak, and SM
cycles per wgmma (at the card's maximum SM clock). The source is written
and built under build/ at run time.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess

import torch

from parrot_tts_tpu_torch.core import kernels

BF16_PEAK = 989e12
# (n, warpgroups, units, layout); "branch": the no-swizzle layout with
# each unit's products behind a test the block agrees on (taken), as the
# fused MRF skips rounds past a conv's rows
CASES = [(n, w, min(4, 256 // n), lay) for lay in ("none", "branch")
         for n in (16, 32, 64, 128, 256)
         for w in ((1, 2, 4) if n <= 64 else (1, 2))]
CASES += [(n, w, min(4, 256 // n), "sw128") for n in (16, 64, 256)
          for w in ((2, 4) if n <= 64 else (2,))]
# "branch1": as "branch", one k-step per unit (the fused MRF at C = 16)
CASES += [(16, 4, 4, "branch1"), (16, 4, 5, "branch1")]
LAYOUTS = {"none": 0, "sw128": 1, "branch": 2, "branch1": 3}


def mma(n: int) -> str:
    """wgmma m64n{n}k16, both operands through descriptors, d += A B."""
    regs = ", ".join(f"%{i}" for i in range(n // 2))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(n // 2))
    return f"""
__device__ __forceinline__ void mma_n{n}(float (&d)[{n // 2}], uint64_t da,
                                         uint64_t db) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n // 2 + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs}}}, %{n // 2}, %{n // 2 + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {outs}
      : "l"(da), "l"(db), "r"(1));
}}
"""


def kernel(n: int, w: int, u: int, lay: int) -> str:
    """One case: W warpgroups, each with U accumulators of 64 x n; A: W x U
    tiles of 64 rows x 64 k (8 KB each), B: n rows x 64 k."""
    sw = lay == 1
    test = "if (v * 64 >= rows) continue;" if lay >= 2 else ""
    ksteps = 1 if lay == 3 else 4
    if sw:      # rows of 128 bytes, 8-row groups 1024 bytes apart
        da = "sdesc(at + 32 * ks, 16, 1024, kSwizzle128)"
        db = "sdesc(b + 32 * ks, 16, 1024, kSwizzle128)"
    else:       # [8 k groups][rows][8]
        da = "sdesc(at + 2 * ks * 64 * 16, 64 * 16, 128, kNoSwizzle)"
        db = f"sdesc(b + 2 * ks * {n} * 16, {n} * 16, 128, kNoSwizzle)"
    return f"""
__global__ void __launch_bounds__({128 * w}, 1)
rate_{n}_{w}_{u}_{lay}(float* out, int iters, int rows) {{
  extern __shared__ __align__(1024) unsigned char sm[];
  unsigned char* a = sm;
  unsigned char* b = sm + {w * u * 8192};
  const int tid = threadIdx.x, wg = tid / 128;
  for (int i = tid * 4; i < {w * u * 8192 + n * 128}; i += {128 * w * 4})
    *reinterpret_cast<uint32_t*>(sm + i) =   // finite bf16 pairs
        0x3C003C00u | ((i * 2654435761u) & 0x007F007Fu);
  fence_proxy_async();
  __syncthreads();
  float acc[{u}][{n // 2}];
#pragma unroll
  for (int v = 0; v < {u}; ++v)
#pragma unroll
    for (int i = 0; i < {n // 2}; ++i) acc[v][i] = 0.f;
  wg_fence();
  for (int it = 0; it < iters; ++it) {{
#pragma unroll
    for (int v = 0; v < {u}; ++v) {{
      {test}
      const unsigned char* at = a + (wg * {u} + v) * 8192;
#pragma unroll
      for (int ks = 0; ks < {ksteps}; ++ks) mma_n{n}(acc[v], {da}, {db});
    }}
    wg_commit();
    wg_wait<1>();
  }}
  wg_wait<0>();
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < {u}; ++v) {{
    reg_fence(acc[v]);
#pragma unroll
    for (int i = 0; i < {n // 2}; ++i) s += acc[v][i];
  }}
  out[blockIdx.x * blockDim.x + tid] = s;
}}
"""


def source() -> str:
    src = "\n".join(['#include <cuda_runtime.h>', '#include <stdint.h>',
                     f'#include "{kernels.CSRC / "sm90.cuh"}"',
                     "using namespace sm90;"])
    src += "".join(mma(n) for n in sorted({c[0] for c in CASES}))
    src += "".join(kernel(n, w, u, LAYOUTS[lay]) for n, w, u, lay in CASES)
    src += """
extern "C" int run(int n, int w, int u, int sw, int iters, float* out,
                   float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  int err = -1;
"""
    for n, w, u, lay in CASES:
        sw = LAYOUTS[lay]
        k = f"rate_{n}_{w}_{u}_{sw}"
        src += f"""  if (n == {n} && w == {w} && u == {u} && sw == {sw}) {{
    const int bytes = {w * u * 8192 + n * 128};
    cudaFuncSetAttribute({k}, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    {k}<<<132, {128 * w}, bytes>>>(out, 2, 1 << 20);
    cudaEventRecord(e0);
    {k}<<<132, {128 * w}, bytes>>>(out, iters, 1 << 20);
    cudaEventRecord(e1);
    err = cudaEventSynchronize(e1);
    if (err == 0) err = cudaGetLastError();
  }}
"""
    src += """  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return err;
}
"""
    return src


def build() -> ctypes.CDLL:
    src = source()
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD_DIR / f"exp_wgmma_rate-{tag}.cu"
    lib = cu.with_suffix(".so")
    if not lib.exists():
        cu.write_text(src)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                        str(lib), str(cu)], check=True)
    so = ctypes.CDLL(str(lib))
    so.run.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_wgmma_rate: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    print(f"SM clock at most {clock_hz / 1e6:.0f} MHz")
    so = build()
    out = torch.empty(132 * 512, device="cuda")
    ms = ctypes.c_float()
    for n, w, u, lay in CASES:
        err = so.run(n, w, u, LAYOUTS[lay], args.iters,
                     ctypes.c_void_p(out.data_ptr()), ctypes.byref(ms))
        if err:
            raise RuntimeError(f"n={n} W={w} U={u} {lay}: CUDA error {err}")
        count = (132 * w * u * args.iters         # wgmmas
                 * (1 if lay == "branch1" else 4))
        flops = 2.0 * 64 * n * 16 * count
        secs = ms.value / 1e3
        print(f"m64n{n}k16 {lay:6s} W={w} U={u}: {ms.value:.4f} ms  "
              f"{flops / secs / 1e12:.1f} TFLOP/s "
              f"({100 * flops / secs / BF16_PEAK:.1f}% of peak)  "
              f"{secs * clock_hz * 132 / count:.1f} SM cycles per wgmma")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
