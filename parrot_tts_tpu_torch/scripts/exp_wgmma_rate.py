"""The bf16, tf32 and s8 wgmma rates on the card by the wgmma's n, the
number of warpgroups and where the operands come from.

    python -m parrot_tts_tpu_torch.scripts.exp_wgmma_rate [--iters N]
        [--only bf16|tf32|s8] [--list]

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
one k-step per unit, as the fused MRF at C = 16. The tf32 cases are row
6's float32 mode (`mrf_kernel`, 3xTF32): m64nNk8 with N = 8, 16, 32 and
64, three products per unit and step (lo_a hi_b, hi_a lo_b, hi_a hi_b,
each into the unit's accumulator), B K-major without swizzle in shared
memory, A either from registers ("rs": one commit group per step, all
units; "rs1": one commit group per unit, a wgmma fence before it and a
wait for all but the last group after it, as the kernel issues them) or
from shared memory ("ss", both operands through descriptors). Printed per
case: ms (CUDA events), TFLOP/s against the peak of its type (989 bf16,
494.7 tf32), and SM cycles per wgmma (at the card's maximum SM clock).
The s8 cases are row 7's (`csrc/int8_conv.cu`): m64nNk32 with N = 16,
32, 64, 128 and 256, both operands K-major in shared memory (A as the
conv's unswizzled slab, B as its weights in the 128-byte swizzle), 4
k-steps per unit and step, TOP/s against 1,979. `--only` runs one type's
cases; `--list` prints the cases and measures nothing (no card needed).
The source is written and built under build/ at run time.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess

import torch

from parrot_tts_tpu_torch.core import kernels

BF16_PEAK = 989e12
TF32_PEAK = 494.7e12
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
# tf32 m64nNk8, three products per unit and step (row 6's float32 mode)
CASES += [(n, w, u, form) for form in ("rs1", "rs", "ss")
          for n, us in ((8, (4,)), (16, (4,)), (32, (4,)), (64, (2, 3)))
          for w in (2, 3, 4) for u in us]
# s8 m64nNk32, both operands from shared memory (row 7)
CASES += [(n, w, min(4, 256 // n), "s8") for n in (16, 32, 64, 128, 256)
          for w in (1, 2)]
LAYOUTS = {"none": 0, "sw128": 1, "branch": 2, "branch1": 3, "rs1": 4,
           "rs": 5, "ss": 6, "s8": 7}
TF32 = ("rs1", "rs", "ss")
INT8_PEAK = 1979e12


def kind(lay: str) -> str:
    return "s8" if lay == "s8" else "tf32" if lay in TF32 else "bf16"


def kernel_s8(n: int, w: int, u: int) -> str:
    """One s8 case: W warpgroups, each with U int32 accumulators of 64 x n;
    A: W x U tiles of 64 rows x 128 bytes of K as [8 k groups][64 rows][16
    bytes] (row 7's slab), B: n rows x 128 bytes in the 128-byte swizzle
    (row 7's weights), 4 k-steps of 32 bytes a step."""
    return f"""
__global__ void __launch_bounds__({128 * w}, 1)
rate_{n}_{w}_{u}_7(float* out, int iters, int rows) {{
  extern __shared__ __align__(1024) unsigned char sm[];
  unsigned char* b = sm;
  unsigned char* a = sm + {n * 128};
  const int tid = threadIdx.x, wg = tid / 128;
  for (int i = tid * 4; i < {w * u * 8192 + n * 128}; i += {128 * w * 4})
    *reinterpret_cast<uint32_t*>(sm + i) = i * 2654435761u;
  fence_proxy_async();
  __syncthreads();
  int acc[{u}][{n // 2}];
#pragma unroll
  for (int v = 0; v < {u}; ++v)
#pragma unroll
    for (int i = 0; i < {n // 2}; ++i) acc[v][i] = 0;
  wg_fence();
  for (int it = 0; it < iters; ++it) {{
#pragma unroll
    for (int v = 0; v < {u}; ++v) {{
      const unsigned char* at = a + (wg * {u} + v) * 8192;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_s8<{n}>(acc[v], sdesc(at + 2 * ks * 64 * 16, 64 * 16, 128,
                                    kNoSwizzle),
                      sdesc(b + 32 * ks, 16, 1024, kSwizzle128));
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


def mma_tf32(n: int) -> str:
    """wgmma m64n{n}k8 tf32, d += A B: A from registers (mma_r) or through
    a descriptor (mma_s), B through a descriptor."""
    regs = ", ".join(f"%{i}" for i in range(n // 2))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(n // 2))
    h = n // 2
    return f"""
__device__ __forceinline__ void mma_r{n}(float (&d)[{h}],
                                        const uint32_t (&a)[4], uint64_t db) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{h + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
      "{{{regs}}}, {{%{h}, %{h + 1}, %{h + 2}, %{h + 3}}}, %{h + 4}, p, 1, 1;"
      "\\n}}\\n"
      : {outs}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}}
__device__ __forceinline__ void mma_s{n}(float (&d)[{h}], uint64_t da,
                                        uint64_t db) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{h + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
      "{{{regs}}}, %{h}, %{h + 1}, p, 1, 1;\\n}}\\n"
      : {outs}
      : "l"(da), "l"(db), "r"(1));
}}
"""


def kernel_tf32(n: int, w: int, u: int, form: str) -> str:
    """One tf32 case: W warpgroups, each with U accumulators of 64 x n; A
    hi and lo (registers, or 2 KB planes per unit), B hi and lo (n x 8
    each, K-major no-swizzle: two 16-byte k groups n * 16 bytes apart)."""
    lay = LAYOUTS[form]
    a_bytes = w * u * 2 * 2048
    b_bytes = 2 * n * 32
    if form == "ss":
        prods = f"""      const uint32_t at =
          smem_u32(sm) + (wg * {u} + v) * 4096;
      mma_s{n}(acc[v], sdesc_u(at + 2048), dh);
      mma_s{n}(acc[v], sdesc_u(at), dl);
      mma_s{n}(acc[v], sdesc_u(at), dh);"""
    else:
        prods = f"""      mma_r{n}(acc[v], al[v], dh);
      mma_r{n}(acc[v], ah[v], dl);
      mma_r{n}(acc[v], ah[v], dh);"""
    if form == "rs1":
        body = f"""#pragma unroll
    for (int v = 0; v < {u}; ++v) {{
      wg_fence();
{prods}
      wg_commit();
      wg_wait<1>();
    }}"""
    else:
        body = f"""#pragma unroll
    for (int v = 0; v < {u}; ++v) {{
{prods}
    }}
    wg_commit();
    wg_wait<1>();"""
    return f"""
__global__ void __launch_bounds__({128 * w}, 1)
rate_{n}_{w}_{u}_{lay}(float* out, int iters, int rows) {{
  extern __shared__ __align__(1024) unsigned char sm[];
  const int tid = threadIdx.x, wg = tid / 128;
  for (int i = tid * 4; i < {a_bytes + b_bytes}; i += {128 * w * 4})
    *reinterpret_cast<float*>(sm + i) = 1.0f + (i % 97) * 0.0078125f;
  fence_proxy_async();
  __syncthreads();
  auto sdesc_u = [](uint32_t a) {{
    return desc_hi(128, 256) | (a >> 4);   // [2][8 rows][4]: lbo 128, sbo 256
  }};
  const uint32_t bs = smem_u32(sm + {a_bytes});
  const uint64_t dh = desc_hi({n} * 16, 128) | (bs >> 4);
  const uint64_t dl = desc_hi({n} * 16, 128) | ((bs + {n * 32}) >> 4);
  uint32_t ah[{u}][4], al[{u}][4];
#pragma unroll
  for (int v = 0; v < {u}; ++v)
#pragma unroll
    for (int i = 0; i < 4; ++i) {{
      ah[v][i] = __float_as_uint(1.0f + 0.125f * (tid % 7) + v);
      al[v][i] = __float_as_uint(0.0009765625f * (i + 1));
    }}
  float acc[{u}][{n // 2}];
#pragma unroll
  for (int v = 0; v < {u}; ++v)
#pragma unroll
    for (int i = 0; i < {n // 2}; ++i) acc[v][i] = 0.f;
  wg_fence();
  for (int it = 0; it < iters; ++it) {{
    {body}
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
    src += "".join(mma(n) for n in sorted({c[0] for c in CASES
                                           if kind(c[3]) == "bf16"}))
    src += "".join(mma_tf32(n) for n in sorted({c[0] for c in CASES
                                                if c[3] in TF32}))
    src += "".join(kernel_s8(n, w, u) if lay == "s8"
                   else kernel_tf32(n, w, u, lay) if lay in TF32
                   else kernel(n, w, u, LAYOUTS[lay])
                   for n, w, u, lay in CASES)
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
        nbytes = (w * u * 4096 + n * 64 if lay in TF32
                  else w * u * 8192 + n * 128)   # s8: as bf16
        src += f"""  if (n == {n} && w == {w} && u == {u} && sw == {sw}) {{
    const int bytes = {nbytes};
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


def label(n: int, w: int, u: int, lay: str) -> str:
    k = {"s8": 32, "tf32": 8, "bf16": 16}[kind(lay)]
    return f"m64n{n}k{k} {kind(lay)} {lay:6s} W={w} U={u}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--only", choices=("bf16", "tf32", "s8"), default=None,
                    help="run only this type's cases")
    ap.add_argument("--list", action="store_true",
                    help="print the cases; measure nothing")
    args = ap.parse_args(argv)
    cases = [c for c in CASES if args.only in (None, kind(c[3]))]
    if args.list:
        for case in cases:
            print(f"{label(*case)}: not measured")
        return 0
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
    for n, w, u, lay in cases:
        err = so.run(n, w, u, LAYOUTS[lay], args.iters,
                     ctypes.c_void_p(out.data_ptr()), ctypes.byref(ms))
        if err:
            raise RuntimeError(f"n={n} W={w} U={u} {lay}: CUDA error {err}")
        tf32 = lay in TF32
        count = (132 * w * u * args.iters         # wgmmas
                 * (1 if lay == "branch1" else 3 if tf32 else 4))
        depth = 32 if lay == "s8" else 8 if tf32 else 16
        flops = 2.0 * 64 * n * depth * count
        secs = ms.value / 1e3
        peak = {"s8": INT8_PEAK, "tf32": TF32_PEAK,
                "bf16": BF16_PEAK}[kind(lay)]
        unit = "TOP/s" if lay == "s8" else "TFLOP/s"
        print(f"{label(n, w, u, lay)}: {ms.value:.4f} ms  "
              f"{flops / secs / 1e12:.1f} {unit} "
              f"({100 * flops / secs / peak:.1f}% of peak)  "
              f"{secs * clock_hz * 132 / count:.1f} SM cycles per wgmma")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
