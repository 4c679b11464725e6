// float32 products on the TF32 tensor cores with a 3xTF32 split, shared by
// the serving attention (flash_attn_fwd.cu: the split pre-pass, and wgmma
// m64nNk8 with Q and P split in registers) and the fused MRF stage
// (fused_mrf.cu: wgmma m64nNk8, sm_90a), and the serving attention's
// 1-pass TF32 rounding (round_tf32) and wgmma products (A from registers
// or shared memory). Header-only; core/kernels.py hashes it with every
// source that includes it.
//
// Each float32 operand x is split exactly as x = hi + lo (Veltkamp: hi is x
// rounded to 11 significant bits, a TF32 value), and a * b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b (the small terms first). The dropped
// lo_a lo_b and the bits of lo that TF32 drops (the tensor cores read a
// float32 operand's top 19 bits, lo's top 11 significant ones) leave each
// product within ~5 * 2^-22 of its float32 value. The tensor cores' float32
// sums do not round to nearest, so a long sum there drifts: callers sum
// only short partials from zero on the tensor cores (at most 32 of the
// contraction) and add them in IEEE float32.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4), the layout of a
// wgmma's A operand from registers (each warp's 16 rows of the 64) and of
// its accumulator (repeated over n / 8 column blocks): A (16 x 8) a0
// (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); C (16 x 8) c0,
// c1 (g, 2t and 2t + 1), c2, c3 (g + 8, the same columns). The fused MRF
// permutes k inside each 8-wide step (logical t <-> element 2t, t + 4 <->
// 2t + 1), so an A fragment is two float2 loads; the attention's P V takes
// its keys in that order, so P's A fragment is S's accumulator fragment.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x = hi + lo exactly (Veltkamp's split, 4 float32 operations; __*_rn
// so the compiler neither contracts nor reassociates them): hi is x rounded
// to the nearest value of 11 significant bits, a TF32 value; lo keeps the
// other 13, of which the tensor cores read the top 11
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.0f);   // 2^13 + 1
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// x rounded to TF32 (11 significant bits), to nearest, ties away from zero:
// the 1-pass operand, as ops/precision.py::round_tf32 rounds it in the
// bits the tensor cores read
__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// an A fragment split once for the products it takes part in
struct SplitA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2,
                                          float a3) {
  SplitA r;
  split(a0, r.hi[0], r.lo[0]);
  split(a1, r.hi[1], r.lo[1]);
  split(a2, r.hi[2], r.lo[2]);
  split(a3, r.hi[3], r.lo[3]);
  return r;
}

// ---- wgmma m64nNk8 tf32 with A from registers ------------------------------
// d (64 x N, N/2 per thread) = A B + (accumulate ? d : 0). A is this warp's
// 16 rows of the warpgroup's 64, as the m16n8k8 A fragment above; B (N x 8,
// K-major) through the shared-memory descriptor db. The accumulator layout
// is the m16n8k8 C fragment repeated over N / 8 column blocks: element i is
// row g + 8 * ((i % 4) / 2), column 8 * (i / 4) + 2t + i % 2 of the warp's
// rows. The registers of a and d belong to the asynchronous product until a
// wgmma wait covers it (sm90.cuh: wg_fence, wg_commit, wg_wait, reg_fence).

__device__ __forceinline__ void wgmma_tf32(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// ---- wgmma m64n32k8 tf32 with A in shared memory ---------------------------
// d (64 x 32) = A B + (accumulate ? d : 0), A (64 x 8) and B (32 x 8) both
// K-major through the descriptors da and db (the only form TF32 takes: no
// transpose), the accumulator laid out as above

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// 16 bytes from global to shared memory, asynchronously (zero-filled when
// !ok, src then only has to be a valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

}  // namespace tf32x3
