// One whole MRF stage of the HiFi-GAN vocoder in one kernel, for Hopper
// (sm_90a): float32 convolutions on the TF32 tensor cores with a 3xTF32
// split (wgmma m64nNk8, A from registers; csrc/tf32x3.cuh).
//
// Replaces: parrot_tts_tpu/ops/fused_mrf.py::_mrf_kernel (driven by
// mrf_fused, fused_mrf.py:115-193). For x (B, T, C) float32 it computes
//     out = mean over branches br of y_br, where y = x and, for each
//     (dilated, plain) conv pair of the branch (kernel size k, dilation d),
//         t = valid * (conv_d(leaky(y)) + b1)
//         t = valid * (conv_1(leaky(t)) + b2)
//         y = y + t
// with leaky(v) = max(v, 0.1 v), 'same' zero padding, and valid = 1 on the
// rows of [0, T), 0 elsewhere: rows outside the sequence are re-zeroed after
// every conv, so the biases never leak in from the sequence ends. At V1 a
// stage is 3 branches (k = 3, 7, 11) x 3 pairs (d = 1, 3, 5): 18 convs.
//
// Bound on this card: 2 * sum(K) * C^2 = 252 C^2 operations per sample
// against the input and output (8 C bytes per sample) and the stage's
// 126 C^2 weights. Taken as 3xTF32 products on the tensor cores (3x the
// operations at 494.7 TFLOP/s) or as float32 FMAs on the CUDA cores (67
// TFLOP/s), the operations take 10-100x as long as the bytes at C = 16-64:
// the products bound the kernel.
//
// Numerics: every product is 3xTF32 (tf32x3.cuh): within ~5 * 2^-22 of its
// float32 value. The tensor cores sum one weight slab's products (one tap,
// KC input channels: KC / 8 k-steps, 3 wgmma each) from zero; IEEE float32
// adds each such partial to the running sum, which starts at the bias.
// chip_smoke.py phase 5 holds the stage to 1e-5 of max |plain| against its
// IEEE float32 plain version; plain TF32 (one product of hi parts, ~2^-11)
// would not hold it.
//
// The design. A block (one per SM) owns tb output rows of one batch row and
// computes the stage on a strip of L = tb + 2 * halo rows in shared memory,
// where halo is the longest branch's one-sided receptive field in samples
// (60 at V1: 5 + 15 + 25 for the k = 11 dilated convs, 3 x 5 for the plain
// ones). Each conv is computed only on the rows that later convs still
// need, so the recompute shrinks conv by conv to exactly tb rows at the
// branch's end. Two strips: Y (the branch state) and LT (leaky of the
// dilated conv's output); leaky(Y) is taken as the A fragment is loaded.
// Rows are padded to S = C + 8 (C + 16 when C is an odd multiple of 8)
// floats, so the float2 A-fragment loads of a half warp hit 32 banks.
//
// Each conv is an implicit GEMM: strip rows x C outputs, reducing over taps
// x C inputs. A dilated tap is a row shift of the same strip: each warp
// loads its A fragment (16 rows x 8 inputs) at a row offset of tap * dil -
// pad, splits it in registers (hi, lo) and hands it to wgmma, so any shift
// works. The weights come pre-split on the host (ops/fused_mrf.py::
// kernel_weights: TF32 hi and lo halves, each K-major [KC / 4][C][4], the
// no-swizzle layout the B descriptor reads, inputs ordered as the A
// fragment's k) and stream through a ring of NS = 2 shared-memory slots by
// cp.async: one slab (one tap, KC = min(n, 32) inputs, both halves) lands
// while the previous one multiplies; one barrier per slab; slabs run in the
// stage's order across conv and branch boundaries. A warpgroup's unit is
// 64 rows x C outputs (C / n wgmmas of m64nNk8 per k-step, n = 64 at C =
// 64, else the widest of 32, 16, 8 dividing C), each product lo_a hi_b +
// hi_a lo_b + hi_a hi_b; it holds up to R units' sums in registers through
// a conv. A round (one unit per warpgroup) runs while its first unit has
// rows, a test the whole block agrees on: ptxas serializes wgmmas on a
// divergent path.
//
// Tiles (ops/fused_mrf.py::tile_plan chooses tb and passes it; the launch
// checks it): 4 warpgroups x R = 5 units at C = 8 and 16, 3 x 4 at 32, 2 x 3
// at 64, 2 x 2 at the runtime widths; the strips and ring fill the SM's
// 227 KB. At V1 (halo 60) the largest tiles with the least work per row:
// C = 64 tb 224 (rows computed, in whole rounds, over 18 tb: 1.40), C = 32
// tb 496 (1.20), C = 16 tb 944 (1.11); a launch takes the tb with the
// least waves x rows.
//
// The branch mean accumulates in the output, which each thread owns for its
// rows, in branch order (no atomics: deterministic). The ragged last tile
// is masked; any T works.
//
// The bfloat16 mode (mrf_kernel_bf16; the bf16 vocoder's fused stages, C =
// 16, 32 or 64) follows the JAX kernel's rounding points in bf16
// (_mrf_kernel with a bf16 strip, fused_mrf.py:97-152): every conv sums its
// bf16 products in float32 from its bf16 bias and rounds the sum to bf16
// once (_strip_conv); the validity mask, the leaky ReLU (slope bf16(0.1))
// and y + t are taken in bf16, each rounded to nearest even; the branches
// are summed in float32 and the sum times 1 / n_branch is rounded to bf16
// at the store. Its products are bf16 wgmma m64nCk16 (one product per
// k-step, no split), A from registers with leaky(Y) taken at the load in
// bf16, B a K-major bf16 slab of one tap's C input channels (ops/
// fused_mrf.py::kernel_weights of the bf16 weights: [C / 8][C][8], the
// inputs of every 16 in the order of the A fragment's k, so a thread's four
// values are one 8-byte load). The strips hold bf16 (half the bytes of a
// float32 row; stride C + 16, or C when C is an odd multiple of 16, so a
// half warp's 8-byte loads hit 32 banks), and the branch sum sits in a
// float32 strip of tb rows; the tiles follow from that (ops/fused_mrf.py::
// tile_plan(..., dtype=torch.bfloat16)). Bound: the same operations on the
// bf16 tensor cores (989 TFLOP/s), against 4 C bytes per sample.
//
// Interface (plain C, loaded with ctypes):
//   int fused_mrf_f32(x, wk, bias, out, B, T, C, n_branch, kernel_sizes,
//                     n_pairs, dilations, halo, tb, stream)
// x, out: contiguous (B, T, C) float32, 16-byte aligned; wk: the weight
// stream of kernel_weights (2 * sum over convs of K * C * C floats),
// 16-byte aligned; bias: the convs' (C,) biases in pack_mrf's order
// (branch, pair, dilated then plain). kernel_sizes, n_pairs: n_branch ints
// on the host; dilations: n_branch x 4 ints on the host. C must be a
// multiple of 8 up to 120. Returns the CUDA error code of the launch
// (cudaErrorInvalidValue for a plan the kernel does not take).
//   int fused_mrf_bf16(x, wk, bias, out, B, T, C, n_branch, kernel_sizes,
//                      n_pairs, dilations, halo, tb, stream)
// the same in bfloat16: x, out (B, T, C), wk (sum over convs of K * C * C)
// and bias bf16, x and wk 16-byte aligned; C 16, 32 or 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;
using sm90::fence_proxy_async;
using sm90::kNoSwizzle;
using sm90::reg_fence;
using sm90::sdesc;
using sm90::wg_commit;
using sm90::wg_fence;
using sm90::wg_wait;

constexpr int MAXB = 4;         // branches
constexpr int MAXP = 4;         // pairs per branch
constexpr int NS = 2;           // weight ring slots
constexpr int UNIT_ROWS = 64;   // rows of a warpgroup's unit (the wgmma m)
constexpr int MAX_C = 120;      // the runtime-C instantiations' widest
constexpr int SMEM_MAX = 232448;
constexpr float SLOPE = 0.1f;

struct Plan {
  int nb;
  int k[MAXB];
  int np[MAXB];
  int d[MAXB][MAXP];
  int halo;
  int tb;
};

// the wgmma n of a width: 64 at C = 64, else the widest of 32, 16, 8 that
// divides C; the slab's input channels, KC = min(n, 32)
__host__ __device__ constexpr int wg_n(int c) {
  return c == 64 ? 64 : c % 32 == 0 ? 32 : c % 16 == 0 ? 16 : 8;
}

__host__ __device__ constexpr int k_chunk(int n) { return n < 32 ? n : 32; }

// warpgroups per block: one warpgroup's wait for its products leaves the
// tensor cores idle unless others interleave, so as many as the registers
// allow: four at C = 8 and 16, three at C = 32, two at C = 64 and the
// runtime widths (their accumulators need the registers)
__host__ __device__ constexpr int warpgroups(int ct) {
  return ct == 8 || ct == 16 ? 4 : ct == 32 ? 3 : 2;
}

// 64 x C units a warpgroup holds through a conv (enough for the longest
// strip that fits): 5 at C = 8 and 16, 4 at C = 32, 3 at C = 64 (96
// accumulator registers), 2 at the runtime widths (up to 120 channels)
__host__ __device__ constexpr int rounds(int ct) {
  return ct == 8 || ct == 16 ? 5 : ct == 32 ? 4 : ct == 64 ? 3 : 2;
}

__host__ __device__ __forceinline__ int strip_stride(int c) {
  return c % 16 == 0 ? c + 8 : c + 16;
}

__device__ __forceinline__ float leaky(float v) { return fmaxf(v, SLOPE * v); }

template <int CT, int N>
__global__ void __launch_bounds__(128 * warpgroups(CT), 1)
mrf_kernel(const float* __restrict__ x, const float* __restrict__ wk,
           const float* __restrict__ bias, float* __restrict__ out, int T,
           int c_arg, const __grid_constant__ Plan plan) {
  constexpr int KC = k_chunk(N);       // input channels per slab
  constexpr int KS = KC / 8;           // k-steps per slab
  constexpr int NGM = (CT ? CT : MAX_C) / N;   // n tiles held
  constexpr int NWG = warpgroups(CT);
  constexpr int THREADS = 128 * NWG;
  constexpr int R = rounds(CT);
  const int C = CT ? CT : c_arg;
  const int NG = C / N;
  const int S = strip_stride(C);
  const int H = plan.halo, tb = plan.tb, L = tb + 2 * H;
  const int NCH = C / KC;
  const int slab = 2 * KC * C;          // floats: the hi and lo halves
  extern __shared__ __align__(128) float sm[];
  float* ring = sm;                     // NS weight slabs
  float* Y = ring + NS * slab;          // the branch state y
  float* LT = Y + L * S;                // leaky(dilated conv output)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;   // warpgroup, warp in it
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * tb - H;   // sequence row of strip row 0
  const float* xb = x + static_cast<size_t>(b) * T * C;
  float* ob = out + static_cast<size_t>(b) * T * C;
  const int c4 = C / 4;

  // every slab has the same size, so slab s of the stream is at s * slab
  int n_slabs = 0;
  for (int br = 0; br < plan.nb; ++br)
    n_slabs += 2 * plan.np[br] * plan.k[br] * NCH;
  auto issue = [&](int s) {
    if (s < n_slabs) {
      const float* src = wk + static_cast<size_t>(s) * slab;
      float* dst = ring + (s % NS) * slab;
      for (int idx = tid; idx < slab / 4; idx += THREADS)
        cp_async16(dst + 4 * idx, src + 4 * idx, true);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);

  float acc[R][NGM][N / 2];
  int s = 0;          // slab index
  int boff = 0;       // bias offset of the current conv
  for (int br = 0; br < plan.nb; ++br) {
    const int K = plan.k[br];
    int rem = 0;
    for (int p = 0; p < plan.np[br]; ++p)
      rem += (K - 1) * plan.d[br][p] / 2 + (K - 1) / 2;

    // the rows this branch needs, [H - rem, H + tb + rem), from x (zero
    // outside [0, T)); the barrier first: the previous branch's last conv
    // may still be updating Y
    __syncthreads();
    {
      const int lo = H - rem, n = tb + 2 * rem;
      for (int idx = tid; idx < n * c4; idx += THREADS) {
        const int r = lo + idx / c4, q = idx % c4;
        const int tt = g0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (tt >= 0 && tt < T)
          v = __ldg(reinterpret_cast<const float4*>(
                        xb + static_cast<size_t>(tt) * C) + q);
        *reinterpret_cast<float4*>(Y + r * S + 4 * q) = v;
      }
    }

    for (int p = 0; p < plan.np[br]; ++p) {
      const int d = plan.d[br][p];
      const int p1 = (K - 1) * d / 2, p2 = (K - 1) / 2;
#pragma unroll 1
      for (int cv = 0; cv < 2; ++cv) {
        const int dil = cv ? 1 : d, pad = cv ? p2 : p1;
        if (cv) rem -= p1 + p2;
        const int lo = cv ? H - rem : H - rem + p1;
        const int hi = cv ? H + tb + rem : H + tb + rem - p1;
        const float* src = cv ? LT : Y;
        // every unit's sum starts at the bias
#pragma unroll
        for (int ng = 0; ng < NGM; ++ng)
#pragma unroll
          for (int i = 0; i < N / 2; i += 2) {
            const int co = ng * N + 8 * (i / 4) + 2 * t;
            const float b0 = ng < NG ? __ldg(bias + boff + co) : 0.f;
            const float b1 = ng < NG ? __ldg(bias + boff + co + 1) : 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r][ng][i] = b0;
              acc[r][ng][i + 1] = b1;
            }
          }
        for (int tap = 0; tap < K; ++tap) {
          const int shift = tap * dil - pad;
          for (int ch = 0; ch < NCH; ++ch, ++s) {
            cp_async_wait<NS - 2>();   // this thread's copies of slab s
            fence_proxy_async();       // visible to the tensor cores' reads
            __syncthreads();           // everyone's; slot s - 1 is free
            issue(s + NS - 1);
            const float* ws = ring + (s % NS) * slab;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              // a round runs while its first unit has rows: a test the
              // whole block agrees on, so the wgmmas are on no divergent
              // path (ptxas serializes them there); the second warpgroup's
              // unit past hi computes on the clamped last row, unstored
              if (lo + r * NWG * UNIT_ROWS >= hi) continue;
              const int m0 = lo + (wg + r * NWG) * UNIT_ROWS;
              // this warp's 16 rows (ragged rows read the last row)
              const int ra = min(m0 + 16 * wl + g, hi - 1);
              const int rb = min(m0 + 16 * wl + g + 8, hi - 1);
              const float* pa = src + (ra + shift) * S + ch * KC + 2 * t;
              const float* pb = src + (rb + shift) * S + ch * KC + 2 * t;
              SplitA a[KS];
#pragma unroll
              for (int ks = 0; ks < KS; ++ks) {
                float2 x0 = *reinterpret_cast<const float2*>(pa + 8 * ks);
                float2 x1 = *reinterpret_cast<const float2*>(pb + 8 * ks);
                if (cv == 0) {
                  x0 = make_float2(leaky(x0.x), leaky(x0.y));
                  x1 = make_float2(leaky(x1.x), leaky(x1.y));
                }
                a[ks] = split_a(x0.x, x1.x, x0.y, x1.y);
              }
#pragma unroll
              for (int ng = 0; ng < NGM; ++ng) {
                if (ng >= NG) break;
                float part[N / 2];
                wg_fence();
#pragma unroll
                for (int ks = 0; ks < KS; ++ks) {
                  // k-step ks: 16-byte k groups 2ks, 2ks + 1 of the slab's
                  // [KC / 4][C][4] halves; n tile ng starts ng * N rows down
                  const float* wh = ws + (2 * ks * C + ng * N) * 4;
                  const uint64_t dh = sdesc(wh, C * 16, 128, kNoSwizzle);
                  const uint64_t dl = sdesc(wh + KC * C, C * 16, 128,
                                            kNoSwizzle);
                  wgmma_tf32(part, a[ks].lo, dh, ks > 0);
                  wgmma_tf32(part, a[ks].hi, dl, 1);
                  wgmma_tf32(part, a[ks].hi, dh, 1);
                }
                wg_commit();
                wg_wait<0>();
                reg_fence(part);
#pragma unroll
                for (int i = 0; i < N / 2; ++i) acc[r][ng][i] += part[i];
              }
            }
          }
        }
        boff += C;

        // epilogue: the dilated conv stores leaky(t) in LT; the plain one
        // adds t to Y and, on the branch's last pair, folds y into out
        const bool last = cv == 1 && p == plan.np[br] - 1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int m0 = lo + (wg + r * NWG) * UNIT_ROWS;
          if (m0 >= hi) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + 16 * wl + 8 * h + g;
            if (row >= hi) continue;
            const int tt = g0 + row;
            const bool valid = tt >= 0 && tt < T;
#pragma unroll
            for (int ng = 0; ng < NGM; ++ng) {
              if (ng >= NG) break;
#pragma unroll
              for (int i = 2 * h; i < N / 2; i += 4) {
                const int co = ng * N + 8 * (i / 4) + 2 * t;
                const float v0 = valid ? acc[r][ng][i] : 0.f;
                const float v1 = valid ? acc[r][ng][i + 1] : 0.f;
                if (cv == 0) {
                  *reinterpret_cast<float2*>(LT + row * S + co) =
                      make_float2(leaky(v0), leaky(v1));
                } else {
                  float2* yp = reinterpret_cast<float2*>(Y + row * S + co);
                  float2 y = *yp;
                  y.x += v0;
                  y.y += v1;
                  *yp = y;
                  if (last && valid) {   // rows [H, H + tb) by construction
                    float2* o = reinterpret_cast<float2*>(
                        ob + static_cast<size_t>(tt) * C + co);
                    float2 m = y;
                    if (br > 0) {
                      const float2 prev = *o;
                      m.x = prev.x + y.x;
                      m.y = prev.y + y.y;
                    }
                    if (br == plan.nb - 1) {
                      m.x *= 1.0f / plan.nb;
                      m.y *= 1.0f / plan.nb;
                    }
                    *o = m;
                  }
                }
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- the bfloat16 mode ---------------------------------------------------

constexpr float SLOPE16 = 0.10009765625f;   // bf16(0.1)

// bf16 row stride (elements): C + 16, or C when C is an odd multiple of 16;
// a half warp's 8-byte loads of rows g..g+3 then start 32 bytes apart mod
// 128. The float32 branch-sum strip: C + 8 floats a row.
__host__ __device__ constexpr int strip_stride16(int c) {
  return c % 32 == 16 ? c : c + 16;
}
__host__ __device__ constexpr int sum_stride(int c) { return c + 8; }

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ __nv_bfloat16 rn(float v) {
  return __float2bfloat16_rn(v);
}
// leaky ReLU in bf16: max(v, bf16(SLOPE16 * v)), the product exact in float32
__device__ __forceinline__ __nv_bfloat16 leaky16(__nv_bfloat16 v) {
  const float f = bf(v);
  return rn(fmaxf(f, bf(rn(__fmul_rn(SLOPE16, f)))));
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ __nv_bfloat16 lo16(uint32_t u) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(u & 0xFFFF));
}
__device__ __forceinline__ __nv_bfloat16 hi16(uint32_t u) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
}
__device__ __forceinline__ uint32_t leaky2(uint32_t u) {
  return pack2(leaky16(lo16(u)), leaky16(hi16(u)));
}

// wgmma m64nNk16 bf16 with A from registers (the m16n8k16 A fragment: a0 (g,
// k 2t..2t+1), a1 (g + 8, same k), a2 (g, k 2t+8..2t+9), a3 (g + 8, same)),
// B K-major through the descriptor, float32 d = A B + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_bf16(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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

// one MRF stage in bf16 at C = CT (16, 32, 64): wgmma n = C, one slab per
// tap (all C inputs, C / 16 k-steps); the walk, tiles and barriers are
// mrf_kernel's
template <int CT>
__global__ void __launch_bounds__(128 * warpgroups(CT), 1)
mrf_kernel_bf16(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ wk,
                const __nv_bfloat16* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int T,
                const __grid_constant__ Plan plan) {
  constexpr int C = CT, N = CT;
  constexpr int KS = C / 16;           // k-steps per slab
  constexpr int NWG = warpgroups(CT);
  constexpr int THREADS = 128 * NWG;
  constexpr int R = rounds(CT);
  constexpr int S = strip_stride16(C);
  constexpr int SM = sum_stride(C);
  constexpr int slab = C * C;          // bf16 elements: one tap
  const int H = plan.halo, tb = plan.tb, L = tb + 2 * H;
  extern __shared__ __align__(128) unsigned char smem16[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* Y = ring + NS * slab;         // the branch state y
  __nv_bfloat16* LT = Y + L * S;               // leaky(dilated conv output)
  float* M = reinterpret_cast<float*>(LT + L * S);   // branch sum, tb rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * tb - H;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * T * C;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * T * C;
  constexpr int c8 = C / 8;            // 16-byte pieces of a row

  int n_slabs = 0;
  for (int br = 0; br < plan.nb; ++br) n_slabs += 2 * plan.np[br] * plan.k[br];
  auto issue = [&](int s) {
    if (s < n_slabs) {
      const __nv_bfloat16* src = wk + static_cast<size_t>(s) * slab;
      __nv_bfloat16* dst = ring + (s % NS) * slab;
      for (int idx = tid; idx < slab / 8; idx += THREADS)
        cp_async16(reinterpret_cast<float*>(dst + 8 * idx),
                   reinterpret_cast<const float*>(src + 8 * idx), true);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);

  float acc[R][N / 2];
  int s = 0;
  int boff = 0;
  for (int br = 0; br < plan.nb; ++br) {
    const int K = plan.k[br];
    int rem = 0;
    for (int p = 0; p < plan.np[br]; ++p)
      rem += (K - 1) * plan.d[br][p] / 2 + (K - 1) / 2;

    __syncthreads();
    {
      const int lo = H - rem, n = tb + 2 * rem;
      for (int idx = tid; idx < n * c8; idx += THREADS) {
        const int r = lo + idx / c8, q = idx % c8;
        const int tt = g0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (tt >= 0 && tt < T)
          v = __ldg(reinterpret_cast<const uint4*>(
                        xb + static_cast<size_t>(tt) * C) + q);
        *reinterpret_cast<uint4*>(Y + r * S + 8 * q) = v;
      }
    }

    for (int p = 0; p < plan.np[br]; ++p) {
      const int d = plan.d[br][p];
      const int p1 = (K - 1) * d / 2, p2 = (K - 1) / 2;
#pragma unroll 1
      for (int cv = 0; cv < 2; ++cv) {
        const int dil = cv ? 1 : d, pad = cv ? p2 : p1;
        if (cv) rem -= p1 + p2;
        const int lo = cv ? H - rem : H - rem + p1;
        const int hi = cv ? H + tb + rem : H + tb + rem - p1;
        const __nv_bfloat16* src = cv ? LT : Y;
        // every unit's sum starts at the bias (bf16, exact in float32)
#pragma unroll
        for (int i = 0; i < N / 2; i += 2) {
          const int co = 8 * (i / 4) + 2 * t;
          const float b0 = bf(bias[boff + co]);
          const float b1 = bf(bias[boff + co + 1]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][i] = b0;
            acc[r][i + 1] = b1;
          }
        }
        for (int tap = 0; tap < K; ++tap, ++s) {
          const int shift = tap * dil - pad;
          cp_async_wait<NS - 2>();
          fence_proxy_async();
          __syncthreads();
          issue(s + NS - 1);
          const __nv_bfloat16* ws = ring + (s % NS) * slab;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (lo + r * NWG * UNIT_ROWS >= hi) continue;
            const int m0 = lo + (wg + r * NWG) * UNIT_ROWS;
            const int ra = min(m0 + 16 * wl + g, hi - 1);
            const int rb = min(m0 + 16 * wl + g + 8, hi - 1);
            const __nv_bfloat16* pa = src + (ra + shift) * S + 4 * t;
            const __nv_bfloat16* pb = src + (rb + shift) * S + 4 * t;
            uint32_t a[KS][4];
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              // channels 16 ks + 4t .. 4t + 3: logical k 2t, 2t + 1 (a0,
              // a1) and 2t + 8, 2t + 9 (a2, a3) of the k-step
              uint2 x0 = *reinterpret_cast<const uint2*>(pa + 16 * ks);
              uint2 x1 = *reinterpret_cast<const uint2*>(pb + 16 * ks);
              if (cv == 0) {
                x0 = make_uint2(leaky2(x0.x), leaky2(x0.y));
                x1 = make_uint2(leaky2(x1.x), leaky2(x1.y));
              }
              a[ks][0] = x0.x;
              a[ks][1] = x1.x;
              a[ks][2] = x0.y;
              a[ks][3] = x1.y;
            }
            float part[N / 2];
            wg_fence();
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              // k-step ks: 16-byte k groups 2ks, 2ks + 1 of [C / 8][C][8]
              const uint64_t db =
                  sdesc(ws + 2 * ks * C * 8, C * 16, 128, kNoSwizzle);
              wgmma_bf16(part, a[ks], db, ks > 0);
            }
            wg_commit();
            wg_wait<0>();
            reg_fence(part);
#pragma unroll
            for (int i = 0; i < N / 2; ++i) acc[r][i] += part[i];
          }
        }
        boff += C;

        // epilogue: t = bf16(sum), zero outside [0, T); the dilated conv
        // stores leaky(t) in LT; the plain one sets y = bf16(y + t) and, on
        // the branch's last pair, adds y to the float32 sum, which the last
        // branch scales and stores
        const bool last = cv == 1 && p == plan.np[br] - 1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int m0 = lo + (wg + r * NWG) * UNIT_ROWS;
          if (m0 >= hi) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + 16 * wl + 8 * h + g;
            if (row >= hi) continue;
            const int tt = g0 + row;
            const bool valid = tt >= 0 && tt < T;
#pragma unroll
            for (int i = 2 * h; i < N / 2; i += 4) {
              const int co = 8 * (i / 4) + 2 * t;
              const __nv_bfloat16 v0 = rn(valid ? acc[r][i] : 0.f);
              const __nv_bfloat16 v1 = rn(valid ? acc[r][i + 1] : 0.f);
              uint32_t* yp = reinterpret_cast<uint32_t*>(
                  (cv ? Y : LT) + row * S + co);
              if (cv == 0) {
                *yp = pack2(leaky16(v0), leaky16(v1));
              } else {
                const uint32_t y = *yp;
                const __nv_bfloat16 y0 = rn(__fadd_rn(bf(lo16(y)), bf(v0)));
                const __nv_bfloat16 y1 = rn(__fadd_rn(bf(hi16(y)), bf(v1)));
                *yp = pack2(y0, y1);
                if (last && valid) {   // rows [H, H + tb) by construction
                  float2* mp = reinterpret_cast<float2*>(
                      M + (row - H) * SM + co);
                  float2 m = make_float2(bf(y0), bf(y1));
                  if (br > 0) {
                    const float2 prev = *mp;
                    m.x = __fadd_rn(prev.x, m.x);
                    m.y = __fadd_rn(prev.y, m.y);
                  }
                  if (br == plan.nb - 1) {
                    const float inv = 1.0f / plan.nb;
                    *reinterpret_cast<uint32_t*>(
                        ob + static_cast<size_t>(tt) * C + co) =
                        pack2(rn(__fmul_rn(m.x, inv)),
                              rn(__fmul_rn(m.y, inv)));
                  } else {
                    *mp = m;
                  }
                }
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

size_t smem_bytes_bf16(int tb, int halo, int C) {
  return 2 * (2 * static_cast<size_t>(tb + 2 * halo) * strip_stride16(C) +
              static_cast<size_t>(NS) * C * C) +
         4 * static_cast<size_t>(tb) * sum_stride(C);
}

template <int CT>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* wk,
                const __nv_bfloat16* bias, __nv_bfloat16* out, int B, int T,
                const Plan& plan, cudaStream_t stream) {
  const int rows = plan.tb + 2 * plan.halo;
  if ((rows + UNIT_ROWS - 1) / UNIT_ROWS > warpgroups(CT) * rounds(CT))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes_bf16(plan.tb, plan.halo, CT);
  cudaError_t err = cudaFuncSetAttribute(
      mrf_kernel_bf16<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + plan.tb - 1) / plan.tb, B);
  mrf_kernel_bf16<CT><<<grid, 128 * warpgroups(CT), bytes, stream>>>(
      x, wk, bias, out, T, plan);
  return static_cast<int>(cudaGetLastError());
}

// the plan of a launch from its host arrays (false: one the kernels do not
// take)
bool make_plan(Plan& plan, int n_branch, const int* kernel_sizes,
               const int* n_pairs, const int* dilations, int halo, int tb) {
  plan = Plan{};
  plan.nb = n_branch;
  plan.halo = halo;
  plan.tb = tb;
  for (int br = 0; br < n_branch; ++br) {
    if (n_pairs[br] < 1 || n_pairs[br] > MAXP || kernel_sizes[br] < 1)
      return false;
    plan.k[br] = kernel_sizes[br];
    plan.np[br] = n_pairs[br];
    int rem = 0;
    for (int p = 0; p < n_pairs[br]; ++p) {
      plan.d[br][p] = dilations[br * MAXP + p];
      rem += (plan.k[br] - 1) * plan.d[br][p] / 2 + (plan.k[br] - 1) / 2;
    }
    if (rem > halo) return false;
  }
  return true;
}

size_t smem_bytes(int tb, int halo, int C) {
  return sizeof(float) *
         (2 * static_cast<size_t>(tb + 2 * halo) * strip_stride(C) +
          static_cast<size_t>(NS) * 2 * k_chunk(wg_n(C)) * C);
}

template <int CT, int N>
int launch(const float* x, const float* wk, const float* bias, float* out,
           int B, int T, int C, const Plan& plan, cudaStream_t stream) {
  const int rows = plan.tb + 2 * plan.halo;
  if ((rows + UNIT_ROWS - 1) / UNIT_ROWS > warpgroups(CT) * rounds(CT))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(plan.tb, plan.halo, C);
  cudaError_t err = cudaFuncSetAttribute(
      mrf_kernel<CT, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + plan.tb - 1) / plan.tb, B);
  mrf_kernel<CT, N><<<grid, 128 * warpgroups(CT), bytes, stream>>>(
      x, wk, bias, out, T, C, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_mrf_f32(const float* x, const float* wk,
                             const float* bias, float* out, int B, int T,
                             int C, int n_branch, const int* kernel_sizes,
                             const int* n_pairs, const int* dilations,
                             int halo, int tb, void* stream) {
  if (n_branch < 1 || n_branch > MAXB || C % 8 != 0 || C < 8 || C > MAX_C ||
      tb < 16 || halo < 0 || B < 1 || B > 65535 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  if (!make_plan(plan, n_branch, kernel_sizes, n_pairs, dilations, halo, tb))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes(tb, halo, C) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return launch<64, 64>(x, wk, bias, out, B, T, C, plan, s);
    case 32: return launch<32, 32>(x, wk, bias, out, B, T, C, plan, s);
    case 16: return launch<16, 16>(x, wk, bias, out, B, T, C, plan, s);
    case 8: return launch<8, 8>(x, wk, bias, out, B, T, C, plan, s);
    default:
      switch (wg_n(C)) {
        case 32: return launch<0, 32>(x, wk, bias, out, B, T, C, plan, s);
        case 16: return launch<0, 16>(x, wk, bias, out, B, T, C, plan, s);
        default: return launch<0, 8>(x, wk, bias, out, B, T, C, plan, s);
      }
  }
}

extern "C" int fused_mrf_bf16(const void* x, const void* wk, const void* bias,
                              void* out, int B, int T, int C, int n_branch,
                              const int* kernel_sizes, const int* n_pairs,
                              const int* dilations, int halo, int tb,
                              void* stream) {
  if (n_branch < 1 || n_branch > MAXB || (C != 16 && C != 32 && C != 64) ||
      tb < 16 || halo < 0 || B < 1 || B > 65535 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  if (!make_plan(plan, n_branch, kernel_sizes, n_pairs, dilations, halo, tb) ||
      smem_bytes_bf16(tb, halo, C) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(wk);
  const auto* bb = static_cast<const __nv_bfloat16*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return launch_bf16<64>(xb, wb, bb, o, B, T, plan, s);
    case 32: return launch_bf16<32>(xb, wb, bb, o, B, T, plan, s);
    default: return launch_bf16<16>(xb, wb, bb, o, B, T, plan, s);
  }
}
