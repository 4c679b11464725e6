// One whole MRF stage of the HiFi-GAN vocoder in one kernel, for Hopper
// (sm_90a): float32 convolutions on the TF32 tensor cores with a 3xTF32
// split (wgmma m64nCk8, A from registers; csrc/tf32x3.cuh).
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
// the products bound the kernel. A lone wgmma m64nNk8 with A from
// registers, three to a unit and k-step as here, runs at 30 / 59 / 96 / 97%
// of the TF32 rate at N = 8 / 16 / 32 / 64 (scripts/exp_wgmma_rate.py).
//
// Numerics: every product is 3xTF32 (lo_a hi_b + hi_a lo_b + hi_a hi_b):
// within ~2^-20 of its float32 value. The tensor cores' float32 sums do
// not round to nearest, so a sum there drifts with its length. A conv's
// sums stay in the wgmma accumulators from the bias over at most 704 taps x
// input channels (tap_group): the whole conv at V1's widths, C <= 64 (K <=
// 11), where the card measured 0.36-0.48 of phase 5's gate for sums carried
// over a whole conv; above C = 64, groups of 5-9 taps, each group's
// partial added to the sum in IEEE float32 in shared memory. chip_smoke.py
// phase 5 holds the stage to 1e-5 of max |plain| against its IEEE float32
// plain version; plain TF32 (one product of hi parts, ~2^-11) would not.
//
// The design. A block (one per SM) owns tb output rows of one batch row and
// computes the stage on a strip of L = tb + 2 * halo rows in shared memory,
// where halo is the longest branch's one-sided receptive field in samples
// (60 at V1: 5 + 15 + 25 for the k = 11 dilated convs, 3 x 5 for the plain
// ones). Each conv is computed only on the rows that later convs still
// need, so the recompute shrinks conv by conv to exactly tb rows at the
// branch's end. Two strips, rows of S = C + 8 floats (C + 16 at an odd C /
// 8, so the float2 A-fragment loads of a half warp hit 32 banks): Y, the
// branch state y, which the dilated conv reads, and Z, where the dilated
// conv sums and leaves leaky(t), which the plain conv reads; the plain conv
// adds its t to Y. Each conv is an implicit GEMM: strip rows x C outputs,
// reducing over taps x C inputs. A dilated tap is a row shift of the same
// strip: each warp loads its A fragment (16 rows x 8 inputs, two float2) at
// a row offset of tap * dil - pad, takes the leaky ReLU (the dilated conv;
// a template parameter, so no test among the wgmmas) and splits it in two
// instructions a value (hi: x itself, which the tensor cores read
// truncated to TF32; lo: x minus that). A warpgroup's unit is 64 rows x C
// outputs, one wgmma m64nCk8 per product; a warpgroup holds R units' sums.
// - Weights. ops/fused_mrf.py::kernel_weights pre-splits them into TF32 hi
//   and lo halves, one block per k-step (one tap, 8 input channels, ordered
//   as the A fragment's k; each half K-major [2][C][4], the no-swizzle
//   layout the B descriptor reads: 64 C bytes). A slab is the k-steps of a
//   tap that fit 8 KB (slab_ksteps: the whole tap up to C = 32, 2 k-steps
//   at 48 and 64, 1 above). The slabs arrive by bulk async copies that one
//   thread issues (a predicate, not a branch) into a ring of slots
//   (slots32: 3 at C = 64, whose tile shared memory binds, else about 32
//   KB, 4 to 12) with a full and an empty mbarrier each, copied two short
//   of the ring ahead; one thread of each warpgroup releases a slot (a
//   predicate again) once the warpgroup's waits have retired its products
//   on it. The slabs run in the stage's order across conv and branch
//   boundaries. No block barrier per slab: one wait for the slab to land
//   and one for its slot's release a slab.
// - Waits. Each unit's three products of a k-step are one commit group,
//   and the wait after each commit leaves only the newest group in
//   flight. From three units a warpgroup on, the next unit's fragment is
//   loaded and split between a group's commit and that wait, so the next
//   products follow the wait at once. A slab's groups are issued
//   straight-line (one block-uniform test per slab picks how many units: a
//   round of units runs while its first unit has rows): ptxas serializes
//   wgmmas around a branch between them.
// - Barriers. Block barriers remain only where a strip changes hands: one
//   per conv and one per branch.
// The branch mean accumulates in the output, which each thread owns for its
// rows, in branch order (no atomics: deterministic). The ragged last tile
// is masked; any T works.
//
// Tiles (ops/fused_mrf.py::tile_plan chooses tb and passes it; the launch
// checks it): warpgroups x units (warpgroups32, rounds32) 4 x 4 at C = 8
// and 24, 3 x 5 at 16, 3 x 4 at 32 and 40, 3 x 3 at 48, 2 x 3 up to 96, 2 x
// 2 above; the strips and ring fill the SM's 227 KB. At V1 (halo 60), with
// the least work per output row: C = 64 tb 240, 32 tb 496, 16 tb 688 (the
// units bind at 16); a launch takes the tb with the least waves x rows
// computed (tests/test_torch_fused_mrf_tiles.py::test_v1_tiles).
//
// The bfloat16 mode (mrf_kernel_bf16; the bf16 vocoder's fused stages, the
// float32 mode's widths: every multiple of 8 up to 120) replaces the same
// JAX kernel run on a bf16 strip
// (_mrf_kernel, _strip_conv: fused_mrf.py:98-152) and keeps its rounding
// points: every conv sums its bf16 products in float32 from its bf16 bias
// and rounds the sum to bf16 once; the validity mask, the leaky ReLU
// (slope bf16(0.1)) and y + t are taken in bf16, each rounded to nearest
// even; the branches are summed in float32 and the sum times 1 / n_branch
// is rounded to bf16 at the store.
//
// Bound: the same 252 C^2 operations per sample on the bf16 tensor cores
// (989 TFLOP/s) against 4 C bytes per sample: the operations, by 3-14x.
// A lone m64nCk16 runs at 40% / 66% / 99% of that rate at C = 16 / 32 /
// 64 (scripts/exp_wgmma_rate.py).
//
// The design. The float32 mode's strip walk and rounds of 64-row units,
// with bf16 wgmma m64nCk16 products whose operands are both in shared
// memory: the strips are [C / 8][rows][8] planes (8 x 16-byte core
// matrices, the no-swizzle K-major layout; planes strip_rows apart, 4 mod
// 8), so a tap's row shift is a descriptor 16 bytes further on, and no
// thread loads, converts or holds A. B is a one-tap slab, [k16(C) / 8][C]
// [8] (ops/fused_mrf.py::kernel_weights of bf16 weights). At an odd C / 8
// (8, 24, ..., 120) a 16-deep k-step spans one plane of 8 channels past
// C: the Z strip the products read has that plane, zeroed once per block
// and never written again, and the slab's last 8 input rows are zero, so
// the step adds exact zeros; x is not padded in device memory. One wgmma
// overload per n (WGMMA_BF16).
// - Waits. Each conv's sums stay in the wgmma accumulators through all its
//   taps, from the bias: no partial sums and no float32 adds. A warpgroup
//   waits for its products only one tap behind, to free that tap's weight
//   slot, and before the conv's epilogue. A tap's rounds are issued
//   straight-line (one block-uniform test per tap picks how many): ptxas
//   serializes wgmmas around a branch between them.
// - Barriers. None per slab. The weights arrive by bulk async copies that
//   one thread issues (a predicate, not a branch) into slots with a full
//   and an empty mbarrier each: a ring of 8 at C = 64 and 12 at C = 32,
//   filled two short of the ring ahead, each slot released by one thread
//   of each warpgroup (a predicate again) once the warpgroup's wait has
//   retired its products on it; at C = 16 the whole stage's 126 slabs (63
//   KB at V1) are resident, loaded once per block. Block barriers remain
//   only where a strip changes hands: four per pair, one per branch.
// - Leaky ReLU. leaky(y) is written once per pair into the Z strip, which
//   the dilated conv reads and its epilogue then overwrites with leaky(t)
//   for the plain conv: no more shared memory than before. Leaky ReLU,
//   the rounding and y + t run on packed pairs (mul/max/add.bf16x2), bit
//   for bit the rounding of the float32 forms, and an epilogue loads all
//   of a row's pairs before it stores any.
// - Weight traffic. Every block still streams the stage's slabs from L2
//   (at C = 64, 1008 KB per tile); the ring keeps six 8 KB copies in
//   flight. Tiles at V1's halo of 60 (tile_plan(..., dtype=torch.
//   bfloat16); tests/test_torch_bf16.py::BF16_TILES), warpgroups x units
//   and weight slots: C = 8 tb 1152 (4 x 5, resident), 16 tb 944 (4 x 5,
//   resident), 24 tb 688 (4 x 5, 12), 32 tb 640 (3 x 4, 12), 40 / 48 tb
//   368 / 352 (3 x 4, 12), 56 tb 240 (3 x 4, 9), 64 tb 240 (2 x 3, 8), 72
//   / 80 tb 192 / 176 (2 x 3, 5), 88 / 96 tb 160 / 144 (2 x 3, 3), 104 /
//   112 tb 112 / 96 (2 x 2, 3), 120 tb 64 (3 x 1, 3): the strips, slots
//   and float32 branch sum within the SM's 227 KB, a unit's C / 2 sums a
//   thread within its warpgroups' registers.
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
// the same in bfloat16: x, out (B, T, C), wk (sum over convs of K *
// k16(C) * C) and bias bf16, x and wk 16-byte aligned; C a multiple of 8 up
// to 120.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;
using sm90::bulk_load_1d;
using sm90::desc_hi;
using sm90::fence_proxy_async;
using sm90::mbar_arrive_if;
using sm90::mbar_fence_init;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::reg_fence;
using sm90::smem_u32;
using sm90::wg_commit;
using sm90::wg_fence;
using sm90::wg_wait;

constexpr int MAXB = 4;         // branches
constexpr int MAXP = 4;         // pairs per branch
constexpr int UNIT_ROWS = 64;   // rows of a warpgroup's unit (the wgmma m)
constexpr int MAX_C = 120;      // the widest stage either mode takes
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

// ---- the bfloat16 mode ---------------------------------------------------

constexpr float SLOPE16 = 0.10009765625f;   // bf16(0.1)

// a bf16 width's k extent: C rounded up to the wgmma's 16-deep k-step. At
// an odd C / 8 the last k-step spans one plane of 8 channels past C, which
// the kernel keeps zero in the Z strip and kernel_weights in the slab
__host__ __device__ constexpr int k16(int c) { return (c + 15) / 16 * 16; }

// warpgroups and 64 x C units per warpgroup of the bf16 mode, within the
// registers (a unit's sums take C / 2 a thread): 4 x 5 up to C = 24, 3 x 4
// up to 56, 2 x 3 up to 96, 2 x 2 up to 112, 3 x 1 at 120 (two units of 60
// sums spilled at 255 registers; the tile, 64 rows, needs three units)
__host__ __device__ constexpr int warpgroups16(int c) {
  return c <= 24 ? 4 : c <= 56 ? 3 : c <= 112 ? 2 : 3;
}
__host__ __device__ constexpr int rounds16(int c) {
  return c <= 24 ? 5 : c <= 56 ? 4 : c <= 96 ? 3 : c <= 112 ? 2 : 1;
}

// C = 8 and 16 hold the stage's whole weight stream (63 KB at V1 and C =
// 16) in place of the ring
__host__ __device__ constexpr bool resident16(int c) { return c <= 16; }

// the bf16 weight slots: a ring of 8 one-tap slabs at C = 64 (8 KB each),
// 12 at C = 32 (2 KB); at the other widths as many as fit in 64 KB, 3 to
// 12 (3 of 30 KB at C = 120), copied two short of the ring ahead; at C = 8
// and 16 every slab of the stage
__host__ __device__ constexpr int ring16(int n) {
  return n < 3 ? 3 : n > 12 ? 12 : n;
}
__host__ __device__ constexpr int slots16(int c, int n_slabs) {
  return resident16(c) ? n_slabs
         : c == 64     ? 8
         : c == 32     ? 12
                       : ring16(65536 / (2 * k16(c) * c));
}

// the bf16 weight stream's slabs: one per tap of every conv
__host__ __device__ inline int plan_slabs(const Plan& plan) {
  int n = 0;
  for (int br = 0; br < plan.nb; ++br) n += 2 * plan.np[br] * plan.k[br];
  return n;
}

// a full and an empty mbarrier per slot, padded to 128 bytes
__host__ __device__ constexpr int barrier_bytes(int nslot) {
  return (16 * nslot + 127) / 128 * 128;
}

// a strip plane's rows: l rounded up to 4 mod 8, so a k-step's two planes
// start 64 bytes apart mod 128
__host__ __device__ constexpr int strip_rows(int l) {
  return (l + 3) / 8 * 8 + 4;
}

// the float32 branch-sum strip's row: C + 8 floats, C + 16 at an odd C / 8
// (8 or 24 mod 32, so a half warp's float2 stores hit 32 banks)
__host__ __device__ constexpr int sum_stride(int c) {
  return c % 16 == 0 ? c + 8 : c + 16;
}

// a packed pair of bf16 (the first in the low half) and its 32 bits
__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}
__device__ __forceinline__ __nv_bfloat162 pair2(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, 4);
  return v;
}
// the leaky ReLU of a packed pair of bf16, max(v, bf16(0.1) v), in two
// instructions (mul.bf16x2, max.bf16x2): a product of two bf16 values is
// exact in float32, so the one rounding of the packed multiply (to nearest,
// ties to even) gives the bf16 of the float32 product, as the JAX kernel's
// bf16 leaky ReLU does (tests/test_torch_bf16.py checks every finite bf16)
__device__ __forceinline__ uint32_t leaky2(uint32_t u) {
  const __nv_bfloat162 v = pair2(u);
  return bits2(__hmax2(v, __hmul2(__float2bfloat162_rn(SLOPE16), v)));
}
// y + t on packed pairs, rounded once to nearest even: equal to rounding
// the float32 sum, which is exact unless the exponents are over 15 apart,
// and then too far from a bf16 tie for the two roundings to differ
__device__ __forceinline__ uint32_t add2(uint32_t y, uint32_t t) {
  return bits2(__hadd2(pair2(y), pair2(t)));
}

// wgmma m64nNk16 bf16, A and B K-major in shared memory (both through
// descriptors, no transpose), float32 d += A B: one overload per n, 8 to
// 120 by 8, each written out by WGMMA_BF16 (its three operand numbers are
// those after the N / 2 accumulators: the two descriptors and the scale)
#define WG16_D(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGMMA_BF16(N, DA, DB, SCALE)                                         \
  __device__ __forceinline__ void wgmma_bf16(float(&d)[N / 2], uint64_t da, \
                                             uint64_t db) {                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" #N                     \
                 "k16.f32.bf16.bf16 {" WG16_R##N "}, " DA ", " DB           \
                 ", p, 1, 1, 0, 0;\n}\n"                                     \
                 : WG16_D##N                                                \
                 : "l"(da), "l"(db), "r"(1));                               \
  }
#define WG16_R8 "%0, %1, %2, %3"
#define WG16_R16 WG16_R8 ", %4, %5, %6, %7"
#define WG16_R24 WG16_R16 ", %8, %9, %10, %11"
#define WG16_R32 WG16_R24 ", %12, %13, %14, %15"
#define WG16_R40 WG16_R32 ", %16, %17, %18, %19"
#define WG16_R48 WG16_R40 ", %20, %21, %22, %23"
#define WG16_R56 WG16_R48 ", %24, %25, %26, %27"
#define WG16_R64 WG16_R56 ", %28, %29, %30, %31"
#define WG16_R72 WG16_R64 ", %32, %33, %34, %35"
#define WG16_R80 WG16_R72 ", %36, %37, %38, %39"
#define WG16_R88 WG16_R80 ", %40, %41, %42, %43"
#define WG16_R96 WG16_R88 ", %44, %45, %46, %47"
#define WG16_R104 WG16_R96 ", %48, %49, %50, %51"
#define WG16_R112 WG16_R104 ", %52, %53, %54, %55"
#define WG16_R120 WG16_R112 ", %56, %57, %58, %59"
#define WG16_D8 WG16_D(0)
#define WG16_D16 WG16_D8, WG16_D(4)
#define WG16_D24 WG16_D16, WG16_D(8)
#define WG16_D32 WG16_D24, WG16_D(12)
#define WG16_D40 WG16_D32, WG16_D(16)
#define WG16_D48 WG16_D40, WG16_D(20)
#define WG16_D56 WG16_D48, WG16_D(24)
#define WG16_D64 WG16_D56, WG16_D(28)
#define WG16_D72 WG16_D64, WG16_D(32)
#define WG16_D80 WG16_D72, WG16_D(36)
#define WG16_D88 WG16_D80, WG16_D(40)
#define WG16_D96 WG16_D88, WG16_D(44)
#define WG16_D104 WG16_D96, WG16_D(48)
#define WG16_D112 WG16_D104, WG16_D(52)
#define WG16_D120 WG16_D112, WG16_D(56)
WGMMA_BF16(8, "%4", "%5", "%6")
WGMMA_BF16(16, "%8", "%9", "%10")
WGMMA_BF16(24, "%12", "%13", "%14")
WGMMA_BF16(32, "%16", "%17", "%18")
WGMMA_BF16(40, "%20", "%21", "%22")
WGMMA_BF16(48, "%24", "%25", "%26")
WGMMA_BF16(56, "%28", "%29", "%30")
WGMMA_BF16(64, "%32", "%33", "%34")
WGMMA_BF16(72, "%36", "%37", "%38")
WGMMA_BF16(80, "%40", "%41", "%42")
WGMMA_BF16(88, "%44", "%45", "%46")
WGMMA_BF16(96, "%48", "%49", "%50")
WGMMA_BF16(104, "%52", "%53", "%54")
WGMMA_BF16(112, "%56", "%57", "%58")
WGMMA_BF16(120, "%60", "%61", "%62")

// one tap's products for this warpgroup's first NA rounds, straight-line:
// a is the shared address of its round-0 unit's first A row in plane 0
// (planes `plane` bytes apart, a round NWG units further on), w the slab's;
// k16(N) / 16 k-steps, the last at an odd N / 8 over a zero plane
template <int NA, int R, int N, int NWG>
__device__ __forceinline__ void tap_products(float (&acc)[R][N / 2],
                                             uint32_t a, uint32_t w,
                                             uint64_t ha, uint64_t hb,
                                             uint32_t plane) {
#pragma unroll
  for (int r = 0; r < NA; ++r)
#pragma unroll
    for (int ks = 0; ks < k16(N) / 16; ++ks)
      wgmma_bf16(acc[r],
                 ha | ((a + r * NWG * UNIT_ROWS * 16 + 2 * ks * plane) >> 4),
                 hb | ((w + 2 * ks * N * 16) >> 4));
}

// tap_products for the conv's n active rounds (1 <= n <= NA): one test the
// block agrees on per tap, none between the wgmmas
template <int NA, int R, int N, int NWG>
__device__ __forceinline__ void tap_rounds(int n, float (&acc)[R][N / 2],
                                           uint32_t a, uint32_t w,
                                           uint64_t ha, uint64_t hb,
                                           uint32_t plane) {
  if constexpr (NA > 1) {
    if (n < NA) {
      tap_rounds<NA - 1, R, N, NWG>(n, acc, a, w, ha, hb, plane);
      return;
    }
  }
  tap_products<NA, R, N, NWG>(acc, a, w, ha, hb, plane);
}

// one MRF stage in bf16 at C = CT (a multiple of 8 up to 120): wgmma
// m64nCk16 with both operands in shared memory; the strip walk and the
// tiles' rounds are mrf_kernel's (header: the bfloat16 mode)
template <int CT>
__global__ void __launch_bounds__(128 * warpgroups16(CT), 1)
mrf_kernel_bf16(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ wk,
                const __nv_bfloat16* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int T,
                const __grid_constant__ Plan plan) {
  constexpr int C = CT, N = CT;
  constexpr int NWG = warpgroups16(CT);
  constexpr int THREADS = 128 * NWG;
  constexpr int R = rounds16(CT);
  constexpr int SM = sum_stride(C);
  constexpr int slab = k16(C) * C;     // bf16 elements: one tap
  constexpr int c8 = C / 8;            // 8-channel planes of y
  const int H = plan.halo, tb = plan.tb, L = strip_rows(tb + 2 * H);
  const int n_slabs = plan_slabs(plan);
  // resident: every slab its own slot, all issued at once, none reused
  const int nslot = slots16(C, n_slabs);
  const int lead = resident16(C) ? n_slabs : nslot - 2;
  extern __shared__ __align__(128) unsigned char smem16[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem16);   // slab landed
  uint64_t* empty = full + nslot;      // every warpgroup done with the slot
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem16 + barrier_bytes(nslot));
  // the strips: [C / 8][L][8], row r's channels 8q..8q+7 at (q L + r) 8;
  // Z, which the products read, has k16(C) / 8 planes, its last zero at an
  // odd C / 8
  __nv_bfloat16* Y = ring + nslot * slab;      // the branch state y
  __nv_bfloat16* Z = Y + L * C;     // leaky(y), then leaky(dilated conv)
  float* M = reinterpret_cast<float*>(Z + L * k16(C));   // branch sum

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * tb - H;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * T * C;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * T * C;

  for (int j = tid; j < nslot; j += THREADS) {
    mbar_init(full + j, 1);
    if (!resident16(C)) mbar_init(empty + j, NWG);
  }
  if (c8 % 2)   // the zero plane; the first leaky pass fences it for wgmma
    for (int r = tid; r < L; r += THREADS)
      *reinterpret_cast<uint4*>(Z + (c8 * L + r) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  mbar_fence_init();
  __syncthreads();
  // the first `lead` slabs, before any product is in flight
  if (tid == 0)
    for (int j = 0; j < lead; ++j)
      bulk_load_1d(ring + j * slab, wk + static_cast<size_t>(j) * slab,
                   2 * slab, full + j, true);
  // then the next slab q into slot qs (its use qp-th mod 2), once every
  // warpgroup has released the slot's previous slab q - nslot: all threads
  // wait, thread 0 copies (the test a predicate, so no divergent path sits
  // among the wgmmas)
  int q = lead, qs = lead % nslot;
  uint32_t qp = (lead / nslot) & 1;
  auto issue = [&]() {
    if (q >= n_slabs) return;
    mbar_wait(empty + qs, qp ^ 1);
    bulk_load_1d(ring + qs * slab, wk + static_cast<size_t>(q) * slab,
                 2 * slab, full + qs, tid == 0);
    ++q;
    if (++qs == nslot) qs = 0, qp ^= 1;
  };
  // one thread of each warpgroup releases its slots
  const bool releaser = (tid & 127) == 0;
  const uint32_t z_s = smem_u32(Z), ring_s = smem_u32(ring);
  const uint64_t ha = desc_hi(L * 16, 128), hb = desc_hi(C * 16, 128);

  float acc[R][N / 2];
  int ss = 0;         // the slot of the slab in use, across convs and
  uint32_t sp = 0;    // branches, and its use mod 2
  int boff = 0;       // bias offset of the current conv
  for (int br = 0; br < plan.nb; ++br) {
    const int K = plan.k[br];
    int rem = 0;
    for (int p = 0; p < plan.np[br]; ++p)
      rem += (K - 1) * plan.d[br][p] / 2 + (K - 1) / 2;

    // the rows this branch needs, [H - rem, H + tb + rem), from x (zero
    // outside [0, T)); the barrier first: the previous branch's last
    // epilogue may still be updating Y
    __syncthreads();
    {
      const int lo = H - rem, n = tb + 2 * rem;
      for (int idx = tid; idx < n * c8; idx += THREADS) {
        const int r = lo + idx / c8, pc = idx % c8;
        const int tt = g0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (tt >= 0 && tt < T)
          v = __ldg(reinterpret_cast<const uint4*>(
                        xb + static_cast<size_t>(tt) * C) + pc);
        *reinterpret_cast<uint4*>(Y + (pc * L + r) * 8) = v;
      }
    }

    for (int p = 0; p < plan.np[br]; ++p) {
      const int d = plan.d[br][p];
      const int p1 = (K - 1) * d / 2, p2 = (K - 1) / 2;
      // Z = leaky(y) on the rows the dilated conv reads, [H - rem, H + tb +
      // rem), once per pair; y is written, and the last conv's products no
      // longer read Z
      __syncthreads();
      for (int r = H - rem + tid; r < H + tb + rem; r += THREADS) {
        uint4 v[c8];      // a row: all its loads, then its stores
#pragma unroll
        for (int pc = 0; pc < c8; ++pc)
          v[pc] = *reinterpret_cast<const uint4*>(Y + (pc * L + r) * 8);
#pragma unroll
        for (int pc = 0; pc < c8; ++pc)
          *reinterpret_cast<uint4*>(Z + (pc * L + r) * 8) =
              make_uint4(leaky2(v[pc].x), leaky2(v[pc].y), leaky2(v[pc].z),
                         leaky2(v[pc].w));
      }
      fence_proxy_async();   // the generic stores, visible to the wgmmas
      __syncthreads();
#pragma unroll 1
      for (int cv = 0; cv < 2; ++cv) {
        const int dil = cv ? 1 : d, pad = cv ? p2 : p1;
        if (cv) rem -= p1 + p2;
        const int lo = cv ? H - rem : H - rem + p1;
        const int hi = cv ? H + tb + rem : H + tb + rem - p1;
        // every unit's sum starts at the bias (bf16, exact in float32)
#pragma unroll
        for (int i = 0; i < N / 2; i += 2) {
          const int co = 8 * (i / 4) + 2 * t;
          const float b0 = __bfloat162float(bias[boff + co]);
          const float b1 = __bfloat162float(bias[boff + co + 1]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][i] = b0;
            acc[r][i + 1] = b1;
          }
        }
        // a round (one unit per warpgroup) runs while its first unit has
        // rows, so n rounds, a number the whole block agrees on (ptxas
        // serializes wgmmas on a divergent path); a later warpgroup's unit
        // past hi reads rows past the conv's, whose sums are not stored
        const int n = min(R, (hi - lo + NWG * UNIT_ROWS - 1) /
                                 (NWG * UNIT_ROWS));
        const uint32_t a0 = z_s + (lo + wg * UNIT_ROWS) * 16;
        wg_fence();
        int prev = 0;
#pragma unroll 1
        for (int tap = 0; tap < K; ++tap) {
          // the slab `lead` ahead; its slot's last reader, the slab two
          // before this one, was released at the end of the previous tap
          if (!resident16(C)) issue();
          mbar_wait(full + ss, sp);
          // k-step ks: planes 2ks, 2ks + 1 of Z from row m0 + shift; the
          // slab's 16-byte k groups 2ks, 2ks + 1 ([C / 8][C][8])
          tap_rounds<R, R, N, NWG>(n, acc, a0 + (tap * dil - pad) * 16,
                                   ring_s + ss * slab * 2, ha, hb, L * 16);
          wg_commit();
          wg_wait<1>();   // the previous tap's products are done
          if (!resident16(C) && tap > 0)
            mbar_arrive_if(empty + prev, releaser);
          prev = ss;
          if (++ss == nslot) ss = 0, sp ^= 1;
        }
        wg_wait<0>();
#pragma unroll
        for (int r = 0; r < R; ++r) reg_fence(acc[r]);
        if (!resident16(C)) mbar_arrive_if(empty + prev, releaser);
        boff += C;
        // the dilated conv's epilogue overwrites Z: every warpgroup's
        // products must be done reading it
        if (cv == 0) __syncthreads();

        // epilogue, on packed pairs of bf16: t = bf16(sum), zero outside
        // [0, T); the dilated conv stores leaky(t) in Z; the plain one sets
        // y = bf16(y + t) (add.bf16x2 rounds the exact sum once, as
        // rounding its float32 sum does) and, on the branch's last pair,
        // adds y to the float32 sum, which the last branch scales and stores
        const bool last = cv == 1 && p == plan.np[br] - 1;
        const bool store = last && br == plan.nb - 1;
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
            const uint32_t keep = valid ? 0xFFFFFFFFu : 0u;
            // the row's N / 8 pairs: j holds channels 8j + 2t, 8j + 2t + 1
            // (accumulators 2h + 4j, 2h + 4j + 1), in plane j of the strip
            constexpr int NP = N / 8;
            uint32_t* zr = reinterpret_cast<uint32_t*>((cv ? Y : Z) +
                                                       row * 8 + 2 * t);
            uint32_t v[NP];
#pragma unroll
            for (int j = 0; j < NP; ++j)
              v[j] = bits2(__floats2bfloat162_rn(acc[r][2 * h + 4 * j],
                                                 acc[r][2 * h + 4 * j + 1])) &
                     keep;
            if (cv == 0) {
#pragma unroll
              for (int j = 0; j < NP; ++j) zr[j * L * 4] = leaky2(v[j]);
              continue;
            }
            // every load before the stores: the compiler cannot tell the
            // pairs apart and would wait out each load's latency in turn
            uint32_t y[NP];
#pragma unroll
            for (int j = 0; j < NP; ++j) y[j] = zr[j * L * 4];
#pragma unroll
            for (int j = 0; j < NP; ++j) {
              y[j] = add2(y[j], v[j]);
              zr[j * L * 4] = y[j];
            }
            if (!(last && valid)) continue;   // rows [H, H + tb)
            float2* mr =
                reinterpret_cast<float2*>(M + (row - H) * SM + 2 * t);
            float2 m[NP];
#pragma unroll
            for (int j = 0; j < NP; ++j) {
              m[j] = make_float2(__uint_as_float(y[j] << 16),
                                 __uint_as_float(y[j] & 0xFFFF0000u));
              if (br > 0) {
                const float2 prev = mr[4 * j];
                m[j].x = __fadd_rn(prev.x, m[j].x);
                m[j].y = __fadd_rn(prev.y, m[j].y);
              }
            }
#pragma unroll
            for (int j = 0; j < NP; ++j) {
              if (store) {
                const float inv = 1.0f / plan.nb;
                *reinterpret_cast<uint32_t*>(
                    ob + static_cast<size_t>(tt) * C + 8 * j + 2 * t) =
                    bits2(__floats2bfloat162_rn(__fmul_rn(m[j].x, inv),
                                                __fmul_rn(m[j].y, inv)));
              } else {
                mr[4 * j] = m[j];
              }
            }
          }
        }
        if (cv == 0) {      // leaky(t) in Z, for the plain conv's products
          fence_proxy_async();
          __syncthreads();
        }
      }
    }
  }
}

// shared memory of a bf16 launch: the barriers, the weight slots, the two
// strips (Z with its zero plane at an odd C / 8), the branch sum, and room
// past them for the rows a last round's unit reads past its conv's
size_t smem_bytes_bf16(int tb, int halo, int C, int n_slabs) {
  const int nslot = slots16(C, n_slabs);
  return barrier_bytes(nslot) + 2 * static_cast<size_t>(nslot) * k16(C) * C +
         2 * static_cast<size_t>(strip_rows(tb + 2 * halo)) * (C + k16(C)) +
         4 * static_cast<size_t>(tb) * sum_stride(C) +
         16 * UNIT_ROWS * warpgroups16(C);
}

template <int CT>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* wk,
                const __nv_bfloat16* bias, __nv_bfloat16* out, int B, int T,
                const Plan& plan, cudaStream_t stream) {
  const int rows = plan.tb + 2 * plan.halo;
  if ((rows + UNIT_ROWS - 1) / UNIT_ROWS > warpgroups16(CT) * rounds16(CT))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      smem_bytes_bf16(plan.tb, plan.halo, CT, plan_slabs(plan));
  cudaError_t err = cudaFuncSetAttribute(
      mrf_kernel_bf16<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + plan.tb - 1) / plan.tb, B);
  mrf_kernel_bf16<CT><<<grid, 128 * warpgroups16(CT), bytes, stream>>>(
      x, wk, bias, out, T, plan);
  return static_cast<int>(cudaGetLastError());
}

// ---- the float32 mode -----------------------------------------------------

// warpgroups and 64 x C units per warpgroup of the float32 mode, within the
// registers (a unit holds C / 2 sums and its A fragment, 8 registers, a
// thread): 4 x 4 at C = 8 and 24, 3 x 5 at 16, 3 x 4 at 32 and 40, 3 x 3 at
// 48, 2 x 3 up to 96, 2 x 2 above (4 x 5 at C = 8 spilled at the 128
// registers of four warpgroups)
__host__ __device__ constexpr int warpgroups32(int c) {
  return c == 16 ? 3 : c <= 24 ? 4 : c <= 48 ? 3 : 2;
}
__host__ __device__ constexpr int rounds32(int c) {
  return c == 16 ? 5 : c <= 40 ? 4 : c <= 96 ? 3 : 2;
}

// k-steps a weight slab holds (one k-step: 8 input channels x C outputs,
// hi and lo halves, 64 C bytes): the most that divide a tap's C / 8 within
// 8 KB (a whole tap up to C = 32, 2 at C = 48 and 64, else 1)
__host__ __device__ constexpr int slab_ksteps(int c, int k = 0) {
  return k == 0 ? slab_ksteps(c, c / 8)
         : (c / 8) % k == 0 && 64 * c * k <= 8192 ? k
                                                  : slab_ksteps(c, k - 1);
}

// weight slots: 3 at C = 64 (its tile is bound by shared memory), else
// about 32 KB of slabs, 4 to 12
__host__ __device__ constexpr int slots32(int c) {
  return c == 64                                  ? 3
         : 32768 / (64 * c * slab_ksteps(c)) < 4  ? 4
         : 32768 / (64 * c * slab_ksteps(c)) > 12 ? 12
                                                  : 32768 / (64 * c *
                                                             slab_ksteps(c));
}

// taps a partial sum covers: at most 704 taps x input channels, the whole
// conv at C <= 64 (K <= 11), 5 to 9 taps above
__host__ __device__ constexpr int tap_group(int c) { return 704 / c; }

__host__ __device__ constexpr int strip_stride(int c) {
  return c % 16 == 0 ? c + 8 : c + 16;
}

// x split for the tensor cores in two instructions: hi is x itself, of
// which they read the top 19 bits (x truncated to TF32), and lo = x - that,
// exact, of which they read the top 11 significant bits
__device__ __forceinline__ void split2(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi & 0xFFFFE000u)));
}

__device__ __forceinline__ float leaky(float v) { return fmaxf(v, SLOPE * v); }

// wgmma m64nNk8 tf32, A from registers (the m16n8k8 fragment of this warp's
// 16 rows), B K-major through a descriptor, d = A B + (scale ? d : 0): one
// overload per n, 8 to 120 by 8 (the bf16 mode's accumulator lists; the
// operand numbers are those after the N / 2 accumulators)
#define WGMMA_TF32(N, A, DB, SCALE)                                          \
  __device__ __forceinline__ void mma_tf32(float(&d)[N / 2],                  \
                                           const uint32_t(&a)[4],             \
                                           uint64_t db, int scale) {          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k8.f32.tf32.tf32 {" WG16_R##N "}, {" A "}, " DB            \
                 ", p, 1, 1;\n}\n"                                            \
                 : WG16_D##N                                                 \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                   "r"(scale));                                              \
  }
WGMMA_TF32(8, "%4, %5, %6, %7", "%8", "%9")
WGMMA_TF32(16, "%8, %9, %10, %11", "%12", "%13")
WGMMA_TF32(24, "%12, %13, %14, %15", "%16", "%17")
WGMMA_TF32(32, "%16, %17, %18, %19", "%20", "%21")
WGMMA_TF32(40, "%20, %21, %22, %23", "%24", "%25")
WGMMA_TF32(48, "%24, %25, %26, %27", "%28", "%29")
WGMMA_TF32(56, "%28, %29, %30, %31", "%32", "%33")
WGMMA_TF32(64, "%32, %33, %34, %35", "%36", "%37")
WGMMA_TF32(72, "%36, %37, %38, %39", "%40", "%41")
WGMMA_TF32(80, "%40, %41, %42, %43", "%44", "%45")
WGMMA_TF32(88, "%44, %45, %46, %47", "%48", "%49")
WGMMA_TF32(96, "%48, %49, %50, %51", "%52", "%53")
WGMMA_TF32(104, "%52, %53, %54, %55", "%56", "%57")
WGMMA_TF32(112, "%56, %57, %58, %59", "%60", "%61")
WGMMA_TF32(120, "%60, %61, %62, %63", "%64", "%65")

// keeps a fragment's registers live up to here (the wait that retires the
// products reading them): the compiler may not give them to other values
// while an asynchronous wgmma still reads them
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e]) :: "memory");
}

// this warp's unit A fragment: rows ro of the strip from za (two float2
// loads), the leaky ReLU where LEAKY (the dilated conv's input), split. a0
// (g, t) = channel 2t, a1 (g + 8, t), a2 (g, t + 4) = channel 2t + 1, a3
// (g + 8, t + 4): kernel_weights orders B's k the same way
template <bool LEAKY>
__device__ __forceinline__ void load_frag(uint32_t (&ah)[4],
                                          uint32_t (&al)[4], const float* za,
                                          const int (&ro)[2]) {
  float2 x0 = *reinterpret_cast<const float2*>(za + ro[0]);
  float2 x1 = *reinterpret_cast<const float2*>(za + ro[1]);
  if constexpr (LEAKY) {
    x0 = make_float2(leaky(x0.x), leaky(x0.y));
    x1 = make_float2(leaky(x1.x), leaky(x1.y));
  }
  split2(x0.x, ah[0], al[0]);
  split2(x1.x, ah[1], al[1]);
  split2(x0.y, ah[2], al[2]);
  split2(x1.y, ah[3], al[3]);
}

// one slab's products (KSL k-steps, 8 input channels each) for this
// warpgroup's first NA units, each unit's three of a k-step its own commit
// group, straight-line; the wait after each commit leaves only the newest
// group in flight (none at NA = 1). From three units on, the next group's
// fragment (the next slab's first, from zn, after the last) is loaded and
// split before that wait, so the wait is followed at once by the next
// products: its registers are free by then, since the groups in flight
// are the two before it. With fewer units each fragment is loaded after
// the wait that frees its registers. w: the slab's shared address; scale 0
// starts the sums from zero at its first k-step
template <int NA, int R, int C, int KSL, bool LEAKY>
__device__ __forceinline__ void slab_products(
    float (&acc)[R][C / 2], uint32_t (&ah)[R][4], uint32_t (&al)[R][4],
    const float* za, const float* zn, const int (&roff)[R][2], uint32_t w,
    int scale) {
  constexpr bool AHEAD = NA >= 3;
  const uint64_t hb = desc_hi(C * 16, 128);
#pragma unroll
  for (int ks = 0; ks < KSL; ++ks) {
    // k-step ks: its hi half [2][C][4], its lo half 32 C bytes on
    const uint64_t dh = hb | ((w + 64 * C * ks) >> 4);
    const uint64_t dl = hb | ((w + 64 * C * ks + 32 * C) >> 4);
#pragma unroll
    for (int r = 0; r < NA; ++r) {
      if (!AHEAD) load_frag<LEAKY>(ah[r], al[r], za + 8 * ks, roff[r]);
      wg_fence();
      mma_tf32(acc[r], al[r], dh, ks > 0 || scale);
      mma_tf32(acc[r], ah[r], dl, 1);
      mma_tf32(acc[r], ah[r], dh, 1);
      wg_commit();
      if (AHEAD) {
        if (r + 1 < NA)
          load_frag<LEAKY>(ah[r + 1], al[r + 1], za + 8 * ks, roff[r + 1]);
        else if (ks + 1 < KSL)
          load_frag<LEAKY>(ah[0], al[0], za + 8 * (ks + 1), roff[0]);
        else
          load_frag<LEAKY>(ah[0], al[0], zn, roff[0]);
      }
      wg_wait<(NA > 1 ? 1 : 0)>();
      // the group that wait retired: unit r - 1's (the previous k-step's
      // last unit's at r = 0), or this one's at NA = 1
      const int done = NA > 1 ? (r + NA - 1) % NA : r;
      reg_fence(ah[done]);
      reg_fence(al[done]);
    }
  }
}

// slab_products for the conv's n active units (1 <= n <= NA) and input
// (the dilated conv's, leaky, or the plain one's): tests the block agrees
// on, once per slab, none between the wgmmas
template <int NA, int R, int C, int KSL>
__device__ __forceinline__ void slab_rounds(
    int n, bool leaky_in, float (&acc)[R][C / 2], uint32_t (&ah)[R][4],
    uint32_t (&al)[R][4], const float* za, const float* zn,
    const int (&roff)[R][2], uint32_t w, int scale) {
  if constexpr (NA > 1) {
    if (n < NA) {
      slab_rounds<NA - 1, R, C, KSL>(n, leaky_in, acc, ah, al, za, zn, roff,
                                     w, scale);
      return;
    }
  }
  if (leaky_in)
    slab_products<NA, R, C, KSL, true>(acc, ah, al, za, zn, roff, w, scale);
  else
    slab_products<NA, R, C, KSL, false>(acc, ah, al, za, zn, roff, w, scale);
}

// one MRF stage in float32 at C = CT (a multiple of 8 up to 120), 3xTF32
// on wgmma m64nCk8 (header)
template <int CT>
__global__ void __launch_bounds__(128 * warpgroups32(CT), 1)
mrf_kernel(const float* __restrict__ x, const float* __restrict__ wk,
           const float* __restrict__ bias, float* __restrict__ out, int T,
           const __grid_constant__ Plan plan) {
  constexpr int C = CT;
  constexpr int NWG = warpgroups32(C);
  constexpr int THREADS = 128 * NWG;
  constexpr int R = rounds32(C);
  constexpr int S = strip_stride(C);
  constexpr int KSL = slab_ksteps(C);   // k-steps a slab holds
  constexpr int SLAB = 16 * C * KSL;    // floats: KSL k-steps, hi and lo
  constexpr int NSLOT = slots32(C);
  constexpr int NSL = C / 8 / KSL;      // slabs a tap
  constexpr int TG = tap_group(C);
  constexpr int c4 = C / 4, NP = C / 8;
  const int H = plan.halo, tb = plan.tb, L = tb + 2 * H;
  const int n_slabs = plan_slabs(plan) * NSL;
  constexpr int lead = NSLOT - 2;
  extern __shared__ __align__(128) unsigned char smem32[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem32);   // slab landed
  uint64_t* empty = full + NSLOT;      // every warpgroup done with the slot
  float* ring = reinterpret_cast<float*>(smem32 + barrier_bytes(NSLOT));
  float* Y = ring + NSLOT * SLAB;      // the branch state y
  float* Z = Y + L * S;                // the dilated conv's sum, leaky(t)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;   // warpgroup, warp in it
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * tb - H;   // sequence row of strip row 0
  const float* xb = x + static_cast<size_t>(b) * T * C;
  float* ob = out + static_cast<size_t>(b) * T * C;

  for (int j = tid; j < NSLOT; j += THREADS) {
    mbar_init(full + j, 1);
    mbar_init(empty + j, NWG);
  }
  mbar_fence_init();
  __syncthreads();
  // the first `lead` slabs, before any product is in flight
  if (tid == 0)
    for (int j = 0; j < lead && j < n_slabs; ++j)
      bulk_load_1d(ring + j * SLAB, wk + static_cast<size_t>(j) * SLAB,
                   4 * SLAB, full + j, true);
  // then the next slab q into slot qs (its use qp-th mod 2), once every
  // warpgroup has released the slot's previous slab q - NSLOT: all threads
  // wait, thread 0 copies (a predicate, so no divergent path sits among the
  // wgmmas)
  int q = lead, qs = lead % NSLOT;
  uint32_t qp = (lead / NSLOT) & 1;
  auto issue = [&]() {
    if (q >= n_slabs) return;
    mbar_wait(empty + qs, qp ^ 1);
    bulk_load_1d(ring + qs * SLAB, wk + static_cast<size_t>(q) * SLAB,
                 4 * SLAB, full + qs, tid == 0);
    ++q;
    if (++qs == NSLOT) qs = 0, qp ^= 1;
  };
  // one thread of each warpgroup releases its slots
  const bool releaser = (tid & 127) == 0;
  const uint32_t ring_s = smem_u32(ring);

  float acc[R][C / 2];
  uint32_t ah[R][4], al[R][4];
  int roff[R][2];
  int ss = 0;         // the slot of the slab in use, across convs and
  uint32_t sp = 0;    // branches, and its use mod 2
  int boff = 0;       // bias offset of the current conv
  for (int br = 0; br < plan.nb; ++br) {
    const int K = plan.k[br];
    int rem = 0;
    for (int p = 0; p < plan.np[br]; ++p)
      rem += (K - 1) * plan.d[br][p] / 2 + (K - 1) / 2;

    // the rows this branch needs, [H - rem, H + tb + rem), from x (zero
    // outside [0, T)); the previous branch's last conv ended on a barrier
    {
      const int lo = H - rem, n = tb + 2 * rem;
      for (int idx = tid; idx < n * c4; idx += THREADS) {
        const int r = lo + idx / c4, qd = idx % c4;
        const int tt = g0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (tt >= 0 && tt < T)
          v = __ldg(reinterpret_cast<const float4*>(
                        xb + static_cast<size_t>(tt) * C) + qd);
        *reinterpret_cast<float4*>(Y + r * S + 4 * qd) = v;
      }
    }
    __syncthreads();

    for (int p = 0; p < plan.np[br]; ++p) {
      const int d = plan.d[br][p];
      const int p1 = (K - 1) * d / 2, p2 = (K - 1) / 2;
#pragma unroll 1
      for (int cv = 0; cv < 2; ++cv) {
        const int dil = cv ? 1 : d, pad = cv ? p2 : p1;
        if (cv) rem -= p1 + p2;
        const int lo = cv ? H - rem : H - rem + p1;
        const int hi = cv ? H + tb + rem : H + tb + rem - p1;
        // the dilated conv reads leaky(y) from Y, the plain one leaky(t)
        // from Z as it is
        const float* src = cv ? Z : Y;
        const bool leaky_in = cv == 0;
        // every unit's sum starts at the bias
#pragma unroll
        for (int i = 0; i < C / 2; i += 2) {
          const int co = 8 * (i / 4) + 2 * t;
          const float b0 = __ldg(bias + boff + co);
          const float b1 = __ldg(bias + boff + co + 1);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][i] = b0;
            acc[r][i + 1] = b1;
          }
        }
        // a round (one unit per warpgroup) runs while its first unit has
        // rows, so n rounds, a number the whole block agrees on (ptxas
        // serializes wgmmas on a divergent path); a later warpgroup's unit
        // past hi reads the conv's last row, and its sums are not stored
        const int n = min(R, (hi - lo + NWG * UNIT_ROWS - 1) /
                                 (NWG * UNIT_ROWS));
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            roff[r][h] = min(lo + (wg + r * NWG) * UNIT_ROWS + 16 * wl +
                                 8 * h + g, hi - 1) * S + 2 * t;
        // from three units on, the first fragment comes ahead of the loop
        if (n >= 3) {
          if (leaky_in)
            load_frag<true>(ah[0], al[0], src - pad * S, roff[0]);
          else
            load_frag<false>(ah[0], al[0], src - pad * S, roff[0]);
        }
        int prev = 0;       // the slot of the previous slab
#pragma unroll 1
        for (int tap = 0; tap < K; ++tap) {
          const float* zt = src + (tap * dil - pad) * S;
          // the next tap's rows (this tap's at the conv's last)
          const float* zu = tap + 1 < K ? zt + dil * S : zt;
          // a later group of taps starts its partial from zero
          const int fresh = tap % TG == 0 && tap > 0;
#pragma unroll 1
          for (int sl = 0; sl < NSL; ++sl) {
            // the slab `lead` ahead; its slot's last reader, the slab two
            // before this one, was released after the previous slab
            issue();
            mbar_wait(full + ss, sp);
            // slab sl: input channels 8 KSL sl on; the next slab's rows
            // follow
            slab_rounds<R, R, C, KSL>(
                n, leaky_in, acc, ah, al, zt + 8 * KSL * sl,
                sl + 1 < NSL ? zt + 8 * KSL * (sl + 1) : zu, roff,
                ring_s + ss * SLAB * 4, !(fresh && sl == 0));
            // the previous slab's products are done
            mbar_arrive_if(empty + prev, releaser && (tap > 0 || sl > 0));
            prev = ss;
            if (++ss == NSLOT) ss = 0, sp ^= 1;
          }
          if (tap % TG != TG - 1 && tap != K - 1) continue;

          // a sum or, above C = 64, a partial is done: the epilogue on the
          // rows this thread owns (rows past hi are not stored). The
          // dilated conv sums into Z and leaves leaky(t) there, t zero
          // outside [0, T); the plain conv adds its partials to y on the
          // rows of [0, T) and, on the branch's last pair, folds y into out
          wg_wait<0>();
#pragma unroll
          for (int r = 0; r < R; ++r) reg_fence(acc[r]);
          reg_fence(ah);
          reg_fence(al);
          const bool first = tap < TG, end = tap == K - 1;
          const bool fold = end && cv == 1 && p == plan.np[br] - 1;
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
              // the row's C / 8 pairs: j holds channels 8j + 2t, 8j + 2t + 1
              // (accumulators 2h + 4j, 2h + 4j + 1)
              float2 v[NP];
#pragma unroll
              for (int j = 0; j < NP; ++j)
                v[j] = make_float2(acc[r][2 * h + 4 * j],
                                   acc[r][2 * h + 4 * j + 1]);
              if (cv == 0) {
                float2* zr = reinterpret_cast<float2*>(Z + row * S + 2 * t);
                if (!first) {   // every load before the stores
                  float2 z[NP];
#pragma unroll
                  for (int j = 0; j < NP; ++j) z[j] = zr[4 * j];
#pragma unroll
                  for (int j = 0; j < NP; ++j)
                    v[j] = make_float2(z[j].x + v[j].x, z[j].y + v[j].y);
                }
                if (end) {
#pragma unroll
                  for (int j = 0; j < NP; ++j)
                    v[j] = valid ? make_float2(leaky(v[j].x), leaky(v[j].y))
                                 : make_float2(0.f, 0.f);
                }
#pragma unroll
                for (int j = 0; j < NP; ++j) zr[4 * j] = v[j];
                continue;
              }
              if (!valid) continue;
              float2* yr = reinterpret_cast<float2*>(Y + row * S + 2 * t);
              float2 y[NP];
#pragma unroll
              for (int j = 0; j < NP; ++j) y[j] = yr[4 * j];
#pragma unroll
              for (int j = 0; j < NP; ++j) {
                y[j].x += v[j].x;
                y[j].y += v[j].y;
                yr[4 * j] = y[j];
              }
              if (!fold) continue;   // rows [H, H + tb) by construction
              float2* o = reinterpret_cast<float2*>(
                  ob + static_cast<size_t>(tt) * C + 2 * t);
#pragma unroll
              for (int j = 0; j < NP; ++j) {
                float2 m = y[j];
                if (br > 0) {
                  const float2 prior = o[4 * j];
                  m.x = prior.x + m.x;
                  m.y = prior.y + m.y;
                }
                if (br == plan.nb - 1) {
                  m.x *= 1.0f / plan.nb;
                  m.y *= 1.0f / plan.nb;
                }
                o[4 * j] = m;
              }
            }
          }
        }
        mbar_arrive_if(empty + prev, releaser);   // the conv's last slab
        boff += C;
        // Z (the dilated conv's leaky(t)) or Y (the plain conv's y) is
        // complete before the next conv reads it, and no one reads the
        // strip the next conv writes
        __syncthreads();
      }
    }
  }
}

// shared memory of a float32 launch: the barriers, the weight slots and the
// two strips
size_t smem_bytes(int tb, int halo, int C) {
  const int nslot = slots32(C);
  return barrier_bytes(nslot) +
         64 * static_cast<size_t>(nslot) * C * slab_ksteps(C) +
         8 * static_cast<size_t>(tb + 2 * halo) * strip_stride(C);
}

template <int CT>
int launch(const float* x, const float* wk, const float* bias, float* out,
           int B, int T, const Plan& plan, cudaStream_t stream) {
  const int rows = plan.tb + 2 * plan.halo;
  if ((rows + UNIT_ROWS - 1) / UNIT_ROWS > warpgroups32(CT) * rounds32(CT))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(plan.tb, plan.halo, CT);
  cudaError_t err = cudaFuncSetAttribute(
      mrf_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + plan.tb - 1) / plan.tb, B);
  mrf_kernel<CT><<<grid, 128 * warpgroups32(CT), bytes, stream>>>(
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
  if (!make_plan(plan, n_branch, kernel_sizes, n_pairs, dilations, halo, tb) ||
      smem_bytes(tb, halo, C) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define F32_CASE(c) \
  case c: return launch<c>(x, wk, bias, out, B, T, plan, s);
    F32_CASE(8) F32_CASE(16) F32_CASE(24) F32_CASE(32) F32_CASE(40)
    F32_CASE(48) F32_CASE(56) F32_CASE(64) F32_CASE(72) F32_CASE(80)
    F32_CASE(88) F32_CASE(96) F32_CASE(104) F32_CASE(112) F32_CASE(120)
#undef F32_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fused_mrf_bf16(const void* x, const void* wk, const void* bias,
                              void* out, int B, int T, int C, int n_branch,
                              const int* kernel_sizes, const int* n_pairs,
                              const int* dilations, int halo, int tb,
                              void* stream) {
  if (n_branch < 1 || n_branch > MAXB || C % 8 != 0 || C < 8 || C > MAX_C ||
      tb < 16 || halo < 0 || B < 1 || B > 65535 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  if (!make_plan(plan, n_branch, kernel_sizes, n_pairs, dilations, halo, tb) ||
      smem_bytes_bf16(tb, halo, C, plan_slabs(plan)) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(wk);
  const auto* bb = static_cast<const __nv_bfloat16*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define BF16_CASE(c) \
  case c: return launch_bf16<c>(xb, wb, bb, o, B, T, plan, s);
    BF16_CASE(8) BF16_CASE(16) BF16_CASE(24) BF16_CASE(32) BF16_CASE(40)
    BF16_CASE(48) BF16_CASE(56) BF16_CASE(64) BF16_CASE(72) BF16_CASE(80)
    BF16_CASE(88) BF16_CASE(96) BF16_CASE(104) BF16_CASE(112) BF16_CASE(120)
#undef BF16_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
