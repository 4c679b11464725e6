// Flash attention with attention-weight dropout for Hopper (sm_90a): the
// forward, dQ and dK/dV kernels of TTE training, and the keep mask.
//
// Replaces (parrot_tts_tpu/ops/flash_dropout.py):
//   flash_dropout_fwd        <- _forward -> _fwd_kernel   (flash_dropout.py:87)
//   flash_dropout_dq         <- _backward -> _dq_kernel   (flash_dropout.py:173)
//   flash_dropout_dkv        <- _backward -> _dkv_kernel  (flash_dropout.py:207)
//   flash_dropout_keep_mask  <- dump_keep_mask             (flash_dropout.py:362)
//
// Math per (b, h), M the keep mask, c = 1/(1-p):
//   S = scale * Q K^T + bias   (bias 0 / -1e30 per key)
//   P = exp(S - lse),  lse = rowmax(S) + log(rowsum(exp(S - rowmax)))
//   O = (M.P.c) V;  D = rowsum(dO.O);  dPd = M.(dO V^T).c;
//   dS = P.(dPd - D);   dQ = scale dS K;  dK = scale dS^T Q;  dV = (M.P.c)^T dO
// Every operand of the five products is rounded to bf16 (round to nearest
// even) and every product is summed in float32 on the tensor cores, as the
// JAX package's `_dot` does.
//
// Keep mask: element (bh, i, j) keeps iff word j%4 of Philox4x32-10, key
// (seed lo, seed hi), counter (j/4, i, bh + bh_offset, 0), is >= threshold
// (bh_offset: a data-parallel shard's first global row times H, so shards
// draw rows of one batch-wide mask). It depends on (seed, global bh, i, j)
// alone, so the forward and dQ kernels draw the same
// mask under their tilings, and so do the keep-mask kernel and the plain
// torch version (ops/flash_dropout.py::keep_mask_reference). One Philox call
// gives the words of four neighbouring keys; the two lanes of an m16n8
// accumulator fragment that share a call each make one and trade words
// with a shuffle, so no word is drawn twice. The dQ kernel, which runs
// first in the backward, also writes the mask as bits (bit j%32 of word
// j/32 of query row i, (BH, T, ceil(T/32)) uint32, ops/flash_dropout.py::
// pack_keep_bits); the dK/dV kernel reads them and runs no Philox.
//
// Bounds on this card: the forward does 4, dQ 6 and dK/dV 8 * B*H*T^2*d
// operations against 10 (forward: bf16 Q, K, V in, float32 O out), 20 and
// 16 * B*H*T*d bytes (bf16 operands; float32 dO, O and outputs), so above
// T ~ 750 (forward), ~1000 (dQ) and ~600 (dK/dV) all three are bound by
// the tensor cores, whose full bf16 rate only wgmma reaches; the dropout
// adds Philox4x32-10 integer work (one call of 10 multiply-high rounds per
// 4 scores) that competes with the elementwise work for issue slots. The
// design, shared by the three:
//   - bf16 operands in device memory: the autograd function casts Q, K and
//     V to bf16 once in the forward (ops/flash_dropout.py::to_bf16, round to
//     nearest even, as pack_bf16) and saves that copy; the backward casts
//     dO. Every kernel reads those copies: half the bytes of float32,
//     nothing converted. dQ also reads float32 dO and O for D.
//   - one warpgroup (128 threads) per block owns 64 rows (forward and dQ:
//     queries, dK/dV: keys) and walks the other side in 64-row tiles. Every
//     tile is in shared memory as 64 x 64 bf16 blocks in the 128-byte
//     swizzle, which TMA writes and wgmma reads without bank conflicts.
//   - asynchronous copies: thread 0 loads each tile by TMA
//     (cp.async.bulk.tensor, 3-d map (D, T, BH), rows past T read as 0)
//     into a ring with mbarrier completion: the backward's has two stages
//     (tile n+2 is in flight while tile n is multiplied), the forward's
//     four one-tile slots (pass 1: the next two K tiles in flight; pass 2:
//     the next tile's K and V). The backward's key bias (dQ) or lse and D
//     (dK/dV), 64 floats each at any alignment, come by 4-byte cp.async,
//     zero past T, waited one tile ahead of their use; the forward reads
//     each lane's 16 bias values of a tile into registers while the tile's
//     products run.
//   - overlap in the forward: pass 1 issues two tiles' scores at once and
//     takes the first one's row max while the second's run; pass 2 issues
//     S_j with P_{j-1} V_{j-1}, draws tile j's keep mask while both run
//     and takes S_j's exponentials while P_{j-1} V_{j-1} runs.
//   - products: S = Q K^T and dP = dO V^T (dK/dV: S^T = K Q^T, dP^T =
//     V dO^T) are m64n64k16 wgmma with both operands in shared memory,
//     K-major. O += Pd V, dQ += dS K, dV += Pd^T dO and dK += dS^T Q take A
//     from registers (the accumulator re-packed to bf16 pairs; a wgmma
//     accumulator has the m16n8 layout per warp) and read the tile as an
//     MN-major B (m64n{D}k16), so one copy of a tile serves both products.
//   - the forward's two passes: the first walks K alone and keeps each
//     row's max of S; the second walks K and V, so P's bf16 operand is
//     exp(S - final row max), the value the plain version rounds (to a few
//     float32 ulp: __expf), and the row sum adds the same exponentials.
//     The kernel then differs from the plain version only where a float32
//     sum in another order or those ulps move a P to the other bf16
//     neighbour (phase 10 of chip_smoke.py holds O to an rms difference of
//     1e-4 of rms(O)); a single pass against the running max would round
//     every P at other points. The price is one more Q K^T per tile (6
//     instead of 4 * B*H*T^2*d).
//   - one Philox pass per step: the forward and dQ draw the mask; dQ also
//     writes its bits and dK/dV reads 4 bytes per (query, 32 keys) instead,
//     staged in shared memory by cp.async with the tile's lse and D. The
//     forward and dQ draw a tile's mask into one register of 32 bits (dQ
//     also stores its bits) after issuing the tile's score products and
//     before waiting for them, so the Philox work runs beside the tensor
//     cores. (Reading dK/dV's bits the same way made dK/dV 8% slower, at
//     p = 0 too; PERF.md has the measurement.)
//   - no atomics: each block writes its own rows of O and lse (dQ and D;
//     dK and dV), so two runs give the same bits.
// Two blocks (8 warps, ~81 KB of shared memory each for the forward, ~97
// KB for the backward at d = 128) share an SM, so one block's elementwise
// work can overlap the other's products. (Two warpgroups per block taking
// turns at the score products, as FA3 does, measured no faster in the
// backward on this card, PERF.md has the numbers; a forward block of two
// warpgroups sharing each K and V tile was no faster either.)
//
// Any T (rows past T read as zero and are not stored; a score of a key or
// query past T gets P = 0); d_head 64 or 128.
//
// Interface (plain C, loaded with ctypes; every function returns the CUDA
// error of its launch, 0 on success; tensors contiguous):
//   flash_dropout_fwd(q16, k16, v16, bias, o (out), lse (out), B, H, T, D,
//                     scale, threshold, keep_scale, seed_lo, seed_hi,
//                     bh_offset, stream)
//   flash_dropout_dq(q16, k16, v16, do16, bias, do, o, lse, delta (out),
//                    dq (out), bits (out), B, H, T, D, ...)
//   flash_dropout_dkv(q16, k16, v16, do16, bias, lse, delta, bits,
//                     dk (out), dv (out), B, H, T, D, ...)
//       q16, k16, v16, do16: bf16 (B, H, T, D), 16-byte aligned (TMA); do,
//       o, dq, dk, dv float32 (B, H, T, D); bias (B, T), lse and delta =
//       D = rowsum(dO.O) (B, H, T) float32 (the forward writes lse, dQ
//       computes D for its rows);
//       bits (B*H, T, ceil(T/32)) uint32, written by dQ and read by dK/dV
//       when threshold != 0 (else unused, may be null).
//   flash_dropout_keep_mask(out (BH, T, T) int32, BH, T, threshold,
//                           seed_lo, seed_hi, bh_offset, stream)
// threshold 0 skips the mask (p = 0).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps (one warpgroup), 16 rows each

struct Seed {
  uint32_t threshold;
  float keep_scale;
  uint32_t lo, hi;
  uint32_t bh0;  // global (batch, head) row of this launch's first
};

__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// Keep words of one m16n8 accumulator tile whose rows are QUERIES and
// columns KEYS: element e of this lane is (row g + 8*(e/2), key col
// 2t + e%2). Keys col0 .. col0+7 (col0 % 8 == 0), rows row0 .. row0+15.
// Lanes t and t^1 share a Philox block (4 consecutive keys); the even one
// draws row g's, the odd one row g+8's, and they swap halves.
__device__ __forceinline__ void keep_rows_q(uint32_t out[4], const Seed& sd,
                                            uint32_t bh, int row0, int col0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool even = (t & 1) == 0;
  const uint32_t j4 = static_cast<uint32_t>(col0 / 4 + (t >> 1));
  const uint32_t i = static_cast<uint32_t>(row0 + g + (even ? 0 : 8));
  const uint4 w = philox(j4, i, bh + sd.bh0, 0u, sd.lo, sd.hi);
  const uint32_t s0 = even ? w.z : w.x, s1 = even ? w.w : w.y;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (even) {
    out[0] = w.x; out[1] = w.y; out[2] = r0; out[3] = r1;
  } else {
    out[0] = r0; out[1] = r1; out[2] = w.z; out[3] = w.w;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// TMA tile copies, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int TILE = 64;             // rows of every tile
constexpr int STAGES = 2;            // copy ring of the walked side
constexpr int BLK = TILE * 64 * 2;   // bytes of one 64 x 64 bf16 swizzle block
constexpr int SIDE = TILE * 4;       // bytes of a tile's float32 row values
constexpr int WORDS = TILE * 2;      // dK/dV: keep words of a tile (64 x 64)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// arrive and expect `bytes` of copies on the barrier's current phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase with this parity; a copy
// that never lands traps (an error for the caller) instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// one 64 x 64 box of a (BH, T, D) bf16 map: columns c0.., rows row0.., bh
__device__ __forceinline__ void tma_box(unsigned char* dst,
                                        const CUtensorMap* map, uint64_t* bar,
                                        int c0, int row0, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(row0), "r"(bh)
      : "memory");
}

// rows row0 .. row0+63 of head bh as D/64 swizzle blocks
template <int D>
__device__ __forceinline__ void tma_rows(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row0, int bh) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_box(dst + c * BLK, map, bar, c * 64, row0, bh);
}

// a tile's float32 row values (bias, lse, D): element n of row 0.. of a
// (rows, T) array into dst[threadIdx.x] for the first TILE threads, zero
// past T, by a 4-byte cp.async (any T: no alignment asked of the source)
__device__ __forceinline__ void side_copy(float* dst, const float* row,
                                          int j0, int T) {
  if (threadIdx.x < TILE) {
    const int j = j0 + threadIdx.x;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst + threadIdx.x)),
                    "l"(row + (j < T ? j : 0)), "r"(j < T ? 4 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void side_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void side_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of d above the wgmma wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma descriptor of a bf16 operand in the 128-byte swizzle (layout 1):
// start address, leading and stride byte offsets
__device__ __forceinline__ uint64_t sdesc(const unsigned char* p,
                                          uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// a 64-row tile read K-major (the contraction runs along d): k16 step kk
// is 32 bytes into swizzle block kk/4; 8-row groups are 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile,
                                           int kk) {
  return sdesc(tile + (kk >> 2) * BLK + (kk & 3) * 32, 16, 1024);
}
// the same tile read MN-major as B (the contraction runs along its rows,
// N along d): k16 step kk starts 16 rows down; the next 64 columns are the
// next swizzle block (leading offset), the next 8 rows 1024 bytes on
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile,
                                            int kk) {
  return sdesc(tile + kk * 2048, BLK, 1024);
}

// d (+)= A B for one k16 step of a 64-row warpgroup tile, A and B bf16
// in shared memory (descriptors), both K-major; ScaleD 0 overwrites d
template <int ScaleD>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(ScaleD));
}

// d += A B for one k16 step, A (4 bf16 pairs per thread, the accumulator
// layout) from registers, B MN-major in shared memory (N = 64)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for one k16 step, A (4 bf16 pairs per thread, the accumulator
// layout) from registers, B MN-major in shared memory (N = 128)
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) wgmma_rs64(d, a, db);
  else wgmma_rs128(d, a, db);
}

// s = A B^T over d (both 64-row tiles K-major): D/16 steps, the first
// overwriting s
template <int D>
__device__ __forceinline__ void scores(float (&s)[32],
                                       const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if (kk == 0) wgmma_ss64<0>(s, desc_k(a, kk), desc_k(b, kk));
    else wgmma_ss64<1>(s, desc_k(a, kk), desc_k(b, kk));
  }
}

// acc += A (64 x 64, registers) * tile (64 rows x D, MN-major)
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2],
                                           const uint32_t (&a)[4][4],
                                           const unsigned char* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], desc_mn(tile, kk));
}

// the (64 x 64) tile's elements of chunk nt as the A operand of k16 step
// nt/2: this lane's (row g, cols 2t, 2t+1) and (row g+8, the same)
__device__ __forceinline__ void put_a(uint32_t (&a)[4][4], int nt,
                                     const float (&x)[4]) {
  a[nt >> 1][(nt & 1) * 2] = pack_bf16(x[0], x[1]);
  a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
}

template <int D>
struct BwdSmem {
  // the block's two 64-row operands, a ring of two tiles of two operands,
  // a ring of two (dQ: bias; dK/dV: lse, D and keep words) tile side
  // values, barriers
  static constexpr int kTile = TILE * D * 2;
  static constexpr int kOwn = 0, kRing = 2 * kTile, kSide = 6 * kTile;
  static constexpr int kBars = kSide + STAGES * (2 * SIDE + 4 * WORDS);
  static constexpr size_t bytes = kBars + 3 * sizeof(uint64_t) + 1024;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// forward: block = 64 queries of one (b, h); two passes over 64-key tiles
// ---------------------------------------------------------------------------

constexpr int SLOTS = 4;   // forward: tiles in its copy ring

template <int D>
struct FwdSmem {
  // the block's Q, a ring of four 64-row tiles (pass 1: K tiles; pass 2:
  // the K and V of each tile in consecutive slots), barriers
  static constexpr int kTile = TILE * D * 2;
  static constexpr int kQ = 0, kRing = kTile;
  static constexpr int kBars = kRing + SLOTS * kTile;
  static constexpr size_t bytes = kBars + (1 + SLOTS) * sizeof(uint64_t) + 1024;
};

// the keep mask of this lane's elements of a 64 x 64 score tile (queries
// row0 + 0..15 of this warp, keys k0..): bit 4*nt + e is accumulator
// element (nt, e)
__device__ __forceinline__ uint32_t tile_keep(const Seed& sd, uint32_t bh,
                                              int row0, int k0, int lane) {
  uint32_t kmask = 0u;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    uint32_t keep[4];
    keep_rows_q(keep, sd, bh, row0, k0 + nt * 8, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      kmask |= static_cast<uint32_t>(keep[e] >= sd.threshold) << (4 * nt + e);
  }
  return kmask;
}

// wait until at most N committed wgmma groups are pending (they complete
// in order)
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// The forward walks K twice, through one ring of SLOTS tile copies in the
// order of a sequence of loads: load L < n_tiles is K tile L (pass 1),
// then load n_tiles + 2j is K tile j and n_tiles + 2j + 1 is V tile j
// (pass 2). Load L goes to slot L % SLOTS, whose barrier completes its
// (L / SLOTS)-th phase, and load L + SLOTS is issued when every warp is
// done with load L. The products overlap the elementwise work: pass 1
// issues two tiles' scores and takes the first one's max while the second
// runs; pass 2 issues S_j and P_{j-1} V_{j-1} together, draws tile j's
// mask while both run and takes S_j's exponentials while P_{j-1} V_{j-1}
// runs. Every wgmma is waited for in the iteration that issued it (FA3's
// order), so no accumulator is in flight across the loop.
template <int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const float* __restrict__ bias, float* __restrict__ o,
           float* __restrict__ lse, int H, int T, float scale, Seed sd) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  unsigned char* Qs = sm + L::kQ;
  unsigned char* ring = sm + L::kRing;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * TILE, wr = warp * 16;
  const int n_tiles = (T + TILE - 1) / TILE;
  const int n_loads = 3 * n_tiles;
  const float* bias_b = bias + static_cast<size_t>(b) * T;
  const bool drop = sd.threshold != 0u;

  auto slot = [&](int l) { return ring + (l % SLOTS) * L::kTile; };
  auto load = [&](int l) {   // thread 0
    if (l >= n_loads) return;
    const int i = l - n_tiles;
    const CUtensorMap* map = l < n_tiles || (i & 1) == 0 ? &tk : &tv;
    uint64_t* bar = &bars[1 + l % SLOTS];
    mbar_expect(bar, L::kTile);
    tma_rows<D>(slot(l), map, bar, (l < n_tiles ? l : i >> 1) * TILE, bh);
  };
  auto wait_load = [&](int l) {
    mbar_wait(&bars[1 + l % SLOTS], (l / SLOTS) & 1);
  };
  // this lane's key bias of the tile at k0 (columns nt * 8 + 2t + e%2 of
  // the accumulator; -inf past T, so those keys get P = 0), read while the
  // tile's products run
  auto load_bias = [&](float (&bv)[16], int k0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = k0 + (i >> 1) * 8 + 2 * t + (i & 1);
      bv[i] = j < T ? __ldg(bias_b + j) : -INFINITY;
    }
  };
  // every warp is done with loads l0 and l1 (-1: none): thread 0 issues
  // the loads that take their slots
  auto release = [&](int l0, int l1) {
    __syncthreads();
    if (threadIdx.x == 0) {
      if (l0 >= 0) load(l0 + SLOTS);
      if (l1 >= 0) load(l1 + SLOTS);
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + SLOTS; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bars[0], L::kTile);
    tma_rows<D>(Qs, &tq, &bars[0], q0, bh);
    for (int l = 0; l < SLOTS; ++l) load(l);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(&bars[0], 0);

  // pass 1: the row max of S, two tiles at a time: the second tile's
  // scores run while the first tile's max is taken
  auto row_max = [&](const float (&sc)[32], const float (&bv)[16]) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mt = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 2 * h2; e < 2 * h2 + 2; ++e)
          mt = fmaxf(mt, fmaf(sc[4 * nt + e], scale, bv[2 * nt + (e & 1)]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      m[h2] = fmaxf(m[h2], mt);   // finite: key 0 < T exists
    }
  };
  // (the loops issue and wait for the same wgmma groups in every
  // iteration, so the compiler can tell which accumulators are in flight;
  // the uneven ends are peeled)
  int n = 0;
  for (; n + 1 < n_tiles; n += 2) {
    float sa[32], sb[32], ba[16], bb[16];
    wait_load(n);
    wg_fence();
    scores<D>(sa, Qs, slot(n));
    wg_commit();
    wait_load(n + 1);
    wg_fence();
    scores<D>(sb, Qs, slot(n + 1));
    wg_commit();
    load_bias(ba, n * TILE);
    load_bias(bb, (n + 1) * TILE);
    wg_wait<1>();
    reg_fence(sa);
    row_max(sa, ba);
    wg_wait<0>();
    reg_fence(sb);
    row_max(sb, bb);
    release(n, n + 1);
  }
  if (n < n_tiles) {
    float sa[32], ba[16];
    wait_load(n);
    wg_fence();
    scores<D>(sa, Qs, slot(n));
    wg_commit();
    load_bias(ba, n * TILE);
    wg_wait<0>();
    reg_fence(sa);
    row_max(sa, ba);
    release(n, -1);
  }

  // pass 2: O = (M . exp(S - m) . c) V and the row sum of exp(S - m).
  // Tile j: issue S_j and then P_{j-1} V_{j-1}; draw tile j's mask while
  // both run; wait for S_j and take its exponentials while P_{j-1} V_{j-1}
  // runs; wait for it, free K_j's and V_{j-1}'s slots, and make P_j, the
  // A operand of the next P V, from the exponentials.
  uint32_t af[4][4];
  auto exps = [&](float (&sc)[32], const float (&bv)[16], uint32_t kmask) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = i & 3;
      // __expf (ex2.approx of x log2 e): a few ulp from expf, so a rare P
      // rounds to the other bf16 neighbour, as float32 sums in another
      // order make it do, for about half the instructions of expf
      float p = __expf(fmaf(sc[i], scale, bv[2 * (i >> 2) + (e & 1)]) -
                       m[e >> 1]);
      l[e >> 1] += p;
      if (drop) p = (kmask >> i) & 1u ? p * sd.keep_scale : 0.f;
      sc[i] = p;
    }
  };
  auto pack = [&](const float (&sc)[32]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float x[4] = {sc[4 * nt], sc[4 * nt + 1], sc[4 * nt + 2],
                          sc[4 * nt + 3]};
      put_a(af, nt, x);
    }
  };
  auto keep = [&](int j) {
    uint32_t kmask = drop ? tile_keep(sd, bh, q0 + wr, j * TILE, lane) : 0u;
    asm volatile("" : "+r"(kmask));   // drawn before the wait, not after
    return kmask;
  };
  {
    float sc[32], bv[16];
    wait_load(n_tiles);
    wg_fence();
    scores<D>(sc, Qs, slot(n_tiles));
    wg_commit();
    load_bias(bv, 0);
    const uint32_t kmask = keep(0);
    wg_wait<0>();
    reg_fence(sc);
    exps(sc, bv, kmask);
    release(n_tiles, -1);
    pack(sc);
  }
  for (int j = 1; j < n_tiles; ++j) {
    const int lk = n_tiles + 2 * j;   // loads of K_j and V_j: lk, lk + 1
    float sc[32], bv[16];
    wait_load(lk);
    wg_fence();
    scores<D>(sc, Qs, slot(lk));
    wg_commit();
    wait_load(lk - 1);
    wg_fence();
    accumulate<D>(acc, af, slot(lk - 1));
    wg_commit();
    load_bias(bv, j * TILE);
    const uint32_t kmask = keep(j);
    wg_wait<1>();
    reg_fence(sc);
    exps(sc, bv, kmask);
    wg_wait<0>();
    release(lk, lk - 1);
    pack(sc);
  }
  wait_load(n_loads - 1);
  wg_fence();
  accumulate<D>(acc, af, slot(n_loads - 1));
  wg_commit();
  wg_wait<0>();
  reg_fence(acc);

  float* og = o + static_cast<size_t>(bh) * T * D;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
    const int row = q0 + wr + g + 8 * h2;
    if (row >= T) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float2 x = make_float2(acc[4 * dt + 2 * h2] / l[h2],
                                   acc[4 * dt + 2 * h2 + 1] / l[h2]);
      *reinterpret_cast<float2*>(og + static_cast<size_t>(row) * D + dt * 8 + 2 * t) = x;
    }
    if (t == 0) lse[static_cast<size_t>(bh) * T + row] = m[h2] + logf(l[h2]);
  }
}

// ---------------------------------------------------------------------------
// dQ: block = 64 queries of one (b, h); walks 64-key tiles
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ bias, const float* __restrict__ dout,
          const float* __restrict__ o, const float* __restrict__ lse,
          float* __restrict__ delta, float* __restrict__ dq,
          uint32_t* __restrict__ bits, int H, int T, float scale, Seed sd) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  unsigned char* Qs = sm + L::kOwn;
  unsigned char* dOs = Qs + L::kTile;
  unsigned char* Ks = sm + L::kRing;           // Ks[st] = Ks + st * kTile
  unsigned char* Vs = Ks + STAGES * L::kTile;
  float* bias_s = reinterpret_cast<float*>(sm + L::kSide);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * TILE, wr = warp * 16;
  const int n_tiles = (T + TILE - 1) / TILE;
  const int W = (T + 31) / 32;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* bias_b = bias + static_cast<size_t>(b) * T;
  const bool drop = sd.threshold != 0u;

  // tile n of K and V into stage st by TMA (thread 0); its key bias by
  // cp.async (every thread, waited before the barrier that ends the tile
  // before its use)
  auto load_kv = [&](int st, int n) {
    mbar_expect(&bars[1 + st], 2 * L::kTile);
    tma_rows<D>(Ks + st * L::kTile, &tk, &bars[1 + st], n * TILE, bh);
    tma_rows<D>(Vs + st * L::kTile, &tv, &bars[1 + st], n * TILE, bh);
  };
  auto load_side = [&](int st, int n) {
    side_copy(bias_s + st * TILE, bias_b, n * TILE, T);
    side_commit();
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int st = 0; st < STAGES && st < n_tiles; ++st) load_side(st, st);
  side_wait();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bars[0], 2 * L::kTile);
    tma_rows<D>(Qs, &tq, &bars[0], q0, bh);
    tma_rows<D>(dOs, &tdo, &bars[0], q0, bh);
    for (int st = 0; st < STAGES && st < n_tiles; ++st) load_kv(st, st);
  }

  // D = rowsum(dO . O) in float32 for this warp's 16 rows while the first
  // tiles land, one row per warp-wide reduction, written for dK/dV
  float lse_r[2], del_r[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + wr + g + 8 * h2;
    lse_r[h2] = row < T ? lse[static_cast<size_t>(bh) * T + row] : 0.f;
  }
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int row = q0 + wr + rr;
    float sum = 0.f;
    if (row < T) {
      const size_t off = base + static_cast<size_t>(row) * D;
      for (int c = 4 * lane; c < D; c += 128) {
        const float4 x = *reinterpret_cast<const float4*>(dout + off + c);
        const float4 y = *reinterpret_cast<const float4*>(o + off + c);
        sum += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (rr == g) del_r[0] = sum;
    if (rr == g + 8) del_r[1] = sum;
    if (lane == 0 && row < T) delta[static_cast<size_t>(bh) * T + row] = sum;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(&bars[0], 0);

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n & (STAGES - 1), k0 = n * TILE;
    const unsigned char* Kt = Ks + st * L::kTile;
    mbar_wait(&bars[1 + st], (n / STAGES) & 1);

    float s[32], dp[32];
    wg_fence();
    scores<D>(s, Qs, Kt);
    scores<D>(dp, dOs, Vs + st * L::kTile);
    wg_commit();
    // the tile's keep mask while the products run (bit 4*nt + e of kmask
    // is accumulator element (nt, e)), and its bits stored for dK/dV: the
    // quad's lanes hold disjoint bits of the same four words [row g / g+8]
    // [32 keys]; lane t stores word (row g + 8*(t/2), keys k0 + 32*(t%2) ..)
    uint32_t kmask = 0u;
    if (drop) {
      uint32_t words[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t keep[4];
        keep_rows_q(keep, sd, bh, q0 + wr, k0 + nt * 8, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t kp = keep[e] >= sd.threshold;
          kmask |= kp << (4 * nt + e);
          const int c = nt * 8 + 2 * t + (e & 1);
          words[e >> 1][nt >> 2] |= (kp & (k0 + c < T)) << ((nt & 3) * 8 + c % 8);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          words[r][w] |= __shfl_xor_sync(0xffffffffu, words[r][w], 1);
          words[r][w] |= __shfl_xor_sync(0xffffffffu, words[r][w], 2);
        }
      const int r = t >> 1, w = t & 1;
      const uint32_t mine = r ? (w ? words[1][1] : words[1][0])
                              : (w ? words[0][1] : words[0][0]);
      const int i = q0 + wr + g + 8 * r;
      if (i < T && k0 + 32 * w < T)
        bits[(static_cast<size_t>(bh) * T + i) * W + k0 / 32 + w] = mine;
    }
    asm volatile("" : "+r"(kmask));   // drawn before the wait, not after
    wg_wait_all();
    reg_fence(s);
    reg_fence(dp);

    const float* bs = bias_s + st * TILE;
    uint32_t af[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        // keys past T: exp(-inf) = 0, a select and no branch
        const float p = expf(k0 + c < T
                                 ? s[4 * nt + e] * scale + bs[c] - lse_r[e >> 1]
                                 : -INFINITY);
        float dpd = dp[4 * nt + e];
        if (drop)
          dpd = (kmask >> (4 * nt + e)) & 1u ? dpd * sd.keep_scale : 0.f;
        ds[e] = p * (dpd - del_r[e >> 1]);
      }
      put_a(af, nt, ds);
    }

    wg_fence();
    accumulate<D>(acc, af, Kt);
    wg_commit();
    wg_wait_all();
    reg_fence(acc);

    side_wait();       // tile n+1's bias has landed
    __syncthreads();   // ... for every thread; every warp is done with st
    if (n + STAGES < n_tiles) {
      if (threadIdx.x == 0) load_kv(st, n + STAGES);
      __syncwarp();
      load_side(st, n + STAGES);
    }
  }

  float* dqg = dq + base;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + wr + g + 8 * h2;
    if (row >= T) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      float2 x = make_float2(acc[4 * dt + 2 * h2] * scale,
                             acc[4 * dt + 2 * h2 + 1] * scale);
      *reinterpret_cast<float2*>(dqg + static_cast<size_t>(row) * D + dt * 8 + 2 * t) = x;
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: block = 64 keys of one (b, h); walks 64-query tiles
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tdo,
           const float* __restrict__ bias, const float* __restrict__ lse,
           const float* __restrict__ delta,
           const uint32_t* __restrict__ bits, float* __restrict__ dk,
           float* __restrict__ dv, int H, int T, float scale, Seed sd) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  unsigned char* Ks = sm + L::kOwn;
  unsigned char* Vs = Ks + L::kTile;
  unsigned char* Qs = sm + L::kRing;           // Qs[st] = Qs + st * kTile
  unsigned char* dOs = Qs + STAGES * L::kTile;
  float* lse_s = reinterpret_cast<float*>(sm + L::kSide);   // [st][64]
  float* del_s = lse_s + STAGES * TILE;                      // [st][64]
  uint32_t* kw_s = reinterpret_cast<uint32_t*>(del_s + STAGES * TILE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int j0 = blockIdx.x * TILE, wr = warp * 16;
  const int n_tiles = (T + TILE - 1) / TILE;
  const int W = (T + 31) / 32;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const bool drop = sd.threshold != 0u;

  // tile n of Q and dO into stage st by TMA (thread 0); its lse and D, and
  // under dropout its keep words, by cp.async, as in dQ. Thread x copies
  // word x%2 of this block's two (keys j0 .. j0+63) of query i0 + x/2:
  // kw_s[st][c][w] holds query i0 + c's bits of keys j0 + 32w ..
  auto load_q = [&](int st, int n) {
    mbar_expect(&bars[1 + st], 2 * L::kTile);
    tma_rows<D>(Qs + st * L::kTile, &tq, &bars[1 + st], n * TILE, bh);
    tma_rows<D>(dOs + st * L::kTile, &tdo, &bars[1 + st], n * TILE, bh);
  };
  auto load_side = [&](int st, int n) {
    const size_t row = static_cast<size_t>(bh) * T;
    side_copy(lse_s + st * TILE, lse + row, n * TILE, T);
    side_copy(del_s + st * TILE, delta + row, n * TILE, T);
    if (drop) {
      const int i = n * TILE + (threadIdx.x >> 1), w = threadIdx.x & 1;
      const bool ok = i < T && j0 + 32 * w < T;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(smem_u32(kw_s + st * WORDS + threadIdx.x)),
                      "l"(bits + (ok ? (row + i) * W + j0 / 32 + w : 0)),
                      "r"(ok ? 4 : 0)
                   : "memory");
    }
    side_commit();
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int st = 0; st < STAGES && st < n_tiles; ++st) load_side(st, st);
  side_wait();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bars[0], 2 * L::kTile);
    tma_rows<D>(Ks, &tk, &bars[0], j0, bh);
    tma_rows<D>(Vs, &tv, &bars[0], j0, bh);
    for (int st = 0; st < STAGES && st < n_tiles; ++st) load_q(st, st);
  }

  // this lane's key rows j0 + wr + g (+8): their bias, and their bits in
  // this warp's word (keys j0 + 32 * (warp / 2) ..) of each query
  float bias_r[2];
  bool key_ok[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int j = j0 + wr + g + 8 * h2;
    key_ok[h2] = j < T;
    bias_r[h2] = key_ok[h2] ? bias[static_cast<size_t>(b) * T + j] : 0.f;
  }
  const int bit0 = (wr & 31) + g;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(&bars[0], 0);

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n & (STAGES - 1), i0 = n * TILE;
    const unsigned char* Qt = Qs + st * L::kTile;
    const unsigned char* dOt = dOs + st * L::kTile;
    mbar_wait(&bars[1 + st], (n / STAGES) & 1);

    float s[32], dp[32];
    wg_fence();
    scores<D>(s, Ks, Qt);     // S^T = K Q^T
    scores<D>(dp, Vs, dOt);   // dP^T = V dO^T
    wg_commit();
    wg_wait_all();
    reg_fence(s);
    reg_fence(dp);

    const float* ls = lse_s + st * TILE;
    const float* dl = del_s + st * TILE;
    const uint32_t* kw = kw_s + st * WORDS + (warp >> 1);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float pd[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const float p =   // past T: exp(-inf) = 0, a select and no branch
            expf(key_ok[e >> 1] & (i0 + c < T)
                     ? s[4 * nt + e] * scale + bias_r[e >> 1] - ls[c]
                     : -INFINITY);
        float pdv = p, dpd = dp[4 * nt + e];
        if (drop) {
          const bool kp = (kw[2 * c] >> (bit0 + 8 * (e >> 1))) & 1u;
          pdv = kp ? p * sd.keep_scale : 0.f;
          dpd = kp ? dpd * sd.keep_scale : 0.f;
        }
        pd[e] = pdv;
        ds[e] = p * (dpd - dl[c]);   // dS^T
      }
      put_a(pa, nt, pd);
      put_a(da, nt, ds);
    }

    wg_fence();
    accumulate<D>(dv_acc, pa, dOt);   // dV += Pd^T dO
    accumulate<D>(dk_acc, da, Qt);    // dK += dS^T Q
    wg_commit();
    wg_wait_all();
    reg_fence(dv_acc);
    reg_fence(dk_acc);

    side_wait();       // tile n+1's lse and D have landed
    __syncthreads();   // ... for every thread; every warp is done with st
    if (n + STAGES < n_tiles) {
      if (threadIdx.x == 0) load_q(st, n + STAGES);
      __syncwarp();
      load_side(st, n + STAGES);
    }
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = j0 + wr + g + 8 * h2;
    if (row >= T) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const size_t off = base + static_cast<size_t>(row) * D + dt * 8 + 2 * t;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(dk_acc[4 * dt + 2 * h2] * scale,
                      dk_acc[4 * dt + 2 * h2 + 1] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dv_acc[4 * dt + 2 * h2], dv_acc[4 * dt + 2 * h2 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// keep mask: one thread per Philox block (bh, i, 4 keys)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
keep_mask_kernel(int* __restrict__ out, int T, uint32_t threshold,
                 uint32_t lo, uint32_t hi, uint32_t bh0) {
  const int n4 = (T + 3) / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(T) * n4) return;
  const int i = static_cast<int>(idx / n4), j4 = static_cast<int>(idx % n4);
  const uint32_t bh = blockIdx.y;
  const uint4 w = philox(static_cast<uint32_t>(j4), static_cast<uint32_t>(i),
                         bh + bh0, 0u, lo, hi);
  int* row = out + (static_cast<size_t>(bh) * T + i) * T;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j4 * 4 + e;
    if (j < T) row[j] = word(w, e) >= threshold ? 1 : 0;
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t bytes, dim3 grid, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

Seed make_seed(unsigned threshold, float keep_scale, unsigned lo, unsigned hi,
               unsigned bh0) {
  Seed s;
  s.threshold = threshold;
  s.keep_scale = keep_scale;
  s.lo = lo;
  s.hi = hi;
  s.bh0 = bh0;
  return s;
}

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the library
// links against nothing but the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (BH, T, D) bf16 tensor as 64 x 64 boxes in the 128-byte swizzle; rows
// past T read as zeros
bool rows_map(CUtensorMap* map, const void* x, int BH, int T, int D) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {64, TILE, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

// dout null: the forward, which reads no dO
bool make_maps(Maps* m, const void* q, const void* k, const void* v,
               const void* dout, int BH, int T, int D) {
  return rows_map(&m->q, q, BH, T, D) && rows_map(&m->k, k, BH, T, D) &&
         rows_map(&m->v, v, BH, T, D) &&
         (dout == nullptr || rows_map(&m->dout, dout, BH, T, D));
}

}  // namespace

extern "C" int flash_dropout_fwd(const void* q, const void* k, const void* v,
                                 const float* bias, float* o, float* lse,
                                 int B, int H, int T, int D, float scale,
                                 unsigned threshold, float keep_scale,
                                 unsigned seed_lo, unsigned seed_hi,
                                 unsigned bh_offset, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Seed sd = make_seed(threshold, keep_scale, seed_lo, seed_hi, bh_offset);
  Maps m;
  if ((D != 64 && D != 128) ||
      !make_maps(&m, q, k, v, nullptr, B * H, T, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  if (D == 64)
    return launch(fwd_kernel<64>, FwdSmem<64>::bytes, grid, s, m.q, m.k,
                  m.v, bias, o, lse, H, T, scale, sd);
  return launch(fwd_kernel<128>, FwdSmem<128>::bytes, grid, s, m.q, m.k,
                m.v, bias, o, lse, H, T, scale, sd);
}

extern "C" int flash_dropout_dq(const void* q, const void* k, const void* v,
                                const void* dout16, const float* bias,
                                const float* dout, const float* o,
                                const float* lse, float* delta, float* dq,
                                unsigned* bits, int B, int H, int T, int D,
                                float scale, unsigned threshold,
                                float keep_scale, unsigned seed_lo,
                                unsigned seed_hi, unsigned bh_offset,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Seed sd = make_seed(threshold, keep_scale, seed_lo, seed_hi, bh_offset);
  Maps m;
  if ((D != 64 && D != 128) || !make_maps(&m, q, k, v, dout16, B * H, T, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  if (D == 64)
    return launch(dq_kernel<64>, BwdSmem<64>::bytes, grid, s, m.q, m.k, m.v,
                  m.dout, bias, dout, o, lse, delta, dq, bits, H, T,
                  scale, sd);
  return launch(dq_kernel<128>, BwdSmem<128>::bytes, grid, s, m.q, m.k, m.v,
                m.dout, bias, dout, o, lse, delta, dq, bits, H, T,
                scale, sd);
}

extern "C" int flash_dropout_dkv(const void* q, const void* k, const void* v,
                                 const void* dout16, const float* bias,
                                 const float* lse, const float* delta,
                                 const unsigned* bits, float* dk, float* dv,
                                 int B, int H, int T, int D, float scale,
                                 unsigned threshold, float keep_scale,
                                 unsigned seed_lo, unsigned seed_hi,
                                 unsigned bh_offset, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Seed sd = make_seed(threshold, keep_scale, seed_lo, seed_hi, bh_offset);
  Maps m;
  if ((D != 64 && D != 128) || !make_maps(&m, q, k, v, dout16, B * H, T, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  if (D == 64)
    return launch(dkv_kernel<64>, BwdSmem<64>::bytes, grid, s, m.q, m.k, m.v,
                  m.dout, bias, lse, delta, bits, dk, dv, H, T,
                  scale, sd);
  return launch(dkv_kernel<128>, BwdSmem<128>::bytes, grid, s, m.q, m.k, m.v,
                m.dout, bias, lse, delta, bits, dk, dv, H, T, scale, sd);
}

extern "C" int flash_dropout_keep_mask(int* out, int BH, int T,
                                       unsigned threshold, unsigned seed_lo,
                                       unsigned seed_hi, unsigned bh_offset,
                                       void* stream) {
  const long long blocks_x =
      (static_cast<long long>(T) * ((T + 3) / 4) + 255) / 256;
  if (blocks_x > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_x), BH);
  keep_mask_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, T, threshold, seed_lo, seed_hi, bh_offset);
  return static_cast<int>(cudaGetLastError());
}
