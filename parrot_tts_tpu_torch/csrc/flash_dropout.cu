// Flash attention with attention-weight dropout for Hopper (sm_90a): the
// forward, dQ and dK/dV kernels of TTE training, and the keep mask they
// regenerate.
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
// even) and every product is summed in float32 on the tensor cores
// (mma.sync m16n8k16), as the JAX package's `_dot` does.
//
// Keep mask: element (bh, i, j) keeps iff word j%4 of Philox4x32-10, key
// (seed lo, seed hi), counter (j/4, i, bh, 0), is >= threshold. It depends
// on (seed, bh, i, j) alone, so all four kernels regenerate the same mask
// under their different tilings, and so does the plain torch version
// (ops/flash_dropout.py::keep_mask_reference). One Philox call gives the
// four words of four neighbouring keys; the two (fwd, dq: query rows) or
// four (dkv: key rows) lanes of an mma fragment that share a call each make
// one and trade words with shuffles, so no word is drawn twice.
//
// Bound on this card: 4 (fwd), 6 (dq) and 8 (dkv) * B*H*T^2*d operations
// on bf16 operands against 4 (fwd), 6 (dq) and 6 (dkv) * 4*B*H*T*d bytes,
// about T/4 operations per byte. Above T ~ 1200 that passes the card's
// ~295 (989 TFLOP/s dense bf16 over 3.35 TB/s): the decoder's lengths
// (2048, 3584) are bound by the tensor cores, the encoder's (128, 256) by
// bytes. The Philox integer work (one call of ~10 multiply-high rounds per
// 4 scores) competes with the products for instruction slots. What the
// design does about it: the (T, T) scores and the
// mask never reach device memory; each block keeps its 64 rows' operands in
// shared memory as bf16 (rows padded by 8 so fragment loads are free of
// bank conflicts) and walks the other side's 64-row (dkv: 32-row) tiles,
// each read from device memory once: the products that contract over a
// tile's rows (P V, dS K, Pd^T dO, dS^T Q) take their B operand from the
// same row-major tile with ldmatrix.trans.
// The forward takes two passes over K (row max and sum, then P V) so that
// P's bf16 operand is exp(S - final row max), the value the plain version
// rounds. The kernel then differs from the plain version only in the order
// of its float32 sums, which moves an operand to the other bf16 neighbour
// now and then, and phase 10 of chip_smoke.py can hold O to an rms
// difference of 1e-4 of rms(O), where a wrong tile, row or mask stream
// shows. A one-pass kernel rounds P against a running max, as the JAX
// kernel does, and so differs from the plain version by that rounding
// throughout: tests/test_torch_flash_dropout.py holds the JAX kernel to it
// only within 2e-3 of rms(O). The price is one more Q K^T per tile (1.5x
// the forward's products). No wgmma or TMA yet: a simple kernel that is
// right comes first.
//
// Any T (ragged tiles are masked: keys >= T get P = 0, rows >= T are
// neither read past T nor stored); d_head 64 or 128.
//
// Interface (plain C, loaded with ctypes; every function returns the CUDA
// error of its launch, 0 on success; all tensors contiguous float32):
//   flash_dropout_fwd(q, k, v, bias, o, lse, B, H, T, D, scale,
//                     threshold, keep_scale, seed_lo, seed_hi, stream)
//   flash_dropout_dq(q, k, v, bias, do, o, lse, delta (out), dq, B, H, T,
//                    D, ...)
//   flash_dropout_dkv(q, k, v, bias, do, lse, delta, dk, dv, B, H, T, D,
//                     ...)
//   flash_dropout_keep_mask(out (BH, T, T) int32, BH, T, threshold,
//                           seed_lo, seed_hi, stream)
// q, k, v, o, do, dq, dk, dv: (B, H, T, D); bias: (B, T); lse and delta =
// D = rowsum(dO.O): (B, H, T). The dQ kernel computes D for its rows and
// writes it; the dK/dV kernel, launched after it, reads it (the JAX
// kernels recompute D in every tile). threshold 0 skips the mask (p = 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps, 16 rows each
constexpr int BR = 64;        // rows a block owns (queries; dkv: keys)
constexpr int BC = 64;        // columns of a tile (keys; dkv: BCQ queries)
constexpr int BCQ = 32;       // query tile of the dK/dV kernel
constexpr int PAD = 8;        // bf16 of padding per shared-memory row

struct Seed {
  uint32_t threshold;
  float keep_scale;
  uint32_t lo, hi;
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
  const uint4 w = philox(j4, i, bh, 0u, sd.lo, sd.hi);
  const uint32_t s0 = even ? w.z : w.x, s1 = even ? w.w : w.y;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (even) {
    out[0] = w.x; out[1] = w.y; out[2] = r0; out[3] = r1;
  } else {
    out[0] = r0; out[1] = r1; out[2] = w.z; out[3] = w.w;
  }
}

// The same for a tile whose rows are KEYS and columns QUERIES (dK/dV):
// element e is (key row g + 8*(e/2), query col 2t + e%2). Key g = 4a + r
// reads word r of block (row0/4 + a (+2 for g+8)); the four lanes r = 0..3
// of one (a, t) draw the four blocks of their elements, lane r the block of
// element r, and four shuffle rounds hand each lane word r of every block.
__device__ __forceinline__ void keep_rows_k(uint32_t out[4], const Seed& sd,
                                            uint32_t bh, int row0, int col0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int a = g >> 2, r = g & 3;
  const uint32_t j4 = static_cast<uint32_t>(row0 / 4 + a + 2 * (r >> 1));
  const uint32_t i = static_cast<uint32_t>(col0 + 2 * t + (r & 1));
  const uint4 w = philox(j4, i, bh, 0u, sd.lo, sd.hi);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    // this lane serves lane r^s, which wants word r^s of this lane's block
    const uint32_t got = __shfl_xor_sync(0xffffffffu, word(w, r ^ s), s << 2);
    const int e = r ^ s;   // got = word r of the block of element e
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k == e) out[k] = got;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b: m16n8k16, a row-major 16x16 bf16, b "col" (stored n-major)
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16, k-chunk kc) of a row-major bf16 tile with row stride ld
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s,
                                       int ld, int row0, int kc, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = s + (row0 + g) * ld + kc * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment (16 x 8) from an n-major bf16 tile: rows n0..n0+7, k-chunk kc
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const __nv_bfloat16* s, int ld, int n0,
                                       int kc, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = s + (n0 + g) * ld + kc * 16 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// acc[N/8][4] += A(16 x K, from shared rows row0..) * Bt(N x K)^T
template <int K, int N>
__device__ __forceinline__ void gemm_ss(float (*acc)[4],
                                        const __nv_bfloat16* a, int lda,
                                        int row0, const __nv_bfloat16* bt,
                                        int ldb, int lane) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t af[4];
    load_a(af, a, lda, row0, kc, lane);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      uint32_t b0, b1;
      load_b(b0, b1, bt, ldb, nt * 8, kc, lane);
      mma(acc[nt], af, b0, b1);
    }
  }
}

// B fragments (16 x 8) of n-tiles n0/8 and n0/8 + 1, k-chunk kc, from a
// k-major bf16 tile [k][n] (row stride ld): ldmatrix.x4.trans hands lane
// (g, t) the elements (k 2t, 2t+1; n g) of each 8x8 block. Lane i gives
// the address of row i%8 of block i/8: blocks (k0, n0), (k0+8, n0),
// (k0, n0+8), (k0+8, n0+8).
__device__ __forceinline__ void load_b_trans(uint32_t b[4],
                                             const __nv_bfloat16* s, int ld,
                                             int n0, int kc, int lane) {
  const int blk = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p =
      s + (kc * 16 + (blk & 1) * 8 + r) * ld + n0 + (blk >> 1) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// acc[N/8][4] += P(16 x K, accumulator fragments p[K/8][4]) * B(K x N),
// B a k-major shared tile [k][n]; P is rounded to bf16 here
template <int K, int N>
__device__ __forceinline__ void gemm_rs(float (*acc)[4], const float (*p)[4],
                                        const __nv_bfloat16* b, int ldb,
                                        int lane) {
  static_assert(N % 16 == 0, "n-tiles go in pairs");
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    const uint32_t af[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                            pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                            pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                            pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int nt = 0; nt < N / 8; nt += 2) {
      uint32_t bf[4];
      load_b_trans(bf, b, ldb, nt * 8, kc, lane);
      mma(acc[nt], af, bf[0], bf[1]);
      mma(acc[nt + 1], af, bf[2], bf[3]);
    }
  }
}

// rows row0 .. row0+R-1 of a (T, D) float32 matrix -> bf16 shared tile
// [R][D+PAD] (rows past T are zero)
template <int R, int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* s, const float* g,
                                           int row0, int T) {
  constexpr int D4 = D / 4;
  for (int idx = threadIdx.x; idx < R * D4; idx += THREADS) {
    const int r = idx / D4, c = (idx % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T)
      x = *reinterpret_cast<const float4*>(g + static_cast<size_t>(row0 + r) * D + c);
    uint32_t* dst = reinterpret_cast<uint32_t*>(s + r * (D + PAD) + c);
    dst[0] = pack_bf16(x.x, x.y);
    dst[1] = pack_bf16(x.z, x.w);
  }
}

// ---------------------------------------------------------------------------
// forward: block = 64 queries of one (b, h); two passes over 64-key tiles
// ---------------------------------------------------------------------------

template <int D>
struct FwdSmem {
  static constexpr int kQ = BR * (D + PAD), kK = BC * (D + PAD);
  static constexpr size_t bytes = 2 * (kQ + 2 * kK) + sizeof(float) * BC;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ bias,
           float* __restrict__ o, float* __restrict__ lse, int H, int T,
           float scale, Seed sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + FwdSmem<D>::kQ;
  __nv_bfloat16* Vs = Ks + FwdSmem<D>::kK;
  float* bs = reinterpret_cast<float*>(Vs + FwdSmem<D>::kK);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BR, wr = warp * 16;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* bias_b = bias + static_cast<size_t>(b) * T;
  const bool drop = sd.threshold != 0u;

  stage_rows<BR, D>(Qs, q + base, q0, T);

  auto load_k = [&](int k0, bool with_v) {
    __syncthreads();   // the previous tile's reads are done
    stage_rows<BC, D>(Ks, k + base, k0, T);
    if (with_v) stage_rows<BC, D>(Vs, v + base, k0, T);
    if (threadIdx.x < BC) {
      const int j = k0 + threadIdx.x;
      bs[threadIdx.x] = j < T ? bias_b[j] : -INFINITY;   // no such key
    }
    __syncthreads();
  };
  auto scores = [&](float (*s)[4]) {
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    gemm_ss<D, BC>(s, Qs, D + PAD, wr, Ks, D + PAD, lane);
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = s[nt][e] * scale + bs[nt * 8 + 2 * t + (e & 1)];
  };

  // pass 1: row max and row sum of exp
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < T; k0 += BC) {
    load_k(k0, false);
    float s[BC / 8][4];
    scores(s);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mt = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BC / 8; ++nt)
        mt = fmaxf(mt, fmaxf(s[nt][2 * h2], s[nt][2 * h2 + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[h2], mt);   // finite: key 0 < T exists
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < BC / 8; ++nt)
        rs += expf(s[nt][2 * h2] - m_new) + expf(s[nt][2 * h2 + 1] - m_new);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[h2] = l[h2] * expf(m[h2] - m_new) + rs;
      m[h2] = m_new;
    }
  }

  // pass 2: O = (M . exp(S - m) . c) V, then / l
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int k0 = 0; k0 < T; k0 += BC) {
    load_k(k0, true);
    float s[BC / 8][4];
    scores(s);
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
      uint32_t keep[4];
      if (drop) keep_rows_q(keep, sd, bh, q0 + wr, k0 + nt * 8, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[nt][e] - m[e >> 1]);
        if (drop) p = keep[e] >= sd.threshold ? p * sd.keep_scale : 0.f;
        s[nt][e] = p;
      }
    }
    gemm_rs<BC, D>(acc, s, Vs, D + PAD, lane);
  }

  float* og = o + base;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + wr + g + 8 * h2;
    if (row >= T) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      float2 x = make_float2(acc[dt][2 * h2] / l[h2], acc[dt][2 * h2 + 1] / l[h2]);
      *reinterpret_cast<float2*>(og + static_cast<size_t>(row) * D + dt * 8 + 2 * t) = x;
    }
    if (t == 0) lse[static_cast<size_t>(bh) * T + row] = m[h2] + logf(l[h2]);
  }
}

// ---------------------------------------------------------------------------
// dQ: block = 64 queries; loop over 64-key tiles
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kRow = BR * (D + PAD);
  // Qs, dOs, Ks, Vs; bias
  static constexpr size_t bytes = 2 * 4 * kRow + sizeof(float) * BC;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ bias,
          const float* __restrict__ dout, const float* __restrict__ o,
          const float* __restrict__ lse, float* __restrict__ delta,
          float* __restrict__ dq, int H, int T, float scale, Seed sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + PAD;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + DqSmem<D>::kRow;
  __nv_bfloat16* Ks = dOs + DqSmem<D>::kRow;
  __nv_bfloat16* Vs = Ks + DqSmem<D>::kRow;
  float* bs = reinterpret_cast<float*>(Vs + DqSmem<D>::kRow);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BR, wr = warp * 16;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* bias_b = bias + static_cast<size_t>(b) * T;
  const bool drop = sd.threshold != 0u;

  stage_rows<BR, D>(Qs, q + base, q0, T);
  stage_rows<BR, D>(dOs, dout + base, q0, T);
  float lse_r[2], del_r[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + wr + g + 8 * h2;
    lse_r[h2] = row < T ? lse[static_cast<size_t>(bh) * T + row] : 0.f;
  }
  // D = rowsum(dO . O) in float32 for this warp's 16 rows, one row per
  // warp-wide reduction; written out for the dK/dV kernel. Unrolled: with
  // the loop rolled, ptxas gives the kernel fewer registers (169, not 222
  // at D = 128) and the main loop runs slower.
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

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int k0 = 0; k0 < T; k0 += BC) {
    __syncthreads();
    stage_rows<BC, D>(Ks, k + base, k0, T);
    stage_rows<BC, D>(Vs, v + base, k0, T);
    if (threadIdx.x < BC) {
      const int j = k0 + threadIdx.x;
      bs[threadIdx.x] = j < T ? bias_b[j] : 0.f;
    }
    __syncthreads();

    float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    gemm_ss<D, BC>(s, Qs, LD, wr, Ks, LD, lane);
    gemm_ss<D, BC>(dp, dOs, LD, wr, Vs, LD, lane);
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
      uint32_t keep[4];
      if (drop) keep_rows_q(keep, sd, bh, q0 + wr, k0 + nt * 8, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + nt * 8 + 2 * t + (e & 1);
        const float sv = s[nt][e] * scale + bs[nt * 8 + 2 * t + (e & 1)];
        const float p = j < T ? expf(sv - lse_r[e >> 1]) : 0.f;
        float dpd = dp[nt][e];
        if (drop) dpd = keep[e] >= sd.threshold ? dpd * sd.keep_scale : 0.f;
        s[nt][e] = p * (dpd - del_r[e >> 1]);   // dS
      }
    }
    gemm_rs<BC, D>(acc, s, Ks, LD, lane);
  }

  float* dqg = dq + base;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + wr + g + 8 * h2;
    if (row >= T) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      float2 x = make_float2(acc[dt][2 * h2] * scale, acc[dt][2 * h2 + 1] * scale);
      *reinterpret_cast<float2*>(dqg + static_cast<size_t>(row) * D + dt * 8 + 2 * t) = x;
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: block = 64 keys; loop over 32-query tiles
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int kKey = BR * (D + PAD), kQ = BCQ * (D + PAD);
  // Ks, Vs; Qs, dOs; lse, D
  static constexpr size_t bytes =
      2 * (2 * kKey + 2 * kQ) + sizeof(float) * 2 * BCQ;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ bias,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk,
           float* __restrict__ dv, int H, int T, float scale, Seed sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + PAD;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + DkvSmem<D>::kKey;
  __nv_bfloat16* Qs = Vs + DkvSmem<D>::kKey;
  __nv_bfloat16* dOs = Qs + DkvSmem<D>::kQ;
  float* lse_s = reinterpret_cast<float*>(dOs + DkvSmem<D>::kQ);
  float* del_s = lse_s + BCQ;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int j0 = blockIdx.x * BR, wr = warp * 16;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const bool drop = sd.threshold != 0u;

  stage_rows<BR, D>(Ks, k + base, j0, T);
  stage_rows<BR, D>(Vs, v + base, j0, T);
  float bias_r[2];
  bool key_ok[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int j = j0 + wr + g + 8 * h2;
    key_ok[h2] = j < T;
    bias_r[h2] = key_ok[h2] ? bias[static_cast<size_t>(b) * T + j] : 0.f;
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  for (int i0 = 0; i0 < T; i0 += BCQ) {
    __syncthreads();
    stage_rows<BCQ, D>(Qs, q + base, i0, T);
    stage_rows<BCQ, D>(dOs, dout + base, i0, T);
    if (threadIdx.x < BCQ) {
      const int i = i0 + threadIdx.x;
      const size_t at = static_cast<size_t>(bh) * T + i;
      lse_s[threadIdx.x] = i < T ? lse[at] : 0.f;
      del_s[threadIdx.x] = i < T ? delta[at] : 0.f;
    }
    __syncthreads();

    float s[BCQ / 8][4], dp[BCQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BCQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    gemm_ss<D, BCQ>(s, Ks, LD, wr, Qs, LD, lane);     // S^T = K Q^T
    gemm_ss<D, BCQ>(dp, Vs, LD, wr, dOs, LD, lane);   // dP^T = V dO^T
    float pd[BCQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BCQ / 8; ++nt) {
      uint32_t keep[4];
      if (drop) keep_rows_k(keep, sd, bh, j0 + wr, i0 + nt * 8, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ic = nt * 8 + 2 * t + (e & 1);
        const float sv = s[nt][e] * scale + bias_r[e >> 1];
        const float p = (key_ok[e >> 1] && i0 + ic < T)
                            ? expf(sv - lse_s[ic]) : 0.f;
        float pdv = p, dpd = dp[nt][e];
        if (drop) {
          const bool kp = keep[e] >= sd.threshold;
          pdv = kp ? p * sd.keep_scale : 0.f;
          dpd = kp ? dpd * sd.keep_scale : 0.f;
        }
        pd[nt][e] = pdv;
        s[nt][e] = p * (dpd - del_s[ic]);   // dS^T
      }
    }
    gemm_rs<BCQ, D>(dv_acc, pd, dOs, LD, lane);    // dV += Pd^T dO
    gemm_rs<BCQ, D>(dk_acc, s, Qs, LD, lane);      // dK += dS^T Q
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = j0 + wr + g + 8 * h2;
    if (row >= T) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const size_t off = base + static_cast<size_t>(row) * D + dt * 8 + 2 * t;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(dk_acc[dt][2 * h2] * scale, dk_acc[dt][2 * h2 + 1] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dv_acc[dt][2 * h2], dv_acc[dt][2 * h2 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// keep mask: one thread per Philox block (bh, i, 4 keys)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
keep_mask_kernel(int* __restrict__ out, int T, uint32_t threshold,
                 uint32_t lo, uint32_t hi) {
  const int n4 = (T + 3) / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(T) * n4) return;
  const int i = static_cast<int>(idx / n4), j4 = static_cast<int>(idx % n4);
  const uint32_t bh = blockIdx.y;
  const uint4 w = philox(static_cast<uint32_t>(j4), static_cast<uint32_t>(i),
                         bh, 0u, lo, hi);
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

Seed make_seed(unsigned threshold, float keep_scale, unsigned lo, unsigned hi) {
  Seed s;
  s.threshold = threshold;
  s.keep_scale = keep_scale;
  s.lo = lo;
  s.hi = hi;
  return s;
}

}  // namespace

extern "C" int flash_dropout_fwd(const float* q, const float* k,
                                 const float* v, const float* bias, float* o,
                                 float* lse, int B, int H, int T, int D,
                                 float scale, unsigned threshold,
                                 float keep_scale, unsigned seed_lo,
                                 unsigned seed_hi, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Seed sd = make_seed(threshold, keep_scale, seed_lo, seed_hi);
  const dim3 grid((T + BR - 1) / BR, B * H);
  switch (D) {
    case 64:
      return launch(fwd_kernel<64>, FwdSmem<64>::bytes, grid, s, q, k, v,
                        bias, o, lse, H, T, scale, sd);
    case 128:
      return launch(fwd_kernel<128>, FwdSmem<128>::bytes, grid, s, q, k,
                         v, bias, o, lse, H, T, scale, sd);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_dropout_dq(const float* q, const float* k, const float* v,
                                const float* bias, const float* dout,
                                const float* o, const float* lse,
                                float* delta, float* dq, int B, int H, int T,
                                int D, float scale, unsigned threshold,
                                float keep_scale, unsigned seed_lo,
                                unsigned seed_hi, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Seed sd = make_seed(threshold, keep_scale, seed_lo, seed_hi);
  const dim3 grid((T + BR - 1) / BR, B * H);
  switch (D) {
    case 64:
      return launch(dq_kernel<64>, DqSmem<64>::bytes, grid, s, q, k, v,
                    bias, dout, o, lse, delta, dq, H, T, scale, sd);
    case 128:
      return launch(dq_kernel<128>, DqSmem<128>::bytes, grid, s, q, k, v,
                    bias, dout, o, lse, delta, dq, H, T, scale, sd);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_dropout_dkv(const float* q, const float* k,
                                 const float* v, const float* bias,
                                 const float* dout, const float* lse,
                                 const float* delta, float* dk, float* dv,
                                 int B, int H, int T, int D, float scale,
                                 unsigned threshold, float keep_scale,
                                 unsigned seed_lo, unsigned seed_hi,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Seed sd = make_seed(threshold, keep_scale, seed_lo, seed_hi);
  const dim3 grid((T + BR - 1) / BR, B * H);
  switch (D) {
    case 64:
      return launch(dkv_kernel<64>, DkvSmem<64>::bytes, grid, s, q, k, v,
                        bias, dout, lse, delta, dk, dv, H, T, scale, sd);
    case 128:
      return launch(dkv_kernel<128>, DkvSmem<128>::bytes, grid, s, q, k,
                         v, bias, dout, lse, delta, dk, dv, H, T, scale, sd);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_dropout_keep_mask(int* out, int BH, int T,
                                       unsigned threshold, unsigned seed_lo,
                                       unsigned seed_hi, void* stream) {
  const long long blocks_x =
      (static_cast<long long>(T) * ((T + 3) / 4) + 255) / 256;
  if (blocks_x > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_x), BH);
  keep_mask_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, T, threshold, seed_lo, seed_hi);
  return static_cast<int>(cudaGetLastError());
}
