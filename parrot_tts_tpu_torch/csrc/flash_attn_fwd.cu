// Flash-attention forward for Hopper (sm_90a): float32 attention on the
// TF32 tensor cores with a 3xTF32 split, or in one TF32 pass.
//
// Replaces: parrot_tts_tpu/ops/attention.py::_flash_attention
// (attention.py:153-181), which calls JAX's stock Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention with the key padding as
// segment ids. It computes, for every (b, h) of (B, H, T, D) float32,
//     O = softmax(Q K^T * scale + mask) V,   non-causal,
// where keys whose key_padding_mask byte is nonzero get -inf. A query row
// with no valid key writes 0 (the plain PyTorch version in
// ops/flash_attention.py does the same; the XLA path would give NaN).
//
// Numerics of the 3xTF32 mode: every product of the two matrix products is
// 3xTF32. Each float32 operand x is split exactly as x = hi + lo (Veltkamp:
// hi is x rounded to 11 significant bits, a TF32 value), and a * b is taken
// as lo_a hi_b + hi_a lo_b + hi_a hi_b (the small terms first) on the TF32
// tensor cores. Their float32 accumulation does not round to nearest, so a
// long sum there drifts: they sum only short partials from zero (4 k steps,
// 32 of d, of S = Q K^T; one 32-key tile of P V), which IEEE float32 adds to
// the running sums. The dropped lo_a lo_b and the bits of lo that TF32
// drops (the tensor cores read lo's top 11) leave each product within
// ~5 * 2^-22 of its float32 value, so the result stays close to the IEEE
// float32 plain version: phase 3 of chip_smoke.py holds it to 1e-5
// absolute, and phase 4 to the unit-exact decode. Plain TF32 (one product
// of hi parts, ~2^-11 relative) would flip the decoder's argmax near-ties
// and durations. The softmax (scale, mask, max, exp in base e, sums, the
// division) is IEEE float32 on the CUDA cores.
//
// 1-pass mode (the TPU's default precision, which the JAX package's
// "selective" decode and exact=False run): each operand of a product (Q, K,
// P, V) is rounded to TF32 once, to nearest (cvt.rna), and each product is
// one TF32 pass. P is rounded against the running row max of its 32-key
// tile, then rescaled by the running max's change, and the plain version
// (ops/flash_attention.py) rounds it the same way. The products of TF32
// values are exact in float32, so the two differ only by the order of
// float32 sums (and exp2 of the base-2 scores against exp), which now and
// then sends a weight to the neighbouring TF32 value (<= 2^-10 of it; the
// output by <= 2^-10 max |v|). Masking and the zero row are as in 3xTF32
// mode.
//
// Bound on this card: 4*B*H*T^2*D floating-point operations (QK^T and PV)
// against 16*B*H*T*D bytes (Q, K, V read once, O written once); T/4
// operations per byte. The 3xTF32 products take 3 * 4*B*H*T^2*D at 494.7
// TFLOP/s dense TF32 (ridge 148): bound by operations above T ~ 600, with
// the splits of Q and P on the CUDA cores beside them. The 1-pass mode's
// bound is one third of that.
//
// The design. Both modes are two kernels on wgmma, whose TF32 form takes
// its shared-memory operands K-major only, with no transpose (P V wants
// V^T, which TMA cannot make of 4-byte elements) and reads a float32
// operand's TF32 bits truncated. So a pre-pass, prep_kernel<D, PARTS> (one
// block per (32-key tile, b h)), writes each key tile once per (b, h) into
// scratch the wrapper allocates, as PARTS planes of K [D / 4][32][4] (the
// K-major no-swizzle core matrices of S = Q K^T's B), the tile's key bias
// (0, or -inf masked or past T) and PARTS planes of V^T [8][D][4] whose
// logical k of every 8 holds key key_of(k): the P fragment's order (logical
// k t is key 2t, t + 4 key 2t + 1), which makes the S accumulator the A
// fragment of P V with no shuffles. The 1-pass mode's plane is rounded
// (cvt.rna); the 3xTF32 mode's two are the split's hi and lo (hi + lo = x
// exactly; the tensor cores read lo truncated, as mma.sync read it before),
// so each key is split once per (b, h), not once per query block and warp.
// The pre-pass reads K and V once and writes them PARTS times: (8 + 8 PARTS)
// B*H*T*D bytes.
//
// - three_pass::attn_kernel (the 3xTF32 mode): a block of three warpgroups
//   of 64 queries (the wgmma m; 192 queries: at (5, 2, 2048, 128) 110
//   blocks, one wave on 132 SMs). Thread 0 bulk-copies whole tiles (K hi,
//   lo, bias, V^T hi, lo: 64.1 KB at D = 128) into a 2-slot mbarrier ring,
//   one tile ahead, once every warpgroup has released the slot (all
//   threads wait, thread 0 copies: a predicate, so no divergent path sits
//   among the wgmmas). Q stays float32 in shared memory, each thread's A
//   fragments of a k-step as one 16-byte vector ([D / 8][128][4] per
//   warpgroup), split in registers per partial (row 6's 3xTF32 mode does
//   the same, fused_mrf.cu): Q's hi and lo planes would take 64 KB a
//   warpgroup, and two of them beside two slots exceed the 227 KB a block
//   may take. Shared memory at D = 128: Q 3 x 32 KB + 2 x 64.1 KB = 229,760
//   bytes (115,072 at D = 64). Per tile n and warpgroup:
//   S_n = Q K_n^T in D / 32 partials, each 4 k-steps x 3 wgmma m64n32k8 (A
//   from registers) from zero, waited and added in IEEE float32; the online
//   softmax in base e on the accumulators (the row max over the quad by
//   two shuffles), O rescaled; P split in registers (tf32x3::split); O +=
//   P V in n = 64 halves, each 4 k-steps x 3 wgmma m64n64k8 (A = P's hi or
//   lo from registers, B = V^T's hi or lo) from zero, waited and added;
//   then one thread releases the slot. Registers: ptxas allots 168 a
//   thread at 384 threads; O takes D / 2, so one partial is in flight per
//   warpgroup (S's: 16 sums and 32 fragment registers; P V's: 32 sums
//   beside P's 32), and the other two warpgroups' products run on the
//   tensor cores during its adds and softmax (S_{n+1} issued ahead of
//   P_n V_n, and a second partial buffer, would need ~60 more). No branch
//   sits among a partial's wgmmas (ptxas would serialize them).
//   Bytes: each block reads its (b, h)'s whole scratch, (16 D + 1) 32 * 4
//   bytes a tile, from L2: 0.46 GB at (5, 2, 2048, 128), 5.9 GB at (64, 2,
//   2048, 128), against 0.13 and 1.67 ms of products at the bound.
// - one_pass::attn_kernel (the 1-pass mode): three warpgroups of 64
//   queries, a 4-slot ring, each tile copied two tiles ahead. Each
//   warpgroup rounds its Q into shared memory once, [D / 4][64][4] (its
//   fragments in registers, D / 2 a thread, left too few registers for the
//   rest: they spilled at ptxas's 168). Per tile n: S_n = Q K_n^T, D / 8
//   wgmma m64n32k8 with both operands in shared memory, from zero; the
//   online softmax in base 2 on the accumulators; O rescaled and P rounded
//   (cvt.rna) into registers; O += P V, 4 wgmma m64nDk8 with A from
//   registers. S_{n+1} is issued ahead of P_n V_n, so tile n + 1's softmax
//   runs while P_n V_n multiplies; the last tile's P V is peeled off the
//   loop. Shared memory 230,016 bytes (115,328 at D = 64).
//
// Interface (route (b): plain C, loaded with ctypes):
//   int flash_attn_split_f32(k, v, key_padding_mask or NULL, kv, B, H, T, D,
//                            stream)
// the 3xTF32 pre-pass into kv: (B*H, ceil(T / 32), 4*D*32 + 32) float32.
//   int flash_attn_fwd_f32(q, kv, o, B, H, T, D, scale, stream)
// the 3xTF32 kernel on the pre-pass's kv.
//   int flash_attn_prep_f32(k, v, key_padding_mask or NULL, kv, B, H, T, D,
//                           stream)
// the 1-pass pre-pass into kv: (B*H, ceil(T / 32), 2*D*32 + 32) float32.
//   int flash_attn_1pass_f32(q, kv, o, B, H, T, D, scale, stream)
// the 1-pass kernel on the pre-pass's kv. q, k, v, o: contiguous
// (B, H, T, D) float32, 16-byte aligned; key_padding_mask: contiguous
// (B, T) bytes (torch.bool), nonzero = ignore that key. Each returns the
// CUDA error code of the launch (0 on success). D must be 64 or 128, B*H at
// most 65,535.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;   // split, round_tf32, wgmma_tf32, wgmma_tf32_ss
using sm90::bulk_load_1d;
using sm90::desc_hi;
using sm90::fence_proxy_async;
using sm90::mbar_arrive_if;
using sm90::mbar_fence_init;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::named_bar;
using sm90::reg_fence;
using sm90::smem_u32;
using sm90::wg_commit;
using sm90::wg_fence;
using sm90::wg_wait;

constexpr int BQ = 64;         // queries per warpgroup (the wgmma m)
constexpr int BK = 32;         // keys per tile
constexpr int PREP_THREADS = 256;

// the key order inside each 8 keys of a V^T tile: logical k t holds key 2t,
// t + 4 key 2t + 1 (the P fragment's, tf32x3.cuh)
__host__ __device__ constexpr int key_of(int p) {
  return (p & ~7) | ((p & 7) < 4 ? 2 * (p & 7) : 2 * (p & 7) - 7);
}

// one prepared key tile, as prep_kernel writes it and a ring slot holds
// it: PARTS planes of K [D / 4][BK][4], the key bias [BK] (0, or -inf for a
// padded key or one past T), PARTS planes of V^T [BK / 4][D][4] in key_of
// order. PARTS 1: rounded to TF32; PARTS 2: the split's hi, then lo
template <int D, int PARTS>
struct Tile {
  static constexpr int kPlaneK = D * BK, kPlaneV = BK * D;
  static constexpr int kK = PARTS * kPlaneK, kBias = BK, kV = PARTS * kPlaneV;
  static constexpr int floats = kK + kBias + kV;
  static constexpr uint32_t bytes = 4 * floats;
};

__device__ __forceinline__ float rounded(float x) {
  return __uint_as_float(round_tf32(x) & 0xFFFFE000u);
}

// 4 values into their planes at dst[0] (and dst[plane] for lo): rounded to
// TF32 (PARTS 1), or split into hi and lo (PARTS 2)
template <int PARTS>
__device__ __forceinline__ void store_parts(float4* dst, int plane,
                                            float4 x) {
  if constexpr (PARTS == 1) {
    dst[0] = make_float4(rounded(x.x), rounded(x.y), rounded(x.z),
                         rounded(x.w));
  } else {
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    dst[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                         __uint_as_float(h[2]), __uint_as_float(h[3]));
    dst[plane] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                             __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// the pre-pass: one block per (key tile, b h) writes the tile's planes of K,
// its bias and the planes of V^T into the scratch the wrapper allocates
template <int D, int PARTS>
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const float* __restrict__ k, const float* __restrict__ v,
            const unsigned char* __restrict__ kpm, float* __restrict__ kv,
            int H, int T, int n_tiles) {
  using TL = Tile<D, PARTS>;
  constexpr int C = D / 4;   // 16-byte chunks of a row
  constexpr int LD = D + 4;  // staged row stride (floats): float4 stores,
                             // and a K chunk's reads down the rows hit 32 banks
  __shared__ __align__(16) float ks[BK * LD];
  __shared__ __align__(16) float vs[BK * LD];
  const int n = blockIdx.x, bh = blockIdx.y, b = bh / H;
  const int k0 = n * BK;
  const size_t base = static_cast<size_t>(bh) * T * D;
  float* tile = kv + (static_cast<size_t>(bh) * n_tiles + n) * TL::floats;
  for (int idx = threadIdx.x; idx < BK * C; idx += PREP_THREADS) {
    const int r = idx / C, c = idx % C;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (k0 + r < T) {
      const size_t off = base + static_cast<size_t>(k0 + r) * D + 4 * c;
      x = __ldg(reinterpret_cast<const float4*>(k + off));
      y = __ldg(reinterpret_cast<const float4*>(v + off));
    }
    *reinterpret_cast<float4*>(ks + r * LD + 4 * c) = x;
    *reinterpret_cast<float4*>(vs + r * LD + 4 * c) = y;
  }
  if (threadIdx.x < BK) {
    const int j = k0 + threadIdx.x;
    const bool valid =
        j < T && (kpm == nullptr || kpm[static_cast<size_t>(b) * T + j] == 0);
    tile[TL::kK + threadIdx.x] = valid ? 0.f : -INFINITY;
  }
  __syncthreads();
  // K: 16-byte chunk j = c BK + r of a plane holds row r's d 4c..4c+3
  for (int j = threadIdx.x; j < C * BK; j += PREP_THREADS)
    store_parts<PARTS>(reinterpret_cast<float4*>(tile) + j, TL::kPlaneK / 4,
                       *reinterpret_cast<const float4*>(ks + (j % BK) * LD +
                                                        4 * (j / BK)));
  // V^T: chunk j = g D + d of a plane holds d of logical keys 4g..4g+3
  float* vt = tile + TL::kK + TL::kBias;
  for (int j = threadIdx.x; j < BK / 4 * D; j += PREP_THREADS) {
    const int p = 4 * (j / D), d = j % D;
    store_parts<PARTS>(
        reinterpret_cast<float4*>(vt) + j, TL::kPlaneV / 4,
        make_float4(vs[key_of(p) * LD + d], vs[key_of(p + 1) * LD + d],
                    vs[key_of(p + 2) * LD + d], vs[key_of(p + 3) * LD + d]));
  }
}

template <int D, int PARTS>
int prep(const float* k, const float* v, const unsigned char* kpm, float* kv,
         int B, int H, int T, cudaStream_t stream) {
  const int n_tiles = (T + BK - 1) / BK;
  prep_kernel<D, PARTS><<<dim3(n_tiles, B * H), PREP_THREADS, 0, stream>>>(
      k, v, kpm, kv, H, T, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// the epilogue of both modes: rows g and g + 8 of this warp's 16, O / l
// (the quad's l), 0 where every key is masked; rows past T not written
template <int D>
__device__ __forceinline__ void store_rows(float* og, int row0, int T,
                                           int t, float (&l)[2],
                                           const float (&acc)[D / 2]) {
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
    const int row = row0 + 8 * h2;
    if (row >= T) continue;
    const bool any = l[h2] > 0.f;   // false only when every key is masked
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(og + static_cast<size_t>(row) * D + 8 * j +
                                 2 * t) =
          make_float2(any ? acc[4 * j + 2 * h2] / l[h2] : 0.f,
                      any ? acc[4 * j + 2 * h2 + 1] / l[h2] : 0.f);
  }
}

// ---- the 3xTF32 mode on wgmma ---------------------------------------------

namespace three_pass {

constexpr int NWG = 3;         // warpgroups per block
constexpr int STAGES = 2;      // key tiles in the ring
constexpr int THREADS = 128 * NWG;
constexpr int KP = 4;          // k-steps of a partial of S (32 of d)

// shared memory: the ring's full and empty mbarriers (128 bytes), each
// warpgroup's Q [D / 8][128][4] (float32), the ring
template <int D>
constexpr size_t smem_bytes() {
  return 128 + 4 * (static_cast<size_t>(NWG) * BQ * D +
                    static_cast<size_t>(STAGES) * Tile<D, 2>::floats);
}

// the 3xTF32 attention on split tiles (header: the design)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_kernel(const float* __restrict__ q, const float* __restrict__ kv,
            float* __restrict__ o, int T, int n_tiles, float scale) {
  using TL = Tile<D, 2>;
  constexpr int KS = D / 8;      // k-steps of S = Q K^T (m64n32k8)
  constexpr int NT = BK / 8;     // k-steps of O += P V (m64n64k8)
  constexpr int NH = D / 64;     // n = 64 halves of P V
  extern __shared__ __align__(128) unsigned char smem3[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem3);   // tile landed
  uint64_t* empty = full + STAGES;   // every warpgroup done with the slot
  float* qs = reinterpret_cast<float*>(smem3 + 128);
  float* ring = qs + NWG * BQ * D;
  const int tid = threadIdx.x, lt = tid & 127, wg = tid >> 7;
  const int wl = lt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const float* tiles = kv + static_cast<size_t>(bh) * n_tiles * TL::floats;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // tile m into its slot, by thread 0 (a predicate, not a branch)
  auto copy = [&](int m) {
    bulk_load_1d(ring + (m % STAGES) * TL::floats,
                 tiles + static_cast<size_t>(m) * TL::floats, TL::bytes,
                 full + m % STAGES, tid == 0);
  };
  for (int m = 0; m < STAGES && m < n_tiles; ++m) copy(m);

  // this thread's A fragments of Q (rows r0 and r0 + 8; k-step ks holds
  // d 8ks + t and 8ks + t + 4), float32, one 16-byte vector per k-step at
  // [ks][lt] of its warpgroup's [D / 8][128][4]; rows past T 0. Each thread
  // reads back only its own vectors: no barrier
  const int row0 = (blockIdx.x * NWG + wg) * BQ + 16 * wl + g;
  float4* qw = reinterpret_cast<float4*>(qs) + wg * BQ * D / 4;
  const float* qg = q + static_cast<size_t>(bh) * T * D;
  const float* q_lo = qg + static_cast<size_t>(row0) * D;
  const float* q_hi = q_lo + 8 * D;
  const bool in_lo = row0 < T, in_hi = row0 + 8 < T;
  for (int ks = 0; ks < KS; ++ks) {
    const int c = 8 * ks + t;
    qw[ks * 128 + lt] = make_float4(
        in_lo ? __ldg(q_lo + c) : 0.f, in_hi ? __ldg(q_hi + c) : 0.f,
        in_lo ? __ldg(q_lo + c + 4) : 0.f, in_hi ? __ldg(q_hi + c + 4) : 0.f);
  }

  // k-step ks of K: 16-byte k groups 2ks, 2ks + 1 of a plane; of V^T: 2kc,
  // 2kc + 1, the n = 64 half h 64 rows on
  const uint64_t hk = desc_hi(BK * 16, 128), hv = desc_hi(D * 16, 128);
  const bool releaser = lt == 0;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // S of a tile: element i is row g + 8 ((i % 4) / 2) of this warp's 16,
  // key 8 (i / 4) + 2t + i % 2; after the softmax, P
  float s[BK / 2];

  // partial p of S_n from zero: k-steps KP p .. KP p + KP - 1, Q split here,
  // lo_q hi_k + hi_q lo_k + hi_q hi_k each; waited
  auto s_partial = [&](float (&d)[BK / 2], uint32_t kb, int p) {
    uint32_t qh[KP][4], ql[KP][4];
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const float4 x = qw[(KP * p + j) * 128 + lt];
      split(x.x, qh[j][0], ql[j][0]);
      split(x.y, qh[j][1], ql[j][1]);
      split(x.z, qh[j][2], ql[j][2]);
      split(x.w, qh[j][3], ql[j][3]);
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const uint32_t a = kb + (KP * p + j) * 2 * BK * 16;
      const uint64_t hi = hk | (a >> 4), lo = hk | ((a + 4 * TL::kPlaneK) >> 4);
      wgmma_tf32(d, ql[j], hi, j > 0);
      wgmma_tf32(d, qh[j], lo, 1);
      wgmma_tf32(d, qh[j], hi, 1);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(d);
    reg_fence(qh);
    reg_fence(ql);
  };

  for (int n = 0; n < n_tiles; ++n) {
    // tile n + 1 into the slot of tile n - 1, once every warpgroup has
    // released it (a test the block agrees on)
    if (n > 0 && n - 1 + STAGES < n_tiles) {
      mbar_wait(empty + (n - 1) % STAGES, ((n - 1) / STAGES) & 1);
      copy(n - 1 + STAGES);
    }
    mbar_wait(full + n % STAGES, (n / STAGES) & 1);
    const float* tile = ring + (n % STAGES) * TL::floats;
    const uint32_t kb = smem_u32(tile);

    // S_n = Q K_n^T: D / 32 partials, summed in IEEE float32
    s_partial(s, kb, 0);
#pragma unroll
    for (int p = 1; p < KS / KP; ++p) {
      float sp[BK / 2];
      s_partial(sp, kb, p);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] += sp[i];
    }

    // online softmax in base e, rows g (h2 = 0) and g + 8 (h2 = 1): P =
    // exp(s - m) in s, the running sum of this lane's keys (the quad's at
    // the end), O rescaled by the running max's change
    const float* kbias = tile + TL::kK;
    float alpha[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h2 + e];
          x = fmaf(x, scale, kbias[8 * j + 2 * t + e]);
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[h2], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
      alpha[h2] = expf(m[h2] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h2 + e];
          x = expf(x - m_use);
          rs += x;
        }
      l[h2] = l[h2] * alpha[h2] + rs;
      m[h2] = m_new;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j + i] *= alpha[i / 2];

    // P split into the A fragments of O += P V: k-step kc is keys 8kc..,
    // elements 4kc, 4kc + 2, 4kc + 1, 4kc + 3 (rows g, g + 8 at logical k t,
    // then t + 4: V^T's key_of order)
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int kc = 0; kc < NT; ++kc) {
      split(s[4 * kc], ph[kc][0], pl[kc][0]);
      split(s[4 * kc + 2], ph[kc][1], pl[kc][1]);
      split(s[4 * kc + 1], ph[kc][2], pl[kc][2]);
      split(s[4 * kc + 3], ph[kc][3], pl[kc][3]);
    }
    const uint32_t vb = kb + 4 * (TL::kK + TL::kBias);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float part[32];
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < NT; ++kc) {
        const uint32_t a = vb + kc * 2 * D * 16 + h * 64 * 16;
        const uint64_t hi = hv | (a >> 4), lo = hv | ((a + 4 * TL::kPlaneV) >> 4);
        wgmma_tf32(part, pl[kc], hi, kc > 0);
        wgmma_tf32(part, ph[kc], lo, 1);
        wgmma_tf32(part, ph[kc], hi, 1);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(part);
      reg_fence(ph);
      reg_fence(pl);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[32 * h + i] += part[i];
    }
    mbar_arrive_if(empty + n % STAGES, releaser);   // K_n, V_n^T read
  }

  store_rows<D>(o + static_cast<size_t>(bh) * T * D, row0, T, t, l, acc);
}

template <int D>
int launch(const float* q, const float* kv, float* o, int B, int H, int T,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (T + BK - 1) / BK;
  const dim3 grid((T + NWG * BQ - 1) / (NWG * BQ), B * H);
  attn_kernel<D><<<grid, THREADS, bytes, stream>>>(q, kv, o, T, n_tiles,
                                                   scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace three_pass

// ---- the 1-pass TF32 mode on wgmma -----------------------------------------

namespace one_pass {

constexpr int NWG = 3;         // warpgroups per block
constexpr int STAGES = 4;      // key tiles in the ring
constexpr int THREADS = 128 * NWG;

// shared memory: the ring's full and empty mbarriers (128 bytes), each
// warpgroup's Q [D / 4][BQ][4], the ring
template <int D>
constexpr size_t smem_bytes() {
  return 128 + 4 * (static_cast<size_t>(NWG) * BQ * D +
                    static_cast<size_t>(STAGES) * Tile<D, 1>::floats);
}

// the 1-pass attention on prepared tiles (header: the 1-pass mode)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_kernel(const float* __restrict__ q, const float* __restrict__ kv,
            float* __restrict__ o, int T, int n_tiles, float scale_log2) {
  using TL = Tile<D, 1>;
  constexpr int KS = D / 8;      // k-steps of S = Q K^T (m64n32k8)
  constexpr int NT = BK / 8;     // k-steps of O += P V (m64nDk8)
  extern __shared__ __align__(128) unsigned char smem1[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem1);   // tile landed
  uint64_t* empty = full + STAGES;   // every warpgroup done with the slot
  float* qs = reinterpret_cast<float*>(smem1 + 128);
  float* ring = qs + NWG * BQ * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const float* tiles = kv + static_cast<size_t>(bh) * n_tiles * TL::floats;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // tile m into its slot, by thread 0 (a predicate, not a branch: no
  // divergent path sits among the wgmmas, which ptxas would serialize)
  auto copy = [&](int m) {
    bulk_load_1d(ring + (m % STAGES) * TL::floats,
                 tiles + static_cast<size_t>(m) * TL::floats, TL::bytes,
                 full + m % STAGES, tid == 0);
  };
  for (int m = 0; m < STAGES && m < n_tiles; ++m) copy(m);

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int q0 = (blockIdx.x * NWG + wg) * BQ;
  // this warpgroup's Q rounded to TF32 once ([D / 4][BQ][4]; rows past T
  // 0), the A operand of S from shared memory (its fragments in registers,
  // D / 2 a thread, spilled: header)
  float* qw = qs + wg * BQ * D;
  const float* qg = q + static_cast<size_t>(bh) * T * D;
  for (int idx = tid & 127; idx < BQ * D / 4; idx += 128) {
    const int m = idx % BQ, c = idx / BQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + m < T)
      x = __ldg(reinterpret_cast<const float4*>(
          qg + static_cast<size_t>(q0 + m) * D + 4 * c));
    *reinterpret_cast<float4*>(qw + (c * BQ + m) * 4) =
        make_float4(rounded(x.x), rounded(x.y), rounded(x.z), rounded(x.w));
  }
  fence_proxy_async();     // the generic stores, visible to the wgmmas
  named_bar(1 + wg, 128);

  // k-step ks of Q and K: 16-byte k groups 2ks, 2ks + 1; of V^T: 2kc, 2kc + 1
  const uint32_t qa = smem_u32(qw);
  const uint64_t hq = desc_hi(BQ * 16, 128), hk = desc_hi(BK * 16, 128),
                 hv = desc_hi(D * 16, 128);
  const bool releaser = (tid & 127) == 0;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // S of a tile: element i is row g + 8 ((i % 4) / 2) of this warp's 16,
  // key 8 (i / 4) + 2t + i % 2; after `softmax`, P (unrounded)
  float sc[BK / 2];
  uint32_t pa[NT][4];   // P rounded, the A fragments of O += P V

  // S_n = Q K_n^T: D / 8 wgmma m64n32k8, both operands in shared memory,
  // from zero
  auto scores = [&](int n) {
    const uint32_t kb = smem_u32(ring + (n % STAGES) * TL::floats);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_tf32_ss(sc, hq | ((qa + ks * 2 * BQ * 16) >> 4),
                    hk | ((kb + ks * 2 * BK * 16) >> 4), ks > 0);
  };
  // O += P_n V_n: k-step kc is keys 8kc.. of V^T in key_of order
  auto products = [&](int n) {
    const uint32_t vb = smem_u32(ring + (n % STAGES) * TL::floats) +
                        4 * (TL::kK + TL::kBias);
#pragma unroll
    for (int kc = 0; kc < NT; ++kc)
      wgmma_tf32(acc, pa[kc], hv | ((vb + kc * 2 * D * 16) >> 4), 1);
  };
  // online softmax of tile n in base 2 (scale_log2 = scale log2(e)), rows
  // g (h2 = 0) and g + 8 (h2 = 1): P = exp2(s - m) in sc, the running sum
  // of this lane's keys (the quad's at the end), and alpha, O's rescale
  auto softmax = [&](int n) {
    const float* kbias = ring + (n % STAGES) * TL::floats + TL::kK;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h2 + e];
          x = fmaf(x, scale_log2, kbias[8 * j + 2 * t + e]);
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[h2], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
      alpha[h2] = exp2f(m[h2] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h2 + e];
          x = exp2f(x - m_use);
          rs += x;
        }
      l[h2] = l[h2] * alpha[h2] + rs;
      m[h2] = m_new;
    }
  };
  // once the previous P V is done: O rescaled, and P rounded (cvt.rna)
  // into the A fragments, element i of k-step kc in key_of order
  auto rescale_round = [&]() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j + i] *= alpha[i / 2];
#pragma unroll
    for (int kc = 0; kc < NT; ++kc) {
      pa[kc][0] = round_tf32(sc[4 * kc]);
      pa[kc][1] = round_tf32(sc[4 * kc + 2]);
      pa[kc][2] = round_tf32(sc[4 * kc + 1]);
      pa[kc][3] = round_tf32(sc[4 * kc + 3]);
    }
  };

  mbar_wait(full, 0);
  wg_fence();
  scores(0);
  wg_commit();
  wg_wait<0>();
  reg_fence(sc);
  softmax(0);
  rescale_round();
  // tile n + 1's scores go to the tensor cores ahead of tile n's P V, so
  // its softmax runs while they multiply
  for (int n = 0; n + 1 < n_tiles; ++n) {
    // tile n - 1 + STAGES into the slot of tile n - 1, once every
    // warpgroup has released it (a test the block agrees on): copies run
    // two tiles ahead of their use
    if (n > 0 && n - 1 + STAGES < n_tiles) {
      mbar_wait(empty + (n - 1) % STAGES, ((n - 1) / STAGES) & 1);
      copy(n - 1 + STAGES);
    }
    mbar_wait(full + (n + 1) % STAGES, ((n + 1) / STAGES) & 1);
    wg_fence();
    scores(n + 1);
    wg_commit();
    products(n);
    wg_commit();
    wg_wait<1>();
    reg_fence(sc);
    softmax(n + 1);
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
    mbar_arrive_if(empty + n % STAGES, releaser);   // K_n, V_n^T read
    rescale_round();
  }
  wg_fence();
  products(n_tiles - 1);
  wg_commit();
  wg_wait<0>();
  reg_fence(acc);

  store_rows<D>(o + static_cast<size_t>(bh) * T * D, q0 + 16 * wl + g, T, t,
                l, acc);
}

template <int D>
int launch(const float* q, const float* kv, float* o, int B, int H, int T,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (T + BK - 1) / BK;
  const dim3 grid((T + NWG * BQ - 1) / (NWG * BQ), B * H);
  attn_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, kv, o, T, n_tiles, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace one_pass

// D = 64 or 128 to the instantiation, else cudaErrorInvalidValue
template <typename F64, typename F128>
int by_width(int D, F64 f64, F128 f128) {
  switch (D) {
    case 64: return f64();
    case 128: return f128();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attn_split_f32(const float* k, const float* v,
                                    const unsigned char* key_padding_mask,
                                    float* kv, int B, int H, int T, int D,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(
      D, [&] { return prep<64, 2>(k, v, key_padding_mask, kv, B, H, T, s); },
      [&] { return prep<128, 2>(k, v, key_padding_mask, kv, B, H, T, s); });
}

extern "C" int flash_attn_fwd_f32(const float* q, const float* kv, float* o,
                                  int B, int H, int T, int D, float scale,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(
      D, [&] { return three_pass::launch<64>(q, kv, o, B, H, T, scale, s); },
      [&] { return three_pass::launch<128>(q, kv, o, B, H, T, scale, s); });
}

extern "C" int flash_attn_prep_f32(const float* k, const float* v,
                                   const unsigned char* key_padding_mask,
                                   float* kv, int B, int H, int T, int D,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(
      D, [&] { return prep<64, 1>(k, v, key_padding_mask, kv, B, H, T, s); },
      [&] { return prep<128, 1>(k, v, key_padding_mask, kv, B, H, T, s); });
}

extern "C" int flash_attn_1pass_f32(const float* q, const float* kv,
                                    float* o, int B, int H, int T, int D,
                                    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(
      D, [&] { return one_pass::launch<64>(q, kv, o, B, H, T, scale, s); },
      [&] { return one_pass::launch<128>(q, kv, o, B, H, T, scale, s); });
}
