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
// Numerics: every product of the two matrix products is 3xTF32. Each
// float32 operand x is split exactly as x = hi + lo (Veltkamp: hi is x
// rounded to 11 significant bits, a TF32 value), and a * b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b (the small terms first) on the TF32
// tensor cores. Their float32 accumulation does not round to nearest, so
// a long sum there drifts: they sum only short partials from zero (4 k
// steps, 32 of d, of S = Q K^T; one 32-key tile of P V), which IEEE float32
// adds to the running sums. The dropped lo_a lo_b and the bits of lo that
// TF32 drops leave each product within ~5 * 2^-22 of its float32 value,
// so the result stays close to the IEEE float32 plain version: phase 3 of
// chip_smoke.py holds it to 1e-5 absolute, and phase 4 to the unit-exact
// decode. Plain TF32 (one product of hi parts, ~2^-11 relative) would flip
// the decoder's argmax near-ties and durations. The softmax (scale, mask, max, exp, sums, the division) is
// IEEE float32 on the CUDA cores.
//
// 1-pass mode (the TPU's default precision, which the JAX package's
// "selective" decode and exact=False run; its own kernels, below): each
// operand of a product (Q, K, P, V) is rounded to TF32 once, to nearest
// (cvt.rna), and each product is one TF32 pass. P is rounded against the
// running row max of its 32-key tile, then rescaled by the running max's
// change, and the plain version (ops/flash_attention.py) rounds it the same
// way. The products of TF32 values are exact in float32, so the two differ
// only by the order of float32 sums (and exp2 of the base-2 scores against
// exp), which now and then sends a weight to the neighbouring TF32 value
// (<= 2^-10 of it; the output by <= 2^-10 max |v|). Masking and the zero
// row are as in 3xTF32 mode.
//
// Bound on this card: 4*B*H*T^2*D floating-point operations (QK^T and PV)
// against 16*B*H*T*D bytes (Q, K, V read once, O written once); T/4
// operations per byte. Against the float32 rate of the CUDA cores (67
// TFLOP/s, ridge 20) every serving length is bound by operations; so are
// the 3xTF32 products (3 * 4*B*H*T^2*D at 494.7 TFLOP/s dense TF32, ridge
// 148) above T ~ 200, with the split's conversions on the CUDA cores
// beside them. The 1-pass mode's bound is one third of that: 4*B*H*T^2*D
// at 494.7 TFLOP/s (ridge 148 as well).
//
// The design: the (T, T) scores never reach device memory. One block of
// 128 threads (4 warps, 16 queries each) owns 64 queries of one (b, h),
// whose Q tile it copies to shared memory once (each warp splits its
// fragments per tile: Q in registers would take 64 of them), and walks
// 32-key tiles of K and V, copied by cp.async into a two-stage
// shared-memory ring (tile n+1 lands while tile n is multiplied; one
// barrier per tile; rows past T zero-filled). Products are mma.sync
// m16n8k8 TF32 with float32 accumulators: S = Q K^T reads K as the
// column-major B, O += P V takes P from the score accumulators in
// registers and V as B. Inside every 8-wide k step the contraction index
// is permuted (logical k t <-> element 2t, t+4 <-> 2t+1), which makes the
// A fragment of P exactly the accumulator fragment of S (no shuffles) and
// turns the Q and K fragments into float2 loads; Q's and K's rows are
// padded to D+8 floats and V's to D+4, so the fragment loads hit 32
// banks. Each row's running max and sum stay in registers (online
// softmax; the sum is reduced across the quad once, at the end). Any T: the key bias is 0 or
// -inf per key, -inf past T, so the ragged last tile takes the same path.
//
// The 1-pass design (one_pass::, on wgmma, which gives the TF32 rate's
// other half: mma.sync with one product per k step was issue-bound, ~11%
// of the bound). wgmma's TF32 form takes both shared-memory operands
// K-major, with no transpose: P V wants V^T, which TMA cannot make of
// 4-byte elements, and the tensor cores read a float32 operand's TF32 bits
// truncated, where the mode rounds. So two kernels:
// - prep_kernel (the pre-pass; one block per (32-key tile, b h)) writes
//   each key tile, rounded, into scratch the wrapper allocates: K as
//   [D / 4][32][4] (the K-major no-swizzle core matrices of S = Q K^T's
//   B), the tile's key bias (0, or -inf masked or past T), and V^T as
//   [8][D][4] whose logical k of every 8 holds key key_of(k): the P
//   fragment's order (logical k t is key 2t, t + 4 key 2t + 1), which makes
//   the S accumulator, rounded, the A fragment of P V with no shuffles. It
//   reads K and V once and writes them once: 16 B*H*T*D bytes.
// - attn_kernel: a block of three warpgroups (64 queries each, the wgmma
//   m). One thread bulk-copies whole tiles (K, bias, V^T: 32 KB at D =
//   128) into a 4-slot ring with a full and an empty mbarrier per slot (no
//   block barrier per tile), each two tiles ahead of its use, once every
//   warpgroup has released the slot (all threads wait, thread 0 copies:
//   a predicate, so no divergent path sits among the wgmmas; a producer
//   warp beside three warpgroups would cap ptxas at 128 registers).
//   Each warpgroup rounds its Q into shared memory once, [D / 4][64][4]
//   (its fragments in registers, D / 2 a thread, left too few registers
//   for the rest: they spilled at ptxas's 168). Per tile
//   n: S_n = Q K_n^T, D / 8 wgmma m64n32k8 with both operands in shared
//   memory, from zero; the online softmax in base 2 on the accumulators
//   (the row max over the quad by two shuffles); O rescaled and P rounded
//   (cvt.rna) into registers; O +=
//   P V, 4 wgmma m64nDk8 with A from registers; one thread then releases
//   the slot. S_{n+1} is issued ahead of P_n V_n, so tile n + 1's softmax
//   runs while P_n V_n multiplies; O's rescale and P's rounding wait for
//   P_n V_n. The wgmmas of a product issue straight-line (ptxas
//   serializes them around a branch among them; the last tile's P V is
//   peeled off the loop); the three warpgroups interleave on the SM's
//   tensor cores. One block per SM (192 queries: at (5, 2, 2048, 128)
//   110 blocks, one wave); shared memory 230,016 bytes (115,328 at D =
//   64).
//
// Interface (route (b): plain C, loaded with ctypes):
//   int flash_attn_fwd_f32(q, k, v, key_padding_mask or NULL, o,
//                          B, H, T, D, scale, stream)
// the 3xTF32 mode. q, k, v, o: contiguous (B, H, T, D) float32, 16-byte
// aligned; key_padding_mask: contiguous (B, T) bytes (torch.bool), nonzero
// = ignore that key.
//   int flash_attn_prep_f32(k, v, key_padding_mask or NULL, kv, B, H, T, D,
//                           stream)
// the pre-pass into kv: (B*H, ceil(T / 32), 2*D*32 + 32) float32.
//   int flash_attn_1pass_f32(q, kv, o, B, H, T, D, scale, stream)
// the 1-pass kernel on the pre-pass's kv. Each returns the CUDA error code
// of the launch (0 on success). D must be 64 or 128, B*H at most 65,535.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;   // split_a, mma3, add, cp_async16, round_tf32,
                          // wgmma_tf32, wgmma_tf32_ss

constexpr int BQ = 64;        // queries per block, 16 per warp
constexpr int BK = 32;        // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int STAGES = 2;     // copy ring

template <int D>
struct Layout {
  static constexpr int kLdK = D + 8;   // Q and K row stride (floats)
  static constexpr int kLdV = D + 4;   // V row stride (floats)
  static constexpr int kQ = BQ * kLdK, kK = BK * kLdK, kV = BK * kLdV;
  static constexpr int kStage = kK + kV + BK;   // K, V, the key bias
  static constexpr size_t bytes = sizeof(float) * (kQ + STAGES * kStage);
};

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const unsigned char* __restrict__ kpm,
                 float* __restrict__ o, int H, int T, float scale) {
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  using L = Layout<D>;
  constexpr int KC = D / 8;      // k steps of Q K^T; n-tiles of P V
  constexpr int NT = BK / 8;     // n-tiles of Q K^T; k steps of P V

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* kg = k + base;
  const float* vg = v + base;
  const int n_tiles = (T + BK - 1) / BK;
  constexpr int C = D / 4;       // 16-byte chunks per row

  // the block's Q (rows past T zero), with the first tile
  for (int idx = threadIdx.x; idx < BQ * C; idx += THREADS) {
    const int r = idx / C, c = (idx % C) * 4;
    const bool ok = q0 + r < T;
    cp_async16(Qs + r * L::kLdK + c,
               q + base + (ok ? static_cast<size_t>(q0 + r) * D + c : 0), ok);
  }
  // tile n of K, V (rows past T zero) and its key bias into stage st
  auto load = [&](int st, int n) {
    float* Ks = smem + L::kQ + st * L::kStage;
    float* Vs = Ks + L::kK;
    const int k0 = n * BK;
    for (int idx = threadIdx.x; idx < BK * C; idx += THREADS) {
      const int r = idx / C, c = (idx % C) * 4;
      const bool ok = k0 + r < T;
      const size_t off = ok ? static_cast<size_t>(k0 + r) * D + c : 0;
      cp_async16(Ks + r * L::kLdK + c, kg + off, ok);
      cp_async16(Vs + r * L::kLdV + c, vg + off, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (threadIdx.x < BK) {
      const int j = k0 + threadIdx.x;
      const bool valid =
          j < T && (kpm == nullptr || kpm[static_cast<size_t>(b) * T + j] == 0);
      Vs[L::kV + threadIdx.x] = valid ? 0.f : -INFINITY;
    }
  };
  load(0, 0);
  // this warp's Q rows g and g+8: A fragment k step kc is elements
  // (2t, 2t+1) of each (the permuted k order)
  const float* q_g = Qs + (warp * 16 + g) * L::kLdK + 2 * t;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[KC][4];
#pragma unroll
  for (int nt = 0; nt < KC; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n & (STAGES - 1);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // tile n is in; every warp is done with tile n-1
    if (n + 1 < n_tiles) load(st ^ 1, n + 1);
    const float* Ks = smem + L::kQ + st * L::kStage;
    const float* Vs = Ks + L::kK;
    const float* kbias = Vs + L::kV;

    // S = Q K^T: accumulator (nt, e) is row g + 8*(e/2), key 8nt + 2t + e%2;
    // partial sums over 4 k steps (32 of d) on the tensor cores, added in
    // float32
    float s[NT][4], d[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = d[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const float2 x0 = *reinterpret_cast<const float2*>(q_g + kc * 8);
      const float2 x1 = *reinterpret_cast<const float2*>(q_g + 8 * L::kLdK + kc * 8);
      const SplitA a = split_a(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 kb = *reinterpret_cast<const float2*>(
            Ks + (nt * 8 + g) * L::kLdK + kc * 8 + 2 * t);
        mma3(d[nt], a, kb.x, kb.y);
        if (kc % 4 == 3) add(s[nt], d[nt]);
      }
    }

    // online softmax over this tile, rows g (h2 = 0) and g+8 (h2 = 1)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mt = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h2; e < 2 * h2 + 2; ++e) {
          s[nt][e] = s[nt][e] * scale + kbias[nt * 8 + 2 * t + (e & 1)];
          mt = fmaxf(mt, s[nt][e]);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[h2], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
      const float alpha = expf(m[h2] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h2; e < 2 * h2 + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - m_use);
          rs += s[nt][e];
        }
      l[h2] = l[h2] * alpha + rs;   // this lane's keys; the quad's at the end
      m[h2] = m_new;
#pragma unroll
      for (int dt = 0; dt < KC; ++dt) {
        acc[dt][2 * h2] *= alpha;
        acc[dt][2 * h2 + 1] *= alpha;
      }
    }

    // O += P V: k step kc is keys 8kc.., whose permuted A fragment is the
    // accumulator fragment s[kc]; B element (k t, n g) is V[8kc + 2t][n],
    // (k t+4, n g) is V[8kc + 2t + 1][n]. The tile's partial sums on the
    // tensor cores, added in float32.
    SplitA pa[NT];
#pragma unroll
    for (int kc = 0; kc < NT; ++kc)
      pa[kc] = split_a(s[kc][0], s[kc][2], s[kc][1], s[kc][3]);
    const float* v0 = Vs + 2 * t * L::kLdV + g;
#pragma unroll
    for (int dt = 0; dt < KC; ++dt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < NT; ++kc)
        mma3(part, pa[kc], v0[kc * 8 * L::kLdV + dt * 8],
             v0[(kc * 8 + 1) * L::kLdV + dt * 8]);
      add(acc[dt], part);
    }
  }

  float* og = o + base;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
    const int row = q0 + warp * 16 + g + 8 * h2;
    if (row >= T) continue;
    const bool any = l[h2] > 0.f;   // false only when every key is masked
#pragma unroll
    for (int dt = 0; dt < KC; ++dt) {
      const float2 x = make_float2(any ? acc[dt][2 * h2] / l[h2] : 0.f,
                                   any ? acc[dt][2 * h2 + 1] / l[h2] : 0.f);
      *reinterpret_cast<float2*>(og + static_cast<size_t>(row) * D + dt * 8 + 2 * t) = x;
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v,
           const unsigned char* kpm, float* o, int B, int H, int T,
           float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(q, k, v, kpm, o, H, T,
                                                        scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- the 1-pass TF32 mode on wgmma -----------------------------------------

namespace one_pass {

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
constexpr int NWG = 3;         // warpgroups per block
constexpr int STAGES = 4;      // key tiles in the ring
constexpr int THREADS = 128 * NWG;
constexpr int PREP_THREADS = 256;

// the key order inside each 8 keys of a V^T tile: logical k t holds key 2t,
// t + 4 key 2t + 1 (the P fragment's, tf32x3.cuh)
__host__ __device__ constexpr int key_of(int p) {
  return (p & ~7) | ((p & 7) < 4 ? 2 * (p & 7) : 2 * (p & 7) - 7);
}

// one prepared key tile, as prep_kernel writes it and a ring slot holds
// it: K [D / 4][BK][4], the key bias [BK] (0, or -inf for a padded key or
// one past T), V^T [BK / 4][D][4] in key_of order; K and V rounded to TF32
template <int D>
struct Tile {
  static constexpr int kK = D * BK, kBias = BK, kV = BK * D;
  static constexpr int floats = kK + kBias + kV;
  static constexpr uint32_t bytes = 4 * floats;
};

// shared memory: the ring's full and empty mbarriers (128 bytes), each
// warpgroup's Q [D / 4][BQ][4], the ring
template <int D>
constexpr size_t smem_bytes() {
  return 128 + 4 * (static_cast<size_t>(NWG) * BQ * D +
                    static_cast<size_t>(STAGES) * Tile<D>::floats);
}

__device__ __forceinline__ float rounded(float x) {
  return __uint_as_float(round_tf32(x) & 0xFFFFE000u);
}

// the pre-pass: one block per (key tile, b h) writes the tile's K, bias
// and V^T, rounded, into the scratch the wrapper allocates
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const float* __restrict__ k, const float* __restrict__ v,
            const unsigned char* __restrict__ kpm, float* __restrict__ kv,
            int H, int T, int n_tiles) {
  using TL = Tile<D>;
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
    *reinterpret_cast<float4*>(ks + r * LD + 4 * c) =
        make_float4(rounded(x.x), rounded(x.y), rounded(x.z), rounded(x.w));
    *reinterpret_cast<float4*>(vs + r * LD + 4 * c) =
        make_float4(rounded(y.x), rounded(y.y), rounded(y.z), rounded(y.w));
  }
  if (threadIdx.x < BK) {
    const int j = k0 + threadIdx.x;
    const bool valid =
        j < T && (kpm == nullptr || kpm[static_cast<size_t>(b) * T + j] == 0);
    tile[TL::kK + threadIdx.x] = valid ? 0.f : -INFINITY;
  }
  __syncthreads();
  // K: 16-byte chunk j = c BK + r holds row r's d 4c..4c+3
  for (int j = threadIdx.x; j < C * BK; j += PREP_THREADS)
    reinterpret_cast<float4*>(tile)[j] =
        *reinterpret_cast<const float4*>(ks + (j % BK) * LD + 4 * (j / BK));
  // V^T: chunk j = g D + d holds d of logical keys 4g..4g+3
  float* vt = tile + TL::kK + TL::kBias;
  for (int j = threadIdx.x; j < BK / 4 * D; j += PREP_THREADS) {
    const int p = 4 * (j / D), d = j % D;
    reinterpret_cast<float4*>(vt)[j] =
        make_float4(vs[key_of(p) * LD + d], vs[key_of(p + 1) * LD + d],
                    vs[key_of(p + 2) * LD + d], vs[key_of(p + 3) * LD + d]);
  }
}

// the 1-pass attention on prepared tiles (header: the 1-pass mode)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_kernel(const float* __restrict__ q, const float* __restrict__ kv,
            float* __restrict__ o, int T, int n_tiles, float scale_log2) {
  using TL = Tile<D>;
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

  float* og = o + static_cast<size_t>(bh) * T * D;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
    const int row = q0 + 16 * wl + g + 8 * h2;
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

template <int D>
int prep(const float* k, const float* v, const unsigned char* kpm, float* kv,
         int B, int H, int T, cudaStream_t stream) {
  const int n_tiles = (T + BK - 1) / BK;
  prep_kernel<D><<<dim3(n_tiles, B * H), PREP_THREADS, 0, stream>>>(
      k, v, kpm, kv, H, T, n_tiles);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

extern "C" int flash_attn_fwd_f32(const float* q, const float* k,
                                  const float* v,
                                  const unsigned char* key_padding_mask,
                                  float* o, int B, int H, int T, int D,
                                  float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, key_padding_mask, o, B, H, T, scale, s);
    case 128:
      return launch<128>(q, k, v, key_padding_mask, o, B, H, T, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attn_prep_f32(const float* k, const float* v,
                                   const unsigned char* key_padding_mask,
                                   float* kv, int B, int H, int T, int D,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return one_pass::prep<64>(k, v, key_padding_mask, kv, B, H, T, s);
    case 128:
      return one_pass::prep<128>(k, v, key_padding_mask, kv, B, H, T, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attn_1pass_f32(const float* q, const float* kv,
                                    float* o, int B, int H, int T, int D,
                                    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return one_pass::launch<64>(q, kv, o, B, H, T, scale, s);
    case 128: return one_pass::launch<128>(q, kv, o, B, H, T, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
