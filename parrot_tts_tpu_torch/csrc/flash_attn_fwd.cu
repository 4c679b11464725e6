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
// 1-pass mode (passes = 1; the TPU's default precision, which the JAX
// package's "selective" decode and exact=False run): each operand of a
// product (Q, K, P, V) is rounded to TF32 once, to nearest, and each product
// takes one mma.sync in place of three (each warp rounds its fragments as
// it loads them, one cvt.rna each). P is rounded against the running row
// max of its 32-key tile, then rescaled by exp(m_old - m_new), and the
// plain version (ops/flash_attention.py) rounds it the same way. The
// products of TF32 values are exact in float32, so the two differ only by
// the order of float32 sums, which now and then sends a weight to the
// neighbouring TF32 value (<= 2^-10 of it; the output by <= 2^-10 max |v|).
// Softmax, masking and the zero row are as in 3xTF32 mode.
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
// (wgmma would give the TF32 rate's other half, but its TF32 form wants
// both operands K-major: P V would need a transposed copy of V, which TMA
// cannot make for 4-byte elements.)
//
// Interface (route (b): plain C, loaded with ctypes):
//   int flash_attn_fwd_f32(q, k, v, key_padding_mask or NULL, o,
//                          B, H, T, D, scale, passes, stream)
// q, k, v, o: contiguous (B, H, T, D) float32, 16-byte aligned;
// key_padding_mask: contiguous (B, T) bytes (torch.bool), nonzero = ignore
// that key. passes: 3 (3xTF32) or 1 (one TF32 pass). Returns the CUDA error
// code of the launch (0 on success). D must be 64 or 128.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;   // split_a, mma3, round_a, mma1, add, cp_async16

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

// the A fragment and the product of a mode: kSplit, 3xTF32 (SplitA, mma3);
// else one TF32 pass (RoundA, mma1)
template <bool kSplit>
using FragA = std::conditional_t<kSplit, SplitA, RoundA>;

template <bool kSplit>
__device__ __forceinline__ FragA<kSplit> fragment_a(float a0, float a1,
                                                    float a2, float a3) {
  if constexpr (kSplit) return split_a(a0, a1, a2, a3);
  else return round_a(a0, a1, a2, a3);
}

__device__ __forceinline__ void product(float (&c)[4], const SplitA& a,
                                        float b0, float b1) {
  mma3(c, a, b0, b1);
}

__device__ __forceinline__ void product(float (&c)[4], const RoundA& a,
                                        float b0, float b1) {
  mma1(c, a, b0, b1);
}

template <int D, bool kSplit>
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
      const FragA<kSplit> a = fragment_a<kSplit>(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 kb = *reinterpret_cast<const float2*>(
            Ks + (nt * 8 + g) * L::kLdK + kc * 8 + 2 * t);
        product(d[nt], a, kb.x, kb.y);
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
    FragA<kSplit> pa[NT];
#pragma unroll
    for (int kc = 0; kc < NT; ++kc)
      pa[kc] = fragment_a<kSplit>(s[kc][0], s[kc][2], s[kc][1], s[kc][3]);
    const float* v0 = Vs + 2 * t * L::kLdV + g;
#pragma unroll
    for (int dt = 0; dt < KC; ++dt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < NT; ++kc)
        product(part, pa[kc], v0[kc * 8 * L::kLdV + dt * 8],
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

template <int D, bool kSplit>
int launch(const float* q, const float* k, const float* v,
           const unsigned char* kpm, float* o, int B, int H, int T,
           float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D, kSplit><<<grid, THREADS, bytes, stream>>>(
      q, k, v, kpm, o, H, T, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSplit>
int launch_d(const float* q, const float* k, const float* v,
             const unsigned char* kpm, float* o, int B, int H, int T, int D,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64, kSplit>(q, k, v, kpm, o, B, H, T, scale, stream);
    case 128:
      return launch<128, kSplit>(q, k, v, kpm, o, B, H, T, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attn_fwd_f32(const float* q, const float* k,
                                  const float* v,
                                  const unsigned char* key_padding_mask,
                                  float* o, int B, int H, int T, int D,
                                  float scale, int passes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (passes) {
    case 3:
      return launch_d<true>(q, k, v, key_padding_mask, o, B, H, T, D, scale, s);
    case 1:
      return launch_d<false>(q, k, v, key_padding_mask, o, B, H, T, D, scale,
                             s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
