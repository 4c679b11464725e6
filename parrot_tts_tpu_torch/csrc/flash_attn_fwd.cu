// Flash-attention forward for Hopper (sm_90a), IEEE float32 on the CUDA cores.
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
// Bound on this card: 4*B*H*T^2*D floating-point operations (QK^T and PV)
// against 16*B*H*T*D bytes (Q, K, V read once, O written once). The
// arithmetic intensity is T/4 operations per byte, and the H100's float32
// ridge (67 TFLOP/s non-tensor over 3.35 TB/s) is 20, so at every serving
// length (T >= 64) the kernel is bound by float32 FMAs on the CUDA cores.
// Tensor cores would be faster but round operands to TF32, which flips the
// decoder's argmax near-ties and durations; the unit-exact decode needs
// IEEE float32, so every product here is a plain fmaf.
//
// What the design does about it: the (T, T) scores never reach device
// memory. One block of 256 threads owns 64 queries of one (b, h) and walks
// over 64-key tiles of K and V staged in shared memory (K transposed so the
// score loop reads conflict-free float4s). Each thread computes a 4x4
// register micro-tile of scores (16 FMAs per two shared-memory loads), keeps
// its 4 rows' running max and denominator in registers (reduced over the 16
// threads that share those rows with warp shuffles), and accumulates a 4 x
// (D/16) slice of the output. The ragged last tile of any T is masked in the
// kernel, so every length takes this path.
//
// Interface (route (b): plain C, loaded with ctypes):
//   int flash_attn_fwd_f32(q, k, v, key_padding_mask or NULL, o,
//                          B, H, T, D, scale, stream)
// q, k, v, o: contiguous (B, H, T, D) float32; key_padding_mask: contiguous
// (B, T) bytes (torch.bool), nonzero = ignore that key. Returns the CUDA
// error code of the launch (0 on success). D must be 64 or 128.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups

template <int D>
struct Layout {
  static constexpr int kQt = D * BQ;    // Q tile transposed, [d][q]
  static constexpr int kKt = D * BK;    // K tile transposed, [d][k]
  static constexpr int kV = BK * D;     // V tile, [k][d]
  static constexpr int kP = BQ * BK;    // probabilities, [q][k]
  static constexpr int kBias = BK;      // 0 or -inf per key of the tile
  static constexpr size_t bytes =
      sizeof(float) * (kQt + kKt + kV + kP + kBias);
};

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const unsigned char* __restrict__ kpm,
                 float* __restrict__ o, int H, int T, float scale) {
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  constexpr int D4 = D / 4;      // float4s per row
  constexpr int NV = D / 64;     // float4 output chunks per thread per row

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + Layout<D>::kQt;
  float* Vs = Kt + Layout<D>::kKt;
  float* Ps = Vs + Layout<D>::kV;
  float* kbias = Ps + Layout<D>::kP;

  const int tid = threadIdx.x;
  const int rg = tid / 16;       // rows rg*4 .. rg*4+3 of the query tile
  const int cg = tid % 16;       // keys cg*4.. of a tile; d cols n*64+cg*4..
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* qg = q + base;
  const float* kg = k + base;
  const float* vg = v + base;

  // Q tile, transposed; rows past T are zero and never stored
  for (int idx = tid; idx < BQ * D4; idx += THREADS) {
    const int r = idx % BQ, d4 = idx / BQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T)
      x = *reinterpret_cast<const float4*>(qg + static_cast<size_t>(q0 + r) * D + d4 * 4);
    Qt[(d4 * 4 + 0) * BQ + r] = x.x;
    Qt[(d4 * 4 + 1) * BQ + r] = x.y;
    Qt[(d4 * 4 + 2) * BQ + r] = x.z;
    Qt[(d4 * 4 + 3) * BQ + r] = x.w;
  }

  float m[4], l[4], acc[4][NV * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV * 4; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();   // Q staged (first tile); last tile's K/V/P reads done

    for (int idx = tid; idx < BK * D4; idx += THREADS) {
      const int c = idx % BK, d4 = idx / BK;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < T)
        x = *reinterpret_cast<const float4*>(kg + static_cast<size_t>(k0 + c) * D + d4 * 4);
      Kt[(d4 * 4 + 0) * BK + c] = x.x;
      Kt[(d4 * 4 + 1) * BK + c] = x.y;
      Kt[(d4 * 4 + 2) * BK + c] = x.z;
      Kt[(d4 * 4 + 3) * BK + c] = x.w;
    }
    for (int idx = tid; idx < BK * D4; idx += THREADS) {
      const int c = idx / D4, d4 = idx % D4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < T)
        x = *reinterpret_cast<const float4*>(vg + static_cast<size_t>(k0 + c) * D + d4 * 4);
      *reinterpret_cast<float4*>(Vs + c * D + d4 * 4) = x;
    }
    if (tid < BK) {
      const int j = k0 + tid;
      const bool valid =
          j < T && (kpm == nullptr || kpm[static_cast<size_t>(b) * T + j] == 0);
      kbias[tid] = valid ? 0.f : -INFINITY;
    }
    __syncthreads();

    // scores: 4x4 micro-tile, rows rg*4+i, keys cg*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * BQ + rg * 4);
      const float4 kb = *reinterpret_cast<const float4*>(Kt + d * BK + cg * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over this tile; the 16 threads of a half-warp share rows
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] * scale + kbias[cg * 4 + j];
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;  // all masked so far
      alpha[i] = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_new;
      *reinterpret_cast<float4*>(Ps + (rg * 4 + i) * BK + cg * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
#pragma unroll
      for (int c = 0; c < NV * 4; ++c) acc[i][c] *= alpha[i];
    }
    __syncthreads();

    // acc += P V over the tile's keys
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(Ps + (rg * 4 + i) * BK + c);
        p[i][0] = x.x; p[i][1] = x.y; p[i][2] = x.z; p[i][3] = x.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * D;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + n * 64 + cg * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][n * 4 + 0] = fmaf(p[i][cc], x.x, acc[i][n * 4 + 0]);
            acc[i][n * 4 + 1] = fmaf(p[i][cc], x.y, acc[i][n * 4 + 1]);
            acc[i][n * 4 + 2] = fmaf(p[i][cc], x.z, acc[i][n * 4 + 2]);
            acc[i][n * 4 + 3] = fmaf(p[i][cc], x.w, acc[i][n * 4 + 3]);
          }
        }
      }
    }
  }

  float* og = o + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= T) continue;
    const bool any = l[i] > 0.f;   // false only when every key is masked
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      float4 x;
      x.x = any ? acc[i][n * 4 + 0] / l[i] : 0.f;
      x.y = any ? acc[i][n * 4 + 1] / l[i] : 0.f;
      x.z = any ? acc[i][n * 4 + 2] / l[i] : 0.f;
      x.w = any ? acc[i][n * 4 + 3] / l[i] : 0.f;
      *reinterpret_cast<float4*>(og + static_cast<size_t>(row) * D + n * 64 + cg * 4) = x;
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

}  // namespace

extern "C" int flash_attn_fwd_f32(const float* q, const float* k,
                                  const float* v,
                                  const unsigned char* key_padding_mask,
                                  float* o, int B, int H, int T, int D,
                                  float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, key_padding_mask, o, B, H, T, scale, s);
    case 128:
      return launch<128>(q, k, v, key_padding_mask, o, B, H, T, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
