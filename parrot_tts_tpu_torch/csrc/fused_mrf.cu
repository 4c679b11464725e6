// One whole MRF stage of the HiFi-GAN vocoder in one kernel, for Hopper
// (sm_90a), IEEE float32 on the CUDA cores.
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
// (float32, 67 TFLOP/s without tensor cores) against the input and output
// (8 C bytes per sample) and the stage's 126 C^2 weights: at C = 16-64 the
// operations take 25-100x as long as the bytes, so FMAs bound the kernel.
//
// What the design does about it: the 18 convs' intermediates never reach
// device memory. A block owns tb output rows of one batch row and computes
// the stage on a strip of tb + 2 * halo rows held in shared memory, where
// halo (in samples) is the longest branch's one-sided receptive field: 60
// at V1 (5 + 15 + 25 for the k = 11 dilated convs, 3 x 5 for the plain
// ones). Each conv is computed only on the rows that later convs still
// need, so the recompute shrinks conv by conv to exactly tb rows at the
// branch's end. Three strips: y (the branch state), leaky(y), and
// leaky(t). Each thread computes a 4-row x 8-channel micro-tile: 4 shared
// reads (broadcast, rows padded to C + 1 floats so they hit distinct banks)
// and 2 float4 weight reads (L1/L2; a stage's weights are 2 MB at C = 64,
// too large to stage) per 32 FMAs. The branch mean accumulates in the
// output, which each thread owns for its rows. The ragged last tile is
// masked; any T works. No TF32: every product is a plain fmaf.
//
// Interface (plain C, loaded with ctypes):
//   int fused_mrf_f32(x, w, bias, out, B, T, C, n_branch, kernel_sizes,
//                     n_pairs, dilations, halo, stream)
// x, out: contiguous (B, T, C) float32; w: the 2 * sum(n_pairs) conv
// kernels, each (K, C, C) = [tap][ci][co], in order branch, pair, (dilated,
// plain); bias: their (C,) biases in the same order. kernel_sizes, n_pairs:
// n_branch ints on the host; dilations: n_branch x 4 ints on the host.
// C must be a multiple of 8. Returns the CUDA error code of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int MAXB = 4;        // branches
constexpr int MAXP = 4;        // pairs per branch
constexpr int THREADS = 256;
constexpr int RM = 4;          // rows per thread
constexpr int CN = 8;          // channels per thread
constexpr float SLOPE = 0.1f;

struct Plan {
  int nb;
  int k[MAXB];
  int np[MAXB];
  int d[MAXB][MAXP];
  int halo;
};

__device__ __forceinline__ float leaky(float v) { return fmaxf(v, SLOPE * v); }

// One 'same' conv over strip rows [lo, hi): reads src rows lo - pad ..
// hi - 1 + pad (all inside the strip). mode 1 stores leaky(valid * y) in
// dst; mode 2 adds valid * y to dst (the residual y) in place and stores
// leaky of the sum in dst_leaky, and, on the branch's last pair, folds the
// sum into the output.
__device__ void conv_rows(const float* __restrict__ src, float* dst,
                          float* dst_leaky, const float* __restrict__ w,
                          const float* __restrict__ bias, int K, int dil,
                          int pad, int lo, int hi, int S, int C, int g0,
                          int T, int mode, bool last, int br, int nb,
                          float* ob, int H, int tid) {
  const int CG = C / CN;
  const int RG = THREADS / CG;
  const int cg = tid % CG, rg = tid / CG;
  if (rg >= RG) return;
  const int co = cg * CN;
  float bv[CN];
#pragma unroll
  for (int j = 0; j < CN; ++j) bv[j] = __ldg(bias + co + j);

  for (int r0 = lo + rg * RM; r0 < hi; r0 += RG * RM) {
    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = bv[j];
    int rr[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) rr[i] = min(r0 + i, hi - 1);   // ragged pass

    for (int tap = 0; tap < K; ++tap) {
      const int off = tap * dil - pad;
      const float* s[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) s[i] = src + (rr[i] + off) * S;
      const float* wt = w + static_cast<size_t>(tap) * C * C + co;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(wt + ci * C));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(wt + ci * C + 4));
        const float wv[CN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float a = s[i][ci];
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = r0 + i;
      if (r >= hi) break;
      const int t = g0 + r;
      const bool valid = t >= 0 && t < T;
      float* drow = dst + r * S + co;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float v = valid ? acc[i][j] : 0.f;
        if (mode == 1) {
          drow[j] = leaky(v);
        } else {
          const float y = drow[j] + v;
          drow[j] = y;
          dst_leaky[r * S + co + j] = leaky(y);
          if (last && valid) {      // rows [H, H + tb) by construction
            float* o = ob + static_cast<size_t>(t) * C + co + j;
            float m = br == 0 ? y : *o + y;
            if (br == nb - 1) m = m * (1.0f / nb);
            *o = m;
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mrf_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias, float* __restrict__ out, int T,
           int C, int tb, Plan plan) {
  extern __shared__ float sm[];
  const int S = C + 1;
  const int H = plan.halo;
  const int L = tb + 2 * H;
  float* Y = sm;            // branch state y
  float* LY = Y + L * S;    // leaky(y)
  float* TB = LY + L * S;   // leaky(conv1 output)
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * tb - H;   // sequence row of strip row 0
  const float* xb = x + static_cast<size_t>(b) * T * C;
  float* ob = out + static_cast<size_t>(b) * T * C;
  const int tid = threadIdx.x;

  size_t woff = 0;
  int boff = 0;
  for (int br = 0; br < plan.nb; ++br) {
    const int K = plan.k[br];
    int rem = 0;
    for (int p = 0; p < plan.np[br]; ++p)
      rem += (K - 1) * plan.d[br][p] / 2 + (K - 1) / 2;

    // the rows this branch needs: [H - rem, H + tb + rem)
    const int lo = H - rem, n = tb + 2 * rem;
    for (int idx = tid; idx < n * C; idx += THREADS) {
      const int r = lo + idx / C, c = idx % C;
      const int t = g0 + r;
      const float v = (t >= 0 && t < T) ? xb[static_cast<size_t>(t) * C + c] : 0.f;
      Y[r * S + c] = v;
      LY[r * S + c] = leaky(v);
    }
    __syncthreads();

    for (int p = 0; p < plan.np[br]; ++p) {
      const int d = plan.d[br][p];
      const int p1 = (K - 1) * d / 2, p2 = (K - 1) / 2;
      const float* w1 = w + woff;
      const float* w2 = w1 + static_cast<size_t>(K) * C * C;
      const float* b1 = bias + boff;
      const float* b2 = b1 + C;
      woff += 2 * static_cast<size_t>(K) * C * C;
      boff += 2 * C;
      conv_rows(LY, TB, nullptr, w1, b1, K, d, p1, H - rem + p1,
                H + tb + rem - p1, S, C, g0, T, 1, false, br, plan.nb, ob, H,
                tid);
      __syncthreads();
      rem -= p1 + p2;
      conv_rows(TB, Y, LY, w2, b2, K, 1, p2, H - rem, H + tb + rem, S, C, g0,
                T, 2, p == plan.np[br] - 1, br, plan.nb, ob, H, tid);
      __syncthreads();
    }
  }
}

size_t smem_bytes(int tb, int halo, int C) {
  return 3 * static_cast<size_t>(tb + 2 * halo) * (C + 1) * sizeof(float);
}

// The time tile: the largest multiple of 32 (up to 1024) whose strips fit
// two blocks per SM (113 KB each) while tb >= 2 * halo; else the largest
// that fits one block (227 KB); else 16 rows.
int pick_tb(int halo, int C) {
  const size_t budgets[2] = {115712, 232448};
  for (size_t budget : budgets) {
    for (int tb = 1024; tb >= 32; tb -= 32)
      if (smem_bytes(tb, halo, C) <= budget && (budget > 115712 || tb >= 2 * halo))
        return tb;
  }
  return 16;
}

}  // namespace

extern "C" int fused_mrf_tile(int halo, int C) { return pick_tb(halo, C); }

extern "C" int fused_mrf_f32(const float* x, const float* w, const float* bias,
                             float* out, int B, int T, int C, int n_branch,
                             const int* kernel_sizes, const int* n_pairs,
                             const int* dilations, int halo, void* stream) {
  if (n_branch < 1 || n_branch > MAXB || C % CN != 0 || C / CN > THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan{};
  plan.nb = n_branch;
  plan.halo = halo;
  for (int br = 0; br < n_branch; ++br) {
    if (n_pairs[br] < 1 || n_pairs[br] > MAXP)
      return static_cast<int>(cudaErrorInvalidValue);
    plan.k[br] = kernel_sizes[br];
    plan.np[br] = n_pairs[br];
    for (int p = 0; p < n_pairs[br]; ++p) plan.d[br][p] = dilations[br * MAXP + p];
  }
  const int tb = pick_tb(halo, C);
  const size_t bytes = smem_bytes(tb, halo, C);
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mrf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + tb - 1) / tb, B);
  mrf_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, T, C, tb, plan);
  return static_cast<int>(cudaGetLastError());
}
