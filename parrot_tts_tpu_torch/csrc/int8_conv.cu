// int8 stride-1 dilated NWC convolution for Hopper (sm_90a), int32 accumulation
// on the int8 tensor cores, with a fused dequantize / bias / leaky epilogue.
//
// Replaces: parrot_tts_tpu/ops/pallas_qconv.py::_conv_kernel (driven by
// int8_conv_nwc_pallas, pallas_qconv.py:42-154). It computes, for xq (B, T, Ci)
// int8 and a kernel w (K, Ci, Co) int8 (stored as wt (K, Co, Ci), each output
// channel's taps rows of Ci contiguous bytes),
//     acc[b, t, co] = sum_{tap, ci} xq[b, t + tap*dil - pad_left, ci] * wt[tap, co, ci]
// in int32 (rows outside [0, T) read as zero), then
//     y = float(acc) * scale[b, co] + bias[co]     (__fmul_rn, then __fadd_rn)
//     y = max(y, slope * y)                        (when leaky is set)
// and writes y as float32 (B, T_out, Co). The two roundings of the epilogue
// are written out, so no FMA contracts them and the result is bit-identical
// to the plain PyTorch version in ops/qconv.py (an exact float64 conv, then
// the same float32 multiply and add).
//
// Bound on this card: 2*B*T_out*K*Ci*Co int8 operations against the bytes of
// xq, the weights, scale, bias and the float32 output. At the vocoder's
// widths (Ci 16-512, K 3-11) the operations over 1,979 TOP/s and the bytes
// over 3.35 TB/s are of the same order; the float32 output (4 bytes per
// element against 1 byte in) dominates the bytes at the narrow stages.
//
// What the design does about it: an implicit GEMM with M = output time rows,
// N = Co and the reduction taps x Ci, on mma.sync m16n8k32 s8 tiles (exact:
// every product and sum is an integer below 2^31). A block of 4 warps owns a
// 64-row x 64-channel output tile. For each chunk of 32 input channels it
// stages one slab of 64 + (K-1)*dil input rows (every tap reads a shifted
// window of the same slab, so dilation costs no extra loads) and the chunk's
// weights for all taps, each row padded to 48 bytes so the fragment reads
// are free of bank conflicts. Ci that is not a multiple of 32 is zero-padded
// in shared memory; n8 tiles past Co are skipped. Any T, ragged edges masked.
// wgmma and TMA are later work.
//
// Interface (plain C, loaded with ctypes):
//   int int8_conv_s8(xq, wt, scale, scale_bstride, bias or NULL, out, B, T,
//                    Ci, K, Co, T_out, pad_left, dil, leaky, slope, stream)
// xq: contiguous (B, T, Ci) int8; wt: contiguous (K, Co, Ci) int8; scale:
// (B, Co) float32, element [b, co] at b * scale_bstride + co (0 broadcasts
// one (Co,) vector over the batch); bias: (Co,) float32 or NULL; out:
// contiguous (B, T_out, Co) float32. Returns the CUDA error code of the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output channels per block
constexpr int BK = 32;          // input channels per chunk (one mma depth)
constexpr int THREADS = 128;    // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int ROW_BYTES = 48;   // 32 data bytes + 16 pad: conflict-free reads

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 consecutive int8 of a row (elements i0..i0+3, zero past n) as one word
__device__ __forceinline__ uint32_t load4(const int8_t* row, int i0, int n) {
  if ((n & 3) == 0 && i0 + 4 <= n)
    return *reinterpret_cast<const uint32_t*>(row + i0);
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i0 + j < n) v |= static_cast<uint32_t>(static_cast<uint8_t>(row[i0 + j])) << (8 * j);
  return v;
}

__global__ void __launch_bounds__(THREADS)
int8_conv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wt,
                 const float* __restrict__ scale, int scale_bstride,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int T, int Ci, int K, int Co, int T_out, int pad_left,
                 int dil, int leaky, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slab_rows = BM + (K - 1) * dil;
  unsigned char* xs = smem;                           // [slab_rows][ROW_BYTES]
  unsigned char* ws = smem + slab_rows * ROW_BYTES;   // [K][BN][ROW_BYTES]

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32;     // warp's rows within the tile
  const int wn = (warp & 1) * 32;      // warp's channels within the tile
  const int g = lane >> 2, tg = lane & 3;

  // n8 tiles of this warp that hold a channel < Co (warp-uniform)
  int n_tiles = (Co - (n0 + wn) + 7) / 8;
  n_tiles = n_tiles < 0 ? 0 : (n_tiles > 4 ? 4 : n_tiles);

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int8_t* xb = xq + static_cast<size_t>(b) * T * Ci;
  for (int c0 = 0; c0 < Ci; c0 += BK) {
    __syncthreads();   // the previous chunk's fragment reads are done
    for (int idx = tid; idx < slab_rows * 8; idx += THREADS) {
      const int r = idx >> 3, w4 = idx & 7;
      const int t = m0 - pad_left + r;
      uint32_t v = 0;
      if (t >= 0 && t < T) v = load4(xb + static_cast<size_t>(t) * Ci + c0, w4 * 4, Ci - c0);
      *reinterpret_cast<uint32_t*>(xs + r * ROW_BYTES + w4 * 4) = v;
    }
    for (int idx = tid; idx < K * BN * 8; idx += THREADS) {
      const int w4 = idx & 7, n = (idx >> 3) % BN, tap = (idx >> 3) / BN;
      const int co = n0 + n;
      uint32_t v = 0;
      if (co < Co)
        v = load4(wt + (static_cast<size_t>(tap) * Co + co) * Ci + c0, w4 * 4, Ci - c0);
      *reinterpret_cast<uint32_t*>(ws + (tap * BN + n) * ROW_BYTES + w4 * 4) = v;
    }
    __syncthreads();

    for (int tap = 0; tap < K; ++tap) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const unsigned char* p0 = xs + (tap * dil + wm + mi * 16 + g) * ROW_BYTES + tg * 4;
        const unsigned char* p1 = p0 + 8 * ROW_BYTES;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p0);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p1);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if (ni >= n_tiles) break;
        const unsigned char* q = ws + (tap * BN + wn + ni * 8 + g) * ROW_BYTES + tg * 4;
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(q);
        bf[1] = *reinterpret_cast<const uint32_t*>(q + 16);
        mma_s8(acc[0][ni], a[0], bf);
        mma_s8(acc[1][ni], a[1], bf);
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + half * 8;
        if (row >= T_out) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn + ni * 8 + tg * 2 + e;
          if (co >= Co) continue;
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + e]),
                              scale[static_cast<size_t>(b) * scale_bstride + co]);
          if (bias != nullptr) y = __fadd_rn(y, bias[co]);
          if (leaky) y = fmaxf(y, __fmul_rn(slope, y));
          out[(static_cast<size_t>(b) * T_out + row) * Co + co] = y;
        }
      }
}

}  // namespace

extern "C" int int8_conv_s8(const int8_t* xq, const int8_t* wt,
                            const float* scale, int scale_bstride,
                            const float* bias, float* out,
                            int B, int T, int Ci, int K, int Co, int T_out,
                            int pad_left, int dil, int leaky, float slope,
                            void* stream) {
  const size_t bytes =
      static_cast<size_t>(BM + (K - 1) * dil) * ROW_BYTES +
      static_cast<size_t>(K) * BN * ROW_BYTES;
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      int8_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_out + BM - 1) / BM, (Co + BN - 1) / BN, B);
  int8_conv_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      xq, wt, scale, scale_bstride, bias, out, T, Ci, K, Co, T_out, pad_left,
      dil, leaky, slope);
  return static_cast<int>(cudaGetLastError());
}
