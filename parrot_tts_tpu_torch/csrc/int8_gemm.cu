// Dense GEMM for Hopper (sm_90a): C (M, N) = A (M, K) @ B (K, N), all row-major.
// int8 operands give int32 sums on the int8 tensor cores (mma.sync m16n8k32),
// bf16 operands float32 sums on the bf16 tensor cores (m16n8k16), float32
// operands IEEE float32 FMAs on the CUDA cores (no TF32).
//
// Replaces: parrot_tts_tpu/ops/pallas_qconv.py::matmul_pallas -> _mm_kernel
// (pallas_qconv.py:162-195), the rate microkernel of the JAX package's int8
// experiment. It computes what _mm_kernel computes, not its TPU block loop:
// the Pallas kernel carries each output block in VMEM across a sequential k
// grid axis; blocks here run in no order on 132 SMs, so each block owns its
// output tile and runs the whole k loop itself. Any M, N, K >= 1: ragged
// edges are masked, A rows that are not 16-byte aligned are read bytewise.
//
// Bound on this card: 2*M*N*K operations against the bytes of A, B and C. At
// the experiment's (8192, 4096, 4096) that is 2.75e11 operations, 0.139 ms
// at 1,979 int8 TOP/s or 0.278 ms at 989 bf16 TFLOP/s, against 0.055 /
// 0.070 ms of bytes: operation-bound.
//
// What the design does about it, as a first, simple kernel: both tensor-core
// products read their operands K-major (mma.sync for s8 takes only .row.col,
// and an N-major int8 B cannot be transposed by ldmatrix), so a first pass
// writes B^T (N, ldb) into a workspace the wrapper allocates (2*K*N bytes of
// traffic, about 10 us at the rate shape), its rows zero-padded to a multiple
// of 16 bytes. The GEMM then stages 128 x 128 output tiles: 8 warps, each a
// 64 x 32 sub-tile, 64 bytes of K per stage (two mma k-steps), shared-memory
// rows of 80 bytes so every fragment read is free of bank conflicts, and the
// next stage's global loads issued into registers before the current stage's
// products. cp.async or TMA pipelining and wgmma are work for a later kernel.
//
// Interface (plain C, loaded with ctypes):
//   int int8_gemm(dtype, a, b, bt, ldb, c, M, N, K, vec_a, stream)
// dtype 0 int8 (c int32), 1 bf16 (c float32), 2 float32 (c float32; bt and
// ldb unused); a: contiguous (M, K); b: contiguous (K, N); bt: workspace of N
// rows of ldb elements (ldb >= K, ldb * element size a multiple of 16); c:
// contiguous (M, N); vec_a: a's rows are 16-byte aligned (K * element size a
// multiple of 16 and a 16-byte aligned base). Returns the CUDA error code of
// the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;         // output rows per block
constexpr int BN = 128;         // output columns per block
constexpr int BKB = 64;         // bytes of K per stage: two mma k-steps of 32 bytes
constexpr int ROW = BKB + 16;   // shared row stride, 80 bytes = 20 words
constexpr int THREADS = 256;    // 8 warps, 2 (M) x 4 (N), 64 x 32 each

__device__ __forceinline__ void mma(int c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B (K, N) -> B^T (N, ldb), zero in columns [K, ldb); E is the element's
// storage type (uint8_t for int8, uint16_t for bf16)
template <typename E>
__global__ void transpose_kernel(const E* __restrict__ b, E* __restrict__ bt,
                                 int K, int N, int ldb) {
  __shared__ E tile[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    tile[i][threadIdx.x] = (k < K && n < N) ? b[static_cast<size_t>(k) * N + n] : E(0);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (n < N && k < ldb) bt[static_cast<size_t>(n) * ldb + k] = tile[threadIdx.x][i];
  }
}

// bytes kb..kb+15 of a row of `bytes` bytes, zero past its end
__device__ __forceinline__ uint4 load16(const unsigned char* row, int kb,
                                        int bytes, bool vec) {
  if (vec) {
    if (kb < bytes) return *reinterpret_cast<const uint4*>(row + kb);
    return make_uint4(0, 0, 0, 0);
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (kb + i < bytes) w[i >> 2] |= static_cast<uint32_t>(row[kb + i]) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Acc int (int8 operands) or float (bf16 operands); a (M, kbytes) and bt
// (N, ldb_bytes) K-major byte rows
template <typename Acc>
__global__ void __launch_bounds__(THREADS)
gemm_tn_kernel(const unsigned char* __restrict__ a, int vec_a,
               const unsigned char* __restrict__ bt, int ldb_bytes,
               Acc* __restrict__ c, int M, int N, int kbytes) {
  __shared__ __align__(16) unsigned char as[BM * ROW];
  __shared__ __align__(16) unsigned char bs[BN * ROW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  Acc acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);

  // each thread stages two 16-byte chunks of A and two of B^T per stage:
  // chunk q = tid + 256*i is row q / 4, bytes 16 * (q % 4) of the stage
  uint4 ra[2], rb[2];
  auto fetch = [&](int kb) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * THREADS, r = q >> 2, col = kb + (q & 3) * 16;
      ra[i] = m0 + r < M
          ? load16(a + static_cast<size_t>(m0 + r) * kbytes, col, kbytes, vec_a)
          : make_uint4(0, 0, 0, 0);
      rb[i] = n0 + r < N
          ? load16(bt + static_cast<size_t>(n0 + r) * ldb_bytes, col, ldb_bytes, true)
          : make_uint4(0, 0, 0, 0);
    }
  };

  fetch(0);
  for (int kb = 0; kb < kbytes; kb += BKB) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * THREADS, off = (q >> 2) * ROW + (q & 3) * 16;
      *reinterpret_cast<uint4*>(as + off) = ra[i];
      *reinterpret_cast<uint4*>(bs + off) = rb[i];
    }
    __syncthreads();
    if (kb + BKB < kbytes) fetch(kb + BKB);   // in flight during the products

#pragma unroll
    for (int ks = 0; ks < BKB; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const unsigned char* p = as + (wm + mi * 16 + g) * ROW + ks + tg * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const unsigned char* p = bs + (wn + ni * 8 + g) * ROW + ks + tg * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();   // the products are done with this stage's tiles
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + half * 8;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + ni * 8 + tg * 2 + e;
          if (col < N) c[static_cast<size_t>(row) * N + col] = acc[mi][ni][half * 2 + e];
        }
      }
}

// float32: 128 x 128 tiles, 16 of K per stage, each thread an 8 x 8 grid of
// outputs strided by 16 so the shared reads broadcast
constexpr int FBK = 16;

__global__ void __launch_bounds__(THREADS)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c, int M, int N, int K) {
  __shared__ float as[FBK][BM + 4];   // as[k][m]
  __shared__ float bs[FBK][BN + 4];   // bs[k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + i * THREADS;
      const int m = e >> 4, ka = e & 15;          // A: 16 floats of a row
      as[ka][m] = (m0 + m < M && k0 + ka < K)
          ? a[static_cast<size_t>(m0 + m) * K + k0 + ka] : 0.f;
      const int kb = e >> 7, n = e & 127;          // B: 128 floats of a row
      bs[kb][n] = (k0 + kb < K && n0 + n < N)
          ? b[static_cast<size_t>(k0 + kb) * N + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float ar[8], br[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ar[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) br[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) c[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int int8_gemm(int dtype, const void* a, const void* b, void* bt,
                         int ldb, void* c, int M, int N, int K, int vec_a,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (dtype == 2) {
    sgemm_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(a),
                                          static_cast<const float*>(b),
                                          static_cast<float*>(c), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  const int esize = dtype == 0 ? 1 : 2;
  const dim3 tgrid((N + 31) / 32, (ldb + 31) / 32), tblock(32, 8);
  if (dtype == 0)
    transpose_kernel<uint8_t><<<tgrid, tblock, 0, s>>>(
        static_cast<const uint8_t*>(b), static_cast<uint8_t*>(bt), K, N, ldb);
  else
    transpose_kernel<uint16_t><<<tgrid, tblock, 0, s>>>(
        static_cast<const uint16_t*>(b), static_cast<uint16_t*>(bt), K, N, ldb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned char* a8 = static_cast<const unsigned char*>(a);
  const unsigned char* bt8 = static_cast<const unsigned char*>(bt);
  if (dtype == 0)
    gemm_tn_kernel<int><<<grid, THREADS, 0, s>>>(
        a8, vec_a, bt8, ldb * esize, static_cast<int*>(c), M, N, K * esize);
  else
    gemm_tn_kernel<float><<<grid, THREADS, 0, s>>>(
        a8, vec_a, bt8, ldb * esize, static_cast<float*>(c), M, N, K * esize);
  return static_cast<int>(cudaGetLastError());
}
