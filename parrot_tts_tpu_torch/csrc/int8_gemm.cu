// Dense GEMM for Hopper (sm_90a): C (M, N) = A (M, K) @ B (K, N), all row-major.
// int8 operands give int32 sums and bf16 operands float32 sums on the tensor
// cores (wgmma); float32 operands IEEE float32 FMAs on the CUDA cores (no
// TF32).
//
// Replaces: parrot_tts_tpu/ops/pallas_qconv.py::matmul_pallas -> _mm_kernel
// (pallas_qconv.py:162-195), the rate microkernel of the JAX package's int8
// experiment. It computes what _mm_kernel computes, not its TPU block loop:
// the Pallas kernel carries each output block in VMEM across a sequential k
// grid axis; here each output tile is owned by one block, which runs the
// whole k loop itself.
//
// Bound on this card: 2*M*N*K operations against the bytes of A, B and C. At
// the experiment's (8192, 4096, 4096) that is 2.75e11 operations, 0.139 ms
// at 1,979 int8 TOP/s or 0.278 ms at 989 bf16 TFLOP/s, against 0.055 /
// 0.070 ms of bytes: bound by the tensor cores, whose full rate only wgmma
// reaches; the 128 MB of int32 / float32 C is ~40 us of that on its own.
//
// What the design does about it (int8 and bf16; the float32 mode keeps the
// simple CUDA-core kernel at the end of this file):
//   - one persistent block of three warpgroups per SM walks 128 x 256 output
//     tiles in a grouped order (`group` tile rows at a time, so the blocks
//     in flight share rows of A and columns of B in L2; ops/qconv.py::
//     gemm_tile is the same order in Python).
//   - warpgroup 0 is the producer: one thread issues TMA loads of 128 bytes
//     of K at a time (A: a 128 x 128-byte box; B: 256 x 128 bytes) into a
//     ring of four 48 KB stages in the 128-byte swizzle, completing on one
//     `full` mbarrier per stage, and waits on the stage's `empty` mbarrier
//     before reusing it. setmaxnreg gives its registers to the consumers.
//   - warpgroups 1 and 2 are the consumers, 64 rows each: per stage four
//     wgmma.mma_async m64n256 k-steps (s8: k32, .s32.s8.s8; bf16: k16,
//     .f32.bf16.bf16) with both operands read from shared memory by
//     descriptor, one group in flight while the next stage is waited for;
//     a stage is released as soon as the group that read it completes.
//   - operand layouts: wgmma takes 8-bit operands K-major only, so int8
//     keeps a pass that writes B^T (N, ldb) into a workspace (2*K*N bytes,
//     `int8_gemm_transpose`, its rows zero-padded to 16 bytes). bf16 reads
//     row-major B as it is: its tile is four 64 x 64 swizzle blocks read
//     MN-major through the descriptor's transpose bit.
//   - epilogue: each consumer writes its 64 x 256 tile in eight 64 x 32
//     chunks into two 8 KB buffers in the 128-byte swizzle (conflict-free)
//     and one thread stores each chunk by TMA; the stores run while the
//     next tile's products do, and a buffer is rewritten only after the
//     store that read it (bulk wait_group.read).
//   - ragged shapes: TMA wants 16-byte row strides and bases. The wrapper
//     (ops/qconv.py::gemm_plan) copies an operand that breaks that rule into
//     a zero-padded workspace and the same kernel runs on it; K past the end
//     reads as zero (TMA's out-of-bounds fill), and the M and N edges of C
//     are clipped by the TMA store.
//
// Interface (plain C, loaded with ctypes):
//   int int8_gemm_transpose(b, bt, K, N, ldb, stream)
//       int8 b (K, N) contiguous -> bt (N, ldb), zero in columns [K, ldb).
//   int int8_gemm(dtype, a, lda, b, ldb, c, ldc, M, N, K, group, grid, stream)
// dtype 0 int8 (c int32; b is B^T (N, ldb) from the pass above), 1 bf16 (c
// float32; b is B (K, ldb)), 2 float32 (c float32; a (M, K), b (K, N) and c
// contiguous; lda, ldb, ldc, group and grid unused). lda, ldb, ldc: row
// strides in elements; for dtypes 0 and 1 each a multiple of 16 bytes with
// 16-byte aligned bases. grid: persistent blocks (at most the number of
// SMs). Returns the CUDA error code of the launch.

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;            // output rows per tile: 2 consumers x 64
constexpr int BN = 256;            // output columns per tile
constexpr int KB = 128;            // bytes of K per stage
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * KB;   // 16 KB
constexpr int B_BYTES = BN * KB;   // 32 KB
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int EPI_COLS = 32;       // 4-byte columns per store box: 128 bytes
constexpr int EPI = 64 * EPI_COLS * 4;   // one 64 x 32 store buffer
constexpr int THREADS = 384;
constexpr int REGS = 168;          // 65536 / 384, rounded down to 8
constexpr int OFF_EPI = STAGES * STAGE;
constexpr int OFF_BARS = OFF_EPI + 4 * EPI;
constexpr size_t SMEM = OFF_BARS + 2 * STAGES * sizeof(uint64_t) + 1024;

// tile `tile` of a tiles_m x tiles_n grid in grouped order: `group` tile
// rows at a time, down each column of the group before the next column
__device__ __forceinline__ void tile_mn(int tile, int tiles_m, int tiles_n,
                                        int group, int& mt, int& nt) {
  const int per_group = group * tiles_n;
  const int first = (tile / per_group) * group;
  const int rows = min(group, tiles_m - first);
  const int r = tile % per_group;
  mt = first + r % rows;
  nt = r / rows;
}

template <bool Int8>
struct Ops {
  using Acc = typename std::conditional<Int8, int, float>::type;
  // one 128-byte k block: four k-steps of 32 bytes (s8 k32 / bf16 k16)
  static __device__ __forceinline__ void mma(Acc (&d)[128],
                                             const unsigned char* a,
                                             const unsigned char* b) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sdesc(a + kk * 32, 16, 1024, kSwizzle128);
      if constexpr (Int8) {
        wgmma_s8_n256(d, da, sdesc(b + kk * 32, 16, 1024, kSwizzle128));
      } else {
        // B MN-major: k-step kk starts 16 rows of K down; the next 64
        // columns of N are the next 8 KB swizzle block
        wgmma_bf16_n256(d, da, sdesc(b + kk * 2048, 8192, 1024, kSwizzle128));
      }
    }
  }
};

template <bool Int8>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tc, int M, int N, int K,
            int group) {
  using Acc = typename Ops<Int8>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + OFF_BARS);
  uint64_t* empty = full + STAGES;

  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int esize = Int8 ? 1 : 2;
  const int kblocks = (K * esize + KB - 1) / KB;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer
    reg_dealloc<40>();
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int mt, nt;
      tile_mn(tile, tiles_m, tiles_n, group, mt, nt);
      for (int kb = 0; kb < kblocks; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* a = sm + s * STAGE;
        unsigned char* b = a + A_BYTES;
        mbar_expect(&full[s], STAGE);
        tma_load_2d(a, &ta, &full[s], kb * KB / esize, mt * BM);
        if constexpr (Int8) {
          tma_load_2d(b, &tb, &full[s], kb * KB, nt * BN);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            tma_load_2d(b + q * 8192, &tb, &full[s], nt * BN + 64 * q,
                        kb * 64);
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 rows 0-63 of the tile, warpgroup 2 rows 64-127
  reg_alloc<232>();
  const int cw = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  unsigned char* epi = sm + OFF_EPI + cw * 2 * EPI;
  Acc acc[128];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int mt, nt;
    tile_mn(tile, tiles_m, tiles_n, group, mt, nt);
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = Acc(0);
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* a = sm + s * STAGE;
      wg_fence();
      Ops<Int8>::mma(acc, a + cw * 64 * KB, a + A_BYTES);
      wg_commit();
      wg_wait<1>();   // the previous stage's products are done
      if (kb > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wg_wait<0>();
    reg_fence(acc);
    if (tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

    // epilogue: eight 64 x 32 chunks through two swizzled buffers
#pragma unroll
    for (int c = 0; c < BN / EPI_COLS; ++c) {
      unsigned char* buf = epi + (c & 1) * EPI;
      if (tid == 0) bulk_wait_read<1>();   // the store that read buf is done
      named_bar(1 + cw, 128);
#pragma unroll
      for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
        const int j = c * (EPI_COLS / 8) + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = warp * 16 + g + 8 * h;
          const uint32_t off = swizzled(row * 128 + (jj * 8 + 2 * t) * 4, 128);
          Acc* p = reinterpret_cast<Acc*>(buf + off);
          p[0] = acc[4 * j + 2 * h];
          p[1] = acc[4 * j + 2 * h + 1];
        }
      }
      fence_proxy_async();
      named_bar(1 + cw, 128);
      if (tid == 0) {
        tma_store_2d(&tc, buf, nt * BN + c * EPI_COLS, mt * BM + cw * 64);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait_all();   // shared memory outlives its stores
}

// B (K, N) -> B^T (N, ldb), zero in columns [K, ldb): 64 x 64-byte tiles,
// 256 threads. Each thread reads 4 bytes of a row of B (a word when N is a
// multiple of 4, which keeps every row word-aligned, else 4 single bytes)
// and writes 4 bytes of a row of B^T as one word (ldb is a multiple of 16).
constexpr int TT = 64;

__global__ void __launch_bounds__(256)
transpose_kernel(const uint8_t* __restrict__ b, uint8_t* __restrict__ bt,
                 int K, int N, int ldb) {
  __shared__ uint8_t tile[TT][TT + 4];   // tile[k][n]
  const int n0 = blockIdx.x * TT, k0 = blockIdx.y * TT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;   // 16 x 16
  const bool words = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < TT / 16; ++i) {
    const int k = k0 + ty + 16 * i, n = n0 + 4 * tx;
    uint32_t v = 0;
    if (k < K) {
      const uint8_t* row = b + static_cast<size_t>(k) * N;
      if (words && n + 4 <= N) {
        v = *reinterpret_cast<const uint32_t*>(row + n);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) v |= static_cast<uint32_t>(row[n + j]) << (8 * j);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) tile[ty + 16 * i][4 * tx + j] = v >> (8 * j);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TT / 16; ++i) {
    const int n = n0 + ty + 16 * i, k = k0 + 4 * tx;
    if (n >= N || k >= ldb) continue;
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v |= static_cast<uint32_t>(tile[4 * tx + j][ty + 16 * i]) << (8 * j);
    *reinterpret_cast<uint32_t*>(bt + static_cast<size_t>(n) * ldb + k) = v;
  }
}

// float32: 128 x 128 tiles, 16 of K per stage, each thread an 8 x 8 grid of
// outputs strided by 16 so the shared reads broadcast
constexpr int FBM = 128, FBN = 128, FBK = 16, FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c, int M, int N, int K) {
  __shared__ float as[FBK][FBM + 4];   // as[k][m]
  __shared__ float bs[FBK][FBN + 4];   // bs[k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + i * FTHREADS;
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

template <bool Int8>
int launch_tc(const void* a, int lda, const void* b, int ldb, void* c,
              int ldc, int M, int N, int K, int group, int grid,
              cudaStream_t s) {
  const CUtensorMapDataType in_type =
      Int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t esize = Int8 ? 1 : 2;
  CUtensorMap ta, tb, tc;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t a_strides[1] = {lda * esize};
  const cuuint32_t a_box[2] = {static_cast<cuuint32_t>(KB / esize), BM};
  // int8: B^T (N rows of ldb); bf16: B (K rows of ldb), 64 x 64 boxes
  const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(Int8 ? K : N),
                                static_cast<cuuint64_t>(Int8 ? N : K)};
  const cuuint64_t b_strides[1] = {ldb * esize};
  const cuuint32_t b_box[2] = {Int8 ? static_cast<cuuint32_t>(KB) : 64u,
                               Int8 ? static_cast<cuuint32_t>(BN) : 64u};
  const cuuint64_t c_dims[2] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t c_strides[1] = {static_cast<cuuint64_t>(ldc) * 4};
  const cuuint32_t c_box[2] = {EPI_COLS, 64};
  if (!encode_map(&ta, in_type, 2, a, a_dims, a_strides, a_box,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&tb, in_type, 2, b, b_dims, b_strides, b_box,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&tc, Int8 ? CU_TENSOR_MAP_DATA_TYPE_INT32
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  2, c, c_dims, c_strides, c_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      prepare_once<gemm_kernel<Int8>>(REGS, static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_kernel<Int8><<<grid, THREADS, SMEM, s>>>(ta, tb, tc, M, N, K, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int int8_gemm_transpose(const void* b, void* bt, int K, int N,
                                   int ldb, void* stream) {
  const dim3 grid((N + TT - 1) / TT, (ldb + TT - 1) / TT);
  transpose_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(b), static_cast<uint8_t*>(bt), K, N, ldb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int int8_gemm(int dtype, const void* a, int lda, const void* b,
                         int ldb, void* c, int ldc, int M, int N, int K,
                         int group, int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2) {
    const dim3 fgrid((M + FBM - 1) / FBM, (N + FBN - 1) / FBN);
    sgemm_kernel<<<fgrid, FTHREADS, 0, s>>>(static_cast<const float*>(a),
                                            static_cast<const float*>(b),
                                            static_cast<float*>(c), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (grid < 1 || group < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_tc<true>(a, lda, b, ldb, c, ldc, M, N, K, group, grid, s);
  return launch_tc<false>(a, lda, b, ldb, c, ldc, M, N, K, group, grid, s);
}
