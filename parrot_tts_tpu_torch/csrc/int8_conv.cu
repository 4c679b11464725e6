// int8 stride-1 dilated NWC convolution for Hopper (sm_90a), int32 accumulation
// on the int8 tensor cores (wgmma), with a fused dequantize / bias / leaky
// epilogue.
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
// With a bfloat16 output (the bf16 vocoder's dynamic int8 sites) the same
// float32 y is rounded to bf16 (__float2bfloat16_rn) and, when leaky is
// set, the leaky ReLU is then taken on the bf16 value:
//     y16 = bf16(y);  y16 = max(y16, bf16(s16 * y16)),  s16 = bf16(slope)
// (s16 * y16 is exact in float32; one rounding). That is what the JAX
// package's bf16 serving path computes: its int8 conv's output cast to bf16
// (ops/quant.py::int8_conv_nwc, out_dtype x.dtype), then jax.nn.leaky_relu
// in bf16, so its value is rounded twice where leaky is fused. The Pallas
// kernel itself (pallas_qconv.py:64-68) applies the leaky ReLU in float32
// and rounds once at its store; the port follows the serving path, whose
// numbers the fidelity budgets were measured on. The plain version rounds
// at the same two points and is bit-equal. Two bytes per output halve the
// output's bytes.
//
// Bound on this card: 2*B*T_out*K*Ci*Co int8 operations against the bytes of
// xq, the weights, scale, bias and the float32 output. At the vocoder's
// narrow stages (Ci = Co = 16-64, up to 327,680 rows a batch row) the bytes
// bound it, four bytes of output for every input byte; at the wide ones
// (Ci, Co 128-1280) the operations, which only wgmma runs at the full rate.
//
// What the design does about it: an implicit GEMM, M = output time rows of
// one batch row, N = Co, the reduction taps x Ci, on s8 wgmma.
//   - blocks: one persistent block of three warpgroups per SM walks tiles
//     of (batch row, 128*MB output rows, BN channels), channels fastest
//     (ops/qconv.py::conv_tile is the same walk in Python). BN and MB are
//     chosen per launch (ops/qconv.py::conv_plan): BN the smallest of 16,
//     32, 64, 128, 256 that covers Co when the weights stay resident, else
//     64 (channels past Co read zero weights and are not stored); MB 4 m64
//     blocks per consumer at BN <= 32, 2 at 64, 1 above, so the narrow
//     stages take 512-row tiles and the per-tile costs are spread over
//     more output; a streamed launch with fewer tiles than SMs takes MB 1.
//   - activations: one slab per tile and 32-byte chunk of Ci. Its 128*MB +
//     (K-1)*dil rows start at t0 - pad_left; a producer thread loads it by
//     TMA from a 3-d map (Ci, T, B) as two 16-byte-wide boxes, the rows
//     before 0 and past T (and channels past Ci) zero-filled by TMA, so the
//     pads cost no code. The slab is stored without swizzle: 16-byte rows,
//     so every 8 rows are one 128-byte core matrix of the wgmma operand and
//     the A operand of tap `tap` is the same slab read from row tap*dil on
//     (the descriptor's start moves by 16 bytes a row). Every input row is
//     read from L2 once per tile and chunk, not once per tap, and no tap
//     costs a copy. (A box per (tap, chunk) at row t0 + tap*dil - pad_left
//     would re-read the rows K times through TMA; a swizzled slab cannot
//     be read from an arbitrary row.)
//   - weights (wt as (K, Co, Ci): K-major per tap, as s8 wgmma needs): where
//     the tile covers all of Co and the weights fit (<= 96 KB: every
//     16-, 32- and 64-channel stage, and 128 channels at K = 3), the block
//     loads them once by TMA and keeps them for all its tiles; otherwise the
//     chunk's taps ride the ring with the activations, 64 channels a tile
//     (wider streamed tiles measured slower on this card).
//   - ring: warpgroup 0's thread keeps 3 stages in flight with resident
//     weights, 4 with streamed ones (full / empty mbarriers; deeper rings
//     measured slower); warpgroups 1 and 2 each own 64*MB rows of the tile
//     and issue K*MB wgmma m64nBNk32 per chunk, one group in flight while
//     the next chunk is waited for. Ci = 16 is zero-padded to the 32-byte
//     k-step by TMA's fill; those stages are bytes-bound, so the extra
//     products cost nothing.
//   - epilogue: the same two roundings in the same order; each consumer
//     writes 64 x min(BN, 32) chunks into two buffers in the 128-byte (64-byte
//     at BN = 16) swizzle and one thread stores each by TMA into a 3-d map
//     (Co, T_out, B), which clips rows past T_out and channels past Co; the
//     stores overlap the next tile's products.
//   - shapes off the 16-byte rule of TMA (Ci or Co not a multiple of 16 / 4,
//     or an unaligned base): the wrapper (ops/qconv.py::conv_plan) copies the
//     operand into a zeroed workspace, or lets the kernel write a padded
//     output that it then slices; the same kernel runs either way.
//
// Interface (plain C, loaded with ctypes):
//   int int8_conv_s8(xq, wt, scale, scale_bstride, bias or NULL, out, B, T,
//                    Ci, K, Co, ldo, T_out, pad_left, dil, leaky, slope,
//                    bn, mb, stages, resident, grid, out_bf16, stream)
// xq: (B, T, Ci) int8, wt: (K, Co, Ci) int8, out: (B, T_out, ldo) float32
// or, with out_bf16, bfloat16 (channels [Co, ldo) not written), all
// contiguous with 16-byte aligned bases, Ci a multiple of 16 and ldo of 4
// (float32) or 8 (bfloat16);
// scale: (B, Co) float32, element [b, co] at b * scale_bstride + co (0
// broadcasts one (Co,) vector over the batch); bias: (Co,) float32 or NULL;
// bn, mb, stages, resident, grid: the plan of ops/qconv.py::conv_plan (mb:
// m64 blocks of rows per consumer warpgroup). Returns the
// CUDA error code of the launch.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int THREADS = 384;
constexpr int REGS = 168;           // 65536 / 384, rounded down to 8
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;

__host__ __device__ constexpr int round1024(int x) { return (x + 1023) & ~1023; }

struct Plan {
  int B, K, BN, slab, box_rows, n_rbox, n_chunks, stages, resident;
  int tiles_m, tiles_n;
  // shared memory: [epilogue buffers | resident weights | ring | barriers]
  __host__ __device__ int epi() const { return 64 * (BN < 32 ? BN : 32) * 4; }
  __host__ __device__ int wbox() const { return K * BN * 16; }
  __host__ __device__ int a_bytes() const { return 2 * slab * 16; }
  __host__ __device__ int stage() const {
    return round1024(a_bytes() + (resident ? 0 : 2 * wbox()));
  }
  __host__ __device__ int off_w() const { return 4 * epi(); }
  __host__ __device__ int off_ring() const {
    return off_w() + (resident ? round1024(n_chunks * 2 * wbox()) : 0);
  }
  __host__ __device__ int off_bars() const { return off_ring() + stages * stage(); }
  __host__ __device__ int smem() const {
    return off_bars() + (2 * stages + 1) * 8 + 1024;
  }
};

struct Epi {
  const float* scale;
  int sbstride;
  const float* bias;
  int leaky;
  float slope;
  int Co, T_out, pad_left, dil;
};

// y16 rounded to bf16 then max(y16, bf16(s16 * y16)): s16 * y16 is exact in
// float32, so one rounding, as the JAX package's bf16 leaky_relu
__device__ __forceinline__ __nv_bfloat16 leaky_bf16(__nv_bfloat16 y,
                                                    float s16) {
  const float v = __bfloat162float(y);
  const float p = __bfloat162float(__float2bfloat16_rn(__fmul_rn(s16, v)));
  return __float2bfloat16_rn(fmaxf(v, p));
}

// BN channels and 2 x MB m64 blocks of rows per tile; BF16: the output type
template <int BN, int MB, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap to, const Plan p,
            const Epi e) {
  constexpr int ROWS = 64 * MB;              // output rows per consumer
  constexpr int BM = 2 * ROWS;
  constexpr int EC = BN < 32 ? BN : 32;      // columns per store box
  constexpr int OB = BF16 ? 2 : 4;           // bytes per output
  constexpr int PITCH = EC * OB;             // its row: 32 to 128 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  unsigned char* wres = sm + p.off_w();
  unsigned char* ring = sm + p.off_ring();
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.off_bars());
  uint64_t* empty = full + p.stages;
  uint64_t* wbar = empty + p.stages;
  const int wbox = p.wbox(), stage = p.stage();
  const int tiles = p.B * p.tiles_m * p.tiles_n;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer
    reg_dealloc<40>();
    if (threadIdx.x != 0) return;
    if (p.resident) {
      mbar_expect(wbar, p.n_chunks * 2 * wbox);
      for (int j = 0; j < 2 * p.n_chunks; ++j)
        tma_load_3d(wres + j * wbox, &tw, wbar, 16 * j, 0, 0);
    }
    const uint32_t bytes = p.a_bytes() + (p.resident ? 0 : 2 * wbox);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int nt = tile % p.tiles_n, r = tile / p.tiles_n;
      const int mt = r % p.tiles_m, b = r / p.tiles_m;
      const int row0 = mt * BM - e.pad_left;
      for (int c = 0; c < p.n_chunks; ++c, ++it) {
        const int s = it % p.stages;
        mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
        unsigned char* a = ring + s * stage;
        mbar_expect(&full[s], bytes);
        for (int j = 0; j < 2; ++j)
          for (int q = 0; q < p.n_rbox; ++q)
            tma_load_3d(a + (j * p.slab + q * p.box_rows) * 16, &tx, &full[s],
                        16 * (2 * c + j), row0 + q * p.box_rows, b);
        if (!p.resident)
          for (int j = 0; j < 2; ++j)
            tma_load_3d(a + p.a_bytes() + j * wbox, &tw, &full[s],
                        16 * (2 * c + j), nt * BN, 0);
      }
    }
    return;
  }

  // consumers: warpgroup 1 rows 0 .. ROWS-1 of the tile, warpgroup 2 the rest
  reg_alloc<232>();
  const int cw = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  unsigned char* ebuf = sm + cw * 2 * p.epi();
  if (p.resident) mbar_wait(wbar, 0);
  int acc[MB][BN / 2];
  int it = 0, chunk = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int nt = tile % p.tiles_n, r = tile / p.tiles_n;
    const int mt = r % p.tiles_m, b = r / p.tiles_m;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0;
    for (int c = 0; c < p.n_chunks; ++c, ++it) {
      const int s = it % p.stages;
      mbar_wait(&full[s], (it / p.stages) & 1);
      const unsigned char* a = ring + s * stage + cw * ROWS * 16;
      const unsigned char* w =
          p.resident ? wres + c * 2 * wbox : ring + s * stage + p.a_bytes();
      wg_fence();
      for (int tap = 0; tap < p.K; ++tap) {
        const uint64_t db = sdesc(w + tap * BN * 16, wbox, 128, kNoSwizzle);
        const unsigned char* at = a + tap * e.dil * 16;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          wgmma_s8<BN>(acc[mb], sdesc(at + mb * 64 * 16, p.slab * 16, 128,
                                      kNoSwizzle), db);
      }
      wg_commit();
      wg_wait<1>();   // the previous chunk's products are done
      if (c > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % p.stages]);
    }
    wg_wait<0>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) reg_fence(acc[mb]);
    if (tid == 0) mbar_arrive(&empty[(it - 1) % p.stages]);

    // epilogue: 64 x EC chunks through two swizzled buffers
    const int n0 = nt * BN;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int r0 = mt * BM + cw * ROWS + mb * 64;
#pragma unroll
      for (int ch = 0; ch < BN / EC; ++ch, ++chunk) {
        unsigned char* buf = ebuf + (chunk & 1) * p.epi();
        if (tid == 0) bulk_wait_read<1>();   // the store that read buf is done
        named_bar(1 + cw, 128);
#pragma unroll
        for (int jj = 0; jj < EC / 8; ++jj) {
          const int j = ch * (EC / 8) + jj;
          float sc[2], bi[2];
          const float s16 =
              BF16 ? __bfloat162float(__float2bfloat16_rn(e.slope)) : 0.f;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int co = n0 + j * 8 + 2 * t + q;
            const bool in = co < e.Co;
            sc[q] = in ? __ldg(e.scale + static_cast<size_t>(b) * e.sbstride + co) : 0.f;
            bi[q] = in && e.bias != nullptr ? __ldg(e.bias + co) : 0.f;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float y[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              float v = __fmul_rn(__int2float_rn(acc[mb][4 * j + 2 * h + q]), sc[q]);
              if (e.bias != nullptr) v = __fadd_rn(v, bi[q]);
              if (!BF16 && e.leaky) v = fmaxf(v, __fmul_rn(e.slope, v));
              y[q] = v;
            }
            const int row = warp * 16 + g + 8 * h;
            const uint32_t off =
                swizzled(row * PITCH + (jj * 8 + 2 * t) * OB, PITCH);
            if constexpr (BF16) {
              __nv_bfloat16 y0 = __float2bfloat16_rn(y[0]);
              __nv_bfloat16 y1 = __float2bfloat16_rn(y[1]);
              if (e.leaky) {
                y0 = leaky_bf16(y0, s16);
                y1 = leaky_bf16(y1, s16);
              }
              *reinterpret_cast<__nv_bfloat162*>(buf + off) =
                  __halves2bfloat162(y0, y1);
            } else {
              *reinterpret_cast<float2*>(buf + off) = make_float2(y[0], y[1]);
            }
          }
        }
        fence_proxy_async();
        named_bar(1 + cw, 128);
        if (tid == 0) {
          if (n0 + ch * EC < e.Co && r0 < e.T_out)
            tma_store_3d(&to, buf, n0 + ch * EC, r0, b);
          bulk_commit();   // a group even when empty, so the waits above count
        }
      }
    }
  }
  if (tid == 0) bulk_wait_all();   // shared memory outlives its stores
}

template <int BN, int MB, bool BF16>
int launch_t(const CUtensorMap& tx, const CUtensorMap& tw,
             const CUtensorMap& to, const Plan& p, const Epi& e, int grid,
             cudaStream_t s) {
  const cudaError_t err =
      prepare_once<conv_kernel<BN, MB, BF16>>(REGS, SMEM_MAX);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_kernel<BN, MB, BF16><<<grid, THREADS, p.smem(), s>>>(tx, tw, to, p, e);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int MB>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& to,
           const Plan& p, const Epi& e, int grid, bool bf16, cudaStream_t s) {
  return bf16 ? launch_t<BN, MB, true>(tx, tw, to, p, e, grid, s)
              : launch_t<BN, MB, false>(tx, tw, to, p, e, grid, s);
}

}  // namespace

extern "C" int int8_conv_s8(const int8_t* xq, const int8_t* wt,
                            const float* scale, int scale_bstride,
                            const float* bias, void* out,
                            int B, int T, int Ci, int K, int Co, int ldo,
                            int T_out,
                            int pad_left, int dil, int leaky, float slope,
                            int bn, int mb, int stages, int resident,
                            int grid, int out_bf16, void* stream) {
  Plan p;
  p.B = B;
  p.K = K;
  p.BN = bn;
  const int bm = 128 * mb;
  const int need = bm + (K - 1) * dil;
  p.n_rbox = (need + 255) / 256;
  p.box_rows = ((need + p.n_rbox - 1) / p.n_rbox + 7) & ~7;
  p.slab = p.n_rbox * p.box_rows;
  p.n_chunks = (Ci + 31) / 32;
  p.stages = stages;
  p.resident = resident;
  p.tiles_m = (T_out + bm - 1) / bm;
  p.tiles_n = (Co + bn - 1) / bn;
  const int ob = out_bf16 ? 2 : 4;   // bytes per output
  if (Ci % 16 != 0 || (ldo * ob) % 16 != 0 || ldo < Co || stages < 2 ||
      stages > MAX_STAGES ||
      (resident && p.tiles_n != 1) || p.smem() > SMEM_MAX || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Epi e{scale, scale_bstride, bias, leaky, slope, Co, T_out, pad_left, dil};

  CUtensorMap tx, tw, to;
  const cuuint64_t x_dims[3] = {static_cast<cuuint64_t>(Ci),
                                static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[2] = {static_cast<cuuint64_t>(Ci),
                                   static_cast<cuuint64_t>(T) * Ci};
  const cuuint32_t x_box[3] = {16, static_cast<cuuint32_t>(p.box_rows), 1};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(Ci),
                                static_cast<cuuint64_t>(Co),
                                static_cast<cuuint64_t>(K)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(Ci),
                                   static_cast<cuuint64_t>(Co) * Ci};
  const cuuint32_t w_box[3] = {16, static_cast<cuuint32_t>(bn),
                               static_cast<cuuint32_t>(K)};
  const int ec = bn < 32 ? bn : 32;
  const cuuint64_t o_dims[3] = {static_cast<cuuint64_t>(Co),
                                static_cast<cuuint64_t>(T_out),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t o_strides[2] = {static_cast<cuuint64_t>(ldo) * ob,
                                   static_cast<cuuint64_t>(T_out) * ldo * ob};
  const cuuint32_t o_box[3] = {static_cast<cuuint32_t>(ec), 64, 1};
  // the store box's rows: ec * ob bytes, in the swizzle of that width
  const int pitch = ec * ob;
  const CUtensorMapSwizzle o_swizzle =
      pitch == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : pitch == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  if (!encode_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, xq, x_dims, x_strides,
                  x_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wt, w_dims, w_strides,
                  w_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_map(&to,
                  out_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  3, out, o_dims, o_strides, o_box, o_swizzle))
    return static_cast<int>(cudaErrorInvalidValue);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn * 8 + mb) {
    case 16 * 8 + 4: return launch<16, 4>(tx, tw, to, p, e, grid, out_bf16, s);
    case 16 * 8 + 2: return launch<16, 2>(tx, tw, to, p, e, grid, out_bf16, s);
    case 16 * 8 + 1: return launch<16, 1>(tx, tw, to, p, e, grid, out_bf16, s);
    case 32 * 8 + 4: return launch<32, 4>(tx, tw, to, p, e, grid, out_bf16, s);
    case 32 * 8 + 2: return launch<32, 2>(tx, tw, to, p, e, grid, out_bf16, s);
    case 32 * 8 + 1: return launch<32, 1>(tx, tw, to, p, e, grid, out_bf16, s);
    case 64 * 8 + 2: return launch<64, 2>(tx, tw, to, p, e, grid, out_bf16, s);
    case 64 * 8 + 1: return launch<64, 1>(tx, tw, to, p, e, grid, out_bf16, s);
    case 128 * 8 + 1: return launch<128, 1>(tx, tw, to, p, e, grid, out_bf16, s);
    case 256 * 8 + 1: return launch<256, 1>(tx, tw, to, p, e, grid, out_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
