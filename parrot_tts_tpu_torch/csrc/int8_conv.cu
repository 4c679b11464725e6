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
// float32 y is rounded to bf16 (__floats2bfloat162_rn) and, when leaky is
// set, the leaky ReLU is then taken on the bf16 pair:
//     y16 = bf16(y);  y16 = max(y16, bf16(s16 * y16)),  s16 = bf16(slope)
// on packed pairs (__hmul2, __hmax2): s16 * y16 is exact in float32, so the
// one rounding of __hmul2 gives the bits of the float32 product rounded to
// bf16. That is what the JAX package's bf16 serving path computes: its int8
// conv's output cast to bf16 (ops/quant.py::int8_conv_nwc, out_dtype
// x.dtype), then jax.nn.leaky_relu in bf16, so its value is rounded twice
// where leaky is fused. The Pallas kernel itself (pallas_qconv.py:64-68)
// applies the leaky ReLU in float32 and rounds once at its store; the port
// follows the serving path, whose numbers the fidelity budgets were
// measured on. The plain version rounds at the same two points and is
// bit-equal. Two bytes per output halve the output's bytes.
//
// Bound on this card: 2*B*T_out*K*Ci*Co int8 operations against the bytes of
// xq, the weights, scale, bias and the output. At the vocoder's narrow
// stages (Ci = Co = 16-64, up to 327,680 rows a batch row) the bytes bound
// it, four bytes of float32 output for every input byte; at the wide ones
// (Ci, Co 256-1280, K 7-11) the operations, which only wgmma runs at the
// full rate. Most launches of a serve are small (a few us of bound), so a
// launch's fixed cost and its first tile's latency count as much as its
// rate.
//
// What the design does about it: an implicit GEMM, M = output time rows of
// one batch row, N = Co, the reduction taps x Ci, on s8 wgmma.
//   - blocks: a block of three warpgroups per SM. Warpgroup 0 is the
//     producer (two threads issue TMA); warpgroups 1 and 2 are consumers
//     that take the block's tiles in turn (ping-pong): a tile is (batch
//     row, 64*MB output rows, BN channels) and belongs to one consumer
//     from its products to its store, so one consumer's epilogue runs
//     under the other's products and the producer's loads. The walk is
//     channels fastest, then time tiles, then batch rows, block i taking
//     tiles i, i + grid, ...; the grid is a multiple of the channel tiles,
//     so every tile of a block has the same channels
//     (ops/qconv.py::conv_tile is the same walk in Python).
//   - weights (wt as (K, Co, Ci): K-major per tap, as s8 wgmma needs): the
//     block's channel tile of every tap stays resident, loaded once by TMA
//     in chunks of CK bytes of Ci (32, 64 or 128) as boxes {CK, BN, K} in
//     the CK-byte swizzle, each chunk completing on its own mbarrier, so
//     the first products wait only for chunk 0. The descriptor advances
//     along K by 32 bytes inside the swizzle atom. Where even 16 channels
//     of every tap do not fit, the chunk's weights ride the ring instead
//     (the same box).
//   - activations: one slab per tile and chunk: 64*MB + (K-1)*dil rows from
//     t0 - pad_left, rows of CK bytes loaded by TMA as boxes {CK, rows} in
//     the CK-byte swizzle (the rows before 0 and past T and channels past
//     Ci zero-filled by TMA, so the pads cost no code); the A operand of
//     tap `tap` is the same slab read from row tap*dil on, the
//     descriptor's start moved by whole rows: the swizzle's XOR is taken
//     on the address bits, so a start at any row reads the rows TMA wrote
//     (a descriptor base offset broke it; tests/test_torch_kernels.py
//     holds every row shift to the plain version). Every input row is read
//     from L2 once per tile and chunk, not once per tap, and no tap costs
//     a copy. At Ci = 16 the slab's rows are the input's own 16-byte rows:
//     inside the batch row it is one 1-d bulk copy (boxes {16, rows} at
//     the edges) into an unswizzled plane beside a plane of zeros that
//     pads the 32-byte k-step (16-byte boxes cost a TMA request per row).
//   - ring: stages / 2 slots for each consumer, fed by its own producer
//     thread (lane 0 of producer warp 0 or 1) in the order the consumer
//     takes them (full / empty mbarriers, one arrival each), so that no
//     wait on a slot runs ahead of the slot's previous use, which a
//     phase parity cannot tell apart; per chunk a consumer issues K *
//     CK/32 * MB wgmma m64nBNk32 and frees the slot when they are done;
//     the other consumer's products fill the tensor cores meanwhile.
//     Ci = 16 is zero-padded to the 32-byte k-step; those stages are
//     bytes-bound, so the extra products cost nothing.
//   - epilogue: a tile's scale and bias are loaded into registers before
//     its products; after them the consumer writes its 64*MB x BN tile
//     once into its own buffer, in BN / EC boxes of EC columns in the
//     swizzle of the box's row (32, 64 or 128 bytes; 256 rows at most),
//     and one thread stores the boxes by TMA into a 3-d map (Co, T_out,
//     B), which clips rows past T_out and channels past Co. Two named
//     barriers per tile;
//     the buffer is rewritten only after its store has read it.
//   - shapes off the 16-byte rule of TMA (Ci or Co not a multiple of 16 / 4,
//     or an unaligned base): the wrapper (ops/qconv.py::conv_plan) copies the
//     operand into a zeroed workspace, or lets the kernel write a padded
//     output that it then slices; the same kernel runs either way.
//   - the launch plan (BN, MB, CK, stages, grid, resident weights) is
//     computed in Python (ops/qconv.py::conv_plan) from the shapes: of the
//     tiles that fit shared memory with four stages, the one a launch
//     model gives the least time (products at the measured wgmma rates,
//     bytes from memory and L2, TMA box rows, ring reloads, a cost per
//     tile), so small launches take short tiles that spread over the SMs.
//   - launch: thread 0 prefetches the three tensor maps before it sets up
//     the barriers. A launch costs ~2 us beyond the card's launch floor
//     (PERF.md section 6).
//
// Interface (plain C, loaded with ctypes):
//   int int8_conv_s8(xq, wt, scale, scale_bstride, bias or NULL, out, B, T,
//                    Ci, K, Co, ldo, T_out, pad_left, dil, leaky, slope,
//                    bn, mb, ck, stages, resident, grid, out_bf16, stream)
// xq: (B, T, Ci) int8, wt: (K, Co, Ci) int8, out: (B, T_out, ldo) float32
// or, with out_bf16, bfloat16 (channels [Co, ldo) not written), all
// contiguous with 16-byte aligned bases, Ci a multiple of 16 and ldo of 4
// (float32) or 8 (bfloat16);
// scale: (B, Co) float32, element [b, co] at b * scale_bstride + co (0
// broadcasts one (Co,) vector over the batch); bias: (Co,) float32 or NULL;
// bn, mb, ck, stages, resident, grid: the plan of ops/qconv.py::conv_plan
// (mb: m64 blocks of rows per tile; ck: bytes of Ci per chunk; stages:
// even and at least 4, half for each consumer). Returns the CUDA error
// code of the launch.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int THREADS = 384;
constexpr int REGS = 168;           // 65536 / 384, rounded down to 8
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;
// wgmma descriptor layouts (bits 62-63) of the 64- and 32-byte swizzles
constexpr uint64_t kSwizzle64 = 2, kSwizzle32 = 3;

__host__ __device__ constexpr int round1024(int x) { return (x + 1023) & ~1023; }

struct Plan {
  int B, K, BN, ROWS, OB, CK, slab, box_rows, n_rbox, n_chunks, stages;
  int resident, tiles_m, tiles_n;
  int planes;   // Ci = 16: the slab as two 16-byte planes, the second zero
  // shared memory: [two output tiles | resident weights | ring | barriers]
  __host__ __device__ int epi() const { return ROWS * BN * OB; }
  __host__ __device__ int wchunk() const { return K * BN * CK; }
  __host__ __device__ int a_bytes() const { return slab * CK; }
  __host__ __device__ int stage() const {
    return round1024(a_bytes() + (resident ? 0 : wchunk()));
  }
  __host__ __device__ int off_w() const { return 2 * epi(); }
  __host__ __device__ int off_ring() const {
    return off_w() + (resident ? round1024(n_chunks * wchunk()) : 0);
  }
  __host__ __device__ int off_bars() const { return off_ring() + stages * stage(); }
  __host__ __device__ int smem() const {
    return off_bars() + (2 * stages + n_chunks) * 8 + 1024;
  }
};

struct Epi {
  const float* scale;
  int sbstride;
  const float* bias;
  int leaky;
  float slope;
  int Co, T_out, pad_left, dil;
  const int8_t* xq;   // for the planes' 1-d copies
  int T;
};

// `bytes` contiguous bytes from global into shared memory by one bulk copy
// (both 16-byte aligned, a multiple of 16), completing on `bar`, whose
// expected bytes the caller has set
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a K-major operand of `ck`-byte rows in the ck-byte swizzle, as TMA wrote
// it (the XOR taken on address bits 7 and up, so a start at any row of a
// 1024-byte aligned buffer, and 32 bytes on along K, reads the same rows)
__device__ __forceinline__ uint64_t swz_desc(const void* p, int ck,
                                             uint64_t layout) {
  return sdesc(p, 16, 8 * ck, layout);
}

// BN channels and 64 x MB rows per tile; BF16: the output type
template <int BN, int MB, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap to, const Plan p,
            const Epi e) {
  constexpr int ROWS = 64 * MB;
  constexpr int OB = BF16 ? 2 : 4;              // bytes per output
  constexpr int EC = BN * OB < 128 ? BN : 128 / OB;   // columns per store box
  constexpr int PITCH = EC * OB;                // its row: 32 to 128 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  unsigned char* wres = sm + p.off_w();
  unsigned char* ring = sm + p.off_ring();
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.off_bars());
  uint64_t* empty = full + p.stages;
  uint64_t* wbar = empty + p.stages;            // one per chunk of weights
  const int stage = p.stage(), wchunk = p.wchunk();
  const int tiles = p.B * p.tiles_m * p.tiles_n;
  const int nt = blockIdx.x % p.tiles_n;        // the same for all its tiles
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    // the tensor maps' first use is the launch's critical path
    for (const CUtensorMap* m : {&tx, &tw, &to})
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(m)) : "memory");
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);   // the consumer that owns the chunk's tile
    }
    for (int c = 0; c < p.n_chunks; ++c) mbar_init(&wbar[c], 1);
    mbar_fence_init();
  }
  if (p.planes) {   // every slot's second plane: zeros, the k-step's pad
    for (int i = threadIdx.x; i < p.stages * p.slab; i += THREADS)
      *reinterpret_cast<uint4*>(ring + (i / p.slab) * stage +
                                (p.slab + i % p.slab) * 16) =
          make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();

  // the ring: stages / 2 slots for each consumer, each fed by its own
  // producer thread in the order that consumer takes them, so no wait on
  // a slot can run ahead of the slot's previous use (mbarrier parity)
  const int half = p.stages / 2;
  if (wg == 0) {   // producers: lane 0 of warp 0 feeds consumer 0, of warp 1
    reg_dealloc<40>();   // consumer 1
    const int pw = threadIdx.x >> 5;
    if (pw > 1 || (threadIdx.x & 31) != 0) return;
    if (pw == 0)
      for (int c = 0; c < p.n_chunks; ++c) {
        if (p.resident) {
          mbar_expect(&wbar[c], wchunk);
          tma_load_3d(wres + c * wchunk, &tw, &wbar[c], c * p.CK, nt * BN, 0);
        } else {
          mbar_arrive(&wbar[c]);   // streamed weights ride the ring
        }
      }
    const uint32_t bytes = (p.planes ? p.slab * 16 : p.a_bytes()) +
                           (p.resident ? 0 : wchunk);
    int it = 0, local = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
      if ((local & 1) != pw) continue;
      const int r = tile / p.tiles_n;
      const int mt = r % p.tiles_m, b = r / p.tiles_m;
      const int row0 = mt * ROWS - e.pad_left;
      for (int c = 0; c < p.n_chunks; ++c, ++it) {
        const int s = pw * half + it % half;
        mbar_wait(&empty[s], ((it / half) & 1) ^ 1);
        unsigned char* a = ring + s * stage;
        mbar_expect(&full[s], bytes);
        if (p.planes && row0 >= 0 && row0 + p.slab <= e.T)   // one copy
          bulk_copy(a, e.xq + (static_cast<size_t>(b) * e.T + row0) * 16,
                    p.slab * 16, &full[s]);
        else   // boxes {CK, rows} (planes: {16, rows}), zero past the edges
          for (int q = 0; q < p.n_rbox; ++q)
            tma_load_3d(a + q * p.box_rows * (p.planes ? 16 : p.CK), &tx,
                        &full[s], c * p.CK, row0 + q * p.box_rows, b);
        if (!p.resident)
          tma_load_3d(a + p.a_bytes(), &tw, &full[s], c * p.CK, nt * BN, 0);
      }
    }
    return;
  }

  // consumers: warpgroup 1 takes the block's tiles 0, 2, 4, ..., warpgroup 2
  // tiles 1, 3, 5, ...
  reg_alloc<232>();
  const int cw = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  unsigned char* ebuf = sm + cw * p.epi();
  const int n0 = nt * BN, ksteps = p.CK / 32;
  const uint64_t layout =
      p.CK == 128 ? kSwizzle128 : p.CK == 64 ? kSwizzle64 : kSwizzle32;
  const __nv_bfloat162 s2 =
      __bfloat162bfloat162(__float2bfloat16_rn(e.slope));
  int acc[MB][BN / 2];
  int local = 0;   // the block's tiles so far
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
    if ((local & 1) != cw) continue;
    const int r = tile / p.tiles_n;
    const int mt = r % p.tiles_m, b = r / p.tiles_m;
    // the tile's scale and bias, loaded before its products
    float sc[BN / 8][2], bi[BN / 8][2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int co = n0 + j * 8 + 2 * t + q;
        const bool in = co < e.Co;
        sc[j][q] =
            in ? __ldg(e.scale + static_cast<size_t>(b) * e.sbstride + co) : 0.f;
        bi[j][q] = in && e.bias != nullptr ? __ldg(e.bias + co) : 0.f;
      }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0;
    int it = (local >> 1) * p.n_chunks;   // this consumer's chunks so far
    for (int c = 0; c < p.n_chunks; ++c, ++it) {
      const int s = cw * half + it % half;
      mbar_wait(&wbar[c], 0);
      mbar_wait(&full[s], (it / half) & 1);
      const unsigned char* a = ring + s * stage;
      const unsigned char* w =
          p.resident ? wres + c * wchunk : a + p.a_bytes();
      wg_fence();
      for (int tap = 0; tap < p.K; ++tap) {
        const unsigned char* at = a + tap * e.dil * p.CK;
        const unsigned char* wt = w + tap * BN * p.CK;
        for (int ks = 0; ks < ksteps; ++ks) {
          const uint64_t db = swz_desc(wt + ks * 32, p.CK, layout);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            wgmma_s8<BN>(acc[mb],
                         p.planes ? sdesc(a + (tap * e.dil + mb * 64) * 16,
                                          p.slab * 16, 128, kNoSwizzle)
                                  : swz_desc(at + mb * 64 * p.CK + ks * 32,
                                             p.CK, layout),
                         db);
        }
      }
      wg_commit();
      wg_wait<0>();   // the chunk's products are done: its slot is free
      mbar_arrive_if(&empty[s], tid == 0);
    }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) reg_fence(acc[mb]);

    // epilogue: the whole tile into this consumer's buffer, then its stores
    if (tid == 0) bulk_wait_read<0>();   // the last store has read the buffer
    named_bar(1 + cw, 128);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float y[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float v = __fmul_rn(__int2float_rn(acc[mb][4 * j + 2 * h + q]),
                                sc[j][q]);
            if (e.bias != nullptr) v = __fadd_rn(v, bi[j][q]);
            if (!BF16 && e.leaky) v = fmaxf(v, __fmul_rn(e.slope, v));
            y[q] = v;
          }
          const int row = mb * 64 + warp * 16 + g + 8 * h;
          const int col = j * 8 + 2 * t;
          unsigned char* box = ebuf + (col / EC) * ROWS * PITCH;
          const uint32_t off = swizzled(row * PITCH + (col % EC) * OB, PITCH);
          if constexpr (BF16) {
            __nv_bfloat162 v = __floats2bfloat162_rn(y[0], y[1]);
            if (e.leaky) v = __hmax2(v, __hmul2(s2, v));
            *reinterpret_cast<__nv_bfloat162*>(box + off) = v;
          } else {
            *reinterpret_cast<float2*>(box + off) = make_float2(y[0], y[1]);
          }
        }
    fence_proxy_async();
    named_bar(1 + cw, 128);
    if (tid == 0) {
      constexpr int BOX_ROWS = ROWS < 256 ? ROWS : 256;   // TMA's limit
#pragma unroll
      for (int bx = 0; bx < BN / EC; ++bx)
#pragma unroll
        for (int br = 0; br < ROWS / BOX_ROWS; ++br)
          if (n0 + bx * EC < e.Co && mt * ROWS + br * BOX_ROWS < e.T_out)
            tma_store_3d(&to, ebuf + (bx * ROWS + br * BOX_ROWS) * PITCH,
                         n0 + bx * EC, mt * ROWS + br * BOX_ROWS, b);
      bulk_commit();
    }
  }
  // shared memory outlives its stores' reads (the writes complete with
  // the grid)
  if (tid == 0) bulk_wait_read<0>();
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

CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
}

}  // namespace

extern "C" int int8_conv_s8(const int8_t* xq, const int8_t* wt,
                            const float* scale, int scale_bstride,
                            const float* bias, void* out,
                            int B, int T, int Ci, int K, int Co, int ldo,
                            int T_out,
                            int pad_left, int dil, int leaky, float slope,
                            int bn, int mb, int ck, int stages, int resident,
                            int grid, int out_bf16, void* stream) {
  const int ob = out_bf16 ? 2 : 4;   // bytes per output
  Plan p;
  p.B = B;
  p.K = K;
  p.BN = bn;
  p.ROWS = 64 * mb;
  p.OB = ob;
  p.CK = ck;
  const int need = p.ROWS + (K - 1) * dil;
  p.n_rbox = (need + 255) / 256;
  p.box_rows = ((need + p.n_rbox - 1) / p.n_rbox + 7) & ~7;
  p.slab = p.n_rbox * p.box_rows;
  p.n_chunks = (Ci + ck - 1) / ck;
  p.stages = stages;
  p.resident = resident;
  p.tiles_m = (T_out + p.ROWS - 1) / p.ROWS;
  p.tiles_n = (Co + bn - 1) / bn;
  if (Ci % 16 != 0 || (ldo * ob) % 16 != 0 || ldo < Co || stages < 4 ||
      stages > MAX_STAGES || stages % 2 != 0 ||
      (ck != 32 && ck != 64 && ck != 128) ||
      grid < 1 || grid % p.tiles_n != 0 || p.smem() > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  p.planes = Ci == 16 && ck == 32;
  Epi e{scale, scale_bstride, bias, leaky, slope, Co, T_out, pad_left, dil,
        xq, T};

  CUtensorMap tx, tw, to;
  const cuuint64_t x_dims[3] = {static_cast<cuuint64_t>(Ci),
                                static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[2] = {static_cast<cuuint64_t>(Ci),
                                   static_cast<cuuint64_t>(T) * Ci};
  const cuuint32_t x_box[3] = {static_cast<cuuint32_t>(p.planes ? 16 : ck),
                               static_cast<cuuint32_t>(p.box_rows), 1};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(Ci),
                                static_cast<cuuint64_t>(Co),
                                static_cast<cuuint64_t>(K)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(Ci),
                                   static_cast<cuuint64_t>(Co) * Ci};
  const cuuint32_t w_box[3] = {static_cast<cuuint32_t>(ck),
                               static_cast<cuuint32_t>(bn),
                               static_cast<cuuint32_t>(K)};
  const int ec = bn * ob < 128 ? bn : 128 / ob;
  const cuuint64_t o_dims[3] = {static_cast<cuuint64_t>(Co),
                                static_cast<cuuint64_t>(T_out),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t o_strides[2] = {static_cast<cuuint64_t>(ldo) * ob,
                                   static_cast<cuuint64_t>(T_out) * ldo * ob};
  const cuuint32_t o_box[3] = {static_cast<cuuint32_t>(ec),
                               static_cast<cuuint32_t>(p.ROWS < 256 ? p.ROWS
                                                                   : 256),
                               1};
  if (!encode_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, xq, x_dims, x_strides,
                  x_box,
                  p.planes ? CU_TENSOR_MAP_SWIZZLE_NONE : swizzle_of(ck)) ||
      !encode_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wt, w_dims, w_strides,
                  w_box, swizzle_of(ck)) ||
      !encode_map(&to,
                  out_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  3, out, o_dims, o_strides, o_box, swizzle_of(ec * ob)))
    return static_cast<int>(cudaErrorInvalidValue);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn * 16 + mb) {
    case 16 * 16 + 8: return launch<16, 8>(tx, tw, to, p, e, grid, out_bf16, s);
    case 16 * 16 + 4: return launch<16, 4>(tx, tw, to, p, e, grid, out_bf16, s);
    case 16 * 16 + 2: return launch<16, 2>(tx, tw, to, p, e, grid, out_bf16, s);
    case 16 * 16 + 1: return launch<16, 1>(tx, tw, to, p, e, grid, out_bf16, s);
    case 32 * 16 + 4: return launch<32, 4>(tx, tw, to, p, e, grid, out_bf16, s);
    case 32 * 16 + 2: return launch<32, 2>(tx, tw, to, p, e, grid, out_bf16, s);
    case 32 * 16 + 1: return launch<32, 1>(tx, tw, to, p, e, grid, out_bf16, s);
    case 64 * 16 + 2: return launch<64, 2>(tx, tw, to, p, e, grid, out_bf16, s);
    case 64 * 16 + 1: return launch<64, 1>(tx, tw, to, p, e, grid, out_bf16, s);
    case 128 * 16 + 1: return launch<128, 1>(tx, tw, to, p, e, grid, out_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
