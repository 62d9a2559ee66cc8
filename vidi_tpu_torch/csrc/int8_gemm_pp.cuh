// K5's int8 GEMM for Hopper (sm_90a): persistent, warp-specialised, with two
// consumer warpgroups that take whole output tiles in turn ("ping-pong").
//
// Replaces the products of vidi_tpu/ops/pallas/fused_tower_layer.py (`_qdot`
// in ln_qkv, o_residual and ln_ffn). Numerics are those of int8_gemm.cuh's
// `epilogue`, which this file calls and does not restate: exact int32 sums
// (in any order), x s_row x s_col, + fp32 bias, + the residual, each
// rounding where the JAX code has it.
//
// Why a second GEMM beside int8_gemm.cuh: the tower products are short. qkv,
// o and fc1 take 9-10 k-steps of 128, fc2 34-40, so a block that computes one
// tile and exits spends as long on its set-up, epilogue and store as on its
// products, and nothing else runs on its SM meanwhile. At SigLIP's 2,916 rows
// and Whisper's 1,500 the 128 x 256 tiles of int8_gemm.cuh also fit 132 SMs
// badly (Whisper's o and fc2: 60 blocks). Here:
//  - The grid is min(tiles, SMs) blocks, each walking the tiles b, b + G,
//    b + 2G, ... of one list that holds every product of the launch (q, k
//    and v are one list of 3 x tiles). Tiles are numbered rows first, then
//    columns, then product. `tower_plan` in ops/cuda/fused_tower_layer.py
//    mirrors this schedule for the tests.
//  - A tile is 128 rows x 128 columns and belongs to one consumer warpgroup:
//    the block's j-th tile goes to consumer j % 2. Each runs two wgmma
//    m64n128k32 s8 a depth step (128 int32 sums a thread). 128 columns divide
//    SigLIP's 1,152 and Whisper's 1,280 (9 and 10 column tiles, none ragged).
//  - One producer warpgroup (setmaxnreg 40 / 232; one thread issues TMA)
//    fills a ring of 32 KB stages (A 128 x 128, B 128 x 128, 128-byte
//    swizzle) in the order the tiles are consumed, across tile boundaries:
//    the next tile's first k-steps arrive while a consumer is still in its
//    epilogue. Each stage is read by one consumer, which hands it back (one
//    lane a warp) once its products are read out.
//  - The consumers take turns on the tensor cores: a consumer starts a
//    tile's products only after the other has issued every product of the
//    tile before (named barriers 1 and 2). So one consumer's epilogue
//    (rescale, bias, cast, residual, store) runs while the other's products
//    run. The turns also keep each stage's phase parity unambiguous: a
//    consumer never waits on a stage whose earlier fill is still owed to
//    the other consumer.
//  - The epilogue stages its tile in a shared buffer of its own (the ring is
//    busy with the next tiles), 64 columns at a time, each warp its own 32
//    rows, and stores 16-byte pieces of a row; a residual is read and added
//    the same way.
//  - Measured (H100 80GB HBM3, 700 W; scripts/k5_variants.py): a k-step
//    of 128 takes ~0.87 us a block whatever the ring's depth (4, 5 or 6
//    stages), and clusters of two sharing the weight tile by multicast (as
//    int8_gemm.cuh does) came out 4-16% slower, so neither the loads'
//    latency nor L2's rate bounds it; the tensor cores' own 0.29 us a
//    k-step is 3x away (PERF.md).
// LayerNorm, the row quantize and the FFN hidden's activation and requantize
// stay separate row passes (int8_gemm.cuh's quantize_rows): the activation's
// branchy tanhf / erff in four epilogue warps took ~3x fc1's products.
#pragma once

#include "int8_gemm.cuh"

namespace vidi_int8 {
namespace pp {

constexpr int BM = 128, BN = 128, BK = 128;  // a consumer's tile; k bytes a stage
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_STAGE = BM * BK, STAGE_BYTES = A_STAGE + BN * BK;
constexpr int HALF = 64;  // output columns staged at a time
constexpr int ORDER_BAR = 1;  // named barriers ORDER_BAR + consumer

// shared memory: the ring, each consumer's output staging, the barriers
template <typename T>
struct Layout {
  static constexpr int STAGES = sizeof(T) == 2 ? 5 : 4;
  static constexpr int ROW_BYTES = HALF * sizeof(T) + 16;  // + 16: rows 8 apart on other banks
  static constexpr int OUT_BYTES = 4 * 32 * ROW_BYTES;     // a consumer: 4 warps x 32 rows
  static constexpr int OUT_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = OUT_OFF + CONSUMERS * OUT_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFF + 16 * STAGES + 1024;  // + alignment slack
};
static_assert(Layout<__nv_bfloat16>::SMEM_BYTES <= 232448 && Layout<float>::SMEM_BYTES <= 232448,
              "a block has 227 KB of shared memory");

struct PpParams {
  CUtensorMap map_a;
  CUtensorMap map_b[3];
  GemmArgs g;  // m_fast unused
  int tiles_m, tiles_n, total;  // tiles of one product; of the launch
};

// tile t -> product z and its first row and column
__device__ __forceinline__ void tile_origin(const PpParams& P, int t, int& z, int& m0, int& n0) {
  const int per = P.tiles_m * P.tiles_n;
  z = t / per;
  const int r = t - z * per;
  n0 = (r / P.tiles_m) * BN;
  m0 = (r % P.tiles_m) * BM;
}

template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
int8_gemm_pp_sm90(const __grid_constant__ PpParams P) {
  using namespace vidi::sm90;
  static_assert(EPI == EPI_BIAS || EPI == EPI_BIAS_RES,
                "the tower products: bias, or bias + residual");
  using L = Layout<T>;
  constexpr int STAGES = L::STAGES, RB = L::ROW_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const GemmArgs& p = P.g;
  const int n_it = (p.K + BK - 1) / BK;
  const int G = gridDim.x, b = blockIdx.x;
  const int count = (P.total - b + G - 1) / G;  // this block's tiles: b + j G

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // a lane of each warp of the consumer that read it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == CONSUMERS) {
    // ---- producer: every stage of every tile of the block, in order ----
    setmaxnreg_dec<40>();
    if (tid == 128 * CONSUMERS) {
      int g = 0;
      for (int j = 0; j < count; ++j) {
        int z, m0, n0;
        tile_origin(P, b + j * G, z, m0, n0);
        for (int it = 0; it < n_it; ++it, ++g) {
          const int s = g % STAGES;
          const uint32_t sa = base + s * STAGE_BYTES;
          mbar_wait(empty(s), ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          tma_load_2d(sa, &P.map_a, full(s), it * BK, m0);
          tma_load_2d(sa + A_STAGE, &P.map_b[z], full(s), it * BK, n0);
        }
      }
    }
  } else {
    // ---- consumers: tiles j = wg, wg + 2, ... of the block ----
    setmaxnreg_inc<232>();
    const int lane = tid % 32, quad = lane % 4, warp = (tid % 128) / 32;
    const int rl = warp * 16 + lane / 4;  // a fragment's first row in each 64
    unsigned char* stage = smem_raw + (base - raw) + L::OUT_OFF + wg * L::OUT_BYTES +
                           warp * 32 * RB;  // this warp's 32 staged rows
    const T* __restrict__ res = static_cast<const T*>(p.res);
    int32_t acc[2][64];  // rows 0-63 and 64-127 of the tile
    for (int j = wg; j < count; j += CONSUMERS) {
      if (j > 0) named_sync(ORDER_BAR + wg, 256);  // the other issued tile j - 1's products
      int z, m0, n0;
      tile_origin(P, b + j * G, z, m0, n0);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;
      const int g0 = j * n_it;
      for (int it = 0; it < n_it; ++it) {
        const int g = g0 + it, s = g % STAGES;
        const uint32_t sa = base + s * STAGE_BYTES, sb = sa + A_STAGE;
        mbar_wait(full(s), (g / STAGES) & 1);
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks) {
          const uint64_t db = smem_desc(sb + 32 * ks, 16, 1024, true);
          vidi::wgmma_s8(acc[0], smem_desc(sa + 32 * ks, 16, 1024, true), db, 1);
          vidi::wgmma_s8(acc[1], smem_desc(sa + 64 * BK + 32 * ks, 16, 1024, true), db, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the stage before is read out: hand it back
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        if (it > 0 && lane == 0) mbar_arrive(empty((g - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (lane == 0) mbar_arrive(empty((g0 + n_it - 1) % STAGES));
      // the other consumer's next tile may start its products
      if (j + 1 < count) named_arrive(ORDER_BAR + (1 - wg), 256);

      // ---- epilogue, beside the other consumer's products ----
      // acc[h][4 c + 2 i + e]: row h 64 + rl + 8 i, column 8 c + 2 quad + e
      const float* __restrict__ scol = p.sb[z];
      const float* __restrict__ bias = p.bias[z];
      T* out = static_cast<T*>(p.out[z]);
      float s_row[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = m0 + h * 64 + rl + 8 * i;
          s_row[h][i] = m < p.M ? p.sa[m] : 0.0f;
        }
#pragma unroll
      for (int hc = 0; hc < BN / HALF; ++hc) {
#pragma unroll
        for (int cc = 0; cc < HALF / 8; ++cc) {
          const int c = hc * (HALF / 8) + cc;
          const int n = n0 + 8 * c + 2 * quad;
          if (n < p.N) {  // N is even
            const float sc0 = scol[n], sc1 = scol[n + 1], b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const float r0 = epilogue<T, EPI>(acc[h][4 * c + 2 * i], s_row[h][i], sc0, b0,
                                                  0, 0.0f, p.act);
                const float r1 = epilogue<T, EPI>(acc[h][4 * c + 2 * i + 1], s_row[h][i], sc1,
                                                  b1, 0, 0.0f, p.act);
                store_pair(reinterpret_cast<T*>(stage + (h * 16 + lane / 4 + 8 * i) * RB) +
                               8 * cc + 2 * quad,
                           r0, r1);
              }
          }
        }
        __syncwarp();
        constexpr int PER = 16 / sizeof(T), CHUNKS = HALF / PER;  // 16-byte pieces of a row
#pragma unroll 4
        for (int idx = lane; idx < 32 * CHUNKS; idx += 32) {
          const int row = idx / CHUNKS, ch = idx % CHUNKS;
          const int m = m0 + (row / 16) * 64 + warp * 16 + row % 16;
          const int n = n0 + hc * HALF + ch * PER;
          if (m < p.M && n < p.N) {  // N % 16 == 0: a piece is whole or absent
            uint4 piece = *reinterpret_cast<const uint4*>(stage + row * RB + ch * 16);
            if constexpr (EPI == EPI_BIAS_RES) {  // residual + the staged, T-rounded product
              float y[PER], rv[PER];
              vidi::unpack16(piece, y);
              vidi::unpack16(*reinterpret_cast<const uint4*>(res + (long long)m * p.N + n), rv);
#pragma unroll
              for (int e = 0; e < PER; ++e) y[e] = __fadd_rn(rv[e], y[e]);
              piece = vidi::pack16(y);
            }
            *reinterpret_cast<uint4*>(out + (long long)m * p.N + n) = piece;
          }
        }
        __syncwarp();  // the staged half is stored before the next overwrites it
      }
    }
  }
}

}  // namespace pp

// out[z] = epilogue(a . b[z]^T) for z < n_mats, on the persistent kernel:
// min(tiles, sms) blocks. K % 16 == 0 (TMA row starts), N % 16 == 0 (16-byte
// stores), res 16-byte aligned; EPI is EPI_BIAS or EPI_BIAS_RES.
template <typename T, int EPI>
cudaError_t gemm_pp(GemmArgs g, int n_mats, int sms, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(pp::int8_gemm_pp_sm90<T, EPI>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           pp::Layout<T>::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (g.M < 1 || g.N < 1 || g.K < 1 || g.K % 16 || g.N % 16 || n_mats < 1 || n_mats > 3 ||
      sms < 1 || !aligned16(g.res))
    return cudaErrorInvalidValue;
  pp::PpParams P;
  if (!vidi::sm90::make_map_s8(&P.map_a, g.a, g.K, g.M, pp::BK, pp::BM))
    return cudaErrorInvalidValue;
  for (int i = 0; i < n_mats; ++i)
    if (!vidi::sm90::make_map_s8(&P.map_b[i], g.b[i], g.K, g.N, pp::BK, pp::BN))
      return cudaErrorInvalidValue;
  P.g = g;
  P.tiles_m = (g.M + pp::BM - 1) / pp::BM;
  P.tiles_n = (g.N + pp::BN - 1) / pp::BN;
  const long long total = (long long)P.tiles_m * P.tiles_n * n_mats;
  if (total > (1ll << 30)) return cudaErrorInvalidValue;
  P.total = static_cast<int>(total);
  const int grid = P.total < sms ? P.total : sms;
  pp::int8_gemm_pp_sm90<T, EPI><<<grid, pp::THREADS, pp::Layout<T>::SMEM_BYTES, s>>>(P);
  return cudaGetLastError();
}

}  // namespace vidi_int8
