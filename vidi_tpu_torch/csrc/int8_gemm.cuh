// The int8 core of K6 (csrc/quant_matmul.cu), whose row pass and epilogue
// arithmetic K5 (csrc/fused_tower_layer.cu, on csrc/int8_gemm_pp.cuh)
// shares: a per-row int8 quantize pass (optionally behind a LayerNorm or
// with an activation first), the epilogue of one output value (rescale,
// bias or residual, the gated activation, cast), and an int8 x int8 ->
// int32 GEMM for Hopper (sm_90a) with K6's epilogues.
//
// Replaces the products of vidi_tpu/ops/pallas/quant_matmul.py and
// vidi_tpu/ops/pallas/fused_tower_layer.py. Numerics are those of
// vidi_tpu/infer/quantize.py (quantize_act, dynamic_qdense) and of
// fused_tower_layer.py's _qdot: amax over the row as fp32; s = amax / 127
// (1 when amax is 0), a true division; q = clip(rint(x / s), +-127), round
// half to even; the int32 sums are exact in any order; the epilogue's
// multiplies and adds use the _rn intrinsics so nvcc fuses none of them into
// an FMA, and each rounding to the activation dtype sits where the JAX code
// has it (`epilogue` below, the one place that arithmetic lives).
//
// What bounds it on an H100: the products do hundreds to thousands of int8
// operations per byte they read, so the tensor cores (1,979 TOP/s), which
// only wgmma reaches. The design:
//  - One block computes 128 rows x 256 columns (gated: 128 columns of gate
//    and the same 128 of up, so act(gate) * up is formed in registers). Two
//    consumer warpgroups of 64 rows each run wgmma m64n256k32 s8 with both
//    operands in shared memory and 128 int32 sums a thread; a producer
//    warpgroup, one thread of which starts every TMA load, gives its
//    registers away (setmaxnreg 40 / 232).
//  - A and B tiles of 128 k values (one 128-byte swizzled row) arrive by TMA
//    in a ring of four stages of 48 KB, each with a "full" and an "empty"
//    mbarrier; a consumer keeps one group of products in flight and releases
//    the stage before. TMA fills past M, N and K with zeros, which add 0 to
//    an exact sum: ragged edges are masked only in the store.
//  - 8-bit wgmma reads both operands k-contiguous. x's int8 rows are; the
//    weights [K, N] are not, so the GEMM takes a K-major copy [N, K] that the
//    wrapper makes once per weight (csrc/quant_matmul.cu's byte transpose)
//    and reuses (ops/cuda/quant_matmul.py, KMajorCache).
//  - Blocks are numbered along the dimension with fewer tiles first, so the
//    blocks that run together share the other operand's tile in L2. Even so
//    one block a tile asks L2 for 48 KB a k-step, 11 TB/s over 132 SMs at the
//    tensor cores' rate: blocks run in clusters of CLUSTER_M tiles along M,
//    which share their B tile; each loads its share of B's rows and
//    multicasts them, so B crosses L2 once per cluster (measured 5-10% on the
//    k / v and down products; sharing A along N as well, 2 x 2 or 1 x 2,
//    gave no more). A stage is handed back to every block that writes into
//    it (remote mbarrier arrivals).
//  - The ring is free once the last products are read out, so the output
//    tile is staged there and leaves in whole 16-byte pieces of a row, not
//    in the fragments' 4-byte pairs.
//  - K is not split: at down's [735 x 14336] . [14336 x 3584] (84 tiles for
//    132 SMs) parts of K through an int32 workspace were measured and came
//    out level or slower (the workspace's traffic ate the gain).
// What is left: one block a SM (its registers), so nothing runs beside a
// block's epilogue, and eight consumer warps hide little of an activation's
// latency: the gated epilogue costs as much as its k loop (tanhf, expf and
// the true division stay, for bit-equal results).
// The row pass reads its row once with 16-byte loads and keeps it in
// registers between the statistics and the quantize (rows of up to 14,336
// values; longer or unaligned rows take the scalar pass).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "vec16.cuh"
#include "wgmma.cuh"

namespace vidi_int8 {

constexpr int THREADS = 256;        // row passes
constexpr int ROW_REGS = 56;        // most values a thread of the vector row pass holds
constexpr int ROW_REGS_SHORT = 16;  // its variant for rows of up to 4,096 values
constexpr int BM = 128, BN = 256;   // output tile; gated: BN / 2 output columns
constexpr int BK = 128;             // k values (bytes) per stage: one swizzled row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;        // warpgroups of 64 rows
constexpr int CLUSTER_M = 2;        // tiles of a cluster, along M: they share their B tile
constexpr int GEMM_THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int A_STAGE = BM * BK, B_STAGE = BN * BK, STAGE_BYTES = A_STAGE + B_STAGE;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;        // full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = BAR_OFF + 16 * STAGES + 1024;  // + alignment slack
static_assert(SMEM_BYTES <= 232448, "a block has 227 KB of shared memory");
static_assert(A_STAGE % 1024 == 0 && STAGE_BYTES % 1024 == 0, "swizzle atoms are 1024-byte aligned");

enum Epilogue { EPI_SCALE = 0, EPI_BIAS = 1, EPI_BIAS_RES = 2, EPI_GATED = 4 };
enum Activation { ACT_GELU_TANH = 0, ACT_GELU = 1, ACT_QUICK_GELU = 2, ACT_SILU = 3 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back: the value a T tensor would hold
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// act(x) for x already rounded to T, rounded to T: PyTorch's formulas
// (F.gelu tanh / erf, F.silu in fp32), and quick_gelu as the plain
// x * sigmoid(1.702 x) rounds it, after each of its three ops.
template <typename T>
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_GELU_TANH: {
      const float beta = 0.7978845608028654f, kappa = 0.044715f;
      const float inner = beta * (x + kappa * (x * x * x));
      return round_to<T>(0.5f * x * (1.0f + tanhf(inner)));
    }
    case ACT_GELU:
      return round_to<T>(x * 0.5f * (1.0f + erff(x * 0.7071067811865476f)));
    case ACT_QUICK_GELU: {
      const float z = round_to<T>(1.702f * x);
      const float sg = round_to<T>(1.0f / (1.0f + expf(-z)));
      return round_to<T>(x * sg);
    }
    default:
      return round_to<T>(x / (1.0f + expf(-x)));
  }
}

// One output value from its exact int32 sum: x s_row x sb, then the
// epilogue's own steps, each rounding to T where the JAX code has it. `up`
// / `sb_up` are the gated epilogue's second product; the caller casts the
// result to T. EPI_BIAS_RES gives the product rounded to T: the residual is
// added to it where the tile is stored.
template <typename T, int EPI>
__device__ __forceinline__ float epilogue(int32_t acc, float s_row, float sb, float bias,
                                          int32_t up, float sb_up, int act) {
  const float y = __fmul_rn(__fmul_rn(static_cast<float>(acc), s_row), sb);
  if constexpr (EPI == EPI_SCALE) {
    return y;
  } else if constexpr (EPI == EPI_BIAS) {
    return __fadd_rn(y, bias);
  } else if constexpr (EPI == EPI_BIAS_RES) {
    return round_to<T>(__fadd_rn(y, bias));
  } else {  // gated: act(gate) * up, each rounded to T
    const float u = round_to<T>(__fmul_rn(__fmul_rn(static_cast<float>(up), s_row), sb_up));
    return __fmul_rn(activate<T>(round_to<T>(y), act), u);
  }
}

// ---- the row pass -------------------------------------------------------

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is reused across calls
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? red[lane] : 0.0f;  // amax >= 0: 0 is neutral for both
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = is_max ? fmaxf(v, w) : v + w;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__device__ __forceinline__ float quantize_value(float v, float s) {
  return fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);
}

// One block per row of x [M, K] (row stride K): xq [M, K] int8, sx [M].
// With ln_s: the row first goes through LayerNorm in fp32 and is rounded to
// T, as fused_tower_layer's `_ln_f32(...).astype(dt)`. With ACT: each value
// (already T) first goes through `activate` (K5's FFN hidden: the
// activation runs here, across all the SM's warps, and not in the GEMM
// epilogue's four, where its branches left it latency-bound). The row is read once,
// 16 bytes a load, and held in registers, REGS values a thread (K <=
// THREADS * REGS, K % 16 == 0, 16-byte aligned pointers): few registers for
// short rows, so that enough blocks run at once to fill the memory pipe.
template <typename T, int REGS, bool ACT>
__global__ void __launch_bounds__(THREADS) quantize_rows_vec_kernel(
    const T* __restrict__ x, int K, const float* __restrict__ ln_s,
    const float* __restrict__ ln_b, float eps, int act, int8_t* __restrict__ xq,
    float* __restrict__ sx, const float* __restrict__ amax_in, float* __restrict__ amax_out) {
  constexpr int V = 16 / sizeof(T), NV = REGS / V;
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * K;
  const int nvec = K / V;
  float v[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    if (idx < nvec) {
      vidi::unpack16(*reinterpret_cast<const uint4*>(xr + idx * V), v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[j][e] = 0.0f;
    }
  }
  if (ln_s != nullptr) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[j][e];  // absent values are 0
    const float mean = block_reduce(s, red, false) / static_cast<float>(K);
    float d2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (threadIdx.x + j * THREADS < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = v[j][e] - mean;
          d2 += d * d;
        }
      }
    }
    const float var = block_reduce(d2, red, false) / static_cast<float>(K);
    const float rstd = 1.0f / sqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      if (idx < nvec) {
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {
          const float4 ls4 = reinterpret_cast<const float4*>(ln_s + idx * V)[h];
          const float4 lb4 = reinterpret_cast<const float4*>(ln_b + idx * V)[h];
          const float ls[4] = {ls4.x, ls4.y, ls4.z, ls4.w};
          const float lb[4] = {lb4.x, lb4.y, lb4.z, lb4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[j][4 * h + e] = round_to<T>(__fadd_rn(
                __fmul_rn(__fmul_rn(__fsub_rn(v[j][4 * h + e], mean), rstd), ls[e]), lb[e]));
        }
      }
    }
  }
  if constexpr (ACT) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (threadIdx.x + j * THREADS < nvec)
#pragma unroll
        for (int e = 0; e < V; ++e) v[j][e] = activate<T>(v[j][e], act);
  }
  float amax = 0.0f;
  if (amax_in != nullptr) {
    amax = amax_in[row];
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[j][e]));
    amax = block_reduce(amax, red, true);
    if (amax_out != nullptr) {  // the reduction half alone
      if (threadIdx.x == 0) amax_out[row] = amax;
      return;
    }
  }
  const float s = amax > 0.0f ? amax / 127.0f : 1.0f;
  int8_t* qr = xq + row * K;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    if (idx < nvec) {
      uint32_t w[V / 4];
#pragma unroll
      for (int h = 0; h < V / 4; ++h) {
        w[h] = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = static_cast<int>(quantize_value(v[j][4 * h + e], s));
          w[h] |= static_cast<uint32_t>(q & 0xff) << (8 * e);
        }
      }
      if constexpr (V == 8)
        *reinterpret_cast<uint2*>(qr + idx * V) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(qr + idx * V) = w[0];
    }
  }
  if (threadIdx.x == 0) sx[row] = s;
}

// The scalar row pass: any K, any alignment; reads the row up to three times.
template <typename T, bool ACT>
__global__ void __launch_bounds__(THREADS) quantize_rows_kernel(
    const T* __restrict__ x, int K, const float* __restrict__ ln_s,
    const float* __restrict__ ln_b, float eps, int act, int8_t* __restrict__ xq,
    float* __restrict__ sx, const float* __restrict__ amax_in, float* __restrict__ amax_out) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * K;
  float mean = 0.0f, rstd = 0.0f;
  if (ln_s != nullptr) {
    float s = 0.0f;
    for (int i = threadIdx.x; i < K; i += THREADS) s += to_f<T>(xr[i]);
    mean = block_reduce(s, red, false) / static_cast<float>(K);
    float v = 0.0f;
    for (int i = threadIdx.x; i < K; i += THREADS) {
      const float d = to_f<T>(xr[i]) - mean;
      v += d * d;
    }
    const float var = block_reduce(v, red, false) / static_cast<float>(K);
    rstd = 1.0f / sqrtf(var + eps);
  }
  auto value = [&](int i) -> float {
    float v = to_f<T>(xr[i]);
    if (ln_s != nullptr) {
      v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), ln_s[i]), ln_b[i]);
      v = round_to<T>(v);
    }
    if constexpr (ACT) v = activate<T>(v, act);
    return v;
  };
  float amax = 0.0f;
  if (amax_in != nullptr) {
    amax = amax_in[row];
  } else {
    for (int i = threadIdx.x; i < K; i += THREADS) amax = fmaxf(amax, fabsf(value(i)));
    amax = block_reduce(amax, red, true);
    if (amax_out != nullptr) {
      if (threadIdx.x == 0) amax_out[row] = amax;
      return;
    }
  }
  const float s = amax > 0.0f ? amax / 127.0f : 1.0f;
  int8_t* qr = xq + row * K;
  for (int i = threadIdx.x; i < K; i += THREADS)
    qr[i] = static_cast<int8_t>(quantize_value(value(i), s));
  if (threadIdx.x == 0) sx[row] = s;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, bool ACT>
cudaError_t quantize_rows_as(const T* x, int M, int K, const float* ln_s, const float* ln_b,
                             float eps, int act, int8_t* xq, float* sx, const float* amax_in,
                             float* amax_out, cudaStream_t s) {
  const bool vec = K % 16 == 0 && K <= THREADS * ROW_REGS && aligned16(x) && aligned16(xq) &&
                   aligned16(ln_s) && aligned16(ln_b);
  if (vec && K <= THREADS * ROW_REGS_SHORT)
    quantize_rows_vec_kernel<T, ROW_REGS_SHORT, ACT><<<M, THREADS, 0, s>>>(
        x, K, ln_s, ln_b, eps, act, xq, sx, amax_in, amax_out);
  else if (vec)
    quantize_rows_vec_kernel<T, ROW_REGS, ACT><<<M, THREADS, 0, s>>>(
        x, K, ln_s, ln_b, eps, act, xq, sx, amax_in, amax_out);
  else
    quantize_rows_kernel<T, ACT><<<M, THREADS, 0, s>>>(x, K, ln_s, ln_b, eps, act, xq, sx,
                                                       amax_in, amax_out);
  return cudaGetLastError();
}

// act >= 0: each value goes through that activation before the quantize.
// amax_in [M]: quantize row r by amax_in[r] / 127 (1 where it is 0) instead
// of the row's own absmax: a product whose contraction dim is cut over
// ranks quantizes each rank's slice of a row by the whole row's absmax.
// amax_out [M]: the reduction half alone, each row's absmax written there
// (xq / sx untouched).
template <typename T>
cudaError_t quantize_rows(const T* x, int M, int K, const float* ln_s, const float* ln_b,
                          float eps, int8_t* xq, float* sx, cudaStream_t s, int act = -1,
                          const float* amax_in = nullptr, float* amax_out = nullptr) {
  return act >= 0 ? quantize_rows_as<T, true>(x, M, K, ln_s, ln_b, eps, act, xq, sx, amax_in,
                                              amax_out, s)
                  : quantize_rows_as<T, false>(x, M, K, ln_s, ln_b, eps, act, xq, sx, amax_in,
                                               amax_out, s);
}

// ---- the GEMM -----------------------------------------------------------

struct GemmArgs {
  const int8_t* a;       // [M, K] int8, row stride K
  const float* sa;       // [M] row scales
  const int8_t* b[3];    // K-major weights [N, K] (blockIdx.z picks one; gated: gate, up)
  const float* sb[3];    // [N] column scales
  const float* bias[3];  // [N] fp32 (EPI_BIAS*, K5)
  void* out[3];          // [M, N] T
  const void* res;       // [M, N] T (EPI_BIAS_RES, K5)
  int M, N, K, act;
  int m_fast;            // blockIdx.x walks the row tiles (else the column tiles)
};

struct GemmParams {
  CUtensorMap map_a;
  CUtensorMap map_b[3];
  GemmArgs g;
};

template <typename T, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
int8_gemm_sm90(const __grid_constant__ GemmParams P) {
  using namespace vidi::sm90;
  static_assert(EPI == EPI_SCALE || EPI == EPI_GATED, "K6's epilogues");
  constexpr bool GATED = EPI == EPI_GATED;
  constexpr int COLS = GATED ? BN / 2 : BN;  // output columns per block
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const GemmArgs& p = P.g;
  const int tile_m = p.m_fast ? blockIdx.x : blockIdx.y;
  const int tile_n = p.m_fast ? blockIdx.y : blockIdx.x;
  // rank in the cluster (the grid is a whole number of clusters along M)
  const int cm = tile_m % CLUSTER_M;
  const int z = blockIdx.z;
  const int m0 = tile_m * BM, n0 = tile_n * COLS;
  const int n_it = (p.K + BK - 1) / BK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CONSUMERS * CLUSTER_M);  // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  const int wg = tid / 128;
  if (wg == CONSUMERS) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (tid == 128 * CONSUMERS) {
      // its own A tile, and its share of the rows of B's two halves of 128
      // for every block of the cluster
      constexpr int B_ROWS = BN / 2 / CLUSTER_M;
      constexpr uint16_t kAll = (1u << CLUSTER_M) - 1;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES, kc = it * BK;
        const uint32_t sa = base + s * STAGE_BYTES;
        const uint32_t sb = sa + A_STAGE + cm * B_ROWS * BK;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), STAGE_BYTES);
        tma_load_2d(sa, &P.map_a, full(s), kc, m0);
        const CUtensorMap* b0 = &P.map_b[GATED ? 0 : z];
        const CUtensorMap* b1 = &P.map_b[GATED ? 1 : z];
        const int n1 = GATED ? n0 : n0 + BN / 2;  // the second half's first weight row
        tma_load_2d_multicast(sb, b0, full(s), kc, n0 + cm * B_ROWS, kAll);
        tma_load_2d_multicast(sb + B_STAGE / 2, b1, full(s), kc, n1 + cm * B_ROWS, kAll);
      }
    }
    cluster_sync();  // no block leaves while another may still write to it
  } else {
    // ---- consumers: 64 rows x 256 staged columns per warpgroup ----
    setmaxnreg_inc<232>();
    int32_t acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES;
      const uint32_t sa = base + s * STAGE_BYTES + wg * 64 * BK;
      const uint32_t sb = base + s * STAGE_BYTES + A_STAGE;
      mbar_wait(full(s), (it / STAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        vidi::wgmma_s8(acc, smem_desc(sa + 32 * ks, 16, 1024, true),
                       smem_desc(sb + 32 * ks, 16, 1024, true), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the stage before is read out: hand it back to its writers
      if (it > 0 && tid % 32 == 0)
        for (int r = 0; r < CLUSTER_M; ++r) mbar_arrive_cluster(empty((it - 1) % STAGES), r);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // Both warpgroups have read the last stage: the ring is free to stage
    // the output tile, so that it leaves in 16-byte pieces of a row instead
    // of the fragments' 4-byte pairs.
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
    if (m0 < p.M && n0 < p.N) {  // else a block that only fills its cluster
      // acc[4 j + 2 i + e]: row rl + 8 i of the warpgroup's 64, staged column
      // 8 j + 2 quad + e; gated: staged columns 128.. are up's sums of
      // output column - 128
      constexpr int ROW_BYTES = COLS * sizeof(T) + 16;  // + 16: rows 8 apart on other banks
      unsigned char* stage = smem_raw + (base - raw) + wg * 64 * ROW_BYTES;
      const float* __restrict__ sb = p.sb[z];
      const float* __restrict__ sb_up = p.sb[1];
      const int act = p.act;
      const int lane = tid % 32, quad = lane % 4, warp = (tid % 128) / 32;
      const int rl = warp * 16 + lane / 4;
      const int m_row[2] = {m0 + wg * 64 + rl, m0 + wg * 64 + rl + 8};
      float s_row[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) s_row[i] = m_row[i] < p.M ? p.sa[m_row[i]] : 0.0f;
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j) {
        const int n = n0 + 8 * j + 2 * quad;
        if (n < p.N) {  // N is even
          float sc[2], su[2] = {0.0f, 0.0f};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[e] = sb[n + e];
            if constexpr (GATED) su[e] = sb_up[n + e];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (m_row[i] < p.M) {
              float r[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                int32_t up = 0;
                if constexpr (GATED) up = acc[4 * (j + COLS / 8) + 2 * i + e];
                r[e] = epilogue<T, EPI>(acc[4 * j + 2 * i + e], s_row[i], sc[e], 0.0f, up,
                                        su[e], act);
              }
              store_pair(reinterpret_cast<T*>(stage + (rl + 8 * i) * ROW_BYTES) + 8 * j + 2 * quad,
                         r[0], r[1]);
            }
          }
        }
      }
      __syncwarp();  // a warp stages and stores its own 16 rows
      constexpr int PER = 16 / sizeof(T), CHUNKS = COLS / PER;  // 16-byte pieces of a row
      T* out = static_cast<T*>(p.out[z]);
#pragma unroll 4
      for (int idx = lane; idx < 16 * CHUNKS; idx += 32) {
        const int row = warp * 16 + idx / CHUNKS, c = idx % CHUNKS;
        const int m = m0 + wg * 64 + row, n = n0 + c * PER;
        if (m < p.M && n < p.N) {  // N % 16 == 0: a piece is whole or absent
          *reinterpret_cast<uint4*>(out + (long long)m * p.N + n) =
              *reinterpret_cast<const uint4*>(stage + row * ROW_BYTES + c * 16);
        }
      }
    }
    cluster_sync();
  }
}

// out[z] = epilogue(a . b[z]^T) for z < n_mats (gated: one output from b[0],
// b[1]). K % 16 == 0 (TMA row starts), N % 16 == 0 (16-byte stores).
template <typename T, int EPI>
cudaError_t gemm(GemmArgs g, int n_mats, cudaStream_t s) {
  constexpr bool GATED = EPI == EPI_GATED;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_gemm_sm90<T, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (g.M < 1 || g.N < 1 || g.K < 1 || g.K % 16 || g.N % 16 || n_mats < 1 || n_mats > 3)
    return cudaErrorInvalidValue;
  GemmParams P;
  const int n_b = GATED ? 2 : n_mats;
  if (!vidi::sm90::make_map_s8(&P.map_a, g.a, g.K, g.M, BK, BM)) return cudaErrorInvalidValue;
  for (int i = 0; i < n_b; ++i)
    if (!vidi::sm90::make_map_s8(&P.map_b[i], g.b[i], g.K, g.N, BK, BN / 2 / CLUSTER_M))
      return cudaErrorInvalidValue;
  // whole clusters: the blocks past M or N load zeros and store nothing
  constexpr int COLS = GATED ? BN / 2 : BN;
  const int tm = ((g.M + BM - 1) / BM + CLUSTER_M - 1) / CLUSTER_M * CLUSTER_M;
  const int tn = (g.N + COLS - 1) / COLS;
  g.m_fast = tm < tn;
  const int gz = GATED ? 1 : n_mats;
  if ((g.m_fast ? tn : tm) > 65535 || gz > 65535) return cudaErrorInvalidValue;
  P.g = g;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.m_fast ? tm : tn, g.m_fast ? tn : tm, gz);
  cfg.blockDim = dim3(GEMM_THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = g.m_fast ? CLUSTER_M : 1;
  attr.val.clusterDim.y = g.m_fast ? 1 : CLUSTER_M;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_gemm_sm90<T, EPI>, P);
}

inline GemmArgs gemm_args(const int8_t* a, const float* sa, int M, int N, int K) {
  GemmArgs p = {};
  p.a = a; p.sa = sa; p.M = M; p.N = N; p.K = K; p.act = 0;
  return p;
}

}  // namespace vidi_int8
