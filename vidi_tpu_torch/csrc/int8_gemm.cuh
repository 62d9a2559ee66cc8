// The int8 core shared by K5 (csrc/fused_tower_layer.cu) and K6
// (csrc/quant_matmul.cu): a per-row int8 quantize pass (optionally behind a
// LayerNorm) and an int8 x int8 -> int32 tensor-core GEMM whose epilogue
// rescales, adds a bias or a residual, applies an activation and casts.
//
// Numerics are those of vidi_tpu/infer/quantize.py (quantize_act,
// dynamic_qdense) and vidi_tpu/ops/pallas/fused_tower_layer.py (_qdot):
// amax over the row as fp32; s = amax / 127 (1 when amax is 0), a true
// division; q = clip(rint(x / s), +-127), round half to even; the int32
// sums are exact; the epilogue's multiplies and adds use the _rn
// intrinsics so nvcc fuses none of them into an FMA, and each rounding to
// the activation dtype sits where the JAX code has it.
//
// The GEMM: 128 x 128 output tiles (two 128-column halves of gate and up
// for the gated epilogue, 64 columns of output), 256 threads in 2 x 4
// warps of 64 x 32, k steps of 64, mma.sync.m16n8k32 s8. The weights are
// [K, N] with N contiguous and the mma reads B k-contiguous, so each thread
// transposes 4 x 4 byte blocks with __byte_perm on the way to shared
// memory. One stage, no cp.async pipeline: wgmma and TMA are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vidi_int8 {

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int A_LD = BK + 16;  // bytes per staged A row: fragment reads hit distinct banks
constexpr int B_LD = BK + 4;   // bytes per staged B^T row (word stores / reads)

enum Epilogue { EPI_SCALE = 0, EPI_BIAS = 1, EPI_BIAS_RES = 2, EPI_BIAS_ACT = 3, EPI_GATED = 4 };
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

// One block per row of x [M, K] (row stride K): xq [M, K] int8, sx [M].
// With ln_s: the row first goes through LayerNorm in fp32 and is rounded to
// T, as fused_tower_layer's `_ln_f32(...).astype(dt)`.
template <typename T>
__global__ void __launch_bounds__(THREADS) quantize_rows_kernel(
    const T* __restrict__ x, int K, const float* __restrict__ ln_s,
    const float* __restrict__ ln_b, float eps, int8_t* __restrict__ xq,
    float* __restrict__ sx) {
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
    return v;
  };
  float amax = 0.0f;
  for (int i = threadIdx.x; i < K; i += THREADS) amax = fmaxf(amax, fabsf(value(i)));
  amax = block_reduce(amax, red, true);
  const float s = amax > 0.0f ? amax / 127.0f : 1.0f;
  int8_t* qr = xq + row * K;
  for (int i = threadIdx.x; i < K; i += THREADS) {
    const float q = fminf(fmaxf(rintf(value(i) / s), -127.0f), 127.0f);
    qr[i] = static_cast<int8_t>(q);
  }
  if (threadIdx.x == 0) sx[row] = s;
}

struct GemmArgs {
  const int8_t* a;       // [M, K] int8, row stride K
  const float* sa;       // [M] row scales
  const int8_t* b[3];    // [K, N] int8 weights (blockIdx.z picks one; gated: gate, up)
  const float* sb[3];    // [N] column scales
  const float* bias[3];  // [N] fp32 (EPI_BIAS*)
  void* out[3];          // [M, N] T
  const void* res;       // [M, N] T (EPI_BIAS_RES)
  int M, N, K, act;
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS) int8_gemm_kernel(GemmArgs p) {
  constexpr bool GATED = EPI == EPI_GATED;
  __shared__ __align__(16) int8_t As[BM * A_LD];
  __shared__ __align__(16) int8_t Bs[BN * B_LD];
  const int z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * (GATED ? BN / 2 : BN);
  const int M = p.M, N = p.N, K = p.K;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A: 128 rows x 64 bytes, 16 bytes a load (K % 16 == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx >> 2, c16 = (idx & 3) * 16;
      const int gm = m0 + row, gk = k0 + c16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M && gk < K)
        v = *reinterpret_cast<const uint4*>(p.a + static_cast<long long>(gm) * K + gk);
      *reinterpret_cast<uint4*>(As + row * A_LD + c16) = v;
    }
    // B: 64 k x 128 staged columns as 4 x 4 byte blocks, transposed into
    // Bs[n][k]. Gated: staged columns [32w, 32w+16) are gate's output
    // columns n0 + 16w + [0, 16), [32w+16, 32w+32) up's same columns, so a
    // thread's n8 tiles ni and ni + 2 hold gate and up of one output.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int c = (idx & 31) * 4, kb = idx >> 5;
      const int8_t* src;
      int col;
      if (GATED) {
        const int r = c & 31;
        src = r < 16 ? p.b[0] : p.b[1];
        col = n0 + (c >> 5) * 16 + (r & 15);
      } else {
        src = p.b[z];
        col = n0 + c;
      }
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gk = k0 + kb * 4 + r;
        w[r] = (gk < K && col < N)
                   ? *reinterpret_cast<const uint32_t*>(src + static_cast<long long>(gk) * N + col)
                   : 0u;
      }
      const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
      int8_t* dst = Bs + c * B_LD + kb * 4;
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + B_LD) = __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * B_LD) = __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * B_LD) = __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* ap = As + (wm + mi * 16 + g) * A_LD + kk + t * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * A_LD);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(ap + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * A_LD + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* bp = Bs + (wn + ni * 8 + g) * B_LD + kk + t * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(bp);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8
  T* out = static_cast<T*>(p.out[z]);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + half * 8;
      if (m >= M) continue;
      const float s_row = p.sa[m];
#pragma unroll
      for (int ni = 0; ni < (GATED ? 2 : 4); ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = half * 2 + e;
          const int n = GATED ? n0 + (wn >> 5) * 16 + ni * 8 + t * 2 + e
                              : n0 + wn + ni * 8 + t * 2 + e;
          if (n >= N) continue;
          const long long o = static_cast<long long>(m) * N + n;
          const float y = __fmul_rn(__fmul_rn(static_cast<float>(acc[mi][ni][v]), s_row), p.sb[z][n]);
          float r;
          if constexpr (EPI == EPI_SCALE) {
            r = y;
          } else if constexpr (EPI == EPI_BIAS) {
            r = __fadd_rn(y, p.bias[z][n]);
          } else if constexpr (EPI == EPI_BIAS_RES) {
            const float yb = round_to<T>(__fadd_rn(y, p.bias[z][n]));
            r = __fadd_rn(to_f<T>(static_cast<const T*>(p.res)[o]), yb);
          } else if constexpr (EPI == EPI_BIAS_ACT) {
            r = activate<T>(round_to<T>(__fadd_rn(y, p.bias[z][n])), p.act);
          } else {  // gated: act(gate) * up, each rounded to T
            const float up = round_to<T>(__fmul_rn(
                __fmul_rn(static_cast<float>(acc[mi][ni + 2][v]), s_row), p.sb[1][n]));
            r = __fmul_rn(activate<T>(round_to<T>(y), p.act), up);
          }
          out[o] = from_f<T>(r);
        }
      }
    }
  }
}

template <typename T>
cudaError_t quantize_rows(const T* x, int M, int K, const float* ln_s, const float* ln_b,
                          float eps, int8_t* xq, float* sx, cudaStream_t s) {
  quantize_rows_kernel<T><<<M, THREADS, 0, s>>>(x, K, ln_s, ln_b, eps, xq, sx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gemm(const GemmArgs& p, int epi, int n_mats, cudaStream_t s) {
  const int bn = epi == EPI_GATED ? BN / 2 : BN;
  const dim3 grid((p.N + bn - 1) / bn, (p.M + BM - 1) / BM, n_mats);
  switch (epi) {
    case EPI_SCALE: int8_gemm_kernel<T, EPI_SCALE><<<grid, THREADS, 0, s>>>(p); break;
    case EPI_BIAS: int8_gemm_kernel<T, EPI_BIAS><<<grid, THREADS, 0, s>>>(p); break;
    case EPI_BIAS_RES: int8_gemm_kernel<T, EPI_BIAS_RES><<<grid, THREADS, 0, s>>>(p); break;
    case EPI_BIAS_ACT: int8_gemm_kernel<T, EPI_BIAS_ACT><<<grid, THREADS, 0, s>>>(p); break;
    case EPI_GATED: int8_gemm_kernel<T, EPI_GATED><<<grid, THREADS, 0, s>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

inline GemmArgs gemm_args(const int8_t* a, const float* sa, int M, int N, int K) {
  GemmArgs p = {};
  p.a = a; p.sa = sa; p.M = M; p.N = N; p.K = K; p.act = 0;
  return p;
}

}  // namespace vidi_int8
