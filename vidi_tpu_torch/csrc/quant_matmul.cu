// K6: W8A8 matmuls of the int8 text decoder's prefill.
//
// Replaces the Pallas kernels of vidi_tpu/ops/pallas/quant_matmul.py:
// `quant_matmul` (x [M, K] -> per-row int8 -> int8 x int8 -> int32 ->
// x sx x sw per column -> cast; optionally by a per-row absmax the caller
// gives, for a product whose K is cut over ranks) and stage 1 of `quant_gated_mlp` (one
// shared quantize of x, the gate and up products, each rescaled and cast,
// act(gate) * up in the activation dtype). The gated MLP's down projection
// is a `quant_matmul` call of its own, as in JAX.
//
// What bounds it on an H100: at the prefill's shapes (Gemma2-9B k/v
// [23,520 x 3584] . [3584 x 2048], the diagonal update's 735-row chunks
// through the folded o [2048 x 3584], gate / up [3584 x 14336] and down
// [14336 x 3584]) it does 0.6-2 int8 operations per weight or activation
// byte times the row count, far above the card's ~590 int8 ops per byte:
// tensor-core bound, 1,979 TOP/s. The TPU kernel quantized an x block in
// VMEM beside the dot; here a row pass writes int8 x and fp32 scales once
// (1 byte per element against bf16's 2; the row read once, 16 bytes a load)
// and the GEMM of csrc/int8_gemm.cuh runs the product on wgmma s8 from a
// TMA-fed four-stage ring, with the rescale, cast and gated epilogue fused
// into its store. The weights come K-major ([N, K]: 8-bit wgmma reads both
// operands k-contiguous); the wrapper makes that copy with
// `vidi_int8_transpose` and keeps it over the calls that share a weight.
#include "int8_gemm.cuh"

namespace {

using vidi_int8::GemmArgs;

// wt [N, K] = w [K, N]^T, int8, through a 64 x 64 byte tile in shared
// memory: 4-byte loads along N, 4-byte stores along K (K % 4 == N % 4 == 0).
// It moves bytes and computes nothing of a product.
__global__ void __launch_bounds__(256) vidi_transpose_s8_kernel(const int8_t* __restrict__ w,
                                                           int8_t* __restrict__ wt, int K,
                                                           int N) {
  __shared__ int8_t tile[64][64 + 4];
  const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int c = (threadIdx.x & 15) * 4, r = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + r + 16 * i, n = n0 + c;
    uint32_t word = 0u;
    if (k < K && n < N) word = *reinterpret_cast<const uint32_t*>(w + (long long)k * N + n);
    *reinterpret_cast<uint32_t*>(&tile[r + 16 * i][c]) = word;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int nl = r + 16 * i, n = n0 + nl, k = k0 + c;
    if (n < N && k < K) {
      const uint32_t word = (uint32_t)(uint8_t)tile[c][nl] | (uint32_t)(uint8_t)tile[c + 1][nl] << 8 |
                            (uint32_t)(uint8_t)tile[c + 2][nl] << 16 |
                            (uint32_t)(uint8_t)tile[c + 3][nl] << 24;
      *reinterpret_cast<uint32_t*>(wt + (long long)n * K + k) = word;
    }
  }
}

cudaError_t transpose_s8(const int8_t* w, int8_t* wt, int K, int N, cudaStream_t s) {
  if (K % 4 || N % 4 || K < 1 || N < 1) return cudaErrorInvalidValue;
  const dim3 grid((N + 63) / 64, (K + 63) / 64);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  vidi_transpose_s8_kernel<<<grid, 256, 0, s>>>(w, wt, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t quant_matmul(const void* x, int8_t* xq, float* sx, const float* amax,
                         const int8_t* wt, const float* sw, void* out, int M, int N, int K,
                         cudaStream_t s) {
  cudaError_t err = vidi_int8::quantize_rows<T>(static_cast<const T*>(x), M, K, nullptr,
                                                nullptr, 0.0f, xq, sx, s, -1, amax);
  if (err != cudaSuccess) return err;
  GemmArgs p = vidi_int8::gemm_args(xq, sx, M, N, K);
  p.b[0] = wt; p.sb[0] = sw; p.out[0] = out;
  return vidi_int8::gemm<T, vidi_int8::EPI_SCALE>(p, 1, s);
}

template <typename T>
cudaError_t quant_gated(const void* x, int8_t* xq, float* sx, const int8_t* gt,
                        const float* sg, const int8_t* ut, const float* su, void* h,
                        int M, int N, int K, int act, cudaStream_t s) {
  cudaError_t err = vidi_int8::quantize_rows<T>(static_cast<const T*>(x), M, K, nullptr,
                                                nullptr, 0.0f, xq, sx, s);
  if (err != cudaSuccess) return err;
  GemmArgs p = vidi_int8::gemm_args(xq, sx, M, N, K);
  p.b[0] = gt; p.sb[0] = sg; p.b[1] = ut; p.sb[1] = su; p.out[0] = h; p.act = act;
  return vidi_int8::gemm<T, vidi_int8::EPI_GATED>(p, 1, s);
}

}  // namespace

// out [M, N] = cast((int8(x) . wt^T) * sx * sw); wt [N, K] is the weight's
// K-major copy; xq / sx are the caller's scratch. amax [M] fp32, or null:
// the absmax each row is quantized by (the row-scale mode: a row-cut
// product's rank quantizes its slice of K by the whole row's absmax, the
// max of every rank's `vidi_row_amax`); null takes the row's own.
extern "C" int vidi_quant_matmul(const void* x, void* xq, void* sx, const void* amax,
                                 const void* wt, const void* sw, void* out, int M, int N, int K,
                                 int is_bf16, void* stream) {
  auto q = static_cast<int8_t*>(xq);
  auto s = static_cast<float*>(sx);
  auto am = static_cast<const float*>(amax);
  auto wi = static_cast<const int8_t*>(wt);
  auto wsc = static_cast<const float*>(sw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? quant_matmul<__nv_bfloat16>(x, q, s, am, wi, wsc, out, M, N, K, st)
      : quant_matmul<float>(x, q, s, am, wi, wsc, out, M, N, K, st);
  return static_cast<int>(err);
}

// amax [M] = max |x[r, :]| of x [M, K] (bf16 or fp32) in fp32: the
// reduction half of the row pass, one block a row.
extern "C" int vidi_row_amax(const void* x, void* amax, int M, int K, int is_bf16,
                             void* stream) {
  auto am = static_cast<float*>(amax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? vidi_int8::quantize_rows<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), M, K,
                                                nullptr, nullptr, 0.0f, nullptr, nullptr, st,
                                                -1, nullptr, am)
      : vidi_int8::quantize_rows<float>(static_cast<const float*>(x), M, K, nullptr, nullptr,
                                        0.0f, nullptr, nullptr, st, -1, nullptr, am);
  return static_cast<int>(err);
}

// h [M, N] = act(cast(gate)) * cast(up), both from one quantize of x; gt /
// ut [N, K] are the K-major copies of the gate and up weights.
extern "C" int vidi_quant_gated(const void* x, void* xq, void* sx, const void* gt,
                                const void* sg, const void* ut, const void* su, void* h,
                                int M, int N, int K, int act, int is_bf16, void* stream) {
  auto q = static_cast<int8_t*>(xq);
  auto s = static_cast<float*>(sx);
  auto gi = static_cast<const int8_t*>(gt);
  auto ui = static_cast<const int8_t*>(ut);
  auto gs = static_cast<const float*>(sg);
  auto us = static_cast<const float*>(su);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? quant_gated<__nv_bfloat16>(x, q, s, gi, gs, ui, us, h, M, N, K, act, st)
      : quant_gated<float>(x, q, s, gi, gs, ui, us, h, M, N, K, act, st);
  return static_cast<int>(err);
}

// wt [N, K] = w [K, N]^T (int8): the K-major copy of a weight.
extern "C" int vidi_int8_transpose(const void* w, void* wt, int K, int N, void* stream) {
  return static_cast<int>(transpose_s8(static_cast<const int8_t*>(w), static_cast<int8_t*>(wt),
                                       K, N, static_cast<cudaStream_t>(stream)));
}
