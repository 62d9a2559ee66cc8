// K6: W8A8 matmuls of the int8 text decoder's prefill.
//
// Replaces the Pallas kernels of vidi_tpu/ops/pallas/quant_matmul.py:
// `quant_matmul` (x [M, K] -> per-row int8 -> int8 x int8 -> int32 ->
// x sx x sw per column -> cast) and stage 1 of `quant_gated_mlp` (one
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
// (1 byte per element against bf16's 2), and the GEMM (csrc/int8_gemm.cuh,
// mma.sync s8) fuses the rescale, cast and gated epilogue into its store.
// A simple kernel: one shared-memory stage, no wgmma / TMA yet.
#include "int8_gemm.cuh"

namespace {

template <typename T>
cudaError_t quant_matmul(const void* x, int8_t* xq, float* sx, const int8_t* w,
                         const float* sw, void* out, int M, int N, int K, cudaStream_t s) {
  cudaError_t err = vidi_int8::quantize_rows<T>(static_cast<const T*>(x), M, K, nullptr,
                                                nullptr, 0.0f, xq, sx, s);
  if (err != cudaSuccess) return err;
  vidi_int8::GemmArgs p = vidi_int8::gemm_args(xq, sx, M, N, K);
  p.b[0] = w; p.sb[0] = sw; p.out[0] = out;
  return vidi_int8::gemm<T>(p, vidi_int8::EPI_SCALE, 1, s);
}

template <typename T>
cudaError_t quant_gated(const void* x, int8_t* xq, float* sx, const int8_t* wg,
                        const float* sg, const int8_t* wu, const float* su, void* h,
                        int M, int N, int K, int act, cudaStream_t s) {
  cudaError_t err = vidi_int8::quantize_rows<T>(static_cast<const T*>(x), M, K, nullptr,
                                                nullptr, 0.0f, xq, sx, s);
  if (err != cudaSuccess) return err;
  vidi_int8::GemmArgs p = vidi_int8::gemm_args(xq, sx, M, N, K);
  p.b[0] = wg; p.sb[0] = sg; p.b[1] = wu; p.sb[1] = su; p.out[0] = h; p.act = act;
  return vidi_int8::gemm<T>(p, vidi_int8::EPI_GATED, 1, s);
}

}  // namespace

// out [M, N] = cast((int8(x) . w) * sx * sw); xq / sx are the caller's scratch.
extern "C" int vidi_quant_matmul(const void* x, void* xq, void* sx, const void* w,
                                 const void* sw, void* out, int M, int N, int K,
                                 int is_bf16, void* stream) {
  auto q = static_cast<int8_t*>(xq);
  auto s = static_cast<float*>(sx);
  auto wi = static_cast<const int8_t*>(w);
  auto ws = static_cast<const float*>(sw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? quant_matmul<__nv_bfloat16>(x, q, s, wi, ws, out, M, N, K, st)
      : quant_matmul<float>(x, q, s, wi, ws, out, M, N, K, st);
  return static_cast<int>(err);
}

// h [M, N] = act(cast(gate)) * cast(up), both from one quantize of x.
extern "C" int vidi_quant_gated(const void* x, void* xq, void* sx, const void* wg,
                                const void* sg, const void* wu, const void* su, void* h,
                                int M, int N, int K, int act, int is_bf16, void* stream) {
  auto q = static_cast<int8_t*>(xq);
  auto s = static_cast<float*>(sx);
  auto gi = static_cast<const int8_t*>(wg);
  auto ui = static_cast<const int8_t*>(wu);
  auto gs = static_cast<const float*>(sg);
  auto us = static_cast<const float*>(su);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? quant_gated<__nv_bfloat16>(x, q, s, gi, gs, ui, us, h, M, N, K, act, st)
      : quant_gated<float>(x, q, s, gi, gs, ui, us, h, M, N, K, act, st);
  return static_cast<int>(err);
}
