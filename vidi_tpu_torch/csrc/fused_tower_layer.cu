// K5: the int8 encoder-tower layer in three fused pieces.
//
// Replaces the Pallas kernels of vidi_tpu/ops/pallas/fused_tower_layer.py:
//   ln_qkv      x -> LN1 (fp32) -> cast -> per-row int8, once -> three int8
//               products, each x sx x sw + fp32 bias, one cast
//   o_residual  attn -> per-row int8 -> product + bias, cast, + residual
//   ln_ffn      x -> LN2 -> cast -> int8 -> fc1 + bias, cast -> act in the
//               activation dtype -> per-row int8 of the full (padded) ff row
//               -> fc2 + bias, cast -> + x
// for SigLIP-so400m ([4, 729, 1152], ff 4304 padded to 4352, gelu_tanh,
// eps 1e-6) and Whisper-large-v3 ([1, 1500, 1280], ff 5120, exact gelu,
// eps 1e-5; k has no bias, the wrapper passes zeros).
//
// What bounds it on an H100: per row the products do 2 x (3d^2 or d^2 or
// 2 d ff) int8 operations against ~d to ff bytes of activations, and the
// int8 weights (1.3-13 MB) are read once per 128-row tile: tensor-core
// bound, 1,979 TOP/s. The TPU kernel kept the weights resident in VMEM and
// pipelined whole row blocks; a block here has 227 KB of shared memory, so
// the layer piece is a row pass (LayerNorm and quantize; fp32 statistics,
// the same rounding points; the row read once and held in registers) plus
// the persistent ping-pong int8 GEMM of csrc/int8_gemm_pp.cuh (one block a
// SM walking every tile of the piece's products, a TMA ring kept full across
// tiles, two consumer warpgroups taking tiles in turn so that one's
// epilogue runs beside the other's products), whose epilogue applies the
// rescale, bias and residual on the accumulators, so only int8
// rows, scales and the T outputs cross device memory. Every weight comes as
// its K-major form [N, K] (the towers store their weights that way from
// load). ln_ffn's hidden row is written once in T (fc1 + bias, cast) and
// requantized by a second row pass, since its amax spans the whole ff row
// across tiles; that pass applies the activation first (in T, as the JAX
// code does), across all the SM's warps: in the GEMM epilogue's four warps
// its branchy tanhf / erff left fc1 latency-bound at ~3x its products.
// Exact gelu uses erff (the Pallas kernel's polynomial existed only because
// Mosaic lacks erf). LayerNorm and the quantize fused into the GEMM's
// producer, and the hidden requantized without a trip through device
// memory, are later work.
#include "int8_gemm_pp.cuh"

namespace {

using vidi_int8::GemmArgs;

template <typename T>
cudaError_t ln_qkv(const void* x, const float* ln_s, const float* ln_b, float eps,
                   int8_t* xq, float* sx, const int8_t* const* w, const float* const* sw,
                   const float* const* bias, void* const* out, int M, int d, int sms,
                   cudaStream_t s) {
  cudaError_t err = vidi_int8::quantize_rows<T>(static_cast<const T*>(x), M, d, ln_s, ln_b,
                                                eps, xq, sx, s);
  if (err != cudaSuccess) return err;
  GemmArgs p = vidi_int8::gemm_args(xq, sx, M, d, d);
  for (int i = 0; i < 3; ++i) {
    p.b[i] = w[i]; p.sb[i] = sw[i]; p.bias[i] = bias[i]; p.out[i] = out[i];
  }
  return vidi_int8::gemm_pp<T, vidi_int8::EPI_BIAS>(p, 3, sms, s);
}

template <typename T>
cudaError_t o_residual(const void* attn, const void* res, int8_t* xq, float* sx,
                       const int8_t* w, const float* sw, const float* bias, void* out,
                       int M, int d, int sms, cudaStream_t s) {
  cudaError_t err = vidi_int8::quantize_rows<T>(static_cast<const T*>(attn), M, d, nullptr,
                                                nullptr, 0.0f, xq, sx, s);
  if (err != cudaSuccess) return err;
  GemmArgs p = vidi_int8::gemm_args(xq, sx, M, d, d);
  p.b[0] = w; p.sb[0] = sw; p.bias[0] = bias; p.out[0] = out; p.res = res;
  return vidi_int8::gemm_pp<T, vidi_int8::EPI_BIAS_RES>(p, 1, sms, s);
}

template <typename T>
cudaError_t ln_ffn(const void* x, const float* ln_s, const float* ln_b, float eps,
                   int8_t* xq, float* sx, const int8_t* w1, const float* s1,
                   const float* b1, void* hidden, int8_t* hq, float* hsx,
                   const int8_t* w2, const float* s2, const float* b2, void* out,
                   int M, int d, int ff, int act, int sms, cudaStream_t s) {
  cudaError_t err = vidi_int8::quantize_rows<T>(static_cast<const T*>(x), M, d, ln_s, ln_b,
                                                eps, xq, sx, s);
  if (err != cudaSuccess) return err;
  GemmArgs p1 = vidi_int8::gemm_args(xq, sx, M, ff, d);
  p1.b[0] = w1; p1.sb[0] = s1; p1.bias[0] = b1; p1.out[0] = hidden;
  err = vidi_int8::gemm_pp<T, vidi_int8::EPI_BIAS>(p1, 1, sms, s);
  if (err != cudaSuccess) return err;
  err = vidi_int8::quantize_rows<T>(static_cast<const T*>(hidden), M, ff, nullptr, nullptr,
                                    0.0f, hq, hsx, s, act);
  if (err != cudaSuccess) return err;
  GemmArgs p2 = vidi_int8::gemm_args(hq, hsx, M, d, ff);
  p2.b[0] = w2; p2.sb[0] = s2; p2.bias[0] = b2; p2.out[0] = out; p2.res = x;
  return vidi_int8::gemm_pp<T, vidi_int8::EPI_BIAS_RES>(p2, 1, sms, s);
}

}  // namespace

// q, k, v [M, d] = cast(int8(LN1(x)) . w{q,k,v} * sx * sw + b); xq / sx scratch.
// Here and below every weight pointer is the K-major form [N, K] of its
// matrix, and `sms` the card's SMs (the persistent grid's most blocks).
extern "C" int vidi_ln_qkv(const void* x, const void* ln_s, const void* ln_b, void* xq,
                           void* sx, const void* wq, const void* wk, const void* wv,
                           const void* sq, const void* sk, const void* sv, const void* bq,
                           const void* bk, const void* bv, void* q, void* k, void* v,
                           int M, int d, int is_bf16, float eps, int sms, void* stream) {
  const int8_t* w[3] = {static_cast<const int8_t*>(wq), static_cast<const int8_t*>(wk),
                        static_cast<const int8_t*>(wv)};
  const float* sw[3] = {static_cast<const float*>(sq), static_cast<const float*>(sk),
                        static_cast<const float*>(sv)};
  const float* b[3] = {static_cast<const float*>(bq), static_cast<const float*>(bk),
                       static_cast<const float*>(bv)};
  void* out[3] = {q, k, v};
  auto ls = static_cast<const float*>(ln_s);
  auto lb = static_cast<const float*>(ln_b);
  auto xi = static_cast<int8_t*>(xq);
  auto xs = static_cast<float*>(sx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? ln_qkv<__nv_bfloat16>(x, ls, lb, eps, xi, xs, w, sw, b, out, M, d, sms, st)
      : ln_qkv<float>(x, ls, lb, eps, xi, xs, w, sw, b, out, M, d, sms, st);
  return static_cast<int>(err);
}

// out [M, d] = res + cast(int8(attn) . wo * sx * so + bo).
extern "C" int vidi_o_residual(const void* attn, const void* res, void* xq, void* sx,
                               const void* wo, const void* so, const void* bo, void* out,
                               int M, int d, int is_bf16, int sms, void* stream) {
  auto xi = static_cast<int8_t*>(xq);
  auto xs = static_cast<float*>(sx);
  auto w = static_cast<const int8_t*>(wo);
  auto s = static_cast<const float*>(so);
  auto b = static_cast<const float*>(bo);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? o_residual<__nv_bfloat16>(attn, res, xi, xs, w, s, b, out, M, d, sms, st)
      : o_residual<float>(attn, res, xi, xs, w, s, b, out, M, d, sms, st);
  return static_cast<int>(err);
}

// out [M, d] = x + cast(int8(act(cast(int8(LN2(x)) . w1 ...))) . w2 ...);
// hidden [M, ff] T, hq [M, ff] int8, hsx [M] and xq / sx are scratch.
extern "C" int vidi_ln_ffn(const void* x, const void* ln_s, const void* ln_b, void* xq,
                           void* sx, const void* w1, const void* s1, const void* b1,
                           void* hidden, void* hq, void* hsx, const void* w2, const void* s2,
                           const void* b2, void* out, int M, int d, int ff, int act,
                           int is_bf16, float eps, int sms, void* stream) {
  auto ls = static_cast<const float*>(ln_s);
  auto lb = static_cast<const float*>(ln_b);
  auto xi = static_cast<int8_t*>(xq);
  auto xs = static_cast<float*>(sx);
  auto w1i = static_cast<const int8_t*>(w1);
  auto w2i = static_cast<const int8_t*>(w2);
  auto s1f = static_cast<const float*>(s1);
  auto s2f = static_cast<const float*>(s2);
  auto b1f = static_cast<const float*>(b1);
  auto b2f = static_cast<const float*>(b2);
  auto hi = static_cast<int8_t*>(hq);
  auto hs = static_cast<float*>(hsx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? ln_ffn<__nv_bfloat16>(x, ls, lb, eps, xi, xs, w1i, s1f, b1f, hidden, hi, hs, w2i,
                              s2f, b2f, out, M, d, ff, act, sms, st)
      : ln_ffn<float>(x, ls, lb, eps, xi, xs, w1i, s1f, b1f, hidden, hi, hs, w2i, s2f, b2f,
                      out, M, d, ff, act, sms, st);
  return static_cast<int>(err);
}
