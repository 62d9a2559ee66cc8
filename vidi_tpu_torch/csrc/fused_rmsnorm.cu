// K7: RMSNorm with fp32 statistics, y = x * rsqrt(mean(x^2) + eps) * (w [+ 1]).
//
// Replaces the Pallas kernel of vidi_tpu/ops/pallas/fused_rmsnorm.py
// (`fused_rms_norm`). Nothing on a path of either package calls it: the JAX
// package's models use the jnp norm, and the port's use ops/norms.py.
//
// What bounds it on an H100: 3 operations per element against 4 bytes of
// bf16 read and written, so device memory (3.35 TB/s). The TPU kernel
// took 256-row blocks; here one block of 256 threads takes one row, reads
// it twice (the second read from L2: a 3584-wide bf16 row is 7 KB) and
// writes it once, with a two-level shuffle reduction for the sum of squares.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ float load(const T* p, long long i);
template <> __device__ __forceinline__ float load<float>(const float* p, long long i) {
  return p[i];
}
template <> __device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                 long long i) {
  return __bfloat162float(p[i]);
}
template <typename T> __device__ __forceinline__ void store(T* p, long long i, float v);
template <> __device__ __forceinline__ void store<float>(float* p, long long i, float v) {
  p[i] = v;
}
template <> __device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p, long long i,
                                                                 float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T, typename W>
__global__ void __launch_bounds__(THREADS) rms_norm_kernel(const T* __restrict__ x,
                                                           const W* __restrict__ w,
                                                           T* __restrict__ out, int D,
                                                           int plus_one, float eps) {
  __shared__ float red[THREADS / 32];
  const long long base = static_cast<long long>(blockIdx.x) * D;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    const float v = load<T>(x, base + i);
    ss += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.0f;
  for (int i = 0; i < THREADS / 32; ++i) total += red[i];
  const float r = 1.0f / sqrtf(total / static_cast<float>(D) + eps);
  for (int i = threadIdx.x; i < D; i += THREADS) {
    float wi = load<W>(w, i);
    if (plus_one) wi += 1.0f;
    store<T>(out, base + i, load<T>(x, base + i) * r * wi);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int M, int D, int w_bf16,
                   int plus_one, float eps, cudaStream_t s) {
  auto xt = static_cast<const T*>(x);
  auto ot = static_cast<T*>(out);
  if (w_bf16)
    rms_norm_kernel<T, __nv_bfloat16><<<M, THREADS, 0, s>>>(
        xt, static_cast<const __nv_bfloat16*>(w), ot, D, plus_one, eps);
  else
    rms_norm_kernel<T, float><<<M, THREADS, 0, s>>>(xt, static_cast<const float*>(w), ot, D,
                                                    plus_one, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out [M, D] (bf16 or fp32, contiguous), w [D] (bf16 or fp32).
extern "C" int vidi_rms_norm(const void* x, const void* w, void* out, int M, int D,
                             int x_bf16, int w_bf16, int plus_one, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_bf16 ? launch<__nv_bfloat16>(x, w, out, M, D, w_bf16, plus_one, eps, s)
                           : launch<float>(x, w, out, M, D, w_bf16, plus_one, eps, s);
  return static_cast<int>(err);
}
