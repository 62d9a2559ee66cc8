// K7: RMSNorm with fp32 statistics, y = x * rsqrt(mean(x^2) + eps) * (w [+ 1]).
//
// Replaces the Pallas kernel of vidi_tpu/ops/pallas/fused_rmsnorm.py
// (`fused_rms_norm`). Nothing on a path of either package calls it: the JAX
// package's models use the jnp norm, and the port's use ops/norms.py.
//
// What bounds it on an H100: 3 operations per element against 4 bytes of
// bf16 read and written, so device memory (3.35 TB/s): the least it can do
// is read each row once and write it once. The TPU kernel took 256-row
// blocks. Here one warp takes one row (four rows a block; one, when there
// are too few rows to fill the card): each lane loads its share of the row
// as 16-byte vectors (8 bf16 or 4 fp32), all of them in flight at once, and
// keeps them in registers between the sum of squares (warp shuffles, no
// shared memory, no block barrier) and the scale, so the row crosses device
// memory once each way; the weight is read as vectors too, and the store is
// 16 bytes a lane. Per element the arithmetic is the scalar pass's: x * r *
// w in fp32. Rows that are not 16-byte aligned (D % 8 != 0 in bf16), or
// longer than the 128 values a lane holds (D > 4096), take the scalar pass:
// a block a row, the row read twice.
#include "vec16.cuh"

namespace {

constexpr int THREADS = 256;      // scalar pass: one block a row
constexpr int VEC_THREADS = 128;  // vector pass: one warp a row, four rows a block
constexpr int MAX_LANE_VALUES = 128;  // values of its row a lane holds in registers
constexpr int SPREAD_ROWS = 1024;     // fewer rows than this: one warp a block

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

// The V weights beside a 16-byte vector of x, as fp32: 16 bytes when W is
// x's type, 32 for fp32 weights beside 8 bf16 values, 8 for bf16 weights
// beside 4 fp32 values.
template <typename W, int V>
__device__ __forceinline__ void load_weights(const W* p, float (&out)[V]) {
  if constexpr (sizeof(W) * V == 16) {
    vidi::unpack16(*reinterpret_cast<const uint4*>(p), out);
  } else if constexpr (sizeof(W) * V == 32) {
    float lo[4], hi[4];
    vidi::unpack16(reinterpret_cast<const uint4*>(p)[0], lo);
    vidi::unpack16(reinterpret_cast<const uint4*>(p)[1], hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[e] = lo[e];
      out[4 + e] = hi[e];
    }
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    out[0] = vidi::bf16_lo(raw.x); out[1] = vidi::bf16_hi(raw.x);
    out[2] = vidi::bf16_lo(raw.y); out[3] = vidi::bf16_hi(raw.y);
  }
}

// One warp per row (blockDim.x / 32 rows a block), NPL values (NPL / V
// 16-byte vectors) per lane held in registers.
template <typename T, typename W, int NPL>
__global__ void __launch_bounds__(VEC_THREADS) rms_norm_vec_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out, int M, int D,
    int plus_one, float eps) {
  constexpr int V = 16 / sizeof(T), VPL = NPL / V;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const int lane = threadIdx.x % 32, nvec = D / V;
  const T* xr = x + (long long)row * D;
  float v[VPL][V];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int idx = lane + 32 * j;
    if (idx < nvec) {
      vidi::unpack16(*reinterpret_cast<const uint4*>(xr + idx * V), v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[j][e] = 0.0f;
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < VPL; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) ss += v[j][e] * v[j][e];
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
  T* orow = out + (long long)row * D;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int idx = lane + 32 * j;
    if (idx < nvec) {
      float wi[V], y[V];
      load_weights<W, V>(w + idx * V, wi);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (plus_one) wi[e] += 1.0f;
        y[e] = v[j][e] * r * wi[e];
      }
      *reinterpret_cast<uint4*>(orow + idx * V) = vidi::pack16(y);
    }
  }
}

// The scalar pass: any D, any alignment; one block per row, read twice.
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

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* out, int M, int D, int vec,
                   int plus_one, float eps, cudaStream_t s) {
  auto xt = static_cast<const T*>(x);
  auto wt = static_cast<const W*>(w);
  auto ot = static_cast<T*>(out);
  if (!vec) {
    rms_norm_kernel<T, W><<<M, THREADS, 0, s>>>(xt, wt, ot, D, plus_one, eps);
    return cudaGetLastError();
  }
  constexpr int V = 16 / sizeof(T);
  const int per_lane = (D / V + 31) / 32 * V;  // values a lane holds
  const auto misaligned = [](const void* p, size_t a) {
    return reinterpret_cast<uintptr_t>(p) % a != 0;
  };
  if (D % V || per_lane > MAX_LANE_VALUES || misaligned(x, 16) || misaligned(out, 16) ||
      misaligned(w, sizeof(W) * V < 16 ? sizeof(W) * V : 16))
    return cudaErrorInvalidValue;
  // few rows: one a block, so that they spread over the SMs
  const int threads = M < SPREAD_ROWS ? 32 : VEC_THREADS;
  const int blocks = (M + threads / 32 - 1) / (threads / 32);
  if (per_lane <= 32)
    rms_norm_vec_kernel<T, W, 32><<<blocks, threads, 0, s>>>(xt, wt, ot, M, D, plus_one, eps);
  else
    rms_norm_vec_kernel<T, W, MAX_LANE_VALUES>
        <<<blocks, threads, 0, s>>>(xt, wt, ot, M, D, plus_one, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out [M, D] (bf16 or fp32, contiguous), w [D] (bf16 or fp32). vec = 1
// takes the one-read vector pass (16-byte aligned rows of at most 128
// values a lane; refused otherwise), vec = 0 the scalar pass.
extern "C" int vidi_rms_norm(const void* x, const void* w, void* out, int M, int D,
                             int x_bf16, int w_bf16, int plus_one, int vec, float eps,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (x_bf16)
    err = w_bf16 ? launch<bf16, bf16>(x, w, out, M, D, vec, plus_one, eps, s)
                 : launch<bf16, float>(x, w, out, M, D, vec, plus_one, eps, s);
  else
    err = w_bf16 ? launch<float, bf16>(x, w, out, M, D, vec, plus_one, eps, s)
                 : launch<float, float>(x, w, out, M, D, vec, plus_one, eps, s);
  return static_cast<int>(err);
}
