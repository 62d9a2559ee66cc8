// 16-byte vectors of activations to and from fp32 registers: 4 fp32 or 8
// bf16 values a load or store, unpacked with bit operations so the vector
// never takes an address (and so never leaves the registers). The array's
// length picks the element type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vidi {

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {  // round to nearest even
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16;
}

__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[4]) {  // fp32
  out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[8]) {  // bf16
  out[0] = bf16_lo(raw.x); out[1] = bf16_hi(raw.x); out[2] = bf16_lo(raw.y);
  out[3] = bf16_hi(raw.y); out[4] = bf16_lo(raw.z); out[5] = bf16_hi(raw.z);
  out[6] = bf16_lo(raw.w); out[7] = bf16_hi(raw.w);
}
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {  // fp32
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&v)[8]) {  // bf16
  return make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]),
                    bf16_pair(v[6], v[7]));
}

}  // namespace vidi
