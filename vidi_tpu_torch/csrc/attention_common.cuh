// Shared device code for the attention kernels of vidi_tpu_torch.
//
// `flash_forward` is the blocked online-softmax attention that K1
// (flash_attention.cu) and K2 (tower_attention.cu) launch for fp32 operands;
// each keeps its own C entry point. Plain SIMT arithmetic in fp32: tiles are
// staged in shared memory and every product is an FMA on the CUDA cores. As
// in the Pallas kernels, the unnormalised probabilities are rounded to the
// input dtype before P @ V and the row sums are kept in fp32. bf16 operands
// take the Hopper kernel of flash_forward_sm90.cuh, which reuses
// FlashParams and flash_combine from here. With packing segment ids both
// skip every key tile whose ids cannot meet the block's rows' (the rule of
// the Pallas kernel's `_seg_overlap`, see `mark_live_tiles` there).
//
// Head dims: a kernel is compiled for a width D and computes any head dim
// d <= D with d % 8 == 0 (`FlashParams::d`): the columns past d are read as
// zeros and never stored, so q . k and P V are those of the d columns. The
// partial states of a split S keep the compiled width (`part_acc` rows of
// D); q, k, v and out have rows of d.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace vidi {

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// copy one element pair without converting (global -> shared staging)
template <typename T>
__device__ __forceinline__ void copy2(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        *reinterpret_cast<const __nv_bfloat162*>(src);
  }
}
template <typename T>
__device__ __forceinline__ void zero2(T* dst) {
  store2(dst, 0.f, 0.f);
}
// x rounded to T's precision: the probabilities enter P @ V in v's dtype,
// as in the Pallas kernels (`p.astype(v.dtype)`); the row sum l stays fp32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 4) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16(x));
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// lse written for rows with no visible key (the Pallas kernel's -MASK_VALUE)
constexpr float kEmptyRowLse = 0.7f * FLT_MAX;

struct FlashParams {
  const void* q;        // [B, T, Hq, d] strided, last dim contiguous
  const void* k;        // [B, S, Hk, d] strided, last dim contiguous
  const void* v;
  const unsigned char* kv_mask;  // [B, S] bool bytes, contiguous, nullptr = all valid
  const int* q_segs;    // [B, T] contiguous, nullptr = no packing
  const int* kv_segs;   // [B, S]
  void* out;            // [B, T, Hq, d] contiguous
  float* lse;           // [B, Hq, T] contiguous, nullptr = not wanted
  int B, T, S, Hq, Hk;
  int d;                // head dim: at most the compiled width D, a multiple of 8
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal;
  int window;           // 0 = no sliding window
  float softcap;        // 0 = no softcap
  // Split of the KV axis across blocks (1 = none). With n_split > 1 each
  // block covers kv_split keys and writes its unnormalised partial state to
  // part_* ([B,Hq,T,n_split] and [B,Hq,T,n_split,D], D the compiled
  // width); flash_combine merges.
  int n_split;
  int kv_split;
  float* part_m;
  float* part_l;
  float* part_acc;
};

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Shared-memory layout of one block, in bytes.
template <typename T, int D, int BQ, int BK>
struct FlashSmem {
  static constexpr int KS = D + 2;   // K/V row stride: an odd word count, so
                                     // lanes reading one column of many rows
                                     // hit distinct banks
  static constexpr int PS = BK + 1;  // score row stride
  static constexpr size_t q_off = 0;                                     // float [BQ][D]
  static constexpr size_t k_off = align16(q_off + sizeof(float) * BQ * D);  // T [BK][KS]
  static constexpr size_t v_off = align16(k_off + sizeof(T) * BK * KS);
  static constexpr size_t p_off = align16(v_off + sizeof(T) * BK * KS);     // float [BQ][PS]
  static constexpr size_t m_off = align16(p_off + sizeof(float) * BQ * PS); // float [BQ]
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t a_off = l_off + sizeof(float) * BQ;
  static constexpr size_t qseg_off = a_off + sizeof(float) * BQ;            // int [BQ]
  static constexpr size_t kok_off = qseg_off + sizeof(int) * BQ;            // int [BK]
  static constexpr size_t kseg_off = kok_off + sizeof(int) * BK;            // int [BK]
  static constexpr size_t bytes = align16(kseg_off + sizeof(int) * BK);
};

// One block computes BQ query rows of one (batch, head) against every visible
// key, streaming K/V tiles of BK keys through shared memory with an online
// softmax (running max m, running sum l, unnormalised accumulator). The loop
// over KV tiles inside the block takes the place of the TPU grid's
// sequential ("arbitrary") KV axis.
//
// Thread maps (NT threads):
//   scores:  key j = tid % BK, rows tid / BK + i * (NT / BK)  -> one K pair
//            load per row-group of FMAs, Q reads are warp broadcasts;
//   P @ V:   column pair c = tid % (D/2), rows tid / (D/2) + i * RG -> one V
//            pair load per row-group of FMAs, P reads are broadcasts.
template <typename T, int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT) flash_forward(FlashParams p) {
  static_assert(D % 2 == 0, "head dim must be even");
  static_assert(NT % BK == 0 && BQ % (NT / BK) == 0, "score map");
  static_assert(BK % 32 == 0, "softmax map");
  using L = FlashSmem<T, D, BQ, BK>;
  constexpr int NPAIR = D / 2;
  constexpr int RG = NT / NPAIR > 0 ? NT / NPAIR : 1;  // row groups in P @ V
  static_assert(NT >= NPAIR, "P @ V map needs a thread per column pair");
  constexpr int NR = (BQ + RG - 1) / RG;               // rows per thread in P @ V
  constexpr int NS = BQ * BK / NT;                     // scores per thread
  constexpr int SR = NT / BK;                          // row step of the score map
  constexpr int NW = NT / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sP = reinterpret_cast<float*>(smem + L::p_off);
  float* sM = reinterpret_cast<float*>(smem + L::m_off);
  float* sL = reinterpret_cast<float*>(smem + L::l_off);
  float* sA = reinterpret_cast<float*>(smem + L::a_off);
  int* sQseg = reinterpret_cast<int*>(smem + L::qseg_off);
  int* sKok = reinterpret_cast<int*>(smem + L::kok_off);
  int* sKseg = reinterpret_cast<int*>(smem + L::kseg_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z / p.n_split, split = blockIdx.z % p.n_split;
  const int h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (p.Hq / p.Hk);  // GQA: query head h reads KV head h // g
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int e = tid; e < BQ * NPAIR; e += NT) {
    const int r = e / NPAIR, c = 2 * (e % NPAIR), t = q0 + r;
    float2 x = t < p.T && c < p.d ? load2(q + t * p.q_st + c) : make_float2(0.f, 0.f);
    store2(sQ + r * D + c, x.x, x.y);
  }
  for (int r = tid; r < BQ; r += NT) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
    const int t = q0 + r;
    sQseg[r] = (p.q_segs != nullptr && t < p.T) ? p.q_segs[b * p.T + t] : 0;
  }

  // KV range any row of this block can see: the causal bound and the
  // sliding-window bound skip whole tiles before any arithmetic.
  // With segment ids a tile is also skipped unless the [min, max] ranges
  // of the nonzero ids of the block's rows and of its unmasked keys meet,
  // or both hold padding (id 0): q_lo / q_hi / q_pad here, the keys' side
  // as three block-wide ORs per tile (k_lo <= q_hi, k_hi >= q_lo, a pad).
  int q_lo = 0x7fffffff, q_hi = -0x7fffffff;
  bool q_pad = false;
  if (p.q_segs != nullptr) {
    for (int t = q0; t < min(q0 + BQ, p.T); ++t) {
      const int sg = p.q_segs[(long long)b * p.T + t];
      q_pad = q_pad || sg == 0;
      if (sg != 0) {
        q_lo = min(q_lo, sg);
        q_hi = max(q_hi, sg);
      }
    }
  }
  int kv_begin = split * p.kv_split, kv_end = min(p.S, kv_begin + p.kv_split);
  if (p.causal) kv_end = min(kv_end, q0 + BQ);
  if (p.window > 0) kv_begin = max(kv_begin, q0 - p.window + 1);

  float2 acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = make_float2(0.f, 0.f);
  const int pv_c = 2 * (tid % NPAIR), pv_r0 = tid / NPAIR;
  const bool pv_on = tid < RG * NPAIR;
  const int sc_j = tid % BK, sc_r0 = tid / BK;

  for (int s0 = kv_begin; s0 < kv_end; s0 += BK) {
    __syncthreads();  // the previous tile's K/V/P are no longer read
    bool below = false, above = false, pad = false;  // this thread's keys
    for (int j = tid; j < BK; j += NT) {
      const int key = s0 + j;
      int ok = key < kv_end;
      if (ok && p.kv_mask != nullptr) ok = p.kv_mask[b * p.S + key] != 0;
      const int sg = (ok && p.kv_segs != nullptr) ? p.kv_segs[b * p.S + key] : 0;
      sKok[j] = ok;
      sKseg[j] = sg;
      pad = pad || (ok && sg == 0);
      below = below || (ok && sg != 0 && sg <= q_hi);
      above = above || (ok && sg != 0 && sg >= q_lo);
    }
    if (p.q_segs != nullptr) {  // the tile's segment test (uniform across the block)
      const int meet_lo = __syncthreads_or(below), meet_hi = __syncthreads_or(above);
      const int pads = __syncthreads_or(pad && q_pad);
      if (!((meet_lo && meet_hi) || pads)) continue;
    }
    for (int e = tid; e < BK * NPAIR; e += NT) {
      const int j = e / NPAIR, c = 2 * (e % NPAIR), key = s0 + j;
      if (key < p.S && c < p.d) {
        copy2(sK + j * L::KS + c, k + key * p.k_ss + c);
        copy2(sV + j * L::KS + c, v + key * p.v_ss + c);
      } else {
        zero2(sK + j * L::KS + c);
        zero2(sV + j * L::KS + c);
      }
    }
    __syncthreads();

    // scores = softcap(q . k * scale), masked to -inf
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    const T* krow = sK + sc_j * L::KS;
#pragma unroll 4
    for (int c = 0; c < D; c += 2) {
      const float2 kk = load2(krow + c);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float2 qq = load2(sQ + (sc_r0 + i * SR) * D + c);
        sc[i] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, sc[i]));
      }
    }
    {
      const int key = s0 + sc_j;
      const int kok = sKok[sc_j], kseg = sKseg[sc_j];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = sc_r0 + i * SR, t = q0 + r;
        float s = sc[i] * p.scale;
        if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
        bool ok = kok && t < p.T;
        if (p.causal) ok = ok && key <= t;
        if (p.window > 0) ok = ok && (t - key) < p.window;
        if (p.q_segs != nullptr) ok = ok && sQseg[r] == kseg;
        sP[r * L::PS + sc_j] = ok ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < BQ; r += NW) {
      float mt = -INFINITY;
      for (int j = lane; j < BK; j += 32) mt = fmaxf(mt, sP[r * L::PS + j]);
      mt = warp_max(mt);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mt);
      float alpha = 1.f, sum = 0.f;
      if (m_new == -INFINITY) {
        for (int j = lane; j < BK; j += 32) sP[r * L::PS + j] = 0.f;
      } else {
        alpha = expf(m_old - m_new);
        for (int j = lane; j < BK; j += 32) {
          const float s = sP[r * L::PS + j];
          const float e = s == -INFINITY ? 0.f : expf(s - m_new);
          sP[r * L::PS + j] = round_to<T>(e);
          sum += e;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
    if (pv_on) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = pv_r0 + i * RG;
        if (r < BQ) {
          const float a = sA[r];
          acc[i].x *= a;
          acc[i].y *= a;
        }
      }
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float2 vv = load2(sV + j * L::KS + pv_c);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int r = pv_r0 + i * RG;
          if (r < BQ) {
            const float pj = sP[r * L::PS + j];
            acc[i].x = fmaf(pj, vv.x, acc[i].x);
            acc[i].y = fmaf(pj, vv.y, acc[i].y);
          }
        }
      }
    }
  }
  __syncthreads();

  if (p.n_split > 1) {  // partial state for flash_combine
    const long long row0 = ((long long)b * p.Hq + h) * p.T;
    if (pv_on) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = pv_r0 + i * RG, t = q0 + r;
        if (r < BQ && t < p.T) {
          const long long row = (row0 + t) * p.n_split + split;
          store2(p.part_acc + row * D + pv_c, acc[i].x, acc[i].y);
        }
      }
    }
    for (int r = tid; r < BQ; r += NT) {
      const int t = q0 + r;
      if (t < p.T) {
        const long long row = (row0 + t) * p.n_split + split;
        p.part_m[row] = sM[r];
        p.part_l[row] = sL[r];
      }
    }
    return;
  }

  // out = acc / l; rows that saw no key get zeros (and the sentinel lse)
  T* out = static_cast<T*>(p.out);
  if (pv_on && pv_c < p.d) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = pv_r0 + i * RG, t = q0 + r;
      if (r < BQ && t < p.T) {
        const float l = sL[r];
        const float inv = l == 0.f ? 0.f : 1.f / l;
        store2(out + ((long long)(b * p.T + t) * p.Hq + h) * p.d + pv_c,
               acc[i].x * inv, acc[i].y * inv);
      }
    }
  }
  if (p.lse != nullptr) {
    for (int r = tid; r < BQ; r += NT) {
      const int t = q0 + r;
      if (t < p.T) {
        const float l = sL[r];
        p.lse[((long long)b * p.Hq + h) * p.T + t] =
            l == 0.f ? kEmptyRowLse : sM[r] + logf(l);
      }
    }
  }
}

// Merge of the n_split partial states of one query row (one block per
// (b, h, t), one thread per column pair of the compiled width D, those
// before d stored): out = sum acc_i e^(m_i - M) / sum l_i e^(m_i - M),
// lse = M + log(L); zeros / sentinel when L = 0.
template <typename T, int D>
__global__ void __launch_bounds__(D / 2) flash_combine(FlashParams p) {
  const long long row = blockIdx.x;  // (b * Hq + h) * T + t
  const int t = row % p.T, h = (row / p.T) % p.Hq, b = row / ((long long)p.T * p.Hq);
  const int c = 2 * threadIdx.x;
  const float* pm = p.part_m + row * p.n_split;
  const float* pl = p.part_l + row * p.n_split;
  float mx = -INFINITY;
  for (int i = 0; i < p.n_split; ++i) mx = fmaxf(mx, pm[i]);
  float lsum = 0.f, ax = 0.f, ay = 0.f;
  if (mx != -INFINITY) {
    for (int i = 0; i < p.n_split; ++i) {
      const float f = expf(pm[i] - mx);
      const float2 a = load2(p.part_acc + (row * p.n_split + i) * D + c);
      lsum += pl[i] * f;
      ax += a.x * f;
      ay += a.y * f;
    }
  }
  const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
  if (c < p.d)
    store2(static_cast<T*>(p.out) + ((long long)(b * p.T + t) * p.Hq + h) * p.d + c,
           ax * inv, ay * inv);
  if (threadIdx.x == 0 && p.lse != nullptr) {
    p.lse[row] = lsum == 0.f ? kEmptyRowLse : mx + logf(lsum);
  }
}

// Launch helper: raises the dynamic shared-memory cap once per instantiation
// (above 48 KB a kernel must opt in), launches on `stream`, and merges the
// KV splits when there are several.
template <typename T, int D, int BQ, int BK, int NT>
cudaError_t launch_flash_forward(const FlashParams& p, cudaStream_t stream) {
  using L = FlashSmem<T, D, BQ, BK>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_forward<T, D, BQ, BK, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (p.n_split < 1 || p.B * p.n_split > 65535 || p.d < 8 || p.d > D || p.d % 8)
    return cudaErrorInvalidValue;
  dim3 grid((p.T + BQ - 1) / BQ, p.Hq, p.B * p.n_split);
  flash_forward<T, D, BQ, BK, NT><<<grid, NT, L::bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  flash_combine<T, D><<<(unsigned)((long long)p.B * p.Hq * p.T), D / 2, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace vidi
