// K4: flash attention backward for the Dattn decoder.
//
// Replaces the Pallas backward of vidi_tpu/ops/pallas/flash_attention.py
// (`_bwd_rule`: `_dq_kernel` and `_dkv_kernel`). Given q [B,T,Hq,D], k/v
// [B,S,Hk,D] (strided, last dim contiguous), the upstream gradient dO
// [B,T,Hq,D], the forward's lse [B,Hq,T] and di = sum(o * dO) [B,Hq,T] (one
// reduction in the wrapper, as JAX computes it outside Pallas), it
// recomputes p = exp(z - lse) tile by tile and returns
//   dv = p^T dO,  dz = p (dO v^T - di) (1 - tanh^2 under the softcap),
//   dq = dz k * scale,  dk = dz^T q * scale,
// with the forward's masks (kv_mask, causal and sliding window by absolute
// index, packing segment ids) zeroing p and dz. Rows with no visible key
// carry the sentinel lse, so every p of theirs is zero.
//
// Two routes, chosen by dtype in ops/cuda/flash_attention_bwd.py:
// - bf16: `vidi_flash_attention_bwd_sm90`, the two Hopper kernels of
//   flash_backward_sm90.cuh (wgmma products fed by TMA; p and dz rounded to
//   bf16 as the operands of the gradient products, as the sm90 forward
//   rounds P).
// - fp32: `vidi_flash_attention_bwd`, the SIMT template below, for the fp32
//   checks that hold the card against the CPU at 1e-4 and finer. Every
//   product and sum is fp32 and p is not rounded. It is bound by its fp32
//   FMAs (~13.6 TFLOP/s on an H100) and serves no bf16 path:
//   - dq: one block per (b, q head, 16-row tile) walks the visible KV tiles
//     (the loop takes the place of the TPU grid's "arbitrary" S axis); the
//     wrapper splits S across blocks, each split writes an fp32 partial and
//     flash_bwd_dq_sum adds them;
//   - dk/dv: one block per (b, KV head, 32-key tile) walks the G query heads
//     of its group and the visible 16-row q tiles (the Pallas grid's (G, T)
//     axes), holding the 32 x D fp32 dk and dv sums in registers.
//   Both passes stage their tiles in dynamic shared memory. No atomics:
//   results do not vary from run to run on either route.
// Both routes are compiled for a few widths (sm90: 128, 256; SIMT: 64, 128,
// 256) and run at any head dim d up to the width with d % 8 == 0: columns
// past d are read as zeros and not stored.
#include "attention_common.cuh"
#include "flash_backward_sm90.cuh"

namespace vidi {

// dz of one (row, key) entry: p (dp - di) times the softcap derivative, or
// 0 for a masked entry. Writes p through `prob`.
__device__ __forceinline__ float grad_logit(float dot, float dp, float lse,
                                            float di, bool ok,
                                            const FlashBwdParams& p,
                                            float* prob) {
  *prob = 0.f;
  if (!ok) return 0.f;
  const float raw = dot * p.scale;
  float z = raw, dcap = 1.f;
  if (p.softcap > 0.f) {
    const float th = tanhf(raw / p.softcap);
    z = th * p.softcap;
    dcap = 1.f - th * th;
  }
  const float pr = expf(z - lse);
  *prob = pr;
  return pr * (dp - di) * dcap;
}

__device__ __forceinline__ bool visible(const FlashBwdParams& p, int t, int key,
                                        int qseg, int kseg) {
  bool ok = t < p.T;
  if (p.causal) ok = ok && key <= t;
  if (p.window > 0) ok = ok && (t - key) < p.window;
  if (p.q_segs != nullptr) ok = ok && qseg == kseg;
  return ok;
}

// ---------------------------------------------------------------------------
// dq pass
// ---------------------------------------------------------------------------

template <typename T, int D, int BQ, int BK>
struct DqSmem {
  static constexpr int KS = D + 2;   // K/V row stride (see FlashSmem)
  static constexpr int PS = BK + 1;  // dz row stride
  static constexpr size_t q_off = 0;                                         // float [BQ][D]
  static constexpr size_t do_off = align16(q_off + sizeof(float) * BQ * D);  // float [BQ][D]
  static constexpr size_t k_off = align16(do_off + sizeof(float) * BQ * D);  // T [BK][KS]
  static constexpr size_t v_off = align16(k_off + sizeof(T) * BK * KS);
  static constexpr size_t dz_off = align16(v_off + sizeof(T) * BK * KS);    // float [BQ][PS]
  static constexpr size_t lse_off = align16(dz_off + sizeof(float) * BQ * PS);
  static constexpr size_t di_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t qseg_off = di_off + sizeof(float) * BQ;           // int [BQ]
  static constexpr size_t kok_off = qseg_off + sizeof(int) * BQ;            // int [BK]
  static constexpr size_t kseg_off = kok_off + sizeof(int) * BK;            // int [BK]
  static constexpr size_t bytes = align16(kseg_off + sizeof(int) * BK);
};

// Thread maps (NT threads), as in flash_forward:
//   scores: key j = tid % BK, rows tid / BK + i * (NT / BK); q . k and
//           dO . v share the K / V pair loads, Q / dO reads are broadcasts;
//   dq:     column pair c = tid % (D/2), rows tid / (D/2) + i * RG.
template <typename T, int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT) flash_bwd_dq(FlashBwdParams p) {
  static_assert(D % 2 == 0 && NT % BK == 0 && BQ % (NT / BK) == 0, "score map");
  using L = DqSmem<T, D, BQ, BK>;
  constexpr int NPAIR = D / 2;
  static_assert(NT >= NPAIR, "dq map needs a thread per column pair");
  constexpr int RG = NT / NPAIR;
  constexpr int NR = (BQ + RG - 1) / RG;
  constexpr int NS = BQ * BK / NT;
  constexpr int SR = NT / BK;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q_off);
  float* sDO = reinterpret_cast<float*>(smem + L::do_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sDZ = reinterpret_cast<float*>(smem + L::dz_off);
  float* sLse = reinterpret_cast<float*>(smem + L::lse_off);
  float* sDi = reinterpret_cast<float*>(smem + L::di_off);
  int* sQseg = reinterpret_cast<int*>(smem + L::qseg_off);
  int* sKok = reinterpret_cast<int*>(smem + L::kok_off);
  int* sKseg = reinterpret_cast<int*>(smem + L::kseg_off);

  const int tid = threadIdx.x;
  const int b = blockIdx.z / p.n_split, split = blockIdx.z % p.n_split;
  const int h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (p.Hq / p.Hk);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long do_st = (long long)p.Hq * p.d;
  const T* dout = static_cast<const T*>(p.dout) + ((long long)b * p.T * p.Hq + h) * p.d;

  for (int e = tid; e < BQ * NPAIR; e += NT) {
    const int r = e / NPAIR, c = 2 * (e % NPAIR), t = q0 + r;
    const bool in = t < p.T && c < p.d;
    const float2 x = in ? load2(q + t * p.q_st + c) : make_float2(0.f, 0.f);
    const float2 y = in ? load2(dout + t * do_st + c) : make_float2(0.f, 0.f);
    store2(sQ + r * D + c, x.x, x.y);
    store2(sDO + r * D + c, y.x, y.y);
  }
  for (int r = tid; r < BQ; r += NT) {
    const int t = q0 + r;
    const bool in = t < p.T;
    const long long row = ((long long)b * p.Hq + h) * p.T + t;
    sLse[r] = in ? p.lse[row] : kEmptyRowLse;
    sDi[r] = in ? p.di[row] : 0.f;
    sQseg[r] = (p.q_segs != nullptr && in) ? p.q_segs[b * p.T + t] : 0;
  }

  int kv_begin = split * p.kv_split, kv_end = min(p.S, kv_begin + p.kv_split);
  if (p.causal) kv_end = min(kv_end, q0 + BQ);
  if (p.window > 0) kv_begin = max(kv_begin, q0 - p.window + 1);

  float2 acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = make_float2(0.f, 0.f);
  const int pc = 2 * (tid % NPAIR), pr0 = tid / NPAIR;
  const bool p_on = tid < RG * NPAIR;
  const int sc_j = tid % BK, sc_r0 = tid / BK;

  for (int s0 = kv_begin; s0 < kv_end; s0 += BK) {
    __syncthreads();  // the previous tile's K / dz are no longer read
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
    for (int j = tid; j < BK; j += NT) {
      const int key = s0 + j;
      int ok = key < kv_end;
      if (ok && p.kv_mask != nullptr) ok = p.kv_mask[b * p.S + key] != 0;
      sKok[j] = ok;
      sKseg[j] = (ok && p.kv_segs != nullptr) ? p.kv_segs[b * p.S + key] : 0;
    }
    __syncthreads();

    float sc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
    const T* krow = sK + sc_j * L::KS;
    const T* vrow = sV + sc_j * L::KS;
#pragma unroll 4
    for (int c = 0; c < D; c += 2) {
      const float2 kk = load2(krow + c);
      const float2 vv = load2(vrow + c);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = sc_r0 + i * SR;
        const float2 qq = load2(sQ + r * D + c);
        const float2 dd = load2(sDO + r * D + c);
        sc[i] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, sc[i]));
        dp[i] = fmaf(dd.x, vv.x, fmaf(dd.y, vv.y, dp[i]));
      }
    }
    {
      const int key = s0 + sc_j;
      const int kok = sKok[sc_j], kseg = sKseg[sc_j];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = sc_r0 + i * SR;
        const bool ok = kok && visible(p, q0 + r, key, sQseg[r], kseg);
        float prob;
        const float dz = grad_logit(sc[i], dp[i], sLse[r], sDi[r], ok, p, &prob);
        sDZ[r * L::PS + sc_j] = dz * p.scale;
      }
    }
    __syncthreads();

    // dq += dz @ K (scale folded into dz)
    if (p_on) {
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float2 kk = load2(sK + j * L::KS + pc);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int r = pr0 + i * RG;
          if (r < BQ) {
            const float g = sDZ[r * L::PS + j];
            acc[i].x = fmaf(g, kk.x, acc[i].x);
            acc[i].y = fmaf(g, kk.y, acc[i].y);
          }
        }
      }
    }
  }

  if (!p_on || pc >= p.d) return;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = pr0 + i * RG, t = q0 + r;
    if (r < BQ && t < p.T) {
      const long long row = ((long long)b * p.T + t) * p.Hq + h;
      if (p.n_split > 1) {
        const long long part = (long long)split * p.B * p.T * p.Hq + row;
        store2(p.dq_part + part * D + pc, acc[i].x, acc[i].y);
      } else {
        store2(static_cast<T*>(p.dq) + row * p.d + pc, acc[i].x, acc[i].y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv pass
// ---------------------------------------------------------------------------

template <typename T, int D, int BQ, int BKV>
struct DkvSmem {
  static constexpr int KS = D + 2;
  static constexpr int PS = BKV + 1;
  static constexpr size_t k_off = 0;                                          // T [BKV][KS]
  static constexpr size_t v_off = align16(k_off + sizeof(T) * BKV * KS);
  static constexpr size_t q_off = align16(v_off + sizeof(T) * BKV * KS);     // float [BQ][D]
  static constexpr size_t do_off = align16(q_off + sizeof(float) * BQ * D);  // float [BQ][D]
  static constexpr size_t p_off = align16(do_off + sizeof(float) * BQ * D);  // float [BQ][PS]
  static constexpr size_t dz_off = align16(p_off + sizeof(float) * BQ * PS); // float [BQ][PS]
  static constexpr size_t lse_off = align16(dz_off + sizeof(float) * BQ * PS);
  static constexpr size_t di_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t qseg_off = di_off + sizeof(float) * BQ;            // int [BQ]
  static constexpr size_t kok_off = qseg_off + sizeof(int) * BQ;             // int [BKV]
  static constexpr size_t kseg_off = kok_off + sizeof(int) * BKV;            // int [BKV]
  static constexpr size_t bytes = align16(kseg_off + sizeof(int) * BKV);
};

// Thread maps (NT threads):
//   scores: key j = tid % BKV, rows tid / BKV + i * (NT / BKV);
//   dk/dv:  column pair c = tid % (D/2), keys tid / (D/2) + i * RG; the p
//           and dz reads are broadcasts within a warp.
template <typename T, int D, int BQ, int BKV, int NT>
__global__ void __launch_bounds__(NT) flash_bwd_dkv(FlashBwdParams p) {
  static_assert(D % 2 == 0 && NT % BKV == 0 && BQ % (NT / BKV) == 0, "score map");
  using L = DkvSmem<T, D, BQ, BKV>;
  constexpr int NPAIR = D / 2;
  static_assert(NT % NPAIR == 0 && BKV % (NT / NPAIR) == 0, "dk/dv map");
  constexpr int RG = NT / NPAIR;
  constexpr int NJ = BKV / RG;
  constexpr int NS = BQ * BKV / NT;
  constexpr int SR = NT / BKV;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sQ = reinterpret_cast<float*>(smem + L::q_off);
  float* sDO = reinterpret_cast<float*>(smem + L::do_off);
  float* sP = reinterpret_cast<float*>(smem + L::p_off);
  float* sDZ = reinterpret_cast<float*>(smem + L::dz_off);
  float* sLse = reinterpret_cast<float*>(smem + L::lse_off);
  float* sDi = reinterpret_cast<float*>(smem + L::di_off);
  int* sQseg = reinterpret_cast<int*>(smem + L::qseg_off);
  int* sKok = reinterpret_cast<int*>(smem + L::kok_off);
  int* sKseg = reinterpret_cast<int*>(smem + L::kseg_off);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hk;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int e = tid; e < BKV * NPAIR; e += NT) {
    const int j = e / NPAIR, c = 2 * (e % NPAIR), key = k0 + j;
    if (key < p.S && c < p.d) {
      copy2(sK + j * L::KS + c, k + key * p.k_ss + c);
      copy2(sV + j * L::KS + c, v + key * p.v_ss + c);
    } else {
      zero2(sK + j * L::KS + c);
      zero2(sV + j * L::KS + c);
    }
  }
  for (int j = tid; j < BKV; j += NT) {
    const int key = k0 + j;
    int ok = key < p.S;
    if (ok && p.kv_mask != nullptr) ok = p.kv_mask[b * p.S + key] != 0;
    sKok[j] = ok;
    sKseg[j] = (ok && p.kv_segs != nullptr) ? p.kv_segs[b * p.S + key] : 0;
  }

  // rows that can see a key of this tile: t >= k0 when causal, and
  // t <= last key + window - 1 under a window
  const int k_last = min(k0 + BKV, p.S) - 1;
  const int t_lo = p.causal ? k0 : 0;
  const int t_hi = p.window > 0 ? min(p.T, k_last + p.window) : p.T;

  float2 dk[NJ], dv[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) dk[i] = dv[i] = make_float2(0.f, 0.f);
  const int ac = 2 * (tid % NPAIR), aj0 = tid / NPAIR;
  const int sc_j = tid % BKV, sc_r0 = tid / BKV;
  const long long do_st = (long long)p.Hq * p.d;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + ((long long)b * p.T * p.Hq + h) * p.d;
    const long long row0 = ((long long)b * p.Hq + h) * p.T;
    for (int t0 = t_lo; t0 < t_hi; t0 += BQ) {
      __syncthreads();  // the previous tile's Q / dO / p / dz are no longer read
      for (int e = tid; e < BQ * NPAIR; e += NT) {
        const int r = e / NPAIR, c = 2 * (e % NPAIR), t = t0 + r;
        const bool in = t < p.T && c < p.d;
        const float2 x = in ? load2(q + t * p.q_st + c) : make_float2(0.f, 0.f);
        const float2 y = in ? load2(dout + t * do_st + c) : make_float2(0.f, 0.f);
        store2(sQ + r * D + c, x.x, x.y);
        store2(sDO + r * D + c, y.x, y.y);
      }
      for (int r = tid; r < BQ; r += NT) {
        const int t = t0 + r;
        const bool in = t < p.T;
        sLse[r] = in ? p.lse[row0 + t] : kEmptyRowLse;
        sDi[r] = in ? p.di[row0 + t] : 0.f;
        sQseg[r] = (p.q_segs != nullptr && in) ? p.q_segs[b * p.T + t] : 0;
      }
      __syncthreads();

      float sc[NS], dp[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
      const T* krow = sK + sc_j * L::KS;
      const T* vrow = sV + sc_j * L::KS;
#pragma unroll 4
      for (int c = 0; c < D; c += 2) {
        const float2 kk = load2(krow + c);
        const float2 vv = load2(vrow + c);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int r = sc_r0 + i * SR;
          const float2 qq = load2(sQ + r * D + c);
          const float2 dd = load2(sDO + r * D + c);
          sc[i] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, sc[i]));
          dp[i] = fmaf(dd.x, vv.x, fmaf(dd.y, vv.y, dp[i]));
        }
      }
      {
        const int key = k0 + sc_j;
        const int kok = sKok[sc_j], kseg = sKseg[sc_j];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int r = sc_r0 + i * SR;
          const bool ok = kok && visible(p, t0 + r, key, sQseg[r], kseg);
          float prob;
          const float dz = grad_logit(sc[i], dp[i], sLse[r], sDi[r], ok, p, &prob);
          sP[r * L::PS + sc_j] = prob;
          sDZ[r * L::PS + sc_j] = dz * p.scale;
        }
      }
      __syncthreads();

      // dv += p^T dO, dk += dz^T Q (scale folded into dz)
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        const float2 qq = load2(sQ + r * D + ac);
        const float2 dd = load2(sDO + r * D + ac);
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          const int j = aj0 + i * RG;
          const float pv = sP[r * L::PS + j], gz = sDZ[r * L::PS + j];
          dv[i].x = fmaf(pv, dd.x, dv[i].x);
          dv[i].y = fmaf(pv, dd.y, dv[i].y);
          dk[i].x = fmaf(gz, qq.x, dk[i].x);
          dk[i].y = fmaf(gz, qq.y, dk[i].y);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const int key = k0 + aj0 + i * RG;
    if (key < p.S && ac < p.d) {
      const long long row = ((long long)b * p.S + key) * p.Hk + hk;
      store2(static_cast<T*>(p.dk) + row * p.d + ac, dk[i].x, dk[i].y);
      store2(static_cast<T*>(p.dv) + row * p.d + ac, dv[i].x, dv[i].y);
    }
  }
}

// The two passes (and the dq merge when S is split) on `stream`; the
// dynamic shared-memory cap is raised once per instantiation.
template <typename T, int D>
cudaError_t launch_flash_backward(const FlashBwdParams& p, cudaStream_t stream) {
  constexpr int BQ = 16, BK = 64, NTQ = 128;   // dq: the forward's tiles
  constexpr int BKV = 32, NTK = 256;           // dk/dv: 32 keys, 64 fp32 sums a thread
  using Lq = DqSmem<T, D, BQ, BK>;
  using Lk = DkvSmem<T, D, BQ, BKV>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq<T, D, BQ, BK, NTQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lq::bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        flash_bwd_dkv<T, D, BQ, BKV, NTK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lk::bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (p.n_split < 1 || (long long)p.B * p.n_split > 65535 || p.Hq > 65535 || p.d < 8 ||
      p.d > D || p.d % 8)
    return cudaErrorInvalidValue;
  if (p.n_split > 1 && p.dq_part == nullptr) return cudaErrorInvalidValue;
  dim3 gq((p.T + BQ - 1) / BQ, p.Hq, p.B * p.n_split);
  flash_bwd_dq<T, D, BQ, BK, NTQ><<<gq, NTQ, Lq::bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.n_split > 1) {
    flash_bwd_dq_sum<T, D><<<(unsigned)((long long)p.B * p.T * p.Hq), D / 2, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dim3 gk((p.S + BKV - 1) / BKV, p.Hk, p.B);
  flash_bwd_dkv<T, D, BQ, BKV, NTK><<<gk, NTK, Lk::bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace vidi

namespace {

vidi::FlashBwdParams bwd_params(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* di, const int* q_segs,
                                const int* kv_segs, void* dq, float* dq_part, void* dk, void* dv,
                                int B, int T, int S, int Hq, int Hk, int d, long long q_sb,
                                long long q_st, long long q_sh, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                float scale, int causal, int window, float softcap, int n_split,
                                int kv_split) {
  vidi::FlashBwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.di = di;
  p.q_segs = q_segs; p.kv_segs = kv_segs;
  p.dq = dq; p.dq_part = dq_part; p.dk = dk; p.dv = dv;
  p.B = B; p.T = T; p.S = S; p.Hq = Hq; p.Hk = Hk; p.d = d;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = scale; p.causal = causal; p.window = window; p.softcap = softcap;
  p.n_split = n_split; p.kv_split = kv_split;
  return p;
}

}  // namespace

// Both entries take the head dim d and the compiled width W >= d the
// wrapper chose for it (ops/cuda/flash_attention_bwd.py, `WIDTHS`).

// fp32 operands: the SIMT template; dO contiguous.
extern "C" int vidi_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, const int* kv_mask, const int* q_segs,
    const int* kv_segs, void* dq, float* dq_part, void* dk, void* dv,
    int B, int T, int S, int Hq, int Hk, int W, int d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal, int window, float softcap,
    int n_split, int kv_split, void* stream) {
  vidi::FlashBwdParams p = bwd_params(q, k, v, dout, lse, di, q_segs, kv_segs, dq, dq_part, dk,
                                      dv, B, T, S, Hq, Hk, d, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                                      v_sb, v_ss, v_sh, scale, causal, window, softcap, n_split,
                                      kv_split);
  p.kv_mask = kv_mask;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64: return static_cast<int>(vidi::launch_flash_backward<float, 64>(p, s));
    case 128: return static_cast<int>(vidi::launch_flash_backward<float, 128>(p, s));
    case 256: return static_cast<int>(vidi::launch_flash_backward<float, 256>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 operands: the Hopper kernels; kv_mask as bool bytes, dO strided.
extern "C" int vidi_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, const unsigned char* kv_mask, const int* q_segs,
    const int* kv_segs, void* dq, float* dq_part, void* dk, void* dv,
    int B, int T, int S, int Hq, int Hk, int W, int d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_st, long long do_sh,
    float scale, int causal, int window, float softcap,
    int n_split, int kv_split, void* stream) {
  vidi::FlashBwdParams p = bwd_params(q, k, v, dout, lse, di, q_segs, kv_segs, dq, dq_part, dk,
                                      dv, B, T, S, Hq, Hk, d, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                                      v_sb, v_ss, v_sh, scale, causal, window, softcap, n_split,
                                      kv_split);
  p.kv_bytes = kv_mask;
  p.do_sb = do_sb; p.do_st = do_st; p.do_sh = do_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 128: return static_cast<int>(vidi::sm90bwd::launch_backward<128>(p, s));
    case 256: return static_cast<int>(vidi::sm90bwd::launch_backward<256>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
