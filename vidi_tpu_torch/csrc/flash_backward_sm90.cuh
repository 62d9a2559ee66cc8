// K4's bf16 route for Hopper (sm_90a): the flash-attention backward as two
// kernels that mirror the TPU's two pallas_calls (`_dq_kernel` and
// `_dkv_kernel` of vidi_tpu/ops/pallas/flash_attention.py, reached from
// `_bwd_rule`). fp32 operands stay on the SIMT template of
// flash_attention_bwd.cu. Also here: the parameters both routes share and
// the pass that sums the dq partials of a split S.
//
// Function: given q / dO [B,T,Hq,D], k / v [B,S,Hk,D], the forward's lse
// [B,Hq,T] and di = sum(out * dO) [B,Hq,T], recompute p = exp(z - lse) and
//   dz = p (dO v^T - di) (1 - tanh^2 under the softcap),
//   dq = dz k * scale,  dk = dz^T q * scale,  dv = p^T dO,
// with the forward's masks (kv_mask, causal and window by absolute index,
// packing segment ids). Rows with no visible key carry the sentinel lse,
// rows past T are given lse = +inf here: their p is exactly 0.
//
// Numerics: q k^T and dO v^T are products of the bf16 operands with fp32
// sums, as on the TPU; p and dz are formed in fp32 and rounded to bf16 as
// the operands of the three gradient products (dz k, dz^T q, p^T dO), which
// accumulate in fp32, as the sm90 forward rounds P. The scale is applied to
// the fp32 sums. The softcap's tanh is `tanh_fast` (flash_forward_sm90.cuh,
// absolute error ~1e-7), used for the capped logit and its derivative.
// chip_smoke.py holds every output within 4 bf16 ulps of max|plain|.
//
// What bounds it on an H100: at the training slice's T2V shape (T = 256
// rows, S = 23,520 keys, D = 256, 16 / 8 heads) the five products of the
// visible pairs are 2.0e11 operations against ~100 MB of operands:
// bound by operations (0.20 ms at 989 TFLOP/s). The split into a dq kernel
// and a dk/dv kernel recomputes S and dP in both: seven products for five.
//
// Both kernels: 384 threads, warpgroups 0 and 1 consume, warpgroup 2
// produces. One producer warp stages a tile's masks in shared memory
// (kv_mask and the key-side segment ids in the dq kernel; lse, di and the
// query-side segment ids in the dk/dv kernel), decides whether the tile
// holds any visible pair and, if so, has one lane load its operands by TMA
// (128-byte swizzle) into an mbarrier ring; a tile with no visible pair is
// never loaded and the consumers skip it. The producer reads a tile's masks
// one tile ahead, so their global loads overlap the wait for a free stage.
// The producer keeps 40 registers (56 in the dk/dv kernel), the consumers
// get 232 (224) through setmaxnreg; the two roles' code paths never meet
// again after the split, or ptxas drops setmaxnreg.
//
// Per score the consumers compute p = exp2(c tanh(a x) - lse log2 e) and
// p (1 - tanh^2) with the constants folded once a block (`score_consts`):
// a division or a division by g per score cost the first version half its
// time (measured on the H100, PERF.md).
//
// dq kernel: one block takes 128 packed query rows of one (batch, KV head)
// (row r is query t0 + r / g of head hk * g + r % g, g = Hq / Hk, as the
// forward packs them), with Q and dO resident, and walks the keys of its
// split of S (the wrapper splits S so that one wave fills the card; each
// split writes an fp32 partial and flash_bwd_dq_sum adds them in a fixed
// order: no float atomics, bit-equal runs). Per key tile a consumer
// warpgroup runs S = Q K^T and dP = dO V^T on wgmma (both from shared
// memory), forms dz in registers, and accumulates dq += dz K with dz as the
// register A operand and the same K tile read MN-major as B. The two
// warpgroups take turns to issue S and dP (named barriers), so one's
// exponentials overlap the other's products. The splits take the key tiles
// in turn (split i: tiles i, i + n_split, ...), so a masked tail of S is
// shared. Key tiles are 32 keys at D = 256 (Q + dO take 128 KB; three
// stages of K + V 96 KB) and 64 at D = 128.
//
// dk/dv kernel: one block takes 64 keys of one (batch, KV head) with K and V
// resident and streams the g x T packed query rows of its group in tiles of
// 64 through the ring (Q, dO by TMA; lse, di and segment ids staged by the
// producer warp). A 64-key dk and dv at D = 256 would be 256 fp32 registers
// a thread, so the two consumer warpgroups split the work: each computes
// S^T = K Q^T and dP^T = V dO^T for 32 of the tile's 64 rows (keys along M),
// forms p and dz and writes them as bf16 into shared memory (128-byte
// swizzled, K-major), and after a barrier of the two accumulates its half
// of the head dim: dv[:, half] += P^T dO[:, half], dk[:, half] += dZ^T
// Q[:, half] (A from shared memory, B MN-major): 128 + 128 registers of
// sums become 64 + 64 a thread. Shared memory at D = 256: K + V 64 KB, two
// stages of Q + dO 128 KB, P and dZ 16 KB (D = 128: three stages). p is
// formed while dP^T is still in the tensor cores.
//
// Tile skips: the dq kernel clips its key range to the causal / window band
// of its rows (as the forward does), and skips a key tile whose keys are all
// masked or whose segment ids cannot meet its rows' (min / max overlap); the
// dk/dv kernel clips its rows to the band of its keys, skips a query tile
// whose segment ids cannot meet its keys', and writes zeros for a key tile
// with no unmasked key. ops/cuda/flash_attention_bwd.py mirrors the rules
// (`sm90_bwd_dq_tiles`, `sm90_bwd_dkv_tiles`) for the tests, which check
// them against visible_mask.
//
// Ragged edges: TMA fills rows past T or S with zeros. A zero key scores 0,
// not "absent", so keys past S (and masked keys) are tested out of every
// score; a zero K / V row would add dz . 0 to dq and land in no stored dk /
// dv row in any case. Rows past T are given lse = +inf (p = 0), and padded
// rows (dO = 0) get dz = p (0 - 0) = 0: exactly zero dq.
#pragma once

#include "attention_common.cuh"
#include "flash_forward_sm90.cuh"

namespace vidi {

struct FlashBwdParams {
  const void* q;        // [B, T, Hq, D] strided, last dim contiguous
  const void* k;        // [B, S, Hk, D] strided, last dim contiguous
  const void* v;
  const void* dout;     // [B, T, Hq, D]
  const float* lse;     // [B, Hq, T] contiguous
  const float* di;      // [B, Hq, T] contiguous
  const int* kv_mask;   // SIMT route: [B, S] int32, nullptr = all valid
  const unsigned char* kv_bytes;  // sm90 route: [B, S] bool bytes, nullptr = all valid
  const int* q_segs;    // [B, T] contiguous, nullptr = no packing
  const int* kv_segs;   // [B, S]
  void* dq;             // [B, T, Hq, D] contiguous
  float* dq_part;       // [n_split, B, T, Hq, D] fp32 when n_split > 1
  void* dk;             // [B, S, Hk, D] contiguous
  void* dv;
  int B, T, S, Hq, Hk;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_st, do_sh;  // sm90 route (the SIMT route reads dO contiguous)
  float scale;
  int causal;
  int window;           // 0 = no sliding window
  float softcap;        // 0 = no softcap
  int n_split;          // splits of the KV axis in the dq pass
  int kv_split;         // SIMT route: keys per split (the sm90 splits take tiles in turn)
};

// Sum of the n_split fp32 dq partials of one (b, t, h) row (one block per
// row, one thread per column pair), in split order, cast to the output dtype.
template <typename T, int D>
__global__ void __launch_bounds__(D / 2) flash_bwd_dq_sum(FlashBwdParams p) {
  const long long row = blockIdx.x;  // (b * T + t) * Hq + h
  const long long rows = (long long)p.B * p.T * p.Hq;
  const int c = 2 * threadIdx.x;
  float ax = 0.f, ay = 0.f;
  for (int i = 0; i < p.n_split; ++i) {
    const float2 a = load2(p.dq_part + (i * rows + row) * D + c);
    ax += a.x;
    ay += a.y;
  }
  store2(static_cast<T*>(p.dq) + row * D + c, ax, ay);
}

namespace sm90bwd {

using namespace sm90;

constexpr int kThreads = 384;     // two consumer warpgroups + the producer
constexpr int kQRows = 128;       // dq kernel: packed query rows per block
constexpr int kKeysKV = 64;       // dk/dv kernel: keys per block
constexpr int kRowsKV = 64;       // dk/dv kernel: packed query rows per streamed tile
// setmaxnreg of each kernel's roles (ptxas -v on sm_90a: no spill, but for
// 8 bytes in the dq kernel at D = 256). A block launches with 168 registers a thread
// (64,512 for 384 threads); the consumers' increase waits until the
// producer's decrease has freed enough, so 2 x 128 x consumer + 128 x
// producer must stay within 64,512, or setmaxnreg.inc never returns.
constexpr int kDqProducerRegs = 40, kDqConsumerRegs = 232;
constexpr int kDkvProducerRegs = 56, kDkvConsumerRegs = 224;

// Descriptors of 128-byte-swizzled tiles stored as 64-column chunks of
// `chunk` bytes each (rows of 128 bytes, 8-row atoms of 1024 bytes).
// K-major operand, depth step ks (16 columns):
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, uint32_t chunk, int ks) {
  return smem_desc(tile + (ks / 4) * chunk + (ks % 4) * 32, 16, 1024, true);
}
// MN-major B operand (rows along K, columns along N), row step kk (16 rows):
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, uint32_t chunk, int kk) {
  return smem_desc(tile + kk * 16 * 128, chunk, 1024, true);
}
// Barrier over the two consumer warpgroups (named barrier 1, 256 threads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// Makes this thread's shared-memory stores visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void warp_min_max(int& lo, int& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}
constexpr int kNoSeg = 0x7fffffff;  // empty min / max range: lo = kNoSeg, hi = -kNoSeg

// p of one score, and p times the softcap's derivative in `pd`: x is the
// q . k sum, ok says whether the key is visible from the row, l2 is the
// row's lse in log2 units (+inf: no gradient). dz is then pd (dp - di).
// The constants are folded once a block (`score_consts`): with a cap,
// a = scale / cap and c = cap log2(e), so z log2(e) = c tanh(a x); without,
// a = scale log2(e). No division per score.
template <bool kCap>
__device__ __forceinline__ float prob(float x, bool ok, float l2, float a, float c, float& pd) {
  float zl, dcap = 1.f;
  if constexpr (kCap) {
    const float th = tanh_fast(x * a);
    zl = c * th;
    dcap = 1.f - th * th;
  } else {
    zl = x * a;
  }
  const float pr = ok ? exp2f(zl - l2) : 0.f;
  pd = pr * dcap;
  return pr;
}
__device__ __forceinline__ float2 score_consts(const FlashBwdParams& p) {
  return p.softcap > 0.f ? make_float2(p.scale / p.softcap, p.softcap * kLog2e)
                         : make_float2(p.scale * kLog2e, 0.f);
}

// ---- dq kernel -----------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int kStages = 3;                  // ring depth
  static constexpr int kKeys = D == 256 ? 32 : 64;   // keys per tile
  static constexpr int kChunks = D / 64;
  static constexpr int kQChunk = kQRows * 128;       // one 64-column chunk of Q or dO
  static constexpr int kKVChunk = kKeys * 128;
  static constexpr int kKVTile = kChunks * kKVChunk;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kChunks * kQChunk;
  static constexpr int kK = kDO + kChunks * kQChunk;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kKok = kV + kStages * kKVTile;      // int [kStages][kKeys]
  static constexpr int kKseg = kKok + 4 * kStages * kKeys;  // int [kStages][kKeys]
  static constexpr int kLive = kKseg + 4 * kStages * kKeys; // int [kStages]
  static constexpr int kBar = kLive + 8 * kStages;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
  static constexpr uint32_t kQLoad = kQRows * D * 2;
  static constexpr uint32_t kKVLoad = kKeys * D * 2;
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
  static_assert(kK % 1024 == 0 && kKVTile % 1024 == 0, "swizzle atoms are 1024-byte aligned");
};

template <bool kCap, int N>
__device__ __forceinline__ void dq_scores(float (&sc)[N], const FlashBwdParams& p,
                                          const int* kok, const int* kseg, int s0, int quad,
                                          const int (&t_row)[2], const int (&q_seg)[2],
                                          const float (&l2)[2], float2 cst) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * n + 2 * quad + e, key = s0 + j;
      const bool key_ok = kok[j] != 0;
      const int k_seg = kseg[j];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bool ok = key_ok;
        if (p.causal) ok = ok && key <= t_row[i];
        if (p.window > 0) ok = ok && t_row[i] - key < p.window;
        if (p.q_segs != nullptr) ok = ok && q_seg[i] == k_seg;
        float& x = sc[4 * n + 2 * i + e];
        prob<kCap>(x, ok, l2[i], cst.x, cst.y, x);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_do,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const FlashBwdParams p) {
  using C = DqCfg<D>;
  constexpr int kSc = C::kKeys / 2;  // score registers per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + C::kQ, sDO = base + C::kDO, sK = base + C::kK, sV = base + C::kV;
  int* s_kok = reinterpret_cast<int*>(smem + C::kKok);
  int* s_kseg = reinterpret_cast<int*>(smem + C::kKseg);
  int* s_live = reinterpret_cast<int*>(smem + C::kLive);
  const uint32_t q_full = base + C::kBar;
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + C::kStages + s); };

  const int g = p.Hq / p.Hk, rows_t = kQRows / g;
  const int hk = blockIdx.y;
  const int b = blockIdx.z / p.n_split, split = blockIdx.z % p.n_split;
  const int t0 = blockIdx.x * rows_t;
  // keys any row of the block can see: the causal and window bounds clip
  // the range; each score is still tested against its own row. The range's
  // tiles are dealt to the splits in turn (split i takes tiles i, i +
  // n_split, ...), so that a masked tail of S spreads over all of them.
  int kv_begin = 0, kv_end = p.S;
  if (p.causal) kv_end = min(kv_end, min(p.T, t0 + rows_t));
  if (p.window > 0) kv_begin = max(kv_begin, t0 - p.window + 1);
  const int n_all = kv_end > kv_begin ? (kv_end - kv_begin + C::kKeys - 1) / C::kKeys : 0;
  const int n_tiles = n_all > split ? (n_all - split + p.n_split - 1) / p.n_split : 0;
  auto tile_key = [&](int it) { return kv_begin + (split + it * p.n_split) * C::kKeys; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), 128 * 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: warp 0 of warpgroup 2 ----
    setmaxnreg_dec<kDqProducerRegs>();
    if (tid < 256 + 32) {
      const int lane = tid % 32;
      int q_lo = kNoSeg, q_hi = -kNoSeg;  // segment ids of the block's rows
      if (p.q_segs != nullptr) {
        for (int i = lane; i < rows_t; i += 32) {
          const int t = t0 + i;
          if (t < p.T) {
            const int sg = p.q_segs[(long long)b * p.T + t];
            q_lo = min(q_lo, sg);
            q_hi = max(q_hi, sg);
          }
        }
        warp_min_max(q_lo, q_hi);
      }
      if (lane == 0 && n_tiles > 0) {
        mbar_expect_tx(q_full, 2 * C::kQLoad);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(sQ + c * C::kQChunk, &map_q, q_full, c * 64, hk * g, t0, b);
          tma_load(sDO + c * C::kQChunk, &map_do, q_full, c * 64, hk * g, t0, b);
        }
      }
      // each lane's keys of a tile (kPer of them), read one tile ahead so
      // that the global loads overlap the wait for a free stage
      constexpr int kPer = C::kKeys / 32;
      int ok_next[kPer], seg_next[kPer];
      auto fetch = [&](int s0) {
#pragma unroll
        for (int x = 0; x < kPer; ++x) {
          const int key = s0 + lane + 32 * x;
          bool ok = key < kv_end;
          if (ok && p.kv_bytes != nullptr) ok = p.kv_bytes[(long long)b * p.S + key] != 0;
          ok_next[x] = ok;
          seg_next[x] = (ok && p.kv_segs != nullptr) ? p.kv_segs[(long long)b * p.S + key] : 0;
        }
      };
      if (n_tiles > 0) fetch(tile_key(0));
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages, s0 = tile_key(it);
        int ok_cur[kPer], seg_cur[kPer];
#pragma unroll
        for (int x = 0; x < kPer; ++x) {
          ok_cur[x] = ok_next[x];
          seg_cur[x] = seg_next[x];
        }
        if (it + 1 < n_tiles) fetch(tile_key(it + 1));
        mbar_wait(empty(s), ((it / C::kStages) & 1) ^ 1);
        bool any = false;
        int k_lo = kNoSeg, k_hi = -kNoSeg;
#pragma unroll
        for (int x = 0; x < kPer; ++x) {
          const int j = lane + 32 * x;
          s_kok[s * C::kKeys + j] = ok_cur[x];
          s_kseg[s * C::kKeys + j] = seg_cur[x];
          any = any || ok_cur[x];
          if (ok_cur[x]) {
            k_lo = min(k_lo, seg_cur[x]);
            k_hi = max(k_hi, seg_cur[x]);
          }
        }
        any = __any_sync(0xffffffffu, any);
        if (p.q_segs != nullptr) warp_min_max(k_lo, k_hi);
        const bool live = any && (p.q_segs == nullptr || (k_lo <= q_hi && q_lo <= k_hi));
        if (lane == 0) {
          s_live[s] = live;
          if (live) {
            mbar_expect_tx(full(s), 2 * C::kKVLoad);
            for (int c = 0; c < C::kChunks; ++c) {
              tma_load(sK + s * C::kKVTile + c * C::kKVChunk, &map_k, full(s), c * 64, hk, s0, b);
              tma_load(sV + s * C::kKVTile + c * C::kKVChunk, &map_v, full(s), c * 64, hk, s0, b);
            }
          } else {
            mbar_arrive(full(s));
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumers: packed rows ra and ra + 8 of warpgroup wg, per thread ----
    setmaxnreg_inc<kDqConsumerRegs>();
    const int lane = tid % 32, quad = lane % 4;
    const int ra = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
    int t_row[2], q_seg[2];
    float l2[2], di[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ra + 8 * i;
      t_row[i] = t0 + r / g;
      const bool in = t_row[i] < p.T;
      const long long row = ((long long)b * p.Hq + hk * g + r % g) * p.T + t_row[i];
      l2[i] = in ? p.lse[row] * kLog2e : INFINITY;
      di[i] = in ? p.di[row] : 0.f;
      q_seg[i] = (p.q_segs != nullptr && in) ? p.q_segs[(long long)b * p.T + t_row[i]] : 0;
    }
    const uint32_t q_rows = sQ + wg * 64 * 128, do_rows = sDO + wg * 64 * 128;
    const float2 cst = score_consts(p);

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    // the two warpgroups take turns to issue their S / dP products (named
    // barriers 2 and 3), so that one's scores overlap the other's products
    if (wg == 1) named_arrive(2, 256);
    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::kStages, s0 = tile_key(it);
      mbar_wait(full(s), (it / C::kStages) & 1);
      if (!s_live[s]) {
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t k_tile = sK + s * C::kKVTile, v_tile = sV + s * C::kKVTile;

      // S = Q K^T and dP = dO V^T
      float sc[kSc], dp[kSc];
      fence_regs(sc);
      fence_regs(dp);
      named_sync(2 + wg, 256);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(sc, kdesc(q_rows, C::kQChunk, ks), kdesc(k_tile, C::kKVChunk, ks), ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(dp, kdesc(do_rows, C::kQChunk, ks), kdesc(v_tile, C::kKVChunk, ks), ks > 0);
      wgmma_commit();
      named_arrive(3 - wg, 256);

      // p times the cap's derivative while dP is still in the tensor cores
      wgmma_wait<1>();
      fence_regs(sc);
      const int* kok = s_kok + s * C::kKeys;
      const int* kseg = s_kseg + s * C::kKeys;
      if (p.softcap > 0.f) dq_scores<true>(sc, p, kok, kseg, s0, quad, t_row, q_seg, l2, cst);
      else dq_scores<false>(sc, p, kok, kseg, s0, quad, t_row, q_seg, l2, cst);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < kSc; ++x) dp[x] = sc[x] * (dp[x] - di[(x / 2) % 2]);

      // dz in bf16 as the A fragments of dz K: keys 16kk..16kk+15
      uint32_t za[C::kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < C::kKeys / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) za[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      }

      // dq += dz K (K read MN-major: keys along the depth)
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kKeys / 16; ++kk)
        wgmma_rs(dq, za[kk], mndesc(k_tile, C::kKVChunk, kk));
      wgmma_commit_wait();
      fence_regs(dq);
      mbar_arrive(empty(s));
    }
    if (wg == 0) named_sync(2, 256);  // warpgroup 1's last turn

    // epilogue: dq * scale, as an fp32 partial when S is split
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t_row[i], h = hk * g + (ra + 8 * i) % g;
      if (t >= p.T) continue;
      const long long row = ((long long)b * p.T + t) * p.Hq + h;
      if (p.n_split > 1) {
        float* out = p.dq_part + ((long long)split * p.B * p.T * p.Hq + row) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          store2(out + 8 * n + 2 * quad, dq[4 * n + 2 * i] * p.scale, dq[4 * n + 2 * i + 1] * p.scale);
      } else {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.dq) + row * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          store2(out + 8 * n + 2 * quad, dq[4 * n + 2 * i] * p.scale, dq[4 * n + 2 * i + 1] * p.scale);
      }
    }
  }
}

// ---- dk / dv kernel ------------------------------------------------------

template <int D>
struct DkvCfg {
  static constexpr int kStages = D == 128 ? 3 : 2;  // ring depth (D = 256: no room for 3)
  static constexpr int kChunks = D / 64;
  static constexpr int kKVChunk = kKeysKV * 128;   // one 64-column chunk of K or V
  static constexpr int kKVTile = kChunks * kKVChunk;
  static constexpr int kRowChunk = kRowsKV * 128;  // one 64-column chunk of Q or dO
  static constexpr int kRowTile = kChunks * kRowChunk;
  static constexpr int kPTile = kKeysKV * kRowsKV * 2;  // bf16 P^T or dZ^T, one chunk
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVTile;
  static constexpr int kQ = kV + kKVTile;
  static constexpr int kDO = kQ + kStages * kRowTile;
  static constexpr int kP = kDO + kStages * kRowTile;
  static constexpr int kDZ = kP + kPTile;
  static constexpr int kLse = kDZ + kPTile;                 // float [kStages][kRowsKV]
  static constexpr int kDi = kLse + 4 * kStages * kRowsKV;  // float [kStages][kRowsKV]
  static constexpr int kQseg = kDi + 4 * kStages * kRowsKV; // int [kStages][kRowsKV]
  static constexpr int kLive = kQseg + 4 * kStages * kRowsKV;  // int [kStages]
  static constexpr int kKok = kLive + 8 * kStages;          // int [kKeysKV]
  static constexpr int kKseg = kKok + 4 * kKeysKV;          // int [kKeysKV]
  static constexpr int kBlock = kKseg + 4 * kKeysKV;        // int [4]: any key, seg lo, seg hi
  static constexpr int kBar = kBlock + 16;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
  static constexpr uint32_t kKVLoad = kKeysKV * D * 2;
  static constexpr uint32_t kRowLoad = kRowsKV * D * 2;
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
  static_assert(kQ % 1024 == 0 && kRowTile % 1024 == 0 && kP % 1024 == 0 && kPTile % 1024 == 0,
                "swizzle atoms are 1024-byte aligned");
};

template <bool kCap>
__device__ __forceinline__ void dkv_scores(float (&st)[16], float (&pd)[16],
                                           const FlashBwdParams& p, const float* lse2,
                                           const int* qsegs, int t0, const int (&ct)[8],
                                           int c_base, int quad, const int (&key)[2],
                                           const bool (&key_ok)[2], const int (&k_seg)[2],
                                           float2 cst) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c_base + 8 * n + 2 * quad + e, t = t0 + ct[2 * n + e];
      const float l2 = lse2[c];
      const int q_seg = qsegs[c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bool ok = key_ok[i];
        if (p.causal) ok = ok && key[i] <= t;
        if (p.window > 0) ok = ok && t - key[i] < p.window;
        if (p.q_segs != nullptr) ok = ok && q_seg == k_seg[i];
        const int x = 4 * n + 2 * i + e;
        st[x] = prob<kCap>(st[x], ok, l2, cst.x, cst.y, pd[x]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const FlashBwdParams p) {
  using C = DkvCfg<D>;
  constexpr int kAcc = D / 4;  // sums per thread of a 64-key x D/2 tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base + C::kK, sV = base + C::kV, sQ = base + C::kQ, sDO = base + C::kDO;
  const uint32_t sP = base + C::kP, sDZ = base + C::kDZ;
  float* s_lse = reinterpret_cast<float*>(smem + C::kLse);
  float* s_di = reinterpret_cast<float*>(smem + C::kDi);
  int* s_qseg = reinterpret_cast<int*>(smem + C::kQseg);
  int* s_live = reinterpret_cast<int*>(smem + C::kLive);
  int* s_kok = reinterpret_cast<int*>(smem + C::kKok);
  int* s_kseg = reinterpret_cast<int*>(smem + C::kKseg);
  int* s_block = reinterpret_cast<int*>(smem + C::kBlock);
  const uint32_t kv_full = base + C::kBar;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + C::kStages + s); };

  const int g = p.Hq / p.Hk, rows_t = kRowsKV / g;
  const int k0 = blockIdx.x * kKeysKV, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;

  if (tid < 32) {  // the block's keys: kv_mask and segment ids, staged once
    bool any = false;
    int lo = kNoSeg, hi = -kNoSeg;
    for (int j = tid; j < kKeysKV; j += 32) {
      const int key = k0 + j;
      bool ok = key < p.S;
      if (ok && p.kv_bytes != nullptr) ok = p.kv_bytes[(long long)b * p.S + key] != 0;
      const int sg = (ok && p.kv_segs != nullptr) ? p.kv_segs[(long long)b * p.S + key] : 0;
      s_kok[j] = ok;
      s_kseg[j] = sg;
      any = any || ok;
      if (ok) {
        lo = min(lo, sg);
        hi = max(hi, sg);
      }
    }
    any = __any_sync(0xffffffffu, any);
    warp_min_max(lo, hi);
    if (tid == 0) {
      s_block[0] = any;
      s_block[1] = lo;
      s_block[2] = hi;
      mbar_init(kv_full, 1);
      for (int s = 0; s < C::kStages; ++s) {
        mbar_init(full(s), 32);
        mbar_init(empty(s), 128 * 2);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();

  // query rows any key of the block can see: t >= k0 when causal, t <= the
  // last key + window - 1 under a window; none when every key is masked
  const int k_last = min(k0 + kKeysKV, p.S) - 1;
  const int t_lo = p.causal ? k0 : 0;
  const int t_hi = p.window > 0 ? min(p.T, k_last + p.window) : p.T;
  const int first = t_lo / rows_t;
  const int n_tiles = (s_block[0] && t_hi > t_lo) ? (t_hi - 1) / rows_t - first + 1 : 0;

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: warp 0 of warpgroup 2 ----
    setmaxnreg_dec<kDkvProducerRegs>();
    if (tid < 256 + 32) {
      const int lane = tid % 32;
      const int k_lo = s_block[1], k_hi = s_block[2];
      if (lane == 0 && n_tiles > 0) {
        mbar_expect_tx(kv_full, 2 * C::kKVLoad);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(sK + c * C::kKVChunk, &map_k, kv_full, c * 64, hk, k0, b);
          tma_load(sV + c * C::kKVChunk, &map_v, kv_full, c * 64, hk, k0, b);
        }
      }
      // lse, di and segment id of packed rows r = lane, lane + 32 (query
      // t0 + r / g of head hk * g + r % g), read one tile ahead so that the
      // global loads overlap the wait for a free stage
      constexpr int kPer = kRowsKV / 32;
      float lse_next[kPer], di_next[kPer];
      int seg_next[kPer];
      auto fetch = [&](int t0) {
#pragma unroll
        for (int x = 0; x < kPer; ++x) {
          const int r = lane + 32 * x, t = t0 + r / g, h = hk * g + r % g;
          const bool in = t < p.T;
          const long long row = ((long long)b * p.Hq + h) * p.T + t;
          lse_next[x] = in ? p.lse[row] * kLog2e : INFINITY;
          di_next[x] = in ? p.di[row] : 0.f;
          seg_next[x] = (in && p.q_segs != nullptr) ? p.q_segs[(long long)b * p.T + t] : -kNoSeg;
        }
      };
      if (n_tiles > 0) fetch(first * rows_t);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages, t0 = (first + it) * rows_t;
        float lse_cur[kPer], di_cur[kPer];
        int seg_cur[kPer];
#pragma unroll
        for (int x = 0; x < kPer; ++x) {
          lse_cur[x] = lse_next[x];
          di_cur[x] = di_next[x];
          seg_cur[x] = seg_next[x];
        }
        if (it + 1 < n_tiles) fetch(t0 + rows_t);
        mbar_wait(empty(s), ((it / C::kStages) & 1) ^ 1);
        int q_lo = kNoSeg, q_hi = -kNoSeg;
#pragma unroll
        for (int x = 0; x < kPer; ++x) {
          const int r = lane + 32 * x;
          s_lse[s * kRowsKV + r] = lse_cur[x];
          s_di[s * kRowsKV + r] = di_cur[x];
          s_qseg[s * kRowsKV + r] = seg_cur[x];
          if (seg_cur[x] != -kNoSeg) {  // a row before T
            q_lo = min(q_lo, seg_cur[x]);
            q_hi = max(q_hi, seg_cur[x]);
          }
        }
        if (p.q_segs != nullptr) warp_min_max(q_lo, q_hi);
        const bool live = p.q_segs == nullptr || (k_lo <= q_hi && q_lo <= k_hi);
        if (lane == 0) {
          s_live[s] = live;
          if (live) {
            mbar_expect_tx(full(s), 2 * C::kRowLoad);
            for (int c = 0; c < C::kChunks; ++c) {
              tma_load(sQ + s * C::kRowTile + c * C::kRowChunk, &map_q, full(s), c * 64, hk * g,
                       t0, b);
              tma_load(sDO + s * C::kRowTile + c * C::kRowChunk, &map_do, full(s), c * 64,
                       hk * g, t0, b);
            }
          } else {
            mbar_arrive(full(s));
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumers: keys ra and ra + 8 of the tile; warpgroup wg takes
    // rows 32 wg .. 32 wg + 31 of each streamed tile for S^T / dP^T and
    // columns wg * D / 2 .. of dk and dv ----
    setmaxnreg_inc<kDkvConsumerRegs>();
    const int lane = tid % 32, quad = lane % 4;
    const int ra = (tid % 128) / 32 * 16 + lane / 4;
    int key[2], k_seg[2];
    bool key_ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      key[i] = k0 + ra + 8 * i;
      key_ok[i] = s_kok[ra + 8 * i] != 0;
      k_seg[i] = s_kseg[ra + 8 * i];
    }
    // query offset c / g of each of the thread's 8 columns c of S^T
    int ct[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) ct[x] = (wg * 32 + 8 * (x / 2) + 2 * quad + x % 2) / g;
    const float2 cst = score_consts(p);
    unsigned char* p_bytes = smem + C::kP;
    unsigned char* dz_bytes = smem + C::kDZ;

    float dk[kAcc], dv[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) dk[i] = dv[i] = 0.f;

    if (n_tiles > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::kStages, t0 = (first + it) * rows_t;
      mbar_wait(full(s), (it / C::kStages) & 1);
      if (!s_live[s]) {
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t q_tile = sQ + s * C::kRowTile, do_tile = sDO + s * C::kRowTile;

      // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 32 rows
      float st[16], dpt[16];
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(st, kdesc(sK, C::kKVChunk, ks), kdesc(q_tile + wg * 32 * 128, C::kRowChunk, ks),
                 ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(dpt, kdesc(sV, C::kKVChunk, ks), kdesc(do_tile + wg * 32 * 128, C::kRowChunk, ks),
                 ks > 0);
      wgmma_commit();

      // p and p times the cap's derivative while dP^T is still in the
      // tensor cores, then dz = pd (dp - di)
      wgmma_wait<1>();
      fence_regs(st);
      const float* lse2 = s_lse + s * kRowsKV;
      const float* dis = s_di + s * kRowsKV;
      const int* qsegs = s_qseg + s * kRowsKV;
      float pd[16];
      if (p.softcap > 0.f)
        dkv_scores<true>(st, pd, p, lse2, qsegs, t0, ct, wg * 32, quad, key, key_ok, k_seg, cst);
      else
        dkv_scores<false>(st, pd, p, lse2, qsegs, t0, ct, wg * 32, quad, key, key_ok, k_seg, cst);
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {  // x = 2 i + e: column wg * 32 + 8 n + 2 quad + e
          const int c = wg * 32 + 8 * n + 2 * quad + x % 2;
          dpt[4 * n + x] = pd[4 * n + x] * (dpt[4 * n + x] - dis[c]);
        }
      }

      // P^T and dZ^T in bf16 into shared memory, K-major (keys x 64 rows),
      // in the 128-byte swizzle: 16-byte unit u of key row m sits at u ^ (m % 8)
      consumers_sync();  // the last tile's products have read both tiles
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = ra + 8 * i, c = wg * 32 + 8 * n + 2 * quad;
          const int off = m * 128 + (((c / 8) ^ (m % 8)) * 16) + (c % 8) * 2;
          *reinterpret_cast<uint32_t*>(p_bytes + off) =
              pack_bf16(st[4 * n + 2 * i], st[4 * n + 2 * i + 1]);
          *reinterpret_cast<uint32_t*>(dz_bytes + off) =
              pack_bf16(dpt[4 * n + 2 * i], dpt[4 * n + 2 * i + 1]);
        }
      }
      fence_async_smem();
      consumers_sync();

      // dv[:, half] += P^T dO[:, half], dk[:, half] += dZ^T Q[:, half]
      const uint32_t half = wg * (D / 128) * C::kRowChunk;
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRowsKV / 16; ++kk)
        wgmma_ss_mn(dv, kdesc(sP, C::kPTile, kk), mndesc(do_tile + half, C::kRowChunk, kk));
#pragma unroll
      for (int kk = 0; kk < kRowsKV / 16; ++kk)
        wgmma_ss_mn(dk, kdesc(sDZ, C::kPTile, kk), mndesc(q_tile + half, C::kRowChunk, kk));
      wgmma_commit_wait();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(empty(s));
    }

    // epilogue: keys past S are not stored; dk * scale
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= p.S) continue;
      const long long row = (((long long)b * p.S + key[i]) * p.Hk + hk) * D + wg * (D / 2);
      __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.dk) + row;
      __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.dv) + row;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        store2(dk_out + 8 * n + 2 * quad, dk[4 * n + 2 * i] * p.scale, dk[4 * n + 2 * i + 1] * p.scale);
        store2(dv_out + 8 * n + 2 * quad, dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

// The dq kernel (then the sum of its partials when S is split) and the
// dk / dv kernel on `stream`.
template <int D>
cudaError_t launch_backward(const FlashBwdParams& p, cudaStream_t stream) {
  using Cq = DqCfg<D>;
  using Ck = DkvCfg<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cq::kBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        flash_bwd_dkv_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Ck::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (p.Hk < 1 || p.Hq % p.Hk || kRowsKV % (p.Hq / p.Hk) || p.n_split < 1 ||
      (long long)p.B * p.n_split > 65535 || p.Hk > 65535 ||
      (p.n_split > 1 && p.dq_part == nullptr))
    return cudaErrorInvalidValue;
  const int g = p.Hq / p.Hk;
  CUtensorMap mq, mdo, mk, mv;
  if (!make_map(&mq, p.q, D, p.Hq, p.T, p.B, p.q_sh, p.q_st, p.q_sb, 64, g, kQRows / g, true) ||
      !make_map(&mdo, p.dout, D, p.Hq, p.T, p.B, p.do_sh, p.do_st, p.do_sb, 64, g, kQRows / g,
                true) ||
      !make_map(&mk, p.k, D, p.Hk, p.S, p.B, p.k_sh, p.k_ss, p.k_sb, 64, 1, Cq::kKeys, true) ||
      !make_map(&mv, p.v, D, p.Hk, p.S, p.B, p.v_sh, p.v_ss, p.v_sb, 64, 1, Cq::kKeys, true))
    return cudaErrorInvalidValue;
  const dim3 gq((p.T + kQRows / g - 1) / (kQRows / g), p.Hk, p.B * p.n_split);
  flash_bwd_dq_sm90<D><<<gq, kThreads, Cq::kBytes, stream>>>(mq, mdo, mk, mv, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.n_split > 1) {
    flash_bwd_dq_sum<__nv_bfloat16, D>
        <<<(unsigned)((long long)p.B * p.T * p.Hq), D / 2, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!make_map(&mq, p.q, D, p.Hq, p.T, p.B, p.q_sh, p.q_st, p.q_sb, 64, g, kRowsKV / g, true) ||
      !make_map(&mdo, p.dout, D, p.Hq, p.T, p.B, p.do_sh, p.do_st, p.do_sb, 64, g, kRowsKV / g,
                true) ||
      !make_map(&mk, p.k, D, p.Hk, p.S, p.B, p.k_sh, p.k_ss, p.k_sb, 64, 1, kKeysKV, true) ||
      !make_map(&mv, p.v, D, p.Hk, p.S, p.B, p.v_sh, p.v_ss, p.v_sb, 64, 1, kKeysKV, true))
    return cudaErrorInvalidValue;
  const dim3 gk((p.S + kKeysKV - 1) / kKeysKV, p.Hk, p.B);
  flash_bwd_dkv_sm90<D><<<gk, kThreads, Ck::kBytes, stream>>>(mq, mdo, mk, mv, p);
  return cudaGetLastError();
}

}  // namespace sm90bwd
}  // namespace vidi
