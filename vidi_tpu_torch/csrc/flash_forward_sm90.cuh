// Forward attention for Hopper (sm_90a), bf16 in, fp32 sums: the bf16 route
// of K1 (flash_attention.cu) and K2 (tower_attention.cu), compiled for the
// widths D = 64, 72, 128 and 256 and run at any head dim d <= D with
// d % 8 == 0 (below). fp32 operands stay on the SIMT template of
// attention_common.cuh.
//
// One block computes 128 query rows of one (batch, KV head) against a range
// of keys. Rows are packed GQA groups: row r is query t0 + r / g of head
// hk * g + r % g (g = Hq / Hk, 1 for the towers), so every query head that
// reads a K/V tile shares it, and the tile crosses shared memory once per
// block. Causal, window and segment tests compare against the row's t.
// A group g that does not divide 128 packs 128 / g queries (rounded down)
// of g heads: the 128 % g rows left over are zero in shared memory (TMA
// brings g x (128 / g) rows), computed and never stored.
//
// Tile skips: a block walks only the key tiles of its causal / window band
// (its key range is clipped), and with packing segment ids only those of
// the band's tiles whose ids can meet its rows' (`mark_live_tiles`, the
// rule of the Pallas kernel's `_seg_overlap`). Before the roles split, the
// block's 12 warps mark the live tiles in a bit mask in shared memory;
// producer and consumers then walk the same live tiles, so a dead tile
// costs no TMA load, no wgmma, no softmax update and no trip through the
// ring. A split or a block with no live tile writes the neutral state (m =
// -inf, l = 0: zeros and the sentinel lse, or a partial the merge ignores).
// ops/cuda/flash_attention.py mirrors the walk (`sm90_fwd_tiles`).
//
// Warp roles (384 threads): warpgroups 0 and 1 are consumers of 64 rows
// each; warpgroup 2 is the producer, one thread of which issues every TMA
// load. The producer gives its registers to the consumers (setmaxnreg 24 /
// 240): at D = 256 a consumer thread holds the 64 x 256 fp32 output tile
// (128 registers), a 64 x 64 score tile (32) and its bf16 copy (16). ptxas
// honours setmaxnreg only while the two roles' code paths never meet again;
// a trap (which ptxas gives one shared exit) makes it hold the consumers to
// 168 registers, spill and serialise the wgmma.
//
// Per key tile: the producer loads K and V into a ring of kStages stages,
// each on its own "full" mbarrier, after the consumers released the stage
// on its "empty" barrier. A consumer computes S = Q K^T with wgmma (Q and K
// from shared memory, K-major), masks and softmaxes S in registers (row max
// and sum by shuffles among the four lanes of a row; exp2 with log2(e)
// folded into the scale), rescales its output tile, rounds P to bf16 in
// registers (the Pallas kernels' `p.astype(v.dtype)`; the row sum stays
// fp32) and accumulates O += P V with wgmma (P from registers, V from shared
// memory, MN-major). No score tile is written to shared memory.
//
// Layouts: D = 64, 128, 256 load 64-column TMA boxes with the 128-byte
// swizzle (the canonical wgmma layout). SigLIP's D = 72 has 144-byte rows,
// which no 128-byte box holds: it loads 8-column boxes into the unswizzled
// core-matrix layout, and Q K^T runs to depth 80 over columns 72..79 that are
// zeroed once in shared memory and never loaded (the next head's columns
// would otherwise enter the scores). P V's N = 72 is a legal wgmma width.
//
// Head dims below the compiled width: the tensor maps carry the true d as
// their innermost extent, so TMA fills a box's columns past d with zeros
// (the next head's columns never enter), and the boxes wholly past d are
// not loaded: their chunks of Q, K and V are zeroed once in shared memory,
// as the depth padding of D = 72 is. Q K^T and P V then run at the
// compiled width over zero columns, and the epilogue stores d columns.
//
// Ragged edges: TMA fills rows past T or S with zeros, but a zero key
// scores 0, not "absent", so keys past the block's range are masked to
// -inf; rows past T are computed and not stored.
//
// The softcap's tanh is 1 - 2 / (2^(2 x log2 e) + 1) from the exp2 and
// reciprocal units (absolute error ~1e-7, ~1e-5 on a logit capped at 50),
// not tanh.approx.f32 (relative error 2^-11, up to 0.02 on such a logit),
// and six instructions where the accurate tanhf takes about twenty: at
// D = 256 one tanh per score weighs as much as the two products.
#pragma once

#include "attention_common.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace vidi {
namespace sm90 {

constexpr int kRows = 128;      // query rows per block
constexpr int kConsumers = 2;   // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kStages = 2;      // K/V ring depth
constexpr int kLiveWords = 256; // live-tile mask of a packed block: 8,192 key tiles
constexpr int kNoSeg = 0x7fffffff;  // empty [lo, hi] id range: lo = kNoSeg, hi = -kNoSeg
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr bool kSwizzle = D % 64 == 0;
  static constexpr int kChunk = kSwizzle ? 64 : 8;    // columns per TMA box
  static constexpr int kChunkBytes = 2 * kChunk;      // bytes of one row of a box
  static constexpr int kDepth = (D + 15) / 16 * 16;   // Q K^T depth (72 -> 80)
  static constexpr int kChunks = kDepth / kChunk;     // chunks Q K^T reads
  static constexpr int kKeys = D == 256 ? 64 : 128;   // keys per tile
  static constexpr int kQChunk = kRows * kChunkBytes;  // one chunk of the Q tile
  static constexpr int kKVChunk = kKeys * kChunkBytes; // one chunk of a K or V tile
  static constexpr int kKVTile = kChunks * kKVChunk;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kChunks * kQChunk;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBar = kV + kStages * kKVTile;
  static constexpr int kLive = kBar + 8 * (1 + 3 * kStages);  // uint32 [kLiveWords]
  static constexpr int kBytes = kLive + 4 * kLiveWords + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
  static_assert(kQ % 1024 == 0 && kK % 1024 == 0 && kKVTile % 1024 == 0,
                "swizzle atoms are 1024-byte aligned");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// K-major operand (Q rows, K keys) of depth step ks (16 columns) from a
// tile stored as column chunks of `chunk_bytes` bytes each.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, uint32_t chunk_bytes, int ks) {
  using C = Cfg<D>;
  if constexpr (C::kSwizzle) {  // 128-byte rows, 8-row atoms of 1024 bytes
    return smem_desc(tile + (ks / 4) * chunk_bytes + (ks % 4) * 32, 16, 1024, true);
  } else {  // core matrices of 8 rows x 16 bytes; next 8 columns one chunk on
    return smem_desc(tile + 2 * ks * chunk_bytes, chunk_bytes, 128, false);
  }
}
// MN-major V operand (keys along K, head dim along N) of key step kk.
template <int D>
__device__ __forceinline__ uint64_t vmajor_desc(uint32_t tile, int kk) {
  using C = Cfg<D>;
  if constexpr (C::kSwizzle) {  // next 64 columns one chunk on, next 8 keys 1024 bytes on
    return smem_desc(tile + kk * 16 * 128, C::kKVChunk, 1024, true);
  } else {  // next 8 keys 128 bytes on, next 8 columns one chunk on
    return smem_desc(tile + kk * 16 * 16, 128, C::kKVChunk, false);
  }
}

// tanh(x) = 1 - 2 / (e^2x + 1) on the exp2 and reciprocal units: exact
// limits at +-inf, absolute error ~1e-7 near 0 (where the plain tanhf is
// relative).
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, exp2f(2.f * kLog2e * x) + 1.f);
}

// Scores of one key tile into log2 units, in place: x * scale (with a cap,
// cap * tanh(x * scale / cap)) * log2(e), and -inf where the key is not
// visible from the row (kMask; a tile inside the range of an unmasked call
// skips the tests). The score of 8-key group n sits in sc[4n + 2i + e]: row
// ra + 8i, key 8n + 2 quad + e. The cap and the tests are template
// arguments because, left as branches inside the element loop, the compiler
// predicates the whole tanh onto every score whether or not a cap is set.
template <bool kCap, bool kMask, int N>
__device__ __forceinline__ void score_tile(float (&sc)[N], const FlashParams& p, int b, int s0,
                                           int kv_end, int quad, const int (&t_row)[2],
                                           const int (&q_seg)[2]) {
  const float scale = kCap ? p.scale / p.softcap : p.scale * kLog2e;
  const float cap = p.softcap * kLog2e;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = s0 + 8 * n + 2 * quad + e;
      bool key_ok = true;
      int k_seg = 0;
      if constexpr (kMask) {
        key_ok = key < kv_end && (p.kv_mask == nullptr || p.kv_mask[(long long)b * p.S + key]);
        if (key_ok && p.kv_segs != nullptr) k_seg = p.kv_segs[b * p.S + key];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = sc[4 * n + 2 * i + e] * scale;
        if constexpr (kCap) x = cap * tanh_fast(x);
        if constexpr (kMask) {
          bool ok = key_ok;
          if (p.causal) ok = ok && key <= t_row[i];
          if (p.window > 0) ok = ok && t_row[i] - key < p.window;
          if (p.q_segs != nullptr) ok = ok && q_seg[i] == k_seg;
          if (!ok) x = -INFINITY;
        }
        sc[4 * n + 2 * i + e] = x;
      }
    }
  }
}

__device__ __forceinline__ void warp_min_max(int& lo, int& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// Packed segments: sets bit `it` of `live` for each key tile `it` of the
// block's range [kv_begin, kv_end) that can hold a visible pair, by the
// rule of the Pallas kernel's `_seg_overlap`: the [min, max] range of the
// nonzero segment ids of the block's rows meets that of the tile's keys.
// The keys are those the score test admits (inside the range, kv_mask
// set), and a tile whose unmasked keys include padding (id 0) is kept for
// a block with a padding row too, since the mask lets the two see each
// other; where kv_mask hides the padding, as it does for packed rows, this
// is `_seg_overlap` exactly. Every warp of the block takes tiles in turn,
// a lane kKeys / 32 keys of each; `live` is zero on entry.
template <int kKeys>
__device__ __forceinline__ void mark_live_tiles(uint32_t* live, const FlashParams& p, int b,
                                                int t0, int rows_t, int kv_begin, int kv_end,
                                                int n_tiles) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int q_lo = kNoSeg, q_hi = -kNoSeg;
  bool q_pad = false;
  for (int i = lane; i < rows_t && t0 + i < p.T; i += 32) {
    const int sg = p.q_segs[(long long)b * p.T + t0 + i];
    q_pad = q_pad || sg == 0;
    if (sg != 0) {
      q_lo = min(q_lo, sg);
      q_hi = max(q_hi, sg);
    }
  }
  warp_min_max(q_lo, q_hi);
  q_pad = __any_sync(0xffffffffu, q_pad);
  for (int it = warp; it < n_tiles; it += kThreads / 32) {
    int k_lo = kNoSeg, k_hi = -kNoSeg;
    bool k_pad = false;
#pragma unroll
    for (int x = 0; x < kKeys / 32; ++x) {
      const int key = kv_begin + it * kKeys + lane + 32 * x;
      const long long at = (long long)b * p.S + key;
      if (key < kv_end && (p.kv_mask == nullptr || p.kv_mask[at])) {
        const int sg = p.kv_segs[at];
        k_pad = k_pad || sg == 0;
        if (sg != 0) {
          k_lo = min(k_lo, sg);
          k_hi = max(k_hi, sg);
        }
      }
    }
    warp_min_max(k_lo, k_hi);
    const bool pads = __any_sync(0xffffffffu, k_pad) && q_pad;
    if (lane == 0 && ((k_lo <= q_hi && q_lo <= k_hi) || pads))
      atomicOr(live + it / 32, 1u << (it % 32));
  }
}

// ---- the kernel ---------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_forward_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const FlashParams p) {
  using C = Cfg<D>;
  constexpr int kSc = C::kKeys / 2;  // score registers per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + C::kQ, sK = base + C::kK, sV = base + C::kV;
  const uint32_t q_full = base + C::kBar;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  uint32_t* s_live = reinterpret_cast<uint32_t*>(smem + C::kLive);
  const bool packed = p.q_segs != nullptr;
  auto live = [&](int it) { return !packed || (s_live[it / 32] >> (it % 32) & 1u); };

  const int g = p.Hq / p.Hk;  // query heads per KV head: rows per t
  const int rows_t = kRows / g, live_rows = rows_t * g;  // queries, stored rows
  const int loaded = (p.d + C::kChunk - 1) / C::kChunk;  // chunks TMA fills
  const int hk = blockIdx.y;
  const int b = blockIdx.z / p.n_split, split = blockIdx.z % p.n_split;
  const int t0 = blockIdx.x * rows_t;
  // keys any row of the block can see: the causal and window bounds skip
  // whole tiles; each score is still tested against its own row
  int kv_begin = split * p.kv_split, kv_end = min(p.S, kv_begin + p.kv_split);
  if (p.causal) kv_end = min(kv_end, min(p.T, t0 + rows_t));
  if (p.window > 0) kv_begin = max(kv_begin, t0 - p.window + 1);
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + C::kKeys - 1) / C::kKeys : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (packed)
    for (int i = tid; i < kLiveWords; i += kThreads) s_live[i] = 0;
  if (loaded < C::kChunks || live_rows < kRows) {
    // zero what TMA never fills: the chunks past d (of Q and K: the depth
    // padding; of V: P V's columns past d) and the rows of Q past a group's
    // 128 / g queries
    const int pad = (C::kChunks - loaded) * C::kQChunk / 16;
    const int pad_kv = (C::kChunks - loaded) * C::kKVChunk / 16;
    for (int i = tid; i < pad; i += kThreads)
      reinterpret_cast<uint4*>(smem + C::kQ + loaded * C::kQChunk)[i] = make_uint4(0, 0, 0, 0);
    for (int s = 0; s < kStages; ++s)
      for (int i = tid; i < pad_kv; i += kThreads) {
        reinterpret_cast<uint4*>(smem + C::kK + s * C::kKVTile + loaded * C::kKVChunk)[i] =
            make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(smem + C::kV + s * C::kKVTile + loaded * C::kKVChunk)[i] =
            make_uint4(0, 0, 0, 0);
      }
    constexpr int kRowUnits = C::kChunkBytes / 16;  // 16-byte units of a row of a chunk
    const int left = (kRows - live_rows) * kRowUnits;
    for (int i = tid; i < loaded * left; i += kThreads)
      reinterpret_cast<uint4*>(smem + C::kQ + (i / left) * C::kQChunk +
                               live_rows * C::kChunkBytes)[i % left] = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 128 * kConsumers) {  // Q first: its load overlaps the tile marks
    mbar_expect_tx(q_full, loaded * live_rows * C::kChunkBytes);
    for (int c = 0; c < loaded; ++c)
      tma_load(sQ + c * C::kQChunk, &map_q, q_full, c * C::kChunk, hk * g, t0, b);
  }
  if (packed) {
    mark_live_tiles<C::kKeys>(s_live, p, b, t0, rows_t, kv_begin, kv_end, n_tiles);
    __syncthreads();
  }

  const int wg = tid / 128;
  if (wg == kConsumers) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (tid == 128 * kConsumers) {
      for (int it = 0, j = 0; it < n_tiles; ++it) {
        if (!live(it)) continue;
        const int s = j % kStages, s0 = kv_begin + it * C::kKeys;
        mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        ++j;
        mbar_expect_tx(k_full(s), loaded * C::kKVChunk);
        for (int c = 0; c < loaded; ++c)
          tma_load(sK + s * C::kKVTile + c * C::kKVChunk, &map_k, k_full(s), c * C::kChunk,
                   hk, s0, b);
        mbar_expect_tx(v_full(s), loaded * C::kKVChunk);
        for (int c = 0; c < loaded; ++c)
          tma_load(sV + s * C::kKVTile + c * C::kKVChunk, &map_v, v_full(s), c * C::kChunk,
                   hk, s0, b);
      }
    }
  } else {
    // ---- consumers: rows ra and ra + 8 of warpgroup wg, per thread ----
    setmaxnreg_inc<240>();
    const int lane = tid % 32, quad = lane % 4;
    const int ra = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
    int t_row[2], h_row[2], q_seg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ra + 8 * i;
      t_row[i] = t0 + r / g;
      h_row[i] = hk * g + r % g;
      q_seg[i] = (p.q_segs != nullptr && t_row[i] < p.T) ? p.q_segs[b * p.T + t_row[i]] : 0;
    }
    const bool unmasked = p.kv_mask == nullptr && p.q_segs == nullptr && !p.causal &&
                          p.window == 0;
    const uint32_t q_rows = sQ + wg * 64 * C::kChunkBytes;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int it = 0, j = 0; it < n_tiles; ++it) {
      if (!live(it)) continue;
      const int s = j % kStages, s0 = kv_begin + it * C::kKeys;
      const uint32_t phase = (j / kStages) & 1;
      ++j;

      // S = Q K^T
      float sc[kSc];
      mbar_wait(k_full(s), phase);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::kDepth / 16; ++ks)
        wgmma_ss(sc, kmajor_desc<D>(q_rows, C::kQChunk, ks),
                 kmajor_desc<D>(sK + s * C::kKVTile, C::kKVChunk, ks), ks > 0);
      wgmma_commit_wait();
      fence_regs(sc);

      const bool whole = unmasked && s0 + C::kKeys <= kv_end;
      if (p.softcap > 0.f) {
        if (whole) score_tile<true, false>(sc, p, b, s0, kv_end, quad, t_row, q_seg);
        else score_tile<true, true>(sc, p, b, s0, kv_end, quad, t_row, q_seg);
      } else {
        if (whole) score_tile<false, false>(sc, p, b, s0, kv_end, quad, t_row, q_seg);
        else score_tile<false, true>(sc, p, b, s0, kv_end, quad, t_row, q_seg);
      }

      // online softmax in log2 units; the four lanes of a quad share a row
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int n = 0; n < C::kKeys / 8; ++n)
          mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * i], sc[4 * n + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mu = mx == -INFINITY ? 0.f : mx;
        const float alpha = exp2f(m[i] - mu);
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < C::kKeys / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = exp2f(sc[4 * n + 2 * i + e] - mu);
            sc[4 * n + 2 * i + e] = pe;
            sum += pe;
          }
        }
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n + 2 * i] *= alpha;
          o[4 * n + 2 * i + 1] *= alpha;
        }
      }
      // P in bf16 as the A fragments of P V: keys 16kk..16kk+15
      uint32_t pa[C::kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < C::kKeys / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
      }

      // O += P V
      mbar_wait(v_full(s), phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kKeys / 16; ++kk)
        wgmma_rs(o, pa[kk], vmajor_desc<D>(sV + s * C::kKVTile, kk));
      wgmma_commit_wait();
      fence_regs(o);
      mbar_arrive(empty(s));
    }

    // epilogue: the quad's partial row sums, then out = O / l (or the
    // unnormalised partial state for flash_combine); the rows left over past
    // a group's 128 / g queries and the columns past d are not stored
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t_row[i], h = h_row[i];
      if (t >= p.T || ra + 8 * i >= live_rows) continue;
      const long long row = ((long long)b * p.Hq + h) * p.T + t;
      if (p.n_split > 1) {
        const long long prow = row * p.n_split + split;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          store2(p.part_acc + prow * D + 8 * n + 2 * quad, o[4 * n + 2 * i], o[4 * n + 2 * i + 1]);
        if (quad == 0) {
          p.part_m[prow] = m[i] == -INFINITY ? -INFINITY : m[i] * kLn2;
          p.part_l[prow] = l[i];
        }
      } else {
        const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) +
                             ((long long)(b * p.T + t) * p.Hq + h) * p.d;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          if (8 * n < p.d)
            store2(out + 8 * n + 2 * quad, o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
        if (quad == 0 && p.lse != nullptr)
          p.lse[row] = l[i] == 0.f ? kEmptyRowLse : m[i] * kLn2 + logf(l[i]);
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

// A bf16 [batch, len, heads, d] operand as a 4-D tensor map (innermost
// first: d, heads, len, batch; strides in elements, each a multiple of 8),
// read in boxes of box_cols x box_heads x box_rows; a box's columns past d
// are filled with zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int d, int heads, int len, int batch,
                     long long s_head, long long s_len, long long s_batch, int box_cols,
                     int box_heads, int box_rows, bool swizzle) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)len,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_head * 2, (cuuint64_t)s_len * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_heads,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encodes the three tensor maps, launches on `stream` and merges the KV
// splits with flash_combine when there are several.
template <int D>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_forward_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (p.Hk < 1 || p.Hq % p.Hk || p.Hq / p.Hk > kRows || p.n_split < 1 ||
      p.B * p.n_split > 65535 || (p.n_split > 1 && p.kv_split % C::kKeys) ||
      p.d < 8 || p.d > D || p.d % 8)
    return cudaErrorInvalidValue;
  if (p.q_segs != nullptr &&  // a packed block's key tiles must fit the live-tile mask
      ((p.kv_split < p.S ? p.kv_split : p.S) + C::kKeys - 1) / C::kKeys > 32 * kLiveWords)
    return cudaErrorInvalidValue;
  const int g = p.Hq / p.Hk;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, p.q, p.d, p.Hq, p.T, p.B, p.q_sh, p.q_st, p.q_sb, C::kChunk, g, kRows / g,
                C::kSwizzle) ||
      !make_map(&mk, p.k, p.d, p.Hk, p.S, p.B, p.k_sh, p.k_ss, p.k_sb, C::kChunk, 1, C::kKeys,
                C::kSwizzle) ||
      !make_map(&mv, p.v, p.d, p.Hk, p.S, p.B, p.v_sh, p.v_ss, p.v_sb, C::kChunk, 1, C::kKeys,
                C::kSwizzle))
    return cudaErrorInvalidValue;
  const dim3 grid((p.T + kRows / g - 1) / (kRows / g), p.Hk, p.B * p.n_split);
  flash_forward_sm90<D><<<grid, kThreads, C::kBytes, stream>>>(mq, mk, mv, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  flash_combine<__nv_bfloat16, D>
      <<<(unsigned)((long long)p.B * p.Hq * p.T), D / 2, 0, stream>>>(p);
  return cudaGetLastError();
}

// Each width is compiled in one source: 128 and 256 in flash_attention.cu,
// 64 and 72 in tower_attention.cu; K1 and K2 reach all four through
// `launch_width`.
extern template cudaError_t launch<64>(const FlashParams&, cudaStream_t);
extern template cudaError_t launch<72>(const FlashParams&, cudaStream_t);
extern template cudaError_t launch<128>(const FlashParams&, cudaStream_t);
extern template cudaError_t launch<256>(const FlashParams&, cudaStream_t);

// The kernel at the compiled width W the wrapper chose for the head dim
// p.d (ops/cuda/flash_attention.py, `WIDTHS`).
inline cudaError_t launch_width(const FlashParams& p, int W, cudaStream_t stream) {
  switch (W) {
    case 64: return launch<64>(p, stream);
    case 72: return launch<72>(p, stream);
    case 128: return launch<128>(p, stream);
    case 256: return launch<256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace vidi
