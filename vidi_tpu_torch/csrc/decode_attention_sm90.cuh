// K3's bf16 route on Hopper: one decode token against a bf16 KV cache.
//
// What bounds it on an H100: each call reads every visible cache row once
// (2 * D bf16 of K and V per key and KV head) for only G query rows (G = 2
// for Gemma2, 4 for Mistral-7B; groups of 1, 2, 4 and 8 are built), so G FMAs per
// cache element: about 3.5 G TFLOP/s of fp32 at the full 3.35 TB/s,
// against the card's 67. Tensor cores do not decide it; what does is the
// bytes in flight and the number of SMs that hold them.
//
// The design:
// - The cache layout [B, Hk, S, D] makes a tile of `kTile` keys of one
//   (batch, KV head) one contiguous run of kTile * D elements, so a single
//   1-D bulk asynchronous copy (`cp.async.bulk`, completed on an mbarrier;
//   no tensor map, so no host work per call) moves it whole. One producer
//   warp keeps a ring of 96 KB full (three stages of 32 KB of K and V at
//   G <= 2; more, smaller stages at G >= 4, see Cfg); two blocks an SM keep
//   up to 192 KB in flight. The copies are marked evict-first in L2: each
//   step reads the cache once.
// - The wrapper's split plan (`decode_plan`) gives B * Hk * n_split blocks,
//   up to one wave of two an SM; the splits take the tiles of S in turn
//   (split i: tiles i, i + n_split, ...), so the padded frames at the end
//   of an image cache or the keys before a sliding window spread over
//   every split instead of idling whole blocks. The block takes the plan
//   as given.
// - The block reads its tiles' kv_mask bytes once, in the same round trip
//   as q and q_pos; a tile with no visible key is neither copied nor
//   computed.
// - Four consumer warps compute from shared memory with fp32 FMAs (SIMT).
//   Each takes kKPW keys of every tile: its lanes hold D / 32 neighbouring
//   elements of a row, so a warp reads whole rows (no bank conflicts), and
//   one butterfly reduce-scatter leaves each lane one (key, row) score, so
//   a warp takes at most 32 / G keys of a tile: at G >= 4 the tile shrinks
//   (to 128 / G keys) and the ring gets as many more stages, rather than
//   the reduce growing a second round.
//   Per tile and warp, in the Pallas kernel's order: scores in fp32, the
//   softcap, where(valid, s, MASK), the running max, p rounded to bf16
//   against it before P @ V, the row sum l in fp32. Each warp keeps its own
//   (m, l, acc) in registers; the warps merge once, when the block is done.
// - One launch a call: each block writes its partial (m, l, acc) to the
//   workspace and counts itself in on a per-(b, hk) counter with one
//   acquire-release atomic add; the block that arrives last stages the
//   partials in shared memory (one bulk copy for as many splits as the
//   ring holds), merges them in split order (so the result does not depend
//   on which block came last), writes the output and resets the counter to
//   0 for the next call. Asked for it (a non-null `lse`), the merge also
//   writes each row's log-sum-exp m + log(l), or kEmptyRowLse for a row
//   with no visible key: a read of a seq-cut cache merges the shards'
//   outputs with it.
//
// Head dims and groups: the kernel is compiled for the widths D = 128 and
// 256 and the groups kG = 1, 2, 4 and 8, each twice. The exact build
// (kExact) takes d = D and G = kG, the shipped shapes, with every size a
// constant: the general build ran those shapes 1.5-13% slower on device
// time on an H100 (80GB HBM3, 700 W; PERF.md): 0.7-1.3 us of a short
// cache's 7-10 us, 4% of the 9B image cache's read. The general build
// takes any head dim d <= D with d % 8 == 0 and any G, from the wrapper's
// row groups (`decode_groups`): a block takes rg <= kG rows of its KV
// head's G, the grid's y axis runs over Hk x n_groups (a KV head's tiles
// are read once per row group: G = 12 as two groups of 6), and rows past
// rg (a G that is no power of two) are computed on zero queries and not
// stored. A tile stays one bulk copy of kTile x d elements, read at a row
// stride of d; a lane whose elements lie past d holds zeros.
//
// Measured on an H100 (PERF.md, vidi_tpu_torch/tools/k3_variants.py): the copies alone
// stream the 9B image cache at ~3 TB/s; the arithmetic adds ~4 us and the
// count and merge ~3 us to a call. A short cache's call is that chain of
// dependent memory round trips (~6-9 us), not its bytes.
#pragma once

#include <limits.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "sm90.cuh"

namespace vidi {
namespace decode_sm90 {

constexpr int kConsumers = 4;  // consumer warps; one more warp produces
constexpr int kThreads = (kConsumers + 1) * 32;
constexpr int kMaxChunk = 4096;  // keys a block takes: their mask bytes sit in shared memory
constexpr float kMaskValue = -0.7f * FLT_MAX;  // the Pallas kernel's MASK_VALUE
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;       // [B, Hq, d], strides q_sb / q_sh, last dim contiguous
  const __nv_bfloat16* k;       // [B, Hk, S, d], each (b, hk) block contiguous
  const __nv_bfloat16* v;
  const unsigned char* kv_mask;  // [B, S] bytes, row stride mask_sb; nullptr = all valid
  const void* q_pos;             // [B] int32 or int64 (qpos64), stride qpos_s; window > 0
  float* part_m;                 // [B, Hk * n_groups, n_split, kG]
  float* part_l;
  float* part_acc;               // [B, Hk * n_groups, n_split, kG, D]
  unsigned int* counters;        // [B, Hk * n_groups], 0 between calls
  __nv_bfloat16* out;            // [B, Hq, d] contiguous
  float* lse;                    // [B, Hq] contiguous, or nullptr: not written
  int B, Hq, Hk, S, n_split, chunk, qpos64;
  int d, rg, n_groups;           // head dim, rows a block takes, row groups a KV head
  long long q_sb, q_sh, k_sb, k_sh, v_sb, v_sh, mask_sb, qpos_s;
  float scale, softcap;
  int window;
};

// D: head dim; G: query rows a KV head (Hq / Hk)
template <int D, int G>
struct Cfg {
  static constexpr int kBaseTile = D == 256 ? 32 : 64;  // 16 KB of K a stage
  // keys a ring stage holds: a warp's kKPW keys times G rows must fit the
  // 32 lanes of one reduce-scatter, so G >= 4 halves the tile (or more)
  static constexpr int kTile = kBaseTile < kConsumers * 32 / G ? kBaseTile
                                                               : kConsumers * 32 / G;
  static constexpr int kStages = 3 * kBaseTile / kTile;  // 96 KB of ring whatever G
  static constexpr int kEPL = D / 32;                    // row elements a lane holds
  static constexpr int kKPW = kTile / kConsumers;        // keys a warp takes of a tile
  static constexpr int kNV = kKPW * G;                   // scores a warp reduces a tile
  // after the reduce-scatter lane l holds score (lane >> kShift): kNV <= 32
  static constexpr int kShift = kNV == 32 ? 0 : kNV == 16 ? 1 : kNV == 8 ? 2 : -1;
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int kRing = kStages * 2 * kTileBytes;  // K and V tiles
  static constexpr int kMaxBytes = kRing + kMaxChunk;
  // the merge's float4 columns (G rows of D) a thread sums
  static constexpr int kCols = (G * D / 4 + kThreads - 1) / kThreads;
  // registers: acc and q take 2 G D / 32 a lane; at G D > 1024 one block an SM
  static constexpr int kMinBlocks = G * D > 1024 ? 1 : 2;
  static_assert(kShift >= 0 && kEPL % 4 == 0 && kTile % 16 == 0, "unsupported D, G");
};

// `bytes` of global memory at `src` into shared memory at `dst`, completed on
// the mbarrier `bar`; marked evict-first in L2 (the cache is read once a step)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], pol;\n}\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void unpack(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

// N neighbouring bf16 of a row as raw bits (N = 8: one 16-byte load; 4: 8
// bytes), and their conversion to fp32
template <int N>
struct RowBits;
template <>
struct RowBits<8> {
  uint4 u;
  __device__ __forceinline__ void unpack(float (&x)[8]) const {
    vidi::decode_sm90::unpack(u.x, x[0], x[1]);
    vidi::decode_sm90::unpack(u.y, x[2], x[3]);
    vidi::decode_sm90::unpack(u.z, x[4], x[5]);
    vidi::decode_sm90::unpack(u.w, x[6], x[7]);
  }
};
template <>
struct RowBits<4> {
  uint2 u;
  __device__ __forceinline__ void unpack(float (&x)[4]) const {
    vidi::decode_sm90::unpack(u.x, x[0], x[1]);
    vidi::decode_sm90::unpack(u.y, x[2], x[3]);
  }
};

// cap * tanh(x / cap), tanh from one exp2 and one fast reciprocal
// (1 - 2 / (e^2y + 1), to ~1e-7 absolute; the library tanhf branches and
// takes several times the instructions on the per-tile critical path)
__device__ __forceinline__ float softcap(float x, float cap) {
  const float e = exp2f(x * (2.f * kLog2e / cap));
  return cap - __fdividef(2.f * cap, e + 1.f);
}

// Butterfly reduce-scatter of N per-lane partial sums over the warp: at the
// step of offset O each lane keeps the half of its values whose index bit
// matches its own lane bit O and adds its partner's copy of that half, so
// lane l ends with the full sum of value (l >> (5 - log2 N)), in N - 1 + 5 -
// log2 N shuffles instead of 5 N.
template <int N, int O = 16>
__device__ __forceinline__ float reduce_scatter(float* v, int lane) {
  if constexpr (O == 0) {
    return v[0];
  } else if constexpr (N > 1) {
    constexpr int H = N / 2;
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return reduce_scatter<H, O / 2>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    return reduce_scatter<1, O / 2>(v, lane);
  }
}

template <int D, int kG, bool kExact>
__global__ void __launch_bounds__(kThreads, (Cfg<D, kG>::kMinBlocks))
    decode_attention_sm90(const Params p) {
  using C = Cfg<D, kG>;
  using namespace vidi::sm90;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], staged;
  __shared__ __align__(16) float sP[kConsumers][C::kNV];
  __shared__ float sM[kConsumers][kG], sL[kConsumers][kG], sMx[kG], sLs[kG];
  __shared__ int sLast;
  unsigned char* sMask = smem + C::kRing;  // [n_tiles][kTile] mask bytes, 0 past S

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the exact build's sizes are constants; the general build's come from p
  const int d = kExact ? D : p.d;          // the rows' length
  const int rg = kExact ? kG : p.rg;       // rows of the group the block takes
  const int n_groups = kExact ? 1 : p.n_groups;
  const int G = kExact ? kG : p.Hq / p.Hk;
  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / n_groups, grp = blockIdx.y % n_groups;
  const int q0 = hk * G + grp * rg;  // query head of the block's row 0
  // row g of the block is a query head it stores; a lane holds columns
  // lane * kEPL .. of a row, zeros past d
  auto live = [&](int g) { return kExact || (g < rg && grp * rg + g < G); };
  const bool lane_on = kExact || lane * C::kEPL < d;
  // the splits take the cache's tiles in turn: the block's tile t is tile
  // split + t * n_split of S, keys [key0(t), key0(t) + kTile), the last
  // tile of S cut at S
  const int n_tiles = ((p.S + C::kTile - 1) / C::kTile - split + p.n_split - 1) / p.n_split;
  auto key0 = [&](int t) { return (split + t * p.n_split) * C::kTile; };
  auto tile_bytes = [&](int t) { return uint32_t(min(C::kTile, p.S - key0(t)) * d * 2); };

  // Every load the block needs before it can wait on anything is issued
  // here at once: q_pos, the mask bytes and q (one round trip to memory).
  long long qp = 0;
  if (p.window > 0)
    qp = p.qpos64 ? static_cast<const long long*>(p.q_pos)[b * p.qpos_s]
                  : static_cast<const int*>(p.q_pos)[b * p.qpos_s];
  const unsigned char* mrow = p.kv_mask ? p.kv_mask + b * p.mask_sb : nullptr;
  const bool vec = mrow != nullptr && (reinterpret_cast<uintptr_t>(mrow) % 16) == 0;
  for (int i = tid * 16; i < n_tiles * C::kTile; i += kThreads * 16) {
    const int key = key0(i / C::kTile) + i % C::kTile;
    uint4 bytes;
    if (mrow != nullptr && vec && key + 16 <= p.S) {
      bytes = *reinterpret_cast<const uint4*>(mrow + key);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        w[j / 4] |= uint32_t(key + j < p.S && (mrow == nullptr || mrow[key + j] != 0))
                    << (8 * (j % 4));
      bytes = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(sMask + i) = bytes;
  }
  float qr[kG][C::kEPL];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const __nv_bfloat16* qg = p.q + b * p.q_sb + (q0 + g) * p.q_sh + lane * C::kEPL;
    const bool on = live(g) && lane_on;
#pragma unroll
    for (int e = 0; e < C::kEPL; e += 2) {
      const float2 x = on ? load2(qg + e) : make_float2(0.f, 0.f);
      qr[g][e] = x.x;
      qr[g][e + 1] = x.y;
    }
  }
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  auto issue = [&](int t, int s) {  // stage s <- tile t's K and V rows
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, 2 * tile_bytes(t));
    bulk_load(smem_u32(smem + (2 * s) * C::kTileBytes), kb + (long long)key0(t) * d,
              tile_bytes(t), bar);
    bulk_load(smem_u32(smem + (2 * s + 1) * C::kTileBytes), vb + (long long)key0(t) * d,
              tile_bytes(t), bar);
  };
  if (tid == kConsumers * 32) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a key is visible iff its mask byte is set and q_pos - key < window
  const int first = p.window > 0
      ? static_cast<int>(max(min(qp - p.window + 1, (long long)INT_MAX), (long long)INT_MIN))
      : 0;
  __syncthreads();

  // warp-uniform: does tile t hold a visible key? (producer and consumers
  // walk the same tiles in the same order)
  auto visible = [&](int t) {
    bool any = false;
#pragma unroll
    for (int j = lane; j < C::kTile; j += 32)
      any |= sMask[t * C::kTile + j] != 0 && key0(t) + j >= first;
    return __any_sync(0xffffffffu, any);
  };

  float acc[kG][C::kEPL], m[kG], l[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < C::kEPL; ++e) acc[g][e] = 0.f;
  }

  if (warp == kConsumers) {
    // producer: one bulk copy of K and one of V per visible tile
    for (int t = 0, it = 0; t < n_tiles; ++t) {
      if (!visible(t)) continue;
      const int s = it % kStages;
      if (lane == 0) {
        mbar_wait(smem_u32(&empty[s]), ((it / kStages) & 1) ^ 1);
        issue(t, s);
      }
      __syncwarp();
      ++it;
    }
  } else {
    const int idx = lane >> C::kShift;  // the (key, row) score this lane ends with
    const int my_j = idx / kG, my_g = idx % kG;
    for (int t = 0, it = 0; t < n_tiles; ++t) {
      if (!visible(t)) continue;
      const int s = it % kStages, phase = (it / kStages) & 1;
      ++it;
      mbar_wait(smem_u32(&full[s]), phase);
      const __nv_bfloat16* sk =
          reinterpret_cast<const __nv_bfloat16*>(smem + (2 * s) * C::kTileBytes);
      const __nv_bfloat16* sv =
          reinterpret_cast<const __nv_bfloat16*>(smem + (2 * s + 1) * C::kTileBytes);
      const int row0 = warp * C::kKPW;      // the warp's first row of the tile
      const int nk = p.S - key0(t) - row0;  // its keys before S (the last tile is cut)
      using Bits = RowBits<C::kEPL>;

      float part[C::kNV];
#pragma unroll
      for (int j = 0; j < C::kKPW; ++j) {
#pragma unroll
        for (int g = 0; g < kG; ++g) part[j * kG + g] = 0.f;
        if (j < nk) {
          float kk[C::kEPL] = {};
          if (lane_on)
            reinterpret_cast<const Bits*>(sk + (row0 + j) * d + lane * C::kEPL)->unpack(kk);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < C::kEPL; ++e) dot = fmaf(qr[g][e], kk[e], dot);
            part[j * kG + g] = dot;
          }
        }
      }
      float sc = reduce_scatter<C::kNV>(part, lane) * p.scale;
      if (p.softcap > 0.f) sc = softcap(sc, p.softcap);
      const bool valid = sMask[t * C::kTile + row0 + my_j] != 0 && key0(t) + row0 + my_j >= first;
      sc = valid ? sc : kMaskValue;
      // lane bits: kShift copies, then log2 kG of the row, then the key;
      // the row's max and sum run over the key bits only
      float tmax = sc;
#pragma unroll
      for (int o = kG << C::kShift; o < 32; o <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      float m_new[kG], alpha[kG], m_mine = 0.f;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        m_new[g] = fmaxf(m[g], __shfl_sync(0xffffffffu, tmax, g << C::kShift));
        alpha[g] = exp2f((m[g] - m_new[g]) * kLog2e);
        if (g == my_g) m_mine = m_new[g];
      }
      const float pr = valid ? exp2f((sc - m_mine) * kLog2e) : 0.f;
      float lsum = pr;
#pragma unroll
      for (int o = kG << C::kShift; o < 32; o <<= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
#pragma unroll
      for (int g = 0; g < kG; ++g)
        l[g] = l[g] * alpha[g] + __shfl_sync(0xffffffffu, lsum, g << C::kShift);
      if ((lane & ((1 << C::kShift) - 1)) == 0) sP[warp][idx] = round_to<__nv_bfloat16>(pr);
      __syncwarp();
      float pv[C::kNV];
#pragma unroll
      for (int i = 0; i < C::kNV; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&sP[warp][i]);
        pv[i] = x.x;
        pv[i + 1] = x.y;
        pv[i + 2] = x.z;
        pv[i + 3] = x.w;
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        m[g] = m_new[g];
#pragma unroll
        for (int e = 0; e < C::kEPL; ++e) acc[g][e] *= alpha[g];
      }
#pragma unroll
      for (int j = 0; j < C::kKPW; ++j) {
        if (j < nk) {
          float vv[C::kEPL] = {};
          if (lane_on)
            reinterpret_cast<const Bits*>(sv + (row0 + j) * d + lane * C::kEPL)->unpack(vv);
#pragma unroll
          for (int g = 0; g < kG; ++g)
#pragma unroll
            for (int e = 0; e < C::kEPL; ++e) acc[g][e] = fmaf(pv[j * kG + g], vv[e], acc[g][e]);
        }
      }
      __syncwarp();  // every lane is done with the stage and with sP
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    }
  }
  __syncthreads();  // every tile consumed: the ring is free

  // merge the warps' states into the block's partial
  float* sAcc = reinterpret_cast<float*>(smem);  // [kConsumers][kG][D]
  if (warp < kConsumers) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float* dst = sAcc + (warp * kG + g) * D + lane * C::kEPL;
#pragma unroll
      for (int e = 0; e < C::kEPL; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
      if (lane == 0) {
        sM[warp][g] = m[g];
        sL[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  if (tid < kG) {  // row tid: the block's m and l, and each warp's factor
    float mx = -INFINITY, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) mx = fmaxf(mx, sM[w][tid]);
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      sM[w][tid] = mx == -INFINITY ? 0.f : expf(sM[w][tid] - mx);
      ls += sL[w][tid] * sM[w][tid];
    }
    sMx[tid] = mx;
    sLs[tid] = ls;
  }
  __syncthreads();
  const long long head = (long long)b * gridDim.y + blockIdx.y;  // (b, hk, row group)
  const bool single = p.n_split == 1;
  for (int i = tid; i < kG * D; i += kThreads) {
    const int g = i / D, c = i % D;
    const float mx = sMx[g], ls = sLs[g];
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) a += sAcc[(w * kG + g) * D + c] * sM[w][g];
    if (single) {
      if (!live(g) || c >= d) continue;
      p.out[(b * (long long)p.Hq + q0 + g) * d + c] =
          __float2bfloat16(ls == 0.f ? 0.f : a / ls);
      if (p.lse != nullptr && c == 0)
        p.lse[b * (long long)p.Hq + q0 + g] = ls == 0.f ? kEmptyRowLse : mx + logf(ls);
    } else {
      const long long row = (head * p.n_split + split) * kG + g;
      p.part_acc[row * D + c] = a;
      if (c == 0) {
        p.part_m[row] = mx;
        p.part_l[row] = ls;
      }
    }
  }
  if (single) return;

  // count this block in: one acquire-release add by thread 0 after the
  // barrier (releases the block's partial, acquires the others' for the
  // block that comes last); the last of the head's blocks merges
  __syncthreads();
  if (tid == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(p.counters + head) : "memory");
    sLast = prev == (unsigned)(p.n_split - 1);
  }
  __syncthreads();
  if (!sLast) return;
  // Merge in split order, kGroup splits at a time staged in the ring: their
  // acc rows by one bulk copy, m and l by loads issued beside it and beside
  // the pass that finds each row's largest m; then one factor exp(m - max
  // m) a (split, row), and sums in split order: l by the row's warp, acc
  // four neighbouring columns a thread.
  constexpr int kGroup = C::kRing / (kG * D * 4 + 2 * kG * 4);
  constexpr int kRowWarps = kThreads / 32;  // warps that take the rows' m and l
  float* sPa = reinterpret_cast<float*>(smem);  // [kGroup][kG][D]: acc rows
  float* sF = sPa + kGroup * kG * D;            // [kGroup][kG]: m, then factors
  float* sPl = sF + kGroup * kG;                // [kGroup][kG]: l
  const long long row0 = head * p.n_split * kG;
  if (tid == 0) {
    mbar_init(smem_u32(&staged), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto stage = [&](int s0) {
    const int ns = min(kGroup, p.n_split - s0);
    if (tid == 0) {
      // the partials were written by other blocks through the generic proxy
      // (acquired through the counter); the bulk copy reads through the
      // async proxy, so order the two first
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      const uint32_t bytes = ns * kG * D * 4;
      mbar_expect_tx(smem_u32(&staged), bytes);
      bulk_load(smem_u32(sPa), p.part_acc + (row0 + s0 * kG) * D, bytes, smem_u32(&staged));
    }
    for (int i = tid; i < ns * kG; i += kThreads) {
      sF[i] = __ldcg(p.part_m + row0 + s0 * kG + i);
      sPl[i] = __ldcg(p.part_l + row0 + s0 * kG + i);
    }
    return ns;
  };
  int ns = stage(0);
  for (int r = warp; r < kG; r += kRowWarps) {
    float mx = -INFINITY;
#pragma unroll 4
    for (int s = lane; s < p.n_split; s += 32)
      mx = fmaxf(mx, __ldcg(p.part_m + row0 + s * kG + r));
    mx = warp_max(mx);
    if (lane == 0) sMx[r] = mx;
  }
  // the thread's float4 columns: c = tid + i * kThreads of the kG * D / 4
  float4 a[C::kCols];
#pragma unroll
  for (int i = 0; i < C::kCols; ++i) a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < p.n_split; s0 += kGroup) {
    if (s0 > 0) ns = stage(s0);
    mbar_wait(smem_u32(&staged), (s0 / kGroup) & 1);
    __syncthreads();
    for (int i = tid; i < ns * kG; i += kThreads) {
      const float mx = sMx[i % kG];
      sF[i] = mx == -INFINITY ? 0.f : expf(sF[i] - mx);
    }
    __syncthreads();
    for (int r = warp; r < kG; r += kRowWarps) {
      float ls = 0.f;
      for (int s = lane; s < ns; s += 32) ls += sPl[s * kG + r] * sF[s * kG + r];
      ls = warp_sum(ls);
      if (lane == 0) sLs[r] = (s0 == 0 ? 0.f : sLs[r]) + ls;
    }
#pragma unroll
    for (int i = 0; i < C::kCols; ++i) {
      const int c = tid + i * kThreads, g = c * 4 / D, col = c * 4 % D;
      if (c < kG * D / 4) {
        for (int s = 0; s < ns; ++s) {
          const float f = sF[s * kG + g];
          const float4 x = *reinterpret_cast<const float4*>(sPa + (s * kG + g) * D + col);
          a[i].x += x.x * f;
          a[i].y += x.y * f;
          a[i].z += x.z * f;
          a[i].w += x.w * f;
        }
      }
    }
    __syncthreads();  // the group is merged: the ring may take the next
  }
#pragma unroll
  for (int i = 0; i < C::kCols; ++i) {
    const int c = tid + i * kThreads, g = c * 4 / D, col = c * 4 % D;
    if (c < kG * D / 4 && live(g) && col < d) {
      const float ls = sLs[g];
      __nv_bfloat16* o = p.out + (b * (long long)p.Hq + q0 + g) * d + col;
      store2(o, ls == 0.f ? 0.f : a[i].x / ls, ls == 0.f ? 0.f : a[i].y / ls);
      store2(o + 2, ls == 0.f ? 0.f : a[i].z / ls, ls == 0.f ? 0.f : a[i].w / ls);
    }
  }
  // the merged rows' log-sum-exp, in the units of K1's (scaled, softcapped
  // scores): what a merge of seq-cut caches weights this partial by
  if (p.lse != nullptr && tid < kG && live(tid))
    p.lse[b * (long long)p.Hq + q0 + tid] =
        sLs[tid] == 0.f ? kEmptyRowLse : sMx[tid] + logf(sLs[tid]);
  if (tid == 0) p.counters[head] = 0;  // ready for the next call on this stream
}

// Checks the plan against the kernel's limits, sets the shared-memory
// limit once, and launches one block per (split, KV head and row group,
// batch row).
template <int D, int G, bool kExact>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<D, G>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_sm90<D, G, kExact>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kMaxBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const bool groups_ok =
      kExact ? p.Hq == G * p.Hk && p.d == D && p.rg == G && p.n_groups == 1
             : p.Hk >= 1 && p.Hq % p.Hk == 0 && p.rg >= 1 && p.rg <= G && p.n_groups >= 1 &&
                   p.n_groups * p.rg >= p.Hq / p.Hk && (p.n_groups - 1) * p.rg < p.Hq / p.Hk &&
                   p.d >= 8 && p.d <= D && p.d % 8 == 0;
  if (!groups_ok || (long long)p.Hk * p.n_groups > 65535) return cudaErrorInvalidValue;
  if (p.S < 1 || p.chunk < 1 || p.chunk % C::kTile ||
      p.chunk > kMaxChunk || p.n_split < 1 || p.n_split > (p.S + C::kTile - 1) / C::kTile ||
      (long long)(p.chunk / C::kTile) * p.n_split < (p.S + C::kTile - 1) / C::kTile ||
      p.n_split > 65535 || p.B > 65535 ||
      (p.n_split > 1 && (p.counters == nullptr || p.part_m == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid(p.n_split, p.Hk * p.n_groups, p.B);
  const int bytes = C::kRing + (p.chunk + 15) / 16 * 16;
  decode_attention_sm90<D, G, kExact><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace decode_sm90
}  // namespace vidi
