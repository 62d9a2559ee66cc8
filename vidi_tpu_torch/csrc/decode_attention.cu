// K3: decode attention, one query token per row against a KV cache.
//
// Replaces the Pallas kernel vidi_tpu/ops/pallas/decode_attention.py
// (`decode_attention` -> `_kernel`): q [B,Hq,D] against the cache-native
// k/v [B,Hk,S,D], GQA group rows sharing one KV head, a bool / uint8
// kv_mask, logit softcap and the Gemma2 sliding window through q_pos
// (int32 or int64; key visible iff q_pos - key < window). Rows with no
// visible key give zeros. As in `_kernel`, each probability is rounded to
// the cache dtype before it weights V, and the row sum stays fp32. Asked
// for it (a non-null lse), both routes also write each row's log-sum-exp
// (K1's units; kEmptyRowLse for a row with no visible key), which the
// merge of a seq-cut cache's shards weights them by.
//
// What bounds it on an H100: every step reads the visible cache once (2*S*D
// elements per KV head) for 2*g*S*D FMAs, so it is bound by device-memory
// bandwidth. Both routes are built for row groups of kG in {1, 2, 4, 8}
// (Gemma2 has g = 2, Mistral-7B 4) and a few widths (sm90: 128, 256; SIMT:
// 64, 128, 256), and take any g = Hq / Hk and any head dim d <= 256 with
// d % 8 == 0: the wrapper (`decode_groups`, `WIDTHS`) cuts a KV head's g
// rows into n_groups groups of rg <= kG rows (G = 12: two groups of 6,
// each reading the KV head's tiles), and rows past rg and columns past d
// are computed as zeros and not stored. Two routes, chosen by dtype in
// ops/cuda/decode_attention.py:
// - bf16: `vidi_decode_attention_sm90`, the Hopper kernel of
//   decode_attention_sm90.cuh (bulk asynchronous copies of whole K/V tiles
//   into a shared-memory ring, a split plan that fills the card, masked
//   tiles skipped, the splits merged by the last block: one launch a call).
// - fp32: `vidi_decode_attention`, the SIMT kernels below, for the fp32
//   checks that hold the card against the CPU. Pass 1 gives each block one
//   chunk of keys for one (batch, KV head); its warps stream keys (one
//   2*D-element row per warp step, lanes on neighbouring addresses) and keep
//   fp32 online-softmax state for the g query rows in registers, then merge
//   into one partial (m, l, acc); pass 2 merges the partials of all chunks.
//
// Both entries take the same packed arguments (`DecodeArgs`); the partials
// and counters are the wrapper's workspace.
#include <stddef.h>

#include "attention_common.cuh"
#include "decode_attention_sm90.cuh"

namespace {

constexpr int kWarps = 4;

struct DecodeParams {
  const void* q;       // [B, Hq, d], last dim contiguous
  const void* k;       // [B, Hk, S, d], last dim contiguous
  const void* v;
  const unsigned char* kv_mask;  // [B, S] bytes, row stride mask_sb; nullptr = all valid
  const void* q_pos;   // [B] int32 or int64, stride qpos_s; read when window > 0
  float* part_m;       // [B, Hq, n_split]
  float* part_l;       // [B, Hq, n_split]
  float* part_acc;     // [B, Hq, n_split, D] (D: the compiled width)
  void* out;           // [B, Hq, d] contiguous
  float* lse;          // [B, Hq] contiguous, or nullptr: not written
  int B, Hq, Hk, S, n_split, chunk, qpos64;
  int d, rg, n_groups;  // head dim, rows a block takes, row groups a KV head
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long mask_sb, qpos_s;
  float scale, softcap;
  int window;
};

// One block: one chunk of keys for rows g < rg of row group grp of KV head
// hk (the grid's y is hk * n_groups + grp); a lane holds EPL columns, zeros
// past d.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32) decode_partial(DecodeParams p) {
  constexpr int EPL = D / 32;  // elements per lane
  static_assert(EPL % 2 == 0, "D must be a multiple of 64");
  __shared__ float sAcc[kWarps][G][D];
  __shared__ float sM[kWarps][G];
  __shared__ float sL[kWarps][G];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / p.n_groups, grp = blockIdx.y % p.n_groups;
  const int q0 = hk * (p.Hq / p.Hk) + grp * p.rg;  // query head of row 0
  const int rows = min(p.rg, p.Hq / p.Hk - grp * p.rg);  // rows the block stores
  const bool lane_on = lane * EPL < p.d;
  const int c0 = split * p.chunk, c1 = min(p.S, c0 + p.chunk);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh + lane * EPL;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh + lane * EPL;
  long long qpos = 0;
  if (p.window > 0)
    qpos = p.qpos64 ? static_cast<const long long*>(p.q_pos)[b * p.qpos_s]
                    : static_cast<const int*>(p.q_pos)[b * p.qpos_s];

  float qr[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qg = q + (q0 + g) * p.q_sh + lane * EPL;
    const bool on = g < rows && lane_on;
#pragma unroll
    for (int e = 0; e < EPL; e += 2) {
      const float2 x = on ? vidi::load2(qg + e) : make_float2(0.f, 0.f);
      qr[g][e] = x.x;
      qr[g][e + 1] = x.y;
      acc[g][e] = 0.f;
      acc[g][e + 1] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  for (int key = c0 + warp; key < c1; key += kWarps) {
    // warp-uniform skip: masked keys cost no cache read
    if (p.kv_mask != nullptr && p.kv_mask[b * p.mask_sb + key] == 0) continue;
    if (p.window > 0 && qpos - key >= p.window) continue;
    float kk[EPL], vv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; e += 2) {
      const float2 x = lane_on ? vidi::load2(k + key * p.k_ss + e) : make_float2(0.f, 0.f);
      const float2 y = lane_on ? vidi::load2(v + key * p.v_ss + e) : make_float2(0.f, 0.f);
      kk[e] = x.x; kk[e + 1] = x.y;
      vv[e] = y.x; vv[e + 1] = y.y;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kk[e], d);
      float s = vidi::warp_sum(d) * p.scale;
      if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float pr = expf(s - m_new);
      const float pv = vidi::round_to<T>(pr);  // P @ V in v's dtype, l in fp32
      l[g] = l[g] * alpha + pr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pv, vv[e], acc[g][e] * alpha);
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) sAcc[warp][g][lane * EPL + e] = acc[g][e];
    if (lane == 0) {
      sM[warp][g] = m[g];
      sL[warp][g] = l[g];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < rows * D; idx += kWarps * 32) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w][g]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(sM[w][g] - mx);
        lsum += sL[w][g] * f;
        a += sAcc[w][g][d] * f;
      }
    }
    const long long row = ((long long)b * p.Hq + q0 + g) * p.n_split + split;
    p.part_acc[row * D + d] = a;
    if (d == 0) {
      p.part_m[row] = mx;
      p.part_l[row] = lsum;
    }
  }
}

template <typename T, int D>
__global__ void decode_combine(DecodeParams p) {
  const int row = blockIdx.x;  // b * Hq + h
  const int d = threadIdx.x;
  const float* pm = p.part_m + (long long)row * p.n_split;
  const float* pl = p.part_l + (long long)row * p.n_split;
  const float* pa = p.part_acc + (long long)row * p.n_split * D;
  float mx = -INFINITY;
  for (int i = 0; i < p.n_split; ++i) mx = fmaxf(mx, pm[i]);
  float lsum = 0.f, a = 0.f;
  if (mx != -INFINITY) {
    for (int i = 0; i < p.n_split; ++i) {
      const float f = expf(pm[i] - mx);
      lsum += pl[i] * f;
      a += pa[(long long)i * D + d] * f;
    }
  }
  T* out = static_cast<T*>(p.out) + (long long)row * p.d;
  const float o = lsum == 0.f ? 0.f : a / lsum;
  if (p.lse != nullptr && d == 0) p.lse[row] = lsum == 0.f ? vidi::kEmptyRowLse : mx + logf(lsum);
  if (d >= p.d) return;
  if constexpr (sizeof(T) == 4) {
    out[d] = o;
  } else {
    out[d] = __float2bfloat16(o);
  }
}

template <typename T, int D, int G>
cudaError_t launch_simt(const DecodeParams& p, cudaStream_t s) {
  const int g = p.Hq / p.Hk;
  if (p.rg < 1 || p.rg > G || p.n_groups * p.rg < g || (p.n_groups - 1) * p.rg >= g ||
      p.d < 8 || p.d > D || p.d % 8 || (long long)p.Hk * p.n_groups > 65535)
    return cudaErrorInvalidValue;
  dim3 grid(p.n_split, p.Hk * p.n_groups, p.B);
  decode_partial<T, D, G><<<grid, kWarps * 32, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T, D><<<p.B * p.Hq, D, 0, s>>>(p);
  return cudaGetLastError();
}

// Row groups of kG = 1, 2 (Gemma2: Vidi1.5-9B at head dim 256, the 1.5B
// configuration at 128), 4 (Mistral-7B, 128) or 8 (any other g)
template <int D>
cudaError_t dispatch_simt_g(const DecodeParams& p, int kg, cudaStream_t s) {
  if (p.Hk < 1 || p.Hq % p.Hk) return cudaErrorInvalidValue;
  switch (kg) {
    case 1: return launch_simt<float, D, 1>(p, s);
    case 2: return launch_simt<float, D, 2>(p, s);
    case 4: return launch_simt<float, D, 4>(p, s);
    case 8: return launch_simt<float, D, 8>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_simt(const DecodeParams& p, int W, int kg, cudaStream_t s) {
  switch (W) {
    case 64: return dispatch_simt_g<64>(p, kg, s);
    case 128: return dispatch_simt_g<128>(p, kg, s);
    case 256: return dispatch_simt_g<256>(p, kg, s);
    default: return cudaErrorInvalidValue;
  }
}

// The exact build where the shapes are the compiled ones (d = D, one row
// group of kG = g rows; faster there, decode_attention_sm90.cuh), the
// general build otherwise.
template <int D, int kG>
cudaError_t launch_sm90(const vidi::decode_sm90::Params& p, cudaStream_t s) {
  using vidi::decode_sm90::launch;
  const bool exact = p.d == D && p.n_groups == 1 && p.rg == kG && p.Hk >= 1 &&
                     p.Hq == kG * p.Hk;
  return exact ? launch<D, kG, true>(p, s) : launch<D, kG, false>(p, s);
}

template <int D>
cudaError_t dispatch_sm90(const vidi::decode_sm90::Params& p, int kg, cudaStream_t s) {
  if (p.Hk < 1 || p.Hq % p.Hk) return cudaErrorInvalidValue;
  switch (kg) {
    case 1: return launch_sm90<D, 1>(p, s);
    case 2: return launch_sm90<D, 2>(p, s);
    case 4: return launch_sm90<D, 4>(p, s);
    case 8: return launch_sm90<D, 8>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The arguments of a K3 call, packed by the wrapper into one block
// (ops/cuda/decode_attention.py, `ARGS`: struct format "<11Q6i10q2f4i3i") so
// that a call crosses ctypes with two arguments instead of 37. D is the
// compiled width, d the head dim; kg, rg and n_groups the row groups
// (`decode_groups`).
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* kv_mask;
  const void* q_pos;
  float* part_m;
  float* part_l;
  float* part_acc;
  unsigned int* counters;
  void* out;
  float* lse;  // nullptr: no lse asked for
  int B, Hq, Hk, S, D, qpos64;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, mask_sb, qpos_s;
  float scale, softcap;
  int d, kg, rg, n_groups;
  int window, n_split, chunk;
};
static_assert(sizeof(DecodeArgs) == 232 && offsetof(DecodeArgs, q_sb) == 112 &&
                  offsetof(DecodeArgs, scale) == 192 && offsetof(DecodeArgs, d) == 200 &&
                  offsetof(DecodeArgs, chunk) == 224,
              "DecodeArgs must match the wrapper's packing");

// fp32 operands: the two-pass SIMT kernels (counters unused)
extern "C" int vidi_decode_attention(const DecodeArgs* a, void* stream) {
  DecodeParams p;
  p.q = a->q; p.k = a->k; p.v = a->v; p.kv_mask = a->kv_mask; p.q_pos = a->q_pos;
  p.part_m = a->part_m; p.part_l = a->part_l; p.part_acc = a->part_acc; p.out = a->out;
  p.lse = a->lse;
  p.B = a->B; p.Hq = a->Hq; p.Hk = a->Hk; p.S = a->S; p.n_split = a->n_split;
  p.chunk = a->chunk; p.qpos64 = a->qpos64;
  p.q_sb = a->q_sb; p.q_sh = a->q_sh;
  p.k_sb = a->k_sb; p.k_sh = a->k_sh; p.k_ss = a->k_ss;
  p.v_sb = a->v_sb; p.v_sh = a->v_sh; p.v_ss = a->v_ss;
  p.mask_sb = a->mask_sb; p.qpos_s = a->qpos_s;
  p.scale = a->scale; p.softcap = a->softcap; p.window = a->window;
  p.d = a->d; p.rg = a->rg; p.n_groups = a->n_groups;
  return static_cast<int>(dispatch_simt(p, a->D, a->kg, static_cast<cudaStream_t>(stream)));
}

// bf16 operands: the Hopper kernel, one launch a call (k_ss / v_ss must be
// d: the wrapper checks each (b, hk) block of k / v is contiguous)
extern "C" int vidi_decode_attention_sm90(const DecodeArgs* a, void* stream) {
  using vidi::decode_sm90::Params;
  if (a->k_ss != a->d || a->v_ss != a->d) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(a->q);
  p.k = static_cast<const __nv_bfloat16*>(a->k);
  p.v = static_cast<const __nv_bfloat16*>(a->v);
  p.kv_mask = a->kv_mask; p.q_pos = a->q_pos;
  p.part_m = a->part_m; p.part_l = a->part_l; p.part_acc = a->part_acc;
  p.counters = a->counters;
  p.out = static_cast<__nv_bfloat16*>(a->out);
  p.lse = a->lse;
  p.B = a->B; p.Hq = a->Hq; p.Hk = a->Hk; p.S = a->S; p.n_split = a->n_split;
  p.chunk = a->chunk; p.qpos64 = a->qpos64;
  p.q_sb = a->q_sb; p.q_sh = a->q_sh; p.k_sb = a->k_sb; p.k_sh = a->k_sh;
  p.v_sb = a->v_sb; p.v_sh = a->v_sh; p.mask_sb = a->mask_sb; p.qpos_s = a->qpos_s;
  p.scale = a->scale; p.softcap = a->softcap; p.window = a->window;
  p.d = a->d; p.rg = a->rg; p.n_groups = a->n_groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->D) {
    case 128: return static_cast<int>(dispatch_sm90<128>(p, a->kg, s));
    case 256: return static_cast<int>(dispatch_sm90<256>(p, a->kg, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
