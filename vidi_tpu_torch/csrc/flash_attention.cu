// K1: flash attention forward for the Dattn decoder.
//
// Replaces the Pallas kernel vidi_tpu/ops/pallas/flash_attention.py
// (`flash_attention` -> `_flash_forward` -> `_fwd_kernel`): blocked
// online-softmax attention of q [B,T,Hq,D] against k/v [B,S,Hk,D] with GQA
// (query head h reads KV head h // (Hq/Hk), no repeated KV), causal masking,
// the Gemma2 sliding window by absolute index, logit softcap, a bool
// kv_mask and packing segment ids. It returns the output and the logsumexp
// [B,Hq,T]; rows with no visible key give zeros and the sentinel lse
// 0.7 * FLT_MAX, as the Pallas kernel does. Both routes skip the key tiles
// outside a block's causal / window band and, with segment ids, the tiles
// whose ids cannot meet its rows' (the Pallas kernel's `_seg_overlap`), so
// packed rows cost about the sum of each segment's length squared.
//
// What bounds it on an H100: the cross attention of 128 text rows against
// 23,520 video keys (D = 256, 16 query / 8 KV heads) moves 192 MB of K/V for
// 4.0e10 operations, so it is bound by bytes (0.058 ms at 3.35 TB/s); the
// text self attention (T = S = 128) is bound by its launch.
//
// Two routes, chosen by dtype in ops/cuda/flash_attention.py:
// - bf16: `vidi_flash_attention_fwd_sm90`, the Hopper kernel of
//   flash_forward_sm90.cuh. Both products run on wgmma; the g = Hq / Hk
//   query heads of a KV head share one block's 128 rows, so each K/V tile
//   crosses shared memory once for all of them (and the 9B's 8 KV heads x
//   256 rows give 16 blocks); TMA loads K/V into a two-stage ring ahead of
//   the products. Too few blocks for 132 SMs: the wrapper splits S so that
//   one wave fills the card, and flash_combine merges the partial states.
// - fp32: `vidi_flash_attention_fwd`, the SIMT template of
//   attention_common.cuh (fp32 FMAs, 16-row tiles), for the fp32 checks that
//   hold the card against the CPU at 1e-3 and finer, which TF32 would miss.
#include "attention_common.cuh"
#include "flash_forward_sm90.cuh"

namespace {

vidi::FlashParams params(const void* q, const void* k, const void* v,
                         const unsigned char* kv_mask,
                         const int* q_segs, const int* kv_segs, void* out, float* lse, int B,
                         int T, int S, int Hq, int Hk, int d, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh, float scale,
                         int causal, int window, float softcap, int n_split, int kv_split,
                         float* part_m, float* part_l, float* part_acc) {
  vidi::FlashParams p;
  p.q = q; p.k = k; p.v = v;
  p.kv_mask = kv_mask; p.q_segs = q_segs; p.kv_segs = kv_segs;
  p.out = out; p.lse = lse;
  p.B = B; p.T = T; p.S = S; p.Hq = Hq; p.Hk = Hk; p.d = d;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = scale; p.causal = causal; p.window = window; p.softcap = softcap;
  p.n_split = n_split; p.kv_split = kv_split;
  p.part_m = part_m; p.part_l = part_l; p.part_acc = part_acc;
  return p;
}

}  // namespace

#define VIDI_K1_ARGS                                                                    \
  const void *q, const void *k, const void *v, const unsigned char *kv_mask,           \
      const int *q_segs,                                                              \
      const int *kv_segs, void *out, float *lse, int B, int T, int S, int Hq, int Hk,  \
      int W, int d, long long q_sb, long long q_st, long long q_sh, long long k_sb,           \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,  \
      float scale, int causal, int window, float softcap, int n_split, int kv_split,   \
      float *part_m, float *part_l, float *part_acc, void *stream
#define VIDI_K1_PARAMS                                                                  \
  params(q, k, v, kv_mask, q_segs, kv_segs, out, lse, B, T, S, Hq, Hk, d, q_sb, q_st, q_sh, \
         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, window, softcap, n_split,   \
         kv_split, part_m, part_l, part_acc)

// Both entries take the head dim d and the compiled width W >= d the
// wrapper chose for it (ops/cuda/flash_attention.py, `WIDTHS`).

// fp32 operands: the SIMT template. BQ = 16 query rows per block: the text
// side has T = 128, so wider tiles would leave most of the 132 SMs idle.
extern "C" int vidi_flash_attention_fwd(VIDI_K1_ARGS) {
  const vidi::FlashParams p = VIDI_K1_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64: return static_cast<int>(vidi::launch_flash_forward<float, 64, 16, 64, 128>(p, s));
    case 72: return static_cast<int>(vidi::launch_flash_forward<float, 72, 16, 64, 128>(p, s));
    case 128: return static_cast<int>(vidi::launch_flash_forward<float, 128, 16, 64, 128>(p, s));
    case 256: return static_cast<int>(vidi::launch_flash_forward<float, 256, 16, 64, 128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 operands: the Hopper kernel. Widths 256 (Vidi1.5-9B) and 128 (the
// 1.5B configuration, Mistral) are compiled here, 64 and 72 beside K2.
namespace vidi {
namespace sm90 {
template cudaError_t launch<128>(const FlashParams&, cudaStream_t);
template cudaError_t launch<256>(const FlashParams&, cudaStream_t);
}  // namespace sm90
}  // namespace vidi

extern "C" int vidi_flash_attention_fwd_sm90(VIDI_K1_ARGS) {
  const vidi::FlashParams p = VIDI_K1_PARAMS;
  return static_cast<int>(vidi::sm90::launch_width(p, W, static_cast<cudaStream_t>(stream)));
}
