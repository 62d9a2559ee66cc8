// K1: flash attention forward for the Dattn decoder.
//
// Replaces the Pallas kernel vidi_tpu/ops/pallas/flash_attention.py
// (`flash_attention` -> `_flash_forward` -> `_fwd_kernel`): blocked
// online-softmax attention of q [B,T,Hq,D] against k/v [B,S,Hk,D] with GQA
// (query head h reads KV head h // (Hq/Hk), no repeated KV), causal masking,
// the Gemma2 sliding window by absolute index, logit softcap, an int32
// kv_mask and packing segment ids (masking only). It returns the output and
// the logsumexp [B,Hq,T]; rows with no visible key give zeros and the
// sentinel lse 0.7 * FLT_MAX, as the Pallas kernel does.
//
// What bounds it on an H100: at the slice's shapes (T = 128 text rows
// against S = 23,520 video keys, D = 256) the work is 2*T*S*D FMAs per head
// while the K/V bytes are read once per query tile, so it is compute-bound;
// written in SIMT fp32 FMAs it runs far below the tensor cores' rate. The
// design keeps the score matrix out of device memory (one BK-key tile at a
// time in shared memory), reuses each staged K/V element for a whole query
// tile, and skips tiles outside the causal/window band. One block per
// (b, h, 16-row query tile) gives only 128 blocks at T = 128 on 132 SMs, so
// when that would leave the SMs idle the wrapper also splits S across
// blocks and a merge pass combines their partial (m, l, acc) states. Moving
// the two products to wgmma is the next step.
#include "attention_common.cuh"

namespace {

template <typename T>
cudaError_t dispatch(const vidi::FlashParams& p, int D, cudaStream_t s) {
  // BQ = 16 query rows per block: the text side has T = 128 (a TR prompt
  // padded to 64), so wider tiles would leave most of the 132 SMs idle.
  // Head dims: 256 (Vidi1.5-9B) and
  // 128 (the 1.5B configuration).
  switch (D) {
    case 128: return vidi::launch_flash_forward<T, 128, 16, 64, 128>(p, s);
    case 256: return vidi::launch_flash_forward<T, 256, 16, 64, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vidi_flash_attention_fwd(
    const void* q, const void* k, const void* v, const int* kv_mask,
    const int* q_segs, const int* kv_segs, void* out, float* lse,
    int B, int T, int S, int Hq, int Hk, int D, int is_bf16,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal, int window, float softcap,
    int n_split, int kv_split, float* part_m, float* part_l, float* part_acc,
    void* stream) {
  vidi::FlashParams p;
  p.q = q; p.k = k; p.v = v;
  p.kv_mask = kv_mask; p.q_segs = q_segs; p.kv_segs = kv_segs;
  p.out = out; p.lse = lse;
  p.B = B; p.T = T; p.S = S; p.Hq = Hq; p.Hk = Hk;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = scale; p.causal = causal; p.window = window; p.softcap = softcap;
  p.n_split = n_split; p.kv_split = kv_split;
  p.part_m = part_m; p.part_l = part_l; p.part_acc = part_acc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, D, s) : dispatch<float>(p, D, s);
  return static_cast<int>(err);
}
