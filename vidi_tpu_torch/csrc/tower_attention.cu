// K2: maskless, non-causal multi-head attention for the encoder towers.
//
// Replaces the Pallas kernels of vidi_tpu/ops/pallas/tower_attention.py
// (`tower_attention` with its packed / fullwidth / generic layouts). Those
// layouts exist for the TPU's 128-lane tiling; here one layout reads the
// projections in place as [B, T, H*D] (strided [B,T,H,D]) for any T and any
// D % 8 == 0 up to 256, on kernels compiled for the widths 64, 72, 128 and
// 256 (SigLIP-so400m: T = 729, 16 heads x 72; Whisper-large-v3: T = 1500,
// 20 heads x 64; CLIP ViT-L/14 64, ViT-H/14 80, ViT-bigG/14 104).
//
// What bounds it on an H100: 4*T*T*D operations per (batch, head) against
// 4*T*D bytes of q, k, v and out, so it is bound by operations (SigLIP's
// 4 frames: 1.0e10 operations, 0.010 ms at the bf16 tensor-core peak). The
// TPU kernel holds a whole T x T fp32 score block in VMEM; at T = 1500 that
// is 9 MB against a block's 227 KB of shared memory, so the kernels here
// stream K/V tiles with an online softmax instead.
//
// Two routes, chosen by dtype in ops/cuda/tower_attention.py:
// - bf16: `vidi_tower_attention_sm90`, the Hopper kernel of
//   flash_forward_sm90.cuh: both products on wgmma (tensor cores, the
//   operations that bound it), 128 query rows per block, K/V tiles of 128
//   keys loaded by TMA into a two-stage ring ahead of the products. SigLIP's
//   72-column heads load in 8-column boxes and pad Q K^T's depth to 80 with
//   zeros in shared memory.
// - fp32: `vidi_tower_attention`, the SIMT template of attention_common.cuh
//   (fp32 FMAs), for the fp32 card-vs-CPU checks.
#include "attention_common.cuh"
#include "flash_forward_sm90.cuh"

namespace {

vidi::FlashParams params(const void* q, const void* k, const void* v, void* out, int B, int T,
                         int S, int H, int d, long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                         long long v_ss, long long v_sh, float scale) {
  vidi::FlashParams p;
  p.q = q; p.k = k; p.v = v;
  p.kv_mask = nullptr; p.q_segs = nullptr; p.kv_segs = nullptr;
  p.out = out; p.lse = nullptr;
  p.B = B; p.T = T; p.S = S; p.Hq = H; p.Hk = H; p.d = d;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = scale; p.causal = 0; p.window = 0; p.softcap = 0.f;
  p.n_split = 1; p.kv_split = S;  // frames x heads x row tiles fill the SMs
  p.part_m = p.part_l = p.part_acc = nullptr;
  return p;
}

}  // namespace

#define VIDI_K2_ARGS                                                                   \
  const void *q, const void *k, const void *v, void *out, int B, int T, int S, int H, \
      int W, int d, long long q_sb, long long q_st, long long q_sh, long long k_sb,          \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh, \
      float scale, void *stream
#define VIDI_K2_PARAMS \
  params(q, k, v, out, B, T, S, H, d, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale)

// Both entries take the head dim d and the compiled width W >= d the
// wrapper chose for it (ops/cuda/flash_attention.py, `WIDTHS`).

// fp32 operands: the SIMT template, 32 rows per block.
extern "C" int vidi_tower_attention(VIDI_K2_ARGS) {
  const vidi::FlashParams p = VIDI_K2_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64: return static_cast<int>(vidi::launch_flash_forward<float, 64, 32, 64, 128>(p, s));
    case 72: return static_cast<int>(vidi::launch_flash_forward<float, 72, 32, 64, 128>(p, s));
    case 128: return static_cast<int>(vidi::launch_flash_forward<float, 128, 32, 64, 128>(p, s));
    case 256: return static_cast<int>(vidi::launch_flash_forward<float, 256, 32, 64, 128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 operands: the Hopper kernel. Widths 64 (Whisper, CLIP) and 72
// (SigLIP) are compiled here, 128 and 256 beside K1.
namespace vidi {
namespace sm90 {
template cudaError_t launch<64>(const FlashParams&, cudaStream_t);
template cudaError_t launch<72>(const FlashParams&, cudaStream_t);
}  // namespace sm90
}  // namespace vidi

extern "C" int vidi_tower_attention_sm90(VIDI_K2_ARGS) {
  const vidi::FlashParams p = VIDI_K2_PARAMS;
  return static_cast<int>(vidi::sm90::launch_width(p, W, static_cast<cudaStream_t>(stream)));
}
