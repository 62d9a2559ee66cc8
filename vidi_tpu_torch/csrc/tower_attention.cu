// K2: maskless, non-causal multi-head attention for the encoder towers.
//
// Replaces the Pallas kernels of vidi_tpu/ops/pallas/tower_attention.py
// (`tower_attention` with its packed / fullwidth / generic layouts). Those
// layouts exist for the TPU's 128-lane tiling; here one layout reads the
// projections in place as [B, T, H*D] (strided [B,T,H,D]) for any T and
// D in {64, 72} (SigLIP-so400m: T = 729, 16 heads x 72; Whisper-large-v3:
// T = 1500, 20 heads x 64).
//
// What bounds it on an H100: 2*T*T*D FMAs per (batch, head) against
// 3*T*D bf16 reads, so it is compute-bound. The TPU kernel holds a whole
// T x T fp32 score block in VMEM; at T = 1500 that is 9 MB against a block's
// 227 KB of shared memory, so this kernel streams K/V tiles with an online
// softmax instead (the flash_forward template it shares with K1, with no
// mask and no cap). SIMT fp32 FMAs: tensor-core tiles are later work.
#include "attention_common.cuh"

namespace {

template <typename T>
cudaError_t dispatch(const vidi::FlashParams& p, int D, cudaStream_t s) {
  // BQ = 32 rows per block: T is long here, and wider tiles read each
  // staged K/V element for more rows.
  switch (D) {
    case 64: return vidi::launch_flash_forward<T, 64, 32, 64, 128>(p, s);
    case 72: return vidi::launch_flash_forward<T, 72, 32, 64, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vidi_tower_attention(
    const void* q, const void* k, const void* v, void* out,
    int B, int T, int S, int H, int D, int is_bf16,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  vidi::FlashParams p;
  p.q = q; p.k = k; p.v = v;
  p.kv_mask = nullptr; p.q_segs = nullptr; p.kv_segs = nullptr;
  p.out = out; p.lse = nullptr;
  p.B = B; p.T = T; p.S = S; p.Hq = H; p.Hk = H;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = scale; p.causal = 0; p.window = 0; p.softcap = 0.f;
  p.n_split = 1; p.kv_split = S;  // frames x heads x row tiles fill the SMs
  p.part_m = p.part_l = p.part_acc = nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, D, s) : dispatch<float>(p, D, s);
  return static_cast<int>(err);
}
