"""Model / framework configuration dataclasses.

These are frozen (hashable) so they can be passed as static args through
`jax.jit`. They replace the reference's HF config-class-attribute scheme
(reference: Vidi1.5_9B/vidi/model/lmm/dattn/gemma.py:427-448 DattnGemma2Config
and the HfArgumentParser dataclasses in vidi/train/train.py:37-89).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Decoder backbone hyper-parameters (Gemma2 / Mistral families)."""

    arch: str = "gemma2"
    vocab_size: int = 256000
    hidden_size: int = 3584
    num_layers: int = 42
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 256
    intermediate_size: int = 14336
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    # Gemma2 alternates sliding-window / global layers; even layers slide
    # (reference: gemma.py:104 `is_sliding = not bool(layer_idx % 2)`).
    sliding_window: Optional[int] = 4096
    attn_softcap: Optional[float] = 50.0
    final_softcap: Optional[float] = 30.0
    # Gemma2 scales queries by query_pre_attn_scalar**-0.5 instead of head_dim.
    query_scale: Optional[float] = None  # None -> head_dim**-0.5
    # Gemma2 multiplies embeddings (and modality embeds) by sqrt(hidden_size)
    # (reference: gemma.py:353-356).
    embed_scale: bool = True
    hidden_act: str = "gelu_tanh"  # gemma2: gelu_pytorch_tanh; mistral: silu
    # Gemma2 has pre/post norms around both attention and FFN (4 norms/layer);
    # Mistral has the classic 2-norm pre-norm layer.
    double_norms: bool = True
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 8192

    @property
    def q_scale(self) -> float:
        if self.query_scale is not None:
            return self.query_scale
        return self.head_dim**-0.5

    @staticmethod
    def gemma2_9b() -> "TextConfig":
        return TextConfig(query_scale=256.0**-0.5)

    @staticmethod
    def mistral_7b() -> "TextConfig":
        return TextConfig(
            arch="mistral",
            vocab_size=32000,
            hidden_size=4096,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            intermediate_size=14336,
            rope_theta=10000.0,
            rms_norm_eps=1e-5,
            sliding_window=4096,
            attn_softcap=None,
            final_softcap=None,
            embed_scale=False,
            hidden_act="silu",
            double_norms=False,
            tie_word_embeddings=False,
            max_position_embeddings=32768,
        )

    @staticmethod
    def tiny(arch: str = "gemma2") -> "TextConfig":
        base = TextConfig.gemma2_9b() if arch == "gemma2" else TextConfig.mistral_7b()
        return dataclasses.replace(
            base,
            vocab_size=512,
            hidden_size=64,
            num_layers=4,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            intermediate_size=128,
            sliding_window=16 if base.sliding_window else None,
        )


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """ViT vision tower — SigLIP (reference: vidi/model/mm_vision/siglip.py)
    or CLIP (reference: Vidi_7B/model/mm_vision/clip.py; CLIP adds a class
    token, a post-embedding pre-layernorm, and quick-gelu)."""

    arch: str = "siglip"  # "siglip" | "clip"
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    patch_size: int = 14
    image_size: int = 384
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_tanh"  # clip: "quick_gelu"
    # hidden_states[select_layer] with hidden_states = [embeds, layer0, ...];
    # -2 means output of the second-to-last encoder layer (siglip.py:30-36).
    select_layer: int = -2

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side**2

    @staticmethod
    def siglip2_so400m() -> "VisionConfig":
        return VisionConfig()

    @staticmethod
    def clip_vit_l14() -> "VisionConfig":
        """openai/clip-vit-large-patch14 — the Vidi_7B default tower
        (reference: Vidi_7B/model/lmm/dattn/mistral.py:460)."""
        return VisionConfig(
            arch="clip",
            hidden_size=1024,
            num_layers=24,
            num_heads=16,
            intermediate_size=4096,
            patch_size=14,
            image_size=224,
            layer_norm_eps=1e-5,
            hidden_act="quick_gelu",
        )

    @staticmethod
    def tiny(arch: str = "siglip") -> "VisionConfig":
        return VisionConfig(
            arch=arch,
            hidden_size=32,
            num_layers=3,
            num_heads=2,
            intermediate_size=64,
            patch_size=14,
            image_size=42,  # 3x3 patches -> pads to 4x4 like 27 -> 28
            layer_norm_eps=1e-6 if arch == "siglip" else 1e-5,
            hidden_act="gelu_tanh" if arch == "siglip" else "quick_gelu",
        )


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Whisper encoder tower (reference: vidi/model/mm_audio/whisper.py)."""

    d_model: int = 1280
    num_layers: int = 32
    num_heads: int = 20
    ffn_dim: int = 5120
    num_mel_bins: int = 128
    max_source_positions: int = 1500
    # Mel frontend (matches WhisperFeatureExtractor defaults).
    sampling_rate: int = 16000
    hop_length: int = 160
    n_fft: int = 400
    chunk_length_s: int = 30

    @property
    def n_samples(self) -> int:
        return self.sampling_rate * self.chunk_length_s

    @property
    def nb_max_frames(self) -> int:
        return self.n_samples // self.hop_length

    @staticmethod
    def whisper_large_v3() -> "AudioConfig":
        return AudioConfig()

    @staticmethod
    def tiny() -> "AudioConfig":
        return AudioConfig(
            d_model=32,
            num_layers=2,
            num_heads=2,
            ffn_dim=64,
            num_mel_bins=128,
            max_source_positions=1500,
        )


@dataclasses.dataclass(frozen=True)
class DattnConfig:
    """Full multimodal Dattn LMM configuration.

    mm_* fields mirror reference defaults (gemma.py:427-448, finetune.sh:17-27).
    """

    text: TextConfig = dataclasses.field(default_factory=TextConfig.gemma2_9b)
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig.siglip2_so400m)
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig.whisper_large_v3)

    # Adapter generation: "v1.5" = 9B-style (pad+resize+space_to_depth pool,
    # Conv1d d_aud->d_llm audio pool); "v1" = 7B-style (strided Conv2d +
    # bilinear-align-corners pool to a fixed side, Conv1d d_aud->d_aud audio
    # pool then a d_aud->d_llm projector). Reference: Vidi_7B/model/mm_vision/
    # pool.py vs Vidi1.5_9B/vidi/model/mm_vision/pool.py.
    mm_version: str = "v1.5"
    mm_input_type: str = "video"  # "video" | "image"
    mm_projector_depth: int = 2  # "mlp2x_gelu"
    mm_image_pool_size: int = 2
    mm_audio_pool_size: int = 5
    mm_time_interval: int = 1024  # anchor count for the temporal pos-embed
    mm_std: Optional[float] = 0.028976401314139366
    mm_rms_eps: float = 1e-5
    # Token budget: video tokens capped at max_mm_tokens * pool_size**2
    # (reference: multimodal.py:175-180).
    mm_max_tokens_base: int = 60000
    mm_image_aspect_ratio: str = "resize"
    mm_image_grid_points: Tuple[Tuple[int, int], ...] = (
        (1, 2), (2, 1), (2, 2), (1, 3), (3, 1), (1, 4), (4, 1),
    )

    loss_thres: Optional[float] = 0.1
    model_max_length: int = 4096

    @property
    def mm_max_tokens(self) -> int:
        return self.mm_max_tokens_base * self.mm_image_pool_size**2

    @staticmethod
    def vidi15_9b() -> "DattnConfig":
        return DattnConfig()

    @staticmethod
    def vidi_7b() -> "DattnConfig":
        """Vidi-7B: Mistral backbone + CLIP tower + v1 adapters. The pool
        side / time interval come from the released checkpoint's HF config;
        these are the class defaults (mistral.py:456-477) with a working
        pool size for from-scratch runs."""
        return DattnConfig(
            text=TextConfig.mistral_7b(),
            vision=VisionConfig.clip_vit_l14(),
            mm_version="v1",
            mm_image_pool_size=8,
            mm_std=None,
            loss_thres=None,
        )

    @staticmethod
    def bench_1_5b() -> "DattnConfig":
        """~1.5B-scale Dattn with the 9B's structure — the single-chip bench
        geometry (bench.py) and the --random-weights 1.5b serving model:
        fits one v5e in bf16 WITH hour-scale KV caches, unlike the 9B."""
        return DattnConfig(
            text=TextConfig(
                arch="gemma2", vocab_size=32768, hidden_size=1536,
                num_layers=12, num_heads=12, num_kv_heads=6, head_dim=128,
                intermediate_size=6144, sliding_window=4096,
                attn_softcap=50.0, final_softcap=30.0,
                query_scale=128.0**-0.5,
            ),
            vision=VisionConfig(hidden_size=768, num_layers=12, num_heads=12,
                                intermediate_size=3072, patch_size=14,
                                image_size=384),
            audio=AudioConfig(d_model=768, num_layers=8, num_heads=12,
                              ffn_dim=3072),
            mm_time_interval=1024,
        )

    @staticmethod
    def tiny(arch: str = "gemma2") -> "DattnConfig":
        if arch == "gemma2":
            return DattnConfig(
                text=TextConfig.tiny(arch),
                vision=VisionConfig.tiny(),
                audio=AudioConfig.tiny(),
                mm_time_interval=16,
                model_max_length=128,
            )
        return DattnConfig(
            text=TextConfig.tiny(arch),
            vision=VisionConfig.tiny("clip"),
            audio=AudioConfig.tiny(),
            mm_version="v1",
            mm_image_pool_size=2,
            mm_std=None,
            loss_thres=None,
            mm_time_interval=16,
            model_max_length=128,
        )
