"""Model loading for the port: HF-format Vidi checkpoints, assembly from a
base LLM and tower checkpoints, or random-weight test models (port of
vidi_tpu/infer/loader.py).

`load_model(model_path=...)` reads `config.json` and every `*.safetensors`
shard of the directory (`safetensors_io`, the port's own reader: no
`safetensors` package is needed) and converts the weights tensor by
tensor straight onto `device` (`infer/convert.py`), so neither a host copy
of the model nor an fp32 staging of it is ever made. With
`mm_vision_tower`, `model_path` is a plain Gemma2 / Mistral checkpoint and
the model is assembled (`assemble_model`).

`load_model(random_weights="tiny" | "9b" | "1.5b" | "7b" | "tiny7b")` builds
the configuration (`DattnConfig.tiny`, `vidi15_9b`, `bench_1_5b`,
`vidi_7b`, `tiny("mistral")`) and draws random weights
directly on `device` in `dtype` from `seed` -- a host-side fp32 init of the
9B would need ~41 GB of RAM.

`load_8bit` / `load_4bit` quantize the text decoder's layer matmuls (and an
untied lm_head) to int8 / group-wise int4 and `load_8bit_towers` the encoder
towers to int8 (the reference's bitsandbytes options), layer by layer as
each layer arrives, so the full-precision model never lies whole on the
device beside its quantized copy.

`load_model(..., mesh=)` (a `core.mesh.Mesh` of several ranks) returns
this rank's shards (`parallel.sharding.shard_params`): each layer is cut
as it is drawn or read (`sharding.layer_sharder`) and every other leaf
once it is made, so a model larger than one card never stages whole on
one. Quantized weights under such a mesh are ROADMAP Q1.16c.

Tokenizer: a directory without tokenizer files gives the byte tokenizer,
with a printed note; one with them needs `transformers`, imported only
then, and raises ImportError naming it when it is missing.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from vidi_tpu_torch.core.config import AudioConfig, DattnConfig, TextConfig, VisionConfig
from vidi_tpu_torch.infer import quantize as qz
from vidi_tpu_torch.infer.convert import (convert_clip, convert_dattn, convert_siglip,
                                          convert_text, convert_whisper)
from vidi_tpu_torch.infer.safetensors_io import load_safetensors_dir
from vidi_tpu_torch.media.text import ByteTokenizer
from vidi_tpu_torch.models import dattn, whisper

CONFIGS = {
    "tiny": DattnConfig.tiny,
    "9b": DattnConfig.vidi15_9b,
    "1.5b": DattnConfig.bench_1_5b,
    "7b": DattnConfig.vidi_7b,
    "tiny7b": lambda: DattnConfig.tiny("mistral"),
}
TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")
MAX_TRIES = 5  # weight loads retried on errors other than a layout's


def resolve_device(device) -> torch.device:
    """torch.device from a name; a CUDA device without a card raises (the
    port never drops to the CPU behind the caller's back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    return dev


def config_from_hf(cfg_json: dict) -> DattnConfig:
    """Map a DattnGemma2Config / DattnMistral config.json onto DattnConfig."""
    arch = "gemma2" if "gemma" in cfg_json.get("model_type", "gemma2") else "mistral"
    if arch == "gemma2":
        text = TextConfig(
            arch="gemma2",
            vocab_size=cfg_json.get("vocab_size", 256000),
            hidden_size=cfg_json.get("hidden_size", 3584),
            num_layers=cfg_json.get("num_hidden_layers", 42),
            num_heads=cfg_json.get("num_attention_heads", 16),
            num_kv_heads=cfg_json.get("num_key_value_heads", 8),
            head_dim=cfg_json.get("head_dim", 256),
            intermediate_size=cfg_json.get("intermediate_size", 14336),
            rope_theta=cfg_json.get("rope_theta", 10000.0),
            rms_norm_eps=cfg_json.get("rms_norm_eps", 1e-6),
            sliding_window=cfg_json.get("sliding_window", 4096),
            attn_softcap=cfg_json.get("attn_logit_softcapping", 50.0),
            final_softcap=cfg_json.get("final_logit_softcapping", 30.0),
            query_scale=cfg_json.get("query_pre_attn_scalar", 256) ** -0.5,
        )
    else:
        base = TextConfig.mistral_7b()
        text = dataclasses.replace(
            base,
            vocab_size=cfg_json.get("vocab_size", base.vocab_size),
            hidden_size=cfg_json.get("hidden_size", base.hidden_size),
            num_layers=cfg_json.get("num_hidden_layers", base.num_layers),
            num_heads=cfg_json.get("num_attention_heads", base.num_heads),
            num_kv_heads=cfg_json.get("num_key_value_heads", base.num_kv_heads),
            head_dim=cfg_json.get("head_dim", base.head_dim),
            intermediate_size=cfg_json.get("intermediate_size", base.intermediate_size),
            rope_theta=cfg_json.get("rope_theta", base.rope_theta),
            rms_norm_eps=cfg_json.get("rms_norm_eps", base.rms_norm_eps),
            sliding_window=cfg_json.get("sliding_window", base.sliding_window),
        )
    mm_version = "v1.5" if arch == "gemma2" else "v1"
    # checkpoints written by save_pretrained carry explicit geometry
    # (infer/export.py); released Vidi checkpoints name towers by hub id only
    if "vidi_tpu_text" in cfg_json:
        tt = cfg_json["vidi_tpu_text"]
        mm_version = tt.get("mm_version", mm_version)
        text = dataclasses.replace(
            text, embed_scale=tt["embed_scale"], hidden_act=tt["hidden_act"],
            double_norms=tt["double_norms"], query_scale=tt["query_scale"],
            tie_word_embeddings=cfg_json.get(
                "tie_word_embeddings", text.tie_word_embeddings))
    if "vidi_tpu_vision" in cfg_json:
        vision = VisionConfig(**cfg_json["vidi_tpu_vision"])
    else:
        vision_name = cfg_json.get("mm_vision_tower", "") or ""
        if "clip" in vision_name.lower() or (arch == "mistral" and not vision_name):
            vision = VisionConfig.clip_vit_l14()
        else:
            vision = VisionConfig.siglip2_so400m()
    audio = (AudioConfig(**cfg_json["vidi_tpu_audio"])
             if "vidi_tpu_audio" in cfg_json
             else AudioConfig.whisper_large_v3())
    default_pool = 2 if mm_version == "v1.5" else 8
    return DattnConfig(
        text=text,
        vision=vision,
        audio=audio,
        mm_version=mm_version,
        mm_image_pool_size=cfg_json.get("mm_image_pool_size", default_pool)
        or default_pool,
        mm_audio_pool_size=cfg_json.get("mm_audio_pool_size", 5) or 5,
        mm_time_interval=cfg_json.get("mm_time_interval", 1024) or 1024,
        mm_std=cfg_json.get("mm_std"),
        mm_input_type=cfg_json.get("mm_input_type", "video"),
        mm_image_aspect_ratio=cfg_json.get("mm_image_aspect_ratio", "resize"),
        loss_thres=cfg_json.get("loss_thres"),
        model_max_length=cfg_json.get("model_max_length", 4096),
    )


def vision_config_from_hf(cfg_json: dict) -> VisionConfig:
    """HF SiglipVisionConfig / CLIPVisionConfig (possibly nested under
    "vision_config" in a combined model config) -> VisionConfig."""
    if "vision_config" in cfg_json:
        model_type = cfg_json.get("model_type", "")
        cfg_json = dict(cfg_json["vision_config"])
        cfg_json.setdefault("model_type", model_type)
    arch = "clip" if "clip" in cfg_json.get("model_type", "") else "siglip"
    base = (VisionConfig.clip_vit_l14() if arch == "clip"
            else VisionConfig.siglip2_so400m())
    act = {"gelu_pytorch_tanh": "gelu_tanh", "quick_gelu": "quick_gelu",
           "gelu_tanh": "gelu_tanh"}.get(
        cfg_json.get("hidden_act", base.hidden_act), base.hidden_act)
    return VisionConfig(
        arch=arch,
        hidden_size=cfg_json.get("hidden_size", base.hidden_size),
        num_layers=cfg_json.get("num_hidden_layers", base.num_layers),
        num_heads=cfg_json.get("num_attention_heads", base.num_heads),
        intermediate_size=cfg_json.get("intermediate_size", base.intermediate_size),
        patch_size=cfg_json.get("patch_size", base.patch_size),
        image_size=cfg_json.get("image_size", base.image_size),
        layer_norm_eps=cfg_json.get("layer_norm_eps", base.layer_norm_eps),
        hidden_act=act,
    )


def audio_config_from_hf(cfg_json: dict) -> AudioConfig:
    """HF WhisperConfig -> AudioConfig (encoder-only fields)."""
    base = AudioConfig.whisper_large_v3()
    return AudioConfig(
        d_model=cfg_json.get("d_model", base.d_model),
        num_layers=cfg_json.get("encoder_layers", base.num_layers),
        num_heads=cfg_json.get("encoder_attention_heads", base.num_heads),
        ffn_dim=cfg_json.get("encoder_ffn_dim", base.ffn_dim),
        num_mel_bins=cfg_json.get("num_mel_bins", base.num_mel_bins),
        max_source_positions=cfg_json.get("max_source_positions",
                                          base.max_source_positions),
    )


def _detect_prefix(sd, candidates, probe: str) -> str:
    """The first prefix under which `probe` (a key every valid checkpoint of
    this module has) exists: a wrong-layout directory fails here with a
    sample of its keys, not deep inside a converter."""
    for p in candidates:
        if p + probe in sd:
            return p
    raise KeyError(f"no prefix in {candidates} has '{probe}'; "
                   f"sample keys: {sorted(sd)[:5]}")


def _read_json(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _drop_none(overrides: Optional[dict]) -> dict:
    """Unset CLI flags (None) leave the configuration's values alone."""
    return {k: v for k, v in (overrides or {}).items() if v is not None}


def assemble_model(model_path: str, mm_vision_tower: str,
                   mm_audio_tower: Optional[str], *, device, dtype=torch.bfloat16,
                   seed: int = 0, mm_overrides: Optional[dict] = None,
                   text_layer_fn=None, tower_layer_fn=None):
    """Assemble a fresh Vidi from separate HF checkpoints, the finetune
    entry: decoder weights from a plain Gemma2 / Mistral checkpoint at
    `model_path`, towers from their own checkpoint directories, and the
    mm_rand_* adapters drawn fresh (`dattn.init_mm_params` from `seed`,
    llm_norm at mm_std). `mm_audio_tower=None` leaves a tiny random audio
    tower (`AudioConfig.tiny()`, drawn from seed + 1), valid only when the
    run never feeds audio. -> (params, cfg) on `device`."""
    base_json = _read_json(model_path)
    cfg = config_from_hf(base_json)
    if "mm_time_interval" not in base_json:
        # assembly's default is the finetune arguments' 10000, not the
        # released checkpoints' fallback
        cfg = dataclasses.replace(cfg, mm_time_interval=10000)
    vision = vision_config_from_hf(_read_json(mm_vision_tower))
    audio = (audio_config_from_hf(_read_json(mm_audio_tower))
             if mm_audio_tower is not None else AudioConfig.tiny())
    cfg = dataclasses.replace(cfg, vision=vision, audio=audio, **_drop_none(mm_overrides))
    dev = torch.device(device)

    text_sd = load_safetensors_dir(model_path)
    text = convert_text(text_sd, cfg.text, dtype,
                        _detect_prefix(text_sd, ("model.", ""), "embed_tokens.weight"),
                        device=dev, layer_fn=text_layer_fn)
    vis_sd = load_safetensors_dir(mm_vision_tower)
    conv_vis = convert_clip if vision.arch == "clip" else convert_siglip
    vis = conv_vis(vis_sd, vision, dtype, _detect_prefix(
        vis_sd, ("vision_model.", "vision_tower.vision_model.", "model.vision_model.", ""),
        "encoder.layers.0.layer_norm1.weight"), device=dev, layer_fn=tower_layer_fn)
    if mm_audio_tower is not None:
        aud_sd = load_safetensors_dir(mm_audio_tower)
        aud = convert_whisper(aud_sd, audio, dtype, _detect_prefix(
            aud_sd, ("model.encoder.", "encoder.", ""), "conv1.weight"), device=dev,
            layer_fn=tower_layer_fn)
    else:
        aud = whisper.init_params(audio, dtype, dev,
                                  torch.Generator(device=dev).manual_seed(seed + 1))
    mm = dattn.init_mm_params(cfg, dtype, dev, torch.Generator(device=dev).manual_seed(seed))
    return {"text": text, "vision": vis, "audio": aud, "mm": mm}, cfg


def _quantizers(load_8bit: bool, load_8bit_towers: bool, load_4bit: bool):
    """(text layer_fn, tower layer_fn) for the quantized loads, or None."""
    bits = 4 if load_4bit else 8
    text_fn = ((lambda lp: qz.quantize_text_layer(lp, bits=bits))
               if load_8bit or load_4bit else None)
    return text_fn, (qz.quantize_tower_layer if load_8bit_towers else None)


def load_model(model_path: Optional[str] = None,
               random_weights: Optional[str] = None, *,
               dtype: torch.dtype = torch.bfloat16, device="cuda",
               seed: int = 0, load_8bit: bool = False,
               load_8bit_towers: bool = False, load_4bit: bool = False,
               mm_vision_tower: Optional[str] = None,
               mm_audio_tower: Optional[str] = None,
               mm_overrides: Optional[dict] = None, mesh=None):
    """-> (params, cfg, tokenizer). See the module docstring.
    `mm_overrides` (the finetune model arguments: mm_std, mm_image_pool_size,
    mm_input_type, ...; None values ignored) override the configuration in
    every branch. `mesh`: cut the weights to this rank's shards."""
    dev = resolve_device(device)
    text_fn, tower_fn = _quantizers(load_8bit, load_8bit_towers, load_4bit)
    overrides = _drop_none(mm_overrides)
    if mesh is not None and mesh.size > 1:
        if text_fn is not None or tower_fn is not None:
            raise NotImplementedError(
                "--load-8bit / --load-4bit / --load-8bit-towers under a mesh of "
                "several ranks are ROADMAP Q1.16c")
    else:
        mesh = None

    if random_weights is not None:
        if mm_vision_tower is not None:
            raise ValueError("mm_vision_tower assembles from a base LLM checkpoint; "
                             "it cannot combine with random weights")
        if random_weights not in CONFIGS:
            raise ValueError(f"random_weights must be one of {sorted(CONFIGS)}, "
                             f"got {random_weights!r}")
        cfg = dataclasses.replace(CONFIGS[random_weights](), **overrides)
        if mesh is not None:
            params = dattn.init_params(cfg, dtype, dev, seed, layer_fns=_sharders(cfg, mesh))
            return _shard_rest(params, cfg, mesh), cfg, ByteTokenizer()
        params = dattn.init_params(cfg, dtype, dev, seed)
        for module, fn in (("text", text_fn), ("vision", tower_fn), ("audio", tower_fn)):
            if fn is not None:
                layers = params[module]["layers"]
                for i, lp in enumerate(layers):
                    layers[i] = fn(lp)
        _quantize_lm_head(params, text_fn, load_4bit)
        return params, cfg, ByteTokenizer()

    if model_path is None:
        raise ValueError("need model_path or random_weights")
    audio_fn = None
    if mesh is not None:
        if mm_vision_tower is not None:
            raise NotImplementedError("assembly under a mesh of several ranks: assemble "
                                      "in one process and export the model first")
        # the sharders need the layer counts before any layer is read
        fns = _sharders(dataclasses.replace(config_from_hf(_read_json(model_path)),
                                            **overrides), mesh)
        text_fn, tower_fn, audio_fn = fns["text"], fns["vision"], fns["audio"]
    for attempt in range(1, MAX_TRIES + 1):
        try:
            if mm_vision_tower is not None:
                params, cfg = assemble_model(
                    model_path, mm_vision_tower, mm_audio_tower, dtype=dtype, device=dev,
                    seed=seed, mm_overrides=overrides, text_layer_fn=text_fn,
                    tower_layer_fn=tower_fn)
            else:
                cfg = dataclasses.replace(config_from_hf(_read_json(model_path)),
                                          **overrides)
                params = convert_dattn(load_safetensors_dir(model_path), cfg, dtype,
                                       device=dev, text_layer_fn=text_fn,
                                       tower_layer_fn=tower_fn, audio_layer_fn=audio_fn)
            break
        except (FileNotFoundError, KeyError, ValueError, NotImplementedError,
                torch.OutOfMemoryError):
            # a layout or format fault, or a card too small: reading the
            # checkpoint again gives it again
            raise
        except Exception as e:  # noqa: BLE001 -- a flaky read is retried, as the reference does
            print(f"load_model try {attempt} of {MAX_TRIES} failed: {e!r}")
            if attempt == MAX_TRIES:
                raise
    if mesh is not None:
        return _shard_rest(params, cfg, mesh), cfg, load_tokenizer(model_path, cfg)
    _quantize_lm_head(params, text_fn, load_4bit)
    return params, cfg, load_tokenizer(model_path, cfg)


def _sharders(cfg: DattnConfig, mesh) -> dict:
    """{"text" | "vision" | "audio": fn cutting a layer of that module to
    this rank's shards as it arrives}; raises ValueError unless the mesh's
    "model" size divides the KV heads."""
    from vidi_tpu_torch.parallel import sharding

    sharding.check_model_cut(mesh, cfg.text.num_kv_heads)
    return {m: sharding.layer_sharder(m, getattr(cfg, c).num_layers, mesh)
            for m, c in (("text", "text"), ("vision", "vision"), ("audio", "audio"))}


def _shard_rest(params, cfg: DattnConfig, mesh):
    """The leaves outside the layers cut to this rank's shards (the layers
    were cut as they arrived)."""
    from vidi_tpu_torch.parallel import sharding

    return sharding.shard_params(params, mesh, kv_heads=cfg.text.num_kv_heads)


def _quantize_lm_head(params, text_fn, load_4bit: bool) -> None:
    """An untied lm_head (Mistral) takes the text layers' format."""
    if text_fn is not None and "lm_head" in params["text"]:
        qw = qz.quantize_weight4 if load_4bit else qz.quantize_weight
        params["text"]["lm_head"] = qw(params["text"]["lm_head"])


def load_tokenizer(model_path: str, cfg: DattnConfig):
    """The checkpoint's tokenizer through `transformers`, or the byte
    tokenizer (with a note) where the directory has no tokenizer files."""
    if not any(os.path.exists(os.path.join(model_path, n)) for n in TOKENIZER_FILES):
        # directories written by save_pretrained may hold weights only
        print(f"no tokenizer files in {model_path}; using ByteTokenizer")
        return ByteTokenizer()
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(f"{model_path} holds tokenizer files, and reading them needs "
                          "the `transformers` package, which is not installed") from e
    return AutoTokenizer.from_pretrained(
        model_path, model_max_length=cfg.model_max_length, padding_side="right")
