"""Port parameters -> HF-format checkpoint (port of vidi_tpu/infer/export.py).

The inverse of `infer/convert.py`: each per-layer dict becomes its HF
names, matmul weights go back to torch's [out, in] (as transposed views:
the writer makes each contiguous as it writes it), and `save_pretrained`
writes `model.safetensors` with the port's own writer (`safetensors_io`)
and `config.json`, so a finetune run on the card can hand its weights back
and `load_model(model_path=...)` (either package's) reads them again.
Quantized (int8 / int4) leaves are written dequantized in fp32, as the
reference does: HF checkpoints carry plain tensors. `export_state_dict`
gives them as `safetensors_io.Deferred`s, which the writer dequantizes one
at a time as it writes them, so an int8 tree's export never holds its fp32
copy on the device.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Union

import torch

from vidi_tpu_torch.core.config import DattnConfig, TextConfig
from vidi_tpu_torch.infer import quantize as qz
from vidi_tpu_torch.infer.convert import (TEXT_DOUBLE_NORM_NAMES, TEXT_LAYER_NAMES,
                                          VIT_LAYER_NAMES, WHISPER_LAYER_NAMES,
                                          WHISPER_NAMES)
from vidi_tpu_torch.infer.safetensors_io import Deferred, save_file

StateDict = Dict[str, Union[torch.Tensor, Deferred]]
TOKENIZER_COPY = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json",
                  "special_tokens_map.json")


def _plain(x, transpose: bool = False):
    """A leaf as a plain tensor, transposed (a view) when asked; a quantized
    dict as a Deferred fp32 dequantization (int8 per-column weights and
    per-row embeddings share the multiply)."""
    if not qz.is_quantized(x):
        x = x.detach()
        return x.t() if transpose else x
    if qz.QUANT4_KEY in x:
        packed = x[qz.QUANT4_KEY]  # two contraction rows a byte
        deq, shape = qz.dequantize_weight4, (*packed.shape[:-2], 2 * packed.shape[-2],
                                             packed.shape[-1])
    else:
        deq, shape = qz.dequantize_weight, tuple(x[qz.QUANT_KEY].shape)
    if transpose:
        return Deferred(shape[::-1], torch.float32, lambda: deq(x, torch.float32).t())
    return Deferred(shape, torch.float32, lambda: deq(x, torch.float32))


def _weight(x):
    """A matmul weight back to torch's [out, in]."""
    return _plain(x, transpose=True)


def _export_layers(sd: StateDict, layers, prefix: str, names: Dict[str, str]) -> None:
    """Per-layer dicts -> sd[prefix + "layers.{i}." + theirs]; keys a layer
    lacks (whisper's k bias) are skipped."""
    for i, lp in enumerate(layers):
        for ours, theirs in names.items():
            if ours in lp:
                x = lp[ours]
                sd[f"{prefix}layers.{i}.{theirs}"] = (_weight(x) if ours.endswith("_w")
                                                     else _plain(x))


def export_text(params: Dict, cfg: TextConfig, prefix: str = "model.") -> StateDict:
    sd: StateDict = {prefix + "embed_tokens.weight": _plain(params["embed"]),
                     prefix + "norm.weight": _plain(params["final_ln"])}
    names = dict(TEXT_LAYER_NAMES)
    if cfg.double_norms:
        names.update(TEXT_DOUBLE_NORM_NAMES)
    _export_layers(sd, params["layers"], prefix, names)
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = _weight(params["lm_head"])
    return sd


def export_vision(params: Dict, cfg, prefix: str) -> StateDict:
    pw = _plain(params["patch_w"])  # [C*KH*KW, O] -> [O, C, KH, KW]
    sd: StateDict = {prefix + "embeddings.patch_embedding.weight": pw.t().reshape(
        pw.shape[1], 3, cfg.patch_size, cfg.patch_size)}
    if "patch_b" in params:
        sd[prefix + "embeddings.patch_embedding.bias"] = _plain(params["patch_b"])
    sd[prefix + "embeddings.position_embedding.weight"] = _plain(params["pos_embed"])
    if cfg.arch == "clip":
        sd[prefix + "embeddings.class_embedding"] = _plain(params["cls_embed"])
        sd[prefix + "pre_layrnorm.weight"] = _plain(params["pre_ln_scale"])
        sd[prefix + "pre_layrnorm.bias"] = _plain(params["pre_ln_bias"])
    _export_layers(sd, params["layers"], prefix + "encoder.", VIT_LAYER_NAMES)
    return sd


def export_whisper(params: Dict, prefix: str) -> StateDict:
    sd: StateDict = {prefix + theirs: _plain(params[ours])
                     for ours, theirs in WHISPER_NAMES.items()}
    _export_layers(sd, params["layers"], prefix, WHISPER_LAYER_NAMES)
    return sd


def export_mm_adapters(params: Dict, cfg: DattnConfig, prefix: str = "model.") -> StateDict:
    sd: StateDict = {}

    def mlp(name, tree, sub):
        sd[f"{prefix}{name}.{sub}.0.weight"] = _weight(tree["w0"])
        sd[f"{prefix}{name}.{sub}.0.bias"] = _plain(tree["b0"])
        sd[f"{prefix}{name}.{sub}.2.weight"] = _weight(tree["w1"])
        sd[f"{prefix}{name}.{sub}.2.bias"] = _plain(tree["b1"])

    sd[prefix + "mm_rand_llm_norm.weight"] = _plain(params["llm_norm"]["weight"])
    if cfg.mm_input_type == "image":
        mlp("mm_rand_projector", params["projector"], "model")
        sd[prefix + "mm_rand_norm.weight"] = _plain(params["norm"]["weight"])
        mlp("mm_rand_pos_w", params["pos_w"], "mlp")
        mlp("mm_rand_pos_h", params["pos_h"], "mlp")
        return sd
    mlp("mm_rand_img_projector", params["img_projector"], "model")
    sd[prefix + "mm_rand_img_norm.weight"] = _plain(params["img_norm"]["weight"])
    for axis in ("w", "h", "t"):
        mlp(f"mm_rand_pos_{axis}", params[f"pos_{axis}"], "mlp")
    sd[prefix + "mm_rand_aud_pool.weight"] = _plain(params["aud_pool"]["w"])
    mlp("mm_rand_aud_projector", params["aud_projector"], "model")
    sd[prefix + "mm_rand_aud_norm.weight"] = _plain(params["aud_norm"]["weight"])
    if cfg.mm_version == "v1":
        sd[prefix + "mm_rand_img_pool.conv.weight"] = _plain(params["img_pool"]["w"])
    return sd


def export_state_dict(params: Dict, cfg: DattnConfig) -> StateDict:
    """The full Dattn tree -> a flat HF state dict (convert_dattn's inverse)."""
    sd = export_text(params["text"], cfg.text)
    sd.update(export_vision(params["vision"], cfg.vision, "model.mm_vis.vision_model."))
    sd.update(export_whisper(params["audio"], "model.mm_aud.encoder."))
    sd.update(export_mm_adapters(params["mm"], cfg))
    return sd


def config_to_hf(cfg: DattnConfig) -> dict:
    """DattnConfig -> config.json dict (config_from_hf's inverse; the field
    set mirrors DattnGemma2Config's defaults)."""
    t = cfg.text
    arch = t.arch
    out = {
        "model_type": "dattn_gemma2" if arch == "gemma2" else "dattn_mistral",
        "architectures": ["DattnGemma2ForCausalLM" if arch == "gemma2"
                          else "DattnMistralForCausalLM"],
        "vocab_size": t.vocab_size,
        "hidden_size": t.hidden_size,
        "num_hidden_layers": t.num_layers,
        "num_attention_heads": t.num_heads,
        "num_key_value_heads": t.num_kv_heads,
        "head_dim": t.head_dim,
        "intermediate_size": t.intermediate_size,
        "rope_theta": t.rope_theta,
        "rms_norm_eps": t.rms_norm_eps,
        "sliding_window": t.sliding_window,
        "tie_word_embeddings": t.tie_word_embeddings,
        "mm_vision_tower": ("openai/clip-vit-large-patch14" if cfg.vision.arch == "clip"
                            else "google/siglip2-so400m-patch14-384"),
        "mm_audio_tower": "openai/whisper-large-v3",
        "mm_image_pool_size": cfg.mm_image_pool_size,
        "mm_audio_pool_size": cfg.mm_audio_pool_size,
        "mm_time_interval": cfg.mm_time_interval,
        "mm_std": cfg.mm_std,
        "mm_input_type": cfg.mm_input_type,
        "mm_image_aspect_ratio": cfg.mm_image_aspect_ratio,
        "loss_thres": cfg.loss_thres,
        "model_max_length": cfg.model_max_length,
        "torch_dtype": "bfloat16",
    }
    if arch == "gemma2":
        out.update({
            "attn_logit_softcapping": t.attn_softcap,
            "final_logit_softcapping": t.final_softcap,
            "query_pre_attn_scalar": round(t.query_scale ** -2),
            "eos_token_id": 107,
        })
    # the towers' geometry under explicit keys: HF configs name towers by hub
    # id only, which cannot describe a tiny test model. config_from_hf honours
    # these where present; released checkpoints lack them.
    v, a = cfg.vision, cfg.audio
    out["vidi_tpu_vision"] = {
        "arch": v.arch, "hidden_size": v.hidden_size,
        "num_layers": v.num_layers, "num_heads": v.num_heads,
        "intermediate_size": v.intermediate_size, "patch_size": v.patch_size,
        "image_size": v.image_size, "layer_norm_eps": v.layer_norm_eps,
        "hidden_act": v.hidden_act, "select_layer": v.select_layer,
    }
    out["vidi_tpu_audio"] = {
        "d_model": a.d_model, "num_layers": a.num_layers,
        "num_heads": a.num_heads, "ffn_dim": a.ffn_dim,
        "num_mel_bins": a.num_mel_bins,
        "max_source_positions": a.max_source_positions,
    }
    out["vidi_tpu_text"] = {
        "embed_scale": t.embed_scale, "hidden_act": t.hidden_act,
        "double_norms": t.double_norms, "query_scale": t.query_scale,
        "mm_version": cfg.mm_version,
    }
    return out


def save_pretrained(params: Dict, cfg: DattnConfig, out_dir: str,
                    tokenizer_src: Optional[str] = None) -> str:
    """Write model.safetensors + config.json (+ the tokenizer files of
    `tokenizer_src`, when given). Returns out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    save_file(export_state_dict(params, cfg), os.path.join(out_dir, "model.safetensors"),
              metadata={"format": "pt"})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config_to_hf(cfg), f, indent=2)
    if tokenizer_src is not None and os.path.isdir(tokenizer_src):
        for name in TOKENIZER_COPY:
            src = os.path.join(tokenizer_src, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, name))
    return out_dir
