"""Parameter conversion into the port's layout (port of
vidi_tpu/infer/convert.py, plus `params_from_jax`).

The port's layout: nested dicts of torch tensors whose keys mirror the JAX
tree, with every scanned `layers` dict of stacked [L, ...] leaves replaced
by a list of L per-layer dicts.

`convert_*` read an HF state dict from a lazy `safetensors_io.Index`, one
tensor at a time as each is asked for, and put each tensor straight onto
`device` in `dtype`. Torch Linear weights are [out, in] and are transposed on the
device to the port's [in, out], then made contiguous (the kernels and the
K-major weight cache expect contiguous weights); the SigLIP / CLIP patch
weight [O, C, KH, KW] becomes [O, C*KH*KW]^T; conv weights stay [O, I, K].
A `layer_fn` (for example a quantizer) is applied to each layer's dict as
soon as it is converted, so a quantized load never holds the whole
full-precision model. The position MLPs stay fp32 whatever `dtype` is.

`params_from_jax` takes a vidi_tpu parameter tree (nested dicts of numpy
arrays, or of anything `numpy.asarray` accepts) and returns the port's
parameters; the tests use it to run both packages on the same weights.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from vidi_tpu_torch.core.config import AudioConfig, DattnConfig, TextConfig, VisionConfig
from vidi_tpu_torch.infer.quantize import QUANT4_KEY, QUANT_KEY, tree_leaves
from vidi_tpu_torch.infer.safetensors_io import Index

LayerFn = Optional[Callable[[Dict], Dict]]

# per-layer names: ours -> the HF submodule path under "layers.{i}." (the
# matmul weights, ending in "_w", are transposed)
TEXT_LAYER_NAMES = {
    "input_ln": "input_layernorm.weight",
    "post_attn_ln": "post_attention_layernorm.weight",
    "q_w": "self_attn.q_proj.weight", "k_w": "self_attn.k_proj.weight",
    "v_w": "self_attn.v_proj.weight", "o_w": "self_attn.o_proj.weight",
    "gate_w": "mlp.gate_proj.weight", "up_w": "mlp.up_proj.weight",
    "down_w": "mlp.down_proj.weight",
}
TEXT_DOUBLE_NORM_NAMES = {
    "pre_ffn_ln": "pre_feedforward_layernorm.weight",
    "post_ffn_ln": "post_feedforward_layernorm.weight",
}
VIT_LAYER_NAMES = {
    "ln1_scale": "layer_norm1.weight", "ln1_bias": "layer_norm1.bias",
    "q_w": "self_attn.q_proj.weight", "q_b": "self_attn.q_proj.bias",
    "k_w": "self_attn.k_proj.weight", "k_b": "self_attn.k_proj.bias",
    "v_w": "self_attn.v_proj.weight", "v_b": "self_attn.v_proj.bias",
    "o_w": "self_attn.out_proj.weight", "o_b": "self_attn.out_proj.bias",
    "ln2_scale": "layer_norm2.weight", "ln2_bias": "layer_norm2.bias",
    "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
    "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
}
WHISPER_LAYER_NAMES = {
    "ln1_scale": "self_attn_layer_norm.weight",
    "ln1_bias": "self_attn_layer_norm.bias",
    "q_w": "self_attn.q_proj.weight", "q_b": "self_attn.q_proj.bias",
    "k_w": "self_attn.k_proj.weight",  # whisper's k_proj has no bias
    "v_w": "self_attn.v_proj.weight", "v_b": "self_attn.v_proj.bias",
    "o_w": "self_attn.out_proj.weight", "o_b": "self_attn.out_proj.bias",
    "ln2_scale": "final_layer_norm.weight", "ln2_bias": "final_layer_norm.bias",
    "fc1_w": "fc1.weight", "fc1_b": "fc1.bias",
    "fc2_w": "fc2.weight", "fc2_b": "fc2.bias",
}
WHISPER_NAMES = {
    "conv1_w": "conv1.weight", "conv1_b": "conv1.bias",
    "conv2_w": "conv2.weight", "conv2_b": "conv2.bias",
    "pos_embed": "embed_positions.weight",
    "final_ln_scale": "layer_norm.weight", "final_ln_bias": "layer_norm.bias",
}


def _getter(sd: Index, prefix: str, dtype: Optional[torch.dtype],
            device) -> Callable[..., torch.Tensor]:
    """get(name, transpose=False): sd[prefix + name] on `device`, floating
    values cast to `dtype`, transposed ([out, in] -> [in, out]) on request."""
    def get(name: str, transpose: bool = False) -> torch.Tensor:
        t = sd.load(prefix + name, device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.t().contiguous() if transpose else t
    return get


def _layers(get, n: int, names: Dict[str, str], layer_fn: LayerFn = None,
            sub: str = ""):
    """[{ours: get(sub + "layers.{i}." + theirs)}] for i < n, matmul weights
    transposed, each dict passed through `layer_fn` as it is made."""
    out = []
    for i in range(n):
        lp = {ours: get(f"{sub}layers.{i}.{theirs}", ours.endswith("_w"))
              for ours, theirs in names.items()}
        out.append(layer_fn(lp) if layer_fn is not None else lp)
    return out


def _patch_w(get) -> torch.Tensor:
    pw = get("embeddings.patch_embedding.weight")  # [O, C, KH, KW]
    return pw.reshape(pw.shape[0], -1).t().contiguous()  # [C*KH*KW, O]


def convert_siglip(sd: Index, cfg: VisionConfig, dtype=torch.float32,
                   prefix: str = "vision_model.", *, device,
                   layer_fn: LayerFn = None) -> Dict:
    """SiglipVisionModel state_dict -> siglip.init_params layout."""
    get = _getter(sd, prefix, dtype, device)
    return {
        "patch_w": _patch_w(get),
        "patch_b": get("embeddings.patch_embedding.bias"),
        "pos_embed": get("embeddings.position_embedding.weight"),
        "layers": _layers(get, cfg.num_layers, VIT_LAYER_NAMES, layer_fn, "encoder."),
    }


def convert_clip(sd: Index, cfg: VisionConfig, dtype=torch.float32,
                 prefix: str = "vision_model.", *, device,
                 layer_fn: LayerFn = None) -> Dict:
    """CLIPVisionModel state_dict -> the CLIP tower's layout (the 7B tower;
    converted as data: the port's CLIP tower is not written yet)."""
    get = _getter(sd, prefix, dtype, device)
    return {
        "patch_w": _patch_w(get),  # no patch bias
        "cls_embed": get("embeddings.class_embedding"),
        "pos_embed": get("embeddings.position_embedding.weight"),
        # HF spells it "pre_layrnorm" (sic)
        "pre_ln_scale": get("pre_layrnorm.weight"),
        "pre_ln_bias": get("pre_layrnorm.bias"),
        "layers": _layers(get, cfg.num_layers, VIT_LAYER_NAMES, layer_fn, "encoder."),
    }


def convert_whisper(sd: Index, cfg: AudioConfig, dtype=torch.float32,
                    prefix: str = "encoder.", *, device,
                    layer_fn: LayerFn = None) -> Dict:
    """WhisperEncoder state_dict -> whisper.init_params layout."""
    get = _getter(sd, prefix, dtype, device)
    params = {ours: get(theirs) for ours, theirs in WHISPER_NAMES.items()}
    params["layers"] = _layers(get, cfg.num_layers, WHISPER_LAYER_NAMES, layer_fn)
    return params


def convert_text(sd: Index, cfg: TextConfig, dtype=torch.bfloat16,
                 prefix: str = "model.", *, device,
                 layer_fn: LayerFn = None) -> Dict:
    """Gemma2 / Mistral backbone state_dict -> decoder.init_params layout."""
    get = _getter(sd, prefix, dtype, device)
    names = dict(TEXT_LAYER_NAMES)
    if cfg.double_norms:
        names.update(TEXT_DOUBLE_NORM_NAMES)
    params = {
        "embed": get("embed_tokens.weight"),
        "final_ln": get("norm.weight"),
        "layers": _layers(get, cfg.num_layers, names, layer_fn),
    }
    if not cfg.tie_word_embeddings:
        # lm_head lives outside the `model.` prefix in HF causal-LM layouts
        params["lm_head"] = _getter(sd, "", dtype, device)("lm_head.weight", True)
    return params


def convert_mm_adapters(sd: Index, cfg: DattnConfig, dtype=torch.bfloat16,
                        prefix: str = "model.", *, device) -> Dict:
    """The mm_rand_* adapter modules. The image-mode and v1 adapters are
    converted as data (the port's model raises on them)."""
    get = _getter(sd, prefix, dtype, device)
    get32 = _getter(sd, prefix, torch.float32, device)

    def proj(name):
        return {"w0": get(f"{name}.model.0.weight", True),
                "b0": get(f"{name}.model.0.bias"),
                "w1": get(f"{name}.model.2.weight", True),
                "b1": get(f"{name}.model.2.bias")}

    def pos(name):
        # the position MLPs stay fp32, read straight from the source tensors
        return {"w0": get32(f"{name}.mlp.0.weight", True),
                "b0": get32(f"{name}.mlp.0.bias"),
                "w1": get32(f"{name}.mlp.2.weight", True),
                "b1": get32(f"{name}.mlp.2.bias")}

    mm = {"llm_norm": {"weight": get("mm_rand_llm_norm.weight")}}
    if cfg.mm_input_type == "image":
        mm.update(projector=proj("mm_rand_projector"),
                  norm={"weight": get("mm_rand_norm.weight")},
                  pos_w=pos("mm_rand_pos_w"), pos_h=pos("mm_rand_pos_h"))
        return mm
    mm.update(img_projector=proj("mm_rand_img_projector"),
              img_norm={"weight": get("mm_rand_img_norm.weight")},
              pos_w=pos("mm_rand_pos_w"), pos_h=pos("mm_rand_pos_h"),
              pos_t=pos("mm_rand_pos_t"),
              aud_pool={"w": get("mm_rand_aud_pool.weight")},  # [O, I, K]
              aud_projector=proj("mm_rand_aud_projector"),
              aud_norm={"weight": get("mm_rand_aud_norm.weight")})
    if cfg.mm_version == "v1":
        # the 7B's pool is a learned conv
        mm["img_pool"] = {"w": get("mm_rand_img_pool.conv.weight")}
    return mm


def convert_dattn(sd: Index, cfg: DattnConfig, dtype=torch.bfloat16, *, device,
                  text_layer_fn: LayerFn = None, tower_layer_fn: LayerFn = None,
                  audio_layer_fn: LayerFn = None) -> Dict:
    """A full Vidi checkpoint (DattnGemma2ForCausalLM / Mistral state_dict)
    -> dattn.init_params layout. The towers live under model.mm_vis /
    model.mm_aud; `audio_layer_fn` (default `tower_layer_fn`) maps the audio
    tower's layers."""
    conv_vis = convert_clip if cfg.vision.arch == "clip" else convert_siglip
    return {
        "text": convert_text(sd, cfg.text, dtype, device=device, layer_fn=text_layer_fn),
        "vision": conv_vis(sd, cfg.vision, dtype, "model.mm_vis.vision_model.",
                           device=device, layer_fn=tower_layer_fn),
        "audio": convert_whisper(sd, cfg.audio, dtype, "model.mm_aud.encoder.",
                                 device=device, layer_fn=audio_layer_fn or tower_layer_fn),
        "mm": convert_mm_adapters(sd, cfg, dtype, device=device),
    }


def _tensor(x, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)  # ml_dtypes bfloat16: torch has no numpy bf16
    t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, dtype: Optional[torch.dtype] = None,
                    device="cpu"):
    """vidi_tpu parameter tree -> port parameters (see module docstring).
    `dtype` casts floating leaves (None keeps each leaf's own precision,
    with bfloat16 leaves arriving as float32). Quantized leaves ({qi8 |
    qi4 int8, scale fp32}) keep their int8 values and fp32 scales whatever
    `dtype` asks."""
    if isinstance(tree, dict):
        if QUANT_KEY in tree or QUANT4_KEY in tree:
            return {k: _tensor(v, None, device) for k, v in tree.items()}
        out = {}
        for key, val in tree.items():
            if key == "layers" and isinstance(val, dict):
                n = len(np.asarray(next(tree_leaves(val))))
                out[key] = [params_from_jax(_take(val, i), dtype, device)
                            for i in range(n)]
            else:
                out[key] = params_from_jax(val, dtype, device)
        return out
    return _tensor(tree, dtype, device)


def _take(tree, i: int):
    """Layer i of a tree of stacked [L, ...] leaves."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
