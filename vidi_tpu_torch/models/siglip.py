"""Vision tower, SigLIP or CLIP ViT (port of vidi_tpu/models/siglip.py).

Patch embedding as patch-extract + matmul, learned position embeddings,
pre-norm encoder layers run in a Python loop, tapped at `select_layer`
(-2: the output of the second-to-last layer). CLIP (Vidi-7B, `cfg.arch ==
"clip"`) has no patch bias, a class token before the patches, a
LayerNorm after the positions and quick_gelu; its features drop the class
token. Layers with int8 weights
(`infer.quantize.quantize_tower_params`) run K5's fused pieces. Parameters are a dict whose
keys mirror the JAX tree; `layers` is a list of per-layer dicts.
"""
from __future__ import annotations

from typing import Dict

import torch

from vidi_tpu_torch.core.config import VisionConfig
from vidi_tpu_torch.infer.quantize import is_quantized
from vidi_tpu_torch.ops.basic import dense, layer_norm, mha, tower_act
from vidi_tpu_torch.ops.cuda import fused_tower_layer as ftl
from vidi_tpu_torch.parallel import sharding

Params = Dict


def init_params(cfg: VisionConfig, dtype, device, gen: torch.Generator,
                layer_fn=None) -> Params:
    """Random init with the JAX init's shapes and scales."""
    d, ff = cfg.hidden_size, cfg.intermediate_size
    patch_dim = 3 * cfg.patch_size * cfg.patch_size

    def nrm(shape, scale):
        return (torch.randn(shape, generator=gen, device=device, dtype=dtype)
                * scale)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    layer_fn = layer_fn or (lambda lp: lp)  # applied to each layer as it is drawn
    layers = [layer_fn({
        "ln1_scale": const((d,), 1.0), "ln1_bias": const((d,), 0.0),
        "q_w": nrm((d, d), d**-0.5), "q_b": const((d,), 0.0),
        "k_w": nrm((d, d), d**-0.5), "k_b": const((d,), 0.0),
        "v_w": nrm((d, d), d**-0.5), "v_b": const((d,), 0.0),
        "o_w": nrm((d, d), d**-0.5), "o_b": const((d,), 0.0),
        "ln2_scale": const((d,), 1.0), "ln2_bias": const((d,), 0.0),
        "fc1_w": nrm((d, ff), d**-0.5), "fc1_b": const((ff,), 0.0),
        "fc2_w": nrm((ff, d), ff**-0.5), "fc2_b": const((d,), 0.0),
    }) for _ in range(cfg.num_layers)]
    clip = cfg.arch == "clip"
    params = {
        "patch_w": nrm((patch_dim, d), patch_dim**-0.5),
        "pos_embed": nrm((cfg.num_patches + clip, d), 0.02),
        "layers": layers,
    }
    if clip:  # no patch bias; a class token and a pre-LayerNorm instead
        params["cls_embed"] = nrm((d,), d**-0.5)
        params["pre_ln_scale"] = const((d,), 1.0)
        params["pre_ln_bias"] = const((d,), 0.0)
    else:
        params["patch_b"] = const((d,), 0.0)
    return params


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B,H,W,3] -> [B,(H/p)*(W/p),3*p*p], channel order (c, i, j) as the HF
    conv weight [O,C,KH,KW]; trailing pixels past a full patch are dropped."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images[:, : gh * patch, : gw * patch, :]
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, gh * gw, c * patch * patch)


def _encoder_layer(x, lp, num_heads, eps, hidden_act, use_flash=False):
    if is_quantized(lp["q_w"]):
        # int8 tower (load_8bit_towers): K5's three fused pieces
        q, k, v = ftl.ln_qkv(x, lp, eps)
        attn = mha(q, k, v, num_heads, use_flash=use_flash)
        x = ftl.o_residual(attn, x, lp)
        return ftl.ln_ffn(x, lp, eps, hidden_act)
    res = x
    h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
    q = dense(h, lp["q_w"], lp["q_b"])
    k = dense(h, lp["k_w"], lp["k_b"])
    v = dense(h, lp["v_w"], lp["v_b"])
    h = dense(mha(q, k, v, num_heads, use_flash=use_flash), lp["o_w"], lp["o_b"])
    x = res + h
    res = x
    h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
    h = dense(tower_act(dense(h, lp["fc1_w"], lp["fc1_b"]), hidden_act),
              lp["fc2_w"], lp["fc2_b"])
    return res + h


def forward_features(params: Params, images: torch.Tensor, cfg: VisionConfig,
                     use_flash: bool = False) -> torch.Tensor:
    """images [B,H,W,3] (processor-normalized) -> patch features [B,N,D]
    tapped at `cfg.select_layer` (CLIP: the class token dropped)."""
    clip = cfg.arch == "clip"
    images = images.to(params["patch_w"].dtype)
    x = dense(patchify(images, cfg.patch_size), params["patch_w"],
              params.get("patch_b"))
    if clip:
        cls = params["cls_embed"].to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(x.dtype)
    if clip:
        x = layer_norm(x, params["pre_ln_scale"], params["pre_ln_bias"],
                       cfg.layer_norm_eps)
    n_run = (cfg.num_layers + 1 + cfg.select_layer if cfg.select_layer < 0
             else cfg.select_layer)
    for lp in params["layers"][:n_run]:
        x = _encoder_layer(x, sharding.gathered(lp), cfg.num_heads, cfg.layer_norm_eps,
                           cfg.hidden_act, use_flash)
    return x[:, 1:] if clip else x
