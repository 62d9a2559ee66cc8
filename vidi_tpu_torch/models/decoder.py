"""Text-decoder backbone ops, Gemma2 or Mistral (port of
vidi_tpu/models/decoder.py):
norms, activation, gated MLP, the FFN block, embedding lookup and the
logits with the final softcap. Weights may be int8 / int4 dicts
(`infer.quantize`): products go through `qdot`, and a gated MLP with at
least `w8a8_min_tokens` rows takes K6's `quant_gated_mlp`. Under a "model"
cut of the layer weights (`parallel.sharding`) the MLP runs on the rank's
gate / up columns and down rows and sums the row partials
(`sharding.model_sum`).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from vidi_tpu_torch.core.config import TextConfig
from vidi_tpu_torch.infer import quantize as qz
from vidi_tpu_torch.ops.basic import gelu_tanh, matmul_f32
from vidi_tpu_torch.ops.norms import gemma_rms_norm, mistral_rms_norm
from vidi_tpu_torch.parallel import sharding

Params = Dict


def norm(x, weight, cfg: TextConfig):
    if cfg.arch == "gemma2":
        return gemma_rms_norm(x, weight, cfg.rms_norm_eps)
    return mistral_rms_norm(x, weight, cfg.rms_norm_eps)


def activation(x, cfg: TextConfig):
    if cfg.hidden_act == "gelu_tanh":
        return gelu_tanh(x)
    return F.silu(x)


def init_params(cfg: TextConfig, dtype, device, gen: torch.Generator,
                layer_fn=None) -> Params:
    """Random init with the JAX init's shapes and scales. Gemma2: norm
    weights are zero (the (1 + w) form makes them identity) and the FFN has
    its own two norms; Mistral: norm weights are ones, and an untied
    lm_head [d, vocab] when the config asks for one."""
    d, ff = cfg.hidden_size, cfg.intermediate_size
    hq, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def nrm(shape, scale):
        return (torch.randn(shape, generator=gen, device=device, dtype=dtype)
                * scale)

    def unit(shape):  # the identity norm weight of the arch
        return torch.full(shape, 0.0 if cfg.arch == "gemma2" else 1.0,
                          dtype=dtype, device=device)

    layer_fn = layer_fn or (lambda lp: lp)  # applied to each layer as it is drawn
    layers = [layer_fn({
        "input_ln": unit((d,)), "post_attn_ln": unit((d,)),
        "q_w": nrm((d, hq * dh), d**-0.5),
        "k_w": nrm((d, hk * dh), d**-0.5),
        "v_w": nrm((d, hk * dh), d**-0.5),
        "o_w": nrm((hq * dh, d), (hq * dh)**-0.5),
        "gate_w": nrm((d, ff), d**-0.5),
        "up_w": nrm((d, ff), d**-0.5),
        "down_w": nrm((ff, d), ff**-0.5),
        **({"pre_ffn_ln": unit((d,)), "post_ffn_ln": unit((d,))}
           if cfg.double_norms else {}),
    }) for _ in range(cfg.num_layers)]
    params = {"embed": nrm((cfg.vocab_size, d), 1.0), "final_ln": unit((d,)),
              "layers": layers}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = nrm((d, cfg.vocab_size), d**-0.5)
    return params


def split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def mlp(lp: Params, x: torch.Tensor, cfg: TextConfig) -> torch.Tensor:
    keys = ("gate_w", "up_w", "down_w")
    # under a "model" cut: the rank's gate / up columns and down rows give a
    # row partial, summed over the model group; x's gradient is summed there
    x = sharding.to_model(x, lp["gate_w"])
    if (qz.w8a8_min_tokens is not None
            and math.prod(x.shape[:-1]) >= qz.w8a8_min_tokens
            and all(isinstance(lp[k], dict) and qz.QUANT_KEY in lp[k] for k in keys)):
        # W8A8 prefill FFN: one shared quantize of x for gate and up (x is
        # whole on every rank); the down product quantizes the rank's hidden
        # columns by the group's row absmax
        from vidi_tpu_torch.ops.cuda.quant_matmul import quant_gated_mlp
        out = quant_gated_mlp(x, *(lp[k] for k in keys), cfg.hidden_act)
    else:
        gate = qz.qdot(x, lp["gate_w"])
        out = qz.qdot(activation(gate, cfg) * qz.qdot(x, lp["up_w"]), lp["down_w"])
    return sharding.model_sum(out, lp["down_w"])


def ffn_block(lp: Params, x: torch.Tensor, cfg: TextConfig) -> torch.Tensor:
    """Gemma2: x + post_ffn_norm(mlp(pre_ffn_norm(x)));
    Mistral: x + mlp(post_attn_norm(x))."""
    if cfg.double_norms:
        h = norm(mlp(lp, norm(x, lp["pre_ffn_ln"], cfg), cfg),
                 lp["post_ffn_ln"], cfg)
    else:
        h = mlp(lp, norm(x, lp["post_attn_ln"], cfg), cfg)
    return x + h


def embed_tokens(params: Params, ids: torch.Tensor, cfg: TextConfig) -> torch.Tensor:
    return qz.embed_lookup(params["embed"], ids)


def lm_logits(params: Params, hidden: torch.Tensor, cfg: TextConfig) -> torch.Tensor:
    """Logits in fp32 (tied embedding, or an untied lm_head), then the final
    softcap."""
    if cfg.tie_word_embeddings:
        logits = qz.tied_logits(hidden, params["embed"])
    elif qz.is_quantized(params["lm_head"]):
        logits = qz.qdot(hidden, params["lm_head"]).float()
    else:
        logits = matmul_f32(hidden, params["lm_head"])
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits
