"""Weight-only and W8A8 int8 quantization (port of vidi_tpu/infer/quantize.py).

The reference optionally loads 8/4-bit weights through bitsandbytes (its
model loader's `load_in_8bit` / `load_in_4bit`). Here, as in `vidi_tpu`:

- text-decoder layer weights: int8 with per-output-channel symmetric scales
  ({qi8 int8 [in, out], scale f32 [1, out]}), or group-wise int4 packed two
  rows to a byte ({qi4 int8 [in/2, out], scale f32 [in/64, 1, out]});
- encoder-tower layer weights: int8, with the FFN width zero-padded to a
  multiple of 128 so the parameter trees match the JAX package's;
- the embedding (optional): int8 per row ({qi8 [V, d], scale [V, 1]});
- the modality KV caches (optional): int8 per token ({qi8 [.., S, D],
  scale [.., S, 1]}).

The port keeps per-layer lists, so every scale drops the JAX tree's leading
layer axis. `qdot` multiplies by a possibly-quantized weight: weight-only
(the int8 weight converted to the activation dtype, then the product) unless
`w8a8_min_tokens` is set and the call has at least that many rows, when it
takes `dynamic_qdense`: per-row int8 activations, an int8 x int8 -> int32
product, rescaled per row and column (K6 on a CUDA tensor). Eager PyTorch
materialises `qi8.to(bfloat16)` on every weight-only call, where XLA fused
the convert into the matmul read.

Rounding follows the JAX functions bit for bit: amax over the values as
fp32, s = amax / 127 (1 where amax is 0), q = clip(round_half_even(x / s)).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from vidi_tpu_torch.parallel import sharding

QUANT_KEY = "qi8"
QUANT4_KEY = "qi4"
INT4_GROUP = 64  # int4 groups along the contraction dim
# the int8 W8A8 threshold: None keeps every product weight-only; set it (the
# CLI's --w8a8-prefill) to send products with at least this many rows to
# dynamic_qdense
w8a8_min_tokens = None

_TEXT_QUANT_KEYS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
_TOWER_QUANT_KEYS = ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w")


def is_quantized(w) -> bool:
    return isinstance(w, dict) and (QUANT_KEY in w or QUANT4_KEY in w)


def _symmetric(xf: torch.Tensor, dim: int, qmax: int, amax=None):
    """(q int8, scale f32) with amax taken over `dim` of the fp32 values, or
    the `amax` given (keepdim's shape). The divisor is a tensor on xf's
    device: on a CUDA tensor PyTorch divides by a Python scalar as a
    multiply by its reciprocal, which can differ in the last bit from the
    true quotient that JAX (and the kernels) take."""
    if amax is None:
        amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, float(qmax)),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] float -> {qi8 int8, scale f32 [..., 1, out]}."""
    q, scale = _symmetric(w.float(), -2, 127)
    return {QUANT_KEY: q, "scale": scale}


def dequantize_weight(wq: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    return (wq[QUANT_KEY].float() * wq["scale"]).to(dtype)


def quantize_weight4(w: torch.Tensor, group: int = INT4_GROUP):
    """[..., in, out] float -> {qi4 packed int8 [..., in/2, out], scale f32
    [..., in/group, 1, out]}: symmetric int4 (+-7) per group of `group`
    contraction rows; rows 2i and 2i+1 share a byte (low and high nibble).
    A contraction dim that the group does not tile quantizes to int8."""
    din = w.shape[-2]
    if din % group or din % 2:
        return quantize_weight(w)
    lead, dout = w.shape[:-2], w.shape[-1]
    wf = w.float().reshape(*lead, din // group, group, dout)
    q, scale = _symmetric(wf, -2, 7)
    q = q.reshape(*lead, din, dout)
    lo, hi = q[..., 0::2, :], q[..., 1::2, :]
    packed = torch.bitwise_or(torch.bitwise_and(lo, 0xF), torch.bitwise_left_shift(hi, 4))
    return {QUANT4_KEY: packed, "scale": scale}


def dequantize_weight4(wq: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    packed, scale = wq[QUANT4_KEY], wq["scale"]
    lead, dout = packed.shape[:-2], packed.shape[-1]
    din = packed.shape[-2] * 2
    # arithmetic shifts sign-extend the nibbles
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    q = torch.stack([lo, hi], dim=-2).reshape(*lead, din, dout)
    n_groups = scale.shape[-3]
    qf = q.float().reshape(*lead, n_groups, din // n_groups, dout)
    return (qf * scale).reshape(*lead, din, dout).to(dtype)


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w where w is a float tensor or a quantized dict. Per-output-channel
    scales commute with the contraction: x @ (q * s) == (x @ q) * s."""
    if not is_quantized(w):
        return x @ w
    if QUANT4_KEY in w:
        # group scales vary along the contraction: dequantize, then the product
        return x @ dequantize_weight4(rank_groups(w), x.dtype)
    if w8a8_min_tokens is not None and math.prod(x.shape[:-1]) >= w8a8_min_tokens:
        return dynamic_qdense(x, w)
    y = x @ w[QUANT_KEY].to(x.dtype)
    return y * w["scale"].reshape(w["scale"].shape[-1]).to(y.dtype)


def rank_groups(w: Dict) -> Dict:
    """An int4 weight whose scale covers the contraction rows this rank
    holds: `w` itself, unless its rows are cut on "model" and its scale
    [G, 1, out] kept whole (G does not split over the model group, each
    rank's rows lying inside one group), when the scale of that group."""
    cut = sharding.model_cut(w[QUANT4_KEY])
    if cut is None or cut.dim != 0 or sharding.model_cut(w["scale"]) is not None:
        return w
    rows, groups = 2 * w[QUANT4_KEY].shape[0], w["scale"].shape[0]
    size = rows * cut.mesh.shape["model"] // groups  # contraction rows a group
    if size % rows:
        raise ValueError(f"int4 groups of {size} rows over model slices of {rows}")
    return {**w, "scale": w["scale"].narrow(0, cut.mesh.coord("model") * rows // size, 1)}


def quantize_act(x: torch.Tensor, amax=None):
    """Dynamic per-row symmetric int8 -> (xq int8, sx f32 [..., 1]); `amax`
    [...] (one a row): quantize by it instead of each row's own absmax."""
    return _symmetric(x.float(), -1, 127, None if amax is None else amax[..., None])


def dynamic_qdense(x: torch.Tensor, wq: Dict, bias=None) -> torch.Tensor:
    """x @ wq with per-row int8 activations: int8 x int8 -> int32, rescaled by
    the row and column scales, cast to x's dtype, then + bias in the bias's
    dtype. K6's `quant_matmul` on a CUDA tensor, its plain version on a CPU
    tensor. Under a "model" cut of wq's contraction dim (o / down) each
    row is quantized by the model group's row absmax (`shared_row_amax`),
    and the result is this rank's row partial."""
    from vidi_tpu_torch.ops.cuda.quant_matmul import quant_matmul
    return quant_matmul(x, wq[QUANT_KEY], wq["scale"][..., 0, :], bias,
                        amax=shared_row_amax(x, wq))


def shared_row_amax(x: torch.Tensor, wq: Dict):
    """The absmax each row of x is quantized by in a W8A8 product with wq:
    None (the row's own) unless wq is cut on "model" along its contraction
    dim, when it is the max over the model group of every rank's absmax of
    its slice of the row (K6's `row_amax`, then one all-reduce of an [M]
    fp32 vector): the whole row's absmax, which JAX's GSPMD takes over the
    unsplit contraction."""
    cut = sharding.model_cut(wq[QUANT_KEY])
    if cut is None or cut.dim != 0 or cut.mesh.shape["model"] == 1:
        return None
    from vidi_tpu_torch.ops.cuda.quant_matmul import row_amax
    return sharding.model_max(row_amax(x))


def quantize_tower_layer(lp: Dict) -> Dict:
    """One encoder layer's matmuls to int8, the FFN width zero-padded to a
    multiple of 128 (SigLIP-so400m: 4304 -> 4352). Padded columns carry zero
    weight and bias, so act(0) = 0 adds nothing to fc2.

    Each int8 matrix is stored K-major: its `qi8` [in, out] is the `.t()`
    view of a contiguous [out, in] tensor, the layout K5's GEMM reads (8-bit
    wgmma takes both operands k-contiguous), so the card's kernels need no
    copy of a tower weight. Keys, shapes and values are those of
    `quantize_weight`. K5's fp32 LayerNorm parameters and biases are made
    here too, once a layer (`fused_tower_layer.prepare_layer`)."""
    from vidi_tpu_torch.ops.cuda import fused_tower_layer

    out = dict(lp)
    pad = (-lp["fc1_w"].shape[-1]) % 128 if "fc1_w" in lp else 0
    if pad and "fc2_w" in lp:
        out["fc1_w"] = torch.nn.functional.pad(lp["fc1_w"], (0, pad))
        out["fc2_w"] = torch.nn.functional.pad(lp["fc2_w"], (0, 0, 0, pad))
        if "fc1_b" in lp:
            out["fc1_b"] = torch.nn.functional.pad(lp["fc1_b"], (0, pad))
    for k in _TOWER_QUANT_KEYS:
        if k in out:
            w = quantize_weight(out[k])
            w[QUANT_KEY] = w[QUANT_KEY].t().contiguous().t()
            out[k] = w
    if fused_tower_layer.takes(out):
        fused_tower_layer.prepare_layer(out)
    return out


def quantize_tower_params(tower_params: Dict) -> Dict:
    """A tower's encoder layers to int8 (see `quantize_tower_layer`)."""
    return {**tower_params,
            "layers": [quantize_tower_layer(lp) for lp in tower_params["layers"]]}


def quantize_rows_cut(wf: torch.Tensor, bits: int, cut) -> Dict[str, torch.Tensor]:
    """wf [in, out] fp32 quantized as `quantize_weight` (bits 8) or
    `quantize_weight4` (bits 4) quantizes it, where wf is this rank's slice
    of the contraction rows of a weight cut on "model" (`cut`, or None for
    a whole weight): the per-column int8 scales take the column absmax over
    the model group, int4 groups lie inside the slice; the codes are marked
    with `cut`, so that a W8A8 product with them takes the group's row
    absmax. The slice's codes and scales are those of the whole weight's."""
    m = cut.mesh.shape["model"] if cut is not None else 1
    whole = wf.shape[0] * m
    if bits == 4 and whole % INT4_GROUP == 0:
        if wf.shape[0] % INT4_GROUP:
            raise ValueError(f"int4 groups of {INT4_GROUP} rows over model slices of "
                             f"{wf.shape[0]}")
        out = quantize_weight4(wf)
        sharding.mark_model_cut(out["scale"], cut)
    else:
        amax = wf.abs().amax(dim=0, keepdim=True)
        if cut is not None:
            amax = sharding.model_max(amax)
        q, scale = _symmetric(wf, 0, 127, amax)
        out = {QUANT_KEY: q, "scale": scale}
    sharding.mark_model_cut(out[QUANT4_KEY if QUANT4_KEY in out else QUANT_KEY], cut)
    return out


def quantize_embedding(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[V, d] -> {qi8, scale [V, 1]}, per row: rows are the lookup unit and,
    for the tied lm_head, the output channels."""
    q, scale = _symmetric(w.float(), -1, 127)
    return {QUANT_KEY: q, "scale": scale}


def embed_lookup(embed, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    if not is_quantized(embed):
        return embed[ids]
    return (embed[QUANT_KEY][ids].float() * embed["scale"][ids]).to(dtype)


def tied_logits(hidden: torch.Tensor, embed) -> torch.Tensor:
    """hidden @ embed.T in fp32 with a possibly-quantized [V, d] embedding."""
    from vidi_tpu_torch.ops.basic import matmul_f32

    if not is_quantized(embed):
        return matmul_f32(hidden, embed.T)
    logits = matmul_f32(hidden, embed[QUANT_KEY].T.to(hidden.dtype))
    return logits * embed["scale"][:, 0]


def quantize_text_layer(lp: Dict, bits: int = 8) -> Dict:
    qw = quantize_weight4 if bits == 4 else quantize_weight
    return {k: qw(v) if k in _TEXT_QUANT_KEYS else v for k, v in lp.items()}


def quantize_text_params(text_params: Dict, quantize_embed: bool = False,
                         bits: int = 8) -> Dict:
    """The decoder's layer matmuls (and an untied lm_head) to int8, or to
    group-wise int4 with bits=4; the embedding too with `quantize_embed`."""
    out = {**text_params,
           "layers": [quantize_text_layer(lp, bits) for lp in text_params["layers"]]}
    if "lm_head" in out:
        out["lm_head"] = (quantize_weight4 if bits == 4 else quantize_weight)(out["lm_head"])
    if quantize_embed:
        out["embed"] = quantize_embedding(out["embed"])
    return out


def quantize_params(params: Dict, modules: Sequence[str] = ("text",),
                    quantize_embed: bool = False, bits: int = 8) -> Dict:
    """Quantize the selected modules of a Dattn parameter tree: "text" to
    weight-only int8 / int4, "vision" / "audio" to int8 towers."""
    out = dict(params)
    if "text" in modules:
        out["text"] = quantize_text_params(params["text"], quantize_embed, bits=bits)
    for tower in ("vision", "audio"):
        if tower in modules and tower in params:
            out[tower] = quantize_tower_params(params[tower])
    return out


def quantize_cache(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """KV cache [..., S, D] -> {qi8 int8, scale f32 [..., S, 1]}, per token."""
    q, scale = _symmetric(x.float(), -1, 127)
    return {QUANT_KEY: q, "scale": scale}


def dequantize_cache(xq, dtype=torch.bfloat16) -> torch.Tensor:
    if not is_quantized(xq):
        return xq
    return (xq[QUANT_KEY].float() * xq["scale"]).to(dtype)


def tree_leaves(tree):
    """The tensors of a parameter tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def quantized_bytes(params: Dict) -> int:
    """Total parameter bytes (for memory reporting)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
