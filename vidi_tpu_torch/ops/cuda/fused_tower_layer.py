"""K5: the int8 encoder-tower layer (csrc/fused_tower_layer.cu on the shared
int8 core of csrc/int8_gemm.cuh).

Replaces the Pallas kernels of `vidi_tpu.ops.pallas.fused_tower_layer`,
three pieces per SigLIP / Whisper layer whose matmul weights are {qi8,
scale} dicts (`infer.quantize.quantize_tower_layer`):

  ln_qkv      x -> LN1 (fp32) -> cast -> per-row int8 once -> q, k, v
  o_residual  residual + (int8(attn) @ o_w + o_b)
  ln_ffn      x + fc2(int8(act(fc1(int8(LN2(x))) + b1)) + b2)

Each product is rescaled (x sx x sw), gets its fp32 bias and is cast ONCE
(`_qdot` of the JAX module: no extra rounding per projection); the
activation runs in the activation dtype and the residual add too. These
are the Pallas kernels' numerics, and in fp32 also the jnp path's. Exact
gelu is `erf`'s. The plain versions repeat them in PyTorch with exact
float64 int8 products. Each wrapper takes its plain version for a CPU
tensor and launches the kernel, or raises, for a CUDA tensor; `launches`
counts the calls that launched, per function. No environment switch and
no lane rule: on the card every int8 tower layer runs here.

The kernels read each weight in its K-major form (`quant_matmul.kmajor`),
which the towers store from load (`infer.quantize.quantize_tower_layer`):
no copy a call. The fp32 LayerNorm parameters and biases the kernels read
(zeros for Whisper's absent k bias) are made once a layer by `prepare` and
kept in `PREPARED`, which refers to the layer's weights weakly and checks
each source tensor's identity and `_version`, so a layer whose parameters
were replaced or edited in place is prepared anew. Each piece's products
run on one launch of the persistent GEMM of csrc/int8_gemm_pp.cuh;
`tower_plan` says which tiles each block and each of its two consumer
warpgroups computes.
"""
from __future__ import annotations

import operator
import weakref
from typing import NamedTuple

import torch

from vidi_tpu_torch.infer.quantize import QUANT_KEY, quantize_act
from vidi_tpu_torch.ops.basic import layer_norm, tower_act
from vidi_tpu_torch.ops.cuda import _lib
from vidi_tpu_torch.ops.cuda.quant_matmul import (ACTIVATIONS, TILE_K, check_int8_weight,
                                                  int8_dot, kmajor, rows, scratch)

launches = {"ln_qkv": 0, "o_residual": 0, "ln_ffn": 0}
# the persistent GEMM's tile (csrc/int8_gemm_pp.cuh): rows x columns of one
# consumer warpgroup's tile; consumers a block
PP_TILE_M, PP_TILE_N, PP_CONSUMERS = 128, 128, 2


class TowerPlan(NamedTuple):
    """How `vidi_int8::gemm_pp` runs `n_mats` products [m, k] . [k, n]: one
    list of `total` tiles of PP_TILE_M x PP_TILE_N (rows first, then columns,
    then product), `steps` k-steps of TILE_K each, on `blocks` persistent
    blocks; block b takes tiles b, b + blocks, ..., and its j-th tile goes to
    consumer j % PP_CONSUMERS."""
    m: int
    n: int
    n_mats: int
    steps: int
    tiles_m: int
    tiles_n: int
    blocks: int

    @property
    def total(self) -> int:
        return self.tiles_m * self.tiles_n * self.n_mats

    def tile(self, t: int) -> tuple:
        """(product, first row, first column) of tile t."""
        z, r = divmod(t, self.tiles_m * self.tiles_n)
        return z, (r % self.tiles_m) * PP_TILE_M, (r // self.tiles_m) * PP_TILE_N

    def block_tiles(self, b: int) -> list:
        return [self.tile(t) for t in range(b, self.total, self.blocks)]

    def consumer_tiles(self, b: int, c: int) -> list:
        return self.block_tiles(b)[c::PP_CONSUMERS]


def tower_plan(m: int, n: int, k: int, n_mats: int = 1, sms: int = 132) -> TowerPlan:
    """The persistent schedule of one K5 GEMM launch on a card of `sms` SMs."""
    tiles_m, tiles_n = -(-m // PP_TILE_M), -(-n // PP_TILE_N)
    return TowerPlan(m, n, n_mats, -(-k // TILE_K), tiles_m, tiles_n,
                     min(tiles_m * tiles_n * n_mats, sms))


def piece_plans(m: int, d: int, ff: int, sms: int = 132) -> dict:
    """The GEMM launches of one tower layer of m rows: qkv (three products in
    one launch), o, fc1 and fc2."""
    return {"qkv": tower_plan(m, d, d, 3, sms), "o": tower_plan(m, d, d, 1, sms),
            "fc1": tower_plan(m, ff, d, 1, sms), "fc2": tower_plan(m, d, ff, 1, sms)}


# each piece's int8 weights and the fp32 tensors its kernel reads besides them
_PIECES = {"ln_qkv": (("q_w", "k_w", "v_w"), ("ln1_scale", "ln1_bias", "q_b", "k_b", "v_b")),
           "o_residual": (("o_w",), ("o_b",)),
           "ln_ffn": (("fc1_w", "fc2_w"), ("ln2_scale", "ln2_bias", "fc1_b", "fc2_b"))}
_OPTIONAL = ("k_b",)  # Whisper's k projection has no bias: zeros
# (id of the piece's first int8 weight, piece) -> (Prepared, finalizer)
PREPARED = {}


class Prepared(NamedTuple):
    """One piece of one layer, checked and ready to launch (`prepare`)."""
    refs: tuple      # weak references to each weight's codes and scales
    f32_srcs: tuple  # the fp32 tensors' sources (None: an absent bias)
    versions: tuple  # their `_version`s when the copies were made
    f32: dict        # the fp32 copies by source key
    kmajor: tuple    # each weight's K-major form if it is stored so, else None
    dims: tuple      # each weight's (K, N)
    device: torch.device
    sms: int         # the device's SMs: the persistent GEMM's most blocks
    ptrs: tuple      # the scales' and fp32 tensors' addresses, in the kernel's order


def takes(lp) -> bool:
    """Whether lp is an int8 tower layer with every tensor K5 reads."""
    return all(isinstance(lp.get(k), dict) and QUANT_KEY in lp[k]
               for ws, _ in _PIECES.values() for k in ws) \
        and all(k in lp for _, fs in _PIECES.values() for k in fs if k not in _OPTIONAL)


def prepare(lp, piece: str) -> Prepared:
    """The piece's weights checked once (int8 [K, N], stored K-major or
    contiguous, N % 16 == 0, fp32 scales, one device) and its fp32
    LayerNorm parameters and biases made once (zeros for an absent bias; a
    value's fp32 form is exact, so the kernel reads what the plain versions
    compute with), kept in PREPARED. Each call checks that the layer still
    holds the same tensors, and the fp32 sources the same versions, else
    prepares anew. The entry refers to the weights weakly and leaves with
    the piece's first weight."""
    wkeys, fkeys = _PIECES[piece]
    ws = [lp[k] for k in wkeys]
    fsrc = tuple(lp.get(k) for k in fkeys)
    key = (id(ws[0][QUANT_KEY]), piece)
    entry = PREPARED.get(key)
    if entry is not None:
        rec = entry[0]
        if all(rq() is w[QUANT_KEY] and rs() is w["scale"] for (rq, rs), w in zip(rec.refs, ws)) \
                and all(map(operator.is_, rec.f32_srcs, fsrc)) \
                and rec.versions == tuple(-1 if t is None else t._version for t in fsrc):
            return rec
    _drop(key)
    dev = ws[0][QUANT_KEY].device
    dims, kms = [], []
    for k, w in zip(wkeys, ws):
        q, sc = w[QUANT_KEY], w["scale"]
        n = check_int8_weight(q, sc, q.shape[0], f"fused_tower_layer {k}", kmajor_stored=True,
                              on_card=False)
        if q.device != dev or sc.device != dev:
            raise TypeError(f"fused_tower_layer {k}: weights on {q.device} / {sc.device}, "
                            f"expected {dev}")
        dims.append((q.shape[0], n))
        kms.append(q.t() if q.t().is_contiguous() else None)
    d = dims[0][0]
    f32 = {k: (torch.zeros(d, dtype=torch.float32, device=dev) if t is None
               else t.to(dev, torch.float32).contiguous()) for k, t in zip(fkeys, fsrc)}
    for k in fkeys:
        if f32[k].dim() != 1:
            raise ValueError(f"fused_tower_layer {k}: expected a vector, got "
                             f"{tuple(f32[k].shape)}")
    ptrs = tuple(w["scale"].data_ptr() for w in ws) + tuple(f32[k].data_ptr() for k in fkeys)
    rec = Prepared(tuple((weakref.ref(w[QUANT_KEY]), weakref.ref(w["scale"])) for w in ws),
                   fsrc, tuple(-1 if t is None else t._version for t in fsrc), f32, tuple(kms),
                   tuple(dims), dev, _lib.sm_count(dev) if dev.type == "cuda" else 0, ptrs)
    PREPARED[key] = (rec, weakref.finalize(ws[0][QUANT_KEY], _drop, key))
    return rec


def prepare_layer(lp) -> None:
    """Prepare all three pieces of an int8 tower layer (at quantize time)."""
    for piece in _PIECES:
        prepare(lp, piece)


def _drop(key) -> None:
    entry = PREPARED.pop(key, None)
    if entry is not None:
        entry[1].detach()


def _qdot_plain(hq, sx, w, bias, dtype):
    """int8 product + rescale + fp32 bias, then one cast."""
    y = int8_dot(hq, w[QUANT_KEY]) * sx * w["scale"].reshape(-1).float()
    return (y + bias.float()).to(dtype)


def _bias(lp, key, d, device):
    """The layer's bias as fp32, zeros where it has none (Whisper's k)."""
    b = lp.get(key)
    return torch.zeros(d, dtype=torch.float32, device=device) if b is None else b.float()


def ln_qkv(x, lp, eps: float):
    """x [..., T, d] -> (q, k, v): LN1 + one shared quantize + three int8 dots."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, lp, eps)
    return _launch_ln_qkv(x, lp, eps)


def ln_qkv_plain(x, lp, eps: float):
    d = x.shape[-1]
    hq, sx = quantize_act(layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps))
    return tuple(_qdot_plain(hq, sx, lp[w], _bias(lp, b, d, x.device), x.dtype)
                 for w, b in (("q_w", "q_b"), ("k_w", "k_b"), ("v_w", "v_b")))


def o_residual(attn, residual, lp):
    """residual + attn @ o_w (int8, per-row quantized attn) + o_b."""
    if attn.device.type == "cpu":
        return o_residual_plain(attn, residual, lp)
    return _launch_o_residual(attn, residual, lp)


def o_residual_plain(attn, residual, lp):
    aq, sx = quantize_act(attn)
    return residual + _qdot_plain(aq, sx, lp["o_w"], lp["o_b"], attn.dtype)


def ln_ffn(x, lp, eps: float, hidden_act: str):
    """x + FFN(LN2(x)), both products int8, the hidden requantized per row."""
    if x.device.type == "cpu":
        return ln_ffn_plain(x, lp, eps, hidden_act)
    return _launch_ln_ffn(x, lp, eps, hidden_act)


def ln_ffn_plain(x, lp, eps: float, hidden_act: str):
    hq, sx = quantize_act(layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps))
    a = tower_act(_qdot_plain(hq, sx, lp["fc1_w"], lp["fc1_b"], x.dtype), hidden_act)
    aq, sx2 = quantize_act(a)
    return x + _qdot_plain(aq, sx2, lp["fc2_w"], lp["fc2_b"], x.dtype)


def _weights(rec: Prepared, x, d_in: int):
    """-> the piece's K-major weights (its stored form, else the cached
    copy), after checking x against the prepared piece."""
    if x.device != rec.device:
        raise TypeError(f"fused_tower_layer: x on {x.device}, weights on {rec.device}")
    if rec.dims[0][0] != d_in:
        raise ValueError(f"fused_tower_layer: weights {rec.dims} for rows of {d_in}")
    return [wt if wt is not None else kmajor(r[0]()) for wt, r in zip(rec.kmajor, rec.refs)]


def _launch_ln_qkv(x, lp, eps):
    x2, d = rows(x, "ln_qkv x")
    m = x2.shape[0]
    rec = prepare(lp, "ln_qkv")
    if any(dim != (d, d) for dim in rec.dims):
        raise ValueError(f"ln_qkv: q/k/v weights must be [d, d], got {rec.dims}")
    wq, wk, wv = _weights(rec, x, d)
    xq, sx = scratch(m, d, x.device)
    outs = torch.empty((3, *x.shape), dtype=x.dtype, device=x.device)
    ptr, step = outs.data_ptr(), m * d * x.element_size()
    sq, sk, sv, ln_s, ln_b, bq, bk, bv = rec.ptrs
    _lib.call("vidi_ln_qkv", x.device, x2.data_ptr(), ln_s, ln_b, xq.data_ptr(), sx.data_ptr(),
              wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), sq, sk, sv, bq, bk, bv, ptr,
              ptr + step, ptr + 2 * step, m, d, x.dtype == torch.bfloat16, float(eps), rec.sms)
    launches["ln_qkv"] += 1
    return outs.unbind(0)


def _launch_o_residual(attn, residual, lp):
    a2, d = rows(attn, "o_residual attn")
    if residual.shape != attn.shape or residual.dtype != attn.dtype:
        raise ValueError(f"o_residual: residual {tuple(residual.shape)} {residual.dtype} "
                         f"vs attn {tuple(attn.shape)} {attn.dtype}")
    res2 = residual.reshape(-1, d).contiguous()
    m = a2.shape[0]
    rec = prepare(lp, "o_residual")
    if rec.dims[0] != (d, d):
        raise ValueError(f"o_residual: o_w must be [d, d], got {rec.dims[0]}")
    (w,) = _weights(rec, attn, d)
    so, bo = rec.ptrs
    xq, sx = scratch(m, d, attn.device)
    out = torch.empty((m, d), dtype=attn.dtype, device=attn.device)
    _lib.call("vidi_o_residual", attn.device, a2.data_ptr(), res2.data_ptr(), xq.data_ptr(),
              sx.data_ptr(), w.data_ptr(), so, bo, out.data_ptr(), m, d,
              attn.dtype == torch.bfloat16, rec.sms)
    launches["o_residual"] += 1
    return out.view(attn.shape)


def _launch_ln_ffn(x, lp, eps, hidden_act):
    x2, d = rows(x, "ln_ffn x")
    m = x2.shape[0]
    rec = prepare(lp, "ln_ffn")
    (_, ff), (ff2, n2) = rec.dims
    if ff2 != ff or n2 != d or ff % 16:
        raise ValueError(f"ln_ffn: fc1 [d, ff] / fc2 [ff, d] with ff % 16 == 0, got "
                         f"{rec.dims} for d = {d}")
    w1, w2 = _weights(rec, x, d)
    s1, s2, ln_s, ln_b, b1, b2 = rec.ptrs
    xq, sx = scratch(m, d, x.device)
    hq, hsx = scratch(m, ff, x.device)
    hidden = torch.empty((m, ff), dtype=x.dtype, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    _lib.call("vidi_ln_ffn", x.device, x2.data_ptr(), ln_s, ln_b, xq.data_ptr(), sx.data_ptr(),
              w1.data_ptr(), s1, b1, hidden.data_ptr(), hq.data_ptr(), hsx.data_ptr(),
              w2.data_ptr(), s2, b2, out.data_ptr(), m, d, ff, ACTIVATIONS[hidden_act],
              x.dtype == torch.bfloat16, float(eps), rec.sms)
    launches["ln_ffn"] += 1
    return out.view(x.shape)
