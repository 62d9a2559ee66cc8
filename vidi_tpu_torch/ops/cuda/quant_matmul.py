"""K6: W8A8 int8 matmuls (csrc/quant_matmul.cu on the shared int8 core of
csrc/int8_gemm.cuh).

Replaces the Pallas kernels of `vidi_tpu.ops.pallas.quant_matmul`:

- `quant_matmul(x, wq, wscale, bias)`: per-row int8 quantize of x, int8 x
  int8 -> int32, x sx x sw (per column), cast to x's dtype, then + bias in
  the bias's dtype (outside the kernel, as in JAX). It is
  `infer.quantize.dynamic_qdense`, which every W8A8 product of the decoder
  reaches through `qdot`.
- `quant_gated_mlp(x, gate_w, up_w, down_w, hidden_act)`: one shared
  quantize of x, the gate and up products each rescaled and cast,
  act(gate) * up in x's dtype, then `quant_matmul` for the down
  projection, its rows quantized by `shared_row_amax` as
  `dynamic_qdense`'s are. The decoder's W8A8 FFN (`models/decoder.mlp`).
- the row-scale mode: `quant_matmul(..., amax=)` quantizes row r of x by
  amax[r] / 127 (1 where it is 0) instead of by its own absmax, and
  `row_amax(x)` is the reduction half alone (each row's absmax, fp32). A
  product whose contraction dim is cut over the "model" group (o and down
  under tensor parallelism) quantizes each rank's slice of a row by the
  whole row's absmax: the max over the group of the ranks' `row_amax`
  (`infer.quantize.shared_row_amax`). Given the absmax it would have
  computed itself, the mode is bit-equal to the plain call.

Both reproduce the jnp W8A8 path, the numerics of record. The plain
versions compute the int8 products in float64, exact below 2^53 (the int32
sums reach 2.3e8 at K = 14,336, past fp32's 2^24), then round to fp32 as
the int32 -> fp32 convert does. Each wrapper takes its plain version for a
CPU tensor and launches the kernel, or raises, for a CUDA tensor; `launches`
counts the calls that launched, per function.

On the card the products run on Hopper's 8-bit `wgmma`, which reads both
operands k-contiguous. The weights stay [K, N] with N contiguous (the
layout of the JAX tree, of `infer/quantize.py` and of every plain version);
`kmajor` hands the kernel a K-major copy [N, K], made once per weight by a
byte-transpose kernel (`launches["kmajor_copy"]` counts them) and kept in
`KMAJOR` (a weight stored K-major, as the towers' are, is its own K-major
form: no copy), a least-recently-used cache bounded by `KMAJOR_LIMIT_BYTES` of
copies: the 735-row chunks of one layer's diagonal update call o, gate, up
and down 32 times each with the same weight, so a copy is paid once in 32,
while a second resident copy of every int8 weight would undo what int8
loading is for. The cache refers to the weights weakly: a dropped model's
copies go with it. `gemm_plan` says how a product is cut into blocks.
"""
from __future__ import annotations

import collections
import weakref
from typing import NamedTuple

import torch

from vidi_tpu_torch.infer import quantize
from vidi_tpu_torch.infer.quantize import QUANT_KEY, quantize_act
from vidi_tpu_torch.ops.basic import gelu_tanh
from vidi_tpu_torch.ops.cuda import _lib

launches = {"quant_matmul": 0, "quant_gated_mlp": 0, "kmajor_copy": 0, "row_amax": 0,
            "quant_matmul_amax": 0}
ACTIVATIONS = {"gelu_tanh": 0, "gelu": 1, "quick_gelu": 2, "silu": 3}  # csrc/int8_gemm.cuh
# the GEMM's tile and cluster (csrc/int8_gemm.cuh): rows, staged columns, k
# values a step; tiles of a cluster (along M)
TILE_M, TILE_N, TILE_K = 128, 256, 128
CLUSTER_M = 2
KMAJOR_LIMIT_BYTES = 256 * 2**20


class GemmPlan(NamedTuple):
    """How the int8 GEMM cuts [m, k] . [k, n] into blocks: `tiles_m` x
    `tiles_n` output tiles of TILE_M rows x `cols` columns, `steps` k-steps
    of TILE_K, on a grid of whole clusters along M (`grid_m` x `tiles_n`
    blocks: one past the last tile only feeds its cluster), numbered along M
    first when `m_fast`."""
    tiles_m: int
    tiles_n: int
    cols: int
    steps: int
    grid_m: int
    m_fast: bool

    @property
    def grid(self) -> tuple:
        """(blocks along x, blocks along y) of one matrix."""
        return (self.grid_m, self.tiles_n) if self.m_fast else (self.tiles_n, self.grid_m)

    def origin(self, bx: int, by: int) -> tuple:
        """(first row, first column) of the tile block (bx, by) computes."""
        tile_m, tile_n = (bx, by) if self.m_fast else (by, bx)
        return tile_m * TILE_M, tile_n * self.cols


def gemm_plan(m: int, n: int, k: int, gated: bool = False) -> GemmPlan:
    """The blocks of one product, as `vidi_int8::gemm` lays them out. A gated
    tile holds 128 columns of gate and the same 128 of up. Blocks are
    numbered along the dimension with fewer tiles first, so those that run
    together share the other operand in L2. K is never split: parts of K
    through an int32 workspace measured level or slower at the one shape
    with fewer tiles than SMs and a long K (the 9B's down projection)."""
    cols = TILE_N // 2 if gated else TILE_N
    tiles_m, tiles_n, steps = -(-m // TILE_M), -(-n // cols), -(-k // TILE_K)
    grid_m = -(-tiles_m // CLUSTER_M) * CLUSTER_M
    return GemmPlan(tiles_m, tiles_n, cols, steps, grid_m, grid_m < tiles_n)


class KMajorCache:
    """K-major copies [N, K] of int8 weights [K, N], least recently used
    first out, bounded by the bytes of the copies it holds.

    An entry is keyed by the weight tensor object and refers to it weakly:
    the cache keeps no weight alive, and when a weight dies a finalizer
    drops its entry and frees the copy's bytes. So a dropped model leaves the
    card with its copies, and a temporary weight (the folded o_proj of each
    `_xattn_block` call) leaves the cache when it is freed; an id or address
    that a later tensor takes can never find a dead weight's copy. An
    in-place edit of the weight bumps its `_version`, which the entry
    records: the next call copies anew.
    """

    def __init__(self, limit_bytes: int = KMAJOR_LIMIT_BYTES):
        self.limit_bytes = limit_bytes
        # id(w) -> (weakref to w, version, copy, finalizer)
        self.entries = collections.OrderedDict()
        self.bytes = 0
        self.hits = self.misses = 0

    def get(self, w: torch.Tensor) -> torch.Tensor:
        entry = self.entries.get(id(w))
        if entry is not None and entry[0]() is w and entry[1] == w._version:
            self.entries.move_to_end(id(w))
            self.hits += 1
            return entry[2]
        self.misses += 1
        self._drop(id(w))
        copy = transpose_int8(w)
        size = copy.numel()
        if size <= self.limit_bytes:
            key = id(w)
            self.entries[key] = (weakref.ref(w), w._version, copy,
                                 weakref.finalize(w, self._drop, key))
            self.bytes += size
            while self.bytes > self.limit_bytes:
                self._drop(next(iter(self.entries)))
        return copy

    def _drop(self, key) -> None:
        entry = self.entries.pop(key, None)
        if entry is not None:
            self.bytes -= entry[2].numel()
            entry[3].detach()

    def clear(self) -> None:
        for key in list(self.entries):
            self._drop(key)
        self.hits = self.misses = 0


KMAJOR = KMajorCache()


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """The K-major form [N, K] of an int8 weight [K, N]: `w.t()` itself,
    with no copy and no cache entry, where the weight is stored K-major (the
    towers' weights, `infer.quantize.quantize_tower_layer`), else its copy
    from `KMAJOR`."""
    wt = w.t()
    return wt if wt.is_contiguous() else KMAJOR.get(w)


def transpose_int8(w: torch.Tensor) -> torch.Tensor:
    """w [K, N] int8 -> a contiguous [N, K]: plain PyTorch on the CPU, the
    byte-transpose kernel on the card."""
    if w.device.type == "cpu":
        return w.t().contiguous()
    k, n = w.shape
    wt = torch.empty((n, k), dtype=torch.int8, device=w.device)
    _lib.call("vidi_int8_transpose", w.device, w.data_ptr(), wt.data_ptr(), k, n)
    launches["kmajor_copy"] += 1
    return wt


def int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [..., K] int8 @ wq [K, N] int8 -> the exact int32 sums as fp32."""
    return (xq.double() @ wq.double()).float()


def _col_scale(scale: torch.Tensor) -> torch.Tensor:
    return scale.reshape(scale.shape[-1]).float()


def quant_matmul(x, wq, wscale, bias=None, amax=None):
    """x [..., K] @ wq int8 [K, N] with per-column scales [N] (or [1, N]) ->
    [..., N] in x's dtype, + bias. `amax` [...] fp32: the absmax each row
    is quantized by (the row-scale mode), None: the row's own."""
    out = quant_matmul_plain(x, wq, wscale, amax=amax) if x.device.type == "cpu" \
        else _launch_matmul(x, wq, wscale, amax=amax)
    return out if bias is None else out + bias


def quant_matmul_plain(x, wq, wscale, bias=None, amax=None):
    xq, sx = quantize_act(x, amax)
    y = (int8_dot(xq, wq) * sx * _col_scale(wscale)).to(x.dtype)
    return y if bias is None else y + bias


def row_amax(x):
    """x [..., K] -> each row's absmax [...] in fp32: the reduction half of
    the row pass (its kernel on a CUDA tensor, its plain version on a CPU
    tensor)."""
    if x.device.type == "cpu":
        return row_amax_plain(x)
    x2, k = rows(x, "row_amax x")
    out = torch.empty((x2.shape[0],), dtype=torch.float32, device=x.device)
    _lib.call("vidi_row_amax", x.device, x2.data_ptr(), out.data_ptr(), x2.shape[0], k,
              x.dtype == torch.bfloat16)
    launches["row_amax"] += 1
    return out.reshape(x.shape[:-1])


def row_amax_plain(x):
    return x.float().abs().amax(dim=-1)


def _act(x, hidden_act: str):
    return gelu_tanh(x) if hidden_act == "gelu_tanh" else torch.nn.functional.silu(x)


def quant_gated_mlp(x, gate_w, up_w, down_w, hidden_act: str):
    """act(x @ gate) * (x @ up) @ down with {qi8, scale} weights, all W8A8;
    `hidden_act` is "gelu_tanh" (Gemma2) or anything else for silu. Each
    row of the hidden h is quantized for the down product by
    `shared_row_amax(h, down_w)`: h's own absmax, or the model group's when
    down is cut on "model"."""
    if x.device.type == "cpu":
        return quant_gated_mlp_plain(x, gate_w, up_w, down_w, hidden_act)
    h = _launch_gated(x, gate_w, up_w, hidden_act)
    return quant_matmul(h, down_w[QUANT_KEY], down_w["scale"],
                        amax=quantize.shared_row_amax(h, down_w))


def quant_gated_mlp_plain(x, gate_w, up_w, down_w, hidden_act: str):
    xq, sx = quantize_act(x)
    g = (int8_dot(xq, gate_w[QUANT_KEY]) * sx * _col_scale(gate_w["scale"])).to(x.dtype)
    u = (int8_dot(xq, up_w[QUANT_KEY]) * sx * _col_scale(up_w["scale"])).to(x.dtype)
    h = _act(g, hidden_act) * u
    return quant_matmul_plain(h, down_w[QUANT_KEY], down_w["scale"],
                              amax=quantize.shared_row_amax(h, down_w))


def check_int8_weight(w, scale, k: int, name: str, kmajor_stored: bool = False,
                      on_card: bool = True) -> int:
    """Raise unless w is a contiguous CUDA int8 [k, N] (with `kmajor_stored`
    also the [k, N] view of a contiguous [N, k], the towers' layout; with
    `on_card` False on any device) with N % 16 == 0 (the GEMM stores its
    output 16 bytes at a time) and scale holds N fp32 values; -> N."""
    laid_out = w.is_contiguous() or (kmajor_stored and w.dim() == 2 and w.t().is_contiguous())
    if not (w.dtype == torch.int8 and w.dim() == 2 and laid_out):
        raise TypeError(f"{name}: expected a contiguous int8 matrix, got "
                        f"{w.dtype} {tuple(w.shape)} strides {w.stride()}")
    n = w.shape[1]
    if w.shape[0] != k or n % 16:
        raise ValueError(f"{name}: expected [{k}, N] with N % 16 == 0, got {tuple(w.shape)}")
    if scale.dtype != torch.float32 or scale.numel() != n or not scale.is_contiguous():
        raise ValueError(f"{name}: scale must hold {n} contiguous fp32 values, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if on_card and not (w.is_cuda and scale.device == w.device):
        raise TypeError(f"{name}: expected CUDA tensors on one device, got {w.device} "
                        f"and {scale.device}")
    return n


def rows(x, name: str):
    """x [..., K] on the card -> (contiguous [M, K], K); the kernels take
    bf16 or fp32 with K % 16 == 0 (TMA reads int8 rows whose starts are
    16-byte aligned)."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: expected a bf16 / fp32 tensor, got {x.dtype}")
    k = x.shape[-1]
    if k % 16:
        raise ValueError(f"{name}: the contraction dim must be a multiple of 16, got {k}")
    if x.numel() == 0:
        raise ValueError(f"{name}: no rows")
    if not x.is_cuda:
        raise TypeError(f"{name}: expected a CUDA tensor, got {x.device}")
    return x.reshape(-1, k).contiguous(), k


def scratch(m: int, k: int, device):
    """Per-row int8 copy and scales of an [m, k] operand."""
    return (torch.empty((m, k), dtype=torch.int8, device=device),
            torch.empty((m,), dtype=torch.float32, device=device))


def _launch_matmul(x, wq, wscale, wt=None, amax=None):
    """`wt`: the K-major copy to read instead of `kmajor(wq)`; `amax`: the
    rows' given absmax (fp32, one a row, on x's device)."""
    x2, k = rows(x, "quant_matmul x")
    n = check_int8_weight(wq, wscale, k, "quant_matmul wq")
    m = x2.shape[0]
    if amax is not None:
        if amax.dtype != torch.float32 or amax.numel() != m or amax.device != x.device:
            raise ValueError(f"quant_matmul amax: expected {m} fp32 values on {x.device}, "
                             f"got {amax.dtype} {tuple(amax.shape)} on {amax.device}")
        amax = amax.reshape(m).contiguous()
    if wt is None:
        wt = kmajor(wq)
    xq, sx = scratch(m, k, x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _lib.call("vidi_quant_matmul", x.device, x2.data_ptr(), xq.data_ptr(), sx.data_ptr(),
              0 if amax is None else amax.data_ptr(), wt.data_ptr(), wscale.data_ptr(),
              out.data_ptr(), m, n, k, x.dtype == torch.bfloat16)
    launches["quant_matmul" if amax is None else "quant_matmul_amax"] += 1
    return out.reshape(*x.shape[:-1], n)


def _launch_gated(x, gate_w, up_w, hidden_act):
    x2, k = rows(x, "quant_gated_mlp x")
    n = check_int8_weight(gate_w[QUANT_KEY], gate_w["scale"], k, "quant_gated_mlp gate_w")
    if check_int8_weight(up_w[QUANT_KEY], up_w["scale"], k, "quant_gated_mlp up_w") != n:
        raise ValueError("quant_gated_mlp: gate and up widths differ")
    m = x2.shape[0]
    gt, ut = kmajor(gate_w[QUANT_KEY]), kmajor(up_w[QUANT_KEY])
    xq, sx = scratch(m, k, x.device)
    h = torch.empty((m, n), dtype=x.dtype, device=x.device)
    act = ACTIVATIONS["gelu_tanh" if hidden_act == "gelu_tanh" else "silu"]
    _lib.call("vidi_quant_gated", x.device, x2.data_ptr(), xq.data_ptr(), sx.data_ptr(),
              gt.data_ptr(), gate_w["scale"].data_ptr(), ut.data_ptr(),
              up_w["scale"].data_ptr(), h.data_ptr(), m, n, k, act, x.dtype == torch.bfloat16)
    launches["quant_gated_mlp"] += 1
    return h.reshape(*x.shape[:-1], n)
