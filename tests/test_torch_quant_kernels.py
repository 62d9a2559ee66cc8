"""The plain versions of K5 (fused int8 tower layer), K6 (W8A8 matmuls) and
K7 (fused RMSNorm) against the Pallas kernels of vidi_tpu, run in interpret
mode on the CPU, on the same numpy inputs and quantized weights.

Tolerances are the JAX package's own for these kernels
(tests/test_quant_fused.py): 2e-5 in fp32; 2e-2 in bf16, where a one-ulp
shift of a row's amax between the two frameworks' bf16 roundings re-rounds
that whole row's int8 codes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidi_tpu.infer.quantize import quantize_tower_params, quantize_weight
from vidi_tpu.models import siglip as jsiglip
from vidi_tpu.ops.pallas import fused_rmsnorm as jfr
from vidi_tpu.ops.pallas import fused_tower_layer as jftl
from vidi_tpu.ops.pallas import quant_matmul as jqm
from vidi_tpu.core.config import VisionConfig
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.ops.cuda import fused_rmsnorm as tfr
from vidi_tpu_torch.ops.cuda import fused_tower_layer as tftl
from vidi_tpu_torch.ops.cuda import quant_matmul as tqm

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for mod in (jftl, jqm, jfr):
        monkeypatch.setattr(mod, "INTERPRET", True)


def _np(x):
    return np.asarray(jax.device_get(x).astype(jnp.float32))


def _pair(a, dtype):
    """The same values as a jnp array and a torch tensor of `dtype`."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _layer(ff, seed, dtype, bias_scale=0.1):
    """One quantized SigLIP-layout layer (d = 256, ff padded to 128) with
    non-zero biases and LN parameters, as a JAX dict and the port's."""
    cfg = VisionConfig(hidden_size=256, intermediate_size=ff, num_layers=1, num_heads=4,
                       patch_size=16, image_size=64)
    params = jsiglip.init_params(jax.random.key(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    for key in ("q_b", "k_b", "v_b", "o_b", "fc1_b", "fc2_b", "ln1_bias", "ln2_bias"):
        layers[key] = jnp.asarray(rng.standard_normal(layers[key].shape) * bias_scale,
                                  jnp.float32)
    for key in ("ln1_scale", "ln2_scale"):
        layers[key] = jnp.asarray(1 + rng.standard_normal(layers[key].shape) * 0.1,
                                  jnp.float32)
    qp = quantize_tower_params({**params, "layers": layers})
    jl = jax.tree.map(lambda a: a[0], qp["layers"])
    jl = {k: (v if isinstance(v, dict) else v.astype(getattr(jnp, dtype)))
          for k, v in jl.items()}
    return jl, params_from_jax(jax.device_get(jl))


def _x(seed, shape, ragged=True):
    """N(0, 1) values; `ragged` scales each row by a gain in [e^-2, e]."""
    rng = np.random.default_rng(seed)
    gains = np.exp(rng.uniform(-2, 1, shape[:-1] + (1,))) if ragged else 1.0
    return (rng.standard_normal(shape) * gains).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act, ff", [("gelu_tanh", 456), ("gelu", 512),
                                     ("quick_gelu", 384)])
def test_tower_layer_pieces_match_pallas(dtype, act, ff):
    """ln_qkv, o_residual and ln_ffn on 2 x 13 rows (not a multiple of 8);
    ff 456 runs padded to 512."""
    jl, tl = _layer(ff, 1, dtype)
    for key, val in tl.items():
        if not isinstance(val, dict):
            tl[key] = val.to(getattr(torch, dtype))
    assert tl["fc1_w"]["qi8"].shape[-1] % 128 == 0
    jx, tx = _pair(_x(2, (2, 13, 256)), dtype)
    for j, t in zip(jftl.ln_qkv(jx, jl, 1e-6), tftl.ln_qkv_plain(tx, tl, 1e-6)):
        np.testing.assert_allclose(t.float().numpy(), _np(j), **TOL[dtype])
    ja, ta = _pair(_x(3, (2, 13, 256)), dtype)
    np.testing.assert_allclose(tftl.o_residual_plain(ta, tx, tl).float().numpy(),
                               _np(jftl.o_residual(ja, jx, jl)), **TOL[dtype])
    np.testing.assert_allclose(tftl.ln_ffn_plain(tx, tl, 1e-5, act).float().numpy(),
                               _np(jftl.ln_ffn(jx, jl, 1e-5, act)), **TOL[dtype])


def test_tower_wrappers_take_the_plain_version_on_the_cpu():
    _, tl = _layer(512, 4, "float32")
    x = torch.from_numpy(_x(5, (3, 256)))
    for got, want in zip(tftl.ln_qkv(x, tl, 1e-6), tftl.ln_qkv_plain(x, tl, 1e-6)):
        assert torch.equal(got, want)
    assert torch.equal(tftl.o_residual(x, x, tl), tftl.o_residual_plain(x, x, tl))
    assert torch.equal(tftl.ln_ffn(x, tl, 1e-6, "gelu"), tftl.ln_ffn_plain(x, tl, 1e-6, "gelu"))
    assert tftl.launches == {"ln_qkv": 0, "o_residual": 0, "ln_ffn": 0}


def _wq(seed, shape):
    w = _x(seed, shape) * 0.05
    jw = quantize_weight(jnp.asarray(w))
    return jw, params_from_jax(jax.device_get(jw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_matches_pallas(dtype):
    jw, tw = _wq(6, (384, 200))
    jx, tx = _pair(_x(7, (3, 37, 384)), dtype)
    jb, tb = _pair(_x(8, (200,)), dtype)
    want = jqm.quant_matmul(jx, jw["qi8"], jw["scale"][0], jb)
    got = tqm.quant_matmul(tx, tw["qi8"], tw["scale"], tb)
    assert got.dtype == tx.dtype and got.shape == (3, 37, 200)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu_tanh", "silu"])
def test_quant_gated_mlp_matches_pallas(dtype, act):
    (jg, tg), (ju, tu), (jd, td) = _wq(9, (256, 384)), _wq(10, (256, 384)), _wq(11, (384, 256))
    # unit rows, as the JAX package's own test: 2e-2 is an absolute limit
    # there, and a re-rounded row moves by ~1% of its largest value
    jx, tx = _pair(_x(12, (45, 256), ragged=dtype == "float32"), dtype)
    want = jqm.quant_gated_mlp(jx, jg, ju, jd, act)
    got = tqm.quant_gated_mlp(tx, tg, tu, td, act)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_scale_mode_with_its_own_absmax_is_bit_equal(dtype):
    """K6's row-scale mode given the absmax `quantize_act` takes itself (a
    row of zeros included: its scale is 1) is today's call, bit for bit,
    and `row_amax_plain` is that absmax."""
    _, tw = _wq(13, (384, 208))
    _, tx = _pair(_x(14, (2, 29, 384)), dtype)
    tx[1, 3] = 0
    own = tx.float().abs().amax(-1)
    assert torch.equal(tqm.row_amax_plain(tx), own) and torch.equal(tqm.row_amax(tx), own)
    for given in (own, tqm.row_amax(tx)):
        got = tqm.quant_matmul_plain(tx, tw["qi8"], tw["scale"], amax=given)
        assert torch.equal(got, tqm.quant_matmul(tx, tw["qi8"], tw["scale"]))


def test_row_scale_mode_sums_k_halves_to_the_whole_product():
    """Two halves of K, each quantized by the shared row absmax (the max of
    the halves' `row_amax`), each rescaled, summed: the whole product
    within 1e-6 relative; each half's own absmax re-rounds its codes."""
    _, tw = _wq(15, (512, 96))
    _, tx = _pair(_x(16, (40, 512)), "float32")
    tx[:, 7] *= 30  # the row's absmax in the first half
    halves = [(tx[:, :256], tw["qi8"][:256]), (tx[:, 256:], tw["qi8"][256:])]
    shared = torch.maximum(*(tqm.row_amax(x) for x, _ in halves))
    whole = tqm.quant_matmul(tx, tw["qi8"], tw["scale"])

    def summed(amax):
        return sum(tqm.quant_matmul(x, w, tw["scale"], amax=amax) for x, w in halves)

    rel = float((summed(shared) - whole).norm() / whole.norm())
    assert rel <= 1e-6, rel
    assert float((summed(None) - whole).norm() / whole.norm()) > 1e-3


def test_int8_dot_is_exact_past_fp32():
    """K = 14,336 rows of +-127: sums up to 2.3e8, past fp32's 2^24."""
    xq = torch.full((2, 14336), 127, dtype=torch.int8)
    xq[1, ::2] = -127
    wq = torch.full((14336, 3), 127, dtype=torch.int8)
    wq[7, 1] = 126
    got = tqm.int8_dot(xq, wq)
    want = (xq.long() @ wq.long()).float()  # exact int64 sums, rounded once to fp32
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus_one", [True, False])
def test_fused_rms_norm_matches_pallas(dtype, plus_one):
    jx, tx = _pair(_x(13, (3, 17, 64)), dtype)
    jw, tw = _pair(np.random.default_rng(14).standard_normal(64).astype(np.float32) * 0.1,
                   dtype)
    want = jfr.fused_rms_norm(jx, jw, eps=1e-6, plus_one=plus_one)
    got = tfr.fused_rms_norm(tx, tw, eps=1e-6, plus_one=plus_one)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])
    assert tfr.launches == 0
