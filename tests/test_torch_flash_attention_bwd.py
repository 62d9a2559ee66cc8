"""K4: the port's plain flash-attention backward (the CUDA kernel's CPU twin)
against `jax.vjp` through the Pallas `flash_attention` in interpret mode,
whose custom VJP runs the Pallas backward kernels `_dq_kernel` and
`_dkv_kernel`; and K1's autograd Function, whose backward is K4.

Tolerance: fp32, max |error| <= 1e-5 of each output's largest magnitude.
Both sides evaluate the same fp32 formulas (p recomputed from lse, dz = p
(dp - di)); the Pallas kernels sum tile by tile and the plain version over
whole rows, which moves results by a few fp32 ulps of the largest terms.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.ops.pallas import flash_attention as fa
from vidi_tpu_torch.ops.cuda import flash_attention as k1
from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4

fa.INTERPRET = True  # CPU test mesh: run the Pallas kernels interpreted

REL = 1e-5


def _close(got, want, name):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    top = float(np.abs(want).max())
    assert err <= REL * top, f"{name}: max |err| {err:.3e} over {REL} x {top:.3e}"


def _case(b, t, s, hq, hk, d, seed, q_gain=3.0):
    rng = np.random.default_rng(seed)
    q = (q_gain * rng.standard_normal((b, t, hq, d))).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    do = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    return q, k, v, do


def _check_against_pallas(q, k, v, do, mask, scale, causal, window, softcap,
                          segs=None):
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731

    def f(q_, k_, v_):
        return fa.flash_attention(q_, k_, v_, j(mask), scale, causal, window,
                                  softcap, 128, 128, j(segs), j(segs))

    _, vjp = jax.vjp(f, j(q), j(k), j(v))
    want = vjp(j(do))
    out, lse = k1.flash_attention_plain(t(q), t(k), t(v), t(mask), scale, causal,
                                        window, softcap, q_segs=t(segs),
                                        kv_segs=t(segs))
    got = k4.flash_attention_bwd_plain(t(q), t(k), t(v), t(mask), out, lse, t(do),
                                       scale, causal, window, softcap,
                                       q_segs=t(segs), kv_segs=t(segs))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)
    return got


@pytest.mark.parametrize("t,window,softcap", [
    (160, 64, 50.0),   # Gemma2 sliding layer, T not a multiple of the tile
    (100, 16, 30.0),   # ragged T, narrow window
    (128, None, None),  # plain causal, GQA group of 2
])
def test_causal_window_softcap(t, window, softcap):
    q, k, v, do = _case(2, t, t, 4, 2, 32, seed=t)
    mask = np.ones((2, t), np.int32)
    mask[1, t - 13:] = 0  # right-padded prompt
    _check_against_pallas(q, k, v, do, mask, 0.125, True, window, softcap)


@pytest.mark.parametrize("t,s,hq,hk,softcap", [
    (64, 288, 4, 2, 50.0),   # T2V-like: masked keys, GQA group of 2
    (100, 200, 8, 2, None),  # T and S not multiples of 128, GQA group of 4
])
def test_cross_attention_with_masked_keys(t, s, hq, hk, softcap):
    q, k, v, do = _case(2, t, s, hq, hk, 64, seed=s)
    mask = np.ones((2, s), np.int32)
    mask[0, s - 37:] = 0
    mask[1, ::3] = 0
    _, dk, dv = _check_against_pallas(q, k, v, do, mask, 0.11, False, None, softcap)
    dead = torch.from_numpy(mask == 0)
    assert not dk[dead].any() and not dv[dead].any()  # masked keys get nothing


def test_segments_and_fully_masked_sample():
    """Packing segment ids (positions restart per segment; the index rule
    holds because segments are contiguous), and a sample whose kv_mask is
    all zero: its rows carry the sentinel lse and get no gradient."""
    t = 96
    q, k, v, do = _case(2, t, t, 4, 2, 32, seed=7)
    segs = np.zeros((2, t), np.int32)
    segs[0, :40], segs[0, 40:90] = 1, 2
    segs[1, :70] = 1
    mask = np.ones((2, t), np.int32)
    mask[1] = 0
    dq, dk, dv = _check_against_pallas(q, k, v, do, mask, 0.2, True, 48, 50.0, segs)
    assert not dq[1].any() and not dk[1].any() and not dv[1].any()


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 24, 50.0), (False, None, None)])
def test_function_backward_is_k4(causal, window, softcap):
    """K1's autograd Function: `out` has the Function's backward as its
    grad_fn, lse carries no gradient, and q/k/v gradients equal autograd
    through `flash_attention_plain`."""
    q, k, v, do = (torch.from_numpy(x) for x in _case(2, 40, 40, 4, 2, 16, seed=3))
    mask = torch.ones((2, 40), dtype=torch.bool)
    mask[1, 33:] = False
    args = (mask, 0.25, causal, window, softcap)

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out, lse = fn(*leaves, *args)
        return out, lse, torch.autograd.grad(out, leaves, do)

    before = k4.launches
    out, lse, got = grads(k1.flash_attention)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert not lse.requires_grad
    _, _, want = grads(k1.flash_attention_plain)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w.numpy(), name)
    assert k4.launches == before  # CPU tensors take the plain version


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor selects the plain version: any other device goes
    to the kernel launch, which raises here (no card, no fallback)."""
    q, k, v, do = (torch.from_numpy(x).to("meta") for x in _case(1, 20, 20, 2, 1, 16, 0))
    lse = torch.zeros((1, 2, 20), device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        k4.flash_attention_bwd(q, k, v, None, q, lse, do, 0.25, True)
