"""K1: the port's plain flash attention (the CUDA kernel's CPU twin) against
the Pallas `flash_attention` run in interpret mode, as
tests/test_flash_attention.py runs it.

Tolerance: atol = rtol = 2e-5 in fp32. Both compute the same masked
online-softmax attention; the Pallas kernel sums tile by tile, the plain
version over the whole row, which moves results by a few ulp of values of
order 1.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.ops.pallas import flash_attention as fa
from vidi_tpu_torch.ops.cuda import flash_attention as k1

fa.INTERPRET = True  # CPU test mesh: run the Pallas kernel interpreted

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(b, t, s, hq, hk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    return q, k, v


def _both(q, k, v, mask, scale, causal, window, softcap, q_segs=None, kv_segs=None):
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    want, want_lse = fa._flash_forward(
        j(q), j(k), j(v), j(mask), scale, causal, window, softcap, 128, 128,
        j(q_segs), j(kv_segs))
    got, got_lse = k1.flash_attention_plain(
        t(q), t(k), t(v), t(mask), scale, causal, window, softcap,
        q_segs=t(q_segs), kv_segs=t(kv_segs))
    return got, got_lse, np.asarray(want), np.asarray(want_lse)[..., 0]


@pytest.mark.parametrize("t,window,softcap", [
    (128, None, None),   # plain causal
    (160, 64, 50.0),     # Gemma2 sliding layer, T not a multiple of the tile
    (100, 16, 30.0),     # ragged T, narrow window
])
def test_causal_window_softcap(t, window, softcap):
    q, k, v = _inputs(2, t, t, 4, 2, 32, seed=t)
    mask = np.ones((2, t), np.int32)
    mask[1, t - 13:] = 0  # right-padded prompt
    got, got_lse, want, want_lse = _both(q, k, v, mask, 0.125, True, window, softcap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **TOL)


@pytest.mark.parametrize("s,hq,hk,softcap", [
    (288, 4, 2, 50.0),   # GQA group of 2, ragged S
    (200, 4, 4, None),   # no GQA
    (130, 8, 2, 50.0),   # GQA group of 4
])
def test_cross_attention_with_mask(s, hq, hk, softcap):
    q, k, v = _inputs(2, 64, s, hq, hk, 64, seed=s)
    mask = np.ones((2, s), np.int32)
    mask[0, s - 37:] = 0
    mask[1, ::3] = 0
    got, got_lse, want, want_lse = _both(q, k, v, mask, 0.11, False, None, softcap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **TOL)


def test_segments_and_empty_rows():
    """Packing segment ids; pad rows (segment 0 against no kv) and a sample
    whose kv_mask is all zero give zeros and the sentinel lse."""
    t = 96
    q, k, v = _inputs(2, t, t, 4, 2, 32, seed=7)
    segs = np.zeros((2, t), np.int32)
    segs[0, :40], segs[0, 40:90] = 1, 2
    segs[1, :70] = 1
    mask = np.ones((2, t), np.int32)
    mask[1] = 0
    got, got_lse, want, want_lse = _both(q, k, v, mask, 0.2, True, None, 50.0,
                                         segs, segs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **TOL)
    assert not got[1].any()
    assert (got_lse[1] == k1.EMPTY_ROW_LSE).all()


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 20, 20, 2, 1, 16))
    before = k1.launches
    out, lse = k1.flash_attention(q, k, v, None, 0.25, True, 8, 50.0)
    want, want_lse = k1.flash_attention_plain(q, k, v, None, 0.25, True, 8, 50.0)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert k1.launches == before  # the count moves only for kernel launches
    with pytest.raises(ValueError):
        k1.flash_attention(q, k, v, None, 0.25, q_segs=torch.ones(1, 20))


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor selects the plain version: any other device goes
    to the kernel launch, which raises here (no card, no fallback)."""
    q, k, v = (torch.from_numpy(x).to("meta") for x in _inputs(1, 20, 20, 2, 1, 16))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        k1.flash_attention(q, k, v, None, 0.25, True)
