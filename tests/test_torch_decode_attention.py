"""K3: the port's plain decode attention (the CUDA kernel's CPU twin) against
the Pallas `decode_attention` in interpret mode.

Tolerance: atol = rtol = 2e-5 in fp32 (same masked softmax over the cache;
the Pallas kernel sums block by block).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vidi_tpu.ops.pallas.decode_attention as da
from vidi_tpu_torch.ops.cuda import decode_attention as k3

da.INTERPRET = True

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(b, s, hq, hk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    mask = rng.random((b, s)) > 0.3
    return q, k, v, mask


@pytest.mark.parametrize("s,block,hq,hk,softcap,window", [
    (96, 96, 8, 4, 50.0, None),    # image-cache style: mask + cap
    (768, 256, 4, 2, None, None),  # several Pallas blocks
    (320, 64, 4, 2, 30.0, 64),     # sliding text layer: window through q_pos
    (256, 128, 8, 2, None, 64),    # Mistral-7B's G = 4: sliding, no cap
    (192, 64, 16, 2, None, None),  # G = 8
    (128, 64, 8, 2, 30.0, None),   # G = 4 with a cap
])
def test_matches_pallas(s, block, hq, hk, softcap, window):
    """S is a multiple of the Pallas block: interpret mode fills reads past
    the end of a ragged last block with NaN, and 0 * NaN reaches the
    Pallas output."""
    q, k, v, mask = _inputs(2, s, hq, hk, 32, seed=s)
    q_pos = np.array([s - 1, s // 2], np.int32)
    want = da.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), 0.125, softcap=softcap,
                               window=window, q_pos=jnp.asarray(q_pos),
                               block_k=block)
    got = k3.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(mask),
                                    0.125, softcap, window, torch.from_numpy(q_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_empty_row_is_zero_and_cpu_routes_to_plain():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(2, 40, 4, 2, 16))
    mask[1] = False
    before = k3.launches
    got = k3.decode_attention(q, k, v, mask, 0.25, 50.0)
    assert torch.equal(got, k3.decode_attention_plain(q, k, v, mask, 0.25, 50.0))
    assert not got[1].any()
    assert k3.launches == before
    with pytest.raises(ValueError):
        k3.decode_attention(q, k, v, mask, 0.25, window=8)  # window needs q_pos


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor selects the plain version: any other device goes
    to the kernel launch, which raises here (no card, no fallback)."""
    q, k, v, mask = (torch.from_numpy(x).to("meta") for x in _inputs(1, 40, 4, 2, 16))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        k3.decode_attention(q, k, v, mask, 0.25, 50.0)
