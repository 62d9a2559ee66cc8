"""K2: the port's plain tower attention (the CUDA kernel's CPU twin) against
the Pallas `tower_attention` in interpret mode, through each of its three
layouts.

Tolerance: atol = rtol = 2e-5 in fp32 (same softmax attention; the Pallas
kernel divides after P @ V, the plain version before it).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.ops.pallas import tower_attention as ta
from vidi_tpu_torch.ops import basic as tbasic
from vidi_tpu_torch.ops.cuda import tower_attention as k2

ta.INTERPRET = True

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,t,h,d,layout", [
    (2, 37, 2, 72, "fullwidth"),  # SigLIP-so400m head dim
    (2, 45, 2, 64, "packed"),     # Whisper head dim, 2 heads per 128 lanes
    (2, 37, 2, 16, "generic"),    # the tiny config's towers
])
def test_matches_pallas(b, t, h, d, layout):
    assert {"fullwidth": ta._fullwidth_ok(t, h, d),
            "packed": ta._packed_ok(t, d, h * d),
            "generic": not ta._packed_ok(t, d, h * d)
            and not ta._fullwidth_ok(t, h, d)}[layout]
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    want = ta.tower_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d**-0.5)
    got = k2.tower_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), d**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mha_use_flash_reaches_the_wrapper_on_cpu():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 29, 144)).astype(np.float32))
               for _ in range(3))
    before = k2.launches
    got = tbasic.mha(q, k, v, 2, use_flash=True)
    want = k2.tower_attention_plain(q.reshape(2, 29, 2, 72), k.reshape(2, 29, 2, 72),
                                    v.reshape(2, 29, 2, 72), 72**-0.5)
    assert torch.equal(got, want.reshape(2, 29, 144))
    assert k2.launches == before


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor selects the plain version: any other device goes
    to the kernel launch, which raises here (no card, no fallback)."""
    q, k, v = (torch.zeros((1, 29, 2, 72), device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        k2.tower_attention(q, k, v, 72**-0.5)
