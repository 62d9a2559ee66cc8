"""SigLIP and Whisper towers of the port against vidi_tpu at the tiny
configuration, same weights (params_from_jax), fp32 on the CPU.

Tolerance: atol = rtol = 1e-4. A few fp32 layers (matmuls, layer norms,
softmax, and Whisper's convolutions) compound the ops' few-ulp differences.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.models import siglip as jsiglip
from vidi_tpu.models import whisper as jwhisper
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.models import siglip as tsiglip
from vidi_tpu_torch.models import whisper as twhisper

TOL = dict(atol=1e-4, rtol=1e-4)
CFG = DattnConfig.tiny()


@pytest.mark.parametrize("use_flash", [False, True])
def test_siglip_forward_features(use_flash):
    jp = jsiglip.init_params(jax.random.PRNGKey(1), CFG.vision, jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    x = np.random.default_rng(0).standard_normal((3, 42, 42, 3)).astype(np.float32)
    want = jsiglip.forward_features(jp, jnp.asarray(x), CFG.vision)
    got = tsiglip.forward_features(tp, torch.from_numpy(x), CFG.vision,
                                   use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_patchify_matches():
    x = np.random.default_rng(1).standard_normal((2, 30, 44, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsiglip.patchify(torch.from_numpy(x), 14).numpy(),
                                  np.asarray(jsiglip.patchify(jnp.asarray(x), 14)))


@pytest.mark.parametrize("use_flash", [False, True])
def test_whisper_forward(use_flash):
    jp = jwhisper.init_params(jax.random.PRNGKey(2), CFG.audio, jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    mel = np.random.default_rng(0).standard_normal((2, 128, 3000)).astype(np.float32)
    want = jwhisper.forward(jp, jnp.asarray(mel), CFG.audio)
    got = twhisper.forward(tp, torch.from_numpy(mel), CFG.audio, use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_whisper_conv_and_positions():
    w = np.random.default_rng(3).standard_normal((8, 5, 3)).astype(np.float32)
    b = np.random.default_rng(4).standard_normal((8,)).astype(np.float32)
    x = np.random.default_rng(5).standard_normal((2, 11, 5)).astype(np.float32)
    for stride in (1, 2):
        np.testing.assert_allclose(
            twhisper._conv1d(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), stride).numpy(),
            np.asarray(jwhisper._conv1d(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b), stride)), **TOL)
    np.testing.assert_array_equal(twhisper.sinusoidal_positions(50, 16),
                                  jwhisper.sinusoidal_positions(50, 16))
