"""The bf16 forward's dependence on `mm_chunks`, the port against vidi_tpu.

`mm_chunks` splits the media streams' per-token diagonal update along the
token axis: exact arithmetic gives the same result for every k. The port
takes ceil(S / k)-row chunks with a ragged tail; the reference pads S to a
multiple of k and maps equal chunks. On the same weights (params_from_jax)
and inputs, each package runs its forward in bf16 with mm_chunks = 1 and
k in {2, 3, 5} (the 37 image and 23 audio tokens leave a ragged tail at
every k), and in fp32 with mm_chunks = 1. Read over the hidden states and
all six caches, relative to max|fp32 output|:

- spread(k) = max|bf16(k) - bf16(1)|: the port's must not exceed the
  reference's by more than one bf16 ulp (2^-8);
- error(k) = max|bf16(k) - fp32|: chunking must not move the port's error
  against fp32 by more than one bf16 ulp from its error at k = 1.

A planted fault, the port's chunked update with the ragged tail left out,
must fail the first reading. `JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_mm_chunks.py` prints the readings.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.models import dattn as jdattn
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.models import dattn as tdattn

CFG = DattnConfig.tiny()
S_IMG, S_AUD, T = 37, 23, 12
KS = (2, 3, 5)
ULP = 2.0 ** -8  # one bf16 ulp, relative


def _is_pos(path) -> bool:
    """The position MLPs, which stay fp32 in a bf16 model."""
    return any(str(getattr(p, "key", p)).startswith("pos_") for p in path)


def _inputs():
    rng = np.random.default_rng(0)
    d = CFG.text.hidden_size
    return {"embeds": rng.standard_normal((1, T, d)).astype(np.float32),
            "img": (0.5 * rng.standard_normal((1, S_IMG, d))).astype(np.float32),
            "aud": (0.5 * rng.standard_normal((1, S_AUD, d))).astype(np.float32)}


def _flat(h, caches) -> np.ndarray:
    parts = [h] + [getattr(caches, n) for n in ("text_k", "text_v", "img_k", "img_v",
                                                "aud_k", "aud_v")]
    return np.concatenate([np.asarray(p, np.float32).ravel() for p in parts])


def _jax_run(jp, x, dtype, k):
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    mask = jnp.ones((1, T), bool)
    pos = jnp.arange(T, dtype=jnp.int32)[None]
    h, caches = jdattn.forward(
        jp, CFG, cast(x["embeds"]), mask, pos, img=cast(x["img"]),
        img_mask=jnp.ones((1, S_IMG), bool), aud=cast(x["aud"]),
        aud_mask=jnp.ones((1, S_AUD), bool), mm_chunks=k, return_caches=True)
    return _flat(h.astype(jnp.float32),
                 jax.tree.map(lambda a: a.astype(jnp.float32), caches))


def _torch_run(tp, x, dtype, k):
    cast = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    h, caches = tdattn.forward(
        tp, CFG, cast(x["embeds"]), torch.ones(1, T, dtype=torch.bool),
        torch.arange(T)[None], img=cast(x["img"]),
        img_mask=torch.ones(1, S_IMG, dtype=torch.bool), aud=cast(x["aud"]),
        aud_mask=torch.ones(1, S_AUD, dtype=torch.bool), mm_chunks=k,
        return_caches=True)
    return _flat(h.float(), caches._replace(**{
        n: getattr(caches, n).float() for n in caches._fields}))


def _bf16_torch(tree, pos=False):
    if isinstance(tree, dict):
        return {k: _bf16_torch(v, pos or k.startswith("pos_")) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16_torch(v, pos) for v in tree]
    return tree if pos else tree.to(torch.bfloat16)


def _readings():
    """{package: {"fp32": out, 1: bf16 out, k: bf16 out}}."""
    jp32 = jdattn.init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    jp16 = jax.tree_util.tree_map_with_path(
        lambda p, a: a if _is_pos(p) else a.astype(jnp.bfloat16), jp32)
    tp32 = params_from_jax(jax.device_get(jp32))
    tp16 = _bf16_torch(tp32)
    x = _inputs()
    out = {"ref": {"fp32": _jax_run(jp32, x, jnp.float32, 1)},
           "port": {"fp32": _torch_run(tp32, x, torch.float32, 1)}}
    for k in (1, *KS):
        out["ref"][k] = _jax_run(jp16, x, jnp.bfloat16, k)
        out["port"][k] = _torch_run(tp16, x, torch.bfloat16, k)
    out["tp16"], out["x"] = tp16, x
    return out


@pytest.fixture(scope="module")
def readings():
    return _readings()


def _rel(a, b, ref) -> float:
    return float(np.abs(a - b).max() / np.abs(ref).max())


@pytest.mark.parametrize("k", KS)
def test_port_chunk_spread_within_the_reference(readings, k):
    port, ref = readings["port"], readings["ref"]
    spread_port = _rel(port[k], port[1], port["fp32"])
    spread_ref = _rel(ref[k], ref[1], ref["fp32"])
    assert spread_port <= spread_ref + ULP, (spread_port, spread_ref)


@pytest.mark.parametrize("k", KS)
def test_port_chunking_adds_no_error_against_fp32(readings, k):
    port = readings["port"]
    err_k = _rel(port[k], port["fp32"], port["fp32"])
    err_1 = _rel(port[1], port["fp32"], port["fp32"])
    assert err_k <= err_1 + ULP, (err_k, err_1)


def test_planted_fault_ragged_tail_dropped_is_seen(readings, monkeypatch):
    """The chunked update with its ragged tail left as the stream's input
    must land outside the spread limit."""
    real = tdattn._diag_update

    def tail_dropped(lp, stream, v, o_w, tcfg):
        out = real(lp, stream, v, o_w, tcfg)
        return stream if stream.shape[1] < -(-S_AUD // 3) else out

    monkeypatch.setattr(tdattn, "_diag_update", tail_dropped)
    got = _torch_run(readings["tp16"], readings["x"], torch.bfloat16, 3)
    port, ref = readings["port"], readings["ref"]
    assert _rel(got, port[1], port["fp32"]) > _rel(ref[3], ref[1], ref["fp32"]) + ULP


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_mm_chunks.py
    r = _readings()
    for pkg in ("port", "ref"):
        p = r[pkg]
        print(pkg, f"error(1) {_rel(p[1], p['fp32'], p['fp32']):.3e}", ", ".join(
            f"k={k}: spread {_rel(p[k], p[1], p['fp32']):.3e} "
            f"error {_rel(p[k], p['fp32'], p['fp32']):.3e}" for k in KS))
