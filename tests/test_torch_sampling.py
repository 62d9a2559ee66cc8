"""Sampling in the port: `_warp_logits` against vidi_tpu's on seeded numpy
logits, then the port's own checks of sampled `generate` and sampled
`speculative_generate` at the tiny configuration in fp32 on the CPU.

JAX draws from its counter-based keys and the port from a torch.Generator:
the two streams differ, so no sample is compared with JAX. The port is
held instead to the law it must follow: the joint law of the first three
tokens, enumerated exactly over the warped support with teacher-forced
forwards of vidi_tpu and its `_warp_logits` (so the law does not come
from the code under test), against the counts of many rows of one prompt (a chi-square test
at p >= 1e-4), for sampled `generate` and for speculative sampling with
either draft; and to reproducibility by seed. The CLI's `--seed` seeds
the sampler, and `--random-weights-seed` the random weights.

Tolerances: the warped logits' -inf masks are identical and the kept
values within atol = rtol = 1e-6 (the same fp32 division).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import scipy.stats
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.infer import generate as jgen
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.models import decoder as jdecoder
from vidi_tpu_torch.infer import generate as tgen
from vidi_tpu_torch.infer.convert import params_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from make_example import make_video  # noqa: E402

CFG = DattnConfig.tiny()
V = CFG.text.vocab_size
WARP = (0.3, 8, 0.8)   # temperature, top_k, top_p of the law checks
ROWS = 4000            # rows of one prompt drawn in one batch
EOS = 2
N_POS = 3              # the law checks' output length
P_MIN = 1e-4
NOISE = 0.003          # the model draft: the target with this noise on every leaf


@pytest.fixture(scope="module")
def jparams():
    """The tiny model with its embedding scaled by 0.05: at init the tied
    embedding makes a token predict itself; scaled down, the layers shape
    the logits and the warped laws have several tokens."""
    jp = jdattn.init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    jp["text"]["embed"] = jp["text"]["embed"] * 0.05
    return jp


@pytest.fixture(scope="module")
def model(jparams):
    """The same weights in the port."""
    return params_from_jax(jax.device_get(jparams))


@pytest.fixture(scope="module")
def prompt():
    """One 10-token prompt with repeats, on which the n-gram draft proposes
    a likely token in about a sixth of the rows of the law checks."""
    return torch.tensor([[416, 163, 163, 163, 416, 147, 147, 147, 298, 416]])


def _warp_cases():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, V)) * 4).astype(np.float32)
    # a row with 40 logits tied at the softcap of 30, the nucleus boundary
    # inside the tied block
    logits[5, :] = rng.uniform(-30, 20, V)
    logits[5, rng.choice(V, 40, replace=False)] = 30.0
    return logits


@pytest.mark.parametrize("warp", [(0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.9),
                                  (0.7, 20, 0.8), (1.0, 0, 0.3)],
                         ids=["temperature", "top_k", "top_p", "all_three",
                              "top_p_in_tied_block"])
def test_warp_logits_matches(warp):
    logits = _warp_cases()
    want = np.asarray(jgen._warp_logits(jnp.asarray(logits), *warp))
    got = tgen._warp_logits(torch.from_numpy(logits), *warp).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    kept = ~np.isneginf(want)
    np.testing.assert_allclose(got[kept], want[kept], atol=1e-6, rtol=1e-6)
    if warp[2] == 0.3:  # the tied row keeps a strict prefix of its tied block
        assert 0 < kept[5].sum() < 40


def _rows(prompt, n):
    ids = prompt.expand(n, -1).contiguous()
    return ids, torch.ones_like(ids, dtype=torch.bool)


@jax.jit
def _warped_last(jp, ids):
    """vidi_tpu's warped next-token logits [N,V] after each row of ids
    [N,T]: its plain forward, lm_logits and `_warp_logits`."""
    mask = jnp.ones(ids.shape, bool)
    pos = jnp.broadcast_to(jnp.arange(ids.shape[1], dtype=jnp.int32), ids.shape)
    h, _ = jdattn.forward(jp, CFG, jdecoder.embed_tokens(jp["text"], ids, CFG.text), mask, pos)
    return jgen._warp_logits(jdecoder.lm_logits(jp["text"], h[:, -1], CFG.text), *WARP)


@pytest.fixture(scope="module")
def law(jparams, prompt) -> dict:
    """Exact law of the first N_POS tokens {(x0, x1, ...): p}, eos
    absorbing (the tokens after an eos are eos), enumerated over the warped
    support with one teacher-forced forward of vidi_tpu a prefix (fp64
    softmax of its fp32 warped logits): independent of the port's code."""
    out = {(): 1.0}
    for _ in range(N_POS):
        live = [pfx for pfx in out if EOS not in pfx]
        nxt = {pfx + (EOS,): p for pfx, p in out.items() if EOS in pfx}
        ids = np.concatenate([np.repeat(prompt.numpy(), len(live), axis=0),
                              np.array(live, dtype=np.int64).reshape(len(live), -1)], axis=1)
        probs = scipy.special.softmax(
            np.asarray(_warped_last(jparams, jnp.asarray(ids, jnp.int32)), np.float64), axis=-1)
        for pfx, p1 in zip(live, probs):
            for x in np.nonzero(p1 > 0)[0].tolist():
                nxt[pfx + (x,)] = out[pfx] * float(p1[x])
        out = nxt
    return out


def _chi2_p(tokens, law: dict) -> float:
    """p-value of the counts of the rows of tokens [N, N_POS] under `law`:
    outputs expected at least 5 times are bins of their own, the rest (and
    outputs outside the law) one more bin; where the rest has no mass, an
    output outside the law gives p = 0."""
    counts = {}
    for pair in map(tuple, tokens[:, :N_POS].tolist()):
        counts[pair] = counts.get(pair, 0) + 1
    n = tokens.shape[0]
    big = [pair for pair, p in law.items() if p * n >= 5]
    obs = [counts.get(pair, 0) for pair in big]
    exp = [law[pair] * n for pair in big]
    rest_obs, rest_exp = n - sum(obs), n - sum(exp)
    if rest_exp > 1e-6:
        obs.append(rest_obs)
        exp.append(rest_exp)
    elif rest_obs:  # every output of the law has its own bin: one outside it fails
        return 0.0
    assert len(big) >= 8, f"the law has too few likely outputs to test: {len(big)}"
    return scipy.stats.chisquare(obs, exp).pvalue


def _sample(params, prompt, seed, n=ROWS, **kw):
    gen = torch.Generator().manual_seed(seed)
    return tgen.generate(params, CFG, *_rows(prompt, n), max_new_tokens=kw.pop("max_new", N_POS),
                         eos_id=EOS, temperature=WARP[0], top_k=WARP[1], top_p=WARP[2],
                         generator=gen, **kw)


def test_sampled_generate_follows_the_warped_law(model, prompt, law):
    res = _sample(model, prompt, seed=11)
    assert _chi2_p(res.tokens, law) >= P_MIN


def test_sampled_generate_power(model, prompt, law):
    """The chi-square test rejects a sampler that skips top-p (the law
    without the nucleus cut): the law check has the power to see a wrong
    warp."""
    gen = torch.Generator().manual_seed(11)
    res = tgen.generate(model, CFG, *_rows(prompt, ROWS), max_new_tokens=N_POS, eos_id=EOS,
                        temperature=WARP[0], top_k=WARP[1], top_p=1.0, generator=gen)
    assert _chi2_p(res.tokens, law) < P_MIN


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_speculative_sampling_follows_the_warped_law(model, prompt, law, draft):
    """Speculative sampling (spec_k 1 and 2) leaves the law of the output
    that of sampled generate. The model draft is the target with noise on
    every leaf: close enough that its proposals are often accepted, so the
    accept and the residual branches both carry mass."""
    if draft == "model":
        g = torch.Generator().manual_seed(77)
        dp = _noised(model, g, NOISE)
        args = (dp, CFG)
    else:
        args = (None, None)
    for k, seed in ((1, 21), (2, 22)):
        gen = torch.Generator().manual_seed(seed)
        res = tgen.speculative_generate(
            model, CFG, *args, *_rows(prompt, ROWS), spec_k=k, max_new_tokens=N_POS,
            eos_id=EOS, temperature=WARP[0], top_k=WARP[1], top_p=WARP[2], generator=gen)
        assert _chi2_p(res.tokens, law) >= P_MIN, (draft, k)
        # both branches carry mass: proposals accepted, and rejected
        n_acc, n_draft = int(res.n_accepted.sum()), int(res.n_drafted.sum())
        assert ROWS // 100 < n_acc < n_draft - ROWS // 100, (draft, k, n_acc, n_draft)


def _noised(params, gen, scale):
    """params with scale * N(0, 1) added to every floating leaf."""
    if isinstance(params, dict):
        return {k: _noised(v, gen, scale) for k, v in params.items()}
    if isinstance(params, list):
        return [_noised(v, gen, scale) for v in params]
    if params.is_floating_point():
        return params + scale * torch.randn(params.shape, generator=gen)
    return params


def test_same_seed_same_tokens(model, prompt):
    kw = dict(n=4, max_new=8)
    a, b = _sample(model, prompt, 5, **kw), _sample(model, prompt, 5, **kw)
    c = _sample(model, prompt, 6, **kw)
    assert torch.equal(a.tokens, b.tokens)
    assert not torch.equal(a.tokens, c.tokens)


def test_top_k_1_is_greedy(model, prompt):
    ids, mask = _rows(prompt, 2)
    greedy = tgen.generate(model, CFG, ids, mask, max_new_tokens=8, eos_id=EOS)
    sampled = tgen.generate(model, CFG, ids, mask, max_new_tokens=8, eos_id=EOS,
                            temperature=0.7, top_k=1, generator=torch.Generator().manual_seed(1))
    assert torch.equal(sampled.tokens, greedy.tokens)


@pytest.mark.parametrize("fn", ["generate", "speculative_generate"])
def test_sampling_takes_a_generator(model, prompt, fn):
    """Sampling has no hidden default seed: temperature > 0 without a
    generator raises."""
    ids, mask = _rows(prompt, 1)
    lead = (model, CFG) if fn == "generate" else (model, CFG, None, None)
    with pytest.raises(ValueError, match="torch.Generator"):
        getattr(tgen, fn)(*lead, ids, mask, max_new_tokens=4, eos_id=EOS, temperature=0.7)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_sampled_speculative_is_reproducible(model, prompt, k, draft):
    """One seed gives one run: a round draws the draft samples, then the
    uniforms, then the residuals from one generator."""
    dp = (_noised(model, torch.Generator().manual_seed(7), NOISE), CFG) \
        if draft == "model" else (None, None)
    runs = [tgen.speculative_generate(
        model, CFG, *dp, *_rows(prompt, 3), spec_k=k, max_new_tokens=8, eos_id=EOS,
        temperature=0.7, top_k=50, top_p=0.9, generator=torch.Generator().manual_seed(s))
        for s in (4, 4, 5)]
    for f in ("tokens", "lengths", "n_drafted", "n_accepted"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
    assert runs[0].n_target_steps == runs[1].n_target_steps
    assert not torch.equal(runs[0].tokens, runs[2].tokens)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("media") / "clip.mp4")
    make_video(path, seconds=4.0)
    return path


def test_cli_seed_is_the_sampling_seed(clip, monkeypatch, capsys):
    """`--seed` seeds the sampler, `--random-weights-seed` the random
    weights (default 0); one `--seed` gives one answer."""
    from vidi_tpu_torch.infer import loader
    from vidi_tpu_torch.infer import pipeline as tpipe

    seen = {"weights": [], "sampler": [], "tokens": []}
    real_load, real_generate = loader.load_model, tpipe.generate

    def load_model(*a, **kw):
        seen["weights"].append(kw["seed"])
        return real_load(*a, **kw)

    def generate(*a, **kw):
        assert kw["temperature"] == 0.7 and kw["top_k"] == 50 and kw["top_p"] == 0.9
        seen["sampler"].append(kw["generator"].initial_seed())
        res = real_generate(*a, **kw)
        seen["tokens"].append(res.tokens)
        return res

    monkeypatch.setattr(loader, "load_model", load_model)
    monkeypatch.setattr(tpipe, "generate", generate)
    base = ["--video-path", clip, "--query", "a moving gradient", "--random-weights", "tiny",
            "--device", "cpu", "--dtype", "float32", "--max-new-tokens", "8",
            "--temperature", "0.7", "--top-k", "50", "--top-p", "0.9"]
    for extra in (["--seed", "3"], ["--seed", "3"], ["--seed", "3", "--random-weights-seed", "1"]):
        tpipe.main(base + extra)
        assert capsys.readouterr().out.strip()
    assert seen["weights"] == [0, 0, 1]
    assert seen["sampler"] == [3, 3, 3]
    assert torch.equal(seen["tokens"][0], seen["tokens"][1])
