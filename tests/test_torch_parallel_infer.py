"""The port's inference under a (data, seq, model) mesh against vidi_tpu and
against one process, on the CPU, inputs from numpy seeds, fp32:

(i) K3's lse: `decode_attention_plain` and `decode_attention_schedule`
    with `return_lse` against `jax.nn.logsumexp` of the masked, scaled,
    softcapped logits (window, G in {1, 2, 4}, an empty row giving
    EMPTY_ROW_LSE) to 1e-5, their out the same bits as without lse and
    equal to the interpreted Pallas `decode_attention`; the packed launch
    passes the lse pointer only when asked. The int8-cache attention's lse
    against the same logsumexp, and its 4-shard merge (a shard with no
    visible key) against the whole cache.
(ii) 4 gloo ranks (tests/torch_parallel_infer_worker.py) at (data 2,
    seq 2) and (data 1, seq 2, model 2), on the inputs of vidi_tpu's
    test_generate_matches_under_seq_mesh: greedy tokens and lengths equal
    to JAX's `generate` on the same parameters, with the reference route
    and the kernel wrappers' route (their plain versions here), the step-0
    and step-1 logits within 1e-5 of JAX's; every rank of a (seq, model)
    group the same tokens; the prefill caches a rank holds S / seq keys
    and Hk / model heads, that slice of one process's caches to 1e-6;
    shared caches (`media_prefill`, and `media_prefill_chunked` in uneven
    chunks, on the slice; 4 query rows folded) and int8 caches against one
    process (tokens, and step logits to 1e-5),
    n-gram speculative decoding against one process's greedy tokens, beam
    search (2 beams) against one process's;
    `load_model(random_weights="tiny", mesh=)` leaf by leaf; the streamed
    encode's frames cut over seq.
(iii) the CLIs under torchrun (gloo): `run_benchmark --task tr
    --data-parallel 2 --seq-parallel 2` (4 ranks) and `pipeline --task qa
    --model-parallel 2` (2 ranks) against one process on make_video clips.
(iv) int8 / int4 weights loaded under (1, 1, 2) (2 ranks) and (1, 2, 2):
    each rank's quantized leaves cut as `storage_cuts` says (int8 towers
    kept K-major); weight-only int8, W8A8 with int8 caches and int4 greedy
    tokens equal to JAX's generate under its (1, 2, 2) mesh on the same
    quantized tree and to one process's, step-0 logits within 1e-4 of
    max |logit|; the W8A8 fault of each rank's own row absmax moves them
    past it; the streamed encode through int8 towers; `value_and_grads`
    under a "model" mesh of a shape.

Every spawn starts at once (module fixtures), the references are computed
while they run.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidi_tpu.core.config import DattnConfig as JConfig
from vidi_tpu.infer import generate as jgen
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.models import decoder as jdecoder
import vidi_tpu.ops.pallas.decode_attention as jda
from vidi_tpu_torch.core.mesh import Mesh
from vidi_tpu_torch.core.tree import leaves
from vidi_tpu_torch.infer import generate as tgen
from vidi_tpu_torch.infer.loader import load_model
from vidi_tpu_torch.models import dattn, decoder
from vidi_tpu_torch.ops.attention import quantized_cache_cross_attention
from vidi_tpu_torch.ops.cuda import decode_attention as k3
from vidi_tpu_torch.ops.cuda.flash_attention import EMPTY_ROW_LSE
from vidi_tpu_torch.parallel import ring_attention, sharding
from vidi_tpu_torch.infer import quantize as qz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import torch_parallel_infer_worker as W  # noqa: E402
from torch_init import stacked  # noqa: E402
from make_example import make_video  # noqa: E402

jda.INTERPRET = True
LSE_TOL = 1e-5
LOGIT_TOL = 1e-5
CACHE_TOL = 1e-6
LAYOUTS = ((2, 2, 1), (1, 2, 2))
IDS = ["data2_seq2", "seq2_model2"]
QUANT_LAYOUTS = ((1, 1, 2), (1, 2, 2))  # the int8 / int4 serving cases
QUANT_IDS = ["model2", "seq2_model2"]
QUANT_TOL = 1e-4  # of max |logit|


# ---------------------------------------------------------------------------
# (i) K3's lse and the int8 attention's
# ---------------------------------------------------------------------------

def _decode_inputs(b, s, hq, hk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    mask = rng.random((b, s)) > 0.3
    mask[-1] = False  # the last row sees no key
    return q, k, v, mask


def _jax_lse(q, k, mask, scale, softcap, window, q_pos):
    """logsumexp over the visible keys of the scaled, softcapped logits of
    the JAX reference (-inf for a row with none)."""
    b, hq, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(b, hk, hq // hk, d)
    logits = jnp.einsum("bhgd,bhsd->bhgs", qg, jnp.asarray(k)) * scale
    if softcap is not None:
        logits = jnp.tanh(logits / softcap) * softcap
    valid = jnp.asarray(mask)
    if window is not None:
        valid = valid & (jnp.asarray(q_pos)[:, None] - jnp.arange(s)[None] < window)
    logits = jnp.where(valid[:, None, None, :], logits, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(b, hq)


K3_CASES = [  # hq, hk, softcap, window
    (2, 2, 50.0, None),  # G = 1
    (4, 2, 50.0, 64),    # G = 2, sliding
    (8, 2, None, 64),    # G = 4, sliding, no cap
    (8, 2, 30.0, None),  # G = 4 with a cap
]


@pytest.mark.parametrize("hq,hk,softcap,window", K3_CASES)
def test_k3_lse_matches_logsumexp(hq, hk, softcap, window):
    s, d = 256, 128
    q, k, v, mask = _decode_inputs(3, s, hq, hk, d, seed=hq + s)
    q_pos = np.array([s - 1, s // 2, s - 1])
    args = [torch.from_numpy(x) for x in (q, k, v, mask)]
    kw = dict(softcap=softcap, window=window, q_pos=torch.from_numpy(q_pos))
    want = _jax_lse(q, k, mask, 0.125, softcap, window, q_pos)
    plain_out, plain_lse = k3.decode_attention_plain(*args, 0.125, return_lse=True, **kw)
    plan = k3.decode_plan(3, hk, s, d, 8, g=hq // hk)
    sched_out, sched_lse = k3.decode_attention_schedule(*args, 0.125, plan=plan,
                                                        return_lse=True, **kw)
    for lse in (plain_lse, sched_lse):
        np.testing.assert_allclose(lse[:-1].numpy(), want[:-1], rtol=LSE_TOL, atol=LSE_TOL)
        assert bool((lse[-1] == EMPTY_ROW_LSE).all())  # no visible key
        assert np.isneginf(want[-1]).all()
    assert torch.equal(plain_out, k3.decode_attention_plain(*args, 0.125, **kw))
    assert torch.equal(sched_out, k3.decode_attention_schedule(*args, 0.125, plan=plan, **kw))
    pallas = jda.decode_attention(*map(jnp.asarray, (q, k, v, mask)), 0.125, softcap=softcap,
                                  window=window, q_pos=jnp.asarray(q_pos, jnp.int32),
                                  block_k=128)
    np.testing.assert_allclose(plain_out[:-1].numpy(), np.asarray(pallas)[:-1],
                               atol=2e-5, rtol=2e-5)
    got, lse = k3.decode_attention(*args, 0.125, return_lse=True, **kw)  # CPU: plain
    assert torch.equal(got, plain_out) and torch.equal(lse, plain_lse)


def test_k3_launch_passes_lse_only_when_asked(monkeypatch):
    """The packed launch, the C call recorded: a null lse pointer without
    `return_lse` (every existing call), the returned lse's with it."""
    calls = []
    monkeypatch.setattr(k3, "same_device", lambda q, k, v: (q.device, q.dtype))
    monkeypatch.setattr(k3._lib, "sm_count", lambda dev: 132)
    monkeypatch.setattr(k3, "_call", lambda entry, dev, stream, values:
                        calls.append(values))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda idx: 1,
                        raising=False)
    monkeypatch.setattr(k3, "WORKSPACE", k3.Workspace())
    monkeypatch.setattr(k3, "_LAYOUTS", {})
    q = torch.zeros(1, 16, 256, dtype=torch.bfloat16)
    cache = torch.zeros(1, 8, 160, 256, dtype=torch.bfloat16)
    out = k3._launch(q, cache, cache, None, 0.0625, 50.0, None, None)
    out2, lse = k3._launch(q, cache, cache, None, 0.0625, 50.0, None, None, True)
    assert isinstance(out, torch.Tensor) and out2.shape == out.shape
    assert lse.shape == (1, 16) and lse.dtype == torch.float32
    assert calls[0][10] == 0 and calls[1][10] == lse.data_ptr()
    assert calls[0][:9] == calls[1][:9]  # the same operands and workspace
    assert len(k3.ARGS.pack(*calls[1])) == k3.ARGS.size


def test_int8_attention_lse_and_shard_merge():
    """The int8-cache attention's lse against logsumexp of its logits, and
    its partials over 4 shards of S (the first shard with no visible key)
    merged in shard order against the whole cache."""
    rng = np.random.default_rng(3)
    b, t, hq, hk, s, d = 2, 3, 4, 2, 64, 16
    q = torch.from_numpy(rng.standard_normal((b, t, hq, d)).astype(np.float32))
    kf = torch.from_numpy(rng.standard_normal((b, hk, s, d)).astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal((b, hk, s, d)).astype(np.float32))
    mask = torch.from_numpy(rng.random((b, s)) > 0.3)
    mask[:, :s // 4] = False
    kq, vq = qz.quantize_cache(kf), qz.quantize_cache(vf)
    kw = dict(kv_valid=mask, scale=0.25, softcap=50.0)
    out, lse = quantized_cache_cross_attention(q, kq, vq, return_lse=True, **kw)
    assert torch.equal(out, quantized_cache_cross_attention(q, kq, vq, **kw))
    logits = torch.einsum("bthgd,bhsd->bhgts", q.reshape(b, t, hk, hq // hk, d),
                          kq["qi8"].float()) * (kq["scale"][..., 0][:, :, None, None] * 0.25)
    logits = jnp.asarray((torch.tanh(logits / 50.0) * 50.0).numpy())
    want = jax.nn.logsumexp(jnp.where(jnp.asarray(mask.numpy())[:, None, None, None],
                                      logits, -jnp.inf), axis=-1)
    want = np.asarray(want).transpose(0, 3, 1, 2).reshape(b, t, hq)
    np.testing.assert_allclose(lse.numpy(), want, rtol=LSE_TOL, atol=LSE_TOL)
    parts = []
    for i in range(4):
        cut = slice(i * s // 4, (i + 1) * s // 4)
        shard = lambda c: {k: x[:, :, cut] for k, x in c.items()}  # noqa: E731
        parts.append(quantized_cache_cross_attention(
            q, shard(kq), shard(vq), kv_valid=mask[:, cut], scale=0.25, softcap=50.0,
            return_lse=True))
    assert np.isneginf(parts[0][1].numpy()).all()
    merged, merged_lse = ring_attention.merge(parts)
    np.testing.assert_allclose(merged.numpy(), out.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(merged_lse.numpy(), lse.numpy(), rtol=LSE_TOL, atol=LSE_TOL)


# ---------------------------------------------------------------------------
# (ii) the ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", **kw)
    return env


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("par_media")
    make_video(str(d / "vid_a.mp4"), seconds=4.0)
    make_video(str(d / "vid_b.mp4"), seconds=2.0)
    gt = d / "gt.json"
    gt.write_text(json.dumps([
        {"query_id": f"t{i}", "video_id": v, "query": q, "duration": dur}
        for i, (v, q, dur) in enumerate([
            ("vid_a", "the opening shot", 4.0), ("vid_a", "a red square", 4.0),
            ("vid_a", "a blue line", 4.0), ("vid_b", "a moving gradient", 2.0)])]))
    return d


def _torchrun(n: int, module: str, args, out):
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
         "--master_addr", "localhost", "--master_port", str(_free_port()), "-m", module,
         *args], cwd=ROOT, env=_env(), stdout=out, stderr=subprocess.STDOUT, text=True)


BENCH_ARGS = ["--task", "tr", "--random-weights", "tiny", "--device", "cpu",
              "--dtype", "float32", "--max-new-tokens", "6", "--mm-splits", "2",
              "--batch-queries", "3"]
PIPE_ARGS = ["--task", "qa", "--query", "what happens?", "--random-weights", "tiny",
             "--device", "cpu", "--dtype", "float32", "--max-new-tokens", "8"]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, clips):
    """Every multi-rank run, started together: the worker's layouts and
    the two CLIs."""
    procs = {}
    for layout in (*LAYOUTS, QUANT_LAYOUTS[0]):
        out = tmp_path_factory.mktemp("mesh" + "x".join(map(str, layout)))
        port, n = _free_port(), layout[0] * layout[1] * layout[2]
        procs[layout] = (out, [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_parallel_infer_worker.py"),
             str(out), *map(str, layout), *(["quant"] if layout not in LAYOUTS else [])],
            cwd=ROOT, env=_env(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                               MASTER_ADDR="localhost", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)])
    procs["bench"] = (clips / "mesh_pred.json", [_torchrun(
        4, "vidi_tpu_torch.infer.run_benchmark",
        [*BENCH_ARGS, "--gt", str(clips / "gt.json"), "--video-dir", str(clips),
         "--out", str(clips / "mesh_pred.json"), "--data-parallel", "2",
         "--seq-parallel", "2"], subprocess.PIPE)])
    procs["pipe"] = (None, [_torchrun(
        2, "vidi_tpu_torch.infer.pipeline",
        [*PIPE_ARGS, "--video-path", str(clips / "vid_a.mp4"), "--model-parallel", "2"],
        subprocess.PIPE)])
    yield procs
    for _, ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


def _finish(spawned, key):
    out, ps = spawned[key]
    logs = [p.communicate(timeout=600)[0] for p in ps]
    assert all(p.returncode == 0 for p in ps), "\n".join(x[-3000:] for x in logs)
    return out, logs


@pytest.fixture(scope="module")
def ranks(spawned, jax_refs, jax_quant, single):
    """{layout: [rank results]} (the references first, while the ranks
    run)."""
    res = {}
    for layout in (*LAYOUTS, QUANT_LAYOUTS[0]):
        out, ps = _finish(spawned, layout)
        res[layout] = [torch.load(out / f"rank{r}.pt") for r in range(len(ps))]
    return res


@pytest.fixture(scope="module")
def jax_refs(spawned):
    """JAX's greedy generate and step-0 / step-1 logits on the port's
    weights (vidi_tpu's tiny config, one device)."""
    cfg = JConfig.tiny()
    jp = stacked(dattn.init_params(W.tiny_cfg(), torch.float32, "cpu", 0))
    ids, mask, img, img_mask = map(jnp.asarray, W.generate_inputs(W.tiny_cfg()))
    res = jgen.generate(jp, cfg, ids, mask, img=img, img_mask=img_mask,
                        max_new_tokens=W.NEW_TOKENS, eos_id=W.EOS)
    h, caches, lens = jgen._prefill(jp, cfg, ids, mask, img, img_mask, None, None,
                                    max_new_tokens=2, mm_chunks=1, use_flash=False,
                                    quantize_caches=False, media_caches=None)
    l0 = jdecoder.lm_logits(jp["text"], h[jnp.arange(2), lens - 1], cfg.text)
    emb = jdecoder.embed_tokens(jp["text"], jnp.argmax(l0, -1)[:, None], cfg.text)
    l1, _ = jdattn.decode_step(jp, cfg, emb, lens, caches, img_mask=img_mask)
    return dict(tokens=np.asarray(res.tokens), lengths=np.asarray(res.lengths),
                logits0=np.asarray(l0), logits1=np.asarray(l1))


@pytest.fixture(scope="module")
def jax_quant(spawned):
    """JAX's greedy generate and step-0 logits under make_mesh(data=1,
    seq=2, model=2) on vidi_tpu's quantize_params of the port's weights,
    for each of the worker's QUANT_CASES (W8A8 through vidi_tpu's
    w8a8_min_tokens; the jit caches cleared between cases, since that
    threshold is read while tracing)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vidi_tpu.core.mesh import make_mesh as jmake_mesh
    from vidi_tpu.infer import quantize as jqz
    from vidi_tpu.parallel import sharding as jsh

    cfg = JConfig.tiny()
    jp = stacked(dattn.init_params(W.tiny_cfg(), torch.float32, "cpu", 0))
    ids, mask, img, img_mask = W.generate_inputs(W.tiny_cfg())
    mesh = jmake_mesh(jax.devices()[:4], data=1, seq=2, model=2)

    def logits0(p, ids, mask, img, img_mask, caches):
        h, _, lens = jgen._prefill(p, cfg, ids, mask, img, img_mask, None, None,
                                   max_new_tokens=2, mm_chunks=1, use_flash=False,
                                   quantize_caches=caches, media_caches=None)
        return jdecoder.lm_logits(p["text"], h[jnp.arange(ids.shape[0]), lens - 1], cfg.text)

    out = {}
    keep = jqz.w8a8_min_tokens
    try:
        for name, (flag, w8a8, caches) in W.QUANT_CASES.items():
            jqz.w8a8_min_tokens = w8a8
            jax.clear_caches()
            q = jqz.quantize_params(jax.tree.map(jnp.asarray, jp), modules=("text",),
                                    bits=4 if flag == "load_4bit" else 8)
            with jsh.use_mesh(mesh):
                def sh(a, *spec):
                    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))
                args = (sh(ids, "data", None), sh(mask, "data", None),
                        sh(img, "data", "seq", None), sh(img_mask, "data", "seq"))
                q = jsh.shard_params(q, mesh)

                def both(p, ids, mask, img, img_mask, caches=caches):
                    """generate and the step-0 logits, one compile"""
                    res = jgen.generate(p, cfg, ids, mask, img=img, img_mask=img_mask,
                                        max_new_tokens=W.NEW_TOKENS, eos_id=W.EOS,
                                        quantize_caches=caches)
                    return res.tokens, res.lengths, logits0(p, ids, mask, img, img_mask, caches)

                tokens, lengths, l0 = jax.jit(both)(q, *args)
            out[name] = dict(tokens=np.asarray(tokens), lengths=np.asarray(lengths),
                             logits0=np.asarray(l0))
    finally:
        jqz.w8a8_min_tokens = keep
        jax.clear_caches()
    return out


@pytest.fixture(scope="module")
def single(spawned):
    """One process's port runs of the worker's cases (no mesh)."""
    cfg = W.tiny_cfg()
    params = dattn.init_params(cfg, torch.float32, "cpu", 0)
    ids, mask, img, img_mask = map(W._t, W.generate_inputs(cfg))
    ids = ids.long()
    out = {}
    with torch.no_grad():
        out["greedy"] = tgen.generate(params, cfg, ids, mask, img, img_mask,
                                      max_new_tokens=W.NEW_TOKENS, eos_id=W.EOS)
        out["int8"] = tgen.generate(params, cfg, ids, mask, img, img_mask,
                                    max_new_tokens=W.NEW_TOKENS, eos_id=W.EOS,
                                    quantize_caches=True)
        out["int8_logits"] = W.step_logits(params, cfg, ids, mask, img, img_mask, False,
                                           quantize_caches=True)
        out["beam"] = tgen.beam_generate(params, cfg, ids, mask, img, img_mask,
                                         max_new_tokens=W.NEW_TOKENS, eos_id=W.EOS,
                                         num_beams=W.BEAMS)
        emb = decoder.embed_tokens(params["text"], ids, cfg.text)
        _, out["caches"] = dattn.forward(params, cfg, emb, mask,
                                         (torch.cumsum(mask.long(), 1) - 1).clamp(min=0),
                                         img=img, img_mask=img_mask, return_caches=True)
        qids, qmask = map(W._t, W.query_rows(cfg))
        media = dattn.media_prefill(params, cfg, img=img[:1], img_mask=img_mask[:1])
        out["shared"] = tgen.generate(params, cfg, qids.long(), qmask, img_mask=img_mask[:1],
                                      media_caches=media, max_new_tokens=W.NEW_TOKENS,
                                      eos_id=W.EOS)
        out["shared_logits"] = W.step_logits(params, cfg, qids.long(), qmask, None,
                                             img_mask[:1], False, media_caches=media)
    for flag in W.LOAD_FLAGS:
        out[f"load/{flag}"], _, _ = load_model(random_weights="tiny", dtype=torch.float32,
                                               device="cpu", **({flag: True} if flag else {}))
    ids, mask, img, img_mask = map(W._t, W.generate_inputs(cfg))
    for name, (flag, w8a8, caches) in W.QUANT_CASES.items():
        qp, _, _ = load_model(random_weights="tiny", dtype=torch.float32, device="cpu",
                              **{flag: True})
        out[f"quant/{name}"] = W.quant_generate(qp, cfg, (ids.long(), mask, img, img_mask),
                                                w8a8, caches)
    qp, _, _ = load_model(random_weights="tiny", dtype=torch.float32, device="cpu",
                          load_8bit_towers=True)
    out["quant/towers"] = W.stream_cases(qp, cfg)["stream"]
    from vidi_tpu_torch.infer import pipeline

    frames, chunks = W.stream_frames(cfg)
    with torch.no_grad():
        out["stream"] = pipeline._encode_frame_chunks(params, cfg, chunks, len(frames))
    return out


def _coords(layout, r):
    """(data, seq, model) coordinates of rank r (row-major)."""
    _, s, m = layout
    return r // (s * m), r // m % s, r % m


def _gathered_rows(layout, results, case, key, rows_total):
    """The case's `key` rows of every data group, checked to be the same
    on every rank of a group, concatenated in data order."""
    data = layout[0]
    groups = [[res[case][key] for r, res in enumerate(results)
               if _coords(layout, r)[0] == d] for d in range(data)]
    for g in groups:
        for x in g[1:]:
            assert torch.equal(x, g[0]), f"{case}/{key} differs inside a data group"
    got = torch.cat([g[0] for g in groups])
    assert got.shape[0] == rows_total
    return got


@pytest.mark.parametrize("flash", [0, 1], ids=["reference", "kernel_route"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_generate_matches_jax(ranks, jax_refs, layout, flash):
    res = ranks[layout]
    case = f"gen/{flash}"
    for key in ("tokens", "lengths"):
        got = _gathered_rows(layout, res, case, key, 2).numpy()
        np.testing.assert_array_equal(got, jax_refs[key])
    for key in ("logits0", "logits1"):
        got = _gathered_rows(layout, res, case, key, 2).numpy()
        np.testing.assert_allclose(got, jax_refs[key], rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_prefill_caches_hold_the_ranks_slice(ranks, single, layout):
    """S / seq keys and Hk / model heads a rank, equal to that slice of one
    process's caches (the port of vidi_tpu's
    test_prefill_caches_shard_over_seq_axis)."""
    data, seq, model = layout
    whole = single["caches"]
    for r, res in enumerate(ranks[layout]):
        d, s, m = _coords(layout, r)
        for key, got in res["caches"].items():
            want = getattr(whole, key)
            rows = slice(d * 2 // data, (d + 1) * 2 // data)
            heads = slice(m * want.shape[2] // model, (m + 1) * want.shape[2] // model)
            want = want[:, rows, heads]
            if key.startswith("img"):
                n = want.shape[3] // seq
                want = want[:, :, :, s * n:(s + 1) * n]
            assert got.shape == want.shape, (key, got.shape, want.shape)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=CACHE_TOL,
                                       atol=CACHE_TOL, err_msg=f"rank {r} {key}")
        assert res["caches"]["img_k"].shape[2:4] == (2 // model, 32 // seq)


def _logits_match(layout, results, case, rows, want):
    for key, w in zip(("logits0", "logits1"), want):
        got = _gathered_rows(layout, results, case, key, rows)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"{case} {key}")


@pytest.mark.parametrize("case,ref", [("int8", "int8"), ("spec", "greedy"), ("beam", "beam")])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_int8_speculative_and_beams_match_one_process(ranks, single, layout, case, ref):
    for key in ("tokens", "lengths"):
        got = _gathered_rows(layout, ranks[layout], case, key, 2)
        assert torch.equal(got, getattr(single[ref], key)), (case, key)
    if case == "int8":
        _logits_match(layout, ranks[layout], case, 2, single["int8_logits"])


@pytest.mark.parametrize("case", ["0", "1", "chunked"],
                         ids=["reference", "kernel_route", "chunked_prefill"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_shared_caches_match_one_process(ranks, single, layout, case):
    for key in ("tokens", "lengths"):
        got = _gathered_rows(layout, ranks[layout], f"shared/{case}", key, 4)
        assert torch.equal(got, getattr(single["shared"], key)), key
    _logits_match(layout, ranks[layout], f"shared/{case}", 4, single["shared_logits"])


def _check_load(results, single, layout, flag):
    """Each rank's leaves of `load_model(mesh=, **{flag: True})` are their
    `storage_cuts` slice of one process's load, stored K-major where it is
    (the int8 towers), and made whole again they are its leaves, bit for
    bit. -> the number of cut leaves."""
    params = single[f"load/{flag}"]
    want = {key: p for key, _, p in leaves(params)}
    mesh_shape = dict(zip(("data", "seq", "model"), layout))
    n_cut = 0
    for r, res in enumerate(results):
        got = res[f"load/{flag}"]
        mesh = Mesh(mesh_shape, rank=r)
        for path, shape, depth in sharding._stacked_paths(params):
            key = "/".join(map(str, path))
            cuts = sharding.storage_cuts(path, shape, depth, mesh)
            assert torch.equal(got["local"][key], sharding._local_cut(want[key], cuts, mesh)), \
                (r, key)
            assert got["kmajor"][key] == sharding._kmajor(want[key]), (r, key)
            n_cut += cuts != (None, None)
    for key, w in results[0][f"load/{flag}"]["whole"].items():
        assert torch.equal(w, want[key]), key
    return n_cut


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_load_model_cuts_each_leaf(ranks, single, layout):
    assert _check_load(ranks[layout], single, layout, "") >= 40


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_streamed_encode_holds_the_ranks_frames(ranks, single, layout):
    """The streamed encode (5 frames in chunks of 2) under seq 2: each rank
    the stream of its 3 frames, the last rank's third frame padding (zero,
    masked), equal to that slice of one process's stream."""
    img, mask = single["stream"]
    per_frame = img.shape[1] // 5
    for r, res in enumerate(ranks[layout]):
        s = _coords(layout, r)[1]
        lo, hi = 3 * s * per_frame, min(3 * (s + 1), 5) * per_frame
        got_img, got_mask = res["stream"]["img"], res["stream"]["mask"]
        assert got_img.shape[1] == 3 * per_frame
        np.testing.assert_allclose(got_img[:, :hi - lo].numpy(), img[:, lo:hi].numpy(),
                                   rtol=CACHE_TOL, atol=CACHE_TOL)
        assert torch.equal(got_mask[:, :hi - lo], mask[:, lo:hi])
        assert not got_mask[:, hi - lo:].any() and not got_img[:, hi - lo:].any()


def test_model_cut_needs_whole_kv_heads():
    with pytest.raises(ValueError, match="KV heads"):
        sharding.check_model_cut(Mesh({"model": 4}), 2)
    sharding.check_model_cut(Mesh({"model": 2}), 2)


# ---------------------------------------------------------------------------
# (iii) the CLIs
# ---------------------------------------------------------------------------

def test_run_benchmark_data_and_seq_ranks_match_one_process(spawned, clips, jax_refs):
    from vidi_tpu_torch.infer import run_benchmark as trb

    trb.main([*BENCH_ARGS, "--gt", str(clips / "gt.json"), "--video-dir", str(clips),
              "--out", str(clips / "one_pred.json")])
    out, (log,) = _finish(spawned, "bench")
    assert "retrying queries individually" not in log
    assert out.read_bytes() == (clips / "one_pred.json").read_bytes()
    assert log.count("wrote ") == 1  # rank 0 alone writes


def test_pipeline_model_ranks_match_one_process(spawned, clips, capsys, jax_refs):
    from vidi_tpu_torch.infer import pipeline

    pipeline.main([*PIPE_ARGS, "--video-path", str(clips / "vid_a.mp4")])
    want = capsys.readouterr().out.strip()
    _, (log,) = _finish(spawned, "pipe")
    assert want and log.count(want) == 1, (want, log[-2000:])  # the same, printed once


# ---------------------------------------------------------------------------
# (iv) int8 / int4 weights under a mesh, and the train step under "model"
# ---------------------------------------------------------------------------

def _quant_close(got, want, msg):
    limit = QUANT_TOL * float(np.abs(np.asarray(want)).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= limit, f"{msg}: max |err| {err:.3e} over {limit:.3e}"


@pytest.mark.parametrize("flag", ["load_8bit", "load_4bit", "load_8bit_towers"])
def test_quantized_load_cuts_each_leaf(ranks, single, flag):
    """`load_model(mesh=)` quantizes each layer as it is drawn, then cuts it:
    under (1, 2, 2) each rank holds the cuts of one process's int8 / int4
    leaves (their codes and scales cut as `storage_cuts` says), and they
    rebuild it whole."""
    assert _check_load(ranks[LAYOUTS[1]], single, LAYOUTS[1], flag) >= 40


@pytest.mark.parametrize("case", list(W.QUANT_CASES))
@pytest.mark.parametrize("layout", QUANT_LAYOUTS, ids=QUANT_IDS)
def test_quantized_generate_matches_jax_and_one_process(ranks, single, jax_quant, layout,
                                                        case):
    """Weight-only int8, W8A8 with int8 caches (the row-cut products
    quantized by the model group's row absmax) and int4 loaded under the
    mesh: greedy tokens equal to JAX's generate under its (1, 2, 2) mesh
    and to one process's, step-0 logits within QUANT_TOL of max |logit| of
    both (and step 1's of one process's)."""
    res = ranks[layout]
    want, jwant = single[f"quant/{case}"], jax_quant[case]
    for key in ("tokens", "lengths"):
        got = _gathered_rows(layout, res, f"quant/{case}", key, 2)
        assert torch.equal(got, want[key]), (case, key)
        np.testing.assert_array_equal(got.numpy(), jwant[key])
    l0 = _gathered_rows(layout, res, f"quant/{case}", "logits0", 2)
    _quant_close(l0, jwant["logits0"], f"{case} logits0 vs JAX")
    for key in ("logits0", "logits1"):
        _quant_close(_gathered_rows(layout, res, f"quant/{case}", key, 2), want[key],
                     f"{case} {key} vs one process")


@pytest.mark.parametrize("layout", QUANT_LAYOUTS, ids=QUANT_IDS)
def test_w8a8_local_absmax_fault_moves_the_logits(ranks, single, layout):
    """The planted fault: each rank quantizing its slice of a row-cut
    product by its own absmax moves the step-0 logits past QUANT_TOL."""
    got = _gathered_rows(layout, ranks[layout], "quant/w8a8_fault", "logits0", 2)
    with pytest.raises(AssertionError, match="max |err|"):
        _quant_close(got, single["quant/w8a8"]["logits0"], "fault")


@pytest.mark.parametrize("layout", QUANT_LAYOUTS, ids=QUANT_IDS)
def test_int8_towers_stream_matches_one_process(ranks, single, layout):
    """The streamed encode through int8 towers loaded under the mesh: each
    rank's frames' stream, that slice of one process's."""
    img, mask = single["quant/towers"]["img"], single["quant/towers"]["mask"]
    seq = layout[1]
    per_frame = img.shape[1] // 5
    for r, res in enumerate(ranks[layout]):
        s = _coords(layout, r)[1]
        n = -(-5 // seq)
        lo, hi = n * s * per_frame, min(n * (s + 1), 5) * per_frame
        got = res["quant/towers"]
        np.testing.assert_allclose(got["img"][:, :hi - lo].numpy(), img[:, lo:hi].numpy(),
                                   rtol=CACHE_TOL, atol=CACHE_TOL)
        assert torch.equal(got["mask"][:, :hi - lo], mask[:, lo:hi])


def test_kmajor_leaf_cut_and_gathered_keeps_its_layout(ranks):
    """A K-major int8 matrix (a tower weight's layout) cut over the world
    stays K-major on each rank, and gathered back it is the whole matrix,
    K-major, so that K5 reads it without a copy."""
    w = torch.arange(64 * 48, dtype=torch.int8).reshape(48, 64).t()
    for r, res in enumerate(ranks[LAYOUTS[1]]):
        got = res["kmajor_cut"]
        assert got["cut_kmajor"] and got["back_kmajor"]
        assert torch.equal(got["cut"], w[r * 16:(r + 1) * 16])
        assert torch.equal(got["back"], w)


def test_train_step_under_model_cut_runs():
    """value_and_grads under Mesh({"model": 2}) (a mesh of a shape, whole
    weights: no collective is reached) runs, and gives the loss and the
    gradients of no mesh, bit for bit; "model" must divide the KV heads."""
    from vidi_tpu_torch.train.optimizer import TrainHParams, make_optimizer
    from vidi_tpu_torch.train.train_step import make_batch_hw, value_and_grads
    from vidi_tpu_torch.train.data import synthetic_batch, to_device

    cfg = W.tiny_cfg()
    params = dattn.init_params(cfg, torch.float32, "cpu", 0)
    labels = make_optimizer(params, TrainHParams()).labels
    b = synthetic_batch(cfg, b=1, t=8, n_frames=1, n_windows=1, seed=0)
    kw = dict(labels=labels, cfg=cfg, hw=make_batch_hw(cfg, 1), frozen=("vision", "audio"))
    want = value_and_grads(params, to_device(b, "cpu"), None, **kw)
    with sharding.use_mesh(Mesh({"model": 2})):
        got = value_and_grads(params, to_device(b, "cpu"), None, **kw)
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
    with sharding.use_mesh(Mesh({"model": 4})):
        with pytest.raises(ValueError, match="KV heads"):
            value_and_grads(params, to_device(b, "cpu"), None, **kw)


# ---------------------------------------------------------------------------
# one process asking for ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", ["--seq-parallel", "--model-parallel"])
def test_pipeline_ranks_need_torchrun(monkeypatch, flag):
    from vidi_tpu_torch.infer import pipeline

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        pipeline.main(["--video-path", "v.mp4", "--query", "q", "--random-weights", "tiny",
                       "--device", "cpu", flag, "2"])
