"""The port's parallelism (core/mesh, parallel/) against vidi_tpu's on the
CPU, inputs from numpy seeds, fp32:

(i) spec rules: `_param_spec_for_path` / `fsdp_param_spec` / `_fit_spec`
    pick JAX's dims and axes leaf by leaf, on the tiny tree and the 9B's
    shapes (`jax.eval_shape` of `init_params`), on mesh shapes (2, 4, 1),
    (8, 1, 1) and (1, 4, 2); the port's per-layer storage follows its
    stacked JAX leaf. No processes.
(ii) attention under 4 gloo ranks (tests/torch_parallel_worker.py; data 2
    x seq 2, and seq 4): ring, Ulysses and the "gspmd" plan, on the kernel
    wrapper's route (`use_flash`, its plain version here) and the reference
    route, outputs and gradients of sum(out^2) against JAX's
    `ring_cross_attention` / `ulysses_cross_attention_sharded` on a JAX CPU
    mesh of the same shape (`JAX_REFS`) and against the port's
    single-process `cross_attention`, at rtol = atol = 2e-5
    (tests/test_parallel.py's);
    a shard with no key, 2 KV heads over seq 4 (`expand_kv`), the
    `seq_to_heads` / `heads_to_seq` round trip. Each rank's gradient is
    seeded with 1 / seq, as the train step seeds it: dq is the sum of the
    ranks' shares, dk / dv the concatenation of their slices.
(iii) `dattn.forward` in each mode under (2, 2), on each rank's rows and
    image-stream slice, against the port's mesh-less forward and JAX's ring
    forward under its mesh (2e-4, tests/test_parallel.py's).
(iv) two FSDP train steps under (2, 2) in each mode (uneven frame cut, a
    seq rank holding only audio padding, every module training): the
    losses within 1e-5 relative, the first step's gradients within 1e-5 of
    each leaf's largest magnitude (floor 1e-7: a key bias's exact gradient
    is zero, see test_torch_train_step) and the parameters within 1e-5 of
    the port's single-process steps on the same global batch; each rank
    holds a quarter of every leaf of >= 2**14 elements (but pos_embed) and
    of its AdamW moments. The same for an image-conv step (anyres grids
    (2, 2) and (1, 3): 5 tiles fanned out over seq 2, the tower trained).
(v) the train CLI under `torchrun --nproc_per_node 4` (gloo, seq 2, ring)
    writes a checkpoint that a restart resumes onto the mesh, its losses
    those of one process on the same global batch; --model_parallel_size 2
    raises (training under tensor parallelism is ROADMAP Q1.16c).

One spawn of 4 ranks a mesh layout serves every case (module fixtures);
the ranks import no jax and run one thread each.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.core.config import DattnConfig as JConfig
from vidi_tpu.core.mesh import make_mesh as jmake_mesh
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.models import decoder as jdecoder
from vidi_tpu.parallel import sharding as jsh
from vidi_tpu.parallel.ring_attention import ring_cross_attention as jring
from vidi_tpu.parallel.ulysses import ulysses_cross_attention_sharded as julysses
from vidi_tpu_torch.core.mesh import Mesh
from vidi_tpu_torch.models import dattn, decoder
from vidi_tpu_torch.ops.attention import cross_attention
from vidi_tpu_torch.parallel import sharding
from vidi_tpu_torch.train import optimizer as topt
from vidi_tpu_torch.train.train_step import train_step, value_and_grads

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as W  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = RTOL = 2e-5
FWD_TOL = 2e-4
LOSS_TOL, LEAF_TOL, LEAF_FLOOR, PARAM_TOL = 1e-5, 1e-5, 1e-7, 1e-5
LAYOUTS = ((2, 2), (1, 4))


# ---------------------------------------------------------------------------
# (i) spec rules
# ---------------------------------------------------------------------------

SPEC_MESHES = ((2, 4, 1), (8, 1, 1), (1, 4, 2))


def _both_meshes(shape):
    jm = jmake_mesh(jax.devices()[:8], data=shape[0], seq=shape[1], model=shape[2])
    return jm, Mesh(dict(zip(("data", "seq", "model"), shape)))


def _jax_tree(cfg):
    return jax.eval_shape(lambda k: jdattn.init_params(k, cfg, jnp.bfloat16),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh_shape", SPEC_MESHES)
@pytest.mark.parametrize("model", ["tiny", "vidi15_9b"])
def test_param_specs_match_jax_leaf_by_leaf(model, mesh_shape):
    jm, tm = _both_meshes(mesh_shape)
    tree = _jax_tree(getattr(JConfig, model)())
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        names = tuple(k.key for k in path)
        want = tuple(jsh._param_spec_for_path(path, leaf, jm))
        assert sharding._param_spec_for_path(names, leaf, tm) == want, names
        assert sharding.fsdp_param_spec(leaf.shape, tm) == tuple(
            jsh.fsdp_param_spec(leaf.shape, jm)), names
        n += 1
    assert n > 50


@pytest.mark.parametrize("mesh_shape", SPEC_MESHES)
def test_fit_spec_matches_jax(mesh_shape):
    jm, tm = _both_meshes(mesh_shape)
    for dim in (1, 2, 3, 4, 6, 8, 12, 16, 3584, 4304):
        for s in ("data", "seq", "model", ("data", "seq"), ("data", "seq", "model"),
                  ("seq", "model")):
            assert sharding._fit_spec(dim, s, tm) == jsh._fit_spec(dim, s, jm), (dim, s)


@pytest.mark.parametrize("mesh_shape", [(2, 4, 1), (8, 1, 1)])
def test_port_storage_follows_the_stacked_leaf(mesh_shape):
    """The port's per-layer leaves take their stacked JAX leaf's spec with L
    dropped; every other leaf its own; `shard_params` cuts them so."""
    jm, tm = _both_meshes(mesh_shape)
    params = dattn.init_params(W.tiny_cfg(), torch.float32, "cpu", 0)
    jtree = _jax_tree(JConfig.tiny())
    jspecs = {tuple(k.key for k in p): tuple(jsh._param_spec_for_path(p, leaf, jm))
              for p, leaf in jax.tree_util.tree_leaves_with_path(jtree)}
    sharded = 0
    for path, shape, depth in sharding._stacked_paths(params):
        got = sharding.storage_spec(path, shape, depth, tm)
        spec = jspecs[tuple(k for k in path if isinstance(k, str))]
        if depth is not None:
            assert not spec or spec[0] is None
            spec = spec[1:]
        live = [(d, tuple(a for a in (s if isinstance(s, tuple) else (s,))
                          if tm.shape[a] > 1)) for d, s in enumerate(spec) if s is not None]
        live = [(d, a) for d, a in live if a]
        assert got == (live[0] if live else None), path
        sharded += got is not None
    assert sharded >= 6



# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The 4 ranks of both layouts, started together: {(data, seq): (out
    dir, processes)}."""
    procs = {}
    for data, seq in LAYOUTS:
        out = tmp_path_factory.mktemp(f"mesh{data}x{seq}")
        port = _free_port()
        env_base = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        procs[(data, seq)] = (out, [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_parallel_worker.py"),
             str(out), str(data), str(seq)], cwd=ROOT,
            env=dict(env_base, RANK=str(r), WORLD_SIZE="4", LOCAL_RANK=str(r),
                     MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)])
    yield procs
    for _, ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(spawned, jax_attention, forward_refs, single_steps, single_image_steps):
    """{(data, seq): [rank 0..3 results]}, read once the ranks end (the
    references are computed while they run)."""
    res = {}
    for key, (out, ps) in spawned.items():
        logs = [p.communicate(timeout=600)[0] for p in ps]
        assert all(p.returncode == 0 for p in ps), "\n".join(x[-3000:] for x in logs)
        res[key] = [torch.load(out / f"rank{r}.pt") for r in range(4)]
    return res


def _rank(seq: int, d: int, s: int) -> int:
    return d * seq + s


def _assemble(results, data: int, seq: int, key: str) -> dict:
    """The ranks' pieces of one attention case as whole arrays: out (checked
    to be the same on every rank of a seq group), dq summed over the seq
    group, dk / dv concatenated along S."""
    out, dq, dk, dv = [], [], [], []
    for d in range(data):
        rs = [results[_rank(seq, d, s)][key] for s in range(seq)]
        for r in rs[1:]:
            assert torch.equal(r["out"], rs[0]["out"]), f"{key}: out differs over seq"
        out.append(rs[0]["out"])
        dq.append(sum(r["dq"] for r in rs))
        dk.append(torch.cat([r["dk"] for r in rs], dim=1))
        dv.append(torch.cat([r["dv"] for r in rs], dim=1))
    return {k: torch.cat(v).numpy() for k, v in
            (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))}


# ---------------------------------------------------------------------------
# (ii) attention
# ---------------------------------------------------------------------------

# the JAX functions each case is held against (a JAX gradient compile takes
# 1-3 s): the shard with no key through the ring, 2 KV heads over seq 4
# through Ulysses' expand_kv
JAX_REFS = {"plain": ("ring", "ulysses"), "masked_shard": ("ring",), "gqa": ("ulysses",)}


@pytest.fixture(scope="module")
def jax_attention(spawned):
    """JAX's ring / Ulysses on its CPU mesh of each layout: (out, dq, dk, dv)
    of sum(out^2) per (layout, case, fn)."""
    res = {}
    for data, seq in LAYOUTS:
        mesh = jmake_mesh(jax.devices()[:data * seq], data=data, seq=seq, model=1)
        for case, names in JAX_REFS.items():
            hk, masked, cap = W.ATTN_CASES[case]
            q, k, v, mask = map(jnp.asarray, W.attention_inputs(hk, masked))
            for name in names:
                fn = {"ring": jring, "ulysses": julysses}[name]
                def loss(q, k, v, fn=fn, cap=cap):
                    o = fn(q, k, v, mask, mesh, sm_scale=W.SCALE, softcap=cap)
                    return jnp.sum(o ** 2), o
                (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                       has_aux=True))(q, k, v)
                res[(data, seq), case, name] = dict(
                    out=np.asarray(o), dq=np.asarray(g[0]), dk=np.asarray(g[1]),
                    dv=np.asarray(g[2]))
    return res


def _single(case):
    hk, masked, cap = W.ATTN_CASES[case]
    q, k, v, mask = (torch.from_numpy(x) for x in W.attention_inputs(hk, masked))
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    o = cross_attention(q, k, v, kv_valid=mask, scale=W.SCALE, softcap=cap)
    g = torch.autograd.grad(o.square().sum(), (q, k, v))
    return dict(out=o.detach().numpy(), dq=g[0].numpy(), dk=g[1].numpy(), dv=g[2].numpy())


@pytest.mark.parametrize("flash", [False, True], ids=["reference", "kernel_route"])
@pytest.mark.parametrize("mode", W.MODES)
@pytest.mark.parametrize("case", list(W.ATTN_CASES))
@pytest.mark.parametrize("layout", LAYOUTS, ids=["data2_seq2", "seq4"])
def test_sequence_parallel_attention(ranks, jax_attention, layout, case, mode, flash):
    got = _assemble(ranks[layout], *layout, f"attn/{case}/{mode}/{int(flash)}")
    wants = {"port": _single(case)}
    wants.update({f"jax_{name}": jax_attention[layout, case, name]
                  for name in JAX_REFS[case]})
    for label, want in wants.items():
        for k in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} vs {label}")


@pytest.mark.parametrize("layout", LAYOUTS, ids=["data2_seq2", "seq4"])
def test_seq_heads_all_to_all_roundtrip(ranks, layout):
    data, seq = layout
    x = np.random.default_rng(0).standard_normal((2, 32, 8, 4)).astype(np.float32)
    for s in range(seq):
        r = ranks[layout][_rank(seq, 0, s)]["a2a"]
        heads = 8 // seq
        np.testing.assert_array_equal(r["heads"].numpy(), x[:, :, s * heads:(s + 1) * heads])
        np.testing.assert_array_equal(r["back"].numpy(), x[:, s * 32 // seq:(s + 1) * 32 // seq])


def test_expand_kv_replicates_heads():
    from vidi_tpu.parallel.ulysses import expand_kv as jexpand
    from vidi_tpu_torch.parallel.ulysses import expand_kv

    k = np.random.default_rng(0).standard_normal((1, 8, 2, 4)).astype(np.float32)
    got = expand_kv(torch.from_numpy(k), torch.from_numpy(k), 2, 8)
    want = jexpand(jnp.asarray(k), jnp.asarray(k), 2, 8)
    for g, w in zip(got, want):
        assert g.shape == (1, 8, 8, 4)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# (iii) forward
# ---------------------------------------------------------------------------

def _stacked(tree):
    """The port's tree in vidi_tpu's layout (layers stacked [L, ...])."""
    if isinstance(tree, dict):
        return {k: (jax.tree.map(lambda *xs: np.stack(xs), *map(_stacked, v))
                    if k == "layers" and isinstance(v, list) else _stacked(v))
                for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module")
def forward_refs(spawned):
    """(the port's mesh-less hidden, JAX's ring forward under (2, 2))."""
    cfg = W.tiny_cfg()
    params = dattn.init_params(cfg, torch.float32, "cpu", 0)
    ids, img, img_mask = W.forward_inputs(cfg)
    mask = np.ones(ids.shape, bool)
    pos = np.broadcast_to(np.arange(ids.shape[1], dtype=np.int32)[None], ids.shape)
    with torch.no_grad():
        emb = decoder.embed_tokens(params["text"], torch.from_numpy(ids).long(), cfg.text)
        h, _ = dattn.forward(params, cfg, emb, torch.from_numpy(mask),
                             torch.from_numpy(pos.copy()).long(),
                             img=torch.from_numpy(img), img_mask=torch.from_numpy(img_mask))
    jcfg = JConfig.tiny()
    jp = _stacked(params)
    jmesh = jmake_mesh(jax.devices()[:4], data=2, seq=2, model=1)
    jemb = jdecoder.embed_tokens(jp["text"], jnp.asarray(ids), jcfg.text)
    with jsh.use_mesh(jmesh):
        jh, _ = jax.jit(lambda p, e: jdattn.forward(
            p, jcfg, e, jnp.asarray(mask), jnp.asarray(pos), img=jnp.asarray(img),
            img_mask=jnp.asarray(img_mask), sp_mode="ring"))(jp, jemb)
    return h.numpy(), np.asarray(jh)


@pytest.mark.parametrize("mode", W.MODES)
def test_forward_under_mesh(ranks, forward_refs, mode):
    res = ranks[(2, 2)]
    for d in range(2):
        hs = [res[_rank(2, d, s)][f"fwd/{mode}"]["h"] for s in range(2)]
        assert torch.equal(hs[0], hs[1])
    got = torch.cat([res[_rank(2, d, 0)][f"fwd/{mode}"]["h"] for d in range(2)]).numpy()
    for want in forward_refs:
        np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


# ---------------------------------------------------------------------------
# (iv) training
# ---------------------------------------------------------------------------

def _single_steps(cfg, batch_fn):
    """The port's two steps in one process on the global batches of
    `batch_fn`: (losses, first-step gradients, parameters after)."""
    params = dattn.init_params(cfg, torch.float32, "cpu", 0)
    tx = topt.make_optimizer(params, W.train_hparams())
    state = tx.init(params)
    losses = []
    for step in range(W.TRAIN_STEPS):
        batch, noise, hw = batch_fn(cfg, step)
        kw = dict(cfg=cfg, hw=hw, remat=True)
        if step == 0:
            loss, grads = value_and_grads(params, batch, noise, labels=tx.labels, **kw)
            tx.apply(params, grads, state)
        else:
            params, state, loss = train_step(params, state, batch, noise, tx=tx, **kw)
        losses.append(float(loss))
    return losses, grads, params


@pytest.fixture(scope="module")
def single_steps(spawned):
    return _single_steps(W.tiny_cfg(), W.train_batch)


@pytest.fixture(scope="module")
def single_image_steps(spawned):
    return _single_steps(W.image_cfg(), W.image_batch)


def _check_fsdp_steps(ranks, single, run):
    """Each rank's losses, first-step gradient slices and parameter slices
    of the run `run` against the single-process steps."""
    losses, grads, params = single
    specs = sharding.param_specs(params, Mesh({"data": 2, "seq": 2}))
    for r, res in enumerate(ranks[(2, 2)]):
        got = res[run]
        for a, b in zip(got["losses"].tolist(), losses):
            assert abs(a - b) <= LOSS_TOL * abs(b), (r, a, b)
        mesh = Mesh({"data": 2, "seq": 2}, rank=r)
        for key, _, p in topt.leaves(params):
            g = grads[key]
            spec = specs[key]
            if spec is not None:
                g = sharding._local_slice(g, *spec, mesh)
                p = sharding._local_slice(p, *spec, mesh)
            limit = max(LEAF_TOL * float(grads[key].abs().max()), LEAF_FLOOR)
            err = float((got["grads"][key] - g).abs().max())
            assert err <= limit, (r, key, err, limit)
            np.testing.assert_allclose(got["params"][key].numpy(), p.numpy(), rtol=0,
                                       atol=PARAM_TOL, err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("mode", W.MODES)
def test_fsdp_train_steps_match_one_process(ranks, single_steps, mode):
    _check_fsdp_steps(ranks, single_steps, f"train/{mode}")


@pytest.mark.parametrize("mode", W.MODES)
def test_fsdp_image_train_steps_match_one_process(ranks, single_image_steps, mode):
    _check_fsdp_steps(ranks, single_image_steps, f"train_image/{mode}")


def test_fsdp_storage_is_a_quarter(ranks):
    """Every leaf whose JAX leaf has >= 2**14 elements (the per-layer ones
    counted stacked), pos_embed aside, and its AdamW moments: a quarter on
    each of the 4 ranks."""
    params = dattn.init_params(W.tiny_cfg(), torch.float32, "cpu", 0)
    big = ["/".join(map(str, p)) for p, shape, _ in sharding._stacked_paths(params)
           if np.prod(shape) >= 2**14 and "pos_embed" not in p]
    assert len(big) >= 20
    for res in ranks[(2, 2)]:
        sizes = res["train/ring"]["sizes"]
        for key in big:
            for k in (key, f"mu/{key}"):
                local, whole = sizes[k]
                assert local * 4 == whole, (k, local, whole)


# ---------------------------------------------------------------------------
# (v) the CLI under torchrun
# ---------------------------------------------------------------------------

def _cli_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore::FutureWarning")
    return env


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_under_torchrun_resumes_and_matches_one_process(tmp_path):
    from vidi_tpu_torch.train import train as tcli

    out, one = tmp_path / "run", tmp_path / "one"
    common = ["--tiny", "--data_path", "synthetic", "--device", "cpu", "--dtype", "float32",
              "--learning_rate", "1e-3", "--mm_rand_lr", "1e-3"]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "4", "-m", "vidi_tpu_torch.train.train", *common,
           "--output_dir", str(out), "--seq_parallel_size", "2", "--sp_mode", "ring"]
    first = subprocess.Popen([*run, "--max_steps", "2"], cwd=ROOT, env=_cli_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # meanwhile, one process on the same global batch: data 2 x 1 row
    tcli.main([*common, "--output_dir", str(one), "--per_device_train_batch_size", "2",
               "--max_steps", "3"])
    stdout, stderr = first.communicate(timeout=300)
    assert first.returncode == 0, stdout[-2000:] + stderr[-3000:]
    assert sorted(os.listdir(out / "checkpoints")) == ["step_2.pt"]
    second = subprocess.run([*run, "--max_steps", "3"], cwd=ROOT, env=_cli_env(),
                            capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stdout[-2000:] + second.stderr[-3000:]
    assert "resumed from step 2" in second.stdout
    got = [m["loss"] for m in _metrics(out)]
    assert [m["step"] for m in _metrics(out)] == [0, 1, 2]
    ckpt = torch.load(out / "checkpoints" / "step_3.pt", weights_only=True)
    assert ckpt["params"]["text"]["embed"].shape == (512, 64)  # saved whole

    want = [m["loss"] for m in _metrics(one)]
    for a, b in zip(got, want):
        assert abs(a - b) <= LOSS_TOL * abs(b), (got, want)
    with pytest.raises(NotImplementedError, match="Q1.16c"):
        tcli.main([*common, "--output_dir", str(one), "--model_parallel_size", "2"])


def test_cli_data_ranks_decode_their_rows(tmp_path):
    """Two data ranks each decode only their rows of an image-conv file and
    pad them to the global batch's sizes: the losses are one process's on
    the same global batch. Seed 1 orders the file so that step 1 pairs two
    images of 5 and 3 tiles (tile buckets 5 and 3: the ranks' own batches
    differ in size)."""
    from test_torch_train_extras import _conversations
    from vidi_tpu_torch.train import train as tcli

    data = _conversations(tmp_path, image=True)
    common = ["--tiny", "--device", "cpu", "--dtype", "float32", "--mm_input_type", "image",
              "--mm_image_aspect_ratio", "anyres", "--dataset_type", "image-conv",
              "--data_path", data, "--image_folder", str(tmp_path), "--max_steps", "3",
              "--learning_rate", "1e-3", "--mm_rand_lr", "1e-3", "--seed", "1"]
    run = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "vidi_tpu_torch.train.train", *common, "--output_dir",
         str(tmp_path / "run")],
        cwd=ROOT, env=_cli_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    tcli.main([*common, "--output_dir", str(tmp_path / "one"),
               "--per_device_train_batch_size", "2"])
    stdout, stderr = run.communicate(timeout=300)
    assert run.returncode == 0, stdout[-2000:] + stderr[-3000:]
    got = [m["loss"] for m in _metrics(tmp_path / "run")]
    want = [m["loss"] for m in _metrics(tmp_path / "one")]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert abs(a - b) <= LOSS_TOL * abs(b), (got, want)
