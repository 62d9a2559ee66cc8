"""HF checkpoints in and out of the port, against the `safetensors` package
and vidi_tpu, at the tiny configuration on the CPU.

- The port's safetensors writer read by `safetensors.torch.load_file`, and
  the library's files read by the port's reader: every dtype of the map,
  bit-equal, two shards, a metadata block; malformed files raise ValueError
  naming the file.
- vidi_tpu's `save_pretrained` -> the port's `load_model` equals
  `params_from_jax` of the same parameters, and the port's
  `save_pretrained` -> vidi_tpu's `load_model` equals them, leaf by leaf,
  bit-equal in fp32; the int8 load equals quantizing the loaded tree.
- `config_to_hf` / `config_from_hf` equal vidi_tpu's.
- `assemble_model` from tiny `transformers` Gemma2 / SigLIP / Whisper
  checkpoints: text and towers equal vidi_tpu's, llm_norm at mm_std, a
  wrong layout raising KeyError.
- int8 / int4 trees export dequantized.
- `ask` from an exported directory gives the same tokens in both packages,
  and the CLI's --model-path the same answer.
- The train CLI with --export_hf: the directory loads back to logits within
  1e-5 of the trained tree's.
"""
import dataclasses
import json
import os
import subprocess
import sys
import weakref

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.core.config import DattnConfig as JConfig
from vidi_tpu.infer import export as jexport
from vidi_tpu.infer import loader as jloader
from vidi_tpu.infer import pipeline as jpipe
from vidi_tpu_torch.core.config import DattnConfig as TConfig
from vidi_tpu_torch.infer import export as texport
from vidi_tpu_torch.infer import loader as tloader
from vidi_tpu_torch.infer import pipeline as tpipe
from vidi_tpu_torch.infer import quantize as tq
from vidi_tpu_torch.infer import safetensors_io as sio
from vidi_tpu_torch.infer.convert import params_from_jax
from torch_init import port_init  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from make_example import make_video  # noqa: E402
from test_torch_pipeline import _RecordingTokenizer  # noqa: E402

MM_STD = 0.028976401314139366
QUERY = "a moving gradient"
F32 = torch.float32


def _assert_trees_equal(got, want, path=""):
    """Same keys, lengths, dtypes and values (bit for bit)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}/{i}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype,
                                                                    want.dtype)
        assert torch.equal(got, want), path


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny model's fp32 parameters (the port's init in vidi_tpu's
    layout, seed 0), written by each package's save_pretrained."""
    root = tmp_path_factory.mktemp("exported")
    jp = jax.device_get(port_init(JConfig.tiny(), 0))
    tp = params_from_jax(jp)
    jexport.save_pretrained(jp, JConfig.tiny(), str(root / "ref"))
    texport.save_pretrained(tp, TConfig.tiny(), str(root / "port"))
    return {"root": root, "jp": jp, "tp": tp, "ref": str(root / "ref"),
            "port": str(root / "port")}


# --- the format ---------------------------------------------------------------

def _all_dtypes():
    g = torch.Generator().manual_seed(0)
    return {
        "bf16": torch.randn(3, 5, generator=g).bfloat16(),
        "f16": torch.randn(4, generator=g).half(),
        "f32": torch.randn(2, 3, 2, generator=g),
        "f64": torch.randn(3, generator=g, dtype=torch.float64),
        "i8": torch.randint(-128, 128, (7,), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 256, (2, 2), generator=g, dtype=torch.uint8),
        "i16": torch.randint(-2**15, 2**15, (3,), generator=g, dtype=torch.int16),
        "i32": torch.randint(-2**31, 2**31 - 1, (3,), generator=g, dtype=torch.int32),
        "i64": torch.randint(-2**62, 2**62, (2,), generator=g, dtype=torch.int64),
        "bool": torch.rand(5, generator=g) > 0.5,
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 3),
    }


def test_dtype_map_is_the_library_map():
    st = pytest.importorskip("safetensors.torch")
    assert {t.dtype for t in _all_dtypes().values()} == set(sio.NAMES)
    for name, dtype in sio.DTYPES.items():
        assert st._TYPES[name] == dtype


@pytest.mark.parametrize("writer", ["port", "library"])
def test_two_shards_with_metadata_bit_equal(tmp_path, writer):
    """One package writes two shards with a metadata block, the other reads
    them: every tensor bit-equal, in its dtype."""
    st = pytest.importorskip("safetensors.torch")
    tensors = _all_dtypes()
    names = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    meta = {"format": "pt", "note": "two shards"}
    for fname, keys in shards.items():
        part = {k: tensors[k] for k in keys}
        path = str(tmp_path / fname)
        if writer == "port":
            sio.save_file(part, path, metadata=meta)
        else:
            st.save_file(part, path, metadata=meta)
    if writer == "port":
        for fname, keys in shards.items():
            got = st.load_file(str(tmp_path / fname))
            assert sorted(got) == sorted(keys)
            for k in keys:
                assert got[k].dtype == tensors[k].dtype and torch.equal(got[k], tensors[k]), k
        from safetensors import safe_open
        with safe_open(str(tmp_path / fname), framework="pt") as f:
            assert f.metadata() == meta
    else:
        index = sio.load_safetensors_dir(str(tmp_path))
        assert sorted(index) == names
        assert all(isinstance(index[k], sio.TensorRef) for k in names)  # nothing read yet
        assert [m for _, m in index.shards] == [meta, meta]
        for k in names:
            got = index.load(k, "cpu")
            assert got.dtype == tensors[k].dtype and torch.equal(got, tensors[k]), k


def test_staging_buffer_is_unregistered_when_it_dies(monkeypatch):
    """The page-locked buffer of a load or save is registered with CUDA when
    made, reused while large enough, and unregistered when it dies (so its
    memory leaves the process with the load or save), with the CUDA calls
    recorded in place of the driver's."""
    import gc

    calls = []

    class Cudart:
        def cudaHostRegister(self, ptr, n, flags):
            calls.append(("register", ptr, n))
            return 0

        def cudaHostUnregister(self, ptr):
            calls.append(("unregister", ptr))
            return 0

    monkeypatch.setattr(torch.cuda, "cudart", Cudart)
    monkeypatch.setattr(torch.cuda, "check_error", lambda res: None)
    small = sio._staging(torch.empty(0, dtype=torch.uint8), 64)
    p_small = small.data_ptr()
    assert calls == [("register", p_small, 64)]
    assert sio._staging(small, 32) is small and len(calls) == 1
    big = sio._staging(small, 128)
    p_big = big.data_ptr()
    del small
    gc.collect()
    assert calls == [("register", p_small, 64), ("register", p_big, 128),
                     ("unregister", p_small)]
    view = big[:16]
    del big
    gc.collect()
    assert calls[-1] == ("unregister", p_small)  # the view keeps it
    del view
    gc.collect()
    assert calls[-1] == ("unregister", p_big)


def test_tensors_larger_than_the_stage_read_in_pieces(tmp_path, monkeypatch):
    """A tensor larger than STAGE_BYTES is read in pieces (a ragged last one
    included), bit-equal, in every dtype."""
    monkeypatch.setattr(sio, "STAGE_BYTES", 8)
    tensors = _all_dtypes()
    sio.save_file(tensors, str(tmp_path / "m.safetensors"))
    index = sio.load_safetensors_dir(str(tmp_path))
    for k, want in tensors.items():
        got = index.load(k, "cpu")
        assert got.dtype == want.dtype and torch.equal(got, want), k


def _write_raw(path, header: dict, data: bytes = b"", n=None):
    text = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write((len(text) if n is None else n).to_bytes(8, "little") + text + data)


def _entry(dtype="F32", shape=(2,), offs=(0, 8)):
    return {"dtype": dtype, "shape": list(shape), "data_offsets": list(offs)}


MALFORMED = {
    "short file": lambda p: open(p, "wb").write(b"\x01\x02"),
    "header length past the file": lambda p: _write_raw(p, {"a": _entry()}, bytes(8), n=10**6),
    "header not JSON": lambda p: open(p, "wb").write((4).to_bytes(8, "little") + b"{{{{"),
    "unknown dtype": lambda p: _write_raw(p, {"a": _entry("F8")}, bytes(8)),
    "offsets overlap": lambda p: _write_raw(p, {"a": _entry(offs=(0, 8)),
                                                "b": _entry(offs=(4, 12))}, bytes(12)),
    "offsets past the data": lambda p: _write_raw(p, {"a": _entry(offs=(8, 16))}, bytes(8)),
    "offsets disagree with the shape": lambda p: _write_raw(
        p, {"a": _entry(shape=(3,), offs=(0, 8))}, bytes(12)),
    "negative offsets": lambda p: _write_raw(p, {"a": _entry(offs=(8, 0))}, bytes(8)),
    "metadata not strings": lambda p: _write_raw(
        p, {"__metadata__": {"n": 1}, "a": _entry()}, bytes(8)),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_file_raises(tmp_path, case):
    path = str(tmp_path / "bad.safetensors")
    MALFORMED[case](path)
    with pytest.raises(ValueError, match="bad.safetensors"):
        sio.Index([path])


def test_a_name_in_two_shards_raises(tmp_path):
    for i in range(2):
        sio.save_file({"w": torch.zeros(2)}, str(tmp_path / f"s{i}.safetensors"))
    with pytest.raises(ValueError, match="also in"):
        sio.load_safetensors_dir(str(tmp_path))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        sio.load_safetensors_dir(str(tmp_path / "empty"))


# --- whole checkpoints, both packages -----------------------------------------

def test_reference_export_loads_in_port(exported):
    params, cfg, tok = tloader.load_model(model_path=exported["ref"], dtype=F32,
                                          device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(TConfig.tiny())
    _assert_trees_equal(params, exported["tp"])
    assert type(tok).__name__ == "ByteTokenizer"


def test_port_export_loads_in_reference(exported):
    jp, jcfg, _ = jloader.load_model(model_path=exported["port"], dtype=jnp.float32)
    assert jcfg == JConfig.tiny()
    want = dict(jax.tree_util.tree_flatten_with_path(exported["jp"])[0])
    got = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(w),
                                      err_msg=str(path))


def test_quantized_load_equals_quantizing_the_loaded_tree(exported):
    """load_8bit / load_8bit_towers quantize each layer as it arrives: the
    same codes and scales as quantizing the full-precision tree."""
    full, _, _ = tloader.load_model(model_path=exported["port"], dtype=F32, device="cpu")
    q8, _, _ = tloader.load_model(model_path=exported["port"], dtype=F32, device="cpu",
                                  load_8bit=True, load_8bit_towers=True)
    _assert_trees_equal(q8, tq.quantize_params(full, modules=("text", "vision", "audio")))
    q4, _, _ = tloader.load_model(model_path=exported["port"], dtype=F32, device="cpu",
                                  load_4bit=True)
    _assert_trees_equal(q4, tq.quantize_params(full, modules=("text",), bits=4))


@pytest.mark.parametrize("ctor", ["tiny", "tiny_mistral", "vidi15_9b", "bench_1_5b"])
def test_config_maps_match_reference(ctor):
    make = {"tiny_mistral": lambda C: C.tiny("mistral")}.get(
        ctor, lambda C: getattr(C, ctor)())
    tcfg, jcfg = make(TConfig), make(JConfig)
    tjson = texport.config_to_hf(tcfg)
    assert tjson == jexport.config_to_hf(jcfg)
    back = tloader.config_from_hf(json.loads(json.dumps(tjson)))
    assert back == tcfg
    assert dataclasses.asdict(back) == dataclasses.asdict(jloader.config_from_hf(tjson))


@pytest.mark.parametrize("bits", [8, 4])
def test_export_dequantizes_int8_and_int4(exported, bits):
    tp = exported["tp"]
    sd = texport.export_state_dict(tq.quantize_params(tp, bits=bits), TConfig.tiny())
    deferred = sd["model.layers.0.self_attn.q_proj.weight"]
    assert isinstance(deferred, sio.Deferred)  # dequantized only when written
    lw = deferred.make()
    assert lw.dtype == deferred.dtype == F32 and tuple(lw.shape) == deferred.shape
    ref = tp["text"]["layers"][0]["q_w"].t()
    # the exported weights are the dequantized ones (coarser for int4)
    assert float((lw - ref).abs().max()) <= (0.02 if bits == 8 else 0.2)
    want = tq.dequantize_weight(tq.quantize_weight(tp["text"]["layers"][0]["q_w"]), F32)
    if bits == 8:
        assert torch.equal(lw, want.t())


@pytest.mark.parametrize("bits", [8, 4])
def test_export_dequantizes_one_tensor_at_a_time(exported, tmp_path, monkeypatch, bits):
    """save_pretrained of a quantized tree makes each dequantized tensor as
    it writes it: when one is made, none made before it is still alive."""
    made, most_alive = [], [0]

    def spy(real):
        def deq(wq, dtype=torch.bfloat16):
            most_alive[0] = max(most_alive[0], sum(r() is not None for r in made))
            out = real(wq, dtype).clone()  # a base of its own, which views keep alive
            made.append(weakref.ref(out))
            return out
        return deq

    q = tq.quantize_params(exported["tp"], bits=bits)
    monkeypatch.setattr(tq, "dequantize_weight", spy(tq.dequantize_weight))
    monkeypatch.setattr(tq, "dequantize_weight4", spy(tq.dequantize_weight4))
    texport.save_pretrained(q, TConfig.tiny(), str(tmp_path))
    assert len(made) == 7 * TConfig.tiny().text.num_layers
    assert most_alive[0] == 0
    sd = sio.load_safetensors_dir(str(tmp_path))
    got = sd.load("model.layers.0.self_attn.q_proj.weight", "cpu")
    assert torch.equal(got, texport.export_state_dict(q, TConfig.tiny())[
        "model.layers.0.self_attn.q_proj.weight"].make())


def test_load_model_does_not_retry_out_of_memory(exported, monkeypatch):
    calls = []

    def oom(*args, **kwargs):
        calls.append(1)
        raise torch.OutOfMemoryError("planted")

    monkeypatch.setattr(tloader, "convert_dattn", oom)
    with pytest.raises(torch.OutOfMemoryError, match="planted"):
        tloader.load_model(model_path=exported["port"], dtype=F32, device="cpu")
    assert len(calls) == 1


def test_tokenizer_files_need_transformers(tmp_path, monkeypatch):
    (tmp_path / "tokenizer.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "transformers", None)  # import raises
    with pytest.raises(ImportError, match="transformers"):
        tloader.load_tokenizer(str(tmp_path), TConfig.tiny())


# --- assembly -------------------------------------------------------------------

@pytest.fixture(scope="module")
def base_ckpts(tmp_path_factory):
    """Tiny HF-format checkpoint directories: Gemma2 LLM, SigLIP, Whisper."""
    pytest.importorskip("transformers")
    from safetensors.torch import save_file
    from transformers import (Gemma2Config, Gemma2ForCausalLM, SiglipVisionConfig,
                              SiglipVisionModel, WhisperConfig)
    from transformers.models.whisper.modeling_whisper import WhisperEncoder

    root = tmp_path_factory.mktemp("base_ckpts")
    torch.manual_seed(0)

    def save(name, model, cfg):
        os.makedirs(root / name)
        save_file({k: v.detach().clone() for k, v in model.state_dict().items()},
                  str(root / name / "model.safetensors"))
        (root / name / "config.json").write_text(json.dumps(cfg.to_dict()))

    text_cfg = Gemma2Config(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, sliding_window=16,
        query_pre_attn_scalar=16, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0)
    save("gemma2", Gemma2ForCausalLM(text_cfg).eval(), text_cfg)
    vis_cfg = SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                                 num_attention_heads=2, image_size=42, patch_size=14)
    save("siglip", SiglipVisionModel(vis_cfg).eval(), vis_cfg)
    aud_cfg = WhisperConfig(d_model=32, encoder_layers=2, encoder_attention_heads=2,
                            encoder_ffn_dim=64, num_mel_bins=128, max_source_positions=1500)
    save("whisper", WhisperEncoder(aud_cfg).eval(), aud_cfg)
    return root


def test_assemble_matches_reference(base_ckpts):
    root = base_ckpts
    kw = dict(mm_vision_tower=str(root / "siglip"), mm_audio_tower=str(root / "whisper"),
              mm_overrides={"mm_std": MM_STD, "mm_time_interval": 16,
                            "model_max_length": 128, "mm_image_pool_size": None})
    jp, jcfg, _ = jloader.load_model(str(root / "gemma2"), dtype=jnp.float32, **kw)
    tp, tcfg, tok = tloader.load_model(str(root / "gemma2"), dtype=F32, device="cpu", **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.vision.num_layers == 3 and tcfg.audio.d_model == 32
    assert tcfg.mm_time_interval == 16 and tcfg.mm_image_pool_size == 2
    assert type(tok).__name__ == "ByteTokenizer"
    want = params_from_jax(jax.device_get(jp))
    for module in ("text", "vision", "audio"):
        _assert_trees_equal(tp[module], want[module], module)
    # fresh adapters from the port's own generator: the reference's shapes,
    # llm_norm at mm_std, the position MLPs in fp32
    assert jax.tree.map(np.shape, jax.device_get(jp["mm"])) == \
        jax.tree.map(lambda t: tuple(t.shape), tp["mm"])
    assert torch.equal(tp["mm"]["llm_norm"]["weight"],
                       torch.full((64,), MM_STD, dtype=F32))
    assert tp["mm"]["pos_t"]["w0"].dtype == F32

    # no audio tower: the tiny random stub, as in the reference
    tp2, tcfg2, _ = tloader.load_model(
        str(root / "gemma2"), dtype=torch.bfloat16, device="cpu",
        mm_vision_tower=str(root / "siglip"), mm_overrides={"mm_std": MM_STD})
    assert tcfg2.audio == TConfig.tiny().audio and tcfg2.mm_time_interval == 10000
    assert tp2["audio"]["conv1_w"].shape[0] == 32
    assert tp2["mm"]["pos_w"]["w0"].dtype == F32 and tp2["text"]["embed"].dtype == torch.bfloat16


def test_assemble_rejects_bad_layout_and_random_weights(base_ckpts):
    root = base_ckpts
    with pytest.raises(KeyError, match="no prefix"):
        tloader.load_model(str(root / "gemma2"), dtype=F32, device="cpu",
                           mm_vision_tower=str(root / "whisper"),
                           mm_overrides={"mm_std": MM_STD})
    with pytest.raises(ValueError, match="random weights"):
        tloader.load_model(None, "tiny", device="cpu", mm_vision_tower=str(root / "siglip"))
    # image mode assembles since the image adapters were ported: fresh image
    # adapters over the loaded towers
    params, cfg = tloader.load_model(str(root / "gemma2"), dtype=F32, device="cpu",
                                     mm_vision_tower=str(root / "siglip"),
                                     mm_overrides={"mm_input_type": "image"})[:2]
    assert cfg.mm_input_type == "image"
    assert set(params["mm"]) == {"llm_norm", "projector", "norm", "pos_w", "pos_h"}


# --- the entry points -----------------------------------------------------------

@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("media") / "clip.mp4")
    make_video(path, seconds=6.0)
    return path


def test_ask_from_exported_dir_same_tokens(exported, clip, capsys):
    """Both packages load the directory the port wrote and answer alike;
    the port's CLI with --model-path prints the same answer."""
    jp, jcfg, _ = jloader.load_model(model_path=exported["port"], dtype=jnp.float32)
    tp, tcfg, _ = tloader.load_model(model_path=exported["port"], dtype=F32, device="cpu")
    kw = dict(max_new_tokens=16, mm_chunks=4, use_flash=False)
    jtok, ttok = _RecordingTokenizer(), _RecordingTokenizer()
    want = jpipe.ask(QUERY, clip, jp, jcfg, jtok, **kw)
    got = tpipe.ask(QUERY, clip, tp, tcfg, ttok, **kw)
    assert got == want
    assert ttok.decoded == jtok.decoded and any(ttok.decoded)
    capsys.readouterr()
    tpipe.main(["--video-path", clip, "--query", QUERY, "--model-path", exported["port"],
                "--device", "cpu", "--dtype", "float32", "--max-new-tokens", "16",
                "--mm-splits", "4"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == (want or "(no parsed output)")


def test_cli_model_path_and_random_weights_exclusive(exported):
    with pytest.raises(SystemExit):
        tpipe.main(["--video-path", "v.mp4", "--query", QUERY, "--random-weights", "tiny",
                    "--model-path", exported["port"], "--device", "cpu"])


def _logits(params, cfg):
    from vidi_tpu_torch.models import dattn, decoder

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, cfg.text.vocab_size, (1, 10)))
    img = torch.from_numpy(rng.standard_normal((1, 6, cfg.text.hidden_size)) * 0.1)
    dtype = params["text"]["embed"].dtype
    h, _ = dattn.forward(params, cfg, decoder.embed_tokens(params["text"], ids, cfg.text),
                         torch.ones(1, 10, dtype=torch.bool), torch.arange(10)[None],
                         img=img.to(dtype), img_mask=torch.ones(1, 6, dtype=torch.bool))
    return decoder.lm_logits(params["text"], h, cfg.text)


def test_train_cli_export_hf_roundtrip(tmp_path):
    out, hf = tmp_path / "run", tmp_path / "hf"
    res = subprocess.run(
        [sys.executable, "-m", "vidi_tpu_torch.train.train", "--tiny", "--data_path",
         "synthetic", "--output_dir", str(out), "--max_steps", "2", "--device", "cpu",
         "--dtype", "float32", "--export_hf", str(hf)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"exported HF checkpoint to {hf}" in res.stdout
    from vidi_tpu_torch.train.checkpoint import Checkpointer

    step, trained, _ = Checkpointer(str(out)).restore()
    assert step == 2
    loaded, cfg, _ = tloader.load_model(model_path=str(hf), dtype=F32, device="cpu")
    cfg_in = dataclasses.replace(TConfig.tiny(), loss_thres=0.1)
    assert cfg == cfg_in
    # two optimizer steps moved the weights off the init
    init = tloader.load_model(random_weights="tiny", dtype=F32, device="cpu", seed=45678)[0]
    assert not torch.equal(trained["text"]["embed"], init["text"]["embed"])
    _assert_trees_equal(loaded, trained)
    torch.testing.assert_close(_logits(loaded, cfg), _logits(trained, cfg_in),
                               atol=1e-5, rtol=1e-5)
