"""Checkpoint loading and HF export in the port (models/safetensors_io.py,
models/catalog.py, models/load.py, models/hf_export.py, the copies of conf/,
overwatch/, models/prompting.py and vla/norm_stats.py) against the JAX
package, on the CPU at tiny size, offline.

* The safetensors reader and writer against ``safetensors.numpy`` and
  ml_dtypes: every dtype both ways, metadata, a sharded directory with its
  index; bytes equal.
* Every catalog id against the JAX catalog through convert.config_from_jax
  (configs, image transforms, prompt builders), the ids the port lacks
  raising NotImplementedError naming their ROADMAP item; the model registry.
* params_from_hf_state / params_to_hf_state leaf for leaf equal to JAX's on
  a tiny random state (bf16: the same rounding of the same fp32 values).
* Each load / load_vla route of tests/test_hub_load.py, built with that
  file's fixture helpers: a native run dir, the `.pt` path convention, a
  registry id and an openvla-dev run id with step discovery from the local
  hub cache, the released-policy repo (sharded safetensors written by the
  port's writer), and quantize_bits 8 / 4 / "mix" / "nibble". Each is held to
  the JAX `load_vla` on the same files: every leaf equal (quantized codes and
  scales bit for bit), the config (convert.config_from_jax), norm stats,
  codec vocabulary, and one call's tokens (the margin rule of
  tests/test_torch_turbo_kv8.assert_tokens: with the first logits' gap, which
  must stay under 2e-2, on bf16 weights; with 2e-2 on quantized trunks, whose
  decode steps' activation codes may flip at a rounding tie). Quantized codes
  are held bit for bit to the JAX package's quantize_params of its own load
  and within one step to its load_vla's, which quantizes under jit.
* hf_export's sidecars byte-equal to JAX's; the copied modules equal to
  JAX's files but for the torch.distributed rank.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import openvla_probe_tpu
import openvla_probe_tpu_torch
from openvla_probe_tpu.models import catalog as jcat
from openvla_probe_tpu.models import hf_export as jexport
from openvla_probe_tpu.models import load as jload
from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import catalog as tcat
from openvla_probe_tpu_torch.models import hf_export as texport
from openvla_probe_tpu_torch.models import load as tload
from openvla_probe_tpu_torch.models import safetensors_io as sio
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.ops import linear as tlin
from tests.test_hub_load import ARCH, LLM_ID, VIS_ID, _make_hub_cache, tiny_run_dir  # noqa: F401
from tests.test_torch_openvla import _ovla_env, clean_ovla_env  # noqa: F401 (autouse)
from tests.test_torch_turbo import jax_turbo
from tests.test_torch_turbo_kv8 import assert_tokens

JROOT = Path(openvla_probe_tpu.__file__).parent
TROOT = Path(openvla_probe_tpu_torch.__file__).parent
BF16_GAP = 2e-2      # first logits, port vs JAX, bf16 tiny weights (module docstring)
QUANT_GAP = 2e-2     # the logit gap the margin rule assumes on quantized trunks


class Tok:
    def encode(self, text):
        return [1] + [len(w) + 3 for w in text.split()]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# --- the safetensors reader and writer -------------------------------------------------

DTYPES = {"BF16": ml_dtypes.bfloat16, "F16": np.float16, "F32": np.float32, "F64": np.float64,
          "I8": np.int8, "U8": np.uint8, "I16": np.int16, "I32": np.int32, "I64": np.int64,
          "BOOL": np.bool_}


def _arrays(seed=0):
    r = np.random.default_rng(seed)
    out = {}
    for i, (name, dt) in enumerate(DTYPES.items()):
        shape = [(3, 5), (7,), (2, 3, 4), (), (0, 3)][i % 5]
        a = r.normal(0, 3, shape)
        out[f"t.{name}"] = (a > 0) if dt is np.bool_ else a.astype(dt)
    return out


def _bytes_equal(got: torch.Tensor, want: np.ndarray, name: str):
    g = got.view(torch.int16).numpy() if got.dtype == torch.bfloat16 else got.numpy()
    w = want.view(np.int16) if want.dtype == ml_dtypes.bfloat16 else want
    assert g.shape == w.shape and g.tobytes() == w.tobytes(), name


def test_reader_reads_safetensors_files(tmp_path):
    from safetensors.numpy import save_file

    arrs = _arrays()
    save_file(arrs, str(tmp_path / "x.safetensors"), metadata={"format": "pt", "k": "v"})
    f = sio.SafetensorsFile(tmp_path / "x.safetensors")
    assert f.metadata == {"format": "pt", "k": "v"}
    assert set(f.keys()) == set(arrs)
    for k, a in arrs.items():
        t = f.get_tensor(k)
        assert t.dtype == sio.DTYPES[k.split(".")[1]], k
        _bytes_equal(t, a, k)


def test_writer_writes_safetensors_files(tmp_path):
    from safetensors.numpy import load_file
    from safetensors import safe_open

    arrs = _arrays(1)
    sio.save_file({k: sio.to_tensor(v) for k, v in arrs.items()}, tmp_path / "y.safetensors",
                  metadata={"format": "pt"})
    back = load_file(str(tmp_path / "y.safetensors"))
    assert set(back) == set(arrs)
    for k, a in arrs.items():
        assert back[k].dtype == a.dtype and back[k].tobytes() == a.tobytes(), k
    with safe_open(str(tmp_path / "y.safetensors"), framework="np") as sf:
        assert sf.metadata() == {"format": "pt"}
    # the cast on the way out, one tensor at a time
    sio.save_file({"w": torch.randn(4, 3)}, tmp_path / "z.safetensors", dtype=torch.bfloat16)
    assert load_file(str(tmp_path / "z.safetensors"))["w"].dtype == ml_dtypes.bfloat16


def test_sharded_directory_with_index(tmp_path):
    from safetensors.numpy import load_file

    r = np.random.default_rng(2)
    state = {f"layer.{i}.w": sio.to_tensor(r.normal(size=(64, 32)).astype(np.float32))
             for i in range(5)}
    out = sio.save_sharded(state, tmp_path, max_shard_bytes=3 * 64 * 32 * 2,
                           dtype=torch.bfloat16)
    assert out["files"] == [f"model-0000{i}-of-00002.safetensors" for i in (1, 2)]
    index = json.loads((tmp_path / sio.INDEX_FILE).read_text())
    assert index["metadata"]["total_size"] == 5 * 64 * 32 * 2
    assert set(index["weight_map"]) == set(state)
    lazy = sio.read_dir(tmp_path)
    assert set(lazy) == set(state) and "layer.0.w" in lazy
    for k, t in state.items():
        shard = load_file(str(tmp_path / index["weight_map"][k]))
        np.testing.assert_array_equal(shard[k].astype(np.float32),
                                      t.to(torch.bfloat16).float().numpy())
        assert torch.equal(lazy[k], t.to(torch.bfloat16))
    # a state that fits writes one file and no index
    one = tmp_path / "one"
    assert sio.save_sharded(state, one)["files"] == ["model.safetensors"]
    assert not (one / sio.INDEX_FILE).exists()
    with pytest.raises(FileNotFoundError, match="No safetensors files"):
        sio.read_dir(tmp_path / "nowhere")


# --- the catalog ----------------------------------------------------------------------


def _same_image_cfg(t, j):
    assert t.resize_strategy == j.resize_strategy
    assert len(t.specs) == len(j.specs)
    for a, b in zip(t.specs, j.specs):
        assert (tuple(a.input_size), a.interpolation, tuple(a.mean), tuple(a.std)) == \
            (tuple(b.input_size), b.interpolation, tuple(b.mean), tuple(b.std))


_MISSING = {**{v: "item 3" for v in ("clip-vit-l", "clip-vit-l-336px", "in1k-vit-l",
                                      "dinoclip-vit-l-336px")},
            **{m: "item 15" for m in ("phi-2-3b", "mixtral-8x7b-v0.1",
                                      "mixtral-8x7b-instruct-v0.1", "mixtral-tiny")}}


@pytest.mark.parametrize("vision_id,llm_id", [(v, "llama2-7b-pure") for v in jcat.VISION_BACKBONES]
                         + [("dinosiglip-vit-so-224px", m) for m in jcat.LLM_BACKBONES])
def test_every_catalog_id_matches_jax(vision_id, llm_id):
    assert set(tcat.VISION_BACKBONES) == set(jcat.VISION_BACKBONES)
    assert set(tcat.LLM_BACKBONES) == set(jcat.LLM_BACKBONES)
    assert (tcat.LLM_BACKBONES[llm_id]["prompt"].__name__
            == jcat.LLM_BACKBONES[llm_id]["prompt"].__name__)
    jcfg, jimg, jprompt = jcat.build_vlm_config(vision_id, llm_id, ARCH, "letterbox")
    missing = _MISSING.get(vision_id) or _MISSING.get(llm_id)
    if missing:
        with pytest.raises(NotImplementedError, match=missing):
            tcat.build_vlm_config(vision_id, llm_id, ARCH, "letterbox")
        return
    tcfg, timg, tprompt = tcat.build_vlm_config(vision_id, llm_id, ARCH, "letterbox")
    assert tcfg == convert.config_from_jax(jcfg)
    _same_image_cfg(timg, jimg)
    assert tprompt.__name__ == jprompt.__name__


def test_registry_matches_jax():
    assert tcat.MODEL_REGISTRY == jcat.MODEL_REGISTRY
    assert tcat.GLOBAL_REGISTRY == jcat.GLOBAL_REGISTRY
    assert tload.available_models() == jload.available_models()
    assert tload.available_model_names() == jload.available_model_names()
    for name in ("openvla-7b", "OpenVLA 7B", next(iter(jcat.MODEL_REGISTRY))):
        assert tload.get_model_description(name) == jload.get_model_description(name)
    with pytest.raises(ValueError) as te:
        tload.get_model_description("nope")
    with pytest.raises(ValueError) as je:
        jload.get_model_description("nope")
    assert str(te.value) == str(je.value)
    assert tcat.vlm.VLMConfig.openvla_13b() == convert.config_from_jax(
        jcat.vlm.VLMConfig.openvla_13b())


@pytest.fixture(scope="module")
def tiny_state():
    """A tiny random HF-layout state (JAX's params_to_hf_state) and its cfgs."""
    jcfg, _, _ = jcat.build_vlm_config(VIS_ID, LLM_ID, ARCH, "resize-naive",
                                       dtype=jnp.float32)
    params = __import__("openvla_probe_tpu.models.vlm", fromlist=["init_params"]).init_params(
        jcfg, jax.random.key(3))
    return jcfg, params, jcat.params_to_hf_state(params, jcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_hf_state_matches_jax(tiny_state, dtype):
    jcfg, _, state = tiny_state
    jcfg_d, _, _ = jcat.build_vlm_config(VIS_ID, LLM_ID, ARCH, "resize-naive",
                                         dtype=jnp.dtype(dtype))
    want = jcat.params_from_hf_state(state, jcfg_d)
    tcfg = convert.config_from_jax(jcfg_d)
    got = tcat.params_from_hf_state(state, tcfg, device="cpu")
    w, g = _flat(want), _flat(got)
    assert w.keys() == g.keys()
    for k in w:
        assert g[k].dtype == getattr(torch, dtype), k
        np.testing.assert_array_equal(_np(g[k]), _np(w[k]), err_msg=k)


def test_params_to_hf_state_matches_jax(tiny_state):
    jcfg, params, state = tiny_state
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      convert.config_from_jax(jcfg), device="cpu")
    got = tcat.params_to_hf_state(tparams, convert.config_from_jax(jcfg))
    assert list(got) == list(state)
    for k in state:
        np.testing.assert_array_equal(_np(got[k]), state[k], err_msg=k)


# --- load / load_vla against the JAX loader ----------------------------------------------


def _jax_env(bits):
    """The JAX configuration a loaded model is held to: its default environment
    for bf16 (the parity tier), jax_turbo for quantized trunks (with the Pallas
    w4a8 gate closed for grouped int4, whose turbo route is the grouped dot)."""
    if bits is None:
        return clean_ovla_env()
    ctx = jax_turbo()

    class _Ctx:
        def __enter__(self):
            mp = ctx.__enter__()
            mp.setenv("OVLA_PALLAS_W4A8", "0")
            return mp

        def __exit__(self, *exc):
            return ctx.__exit__(*exc)

    return _Ctx()


def _request(s, vocab, B=2, P=12, seed=0):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (B, s + 6, s + 6, 3), dtype=np.uint8)
    ids = np.zeros((B, P), np.int32)
    ids[:, 0] = 1
    ids[:, 1:9] = r.integers(3, vocab - 1, (B, 8))
    return dict(image_u8=img, input_ids=ids, prompt_len=np.full((B,), 9, np.int32),
                q01=-np.ones(7, np.float32), q99=np.ones(7, np.float32),
                action_mask=np.array([True] * 6 + [False]))


def _within_one_step(got_llm, want_llm, llm_cfg, bits):
    """The port's quantized LLM leaves against the JAX load_vla's: scales
    within one fp32 ulp, codes within one step."""
    spec = convert._quantized_spec(convert.llama_param_spec(llm_cfg),
                                   tlin._DEFAULT_QUANT_SUFFIXES, bits)
    def codes(tree):   # nibble planes as their int8 codes: one step may carry into hi
        if tlin.is_nibble_quant(tree):
            return {"q8": tlin.nibble_reconstruct_q8(tree), "s": tree["s"]}
        return {k: codes(v) for k, v in tree.items()} if isinstance(tree, dict) else tree

    want = _flat(codes(convert._convert(jax.tree.map(np.asarray, want_llm), spec, "",
                                        torch.device("cpu"))))
    got = _flat(codes(got_llm))
    assert want.keys() == got.keys()
    for k in want:
        g, w = got[k], want[k]
        if g.dtype == torch.uint8:       # packed int4 codes
            g, w = tlin.unpack_int4(g), tlin.unpack_int4(w)
        if g.dtype == torch.int8:
            assert (g.int() - w.int()).abs().max() <= 1, k
        else:
            torch.testing.assert_close(g, w, rtol=1.2e-7, atol=0, msg=k)


def _leaves_equal(got_tree, want_tree, cfg, bits):
    """Every leaf of the port's tree equals the JAX tree's (numpy; int4 codes
    as int8 codes, packed here): dtypes and bits."""
    suffixes = tlin._DEFAULT_QUANT_SUFFIXES if bits is not None else ()
    spec = convert._quantized_spec(convert.vlm_param_spec(cfg), suffixes, bits or 8)
    want = _flat(convert._convert(jax.tree.map(np.asarray, want_tree), spec, "",
                                  torch.device("cpu")))
    got = _flat(got_tree)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    return got, want


def _held_to_jax(tm, jm, bits=None, jax_bf16=None) -> int:
    """The port's loaded OpenVLA against the JAX loader's: leaves, config,
    norm stats, codec vocabulary, and one call's tokens. Quantized leaves are
    held bit for bit to the JAX package's quantize_params of its bf16 load
    (`jax_bf16`), and to its load_vla's own codes within one code step: that
    quantizes under jit, where XLA multiplies by 1/127 for the division
    (tests/test_torch_load.py::test_jitted_jax_quantize_rounds_differently)."""
    assert tm.cfg == convert.config_from_jax(jm.cfg)
    assert tm.cfg.codec_vocab_size == jm.cfg.codec_vocab_size
    assert json.dumps(jax.tree.map(lambda a: np.asarray(a).tolist(), jm.norm_stats),
                      sort_keys=True) == json.dumps(
        jax.tree.map(lambda a: np.asarray(a).tolist(), tm.norm_stats), sort_keys=True)
    jparams = jm.params
    if bits is None:
        _leaves_equal(tm.params, jm.params, tm.cfg.vlm, None)
    else:
        # the call runs JAX on the same codes as the port's (its eager quantize)
        jparams = {**jax_bf16, "llm": jlin.quantize_params(jax_bf16["llm"], bits=bits)}
        q = jlin.quantize_params(jax_bf16["llm"], bits=bits, emit_codes=True)
        _leaves_equal(tm.params, {**jax_bf16, "llm": q}, tm.cfg.vlm, bits)
        codes = jax.tree.map(lambda a: a.astype(jnp.int8) if a.dtype == jnp.int4 else a,
                             jm.params["llm"])
        _within_one_step(tm.params["llm"], codes, tm.cfg.vlm.llm, bits)
    # one call's tokens
    s = tm.cfg.vlm.vision[0].image_size
    req = _request(s, tm.cfg.vlm.llm.vocab_size)
    with _jax_env(bits):
        wout = jvla.predict_action_from_image(
            jparams, jm.cfg, jnp.asarray(req["image_u8"]), jm.image_cfg,
            **{k: jnp.asarray(v) for k, v in req.items() if k != "image_u8"},
            return_first_logits=True)
    tout = tvla.predict_action_from_image(
        tm.params, tm.cfg, torch.from_numpy(req["image_u8"]), tm.image_cfg,
        **{k: torch.from_numpy(v) for k, v in req.items() if k != "image_u8"},
        return_first_logits=True, device="cpu")
    gap = float(np.abs(_np(tout["first_logits"]) - _np(wout["first_logits"])).max())
    assert gap < BF16_GAP, gap
    # quantized trunks: the decode steps' activation codes may flip at a rounding
    # tie, so the later steps' gap is not the first logits': the rule takes the
    # stated bound of these tiers (tests/test_torch_multilora.py QUANT_GAP)
    got_t, want_t = tout["action_tokens"].numpy(), np.asarray(wout["action_tokens"])
    margins = np.asarray(wout["logit_margins"])
    n = assert_tokens(got_t[:, :1], want_t[:, :1], margins[:, :1], gap)   # the prefill's
    if bits is not None:
        assert_tokens(got_t, want_t, margins, QUANT_GAP)
    else:
        n = assert_tokens(got_t, want_t, margins, gap)
    assert n >= 1, n     # bf16 margins at tiny random weights sit near 2e-3
    return n


def test_native_run_dir_and_pt_path(tiny_run_dir, monkeypatch):  # noqa: F811
    run, _, _ = tiny_run_dir
    # load(): the bundle, the caller's tokenizer or None
    tb, jb = tload.load(run, device="cpu"), jload.load(run)
    assert tb["tokenizer"] is None and tb["cfg"] == convert.config_from_jax(jb["cfg"])
    assert tb["norm_stats"] == jb["norm_stats"]
    tok = Tok()
    assert tload.load(run, tokenizer=tok, device="cpu")["tokenizer"] is tok
    pt = run / "checkpoints" / "latest-checkpoint.pt"
    _held_to_jax(tload.load_vla(pt, tokenizer=Tok(), device="cpu"), jload.load_vla(pt))
    for fn, kw in ((tload.load_vla, dict(tokenizer=Tok(), device="cpu")), (jload.load_vla, {})):
        with pytest.raises(ValueError, match="checkpoints") as e:
            fn(run / "config.json", **kw)
    with pytest.raises(ValueError, match="pass tokenizer="):
        tload.load_vla(pt, device="cpu")


@pytest.mark.parametrize("bits", [8, 4, "mix", "nibble"])
def test_quantized_loads_match_jax(tiny_run_dir, bits):  # noqa: F811
    run, _, _ = tiny_run_dir
    pt = run / "checkpoints" / "latest-checkpoint.pt"
    # fp32 towers and activations (quantizing the fp32 trunk): the bf16 loads are
    # the other routes'
    tm = tload.load_vla(pt, quantize_int8=True, quantize_bits=bits, tokenizer=Tok(),
                        device="cpu", dtype=torch.float32)
    jm = jload.load_vla(pt, quantize_int8=True, quantize_bits=bits, dtype=jnp.float32)
    assert tm.cfg.tier == "turbo"
    _held_to_jax(tm, jm, bits, jax_bf16=jload.load(run, dtype=jnp.float32)["params"])
    # the port's codes: quantize_params of the port's own float load, bit for bit
    want = tlin.quantize_params(tload.load(run, device="cpu", dtype=torch.float32)["params"]["llm"],
                                bits=bits)
    for k, v in _flat(want).items():
        assert torch.equal(_flat(tm.params["llm"])[k], v), k
    with pytest.raises(ValueError) as te:
        tload.load_vla(pt, quantize_bits=bits if bits != 8 else 4, tokenizer=Tok(), device="cpu")
    with pytest.raises(ValueError) as je:
        jload.load_vla(pt, quantize_bits=bits if bits != 8 else 4)
    assert str(te.value) == str(je.value)


def test_registry_id_from_the_hub_cache(tiny_run_dir, tmp_path, monkeypatch):  # noqa: F811
    run, _, _ = tiny_run_dir
    reg_id = next(iter(jcat.MODEL_REGISTRY))
    hub_id = jcat.MODEL_REGISTRY[reg_id].get("model_id", reg_id)
    cache = _make_hub_cache(tmp_path, jload.HF_HUB_REPO, {
        f"{hub_id}/config.json": (run / "config.json").read_text(),
        f"{hub_id}/checkpoints/latest-checkpoint.pt":
            (run / "checkpoints" / "latest-checkpoint.pt").read_bytes(),
    })
    monkeypatch.setenv("OVLA_HUB_OFFLINE", "1")
    tb, jb = tload.load(reg_id, cache_dir=cache, device="cpu"), jload.load(reg_id, cache_dir=cache)
    w, g = _flat(jb["params"]), _flat(tb["params"])
    assert w.keys() == g.keys()
    for k in w:
        np.testing.assert_array_equal(_np(g[k]), _np(w[k]), err_msg=k)
    monkeypatch.delenv("OVLA_HUB_OFFLINE")     # the port reads the cache either way
    assert tload.load(reg_id, cache_dir=cache, device="cpu")["cfg"] == tb["cfg"]
    with pytest.raises(FileNotFoundError, match="is not in the local hub cache"):
        tload.load(reg_id, cache_dir=tmp_path / "empty", device="cpu")


def test_vla_run_id_step_discovery(tiny_run_dir, tmp_path, monkeypatch):  # noqa: F811
    run, _, _ = tiny_run_dir
    pt = (run / "checkpoints" / "latest-checkpoint.pt").read_bytes()
    cache = _make_hub_cache(tmp_path, jload.VLA_HF_HUB_REPO, {
        "pretrained/tiny-vla/config.json": (run / "config.json").read_text(),
        "pretrained/tiny-vla/dataset_statistics.json":
            (run / "dataset_statistics.json").read_text(),
        "pretrained/tiny-vla/checkpoints/step-000005-epoch-00-loss=0.5.pt": pt,
        "pretrained/tiny-vla/checkpoints/step-000010-epoch-00-loss=0.1.pt": pt,
    })
    monkeypatch.setenv("OVLA_HUB_OFFLINE", "1")
    tm = tload.load_vla("tiny-vla", cache_dir=cache, step_to_load=5, tokenizer=Tok(),
                        device="cpu")
    jm = jload.load_vla("tiny-vla", cache_dir=cache, step_to_load=5)
    _held_to_jax(tm, jm)
    assert "bridge_orig" in tload.load_vla("tiny-vla", cache_dir=cache, tokenizer=Tok(),
                                           device="cpu").norm_stats
    with pytest.raises(ValueError) as te:
        tload.load_vla("tiny-vla", cache_dir=cache, step_to_load=7, tokenizer=Tok(), device="cpu")
    with pytest.raises(ValueError) as je:
        jload.load_vla("tiny-vla", cache_dir=cache, step_to_load=7)
    assert str(te.value) == str(je.value) and "unique checkpoint" in str(te.value)


def test_released_policy_repo_written_by_the_port(tiny_run_dir, tmp_path, monkeypatch):  # noqa: F811
    """'openvla-7b' routes to its own HF-layout repo: the port writes the
    snapshot (sharded bf16 safetensors with the index, hf_export's config),
    and both loaders read it."""
    run, _, _ = tiny_run_dir
    tb = tload.load(run, device="cpu")
    cache = _make_hub_cache(tmp_path, "openvla/openvla-7b", {})
    snap = cache / "models--openvla--openvla-7b" / "snapshots" / ("0" * 40)
    snap.mkdir(parents=True, exist_ok=True)
    state = tcat.params_to_hf_state(tb["params"], tb["cfg"])
    out = sio.save_sharded(state, snap, max_shard_bytes=1 << 16, dtype=torch.bfloat16)
    assert len(out["files"]) > 1 and (snap / sio.INDEX_FILE).exists()
    stats = {"bridge_orig": {"action": {"q01": [-1.0] * 7, "q99": [1.0] * 7}}}
    texport.write_export_sidecars(snap, tb["cfg"], tb["image_cfg"], VIS_ID, LLM_ID, ARCH,
                                  "resize-naive", norm_stats=stats)
    monkeypatch.setenv("OVLA_HUB_OFFLINE", "1")
    tm = tload.load_vla("openvla-7b", cache_dir=cache, tokenizer=Tok(), device="cpu")
    jm = jload.load_vla("openvla-7b", cache_dir=cache)
    _held_to_jax(tm, jm)
    # the round trip through the port's writer keeps every bf16 leaf's bits
    for k, v in _flat(tm.params).items():
        assert torch.equal(v, _flat(tb["params"])[k]), k


def test_jitted_jax_quantize_rounds_differently():
    """Why the JAX load_vla's codes are held within one step, not bit for bit:
    it quantizes under jax.jit, where XLA turns the division by 127 into a
    multiplication by its reciprocal; its eager quantize_params divides, as the
    port does (ROADMAP Queue 3, "Division by 127")."""
    r = np.random.default_rng(0)
    w = jnp.asarray(r.normal(0, 0.02, (4, 64, 64)), jnp.bfloat16)
    eager = jlin.quantize_params({"q_proj": w})["q_proj"]
    jitted = jax.jit(lambda p: jlin.quantize_params(p))({"q_proj": w})["q_proj"]
    port = tlin.quantize_params({"q_proj": torch.from_numpy(
        np.asarray(w.astype(jnp.float32))).to(torch.bfloat16)})["q_proj"]
    assert (np.asarray(eager["s"]) != np.asarray(jitted["s"])).any()
    for k in ("q", "s"):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(eager[k]), err_msg=k)


def test_hf_export_sidecars_byte_equal(tmp_path):
    for jcfg_args in ((VIS_ID, LLM_ID), ("dinosiglip-vit-so-224px", "llama2-7b-pure")):
        jcfg, jimg, _ = jcat.build_vlm_config(*jcfg_args, ARCH, "letterbox")
        tcfg, timg, _ = tcat.build_vlm_config(*jcfg_args, ARCH, "letterbox")
        stats = {"bridge_orig": {"action": {"q01": [-1.0] * 7, "q99": [1.0] * 7}}}
        src = tmp_path / "tok"
        src.mkdir(exist_ok=True)
        (src / "tokenizer.model").write_bytes(b"\x00\x01sentencepiece")
        a, b = tmp_path / f"jax{jcfg_args[0]}", tmp_path / f"port{jcfg_args[0]}"
        jw = jexport.write_export_sidecars(a, jcfg, jimg, *jcfg_args, ARCH, "letterbox",
                                           norm_stats=stats, tokenizer_src=src)
        tw = texport.write_export_sidecars(b, tcfg, timg, *jcfg_args, ARCH, "letterbox",
                                           norm_stats=stats, tokenizer_src=src)
        assert jw == tw
        names = sorted(p.name for p in a.iterdir())
        assert names == sorted(p.name for p in b.iterdir())
        for n in names:
            assert (a / n).read_bytes() == (b / n).read_bytes(), n


# --- the copied modules -------------------------------------------------------------------


@pytest.mark.parametrize("rel", ["conf/__init__.py", "conf/registry.py", "conf/models.py",
                                 "conf/vla.py", "conf/datasets.py", "models/prompting.py",
                                 "models/hf_export.py", "models/model_registry.json",
                                 "overwatch/__init__.py"])
def test_copies_are_the_jax_files(rel):
    assert (TROOT / rel).read_bytes() == (JROOT / rel).read_bytes()


def test_norm_stats_differs_only_in_the_rank():
    want = (JROOT / "vla/norm_stats.py").read_text().replace(
        "statistics on every process; see parallel.distributed.is_primary)\n"
        "    from ..parallel.distributed import is_primary\n\n    if is_primary():",
        "statistics on every process): the torch.distributed rank, 0 without a group\n"
        "    from ..overwatch.overwatch import process_index\n\n    if process_index() == 0:")
    assert (TROOT / "vla/norm_stats.py").read_text() == want


def test_overwatch_ranks_without_a_group(tmp_path):
    from openvla_probe_tpu.overwatch import overwatch as jow
    from openvla_probe_tpu_torch.overwatch import initialize_overwatch, overwatch as tow
    from openvla_probe_tpu_torch.vla import norm_stats as tns
    from openvla_probe_tpu.vla import norm_stats as jns

    ow = initialize_overwatch("x")
    assert (ow.rank(), ow.world_size(), ow.is_rank_zero()) == (0, 1, True)
    assert ow.rank_zero_only(lambda: 5)() == 5
    public = lambda m: sorted(n for n in vars(m.Overwatch) if not n.startswith("__"))  # noqa: E731
    assert public(tow) == public(jow)
    assert "jax" not in (TROOT / "overwatch/overwatch.py").read_text()
    stats = {"d": {"action": {"q01": np.zeros(3, np.float32), "q99": np.ones(3, np.float32)}}}
    a = jns.save_dataset_statistics(stats, tmp_path / "a")
    b = tns.save_dataset_statistics(stats, tmp_path / "b")
    assert a.read_bytes() == b.read_bytes()
    assert json.dumps(jax.tree.map(np.ndarray.tolist, tns.load_dataset_statistics(b))) == \
        json.dumps(jax.tree.map(np.ndarray.tolist, jns.load_dataset_statistics(a)))
