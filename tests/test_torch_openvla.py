"""The port's `OpenVLA` wrapper against the JAX package's, on the CPU at tiny
size (the JAX serving tests' config: tiny Llama, DINOv2-like and SigLIP-like
tiny towers, prompt_pad_len 16, A = 5; here with OpenVLA's vocabulary, 32064
rows, so that the appended 29871 is a row of the embedding: the JAX gather
clamps an index past the table, the port's raises; both packages on the same
weights and the same word tokenizer).

* predict_action (one image and B images, one prompt) with and without
  return_hidden_states and return_first_logits; with a draft ([A], broadcast
  over the images) on a turbo-labelled config and on parity with
  speculative_in_parity="allow"; predict_action_batch with per-row prompts
  and per-row norm stats, padded to its bucket, against the JAX package's
  batch call and the port's own single calls. Tokens and n_accepted equal;
  actions within 1e-6; logits, margins and hidden_pooled within 1e-5 (fp32,
  the same sums in another order).
* The errors: the parity draft gate and its opt-in, return_first_logits with
  a draft, the unnorm-key errors, a prompt longer than the pad, every serving
  env knob (the JAX package's configs field for field and its ValueErrors
  word for word), env drift after construction, a JAX kernel-gate knob set
  at construction, and an adapter request with no banks installed.
"""

import contextlib
import dataclasses
import os
import zlib

import jax
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.models.llama import LlamaConfig
from openvla_probe_tpu.models.vit import ViTConfig
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.ops import image as timage

A = 5
TOL = 1e-5


@contextlib.contextmanager
def clean_ovla_env():
    """Every OVLA_* variable unset inside, restored after."""
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("OVLA_")]:
            mp.delenv(k)
        yield mp


@pytest.fixture(autouse=True)
def _ovla_env():
    with clean_ovla_env():
        yield


class Tok:
    """Word tokenizer: BOS, then one id per word (zlib.crc32, the same in
    every process)."""

    def encode(self, text):
        return [1] + [zlib.crc32(w.encode()) % 400 + 3 for w in text.split()]


VOCAB, CODEC_VOCAB = 32064, 32000


def _vlm_cfg():
    return jvlm.VLMConfig(
        llm=LlamaConfig.tiny(vocab_size=VOCAB),
        vision=(ViTConfig.tiny(num_register_tokens=4, no_embed_class=True), ViTConfig.tiny()),
        vision_names=("dino", "siglip"),
        arch_specifier="no-align+fused-gelu-mlp",
    )


def _img_cfg(m, s):
    return m.ImageTransformConfig(specs=(
        m.BackboneTransformSpec((s, s), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        m.BackboneTransformSpec((s, s), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    ))


STATS = {
    "a": {"action": {"q01": -np.ones(A, np.float32), "q99": np.ones(A, np.float32)}},
    "b": {"action": {"q01": np.zeros(A, np.float32), "q99": 2 * np.ones(A, np.float32),
                     "mask": np.array([True] * (A - 1) + [False])}},
}


@pytest.fixture(scope="module")
def parts():
    with clean_ovla_env():
        cfg = _vlm_cfg()
        serving = jvla.VLAServingConfig(vlm=cfg, action_dim=A, prompt_pad_len=16,
                                        codec_vocab_size=CODEC_VOCAB)
        params = jvlm.init_params(cfg, jax.random.key(0))
        tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                          convert.config_from_jax(cfg), device="cpu")
        s = cfg.vision[0].image_size
        imgs = np.random.default_rng(0).integers(0, 256, (4, s + 10, s + 10, 3), dtype=np.uint8)
        return serving, params, tparams, s, imgs


def _pair(parts, serving=None, stats=STATS):
    """(JAX OpenVLA, port OpenVLA) over the same weights."""
    base, params, tparams, s, _ = parts
    serving = serving or base
    jm = jvla.OpenVLA(params, serving, Tok(), stats, _img_cfg(jimage, s))
    tm = tvla.OpenVLA(tparams, convert.config_from_jax(serving), Tok(), stats,
                      _img_cfg(timage, s), device="cpu")
    return jm, tm


def _same(got, want, keys=None):
    assert set(got) == set(want), (set(got), set(want))
    for k in keys or want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k in ("action_tokens", "n_accepted", "normalized_actions"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=k)


PROMPT = "In: What action should the robot take to pick up the mug?\nOut:"


@pytest.mark.parametrize("hidden,first", [(False, False), (True, False), (False, True),
                                          (True, True)])
@pytest.mark.parametrize("batched", [False, True], ids=["one_image", "three_images"])
def test_predict_action_matches_jax(parts, hidden, first, batched):
    jm, tm = _pair(parts)
    img = parts[4][:3] if batched else parts[4][0]
    kw = dict(unnorm_key="b", return_hidden_states=hidden, return_first_logits=first)
    want, got = jm.predict_action(img, PROMPT, **kw), tm.predict_action(img, PROMPT, **kw)
    _same(got, want)
    assert got["action_tokens"].shape == ((3, A) if batched else (A,))
    assert isinstance(got["actions"], np.ndarray)


@pytest.mark.parametrize("draft_kind", ["correct", "wrong"])
@pytest.mark.parametrize("label", ["turbo", "parity_allow"])
def test_predict_action_with_a_draft_matches_jax(parts, draft_kind, label):
    serving = (dataclasses.replace(parts[0], tier="turbo") if label == "turbo" else
               dataclasses.replace(parts[0], speculative_in_parity="allow"))
    jm, tm = _pair(parts, serving)
    imgs = parts[4][:3]
    base = tm.predict_action(imgs[0], PROMPT, unnorm_key="a")["action_tokens"]
    draft = base if draft_kind == "correct" else (base + 1) % CODEC_VOCAB
    kw = dict(unnorm_key="a", draft_tokens=draft, return_hidden_states=True)
    want, got = jm.predict_action(imgs, PROMPT, **kw), tm.predict_action(imgs, PROMPT, **kw)
    _same(got, want)
    assert got["n_accepted"].shape == (3,)
    if draft_kind == "wrong":
        np.testing.assert_array_equal(got["n_accepted"], [0, 0, 0])
    one = tm.predict_action(imgs[0], PROMPT, unnorm_key="a", draft_tokens=draft)
    np.testing.assert_array_equal(one["action_tokens"], got["action_tokens"][0])
    assert one["n_accepted"].shape == ()


def test_predict_action_batch_matches_jax_and_single_calls(parts):
    jm, tm = _pair(parts)
    imgs = parts[4][:3]
    prompts = ["pick up the fork", "close the drawer now please", "push the plate left"]
    keys = ["a", "b", "a"]
    want = jm.predict_action_batch(imgs, prompts, keys)
    got = tm.predict_action_batch(imgs, prompts, keys)       # bucket 4: row 0 repeated
    assert len(got) == 3
    for i in range(3):
        _same(got[i], want[i])
        single = tm.predict_action(imgs[i], prompts[i], unnorm_key=keys[i])
        np.testing.assert_array_equal(got[i]["action_tokens"], single["action_tokens"])
        np.testing.assert_allclose(got[i]["actions"], single["actions"], atol=1e-6)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        tm.predict_action_batch(imgs, prompts, keys, batch_buckets=(1, 2))


# --- the errors -------------------------------------------------------------------------------


def test_parity_draft_gate_and_opt_in(parts):
    _, tm = _pair(parts)
    draft = np.zeros(A, np.int32)
    with pytest.raises(ValueError, match="turbo-tier feature"):
        tm.predict_action(parts[4][0], PROMPT, unnorm_key="a", draft_tokens=draft)
    _, allowed = _pair(parts, dataclasses.replace(parts[0], speculative_in_parity="allow"))
    out = allowed.predict_action(parts[4][0], PROMPT, unnorm_key="a", draft_tokens=draft)
    assert out["n_accepted"].shape == ()
    with pytest.raises(ValueError, match="speculative_in_parity"):
        tvla.VLAServingConfig(vlm=allowed.cfg.vlm, speculative_in_parity="maybe")


def test_first_logits_with_a_draft_raises(parts):
    _, tm = _pair(parts, dataclasses.replace(parts[0], tier="turbo"))
    with pytest.raises(ValueError, match="return_first_logits is not supported"):
        tm.predict_action(parts[4][0], PROMPT, unnorm_key="a", draft_tokens=np.zeros(A),
                          return_first_logits=True)


def test_unnorm_key_errors(parts):
    jm, tm = _pair(parts)
    for m in (jm, tm):
        with pytest.raises(ValueError, match="more than one dataset"):
            m.predict_action(parts[4][0], PROMPT)
        with pytest.raises(ValueError, match="not in `norm_stats`"):
            m.get_action_stats("nope")
    assert tm.get_action_dim("b") == jm.get_action_dim("b") == A
    _, single = _pair(parts, stats={"only": STATS["a"]})
    assert single._check_unnorm_key(None) == "only"
    np.testing.assert_array_equal(single.get_action_stats()["q99"], STATS["a"]["action"]["q99"])


def test_prepare_ids_and_a_prompt_too_long(parts):
    jm, tm = _pair(parts)
    for text in ("go", "go ▁"):
        ids, n = tm.prepare_ids(text)
        jids, jn = jm.prepare_ids(text)
        np.testing.assert_array_equal(ids, jids)
        assert n == jn and ids[n - 1] == tvla.EMPTY_TOKEN_ID and ids.dtype == np.int32
    with pytest.raises(ValueError, match="exceeds pad bucket 16"):
        tm.prepare_ids(" ".join(["word"] * 15))
    tok = type("T", (), {"encode": lambda self, t: [1, 5, tvla.EMPTY_TOKEN_ID]})()
    tm.tokenizer = tok
    assert tm.prepare_ids("x")[1] == 3          # no second 29871


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__, str(e))


TIER_OF = {"parity": "parity", "turbo": "turbo", "pallas": "pallas",
           "pallas_kv8": "pallas_kv8"}


@pytest.mark.parametrize("env", [
    {"OVLA_STACKED_KV8": "1"},
    {"OVLA_STACKED_KV8": "1", "OVLA_KV_INT8": "1"},
    {"OVLA_STACKED_KV8": "1", "OVLA_LEGACY_DECODE": "0"},
    {"OVLA_LEGACY_DECODE": "1"},
    {"OVLA_LEGACY_DECODE": "0"},
    {"OVLA_KV_INT8": "1"},
    {"OVLA_KV_INT8": "1", "OVLA_LEGACY_DECODE": "1"},
    {"OVLA_KV_INT8": "1", "OVLA_SPLIT_PREFILL": "1"},
    {"OVLA_SPLIT_PREFILL": "1"},
    {"OVLA_FLAT_CACHE": "1"},
    {"OVLA_DECODE_UNROLL": "0"},
], ids=lambda e: "+".join(f"{k[5:]}={v}" for k, v in e.items()))
@pytest.mark.parametrize("tier", list(TIER_OF))
def test_env_overrides_act_as_in_jax(tier, env, monkeypatch):
    """Where the JAX package gives a config, the port gives the same fields
    (every tier, decode and option now runs in the port: turbo_kv8,
    split_prefill and flat_cache included); where its knobs conflict or its
    validation rejects the result, the port raises the same ValueError word
    for word."""
    base = jvlm.VLMConfig.tiny()
    jcfg = jvla.VLAServingConfig.for_tier(base, tier)
    tcfg = convert.config_from_jax(jcfg)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = _outcome(jcfg.with_env_overrides)
    got = _outcome(tcfg.with_env_overrides)
    if want[0] == "ValueError":   # a conflict of knobs, or the JAX package's validation
        assert got == want
        return
    assert want[0] == "ok" and got[0] == "ok", (want, got)
    fields = [(c.tier, c.decode_impl, c.split_prefill, c.flat_cache, c.kv_int8, c.decode_unroll)
              for c in (want[1], got[1])]
    assert fields[1] == fields[0]
    assert got[1].vlm == tcfg.vlm


def test_the_wrapper_applies_the_overrides_once(parts, monkeypatch):
    monkeypatch.setenv("OVLA_DECODE_UNROLL", "0")
    _, tm = _pair(parts)
    assert tm.cfg.decode_unroll is False
    monkeypatch.setenv("OVLA_STACKED_KV8", "1")
    with pytest.raises(RuntimeError, match="env knobs changed.*OVLA_STACKED_KV8='1'"):
        tm.predict_action(parts[4][0], PROMPT, unnorm_key="a")
    monkeypatch.setenv("OVLA_STACKED_KV8", "0")
    monkeypatch.delenv("OVLA_DECODE_UNROLL")
    monkeypatch.setenv("OVLA_STACKED_KV8", "1")
    tm2 = tvla.OpenVLA(parts[2], convert.config_from_jax(parts[0]), Tok(), STATS,
                       _img_cfg(timage, parts[3]), device="cpu")
    assert (tm2.cfg.tier, tm2.cfg.decode_impl) == ("pallas_kv8", "stacked_kv8")


@pytest.mark.parametrize("knob", ["OVLA_KV_INT8", "OVLA_PALLAS_INTERPRET", "OVLA_PALLAS_ATTN",
                                  "OVLA_FLASH_ONESHOT"])
def test_env_drift_after_construction_raises(parts, knob, monkeypatch):
    _, tm = _pair(parts)
    tm.predict_action(parts[4][0], PROMPT, unnorm_key="a")
    monkeypatch.setenv(knob, "1")
    with pytest.raises(RuntimeError, match=f"env knobs changed after model construction: {knob}"):
        tm.predict_action(parts[4][0], PROMPT, unnorm_key="a")
    with pytest.raises(RuntimeError, match="env knobs changed"):
        tm.predict_action_batch(parts[4][:1], [PROMPT], ["a"])


@pytest.mark.parametrize("knob,field", [
    ("OVLA_PALLAS", "for_tier"), ("OVLA_PALLAS_MATMUL", "int8_matmul"),
    ("OVLA_PALLAS_ATTN", "LlamaConfig.flash_attn"), ("OVLA_PALLAS_DECODE", "decode_impl"),
    ("OVLA_PALLAS_VITMLP", "ViTConfig.int8_matmul"), ("OVLA_PALLAS_VITATTN", "ViTConfig.flash_attn"),
    ("OVLA_PALLAS_RMSQ", "fused_rmsq"), ("OVLA_PALLAS_W4A8", "bits=4"),
    ("OVLA_W8A8", "int8_matmul"), ("OVLA_W4A8", "NIB_HI_M_MAX"),
    ("OVLA_W4A8_GROUP_M_MAX", "NIB_HI_M_MAX"), ("OVLA_VITMLP_BM", "their own tiles"),
    ("OVLA_FLASH_ONESHOT", "ONESHOT_MAX_TK"), ("OVLA_PALLAS_SOMETHING_NEW", "a config field"),
])
@pytest.mark.parametrize("value", ["0", "1"])
def test_a_kernel_gate_knob_raises_at_construction(parts, knob, field, value, monkeypatch):
    """Set to any value, a JAX kernel gate would be a silent no-op in the port."""
    monkeypatch.setenv(knob, value)
    with pytest.raises(ValueError, match=f"unset {knob} \\(replaced by [^)]*{field}"):
        _pair(parts)


def test_the_interpret_knob_is_not_read(parts, monkeypatch):
    monkeypatch.setenv("OVLA_PALLAS_INTERPRET", "1")
    _, tm = _pair(parts)
    assert "OVLA_PALLAS_INTERPRET" not in tvla.KERNEL_GATE_FIELDS
    assert tm.predict_action(parts[4][0], PROMPT, unnorm_key="a")["action_tokens"].shape == (A,)


def test_multi_lora_raises_naming_item_11(parts):
    """Multi-LoRA is ported (tests/test_torch_multilora.py): without banks an
    adapter request raises the JAX package's error, in both entries."""
    jm, tm = _pair(parts)
    for m in (tm, jm):
        with pytest.raises(ValueError, match="no adapter banks installed; call set_adapters"):
            m.predict_action(parts[4][0], PROMPT, unnorm_key="a", adapter="x")
        with pytest.raises(ValueError, match="no adapter banks installed; call set_adapters"):
            m.predict_action_batch(parts[4][:1], [PROMPT], ["a"], adapters=["x"])
    assert tm.n_adapters == 0 and tm.adapter_names == [] and tm.lora_bank is None


def test_the_wrapper_defaults_to_the_card(parts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvla.OpenVLA(parts[2], convert.config_from_jax(parts[0]), Tok(), STATS)


def test_config_from_jax_carries_the_new_fields():
    j = jvla.VLAServingConfig(vlm=jvlm.VLMConfig.tiny(), speculative_in_parity="allow",
                              decode_unroll=False)
    t = convert.config_from_jax(j)
    assert (t.speculative_in_parity, t.decode_unroll) == ("allow", False)
    assert tvla._serving_env_snapshot()[0][0] == "OVLA_LEGACY_DECODE"
    assert [k for k, _ in tvla._serving_env_snapshot()] == [k for k, _ in
                                                           jvla._serving_env_snapshot()]
