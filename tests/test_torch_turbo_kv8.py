"""The port's `turbo_kv8` tier (turbo's routes, the frozen-KV split decode
over the prefill K/V quantized to int8) and the stacked decode's
`split_prefill` and `flat_cache` options vs the JAX package, on the CPU at
tiny sizes, with inputs made from seeded numpy generators.

The JAX side runs in `tests.test_torch_turbo.jax_turbo` (OVLA_PALLAS=1 in
interpret mode with the int8 matmul and tower kernels off and the fused
RMSNorm -> int8 kernel on); its ``_split_attention_i8`` is XLA either way.

* ``quantize_prefill_kv``: codes and scales bit for bit, bf16 and fp32 K/V.
* ``split_attention_i8_plain`` vs ``_split_attention_i8`` at n_rep 1 and 2,
  scores in fp32 and bf16, q in fp32 and bf16, masked prefill and decode
  slots: the q codes and the int32 q·K bit for bit; outputs within 1e-6
  (fp32 q: the softmax's fp32 sums in another order; found 1.8e-7) or within
  one bf16 step, 2^-7 relative (bf16 q: the same fp32 sums, then one rounding
  to bf16; found at most one element in 128 one step apart).
* The trunk's decode over a `PrefillKVQ`: from the same int8 K/V (the JAX
  package's, converted), `decode_step`'s hidden state within 2e-2 of the JAX
  one (the one-bf16-step RoPE differences move activation codes at rounding
  ties, as on every activation-quantizing tier: ROADMAP Queue 3) and
  `greedy_decode`'s tokens equal where the margins allow (`assert_tokens`).
* End to end, `predict_action_from_image` on `for_tier(..., "turbo_kv8")`:
  first logits and margins within 2e-2, action tokens equal where the
  margins allow: a row is compared up to its first token whose JAX margin is
  below twice the largest first-logit gap seen (past it, a hairline token may
  take the other value and every later token follows it). At the seed below
  (found: first-logit gap 5.7e-3, margins 4.7e-3 to 1.1) 17 of the 21 tokens
  are compared, and all 21 are equal.
* ``with_env_overrides`` under OVLA_KV_INT8, OVLA_SPLIT_PREFILL and
  OVLA_FLAT_CACHE (with OVLA_LEGACY_DECODE and OVLA_DECODE_UNROLL) gives the
  JAX package's configs field for field, or its ValueError word for word
  (mirrors tests/test_serving_tiers.py::test_env_overrides).
* ``split_prefill`` and ``flat_cache`` give the plain stacked decode's tokens
  (and taps, and actions) exactly on the parity and turbo tiers, and the JAX
  package's tokens (mirrors tests/test_decode_fastpath.py::
  test_split_prefill_matches_carry and ::test_flat_cache_matches_default).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.models import vlm as tvlm
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import decode_attention as tda
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin

from tests.test_torch_openvla import _ovla_env, clean_ovla_env  # noqa: F401 (autouse)
from tests.test_torch_pallas_tier import _img_cfg
from tests.test_torch_probe_taps import _inputs, _Parity
from tests.test_torch_turbo import jax_turbo

VOCAB = 512
A = 7
P = 64            # T = 68 >= 64: the prefill flash gate engages in both packages
ATOL = 2e-2       # logits, margins, hidden states (module docstring)
SEED = 5
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(x, dtype=None):
    """A JAX array -> a torch tensor (bf16 through fp32, exact)."""
    a = np.asarray(jnp.asarray(x).astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def assert_tokens(got, want, want_margins, gap: float) -> int:
    """Tokens equal where the margins allow (module docstring): each row up to
    its first token whose JAX margin is below 2 · gap. Returns how many
    tokens were compared."""
    n = 0
    for b in range(want.shape[0]):
        for t in range(want.shape[1]):
            if want_margins[b, t] < 2 * gap:
                break
            assert got[b, t] == want[b, t], (b, t, got[b], want[b], want_margins[b])
            n += 1
    return n


# --- quantize_prefill_kv ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_prefill_kv_bit_identical(dtype):
    r = np.random.default_rng(1)
    k = jnp.asarray(r.normal(size=(2, 3, 9, 2, 16)), JNP_DT[dtype])
    v = jnp.asarray(r.normal(size=(2, 3, 9, 2, 16)) * 3, JNP_DT[dtype])
    v = v.at[0, 1, 4].set(0.0)                     # a zero row: the 1e-8 floor
    want = jllama.quantize_prefill_kv(jllama.PrefillKV(k, v))
    got = tllama.quantize_prefill_kv(tllama.PrefillKV(_t(k, TORCH_DT[dtype]),
                                                      _t(v, TORCH_DT[dtype])))
    for name in ("k", "v", "ks", "vs"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == (torch.int8 if name in ("k", "v") else torch.float32), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


# --- the int8 split attention -------------------------------------------------------


def _split_case(seed, n_rep, dtype):
    r = np.random.default_rng(seed)
    B, T, Ad, Hkv, Dh = 2, 20, 3, 2, 16
    H = Hkv * n_rep
    q = jnp.asarray(r.normal(size=(B, 1, H, Dh)), JNP_DT[dtype])
    k = jnp.asarray(r.normal(size=(1, B, T, Hkv, Dh)), JNP_DT[dtype])
    v = jnp.asarray(r.normal(size=(1, B, T, Hkv, Dh)), JNP_DT[dtype])
    kd = jnp.asarray(r.normal(size=(B, Ad, Hkv, Dh)), JNP_DT[dtype])
    vd = jnp.asarray(r.normal(size=(B, Ad, Hkv, Dh)), JNP_DT[dtype])
    pre = np.ones((B, T), np.int32)
    pre[1, 14:] = 0
    dec = np.array([[1, 1, 0]] * B, np.int32)
    kvq = jllama.quantize_prefill_kv(jllama.PrefillKV(k, v))
    return q, kvq, kd, vd, pre, dec


@pytest.mark.parametrize("scores", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rep", [1, 2])
def test_split_attention_i8_plain_matches_jax(n_rep, dtype, scores):
    q, kvq, kd, vd, pre, dec = _split_case(7 + n_rep, n_rep, dtype)
    neg = jllama.NEG_INF
    add_pre = jnp.where(jnp.asarray(pre) > 0, 0.0, neg)[:, None, None, :].astype(jnp.float32)
    add_dec = jnp.where(jnp.asarray(dec) > 0, 0.0, neg)[:, None, None, :].astype(jnp.float32)
    want = jllama._split_attention_i8(q, kvq.k[0], kvq.ks[0], kvq.v[0], kvq.vs[0], kd, vd,
                                      add_pre, add_dec, JNP_DT[scores])
    tdt = TORCH_DT[dtype]
    got = tda.split_attention_i8_plain(
        _t(q, tdt), _t(kvq.k[0]), _t(kvq.ks[0]), _t(kvq.v[0]), _t(kvq.vs[0]), _t(kd, tdt),
        _t(vd, tdt), torch.from_numpy(pre), torch.from_numpy(dec), TORCH_DT[scores])
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("n_rep", [1, 2])
def test_split_attention_i8_int_dots_exact(n_rep):
    """The q codes (JAX's formula, as _split_attention_i8 writes it) and the
    int32 q·Kp of the plain version's float64 einsum are the JAX int32 ones."""
    q, kvq, *_ = _split_case(3, n_rep, "bfloat16")
    qf = q.astype(jnp.float32)
    sq = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1), 1e-8) / 127.0
    qi = jnp.clip(jnp.round(qf / sq[..., None]), -127, 127).astype(jnp.int8)
    kq = jllama._repeat_kv(kvq.k[0], n_rep)
    want = np.asarray(jnp.einsum("bthd,bshd->bhts", qi, kq, preferred_element_type=jnp.int32))
    tq = _t(q, torch.bfloat16)[:, 0].float()
    tsq = tlin.div127(torch.clamp(tq.abs().amax(-1), min=1e-8))
    tqi = torch.clamp(torch.round(tq / tsq[..., None]), -127, 127)
    np.testing.assert_array_equal(tqi.numpy(), np.asarray(qi[:, 0]).astype(np.float32))
    tk = tda._repeat_heads(_t(kvq.k[0]), n_rep)
    got = torch.einsum("bhd,bshd->bhs", tqi.double(), tk.double())
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want[:, :, 0].astype(np.int64))


def test_split_attention_i8_wrapper_on_cpu_is_the_plain_version():
    q, kvq, kd, vd, pre, dec = _split_case(4, 2, "bfloat16")
    args = (_t(q, torch.bfloat16), _t(kvq.k[0]), _t(kvq.ks[0]), _t(kvq.v[0]), _t(kvq.vs[0]),
            _t(kd, torch.bfloat16), _t(vd, torch.bfloat16), torch.from_numpy(pre),
            torch.from_numpy(dec), torch.bfloat16)
    _build.reset_launch_counts()
    assert torch.equal(tda.split_attention_i8(*args), tda.split_attention_i8_plain(*args))
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}
    stats = tda.compare_split_attention_i8(tda.split_attention_i8_plain(*args), *args[:-1],
                                           torch.bfloat16)
    assert stats["max_abs_err"] == 0.0


# --- the tier ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    return make_models(SEED)


def make_models(seed):
    with clean_ovla_env():
        base = jvlm.VLMConfig.tiny()
        serving = jvla.VLAServingConfig.for_tier(base, "turbo_kv8", action_dim=A,
                                                 prompt_pad_len=P, codec_vocab_size=VOCAB)
        params = jlin.quantize_params(jvlm.init_params(serving.vlm, jax.random.key(seed)),
                                      suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=8)
        tserving = convert.config_from_jax(serving)
        tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tserving.vlm,
                                          device="cpu", quant_suffixes=tlin.TURBO_QUANT_SUFFIXES,
                                          bits=8)
    return serving, params, tserving, tparams


def test_for_tier_matches_jax(models):
    serving, _, tserving, _ = models
    t = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "turbo_kv8", action_dim=A,
                                       prompt_pad_len=P, codec_vocab_size=VOCAB)
    assert t == tserving
    assert (t.tier, t.decode_impl, t.kv_int8) == (serving.tier, serving.decode_impl, True)
    assert (t.vlm.llm.int8_matmul, t.vlm.llm.fused_rmsq) == ("w8a8", True)
    assert t.vlm == tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "turbo").vlm


@pytest.fixture(scope="module")
def both(models):
    return run_both(models)


def run_both(models):
    serving, params, tserving, tparams = models
    img, ids, plen, q01, q99, mask = _inputs(VOCAB)
    with clean_ovla_env(), jax_turbo():
        want = jvla.predict_action_from_image(
            params, serving, jnp.asarray(img), _img_cfg(jimage), jnp.asarray(ids),
            jnp.asarray(plen), jnp.asarray(q01), jnp.asarray(q99), jnp.asarray(mask),
            return_first_logits=True)
        want = jax.tree.map(np.asarray, want)
    spied = []
    real = tda.split_attention_i8
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tllama, "split_attention_i8", lambda *a: spied.append(a[1].shape) or real(*a))
        got = tvla.predict_action_from_image(
            tparams, tserving, img, _img_cfg(timage), ids, plen, q01, q99, mask,
            return_first_logits=True, device="cpu")
    return want, {k: v.numpy() for k, v in got.items()}, spied


def test_turbo_kv8_tokens_match_jax(both, models):
    want, got, spied = both
    L = models[2].vlm.llm.num_hidden_layers
    assert len(spied) == L * (A - 1)                 # every decode layer on the int8 attention
    gap = np.abs(got["first_logits"] - want["first_logits"]).max()
    assert len(np.unique(want["action_tokens"])) > 1
    n = assert_tokens(got["action_tokens"], want["action_tokens"], want["logit_margins"], gap)
    assert n >= 17, n                                # at this seed (module docstring)


@pytest.mark.parametrize("key", ["first_logits", "logit_margins"])
def test_turbo_kv8_logits_and_margins_close(both, key):
    want, got, _ = both
    np.testing.assert_allclose(got[key], want[key], atol=ATOL)


def test_turbo_kv8_decode_over_the_same_int8_kv(models):
    """The trunk's decode alone, both packages from the JAX package's
    PrefillKVQ: decode_step's hidden state and greedy_decode's tokens."""
    serving, params, tserving, tparams = models
    jcfg, tcfg = serving.vlm.llm, tserving.vlm.llm
    B, T = 2, 68
    r = np.random.default_rng(11)
    x = r.normal(size=(B, T, jcfg.hidden_size)).astype(np.float32)
    am = np.ones((B, T), np.int32)
    am[1, T - 9:] = 0
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    mm_len = am.sum(1).astype(np.int32)
    first = np.array([3, 77], np.int32)
    with clean_ovla_env(), jax_turbo():
        kvq = jllama.quantize_prefill_kv(jllama.prefill(
            params["llm"], jcfg, jnp.asarray(x), jnp.asarray(am), jnp.asarray(pos))["kv"])
        e = jllama.embed_tokens(params["llm"], jnp.asarray(first)[:, None])
        dk = jnp.zeros((jcfg.num_hidden_layers, B, 4, jcfg.num_key_value_heads, jcfg.head_dim),
                       jcfg.dtype)
        jh, _, _ = jllama.decode_step(params["llm"], jcfg, e, jnp.asarray(mm_len)[:, None], kvq,
                                      jnp.asarray(am), dk, dk, jnp.int32(0))
        jtoks, jmargins = jllama.greedy_decode(params["llm"], jcfg, kvq, jnp.asarray(am),
                                               jnp.asarray(first), jnp.asarray(mm_len), 4)
    tkv = tllama.PrefillKVQ(*(_t(t) for t in kvq))
    te = tllama.embed_tokens(tparams["llm"], torch.from_numpy(first).long()[:, None])
    tdk = torch.zeros(tuple(dk.shape), dtype=tcfg.dtype)
    th = tllama.decode_step(tparams["llm"], tcfg, te, torch.from_numpy(mm_len).long()[:, None],
                            tkv, torch.from_numpy(am), tdk, tdk.clone(), 0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    ttoks, tmargins = tllama.greedy_decode(tparams["llm"], tcfg, tkv, torch.from_numpy(am),
                                           torch.from_numpy(first).long(),
                                           torch.from_numpy(mm_len).long(), 4)
    np.testing.assert_allclose(tmargins.numpy(), np.asarray(jmargins), atol=ATOL)
    gap = np.abs(tmargins.numpy() - np.asarray(jmargins)).max()
    assert assert_tokens(ttoks.numpy(), np.asarray(jtoks), np.asarray(jmargins), max(gap, 1e-3)) > 0


# --- the env knobs -------------------------------------------------------------------


def _outcome(fn):
    try:
        c = fn()
    except ValueError as e:
        return ("ValueError", str(e))
    return ("ok", (c.tier, c.decode_impl, c.split_prefill, c.flat_cache, c.kv_int8,
                   c.decode_unroll))


@pytest.mark.parametrize("env", [
    {"OVLA_KV_INT8": "1"},
    {"OVLA_KV_INT8": "1", "OVLA_LEGACY_DECODE": "1"},
    {"OVLA_KV_INT8": "1", "OVLA_LEGACY_DECODE": "0"},
    {"OVLA_KV_INT8": "1", "OVLA_SPLIT_PREFILL": "1"},
    {"OVLA_KV_INT8": "1", "OVLA_FLAT_CACHE": "1"},
    {"OVLA_SPLIT_PREFILL": "1"},
    {"OVLA_SPLIT_PREFILL": "1", "OVLA_DECODE_UNROLL": "0"},
    {"OVLA_SPLIT_PREFILL": "1", "OVLA_FLAT_CACHE": "1"},
    {"OVLA_FLAT_CACHE": "1"},
    {"OVLA_FLAT_CACHE": "1", "OVLA_LEGACY_DECODE": "0"},
    {"OVLA_LEGACY_DECODE": "1"},
], ids=lambda e: "+".join(f"{k[5:]}={v}" for k, v in e.items()))
@pytest.mark.parametrize("tier", ["parity", "turbo", "turbo_kv8", "pallas"])
def test_env_overrides_match_jax(tier, env):
    with clean_ovla_env(), pytest.MonkeyPatch.context() as mp:
        jcfg = jvla.VLAServingConfig.for_tier(jvlm.VLMConfig.tiny(), tier)
        tcfg = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), tier)
        for k, v in env.items():
            mp.setenv(k, v)
        want, got = _outcome(jcfg.with_env_overrides), _outcome(tcfg.with_env_overrides)
    assert got == want


def test_env_overrides_walkthrough(monkeypatch):
    """tests/test_serving_tiers.py::test_env_overrides on the port's config."""
    with clean_ovla_env():
        base = tvla.VLAServingConfig(vlm=tvlm.VLMConfig.tiny())
        monkeypatch.setenv("OVLA_LEGACY_DECODE", "0")
        assert base.with_env_overrides().decode_impl == "frozen_kv"
        monkeypatch.setenv("OVLA_KV_INT8", "1")
        monkeypatch.delenv("OVLA_LEGACY_DECODE")
        with pytest.raises(ValueError, match="parity config"):
            base.with_env_overrides()
        turbo = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "turbo")
        c = turbo.with_env_overrides()
        assert c.kv_int8 and c.decode_impl == "frozen_kv" and c.tier == "turbo_kv8"
        monkeypatch.setenv("OVLA_LEGACY_DECODE", "1")
        with pytest.raises(ValueError, match="OVLA_KV_INT8"):
            base.with_env_overrides()
        monkeypatch.delenv("OVLA_LEGACY_DECODE")
        monkeypatch.setenv("OVLA_SPLIT_PREFILL", "1")
        with pytest.raises(ValueError, match="conflicts"):
            base.with_env_overrides()
        monkeypatch.delenv("OVLA_KV_INT8")
        monkeypatch.setenv("OVLA_DECODE_UNROLL", "0")
        c = base.with_env_overrides()
        assert c.decode_unroll is False and c.split_prefill is True
        monkeypatch.delenv("OVLA_SPLIT_PREFILL")
        monkeypatch.delenv("OVLA_DECODE_UNROLL")
        monkeypatch.setenv("OVLA_LEGACY_DECODE", "1")
        kv8 = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "turbo_kv8")
        c = kv8.with_env_overrides()
        assert c.decode_impl == "stacked" and not c.kv_int8 and c.tier == "turbo"


# --- split_prefill and flat_cache ------------------------------------------------------


@pytest.fixture(scope="module")
def stacked_runs():
    """tier -> (JAX tokens, the port's results: plain, split_prefill, flat_cache)."""
    cache = {}

    def run(tier):
        if tier in cache:
            return cache[tier]
        with clean_ovla_env():
            serving = jvla.VLAServingConfig.for_tier(jvlm.VLMConfig.tiny(), tier, action_dim=A,
                                                     prompt_pad_len=P, codec_vocab_size=VOCAB)
            params = jvlm.init_params(serving.vlm, jax.random.key(3))
            bits = 8 if tier == "turbo" else None
            if bits:
                params = jlin.quantize_params(params, suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=8)
            tserving = convert.config_from_jax(serving)
            qkw = dict(quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits=8) if bits else {}
            tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tserving.vlm,
                                              device="cpu", **qkw)
            img, ids, plen, q01, q99, mask = _inputs(VOCAB)
            jout = {}
            for opt in ("plain", "split_prefill", "flat_cache"):
                jcfg = serving if opt == "plain" else dataclasses.replace(serving, **{opt: True})
                ctx = jax_turbo() if tier == "turbo" else _Parity()
                with ctx:
                    jout[opt] = np.asarray(jvla.predict_action_from_image(
                        params, jcfg, jnp.asarray(img), _img_cfg(jimage), jnp.asarray(ids),
                        jnp.asarray(plen), jnp.asarray(q01), jnp.asarray(q99),
                        jnp.asarray(mask))["action_tokens"])
            tout = {}
            for opt in ("plain", "split_prefill", "flat_cache"):
                tcfg = tserving if opt == "plain" else dataclasses.replace(tserving, **{opt: True})
                out = tvla.predict_action_from_image(
                    tparams, tcfg, img, _img_cfg(timage), ids, plen, q01, q99, mask,
                    collect_hidden_states=True, return_first_logits=True, device="cpu")
                tout[opt] = {k: v.numpy() for k, v in out.items()}
        cache[tier] = (jout, tout)
        return cache[tier]

    return run


@pytest.mark.parametrize("opt", ["split_prefill", "flat_cache"])
@pytest.mark.parametrize("tier", ["parity", "turbo"])
def test_stacked_options_token_identical(stacked_runs, tier, opt):
    jout, tout = stacked_runs(tier)
    plain, other = tout["plain"], tout[opt]
    np.testing.assert_array_equal(other["action_tokens"], plain["action_tokens"])
    np.testing.assert_array_equal(other["actions"], plain["actions"])
    np.testing.assert_allclose(other["hidden_pooled"], plain["hidden_pooled"], atol=1e-5)
    np.testing.assert_array_equal(jout[opt], jout["plain"])      # the JAX package's promise too


@pytest.mark.parametrize("tier", ["parity", "turbo"])
def test_stacked_options_match_jax_tokens(stacked_runs, tier):
    jout, tout = stacked_runs(tier)
    gap = 1e-3 if tier == "parity" else ATOL / 2
    for opt in ("split_prefill", "flat_cache"):
        assert assert_tokens(tout[opt]["action_tokens"], jout[opt],
                             tout[opt]["logit_margins"], gap) > 0


def test_flat_cache_is_a_view_of_the_same_bytes():
    cfg = tllama.LlamaConfig.tiny()
    c = tllama.KVCache.zeros_flat(cfg, 2, 16)
    assert tuple(c.k.shape) == (cfg.num_hidden_layers, 2, 16,
                                cfg.num_key_value_heads * cfg.head_dim)
    v = c.k.view(*c.k.shape[:3], cfg.num_key_value_heads, cfg.head_dim)
    v[1, 0, 3, 2] = 7.0
    assert c.k[1, 0, 3, 2 * cfg.head_dim:3 * cfg.head_dim].eq(7.0).all()
