"""End to end: the port's `pallas` serving tier vs the JAX package's, on the
CPU at tiny sizes (fp32 activations, int8 TURBO_QUANT_SUFFIXES weights,
VLMConfig.turbo() numerics, the frozen-KV split decode).

The JAX side runs with its kernel gates on, every Pallas kernel interpreted
on the CPU: OVLA_PALLAS=1 and OVLA_PALLAS_INTERPRET=1 (monkeypatch), the wi8
matmul gate patched open (`_use_pallas` has no interpret escape), inside
`force_tpu_interpret_mode()`. T = 68 >= 64, so the prefill flash gate
engages on both sides.

Action tokens and actions must be equal. First-position logits and margins
within atol 1e-3: activation codes may differ by one step at rounding ties
(the LayerNorm sums run in another order), and the bf16 RoPE rounds at other
places under XLA (fused elementwise) than op by op in PyTorch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import openvla_probe_tpu.ops.linear
from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.ops.linear import TURBO_QUANT_SUFFIXES, quantize_params
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.models import vlm as tvlm
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin

VOCAB = 512
A = 7
P = 64          # T = 1 + 4 patches + 63 = 68 >= 64
ATOL = 1e-3


def _img_cfg(m):
    return m.ImageTransformConfig(specs=(
        m.BackboneTransformSpec((28, 28), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        m.BackboneTransformSpec((28, 28), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    ))


def _inputs(B=3, seed=0):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (B, 40, 40, 3), dtype=np.uint8)
    plen = np.array([20, 35, 9][:B], np.int32)
    ids = np.zeros((B, P), np.int32)
    for b in range(B):
        ids[b, 0] = 1
        ids[b, 1:plen[b] - 1] = r.integers(3, VOCAB, plen[b] - 2)
        ids[b, plen[b] - 1] = 29871 % VOCAB
    q01 = r.uniform(-2, 0, A).astype(np.float32)
    q99 = r.uniform(0.5, 2, A).astype(np.float32)
    mask = np.array([True] * (A - 1) + [False])
    return img, ids, plen, q01, q99, mask


class _JaxKernelsOn:
    """The JAX package's kernel gates on, every Pallas kernel interpreted."""

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        self.mp.setenv("OVLA_PALLAS", "1")
        self.mp.setenv("OVLA_PALLAS_INTERPRET", "1")
        self.mp.setattr(openvla_probe_tpu.ops.linear, "_use_pallas", lambda: True)
        self.interp = pltpu.force_tpu_interpret_mode()
        self.interp.__enter__()
        return self

    def __exit__(self, *exc):
        self.interp.__exit__(*exc)
        self.mp.undo()


@pytest.fixture(scope="module")
def models():
    serving = jvla.VLAServingConfig.for_tier(jvlm.VLMConfig.tiny(), "pallas", action_dim=A,
                                             prompt_pad_len=P, codec_vocab_size=VOCAB)
    params = quantize_params(jvlm.init_params(serving.vlm, jax.random.key(0)),
                             suffixes=TURBO_QUANT_SUFFIXES, bits=8)
    tserving = convert.config_from_jax(serving)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tserving.vlm,
                                      device="cpu", quant_suffixes=tlin.TURBO_QUANT_SUFFIXES)
    return serving, params, tserving, tparams


@pytest.fixture(scope="module")
def both(models):
    serving, params, tserving, tparams = models
    img, ids, plen, q01, q99, mask = _inputs()
    with _JaxKernelsOn():
        want = jvla.predict_action_from_image(
            params, serving, jnp.asarray(img), _img_cfg(jimage), jnp.asarray(ids),
            jnp.asarray(plen), jnp.asarray(q01), jnp.asarray(q99), jnp.asarray(mask),
            return_first_logits=True)
        want = jax.tree.map(np.asarray, want)
    _build.reset_launch_counts()
    got = tvla.predict_action_from_image(
        tparams, tserving, img, _img_cfg(timage), ids, plen, q01, q99, mask,
        return_first_logits=True, device="cpu")
    return want, {k: v.numpy() for k, v in got.items()}


def test_action_tokens_and_actions_equal(both):
    want, got = both
    assert got["action_tokens"].shape == (3, A)
    np.testing.assert_array_equal(got["action_tokens"], want["action_tokens"])
    np.testing.assert_array_equal(got["normalized_actions"], want["normalized_actions"])
    np.testing.assert_array_equal(got["actions"], want["actions"])


@pytest.mark.parametrize("key", ["first_logits", "logit_margins"])
def test_logits_and_margins_close(both, key):
    want, got = both
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], atol=ATOL)


def test_cpu_run_launches_no_kernel(both):
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}


def test_config_for_tier_matches_jax(models):
    serving, _, tserving, _ = models
    t = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "pallas", action_dim=A,
                                       prompt_pad_len=P, codec_vocab_size=VOCAB)
    assert t == tserving
    assert (t.tier, t.decode_impl, t.kv_int8) == ("pallas", "frozen_kv", False)
    assert t.vlm.llm.rope_dtype == t.vlm.llm.attn_scores_dtype == torch.bfloat16
    assert [v.act for v in t.vlm.vision] == ["gelu_tanh", "gelu_tanh"]
    assert convert.config_from_jax(jvla.VLAServingConfig.for_tier(
        jvlm.VLMConfig.openvla_7b(), "pallas", prompt_pad_len=32)) == \
        tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.openvla_7b(), "pallas", prompt_pad_len=32)


@pytest.mark.parametrize("kw", [{"tier": "pallas", "decode_impl": "stacked"},
                                {"tier": "pallas", "kv_int8": True},
                                {"tier": "turbo_kv8", "kv_int8": True},
                                {"tier": "parity", "decode_impl": "frozen_kv"}])
def test_other_knobs_raise(models, kw):
    with pytest.raises(NotImplementedError, match="pallas"):
        dataclasses.replace(models[2], **kw)


@pytest.mark.parametrize("tier", ["turbo", "turbo_kv8", "pallas_kv8"])
def test_unported_for_tier_raises(tier):
    """turbo_kv8 is not ported; turbo and pallas_kv8 are, but only with their
    own decodes (the stacked cache; decode_impl='stacked_kv8')."""
    with pytest.raises(NotImplementedError, match=tier):
        if tier == "turbo_kv8":
            tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), tier)
        else:
            tvla.VLAServingConfig(vlm=tvlm.VLMConfig.tiny().turbo(), tier=tier,
                                  decode_impl="frozen_kv")


def test_prefill_and_greedy_decode_match_jax(models):
    """The trunk alone: frozen-KV prefill (flash) then 4 split-decode steps,
    int8 weights and bf16 RoPE; the frozen K/V pair and the tokens."""
    serving, params, tserving, tparams = models
    jcfg, tcfg = serving.vlm.llm, tserving.vlm.llm
    B, T = 2, 68
    r = np.random.default_rng(5)
    x = r.normal(size=(B, T, jcfg.hidden_size)).astype(np.float32)
    am = np.ones((B, T), np.int32)
    am[1, T - 9:] = 0
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    mm_len = am.sum(1).astype(np.int32)
    first = np.array([3, 77], np.int32)
    with _JaxKernelsOn():
        jout = jllama.prefill(params["llm"], jcfg, jnp.asarray(x), jnp.asarray(am), jnp.asarray(pos))
        jtoks, jmargins = jllama.greedy_decode(params["llm"], jcfg, jout["kv"], jnp.asarray(am),
                                               jnp.asarray(first), jnp.asarray(mm_len), 4)
    tout = tllama.prefill(tparams["llm"], tcfg, torch.from_numpy(x), torch.from_numpy(am),
                          torch.from_numpy(pos))
    # K leaves the bf16 RoPE: XLA's fused rotation may round one bf16 step apart
    np.testing.assert_allclose(tout["kv"].k.numpy(), np.asarray(jout["kv"].k), atol=ATOL, rtol=8e-3)
    np.testing.assert_allclose(tout["kv"].v.numpy(), np.asarray(jout["kv"].v), atol=ATOL)
    ttoks, tmargins = tllama.greedy_decode(tparams["llm"], tcfg, tout["kv"], torch.from_numpy(am),
                                           torch.from_numpy(first).long(),
                                           torch.from_numpy(mm_len).long(), 4)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(tmargins.numpy(), np.asarray(jmargins), atol=ATOL)


def test_bf16_rope_matches_jax():
    """The turbo RoPE rotates in bf16 (tables and q/k cast first), op by op:
    equal to the JAX function run eagerly."""
    r = np.random.default_rng(7)
    q = r.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k = r.normal(size=(2, 5, 4, 16)).astype(np.float32)
    jcfg = jllama.LlamaConfig.tiny(hidden_size=64, num_attention_heads=4)
    tcfg = tllama.LlamaConfig(**convert._fields(jcfg, tllama.LlamaConfig))
    pos = np.arange(5)[None] + np.array([[0], [200]])
    jcos, jsin = jllama.rope_tables(jcfg, jnp.asarray(pos))
    want = jllama.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin, jnp.bfloat16)
    tcos, tsin = tllama.rope_tables(tcfg, torch.from_numpy(pos))
    got = tllama.apply_rope(torch.from_numpy(q), torch.from_numpy(k), tcos, tsin, torch.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bf16_scores_plain_attention_matches_jax():
    """Short turbo calls (Tq < 64) take the plain attention with bf16 scores:
    the JAX package's XLA branch (llama.py:225-229), within bf16 rounding."""
    r = np.random.default_rng(8)
    B, T, H, Dh = 2, 12, 4, 16
    q, k, v = (r.normal(size=(B, T, H, Dh)).astype(np.float32) for _ in range(3))
    am = np.ones((B, T), np.int32)
    am[1, 9:] = 0
    mask = jllama.make_causal_mask(jnp.asarray(am), T, T)
    want = jllama.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask,
                            scores_dtype=jnp.bfloat16)
    got = tllama.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           tllama.make_causal_mask(torch.from_numpy(am), T, T),
                           scores_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=2e-2)
