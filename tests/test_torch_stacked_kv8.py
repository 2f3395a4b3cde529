"""The port's `pallas_kv8` tier (int8 flat stacked KV cache, fused-dequant
decode attention) vs the JAX package, on the CPU at tiny sizes.

* _quant_heads and quantize_prefill_to_stacked: codes and scales
  bit-identical to the JAX package's, the zero-padded slots included.
* stacked_decode_attention_i8's plain version vs the JAX kernel in interpret
  mode, on the cases of tests/test_stacked_kv8.py (two layers picked out of
  three, layer selection, GQA) plus an S that is no multiple of 128 (the JAX
  kernel pads in VMEM): fp32 1e-5 (the same fp32 arithmetic, sums in another
  order), bf16 2e-2 (one bf16 rounding of outputs up to ~3).
* The decode step alone (GQA trunk, n_rep = 2): from the same int8 cache, four
  `decode_step_stacked_i8` steps give hidden states within 1e-3 of the JAX
  package's and the same tokens; the cache codes differ from the JAX
  package's in at most 5 % of places (found: 1.1 %), by one step (the bf16
  RoPE rounds at other places under XLA, so a K value near a rounding edge may
  land one code apart).
* End to end (`pallas_kv8`, int8 TURBO_QUANT_SUFFIXES weights, turbo
  numerics): tokens and actions equal, first logits and margins within 1e-3
  (the `pallas` tier's tolerance and reasons, tests/test_torch_pallas_tier.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import decode_attention as jdec
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.ops.linear import TURBO_QUANT_SUFFIXES, quantize_params
from openvla_probe_tpu.ops.linear import matmul_t as jmatmul_t
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.models import vlm as tvlm
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import decode_attention as tdec
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin

from tests.test_torch_pallas_tier import _JaxKernelsOn, _img_cfg, _inputs

VOCAB = 512
A = 7
P = 64          # T = 1 + 4 patches + 63 = 68 >= 64: the prefill flash gate engages
ATOL = 1e-3
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a):
    """numpy / JAX -> torch (bf16 through fp32, exactly)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _quant_np(x):
    s = np.maximum(np.abs(x).max(-1), 1e-8) / 127.0
    return np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8), s.astype(np.float32)


# --- quantization of the cache --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_heads_bit_identical(dtype):
    x = np.random.default_rng(0).normal(size=(2, 5, 3, 16))
    x[0, 1] = 0.0                                    # all-zero heads: the 1e-8 scale floor
    jx = jnp.asarray(x, JNP_DT[dtype])
    want = jllama._quant_heads(jx)
    got = tllama._quant_heads(_t(jx))
    assert got[0].dtype == torch.int8 and got[0].shape == (2, 5, 48)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_prefill_to_stacked_bit_identical(dtype):
    r = np.random.default_rng(1)
    L, B, T, Hkv, Dh, S = 3, 2, 21, 2, 16, 32
    k, v = (jnp.asarray(r.normal(size=(L, B, T, Hkv, Dh)), JNP_DT[dtype]) for _ in range(2))
    want = jllama.quantize_prefill_to_stacked(jllama.PrefillKV(k, v), S)
    got = tllama.quantize_prefill_to_stacked(tllama.PrefillKV(_t(k), _t(v)), S)
    assert got.kq.shape == (L, B, S, Hkv * Dh) and got.ks.shape == (L, B, S, Hkv)
    for name in ("kq", "ks", "vq", "vs"):   # the padded slots T..S-1 included
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


# --- the decode kernel's plain version ------------------------------------------------------


def _cache(rng, L, B, S, Hkv, Dh, v_const=None):
    kq, ks = _quant_np(rng.normal(size=(L, B, S, Hkv, Dh)).astype(np.float32))
    vf = rng.normal(size=(L, B, S, Hkv, Dh)).astype(np.float32) if v_const is None else v_const
    vq, vs = _quant_np(vf)
    return (kq.reshape(L, B, S, Hkv * Dh), ks, vq.reshape(L, B, S, Hkv * Dh), vs)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case", ["layers", "gqa", "s_pad"])
def test_stacked_plain_matches_jax_kernel(dtype, tol, case):
    r = np.random.default_rng(3)
    L, B, S, H, Hkv, Dh, layers = {
        "layers": (3, 2, 128, 4, 4, 128, (0, 2)),    # layers picked out of three
        "gqa": (2, 2, 128, 4, 2, 128, (1,)),         # n_rep = 2
        "s_pad": (2, 3, 40, 4, 2, 16, (1,)),         # S past no 128 multiple, tiny heads
    }[case]
    q = jnp.asarray(r.normal(size=(B, 1, H, Dh)), JNP_DT[dtype])
    cache = _cache(r, L, B, S, Hkv, Dh)
    valid = (r.random((B, S)) > 0.3).astype(np.int32)
    valid[:, :4] = 1
    _build.reset_launch_counts()
    for li in layers:
        want = jdec.stacked_decode_attention_i8(q, *(jnp.asarray(c) for c in cache),
                                                jnp.asarray(valid), jnp.int32(li), interpret=True)
        got = tdec.stacked_decode_attention_i8(_t(q), *(torch.from_numpy(c) for c in cache),
                                               torch.from_numpy(valid), li)
        assert got.dtype == TORCH_DT[dtype] and got.shape == (B, 1, H, Dh)
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}     # the CPU takes the plain version


def test_stacked_layer_selection_is_exact():
    """Two layers with V = 1 and V = -3: each call reads exactly its layer."""
    r = np.random.default_rng(1)
    L, B, S, H, Dh = 2, 1, 128, 2, 128
    v = np.stack([np.full((B, S, H, Dh), 1.0, np.float32), np.full((B, S, H, Dh), -3.0, np.float32)])
    cache = [torch.from_numpy(c) for c in _cache(r, L, B, S, H, Dh, v_const=v)]
    q = torch.from_numpy(r.normal(size=(B, 1, H, Dh)).astype(np.float32))
    for li, expect in ((0, 1.0), (1, -3.0)):
        out = tdec.stacked_decode_attention_i8(q, *cache, torch.ones((B, S), dtype=torch.int32), li)
        np.testing.assert_allclose(out.numpy(), expect, rtol=1e-6)
    with pytest.raises(IndexError):
        tdec.stacked_decode_attention_i8(q, *cache, torch.ones((B, S), dtype=torch.int32), 2)


# --- the decode step, from the same cache -------------------------------------------------


@pytest.fixture(scope="module")
def gqa_trunk():
    cfg = jvlm.VLMConfig.tiny(llm=jllama.LlamaConfig.tiny(num_key_value_heads=2)).turbo()
    params = quantize_params(jvlm.init_params(cfg, jax.random.key(3)),
                             suffixes=TURBO_QUANT_SUFFIXES, bits=8)
    tcfg = convert.config_from_jax(cfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu",
                                      quant_suffixes=tlin.TURBO_QUANT_SUFFIXES)
    return cfg.llm, params["llm"], tcfg.llm, tparams["llm"]


def test_decode_steps_match_jax(gqa_trunk):
    jcfg, jp, tcfg, tp = gqa_trunk
    assert jcfg.num_attention_heads // jcfg.num_key_value_heads == 2
    B, T, steps = 2, 21, 4
    S = 32
    r = np.random.default_rng(6)
    x = r.normal(size=(B, T, jcfg.hidden_size)).astype(np.float32)
    am = np.ones((B, T), np.int32)
    am[1, T - 5:] = 0
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    mm_len = am.sum(1)
    with _JaxKernelsOn():
        kv = jllama.prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(am), jnp.asarray(pos))["kv"]
    jc = jllama.quantize_prefill_to_stacked(kv, S)
    tc = tllama.quantize_prefill_to_stacked(tllama.PrefillKV(_t(kv.k), _t(kv.v)), S)
    slots = np.arange(S)[None]
    jtok = ttok = np.array([5, 300])
    for t in range(steps):
        valid = ((slots < mm_len[:, None]) | ((slots >= T) & (slots <= T + t))).astype(np.int32)
        step_pos = (mm_len + t)[:, None]
        with _JaxKernelsOn():
            jh, jc = jllama.decode_step_stacked_i8(
                jp, jcfg, jllama.embed_tokens(jp, jnp.asarray(jtok)[:, None]),
                jnp.asarray(step_pos), jc, jnp.asarray(valid), jnp.int32(T + t))
            jlg = np.asarray(jmatmul_t(jh, jp["lm_head"]).astype(jnp.float32))
        th = tllama.decode_step_stacked_i8(
            tp, tcfg, tllama.embed_tokens(tp, torch.from_numpy(ttok)[:, None]),
            torch.from_numpy(step_pos), tc, torch.from_numpy(valid), T + t)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
        tlg = tlin.matmul_t(th, tp["lm_head"]).float().numpy()
        jtok, ttok = jlg.argmax(-1), tlg.argmax(-1)
        np.testing.assert_array_equal(ttok, jtok)
    for name in ("kq", "vq"):
        diff = np.abs(getattr(tc, name).numpy().astype(np.int32)
                      - np.asarray(getattr(jc, name)).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.05, name
    np.testing.assert_allclose(tc.ks.numpy(), np.asarray(jc.ks), rtol=1e-2)


# --- end to end ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    serving = jvla.VLAServingConfig.for_tier(jvlm.VLMConfig.tiny(), "pallas_kv8", action_dim=A,
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
    assert len(np.unique(want["action_tokens"])) > 1
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
    t = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "pallas_kv8", action_dim=A,
                                       prompt_pad_len=P, codec_vocab_size=VOCAB)
    assert t == tserving
    assert (t.tier, t.decode_impl, t.kv_int8) == ("pallas_kv8", "stacked_kv8", False)
    assert t.vlm == tvlm.VLMConfig.tiny().turbo()
    assert convert.config_from_jax(jvla.VLAServingConfig.for_tier(
        jvlm.VLMConfig.openvla_7b(), "pallas_kv8", prompt_pad_len=32)) == \
        tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.openvla_7b(), "pallas_kv8", prompt_pad_len=32)
    # the tier and decode_impl='stacked_kv8' imply each other, in both packages
    for kw in ({"tier": "pallas_kv8"}, {"tier": "pallas", "decode_impl": "stacked_kv8"}):
        with pytest.raises(ValueError, match="imply each other"):
            tvla.VLAServingConfig(vlm=t.vlm, **kw)
        with pytest.raises(ValueError, match="imply each other"):
            jvla.VLAServingConfig(vlm=serving.vlm, **kw)
