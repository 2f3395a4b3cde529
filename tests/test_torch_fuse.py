"""`fuse_serving_params` of the port vs the JAX package's, on the CPU at tiny
sizes (mirrors tests/test_decode_fastpath.py::
test_fused_serving_weights_token_identical).

* Leaf for leaf: the fused tree of every weight form (bf16, per-channel
  int8, grouped int4 and mix at group size 32, nibble planes) equals the JAX
  package's fused tree (int4 codes compared unpacked), the unfused leaves
  gone; GQA (Hkv < H) included.
* Bit-equal outputs: each output channel's product is the same in the fused
  leaf as in its own, so a serving call on the fused tree gives the unfused
  call's tokens, actions and first logits bit for bit, on every tier that
  decodes through a different path (turbo: the stacked decode and the fused
  norm's consumers; pallas: the frozen-KV decode; pallas_kv8: the int8
  cache; turbo_kv8: the int8 frozen K/V), and so does the speculative entry.
* The product count: one fused call's trunk runs 4 products a layer, not 7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.models import vlm as tvlm
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin

from tests.test_torch_openvla import _ovla_env  # noqa: F401 (autouse)
from tests.test_torch_pallas_tier import _img_cfg
from tests.test_torch_probe_taps import _inputs

FORMS = {"bf16": None, "int8": 8, "int4": 4, "mix": "mix", "nibble": "nibble"}
VOCAB = 512
A = 7
P = 64


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    if x.dtype == jnp.int4:
        return np.asarray(x.astype(jnp.int8))
    return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("form", list(FORMS))
def test_fuse_matches_jax_leaf_for_leaf(form, kv_heads):
    cfg = jllama.LlamaConfig.tiny(num_key_value_heads=kv_heads)
    params = jllama.init_params(cfg, jax.random.key(1))
    bits = FORMS[form]
    tcfg = tllama.LlamaConfig.tiny(num_key_value_heads=kv_heads)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    if bits is not None:
        params = jlin.quantize_params(params, bits=bits, group_size=32)
        tparams = tlin.quantize_params(tparams, bits=bits, group_size=32)
    want = _flat(jllama.fuse_serving_params(params))
    got = _flat(tllama.fuse_serving_params(tparams))
    assert got.keys() == want.keys()
    assert not any(k.split("/")[2] in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
                   for k in got if k.startswith("/layers/"))
    for k in want:
        g = tlin.unpack_int4(got[k]) if got[k].dtype == torch.uint8 else got[k]
        np.testing.assert_array_equal(_np(g), _np(want[k]), err_msg=k)
    qkv = tllama.fuse_serving_params(tparams)["layers"]["qkv_proj"]
    O = (tcfg.num_attention_heads + 2 * kv_heads) * tcfg.head_dim
    assert (qkv if bits is None else qkv["s"]).shape[:2] == (tcfg.num_hidden_layers, O)
    assert "q_proj" in tparams["layers"]                        # the input tree is kept


@pytest.fixture(scope="module")
def calls():
    """(tier, form) -> (unfused result, fused result) of one serving call."""
    cache = {}

    def run(tier, form):
        key = (tier, form)
        if key in cache:
            return cache[key]
        bits = FORMS[form]
        cfg = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), tier, action_dim=A,
                                             prompt_pad_len=P, codec_vocab_size=VOCAB)
        qkw = dict(quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits=bits) if bits else {}
        params = convert.init_params(cfg.vlm, torch.Generator().manual_seed(3), "cpu", **qkw)
        fused = dict(params, llm=tllama.fuse_serving_params(params["llm"]))
        img, ids, plen, q01, q99, mask = _inputs(VOCAB)
        out = []
        for p in (params, fused):
            r = tvla.predict_action_from_image(p, cfg, img, _img_cfg(timage), ids, plen, q01,
                                               q99, mask, return_first_logits=True, device="cpu")
            out.append({k: v.numpy() for k, v in r.items()})
        cache[key] = out
        return out

    return run


CASES = [("turbo", "int8"), ("turbo", "int4"), ("turbo", "mix"), ("turbo", "nibble"),
         ("turbo_kv8", "int8"), ("pallas", "int8"), ("pallas", "int4"), ("pallas_kv8", "int8"),
         ("parity", "bf16")]


@pytest.mark.parametrize("tier,form", CASES)
def test_fused_serving_bit_equal(calls, tier, form):
    want, got = calls(tier, form)
    for k in ("action_tokens", "actions", "first_logits", "logit_margins"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("form", ["int8", "mix"])
def test_fused_speculative_bit_equal(form):
    cfg = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "turbo", action_dim=A,
                                         prompt_pad_len=P, codec_vocab_size=VOCAB)
    params = convert.init_params(cfg.vlm, torch.Generator().manual_seed(4), "cpu",
                                 quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits=FORMS[form])
    fused = dict(params, llm=tllama.fuse_serving_params(params["llm"]))
    img, ids, plen, q01, q99, mask = _inputs(VOCAB)
    draft = np.random.default_rng(0).integers(0, VOCAB, (3, A)).astype(np.int32)
    out = [tvla.predict_action_speculative_from_image(p, cfg, img, _img_cfg(timage), ids, plen,
                                                      draft, q01, q99, mask, device="cpu")
           for p in (params, fused)]
    for k in ("action_tokens", "n_accepted", "actions"):
        assert torch.equal(out[0][k], out[1][k]), k


def test_fused_trunk_runs_four_products_a_layer(monkeypatch):
    cfg = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "turbo", action_dim=A,
                                         prompt_pad_len=P, codec_vocab_size=VOCAB)
    params = convert.init_params(cfg.vlm, torch.Generator().manual_seed(3), "cpu",
                                 quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits=8)
    counts = []
    real = tllama.matmul_t

    def counted(x, w, *a):
        counts.append(1)
        return real(x, w, *a)

    img, ids, plen, q01, q99, mask = _inputs(VOCAB)
    L = cfg.vlm.llm.num_hidden_layers
    n = {}
    for name, p in (("unfused", params),
                    ("fused", dict(params, llm=tllama.fuse_serving_params(params["llm"])))):
        counts.clear()
        with monkeypatch.context() as mp:
            mp.setattr(tllama, "matmul_t", counted)
            tvla.predict_action_from_image(p, cfg, img, _img_cfg(timage), ids, plen, q01, q99,
                                           mask, device="cpu")
        n[name] = len(counts)
    # the prefill and A - 1 decode steps, each L layers, and each decode step's lm_head in
    # llama.forward (the prefill's runs through vla.matmul_t)
    assert n == {"unfused": 7 * L * A + A - 1, "fused": 4 * L * A + A - 1}, n


def test_fused_tree_keeps_other_leaves():
    params = convert.init_params(tvlm.VLMConfig.tiny(), torch.Generator().manual_seed(0), "cpu")
    fused = tllama.fuse_serving_params(params["llm"])
    assert fused["embed_tokens"] is params["llm"]["embed_tokens"]
    assert fused["layers"]["o_proj"] is params["llm"]["layers"]["o_proj"]
    assert set(fused["layers"]) == {"qkv_proj", "o_proj", "gate_up_proj", "down_proj",
                                    "input_layernorm", "post_attention_layernorm"}
