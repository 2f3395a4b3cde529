"""The port's Phi-2 trunk (`models/phi.py`) and the Phi branches of
`models/vlm.py` against the JAX package's, on the CPU at tiny fp32 sizes.

The JAX side runs as ``tests/test_phi.py`` runs it (XLA on the CPU; the
trunk's attention takes no kernel on either side), the towers of the VLM
with the JAX kernels in interpret mode (OVLA_PALLAS=1,
OVLA_PALLAS_INTERPRET=1, monkeypatch only), as
``tests/test_torch_vit_llama.py``. Tolerance: fp32 atol 1e-4 on logits
(the same fp32 sums in another order through a few layers), 1e-5 on one
layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import catalog as jcat
from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import phi as jphi
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.models.vit import ViTConfig as JViTConfig
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import catalog as tcat
from openvla_probe_tpu_torch.models import generate as tgen
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import phi as tphi
from openvla_probe_tpu_torch.models import vlm as tvlm

ATOL = 1e-4


def _perturbed(params, seed):
    """Non-trivial norms and biases, so every leaf is exercised."""
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * r.normal(size=a.shape).astype(np.float32),
                        params)


@pytest.fixture(scope="module", params=[0.4, 0.5], ids=["rotary0.4", "rotary0.5"])
def trunk(request):
    jcfg = jphi.PhiConfig.tiny(partial_rotary_factor=request.param)
    tcfg = tphi.PhiConfig(**convert._fields(jcfg, tphi.PhiConfig))
    params = _perturbed(jphi.init_params(jcfg, jax.random.key(0)), 1)
    tparams = convert._convert(params, convert.phi_param_spec(tcfg), "", torch.device("cpu"))
    return jcfg, jax.tree.map(jnp.asarray, params), tcfg, tparams


def test_config_and_rotary_dim(trunk):
    jcfg, _, tcfg, _ = trunk
    assert (tcfg.head_dim, tcfg.rotary_dim) == (jcfg.head_dim, jcfg.rotary_dim)
    assert convert.config_from_jax(jvlm.VLMConfig.tiny(llm=jcfg)).llm == tcfg


def test_partial_rope_and_gelu_match_jax(trunk):
    jcfg, _, tcfg, _ = trunk
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])
    want = np.asarray(jphi._partial_rope(jnp.asarray(x), jnp.asarray(pos), jcfg))
    got = tphi._partial_rope(torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(got[..., tcfg.rotary_dim:].numpy(), x[..., tcfg.rotary_dim:])
    np.testing.assert_allclose(tphi._gelu_tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(jphi._gelu_tanh(jnp.asarray(x))), atol=1e-6)


def test_layer_matches_jax(trunk):
    jcfg, jp, tcfg, tp = trunk
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 6, 64)).astype(np.float32)
    am = np.ones((2, 6), np.int32)
    am[1, 4:] = 0
    pos = np.broadcast_to(np.arange(6), (2, 6)).copy()
    jmask = jllama.make_causal_mask(jnp.asarray(am), 6, 6)
    tmask = tllama.make_causal_mask(torch.from_numpy(am), 6, 6)
    jlp = {k: v[1] for k, v in jp["layers"].items()}
    tlp = {k: v[1] for k, v in tp["layers"].items()}
    want, _ = jphi._layer(jcfg, jlp, jnp.asarray(x), jmask, jnp.asarray(pos))
    got = tphi._layer(tcfg, tlp, torch.from_numpy(x), tmask, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_logits_match_jax(trunk):
    jcfg, jp, tcfg, tp = trunk
    ids = np.random.default_rng(4).integers(0, 256, size=(2, 9))
    am = np.ones((2, 9), np.int32)
    am[0, 7:] = 0
    pos = np.broadcast_to(np.arange(9), (2, 9)).copy()
    want = jphi.forward(jp, jcfg, jphi.embed_tokens(jp, jnp.asarray(ids)), jnp.asarray(am),
                        jnp.asarray(pos))
    got = tphi.forward(tp, tcfg, tphi.embed_tokens(tp, torch.from_numpy(ids)),
                       torch.from_numpy(am), torch.from_numpy(pos))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(got["last_hidden_state"].numpy(),
                               np.asarray(want["last_hidden_state"]), atol=ATOL)
    assert got["logits"].dtype == torch.float32


def test_cached_decode_matches_full_and_jax(trunk):
    """The JAX test's setup: a 5-token cached prefill, then decode steps at
    slots 5 and 6, each equal to the uncached forward's position and to the
    JAX package's cached step."""
    jcfg, jp, tcfg, tp = trunk
    ids = np.random.default_rng(5).integers(0, 256, size=(1, 7))
    e = tphi.embed_tokens(tp, torch.from_numpy(ids))
    je = jphi.embed_tokens(jp, jnp.asarray(ids))
    full = tphi.forward(tp, tcfg, e, torch.ones(1, 7, dtype=torch.int32),
                        torch.arange(7)[None])["logits"]
    shape = (tcfg.num_hidden_layers, 1, 10, tcfg.num_attention_heads, tcfg.head_dim)
    cache = tllama.KVCache(torch.zeros(shape), torch.zeros(shape))
    jcache = jllama.KVCache(jnp.zeros(shape), jnp.zeros(shape))
    mask = torch.zeros(1, 10, dtype=torch.int32)
    mask[:, :5] = 1
    out = tphi.forward(tp, tcfg, e[:, :5], mask, torch.arange(5)[None], cache=cache,
                       cache_index=0)
    jout = jphi.forward(jp, jcfg, je[:, :5], jnp.asarray(mask.numpy()), jnp.arange(5)[None],
                        cache=jcache, cache_index=jnp.int32(0))
    np.testing.assert_allclose(out["logits"].numpy(), full[:, :5].numpy(), atol=ATOL)
    for t in (5, 6):
        mask[:, t] = 1
        out = tphi.forward(tp, tcfg, e[:, t:t + 1], mask, torch.full((1, 1), t), cache=cache,
                           cache_index=t)
        jout = jphi.forward(jp, jcfg, je[:, t:t + 1], jnp.asarray(mask.numpy()),
                            jnp.full((1, 1), t), cache=jout["cache"], cache_index=jnp.int32(t))
        np.testing.assert_allclose(out["logits"][:, 0].numpy(), full[:, t].numpy(), atol=ATOL)
        np.testing.assert_allclose(out["logits"][:, 0].numpy(),
                                   np.asarray(jout["logits"][:, 0]), atol=ATOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jout["cache"].k), atol=ATOL)


def test_params_from_hf_matches_jax():
    """The HF PhiForCausalLM layout, as the JAX package reads it."""
    cfg = jphi.PhiConfig.tiny()
    tcfg = tphi.PhiConfig(**convert._fields(cfg, tphi.PhiConfig))
    r = np.random.default_rng(6)
    D, F, V = 64, 128, 256
    state = {"model.embed_tokens.weight": r.normal(size=(V, D)),
             "model.final_layernorm.weight": r.normal(size=D),
             "model.final_layernorm.bias": r.normal(size=D),
             "lm_head.weight": r.normal(size=(V, D)), "lm_head.bias": r.normal(size=V)}
    shapes = {"input_layernorm.weight": (D,), "input_layernorm.bias": (D,),
              "mlp.fc1.weight": (F, D), "mlp.fc1.bias": (F,), "mlp.fc2.weight": (D, F),
              "mlp.fc2.bias": (D,), "self_attn.dense.weight": (D, D),
              "self_attn.dense.bias": (D,)}
    for p in "qkv":
        shapes[f"self_attn.{p}_proj.weight"], shapes[f"self_attn.{p}_proj.bias"] = (D, D), (D,)
    for i in range(cfg.num_hidden_layers):
        for k, s in shapes.items():
            state[f"model.layers.{i}.{k}"] = r.normal(size=s)
    state = {k: v.astype(np.float32) for k, v in state.items()}
    want = jphi.params_from_hf(state, cfg)
    got = tphi.params_from_hf(state, tcfg, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert sum(1 for _ in flat_w) == len(tphi._HF_LAYER_KEYS) + 5
    for path, leaf in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf), err_msg=str(path))


# --- the VLM ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def phi_vlm():
    """The phi-2+3b shape at tiny width: one CLIP-style tower (pre-norm, no
    patch bias, quick GELU), the gelu-mlp projector, a Phi trunk."""
    jcfg = jvlm.VLMConfig(
        llm=jphi.PhiConfig.tiny(),
        vision=(JViTConfig.clip_vit_l(image_size=28, hidden_size=32, num_layers=3, num_heads=2,
                                      mlp_dim=64),),
        vision_names=("clip",), arch_specifier="gelu-mlp")
    params = _perturbed(jvlm.init_params(jcfg, jax.random.key(7)), 8)
    tcfg = convert.config_from_jax(jcfg)
    tparams = convert.params_from_jax(params, tcfg, device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, params), tcfg, tparams


def test_phi_vlm_forward_matches_jax(phi_vlm, monkeypatch):
    """Multimodal (the patches spliced after BOS), with labels, and unimodal."""
    jcfg, jp, tcfg, tp = phi_vlm
    monkeypatch.setenv("OVLA_PALLAS", "1")
    monkeypatch.setenv("OVLA_PALLAS_INTERPRET", "1")
    r = np.random.default_rng(9)
    B, T = 2, 10
    ids = r.integers(2, 250, (B, T))
    am = np.ones((B, T), np.int32)
    am[1, 8:] = 0
    labels = np.full((B, T), -100, np.int64)
    labels[:, -4:] = r.integers(3, 256, (B, 4))
    px = r.normal(size=(B, 3, 28, 28)).astype(np.float32)
    want = jvlm.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(px),
                        jnp.asarray(labels))
    got = tvlm.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(am),
                       torch.from_numpy(px), torch.from_numpy(labels))
    assert got["logits"].shape == (B, T + tcfg.num_patches, 256)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    uni_w = jvlm.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(am))
    uni_g = tvlm.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(am))
    np.testing.assert_allclose(uni_g["logits"].numpy(), np.asarray(uni_w["logits"]), atol=ATOL)


def test_phi_vlm_spec_and_init(phi_vlm):
    """The parameter layout is Phi's, and init_params makes it."""
    _, _, tcfg, tp = phi_vlm
    spec = convert.vlm_param_spec(tcfg)
    assert set(spec["llm"]["layers"]) == set(tp["llm"]["layers"]) >= {"q_w", "fc1_b"}
    init = convert.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert init["llm"]["layers"]["q_w"].shape == (3, 64, 64)
    assert torch.all(init["llm"]["layers"]["q_b"] == 0)
    assert torch.all(init["llm"]["final_ln_scale"] == 1)


def test_unported_trunks_and_phi_limits_raise(phi_vlm):
    """A trunk other than Llama or Phi raises; on Phi, generation (the JAX
    package's generate runs the Llama trunk only), the probe tap (Llama
    only there too) and the HF export raise; scoring takes the trunk."""
    _, _, tcfg, tp = phi_vlm
    ids = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="Llama .*and Phi-2 trunks"):
        tvlm.forward(tp, dataclasses.replace(tcfg, llm=object()), ids, torch.ones_like(ids))
    with pytest.raises(NotImplementedError, match="Llama-trunk feature"):
        tvlm.forward(tp, tcfg, ids, torch.ones_like(ids), collect_hidden_states=True)
    with pytest.raises(NotImplementedError, match="Phi-2 trunk"):
        tgen.generate_greedy_batch(tp, tcfg, None, [[1, 5, 9]], max_new_tokens=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Phi-2 trunk"):
        tcat.params_to_hf_state(tp, tcfg)
    scores = tgen.score_continuation_rows(tp, tcfg, [([1, 5, 9, 11], 2)], device="cpu")
    assert scores.shape == (1,) and np.isfinite(scores).all()


def test_phi_catalog_entry_matches_jax():
    tcfg, _, prompt = tcat.build_vlm_config("clip-vit-l-336px", "phi-2-3b", "gelu-mlp",
                                            "letterbox")
    jcfg, _, _ = jcat.build_vlm_config("clip-vit-l-336px", "phi-2-3b", "gelu-mlp", "letterbox")
    assert isinstance(tcfg.llm, tphi.PhiConfig) and tcfg == convert.config_from_jax(jcfg)
    assert (tcfg.llm.hidden_size, tcfg.llm.head_dim, tcfg.llm.rotary_dim) == (2560, 80, 32)
    assert tcfg.vision[0].num_patches + 1 == 577 and tcfg.vision[0].head_dim == 64
    assert prompt.__name__ == "PhiPromptBuilder"
