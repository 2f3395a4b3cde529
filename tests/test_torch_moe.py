"""The port's sparse-MoE trunk (`models/moe.py`, the router branch of
`models/llama.py`) against the JAX package's, on the CPU at tiny sizes.

The JAX side runs as ``tests/test_moe.py`` runs it (XLA on the CPU,
``lax.ragged_dot_general`` for the sorted dispatch), and for the VLA paths
as the port's tiers are held to: parity with OVLA_PALLAS=1 and
OVLA_PALLAS_INTERPRET=1, turbo under ``test_torch_turbo.jax_turbo``.

Tolerances (fp32 unless stated): the router's logits and probabilities
1e-6 relative (the same fp32 products summed in another order), its expert
ids and the aux losses equal / 1e-6; one MoE layer 2e-6 + 1e-5 relative (the
JAX test's own bound between its two dispatches); a trunk's logits 1e-4;
bf16 layers within 2 bf16 steps at the largest |want| (products exact, fp32
sums in another order, each side rounding its intermediates once). The tiny
MoE VLA: action tokens equal (parity), and on turbo equal up to each row's
first token whose JAX margin is below twice the first-logit gap
(`test_torch_turbo_kv8.assert_tokens`; every linear quantizes its
activations, so codes at rounding ties move); the counts found at the seeds
are asserted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import catalog as jcat
from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import moe as jmoe
from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import catalog as tcat
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import moe as tmoe
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.models import vlm as tvlm
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin
from openvla_probe_tpu_torch.training import train_step as ttrain
from openvla_probe_tpu_torch.training.train_state import OptimizerConfig, make_optimizer

from tests.test_torch_openvla import Tok, clean_ovla_env
from tests.test_torch_openvla import _vlm_cfg as _openvla_cfg
from tests.test_torch_pallas_tier import _img_cfg
from tests.test_torch_turbo import count_calls, jax_turbo
from tests.test_torch_turbo_kv8 import assert_tokens
from tests.test_torch_vla import _inputs

JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
A = 7
P = 64          # T = 1 + 4 patches + 63 = 68 >= 64: the prefill flash gate engages
VOCAB = 512


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(TORCH_DT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _layer(seed, E=4, D=16, F=32, dtype="float32"):
    r = np.random.default_rng(seed)
    lp = {"router": r.normal(size=(E, D)), "gate_proj": r.normal(size=(E, F, D)),
          "up_proj": r.normal(size=(E, F, D)), "down_proj": r.normal(size=(E, D, F))}
    jlp = {k: jnp.asarray(v * 0.2, JNP_DT[dtype]) for k, v in lp.items()}
    return jlp, {k: _t(v, dtype) for k, v in jlp.items()}


def _h(seed, shape=(2, 5, 16), dtype="float32"):
    j = jnp.asarray(np.random.default_rng(seed).normal(size=shape), JNP_DT[dtype])
    return j, _t(j, dtype)


def _close(got, want, dtype, atol=2e-6, rtol=1e-5, steps=2):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=steps * 2.0 ** -7 * np.abs(want).max())


# --- routing ------------------------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_route_matches_jax(top_k):
    jlp, tlp = _layer(0)
    jx, tx = _h(1, (11, 16))
    want = jmoe._route(jlp, jx, top_k)
    got = tmoe._route(tlp, tx, top_k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))   # expert ids
    for g, w in zip(got[1:], want[1:]):                                    # gates, probs, logits
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-7)


def test_route_ties_take_the_first_index():
    """A zero router: every probability ties, the first indices win, as JAX's argmax."""
    jlp, tlp = _layer(0)
    jlp["router"], tlp["router"] = jnp.zeros((4, 16)), torch.zeros(4, 16)
    jx, tx = _h(2, (3, 16))
    np.testing.assert_array_equal(tmoe._route(tlp, tx, 2)[0].numpy(),
                                  np.asarray(jmoe._route(jlp, jx, 2)[0]))
    assert tmoe._route(tlp, tx, 2)[0].tolist() == [[0, 0, 0], [1, 1, 1]]


@pytest.mark.parametrize("with_valid", [False, True])
def test_aux_losses_match_jax(with_valid):
    jlp, tlp = _layer(3)
    jx, tx = _h(4, (10, 16))
    valid = np.array([1, 1, 0, 1, 0, 0, 1, 1, 1, 0], np.float32) if with_valid else None
    ji, _, jp, jl = jmoe._route(jlp, jx, 2)
    ti, _, tp, tl = tmoe._route(tlp, tx, 2)
    want = jmoe._aux_losses(ji, jp, jl, None if valid is None else jnp.asarray(valid), 4, 2)
    got = tmoe._aux_losses(ti, tp, tl, None if valid is None else torch.from_numpy(valid), 4, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_capacity_matches_jax():
    for E, K, cf, S in ((8, 2, 4.0, 2304), (8, 2, 2.0, 16), (4, 2, 2.0, 7), (4, 1, 0.5, 3)):
        assert tmoe.capacity(E, K, cf, S) == jmoe.capacity(E, K, cf, S)


# --- one layer ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [10, 4, 1], ids=["dropless", "drops", "one_slot"])
@pytest.mark.parametrize("with_valid", [False, True], ids=["all_valid", "pads"])
def test_moe_ffn_matches_jax(dtype, capacity, with_valid):
    """The one-hot dispatch, with capacity drops and with PAD tokens (which
    claim no slot)."""
    jlp, tlp = _layer(5, dtype=dtype)
    jh, th = _h(6, dtype=dtype)
    valid = np.array([[1, 1, 1, 0, 0], [1, 0, 1, 1, 1]], np.int32) if with_valid else None
    y_j, aux_j = jmoe.moe_ffn(jlp, jh, top_k=2, capacity=capacity,
                              token_valid=None if valid is None else jnp.asarray(valid))
    y_t, aux_t = tmoe.moe_ffn(tlp, th, top_k=2, capacity=capacity,
                              token_valid=None if valid is None else torch.from_numpy(valid))
    _close(y_t, y_j, dtype)
    np.testing.assert_allclose(aux_t.numpy(), np.asarray(aux_j), rtol=1e-6)


def test_moe_ffn_pads_claim_no_capacity():
    """The JAX test's setup: a uniform router, capacity 7 = the valid tokens;
    every valid token of row 1 is served, pads emit 0, aux 1 and log(E)²."""
    jlp, tlp = _layer(7)
    tlp["router"] = torch.zeros(4, 16)
    _, th = _h(8, (2, 6, 16))
    valid = torch.tensor([[1, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1]])
    y, aux = tmoe.moe_ffn(tlp, th, top_k=2, capacity=7, token_valid=valid)
    assert all(y[1, t].abs().max() > 0 for t in range(6))
    assert torch.all(y[0, 1:] == 0)
    assert aux[0].item() == pytest.approx(1.0, rel=1e-5)
    assert aux[1].item() == pytest.approx(float(np.log(4.0) ** 2), rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("with_valid", [False, True], ids=["all_valid", "pads"])
def test_moe_ffn_sorted_matches_jax(dtype, top_k, with_valid):
    """The sorted dispatch over the grouped product (its plain version here):
    the same outputs and aux; pads emit 0."""
    jlp, tlp = _layer(9, dtype=dtype)
    jh, th = _h(10, dtype=dtype)
    valid = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32) if with_valid else None
    y_j, aux_j = jmoe.moe_ffn_sorted(jlp, jh, top_k=top_k,
                                     token_valid=None if valid is None else jnp.asarray(valid))
    _build.reset_launch_counts()
    y_t, aux_t = tmoe.moe_ffn_sorted(tlp, th, top_k=top_k,
                                     token_valid=None if valid is None else torch.from_numpy(valid))
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}
    _close(y_t, y_j, dtype)
    np.testing.assert_allclose(aux_t.numpy(), np.asarray(aux_j), rtol=1e-6)
    if with_valid:
        assert torch.all(y_t[0, 3:] == 0)


def test_sorted_combine_order_is_jax_scatter_order():
    """At top-3 in bf16 the sum order of a token's rows matters: the port's
    gather over the inverse permutation adds them in the sorted order, the
    JAX package's scatter-add's, so the outputs are bit-equal to a sum in
    that order (and to JAX's where XLA adds them in it too)."""
    jlp, tlp = _layer(11, dtype="bfloat16")
    jh, th = _h(12, (3, 7, 16), dtype="bfloat16")
    y_t, _ = tmoe.moe_ffn_sorted(tlp, th, top_k=3)
    y_j, _ = jmoe.moe_ffn_sorted(jlp, jh, top_k=3)
    _close(y_t, y_j, "bfloat16")
    # the order itself: each token's rows in ascending expert order
    x = th.reshape(-1, 16)
    idx_k, gate_k, _, _ = tmoe._route(tlp, x, 3)
    rows = []
    for e in range(4):
        lp1 = {k: v[e:e + 1] for k, v in tlp.items() if k != "router"}
        g = (x.float() @ lp1["gate_proj"][0].float().t()).bfloat16()
        u = (x.float() @ lp1["up_proj"][0].float().t()).bfloat16()
        act = torch.nn.functional.silu(g.float()).bfloat16() * u
        rows.append((act.float() @ lp1["down_proj"][0].float().t()).bfloat16())
    want = torch.zeros_like(x)
    order = idx_k.sort(dim=0)
    for k in range(3):
        e = order.values[k]
        gk = gate_k.gather(0, order.indices[k:k + 1])[0].bfloat16()
        c = torch.stack([rows[int(e[s])][s] for s in range(x.shape[0])]) * gk[:, None]
        want = want + c
    assert torch.equal(y_t.reshape(-1, 16), want)


@pytest.mark.parametrize("form", ["int8", "int4", "lora"])
def test_sorted_weight_forms_match_jax(form):
    """int8 experts (quantize_params), grouped int4 (group 16 over D = 16 and
    F = 32) and streamed LoRA over the int8 base, on both dispatches."""
    jlp, _ = _layer(13)
    jh, th = _h(14)
    if form == "int4":
        jq = jlin.quantize_params(jlp, bits=4, group_size=16)
    else:
        jq = jlin.quantize_params(jlp)
    if form == "lora":
        r = np.random.default_rng(15)
        for k in ("gate_proj", "up_proj", "down_proj"):
            E, O, I = jlp[k].shape
            jq[k] = {"base": jq[k], "A": jnp.asarray(r.normal(size=(E, 2, I)) * 0.2, jnp.float32),
                     "B": jnp.asarray(r.normal(size=(E, O, 2)) * 0.1, jnp.float32)}
    tq = {k: _leaf(v) for k, v in jq.items()}
    for jfn, tfn, kw in ((jmoe.moe_ffn_sorted, tmoe.moe_ffn_sorted, {}),
                         (jmoe.moe_ffn, tmoe.moe_ffn, {"capacity": 10})):
        y_j, _ = jfn(jq, jh, top_k=2, **kw)
        y_t, _ = tfn(tq, th, top_k=2, **kw)
        _close(y_t, y_j, "float32")


def _leaf(v):
    """A JAX leaf (float, int8 {q, s}, s4 grouped int4, or a LoRA wrapper) ->
    the port's (int4 codes packed)."""
    if not isinstance(v, dict):
        return _t(v)
    if "base" in v:
        return {"base": _leaf(v["base"]), "A": _t(v["A"]), "B": _t(v["B"])}
    if jnp.asarray(v["q"]).dtype == jnp.int4:
        codes = np.array(jnp.asarray(v["q"]).astype(jnp.int8))
        return {"q": tlin.pack_int4(torch.from_numpy(codes)), "s": _t(v["s"])}
    return {"q": torch.from_numpy(np.array(v["q"])), "s": _t(v["s"])}


def test_dispatch_rule_matches_jax():
    """'auto' is sorted exactly when dropless; 'sorted' raises where it
    would drop; the three agree at dropless capacity."""
    cfg = tllama.LlamaConfig.tiny(moe_experts=4)          # factor 2 = E / K: dropless
    jcfg = jllama.LlamaConfig.tiny(moe_experts=4)
    jlp, tlp = _layer(16, D=32, F=128)
    jh, th = _h(17, (1, 8, 32))
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        count_calls(mp, tmoe, ["moe_ffn", "moe_ffn_sorted"], calls)
        y_auto, _ = tllama._moe_mlp(cfg, tlp, th)
    assert calls == {"moe_ffn_sorted": 1}
    y_e, _ = tllama._moe_mlp(dataclasses.replace(cfg, moe_dispatch="einsum"), tlp, th)
    _close(y_auto, y_e, "float32")
    _close(y_auto, jllama._moe_mlp(jcfg, jlp, jh)[0], "float32")
    capped = dataclasses.replace(cfg, moe_capacity_factor=0.5)
    y_c, _ = tllama._moe_mlp(capped, tlp, th)
    _close(y_c, jllama._moe_mlp(dataclasses.replace(jcfg, moe_capacity_factor=0.5), jlp, jh)[0],
           "float32")
    with pytest.raises(ValueError, match="dropless-only"):
        tllama._moe_mlp(dataclasses.replace(capped, moe_dispatch="sorted"), tlp, th)


# --- the trunk ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def trunk():
    """A tiny MoE trunk with GQA (4 heads over 2 kv heads), dropless."""
    jcfg = jllama.LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                              moe_experts=4, moe_capacity_factor=100.0, dtype=jnp.float32)
    params = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = convert.config_from_jax(jvlm.VLMConfig.tiny(llm=jcfg)).llm
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    return jcfg, params, tcfg, tparams


@pytest.mark.parametrize("dispatch", ["auto", "einsum"])
def test_trunk_forward_matches_jax(trunk, dispatch):
    """The uncached forward (pads in row 1): logits, and the router losses
    averaged over layers."""
    jcfg, params, tcfg, tparams = trunk
    jcfg, tcfg = (dataclasses.replace(c, moe_dispatch=dispatch) for c in (jcfg, tcfg))
    ids = np.random.default_rng(18).integers(0, 128, size=(2, 9))
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    pos = np.broadcast_to(np.arange(9), (2, 9))
    want = jllama.forward(params, jcfg, jllama.embed_tokens(params, jnp.asarray(ids)),
                          jnp.asarray(mask), jnp.asarray(pos))
    got = tllama.forward(tparams, tcfg, tllama.embed_tokens(tparams, torch.from_numpy(ids)),
                         torch.from_numpy(mask), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-4)
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5)


def test_trunk_cached_decode_matches_full(trunk):
    """A cached prefill and decode steps equal the uncached forward (the JAX
    test's setup), and the JAX package's cached steps."""
    jcfg, params, tcfg, tparams = trunk
    ids = np.random.default_rng(19).integers(0, 128, size=(1, 6))
    e = tllama.embed_tokens(tparams, torch.from_numpy(ids))
    full = tllama.forward(tparams, tcfg, e, torch.ones(1, 6, dtype=torch.int32),
                          torch.arange(6)[None])["logits"]
    je = jllama.embed_tokens(params, jnp.asarray(ids))
    cache = tllama.KVCache.zeros(tcfg, 1, 8, dtype=torch.float32)
    jcache = jllama.KVCache.zeros(jcfg, 1, 8, dtype=jnp.float32)
    mask = torch.zeros(1, 8, dtype=torch.int32)
    mask[:, :4] = 1
    out = tllama.forward(tparams, tcfg, e[:, :4], mask, torch.arange(4)[None], cache=cache,
                         cache_index=0)
    jout = jllama.forward(params, jcfg, je[:, :4], jnp.asarray(mask.numpy()),
                          jnp.arange(4)[None], cache=jcache, cache_index=jnp.int32(0))
    np.testing.assert_allclose(out["logits"][:, -1].numpy(), full[:, 3].numpy(), atol=1e-4)
    assert "moe_aux" not in out
    for t in (4, 5):
        mask[:, t] = 1
        out = tllama.forward(tparams, tcfg, e[:, t:t + 1], mask, torch.full((1, 1), t),
                             cache=cache, cache_index=t)
        jout = jllama.forward(params, jcfg, je[:, t:t + 1], jnp.asarray(mask.numpy()),
                              jnp.full((1, 1), t), cache=jout["cache"], cache_index=jnp.int32(t))
        np.testing.assert_allclose(out["logits"][:, 0].numpy(), full[:, t].numpy(), atol=1e-4)
        np.testing.assert_allclose(out["logits"][:, 0].numpy(), np.asarray(jout["logits"][:, 0]),
                                   atol=1e-4)


def test_frozen_kv_decode_matches_jax(trunk):
    """`prefill` + `greedy_decode` (the frozen-KV split decode the pallas and
    turbo_kv8 tiers take) over the MoE trunk: the JAX package's tokens."""
    jcfg, params, tcfg, tparams = trunk
    ids = np.random.default_rng(20).integers(0, 128, size=(2, 7))
    mask = np.ones((2, 7), np.int32)
    mask[0, 5:] = 0
    pos = np.broadcast_to(np.arange(7), (2, 7)).copy()
    e = tllama.embed_tokens(tparams, torch.from_numpy(ids))
    out = tllama.prefill(tparams, tcfg, e, torch.from_numpy(mask), torch.from_numpy(pos))
    jout = jllama.prefill(params, jcfg, jllama.embed_tokens(params, jnp.asarray(ids)),
                          jnp.asarray(mask), jnp.asarray(pos))
    np.testing.assert_allclose(out["last_hidden_state"].numpy(),
                               np.asarray(jout["last_hidden_state"]), atol=1e-5)
    first = torch.tensor([3, 9])
    start = torch.tensor([5, 7])
    toks, _ = tllama.greedy_decode(tparams, tcfg, out["kv"], torch.from_numpy(mask), first,
                                   start, 4)
    jtoks, _ = jllama.greedy_decode(params, jcfg, jout["kv"], jnp.asarray(mask),
                                    jnp.asarray(first.numpy()), jnp.asarray(start.numpy()), 4)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


def test_fuse_serving_params_keeps_experts_unfused(trunk):
    _, _, tcfg, tparams = trunk
    fused = tllama.fuse_serving_params(tparams)["layers"]
    assert "qkv_proj" in fused and "gate_up_proj" not in fused
    assert {"router", "gate_proj", "up_proj", "down_proj"} <= set(fused)


# --- weights ------------------------------------------------------------------------


def _hf_state(rng, cfg, L, E, D, F, H, Hkv, Dh, V):
    def w(*shape):
        return (rng.normal(size=shape) * 0.05).astype(np.float32)

    state = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": w(D) + 1,
             "lm_head.weight": w(V, D)}
    for i in range(L):
        p = f"model.layers.{i}."
        state.update({p + "self_attn.q_proj.weight": w(H * Dh, D),
                      p + "self_attn.k_proj.weight": w(Hkv * Dh, D),
                      p + "self_attn.v_proj.weight": w(Hkv * Dh, D),
                      p + "self_attn.o_proj.weight": w(D, H * Dh),
                      p + "input_layernorm.weight": w(D) + 1,
                      p + "post_attention_layernorm.weight": w(D) + 1,
                      p + "block_sparse_moe.gate.weight": w(E, D)})
        for j in range(E):
            for name, shape in (("w1", (F, D)), ("w3", (F, D)), ("w2", (D, F))):
                state[p + f"block_sparse_moe.experts.{j}.{name}.weight"] = w(*shape)
    return state


@pytest.mark.parametrize("bits", [None, 8, 4, "mix"])
def test_params_from_hf_mixtral_layout(bits):
    """The HF Mixtral layout (router, experts w1 / w3 / w2 stacked [L, E,
    ...]) as the JAX package reads it; quantized on the way in, the codes of
    quantize_params over the loaded tree bit for bit."""
    jcfg = jllama.LlamaConfig.tiny(vocab_size=64, num_hidden_layers=2, moe_experts=3,
                                   hidden_size=128, intermediate_size=256, num_attention_heads=2,
                                   num_key_value_heads=1)
    tcfg = convert.config_from_jax(jvlm.VLMConfig.tiny(llm=jcfg)).llm
    state = _hf_state(np.random.default_rng(21), jcfg, 2, 3, 128, 256, 2, 1, 64, 64)
    want = jllama.params_from_hf(state, jcfg)
    got = tllama.params_from_hf(state, tcfg, device="cpu", bits=bits)
    assert set(got["layers"]) == set(want["layers"])
    if bits is None:
        assert got["layers"]["gate_proj"].shape == (2, 3, 256, 128)
    ref = tllama.params_from_hf(state, tcfg, device="cpu")
    for k, v in want["layers"].items():
        np.testing.assert_array_equal(ref["layers"][k].numpy(), np.asarray(v), err_msg=k)
    if bits is not None:
        q = tlin.quantize_params(ref, bits=bits)
        for k in ("router", "gate_proj", "down_proj"):
            a, b = got["layers"][k], q["layers"][k]
            if isinstance(b, dict):
                for kk in b:
                    assert torch.equal(a[kk], b[kk]), (k, kk)
            else:
                assert torch.equal(a, b), k


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_expert_layouts_match_jax(bits):
    """quantize_params on the [L, E, O, I] expert leaves: int8 s [L, E, O],
    grouped int4 codes group-major [L, E, G, O, gsz] (packed here), the
    router left float; the codes equal JAX's, and params_from_jax carries
    every leaf."""
    jcfg = jvlm.VLMConfig.tiny(llm=jllama.LlamaConfig.tiny(moe_experts=4, hidden_size=128,
                                                           intermediate_size=256))
    params = jvlm.init_params(jcfg, jax.random.key(1))
    jq = jlin.quantize_params(params, bits=bits)
    tcfg = convert.config_from_jax(jcfg)
    tq = convert.params_from_jax(jax.tree.map(np.asarray, jq), tcfg, device="cpu",
                                 quant_suffixes=tlin._DEFAULT_QUANT_SUFFIXES, bits=bits)
    tf = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    mine = tlin.quantize_params(tf, bits=bits)
    layers = tq["layers"] if "layers" in tq else tq["llm"]["layers"]
    assert not isinstance(layers["router"], dict)
    L, E, F_, D = 4, 4, 256, 128
    if bits == 8:
        assert layers["gate_proj"]["q"].shape == (L, E, F_, D)
        assert layers["gate_proj"]["s"].shape == (L, E, F_)
    else:
        assert layers["gate_proj"]["q"].shape == (L, E, D // 128, F_, 64)
        assert layers["gate_proj"]["s"].shape == (L, E, F_, D // 128)
        assert tlin.is_grouped_int4(tlin.index_layer(layers, 0)["gate_proj"])
    for k in ("gate_proj", "up_proj", "down_proj"):
        for kk in ("q", "s"):
            a, b = layers[k][kk], mine["llm"]["layers"][k][kk]
            diff = (a.float() - b.float()).abs().max().item() if kk == "s" else \
                (tlin.unpack_int4(a) if bits == 4 else a).ne(
                    tlin.unpack_int4(b) if bits == 4 else b).float().mean().item()
            assert diff < (1e-6 if kk == "s" else 1e-3), (k, kk, diff)


def test_random_params_like_makes_the_expert_tree():
    """A quantized MoE tree drawn directly (no float twin): each leaf in the
    layout vlm_param_spec states."""
    cfg = convert.config_from_jax(jvlm.VLMConfig.tiny(
        llm=jllama.LlamaConfig.tiny(moe_experts=4)))
    spec = convert.vlm_param_spec(cfg, tlin.TURBO_QUANT_SUFFIXES, 8)
    tree = tlin.random_params_like(spec, torch.Generator().manual_seed(0))
    layers = tree["llm"]["layers"]
    assert layers["gate_proj"]["q"].shape == (4, 4, 128, 64)
    assert layers["gate_proj"]["q"].dtype == torch.int8
    assert layers["down_proj"]["s"].shape == (4, 4, 64)
    assert layers["router"].dtype == torch.float32 and layers["router"].shape == (4, 4, 64)


def test_config_from_jax_takes_moe():
    jcfg = jvlm.VLMConfig.tiny(llm=jllama.LlamaConfig.tiny(moe_experts=4, moe_top_k=1,
                                                           moe_dispatch="einsum"))
    t = convert.config_from_jax(jcfg)
    assert (t.llm.moe_experts, t.llm.moe_top_k, t.llm.moe_dispatch) == (4, 1, "einsum")
    mix = jcat.LLM_BACKBONES["mixtral-8x7b-v0.1"]["cfg"]
    assert convert.config_from_jax(jvlm.VLMConfig.tiny(llm=mix)).llm == \
        tcat.LLM_BACKBONES["mixtral-8x7b-v0.1"]["cfg"]


# --- the VLA ------------------------------------------------------------------------


# tokens compared at the seeds (module docstring): every one on parity; on turbo 13 of 14
# (a sweep of seeds 0-14 compared 1 to 13: the first-logit gap is 4e-3 to 6e-3, the smallest
# margins at tiny random weights 8e-4 to 9e-3; no compared token differed)
SEEDS = {"parity": 0, "turbo": 14}
COMPARED = {"parity": 14, "turbo": 13}


@pytest.fixture(scope="module", params=["parity", "turbo"])
def vla_pair(request):
    tier = request.param
    cfg = jvlm.VLMConfig.tiny(llm=jllama.LlamaConfig.tiny(moe_experts=4))
    serving = jvla.VLAServingConfig.for_tier(cfg, tier, action_dim=A, prompt_pad_len=P,
                                             codec_vocab_size=VOCAB)
    params = jvlm.init_params(serving.vlm, jax.random.key(SEEDS[tier]))
    quant = {}
    if tier == "turbo":
        params = jlin.quantize_params(params, suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=8)
        quant = dict(quant_suffixes=tlin.TURBO_QUANT_SUFFIXES)
    tserving = convert.config_from_jax(serving)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tserving.vlm,
                                      device="cpu", **quant)
    img, ids, plen, q01, q99, mask = _inputs()
    if tier == "turbo":
        ctx = jax_turbo()
    else:
        ctx = pytest.MonkeyPatch.context()
    with ctx as mp:
        if tier == "parity":
            mp.setenv("OVLA_PALLAS", "1")
            mp.setenv("OVLA_PALLAS_INTERPRET", "1")
        want = jvla.predict_action_from_image(
            params, serving, jnp.asarray(img), _img_cfg(jimage), jnp.asarray(ids),
            jnp.asarray(plen), jnp.asarray(q01), jnp.asarray(q99), jnp.asarray(mask),
            return_first_logits=True)
    want = jax.tree.map(np.asarray, want)
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        count_calls(mp, tmoe, ["expert_ragged"], calls)
        _build.reset_launch_counts()
        got = tvla.predict_action_from_image(
            tparams, tserving, img, _img_cfg(timage), ids, plen, q01, q99, mask,
            return_first_logits=True, device="cpu")
    return tier, want, {k: v.numpy() for k, v in got.items()}, calls, tserving


def test_moe_vla_tokens_match_jax(vla_pair):
    tier, want, got, calls, c = vla_pair
    assert got["action_tokens"].shape == want["action_tokens"].shape
    gap = np.abs(got["first_logits"] - want["first_logits"]).max()
    n = assert_tokens(got["action_tokens"], want["action_tokens"], want["logit_margins"], gap)
    assert n == COMPARED[tier], (n, gap, want["logit_margins"])
    # three grouped products a MoE layer, every layer of the prefill and of each decode step
    assert calls == {"expert_ragged": 3 * c.vlm.llm.num_hidden_layers * A}
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}


def test_moe_vla_first_logits_close(vla_pair):
    tier, want, got, _, _ = vla_pair
    atol = 1e-4 if tier == "parity" else 2e-2
    np.testing.assert_allclose(got["first_logits"], want["first_logits"], atol=atol)


def test_moe_openvla_matches_jax():
    """The OpenVLA wrapper over a MoE trunk (the JAX test_moe_vla_serving_e2e
    setup, with OpenVLA's vocabulary: test_torch_openvla's), one image and
    three: the JAX wrapper's tokens and actions, and two calls alike."""
    with clean_ovla_env():
        cfg = dataclasses.replace(_openvla_cfg(), llm=jllama.LlamaConfig.tiny(
            vocab_size=32064, moe_experts=4, moe_capacity_factor=100.0))
        serving = jvla.VLAServingConfig(vlm=cfg, action_dim=5, prompt_pad_len=16,
                                        codec_vocab_size=32000)
        params = jvlm.init_params(cfg, jax.random.key(0))
        tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                          convert.config_from_jax(cfg), device="cpu")
        s = cfg.vision[0].image_size
        stats = {"x": {"action": {"q01": -np.ones(5, np.float32),
                                  "q99": np.ones(5, np.float32)}}}
        jm = jvla.OpenVLA(params, serving, Tok(), stats, _img_cfg(jimage))
        tm = tvla.OpenVLA(tparams, convert.config_from_jax(serving), Tok(), stats,
                          _img_cfg(timage), device="cpu")
        imgs = np.random.default_rng(0).integers(0, 256, (3, s + 10, s + 10, 3), dtype=np.uint8)
        for img in (imgs[0], imgs):
            want = jm.predict_action(img, "pick up the block", unnorm_key="x")
            got = tm.predict_action(img, "pick up the block", unnorm_key="x")
            np.testing.assert_array_equal(np.asarray(got["action_tokens"]),
                                          np.asarray(want["action_tokens"]))
            np.testing.assert_allclose(np.asarray(got["actions"]), np.asarray(want["actions"]),
                                       atol=1e-6)
        again = tm.predict_action(imgs, "pick up the block", unnorm_key="x")
        np.testing.assert_array_equal(np.asarray(again["action_tokens"]),
                                      np.asarray(got["action_tokens"]))


# --- what stays out of this slice ---------------------------------------------------


def test_moe_training_raises():
    cfg = tvlm.VLMConfig.tiny(llm=tllama.LlamaConfig.tiny(moe_experts=4))
    opt = make_optimizer(OptimizerConfig(), {"w": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="item 13"):
        ttrain.make_train_step(cfg, opt)


def test_moe_export_raises():
    """The hazard of the JAX package's export (its dense keys would carry the
    [E, F, D] expert stacks and drop the router): the port refuses it."""
    cfg = tvlm.VLMConfig.tiny(llm=tllama.LlamaConfig.tiny(moe_experts=4))
    params = convert.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE trunk"):
        tcat.params_to_hf_state(params, cfg)
