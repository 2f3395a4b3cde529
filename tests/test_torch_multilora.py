"""The port's multi-LoRA serving (models/multilora.py, the multi-LoRA branches
of ops/linear.py, OpenVLA.set_adapters) against the JAX package's, on the CPU
at tiny size, on the same weights and the same adapters (JAX's, brought
across with convert.lora_from_jax).

* Banks, the fused tree, the one-hot and infer_lora_config: bit-equal.
* matmul_t on masked wrappers (both variants) and fused wrappers over every
  base form: bf16 and fp32, per-channel int8 on "wi8" (the JAX package's
  `_wi8_matmul_2d` interpreted) and "w8a8" (`_w8a8_dot`), grouped int4 at
  decode and prefill M, mix and nibble; fuse raises on the last three. fp32
  activations: within 2e-5 relative (the same products summed in another
  order; the int8 routes quantize the same activations to the same codes);
  bf16: within 1e-2 relative. `matmul_t_grouped` under the grouped option
  (the JAX package's OVLA_MULTILORA_GROUPED=1) and per leaf.
* OpenVLA with mixed rows [bare, t0, t1, t2], sequential and speculative,
  masked and fused installs, on parity (masked only: the JAX package refuses
  fused there), turbo and pallas, against the JAX OpenVLA with the same
  adapters (the environments of tests/test_torch_turbo.py::jax_turbo and
  tests/test_torch_pallas_tier.py::_JaxKernelsOn). parity: tokens equal,
  first logits within 1e-5. turbo and pallas: tokens equal up to the margin
  rule of tests/test_torch_turbo_kv8.assert_tokens (every linear quantizes
  its activations), first logits within 2e-2 (the bound the speculative
  tests state for these tiers: the bf16 RoPE's standing divergence).
* The errors word for word (no banks, an unknown name, an id out of range,
  the row count, a reinstall after fused=True, fused on parity), the A/B
  knobs refused at construction, and an adapter checkpoint round trip
  through the port trainer's format.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import multilora as jml
from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu.training import lora as jlora
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import multilora as tml
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin
from openvla_probe_tpu_torch.training import checkpointing, lora as tlora
from tests.test_torch_openvla import (A, PROMPT, STATS, Tok, _img_cfg, _ovla_env,  # noqa: F401
                                      _vlm_cfg, clean_ovla_env)
from tests.test_torch_pallas_tier import _JaxKernelsOn
from tests.test_torch_turbo import jax_turbo
from tests.test_torch_turbo_kv8 import assert_tokens

R, N_AD = 4, 3
ROWS = [None, "t0", "t1", "t2"]


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


def _rand_lora(params, cfg, seed):
    """init_lora_params with B drawn N(0, 0.05) (B = 0 would add nothing)."""
    tree = jlora.init_lora_params(params, cfg, jax.random.key(seed))
    leaves, td = jax.tree_util.tree_flatten(tree, is_leaf=jlora._is_ab)
    ks = jax.random.split(jax.random.key(seed + 1000), len(leaves))
    return jax.tree_util.tree_unflatten(td, [
        None if l is None else {"A": l["A"], "B": jax.random.normal(k, l["B"].shape) * 0.05}
        for l, k in zip(leaves, ks)])


def _port_lora(tree):
    return convert.lora_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


JCFG = jlora.LoRAConfig(r=R, include_lm_head=True)
TCFG = tlora.LoRAConfig(r=R, include_lm_head=True)


# --- banks, fuse, one-hot -------------------------------------------------------------


@pytest.fixture(scope="module")
def leaf_bank():
    """One target leaf t [O, K] with N adapters (fp32 masters)."""
    r = np.random.default_rng(0)
    O, K = 32, 64
    trees = [{"t": {"A": r.normal(0, 0.05, (R, K)).astype(np.float32),
                    "B": r.normal(0, 0.05, (O, R)).astype(np.float32)}} for _ in range(N_AD)]
    w = r.normal(0, 0.05, (O, K)).astype(np.float32)
    return trees, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_adapter_banks_matches_jax(leaf_bank, dtype):
    trees, _ = leaf_bank
    jb = jml.stack_adapter_banks([jax.tree.map(jnp.asarray, t) for t in trees], JCFG,
                                 dtype=jnp.dtype(dtype))
    tb = tml.stack_adapter_banks([_port_lora(t) for t in trees], TCFG,
                                 dtype=getattr(torch, dtype))
    for k in ("A", "Bt"):
        assert tb["t"][k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_np(tb["t"][k]), _np(jb["t"][k]), err_msg=k)
    with pytest.raises(ValueError, match="at least one adapter"):
        tml.stack_adapter_banks([], TCFG)
    with pytest.raises(ValueError, match="disagree on target leaves"):
        tml.stack_adapter_banks([_port_lora(trees[0]), {"t": None}], TCFG)


@pytest.mark.parametrize("base", ["int8", "float32"])
def test_fuse_bank_into_base_matches_jax(leaf_bank, base):
    trees, w = leaf_bank
    jb = jml.stack_adapter_banks([jax.tree.map(jnp.asarray, t) for t in trees], JCFG,
                                 dtype=jnp.float32)
    tb = tml.stack_adapter_banks([_port_lora(t) for t in trees], TCFG, dtype=torch.float32)
    jw = jlin.quantize_weight(jnp.asarray(w)) if base == "int8" else jnp.asarray(w)
    tw = ({k: torch.from_numpy(np.array(v)) for k, v in jw.items()} if base == "int8"
          else torch.from_numpy(w.copy()))
    before = {k: v.clone() for k, v in _flat({"t": tw}).items()}
    jf = jml.fuse_bank_into_base({"t": jw}, jb)
    tf = tml.fuse_bank_into_base({"t": tw}, tb)
    assert set(tf["t"]) == set(jf["t"]) == ({"qf", "sf", "Bt"} if base == "int8" else {"wf", "Bt"})
    for k in tf["t"]:
        np.testing.assert_array_equal(_np(tf["t"][k]), _np(jf["t"][k]), err_msg=k)
    # the caller's tree is untouched
    for k, v in _flat({"t": tw}).items():
        assert torch.equal(v, before[k]), k
    sel = np.array([0, 2, -1])
    ja = jml.attach_multilora_fused(jf, jml.adapter_one_hot(sel, N_AD))
    ta = tml.attach_multilora_fused(tf, tml.adapter_one_hot(sel, N_AD))
    np.testing.assert_array_equal(_np(ta["t"]["sel"]), _np(ja["t"]["sel"]))


def test_attach_multilora_matches_jax(leaf_bank):
    """Layer-stacked leaves: sel broadcast over the stack dims, so that a
    layer's slice (index_layer) is a well-formed wrapper; non-targets kept."""
    trees, w = leaf_bank
    L = 2
    stacked = [{"t": {k: np.stack([v, 2 * v]) for k, v in t["t"].items()}, "u": None}
               for t in trees]
    jb = jml.stack_adapter_banks([jax.tree.map(jnp.asarray, t) for t in stacked], JCFG)
    tb = tml.stack_adapter_banks([_port_lora(t) for t in stacked], TCFG)
    base = np.stack([w, 3 * w])
    u = np.ones((4, 4), np.float32)
    sel = np.array([1, -1, 0])
    ja = jml.attach_multilora({"t": jnp.asarray(base), "u": jnp.asarray(u)}, jb,
                              jml.adapter_one_hot(sel, N_AD))
    ta = tml.attach_multilora({"t": torch.from_numpy(base), "u": torch.from_numpy(u)}, tb,
                              tml.adapter_one_hot(sel, N_AD))
    assert set(ta["t"]) == set(ja["t"]) == {"base", "A", "Bt", "sel"}
    for k in ("base", "A", "Bt", "sel"):
        assert tuple(ta["t"][k].shape) == tuple(ja["t"][k].shape), k
        np.testing.assert_array_equal(_np(ta["t"][k]), _np(ja["t"][k]), err_msg=k)
    assert ta["t"]["sel"].shape[0] == L
    assert torch.equal(ta["u"], torch.from_numpy(u))
    layer = tlin.index_layer(ta, 1)["t"]
    assert tlin.is_multilora(layer) and tuple(layer["sel"].shape) == (3, N_AD)


def test_adapter_one_hot_matches_jax():
    for ids, kw in (([2, -1, 0, 1], {}), (1, {"batch": 3}), (np.array([-1, 5]), {})):
        np.testing.assert_array_equal(tml.adapter_one_hot(ids, 3, **kw).numpy(),
                                      np.asarray(jml.adapter_one_hot(ids, 3, **kw)))
    for fn in (jml.adapter_one_hot, tml.adapter_one_hot):
        with pytest.raises(ValueError, match="scalar adapter id needs `batch`"):
            fn(1, 3)
        with pytest.raises(ValueError, match="must be a scalar or"):
            fn(np.zeros((2, 2), np.int32), 3)


# --- matmul_t over every base form ------------------------------------------------------

BEX, T_PRE, T_DEC = 2, 20, 1     # prefill M = 40 (> 32), decode M = 2


@pytest.fixture(scope="module")
def ops():
    r = np.random.default_rng(1)
    O, K = 128, 256
    w = r.normal(0, 0.05, (O, K)).astype(np.float32)
    trees = [{"t": {"A": r.normal(0, 0.1, (R, K)).astype(np.float32),
                    "B": r.normal(0, 0.1, (O, R)).astype(np.float32)}} for _ in range(N_AD)]
    jb = jml.stack_adapter_banks([jax.tree.map(jnp.asarray, t) for t in trees], JCFG,
                                 dtype=jnp.float32)
    tb = tml.stack_adapter_banks([_port_lora(t) for t in trees], TCFG, dtype=torch.float32)
    xs = {T: r.normal(0, 1.0, (BEX, T, K)).astype(np.float32) for T in (T_PRE, T_DEC)}
    return w, jb, tb, xs


def _bases(w):
    """(JAX leaf, port leaf) of each base form (int4 groups of 128)."""
    jw = jnp.asarray(w)
    out = {"float32": (jw, torch.from_numpy(w.copy()))}
    for name, bits in (("int8", 8), ("int4", 4), ("mix", "mix"), ("nibble", "nibble")):
        # a trunk leaf's name, so that quantize_params gives mix and nibble forms
        jq = jlin.quantize_params({"q_proj": jw}, bits=bits)["q_proj"]
        codes = jlin.quantize_params({"q_proj": jw}, bits=bits, emit_codes=True)["q_proj"]
        spec = convert._quant_leaf("q_proj", convert.Leaf(tuple(w.shape), torch.float32,
                                                          "normal"), bits)
        out[name] = (jq, convert._convert(jax.tree.map(np.asarray, codes), spec, name,
                                          torch.device("cpu")))
    return out


def _jax_env(route):
    """The JAX package's dispatch for the port's route: "wi8" its kernel gate
    (interpreted), "w8a8" its default environment."""
    if route == "wi8":
        return _JaxKernelsOn()
    return clean_ovla_env()


def _both(ops_, base, route, T, wrap, impl="masked", dtype="float32"):
    w, jb, tb, xs = ops_
    jw, tw = _bases(w)[base]
    if base == "float32":   # a float leaf in the activations' dtype, as the model's are
        jw, tw = jw.astype(jnp.dtype(dtype)), tw.to(getattr(torch, dtype))
    ids = np.array([1, -1])
    jsel, tsel = jml.adapter_one_hot(ids, N_AD), tml.adapter_one_hot(ids, N_AD)
    x = xs[T]
    jx, tx = jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    if wrap == "masked":
        jl = {"base": jw, "A": jb["t"]["A"], "Bt": jb["t"]["Bt"], "sel": jsel}
        tl = tml.attach_multilora({"t": tw}, tb, tsel, impl=impl)["t"]
    else:
        jl = jml.attach_multilora_fused(jml.fuse_bank_into_base({"t": jw}, jb), jsel)["t"]
        tl = tml.attach_multilora_fused(tml.fuse_bank_into_base({"t": tw}, tb), tsel)["t"]
    with _jax_env(route) as env:
        if impl == "einsum":
            env.setenv("OVLA_MULTILORA_IMPL", "einsum")
        want = jlin.matmul_t(jx, jl)
    got = tlin.matmul_t(tx, tl, route)
    base_only = tlin.matmul_t(tx, tw, route)
    return _np(got), _np(want), _np(base_only)


def _close(got, want, dtype):
    tol = 2e-5 if dtype == "float32" else 1e-2
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("T", [T_PRE, T_DEC], ids=["prefill", "decode"])
@pytest.mark.parametrize("base,route,dtype", [("float32", "w8a8", "float32"),
                                              ("float32", "w8a8", "bfloat16"),
                                              ("int8", "wi8", "float32"),
                                              ("int8", "w8a8", "float32"),
                                              ("int4", "w8a8", "float32"),
                                              ("mix", "w8a8", "float32"),
                                              ("nibble", "w8a8", "float32")])
def test_matmul_t_masked_matches_jax(ops, base, route, dtype, T):
    got, want, base_only = _both(ops, base, route, T, "masked", dtype=dtype)
    _close(got, want, dtype)
    np.testing.assert_array_equal(got[1], base_only[1])      # the bare row: the base's bits
    assert np.abs(got[0] - base_only[0]).max() > 1e-3        # the adapter does something


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_t_einsum_matches_jax_and_masked(ops, dtype):
    got, want, _ = _both(ops, "float32", "w8a8", T_PRE, "masked", impl="einsum", dtype=dtype)
    _close(got, want, dtype)
    masked, _, _ = _both(ops, "float32", "w8a8", T_PRE, "masked", dtype=dtype)
    _close(got, masked, dtype)


@pytest.mark.parametrize("T", [T_PRE, T_DEC], ids=["prefill", "decode"])
@pytest.mark.parametrize("base,route,dtype", [("float32", "w8a8", "float32"),
                                              ("float32", "w8a8", "bfloat16"),
                                              ("int8", "wi8", "float32"),
                                              ("int8", "w8a8", "float32")])
def test_matmul_t_fused_matches_jax(ops, base, route, dtype, T):
    got, want, base_only = _both(ops, base, route, T, "fused", dtype=dtype)
    _close(got, want, dtype)
    # the bare row: the plain leaf's bits (the first O columns of the widened product)
    np.testing.assert_array_equal(got[1], base_only[1])


@pytest.mark.parametrize("base", ["int4", "mix", "nibble"])
def test_fuse_refuses_int4_mix_nibble(ops, base):
    w, jb, tb, _ = ops
    jw, tw = _bases(w)[base]
    with pytest.raises(NotImplementedError) as je:
        jml.fuse_bank_into_base({"t": jw}, jb)
    with pytest.raises(NotImplementedError) as te:
        tml.fuse_bank_into_base({"t": tw}, tb)
    assert str(te.value) == str(je.value)


def test_matmul_t_grouped_matches_jax(ops):
    w, jb, tb, xs = ops
    ids = np.array([2, -1])
    jsel, tsel = jml.adapter_one_hot(ids, N_AD), tml.adapter_one_hot(ids, N_AD)
    jl, tl, tl_g = [], [], []
    for fac in (1.0, 0.7, 1.3):
        jq = jlin.quantize_weight(jnp.asarray(w * fac))
        tq = {k: torch.from_numpy(np.array(v)) for k, v in jq.items()}
        jl.append(jml.attach_multilora_fused(jml.fuse_bank_into_base({"t": jq}, jb), jsel)["t"])
        tf = tml.fuse_bank_into_base({"t": tq}, tb)
        tl.append(tml.attach_multilora_fused(tf, tsel)["t"])
        tl_g.append(tml.attach_multilora_fused(tf, tsel, grouped=True)["t"])
        assert tl_g[-1]["grouped"] is True and "grouped" not in tl[-1]
    x = xs[T_PRE]
    with clean_ovla_env() as env:
        env.setenv("OVLA_MULTILORA_GROUPED", "1")
        want = jlin.matmul_t_grouped(jnp.asarray(x), jl)
    got = tlin.matmul_t_grouped(torch.from_numpy(x), tl_g, "w8a8")
    per_leaf = tlin.matmul_t_grouped(torch.from_numpy(x), tl, "w8a8")
    for g, p, wnt in zip(got, per_leaf, want):
        _close(_np(g), _np(wnt), "float32")
        _close(_np(g), _np(p), "float32")
    # a leaf that is not fused: per leaf, bit for bit
    plain = [{k: torch.from_numpy(np.array(v)) for k, v in jlin.quantize_weight(
        jnp.asarray(w * f)).items()} for f in (1.0, 2.0)]
    got = tlin.matmul_t_grouped(torch.from_numpy(x), plain, "w8a8")
    for g, q in zip(got, plain):
        assert torch.equal(g, tlin.matmul_t(torch.from_numpy(x), q, "w8a8"))
    # a grouped leaf beside one that is not grouped: per leaf, bit for bit
    got = tlin.matmul_t_grouped(torch.from_numpy(x), [tl_g[0], tl[1]], "w8a8")
    for g, leaf in zip(got, [tl_g[0], tl[1]]):
        assert torch.equal(g, tlin.matmul_t(torch.from_numpy(x), leaf, "w8a8"))


def test_multilora_options_validates(ops):
    """The options live in the wrapper leaves: attach validates `impl`, and
    a layer-stacked wrapper's option keys pass `index_layer` unchanged."""
    _, _, tb, _ = ops
    sel = tml.adapter_one_hot(np.array([0, -1]), N_AD)
    O, K = tb["t"]["Bt"].shape[-1], tb["t"]["A"].shape[-1]
    with pytest.raises(ValueError, match="impl must be one of"):
        tml.attach_multilora({"t": torch.zeros(O, K)}, tb, sel, impl="gather")
    assert "impl" not in tml.attach_multilora({"t": torch.zeros(O, K)}, tb, sel)["t"]
    stacked = {"A": tb["t"]["A"].expand(3, *tb["t"]["A"].shape),
               "Bt": tb["t"]["Bt"].expand(3, *tb["t"]["Bt"].shape)}
    wrapped = tml.attach_multilora({"t": torch.zeros(3, O, K)}, {"t": stacked}, sel,
                                   impl="einsum")
    layer = tlin.index_layer(wrapped, 1)["t"]
    assert layer["impl"] == "einsum" and layer["sel"].shape == sel.shape
    assert layer["A"].shape == tb["t"]["A"].shape


# --- the OpenVLA wrapper ----------------------------------------------------------------


@pytest.fixture(scope="module")
def vla_parts():
    with clean_ovla_env():
        cfg = _vlm_cfg()
        params = jax.tree.map(np.asarray, __import__(
            "openvla_probe_tpu.models.vlm", fromlist=["init_params"]).init_params(
                cfg, jax.random.key(0)))
        adapters = {f"t{i}": _rand_lora(params, JCFG, 10 + i) for i in range(N_AD)}
        s = cfg.vision[0].image_size
        imgs = np.random.default_rng(0).integers(0, 256, (4, s + 10, s + 10, 3), dtype=np.uint8)
        return cfg, params, adapters, s, imgs


def _tier(parts, tier):
    """(JAX serving config, JAX params as numpy, the JAX environment) of a tier."""
    cfg, params = parts[0], parts[1]
    if tier == "parity":
        return jvla.VLAServingConfig(vlm=cfg, action_dim=A, prompt_pad_len=16,
                                     codec_vocab_size=32000), params, clean_ovla_env
    serving = jvla.VLAServingConfig.for_tier(cfg, tier, action_dim=A, prompt_pad_len=16,
                                             codec_vocab_size=32000)
    qparams = jax.tree.map(np.asarray, jlin.quantize_params(
        jax.tree.map(jnp.asarray, params), suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=8))
    return serving, qparams, (jax_turbo if tier == "turbo" else _JaxKernelsOn)


def _models(parts, tier, fused, impl="masked", grouped=False):
    serving, params, env = _tier(parts, tier)
    s, adapters = parts[3], parts[2]
    tparams = convert.params_from_jax(
        params, convert.config_from_jax(serving.vlm), device="cpu",
        quant_suffixes=tlin.TURBO_QUANT_SUFFIXES if tier != "parity" else ())
    tm = tvla.OpenVLA(tparams, convert.config_from_jax(serving), Tok(), STATS,
                      _img_cfg(timage, s), device="cpu")
    tm.set_adapters({k: _port_lora(v) for k, v in adapters.items()}, TCFG, fused=fused,
                    impl=impl, grouped=grouped)
    with env():
        # fused=True deletes the JAX tree's source buffers: a fresh copy each time
        jm = jvla.OpenVLA(jax.tree.map(jnp.array, params), serving, Tok(), STATS,
                          _img_cfg(jimage, s))
        jm.set_adapters({k: jax.tree.map(jnp.asarray, v) for k, v in adapters.items()}, JCFG,
                        fused=fused)
    return jm, tm, env


def _check(got, want, tier) -> float:
    """Tokens (parity: equal; else by the margin rule) and first logits;
    returns the first logits' largest gap."""
    gap = float(np.abs(got["first_logits"] - want["first_logits"]).max())
    if tier == "parity":
        np.testing.assert_array_equal(got["action_tokens"], want["action_tokens"])
        assert gap <= 1e-5 * max(np.abs(want["first_logits"]).max(), 1.0), gap
        return gap
    assert gap <= QUANT_GAP, gap
    n = assert_tokens(got["action_tokens"], want["action_tokens"], want["logit_margins"], gap)
    assert n >= MIN_COMPARED[tier], n
    return gap


# the tokens of the 20 that the margin rule compares at this seed (the turbo tier's first
# logits sit 7e-3 to 1.4e-2 from JAX's, the pallas tier's 8e-5)
MIN_COMPARED = {"turbo": 8, "pallas": 20}
# the first logits' port-vs-JAX gap on the activation-quantizing tiers: the bound
# tests/test_torch_speculative_quant.py states (the bf16 RoPE's standing divergence,
# ROADMAP Queue 3)
QUANT_GAP = 2e-2


@pytest.mark.parametrize("tier,fused", [("parity", False), ("turbo", False), ("turbo", True),
                                        ("pallas", False), ("pallas", True)])
def test_openvla_mixed_rows_match_jax(vla_parts, tier, fused):
    """Sequential and speculative calls over rows [bare, t0, t1, t2]."""
    jm, tm, env = _models(vla_parts, tier, fused)
    imgs = vla_parts[4]
    kw = dict(unnorm_key="b", adapter=ROWS)
    with env():
        want = jm.predict_action(imgs, PROMPT, return_first_logits=True, **kw)
    got = tm.predict_action(imgs, PROMPT, return_first_logits=True, **kw)
    gap = _check(got, want, tier)
    # speculative, drafted with JAX's sequential tokens (parity opts in)
    if tier == "parity":
        jm.cfg = dataclasses.replace(jm.cfg, speculative_in_parity="allow")
        tm.cfg = dataclasses.replace(tm.cfg, speculative_in_parity="allow")
    draft = want["action_tokens"].copy()
    draft[:, 2:] = (draft[:, 2:] + 7) % 32000          # right for 2 tokens, then wrong
    with env():
        jspec = jm.predict_action(imgs, PROMPT, draft_tokens=draft, **kw)
    tspec = tm.predict_action(imgs, PROMPT, draft_tokens=draft, **kw)
    if tier == "parity":
        np.testing.assert_array_equal(tspec["action_tokens"], jspec["action_tokens"])
        np.testing.assert_array_equal(tspec["n_accepted"], jspec["n_accepted"])
    else:   # the sequential call's margins stand for the verify's
        n = assert_tokens(tspec["action_tokens"], jspec["action_tokens"], want["logit_margins"],
                          gap)
        assert n >= MIN_COMPARED[tier], n
    assert tspec["action_tokens"].shape == (4, A)


def test_openvla_einsum_install_matches_masked(vla_parts):
    _, tm, _ = _models(vla_parts, "parity", False)
    _, te, _ = _models(vla_parts, "parity", False, impl="einsum")
    imgs = vla_parts[4]
    a = tm.predict_action(imgs, PROMPT, unnorm_key="b", adapter=ROWS, return_first_logits=True)
    b = te.predict_action(imgs, PROMPT, unnorm_key="b", adapter=ROWS, return_first_logits=True)
    np.testing.assert_array_equal(a["action_tokens"], b["action_tokens"])
    np.testing.assert_allclose(a["first_logits"], b["first_logits"], rtol=1e-5, atol=1e-5)


def test_openvla_grouped_install_matches_per_leaf(vla_parts):
    """grouped=True on a fused turbo install batches the gate/up second
    products into one bmm: the same tokens, first logits within fp32
    rounding of the per-leaf install's."""
    _, tm, _ = _models(vla_parts, "turbo", True)
    _, tg, _ = _models(vla_parts, "turbo", True, grouped=True)
    imgs = vla_parts[4]
    a = tm.predict_action(imgs, PROMPT, unnorm_key="b", adapter=ROWS, return_first_logits=True)
    b = tg.predict_action(imgs, PROMPT, unnorm_key="b", adapter=ROWS, return_first_logits=True)
    np.testing.assert_array_equal(a["action_tokens"], b["action_tokens"])
    np.testing.assert_allclose(a["first_logits"], b["first_logits"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_openvla_batch_rows_match_jax(vla_parts, fused):
    """predict_action_batch: 3 rows padded to the bucket of 4 (the adapter ids
    repeat row 0 as the images do), per-row prompts, stats and adapters."""
    jm, tm, env = _models(vla_parts, "turbo", fused)
    imgs = vla_parts[4][:3]
    prompts = [PROMPT, "In: What action should the robot take to open the drawer?\nOut:",
               "In: What action should the robot take to stack the cups?\nOut:"]
    kw = dict(unnorm_keys=["a", "b", "a"], adapters=["t2", None, "t0"])
    with env():
        want = jm.predict_action_batch(imgs, prompts, **kw)
    got = tm.predict_action_batch(imgs, prompts, **kw)
    tok = lambda rows: np.stack([r["action_tokens"] for r in rows])   # noqa: E731
    margins = np.stack([r["logit_margins"] for r in want])
    # the margins' difference bounds twice the logits' gap where the tokens agree
    gap = max(abs(g["logit_margins"][0] - w["logit_margins"][0]) for g, w in zip(got, want))
    assert tok(got)[:, 0].tolist() == tok(want)[:, 0].tolist()
    assert assert_tokens(tok(got), tok(want), margins, gap) >= 9
    # a bare row of the adapted batch is the plain batch's row on the masked install
    if not fused:
        plain = tm.predict_action_batch(imgs, prompts, unnorm_keys=["a", "b", "a"])
        np.testing.assert_array_equal(got[1]["action_tokens"], plain[1]["action_tokens"])


def _message(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    raise AssertionError("no error")


def test_openvla_errors_word_for_word(vla_parts):
    serving, params, _ = _tier(vla_parts, "parity")
    s, adapters, imgs = vla_parts[3], vla_parts[2], vla_parts[4]
    jm = jvla.OpenVLA(jax.tree.map(jnp.asarray, params), serving, Tok(), STATS,
                      _img_cfg(jimage, s))
    tm = tvla.OpenVLA(convert.params_from_jax(params, convert.config_from_jax(serving.vlm),
                                              device="cpu"),
                      convert.config_from_jax(serving), Tok(), STATS, _img_cfg(timage, s),
                      device="cpu")
    pairs = [lambda m: m.predict_action(imgs[:1], PROMPT, unnorm_key="a", adapter="t0")]
    for call in pairs:                                         # no banks installed
        assert _message(lambda: call(tm)) == _message(lambda: call(jm))
    ja = {k: jax.tree.map(jnp.asarray, v) for k, v in adapters.items()}
    ta = {k: _port_lora(v) for k, v in adapters.items()}
    # fused on the parity tier
    assert (_message(lambda: tm.set_adapters(ta, TCFG, fused=True))
            == _message(lambda: jm.set_adapters(ja, JCFG, fused=True)))
    jm.set_adapters(ja, JCFG)
    tm.set_adapters(ta, TCFG)
    assert tm.n_adapters == jm.n_adapters == N_AD and tm.adapter_names == jm.adapter_names
    for adapter, n in (("nope", 1), (7, 1), (["t0"], 2), (-2, 1)):
        call = lambda m: m.predict_action(imgs[:n], PROMPT, unnorm_key="a",  # noqa: E731
                                          adapter=adapter)
        assert _message(lambda: call(tm)) == _message(lambda: call(jm)), adapter
    # the reinstall after fused=True (a turbo base)
    jt, tt, env = _models(vla_parts, "turbo", True)
    with env():
        want = _message(lambda: jt.set_adapters(ja, JCFG))
    assert _message(lambda: tt.set_adapters(ta, TCFG)) == want
    with pytest.raises(ValueError, match="impl must be one of"):
        tm.set_adapters(ta, TCFG, impl="gather")


@pytest.mark.parametrize("knob,arg", [("OVLA_MULTILORA_IMPL", "impl="),
                                      ("OVLA_MULTILORA_GROUPED", "grouped=")])
def test_the_ab_knobs_raise_at_construction(vla_parts, knob, arg, monkeypatch):
    serving, params, _ = _tier(vla_parts, "parity")
    tparams = convert.params_from_jax(params, convert.config_from_jax(serving.vlm), device="cpu")
    monkeypatch.setenv(knob, "1")
    with pytest.raises(ValueError, match=f"unset {knob} \\(replaced by OpenVLA.set_adapters"
                                         f"\\(\\.\\.\\., {arg}"):
        tvla.OpenVLA(tparams, convert.config_from_jax(serving), Tok(), STATS, device="cpu")


def test_infer_lora_config_matches_jax(vla_parts):
    for tree in vla_parts[2].values():
        want = jml.infer_lora_config(tree)
        got = tml.infer_lora_config(_port_lora(tree))
        assert (got.r, got.include_lm_head, got.include_embeddings, got.scaling) == (
            want.r, want.include_lm_head, want.include_embeddings, want.scaling)
    with pytest.raises(ValueError, match="no adapted leaves"):
        tml.infer_lora_config({"a": None})


@pytest.mark.parametrize("layout", ["bare", "with_opt_state"])
def test_adapter_checkpoint_round_trip(vla_parts, layout, tmp_path):
    """The port trainer's run dir (training/checkpointing.py): the latest
    step's state.pt, a bare adapter tree or {"lora": ..., "opt_state": ...};
    then a bank from two run dirs."""
    tree = _port_lora(vla_parts[2]["t1"])
    state = tree if layout == "bare" else {"lora": tree, "opt_state": {"t": torch.zeros(3)}}
    checkpointing.save_checkpoint(tmp_path / "run", state, step=3)
    checkpointing.save_checkpoint(tmp_path / "run", state, step=7)
    back = tml.load_adapter_checkpoint(tmp_path / "run")
    want, got = _flat(tree), _flat(back)
    assert want.keys() == got.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert torch.equal(want[k], got[k]), k
    bank = tml.load_adapter_bank([tmp_path / "run", tmp_path / "run"], TCFG)
    assert bank["llm"]["layers"]["q_proj"]["A"].shape[:2] == (
        tree["llm"]["layers"]["q_proj"]["A"].shape[0], 2)
