"""The port's LoRA (``training/lora.py``) vs the JAX package's, on the CPU at
tiny sizes, over bf16, per-channel int8 and grouped-int4 bases
(``tests/test_torch_int4.py::int4_vlm`` with its trunk and lm_head
quantized; the towers and projector float).

* ``init_lora_params``: the same target leaves (None elsewhere) with the
  same shapes, fp32 masters (A ~ N(0, 1) / r, B = 0; the random values differ:
  torch.Generator is not jax.random), grouped-int4 leaves counted as
  [O, G·gsz]; nibble bases raise on both sides.
* ``attach_lora``: the wrappers' products through ``matmul_t`` equal the JAX
  ``matmul_t`` on the JAX wrappers within 1e-5 relative (fp32; the int8 and
  int4 bases on their STE routes); layer-stacked wrappers slice with
  ``index_layer``.
* ``merge_lora`` / ``merge_and_unload_host``: the adapters hold small
  multiples of 2^-8, so B A is exact in fp32 in any order of the sums and
  the merged weights are the same numbers on both sides: int8 and int4 codes
  and scales bit-equal, float leaves bit-equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu.training import lora as jlora
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.ops import linear as tlin
from openvla_probe_tpu_torch.training import lora as tlora
from openvla_probe_tpu_torch.training.train_state import tree_leaves

from tests.test_torch_int4 import int4_vlm

R = 4
BASES = {"bf16": None, "int8": 8, "int4": 4}


def _is_ab(x):
    return isinstance(x, dict) and set(x) == {"A", "B"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module", params=list(BASES))
def base(request):
    bits = BASES[request.param]
    jcfg = int4_vlm()
    params = jvlm.init_params(jcfg, jax.random.key(0))
    if bits is None:
        params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    else:
        params = jlin.quantize_params(params, suffixes=jlin._DEFAULT_QUANT_SUFFIXES, bits=bits)
    tcfg = convert.config_from_jax(jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu",
                                      quant_suffixes=jlin._DEFAULT_QUANT_SUFFIXES if bits else (),
                                      bits=bits or 8)
    return request.param, params, tparams


def _exact_adapters(jlora_tree, rng):
    """Adapters of small multiples of 2^-8 (module docstring), as the JAX tree."""
    def walk(t):
        if t is None:
            return None
        if _is_ab(t):
            return {k: jnp.asarray(rng.integers(-2, 3, t[k].shape) / 256.0, jnp.float32)
                    for k in "AB"}
        return {k: walk(v) for k, v in t.items()}
    return walk(jlora_tree)


def _pairs(jtree, ttree, path=""):
    if isinstance(ttree, dict):
        assert isinstance(jtree, dict) and set(jtree) == set(ttree), path
        return [p for k in ttree for p in _pairs(jtree[k], ttree[k], f"{path}/{k}")]
    assert (jtree is None) == (ttree is None), path
    return [] if ttree is None else [(path, jtree, ttree)]


def test_init_targets_shapes_and_dtypes(base):
    kind, params, tparams = base
    want = jlora.init_lora_params(params, jlora.LoRAConfig(r=R), jax.random.key(1))
    got = tlora.init_lora_params(tparams, tlora.LoRAConfig(r=R), torch.Generator().manual_seed(1))
    pairs = _pairs(want, got)
    assert {p.rsplit("/", 2)[-2] for p, _, _ in pairs} >= {"q_proj", "down_proj", "qkv_w", "w"}
    for path, j, t in pairs:
        assert tuple(t.shape) == tuple(np.shape(j)) and t.dtype == torch.float32, path
        if path.endswith("/B"):
            assert not t.any(), path
    q = got["llm"]["layers"]["q_proj"]
    assert tuple(q["A"].shape) == (2, R, 128) and tuple(q["B"].shape) == (2, 128, R)
    assert got["llm"]["lm_head"] is None and got["llm"]["embed_tokens"] is None
    assert got["vision"]["dino"]["patch_embed"]["weight"] is None
    np.testing.assert_allclose(float(q["A"].std()), 1.0 / R, rtol=0.2)   # N(0, 1) / r


def test_nibble_base_raises():
    w = tlin.quantize_weight_nibble(torch.randn(2, 8, 16))
    with pytest.raises(NotImplementedError, match="nibble"):
        tlora.init_lora_params({"layers": {"q_proj": w}}, tlora.LoRAConfig(r=R),
                               torch.Generator().manual_seed(0))


def test_attach_matches_jax_matmul_t(base):
    """Each wrapped trunk linear of layer 1 through both matmul_t's (int8 on
    the w8a8 STE route, int4 under the kernel gate, bf16 a float product)."""
    kind, params, tparams = base
    rng = np.random.default_rng(3)
    jl = _exact_adapters(jlora.init_lora_params(params, jlora.LoRAConfig(r=R), jax.random.key(1)),
                         rng)
    tl = convert.lora_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    jw = jlora.attach_lora(params, jl, jlora.LoRAConfig(r=R))
    tw = tlora.attach_lora(tparams, tl, tlora.LoRAConfig(r=R))
    tlayer = tlin.index_layer(tw["llm"]["layers"], 1)
    assert set(tlayer["q_proj"]) == {"base", "A", "B"}
    torch.testing.assert_close(tlayer["q_proj"]["A"], tl["llm"]["layers"]["q_proj"]["A"][1])
    x = rng.normal(size=(5, 128)).astype(np.float32)
    env = {"OVLA_PALLAS": "1", "OVLA_PALLAS_INTERPRET": "1"} if kind == "int4" else {}
    route = "wi8" if kind == "int4" else "w8a8"
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        for k in [k for k in os.environ if k.startswith("OVLA_")]:
            mp.delenv(k)
        for k, v in env.items():
            mp.setenv(k, v)
        for name in ("q_proj", "gate_proj"):
            jleaf = jax.tree.map(lambda a: a[1], jw["llm"]["layers"][name])
            dt = jnp.bfloat16 if kind == "bf16" else jnp.float32
            want = _np(jlin.matmul_t(jnp.asarray(x, dt), jleaf))
            got = _np(tlin.matmul_t(torch.from_numpy(x).to(torch.bfloat16 if kind == "bf16"
                                                           else torch.float32),
                                    tlayer[name], route))
            tol = 1e-2 if kind == "bf16" else 1e-5
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_merge_matches_jax_bit_for_bit(base):
    kind, params, tparams = base
    jl = _exact_adapters(jlora.init_lora_params(params, jlora.LoRAConfig(r=R), jax.random.key(1)),
                         np.random.default_rng(4))
    tl = convert.lora_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    want = jlora.merge_lora(params, jl, jlora.LoRAConfig(r=R))
    got = tlora.merge_lora(tparams, tl, tlora.LoRAConfig(r=R))
    wq, gq = want["llm"]["layers"]["q_proj"], got["llm"]["layers"]["q_proj"]
    if kind == "int4":
        assert tlin.is_grouped_int4(gq)
        np.testing.assert_array_equal(tlin.unpack_int4(gq["q"]).numpy(), np.asarray(wq["q"],
                                                                                   np.int8))
        np.testing.assert_array_equal(gq["s"].numpy(), np.asarray(wq["s"]))
    elif kind == "int8":
        np.testing.assert_array_equal(gq["q"].numpy(), np.asarray(wq["q"]))
        np.testing.assert_array_equal(gq["s"].numpy(), np.asarray(wq["s"]))
    else:
        np.testing.assert_array_equal(_np(gq), _np(wq))
    for path in (("vision", "siglip", "blocks", "fc1_w"), ("projector", "fc2", "w")):
        w, g = want, got
        for k in path:
            w, g = w[k], g[k]
        np.testing.assert_array_equal(_np(g), _np(w), err_msg="/".join(path))
    assert got["llm"]["lm_head"] is tparams["llm"]["lm_head"]   # no adapter: the leaf as it was
    assert tlora.merge_and_unload(tparams, tl, tlora.LoRAConfig(r=R))["llm"]["layers"].keys() == \
        got["llm"]["layers"].keys()


def test_merge_and_unload_host_matches_jax(base):
    """Host export: float leaves merged and cast back; int8 and int4 bases as
    per-channel int8 (codes and scales bit-equal)."""
    kind, params, tparams = base
    jl = _exact_adapters(jlora.init_lora_params(params, jlora.LoRAConfig(r=R), jax.random.key(1)),
                         np.random.default_rng(5))
    tl = convert.lora_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    want = jlora.merge_and_unload_host(params, jl, jlora.LoRAConfig(r=R))
    got = tlora.merge_and_unload_host(tparams, tl, tlora.LoRAConfig(r=R))
    for name in ("q_proj", "down_proj"):
        w, g = want["llm"]["layers"][name], got["llm"]["layers"][name]
        if kind == "bf16":
            np.testing.assert_array_equal(_np(g), _np(w))
            continue
        assert tlin.is_int8_per_channel(g), name
        np.testing.assert_array_equal(g["q"].numpy(), np.asarray(w["q"]))
        np.testing.assert_array_equal(g["s"].numpy(), np.asarray(w["s"]))
    assert all(t.device.type == "cpu" for t in tree_leaves(got))
