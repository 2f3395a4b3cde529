"""The port's placement rules (``openvla_probe_tpu_torch/parallel``) against
the JAX package's: `param_spec` / `shard_params` give, for every leaf, the
entries of the JAX ``PartitionSpec`` on the same mesh, and `make_mesh` the
JAX axes and errors.

The trees are shapes only: ``jax.eval_shape`` of the JAX initializers (and
quantizers) on one side, meta tensors of the same shapes on the other, int4
codes packed two a byte as the port stores them. Tiny dense, MoE (int8,
grouped int4, mix, nibble, LoRA factors, multi-LoRA banks) and Phi trees on
the four meshes of the JAX serving tests, then OpenVLA-7B, Mixtral-8x7B and
SigLIP at their published widths. The JAX side runs on the 8 virtual CPU
devices of tests/conftest.py."""

import functools

import jax
import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.parallel import mesh as tmesh
from openvla_probe_tpu_torch.parallel import sharding as tsharding

MESHES = [{"dp": 4, "fsdp": 1, "tp": 2}, {"dp": 1, "fsdp": 2, "tp": 4}, {"fsdp": 8},
          {"dp": 2, "ep": 2, "tp": 2}]
STRATEGIES = ("tp", "fsdp", "fsdp+tp")


def _meta(s) -> torch.Tensor:
    """A meta tensor of a ShapeDtypeStruct's shape (int4: packed uint8)."""
    name = np.dtype(s.dtype).name
    if name == "int4":
        return torch.empty((*s.shape[:-1], s.shape[-1] // 2), dtype=torch.uint8, device="meta")
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
          "int32": torch.int32}[name]
    return torch.empty(tuple(s.shape), dtype=dt, device="meta")


def _port_tree(tree):
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    return None if tree is None else _meta(tree)


def _flat_jax(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_jax(v, f"{prefix}/{k}" if prefix else str(k)))
    elif tree is not None:
        out[prefix] = tuple(tree.spec)
    return out


def _flat_port(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_port(v, f"{prefix}/{k}" if prefix else str(k)))
    elif tree is not None:
        out[prefix] = tuple(tree)
    return out


def _assert_specs_match(jtree, mesh_axes, strategy):
    from openvla_probe_tpu.parallel.mesh import make_mesh
    from openvla_probe_tpu.parallel.sharding import shard_params

    want = _flat_jax(shard_params(jtree, make_mesh(dict(mesh_axes)), strategy))
    got = _flat_port(tsharding.shard_params(_port_tree(jtree),
                                            tmesh.make_mesh(dict(mesh_axes), devices=8), strategy))
    assert set(got) == set(want)
    bad = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert not bad, bad
    return want


@functools.lru_cache(maxsize=None)
def _trees():
    """name -> JAX shape tree."""
    from openvla_probe_tpu.models import llama, multilora, phi, vlm
    from openvla_probe_tpu.ops.linear import TURBO_QUANT_SUFFIXES, quantize_params
    from openvla_probe_tpu.training.lora import LoRAConfig, init_lora_params

    key = jax.random.key(0)
    # widths that clear MIN_SHARD_ELEMS, so that every rule engages
    dense = vlm.VLMConfig.tiny(llm=llama.LlamaConfig.tiny(hidden_size=128, intermediate_size=256,
                                                          vocab_size=512))
    moe = vlm.VLMConfig.tiny(llm=llama.LlamaConfig.tiny(hidden_size=128, intermediate_size=256,
                                                        moe_experts=4))
    out = {}
    for name, cfg in (("dense", dense), ("moe", moe)):
        shapes = jax.eval_shape(functools.partial(vlm.init_params, cfg), key)
        out[name] = shapes
        for bits in (8, 4, "mix", "nibble"):
            out[f"{name}_{bits}"] = jax.eval_shape(
                lambda p, b=bits: quantize_params(p, TURBO_QUANT_SUFFIXES, bits=b, group_size=32),
                shapes)
        lcfg = LoRAConfig(r=8)
        lora = jax.eval_shape(lambda p: init_lora_params(p, lcfg, key), shapes)
        out[f"{name}_lora"] = lora
        out[f"{name}_bank"] = jax.eval_shape(
            lambda a, b: multilora.stack_adapter_banks([a, b], lcfg),
            *(jax.eval_shape(lambda p: init_lora_params(p, lcfg, key), shapes),) * 2)
    out["phi"] = jax.eval_shape(functools.partial(
        phi.init_params, phi.PhiConfig.tiny(hidden_size=128, intermediate_size=256)), key)
    return out


TREE_NAMES = ["dense", "dense_8", "dense_4", "dense_mix", "dense_nibble", "dense_lora",
              "dense_bank", "moe", "moe_8", "moe_4", "moe_mix", "moe_nibble", "moe_lora",
              "moe_bank", "phi"]


@pytest.mark.parametrize("tree", TREE_NAMES)
@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
def test_shard_params_match_jax(tree, mesh_i):
    for strategy in STRATEGIES:
        _assert_specs_match(_trees()[tree], MESHES[mesh_i], strategy)


def test_tiny_trees_engage_every_rule():
    """The trees above exercise the rules they are meant to: tp on out and
    contraction dims, vocab, the expert rule, grouped-int4 groups, fsdp."""
    from openvla_probe_tpu.parallel.mesh import make_mesh  # noqa: F401 (the JAX mesh is built)

    got = _flat_port(tsharding.shard_params(_port_tree(_trees()["moe_4"]),
                                            tmesh.make_mesh(MESHES[3], devices=8), "tp"))
    assert got["llm/layers/gate_proj/q"][1] == "ep"
    assert got["llm/layers/o_proj/q"] == (None, "tp", None, None)      # grouped: the G axis
    assert got["llm/embed_tokens"] == ("tp", None)
    dense = _flat_port(tsharding.shard_params(_port_tree(_trees()["dense_8"]),
                                              tmesh.make_mesh(MESHES[1], devices=8), "fsdp+tp"))
    assert "fsdp" in dense["llm/layers/q_proj/q"] and "tp" in dense["llm/layers/q_proj/q"]
    assert dense["llm/layers/o_proj/q"][2] == "tp"


def _big(name):
    from openvla_probe_tpu.models import llama, vit, vlm
    from openvla_probe_tpu.ops.linear import TURBO_QUANT_SUFFIXES, quantize_params

    key = jax.random.key(0)
    if name == "openvla_7b":
        shapes = jax.eval_shape(functools.partial(vlm.init_params, vlm.VLMConfig.openvla_7b()), key)
        return jax.eval_shape(lambda p: quantize_params(p, TURBO_QUANT_SUFFIXES), shapes)
    if name == "mixtral":
        cfg = llama.LlamaConfig(hidden_size=4096, intermediate_size=14336, num_hidden_layers=2,
                                num_attention_heads=32, num_key_value_heads=8, vocab_size=32000,
                                moe_experts=8)
        shapes = jax.eval_shape(functools.partial(llama.init_params, cfg), key)
        return {"llm": jax.eval_shape(lambda p: quantize_params(p, bits=4), shapes)}
    cfg = vit.ViTConfig.siglip_so400m()
    shapes = jax.eval_shape(functools.partial(vit.init_params, cfg), key)
    return {"vision": {"siglip": jax.eval_shape(
        lambda p: quantize_params(p, TURBO_QUANT_SUFFIXES), shapes)}}


@pytest.mark.parametrize("name", ["openvla_7b", "mixtral", "siglip"])
def test_published_widths_match_jax(name):
    tree = _big(name)
    for axes in ({"dp": 4, "fsdp": 1, "tp": 2}, {"dp": 2, "ep": 2, "tp": 2}, {"fsdp": 8}):
        for strategy in STRATEGIES:
            _assert_specs_match(tree, axes, strategy)


def test_pinned_specs():
    """The rules the JAX tests pin at 7B / Mixtral / SigLIP shapes
    (tests/test_sharded_serving.py, tests/test_moe.py), through the port."""
    m = tmesh.make_mesh({"dp": 4, "fsdp": 1, "tp": 2}, devices=8)
    spec = tsharding.param_spec
    assert spec("llm/layers/q_proj/q", (32, 4096, 4096), m, "tp") == (None, "tp", None)
    assert spec("llm/layers/q_proj/s", (32, 4096), m, "tp") == (None, "tp")
    assert spec("llm/layers/o_proj/q", (32, 4096, 4096), m, "tp") == (None, None, "tp")
    assert spec("llm/layers/o_proj/s", (32, 4096), m, "tp") == (None, None)
    assert spec("llm/lm_head/q", (32064, 4096), m, "tp") == ("tp", None)
    assert spec("llm/lm_head/s", (32064,), m, "tp") == ("tp",)
    g = dict(grouped_int4=True)
    assert spec("llm/layers/q_proj/q", (32, 32, 4096, 128), m, "tp", **g) == \
        (None, None, "tp", None)
    assert spec("llm/layers/q_proj/s", (32, 4096, 32), m, "tp", **g) == (None, "tp", None)
    assert spec("llm/layers/o_proj/q", (32, 32, 4096, 128), m, "tp", **g) == \
        (None, "tp", None, None)
    assert spec("llm/layers/o_proj/s", (32, 4096, 32), m, "tp", **g) == (None, None, "tp")
    # SigLIP's fc2 at tp = 2: the contraction 4304 splits into 2152, which the w8a8 kernels
    # take only zero-padded (place_leaf)
    assert spec("vision/siglip/blocks/fc2_w/q", (27, 1152, 4304), m, "tp") == (None, None, "tp")
    ep = tmesh.make_mesh({"dp": 2, "ep": 2, "tp": 2}, devices=8)
    assert spec("llm/layers/gate_proj/q", (8, 4, 32, 512, 128), ep, "tp", **g)[1] == "ep"
    L, E, F, D = 8, 8, 256, 64
    assert spec("llm/layers/gate_proj/q", (L, E, F, D), ep, "tp") == (None, "ep", "tp", None)
    assert spec("llm/layers/gate_proj/s", (L, E, F), ep, "tp") == (None, "ep", "tp")
    assert spec("llm/layers/down_proj/q", (L, E, D, F), ep, "tp") == (None, "ep", None, "tp")
    assert spec("llm/layers/down_proj/s", (L, E, 4096), ep, "tp") == (None, "ep", None)
    assert spec("llm/layers/up_proj/A", (L, E, 32, D), ep, "tp") == (None, "ep", None, None)
    assert spec("llm/layers/up_proj/B", (L, E, F, 32), ep, "tp") == (None, "ep", "tp", None)
    assert spec("llm/layers/down_proj/A", (L, E, 32, F), ep, "tp") == (None, "ep", None, "tp")
    assert spec("llm/layers/gate_proj/q", (L, F, D), ep, "tp") == (None, "tp", None)
    assert "tp" not in spec("llm/layers/down_proj/s", (L, 4096), ep, "tp")


@pytest.mark.parametrize("axes,n", [
    ({"dp": 4, "tp": 2}, 8), ({"dp": -1, "tp": 2}, 8), ({"fsdp": -1}, 8), (None, 8),
    ({"dp": 2, "ep": 2, "tp": 2}, 8), ({"tp": 2}, 2), ({"dp": -1, "ep": 2}, 4)])
def test_make_mesh_axes_match_jax(axes, n):
    from openvla_probe_tpu.parallel.mesh import make_mesh

    want = make_mesh(None if axes is None else dict(axes), jax.devices()[:n])
    got = tmesh.make_mesh(None if axes is None else dict(axes), devices=n)
    assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)
    # rank r sits at the JAX device array's position of device r (C order)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    base = min(d.id for d in jax.devices()[:n])
    for r in range(n):
        coords = tmesh.Mesh(got.shape, rank=r).coords
        assert ids[tuple(coords[a] for a in got.axis_names)] - base == r


@pytest.mark.parametrize("axes,n", [({"dp": -1, "tp": -1}, 8), ({"dp": -1, "tp": 3}, 8),
                                    ({"dp": 4, "tp": 4}, 8)])
def test_make_mesh_errors_match_jax(axes, n):
    from openvla_probe_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError) as want:
        make_mesh(dict(axes), jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        tmesh.make_mesh(dict(axes), devices=n)
    assert str(got.value) == str(want.value)


def test_batch_specs_match_jax():
    """data_sharding / sequence_sharding choose the JAX functions' axes,
    the fallback for a T the sp axis does not divide included."""
    from openvla_probe_tpu.parallel.mesh import data_sharding, make_mesh, sequence_sharding

    for axes in ({"dp": 4, "tp": 2}, {"fsdp": 8}, {"dp": 2, "sp": 4}, {"sp": 8}):
        jm, tm = make_mesh(dict(axes)), tmesh.make_mesh(dict(axes), devices=8)
        assert tuple(data_sharding(jm).spec) == tmesh.data_sharding(tm)
        batch = {"ids": np.zeros((8, 64)), "odd": np.zeros((8, 30)), "px": np.zeros((8, 3, 4, 4))}
        want = jax.tree.map(lambda s: tuple(s.spec), sequence_sharding(jm, batch))
        assert tmesh.sequence_sharding(tm, batch) == want


def test_place_params_slices_by_spec():
    """place_params: each leaf sliced by its spec and the rank's coordinates
    (the fused qkv by its three parts; an int8 leaf whose local contraction
    breaks the kernels' multiple of 16 zero-padded), bare where whole."""
    from openvla_probe_tpu_torch.ops.linear import quantize_weight

    g = torch.Generator().manual_seed(0)
    w = torch.randn(2, 192, 64, generator=g)
    fc2 = quantize_weight(torch.randn(2, 64, 4304, generator=g))
    tree = {"vision": {"siglip": {"blocks": {"qkv_w": w, "fc2_w": fc2, "ln": torch.ones(2, 4)}}}}
    for rank in range(2):
        m = tmesh.Mesh({"tp": 2}, rank=rank)
        local = tsharding.place_params(tree, m, "tp")["vision"]["siglip"]["blocks"]
        q = local["qkv_w"]
        assert q["parts"] == 3 and q["spec"] == (None, "tp", None)
        want = torch.cat([w[:, j * 64 + rank * 32: j * 64 + (rank + 1) * 32] for j in range(3)], 1)
        assert torch.equal(q["local"], want)
        f = local["fc2_w"]
        assert f["k_valid"] == 2152 and f["local"]["q"].shape == (2, 64, 2160)
        want_q = fc2["q"][..., rank * 2152:(rank + 1) * 2152]
        assert torch.equal(f["local"]["q"][..., :2152], want_q)
        assert not f["local"]["q"][..., 2152:].any()
        assert torch.equal(f["local"]["s"], fc2["s"])
        assert local["ln"] is tree["vision"]["siglip"]["blocks"]["ln"]


@pytest.mark.parametrize("axes,strategy,p_strategy,o_strategy", [
    ({"fsdp": 8}, "zero2", "none", "fsdp"),
    ({"dp": 1, "fsdp": 2, "tp": 4}, "zero2+tp", "tp", "fsdp+tp"),
    ({"dp": 4, "fsdp": 1, "tp": 2}, "fsdp+tp", "fsdp+tp", "fsdp+tp")])
def test_shard_train_state_matches_jax(axes, strategy, p_strategy, o_strategy):
    """shard_train_state over the port's TrainState (AdamW's OptState
    moments beside the parameters): the parameters' specs are the JAX
    package's shard_params under the strategy's parameter rule (zero2: whole,
    "zero2+tp": tp), the moments' under its optimizer rule (fsdp), the JAX
    function's mapping."""
    from openvla_probe_tpu.parallel.mesh import make_mesh
    from openvla_probe_tpu.parallel.sharding import shard_params
    from openvla_probe_tpu_torch.training.train_state import OptState, TrainState

    jtree = _trees()["dense"]
    params = _port_tree(jtree)
    moments = {k: v for k, v in params.items()}
    state = TrainState(step=0, params=params, opt_state=OptState(0, moments, moments))
    got = tsharding.shard_train_state(state, tmesh.make_mesh(dict(axes), devices=8), strategy)
    jm = make_mesh(dict(axes))
    assert got.step == ()
    assert _flat_port(got.params) == _flat_jax(shard_params(jtree, jm, p_strategy))
    want_o = _flat_jax(shard_params(jtree, jm, o_strategy))
    assert got.opt_state.count == 0
    for moment in (got.opt_state.mu, got.opt_state.nu):
        assert _flat_port(moment) == want_o
