"""Expert parallelism and sharded multi-LoRA serving on the CPU, each rank a
gloo process, against the JAX package on the same mesh and the port's
one-process run.

* A tiny Mixtral VLA (4 experts, top-2) at dp = 2 x ep = 2: greedy tokens
  equal to the JAX package's sharded and one-device runs and to the port's
  one process. The MoE trunk alone at ep = 2 (each rank two experts, the
  router whole, every rank routing all tokens): its output bit-equal to the
  one-process trunk, for the sorted (dropless) and the einsum (capacity)
  dispatch, in fp32 and bf16 (a top-2 output has at most two non-zero
  terms in the combine's SUM).
* Multi-LoRA over a float and an int8 base at tp = 2, four random adapters
  and a bare row: tokens equal to the JAX package's
  `make_sharded_multilora_predict` and to the port's one process (the int8
  base margin-limited, the repo's rule)."""

import dataclasses

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import multilora as tml
from openvla_probe_tpu_torch.parallel import distributed as D
from openvla_probe_tpu_torch.parallel import mesh as tmesh
from openvla_probe_tpu_torch.parallel import sharding as tsharding
from openvla_probe_tpu_torch.parallel import tensor_parallel as tp
from test_torch_parallel_serving import (inputs, jax_call, jax_np, jax_setup, port_call,
                                         port_config, sharded, to_port)


def test_sharded_moe_vla_tokens():
    jserving, jparams = jax_setup({"moe_experts": 4})
    params = to_port(jax_np(jparams))
    serving = port_config(jserving)
    args = inputs()
    mesh = {"dp": 2, "ep": 2}
    want = jax_call(jparams, jserving, args)
    jsh = jax_call(jparams, jserving, args, mesh, "tp", n=4)
    one = port_call(params, serving, args)
    got = sharded(params, serving, args, mesh, "tp")
    for other in (want, jsh, one):
        np.testing.assert_array_equal(got["action_tokens"], other["action_tokens"])
    local = tsharding.place_params(params, tmesh.Mesh(mesh, rank=1), "tp")
    assert tp.ep_range(tp.index_layer(local["llm"]["layers"], 0)["gate_proj"])[:2] == (2, 2)


def _trunk_rank(rank, world, params, cfg, x, mask):
    mesh = tmesh.make_mesh({"ep": world})
    local = tp.resolve_tree(tsharding.place_params({"llm": params}, mesh, "tp"))["llm"]
    B, T, _ = x.shape
    pos = torch.arange(T).expand(B, T)
    D.reset_collective_counts()
    out = tllama.forward(local, cfg, x, mask, pos, compute_logits=False)["last_hidden_state"]
    return out, dict(D.COLLECTIVE_CALLS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_ep_trunk_bit_equal(dtype, capacity_factor):
    """The ep = 2 trunk's output is bit-equal to one process: the sorted
    dispatch at capacity factor 2 (dropless), the einsum one at 0.5."""
    from openvla_probe_tpu_torch import convert

    cfg = tllama.LlamaConfig.tiny(moe_experts=4, num_hidden_layers=2, dtype=dtype,
                                  moe_capacity_factor=capacity_factor)
    g = torch.Generator().manual_seed(7)
    params = convert.init_params(_vlm_of(cfg), g, device="cpu")["llm"]
    x = (torch.randn(3, 11, cfg.hidden_size, generator=g) * 0.5).to(dtype)
    mask = torch.ones(3, 11, dtype=torch.int32)
    mask[1, 8:] = 0
    pos = torch.arange(11).expand(3, 11)
    want = tllama.forward(params, cfg, x, mask, pos, compute_logits=False)["last_hidden_state"]
    res = D.run_ranks(_trunk_rank, 2, (params, cfg, x, mask), timeout=120, device="cpu")
    for out, calls in res:
        assert torch.equal(out, want)
        # one combine SUM a layer (sorted dispatch), or one gather of the slot outputs (einsum)
        combine = "all_reduce" if capacity_factor >= 2 else "all_gather"
        assert calls == {combine: cfg.num_hidden_layers}


def _vlm_of(llm_cfg):
    from openvla_probe_tpu_torch.models import vlm

    return dataclasses.replace(vlm.VLMConfig.tiny(), llm=llm_cfg)


def _rand_bank(jparams, seed):
    import jax
    import jax.numpy as jnp

    from openvla_probe_tpu.models import multilora
    from openvla_probe_tpu.training import lora

    lcfg = lora.LoRAConfig(r=8, include_lm_head=True)
    trees = []
    for i in range(4):
        tree = lora.init_lora_params(jparams, lcfg, jax.random.key(seed + i))
        leaves, treedef = jax.tree_util.tree_flatten(tree, is_leaf=lora._is_ab)
        keys = jax.random.split(jax.random.key(seed + 1000 + i), len(leaves))
        trees.append(jax.tree_util.tree_unflatten(treedef, [
            None if leaf is None else
            {"A": leaf["A"], "B": jax.random.normal(k, leaf["B"].shape, jnp.float32) * 0.05}
            for leaf, k in zip(leaves, keys)]))
    return multilora.stack_adapter_banks(trees, lcfg)


@pytest.mark.parametrize("bits,n_tokens", [(None, 20), (8, 16)])
def test_sharded_multilora_tokens(bits, n_tokens):
    import functools

    import jax
    import jax.numpy as jnp

    from openvla_probe_tpu.models import multilora, vla
    from openvla_probe_tpu.ops import image as jimage
    from openvla_probe_tpu.ops.linear import quantize_params
    from openvla_probe_tpu.parallel.mesh import make_mesh
    from test_torch_parallel_serving import img_cfg
    from test_torch_turbo_kv8 import assert_tokens

    jserving, jparams = jax_setup()
    if bits:
        jparams = {**jparams, "llm": quantize_params(jparams["llm"], bits=bits)}
    bank = _rand_bank(jparams, 50)
    args = inputs()
    jsel = multilora.adapter_one_hot(np.array([0, 3, -1, 2]), 4)

    def serve(p, bk, s, image_u8, *rest, **kw):
        return vla.predict_action_from_image(multilora.attach_multilora(p, bk, s), jserving,
                                             image_u8, img_cfg(jimage), *rest, **kw)

    want = jax.tree.map(np.asarray, jax.jit(functools.partial(serve, return_first_logits=True))(
        jparams, bank, jsel, *map(jnp.asarray, args)))
    mesh = {"tp": 2}
    call, sp, sb = vla.make_sharded_multilora_predict(jparams, bank, jserving,
                                                      make_mesh(mesh, jax.devices()[:2]),
                                                      image_cfg=img_cfg(jimage), strategy="tp")
    jsh = jax.tree.map(np.asarray, call(sp, sb, jsel, *args))

    params, tbank = to_port(jax_np(jparams)), to_port(jax_np(bank))
    serving = port_config(jserving, int8_route=bits is not None)
    sel = torch.from_numpy(np.array(jsel))
    one = port_call(tml.attach_multilora(params, tbank, sel), serving, args,
                    return_first_logits=True)
    got = sharded(params, serving, args, mesh, "tp", bank=tbank, sel=sel)
    gap = float(np.abs(one["first_logits"] - want["first_logits"]).max())
    for other in (want, jsh, one):
        assert assert_tokens(got["action_tokens"], other["action_tokens"],
                             want["logit_margins"], gap) == n_tokens
    # the bank is placed with its base: down_proj's A on tp (row), up_proj's Bt (column);
    # o_proj's factors are under MIN_SHARD_ELEMS, whole beside a split base
    lb = tsharding.place_params(tbank, tmesh.Mesh(mesh, rank=0), "tp")["llm"]["layers"]
    assert tp.is_placed(lb["down_proj"]["A"]) and tp.is_placed(lb["up_proj"]["Bt"])
    assert not tp.is_placed(lb["o_proj"]["A"])
