"""`tools.tp_reference`: one process's QLoRA step rounded as tp = 2 ranks
round it, against the sharded step on two gloo ranks on the CPU, at the tiny
VLM in bf16 over an int8 trunk and lm_head (bench_finetune's int8 trainer:
the w8a8 STE route, remat, the plain attention), where one process's plain
step rounds differently.

The sharded step and the reference differ only in the loss's log-softmax
(vocab-parallel over the split lm_head against one softmax over the whole
vocabulary, both fp32) and in the global norm's sum order, so the loss and
grad norm are held within 1e-5 relative and every adapter leaf's first AdamW
moment (its clipped gradient) within 1e-4 relative in norm (found: loss
7.6e-8, the grad norm and every moment bit-equal). One process's plain step,
which rounds the forward's partial sums in bf16 once, is 3e-3 to 1.7e-2 from
the sharded step in each leaf's moment: its distance is asserted past the
tolerance, so that the comparison is not one any step passes.
"""

import dataclasses
import functools

import pytest
import torch

from openvla_probe_tpu_torch.models import vlm
from openvla_probe_tpu_torch.parallel import distributed as D
from openvla_probe_tpu_torch.parallel import mesh as tmesh
from openvla_probe_tpu_torch.parallel import sharding as tsharding
from openvla_probe_tpu_torch.parallel import tensor_parallel as tp
from openvla_probe_tpu_torch.tools import bench_finetune as bf
from openvla_probe_tpu_torch.tools import tp_reference
from openvla_probe_tpu_torch.training import lora as tlora
from openvla_probe_tpu_torch.training import train_state as tstate
from openvla_probe_tpu_torch.training import train_step as tstep
from openvla_probe_tpu_torch.vla.action_tokenizer import ActionCodec

R, LR = 16, 1e-3
LOSS_REL, GN_REL, MU_REL = 1e-5, 1e-5, 1e-4


def case():
    """(config, int8 base, adapters with B drawn N(0, 0.02), batch) on the CPU."""
    cfg = bf.train_config(vlm.VLMConfig.tiny(), "int8")
    cfg = dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, dtype=torch.bfloat16),
        vision=tuple(dataclasses.replace(v, dtype=torch.bfloat16) for v in cfg.vision))
    base = bf.base_params(cfg, "int8", torch.Generator().manual_seed(1), "cpu")
    lora = tlora.init_lora_params(base, tlora.LoRAConfig(r=R), torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)

    def draw(t):
        if isinstance(t, dict):
            if set(t) == {"A", "B"}:
                return {"A": t["A"], "B": torch.randn(t["B"].shape, generator=g) * 0.02}
            return {k: draw(v) for k, v in t.items()}
        return t

    batch = bf.synthetic_batch(cfg, 4, 16, 2, "cpu")
    batch["pixel_values"] = batch["pixel_values"].to(torch.bfloat16)
    return cfg, base, draw(lora), batch


def setup(cfg, base, lora, mesh=None):
    codec = ActionCodec(vocab_size=cfg.llm.vocab_size)
    opt = tstate.make_optimizer(tstate.OptimizerConfig(
        learning_rate=LR, lr_schedule_type="constant", max_steps=2, weight_decay=0.0), lora)
    state = tstate.TrainState.create(lora, opt)
    lcfg = tlora.LoRAConfig(r=R)
    vla_loss = functools.partial(tstep.vla_loss_fn, codec=codec)
    if mesh is None:
        loss_fn = tlora.make_lora_loss_fn(vla_loss, base, lcfg, stream=True)
        return tstep.make_train_step(cfg, opt, codec, loss_fn=loss_fn), state
    loss_fn = tlora.make_lora_loss_fn(vla_loss, tsharding.place_params(base, mesh, "tp"), lcfg,
                                      stream=True)
    step = tstep.make_sharded_train_step(cfg, opt, mesh,
                                         tsharding.shard_train_state(state, mesh, "tp"),
                                         tmesh.data_sharding(mesh), codec, loss_fn=loss_fn)
    return step, tstep.place_train_state(state, mesh, "tp")


def result(state, m):
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                mu=tp.local_tree(state.opt_state.mu))


def rank_step(rank, world):
    cfg, base, lora, batch = case()
    step, state = setup(cfg, base, lora, tmesh.make_mesh({"tp": world}))
    return result(*step(state, batch))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif tree is not None:
        yield path, tree


def apart(got, want, rank):
    """Relative loss and grad-norm distances, and the largest relative
    distance in norm of an adapter leaf's moment (the reference's cut to the
    rank's slice)."""
    mu = tp.local_tree(tsharding.place_params(want["mu"], tmesh.Mesh({"tp": 2}, rank=rank), "tp",
                                              _path="mu"))
    pairs = list(zip(_leaves(got["mu"]), _leaves(mu)))
    assert pairs and all(p == q for (p, _), (q, _) in pairs)
    return dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                grad_norm=abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"],
                mu=max(float((a.float() - b.float()).norm() / b.float().norm())
                       for (_, a), (_, b) in pairs))


@pytest.fixture(scope="module")
def runs():
    ranks = D.run_ranks(rank_step, 2, timeout=240.0, device="cpu")
    cfg, base, lora, batch = case()
    step, state = setup(cfg, base, lora)
    plain = result(*step(state, batch))
    with tp_reference.rounded_as_tp(base, 2) as calls:
        rounded = result(*step(state, batch))
    return ranks, plain, rounded, dict(calls)


def test_reference_takes_every_split_product_and_attention(runs):
    """The reference reached the towers' and the trunk's column- and
    row-parallel products and the plain attention (forward and the remat
    recompute)."""
    calls = runs[3]
    assert calls["col"] > 0 and calls["row"] > 0 and calls["attention"] > 0, calls


@pytest.mark.parametrize("rank", [0, 1])
def test_tp2_step_matches_the_tp_rounded_reference(runs, rank):
    ranks, plain, rounded, _ = runs
    d = apart(ranks[rank], rounded, rank)
    assert d["loss"] <= LOSS_REL and d["grad_norm"] <= GN_REL and d["mu"] <= MU_REL, d
    far = apart(ranks[rank], plain, rank)
    assert far["mu"] > MU_REL, (far, d)
