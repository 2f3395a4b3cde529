"""The weight bytes a tensor-parallel rank gathers whole in one serving call.

    python -m openvla_probe_tpu_torch.tools.tp_gather_bytes [--tp 2] [--batch 24]
        [--action_dim 7] [--prompt_pad_len 32]

The sharded forward (``parallel.tensor_parallel``) runs a row-parallel
product on its shard only on the exact int32 route (per-channel int8 codes on
"w8a8", a nibble or mix leaf's int8 copy at prefill M). Every other
row-parallel route computes its activation scale inside its kernel, so the
leaf's K shards are all-gathered and the whole product runs on every rank;
and on the "wi8" route the towers' fused kernels take no shard, so each
block's int8 qkv / proj and fc1 / fc2 pairs are gathered whole. This counts
what one rank receives for those gathers in one call of
``models.vla.make_sharded_predict`` (strategy "tp") of OpenVLA-7B: the prefill
at M = batch x prefill length, then action_dim - 1 decode steps at M = batch,
on every layer, and each tower's blocks before the feature layer once. The
placement is `parallel.sharding.place_params`'s on meta tensors (no weights
are made, nothing runs), and the rules are the forward's own
(`tensor_parallel.exact_row`, `tensor_parallel.gathered_bytes`). Prints one
JSON object: each tier and weight form, its gathered bytes split into trunk
and towers, beside one rank's local weights."""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict

import torch

from .. import convert
from ..models import vla, vlm
from ..ops import linear as lin
from ..parallel import mesh as pmesh
from ..parallel import sharding
from ..parallel import tensor_parallel as tp

# (serving tier, weight bits): the forms the main paths serve (None: bf16)
FORMS = {"parity": ("parity", None), "pallas": ("pallas", 8), "pallas_int4": ("pallas", 4),
         "turbo": ("turbo", 8), "turbo_int4": ("turbo", 4), "turbo_nibble": ("turbo", "nibble"),
         "turbo_mix": ("turbo", "mix")}
# the tower leaf pairs one fused kernel takes on the "wi8" route (models.vit._block)
FUSED_PAIRS = (("qkv_w", "proj_w"), ("fc1_w", "fc2_w"))


def meta_params(vlm_cfg: vlm.VLMConfig, bits) -> Dict[str, Any]:
    """The weight tree of `bits` (as the main paths quantize it) as meta tensors."""
    spec = convert.vlm_param_spec(vlm_cfg, lin.TURBO_QUANT_SUFFIXES if bits else (), bits or 8)

    def walk(t):
        if isinstance(t, convert.Leaf):
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        return {k: walk(v) for k, v in t.items()}

    return walk(spec)


def _local_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if tp.is_placed(tree):
        return _local_bytes(tree["local"])
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    return 0


def gather_bytes(cfg: vla.VLAServingConfig, local: Dict[str, Any], batch: int) -> Dict[str, int]:
    """{"trunk", "towers"}: the bytes a rank receives for whole-leaf gathers
    in one call, over rank `local`'s placed tree."""
    llm = cfg.vlm.llm
    trunk = 0
    steps = ((batch * cfg.prefill_len, 1), (batch, cfg.action_dim - 1))
    for w in local["llm"]["layers"].values():
        if tp.tp_role(w) != "row":
            continue
        form = tp._form(w["local"])
        if form == "float":   # fp32 partials, SUM-reduced: no weight moves
            continue
        for M, n in steps:
            if not tp.exact_row(form, llm.int8_matmul, M):
                trunk += n * tp.gathered_bytes(w, k_only=True)   # every layer of the stack
    towers = 0
    M = batch * cfg.vlm.num_patches   # at least: each image's patches and prefix tokens
    for name, vcfg in zip(cfg.vlm.vision_names, cfg.vlm.vision):
        blocks = local["vision"][name]["blocks"]
        run = vcfg.num_layers + 1 + cfg.vlm.feature_layer_index   # blocks before the feature
        for pair in FUSED_PAIRS:
            fused = vcfg.int8_matmul == "wi8" and all(tp.int8_form(blocks[n]) for n in pair)
            for n in pair:
                w = blocks[n]
                form = tp._form(w["local"]) if tp.is_placed(w) else "float"
                if fused:
                    towers += tp.gathered_bytes(w, k_only=False) * run // vcfg.num_layers
                elif (tp.tp_role(w) == "row" and form != "float"
                      and not tp.exact_row(form, vcfg.int8_matmul, M)):
                    towers += tp.gathered_bytes(w, k_only=True) * run // vcfg.num_layers
    return {"trunk": trunk, "towers": towers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--action_dim", type=int, default=7)
    ap.add_argument("--prompt_pad_len", type=int, default=32)
    a = ap.parse_args(argv)
    mesh = pmesh.Mesh({"tp": a.tp}, rank=0)
    rows = {}
    for path, (tier, bits) in FORMS.items():
        cfg = vla.VLAServingConfig.for_tier(vlm.VLMConfig.openvla_7b(), tier,
                                            action_dim=a.action_dim,
                                            prompt_pad_len=a.prompt_pad_len)
        local = sharding.place_params(meta_params(cfg.vlm, bits), mesh, "tp")
        got = gather_bytes(cfg, local, a.batch)
        rows[path] = {**got, "total": got["trunk"] + got["towers"],
                      "local_weight_bytes": _local_bytes(local)}
    print(json.dumps({"model": "openvla-7b", "tp": a.tp, "batch": a.batch,
                      "action_dim": a.action_dim, "prompt_pad_len": a.prompt_pad_len,
                      "bytes_received_per_call": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
