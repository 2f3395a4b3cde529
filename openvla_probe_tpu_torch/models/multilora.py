"""Multi-adapter LoRA serving: N finetuned adapters over ONE frozen base in
one batched call (counterpart of ``openvla_probe_tpu/models/multilora.py``).

The reference serves one merged finetuned checkpoint per process, so a fleet
of robots finetuned per task costs one full model per task. Here the
(possibly quantized) base is resident once, every task's LoRA adapters are
stacked into banks (A [N, r, I] and Bt [N, r, O] per target weight, B
pre-transposed with the alpha / r scale folded in), and each request row
picks its adapter through a one-hot ``sel`` [B, N], so one call mixes tasks
freely. ``ops.linear.matmul_t`` computes a masked wrapper as

    u     = x · A_bankᵀ          # one [B·T, K] x [K, N·r] product
    u    *= repeat(sel, r)       # zero the unselected rank columns
    delta = u · Bt_bank          # one [B·T, N·r] x [N·r, O] product

never a per-row gather of weight copies. Masking zeroes the unselected
columns exactly (their terms are 0 · w), so row b computes the same function
as single-adapter streamed LoRA (``training.lora.attach_lora``) of adapter
sel[b]; the bits differ by the order of the sums.

`fuse_bank_into_base` is the fused install: each A bank's N·r rows are
concatenated onto the base weight's output rows once (int8-quantized per row
for an int8 base), so a target's base and rank projections are one widened
product whose first O columns are the plain base leaf's, bit for bit, on the
int8 routes. It returns a new tree and never changes the caller's.

Works over every base form ``matmul_t`` serves (bf16, int8, grouped int4,
mix, nibble) in the masked form; the fused form takes int8 and float bases.
Not compatible with ``llama.fuse_serving_params`` (the banks target the
unfused leaves).

The adapters come from the port trainer's run dirs (`load_adapter_checkpoint`:
``training/checkpointing.py``'s ``state.pt``, a bare adapter tree or
``{"lora": ...}``); an adapter the JAX package wrote with orbax comes across
through ``convert.lora_from_jax``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.linear import (MULTILORA_IMPLS, is_grouped_int4, is_mixed_quant, is_nibble_quant,
                          quantize_weight)
from ..training.lora import LoRAConfig, _is_ab

Params = Dict[str, Any]
_FUSE_BASES = ("fuse_bank_into_base supports int8 and bf16 bases only "
               "(multi-LoRA's deployment base; mix/int4 bases OOM or "
               "lack a widened-dot form)")


def stack_adapter_banks(
    adapters: Sequence[Any],
    cfg: LoRAConfig,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Any:
    """Stack N per-adapter LoRA trees (``init_lora_params`` layout: {"A",
    "B"} at target leaves, None elsewhere) into serving banks, on `device`
    (the adapters' own without one).

    A leaves [*, r, I] stack to [*, N, r, I]; B leaves [*, O, r] are
    transposed, scaled by alpha / r in fp32 and stack to "Bt" [*, N, r, O]
    (axis -3: the layer-stacked Llama leaves [L, ...] and flat leaves alike),
    then cast to the serving `dtype` (adapters train as fp32 masters)."""
    if not adapters:
        raise ValueError("need at least one adapter")
    scale = cfg.scaling

    def on(t):
        return t if device is None else t.to(device)

    def stack(nodes):
        if nodes[0] is None or any(n is None for n in nodes):
            if any(n is not None for n in nodes):
                raise ValueError("adapters disagree on target leaves — all "
                                 "banks must come from the same LoRAConfig")
            return None
        if _is_ab(nodes[0]):
            A = torch.stack([on(n["A"]) for n in nodes], dim=-3).to(dtype)
            Bt = torch.stack([on(n["B"]).float().transpose(-1, -2) * scale
                              for n in nodes], dim=-3).to(dtype)
            return {"A": A, "Bt": Bt}
        if any(not isinstance(n, dict) or set(n) != set(nodes[0]) for n in nodes):
            raise ValueError("adapters disagree on target leaves — all "
                             "banks must come from the same LoRAConfig")
        return {k: stack([n[k] for n in nodes]) for k in nodes[0]}

    return stack(list(adapters))


def _is_bank(x) -> bool:
    """A bank-tree leaf: {"A": [*, N, r, I], "Bt": [*, N, r, O]} or None."""
    return x is None or (isinstance(x, dict) and set(x.keys()) == {"A", "Bt"})


def _zip(fn, bank: Any, params: Any) -> Any:
    """fn(bank leaf, param leaf) at each bank leaf (a quantized base whole)."""
    if _is_bank(bank):
        return fn(bank, params)
    return {k: _zip(fn, bank[k], params[k]) if k in bank else params[k] for k in params}


def _sel_for(sel: torch.Tensor, lead) -> torch.Tensor:
    """`sel` broadcast over a leaf's leading model-stack dims (a view), so a
    layer-stacked wrapper slices with ``index_layer`` as the base does."""
    return sel if not lead else sel.expand(*lead, *sel.shape)


def attach_multilora(params: Params, bank: Any, sel: torch.Tensor,
                     impl: str = "masked") -> Params:
    """Wrap target leaves as {"base", "A", "Bt", "sel"} for `matmul_t`.

    `sel` [B, N] is the per-row one-hot (`adapter_one_hot`), broadcast to
    [L, B, N] on layer-stacked leaves. Cheap (views): made per call. `impl`
    "einsum" (the JAX package's ``OVLA_MULTILORA_IMPL=einsum``) adds
    ``"impl": "einsum"`` to each wrapper: sel folded into one contraction
    instead of the masked rank columns' second product."""
    if impl not in MULTILORA_IMPLS:
        raise ValueError(f"multi-LoRA impl must be one of {MULTILORA_IMPLS}, got {impl!r}")
    opt = {} if impl == "masked" else {"impl": impl}

    def attach(bw, w):
        if bw is None:
            return w
        A = bw["A"]
        return {"base": w, "A": A, "Bt": bw["Bt"], "sel": _sel_for(sel, A.shape[:-3]), **opt}

    return _zip(attach, bank, params)


def _unsupported(w) -> bool:
    return isinstance(w, dict) and (is_nibble_quant(w) or is_mixed_quant(w) or is_grouped_int4(w)
                                    or ("q" in w and w["q"].dtype != torch.int8))


def fuse_bank_into_base(params: Params, bank: Any) -> Params:
    """Concat-fuse the A banks onto the base weights once (at install, not
    per call), so serving runs one widened product per target instead of the
    base product and a separate rank projection.

    int8 bases {"q": [*, O, I], "s": [*, O]}: each A leaf's N·r rank rows are
    quantized per row (``ops.linear.quantize_weight``, the base's rule) and
    concatenated onto the output rows: {"qf": [*, O + N·r, I], "sf": [*, O +
    N·r], "Bt": [*, N, r, O]}. Float bases concatenate the A rows as they
    are: {"wf": [*, O + N·r, I], "Bt"}. The first O output rows of the
    widened int8 product are the plain base leaf's bit for bit (an exact
    int32 sum per output, then a per-element epilogue); the rank projection
    becomes the base's int8 product (a small perturbation of the delta).
    A bare-base row of a call over the fused tree is therefore the base on
    the routes a wrapped leaf takes, not the plain tier's call: a wrapped
    leaf stands the fused RMSNorm -> int8 kernel and the fused tower
    kernels down, as in the JAX package.

    Mix, grouped-int4 and nibble bases raise NotImplementedError, checked
    over the whole tree before anything is built. Returns a new tree: the
    caller's is never changed. The JAX package's ``free_source`` (deleting
    the base buffers as the walk goes, for a 16 GB chip) has no counterpart:
    the base frees when the caller drops its tree."""
    bad = []
    _zip(lambda bw, w: bad.append(bw is not None and _unsupported(w)), bank, params)
    if any(bad):
        raise NotImplementedError(_FUSE_BASES)

    def fuse(bw, w):
        if bw is None:
            return w
        A, Bt = bw["A"], bw["Bt"]                  # [*, N, r, I], [*, N, r, O]
        nr = A.shape[-3] * A.shape[-2]
        A2 = A.reshape(*A.shape[:-3], nr, A.shape[-1])
        if isinstance(w, dict):
            qa = quantize_weight(A2.float())
            return {"qf": torch.cat([w["q"], qa["q"]], dim=-2),
                    "sf": torch.cat([w["s"], qa["s"].to(w["s"].dtype)], dim=-1),
                    "Bt": Bt}
        return {"wf": torch.cat([w, A2.to(w.dtype)], dim=-2), "Bt": Bt}

    return _zip(fuse, bank, params)


def _is_fused(x) -> bool:
    return isinstance(x, dict) and ("qf" in x or "wf" in x) and "Bt" in x


def attach_multilora_fused(fused_params: Params, sel: torch.Tensor,
                           grouped: bool = False) -> Params:
    """Add the per-row one-hot `sel` to every fused leaf (broadcast over the
    leading model-stack dims, as `attach_multilora`). `grouped` (the JAX
    package's ``OVLA_MULTILORA_GROUPED=1``) adds ``"grouped": True``, so
    `ops.linear.matmul_t_grouped` batches the second products of same-input
    leaves (q/k/v, gate/up) into one ``torch.bmm``."""
    opt = {"grouped": True} if grouped else {}

    def walk(w):
        if _is_fused(w):
            return {**w, "sel": _sel_for(sel, w["Bt"].shape[:-3]), **opt}
        if isinstance(w, dict):
            return {k: walk(v) for k, v in w.items()}
        return w

    return walk(fused_params)


def adapter_one_hot(
    adapter_ids: Union[int, Sequence[int], np.ndarray, torch.Tensor],
    n_adapters: int,
    batch: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """[B] adapter indices -> [B, N] one-hot selection rows on `device`.

    A scalar id broadcasts over `batch`. Index -1 (any index outside [0, N))
    selects no adapter, a zero row: that request row serves the bare base."""
    ids = torch.as_tensor(np.asarray(adapter_ids) if not isinstance(adapter_ids, torch.Tensor)
                          else adapter_ids, dtype=torch.int64, device=device)
    if ids.dim() == 0:
        if batch is None:
            raise ValueError("scalar adapter id needs `batch`")
        ids = ids.expand(batch)
    if ids.dim() != 1:
        raise ValueError(f"adapter_ids must be a scalar or [B], got {tuple(ids.shape)}")
    return (ids[:, None] == torch.arange(n_adapters, device=ids.device)[None, :]).to(dtype)


def infer_lora_config(tree: Any) -> LoRAConfig:
    """The LoRAConfig a saved adapter tree was trained with (rank from the A
    factors; lm_head / embedding targeting from which leaves are adapted).
    Only `scaling` matters for serving: alpha keeps the reference default
    rule min(r, 16)."""
    found = {"r": None, "lm": False, "emb": False}

    def walk(node, name):
        if node is None:
            return
        if _is_ab(node):
            found["r"] = int(node["A"].shape[-2])
            found["lm"] = found["lm"] or name in ("lm_head", "lm_head_w")
            found["emb"] = found["emb"] or name == "embed_tokens"
            return
        for k, v in node.items():
            walk(v, k)

    walk(tree, "")
    if found["r"] is None:
        raise ValueError("adapter tree has no adapted leaves")
    return LoRAConfig(r=found["r"], include_lm_head=found["lm"], include_embeddings=found["emb"])


def load_adapter_checkpoint(path: Union[str, Path]) -> Any:
    """The LoRA tree of a finetune run dir (its latest checkpoint) or of one
    checkpoint dir, on the CPU: a bare adapter tree, or the trainer's
    {"lora": ..., "opt_state": ...} pair (the Adam moments dropped)."""
    from ..training.checkpointing import latest_checkpoint, load_checkpoint

    p = Path(path)
    tree = load_checkpoint(latest_checkpoint(p) or p)
    return tree["lora"] if isinstance(tree, dict) and "lora" in tree else tree


def load_adapter_bank(
    paths: Sequence[Union[str, Path]],
    cfg: LoRAConfig,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Any:
    """Load N finetune-run adapter checkpoints and stack them into banks."""
    return stack_adapter_banks([load_adapter_checkpoint(p) for p in paths], cfg, dtype=dtype,
                               device=device)
