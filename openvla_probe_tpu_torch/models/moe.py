"""Sparse mixture-of-experts SwiGLU FFN of a Mixtral-style trunk (counterpart
of ``openvla_probe_tpu/models/moe.py``).

Routing follows HF Mixtral: router logits in full fp32 (the package keeps TF32
off: the argmax is precision-sensitive), a softmax over all experts, the top-k
experts by an iterative argmax (the first index wins a tie), the selected
probabilities renormalized to sum 1; each expert is a SwiGLU FFN
down(silu(gate(x)) · up(x)) with the silu in fp32. Two dispatches, as in the
JAX package:

* `moe_ffn`: the GShard one-hot dispatch with a static capacity C per expert
  (tokens past it are dropped), in plain PyTorch einsums, as XLA computes it
  outside any kernel; quadratic in tokens at dropless capacity.
* `moe_ffn_sorted`: dropless and linear in tokens: the K·S (token, expert)
  assignments sorted stably by expert (k-major flat ids), each projection one
  grouped product over the expert-contiguous rows (`ops.expert_ragged`, a
  hand kernel on the card), and the gated rows combined per token in the
  sorted order by a gather over the inverse permutation (no atomics: the JAX
  package adds them into a zero tensor in that order).

Layer-stacked params (the leading L axis indexed away by the caller):
router [E, D]; gate_proj / up_proj [E, F, D]; down_proj [E, D, F], each a
float stack or a quantized / LoRA-wrapped leaf (`ops.expert_ragged` forms).

Expert parallelism (`parallel.sharding`'s expert rule: placed expert stacks
holding E / ep experts, the router whole): every ep rank routes all tokens
and runs its own experts only, each on that expert's rows. The sorted
dispatch SUM-reduces its combine's partials (zero for the other ranks'
experts) over ep in the combine's dtype: with top-2 an output has at most
two non-zero terms, so one rounding, as in one process. The einsum
dispatch's combine is one fp32 contraction over every expert's slots, whose
order of terms a partial sum would change: its slot outputs are all-gathered
over ep and the combine runs whole.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.expert_ragged import expert_ragged
from ..ops.linear import dequantize_weight, is_grouped_int4, is_lora_wrapped, is_quantized
from ..parallel import distributed as dist_
from ..parallel import tensor_parallel as tp

Params = Dict[str, Any]


def capacity(moe_experts: int, moe_top_k: int, capacity_factor: float, n_tokens: int) -> int:
    """Static slots an expert: ceil(K·S·cf / E), capped at S (a token picks K
    distinct experts), so a large capacity factor is the dropless mode."""
    c = math.ceil(moe_top_k * n_tokens * capacity_factor / moe_experts)
    return max(1, min(n_tokens, c))


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with b cast to a's dtype, computed in fp32 (full fp32, no
    TF32), one cast to a's dtype."""
    return torch.einsum(eq, a.float(), b.to(a.dtype).float()).to(a.dtype)


def _expert_einsum(eq: str, x: torch.Tensor, w: Any) -> torch.Tensor:
    """An expert-stacked einsum over plain, weight-only-int8 (the codes cast
    to x's dtype, the product in fp32, the per-channel scales on the
    [E, C, O] result, one cast), grouped-int4 (dequantized per use) or
    streamed-LoRA weights (base + (x Aᵀ) Bᵀ)."""
    if is_lora_wrapped(w):
        y = _expert_einsum(eq, x, w["base"])
        t = _einsum("ecx,erx->ecr", x, w["A"])
        return y + _einsum("ecr,eor->eco", t, w["B"])
    if is_grouped_int4(w):
        return _einsum(eq, x, dequantize_weight(w, x.dtype))
    if is_quantized(w):
        acc = torch.einsum(eq, x.float(), w["q"].float())
        return (acc * w["s"][:, None, :]).to(x.dtype)
    return _einsum(eq, x, w)


def _route(lp: Params, x: torch.Tensor, top_k: int):
    """x [S, D] -> (idx_k [K, S] long, gate_k [K, S] fp32 renormalized,
    probs [S, E] fp32, logits [S, E] fp32)."""
    E = lp["router"].shape[0]
    logits = torch.matmul(x.float(), lp["router"].float().t())
    probs = torch.softmax(logits, dim=-1)
    masked = probs
    idxs, gates = [], []
    for _ in range(top_k):
        idx = masked.argmax(-1)
        gates.append(masked.gather(-1, idx[:, None])[:, 0])
        idxs.append(idx)
        masked = masked * (1.0 - F.one_hot(idx, E).to(probs.dtype))
    idx_k, gate_k = torch.stack(idxs), torch.stack(gates)
    gate_k = gate_k / torch.clamp(gate_k.sum(0, keepdim=True), min=1e-9)
    return idx_k, gate_k, probs, logits


def _counts(idx: torch.Tensor, E: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.bincount(idx, weights, minlength=E)`` for ids in [0, E) without
    its host sync (bincount reads max(idx) on the host): int32 counts, or the
    fp32 sums of 0/1 weights (exact in any order)."""
    if weights is None:
        return torch.zeros(E, dtype=torch.int32, device=idx.device).index_add_(
            0, idx, torch.ones_like(idx, dtype=torch.int32))
    return torch.zeros(E, dtype=torch.float32, device=idx.device).index_add_(
        0, idx, weights.float())


def _aux_losses(idx_k: torch.Tensor, probs: torch.Tensor, logits: torch.Tensor,
                valid: Optional[torch.Tensor], E: int, top_k: int) -> torch.Tensor:
    """fp32 [2]: the load-balance loss E · Σ_e f_e · P_e (1 at perfect
    balance) and the router z-loss mean(logsumexp(logits)²), both over valid
    tokens only (`valid` [S] 0/1, or None for all)."""
    S = probs.shape[0]
    z = torch.logsumexp(logits, dim=-1) ** 2
    if valid is None:
        n_tok = float(S)
        f = _counts(idx_k.reshape(-1), E).float() / (n_tok * top_k)
        p = probs.mean(0)
        z_loss = z.mean()
    else:
        n_tok = torch.clamp(valid.sum(), min=1.0)
        f = _counts(idx_k.reshape(-1), E, valid.repeat(top_k)) / (n_tok * top_k)
        p = (probs * valid[:, None]).sum(0) / n_tok
        z_loss = (z * valid).sum() / n_tok
    return torch.stack([E * torch.sum(f * p), z_loss])


def moe_ffn(lp: Params, h: torch.Tensor, *, top_k: int, capacity: int,
            token_valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-hot dispatch with capacity drops: h [B, T, D] -> ([B, T, D],
    fp32 [2] aux). Slots are claimed in arrival order, every rank-0 choice
    before any rank-1; PAD tokens (`token_valid` 0) claim no slot and leave
    the aux statistics."""
    B, T, D = h.shape
    S = B * T
    E = lp["router"].shape[0]
    x = h.reshape(S, D)
    valid = None if token_valid is None else token_valid.reshape(S).float()
    idx_k, gate_k, probs, logits = _route(lp, x, top_k)

    sel = F.one_hot(idx_k, E).int()                                 # [K, S, E]
    if valid is not None:
        sel = sel * valid.int()[None, :, None]
    flat = sel.reshape(top_k * S, E)
    slot = (torch.cumsum(flat, dim=0) - flat).reshape(top_k, S, E)
    slot_k = (slot * sel).sum(-1)                                   # [K, S]
    keep = slot_k < capacity

    cdt = h.dtype
    de = sel.to(cdt) * keep.to(cdt)[..., None]                      # [K, S, E]
    slot_oh = F.one_hot(torch.clamp(slot_k, max=capacity), capacity + 1)[..., :capacity].to(cdt)
    dispatch = torch.einsum("kse,ksc->sec", de, slot_oh)
    combine = torch.einsum("kse,ksc->sec", de * gate_k.to(cdt)[..., None], slot_oh)

    xin = _einsum("sec,sd->ecd", dispatch, x)                       # [E, C, D]
    ep = tp.ep_range(lp["gate_proj"])
    gw, uw, dw = (tp.ep_local(lp[k]) if ep else lp[k]
                  for k in ("gate_proj", "up_proj", "down_proj"))
    if ep:   # this rank's experts
        xin = xin[ep[0]:ep[0] + ep[1]]
    g = _expert_einsum("ecd,efd->ecf", xin, gw)
    u = _expert_einsum("ecd,efd->ecf", xin, uw)
    act = F.silu(g.float()).to(cdt) * u
    y_e = _expert_einsum("ecf,edf->ecd", act, dw)                   # [E, C, D]
    if ep:   # every expert's slots, for the combine as one process computes it
        y_e = dist_.all_gather(y_e, 0, ep[2])
    y = _einsum("sec,ecd->sd", combine, y_e)
    return y.reshape(B, T, D), _aux_losses(idx_k, probs, logits, valid, E, top_k)


def moe_ffn_sorted(lp: Params, h: torch.Tensor, *, top_k: int,
                   token_valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropless sorted dispatch: h [B, T, D] -> ([B, T, D], fp32 [2]
    aux), the same routing and math as `moe_ffn` at capacity >= S. PAD
    tokens keep their rows but their gates are zeroed. Three grouped
    products (gate, up, down) over the K·S expert-sorted rows, their group
    sizes on the device; each token's K gated rows summed in the sorted order
    (by expert), the first one exact, as the JAX package's adds into zeros."""
    B, T, D = h.shape
    S = B * T
    E = lp["router"].shape[0]
    cdt = h.dtype
    x = h.reshape(S, D)
    valid = None if token_valid is None else token_valid.reshape(S).float()
    idx_k, gate_k, probs, logits = _route(lp, x, top_k)
    if valid is not None:
        gate_k = gate_k * valid[None, :]

    e_flat = idx_k.reshape(-1)                                      # [K·S], k-major
    order = torch.argsort(e_flat, stable=True)
    tok = order % S                                                 # t_flat[order]
    gates = gate_k.reshape(-1)[order]
    group_sizes = _counts(e_flat, E)

    xs = x[tok]
    ep = tp.ep_range(lp["gate_proj"])
    if ep:
        y_s = _local_experts(lp, xs, group_sizes, ep)
    else:
        g = expert_ragged(xs, lp["gate_proj"], group_sizes)
        u = expert_ragged(xs, lp["up_proj"], group_sizes)
        act = F.silu(g.float()).to(cdt) * u
        y_s = expert_ragged(act, lp["down_proj"], group_sizes)
    y_s = y_s * gates.to(cdt)[:, None]

    # each token's K rows in sorted order: their sorted positions, ascending
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    pos = inv.reshape(top_k, S).sort(dim=0).values                  # [K, S]
    y = y_s[pos[0]]
    for k in range(1, top_k):
        y = y + y_s[pos[k]]
    if ep:   # the other ranks' experts' terms
        y = dist_.all_reduce(y, "sum", ep[2])
    return y.reshape(B, T, D), _aux_losses(idx_k, probs, logits, valid, E, top_k)


def _local_experts(lp: Params, xs: torch.Tensor, group_sizes: torch.Tensor, ep) -> torch.Tensor:
    """The expert FFN of this ep rank's experts [e0, e0 + n) on their rows of
    the expert-sorted xs [K·S, D], zero on every other row: the rows rotated
    so that the rank's come first (the offset stays on the device), the three
    grouped products over the local group sizes (rows past their sum come
    out 0; the row count, and so the kernel route, is the whole call's), and
    rotated back."""
    e0, n, _ = ep
    M = xs.shape[0]
    start = torch.cumsum(group_sizes, 0)[e0 - 1] if e0 else 0
    idx = (torch.arange(M, device=xs.device) + start) % M
    gs = group_sizes[e0:e0 + n]
    xl = xs[idx]
    g = expert_ragged(xl, tp.ep_local(lp["gate_proj"]), gs)
    u = expert_ragged(xl, tp.ep_local(lp["up_proj"]), gs)
    act = F.silu(g.float()).to(xs.dtype) * u
    yl = expert_ragged(act, tp.ep_local(lp["down_proj"]), gs)
    y = torch.empty_like(yl)
    y[idx] = yl
    return y
