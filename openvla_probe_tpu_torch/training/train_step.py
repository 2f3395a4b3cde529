"""The VLA / VLM train step: masked next-token loss, action metrics, the
optimizer update (counterpart of ``openvla_probe_tpu/training/train_step.py``).

Loss semantics are the reference's: next-token cross entropy with
IGNORE_INDEX (-100) masking, so the loss lands only on the action tokens and
the stop token; action accuracy and the continuous L1 over positions whose
label is past ``codec.action_token_begin_idx``. The step differentiates the
loss with ``torch.autograd.grad`` with respect to the trained tree's float
leaves only (a frozen base passed beside it stays out of the graph's
leaves), masks frozen leaves' gradients and updates, and applies the update
in fp32.

``make_sharded_train_step`` is the step over a rank mesh, one process a rank
(the JAX function's signature; its strategies tp, fsdp, fsdp+tp, zero2 and
zero2+tp, with dp and sp by mesh axis). Every rank calls it with its local
state (`place_train_state`) and the whole batch:

* **Rows and tokens.** The rank takes the rows its batch axes give it (dp);
  under sp it builds its rows' multimodal inputs whole, shifts the labels
  over the whole spliced sequence, and runs the trunk on its contiguous
  token slice (``llama.forward``'s `seq_group`: K / V all-gathered over sp).
* **One loss.** Each rank's loss is its NLL sum over the global batch's
  valid-label count (SUM all-reduced over the axes that split the data, never
  a mean of means), over a vocab-sharded lm_head a vocab-parallel log-softmax
  (``tensor_parallel.token_nll``); it is divided by the data axes' ranks that
  hold the same rows and tokens, so that the rank losses over the data axes
  (every axis but tp) sum to the global loss.
* **Gradients.** The placed leaves' collectives are differentiable
  (``parallel.tensor_parallel``): a leaf tp splits keeps its local gradient,
  an fsdp-gathered one comes back to its shard through the gather's
  reduce-scatter, and each leaf's gradient is then SUM all-reduced over the
  data axes that do not split it (dp, sp, fsdp for a whole leaf).
* **Update.** AdamW on each rank's shard of every leaf, the layout of the
  moments (`state_specs`): under zero2 the parameters stay whole (or
  tp-split) and the moments are fsdp shards, so the rank updates its shard of
  each leaf and all-gathers the new parameters. The clip reads the global
  norm: each leaf's squared norm summed over the shards it is split into,
  then one sqrt. Metrics (loss, action accuracy, L1, grad norm) are the
  global batch's; ``per_example`` comes back for every row.

Not ported (ROADMAP Queue 1 item 14, slice 6c), each raising
NotImplementedError: an ep axis larger than 1, a MoE or Phi trunk,
``grad_accum_steps`` > 1, a pp axis.
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models import llama, vla, vlm
from ..parallel import distributed as D
from ..parallel import tensor_parallel as tp
from ..parallel.sharding import place_params, shard_train_state
from ..vla.action_tokenizer import ActionCodec
from .train_state import (AdamW, OptState, TrainState, apply_updates, global_norm, tree_leaves,
                          tree_map)

IGNORE_INDEX = -100


def _apply_mask(g: torch.Tensor, t) -> torch.Tensor:
    """Zero a gradient (or update) where the trainable mask is False: a bool
    freezes the whole leaf, a tensor broadcasts over the leading dims (a
    [L] layer mask over a layer-stacked weight)."""
    if isinstance(t, bool):
        return g if t else torch.zeros_like(g)
    t = torch.as_tensor(t, device=g.device)
    return g * t.reshape(t.shape + (1,) * (g.dim() - t.dim())).to(g.dtype)


def _shifted(logits: torch.Tensor, labels: torch.Tensor):
    shift_logits, shift_labels = logits[:, :-1], labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    logp = torch.log_softmax(shift_logits.float(), dim=-1)
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return shift_logits, shift_labels, valid, nll


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE over the non-ignored positions (labels aligned to
    the inputs; shifted here, as the HF reference does)."""
    _, _, valid, nll = _shifted(logits, labels)
    total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    return total / torch.clamp(valid.sum(), min=1)


def _action_stats(preds, targets, codec: ActionCodec, dims):
    mask = targets > codec.action_token_begin_idx
    n = torch.clamp(mask.sum(dim=dims), min=1)
    acc = ((preds == targets) & mask).sum(dim=dims) / n
    fill = torch.full_like(targets, codec.vocab_size - 1)
    cont_pred = codec.decode(torch.where(mask, preds, fill))
    cont_tgt = codec.decode(torch.where(mask, targets, fill))
    l1 = torch.where(mask, (cont_pred - cont_tgt).abs(),
                     torch.zeros_like(cont_pred)).sum(dim=dims) / n
    return acc, l1


def action_metrics(logits: torch.Tensor, labels: torch.Tensor,
                   codec: ActionCodec) -> Dict[str, torch.Tensor]:
    """Action-token accuracy and continuous L1 over the batch."""
    acc, l1 = _action_stats(logits[:, :-1].argmax(-1), labels[:, 1:], codec, dims=None)
    return {"action_accuracy": acc, "l1_loss": l1}


def per_example_metrics(logits: torch.Tensor, labels: torch.Tensor,
                        codec: ActionCodec) -> Dict[str, torch.Tensor]:
    """[B]-shaped loss, action accuracy and L1 per example (the host groups
    them by dataset for the per-dataset trackers)."""
    shift_logits, shift_labels, valid, nll = _shifted(logits, labels)
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum(dim=1) / torch.clamp(
        valid.sum(dim=1), min=1)
    acc, l1 = _action_stats(shift_logits.argmax(-1), shift_labels, codec, dims=1)
    return {"loss": loss, "action_accuracy": acc, "l1_loss": l1}


def vla_loss_fn(params: Any, cfg: vlm.VLMConfig, batch: Dict[str, torch.Tensor],
                codec: ActionCodec, with_per_example: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The loss of one batch (``input_ids``, ``attention_mask``, ``labels``
    [B, T]; ``pixel_values`` [B, 3K, S, S] or absent) and its metrics; the
    metrics are detached. A MoE trunk's router losses join the loss
    (``moe_aux_coef · moe_aux + moe_z_coef · moe_z``, their gradients through
    the router) and the metrics; ``metrics["loss"]`` stays the cross entropy.
    Inside a sharded step (`make_sharded_train_step`) a rank's share of the
    global loss (`_sharded_loss`), and the step is told that it ran."""
    ctx = _SHARD.get()
    if ctx is not None:
        shard, entered = ctx
        entered.append(True)
        return _sharded_loss(params, cfg, batch, codec, with_per_example, shard)
    out = vlm.forward(params, cfg, input_ids=batch["input_ids"],
                      attn_mask=batch["attention_mask"], pixel_values=batch.get("pixel_values"),
                      labels=batch["labels"])
    logits, labels = out["logits"], out["labels"]
    ce = cross_entropy_loss(logits, labels)
    loss = ce
    if "moe_aux" in out:
        loss = (ce + getattr(cfg.llm, "moe_aux_coef", 0.0) * out["moe_aux"]
                + getattr(cfg.llm, "moe_z_coef", 0.0) * out["moe_z"])
    with torch.no_grad():
        metrics: Dict[str, Any] = {"loss": ce.detach(), **action_metrics(logits, labels, codec)}
        if "moe_aux" in out:
            metrics["moe_aux"] = out["moe_aux"].detach()
            metrics["moe_z"] = out["moe_z"].detach()
        if with_per_example:
            metrics["per_example"] = per_example_metrics(logits, labels, codec)
    return loss, metrics


def _trainable(params: Any) -> Any:
    """The params with every float leaf a fresh autograd leaf (detached,
    sharing storage); other leaves as they are."""
    return tree_map(lambda p: p.detach().requires_grad_(True) if p.is_floating_point() else p,
                    params)


def value_and_grad(loss_fn: Callable, params: Any, *args):
    """((loss, metrics), grads) of ``loss_fn(params, *args)`` with respect to
    the float leaves of `params`: a leaf the loss does not reach gets zeros,
    a non-float leaf None (``jax.value_and_grad(has_aux=True)``)."""
    p = _trainable(params)
    with torch.enable_grad():
        loss, metrics = loss_fn(p, *args)
        leaves = [t for t in tree_leaves(p) if t.requires_grad]
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(t):
        if not t.requires_grad:
            return None
        g = next(grads)
        return torch.zeros_like(t) if g is None else g

    return (loss.detach(), metrics), tree_map(grad_of, p)


def make_train_step(
    cfg: vlm.VLMConfig,
    optimizer: AdamW,
    codec: Optional[ActionCodec] = None,
    trainable_mask: Optional[Any] = None,   # tree of bool / layer masks: False = frozen
    loss_fn: Optional[Callable] = None,
    grad_accum_steps: int = 1,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, Any]]]:
    """The (state, batch) -> (state, metrics) step.

    `trainable_mask` freezes leaves (zero gradients, and zero updates, so
    AdamW's decoupled weight decay cannot move them either).
    `grad_accum_steps` > 1 splits the batch into that many micro-batches along
    dim 0 and averages their gradients (fp32 sums), losses and metrics; the
    per-example metrics are dropped there."""
    codec = codec or ActionCodec()
    loss_fn = loss_fn or functools.partial(vla_loss_fn, codec=codec)

    def compute_grads(params, batch):
        if grad_accum_steps <= 1:
            return value_and_grad(loss_fn, params, cfg, batch)
        n = grad_accum_steps
        micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         if p.is_floating_point() else None, params)
        l_acc, m_acc = torch.zeros((), dtype=torch.float32), None
        for i in range(n):
            (loss, metrics), grads = value_and_grad(loss_fn, params, cfg,
                                                    {k: v[i] for k, v in micro.items()})
            metrics = {k: v for k, v in metrics.items() if k != "per_example"}
            g_acc = tree_map(lambda a, g: a + g, g_acc, grads)
            l_acc = l_acc.to(loss.device) + loss
            m_acc = metrics if m_acc is None else {k: m_acc[k] + metrics[k] for k in m_acc}
        scale = 1.0 / n
        return ((l_acc * scale, {k: v * scale for k, v in m_acc.items()}),
                tree_map(lambda g: g * scale, g_acc))

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        (loss, metrics), grads = compute_grads(state.params, batch)
        if trainable_mask is not None:
            grads = tree_map(_apply_mask, grads, trainable_mask)
        updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
        if trainable_mask is not None:
            updates = tree_map(_apply_mask, updates, trainable_mask)
        new_state = TrainState(step=state.step + 1, params=apply_updates(state.params, updates),
                               opt_state=new_opt)
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads)
        return new_state, metrics

    return step


# --- the sharded step (slice 6b): one process a rank ---------------------------------


class _Shard(NamedTuple):
    """A sharded loss's view of the mesh: `split` the axes that split the
    data (its rows; "sp" its tokens), `sp` the sequence-parallel size, `rep`
    the ranks of the data axes that hold the same rows and tokens."""

    mesh: Any
    split: Tuple[str, ...]
    sp: int
    rep: int


_SHARD: contextvars.ContextVar = contextvars.ContextVar("sharded_loss", default=None)
_ITEM = "ROADMAP Queue 1 item 14 (slice 6c)"


def _sum_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """In-place SUM all-reduce of `t` over each of `axes` in turn."""
    for a in axes:
        D.all_reduce(t, "sum", mesh.group(a))
    return t


def _sharded_loss(params, cfg: vlm.VLMConfig, batch, codec: ActionCodec,
                  with_per_example: bool, sh: _Shard):
    """`vla_loss_fn` on a rank: its share of the global loss (the module
    docstring) and the global batch's metrics."""
    mesh = sh.mesh
    params = tp.resolve_tree(params)
    cfg = dataclasses.replace(cfg, llm=vla.local_llm_config(
        cfg.llm, params["llm"], math.prod(mesh.axis_size(a) for a in sh.split)))
    ids, attn, labels = batch["input_ids"], batch["attention_mask"], batch["labels"]
    if batch.get("pixel_values") is None:
        embeds, mask, lbls = llama.embed_tokens(params["llm"], ids), attn, labels
    else:
        mm = vlm.build_multimodal_inputs(params, cfg, ids, attn, batch["pixel_values"], labels)
        embeds, mask, lbls = mm["inputs_embeds"], mm["attn_mask"], mm["labels"]
    B, T = embeds.shape[:2]
    # next-token targets over the whole spliced sequence, before any slicing
    tgt = torch.cat([lbls[:, 1:], torch.full_like(lbls[:, :1], IGNORE_INDEX)], dim=1)
    positions = torch.arange(T, device=embeds.device).expand(B, T)
    group = None
    if sh.sp > 1:
        if T % sh.sp:
            raise ValueError(f"sequence parallelism: the spliced length {T} (the prompt's tokens "
                             f"and the patches) does not divide by sp={sh.sp}; pad the batch's "
                             "token dim")
        tl = T // sh.sp
        off = mesh.coord("sp") * tl
        embeds, positions, tgt = (t[:, off:off + tl] for t in (embeds, positions, tgt))
        group = mesh.group("sp")
    logits = llama.forward(params["llm"], cfg.llm, embeds, mask, positions,
                           seq_group=group)["logits"]
    lm = params["llm"]["lm_head"]
    Bl, Tl, Vl = logits.shape
    valid = tgt != IGNORE_INDEX
    safe = torch.where(valid, tgt, torch.zeros_like(tgt))
    nll = tp.token_nll(logits.reshape(-1, Vl), safe.reshape(-1), lm).reshape(Bl, Tl)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    count = _sum_over(valid.sum().float(), mesh, sh.split)
    loss = nll.sum() / torch.clamp(count, min=1) / sh.rep
    with torch.no_grad():
        preds = tp.greedy(logits.detach().reshape(-1, Vl), lm)[0].reshape(Bl, Tl)
        metrics = _sharded_metrics(nll.detach(), valid, preds, tgt, codec, sh, with_per_example)
    return loss, metrics


def _sharded_metrics(nll, valid, preds, tgt, codec: ActionCodec, sh: _Shard,
                     with_per_example: bool) -> Dict[str, Any]:
    """The global batch's loss, action accuracy and L1 (and per row): each
    row's sums SUM-reduced over sp, the rows' over the batch axes."""
    mesh = sh.mesh
    mask = tgt > codec.action_token_begin_idx
    fill = torch.full_like(tgt, codec.vocab_size - 1)
    l1 = (codec.decode(torch.where(mask, preds, fill)) - codec.decode(torch.where(mask, tgt, fill)))
    l1 = torch.where(mask, l1.abs(), torch.zeros_like(l1))
    rows = torch.stack([nll.sum(1), valid.sum(1).float(), mask.sum(1).float(),
                        ((preds == tgt) & mask).sum(1).float(), l1.float().sum(1)], dim=1)
    if sh.sp > 1:
        D.all_reduce(rows, "sum", mesh.group("sp"))
    batch_axes = [a for a in sh.split if a != "sp"]
    tot = _sum_over(rows.sum(0), mesh, batch_axes)

    def stats(t):
        return {"loss": t[..., 0] / torch.clamp(t[..., 1], min=1),
                "action_accuracy": t[..., 3] / torch.clamp(t[..., 2], min=1),
                "l1_loss": t[..., 4] / torch.clamp(t[..., 2], min=1)}

    metrics: Dict[str, Any] = stats(tot)
    if with_per_example:
        for a in reversed(batch_axes):   # the innermost axis first: rows in rank order
            rows = D.all_gather(rows, 0, mesh.group(a))
        metrics["per_example"] = stats(rows)
    return metrics


def _batch_axes(mesh, batch_specs) -> Tuple[Tuple[str, ...], int]:
    """(the axes of size > 1 splitting the rows, the sp size splitting the
    tokens) of a batch spec: `mesh.data_sharding`'s one spec for every leaf,
    or `mesh.sequence_sharding`'s dict (read at ``input_ids``)."""
    spec = batch_specs["input_ids"] if isinstance(batch_specs, dict) else batch_specs
    spec = tuple(spec or ())
    first = spec[0] if spec else None
    names = (first,) if isinstance(first, str) else tuple(first or ())
    rows = tuple(a for a in names if mesh.axis_size(a) > 1)
    sp = mesh.axis_size("sp") if len(spec) > 1 and spec[1] == "sp" else 1
    return rows, sp


def _rank_rows(batch, mesh, rows: Tuple[str, ...], dev) -> Dict[str, torch.Tensor]:
    """This rank's rows of every batch leaf on `dev` (the JAX package's
    divisibility error)."""
    n = math.prod(mesh.axis_size(a) for a in rows)
    idx = 0
    for a in rows:
        idx = idx * mesh.axis_size(a) + mesh.coord(a)
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v, device=dev)
        if v.shape[0] % n:
            raise ValueError(f"the batch's sharding over {rows} implies that the global size of "
                             f"its dimension 0 should be divisible by {n}, but it is equal to "
                             f"{v.shape[0]}")
        b = v.shape[0] // n
        out[k] = v[idx * b:(idx + 1) * b]
    return out


def _live(spec, mesh) -> set:
    return {a for a in (spec or ()) if a is not None and mesh.axis_size(a) > 1}


def _zero2_dims(t: torch.Tensor, p_spec, o_spec, mesh):
    """The dims where the moments' spec splits on fsdp and the parameters'
    does not (zero2), right-aligned to t."""
    if mesh.axis_size("fsdp") <= 1:
        return []
    ps, os_ = tp._rs(p_spec, t.dim()), tp._rs(o_spec, t.dim())
    return [d for d in range(t.dim()) if os_[d] == "fsdp" and ps[d] != "fsdp"]


def _to_update(t, p_spec, o_spec, mesh):
    """A rank's parameter-layout tensor cut to the moments' layout."""
    for d in _zero2_dims(t, p_spec, o_spec, mesh):
        n = t.shape[d] // mesh.axis_size("fsdp")
        t = t.narrow(d, mesh.coord("fsdp") * n, n)
    return t


def _from_update(t, p_spec, o_spec, mesh):
    """A moments-layout tensor all-gathered back to the parameters' layout."""
    for d in _zero2_dims(t, p_spec, o_spec, mesh):
        t = D.all_gather(t, d, mesh.group("fsdp"), "all_gather_params")
    return t


def _pairs(tree, specs) -> list:
    """(tensor, spec) over the tensor leaves of `tree` in order."""
    out = []
    tree_map(lambda t, s: out.append((t, s)), tree, specs)
    return out


def _reduce_grads(grads, p_specs, mesh, data_axes) -> Any:
    """Each gradient SUM all-reduced (fp32) over the data axes that do not
    split its leaf, leaves of one set of axes flattened into one buffer."""
    pairs = _pairs(grads, p_specs)
    groups: Dict[tuple, list] = {}
    for i, (g, s) in enumerate(pairs):
        groups.setdefault(tuple(a for a in data_axes if a not in _live(s, mesh)), []).append(i)
    out = [g.float() for g, _ in pairs]
    for axes, idx in groups.items():
        if not axes:
            continue
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        for a in axes:
            D.all_reduce(flat, "sum", mesh.group(a), "grad_all_reduce")
        for i, part in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = part.view_as(out[i])
    it = iter(out)
    return tree_map(lambda _: next(it), grads)


def _global_norm(g_u, o_specs, mesh) -> torch.Tensor:
    """sqrt of every leaf's squared norm summed over the shards it is split
    into (fp32): leaves grouped by the axes that split them, each group's sum
    SUM all-reduced over those axes."""
    by_axes: Dict[tuple, list] = {}
    for g, s in _pairs(g_u, o_specs):
        by_axes.setdefault(tuple(sorted(_live(s, mesh))), []).append(torch.sum(g.float() * g.float()))
    total = []
    for axes, sq in by_axes.items():
        t = torch.stack(sq).sum()
        for a in axes:
            D.all_reduce(t, "sum", mesh.group(a), "grad_norm_all_reduce")
        total.append(t)
    return torch.sqrt(torch.stack(total).sum())


def _refuse(cfg: vlm.VLMConfig, mesh, grad_accum_steps: int) -> None:
    what = None
    if vlm.is_phi(cfg):
        what = "a Phi trunk"
    elif getattr(cfg.llm, "moe_experts", 0):
        what = "a MoE trunk"
    elif mesh.axis_size("ep") > 1:
        what = f"an ep axis of {mesh.axis_size('ep')}"
    elif "pp" in mesh.axis_names:
        what = "a pp axis (parallel/pipeline.py)"
    elif grad_accum_steps > 1:
        what = f"grad_accum_steps={grad_accum_steps}"
    if what:
        raise NotImplementedError(f"make_sharded_train_step: {what} is not ported ({_ITEM})")


def place_train_state(state: TrainState, mesh, strategy: str = "fsdp") -> TrainState:
    """This rank's local train state: the parameters and the AdamW moments
    placed by their specs (``parallel.sharding.shard_train_state``, zero2
    included; ``place_params``), the step and the count as they are."""
    specs = shard_train_state(state, mesh, strategy)
    opt = state.opt_state
    return TrainState(
        step=state.step,
        params=place_params(state.params, mesh, _spec=specs.params),
        opt_state=OptState(opt.count, place_params(opt.mu, mesh, _path="mu", _spec=specs.opt_state.mu),
                           place_params(opt.nu, mesh, _path="nu", _spec=specs.opt_state.nu)))


def make_sharded_train_step(
    cfg: vlm.VLMConfig,
    optimizer: AdamW,
    mesh,                          # parallel.mesh.Mesh over dp / fsdp / tp / sp
    state_specs: TrainState,       # parallel.sharding.shard_train_state(state, mesh, strategy)
    batch_specs: Any,              # parallel.mesh.data_sharding / sequence_sharding
    codec: Optional[ActionCodec] = None,
    trainable_mask: Optional[Any] = None,
    loss_fn: Optional[Callable] = None,
    grad_accum_steps: int = 1,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, Any]]]:
    """The (local state, whole batch) -> (local state, metrics) step of one
    rank (the module docstring): the state is `place_train_state`'s, laid out
    by `state_specs`; `loss_fn` as `make_train_step`'s, its frozen base (a
    LoRA loss's) placed by the caller (``parallel.place_params``) with the
    same strategy. The loss must go through `vla_loss_fn` (a wrapper of it,
    as ``training.lora``'s loss is), the one loss that reads the mesh: a step
    whose loss never reached it raises TypeError. The result equals the
    one-process step's."""
    _refuse(cfg, mesh, grad_accum_steps)
    codec = codec or ActionCodec()
    loss_fn = loss_fn or functools.partial(vla_loss_fn, codec=codec)
    rows, sp = _batch_axes(mesh, batch_specs)
    data_axes = tuple(a for a in mesh.axis_names if a != "tp" and mesh.axis_size(a) > 1)
    split = rows + (("sp",) if sp > 1 else ())
    sh = _Shard(mesh, split, sp, math.prod(mesh.axis_size(a) for a in data_axes if a not in split))
    p_specs, o_specs = state_specs.params, state_specs.opt_state.mu

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        local = tp.local_tree(state.params)
        dev = next(t for t in tree_leaves(local) if isinstance(t, torch.Tensor)).device
        entered: list = []
        token = _SHARD.set((sh, entered))
        try:
            (loss, metrics), grads = value_and_grad(
                lambda p, *a: loss_fn(tp.with_locals(state.params, p), *a), local, cfg,
                _rank_rows(batch, mesh, rows, dev))
        finally:
            _SHARD.reset(token)
        if not entered:
            # a loss that never reached vla_loss_fn ran as one process's mean over this rank's
            # rows, and the SUM over the data axes below would scale it by their ranks
            raise TypeError("make_sharded_train_step: loss_fn never called vla_loss_fn, the one "
                            "loss that knows the mesh (the global valid count, the vocab-"
                            "parallel log-softmax); wrap it, as training.lora's loss does")
        grads = _reduce_grads(grads, p_specs, mesh, data_axes)
        if trainable_mask is not None:
            grads = tree_map(_apply_mask, grads, trainable_mask)
        g_u = tree_map(lambda g, ps, os_: _to_update(g, ps, os_, mesh), grads, p_specs, o_specs)
        p_u = tree_map(lambda p, ps, os_: _to_update(p, ps, os_, mesh), local, p_specs, o_specs)
        norm = _global_norm(g_u, o_specs, mesh)
        opt = state.opt_state
        updates, new_opt = optimizer.update(
            g_u, OptState(opt.count, tp.local_tree(opt.mu), tp.local_tree(opt.nu)), p_u, norm=norm)
        if trainable_mask is not None:
            updates = tree_map(_apply_mask, updates, trainable_mask)
        new_p = tree_map(lambda p, ps, os_: _from_update(p, ps, os_, mesh),
                         apply_updates(p_u, updates), p_specs, o_specs)
        new_state = TrainState(
            step=state.step + 1, params=tp.with_locals(state.params, new_p),
            opt_state=OptState(new_opt.count, tp.with_locals(opt.mu, new_opt.mu),
                               tp.with_locals(opt.nu, new_opt.nu)))
        metrics = dict(metrics)
        metrics["grad_norm"] = norm
        return new_state, metrics

    return step
