"""The VLA / VLM train step: masked next-token loss, action metrics, the
optimizer update (counterpart of ``openvla_probe_tpu/training/train_step.py``).

Loss semantics are the reference's: next-token cross entropy with
IGNORE_INDEX (-100) masking, so the loss lands only on the action tokens and
the stop token; action accuracy and the continuous L1 over positions whose
label is past ``codec.action_token_begin_idx``. The step differentiates the
loss with ``torch.autograd.grad`` with respect to the trained tree's float
leaves only (a frozen base passed beside it stays out of the graph's
leaves), masks frozen leaves' gradients and updates, and applies the update
in fp32. ``make_sharded_train_step`` waits for the parallel slice (ROADMAP
Queue 1 item 14).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import vlm
from ..vla.action_tokenizer import ActionCodec
from .train_state import AdamW, TrainState, apply_updates, global_norm, tree_leaves, tree_map

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
    metrics are detached."""
    out = vlm.forward(params, cfg, input_ids=batch["input_ids"],
                      attn_mask=batch["attention_mask"], pixel_values=batch.get("pixel_values"),
                      labels=batch["labels"])
    logits, labels = out["logits"], out["labels"]
    loss = cross_entropy_loss(logits, labels)
    with torch.no_grad():
        metrics: Dict[str, Any] = {"loss": loss.detach(), **action_metrics(logits, labels, codec)}
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
