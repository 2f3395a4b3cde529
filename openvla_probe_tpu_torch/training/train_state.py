"""Optimizer and schedule: AdamW with decay groups, warmup-cosine, fp32 moments
(counterpart of ``openvla_probe_tpu/training/train_state.py``).

The JAX package builds its optimizer as the optax chain

    clip_by_global_norm(max_grad_norm)
    scale_by_adam(b1, b2, eps=1e-8, eps_root=0, mu_dtype=fp32)
    add_decayed_weights(weight_decay, mask=ndim >= 2)
    scale_by_learning_rate(schedule)

and the port writes the same chain by hand, functional over a tree of tensors
(nested dicts whose leaves are tensors or None), op for op in fp32:

* the global norm is sqrt(Σ_leaf Σ g²); where it is not below the limit every
  leaf becomes (g / norm) · max (optax's form; not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6);
* mu = (1 - b1)·g + b1·mu, nu = (1 - b2)·g² + b2·nu, both fp32; the update
  (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) at t = steps taken + 1;
* weight decay adds wd · p on leaves of at least two dims only (the
  reference's no-decay group: norms, biases, 1-D tensors);
* the learning rate is applied last, at count = steps taken so far:
  warmup-cosine gives lr = 0 at step 0, so a first step changes nothing.

Tensors are never updated in place: `update` and `apply_updates` return new
trees, as optax does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-5
    lr_schedule_type: str = "linear-warmup+cosine-decay"  # or "constant"
    warmup_ratio: float = 0.05
    max_steps: int = 10000
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    betas: tuple = (0.9, 0.999)
    final_lr_ratio: float = 0.01  # cosine floor
    optimizer_type: str = "adamw"  # "adafactor" is not ported


# --- trees of tensors -------------------------------------------------------------------


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """`fn` over the tensor leaves of `tree` (and the matching leaves of
    `rest`); None leaves stay None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt(Σ_leaf Σ x²) in fp32 (``optax.global_norm``)."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(x.float() * x.float()) for x in leaves))


# --- schedule ---------------------------------------------------------------------------


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], torch.Tensor]:
    """count -> fp32 learning rate, optax's constant or
    ``warmup_cosine_decay_schedule(0, lr, warmup, max_steps, lr · final_ratio)``
    (warmup = max(1, int(max_steps · warmup_ratio)))."""
    lr = cfg.learning_rate
    if cfg.lr_schedule_type == "constant":
        return lambda count: torch.tensor(lr, dtype=torch.float32)
    if cfg.lr_schedule_type != "linear-warmup+cosine-decay":
        raise ValueError(f"Unknown schedule {cfg.lr_schedule_type}")
    warmup = max(1, int(cfg.max_steps * cfg.warmup_ratio))
    decay_steps = cfg.max_steps - warmup
    alpha = cfg.final_lr_ratio   # end_value / peak_value
    if decay_steps <= 0:
        raise ValueError(f"max_steps={cfg.max_steps} leaves no decay after {warmup} warmup steps")

    def schedule(count: int) -> torch.Tensor:
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        if count < warmup:       # optax.linear_schedule(0, lr, warmup)
            frac = 1 - f32(count) / f32(warmup)
            return (f32(0.0) - f32(lr)) * frac + f32(lr)
        t = torch.minimum(f32(count - warmup), f32(decay_steps))
        cosine = 0.5 * (1 + torch.cos(f32(math.pi) * t / f32(decay_steps)))
        return f32(lr) * ((1 - alpha) * cosine + alpha)

    return schedule


# --- AdamW ------------------------------------------------------------------------------


class OptState(NamedTuple):
    """``count``: updates taken (optax's ScaleByAdamState.count, and the
    schedule's count, which moves with it); ``mu``, ``nu``: fp32 moments."""

    count: int
    mu: Tree
    nu: Tree


class AdamW:
    """The JAX package's optimizer chain (module docstring) over a tree of
    tensors: ``init(params) -> OptState``, ``update(grads, state, params) ->
    (updates, state)``, as an optax GradientTransformation."""

    def __init__(self, cfg: OptimizerConfig, params: Tree):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        # decay groups from the params' shapes (the reference's no-decay rule)
        self.decay_mask = tree_map(lambda p: p.dim() >= 2, params)

    def init(self, params: Tree) -> OptState:
        """Zero fp32 moments for the float leaves (None for integer leaves,
        which take no gradient)."""
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         if p.is_floating_point() else None, params)
        return OptState(0, zeros, tree_map(torch.clone, zeros))

    def update(self, grads: Tree, state: OptState, params: Tree) -> Tuple[Tree, OptState]:
        cfg = self.cfg
        b1, b2 = cfg.betas
        g = tree_map(lambda t: t.float(), grads)
        norm = global_norm(g)
        # optax's select on the device: no host sync inside the step
        keep = norm < cfg.max_grad_norm
        g = tree_map(lambda t: torch.where(keep, t, (t / norm) * cfg.max_grad_norm), g)
        mu = tree_map(lambda t, m: (1 - b1) * t + b1 * m, g, state.mu)
        nu = tree_map(lambda t, n: (1 - b2) * (t * t) + b2 * n, g, state.nu)
        count = state.count + 1
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
        upd = tree_map(lambda m, n: (m / c1) / (torch.sqrt(n / c2) + 1e-8), mu, nu)
        upd = tree_map(lambda u, p, decay: u + cfg.weight_decay * p.float() if decay else u,
                       upd, params, self.decay_mask)
        step = -self.schedule(state.count)
        upd = tree_map(lambda u: step * u, upd)   # a CPU scalar: no copy per leaf
        return upd, OptState(count, mu, nu)


def make_optimizer(cfg: OptimizerConfig, params: Tree) -> AdamW:
    if cfg.optimizer_type == "adafactor":
        raise NotImplementedError(
            "optimizer_type='adafactor' is not ported: ROADMAP Queue 1 item 13")
    if cfg.optimizer_type != "adamw":
        raise ValueError(f"Unknown optimizer_type {cfg.optimizer_type}")
    return AdamW(cfg, params)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """p + u in fp32, cast back to p's dtype (new tensors); a leaf without an
    update (None) stays as it is."""
    return tree_map(lambda p, u: p if u is None else (p.float() + u.float()).to(p.dtype),
                    params, updates)


class TrainState(NamedTuple):
    step: int
    params: Tree
    opt_state: OptState

    @staticmethod
    def create(params: Tree, optimizer: AdamW) -> "TrainState":
        return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def apply_gradients(state: TrainState, grads: Tree, optimizer: AdamW) -> TrainState:
    updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
    return TrainState(step=state.step + 1, params=apply_updates(state.params, updates),
                      opt_state=new_opt)
