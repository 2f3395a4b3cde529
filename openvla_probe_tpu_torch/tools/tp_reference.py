"""One process's forward and backward, rounded as a tensor-parallel group of
n ranks rounds them: the reference a sharded train step is held to.

A tp = n step (``training.make_sharded_train_step`` over
``parallel.tensor_parallel``) computes the same function as one process's
step, but sums some of it in another order and runs its products at other
shapes:

* a row-parallel float product sums n fp32 K-slice partials, then casts;
* a column-parallel product's dx sums n fp32 partials (a float leaf's
  g · w, an int8 leaf's g times its bf16 dequantized codes), then casts;
* a LoRA rank projection over a row-parallel base sums n fp32 K-slice
  partials, then casts;
* each rank runs its GEMMs on its own columns (O / n) and the plain attention
  on its own heads (H / n), where the library may pick another kernel.

The exact row-parallel int8 chain, the int8 forward products and every
elementwise step do not depend on the partition. At random weights the int8
QLoRA step amplifies one bf16 rounding of its forward (an activation code
moves by one, and the next layers' codes with it) far past the distances the
step is held to, so one process's plain step is no reference for it. Inside
`rounded_as_tp` every product of a leaf the "tp" rules split, and the plain
attention, computes in one process what the n ranks compute: the same
partial products at the rank's shapes, summed in rank order (for n = 2
gloo's sum, a + b), over the whole leaves and whole activations, laid out as
one process lays them out. Everything else runs as it does in one process
(the loss's log-softmax over the whole vocabulary, the global norm).

    with tp_reference.rounded_as_tp(base, 2):
        state, metrics = one_process_step(state, batch)

It covers float leaves and per-channel int8 leaves on the "w8a8" route, bare
or under a streamed-LoRA wrapper ``{"base", "A", "B"}`` (the trainer's), and
refuses any other form of a split leaf.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Tuple
from unittest import mock

import torch

from ..models import llama, vit
from ..ops import linear as lin
from ..parallel import tensor_parallel as tp
from ..parallel.mesh import Mesh
from ..parallel.sharding import _is_leaf_group, shard_params

Key = Tuple[int, Tuple[int, ...]]


def _cut(t: torch.Tensor, dim: int, n: int, i: int, parts: int) -> torch.Tensor:
    """Rank i's share of `dim` (of each of `parts` equal parts), contiguous."""
    size = t.shape[dim]
    c = size // (n * parts)
    p = size // parts
    return torch.cat([t.narrow(dim, j * p + i * c, c) for j in range(parts)], dim).contiguous()


def _join(ys: List[torch.Tensor], dim: int, parts: int) -> torch.Tensor:
    """The ranks' outputs along `dim` laid out whole (each part's rank
    slices in rank order): the inverse of `_cut`."""
    c = ys[0].shape[dim] // parts
    return torch.cat([y.narrow(dim, j * c, c) for j in range(parts) for y in ys], dim)


def _rank_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _ColFloat(torch.autograd.Function):
    """A column-parallel float product: each rank's x @ w_iᵀ, laid out whole;
    dx the ranks' fp32 partials g_i · w_i summed, then cast; dw each rank's
    g_iᵀ x."""

    @staticmethod
    def forward(ctx, x, w, n, parts):
        ctx.save_for_backward(x, w)
        ctx.n, ctx.parts = n, parts
        return _join([torch.matmul(x, _cut(w, 0, n, i, parts).t()) for i in range(n)], -1, parts)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        n, parts = ctx.n, ctx.parts
        gs = [_cut(g, -1, n, i, parts) for i in range(n)]
        ws = [_cut(w, 0, n, i, parts) for i in range(n)]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _rank_sum([torch.matmul(gi.float(), wi.float())
                            for gi, wi in zip(gs, ws)]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            x2 = x.reshape(-1, x.shape[-1])
            dw = _join([torch.matmul(gi.reshape(-1, gi.shape[-1]).t(), x2) for gi in gs], 0, parts)
        return dx, dw, None, None


class _ColInt8(torch.autograd.Function):
    """A column-parallel per-channel int8 product on the w8a8 route (exact
    per column, so computed whole); dx the ranks' fp32 partials of the w8a8
    STE (g in bf16 times the bf16 dequantized codes of the rank's columns)
    summed, then cast."""

    @staticmethod
    def forward(ctx, x, w, n, parts):
        ctx.w, ctx.n, ctx.parts = w, n, parts
        lead, K = x.shape[:-1], x.shape[-1]
        return lin.w8a8_matmul(x.reshape(-1, K).contiguous(), w).reshape(*lead, -1)

    @staticmethod
    def backward(ctx, g):
        w, n, parts = ctx.w, ctx.n, ctx.parts
        dx = []
        for i in range(n):
            q, s = _cut(w["q"], 0, n, i, parts), _cut(w["s"], 0, n, i, parts)
            wd = q.to(torch.bfloat16) * s.to(torch.bfloat16)[:, None]
            dx.append(torch.matmul(_cut(g, -1, n, i, parts).to(torch.bfloat16).float(), wd.float()))
        return _rank_sum(dx).to(g.dtype), None, None, None


class _RowInt8(torch.autograd.Function):
    """A row-parallel per-channel int8 product on the w8a8 route: the exact
    chain equals the one-process kernel bit for bit; dx each rank's K slice
    by the w8a8 STE on its codes, laid side by side."""

    @staticmethod
    def forward(ctx, x2, w, n):
        ctx.w, ctx.n = w, n
        return lin.w8a8_matmul(x2, w)

    @staticmethod
    def backward(ctx, g):
        w, n = ctx.w, ctx.n
        return torch.cat([lin._int8_ste_dx(g, _cut(w["q"], -1, n, i, 1), w["s"])
                          for i in range(n)], -1), None, None


def _k_partials(x2: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """The ranks' fp32 partials x2_i · w_iᵀ over their K slices, summed."""
    return _rank_sum([torch.matmul(_cut(x2, -1, n, i, 1).float(), _cut(w, -1, n, i, 1).float().t())
                      for i in range(n)])


class _Rounding:
    """The patched products and attention of `rounded_as_tp`."""

    def __init__(self, roles: Dict[Key, Tuple[str, int]], n: int, tp_matmul, llama_matmul,
                 attention):
        self.roles, self.n = roles, n
        self.tp_matmul, self.llama_matmul, self.attention_plain = tp_matmul, llama_matmul, attention
        self.calls = {"col": 0, "row": 0, "attention": 0}

    def role(self, w: Any) -> Optional[Tuple[str, int]]:
        t = _key_tensor(w)
        return None if t is None else self.roles.get((t.data_ptr(), tuple(t.shape)))

    def matmul(self, orig, x, w, route: str = "wi8", row_split: int = 1):
        lw = w if lin.is_lora_wrapped(w) else None
        base = lw["base"] if lw else w
        info = self.role(base)
        if info is None:
            return orig(x, w, route, row_split)
        role, parts = info
        if not (isinstance(base, torch.Tensor) or
                (lin.is_int8_per_channel(base) and route == "w8a8")):
            raise NotImplementedError(f"tp_reference: a {role}-parallel leaf of another form or "
                                      f"route ({route}) than float or per-channel int8 on w8a8")
        self.calls[role] += 1
        n, dt = self.n, x.dtype
        # each product in the sharded forward's order (its side path first, the base last), so
        # that autograd sums an input's cotangents in the same order
        delta = None
        if role == "col":
            if lw:
                u = torch.matmul(x, lw["A"].to(dt).t())
                delta = _ColFloat.apply(u, lw["B"].to(dt), n, parts)
            if isinstance(base, torch.Tensor):
                y = _ColFloat.apply(x, base, n, parts)
            elif lin._needs_grad(x):
                y = _ColInt8.apply(x, base, n, parts)
            else:
                y = orig(x, base, route, row_split)
            return y if delta is None else y + delta
        lead, K = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, K)
        if lw:
            u = _k_partials(x2, lw["A"].reshape(-1, K), n).to(dt)
            delta = torch.matmul(u, lw["B"].to(dt).t())
        if isinstance(base, torch.Tensor):
            y = _k_partials(x2, base, n).to(dt)
        elif lin._needs_grad(x2):
            y = _RowInt8.apply(x2.contiguous(), base, n)
        else:
            y = lin.w8a8_matmul(x2.contiguous(), base)
        if delta is not None:
            y = y + delta
        return y.reshape(*lead, -1)

    def attention(self, q, k, v, mask, scores_dtype=torch.float32):
        """The plain attention on each rank's heads, laid side by side."""
        n = self.n
        if q.shape[2] % n or k.shape[2] % n:
            return self.attention_plain(q, k, v, mask, scores_dtype)
        self.calls["attention"] += 1
        hq, hk = q.shape[2] // n, k.shape[2] // n
        return torch.cat([self.attention_plain(q[:, :, i * hq:(i + 1) * hq],
                                               k[:, :, i * hk:(i + 1) * hk],
                                               v[:, :, i * hk:(i + 1) * hk], mask, scores_dtype)
                          for i in range(n)], dim=2)


def _key_tensor(w: Any) -> Optional[torch.Tensor]:
    """The tensor that names a leaf: a float weight itself, a quantized
    leaf's codes ("q", a nibble leaf's "hi")."""
    if isinstance(w, torch.Tensor):
        return w
    t = w.get("q", w.get("hi")) if isinstance(w, dict) else None
    return t if isinstance(t, torch.Tensor) else None


def _roles(params: Any, n: int) -> Dict[Key, Tuple[str, int]]:
    """(data pointer, shape) of every 2-D weight (each layer's of a stacked
    one; a quantized leaf's codes) that the "tp" rules split at tp = n ->
    (its role, "col" or "row"; its parts: 3 for a fused qkv)."""
    mesh = Mesh({"tp": n})
    out: Dict[Key, Tuple[str, int]] = {}

    def walk(t: Any, spec: Any, path: str) -> None:
        if isinstance(t, dict) and not _is_leaf_group(t):
            for k in t:
                walk(t[k], spec[k], f"{path}/{k}" if path else k)
            return
        key = _key_tensor(t)
        if key is None or key.dim() < 2:
            return
        rs = tp._rs(spec if isinstance(t, torch.Tensor) else spec["q" if "q" in t else "hi"],
                    key.dim())
        role = "col" if rs[-2] == "tp" else "row" if rs[-1] == "tp" else None
        if role is None:
            return
        parts = 3 if "qkv_w" in path.rsplit("/", 2)[-2:] else 1
        mats = key.reshape(-1, *key.shape[-2:])
        for m in mats:
            out[(m.data_ptr(), tuple(m.shape))] = (role, parts)

    walk(params, shard_params(params, mesh, "tp"), "")
    return out


@contextlib.contextmanager
def rounded_as_tp(base: Any, n: int) -> Iterator[Dict[str, int]]:
    """Within the block, one process's products of `base`'s leaves that the
    "tp" rules split at tp = n, and the plain attention of the trunk and
    towers, round as n ranks round them (the module docstring). Yields the
    count of products ("col", "row") and attention calls taken so."""
    r = _Rounding(_roles(base, n), n, tp.matmul, llama.matmul_t, llama.attention_plain)

    def tp_matmul(x, w, route="wi8", row_split=1):
        return r.matmul(r.tp_matmul, x, w, route, row_split)

    def llama_matmul(x, w, route="wi8", row_split=1):
        return r.matmul(r.llama_matmul, x, w, route, row_split)

    with mock.patch.object(tp, "matmul", tp_matmul), \
            mock.patch.object(llama, "matmul_t", llama_matmul), \
            mock.patch.object(llama, "attention_plain", r.attention), \
            mock.patch.object(vit, "attention_plain", r.attention):
        yield r.calls
