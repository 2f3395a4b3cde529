"""The sharded forward's collectives, chosen by each placed leaf's spec and
never by its name (the JAX package leaves them to GSPMD, which places them
from the shardings).

A placed leaf (`sharding.place_leaf`) is ``{"local", "spec", "mesh", "path",
"parts"[, "k_valid"]}``. The models take their products through `matmul` and
their layers through `index_layer`, which serve bare leaves as
``ops.linear`` does and placed leaves by their spec (read right-aligned, so
the stack axis drops out of a layer; its fsdp dims gathered, `resolve`).
What each role costs:

* **fsdp** (any dim on ``fsdp``): the leaf is all-gathered just before use
  (`resolve`: per layer for the stacks, once a call for the rest) and freed
  after, so a rank holds its shards plus one whole layer.
* **column-parallel** (the out dim on ``tp``): the product runs on the local
  rows, no collective; scales and biases a rule leaves whole are cut to the
  local columns (`col_slice`). Attention then runs on the rank's heads.
* **row-parallel** (the contraction on ``tp``): the local K slice of the input
  (sliced here when the input is whole), then a SUM all-reduce. Float leaves
  reduce fp32 partials and cast after. Per-channel int8 codes on the w8a8
  route (and a nibble leaf's codes at prefill M, a mix leaf's int8 copy) do
  what XLA does with ``_w8a8_dot``: the row absmax over the whole K (local
  max `linear.w8a8_row_absmax`, MAX all-reduce), codes from that scale
  (`linear.w8a8_quant_given`), int32 partials (`linear.w8a8_matmul_i32`)
  summed in int32, then the epilogue (`linear.w8a8_epilogue`): bit-equal to
  one card. Every other
  quantized route (wi8, grouped int4, a mix leaf's int4 copy, the nibble hi
  plane) computes its activation scale inside its kernel, so its leaf's K
  shards and the input are all-gathered and the whole product runs on each
  rank: that moves the whole row-parallel weights every call, no tensor
  parallelism (`gathered_bytes`; the sizes a call in
  ``tools/tp_gather_bytes.py``). Those gathers count under ``WHOLE_LEAF``. A LoRA delta over a row-parallel base is a partial too: its rank
  projection is SUM-reduced in fp32, apart from the base's sum, and added
  after the base's epilogue.
* **vocab** (``embed_tokens`` / ``lm_head`` rows on ``tp``): the embedding is
  a masked local gather plus a SUM; the greedy token is the argmax over the
  global vocabulary (`greedy`, ties to the lowest index as
  ``torch.argmax``); logits are gathered only where a caller asks (`gather_cols`).
* **ep** (an expert stack's E on ``ep``): the rank holds E / ep experts
  (`ep_range`); ``models.moe`` runs them on their rows and SUM-reduces the
  combine's partials over ``ep``.

A leaf no rule splits takes no collective.

**Under autograd** (the sharded train step, ``training.train_step``) the same
placements take the differentiable collectives of ``parallel.distributed``,
with Megatron's reading of tp: every rank of a tp group runs the same rows,
so a tensor the group holds whole has its whole cotangent on every rank.

* A column-parallel product's dx partial is SUM-reduced over tp in fp32,
  then cast (`_col_product`: the fp32 partial of a float or w8a8 leaf, the
  product's own for other forms through `copy_to`); a whole tensor cut to
  the rank's columns (a bias, a LoRA factor or a product's output the rules
  leave whole) goes through `copy_to` before the cut.
* A row-parallel float product SUM-reduces its fp32 partial (`reduce_from`:
  identity backward). The exact int8 chain runs as `_RowExactSTE`: today's
  forward, and dx of the rank's K slice by the w8a8 STE on the local codes
  (JAX ``_w8a8_dot_bwd`` restricted to the slice), no collective.
* tp all-gathers of activations hand back the rank's slice; fsdp gathers of
  parameters reduce-scatter their cotangent (the shard's gradient).
* Streamed LoRA ``{"base", "A", "B"}`` over a placed base (`lora_wrapper`,
  the JAX rule of ``parallel/sharding.py:95-112``): over a column-parallel
  base B is split on O and the rank projection u = x Aᵀ (A whole) passes
  `copy_to`, so that dA and dx come out whole on every rank; over a
  row-parallel base A is split on I and the partial u is SUM-reduced in
  fp32, then multiplied by B whole; the delta is added to the base's output.
  Multi-LoRA's ``{"base", "A", "Bt", "sel"}`` is told apart by its keys.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..ops import linear as lin
from . import distributed as D
from .sharding import _slice_dim, sharded_axes


WHOLE_LEAF = "all_gather_whole_leaf"   # the collective counters' tag of a leaf gathered whole


def is_placed(w: Any) -> bool:
    return isinstance(w, dict) and "local" in w and "mesh" in w


def local_leaf(w: Any) -> Any:
    """The rank's local leaf of a placed leaf (a bare leaf as it is)."""
    return w["local"] if is_placed(w) else w


def _rs(spec, ndim: int) -> tuple:
    """A spec right-aligned to a tensor of `ndim` dims (all None for a whole leaf)."""
    spec = tuple(spec) if spec else ()
    return spec[-ndim:] if len(spec) >= ndim else (None,) * (ndim - len(spec)) + spec


def _live_axes(spec, mesh) -> set:
    return {a for a in sharded_axes(spec) if mesh.axis_size(a) > 1}


def _gather_fsdp(t: Any, spec, mesh) -> Tuple[Any, Any]:
    """(t with its fsdp dims all-gathered, the spec left); a dict of tensors
    (a quantized leaf, a LoRA wrapper's parts) key by key."""
    if isinstance(t, dict):
        pairs = {k: _gather_fsdp(v, spec[k], mesh) for k, v in t.items()}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    rs = _rs(spec, t.dim())
    for d, axis in enumerate(rs):
        if axis == "fsdp" and mesh.axis_size("fsdp") > 1:
            t = D.all_gather(t, d, mesh.group("fsdp"))
    return t, tuple(None if a == "fsdp" else a for a in rs)


def local_tree(tree: Any) -> Any:
    """A tree with each placed leaf replaced by its local leaf."""
    if is_placed(tree):
        return tree["local"]
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    return tree


def with_locals(tree: Any, locals_: Any) -> Any:
    """`tree` with each placed leaf's local leaf, and each bare leaf, taken
    from `locals_` (a tree shaped as `local_tree(tree)`)."""
    if is_placed(tree):
        return {**tree, "local": locals_}
    if isinstance(tree, dict):
        return {k: with_locals(v, locals_[k]) for k, v in tree.items()}
    return locals_


def resolve(w: Any) -> Any:
    """A placed leaf with its fsdp dims all-gathered: a placed leaf of what
    is left (tp, ep), or the bare whole leaf where nothing is."""
    if not is_placed(w):
        return w
    mesh, spec, local = w["mesh"], w["spec"], w["local"]
    if "fsdp" not in _live_axes(spec, mesh):
        return w
    local, spec = _gather_fsdp(local, spec, mesh)
    if not _live_axes(spec, mesh):
        return local
    return {**w, "local": local, "spec": spec}


def resolve_tree(tree: Any) -> Any:
    """`resolve` over a tree but its layer stacks (paths through ``layers/``
    or ``blocks/``), which stay sharded: `ops.linear.index_layer` gathers
    them a layer at a time."""
    if is_placed(tree):
        p = tree["path"]
        return tree if "layers/" in p or "blocks/" in p else resolve(tree)
    if isinstance(tree, dict):
        return {k: resolve_tree(v) for k, v in tree.items()}
    return tree


def index_layer(tree: Any, i: int) -> Any:
    """Layer `i` of a layer-stacked tree (``ops.linear.index_layer``), where a
    placed stack's layer comes with its fsdp dims gathered."""
    if is_placed(tree):
        local = tree["local"]
        local = lin.index_layer(local, i) if isinstance(local, dict) else local[i]
        return resolve({**tree, "local": local})
    if isinstance(tree, dict):
        return {k: index_layer(v, i) for k, v in tree.items()}
    return tree[i] if isinstance(tree, torch.Tensor) else tree


# --- roles ----------------------------------------------------------------------------


def _form(local: Any) -> str:
    """The leaf form from keys and dtypes alone (a column-parallel leaf may
    hold a whole scale beside its local codes): "lora" a multi-LoRA wrapper,
    "lora_ab" a streamed-LoRA wrapper."""
    if isinstance(local, torch.Tensor):
        return "float"
    keys = set(local)
    if keys == {"base", "A", "B"}:
        return "lora_ab"
    if "base" in keys:
        return "lora"
    if keys == {"hi", "lo", "s"}:
        return "nibble"
    if keys == {"q", "s", "q4", "s4"}:
        return "mix"
    if keys == {"q", "s"}:
        return "int8" if local["q"].dtype == torch.int8 else "int4"
    raise TypeError(f"a placed leaf of an unsupported form: {sorted(keys)}")


# the dim of each tensor of a form that carries the out channels / the contraction
_OUT_DIM = {"float": {None: -2}, "int8": {"q": -2, "s": -1}, "int4": {"q": -2, "s": -2},
            "nibble": {"hi": -2, "lo": -2, "s": -1}, "mix": {"q": -2, "s": -1, "q4": -2, "s4": -2}}
_K_DIM = {"float": {None: -1}, "int8": {"q": -1}, "int4": {"q": -3, "s": -1},
          "nibble": {"hi": -1, "lo": -1}, "mix": {"q": -1, "q4": -3, "s4": -1}}
_CODES = {"float": None, "int8": "q", "int4": "q", "nibble": "hi", "mix": "q"}


def _spec_of(spec, key):
    return spec if key is None else spec[key]


def _tensor(local, key):
    return local if key is None else local[key]


def tp_role(w: Any) -> Optional[str]:
    """"col" (out dim on tp), "row" (contraction on tp) or None for a leaf tp
    does not split (a bare leaf, or one only fsdp / ep split)."""
    if not is_placed(w) or w["mesh"].axis_size("tp") <= 1:
        return None
    local, spec = w["local"], w["spec"]
    form = _form(local)
    if form in ("lora", "lora_ab"):
        return tp_role({**w, "local": local["base"], "spec": spec["base"]})
    key = _CODES[form]
    t = _tensor(local, key)
    rs = _rs(_spec_of(spec, key), t.dim())
    if rs[_OUT_DIM[form][key]] == "tp":
        return "col"
    if rs[_K_DIM[form][key]] == "tp":
        return "row"
    return None


def tp_coord(w: dict) -> Tuple[int, int, Any]:
    """(this rank's tp index, tp size, the tp process group)."""
    m = w["mesh"]
    return m.coord("tp"), m.axis_size("tp"), m.group("tp")


def _out_slice(t: torch.Tensor, dim: int, n_local: int, w: dict) -> torch.Tensor:
    """A whole out dim cut to the rank's columns (a view, or for the fused
    qkv its three parts' slices; under autograd after `copy_to`)."""
    i, n, g = tp_coord(w)
    if t.shape[dim] == n_local:
        return t
    return _slice_dim(D.copy_to(t, g), dim, n, i, w["parts"])


def _base(local: Any) -> Any:
    """A LoRA wrapper's base (either form), any other leaf as it is."""
    while _form(local) in ("lora", "lora_ab"):
        local = local["base"]
    return local


def _col_local(local: Any, w: dict) -> Any:
    """The column-parallel local leaf with every tensor on the rank's columns."""
    form = _form(local)
    if form in ("lora", "lora_ab"):   # the base on its columns, and Bt's / B's out dim with it
        base = _col_local(local["base"], w)
        b_form = _form(base)
        key = _CODES[b_form]
        n_loc = _tensor(base, key).shape[_OUT_DIM[b_form][key]]
        if form == "lora_ab":
            return {**local, "base": base, "B": _out_slice(local["B"], -2, n_loc, w)}
        return {**local, "base": base, "Bt": _out_slice(local["Bt"], -1, n_loc, w)}
    if form == "float":
        return local
    key = _CODES[form]
    n_loc = local[key].shape[_OUT_DIM[form][key]]
    return {k: _out_slice(v, _OUT_DIM[form][k], n_loc, w) for k, v in local.items()}


def consumer_leaf(w: Any) -> Any:
    """The leaf a norm's consumer multiplies with: a column-parallel leaf's
    local leaf on its columns (so the fused norm's rule sees its form), any
    other leaf as it is."""
    return _col_local(w["local"], w) if tp_role(w) == "col" else w


def col_slice(b: torch.Tensor, w: Any) -> torch.Tensor:
    """A whole bias [O] cut to a column-parallel leaf's local columns; as it
    is for any other leaf."""
    if tp_role(w) != "col":
        return b
    local = _base(w["local"])
    form = _form(local)
    key = _CODES[form]
    return _out_slice(b, -1, _tensor(local, key).shape[_OUT_DIM[form][key]], w)


def rank_cols(t: torch.Tensor, width: int, ref: dict) -> torch.Tensor:
    """t [..., width] as it is, or the output of a product tp leaves whole
    ([..., n·width]) cut to this rank's `width` columns (`ref`: a placed leaf
    of the same mesh, for the coordinate)."""
    if t.shape[-1] == width:
        return t
    i, n, g = tp_coord(ref)
    if t.shape[-1] != n * width:
        raise ValueError(f"{ref['path']}: {t.shape[-1]} columns are neither {width} nor {n} x that")
    return D.copy_to(t, g).narrow(-1, i * width, width)


def input_for(x: torch.Tensor, w: Any, ref: Any) -> torch.Tensor:
    """The input of product `w` where x holds the local columns of
    column-parallel `ref`'s output: all-gathered when tp does not split `w`
    (a leaf the rules leave whole takes the whole input); as it is otherwise
    (a placed leaf takes or slices it itself)."""
    if tp_role(w) is not None or tp_role(ref) != "col":
        return x
    _, _, g = tp_coord(ref)
    return D.all_gather(x, x.dim() - 1, g, backward="split")


def _contraction(local: Any) -> int:
    """A leaf's contraction width (a LoRA wrapper's base's; packed 4-bit
    codes unpacked)."""
    local = _base(local)
    form = _form(local)
    t = _tensor(local, _CODES[form])
    if form == "int4":
        return t.shape[-3] * t.shape[-1] * 2
    return t.shape[-1] * (2 if form == "nibble" else 1)


def _k_local(w: dict) -> int:
    """The contraction width of a row-parallel leaf's local block (the true
    width of a zero-padded int8 leaf)."""
    return w.get("k_valid") or _contraction(w["local"])


def int8_form(w: Any) -> bool:
    """Whether a leaf (placed or bare) is a per-channel int8 leaf."""
    return _form(w["local"]) == "int8" if is_placed(w) else lin.is_int8_per_channel(w)


def _input_cols(x: torch.Tensor, k: int, w: dict) -> torch.Tensor:
    """x [..., K] or its rank's slice [..., k] -> the rank's slice."""
    i, n, g = tp_coord(w)
    if x.shape[-1] == k:
        return x
    if x.shape[-1] != n * k:
        raise ValueError(f"{w['path']}: input width {x.shape[-1]} is neither the local "
                         f"contraction {k} nor the whole {n * k}")
    return D.copy_to(x, g).narrow(-1, i * k, k)


def _whole_input(x: torch.Tensor, k: int, w: dict) -> torch.Tensor:
    """x [..., K] whole, all-gathering the ranks' slices where x is one."""
    if x.shape[-1] == k:
        return x
    _, n, g = tp_coord(w)
    if x.shape[-1] * n != k:
        raise ValueError(f"{w['path']}: input width {x.shape[-1]} is neither the leaf's "
                         f"contraction {k} nor a tp slice of it")
    return D.all_gather(x, x.dim() - 1, g, backward="split")


def _gather_k(local: Any, w: dict) -> Any:
    """A row-parallel leaf's K shards all-gathered into the whole leaf (the
    tensors its spec splits on tp; a scale a rule leaves whole stays)."""
    _, _, g = tp_coord(w)
    form = _form(local)
    if form == "float":
        return D.all_gather(local, local.dim() - 1, g, WHOLE_LEAF, backward="split")
    if "k_valid" in w:
        local = {**local, "q": local["q"][..., :w["k_valid"]]}
    out = {}
    for k, v in local.items():
        d = _K_DIM[form].get(k)
        split = d is not None and _rs(w["spec"][k], v.dim())[d] == "tp"
        out[k] = D.all_gather(v, v.dim() + d, g, WHOLE_LEAF, backward="split") if split else v
    return out


def gathered_bytes(w: Any, k_only: bool) -> int:
    """The bytes one rank receives when a placed leaf's tp shards are
    all-gathered whole (the other ranks' shards of each tensor tp splits: on
    the contraction alone for `k_only`, as the row-parallel fallback
    gathers; on any dim, as `whole`); 0 for a leaf tp does not split."""
    if tp_role(w) is None:
        return 0
    _, n, _ = tp_coord(w)
    local, spec = w["local"], w["spec"]
    tensors = {None: (local, spec)} if isinstance(local, torch.Tensor) else {
        k: (v, spec[k]) for k, v in local.items()}
    form = _form(local)
    total = 0
    for k, (t, s) in tensors.items():
        rs = _rs(s, t.dim())
        d = _K_DIM[form].get(k)
        split = (d is not None and rs[d] == "tp") if k_only else "tp" in rs
        if split:
            numel = t.numel()
            if k == "q" and "k_valid" in w:   # a zero padding is dropped before the gather
                numel = numel // t.shape[-1] * w["k_valid"]
            total += (n - 1) * numel * t.element_size()
    return total


def exact_row(form: str, route: str, M: int) -> bool:
    """Whether a row-parallel leaf of `form` at M rows (the whole batch's)
    takes the exact partition of ``_w8a8_dot`` (`_row_exact`); every other
    row-parallel product gathers its leaf whole."""
    if form == "int8":
        return route == "w8a8"
    return form in ("nibble", "mix") and M > lin.NIB_HI_M_MAX


def _gather_tp(t: torch.Tensor, spec, w: dict) -> torch.Tensor:
    """A tensor's tp-split dim all-gathered (the fused qkv's three parts put
    back in order); a tensor tp does not split as it is."""
    rs = _rs(spec, t.dim())
    if "tp" not in rs:
        return t
    d = rs.index("tp")
    _, n, g = tp_coord(w)
    full = D.all_gather(t, d, g, WHOLE_LEAF, backward="split")
    parts = w["parts"]
    if parts == 1:
        return full
    c = t.shape[d] // parts   # each part's rows on a rank
    chunks = full.split(c, dim=d)   # rank-major: rank r's part j at r * parts + j
    return torch.cat([chunks[r * parts + j] for j in range(parts) for r in range(n)], dim=d)


def whole(w: Any) -> Any:
    """The whole leaf of a placed leaf (its tp shards all-gathered, a zero
    padding dropped), as a kernel that cannot take a shard needs it (GSPMD
    gathers the operands of a Pallas call it cannot partition); any other
    leaf as it is."""
    if tp_role(w) is None:
        return w
    local = w["local"]
    if isinstance(local, torch.Tensor):
        return _gather_tp(local, w["spec"], w)
    if "k_valid" in w:
        local = {**local, "q": local["q"][..., :w["k_valid"]]}
    return {k: _gather_tp(v, w["spec"][k], w) for k, v in local.items()}


def _row_exact_chain(x2: torch.Tensor, local: dict, w: dict) -> torch.Tensor:
    """The exact row-parallel w8a8 product of x2 [M, k] (the rank's columns)
    and per-channel int8 or nibble codes: XLA's partition of ``_w8a8_dot``.
    A k that is not a multiple of 4 (the two pre-pass kernels' rule; SigLIP
    fc2 at tp = 8: 538) is zero-padded first: zeros move neither a row's max
    of |x| nor the int32 sum, and the codes past k are zero either way."""
    _, _, g = tp_coord(w)
    if x2.shape[-1] % 4:
        x2 = torch.nn.functional.pad(x2, (0, -x2.shape[-1] % 4))
    amax = lin.w8a8_row_absmax(x2)
    D.all_reduce(amax, "max", g)
    sx = torch.clamp(lin.div127(amax), min=1e-8)
    k_pad = local["q"].shape[-1] if "q" in local else 2 * local["hi"].shape[-1]
    codes = lin.w8a8_quant_given(x2, sx, k_pad, nibble="hi" in local)
    acc = lin.w8a8_matmul_i32(codes, local)
    D.all_reduce(acc, "sum", g)
    return lin.w8a8_epilogue(acc, sx, local["s"], x2.dtype)


class _RowExactSTE(torch.autograd.Function):
    """`_row_exact_chain` forward; dx of the rank's K slice through the bf16
    dequantized local codes ``q[:, :k] · s`` (a nibble leaf's rebuilt), the
    JAX ``_w8a8_dot_bwd`` restricted to the slice: g is the whole cotangent
    on every tp rank, so no collective. The codes and scales take none."""

    @staticmethod
    def forward(ctx, x2, local, w):
        ctx.local, ctx.k = local, x2.shape[-1]
        return _row_exact_chain(x2, local, w)

    @staticmethod
    def backward(ctx, g):
        local = ctx.local
        q = lin.nibble_reconstruct_q8(local) if "hi" in local else local["q"]
        return lin._int8_ste_dx(g, q[:, :ctx.k], local["s"]), None, None


def _row_exact(x2: torch.Tensor, local: dict, w: dict) -> torch.Tensor:
    """`_row_exact_chain`, differentiable in x2 by `_RowExactSTE` where
    autograd records."""
    if lin._needs_grad(x2):
        return _RowExactSTE.apply(x2, local, w)
    return _row_exact_chain(x2, local, w)


def _row_base(x2: torch.Tensor, local: Any, w: dict, route: str, row_split: int) -> torch.Tensor:
    form = _form(local)
    _, _, g = tp_coord(w)
    M = x2.shape[0] * row_split
    if form == "float":
        y = torch.matmul(x2.float(), local.float().t())
        return D.reduce_from(y, g).to(x2.dtype)
    if exact_row(form, route, M):
        return _row_exact(x2, lin.int8_copy(local) if form == "mix" else local, w)
    # a route whose kernel computes its own activation scale: the whole product on each rank
    x_whole = D.all_gather(x2, 1, g, backward="split")
    return lin.matmul_t(x_whole, _gather_k(local, w), route, row_split)


def _local_shapes(local: Any) -> Any:
    if isinstance(local, torch.Tensor):
        return tuple(local.shape)
    return {k: _local_shapes(v) for k, v in local.items() if isinstance(v, (torch.Tensor, dict))}


def matmul(x, w: Any, route: str = "wi8", row_split: int = 1) -> torch.Tensor:
    """x [..., K] @ w's weight: ``ops.linear.matmul_t`` for a bare leaf; for a
    placed leaf by its tp role (see the module docstring), [..., O_local] for
    a column-parallel leaf, [..., O] whole for a row-parallel one, and a local
    shape no kernel route takes raises, naming the leaf and its local shapes.
    `row_split` as ``matmul_t``'s (the ranks on dp)."""
    if not is_placed(w):
        return lin.matmul_t(x, w, route, row_split)
    try:
        return _matmul(x, w, route, row_split)
    except ValueError as e:
        raise ValueError(f"{w['path']} (local {_local_shapes(w['local'])}): {e}") from e


def _matmul(x, w: dict, route: str, row_split: int) -> torch.Tensor:
    role = tp_role(w)
    local = w["local"]
    if role == "col":
        local = _col_local(local, w)
        if isinstance(x, lin.PrequantActivation):
            return lin.matmul_t(x, local, route, row_split)
        x = _whole_input(x, _contraction(local), w)
        _, _, g = tp_coord(w)
        if _form(local) == "lora_ab":
            return _col_lora(x, local, g, route, row_split)
        return _col_product(x, local, g, route, row_split)
    if role == "row":
        if isinstance(x, lin.PrequantActivation):
            raise TypeError(f"{w['path']}: a row-parallel leaf takes a float input")
        k = _k_local(w)
        xl = _input_cols(x, k, w)
        lead = xl.shape[:-1]
        x2 = xl.reshape(-1, k).contiguous()
        form = _form(local)
        if form in ("lora", "lora_ab"):
            # the delta before the base, as matmul_t orders a streamed wrapper's products
            delta = _row_delta(x2, local, w) if form == "lora" else _row_lora(x2, local, w)
            y = _row_base(x2, local["base"], {**w, "spec": w["spec"]["base"]}, route, row_split)
            y = y + delta
        else:
            y = _row_base(x2, local, w, route, row_split)
        return y.reshape(*lead, -1)
    if role is None and _form(local) == "lora_ab":
        # a base tp leaves whole: its factors gathered whole (the replicated product)
        local = {**local, **{k: _gather_tp(local[k], w["spec"][k], w) for k in ("A", "B")}}
        if not _live_axes(w["spec"]["base"], w["mesh"]) - {"ep"}:
            return lin.matmul_t(x, local, route, row_split)
    elif role is None and not _live_axes(w["spec"], w["mesh"]) - {"ep"}:
        return lin.matmul_t(x, local, route, row_split)
    raise ValueError(f"{w['path']}: a placed leaf with spec {w['spec']} has no tp role")


class _ColFloat(torch.autograd.Function):
    """x @ wᵀ on the rank's columns of a float weight; dx the fp32 partial
    g · w SUM-reduced over tp, then cast (GSPMD reduces the fp32 dot output
    before the cast); dw = gᵀ x, local."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return torch.matmul(x, w.t())

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = D.all_reduce(torch.matmul(gy.float(), w.float()), "sum", ctx.group,
                              "all_reduce_bwd").to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(gy.reshape(-1, gy.shape[-1]).t(), x.reshape(-1, x.shape[-1]))
        return dx, dw, None


class _ColInt8(torch.autograd.Function):
    """`ops.linear.w8a8_matmul` on the rank's columns of a per-channel int8
    leaf; dx the w8a8 STE's (JAX ``_w8a8_dot_bwd``: g in bf16 times the bf16
    dequantized weight, summed in fp32) as the rank's fp32 partial, SUM-
    reduced over tp, then cast. The codes and scales take no gradient."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.w, ctx.group = w, group
        lead, K = x.shape[:-1], x.shape[-1]
        return lin.w8a8_matmul(x.reshape(-1, K).contiguous(), w).reshape(*lead, -1)

    @staticmethod
    def backward(ctx, gy):
        w = ctx.w
        wd = w["q"].to(torch.bfloat16) * w["s"].to(torch.bfloat16)[:, None]
        dx = torch.matmul(gy.to(torch.bfloat16).float(), wd.float())
        return D.all_reduce(dx, "sum", ctx.group, "all_reduce_bwd").to(gy.dtype), None, None


def _col_product(x: torch.Tensor, local: Any, g, route: str, row_split: int) -> torch.Tensor:
    """A column-parallel product: ``ops.linear.matmul_t`` on the rank's
    columns; under autograd the input's dx partial SUM-reduced over tp, in
    fp32 for a float leaf and an int8 leaf on the w8a8 route (`_ColFloat`,
    `_ColInt8`), through `copy_to` for the other forms."""
    if not torch.is_grad_enabled():
        return lin.matmul_t(x, local, route, row_split)
    if isinstance(local, torch.Tensor):
        if x.requires_grad or local.requires_grad:
            return _ColFloat.apply(x, local, g)
        return lin.matmul_t(x, local, route, row_split)
    if lin.is_int8_per_channel(local) and route == "w8a8" and x.requires_grad:
        return _ColInt8.apply(x, local, g)
    return lin.matmul_t(D.copy_to(x, g), local, route, row_split)


def _col_lora(x: torch.Tensor, local: dict, g, route: str, row_split: int) -> torch.Tensor:
    """A streamed-LoRA wrapper over a column-parallel base, on the rank's
    columns: (x Aᵀ) B_localᵀ with A whole, the rank projection's cotangent
    SUM-reduced over tp (`_col_product` with B_local: dA and dx whole on
    every rank), then the base product (last, as `ops.linear.matmul_t`
    orders them)."""
    dt = x.dtype
    u = torch.matmul(x, local["A"].to(dt).t())
    delta = _col_product(u, local["B"].to(dt), g, route, row_split)
    return _col_product(x, local["base"], g, route, row_split) + delta


def _row_projection(x2: torch.Tensor, A: torch.Tensor, w: dict) -> torch.Tensor:
    """A LoRA rank projection over a row-parallel base: x2 [M, k] (the local
    K slice) times A [..., k]ᵀ (A cut there where the rules leave it whole),
    SUM-reduced in fp32 over tp, cast to x2's dtype: [M, prod(A's lead)]."""
    i, _, g = tp_coord(w)
    k = x2.shape[-1]
    if A.shape[-1] != k:
        A = D.copy_to(A, g).narrow(-1, i * k, k)
    u = torch.matmul(x2.float(), A.reshape(-1, k).float().t())
    return D.reduce_from(u, g).to(x2.dtype)


def _row_lora(x2: torch.Tensor, local: dict, w: dict) -> torch.Tensor:
    """A streamed-LoRA delta over a row-parallel base: the rank projection,
    then times B whole."""
    return torch.matmul(_row_projection(x2, local["A"], w), local["B"].to(x2.dtype).t())


def _row_delta(x2: torch.Tensor, local: dict, w: dict) -> torch.Tensor:
    """A multi-LoRA delta over a row-parallel base: the rank projection onto
    all N · r ranks, masked and projected back (Bt whole)."""
    A, Bt, sel = local["A"], local["Bt"], local["sel"]
    N, r = A.shape[-3:-1]
    O = Bt.shape[-1]
    u = _row_projection(x2, A, w)
    if local.get("impl", "masked") == "einsum":
        Bex = sel.shape[0]
        return torch.einsum("btnr,bn,nro->bto", u.reshape(Bex, -1, N, r), sel.to(x2.dtype),
                            Bt.to(x2.dtype)).reshape(-1, O)
    return torch.matmul(lin._rank_mask(u, sel, r), Bt.reshape(N * r, O).to(x2.dtype))


def lora_wrapper(w: Any, A: Any, B: Any) -> Any:
    """The streamed-LoRA wrapper ``{"base", "A", "B"}`` (``training.lora``):
    as it is where nothing is placed, else one placed leaf with the base's
    tp role (its spec, parts and padding) and each part's spec beside it
    (a part no axis splits: ``()``)."""
    parts = (("base", w), ("A", A), ("B", B))
    if not any(is_placed(t) for _, t in parts):
        return {"base": w, "A": A, "B": B}
    ref = next(t for _, t in parts if is_placed(t))
    out = {"local": {k: local_leaf(t) for k, t in parts},
           "spec": {k: t["spec"] if is_placed(t) else () for k, t in parts},
           "mesh": ref["mesh"], "path": ref["path"], "parts": ref["parts"]}
    if is_placed(w) and "k_valid" in w:
        out["k_valid"] = w["k_valid"]
    return out


def map_local(fn, w: Any) -> Any:
    """fn over a placed leaf's local tensor (kept placed), or over a bare tensor."""
    return {**w, "local": fn(w["local"])} if is_placed(w) else fn(w)


# --- vocab-sharded embedding and greedy head -------------------------------------------


def embed(w: Any, ids: torch.Tensor) -> torch.Tensor:
    """The embedding rows of `ids`: a plain gather, or over vocab-sharded rows
    the rank's rows (zero elsewhere) SUM-reduced over tp (one non-zero term
    an element: exact in the table's dtype)."""
    if not is_placed(w):
        return w[ids]
    if tp_role(w) != "col":
        raise ValueError(f"{w['path']}: an embedding split other than by vocabulary rows")
    i, _, g = tp_coord(w)
    table = w["local"]
    v_loc = table.shape[0]
    rel = ids - i * v_loc
    mine = (rel >= 0) & (rel < v_loc)
    rows = table[rel.clamp(0, v_loc - 1)]
    out = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return D.reduce_from(out, g)


def gather_cols(y: torch.Tensor, w: Any) -> torch.Tensor:
    """A column-parallel product's local columns gathered into the whole
    [..., O] (as it is for any other leaf)."""
    if tp_role(w) != "col":
        return y
    _, _, g = tp_coord(w)
    return D.all_gather(y, y.dim() - 1, g, backward="split")


def greedy(logits: torch.Tensor, w: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmax token [B], top1 - top2 margin [B]) of fp32 logits [B, V]: over
    the whole vocabulary where `w` (the lm_head) splits it over tp, each
    rank's best two and its argmax gathered; ties go to the lowest index, as
    ``torch.argmax`` breaks them."""
    if tp_role(w) != "col":
        from ..models.llama import top2_margin

        tok = logits.argmax(-1)
        return tok, top2_margin(logits, tok)
    i, n, g = tp_coord(w)
    v_loc = logits.shape[-1]
    tok = logits.argmax(-1)
    cols = torch.arange(v_loc, device=logits.device)[None, :]
    second = logits.masked_fill(cols == tok[:, None], float("-inf")).amax(-1)
    vals = torch.stack([logits.amax(-1), second], dim=-1)     # each rank's best two
    idx = (tok + i * v_loc)[:, None]
    all_vals = D.all_gather(vals[None], 0, g)          # [n, B, 2]
    all_idx = D.all_gather(idx[None], 0, g)[..., 0]     # [n, B]
    top1 = all_vals[..., 0]
    best = top1.amax(0)                                  # [B]
    win = (top1 == best[None]).int().argmax(0)           # the lowest rank holding the max
    ar = torch.arange(win.shape[0], device=win.device)
    token = all_idx[win, ar]
    others = top1.clone()
    others[win, ar] = all_vals[win, ar, 1]               # the winner's second value
    return token, best - others.amax(0)


def token_nll(logits: torch.Tensor, targets: torch.Tensor, w: Any) -> torch.Tensor:
    """-log softmax(logits)[target] in fp32 a row, for logits [M, V] (or the
    rank's vocabulary columns [M, V / tp] where `w`, the lm_head, splits it
    over tp) and global target ids [M]. Over a split vocabulary the [M, V]
    logits are never gathered: the row max by a MAX all-reduce (no
    gradient), the sum of exponentials and the target's logit (from the rank
    that holds it, zero elsewhere) by SUM all-reduces (`reduce_from`)."""
    logits = logits.float()
    if tp_role(w) != "col":
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets[:, None].long())[:, 0]
    i, _, g = tp_coord(w)
    v_loc = logits.shape[-1]
    m = D.all_reduce(logits.detach().amax(-1, keepdim=True), "max", g)
    z = D.reduce_from(torch.exp(logits - m).sum(-1), g)
    rel = targets.long() - i * v_loc
    mine = (rel >= 0) & (rel < v_loc)
    picked = torch.gather(logits, -1, rel.clamp(0, v_loc - 1)[:, None])[:, 0]
    t = D.reduce_from(torch.where(mine, picked, torch.zeros_like(picked)), g)
    return torch.log(z) + m[:, 0] - t


# --- expert parallelism ------------------------------------------------------------


def ep_range(w: Any) -> Optional[Tuple[int, int, Any]]:
    """(first expert, experts here, the ep group) of an expert stack split on
    ep (a per-layer [E, ...] leaf), or None."""
    if not is_placed(w) or w["mesh"].axis_size("ep") <= 1:
        return None
    local = w["local"]
    spec = w["spec"]
    form = _form(local)
    if form in ("lora", "lora_ab"):
        raise NotImplementedError(f"{w['path']}: a LoRA-wrapped expert stack split on ep")
    key = _CODES[form]
    t = _tensor(local, key)
    rs = _rs(_spec_of(spec, key), t.dim())
    e_dim = -4 if form == "int4" else -3
    if rs[e_dim] != "ep":
        return None
    m = w["mesh"]
    e_loc = t.shape[e_dim]
    return m.coord("ep") * e_loc, e_loc, m.group("ep")


def ep_local(w: Any) -> Any:
    """An ep-split expert stack's local leaf (the rank's experts), refusing a
    stack tp splits as well."""
    if tp_role(w) is not None:
        raise NotImplementedError(f"{w['path']}: an expert stack split on tp as well as ep")
    return w["local"]
