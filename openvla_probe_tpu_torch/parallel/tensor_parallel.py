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
  max, MAX all-reduce), codes from that scale (`linear.w8a8_quant_given`),
  int32 partials (`linear.w8a8_matmul_i32`) summed in int32, then the
  epilogue (`linear.w8a8_epilogue`): bit-equal to one card. Every other
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


def _gather_fsdp(t: torch.Tensor, spec, mesh) -> Tuple[torch.Tensor, tuple]:
    rs = _rs(spec, t.dim())
    for d, axis in enumerate(rs):
        if axis == "fsdp" and mesh.axis_size("fsdp") > 1:
            t = D.all_gather(t, d, mesh.group("fsdp"))
    return t, tuple(None if a == "fsdp" else a for a in rs)


def resolve(w: Any) -> Any:
    """A placed leaf with its fsdp dims all-gathered: a placed leaf of what
    is left (tp, ep), or the bare whole leaf where nothing is."""
    if not is_placed(w):
        return w
    mesh, spec, local = w["mesh"], w["spec"], w["local"]
    if "fsdp" not in _live_axes(spec, mesh):
        return w
    if isinstance(local, dict):
        pairs = {k: _gather_fsdp(local[k], spec[k], mesh) for k in local}
        local = {k: p[0] for k, p in pairs.items()}
        spec = {k: p[1] for k, p in pairs.items()}
    else:
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
    hold a whole scale beside its local codes)."""
    if isinstance(local, torch.Tensor):
        return "float"
    keys = set(local)
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
    if form == "lora":
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
    qkv its three parts' slices)."""
    i, n, _ = tp_coord(w)
    if t.shape[dim] == n_local:
        return t
    return _slice_dim(t, dim, n, i, w["parts"])


def _col_local(local: Any, w: dict) -> Any:
    """The column-parallel local leaf with every tensor on the rank's columns."""
    form = _form(local)
    if form == "lora":   # the base on its columns, and Bt's out dim with it
        base = _col_local(local["base"], w)
        b_form = _form(base)
        key = _CODES[b_form]
        n_loc = _tensor(base, key).shape[_OUT_DIM[b_form][key]]
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
    local = w["local"]
    while _form(local) == "lora":
        local = local["base"]
    form = _form(local)
    key = _CODES[form]
    return _out_slice(b, -1, _tensor(local, key).shape[_OUT_DIM[form][key]], w)


def rank_cols(t: torch.Tensor, width: int, ref: dict) -> torch.Tensor:
    """t [..., width] as it is, or the output of a product tp leaves whole
    ([..., n·width]) cut to this rank's `width` columns (`ref`: a placed leaf
    of the same mesh, for the coordinate)."""
    if t.shape[-1] == width:
        return t
    i, n, _ = tp_coord(ref)
    if t.shape[-1] != n * width:
        raise ValueError(f"{ref['path']}: {t.shape[-1]} columns are neither {width} nor {n} x that")
    return t.narrow(-1, i * width, width)


def input_for(x: torch.Tensor, w: Any, ref: Any) -> torch.Tensor:
    """The input of product `w` where x holds the local columns of
    column-parallel `ref`'s output: all-gathered when tp does not split `w`
    (a leaf the rules leave whole takes the whole input); as it is otherwise
    (a placed leaf takes or slices it itself)."""
    if tp_role(w) is not None or tp_role(ref) != "col":
        return x
    _, _, g = tp_coord(ref)
    return D.all_gather(x, x.dim() - 1, g)


def _contraction(local: Any) -> int:
    """A leaf's contraction width (a LoRA wrapper's base's; packed 4-bit
    codes unpacked)."""
    while _form(local) == "lora":
        local = local["base"]
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
    i, n, _ = tp_coord(w)
    if x.shape[-1] == k:
        return x
    if x.shape[-1] != n * k:
        raise ValueError(f"{w['path']}: input width {x.shape[-1]} is neither the local "
                         f"contraction {k} nor the whole {n * k}")
    return x.narrow(-1, i * k, k)


def _whole_input(x: torch.Tensor, k: int, w: dict) -> torch.Tensor:
    """x [..., K] whole, all-gathering the ranks' slices where x is one."""
    if x.shape[-1] == k:
        return x
    _, n, g = tp_coord(w)
    if x.shape[-1] * n != k:
        raise ValueError(f"{w['path']}: input width {x.shape[-1]} is neither the leaf's "
                         f"contraction {k} nor a tp slice of it")
    return D.all_gather(x, x.dim() - 1, g)


def _gather_k(local: Any, w: dict) -> Any:
    """A row-parallel leaf's K shards all-gathered into the whole leaf (the
    tensors its spec splits on tp; a scale a rule leaves whole stays)."""
    _, _, g = tp_coord(w)
    form = _form(local)
    if form == "float":
        return D.all_gather(local, local.dim() - 1, g, WHOLE_LEAF)
    if "k_valid" in w:
        local = {**local, "q": local["q"][..., :w["k_valid"]]}
    out = {}
    for k, v in local.items():
        d = _K_DIM[form].get(k)
        split = d is not None and _rs(w["spec"][k], v.dim())[d] == "tp"
        out[k] = D.all_gather(v, v.dim() + d, g, WHOLE_LEAF) if split else v
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
    full = D.all_gather(t, d, g, WHOLE_LEAF)
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


def _row_exact(x2: torch.Tensor, local: dict, w: dict) -> torch.Tensor:
    """The exact row-parallel w8a8 product of x2 [M, k] (the rank's columns)
    and per-channel int8 or nibble codes: XLA's partition of ``_w8a8_dot``."""
    _, _, g = tp_coord(w)
    amax = x2.abs().amax(dim=-1, keepdim=True).float()
    D.all_reduce(amax, "max", g)
    sx = torch.clamp(lin.div127(amax), min=1e-8)
    k_pad = local["q"].shape[-1] if "q" in local else 2 * local["hi"].shape[-1]
    codes = lin.w8a8_quant_given(x2, sx, k_pad, nibble="hi" in local)
    acc = lin.w8a8_matmul_i32(codes, local)
    D.all_reduce(acc, "sum", g)
    return lin.w8a8_epilogue(acc, sx, local["s"], x2.dtype)


def _row_base(x2: torch.Tensor, local: Any, w: dict, route: str, row_split: int) -> torch.Tensor:
    form = _form(local)
    _, _, g = tp_coord(w)
    M = x2.shape[0] * row_split
    if form == "float":
        y = torch.matmul(x2.float(), local.float().t())
        return D.all_reduce(y, "sum", g).to(x2.dtype)
    if exact_row(form, route, M):
        return _row_exact(x2, lin.int8_copy(local) if form == "mix" else local, w)
    # a route whose kernel computes its own activation scale: the whole product on each rank
    x_whole = D.all_gather(x2, 1, g)
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
        return lin.matmul_t(_whole_input(x, _contraction(local), w), local, route, row_split)
    if role == "row":
        if isinstance(x, lin.PrequantActivation):
            raise TypeError(f"{w['path']}: a row-parallel leaf takes a float input")
        k = _k_local(w)
        xl = _input_cols(x, k, w)
        lead = xl.shape[:-1]
        x2 = xl.reshape(-1, k).contiguous()
        if _form(local) == "lora":
            y = _row_base(x2, local["base"], {**w, "spec": w["spec"]["base"]}, route, row_split)
            y = y + _row_delta(x2, local, w)
        else:
            y = _row_base(x2, local, w, route, row_split)
        return y.reshape(*lead, -1)
    if role is None and not _live_axes(w["spec"], w["mesh"]) - {"ep"}:
        return lin.matmul_t(x, local, route, row_split)
    raise ValueError(f"{w['path']}: a placed leaf with spec {w['spec']} has no tp role")


def _row_delta(x2: torch.Tensor, local: dict, w: dict) -> torch.Tensor:
    """A multi-LoRA delta over a row-parallel base: the rank projection x · Aᵀ
    of the local K slice, SUM-reduced in fp32, cast, masked and projected
    back (Bt whole)."""
    i, n, g = tp_coord(w)
    A, Bt, sel = local["A"], local["Bt"], local["sel"]
    k = x2.shape[-1]
    if A.shape[-1] != k:   # a factor the rules leave whole: the rank's K slice
        A = A.narrow(-1, i * k, k)
    N, r, _ = A.shape
    O = Bt.shape[-1]
    u = torch.matmul(x2.float(), A.reshape(N * r, -1).float().t())
    u = D.all_reduce(u, "sum", g).to(x2.dtype)
    if local.get("impl", "masked") == "einsum":
        Bex = sel.shape[0]
        return torch.einsum("btnr,bn,nro->bto", u.reshape(Bex, -1, N, r), sel.to(x2.dtype),
                            Bt.to(x2.dtype)).reshape(-1, O)
    return torch.matmul(lin._rank_mask(u, sel, r), Bt.reshape(N * r, O).to(x2.dtype))


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
    return D.all_reduce(out, "sum", g)


def gather_cols(y: torch.Tensor, w: Any) -> torch.Tensor:
    """A column-parallel product's local columns gathered into the whole
    [..., O] (as it is for any other leaf)."""
    if tp_role(w) != "col":
        return y
    _, _, g = tp_coord(w)
    return D.all_gather(y, y.dim() - 1, g)


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


# --- expert parallelism ------------------------------------------------------------


def ep_range(w: Any) -> Optional[Tuple[int, int, Any]]:
    """(first expert, experts here, the ep group) of an expert stack split on
    ep (a per-layer [E, ...] leaf), or None."""
    if not is_placed(w) or w["mesh"].axis_size("ep") <= 1:
        return None
    local = w["local"]
    spec = w["spec"]
    form = _form(local)
    if form == "lora":
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
