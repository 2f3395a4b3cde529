"""Parameter placement over the rank mesh (counterpart of
``openvla_probe_tpu/parallel/sharding.py``).

The port keeps its own copy of the JAX package's rule table (megatron tp for
the trunk and the towers, vocab-sharded embeddings, the expert rule, the
quantized / grouped-int4 / LoRA / bank rules, fsdp on the largest divisible
dim, tiny leaves whole). `param_spec` gives, for one leaf, the JAX
``PartitionSpec``'s entries as a tuple (an axis name or None a dim; the
empty tuple for a whole leaf); `shard_params` the spec tree of a parameter
tree, visiting quantized and nibble leaves whole as the JAX function does.
Packed 4-bit tensors (grouped int4 codes, nibble planes: two codes a byte)
take the spec of their unpacked shape, the JAX package's storage.

`place_params` returns this rank's local tree: each sharded leaf sliced by
its spec and the rank's mesh coordinates, wrapped as a *placed leaf*
``{"local": leaf, "spec": spec, "mesh": mesh, "path": str, "parts": n,
"k_valid": k}`` that the forward reads (`parallel.tensor_parallel`); a leaf
no axis splits stays bare. Two placements differ from a plain slice:

* the ViT's fused ``qkv_w`` [L, 3D, D] on tp: contiguous halves would cut
  across q, k and v, so the rank's slice holds its heads of each of the
  three (``"parts": 3``), and so does a LoRA factor of it split on its out
  dim (``qkv_w/B``, a multi-LoRA ``qkv_w/Bt``);
* a per-channel int8 leaf whose tp-local contraction is not a multiple of
  16 (the w8a8 kernels' rule; SigLIP's fc2 at tp = 2: 4304 / 2 = 2152) gets
  zero codes appended to its local K (``"k_valid"`` the true width): the
  row-parallel product writes zero activation codes there, so the int32 sum
  is unchanged.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from ..ops.linear import is_grouped_int4, is_int8_per_channel, is_nibble_quant, is_quantized
from .mesh import Mesh, Spec

MIN_SHARD_ELEMS = 2**14  # replicate tiny tensors (norms, biases)
KMULT = 16               # the w8a8 kernels' contraction multiple (int8 codes)

# --- tp rules: path-pattern -> dim to shard --------------------------------
# Llama stacked-layer weights are [L, out, in]; embeddings [V, D].
_TP_DIM_BY_SUFFIX = {
    "q_proj": 1, "k_proj": 1, "v_proj": 1,       # shard heads (out dim)
    "gate_proj": 1, "up_proj": 1,                # shard ffn (out dim)
    "o_proj": 2, "down_proj": 2,                 # shard contraction (in dim)
    "embed_tokens": 0, "lm_head": 0,             # shard vocab
    # ViT blocks [L, out, in]
    "qkv_w": 1, "fc1_w": 1,
    "proj_w": 2, "fc2_w": 2,
}

_MOE_EXPERT_LEAVES = ("gate_proj", "up_proj", "down_proj")


def _tp_dim(path: str, shape: Tuple[int, ...], grouped_int4: bool = False) -> Optional[int]:
    """The JAX package's rule, dim for dim: MoE expert stacks shift the tp dim
    right by their E axis; quantized q / s, LoRA A / B / Bt and bank leaves
    follow their parent weight's rule, addressed from the end; projector
    {fc*: {w, b}} by fc index."""
    parts = path.rsplit("/", 2)
    leaf = parts[-1]
    if leaf in _MOE_EXPERT_LEAVES and len(shape) == 4:
        return _TP_DIM_BY_SUFFIX[leaf] + 1
    if leaf in ("q", "s") and len(parts) >= 2:
        d0 = _TP_DIM_BY_SUFFIX.get(parts[-2])
        if d0 is None:
            return None
        is_out = d0 != 2
        n = len(shape)
        if grouped_int4:
            if leaf == "q":
                return n - 2 if is_out else n - 3
            return n - 2 if is_out else n - 1
        if leaf == "q":
            return n - 2 if is_out else n - 1
        return n - 1 if is_out else None
    if leaf in ("A", "B", "Bt") and len(parts) >= 2:
        d0 = _TP_DIM_BY_SUFFIX.get(parts[-2])
        if d0 is None:
            return None
        is_out = d0 != 2
        if leaf == "A":
            return None if is_out else len(shape) - 1
        if leaf == "Bt":
            return len(shape) - 1 if is_out else None
        return len(shape) - 2 if is_out else None
    if leaf == "w" and len(shape) == 2:
        if "/fc1/" in path or path.endswith("fc1/w"):
            return 0
        return 1 if "/fc2/" in path or "/fc3/" in path else None
    return _TP_DIM_BY_SUFFIX.get(leaf)


def _fsdp_dim(shape: Tuple[int, ...], axis_size: int, skip: Tuple[int, ...] = ()) -> Optional[int]:
    """Largest dim divisible by the axis size (excluding `skip` dims)."""
    best, best_size = None, 0
    for d, s in enumerate(shape):
        if d in skip:
            continue
        if s % axis_size == 0 and s > best_size:
            best, best_size = d, s
    return best


def param_spec(path: str, shape: Tuple[int, ...], mesh: Mesh, strategy: str = "fsdp",
               grouped_int4: bool = False) -> Spec:
    """The split of one parameter tensor: the JAX ``PartitionSpec``'s entries
    (the empty tuple for a whole leaf). `shape` is the JAX package's (for a
    packed 4-bit tensor, its unpacked shape); `grouped_int4` as there."""
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) < MIN_SHARD_ELEMS:
        return ()
    entries: list = [None] * len(shape)
    used_dims = set()
    ep = mesh.shape.get("ep", 1)
    if ep > 1:
        parts = path.rsplit("/", 2)
        leaf = parts[-1]
        name = parts[-2] if leaf in ("q", "s", "A", "B") and len(parts) >= 2 else leaf
        min_ndim = (3 if leaf == "s" else 4) + (1 if grouped_int4 else 0)
        if name in _MOE_EXPERT_LEAVES and len(shape) == min_ndim and shape[1] % ep == 0:
            entries[1] = "ep"
            used_dims.add(1)
    tp = mesh.shape.get("tp", 1)
    if "tp" in strategy and tp > 1:
        d = _tp_dim(path, shape, grouped_int4=grouped_int4)
        if d is not None and shape[d] % tp == 0:
            entries[d] = "tp"
            used_dims.add(d)
    fsdp = mesh.shape.get("fsdp", 1)
    if "fsdp" in strategy and fsdp > 1:
        # layer-stacked tensors: never shard the stack axis (the layer loop walks it)
        skip = set(used_dims)
        if ("layers/" in path or "blocks/" in path) and len(shape) >= 2:
            skip.add(0)
        d = _fsdp_dim(shape, fsdp, skip=tuple(skip))
        if d is not None:
            entries[d] = "fsdp"
    return tuple(entries)


def _unpacked(t: torch.Tensor) -> Tuple[int, ...]:
    """The JAX package's shape of a stored tensor: packed uint8 4-bit codes
    (two a byte) unpacked."""
    shape = tuple(t.shape)
    return shape[:-1] + (2 * shape[-1],) if t.dtype == torch.uint8 else shape


def _is_leaf_group(x: Any) -> bool:
    return is_quantized(x) or is_nibble_quant(x)


def _leaf_spec(path: str, leaf: Any, mesh: Mesh, strategy: str):
    if is_nibble_quant(leaf):
        return {k: param_spec(f"{path}/{'s' if k == 's' else 'q'}", _unpacked(leaf[k]), mesh,
                              strategy) for k in leaf}
    if is_quantized(leaf):
        grouped = is_grouped_int4(leaf)
        return {k: param_spec(f"{path}/{k.rstrip('4')}", _unpacked(leaf[k]), mesh, strategy,
                              grouped_int4=grouped or k in ("q4", "s4"))
                for k in leaf}
    return param_spec(path, tuple(leaf.shape), mesh, strategy)


def shard_params(params: Any, mesh: Mesh, strategy: str = "fsdp", _path: str = "") -> Any:
    """The spec tree mirroring `params` (tuples for tensors, a dict of tuples
    for a quantized or nibble leaf, visited whole; anything that is not a
    tensor, e.g. a bank tree's None, kept as it is)."""
    if _is_leaf_group(params):
        return _leaf_spec(_path, params, mesh, strategy)
    if isinstance(params, dict):
        return {k: shard_params(v, mesh, strategy, f"{_path}/{k}" if _path else str(k))
                for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return param_spec(_path, tuple(params.shape), mesh, strategy)
    if isinstance(params, tuple) and hasattr(params, "_fields"):   # a NamedTuple state
        return type(params)(*(shard_params(v, mesh, strategy, f"{_path}/{k}" if _path else k)
                              for k, v in zip(params._fields, params)))
    if isinstance(params, (list, tuple)):
        return type(params)(shard_params(v, mesh, strategy, f"{_path}/{i}" if _path else str(i))
                            for i, v in enumerate(params))
    return params


def sharded_axes(spec) -> set:
    """The mesh axes a spec (or a dict of specs) splits on."""
    if isinstance(spec, dict):
        return set().union(*(sharded_axes(s) for s in spec.values())) if spec else set()
    return {a for a in spec if a is not None}


def _slice_dim(t: torch.Tensor, dim: int, n: int, i: int, parts: int = 1) -> torch.Tensor:
    """Chunk i of n along `dim` (of each of `parts` equal parts, concatenated)."""
    size = t.shape[dim]
    if size % (n * parts):
        raise ValueError(f"cannot split a dim of {size} into {parts} x {n} chunks")
    if parts == 1:
        return t.narrow(dim, i * (size // n), size // n)
    p = size // parts
    return torch.cat([t.narrow(dim, j * p + i * (p // n), p // n) for j in range(parts)], dim=dim)


def local_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh, parts: int = 1) -> torch.Tensor:
    """This rank's block of tensor `t` under `spec` (right-aligned to t's dims:
    a layer index taken off the front keeps the rest); `parts` > 1 splits
    the tp dim by parts (the fused qkv). A packed 4-bit last dim splits in
    bytes. Returns a contiguous copy where anything was cut."""
    spec = tuple(spec)[-t.dim():] if spec else ()
    off = t.dim() - len(spec)
    out = t
    for d, axis in enumerate(spec):
        n = mesh.axis_size(axis)
        if n > 1:
            out = _slice_dim(out, off + d, n, mesh.coord(axis), parts if axis == "tp" else 1)
    return out.contiguous() if out is not t else t


def _pad_k(q: torch.Tensor, k_pad: int) -> torch.Tensor:
    """int8 codes [..., K] with zero codes appended up to `k_pad`."""
    return torch.nn.functional.pad(q, (0, k_pad - q.shape[-1]))


def place_leaf(path: str, leaf: Any, spec, mesh: Mesh):
    """One leaf's local form: bare where no axis of size > 1 splits it, else a
    placed leaf (see the module docstring)."""
    if not any(mesh.axis_size(a) > 1 for a in sharded_axes(spec)):
        return leaf
    # the fused qkv, and its LoRA factors and moments (".../qkv_w/B"), cut by parts
    parts = 3 if "qkv_w" in path.rsplit("/", 2)[-2:] else 1
    if isinstance(leaf, dict):
        local = {k: local_tensor(v, spec[k], mesh, parts) for k, v in leaf.items()}
    else:
        local = local_tensor(leaf, spec, mesh, parts)
    placed = {"local": local, "spec": spec, "mesh": mesh, "path": path, "parts": parts}
    if is_int8_per_channel(leaf) and spec["q"] and spec["q"][-1] == "tp":
        k_loc = local["q"].shape[-1]
        if k_loc % KMULT:
            local["q"] = _pad_k(local["q"], -(-k_loc // KMULT) * KMULT)
            placed["k_valid"] = k_loc
    return placed


def place_params(params: Any, mesh: Mesh, strategy: str = "fsdp", _path: str = "",
                 _spec: Any = None) -> Any:
    """This rank's local tree: every leaf sliced by its spec (`shard_params`)
    and the rank's coordinates, a placed leaf where anything was cut."""
    spec = shard_params(params, mesh, strategy, _path) if _spec is None else _spec
    if _is_leaf_group(params) or isinstance(params, torch.Tensor):
        return place_leaf(_path, params, spec, mesh)
    if isinstance(params, dict):
        return {k: place_params(v, mesh, strategy, f"{_path}/{k}" if _path else str(k), spec[k])
                for k, v in params.items()}
    return params


def shard_train_state(state: Any, mesh: Mesh, strategy: str = "fsdp") -> Any:
    """The spec trees of a train state (``training.train_state.TrainState``:
    step, params, opt_state): ``zero2`` (parameters whole, or tp-sharded with
    "zero2+tp"; optimizer moments fsdp-sharded), any other strategy applied
    uniformly (the JAX function's rule). The sharded train step reads it
    (``training.train_step.make_sharded_train_step``)."""
    if "zero2" in strategy:
        p_strategy = strategy.replace("zero2", "").strip("+") or "none"
        o_strategy = strategy.replace("zero2", "fsdp")
    else:
        p_strategy = o_strategy = strategy
    return type(state)(step=(), params=shard_params(state.params, mesh, p_strategy),
                       opt_state=shard_params(state.opt_state, mesh, o_strategy))
