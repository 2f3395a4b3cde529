"""The rank mesh over dp / fsdp / tp / ep axes (counterpart of
``openvla_probe_tpu/parallel/mesh.py``).

A `Mesh` lays the ranks of the process group out on named axes in C order
(the JAX package reshapes its device list the same way), so rank r sits at
``np.unravel_index(r, sizes)``. Each axis has one process group a rank
belongs to: the ranks that differ from it only along that axis, in
coordinate order (None where the axis has size 1, or where no process group
runs: a mesh built from a device count alone, for the placement rules).

`replicated`, `data_sharding` and `sequence_sharding` return which axis a
batch leaf splits on (a tuple of axis names or None per dim, the JAX
``PartitionSpec``'s entries), choosing as the JAX functions do.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np

Spec = Tuple[Optional[str], ...]


class Mesh:
    """Ranks on named axes: `shape` {axis: size} (insertion order), `rank`
    this process's rank, `coords` {axis: index}, `group(axis)` the process
    group along an axis."""

    def __init__(self, axes: Dict[str, int], rank: int = 0, groups: Optional[dict] = None):
        self.shape: Dict[str, int] = dict(axes)
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.size = math.prod(axes.values())
        self.rank = rank
        idx = np.unravel_index(rank, tuple(axes.values())) if axes else ()
        self.coords: Dict[str, int] = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self._groups = groups or {}

    def axis_size(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis is not None else 1

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group along `axis` (None: a group of one rank, or no
        process group running)."""
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _axis_ranks(sizes: Tuple[int, ...], axis: int):
    """Every group of ranks along `axis`: the ranks of each line of the grid."""
    grid = np.arange(math.prod(sizes)).reshape(sizes)
    lines = np.moveaxis(grid, axis, -1).reshape(-1, sizes[axis])
    return [list(map(int, line)) for line in lines]


def make_mesh(axes: Optional[Dict[str, int]] = None, devices: Any = None) -> Mesh:
    """Build a mesh from {axis_name: size}; -1 means "remaining ranks".

    `devices`: the number of ranks (or a sequence of that length); by default
    the process group's world size, 1 without a group. The JAX package's
    rules and errors. Default: all ranks on one ``fsdp`` axis. When a process
    group of exactly that many ranks runs, each axis gets its process groups
    (``torch.distributed.new_group``, which every rank calls in the same
    order)."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if devices is None:
        n = dist.get_world_size() if live else 1
    else:
        n = devices if isinstance(devices, int) else len(devices)
    axes = dict(axes or {"fsdp": n})
    n_fixed = 1
    wild = None
    for name, size in axes.items():
        if size == -1:
            if wild is not None:
                raise ValueError("only one axis may be -1")
            wild = name
        else:
            n_fixed *= size
    if wild is not None:
        if n % n_fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes {axes}")
        axes[wild] = n // n_fixed
    total = math.prod(axes.values())
    if total != n:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n}")
    if not (live and dist.get_world_size() == n):
        return Mesh(axes)
    rank = dist.get_rank()
    sizes = tuple(axes.values())
    groups = {}
    for i, name in enumerate(axes):
        if sizes[i] == 1:
            continue
        for ranks in _axis_ranks(sizes, i):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    return Mesh(axes, rank, groups)


def replicated(mesh: Mesh) -> Spec:
    return ()


def data_sharding(mesh: Mesh, axis: str = "dp") -> Spec:
    """The batch dim's split for input trees."""
    if axis not in mesh.axis_names:
        return replicated(mesh)
    return (axis,)


def sequence_sharding(mesh: Mesh, batch, seq_axis: str = "sp", batch_axis: str = "dp"):
    """Sequence-parallel splits of a batch tree: [B, T] token arrays split T
    over `seq_axis` (and B over `batch_axis`) where T divides by its size;
    every other leaf splits the batch only (the JAX function's choice, its
    fallback included). ``training.train_step.make_sharded_train_step``
    reads it: its ranks on sp split the spliced sequence."""
    def spec(x):
        if seq_axis in mesh.axis_names and getattr(x, "ndim", 0) == 2 \
                and x.shape[1] % mesh.shape[seq_axis] == 0:
            return (batch_axis if batch_axis in mesh.axis_names else None, seq_axis)
        return data_sharding(mesh, batch_axis)

    if isinstance(batch, dict):
        return {k: sequence_sharding(mesh, v, seq_axis, batch_axis) for k, v in batch.items()}
    return spec(batch)
