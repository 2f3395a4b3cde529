"""Multi-process initialisation, cross-process helpers and the collectives the
sharded forward issues (counterpart of ``openvla_probe_tpu/parallel/distributed.py``).

`initialize_distributed` wraps ``torch.distributed.init_process_group`` and
reads the JAX function's environment names (``COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``); it is a no-op on one process. The
backend follows one declared rule (`backend_rule`), printed when a group
starts and never switched after a failure:

* ``nccl`` when every rank has a card of its own;
* ``gloo`` when ranks share a card (NCCL refuses two ranks on one device) or
  run on the CPU.

Gloo takes CUDA tensors in every collective the sharded forward issues
(all_reduce: int32 SUM, fp32 MAX, bf16 SUM; all_gather; broadcast: checked
on an H100 with PyTorch 2.11), so nothing is staged through host memory.
Every collective adds the bytes it moves to `COLLECTIVE_BYTES` (the tensor's
bytes on each rank) and one to `COLLECTIVE_CALLS`, under its tag, so a caller
can show what a call exchanged.

Under autograd (the sharded train step) the collectives of the forward are
``torch.autograd.Function``s, each backward the transpose of its forward:

* `reduce_from`: a SUM all-reduce of partials whose result every rank of the
  group then uses as its own (a row-parallel product's sum): identity
  backward;
* `copy_to`: the identity into a region whose ranks each use part of the
  tensor (a column-parallel product's input): a SUM all-reduce of the
  cotangent in fp32 backward (tag ``all_reduce_bwd``);
* `all_gather`: backward the rank's slice of the SUM-reduced cotangent (a
  reduce-scatter's result) where the ranks' uses of the gathered tensor are
  terms of one sum (fsdp leaves, sequence-parallel K/V), or the rank's slice
  alone (``backward="split"``) where every rank of the group runs the same
  computation on it (tp activations). Gloo has no reduce-scatter, so the
  first is a SUM all-reduce of the whole cotangent and then the slice, world
  times a reduce-scatter's bytes, counted as such under its own tag
  ``all_reduce_slice_bwd``;
* a MAX all-reduce (the activation scale) takes no gradient: it runs on a
  detached tensor.

Without grad every one of them is today's in-place call, counted as before.

`run_ranks` starts one process a rank (spawned, so each has its own CUDA
context), each joining a ``file://`` rendezvous (no TCP port to race for),
and returns each rank's result; a rank that fails, exits without a result or
outlives the timeout fails the whole run.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from collections import Counter
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)

COLLECTIVE_BYTES: Counter = Counter()   # collective -> bytes moved (the tensor's, each rank)
COLLECTIVE_CALLS: Counter = Counter()   # collective -> calls


def reset_collective_counts() -> None:
    COLLECTIVE_BYTES.clear()
    COLLECTIVE_CALLS.clear()


def backend_rule(device: str, world_size: int, cards: int) -> str:
    """The backend of a group of `world_size` ranks on `device` ("cpu" or
    "cuda") with `cards` cards on the host: nccl when every rank has a card of
    its own, gloo when ranks share a card or run on the CPU."""
    if device == "cpu":
        return "gloo"
    return "nccl" if world_size <= cards else "gloo"


def rank_device(rank: int, device: str) -> torch.device:
    """The device rank `rank` runs on: its own card where there are enough,
    else the cards in turn (ranks sharing a card under gloo)."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> Optional[str]:
    """Join the process group (a no-op on a single process). The address is
    ``host:port`` (a TCP rendezvous) or a URL (``tcp://``, ``file://``).
    `device` "cuda" (the default) runs the ranks on cards, "cpu" on the host.
    Returns the backend, or None on a single process."""
    env = os.environ
    if num_processes in (None, 1) and coordinator_address is None and (
            "COORDINATOR_ADDRESS" not in env):
        if int(env.get("JAX_NUM_PROCESSES", "1")) <= 1:
            overwatch.info("single-process run; skipping torch.distributed init")
            return None
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    world = num_processes or int(env.get("JAX_NUM_PROCESSES", "0")) or None
    rank = process_id if process_id is not None else (
        int(env["JAX_PROCESS_ID"]) if "JAX_PROCESS_ID" in env else None)
    if addr is None or world is None or rank is None:
        raise ValueError("a multi-process run needs the coordinator address, the number of "
                         "processes and this process's id (arguments or COORDINATOR_ADDRESS, "
                         "JAX_NUM_PROCESSES, JAX_PROCESS_ID)")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed(device='cuda'): no CUDA device; pass "
                           "device='cpu' to run the ranks on the host")
    cards = torch.cuda.device_count() if device == "cuda" else 0
    backend = backend_rule(device, world, cards)
    if device == "cuda":
        torch.cuda.set_device(rank_device(rank, device))
    url = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)
    where = "the host" if device == "cpu" else (
        "a card a rank" if backend == "nccl" else f"ranks sharing {cards} card(s)")
    overwatch.info(f"distributed: rank {rank}/{world}, backend {backend} ({where})")
    return backend


def _group_live() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _group_live() else 0


def process_count() -> int:
    return dist.get_world_size() if _group_live() else 1


def is_primary() -> bool:
    """True on the one process that owns shared-filesystem writes (rank 0;
    every process without a group). The single home of the multi-process
    file-writer invariant, as in the JAX package."""
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (a no-op on one process)."""
    if process_count() == 1:
        return
    dist.barrier()


def broadcast_host_value(value: np.ndarray) -> np.ndarray:
    """Process-0 value -> all processes (config / seed distribution)."""
    value = np.asarray(value)
    if process_count() == 1:
        return value
    box = [value if is_primary() else None]
    dist.broadcast_object_list(box, src=0)
    return np.asarray(box[0])


# --- collectives --------------------------------------------------------------------


def _count(op: str, t: torch.Tensor) -> None:
    COLLECTIVE_CALLS[op] += 1
    COLLECTIVE_BYTES[op] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, op: str, group, tag: str = "all_reduce") -> torch.Tensor:
    """In-place SUM / MAX / MIN all-reduce of `t` over `group` (None: a group
    of one, nothing to do), counted under `tag`. Returns `t`."""
    if group is None:
        return t
    _count(tag, t)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(t, op=red, group=group)
    return t


def _gather(t: torch.Tensor, dim: int, group, tag: str) -> torch.Tensor:
    _count(tag, t)
    n = dist.get_world_size(group)
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def _records(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def group_rank(group) -> int:
    """This process's rank in `group` (None: a group of one, 0)."""
    return 0 if group is None else dist.get_rank(group)


def _rank_slice(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = g.shape[dim] // dist.get_world_size(group)
    return g.narrow(dim, group_rank(group) * n, n)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        # a copy: autograd may hand the same cotangent to another branch
        red = all_reduce(g.to(torch.float32, copy=True), "sum", ctx.group, "all_reduce_bwd")
        return red.to(g.dtype), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, tag, backward):
        ctx.dim, ctx.group, ctx.backward = dim, group, backward
        return _gather(t, dim, group, tag)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "reduce_scatter":
            g = all_reduce(g.contiguous().clone(), "sum", ctx.group, "all_reduce_slice_bwd")
        return _rank_slice(g, ctx.dim, ctx.group), None, None, None, None


def all_gather(t: torch.Tensor, dim: int, group, tag: str = "all_gather",
               backward: str = "reduce_scatter") -> torch.Tensor:
    """The group's tensors concatenated along `dim` in rank order (None: `t`),
    counted under `tag`; under autograd its backward is `backward`:
    "reduce_scatter" or "split" (the module docstring)."""
    if group is None:
        return t
    if _records(t):
        return _AllGather.apply(t, dim, group, tag, backward)
    return _gather(t, dim, group, tag)


def reduce_from(t: torch.Tensor, group) -> torch.Tensor:
    """SUM all-reduce of `t` over `group`: in place without autograd, else a
    new tensor whose backward is the identity."""
    if group is None:
        return t
    return _ReduceFrom.apply(t, group) if _records(t) else all_reduce(t, "sum", group)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """`t` itself; under autograd its cotangent is SUM all-reduced over
    `group` (in fp32, cast back)."""
    if group is None or not _records(t):
        return t
    return _CopyTo.apply(t, group)


# --- one process a rank -------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, url: str, device: str, args, out_dir: str) -> None:
    out = Path(out_dir) / f"rank{rank}.pkl"
    try:
        torch.set_num_threads(1)
        initialize_distributed(url, world, rank, device=device)
        result = fn(rank, world, *args)
        payload = {"ok": True, "result": result}
    except BaseException:   # the parent fails the run with this rank's traceback
        payload = {"ok": False, "error": traceback.format_exc()}
    tmp = out.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, out)
    if _group_live():
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (), timeout: float = 600.0,
              device: str = "cuda") -> List[Any]:
    """Run ``fn(rank, world, *args)`` in `world` spawned processes that share
    one process group (``file://`` rendezvous in a temporary directory), and
    return the ranks' results in rank order. `fn` must be importable by
    reference (a module-level function) and its results picklable. A rank that
    raises, exits without a result or is still running after `timeout` seconds
    fails the run: every process is stopped and a RuntimeError names the rank."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ovla_ranks_") as tmp:
        url = f"file://{Path(tmp) / 'rendezvous'}"
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, url, device, tuple(args), tmp),
                             daemon=False) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            if hung:
                raise RuntimeError(f"ranks {hung} still running after {timeout} s")
            results = []
            for r, p in enumerate(procs):
                path = Path(tmp) / f"rank{r}.pkl"
                if not path.is_file():
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode} and no result")
                with open(path, "rb") as f:
                    payload = pickle.load(f)
                if not payload["ok"]:
                    raise RuntimeError(f"rank {r} failed:\n{payload['error']}")
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode}")
                results.append(payload["result"])
            return results
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
