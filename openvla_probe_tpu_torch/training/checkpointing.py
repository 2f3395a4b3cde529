"""Checkpoint save / restore with the reference's run-dir conventions
(counterpart of ``openvla_probe_tpu/training/checkpointing.py``, written on
``torch.save`` / ``torch.load`` where the JAX package uses orbax)::

    run_dir/
      config.json                            # model + train config
      checkpoints/
        step-XXXXXX-epoch-YY-loss=Z.ZZZZ/    # one directory per checkpoint
          state.pt

Resume: `latest_checkpoint` parses the step from the directory names, the
reference's name-derived resume contract. A state is any tree of dicts,
lists, tuples, NamedTuples (``TrainState``, ``OptState``), tensors and plain
numbers; it is written as plain containers (``torch.load(weights_only=True)``
reads it back) and rebuilt in the types of a template on load. Writes go to a
temporary name first, so a checkpoint directory that parses is complete.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import threading
from concurrent.futures import Future
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

_CKPT_RE = re.compile(r"step-(\d+)-epoch-(\d+)-loss=(-?[0-9.]+|nan|inf|-inf)\.?$")
STATE_FILE = "state.pt"
PathLike = Union[str, Path]


def checkpoint_name(step: int, epoch: int = 0, loss: float = 0.0) -> str:
    # a diverged run's nan/inf loss must still give a parseable name
    loss = loss if math.isfinite(loss) else 0.0
    return f"step-{step:06d}-epoch-{epoch:02d}-loss={loss:.4f}"


def parse_checkpoint_name(name: str) -> Optional[Tuple[int, int, float]]:
    m = _CKPT_RE.match(name)
    if not m:
        return None
    return int(m.group(1)), int(m.group(2)), float(m.group(3))


def _is_primary() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _prune_checkpoints(ckpt_dir: Path, keep_limit: int, just_written: Path) -> None:
    # process 0 only (a shared filesystem), and never the checkpoint just
    # written (a reused run_dir may hold higher steps from an earlier run)
    if not _is_primary():
        return
    ckpts = sorted((p for p in ckpt_dir.iterdir() if parse_checkpoint_name(p.name)),
                   key=lambda p: parse_checkpoint_name(p.name)[0])
    for old in ckpts[:-keep_limit]:
        if old.absolute() != just_written:
            shutil.rmtree(old, ignore_errors=True)


def _to_plain(tree: Any) -> Any:
    """NamedTuples -> dicts of their fields, tuples -> lists, tensors copied
    to the CPU: what ``weights_only`` loading takes."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _to_plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_plain(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)   # a snapshot, even of a CPU tensor
    return tree


def _rebuild(tree: Any, template: Any) -> Any:
    """`tree` in the container types of `template`, tensors on the template's
    tensors' devices and dtypes (orbax's restore into a template)."""
    if template is None:
        return tree
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(**{f: _rebuild(tree[f], getattr(template, f))
                                 for f in template._fields})
    if isinstance(template, dict):
        if set(tree) != set(template):
            raise KeyError(f"checkpoint keys {sorted(tree)} differ from the template's "
                           f"{sorted(template)}")
        return {k: _rebuild(tree[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(t, v) for t, v in zip(tree, template))
    if isinstance(template, torch.Tensor):
        if tuple(tree.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape {tuple(tree.shape)} differs from the "
                             f"template's {tuple(template.shape)}")
        return tree.to(device=template.device, dtype=template.dtype)
    return tree


def _write(path: Path, plain: Any) -> None:
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(plain, tmp / STATE_FILE)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def save_checkpoint(run_dir: PathLike, state: Any, step: int, epoch: int = 0,
                    loss: float = 0.0, keep_limit: Optional[int] = None) -> Path:
    """Write `state` (a TrainState, bare params, any tree) on process 0."""
    ckpt_dir = Path(run_dir) / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = (ckpt_dir / checkpoint_name(step, epoch, loss)).absolute()
    if _is_primary():
        _write(path, _to_plain(state))
    if keep_limit:
        _prune_checkpoints(ckpt_dir, keep_limit, path)
    return path


class AsyncCheckpointWriter:
    """Checkpoint saves that do not stall the training loop.

    `save` copies the state to host memory at once (the checkpoint is the
    state of that moment, whatever the loop does next), then a background
    thread writes it while the next steps run. At most one write is in
    flight: `save` first waits for the previous one, and pruning counts only
    checkpoints whose write finished. A failed write raises from the next
    `save` or `wait`. Call `wait` (or `close`, or use the writer as a context
    manager) after the loop so the last checkpoint is on disk."""

    def __init__(self, keep_limit: Optional[int] = None) -> None:
        self.keep_limit = keep_limit
        self._pending: Optional[Tuple[Path, Future, threading.Thread]] = None

    def save(self, run_dir: PathLike, state: Any, step: int, epoch: int = 0,
             loss: float = 0.0) -> Path:
        self.wait()
        ckpt_dir = Path(run_dir) / "checkpoints"
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        path = (ckpt_dir / checkpoint_name(step, epoch, loss)).absolute()
        plain = _to_plain(state)          # the host snapshot, before the loop moves on
        done: Future = Future()

        def run():
            try:
                if _is_primary():
                    _write(path, plain)
                done.set_result(path)
            except Exception as exc:   # handed to the caller by wait()
                done.set_exception(exc)

        thread = threading.Thread(target=run, name="checkpoint-writer", daemon=True)
        thread.start()
        self._pending = (path, done, thread)
        return path

    def wait(self) -> None:
        """Block until the write in flight (if any) is on disk, then prune."""
        if self._pending is None:
            return
        path, done, thread = self._pending
        self._pending = None
        thread.join()
        done.result()
        if self.keep_limit:
            _prune_checkpoints(path.parent, self.keep_limit, path)

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def latest_checkpoint(run_dir: PathLike) -> Optional[Path]:
    ckpt_dir = Path(run_dir) / "checkpoints"
    if not ckpt_dir.exists():
        return None
    cands = [(parse_checkpoint_name(p.name), p) for p in ckpt_dir.iterdir()]
    cands = [(meta, p) for meta, p in cands if meta is not None]
    if not cands:
        return None
    return max(cands, key=lambda mp: mp[0][0])[1]


def load_checkpoint(path: PathLike, template: Any = None) -> Any:
    """The state saved at `path`, rebuilt in `template`'s types, devices and
    dtypes (plain containers on the CPU without one)."""
    plain = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    return _rebuild(plain, template)


def save_run_config(run_dir: PathLike, config: Dict[str, Any]) -> Path:
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    out = run_dir / "config.json"
    if _is_primary():   # concurrent writes to one shared file can interleave
        with open(out, "w") as f:
            json.dump(config, f, indent=2, default=str)
    return out


def load_run_config(run_dir: PathLike) -> Dict[str, Any]:
    with open(Path(run_dir) / "config.json") as f:
        return json.load(f)
