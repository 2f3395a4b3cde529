"""Rank-aware logging + distributed-context accessors (the port's copy of
``openvla_probe_tpu/overwatch/overwatch.py``).

The counterpart of the reference "overwatch" layer
(reference: prismatic/overwatch/overwatch.py:47-147): process identity comes
from ``torch.distributed`` (rank and world size) when a process group is
initialised, and is rank 0 of 1 otherwise. The logger touches
``torch.distributed`` only when asked for a rank, so it can be constructed
before ``init_process_group``.
"""

from __future__ import annotations

import logging
import os
import sys
from functools import wraps
from typing import Any, Callable

_LOG_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s :: %(message)s"
_DATE_FORMAT = "%H:%M:%S"


def process_index() -> int:
    """This process's rank in the torch.distributed group, or 0 when no group
    is initialised."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The torch.distributed world size, or 1 when no group is initialised."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Overwatch:
    """Process-zero-filtered logger + distributed-state accessors.

    Mirrors the public surface of the reference's ``DistributedOverwatch`` /
    ``PureOverwatch`` (rank()/world_size()/is_rank_zero()/rank_zero_only()),
    mapped onto torch.distributed ranks.
    """

    def __init__(self, name: str) -> None:
        self.logger = logging.getLogger(name)
        if not self.logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(_LOG_FORMAT, datefmt=_DATE_FORMAT))
            self.logger.addHandler(handler)
        level = os.environ.get("OVERWATCH_LEVEL", "INFO").upper()
        self.logger.setLevel(level)
        self.logger.propagate = False

    # --- distributed state -------------------------------------------------
    def rank(self) -> int:
        return process_index()

    def world_size(self) -> int:
        return process_count()

    def local_rank(self) -> int:
        # torchrun's LOCAL_RANK where it launched the process, else 0
        return int(os.environ.get("LOCAL_RANK", 0))

    def is_rank_zero(self) -> bool:
        return self.rank() == 0

    def rank_zero_only(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        """Decorator: run `fn` only on process 0, return None elsewhere."""

        @wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if self.is_rank_zero():
                return fn(*args, **kwargs)
            return None

        return wrapper

    # --- logging (process-zero filtered) -----------------------------------
    def _log(self, level: int, msg: str, *args: Any, all_ranks: bool = False, **kwargs: Any) -> None:
        if all_ranks or self.is_rank_zero():
            self.logger.log(level, msg, *args, **kwargs)

    def debug(self, msg: str, *args: Any, **kwargs: Any) -> None:
        self._log(logging.DEBUG, msg, *args, **kwargs)

    def info(self, msg: str, *args: Any, **kwargs: Any) -> None:
        self._log(logging.INFO, msg, *args, **kwargs)

    def warning(self, msg: str, *args: Any, **kwargs: Any) -> None:
        self._log(logging.WARNING, msg, *args, **kwargs)

    def error(self, msg: str, *args: Any, **kwargs: Any) -> None:
        self._log(logging.ERROR, msg, *args, **kwargs)


def initialize_overwatch(name: str) -> Overwatch:
    return Overwatch(name)
