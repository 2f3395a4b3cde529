"""Preemption-safe training: a signal becomes a cooperative flag the train
loop polls once per step (counterpart of
``openvla_probe_tpu/training/preemption.py``).

Spot reclaims and maintenance arrive as SIGTERM with a short grace window.
On the step after delivery the loop writes one final checkpoint and exits,
so a resumed run continues from that step. With several processes
(``torch.distributed`` initialized) every process must agree on which step
is the last: `should_exit` OR-reduces the flag across them every
`sync_every` steps (a collective: every process calls it at the same
cadence). With one process it is a flag read.
"""

from __future__ import annotations

import signal
from typing import Iterable

import torch


class PreemptionGuard:
    """Cooperative SIGTERM/SIGINT-to-flag bridge for training loops::

        with PreemptionGuard() as guard:
            while step < max_steps:
                ...train step...
                if guard.should_exit(step):
                    save_final_checkpoint(); break

    The handler only sets a flag; the checkpoint is written in loop context.
    The previous handlers come back on exit, and a SECOND signal restores them
    and re-raises, so a stuck save can still be interrupted."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT),
                 sync_every: int = 1) -> None:
        self._signals = tuple(signals)
        self._sync_every = max(1, int(sync_every))
        self._flag = False
        self._agreed = False
        self._prev: dict = {}

    def _handler(self, signum, frame):
        if self._flag:
            # second delivery: the default action runs (a hung save stays killable)
            self.restore()
            signal.raise_signal(signum)
            return
        self._flag = True

    def install(self) -> "PreemptionGuard":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def restore(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.restore()

    @property
    def preempted(self) -> bool:
        """This process's own flag (no agreement across processes)."""
        return self._flag

    def should_exit(self, step: int = 0) -> bool:
        """True once every process agrees a signal arrived; sticky after."""
        if self._agreed:
            return True
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            self._agreed = self._flag
            return self._agreed
        if step % self._sync_every:
            return False
        flag = torch.tensor([int(self._flag)], dtype=torch.int32)
        if dist.get_backend() == "nccl":
            flag = flag.cuda()
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self._agreed = bool(flag.item())
        return self._agreed
