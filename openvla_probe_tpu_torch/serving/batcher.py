"""Dynamic micro-batching for the action server (the port's copy of
``openvla_probe_tpu/serving/batcher.py``).

The serving core is batched (one call serves B heterogeneous requests —
per-row prompts, per-row norm stats); the reference's server is strictly
bs=1 (FastAPI handler -> predict_action, vla-scripts/deploy.py:91-109). This
batcher converts concurrent HTTP requests into device batches:

  * a request arrives -> it opens a window of `max_wait_ms`
  * every request that arrives inside the window joins the batch
    (up to `max_batch`, grouped by image shape: one batch stacks its images
    into one tensor)
  * one `predict_action_batch` call serves the whole group (padded to a
    bucket of a few batch sizes)

A batch of B rows streams every weight once for all of them, so under
concurrent load it trades ~max_wait_ms of added latency for a lower cost per
request.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

_SEQ = itertools.count()


@dataclass
class _Pending:
    image: np.ndarray
    prompt: str
    unnorm_key: Optional[str]
    adapter: Any = None            # multi-LoRA: per-request adapter name/id
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, np.ndarray]] = None
    error: Optional[Exception] = None
    seq: int = field(default_factory=lambda: next(_SEQ))   # arrival order


class DynamicBatcher:
    """Collect concurrent predict_action requests into device batches."""

    def __init__(
        self,
        model: Any,                       # needs .predict_action_batch(...)
        max_batch: int = 24,
        max_wait_ms: float = 8.0,
    ) -> None:
        self.model = model
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        # shape-keyed backlog, worker-thread-only: a mixed-geometry arrival
        # parks here instead of re-queuing at the BACK of the line (the
        # round-2 starvation edge: alternating shapes could push a minority
        # shape past its timeout). Batch selection is strict oldest-first
        # across shapes, so every request's wait is bounded by the batches
        # ahead of it at arrival.
        self._backlog: Dict[Tuple[int, ...], Deque[_Pending]] = {}
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        self.stats = {"requests": 0, "batches": 0, "max_seen_batch": 0}

    # --- client side ---------------------------------------------------
    def predict_action(
        self, image: np.ndarray, prompt: str, unnorm_key: Optional[str] = None,
        timeout: float = 60.0, adapter: Any = None,
    ) -> Dict[str, np.ndarray]:
        if self._stop.is_set():
            raise RuntimeError("DynamicBatcher is shut down")
        p = _Pending(np.asarray(image, np.uint8), prompt, unnorm_key, adapter)
        self._q.put(p)
        if self._stop.is_set():
            # shutdown raced between the check above and the put: sweep the
            # queue ourselves so this request fails now, not at its timeout
            self._sweep_queue()
        if not p.event.wait(timeout):
            raise TimeoutError("predict_action batcher timed out")
        if p.error is not None:
            raise p.error
        return p.result

    # --- worker ----------------------------------------------------------
    def _drain(self, timeout: float) -> bool:
        """Move arrivals into the shape-keyed backlog (one blocking get, then
        everything immediately available). Returns True if anything moved."""
        try:
            p = self._q.get(timeout=timeout)
        except queue.Empty:
            return False
        self._backlog.setdefault(tuple(p.image.shape), collections.deque()).append(p)
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                return True
            self._backlog.setdefault(tuple(p.image.shape), collections.deque()).append(p)

    def _gather(self) -> List[_Pending]:
        if not any(self._backlog.values()):
            if not self._drain(0.1):
                return []
        # serve the shape whose HEAD request has waited longest: a minority
        # geometry becomes the next batch as soon as it is the oldest waiter
        shape = min((s for s, d in self._backlog.items() if d),
                    key=lambda s: self._backlog[s][0].seq)
        dq = self._backlog[shape]
        group = [dq.popleft()]
        deadline = time.monotonic() + self.max_wait_s
        while len(group) < self.max_batch:
            if dq:
                group.append(dq.popleft())
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self._drain(remaining):
                break
            # _drain may have parked other shapes; only same-shape arrivals
            # (now in dq) join this batch
        return group

    def _fail(self, p: _Pending) -> None:
        p.error = RuntimeError("DynamicBatcher shut down before serving request")
        p.event.set()

    def _sweep_queue(self) -> None:
        """Fail everything in the arrival queue (thread-safe: queue.Queue
        hands each request to exactly one sweeper)."""
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                return
            self._fail(p)

    def _loop(self) -> None:
        try:
            self._run()
        finally:
            # the worker OWNS the backlog — failing it here (and only here)
            # means no other thread ever touches the deques concurrently,
            # and a request drained after shutdown's sweep still gets failed
            for dq in self._backlog.values():
                while dq:
                    self._fail(dq.popleft())
            self._sweep_queue()

    def _run(self) -> None:
        while not self._stop.is_set():
            group = self._gather()
            if not group:
                continue
            try:
                # multi-LoRA requests batch WITH plain ones (per-row one-hot;
                # None rows serve the bare base) — only an all-plain group
                # stays on the adapter-free graph
                kw = {}
                if any(p.adapter is not None for p in group):
                    kw["adapters"] = [p.adapter for p in group]
                results = self.model.predict_action_batch(
                    np.stack([p.image for p in group]),
                    [p.prompt for p in group],
                    [p.unnorm_key for p in group],
                    **kw,
                )
                for p, r in zip(group, results):
                    p.result = r
            except Exception as e:  # noqa: BLE001
                for p in group:
                    p.error = e
            self.stats["requests"] += len(group)
            self.stats["batches"] += 1
            self.stats["max_seen_batch"] = max(self.stats["max_seen_batch"], len(group))
            for p in group:
                p.event.set()

    def shutdown(self) -> None:
        self._stop.set()
        self._worker.join(timeout=2.0)
        # sweep the (thread-safe) arrival queue so queued callers error now;
        # the BACKLOG is failed by the worker's own exit path — if the join
        # timed out (worker mid-device-call), backlogged callers are failed
        # the moment the worker reaches its finally, never stranded
        self._sweep_queue()
