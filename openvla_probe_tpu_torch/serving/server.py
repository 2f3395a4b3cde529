"""REST action server: POST /act with a json-numpy payload -> 7-DoF action
(the port's copy of ``openvla_probe_tpu/serving/server.py``).

Same wire contract as the reference's deploy server (vla-scripts/deploy.py:66-145:
FastAPI `POST /act` with {image, instruction, unnorm_key?}), re-implemented on
the stdlib http.server (zero extra deps; uvicorn/FastAPI are not needed for a
single-model action endpoint). json-numpy encoding is supported both ways:
arrays ride as {"__numpy__": <b64>, "dtype": ..., "shape": ...}; plain nested
lists also work.

The prompt template matches deploy.py:58-62:
  "In: What action should the robot take to {instruction.lower()}?\nOut:"
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np


def encode_numpy(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        return {
            "__numpy__": base64.b64encode(np.ascontiguousarray(obj).tobytes()).decode(),
            "dtype": str(obj.dtype),
            "shape": list(obj.shape),
        }
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, dict):
        return {k: encode_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_numpy(v) for v in obj]
    return obj


def decode_numpy(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__numpy__" in obj:
            buf = base64.b64decode(obj["__numpy__"])
            return np.frombuffer(buf, dtype=np.dtype(obj["dtype"])).reshape(obj["shape"]).copy()
        return {k: decode_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_numpy(v) for v in obj]
    return obj


def get_openvla_prompt(instruction: str, base_vlm: str = "openvla-7b") -> str:
    """deploy.py:58-62 template (v01 models use the chat-style prefix)."""
    if "v01" in base_vlm:
        return (
            "USER: What action should the robot take to "
            f"{instruction.lower()}? ASSISTANT:"
        )
    return f"In: What action should the robot take to {instruction.lower()}?\nOut:"


class OpenVLAServer:
    """Serve `model.predict_action` over HTTP. `model` is any object with
    predict_action(image, prompt, unnorm_key) -> {"actions": ...}.

    With `dynamic_batching=True` (and a model exposing predict_action_batch),
    concurrent requests micro-batch into one device call (serving/batcher.py)
    — the reference server is strictly bs=1 (deploy.py:91-109)."""

    def __init__(
        self,
        model: Any,
        base_vlm: str = "openvla-7b",
        dynamic_batching: bool = False,
        max_batch: int = 24,
        max_wait_ms: float = 8.0,
        speculative_streams: bool = True,
        max_streams: int = 1024,
    ) -> None:
        self.model = model
        self.base_vlm = base_vlm
        self._httpd: Optional[ThreadingHTTPServer] = None
        self.batcher = None
        if dynamic_batching and hasattr(model, "predict_action_batch"):
            from .batcher import DynamicBatcher

            self.batcher = DynamicBatcher(model, max_batch=max_batch,
                                          max_wait_ms=max_wait_ms)
        # per-stream verified speculation: a robot control loop posts with a
        # stable "stream_id" and the server drafts each step with the stream's
        # PREVIOUS action tokens (greedy outputs are identical by the verify
        # construction; a fully-accepted draft skips the sequential decode,
        # the bs=1 robot-loop lever). Turbo-tier only: the parity tier rejects
        # drafts by contract.
        tier = getattr(getattr(model, "cfg", None), "tier", None)
        self._spec_streams = (
            speculative_streams
            and self.batcher is None               # bs=1 path only
            and hasattr(model, "predict_action")
            and tier not in (None, "parity")
        )
        self._max_streams = max_streams
        self._stream_drafts: "Dict[str, np.ndarray]" = {}
        self._stream_lock = threading.Lock()
        # request-latency ring (seconds, last 2048 requests) for GET /stats
        # percentiles — includes any batching wait, i.e. what the CLIENT sees
        import collections

        self._lat = collections.deque(maxlen=2048)
        # speculative-acceptance telemetry: a speculative deployment silently
        # degrades toward the sequential decode's latency when trained-weight
        # margins are thin — a rolling acceptance rate on
        # /stats makes that observable in deployment. Ring of (accepted,
        # possible) per drafted request + an all-time histogram of accepted
        # counts.
        self._spec_accept = collections.deque(maxlen=2048)
        self._spec_hist = collections.Counter()

    def predict_action(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        import time

        t0 = time.monotonic()
        out = self._predict_action(payload)
        self._lat.append(time.monotonic() - t0)
        return out

    def _predict_action(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if "instruction" not in payload or "image" not in payload:
            raise ValueError(
                "Payload must contain 'image' and 'instruction' keys "
                "(optionally 'unnorm_key')"
            )
        image = np.asarray(payload["image"], dtype=np.uint8)
        prompt = get_openvla_prompt(str(payload["instruction"]), self.base_vlm)
        stream_id = payload.get("stream_id")
        # multi-LoRA: optional per-request adapter name/id (deploy.py
        # --adapters; models/multilora.py). Requests with different adapters
        # still micro-batch together — the selection is a per-row one-hot.
        adapter = payload.get("adapter")
        akw = {"adapter": adapter} if adapter is not None else {}
        if self.batcher is not None:
            out = self.batcher.predict_action(
                image, prompt, unnorm_key=payload.get("unnorm_key"),
                **akw,
            )
        elif self._spec_streams and stream_id is not None:
            sid = str(stream_id)
            with self._stream_lock:
                draft = self._stream_drafts.get(sid)
            # a stale/wrong draft only costs acceptance, never correctness:
            # the verify pass re-derives the greedy tokens exactly
            out = self.model.predict_action(
                image, prompt, unnorm_key=payload.get("unnorm_key"),
                draft_tokens=draft, **akw,
            )
            toks = out.get("action_tokens")
            if draft is not None and "n_accepted" in out:
                acc = int(np.asarray(out["n_accepted"]).reshape(-1)[0])
                # `possible` = how many tokens COULD have been accepted: the
                # output length, or the draft length when the model returned
                # no tokens — never `acc` itself, which would record a
                # degrading deployment as 100% accepting (the blind spot
                # this telemetry exists to expose)
                possible = int(np.asarray(
                    toks if toks is not None else draft).reshape(-1).shape[0])
                with self._stream_lock:
                    self._spec_accept.append((acc, possible))
                    self._spec_hist[acc] += 1
            if toks is not None:
                with self._stream_lock:
                    if sid not in self._stream_drafts and len(
                            self._stream_drafts) >= self._max_streams:
                        # drop the oldest stream (insertion order) — a robot
                        # fleet has a bounded, mostly-stable id set
                        self._stream_drafts.pop(next(iter(self._stream_drafts)))
                    self._stream_drafts[sid] = np.asarray(toks).reshape(-1)
        else:
            out = self.model.predict_action(
                image, prompt, unnorm_key=payload.get("unnorm_key"),
                **akw,
            )
        return {"action": out["actions"]}

    def _make_handler(server_self):  # noqa: N805
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(encode_numpy(payload)).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path.rstrip("/") != "/act":
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = decode_numpy(json.loads(self.rfile.read(n)))
                    result = server_self.predict_action(payload)
                    self._send(200, result)
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def do_GET(self):
                path = self.path.rstrip("/")
                if path == "/health":
                    self._send(200, {"status": "ok"})
                elif path == "/stats":
                    stats: Dict[str, Any] = {
                        "dynamic_batching": server_self.batcher is not None,
                        "speculative_streams": server_self._spec_streams,
                        "active_streams": len(server_self._stream_drafts),
                        "adapters": list(getattr(server_self.model,
                                                 "adapter_names", [])),
                    }
                    if server_self._spec_streams:
                        with server_self._stream_lock:
                            ring = list(server_self._spec_accept)
                            hist = dict(server_self._spec_hist)
                        spec: Dict[str, Any] = {
                            "drafted_requests": int(sum(hist.values())),
                            "accept_histogram": {str(k): int(v) for k, v
                                                 in sorted(hist.items())},
                        }
                        if ring:
                            acc = sum(a for a, _ in ring)
                            poss = sum(p for _, p in ring)
                            spec["rolling_accept_rate"] = round(
                                acc / max(poss, 1), 4)
                            spec["rolling_full_accept_rate"] = round(
                                sum(1 for a, p in ring if a >= p) / len(ring), 4)
                            spec["rolling_window"] = len(ring)
                        stats["speculative"] = spec
                    lat = np.asarray(server_self._lat, np.float64)
                    if lat.size:
                        p50, p95, p99 = np.percentile(lat, [50, 95, 99]) * 1e3
                        stats["latency_ms"] = {
                            "count": int(lat.size), "p50": round(float(p50), 2),
                            "p95": round(float(p95), 2), "p99": round(float(p99), 2),
                        }
                    if server_self.batcher is not None:
                        b = server_self.batcher
                        stats.update(b.stats)
                        stats["max_batch"] = b.max_batch
                        stats["max_wait_ms"] = b.max_wait_s * 1e3
                        if stats["batches"]:
                            stats["mean_batch"] = round(stats["requests"] / stats["batches"], 3)
                    self._send(200, stats)
                else:
                    self._send(404, {"error": "POST /act"})

        return Handler

    def run(self, host: str = "0.0.0.0", port: int = 8000, background: bool = False):
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        if background:
            t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            t.start()
            return t
        self._httpd.serve_forever()

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def shutdown(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd = None
