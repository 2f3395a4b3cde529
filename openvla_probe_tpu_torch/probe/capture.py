"""Rollout hidden-state capture: one prefill serves both control and probing
(the port's copy of ``openvla_probe_tpu/probe/capture.py``).

Replaces the reference's double-forward capture loop (its `get_vla_action`
with return_embeddings=True runs a full extra forward per control step, then
predict_action prefills again): `CaptureSession.step` gets the action and the
L + 1 mean-pooled layer states from the same call.

The symbolic-state oracles live in the external `detection` package (the
reference imports it too); `SymbolicDetector` is that boundary: anything
returning {-1, 0, 1} vectors.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Protocol, Union

import numpy as np

from ..models.vla import OpenVLA
from .episodes import EpisodeWriter


class SymbolicDetector(Protocol):
    """External symbolic-state oracle (the `detection` package contract)."""

    def detect_binary_states(self) -> np.ndarray:  # values in {-1, 0, 1}
        ...


class CaptureSession:
    """Accumulates per-step (hidden states, symbolic labels) for one episode."""

    def __init__(
        self,
        model: OpenVLA,
        out_dir: Union[str, Path],
        detectors: Optional[Dict[str, SymbolicDetector]] = None,
        unnorm_key: Optional[str] = None,
        speculative: bool = False,
    ) -> None:
        self.model = model
        self.writer = EpisodeWriter(out_dir)
        self.detectors = detectors or {}
        self.unnorm_key = unnorm_key
        self.spec_state = None
        if speculative:
            from ..robot.openvla_utils import SpeculativeActionState

            self.spec_state = SpeculativeActionState()

    def step(self, image: np.ndarray, prompt: str) -> Dict[str, np.ndarray]:
        """One control step: returns the predict_action outputs; records the
        taps and the detector vectors. With speculative=True the previous
        step's tokens draft the decode (see models/vla.py)."""
        draft = self.spec_state.last_tokens if self.spec_state is not None else None
        out = self.model.predict_action(
            image, prompt, unnorm_key=self.unnorm_key, return_hidden_states=True,
            draft_tokens=draft,
        )
        if self.spec_state is not None:
            self.spec_state.observe(out)
        labels = {
            name: np.asarray(det.detect_binary_states(), np.int8)
            for name, det in self.detectors.items()
        }
        self.writer.append(out["hidden_pooled"], **labels)
        return out

    def end_episode(self, episode_index: int, success: Optional[bool] = None) -> Path:
        if self.spec_state is not None:
            self.spec_state.reset()
        return self.writer.flush(episode_index, success=success)
