"""Discrete action <-> token codec (counterpart of ``openvla_probe_tpu/vla/action_tokenizer.py``).

256 uniform bin edges over [-1, 1], 255 bin centers at edge midpoints; actions
live in the last 256 vocabulary slots: token_id = vocab_size - bin index.
Decoding keeps the reference's off-by-one clip: center = bin_centers[clip(
vocab_size - token_id - 1, 0, 254)]. ``vocab_size`` is the codec's 32000 for
OpenVLA, not the LLM's padded 32064.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class ActionCodec:
    """Stateless codec: token ids -> continuous actions in [-1, 1]."""

    vocab_size: int = 32000
    n_bins: int = 256
    min_action: float = -1.0
    max_action: float = 1.0

    @property
    def bins(self) -> np.ndarray:
        return np.linspace(self.min_action, self.max_action, self.n_bins)

    @property
    def action_token_begin_idx(self) -> int:
        """Token ids above this one are action tokens."""
        return self.vocab_size - (self.n_bins + 1)

    @property
    def bin_centers(self) -> np.ndarray:
        b = self.bins
        return (b[:-1] + b[1:]) / 2.0

    def decode(self, token_ids: torch.Tensor) -> torch.Tensor:
        """Token ids -> fp32 bin-center actions (the documented off-by-one clip)."""
        centers = _centers_on(self, token_ids.device)
        idx = self.vocab_size - token_ids.to(torch.int64)
        idx = torch.clamp(idx - 1, 0, self.n_bins - 2)
        return centers[idx]

    def unnormalize(
        self,
        actions: torch.Tensor,
        q01,
        q99,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Invert q01/q99 bounds normalization; dims where ``mask`` is False
        pass through untouched (e.g. the gripper)."""
        q01 = torch.as_tensor(q01, dtype=torch.float32, device=actions.device)
        q99 = torch.as_tensor(q99, dtype=torch.float32, device=actions.device)
        raw = 0.5 * (actions + 1.0) * (q99 - q01) + q01
        if mask is None:
            return raw
        return torch.where(torch.as_tensor(mask, dtype=torch.bool, device=actions.device),
                           raw, actions)

    def decode_and_unnormalize(self, token_ids, q01, q99, mask=None) -> torch.Tensor:
        return self.unnormalize(self.decode(token_ids), q01, q99, mask)


@functools.lru_cache(maxsize=None)
def _centers_on(codec: ActionCodec, device: torch.device) -> torch.Tensor:
    """`codec`'s fp32 bin centers on `device`, copied there once (a copy from
    the host inside a step makes the host wait for the card)."""
    return torch.as_tensor(codec.bin_centers, dtype=torch.float32, device=device)
