"""Discrete action <-> token codec (counterpart of ``openvla_probe_tpu/vla/action_tokenizer.py``).

256 uniform bin edges over [-1, 1], 255 bin centers at edge midpoints; actions
live in the last 256 vocabulary slots: token_id = vocab_size - bin index.
Decoding keeps the reference's off-by-one clip: center = bin_centers[clip(
vocab_size - token_id - 1, 0, 254)]. ``vocab_size`` is the codec's 32000 for
OpenVLA, not the LLM's padded 32064.

``ActionCodec.encode`` is the JAX codec's device encoder (fp32 edges,
searchsorted); ``ActionTokenizer`` is the host-side numpy twin the data
pipeline uses (float64 ``np.digitize``, strings through the text tokenizer).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, List, Optional, Union

import numpy as np
import torch


@dataclass(frozen=True)
class ActionCodec:
    """Stateless codec: token ids <-> continuous actions in [-1, 1]."""

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

    def encode(self, actions: torch.Tensor) -> torch.Tensor:
        """Continuous actions -> int32 token ids: the bin index over the fp32
        edges (np.digitize's rule, searchsorted to the right). Actions within
        ~6e-8 of an edge can land one bin off the float64 `ActionTokenizer`,
        as in the JAX package."""
        a = torch.clamp(actions, self.min_action, self.max_action).to(torch.float32)
        edges = torch.as_tensor(self.bins, dtype=torch.float32, device=a.device)
        idx = torch.searchsorted(edges, a.contiguous(), right=True)
        return (self.vocab_size - idx).to(torch.int32)

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


class ActionTokenizer:
    """Host-side numpy twin wrapping a text tokenizer (data-pipeline use).

    ``__call__`` renders actions as the decoded string of their action tokens
    (what gets appended to the training prompt); ``decode_token_ids_to_actions``
    is the inverse used for L1 metrics during training.
    """

    def __init__(
        self,
        tokenizer: Any,
        bins: int = 256,
        min_action: float = -1.0,
        max_action: float = 1.0,
    ) -> None:
        self.tokenizer = tokenizer
        self.codec = ActionCodec(
            vocab_size=int(tokenizer.vocab_size),
            n_bins=bins,
            min_action=min_action,
            max_action=max_action,
        )
        self.bins = self.codec.bins
        self.bin_centers = self.codec.bin_centers

    @property
    def vocab_size(self) -> int:
        return self.codec.vocab_size

    @property
    def action_token_begin_idx(self) -> int:
        return self.codec.action_token_begin_idx

    def encode_to_ids(self, action: np.ndarray) -> np.ndarray:
        a = np.clip(action, self.codec.min_action, self.codec.max_action)
        idx = np.digitize(a, self.bins)
        return (self.vocab_size - idx).astype(np.int64)

    def __call__(self, action: np.ndarray) -> Union[str, List[str]]:
        ids = self.encode_to_ids(np.asarray(action))
        if ids.ndim <= 1:
            return self.tokenizer.decode(ids.tolist())
        return [self.tokenizer.decode(row.tolist()) for row in ids]

    def decode_token_ids_to_actions(self, token_ids: np.ndarray) -> np.ndarray:
        idx = self.vocab_size - np.asarray(token_ids)
        idx = np.clip(idx - 1, 0, self.codec.n_bins - 2)
        return self.bin_centers[idx]
