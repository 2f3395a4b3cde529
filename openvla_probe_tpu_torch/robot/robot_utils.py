"""Model-family dispatch + gripper conventions + seeding for robot eval.

The port's copy of ``openvla_probe_tpu/robot/robot_utils.py``: get_model /
get_action dispatch keyed by model_family, deterministic seeding, and the
gripper-action conventions the LIBERO/Bridge envs expect.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

import numpy as np

DATE_FORMAT = "%Y_%m_%d-%H_%M_%S"


def set_seed_everywhere(seed: int) -> None:
    """Seed numpy + python (+ torch when present) for reproducible rollouts."""
    np.random.seed(seed)
    random.seed(seed)
    try:
        import torch

        torch.manual_seed(seed)
    except ImportError:
        pass


def get_model(cfg: Any, wrap_diffusion_policy_for_droid: bool = False):
    """Load the policy for cfg.model_family (only `openvla` is in-tree)."""
    if cfg.model_family == "openvla":
        from .openvla_utils import get_vla

        return get_vla(cfg)
    raise ValueError(f"Unexpected `model_family` = {cfg.model_family}")


def get_action(
    cfg: Any,
    model: Any,
    obs: Dict[str, Any],
    task_label: str,
    processor: Any = None,
    return_embeddings: bool = False,
    layer_indices: Optional[list] = None,
    spec_state: Any = None,
):
    """Query the policy for one action (optionally with hidden-state capture
    and/or verified speculative decode via `spec_state`)."""
    if cfg.model_family == "openvla":
        from .openvla_utils import get_vla_action

        return get_vla_action(
            model, obs, task_label,
            unnorm_key=getattr(cfg, "unnorm_key", None),
            center_crop=getattr(cfg, "center_crop", False),
            return_embeddings=return_embeddings,
            spec_state=spec_state,
        )
    raise ValueError(f"Unexpected `model_family` = {cfg.model_family}")


def normalize_gripper_action(action: np.ndarray, binarize: bool = True) -> np.ndarray:
    """Map gripper from [0, 1] -> [-1, +1] (env convention), optionally
    snapping to the extremes (reference robot_utils.py:81-98)."""
    action = np.asarray(action, np.float64).copy()
    action[..., -1] = 2.0 * (action[..., -1] - 0.0) / 1.0 - 1.0
    if binarize:
        action[..., -1] = np.sign(action[..., -1])
    return action


def invert_gripper_action(action: np.ndarray) -> np.ndarray:
    """Flip the gripper sign (envs where -1 = open; reference :101-108)."""
    action = np.asarray(action, np.float64).copy()
    action[..., -1] *= -1.0
    return action
