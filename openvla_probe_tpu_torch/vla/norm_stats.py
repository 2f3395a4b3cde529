"""Dataset action/proprio statistics: schema, computation, (un)normalization, JSON I/O.

Behavioral parity with the reference's statistics machinery
(prismatic/vla/datasets/rlds/utils/data_utils.py:49-103 NormalizationType +
normalize_action_and_proprio; :185-293 get_dataset_statistics/save_dataset_statistics),
re-expressed host-side in numpy (the on-device inverse lives in
``ActionCodec.unnormalize``). The JSON schema written here is byte-compatible with
the reference's ``dataset_statistics.json`` sidecar so checkpoints interoperate.
"""

from __future__ import annotations

import hashlib
import json
from enum import Enum
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Union

import numpy as np


class NormalizationType(str, Enum):
    NORMAL = "normal"          # (x - mean) / std
    BOUNDS = "bounds"          # [min, max] -> [-1, 1]
    BOUNDS_Q99 = "bounds_q99"  # [q01, q99] -> [-1, 1], clipped


ArrayStats = Dict[str, np.ndarray]  # mean/std/min/max/q01/q99 [+ mask]


def compute_array_statistics(rows: np.ndarray) -> ArrayStats:
    """Per-dimension statistics over a [N, D] stack of actions/proprio."""
    rows = np.asarray(rows, dtype=np.float64)
    return {
        "mean": rows.mean(axis=0).astype(np.float32),
        "std": rows.std(axis=0).astype(np.float32),
        "max": rows.max(axis=0).astype(np.float32),
        "min": rows.min(axis=0).astype(np.float32),
        "q01": np.quantile(rows, 0.01, axis=0).astype(np.float32),
        "q99": np.quantile(rows, 0.99, axis=0).astype(np.float32),
    }


def compute_dataset_statistics(
    trajectories: Iterable[Dict[str, np.ndarray]],
    *,
    action_key: str = "action",
    proprio_key: Optional[str] = "proprio",
) -> Dict[str, Any]:
    """Scan trajectories (each a dict of [T, D] arrays) -> statistics dict.

    Equivalent of the reference's full-dataset cardinality scan
    (rlds/utils/data_utils.py:185-271) for in-memory / host iterables; the
    tf.data path in the RLDS layer calls into this on materialized arrays.
    """
    actions, proprios = [], []
    num_transitions = 0
    num_trajectories = 0
    for traj in trajectories:
        a = np.asarray(traj[action_key])
        actions.append(a.reshape(-1, a.shape[-1]))
        if proprio_key and proprio_key in traj:
            p = np.asarray(traj[proprio_key])
            proprios.append(p.reshape(-1, p.shape[-1]))
        num_transitions += a.shape[0]
        num_trajectories += 1
    out: Dict[str, Any] = {
        "action": compute_array_statistics(np.concatenate(actions, axis=0)),
        "num_transitions": num_transitions,
        "num_trajectories": num_trajectories,
    }
    if proprios:
        out["proprio"] = compute_array_statistics(np.concatenate(proprios, axis=0))
    return out


def statistics_cache_key(dataset_name: str, spec: str) -> str:
    """Stable hash for caching statistics of a (dataset, transform-spec) pair."""
    return hashlib.sha256(f"{dataset_name}::{spec}".encode()).hexdigest()[:16]


def normalize(
    x: np.ndarray,
    stats: ArrayStats,
    normalization_type: NormalizationType = NormalizationType.BOUNDS_Q99,
) -> np.ndarray:
    """Forward normalization (training-time). Masked-out dims pass through;
    degenerate dims (min == max) are zeroed, matching the reference."""
    x = np.asarray(x, dtype=np.float32)
    mask = np.asarray(stats.get("mask", np.ones_like(np.asarray(stats["min"]), dtype=bool)), dtype=bool)
    if normalization_type == NormalizationType.NORMAL:
        return np.where(mask, (x - stats["mean"]) / (np.asarray(stats["std"]) + 1e-8), x).astype(np.float32)
    if normalization_type == NormalizationType.BOUNDS:
        low, high = np.asarray(stats["min"]), np.asarray(stats["max"])
    elif normalization_type == NormalizationType.BOUNDS_Q99:
        low, high = np.asarray(stats["q01"]), np.asarray(stats["q99"])
    else:
        raise ValueError(f"Unknown normalization type {normalization_type}")
    y = np.where(mask, np.clip(2.0 * (x - low) / (high - low + 1e-8) - 1.0, -1.0, 1.0), x)
    zeros = np.asarray(stats["min"]) == np.asarray(stats["max"])
    return np.where(zeros, 0.0, y).astype(np.float32)


def unnormalize(
    x: np.ndarray,
    stats: ArrayStats,
    normalization_type: NormalizationType = NormalizationType.BOUNDS_Q99,
) -> np.ndarray:
    """Host-side inverse of :func:`normalize` (serving twin of ActionCodec.unnormalize)."""
    x = np.asarray(x, dtype=np.float32)
    mask = np.asarray(stats.get("mask", np.ones_like(np.asarray(stats["min"]), dtype=bool)), dtype=bool)
    if normalization_type == NormalizationType.NORMAL:
        return np.where(mask, x * (np.asarray(stats["std"]) + 1e-8) + stats["mean"], x).astype(np.float32)
    if normalization_type == NormalizationType.BOUNDS:
        low, high = np.asarray(stats["min"]), np.asarray(stats["max"])
    elif normalization_type == NormalizationType.BOUNDS_Q99:
        low, high = np.asarray(stats["q01"]), np.asarray(stats["q99"])
    else:
        raise ValueError(f"Unknown normalization type {normalization_type}")
    return np.where(mask, 0.5 * (x + 1.0) * (high - low) + low, x).astype(np.float32)


# --- JSON sidecar I/O (schema-compatible with the reference) ----------------

def _to_jsonable(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def save_dataset_statistics(
    statistics: Dict[str, Dict[str, Any]], run_dir: Union[str, Path]
) -> Path:
    """Write ``dataset_statistics.json`` ({dataset_name: stats}) into `run_dir`."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    out_path = run_dir / "dataset_statistics.json"
    # rank-zero write (multi-process runs call this with identical global
    # statistics on every process; see parallel.distributed.is_primary)
    from ..parallel.distributed import is_primary

    if is_primary():
        with open(out_path, "w") as f:
            json.dump(_to_jsonable(statistics), f, indent=2)
    return out_path


def load_dataset_statistics(path: Union[str, Path]) -> Dict[str, Dict[str, Any]]:
    """Load a stats sidecar; leaf lists come back as float32/bool numpy arrays."""
    path = Path(path)
    if path.is_dir():
        path = path / "dataset_statistics.json"
    with open(path) as f:
        raw = json.load(f)

    def _restore(d: Any) -> Any:
        if isinstance(d, dict):
            return {k: _restore(v) for k, v in d.items()}
        if isinstance(d, list):
            arr = np.asarray(d)
            return arr.astype(bool) if arr.dtype == np.bool_ else arr.astype(np.float32)
        return d

    return _restore(raw)
