"""Rollout-log parsing + per-task summaries + sanity census utilities
(the port's copy of ``openvla_probe_tpu/probe/logs.py``; F1 from
``probe.metrics``).

Re-implementation of the reference's log tooling
(experiment_utils/parse_libero_log.py:53-106, summarise_libero_log.py,
sanity.py, count_atoms.py, eval_object_probe_on_failure.py's episode
filtering): eval logs -> global success indices / per-task CSV rows, label
count sanity, predicate-family census, and success/failure episode splits
for probe evaluation.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import metrics
from .analysis import label_family

_EP_RE = re.compile(r"[Ee]pisode\s+(\d+)\s+success:\s*(True|False|1|0)")
_TASK_RE = re.compile(r"\[(?P<suite>[\w-]+)\]\s+task\s+(?P<task>\d+)\s+ep\s+(?P<ep>\d+):\s+success=(?P<s>True|False)")


def parse_eval_log(log_text: str) -> List[Dict[str, Any]]:
    """Eval log -> per-episode records {episode, task?, success}."""
    records: List[Dict[str, Any]] = []
    by_episode: Dict[int, Dict[str, Any]] = {}
    for m in _EP_RE.finditer(log_text):
        idx = int(m.group(1))
        by_episode[idx] = {"episode": idx, "success": m.group(2) in ("True", "1")}
    counter = 0
    for m in _TASK_RE.finditer(log_text):
        rec = by_episode.setdefault(counter, {"episode": counter})
        rec.update(task=int(m.group("task")), success=m.group("s") == "True")
        counter += 1
    records = [by_episode[k] for k in sorted(by_episode)]
    return records


def success_indices(records: List[Dict[str, Any]]) -> List[int]:
    return [r["episode"] for r in records if r.get("success")]


def failure_indices(records: List[Dict[str, Any]]) -> List[int]:
    return [r["episode"] for r in records if not r.get("success", False)]


def per_task_summary(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-task success CSV rows (summarise_libero_log equivalent)."""
    by_task: Dict[Any, List[bool]] = defaultdict(list)
    for r in records:
        by_task[r.get("task", "all")].append(bool(r.get("success", False)))
    rows = []
    for task in sorted(by_task, key=str):
        flags = by_task[task]
        rows.append({
            "task": task,
            "episodes": len(flags),
            "successes": int(sum(flags)),
            "success_rate": sum(flags) / len(flags),
        })
    total = [f for flags in by_task.values() for f in flags]
    rows.append({"task": "TOTAL", "episodes": len(total),
                 "successes": int(sum(total)), "success_rate": sum(total) / max(len(total), 1)})
    return rows


def label_count_sanity(
    episodes: Sequence[Dict[str, np.ndarray]],
    label_keys: Sequence[str] = ("symbolic_state_object_relations", "symbolic_state_action_subgoals"),
) -> Dict[str, Any]:
    """Per-value counts + flip statistics (sanity.py equivalent)."""
    Y = np.concatenate(
        [np.concatenate([np.asarray(ep[k]) for k in label_keys], axis=1) for ep in episodes]
    )
    pos = (Y == 1).sum(0)
    neg = (Y == 0).sum(0)
    na = (Y == -1).sum(0)
    flips = ((Y == 1).any(0) & (Y == 0).any(0)).sum()
    return {
        "n_frames": Y.shape[0],
        "n_labels": Y.shape[1],
        "pos_counts": pos,
        "neg_counts": neg,
        "na_counts": na,
        "n_labels_with_flips": int(flips),
        "always_positive": int(((Y == 1).all(0)).sum()),
        "always_na": int(((Y == -1).all(0)).sum()),
    }


def atom_census(label_names: Sequence[str]) -> Dict[str, int]:
    """Predicate-family histogram over the label vocabulary (count_atoms.py)."""
    return dict(Counter(label_family(n) for n in label_names))


def single_label_f1(
    collected: Dict[int, Dict[str, np.ndarray]],
    label_index: int,
    layer: int,
    threshold: float = 0.5,
) -> float:
    """Spot-check F1 of one predicate at one layer (sanity_f1_layer10.py)."""
    blob = collected[layer]
    t = blob["targets"][:, label_index]
    m = t != -1
    if not m.any():
        return float("nan")
    probs = 1.0 / (1.0 + np.exp(-blob["logits"][m, label_index]))
    return float(metrics.f1_score((t[m] == 1).astype(int), (probs > threshold).astype(int),
                                  zero_division=0))
