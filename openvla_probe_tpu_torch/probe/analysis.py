"""Probe analysis: collected logits, per-label metrics, family AUPRC + lift
(the port's copy of ``openvla_probe_tpu/probe/analysis.py``, over the port's
probe bank, its metrics in numpy: ``probe.metrics``).

Re-implementation of the reference's analysis stack
(analysis/01_collect_logits.py, 02_per_label_metrics.py,
03_global_histograms.py, 05_family_auprc.py, util_data.py and
experiment_utils/eval_probes_per_label.py): probe logits per layer, per-label
precision/recall/F1/AUPRC/MCC/balanced-accuracy, and predicate-family pooled
AUPRC with lift over the positive-rate prior.
"""

from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import metrics
from .episodes import iter_episodes
from .train_probes import DEFAULT_LABEL_KEYS, ProbeBank, _episode_xy


def collect_logits(
    bank: ProbeBank,
    data: Union[str, Path, Sequence[Dict[str, np.ndarray]]],
    label_keys: Sequence[str] = DEFAULT_LABEL_KEYS,
    include: Optional[Sequence[int]] = None,
) -> Dict[int, Dict[str, np.ndarray]]:
    """Forward all episode frames through each layer's probe.

    Returns {layer: {"logits": [N, K], "targets": [N, K] in {-1,0,1}}} —
    the equivalent of 01_collect_logits.py's logits_{L}.pkl / targets_{L}.pkl.
    """
    if isinstance(data, (str, Path)):
        episodes = list(iter_episodes(data, include=include))
    else:
        episodes = list(data)
    xs, ys = _episode_xy(episodes, label_keys)
    X = np.concatenate([x[bank.layers] for x in xs], axis=1)  # [L, N, D]
    Y = np.concatenate(ys, axis=0)[:, bank.keep]              # [N, K]
    out = {}
    for li, layer in enumerate(bank.layers):
        out[layer] = {
            "logits": X[li].astype(np.float32) @ bank.w[li].T + bank.b[li],
            "targets": Y,
        }
    return out


def _binary_metrics(y_true: np.ndarray, y_pred: np.ndarray, y_prob: np.ndarray) -> Dict[str, float]:
    both = len(np.unique(y_true)) > 1
    out = {
        "precision": metrics.precision_score(y_true, y_pred, zero_division=0),
        "recall": metrics.recall_score(y_true, y_pred, zero_division=0),
        "f1": metrics.f1_score(y_true, y_pred, zero_division=0),
        "balanced_acc": metrics.balanced_accuracy_score(y_true, y_pred) if both else 0.0,
        "mcc": metrics.matthews_corrcoef(y_true, y_pred) if both else 0.0,
        "support": int(y_true.sum()),
    }
    out["auprc"] = float(metrics.average_precision_score(y_true, y_prob)) if both else float("nan")
    return {k: float(v) if not isinstance(v, int) else v for k, v in out.items()}


def per_label_metrics(
    collected: Dict[int, Dict[str, np.ndarray]],
    label_names: Optional[Sequence[str]] = None,
    threshold: float = 0.5,
) -> List[Dict[str, Any]]:
    """Per-(layer, label) metric rows — the per_label_metrics.csv equivalent."""
    rows = []
    for layer, blob in collected.items():
        logits, targets = blob["logits"], blob["targets"]
        probs = 1.0 / (1.0 + np.exp(-logits))
        for k in range(targets.shape[1]):
            m = targets[:, k] != -1
            if not m.any():
                continue
            y = (targets[m, k] == 1).astype(int)
            p = probs[m, k]
            name = label_names[k] if label_names is not None else k
            row = {
                "layer": layer,
                "label_idx": k,
                "label": name,
                "family": label_family(str(name)),
                **_binary_metrics(y, (p > threshold).astype(int), p),
            }
            rows.append(row)
    return rows


_FAMILY_RE = re.compile(r"^\(?\s*([A-Za-z_-]+)")


def label_family(name: str) -> str:
    """Predicate family from a label name: '(inside obj region)' -> 'inside'."""
    m = _FAMILY_RE.match(str(name))
    return m.group(1).lower() if m else str(name)


def family_auprc(
    collected: Dict[int, Dict[str, np.ndarray]],
    label_names: Sequence[str],
    families: Optional[Sequence[str]] = None,
) -> List[Dict[str, Any]]:
    """Pooled AUPRC per predicate family over ALL layers + lift vs the
    positive-rate prior (05_family_auprc.py semantics: scores from every
    (frame, label-in-family, layer) pooled into one PR computation)."""
    fam_of = [label_family(n) for n in label_names]
    wanted = set(families) if families else set(fam_of)
    pooled_y: Dict[str, List[np.ndarray]] = defaultdict(list)
    pooled_p: Dict[str, List[np.ndarray]] = defaultdict(list)
    for layer, blob in collected.items():
        logits, targets = blob["logits"], blob["targets"]
        probs = 1.0 / (1.0 + np.exp(-logits))
        for k, fam in enumerate(fam_of):
            if fam not in wanted:
                continue
            m = targets[:, k] != -1
            if not m.any():
                continue
            pooled_y[fam].append((targets[m, k] == 1).astype(int))
            pooled_p[fam].append(probs[m, k])
    rows = []
    for fam in sorted(pooled_y):
        y = np.concatenate(pooled_y[fam])
        p = np.concatenate(pooled_p[fam])
        prior = y.mean() if y.size else float("nan")
        if y.size and 0 < y.sum() < y.size:
            ap = float(metrics.average_precision_score(y, p))
        else:
            ap = float("nan")
        rows.append({
            "family": fam,
            "auprc": ap,
            "prior": float(prior),
            "lift": float(ap / prior) if prior and not np.isnan(ap) else float("nan"),
            "n": int(y.size),
            "n_pos": int(y.sum()),
        })
    return rows


# --- reference CSV schemas (drop-in artifact compatibility) -------------------
# Column names/order exactly as the reference's published artifacts
# (experiment_images/*.csv, analysis/family_auprc.csv) so downstream tooling
# written against those files consumes ours unchanged.

REFERENCE_CSV_SCHEMAS: Dict[str, List[str]] = {
    # experiment_images/probe_metrics_clean.csv
    "binary": ["layer", "val_acc", "val_f1"],
    # experiment_images/probe_metrics_dual_head_final.csv
    "dual": ["layer", "pres_acc_va", "truth_acc_va", "pres_f1_va", "truth_f1_va", "status"],
    # experiment_images/probe_metrics_3class_direct.csv
    "3class": ["layer", "val_acc", "val_f1", "status"],
    # experiment_images/per_label_metrics.csv (no auprc column)
    "per_label": ["layer", "label_idx", "label", "family",
                  "prec", "recall", "f1", "mcc", "bal_acc"],
    # analysis/per_label_metrics.csv (02_per_label_metrics.py adds auprc)
    "per_label_auprc": ["layer", "label_idx", "label", "family",
                        "prec", "recall", "f1", "auprc", "mcc", "bal_acc"],
    # analysis/family_auprc.csv
    "family_auprc": ["family", "prior", "auprc", "lift"],
    # experiment_images/label_stats.csv (visualize_data_distribution)
    "label_stats": ["label", "family", "n_pos", "n_neg", "n_missing",
                    "p_pos", "p_neg", "p_missing"],
}

_REFERENCE_KEY_MAP = {
    "dual": {"pres_acc_va": "presence_acc", "truth_acc_va": "truth_acc",
             "pres_f1_va": "presence_f1", "truth_f1_va": "truth_f1"},
    "per_label": {"prec": "precision", "bal_acc": "balanced_acc"},
    "per_label_auprc": {"prec": "precision", "bal_acc": "balanced_acc"},
}


def write_reference_csv(kind: str, rows: List[Dict[str, Any]], path) -> "Path":
    """Write `rows` (our record dicts) as the reference's exact CSV layout."""
    import csv
    from pathlib import Path as _P

    cols = REFERENCE_CSV_SCHEMAS[kind]
    remap = _REFERENCE_KEY_MAP.get(kind, {})
    path = _P(path)
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(cols)
        for r in rows:
            wr.writerow([
                "completed" if c == "status" else r.get(remap.get(c, c), "")
                for c in cols
            ])
    return path


def metric_histogram(rows: List[Dict[str, Any]], metric: str = "f1", bins: int = 20) -> Dict[str, np.ndarray]:
    """Global metric histogram across (layer, label) rows (03_global_histograms)."""
    vals = np.asarray([r[metric] for r in rows if not np.isnan(r.get(metric, np.nan))])
    hist, edges = np.histogram(vals, bins=bins, range=(0.0, 1.0))
    return {"hist": hist, "edges": edges, "mean": float(vals.mean()) if vals.size else float("nan")}


def success_episode_indices(log_text: str) -> List[int]:
    """Parse a rollout log for per-episode success markers — the
    parse_libero_log.py contract: lines like 'Episode 12 success: True'."""
    out = []
    for m in re.finditer(r"[Ee]pisode\s+(\d+)\s+success:\s*(True|False|1|0)", log_text):
        if m.group(2) in ("True", "1"):
            out.append(int(m.group(1)))
    return out
