"""Probe-analysis figures: layer x predicate-family heatmaps, label histograms.

Re-implementation of the reference's plotting stack
(experiment_utils/plot_heatmap/* — F1 / recall / support-weighted / 3-class /
dual-head heatmaps — and experiment_utils/visualize_data_distribution/*):
one parameterized heatmap function + frequency histograms over the metric rows
produced by probe.analysis.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .analysis import label_family


def family_layer_matrix(
    rows: List[Dict[str, Any]],
    metric: str = "f1",
    weight_by_support: bool = False,
) -> Dict[str, Any]:
    """Per-label metric rows -> {matrix [n_layers, n_families], layers, families}."""
    layers = sorted({r["layer"] for r in rows})
    fams = sorted({label_family(r["label"]) for r in rows})
    acc = defaultdict(list)
    for r in rows:
        v = r.get(metric)
        if v is None or (isinstance(v, float) and np.isnan(v)):
            continue
        w = max(r.get("support", 1), 1) if weight_by_support else 1.0
        acc[(r["layer"], label_family(r["label"]))].append((v, w))
    M = np.full((len(layers), len(fams)), np.nan)
    for (layer, fam), vals in acc.items():
        vs = np.asarray([v for v, _ in vals])
        ws = np.asarray([w for _, w in vals], np.float64)
        M[layers.index(layer), fams.index(fam)] = float((vs * ws).sum() / ws.sum())
    return {"matrix": M, "layers": layers, "families": fams}


def plot_family_heatmap(
    rows: List[Dict[str, Any]],
    out_path: Union[str, Path],
    metric: str = "f1",
    weight_by_support: bool = False,
    title: Optional[str] = None,
) -> Path:
    """Write the layer x family heatmap PNG (make_probe_heatmap.py:45-60)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = family_layer_matrix(rows, metric, weight_by_support)
    M, layers, fams = data["matrix"], data["layers"], data["families"]
    fig, ax = plt.subplots(figsize=(max(6, 0.5 * len(fams)), max(4, 0.28 * len(layers))))
    im = ax.imshow(M, aspect="auto", cmap="viridis", vmin=0.0, vmax=1.0)
    ax.set_xticks(range(len(fams)), fams, rotation=45, ha="right", fontsize=8)
    ax.set_yticks(range(len(layers)), layers, fontsize=7)
    ax.set_xlabel("predicate family")
    ax.set_ylabel("layer")
    ax.set_title(title or f"probe {metric} by layer x family")
    fig.colorbar(im, ax=ax, label=metric)
    fig.tight_layout()
    out_path = Path(out_path)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_layer_metric_curves(
    records: List[Dict[str, float]],
    out_path: Union[str, Path],
    metrics: Sequence[str] = ("val_acc", "val_f1", "val_ap"),
) -> Path:
    """Metric-vs-layer curves from the trainer's records (probe_metrics CSV)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    layers = [r["layer"] for r in records]
    for m in metrics:
        if m in records[0]:
            ax.plot(layers, [r[m] for r in records], marker="o", label=m)
    ax.set_xlabel("layer")
    ax.set_ylabel("metric")
    ax.set_ylim(0, 1.02)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    out_path = Path(out_path)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def label_frequency_stats(
    episodes: Sequence[Dict[str, np.ndarray]],
    label_keys: Sequence[str] = ("symbolic_state_object_relations", "symbolic_state_action_subgoals"),
) -> Dict[str, np.ndarray]:
    """Per-label positive/negative/n.a. frequencies over all frames
    (visualize_data_distribution equivalents)."""
    Y = np.concatenate(
        [np.concatenate([np.asarray(ep[k]) for k in label_keys], axis=1) for ep in episodes]
    )
    n = Y.shape[0]
    return {
        "pos_rate": (Y == 1).sum(0) / n,
        "neg_rate": (Y == 0).sum(0) / n,
        "na_rate": (Y == -1).sum(0) / n,
        "n_frames": np.asarray(n),
    }


def label_stats_rows(
    episodes: Sequence[Dict[str, np.ndarray]],
    label_names: Sequence[str],
    label_keys: Sequence[str] = ("symbolic_state_object_relations", "symbolic_state_action_subgoals"),
) -> List[Dict[str, Any]]:
    """Per-label count/fraction rows in the published label_stats.csv schema
    (experiment_images/label_stats.csv: label, family, n_pos/n_neg/n_missing
    counts + p_* fractions over all frames). Feed to
    analysis.write_reference_csv("label_stats", ...)."""
    Y = np.concatenate(
        [np.concatenate([np.asarray(ep[k]) for k in label_keys], axis=1) for ep in episodes]
    )
    n = Y.shape[0]
    rows = []
    for k, name in enumerate(label_names):
        n_pos = int((Y[:, k] == 1).sum())
        n_neg = int((Y[:, k] == 0).sum())
        n_missing = int((Y[:, k] == -1).sum())
        rows.append({
            "label": name,
            "family": label_family(str(name)),
            "n_pos": float(n_pos),
            "n_neg": float(n_neg),
            "n_missing": float(n_missing),
            "p_pos": n_pos / n,
            "p_neg": n_neg / n,
            "p_missing": n_missing / n,
        })
    return rows


def plot_label_frequencies(
    stats: Dict[str, np.ndarray], out_path: Union[str, Path], bins: int = 30
) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    for ax, key in zip(axes, ["pos_rate", "neg_rate", "na_rate"]):
        ax.hist(stats[key], bins=bins, range=(0, 1))
        ax.set_title(key)
        ax.set_xlabel("rate")
    fig.tight_layout()
    out_path = Path(out_path)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
