"""Probe analysis: collected logits -> per-label metrics, family AUPRC, figures.

Counterpart of the JAX package's ``scripts/analyze_probes.py`` (the unified
analysis/01_collect_logits + 02_per_label_metrics + 03_global_histograms +
05_family_auprc and the plot_heatmap scripts). The label names come from the
port's copy of the suite's key files (``robot/label_keys``). The heatmaps are
probe/plots.py's (matplotlib); where matplotlib is not installed (the card's
machine) each is written instead, under its name with ``_matrix`` before
``.png``, as a plain PNG of the same layer x family matrix, one 16-pixel
square a cell, value 0..1 as dark to light, NaN red, with no axes or labels,
and a warning says so. Runs on the host: no ``--device``.

    python -m openvla_probe_tpu_torch.scripts.analyze_probes \\
        --bank probe-results/probe_bank_object_binary.npz --log_dir <episodes>
"""

from __future__ import annotations

import ast
import csv
from dataclasses import dataclass
from pathlib import Path

from ..overwatch import initialize_overwatch
from . import _cli

overwatch = initialize_overwatch(__name__)
LABEL_KEY_DIR = Path(__file__).resolve().parents[1] / "robot" / "label_keys"


@dataclass(frozen=True)
class AnalyzeConfig:
    bank: str = "probe-results/probe_bank_object_binary.npz"
    log_dir: str = "experiments/logs"
    out_dir: str = "probe-results"
    suite: str = "object"
    success_only: bool = False              # restrict to successful episodes
    failures_only: bool = False             # eval_object_probe_on_failure mode
    eval_log: str = ""                      # log file for success filtering


def label_names(suite: str):
    """The suite's object-relation then action-state label names."""
    rel = ast.literal_eval((LABEL_KEY_DIR / f"{suite}_object_relations_keys.txt").read_text())
    act = ast.literal_eval((LABEL_KEY_DIR / f"{suite}_action_states_keys.txt").read_text())
    return list(rel) + list(act)


def matrix_png(rows, out_path: Path, metric: str = "f1", weight_by_support: bool = False,
               cell: int = 16) -> Path:
    """probe/plots.family_layer_matrix as a PNG without matplotlib: rows are
    layers, columns families, each cell `cell` pixels square."""
    import numpy as np

    from ..probe import plots
    from ..utils.image_io import write_png

    m = plots.family_layer_matrix(rows, metric, weight_by_support)["matrix"]
    gray = np.round(np.clip(np.nan_to_num(m, nan=0.0), 0.0, 1.0) * 255).astype(np.uint8)
    img = np.repeat(gray[:, :, None], 3, axis=2)
    img[np.isnan(m)] = (255, 0, 0)
    return write_png(out_path, np.kron(img, np.ones((cell, cell, 1), np.uint8)))


def matrix_name(heatmap_name: str) -> str:
    """The file name `matrix_png` takes in place of a heatmap's."""
    return heatmap_name[:-len(".png")] + "_matrix.png"


def heatmap(rows, out_path: Path, metric: str = "f1", weight_by_support: bool = False) -> Path:
    """plots.plot_family_heatmap, or `matrix_png` under `matrix_name` where
    matplotlib is missing."""
    from ..probe import plots

    try:
        import matplotlib  # noqa: F401
    except ImportError:
        bare = out_path.with_name(matrix_name(out_path.name))
        overwatch.warning(f"matplotlib is not installed: {bare.name} is the bare "
                          f"layer x family matrix (no axes or labels) in place of {out_path.name}")
        return matrix_png(rows, bare, metric, weight_by_support)
    return plots.plot_family_heatmap(rows, out_path, metric=metric,
                                     weight_by_support=weight_by_support)


def main(cfg: AnalyzeConfig) -> None:
    from ..probe import analysis, logs, plots
    from ..probe.analysis import write_reference_csv
    from ..probe.episodes import iter_episodes
    from ..probe.train_probes import ProbeBank

    bank = ProbeBank.load(cfg.bank)
    names = label_names(cfg.suite)
    kept_names = [names[i] for i in bank.keep]

    include = None
    if (cfg.success_only or cfg.failures_only) and cfg.eval_log:
        records = logs.parse_eval_log(Path(cfg.eval_log).read_text())
        include = (logs.success_indices(records) if cfg.success_only
                   else logs.failure_indices(records))
        overwatch.info(f"Filtering to {len(include)} episodes")

    collected = analysis.collect_logits(bank, cfg.log_dir, include=include)
    rows = analysis.per_label_metrics(collected, kept_names)
    fams = analysis.family_auprc(collected, kept_names)

    out = Path(cfg.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    # analysis/02_per_label_metrics.py emits the auprc column; the
    # experiment_images variant drops it — write both published schemas.
    write_reference_csv("per_label_auprc", rows, out / "per_label_metrics_reference_schema.csv")
    write_reference_csv("per_label", rows, out / "per_label_metrics_experiment_images_schema.csv")
    with open(out / "per_label_metrics.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    write_reference_csv("family_auprc", fams, out / "family_auprc_reference_schema.csv")
    with open(out / "family_auprc.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(fams[0].keys()))
        w.writeheader()
        w.writerows(fams)
    # published label_stats.csv (visualize_data_distribution equivalent)
    episodes = list(iter_episodes(cfg.log_dir, include=include))
    stats_rows = plots.label_stats_rows(episodes, names)
    write_reference_csv("label_stats", stats_rows, out / "label_stats.csv")

    heatmap(rows, out / f"heatmap_f1_{cfg.suite}.png", metric="f1")
    heatmap(rows, out / f"heatmap_recall_{cfg.suite}.png", metric="recall")
    heatmap(rows, out / f"heatmap_f1_weighted_{cfg.suite}.png", metric="f1",
            weight_by_support=True)
    hist = analysis.metric_histogram(rows, "f1")
    overwatch.info(f"global mean f1: {hist['mean']:.4f}")
    for r in fams:
        overwatch.info(f"  family {r['family']}: AUPRC={r['auprc']:.3f} lift={r['lift']:.1f}x")
    overwatch.info(f"wrote CSVs + heatmaps to {out}")


if __name__ == "__main__":
    main(_cli.parse(AnalyzeConfig, __doc__))
