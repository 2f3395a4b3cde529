"""The probe bank and its analysis (counterpart of ``openvla_probe_tpu/probe``).

Ported: episode storage, the rollout capture session, the all-layer probe
trainer and evaluator, the analysis and log utilities, their metrics in
numpy. Not ported: ``plots.py`` (matplotlib).
"""

from .analysis import collect_logits, family_auprc, per_label_metrics
from .capture import CaptureSession, SymbolicDetector
from .episodes import EpisodeWriter, iter_episodes, list_episodes, load_episode
from .train_probes import ProbeBank, ProbeTrainConfig, evaluate_probes, save_metrics_csv

# keep the `probe.train_probes` attribute bound to the SUBMODULE (the bare
# function would shadow it); reach the function via probe.train_probes.train_probes
from . import train_probes  # noqa: E402

__all__ = [
    "CaptureSession",
    "EpisodeWriter",
    "ProbeBank",
    "ProbeTrainConfig",
    "collect_logits",
    "evaluate_probes",
    "family_auprc",
    "iter_episodes",
    "list_episodes",
    "load_episode",
    "per_label_metrics",
    "save_metrics_csv",
    "SymbolicDetector",
    "train_probes",
]
