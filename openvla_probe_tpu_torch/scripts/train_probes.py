"""Train per-layer linear probes on captured episodes -> probe bank + metrics CSV.

Counterpart of the JAX package's ``scripts/train_probes.py`` (the unified
train_object_probes / train_spatial_probes / train_dual_head_final /
train_3class_direct, selected with --head); every layer trains in one bank on
the card.

    python -m openvla_probe_tpu_torch.scripts.train_probes --log_dir <episodes> \\
        --out_dir probe-results --suite object --head binary [--device cpu]
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from ..overwatch import initialize_overwatch
from . import _cli

overwatch = initialize_overwatch(__name__)


@dataclass(frozen=True)
class ProbeCLIConfig:
    log_dir: str = "experiments/logs"       # episode_*.npz / episode_*.pt
    out_dir: str = "probe-results"
    suite: str = "object"                   # object | spatial (names the CSV)
    head: str = "binary"                    # binary | dual | 3class
    epochs: int = 20
    batch: int = 4096
    layers: str = "all"                     # "all" or comma-separated ints
    exclude_eps: str = ""                   # "11,13" or ranges "50-60"
    shuffled_label_control: bool = False
    seed: int = 0
    device: str = "cuda"                    # "cpu" trains on the CPU


def parse_exclusions(spec: str):
    out = set()
    for tok in filter(None, (t.strip() for t in spec.split(","))):
        if "-" in tok:
            a, b = map(int, tok.split("-"))
            out.update(range(a, b + 1))
        else:
            out.add(int(tok))
    return sorted(out)


def main(cfg: ProbeCLIConfig) -> None:
    from ..probe.analysis import write_reference_csv
    from ..probe.train_probes import ProbeTrainConfig, save_metrics_csv, train_probes

    dev = _cli.ready_device(cfg.device)
    layers = None if cfg.layers == "all" else [int(x) for x in cfg.layers.split(",")]
    tcfg = ProbeTrainConfig(
        epochs=cfg.epochs, batch_size=cfg.batch, head=cfg.head, seed=cfg.seed,
        shuffled_label_control=cfg.shuffled_label_control,
        freq_filter=(0.01, 0.99) if cfg.head == "dual" else None,
    )
    result = train_probes(cfg.log_dir, tcfg, layers=layers,
                          exclude_eps=parse_exclusions(cfg.exclude_eps), device=dev)
    out = Path(cfg.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    bank_path = result["bank"].save(out / f"probe_bank_{cfg.suite}_{cfg.head}.npz")
    csv_path = save_metrics_csv(result["records"], out / f"probe_metrics_{cfg.suite}.csv")
    # also emit the reference's exact column layout (drop-in artifact compat)
    kind = {"binary": "binary", "dual": "dual", "3class": "3class"}[cfg.head]
    write_reference_csv(kind, result["records"],
                        out / f"probe_metrics_{cfg.suite}_reference_schema.csv")
    overwatch.info(f"baseline: {result['baseline']}")
    for r in result["records"]:
        overwatch.info("  " + "  ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                                        for k, v in r.items()))
    overwatch.info(f"bank -> {bank_path}; metrics -> {csv_path}")


if __name__ == "__main__":
    main(_cli.parse(ProbeCLIConfig, __doc__))
