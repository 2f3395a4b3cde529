"""Per-layer linear probes on captured hidden states, all layers at once
(counterpart of ``openvla_probe_tpu/probe/train_probes.py``).

The JAX package's statistical semantics, kept:

  * episode-level split: ids shuffled by random.Random(seed), first 10% = val
  * keep-filter: only label columns with BOTH a 0 and a 1 somewhere
  * pos_weight = (neg+1)/(pos+1) from the TRAIN split, clamped to 20
  * masked BCE-with-logits; -1 (not-applicable) excluded everywhere
  * majority-class baseline trained-on-train, scored-on-val
  * optional column-shuffled-label control, the dual head's train-only
    positive-frequency filter
  * AdamW (optax.adamw: b1 0.9, b2 0.999, eps 1e-8, decay on every leaf), the
    epochs' permutations from np.random.default_rng(seed), batch 4096,
    threshold 0.5
  * metrics: masked accuracy, macro-F1 and AP (``probe.metrics``, numpy, the
    values of scikit-learn's), computed on the host as the JAX package does

The probe bank is one parameter tensor {w: [L, K_out, D], b: [L, K_out]} on
the device, and every step updates all layers at once (per-layer mean-masked
losses summed, so each probe's trajectory is its standalone run's): the
training rows stay on the device and each step gathers its batch there; the
per-layer product is one batched matmul in fp32. Head variants: `binary`,
`dual` (presence + truth heads), `3class` (direct CE).

Standing divergence: the initial bank comes from a torch.Generator seeded
with cfg.seed (uniform in ±1/sqrt(D), as the JAX package draws it from
jax.random), so the two packages start from other numbers; `init=(w, b)`
hands in a given bank.
"""

from __future__ import annotations

import csv
import dataclasses
import random
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..training.train_state import AdamW, OptimizerConfig, apply_updates
from . import metrics
from .episodes import iter_episodes

DEFAULT_LABEL_KEYS = ("symbolic_state_object_relations", "symbolic_state_action_subgoals")


@dataclasses.dataclass(frozen=True)
class ProbeTrainConfig:
    epochs: int = 20
    batch_size: int = 4096
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    pos_weight_clamp: float = 20.0
    threshold: float = 0.5
    seed: int = 0
    val_frac: float = 0.10
    head: str = "binary"            # binary | dual | 3class
    shuffled_label_control: bool = False
    freq_filter: Optional[Tuple[float, float]] = None  # dual-head (0.01, 0.99) filter


@dataclasses.dataclass
class ProbeBank:
    """Trained probe parameters for all layers + bookkeeping (numpy, the JAX
    package's .npz format)."""

    w: np.ndarray                  # [L, K_out, D]
    b: np.ndarray                  # [L, K_out]
    layers: List[int]
    keep: np.ndarray               # label-column indices kept
    head: str

    def save(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        np.savez_compressed(
            path, w=self.w, b=self.b, layers=np.asarray(self.layers),
            keep=self.keep, head=np.asarray(self.head),
        )
        return path

    @staticmethod
    def load(path: Union[str, Path]) -> "ProbeBank":
        with np.load(path, allow_pickle=False) as z:
            return ProbeBank(
                w=z["w"], b=z["b"], layers=list(z["layers"]),
                keep=z["keep"], head=str(z["head"]),
            )

    def logits(self, x: np.ndarray, layer_pos: int) -> np.ndarray:
        """x: [N, D] hidden states of self.layers[layer_pos]."""
        return x @ self.w[layer_pos].T + self.b[layer_pos]


def _episode_xy(
    episodes: Sequence[Dict[str, np.ndarray]],
    label_keys: Sequence[str],
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per-episode ([L+1, T, D] hidden, [T, K] labels)."""
    xs, ys = [], []
    for ep in episodes:
        xs.append(np.asarray(ep["visual_semantic_encoding"]))
        ys.append(np.concatenate([np.asarray(ep[k]) for k in label_keys], axis=1))
    return xs, ys


def _column_shuffle(y: np.ndarray, seed: int = 0) -> np.ndarray:
    g = np.random.default_rng(seed)
    out = y.copy()
    for c in range(out.shape[1]):
        out[:, c] = out[g.permutation(out.shape[0]), c]
    return out


def majority_baseline(y_tr: np.ndarray, y_val: np.ndarray) -> Dict[str, float]:
    """Column-majority predictor trained on train, scored on val (masked)."""
    m_tr = y_tr != -1
    maj = ((y_tr == 1) & m_tr).sum(0) > ((y_tr == 0) & m_tr).sum(0)
    m_val = y_val != -1
    tgt = (y_val == 1)
    pred = np.broadcast_to(maj, tgt.shape)
    acc = (pred == tgt)[m_val].mean() if m_val.any() else 0.0
    f1 = metrics.f1_score(tgt[m_val].astype(int), pred[m_val].astype(int),
                          average="macro", zero_division=0) if m_val.any() else 0.0
    return {"val_acc": float(acc), "val_f1": float(f1)}


def init_bank(L: int, K_out: int, D: int, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [L, K_out, D], b [L, K_out] uniform in ±1/sqrt(D) from a torch.Generator
    seeded with `seed` (on the CPU, so every device starts from the same bank)."""
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / np.sqrt(D)
    w = torch.rand((L, K_out, D), generator=g) * (2 * bound) - bound
    b = torch.rand((L, K_out), generator=g) * (2 * bound) - bound
    return w, b


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy: -z log σ(x) - (1 - z) log σ(-x)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def head_loss(head: str, logits: torch.Tensor, y: torch.Tensor,
              pos_w: torch.Tensor) -> torch.Tensor:
    """The summed per-layer losses; logits [L, B, K_out], y [B, K] in {-1, 0, 1}."""
    L, B = logits.shape[:2]
    K = y.shape[1]
    mask = (y != -1).float()
    n_mask = torch.clamp(mask.sum(), min=1.0)
    if head == "binary":
        tgt = (y == 1).float()
        bce = _sigmoid_bce(logits, tgt[None])
        bce = bce * torch.where(tgt[None] == 1, pos_w, torch.ones_like(pos_w))
        return ((bce * mask[None]).sum((1, 2)) / n_mask).sum()
    if head == "dual":
        pres, truth = logits[..., :K], logits[..., K:]
        pres_bce = _sigmoid_bce(pres, mask[None])
        tr_bce = _sigmoid_bce(truth, (y == 1).float()[None]) * mask[None]
        return (pres_bce.mean((1, 2)) + tr_bce.sum((1, 2)) / n_mask).sum()
    if head == "3class":   # CE over {-1, 0, 1} -> class index y + 1
        logp = torch.log_softmax(logits.reshape(L, B, K, 3), dim=-1)
        nll = -torch.gather(logp, -1, (y + 1).long()[None, :, :, None].expand(L, B, K, 1))[..., 0]
        return nll.mean((1, 2)).sum()
    raise ValueError(f"unknown probe head {head!r}")


def train_probes(
    data: Union[str, Path, Sequence[Dict[str, np.ndarray]]],
    cfg: ProbeTrainConfig = ProbeTrainConfig(),
    layers: Optional[Sequence[int]] = None,
    label_keys: Sequence[str] = DEFAULT_LABEL_KEYS,
    exclude_eps: Optional[Sequence[int]] = None,
    device: DeviceLike = "cuda",
    init: Optional[Tuple[Any, Any]] = None,
) -> Dict[str, Any]:
    """Train the probe bank on `device`; returns {bank, records, baseline,
    split, train_s}. `records` rows match the reference CSV schema: layer /
    val_acc / val_f1 / val_ap (+ presence_f1/truth_f1 for dual, 3-class f1 for
    3class); `train_s` is the host time of the epochs, the device's work
    included. `init` = (w [L, K_out, D], b [L, K_out]) replaces the seeded
    initial bank."""
    dev = resolve_device(device)
    if isinstance(data, (str, Path)):
        episodes = list(iter_episodes(data, exclude=exclude_eps))
    else:
        episodes = list(data)
    if not episodes:
        raise FileNotFoundError("No episodes to train on")

    xs, ys = _episode_xy(episodes, label_keys)
    n_layers_total = xs[0].shape[0]
    layers = list(layers) if layers is not None else list(range(n_layers_total))

    # episode-level split (reference: random.Random(0).shuffle, first 10% val)
    ep_ids = list(range(len(episodes)))
    random.Random(cfg.seed).shuffle(ep_ids)
    val_len = max(1, int(cfg.val_frac * len(ep_ids)))
    val_ids, train_ids = ep_ids[:val_len], ep_ids[val_len:]

    y_full = np.concatenate(ys, axis=0)
    if cfg.shuffled_label_control:
        y_shuf = _column_shuffle(y_full, cfg.seed)
        cursor = 0
        for i in range(len(ys)):
            n = ys[i].shape[0]
            ys[i] = y_shuf[cursor:cursor + n]
            cursor += n
        y_full = np.concatenate(ys, axis=0)

    # keep-filter over ALL episodes (train ∪ val)
    m_full = y_full != -1
    pos_any = ((y_full == 1) & m_full).any(0)
    neg_any = ((y_full == 0) & m_full).any(0)
    keep = np.nonzero(pos_any & neg_any)[0]
    if keep.size == 0:
        raise RuntimeError("No label flips value across remaining episodes.")

    y_tr = np.concatenate([ys[i] for i in train_ids], axis=0)[:, keep]
    y_val = np.concatenate([ys[i] for i in val_ids], axis=0)[:, keep]
    if cfg.freq_filter is not None:
        # dual-head: train-only positive-frequency filter
        m = y_tr != -1
        freq = ((y_tr == 1) & m).sum(0) / np.maximum(m.sum(0), 1)
        ok = (freq > cfg.freq_filter[0]) & (freq < cfg.freq_filter[1])
        keep = keep[ok]
        y_tr, y_val = y_tr[:, ok], y_val[:, ok]

    K = keep.size
    D = xs[0].shape[-1]
    L = len(layers)

    x_tr = np.concatenate([xs[i][layers] for i in train_ids], axis=1)   # [L, Ntr, D]
    x_val = np.concatenate([xs[i][layers] for i in val_ids], axis=1)    # [L, Nva, D]

    # pos_weight from train
    m_tr = y_tr != -1
    pos_cnt = ((y_tr == 1) & m_tr).sum(0).astype(np.float32)
    neg_cnt = ((y_tr == 0) & m_tr).sum(0).astype(np.float32)
    pos_w = np.minimum((neg_cnt + 1.0) / (pos_cnt + 1.0), cfg.pos_weight_clamp)

    baseline = majority_baseline(y_tr, y_val)

    K_out = {"binary": K, "dual": 2 * K, "3class": 3 * K}[cfg.head]
    w0, b0 = init if init is not None else init_bank(L, K_out, D, cfg.seed)
    params = {k: (v.detach().to(dev, torch.float32).clone() if torch.is_tensor(v)
                  else torch.from_numpy(np.array(v, dtype=np.float32)).to(dev))
              for k, v in (("w", w0), ("b", b0))}
    if params["w"].shape != (L, K_out, D) or params["b"].shape != (L, K_out):
        raise ValueError(f"init: expected w {(L, K_out, D)} and b {(L, K_out)}, got "
                         f"{tuple(params['w'].shape)} and {tuple(params['b'].shape)}")
    # optax.adamw(lr, weight_decay=wd): no clipping, a constant rate, decay on both leaves
    optimizer = AdamW(OptimizerConfig(learning_rate=cfg.learning_rate,
                                      lr_schedule_type="constant",
                                      weight_decay=cfg.weight_decay,
                                      max_grad_norm=float("inf")), params)
    opt_state = optimizer.init(params)
    pos_w_d = torch.as_tensor(pos_w).to(dev)

    # the training rows stay on the device; each step gathers its batch there
    x_tr_d = torch.as_tensor(x_tr, dtype=torch.float32).to(dev)     # [L, Ntr, D]
    y_tr_d = torch.as_tensor(y_tr).to(dev)
    n_tr = x_tr.shape[1]
    g = np.random.default_rng(cfg.seed)
    t0 = time.perf_counter()
    for _ in range(cfg.epochs):
        order = g.permutation(n_tr)
        for s in range(0, n_tr, cfg.batch_size):
            idx = torch.as_tensor(order[s:s + cfg.batch_size]).to(dev)
            xb = x_tr_d.index_select(1, idx)
            yb = y_tr_d.index_select(0, idx)
            w = params["w"].requires_grad_(True)
            b = params["b"].requires_grad_(True)
            with torch.enable_grad():
                logits = torch.bmm(xb, w.transpose(1, 2)) + b[:, None, :]
                loss = head_loss(cfg.head, logits, yb, pos_w_d)
                gw, gb = torch.autograd.grad(loss, (w, b))
            with torch.no_grad():
                updates, opt_state = optimizer.update({"w": gw, "b": gb}, opt_state,
                                                      {"w": w.detach(), "b": b.detach()})
                params = apply_updates({"w": w.detach(), "b": b.detach()}, updates)

    w_host, b_host = params["w"].cpu().numpy(), params["b"].cpu().numpy()   # waits for the device
    train_s = time.perf_counter() - t0
    bank = ProbeBank(w=w_host, b=b_host, layers=layers, keep=keep, head=cfg.head)
    records = evaluate_probes(bank, x_val, y_val, cfg)
    return {
        "bank": bank,
        "records": records,
        "baseline": baseline,
        "split": {"train_ids": train_ids, "val_ids": val_ids},
        "train_s": train_s,
    }


def evaluate_probes(
    bank: ProbeBank,
    x_val: np.ndarray,       # [L, N, D]
    y_val: np.ndarray,       # [N, K]
    cfg: ProbeTrainConfig = ProbeTrainConfig(),
) -> List[Dict[str, float]]:
    """Per-layer masked accuracy + macro-F1 + macro-AP (host metrics)."""
    K = bank.keep.size
    mask = y_val != -1
    tgt = (y_val == 1).astype(int)
    records = []
    for li, layer in enumerate(bank.layers):
        logits = x_val[li].astype(np.float32) @ bank.w[li].T + bank.b[li]
        if bank.head == "binary":
            probs = 1.0 / (1.0 + np.exp(-logits))
            pred = (probs > cfg.threshold).astype(int)
            if mask.any():
                acc = (pred == tgt)[mask].mean()
                f1 = metrics.f1_score(tgt[mask], pred[mask], average="macro", zero_division=0)
                ap = metrics.average_precision_score(tgt[mask], probs[mask])
            else:
                acc = f1 = ap = 0.0
            records.append({"layer": layer, "val_acc": float(acc),
                            "val_f1": float(f1), "val_ap": float(ap)})
        elif bank.head == "dual":
            pres = 1.0 / (1.0 + np.exp(-logits[:, :K]))
            truth = 1.0 / (1.0 + np.exp(-logits[:, K:]))
            pres_pred = (pres > cfg.threshold).astype(int)
            pres_f1 = metrics.f1_score(mask.astype(int).ravel(), pres_pred.ravel(),
                                       average="macro", zero_division=0)
            pres_acc = float((pres_pred == mask.astype(int)).mean())
            tr_pred = (truth > cfg.threshold).astype(int)
            tr_f1 = (metrics.f1_score(tgt[mask], tr_pred[mask], average="macro",
                                      zero_division=0) if mask.any() else 0.0)
            tr_acc = float((tr_pred == tgt)[mask].mean()) if mask.any() else 0.0
            records.append({"layer": layer,
                            "presence_acc": pres_acc, "truth_acc": tr_acc,
                            "presence_f1": float(pres_f1), "truth_f1": float(tr_f1)})
        else:  # 3class
            lg = logits.reshape(-1, K, 3)
            pred = lg.argmax(-1) - 1
            f1 = metrics.f1_score((y_val + 1).ravel(), (pred + 1).ravel(),
                                  average="macro", zero_division=0)
            acc = float((pred == y_val).mean())
            records.append({"layer": layer, "val_acc": acc, "val_f1": float(f1)})
    return records


def save_metrics_csv(records: List[Dict[str, float]], path: Union[str, Path]) -> Path:
    """probe_metrics CSV in the reference's schema."""
    path = Path(path)
    if records:
        with open(path, "w", newline="") as f:
            wr = csv.DictWriter(f, fieldnames=list(records[0].keys()))
            wr.writeheader()
            wr.writerows(records)
    return path
