"""The probe metrics in numpy: the values of scikit-learn's ``f1_score``,
``precision_score``, ``recall_score``, ``average_precision_score``,
``balanced_accuracy_score`` and ``matthews_corrcoef`` for the calls the probe
modules make, without scikit-learn (the machine with the card does not have
it). The JAX package computes these with scikit-learn on the host.

Conventions kept (scikit-learn 1.9):

* F1 of a label = 2 tp / (2 tp + fp + fn); precision tp / (tp + fp); recall
  tp / (tp + fn); a zero denominator gives `zero_division`.
* ``average="binary"`` scores the label 1 alone; ``average="macro"`` takes the
  unweighted mean over the labels present in y_true or y_pred.
* Average precision: the scores sorted descending, one threshold per distinct
  score (ties form one step), precision = tp / (tp + fp), recall = tp / P;
  AP = Σ (R_n - R_{n-1}) P_n over the thresholds, clipped at 0. With no
  positive in y_true every recall is 1, which gives 0.
* Balanced accuracy: the mean recall over the classes present in y_true.
* MCC from the confusion matrix; 0 where a marginal is constant.
"""

from __future__ import annotations

import numpy as np


def _counts(y_true: np.ndarray, y_pred: np.ndarray, label) -> tuple:
    t, p = y_true == label, y_pred == label
    return int((t & p).sum()), int(p.sum()), int(t.sum())   # tp, pred_sum, true_sum


def _div(num: float, den: float, zero_division: float) -> float:
    return num / den if den else float(zero_division)


def _labels(y_true, y_pred, average: str):
    if average == "binary":
        return [1]
    if average == "macro":
        return list(np.union1d(np.unique(y_true), np.unique(y_pred)))
    raise ValueError(f"average={average!r}: binary or macro")


def f1_score(y_true, y_pred, average: str = "binary", zero_division: float = 0.0) -> float:
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    scores = []
    for label in _labels(y_true, y_pred, average):
        tp, pred, true = _counts(y_true, y_pred, label)
        scores.append(_div(2.0 * tp, float(true + pred), zero_division))
    return float(np.mean(scores)) if scores else float(zero_division)


def precision_score(y_true, y_pred, zero_division: float = 0.0) -> float:
    tp, pred, _ = _counts(np.asarray(y_true).ravel(), np.asarray(y_pred).ravel(), 1)
    return _div(float(tp), float(pred), zero_division)


def recall_score(y_true, y_pred, zero_division: float = 0.0) -> float:
    tp, _, true = _counts(np.asarray(y_true).ravel(), np.asarray(y_pred).ravel(), 1)
    return _div(float(tp), float(true), zero_division)


def average_precision_score(y_true, y_score) -> float:
    """Binary average precision (label 1 positive), scikit-learn's step integral."""
    y_true = (np.asarray(y_true).ravel() == 1).astype(np.float64)
    y_score = np.asarray(y_score).ravel()
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    last = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[last]
    fps = 1 + last - tps
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1), 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _confusion(y_true, y_pred):
    """Counts [true label, predicted label] over the labels of either."""
    labels = np.union1d(np.unique(y_true), np.unique(y_pred))
    k = labels.size
    ti, pi = np.searchsorted(labels, y_true), np.searchsorted(labels, y_pred)
    return np.bincount(ti * k + pi, minlength=k * k).reshape(k, k)


def balanced_accuracy_score(y_true, y_pred) -> float:
    C = _confusion(np.asarray(y_true).ravel(), np.asarray(y_pred).ravel())
    support = C.sum(axis=1)
    per_class = np.diag(C)[support > 0] / support[support > 0]
    return float(per_class.mean())


def matthews_corrcoef(y_true, y_pred) -> float:
    C = _confusion(np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()).astype(np.float64)
    t_sum, p_sum = C.sum(axis=1), C.sum(axis=0)
    n_correct, n = np.trace(C), C.sum()
    cov_ytyp = n_correct * n - np.dot(t_sum, p_sum)
    cov_ypyp = n ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n ** 2 - np.dot(t_sum, t_sum)
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ytyt * cov_ypyp))
