"""Episode capture storage: per-rollout hidden states + symbolic labels
(the port's copy of ``openvla_probe_tpu/probe/episodes.py``, numpy only; the
reference's ``.pt`` format goes through torch).

Replaces the reference's per-episode torch.save payloads
(experiments/robot/libero/run_libero_eval_object.py:356-367:
`episode_N.pt` = {visual_semantic_encoding: {layer: [T, 4096]},
symbolic_state_object_relations: [T, K_rel], symbolic_state_action_subgoals:
[T, K_act]}) with compressed .npz: hidden states stored as ONE stacked
[n_layers+1, T, D] array (fp16 by default — probes are robust to it and it
halves disk), labels as int8 {-1, 0, 1}.

`load_episode` also reads the reference's .pt format so probe training runs
on either corpus.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

EP_RE = re.compile(r"episode_(\d+)\.(npz|pt)$")


class EpisodeWriter:
    """Accumulate per-step capture, then flush one episode file."""

    def __init__(self, out_dir: Union[str, Path], hidden_dtype=np.float16) -> None:
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.hidden_dtype = hidden_dtype
        self.reset()

    def reset(self) -> None:
        self._hidden: List[np.ndarray] = []      # each [n_layers+1, D]
        self._labels: Dict[str, List[np.ndarray]] = {}

    def append(self, hidden_pooled: np.ndarray, **label_vectors: np.ndarray) -> None:
        """hidden_pooled: [n_layers+1, D] (one control step's taps)."""
        self._hidden.append(np.asarray(hidden_pooled, self.hidden_dtype))
        for k, v in label_vectors.items():
            self._labels.setdefault(k, []).append(np.asarray(v, np.int8))

    def flush(self, episode_index: int, success: Optional[bool] = None) -> Path:
        path = self.out_dir / f"episode_{episode_index}.npz"
        payload = {
            "visual_semantic_encoding": np.stack(self._hidden, axis=1),  # [L+1, T, D]
        }
        for k, v in self._labels.items():
            payload[k] = np.stack(v)                                     # [T, K]
        if success is not None:
            payload["success"] = np.asarray(success)
        np.savez_compressed(path, **payload)
        self.reset()
        return path


def load_episode(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Load .npz (ours) or .pt (reference layout) into the stacked schema."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.suffix == ".pt":
        import torch

        blob = torch.load(path, map_location="cpu", weights_only=False)
        enc = blob["visual_semantic_encoding"]
        layers = sorted(enc.keys())
        hidden = np.stack([np.asarray(enc[l], np.float32) for l in layers])  # [L+1, T, D]
        out: Dict[str, np.ndarray] = {"visual_semantic_encoding": hidden}
        for k, v in blob.items():
            if k != "visual_semantic_encoding":
                out[k] = np.asarray(v)
        return out
    raise ValueError(f"Unknown episode format: {path}")


def export_episode_pt(src: Union[str, Path], dst: Optional[Union[str, Path]] = None) -> Path:
    """Write a reference-schema `episode_N.pt` from one of our `.npz` episodes
    (inverse of the `.pt` branch in `load_episode`), so the reference's
    downstream scripts (train_linear_probes.py etc.) consume this repo's
    rollouts directly: `visual_semantic_encoding` becomes a {layer: [T, D]
    tensor} dict, label matrices become tensors (reference
    run_libero_eval_object.py:352-366)."""
    import torch

    src = Path(src)
    dst = Path(dst) if dst is not None else src.with_suffix(".pt")
    dst.parent.mkdir(parents=True, exist_ok=True)
    ep = load_episode(src)
    hidden = np.asarray(ep["visual_semantic_encoding"], np.float32)  # [L+1, T, D]
    payload: Dict[str, Any] = {
        "visual_semantic_encoding": {
            layer: torch.from_numpy(np.ascontiguousarray(hidden[layer]))
            for layer in range(hidden.shape[0])
        }
    }
    for k, v in ep.items():
        if k != "visual_semantic_encoding":
            payload[k] = torch.from_numpy(np.atleast_1d(np.asarray(v)))
    torch.save(payload, dst)
    return dst


def list_episodes(data_dir: Union[str, Path]) -> List[Path]:
    paths = [p for p in Path(data_dir).iterdir() if EP_RE.search(p.name)]
    return sorted(paths, key=lambda p: int(EP_RE.search(p.name).group(1)))


def episode_index(path: Union[str, Path]) -> int:
    return int(EP_RE.search(Path(path).name).group(1))


def iter_episodes(
    data_dir: Union[str, Path],
    include: Optional[Sequence[int]] = None,
    exclude: Optional[Sequence[int]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    inc = set(include) if include is not None else None
    exc = set(exclude or ())
    for p in list_episodes(data_dir):
        i = episode_index(p)
        if (inc is not None and i not in inc) or i in exc:
            continue
        yield load_episode(p)
