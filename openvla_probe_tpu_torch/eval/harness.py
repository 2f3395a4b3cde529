"""VLM evaluation harness: closed-set (multiple-choice) and open-ended tasks
(counterpart of ``openvla_probe_tpu/eval/harness.py``, which imports no JAX
at module level; the port keeps its own copy all the same, on the port's
scorer, generator and image transform).

* closed-set: the predicted option is the argmax of the summed
  candidate-token log-probabilities (`models.generate.score_continuation_rows`,
  each candidate against its own context split); `length_normalize=True`
  divides by the candidate's token count.
* open-ended: greedy generation (`models.generate.generate_greedy_batch`),
  graded by normalized exact match or VQAv2 soft accuracy
  (min(#matches / 3, 1); exact match below 3 answers).

Answer normalization: lowercase, punctuation and articles (a/an/the) removed,
whitespace collapsed. Both evaluators take `device` (the card by default,
``"cpu"`` for the plain versions) and keep the injection points
(`score_fn`, `generate_fn`, `generate_batch_fn`).
"""

from __future__ import annotations

import dataclasses
import json
import re
import string
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_ARTICLES = {"a", "an", "the"}
_PUNCT_TABLE = str.maketrans({c: " " for c in string.punctuation})


def normalize_answer(text: str) -> str:
    """VQA-style normalization: lowercase, no punctuation/articles, single spaces."""
    text = text.lower().translate(_PUNCT_TABLE)
    words = [w for w in text.split() if w not in _ARTICLES]
    return " ".join(words)


def exact_match(prediction: str, answers: Sequence[str]) -> float:
    pred = normalize_answer(prediction)
    return float(any(pred == normalize_answer(a) for a in answers))


def vqa_accuracy(prediction: str, answers: Sequence[str]) -> float:
    """VQAv2 soft accuracy: min(matches/3, 1). With <3 answers this reduces
    toward exact match (single-answer datasets get 1/3-steps otherwise, so we
    use plain exact match below 3 annotators — the convention vlm-evaluation
    applies to GQA/TextVQA-style single-answer sets)."""
    if len(answers) < 3:
        return exact_match(prediction, answers)
    pred = normalize_answer(prediction)
    matches = sum(pred == normalize_answer(a) for a in answers)
    return min(matches / 3.0, 1.0)


@dataclasses.dataclass
class EvalExample:
    """One evaluation item.

    `image` is an [H, W, 3] uint8 array (or None for text-only);
    `choices` non-empty makes it a closed-set item with `answer_idx` the
    ground-truth option; open-ended items use `answers` (>=1 reference
    strings).
    """

    question: str
    answers: List[str] = dataclasses.field(default_factory=list)
    choices: List[str] = dataclasses.field(default_factory=list)
    answer_idx: int = -1
    image: Optional[np.ndarray] = None
    example_id: Optional[str] = None


def load_jsonl_dataset(
    path: str,
    image_root: Optional[str] = None,
    max_examples: Optional[int] = None,
    image_loader: Optional[Callable[[Path], np.ndarray]] = None,
) -> List[EvalExample]:
    """Read a JSONL eval file: one object per line with keys
    question, answers|answer, choices?, answer_idx?, image? (path). The port
    carries no image decoder: rows with an image need `image_loader`, which
    reads a path into [H, W, 3] uint8 (e.g. with PIL,
    ``lambda p: np.asarray(Image.open(p).convert("RGB"))``)."""
    out: List[EvalExample] = []
    root = Path(image_root) if image_root else None
    with open(path) as f:
        for i, line in enumerate(f):
            if max_examples is not None and len(out) >= max_examples:
                break
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            answers = row.get("answers") or ([row["answer"]] if "answer" in row else [])
            choices = [str(c) for c in row.get("choices", [])]
            answer_idx = int(row.get("answer_idx", -1))
            if answer_idx < 0 and choices and answers:
                # "answer" given as a string: resolve it against the choices
                # (an unresolved -1 would skip the example downstream).
                # VQA-normalized comparison so "yes" matches "Yes".
                norm_choices = [normalize_answer(c) for c in choices]
                for a in answers:
                    if normalize_answer(str(a)) in norm_choices:
                        answer_idx = norm_choices.index(normalize_answer(str(a)))
                        break
            img = None
            if row.get("image"):
                p = Path(row["image"])
                if root is not None and not p.is_absolute():
                    p = root / p
                if image_loader is None:
                    raise ValueError(f"{path}: row {i} has an image; pass image_loader= "
                                     "to read it")
                img = np.asarray(image_loader(p), np.uint8)
            out.append(EvalExample(
                question=row["question"],
                answers=[str(a) for a in answers],
                choices=choices,
                answer_idx=answer_idx,
                image=img,
                example_id=str(row.get("id", i)),
            ))
    return out


def _continuation_split(
    tokenizer: Any, prompt: str, continuation: str,
    base_ids: Optional[List[int]] = None,
) -> Tuple[List[int], int]:
    """Tokenize `prompt + continuation` and return (full_ids, start) where
    full_ids[start:] is the continuation's token span.

    Sentencepiece merges across the boundary make independent tokenization
    wrong, AND the merge point differs per continuation (trailing "▁" +
    "blue" re-merges into "▁blue"; "7" doesn't) — so each candidate must be
    scored against ITS OWN context full_ids[:start], not a shared prompt
    tokenization (which would condition re-merging choices on a double
    space and bias the ranking)."""
    base = list(base_ids) if base_ids is not None else list(tokenizer.encode(prompt))
    full = list(tokenizer.encode(prompt + continuation))
    i = 0
    while i < len(base) and i < len(full) and base[i] == full[i]:
        i += 1
    if i >= len(full):
        raise ValueError(
            f"continuation {continuation!r} adds no tokens after {prompt!r} "
            f"(empty or fully absorbed into the prompt tokenization) — "
            f"scoring it would grade the prompt's own last token"
        )
    return full, i


def _continuation_ids(tokenizer: Any, prompt: str, continuation: str) -> List[int]:
    """Back-compat helper: just the continuation's token span."""
    full, i = _continuation_split(tokenizer, prompt, continuation)
    return full[i:]


def _build_prompt(question: str, prompt_builder_factory: Optional[Callable]) -> str:
    if prompt_builder_factory is None:
        return f"In: {question}\nOut: "
    b = prompt_builder_factory()
    b.add_turn("human", question)
    return b.get_prompt()


def _pixels_for(cfg, image_cfg, image: Optional[np.ndarray], device: DeviceLike = "cuda"):
    if image is None:
        return None
    if image_cfg is None:
        # a caller who forgets image_cfg must not get a silently-blind vision
        # benchmark: strip images from the examples explicitly if a text-only
        # ablation is intended
        raise ValueError(
            "example carries an image but image_cfg is None — pass the "
            "model's ImageTransformConfig, or set ex.image=None for a "
            "deliberate text-only ablation")
    from ..ops.image import apply_image_transform

    px = apply_image_transform(torch.as_tensor(image[None], device=resolve_device(device)),
                               image_cfg)
    return px.to(cfg.llm.dtype)


def evaluate_closed_set(
    params: Dict[str, Any],
    cfg: Any,                                # vlm.VLMConfig
    tokenizer: Any,
    examples: Sequence[EvalExample],
    image_cfg: Optional[Any] = None,         # ops.image.ImageTransformConfig
    prompt_builder_factory: Optional[Callable] = None,
    length_normalize: bool = False,
    score_fn: Optional[Callable] = None,      # injection point for tests
    strict: bool = False,                     # raise on malformed examples
    examples_per_batch: int = 8,              # cross-example row batching
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """Multiple-choice accuracy via candidate logprob scoring.

    Returns {"accuracy", "n", "n_skipped", "results": [{id, predicted_idx,
    correct, scores}], "skipped": [...]}. Candidate rows batch across
    examples (up to `examples_per_batch` consecutive same-modality examples
    share one scoring call, each row carrying its own pixels); rows are
    independent, so the results are those of one call per example.
    Malformed examples (unresolvable answer_idx, fully-absorbed choice
    strings) skip with a recorded reason by default; strict=True raises
    instead. Images are transformed on `device`.
    """
    if score_fn is None:
        from ..models.generate import score_continuation_rows

        def score_fn(params, cfg, rows, pixel_values=None):
            return score_continuation_rows(params, cfg, rows, pixel_values, device=device)

    results = []
    skipped = []
    state = {"n_correct": 0}
    pending: List[Dict[str, Any]] = []   # same-modality examples awaiting a call

    def flush():
        if not pending:
            return
        all_rows = [r for p in pending for r in p["rows"]]
        px = None
        if pending[0]["px"] is not None:
            px = torch.cat([p["px"].repeat(len(p["rows"]), 1, 1, 1) for p in pending])
        flat = np.asarray(score_fn(params, cfg, all_rows, pixel_values=px),
                          np.float64)
        off = 0
        for p in pending:
            rows, ex = p["rows"], p["ex"]
            scores = flat[off: off + len(rows)]
            off += len(rows)
            if length_normalize:
                scores = scores / np.maximum([len(f) - s for f, s in rows], 1)
            pred = int(np.argmax(scores))
            correct = pred == ex.answer_idx
            state["n_correct"] += int(correct)
            results.append({
                "id": ex.example_id,
                "predicted_idx": pred,
                "predicted": ex.choices[pred],
                "correct": bool(correct),
                "scores": [float(s) for s in scores],
            })
        pending.clear()

    for ex in examples:
        assert ex.choices, f"closed-set example {ex.example_id} has no choices"
        if ex.answer_idx < 0 or ex.answer_idx >= len(ex.choices):
            # a malformed example must not silently score 0 — but it must not
            # abort an hours-long run either: strict raises, default skips
            # loudly and reports the skip count in the summary
            msg = (f"closed-set example {ex.example_id} has answer_idx="
                   f"{ex.answer_idx} outside its {len(ex.choices)} choices")
            if strict:
                raise ValueError(msg)
            skipped.append({"id": ex.example_id, "error": msg})
            continue
        prompt = _build_prompt(ex.question, prompt_builder_factory)
        base_ids = list(tokenizer.encode(prompt))  # loop-invariant per example
        try:
            # per-candidate (full tokenization, split point): each choice
            # scores against its own context (see _continuation_split)
            rows = [_continuation_split(tokenizer, prompt, c, base_ids=base_ids)
                    for c in ex.choices]
        except ValueError as e:
            if strict:
                raise
            skipped.append({"id": ex.example_id, "error": str(e)})
            continue
        px = _pixels_for(cfg, image_cfg, ex.image, device)
        if pending and ((pending[0]["px"] is None) != (px is None)):
            flush()   # modality change: text-only and vision rows never mix
        pending.append({"ex": ex, "rows": rows, "px": px})
        if len(pending) >= examples_per_batch:
            flush()
    flush()
    n = max(len(results), 1)
    return {"task": "closed_set", "accuracy": state["n_correct"] / n,
            "n": len(results),
            "n_skipped": len(skipped), "skipped": skipped, "results": results}


def evaluate_open_ended(
    params: Dict[str, Any],
    cfg: Any,
    tokenizer: Any,
    examples: Sequence[EvalExample],
    image_cfg: Optional[Any] = None,
    prompt_builder_factory: Optional[Callable] = None,
    max_new_tokens: int = 32,
    metric: str = "vqa",                      # "vqa" | "exact"
    generate_fn: Optional[Callable] = None,    # per-example injection (legacy)
    generate_batch_fn: Optional[Callable] = None,  # batched injection point
    examples_per_batch: int = 8,               # cross-example generation batching
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """Greedy generation graded by VQA soft accuracy or exact match.

    Same-modality examples batch into one generate call
    (`generate_greedy_batch`), `examples_per_batch` at a time. Rows are
    independent (per-row prompt masks and EOS latching), so the results are
    those of the per-example loop. Passing `generate_fn` keeps the
    per-example path (tests, custom decoders). Images are transformed on
    `device`."""
    grade = vqa_accuracy if metric == "vqa" else exact_match
    results = []
    total = 0.0

    if generate_fn is not None:
        for ex in examples:
            assert ex.answers, f"open-ended example {ex.example_id} has no answers"
            prompt = _build_prompt(ex.question, prompt_builder_factory)
            prompt_ids = list(tokenizer.encode(prompt))
            px = _pixels_for(cfg, image_cfg, ex.image, device)
            pred = generate_fn(params, cfg, tokenizer, prompt_ids, px)
            acc = grade(pred, ex.answers)
            total += acc
            results.append({"id": ex.example_id, "prediction": pred, "accuracy": acc})
        n = max(len(results), 1)
        return {"task": "open_ended", "metric": metric, "accuracy": total / n,
                "n": len(results), "results": results}

    if generate_batch_fn is None:
        from ..models.generate import generate_greedy_batch

        def generate_batch_fn(params, cfg, tokenizer, prompts_ids, pixel_values):
            return generate_greedy_batch(params, cfg, tokenizer, prompts_ids,
                                         pixel_values=pixel_values,
                                         max_new_tokens=max_new_tokens, device=device)

    pending: List[Dict[str, Any]] = []

    def flush():
        if not pending:
            return
        px = None
        if pending[0]["px"] is not None:
            px = torch.cat([p["px"] for p in pending])
        preds = generate_batch_fn(
            params, cfg, tokenizer, [p["ids"] for p in pending], px)
        for p, pred in zip(pending, preds):
            acc = grade(pred, p["ex"].answers)
            state["total"] += acc
            results.append({"id": p["ex"].example_id, "prediction": pred,
                            "accuracy": acc})
        pending.clear()

    state = {"total": 0.0}
    for ex in examples:
        assert ex.answers, f"open-ended example {ex.example_id} has no answers"
        prompt = _build_prompt(ex.question, prompt_builder_factory)
        prompt_ids = list(tokenizer.encode(prompt))
        px = _pixels_for(cfg, image_cfg, ex.image, device)
        if pending and ((pending[0]["px"] is None) != (px is None)):
            flush()   # modality change: text-only and vision rows never mix
        pending.append({"ex": ex, "ids": prompt_ids, "px": px})
        if len(pending) >= examples_per_batch:
            flush()
    flush()
    total = state["total"]
    n = max(len(results), 1)
    return {"task": "open_ended", "metric": metric, "accuracy": total / n,
            "n": len(results), "results": results}
