from .harness import (  # noqa: F401
    EvalExample,
    evaluate_closed_set,
    evaluate_open_ended,
    exact_match,
    load_jsonl_dataset,
    normalize_answer,
    vqa_accuracy,
)
