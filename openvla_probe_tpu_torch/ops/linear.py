"""Linear layers of the port (counterpart of ``openvla_probe_tpu/ops/linear.py``).

Only float weights so far: ``matmul_t(x, w) = x @ w.T`` with ``w`` in the JAX
package's ``[O, K]`` layout. The JAX package leaves this product to XLA
outside any Pallas kernel, and the port leaves it to ``torch.matmul`` (bf16
products with fp32 accumulation, fp32 in full fp32: see the package's
numerics flags).
"""

from __future__ import annotations

from typing import Any

import torch


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def matmul_t(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x [..., K] @ w[O, K].T -> [..., O] for a float weight tensor."""
    if isinstance(w, torch.Tensor):
        return torch.matmul(x, w.t())
    if is_quantized(w) or (isinstance(w, dict) and "hi" in w):
        raise NotImplementedError(
            "quantized weight leaves (int8 / int4 / mix / nibble) are not ported yet: "
            "ROADMAP Queue 1 items 6, 7 and 10")
    if isinstance(w, dict) and "base" in w:
        raise NotImplementedError(
            "LoRA / multi-LoRA weight wrappers are not ported yet: "
            "ROADMAP Queue 1 items 11 and 13")
    raise TypeError(f"matmul_t: unsupported weight {type(w)}")
