"""Vision -> LLM projectors (counterpart of ``openvla_probe_tpu/models/projector.py``).

linear / gelu-mlp / fused-gelu-mlp, with exact (erf) GELU computed in fp32 and
cast back. The fused variant (DinoSigLIP) is vision_dim -> 4*vision_dim ->
llm_dim -> llm_dim with two GELUs.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..parallel import tensor_parallel as tp

Params = Dict[str, Any]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def _fc(x: torch.Tensor, fc: Params, prev: Any = None) -> torch.Tensor:
    """x @ w.T + b; under tp (placed leaves) x may hold the local columns of
    `prev`'s output, and the output this product's local columns."""
    w = fc["w"]
    return tp.matmul(tp.input_for(x, w, prev), w) + tp.col_slice(fc["b"], w)


def forward(params: Params, arch: str, patches: torch.Tensor) -> torch.Tensor:
    """[B, N, vision_dim] -> [B, N, llm_dim]."""
    x = _fc(patches, params["fc1"])
    if arch == "linear":
        return tp.gather_cols(x, params["fc1"]["w"])
    if arch.endswith("fused-gelu-mlp"):
        x = _fc(_gelu(x), params["fc2"], params["fc1"]["w"])
        x = _fc(_gelu(x), params["fc3"], params["fc2"]["w"])
        return tp.gather_cols(x, params["fc3"]["w"])
    if arch.endswith("gelu-mlp"):
        return tp.gather_cols(_fc(_gelu(x), params["fc2"], params["fc1"]["w"]),
                              params["fc2"]["w"])
    raise ValueError(f"Projector arch `{arch}` is not supported!")
