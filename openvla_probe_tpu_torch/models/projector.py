"""Vision -> LLM projectors (counterpart of ``openvla_probe_tpu/models/projector.py``).

linear / gelu-mlp / fused-gelu-mlp, with exact (erf) GELU computed in fp32 and
cast back. The fused variant (DinoSigLIP) is vision_dim -> 4*vision_dim ->
llm_dim -> llm_dim with two GELUs.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.linear import matmul_t

Params = Dict[str, Any]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def forward(params: Params, arch: str, patches: torch.Tensor) -> torch.Tensor:
    """[B, N, vision_dim] -> [B, N, llm_dim]."""
    x = matmul_t(patches, params["fc1"]["w"]) + params["fc1"]["b"]
    if arch == "linear":
        return x
    if arch.endswith("fused-gelu-mlp"):
        x = _gelu(x)
        x = matmul_t(x, params["fc2"]["w"]) + params["fc2"]["b"]
        x = _gelu(x)
        return matmul_t(x, params["fc3"]["w"]) + params["fc3"]["b"]
    if arch.endswith("gelu-mlp"):
        x = _gelu(x)
        return matmul_t(x, params["fc2"]["w"]) + params["fc2"]["b"]
    raise ValueError(f"Projector arch `{arch}` is not supported!")
