"""Phi-2 decoder for the port (counterpart of ``openvla_probe_tpu/models/phi.py``).

Phi's block differs from Llama's: one LayerNorm (with bias) feeds the
attention and the MLP in parallel and the residual adds both; every
projection has a bias; RoPE rotates only the leading ``rotary_dim =
partial_rotary_factor · head_dim`` channels (HF rotate_half); a final
LayerNorm and a biased lm_head. Weights are layer-stacked ``[L, ...]`` as in
the JAX package, a Python loop over the layers in place of its scan. The
products are plain biased matmuls and the attention passes no key-validity
row, so it takes the plain masked attention (as the JAX package's XLA
path): this trunk launches no kernel of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .llama import KVCache, attention, make_causal_mask
from .vit import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    vocab_size: int = 51200
    hidden_size: int = 2560
    intermediate_size: int = 10240
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 0.4
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.partial_rotary_factor * self.head_dim)

    @staticmethod
    def tiny(**kw) -> "PhiConfig":
        d = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                 num_attention_heads=4, max_position_embeddings=128, dtype=torch.float32)
        d.update(kw)
        return PhiConfig(**d)


def _partial_rope(x: torch.Tensor, positions: torch.Tensor, cfg: PhiConfig) -> torch.Tensor:
    """Rotate the leading rotary_dim channels of x [B, T, H, Dh] in fp32 (HF
    rotate_half), the rest as they are."""
    rd = cfg.rotary_dim
    half = rd // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=x.device) * 2.0 / rd
    inv_freq = 1.0 / torch.pow(torch.full((), cfg.rope_theta, dtype=torch.float32,
                                          device=x.device), exponent)
    freqs = positions[..., None].float() * inv_freq                  # [B, T, half]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(emb)[:, :, None, :], torch.sin(emb)[:, :, None, :]
    rot, rest = x[..., :rd].float(), x[..., rd:]
    rotated = torch.cat([-rot[..., half:], rot[..., :half]], dim=-1)
    return torch.cat([(rot * cos + rotated * sin).to(x.dtype), rest], dim=-1)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def _linear(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(h, w.t()) + b


def _layer(cfg: PhiConfig, lp: Params, x: torch.Tensor, mask: torch.Tensor,
           positions: torch.Tensor, cache_kv=None, cache_index: int = 0) -> torch.Tensor:
    """One parallel block; with `cache_kv` (this layer's [B, S, H, Dh] pair)
    the new K/V are written in place at `cache_index` and attention runs over
    the whole cache."""
    B, T, D = x.shape
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    h = layer_norm(x, lp["ln_scale"], lp["ln_bias"], cfg.layer_norm_eps)
    q = _linear(h, lp["q_w"], lp["q_b"]).reshape(B, T, H, Dh)
    k = _linear(h, lp["k_w"], lp["k_b"]).reshape(B, T, H, Dh)
    v = _linear(h, lp["v_w"], lp["v_b"]).reshape(B, T, H, Dh)
    q, k = _partial_rope(q, positions, cfg), _partial_rope(k, positions, cfg)
    if cache_kv is not None:
        ck, cv = cache_kv
        ck[:, cache_index:cache_index + T] = k
        cv[:, cache_index:cache_index + T] = v
        k, v = ck, cv
    attn = _linear(attention(q, k, v, mask).reshape(B, T, D), lp["dense_w"], lp["dense_b"])
    ff = _linear(_gelu_tanh(_linear(h, lp["fc1_w"], lp["fc1_b"])), lp["fc2_w"], lp["fc2_b"])
    return x + attn + ff


def forward(params: Params, cfg: PhiConfig, inputs_embeds: torch.Tensor,
            attn_mask: torch.Tensor, positions: torch.Tensor, cache: Optional[KVCache] = None,
            cache_index: Optional[int] = None) -> Dict[str, Any]:
    """Run the stack: last_hidden_state (final-normed), logits [B, T, V]
    fp32 and, with a `cache` ([L, B, S, H, Dh] pair, updated in place), the
    cache. `attn_mask` is [B, Tk] (Tk = T without a cache, S with one)."""
    T = inputs_embeds.shape[1]
    offset = 0 if cache is None else int(cache_index)
    mask = make_causal_mask(attn_mask, T, attn_mask.shape[1], offset=offset)
    x = inputs_embeds
    for li in range(cfg.num_hidden_layers):
        lp = {k: v[li] for k, v in params["layers"].items()}
        kv = None if cache is None else (cache.k[li], cache.v[li])
        x = _layer(cfg, lp, x, mask, positions, kv, offset)
    x = layer_norm(x, params["final_ln_scale"], params["final_ln_bias"], cfg.layer_norm_eps)
    out: Dict[str, Any] = {"last_hidden_state": x,
                           "logits": _linear(x, params["lm_head_w"], params["lm_head_b"]).float()}
    if cache is not None:
        out["cache"] = cache
    return out


def embed_tokens(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][ids]


_HF_LAYER_KEYS = {
    "input_layernorm.weight": "ln_scale",
    "input_layernorm.bias": "ln_bias",
    "self_attn.q_proj.weight": "q_w", "self_attn.q_proj.bias": "q_b",
    "self_attn.k_proj.weight": "k_w", "self_attn.k_proj.bias": "k_b",
    "self_attn.v_proj.weight": "v_w", "self_attn.v_proj.bias": "v_b",
    "self_attn.dense.weight": "dense_w", "self_attn.dense.bias": "dense_b",
    "mlp.fc1.weight": "fc1_w", "mlp.fc1.bias": "fc1_b",
    "mlp.fc2.weight": "fc2_w", "mlp.fc2.bias": "fc2_b",
}


def params_from_hf(state, cfg: PhiConfig, prefix: str = "model.", device="cuda") -> Params:
    """An HF PhiForCausalLM state (name -> tensor or numpy array) -> the
    layer-stacked tree on `device` in ``cfg.dtype``, one layer of one leaf on
    the host at a time."""
    from .safetensors_io import stack, to_tensor

    def one(key):
        return to_tensor(state[key]).to(device=device, dtype=cfg.dtype)

    layers = {ours: stack(lambda i, k=hf: state[f"{prefix}layers.{i}.{k}"],
                          cfg.num_hidden_layers, cfg.dtype, device)
              for hf, ours in _HF_LAYER_KEYS.items()}
    return {
        "embed_tokens": one(f"{prefix}embed_tokens.weight"),
        "layers": layers,
        "final_ln_scale": one(f"{prefix}final_layernorm.weight"),
        "final_ln_bias": one(f"{prefix}final_layernorm.bias"),
        "lm_head_w": one("lm_head.weight"),
        "lm_head_b": one("lm_head.bias"),
    }
