"""Llama-2 decoder for the port (counterpart of ``openvla_probe_tpu/models/llama.py``).

Parity numerics only: bf16 weights, RMSNorm with fp32 variance (cast to the
input dtype before the weight multiply), fp32 RoPE in the HF rotate_half
convention, fp32 scores and softmax, SwiGLU with silu in fp32. Weights are
layer-stacked ``[L, ...]`` as in the JAX package; a Python loop over the
layers takes the place of its ``lax.scan``. The KV cache is the 5-D stacked
``[L, B, S, Hkv, Dh]`` pair, written in place (the JAX package writes it with
dynamic_update_slice on the scan carry).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF, attention_plain, decode_attention, flash_attention
from ..ops.linear import matmul_t

Params = Dict[str, Any]

FLASH_MIN_TQ = 64   # prefill-sized calls only take the flash kernel


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32064          # 32000 + pad_to_multiple_of=64 round-up (OpenVLA)
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale config (keeps ratios)."""
        d = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4,
                 max_position_embeddings=256, dtype=torch.float32)
        d.update(kw)
        return LlamaConfig(**d)


class KVCache(NamedTuple):
    """Per-model KV cache: [n_layers, B, S_max, n_kv_heads, head_dim] each."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def zeros(cfg: LlamaConfig, batch: int, max_len: int, dtype=None, device=None) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
        dtype = dtype or cfg.dtype
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


# --- building blocks --------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """HF-convention RMSNorm: fp32 variance + scale, cast to the input dtype
    BEFORE the weight multiply."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return xf.to(dt) * weight.to(dt)


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [..., T, head_dim] in fp32, HF rotate_half convention."""
    half = cfg.head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) * 2.0 / cfg.head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                            device=positions.device), exponent)
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k: [B, T, H, Dh]; cos/sin: [B, T, Dh] fp32 tables; rotation in fp32."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    qf, kf = q.float(), k.float()
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def attention(
    q: torch.Tensor,         # [B, Tq, H, Dh]
    k: torch.Tensor,         # [B, Tk, Hkv, Dh]
    v: torch.Tensor,         # [B, Tk, Hkv, Dh]
    mask: torch.Tensor,      # [B, 1, Tq, Tk] additive fp32 (0 / NEG_INF)
    kv_valid: Optional[torch.Tensor] = None,   # [B, Tk] key validity (1 = attend)
    offset: int = 0,         # absolute position of query 0
) -> torch.Tensor:
    """Masked softmax(q kᵀ) v with fp32 scores and softmax.

    With a key-validity row, prefill-sized calls (Tq >= 64, offset 0) take the
    flash kernel and decode calls (Tq = 1) the decode kernel, both masking
    causal + padding themselves. Other calls take the plain branch: fp32
    scores + the additive mask, fp32 softmax, probs cast to the input dtype,
    PV with fp32 accumulation (the decode kernel's function too)."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if kv_valid is not None and q.shape[1] >= FLASH_MIN_TQ and offset == 0:
        return flash_attention(q, k, v, kv_valid, offset=0)
    if kv_valid is not None and q.shape[1] == 1:
        return decode_attention(q, k, v, kv_valid, offset)
    return attention_plain(q, k, v, mask)


def make_causal_mask(attn_mask: torch.Tensor, tq: int, tk: int, offset: int = 0) -> torch.Tensor:
    """[B, Tk] padding mask (1 = attend) -> [B, 1, Tq, Tk] additive fp32 mask
    with the finite NEG_INF. `offset` = absolute position of query 0."""
    qi = torch.arange(tq, device=attn_mask.device)[:, None] + offset
    ki = torch.arange(tk, device=attn_mask.device)[None, :]
    ok = (ki <= qi)[None] & (attn_mask[:, None, :] > 0)
    zero = torch.zeros((), dtype=torch.float32, device=attn_mask.device)
    return torch.where(ok, zero, NEG_INF)[:, None]


# --- layer + model ------------------------------------------------------------------

def _layer_forward(
    cfg: LlamaConfig,
    lp: Params,               # single-layer params
    x: torch.Tensor,          # [B, T, D]
    mask: torch.Tensor,       # [B, 1, T, Tk]
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache_ref: Optional[Tuple[torch.Tensor, torch.Tensor, int, int]] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """cache_ref = (k_all [L, B, S, Hkv, Dh], v_all, layer_idx, cache_index): the
    new tokens' K/V are written into the stacked cache in place and attention
    reads the layer's whole S-slot cache."""
    B, T, D = x.shape
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    h = rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
    q = matmul_t(h, lp["q_proj"]).reshape(B, T, H, Dh)
    k = matmul_t(h, lp["k_proj"]).reshape(B, T, Hkv, Dh)
    v = matmul_t(h, lp["v_proj"]).reshape(B, T, Hkv, Dh)
    q, k = apply_rope(q, k, cos, sin)
    if cache_ref is not None:
        k_all, v_all, li, ci = cache_ref
        k_all[li, :, ci:ci + T] = k
        v_all[li, :, ci:ci + T] = v
        k, v = k_all[li], v_all[li]
    attn = attention(q, k, v, mask, kv_valid=kv_valid,
                     offset=0 if cache_ref is None else cache_ref[3]).reshape(B, T, D)
    x = x + matmul_t(attn, lp["o_proj"])
    h = rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    gate = F.silu(matmul_t(h, lp["gate_proj"]).float()).to(h.dtype)
    return x + matmul_t(gate * matmul_t(h, lp["up_proj"]), lp["down_proj"])


def forward(
    params: Params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,            # [B, T, D]
    attn_mask: torch.Tensor,                # [B, Tk] (Tk == T without cache, S_max with)
    positions: torch.Tensor,                # [B, T] absolute positions
    cache: Optional[KVCache] = None,
    cache_index: Optional[int] = None,
    compute_logits: bool = True,
    static_zero_offset: bool = False,       # caller knows cache_index == 0 (prefill)
) -> Dict[str, Any]:
    """Run the decoder stack. Returns last_hidden_state, logits [B, T, V] in
    fp32 when `compute_logits`, and the (in-place updated) cache if given."""
    B, T, D = inputs_embeds.shape
    x = inputs_embeds
    offset = 0 if cache is None else int(cache_index)
    mask = make_causal_mask(attn_mask, T, attn_mask.shape[1], offset=offset)
    cos, sin = rope_tables(cfg, positions)
    layers = params["layers"]

    def layer(li: int) -> Params:
        return {name: leaf[li] for name, leaf in layers.items()}

    out: Dict[str, Any] = {}
    if cache is not None:
        # a cached PREFILL (T > 1) at a known zero offset may take the flash
        # kernel and a decode step (T = 1) the decode kernel: causal-by-slot +
        # the padded validity row are their rule. Other calls (short prefills
        # at a nonzero offset) take the plain branch.
        kv_valid = attn_mask if ((static_zero_offset and T > 1) or T == 1) else None
        for li in range(cfg.num_hidden_layers):
            x = _layer_forward(cfg, layer(li), x, mask, cos, sin,
                               (cache.k, cache.v, li, offset), kv_valid)
        out["cache"] = cache
    else:
        kv_valid = attn_mask[:, :T]
        for li in range(cfg.num_hidden_layers):
            x = _layer_forward(cfg, layer(li), x, mask, cos, sin, None, kv_valid)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    out["last_hidden_state"] = x
    if compute_logits:
        out["logits"] = matmul_t(x, params["lm_head"]).float()
    return out


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def top2_margin(logits: torch.Tensor, argmax_idx: torch.Tensor) -> torch.Tensor:
    """top1 - top2 logit gap: the argmax robustness statistic."""
    top1 = logits.amax(dim=-1)
    cols = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    masked = logits.masked_fill(cols == argmax_idx[:, None], float("-inf"))
    return top1 - masked.amax(dim=-1)
