"""Llama-2 decoder for the port (counterpart of ``openvla_probe_tpu/models/llama.py``).

RMSNorm with fp32 variance (cast to the input dtype before the weight
multiply), RoPE in the HF rotate_half convention rotated in `rope_dtype`,
scores in `attn_scores_dtype` with an fp32 softmax, SwiGLU with silu in fp32:
fp32 RoPE and scores are the parity numerics, bf16 the turbo ones. Weights
are layer-stacked ``[L, ...]`` as in the JAX package (bf16, or quantized
leaves through ``matmul_t`` on the config's int8 route); a Python loop over
the layers takes the place of its ``lax.scan``. Where the config turns on the
fused RMSNorm -> int8 kernel and every consumer of a norm takes w8a8, the
norm hands its consumers int8 codes instead of the normed activation
(`_norm_maybe_quant`). For training, ``flash_attn=False`` sends prefill-sized
attention to the plain branch (the kernels have no backward) and ``remat``
recomputes each decoder layer in the backward pass of an uncached forward
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``). Three
cache layouts:

* the 5-D stacked ``[L, B, S, Hkv, Dh]`` pair of the stacked decode (`forward`
  with a `KVCache`), written in place (the JAX package writes it with
  dynamic_update_slice on the scan carry);
* the frozen-KV split decode (`prefill`, `decode_step`, `greedy_decode`): the
  prefill writes each layer's post-RoPE K/V in place into one preallocated
  ``[L, B, T, Hkv, Dh]`` pair (the JAX package emits them through scan ys),
  and each decode step attends [frozen prefill K/V | generated K/V] with one
  joint softmax, the generated K/V written in place into ``[L, B, A, Hkv, Dh]``;
* the int8 flat stacked cache of the `pallas_kv8` tier (`KVCacheQ`,
  `quantize_prefill_to_stacked`, `decode_step_stacked_i8`): int8
  ``[L, B, S, Hkv·Dh]`` codes with fp32 ``[L, B, S, Hkv]`` per-(slot, head)
  absmax scales, filled from the prefill K/V one layer at a time; each decode
  step quantizes its token's K/V into slot ``slot0 + t`` in place and attends
  the whole cache with the fused-dequant kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import NEG_INF, attention_plain, decode_attention, flash_attention
from ..ops.decode_attention import decode_flash_attention, stacked_decode_attention_i8
from ..ops.linear import (PrequantActivation, div127, index_layer, is_int8_per_channel,
                          matmul_t)
from ..ops.rmsnorm_quant import rms_norm, rms_norm_quant

Params = Dict[str, Any]

FLASH_MIN_TQ = 64   # prefill-sized calls only take the flash kernel
RMSQ_MIN_M = 9      # the fused RMSNorm -> int8 kernel serves norms of at least this many rows


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
    attn_scores_dtype: torch.dtype = torch.float32   # bf16 = turbo
    rope_dtype: torch.dtype = torch.float32          # bf16 = turbo (HF's own rotation dtype)
    # the JAX package's kernel gates as fields, at their defaults under its
    # OVLA_PALLAS=1: the route of per-channel int8 leaves ("wi8": the
    # weight-only kernel, OVLA_PALLAS_MATMUL=1; "w8a8": int8 activations, the
    # turbo tier) and the fused RMSNorm -> int8 kernel (OVLA_PALLAS_RMSQ)
    int8_matmul: str = "wi8"
    fused_rmsq: bool = False
    # prefill-sized calls on the flash kernels (the JAX package's
    # OVLA_PALLAS_ATTN under OVLA_PALLAS=1); off, they take attention_plain,
    # the XLA attention JAX training runs (the kernels have no backward)
    flash_attn: bool = True
    # recompute each decoder layer in backward (uncached forward under grad)
    remat: bool = False

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

def rope_tables(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [..., T, head_dim] in fp32, HF rotate_half convention."""
    half = cfg.head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) * 2.0 / cfg.head_dim
    # a fill on the card, not a copy from the host (which would wait for the card)
    inv_freq = 1.0 / torch.pow(torch.full((), cfg.rope_theta, dtype=torch.float32,
                                          device=positions.device), exponent)
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               compute_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k: [B, T, H, Dh]; cos/sin: [B, T, Dh] fp32 tables; rotation in
    `compute_dtype` (fp32 = parity; bf16 = turbo: tables and q/k cast first)."""
    cos = cos.to(compute_dtype)[:, :, None, :]
    sin = sin.to(compute_dtype)[:, :, None, :]
    qf, kf = q.to(compute_dtype), k.to(compute_dtype)
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
    scores_dtype: torch.dtype = torch.float32,
    kv_valid: Optional[torch.Tensor] = None,   # [B, Tk] key validity (1 = attend)
    offset: int = 0,         # absolute position of query 0
    flash: bool = True,      # prefill-sized calls may take the flash kernel
) -> torch.Tensor:
    """Masked softmax(q kᵀ) v with an fp32 softmax.

    With a key-validity row, prefill-sized calls (Tq >= 64, offset 0) take the
    flash kernel (fp32 scores, as the JAX package's) where `flash` is on, and
    decode calls (Tq = 1) the decode kernel, both masking causal + padding
    themselves. Other calls take the plain branch: scores in `scores_dtype` +
    the additive mask, fp32 softmax, probs cast to the input dtype, PV with
    fp32 accumulation (the decode kernel's function too, in either score
    type)."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if flash and kv_valid is not None and q.shape[1] >= FLASH_MIN_TQ and offset == 0:
        return flash_attention(q, k, v, kv_valid, offset=0)
    if kv_valid is not None and q.shape[1] == 1:
        return decode_attention(q, k, v, kv_valid, offset, scores_dtype)
    return attention_plain(q, k, v, mask, scores_dtype)


def make_causal_mask(attn_mask: torch.Tensor, tq: int, tk: int, offset: int = 0) -> torch.Tensor:
    """[B, Tk] padding mask (1 = attend) -> [B, 1, Tq, Tk] additive fp32 mask
    with the finite NEG_INF. `offset` = absolute position of query 0."""
    qi = torch.arange(tq, device=attn_mask.device)[:, None] + offset
    ki = torch.arange(tk, device=attn_mask.device)[None, :]
    ok = (ki <= qi)[None] & (attn_mask[:, None, :] > 0)
    zero = torch.zeros((), dtype=torch.float32, device=attn_mask.device)
    return torch.where(ok, zero, NEG_INF)[:, None]


# --- layer + model ------------------------------------------------------------------

Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _norm_maybe_quant(cfg: LlamaConfig, x: torch.Tensor, norm_w: torch.Tensor, leaves):
    """RMSNorm, fused with the int8 activation quantization where the config
    turns the fused kernel on, the int8 route is w8a8, the norm has more than
    8 rows and every consumer leaf is per-channel int8 (the JAX package's
    rule: never on the wi8 route, never for nibble or int4 leaves). Returns
    the normed activation or a `PrequantActivation` its consumers take."""
    M = x.shape[0] * x.shape[1]
    if (cfg.fused_rmsq and cfg.int8_matmul == "w8a8" and M >= RMSQ_MIN_M
            and all(is_int8_per_channel(w) for w in leaves)):
        return PrequantActivation(*rms_norm_quant(x, norm_w, cfg.rms_norm_eps), x.dtype)
    return rms_norm(x, norm_w, cfg.rms_norm_eps)


def _layer_forward(
    cfg: LlamaConfig,
    lp: Params,               # single-layer params
    x: torch.Tensor,          # [B, T, D]
    cos: torch.Tensor,
    sin: torch.Tensor,
    attend: Attend,           # (q [B,T,H,Dh], k, v [B,T,Hkv,Dh] post-RoPE) -> [B,T,H,Dh]
) -> torch.Tensor:
    """One decoder block. `attend` stores the new tokens' K/V where the
    caller's cache layout wants them and attends over that layer's keys."""
    B, T, D = x.shape
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    route = cfg.int8_matmul
    h = _norm_maybe_quant(cfg, x, lp["input_layernorm"], (lp["q_proj"], lp["k_proj"], lp["v_proj"]))
    q = matmul_t(h, lp["q_proj"], route).reshape(B, T, H, Dh)
    k = matmul_t(h, lp["k_proj"], route).reshape(B, T, Hkv, Dh)
    v = matmul_t(h, lp["v_proj"], route).reshape(B, T, Hkv, Dh)
    q, k = apply_rope(q, k, cos, sin, cfg.rope_dtype)
    x = x + matmul_t(attend(q, k, v).reshape(B, T, D), lp["o_proj"], route)
    h = _norm_maybe_quant(cfg, x, lp["post_attention_layernorm"], (lp["gate_proj"], lp["up_proj"]))
    gate = F.silu(matmul_t(h, lp["gate_proj"], route).float()).to(h.dtype)
    return x + matmul_t(gate * matmul_t(h, lp["up_proj"], route), lp["down_proj"], route)


def _layer(params: Params, li: int) -> Params:
    return index_layer(params["layers"], li)


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
    # cast once per call, not per layer (apply_rope's own cast is then a no-op)
    cos, sin = (t.to(cfg.rope_dtype) for t in rope_tables(cfg, positions))
    # a cached PREFILL (T > 1) at a known zero offset may take the flash kernel
    # and a decode step (T = 1) the decode kernel: causal-by-slot + the padded
    # validity row are their rule. Other cached calls (short prefills at a
    # nonzero offset) take the plain branch.
    if cache is None:
        kv_valid = attn_mask[:, :T]
    else:
        kv_valid = attn_mask if ((static_zero_offset and T > 1) or T == 1) else None

    def attend_layer(li: int) -> Attend:
        def attend(q, k, v):
            if cache is not None:
                cache.k[li, :, offset:offset + T] = k
                cache.v[li, :, offset:offset + T] = v
                k, v = cache.k[li], cache.v[li]
            return attention(q, k, v, mask, cfg.attn_scores_dtype, kv_valid, offset,
                             cfg.flash_attn)
        return attend

    def layer(li: int, x: torch.Tensor) -> torch.Tensor:
        return _layer_forward(cfg, _layer(params, li), x, cos, sin, attend_layer(li))

    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for li in range(cfg.num_hidden_layers):
        x = checkpoint(layer, li, x, use_reentrant=False) if remat else layer(li, x)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    out: Dict[str, Any] = {"last_hidden_state": x}
    if cache is not None:
        out["cache"] = cache
    if compute_logits:
        out["logits"] = matmul_t(x, params["lm_head"], cfg.int8_matmul).float()
    return out


# --- frozen-KV split decode (the `pallas` serving tier) ----------------------------


class PrefillKV(NamedTuple):
    """Frozen prefill K/V, [n_layers, B, T, n_kv_heads, head_dim] each."""

    k: torch.Tensor
    v: torch.Tensor


def prefill(
    params: Params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,          # [B, T, D]
    attn_mask: torch.Tensor,              # [B, T] (1 = real token)
    positions: torch.Tensor,              # [B, T]
) -> Dict[str, Any]:
    """Self-attention prefill that also returns every layer's post-RoPE K/V
    for the split decode: the same math as `forward` without a cache, each
    layer's K/V written in place into one preallocated [L, B, T, Hkv, Dh] pair."""
    B, T, _ = inputs_embeds.shape
    shape = (cfg.num_hidden_layers, B, T, cfg.num_key_value_heads, cfg.head_dim)
    kv = PrefillKV(torch.empty(shape, dtype=inputs_embeds.dtype, device=inputs_embeds.device),
                   torch.empty(shape, dtype=inputs_embeds.dtype, device=inputs_embeds.device))
    out = forward(params, cfg, inputs_embeds, attn_mask, positions, cache=KVCache(kv.k, kv.v),
                  cache_index=0, compute_logits=False, static_zero_offset=True)
    return {"last_hidden_state": out["last_hidden_state"], "kv": kv}


def _split_attention(q, kp, vp, kd, vd, pre_valid, dec_valid) -> torch.Tensor:
    """softmax([q·Kp | q·Kd]) @ [Vp; Vd], one joint softmax over both segments
    (the decode kernel, which the JAX package runs under its kernel gate)."""
    n_rep = q.shape[2] // kp.shape[2]
    kp, vp, kd, vd = (_repeat_kv(t, n_rep) for t in (kp, vp, kd, vd))
    return decode_flash_attention(q, kp, vp, kd, vd, pre_valid, dec_valid)


def decode_step(
    params: Params,
    cfg: LlamaConfig,
    x: torch.Tensor,            # [B, 1, D] current-token embedding
    positions: torch.Tensor,    # [B, 1] absolute position of the token
    kv_pre: PrefillKV,
    pre_mask: torch.Tensor,     # [B, T] prefill validity (1 = attend)
    dec_k: torch.Tensor,        # [L, B, A, Hkv, Dh] generated-token K buffer (updated in place)
    dec_v: torch.Tensor,
    t: int,                     # decode-step index (this token's slot)
) -> torch.Tensor:
    """One greedy decode step (the JAX package's unrolled form). Returns the
    final-normed last hidden state [B, D]."""
    B, A = x.shape[0], dec_k.shape[2]
    # cast once per call, not per layer (apply_rope's own cast is then a no-op)
    cos, sin = (t.to(cfg.rope_dtype) for t in rope_tables(cfg, positions))
    dec_valid = (torch.arange(A, device=x.device) <= t).int()[None].expand(B, A).contiguous()

    def attend_layer(li: int) -> Attend:
        def attend(q, k, v):
            dec_k[li, :, t] = k[:, 0]
            dec_v[li, :, t] = v[:, 0]
            return _split_attention(q, kv_pre.k[li], kv_pre.v[li], dec_k[li], dec_v[li],
                                    pre_mask, dec_valid)
        return attend

    for li in range(cfg.num_hidden_layers):
        x = _layer_forward(cfg, _layer(params, li), x, cos, sin, attend_layer(li))
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)[:, 0]


def greedy_decode(
    params: Params,
    cfg: LlamaConfig,
    kv_pre: PrefillKV,
    pre_mask: torch.Tensor,     # [B, T] prefill validity
    first_token: torch.Tensor,  # [B] (from the prefill logits)
    start_pos: torch.Tensor,    # [B] absolute position of first_token
    n_steps: int,               # number of ADDITIONAL tokens to generate
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy-decode `n_steps` tokens after `first_token`. Returns (tokens
    [B, n_steps], top1 - top2 logit margins [B, n_steps])."""
    B = first_token.shape[0]
    dev = first_token.device
    if n_steps == 0:
        return (torch.zeros((B, 0), dtype=torch.long, device=dev),
                torch.zeros((B, 0), dtype=torch.float32, device=dev))
    shape = (cfg.num_hidden_layers, B, n_steps, cfg.num_key_value_heads, cfg.head_dim)
    dec_k = torch.zeros(shape, dtype=kv_pre.k.dtype, device=dev)
    dec_v = torch.zeros(shape, dtype=kv_pre.k.dtype, device=dev)
    toks, margins, tok = [], [], first_token
    for t in range(n_steps):
        e = embed_tokens(params, tok[:, None])
        hidden = decode_step(params, cfg, e, (start_pos + t)[:, None], kv_pre, pre_mask,
                             dec_k, dec_v, t)
        logits = matmul_t(hidden, params["lm_head"], cfg.int8_matmul).float()
        tok = logits.argmax(-1)
        toks.append(tok)
        margins.append(top2_margin(logits, tok))
    return torch.stack(toks, dim=1), torch.stack(margins, dim=1)


# --- int8 flat stacked cache (the `pallas_kv8` serving tier) ------------------------


class KVCacheQ(NamedTuple):
    """int8 stacked KV cache, flat head-minor layout: kq/vq int8
    [L, B, S, Hkv·Dh], ks/vs fp32 [L, B, S, Hkv] per-(slot, head) absmax scales,
    the JAX package's four arrays. The port keeps K and V in one buffer each
    for codes ([2, L, B, S, Hkv·Dh]) and scales ([2, L, B, S, Hkv]), so that a
    decode step quantizes and writes its token's K and V in one pass (the
    decode steps are bound by the host's launches). Generated tokens are
    quantized into the same cache (one segment, one softmax)."""

    codes: torch.Tensor
    scales: torch.Tensor

    @property
    def kq(self) -> torch.Tensor:
        return self.codes[0]

    @property
    def vq(self) -> torch.Tensor:
        return self.codes[1]

    @property
    def ks(self) -> torch.Tensor:
        return self.scales[0]

    @property
    def vs(self) -> torch.Tensor:
        return self.scales[1]


def _quant_heads(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., H, Dh] -> (int8 [..., H·Dh] flat, fp32 scales [..., H]):
    s = max(max|x|, 1e-8) / 127 (the clamp before the division), codes
    clip(round(x / s), -127, 127)."""
    xf = x.float()
    s = div127(torch.clamp(xf.abs().amax(dim=-1), min=1e-8))
    qi = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return qi.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1]), s


def quantize_prefill_to_stacked(kv: PrefillKV, s_slots: int) -> KVCacheQ:
    """Prefill K/V [L, B, T, Hkv, Dh] -> int8 stacked cache with `s_slots`
    slots, quantized one layer at a time into a preallocated pair (the JAX
    package pads the whole tensor and quantizes it at once: the same values,
    but its fp32 transient would be 4 GB per K at 7B). Slots past T hold the
    codes and scales of zeros (scale 1e-8 / 127) and stay masked."""
    L, B, T, Hkv, Dh = kv.k.shape
    dev = kv.k.device
    pad_scale = div127(torch.full((), 1e-8, dtype=torch.float32, device=dev))
    cq = KVCacheQ(torch.zeros((2, L, B, s_slots, Hkv * Dh), dtype=torch.int8, device=dev),
                  pad_scale.expand(2, L, B, s_slots, Hkv).clone())
    for li in range(L):
        for i, x in enumerate((kv.k[li], kv.v[li])):
            cq.codes[i, li, :, :T], cq.scales[i, li, :, :T] = _quant_heads(x)
    return cq


def decode_step_stacked_i8(
    params: Params,
    cfg: LlamaConfig,
    x: torch.Tensor,            # [B, 1, D] current-token embedding
    positions: torch.Tensor,    # [B, 1] absolute position of the token
    cq: KVCacheQ,               # updated in place
    valid: torch.Tensor,        # [B, S] slot validity for this step (self included)
    slot: int,                  # cache slot of this token
) -> torch.Tensor:
    """One greedy decode step over the int8 stacked cache: each layer
    quantizes the new token's K/V into slot `slot` of layer `li` in place,
    then attends the whole cache through the fused-dequant kernel. Returns the
    final-normed last hidden state [B, D]."""
    # cast once per call, not per layer (apply_rope's own cast is then a no-op)
    cos, sin = (t.to(cfg.rope_dtype) for t in rope_tables(cfg, positions))

    def attend_layer(li: int) -> Attend:
        def attend(q, k, v):
            codes, scales = _quant_heads(torch.stack([k[:, 0], v[:, 0]]))   # K and V at once
            cq.codes[:, li, :, slot], cq.scales[:, li, :, slot] = codes, scales
            return stacked_decode_attention_i8(q, cq.kq, cq.ks, cq.vq, cq.vs, valid, li)
        return attend

    for li in range(cfg.num_hidden_layers):
        x = _layer_forward(cfg, _layer(params, li), x, cos, sin, attend_layer(li))
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)[:, 0]


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def top2_margin(logits: torch.Tensor, argmax_idx: torch.Tensor) -> torch.Tensor:
    """top1 - top2 logit gap: the argmax robustness statistic."""
    top1 = logits.amax(dim=-1)
    cols = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    masked = logits.masked_fill(cols == argmax_idx[:, None], float("-inf"))
    return top1 - masked.amax(dim=-1)
