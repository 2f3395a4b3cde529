"""Llama-2 decoder for the port (counterpart of ``openvla_probe_tpu/models/llama.py``).

RMSNorm with fp32 variance (cast to the input dtype before the weight
multiply), RoPE in the HF rotate_half convention rotated in `rope_dtype`,
scores in `attn_scores_dtype` with an fp32 softmax, SwiGLU with silu in fp32:
fp32 RoPE and scores are the parity numerics, bf16 the turbo ones. Weights
are layer-stacked ``[L, ...]`` as in the JAX package (bf16, or quantized
leaves through ``matmul_t`` on the config's int8 route); a Python loop over
the layers takes the place of its ``lax.scan``. A layer with a router (a
Mixtral trunk, ``moe_experts`` > 0) runs the sparse-MoE FFN of
``models/moe.py`` in place of the SwiGLU, in every forward and decode below;
the uncached forward returns the router losses averaged over layers
(``moe_aux``, ``moe_z``). `fuse_serving_params` fuses
q/k/v into ``qkv_proj`` and gate/up into ``gate_up_proj`` (4 products a layer
instead of 7), which every forward and decode takes where present. Where the
config turns on the fused RMSNorm -> int8 kernel and every consumer of a
norm takes w8a8, the norm hands its consumers int8 codes instead of the
normed activation (`_norm_maybe_quant`; the frozen-KV and int8-cache decode
steps keep the plain norm, as in the JAX package). For training,
``flash_attn=False`` sends prefill-sized
attention to the plain branch (the kernels have no backward) and ``remat``
recomputes each decoder layer in the backward pass of an uncached forward
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``). Three
cache layouts:

* the 5-D stacked ``[L, B, S, Hkv, Dh]`` pair of the stacked decode (`forward`
  with a `KVCache`), written in place (the JAX package writes it with
  dynamic_update_slice on the scan carry), or the flat ``[L, B, S, Hkv·Dh]``
  pair of `KVCache.zeros_flat`, read as a 5-D view of the same bytes;
* the frozen-KV split decode (`prefill`, `decode_step`, `greedy_decode`): the
  prefill writes each layer's post-RoPE K/V in place into one preallocated
  ``[L, B, T, Hkv, Dh]`` pair (the JAX package emits them through scan ys),
  and each decode step attends [frozen prefill K/V | generated K/V] with one
  joint softmax, the generated K/V written in place into ``[L, B, A, Hkv, Dh]``;
  over a `PrefillKVQ` (the ``turbo_kv8`` tier) the frozen K/V are int8 with
  per-(token, head) scales, attended by ``split_attention_i8`` without
  dequantizing, the generated buffer in the model's dtype;
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
from ..ops.decode_attention import (decode_flash_attention, split_attention_i8,
                                    stacked_decode_attention_i8)
from ..ops.linear import (NIB_HI_M_MAX, PrequantActivation, div127, is_grouped_int4,
                          is_int8_per_channel, is_mixed_quant, is_multilora_fused, matmul_t,
                          matmul_t_grouped)
from ..ops.rmsnorm_quant import rms_norm, rms_norm_quant
from ..parallel import tensor_parallel as tp
from . import moe

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
    # sparse-MoE FFN (Mixtral-style, models/moe.py): 0 = the dense SwiGLU
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0     # >= E / top_k: dropless
    moe_aux_coef: float = 0.01           # load-balance loss weight (training)
    moe_z_coef: float = 1e-3             # router z-loss weight (training)
    # "einsum" (one-hot, honours capacity drops), "sorted" (the grouped expert
    # product, dropless only) or "auto" (sorted exactly when dropless)
    moe_dispatch: str = "auto"
    # the tensor-parallel ranks the attention heads are split over (a rank's config in
    # sharded serving, vla.make_sharded_predict): its attention and its KV caches hold
    # num_attention_heads / tp_heads query and num_key_value_heads / tp_heads kv heads
    tp_heads: int = 1
    # the data-parallel ranks a batch's rows are split over (a rank's config in sharded
    # serving): the row-count route rules compare a product's rows times this, the whole
    # batch's, as the JAX package's jit sees global shapes (ops.linear.matmul_t)
    row_split: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def local_heads(self) -> int:
        return self.num_attention_heads // self.tp_heads

    @property
    def local_kv_heads(self) -> int:
        return self.num_key_value_heads // self.tp_heads

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        """Llama-2-13B dims (catalog llama2-13b-*): 40 layers x 5120, 40
        heads, ffn 13824."""
        d = dict(hidden_size=5120, intermediate_size=13824, num_hidden_layers=40,
                 num_attention_heads=40, num_key_value_heads=40)
        d.update(kw)
        return LlamaConfig(**d)

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
        shape = (cfg.num_hidden_layers, batch, max_len, cfg.local_kv_heads, cfg.head_dim)
        dtype = dtype or cfg.dtype
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))

    @staticmethod
    def zeros_flat(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                   device=None) -> "KVCache":
        """The flat [L, B, S, Hkv·Dh] layout (the JAX package's, which denies
        XLA two cache layouts); `forward` reads it as a 5-D view of the same
        bytes. `max_len` should be a multiple of 8, as the JAX package pads it."""
        shape = (cfg.num_hidden_layers, batch, max_len, cfg.local_kv_heads * cfg.head_dim)
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


def _norm_maybe_quant(cfg: LlamaConfig, x: torch.Tensor, norm_w: torch.Tensor, leaves,
                      fused: bool = True):
    """RMSNorm, fused with the int8 activation quantization where `fused`, the
    config turns the fused kernel on, the int8 route is w8a8, the norm has
    more than 8 rows and every consumer leaf takes its int8 copy through w8a8:
    a per-channel int8 leaf, or a mix leaf above M = 32, where it reads its
    int8 copy (the JAX package's rule: never on the wi8 route, never for
    nibble or int4 leaves, nor for mix leaves at decode M, which read the int4
    copy). Returns the normed activation or a `PrequantActivation` its
    consumers take."""
    M = x.shape[0] * x.shape[1] * cfg.row_split

    def w8a8_leaf(w) -> bool:
        w = tp.consumer_leaf(w)
        return is_int8_per_channel(w) or (is_mixed_quant(w) and M > NIB_HI_M_MAX)

    if (fused and cfg.fused_rmsq and cfg.int8_matmul == "w8a8" and M >= RMSQ_MIN_M
            and all(w8a8_leaf(w) for w in leaves)):
        return PrequantActivation(*rms_norm_quant(x, norm_w, cfg.rms_norm_eps), x.dtype)
    return rms_norm(x, norm_w, cfg.rms_norm_eps)


def _matmul(x, w, route: str, row_split: int) -> torch.Tensor:
    """x @ w's weight: a placed leaf by its tp role (`tensor_parallel.matmul`),
    any other through ``matmul_t``; `row_split` the config's."""
    if tp.is_placed(w):
        return tp.matmul(x, w, route, row_split)
    return matmul_t(x, w, route, row_split)


def _products(h, leaves, route: str, row_split: int):
    """[matmul_t(h, w) for w in leaves] (q/k/v or gate/up), through
    ``matmul_t_grouped`` where the leaves are fused multi-LoRA leaves (which
    may group their second products)."""
    if all(is_multilora_fused(w) for w in leaves):
        return matmul_t_grouped(h, leaves, route)
    return [_matmul(h, w, route, row_split) for w in leaves]


def _moe_mlp(cfg: LlamaConfig, lp: Params, h: torch.Tensor,
             token_valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sparse-MoE FFN -> (y, fp32 [2] aux). `moe_dispatch` "auto" takes
    the sorted dispatch exactly when the capacity at this token count is
    dropless, the einsum dispatch otherwise; "sorted" raises where it would
    drop."""
    S = h.shape[0] * h.shape[1]
    cap = moe.capacity(cfg.moe_experts, cfg.moe_top_k, cfg.moe_capacity_factor, S)
    mode = cfg.moe_dispatch
    if mode == "auto":
        mode = "sorted" if cap >= S else "einsum"
    if mode == "sorted":
        if cap < S:
            raise ValueError(
                f"moe_dispatch='sorted' is dropless-only but capacity {cap} < {S} tokens would "
                "drop; use 'einsum' or 'auto', or raise moe_capacity_factor")
        return moe.moe_ffn_sorted(lp, h, top_k=cfg.moe_top_k, token_valid=token_valid)
    return moe.moe_ffn(lp, h, top_k=cfg.moe_top_k, capacity=cap, token_valid=token_valid)


def _layer_forward(
    cfg: LlamaConfig,
    lp: Params,               # single-layer params
    x: torch.Tensor,          # [B, T, D]
    cos: torch.Tensor,
    sin: torch.Tensor,
    attend: Attend,           # (q [B,T,H,Dh], k, v [B,T,Hkv,Dh] post-RoPE) -> [B,T,H,Dh]
    fused_norm: bool = True,  # the fused RMSNorm -> int8 kernel may serve the norms
    token_valid: Optional[torch.Tensor] = None,   # [B, T] the MoE router's pad mask
    moe_aux: Optional[list] = None,               # a MoE layer appends its fp32 [2] aux
) -> torch.Tensor:
    """One decoder block. `attend` stores the new tokens' K/V where the
    caller's cache layout wants them and attends over that layer's keys. The
    fused ``qkv_proj`` / ``gate_up_proj`` leaves of `fuse_serving_params` are
    taken where present (one product, then a split); fused multi-LoRA q/k/v
    and gate/up leaves go through ``matmul_t_grouped``. A layer with a router
    runs the MoE FFN on the float RMSNorm (never the fused norm-quantize:
    the router reads the normed activation), PAD tokens (`token_valid` 0)
    kept out of routing."""
    B, T, D = x.shape
    H, Hkv, Dh = cfg.local_heads, cfg.local_kv_heads, cfg.head_dim
    route, rs = cfg.int8_matmul, cfg.row_split
    qkv_leaves = ((lp["qkv_proj"],) if "qkv_proj" in lp
                  else (lp["q_proj"], lp["k_proj"], lp["v_proj"]))
    h = _norm_maybe_quant(cfg, x, lp["input_layernorm"], qkv_leaves, fused_norm)
    if "qkv_proj" in lp:
        q, k, v = torch.split(_matmul(h, lp["qkv_proj"], route, rs),
                              [H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    else:
        q, k, v = _products(h, qkv_leaves, route, rs)
    if cfg.tp_heads > 1:   # a product tp leaves whole: its output cut to this rank's heads
        q, k, v = (tp.rank_cols(t, n * Dh, qkv_leaves[0]) for t, n in ((q, H), (k, Hkv), (v, Hkv)))
    q, k = apply_rope(q.reshape(B, T, H, Dh), k.reshape(B, T, Hkv, Dh), cos, sin, cfg.rope_dtype)
    a = attend(q, k, v.reshape(B, T, Hkv, Dh)).reshape(B, T, H * Dh)
    x = x + _matmul(tp.input_for(a, lp["o_proj"], qkv_leaves[0]), lp["o_proj"], route, rs)
    if "router" in lp:
        y, aux = _moe_mlp(cfg, lp, rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps),
                          token_valid)
        if moe_aux is not None:
            moe_aux.append(aux)
        return x + y
    mlp_leaves = ((lp["gate_up_proj"],) if "gate_up_proj" in lp
                  else (lp["gate_proj"], lp["up_proj"]))
    h = _norm_maybe_quant(cfg, x, lp["post_attention_layernorm"], mlp_leaves, fused_norm)
    if "gate_up_proj" in lp:
        g, up = torch.chunk(_matmul(h, lp["gate_up_proj"], route, rs), 2, dim=-1)
        gate = F.silu(g.float()).to(h.dtype)
    else:
        g, up = _products(h, mlp_leaves, route, rs)
        gate = F.silu(g.float()).to(h.dtype)
    return x + _matmul(tp.input_for(gate * up, lp["down_proj"], mlp_leaves[0]), lp["down_proj"],
                       route, rs)


def _layer(params: Params, li: int) -> Params:
    return tp.index_layer(params["layers"], li)


def forward(
    params: Params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,            # [B, T, D]
    attn_mask: torch.Tensor,                # [B, Tk] (Tk == T without cache, S_max with)
    positions: torch.Tensor,                # [B, T] absolute positions
    cache: Optional[KVCache] = None,
    cache_index: Optional[int] = None,
    collect_hidden_states: bool = False,
    pool_mask: Optional[torch.Tensor] = None,   # [B, T] override for the tap pooling
    compute_logits: bool = True,
    static_zero_offset: bool = False,       # caller knows cache_index == 0 (prefill)
) -> Dict[str, Any]:
    """Run the decoder stack. Returns last_hidden_state, logits [B, T, V] in
    fp32 when `compute_logits`, the (in-place updated) cache if given, and with
    `collect_hidden_states` the probe tap: hidden_pooled [B, L+1, D] fp32, the
    masked mean over T of the embeddings, of layers 1..L-1's outputs and of the
    final-normed last layer (HF's output_hidden_states convention). The
    pooling weights are `pool_mask`, else attn_mask[:, :T] without a cache and
    ones with one."""
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
    kv5 = cache
    if cache is not None and cache.k.dim() == 4:   # the flat layout: a 5-D view, same bytes
        kv5 = KVCache(*(t.view(*t.shape[:3], cfg.local_kv_heads, cfg.head_dim)
                        for t in cache))

    def attend_layer(li: int) -> Attend:
        def attend(q, k, v):
            if kv5 is not None:
                kv5.k[li, :, offset:offset + T] = k
                kv5.v[li, :, offset:offset + T] = v
                k, v = kv5.k[li], kv5.v[li]
            return attention(q, k, v, mask, cfg.attn_scores_dtype, kv_valid, offset,
                             cfg.flash_attn)
        return attend

    # the router's pad mask: this call's tokens' validity, None at a decode step
    # (a decoded token is real) and at a cached call without a known zero offset
    token_valid = None if (kv_valid is None or (cache is not None and T == 1)) else kv_valid[:, :T]
    moe_aux = [] if (cfg.moe_experts and cache is None) else None

    def layer(li: int, x: torch.Tensor) -> torch.Tensor:
        return _layer_forward(cfg, _layer(params, li), x, cos, sin, attend_layer(li),
                              token_valid=token_valid, moe_aux=moe_aux)

    pool = None
    if collect_hidden_states:
        if pool_mask is not None:
            pool_w = pool_mask.float()
        elif cache is None:
            pool_w = attn_mask[:, :T].float()
        else:
            pool_w = torch.ones((B, T), dtype=torch.float32, device=x.device)
        denom = torch.clamp(pool_w.sum(-1, keepdim=True), min=1.0)

        def pool(h: torch.Tensor) -> torch.Tensor:
            return (h.float() * pool_w[..., None]).sum(1) / denom

        pooled = [pool(inputs_embeds)]

    L = cfg.num_hidden_layers
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for li in range(L):
        x = checkpoint(layer, li, x, use_reentrant=False) if remat else layer(li, x)
        if pool is not None and li < L - 1:
            pooled.append(pool(x))
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    out: Dict[str, Any] = {"last_hidden_state": x}
    if moe_aux:
        # the router losses averaged over layers (uncached forwards, as the JAX package's)
        aux = torch.stack(moe_aux).mean(0)
        out["moe_aux"], out["moe_z"] = aux[0], aux[1]
    # a remat recompute in the backward runs `layer` again: with the list gone it appends
    # nothing, and the aux above keeps its gradient through the checkpointed layers
    moe_aux = None
    if pool is not None:
        pooled.append(pool(x))
        out["hidden_pooled"] = torch.stack(pooled, dim=1)   # [B, L+1, D]
    if cache is not None:
        out["cache"] = cache
    if compute_logits:
        out["logits"] = _matmul(x, params["lm_head"], cfg.int8_matmul, cfg.row_split).float()
    return out


# --- frozen-KV split decode (the `pallas` serving tier) ----------------------------


class PrefillKV(NamedTuple):
    """Frozen prefill K/V, [n_layers, B, T, n_kv_heads, head_dim] each."""

    k: torch.Tensor
    v: torch.Tensor


class PrefillKVQ(NamedTuple):
    """int8 frozen prefill K/V (the ``turbo_kv8`` tier): codes int8
    [L, B, T, Hkv, Dh] and fp32 [L, B, T, Hkv] per-(layer, batch, token, head)
    absmax scales. The decode attends it without dequantizing (int8 q·K and
    scale-folded int8 p·V, `split_attention_i8`): the int8 bytes are the only
    prefill K/V the decode steps read."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor


def _quant_rows_heads(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., H, Dh] -> (int8 codes [..., H, Dh], fp32 scales [..., H]):
    s = max(max|x|, 1e-8) / 127 (the clamp before the division), codes
    clip(round(x / s), -127, 127)."""
    xf = x.float()
    s = div127(torch.clamp(xf.abs().amax(dim=-1), min=1e-8))
    return torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8), s


def quantize_prefill_kv(kv: PrefillKV) -> PrefillKVQ:
    """Frozen prefill K/V -> int8 codes and scales (the JAX package's
    ``quantize_prefill_kv``, the same values), one layer at a time into
    preallocated tensors (the fp32 transient of the whole stack would be
    twice the bf16 K/V)."""
    L, B, T, Hkv, Dh = kv.k.shape
    dev = kv.k.device
    codes = torch.empty((2, L, B, T, Hkv, Dh), dtype=torch.int8, device=dev)
    scales = torch.empty((2, L, B, T, Hkv), dtype=torch.float32, device=dev)
    for li in range(L):
        for i, x in enumerate((kv.k[li], kv.v[li])):
            codes[i, li], scales[i, li] = _quant_rows_heads(x)
    return PrefillKVQ(codes[0], codes[1], scales[0], scales[1])


def prefill(
    params: Params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,          # [B, T, D]
    attn_mask: torch.Tensor,              # [B, T] (1 = real token)
    positions: torch.Tensor,              # [B, T]
    collect_hidden_states: bool = False,
    pool_mask: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """Self-attention prefill that also returns every layer's post-RoPE K/V
    for the split decode: the same math as `forward` without a cache, each
    layer's K/V written in place into one preallocated [L, B, T, Hkv, Dh] pair.
    With `collect_hidden_states`, also the probe tap hidden_pooled [B, L+1, D],
    pooled over `pool_mask`, else over attn_mask."""
    B, T, _ = inputs_embeds.shape
    shape = (cfg.num_hidden_layers, B, T, cfg.local_kv_heads, cfg.head_dim)
    kv = PrefillKV(torch.empty(shape, dtype=inputs_embeds.dtype, device=inputs_embeds.device),
                   torch.empty(shape, dtype=inputs_embeds.dtype, device=inputs_embeds.device))
    out = forward(params, cfg, inputs_embeds, attn_mask, positions, cache=KVCache(kv.k, kv.v),
                  cache_index=0, collect_hidden_states=collect_hidden_states,
                  pool_mask=attn_mask if pool_mask is None else pool_mask,
                  compute_logits=False, static_zero_offset=True)
    res = {"last_hidden_state": out["last_hidden_state"], "kv": kv}
    if collect_hidden_states:
        res["hidden_pooled"] = out["hidden_pooled"]
    return res


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
    kv_pre,                     # PrefillKV, or PrefillKVQ (int8)
    pre_mask: torch.Tensor,     # [B, T] prefill validity (1 = attend)
    dec_k: torch.Tensor,        # [L, B, A, Hkv, Dh] generated-token K buffer (updated in place)
    dec_v: torch.Tensor,
    t: int,                     # decode-step index (this token's slot)
) -> torch.Tensor:
    """One greedy decode step (the JAX package's unrolled form), the norms
    plain as there. Over a `PrefillKVQ` each layer attends through
    `split_attention_i8`, else through the split decode kernel. Returns the
    final-normed last hidden state [B, D]."""
    B, A = x.shape[0], dec_k.shape[2]
    # cast once per call, not per layer (apply_rope's own cast is then a no-op)
    cos, sin = (t.to(cfg.rope_dtype) for t in rope_tables(cfg, positions))
    dec_valid = (torch.arange(A, device=x.device) <= t).int()[None].expand(B, A).contiguous()

    quantized = isinstance(kv_pre, PrefillKVQ)

    def attend_layer(li: int) -> Attend:
        def attend(q, k, v):
            dec_k[li, :, t] = k[:, 0]
            dec_v[li, :, t] = v[:, 0]
            if quantized:
                return split_attention_i8(q, kv_pre.k[li], kv_pre.ks[li], kv_pre.v[li],
                                          kv_pre.vs[li], dec_k[li], dec_v[li], pre_mask,
                                          dec_valid, cfg.attn_scores_dtype)
            return _split_attention(q, kv_pre.k[li], kv_pre.v[li], dec_k[li], dec_v[li],
                                    pre_mask, dec_valid)
        return attend

    for li in range(cfg.num_hidden_layers):
        x = _layer_forward(cfg, _layer(params, li), x, cos, sin, attend_layer(li),
                           fused_norm=False)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)[:, 0]


def greedy_decode(
    params: Params,
    cfg: LlamaConfig,
    kv_pre,                     # PrefillKV, or PrefillKVQ (int8)
    pre_mask: torch.Tensor,     # [B, T] prefill validity
    first_token: torch.Tensor,  # [B] (from the prefill logits)
    start_pos: torch.Tensor,    # [B] absolute position of first_token
    n_steps: int,               # number of ADDITIONAL tokens to generate
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy-decode `n_steps` tokens after `first_token`. Returns (tokens
    [B, n_steps], top1 - top2 logit margins [B, n_steps]). The generated-token
    buffer is in the prefill K/V's dtype, the model's over an int8
    `PrefillKVQ`."""
    B = first_token.shape[0]
    dev = first_token.device
    if n_steps == 0:
        return (torch.zeros((B, 0), dtype=torch.long, device=dev),
                torch.zeros((B, 0), dtype=torch.float32, device=dev))
    shape = (cfg.num_hidden_layers, B, n_steps, cfg.local_kv_heads, cfg.head_dim)
    dec_dtype = cfg.dtype if isinstance(kv_pre, PrefillKVQ) else kv_pre.k.dtype
    dec_k = torch.zeros(shape, dtype=dec_dtype, device=dev)
    dec_v = torch.zeros(shape, dtype=dec_dtype, device=dev)
    toks, margins, tok = [], [], first_token
    for t in range(n_steps):
        e = embed_tokens(params, tok[:, None])
        hidden = decode_step(params, cfg, e, (start_pos + t)[:, None], kv_pre, pre_mask,
                             dec_k, dec_v, t)
        logits = _matmul(hidden, params["lm_head"], cfg.int8_matmul, cfg.row_split).float()
        tok, margin = tp.greedy(logits, params["lm_head"])
        toks.append(tok)
        margins.append(margin)
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
    """[..., H, Dh] -> (int8 [..., H·Dh] flat, fp32 scales [..., H]): the
    codes of `_quant_rows_heads`, flattened."""
    qi, s = _quant_rows_heads(x)
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
    then attends the cache through the fused-dequant kernel, which reads the
    slots up to `slot` (`valid` masks every later one). Returns the
    final-normed last hidden state [B, D]."""
    # cast once per call, not per layer (apply_rope's own cast is then a no-op)
    cos, sin = (t.to(cfg.rope_dtype) for t in rope_tables(cfg, positions))

    def attend_layer(li: int) -> Attend:
        def attend(q, k, v):
            codes, scales = _quant_heads(torch.stack([k[:, 0], v[:, 0]]))   # K and V at once
            cq.codes[:, li, :, slot], cq.scales[:, li, :, slot] = codes, scales
            # the slots past this token's are masked: the kernel reads slots [0, slot]
            return stacked_decode_attention_i8(q, cq.kq, cq.ks, cq.vq, cq.vs, valid, li,
                                               n_keys=slot + 1)
        return attend

    for li in range(cfg.num_hidden_layers):
        x = _layer_forward(cfg, _layer(params, li), x, cos, sin, attend_layer(li),
                           fused_norm=False)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)[:, 0]


def fuse_serving_params(llm_params: Params) -> Params:
    """Serving-side weight fusion (the JAX package's): q/k/v -> one
    ``qkv_proj`` [L, (H + 2Hkv)·Dh, D] and gate/up -> one ``gate_up_proj``
    [L, 2F, D], so each decode layer runs 4 products instead of 7. Every leaf
    form concatenates each of its tensors along its own output-channel axis
    (the groups cover the shared in-dim, so they are untouched): bf16 [L, O, K],
    per-channel int8 {q [L, O, K], s [L, O]}, packed grouped int4 {q [L, G, O,
    gsz/2], s [L, O, G]}, nibble planes {hi, lo [L, O, K/2], s [L, O]} and mix
    {q, s, q4, s4}: axis -2, except the per-channel scales "s" (-1). A column's
    result does not depend on which leaf it sits in, so the outputs are
    bit-equal to the unfused ones. The gate/up fusion stands down where a
    layer has a router. Returns a new tree without the unfused leaves, which
    a caller frees by replacing its own tree: the peak is the trunk and the
    fused leaves (about 0.6 of the trunk's bytes at 7B), never two trunks.
    Training keeps the unfused layout."""
    layers = dict(llm_params["layers"])

    def cat(names, out):
        ws = [layers.pop(n) for n in names]
        if isinstance(ws[0], dict):
            if any(set(w) != set(ws[0]) for w in ws):
                raise ValueError(f"fusing {names}: mismatched leaf layouts "
                                 f"{[sorted(w) for w in ws]}")
            per_channel_s = -2 if is_grouped_int4(ws[0]) else -1
            layers[out] = {k: torch.cat([w[k] for w in ws], dim=per_channel_s if k == "s" else -2)
                           for k in ws[0]}
        else:
            layers[out] = torch.cat(ws, dim=1)

    cat(("q_proj", "k_proj", "v_proj"), "qkv_proj")
    if "router" not in layers:
        cat(("gate_proj", "up_proj"), "gate_up_proj")
    return {**llm_params, "layers": layers}


_HF_LAYER_KEYS = {
    "self_attn.q_proj.weight": "q_proj",
    "self_attn.k_proj.weight": "k_proj",
    "self_attn.v_proj.weight": "v_proj",
    "self_attn.o_proj.weight": "o_proj",
    "mlp.gate_proj.weight": "gate_proj",
    "mlp.up_proj.weight": "up_proj",
    "mlp.down_proj.weight": "down_proj",
    "input_layernorm.weight": "input_layernorm",
    "post_attention_layernorm.weight": "post_attention_layernorm",
}


# the HF Mixtral expert weights (MixtralBlockSparseTop2MLP): w1 = gate, w3 = up, w2 = down
_HF_EXPERT_KEYS = (("w1", "gate_proj"), ("w3", "up_proj"), ("w2", "down_proj"))


def params_from_hf(state, cfg: LlamaConfig, prefix: str = "model.", device="cuda",
                   bits=None) -> Params:
    """An HF LlamaForCausalLM state (name -> tensor or numpy array, e.g. a
    lazy `safetensors_io` state) -> the layer-stacked tree on `device` in
    ``cfg.dtype``, one layer of one leaf on the host at a time
    (`safetensors_io.stack`). With ``cfg.moe_experts`` the dense MLP keys are
    the HF Mixtral layout's: ``block_sparse_moe.gate`` -> router [L, E, D] and
    ``experts.{j}.w1 / w3 / w2`` -> gate / up / down stacked [L, E, ...], one
    expert on the host at a time. With `bits` (4, 8, "mix" or "nibble"), the
    leaves `ops.linear.quantize_params(..., bits=bits)` quantizes come out
    quantized, one layer (one expert) at a time on `device`: the codes of
    quantize_params over the loaded tree, bit for bit."""
    from ..ops.linear import _DEFAULT_QUANT_SUFFIXES, leaf_bits, quantize_leaf
    from .safetensors_io import stack, to_tensor

    if bits not in (None, 4, 8, "mix", "nibble"):
        raise ValueError(f"bits must be 4, 8, 'mix' or 'nibble', got {bits!r}")

    def quant(name):
        if bits is None or name not in _DEFAULT_QUANT_SUFFIXES:
            return None
        return lambda w: quantize_leaf(w, leaf_bits(name, bits))

    def one(key, name):
        w = to_tensor(state[key]).to(device=device, dtype=cfg.dtype)
        q = quant(name)
        return w if q is None or w.dim() < 2 else q(w)

    L, E = cfg.num_hidden_layers, cfg.moe_experts
    keys = dict(_HF_LAYER_KEYS)
    if E:
        for k in ("mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight"):
            del keys[k]
        keys["block_sparse_moe.gate.weight"] = "router"
    layers = {ours: stack(lambda i, k=hf_key: state[f"{prefix}layers.{i}.{k}"],
                          L, cfg.dtype, device, quant(ours))
              for hf_key, ours in keys.items()}
    for w, ours in _HF_EXPERT_KEYS if E else ():
        # [L·E, ...] one expert at a time, then viewed as [L, E, ...]
        flat = stack(lambda i, w=w: state[f"{prefix}layers.{i // E}.block_sparse_moe."
                                          f"experts.{i % E}.{w}.weight"],
                     L * E, cfg.dtype, device, quant(ours))
        layers[ours] = ({k: v.view(L, E, *v.shape[1:]) for k, v in flat.items()}
                        if isinstance(flat, dict) else flat.view(L, E, *flat.shape[1:]))
    return {
        "embed_tokens": one(f"{prefix}embed_tokens.weight", "embed_tokens"),
        "layers": layers,
        "norm": one(f"{prefix}norm.weight", "norm"),
        "lm_head": one("lm_head.weight", "lm_head"),
    }


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """The embedding rows of `input_ids` (over vocab-sharded rows: `tp.embed`)."""
    return tp.embed(params["embed_tokens"], input_ids)


def top2_margin(logits: torch.Tensor, argmax_idx: torch.Tensor) -> torch.Tensor:
    """top1 - top2 logit gap: the argmax robustness statistic."""
    top1 = logits.amax(dim=-1)
    cols = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    masked = logits.masked_fill(cols == argmax_idx[:, None], float("-inf"))
    return top1 - masked.amax(dim=-1)
