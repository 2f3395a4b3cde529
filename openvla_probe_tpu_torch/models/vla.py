"""OpenVLA serving path: preprocess -> prefill -> greedy decode -> action
(counterpart of ``openvla_probe_tpu/models/vla.py``).

    pixels -> dual ViT -> projector -> [BOS | patches | prompt] prefill into a
    stacked KV cache -> greedy decode of `action_dim` tokens -> 256-bin
    de-tokenize -> q01/q99 un-normalize

Prompts are right-padded to `prompt_pad_len`. Decoded tokens are written at
cache slots after the pad region (slot0 + t) with their true RoPE positions
(mm_len + t), and pad slots are masked out of attention, so results do not
depend on the pad length. Argmax runs over the full LLM vocab at every step.

Four serving tiers are ported (`VLAServingConfig.for_tier`):

* ``parity``: bf16 weights, fp32 scores and RoPE, the stacked-cache decode;
* ``pallas``: `VLMConfig.turbo` numerics, the frozen-KV split decode, over
  quantized weights (``ops.linear.quantize_params`` with
  ``TURBO_QUANT_SUFFIXES``): per-channel int8 (bits=8) or grouped int4
  (bits=4, int8 where an in-dim has no group);
* ``pallas_kv8``: turbo numerics and int8 weights, the prefill's K/V
  quantized into an int8 stacked cache that every decode step attends
  through the fused-dequant kernel;
* ``turbo``: turbo numerics, the stacked-cache decode (bf16 scores), every
  int8 linear on the w8a8 route (`turbo_routes`) and the fused RMSNorm ->
  int8 kernel on (``fused_rmsq=False`` turns it off: the JAX tier as it runs
  with ``OVLA_PALLAS_RMSQ`` unset, its default); over int8 weights (bits=8)
  or nibble weights (bits="nibble": the Llama trunk and lm_head as two 4-bit
  planes, the towers int8), the JAX package's bench default.

The weight leaves and the config pick the kernels: on the ``pallas*`` tiers
int8 linears take ``wi8_matmul``, grouped-int4 linears ``w4a8_matmul`` (or the
requant route), int8 tower blocks the fused w8a8 kernels; on ``turbo`` every
int8 linear takes ``w8a8_matmul`` (after ``rms_norm_quant`` where a norm's
consumers all do), nibble linears ``w8a8_matmul`` at prefill and
``nib_hi_dot`` at decode M. The frozen-KV decode takes the split-attention
kernel, the int8-cache decode ``stacked_decode_attention_i8``, the stacked
decode ``decode_attention``.

Other tiers and options raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..device import DeviceLike, resolve_device
from ..ops.image import ImageTransformConfig, apply_image_transform
from ..ops.linear import matmul_t
from ..vla.action_tokenizer import ActionCodec
from . import llama, vlm

Params = Dict[str, Any]

EMPTY_TOKEN_ID = 29871  # Llama sentencepiece "▁"; the reference's forced prompt suffix


_PORTED_TIERS = {
    # (tier, decode_impl, split_prefill, flat_cache, kv_int8)
    ("parity", "stacked", False, False, False),
    ("pallas", "frozen_kv", False, False, False),
    ("pallas_kv8", "stacked_kv8", False, False, False),
    ("turbo", "stacked", False, False, False),
}


def turbo_routes(vlm_cfg: vlm.VLMConfig, fused_rmsq: bool = True) -> vlm.VLMConfig:
    """The `turbo` tier's kernel routes: every int8 linear on w8a8 (trunk and
    towers, the towers unfused) and the fused RMSNorm -> int8 kernel on (the
    JAX package's OVLA_PALLAS_MATMUL=0, _VITLIN=0, _VITMLP=0, _RMSQ=1), or off
    with `fused_rmsq` False (_RMSQ unset, the JAX package's default)."""
    return dataclasses.replace(
        vlm_cfg,
        llm=dataclasses.replace(vlm_cfg.llm, int8_matmul="w8a8", fused_rmsq=fused_rmsq),
        vision=tuple(dataclasses.replace(v, int8_matmul="w8a8") for v in vlm_cfg.vision))


@dataclasses.dataclass(frozen=True)
class VLAServingConfig:
    """Serving configuration. Ported: tier="parity" and tier="turbo" with the
    stacked-cache decode, tier="pallas" with the frozen-KV decode and
    tier="pallas_kv8" with the int8 stacked-cache decode (no split prefill, no
    flat cache, no int8 frozen KV); every other value raises. Build with
    `for_tier`."""

    vlm: vlm.VLMConfig
    action_dim: int = 7
    prompt_pad_len: int = 48
    codec_vocab_size: int = 32000  # text vocab minus the 64-row pad round-up
    tier: str = "parity"
    decode_impl: str = "stacked"
    split_prefill: bool = False
    flat_cache: bool = False
    kv_int8: bool = False

    def __post_init__(self):
        knobs = (self.tier, self.decode_impl, self.split_prefill, self.flat_cache, self.kv_int8)
        if knobs not in _PORTED_TIERS:
            raise NotImplementedError(
                f"(tier, decode_impl, split_prefill, flat_cache, kv_int8) = {knobs}: only "
                "tier='parity' and tier='turbo' with decode_impl='stacked', tier='pallas' "
                "with decode_impl='frozen_kv' and tier='pallas_kv8' with decode_impl="
                "'stacked_kv8' are ported; turbo_kv8 is ROADMAP Queue 1 item 10")

    @classmethod
    def for_tier(cls, vlm_cfg: vlm.VLMConfig, tier: str = "parity", fused_rmsq: bool = True,
                 **kw) -> "VLAServingConfig":
        """One constructor per ported serving tier (the JAX package's `for_tier`).
        `fused_rmsq` (turbo only): the fused RMSNorm -> int8 kernel, on by
        default; False gives the JAX turbo tier with OVLA_PALLAS_RMSQ unset."""
        if not fused_rmsq and tier != "turbo":
            raise ValueError(f"fused_rmsq=False is an option of the turbo tier, not {tier!r}")
        if tier == "parity":
            return cls(vlm=vlm_cfg, tier=tier, **kw)
        if tier == "pallas":
            return cls(vlm=vlm_cfg.turbo(), tier=tier, decode_impl="frozen_kv", **kw)
        if tier == "pallas_kv8":
            return cls(vlm=vlm_cfg.turbo(), tier=tier, decode_impl="stacked_kv8", **kw)
        if tier == "turbo":
            return cls(vlm=turbo_routes(vlm_cfg.turbo(), fused_rmsq), tier=tier, **kw)
        raise NotImplementedError(f"serving tier {tier!r} is not ported (ROADMAP Queue 1)")

    @property
    def prefill_len(self) -> int:
        return 1 + self.vlm.num_patches + self.prompt_pad_len - 1  # BOS + patches + prompt[1:]

    @property
    def cache_len(self) -> int:
        return self.prefill_len + self.action_dim


@torch.no_grad()
def predict_action_core(
    params: Params,
    cfg: VLAServingConfig,
    pixel_values,                 # [B, 3K, S, S] preprocessed
    input_ids,                    # [B, P] right-padded, starts with BOS, ends (at prompt_len-1) with 29871
    prompt_len,                   # [B] true prompt lengths (incl. BOS and 29871)
    q01,                          # [B, A] or [A]
    q99,
    action_mask,                  # [B, A] or [A] bool; False dims pass through
    return_first_logits: bool = False,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    c = cfg.vlm
    pixel_values = torch.as_tensor(pixel_values, device=dev)
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    prompt_len = torch.as_tensor(prompt_len, device=dev).long()
    B, P = input_ids.shape
    N = c.num_patches
    A = cfg.action_dim
    codec = ActionCodec(vocab_size=cfg.codec_vocab_size)

    # --- multimodal prefill --------------------------------------------------------
    prompt_mask = (torch.arange(P, device=dev)[None, :] < prompt_len[:, None]).int()
    mm = vlm.build_multimodal_inputs(params, c, input_ids, prompt_mask, pixel_values)
    embeds, mm_mask = mm["inputs_embeds"], mm["attn_mask"]
    T = embeds.shape[1]
    mm_len = 1 + N + (prompt_len - 1)                                  # [B] true length
    positions = torch.arange(T, device=dev).expand(B, T)

    frozen_kv = cfg.decode_impl == "frozen_kv"
    stacked8 = cfg.decode_impl == "stacked_kv8"
    if frozen_kv:
        # prefill writes each layer's K/V into the frozen [L, B, T, Hkv, Dh] pair
        out = llama.prefill(params["llm"], c.llm, embeds, mm_mask, positions)
    elif stacked8:
        # prefill K/V (Tk = T), then quantized layer by layer into the int8
        # stacked cache; S int8-tile aligned (32) as in the JAX package
        out = llama.prefill(params["llm"], c.llm, embeds, mm_mask, positions)
        S = -(-cfg.cache_len // 32) * 32
        cache = llama.quantize_prefill_to_stacked(out.pop("kv"), S)
    else:
        S = cfg.cache_len
        cache = llama.KVCache.zeros(c.llm, B, S, dtype=c.llm.dtype, device=dev)
        attn_mask_S = torch.nn.functional.pad(mm_mask, (0, S - T))
        out = llama.forward(
            params["llm"], c.llm, embeds, attn_mask_S, positions,
            cache=cache, cache_index=0, compute_logits=False,
            static_zero_offset=True,   # prefill: the flash kernel may engage
        )

    # hidden state at the last REAL token -> lm_head -> first generated token
    last_hidden = out["last_hidden_state"][torch.arange(B, device=dev), mm_len - 1]
    last_logits = matmul_t(last_hidden, params["llm"]["lm_head"], c.llm.int8_matmul).float()
    first_tok = last_logits.argmax(-1)
    margins = [llama.top2_margin(last_logits, first_tok)]

    # --- greedy decode of the remaining A-1 tokens ---------------------------------
    if frozen_kv:
        toks, step_margins = llama.greedy_decode(params["llm"], c.llm, out["kv"], mm_mask,
                                                 first_tok, mm_len, A - 1)
        action_tokens = torch.cat([first_tok[:, None], toks], dim=1).int()   # [B, A]
        margins.extend(step_margins.unbind(1))
    else:
        slot0 = T
        slots = torch.arange(S, device=dev)[None, :]
        toks = [first_tok]
        tok = first_tok
        for t in range(A - 1):
            e = llama.embed_tokens(params["llm"], tok[:, None])        # [B, 1, D]
            pos = (mm_len + t)[:, None]                                 # true RoPE position
            valid = (slots < mm_len[:, None]) | ((slots >= slot0) & (slots <= slot0 + t))
            if stacked8:
                hidden = llama.decode_step_stacked_i8(params["llm"], c.llm, e, pos, cache,
                                                      valid.int(), slot0 + t)
                lg = matmul_t(hidden, params["llm"]["lm_head"], c.llm.int8_matmul).float()
            else:
                step_out = llama.forward(params["llm"], c.llm, e, valid.int(), pos,
                                         cache=cache, cache_index=slot0 + t)
                lg = step_out["logits"][:, -1]
            tok = lg.argmax(-1)
            toks.append(tok)
            margins.append(llama.top2_margin(lg, tok))
        action_tokens = torch.stack(toks, dim=1).int()                 # [B, A]

    # --- de-tokenize + un-normalize --------------------------------------------------
    norm_actions = codec.decode(action_tokens)
    actions = codec.unnormalize(norm_actions, q01, q99, action_mask)
    result = {
        "actions": actions,
        "action_tokens": action_tokens,
        "normalized_actions": norm_actions,
        "logit_margins": torch.stack(margins, dim=1),   # top1 - top2 per token
    }
    if return_first_logits:
        result["first_logits"] = last_logits
    return result


@torch.no_grad()
def predict_action_from_image(
    params: Params,
    cfg: VLAServingConfig,
    image_u8,                     # [B, H, W, 3] uint8
    image_cfg: ImageTransformConfig,
    input_ids,
    prompt_len,
    q01,
    q99,
    action_mask,
    return_first_logits: bool = False,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """Raw-uint8 entry: image transform, then `predict_action_core`, on `device`."""
    dev = resolve_device(device)
    pixels = apply_image_transform(torch.as_tensor(image_u8, device=dev), image_cfg)
    return predict_action_core(
        params, cfg, pixels.to(cfg.vlm.llm.dtype), input_ids, prompt_len, q01, q99,
        action_mask, return_first_logits, device=dev,
    )
