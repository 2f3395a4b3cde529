"""OpenVLA serving path: preprocess -> prefill -> greedy decode -> action
(counterpart of ``openvla_probe_tpu/models/vla.py``).

    pixels -> dual ViT -> projector -> [BOS | patches | prompt] prefill into a
    stacked KV cache -> greedy decode of `action_dim` tokens -> 256-bin
    de-tokenize -> q01/q99 un-normalize

Prompts are right-padded to `prompt_pad_len`. Decoded tokens are written at
cache slots after the pad region (slot0 + t) with their true RoPE positions
(mm_len + t), and pad slots are masked out of attention, so results do not
depend on the pad length. Argmax runs over the full LLM vocab at every step.

The serving tiers of the JAX package's table (`VLAServingConfig.for_tier`):

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
  with ``OVLA_PALLAS_RMSQ`` unset, its default); over int8 weights (bits=8),
  grouped int4 (bits=4), mix weights (bits="mix": the Llama trunk and lm_head
  as int8 and int4 copies, the towers int8) or nibble weights (bits="nibble":
  the trunk and lm_head as two 4-bit planes, the towers int8), the JAX
  package's bench configurations;
* ``turbo_kv8``: turbo's routes, the frozen-KV split decode over the prefill
  K/V quantized to int8 (`llama.PrefillKVQ`).

The weight leaves and the config pick the kernels: on the ``pallas*`` tiers
int8 linears take ``wi8_matmul``, grouped-int4 linears ``w4a8_matmul`` (or the
requant route), int8 tower blocks the fused w8a8 kernels; on ``turbo`` every
int8 linear takes ``w8a8_matmul`` (after ``rms_norm_quant`` where a norm's
consumers all do), nibble linears ``w8a8_matmul`` at prefill and
``nib_hi_dot`` at decode M, grouped-int4 linears the requant route at prefill
and ``w4a8_grouped`` at decode M, mix linears their int8 copy through
``w8a8_matmul`` at prefill and their int4 copy through ``w4a8_grouped`` at
decode M. The frozen-KV decode takes the split-attention kernel (over int8
K/V, ``split_attention_i8``), the int8-cache decode
``stacked_decode_attention_i8``, the stacked decode ``decode_attention``.
Weights fused by `llama.fuse_serving_params` serve every tier.

Verified speculation (`predict_action_speculative_core`, the bs = 1 robot
control loop): one verify forward over [prompt | draft] scores every draft
token, and only the rejected tail runs sequential decode steps, on every
ported tier over the bf16 stacked cache. `OpenVLA` is the stateful wrapper:
tokenized prompts, norm-stats lookup, batching and the env-drift guard.

The ``OVLA_*`` environment knobs the port reads: ``OpenVLA`` applies
``OVLA_STACKED_KV8``, ``OVLA_LEGACY_DECODE``, ``OVLA_KV_INT8``,
``OVLA_SPLIT_PREFILL`` and ``OVLA_FLAT_CACHE`` once, at construction
(`VLAServingConfig.with_env_overrides`), and carries ``OVLA_DECODE_UNROLL``
into `decode_unroll`. The JAX package's per-kernel gates (``OVLA_PALLAS``, ``OVLA_PALLAS_*``,
``OVLA_W8A8``, ``OVLA_W4A8*``, ``OVLA_VITMLP_BM``, ``OVLA_FLASH_ONESHOT``) are
config fields or fixed rules here: set when an ``OpenVLA`` is built, one
raises and names what replaces it (`KERNEL_GATE_FIELDS`).
``OVLA_PALLAS_INTERPRET`` (the TPU kernels' interpret mode) has no
counterpart and is not read. After construction every knob of
`_serving_env_snapshot` is watched: a change raises on the next call. The
multi-LoRA A/B knobs ``OVLA_MULTILORA_IMPL`` and ``OVLA_MULTILORA_GROUPED``
are arguments of `OpenVLA.set_adapters` (``impl``, ``grouped``) and raise the
same way.

Multi-LoRA serving (`OpenVLA.set_adapters`, ``models/multilora.py``): N
adapter banks over the frozen base, each request row picking its adapter
(``adapter=`` / ``adapters=``, None for the bare base), in one call of the
same entry points, speculative calls included.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.image import ImageTransformConfig, apply_image_transform
from ..ops.linear import MULTILORA_IMPLS, matmul_t
from ..parallel import tensor_parallel as tp
from ..vla.action_tokenizer import ActionCodec
from . import llama, multilora, vlm

Params = Dict[str, Any]

EMPTY_TOKEN_ID = 29871  # Llama sentencepiece "▁"; the reference's forced prompt suffix


_SNAPSHOT_KEYS = (
    "OVLA_LEGACY_DECODE", "OVLA_SPLIT_PREFILL", "OVLA_KV_INT8", "OVLA_STACKED_KV8",
    "OVLA_FLAT_CACHE", "OVLA_DECODE_UNROLL", "OVLA_PALLAS", "OVLA_W8A8", "OVLA_W4A8",
    "OVLA_W4A8_GROUP_M_MAX", "OVLA_PALLAS_W4A8", "OVLA_PALLAS_MATMUL", "OVLA_PALLAS_ATTN",
    "OVLA_PALLAS_DECODE", "OVLA_PALLAS_VITMLP", "OVLA_PALLAS_VITLIN", "OVLA_PALLAS_VITATTN",
    "OVLA_VITMLP_BM", "OVLA_PALLAS_INTERPRET", "OVLA_FLASH_ONESHOT")


def _serving_env_snapshot() -> Tuple[Tuple[str, str], ...]:
    """The values of the JAX package's 20 serving env knobs (the same keys):
    read once when an `OpenVLA` is built; every call re-reads them and raises
    on a change, so a knob flipped after construction is never a silent no-op."""
    return tuple((k, os.environ.get(k, "")) for k in _SNAPSHOT_KEYS)


# the JAX package's per-kernel gates -> what selects the same thing in the port
KERNEL_GATE_FIELDS = {
    "OVLA_PALLAS": "the serving tier: VLAServingConfig.for_tier(vlm_cfg, 'pallas' | "
                   "'pallas_kv8' | 'turbo')",
    "OVLA_PALLAS_MATMUL": "LlamaConfig.int8_matmul / ViTConfig.int8_matmul ('wi8' | 'w8a8')",
    "OVLA_PALLAS_ATTN": "LlamaConfig.flash_attn",
    "OVLA_PALLAS_DECODE": "VLAServingConfig.decode_impl",
    "OVLA_PALLAS_VITMLP": "ViTConfig.int8_matmul ('wi8' fuses the tower blocks)",
    "OVLA_PALLAS_VITLIN": "ViTConfig.int8_matmul ('wi8' fuses the tower blocks)",
    "OVLA_PALLAS_VITATTN": "ViTConfig.flash_attn",
    "OVLA_PALLAS_RMSQ": "LlamaConfig.fused_rmsq (VLAServingConfig.for_tier(..., fused_rmsq=))",
    "OVLA_PALLAS_W4A8": "the weight leaves: ops.linear.quantize_params(bits=4) on a pallas tier",
    "OVLA_W8A8": "LlamaConfig.int8_matmul = 'w8a8' (the turbo tier)",
    "OVLA_W4A8": "the weight leaves, bits=4 or 'nibble'; the nibble decode dot is the fixed "
                 "rule M <= ops.linear.NIB_HI_M_MAX",
    "OVLA_W4A8_GROUP_M_MAX": "the fixed rule M <= ops.linear.NIB_HI_M_MAX (32)",
    "OVLA_VITMLP_BM": "nothing: the fused tower kernels choose their own tiles",
    "OVLA_FLASH_ONESHOT": "the fixed rule Tk <= ops.attention.ONESHOT_MAX_TK",
    "OVLA_MULTILORA_IMPL": "OpenVLA.set_adapters(..., impl='masked' | 'einsum')",
    "OVLA_MULTILORA_GROUPED": "OpenVLA.set_adapters(..., grouped=True)",
}


def _check_kernel_gates() -> None:
    """Raise if a JAX per-kernel gate is set: the port would not read it."""
    set_gates = sorted(k for k in os.environ
                       if (k in KERNEL_GATE_FIELDS or k.startswith("OVLA_PALLAS_"))
                       and k != "OVLA_PALLAS_INTERPRET")
    if set_gates:
        raise ValueError(
            "the port does not read the JAX package's kernel-gate env knobs; unset "
            + ", ".join(f"{k} (replaced by {KERNEL_GATE_FIELDS.get(k, 'a config field')})"
                        for k in set_gates))


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
    """Serving configuration: a tier of the module docstring's list, its
    decode (`decode_impl`: "stacked" over the S-slot cache, "frozen_kv" over
    the frozen prefill K/V and a generated-token buffer, "stacked_kv8" over
    the int8 stacked cache) and its options, validated by the JAX package's
    rules (the same ValueErrors): `split_prefill` (stacked only: the prefill
    writes its K/V into the frozen pair, then one pad builds the stacked
    cache) and `flat_cache` (stacked only: the cache in the flat [L, B, S,
    Hkv·Dh] layout, S padded to a multiple of 8), both token-identical to the
    plain stacked decode; `kv_int8` (frozen_kv only: the int8 frozen prefill
    K/V; tier="turbo_kv8" requires it); the pallas_kv8 tier and
    decode_impl="stacked_kv8" imply each other. Build with `for_tier`.

    `speculative_in_parity`: the parity tier's contract is bit-equality with
    the sequential decode, which the batched verify pass cannot promise at
    hairline margins, so `OpenVLA` rejects drafts there ("reject") unless a
    measurement harness opts in ("allow"). `decode_unroll` is carried for the
    JAX package's configs and its OVLA_DECODE_UNROLL knob: under XLA it picks
    an unrolled layer loop over a scan in the frozen-KV decode; the eager port
    runs the same Python loop over the layers either way."""

    vlm: vlm.VLMConfig
    action_dim: int = 7
    prompt_pad_len: int = 48
    codec_vocab_size: int = 32000  # text vocab minus the 64-row pad round-up
    tier: str = "parity"
    decode_impl: str = "stacked"
    split_prefill: bool = False
    flat_cache: bool = False
    kv_int8: bool = False
    decode_unroll: bool = True
    speculative_in_parity: str = "reject"   # reject | allow

    def __post_init__(self):
        if self.decode_impl not in ("stacked", "frozen_kv", "stacked_kv8"):
            raise ValueError("decode_impl must be stacked|frozen_kv|"
                             f"stacked_kv8, got {self.decode_impl}")
        if self.tier not in ("parity", "turbo", "turbo_kv8", "pallas", "pallas_kv8"):
            raise ValueError(f"unknown serving tier {self.tier!r}")
        if self.kv_int8 and self.decode_impl != "frozen_kv":
            raise ValueError("kv_int8 lives on the frozen-KV decode path; "
                             "set decode_impl='frozen_kv' (this was previously "
                             "a silent env-knob no-op)")
        if self.split_prefill and self.decode_impl != "stacked":
            raise ValueError("split_prefill is a stacked-decode option")
        if self.flat_cache and (self.decode_impl != "stacked" or self.split_prefill):
            raise ValueError("flat_cache is a stacked-carry-decode option "
                             "(and excludes split_prefill's 5D pad path)")
        if self.tier == "turbo_kv8" and not self.kv_int8:
            raise ValueError("tier='turbo_kv8' without kv_int8=True would "
                             "mislabel the numerics row; use tier='turbo' or "
                             "for_tier(vlm_cfg, 'turbo_kv8')")
        if (self.tier == "pallas_kv8") != (self.decode_impl == "stacked_kv8"):
            raise ValueError("the pallas_kv8 tier and decode_impl='stacked_kv8' "
                             "imply each other (the int8 stacked cache IS the "
                             "tier's numerics row); build via "
                             "for_tier(vlm_cfg, 'pallas_kv8')")
        if self.speculative_in_parity not in ("reject", "allow"):
            raise ValueError("speculative_in_parity must be 'reject' or 'allow', "
                             f"got {self.speculative_in_parity!r}")

    @classmethod
    def for_tier(cls, vlm_cfg: vlm.VLMConfig, tier: str = "parity", fused_rmsq: bool = True,
                 **kw) -> "VLAServingConfig":
        """One constructor per serving tier (the JAX package's `for_tier`).
        `fused_rmsq` (turbo and turbo_kv8): the fused RMSNorm -> int8 kernel,
        on by default; False gives the JAX tier with OVLA_PALLAS_RMSQ unset."""
        if not fused_rmsq and tier not in ("turbo", "turbo_kv8"):
            raise ValueError(f"fused_rmsq=False is an option of the turbo tiers, not {tier!r}")
        if tier == "parity":
            return cls(vlm=vlm_cfg, tier=tier, **kw)
        if tier == "pallas":
            return cls(vlm=vlm_cfg.turbo(), tier=tier, decode_impl="frozen_kv", **kw)
        if tier == "pallas_kv8":
            return cls(vlm=vlm_cfg.turbo(), tier=tier, decode_impl="stacked_kv8", **kw)
        if tier == "turbo":
            return cls(vlm=turbo_routes(vlm_cfg.turbo(), fused_rmsq), tier=tier, **kw)
        if tier == "turbo_kv8":
            return cls(vlm=turbo_routes(vlm_cfg.turbo(), fused_rmsq), tier=tier,
                       decode_impl="frozen_kv", kv_int8=True, **kw)
        raise ValueError(f"unknown serving tier {tier!r}")

    def with_env_overrides(self) -> "VLAServingConfig":
        """Apply the legacy `OVLA_*` serving knobs once: the JAX package's
        `with_env_overrides`, the same rules and errors. OVLA_STACKED_KV8=1
        selects the pallas_kv8 tier, OVLA_KV_INT8=1 the turbo_kv8 tier,
        OVLA_LEGACY_DECODE the stacked (1) or frozen-KV (0) decode,
        OVLA_SPLIT_PREFILL and OVLA_FLAT_CACHE their options,
        OVLA_DECODE_UNROLL `decode_unroll`."""
        env = os.environ
        c = self
        legacy = env.get("OVLA_LEGACY_DECODE")
        kv8 = env.get("OVLA_KV_INT8", "0") == "1"
        split = env.get("OVLA_SPLIT_PREFILL", "0") == "1"
        stacked8 = env.get("OVLA_STACKED_KV8", "0") == "1"
        if stacked8:
            if kv8 or split or legacy is not None:
                raise ValueError(
                    "OVLA_STACKED_KV8=1 selects the pallas_kv8 tier outright; "
                    "unset OVLA_KV_INT8/OVLA_SPLIT_PREFILL/OVLA_LEGACY_DECODE")
            return dataclasses.replace(c, decode_impl="stacked_kv8", tier="pallas_kv8",
                                       kv_int8=False, split_prefill=False)
        if kv8 and legacy == "1":
            raise ValueError("OVLA_KV_INT8=1 requires the frozen-KV decode; "
                             "unset OVLA_LEGACY_DECODE")
        if kv8 and split:
            raise ValueError("OVLA_KV_INT8=1 (frozen-KV) conflicts with "
                             "OVLA_SPLIT_PREFILL=1 (stacked-path option); "
                             "unset one")
        if kv8:
            if c.tier == "parity":
                raise ValueError(
                    "OVLA_KV_INT8=1 on a parity config would mix fp32-score "
                    "parity numerics with an int8 KV cache under a turbo_kv8 "
                    "label; build for_tier(vlm_cfg, 'turbo_kv8') instead")
            c = dataclasses.replace(c, decode_impl="frozen_kv", kv_int8=True, tier="turbo_kv8")
        elif legacy is not None:
            to_stacked = legacy == "1"
            c = dataclasses.replace(
                c, decode_impl="stacked" if to_stacked else "frozen_kv",
                kv_int8=False if to_stacked else c.kv_int8,
                tier="turbo" if (to_stacked and c.tier == "turbo_kv8") else c.tier)
        if split:
            c = dataclasses.replace(c, split_prefill=True, decode_impl="stacked", kv_int8=False,
                                    tier="turbo" if c.tier == "turbo_kv8" else c.tier)
        if "OVLA_DECODE_UNROLL" in env:
            c = dataclasses.replace(c, decode_unroll=env["OVLA_DECODE_UNROLL"] == "1")
        if env.get("OVLA_FLAT_CACHE", "0") == "1":
            c = dataclasses.replace(c, flat_cache=True)
        return c

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
    collect_hidden_states: bool = False,
    return_first_logits: bool = False,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """One serving call on `device`. With `collect_hidden_states`, result
    ["hidden_pooled"] [B, L+1, D] is the prefill's probe tap pooled over
    [BOS | patches | prompt] without the trailing 29871 (the reference's
    capture runs its first forward without it); the action tokens do not
    change."""
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
    pool_mask = None
    if collect_hidden_states:
        pool_mask = (torch.arange(T, device=dev)[None, :] < (mm_len - 1)[:, None]).int()
    taps = dict(collect_hidden_states=collect_hidden_states, pool_mask=pool_mask)

    frozen_kv = cfg.decode_impl == "frozen_kv"
    stacked8 = cfg.decode_impl == "stacked_kv8"
    if frozen_kv:
        # prefill writes each layer's K/V into the frozen [L, B, T, Hkv, Dh] pair
        out = llama.prefill(params["llm"], c.llm, embeds, mm_mask, positions, **taps)
        if cfg.kv_int8:   # turbo_kv8: the frozen K/V as int8 codes and scales
            out["kv"] = llama.quantize_prefill_kv(out["kv"])
    elif stacked8:
        # prefill K/V (Tk = T), then quantized layer by layer into the int8
        # stacked cache; S int8-tile aligned (32) as in the JAX package
        out = llama.prefill(params["llm"], c.llm, embeds, mm_mask, positions, **taps)
        S = -(-cfg.cache_len // 32) * 32
        cache = llama.quantize_prefill_to_stacked(out.pop("kv"), S)
    else:
        S = cfg.cache_len
        if cfg.flat_cache:
            S = -(-S // 8) * 8   # a multiple of 8, as the JAX package pads it
        if cfg.split_prefill:
            # the frozen-KV prefill, then one pad into the stacked cache (token-identical)
            out = llama.prefill(params["llm"], c.llm, embeds, mm_mask, positions, **taps)
            cache = llama.KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, S - T))
                                    for t in out.pop("kv")))
        else:
            mk = llama.KVCache.zeros_flat if cfg.flat_cache else llama.KVCache.zeros
            cache = mk(c.llm, B, S, dtype=c.llm.dtype, device=dev)
            attn_mask_S = torch.nn.functional.pad(mm_mask, (0, S - T))
            out = llama.forward(
                params["llm"], c.llm, embeds, attn_mask_S, positions,
                cache=cache, cache_index=0, compute_logits=False,
                static_zero_offset=True,   # prefill: the flash kernel may engage
                **taps,
            )

    # hidden state at the last REAL token -> lm_head -> first generated token
    last_hidden = out["last_hidden_state"][torch.arange(B, device=dev), mm_len - 1]
    lm_head = params["llm"]["lm_head"]
    last_logits = tp.matmul(last_hidden, lm_head, c.llm.int8_matmul, c.llm.row_split).float()
    first_tok, margin = tp.greedy(last_logits, lm_head)   # over the whole vocabulary
    margins = [margin]

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
                lg = tp.matmul(hidden, lm_head, c.llm.int8_matmul, c.llm.row_split).float()
            else:
                step_out = llama.forward(params["llm"], c.llm, e, valid.int(), pos,
                                         cache=cache, cache_index=slot0 + t)
                lg = step_out["logits"][:, -1]
            tok, margin = tp.greedy(lg, lm_head)
            toks.append(tok)
            margins.append(margin)
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
        result["first_logits"] = tp.gather_cols(last_logits, lm_head)
    if collect_hidden_states:
        result["hidden_pooled"] = out["hidden_pooled"]                 # [B, L+1, D]
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
    collect_hidden_states: bool = False,
    return_first_logits: bool = False,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """Raw-uint8 entry: image transform, then `predict_action_core`, on `device`."""
    dev = resolve_device(device)
    pixels = apply_image_transform(torch.as_tensor(image_u8, device=dev), image_cfg)
    return predict_action_core(
        params, cfg, pixels.to(cfg.vlm.llm.dtype), input_ids, prompt_len, q01, q99,
        action_mask, collect_hidden_states, return_first_logits, device=dev,
    )


@torch.no_grad()
def predict_action_speculative_core(
    params: Params,
    cfg: VLAServingConfig,
    pixel_values,                 # [B, 3K, S, S] preprocessed
    input_ids,                    # [B, P]
    prompt_len,                   # [B]
    draft_tokens,                 # [B, A] proposed action tokens (e.g. the previous step's)
    q01,
    q99,
    action_mask,
    collect_hidden_states: bool = False,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """Verified speculative serving (the JAX package's
    `predict_action_speculative_core`): one forward over [prompt | draft]
    scores every draft token; the accepted prefix and one corrected token
    come out of it, and only the rejected tail runs sequential decode steps.
    A fully accepted draft runs no decode step.

    The cache holds S = T + 2A slots: prompt, draft, continuation. Greedy
    token i is the argmax after the last real prompt token (i = 0) or after
    draft token i - 1; a draft token is accepted while it equals that argmax
    (`n_accepted`, the leading run of matches), and the first mismatch is
    replaced by it. The continuation restarts batch-uniformly from
    i0 = min(min(n_accepted + 1, A)): one host read a call (the JAX package's
    `lax.while_loop` reads its bound on the device), then a Python loop of
    A - i0 decode steps, step i writing slot T + A + (i - i0) with RoPE
    position mm_len + i - 1. Every tier runs the verify and the continuation
    over the bf16 stacked cache, whatever its `decode_impl`, as in the JAX
    package. The verify's matmuls reduce in another order than the sequential
    decode's, so at hairline logit margins a position may take the other
    token (the margin framework of PARITY_r02.md).

    Returns actions, action_tokens, normalized_actions and n_accepted [B];
    with `collect_hidden_states`, also the verify pass's hidden_pooled
    [B, L+1, D], pooled over [BOS | patches | prompt] without the trailing
    29871 (the draft slots excluded)."""
    dev = resolve_device(device)
    c = cfg.vlm
    pixel_values = torch.as_tensor(pixel_values, device=dev)
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    prompt_len = torch.as_tensor(prompt_len, device=dev).long()
    draft_tokens = torch.as_tensor(draft_tokens, device=dev).long()
    B, P = input_ids.shape
    N = c.num_patches
    A = cfg.action_dim
    if tuple(draft_tokens.shape) != (B, A):
        raise ValueError(f"draft_tokens must be [{B}, {A}], got {tuple(draft_tokens.shape)}")
    codec = ActionCodec(vocab_size=cfg.codec_vocab_size)

    # --- multimodal inputs + the draft at slots [T, T + A) -----------------------------
    prompt_mask = (torch.arange(P, device=dev)[None, :] < prompt_len[:, None]).int()
    mm = vlm.build_multimodal_inputs(params, c, input_ids, prompt_mask, pixel_values)
    embeds, mm_mask = mm["inputs_embeds"], mm["attn_mask"]
    T = embeds.shape[1]
    mm_len = 1 + N + (prompt_len - 1)
    embeds_full = torch.cat([embeds, llama.embed_tokens(params["llm"], draft_tokens)], dim=1)
    positions = torch.cat([torch.arange(T, device=dev).expand(B, T),
                           mm_len[:, None] + torch.arange(A, device=dev)[None, :]], dim=1)

    S = T + 2 * A
    cont0 = T + A                                                      # continuation slot base
    cache = llama.KVCache.zeros(c.llm, B, S, dtype=c.llm.dtype, device=dev)
    verify_mask = torch.nn.functional.pad(
        torch.cat([mm_mask, torch.ones((B, A), dtype=mm_mask.dtype, device=dev)], dim=1),
        (0, S - T - A))
    pool_mask = None
    if collect_hidden_states:
        pool_mask = (torch.arange(T + A, device=dev)[None, :] < (mm_len - 1)[:, None]).int()
    out = llama.forward(
        params["llm"], c.llm, embeds_full, verify_mask, positions, cache=cache, cache_index=0,
        collect_hidden_states=collect_hidden_states, pool_mask=pool_mask, compute_logits=False,
        static_zero_offset=True,   # the verify pass is a prefill: the flash kernel may engage
    )
    hs = out["last_hidden_state"]                                      # [B, T + A, D]
    idx = torch.cat([(mm_len - 1)[:, None],
                     (T - 1 + torch.arange(1, A, device=dev))[None, :].expand(B, A - 1)], dim=1)
    sel = hs[torch.arange(B, device=dev)[:, None], idx]               # [B, A, D]
    greedy = matmul_t(sel, params["llm"]["lm_head"], c.llm.int8_matmul).float().argmax(-1)

    accept_len = torch.cumprod((draft_tokens == greedy).int(), dim=1).sum(1)   # [B]
    # accepted draft tokens equal greedy there, and so does the corrected token: the first
    # min(accept_len + 1, A) greedy entries of a row are its output
    tokens = greedy
    i0 = int(torch.clamp(accept_len + 1, max=A).min())                # the one host read

    # --- continuation: sequential decode of the rejected tail --------------------------
    slots = torch.arange(S, device=dev)[None, :]
    for i in range(i0, A):
        e = llama.embed_tokens(params["llm"], tokens[:, i - 1:i])
        pos = (mm_len + i - 1)[:, None]           # the input token's index is i - 1
        valid = ((slots < mm_len[:, None])
                 # accepted draft K/V: slots [T, T + i0 - 1); the corrected token at index
                 # i0 - 1 has no entry until the continuation writes it at cont0
                 | ((slots >= T) & (slots < T + (i0 - 1)))
                 | ((slots >= cont0) & (slots <= cont0 + (i - i0))))
        step_out = llama.forward(params["llm"], c.llm, e, valid.int(), pos, cache=cache,
                                 cache_index=cont0 + (i - i0))
        tokens[:, i] = step_out["logits"][:, -1].argmax(-1)

    action_tokens = tokens.int()
    norm_actions = codec.decode(action_tokens)
    result = {
        "actions": codec.unnormalize(norm_actions, q01, q99, action_mask),
        "action_tokens": action_tokens,
        "normalized_actions": norm_actions,
        "n_accepted": accept_len.int(),
    }
    if collect_hidden_states:
        result["hidden_pooled"] = out["hidden_pooled"]
    return result


@torch.no_grad()
def predict_action_speculative_from_image(
    params: Params,
    cfg: VLAServingConfig,
    image_u8,                     # [B, H, W, 3] uint8
    image_cfg: ImageTransformConfig,
    input_ids,
    prompt_len,
    draft_tokens,                 # [B, A]
    q01,
    q99,
    action_mask,
    collect_hidden_states: bool = False,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """Raw-uint8 entry of verified speculation: the image transform, then
    `predict_action_speculative_core`, on `device`."""
    dev = resolve_device(device)
    pixels = apply_image_transform(torch.as_tensor(image_u8, device=dev), image_cfg)
    return predict_action_speculative_core(
        params, cfg, pixels.to(cfg.vlm.llm.dtype), input_ids, prompt_len, draft_tokens, q01,
        q99, action_mask, collect_hidden_states, device=dev)


# --- sharded serving (slice 6a): one process a rank ----------------------------------


def local_llm_config(llm: llama.LlamaConfig, local_llm: Params,
                     row_split: int) -> llama.LlamaConfig:
    """A rank's trunk config over its local trunk tree: the attention on this
    rank's heads (``tp_heads``) where tp splits q_proj by heads, and the
    row-count route rules over `row_split` times a rank's rows."""
    llm = dataclasses.replace(llm, row_split=row_split)
    q = local_llm["layers"].get("q_proj")
    if q is not None and tp.tp_role(q) == "col":
        n = q["mesh"].axis_size("tp")
        if llm.num_attention_heads % n or llm.num_key_value_heads % n:
            raise ValueError(f"q_proj splits over tp={n}, which does not divide "
                             f"{llm.num_attention_heads} query / {llm.num_key_value_heads} kv "
                             "heads")
        llm = dataclasses.replace(llm, tp_heads=n)
    return llm


def local_serving_config(cfg: VLAServingConfig, local_params: Params, mesh) -> VLAServingConfig:
    """A rank's serving config over its local tree (`local_llm_config`, the
    ranks on dp splitting the rows)."""
    llm = local_llm_config(cfg.vlm.llm, local_params["llm"], mesh.axis_size("dp"))
    return dataclasses.replace(cfg, vlm=dataclasses.replace(cfg.vlm, llm=llm))


def _dp_rows(mesh, batch: int) -> slice:
    """This rank's rows of the batch over dp (the JAX package's divisibility error)."""
    dp = mesh.axis_size("dp")
    if batch % dp:
        raise ValueError(f"the batch's sharding over dp={dp} implies that the global size of its "
                         f"dimension 0 should be divisible by {dp}, but it is equal to {batch}")
    n = batch // dp
    return slice(mesh.coord("dp") * n, (mesh.coord("dp") + 1) * n)


def _batch_rows(x, rows: slice, dev):
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=dev)[rows]


def _gather_dp(out: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Every rank's rows of each output, in rank order (the whole batch)."""
    from ..parallel import distributed

    g = mesh.group("dp")
    return {k: distributed.all_gather(v, 0, g) for k, v in out.items()}


def make_sharded_predict(
    params: Params,
    cfg: VLAServingConfig,
    mesh,                                   # parallel.mesh.Mesh with tp/fsdp/dp/ep axes
    image_cfg: Optional[ImageTransformConfig] = None,
    strategy: str = "tp",
    collect_hidden_states: bool = False,
    device: DeviceLike = "cuda",
    return_first_logits: bool = False,
) -> Tuple[Any, Params]:
    """Multi-rank serving, the JAX function's signature and strategies (tp,
    fsdp, fsdp+tp; dp and ep by mesh axis): returns (call, local_params),
    where local_params is this rank's tree (`parallel.place_params`) and
    call(p, image_u8, input_ids, prompt_len, q01, q99, action_mask) serves
    one batch. Every rank of the mesh calls it for itself, with the same
    whole batch: the rank runs its dp rows (the batch must divide by dp)
    with its shards, and returns the whole batch's outputs, as the JAX call
    returns global arrays. Greedy tokens equal the one-process run's
    (`parallel.tensor_parallel` says which collective each placement takes).
    On the card unless `device` is "cpu". `return_first_logits` (the port's
    option, as on `predict_action_from_image`) adds the whole vocabulary's
    first logits, gathered over tp."""
    from ..parallel.sharding import place_params

    if vlm.is_phi(cfg.vlm):
        raise NotImplementedError("sharded serving runs the Llama trunk")
    dev = resolve_device(device)
    image_cfg = image_cfg or ImageTransformConfig.dinosiglip_224()
    local = place_params(params, mesh, strategy)
    lcfg = local_serving_config(cfg, local, mesh)

    def call(p, image_u8, input_ids, prompt_len, q01, q99, action_mask):
        rows = _dp_rows(mesh, int(np.shape(input_ids)[0]))
        out = predict_action_from_image(
            tp.resolve_tree(p), lcfg, _batch_rows(image_u8, rows, dev), image_cfg,
            _batch_rows(input_ids, rows, dev), _batch_rows(prompt_len, rows, dev),
            q01, q99, action_mask, collect_hidden_states, return_first_logits, device=dev)
        return _gather_dp(out, mesh)

    return call, local


def _attach_placed(params: Params, bank: Any, sel: torch.Tensor) -> Params:
    """`multilora.attach_multilora` over local trees: a target whose base or
    factors are placed becomes one placed wrapper {"base", "A", "Bt", "sel"}
    with the base's spec (its tp role) and the factors' specs beside it."""
    def attach(bw, w):
        if bw is None:
            return w
        A, Bt = bw["A"], bw["Bt"]
        if not any(tp.is_placed(t) for t in (w, A, Bt)):
            return multilora.attach_multilora(w, bw, sel)
        ref = next(t for t in (w, A, Bt) if tp.is_placed(t))
        locs = {k: tp.local_leaf(t) for k, t in (("base", w), ("A", A), ("Bt", Bt))}
        lead = locs["A"].shape[:-3]
        locs["sel"] = sel if not lead else sel.expand(*lead, *sel.shape)
        spec = {k: t["spec"] if tp.is_placed(t) else () for k, t in (("base", w), ("A", A),
                                                                        ("Bt", Bt))}
        out = {"local": locs, "spec": spec, "mesh": ref["mesh"], "path": ref["path"],
               "parts": w["parts"] if tp.is_placed(w) else 1}
        if tp.is_placed(w) and "k_valid" in w:
            out["k_valid"] = w["k_valid"]
        return out

    return multilora._zip(attach, bank, params)


def make_sharded_multilora_predict(
    params: Params,
    lora_bank: Any,
    cfg: VLAServingConfig,
    mesh,
    image_cfg: Optional[ImageTransformConfig] = None,
    strategy: str = "tp",
    device: DeviceLike = "cuda",
) -> Tuple[Any, Params, Any]:
    """Multi-rank multi-LoRA serving: the N adapter banks placed with the base
    (the JAX rules: an out-sharded base splits Bt's O, a contraction-sharded
    base A's I, whose rank projection is then a partial SUM-reduced in fp32
    over tp). Returns (call, local_params, local_bank);
    call(p, bank, sel, image_u8, input_ids, prompt_len, q01, q99, action_mask),
    `sel` [B, N] riding dp with the batch. Each rank calls it for itself."""
    from ..parallel.sharding import place_params

    if vlm.is_phi(cfg.vlm):
        raise NotImplementedError("sharded serving runs the Llama trunk")
    dev = resolve_device(device)
    image_cfg = image_cfg or ImageTransformConfig.dinosiglip_224()
    local = place_params(params, mesh, strategy)
    local_bank = place_params(lora_bank, mesh, strategy)
    lcfg = local_serving_config(cfg, local, mesh)

    def call(p, bank, sel, image_u8, input_ids, prompt_len, q01, q99, action_mask):
        rows = _dp_rows(mesh, int(np.shape(input_ids)[0]))
        adapted = _attach_placed(tp.resolve_tree(p), bank,
                                 _batch_rows(sel, rows, dev))
        out = predict_action_from_image(
            adapted, lcfg, _batch_rows(image_u8, rows, dev), image_cfg,
            _batch_rows(input_ids, rows, dev), _batch_rows(prompt_len, rows, dev),
            q01, q99, action_mask, device=dev)
        return _gather_dp(out, mesh)

    return call, local, local_bank


class OpenVLA:
    """Stateful serving wrapper (the JAX package's `OpenVLA`): tokenized
    prompts, norm-stats lookup, batching, multi-LoRA adapter banks and the
    env-drift guard, over the eager entry points on `device`.

    `tokenizer` is the caller's (``.encode(str) -> List[int]`` with BOS).
    The `OVLA_*` serving knobs apply once, here (`with_env_overrides`); a
    JAX kernel-gate knob set now raises (`KERNEL_GATE_FIELDS`), and any
    change of the snapshot's knobs after construction raises on the next
    call. Results are numpy arrays."""

    def __init__(
        self,
        params: Params,
        cfg: VLAServingConfig,
        tokenizer: Any,
        norm_stats: Dict[str, Dict[str, Any]],
        image_cfg: Optional[ImageTransformConfig] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg.with_env_overrides()
        _check_kernel_gates()
        self.tokenizer = tokenizer
        self.norm_stats = norm_stats
        self.image_cfg = image_cfg or ImageTransformConfig.dinosiglip_224()
        self._env_snapshot = _serving_env_snapshot()
        # multi-LoRA serving state (set_adapters): N adapter banks resident
        # next to the frozen base; requests pick adapters per row
        self.lora_bank: Optional[Any] = None
        self.adapter_names: List[str] = []
        self._ml_options = ("masked", False)

    def _check_env_drift(self) -> None:
        now = dict(_serving_env_snapshot())
        was = dict(self._env_snapshot)
        if now != was:
            changed = [f"{k}={now[k]!r} (was {was[k]!r})" for k in now if now[k] != was[k]]
            raise RuntimeError(
                "serving-tier env knobs changed after model construction: "
                + ", ".join(changed)
                + " — the model built its tier from the old values and would silently "
                  "ignore this. Build a new OpenVLA (or pass the tier via VLAServingConfig "
                  "fields / VLAServingConfig.for_tier).")

    # --- unnorm-key plumbing --------------------------------------------------------
    def _check_unnorm_key(self, unnorm_key: Optional[str]) -> str:
        if unnorm_key is None:
            if len(self.norm_stats) != 1:
                raise ValueError(
                    f"Your model was trained on more than one dataset; "
                    f"please pass `unnorm_key` from {list(self.norm_stats.keys())}"
                )
            return next(iter(self.norm_stats))
        if unnorm_key not in self.norm_stats:
            raise ValueError(
                f"`unnorm_key={unnorm_key}` not in `norm_stats`; "
                f"choose from {list(self.norm_stats.keys())}"
            )
        return unnorm_key

    def get_action_dim(self, unnorm_key: Optional[str] = None) -> int:
        return len(self.get_action_stats(unnorm_key)["q01"])

    def get_action_stats(self, unnorm_key: Optional[str] = None) -> Dict[str, Any]:
        return self.norm_stats[self._check_unnorm_key(unnorm_key)]["action"]

    # --- host-side prompt prep ------------------------------------------------------
    def prepare_ids(self, prompt: str) -> Tuple[np.ndarray, int]:
        ids = list(self.tokenizer.encode(prompt))
        if ids[-1] != EMPTY_TOKEN_ID:
            ids.append(EMPTY_TOKEN_ID)
        P = self.cfg.prompt_pad_len
        if len(ids) > P:
            raise ValueError(f"Prompt of {len(ids)} tokens exceeds pad bucket {P}")
        out = np.zeros((P,), np.int32)
        out[: len(ids)] = ids
        return out, len(ids)

    # --- multi-LoRA serving (models/multilora.py) -----------------------------------
    def set_adapters(self, adapters: Any, lora_cfg: Any, dtype: Any = None,
                     fused: bool = False, impl: str = "masked", grouped: bool = False) -> None:
        """Install N LoRA adapter banks over the (frozen, possibly quantized)
        base: `adapters` is a {name: lora_tree} dict or a sequence of trees
        (``training.lora.init_lora_params`` layout, e.g.
        ``multilora.load_adapter_checkpoint`` per finetune run), moved to the
        model's device in `dtype` (the LLM's by default). After this,
        ``predict_action(..., adapter=...)`` and ``predict_action_batch(...,
        adapters=...)`` serve any mixture of adapters in one call;
        ``adapter=None`` rows serve the bare base.

        `fused=True` installs the concat-fused form (int8 and bf16 bases only):
        the A banks are quantized onto the base weight rows, the fused tree
        replaces the base trunk, and every request then rides the fused form.
        Its int8 leaves give the plain base leaf's outputs bit for bit, but a
        bare-base row is the base on the routes a wrapped leaf takes, not the
        plain tier's call: a wrapped leaf stands the fused RMSNorm -> int8
        kernel and the fused tower kernels down, as in the JAX package. The
        base cannot be restored in place: a second install raises.
        `impl` ("masked" or "einsum") and `grouped` are the JAX package's
        ``OVLA_MULTILORA_IMPL`` / ``OVLA_MULTILORA_GROUPED`` A/B knobs (its
        defaults here), kept in the wrapper leaves each call attaches."""
        if self.lora_bank == "fused":
            raise ValueError(
                "adapters were installed with fused=True — the base trunk "
                "was consumed by the fused tree, so banks cannot be swapped "
                "in place. Rebuild the OpenVLA (load_vla) to change the "
                "adapter set; the masked install (fused=False) supports "
                "same-geometry hot-swap.")
        if impl not in MULTILORA_IMPLS:
            raise ValueError(f"multi-LoRA impl must be one of {MULTILORA_IMPLS}, got {impl!r}")
        if isinstance(adapters, dict):
            names = list(adapters)
            trees = [adapters[n] for n in names]
        else:
            trees = list(adapters)
            names = [str(i) for i in range(len(trees))]
        if fused and self.cfg.tier == "parity":
            # the fused form's bitwise bare-base argument holds for int8
            # bases (exact int32 accumulation); the parity tier's contract is
            # bit-equality for no-adapter rows
            raise ValueError(
                "fused adapter install requires a turbo-tier base (int8): "
                "widened bf16 dots cannot promise the parity tier's "
                "bit-equality for bare-base requests. Load with "
                "quantize_int8=True, or install with fused=False.")
        bank = multilora.stack_adapter_banks(
            trees, lora_cfg, dtype=dtype or self.cfg.vlm.llm.dtype, device=self.device)
        if fused:
            # fuse BEFORE changing any state: an unsupported base (mix/int4)
            # raises here and the model keeps serving what it had
            self.params = multilora.fuse_bank_into_base(self.params, bank)
            self.lora_bank = "fused"   # sentinel: the banks live inside params
        else:
            self.lora_bank = bank
        self.adapter_names = names
        self._ml_options = (impl, bool(grouped))

    @property
    def n_adapters(self) -> int:
        return len(self.adapter_names)

    def _resolve_adapter_ids(self, adapter: Any, batch: int) -> np.ndarray:
        """name | id | per-row sequence -> [B] int ids (-1 = bare base)."""
        if self.lora_bank is None:
            raise ValueError("no adapter banks installed; call set_adapters first")

        def one(a) -> int:
            if a is None:
                return -1
            if isinstance(a, str):
                try:
                    return self.adapter_names.index(a)
                except ValueError:
                    raise ValueError(f"unknown adapter {a!r}; have {self.adapter_names}")
            i = int(a)
            if not -1 <= i < self.n_adapters:
                raise ValueError(f"adapter id {i} out of range [-1, {self.n_adapters})")
            return i

        if isinstance(adapter, (str, int)) or adapter is None:
            return np.full((batch,), one(adapter), np.int32)
        ids = np.asarray([one(a) for a in adapter], np.int32)
        if ids.shape != (batch,):
            raise ValueError(f"need one adapter per request row ({batch}), got {ids.shape}")
        return ids

    def _serving_params(self, ids: Optional[np.ndarray]) -> Params:
        """The tree one call serves: the base, or with adapter ids [B] (-1 a
        bare row) the banks attached per row (every call rides the fused
        tree after a fused install)."""
        if ids is None:
            return self.params
        sel = multilora.adapter_one_hot(ids, self.n_adapters, device=self.device)
        impl, grouped = self._ml_options
        if self.lora_bank == "fused":
            return multilora.attach_multilora_fused(self.params, sel, grouped=grouped)
        return multilora.attach_multilora(self.params, self.lora_bank, sel, impl=impl)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.array(x, dtype), device=self.device)

    def _stats_rows(self, stats: Sequence[Dict[str, Any]]):
        """q01, q99 and the mask of each row's stats, stacked [B, A]."""
        A = len(stats[0]["q01"])
        q01 = np.stack([np.asarray(s["q01"], np.float32) for s in stats])
        q99 = np.stack([np.asarray(s["q99"], np.float32) for s in stats])
        mask = np.stack([np.asarray(s.get("mask", np.ones(A, bool)), bool) for s in stats])
        return q01, q99, mask

    def predict_action(
        self,
        image: np.ndarray,                  # [H, W, 3] or [B, H, W, 3] uint8
        prompt: str,
        unnorm_key: Optional[str] = None,
        return_hidden_states: bool = False,
        return_first_logits: bool = False,
        draft_tokens: Optional[np.ndarray] = None,   # [A] or [B, A]: verified speculation
        adapter: Any = None,
    ) -> Dict[str, np.ndarray]:
        """One request (one or B images, one prompt): the sequential decode,
        or with `draft_tokens` (e.g. the previous control step's
        action_tokens) verified speculation, which gives the same greedy
        tokens up to hairline margins and skips the decode steps of an
        accepted draft. The parity tier rejects drafts unless
        `speculative_in_parity` is "allow"."""
        self._check_env_drift()
        if (draft_tokens is not None and self.cfg.tier == "parity"
                and self.cfg.speculative_in_parity != "allow"):
            raise ValueError(
                "speculative decoding (draft_tokens) is a turbo-tier feature: "
                "the verify pass's batched matmul reduction order is not "
                "bit-identical to sequential decode, so it cannot ride the "
                "parity tier's bit-equality contract. Build the config via "
                "VLAServingConfig.for_tier(vlm_cfg, 'turbo'), or set "
                "speculative_in_parity='allow' for measurement harnesses.")
        stats = self.get_action_stats(unnorm_key)
        image = np.asarray(image)
        squeeze = image.ndim == 3
        if squeeze:
            image = image[None]
        B = image.shape[0]
        ids, plen = self.prepare_ids(prompt)
        # fused install: every request rides the fused tree (bare-base rows are
        # the base on the routes a wrapped leaf takes)
        params = self._serving_params(self._resolve_adapter_ids(adapter, B) if (
            adapter is not None or self.lora_bank == "fused") else None)
        q01, q99, mask = self._stats_rows([stats])
        common = dict(
            input_ids=self._tensor(np.broadcast_to(ids, (B, ids.shape[0]))),
            prompt_len=self._tensor(np.full((B,), plen, np.int32)),
            q01=self._tensor(q01[0]), q99=self._tensor(q99[0]), action_mask=self._tensor(mask[0]),
        )
        image_t = self._tensor(image, np.uint8)
        if draft_tokens is not None:
            if return_first_logits:
                raise ValueError(
                    "return_first_logits is not supported with draft_tokens "
                    "(the speculative core does not compute first_logits); "
                    "run without a draft for the parity-certificate outputs"
                )
            draft = np.asarray(draft_tokens, np.int32)
            if draft.ndim == 1:
                draft = np.broadcast_to(draft, (B, draft.shape[0]))
            out = predict_action_speculative_from_image(
                params, self.cfg, image_t, self.image_cfg, draft_tokens=self._tensor(draft),
                collect_hidden_states=return_hidden_states, device=self.device, **common)
        else:
            out = predict_action_from_image(
                params, self.cfg, image_t, self.image_cfg,
                collect_hidden_states=return_hidden_states,
                return_first_logits=return_first_logits, device=self.device, **common)
        result = {k: v.cpu().numpy() for k, v in out.items()}
        if squeeze:
            result = {k: v[0] for k, v in result.items()}
        return result

    def predict_action_batch(
        self,
        images: np.ndarray,                 # [B, H, W, 3] uint8 (same shape)
        prompts: Sequence[str],             # B prompts (lengths may differ)
        unnorm_keys: Optional[Sequence[Optional[str]]] = None,
        batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 24, 32),
        adapters: Optional[Sequence[Any]] = None,
    ) -> List[Dict[str, np.ndarray]]:
        """Heterogeneous requests in one call: per-row prompts, per-row norm
        stats and (after `set_adapters`) per-row adapters. The batch pads up
        to the next bucket by repeating row 0 (its adapter too), so the card
        sees a few batch sizes only (each row's tokens do not depend on the
        others'). Returns one result dict per request."""
        self._check_env_drift()
        images = np.asarray(images)
        B = len(prompts)
        assert images.shape[0] == B, "one image per prompt"
        if unnorm_keys is None:
            unnorm_keys = [None] * B
        rows = [self.prepare_ids(p) for p in prompts]
        ids = np.stack([r[0] for r in rows])
        lens = np.asarray([r[1] for r in rows], np.int32)
        q01, q99, mask = self._stats_rows([self.get_action_stats(k) for k in unnorm_keys])

        bucket = next((b for b in batch_buckets if b >= B), None)
        if bucket is None:
            raise ValueError(f"Batch {B} exceeds largest bucket {batch_buckets[-1]}")
        pad = bucket - B

        def padded(x):
            return np.concatenate([x, np.repeat(x[:1], pad, axis=0)]) if pad else x

        def pad_rows(x):
            return self._tensor(padded(x))

        aids = None
        if adapters is not None or self.lora_bank == "fused":
            aids = padded(self._resolve_adapter_ids(
                list(adapters) if adapters is not None else None, B))
        out = predict_action_from_image(
            self._serving_params(aids), self.cfg, pad_rows(images.astype(np.uint8)),
            self.image_cfg, input_ids=pad_rows(ids), prompt_len=pad_rows(lens),
            q01=pad_rows(q01), q99=pad_rows(q99), action_mask=pad_rows(mask),
            device=self.device)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        return [{k: v[i] for k, v in host.items()} for i in range(B)]
