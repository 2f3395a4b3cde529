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

Verified speculation (`predict_action_speculative_core`, the bs = 1 robot
control loop): one verify forward over [prompt | draft] scores every draft
token, and only the rejected tail runs sequential decode steps, on every
ported tier over the bf16 stacked cache. `OpenVLA` is the stateful wrapper:
tokenized prompts, norm-stats lookup, batching and the env-drift guard.

The ``OVLA_*`` environment knobs the port reads: ``OpenVLA`` applies
``OVLA_STACKED_KV8`` and ``OVLA_LEGACY_DECODE`` once, at construction
(`VLAServingConfig.with_env_overrides`), and carries ``OVLA_DECODE_UNROLL``
into `decode_unroll`; ``OVLA_KV_INT8``, ``OVLA_SPLIT_PREFILL`` and
``OVLA_FLAT_CACHE`` select options that are not ported and raise there. The
JAX package's per-kernel gates (``OVLA_PALLAS``, ``OVLA_PALLAS_*``,
``OVLA_W8A8``, ``OVLA_W4A8*``, ``OVLA_VITMLP_BM``, ``OVLA_FLASH_ONESHOT``) are
config fields or fixed rules here: set when an ``OpenVLA`` is built, one
raises and names what replaces it (`KERNEL_GATE_FIELDS`).
``OVLA_PALLAS_INTERPRET`` (the TPU kernels' interpret mode) has no
counterpart and is not read. After construction every knob of
`_serving_env_snapshot` is watched: a change raises on the next call.

Other tiers and options raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.image import ImageTransformConfig, apply_image_transform
from ..ops.linear import matmul_t
from ..vla.action_tokenizer import ActionCodec
from . import llama, vlm

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
    `for_tier`.

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
        knobs = (self.tier, self.decode_impl, self.split_prefill, self.flat_cache, self.kv_int8)
        if knobs not in _PORTED_TIERS:
            raise NotImplementedError(
                f"(tier, decode_impl, split_prefill, flat_cache, kv_int8) = {knobs}: only "
                "tier='parity' and tier='turbo' with decode_impl='stacked', tier='pallas' "
                "with decode_impl='frozen_kv' and tier='pallas_kv8' with decode_impl="
                "'stacked_kv8' are ported; the rest (turbo_kv8, split_prefill, flat_cache) "
                "is ROADMAP Queue 1 item 10")
        if self.speculative_in_parity not in ("reject", "allow"):
            raise ValueError("speculative_in_parity must be 'reject' or 'allow', "
                             f"got {self.speculative_in_parity!r}")

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

    def with_env_overrides(self) -> "VLAServingConfig":
        """Apply the legacy `OVLA_*` serving knobs once: the JAX package's
        `with_env_overrides`, the same rules and errors. OVLA_STACKED_KV8=1
        selects the pallas_kv8 tier, OVLA_LEGACY_DECODE the stacked (1) or
        frozen-KV (0) decode, OVLA_DECODE_UNROLL `decode_unroll`. A config
        the JAX package would build but the port does not run (OVLA_KV_INT8's
        turbo_kv8, OVLA_SPLIT_PREFILL, OVLA_FLAT_CACHE, or a decode the tier
        lacks) raises NotImplementedError in its validation."""
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
    elif stacked8:
        # prefill K/V (Tk = T), then quantized layer by layer into the int8
        # stacked cache; S int8-tile aligned (32) as in the JAX package
        out = llama.prefill(params["llm"], c.llm, embeds, mm_mask, positions, **taps)
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
            **taps,
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


_MULTILORA = "multi-LoRA serving (models/multilora.py) is ROADMAP Queue 1 item 11"


class OpenVLA:
    """Stateful serving wrapper (the JAX package's `OpenVLA`, without
    multi-LoRA): tokenized prompts, norm-stats lookup, batching and the
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
        self.adapter_names: List[str] = []   # multi-LoRA banks: none (item 11)

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

    # --- multi-LoRA (not ported) ----------------------------------------------------
    def set_adapters(self, adapters: Any, lora_cfg: Any, dtype: Any = None,
                     fused: bool = False) -> None:
        raise NotImplementedError(_MULTILORA)

    @property
    def n_adapters(self) -> int:
        return len(self.adapter_names)

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
        if adapter is not None:
            raise NotImplementedError(_MULTILORA)
        stats = self.get_action_stats(unnorm_key)
        image = np.asarray(image)
        squeeze = image.ndim == 3
        if squeeze:
            image = image[None]
        B = image.shape[0]
        ids, plen = self.prepare_ids(prompt)
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
                self.params, self.cfg, image_t, self.image_cfg, draft_tokens=self._tensor(draft),
                collect_hidden_states=return_hidden_states, device=self.device, **common)
        else:
            out = predict_action_from_image(
                self.params, self.cfg, image_t, self.image_cfg,
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
        """Heterogeneous requests in one call: per-row prompts and per-row norm
        stats. The batch pads up to the next bucket by repeating row 0, so the
        card sees a few batch sizes only (each row's tokens do not depend on
        the others'). Returns one result dict per request."""
        self._check_env_drift()
        if adapters is not None:
            raise NotImplementedError(_MULTILORA)
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

        def pad_rows(x):
            return self._tensor(np.concatenate([x, np.repeat(x[:1], pad, axis=0)]) if pad else x)

        out = predict_action_from_image(
            self.params, self.cfg, pad_rows(images.astype(np.uint8)), self.image_cfg,
            input_ids=pad_rows(ids), prompt_len=pad_rows(lens), q01=pad_rows(q01),
            q99=pad_rows(q99), action_mask=pad_rows(mask), device=self.device)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        return [{k: v[i] for k, v in host.items()} for i in range(B)]
