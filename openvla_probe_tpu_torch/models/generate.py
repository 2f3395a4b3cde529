"""Text generation and candidate-string scoring for the base VLM
(counterpart of ``openvla_probe_tpu/models/generate.py``).

* `generate_text` / `generate_greedy` / `generate_greedy_batch`: prompts
  right-padded to a bucket of 64, rows padded to a bucket of 8 by repeating
  row 0; a cached prefill into a stacked KV cache of S = T + max_new_tokens
  slots (the plain attention branch, as the JAX package's prefill here does
  not declare its zero offset), then one cached decode step per token (the
  `decode_attention` kernel), EOS latched per row.
* `score_continuation_rows` / `score_candidates`: the summed log-probability
  of each row's continuation tokens, one batched uncached `vlm.forward` over
  every row (the flash kernels: one-shot up to 1024 keys, blockwise beyond).

Every entry point runs on ``device="cuda"`` unless the caller passes
``"cpu"`` (the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops.linear import matmul_t
from . import llama, vlm

EOS_TOKEN_ID = 2
IGNORE_INDEX = vlm.IGNORE_INDEX


def _bucket(n: int, step: int = 64) -> int:
    return ((n + step - 1) // step) * step


def pick(logits: torch.Tensor, do_sample: bool = False, temperature: float = 1.0,
         top_k: int = 0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Next token per row [B] from logits [B, V]: the argmax (the first index
    wins a tie), or a draw from softmax(logits / max(temperature, 1e-6))
    restricted to the top_k values (logits below the k-th value become -inf,
    so ties at the k-th value stay in) when `do_sample`. Draws come from
    `generator`; they are not the JAX package's random bits (jax.random and a
    torch.Generator give different numbers from one seed), only the same
    distribution."""
    if not do_sample:
        return logits.argmax(-1)
    lg = logits.float() / max(float(temperature), 1e-6)
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    return torch.multinomial(torch.softmax(lg, dim=-1), 1, generator=generator)[:, 0]


@torch.no_grad()
def _generate(
    params: Dict[str, Any],
    cfg: vlm.VLMConfig,
    input_ids,                      # [B, P] right-padded
    prompt_len,                     # [B]
    pixel_values=None,              # [B, 3K, S, S] preprocessed, or None
    max_new_tokens: int = 128,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: int = 50,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Token ids [B, max_new_tokens]: the first from the prefill's last real
    position, then one cached decode step per token; once a row has emitted
    EOS every later token of the row is EOS (the first token is never
    replaced)."""
    dev = resolve_device(device)
    c = cfg.llm
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    prompt_len = torch.as_tensor(prompt_len, device=dev).long()
    B, P = input_ids.shape
    prompt_mask = (torch.arange(P, device=dev)[None] < prompt_len[:, None]).int()
    if pixel_values is not None:
        mm = vlm.build_multimodal_inputs(params, cfg, input_ids, prompt_mask,
                                         torch.as_tensor(pixel_values, device=dev))
        embeds, mask, N = mm["inputs_embeds"], mm["attn_mask"], cfg.num_patches
    else:
        embeds, mask, N = llama.embed_tokens(params["llm"], input_ids), prompt_mask, 0
    T = embeds.shape[1]
    S = T + max_new_tokens
    mm_len = N + prompt_len
    generator = torch.Generator(device=dev).manual_seed(seed) if do_sample else None

    def next_token(logits):
        return pick(logits, do_sample, temperature, top_k, generator)

    cache = llama.KVCache.zeros(c, B, S, dtype=c.dtype, device=dev)
    positions = torch.arange(T, device=dev).expand(B, T)
    out = llama.forward(params["llm"], c, embeds, F.pad(mask, (0, S - T)), positions,
                        cache=cache, cache_index=0, compute_logits=False)
    last_h = out["last_hidden_state"][torch.arange(B, device=dev), mm_len - 1]
    tok = next_token(matmul_t(last_h, params["llm"]["lm_head"], c.int8_matmul).float())
    toks = [tok]
    slots = torch.arange(S, device=dev)[None]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(max_new_tokens - 1):
        valid = (slots < mm_len[:, None]) | ((slots >= T) & (slots <= T + t))
        o = llama.forward(params["llm"], c, llama.embed_tokens(params["llm"], tok[:, None]),
                          valid.int(), (mm_len + t)[:, None], cache=cache, cache_index=T + t)
        nxt = next_token(o["logits"][:, -1])
        done = done | (tok == EOS_TOKEN_ID)
        tok = torch.where(done, EOS_TOKEN_ID, nxt)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def _trim_eos(row) -> List[int]:
    out = []
    for t in row:
        if t == EOS_TOKEN_ID:
            break
        out.append(int(t))
    return out


def generate_text(
    params: Dict[str, Any],
    cfg: vlm.VLMConfig,
    tokenizer: Any,
    prompt_ids: Sequence[int],
    pixel_values=None,              # [1, 3K, S, S] preprocessed, or None
    max_new_tokens: int = 128,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: int = 50,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> str:
    """Single-prompt generation -> decoded text (EOS-trimmed): greedy, or
    temperature / top-k sampling seeded from `seed` (the reference REPL's
    do_sample route into HF generate, whose sampling default is top_k=50)."""
    ids = list(prompt_ids)
    padded = np.zeros((1, _bucket(len(ids))), np.int64)
    padded[0, :len(ids)] = ids
    toks = _generate(params, cfg, padded, [len(ids)], pixel_values, max_new_tokens,
                     do_sample=do_sample, temperature=temperature,
                     top_k=top_k if do_sample else 0, seed=seed, device=device)
    return tokenizer.decode(_trim_eos(toks[0].tolist()), skip_special_tokens=True).strip()


def generate_greedy(
    params: Dict[str, Any],
    cfg: vlm.VLMConfig,
    tokenizer: Any,
    prompt_ids: Sequence[int],
    pixel_values=None,
    max_new_tokens: int = 128,
    device: DeviceLike = "cuda",
) -> str:
    """Single-prompt greedy generation -> decoded text (EOS-trimmed)."""
    return generate_text(params, cfg, tokenizer, prompt_ids, pixel_values, max_new_tokens,
                         device=device)


def generate_greedy_batch(
    params: Dict[str, Any],
    cfg: vlm.VLMConfig,
    tokenizer: Any,
    prompts_ids: Sequence[Sequence[int]],
    pixel_values=None,              # [B, 3K, S, S] preprocessed per row, or None
    max_new_tokens: int = 128,
    device: DeviceLike = "cuda",
) -> List[str]:
    """Batched greedy generation in one call: prompts right-padded to a
    length bucket, rows to a bucket of 8 by repeating row 0 (discarded); rows
    are independent (per-row prompt masks and EOS latching)."""
    dev = resolve_device(device)
    B = len(prompts_ids)
    Bb = _bucket(B, 8)
    padded = np.zeros((Bb, _bucket(max(len(p) for p in prompts_ids))), np.int64)
    lens = np.zeros((Bb,), np.int64)
    for i, ids in enumerate(prompts_ids):
        padded[i, :len(ids)] = list(ids)
        lens[i] = len(ids)
    padded[B:], lens[B:] = padded[0], lens[0]
    pix = None
    if pixel_values is not None:
        pv = torch.as_tensor(pixel_values, device=dev)
        if pv.shape[0] != B:
            raise ValueError(f"pixel_values rows {pv.shape[0]} != batch {B}")
        pix = torch.cat([pv, pv[:1].expand(Bb - B, *pv.shape[1:])]) if Bb > B else pv
    toks = _generate(params, cfg, padded, lens, pix, max_new_tokens, device=dev).tolist()
    return [tokenizer.decode(_trim_eos(toks[b]), skip_special_tokens=True).strip()
            for b in range(B)]


@torch.no_grad()
def _score(params: Dict[str, Any], cfg: vlm.VLMConfig, ids: torch.Tensor, row_len: torch.Tensor,
           cand_start: torch.Tensor, pixel_values) -> torch.Tensor:
    """Sum of candidate-token log-probabilities per row. ids [C, L]
    right-padded; candidate tokens occupy [cand_start, row_len) of each
    (unspliced) row; fp32 log-softmax of the logits at every position but
    the last, gathered at the shifted labels."""
    pos = torch.arange(ids.shape[1], device=ids.device)[None]
    mask = (pos < row_len[:, None]).int()
    labels = torch.where((pos >= cand_start[:, None]) & (pos < row_len[:, None]), ids,
                         IGNORE_INDEX)
    out = vlm.forward(params, cfg, ids, mask, pixel_values, labels=labels)
    logp = torch.log_softmax(out["logits"][:, :-1].float(), dim=-1)
    tgt = out["labels"][:, 1:]
    valid = tgt != IGNORE_INDEX
    tok_lp = logp.gather(-1, torch.where(valid, tgt, 0)[..., None])[..., 0]
    return torch.where(valid, tok_lp, 0.0).sum(dim=1)


def score_continuation_rows(
    params: Dict[str, Any],
    cfg: vlm.VLMConfig,
    rows: List[Tuple[Sequence[int], int]],   # [(full_ids, start)]
    pixel_values=None,                        # [C, 3K, S, S] per row, or one shared image
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Log-probability of full_ids[start:] given full_ids[:start], per row,
    as float32 [C]. Each row keeps its own split point (a sentencepiece
    boundary token can re-merge with a continuation). One batched call:
    rows right-pad to a length bucket of 64 and the row count to a bucket of
    8 (padding rows repeat row 0)."""
    dev = resolve_device(device)
    C = len(rows)
    L = _bucket(max(len(f) for f, _ in rows))
    Cb = _bucket(C, 8)
    ids = np.zeros((Cb, L), np.int64)
    row_len = np.zeros((Cb,), np.int64)
    starts = np.zeros((Cb,), np.int64)
    for i, (full, st) in enumerate(rows):
        ids[i, :len(full)] = list(full)
        row_len[i], starts[i] = len(full), st
    ids[C:], row_len[C:], starts[C:] = ids[0], row_len[0], starts[0]
    pix = None
    if pixel_values is not None:
        pv = torch.as_tensor(pixel_values, device=dev)
        if pv.ndim == 4 and pv.shape[0] == C:
            # per-row pixels (cross-example batching): pad rows to the bucket
            pix = torch.cat([pv, pv[:1].expand(Cb - C, *pv.shape[1:])]) if Cb > C else pv
        else:
            # one shared image for every row (single-example scoring)
            pix = pv.expand(Cb, *pv.shape[-3:]).contiguous()
    scores = _score(params, cfg, torch.from_numpy(ids).to(dev), torch.from_numpy(row_len).to(dev),
                    torch.from_numpy(starts).to(dev), pix)
    return scores[:C].cpu().numpy()


def score_candidates(
    params: Dict[str, Any],
    cfg: vlm.VLMConfig,
    prompt_ids: Sequence[int],
    candidate_ids: List[Sequence[int]],
    pixel_values=None,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Log-probability of each candidate continuation given the prompt (the
    string-probability scoring of multiple-choice evals), in one call."""
    plen = len(prompt_ids)
    rows = [(list(prompt_ids) + list(c), plen) for c in candidate_ids]
    return score_continuation_rows(params, cfg, rows, pixel_values, device=device)
