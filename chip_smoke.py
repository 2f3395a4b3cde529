#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Ten serving paths, each at full OpenVLA-7B width through the normal entry
`predict_action_from_image`:
  parity        bf16 weights, stacked-cache decode
  pallas        int8 TURBO_QUANT_SUFFIXES weights, turbo numerics, frozen-KV
                split decode
  pallas_kv8    the same int8 weights (built once for pallas, pallas_kv8 and
                turbo), the int8 stacked cache and its fused-dequant decode
  turbo         the same int8 weights on the turbo tier: every int8 linear on
                w8a8, the fused RMSNorm -> int8 kernel, stacked-cache decode at
                bf16 scores
  turbo_kv8     the same int8 weights on the turbo_kv8 tier: turbo's routes,
                the frozen-KV split decode over the prefill K/V quantized to
                int8 (split_attention_i8, the norms plain in the decode steps)
  turbo_fused   turbo on the same int8 weights after llama.fuse_serving_params
                (q/k/v and gate/up one product each, fused in place after
                turbo's phases): tokens and first logits bit-equal to turbo's
  pallas_int4   the pallas tier over grouped-int4 weights (bits=4, group 128;
                SigLIP's fc2 int8), frozen-KV split decode
  turbo_int4    the turbo tier over pallas_int4's weights: the requant route
                at prefill and in the towers, w4a8_grouped at decode M and
                lm_head, SigLIP's fc2 on w8a8_matmul
  turbo_nibble  the turbo tier over nibble weights (bits="nibble": the trunk
                and lm_head as two 4-bit planes, the towers int8)
  turbo_mix     the turbo tier over mix weights (bits="mix": the trunk and
                lm_head as int8 and int4 copies, the towers int8; codes and
                scales drawn directly by linear.random_params_like): the int8
                copy on w8a8_matmul at prefill, the int4 copy on w4a8_grouped
                at decode M
three paths of the base VLM's entry points (models/generate.py) on the
parity tier's bf16 weights, B = 8 rows with 224 px dinosiglip pixels:
  generate      generate_greedy_batch, prompts bucketed to 64, 32 new tokens
  score_short   score_continuation_rows, rows bucketed to L = 64 (T = 320)
  score_long    score_continuation_rows, L = 832 (T = 1088 > 1024: the
                blockwise flash kernel)
and two training paths through tools/bench_finetune.py (streamed LoRA r = 32,
AdamW at a constant 5e-4, remat, the plain attention, B = 8 rows of 64 text
tokens, T = 320):
  train_int4    QLoRA over a grouped-int4 trunk and lm_head: w4a8_matmul
                forward and recompute, w4a8_dx backward, lm_head on
                w4a8_requant
  train_int8    over a per-channel int8 trunk and lm_head: w8a8_matmul and
                its STE
and, on the weights of turbo and turbo_nibble while they are alive, the bs = 1
robot-control point and (turbo's int8 weights) the action server:
  bs1           one 256x256 image, P = 32, A = 7: the sequential
                predict_action_from_image; predict_action_speculative_from_image
                drafted with the sequential tokens (with PARITY_r02's margin
                check: the first token that differs must sit within twice the
                gap between the verify's logits and the sequential logits on the
                same prefix), with its own previous output (the steady state:
                full acceptance, no decode_attention launch) and with a draft
                wrong everywhere (n_accepted 0, six decode steps); p50 ms over 5
                calls after a warm-up, busy ms a call, launches per kernel
  serve         serving/server.py over models.vla.OpenVLA: 6 concurrent POST
                /act to a dynamically batching server on 127.0.0.1, each batch's
                tokens equal to a direct predict_action_batch over the same
                requests in the same bucket, /stats; then 4 steps of one
                speculative stream on a bs = 1 server (n_accepted a step,
                /stats acceptance, client-side p50 ms)
Phases, one output line each:
  1. device   the card's name and power limit (nvidia-smi)
  2. build    compiles every CUDA kernel from ops/csrc, one nvcc per source,
              all started together (set-up time); then a `resources` line:
              each kernel's registers a thread and spill bytes (ptxas -v)
  3. kernels  each kernel against its plain PyTorch version at the 7B main-path
              shapes (B=24; B=8 for score_long), with kernel / plain / library
              times: flash_prefill (also at score_short's shape, with its
              negative control and a fully masked row), flash_blockwise (with
              its negative control, a fully masked row at the score_long
              shape, the share of key tiles its causal skip computes, and its
              host time a call),
              vit_attention, decode_attention (parity; turbo's bf16 scores;
              generate's B = 8, S = 352, and its single row timed at the
              cluster rule beside one CTA a (b, h); edge cases: ragged
              cluster key ranges, a CTA with no key, a query far before the
              last key, a row masked but BOS, a row masked everywhere),
              wi8_matmul (also at SigLIP's fc2 on pallas_int4, K = 4304),
              fused_ln_w8a8, fused_mlp_residual (each call's pre-pass and
              GEMM launches exact; edge cases M = 1, 64, 65, 257, N tails,
              F = 8208, fp32; the host time of one call),
              decode_split_attention (pallas; a single row timed at the
              cluster rule beside one CTA a (b, h); edge cases: the prefill /
              generated boundary inside a chunk, a row masked but BOS),
              stacked_decode_attention_i8
              (pallas_kv8), w4a8_matmul (pallas_int4; also at M = 64 / 65,
              its two routes' edge, and its host time a call at decode),
              w8a8_matmul (turbo; also the nibble loader and the prequant
              entry, turbo_nibble's mix, and the routes' edge M = 64 / 65
              and ragged shapes),
              rms_norm_quant (turbo; also at M = 1, odd D and fp32),
              nib_hi_dot (turbo_nibble), w4a8_dx (train_int4), w4a8_requant
              (pallas_int4's lm_head and SigLIP fc1, train_int4's lm_head;
              beside the two-step route it replaced; edge M, N and group
              sizes), split_attention_i8 (turbo_kv8, its ring route; GQA,
              T = 291, T + A = 4096, fp32 scores, one row timed at the
              cluster rule beside 1, 2 and 4 CTAs, a row masked but BOS;
              decode_attention.compare_split_attention_i8),
              w4a8_grouped (turbo_int4 and turbo_mix at decode M: bit-equal;
              its pre-pass and GEMM also timed apart; edge M, N and group
              sizes, lm_head over three row blocks; the persistent grid's
              clusters); vit_attention also at DINOv2's 518 px, N = 1370,
              and at ragged N, bf16 (tensor cores) and fp32 (scalar route);
              the scalar routes (the decode attentions' at fp32 and Dh = 72,
              vit_attention's, flash_prefill's and wi8_matmul's in fp32,
              split_attention_i8's in fp32 and at Dh = 64, n_rep 3),
              which no main path takes: a line of their own
              (`scalar_routes`), with the main paths' launches (0) and the
              tiny paths' (`tiny_launches`)
  4. tiny     each path at tiny fp32 size on the card vs the CPU run (plain
              versions, which the CPU tests hold against the JAX package):
              equal tokens, close logits or scores; the training paths' loss,
              LoRA gradients and adapters after one step; the speculative core
              on turbo and turbo_nibble (drafts correct, partial, wrong): equal
              tokens and n_accepted
  5. main     each path once with every launch count set to 0 just before and
              read just after (exact per-kernel counts asserted, and no
              torch._int_mm call), then p50 latency over timed calls and,
              for the serving paths, the card's busy time a call beside it
              (torch.profiler over one call, as tools/profile_main_path.py
              measures it: the idle share is an upper bound); random
              weights from a seeded generator on the card; the VLA paths with
              256x256 uint8 images, prompt_pad_len=32, A=7; the training
              paths count one step, then time steps after two warm-ups and
              check that the loss stays finite, the base is bit-unchanged
              and every B factor moved off zero; the bs1 and serve phases
              (above) after turbo and turbo_nibble
then a JSON line of per-kernel figures (each kernel's launches from the main
path's run), a JSON line of the scalar routes' figures, and a last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero; with
no CUDA card it exits 1 before printing any result.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import warnings
import zlib
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import generate, llama, vit, vla, vlm
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import attention as attn
from openvla_probe_tpu_torch.ops import decode_attention as dattn
from openvla_probe_tpu_torch.ops import linear as lin
from openvla_probe_tpu_torch.ops import rmsnorm_quant as rmsq
from openvla_probe_tpu_torch.ops import vit_mlp as vmlp
from openvla_probe_tpu_torch.ops.image import (BackboneTransformSpec, ImageTransformConfig,
                                               apply_image_transform)
from openvla_probe_tpu_torch.probe import train_probes
from openvla_probe_tpu_torch.serving.server import (OpenVLAServer, decode_numpy, encode_numpy,
                                                    get_openvla_prompt)
from openvla_probe_tpu_torch.tools import bench_finetune, kernel_ab, profile_main_path
from openvla_probe_tpu_torch.tools.kernel_ab import rotating
from openvla_probe_tpu_torch.training.lora import LoRAConfig, init_lora_params
from openvla_probe_tpu_torch.training.train_state import tree_leaves
from openvla_probe_tpu_torch.training.train_step import value_and_grad

# published H100 SXM peaks (dense): HBM bytes/s; bf16 and int8 tensor-core and
# fp32 FMA operations/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
BATCH, PROMPT_PAD, ACTION_DIM, IMG_HW = 24, 32, 7, 256
LAYERS, T_PREFILL = 32, 288            # Llama-2-7B layers; 1 + 256 patches + 31 prompt tokens
TOWER_LAUNCHES = {"dinov2": 23, "siglip": 26}   # blocks 0..L-2 of each tower run
TIMED_CALLS = 5
L2_BYTES = 50e6
# the base VLM's entry points: rows, new tokens, row buckets (T = 1 + 256 + L - 1)
VLM_PATHS = ("generate", "score_short", "score_long")
VLM_BATCH, GEN_NEW_TOKENS, GEN_PROMPT_PAD = 8, 32, 64
SCORE_L = {"score_short": 64, "score_long": 832}
TIMED_VLM_CALLS = 3
# the training paths (tools/bench_finetune.py's setting): rows, text tokens, rank, timed steps
TRAIN_PATHS = {"train_int4": "int4", "train_int8": "int8"}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_RANK, TRAIN_LR, TRAIN_TIMED = 8, 64, 32, 5e-4, 3
TRAIN_ROWS = TRAIN_BATCH * (1 + 256 + TRAIN_SEQ - 1)   # 2560 rows through every trunk linear


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


SPIN_CYCLES = 4_000_000   # ~2 ms of a spin kernel at the H100's clocks


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of `fn`, by CUDA events around each call.
    Each timed call is queued behind a spin kernel, so the host has enqueued
    the call's launches before the card reaches them and the events measure
    device time, not the host's launch overhead (tens of microseconds per
    wrapper call, longer than a decode-sized kernel)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def copies_past_l2(nbytes: int) -> int:
    return max(1, int(-(-2 * L2_BYTES // nbytes)))


def bound_ms(nbytes: int, flops: int, kind: str):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_flash_prefill(dev, g):
    """Row 1 at its two main-path shapes: the serving prefill, q [24, 288, 32,
    128], k/v [24, 295, 32, 128] bf16 (stacked cache S = T + A, padded
    prompts; 32 launches per call on every serving path), and score_short's
    q/k/v [8, 320, 32, 128] (rows right-padded to 289-320 tokens). Query 0 of
    the last row sees no valid key and must give the mean of V over the Tk
    keys. attn.compare_oneshot against flash_attention_plain (every element
    within one bf16 step plus attn.oneshot_slack, the reach of P's rounding
    when the scores are summed in another order; at most max(16, 2 %)
    apart), which fp32 P (flash_attention_blockwise_plain, the negative
    control) must fail on the same inputs. Bound: q/k/v/out bytes against the causal, unpadded products
    of QKᵀ and PV; beside it the share of key tiles the kernel's causal skip
    leaves it to visit. Library: SDPA with a boolean mask on the same bf16
    inputs (a yardstick of time only)."""
    H, Dh = 32, 128
    by_shape = {}
    for name, (B, T, S, lo, per_call) in {"serving": (BATCH, T_PREFILL, T_PREFILL + ACTION_DIM,
                                                      12, LAYERS),
                                          "score_short": (VLM_BATCH, 320, 320, 31, 0)}.items():
        q = torch.randn((B, T, H, Dh), generator=g, device=dev).bfloat16()
        k = torch.randn((B, S, H, Dh), generator=g, device=dev).bfloat16()
        v = torch.randn((B, S, H, Dh), generator=g, device=dev).bfloat16()
        lens = torch.randint(T - lo, T + 1, (B,), generator=g, device=dev)
        valid = (torch.arange(S, device=dev)[None] < lens[:, None]).int()   # tail slots padded
        valid[-1, 0] = 0                      # query 0 of the last row: every key masked
        before = attn.KERNEL_LAUNCHES["flash_prefill"]
        got = attn.flash_attention(q, k, v, valid)
        torch.cuda.synchronize()
        assert attn.KERNEL_LAUNCHES["flash_prefill"] == before + 1
        want = attn.flash_attention_plain(q, k, v, valid)
        slack = attn.oneshot_slack(q, k, v, valid)
        stats = attn.compare_oneshot(got, want, slack=slack)
        mean_v = v[-1].float().mean(0).bfloat16()          # the mean of V over the Tk keys
        stats["masked_row"] = attn.compare_oneshot(got[-1, :1], mean_v[None])
        control = attn.flash_attention_blockwise_plain(q, k, v, valid)
        try:
            attn.compare_oneshot(control, want, slack=slack)
        except AssertionError:
            stats["control_n_apart"] = int((control != want).sum())
        else:
            raise AssertionError("flash_prefill: the check passed the blockwise class (fp32 P)")
        del control, slack
        ki = torch.arange(S, device=dev)
        sdpa_mask = ((valid[:, None, None, :] > 0)
                     & (ki[None, :] <= torch.arange(T, device=dev)[:, None])[None, None])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        b, by = bound_ms(_nbytes(q, k, v, got, valid), 4 * H * Dh * _causal_pairs(lens, T), "bf16")
        by_shape[name] = dict(
            launches_per_call=per_call, **stats,
            ms=cuda_ms(lambda: attn.flash_attention(q, k, v, valid)),
            plain_ms=cuda_ms(lambda: attn.flash_attention_plain(q, k, v, valid), reps=10),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      attn_mask=sdpa_mask)),
            bound_ms=b, bound_by=by,
            predicted_tile_share=blockwise_predicted_tile_share(valid, T))
        del q, k, v, got, want, qt, kt, vt, sdpa_mask
    main = by_shape["serving"]
    return dict(name="flash_prefill", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/flash_prefill.cu",
                replaces="openvla_probe_tpu/ops/attention.py:88",
                max_abs_err=max(r["max_abs_err"] for r in by_shape.values()),
                **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms")},
                by_shape=by_shape)


def host_us(fn, reps: int = 200) -> float:
    """Median host time of one call of `fn` (the wrapper's Python, checks and
    launch enqueue; the card works behind it), in microseconds."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def blockwise_predicted_tile_share(valid, Tq: int, offset: int = 0, causal: bool = True) -> float:
    """The share of (64 query rows, 64-key tile) pairs that the blockwise
    kernel's skip rule (ops/csrc/flash_blockwise.cu, `visits`) leaves to
    compute, predicted on the host from the mask; the kernel does not count
    the tiles it visits. Under the causal mask, where the batch row's first
    valid key is at or below the diagonal of the rows' first row, a tile above
    the last row's diagonal, past the last valid key, or with no valid key
    after the first is skipped."""
    B, Tk = valid.shape
    n_tiles = -(-Tk // 64)
    seen = total = 0
    for b in range(B):
        keys = torch.nonzero(valid[b] > 0).flatten().tolist()
        first, last = (keys[0], keys[-1]) if keys else (None, -1)
        tile_any = [bool((valid[b, 64 * j:64 * j + 64] > 0).any()) for j in range(n_tiles)]
        for qw in range(0, Tq, 64):
            total += n_tiles
            if not causal or first is None or first > qw + offset:
                seen += n_tiles
                continue
            q_last = min(qw + 64, Tq) - 1
            seen += sum(1 for j in range(n_tiles) if 64 * j <= min(q_last + offset, last)
                        and (64 * j <= first or tile_any[j]))
    return seen / total


def _causal_pairs(lens, T: int) -> int:
    """(query, key) pairs of a causal self-attention over T positions whose
    keys are valid below each row's length: the products the function needs."""
    q = torch.arange(T, device=lens.device)[None]
    return int(torch.minimum(q + 1, lens[:, None]).sum())


def check_flash_blockwise(dev, g):
    """Row 2 at its main-path shape, score_long's q/k/v [8, 1088, 32, 128] bf16
    (32 launches per call; rows right-padded to 1000-1088 tokens), and at the
    Llama position limit, [8, 2048, 32, 128]: attn.compare_blockwise against
    the plain version (every element within one bf16 step, at most 2 % of them
    apart), which the one-shot class (flash_attention_plain: P rounded to
    bf16) must fail on the same inputs. At the score_long shape also with the
    last row's first 70 keys invalid: its query rows 0..69 see no valid key
    and must give the mean of V over the Tk keys (their blocks visit every key
    tile). Bound: q/k/v/out bytes against the causal, unpadded products these
    rows need; beside it the share of key tiles the kernel's causal tile skip
    leaves it to compute, and the host time of one wrapper call. Library: SDPA
    with a boolean mask on the same bf16 inputs, a time yardstick only (it
    rounds P to bf16)."""
    B, H, Dh = VLM_BATCH, 32, 128
    by_shape = {}
    for name, (T, per_call) in {"score_long": (1088, LAYERS), "llama_limit": (2048, 0),
                                "score_long_masked_rows": (1088, 0)}.items():
        q, k, v = (torch.randn((B, T, H, Dh), generator=g, device=dev).bfloat16() for _ in range(3))
        lens = torch.randint(T - 88, T + 1, (B,), generator=g, device=dev)
        valid = (torch.arange(T, device=dev)[None] < lens[:, None]).int()
        if name == "score_long_masked_rows":
            valid[-1, :70] = 0
        before = attn.KERNEL_LAUNCHES["flash_blockwise"]
        got = attn.flash_attention(q, k, v, valid)
        torch.cuda.synchronize()
        assert attn.KERNEL_LAUNCHES["flash_blockwise"] == before + 1
        want = attn.flash_attention_blockwise_plain(q, k, v, valid)
        stats = attn.compare_blockwise(got, want)
        if name == "score_long_masked_rows":   # the mean of V over the Tk keys
            mean_v = v[-1].float().mean(0).bfloat16()
            stats["masked_rows"] = attn.compare_blockwise(got[-1, :70],
                                                          mean_v[None].expand(70, H, Dh))
        control = attn.flash_attention_plain(q, k, v, valid)
        control_apart = int((control != want).sum())
        try:
            attn.compare_blockwise(control, want)
        except AssertionError:
            pass
        else:
            raise AssertionError("flash_blockwise: the check passed the one-shot class (bf16 P)")
        del control
        ki = torch.arange(T, device=dev)
        sdpa_mask = (valid[:, None, None, :] > 0) & (ki[None, :] <= ki[:, None])[None, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        b, by = bound_ms(_nbytes(q, k, v, got, valid), 4 * H * Dh * _causal_pairs(lens, T), "bf16")
        by_shape[name] = dict(
            launches_per_call=per_call, **stats, control_n_apart=control_apart,
            ms=cuda_ms(lambda: attn.flash_attention(q, k, v, valid)),
            plain_ms=cuda_ms(lambda: attn.flash_attention_blockwise_plain(q, k, v, valid),
                             reps=5, warmup=1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      attn_mask=sdpa_mask)),
            bound_ms=b, bound_by=by,
            all_tiles_bound_ms=bound_ms(0, 4 * B * H * T * T * Dh, "bf16")[0],
            predicted_tile_share=blockwise_predicted_tile_share(valid, T),
            host_us=host_us(lambda: attn.flash_attention(q, k, v, valid)))
        del q, k, v, got, want, qt, kt, vt, sdpa_mask
    main = by_shape["score_long"]
    return dict(name="flash_blockwise", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/flash_blockwise.cu",
                replaces="openvla_probe_tpu/ops/attention.py:37",
                max_abs_err=max(r["max_abs_err"] for r in by_shape.values()),
                **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms")},
                by_shape=by_shape)


def check_vit_attention(dev, g):
    """Row 3 at the tower shapes: DINOv2 [24, 261, 16, 64] (23 launches/call)
    and SigLIP [24, 256, 16, 72] (26 launches/call), as strided views of one
    qkv product like the towers pass them; DINOv2 at its 518 px pretraining
    size, N = 37 x 37 + 1 = 1370 (no path launches it); and ragged N = 1, 65
    and 257 (Dh = 72). bf16 takes the tensor-core route (counted as
    vit_attention) and is held by attn.compare_blockwise (every element within
    one bf16 step of the plain version, at most max(16, 2 %) apart); fp32
    takes the scalar route (vit_attention_scalar), within 1e-5. Bound: the
    bytes of q/k/v/out against one pass of the function's bf16 products,
    4 B H N^2 Dh at 989 TFLOP/s (the kernel computes the function exactly
    with bf16 products)."""
    shapes = {"dinov2": (261, 16, 64, 23), "siglip": (256, 16, 72, 26),
              "dinov2_518px": (1370, 16, 64, 0), "ragged_n1": (1, 16, 64, 0),
              "ragged_n65": (65, 16, 64, 0), "ragged_n257_dh72": (257, 16, 72, 0)}
    by_shape = {}
    for name, (N, H, Dh, per_call) in shapes.items():
        row = {}
        for dtype, route in ((torch.float32, "vit_attention_scalar"),
                             (torch.bfloat16, "vit_attention")):
            qkv = torch.randn((BATCH * N, 3 * H * Dh), generator=g, device=dev).to(dtype)
            q, k, v = (t.reshape(BATCH, N, H, Dh) for t in qkv.split(H * Dh, dim=-1))
            before = attn.KERNEL_LAUNCHES[route]
            got = attn.vit_flash_attention(q, k, v)
            torch.cuda.synchronize()
            assert attn.KERNEL_LAUNCHES[route] == before + 1, (name, route)
            want = attn.vit_flash_attention_plain(q, k, v)
            stats = attn.compare_blockwise(got, want, kernel="vit_attention")
            if dtype == torch.float32:
                row["fp32_max_abs_err"] = stats["max_abs_err"]
                continue
            row.update(stats, launches_per_call=per_call)
            if name.startswith("ragged"):
                continue
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            b, by = bound_ms(_nbytes(q, k, v, got), 4 * BATCH * H * N * N * Dh, "bf16")
            row.update(ms=cuda_ms(lambda: attn.vit_flash_attention(q, k, v)),
                       plain_ms=cuda_ms(lambda: attn.vit_flash_attention_plain(q, k, v)),
                       library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                       bound_ms=b, bound_by=by)
        by_shape[name] = row
    towers = {k: r for k, r in by_shape.items() if r["launches_per_call"]}
    n = sum(r["launches_per_call"] for r in towers.values())

    def per_launch(key):   # mean over the main path's launch mix
        return sum(r[key] * r["launches_per_call"] for r in towers.values()) / n

    return dict(name="vit_attention", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/vit_attention.cu",
                replaces="openvla_probe_tpu/ops/attention.py:255",
                max_abs_err=max(r["max_abs_err"] for r in by_shape.values()),
                ms=per_launch("ms"), plain_ms=per_launch("plain_ms"),
                bound_ms=per_launch("bound_ms"),
                bound_by="/".join(sorted({r["bound_by"] for r in towers.values()})),
                library_ms=per_launch("library_ms"), by_shape=by_shape)


def check_vit_attention_scalar(dev, g):
    """vit_attention's scalar route (fp32, other head dims; the tiny fp32
    paths launch it) at the DINOv2 tower shape in fp32, q/k/v [24, 261, 16,
    64] as strided views of one qkv product, within 1e-5 of the plain
    version (attn.compare_blockwise's fp32 rule). Bound: the fp32 bytes
    against the products at the fp32 rate; library: SDPA in fp32."""
    N, H, Dh = 261, 16, 64
    qkv = torch.randn((BATCH * N, 3 * H * Dh), generator=g, device=dev)
    q, k, v = (t.reshape(BATCH, N, H, Dh) for t in qkv.split(H * Dh, dim=-1))
    got = _launched("vit_attention_scalar", lambda: attn.vit_flash_attention(q, k, v))
    stats = attn.compare_blockwise(got, attn.vit_flash_attention_plain(q, k, v),
                                   kernel="vit_attention")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b, by = bound_ms(_nbytes(q, k, v, got), 4 * BATCH * H * N * N * Dh, "fp32")
    return dict(name="vit_attention_scalar", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/vit_attention.cu",
                replaces="openvla_probe_tpu/ops/attention.py:255",
                max_abs_err=stats["max_abs_err"],
                ms=cuda_ms(lambda: attn.vit_flash_attention(q, k, v)),
                plain_ms=cuda_ms(lambda: attn.vit_flash_attention_plain(q, k, v)),
                bound_ms=b, bound_by=by,
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)))


def check_flash_prefill_scalar(dev, g):
    """flash_prefill's scalar route (fp32, head dims other than 64 / 128,
    unaligned rows; the tiny fp32 paths launch it) at score_short's shape in
    fp32, q/k/v [8, 320, 32, 128], right-padded rows, within
    attn.compare_oneshot's fp32 rule (1e-5) of the plain version. Bound: the
    fp32 bytes against the causal products at the fp32 rate; library: SDPA
    in fp32 with the same boolean mask."""
    B, T, H, Dh = VLM_BATCH, 320, 32, 128
    q, k, v = (torch.randn((B, T, H, Dh), generator=g, device=dev) for _ in range(3))
    lens = torch.randint(T - 31, T + 1, (B,), generator=g, device=dev)
    valid = (torch.arange(T, device=dev)[None] < lens[:, None]).int()
    got = _launched("flash_prefill_scalar", lambda: attn.flash_attention(q, k, v, valid))
    stats = attn.compare_oneshot(got, attn.flash_attention_plain(q, k, v, valid))
    ki = torch.arange(T, device=dev)
    mask = (valid[:, None, None, :] > 0) & (ki[None, :] <= ki[:, None])[None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b, by = bound_ms(_nbytes(q, k, v, got, valid), 4 * H * Dh * _causal_pairs(lens, T), "fp32")
    return dict(name="flash_prefill_scalar", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/flash_prefill.cu",
                replaces="openvla_probe_tpu/ops/attention.py:88",
                max_abs_err=stats["max_abs_err"],
                ms=cuda_ms(lambda: attn.flash_attention(q, k, v, valid)),
                plain_ms=cuda_ms(lambda: attn.flash_attention_plain(q, k, v, valid), reps=10),
                bound_ms=b, bound_by=by,
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                          attn_mask=mask)))


def check_wi8_matmul_scalar(dev, g):
    """wi8_matmul's scalar route (fp32 x; the tiny fp32 pallas paths launch
    it) at the pallas decode shape in fp32, x [24, 4096] against int8 codes
    [4096, 4096], by lin.compare_wi8 (fp32 within 1e-4 + 1e-4 |want|).
    Bound: the fp32 x, int8 weight and output bytes against the products at
    the fp32 rate; library: fp32 x @ w_f32ᵀ on weights dequantized
    beforehand (full fp32, no TF32)."""
    M, K, N = BATCH, 4096, 4096
    x = torch.randn((M, K), generator=g, device=dev)
    sets = [(x, torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8),
             torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-3)
            for _ in range(copies_past_l2(N * K))]
    got = _launched("wi8_matmul_scalar", lambda: lin.wi8_matmul(*sets[0]))
    stats = lin.compare_wi8(got, lin.wi8_matmul_plain(*sets[0]))
    w_f32 = [(x, lin.dequantize_weight({"q": q, "s": s}, torch.float32)) for _, q, s in sets]
    b, by = bound_ms(_nbytes(x, sets[0][1], sets[0][2], got), 2 * M * N * K, "fp32")
    return dict(name="wi8_matmul_scalar", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/wi8_matmul.cu",
                replaces="openvla_probe_tpu/ops/linear.py:327",
                max_abs_err=stats["max_abs_err"], ms=cuda_ms(rotating(lin.wi8_matmul, sets)),
                plain_ms=cuda_ms(rotating(lin.wi8_matmul_plain, sets)),
                bound_ms=b, bound_by=by,
                library_ms=cuda_ms(rotating(lambda a, w: a @ w.t(), w_f32)))


def _decode_inputs(B, T, S, slot, H, Dh, g, dev, dtype=torch.bfloat16, copies=2):
    """A stacked-cache decode step: q [B, 1, H, Dh]; `copies` layers of k/v
    [B, S, H, Dh] (timed in turn, past the L2); padded prompts of T - 12 .. T
    tokens, then the generated slots up to `slot`."""
    q = torch.randn((B, 1, H, Dh), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((copies, B, S, H, Dh), generator=g, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, kernel_ab.decode_valid(B, T, S, slot, g, dev)


def _decode_bound(q, k, v, valid, slot, kind: str):
    """decode_attention's bound: the bytes and products of the keys up to the
    query's slot (the rest are masked in every row that has a valid key
    there), q, out and their validity."""
    n = min(k.shape[1], slot + 1)
    B, _, H, Dh = q.shape
    return bound_ms(_nbytes(q, k[:, :n], v[:, :n], q, valid[:, :n]), 4 * B * H * n * Dh, kind)


def _by_cluster_size(kernel: str, call, sets) -> dict:
    """Device ms of `kernel`'s ring launcher at its cluster rule and at 1, 2
    and 4 CTAs a (b, h), on the rotated input sets (uncounted launches)."""
    fns = {"rule": _build.launcher(kernel), **kernel_ab.cluster_launchers(kernel)}
    return {str(cs): cuda_ms(rotating(lambda *a: call(fn, *a), sets)) for cs, fn in fns.items()}


def _hold_decode(got, q, k, v, valid, slot, sd) -> dict:
    """decode_attention's tolerances: fp32 scores within 2e-2 of the plain
    version, bf16 scores by attn.compare_bf16_scores."""
    want = attn.decode_attention_plain(q, k, v, valid, slot, sd)
    if sd == torch.bfloat16:
        return attn.compare_bf16_scores(
            got, want, attn.decode_attention_plain(q, k, v, valid, slot, torch.float32))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    return dict(max_abs_err=(got.float() - want.float()).abs().max().item())


def _launched(kernel: str, fn):
    """fn(), asserting it launched `kernel` once (the route the shape takes)."""
    before = _build.KERNEL_LAUNCHES[kernel]
    out = fn()
    torch.cuda.synchronize()
    assert _build.KERNEL_LAUNCHES[kernel] == before + 1, kernel
    return out


def check_decode_attention(dev, g):
    """The decode-step attention's ring route (bf16, Dh = 128) at the 7B
    shapes: serving, q [24, 1, 32, 128] over one layer of the stacked cache,
    k/v [24, 295, 32, 128], the query at slot 291 (the fourth decode step), in
    its two score types (fp32: parity, bf16: turbo and turbo_nibble; 192
    launches per call each; one CTA a (b, h)); generate's, B = 8 over S = 352
    (T 320 + 32 new tokens), slot 335, fp32 scores (992 launches a generate
    call; one CTA a (b, h)); generate's single row (generate_text; keys split
    over a 4-CTA cluster: 96, 96, 96, 48 of the 336 up to the slot), timed at
    the cluster rule beside 1, 2 and 4 CTAs a (b, h). Edge cases, checked
    untimed: generate's first step (slot 320, 31 keys past it), S = 37 over 2
    rows of 16 heads (4 CTAs of 16, 16, 5 and no key: ranges that are no
    multiple of the chunk or of the split), and at every shape a row whose
    keys are all masked but BOS (its output is V's first row) and a row masked
    everywhere (the mean of all S values of V, keys past the slot included).
    fp32 scores within 2e-2 of the plain version; bf16 scores by
    attn.compare_bf16_scores (within 4e-3, and on average at most a tenth as
    far from it as from the fp32-score plain version). Bound: the keys up to
    the slot (_decode_bound). Library: SDPA with the same boolean mask (P not
    rounded)."""
    Dh = 128
    shapes = {"serving": (BATCH, T_PREFILL, T_PREFILL + ACTION_DIM, T_PREFILL + 3, 32,
                          ("fp32", "bf16"), LAYERS * (ACTION_DIM - 1)),
              "generate": (VLM_BATCH, 320, 320 + GEN_NEW_TOKENS, 335, 32, ("fp32",),
                           LAYERS * (GEN_NEW_TOKENS - 1)),
              "generate_1row": (1, 320, 320 + GEN_NEW_TOKENS, 335, 32, ("fp32",), 0),
              "generate_first_step": (VLM_BATCH, 320, 320 + GEN_NEW_TOKENS, 320, 32,
                                      ("fp32", "bf16"), 0),
              "ragged_cluster": (2, 30, 37, 30, 16, ("fp32", "bf16"), 0)}
    by_mode = {}
    for name, (B, T, S, slot, H, modes, per_call) in shapes.items():
        q, k, v, valid = _decode_inputs(B, T, S, slot, H, Dh, g, dev)
        bos_only, masked = valid.clone(), valid.clone()
        bos_only[-1, 1:] = 0
        masked[-1] = 0
        slots = torch.arange(S, device=dev)[None]
        sdpa_mask = ((valid > 0) & (slots <= slot))[:, None, None, :]
        sets = [(q, k[i], v[i], valid, slot) for i in range(2)]
        lib_sets = [(q.transpose(1, 2), k[i].transpose(1, 2), v[i].transpose(1, 2))
                    for i in range(2)]
        for mode in modes:
            sd = torch.bfloat16 if mode == "bf16" else torch.float32
            row = dict(launches_per_call=per_call)
            for vv, tag in ((valid, ""), (bos_only, "bos_only_row_"), (masked, "masked_row_")):
                got = _launched("decode_attention", lambda: attn.decode_attention(
                    q, k[0], v[0], vv, slot, sd))
                stats = _hold_decode(got, q, k[0], v[0], vv, slot, sd)
                row.update({tag + key: val for key, val in stats.items()})
                if tag == "bos_only_row_":
                    torch.testing.assert_close(got[-1].float(), v[0][-1, :1].float(), atol=2e-2,
                                               rtol=0)
            torch.testing.assert_close(got[-1].float(), v[0][-1].float().mean(0, keepdim=True),
                                       atol=2e-2, rtol=0)
            if per_call or name == "generate_1row":
                b, by = _decode_bound(q, k[0], v[0], valid, slot, "bf16")
                row.update(bound_ms=b, bound_by=by, ms=cuda_ms(rotating(
                    lambda *a: attn.decode_attention(*a, sd), sets)))
            if per_call:
                row.update(
                    plain_ms=cuda_ms(rotating(lambda *a: attn.decode_attention_plain(*a, sd),
                                              sets)),
                    library_ms=cuda_ms(rotating(lambda qt, kt, vt: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=sdpa_mask), lib_sets)))
            if name == "generate_1row":
                row["ms_by_cluster_size"] = _by_cluster_size(
                    "decode_attention", kernel_ab.call_decode_attention,
                    [(*a, int(sd == torch.bfloat16)) for a in sets])
            row["max_abs_err"] = max(val for key, val in row.items() if key.endswith("max_abs_err"))
            by_mode[f"{name}_{mode}_scores"] = row
        del q, k, v, sets, lib_sets
    serving = {m: r["launches_per_call"] for m, r in by_mode.items() if m.startswith("serving")}
    mix = _launch_weighted({m: by_mode[m] for m in serving}, serving)
    mix["max_abs_err"] = max(r["max_abs_err"] for r in by_mode.values())
    return dict(name="decode_attention", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/decode_attention.cu",
                replaces="openvla_probe_tpu/models/llama.py:225", by_mode=by_mode, **mix)


def check_decode_attention_scalar(dev, g):
    """decode_attention's scalar route (fp32, other head dims, unaligned rows;
    the tiny fp32 paths launch it) at the serving decode's shape in fp32,
    q [24, 1, 32, 128] over k/v [24, 295, 32, 128], and at Dh = 72 in bf16,
    both score types: fp32 scores within 1e-5 on fp32 inputs and 2e-2 on bf16
    ones, bf16 scores by attn.compare_bf16_scores.
    Bound: the fp32 bytes; library: SDPA in fp32 with the same mask."""
    B, T, S, slot, H = BATCH, T_PREFILL, T_PREFILL + ACTION_DIM, T_PREFILL + 3, 32
    q, k, v, valid = _decode_inputs(B, T, S, slot, H, 128, g, dev, torch.float32)
    row = {}
    got = _launched("decode_attention_scalar",
                    lambda: attn.decode_attention(q, k[0], v[0], valid, slot, torch.float32))
    want = attn.decode_attention_plain(q, k[0], v[0], valid, slot, torch.float32)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    row["fp32_fp32_scores_max_abs_err"] = (got - want).abs().max().item()
    got = _launched("decode_attention_scalar",
                    lambda: attn.decode_attention(q, k[0], v[0], valid, slot, torch.bfloat16))
    row["fp32_bf16_scores_max_abs_err"] = _hold_decode(got, q, k[0], v[0], valid, slot,
                                                       torch.bfloat16)["max_abs_err"]
    q72, k72, v72, valid72 = _decode_inputs(4, 30, 37, 30, 8, 72, g, dev, copies=1)
    for sd in (torch.float32, torch.bfloat16):
        got = _launched("decode_attention_scalar", lambda: attn.decode_attention(
            q72, k72[0], v72[0], valid72, 30, sd))
        row[f"dh72_{'bf16' if sd == torch.bfloat16 else 'fp32'}_scores_max_abs_err"] = \
            _hold_decode(got, q72, k72[0], v72[0], valid72, 30, sd)["max_abs_err"]
    slots = torch.arange(S, device=dev)[None]
    sdpa_mask = ((valid > 0) & (slots <= slot))[:, None, None, :]
    sets = [(q, k[i], v[i], valid, slot) for i in range(2)]
    lib_sets = [(q.transpose(1, 2), k[i].transpose(1, 2), v[i].transpose(1, 2)) for i in range(2)]
    b, by = _decode_bound(q, k[0], v[0], valid, slot, "fp32")
    return dict(name="decode_attention_scalar", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/decode_attention.cu",
                replaces="openvla_probe_tpu/models/llama.py:225", by_check=row,
                max_abs_err=max(row.values()),
                ms=cuda_ms(rotating(attn.decode_attention, sets)),
                plain_ms=cuda_ms(rotating(attn.decode_attention_plain, sets)),
                bound_ms=b, bound_by=by,
                library_ms=cuda_ms(rotating(lambda qt, kt, vt: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask), lib_sets)))


def _launch_weighted(by_shape: dict, per_call: dict) -> dict:
    """Per-launch means over a kernel's main-path launch mix (the shapes in
    `per_call`; max_abs_err and bound_by over every shape checked)."""
    n = sum(per_call.values())
    out = {key: sum(by_shape[s][key] * per_call[s] for s in per_call) / n
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    out["max_abs_err"] = max(r["max_abs_err"] for r in by_shape.values())
    out["bound_by"] = "/".join(sorted({r["bound_by"] for r in by_shape.values()}))
    return out


def check_wi8_matmul(dev, g):
    """Row 7 at every (M, K, N) of the pallas path: prefill M = 24 x 288 = 6912
    and decode / lm_head M = 24; and SigLIP's fc2 on pallas_int4, M = 6144,
    K = 4304 (a partial last k tile), N = 1152. bf16 x, int8 codes, fp32
    scales; lin.compare_wi8 against the plain version (exact products, fp32
    sums in another order, then one bf16 rounding: every element within one
    bf16 step, at most max(16, 2 %) apart). Library: cuBLAS bf16 x @ w_bf16ᵀ
    on weights dequantized beforehand (it leaves out the dequantization and
    streams 2x the weight bytes)."""
    M_pre, M_dec, A1 = BATCH * T_PREFILL, BATCH, ACTION_DIM - 1
    per_call = {(M_pre, 4096, 4096): 4 * LAYERS, (M_pre, 4096, 11008): 2 * LAYERS,
                (M_pre, 11008, 4096): LAYERS, (M_dec, 4096, 4096): 4 * LAYERS * A1,
                (M_dec, 4096, 11008): 2 * LAYERS * A1, (M_dec, 11008, 4096): LAYERS * A1,
                (M_dec, 4096, 32064): 1 + A1}
    by_shape = {}
    for (M, K, N) in (*per_call, (BATCH * 256, 4304, 1152)):
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = []
        for _ in range(copies_past_l2(N * K)):
            q = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8)
            s = torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-3
            sets.append((x, q, s))
        before = _build.KERNEL_LAUNCHES["wi8_matmul"]
        got = lin.wi8_matmul(*sets[0])
        torch.cuda.synchronize()
        assert _build.KERNEL_LAUNCHES["wi8_matmul"] == before + 1
        stats = lin.compare_wi8(got, lin.wi8_matmul_plain(*sets[0]))
        w_bf16 = [(x, lin.dequantize_weight({"q": q, "s": s})) for x, q, s in sets]
        b, by = bound_ms(_nbytes(x, sets[0][1], sets[0][2], got), 2 * M * N * K, "bf16")
        by_shape[f"{M}x{K}x{N}"] = dict(
            launches_per_call=per_call.get((M, K, N), 0), **stats,
            ms=cuda_ms(rotating(lin.wi8_matmul, sets)),
            plain_ms=cuda_ms(rotating(lin.wi8_matmul_plain, sets), reps=5, warmup=1),
            library_ms=cuda_ms(rotating(lambda a, w: a @ w.t(), w_bf16)),
            bound_ms=b, bound_by=by)
        del sets, w_bf16, got
    mix = _launch_weighted(by_shape, {f"{M}x{K}x{N}": n for (M, K, N), n in per_call.items()})
    return dict(name="wi8_matmul", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/wi8_matmul.cu",
                replaces="openvla_probe_tpu/ops/linear.py:327", by_shape=by_shape, **mix)


def _int_mm_dot(codes, q):
    """The library yardstick of the w8a8 products: cuBLASLt int8 GEMM."""
    return torch._int_mm(codes, q.t()).float()


def _tower_weight(n, k, g, dev):
    return lin.quantize_weight(torch.randn((n, k), generator=g, device=dev) * 0.02)


LN_W8A8_LAUNCHES = {"fused_ln_w8a8_quant_rows": 1, "fused_ln_w8a8": 1}
MLP_LAUNCHES = {"fused_mlp_ln_quant_rows": 1, "fused_mlp_fc1": 1, "fused_mlp_quant_rows": 1,
                "fused_mlp_residual": 1}


def _launch_diff(fn):
    """fn() and the launches it made, by name."""
    before = dict(_build.KERNEL_LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in _build.KERNEL_LAUNCHES.items() if n != before[k]}


def _ln_w8a8_inputs(M, K, N, form, g, dev, dtype=torch.bfloat16):
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    w = _tower_weight(N, K, g, dev)
    b = (torch.randn((N,), generator=g, device=dev) * 0.1).to(dtype)
    kw = {}
    if form == "ln":
        kw["ln"] = ((1 + 0.1 * torch.randn((K,), generator=g, device=dev)).to(dtype),
                    (0.1 * torch.randn((K,), generator=g, device=dev)).to(dtype))
    else:
        kw["res"] = torch.randn((M, N), generator=g, device=dev).to(dtype)
        if form == "res_ls":
            kw["ls"] = torch.randn((N,), generator=g, device=dev).to(dtype)
    return x, w, b, kw


def _hold_ln_w8a8(x, w, b, kw, name):
    """vmlp.compare_ln_w8a8, one call launching exactly its pre-pass and GEMM;
    bit-equal to the plain version outright where there is no LayerNorm."""
    (got, stats), launched = _launch_diff(lambda: vmlp.compare_ln_w8a8(x, w, b, **kw))
    assert launched == LN_W8A8_LAUNCHES, (name, launched)
    want = vmlp.fused_ln_w8a8_plain(x, w, b, **kw)
    if "ln" not in kw:
        assert torch.equal(got, want), f"{name}: not bit-equal to the plain version"
    return got, want, dict(stats, max_abs_err=(got.float() - want.float()).abs().max().item(),
                           equal_share=(got == want).float().mean().item())


def check_fused_ln_w8a8(dev, g):
    """Row 10 at its four call forms: each tower's qkv entry (LN1 first) and
    proj exit (residual; DINOv2's LayerScale). The kernel's activation codes
    within one step of the plain version's, and its output bit-equal to the
    plain version's on its own codes (vmlp.compare_ln_w8a8); without a
    LayerNorm the codes are equal, so the output equals the plain version's
    bit for bit. Each call launches its pre-pass and its GEMM once
    (LN_W8A8_LAUNCHES). Library: the plain version with torch._int_mm for the
    integer product (it leaves the LayerNorm, quantize and epilogue as
    separate passes). Untimed edge cases, held the same way: M = 1 and 64 (the
    decode route), 65 and 257 (the wgmma route's first rows), N tails (200:
    inside a 128-row weight tile; 36: no multiple of 8, scalar stores), and
    the four forms in fp32. The host time of one wrapper call at DINOv2's qkv."""
    forms = {"dinov2_qkv": (6264, 1024, 3072, "ln", 23), "dinov2_proj": (6264, 1024, 1024, "res_ls", 23),
             "siglip_qkv": (6144, 1152, 3456, "ln", 26), "siglip_proj": (6144, 1152, 1152, "res", 26)}
    by_shape = {}
    host = None
    for name, (M, K, N, form, per_call) in forms.items():
        x, w, b, kw = _ln_w8a8_inputs(M, K, N, form, g, dev)
        got, want, stats = _hold_ln_w8a8(x, w, b, kw, name)
        with mock.patch.object(vmlp, "int8_dot", _int_mm_dot):
            lib = cuda_ms(lambda: vmlp.fused_ln_w8a8_plain(x, w, b, **kw))
        nbytes = _nbytes(x, w["q"], w["s"], b, got, *kw.get("ln", ()), *(
            [kw["res"]] if "res" in kw else []), *([kw["ls"]] if "ls" in kw else []))
        bnd, by = bound_ms(nbytes, 2 * M * N * K, "int8")
        by_shape[name] = dict(
            launches_per_call=per_call, **stats,
            ms=cuda_ms(lambda: vmlp.fused_ln_w8a8(x, w, b, **kw)),
            plain_ms=cuda_ms(lambda: vmlp.fused_ln_w8a8_plain(x, w, b, **kw), reps=5, warmup=1),
            library_ms=lib, bound_ms=bnd, bound_by=by)
        if host is None:
            host = host_us(lambda: vmlp.fused_ln_w8a8(x, w, b, **kw))
        del x, w, b, kw, got, want
    edges = {}
    for name, (M, K, N, form, dtype) in {
            "m1_dinov2_qkv": (1, 1024, 3072, "ln", torch.bfloat16),
            "m64_dinov2_proj": (64, 1024, 1024, "res_ls", torch.bfloat16),
            "m65_siglip_proj": (65, 1152, 1152, "res", torch.bfloat16),
            "m257_siglip_qkv": (257, 1152, 3456, "ln", torch.bfloat16),
            "n200_tail": (300, 64, 200, "res_ls", torch.bfloat16),
            "n36_not_8": (100, 64, 36, "res", torch.bfloat16),
            **{f"fp32_{k}": (*v[:4], torch.float32) for k, v in forms.items()}}.items():
        x, w, b, kw = _ln_w8a8_inputs(M, K, N, form, g, dev, dtype)
        edges[name] = _hold_ln_w8a8(x, w, b, kw, name)[2]
        del x, w, b, kw
    mix = _launch_weighted(by_shape, {k: v[4] for k, v in forms.items()})
    return dict(name="fused_ln_w8a8", route="cuda", source="openvla_probe_tpu_torch/ops/csrc/vit_mlp.cu",
                replaces="openvla_probe_tpu/ops/vit_mlp.py:123", by_shape=by_shape,
                edge_cases=edges, host_us_per_call=host, launches_per_wrapper_call=LN_W8A8_LAUNCHES,
                **mix)


def _mlp_inputs(M, D, F_, layerscale, g, dev, dtype=torch.bfloat16):
    cast = lambda t: t.to(dtype)
    x = cast(torch.randn((M, D), generator=g, device=dev))
    ln = (cast(1 + 0.1 * torch.randn((D,), generator=g, device=dev)),
          cast(0.1 * torch.randn((D,), generator=g, device=dev)))
    fc1, fc2 = _tower_weight(F_, D, g, dev), _tower_weight(D, F_, g, dev)
    b1 = cast(0.1 * torch.randn((F_,), generator=g, device=dev))
    b2 = cast(0.1 * torch.randn((D,), generator=g, device=dev))
    ls2 = cast(torch.randn((D,), generator=g, device=dev)) if layerscale else \
        torch.ones((D,), dtype=dtype, device=dev)
    return (x, *ln, fc1, b1, fc2, b2, ls2)


def _hold_mlp(args, name, act="gelu_tanh"):
    """vmlp.compare_mlp_residual, one call launching exactly its two pre-passes
    and two GEMMs (MLP_LAUNCHES)."""
    (got, stats), launched = _launch_diff(lambda: vmlp.compare_mlp_residual(*args, act=act))
    assert launched == MLP_LAUNCHES, (name, launched)
    want = vmlp.fused_mlp_residual_plain(*args, act=act)
    return got, want, dict(stats, max_abs_err=(got.float() - want.float()).abs().max().item(),
                           equal_share=(got == want).float().mean().item())


def check_fused_mlp_residual(dev, g):
    """Row 11 at both towers' MLP halves (turbo act gelu_tanh): DINOv2 with
    LayerScale, SigLIP (F = 4304 = 16 x 269) with ones; both activation codes
    within one step of the plain version's and the output bit-equal to the
    plain version's on the kernel's own codes (vmlp.compare_mlp_residual),
    each call launching its two pre-passes and two GEMMs once (MLP_LAUNCHES).
    Library: the plain version with torch._int_mm for both integer products.
    Untimed edge cases, held the same way: M = 1 and 64 (the decode route),
    65 and 257 at DINOv2's widths, F = 8208 (past the earlier kernel's 8192),
    both towers in fp32, and the erf and quick GELU. The host time of one
    wrapper call at DINOv2."""
    towers = {"dinov2": (6264, 1024, 4096, True), "siglip": (6144, 1152, 4304, False)}
    by_shape = {}
    host = None
    for name, (M, D, F_, layerscale) in towers.items():
        args = _mlp_inputs(M, D, F_, layerscale, g, dev)
        got, want, stats = _hold_mlp(args, name)
        with mock.patch.object(vmlp, "int8_dot", _int_mm_dot):
            lib = cuda_ms(lambda: vmlp.fused_mlp_residual_plain(*args))
        x, ln_s, ln_b, fc1, b1, fc2, b2, ls2 = args
        bnd, by = bound_ms(_nbytes(x, ln_s, ln_b, fc1["q"], fc1["s"], b1, fc2["q"], fc2["s"], b2,
                                   ls2, got), 4 * M * D * F_, "int8")
        by_shape[name] = dict(
            launches_per_call=TOWER_LAUNCHES[name], **stats,
            ms=cuda_ms(lambda: vmlp.fused_mlp_residual(*args)),
            plain_ms=cuda_ms(lambda: vmlp.fused_mlp_residual_plain(*args), reps=5, warmup=1),
            library_ms=lib, bound_ms=bnd, bound_by=by)
        if host is None:
            host = host_us(lambda: vmlp.fused_mlp_residual(*args))
        del args, x, fc1, fc2, got, want
    edges = {}
    for name, (M, D, F_, layerscale, dtype, act) in {
            "m1_dinov2": (1, 1024, 4096, True, torch.bfloat16, "gelu_tanh"),
            "m64_siglip": (64, 1152, 4304, False, torch.bfloat16, "gelu_tanh"),
            "m65_dinov2": (65, 1024, 4096, True, torch.bfloat16, "gelu"),
            "m257_dinov2": (257, 1024, 4096, True, torch.bfloat16, "quick_gelu"),
            "f8208": (257, 1024, 8208, True, torch.bfloat16, "gelu_tanh"),
            "fp32_dinov2": (6264, 1024, 4096, True, torch.float32, "gelu_tanh"),
            "fp32_siglip": (6144, 1152, 4304, False, torch.float32, "gelu_tanh")}.items():
        args = _mlp_inputs(M, D, F_, layerscale, g, dev, dtype)
        edges[name] = _hold_mlp(args, name, act)[2]
        del args
    mix = _launch_weighted(by_shape, TOWER_LAUNCHES)
    return dict(name="fused_mlp_residual", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/vit_mlp.cu",
                replaces="openvla_probe_tpu/ops/vit_mlp.py:62", by_shape=by_shape,
                edge_cases=edges, host_us_per_call=host, launches_per_wrapper_call=MLP_LAUNCHES,
                **mix)


def _split_inputs(B, T, A, step, H, Dh, g, dev, dtype=torch.bfloat16, copies=2):
    """A frozen-KV decode step: q [B, 1, H, Dh]; `copies` layer slices of
    stacked kp/vp [B, T, H, Dh] and kd/vd [B, A, H, Dh]; padded prompts of
    T - 12 .. T tokens; the generated slots up to `step`."""
    kp, vp = (torch.randn((copies, B, T, H, Dh), generator=g, device=dev).to(dtype)
              for _ in range(2))
    kd, vd = (torch.randn((copies, B, A, H, Dh), generator=g, device=dev).to(dtype)
              for _ in range(2))
    q = torch.randn((B, 1, H, Dh), generator=g, device=dev).to(dtype)
    mm_len = torch.randint(T - 12, T + 1, (B,), generator=g, device=dev)
    pre = (torch.arange(T, device=dev)[None] < mm_len[:, None]).int()
    dec = (torch.arange(A, device=dev) <= step).int()[None].expand(B, A).contiguous()
    return [(q, kp[i], vp[i], kd[i], vd[i], pre, dec) for i in range(copies)]


def check_decode_split_attention(dev, g):
    """Row 4's ring route (bf16, Dh = 128) at the 7B decode shape: q [24, 1,
    32, 128] over one layer of the frozen prefill K/V [24, 288, 32, 128] and of
    the generated K/V [24, 6, 32, 128] (strided layer slices of stacked
    buffers), padded prompts, decode step 3 (one CTA a (b, h)); within 2e-2 of
    the plain version (bf16). A single row (a one-observation pallas call;
    keys split over a 4-CTA cluster), timed at the cluster rule beside 1, 2
    and 4 CTAs a (b, h). Edge cases, checked untimed: T = 283 over 2 rows
    (2-CTA clusters; the prefill / generated boundary inside a chunk), and at
    every shape a row whose keys are all masked but BOS (its output is Vp's
    first row). Library: SDPA on K/V concatenated beforehand (it leaves out
    the concatenation and rounds P to bf16)."""
    B, T, A, H, Dh = BATCH, T_PREFILL, ACTION_DIM - 1, 32, 128
    by_shape = {}
    for name, (b_, t_) in {"serving": (B, T), "boundary_in_chunk": (2, 283),
                           "one_row": (1, T)}.items():
        sets = _split_inputs(b_, t_, A, 3, H, Dh, g, dev)
        q, kp, vp, kd, vd, pre, dec = sets[0]
        edge_pre, edge_dec = pre.clone(), dec.clone()
        edge_pre[-1, 1:] = 0
        edge_dec[-1] = 0
        errs = []
        for pv, dv in ((pre, dec), (edge_pre, edge_dec)):
            args = (q, kp, vp, kd, vd, pv, dv)
            got = _launched("decode_split_attention", lambda: dattn.decode_flash_attention(*args))
            want = dattn.decode_flash_attention_plain(*args)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
            errs.append((got.float() - want.float()).abs().max().item())
        torch.testing.assert_close(got[-1].float(), vp[-1, :1].float(), atol=2e-2, rtol=0)
        by_shape[name] = dict(max_abs_err=errs[0], bos_only_row_max_abs_err=errs[1])
        if name == "boundary_in_chunk":
            continue
        b, by = bound_ms(_nbytes(q, kp, vp, kd, vd, pre, dec, got), 4 * b_ * H * (t_ + A) * Dh,
                         "fp32")
        by_shape[name].update(ms=cuda_ms(rotating(dattn.decode_flash_attention, sets)),
                              bound_ms=b, bound_by=by)
        if name == "one_row":
            by_shape[name]["ms_by_cluster_size"] = _by_cluster_size(
                "decode_split_attention", kernel_ab.call_decode_split, sets)
            continue
        sdpa_mask = torch.cat([pre, dec], dim=1).bool()[:, None, None, :]
        lib_sets = [(q.transpose(1, 2), torch.cat([s[1], s[3]], 1).transpose(1, 2),
                     torch.cat([s[2], s[4]], 1).transpose(1, 2)) for s in sets]
        by_shape[name].update(
            launches_per_call=LAYERS * A,
            plain_ms=cuda_ms(rotating(dattn.decode_flash_attention_plain, sets)),
            library_ms=cuda_ms(rotating(lambda qt, kt, vt: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask), lib_sets)))
        del lib_sets
    main = by_shape["serving"]
    return dict(name="decode_split_attention", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/decode_split_attention.cu",
                replaces="openvla_probe_tpu/ops/decode_attention.py:33",
                max_abs_err=max(max(r["max_abs_err"], r["bos_only_row_max_abs_err"])
                                for r in by_shape.values()),
                **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms")},
                by_shape=by_shape)


def check_decode_split_attention_scalar(dev, g):
    """Row 4's scalar route (fp32, other head dims, unaligned rows; the tiny
    fp32 pallas paths launch it) at the 7B decode shape in fp32, within 1e-5
    of the plain version, and at Dh = 72 in bf16 within 2e-2. Bound: the fp32
    bytes; library: SDPA in fp32 on K/V concatenated beforehand."""
    B, T, A, H, Dh = BATCH, T_PREFILL, ACTION_DIM - 1, 32, 128
    sets = _split_inputs(B, T, A, 3, H, Dh, g, dev, torch.float32)
    got = _launched("decode_split_attention_scalar",
                    lambda: dattn.decode_flash_attention(*sets[0]))
    want = dattn.decode_flash_attention_plain(*sets[0])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    err = (got - want).abs().max().item()
    args72 = _split_inputs(4, 30, A, 3, 8, 72, g, dev, copies=1)[0]
    got72 = _launched("decode_split_attention_scalar",
                      lambda: dattn.decode_flash_attention(*args72))
    want72 = dattn.decode_flash_attention_plain(*args72)
    torch.testing.assert_close(got72.float(), want72.float(), atol=2e-2, rtol=2e-2)
    q, kp, vp, kd, vd, pre, dec = sets[0]
    sdpa_mask = torch.cat([pre, dec], dim=1).bool()[:, None, None, :]
    lib_sets = [(q.transpose(1, 2), torch.cat([s[1], s[3]], 1).transpose(1, 2),
                 torch.cat([s[2], s[4]], 1).transpose(1, 2)) for s in sets]
    b, by = bound_ms(_nbytes(q, kp, vp, kd, vd, pre, dec, got), 4 * B * H * (T + A) * Dh, "fp32")
    return dict(name="decode_split_attention_scalar", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/decode_split_attention.cu",
                replaces="openvla_probe_tpu/ops/decode_attention.py:33",
                max_abs_err=max(err, (got72.float() - want72.float()).abs().max().item()),
                ms=cuda_ms(rotating(dattn.decode_flash_attention, sets)),
                plain_ms=cuda_ms(rotating(dattn.decode_flash_attention_plain, sets)),
                bound_ms=b, bound_by=by,
                library_ms=cuda_ms(rotating(lambda qt, kt, vt: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask), lib_sets)))


def _stacked_inputs(B, S, H, Hkv, T, slot, g, dev, dtype=torch.bfloat16):
    """Two layers of an int8 stacked cache (kq/vq [2, B, S, Hkv·128], ks/vs [2, B,
    S, Hkv]), q [B, 1, H, 128], padded prompts of T - 12 .. T tokens, then the
    generated slots up to `slot`."""
    kq, vq = (torch.randint(-127, 128, (2, B, S, Hkv * 128), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((2, B, S, Hkv), generator=g, device=dev) * 0.02 + 1e-3 for _ in range(2))
    q = torch.randn((B, 1, H, 128), generator=g, device=dev).to(dtype)
    return q, kq, ks, vq, vs, kernel_ab.decode_valid(B, T, S, slot, g, dev)


def check_stacked_decode_i8(dev, g):
    """Row 5's ring route (bf16 q at Dh = 128) at the 7B decode shape: q [24, 1,
    32, 128] over one layer of the int8 stacked cache, kq/vq [2, 24, 320, 4096]
    int8, ks/vs [2, 24, 320, 32] fp32 (S = 295 rounded up to 32s), padded
    prompts, at decode steps 0 and 5 (the query at slot 288 and 293; the kernel
    reads the slots up to it, n = slot + 1, as llama.decode_step_stacked_i8
    passes); timed alternating the two layers (63 MB each, past L2). Within 2e-2
    of the plain version (bf16 outputs), also with a row masked everywhere (the
    mean of V over all S) and at GQA n_rep 4 (8 heads over 2 kv heads). A single
    row (a one-observation call: a 4-CTA cluster a (b, kv head)) timed at the
    cluster rule beside 1, 2 and 4 CTAs. Bound: the bytes of the slots read.
    Library: SDPA on K/V dequantized to bf16 beforehand (it leaves out the
    dequantization and rounds P to bf16)."""
    B, T, S, H = BATCH, T_PREFILL, 320, 32
    by_step = {}
    for name, (b_, h_, hkv, t) in {"step0": (B, H, H, 0), "step5": (B, H, H, ACTION_DIM - 2),
                                   "gqa4": (4, 32, 8, 3), "one_row": (1, H, H, ACTION_DIM - 2)
                                   }.items():
        slot = T + t
        q, kq, ks, vq, vs, valid = _stacked_inputs(b_, S, h_, hkv, T, slot, g, dev)
        sets = [(q, kq, ks, vq, vs, valid, li, slot + 1) for li in (1, 0)]
        masked = valid.clone()
        masked[-1] = 0
        errs = []
        for vv in (valid, masked):
            args = (q, kq, ks, vq, vs, vv, 1, slot + 1)
            got = _launched("stacked_decode_attention_i8",
                            lambda: dattn.stacked_decode_attention_i8(*args))
            want = dattn.stacked_decode_attention_i8_plain(*args)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
            errs.append((got.float() - want.float()).abs().max().item())
        mean_v = (vq[1, -1].reshape(S, hkv, 128).float() * vs[1, -1][..., None]).mean(0)
        torch.testing.assert_close(got[-1, 0].float(),
                                   torch.repeat_interleave(mean_v, h_ // hkv, 0),
                                   atol=2e-2, rtol=0)
        row = dict(max_abs_err=errs[0], masked_row_max_abs_err=errs[1], keys_read=slot + 1)
        by_step[name] = row
        if name == "gqa4":
            continue
        n = slot + 1
        b, by = bound_ms(_nbytes(q, kq[1, :, :n], vq[1, :, :n], ks[1, :, :n], vs[1, :, :n],
                                 valid[:, :n], got), 4 * b_ * h_ * n * 128, "fp32")
        row.update(ms=cuda_ms(rotating(dattn.stacked_decode_attention_i8, sets)),
                   bound_ms=b, bound_by=by)
        if name == "one_row":
            row["ms_by_cluster_size"] = _by_cluster_size(
                "stacked_decode_attention_i8",
                lambda fn, q_, kq_, ks_, vq_, vs_, valid_, li, n_: kernel_ab.call_stacked(
                    (fn, True), q_, kq_[li], ks_[li], vq_[li], vs_[li], valid_, n_), sets)
            continue

        def dequant(c, sc, li):
            return (c[li].reshape(b_, S, hkv, 128).float()
                    * sc[li][..., None]).bfloat16().transpose(1, 2)

        mask = (valid > 0)[:, None, None, :]
        lib_sets = [(q.transpose(1, 2), dequant(kq, ks, li), dequant(vq, vs, li)) for li in (1, 0)]
        row.update(launches_per_call=LAYERS,
                   plain_ms=cuda_ms(rotating(dattn.stacked_decode_attention_i8_plain, sets)),
                   library_ms=cuda_ms(rotating(lambda qt, kt, vt: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=mask), lib_sets)))
        del lib_sets
    steps = [by_step["step0"], by_step["step5"]]
    return dict(name="stacked_decode_attention_i8", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/stacked_decode_i8.cu",
                replaces="openvla_probe_tpu/ops/decode_attention.py:112",
                max_abs_err=max(max(r["max_abs_err"], r["masked_row_max_abs_err"])
                                for r in by_step.values()),
                **{key: statistics.mean(r[key] for r in steps)
                   for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
                bound_by=steps[0]["bound_by"], by_step=by_step)


def check_stacked_decode_i8_scalar(dev, g):
    """Row 5's scalar route (fp32 q, head dims 16, 32, 64; the tiny fp32
    pallas_kv8 path launches it) at the 7B decode shape in fp32 (step 3,
    the slots up to the query), within 1e-5 of the plain version, and at Dh = 64
    with n_rep 4 in bf16 within 2e-2. Bound: the bytes of the slots read;
    library: SDPA in fp32 on K/V dequantized beforehand."""
    B, T, S, H, slot = BATCH, T_PREFILL, 320, 32, T_PREFILL + 3
    q, kq, ks, vq, vs, valid = _stacked_inputs(B, S, H, H, T, slot, g, dev, torch.float32)
    sets = [(q, kq, ks, vq, vs, valid, li, slot + 1) for li in (1, 0)]
    got = _launched("stacked_decode_attention_i8_scalar",
                    lambda: dattn.stacked_decode_attention_i8(*sets[0]))
    want = dattn.stacked_decode_attention_i8_plain(*sets[0])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    err = (got - want).abs().max().item()
    kq64 = torch.randint(-127, 128, (1, 4, 40, 2 * 64), generator=g, device=dev, dtype=torch.int8)
    ks64 = torch.rand((1, 4, 40, 2), generator=g, device=dev) * 0.02 + 1e-3
    q64 = torch.randn((4, 1, 8, 64), generator=g, device=dev).bfloat16()
    v64 = torch.ones((4, 40), dtype=torch.int32, device=dev)
    a64 = (q64, kq64, ks64, kq64, ks64, v64, 0, 33)
    got64 = _launched("stacked_decode_attention_i8_scalar",
                      lambda: dattn.stacked_decode_attention_i8(*a64))
    want64 = dattn.stacked_decode_attention_i8_plain(*a64)
    torch.testing.assert_close(got64.float(), want64.float(), atol=2e-2, rtol=2e-2)
    n = slot + 1
    b, by = bound_ms(_nbytes(q, kq[1, :, :n], vq[1, :, :n], ks[1, :, :n], vs[1, :, :n],
                             valid[:, :n], got), 4 * B * H * n * 128, "fp32")

    def dequant(c, sc, li):
        return (c[li].reshape(B, S, H, 128).float() * sc[li][..., None]).transpose(1, 2)

    mask = (valid > 0)[:, None, None, :]
    lib_sets = [(q.transpose(1, 2), dequant(kq, ks, li), dequant(vq, vs, li)) for li in (1, 0)]
    return dict(name="stacked_decode_attention_i8_scalar", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/stacked_decode_i8.cu",
                replaces="openvla_probe_tpu/ops/decode_attention.py:112",
                max_abs_err=max(err, (got64.float() - want64.float()).abs().max().item()),
                ms=cuda_ms(rotating(dattn.stacked_decode_attention_i8, sets)),
                plain_ms=cuda_ms(rotating(dattn.stacked_decode_attention_i8_plain, sets)),
                bound_ms=b, bound_by=by,
                library_ms=cuda_ms(rotating(lambda qt, kt, vt: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask), lib_sets)))


def _train_gemm_launches(quant: str, kernel: str) -> dict:
    """(M, K, N) -> launches of `kernel` in one 7B train step of `quant`'s
    base, M = 2560: q/k/v/o and gate/up in the forward and the remat
    recompute, down_proj in the forward only; lm_head once where its route
    is `kernel` (int8; int4's lm_head takes the requant route). Held to
    _expected_train_launches, which the train paths assert."""
    M = TRAIN_ROWS
    out = {(M, 4096, 4096): 2 * 4 * LAYERS, (M, 4096, 11008): 2 * 2 * LAYERS,
           (M, 11008, 4096): LAYERS}
    if quant == "int8":
        out[(M, 4096, 32064)] = 1
    cfg = bench_finetune.train_config(vlm.VLMConfig.openvla_7b(), quant)
    assert sum(out.values()) == _expected_train_launches(quant, cfg)[kernel], (quant, kernel)
    return out


def _launches_of(shape, per_call: dict, per_step: dict) -> dict:
    """A checked shape's weight: its launches per serving call, or per train step."""
    if shape in per_call:
        return {"launches_per_call": per_call[shape]}
    return {"launches_per_step": per_step[shape]}


def check_w4a8_matmul(dev, g):
    """Row 8 at every (M, K, N) the pallas_int4 path gives it: the towers'
    int4 linears (DINOv2 M = 24 x 261 = 6264, SigLIP qkv/proj M = 6144), the
    Llama prefill M = 6912 and decode M = 24; and the three trunk shapes of a
    train_int4 step, M = 2560 (launches_per_step; the headline times weigh the
    serving launches, train_mix the step's); bf16 x, random int4 codes in
    [-7, 7] packed, fp32 group scales. Bit-equal to the plain version (the same
    activation codes, exact integer sums, the same fold order and roundings).
    Library: cuBLAS bf16 x @ w_bf16ᵀ on weights dequantized beforehand (it
    leaves out the activation quantization and the group fold, and streams
    4x the weight bytes). Also at M = 64 and 65 (the last M of the decode
    route and the first of the wgmma route; launches_per_call 0), and the host
    time of one wrapper call at the decode shape."""
    M_pre, M_dec, A1 = BATCH * T_PREFILL, BATCH, ACTION_DIM - 1
    M_dino, M_sig = BATCH * 261, BATCH * 256
    per_call = {(M_dino, 1024, 3072): 23, (M_dino, 1024, 1024): 23, (M_dino, 1024, 4096): 23,
                (M_dino, 4096, 1024): 23, (M_sig, 1152, 3456): 26, (M_sig, 1152, 1152): 26,
                (M_pre, 4096, 4096): 4 * LAYERS, (M_pre, 4096, 11008): 2 * LAYERS,
                (M_pre, 11008, 4096): LAYERS, (M_dec, 4096, 4096): 4 * LAYERS * A1,
                (M_dec, 4096, 11008): 2 * LAYERS * A1, (M_dec, 11008, 4096): LAYERS * A1}
    per_step = _train_gemm_launches("int4", "w4a8_matmul")
    route_edge = {(64, 4096, 4096): 0, (65, 4096, 4096): 0}
    by_shape = {}
    for (M, K, N) in {**per_call, **per_step, **route_edge}:
        G = K // lin.GROUP_SIZE
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = []
        for _ in range(copies_past_l2(N * K // 2)):
            codes = torch.randint(-7, 8, (G, N, lin.GROUP_SIZE), generator=g, device=dev,
                                  dtype=torch.int8)
            s = torch.rand((N, G), generator=g, device=dev) * 2e-3 + 2e-3
            sets.append((x, lin.pack_int4(codes), s))
        got = lin.w4a8_matmul(*sets[0])
        torch.cuda.synchronize()
        want = lin.w4a8_matmul_plain(*sets[0])
        assert torch.equal(got, want), f"{M}x{K}x{N}: not bit-equal to the plain version"
        w_bf16 = [(x, lin.dequantize_weight({"q": q, "s": s})) for x, q, s in sets]
        b, by = bound_ms(_nbytes(x, sets[0][1], sets[0][2], got), 2 * M * N * K, "int8")
        by_shape[f"{M}x{K}x{N}"] = dict(
            **_launches_of((M, K, N), {**per_call, **route_edge}, per_step), max_abs_err=0.0,
            ms=cuda_ms(rotating(lin.w4a8_matmul, sets)),
            plain_ms=cuda_ms(rotating(lin.w4a8_matmul_plain, sets), reps=3, warmup=1),
            library_ms=cuda_ms(rotating(lambda a, w: a @ w.t(), w_bf16)),
            bound_ms=b, bound_by=by)
        if (M, K, N) == (M_dec, 4096, 4096):
            by_shape[f"{M}x{K}x{N}"]["host_us"] = host_us(lambda: lin.w4a8_matmul(*sets[0]))
        del sets, w_bf16, got, want
    mix = _launch_weighted(by_shape, {f"{M}x{K}x{N}": n for (M, K, N), n in per_call.items()})
    train = _launch_weighted(by_shape, {f"{M}x{K}x{N}": n for (M, K, N), n in per_step.items()})
    return dict(name="w4a8_matmul", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/w4a8_matmul.cu",
                replaces="openvla_probe_tpu/ops/linear.py:573", by_shape=by_shape,
                train_mix=train, **mix)


def _int_mm_w8a8(codes, sx, q, s):
    """The library yardstick of the w8a8 products: cuBLASLt's int8 GEMM
    (torch._int_mm) on the same codes, then the same epilogue."""
    return (torch._int_mm(codes, q.t()).float() * sx * s[None, :]).bfloat16()


def check_w8a8_matmul(dev, g):
    """The w8a8 kernel (the XLA op _w8a8_dot) at every (M, K, N) of the turbo
    path (towers M = 6264 / 6144, prefill M = 6912, decode and lm_head M = 24;
    SigLIP's N = 4304 and K = 4304, lm_head's N = 32064), and of a train_int8
    step, M = 2560
    (the trunk and lm_head; launches_per_step, weighed apart as train_mix):
    bf16 x, int8 codes, fp32 scales; bit
    for bit equal to the plain version, from bf16 x and from the fused norm's
    codes (the prequant entry). At the prefill shapes the nibble loader too,
    bit-equal to the int8 loader on the same codes, with its time; nibble_mix
    weighs turbo_nibble's call as it runs (the towers' 196 int8 launches at
    their bf16-x times, the trunk's 224 nibble prefills at the nibble
    loader's). Edge cases, checked bit for bit and untimed, in both entries
    and (K a multiple of 32) both weight forms: the routes' edge M = 64 / 65,
    one row, ragged M, K and N (100 x 80 x 136, 5 x 48 x 40, 200 x 96 x
    136). Library:
    torch._int_mm on the same activation codes plus the epilogue (it leaves
    out the activation quantization)."""
    M_pre, M_dec, A1 = BATCH * T_PREFILL, BATCH, ACTION_DIM - 1
    M_dino, M_sig = BATCH * 261, BATCH * 256
    per_call = {(M_dino, 1024, 3072): 23, (M_dino, 1024, 1024): 23, (M_dino, 1024, 4096): 23,
                (M_dino, 4096, 1024): 23, (M_sig, 1152, 3456): 26, (M_sig, 1152, 1152): 26,
                (M_sig, 1152, 4304): 26, (M_sig, 4304, 1152): 26,
                (M_pre, 4096, 4096): 4 * LAYERS, (M_pre, 4096, 11008): 2 * LAYERS,
                (M_pre, 11008, 4096): LAYERS, (M_dec, 4096, 4096): 4 * LAYERS * A1,
                (M_dec, 4096, 11008): 2 * LAYERS * A1, (M_dec, 11008, 4096): LAYERS * A1,
                (M_dec, 4096, 32064): 1 + A1}
    per_step = _train_gemm_launches("int8", "w8a8_matmul")
    by_shape = {}
    for (M, K, N) in {**per_call, **per_step}:
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = []
        for _ in range(copies_past_l2(N * K)):
            w = lin.quantize_weight(torch.randn((N, K), generator=g, device=dev) * 0.02)
            sets.append((x, w))
        got = lin.w8a8_matmul(*sets[0])
        torch.cuda.synchronize()
        want = lin.w8a8_matmul_plain(*sets[0])
        assert torch.equal(got, want), f"{M}x{K}x{N}: not bit-equal to the plain version"
        codes, sx = lin.quantize_rows(x.float())
        pre = lin.PrequantActivation(codes, sx, x.dtype)
        assert torch.equal(lin.w8a8_matmul(pre, sets[0][1]), want), f"{M}x{K}x{N}: prequant"
        b, by = bound_ms(_nbytes(x, sets[0][1]["q"], sets[0][1]["s"], got), 2 * M * N * K, "int8")
        row = dict(**_launches_of((M, K, N), per_call, per_step), max_abs_err=0.0,
                   ms=cuda_ms(rotating(lin.w8a8_matmul, sets)),
                   prequant_ms=cuda_ms(rotating(lin.w8a8_matmul, [(pre, w) for _, w in sets])),
                   plain_ms=cuda_ms(rotating(lin.w8a8_matmul_plain, sets), reps=3, warmup=1),
                   library_ms=cuda_ms(rotating(lambda w: _int_mm_w8a8(codes, sx, w["q"], w["s"]),
                                               [(w,) for _, w in sets])),
                   bound_ms=b, bound_by=by)
        if M == M_pre:
            nib = [(x, {**lin.quantize_weight_nibble(lin.dequantize_weight(w, torch.float32)),
                        "s": w["s"]}) for _, w in sets]
            for (_, w), (_, nw) in zip(sets, nib):
                assert torch.equal(lin.nibble_reconstruct_q8(nw), w["q"])
            assert torch.equal(lin.w8a8_matmul(*nib[0]), want), f"{M}x{K}x{N}: nibble loader"
            row["nibble_ms"] = cuda_ms(rotating(lin.w8a8_matmul, nib))
            del nib
        by_shape[f"{M}x{K}x{N}"] = row
        del sets, got, want, codes, pre
    edges = {}
    for (M, K, N) in ((64, 4096, 4096), (65, 4096, 4096), (1, 4096, 4096), (100, 80, 136),
                      (5, 48, 40), (200, 96, 136)):
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        w = lin.quantize_weight(torch.randn((N, K), generator=g, device=dev) * 0.02)
        want = lin.w8a8_matmul_plain(x, w)
        pre = lin.PrequantActivation(*lin.quantize_rows(x.float()), x.dtype)
        entries = {"x": (x, w), "prequant": (pre, w)}
        if K % 32 == 0:   # nibble planes need K a multiple of 32
            entries["nibble"] = (x, kernel_ab.nibble_of(w))
        for entry, args in entries.items():
            got = _launched("w8a8_matmul", lambda: lin.w8a8_matmul(*args))
            assert torch.equal(got, want), f"{M}x{K}x{N} {entry}: not bit-equal"
        edges[f"{M}x{K}x{N}"] = "bit_equal"
    mix = _launch_weighted(by_shape, {f"{M}x{K}x{N}": n for (M, K, N), n in per_call.items()})
    train = _launch_weighted(by_shape, {f"{M}x{K}x{N}": n for (M, K, N), n in per_step.items()})
    towers = {f"{M}x{K}x{N}": n for (M, K, N), n in per_call.items() if M in (M_dino, M_sig)}
    prefill = {f"{M_pre}x{K}x{N}": per_call[(M_pre, K, N)] for (M, K, N) in per_call if M == M_pre}
    n_nib = sum(towers.values()) + sum(prefill.values())
    nibble_mix = {key: (sum(by_shape[s][key] * n for s, n in towers.items())
                        + sum(by_shape[s]["nibble_ms" if key == "ms" else key] * n
                              for s, n in prefill.items())) / n_nib
                  for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    nibble_mix["launches_per_call"] = n_nib
    return dict(name="w8a8_matmul", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/w8a8_matmul.cu",
                replaces="openvla_probe_tpu/ops/linear.py:413", by_shape=by_shape,
                edge_cases=edges, train_mix=train, nibble_mix=nibble_mix, **mix)


def check_rms_norm_quant(dev, g):
    """Row 6 at its two turbo shapes, x bf16 [M, 4096] with M = 6912 (prefill,
    64 launches per call) and 24 (each decode step, 384), held to the plain
    version by rmsq.compare_rms_norm_quant: every code within one step, and
    every row that differs reproduced bit for bit, codes and scale, by the
    plain arithmetic with the row's reciprocal RMS moved by at most 16 ulps
    (the fp32 row sums run in another order). Edge cases held the same way,
    untimed: one row, D = 128 and an odd D (one-element loads), a D past 128
    threads x 8 vectors (more threads a row), fp32 x. No single PyTorch call
    computes this function (library: null)."""
    by_shape = {}
    per_call = {BATCH * T_PREFILL: 2 * LAYERS, BATCH: 2 * LAYERS * (ACTION_DIM - 1)}
    for M, n in per_call.items():
        x = (torch.randn((M, 4096), generator=g, device=dev) * 2).bfloat16()
        w = (1 + 0.2 * torch.randn((4096,), generator=g, device=dev)).bfloat16()
        codes, sx = rmsq.rms_norm_quant(x, w, 1e-5)
        torch.cuda.synchronize()
        stats = rmsq.compare_rms_norm_quant(x, w, 1e-5, (codes, sx),
                                            rmsq.rms_norm_quant_plain(x, w, 1e-5))
        b, by = bound_ms(_nbytes(x, w, codes, sx), 0, "fp32")
        xs = [(x, w)] + [((torch.randn((M, 4096), generator=g, device=dev) * 2).bfloat16(), w)
                         for _ in range(copies_past_l2(_nbytes(x, codes)) - 1)]
        by_shape[f"{M}x4096"] = dict(
            launches_per_call=n, max_abs_err=stats["max_code_step"], **stats,
            ms=cuda_ms(rotating(lambda a, b: rmsq.rms_norm_quant(a, b, 1e-5), xs)),
            plain_ms=cuda_ms(rotating(lambda a, b: rmsq.rms_norm_quant_plain(a, b, 1e-5), xs)),
            library_ms=None, bound_ms=b, bound_by=by)
    edges = {}
    for M, D, dtype in ((1, 4096, torch.bfloat16), (24, 128, torch.bfloat16),
                        (24, 4095, torch.bfloat16), (7, 12288, torch.bfloat16),
                        (6912, 4096, torch.float32), (24, 4096, torch.float32),
                        (5, 999, torch.float32)):
        x = (torch.randn((M, D), generator=g, device=dev) * 2).to(dtype)
        w = (1 + 0.2 * torch.randn((D,), generator=g, device=dev)).to(dtype)
        got, launched = _launch_diff(lambda: rmsq.rms_norm_quant(x, w, 1e-5))
        assert launched == {"rms_norm_quant": 1}, launched
        stats = rmsq.compare_rms_norm_quant(x, w, 1e-5, got, rmsq.rms_norm_quant_plain(x, w, 1e-5))
        edges[f"{M}x{D}_{str(dtype)[6:]}"] = {k: stats[k] for k in ("max_code_step",
                                                                    "rows_differing", "max_r_ulps")}
    n = sum(per_call.values())
    mix = {key: sum(r[key] * r["launches_per_call"] for r in by_shape.values()) / n
           for key in ("ms", "plain_ms", "bound_ms")}
    return dict(name="rms_norm_quant", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/rmsnorm_quant.cu",
                replaces="openvla_probe_tpu/ops/rmsnorm_quant.py:42", by_shape=by_shape,
                edge_cases=edges,
                max_abs_err=max(r["max_abs_err"] for r in by_shape.values()), library_ms=None,
                bound_by="bytes", **mix)


def check_nib_hi_dot(dev, g):
    """The hi-plane product (the XLA op _nib_hi_dot) at the turbo_nibble
    decode shapes, M = 24: the trunk's 4096 x 4096, 4096 x 11008, 11008 x 4096
    and lm_head's 4096 x 32064; bf16 x, nibble planes, fp32 scales; bit for
    bit equal to the plain version; edge cases untimed: one row,
    NIB_HI_M_MAX = 32 and 33, ragged M, K and N (5 x 96 x 40, 65 x 96 x 40).
    Library: torch._int_mm on the same activation codes and the hi codes
    widened to int8 beforehand, plus the same epilogue (it leaves out the
    quantization and streams 2x the weight bytes)."""
    A1 = ACTION_DIM - 1
    per_call = {(BATCH, 4096, 4096): 4 * LAYERS * A1, (BATCH, 4096, 11008): 2 * LAYERS * A1,
                (BATCH, 11008, 4096): LAYERS * A1, (BATCH, 4096, 32064): 1 + A1}
    by_shape = {}
    for (M, K, N) in per_call:
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = [(x, *(lambda w: (w["hi"], w["s"]))(lin.quantize_weight_nibble(
            torch.randn((N, K), generator=g, device=dev) * 0.02)))
            for _ in range(copies_past_l2(N * K // 2))]
        got = lin.nib_hi_dot(*sets[0])
        torch.cuda.synchronize()
        want = lin.nib_hi_dot_plain(*sets[0])
        assert torch.equal(got, want), f"{M}x{K}x{N}: not bit-equal to the plain version"
        codes, sx = lin.quantize_rows(x.float())
        rowsum = codes.int().sum(-1, keepdim=True).float()

        def library(hi8, s):
            acc = torch._int_mm(codes, hi8.t()).float()
            return ((acc * 16.0 + rowsum * 7.5) * sx * s[None, :]).bfloat16()

        lib_sets = [(lin.unpack_int4(hi), s) for _, hi, s in sets]
        b, by = bound_ms(_nbytes(x, sets[0][1], sets[0][2], got), 2 * M * N * K, "int8")
        by_shape[f"{M}x{K}x{N}"] = dict(
            launches_per_call=per_call[(M, K, N)], max_abs_err=0.0,
            ms=cuda_ms(rotating(lin.nib_hi_dot, sets)),
            plain_ms=cuda_ms(rotating(lin.nib_hi_dot_plain, sets), reps=5, warmup=1),
            library_ms=cuda_ms(rotating(library, lib_sets)), bound_ms=b, bound_by=by)
        del sets, lib_sets, got, want
    edges = {}
    for (M, K, N) in ((1, 4096, 4096), (lin.NIB_HI_M_MAX, 4096, 4096), (33, 4096, 4096),
                      (5, 96, 40), (65, 96, 40)):
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        w = lin.quantize_weight_nibble(torch.randn((N, K), generator=g, device=dev) * 0.02)
        got = _launched("nib_hi_dot", lambda: lin.nib_hi_dot(x, w["hi"], w["s"]))
        assert torch.equal(got, lin.nib_hi_dot_plain(x, w["hi"], w["s"])), f"{M}x{K}x{N}"
        edges[f"{M}x{K}x{N}"] = "bit_equal"
    mix = _launch_weighted(by_shape, {f"{M}x{K}x{N}": n for (M, K, N), n in per_call.items()})
    return dict(name="nib_hi_dot", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/nib_hi_dot.cu",
                replaces="openvla_probe_tpu/ops/linear.py:887", by_shape=by_shape,
                edge_cases=edges, **mix)


def check_w4a8_dx(dev, g):
    """Row 9 (the STE backward of the w4a8 products) at the three shapes a
    train_int4 step gives it, B = 8 x T = 320 rows: q/k/v/o g [2560, 4096]
    against 32 groups of [4096, 128] codes (128 launches a step), gate/up g
    [2560, 11008] against 32 of [11008, 128] (64), down g [2560, 4096] against
    86 of [4096, 128] (32); bf16 g (and fp32 g at the first shape), random
    codes in [-7, 7] packed, fp32 scales; held to the plain version by
    linear.compare_w4a8_dx (the same bf16 products, fp32 sums in another
    order). Library: cuBLAS bf16 g @ W_bf16 on the weight dequantized
    beforehand (it leaves out the dequantization and streams 4x the weight
    bytes)."""
    M = TRAIN_ROWS
    per_step = {(M, 4096, 32): 4 * LAYERS, (M, 11008, 32): 2 * LAYERS, (M, 4096, 86): LAYERS}
    by_shape = {}
    for (M_, N, G) in per_step:
        K = G * lin.GROUP_SIZE
        gr = torch.randn((M_, N), generator=g, device=dev).bfloat16()
        sets = []
        for _ in range(copies_past_l2(N * K // 2)):
            codes = torch.randint(-7, 8, (G, N, lin.GROUP_SIZE), generator=g, device=dev,
                                  dtype=torch.int8)
            s = torch.rand((N, G), generator=g, device=dev) * 2e-3 + 2e-3
            sets.append((gr, lin.pack_int4(codes), s))
        before = _build.KERNEL_LAUNCHES["w4a8_dx"]
        got = lin.w4a8_dx(*sets[0])
        torch.cuda.synchronize()
        assert _build.KERNEL_LAUNCHES["w4a8_dx"] == before + 1
        stats = lin.compare_w4a8_dx(got, lin.w4a8_dx_plain(*sets[0]))
        row = dict(launches_per_step=per_step[(M_, N, G)], **stats)
        if (N, G) == (4096, 32):
            g32 = gr.float()
            row["fp32_g"] = lin.compare_w4a8_dx(lin.w4a8_dx(g32, *sets[0][1:]),
                                                lin.w4a8_dx_plain(g32, *sets[0][1:]))
            del g32
        w_bf16 = [(a, lin.dequantize_weight({"q": q, "s": s})) for a, q, s in sets]
        b, by = bound_ms(_nbytes(gr, sets[0][1], sets[0][2], got), 2 * M_ * N * K, "bf16")
        row.update(ms=cuda_ms(rotating(lin.w4a8_dx, sets)),
                   plain_ms=cuda_ms(rotating(lin.w4a8_dx_plain, sets), reps=3, warmup=1),
                   library_ms=cuda_ms(rotating(lambda a, w: a @ w, w_bf16)),
                   bound_ms=b, bound_by=by)
        by_shape[f"{M_}x{N}x{K}"] = row
        del sets, w_bf16, got
    mix = _launch_weighted(by_shape, {k: r["launches_per_step"] for k, r in by_shape.items()})
    return dict(name="w4a8_dx", route="cuda", source="openvla_probe_tpu_torch/ops/csrc/w4a8_dx.cu",
                replaces="openvla_probe_tpu/ops/linear.py:657", by_shape=by_shape, **mix)


REQUANT_LAUNCHES = {"w4a8_requant_quant_rows": 1, "w4a8_requant": 1}


def requant_scratch_bytes(M: int, K: int) -> int:
    """What one requant call may allocate beside its output: the pre-pass's
    codes [M, K] and scales [M], and the caching allocator's slack (it hands
    out a cached block whole where less than 1 MiB of it would be left over:
    under 3 MiB for the three tensors); the [N, K] int8 copy of the two-step
    route (5.0 MB at SigLIP's fc1, 131 MB at lm_head) would not fit."""
    return M * K + 4 * M + (3 << 20)


def _int4_leaf(G, N, gsz, g, dev):
    """Random grouped-int4 codes in [-8, 7] (-8 too: the packed format holds
    it), packed, and fp32 group scales."""
    codes = torch.randint(-8, 8, (G, N, gsz), generator=g, device=dev, dtype=torch.int8)
    return lin.pack_int4(codes), torch.rand((N, G), generator=g, device=dev) * 2e-3 + 2e-3


def check_w8a8_requant(dev, g):
    """The int4 requant route (lin.w4a8_requant: the XLA op _w4a8_dot_requant,
    int4 groups rebuilt to int8 codes and row scales inside the int8 GEMM's
    weight loader) at its three 7B shapes: lm_head (24 x 4096 x 32064, 7
    calls a pallas_int4 call) and SigLIP's fc1 (6144 x 1152 x 4304, 26), and
    train_int4's lm_head (2560 x 4096 x 32064, once a step; weighed apart as
    train_mix); bf16 x, random codes, fp32 group scales. Bit for bit equal
    to the plain version (the requant in PyTorch, then w8a8_matmul_plain),
    each call exactly one pre-pass and one GEMM launch, its peak-memory rise
    the output and the pre-pass's scratch alone (requant_scratch_bytes: no
    [N, K] int8 copy, which the route no longer makes). Beside it, in the
    same run, the route it replaces (the requant in PyTorch, then
    w8a8_matmul: two_step_ms) and the GEMM alone on the requantized codes
    (w8a8_matmul_ms). Edge cases bit for bit, untimed, in
    bf16 and fp32: M = 1, 24, 64, 65 at N = 200 and 4304; group sizes 32, 64
    and 96 (G = 9) and gsz = 128 at G = 32; rows whose scales all sit at the
    1e-8 floor. Library: torch._int_mm on the requantized codes and the
    activation codes (both made beforehand) plus the epilogue."""
    per_call = {(BATCH, 4096, 32064): ACTION_DIM, (BATCH * 256, 1152, 4304): 26}
    per_step = {(TRAIN_ROWS, 4096, 32064): 1}
    by_shape = {}
    for (M, K, N) in {**per_call, **per_step}:
        G = K // lin.GROUP_SIZE
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = [(x, *_int4_leaf(G, N, lin.GROUP_SIZE, g, dev))
                for _ in range(copies_past_l2(N * K // 2))]
        _, q, s = sets[0]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got, launched = _launch_diff(lambda: lin.w4a8_requant(x, q, s))
        rise = torch.cuda.max_memory_allocated() - base - _nbytes(got)
        assert launched == REQUANT_LAUNCHES, (M, K, N, launched)
        assert rise <= requant_scratch_bytes(M, K), f"{M}x{K}x{N}: {rise} bytes allocated"
        q8, s8 = lin.requant_int4_to_int8(q, s)
        want = lin.w8a8_matmul_plain(x, {"q": q8, "s": s8})
        assert torch.equal(got, want), f"{M}x{K}x{N}: requant route differs from its plain version"
        b, by = bound_ms(_nbytes(x, q, s, got), 2 * M * N * K, "int8")
        codes, sx = lin.quantize_rows(x.float())
        by_shape[f"{M}x{K}x{N}"] = dict(
            **_launches_of((M, K, N), per_call, per_step), max_abs_err=0.0,
            peak_rise_bytes=rise, int8_copy_bytes=N * K, bound_ms=b, bound_by=by,
            ms=cuda_ms(rotating(lin.w4a8_requant, sets)),
            two_step_ms=cuda_ms(rotating(lambda a, qq, ss: lin.w8a8_matmul(
                a, dict(zip(("q", "s"), lin.requant_int4_to_int8(qq, ss)))), sets),
                reps=5, warmup=1),
            w8a8_matmul_ms=cuda_ms(lambda: lin.w8a8_matmul(x, {"q": q8, "s": s8})),
            plain_ms=cuda_ms(rotating(lin.w4a8_requant_plain, sets), reps=3, warmup=1),
            library_ms=cuda_ms(lambda: _int_mm_w8a8(codes, sx, q8, s8)))
        del sets, got, want, q8, s8, codes
    edges = {}
    bf16, fp32 = torch.bfloat16, torch.float32
    for (M, N, G, gsz, dtype) in ((1, 200, 32, 128, bf16), (24, 200, 32, 128, fp32),
                                  (64, 4304, 9, 128, bf16), (65, 4304, 9, 128, fp32),
                                  (65, 200, 32, 128, bf16), (24, 4304, 32, 128, bf16),
                                  (24, 200, 9, 32, bf16), (200, 136, 9, 32, fp32),
                                  (24, 200, 9, 64, fp32), (200, 200, 9, 64, bf16),
                                  (5, 40, 9, 96, bf16), (100, 200, 9, 96, bf16)):
        K = G * gsz
        x = torch.randn((M, K), generator=g, device=dev).to(dtype)
        q, s = _int4_leaf(G, N, gsz, g, dev)
        s[: N // 4] = 1e-8                       # rows at the scale floor: r = 1e-8 / (s8 + 1e-30)
        got, launched = _launch_diff(lambda: lin.w4a8_requant(x, q, s))
        assert launched == REQUANT_LAUNCHES, launched
        assert torch.equal(got, lin.w4a8_requant_plain(x, q, s)), f"{M}x{K}x{N} gsz {gsz} {dtype}"
        edges[f"{M}x{K}x{N}_gsz{gsz}_{str(dtype)[6:]}"] = "bit_equal"
    mix = _launch_weighted(by_shape, {f"{M}x{K}x{N}": n for (M, K, N), n in per_call.items()})
    mix["two_step_ms"] = sum(by_shape[f"{M}x{K}x{N}"]["two_step_ms"] * n
                             for (M, K, N), n in per_call.items()) / sum(per_call.values())
    train = _launch_weighted(by_shape, {f"{M}x{K}x{N}": n for (M, K, N), n in per_step.items()})
    return dict(name="w4a8_requant", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/w8a8_matmul.cu",
                replaces="openvla_probe_tpu/ops/linear.py:548", by_shape=by_shape,
                edge_cases=edges, train_mix=train, **mix)


GROUPED_LAUNCHES = {"w4a8_grouped_quant_rows": 1, "w4a8_grouped": 1}


def check_w4a8_grouped(dev, g):
    """The grouped decode product (the XLA op _w4a8_dot_grouped: the turbo
    tier over grouped-int4 and mix weights at M <= 32) at its 7B shapes, M =
    24: the trunk's 4096 x 4096, 4096 x 11008, 11008 x 4096 (each layer of
    each of the six decode steps) and lm_head's 4096 x 32064 (7 a call);
    bf16 x, random codes in [-8, 7], fp32 group scales, group 128. Bit for
    bit equal to the plain version (its fp32 fold order is the kernel's),
    each call one pre-pass and one GEMM launch, also timed apart (the C
    entries kernel_ab.grouped_parts reaches, uncounted). Edge cases bit for
    bit, untimed, bf16 and fp32: M = 1, 32, 33, 70; group sizes 32, 64, 96,
    256; N = 8, 40, 136, 200 and 4104 (past a tile edge), lm_head's 1002 tiles
    over three row blocks (the persistent grid's clusters walking several
    tiles); rows at the scale floor. Library: cuBLAS bf16 on the
    weight dequantized to bf16 beforehand (it leaves out the quantization and
    streams 4x the weight bytes)."""
    A1 = ACTION_DIM - 1
    per_call = {(BATCH, 4096, 4096): 4 * LAYERS * A1, (BATCH, 4096, 11008): 2 * LAYERS * A1,
                (BATCH, 11008, 4096): LAYERS * A1, (BATCH, 4096, 32064): 1 + A1}
    by_shape = {}
    for (M, K, N) in per_call:
        G = K // lin.GROUP_SIZE
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = [(x, *_int4_leaf(G, N, lin.GROUP_SIZE, g, dev))
                for _ in range(copies_past_l2(N * K // 2))]
        got, launched = _launch_diff(lambda: lin.w4a8_grouped(*sets[0]))
        assert launched == GROUPED_LAUNCHES, (M, K, N, launched)
        want = lin.w4a8_grouped_plain(*sets[0])
        assert torch.equal(got, want), f"{M}x{K}x{N}: not bit-equal to the plain version"
        lib_sets = [(x, lin.dequantize_weight({"q": q, "s": s}, torch.bfloat16))
                    for _, q, s in sets]
        b, by = bound_ms(_nbytes(*sets[0], got), 2 * M * N * K, "int8")
        prepass, gemm = kernel_ab.grouped_parts(_build.load("w4a8_grouped"))
        by_shape[f"{M}x{K}x{N}"] = dict(
            launches_per_call=per_call[(M, K, N)], max_abs_err=0.0,
            prepass_ms=cuda_ms(lambda: kernel_ab.call_grouped_prepass(prepass, x)),
            gemm_ms=cuda_ms(rotating(lambda *a: kernel_ab.call_grouped_gemm(gemm, *a), [
                (kernel_ab.call_grouped_prepass(prepass, x), q, s) for _, q, s in sets])),
            ms=cuda_ms(rotating(lin.w4a8_grouped, sets)),
            plain_ms=cuda_ms(rotating(lin.w4a8_grouped_plain, sets), reps=5, warmup=1),
            library_ms=cuda_ms(rotating(lambda a, wd: a @ wd.t(), lib_sets)),
            bound_ms=b, bound_by=by)
        del sets, lib_sets, got, want
    edges = {}
    bf16, fp32 = torch.bfloat16, torch.float32
    for (M, N, G, gsz, dtype) in ((1, 200, 32, 128, bf16), (32, 136, 9, 32, fp32),
                                  (33, 40, 3, 64, bf16), (70, 136, 4, 256, fp32),
                                  (5, 200, 9, 96, bf16), (24, 8, 1, 32, bf16),
                                  (24, 4304, 9, 128, fp32), (32, 4104, 3, 128, bf16),
                                  (70, 32064, 5, 64, bf16)):
        x = torch.randn((M, G * gsz), generator=g, device=dev).to(dtype)
        q, s = _int4_leaf(G, N, gsz, g, dev)
        s[: N // 4] = 1e-8
        got, launched = _launch_diff(lambda: lin.w4a8_grouped(x, q, s))
        assert launched == GROUPED_LAUNCHES, launched
        assert torch.equal(got, lin.w4a8_grouped_plain(x, q, s)), f"{M}x{N} gsz {gsz} {dtype}"
        edges[f"{M}x{G * gsz}x{N}_gsz{gsz}_{str(dtype)[6:]}"] = "bit_equal"
    mix = _launch_weighted(by_shape, {f"{M}x{K}x{N}": n for (M, K, N), n in per_call.items()})
    n = sum(per_call.values())
    for key in ("prepass_ms", "gemm_ms"):
        mix[key] = sum(by_shape[f"{M}x{K}x{N}"][key] * c for (M, K, N), c in per_call.items()) / n
    resident = _build.load("w4a8_grouped").ovla_w4a8_grouped_resident_clusters
    resident.argtypes, resident.restype = [ctypes.c_int], ctypes.c_int
    return dict(name="w4a8_grouped", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/w4a8_grouped.cu",
                resident_clusters=resident(1),
                replaces="openvla_probe_tpu/ops/linear.py:526", by_shape=by_shape,
                edge_cases=edges, **mix)


def _masked_but_bos(args):
    """The split inputs with the last batch row's prefill masked but BOS."""
    pv = args[7].clone()
    pv[-1, 1:] = 0
    return (*args[:7], pv, args[8])


def check_split_attention_i8(dev, g):
    """The int8 frozen-KV decode attention (the XLA function
    _split_attention_i8 of the turbo_kv8 tier) on its ring route at its 7B
    shape: q [24, 1, 32, 128] bf16 over one layer of the int8 prefill K/V
    [24, 288, 32, 128] with their scales and the bf16 generated K/V [24, 6, 32,
    128], bf16 scores, padded prompts, decode step 3; held to the plain
    version by decode_attention.compare_split_attention_i8 (every element
    within two steps of its row's p code, s_p · 127, plus one bf16 step: fp32
    sums in another order and exp's last bits move a p code only at a
    rounding tie), one launch a call. Edge cases, untimed, each with a row
    masked but BOS: GQA (n_rep 2, 4, 8), T = 291 (no multiple of the 16-key
    chunk), T + A = 4096 at n_rep 8, fp32 scores, one row (the cluster rule: 4
    CTAs a (b, kv head)); the one row also timed at the rule and at 1, 2 and 4
    CTAs (the `_cs` launcher, uncounted). Library: SDPA on the K/V dequantized
    to bf16 beforehand, the two segments concatenated (it leaves out the
    quantization of q and p and reads 2x the prefill bytes)."""
    B, T, A, H, Dh = BATCH, T_PREFILL, ACTION_DIM - 1, 32, 128
    sets = kernel_ab.split_i8_sets(B, T, A, 3, H, H, Dh, g, dev,
                                   copies_past_l2(2 * B * T * H * Dh))
    got = _launched("split_attention_i8", lambda: dattn.split_attention_i8(*sets[0],
                                                                           torch.bfloat16))
    stats = dattn.compare_split_attention_i8(got, *sets[0], torch.bfloat16)
    q, kq, ks, vq, vs, kd, vd, pre, dec = sets[0]
    edges = {}
    for name, (b_, t_, a_, h_, hkv, scores) in {
            "gqa2": (3, T, A, 32, 16, torch.bfloat16), "gqa4": (2, T, A, 32, 8, torch.bfloat16),
            "gqa8_4096_keys": (2, 4090, 6, 32, 4, torch.bfloat16),
            "t291": (4, 291, A, 32, 32, torch.bfloat16),
            "fp32_scores": (3, T, A, 32, 32, torch.float32),
            "one_row": (1, T, A, 32, 32, torch.bfloat16)}.items():
        args = _masked_but_bos(kernel_ab.split_i8_sets(b_, t_, a_, 3, h_, hkv, Dh, g, dev, 1)[0])
        out = _launched("split_attention_i8", lambda: dattn.split_attention_i8(*args, scores))
        edges[name] = dattn.compare_split_attention_i8(out, *args, scores)["max_abs_err"]
    one = kernel_ab.split_i8_sets(1, T, A, 3, H, H, Dh, g, dev, copies_past_l2(2 * T * H * Dh))
    kf = [(s[0].transpose(1, 2),
           torch.cat([(s[1].float() * s[2][..., None]).bfloat16(), s[5]], 1).transpose(1, 2),
           torch.cat([(s[3].float() * s[4][..., None]).bfloat16(), s[6]], 1).transpose(1, 2))
          for s in sets]
    mask = torch.cat([pre, dec], dim=1).bool()[:, None, None, :]
    b, by = bound_ms(_nbytes(q, kq, ks, vq, vs, kd, vd, pre, dec, got),
                     4 * B * H * (T + A) * Dh, "int8")
    res = dict(name="split_attention_i8", route="cuda",
               source="openvla_probe_tpu_torch/ops/csrc/split_attention_i8.cu",
               replaces="openvla_probe_tpu/models/llama.py:746",
               max_abs_err=max(stats["max_abs_err"], *edges.values()),
               max_share_of_tolerance=stats["max_share_of_limit"], n_apart=stats["n_apart"],
               ms=cuda_ms(rotating(lambda *a: dattn.split_attention_i8(*a, torch.bfloat16),
                                   sets)),
               plain_ms=cuda_ms(rotating(lambda *a: dattn.split_attention_i8_plain(
                   *a, torch.bfloat16), sets), reps=5, warmup=1),
               library_ms=cuda_ms(rotating(lambda qt, kt, vt: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=mask), kf)),
               bound_ms=b, bound_by=by, launches_per_call=LAYERS * A, edge_cases=edges,
               one_row_ms_by_cluster_size=_by_cluster_size(
                   "split_attention_i8", kernel_ab.call_split_i8, one))
    del sets, kf, one
    return res


def check_split_attention_i8_scalar(dev, g):
    """Row 13's scalar route (fp32 q, head dims other than 128, n_rep other
    than 1, 2, 4, 8; the tiny fp32 turbo_kv8 path launches it: the first
    version of the kernel) at the 7B shape in fp32 with fp32 scores, and at Dh = 64 with
    n_rep 3 in bf16, each with a row masked but BOS, held by
    compare_split_attention_i8. Bound: the bytes (fp32 q and decode K/V);
    library: SDPA in fp32 on the K/V dequantized beforehand."""
    B, T, A, H, Dh = BATCH, T_PREFILL, ACTION_DIM - 1, 32, 128
    sets = [_masked_but_bos(a) for a in kernel_ab.split_i8_sets(
        B, T, A, 3, H, H, Dh, g, dev, copies_past_l2(2 * B * T * H * Dh), torch.float32)]
    got = _launched("split_attention_i8_scalar",
                    lambda: dattn.split_attention_i8(*sets[0], torch.float32))
    stats = dattn.compare_split_attention_i8(got, *sets[0], torch.float32)
    a64 = _masked_but_bos(kernel_ab.split_i8_sets(3, 40, 5, 3, 12, 4, 64, g, dev, 1)[0])
    got64 = _launched("split_attention_i8_scalar",
                      lambda: dattn.split_attention_i8(*a64, torch.bfloat16))
    err64 = dattn.compare_split_attention_i8(got64, *a64, torch.bfloat16)["max_abs_err"]
    q, kq, ks, vq, vs, kd, vd, pre, dec = sets[0]
    kf = [(s[0].transpose(1, 2),
           torch.cat([s[1].float() * s[2][..., None], s[5]], 1).transpose(1, 2),
           torch.cat([s[3].float() * s[4][..., None], s[6]], 1).transpose(1, 2)) for s in sets]
    mask = torch.cat([pre, dec], dim=1).bool()[:, None, None, :]
    b, by = bound_ms(_nbytes(q, kq, ks, vq, vs, kd, vd, pre, dec, got),
                     4 * B * H * (T + A) * Dh, "fp32")
    return dict(name="split_attention_i8_scalar", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/split_attention_i8.cu",
                replaces="openvla_probe_tpu/models/llama.py:746",
                max_abs_err=max(stats["max_abs_err"], err64),
                ms=cuda_ms(rotating(lambda *a: dattn.split_attention_i8(*a, torch.float32),
                                    sets)),
                plain_ms=cuda_ms(rotating(lambda *a: dattn.split_attention_i8_plain(
                    *a, torch.float32), sets), reps=5, warmup=1),
                bound_ms=b, bound_by=by,
                library_ms=cuda_ms(rotating(lambda qt, kt, vt: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask), kf)))


def _inputs(cfg: vla.VLAServingConfig, batch: int, hw: int, g, dev):
    """uint8 images and right-padded prompts [BOS, tokens..., 29871]."""
    P = cfg.prompt_pad_len
    vocab_hi = min(20000, cfg.vlm.llm.vocab_size - 1)
    image = torch.randint(0, 256, (batch, hw, hw, 3), generator=g, device=dev, dtype=torch.uint8)
    plen = torch.randint(P - 12, P - 1, (batch,), generator=g, device=dev)
    ids = torch.randint(min(1000, vocab_hi - 1), vocab_hi, (batch, P), generator=g, device=dev)
    cols = torch.arange(P, device=dev)[None]
    ids = torch.where(cols >= plen[:, None], 0, ids)
    ids = torch.where(cols == plen[:, None] - 1, vla.EMPTY_TOKEN_ID % cfg.vlm.llm.vocab_size, ids)
    ids[:, 0] = 1
    A = cfg.action_dim
    q01, q99 = -torch.ones(A, device=dev), torch.ones(A, device=dev)
    mask = torch.tensor([True] * (A - 1) + [False], device=dev)
    return image, ids, plen, q01, q99, mask


# path -> (serving tier, weight bits or None for bf16, the kernels it must
# launch, each with its activation pre-pass where it has one: every other
# count must stay 0), in the order that lets paths share one build of their
# weights
PATHS = {
    "parity": ("parity", None, ("flash_prefill", "vit_attention", "decode_attention")),
    "pallas": ("pallas", 8, ("flash_prefill", "vit_attention", "fused_ln_w8a8", "fused_mlp_fc1",
                             "fused_mlp_residual", "wi8_matmul", "decode_split_attention")),
    "pallas_kv8": ("pallas_kv8", 8, ("flash_prefill", "vit_attention", "fused_ln_w8a8",
                                     "fused_mlp_fc1", "fused_mlp_residual", "wi8_matmul",
                                     "stacked_decode_attention_i8")),
    "turbo": ("turbo", 8, ("flash_prefill", "vit_attention", "decode_attention", "w8a8_matmul",
                           "rms_norm_quant")),
    "turbo_kv8": ("turbo_kv8", 8, ("flash_prefill", "vit_attention", "split_attention_i8",
                                   "w8a8_matmul", "rms_norm_quant")),
    "turbo_fused": ("turbo", 8, ("flash_prefill", "vit_attention", "decode_attention",
                                 "w8a8_matmul", "rms_norm_quant")),
    "pallas_int4": ("pallas", 4, ("flash_prefill", "vit_attention", "wi8_matmul",
                                  "decode_split_attention", "w4a8_matmul", "w4a8_requant")),
    "turbo_int4": ("turbo", 4, ("flash_prefill", "vit_attention", "decode_attention",
                                "w8a8_matmul", "w4a8_requant", "w4a8_grouped")),
    "turbo_nibble": ("turbo", "nibble", ("flash_prefill", "vit_attention", "decode_attention",
                                         "w8a8_matmul", "nib_hi_dot")),
    "turbo_mix": ("turbo", "mix", ("flash_prefill", "vit_attention", "decode_attention",
                                   "w8a8_matmul", "w4a8_grouped", "rms_norm_quant")),
}
# turbo over the int8 weights after llama.fuse_serving_params (q/k/v and gate/up fused in
# place of turbo's tree, after turbo's phases): tokens bit-equal to turbo's
FUSED_PATHS = ("turbo_fused",)
# the path whose slice ported each kernel (its launches go into the kernels line)
PORTED_ON = {"flash_prefill": "parity", "flash_blockwise": "score_long",
             "vit_attention": "parity", "decode_attention": "parity",
             "stacked_decode_attention_i8": "pallas_kv8", "w4a8_matmul": "pallas_int4",
             "w8a8_matmul": "turbo", "rms_norm_quant": "turbo", "nib_hi_dot": "turbo_nibble",
             "w4a8_dx": "train_int4", "w4a8_requant": "pallas_int4",
             "split_attention_i8": "turbo_kv8", "w4a8_grouped": "turbo_int4"}


def _serving(path: str, vlm_cfg: vlm.VLMConfig, **kw) -> vla.VLAServingConfig:
    return vla.VLAServingConfig.for_tier(vlm_cfg, PATHS[path][0], **kw)


def _init(path: str, vlm_cfg: vlm.VLMConfig, g, dev):
    """The path's weights: random floats quantized one slice at a time
    (convert.init_params), or for mix the codes and scales drawn directly
    (linear.random_params_like, the JAX bench's initializer), fused where the
    path is in FUSED_PATHS."""
    bits = PATHS[path][1]
    if bits == "mix":
        params = lin.random_params_like(
            convert.vlm_param_spec(vlm_cfg, lin.TURBO_QUANT_SUFFIXES, bits), g, device=dev)
    else:
        params = convert.init_params(vlm_cfg, g, device=dev, bits=bits or 8,
                                     quant_suffixes=lin.TURBO_QUANT_SUFFIXES if bits else ())
    if path in FUSED_PATHS:
        params["llm"] = llama.fuse_serving_params(params["llm"])
    return params


def _tiny_vlm(path: str) -> vlm.VLMConfig:
    """VLMConfig.tiny(), or for int4 weights a tiny config whose in-dims are
    multiples of 128 so that the w4a8 kernel runs: two-layer Llama of width
    128, vocab 400 (lm_head takes the requant route), towers of width 128 with
    mlp dims 256 and 208 (SigLIP's fc1 requant, fc2 int8)."""
    if PATHS[path][1] != 4:
        return vlm.VLMConfig.tiny()
    return vlm.VLMConfig.tiny(
        llm=llama.LlamaConfig.tiny(vocab_size=400, hidden_size=128, intermediate_size=256,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   num_key_value_heads=2),
        vision=(vit.ViTConfig.tiny(hidden_size=128, num_heads=2, mlp_dim=256,
                                   num_register_tokens=2, no_embed_class=True,
                                   use_layerscale=True),
                vit.ViTConfig.tiny(hidden_size=128, num_heads=2, mlp_dim=208,
                                   use_cls_token=False, act="gelu_tanh")))


# first-logit tolerance of a tiny path, card vs CPU: parity 1e-4; quantized
# weights 1e-3 (an activation code at a rounding tie may land one step apart
# between the two LayerNorm or RMSNorm sums)
TINY_TOL = {None: 1e-4, 8: 1e-3, 4: 1e-3, "nibble": 1e-3, "mix": 1e-3}


# the tiny configs run fp32: the kernels with a bf16 tensor-core route take their scalar
# route, counted apart
TINY_ROUTES = {"vit_attention": "vit_attention_scalar", "flash_prefill": "flash_prefill_scalar",
               "wi8_matmul": "wi8_matmul_scalar", "decode_attention": "decode_attention_scalar",
               "decode_split_attention": "decode_split_attention_scalar",
               "stacked_decode_attention_i8": "stacked_decode_attention_i8_scalar",
               "split_attention_i8": "split_attention_i8_scalar"}


def check_tiny_path(dev, path: str):
    """The whole path at tiny fp32 size (T = 68 >= 64, so the flash kernel
    runs) on the card vs the CPU run of the plain versions: equal tokens,
    close logits (TINY_TOL)."""
    tvlm = _tiny_vlm(path)
    cfg = _serving(path, tvlm, prompt_pad_len=64, codec_vocab_size=tvlm.llm.vocab_size)
    params = _init(path, cfg.vlm, torch.Generator().manual_seed(1), "cpu")
    img_cfg = ImageTransformConfig(specs=(
        BackboneTransformSpec((28, 28), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        BackboneTransformSpec((28, 28), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))))
    inputs = _inputs(cfg, 4, 40, torch.Generator().manual_seed(2), "cpu")
    ref = vla.predict_action_from_image(params, cfg, inputs[0], img_cfg, *inputs[1:],
                                        return_first_logits=True, device="cpu")
    params_d = _to(params, dev)
    _build.reset_launch_counts()
    out = vla.predict_action_from_image(params_d, cfg, inputs[0].to(dev), img_cfg,
                                        *(x.to(dev) for x in inputs[1:]),
                                        return_first_logits=True, device=dev)
    torch.cuda.synchronize()
    launched = {k for k, n in _build.KERNEL_LAUNCHES.items() if n}
    kernels = {TINY_ROUTES.get(k, k) for k in PATHS[path][2]}
    assert launched == kernels | {_build.PRE_PASSES[k] for k in kernels & set(_build.PRE_PASSES)}, \
        _build.KERNEL_LAUNCHES
    assert torch.equal(out["action_tokens"].cpu(), ref["action_tokens"])
    err = (out["first_logits"].cpu() - ref["first_logits"]).abs().max().item()
    assert err < TINY_TOL[PATHS[path][1]], err
    return dict(path=path, tokens_equal=True, first_logits_max_abs_err=err,
                launches={k: n for k, n in _build.KERNEL_LAUNCHES.items() if n})


class IdTok:
    """A tokenizer stand-in whose text is the token ids themselves."""

    @staticmethod
    def decode(ids, skip_special_tokens=False):
        return " ".join(str(i) for i in ids)


def _ids(text: str):
    return [int(t) for t in text.split()]


def _vlm_requests(path: str, vocab: int, seed: int, lo: int = 1000):
    """generate: VLM_BATCH prompts of 40-64 tokens; score_*: VLM_BATCH rows
    of L - 31 to L tokens (L = SCORE_L[path]) whose last 1-16 tokens are the
    continuation. Each starts with BOS; token ids from [lo, min(20000, vocab))."""
    g = torch.Generator().manual_seed(seed)
    hi = min(20000, vocab)

    def row(n):
        return [1] + torch.randint(lo, hi, (n - 1,), generator=g).tolist()

    if path == "generate":
        return [row(int(n)) for n in torch.randint(40, GEN_PROMPT_PAD + 1, (VLM_BATCH,),
                                                   generator=g)]
    L = SCORE_L[path]
    lens = torch.randint(L - 31, L + 1, (VLM_BATCH,), generator=g).tolist()
    conts = torch.randint(1, 17, (VLM_BATCH,), generator=g).tolist()
    return [(row(n), n - c) for n, c in zip(lens, conts)]


def _run_vlm(path: str, params, cfg, requests, pixels, dev, max_new: int = GEN_NEW_TOKENS):
    """generate: the new token ids of each row (EOS-trimmed); score_*: the
    summed log-probability of each row's continuation."""
    if path == "generate":
        return [_ids(t) for t in generate.generate_greedy_batch(
            params, cfg, IdTok(), requests, pixels, max_new_tokens=max_new, device=dev)]
    return generate.score_continuation_rows(params, cfg, requests, pixels, device=dev)


def _expected_vlm_launches(c: vlm.VLMConfig, decode_steps: int = 0, score_T: int = 0,
                           routes: dict = None) -> dict:
    """Per call: one ViT attention per tower block run (49 at 7B); generate's
    cached prefill takes the plain attention and each of its decode steps one
    decode_attention per layer; the scorer's uncached forward over T tokens
    one flash_prefill (T <= 1024) or flash_blockwise per layer. bf16 at 7B
    takes the tensor-core routes; an fp32 config takes the scalar routes
    (`routes`: TINY_ROUTES)."""
    L = c.llm.num_hidden_layers
    kernels = dict.fromkeys(_build.KERNEL_LAUNCHES, 0)
    routes = routes or {}
    kernels[routes.get("vit_attention", "vit_attention")] = sum(v.num_layers - 1 for v in c.vision)
    kernels[routes.get("decode_attention", "decode_attention")] = L * decode_steps
    if score_T:
        kernels["flash_blockwise" if score_T > attn.ONESHOT_MAX_TK
                else routes.get("flash_prefill", "flash_prefill")] = L
    return kernels


def check_tiny_vlm(dev, path: str):
    """The base VLM's entry points at VLMConfig.tiny() fp32 on the card vs the
    CPU run of the plain versions (which tests/test_torch_generate.py holds to
    the JAX package), 8 rows with per-row pixels: equal tokens (generate, 8
    new tokens), summed log-probabilities within 1e-3 (score_short: T = 68,
    the one-shot kernel; score_long: rows of 1073-1088 tokens, T = 1092, the
    blockwise one), exact launch counts."""
    cfg = vlm.VLMConfig.tiny()
    params = convert.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    img_cfg = ImageTransformConfig(specs=(
        BackboneTransformSpec((28, 28), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        BackboneTransformSpec((28, 28), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))))
    g = torch.Generator().manual_seed(2)
    pixels = apply_image_transform(
        torch.randint(0, 256, (VLM_BATCH, 40, 40, 3), generator=g, dtype=torch.uint8), img_cfg)
    if path == "generate":
        requests = _vlm_requests(path, cfg.llm.vocab_size, 3, lo=3)
        expect = _expected_vlm_launches(cfg, decode_steps=7, routes=TINY_ROUTES)
    else:
        L = {"score_short": 64, "score_long": 1088}[path]
        requests = [([1] + torch.randint(3, cfg.llm.vocab_size, (n - 1,), generator=g).tolist(),
                     n - 5) for n in range(L - 15, L + 1, 2)]
        expect = _expected_vlm_launches(cfg, score_T=cfg.num_patches + L,
                                        routes=TINY_ROUTES)
    ref = _run_vlm(path, params, cfg, requests, pixels, "cpu", max_new=8)
    _build.reset_launch_counts()
    got = _run_vlm(path, _to(params, dev), cfg, requests, pixels.to(dev), dev, max_new=8)
    torch.cuda.synchronize()
    assert _build.KERNEL_LAUNCHES == expect, (path, _build.KERNEL_LAUNCHES)
    if path == "generate":
        assert got == ref, (got, ref)
        return dict(path=path, tokens_equal=True)
    err = float(abs(got - ref).max())
    assert err < 1e-3, (path, err)
    return dict(path=path, scores_max_abs_err=err)


def run_vlm_path(dev, path: str, params):
    """One of the base VLM's entry points at 7B width on the parity tier's bf16
    weights: VLM_BATCH rows with 224 px dinosiglip pixels (from 256x256 uint8
    images, set-up), launches counted around the first call and asserted
    exactly, then p50 over timed calls."""
    c = vlm.VLMConfig.openvla_7b()
    g = torch.Generator(device=dev).manual_seed(5)
    image = torch.randint(0, 256, (VLM_BATCH, IMG_HW, IMG_HW, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    pixels = apply_image_transform(image, ImageTransformConfig.dinosiglip_224()).to(c.llm.dtype)
    requests = _vlm_requests(path, c.llm.vocab_size, seed=6)
    torch.cuda.reset_peak_memory_stats()

    def call():
        out = _run_vlm(path, params, c, requests, pixels, dev)
        torch.cuda.synchronize()
        return out

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = call()
    first_s = time.perf_counter() - t0
    launches = dict(_build.KERNEL_LAUNCHES)
    expect = (_expected_vlm_launches(c, decode_steps=GEN_NEW_TOKENS - 1) if path == "generate"
              else _expected_vlm_launches(c, score_T=c.num_patches + SCORE_L[path]))
    assert launches == expect, (path, launches, expect)
    if path == "generate":
        assert len(out) == VLM_BATCH and all(len(r) <= GEN_NEW_TOKENS for r in out), out
        assert all(0 <= t < c.llm.vocab_size for r in out for t in r), out
        result = dict(new_tokens=[len(r) for r in out], first_tokens=out[0][:8])
    else:
        assert out.shape == (VLM_BATCH,) and bool((out <= 0).all()) and \
            bool(torch.isfinite(torch.from_numpy(out)).all()), out
        result = dict(scores=out.tolist(), T=c.num_patches + SCORE_L[path])
    times = []
    for _ in range(TIMED_VLM_CALLS):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
        assert _build.KERNEL_LAUNCHES == expect, _build.KERNEL_LAUNCHES
    p50 = statistics.median(times)
    return launches, dict(path=path, tier="parity", rows=VLM_BATCH, first_call_s=first_s,
                          p50_ms=p50 * 1e3, rows_per_s=VLM_BATCH / p50,
                          call_ms=[t * 1e3 for t in times],
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **result)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return None if tree is None else tree.to(dev)


def _linear_route(leaf, int8_matmul: str, M: int) -> str:
    """The kernel matmul_t launches for a quantized leaf's layout (a spec
    `Leaf` per tensor), on the config's int8 route, at M rows."""
    if "hi" in leaf:                                    # nibble planes
        return "nib_hi_dot" if M <= lin.NIB_HI_M_MAX else "w8a8_matmul"
    if "q4" in leaf:                                    # mix: the row count picks the copy
        return "w4a8_grouped" if M <= lin.NIB_HI_M_MAX else "w8a8_matmul"
    if leaf["q"].dtype == torch.int8:
        return "wi8_matmul" if int8_matmul == "wi8" else "w8a8_matmul"
    if int8_matmul == "wi8":                            # grouped int4 under the kernel gate
        return "w4a8_matmul" if lin.takes_w4a8_kernel(leaf) else "w4a8_requant"
    return "w4a8_grouped" if M <= lin.NIB_HI_M_MAX else "w4a8_requant"


def _takes_int8_codes(leaf, M: int) -> bool:
    """A consumer the fused norm serves at M rows: an int8 leaf, or a mix leaf
    above M = 32 (llama._norm_maybe_quant)."""
    if "q4" in leaf:
        return M > lin.NIB_HI_M_MAX
    return "q" in leaf and leaf["q"].dtype == torch.int8


def _expected_launches(path: str, cfg: vla.VLAServingConfig, batch: int = BATCH):
    """Exact per-kernel launches of one call, from the weight layout
    (convert.vlm_param_spec) and the routes of the port, with the activation
    pre-pass of each int8 GEMM call (_build.PRE_PASSES) counted apart: every
    call but w8a8's on the fused norm's codes launches one. A fused path runs
    one product for q/k/v and one for gate/up."""
    c = cfg.vlm
    L, A1 = c.llm.num_hidden_layers, cfg.action_dim - 1
    bits = PATHS[path][1]
    kernels = dict.fromkeys(_build.KERNEL_LAUNCHES, 0)
    blocks = sum(v.num_layers - 1 for v in c.vision)       # 23 + 26 tower blocks run
    kernels.update(flash_prefill=L, vit_attention=blocks)
    attn = {"stacked": "decode_attention", "stacked_kv8": "stacked_decode_attention_i8",
            "frozen_kv": "split_attention_i8" if cfg.kv_int8 else "decode_split_attention"}
    kernels[attn[cfg.decode_impl]] = L * A1
    if bits is None:
        return kernels
    spec = convert.vlm_param_spec(c, lin.TURBO_QUANT_SUFFIXES, bits)
    for name, v in zip(c.vision_names, c.vision):
        b, n = spec["vision"][name]["blocks"], v.num_layers - 1
        # the fused kernels: one GEMM launch per linear of the pair (fc1's counted as
        # fused_mlp_fc1), each with its pre-pass
        for pair, fused in ((("qkv_w", "proj_w"), ("fused_ln_w8a8", "fused_ln_w8a8")),
                            (("fc1_w", "fc2_w"), ("fused_mlp_fc1", "fused_mlp_residual"))):
            if all(_linear_route(b[w], v.int8_matmul, 2 ** 20) == "wi8_matmul" for w in pair):
                for gemm in fused:
                    kernels[gemm] += n
            else:
                for w in pair:
                    kernels[_linear_route(b[w], v.int8_matmul, 2 ** 20)] += n
    layers, route = spec["llm"]["layers"], c.llm.int8_matmul
    fused_leaves = path in FUSED_PATHS
    # the products of a layer (q/k/v and gate/up one each when fused) at prefill (M = B x T)
    # and at each step (M = B); lm_head 1 + A1 times
    groups = (("q_proj", "k_proj", "v_proj"), ("o_proj",), ("gate_proj", "up_proj"),
              ("down_proj",))
    for group in groups:
        for w in group[:1] if fused_leaves else group:
            kernels[_linear_route(layers[w], route, batch * T_PREFILL)] += L
            kernels[_linear_route(layers[w], route, batch)] += L * A1
    kernels[_linear_route(spec["llm"]["lm_head"], route, batch)] += 1 + A1
    # the fused norm: both sites of every layer whose consumers all take int8 codes, in the
    # prefill and, on the stacked decode, in every step of more than 8 rows (the frozen-KV
    # and int8-cache decode steps keep the plain norm)
    prequant = 0   # w8a8 calls on the fused norm's codes: no pre-pass
    if c.llm.fused_rmsq and route == "w8a8":
        steps = A1 if cfg.decode_impl == "stacked" and batch > llama.RMSQ_MIN_M - 1 else 0
        for M, n in ((batch * T_PREFILL, 1), (batch, steps)):
            for site in (groups[0], groups[2]):
                if n and all(_takes_int8_codes(layers[w], M) for w in site):
                    kernels["rms_norm_quant"] += L * n
                    prequant += (1 if fused_leaves else len(site)) * L * n
    for gemm, pre_pass in _build.PRE_PASSES.items():
        kernels[pre_pass] = kernels[gemm] - (prequant if gemm == "w8a8_matmul" else 0)
    return kernels


def _counting_int_mm(counter: list):
    real = torch._int_mm

    def counted(*a, **kw):
        counter.append(1)
        return real(*a, **kw)
    return counted


MAIN_OUT = {}   # path -> (action tokens, first logits) of its driven call


def run_main_path(dev, path: str, weights: dict):
    """`weights` caches the last built weights by their bits, so that paths
    sharing weights build them once; a path in FUSED_PATHS fuses the cached
    tree's trunk in place (the unfused leaves dropped) and must give the
    unfused turbo path's tokens and first logits bit for bit."""
    cfg = _serving(path, vlm.VLMConfig.openvla_7b(), action_dim=ACTION_DIM,
                   prompt_pad_len=PROMPT_PAD)
    g = torch.Generator(device=dev).manual_seed(0)
    bits = PATHS[path][1]
    init_s = 0.0
    if bits not in weights:
        weights.clear()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        weights[bits] = _init(path, cfg.vlm, g, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    elif path in FUSED_PATHS and "qkv_proj" not in weights[bits]["llm"]["layers"]:
        t0 = time.perf_counter()
        weights[bits]["llm"] = llama.fuse_serving_params(weights[bits]["llm"])
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    params = weights[bits]
    torch.cuda.reset_peak_memory_stats()   # the serving peak, not the init's transients
    n_params = sum(t.numel() for t in _leaves(params))
    param_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    img_cfg = ImageTransformConfig.dinosiglip_224()
    # the requests from a generator of their own: every path sees the same ones, whether or
    # not it built its weights
    image, ids, plen, q01, q99, mask = _inputs(cfg, BATCH, IMG_HW,
                                               torch.Generator(device=dev).manual_seed(1), dev)

    def call():
        out = vla.predict_action_from_image(params, cfg, image, img_cfg, ids, plen, q01, q99,
                                            mask, return_first_logits=True, device=dev)
        torch.cuda.synchronize()
        return out

    int_mm_calls = []                      # the port calls no library GEMM on any path
    with mock.patch.object(torch, "_int_mm", _counting_int_mm(int_mm_calls)):
        _build.reset_launch_counts()       # counts from 0 around one driven call
        t0 = time.perf_counter()
        out = call()
        first_s = time.perf_counter() - t0
        launches = dict(_build.KERNEL_LAUNCHES)
    expect = _expected_launches(path, cfg)
    assert launches == expect, (path, launches, expect)
    assert not int_mm_calls, (path, len(int_mm_calls))

    toks, actions, logits = out["action_tokens"], out["actions"], out["first_logits"]
    assert toks.shape == (BATCH, ACTION_DIM), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vlm.llm.vocab_size
    assert actions.shape == (BATCH, ACTION_DIM) and torch.isfinite(actions).all()
    assert logits.shape == (BATCH, cfg.vlm.llm.vocab_size) and torch.isfinite(logits).all()
    MAIN_OUT[path] = (toks, logits)
    equal_to = None
    if path in FUSED_PATHS:
        equal_to = "turbo"
        assert torch.equal(toks, MAIN_OUT[equal_to][0]), (path, "tokens differ from turbo's")
        assert torch.equal(logits, MAIN_OUT[equal_to][1]), (path, "logits differ from turbo's")

    times = []
    for _ in range(TIMED_CALLS):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
        assert _build.KERNEL_LAUNCHES == expect, _build.KERNEL_LAUNCHES
    p50 = statistics.median(times)
    busy = profile_main_path.device_time(call, 1)   # the card's busy time a call
    return launches, dict(
        path=path, tier=cfg.tier, weight_bits=bits, fused=path in FUSED_PATHS,
        bit_equal_to=equal_to, int_mm_calls_per_call=len(int_mm_calls),
        params=n_params, param_gb=param_gb, init_s=init_s, first_call_s=first_s,
        p50_ms=p50 * 1e3, calls_per_s=BATCH / p50, call_ms=[t * 1e3 for t in times],
        device_ms_per_call=busy["device_ms_per_call_total"],
        device_ms_by_class=busy["device_ms_per_call_by_class"],
        device_idle_share=busy["device_idle_share"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        first_tokens=toks[0].tolist())


# the probe phase: the tap on pallas_kv8 at 7B width, then the probe bank on the card over
# seeded synthetic episodes (64 episodes of 256 frames: 16384 rows, 33 layers of 4096, 64
# labels, one planted informative layer), 2 epochs of batch 4096; a small bank (3 layers of
# 24, 6 labels) trained on the card and on the CPU from the same start
PROBE_EPISODES, PROBE_T, PROBE_K, PROBE_LAYER, PROBE_EPOCHS, PROBE_LR = 64, 256, 64, 10, 2, 1e-2
PROBE_SMALL_TOL = 1e-4   # the small bank, card vs CPU (fp32 sums in another order, 5 epochs)


def run_probe_tap(dev, params):
    """pallas_kv8 at 7B width, B = 24, with collect_hidden_states=True:
    hidden_pooled [24, 33, 4096] fp32 and finite, the action tokens those of
    the same call without the tap, the card's busy ms a call with the tap and
    without it (torch.profiler, in turns: tap, none, none, tap)."""
    cfg = _serving("pallas_kv8", vlm.VLMConfig.openvla_7b(), action_dim=ACTION_DIM,
                   prompt_pad_len=PROMPT_PAD)
    g = torch.Generator(device=dev).manual_seed(7)
    img_cfg = ImageTransformConfig.dinosiglip_224()
    image, ids, plen, q01, q99, mask = _inputs(cfg, BATCH, IMG_HW, g, dev)

    def call(tap):
        out = vla.predict_action_from_image(params, cfg, image, img_cfg, ids, plen, q01, q99,
                                            mask, collect_hidden_states=tap, device=dev)
        torch.cuda.synchronize()
        return out

    tapped, plain = call(True), call(False)
    hp = tapped["hidden_pooled"]
    L, D = cfg.vlm.llm.num_hidden_layers, cfg.vlm.llm.hidden_size
    assert hp.shape == (BATCH, L + 1, D) and hp.dtype == torch.float32, (hp.shape, hp.dtype)
    assert torch.isfinite(hp).all()
    assert "hidden_pooled" not in plain
    assert torch.equal(tapped["action_tokens"], plain["action_tokens"])
    busy = {True: [], False: []}
    for tap in (True, False, False, True):
        busy[tap].append(profile_main_path.device_time(lambda: call(tap), 1)[
            "device_ms_per_call_total"])
    return dict(hidden_pooled_shape=list(hp.shape), action_tokens_equal=True,
                busy_ms_per_call_with_tap=statistics.mean(busy[True]),
                busy_ms_per_call_without_tap=statistics.mean(busy[False]), busy_ms_turns=busy,
                pooled_abs_mean_by_layer=hp.abs().mean((0, 2)).tolist())


def _probe_episodes(n_eps, T, layers, D, K, planted, g, dev):
    """Seeded synthetic episodes (tests/test_probe.py's recipe): labels
    sign(z · W_k) decodable from layer `planted` (z plus a little noise), every
    other layer noise; label K-1 constant (dropped by the keep-filter), label
    K-2 not applicable on ~30 % of frames. Made on `dev` with generator `g`,
    stored as the capture stores them (fp16 hidden states, int8 labels)."""
    W = torch.randn((K, D), generator=g, device=dev)
    eps = []
    for _ in range(n_eps):
        z = torch.randn((T, D), generator=g, device=dev)
        y = (z @ W.T > 0).to(torch.int8)
        y[:, K - 1] = 1
        y[torch.rand((T,), generator=g, device=dev) < 0.3, K - 2] = -1
        hid = torch.randn((layers, T, D), generator=g, device=dev)
        hid[planted] = z + 0.05 * torch.randn((T, D), generator=g, device=dev)
        eps.append({"visual_semantic_encoding": hid.half().cpu().numpy(),
                    "symbolic_state_object_relations": y[:, :K - 2].cpu().numpy(),
                    "symbolic_state_action_subgoals": y[:, K - 2:].cpu().numpy()})
    return eps


def run_probe_bank(dev):
    """The probe bank trained on the card at D = 4096 over 33 layers (16384
    rows, 64 labels, batch 4096, 2 epochs): the planted layer's F1 and AP above
    every noise layer's; ms an epoch (train_probes' `train_s`: the epochs on
    the host clock, ended by the copy of the bank off the card) and the peak
    device memory. Then a small bank trained on the card and on the CPU from
    the same seeded start: its weights within PROBE_SMALL_TOL, its records
    within 1e-2."""
    assert not torch.backends.cuda.matmul.allow_tf32   # the bank's products in full fp32
    g = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    eps = _probe_episodes(PROBE_EPISODES, PROBE_T, LAYERS + 1, 4096, PROBE_K, PROBE_LAYER, g, dev)
    make_s = time.perf_counter() - t0
    cfg = train_probes.ProbeTrainConfig(epochs=PROBE_EPOCHS, learning_rate=PROBE_LR)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train_probes.train_probes(eps, cfg, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    recs = {r["layer"]: r for r in result["records"]}
    planted = recs[PROBE_LAYER]
    noise = [r for layer, r in recs.items() if layer != PROBE_LAYER]
    for key in ("val_f1", "val_ap"):
        assert planted[key] > max(r[key] for r in noise), (key, planted, noise)
    train_ids = set(result["split"]["train_ids"])
    n_train = sum(e["visual_semantic_encoding"].shape[1] for i, e in enumerate(eps)
                  if i in train_ids)
    kept, train_s = int(result["bank"].keep.size), result["train_s"]
    del eps, result
    torch.cuda.empty_cache()

    small = _probe_episodes(12, 40, 3, 24, 6, 1, torch.Generator().manual_seed(3), "cpu")
    scfg = train_probes.ProbeTrainConfig(epochs=5, batch_size=64, learning_rate=1e-2)
    on_card = train_probes.train_probes(small, scfg, device=dev)
    on_cpu = train_probes.train_probes(small, scfg, device="cpu")
    err = max(float(np.abs(getattr(on_card["bank"], k) - getattr(on_cpu["bank"], k)).max())
              for k in ("w", "b"))
    assert err <= PROBE_SMALL_TOL, err
    rec_err = max(abs(a[k] - b[k]) for a, b in zip(on_card["records"], on_cpu["records"])
                  for k in a)
    assert rec_err <= 1e-2, (on_card["records"], on_cpu["records"])
    return dict(layers=LAYERS + 1, hidden=4096, labels=PROBE_K, kept=kept, train_rows=n_train,
                batch=cfg.batch_size, epochs=PROBE_EPOCHS, episodes_make_s=make_s, run_s=run_s,
                ms_per_epoch=train_s / PROBE_EPOCHS * 1e3, peak_mem_gb=peak_gb,
                planted_layer=PROBE_LAYER, planted_val_f1=planted["val_f1"],
                planted_val_ap=planted["val_ap"],
                best_noise_val_f1=max(r["val_f1"] for r in noise),
                best_noise_val_ap=max(r["val_ap"] for r in noise),
                small_bank_card_vs_cpu_max_abs_err=err, small_records_max_abs_err=rec_err)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# --- the training paths --------------------------------------------------------------


def _expected_train_launches(quant: str, cfg: vlm.VLMConfig) -> dict:
    """Exact per-kernel launches of one train step (tools/bench_finetune.py's
    routes), from the weight layout: each trunk linear's forward kernel in
    the forward and again in the remat recompute, but for down_proj's: the
    non-reentrant checkpoint stops recomputing a layer once the backward has
    every tensor it saved, and the base product of the layer's last linear,
    issued after its LoRA side path, saves none (its STE keeps only the
    frozen weight); on int4 the backward `w4a8_dx` where the kernel's rule
    holds; lm_head's forward once (requant on int4); each GEMM's activation
    pre-pass apart; no attention kernel."""
    bits = bench_finetune.QUANTS[quant]
    kernels = dict.fromkeys(_build.KERNEL_LAUNCHES, 0)
    spec = convert.vlm_param_spec(cfg, lin._DEFAULT_QUANT_SUFFIXES, bits)
    route, L = cfg.llm.int8_matmul, cfg.llm.num_hidden_layers
    for w in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"):
        leaf = spec["llm"]["layers"][w]
        kernels[_linear_route(leaf, route, 2 ** 20)] += L if w == "down_proj" else 2 * L
        if bits == 4 and lin.takes_w4a8_kernel(leaf):
            kernels["w4a8_dx"] += L
    kernels[_linear_route(spec["llm"]["lm_head"], route, 2 ** 20)] += 1
    for gemm, pre_pass in _build.PRE_PASSES.items():
        kernels[pre_pass] = kernels[gemm]
    return kernels


def _random_b(lora, g):
    """The adapters with B drawn N(0, 0.02) from `g`, so that every factor
    has a gradient in the first step."""
    if lora is None:
        return None
    if set(lora) == {"A", "B"}:
        return {"A": lora["A"], "B": torch.randn(lora["B"].shape, generator=g) * 0.02}
    return {k: _random_b(v, g) for k, v in lora.items()}


def _leaf_apart(got, want) -> float:
    """|got - want| in norm over |want|."""
    return float((got.float().cpu() - want.float()).norm() / want.float().norm().clamp(min=1e-30))


# card vs CPU, one training step at tiny fp32 (tests/test_torch_training.py's
# tolerances against the JAX package, for the same reason: each STE backward
# rounds its scaled gradient to bf16, and the two devices' fp32 sums move some
# of those roundings by one bf16 step): loss 1e-4 relative; every LoRA
# gradient within 5e-3 in norm; the adapters after one AdamW step within
# 2 lr everywhere (a near-zero gradient may take the other sign), 90 % within
# 1e-2 lr and 99 % within 1e-1 lr
TRAIN_TINY_TOL = dict(loss=1e-4, grad=5e-3)


def check_tiny_train(dev, path: str):
    """One train step of `path`'s routes at tiny fp32 size (the width-128
    config of the int4 tiny path, so that the w4a8 kernels run) on the card
    vs the CPU, from the same base, batch and adapters: loss, every LoRA
    gradient, the adapters after the step, and the exact launch counts."""
    quant = TRAIN_PATHS[path]
    cfg = bench_finetune.train_config(_tiny_vlm("pallas_int4"), quant)
    base = bench_finetune.base_params(cfg, quant, torch.Generator().manual_seed(1), "cpu")
    batch = bench_finetune.synthetic_batch(cfg, 4, 16, 2, "cpu")
    lora = _random_b(init_lora_params(base, LoRAConfig(r=8), torch.Generator().manual_seed(3)),
                     torch.Generator().manual_seed(4))

    def run(device):
        ft = bench_finetune.Finetune(cfg, _to(base, device), _to(batch, device), rank=8,
                                     lr=TRAIN_LR, lora=_to(lora, device))
        _build.reset_launch_counts()
        (loss, _), grads = value_and_grad(ft.loss_fn, ft.state.params, cfg, ft.batch)
        launches = dict(_build.KERNEL_LAUNCHES)
        ft.step()
        return float(loss), grads, ft.state.params, launches

    ref_loss, ref_grads, ref_lora, _ = run("cpu")
    loss, grads, new_lora, launches = run(dev)
    torch.cuda.synchronize()
    expect = _expected_train_launches(quant, cfg)
    assert launches == expect, (path, launches, expect)
    assert abs(loss - ref_loss) <= TRAIN_TINY_TOL["loss"] * abs(ref_loss), (loss, ref_loss)
    apart = [_leaf_apart(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(ref_grads))]
    assert len(apart) > 20 and max(apart) <= TRAIN_TINY_TOL["grad"], max(apart)
    deltas = torch.cat([(a.cpu() - b).abs().ravel()
                        for a, b in zip(tree_leaves(new_lora), tree_leaves(ref_lora))])
    q = torch.quantile(deltas, torch.tensor([0.9, 0.99]))
    assert deltas.max() <= 2 * TRAIN_LR and q[0] <= 1e-2 * TRAIN_LR and q[1] <= 1e-1 * TRAIN_LR, q
    return dict(path=path, loss=loss, loss_cpu=ref_loss, grads_max_rel_apart=max(apart),
                adapters_max_apart_lr=float(deltas.max()) / TRAIN_LR,
                adapters_p99_apart_lr=float(q[1]) / TRAIN_LR)


def run_train_path(dev, path: str):
    """tools/bench_finetune.py's step at OpenVLA-7B width, all layers: the
    base from a seeded generator on the card, launches counted around the
    first step and asserted exactly, a second warm-up step, then timed steps
    (host clock ending in a synchronize, and CUDA events around each step,
    which the step never waits on: the span of its work on the card's
    timeline; the host's waits on the card inside each step are counted by
    torch.cuda's sync debug mode);
    the loss finite at every step, the base bit-unchanged (equal to a copy
    taken before the steps), every B factor moved off zero."""
    quant = TRAIN_PATHS[path]
    cfg = bench_finetune.train_config(vlm.VLMConfig.openvla_7b(), quant)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = bench_finetune.base_params(cfg, quant, torch.Generator(device=dev).manual_seed(0), dev)
    batch = bench_finetune.synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, dev)
    ft = bench_finetune.Finetune(cfg, base, batch, rank=TRAIN_RANK, lr=TRAIN_LR,
                                 max_steps=2 + TRAIN_TIMED, seed=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frozen = [t.clone() for t in tree_leaves(base)]
    torch.cuda.reset_peak_memory_stats()
    losses = []

    def step():
        metrics = ft.step()
        losses.append(float(metrics["loss"]))

    _build.reset_launch_counts()           # counts from 0 around one driven step
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_build.KERNEL_LAUNCHES)
    expect = _expected_train_launches(quant, cfg)
    assert launches == expect, (path, launches, expect)
    step()
    times, event_ms, timed_losses, host_syncs = [], [], [], []
    for _ in range(TRAIN_TIMED):   # no host read inside the window: the loss is read after it
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:   # every wait on the card, counted
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            start.record()
            timed_losses.append(ft.step()["loss"])
            end.record()
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        event_ms.append(start.elapsed_time(end))
        host_syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    losses += [float(v) for v in timed_losses]
    assert all(torch.isfinite(torch.tensor(losses))), losses
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(base), frozen)), "the base moved"
    del frozen
    lora = ft.state.params
    b_leaves = [lw["B"] for lw in _ab_leaves(lora)]
    assert b_leaves and all(bool((b != 0).any()) for b in b_leaves), "a B factor stayed at zero"
    p50 = statistics.median(times)
    state = ft.state.opt_state
    return launches, dict(
        path=path, base_quant=quant, batch=TRAIN_BATCH, seq=1 + cfg.num_patches + TRAIN_SEQ - 1,
        rank=TRAIN_RANK, init_s=init_s, first_step_s=first_s, step_ms_p50=p50 * 1e3,
        examples_per_s=TRAIN_BATCH / p50, step_ms=[t * 1e3 for t in times],
        event_ms_per_step=event_ms, event_ms_p50=statistics.median(event_ms),
        host_syncs_per_step=host_syncs, losses=losses,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        base_gb=bench_finetune.tree_bytes(base) / 1e9,
        adapters_gb=bench_finetune.tree_bytes(lora) / 1e9,
        opt_state_gb=(bench_finetune.tree_bytes(state.mu) + bench_finetune.tree_bytes(state.nu)) / 1e9,
        adapter_leaves=len(b_leaves))


# --- the bs = 1 robot-control point and the action server ------------------------------------

BS1_TIMED = 5
BS1_PATHS = ("turbo", "turbo_nibble")
SERVE_REQUESTS, SERVE_STREAM_STEPS = 6, 4


def _bs1_measure(fn):
    """A warm-up call, then BS1_TIMED calls each with every count set to 0
    just before and read just after (the same counts every call), then the
    card's busy ms of one more call (torch.profiler)."""
    fn()
    times, launches, out = [], None, None
    for _ in range(BS1_TIMED):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
        counts = {k: n for k, n in _build.KERNEL_LAUNCHES.items() if n}
        assert launches is None or counts == launches, (counts, launches)
        launches = counts
    busy = profile_main_path.device_time(fn, 1)
    return out, dict(p50_ms=statistics.median(times) * 1e3, call_ms=[t * 1e3 for t in times],
                     busy_ms_per_call=busy["device_ms_per_call_total"],
                     device_idle_share=busy["device_idle_share"], launches_per_call=launches)


def _bs1_check_launches(path: str, launches: dict, decode_steps: int):
    """Every launch of a bs = 1 call is a kernel of the path (or its pre-pass):
    32 flash_prefill (the prefill or the verify pass, Tq >= 64) and
    32 decode_attention a decode step."""
    kernels = set(PATHS[path][2])
    allowed = kernels | {_build.PRE_PASSES[k] for k in kernels & set(_build.PRE_PASSES)}
    assert set(launches) <= allowed, (path, launches)
    assert launches.get("flash_prefill", 0) == LAYERS, launches
    assert launches.get("decode_attention", 0) == LAYERS * decode_steps, (decode_steps, launches)


def _margin_check(seq_logits, verify_logits, seq_tokens, spec_tokens):
    """PARITY_r02's margin framework: per position, the gap between the
    verify's logits and the sequential call's on the same prefix (the draft
    is the sequential tokens) and the sequential call's top-2 margin. The
    first position where the tokens differ must have margin <= 2 x gap (an
    argmax can move only that far); later positions see another prefix."""
    rows = []
    for j, lg in enumerate(seq_logits):
        top2 = torch.topk(lg[0], 2).values
        rows.append(dict(pos=j, gap=(verify_logits[0, j] - lg[0]).abs().max().item(),
                         margin=(top2[0] - top2[1]).item()))
    diff = [j for j in range(len(seq_tokens)) if seq_tokens[j] != spec_tokens[j]]
    first = diff[0] if diff else None
    if first is not None:
        r = rows[first]
        assert r["margin"] <= 2 * r["gap"], ("a token moved past its margin", rows, first)
    return dict(per_position=rows, first_difference=first,
                worst_margin_over_gap=min(r["margin"] / max(r["gap"], 1e-30) for r in rows))


def run_bs1(dev, path: str, params):
    """The robot-control point: one 256x256 uint8 image, P = 32, A = 7, at
    7B width. The sequential call; the speculative entry drafted with the
    sequential tokens (with the margin check), with its own previous output
    (the steady state: drafts converge to full acceptance within A calls, as
    each call accepts at least the previous call's accepted prefix and its
    corrected token), and with a draft wrong everywhere."""
    cfg = _serving(path, vlm.VLMConfig.openvla_7b(), action_dim=ACTION_DIM,
                   prompt_pad_len=PROMPT_PAD)
    g = torch.Generator(device=dev).manual_seed(11)
    img_cfg = ImageTransformConfig.dinosiglip_224()
    image, ids, plen, q01, q99, mask = _inputs(cfg, 1, IMG_HW, g, dev)
    A = ACTION_DIM

    def seq():
        out = vla.predict_action_from_image(params, cfg, image, img_cfg, ids, plen, q01, q99,
                                            mask, device=dev)
        torch.cuda.synchronize()
        return out

    def spec(draft):
        out = vla.predict_action_speculative_from_image(params, cfg, image, img_cfg, ids, plen,
                                                        draft, q01, q99, mask, device=dev)
        torch.cuda.synchronize()
        return out

    rows = {}
    seq_out, rows["sequential"] = _bs1_measure(seq)
    _bs1_check_launches(path, rows["sequential"]["launches_per_call"], A - 1)
    seq_tokens = seq_out["action_tokens"]

    # the spec entry drafted with the sequential tokens, and its margin check
    seq_logits, verify_logits = [], []
    real_margin, real_matmul = llama.top2_margin, vla.matmul_t

    def catch_margin(logits, idx):
        seq_logits.append(logits.float().clone())
        return real_margin(logits, idx)

    def catch_verify(x, w, route="wi8"):
        out = real_matmul(x, w, route)
        if x.ndim == 3 and x.shape[1] == A:
            verify_logits.append(out.float().clone())
        return out

    with mock.patch.object(llama, "top2_margin", catch_margin):
        seq()
    with mock.patch.object(vla, "matmul_t", catch_verify):
        drafted = spec(seq_tokens)
    margins = _margin_check(seq_logits, verify_logits[0], seq_tokens[0].tolist(),
                            drafted["action_tokens"][0].tolist())
    out, rows["spec_sequential_draft"] = _bs1_measure(lambda: spec(seq_tokens))
    n_acc = int(out["n_accepted"][0])
    rows["spec_sequential_draft"].update(n_accepted=n_acc, margin_check=margins,
                                         tokens_equal_sequential=bool(torch.equal(
                                             out["action_tokens"], seq_tokens)))
    _bs1_check_launches(path, rows["spec_sequential_draft"]["launches_per_call"],
                        A - min(n_acc + 1, A))

    # the steady state: each call drafts with the previous call's output
    state = {"draft": seq_tokens}
    converge = []
    for _ in range(A + 1):
        out = spec(state["draft"])
        converge.append(int(out["n_accepted"][0]))
        state["draft"] = out["action_tokens"]
        if converge[-1] == A:
            break
    assert converge[-1] == A, ("the steady state must accept its own output", converge)

    def steady():
        o = spec(state["draft"])
        state["draft"] = o["action_tokens"]
        return o

    out, rows["spec_steady"] = _bs1_measure(steady)
    assert int(out["n_accepted"][0]) == A
    rows["spec_steady"].update(n_accepted=A, calls_to_converge=converge)
    _bs1_check_launches(path, rows["spec_steady"]["launches_per_call"], 0)   # no decode step

    # a draft wrong everywhere: greedy token 0 is the steady state's token 0, so n_accepted 0
    wrong = (state["draft"] + 1) % cfg.codec_vocab_size
    out, rows["spec_wrong_draft"] = _bs1_measure(lambda: spec(wrong))
    assert int(out["n_accepted"][0]) == 0, out["n_accepted"]
    rows["spec_wrong_draft"].update(n_accepted=0)
    _bs1_check_launches(path, rows["spec_wrong_draft"]["launches_per_call"], A - 1)
    return dict(path=path, tier=cfg.tier, weight_bits=PATHS[path][1], batch=1,
                sequential_tokens=seq_tokens[0].tolist(),
                steady_tokens=state["draft"][0].tolist(), **rows)


class StubTok:
    """A word tokenizer stand-in (BOS, one id per word by zlib.crc32)."""

    @staticmethod
    def encode(text):
        return [1] + [zlib.crc32(w.encode()) % 30000 + 1000 for w in text.split()]


class _RecordingModel:
    """The OpenVLA a server calls, recording each batch it serves (the
    requests in their bucket and the results) for the direct comparison."""

    def __init__(self, model):
        self.model, self.cfg, self.batches = model, model.cfg, []

    def predict_action_batch(self, images, prompts, unnorm_keys=None):
        out = self.model.predict_action_batch(images, prompts, unnorm_keys)
        self.batches.append((np.array(images), list(prompts), list(unnorm_keys), out))
        return out


def _post_act(port: int, payload: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/act",
                                 data=json.dumps(encode_numpy(payload)).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        out = decode_numpy(json.loads(r.read()))
    return out, (time.perf_counter() - t0) * 1e3


def _get_stats(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as r:
        return json.loads(r.read())


def run_serve(dev, params):
    """The action server on the card over the port's OpenVLA (turbo, int8
    weights at 7B width): a dynamically batching server answers
    SERVE_REQUESTS concurrent POST /act from threads, each batch's tokens
    equal to a direct predict_action_batch over the same requests in the same
    bucket (bit-equal: the kernels do no global atomics and no cross-row
    reduction); then a bs = 1 server with speculative streams answers
    SERVE_STREAM_STEPS steps of one stream on the same frame."""
    cfg = _serving("turbo", vlm.VLMConfig.openvla_7b(), action_dim=ACTION_DIM,
                   prompt_pad_len=PROMPT_PAD)
    A = ACTION_DIM
    stats = {"libero_spatial": {"action": {"q01": -np.ones(A, np.float32),
                                           "q99": np.ones(A, np.float32)}},
             "bridge_orig": {"action": {"q01": np.linspace(-0.5, 0, A).astype(np.float32),
                                        "q99": np.linspace(0.5, 2, A).astype(np.float32),
                                        "mask": np.array([True] * (A - 1) + [False])}}}
    model = vla.OpenVLA(params, cfg, StubTok(), stats, device=dev)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (SERVE_REQUESTS, IMG_HW, IMG_HW, 3), dtype=np.uint8)
    tasks = [f"pick up the {w} block and place it in bin {i}"
             for i, w in enumerate(("red", "green", "blue", "black", "white", "yellow"))]
    keys = [("libero_spatial", "bridge_orig")[i % 2] for i in range(SERVE_REQUESTS)]
    model.predict_action_batch(frames[:2], [get_openvla_prompt(t) for t in tasks[:2]], keys[:2])

    rec = _RecordingModel(model)
    srv = OpenVLAServer(rec, dynamic_batching=True, max_batch=8, max_wait_ms=50.0)
    srv.run(host="127.0.0.1", port=0, background=True)
    replies, client_ms = [None] * SERVE_REQUESTS, [None] * SERVE_REQUESTS
    try:
        def call(i):
            replies[i], client_ms[i] = _post_act(srv.port, {"image": frames[i],
                                                            "instruction": tasks[i],
                                                            "unnorm_key": keys[i]})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(SERVE_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        batched_stats = _get_stats(srv.port)
    finally:
        srv.shutdown()
        srv.batcher.shutdown()
    assert all(r is not None for r in replies), replies
    assert batched_stats["requests"] == SERVE_REQUESTS and batched_stats["batches"] == len(
        rec.batches) >= 1, batched_stats
    prompt_of = {get_openvla_prompt(t): i for i, t in enumerate(tasks)}
    for images, prompts, bkeys, results in rec.batches:
        direct = model.predict_action_batch(images, prompts, bkeys)
        for j, (r, d) in enumerate(zip(results, direct)):
            assert np.array_equal(r["action_tokens"], d["action_tokens"]), (prompts[j], r, d)
            i = prompt_of[prompts[j]]
            assert np.array_equal(replies[i]["action"], r["actions"]), i
    served = dict(requests=SERVE_REQUESTS, batches=[len(b[1]) for b in rec.batches],
                  tokens_equal_direct_batch=True, client_p50_ms=statistics.median(client_ms),
                  client_ms=client_ms, stats=batched_stats)

    srv = OpenVLAServer(model)         # bs = 1, speculative streams
    srv.run(host="127.0.0.1", port=0, background=True)
    step_ms = []
    try:
        assert srv._spec_streams
        payload = {"image": frames[0], "instruction": tasks[0], "unnorm_key": keys[0],
                   "stream_id": "arm-0"}
        actions = []
        for _ in range(SERVE_STREAM_STEPS):
            out, ms = _post_act(srv.port, payload)
            actions.append(out["action"])
            step_ms.append(ms)
        stream_stats = _get_stats(srv.port)
        n_accepted = [a for a, _ in srv._spec_accept]
    finally:
        srv.shutdown()
    assert len(n_accepted) == SERVE_STREAM_STEPS - 1, n_accepted
    assert all(np.isfinite(a).all() and a.shape == (A,) for a in actions)
    stream = dict(steps=SERVE_STREAM_STEPS, n_accepted_per_drafted_step=n_accepted,
                  client_p50_ms=statistics.median(step_ms), client_ms=step_ms,
                  speculative=stream_stats["speculative"],
                  latency_ms=stream_stats["latency_ms"])
    return dict(batched=served, stream=stream)


def check_tiny_spec(dev, path: str):
    """The speculative core at tiny fp32 size on the card vs the CPU run on the
    same weights: drafts correct, right for 3 tokens, and wrong, from the CPU's
    sequential tokens; equal tokens and n_accepted."""
    tvlm = _tiny_vlm(path)
    cfg = _serving(path, tvlm, prompt_pad_len=64, codec_vocab_size=tvlm.llm.vocab_size)
    params = _init(path, cfg.vlm, torch.Generator().manual_seed(1), "cpu")
    img_cfg = ImageTransformConfig(specs=(
        BackboneTransformSpec((28, 28), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        BackboneTransformSpec((28, 28), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))))
    inputs = _inputs(cfg, 4, 40, torch.Generator().manual_seed(2), "cpu")
    seq = vla.predict_action_from_image(params, cfg, inputs[0], img_cfg, *inputs[1:],
                                        device="cpu")["action_tokens"]
    params_d = _to(params, dev)
    rows = {}
    for kind in ("correct", "partial", "wrong"):
        draft = seq.clone()
        if kind == "partial":
            draft[:, 3:] = (draft[:, 3:] + 7) % cfg.codec_vocab_size
        elif kind == "wrong":
            draft = (draft + 1) % cfg.codec_vocab_size
        args = (inputs[1], inputs[2], draft, *inputs[3:])
        ref = vla.predict_action_speculative_from_image(params, cfg, inputs[0], img_cfg, *args,
                                                        device="cpu")
        _build.reset_launch_counts()
        out = vla.predict_action_speculative_from_image(
            params_d, cfg, inputs[0].to(dev), img_cfg, *(x.to(dev) for x in args), device=dev)
        torch.cuda.synchronize()
        assert torch.equal(out["action_tokens"].cpu(), ref["action_tokens"]), (kind, out, ref)
        assert torch.equal(out["n_accepted"].cpu(), ref["n_accepted"]), (kind, out, ref)
        rows[kind] = dict(n_accepted=ref["n_accepted"].tolist(),
                          launches={k: n for k, n in _build.KERNEL_LAUNCHES.items() if n})
    return dict(path=path, entry="speculative", tokens_equal=True, n_accepted_equal=True, **rows)


def _ab_leaves(tree):
    if tree is None:
        return []
    if set(tree) == {"A", "B"}:
        return [tree]
    return [leaf for v in tree.values() for leaf in _ab_leaves(v)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    log("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    _build.build_all()
    ptxas = {n: [l.strip() for l in out.splitlines() if "registers" in l or "spill" in l]
             for n, out in _build.build_report["logs"].items()}
    log("build", seconds=_build.build_report["seconds"], ptxas=ptxas)
    # each kernel's registers a thread and spill bytes, from ptxas -v
    log("resources", kernels={n: _build.resource_usage(out)
                              for n, out in _build.build_report["logs"].items()})

    g = torch.Generator(device=dev).manual_seed(1234)
    kernels = [check_flash_prefill(dev, g), check_flash_blockwise(dev, g),
               check_vit_attention(dev, g),
               check_decode_attention(dev, g), check_wi8_matmul(dev, g),
               check_fused_ln_w8a8(dev, g), check_fused_mlp_residual(dev, g),
               check_decode_split_attention(dev, g), check_stacked_decode_i8(dev, g),
               check_w4a8_matmul(dev, g), check_w8a8_matmul(dev, g), check_rms_norm_quant(dev, g),
               check_nib_hi_dot(dev, g), check_w4a8_dx(dev, g), check_w8a8_requant(dev, g),
               check_split_attention_i8(dev, g), check_w4a8_grouped(dev, g)]
    # the scalar routes: no main path takes them (the tiny fp32 paths do)
    scalar_routes = [check_decode_attention_scalar(dev, g),
                     check_decode_split_attention_scalar(dev, g), check_vit_attention_scalar(dev, g),
                     check_flash_prefill_scalar(dev, g), check_wi8_matmul_scalar(dev, g),
                     check_stacked_decode_i8_scalar(dev, g),
                     check_split_attention_i8_scalar(dev, g)]
    log("kernels", card=card, results=kernels, scalar_routes=scalar_routes)

    tiny = {}
    for path in PATHS:
        row = check_tiny_path(dev, path)
        tiny[path] = row["launches"]
        log("tiny", **row)
    for path in VLM_PATHS:
        log("tiny", **check_tiny_vlm(dev, path))
    for path in TRAIN_PATHS:
        log("tiny", **check_tiny_train(dev, path))
    for path in BS1_PATHS:
        log("tiny", **check_tiny_spec(dev, path))

    launches, weights = {}, {}
    # pallas, pallas_kv8, turbo, turbo_kv8 and turbo_fused share one build of the int8 weights
    # (fused in place after turbo's phases), pallas_int4 and turbo_int4 one of the int4 weights
    for path in PATHS:
        launches[path], main_stats = run_main_path(dev, path, weights)
        log("main", card=card, batch=BATCH, launches_per_call=launches[path], **main_stats)
        torch.cuda.empty_cache()
        if path == "pallas_kv8":   # the probe tap on the same weights
            log("probe", card=card, tap=run_probe_tap(dev, weights[PATHS[path][1]]))
            torch.cuda.empty_cache()
        if path in BS1_PATHS:      # the bs = 1 point on the same weights
            log("bs1", card=card, **run_bs1(dev, path, weights[PATHS[path][1]]))
            torch.cuda.empty_cache()
        if path == "turbo":        # the action server on turbo's int8 weights
            log("serve", card=card, **run_serve(dev, weights[PATHS[path][1]]))
            torch.cuda.empty_cache()
        if path == "parity":   # the base VLM's entry points on the same bf16 weights
            for vpath in VLM_PATHS:
                launches[vpath], vstats = run_vlm_path(dev, vpath, weights[None])
                log("main", card=card, launches_per_call=launches[vpath], **vstats)
                torch.cuda.empty_cache()
    weights.clear()
    for path in TRAIN_PATHS:
        launches[path], train_stats = run_train_path(dev, path)
        log("main", card=card, launches_per_step=launches[path], **train_stats)
        torch.cuda.empty_cache()
    log("probe", card=card, bank=run_probe_bank(dev))

    # each kernel's launches: from the main path whose slice ported it; a scalar route's from
    # every main path (none takes one) and, apart, from the tiny paths that run it
    for k in kernels:
        k["launches"] = launches[PORTED_ON.get(k["name"], "pallas")][k["name"]]
        assert k["launches"] > 0, k["name"]
    for k in scalar_routes:
        k["launches"] = sum(counts.get(k["name"], 0) for counts in launches.values())
        k["tiny_launches"] = sum(counts.get(k["name"], 0) for counts in tiny.values())
        assert k["tiny_launches"] > 0, k["name"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}), flush=True)
    print(json.dumps({"scalar_routes": [{key: k[key] for key in (*keys, "tiny_launches")}
                                        for k in scalar_routes]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
