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
and slice 5's loading and multi-LoRA serving:
  load          after the entry points, on the parity weights: written as the
                released openvla/openvla-7b repository (catalog.params_to_hf_state,
                the port's sharded safetensors writer, hf_export's config.json
                and dataset_statistics.json) into a temporary hub cache, then
                load.load_vla from it with OVLA_HUB_OFFLINE=1: the config, the
                parity path's tokens and first logits bit for bit, one
                predict_action_batch call; then quantize_int8=True: every trunk
                leaf bit-equal to linear.quantize_params, one call with its
                exact launches; bytes, write and load seconds, host peak RSS,
                device peak; the directory removed whatever happens
  multilora     after serve, on turbo's int8 weights: 4 adapters of rank 32
                over the all-linear target, rows [bare, 0, 1, 2, 3, ...],
                the masked then the fused install on turbo and on pallas:
                exact launches of the served tree, bare rows bit-equal to a
                zero-adapter call on the same routes (a wrapped leaf stands
                the fused norm and the fused tower kernels down), each
                adapter's rows' tokens and first logits bit for bit those of
                a single-adapter streamed run (masked) or of the fused
                install with every row on that adapter (fused, whose first
                logits also stay within ML_FUSED_GAP of the streamed run's);
                p50, busy ms, idle share, the banks' bytes and the peak
and slice 5b's command line, last, on the load phase's repository:
  cli           the port's six scripts as subprocesses (python -m
                openvla_probe_tpu_torch.scripts.<name>, no OVLA_* in their
                environment), each to exit code 0 within CLI_TIMEOUT_S: a
                seeded 32000-entry tokenizer.json written into the repository;
                deploy --quantize_int8 true --dynamic_batching true on a free
                port (seconds to listen and to the first 200 from /act, the
                kernel libraries reused within CLI_REUSE_S, CLI_SEQUENTIAL
                requests each bit-equal to an in-process
                load_vla(quantize_int8=True) wrapper's predict_action, the
                wrapper reading the tokenizer.json, the server's own kernel
                launches from its /stats equal to the wrapper's, then
                CLI_CONCURRENT at once with /stats's batches, each bit-equal
                to the wrapper's row at a bucket its batch can pad to;
                stopped with a deadline); generate (its output equal
                to the REPL run in this process over load()); evaluate --task
                closed on seeded PNGs (its report equal to the harness's here);
                convert_weights_to_hf on a trainer checkpoint cut to
                CLI_CONVERT_LAYERS layers (tensors bit-equal, loaded back with
                load bit for bit); train_probes then analyze_probes on seeded
                episodes at 33 x 4096 with the suite's 481 labels (every file
                the JAX scripts write; bare *_matrix.png heatmaps without
                matplotlib)
and slice 7's other models, after everything else, on a card that holds
nothing else (B = 8, P = 32, A = 7):
  moe_turbo     dinosiglip-vit-so-224px + mixtral-8x7b-v0.1 at full width and
                depth (32 layers, E = 8, top-2, GQA 32 / 8 heads) on the turbo
                tier, every TURBO_QUANT_SUFFIXES leaf int8 drawn directly on
                the card (47.7 GB, 45.1 GB of expert codes): 672
                expert_ragged launches a call (3 a layer and pass), two calls'
                tokens equal, p50, busy ms, the device peak
  moe_train     slice 8a, right after moe_turbo has freed its tree: QLoRA
                steps of the same VLM (tools/bench_finetune's Finetune, int8
                trunk and lm_head on the w8a8 STE route drawn on the card,
                towers bf16, streamed LoRA r = 32 on every linear with the
                expert stacks, the router frozen; AdamW 5e-4, remat, B = 8,
                T = 320): exact launches of one step (per MoE layer 18
                expert_ragged, 9 expert_ragged_dx, 6 expert_ragged_dw),
                finite losses and router losses, the base unchanged, B
                factors moved, step ms, examples/s, host syncs, peak memory
  moe_parity    the same VLM in bf16 at 4 layers (the kernel's bf16 form)
  phi           phi-2+3b (CLIP ViT-L/336, N = 577 at Dh 64 on vit_attention's
                tensor cores; Phi-2 at 32 layers) in bf16: score_short's 8 rows
and slice 6a's sharded serving, last, each rank a process spawned on the one
card (parallel.distributed.run_ranks: gloo, as the backend rule says for ranks
that share a card; a rank that raises, exits without a result or outlives
RANK_TIMEOUT_S fails the run; two processes time-sliced on one card give no
multi-card figure):
  tp2_turbo     OpenVLA-7B turbo at full width and depth, tp = 2, through
                vla.make_sharded_predict: turbo's int8 weights drawn on the
                card from the turbo path's seed in each rank, B = 24, P = 32,
                A = 7; each rank's exact launches at the shard shapes
                (row-parallel products on w8a8_row_absmax, w8a8_quant_given,
                w8a8_matmul_i32 and w8a8_epilogue), no torch._int_mm call; the sharded
                projector's output swapped for one process's projected
                patches (its float products sum fp32 partials across ranks:
                the distance printed), so that the towers' features, the
                action tokens, the first logits and every logit margin are
                held bit-equal to the one-process turbo call's; per rank one
                call's time (gloo's host path makes it seconds), busy ms,
                peak memory, the collectives' bytes
  ep2_moe_turbo Mixtral-8x7B's int8 trunk at full width cut to EP_LAYERS
                layers, ep = 2 (four experts a rank, the router whole): the
                prefill's and a decode step's trunk outputs bit-equal to one
                process's
and slice 6b's sharded training, after them:
  tp2_train_int8 train_int8's QLoRA step (OpenVLA-7B, the int8 trunk and
                lm_head on the w8a8 STE route, bf16 towers and projector,
                remat; B = 8, T = 64 text tokens, r = 32, B factors drawn
                small and nonzero) at tp = 2 through
                training.train_step.make_sharded_train_step: each rank's
                exact launches (o_proj and down_proj on the four row-parallel
                kernels, forward and remat recompute), no torch._int_mm call,
                the collectives' bytes forward and backward, busy ms, the
                step's wall time, peak memory, the base bit-unchanged; the
                loss, grad norm and every adapter gradient's direction and
                norm held within TRAIN_TP_TOL to one process's step from the
                same base, adapters and batch with its products rounded as
                two tp ranks round them (tools/tp_reference.py); the
                distances from it and from one process's plain step printed
                first
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
              and ragged shapes), wi8_matmul and w8a8_matmul also widened by
              128 rows at M = 24 / 6912, O = 4096 / 11008 (the fused
              multi-LoRA install: the first O columns bit-equal to the plain
              launch),
              rms_norm_quant (turbo; also at M = 1, odd D and fp32),
              nib_hi_dot (turbo_nibble), w4a8_dx (train_int4), w4a8_requant
              (pallas_int4's lm_head and SigLIP fc1, train_int4's lm_head;
              beside the two-step route it replaced; edge M, N and group
              sizes), expert_ragged (moe_turbo's int8 and moe_parity's bf16
              grouped products at the prefill's 4608 top-2 rows and a decode
              step's 16, E = 8, its two routes; skewed sizes with an empty
              expert, one-row groups, rows past the groups' sum, the route
              boundary M = 64 / 65, one expert holding every row, a group of
              129 rows; at the int8 prefill the outputs off an fp64
              reference's rounding counted for the kernel and the plain
              version, the kernel's at most 1.5x) and expert_ragged_scalar
              (fp32 x; its launches in the kernels line are the tiny fp32
              MoE path's, the one path that takes it), expert_ragged_dx and
              expert_ragged_dw (moe_train's backward at M = 5120, E = 8, r =
              32: the int8 base's dx and the adapters' dx, dA and dB, run
              twice bit-equal; dW of a full bf16 stack; at both int8 dx
              shapes the fp64 count, the kernel's at most 1.5x the plain
              version's; edge cases: an empty expert, one expert with every
              row, M off the tile, rows past the sum, r = 8, 16, 32 and 64,
              both sides of dx_tiling's split switch, one-row experts, O =
              8) and
              their scalar routes (fp32; launches from the tiny fp32 MoE
              training step), split_attention_i8 (turbo_kv8, its ring route; GQA,
              T = 291, T + A = 4096, fp32 scores, one row timed at the
              cluster rule beside 1, 2 and 4 CTAs, a row masked but BOS;
              decode_attention.compare_split_attention_i8),
              w4a8_grouped (turbo_int4 and turbo_mix at decode M: bit-equal;
              its pre-pass and GEMM also timed apart; edge M, N and group
              sizes, lm_head over three row blocks; the persistent grid's
              clusters); vit_attention also at DINOv2's 518 px, N = 1370,
              and at ragged N, bf16 (tensor cores) and fp32 (scalar route);
              the row-parallel product's four launches (w8a8_row_absmax,
              w8a8_quant_given, w8a8_matmul_i32, w8a8_epilogue; tp2_turbo)
              bit for bit at the tp = 2 shapes (o_proj K = 2048 and
              down_proj K = 5504 at M = 6912 and 24, the towers' proj and
              fc2, SigLIP's fc2 K = 2152 padded to 2160) and at SigLIP's fc2
              at tp = 8 (K = 538, its columns zero-padded to 540), with the library
              calls' times (torch.linalg.vector_norm, torch._int_mm; for the
              codes torch.quantize_per_channel where it gives the same
              codes) and each wrapper's host time;
              the scalar routes (the decode attentions' at fp32 and Dh = 72,
              vit_attention's, flash_prefill's and wi8_matmul's in fp32,
              split_attention_i8's in fp32 and at Dh = 64, n_rep 3),
              which no main path takes: a line of their own
              (`scalar_routes`), with the main paths' launches (0) and the
              tiny paths' (`tiny_launches`)
  4. tiny     each path at tiny fp32 size on the card vs the CPU run (plain
              versions, which the CPU tests hold against the JAX package):
              equal tokens, close logits or scores (tiny_moe: the mixtral-tiny
              trunk in fp32 and in bf16; tiny_moe_train: one QLoRA step of
              it, loss, router losses, gradients, adapters and launches);
              the training paths' loss,
              LoRA gradients and adapters after one step; the speculative core
              on turbo and turbo_nibble (drafts correct, partial, wrong): equal
              tokens and n_accepted; multi-LoRA calls on parity (masked),
              turbo and pallas (masked and fused): equal tokens;
              tiny_parallel (TINY_PARALLEL: parity, turbo and pallas_int4 at
              dp = 2 x tp = 2, turbo at fsdp = 4, multi-LoRA on turbo at dp =
              2 x tp = 2, four ranks) against the same tiny path on one card:
              tokens equal, or within the margin rule, the counts printed;
              and its training cases (TINY_TRAIN_PARALLEL: one QLoRA step of
              the tiny int8 trainer at dp x tp, zero2 on dp x fsdp, fsdp+tp,
              sp x tp) against one process's step on the card by
              check_tiny_train's rules (loss, each LoRA gradient, adapters);
              nccl_world_1: the sharded forward's collectives on NCCL
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
then a `phases` line (each phase's wall seconds, the whole script's), the
card's name and power limit, a JSON line of per-kernel figures (each kernel's
launches from the main path's run), a JSON line of the scalar routes'
figures, and a last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero; with
no CUDA card it exits 1 before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import json
import os
import resource
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
import zlib
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import (catalog, generate, hf_export, llama, multilora,
                                             safetensors_io, tokenization, vit, vla, vlm)
from openvla_probe_tpu_torch.models import load as load_mod
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import attention as attn
from openvla_probe_tpu_torch.ops import decode_attention as dattn
from openvla_probe_tpu_torch.ops import expert_ragged as ragged
from openvla_probe_tpu_torch.ops import linear as lin
from openvla_probe_tpu_torch.ops import rmsnorm_quant as rmsq
from openvla_probe_tpu_torch.ops import vit_mlp as vmlp
from openvla_probe_tpu_torch.parallel import distributed as pdist
from openvla_probe_tpu_torch.parallel import mesh as pmesh
from openvla_probe_tpu_torch.parallel import sharding as psharding
from openvla_probe_tpu_torch.parallel import tensor_parallel as tp
from openvla_probe_tpu_torch.ops.image import (BackboneTransformSpec, ImageTransformConfig,
                                               apply_image_transform)
from openvla_probe_tpu_torch.probe import train_probes
from openvla_probe_tpu_torch.scripts import ON_HOST
from openvla_probe_tpu_torch.scripts import _cli as cli
from openvla_probe_tpu_torch.serving.server import (OpenVLAServer, decode_numpy, encode_numpy,
                                                    get_openvla_prompt)
from openvla_probe_tpu_torch.tools import (bench_finetune, kernel_ab, profile_main_path,
                                           tp_reference)
from openvla_probe_tpu_torch.tools.kernel_ab import rotating
from openvla_probe_tpu_torch.tools.synthetic_tokenizer import write_llama_tokenizer
from openvla_probe_tpu_torch.training.lora import (LoRAConfig, attach_lora, init_lora_params,
                                                   make_lora_loss_fn)
from openvla_probe_tpu_torch.training.train_state import (OptimizerConfig, TrainState,
                                                          make_optimizer, tree_leaves)
from openvla_probe_tpu_torch.training.train_step import (make_sharded_train_step,
                                                         make_train_step, place_train_state,
                                                         value_and_grad, vla_loss_fn)
from openvla_probe_tpu_torch.vla.action_tokenizer import ActionCodec
from openvla_probe_tpu_torch.utils import image_io

# published H100 SXM peaks (dense): HBM bytes/s; bf16 and int8 tensor-core and
# fp32 FMA operations/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
BATCH, PROMPT_PAD, ACTION_DIM, IMG_HW = 24, 32, 7, 256
LAYERS, T_PREFILL = 32, 288            # Llama-2-7B layers; 1 + 256 patches + 31 prompt tokens
TOWER_LAUNCHES = {"dinov2": 23, "siglip": 26}   # blocks 0..L-2 of each tower run
TIMED_CALLS = 3
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


_START = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One output line: the phase, its fields, and the script's seconds so far
    (where the time limit goes)."""
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - _START, 1),
                      **fields}), flush=True)


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


# the fused multi-LoRA install's widened products (ROADMAP hazard "bare-base bits"): the
# first O columns of an [O + N·r]-row launch must be the O-row launch's bit for bit, at
# the decode and prefill M, for q/k/v/o (O = 4096) and gate/up (O = 11008), N·r = 128
WIDENED_RANKS = 128


def _widened_first_columns(kernel: str, fn, g, dev) -> dict:
    """`fn(x, q, s)` over q [O + N·r, K] and over its first O rows: the first
    O columns torch.equal, each launch counted once."""
    out = {}
    for M in (BATCH, BATCH * T_PREFILL):
        for O in (4096, 11008):
            x = torch.randn((M, 4096), generator=g, device=dev).bfloat16()
            q = torch.randint(-127, 128, (O + WIDENED_RANKS, 4096), generator=g, device=dev,
                              dtype=torch.int8)
            s = torch.rand((O + WIDENED_RANKS,), generator=g, device=dev) * 1e-3 + 1e-3
            wide = _launched(kernel, lambda: fn(x, q, s))
            plain = _launched(kernel, lambda: fn(x, q[:O], s[:O]))
            assert torch.equal(wide[:, :O], plain), f"{kernel} {M}x4096x{O}: widened columns"
            out[f"{M}x4096x{O}+{WIDENED_RANKS}"] = "first O columns bit-equal"
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
    widened = _widened_first_columns("wi8_matmul", lin.wi8_matmul, g, dev)
    return dict(name="wi8_matmul", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/wi8_matmul.cu",
                replaces="openvla_probe_tpu/ops/linear.py:327", by_shape=by_shape,
                widened=widened, **mix)


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
    widened = _widened_first_columns(
        "w8a8_matmul", lambda x, q, s: lin.w8a8_matmul(x, {"q": q, "s": s}), g, dev)
    return dict(name="w8a8_matmul", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/w8a8_matmul.cu",
                replaces="openvla_probe_tpu/ops/linear.py:413", by_shape=by_shape,
                edge_cases=edges, train_mix=train, nibble_mix=nibble_mix, widened=widened,
                **mix)


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
             "split_attention_i8": "turbo_kv8", "w4a8_grouped": "turbo_int4",
             "expert_ragged": "moe_turbo", "expert_ragged_scalar": "tiny_moe_float32",
             "expert_ragged_dx": "moe_train", "expert_ragged_dw": "moe_train",
             "expert_ragged_dx_scalar": "tiny_moe_train_float32",
             "expert_ragged_dw_scalar": "tiny_moe_train_float32",
             "w8a8_row_absmax": "tp2_turbo", "w8a8_quant_given": "tp2_turbo",
             "w8a8_matmul_i32": "tp2_turbo", "w8a8_epilogue": "tp2_turbo"}
# kernels whose only launches come from a tiny path (the scalar routes of fp32)
TINY_PORTED = ("expert_ragged_scalar", "expert_ragged_dx_scalar", "expert_ragged_dw_scalar")


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


def _linear_route(leaf, int8_matmul: str, M: int):
    """The kernel matmul_t launches for a leaf's layout (a spec `Leaf` per
    tensor, or the tensors themselves), on the config's int8 route, at M
    rows; None for a float leaf (a PyTorch product). A multi-LoRA or LoRA
    wrapper launches its base's kernel (the rank products are PyTorch's); a
    fused multi-LoRA leaf its widened int8 product ("qf") or none ("wf")."""
    if isinstance(leaf, dict) and "base" in leaf:       # LoRA / masked multi-LoRA
        return _linear_route(leaf["base"], int8_matmul, M)
    if isinstance(leaf, dict) and "qf" in leaf:         # fused multi-LoRA over int8
        return "wi8_matmul" if int8_matmul == "wi8" else "w8a8_matmul"
    if not isinstance(leaf, dict) or "wf" in leaf:      # a float product
        return None
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
    above M = 32 (llama._norm_maybe_quant); never a wrapped leaf."""
    if not isinstance(leaf, dict):
        return False
    if "q4" in leaf:
        return M > lin.NIB_HI_M_MAX
    return lin.is_int8_per_channel(leaf)


def _expected_launches(path: str, cfg: vla.VLAServingConfig, batch: int = BATCH, spec=None):
    """Exact per-kernel launches of one call, from the weight layout (the
    path's convert.vlm_param_spec, or `spec`: the tree a call serves, its
    multi-LoRA wrappers included) and the routes of the port, with the
    activation pre-pass of each int8 GEMM call (_build.PRE_PASSES) counted
    apart: every call but w8a8's on the fused norm's codes launches one. A
    fused path runs one product for q/k/v and one for gate/up."""
    c = cfg.vlm
    L, A1 = c.llm.num_hidden_layers, cfg.action_dim - 1
    kernels = dict.fromkeys(_build.KERNEL_LAUNCHES, 0)
    blocks = sum(v.num_layers - 1 for v in c.vision)       # 23 + 26 tower blocks run
    kernels.update(flash_prefill=L, vit_attention=blocks)
    attn = {"stacked": "decode_attention", "stacked_kv8": "stacked_decode_attention_i8",
            "frozen_kv": "split_attention_i8" if cfg.kv_int8 else "decode_split_attention"}
    kernels[attn[cfg.decode_impl]] = L * A1
    if spec is None:
        bits = PATHS[path][1]
        if bits is None:
            return kernels
        spec = convert.vlm_param_spec(c, lin.TURBO_QUANT_SUFFIXES, bits)

    def add(kernel, n):
        if kernel is not None:
            kernels[kernel] += n

    for name, v in zip(c.vision_names, c.vision):
        b, n = spec["vision"][name]["blocks"], v.num_layers - 1
        # the fused kernels where a pair's leaves are int8 on "wi8": one GEMM launch per
        # linear of the pair (fc1's counted as fused_mlp_fc1), each with its pre-pass
        for pair, fused in ((("qkv_w", "proj_w"), ("fused_ln_w8a8", "fused_ln_w8a8")),
                            (("fc1_w", "fc2_w"), ("fused_mlp_fc1", "fused_mlp_residual"))):
            if v.int8_matmul == "wi8" and all(lin.is_int8_per_channel(b[w]) for w in pair):
                for gemm in fused:
                    kernels[gemm] += n
            else:
                for w in pair:
                    add(_linear_route(b[w], v.int8_matmul, 2 ** 20), n)
    for fc in spec["projector"].values():
        add(_linear_route(fc["w"], "wi8", 2 ** 20), 1)
    layers, route = spec["llm"]["layers"], c.llm.int8_matmul
    fused_leaves = path in FUSED_PATHS or "qkv_proj" in layers
    # the products of a layer (q/k/v and gate/up one each when fused) at prefill (M = B x T)
    # and at each step (M = B); lm_head 1 + A1 times. A MoE trunk's FFN is three grouped
    # expert products a layer and pass (gate, up, down) in any weight form
    moe = "router" in layers
    groups = (("q_proj", "k_proj", "v_proj"), ("o_proj",)) + (
        () if moe else (("gate_proj", "up_proj"), ("down_proj",)))
    fused_name = {groups[0]: "qkv_proj", ("gate_proj", "up_proj"): "gate_up_proj"}
    if moe:
        kernels["expert_ragged"] = 3 * L * (1 + A1)

    def leaves_of(group):   # the leaves a group runs: one when fused (its layout the first's)
        if not fused_leaves:
            return [layers[w] for w in group]
        return [layers.get(fused_name.get(group), layers.get(group[0]))]

    for group in groups:
        for leaf in leaves_of(group):
            add(_linear_route(leaf, route, batch * T_PREFILL), L)
            add(_linear_route(leaf, route, batch), L * A1)
    add(_linear_route(spec["llm"]["lm_head"], route, batch), 1 + A1)
    # the fused norm: both sites of every layer whose consumers all take int8 codes (the
    # input norm only on a MoE trunk: the router reads the float norm), in the prefill and,
    # on the stacked decode, in every step of more than 8 rows (the frozen-KV and int8-cache
    # decode steps keep the plain norm)
    prequant = 0   # w8a8 calls on the fused norm's codes: no pre-pass
    if c.llm.fused_rmsq and route == "w8a8":
        steps = A1 if cfg.decode_impl == "stacked" and batch > llama.RMSQ_MIN_M - 1 else 0
        for M, n in ((batch * T_PREFILL, 1), (batch, steps)):
            for site in (groups[0],) + (() if moe else (groups[2],)):
                leaves = leaves_of(site)
                if n and all(_takes_int8_codes(leaf, M) for leaf in leaves):
                    kernels["rms_norm_quant"] += L * n
                    prequant += len(leaves) * L * n
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
MAIN_MARGINS = {}   # path -> its driven call's logit margins
MAIN_TOWERS = {}    # turbo's driven call: its tower features and projected patches
MAIN_P50 = {}       # path -> p50 ms


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
    param_gb = _tree_bytes(params) / 1e9
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
    towers, project = {}, vlm.project_patches

    def recording(p, c, feats):            # turbo's features and patches, for tp2_turbo
        towers["features"], towers["patches"] = feats, project(p, c, feats)
        return towers["patches"]

    with mock.patch.object(torch, "_int_mm", _counting_int_mm(int_mm_calls)), \
            mock.patch.object(vlm, "project_patches", recording):
        _build.reset_launch_counts()       # counts from 0 around one driven call
        t0 = time.perf_counter()
        out = call()
        first_s = time.perf_counter() - t0
        launches = dict(_build.KERNEL_LAUNCHES)
    if path == "turbo":
        MAIN_TOWERS.update({k: v.cpu() for k, v in towers.items()})
    expect = _expected_launches(path, cfg)
    assert launches == expect, (path, launches, expect)
    assert not int_mm_calls, (path, len(int_mm_calls))

    toks, actions, logits = out["action_tokens"], out["actions"], out["first_logits"]
    assert toks.shape == (BATCH, ACTION_DIM), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vlm.llm.vocab_size
    assert actions.shape == (BATCH, ACTION_DIM) and torch.isfinite(actions).all()
    assert logits.shape == (BATCH, cfg.vlm.llm.vocab_size) and torch.isfinite(logits).all()
    MAIN_OUT[path] = (toks, logits)
    MAIN_MARGINS[path] = out["logit_margins"]
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
    MAIN_P50[path] = p50 * 1e3
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
    without it (torch.profiler, one call each: tap, then none)."""
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
    for tap in (True, False):
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


def _map_ab(lora, fn):
    """fn over each {"A", "B"} adapter of a LoRA tree (None stays None)."""
    if lora is None:
        return None
    if set(lora) == {"A", "B"}:
        return fn(lora)
    return {k: _map_ab(v, fn) for k, v in lora.items()}


def _random_b(lora, g, scale: float = 0.02):
    """The adapters with B drawn N(0, scale) from `g` (on B's device), so
    that every factor has a gradient in the first step and every adapter
    changes its rows."""
    return _map_ab(lora, lambda lw: {"A": lw["A"], "B": torch.randn(
        lw["B"].shape, generator=g, device=lw["B"].device) * scale})


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

BS1_TIMED = 2
BS1_PATHS = ("turbo", "turbo_nibble")
SERVE_REQUESTS, SERVE_STREAM_STEPS = 6, 4


def _bs1_measure(fn, busy: bool = True):
    """A warm-up call, then BS1_TIMED calls each with every count set to 0
    just before and read just after (the same counts every call), then, with
    `busy`, the card's busy ms of one more call (torch.profiler; ~10 s of
    the profiler's own host work a call, so only the sequential and the
    steady-state calls take it)."""
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
    prof = profile_main_path.device_time(fn, 1) if busy else {}
    return out, dict(p50_ms=statistics.median(times) * 1e3, call_ms=[t * 1e3 for t in times],
                     busy_ms_per_call=prof.get("device_ms_per_call_total"),
                     device_idle_share=prof.get("device_idle_share"), launches_per_call=launches)


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
    out, rows["spec_sequential_draft"] = _bs1_measure(lambda: spec(seq_tokens), busy=False)
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
    out, rows["spec_wrong_draft"] = _bs1_measure(lambda: spec(wrong), busy=False)
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


# --- multi-LoRA serving (models/multilora.py) -------------------------------------------

# the JAX package's deployment point: N = 4 adapters of rank 32 over the all-linear target
# (the reference's PEFT target: every Llama projection, the towers' linears, the projector),
# on turbo's and pallas's int8 weights; the B = 24 rows take adapters [bare, 0, 1, 2, 3, ...]
ML_ADAPTERS, ML_RANK, ML_PATHS = 4, 32, ("turbo", "pallas")
# timed calls an install (one, to leave tp2_train_int8 room in the time cap), and the busy
# time (torch.profiler) on the first tier only
ML_TIMED_CALLS = 1
# first-logit tolerance of a tiny multi-LoRA path, card vs CPU: parity TINY_TOL's; int8
# weights 4e-3 (TINY_TOL's reason, with every linear's rank products summed in another
# order on the card: more activation codes sit one step apart at a tie; measured 1.4e-3
# and 2.7e-3 on turbo's masked and fused installs, 2e-7 on parity)
ML_TINY_TOL = {None: TINY_TOL[None], 8: 4e-3}
# the most a fused install's adapter rows' first logits may sit from the single-adapter
# streamed run's (bf16 x·Aᵀ there, the base's int8 product of int8 A rows here): measured
# 0.69 on turbo and 0.23 on pallas (w8a8 also quantizes the activations), where an adapter
# moves its rows by 5.8 to 6.3, so a missing or wrong adapter sits far past it
ML_FUSED_GAP = 1.5


def _ml_ids(batch: int) -> np.ndarray:
    return np.array(([-1] + list(range(ML_ADAPTERS))) * batch)[:batch]


def _margin_rule(got, want, margins, gap: float) -> int:
    """tests/test_torch_turbo_kv8.assert_tokens: each row's tokens equal up to
    its first token whose margin (in `want`'s run) is below 2 · gap; the count
    compared."""
    n = 0
    for b in range(want.shape[0]):
        for t in range(want.shape[1]):
            if margins[b, t] < 2 * gap:
                break
            assert got[b, t] == want[b, t], (b, t, got[b].tolist(), want[b].tolist())
            n += 1
    return n


def _zero_b(lora):
    """An adapter whose B is 0: attached with training.lora.attach_lora, the
    base's function on the routes a wrapped leaf takes."""
    if lora is None:
        return None
    if set(lora) == {"A", "B"}:
        return {"A": lora["A"], "B": torch.zeros_like(lora["B"])}
    return {k: _zero_b(v) for k, v in lora.items()}


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree) if t is not None)


def check_tiny_multilora(dev, path: str, install: str):
    """A multi-LoRA call at tiny fp32 size (4 adapters of rank 4 over the
    all-linear target, rows [bare, 0, 1, 2]) on the card vs the CPU run of the
    plain versions: equal tokens, first logits within TINY_TOL; the wrapped
    leaves stand the fused norm and the fused tower kernels down (0
    launches)."""
    tvlm = _tiny_vlm(path)
    cfg = _serving(path, tvlm, prompt_pad_len=64, codec_vocab_size=tvlm.llm.vocab_size)
    params = _init(path, cfg.vlm, torch.Generator().manual_seed(1), "cpu")
    lcfg = LoRAConfig(r=4)
    adapters = [_random_b(init_lora_params(params, lcfg, torch.Generator().manual_seed(5 + i)),
                          torch.Generator().manual_seed(9 + i), 0.05) for i in range(4)]
    bank = multilora.stack_adapter_banks(adapters, lcfg, dtype=cfg.vlm.llm.dtype)
    ids = np.array([-1, 0, 1, 2])
    img_cfg = ImageTransformConfig(specs=(
        BackboneTransformSpec((28, 28), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        BackboneTransformSpec((28, 28), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))))
    inputs = _inputs(cfg, 4, 40, torch.Generator().manual_seed(2), "cpu")

    def tree(p, b, device):
        sel = multilora.adapter_one_hot(ids, 4, device=device)
        if install == "fused":
            return multilora.attach_multilora_fused(multilora.fuse_bank_into_base(p, b), sel)
        return multilora.attach_multilora(p, b, sel)

    ref = vla.predict_action_from_image(tree(params, bank, "cpu"), cfg, inputs[0], img_cfg,
                                        *inputs[1:], return_first_logits=True, device="cpu")
    params_d, bank_d = _to(params, dev), _to(bank, dev)
    _build.reset_launch_counts()
    out = vla.predict_action_from_image(tree(params_d, bank_d, dev), cfg, inputs[0].to(dev),
                                        img_cfg, *(x.to(dev) for x in inputs[1:]),
                                        return_first_logits=True, device=dev)
    torch.cuda.synchronize()
    launches = {k: n for k, n in _build.KERNEL_LAUNCHES.items() if n}
    for stood_down in ("rms_norm_quant", "fused_ln_w8a8", "fused_mlp_residual"):
        assert stood_down not in launches, (path, install, launches)
    assert torch.equal(out["action_tokens"].cpu(), ref["action_tokens"]), (path, install)
    err = (out["first_logits"].cpu() - ref["first_logits"]).abs().max().item()
    assert err < ML_TINY_TOL[PATHS[path][1]], err
    return dict(path=path, entry="multilora", install=install, tokens_equal=True,
                first_logits_max_abs_err=err, launches=launches)


def run_multilora(dev, params):
    """N = 4 adapters at r = 32 over turbo's int8 weights (the all-linear
    target), rows [bare, 0, 1, 2, 3, ...] at B = 24, on the turbo and pallas
    tiers, masked install then fused install: four runs. Each: exact launch
    counts from the served tree; the bare rows' tokens and first logits bit
    for bit those of the same tier's call with a zero-B adapter attached
    (training.lora.attach_lora: the base on the routes a wrapped leaf takes:
    no fused norm, no fused tower kernel), and, reported, how far they sit
    from the plain path's (MAIN_OUT, which takes both); each adapter's rows'
    tokens and first logits: on the masked install bit for bit those of a
    single-adapter streamed run of it (training.lora.attach_lora); on the
    fused install bit for bit those of the fused install with every row on
    that adapter (rows do not depend on each other), and within
    ML_FUSED_GAP of the streamed run (the rank projection is the base's int8
    product there), whose tokens they equal up to the margin rule
    (`_margin_rule`, reported); p50, busy ms and idle share; the banks'
    bytes and the peak."""
    lcfg = LoRAConfig(r=ML_RANK)
    g = torch.Generator(device=dev).manual_seed(31)
    t0 = time.perf_counter()
    adapters = [_random_b(init_lora_params(params, lcfg, g), g) for _ in range(ML_ADAPTERS)]
    bank = multilora.stack_adapter_banks(adapters, lcfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ids = _ml_ids(BATCH)
    bare = torch.as_tensor(ids == -1, device=dev)
    sel = multilora.adapter_one_hot(ids, ML_ADAPTERS, device=dev)
    img_cfg = ImageTransformConfig.dinosiglip_224()
    fused_tree, fuse_s, runs = None, None, []
    for path in ML_PATHS:
        cfg = _serving(path, vlm.VLMConfig.openvla_7b(), action_dim=ACTION_DIM,
                       prompt_pad_len=PROMPT_PAD)
        image, tok, plen, q01, q99, mask = _inputs(
            cfg, BATCH, IMG_HW, torch.Generator(device=dev).manual_seed(1), dev)

        def run(tree):
            out = vla.predict_action_from_image(tree, cfg, image, img_cfg, tok, plen, q01, q99,
                                                mask, return_first_logits=True, device=dev)
            torch.cuda.synchronize()
            return out

        ref = run(attach_lora(params, _zero_b(adapters[0]), lcfg))
        single = [run(attach_lora(params, a, lcfg)) for a in adapters]
        for install in ("masked", "fused"):
            if install == "fused" and fused_tree is None:
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                fused_tree = multilora.fuse_bank_into_base(params, bank)
                torch.cuda.synchronize()
                fuse_s = time.perf_counter() - t0
            tree = (multilora.attach_multilora(params, bank, sel) if install == "masked"
                    else multilora.attach_multilora_fused(fused_tree, sel))
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            out = run(tree)
            launches = {k: n for k, n in _build.KERNEL_LAUNCHES.items()}
            expect = _expected_launches(path, cfg, spec=tree)
            assert launches == expect, (path, install, launches, expect)
            toks, logits = out["action_tokens"], out["first_logits"]
            assert torch.isfinite(logits).all() and torch.isfinite(out["actions"]).all()
            assert torch.equal(toks[bare], ref["action_tokens"][bare]), (path, install)
            assert torch.equal(logits[bare], ref["first_logits"][bare]), (path, install)
            main_toks, main_logits = MAIN_OUT[path]
            per_adapter = []
            for k in range(ML_ADAPTERS):
                rows = torch.as_tensor(ids == k, device=dev)
                streamed = single[k]
                gap = (logits[rows] - streamed["first_logits"][rows]).abs().max().item()
                moved = (streamed["first_logits"][rows] - ref["first_logits"][rows]).abs()
                moved = moved.max().item()
                assert moved > 2 * ML_FUSED_GAP, (path, k, moved)   # the checks can fail
                if install == "masked":
                    want, n = streamed, streamed["action_tokens"][rows].numel()
                else:
                    assert gap < ML_FUSED_GAP, (path, install, k, gap)
                    n = _margin_rule(toks[rows].cpu(), streamed["action_tokens"][rows].cpu(),
                                     streamed["logit_margins"][rows].cpu(), gap)
                    one = multilora.adapter_one_hot(k, ML_ADAPTERS, BATCH, device=dev)
                    want = run(multilora.attach_multilora_fused(fused_tree, one))
                assert torch.equal(toks[rows], want["action_tokens"][rows]), (path, install, k)
                assert torch.equal(logits[rows], want["first_logits"][rows]), (path, install, k)
                per_adapter.append(dict(
                    adapter=k, rows=int(rows.sum()),
                    bit_equal_to="streamed" if install == "masked" else "fused, every row k",
                    first_logits_gap_streamed=gap, tokens_compared_streamed=n,
                    rows_tokens_equal_streamed=int((toks[rows] == streamed["action_tokens"][rows])
                                                   .all(1).sum()),
                    adapter_moves_logits_by=moved))
            times = []
            for _ in range(ML_TIMED_CALLS):
                t0 = time.perf_counter()
                run(tree)
                times.append(time.perf_counter() - t0)
            busy = (profile_main_path.device_time(lambda: run(tree), 1) if path == ML_PATHS[0]
                    else dict.fromkeys(("device_ms_per_call_total", "device_ms_per_call_by_class",
                                        "device_idle_share")))
            runs.append(dict(
                path=path, tier=cfg.tier, install=install, adapters=ML_ADAPTERS, rank=ML_RANK,
                rows=ids.tolist(), launches_per_call=launches,
                bare_rows_bit_equal_to_zero_adapter=True,
                bare_rows_tokens_equal_main=int((toks[bare] == main_toks[bare]).all(1).sum()),
                bare_rows_first_logits_from_main=(logits[bare] - main_logits[bare]).abs()
                .max().item(),
                per_adapter=per_adapter, p50_ms=statistics.median(times) * 1e3,
                call_ms=[t * 1e3 for t in times],
                device_ms_per_call=busy["device_ms_per_call_total"],
                device_ms_by_class=busy["device_ms_per_call_by_class"],
                device_idle_share=busy["device_idle_share"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
            del out, tree
        del ref, single
    result = dict(banks_bytes=_tree_bytes(bank), fused_extra_bytes=_tree_bytes(fused_tree)
                  - _tree_bytes(params), setup_s=setup_s, fuse_s=fuse_s, runs=runs)
    del fused_tree, bank, adapters
    return result


# --- loading a checkpoint (models/load.py) ----------------------------------------------

LOAD_REPO, LOAD_SHA = "openvla/openvla-7b", "0" * 40
LOAD_SHARD_BYTES = 5 << 30   # the released repository's shard size (model-0000i-of-00003)


def _peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6   # KiB on Linux


def run_load(dev, params, root: Path):
    """The parity path's bf16 weights written as a released HF repository
    (params_to_hf_state, the port's sharded safetensors writer, hf_export's
    config.json and dataset_statistics.json) into a temporary hub cache, then
    load_vla("openvla/openvla-7b") from it with OVLA_HUB_OFFLINE=1: its config
    VLMConfig.openvla_7b(), the parity path's tokens and first logits bit for
    bit over the loaded weights, one predict_action_batch call through the
    wrapper; then quantize_int8=True: every trunk leaf torch.equal to
    linear.quantize_params(bits=8) of the in-memory tree, one call with the
    exact launches of its tree. Bytes written, write and load seconds (to the
    card, synchronised), host peak RSS (the process's, before and after),
    device peak. The repository stays under `root` for the cli phase (main
    removes `root` whatever happens)."""
    vcfg = vlm.VLMConfig.openvla_7b()
    A = ACTION_DIM
    stats = {"bridge_orig": {"action": {"q01": [-0.5] * A, "q99": [0.5] * A,
                                        "mask": [True] * (A - 1) + [False]}}}
    env_was = os.environ.get("OVLA_HUB_OFFLINE")
    try:
        repo = root / f"models--{LOAD_REPO.replace('/', '--')}"
        snap = repo / "snapshots" / LOAD_SHA
        (repo / "refs").mkdir(parents=True)
        (repo / "refs" / "main").write_text(LOAD_SHA)
        free_gb = shutil.disk_usage(root).free / 1e9
        rss0 = _peak_rss_gb()
        t0 = time.perf_counter()
        written = safetensors_io.save_sharded(catalog.params_to_hf_state(params, vcfg), snap,
                                              max_shard_bytes=LOAD_SHARD_BYTES,
                                              dtype=torch.bfloat16)
        hf_export.write_export_sidecars(snap, vcfg, ImageTransformConfig.dinosiglip_224(),
                                        "dinosiglip-vit-so-224px", "llama2-7b-pure",
                                        vcfg.arch_specifier, "resize-naive", norm_stats=stats)
        write_s = time.perf_counter() - t0
        rss_write = _peak_rss_gb()
        os.environ["OVLA_HUB_OFFLINE"] = "1"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = load_mod.load_vla(LOAD_REPO, cache_dir=root, tokenizer=StubTok(),
                                  prompt_pad_len=PROMPT_PAD, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        rss_load, dev_peak = _peak_rss_gb(), torch.cuda.max_memory_allocated() / 1e9
        assert model.cfg.vlm == vcfg, model.cfg.vlm
        assert model.cfg.tier == "parity" and model.cfg.codec_vocab_size == 32000
        img_cfg = ImageTransformConfig.dinosiglip_224()
        assert model.image_cfg == img_cfg, model.image_cfg
        cfg = _serving("parity", vcfg, action_dim=A, prompt_pad_len=PROMPT_PAD)
        image, ids, plen, q01, q99, mask = _inputs(
            cfg, BATCH, IMG_HW, torch.Generator(device=dev).manual_seed(1), dev)
        out = vla.predict_action_from_image(model.params, cfg, image, img_cfg, ids, plen, q01,
                                            q99, mask, return_first_logits=True, device=dev)
        assert torch.equal(out["action_tokens"], MAIN_OUT["parity"][0]), "loaded parity tokens"
        assert torch.equal(out["first_logits"], MAIN_OUT["parity"][1]), "loaded parity logits"
        rng = np.random.default_rng(7)
        frames = rng.integers(0, 256, (BATCH, IMG_HW, IMG_HW, 3), dtype=np.uint8)
        prompts = [get_openvla_prompt(f"pick up object {i} and place it in bin {i % 3}")
                   for i in range(BATCH)]
        t0 = time.perf_counter()
        batch = model.predict_action_batch(frames, prompts)
        batch_ms = (time.perf_counter() - t0) * 1e3
        assert len(batch) == BATCH and all(np.isfinite(r["actions"]).all() for r in batch)
        del model, out
        torch.cuda.empty_cache()

        # quantize_int8: each trunk leaf quantized on the card as it is read
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        qmodel = load_mod.load_vla(LOAD_REPO, cache_dir=root, tokenizer=StubTok(),
                                   prompt_pad_len=PROMPT_PAD, quantize_int8=True, device=dev)
        torch.cuda.synchronize()
        qload_s = time.perf_counter() - t0
        qdev_peak = torch.cuda.max_memory_allocated() / 1e9
        assert qmodel.cfg.tier == "turbo"
        qllm, n_leaves = qmodel.params["llm"], 0
        trunk = [(("layers", k), v) for k, v in params["llm"]["layers"].items()]
        for key, leaf in trunk + [((k,), params["llm"][k]) for k in ("embed_tokens", "norm",
                                                                     "lm_head")]:
            name = key[-1]
            got = qllm["layers"][name] if key[0] == "layers" else qllm[name]
            want = lin.quantize_params({name: leaf}, bits=8)[name]
            if isinstance(want, dict):
                assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want), \
                    name
                n_leaves += 1
            else:
                assert torch.equal(got, want), name
            del want
        _build.reset_launch_counts()
        qout = vla.predict_action_from_image(qmodel.params, qmodel.cfg, image, qmodel.image_cfg,
                                             ids, plen, q01, q99, mask, return_first_logits=True,
                                             device=dev)
        torch.cuda.synchronize()
        qlaunches = dict(_build.KERNEL_LAUNCHES)
        qexpect = _expected_launches("turbo", qmodel.cfg, spec=qmodel.params)
        assert qlaunches == qexpect, (qlaunches, qexpect)
        assert torch.isfinite(qout["first_logits"]).all()
        qtoks = qout["action_tokens"]
        del qmodel, qout
        torch.cuda.empty_cache()
        return dict(repo=LOAD_REPO, snapshot=str(snap), disk_free_gb=free_gb, files=written["files"],
                    bytes_written=written["total_size"], write_s=write_s, load_s=load_s,
                    host_peak_rss_gb=dict(before_write=rss0, after_write=rss_write,
                                          after_load=rss_load, after_int8_load=_peak_rss_gb()),
                    device_peak_gb=dev_peak, parity_tokens_and_logits_bit_equal=True,
                    batch_call_ms=batch_ms, int8_load_s=qload_s, int8_device_peak_gb=qdev_peak,
                    int8_leaves_bit_equal=n_leaves, int8_launches_per_call=qlaunches,
                    int8_first_tokens=qtoks[0].tolist())
    finally:
        if env_was is None:
            os.environ.pop("OVLA_HUB_OFFLINE", None)
        else:
            os.environ["OVLA_HUB_OFFLINE"] = env_was


# --- the command line (openvla_probe_tpu_torch/scripts) -----------------------------------

ROOT = Path(__file__).resolve().parent
CLI_TIMEOUT_S = 300          # each subprocess, and the server's readiness
CLI_SEQUENTIAL, CLI_CONCURRENT = 3, 6
CLI_REUSE_S = 2.0            # the most a script may spend loading the built kernel libraries
# the batch buckets a group of 1 .. CLI_CONCURRENT concurrent requests pads to
# (OpenVLA.predict_action_batch's batch_buckets)
CLI_BUCKETS = (1, 2, 4, 8)
# the deploy path's kernels, each launched by every request
CLI_DEPLOY_KERNELS = ("flash_prefill", "vit_attention", "decode_attention", "w8a8_matmul",
                      "rms_norm_quant")
# new tokens a generate reply, rows of the evaluate script (cut to leave tp2_train_int8 room
# in the time cap: the same checks on fewer tokens and rows)
CLI_GEN_NEW, CLI_EVAL_ROWS = 8, 4
CLI_CONVERT_LAYERS = 2       # the trainer checkpoint's depth at 7B width
CLI_PROBE_EPISODES, CLI_PROBE_T, CLI_SUITE = 8, 32, "object"
CLI_TASKS = ["pick up the red block", "open the top drawer", "put the cup on the plate",
             "close the drawer", "move the bowl to the left", "lift the black cup",
             "push the blue block", "place the pot on the stove", "turn the object",
             "grasp the white bowl", "pull the door", "put it in the bin"]


def _cli_env() -> dict:
    """The scripts' environment: this one without any OVLA_* knob, with the
    checkout on the path."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("OVLA_")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    return env


def _cli_cmd(name: str, dev, *args) -> list:
    """The script's command line on `dev` (a host-only script has no --device)."""
    on = [] if name in ON_HOST else ["--device", dev.type]
    return [sys.executable, "-m", f"openvla_probe_tpu_torch.scripts.{name}", *on,
            *map(str, args)]


def _run_script(name: str, dev, *args, input_text=None):
    """One script to its end within CLI_TIMEOUT_S: (its output, wall seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run(_cli_cmd(name, dev, *args), cwd=ROOT, env=_cli_env(), input=input_text,
                         capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    assert out.returncode == 0, (name, out.returncode, out.stderr[-6000:])
    return out, secs


def _kernel_report(stderr: str, dev):
    """The kernel libraries' load as the script logged it: on the card the
    libraries the build phase wrote are reused (same sources, flags and nvcc),
    within CLI_REUSE_S; on the CPU there is none to load."""
    for line in stderr.splitlines():
        if cli.KERNEL_LINE in line:
            report = json.loads(line.split(cli.KERNEL_LINE, 1)[1])
            assert dev.type == "cuda", report
            assert report["reused"] is True and report["seconds"] < CLI_REUSE_S, report
            return report
    assert dev.type != "cuda", "the script logged no kernel libraries"
    return None


def _server_launches(after: dict, before: dict) -> dict:
    """The kernel launches a server made between two /stats reads."""
    a, b = after["kernel_launches"], before["kernel_launches"]
    return {k: n - b.get(k, 0) for k, n in a.items() if n - b.get(k, 0)}


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}


def _cli_deploy(dev, repo: Path, work: Path) -> dict:
    """deploy --quantize_int8 true --dynamic_batching true on a free port:
    the seconds from spawn to the server listening and to the first 200 from
    /act, the kernel libraries reused within CLI_REUSE_S; CLI_SEQUENTIAL
    requests one after another, each action bit-equal to an in-process
    load_vla(quantize_int8=True) wrapper's predict_action (the wrapper reads
    the repository's tokenizer.json); the server's own kernel launches over
    those requests (its /stats before and after) equal to the wrapper's over
    the same requests, each of CLI_DEPLOY_KERNELS launched; then
    CLI_CONCURRENT requests at once, all answered, /stats counting the
    batches, each action bit-equal to the wrapper's predict_action_batch of
    its row at one of the buckets its batch can pad to (a row's result
    depends on its bucket, not on the other rows: the kernels do no
    cross-row reduction); the server stopped with a deadline whatever
    happens."""
    port, err_path = _free_port(), work / "deploy.stderr"
    rng = np.random.default_rng(17)
    n = CLI_SEQUENTIAL + CLI_CONCURRENT
    frames = rng.integers(0, 256, (n, IMG_HW, IMG_HW, 3), dtype=np.uint8)
    payloads = [{"image": frames[i], "instruction": CLI_TASKS[i], "unnorm_key": "bridge_orig"}
                for i in range(n)]
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            _cli_cmd("deploy", dev, "--openvla_path", repo, "--host", "127.0.0.1", "--port", port,
                     "--quantize_int8", "true", "--dynamic_batching", "true"),
            cwd=ROOT, env=_cli_env(), stdout=subprocess.DEVNULL, stderr=err)
    try:
        while True:
            assert proc.poll() is None, ("deploy exited", proc.returncode,
                                         err_path.read_text()[-6000:])
            assert time.perf_counter() - t0 < CLI_TIMEOUT_S, "deploy: no server in time"
            try:
                stats0 = _get_stats(port)
                break
            except OSError:
                time.sleep(0.25)
        listen_s = time.perf_counter() - t0
        replies, act_ms = [], []
        for i in range(CLI_SEQUENTIAL):
            out, ms = _post_act(port, payloads[i])
            replies.append(out["action"])
            act_ms.append(ms)
            if i == 0:
                serve_s = time.perf_counter() - t0
        stats_seq = _get_stats(port)
        conc, conc_ms = [None] * CLI_CONCURRENT, [None] * CLI_CONCURRENT

        def call(j):
            conc[j], conc_ms[j] = _post_act(port, payloads[CLI_SEQUENTIAL + j])

        threads = [threading.Thread(target=call, args=(j,)) for j in range(CLI_CONCURRENT)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=CLI_TIMEOUT_S)
        stats = _get_stats(port)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    server_s = time.perf_counter() - t0
    kernels = _kernel_report(err_path.read_text(), dev)
    assert all(c is not None and c["action"].shape == (ACTION_DIM,) for c in conc), conc
    assert stats["requests"] == n and stats["batches"] >= 1, stats
    seq_launches = _server_launches(stats_seq, stats0)
    conc_launches = _server_launches(stats, stats_seq)

    t1 = time.perf_counter()
    model = load_mod.load_vla(repo, quantize_int8=True, device=dev)
    wrapper_load_s = time.perf_counter() - t1
    assert isinstance(model.tokenizer, tokenization.HostTokenizer), type(model.tokenizer)
    assert model.tokenizer.vocab_size == 32001
    _build.reset_launch_counts()
    for i, got in enumerate(replies):
        want = model.predict_action(frames[i], get_openvla_prompt(CLI_TASKS[i]), "bridge_orig")
        assert np.array_equal(got, want["actions"]), (i, got, want["actions"])
    wrapper_launches = {k: n for k, n in _build.KERNEL_LAUNCHES.items() if n}
    assert seq_launches == wrapper_launches, (seq_launches, wrapper_launches)
    if dev.type == "cuda":
        for k in CLI_DEPLOY_KERNELS:
            assert seq_launches.get(k, 0) >= CLI_SEQUENTIAL, (k, seq_launches)

    # the concurrent rows: each reply is its row's result at the bucket its batch padded to
    images = frames[CLI_SEQUENTIAL:]
    prompts = [get_openvla_prompt(t) for t in CLI_TASKS[CLI_SEQUENTIAL:n]]
    keys = ["bridge_orig"] * CLI_CONCURRENT
    by_bucket = {}
    for b in CLI_BUCKETS:
        rows = []
        for s0 in range(0, CLI_CONCURRENT, b):
            rows += model.predict_action_batch(images[s0:s0 + b], prompts[s0:s0 + b],
                                               keys[s0:s0 + b], batch_buckets=(b,))
        by_bucket[b] = [r["actions"] for r in rows]
    conc_buckets = []
    for j, c in enumerate(conc):
        match = [b for b in CLI_BUCKETS if np.array_equal(c["action"], by_bucket[b][j])]
        assert match, (j, c["action"], {b: v[j] for b, v in by_bucket.items()})
        conc_buckets.append(match)
    del model
    _sync(dev)
    return dict(seconds=server_s, seconds_to_listen=listen_s, seconds_to_first_act=serve_s,
                kernel_libraries=kernels,
                launches_per_request={k: v / CLI_SEQUENTIAL for k, v in seq_launches.items()},
                server_launches_sequential=seq_launches,
                server_launches_equal_in_process=True,
                server_launches_concurrent=conc_launches,
                sequential=CLI_SEQUENTIAL,
                sequential_bit_equal_in_process=CLI_SEQUENTIAL, first_act_ms=act_ms[0],
                act_ms=act_ms[1:], act_p50_ms=statistics.median(act_ms[1:]),
                concurrent=CLI_CONCURRENT, concurrent_bit_equal_in_process=CLI_CONCURRENT,
                concurrent_matching_buckets=conc_buckets, concurrent_client_ms=conc_ms,
                stats={k: stats[k] for k in ("requests", "batches", "mean_batch", "latency_ms")
                       if k in stats},
                wrapper_load_s=wrapper_load_s)


def _cli_probes(dev, work: Path, probe_shape) -> dict:
    """train_probes, then analyze_probes, on seeded episodes at the 7B tap's
    shape with the suite's labels (run_cli's rows for the two scripts)."""
    from openvla_probe_tpu_torch.scripts import analyze_probes

    rows = {}
    names = analyze_probes.label_names(CLI_SUITE)
    logs = work / "episodes"
    logs.mkdir()
    n_layers, hidden = probe_shape
    eps = _probe_episodes(CLI_PROBE_EPISODES, CLI_PROBE_T, n_layers, hidden, len(names),
                          min(PROBE_LAYER, n_layers - 1), torch.Generator().manual_seed(29), "cpu")
    for i, ep in enumerate(eps):
        np.savez(logs / f"episode_{i}.npz", **ep)
    del eps
    probes = work / "probes"
    out, secs = _run_script("train_probes", dev, "--log_dir", logs, "--out_dir", probes,
                            "--suite", CLI_SUITE, "--epochs", 2)
    rows["train_probes"] = dict(seconds=secs, kernel_libraries=_kernel_report(out.stderr, dev))
    bank = probes / f"probe_bank_{CLI_SUITE}_binary.npz"
    analysis_dir = work / "analysis"
    out, secs = _run_script("analyze_probes", dev, "--bank", bank, "--log_dir", logs,
                            "--out_dir", analysis_dir, "--suite", CLI_SUITE)
    has_mpl = "matplotlib is not installed" not in out.stderr
    rows["analyze_probes"] = dict(seconds=secs, matplotlib=has_mpl)
    # the JAX script's heatmaps where the subprocess had matplotlib, else the bare matrices
    # under their own names
    heatmaps = [f"heatmap_f1_{CLI_SUITE}.png", f"heatmap_recall_{CLI_SUITE}.png",
                f"heatmap_f1_weighted_{CLI_SUITE}.png"]
    if not has_mpl:
        heatmaps = [analyze_probes.matrix_name(h) for h in heatmaps]
    want_files = {probes: [bank.name, f"probe_metrics_{CLI_SUITE}.csv",
                           f"probe_metrics_{CLI_SUITE}_reference_schema.csv"],
                  analysis_dir: ["per_label_metrics_reference_schema.csv",
                                 "per_label_metrics_experiment_images_schema.csv",
                                 "per_label_metrics.csv", "family_auprc_reference_schema.csv",
                                 "family_auprc.csv", "label_stats.csv", *heatmaps]}
    for d, files in want_files.items():
        for f in files:
            assert (d / f).is_file() and (d / f).stat().st_size > 0, d / f
            if f.endswith(".png"):
                assert image_io.read_image(d / f).ndim == 3, f
    with open(analysis_dir / "label_stats.csv") as f:
        assert sum(1 for _ in f) == len(names) + 1
    rows["train_probes"].update(episodes=CLI_PROBE_EPISODES, steps=CLI_PROBE_T,
                                layers=n_layers, hidden=hidden, labels=len(names))
    rows["analyze_probes"].update(files=sum(len(v) for v in want_files.values()))
    return rows


def run_cli(dev, repo: Path, work: Path, probe_shape=(LAYERS + 1, 4096)) -> dict:
    """The port's six scripts as subprocesses over `repo` (the released-layout
    repository the load phase wrote), each to its end with exit code 0:
    a seeded Llama-2-layout tokenizer.json written into the repository
    (tools/synthetic_tokenizer.py: 32000 entries and <PAD> = 32000); deploy
    (`_cli_deploy`); generate (two prompts on stdin, a seeded PNG: its whole
    output equal to the REPL's run in this process through
    generate.generate_text over load(repo)); evaluate --task closed over
    CLI_EVAL_ROWS JSONL rows with seeded PNGs (its report equal to the
    harness's in this process); convert_weights_to_hf on a trainer checkpoint
    of load(repo)'s parameters cut to CLI_CONVERT_LAYERS layers (every
    exported tensor equal to the checkpoint's, the export loaded back by
    load with its depth, its tokenizer and its parameters bit for bit);
    train_probes then analyze_probes (`_cli_probes`) on seeded episodes at
    the 7B tap's shape with the suite's labels (every file the JAX scripts
    write, a
    heatmap PNG readable; without matplotlib the bare matrices in place of
    the heatmaps, under their `_matrix.png` names). Each script's wall seconds and, where it loads
    the kernels, its build seconds."""
    from openvla_probe_tpu_torch.eval import evaluate_closed_set, load_jsonl_dataset
    from openvla_probe_tpu_torch.models.prompting import PromptBuilder
    from openvla_probe_tpu_torch.training import checkpointing as ckpt

    work.mkdir(parents=True, exist_ok=True)
    write_llama_tokenizer(repo, seed=0)
    rows = {"deploy": _cli_deploy(dev, repo, work)}
    rng = np.random.default_rng(23)

    # generate: the REPL over two prompts, and the same turns in this process
    png = image_io.write_png(work / "frame.png",
                             rng.integers(0, 256, (IMG_HW, IMG_HW, 3), dtype=np.uint8))
    prompts = ["what is on the table?", "describe the scene"]
    out, secs = _run_script("generate", dev, "--model_path", repo, "--image", png,
                            "--max_new_tokens", CLI_GEN_NEW, input_text="\n".join(prompts) + "\n")
    t0 = time.perf_counter()
    bundle = load_mod.load(repo, device=dev)
    bundle_load_s = time.perf_counter() - t0
    tok = bundle["tokenizer"]
    assert isinstance(tok, tokenization.HostTokenizer), type(tok)
    pixels = apply_image_transform(torch.as_tensor(image_io.read_image(png), device=dev),
                                   bundle["image_cfg"])[None]
    builder, texts = bundle["prompt_builder"](), []
    for msg in prompts:
        ids = tok.encode(builder.get_potential_prompt(msg))
        texts.append(generate.generate_text(bundle["params"], bundle["cfg"], tok, ids,
                                            pixel_values=pixels, max_new_tokens=CLI_GEN_NEW,
                                            device=dev))
        builder.add_turn("human", msg)
        builder.add_turn("gpt", texts[-1])
    want = ("|=> Enter prompts (ctrl-D to exit)\n"
            + "".join(f"|=> Enter Prompt: |=> {t}\n" for t in texts) + "|=> Enter Prompt: \n")
    assert out.stdout == want, (out.stdout, want)
    rows["generate"] = dict(seconds=secs, kernel_libraries=_kernel_report(out.stderr, dev),
                            replies=texts, replies_equal_in_process=True)

    # evaluate: closed-set rows with seeded PNGs
    lines = []
    for i in range(CLI_EVAL_ROWS):
        image_io.write_png(work / f"eval{i}.png",
                           rng.integers(0, 256, (IMG_HW, IMG_HW, 3), dtype=np.uint8))
        lines.append(json.dumps({"question": f"what is object {i}?", "image": f"eval{i}.png",
                                 "choices": ["a red block", "a cup", "a drawer"],
                                 "answer_idx": i % 3}))
    ds = work / "eval.jsonl"
    ds.write_text("\n".join(lines))
    out, secs = _run_script("evaluate", dev, "--checkpoint", repo, "--dataset", ds, "--task",
                            "closed", "--image_root", work, "--output", work / "eval_report.json")
    examples = load_jsonl_dataset(str(ds), str(work), None, image_loader=image_io.read_image)
    report = evaluate_closed_set(params=bundle["params"], cfg=bundle["cfg"], tokenizer=tok,
                                 examples=examples, image_cfg=bundle["image_cfg"],
                                 prompt_builder_factory=lambda: PromptBuilder("pure"),
                                 device=dev)
    report.update(checkpoint=str(repo), dataset=str(ds))
    got = json.loads((work / "eval_report.json").read_text())
    assert got == json.loads(json.dumps(report)), (got, report)
    rows["evaluate"] = dict(seconds=secs, kernel_libraries=_kernel_report(out.stderr, dev),
                            rows=CLI_EVAL_ROWS, accuracy=got["accuracy"],
                            report_equal_in_process=True)

    # convert_weights_to_hf: a trainer checkpoint of the same weights, cut in depth
    p = bundle["params"]
    cut = {**p, "llm": {**p["llm"], "layers": {k: v[:CLI_CONVERT_LAYERS]
                                               for k, v in p["llm"]["layers"].items()}}}
    run_dir = work / "run"
    ckpt.save_checkpoint(run_dir, {"params": cut}, step=1)
    shutil.copy(repo / "dataset_statistics.json", run_dir / "dataset_statistics.json")
    del bundle, p, cut
    _sync(dev)
    hf_cfg = json.loads((repo / "config.json").read_text())
    ids = [a for k in ("vision_backbone_id", "llm_backbone_id", "arch_specifier",
                       "image_resize_strategy") for a in (f"--{k}", hf_cfg[k])]
    out, secs = _run_script("convert_weights_to_hf", dev, "--run_dir", run_dir, "--output_dir",
                            work / "hf", "--tokenizer_path", repo, *ids)
    saved = ckpt.load_checkpoint(ckpt.latest_checkpoint(run_dir))["params"]
    back = load_mod.load(work / "hf", device=dev)
    assert back["cfg"].llm.num_hidden_layers == CLI_CONVERT_LAYERS
    # the checkpoint's tensors under the export's names (the loaded config sets only the depth)
    want_state = catalog.params_to_hf_state(saved, back["cfg"])
    exported = safetensors_io.read_dir(work / "hf")
    assert set(exported) == set(want_state), set(exported) ^ set(want_state)
    for k, v in want_state.items():
        assert torch.equal(exported[k], v), k
    assert isinstance(back["tokenizer"], tokenization.HostTokenizer)
    got_leaves, want_leaves = _flat(back["params"]), _flat(saved)
    assert got_leaves.keys() == want_leaves.keys()
    for k, v in want_leaves.items():
        assert torch.equal(got_leaves[k].cpu(), v), k
    rows["convert_weights_to_hf"] = dict(
        seconds=secs, layers=CLI_CONVERT_LAYERS, tensors=len(want_state),
        bytes=sum(t.numel() * t.element_size() for t in want_state.values()),
        tensors_bit_equal=True, loaded_back_bit_equal=True)
    del back, saved, want_state, exported, got_leaves, want_leaves
    _sync(dev)

    rows.update(_cli_probes(dev, work, probe_shape))
    return dict(scripts=sorted(rows), seconds={k: v["seconds"] for k, v in rows.items()},
                bundle_load_s=bundle_load_s, **rows)


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


# --- slice 7: the Mixtral MoE trunk, the Phi-2 trunk, the CLIP tower ------------------------

MOE_BATCH = 8                  # moe_turbo and moe_parity: B = 8, P = 32, A = 7
MOE_ROWS = 2 * MOE_BATCH * T_PREFILL   # the prefill's top-2 rows through each grouped product
MOE_PARITY_LAYERS = 4          # moe_parity's depth at full width (11.3 GB of bf16 experts)
MOE_TIMED_CALLS = 2
MIXTRAL_E, MIXTRAL_D, MIXTRAL_F = 8, 4096, 14336
MOE_TINY_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}   # first logits, card vs CPU


def _top2_sizes(tokens: int, g, dev, weights=None) -> torch.Tensor:
    """int32 group sizes of `tokens` top-2 picks (two distinct experts a
    token, drawn with `weights`, uniform by default), made on the card."""
    w = torch.ones(MIXTRAL_E, device=dev) if weights is None else torch.tensor(
        weights, dtype=torch.float32, device=dev)
    picks = torch.multinomial(w.expand(tokens, MIXTRAL_E), 2, replacement=False, generator=g)
    return torch.bincount(picks.reshape(-1), minlength=MIXTRAL_E).int()


def _ragged_operands(M, I, O, int8: bool, g, dev, dtype=torch.bfloat16):
    x = torch.randn((M, I), generator=g, device=dev).to(dtype)
    if int8:
        w = torch.randint(-127, 128, (MIXTRAL_E, O, I), generator=g, device=dev,
                          dtype=torch.int8)
        return x, w, torch.rand((MIXTRAL_E, O), generator=g, device=dev) * 1e-3 + 1e-3
    return x, (torch.randn((MIXTRAL_E, O, I), generator=g, device=dev) * 0.02).to(dtype), None


def _ragged_leaf(w, s):
    return w if s is None else {"q": w, "s": s}


def _ragged_library(x, w, s, gs):
    """One cuBLAS product over each expert's rows (bf16, or fp32 x on fp32
    weights), the weights dequantized and the group sizes read beforehand."""
    wd = (w if s is None else w.float() * s[..., None]).to(x.dtype)
    bounds = np.cumsum([0] + gs.tolist())
    out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype, device=x.device)

    def call():
        for e in range(len(bounds) - 1):
            a, b = int(bounds[e]), int(bounds[e + 1])
            if b > a:
                torch.matmul(x[a:b], wd[e].t(), out=out[a:b])
        return out
    return call


def _ragged_bound(x, w, s, gs, out, kind: str):
    """The bytes the product must move (x, the weights and scales of the
    experts this run's groups use, the group sizes, the output) and its
    operations."""
    used = int((gs > 0).sum())
    E, O, I = w.shape
    nbytes = (_nbytes(x, out, gs) + used * O * I * w.element_size()
              + (0 if s is None else used * O * 4))
    return bound_ms(nbytes, 2 * x.shape[0] * O * I, kind)


def _ragged_shape(x, w, s, gs, kernel: str, kind: str, launches: int) -> dict:
    leaf = _ragged_leaf(w, s)
    got = _launched(kernel, lambda: ragged.expert_ragged(x, leaf, gs))
    want = ragged.expert_ragged_plain(x, w, s, gs)
    stats = ragged.compare_expert_ragged(got, want)
    b, by = _ragged_bound(x, w, s, gs, got, kind)
    return dict(launches_per_call=launches, group_sizes=gs.tolist(),
                max_abs_err=stats["max_abs_err"], n_apart=stats["n_apart"],
                ms=cuda_ms(lambda: ragged.expert_ragged(x, leaf, gs)),
                plain_ms=cuda_ms(lambda: ragged.expert_ragged_plain(x, w, s, gs), reps=5,
                                 warmup=1),
                library_ms=cuda_ms(_ragged_library(x, w, s, gs)), bound_ms=b, bound_by=by)


def check_expert_ragged(dev, g):
    """The grouped expert product (models/moe.py:218 `_expert_ragged`,
    lax.ragged_dot_general) at Mixtral-8x7B's shapes, E = 8: the prefill's
    M = 2·B·T = 4608 top-2 rows × 4096 -> 14336 (gate, up) and 14336 -> 4096
    (down), and a decode step's M = 2·B = 16, in both weight forms (int8 codes
    with per-(expert, channel) scales: moe_turbo; bf16: moe_parity), group
    sizes from uniform top-2 picks, held to the plain version by
    compare_expert_ragged (one bf16 step). At the int8 4608 x 4096 -> 14336
    the outputs off the correctly rounded value of an fp64 reference
    (ragged.misrounded) are counted for the kernel and the plain version: the
    kernel's count at most 1.5x the plain version's. Edge cases untimed:
    skewed sizes with one empty expert, one-row groups, rows past the groups'
    sum (0), the route boundary (M = 64 with a group over two row blocks,
    M = 65), one expert holding all 4608 rows, a group of 129 rows (one past
    a 128-row tile).
    Library: cuBLAS bf16 over each expert's rows, weights dequantized
    beforehand. The row's figures are launch-weighted over moe_turbo's and
    moe_parity's calls."""
    A, L, Lp = ACTION_DIM, LAYERS, MOE_PARITY_LAYERS
    D, F_ = MIXTRAL_D, MIXTRAL_F
    prefill = _top2_sizes(MOE_ROWS // 2, g, dev)
    decode = _top2_sizes(MOE_BATCH, g, dev)
    # (form, M, I, O) -> launches a call: moe_turbo (int8, 32 layers), moe_parity (bf16, 4)
    per_call = {}
    for form, layers in (("int8", L), ("bf16", Lp)):
        per_call.update({(form, MOE_ROWS, D, F_): 2 * layers, (form, MOE_ROWS, F_, D): layers,
                         (form, 2 * MOE_BATCH, D, F_): 2 * layers * (A - 1),
                         (form, 2 * MOE_BATCH, F_, D): layers * (A - 1)})
    by_shape, misrounded = {}, {}
    for (form, M, I, O), n in per_call.items():
        x, w, s = _ragged_operands(M, I, O, form == "int8", g, dev)
        gs = prefill if M == MOE_ROWS else decode
        by_shape[f"{form} {M}x{I}x{O}"] = _ragged_shape(x, w, s, gs, "expert_ragged", "bf16", n)
        if (form, M, I, O) == ("int8", MOE_ROWS, D, F_):
            got = _launched("expert_ragged",
                            lambda: ragged.expert_ragged(x, _ragged_leaf(w, s), gs))
            misrounded = dict(kernel=ragged.misrounded(got, x, w, s, gs),
                              plain=ragged.misrounded(ragged.expert_ragged_plain(x, w, s, gs),
                                                      x, w, s, gs))
            assert misrounded["kernel"] <= 1.5 * misrounded["plain"], misrounded
            del got
        del x, w, s
    edges = {}
    for name, sizes, M, I, O in (
            ("skewed_one_empty", [1200, 0, 3, 1, 900, 1500, 700, 304], 4608, D, 2048),
            ("one_row_groups", [1, 1, 1, 5, 0, 1, 40, 1], 50, F_, 1024),
            ("decode_one_empty", [2, 2, 3, 1, 0, 4, 2, 2], 16, D, F_),
            ("rows_past_sum", [3, 0, 9, 1, 0, 0, 20, 2], 64, 1024, 512),
            ("decode_64_rows", [34, 2, 0, 28, 0, 0, 0, 0], 64, D, 2048),
            ("prefill_65_rows", [1, 0, 60, 2, 0, 0, 0, 2], 65, D, 2048),
            ("one_expert_all_rows", [0, 0, 0, 4608, 0, 0, 0, 0], 4608, D, 2048),
            ("group_of_129", [129, 300, 0, 5, 0, 0, 0, 66], 500, D, 2048)):
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        for form in ("int8", "bf16"):
            x, w, s = _ragged_operands(M, I, O, form == "int8", g, dev)
            got = _launched("expert_ragged",
                            lambda: ragged.expert_ragged(x, _ragged_leaf(w, s), gs))
            stats = ragged.compare_expert_ragged(got, ragged.expert_ragged_plain(x, w, s, gs))
            assert bool((got[sum(sizes):] == 0).all()), name
            edges[f"{name} {form}"] = stats["max_abs_err"]
            del x, w, s, got
    weighted = _launch_weighted(by_shape, {f"{f} {M}x{I}x{O}": n
                                           for (f, M, I, O), n in per_call.items()})
    return dict(name="expert_ragged", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/expert_ragged.cu",
                replaces="openvla_probe_tpu/models/moe.py:218", by_shape=by_shape,
                edge_cases=edges, misrounded=misrounded, **weighted)


def check_expert_ragged_scalar(dev, g):
    """The scalar route (fp32 x, or a shape the tensor-core rule refuses; the
    tiny fp32 MoE path launches it) at a decode step's shape in fp32, x
    [16, 4096] against int8 experts 4096 -> 14336, by compare_expert_ragged
    (fp32 within 1e-5 of the largest |want|); a bf16 x at I = 20 (not a
    multiple of 8) untimed. Bound: fp32 operations; library: fp32 cuBLAS over
    each expert's rows on weights dequantized beforehand."""
    x, w, s = _ragged_operands(2 * MOE_BATCH, MIXTRAL_D, MIXTRAL_F, True, g, dev, torch.float32)
    gs = _top2_sizes(MOE_BATCH, g, dev)
    row = _ragged_shape(x, w, s, gs, "expert_ragged_scalar", "fp32", 0)
    xe, we, se = _ragged_operands(40, 20, 24, True, g, dev)
    edge = torch.tensor([7, 0, 1, 30, 0, 0, 0, 2], dtype=torch.int32, device=dev)
    got = _launched("expert_ragged_scalar", lambda: ragged.expert_ragged(xe, {"q": we, "s": se},
                                                                          edge))
    ragged.compare_expert_ragged(got, ragged.expert_ragged_plain(xe, we, se, edge))
    return dict(name="expert_ragged_scalar", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/expert_ragged.cu",
                replaces="openvla_probe_tpu/models/moe.py:218",
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")})


def _tiny_moe_vlm(dtype) -> vlm.VLMConfig:
    """VLMConfig.tiny() over the `mixtral-tiny` trunk (4 experts, top-2), in `dtype`."""
    c = vlm.VLMConfig.tiny(llm=catalog.LLM_BACKBONES["mixtral-tiny"]["cfg"])
    return dataclasses.replace(c, llm=dataclasses.replace(c.llm, dtype=dtype),
                               vision=tuple(dataclasses.replace(v, dtype=dtype)
                                            for v in c.vision))


def check_tiny_moe(dev, dtype):
    """A tiny MoE VLA on the parity tier (T = 68, so the flash gate engages)
    on the card vs the CPU run of the plain versions (which
    tests/test_torch_moe.py holds to the JAX package): fp32 takes
    expert_ragged_scalar, bf16 the tensor-core route, each exactly 3 launches
    a layer and pass. fp32: equal tokens, first logits within 1e-4; bf16
    (every product rounds its fp32 sums once, in another order): tokens equal
    up to each row's first token whose CPU margin is below twice the
    first-logit gap, first logits within 5e-2."""
    c = _tiny_moe_vlm(dtype)
    cfg = vla.VLAServingConfig.for_tier(c, "parity", prompt_pad_len=64,
                                        codec_vocab_size=c.llm.vocab_size)
    params = convert.init_params(cfg.vlm, torch.Generator().manual_seed(1), device="cpu")
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
    launches = {k: n for k, n in _build.KERNEL_LAUNCHES.items() if n}
    route = "expert_ragged" if dtype == torch.bfloat16 else "expert_ragged_scalar"
    other = "expert_ragged_scalar" if route == "expert_ragged" else "expert_ragged"
    assert launches.get(route) == 3 * c.llm.num_hidden_layers * cfg.action_dim, launches
    assert other not in launches, launches
    err = (out["first_logits"].cpu() - ref["first_logits"]).abs().max().item()
    assert err < MOE_TINY_TOL[dtype], err
    got, want = out["action_tokens"].cpu(), ref["action_tokens"]
    if dtype == torch.float32:
        assert torch.equal(got, want)
        compared = want.numel()
    else:
        compared = 0
        for b in range(want.shape[0]):
            for t in range(want.shape[1]):
                if ref["logit_margins"][b, t] < 2 * err:
                    break
                assert got[b, t] == want[b, t], (b, t, got, want)
                compared += 1
    return dict(path="tiny_moe", dtype=str(dtype)[6:], tokens_compared=compared,
                tokens=want.numel(), first_logits_max_abs_err=err, launches=launches)


def _mixtral_vlm() -> vlm.VLMConfig:
    """dinosiglip-vit-so-224px + mixtral-8x7b-v0.1 (32 layers, D 4096, F 14336,
    E 8, top-2, 32 / 8 heads, theta 1e6), OpenVLA's projector, bf16."""
    return catalog.build_vlm_config("dinosiglip-vit-so-224px", "mixtral-8x7b-v0.1")[0]


def _expert_gb(params) -> float:
    layers = params["llm"]["layers"]
    return sum(_tree_bytes({k: layers[k]}) for k in ("gate_proj", "up_proj", "down_proj")) / 1e9


def run_moe_path(dev, path: str):
    """moe_turbo: the Mixtral VLM at full width and depth on the turbo tier,
    every TURBO_QUANT_SUFFIXES leaf int8 drawn directly on the card
    (linear.random_params_like over convert.vlm_param_spec: the expert codes
    [32, 8, O, I] never have a float twin); moe_parity: the same VLM in bf16
    at MOE_PARITY_LAYERS layers (convert.init_params). B = 8, P = 32, A = 7:
    exact launches of one call (3 expert_ragged a layer and pass), two calls'
    tokens equal, p50 over MOE_TIMED_CALLS calls, busy ms a call (moe_turbo),
    the device peak; the tree freed at the end."""
    c = _mixtral_vlm()
    if path == "moe_parity":
        c = dataclasses.replace(c, llm=dataclasses.replace(c.llm,
                                                           num_hidden_layers=MOE_PARITY_LAYERS))
    tier = "turbo" if path == "moe_turbo" else "parity"
    cfg = vla.VLAServingConfig.for_tier(c, tier, action_dim=ACTION_DIM, prompt_pad_len=PROMPT_PAD)
    g = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if tier == "turbo":
        spec = convert.vlm_param_spec(cfg.vlm, lin.TURBO_QUANT_SUFFIXES, 8)
        params = lin.random_params_like(spec, g, device=dev)
    else:
        spec = convert.vlm_param_spec(cfg.vlm)
        params = convert.init_params(cfg.vlm, g, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb, expert_gb = _tree_bytes(params) / 1e9, _expert_gb(params)
    torch.cuda.reset_peak_memory_stats()
    image, ids, plen, q01, q99, mask = _inputs(cfg, MOE_BATCH, IMG_HW,
                                               torch.Generator(device=dev).manual_seed(1), dev)

    def call():
        out = vla.predict_action_from_image(params, cfg, image, ImageTransformConfig.dinosiglip_224(),
                                            ids, plen, q01, q99, mask, return_first_logits=True,
                                            device=dev)
        torch.cuda.synchronize()
        return out

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = call()
    first_s = time.perf_counter() - t0
    launches = dict(_build.KERNEL_LAUNCHES)
    expect = _expected_launches(path, cfg, batch=MOE_BATCH, spec=spec)
    assert launches == expect, (path, launches, expect)
    L = c.llm.num_hidden_layers
    assert launches["expert_ragged"] == 3 * L * ACTION_DIM, launches
    toks, logits = out["action_tokens"], out["first_logits"]
    assert toks.shape == (MOE_BATCH, ACTION_DIM) and int(toks.min()) >= 0
    assert int(toks.max()) < c.llm.vocab_size and torch.isfinite(out["actions"]).all()
    assert torch.isfinite(logits).all() and logits.shape == (MOE_BATCH, c.llm.vocab_size)
    times = []
    for _ in range(MOE_TIMED_CALLS):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        again = call()
        times.append(time.perf_counter() - t0)
        assert _build.KERNEL_LAUNCHES == expect, _build.KERNEL_LAUNCHES
        assert torch.equal(again["action_tokens"], toks), (path, "tokens differ between calls")
    p50 = statistics.median(times)
    busy = profile_main_path.device_time(call, 1) if tier == "turbo" else None
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, out, again
    torch.cuda.empty_cache()
    return launches, dict(
        path=path, tier=tier, layers=L, experts=c.llm.moe_experts, top_k=c.llm.moe_top_k,
        weights="int8 (random_params_like)" if tier == "turbo" else "bf16",
        param_gb=param_gb, expert_gb=expert_gb, init_s=init_s, first_call_s=first_s,
        p50_ms=p50 * 1e3, calls_per_s=MOE_BATCH / p50, call_ms=[t * 1e3 for t in times],
        device_ms_per_call=None if busy is None else busy["device_ms_per_call_total"],
        device_ms_by_class=None if busy is None else busy["device_ms_per_call_by_class"],
        device_idle_share=None if busy is None else busy["device_idle_share"],
        peak_mem_gb=peak, tokens_equal_across_calls=True, first_tokens=toks[0].tolist())


# --- slice 8a: MoE training -------------------------------------------------------------------

MOE_TRAIN_ROWS = 2 * TRAIN_ROWS   # the step's top-2 rows through each grouped product: 5120
# card vs CPU, one step of the tiny MoE VLM: fp32 TRAIN_TINY_TOL's rules; bf16 (every grouped
# product and every STE rounds its fp32 sums to bf16 once, in another order on each device, and
# the chain carries a moved rounding on): the loss 1e-2 relative, every gradient 5e-2 in norm,
# the adapters after one AdamW step within 2 lr, 90 % within 0.1 lr and 99 % within 0.5 lr
MOE_TRAIN_TINY_TOL = {torch.float32: dict(loss=TRAIN_TINY_TOL["loss"], grad=TRAIN_TINY_TOL["grad"],
                                          p90=1e-2, p99=1e-1),
                      torch.bfloat16: dict(loss=1e-2, grad=5e-2, p90=1e-1, p99=5e-1)}


def _dx_operands(M, O, I, int8: bool, g, dev, dtype=torch.bfloat16):
    """dy [M, O] and an expert stack [E, O, I] (int8 codes with scales, or
    dtype at 0.02)."""
    dy = torch.randn((M, O), generator=g, device=dev).to(dtype)
    _, w, s = _ragged_operands(1, I, O, int8, g, dev, dtype)
    return dy, w, s


def _dx_library(dy, w, s, gs):
    """One cuBLAS product a used expert over its rows, dy_e · W_e, the weights
    dequantized to dy's dtype and the group sizes read beforehand."""
    wd = (w if s is None else w.float() * s[..., None]).to(dy.dtype)
    bounds = np.cumsum([0] + gs.tolist())
    out = torch.empty((dy.shape[0], w.shape[2]), dtype=dy.dtype, device=dy.device)

    def call():
        for e in range(len(bounds) - 1):
            a, b = int(bounds[e]), int(bounds[e + 1])
            if b > a:
                torch.matmul(dy[a:b], wd[e], out=out[a:b])
        return out
    return call


def _dw_library(dy, x, gs, E):
    """One cuBLAS product a used expert over its rows, dy_eᵀ · x_e."""
    bounds = np.cumsum([0] + gs.tolist())
    out = torch.zeros((E, dy.shape[1], x.shape[1]), dtype=x.dtype, device=x.device)

    def call():
        for e in range(E):
            a, b = int(bounds[e]), int(bounds[e + 1])
            if b > a:
                torch.matmul(dy[a:b].t(), x[a:b], out=out[e])
        return out
    return call


def _dx_shape(dy, w, s, gs, kernel: str, kind: str, launches: int, reps: int = 25) -> dict:
    got = _launched(kernel, lambda: ragged.expert_ragged_dx(dy, w, s, gs))
    stats = ragged.compare_expert_ragged(got, ragged.expert_ragged_dx_plain(dy, w, s, gs))
    assert torch.equal(got, ragged.expert_ragged_dx(dy, w, s, gs)), "dx: two runs differ"
    used = int((gs > 0).sum())
    E, O, I = w.shape
    nbytes = (_nbytes(dy, got, gs) + used * O * I * w.element_size()
              + (0 if s is None else used * O * 4))
    b, by = bound_ms(nbytes, 2 * int(gs.sum()) * O * I, kind)
    return dict(launches_per_step=launches, max_abs_err=stats["max_abs_err"],
                n_apart=stats["n_apart"],
                ms=cuda_ms(lambda: ragged.expert_ragged_dx(dy, w, s, gs), reps=reps),
                plain_ms=cuda_ms(lambda: ragged.expert_ragged_dx_plain(dy, w, s, gs), reps=3,
                                 warmup=1),
                library_ms=cuda_ms(_dx_library(dy, w, s, gs), reps=reps), bound_ms=b,
                bound_by=by, host_us=host_us(lambda: ragged.expert_ragged_dx(dy, w, s, gs),
                                             reps=20))


def _dw_shape(dy, x, gs, kernel: str, kind: str, launches: int, reps: int = 25) -> dict:
    E = gs.numel()
    got = _launched(kernel, lambda: ragged.expert_ragged_dw(dy, x, gs, E))
    stats = ragged.compare_expert_ragged(got, ragged.expert_ragged_dw_plain(dy, x, gs, E))
    assert torch.equal(got, ragged.expert_ragged_dw(dy, x, gs, E)), "dW: two runs differ"
    rows = int(gs.sum())
    b, by = bound_ms(_nbytes(got, gs) + rows * (dy.shape[1] + x.shape[1]) * dy.element_size(),
                     2 * rows * dy.shape[1] * x.shape[1], kind)
    return dict(launches_per_step=launches, max_abs_err=stats["max_abs_err"],
                n_apart=stats["n_apart"], split_rows=ragged.dw_split_rows(
                    dy.shape[0], dy.shape[1], x.shape[1]),
                ms=cuda_ms(lambda: ragged.expert_ragged_dw(dy, x, gs, E), reps=reps),
                plain_ms=cuda_ms(lambda: ragged.expert_ragged_dw_plain(dy, x, gs, E), reps=3,
                                 warmup=1),
                library_ms=cuda_ms(_dw_library(dy, x, gs, E), reps=reps), bound_ms=b,
                bound_by=by, host_us=host_us(lambda: ragged.expert_ragged_dw(dy, x, gs, E),
                                             reps=20))


def check_expert_ragged_bwd(dev, g):
    """The backward of the grouped expert product (XLA's transpose of
    models/moe.py:218 `_expert_ragged`) at moe_train's shapes: M = 2·B·T =
    5120 top-2 rows, E = 8, D = 4096, F = 14336, r = 32, group sizes from
    uniform top-2 picks. expert_ragged_dx: the int8 base's dx (gate / up
    14336 -> 4096, down 4096 -> 14336) and the adapters' dy · B and dt · A;
    expert_ragged_dw: the adapters' dB and dA. Each held to its plain
    version by compare_expert_ragged's rule and run twice, bit-equal; ms
    (behind the spin kernel, median of 25), the plain version's, cuBLAS per
    expert over its rows (dy_e · W_e on weights dequantized beforehand, dy_eᵀ
    x_e), the bound, host µs a call. At both int8 dx shapes (5120 x 14336 ->
    4096 and 4096 -> 14336) the outputs off an fp64 reference's rounding,
    kernel and plain: the kernel's at most 1.5x. dW of a full bf16 stack [8,
    14336, 4096] from 5120 rows (full fine-tuning; no moe_train launch).
    Edge cases untimed: an empty expert, one expert holding every row, M off
    the 128-row tile, rows past the groups' sum, r = 8, 16, 32 and 64, dy ·
    B on both sides of dx_tiling's split switch (131 and 132 tiles), experts
    of one row, O = 8. Both rows launch-weighted over one moe_train step."""
    M, D, F_, r = MOE_TRAIN_ROWS, MIXTRAL_D, MIXTRAL_F, TRAIN_RANK
    dx_per, dw_per = kernel_ab.ragged_bwd_shapes()   # launches per step by shape
    gs = _top2_sizes(M // 2, g, dev)
    dx_rows, dw_rows, misrounded = {}, {}, {}
    for (form, O, I), n in dx_per.items():
        dy, w, s = _dx_operands(M, O, I, form == "int8", g, dev)
        dx_rows[f"{form} {M}x{O}->{I}"] = _dx_shape(dy, w, s, gs, "expert_ragged_dx", "bf16", n)
        if form == "int8":
            got = ragged.expert_ragged_dx(dy, w, s, gs)
            count = misrounded[f"{M}x{O}->{I}"] = dict(
                kernel=ragged.misrounded_dx(got, dy, w, s, gs),
                plain=ragged.misrounded_dx(ragged.expert_ragged_dx_plain(dy, w, s, gs), dy, w,
                                           s, gs))
            assert count["kernel"] <= 1.5 * count["plain"], misrounded
            del got
        del dy, w, s
    for (O, I), n in dw_per.items():
        dy = torch.randn((M, O), generator=g, device=dev).bfloat16()
        x = torch.randn((M, I), generator=g, device=dev).bfloat16()
        dw_rows[f"{M}x({O}, {I})"] = _dw_shape(dy, x, gs, "expert_ragged_dw", "bf16", n)
        del dy, x
    dy = torch.randn((M, F_), generator=g, device=dev).bfloat16()
    x = torch.randn((M, D), generator=g, device=dev).bfloat16()
    full = _dw_shape(dy, x, gs, "expert_ragged_dw", "bf16", 0, reps=5)
    del dy, x
    torch.cuda.empty_cache()
    edges = {}   # dy · B at 131 tiles splits the contraction, at 132 it does not
    assert ragged.dx_tiling(16768, 256, r, False)[1] > 1
    assert ragged.dx_tiling(16769, 256, r, False)[1] == 1
    for name, sizes, M_, O, I in (
            ("one_empty", [1200, 0, 3, 1, 900, 1500, 700, 304], 4608, 2048, 1024),
            ("one_expert_all_rows", [0, 0, 0, 5120, 0, 0, 0, 0], 5120, 2048, 1024),
            ("m_off_the_tile", [129, 300, 0, 5, 0, 0, 0, 66], 500, 1024, 512),
            ("rows_past_sum", [3, 0, 9, 1, 0, 0, 20, 2], 64, 1024, 512),
            ("r8_dt_a", [700, 0, 3, 1, 900, 1500, 700, 304], 4608, 8, D),
            ("r8_dy_b", [700, 0, 3, 1, 900, 1500, 700, 304], 4608, D, 8),
            ("r32_one_expert", [0, 0, 0, 5120, 0, 0, 0, 0], 5120, r, D),
            ("r16_dy_b", [700, 0, 3, 1, 900, 1500, 700, 304], 4608, 1024, 16),
            ("r64_dy_b", [700, 0, 3, 1, 900, 1500, 700, 304], 4608, 1024, 64),
            ("r64_dt_a", [700, 0, 3, 1, 900, 1500, 700, 304], 4608, 64, 1024),
            ("split_131_tiles", [2096] * 8, 16768, 256, r),
            ("one_pass_132_tiles", [2096] * 7 + [2097], 16769, 256, r),
            ("one_row_experts", [1, 0, 3000, 1, 700, 1, 0, 905], 4608, 2048, 1024),
            ("o8", [700, 0, 3, 1, 900, 1500, 700, 304], 4608, 8, 1024)):
        gse = torch.tensor(sizes, dtype=torch.int32, device=dev)
        for form in ("int8", "bf16"):
            if form == "int8" and I % 16:
                continue
            dy, w, s = _dx_operands(M_, O, I, form == "int8", g, dev)
            got = _launched("expert_ragged_dx", lambda: ragged.expert_ragged_dx(dy, w, s, gse))
            st = ragged.compare_expert_ragged(got, ragged.expert_ragged_dx_plain(dy, w, s, gse))
            assert bool((got[sum(sizes):] == 0).all()), name
            edges[f"dx {name} {form}"] = st["max_abs_err"]
            del dy, w, s, got
        dy = torch.randn((M_, O), generator=g, device=dev).bfloat16()
        x = torch.randn((M_, I), generator=g, device=dev).bfloat16()
        got = _launched("expert_ragged_dw", lambda: ragged.expert_ragged_dw(dy, x, gse, 8))
        st = ragged.compare_expert_ragged(got, ragged.expert_ragged_dw_plain(dy, x, gse, 8))
        assert all(bool((got[e] == 0).all()) for e, n in enumerate(sizes) if n == 0), name
        assert torch.equal(got, ragged.expert_ragged_dw(dy, x, gse, 8)), name
        edges[f"dw {name}"] = st["max_abs_err"]
        del dy, x, got
    out = []
    for name, rows, per in (("expert_ragged_dx", dx_rows, dx_per),
                            ("expert_ragged_dw", dw_rows, dw_per)):
        keys = {k: n for k, n in zip(rows, per.values())}
        weighted = _launch_weighted(rows, keys)
        weighted["host_us"] = sum(rows[k]["host_us"] * n for k, n in keys.items()) / sum(
            keys.values())
        out.append(dict(name=name, route="cuda",
                        source="openvla_probe_tpu_torch/ops/csrc/expert_ragged_bwd.cu",
                        replaces="openvla_probe_tpu/models/moe.py:218", by_shape=rows,
                        launches_per_step=sum(per.values()), group_sizes=gs.tolist(),
                        edge_cases=edges, **weighted))
    out[0]["misrounded"] = misrounded
    out[1]["full_stack_8x14336x4096"] = full
    return out


def check_expert_ragged_bwd_scalar(dev, g):
    """The backward's scalar routes (fp32, or shapes the tensor-core rules
    refuse; the tiny fp32 MoE training step launches them): dx of fp32 dy
    [64, 4096] against int8 experts 4096 -> 1024 and dW of fp32 dy [64, 1024],
    x [64, 4096], by compare_expert_ragged (fp32 within 1e-5 of the largest
    |want|). Bound: fp32 operations; library: fp32 cuBLAS per expert."""
    gs = torch.tensor([20, 0, 9, 30, 1, 0, 0, 4], dtype=torch.int32, device=dev)
    dy, w, s = _dx_operands(64, 1024, MIXTRAL_D, True, g, dev, torch.float32)
    dx = _dx_shape(dy, w, s, gs, "expert_ragged_dx_scalar", "fp32", 0)
    x = torch.randn((64, MIXTRAL_D), generator=g, device=dev)
    dw = _dw_shape(dy, x, gs, "expert_ragged_dw_scalar", "fp32", 0)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [dict(name=name, route="cuda",
                 source="openvla_probe_tpu_torch/ops/csrc/expert_ragged_bwd.cu",
                 replaces="openvla_probe_tpu/models/moe.py:218", **{k: row[k] for k in keys})
            for name, row in (("expert_ragged_dx_scalar", dx), ("expert_ragged_dw_scalar", dw))]


def _expected_moe_train_launches(cfg: vlm.VLMConfig, spec) -> dict:
    """Exact per-kernel launches of one MoE train step (tools/bench_finetune
    routes over an int8 trunk with streamed LoRA on every linear): each
    dense linear's forward kernel in the forward and again in the remat
    recompute (the layer's router losses come last, so the non-reentrant
    checkpoint recomputes every product of the layer), lm_head's once; per
    MoE layer the forward's 9 grouped products (3 a projection: the base,
    x · Aᵀ, t · Bᵀ) twice, 9 expert_ragged_dx and 6 expert_ragged_dw (the
    routes by the dtype: fp32 takes the scalar ones); each GEMM's pre-pass
    apart; no attention kernel."""
    kernels = dict.fromkeys(_build.KERNEL_LAUNCHES, 0)
    route, L = cfg.llm.int8_matmul, cfg.llm.num_hidden_layers
    layers = spec["llm"]["layers"]
    for w in ("q_proj", "k_proj", "v_proj", "o_proj"):
        kernels[_linear_route(layers[w], route, 2 ** 20)] += 2 * L
    kernels[_linear_route(spec["llm"]["lm_head"], route, 2 ** 20)] += 1
    sfx = "" if cfg.llm.dtype == torch.bfloat16 else "_scalar"
    kernels[f"expert_ragged{sfx}"] += 18 * L
    kernels[f"expert_ragged_dx{sfx}"] += 9 * L
    kernels[f"expert_ragged_dw{sfx}"] += 6 * L
    for gemm, pre_pass in _build.PRE_PASSES.items():
        kernels[pre_pass] = kernels[gemm]
    return kernels


def check_tiny_moe_train(dev, dtype):
    """One train step of the mixtral-tiny VLM (int8 trunk on the w8a8 STE
    route, streamed LoRA r = 8 on every linear with B drawn as _random_b,
    remat, plain attention) on the card vs the CPU (the plain versions, which
    tests/test_torch_moe_train.py holds to the JAX package), from the same
    base, batch and adapters: the loss with the router losses, moe_aux and
    moe_z, every gradient, the adapters after one AdamW step
    (MOE_TRAIN_TINY_TOL), the exact launch counts (fp32: the scalar routes;
    bf16: the tensor-core ones), and two backward passes on the card
    bit-equal or not (index_add's atomics in x[tok]'s backward)."""
    cfg = bench_finetune.train_config(_tiny_moe_vlm(dtype), "int8")
    tol = MOE_TRAIN_TINY_TOL[dtype]
    base = bench_finetune.base_params(cfg, "int8", torch.Generator().manual_seed(1), "cpu")
    batch = bench_finetune.synthetic_batch(cfg, 4, 16, 2, "cpu")
    lora = _random_b(init_lora_params(base, LoRAConfig(r=8), torch.Generator().manual_seed(3)),
                     torch.Generator().manual_seed(4))

    def run(device):
        ft = bench_finetune.Finetune(cfg, _to(base, device), _to(batch, device), rank=8,
                                     lr=TRAIN_LR, lora=_to(lora, device))
        _build.reset_launch_counts()
        (loss, metrics), grads = value_and_grad(ft.loss_fn, ft.state.params, cfg, ft.batch)
        launches = dict(_build.KERNEL_LAUNCHES)
        same = None
        if device != "cpu":
            again = value_and_grad(ft.loss_fn, ft.state.params, cfg, ft.batch)[1]
            same = all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(again)))
        ft.step()
        return (float(loss), float(metrics["moe_aux"]), float(metrics["moe_z"]), grads,
                ft.state.params, launches, same)

    ref_loss, ref_aux, ref_z, ref_grads, ref_lora, _, _ = run("cpu")
    loss, aux, z, grads, new_lora, launches, same = run(dev)
    torch.cuda.synchronize()
    expect = _expected_moe_train_launches(cfg, base)
    assert launches == expect, (dtype, {k: (v, expect[k]) for k, v in launches.items()
                                        if v != expect[k]})
    for got, want in ((loss, ref_loss), (aux, ref_aux), (z, ref_z)):
        assert abs(got - want) <= tol["loss"] * abs(want), (got, want)
    apart = [_leaf_apart(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(ref_grads))]
    assert len(apart) > 20 and max(apart) <= tol["grad"], max(apart)
    deltas = torch.cat([(a.cpu() - b).abs().ravel()
                        for a, b in zip(tree_leaves(new_lora), tree_leaves(ref_lora))])
    q = torch.quantile(deltas, torch.tensor([0.9, 0.99]))
    assert (deltas.max() <= 2 * TRAIN_LR and q[0] <= tol["p90"] * TRAIN_LR
            and q[1] <= tol["p99"] * TRAIN_LR), q
    return dict(path="tiny_moe_train", dtype=str(dtype)[6:], loss=loss, loss_cpu=ref_loss,
                moe_aux=aux, moe_aux_cpu=ref_aux, moe_z=z, moe_z_cpu=ref_z,
                grads_max_rel_apart=max(apart),
                adapters_max_apart_lr=float(deltas.max()) / TRAIN_LR,
                adapters_p90_apart_lr=float(q[0]) / TRAIN_LR,
                adapters_p99_apart_lr=float(q[1]) / TRAIN_LR,
                grads_bit_equal_across_two_backwards=same,
                launches={k: n for k, n in launches.items() if n})


def _fingerprint(t: torch.Tensor) -> torch.Tensor:
    """A leaf's bytes summed, and summed weighted by (position mod 65521) + 1,
    in int64 (exact), 2^27 bytes at a time: a copy of the 47 GB base does not
    fit beside it on the card."""
    b = t.reshape(-1).view(torch.uint8)
    out = []
    for i in range(0, b.numel(), 1 << 27):
        c = b[i:i + (1 << 27)].to(torch.int64)
        w = torch.arange(i, i + c.numel(), device=c.device, dtype=torch.int64) % 65521 + 1
        out.append(torch.stack([c.sum(), (c * w).sum()]))
    return torch.stack(out)


def run_moe_train(dev):
    """moe_train: one QLoRA step after another of the Mixtral VLM
    (dinosiglip-vit-so-224px + mixtral-8x7b-v0.1, 32 layers, E = 8, top-2)
    through tools/bench_finetune's build_moe and Finetune (make_train_step
    over make_lora_loss_fn(stream=True)): trunk and lm_head int8 per channel
    on the w8a8 STE route drawn directly on the card, towers and projector
    bf16; LoRA r = 32, alpha 16, on every linear, the expert
    stacks included, the router frozen and not adapted; AdamW at a constant
    5e-4, remat, plain attention; B = 8 rows of 64 text tokens, T = 320.
    As run_train_path: launches of one step asserted exactly, a warm-up step,
    TRAIN_TIMED timed steps (host clock, CUDA events, host syncs counted
    with the Python lines that made them),
    the loss and the router losses finite at every step, the base unchanged
    (each leaf's `_fingerprint`), every B factor moved off zero; two backward
    passes compared bit for bit; peak memory and the base, adapter and
    optimizer-state bytes (where a step's time goes: python -m
    openvla_probe_tpu_torch.tools.profile_main_path --entry train_moe)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ft = bench_finetune.build_moe(TRAIN_BATCH, TRAIN_SEQ, TRAIN_RANK, 2 + TRAIN_TIMED, dev,
                                  seed=0, lr=TRAIN_LR)
    cfg, base, batch = ft.cfg, ft.base, ft.batch
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frozen = [_fingerprint(t) for t in tree_leaves(base)]
    losses, aux = [], []

    def step():
        metrics = ft.step()
        losses.append(float(metrics["loss"]))
        aux.append((float(metrics["moe_aux"]), float(metrics["moe_z"])))

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_build.KERNEL_LAUNCHES)
    expect = _expected_moe_train_launches(cfg, base)
    assert launches == expect, {k: (v, expect[k]) for k, v in launches.items() if v != expect[k]}
    step()
    times, event_ms, timed, host_syncs, sync_sites = [], [], [], [], set()
    for _ in range(TRAIN_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            start.record()
            m = ft.step()
            end.record()
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        event_ms.append(start.elapsed_time(end))
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        host_syncs.append(len(syncs))
        sync_sites.update(f"{Path(w.filename).name}:{w.lineno}" for w in syncs)
        timed.append(m)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9   # the steps' peak, base included
    losses += [float(m["loss"]) for m in timed]
    aux += [(float(m["moe_aux"]), float(m["moe_z"])) for m in timed]
    assert all(np.isfinite(losses)) and all(np.isfinite(aux).ravel()), (losses, aux)
    assert all(torch.equal(_fingerprint(t), f) for t, f in zip(tree_leaves(base), frozen)), \
        "the base moved"
    del frozen
    # two backward passes over the same adapters and batch, bit-equal or not: the kernels are
    # deterministic, the gathers' backward (x[tok], y_s[pos]) is PyTorch's
    first = value_and_grad(ft.loss_fn, ft.state.params, cfg, batch)[1]
    second = value_and_grad(ft.loss_fn, ft.state.params, cfg, batch)[1]
    grads_equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(first), tree_leaves(second)))
    del first, second
    lora = ft.state.params
    layers = lora["llm"]["layers"]
    assert layers["router"] is None
    b_leaves = [lw["B"] for lw in _ab_leaves(lora)]
    assert b_leaves and all(bool((b != 0).any()) for b in b_leaves), "a B factor stayed at zero"
    # the (layer, expert) blocks of the expert stacks' B that moved (an expert no token picked
    # in a layer takes no gradient there)
    moved = torch.stack([(layers[k]["B"] != 0).flatten(2).any(-1)
                         for k in ("gate_proj", "up_proj", "down_proj")]).float().mean()
    p50 = statistics.median(times)
    state = ft.state.opt_state
    expert_ad = sum(bench_finetune.tree_bytes(layers[k]) for k in
                    ("gate_proj", "up_proj", "down_proj"))
    out = dict(
        path="moe_train", base_quant="int8", layers=cfg.llm.num_hidden_layers,
        experts=cfg.llm.moe_experts, top_k=cfg.llm.moe_top_k, batch=TRAIN_BATCH,
        seq=1 + cfg.num_patches + TRAIN_SEQ - 1, rank=TRAIN_RANK, init_s=init_s,
        first_step_s=first_s, step_ms_p50=p50 * 1e3, examples_per_s=TRAIN_BATCH / p50,
        step_ms=[t * 1e3 for t in times], event_ms_per_step=event_ms,
        event_ms_p50=statistics.median(event_ms), host_syncs_per_step=host_syncs,
        host_sync_sites=sorted(sync_sites), grads_bit_equal_across_two_backwards=grads_equal,
        losses=losses, moe_aux_z=aux, peak_mem_gb=peak_gb,
        base_gb=bench_finetune.tree_bytes(base) / 1e9, expert_gb=_expert_gb(base),
        adapters_gb=bench_finetune.tree_bytes(lora) / 1e9, expert_adapters_gb=expert_ad / 1e9,
        opt_state_gb=(bench_finetune.tree_bytes(state.mu)
                      + bench_finetune.tree_bytes(state.nu)) / 1e9,
        adapter_leaves=len(b_leaves), expert_b_blocks_moved_share=float(moved))
    del ft, base, lora, state, batch
    torch.cuda.empty_cache()
    return launches, out


def run_phi(dev):
    """phi-2+3b (CLIP ViT-L/336 at N = 577 and Dh = 64 on vit_attention's
    tensor-core route, the gelu-mlp projector, Phi-2 at 32 layers, D 2560,
    Dh 80) in bf16 at full width and depth: score_continuation_rows over 8
    rows of 33-64 tokens with 336 px letterboxed pixels (T = 640). Exact
    launches (23 vit_attention: the Phi trunk's products and attention are
    PyTorch's, as the JAX package's XLA path), finite log-probabilities,
    p50 over TIMED_VLM_CALLS calls."""
    from openvla_probe_tpu_torch.conf.models import ModelConfig

    mc = ModelConfig.get_choice_class("phi-2+3b")()
    c, img_cfg, _ = catalog.build_vlm_config(mc.vision_backbone_id, mc.llm_backbone_id,
                                             mc.arch_specifier, mc.image_resize_strategy)
    g = torch.Generator(device=dev).manual_seed(7)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = convert.init_params(c, g, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    image = torch.randint(0, 256, (VLM_BATCH, IMG_HW, IMG_HW, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    pixels = apply_image_transform(image, img_cfg).to(c.llm.dtype)
    requests = _vlm_requests("score_short", c.llm.vocab_size, seed=6)
    torch.cuda.reset_peak_memory_stats()

    def call():
        out = generate.score_continuation_rows(params, c, requests, pixels, device=dev)
        torch.cuda.synchronize()
        return out

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    scores = call()
    first_s = time.perf_counter() - t0
    launches = dict(_build.KERNEL_LAUNCHES)
    expect = dict.fromkeys(_build.KERNEL_LAUNCHES, 0)
    expect["vit_attention"] = c.vision[0].num_layers - 1
    assert launches == expect, launches
    assert scores.shape == (VLM_BATCH,) and bool(np.isfinite(scores).all()) and \
        bool((scores <= 0).all()), scores
    times = []
    for _ in range(TIMED_VLM_CALLS):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
        assert _build.KERNEL_LAUNCHES == expect, _build.KERNEL_LAUNCHES
    p50 = statistics.median(times)
    n_params = sum(t.numel() for t in _leaves(params))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    return {k: n for k, n in launches.items() if n}, dict(
        path="phi", model="phi-2+3b", entry="score_continuation_rows", rows=VLM_BATCH,
        T=1 + c.num_patches + SCORE_L["score_short"] - 1, vision_tokens=c.num_patches + 1,
        params=n_params, init_s=init_s, first_call_s=first_s, p50_ms=p50 * 1e3,
        rows_per_s=VLM_BATCH / p50, call_ms=[t * 1e3 for t in times], peak_mem_gb=peak,
        scores=scores.tolist())


# --- slice 6a: sharded serving, one process a rank on the one card --------------------------
#
# Each phase spawns its ranks (parallel.distributed.run_ranks: a file:// rendezvous, gloo, as
# the backend rule says for ranks that share a card) and fails the run if any rank raises,
# exits without a result or outlives RANK_TIMEOUT_S. Two processes time-sliced on one card
# are no multi-card measurement: their times say what a rank's work costs beside the other's.

TP = 2
RANK_TIMEOUT_S = 300
EP = 2
EP_LAYERS = 4            # ep2_moe_turbo's depth, cut to fit the time cap (each rank draws the
                         # whole trunk to slice it, beside the one-process reference)
ROW_PARALLEL_LAUNCHES = ("w8a8_row_absmax", "w8a8_quant_given", "w8a8_matmul_i32",
                         "w8a8_epilogue")


def _row_parallel_shapes() -> dict:
    """(M, K_local, N) -> launches in one tp2_turbo rank's call
    (`kernel_ab.row_parallel_shapes`: o_proj K 2048 and down_proj K 5504 at
    prefill and each decode step; each tower block's proj_w and fc2_w,
    SigLIP's fc2 K = 2152, padded to 2160)."""
    return kernel_ab.row_parallel_shapes()


# SigLIP's fc2 at tp = 8 (4304 / 8 = 538 a rank, at a B = 24 call's rows): a local K that
# is not a multiple of 4, held beside the launch mix (no tp = 8 path runs here)
ROW_PARALLEL_TP8 = (24 * 256, 538, 1152)


def check_row_parallel(dev, g):
    """The row-parallel w8a8 product's four launches at the tp = 2 shapes
    (`_row_parallel_shapes`), each bit-equal to its plain version: the local
    row absmax, the codes from a given row scale (the MAX all-reduce's; zero
    codes in SigLIP fc2's padded columns), the int32 GEMM (wgmma above M =
    64, split-K at M = 24) and the epilogue; the four composed equal
    `w8a8_matmul_plain` over the unpadded weight. Library: one
    torch.linalg.vector_norm (ord inf, fp32) for the absmax, torch._int_mm
    on the same codes for the GEMM, none for the epilogue; for the codes
    torch.quantize_per_channel on the same row scales (fp32 x made
    beforehand) where its codes equal the kernel's at every shape, else none
    and the count of codes apart (`library_codes_apart`). Each with its host
    µs a call."""
    per_call = _row_parallel_shapes()
    rows = {name: {} for name in ROW_PARALLEL_LAUNCHES}
    host = {name: {} for name in ROW_PARALLEL_LAUNCHES}
    qpc = {}
    for (M, K, N) in (*per_call, ROW_PARALLEL_TP8):
        kp = -(-K // 16) * 16
        key = f"{M}x{K}x{N}"
        x0 = torch.randn((M, K), generator=g, device=dev).bfloat16()
        # the pre-pass kernels' input: zero columns up to a multiple of 4 (`_row_exact_chain`)
        x = F.pad(x0, (0, -K % 4))
        sets = []
        for _ in range(copies_past_l2(N * kp)):
            w = lin.quantize_weight(torch.randn((N, K), generator=g, device=dev) * 0.02)
            sets.append({"q": F.pad(w["q"], (0, kp - K)), "s": w["s"]})
        amax = lin.w8a8_row_absmax(x)
        torch.cuda.synchronize()
        assert torch.equal(amax, lin.w8a8_row_absmax_plain(x0)), (key, "absmax")
        sx = torch.clamp(lin.div127(amax), min=1e-8)
        codes = lin.w8a8_quant_given(x, sx, kp)
        torch.cuda.synchronize()
        assert torch.equal(codes, lin.w8a8_quant_given_plain(x0, sx, kp)), (key, "codes")
        acc = lin.w8a8_matmul_i32(codes, sets[0])
        torch.cuda.synchronize()
        assert torch.equal(acc, lin.w8a8_matmul_i32_plain(codes, sets[0])), (key, "int32")
        out = lin.w8a8_epilogue(acc, sx, sets[0]["s"], x.dtype)
        torch.cuda.synchronize()
        assert torch.equal(out, lin.w8a8_epilogue_plain(acc, sx, sets[0]["s"], x.dtype)), key
        whole = {"q": sets[0]["q"][:, :K].contiguous(), "s": sets[0]["s"]}
        assert torch.equal(out, lin.w8a8_matmul_plain(x0, whole)), (key, "composed")
        norm = torch.linalg.vector_norm(x, float("inf"), dim=-1, keepdim=True,
                                        dtype=torch.float32)
        assert torch.equal(norm, amax), (key, "vector_norm")
        b, by = bound_ms(_nbytes(x, amax), 0, "int8")
        rows["w8a8_row_absmax"][key] = dict(
            max_abs_err=0.0, ms=cuda_ms(lambda: lin.w8a8_row_absmax(x)),
            plain_ms=cuda_ms(lambda: lin.w8a8_row_absmax_plain(x)),
            library_ms=cuda_ms(lambda: torch.linalg.vector_norm(
                x, float("inf"), dim=-1, keepdim=True, dtype=torch.float32)),
            bound_ms=b, bound_by=by)
        # the codes' library call: fp32 x, fp64 row scales, zero points, made beforehand
        xf, qargs = x.float(), (sx[:, 0].double(), torch.zeros(M, dtype=torch.long, device=dev))
        qpc_call = lambda: torch.quantize_per_channel(xf, *qargs, 0, torch.qint8)
        try:
            q, why = qpc_call(), None
        except (RuntimeError, NotImplementedError) as e:   # a yardstick's refusal, recorded
            q, why = None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        qpc[key] = dict(apart=None if q is None else int((q.int_repr() != codes[:, :x.shape[1]])
                                                         .sum()))
        b, by = bound_ms(_nbytes(x, sx, codes), 0, "int8")
        rows["w8a8_quant_given"][key] = dict(
            max_abs_err=0.0, ms=cuda_ms(lambda: lin.w8a8_quant_given(x, sx, kp)),
            plain_ms=cuda_ms(lambda: lin.w8a8_quant_given_plain(x, sx, kp), reps=5, warmup=1),
            library_ms=None if q is None else cuda_ms(qpc_call),
            library_codes_apart=qpc[key]["apart"], library_refused=why,
            bound_ms=b, bound_by=by, k_pad=kp)
        del q, xf
        b, by = bound_ms(_nbytes(codes, sets[0]["q"], acc), 2 * M * N * kp, "int8")
        rows["w8a8_matmul_i32"][key] = dict(
            max_abs_err=0.0, ms=cuda_ms(rotating(lambda w: lin.w8a8_matmul_i32(codes, w),
                                                 [(w,) for w in sets])),
            plain_ms=cuda_ms(rotating(lambda w: lin.w8a8_matmul_i32_plain(codes, w),
                                      [(w,) for w in sets]), reps=3, warmup=1),
            library_ms=cuda_ms(rotating(lambda w: torch._int_mm(codes, w["q"].t()),
                                        [(w,) for w in sets])),
            bound_ms=b, bound_by=by)
        b, by = bound_ms(_nbytes(acc, sx, sets[0]["s"], out), 2 * M * N, "fp32")
        rows["w8a8_epilogue"][key] = dict(
            max_abs_err=0.0, ms=cuda_ms(lambda: lin.w8a8_epilogue(acc, sx, sets[0]["s"], x.dtype)),
            plain_ms=cuda_ms(lambda: lin.w8a8_epilogue_plain(acc, sx, sets[0]["s"], x.dtype),
                             reps=5, warmup=1),
            library_ms=None, bound_ms=b, bound_by=by)
        host["w8a8_row_absmax"][key] = host_us(lambda: lin.w8a8_row_absmax(x))
        host["w8a8_quant_given"][key] = host_us(lambda: lin.w8a8_quant_given(x, sx, kp))
        host["w8a8_matmul_i32"][key] = host_us(lambda: lin.w8a8_matmul_i32(codes, sets[0]))
        host["w8a8_epilogue"][key] = host_us(
            lambda: lin.w8a8_epilogue(acc, sx, sets[0]["s"], x.dtype))
        del sets, codes, acc, out, x0
    weights = {f"{M}x{K}x{N}": n for (M, K, N), n in per_call.items()}
    # the codes' library call counts only where its codes are the kernel's at every shape
    library_codes = all(r["apart"] == 0 for r in qpc.values())
    out = []
    for name in ROW_PARALLEL_LAUNCHES:
        mix = _launch_weighted({k: {**r, "library_ms": r["library_ms"] or 0.0}
                                for k, r in rows[name].items()}, weights)
        if name == "w8a8_epilogue" or (name == "w8a8_quant_given" and not library_codes):
            mix["library_ms"] = None
        out.append(dict(name=name, route="cuda",
                        source="openvla_probe_tpu_torch/ops/csrc/w8a8_matmul.cu",
                        replaces=("openvla_probe_tpu/ops/linear.py:406"
                                  if name == "w8a8_row_absmax"
                                  else "openvla_probe_tpu/ops/linear.py:413"),
                        by_shape=rows[name], host_us=host[name], **mix))
    return out


def _local_gb(tree) -> float:
    """A rank's local tree's bytes (placed leaves' local tensors), GB."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size() / 1e9
    if tp.is_placed(tree):
        return _local_gb(tree["local"])
    if isinstance(tree, dict):
        return sum(_local_gb(v) for v in tree.values())
    return 0.0


def _expected_tp_launches(cfg: vla.VLAServingConfig, local) -> dict:
    """One tp rank's exact launches a turbo call: the one-process table with
    every row-parallel product (o_proj and down_proj at prefill and each
    decode step, each tower block's proj_w and fc2_w) moved from w8a8_matmul
    and its pre-pass to the row-parallel product's four launches."""
    expect = _expected_launches("turbo", cfg)
    c = cfg.vlm
    L, A1 = c.llm.num_hidden_layers, cfg.action_dim - 1
    moved = sum(L * (1 + A1) for name in ("o_proj", "down_proj")
                if tp.tp_role(local["llm"]["layers"][name]) == "row")
    moved += sum(v.num_layers - 1 for name, v in zip(c.vision_names, c.vision)
                 for leaf in ("proj_w", "fc2_w")
                 if tp.tp_role(local["vision"][name]["blocks"][leaf]) == "row")
    for k in ("w8a8_matmul", "w8a8_quant_rows"):
        expect[k] -= moved
    for k in ROW_PARALLEL_LAUNCHES:
        expect[k] += moved
    return expect


def _tp2_rank(rank: int, world: int, ref_path: str):
    """One rank of tp2_turbo: turbo's int8 weights drawn on the card from the
    turbo path's seed, this rank's tree placed (`make_sharded_predict`, tp),
    the whole tree freed; the path's requests (B = 24) through the sharded
    call once (gloo's host path makes a call take seconds), under the
    profiler (busy ms), with exact launches at the shard shapes, no
    torch._int_mm and the collectives' bytes; its time, peak memory. In that
    call the sharded projector runs on the sharded towers' features, and its
    output is then swapped for one process's projected patches (`ref_path`,
    from MAIN_TOWERS): the projector's sum is the one step that is not one
    process's bit for bit (fp32 partials across ranks), so that the trunk,
    the KV caches, decode and the greedy head are held to one process's bit
    for bit. The features and the sharded projector's output come back
    beside the outputs."""
    dev = _rank_dev("cuda")
    cfg = _serving("turbo", vlm.VLMConfig.openvla_7b(), action_dim=ACTION_DIM,
                   prompt_pad_len=PROMPT_PAD)
    t0 = time.perf_counter()
    params = _init("turbo", cfg.vlm, torch.Generator(device=dev).manual_seed(0), dev)
    mesh = pmesh.make_mesh({"tp": world})
    call, local = vla.make_sharded_predict(params, cfg, mesh,
                                           image_cfg=ImageTransformConfig.dinosiglip_224(),
                                           strategy="tp", device=dev, return_first_logits=True)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    ref_patches = torch.load(ref_path)["patches"].to(dev)
    image, ids, plen, q01, q99, mask = _inputs(cfg, BATCH, IMG_HW,
                                               torch.Generator(device=dev).manual_seed(1), dev)
    times, outs, seen = [], [], {}
    sharded_projector = vlm.project_patches

    def one_process_patches(p, c, feats):
        seen["features"], seen["patches"] = feats, sharded_projector(p, c, feats)
        return ref_patches

    def run():
        t0 = time.perf_counter()
        outs.append(call(local, image, ids, plen, q01, q99, mask))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    int_mm_calls = []
    with mock.patch.object(torch, "_int_mm", _counting_int_mm(int_mm_calls)), \
            mock.patch.object(vlm, "project_patches", one_process_patches):
        _build.reset_launch_counts()
        pdist.reset_collective_counts()
        busy = profile_main_path.device_time(run, 1, warmup=False)
        launches = dict(_build.KERNEL_LAUNCHES)
        coll_bytes, coll_calls = dict(pdist.COLLECTIVE_BYTES), dict(pdist.COLLECTIVE_CALLS)
    expect = _expected_tp_launches(cfg, local)
    assert launches == expect, (rank, {k: (launches[k], expect[k]) for k in expect
                                       if launches[k] != expect[k]})
    assert not int_mm_calls
    out = outs[0]
    peak = torch.cuda.max_memory_allocated() / 1e9
    return dict(rank=rank, tokens=out["action_tokens"].cpu(),
                first_logits=out["first_logits"].cpu(), margins=out["logit_margins"].cpu(),
                features=seen["features"].cpu(), patches=seen["patches"].cpu(),
                launches=launches, local_gb=_local_gb(local), init_s=init_s,
                p50_ms=statistics.median(times) * 1e3, call_ms=[t * 1e3 for t in times],
                device_ms_per_call=busy["device_ms_per_call_total"],
                device_ms_by_class=busy["device_ms_per_call_by_class"],
                device_idle_share=busy["device_idle_share"], peak_mem_gb=peak,
                collective_bytes_per_call=coll_bytes, collective_calls_per_call=coll_calls)


def run_tp2_turbo(dev):
    """tp2_turbo: OpenVLA-7B on the turbo tier at full width and depth, tp = 2
    (`_tp2_rank` in two processes on the one card), each rank's call with the
    one-process turbo call's projected patches in place of its own
    (MAIN_TOWERS). Each rank's tower features bit-equal to one process's, and its action
    tokens, first logits and every token's logit margin bit-equal to the
    one-process turbo call's (MAIN_OUT, MAIN_MARGINS: the same weights and
    requests): every product of turbo's towers, trunk and head sums int8
    codes in int32, and attention runs per head. The sharded projector's
    distance from one process's patches is printed: its bf16 products sum
    fp32 partials across ranks (PERF.md §6)."""
    want, want_logits = (t.cpu() for t in MAIN_OUT["turbo"])
    want_margins = MAIN_MARGINS["turbo"].cpu()
    ref = MAIN_TOWERS
    with tempfile.TemporaryDirectory(prefix="ovla_tp2_") as tmp:
        ref_path = str(Path(tmp) / "reference.pt")
        torch.save({"patches": ref["patches"]}, ref_path)
        ranks = pdist.run_ranks(_tp2_rank, TP, args=(ref_path,), timeout=RANK_TIMEOUT_S)
    rows = []
    for r in ranks:
        assert torch.equal(r["features"], ref["features"]), (r["rank"], "tower features")
        assert torch.equal(r["tokens"], want), (r["rank"], r["tokens"].tolist(), want.tolist())
        assert torch.equal(r["first_logits"], want_logits), (r["rank"], "first logits")
        assert torch.equal(r["margins"], want_margins), (r["rank"], "logit margins")
        patches = (r["patches"].float() - ref["patches"].float()).abs()
        kept = {k: v for k, v in r.items()
                if k not in ("tokens", "first_logits", "margins", "features", "patches")}
        rows.append({**kept, "features_bit_equal": True, "tokens_bit_equal": True,
                     "first_logits_bit_equal": True, "margins_bit_equal": True,
                     "tokens": int(want.numel()),
                     "projector_max_abs_diff": patches.max().item(),
                     "projector_share_differing": (patches > 0).float().mean().item(),
                     "patches_scale": ref["patches"].float().abs().max().item()})
    return ranks[0]["launches"], dict(path="tp2_turbo", tp=TP, batch=BATCH, ranks=rows,
                                      one_process_p50_ms=MAIN_P50["turbo"])


def _ep_trunk_inputs(cfg, dev):
    """The MoE trunk's inputs: the prefill's (B = 8 x T_PREFILL embeddings of
    random ids, the last rows of two prompts padded) and one decode-shaped
    token a row (M = 8: 16 expert rows, the split-K route)."""
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(1000, 20000, (MOE_BATCH, T_PREFILL), generator=g, device=dev)
    mask = torch.ones((MOE_BATCH, T_PREFILL), dtype=torch.int32, device=dev)
    mask[1, -9:] = 0
    mask[5, -30:] = 0
    return ids, mask


def _ep_trunk(params, cfg, ids, mask):
    """(prefill trunk output [B, T, D], one-token trunk output [B, 1, D]) of
    the uncached `llama.forward` (the prefill's and a decode step's shapes)."""
    out = []
    for i, m in ((ids, mask), (ids[:, -1:], torch.ones_like(mask[:, -1:]))):
        B, T = i.shape
        pos = torch.arange(T, device=i.device).expand(B, T)
        x = llama.embed_tokens(params, i)
        out.append(llama.forward(params, cfg, x, m, pos, compute_logits=False)
                   ["last_hidden_state"])
    torch.cuda.synchronize()
    return out


def _ep_config():
    c = _mixtral_vlm()
    c = dataclasses.replace(c, llm=dataclasses.replace(c.llm, num_hidden_layers=EP_LAYERS))
    return vla.VLAServingConfig.for_tier(c, "turbo").vlm.llm


def _ep_params(cfg, dev):
    spec = convert.vlm_param_spec(dataclasses.replace(_mixtral_vlm(), llm=cfg),
                                  lin.TURBO_QUANT_SUFFIXES, 8)["llm"]
    return lin.random_params_like(spec, torch.Generator(device=dev).manual_seed(0), device=dev)


def _ep2_rank(rank: int, world: int):
    """One rank of ep2_moe_turbo: the int8 Mixtral trunk drawn from the
    reference's seed, this rank's experts placed (E / ep a rank, everything
    else whole), the trunk's outputs and launches."""
    dev = _rank_dev("cuda")
    cfg = _ep_config()
    params = _ep_params(cfg, dev)
    mesh = pmesh.make_mesh({"ep": world})
    local = tp.resolve_tree(psharding.place_params({"llm": params}, mesh, "tp"))["llm"]
    del params
    torch.cuda.empty_cache()
    ids, mask = _ep_trunk_inputs(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    pdist.reset_collective_counts()
    t0 = time.perf_counter()
    outs = _ep_trunk(local, cfg, ids, mask)
    s = time.perf_counter() - t0
    return dict(rank=rank, outs=[o.cpu() for o in outs], launches={
        k: n for k, n in _build.KERNEL_LAUNCHES.items() if n}, seconds=s,
        local_gb=_local_gb(local), peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        collective_bytes=dict(pdist.COLLECTIVE_BYTES))


def run_ep2_moe(dev):
    """ep2_moe_turbo: Mixtral-8x7B's int8 trunk at full width (D 4096, F
    14336, E 8, top-2) cut to EP_LAYERS layers, ep = 2 (four experts a rank):
    each rank's trunk outputs at the prefill's and a decode step's shapes
    bit-equal to the one-process trunk's on the same weights and inputs."""
    cfg = _ep_config()
    params = _ep_params(cfg, dev)
    ids, mask = _ep_trunk_inputs(cfg, dev)
    _build.reset_launch_counts()
    want = [o.cpu() for o in _ep_trunk(params, cfg, ids, mask)]
    one_launches = {k: n for k, n in _build.KERNEL_LAUNCHES.items() if n}
    del params
    torch.cuda.empty_cache()
    ranks = pdist.run_ranks(_ep2_rank, EP, timeout=RANK_TIMEOUT_S)
    for r in ranks:
        for got, ref in zip(r["outs"], want):
            assert torch.equal(got, ref), (r["rank"], "not bit-equal to one process")
        assert r["launches"]["expert_ragged"] == one_launches["expert_ragged"], r["launches"]
    return dict(path="ep2_moe_turbo", ep=EP, layers=EP_LAYERS,
                cut=f"depth {EP_LAYERS} of 32 layers (two ranks each draw the whole trunk to "
                    "slice it, beside the one-process reference)",
                bit_equal=True, one_process_launches=one_launches,
                ranks=[{k: v for k, v in r.items() if k != "outs"} for r in ranks])


# --- tp2_train_int8 (slice 6b): train_int8's QLoRA step at tp = 2 ----------------------------

# tp2_train_int8 against one process's step rounded as two tp ranks round it
# (`tp_reference.rounded_as_tp`): the loss and global grad norm relative, each adapter leaf's
# gradient 1 - cosine and its norm relative (read from the first step's Adam moment). One
# process's plain step is no reference here: at random weights the 7B int8 QLoRA step
# amplifies one bf16 rounding of the forward's partial sums to ~2e-2 in 1 - cosine (PERF.md
# §6); its distances are printed beside
TRAIN_TP_TOL = dict(loss=1e-3, grad_norm=1e-2, cosine=1e-3, leaf_norm=1e-2)


def _train_int8_inputs(dev):
    """train_int8's trainer at full width and depth on `dev`: its config and
    base (the train path's seed), LoRA r = TRAIN_RANK with B drawn small and
    nonzero (`_random_b`), its batch (B = 8, 64 text tokens: 2560 rows)."""
    cfg = bench_finetune.train_config(vlm.VLMConfig.openvla_7b(), "int8")
    base = bench_finetune.base_params(cfg, "int8", torch.Generator(device=dev).manual_seed(0), dev)
    lora = _random_b(init_lora_params(base, LoRAConfig(r=TRAIN_RANK),
                                      torch.Generator(device=dev).manual_seed(1)),
                     torch.Generator(device=dev).manual_seed(2))
    return cfg, base, lora, bench_finetune.synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, dev)


def _expected_tp_train_launches(cfg: vlm.VLMConfig, local_base) -> dict:
    """One tp rank's exact launches a train_int8 step: the one-process table
    (`_expected_train_launches`) with every row-parallel trunk product moved
    from w8a8_matmul and its pre-pass to the row-parallel product's four
    launches: o_proj in the forward and the remat recompute, down_proj in
    the forward only (its base chain is issued after its LoRA side path and
    `_RowExactSTE` saves no tensor, so the recompute stops before it)."""
    expect = _expected_train_launches("int8", cfg)
    L = cfg.llm.num_hidden_layers
    moved = sum(L * (1 if name == "down_proj" else 2) for name in ("o_proj", "down_proj")
                if tp.tp_role(local_base["llm"]["layers"][name]) == "row")
    for k in ("w8a8_matmul", "w8a8_quant_rows"):
        expect[k] -= moved
    for k in ROW_PARALLEL_LAUNCHES:
        expect[k] += moved
    return expect


def _tp2_train_rank(rank: int, world: int):
    """One rank of tp2_train_int8: train_int8's base, adapters and batch
    (`_train_int8_inputs`), the base placed on tp and the whole tree freed,
    the adapters and AdamW moments placed (`place_train_state`); one sharded
    step under the profiler (busy ms) with exact launches, no torch._int_mm,
    the collectives' bytes forward and backward; its wall time, peak memory,
    the base's fingerprint before and after, the local moments."""
    dev = _rank_dev("cuda")
    t0 = time.perf_counter()
    cfg, base, lora, batch = _train_int8_inputs(dev)
    mesh = pmesh.make_mesh({"tp": world})
    step, state, lbase = _train_setup(cfg, base, lora, mesh, "tp", batch)
    del base, lora
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    frozen = [_fingerprint(t) for t in tree_leaves(tp.local_tree(lbase))]
    torch.cuda.reset_peak_memory_stats()
    times, outs, int_mm_calls = [], [], []

    def run():
        t0 = time.perf_counter()
        outs.append(step(state, batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    with mock.patch.object(torch, "_int_mm", _counting_int_mm(int_mm_calls)):
        _build.reset_launch_counts()
        pdist.reset_collective_counts()
        busy = profile_main_path.device_time(run, 1, warmup=False)
        launches = dict(_build.KERNEL_LAUNCHES)
        coll_bytes, coll_calls = dict(pdist.COLLECTIVE_BYTES), dict(pdist.COLLECTIVE_CALLS)
    expect = _expected_tp_train_launches(cfg, lbase)
    assert launches == expect, (rank, {k: (launches[k], expect[k]) for k in expect
                                       if launches[k] != expect[k]})
    assert not int_mm_calls
    new, m = outs[0]
    base_unchanged = all(torch.equal(_fingerprint(t), f)
                         for t, f in zip(tree_leaves(tp.local_tree(lbase)), frozen))
    assert base_unchanged, (rank, "the base moved")
    return dict(rank=rank, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                mu=_to(tp.local_tree(new.opt_state.mu), "cpu"), launches=launches,
                local_base_gb=_local_gb(lbase), init_s=init_s, step_s=times[0],
                device_ms_per_step=busy["device_ms_per_call_total"],
                device_ms_by_class=busy["device_ms_per_call_by_class"],
                device_idle_share=busy["device_idle_share"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                collective_bytes_per_step=coll_bytes, collective_calls_per_step=coll_calls,
                base_bit_unchanged=base_unchanged)


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float((a @ b) / (a.norm() * b.norm()).clamp(min=1e-300))


def _step_result(step, state, batch) -> dict:
    state, m = step(state, batch)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                mu=_to(state.opt_state.mu, "cpu"))


def _apart(got: dict, want: dict) -> dict:
    """Relative loss and grad-norm distances, and over the adapter leaves the
    largest 1 - cosine and relative distance of the norms of their gradients
    (read from the first step's Adam moment, mu = (1 - b1) · the clipped
    gradient), with the four leaves farthest in direction."""
    paths = [k for k, v in _flat(want["mu"]).items() if v is not None]
    pairs = list(zip(paths, tree_leaves(got["mu"]), tree_leaves(want["mu"])))
    assert len(pairs) == len(tree_leaves(got["mu"])) > 0
    off = {k: 1 - _cosine(a, b) for k, a, b in pairs}
    norm = {k: abs(float(a.double().norm() / b.double().norm()) - 1) for k, a, b in pairs}
    return dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                grad_norm=abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"],
                cosine=max(off.values()), leaf_norm=max(norm.values()), leaves=len(off),
                farthest=sorted(off.items(), key=lambda kv: -kv[1])[:4])


def run_tp2_train_int8(dev):
    """tp2_train_int8: train_int8's QLoRA step (OpenVLA-7B, the int8 trunk
    and lm_head on the w8a8 STE route, the bf16 towers and projector, remat,
    the plain attention; B = 8, T = 64 text tokens, r = TRAIN_RANK) at tp = 2
    (`_tp2_train_rank` in two processes on the one card) against one
    process's step from the same base, adapters and batch with its products
    rounded as two tp ranks round them (`tp_reference.rounded_as_tp`), run
    here first: each rank's loss, global grad norm and every adapter
    gradient's direction and norm within TRAIN_TP_TOL, the base bit-unchanged
    (each rank). The distances, and those from one process's plain step,
    are printed before they are held."""
    cfg, base, lora, batch = _train_int8_inputs(dev)
    step, state, _ = _train_setup(cfg, base, lora, None, None, batch)
    t0 = time.perf_counter()
    plain = _step_result(step, state, batch)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    with tp_reference.rounded_as_tp(base, TP) as calls:
        want = _step_result(step, state, batch)
    calls = dict(calls)
    del cfg, base, lora, batch, step, state
    torch.cuda.empty_cache()
    ranks = pdist.run_ranks(_tp2_train_rank, TP, timeout=RANK_TIMEOUT_S)
    rows = []
    for r in ranks:
        mesh = pmesh.Mesh({"tp": TP}, rank=r["rank"])
        local = {k: {**v, "mu": tp.local_tree(psharding.place_params(v["mu"], mesh, "tp",
                                                                     _path="mu"))}
                 for k, v in (("rounded", want), ("plain", plain))}
        rows.append({**{k: v for k, v in r.items() if k != "mu"},
                     **{f"{k}_apart": v for k, v in _apart(r, local["rounded"]).items()},
                     "plain_apart": _apart(r, local["plain"])})
    out = dict(path="tp2_train_int8", tp=TP, batch=TRAIN_BATCH, rank_r=TRAIN_RANK,
               seq=1 + 256 + TRAIN_SEQ - 1, reference_loss=want["loss"],
               reference_grad_norm=want["grad_norm"], reference_calls=calls,
               one_process_loss=plain["loss"], one_process_grad_norm=plain["grad_norm"],
               one_process_step_s=one_s, tolerance=TRAIN_TP_TOL, ranks=rows)
    held = ("loss", "grad_norm", "cosine", "leaf_norm")
    log("tp2_train_int8", **{k: v for k, v in out.items() if k != "ranks"},
        apart=[{"rank": r["rank"], **{f"{k}_apart": r[f"{k}_apart"] for k in held},
                "farthest_apart": r["farthest_apart"],
                "plain_apart": {k: r["plain_apart"][k] for k in held + ("farthest",)}}
               for r in rows])
    assert calls["col"] and calls["row"] and calls["attention"], calls
    for r in rows:   # the distances, printed above, held
        for k in held:
            assert r[f"{k}_apart"] <= TRAIN_TP_TOL[k], (r["rank"], k, r[f"{k}_apart"],
                                                        TRAIN_TP_TOL[k])
    return ranks[0]["launches"], out


# tiny_parallel: the tiny fp32 paths (chip_smoke's tiny configs) on four ranks, each case's
# outputs held to the same tiny path on one card
TINY_PARALLEL = (("parity", {"dp": 2, "tp": 2}, "tp", None),
                 ("turbo", {"dp": 2, "tp": 2}, "tp", None),
                 ("pallas_int4", {"dp": 2, "tp": 2}, "tp", None),
                 ("turbo", {"fsdp": 4}, "fsdp", None),
                 ("turbo", {"dp": 2, "tp": 2}, "tp", "multilora"))


def _tiny_case(path: str, lora: bool):
    """(config, CPU weights, CPU bank or None, image config, inputs) of a tiny
    path (check_tiny_path's), with 4 adapters of rank 4 for `lora`."""
    tvlm = _tiny_vlm(path)
    cfg = _serving(path, tvlm, prompt_pad_len=64, codec_vocab_size=tvlm.llm.vocab_size)
    params = _init(path, cfg.vlm, torch.Generator().manual_seed(1), "cpu")
    bank = None
    if lora:
        lcfg = LoRAConfig(r=4)
        adapters = [_random_b(init_lora_params(params, lcfg, torch.Generator().manual_seed(5 + i)),
                              torch.Generator().manual_seed(9 + i), 0.05) for i in range(4)]
        bank = multilora.stack_adapter_banks(adapters, lcfg, dtype=cfg.vlm.llm.dtype)
    img_cfg = ImageTransformConfig(specs=(
        BackboneTransformSpec((28, 28), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        BackboneTransformSpec((28, 28), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))))
    return cfg, params, bank, img_cfg, _inputs(cfg, 4, 40, torch.Generator().manual_seed(2), "cpu")


def _tiny_sel(dev):
    return multilora.adapter_one_hot(np.array([-1, 0, 1, 2]), 4, device=dev)


# tiny_parallel's training cases (slice 6b): QLoRA over the tiny int8 trunk on the w8a8 STE
# route (the row-parallel products through the four row kernels and `_RowExactSTE`), rank 64
# so that the rules split the factors, one sharded step a case on the four ranks
TINY_TRAIN_PARALLEL = (({"dp": 2, "tp": 2}, "tp"), ({"dp": 2, "fsdp": 2}, "zero2"),
                       ({"fsdp": 2, "tp": 2}, "fsdp+tp"), ({"sp": 2, "tp": 2}, "tp"))
TINY_TRAIN_R = 64


def _tiny_train_case():
    """(config, CPU base, CPU adapters, CPU batch) of the tiny training cases:
    bench_finetune's int8 trainer over VLMConfig.tiny(), 4 rows of 16 text
    tokens (20 spliced), B drawn small and nonzero."""
    cfg = bench_finetune.train_config(vlm.VLMConfig.tiny(), "int8")
    base = bench_finetune.base_params(cfg, "int8", torch.Generator().manual_seed(1), "cpu")
    lora = _random_b(init_lora_params(base, LoRAConfig(r=TINY_TRAIN_R),
                                      torch.Generator().manual_seed(3)),
                     torch.Generator().manual_seed(4))
    batch = bench_finetune.synthetic_batch(cfg, 4, 16, 2, "cpu")
    batch["labels"][0, -9:-5] = -100   # the dp shards' valid counts unequal
    return cfg, base, lora, batch


def _train_setup(cfg, base, lora, mesh, strategy, batch, lr=TRAIN_LR):
    """(step, local state, local base) of a sharded QLoRA step over `base`
    (bench_finetune's optimizer: constant lr, no decay; the batch's tokens on
    sp where the mesh has it), or the one-process step where `mesh` is None."""
    codec = ActionCodec(vocab_size=min(cfg.llm.vocab_size, 32000))
    opt = make_optimizer(OptimizerConfig(learning_rate=lr, lr_schedule_type="constant",
                                         max_steps=2, weight_decay=0.0), lora)
    state = TrainState.create(lora, opt)
    lcfg = LoRAConfig(r=int(next(iter(_ab_leaves(lora)))["A"].shape[-2]))
    if mesh is None:
        loss_fn = make_lora_loss_fn(functools.partial(vla_loss_fn, codec=codec), base, lcfg,
                                    stream=True)
        return make_train_step(cfg, opt, codec, loss_fn=loss_fn), state, base
    lbase = psharding.place_params(base, mesh, strategy)
    loss_fn = make_lora_loss_fn(functools.partial(vla_loss_fn, codec=codec), lbase, lcfg,
                                stream=True)
    specs = psharding.shard_train_state(state, mesh, strategy)
    bspecs = pmesh.sequence_sharding(mesh, batch) if "sp" in mesh.axis_names else \
        pmesh.data_sharding(mesh)
    step = make_sharded_train_step(cfg, opt, mesh, specs, bspecs, codec, loss_fn=loss_fn)
    return step, place_train_state(state, mesh, strategy), lbase


def _train_adapters_apart(got, want) -> dict:
    """The adapters after one AdamW step: the largest distance and the 90th
    and 99th percentiles, in lr."""
    d = torch.cat([(a.float().cpu() - b.float().cpu()).abs().ravel()
                   for a, b in zip(tree_leaves(got), tree_leaves(want))])
    q = torch.quantile(d[:2 ** 24], torch.tensor([0.9, 0.99]))
    return dict(max_lr=float(d.max()) / TRAIN_LR, p90_lr=float(q[0]) / TRAIN_LR,
                p99_lr=float(q[1]) / TRAIN_LR)


def _rank_dev(kind: str) -> torch.device:
    """A rank's device: its card (the one `initialize_distributed` set), or the host."""
    return torch.device("cuda", torch.cuda.current_device()) if kind == "cuda" else \
        torch.device("cpu")


def _tiny_parallel_rank(rank: int, world: int, kind: str = "cuda"):
    """Every TINY_PARALLEL case on this rank: its tree placed, its sharded
    call over the whole batch (tokens, first logits); then every
    TINY_TRAIN_PARALLEL case: one sharded step (loss, grad norm, the local
    adapters after it)."""
    dev = _rank_dev(kind)
    out = []
    for path, axes, strategy, case in TINY_PARALLEL:
        cfg, params, bank, img_cfg, inputs = _tiny_case(path, case == "multilora")
        mesh = pmesh.make_mesh(dict(axes))
        params = _to(params, dev)
        args = tuple(x.to(dev) for x in inputs)
        if case == "multilora":
            call, local, lbank = vla.make_sharded_multilora_predict(
                params, _to(bank, dev), cfg, mesh, image_cfg=img_cfg, strategy=strategy,
                device=dev)
            res = call(local, lbank, _tiny_sel(dev), *args)
        else:
            call, local = vla.make_sharded_predict(params, cfg, mesh, image_cfg=img_cfg,
                                                   strategy=strategy, device=dev,
                                                   return_first_logits=True)
            res = call(local, *args)
        out.append({k: v.cpu() for k, v in res.items()})
    cfg, base, lora, batch = _tiny_train_case()
    for axes, strategy in TINY_TRAIN_PARALLEL:
        mesh = pmesh.make_mesh(dict(axes))
        step, state, _ = _train_setup(cfg, _to(base, dev), _to(lora, dev), mesh, strategy, batch)
        state, m = step(state, _to(batch, dev))
        out.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                        adapters=_to(tp.local_tree(state.params), "cpu"),
                        mu=_to(tp.local_tree(state.opt_state.mu), "cpu")))
    return out


def check_tiny_parallel(dev):
    """tiny_parallel: each TINY_PARALLEL case at tiny fp32 size on four ranks
    against the same tiny path on one card (this process): tokens equal on
    every rank (or within the margin rule, the count printed), actions
    finite."""
    ranks = pdist.run_ranks(_tiny_parallel_rank, 4, (dev.type,), timeout=RANK_TIMEOUT_S,
                            device=dev.type)
    rows = []
    for i, (path, axes, strategy, kind) in enumerate(TINY_PARALLEL):
        cfg, params, bank, img_cfg, inputs = _tiny_case(path, kind == "multilora")
        p = _to(params, dev)
        if kind == "multilora":
            p = multilora.attach_multilora(p, _to(bank, dev), _tiny_sel(dev))
        want = vla.predict_action_from_image(p, cfg, inputs[0].to(dev), img_cfg,
                                             *(x.to(dev) for x in inputs[1:]),
                                             return_first_logits=True, device=dev)
        want = {k: v.cpu() for k, v in want.items()}
        compared = []
        for r in ranks:
            got = r[i]
            assert torch.isfinite(got["actions"]).all()
            gap = ((got["first_logits"] - want["first_logits"]).abs().max().item()
                   if "first_logits" in got else 0.0)
            compared.append(_margin_rule(got["action_tokens"], want["action_tokens"],
                                         want["logit_margins"], gap))
        rows.append(dict(path=path, mesh=axes, strategy=strategy, kind=kind or "predict",
                         tokens=int(want["action_tokens"].numel()),
                         tokens_equal=[int((r[i]["action_tokens"] == want["action_tokens"]).sum())
                                       for r in ranks],
                         margin_rule_compared=compared))
    # the training cases against one process's step on this card, by check_tiny_train's rules
    # (TRAIN_TINY_TOL): the loss; every LoRA gradient in norm (read from the first Adam moment,
    # (1 - b1) times the clipped gradient) and the grad norm by the gradient rule; the adapters
    # within 2 lr everywhere, 90 % within 1e-2 lr and 99 % within 1e-1 lr
    cfg, base, lora, batch = _tiny_train_case()
    step, state, _ = _train_setup(cfg, _to(base, dev), _to(lora, dev), None, None, batch)
    state, m = step(state, _to(batch, dev))
    want_loss, want_gn = float(m["loss"]), float(m["grad_norm"])
    for j, (axes, strategy) in enumerate(TINY_TRAIN_PARALLEL):
        apart = []
        for rank, r in enumerate(ranks):
            got = r[len(TINY_PARALLEL) + j]
            assert abs(got["loss"] - want_loss) <= TRAIN_TINY_TOL["loss"] * abs(want_loss), (
                axes, rank, got["loss"], want_loss)
            assert abs(got["grad_norm"] - want_gn) <= TRAIN_TINY_TOL["grad"] * want_gn, (
                axes, rank, got["grad_norm"], want_gn)
            mesh = pmesh.Mesh(dict(axes), rank=rank)
            want = tp.local_tree(psharding.place_params(_to(state.params, "cpu"), mesh, strategy))
            a = _train_adapters_apart(got["adapters"], want)
            assert a["max_lr"] <= 2 and a["p90_lr"] <= 1e-2 and a["p99_lr"] <= 1e-1, (
                axes, rank, a)
            mu_spec = psharding.shard_train_state(state, mesh, strategy).opt_state.mu
            want_mu = tp.local_tree(psharding.place_params(_to(state.opt_state.mu, "cpu"), mesh,
                                                           _path="mu", _spec=mu_spec))
            grads = [_leaf_apart(g, w) for g, w in zip(tree_leaves(got["mu"]),
                                                       tree_leaves(want_mu))]
            assert len(grads) > 20 and max(grads) <= TRAIN_TINY_TOL["grad"], (
                axes, rank, max(grads))
            apart.append(dict(loss_rel=abs(got["loss"] - want_loss) / want_loss,
                              grad_norm_rel=abs(got["grad_norm"] - want_gn) / want_gn,
                              grads_max_rel_apart=max(grads), **a))
        rows.append(dict(kind="train", mesh=axes, strategy=strategy, rank_r=TINY_TRAIN_R,
                         loss=want_loss, grad_norm=want_gn, ranks_apart=apart))
    return dict(entry="tiny_parallel", ranks=4, cases=rows)


def _nccl_rank(rank: int, world: int):
    """A rank of a world of one on NCCL (a card a rank): each collective the
    sharded forward issues, on CUDA tensors."""
    dev = _rank_dev("cuda")
    group = torch.distributed.group.WORLD
    t = torch.arange(4, dtype=torch.int32, device=dev)
    pdist.all_reduce(t, "sum", group)
    m = torch.arange(4, dtype=torch.float32, device=dev)
    pdist.all_reduce(m, "max", group)
    b = torch.full((4,), 1.5, dtype=torch.bfloat16, device=dev)
    pdist.all_reduce(b, "sum", group)
    g = pdist.all_gather(m, 0, group)
    pdist.barrier()
    return dict(backend=torch.distributed.get_backend(), int32_sum=t.tolist(), fp32_max=m.tolist(),
                bf16_sum=b.float().tolist(), gathered=g.tolist(),
                broadcast=pdist.broadcast_host_value(np.arange(3)).tolist(),
                calls=dict(pdist.COLLECTIVE_CALLS))


def check_nccl_one(dev):
    """One NCCL run at world size 1 (the backend rule's other branch): the
    collectives of the sharded forward on the card, each the identity."""
    (r,) = pdist.run_ranks(_nccl_rank, 1, timeout=RANK_TIMEOUT_S)
    assert r["backend"] == "nccl", r["backend"]
    assert r["int32_sum"] == [0, 1, 2, 3] and r["fp32_max"] == [0.0, 1.0, 2.0, 3.0]
    assert r["bf16_sum"] == [1.5] * 4 and r["gathered"] == r["fp32_max"]
    assert r["broadcast"] == [0, 1, 2] and r["calls"] == {"all_reduce": 3, "all_gather": 1}
    return dict(entry="nccl_world_1", **r)


PHASE_S: dict = {}   # phase -> wall seconds (the `phases` line)


class _phase:
    """Adds the wall seconds of its block to PHASE_S[name]."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        PHASE_S[self.name] = PHASE_S.get(self.name, 0.0) + time.perf_counter() - self.t0


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

    with _phase("build"):
        _build.build_all()
    ptxas = {n: [l.strip() for l in out.splitlines() if "registers" in l or "spill" in l]
             for n, out in _build.build_report["logs"].items()}
    log("build", seconds=_build.build_report["seconds"], ptxas=ptxas)
    # each kernel's registers a thread and spill bytes, from ptxas -v
    log("resources", kernels={n: _build.resource_usage(out)
                              for n, out in _build.build_report["logs"].items()})

    g = torch.Generator(device=dev).manual_seed(1234)
    with _phase("kernels"):
        kernels = [check_flash_prefill(dev, g), check_flash_blockwise(dev, g),
                   check_vit_attention(dev, g),
                   check_decode_attention(dev, g), check_wi8_matmul(dev, g),
                   check_fused_ln_w8a8(dev, g), check_fused_mlp_residual(dev, g),
                   check_decode_split_attention(dev, g), check_stacked_decode_i8(dev, g),
                   check_w4a8_matmul(dev, g), check_w8a8_matmul(dev, g),
                   check_rms_norm_quant(dev, g), check_nib_hi_dot(dev, g),
                   check_w4a8_dx(dev, g), check_w8a8_requant(dev, g),
                   check_split_attention_i8(dev, g), check_w4a8_grouped(dev, g),
                   check_expert_ragged(dev, g), check_expert_ragged_scalar(dev, g),
                   *check_expert_ragged_bwd(dev, g), *check_expert_ragged_bwd_scalar(dev, g),
                   *check_row_parallel(dev, g)]
        # the scalar routes: no main path takes them (the tiny fp32 paths do)
        scalar_routes = [check_decode_attention_scalar(dev, g),
                         check_decode_split_attention_scalar(dev, g),
                         check_vit_attention_scalar(dev, g), check_flash_prefill_scalar(dev, g),
                         check_wi8_matmul_scalar(dev, g), check_stacked_decode_i8_scalar(dev, g),
                         check_split_attention_i8_scalar(dev, g)]
    log("kernels", card=card, results=kernels, scalar_routes=scalar_routes)

    tiny = {}
    with _phase("tiny"):
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
        for path, install in (("parity", "masked"), ("turbo", "masked"), ("turbo", "fused"),
                              ("pallas", "masked"), ("pallas", "fused")):
            log("tiny", **check_tiny_multilora(dev, path, install))
        for dtype in (torch.float32, torch.bfloat16):
            row = check_tiny_moe(dev, dtype)
            tiny[f"tiny_moe_{row['dtype']}"] = row["launches"]
            log("tiny", **row)
            row = check_tiny_moe_train(dev, dtype)
            tiny[f"tiny_moe_train_{row['dtype']}"] = row["launches"]
            log("tiny", **row)
        # slice 6a: the tiny paths sharded over four ranks, and beside them NCCL at world
        # size 1 (its own process group)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            nccl = pool.submit(check_nccl_one, dev)
            log("tiny", **check_tiny_parallel(dev))
            log("tiny", **nccl.result())

    # the load phase's repository stays here for the cli phase; removed whatever happens
    hub = Path(tempfile.mkdtemp(prefix="ovla_hub_"))
    try:
        launches, weights, snap = {}, {}, None
        # pallas, pallas_kv8, turbo, turbo_kv8 and turbo_fused share one build of the int8
        # weights (fused in place after turbo's phases), pallas_int4 and turbo_int4 one of the
        # int4 weights
        for path in PATHS:
            with _phase(f"main:{path}"):
                launches[path], main_stats = run_main_path(dev, path, weights)
                log("main", card=card, batch=BATCH, launches_per_call=launches[path],
                    **main_stats)
                torch.cuda.empty_cache()
            if path == "pallas_kv8":   # the probe tap on the same weights
                with _phase("probe"):
                    log("probe", card=card, tap=run_probe_tap(dev, weights[PATHS[path][1]]))
                    torch.cuda.empty_cache()
            if path in BS1_PATHS:      # the bs = 1 point on the same weights
                with _phase(f"bs1:{path}"):
                    log("bs1", card=card, **run_bs1(dev, path, weights[PATHS[path][1]]))
                    torch.cuda.empty_cache()
            if path == "turbo":        # the action server on turbo's int8 weights
                with _phase("serve"):
                    log("serve", card=card, **run_serve(dev, weights[PATHS[path][1]]))
                    torch.cuda.empty_cache()
                # multi-LoRA on the same weights, turbo and pallas (after pallas's main path)
                with _phase("multilora"):
                    log("multilora", card=card, **run_multilora(dev, weights[PATHS[path][1]]))
                    torch.cuda.empty_cache()
            if path == "parity":   # the base VLM's entry points on the same bf16 weights
                for vpath in VLM_PATHS:
                    with _phase(f"main:{vpath}"):
                        launches[vpath], vstats = run_vlm_path(dev, vpath, weights[None])
                        log("main", card=card, launches_per_call=launches[vpath], **vstats)
                        torch.cuda.empty_cache()
                # a released-layout checkpoint of the same weights, written and loaded back
                with _phase("load"):
                    loaded = run_load(dev, weights[None], hub)
                    snap = Path(loaded["snapshot"])
                    log("load", card=card, **loaded)
                    torch.cuda.empty_cache()
        weights.clear()
        for path in TRAIN_PATHS:
            with _phase(f"train:{path}"):
                launches[path], train_stats = run_train_path(dev, path)
                log("main", card=card, launches_per_step=launches[path], **train_stats)
                torch.cuda.empty_cache()
        with _phase("bank"):
            log("probe", card=card, bank=run_probe_bank(dev))
        # the command line over the load phase's repository, the card otherwise empty
        torch.cuda.empty_cache()
        with _phase("cli"):
            log("cli", card=card, **run_cli(dev, snap, hub / "cli"))
    finally:
        shutil.rmtree(hub, ignore_errors=True)
    # slice 7 on a card that holds nothing else: the Mixtral VLM (47.7 GB at int8), then in
    # bf16 at 4 layers, then phi-2+3b
    torch.cuda.empty_cache()
    for path in ("moe_turbo", "moe_parity"):
        with _phase(f"main:{path}"):
            launches[path], moe_stats = run_moe_path(dev, path)
            log("main", card=card, batch=MOE_BATCH, launches_per_call=launches[path],
                **moe_stats)
        if path == "moe_turbo":   # slice 8a: training the same VLM, its tree freed
            with _phase("train:moe_train"):
                launches["moe_train"], train_stats = run_moe_train(dev)
                log("main", card=card, launches_per_step=launches["moe_train"], **train_stats)
    with _phase("main:phi"):
        launches["phi"], phi_stats = run_phi(dev)
        log("main", card=card, launches_per_call=launches["phi"], **phi_stats)
    # slice 6a on the freed card: OpenVLA-7B turbo at tp = 2, Mixtral's trunk at ep = 2, each
    # rank a process (two processes time-sliced on one card: no multi-card figure)
    torch.cuda.empty_cache()
    with _phase("main:tp2_turbo"):
        launches["tp2_turbo"], tp_stats = run_tp2_turbo(dev)
        log("main", card=card, launches_per_rank_call=launches["tp2_turbo"], **tp_stats)
    with _phase("main:ep2_moe_turbo"):
        log("main", card=card, **run_ep2_moe(dev))
    # slice 6b: train_int8's QLoRA step at tp = 2 on the freed card
    torch.cuda.empty_cache()
    with _phase("train:tp2_train_int8"):
        launches["tp2_train_int8"], tp_train = run_tp2_train_int8(dev)
        log("main", card=card, launches_per_rank_step=launches["tp2_train_int8"], **tp_train)

    # each kernel's launches: from the main path whose slice ported it (expert_ragged_scalar:
    # the tiny fp32 MoE path, the one path that takes it); a scalar route's from every main
    # path (none takes one) and, apart, from the tiny paths that run it
    for k in kernels:
        counts = tiny if k["name"] in TINY_PORTED else launches
        k["launches"] = counts[PORTED_ON.get(k["name"], "pallas")][k["name"]]
        assert k["launches"] > 0, k["name"]
    for k in scalar_routes:
        k["launches"] = sum(counts.get(k["name"], 0) for counts in launches.values())
        k["tiny_launches"] = sum(counts.get(k["name"], 0) for counts in tiny.values())
        assert k["tiny_launches"] > 0, k["name"]
    log("phases", card=card, seconds=PHASE_S, total_s=time.perf_counter() - _START)
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
