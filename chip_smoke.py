#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Two serving paths, each at full OpenVLA-7B width through the normal entry
`predict_action_from_image`: the parity tier (bf16 weights, stacked-cache
decode) and the pallas tier (int8 TURBO_QUANT_SUFFIXES weights, turbo
numerics, frozen-KV split decode). Phases, one output line each:
  1. device   the card's name and power limit (nvidia-smi)
  2. build    compiles every CUDA kernel from ops/csrc, one nvcc per source,
              all started together (set-up time)
  3. kernels  each kernel against its plain PyTorch version at the 7B main-path
              shapes (B=24), with kernel / plain / library times: flash_prefill,
              vit_attention, decode_attention (parity path), wi8_matmul,
              fused_ln_w8a8, fused_mlp_residual, decode_split_attention (pallas)
  4. tiny     each path at tiny fp32 size on the card vs the CPU run (plain
              versions, which the CPU tests hold against the JAX package)
  5. main     each path once with every launch count set to 0 just before and
              read just after (exact per-kernel counts asserted), then p50
              latency and calls/s over timed calls; random weights from a
              seeded generator on the card, 256x256 uint8 images,
              prompt_pad_len=32, A=7
then a JSON line of per-kernel figures and a last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero; with
no CUDA card it exits 1 before printing any result.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch
import torch.nn.functional as F

from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import vla, vlm
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import attention as attn
from openvla_probe_tpu_torch.ops import decode_attention as dattn
from openvla_probe_tpu_torch.ops import linear as lin
from openvla_probe_tpu_torch.ops import vit_mlp as vmlp
from openvla_probe_tpu_torch.ops.image import BackboneTransformSpec, ImageTransformConfig

# published H100 SXM peaks (dense): HBM bytes/s; bf16 and int8 tensor-core and
# fp32 FMA operations/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
BATCH, PROMPT_PAD, ACTION_DIM, IMG_HW = 24, 32, 7, 256
LAYERS, T_PREFILL = 32, 288            # Llama-2-7B layers; 1 + 256 patches + 31 prompt tokens
TOWER_LAUNCHES = {"dinov2": 23, "siglip": 26}   # blocks 0..L-2 of each tower run
TIMED_CALLS = 5
L2_BYTES = 50e6


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


def rotating(fn, arg_sets):
    """`fn` over several copies of its inputs in turn, so that timed launches
    read them from device memory as the main path does, not from L2."""
    it = itertools.cycle(arg_sets)
    return lambda: fn(*next(it))


def copies_past_l2(nbytes: int) -> int:
    return max(1, int(-(-2 * L2_BYTES // nbytes)))


def bound_ms(nbytes: int, flops: int, kind: str):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_flash_prefill(dev, g):
    """Row 1 of the kernel table at the 7B prefill shape: q [24, 288, 32, 128],
    k/v [24, 295, 32, 128] bf16 (stacked cache S = T + A), padded prompts."""
    B, T, S, H, Dh = BATCH, 288, 295, 32, 128
    q = torch.randn((B, T, H, Dh), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, H, Dh), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, H, Dh), generator=g, device=dev).bfloat16()
    mm_len = torch.randint(T - 12, T + 1, (B,), generator=g, device=dev)
    valid = (torch.arange(S, device=dev)[None] < mm_len[:, None]).int()   # tail slots padded
    valid[-1, 0] = 0                      # query 0 of the last row: every key masked
    before = attn.KERNEL_LAUNCHES["flash_prefill"]
    got = attn.flash_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert attn.KERNEL_LAUNCHES["flash_prefill"] == before + 1
    want = attn.flash_attention_plain(q, k, v, valid)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    err = (got.float() - want.float()).abs().max().item()
    ki = torch.arange(S, device=dev)
    sdpa_mask = ((valid[:, None, None, :] > 0)
                 & (ki[None, :] <= torch.arange(T, device=dev)[:, None])[None, None])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = cuda_ms(lambda: attn.flash_attention(q, k, v, valid))
    plain = cuda_ms(lambda: attn.flash_attention_plain(q, k, v, valid), reps=10)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask))
    b, by = bound_ms(_nbytes(q, k, v, got, valid), 4 * B * H * T * S * Dh, "bf16")
    return dict(name="flash_prefill", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/flash_prefill.cu",
                replaces="openvla_probe_tpu/ops/attention.py:88",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=lib)


def check_vit_attention(dev, g):
    """Row 3 at the tower shapes: DINOv2 [24, 261, 16, 64] (23 launches/call)
    and SigLIP [24, 256, 16, 72] (26 launches/call), as strided views of one
    qkv product like the towers pass them; bf16 at 2e-2 and fp32 at 1e-5."""
    shapes = {"dinov2": (261, 16, 64, 23), "siglip": (256, 16, 72, 26)}
    by_shape = {}
    for name, (N, H, Dh, per_call) in shapes.items():
        row = {}
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            qkv = torch.randn((BATCH * N, 3 * H * Dh), generator=g, device=dev).to(dtype)
            q, k, v = (t.reshape(BATCH, N, H, Dh) for t in qkv.split(H * Dh, dim=-1))
            before = attn.KERNEL_LAUNCHES["vit_attention"]
            got = attn.vit_flash_attention(q, k, v)
            torch.cuda.synchronize()
            assert attn.KERNEL_LAUNCHES["vit_attention"] == before + 1
            want = attn.vit_flash_attention_plain(q, k, v)
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                row["fp32_max_abs_err"] = err
                continue
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            b, by = bound_ms(_nbytes(q, k, v, got), 4 * BATCH * H * N * N * Dh, "fp32")
            row.update(max_abs_err=err, launches_per_call=per_call,
                       ms=cuda_ms(lambda: attn.vit_flash_attention(q, k, v)),
                       plain_ms=cuda_ms(lambda: attn.vit_flash_attention_plain(q, k, v)),
                       library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                       bound_ms=b, bound_by=by)
        by_shape[name] = row
    n = sum(r["launches_per_call"] for r in by_shape.values())

    def per_launch(key):   # mean over the main path's launch mix
        return sum(r[key] * r["launches_per_call"] for r in by_shape.values()) / n

    return dict(name="vit_attention", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/vit_attention.cu",
                replaces="openvla_probe_tpu/ops/attention.py:255",
                max_abs_err=max(r["max_abs_err"] for r in by_shape.values()),
                ms=per_launch("ms"), plain_ms=per_launch("plain_ms"),
                bound_ms=per_launch("bound_ms"),
                bound_by="/".join(sorted({r["bound_by"] for r in by_shape.values()})),
                library_ms=per_launch("library_ms"), by_shape=by_shape)


def check_decode_attention(dev, g):
    """The decode-step attention at the 7B shape: q [24, 1, 32, 128] over one
    layer of the stacked cache, k/v [24, 295, 32, 128] bf16, padded prompts,
    the query at slot 291 (the fourth decode step)."""
    B, T, S, H, Dh, slot = BATCH, 288, 295, 32, 128, 291
    q = torch.randn((B, 1, H, Dh), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, H, Dh), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, H, Dh), generator=g, device=dev).bfloat16()
    mm_len = torch.randint(T - 12, T + 1, (B,), generator=g, device=dev)
    slots = torch.arange(S, device=dev)[None]
    valid = ((slots < mm_len[:, None]) | ((slots >= T) & (slots <= slot))).int()
    before = attn.KERNEL_LAUNCHES["decode_attention"]
    got = attn.decode_attention(q, k, v, valid, slot)
    torch.cuda.synchronize()
    assert attn.KERNEL_LAUNCHES["decode_attention"] == before + 1
    want = attn.decode_attention_plain(q, k, v, valid, slot)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    err = (got.float() - want.float()).abs().max().item()
    sdpa_mask = ((valid > 0) & (slots <= slot))[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b, by = bound_ms(_nbytes(q, k, v, got, valid), 4 * B * H * S * Dh, "bf16")
    return dict(name="decode_attention", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/decode_attention.cu",
                replaces="openvla_probe_tpu/models/llama.py:225",
                max_abs_err=err, ms=cuda_ms(lambda: attn.decode_attention(q, k, v, valid, slot)),
                plain_ms=cuda_ms(lambda: attn.decode_attention_plain(q, k, v, valid, slot)),
                bound_ms=b, bound_by=by,
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask)))


def _launch_weighted(by_shape: dict, per_call: dict) -> dict:
    """Per-launch means over a kernel's main-path launch mix."""
    n = sum(per_call.values())
    out = {key: sum(by_shape[s][key] * per_call[s] for s in by_shape) / n
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    out["max_abs_err"] = max(r["max_abs_err"] for r in by_shape.values())
    out["bound_by"] = "/".join(sorted({r["bound_by"] for r in by_shape.values()}))
    return out


def check_wi8_matmul(dev, g):
    """Row 7 at every (M, K, N) of the pallas path: prefill M = 24 x 288 = 6912
    and decode / lm_head M = 24. bf16 x, int8 codes, fp32 scales; within 1e-2
    of the plain version (exact products, fp32 sums in another order, then
    one bf16 rounding). Library: cuBLAS bf16 x @ w_bf16ᵀ on weights
    dequantized beforehand (it leaves out the dequantization and streams 2x
    the weight bytes)."""
    M_pre, M_dec, A1 = BATCH * T_PREFILL, BATCH, ACTION_DIM - 1
    per_call = {(M_pre, 4096, 4096): 4 * LAYERS, (M_pre, 4096, 11008): 2 * LAYERS,
                (M_pre, 11008, 4096): LAYERS, (M_dec, 4096, 4096): 4 * LAYERS * A1,
                (M_dec, 4096, 11008): 2 * LAYERS * A1, (M_dec, 11008, 4096): LAYERS * A1,
                (M_dec, 4096, 32064): 1 + A1}
    by_shape = {}
    for (M, K, N) in per_call:
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = []
        for _ in range(copies_past_l2(N * K)):
            q = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8)
            s = torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-3
            sets.append((x, q, s))
        got = lin.wi8_matmul(*sets[0])
        torch.cuda.synchronize()
        want = lin.wi8_matmul_plain(*sets[0])
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
        w_bf16 = [(x, lin.dequantize_weight({"q": q, "s": s})) for x, q, s in sets]
        b, by = bound_ms(_nbytes(x, sets[0][1], sets[0][2], got), 2 * M * N * K, "bf16")
        by_shape[f"{M}x{K}x{N}"] = dict(
            launches_per_call=per_call[(M, K, N)],
            max_abs_err=(got.float() - want.float()).abs().max().item(),
            ms=cuda_ms(rotating(lin.wi8_matmul, sets)),
            plain_ms=cuda_ms(rotating(lin.wi8_matmul_plain, sets), reps=5, warmup=1),
            library_ms=cuda_ms(rotating(lambda a, w: a @ w.t(), w_bf16)),
            bound_ms=b, bound_by=by)
        del sets, w_bf16, got, want
    mix = _launch_weighted(by_shape, {f"{M}x{K}x{N}": n for (M, K, N), n in per_call.items()})
    return dict(name="wi8_matmul", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/wi8_matmul.cu",
                replaces="openvla_probe_tpu/ops/linear.py:327", by_shape=by_shape, **mix)


def _int_mm_dot(codes, q):
    """The library yardstick of the w8a8 products: cuBLASLt int8 GEMM."""
    return torch._int_mm(codes, q.t()).float()


def _tower_weight(n, k, g, dev):
    return lin.quantize_weight(torch.randn((n, k), generator=g, device=dev) * 0.02)


def check_fused_ln_w8a8(dev, g):
    """Row 10 at its four call forms: each tower's qkv entry (LN1 first) and
    proj exit (residual; DINOv2's LayerScale). The kernel's activation codes
    within one step of the plain version's, and its output bit-equal to the
    plain version's on its own codes (vmlp.compare_ln_w8a8); without a
    LayerNorm the codes are equal, so the output equals the plain version's
    bit for bit. Library: the plain version with torch._int_mm for the
    integer product (it leaves the LayerNorm, quantize and epilogue as
    separate passes)."""
    forms = {"dinov2_qkv": (6264, 1024, 3072, "ln", 23), "dinov2_proj": (6264, 1024, 1024, "res_ls", 23),
             "siglip_qkv": (6144, 1152, 3456, "ln", 26), "siglip_proj": (6144, 1152, 1152, "res", 26)}
    by_shape = {}
    for name, (M, K, N, form, per_call) in forms.items():
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        w = _tower_weight(N, K, g, dev)
        b = (torch.randn((N,), generator=g, device=dev) * 0.1).bfloat16()
        kw = {}
        if form == "ln":
            kw["ln"] = ((1 + 0.1 * torch.randn((K,), generator=g, device=dev)).bfloat16(),
                        (0.1 * torch.randn((K,), generator=g, device=dev)).bfloat16())
        else:
            kw["res"] = torch.randn((M, N), generator=g, device=dev).bfloat16()
            if form == "res_ls":
                kw["ls"] = torch.randn((N,), generator=g, device=dev).bfloat16()
        got, stats = vmlp.compare_ln_w8a8(x, w, b, **kw)
        torch.cuda.synchronize()
        want = vmlp.fused_ln_w8a8_plain(x, w, b, **kw)
        if form != "ln":
            assert torch.equal(got, want), f"{name}: not bit-equal to the plain version"
        with mock.patch.object(vmlp, "int8_dot", _int_mm_dot):
            lib = cuda_ms(lambda: vmlp.fused_ln_w8a8_plain(x, w, b, **kw))
        nbytes = _nbytes(x, w["q"], w["s"], b, got, *kw.get("ln", ()), *(
            [kw["res"]] if "res" in kw else []), *([kw["ls"]] if "ls" in kw else []))
        bnd, by = bound_ms(nbytes, 2 * M * N * K, "int8")
        by_shape[name] = dict(
            launches_per_call=per_call, max_abs_err=(got.float() - want.float()).abs().max().item(),
            equal_share=(got == want).float().mean().item(), **stats,
            ms=cuda_ms(lambda: vmlp.fused_ln_w8a8(x, w, b, **kw)),
            plain_ms=cuda_ms(lambda: vmlp.fused_ln_w8a8_plain(x, w, b, **kw), reps=5, warmup=1),
            library_ms=lib, bound_ms=bnd, bound_by=by)
    mix = _launch_weighted(by_shape, {k: v[4] for k, v in forms.items()})
    return dict(name="fused_ln_w8a8", route="cuda", source="openvla_probe_tpu_torch/ops/csrc/vit_mlp.cu",
                replaces="openvla_probe_tpu/ops/vit_mlp.py:123", by_shape=by_shape, **mix)


def check_fused_mlp_residual(dev, g):
    """Row 11 at both towers' MLP halves (turbo act gelu_tanh): DINOv2 with
    LayerScale, SigLIP (F = 4304 = 16 x 269) with ones; both activation codes
    within one step of the plain version's and the output bit-equal to the
    plain version's on the kernel's own codes (vmlp.compare_mlp_residual).
    Library: the plain version with torch._int_mm for both integer products
    (it writes the [M, F] intermediate to device memory, as the fused kernel
    does not)."""
    towers = {"dinov2": (6264, 1024, 4096, True), "siglip": (6144, 1152, 4304, False)}
    by_shape = {}
    for name, (M, D, F_, layerscale) in towers.items():
        bf = lambda t: t.bfloat16()
        x = bf(torch.randn((M, D), generator=g, device=dev))
        ln = (bf(1 + 0.1 * torch.randn((D,), generator=g, device=dev)),
              bf(0.1 * torch.randn((D,), generator=g, device=dev)))
        fc1, fc2 = _tower_weight(F_, D, g, dev), _tower_weight(D, F_, g, dev)
        b1 = bf(0.1 * torch.randn((F_,), generator=g, device=dev))
        b2 = bf(0.1 * torch.randn((D,), generator=g, device=dev))
        ls2 = bf(torch.randn((D,), generator=g, device=dev)) if layerscale else \
            torch.ones((D,), dtype=torch.bfloat16, device=dev)
        args = (x, *ln, fc1, b1, fc2, b2, ls2)
        got, stats = vmlp.compare_mlp_residual(*args)
        torch.cuda.synchronize()
        want = vmlp.fused_mlp_residual_plain(*args)
        with mock.patch.object(vmlp, "int8_dot", _int_mm_dot):
            lib = cuda_ms(lambda: vmlp.fused_mlp_residual_plain(*args))
        bnd, by = bound_ms(_nbytes(x, *ln, fc1["q"], fc1["s"], b1, fc2["q"], fc2["s"], b2, ls2, got),
                           4 * M * D * F_, "int8")
        by_shape[name] = dict(
            launches_per_call=TOWER_LAUNCHES[name],
            max_abs_err=(got.float() - want.float()).abs().max().item(),
            equal_share=(got == want).float().mean().item(), **stats,
            ms=cuda_ms(lambda: vmlp.fused_mlp_residual(*args)),
            plain_ms=cuda_ms(lambda: vmlp.fused_mlp_residual_plain(*args), reps=5, warmup=1),
            library_ms=lib, bound_ms=bnd, bound_by=by)
    mix = _launch_weighted(by_shape, TOWER_LAUNCHES)
    return dict(name="fused_mlp_residual", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/vit_mlp.cu",
                replaces="openvla_probe_tpu/ops/vit_mlp.py:62", by_shape=by_shape, **mix)


def check_decode_split_attention(dev, g):
    """Row 4 at the 7B decode shape: q [24, 1, 32, 128] over one layer of the
    frozen prefill K/V [24, 288, 32, 128] and of the generated K/V
    [24, 6, 32, 128] (strided layer slices of stacked buffers), padded
    prompts, decode step 3; within 2e-2 of the plain version (bf16). Library:
    SDPA on K/V concatenated beforehand (it leaves out the concatenation and
    rounds P to bf16)."""
    B, T, A, H, Dh = BATCH, T_PREFILL, ACTION_DIM - 1, 32, 128
    kp, vp = (torch.randn((2, B, T, H, Dh), generator=g, device=dev).bfloat16() for _ in range(2))
    kd, vd = (torch.randn((2, B, A, H, Dh), generator=g, device=dev).bfloat16() for _ in range(2))
    q = torch.randn((B, 1, H, Dh), generator=g, device=dev).bfloat16()
    mm_len = torch.randint(T - 12, T + 1, (B,), generator=g, device=dev)
    pre = (torch.arange(T, device=dev)[None] < mm_len[:, None]).int()
    dec = (torch.arange(A, device=dev) <= 3).int()[None].expand(B, A)
    sets = [(q, kp[i], vp[i], kd[i], vd[i], pre, dec) for i in range(2)]
    got = dattn.decode_flash_attention(*sets[0])
    torch.cuda.synchronize()
    want = dattn.decode_flash_attention_plain(*sets[0])
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    sdpa_mask = torch.cat([pre, dec], dim=1).bool()[:, None, None, :]
    lib_sets = [(q.transpose(1, 2), torch.cat([kp[i], kd[i]], 1).transpose(1, 2),
                 torch.cat([vp[i], vd[i]], 1).transpose(1, 2)) for i in range(2)]
    b, by = bound_ms(_nbytes(q, kp[0], vp[0], kd[0], vd[0], pre, dec, got),
                     4 * B * H * (T + A) * Dh, "fp32")
    return dict(name="decode_split_attention", route="cuda",
                source="openvla_probe_tpu_torch/ops/csrc/decode_split_attention.cu",
                replaces="openvla_probe_tpu/ops/decode_attention.py:33",
                max_abs_err=(got.float() - want.float()).abs().max().item(),
                ms=cuda_ms(rotating(dattn.decode_flash_attention, sets)),
                plain_ms=cuda_ms(rotating(dattn.decode_flash_attention_plain, sets)),
                bound_ms=b, bound_by=by,
                library_ms=cuda_ms(rotating(lambda qt, kt, vt: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask), lib_sets)))


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


# the kernels each path must launch (every other count must stay 0)
PATH_KERNELS = {
    "parity": ("flash_prefill", "vit_attention", "decode_attention"),
    "pallas": ("flash_prefill", "vit_attention", "fused_ln_w8a8", "fused_mlp_residual",
               "wi8_matmul", "decode_split_attention"),
}


def _serving(tier: str, vlm_cfg: vlm.VLMConfig, **kw) -> vla.VLAServingConfig:
    return vla.VLAServingConfig.for_tier(vlm_cfg, tier, **kw)


def _quant_suffixes(tier: str):
    return lin.TURBO_QUANT_SUFFIXES if tier == "pallas" else ()


def check_tiny_path(dev, tier: str):
    """The whole path at tiny fp32 size (T = 68 >= 64, so the flash kernel
    runs) on the card vs the CPU run of the plain versions: equal tokens,
    close logits (parity 1e-4; pallas 1e-3, where an activation code at a
    rounding tie may land one step apart between the two LayerNorm sums)."""
    cfg = _serving(tier, vlm.VLMConfig.tiny(), prompt_pad_len=64, codec_vocab_size=512)
    params = convert.init_params(cfg.vlm, torch.Generator().manual_seed(1), device="cpu",
                                 quant_suffixes=_quant_suffixes(tier))
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
    assert launched == set(PATH_KERNELS[tier]), _build.KERNEL_LAUNCHES
    assert torch.equal(out["action_tokens"].cpu(), ref["action_tokens"])
    err = (out["first_logits"].cpu() - ref["first_logits"]).abs().max().item()
    assert err < (1e-4 if tier == "parity" else 1e-3), err
    return dict(tier=tier, tokens_equal=True, first_logits_max_abs_err=err)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _expected_launches(cfg: vla.VLAServingConfig) -> dict:
    L, A1 = cfg.vlm.llm.num_hidden_layers, cfg.action_dim - 1
    blocks = sum(v.num_layers - 1 for v in cfg.vlm.vision)       # 23 + 26 tower blocks run
    expect = dict.fromkeys(_build.KERNEL_LAUNCHES, 0)
    expect.update(flash_prefill=L, vit_attention=blocks)
    if cfg.tier == "parity":
        expect["decode_attention"] = L * A1                          # 32 x 6
    else:
        expect.update(fused_ln_w8a8=2 * blocks, fused_mlp_residual=blocks,
                      # 7 linears per layer at prefill and each step, lm_head 1 + A1 times
                      wi8_matmul=7 * L + 1 + A1 * (7 * L + 1),
                      decode_split_attention=L * A1)
    return expect


def run_main_path(dev, tier: str):
    cfg = _serving(tier, vlm.VLMConfig.openvla_7b(), action_dim=ACTION_DIM,
                   prompt_pad_len=PROMPT_PAD)
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = convert.init_params(cfg.vlm, g, device=dev, quant_suffixes=_quant_suffixes(tier))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()   # the serving peak, not the init's transients
    n_params = sum(t.numel() for t in _leaves(params))
    param_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    img_cfg = ImageTransformConfig.dinosiglip_224()
    image, ids, plen, q01, q99, mask = _inputs(cfg, BATCH, IMG_HW, g, dev)

    def call():
        out = vla.predict_action_from_image(params, cfg, image, img_cfg, ids, plen, q01, q99,
                                            mask, return_first_logits=True, device=dev)
        torch.cuda.synchronize()
        return out

    _build.reset_launch_counts()           # counts from 0 around one driven call
    t0 = time.perf_counter()
    out = call()
    first_s = time.perf_counter() - t0
    launches = dict(_build.KERNEL_LAUNCHES)
    expect = _expected_launches(cfg)
    assert launches == expect, (tier, launches, expect)

    toks, actions, logits = out["action_tokens"], out["actions"], out["first_logits"]
    assert toks.shape == (BATCH, ACTION_DIM), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vlm.llm.vocab_size
    assert actions.shape == (BATCH, ACTION_DIM) and torch.isfinite(actions).all()
    assert logits.shape == (BATCH, cfg.vlm.llm.vocab_size) and torch.isfinite(logits).all()

    times = []
    for _ in range(TIMED_CALLS):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
        assert _build.KERNEL_LAUNCHES == expect, _build.KERNEL_LAUNCHES
    p50 = statistics.median(times)
    return launches, dict(
        tier=tier, params=n_params, param_gb=param_gb, init_s=init_s, first_call_s=first_s,
        p50_ms=p50 * 1e3, calls_per_s=BATCH / p50, call_ms=[t * 1e3 for t in times],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        first_tokens=toks[0].tolist())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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

    g = torch.Generator(device=dev).manual_seed(1234)
    kernels = [check_flash_prefill(dev, g), check_vit_attention(dev, g),
               check_decode_attention(dev, g), check_wi8_matmul(dev, g),
               check_fused_ln_w8a8(dev, g), check_fused_mlp_residual(dev, g),
               check_decode_split_attention(dev, g)]
    log("kernels", card=card, results=kernels)

    for tier in PATH_KERNELS:
        log("tiny", **check_tiny_path(dev, tier))

    launches = {}
    for tier in PATH_KERNELS:
        launches[tier], main_stats = run_main_path(dev, tier)
        log("main", card=card, batch=BATCH, launches_per_call=launches[tier], **main_stats)
        torch.cuda.empty_cache()

    # each kernel's launches: from the main path whose slice ported it (the
    # parity path for the first three, the pallas path for the rest)
    for k in kernels:
        tier = "parity" if k["name"] in PATH_KERNELS["parity"] else "pallas"
        k["launches"] = launches[tier][k["name"]]
        assert k["launches"] > 0, k["name"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
