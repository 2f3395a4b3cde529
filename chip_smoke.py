#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one output line each:
  1. device   the card's name and power limit (nvidia-smi)
  2. build    compiles every CUDA kernel of the path from ops/csrc (set-up time)
  3. kernels  each kernel against its plain PyTorch version at the OpenVLA-7B
              main-path shapes (B=24), with kernel / plain / library times:
              flash_prefill, vit_attention (the two Pallas kernels of the path)
              and decode_attention (the decode steps' attention)
  4. tiny     the whole path at tiny fp32 size on the card vs the CPU run
              (plain versions, which the CPU tests hold against the JAX package)
  5. main     predict_action_from_image at full OpenVLA-7B width (parity tier,
              random bf16 weights from a seeded generator on the card), B=24,
              256x256 uint8 images, prompt_pad_len=32, A=7; kernel launch counts
              read around one call; p50 latency and calls/s over timed calls
then a JSON line of per-kernel figures and a last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero; with
no CUDA card it exits 1 before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import vla, vlm
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import attention as attn
from openvla_probe_tpu_torch.ops.image import BackboneTransformSpec, ImageTransformConfig

# published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core and fp32 FMA FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
BATCH, PROMPT_PAD, ACTION_DIM, IMG_HW = 24, 32, 7, 256
TIMED_CALLS = 5


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of `fn`, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def check_tiny_path(dev):
    """The whole path at tiny fp32 size (T = 68 >= 64, so both kernels run) on
    the card vs the CPU run of the plain versions: equal tokens, close logits."""
    cfg = vla.VLAServingConfig(vlm=vlm.VLMConfig.tiny(), prompt_pad_len=64, codec_vocab_size=512)
    params = convert.init_params(cfg.vlm, torch.Generator().manual_seed(1), device="cpu")
    img_cfg = ImageTransformConfig(specs=(
        BackboneTransformSpec((28, 28), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        BackboneTransformSpec((28, 28), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))))
    inputs = _inputs(cfg, 4, 40, torch.Generator().manual_seed(2), "cpu")
    ref = vla.predict_action_from_image(params, cfg, inputs[0], img_cfg, *inputs[1:],
                                        return_first_logits=True, device="cpu")
    params_d = _to(params, dev)
    before = dict(attn.KERNEL_LAUNCHES)
    out = vla.predict_action_from_image(params_d, cfg, inputs[0].to(dev), img_cfg,
                                        *(x.to(dev) for x in inputs[1:]),
                                        return_first_logits=True, device=dev)
    torch.cuda.synchronize()
    assert all(attn.KERNEL_LAUNCHES[k] > before[k] for k in before), attn.KERNEL_LAUNCHES
    assert torch.equal(out["action_tokens"].cpu(), ref["action_tokens"])
    err = (out["first_logits"].cpu() - ref["first_logits"]).abs().max().item()
    assert err < 1e-4, err
    return dict(tokens_equal=True, first_logits_max_abs_err=err)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def run_main_path(dev):
    cfg = vla.VLAServingConfig(vlm=vlm.VLMConfig.openvla_7b(), action_dim=ACTION_DIM,
                               prompt_pad_len=PROMPT_PAD)
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = convert.init_params(cfg.vlm, g, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    img_cfg = ImageTransformConfig.dinosiglip_224()
    image, ids, plen, q01, q99, mask = _inputs(cfg, BATCH, IMG_HW, g, dev)

    def call():
        out = vla.predict_action_from_image(params, cfg, image, img_cfg, ids, plen, q01, q99,
                                            mask, return_first_logits=True, device=dev)
        torch.cuda.synchronize()
        return out

    torch.cuda.reset_peak_memory_stats()
    attn.reset_launch_counts()            # counts from 0 around one driven call
    t0 = time.perf_counter()
    out = call()
    first_s = time.perf_counter() - t0
    launches = dict(attn.KERNEL_LAUNCHES)
    L = cfg.vlm.llm.num_hidden_layers
    expect = {"flash_prefill": L,                                               # 32
              "vit_attention": sum(v.num_layers - 1 for v in cfg.vlm.vision),   # 23 + 26
              "decode_attention": L * (ACTION_DIM - 1)}                         # 32 x 6
    assert launches == expect, (launches, expect)

    toks, actions, logits = out["action_tokens"], out["actions"], out["first_logits"]
    assert toks.shape == (BATCH, ACTION_DIM), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vlm.llm.vocab_size
    assert actions.shape == (BATCH, ACTION_DIM) and torch.isfinite(actions).all()
    assert logits.shape == (BATCH, cfg.vlm.llm.vocab_size) and torch.isfinite(logits).all()

    times = []
    for _ in range(TIMED_CALLS):
        attn.reset_launch_counts()
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
        assert attn.KERNEL_LAUNCHES == expect, attn.KERNEL_LAUNCHES
    p50 = statistics.median(times)
    return launches, dict(
        params=n_params, init_s=init_s, first_call_s=first_s,
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
    print(smi, flush=True)
    log("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    _build.build_all()
    ptxas = {n: [l.strip() for l in out.splitlines() if "registers" in l or "spill" in l]
             for n, out in _build.build_report["logs"].items()}
    log("build", seconds=_build.build_report["seconds"], ptxas=ptxas)

    g = torch.Generator(device=dev).manual_seed(1234)
    kernels = [check_flash_prefill(dev, g), check_vit_attention(dev, g),
               check_decode_attention(dev, g)]
    log("kernels", card=card, results=kernels)

    log("tiny", **check_tiny_path(dev))

    launches, main_stats = run_main_path(dev)
    log("main", card=card, batch=BATCH, launches_per_call=launches, **main_stats)

    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
