"""Where the time of one OpenVLA-7B serving call goes, on one CUDA card.

    python -m openvla_probe_tpu_torch.tools.profile_main_path
        [--tier parity|pallas|pallas_kv8|turbo] [--weights int8|int4|nibble] [--batch 24]
        [--calls 3] [--entry vla|generate|score_short|score_long|train_int4|train_int8]

Drives the same call as chip_smoke.py (random weights from a seeded
generator: bf16 for the parity tier, TURBO_QUANT_SUFFIXES leaves for the
others, per-channel int8 or, with --weights int4 on the pallas tier, grouped
int4, or, with --weights nibble on the turbo tier, nibble planes for the
trunk; 256x256 uint8 images, prompt_pad_len=32, A=7) and prints JSON lines:

  stages   device time of each stage of predict_action_from_image, each stage
           run alone through the port's own functions (CUDA events, median);
           pallas_kv8 splits its prefill into the trunk and the layer-by-layer
           quantization into the int8 stacked cache
  kernels  torch.profiler device time per call, summed by kernel name and by
           class (cuBLAS GEMM, the port's kernels, elementwise / other),
           beside the host-clock time of the profiled calls; the difference
           is the share of the call the device sits idle

With --entry other than vla it profiles one of the base VLM's entry points
instead (models/generate.py, parity tier, bf16 weights, --batch rows, 8 by
default there, with 224 px dinosiglip pixels made beforehand): generate
(generate_greedy_batch, 64-token prompts, 32 new tokens; stages: towers,
projector, the cached prefill, one decode step), score_short and score_long
(score_continuation_rows over rows of 64 and 832 tokens, T = 320 and 1088;
stages: towers, projector, the uncached 32-layer forward, lm_head, the fp32
log-softmax and gather). ``--entry train_int4`` / ``train_int8`` profiles one
step of tools/bench_finetune.py at OpenVLA-7B width (B = 8 rows of 64 text
tokens by default, streamed LoRA r = 32 over the int4 or int8 base; stages:
the forward alone, forward and backward, the AdamW update, the whole step).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .. import convert
from ..models import generate, llama, vit, vla, vlm
from ..ops.image import ImageTransformConfig, apply_image_transform
from ..ops.linear import TURBO_QUANT_SUFFIXES, matmul_t
from ..training.train_state import apply_updates
from ..training.train_step import value_and_grad
from . import bench_finetune


def _median_ms(fn, reps: int) -> float:
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


def _kernel_class(name: str) -> str:
    n = name.lower()
    if n.startswith("void ovla") or "ovla::" in n or "ovla_" in n:
        return "port kernels (ops/csrc)"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "cublas")):
        return "GEMM (cuBLAS)"
    return "elementwise / reduction / copy"


def device_time(call, calls: int) -> dict:
    """torch.profiler device time per call by kernel name and class, beside
    the host-clock time of the profiled calls."""
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / calls
    by_name, by_class = defaultdict(float), defaultdict(float)
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        # count device-side kernel rows only: aten:: rows repeat their kernels'
        # time, and "Command Buffer Full" is a tracer marker, not a kernel
        if (dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith("aten::") or ev.key == "Command Buffer Full"):
            continue
        by_name[ev.key] += dev_us / 1e3 / calls
        by_class[_kernel_class(ev.key)] += dev_us / 1e3 / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    device_ms = sum(by_class.values())
    return {"device_ms_per_call_by_class": dict(by_class),
            "device_ms_per_call_total": device_ms,
            "host_ms_per_profiled_call": host_ms,
            "device_idle_share": 1.0 - device_ms / host_ms,
            "top_kernels_ms_per_call": [[k[:140], v] for k, v in top]}


def profile_vlm_entry(entry: str, batch: int, calls: int, card: str) -> None:
    """Stages and device time of one call of a base-VLM entry point."""
    dev = torch.device("cuda")
    c = vlm.VLMConfig.openvla_7b()
    g = torch.Generator(device=dev).manual_seed(0)
    params = convert.init_params(c, g, device=dev)
    image = torch.randint(0, 256, (batch, 256, 256, 3), generator=g, device=dev, dtype=torch.uint8)
    pixels = apply_image_transform(image, ImageTransformConfig.dinosiglip_224()).to(c.llm.dtype)
    lm = params["llm"]
    reps = max(3, calls)
    L = {"generate": 64, "score_short": 64, "score_long": 832}[entry]
    ids = torch.randint(1000, 20000, (batch, L), generator=g, device=dev)
    ids[:, 0] = 1
    rows = [(r, L - 8) for r in ids.tolist()]
    mask = torch.ones((batch, L), dtype=torch.int32, device=dev)
    with torch.no_grad():
        feats = vlm.vision_features(params, c, pixels)
        mm = vlm.build_multimodal_inputs(params, c, ids, mask, pixels)
    T = mm["inputs_embeds"].shape[1]
    pos = torch.arange(T, device=dev).expand(batch, T)
    stages = {
        **{f"tower_{name}": lambda i=i, name=name: vit.forward_features(
            params["vision"][name], c.vision[i], pixels[:, 3 * i:3 * i + 3])
           for i, name in enumerate(c.vision_names)},
        "projector": lambda: vlm.project_patches(params, c, feats),
    }
    if entry == "generate":
        S = T + 32
        cache = llama.KVCache.zeros(c.llm, batch, S, device=dev)
        mask_S = torch.nn.functional.pad(mm["attn_mask"], (0, S - T))
        step_valid = (torch.arange(S, device=dev)[None] <= T).int().expand(batch, S)
        e = llama.embed_tokens(lm, ids[:, :1])
        stages["llm_prefill_cached"] = lambda: llama.forward(
            lm, c.llm, mm["inputs_embeds"], mask_S, pos, cache=cache, cache_index=0,
            compute_logits=False)
        stages["llm_decode_step"] = lambda: llama.forward(
            lm, c.llm, e, step_valid, torch.full((batch, 1), T, device=dev), cache=cache,
            cache_index=T)

        def call():
            return generate.generate_greedy_batch(params, c, _NullTok(), ids.tolist(), pixels,
                                                  max_new_tokens=32, device=dev)
    else:
        with torch.no_grad():
            hidden = llama.forward(lm, c.llm, mm["inputs_embeds"], mm["attn_mask"], pos,
                                   compute_logits=False)["last_hidden_state"]
            logits = matmul_t(hidden, lm["lm_head"]).float()
        stages["llm_forward"] = lambda: llama.forward(lm, c.llm, mm["inputs_embeds"],
                                                      mm["attn_mask"], pos, compute_logits=False)
        stages["lm_head"] = lambda: matmul_t(hidden, lm["lm_head"]).float()
        stages["log_softmax_gather"] = lambda: torch.log_softmax(
            logits[:, :-1].float(), dim=-1).gather(-1, ids.new_zeros((batch, T - 1, 1)))

        def call():
            return generate.score_continuation_rows(params, c, rows, pixels, device=dev)
    with torch.no_grad():
        stage_ms = {name: _median_ms(fn, reps) for name, fn in stages.items()}
        stage_ms["whole_call"] = _median_ms(call, reps)
    head = {"card": card, "entry": entry, "batch": batch, "T": T}
    print(json.dumps({**head, "stages_ms": stage_ms}), flush=True)
    print(json.dumps({**head, **device_time(call, calls)}), flush=True)


def profile_train(quant: str, batch: int, calls: int, card: str) -> None:
    """Stages and device time of one train step of tools/bench_finetune.py."""
    ft = bench_finetune.build("full", quant, batch=batch, device="cuda")
    reps = max(3, calls)
    lora, cfg = ft.state.params, ft.cfg

    def forward():
        with torch.no_grad():
            return ft.loss_fn(lora, cfg, ft.batch)

    _, grads = value_and_grad(ft.loss_fn, lora, cfg, ft.batch)

    def update():
        upd, _ = ft.optimizer.update(grads, ft.state.opt_state, lora)
        return apply_updates(lora, upd)

    stage_ms = {"forward_loss": _median_ms(forward, reps),
                "forward_backward": _median_ms(
                    lambda: value_and_grad(ft.loss_fn, lora, cfg, ft.batch), reps),
                "adamw_update": _median_ms(update, reps),
                "whole_step": _median_ms(ft.step, reps)}
    head = {"card": card, "entry": f"train_{quant}", "batch": batch,
            "T": ft.batch["input_ids"].shape[1] + cfg.num_patches}
    print(json.dumps({**head, "stages_ms": stage_ms}), flush=True)
    print(json.dumps({**head, **device_time(ft.step, calls)}), flush=True)


class _NullTok:
    @staticmethod
    def decode(ids, skip_special_tokens=False):
        return ""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tier", choices=("parity", "pallas", "pallas_kv8", "turbo"),
                    default="parity")
    ap.add_argument("--weights", choices=("int8", "int4", "nibble"), default="int8",
                    help="quantized tiers: per-channel int8, grouped int4 (pallas only) or "
                         "nibble (turbo only)")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows of a call: 24 for the VLA call, 8 for the other entries")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--entry", choices=("vla", "generate", "score_short", "score_long",
                                        "train_int4", "train_int8"),
                    default="vla", help="the VLA serving call, a base-VLM entry point, or "
                                        "a train step")
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    if args.entry.startswith("train_"):
        profile_train(args.entry[len("train_"):], args.batch or 8, args.calls, card)
        return
    if args.entry != "vla":
        profile_vlm_entry(args.entry, args.batch or 8, args.calls, card)
        return
    args.batch = args.batch or 24
    cfg = vla.VLAServingConfig.for_tier(vlm.VLMConfig.openvla_7b(), args.tier, prompt_pad_len=32)
    c = cfg.vlm
    g = torch.Generator(device=dev).manual_seed(0)
    if args.weights == "int4" and args.tier != "pallas":
        ap.error("--weights int4 serves through the pallas tier")
    if args.weights == "nibble" and args.tier != "turbo":
        ap.error("--weights nibble serves through the turbo tier")
    bits = {"int8": 8, "int4": 4, "nibble": "nibble"}[args.weights]
    params = convert.init_params(c, g, device=dev, bits=bits,
                                 quant_suffixes=TURBO_QUANT_SUFFIXES if args.tier != "parity" else ())
    B, P = args.batch, cfg.prompt_pad_len
    image = torch.randint(0, 256, (B, 256, 256, 3), generator=g, device=dev, dtype=torch.uint8)
    ids = torch.randint(1000, 20000, (B, P), generator=g, device=dev)
    ids[:, 0] = 1
    ids[:, 25] = vla.EMPTY_TOKEN_ID
    ids[:, 26:] = 0
    plen = torch.full((B,), 26, device=dev)
    q01, q99 = -torch.ones(7, device=dev), torch.ones(7, device=dev)
    mask = torch.tensor([True] * 6 + [False], device=dev)
    img_cfg = ImageTransformConfig.dinosiglip_224()

    def call():
        return vla.predict_action_from_image(params, cfg, image, img_cfg, ids, plen, q01, q99,
                                             mask, device=dev)

    # --- stages, each run alone on the port's functions --------------------------
    pixels = apply_image_transform(image, img_cfg).to(c.llm.dtype)
    feats = vlm.vision_features(params, c, pixels)
    prompt_mask = (torch.arange(P, device=dev)[None] < plen[:, None]).int()
    mm = vlm.build_multimodal_inputs(params, c, ids, prompt_mask, pixels)
    T, S = mm["inputs_embeds"].shape[1], cfg.cache_len
    pos = torch.arange(T, device=dev).expand(B, T)
    e = llama.embed_tokens(params["llm"], ids[:, :1])
    step_pos = torch.full((B, 1), T, device=dev)
    reps = max(3, args.calls)
    extra = {}
    if args.tier in ("parity", "turbo"):     # the stacked-cache decode
        mask_S = torch.nn.functional.pad(mm["attn_mask"], (0, S - T))
        cache = llama.KVCache.zeros(c.llm, B, S, device=dev)
        step_valid = (torch.arange(S, device=dev)[None] <= T).int().expand(B, S)

        def prefill():
            return llama.forward(params["llm"], c.llm, mm["inputs_embeds"], mask_S, pos,
                                 cache=cache, cache_index=0, compute_logits=False,
                                 static_zero_offset=True)

        def decode_step():
            return llama.forward(params["llm"], c.llm, e, step_valid, step_pos, cache=cache,
                                 cache_index=T)
    elif args.tier == "pallas_kv8":
        S8 = -(-S // 32) * 32
        with torch.no_grad():
            kv = llama.prefill(params["llm"], c.llm, mm["inputs_embeds"], mm["attn_mask"], pos)["kv"]
            cq = llama.quantize_prefill_to_stacked(kv, S8)
        step_valid = (torch.arange(S8, device=dev)[None] <= T).int().expand(B, S8).contiguous()

        def prefill():
            return llama.prefill(params["llm"], c.llm, mm["inputs_embeds"], mm["attn_mask"], pos)

        def decode_step():
            return llama.decode_step_stacked_i8(params["llm"], c.llm, e, step_pos, cq, step_valid, T)

        extra["kv8_cache_quantize"] = lambda: llama.quantize_prefill_to_stacked(kv, S8)
    else:
        with torch.no_grad():
            kv = llama.prefill(params["llm"], c.llm, mm["inputs_embeds"], mm["attn_mask"], pos)["kv"]
        dec_shape = (c.llm.num_hidden_layers, B, cfg.action_dim - 1, c.llm.num_key_value_heads,
                     c.llm.head_dim)
        dec_k, dec_v = (torch.zeros(dec_shape, dtype=kv.k.dtype, device=dev) for _ in range(2))

        def prefill():
            return llama.prefill(params["llm"], c.llm, mm["inputs_embeds"], mm["attn_mask"], pos)

        def decode_step():
            return llama.decode_step(params["llm"], c.llm, e, step_pos, kv, mm["attn_mask"],
                                     dec_k, dec_v, 0)

    with torch.no_grad():
        stages = {
            "image_transform": _median_ms(lambda: apply_image_transform(image, img_cfg), reps),
            **{f"tower_{name}": _median_ms(lambda i=i, name=name: vit.forward_features(
                params["vision"][name], c.vision[i], pixels[:, 3 * i:3 * i + 3]), reps)
               for i, name in enumerate(c.vision_names)},
            "projector": _median_ms(lambda: vlm.project_patches(params, c, feats), reps),
            "llm_prefill": _median_ms(prefill, reps),
            **{name: _median_ms(fn, reps) for name, fn in extra.items()},
            "llm_decode_step": _median_ms(decode_step, reps),
            "whole_call": _median_ms(call, reps),
        }
    print(json.dumps({"card": card, "tier": args.tier, "weights": args.weights, "batch": B,
                      "stages_ms": stages}), flush=True)

    # --- device time by kernel over `calls` whole calls -----------------------------
    print(json.dumps({"card": card, "tier": args.tier, "weights": args.weights, "batch": B,
                      **device_time(call, args.calls)}), flush=True)


if __name__ == "__main__":
    main()
