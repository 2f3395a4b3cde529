"""Time kernel builds against each other on one CUDA card, in one process.

    python -m openvla_probe_tpu_torch.tools.kernel_ab --lib parent=DIR [--lib TAG=PATH ...]
        [--kernels flash_prefill,wi8_matmul,w4a8_matmul,flash_blockwise,w4a8_dx,
                   decode_split_attention,decode_attention,w8a8_matmul,nib_hi_dot,
                   fused_ln_w8a8,fused_mlp_residual,w4a8_requant,rms_norm_quant,
                   stacked_decode_attention_i8,split_attention_i8,w4a8_grouped]
        [--shapes MxKxN,...] [--out DIR]

Builds the port's kernels (``ops/_build.py``, tagged ``change``) and every
``--lib`` beside them: ``TAG=DIR`` builds the kernel sources found in DIR (a
copy of another commit's ``ops/csrc``, e.g. unpacked with ``git archive``),
``TAG=FILE.cu`` builds that one file (a variant of a source, e.g. a knock-out
copy with one piece of its work removed: its C launcher keeps its name and
signature). Each build is one ``nvcc`` with the flags of
``_build.NVCC_FLAGS``, all started together, into ``--out``.

For every kernel named in ``--kernels`` and every build that exports its
launcher, at each main-path shape: one launch checked against the plain
version (``w4a8_matmul`` bit for bit; ``flash_prefill`` by
``attention.compare_oneshot`` with its ``oneshot_slack``; ``wi8_matmul`` by ``linear.compare_wi8``;
``flash_blockwise`` by ``attention.compare_blockwise``; ``w4a8_dx`` by
``linear.compare_w4a8_dx`` and bit for bit against the first ``--lib``;
``decode_split_attention`` and ``decode_attention`` at fp32 scores within
2e-2 of the plain version, ``decode_attention`` at bf16 scores by
``attention.compare_bf16_scores``; ``w8a8_matmul`` bit for bit from bf16 x,
from the fused norm's codes (the prequant entry) and through the nibble
loader; ``nib_hi_dot`` bit for bit; ``fused_ln_w8a8`` and
``fused_mlp_residual`` by ``vit_mlp.hold_ln_w8a8`` / ``hold_mlp_residual``,
their codes within one step and their outputs bit-equal on their own codes,
each build timed with the code buffers its wrapper passes; ``w4a8_requant``
bit for bit, a build without that kernel timed on the two-step route it
replaced (the requant in PyTorch, then its ``w8a8_matmul``);
``rms_norm_quant`` by ``rmsnorm_quant.compare_rms_norm_quant``;
``stacked_decode_attention_i8`` within 2e-2 of the plain version, a build
from before its ring route called with its own signature, every slot
read; ``split_attention_i8`` by ``decode_attention.compare_split_attention_i8``
(each build's ``ovla_split_attention_i8``: the ring route, or in an older
build the one-block-a-row kernel);
``w4a8_grouped`` bit for bit, its pre-pass and GEMM also timed apart in the
builds that export them, ``grouped_parts``), then the device
time of one
launch (median of 25, each queued behind a spin kernel, inputs rotated past
the L2) in turns: every build, then every build in reverse order, so that a
drift of the card's clocks shows as a spread between a build's two readings.
The port's own build of the three decode attentions is also timed at 1, 2
and 4 CTAs a (b, h) (``change_ms_by_cluster_size``), beside its cluster
rule.
The checks are reported, not asserted (a knock-out computes another
function). Prints one JSON line per kernel and shape, then one line of
launch-weighted means per kernel (the serving mix and the train mix of
``w4a8_matmul``, the pallas mix of ``wi8_matmul`` and its prefill and decode
routes apart, the serving and score_short launches of ``flash_prefill``, the
turbo, turbo_nibble and train_int8 mixes of ``w8a8_matmul`` with its two
routes apart, the turbo_nibble mix of ``nib_hi_dot``, the pallas mixes of
the two fused tower kernels, the pallas_int4 and train_int4 mixes of
``w4a8_requant``, the turbo mix of ``rms_norm_quant`` and the pallas_kv8 mix
of ``stacked_decode_attention_i8`` (its six decode steps), the turbo_kv8 mix
of ``split_attention_i8`` and the turbo_int4 / turbo_mix mix of
``w4a8_grouped``, as ``chip_smoke.py`` weighs them).
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops import attention as attn
from ..ops import decode_attention as dattn
from ..ops import linear as lin

SPIN_CYCLES = 4_000_000
L2_BYTES = 50e6
LAYERS, BATCH, T_PREFILL, A1 = 32, 24, 288, 6   # A1: decode steps after the prefill (A = 7)
GEN_NEW = 32                                     # generate's new tokens: 31 decode steps
TRAIN_ROWS = 8 * (1 + 256 + 63)


def _ms(fn, reps: int = 25, warmup: int = 3) -> float:
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


def _copies(nbytes: int) -> int:
    return max(1, int(-(-2 * L2_BYTES // nbytes)))


def rotating(fn, arg_sets):
    """`fn` over several copies of its inputs in turn, so that timed launches
    read them from device memory as the main path does, not from L2."""
    it = itertools.cycle(arg_sets)
    return lambda: fn(*next(it))


def build_libs(specs, out: Path) -> dict:
    """tag -> {source name: ctypes.CDLL}: the port's own build under "change",
    then one nvcc per source of every --lib spec, all started together."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = {}
    for spec in specs:
        tag, path = spec.split("=", 1)
        path = Path(path)
        sources = sorted(path.glob("*.cu")) if path.is_dir() else [path]
        for src in sources:
            lib = out / f"lib{tag}_{src.stem}.so"
            jobs[(tag, src.name)] = (lib, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-I", str(src.parent), "-I", str(_build.CSRC), "-o",
                 str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.load("w4a8_matmul")   # builds the port's kernels meanwhile
    libs = {"change": {src: lib for src, lib in _build._loaded.items()}}
    for (tag, name), (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}={name}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(json.dumps({"build": tag, "source": name, "ptxas": regs}), flush=True)
        libs.setdefault(tag, {})[name] = ctypes.CDLL(str(lib))
    return libs


def cluster_launchers(kernel: str, sizes=(1, 2, 4)) -> dict:
    """cs -> the port's ring launcher of `kernel` (``decode_attention``,
    ``decode_split_attention`` or ``stacked_decode_attention_i8``) at `cs` CTAs
    a (b, h) (a (b, kv head) for the last), with the launcher's own
    arguments: its ``_cs`` entry, `cs` passed before the stream. Not counted
    in ``_build.KERNEL_LAUNCHES``: it times the cluster rule against the
    other sizes, beside the main path."""
    _, sym, argtypes = _build.KERNELS[kernel]
    fn = getattr(_build.load(kernel), sym + "_cs")
    fn.argtypes, fn.restype = [*argtypes[:-1], ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    return {cs: (lambda *a, cs=cs: fn(*a[:-1], cs, a[-1])) for cs in sizes}


def launchers(libs: dict, kernel: str) -> dict:
    """tag -> the C launcher of `kernel` in that build (argtypes declared)."""
    source, sym, argtypes = _build.KERNELS[kernel]
    out = {}
    for tag, by_src in libs.items():
        lib = by_src.get(source)
        if lib is None and len(by_src) == 1:   # a single-file variant under another name
            lib = next(iter(by_src.values()))
        fn = getattr(lib, sym, None) if lib is not None else None
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            out[tag] = fn
    return out


def _w4a8(fn, x, q, s):
    M, K = x.shape
    G, N, half = q.shape
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _build.check(fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), codes.data_ptr(),
                    sx.data_ptr(), M, N, K, 2 * half, int(x.dtype == torch.bfloat16),
                    _build.stream_ptr(x)), "w4a8_matmul")
    return out


def _flash(fn, q, k, v, valid, name="flash_blockwise"):
    B, Tq, H, Dh = q.shape
    out = torch.empty_like(q)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), valid.data_ptr(),
                    B, H, Tq, k.shape[1], Dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                    v.stride(0), v.stride(1), attn._scale(Dh), 0, 1, 1, _build.stream_ptr(q)),
                 name)
    return out


def _wi8(fn, x, q, s):
    M, K = x.shape
    out = torch.empty((M, q.shape[0]), dtype=x.dtype, device=x.device)
    _build.check(fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, q.shape[0], K,
                    int(x.dtype == torch.bfloat16), _build.stream_ptr(x)), "wi8_matmul")
    return out


def _checked(compare, got, want) -> dict:
    try:
        return compare(got, want)
    except AssertionError as e:
        return {"refused": str(e)}


def _dx(fn, g, q, s_t):
    M, N = g.shape
    G, _, half = q.shape
    dx = torch.empty((M, G * 2 * half), dtype=g.dtype, device=g.device)
    _build.check(fn(g.data_ptr(), q.data_ptr(), s_t.data_ptr(), dx.data_ptr(), M, N, G, 2 * half,
                    int(g.dtype == torch.bfloat16), _build.stream_ptr(g)), "w4a8_dx")
    return dx


def _turns(fns: dict, make) -> dict:
    """Device ms of every build in turns: forward, then reverse."""
    times = {tag: [] for tag in fns}
    for tag in [*fns, *reversed(list(fns))]:
        times[tag].append(_ms(make(fns[tag])))
    return times


def w4a8_shapes() -> dict:
    """(M, K, N) -> (launches per pallas_int4 call, per train_int4 step)."""
    M_pre, M_dino, M_sig, M_tr = BATCH * T_PREFILL, BATCH * 261, BATCH * 256, TRAIN_ROWS
    call = {(M_dino, 1024, 3072): 23, (M_dino, 1024, 1024): 23, (M_dino, 1024, 4096): 23,
            (M_dino, 4096, 1024): 23, (M_sig, 1152, 3456): 26, (M_sig, 1152, 1152): 26,
            (M_pre, 4096, 4096): 4 * LAYERS, (M_pre, 4096, 11008): 2 * LAYERS,
            (M_pre, 11008, 4096): LAYERS, (BATCH, 4096, 4096): 4 * LAYERS * A1,
            (BATCH, 4096, 11008): 2 * LAYERS * A1, (BATCH, 11008, 4096): LAYERS * A1}
    step = {(M_tr, 4096, 4096): 8 * LAYERS, (M_tr, 4096, 11008): 4 * LAYERS,
            (M_tr, 11008, 4096): LAYERS}
    return {shape: (call.get(shape, 0), step.get(shape, 0)) for shape in {**call, **step}}


def ab_w4a8_matmul(fns, g, dev, shapes=None):
    rows = []
    for (M, K, N), (per_call, per_step) in w4a8_shapes().items():
        if shapes and f"{M}x{K}x{N}" not in shapes:
            continue
        G = K // lin.GROUP_SIZE
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = []
        for _ in range(_copies(N * K // 2)):
            codes = torch.randint(-7, 8, (G, N, lin.GROUP_SIZE), generator=g, device=dev,
                                  dtype=torch.int8)
            s = torch.rand((N, G), generator=g, device=dev) * 2e-3 + 2e-3
            sets.append((x, lin.pack_int4(codes), s))
        want = lin.w4a8_matmul_plain(*sets[0])
        equal = {tag: bool(torch.equal(_w4a8(fn, *sets[0]), want)) for tag, fn in fns.items()}
        rows.append(dict(kernel="w4a8_matmul", shape=f"{M}x{K}x{N}", launches_per_call=per_call,
                         launches_per_step=per_step, bit_equal=equal,
                         ms=_turns(fns, lambda fn: rotating(lambda *a: _w4a8(fn, *a), sets))))
        print(json.dumps(rows[-1]), flush=True)
        del sets, want
    for mix, key in (("serving_mix", "launches_per_call"), ("train_mix", "launches_per_step")):
        n = sum(r[key] for r in rows)
        if n == 0:
            continue
        print(json.dumps({"kernel": "w4a8_matmul", "mix": mix, "ms": {
            tag: sum(statistics.mean(r["ms"][tag]) * r[key] for r in rows) / n for tag in fns}}),
            flush=True)


def wi8_shapes() -> dict:
    """(M, K, N) -> launches per pallas call (pallas_kv8 the same; SigLIP's
    fc2 is pallas_int4's, 26 a call)."""
    M_pre = BATCH * T_PREFILL
    return {(M_pre, 4096, 4096): 4 * LAYERS, (M_pre, 4096, 11008): 2 * LAYERS,
            (M_pre, 11008, 4096): LAYERS, (BATCH, 4096, 4096): 4 * LAYERS * A1,
            (BATCH, 4096, 11008): 2 * LAYERS * A1, (BATCH, 11008, 4096): LAYERS * A1,
            (BATCH, 4096, 32064): 1 + A1, (BATCH * 256, 4304, 1152): 0}


def ab_wi8_matmul(fns, g, dev, shapes=None):
    rows = []
    for (M, K, N), per_call in wi8_shapes().items():
        if shapes and f"{M}x{K}x{N}" not in shapes:
            continue
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = []
        for _ in range(_copies(N * K)):
            q = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8)
            s = torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-3
            sets.append((x, q, s))
        want = lin.wi8_matmul_plain(*sets[0])
        checks = {tag: _checked(lin.compare_wi8, _wi8(fn, *sets[0]), want)
                  for tag, fn in fns.items()}
        rows.append(dict(kernel="wi8_matmul", shape=f"{M}x{K}x{N}", launches_per_call=per_call,
                         route="decode" if M <= 64 else "prefill", check=checks,
                         ms=_turns(fns, lambda fn: rotating(lambda *a: _wi8(fn, *a), sets))))
        print(json.dumps(rows[-1]), flush=True)
        del sets, want
    for mix, keep in (("pallas_mix", lambda r: True),
                      ("pallas_prefill", lambda r: r["route"] == "prefill"),
                      ("pallas_decode", lambda r: r["route"] == "decode")):
        sel = [r for r in rows if keep(r) and r["launches_per_call"]]
        n = sum(r["launches_per_call"] for r in sel)
        if n:
            print(json.dumps({"kernel": "wi8_matmul", "mix": mix, "launches": n, "ms": {
                tag: sum(statistics.mean(r["ms"][tag]) * r["launches_per_call"] for r in sel) / n
                for tag in fns}}), flush=True)


def ab_flash_prefill(fns, g, dev, shapes=None):
    """The serving prefill [24, 288 | 295, 32, 128] (padded prompts, the stacked
    cache's S = T + A keys, query 0 of the last row with every key masked) and
    score_short's [8, 320, 32, 128] (right-padded rows); 32 launches a call each."""
    H, Dh = 32, 128
    for name, (B, T, S, lo) in {"serving": (BATCH, T_PREFILL, T_PREFILL + A1 + 1, 12),
                                "score_short": (8, 320, 320, 31)}.items():
        q = torch.randn((B, T, H, Dh), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, S, H, Dh), generator=g, device=dev).bfloat16() for _ in range(2))
        lens = torch.randint(T - lo, T + 1, (B,), generator=g, device=dev)
        valid = (torch.arange(S, device=dev)[None] < lens[:, None]).int()
        valid[-1, 0] = 0
        want = attn.flash_attention_plain(q, k, v, valid)
        slack = attn.oneshot_slack(q, k, v, valid)
        checks = {tag: _checked(lambda got, w: attn.compare_oneshot(got, w, slack=slack),
                                _flash(fn, q, k, v, valid, "flash_prefill"), want)
                  for tag, fn in fns.items()}
        row = dict(kernel="flash_prefill", shape=f"{B}x{T}|{S}x{H}x{Dh}", path=name,
                   launches_per_call=LAYERS, check=checks,
                   ms=_turns(fns, lambda fn: lambda: _flash(fn, q, k, v, valid, "flash_prefill")))
        print(json.dumps(row), flush=True)
        del q, k, v, want, slack


def ab_flash_blockwise(fns, g, dev, shapes=None):
    B, H, Dh = 8, 32, 128
    for T in (1088, 2048):
        q, k, v = (torch.randn((B, T, H, Dh), generator=g, device=dev).bfloat16() for _ in range(3))
        lens = torch.randint(T - 88, T + 1, (B,), generator=g, device=dev)
        valid = (torch.arange(T, device=dev)[None] < lens[:, None]).int()
        want = attn.flash_attention_blockwise_plain(q, k, v, valid)
        checks = {}
        for tag, fn in fns.items():
            try:
                checks[tag] = attn.compare_blockwise(_flash(fn, q, k, v, valid), want)
            except AssertionError as e:
                checks[tag] = f"refused: {e}"
        row = dict(kernel="flash_blockwise", shape=f"{B}x{T}x{H}x{Dh}", check=checks,
                   ms=_turns(fns, lambda fn: lambda: _flash(fn, q, k, v, valid)))
        print(json.dumps(row), flush=True)
        del q, k, v, want


def ab_w4a8_dx(fns, g, dev, shapes=None):
    M, rows = TRAIN_ROWS, []
    for (N, G), per_step in {(4096, 32): 4 * LAYERS, (11008, 32): 2 * LAYERS,
                             (4096, 86): LAYERS}.items():
        K = G * lin.GROUP_SIZE
        gr = torch.randn((M, N), generator=g, device=dev).bfloat16()
        sets = []
        for _ in range(_copies(N * K // 2)):
            codes = torch.randint(-7, 8, (G, N, lin.GROUP_SIZE), generator=g, device=dev,
                                  dtype=torch.int8)
            s = torch.rand((N, G), generator=g, device=dev) * 2e-3 + 2e-3
            sets.append((gr, lin.pack_int4(codes), s.t().contiguous()))
        want = lin.w4a8_dx_plain(gr, sets[0][1], sets[0][2].t())
        outs = {tag: _dx(fn, *sets[0]) for tag, fn in fns.items()}
        first = next(iter(outs.values()))
        checks = {}
        for tag, got in outs.items():
            try:
                checks[tag] = dict(lin.compare_w4a8_dx(got, want),
                                   bits_equal_first=bool(torch.equal(got, first)))
            except AssertionError as e:
                checks[tag] = f"refused: {e}"
        rows.append(dict(kernel="w4a8_dx", shape=f"{M}x{N}x{K}", launches_per_step=per_step,
                         check=checks,
                         ms=_turns(fns, lambda fn: rotating(lambda *a: _dx(fn, *a), sets))))
        print(json.dumps(rows[-1]), flush=True)
        del sets, outs, want
    n = sum(r["launches_per_step"] for r in rows)
    print(json.dumps({"kernel": "w4a8_dx", "mix": "train_step", "ms": {
        tag: sum(statistics.mean(r["ms"][tag]) * r["launches_per_step"] for r in rows) / n
        for tag in fns}}), flush=True)


def call_decode_split(fn, q, kp, vp, kd, vd, pre, dec):
    """`fn`, a launcher with ``decode_split_attention``'s arguments, on the
    wrapper's tensors."""
    B, _, H, Dh = q.shape
    out = torch.empty_like(q)
    _build.check(fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kd.data_ptr(), vd.data_ptr(),
                    pre.data_ptr(), dec.data_ptr(), out.data_ptr(), B, H, kp.shape[1],
                    kd.shape[1], Dh, q.stride(0), kp.stride(0), kp.stride(1), vp.stride(0),
                    vp.stride(1), kd.stride(0), kd.stride(1), vd.stride(0), vd.stride(1),
                    attn._scale(Dh), int(q.dtype == torch.bfloat16), _build.stream_ptr(q)),
                 "decode_split_attention")
    return out


def call_decode_attention(fn, q, k, v, valid, offset, bf16_scores):
    """`fn`, a launcher with ``decode_attention``'s arguments, on the wrapper's
    tensors."""
    B, _, H, Dh = q.shape
    out = torch.empty_like(q)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), valid.data_ptr(),
                    B, H, k.shape[1], Dh, q.stride(0), k.stride(0), k.stride(1), v.stride(0),
                    v.stride(1), attn._scale(Dh), offset, int(bf16_scores),
                    int(q.dtype == torch.bfloat16), _build.stream_ptr(q)), "decode_attention")
    return out


def _close(got, want) -> dict:
    """The decode attentions' bf16 tolerance (chip_smoke.py's): 2e-2."""
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    return {"max_abs_err": (got.float() - want.float()).abs().max().item()}


def decode_valid(B, T, S, slot, g, dev):
    """Padded prompts of T - 12 .. T tokens, then the generated slots up to
    `slot`: the key validity of a stacked-cache decode step."""
    lens = torch.randint(T - 12, T + 1, (B,), generator=g, device=dev)
    slots = torch.arange(S, device=dev)[None]
    return ((slots < lens[:, None]) | ((slots >= T) & (slots <= slot))).int()


def ab_decode_split_attention(fns, g, dev, shapes=None):
    """The pallas / pallas_int4 frozen-KV decode at step 3: q [24, 1, 32, 128],
    layer slices of stacked kp/vp [24, 288, 32, 128] and kd/vd [24, 6, 32, 128];
    192 launches a call."""
    B, T, A, H, Dh = BATCH, T_PREFILL, A1, 32, 128
    q = torch.randn((B, 1, H, Dh), generator=g, device=dev).bfloat16()
    pre = decode_valid(B, T, T, T, g, dev)
    dec = (torch.arange(A, device=dev) <= 3).int()[None].expand(B, A).contiguous()
    n = max(2, _copies(2 * B * (T + A) * H * Dh * 2))
    kp, vp = (torch.randn((n, B, T, H, Dh), generator=g, device=dev).bfloat16() for _ in range(2))
    kd, vd = (torch.randn((n, B, A, H, Dh), generator=g, device=dev).bfloat16() for _ in range(2))
    sets = [(q, kp[i], vp[i], kd[i], vd[i], pre, dec) for i in range(n)]
    want = dattn.decode_flash_attention_plain(*sets[0])
    row = dict(kernel="decode_split_attention", shape=f"{B}x{T}+{A}x{H}x{Dh}", path="pallas",
               launches_per_call=LAYERS * A1,
               check={tag: _checked(_close, call_decode_split(fn, *sets[0]), want)
                      for tag, fn in fns.items()},
               ms=_turns(fns, lambda fn: rotating(lambda *a: call_decode_split(fn, *a), sets)),
               change_ms_by_cluster_size=_turns(cluster_launchers("decode_split_attention"),
                                                lambda fn: rotating(
                                                    lambda *a: call_decode_split(fn, *a), sets)))
    print(json.dumps(row), flush=True)


def ab_decode_attention(fns, g, dev, shapes=None):
    """The stacked-cache decode: serving [24, 1, 32, 128] over S = 295 at step 3
    (slot 291) in parity's fp32 and turbo's bf16 scores, 192 launches a call
    each; generate's B = 8 over S = 352 (T 320 + 32 new tokens) at its middle
    step (slot 335), fp32 scores, 992 launches a generate call; and generate
    at 1, 2 and 4 rows."""
    H, Dh, rows = 32, 128, []
    for path, (B, T, S, slot, bf16_scores) in {
            "parity": (BATCH, T_PREFILL, T_PREFILL + A1 + 1, T_PREFILL + 3, 0),
            "turbo": (BATCH, T_PREFILL, T_PREFILL + A1 + 1, T_PREFILL + 3, 1),
            "generate": (8, 320, 352, 335, 0),
            # generate at 1, 2 and 4 rows (generate_text's single prompt and up): the
            # shapes that split keys across a cluster
            "generate_1row": (1, 320, 352, 335, 0), "generate_2rows": (2, 320, 352, 335, 0),
            "generate_4rows": (4, 320, 352, 335, 0)}.items():
        q = torch.randn((B, 1, H, Dh), generator=g, device=dev).bfloat16()
        valid = decode_valid(B, T, S, slot, g, dev)
        n = max(2, _copies(2 * B * S * H * Dh * 2))
        k, v = (torch.randn((n, B, S, H, Dh), generator=g, device=dev).bfloat16() for _ in range(2))
        sets = [(q, k[i], v[i], valid, slot, bf16_scores) for i in range(n)]
        sd = torch.bfloat16 if bf16_scores else torch.float32
        want = attn.decode_attention_plain(q, k[0], v[0], valid, slot, sd)
        checks = {}
        for tag, fn in fns.items():
            got = call_decode_attention(fn, *sets[0])
            checks[tag] = _checked(lambda x, w: attn.compare_bf16_scores(
                x, w, attn.decode_attention_plain(q, k[0], v[0], valid, slot, torch.float32)),
                got, want) if bf16_scores else _checked(_close, got, want)
        rows.append(dict(kernel="decode_attention", shape=f"{B}x{S}x{H}x{Dh}", path=path,
                         scores="bf16" if bf16_scores else "fp32",
                         launches_per_call=LAYERS * (GEN_NEW - 1 if path.startswith("generate")
                                                     else A1),
                         check=checks,
                         ms=_turns(fns, lambda fn: rotating(
                             lambda *a: call_decode_attention(fn, *a), sets)),
                         change_ms_by_cluster_size=_turns(
                             cluster_launchers("decode_attention"),
                             lambda fn: rotating(lambda *a: call_decode_attention(fn, *a), sets))))
        print(json.dumps(rows[-1]), flush=True)
        del k, v, sets
    serving = [r for r in rows if r["path"] in ("parity", "turbo")]
    print(json.dumps({"kernel": "decode_attention", "mix": "serving", "ms": {
        tag: statistics.mean(statistics.mean(r["ms"][tag]) for r in serving) for tag in fns}}),
        flush=True)


# the C launcher of row 5 before its ring route: no `n` argument (every slot read)
_STACKED_OLD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def stacked_launchers(libs: dict) -> dict:
    """tag -> (launcher, takes n) of ``stacked_decode_attention_i8`` in each
    build: a build with the scalar route's entry has the ring route's
    signature (the slots up to `n`); an older one reads every slot."""
    out = {}
    for tag, fn in launchers(libs, "stacked_decode_attention_i8").items():
        lib = libs[tag].get("stacked_decode_i8.cu") or next(iter(libs[tag].values()))
        new = getattr(lib, "ovla_stacked_decode_i8_scalar", None) is not None
        if not new:
            fn.argtypes = _STACKED_OLD_ARGTYPES
        out[tag] = (fn, new)
    return out


def call_stacked(fn, q, kq, ks, vq, vs, valid, n):
    """`fn`, a (launcher, takes n) pair of ``stacked_decode_attention_i8``, on one
    layer ([B, S, Hkv·Dh] codes, [B, S, Hkv] scales)."""
    launcher, takes_n = fn
    B, _, H, Dh = q.shape
    S, Hkv = kq.shape[1], ks.shape[2]
    out = torch.empty_like(q)
    head = (q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
            valid.data_ptr(), out.data_ptr(), B, H, Hkv, S, Dh)
    tail = (attn._scale(Dh), int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(launcher(*head, *((n,) if takes_n else ()), *tail),
                 "stacked_decode_attention_i8")
    return out


def ab_stacked_decode_attention_i8(fns, g, dev, shapes=None):
    """The pallas_kv8 decode at each of its six steps: q [24, 1, 32, 128] bf16
    over one layer of the int8 stacked cache, S = 320 slots, the query at slot
    288 + t (a build that takes `n` reads slots [0, 289 + t)), 32 launches a
    step; and one row (a one-observation call: the cluster rule's 4 CTAs) at
    the last step. Each build held to the plain version within 2e-2."""
    H, Dh, S = 32, 128, 320
    rows = []
    for path, (B, steps) in {"pallas_kv8": (BATCH, range(A1)), "one_row": (1, (A1 - 1,))}.items():
        n_sets = max(2, _copies(2 * B * S * H * Dh))
        kq, vq = (torch.randint(-127, 128, (n_sets, B, S, H * Dh), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((n_sets, B, S, H), generator=g, device=dev) * 0.02 + 1e-3
                  for _ in range(2))
        q = torch.randn((B, 1, H, Dh), generator=g, device=dev).bfloat16()
        for t in steps:
            slot = T_PREFILL + t
            valid = decode_valid(B, T_PREFILL, S, slot, g, dev)
            sets = [(q, kq[i], ks[i], vq[i], vs[i], valid, slot + 1) for i in range(n_sets)]
            want = dattn.stacked_decode_attention_i8_plain(q, kq, ks, vq, vs, valid, 0)
            row = dict(kernel="stacked_decode_attention_i8", shape=f"{B}x{S}x{H}x{Dh}",
                       path=path, step=t, keys_read=slot + 1,
                       launches_per_call=LAYERS if path == "pallas_kv8" else 0,
                       check={tag: _checked(_close, call_stacked(fn, *sets[0]), want)
                              for tag, fn in fns.items()},
                       ms=_turns(fns, lambda fn: rotating(lambda *a: call_stacked(fn, *a),
                                                          sets)))
            if path == "one_row":
                row["change_ms_by_cluster_size"] = _turns(
                    {cs: (fn, True) for cs, fn in
                     cluster_launchers("stacked_decode_attention_i8").items()},
                    lambda fn: rotating(lambda *a: call_stacked(fn, *a), sets))
            rows.append(row)
            print(json.dumps(row), flush=True)
        del kq, vq, ks, vs
    serving = [r for r in rows if r["path"] == "pallas_kv8"]
    print(json.dumps({"kernel": "stacked_decode_attention_i8", "mix": "pallas_kv8", "ms": {
        tag: statistics.mean(statistics.mean(r["ms"][tag]) for r in serving) for tag in fns}}),
        flush=True)


def call_w8a8(fn, x, w):
    """`fn`, a launcher with ``w8a8_matmul``'s arguments, on the wrapper's
    operands: x a float [M, K] or a `linear.PrequantActivation`, w an int8 or
    nibble leaf."""
    pre = isinstance(x, lin.PrequantActivation)
    xt = x.q8 if pre else x
    M, K = xt.shape
    N = w["s"].shape[0]
    nib = lin.is_nibble_quant(w)
    if pre:
        codes, sx, dtype = x
    else:
        dtype = x.dtype
        codes = torch.empty((M, K), dtype=torch.int8, device=xt.device)
        sx = torch.empty((M, 1), dtype=torch.float32, device=xt.device)
    out = torch.empty((M, N), dtype=dtype, device=xt.device)
    bf16 = dtype == torch.bfloat16
    _build.check(fn(0 if pre else x.data_ptr(), codes.data_ptr(), sx.data_ptr(),
                    (w["hi"] if nib else w["q"]).data_ptr(), w["lo"].data_ptr() if nib else 0,
                    w["s"].data_ptr(), out.data_ptr(), M, N, K, 0 if pre else (2 if bf16 else 1),
                    int(bf16), _build.stream_ptr(xt)), "w8a8_matmul")
    return out


def call_nib_hi(fn, x, hi, s):
    """`fn`, a launcher with ``nib_hi_dot``'s arguments, on the wrapper's tensors."""
    M, K = x.shape
    N = hi.shape[0]
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    rowsum = torch.empty((M,), dtype=torch.int32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _build.check(fn(x.data_ptr(), hi.data_ptr(), s.data_ptr(), out.data_ptr(), codes.data_ptr(),
                    sx.data_ptr(), rowsum.data_ptr(), M, N, K, int(x.dtype == torch.bfloat16),
                    _build.stream_ptr(x)), "nib_hi_dot")
    return out


def nibble_of(w: dict) -> dict:
    """The nibble planes of an int8 leaf's own codes (hi = floor(q / 16),
    lo = q - 16 hi - 8), exactly as `linear.quantize_weight_nibble` splits them."""
    q = w["q"].to(torch.int32)
    hi = torch.div(q, 16, rounding_mode="floor")
    return {"hi": lin.pack_int4(hi.to(torch.int8)), "lo": lin.pack_int4((q - 16 * hi - 8).to(torch.int8)),
            "s": w["s"]}


def w8a8_shapes() -> dict:
    """(M, K, N) -> launches by entry in a turbo call (``turbo_x``: from bf16
    x with the pre-pass, ``turbo_pre``: on the fused norm's codes), in a
    turbo_nibble call (``nibble_tower``: the towers' int8 linears,
    ``nibble_prefill``: the trunk's nibble planes at prefill M) and in a
    train_int8 step (``train``); the route edge M = 64 / 65 with none."""
    M_pre, M_dino, M_sig, M_tr, L = BATCH * T_PREFILL, BATCH * 261, BATCH * 256, TRAIN_ROWS, LAYERS
    out = {}

    def add(shape, **n):
        row = out.setdefault(shape, dict.fromkeys(
            ("turbo_x", "turbo_pre", "nibble_tower", "nibble_prefill", "train"), 0))
        for k, v in n.items():
            row[k] += v

    for M, (K, N), n in [(M_dino, kn, 23) for kn in ((1024, 3072), (1024, 1024), (1024, 4096),
                                                     (4096, 1024))] + \
                        [(M_sig, kn, 26) for kn in ((1152, 3456), (1152, 1152), (1152, 4304),
                                                    (4304, 1152))]:
        add((M, K, N), turbo_x=n, nibble_tower=n)
    for M, per in ((M_pre, 1), (BATCH, A1)):
        add((M, 4096, 4096), turbo_pre=3 * L * per, turbo_x=L * per)
        add((M, 4096, 11008), turbo_pre=2 * L * per)
        add((M, 11008, 4096), turbo_x=L * per)
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        add((M_pre, K, N), nibble_prefill=L * {4096: 4, 11008: 2}[N] if K == 4096 else L)
    add((BATCH, 4096, 32064), turbo_x=1 + A1)
    add((M_tr, 4096, 4096), train=8 * L)
    add((M_tr, 4096, 11008), train=4 * L)
    add((M_tr, 11008, 4096), train=L)
    add((M_tr, 4096, 32064), train=1)
    add((64, 4096, 4096))
    add((65, 4096, 4096))
    return out


def ab_w8a8_matmul(fns, g, dev, shapes=None):
    """Every (M, K, N) of w8a8_shapes: each entry its shape takes on a main
    path (bf16 x, the prequant codes, the nibble planes) checked bit for bit
    and timed in turns; then the launch-weighted mixes."""
    rows = []
    for (M, K, N), n in w8a8_shapes().items():
        if shapes and f"{M}x{K}x{N}" not in shapes:
            continue
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = [(x, lin.quantize_weight(torch.randn((N, K), generator=g, device=dev) * 0.02))
                for _ in range(_copies(N * K))]
        want = lin.w8a8_matmul_plain(*sets[0])
        entries = {"x": sets}
        if n["turbo_pre"]:
            codes, sx = lin.quantize_rows(x.float())
            entries["prequant"] = [(lin.PrequantActivation(codes, sx, x.dtype), w) for _, w in sets]
        if n["nibble_prefill"] or M == 65:
            entries["nibble"] = [(x, nibble_of(w)) for _, w in sets]
        checks = {e: {tag: bool(torch.equal(call_w8a8(fn, *es[0]), want)) for tag, fn in fns.items()}
                  for e, es in entries.items()}
        rows.append(dict(kernel="w8a8_matmul", shape=f"{M}x{K}x{N}", launches=n,
                         route="decode" if M <= 64 else "wgmma", bit_equal=checks,
                         ms={e: _turns(fns, lambda fn: rotating(lambda *a: call_w8a8(fn, *a), es))
                             for e, es in entries.items()}))
        print(json.dumps(rows[-1]), flush=True)
        del sets, entries, want
    mixes = {"turbo": (("turbo_x", "x"), ("turbo_pre", "prequant")),
             "turbo_nibble": (("nibble_tower", "x"), ("nibble_prefill", "nibble")),
             "train_int8": (("train", "x"),)}
    for mix, parts in mixes.items():
        for route in ("all", "wgmma", "decode"):
            sel = [(r, key, e) for r in rows for key, e in parts
                   if r["launches"][key] and route in ("all", r["route"])]
            n = sum(r["launches"][key] for r, key, _ in sel)
            if n:
                print(json.dumps({"kernel": "w8a8_matmul", "mix": mix, "route": route,
                                  "launches": n, "ms": {
                    tag: sum(statistics.mean(r["ms"][e][tag]) * r["launches"][key]
                             for r, key, e in sel) / n for tag in fns}}), flush=True)


def nib_hi_shapes() -> dict:
    """(M, K, N) -> launches per turbo_nibble call (every decode step's trunk
    linears and lm_head, M = 24); M = 1 and 32 (NIB_HI_M_MAX) with none."""
    L = LAYERS
    return {(BATCH, 4096, 4096): 4 * L * A1, (BATCH, 4096, 11008): 2 * L * A1,
            (BATCH, 11008, 4096): L * A1, (BATCH, 4096, 32064): 1 + A1,
            (1, 4096, 4096): 0, (lin.NIB_HI_M_MAX, 4096, 4096): 0}


def ab_nib_hi_dot(fns, g, dev, shapes=None):
    rows = []
    for (M, K, N), per_call in nib_hi_shapes().items():
        if shapes and f"{M}x{K}x{N}" not in shapes:
            continue
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = []
        for _ in range(_copies(N * K // 2)):
            w = lin.quantize_weight_nibble(torch.randn((N, K), generator=g, device=dev) * 0.02)
            sets.append((x, w["hi"], w["s"]))
        want = lin.nib_hi_dot_plain(*sets[0])
        rows.append(dict(kernel="nib_hi_dot", shape=f"{M}x{K}x{N}", launches_per_call=per_call,
                         bit_equal={tag: bool(torch.equal(call_nib_hi(fn, *sets[0]), want))
                                    for tag, fn in fns.items()},
                         ms=_turns(fns, lambda fn: rotating(lambda *a: call_nib_hi(fn, *a), sets))))
        print(json.dumps(rows[-1]), flush=True)
        del sets, want
    n = sum(r["launches_per_call"] for r in rows)
    if n:
        print(json.dumps({"kernel": "nib_hi_dot", "mix": "turbo_nibble", "launches": n, "ms": {
            tag: sum(statistics.mean(r["ms"][tag]) * r["launches_per_call"] for r in rows) / n
            for tag in fns}}), flush=True)


def ln_w8a8_forms() -> dict:
    """name -> (M, K, N, form, launches per pallas call) of ``fused_ln_w8a8``:
    each tower's qkv entry (LN1 first) and proj exit (residual; DINOv2's
    LayerScale), blocks 0..L-2 (pallas_kv8 the same)."""
    M_dino, M_sig = BATCH * 261, BATCH * 256
    return {"dinov2_qkv": (M_dino, 1024, 3072, "ln", 23),
            "dinov2_proj": (M_dino, 1024, 1024, "res_ls", 23),
            "siglip_qkv": (M_sig, 1152, 3456, "ln", 26), "siglip_proj": (M_sig, 1152, 1152, "res", 26)}


def mlp_towers() -> dict:
    """tower -> (M, D, F, LayerScale, launches per pallas call) of ``fused_mlp_residual``."""
    return {"dinov2": (BATCH * 261, 1024, 4096, True, 23),
            "siglip": (BATCH * 256, 1152, 4304, False, 26)}


def _takes_null_buffers(fn, args) -> bool:
    """Whether a build of a fused tower launcher runs with null code buffers
    (the parent's design kept the codes on chip and wrote them only for a
    probe; the wgmma design needs them): a refused call returns
    cudaErrorInvalidValue and launches nothing."""
    err = fn(*args)
    torch.cuda.synchronize()
    if err not in (0, 1):
        _build.check(err, "fused tower kernel")
    return err == 0


def call_ln_w8a8(fn, x, w, b, ln=None, res=None, ls=None, probe=None, buffers=True):
    """`fn`, a launcher with ``fused_ln_w8a8``'s arguments, on the wrapper's
    tensors; code buffers stored into `probe`, or fresh, or none (null
    pointers) when not `buffers`."""
    M, K = x.shape
    N = w["q"].shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    codes = sx = None
    if probe is not None or buffers:
        codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
        sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
        if probe is not None:
            probe.update(codes=codes, sx=sx)
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (x.data_ptr(), ptr(ln[0] if ln else None), ptr(ln[1] if ln else None),
            w["q"].data_ptr(), w["s"].data_ptr(), b.data_ptr(), ptr(res), ptr(ls), out.data_ptr(),
            M, K, N, 1e-6, ptr(codes), ptr(sx), int(x.dtype == torch.bfloat16),
            _build.stream_ptr(x))
    return out, args


def call_mlp(fn, x, ln_s, ln_b, fc1, b1, fc2, b2, ls2, probe=None, buffers=True):
    """`fn`, a launcher with ``fused_mlp_residual``'s arguments (gelu_tanh),
    on the wrapper's tensors, as `call_ln_w8a8`; g's buffer holds g's codes
    and then fc1's output, as the wrapper allocates it."""
    M, D = x.shape
    F = fc1["q"].shape[0]
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    bufs = [None] * 4
    if probe is not None or buffers:
        g8 = torch.empty(M * F * (1 + x.element_size()), dtype=torch.int8, device=x.device)
        bufs = [torch.empty((M, D), dtype=torch.int8, device=x.device),
                torch.empty((M, 1), device=x.device), g8, torch.empty((M, 1), device=x.device)]
        if probe is not None:
            probe.update(codes1=bufs[0], sx1=bufs[1], codes2=g8[:M * F].view(M, F), sx2=bufs[3])
    args = (x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), fc1["q"].data_ptr(),
            fc1["s"].data_ptr(), b1.data_ptr(), fc2["q"].data_ptr(), fc2["s"].data_ptr(),
            b2.data_ptr(), ls2.data_ptr(), out.data_ptr(), M, D, F, 1e-6, 1,
            *(None if t is None else t.data_ptr() for t in bufs), int(x.dtype == torch.bfloat16),
            _build.stream_ptr(x))
    return out, args


def _run(fn, call, *a, **kw):
    out, args = call(fn, *a, **kw)
    _build.check(fn(*args), "fused tower kernel")
    return out


def _tower_mix(kernel: str, rows, fns) -> None:
    n = sum(r["launches_per_call"] for r in rows)
    if n:
        print(json.dumps({"kernel": kernel, "mix": "pallas", "launches": n, "ms": {
            tag: sum(statistics.mean(r["ms"][tag]) * r["launches_per_call"] for r in rows) / n
            for tag in fns}}), flush=True)


def ab_fused_ln_w8a8(fns, g, dev, shapes=None):
    """Every call form of ``ln_w8a8_forms`` at bf16, each build held by
    ``vit_mlp.hold_ln_w8a8`` (its codes within one step, its output bit-equal
    on its own codes) and timed in turns, each with the buffers its wrapper
    passes; then the launch-weighted pallas mix."""
    from ..ops import vit_mlp as vmlp
    rows = []
    for name, (M, K, N, form, per_call) in ln_w8a8_forms().items():
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        b = (torch.randn((N,), generator=g, device=dev) * 0.1).bfloat16()
        kw = {}
        if form == "ln":
            kw["ln"] = ((1 + 0.1 * torch.randn((K,), generator=g, device=dev)).bfloat16(),
                        (0.1 * torch.randn((K,), generator=g, device=dev)).bfloat16())
        else:
            kw["res"] = torch.randn((M, N), generator=g, device=dev).bfloat16()
            if form == "res_ls":
                kw["ls"] = torch.randn((N,), generator=g, device=dev).bfloat16()
        sets = [(x, lin.quantize_weight(torch.randn((N, K), generator=g, device=dev) * 0.02), b)
                for _ in range(_copies(N * K))]
        checks, buffers = {}, {}
        for tag, fn in fns.items():
            buffers[tag] = not _takes_null_buffers(fn, call_ln_w8a8(fn, *sets[0], **kw,
                                                                     buffers=False)[1])
            probe: dict = {}
            got = _run(fn, call_ln_w8a8, *sets[0], **kw, probe=probe)
            checks[tag] = _checked(lambda o, p: vmlp.hold_ln_w8a8(o, p, *sets[0], **kw), got, probe)
        rows.append(dict(kernel="fused_ln_w8a8", shape=f"{M}x{K}x{N}", form=name,
                         launches_per_call=per_call, check=checks, buffers=buffers,
                         ms=_turns(fns, lambda fn: rotating(
                             lambda *a: _run(fn, call_ln_w8a8, *a, **kw,
                                             buffers=buffers[_tag_of(fns, fn)]), sets))))
        print(json.dumps(rows[-1]), flush=True)
        del sets
    _tower_mix("fused_ln_w8a8", rows, fns)


def _tag_of(fns: dict, fn) -> str:
    return next(tag for tag, f in fns.items() if f is fn)


def ab_fused_mlp_residual(fns, g, dev, shapes=None):
    """Both towers' MLP halves of ``mlp_towers`` at bf16 (gelu_tanh), each
    build held by ``vit_mlp.hold_mlp_residual`` and timed in turns as
    `ab_fused_ln_w8a8`; then the launch-weighted pallas mix."""
    from ..ops import vit_mlp as vmlp
    rows = []
    for name, (M, D, F, layerscale, per_call) in mlp_towers().items():
        bf = lambda t: t.bfloat16()
        x = bf(torch.randn((M, D), generator=g, device=dev))
        ln = (bf(1 + 0.1 * torch.randn((D,), generator=g, device=dev)),
              bf(0.1 * torch.randn((D,), generator=g, device=dev)))
        b1 = bf(0.1 * torch.randn((F,), generator=g, device=dev))
        b2 = bf(0.1 * torch.randn((D,), generator=g, device=dev))
        ls2 = bf(torch.randn((D,), generator=g, device=dev)) if layerscale else \
            torch.ones((D,), dtype=torch.bfloat16, device=dev)
        sets = []
        for _ in range(_copies(2 * F * D)):
            fc1 = lin.quantize_weight(torch.randn((F, D), generator=g, device=dev) * 0.02)
            fc2 = lin.quantize_weight(torch.randn((D, F), generator=g, device=dev) * 0.02)
            sets.append((x, *ln, fc1, b1, fc2, b2, ls2))
        checks, buffers = {}, {}
        for tag, fn in fns.items():
            buffers[tag] = not _takes_null_buffers(fn, call_mlp(fn, *sets[0], buffers=False)[1])
            probe: dict = {}
            got = _run(fn, call_mlp, *sets[0], probe=probe)
            checks[tag] = _checked(lambda o, p: vmlp.hold_mlp_residual(o, p, *sets[0]), got, probe)
        rows.append(dict(kernel="fused_mlp_residual", shape=f"{M}x{D}x{F}", form=name,
                         launches_per_call=per_call, check=checks, buffers=buffers,
                         ms=_turns(fns, lambda fn: rotating(
                             lambda *a: _run(fn, call_mlp, *a, buffers=buffers[_tag_of(fns, fn)]),
                             sets))))
        print(json.dumps(rows[-1]), flush=True)
        del sets
    _tower_mix("fused_mlp_residual", rows, fns)


def call_requant(fn, x, q, s):
    """`fn`, a launcher with ``w4a8_requant``'s arguments, on the wrapper's tensors."""
    M, K = x.shape
    G, N, half = q.shape
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _build.check(fn(x.data_ptr(), codes.data_ptr(), sx.data_ptr(), q.data_ptr(), s.data_ptr(),
                    out.data_ptr(), M, N, G, 2 * half, int(x.dtype == torch.bfloat16),
                    _build.stream_ptr(x)), "w4a8_requant")
    return out


def requant_routes(libs: dict) -> dict:
    """tag -> the int4 requant route of that build, called as (x, q, s): its
    ``w4a8_requant`` kernel where it exports one, else the two-step route
    before it (the requant in PyTorch, then the build's ``w8a8_matmul``)."""
    kernel, two_step = launchers(libs, "w4a8_requant"), launchers(libs, "w8a8_matmul")
    out = {}
    for tag in libs:
        if tag in kernel:
            out[tag] = lambda x, q, s, fn=kernel[tag]: call_requant(fn, x, q, s)
        elif tag in two_step:
            out[tag] = lambda x, q, s, fn=two_step[tag]: call_w8a8(
                fn, x, dict(zip(("q", "s"), lin.requant_int4_to_int8(q, s))))
    return out


def requant_shapes() -> dict:
    """(M, K, N) -> (launches per pallas_int4 call, per train_int4 step) of
    the requant route: lm_head at decode, SigLIP's fc1, lm_head in a step."""
    return {(BATCH, 4096, 32064): (1 + A1, 0), (BATCH * 256, 1152, 4304): (26, 0),
            (TRAIN_ROWS, 4096, 32064): (0, 1)}


def ab_w4a8_requant(routes, g, dev, shapes=None):
    """Every shape of requant_shapes, each build's route (`requant_routes`)
    bit for bit against the plain version and timed in turns; then the
    pallas_int4 mix and the train_int4 step's."""
    rows = []
    for (M, K, N), (per_call, per_step) in requant_shapes().items():
        if shapes and f"{M}x{K}x{N}" not in shapes:
            continue
        G = K // lin.GROUP_SIZE
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = []
        for _ in range(_copies(N * K // 2)):
            codes = torch.randint(-8, 8, (G, N, lin.GROUP_SIZE), generator=g, device=dev,
                                  dtype=torch.int8)
            s = torch.rand((N, G), generator=g, device=dev) * 2e-3 + 2e-3
            sets.append((x, lin.pack_int4(codes), s))
        want = lin.w4a8_requant_plain(*sets[0])
        rows.append(dict(kernel="w4a8_requant", shape=f"{M}x{K}x{N}", launches_per_call=per_call,
                         launches_per_step=per_step,
                         bit_equal={tag: bool(torch.equal(fn(*sets[0]), want))
                                    for tag, fn in routes.items()},
                         ms=_turns(routes, lambda fn: rotating(fn, sets))))
        print(json.dumps(rows[-1]), flush=True)
        del sets, want
    for mix, key in (("pallas_int4", "launches_per_call"), ("train_int4", "launches_per_step")):
        n = sum(r[key] for r in rows)
        if n:
            print(json.dumps({"kernel": "w4a8_requant", "mix": mix, "launches": n, "ms": {
                tag: sum(statistics.mean(r["ms"][tag]) * r[key] for r in rows) / n
                for tag in routes}}), flush=True)


def call_rmsq(fn, x, w, eps=1e-5):
    """`fn`, a launcher with ``rms_norm_quant``'s arguments: (codes, scales)."""
    M, D = x.shape
    codes = torch.empty((M, D), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    _build.check(fn(x.data_ptr(), w.data_ptr(), codes.data_ptr(), sx.data_ptr(), M, D, eps,
                    int(x.dtype == torch.bfloat16), _build.stream_ptr(x)), "rms_norm_quant")
    return codes, sx


def ab_rms_norm_quant(fns, g, dev, shapes=None):
    """turbo's two shapes, x bf16 [M, 4096]: M = 6912 (prefill, 64 launches a
    call) and 24 (decode steps, 384); each build held to the plain version by
    `rmsnorm_quant.compare_rms_norm_quant` (reported) and timed in turns; then
    the launch-weighted turbo mix."""
    from ..ops import rmsnorm_quant as rmsq

    rows = []
    for M, per_call in ((BATCH * T_PREFILL, 2 * LAYERS), (BATCH, 2 * LAYERS * A1)):
        if shapes and f"{M}x4096" not in shapes:
            continue
        w = (1 + 0.2 * torch.randn((4096,), generator=g, device=dev)).bfloat16()
        sets = [((torch.randn((M, 4096), generator=g, device=dev) * 2).bfloat16(), w)
                for _ in range(_copies(M * 4096 * 3))]
        want = rmsq.rms_norm_quant_plain(*sets[0], 1e-5)
        rows.append(dict(kernel="rms_norm_quant", shape=f"{M}x4096", launches_per_call=per_call,
                         held={tag: _checked(lambda got, ref: rmsq.compare_rms_norm_quant(
                             sets[0][0], w, 1e-5, got, ref), call_rmsq(fn, *sets[0]), want)
                               for tag, fn in fns.items()},
                         ms=_turns(fns, lambda fn: rotating(lambda *a: call_rmsq(fn, *a), sets))))
        print(json.dumps(rows[-1]), flush=True)
        del sets, want
    n = sum(r["launches_per_call"] for r in rows)
    if n:
        print(json.dumps({"kernel": "rms_norm_quant", "mix": "turbo", "launches": n, "ms": {
            tag: sum(statistics.mean(r["ms"][tag]) * r["launches_per_call"] for r in rows) / n
            for tag in fns}}), flush=True)


def call_split_i8(fn, q, kq, ks, vq, vs, kd, vd, pre, dec, scores=torch.bfloat16):
    B, _, H, Dh = q.shape
    T, Hkv, A = kq.shape[1], kq.shape[2], kd.shape[1]
    out = torch.empty_like(q)
    _build.check(fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                    kd.data_ptr(), vd.data_ptr(), pre.data_ptr(), dec.data_ptr(), out.data_ptr(),
                    B, H, Hkv, T, A, Dh, attn._scale(Dh), int(q.dtype == torch.bfloat16),
                    int(scores == torch.bfloat16), _build.stream_ptr(q)), "split_attention_i8")
    return out


def split_i8_sets(B, T, A, step, H, Hkv, Dh, g, dev, copies, dtype=torch.bfloat16):
    """`copies` turbo_kv8 decode-step inputs: int8 prefill K/V [B, T, Hkv, Dh] and
    scales (quantized from normal draws by llama.quantize_prefill_kv), q and
    generated K/V [B, A, Hkv, Dh] in `dtype`, padded prompts of T - 12 .. T
    tokens, the generated slots up to `step`."""
    from ..models import llama

    kv = llama.quantize_prefill_kv(llama.PrefillKV(
        *(torch.randn((copies, B, T, Hkv, Dh), generator=g, device=dev).to(dtype)
          for _ in range(2))))
    kd, vd = (torch.randn((copies, B, A, Hkv, Dh), generator=g, device=dev).to(dtype)
              for _ in range(2))
    q = torch.randn((B, 1, H, Dh), generator=g, device=dev).to(dtype)
    mm_len = torch.randint(T - 12, T + 1, (B,), generator=g, device=dev)
    pre = (torch.arange(T, device=dev)[None] < mm_len[:, None]).int()
    dec = (torch.arange(A, device=dev) <= step).int()[None].expand(B, A).contiguous()
    return [(q, kv.k[i], kv.ks[i], kv.v[i], kv.vs[i], kd[i], vd[i], pre, dec)
            for i in range(copies)]


def ab_split_attention_i8(fns, g, dev, shapes=None):
    """The turbo_kv8 decode attention at the 7B serving shape, decode step 3
    (192 launches a call), bf16 scores; and at one row (a one-observation
    call), where the port's build is also timed at 1, 2 and 4 CTAs a (b, kv
    head) beside its cluster rule."""
    for shape, B in (("serving", BATCH), ("one_row", 1)):
        sets = split_i8_sets(B, T_PREFILL, A1, 3, 32, 32, 128, g, dev,
                             _copies(2 * B * T_PREFILL * 4096))
        row = dict(kernel="split_attention_i8", shape=shape,
                   launches_per_call=LAYERS * A1 if B == BATCH else 0,
                   checks={tag: _checked(lambda got, _: dattn.compare_split_attention_i8(
                       got, *sets[0], torch.bfloat16), call_split_i8(fn, *sets[0]), None)
                       for tag, fn in fns.items()},
                   ms=_turns(fns, lambda fn: rotating(lambda *a: call_split_i8(fn, *a), sets)))
        if B == 1:
            row["change_ms_by_cluster_size"] = _turns(
                cluster_launchers("split_attention_i8"),
                lambda fn: rotating(lambda *a: call_split_i8(fn, *a), sets))
        print(json.dumps(row), flush=True)


def call_grouped(fn, x, q, s):
    M, K = x.shape
    G, N, half = q.shape
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _build.check(fn(x.data_ptr(), codes.data_ptr(), sx.data_ptr(), q.data_ptr(), s.data_ptr(),
                    out.data_ptr(), M, N, G, 2 * half, int(x.dtype == torch.bfloat16),
                    _build.stream_ptr(x)), "w4a8_grouped")
    return out


def grouped_parts(lib):
    """The pre-pass and the GEMM of `lib`'s w4a8_grouped build as two
    launchers (``ovla_w4a8_grouped_quant_rows``, ``ovla_w4a8_grouped_gemm``,
    uncounted: they time the two launches of a call apart), or None where the
    build has no such entries (an older one)."""
    pre, gemm = (getattr(lib, sym, None)
                 for sym in ("ovla_w4a8_grouped_quant_rows", "ovla_w4a8_grouped_gemm"))
    if pre is None or gemm is None:
        return None
    _P, _I = ctypes.c_void_p, ctypes.c_int
    pre.argtypes, pre.restype = [_P, _P, _P, _I, _I, _I, _P], _I
    gemm.argtypes, gemm.restype = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I
    return pre, gemm


def call_grouped_prepass(fn, x):
    """The pre-pass alone: (codes, s_x) of x."""
    M, K = x.shape
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    _build.check(fn(x.data_ptr(), codes.data_ptr(), sx.data_ptr(), M, K,
                    int(x.dtype == torch.bfloat16), _build.stream_ptr(x)), "w4a8_grouped")
    return codes, sx, x.dtype


def call_grouped_gemm(fn, pre, q, s):
    """The GEMM alone on the pre-pass's (codes, s_x, x's dtype)."""
    codes, sx, dtype = pre
    M = codes.shape[0]
    G, N, half = q.shape
    out = torch.empty((M, N), dtype=dtype, device=codes.device)
    _build.check(fn(codes.data_ptr(), sx.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                    M, N, G, 2 * half, int(dtype == torch.bfloat16), _build.stream_ptr(codes)),
                 "w4a8_grouped")
    return out


def ab_w4a8_grouped(fns, g, dev, shapes=None, libs=None):
    """The grouped decode product at the turbo_int4 / turbo_mix shapes (M = 24),
    beside nib_hi_dot on the same shapes (the split-K decode core over a 4-bit
    plane, the port's own build) as a yardstick; for the builds of `libs`
    that export them, the pre-pass and the GEMM timed apart."""
    rows = []
    for (M, K, N), per_call in nib_hi_shapes().items():
        if per_call == 0 or (shapes and f"{M}x{K}x{N}" not in shapes):
            continue
        G = K // lin.GROUP_SIZE
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        sets = [(x, lin.pack_int4(torch.randint(-8, 8, (G, N, lin.GROUP_SIZE), generator=g,
                                                device=dev, dtype=torch.int8)),
                 torch.rand((N, G), generator=g, device=dev) * 2e-3 + 2e-3)
                for _ in range(_copies(N * K // 2))]
        want = lin.w4a8_grouped_plain(*sets[0])
        failed = {}
        for tag, fn in list(fns.items()):   # a build whose launch fails is reported, not timed
            try:
                call_grouped(fn, *sets[0])
                torch.cuda.synchronize()
            except RuntimeError as e:
                failed[tag] = str(e)
                del fns[tag]
        nib = [(x, *(lambda w: (w["hi"], w["s"]))(lin.quantize_weight_nibble(
            torch.randn((N, K), generator=g, device=dev) * 0.02))) for _ in range(2)]
        parts = {tag: p for tag, by_src in (libs or {}).items() if tag in fns
                 and (p := grouped_parts(by_src.get("w4a8_grouped.cu"))) is not None}
        rows.append(dict(kernel="w4a8_grouped", shape=f"{M}x{K}x{N}", launches_per_call=per_call,
                         bit_equal={tag: bool(torch.equal(call_grouped(fn, *sets[0]), want))
                                    for tag, fn in fns.items()},
                         ms=_turns(fns, lambda fn: rotating(lambda *a: call_grouped(fn, *a),
                                                            sets)),
                         prepass_ms={tag: _ms(lambda p=p: call_grouped_prepass(p[0], x))
                                     for tag, p in parts.items()},
                         gemm_ms={tag: _ms(rotating(lambda *a, p=p: call_grouped_gemm(p[1], *a), [
                             (call_grouped_prepass(p[0], x), q, s) for _, q, s in sets]))
                             for tag, p in parts.items()},
                         nib_hi_dot_ms=_ms(rotating(lin.nib_hi_dot, nib)), failed=failed))
        print(json.dumps(rows[-1]), flush=True)
        del sets, want, nib
    n = sum(r["launches_per_call"] for r in rows)
    if n:
        print(json.dumps({"kernel": "w4a8_grouped", "mix": "turbo_int4", "launches": n, "ms": {
            tag: sum(statistics.mean(r["ms"][tag]) * r["launches_per_call"] for r in rows) / n
            for tag in fns}}), flush=True)


AB = {"flash_prefill": ab_flash_prefill, "wi8_matmul": ab_wi8_matmul,
      "w4a8_matmul": ab_w4a8_matmul, "flash_blockwise": ab_flash_blockwise,
      "w4a8_dx": ab_w4a8_dx, "decode_split_attention": ab_decode_split_attention,
      "decode_attention": ab_decode_attention, "w8a8_matmul": ab_w8a8_matmul,
      "nib_hi_dot": ab_nib_hi_dot, "fused_ln_w8a8": ab_fused_ln_w8a8,
      "fused_mlp_residual": ab_fused_mlp_residual, "w4a8_requant": ab_w4a8_requant,
      "rms_norm_quant": ab_rms_norm_quant,
      "stacked_decode_attention_i8": ab_stacked_decode_attention_i8,
      "split_attention_i8": ab_split_attention_i8, "w4a8_grouped": ab_w4a8_grouped}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", action="append", default=[], help="TAG=DIR or TAG=FILE.cu")
    ap.add_argument("--kernels", default=",".join(AB))
    ap.add_argument("--shapes", default="",
                    help="w4a8_matmul / wi8_matmul / w8a8_matmul / nib_hi_dot / w4a8_requant "
                         "MxKxN (rms_norm_quant MxD) shapes to time (all)")
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "kernel_ab"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    libs = build_libs(args.lib, Path(args.out))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    for name in args.kernels.split(","):
        fns = (requant_routes(libs) if name == "w4a8_requant" else
               stacked_launchers(libs) if name == "stacked_decode_attention_i8" else
               launchers(libs, name))
        order = [tag for tag in [*[s.split("=", 1)[0] for s in args.lib], "change"] if tag in fns]
        AB[name]({tag: fns[tag] for tag in order}, g, dev,
                 shapes=set(filter(None, args.shapes.split(","))),
                 **({"libs": libs} if name == "w4a8_grouped" else {}))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    raise SystemExit(main())
