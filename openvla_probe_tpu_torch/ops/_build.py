"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``) for Hopper.

Each source exports plain C launchers and is compiled by its own ``nvcc``
into ``openvla_probe_tpu_torch/_build/lib<source>.so`` (git-ignored), all
sources at once, for ``sm_90a``; the libraries are loaded with ``ctypes``.
Sources that include PyTorch's headers take minutes per build, a plain C
interface a few seconds, and every fresh machine builds anew.

The build happens at the first CUDA launch of any kernel (nothing is built or
loaded at import), so running the port on a card builds everything it needs.

``KERNEL_LAUNCHES`` is the one launch registry: every wrapper adds one to its
kernel's count where it launches it, and nowhere else, so a run can show that
the main path went through the kernels. The int8 GEMMs' launchers start the
activation pre-pass (``quant_rows`` or ``ln_quant_rows`` in
``csrc/int8_mma.cuh``) as a launch of its own before the GEMM; it is counted
under its own name (``PRE_PASSES``). ``fused_mlp_residual`` is two GEMMs
with a pre-pass each: fc1's launch counts as ``fused_mlp_fc1``, fc2's (the
one that makes the output) as ``fused_mlp_residual``.

A kernel wrapper fills an output that autograd knows nothing of, so every
wrapper first calls `no_grad_guard`: under grad mode an input that requires
grad raises, on every device, and the message names the differentiable
route (an STE ``torch.autograd.Function``, or the plain attention).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# kernel name -> (source, C launcher symbol, argtypes)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
KERNELS = {
    "flash_prefill": (
        "flash_prefill.cu", "ovla_flash_prefill",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _I, _I, _I, _P],
    ),
    "flash_prefill_scalar": (
        "flash_prefill.cu", "ovla_flash_prefill_scalar",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _I, _I, _I, _P],
    ),
    "flash_blockwise": (
        "flash_blockwise.cu", "ovla_flash_blockwise",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _I, _I, _I, _P],
    ),
    "vit_attention": (
        "vit_attention.cu", "ovla_vit_attention",
        [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _P],
    ),
    "vit_attention_scalar": (
        "vit_attention.cu", "ovla_vit_attention_scalar",
        [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _I, _P],
    ),
    "decode_attention": (
        "decode_attention.cu", "ovla_decode_attention",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _F, _I, _I, _I, _P],
    ),
    "decode_attention_scalar": (
        "decode_attention.cu", "ovla_decode_attention_scalar",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _F, _I, _I, _I, _P],
    ),
    "wi8_matmul": (
        "wi8_matmul.cu", "ovla_wi8_matmul",
        [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "wi8_matmul_scalar": (
        "wi8_matmul.cu", "ovla_wi8_matmul_scalar",
        [_P, _P, _P, _P, _I, _I, _I, _P],
    ),
    "fused_ln_w8a8": (
        "vit_mlp.cu", "ovla_fused_ln_w8a8",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _I, _P],
    ),
    "fused_mlp_residual": (
        "vit_mlp.cu", "ovla_fused_mlp_residual",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _P, _I, _P],
    ),
    "decode_split_attention": (
        "decode_split_attention.cu", "ovla_decode_split_attention",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
         _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P],
    ),
    "decode_split_attention_scalar": (
        "decode_split_attention.cu", "ovla_decode_split_attention_scalar",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
         _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P],
    ),
    "w4a8_matmul": (
        "w4a8_matmul.cu", "ovla_w4a8_matmul",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "stacked_decode_attention_i8": (
        "stacked_decode_i8.cu", "ovla_stacked_decode_i8",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    "stacked_decode_attention_i8_scalar": (
        "stacked_decode_i8.cu", "ovla_stacked_decode_i8_scalar",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    "w8a8_matmul": (
        "w8a8_matmul.cu", "ovla_w8a8_matmul",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "w4a8_requant": (
        "w8a8_matmul.cu", "ovla_w4a8_requant",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "nib_hi_dot": (
        "nib_hi_dot.cu", "ovla_nib_hi_dot",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "rms_norm_quant": (
        "rmsnorm_quant.cu", "ovla_rms_norm_quant",
        [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    ),
    "w4a8_dx": (
        "w4a8_dx.cu", "ovla_w4a8_dx",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "w4a8_grouped": (
        "w4a8_grouped.cu", "ovla_w4a8_grouped",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "split_attention_i8": (
        "split_attention_i8.cu", "ovla_split_attention_i8",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    ),
    "split_attention_i8_scalar": (
        "split_attention_i8.cu", "ovla_split_attention_i8_scalar",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    ),
}
# GEMM -> the name its activation pre-pass launch is counted under
PRE_PASSES = {"w4a8_matmul": "w4a8_quant_rows", "w8a8_matmul": "w8a8_quant_rows",
              "w4a8_requant": "w4a8_requant_quant_rows", "nib_hi_dot": "nib_hi_quant_rows",
              "w4a8_grouped": "w4a8_grouped_quant_rows",
              "fused_ln_w8a8": "fused_ln_w8a8_quant_rows", "fused_mlp_fc1": "fused_mlp_ln_quant_rows",
              "fused_mlp_residual": "fused_mlp_quant_rows"}
KERNEL_LAUNCHES: Dict[str, int] = {name: 0 for name in (*KERNELS, *PRE_PASSES, *PRE_PASSES.values())}
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}   # source -> loaded library
build_report: Dict[str, object] = {}   # seconds and nvcc/ptxas output of the last build


def no_grad_guard(kernel: str, route: str, *tensors) -> None:
    """Raise where autograd is recording and a floating input of `kernel`
    requires grad: the kernel's output would carry no history, and every
    gradient through it would be dropped without a word. `route` names the
    differentiable way to the same function."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: an input requires grad, and the kernel has no backward "
                           f"of its own: {route}")


def reset_launch_counts() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on tensor `t`'s device, as the launchers
    take it (the raw getter: ``torch.cuda.current_stream`` costs ~7 us of host
    time per call, more than a decode-sized kernel)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): cannot build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_all() -> Dict[str, Path]:
    """Compile every kernel source concurrently (one nvcc each); raise with the
    compiler's output if any fails. Returns source -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs, libs = {}, {}
    for src in sorted({src for src, _, _ in KERNELS.values()}):
        stem = Path(src).stem
        lib = BUILD_DIR / f"lib{stem}.so"
        tmp = BUILD_DIR / f"lib{stem}.{os.getpid()}.tmp.so"
        libs[src] = (lib, tmp)
        procs[src] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs, failed = {}, []
    for name, p in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    for lib, tmp in libs.values():
        os.replace(tmp, lib)
    build_report.update(seconds=time.perf_counter() - t0, logs=logs)
    return {src: lib for src, (lib, _) in libs.items()}


def resource_usage(log: str) -> list:
    """Each entry function's registers a thread and spill bytes from one
    source's ``nvcc -Xptxas=-v`` output (`build_report`): a list of dicts
    (function, the mangled name; registers; spill_stores; spill_loads)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1), "registers": None, "spill_stores": 0,
                   "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building all kernels on first use."""
    with _lock:
        if not _loaded:
            for src, path in build_all().items():
                _loaded[src] = ctypes.CDLL(str(path))
            for src, sym, argtypes in KERNELS.values():
                fn = getattr(_loaded[src], sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        return _loaded[KERNELS[name][0]]


_launchers: Dict[str, object] = {}


def launcher(name: str):
    """The C launcher of kernel `name` (argtypes declared)."""
    fn = _launchers.get(name)
    if fn is None:
        fn = _launchers[name] = getattr(load(name), KERNELS[name][1])
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
