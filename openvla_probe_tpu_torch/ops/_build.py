"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``) for Hopper.

Each source exports a plain C launcher and is compiled by its own ``nvcc``
into ``openvla_probe_tpu_torch/_build/lib<name>.so`` (git-ignored), all
sources at once, for ``sm_90a``; the libraries are loaded with ``ctypes``.
Sources that include PyTorch's headers take minutes per build, a plain C
interface a few seconds, and every fresh machine builds anew.

The build happens at the first CUDA launch of any kernel (nothing is built or
loaded at import), so running the port on a card builds everything it needs.
"""

from __future__ import annotations

import ctypes
import os
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
    "vit_attention": (
        "vit_attention.cu", "ovla_vit_attention",
        [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _I, _P],
    ),
    "decode_attention": (
        "decode_attention.cu", "ovla_decode_attention",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _F, _I, _I, _P],
    ),
}
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_report: Dict[str, object] = {}   # seconds and nvcc/ptxas output of the last build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): cannot build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_all() -> Dict[str, Path]:
    """Compile every kernel source concurrently (one nvcc each); raise with the
    compiler's output if any fails. Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs, libs = {}, {}
    for name, (src, _, _) in KERNELS.items():
        lib = BUILD_DIR / f"lib{name}.so"
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        libs[name] = (lib, tmp)
        procs[name] = subprocess.Popen(
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
    return {name: lib for name, (lib, _) in libs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building all kernels on first use."""
    with _lock:
        if not _loaded:
            for n, path in build_all().items():
                lib = ctypes.CDLL(str(path))
                _, sym, argtypes = KERNELS[n]
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _loaded[n] = lib
        return _loaded[name]


def launcher(name: str):
    """The C launcher of kernel `name` (argtypes declared)."""
    return getattr(load(name), KERNELS[name][1])


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
