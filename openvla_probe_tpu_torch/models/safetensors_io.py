"""A safetensors reader and writer of the port's own (the JAX package reads
checkpoints through the ``safetensors`` package, which the port does not use).

The format is public: an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` with an optional
``"__metadata__"`` of strings, then the raw little-endian bytes, each
tensor's offsets counted from the end of the header.

* `SafetensorsFile` reads one tensor at a time through ``mmap``: a tensor is
  a view of its own mapping of the file's pages (no copy), in the file's
  dtype, and the mapping is closed when the last view of it is dropped, so a
  caller that copies each tensor where it goes and drops it holds one tensor
  at a time on the host, never the file.
* `read_dir` maps every ``*.safetensors`` file of a directory into one lazy
  name -> tensor mapping (the released sharded layout: the index is not
  needed to read).
* `stack` builds a layer-stacked leaf on a device from per-layer tensors,
  one layer on the host at a time (quantized on the way where asked).
* `save_file` writes one file; `save_sharded` splits a state into files of
  at most `max_shard_bytes` with ``model.safetensors.index.json``, as the
  released repositories ship (one file, ``model.safetensors``, where it fits),
  moving one tensor at a time to the host.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Union

import numpy as np
import torch

PathLike = Union[str, Path]

DTYPES: Dict[str, torch.dtype] = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
    "I64": torch.int64, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"


def to_tensor(x: Any) -> torch.Tensor:
    """A tensor, or a numpy array (ml_dtypes bfloat16 included, by its bits)
    as a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class SafetensorsFile:
    """One ``.safetensors`` file: its header on open, each tensor on request."""

    def __init__(self, path: PathLike) -> None:
        self.path = Path(path)
        with open(self.path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self.header: Dict[str, Dict[str, Any]] = header
        self.data_start = 8 + n
        for name, h in header.items():
            if h["dtype"] not in DTYPES:
                raise TypeError(f"{self.path}: {name} has dtype {h['dtype']}, which the "
                                f"reader does not take ({sorted(DTYPES)})")

    def keys(self):
        return self.header.keys()

    def get_tensor(self, name: str) -> torch.Tensor:
        """A CPU tensor of the file's dtype and shape over its own mapping of
        the file (copy-on-write: writing to it never reaches the file)."""
        h = self.header[name]
        dtype, shape = DTYPES[h["dtype"]], tuple(h["shape"])
        begin, end = h["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * torch.empty((), dtype=dtype).element_size()
        if end - begin != nbytes:
            raise ValueError(f"{self.path}: {name} holds {end - begin} bytes, its shape "
                             f"{shape} and dtype {h['dtype']} need {nbytes}")
        if nbytes == 0:
            return torch.empty(shape, dtype=dtype)
        start = self.data_start + begin
        page = start - start % mmap.ALLOCATIONGRANULARITY
        with open(self.path, "rb") as f:
            mm = mmap.mmap(f.fileno(), start + nbytes - page, access=mmap.ACCESS_COPY,
                           offset=page)
        raw = torch.frombuffer(mm, dtype=torch.uint8, count=nbytes, offset=start - page)
        if (start - page) % raw.new_empty((), dtype=dtype).element_size():
            raw = raw.clone()   # an offset off the dtype's alignment: the one copy
        return raw.view(dtype).reshape(shape)


class LazyState(Mapping):
    """name -> tensor over a directory's files, each tensor read (mapped) when
    it is looked up: iterating names reads nothing."""

    def __init__(self, files) -> None:
        self._where: Dict[str, SafetensorsFile] = {}
        for f in files:
            for name in f.keys():
                self._where[name] = f

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name].get_tensor(name)

    def __contains__(self, name) -> bool:   # without reading the tensor
        return name in self._where

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def read_dir(path: PathLike) -> LazyState:
    """Every ``*.safetensors`` file under `path` (sorted), as one lazy state."""
    files = sorted(Path(path).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"No safetensors files under {path}")
    return LazyState([SafetensorsFile(f) for f in files])


def stack(read: Callable[[int], Any], n: int, dtype: torch.dtype, device,
          quantize: Optional[Callable[[torch.Tensor], Dict[str, torch.Tensor]]] = None):
    """One layer-stacked leaf [n, ...] on `device` from the per-layer tensors
    `read(i)`, each moved there and cast to `dtype` one at a time (the host
    holds one layer; the stack is never made on the host). With `quantize`,
    each cast layer is quantized there into the leaf's stacked tensors, so
    the float stack is never made either (per-row quantization: the codes of
    a layer do not depend on the others)."""
    out = None
    for i in range(n):
        w = to_tensor(read(i)).to(device=device, dtype=dtype)
        w = w if quantize is None else quantize(w)
        if out is None:
            out = ({k: torch.empty((n, *v.shape), dtype=v.dtype, device=device)
                    for k, v in w.items()} if isinstance(w, dict)
                   else torch.empty((n, *w.shape), dtype=dtype, device=device))
        if isinstance(w, dict):
            for k, v in w.items():
                out[k][i] = v
        else:
            out[i] = w
    return out


def _host_bytes(t: torch.Tensor, dtype: Optional[torch.dtype]) -> memoryview:
    """The little-endian bytes of `t` in `dtype` (moved to the host first, one
    tensor at a time)."""
    t = t.detach().to("cpu")
    t = (t if dtype is None else t.to(dtype)).contiguous().reshape(-1)
    return memoryview(t.view(torch.uint8).numpy()) if t.numel() else memoryview(b"")


def save_file(tensors: Mapping[str, Any], path: PathLike,
              metadata: Optional[Dict[str, str]] = None,
              dtype: Optional[torch.dtype] = None) -> int:
    """Write `tensors` (torch tensors or numpy arrays, on any device), each
    cast to `dtype` if given, to `path`; returns the bytes of tensor data
    written. The header is padded with spaces to a multiple of 8 bytes, the
    tensors laid out in name order."""
    ts = {k: to_tensor(v) for k, v in tensors.items()}
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in sorted(ts):
        dt = dtype or ts[name].dtype
        if dt not in _NAMES:
            raise TypeError(f"{name}: dtype {dt} has no safetensors name")
        nbytes = ts[name].numel() * torch.empty((), dtype=dt).element_size()
        header[name] = {"dtype": _NAMES[dt], "shape": list(ts[name].shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in sorted(ts):
            f.write(_host_bytes(ts[name], dtype))
    return offset


def save_sharded(state: Mapping[str, Any], out_dir: PathLike,
                 max_shard_bytes: int = 5 << 30, dtype: Optional[torch.dtype] = None) -> Dict:
    """Write `state` as the released repositories do: shards of at most
    `max_shard_bytes` (a tensor larger than that alone), in the state's
    order, named ``model-0000i-of-0000n.safetensors`` with
    ``model.safetensors.index.json`` ({"metadata": {"total_size"},
    "weight_map"}), or one ``model.safetensors`` with no index where it fits.
    Each tensor is cast to `dtype` (if given) on the host as it is written.
    Returns {"files", "total_size", "weight_map"}."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    itemsize = None if dtype is None else torch.empty((), dtype=dtype).element_size()
    plans, cur, cur_bytes = [], [], 0
    for k in state:
        t = to_tensor(state[k])
        nbytes = t.numel() * (itemsize or t.element_size())
        if cur and cur_bytes + nbytes > max_shard_bytes:
            plans.append(cur)
            cur, cur_bytes = [], 0
        cur.append(k)
        cur_bytes += nbytes
    if cur:
        plans.append(cur)
    n = len(plans)
    weight_map, total, files = {}, 0, []
    for i, keys in enumerate(plans, start=1):
        fname = f"model-{i:05d}-of-{n:05d}.safetensors" if n > 1 else "model.safetensors"
        total += save_file({k: state[k] for k in keys}, out_dir / fname, dtype=dtype)
        weight_map.update(dict.fromkeys(keys, fname))
        files.append(fname)
    if n > 1:
        (out_dir / INDEX_FILE).write_text(json.dumps(
            {"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    return {"files": files, "total_size": total, "weight_map": weight_map}
