"""What the port's scripts share: ``--help`` from the config dataclass, and
the device with its kernel libraries ready."""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import List, Optional, Type, TypeVar

from ..conf.registry import parse_config
from ..device import DeviceLike, resolve_device
from ..overwatch import initialize_overwatch

T = TypeVar("T")
overwatch = initialize_overwatch(__name__)
KERNEL_LINE = "kernel libraries: "   # the log line that reports the build or its reuse


def usage(cls: type, doc: Optional[str]) -> str:
    """The script's docstring, then one line a field: flag, type, default."""
    lines = [(doc or "").strip(), "", "options (--field value):"]
    for f in dataclasses.fields(cls):
        tp = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", str(f.type))
        lines.append(f"  --{f.name} {tp.replace('typing.', '')} (default: {f.default!r})")
    return "\n".join(lines)


def parse(cls: Type[T], doc: Optional[str], argv: Optional[List[str]] = None) -> T:
    """`cls` from the command line; ``-h`` / ``--help`` prints `usage` and exits."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if any(a in ("-h", "--help") for a in argv):
        print(usage(cls, doc))
        raise SystemExit(0)
    return parse_config(cls, argv)


def ready_device(device: DeviceLike):
    """`device` resolved (the card unless the caller asked for the CPU); on
    the card the kernel libraries are loaded now, built only when no build
    under the current key exists (ops/_build.py), and one log line reports
    the seconds it took and whether the build was reused."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import _build

        _build.load(next(iter(_build.KERNELS)))
        report = {k: v for k, v in _build.build_report.items() if k != "logs"}
        overwatch.info(KERNEL_LINE + json.dumps(report))
    return dev
