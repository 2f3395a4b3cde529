"""Dataclass config system: choice registries + dotted-path CLI overrides.

Stands in for draccus (not available here) with the same ergonomics the
reference relies on (prismatic/conf/*, @draccus.wrap entry points): configs
are nested dataclasses; named experiment variants register into a
ChoiceRegistry and are selected with `--x.type <id>`; any leaf field is
overridable with `--a.b.c value` syntax.
"""

from __future__ import annotations

import dataclasses
import sys
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Type, TypeVar, Union, get_args, get_origin

T = TypeVar("T")


class ChoiceRegistry:
    """Base for config families with named variants (draccus-compatible API)."""

    _registry: Dict[str, Dict[str, type]] = {}

    @classmethod
    def register_subclass(cls, name: str, subclass: Optional[type] = None):
        base = cls.__name__

        def do_register(sub):
            ChoiceRegistry._registry.setdefault(base, {})[name] = sub
            sub._choice_name = name
            return sub

        return do_register(subclass) if subclass is not None else do_register

    @classmethod
    def get_choice_class(cls, name: str) -> type:
        choices = ChoiceRegistry._registry.get(cls.__name__, {})
        if name not in choices:
            raise KeyError(f"Unknown {cls.__name__} choice `{name}`; have {sorted(choices)}")
        return choices[name]

    @classmethod
    def get_choice_names(cls) -> List[str]:
        return sorted(ChoiceRegistry._registry.get(cls.__name__, {}))

    @property
    def choice_name(self) -> str:
        return getattr(type(self), "_choice_name", type(self).__name__)


def _convert(value: str, annotation: Any) -> Any:
    origin = get_origin(annotation)
    if origin is Union:
        args = [a for a in get_args(annotation) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        # try each member in declared order: Union[int, str] fields (e.g.
        # quantization bits 8|4|"mix"|"nibble") take the int parse when the
        # value is numeric and fall through to the string form otherwise
        for a in args[:-1]:
            try:
                return _convert(value, a)
            except (ValueError, KeyError):
                continue
        return _convert(value, args[-1])
    if annotation is bool or (isinstance(value, str) and annotation is Any and value.lower() in ("true", "false")):
        return value.lower() in ("true", "1", "yes")
    if annotation is int:
        return int(value)
    if annotation is float:
        return float(value)
    if isinstance(annotation, type) and issubclass(annotation, Enum):
        try:
            return annotation(value)
        except ValueError:
            return annotation[value]
    if origin in (list, tuple, Sequence):
        inner = get_args(annotation)[0] if get_args(annotation) else str
        items = [v for v in value.split(",") if v]
        seq = [_convert(v, inner) for v in items]
        return tuple(seq) if origin is tuple else seq
    return value


def _set_dotted(obj: Any, path: List[str], value: str) -> Any:
    """Immutably set a dotted field on nested (frozen) dataclasses."""
    field_name = path[0]
    fields = {f.name: f for f in dataclasses.fields(obj)}
    if field_name not in fields:
        raise KeyError(f"{type(obj).__name__} has no field `{field_name}`")
    if len(path) == 1:
        new_value = _convert(value, fields[field_name].type_resolved
                             if hasattr(fields[field_name], "type_resolved")
                             else _resolve_type(obj, field_name))
        return dataclasses.replace(obj, **{field_name: new_value})
    child = getattr(obj, field_name)
    return dataclasses.replace(obj, **{field_name: _set_dotted(child, path[1:], value)})


def _resolve_type(obj: Any, field_name: str) -> Any:
    import typing

    hints = typing.get_type_hints(type(obj))
    return hints.get(field_name, str)


def parse_config(cls: Type[T], argv: Optional[List[str]] = None) -> T:
    """Build `cls()` then apply `--a.b.c value` overrides from argv.

    `--x.type <name>` on a ChoiceRegistry-typed field swaps in the registered
    variant (applied before other overrides on that subtree).
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    pairs: List[tuple] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"Expected --key, got `{tok}`")
        key = tok[2:]
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"Missing value for --{key}")
            value = argv[i + 1]
            i += 2
        pairs.append((key, value))

    # first pass: .type choice swaps (outermost first)
    type_pairs = sorted([p for p in pairs if p[0].endswith(".type") or p[0] == "type"],
                        key=lambda p: p[0].count("."))
    other_pairs = [p for p in pairs if not (p[0].endswith(".type") or p[0] == "type")]

    cfg = cls()
    for key, value in type_pairs:
        path = key.split(".")[:-1]
        if not path:  # --type on the root
            cfg = cls.get_choice_class(value)()
            continue
        parent = cfg
        for name in path[:-1]:
            parent = getattr(parent, name)
        field_obj = getattr(parent, path[-1])
        variant = type(field_obj).get_choice_class(value)()
        cfg = _replace_path(cfg, path, variant)
    for key, value in other_pairs:
        cfg = _set_dotted(cfg, key.split("."), value)
    return cfg


def _replace_path(obj: Any, path: List[str], value: Any) -> Any:
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    child = getattr(obj, path[0])
    return dataclasses.replace(obj, **{path[0]: _replace_path(child, path[1:], value)})


def wrap(cls: Type[T]):
    """@wrap(Config) decorator: parse CLI into Config and call fn(cfg) — the
    draccus.wrap() entry-point idiom."""

    def decorator(fn):
        def main():
            fn(parse_config(cls))

        main.__wrapped_config__ = cls
        main.inner = fn
        return main

    return decorator
