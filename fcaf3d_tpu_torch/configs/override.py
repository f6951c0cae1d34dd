"""Generic `--set key=value` deep overrides for dataclass configs: a copy
of `fcaf3d_tpu/configs/override.py`, held equal to it by a test.

The reference's `--cfg-options` nested dict-merge: CLI strings are parsed
into typed values and applied to (possibly nested, frozen) dataclasses via
`dataclasses.replace`. Dotted keys descend into nested dataclass fields;
values are parsed with `ast.literal_eval` first (numbers, tuples, booleans,
quoted strings) and fall back to plain strings, then coerced to the
declared field type where the parse is ambiguous (e.g. `lr=1` -> 1.0 for a
float field, `lr_steps=8,11` -> (8, 11)).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Any, Sequence


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        pass
    if "," in text:  # bare tuples: `lr_steps=8,11`
        try:
            return ast.literal_eval("(" + text + ")")
        except (ValueError, SyntaxError):
            pass
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    return text


def _coerce(value: Any, declared: Any) -> Any:
    """Best-effort coercion of a parsed value to the current field's type."""
    if value is None or declared is None:
        return value
    if isinstance(declared, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, int):
            return bool(value)
        raise TypeError(f"expected bool, got {value!r}")
    if isinstance(declared, float) and isinstance(value, int):
        return float(value)
    if isinstance(declared, tuple):
        if isinstance(value, (list, tuple)):
            return tuple(value)
        return (value,)
    if isinstance(declared, str) and not isinstance(value, str):
        return str(value)
    return value


def apply_overrides(cfg: Any, assignments: Sequence[str]) -> Any:
    """Apply `key=value` strings to a (frozen) dataclass config.

    Args:
        cfg: dataclass instance (fields may themselves be dataclasses;
            dotted keys descend into them).
        assignments: e.g. ["voxel_size=0.02", "lr_steps=8,11",
            "head.out_channels=64"].

    Returns:
        A new config instance with the overrides applied.

    Raises:
        KeyError: unknown field name (lists the valid fields).
    """
    for a in assignments:
        if "=" not in a:
            raise ValueError(f"override {a!r} is not of the form key=value")
        key, _, raw = a.partition("=")
        cfg = _set_path(cfg, key.strip().split("."), _parse_value(raw.strip()))
    return cfg


def _set_path(cfg: Any, path: Sequence[str], value: Any) -> Any:
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"cannot descend into non-dataclass {type(cfg).__name__}")
    name = path[0]
    names = {f.name for f in dataclasses.fields(cfg)}
    if name not in names:
        raise KeyError(
            f"unknown config field {name!r}; valid fields: {sorted(names)}"
        )
    current = getattr(cfg, name)
    if len(path) == 1:
        new = _coerce(value, current)
    else:
        new = _set_path(current, path[1:], value)
    return dataclasses.replace(cfg, **{name: new})


def add_set_argument(parser) -> None:
    """Attach the standard `--set key=value [key=value ...]` flag."""
    parser.add_argument(
        "--set",
        nargs="+",
        default=[],
        metavar="KEY=VALUE",
        dest="overrides",
        help="config overrides, e.g. --set voxel_size=0.02 lr_steps=8,11 "
             "(reference --cfg-options analog)",
    )
