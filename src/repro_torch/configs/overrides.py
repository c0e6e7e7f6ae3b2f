"""Config overrides: ``path.to.field=value`` on frozen dataclasses (a copy
of ``repro.configs.overrides``).

Assignments are applied recursively with ``dataclasses.replace`` (configs
stay frozen and hashable).  Values are coerced to the type of the field's
current value; dotted paths descend into nested dataclasses (e.g.
``moe.top_k=4``).  A windowed stablelm-12b at 4 layers:

  apply(stablelm_12b.CFG, ["n_layers=4", "attn_window=4096"])
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence


class OverrideError(ValueError):
    pass


def _coerce(raw: str, current: Any) -> Any:
    if current is None:
        # best-effort literal
        for cast in (int, float):
            try:
                return cast(raw)
            except ValueError:
                pass
        return raw
    t = type(current)
    if t is bool:
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise OverrideError(f"cannot parse bool from {raw!r}")
    if t is int:
        return int(raw)
    if t is float:
        return float(raw)
    if t is str:
        return raw
    if t is tuple:
        parts = [p for p in raw.split(",") if p]
        elem = current[0] if current else raw
        return tuple(_coerce(p, elem) for p in parts)
    raise OverrideError(f"unsupported field type {t} for value {raw!r}")


def apply_one(cfg: Any, path: str, raw: str) -> Any:
    """Return a copy of ``cfg`` with ``path`` (dotted) set to ``raw``."""
    head, _, rest = path.partition(".")
    if not dataclasses.is_dataclass(cfg):
        raise OverrideError(f"{type(cfg).__name__} is not a config dataclass")
    names = {f.name for f in dataclasses.fields(cfg)}
    if head not in names:
        raise OverrideError(
            f"unknown field {head!r} on {type(cfg).__name__}; have {sorted(names)}"
        )
    current = getattr(cfg, head)
    if rest:
        if current is None:
            raise OverrideError(f"{head!r} is None; cannot descend into {rest!r}")
        return dataclasses.replace(cfg, **{head: apply_one(current, rest, raw)})
    return dataclasses.replace(cfg, **{head: _coerce(raw, current)})


def apply(cfg: Any, assignments: Sequence[str]) -> Any:
    """Apply ``key=value`` assignments (as from argparse ``--set``)."""
    for a in assignments or ():
        if "=" not in a:
            raise OverrideError(f"expected key=value, got {a!r}")
        path, _, raw = a.partition("=")
        cfg = apply_one(cfg, path.strip(), raw.strip())
    return cfg
