"""Config loading: TOML file + CLI-style overrides, the port's twin of
beom_tpu/io/config.py.

A TOML table maps 1:1 onto the frozen `Config`, with `key=value` override
strings on top (CLI `--set key=value`).  Override values are parsed as
Python literals where possible, so `nu2=300.0`, `rho=(1026.0,1027.5)`
and `wind=True` all work.
"""

from __future__ import annotations

import ast
import dataclasses
import tomllib
from typing import Iterable, Mapping, Optional

from beom_tpu_torch.core.config import Config

_FIELDS = {f.name for f in dataclasses.fields(Config)}


def _coerce(key: str, value):
    if isinstance(value, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass  # keep the raw string (e.g. scheme="fb")
    if isinstance(value, list):
        value = tuple(value)
    return value


def from_dict(d: Mapping, base: Optional[Config] = None) -> Config:
    unknown = set(d) - _FIELDS
    if unknown:
        raise KeyError(f"unknown Config keys: {sorted(unknown)}")
    kw = {k: _coerce(k, v) for k, v in d.items()}
    if base is None:
        return Config(**kw)
    return dataclasses.replace(base, **kw)


def parse_overrides(overrides: Iterable[str]) -> dict:
    """'key=value' strings -> coerced kwargs dict (keys unrestricted:
    case factories take non-Config parameters like L, H0, tau0)."""
    kw = {}
    for item in overrides:
        key, sep, value = item.partition("=")
        if not sep:
            raise ValueError(f"override {item!r} is not key=value")
        kw[key.strip()] = _coerce(key, value.strip())
    return kw


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    kw = parse_overrides(overrides)
    unknown = set(kw) - _FIELDS
    if unknown:
        raise KeyError(f"unknown Config keys: {sorted(unknown)}")
    return dataclasses.replace(cfg, **kw) if kw else cfg


def load_toml_case(path, overrides: Iterable[str] = (), *, device):
    """Build a runnable experiment from a TOML file.

    The file names a canonical geometry with `case = "<name>"`; every
    other top-level key goes to the case factory, Config fields and
    factory parameters alike.  `overrides` are folded in before the
    geometry is built.  Returns (cfg, grid, forcing, state).
    """
    from beom_tpu_torch.cases import make_case

    with open(path, "rb") as f:
        d = dict(tomllib.load(f))
    name = d.pop("case", None)
    if name is None:
        raise ValueError(
            f"{path}: a runnable TOML must set case = '<canonical case>' "
            "(the geometry factory; see beom_tpu_torch.cases)")
    kw = {k: _coerce(k, v) for k, v in d.items()}
    kw.update(parse_overrides(overrides))
    return make_case(name, device=device, **kw)
