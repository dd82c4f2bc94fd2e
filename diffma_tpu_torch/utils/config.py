"""Config system: YAML + CLI flags, flags win.

Counterpart of ``diffma_tpu/utils/config.py``. The machine that runs the
port on the GPU has no PyYAML, so the port reads the flat ``key: value``
YAML of ``configs/*.yaml`` itself. Scalars resolve as PyYAML's ``safe_load``
resolves them (YAML 1.1): ``null``/``~``, booleans, ints with underscores
(``50_000``), floats that have a dot (``1e-4`` without one stays a string,
as in PyYAML), and single- or double-quoted strings. Comments start with
``#`` after whitespace. Nesting, lists and multi-line values are refused.
"""

from __future__ import annotations

import argparse
import re
from typing import Any, Dict, Optional

__all__ = ["Config", "load_config", "merge", "parse_cli", "parse_flat_yaml"]


class Config(dict):
    """Attr-dict: cfg.model and cfg["model"] both work."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


# YAML 1.1 implicit resolvers, as PyYAML's SafeLoader has them.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.\-]*):(?:\s+(.*))?$")


def _scalar(text: str) -> Any:
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    return text


def _value(raw: str, where: str) -> Any:
    """One value with its trailing comment removed."""
    raw = raw.strip()
    if raw[:1] in ("'", '"'):
        q = raw[0]
        i, out = 1, []
        while i < len(raw):
            ch = raw[i]
            if q == "'" and ch == "'" and raw[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            if q == '"' and ch == "\\" and i + 1 < len(raw):
                nxt = raw[i + 1]
                out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(nxt, "\\" + nxt))
                i += 2
                continue
            if ch == q:
                rest = raw[i + 1 :].strip()
                if rest and not rest.startswith("#"):
                    raise ValueError(f"{where}: text after a quoted string")
                return "".join(out)
            out.append(ch)
            i += 1
        raise ValueError(f"{where}: unterminated string")
    text = re.split(r"\s#", raw, maxsplit=1)[0].strip()
    if text[:1] in ("[", "{", "|", ">", "&", "*", "!") or text == "-" or text.startswith("- "):
        raise ValueError(f"{where}: only flat scalar values are supported, got {text!r}")
    return _scalar(text)


def parse_flat_yaml(text: str, name: str = "<yaml>") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        where = f"{name}:{lineno}"
        if line[0].isspace():
            raise ValueError(f"{where}: nested YAML is not supported")
        m = _KEY.match(line.rstrip())
        if not m:
            raise ValueError(f"{where}: expected 'key: value', got {line!r}")
        out[m.group(1)] = _value(m.group(2) or "", where)
    return out


def load_config(path: str) -> Config:
    with open(path) as f:
        return Config(parse_flat_yaml(f.read(), path))


def merge(base: Config, override: Optional[Dict[str, Any]]) -> Config:
    """Override values win; None means "not given"."""
    out = Config(dict(base))
    for k, v in (override or {}).items():
        if v is not None:
            out[k] = v
    return out


def parse_cli(parser: argparse.ArgumentParser, argv=None) -> Config:
    """Parse args, load --config YAML, merge flags over it."""
    args = parser.parse_args(argv)
    d = {k: v for k, v in vars(args).items() if v is not None and k != "config"}
    cfg = load_config(args.config) if getattr(args, "config", None) else Config()
    return merge(cfg, d)
