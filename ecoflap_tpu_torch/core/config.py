"""Config system: project YAML trees and ``--options`` dot-list overrides
(the port's own copy of ``ecoflap_tpu/core/config.py``; reference
LAVIS/lavis/common/config.py:16-144).

The card's machine has no YAML package, so the port reads YAML itself:
``safe_load`` covers what the files under ``configs/projects/`` and the
``--options`` values use (block mappings and sequences, flow ``[...]`` and
``{...}`` collections, quoted and plain scalars, comments) and gives what
PyYAML's ``yaml.safe_load`` gives there, YAML 1.1 scalars included:
``1e-3`` is the string ``'1e-3'`` (a float needs a dot), ``1.0e-3`` and
``0.5`` are floats, ``yes``/``On``/``FALSE`` are booleans, ``~``/``null``
and an empty value are ``None``, ``012`` is 10 (base 8) and
``24-0.5-1.0-1.0`` is a string. Anchors, aliases, tags, block scalars
(``|``, ``>``), multi-line plain scalars and multi-line flow collections
raise ``ValueError``.
"""

from __future__ import annotations

import copy
import datetime
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+"
                  r"|[-+]?0[0-7_]+"
                  r"|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_DATE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]")


def _sexagesimal(digits: str) -> float:
    value = 0.0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def _construct_int(s: str) -> int:
    v = s.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * int(_sexagesimal(v))
    return sign * int(v)


def _construct_float(s: str) -> float:
    v = s.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v)
    return sign * float(v)


def resolve_plain(s: str) -> Any:
    """A plain (unquoted) scalar as PyYAML's SafeLoader types it."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _FLOAT.match(s):
        return _construct_float(s)
    if _INT.match(s):
        return _construct_int(s)
    if _DATE.match(s):
        return datetime.date(int(s[:4]), int(s[5:7]), int(s[8:10]))
    if _TIMESTAMP.match(s):
        raise ValueError(f"YAML timestamp {s!r} is not supported")
    if s[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"unsupported YAML construct {s!r}")
    return s


# -- lines -----------------------------------------------------------------------

def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after
    whitespace, outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    continue
                if quote == '"' and line[i - 1:i] == "\\":
                    continue
                quote = None
        elif ch in "\"'" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs are not allowed in YAML indentation")
        body = _strip_comment(raw)
        if not body.strip() or body.strip() in ("---", "..."):
            continue
        out.append((len(body) - len(body.lstrip(" ")), body.strip()))
    return out


def _split_key(content: str) -> Optional[Tuple[str, str]]:
    """(key, rest) of a ``key: value`` line, or None: the first ``:`` that
    ends the line or precedes a space, outside quotes and brackets."""
    quote, depth = None, 0
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and i == 0:
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(content)
                                           or content[i + 1] == " "):
            return content[:i].strip(), content[i + 1:].strip()
    return None


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


# -- scalars and flow collections ------------------------------------------------------

def _double_quoted(s: str, i: int) -> Tuple[str, int]:
    escapes = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0",
               "r": "\r", " ": " "}
    out, i = [], i + 1
    while i < len(s):
        ch = s[i]
        if ch == '"':
            return "".join(out), i + 1
        if ch == "\\":
            nxt = s[i + 1]
            if nxt in escapes:
                out.append(escapes[nxt])
                i += 2
                continue
            if nxt in "xuU":
                n = {"x": 2, "u": 4, "U": 8}[nxt]
                out.append(chr(int(s[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            raise ValueError(f"unknown escape \\{nxt} in {s!r}")
        out.append(ch)
        i += 1
    raise ValueError(f"unterminated double-quoted scalar in {s!r}")


def _single_quoted(s: str, i: int) -> Tuple[str, int]:
    out, i = [], i + 1
    while i < len(s):
        if s[i] == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(s[i])
        i += 1
    raise ValueError(f"unterminated single-quoted scalar in {s!r}")


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i] == " ":
        i += 1
    return i


def _flow_node(s: str, i: int, in_map_key: bool = False) -> Tuple[Any, int]:
    i = _skip_ws(s, i)
    if i >= len(s):
        raise ValueError(f"unterminated flow collection in {s!r}")
    ch = s[i]
    if ch == "[":
        items, i = [], _skip_ws(s, i + 1)
        while True:
            if i < len(s) and s[i] == "]":
                return items, i + 1
            item, i = _flow_node(s, i)
            items.append(item)
            i = _skip_ws(s, i)
            if i < len(s) and s[i] == ",":
                i = _skip_ws(s, i + 1)
            elif i >= len(s) or s[i] != "]":
                raise ValueError(f"expected ',' or ']' in {s!r}")
    if ch == "{":
        out: Dict[Any, Any] = {}
        i = _skip_ws(s, i + 1)
        while True:
            if i < len(s) and s[i] == "}":
                return out, i + 1
            key, i = _flow_node(s, i, in_map_key=True)
            i = _skip_ws(s, i)
            value = None
            if i < len(s) and s[i] == ":":
                j = _skip_ws(s, i + 1)
                if j < len(s) and s[j] in ",}":
                    i = j
                else:
                    value, i = _flow_node(s, j)
                    i = _skip_ws(s, i)
            out[key] = value
            if i < len(s) and s[i] == ",":
                i = _skip_ws(s, i + 1)
            elif i >= len(s) or s[i] != "}":
                raise ValueError(f"expected ',' or '}}' in {s!r}")
    if ch == '"':
        return _double_quoted(s, i)
    if ch == "'":
        return _single_quoted(s, i)
    j = i
    while j < len(s) and s[j] not in ",[]{}":
        if s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " ,]}"):
            break
        j += 1
    return resolve_plain(s[i:j].strip()), j


def _inline(rest: str) -> Any:
    """A value that starts and ends on its line."""
    if rest[:1] in "[{\"'":
        value, j = _flow_node(rest, 0)
        if rest[j:].strip():
            raise ValueError(f"trailing characters after {rest[:j]!r}")
        return value
    if _split_key(rest) is not None:
        raise ValueError(f"mapping values are not allowed here: {rest!r}")
    return resolve_plain(rest)


# -- blocks ----------------------------------------------------------------------

def _block(lines: List[Tuple[int, str]], i: int, indent: int) -> Tuple[Any, int]:
    content = lines[i][1]
    if _is_item(content):
        return _sequence(lines, i, indent)
    if _split_key(content) is not None and content[:1] not in "[{":
        return _mapping(lines, i, indent)
    if i + 1 < len(lines) and lines[i + 1][0] >= indent:
        raise ValueError(f"multi-line scalars are not supported: {content!r}")
    return _inline(content), i + 1


def _value_after(lines, i, indent, rest) -> Tuple[Any, int]:
    """The value of a key or item whose line ends at ``rest``, then the
    index of the next line."""
    if rest:
        return _inline(rest), i + 1
    if i + 1 < len(lines):
        nxt_indent, nxt = lines[i + 1]
        if nxt_indent > indent:
            return _block(lines, i + 1, nxt_indent)
        if nxt_indent == indent and _is_item(nxt):
            return _sequence(lines, i + 1, indent)
    return None, i + 1


def _mapping(lines, i, indent) -> Tuple[Dict[Any, Any], int]:
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        split = _split_key(lines[i][1])
        if split is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key_text, rest = split
        key = _inline(key_text) if key_text[:1] in "\"'" else resolve_plain(key_text)
        out[key], i = _value_after(lines, i, indent, rest)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return out, i


def _sequence(lines, i, indent) -> Tuple[List[Any], int]:
    out: List[Any] = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        body = lines[i][1][1:].lstrip(" ")
        if not body:
            value, i = _value_after(lines, i, indent, "")
        elif _is_item(body) or (_split_key(body) is not None and body[:1] not in "[{"):
            # a nested block starting on the item's line: re-read it at the
            # column where it starts
            col = indent + len(lines[i][1]) - len(body)
            value, i = _block(lines[:i] + [(col, body)] + lines[i + 1:], i, col)
        else:
            value, i = _inline(body), i + 1
        out.append(value)
    return out, i


def safe_load(text: str) -> Any:
    """The document in ``text`` as ``yaml.safe_load`` reads it (the subset
    in the module docstring); ``None`` for an empty document."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected line {lines[i][1]!r}")
    return value


# -- the config tree ---------------------------------------------------------------

def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return safe_load(f.read()) or {}


def deep_merge(base: Mapping, override: Mapping) -> Dict[str, Any]:
    """Recursive dict merge; override wins; lists replace wholesale."""
    out: Dict[str, Any] = dict(copy.deepcopy(base))
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def parse_dot_list(options: Optional[Sequence[str]]) -> Dict[str, Any]:
    """['a.b=1', 'c=x'] -> nested dict, values typed as YAML scalars."""
    tree: Dict[str, Any] = {}
    for opt in options or []:
        if "=" not in opt:
            raise ValueError(f"option {opt!r} must be key=value")
        key, raw = opt.split("=", 1)
        value = safe_load(raw)
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"option {opt!r} clashes with a scalar")
        node[parts[-1]] = value
    return tree


class Config:
    """The project YAML merged with ``--options`` (``--options`` wins), with
    the reference's three views."""

    def __init__(self, cfg_path: Optional[str] = None,
                 options: Optional[Sequence[str]] = None) -> None:
        merged = load_yaml(cfg_path) if cfg_path else {}
        self.config = deep_merge(merged, parse_dot_list(options))

    @property
    def run_cfg(self) -> Dict[str, Any]:
        return self.config.get("run", {})

    @property
    def model_cfg(self) -> Dict[str, Any]:
        return self.config.get("model", {})

    @property
    def datasets_cfg(self) -> Dict[str, Any]:
        return self.config.get("datasets", {})

    def get(self, dotted: str, default: Any = None) -> Any:
        node: Any = self.config
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node
