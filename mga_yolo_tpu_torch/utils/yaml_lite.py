"""A small YAML reader and writer for the subset this repository's files use.

The card's host has no PyYAML, and a user's data YAML or experiment config
is read on it, so the port reads YAML itself. :func:`loads` returns what
``yaml.safe_load`` returns for:

* a top-level block mapping of ``key: value`` lines;
* values that are scalars (PyYAML's YAML 1.1 rules: null, bool, int, float,
  plain, 'single' and "double" quoted strings), flow lists ``[a, [b, c]]``
  and flow mappings ``{k: v}``, nested to any depth;
* one level of block structure under a key: a block list (``- item``) or a
  block mapping whose values are as above;
* comments, blank lines, and a leading ``---``.

Anything else (anchors, aliases, tags, block scalars, multi-line scalars,
deeper block nesting, several documents) raises ``ValueError`` with the line.
:func:`dumps` writes a mapping of scalars, one-level mappings and lists of
scalars as ``yaml.safe_dump`` does (sorted keys, block style); a list item
that is itself a mapping or a list is written in flow style on its line
(``- {index: 0, inputs: [-1]}``), which both readers read back.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OTHER = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+)$")
_SEXAGESIMAL = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?$")
_KEY = re.compile(r"([^'\"\[{].*?):(?:\s|$)")  # a plain key
_QKEY = re.compile(r"""(?:'[^']*'|"[^"]*"):(?:\s|$)""")  # a quoted key
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0", " ": " "}


class _Error(ValueError):
    pass


def _scalar(text: str) -> Any:
    """A plain scalar's value under PyYAML's implicit resolvers."""
    t = text.strip()
    if t in _NULL:
        return None
    if t in _TRUE:
        return True
    if t in _FALSE:
        return False
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _INT_OTHER.match(t):
        sign, body = (-1, t[1:]) if t[0] == "-" else (1, t.lstrip("+"))
        body = body.replace("_", "")
        base = 2 if body.startswith("0b") else 16 if body.startswith("0x") else 8
        return sign * int(body[2:] if base != 8 else body, base)
    if _SEXAGESIMAL.match(t) or _TIMESTAMP.match(t):
        raise _Error(f"sexagesimal number or timestamp {t!r}")
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if _INF.match(t):
        return -math.inf if t[0] == "-" else math.inf
    if _NAN.match(t):
        return math.nan
    if t[0] in "&*!|>%@`":
        raise _Error(f"unsupported YAML syntax {t!r}")
    return t


class _Flow:
    """Recursive reader of one value in flow context (or a plain line value)."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, flow: bool) -> Any:
        self.ws()
        c = self.s[self.i] if self.i < len(self.s) else ""
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in "'\"":
            return self.quoted(c)
        return self.plain(flow)

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.value(True))
            self.ws()
            c = self.s[self.i:self.i + 1]
            self.i += 1
            if c == "]":
                return out
            if c != ",":
                raise _Error(f"expected ',' or ']' in flow list, got {c!r}")

    def map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.value(True)
            self.ws()
            if self.s[self.i:self.i + 1] != ":":
                raise _Error("expected ':' in flow mapping")
            self.i += 1
            out[key] = self.value(True)
            self.ws()
            c = self.s[self.i:self.i + 1]
            self.i += 1
            if c == "}":
                return out
            if c != ",":
                raise _Error(f"expected ',' or '}}' in flow mapping, got {c!r}")

    def quoted(self, q: str) -> str:
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise _Error("unterminated quoted string (multi-line scalars are not read)")
            c = self.s[self.i]
            if c == q:
                if q == "'" and self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e not in _ESCAPES:
                    raise _Error(f"unsupported escape \\{e}")
                out.append(_ESCAPES[e])
                self.i += 2
                continue
            out.append(c)
            self.i += 1

    def plain(self, flow: bool) -> Any:
        j = self.i
        while j < len(self.s):
            c = self.s[j]
            if flow and c in ",]}":
                break
            if flow and c == ":" and (j + 1 == len(self.s) or self.s[j + 1] in " ,]}"):
                break
            j += 1
        text, self.i = self.s[self.i:j], j
        return _scalar(text)

    def done(self) -> None:
        self.ws()
        if self.i != len(self.s):
            raise _Error(f"unexpected {self.s[self.i:]!r} after the value")


def _strip_comment(line: str) -> str:
    """The line without its comment (a '#' at the start or after a space,
    outside quotes) and trailing space."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " [{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _one(text: str) -> Any:
    """The value of one line's value text."""
    t = text.strip()
    if t[:1] not in ("[", "{", "'", '"'):
        return _scalar(t)
    f = _Flow(t)
    v = f.value(False)
    f.done()
    return v


def _split_key(body: str) -> tuple[Any, str]:
    """'key: value' -> (key, value text); the key may be quoted."""
    if body[:1] in "'\"":
        f = _Flow(body)
        key = f.quoted(body[0])
        rest = body[f.i:]
        if not rest.startswith(":"):
            raise _Error("expected ':' after a quoted key")
        return key, rest[1:]
    m = _KEY.match(body)
    if m is None:
        raise _Error("expected 'key: value'")
    if body[:1] in "?-[{":
        raise _Error("unsupported mapping key")
    return _scalar(m.group(1)), body[m.end():]


def loads(text: str) -> Any:
    """The value of a YAML document in the subset above."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tab indentation")
        line = _strip_comment(raw)
        if line.strip() in ("", "---") and not (line.strip() == "---" and lines):
            continue
        if line.strip() in ("---", "..."):
            raise ValueError(f"line {n}: a second YAML document")
        lines.append((n, len(line) - len(line.lstrip()), line.strip()))
    if not lines:
        return None
    n = lines[0][0]
    try:
        if len(lines) == 1 and not (_KEY.match(lines[0][2]) or _QKEY.match(lines[0][2])):
            return _one(lines[0][2])  # a document that is one value
        out: dict = {}
        i = 0
        while i < len(lines):
            n, ind, body = lines[i]
            if ind != 0:
                raise _Error("unexpected indentation")
            key, rest = _split_key(body)
            i += 1
            if rest.strip():
                out[key] = _one(rest)
                continue
            block = []
            while i < len(lines) and (lines[i][1] > 0 or lines[i][2] == "-" or lines[i][2].startswith("- ")):
                block.append(lines[i])
                i += 1
            n = block[-1][0] if block else n
            out[key] = _block(block)
        return out
    except _Error as e:
        raise ValueError(f"line {n}: {e} (the port reads a subset of YAML)") from None


def _block(block: list) -> Any:
    if not block:
        return None
    ind = block[0][1]
    if any(b[1] != ind for b in block):
        raise _Error("nested block structure below one level")
    if block[0][2].startswith("-"):
        out = []
        for _, _, body in block:
            if not (body == "-" or body.startswith("- ")):
                raise _Error("a block list mixed with a mapping")
            item = body[1:].strip()
            if item.startswith("- ") or _KEY.match(item):
                raise _Error("nested block structure below one level")
            out.append(_one(item))
        return out
    out = {}
    for _, _, body in block:
        key, rest = _split_key(body)
        if not rest.strip():
            raise _Error("nested block structure below one level")
        out[key] = _one(rest)
    return out


def load(path: str | Path) -> Any:
    """:func:`loads` of a file."""
    return loads(Path(path).read_text())


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        return r if "." in r or "e" not in r else r.replace("e", ".0e", 1)
    s = str(v)
    try:
        plain_ok = (s and s == s.strip() and _scalar(s) == s and s[0] not in "-?:,[]{}#&*!|>'\"%@`"
                    and ": " not in s and " #" not in s and not s.endswith(":"))
    except _Error:
        plain_ok = False
    return s if plain_ok else "'" + s.replace("'", "''") + "'"


def _dump_flow(v: Any) -> str:
    """``v`` in flow style: mappings in their own key order."""
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_dump_flow(k)}: {_dump_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_flow(x) for x in v) + "]"
    out = _dump_scalar(v)
    if isinstance(v, str) and not out.startswith("'") and any(c in out for c in ",[]{}"):
        out = "'" + out.replace("'", "''") + "'"
    return out


def dumps(data: dict) -> str:
    """YAML text of a mapping, as ``yaml.safe_dump`` writes it."""
    out = []
    for key in sorted(data):
        v = data[key]
        if isinstance(v, dict) and v:
            out.append(f"{_dump_scalar(key)}:")
            out += [f"  {_dump_scalar(k)}: {_dump_scalar(x)}" for k, x in sorted(v.items())]
        elif isinstance(v, (list, tuple)) and v:
            out.append(f"{_dump_scalar(key)}:")
            out += [f"- {_dump_flow(x) if isinstance(x, (dict, list, tuple)) else _dump_scalar(x)}" for x in v]
        elif isinstance(v, (dict, list, tuple)):
            out.append(f"{_dump_scalar(key)}: {'{}' if isinstance(v, dict) else '[]'}")
        else:
            out.append(f"{_dump_scalar(key)}: {_dump_scalar(v)}")
    return "\n".join(out) + "\n"


def dump(data: dict, path: str | Path) -> None:
    Path(path).write_text(dumps(data))
