"""A reader and writer for the subset of YAML that the configs use.

The machine with the card has no PyYAML, so the port reads ``configs/*.yaml``
and ``merge_from_list`` values itself. The subset:

  * block mappings (``KEY: value``, or ``KEY:`` and an indented block), keys
    plain or quoted strings;
  * flow sequences, nested (``SIZES: [[32], [64]]``), which may span lines;
  * scalars as PyYAML's ``safe_load`` resolves them: single- and
    double-quoted strings, decimal ints, floats (``1.5``, ``.5``, ``1.0e-3``,
    ``.inf``, ``.nan``), booleans (``true``, ``False``, ``yes``, ``off``, ...),
    null (``~``, ``null``, empty) and plain strings;
  * ``#`` comments.

Anything else (block sequences, flow mappings, anchors, tags, block scalars,
several documents, tabs, and plain scalars that PyYAML would read as octal,
hex, binary or sexagesimal numbers) raises :class:`YAMLSubsetError` naming
the line. ``dump`` writes the same subset, so its output reads back here and
in PyYAML to the same values.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Optional, Tuple

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"""(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    re.X,
)
# plain scalars PyYAML resolves to numbers this reader does not take
_OTHER_NUMBER = re.compile(
    r"""(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$""",
    re.X,
)
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YAMLSubsetError(ValueError):
    """A document outside the subset this reader takes."""

    def __init__(self, msg: str, line: int):
        super().__init__(f"line {line}: {msg}")
        self.line = line


def _resolve_plain(text: str, line: int) -> Any:
    """A plain (unquoted) scalar, typed as PyYAML's implicit resolvers do."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.replace("_", "").lower()
        if low.endswith(".inf"):
            return -math.inf if low.startswith("-") else math.inf
        if low == ".nan":
            return math.nan
        return float(low)
    if _OTHER_NUMBER.match(text):
        raise YAMLSubsetError(f"number form {text!r} is outside the subset", line)
    if text[0] in "&*!|>%@`{}?\"'" or (text[0] in "-:" and (len(text) == 1 or text[1] == " ")):
        raise YAMLSubsetError(f"{text!r} is outside the subset", line)
    return text


class _Scanner:
    """Scalars and flow sequences from one logical value (which may span
    lines); ``pos`` walks the text, ``lines`` maps offsets to line numbers."""

    def __init__(self, text: str, first_line: int, line_starts: List[int]):
        self.text = text
        self.pos = 0
        self.first_line = first_line
        self.line_starts = line_starts

    def line(self) -> int:
        n = sum(1 for s in self.line_starts if s <= self.pos)
        return self.first_line + max(n - 1, 0)

    def error(self, msg: str) -> YAMLSubsetError:
        return YAMLSubsetError(msg, self.line())

    def skip_space(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \n":
            self.pos += 1

    def value(self, flow: bool) -> Any:
        self.skip_space()
        if self.pos >= len(self.text):
            return None
        c = self.text[self.pos]
        if c == "[":
            return self.sequence()
        if c == '"':
            return self.double_quoted()
        if c == "'":
            return self.single_quoted()
        return self.plain(flow)

    def sequence(self) -> list:
        self.pos += 1  # "["
        out = []
        while True:
            self.skip_space()
            if self.pos >= len(self.text):
                raise self.error("unclosed flow sequence")
            if self.text[self.pos] == "]":
                self.pos += 1
                return out
            out.append(self.value(flow=True))
            self.skip_space()
            if self.pos >= len(self.text):
                raise self.error("unclosed flow sequence")
            c = self.text[self.pos]
            if c == ",":
                self.pos += 1
            elif c != "]":
                raise self.error(f"expected ',' or ']' in a flow sequence, found {c!r}")

    def plain(self, flow: bool) -> Any:
        start = self.pos
        stop = ",[]{}\n" if flow else "\n"
        while self.pos < len(self.text) and self.text[self.pos] not in stop:
            if self.text.startswith(": ", self.pos) or (flow and self.text[self.pos] == ":"):
                raise self.error("a mapping inside a value is outside the subset")
            self.pos += 1
        text = self.text[start:self.pos].strip()
        if not text:
            raise self.error("empty entry in a flow sequence")
        return _resolve_plain(text, self.line())

    def double_quoted(self) -> str:
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.text):
                raise self.error("unclosed double-quoted string")
            c = self.text[self.pos]
            if c == '"':
                self.pos += 1
                return "".join(out)
            if c == "\n":
                raise self.error("a quoted string across lines is outside the subset")
            if c == "\\":
                e = self.text[self.pos + 1:self.pos + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.pos += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = self.text[self.pos + 2:self.pos + 2 + n]
                    if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                        raise self.error(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.pos += 2 + n
                else:
                    raise self.error(f"unknown escape \\{e}")
                continue
            out.append(c)
            self.pos += 1

    def single_quoted(self) -> str:
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.text):
                raise self.error("unclosed single-quoted string")
            c = self.text[self.pos]
            if c == "\n":
                raise self.error("a quoted string across lines is outside the subset")
            if c == "'":
                if self.text.startswith("''", self.pos):
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            out.append(c)
            self.pos += 1


def _strip_comment(line: str) -> str:
    """``line`` without its ``#`` comment (a ``#`` inside quotes, or not
    after a space, belongs to the value)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'" and (i == 0 or line[i - 1] in " [,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(body: str, line: int) -> Tuple[str, str]:
    """``KEY: rest`` -> (key, rest)."""
    if body[0] in "\"'":
        sc = _Scanner(body, line, [0])
        key = sc.value(flow=False)
        rest = body[sc.pos:]
        if not (rest == ":" or rest.startswith(": ")):
            raise YAMLSubsetError("expected ':' after a quoted key", line)
        return key, rest[1:].strip()
    i = body.find(": ")
    if i < 0:
        if not body.endswith(":"):
            raise YAMLSubsetError(f"expected 'KEY: value', found {body!r}", line)
        i = len(body) - 1
    key = body[:i].strip()
    typed = _resolve_plain(key, line)
    if not isinstance(typed, str):
        raise YAMLSubsetError(f"key {key!r} is not a string", line)
    return key, body[i + 1:].strip()


def safe_load(text: str) -> Any:
    """Parse ``text`` to dicts, lists and scalars, as ``yaml.safe_load``
    does for documents inside the subset; raise :class:`YAMLSubsetError`
    naming the line otherwise. An empty document gives None."""
    lines = []  # (line number, indent, content without comment)
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YAMLSubsetError("tab in indentation", n)
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.strip() in ("---", "...") and not raw.startswith(" "):
            raise YAMLSubsetError("document markers are outside the subset", n)
        lines.append((n, len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    n0, indent0, body0 = lines[0]
    if indent0 == 0 and not _is_mapping_line(body0):
        value, used = _flow_value(lines, 0, body0)
        if used != len(lines):
            raise YAMLSubsetError("content after the document's value", lines[used][0])
        return value
    value, used = _mapping(lines, 0, indent0)
    if used != len(lines):
        raise YAMLSubsetError("line outside the mapping's indentation", lines[used][0])
    return value


def _is_mapping_line(body: str) -> bool:
    if body[0] in "[\"'":
        if body[0] == "[":
            return False
        sc = _Scanner(body, 0, [0])
        try:
            sc.value(flow=False)
        except YAMLSubsetError:
            return False
        rest = body[sc.pos:]
        return rest == ":" or rest.startswith(": ")
    return ": " in body or body.endswith(":")


def _flow_value(lines, i: int, first: str) -> Tuple[Any, int]:
    """The value that starts with ``first`` (the rest of line ``i``); a flow
    sequence may continue on the following lines until its brackets close."""
    n = lines[i][0]
    text, starts, j = first, [0], i + 1
    if first.startswith("["):
        while _depth(text) > 0 and j < len(lines):
            starts.append(len(text) + 1)
            text += "\n" + lines[j][2]
            j += 1
    sc = _Scanner(text, n, starts)
    value = sc.value(flow=False)
    sc.skip_space()
    if sc.pos != len(text):
        raise sc.error(f"unexpected {text[sc.pos:].splitlines()[0]!r} after a value")
    return value, j


def _depth(text: str) -> int:
    depth, quote = 0, None
    for c in text:
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
    return depth


def _mapping(lines, i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines):
        n, ind, body = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise YAMLSubsetError("unexpected indentation", n)
        if body.startswith("- ") or body == "-":
            raise YAMLSubsetError("block sequences are outside the subset", n)
        key, rest = _split_key(body, n)
        if rest:
            out[key], i = _flow_value(lines, i, rest)
            continue
        i += 1
        if i < len(lines) and lines[i][1] > indent:
            out[key], i = _mapping(lines, i, lines[i][1])
        else:
            out[key] = None
    return out, i


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _scalar(v: Any) -> str:
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
        s = repr(v).lower()
        if "." not in s and "e" in s:  # PyYAML's float needs a dot: 1e-05 -> 1.0e-05
            s = s.replace("e", ".0e", 1)
        return s
    if isinstance(v, str):
        return json.dumps(v, ensure_ascii=False)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    raise TypeError(f"cannot write {type(v).__name__} in the YAML subset")


def dump(data: dict, indent: int = 0) -> str:
    """``data`` (nested dicts of scalars, lists and tuples) as a block
    mapping with sorted keys and flow sequences."""
    out = []
    for k in sorted(data):
        if not isinstance(k, str):
            raise TypeError(f"key {k!r} is not a string")
        v = data[k]
        key = k if _resolve_plain_safe(k) == k else json.dumps(k)
        if isinstance(v, dict) and v:
            out.append(" " * indent + f"{key}:\n" + dump(v, indent + 2))
        elif isinstance(v, dict):
            raise TypeError(f"empty mapping under {k!r} is outside the subset")
        else:
            out.append(" " * indent + f"{key}: {_scalar(v)}\n")
    return "".join(out)


def _resolve_plain_safe(text: str) -> Optional[Any]:
    if not text or text != text.strip() or any(c in text for c in ":#,[]{}\"'\n"):
        return None
    try:
        return _resolve_plain(text, 0)
    except YAMLSubsetError:
        return None
