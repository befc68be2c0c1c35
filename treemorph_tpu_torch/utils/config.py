"""Pipeline config files without a YAML library.

:func:`load_config` reads a ``.json`` config with :mod:`json` and a
``.yaml`` / ``.yml`` config with :func:`parse_yaml`, a reader of the YAML
subset that ``configs/pipeline_config.yaml`` and ``yaml.safe_dump`` of such
a dict use:

- block mappings and ``- item`` sequences of scalars, nested by spaces (a
  sequence may sit at its key's indentation, as ``safe_dump`` writes it);
- plain scalars, and single- or double-quoted scalars on one line;
- ``null`` / ``~`` / an empty value, ``true`` / ``false``, decimal ints,
  and floats with a decimal point (``1.5``, ``-0.25e-3``, ``.inf``,
  ``.nan``), the way PyYAML's ``safe_load`` resolves them;
- ``#`` comments and blank lines.

Anything else raises :class:`ValueError` naming the line: anchors, aliases,
tags, flow collections, block scalars, documents markers, tabs, duplicate
keys, and plain scalars whose type YAML 1.1 and 1.2 read differently
(``yes`` / ``on``, ``1e-5``, ``0o17``, ``1_000``, ``007``). The reader
never guesses.
"""

from __future__ import annotations

import json
import math
import os
import re

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)")
_NAN = re.compile(r"\.(nan|NaN|NAN)")
_NULL = ("", "~", "null", "Null", "NULL")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
#: plain scalars that YAML 1.1 (PyYAML) reads as bools and YAML 1.2 as
#: strings
_AMBIGUOUS_BOOL = {"yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON",
                   "off", "Off", "OFF", "y", "Y", "n", "N"}
#: a plain scalar may not start with these indicators
_INDICATORS = "&*!{}[]|>%@`?,\"'"
#: the escapes of double-quoted scalars that JSON reads the same way
_JSON_ESCAPES = set('"\\/bfnrtu')


def load_config(path: str) -> dict:
    """The config at ``path``: JSON for ``.json``, else the YAML subset of
    :func:`parse_yaml`."""
    with open(path) as f:
        text = f.read()
    if os.path.splitext(path)[1].lower() == ".json":
        return json.loads(text)
    return parse_yaml(text)


class _Line:
    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text

    def error(self, what: str) -> ValueError:
        return ValueError(f"line {self.number}: {what} is outside the YAML "
                          f"subset this reader takes: {self.text!r}")

    @property
    def is_item(self) -> bool:
        return self.text == "-" or self.text.startswith("- ")


def _strip_comment(text: str, number: int) -> str:
    """``text`` without its ``#`` comment (a ``#`` at the start or after a
    space, outside quotes)."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " :-"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip()
        i += 1
    if quote is not None:
        raise ValueError(f"line {number}: a quoted scalar that does not end "
                         f"on its line is outside the YAML subset this "
                         f"reader takes: {text!r}")
    return text.rstrip()


def _lines(text: str) -> list[_Line]:
    out = []
    for number, raw in enumerate(text.splitlines(), start=1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise ValueError(f"line {number}: a tab in the indentation is "
                             f"outside the YAML subset this reader takes")
        body = _strip_comment(body, number)
        if not body:
            continue
        line = _Line(number, len(raw) - len(raw.lstrip(" ")), body)
        if body in ("---", "...") or body.startswith(("--- ", "%")):
            raise line.error("a document marker or directive")
        out.append(line)
    return out


def _quoted(text: str, line: _Line) -> str:
    """The value of the quoted scalar ``text`` (quotes included)."""
    if len(text) < 2 or text[-1] != text[0]:
        raise line.error("text after a quoted scalar")
    body = text[1:-1]
    if text[0] == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise line.error("text after a quoted scalar")
        return body.replace("''", "'")
    i = 0
    while i < len(body):
        if body[i] == "\\":
            if body[i + 1:i + 2] not in _JSON_ESCAPES:
                raise line.error("a double-quoted escape JSON lacks")
            i += 2
            continue
        if body[i] == '"':
            raise line.error("text after a quoted scalar")
        i += 1
    return json.loads(text)


def _scalar(text: str, line: _Line):
    """A scalar resolved as ``yaml.safe_load`` resolves it, or an error."""
    if text[:1] in "'\"":
        return _quoted(text, line)
    if text[:1] in _INDICATORS or text.startswith(("- ", ": ")):
        raise line.error("an anchor, alias, tag, flow collection, block "
                         "scalar or other indicator")
    if ": " in text or text.endswith(":"):
        raise line.error("a mapping inside a plain scalar")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text in _AMBIGUOUS_BOOL:
        raise line.error("a plain scalar that YAML 1.1 reads as a bool")
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _INF.fullmatch(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    if re.fullmatch(r"[-+]?[0-9.][0-9a-zA-Z_:.+-]*", text):
        # 1e-5, 0x1f, 0o17, 007, 1_000, 1:30: numbers in one YAML version,
        # strings or other numbers in the other
        raise line.error("a number of a form YAML versions read differently")
    return text


def _split_key(line: _Line) -> tuple:
    """``(key, rest)`` of a mapping line ``key: rest`` (or ``key:``)."""
    text = line.text
    if text[:1] in "'\"":
        end = 1
        while True:
            end = text.find(text[0], end)
            if end < 0:
                raise line.error("an unterminated quoted key")
            if text[0] == "'" and text[end + 1:end + 2] == "'":
                end += 2
                continue
            if text[0] == '"' and text[end - 1] == "\\":
                end += 1
                continue
            break
        key_text, after = text[:end + 1], text[end + 1:]
        if not (after == ":" or after.startswith(": ")):
            raise line.error("a quoted key without ': '")
        return _scalar(key_text, line), after[1:].strip()
    match = re.search(r":( |$)", text)
    if match is None:
        raise line.error("a line that is neither 'key: value' nor '- item'")
    key_text = text[:match.start()]
    if key_text.startswith("? ") or not key_text:
        raise line.error("a complex key")
    return _scalar(key_text, line), text[match.end():].strip()


def _node(lines: list[_Line], i: int, indent: int) -> tuple:
    """The block node whose lines start at ``lines[i]`` (indented by
    ``indent``); returns (value, index of the next line)."""
    if lines[i].is_item:
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines, i, indent):
    out = []
    while i < len(lines) and lines[i].indent == indent and lines[i].is_item:
        line = lines[i]
        item = line.text[1:].strip()
        if not item:
            raise line.error("a nested block under '-'")
        if item[:1] not in "'\"" and re.search(r":( |$)", item):
            raise line.error("a mapping inside a sequence")
        out.append(_scalar(item, line))
        i += 1
    if i < len(lines) and lines[i].indent > indent:
        raise lines[i].error("an indentation that fits no block")
    return out, i


def _mapping(lines, i, indent):
    out = {}
    while i < len(lines) and lines[i].indent == indent:
        line = lines[i]
        if line.is_item:
            raise line.error("a sequence item among mapping keys")
        key, rest = _split_key(line)
        if key in out:
            raise line.error("a duplicate key")
        i += 1
        if rest:
            out[key] = _scalar(rest, line)
        elif i < len(lines) and lines[i].indent > indent:
            out[key], i = _node(lines, i, lines[i].indent)
        elif i < len(lines) and lines[i].indent == indent \
                and lines[i].is_item:
            out[key], i = _sequence(lines, i, indent)
        else:
            out[key] = None
    if i < len(lines) and lines[i].indent > indent:
        raise lines[i].error("an indentation that fits no block")
    return out, i


def parse_yaml(text: str):
    """``text`` in the YAML subset of this module's docstring, as
    ``yaml.safe_load`` reads it (None for an empty document); raises
    ValueError on anything outside the subset."""
    lines = _lines(text)
    if not lines:
        return None
    if lines[0].indent:
        raise lines[0].error("an indented first line")
    if len(lines) == 1 and not lines[0].is_item and not re.search(
            r":( |$)", lines[0].text):
        return _scalar(lines[0].text, lines[0])
    value, i = _node(lines, 0, 0)
    if i < len(lines):
        raise lines[i].error("a line after the top-level block")
    return value
