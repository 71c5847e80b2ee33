"""A reader for the YAML that the repo's configs use, giving what
`yaml.safe_load` gives (the card's machine has no PyYAML).

Supported: block mappings and sequences (a sequence may sit at its parent
key's indentation), `- key: value` items, flow mappings and sequences nested
in blocks or in each other (they may span lines), plain, single- and
double-quoted scalars, comments, and one leading `---`. Plain scalars resolve
as YAML 1.1 does in PyYAML's `SafeLoader`: `yes/no/on/off/true/false` in
their three spellings are booleans, `~`, `null` and the empty value are
None, a float needs a dot (`5.0e-5` is a float, `1e-4` a string), integers
take `0b`, `0x`, a leading 0 for octal, `_` separators and base 60.

Anything else (anchors, aliases, tags, block scalars, complex keys,
directives, timestamps, merge keys, multi-line plain or quoted scalars)
raises `ValueError` naming its line.
"""

from __future__ import annotations

import re
import typing as typ

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)
_UNSUPPORTED_START = {
    "&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars", ">": "block scalars",
    "%": "directives", "@": "reserved indicators", "`": "reserved indicators", "?": "complex keys",
}
_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f", "r": "\r",
    "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
    "P": "\u2029",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line(typ.NamedTuple):
    indent: int
    text: str  # comment stripped, right-stripped
    lineno: int  # 1-based


def _error(lineno: int, msg: str) -> ValueError:
    return ValueError(f"line {lineno}: {msg}")


def _sexagesimal(value: str, cast: typ.Callable[[str], typ.Any]) -> typ.Any:
    total, base = 0, 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(value: str, lineno: int = 0) -> typ.Any:
    """A plain scalar as YAML 1.1 (PyYAML's SafeLoader) resolves it."""
    if _BOOL.match(value):
        return value.lower() in _TRUE
    if _NULL.match(value):
        return None
    if _INT.match(value):
        return _int(value)
    if _FLOAT.match(value):
        return _float(value)
    if _TIMESTAMP.match(value):
        raise _error(lineno, f"timestamps are not supported: {value!r}")
    if value in ("<<", "="):
        raise _error(lineno, f"merge and value keys are not supported: {value!r}")
    return value


def _strip_comment(raw: str, lineno: int) -> str:
    """The line without its comment: `#` at the start or after whitespace,
    outside quotes."""
    quote = None
    i = 0
    while i < len(raw):
        c = raw[i]
        if quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif quote == "'":
            if c == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i].rstrip()
        elif c in "\"'" and (i == 0 or raw[i - 1] in " \t[{,:-"):
            quote = c
        i += 1
    return raw.rstrip()


def _lines(text: str) -> list[_Line]:
    out = []
    for n, raw in enumerate(text.splitlines(), start=1):
        body = raw.lstrip(" ")
        if body.startswith("\t") or (body and raw[: len(raw) - len(body)].count("\t")):
            raise _error(n, "tabs in indentation are not supported")
        stripped = _strip_comment(body, n)
        if not stripped:
            continue
        if raw.startswith("%"):
            raise _error(n, "directives are not supported")
        out.append(_Line(len(raw) - len(body), stripped, n))
    if out and out[0].text == "---" and out[0].indent == 0:
        out = out[1:]
    for line in out:
        if line.indent == 0 and (line.text.startswith("---") or line.text.startswith("...")):
            raise _error(line.lineno, "more than one document is not supported")
    return out


def _double_quoted(s: str, i: int, lineno: int) -> tuple[str, int]:
    """Parse a double-quoted scalar starting at s[i] == '"'; returns (value, end)."""
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            i += 1
            if i >= len(s):
                break
            e = s[i]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                code = s[i + 1 : i + 1 + n]
                if len(code) != n or not re.fullmatch(r"[0-9a-fA-F]+", code):
                    raise _error(lineno, f"bad escape \\{e}{code}")
                out.append(chr(int(code, 16)))
                i += n
            else:
                raise _error(lineno, f"unknown escape \\{e}")
        else:
            out.append(c)
        i += 1
    raise _error(lineno, "unterminated double-quoted scalar (multi-line quoted scalars are not supported)")


def _single_quoted(s: str, i: int, lineno: int) -> tuple[str, int]:
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == "'":
            if i + 1 < len(s) and s[i + 1] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise _error(lineno, "unterminated single-quoted scalar (multi-line quoted scalars are not supported)")


def _check_start(s: str, lineno: int) -> None:
    if s and s[0] in _UNSUPPORTED_START:
        if s[0] == "?" and len(s) > 1 and s[1] not in " \t":
            return  # a plain scalar that starts with '?'
        raise _error(lineno, f"{_UNSUPPORTED_START[s[0]]} are not supported: {s!r}")


class _Flow:
    """Parser of one flow collection (`{...}` or `[...]`)."""

    def __init__(self, text: str, lineno: int):
        self.s, self.i, self.lineno = text, 0, lineno

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def _peek(self) -> str:
        self._ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def _expect(self, c: str) -> None:
        if self._peek() != c:
            raise _error(self.lineno, f"expected {c!r} in flow collection at {self.s[self.i:self.i + 20]!r}")
        self.i += 1

    def node(self) -> typ.Any:
        c = self._peek()
        if c == "{":
            return self.mapping()
        if c == "[":
            return self.sequence()
        if c == '"':
            v, self.i = _double_quoted(self.s, self.i, self.lineno)
            return v
        if c == "'":
            v, self.i = _single_quoted(self.s, self.i, self.lineno)
            return v
        _check_start(self.s[self.i :], self.lineno)
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in ",[]{}":
                break
            if ch == ":" and (self.i + 1 == len(self.s) or self.s[self.i + 1] in " \t,[]{}"):
                break
            self.i += 1
        return resolve_plain(self.s[start : self.i].strip(), self.lineno)

    def mapping(self) -> dict:
        self._expect("{")
        out: dict = {}
        while True:
            if self._peek() == "}":
                self.i += 1
                return out
            key = self.node()
            if isinstance(key, (dict, list)):
                raise _error(self.lineno, "collections as mapping keys are not supported")
            value = None
            if self._peek() == ":":
                self.i += 1
                if self._peek() not in (",", "}"):
                    value = self.node()
            out[key] = value
            if self._peek() == ",":
                self.i += 1
            elif self._peek() != "}":
                raise _error(self.lineno, f"expected ',' or '}}' in flow mapping at {self.s[self.i:self.i + 20]!r}")

    def sequence(self) -> list:
        self._expect("[")
        out: list = []
        while True:
            if self._peek() == "]":
                self.i += 1
                return out
            item = self.node()
            if self._peek() == ":":
                raise _error(self.lineno, "single-pair mappings inside flow sequences are not supported")
            out.append(item)
            if self._peek() == ",":
                self.i += 1
            elif self._peek() != "]":
                raise _error(self.lineno, f"expected ',' or ']' in flow sequence at {self.s[self.i:self.i + 20]!r}")


def _flow_end(text: str) -> int:
    """Index just past the flow collection that opens text[0], or -1 when it
    does not close on this text."""
    depth, quote, i = 0, None, 0
    while i < len(text):
        c = text[i]
        if quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif quote == "'":
            if c == "'":
                quote = None
        elif c in "\"'":
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    return -1


def _split_key(text: str, lineno: int) -> typ.Optional[tuple[typ.Any, str]]:
    """(key, rest) when `text` is a block mapping entry `key: rest`, else None."""
    if text[0] in "\"'":
        value, end = (_double_quoted if text[0] == '"' else _single_quoted)(text, 0, lineno)
        rest = text[end:].lstrip(" ")
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return value, rest[1:].strip()
        return None
    if text[0] in "[{":
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    key = text[: m.start()].rstrip()
    _check_start(key, lineno)
    return resolve_plain(key, lineno), text[m.end() :].strip()


class _Block:
    def __init__(self, lines: list[_Line]):
        self.lines = lines
        self.i = 0

    def _scalar_or_flow(self, text: str, line: _Line) -> typ.Any:
        """A value on one line (or a flow collection spanning lines)."""
        if text[0] in "[{":
            end = _flow_end(text)
            lineno = line.lineno
            while end < 0:
                if self.i >= len(self.lines):
                    raise _error(lineno, "unterminated flow collection")
                nxt = self.lines[self.i]
                self.i += 1
                text = text + " " + nxt.text
                end = _flow_end(text)
            if text[end:].strip():
                raise _error(lineno, f"unexpected text after a flow collection: {text[end:]!r}")
            flow = _Flow(text, lineno)
            return flow.node()
        if text[0] in "\"'":
            value, end = (_double_quoted if text[0] == '"' else _single_quoted)(text, 0, line.lineno)
            if text[end:].strip():
                raise _error(line.lineno, f"unexpected text after a quoted scalar: {text[end:]!r}")
            return value
        _check_start(text, line.lineno)
        if text == "-" or text.startswith("- ") or re.search(r":(?:[ \t]|$)", text):
            raise _error(line.lineno, f"a block collection is not allowed here: {text!r}")
        if self.i < len(self.lines) and self.lines[self.i].indent > line.indent:
            raise _error(self.lines[self.i].lineno, "multi-line plain scalars are not supported")
        return resolve_plain(text, line.lineno)

    def node(self, indent: int) -> typ.Any:
        line = self.lines[self.i]
        if line.text == "-" or line.text.startswith("- "):
            return self.sequence(line.indent)
        if _split_key(line.text, line.lineno) is not None:
            return self.mapping(line.indent)
        self.i += 1
        return self._scalar_or_flow(line.text, line)

    def _value_after(self, rest: str, line: _Line, indent: int, in_sequence: bool = False) -> typ.Any:
        if rest:
            return self._scalar_or_flow(rest, line)
        if self.i < len(self.lines):
            nxt = self.lines[self.i]
            if nxt.indent > indent:
                return self.node(nxt.indent)
            if nxt.indent == indent and not in_sequence and (nxt.text == "-" or nxt.text.startswith("- ")):
                return self.sequence(indent)  # a sequence at its key's indentation
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise _error(line.lineno, "unexpected indentation")
            kv = _split_key(line.text, line.lineno)
            if kv is None:
                if line.text == "-" or line.text.startswith("- "):
                    break  # the parent's sequence continues
                raise _error(line.lineno, f"expected 'key: value', got {line.text!r}")
            key, rest = kv
            if isinstance(key, (dict, list)):
                raise _error(line.lineno, "collections as mapping keys are not supported")
            self.i += 1
            out[key] = self._value_after(rest, line, indent)
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent != indent or not (line.text == "-" or line.text.startswith("- ")):
                if line.indent > indent:
                    raise _error(line.lineno, "unexpected indentation")
                break
            rest = line.text[1:]
            body = rest.lstrip(" ")
            if not body:
                self.i += 1
                out.append(self._value_after("", line, indent, in_sequence=True))
                continue
            # the item's content becomes a line of its own at its column
            self.lines[self.i] = _Line(indent + 1 + len(rest) - len(body), body, line.lineno)
            out.append(self.node(self.lines[self.i].indent))
        return out


def safe_load(text: str) -> typ.Any:
    """Parse `text` as `yaml.safe_load` would, for the supported subset."""
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0].indent)
    if block.i < len(block.lines):
        raise _error(block.lines[block.i].lineno, "unexpected content")
    return value
