"""The YAML that the command line's dict flags take, without PyYAML.

``safe_load(text)`` reads the forms that ``yaml.safe_load`` reads for the
trainer's ``--model_args``, ``--train_args``, ``--eval_args``,
``--save_args``, ``--rec_mults`` and ``--corrupt``: flow mappings and
sequences (``{bf16: true}``, ``{semi: 0.5, modalities: [spiral-y]}``,
nested), quoted and plain scalars, and ``#`` comments. Plain scalars
resolve as YAML 1.1 does: ``null``/``~``, the booleans (``true``,
``yes``, ``on``, ``false``, ``no``, ``off`` in their three casings),
ints (decimal, ``0x``, ``0b``, leading-zero octal) and floats (which
need a dot, so ``1e-4`` stays a string, as in PyYAML); anything else is
a string (``auto``). Block YAML (``key: value`` without braces),
anchors, tags and sexagesimal numbers are not read: they raise
``YAMLError``.
"""

import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_FLOW = ",[]{}"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\"}


class YAMLError(ValueError):
    pass


def resolve(s):
    """A plain scalar's value."""
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    return s


class _Parser:
    def __init__(self, text):
        self.s = text
        self.i = 0

    def error(self, what):
        raise YAMLError("%s at column %d of %r" % (what, self.i, self.s))

    def peek(self):
        return self.s[self.i] if self.i < len(self.s) else ""

    def skip_ws(self):
        """Skip white space and comments (a '#' after white space, to the
        end of its line)."""
        while True:
            while self.peek() in (" ", "\t", "\n", "\r"):
                self.i += 1
            if self.peek() != "#" or (self.i and self.s[self.i - 1] not in
                                      " \t\n\r"):
                return
            end = self.s.find("\n", self.i)
            self.i = len(self.s) if end < 0 else end

    def is_value_colon(self, flow):
        """A ':' at the cursor that separates a key from its value."""
        nxt = self.s[self.i + 1] if self.i + 1 < len(self.s) else ""
        return nxt in ("", " ", "\t", "\n") or (flow and nxt in _FLOW)

    def node(self, flow):
        self.skip_ws()
        c = self.peek()
        if c == "{":
            return self.mapping()
        if c == "[":
            return self.sequence()
        if c in ("'", '"'):
            return self.quoted()
        return resolve(self.plain(flow))

    def plain(self, flow):
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if flow and c in _FLOW:
                break
            if c == ":" and self.is_value_colon(flow):
                break
            if c == "#" and self.i > start and self.s[self.i - 1] in " \t":
                break
            self.i += 1
        return self.s[start:self.i].strip()

    def quoted(self):
        q = self.peek()
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                self.error("unterminated quoted scalar")
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                    continue
                width = {"x": 2, "u": 4, "U": 8}.get(e)
                if width is None:
                    self.error("unknown escape \\%s" % e)
                out.append(chr(int(self.s[self.i + 2:self.i + 2 + width],
                                   16)))
                self.i += 2 + width
                continue
            out.append(c)
            self.i += 1

    def mapping(self):
        self.i += 1
        out = {}
        while True:
            self.skip_ws()
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.node(flow=True)
            self.skip_ws()
            value = None
            if self.peek() == ":":
                self.i += 1
                self.skip_ws()
                if self.peek() not in (",", "}"):
                    value = self.node(flow=True)
            out[key] = value
            self.skip_ws()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                self.error("expected ',' or '}'")

    def sequence(self):
        self.i += 1
        out = []
        while True:
            self.skip_ws()
            if self.peek() == "]":
                self.i += 1
                return out
            out.append(self.node(flow=True))
            self.skip_ws()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                self.error("expected ',' or ']'")

    def document(self):
        self.skip_ws()
        if self.peek() in ("{", "[", "'", '"'):
            value = self.node(flow=False)
        else:
            value = resolve(self.plain(flow=False))
        self.skip_ws()
        if self.i < len(self.s):
            self.error("unexpected text")
        return value


def safe_load(text):
    """The value of one line of flow-style YAML (see the module's
    docstring)."""
    if not isinstance(text, str):
        text = text.decode() if isinstance(text, bytes) else text.read()
    return _Parser(text).document()
