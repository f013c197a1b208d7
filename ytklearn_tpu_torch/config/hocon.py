"""Minimal HOCON parser for ytk-learn config files.

The reference parses HOCON via typesafe-config (reference: pom.xml:63-67) and
reads `config/model/*.conf`. This module implements the HOCON subset those
files actually use, so unchanged reference configs drive this framework:

- `#` and `//` comments
- `key : value`, `key = value`, `key value` for objects
- newline OR comma as element separator; trailing commas
- nested objects `{}`, arrays `[]`
- quoted and unquoted strings; ints/floats/bools/null
- `???` placeholder (typesafe-config "required but unset") -> MISSING sentinel
- dotted keys (`a.b.c : v`) -> nested objects
- duplicate object keys merge (later wins for scalars, deep-merge for objects)

Substitutions (`${...}`) and `include` are not used by any reference config
and raise a clear error.
"""

from __future__ import annotations

from typing import Any


class _Missing:
    """Sentinel for `???` values (required-but-unset in typesafe-config)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "???"

    def __bool__(self):
        return False


MISSING = _Missing()


class HoconError(ValueError):
    pass


_DELIMS = set("{}[],:=")
_WS = set(" \t\r")


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)

    # --- low level -------------------------------------------------------
    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < self.n else ""

    def _skip_ws_and_comments(self, skip_newlines: bool = True) -> None:
        while self.pos < self.n:
            c = self.text[self.pos]
            if c in _WS:
                self.pos += 1
            elif c == "\n":
                if not skip_newlines:
                    return
                self.pos += 1
            elif c == "#" or self.text.startswith("//", self.pos):
                while self.pos < self.n and self.text[self.pos] != "\n":
                    self.pos += 1
            else:
                return

    def _error(self, msg: str) -> HoconError:
        line = self.text.count("\n", 0, self.pos) + 1
        return HoconError(f"line {line}: {msg}")

    # --- values ----------------------------------------------------------
    def parse_root(self) -> dict:
        self._skip_ws_and_comments()
        if self._peek() == "{":
            obj = self.parse_object()
        else:
            obj = self.parse_object_body(root=True)
        self._skip_ws_and_comments()
        if self.pos < self.n:
            raise self._error(f"trailing content: {self.text[self.pos:self.pos+20]!r}")
        return obj

    def parse_object(self) -> dict:
        assert self._peek() == "{"
        self.pos += 1
        obj = self.parse_object_body(root=False)
        if self._peek() != "}":
            raise self._error("expected '}'")
        self.pos += 1
        return obj

    def parse_object_body(self, root: bool) -> dict:
        obj: dict = {}
        while True:
            self._skip_ws_and_comments()
            c = self._peek()
            if c == "" and root:
                return obj
            if c == "}" and not root:
                return obj
            if c == "":
                raise self._error("unexpected end of input in object")
            if c == ",":
                self.pos += 1
                continue
            key = self.parse_key()
            self._skip_ws_and_comments(skip_newlines=False)
            c = self._peek()
            if c in (":", "="):
                self.pos += 1
                self._skip_ws_and_comments()
                value = self.parse_value()
            elif c == "{":
                value = self.parse_object()
            else:
                raise self._error(f"expected ':', '=' or '{{' after key {key!r}")
            _set_dotted(obj, key, value)

    def parse_key(self) -> str:
        c = self._peek()
        if c == '"':
            return self.parse_quoted_string()
        start = self.pos
        while self.pos < self.n:
            c = self.text[self.pos]
            if c in _DELIMS or c in _WS or c == "\n" or c == "#" or self.text.startswith("//", self.pos):
                break
            self.pos += 1
        key = self.text[start : self.pos]
        if not key:
            raise self._error("empty key")
        return key

    def parse_value(self) -> Any:
        c = self._peek()
        if c == "{":
            return self.parse_object()
        if c == "[":
            return self.parse_array()
        if c == '"':
            s = self.parse_quoted_string()
            # HOCON value concatenation of adjacent strings is not needed by
            # the reference configs; a bare quoted string is the value.
            return s
        if c == "$":
            raise self._error("HOCON substitutions ${...} are not supported")
        return self.parse_unquoted()

    def parse_array(self) -> list:
        assert self._peek() == "["
        self.pos += 1
        items: list = []
        while True:
            self._skip_ws_and_comments()
            c = self._peek()
            if c == "]":
                self.pos += 1
                return items
            if c == ",":
                self.pos += 1
                continue
            if c == "":
                raise self._error("unexpected end of input in array")
            items.append(self.parse_value())

    def parse_quoted_string(self) -> str:
        assert self._peek() == '"'
        self.pos += 1
        out = []
        while self.pos < self.n:
            c = self.text[self.pos]
            if c == '"':
                self.pos += 1
                return "".join(out)
            if c == "\\":
                self.pos += 1
                esc = self.text[self.pos] if self.pos < self.n else ""
                mapping = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\", "/": "/"}
                if esc in mapping:
                    out.append(mapping[esc])
                    self.pos += 1
                elif esc == "u":
                    out.append(chr(int(self.text[self.pos + 1 : self.pos + 5], 16)))
                    self.pos += 5
                else:
                    raise self._error(f"bad escape \\{esc}")
            else:
                out.append(c)
                self.pos += 1
        raise self._error("unterminated string")

    def parse_unquoted(self) -> Any:
        start = self.pos
        while self.pos < self.n:
            c = self.text[self.pos]
            if c in "{}[]," or c == "\n" or c == "#" or self.text.startswith("//", self.pos):
                break
            self.pos += 1
        raw = self.text[start : self.pos].strip()
        if not raw:
            raise self._error("empty value")
        return _coerce(raw)


def _coerce(raw: str) -> Any:
    if raw == "???":
        return MISSING
    low = raw.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low == "null":
        # typesafe-config treats only `null` as null; an unquoted `none`
        # stays a string (ADVICE r1).
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def _set_dotted(obj: dict, key: str, value: Any, merge: bool = True) -> None:
    parts = key.split(".")
    cur = obj
    for p in parts[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    last = parts[-1]
    old = cur.get(last)
    if merge and isinstance(old, dict) and isinstance(value, dict):
        _deep_merge(old, value)
    else:
        cur[last] = value


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


# --- public API ----------------------------------------------------------


def loads(text: str) -> dict:
    """Parse a HOCON document into a plain nested dict."""
    return _Parser(text).parse_root()


def load(path: str) -> dict:
    # ytklint: allow(unseamed-io) reason=startup config parse; runs once before any obs/retry plumbing exists, a missing config must fail loudly not retry
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read())


def get_path(cfg: dict, path: str, default: Any = None) -> Any:
    """`config.getX("a.b.c")` equivalent. Returns `default` when absent."""
    cur: Any = cfg
    for p in path.split("."):
        if not isinstance(cur, dict) or p not in cur:
            return default
        cur = cur[p]
    return cur


def set_path(cfg: dict, path: str, value: Any) -> dict:
    """`config.withValue` equivalent (reference: worker/TrainWorker.java:118-131),
    used for programmatic/custom-param overrides. Mutates and returns cfg.

    Values keep the type they are given (`withValue` semantics) — a string
    "2024" stays a string; callers wanting coercion parse before calling.
    Dict values *replace* the subtree (withValue replaces; only the HOCON
    parser's duplicate-key handling deep-merges)."""
    _set_dotted(cfg, path, value, merge=False)
    return cfg


def require(cfg: dict, path: str) -> Any:
    v = get_path(cfg, path, MISSING)
    if v is MISSING:
        raise HoconError(f"config value {path!r} is required (??? or absent)")
    return v
