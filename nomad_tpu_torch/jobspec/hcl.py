"""Minimal HCL v1 reader — enough for job specifications.

Behavioral reference: the reference parses jobspecs with hashicorp/hcl v1
(`jobspec/parse.go:26` Parse). This implements the HCL v1 subset jobspecs
actually use: blocks with string labels, `key = value` assignments,
strings (with escapes), heredocs (`<<EOF`/`<<-EOF`), numbers, bools,
lists, inline objects, and `#`, `//`, `/* */` comments.

Output shape matches hashicorp/hcl's decode-into-map convention: each
block contributes `{label...: {body}}` and repeated blocks accumulate
into lists under their key.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple


class HclError(ValueError):
    pass


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<heredoc><<-?(?P<hd_tag>[A-Za-z_][A-Za-z0-9_]*)\n)
  | (?P<string>"(?:\\.|[^"\\])*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.\-]*)
  | (?P<punct>[{}\[\],=:])
""", re.VERBOSE | re.DOTALL)


def _tokenize(src: str) -> List[Tuple[str, str]]:
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise HclError(f"unexpected character {src[pos]!r} at {pos}")
        kind = m.lastgroup
        if kind == "heredoc":
            tag = m.group("hd_tag")
            indent = m.group("heredoc").startswith("<<-")
            # the heredoc body runs to a line holding ONLY the tag
            # (anchored: a body line merely starting with the tag must
            # not terminate it)
            endl = re.search(
                rf"\n[ \t]*{re.escape(tag)}[ \t]*(?=\r?\n|$)",
                src[m.end() - 1:])
            if endl is None:
                raise HclError(f"unterminated heredoc {tag}")
            body = src[m.end(): m.end() - 1 + endl.start() + 1]
            if indent:
                body = "\n".join(ln.lstrip() for ln in body.split("\n"))
            tokens.append(("string", body))
            pos = m.end() - 1 + endl.end()
            continue
        if kind in ("ws", "comment"):
            pos = m.end()
            continue
        tokens.append((kind, m.group()))
        pos = m.end()
    return tokens


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]) -> None:
        self.tokens = tokens
        self.i = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> Tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise HclError("unexpected end of input")
        self.i += 1
        return tok

    def expect(self, value: str) -> None:
        tok = self.next()
        if tok[1] != value:
            raise HclError(f"expected {value!r}, got {tok[1]!r}")

    # body := (assignment | block)*
    def parse_body(self, until: Optional[str] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        while True:
            tok = self.peek()
            if tok is None:
                if until is not None:
                    raise HclError(f"expected {until!r} before end")
                return out
            if until is not None and tok[1] == until:
                self.next()
                return out
            self._parse_item(out)

    def _parse_item(self, out: Dict[str, Any]) -> None:
        kind, key = self.next()
        if kind == "string":
            key = _unquote(key)
        elif kind != "ident":
            raise HclError(f"expected key, got {key!r}")
        tok = self.peek()
        if tok is None:
            raise HclError(f"dangling key {key!r}")
        if tok[1] == "=":
            self.next()
            _merge(out, key, self.parse_value())
            return
        # block: labels then { body }
        labels: List[str] = []
        while tok is not None and tok[0] in ("string", "ident") \
                and tok[1] != "{":
            labels.append(_unquote(self.next()[1]))
            tok = self.peek()
        self.expect("{")
        body = self.parse_body(until="}")
        for label in reversed(labels):
            body = {label: body}
        _merge(out, key, body, block=True)

    def parse_value(self) -> Any:
        kind, val = self.next()
        if kind == "string":
            return _unquote(val)
        if kind == "number":
            return float(val) if "." in val else int(val)
        if kind == "ident":
            if val == "true":
                return True
            if val == "false":
                return False
            return val  # bare word → string (hcl allows in some spots)
        if val == "[":
            items = []
            while True:
                tok = self.peek()
                if tok is None:
                    raise HclError("unterminated list")
                if tok[1] == "]":
                    self.next()
                    return items
                items.append(self.parse_value())
                if self.peek() is not None and self.peek()[1] == ",":
                    self.next()
        if val == "{":
            return self.parse_body(until="}")
        raise HclError(f"unexpected token {val!r}")


def _unquote(s: str) -> str:
    if not (s.startswith('"') and s.endswith('"')):
        return s
    body = s[1:-1]
    return re.sub(
        r"\\(.)",
        lambda m: {"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(
            m.group(1), m.group(1)),
        body)


def _merge(out: Dict[str, Any], key: str, value: Any,
           block: bool = False) -> None:
    """Repeated blocks accumulate into lists (hcl v1 decode semantics)."""
    if key not in out:
        out[key] = [value] if block else value
        return
    existing = out[key]
    if block:
        if isinstance(existing, list):
            existing.append(value)
        else:
            out[key] = [existing, value]
    else:
        out[key] = value


def parse_hcl(src: str) -> Dict[str, Any]:
    return _Parser(_tokenize(src)).parse_body()
