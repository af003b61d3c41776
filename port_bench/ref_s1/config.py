# Frozen copy of holoscene_tpu_torch/config.py at commit badb067, for the
# benchmark's plain reference: imports rewired to port_bench.ref_s1, cut to
# the paths the benchmark's Stage-1 configuration runs, in plain PyTorch.
# Do not edit to follow the port.
"""Typed config layer.

The port's own copy of holoscene_tpu/config.py: the port
imports nothing of the JAX package.

Parses the same pyhocon ``.conf`` files as the reference pipeline
(reference: training/holoscene_train.py:48 uses pyhocon ConfigFactory) with a
self-contained HOCON-subset parser (pyhocon is not available in this image).

Supported HOCON subset — everything the shipped confs use:
  * ``key = value`` and ``key : value``
  * nested objects ``name { ... }`` (with or without ``=``)
  * lists ``[a, b, c]``
  * scalars: int, float (incl. exponents), bools (true/false/True/False),
    quoted and bare strings
  * comments: ``#`` and ``//`` to end of line
  * dotted keys on lookup (``conf.get_config('a.b')``)
"""

from __future__ import annotations

import re
from typing import Any


class Config(dict):
    """A nested dict with pyhocon-ConfigTree-compatible accessors."""

    def _resolve(self, key: str) -> Any:
        node: Any = self
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(key)
            node = node[part]
        return node

    def get(self, key: str, default: Any = None) -> Any:  # type: ignore[override]
        try:
            return self._resolve(key)
        except KeyError:
            return default

    def get_config(self, key: str, default: Any = None) -> "Config":
        val = self.get(key, default)
        if val is None:
            return Config()
        return val if isinstance(val, Config) else Config(val)

    def get_int(self, key: str, default: int | None = None) -> int:
        val = self.get(key, default)
        if val is None:
            raise KeyError(key)
        return int(val)

    def get_float(self, key: str, default: float | None = None) -> float:
        val = self.get(key, default)
        if val is None:
            raise KeyError(key)
        return float(val)

    def get_bool(self, key: str, default: bool | None = None) -> bool:
        val = self.get(key, default)
        if val is None:
            raise KeyError(key)
        if isinstance(val, str):
            return val.strip().lower() in ("true", "yes", "on", "1")
        return bool(val)

    def get_string(self, key: str, default: str | None = None) -> str:
        val = self.get(key, default)
        if val is None:
            raise KeyError(key)
        return str(val)

    def get_list(self, key: str, default: list | None = None) -> list:
        val = self.get(key, default)
        if val is None:
            raise KeyError(key)
        return list(val)

    def put(self, key: str, value: Any) -> None:
        node: Any = self
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, Config())
        node[parts[-1]] = value


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _coerce(token: str) -> Any:
    token = token.strip()
    if token.lower() == "true":
        return True
    if token.lower() == "false":
        return False
    if token.lower() in ("null", "none"):
        return None
    if _NUM_RE.match(token):
        if re.match(r"^[+-]?\d+$", token):
            return int(token)
        return float(token)
    if len(token) >= 2 and token[0] == token[-1] and token[0] in "\"'":
        return token[1:-1]
    return token


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)

    def _skip_ws_and_comments(self) -> None:
        while self.pos < self.n:
            ch = self.text[self.pos]
            if ch in " \t\r\n,":
                self.pos += 1
            elif ch == "#" or self.text.startswith("//", self.pos):
                while self.pos < self.n and self.text[self.pos] != "\n":
                    self.pos += 1
            else:
                return

    def parse_object(self, top_level: bool = False) -> Config:
        obj = Config()
        while True:
            self._skip_ws_and_comments()
            if self.pos >= self.n:
                if not top_level:
                    raise ValueError("unexpected EOF inside object")
                return obj
            if self.text[self.pos] == "}":
                self.pos += 1
                return obj
            key = self._parse_key()
            self._skip_ws_and_comments()
            if self.pos < self.n and self.text[self.pos] == "{":
                self.pos += 1
                value: Any = self.parse_object()
            else:
                if self.pos < self.n and self.text[self.pos] in "=:":
                    self.pos += 1
                    self._skip_ws_and_comments()
                if self.pos < self.n and self.text[self.pos] == "{":
                    self.pos += 1
                    value = self.parse_object()
                elif self.pos < self.n and self.text[self.pos] == "[":
                    self.pos += 1
                    value = self._parse_list()
                else:
                    value = self._parse_scalar()
            # HOCON: dotted keys create nested objects; repeated object keys merge
            if isinstance(value, Config) and isinstance(obj.get(key), Config):
                obj.get_config(key).update(value)
            else:
                obj.put(key, value)

    def _parse_key(self) -> str:
        start = self.pos
        while self.pos < self.n and self.text[self.pos] not in "=:{ \t\r\n":
            self.pos += 1
        if self.pos == start:
            raise ValueError(f"expected key at offset {self.pos}")
        return self.text[start:self.pos].strip().strip('"')

    def _parse_list(self) -> list:
        items: list[Any] = []
        while True:
            self._skip_ws_and_comments()
            if self.pos >= self.n:
                raise ValueError("unexpected EOF inside list")
            ch = self.text[self.pos]
            if ch == "]":
                self.pos += 1
                return items
            if ch == "{":
                self.pos += 1
                items.append(self.parse_object())
            elif ch == "[":
                self.pos += 1
                items.append(self._parse_list())
            else:
                start = self.pos
                while self.pos < self.n and self.text[self.pos] not in ",]\n#":
                    self.pos += 1
                items.append(_coerce(self.text[start:self.pos]))

    def _parse_scalar(self) -> Any:
        start = self.pos
        while self.pos < self.n and self.text[self.pos] not in "\n#}":
            if self.text.startswith("//", self.pos):
                break
            self.pos += 1
        return _coerce(self.text[start:self.pos])


def parse_string(text: str) -> Config:
    return _Parser(text).parse_object(top_level=True)


class ConfigFactory:
    """pyhocon-compatible entry point."""

    @staticmethod
    def parse_string(text: str) -> Config:
        return parse_string(text)
