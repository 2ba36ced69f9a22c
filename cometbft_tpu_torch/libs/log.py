"""Structured key-value logger (counterpart of ``cometbft_tpu/libs/log.py``;
reference: ``libs/log/tm_logger.go`` and the per-module level filter in
``libs/log/filter.go``).

Usage::

    logger = log.logger("consensus", node="node0")
    logger.info("entering new round", height=5, round=0)
    logger.with_(peer="ab12").warn("send failed")

Output is one line per record: ``LVL[timestamp] message  module=consensus
height=5 ...`` (or JSON with ``log.set_format("json")``).  Levels filter
per module via ``set_level("consensus", "debug")`` or the global
default."""

from __future__ import annotations

import json
import sys
import threading
import time

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "none": 100}

_config_lock = threading.Lock()
_default_level = LEVELS["info"]
_module_levels: dict[str, int] = {}
_format = "plain"                    # plain | json
_sink = sys.stderr


def set_level(module: str | None, level: str) -> None:
    global _default_level
    lv = LEVELS[level]
    with _config_lock:
        if module is None:
            _default_level = lv
        else:
            _module_levels[module] = lv


def set_format(fmt: str) -> None:
    global _format
    assert fmt in ("plain", "json")
    _format = fmt


def set_sink(f) -> None:
    global _sink
    _sink = f


class Logger:
    __slots__ = ("module", "ctx")

    def __init__(self, module: str, ctx: dict | None = None):
        self.module = module
        self.ctx = ctx or {}

    def with_(self, **kv) -> "Logger":
        return Logger(self.module, {**self.ctx, **kv})

    def _enabled(self, level: int) -> bool:
        return level >= _module_levels.get(self.module, _default_level)

    def _emit(self, level_name: str, msg: str, kv: dict) -> None:
        record = {**self.ctx, **kv}
        if _format == "json":
            line = json.dumps({"ts": time.time(), "level": level_name,
                               "module": self.module, "msg": msg,
                               **{k: _scalar(v) for k, v in record.items()}})
        else:
            ts = time.strftime("%H:%M:%S", time.localtime())
            kvs = " ".join(f"{k}={_scalar(v)}" for k, v in record.items())
            line = (f"{level_name[0].upper()}[{ts}] {msg:<44} "
                    f"module={self.module}" + (f" {kvs}" if kvs else ""))
        print(line, file=_sink, flush=True)

    def debug(self, msg: str, **kv) -> None:
        if self._enabled(10):
            self._emit("debug", msg, kv)

    def info(self, msg: str, **kv) -> None:
        if self._enabled(20):
            self._emit("info", msg, kv)

    def warn(self, msg: str, **kv) -> None:
        if self._enabled(30):
            self._emit("warn", msg, kv)

    def error(self, msg: str, **kv) -> None:
        if self._enabled(40):
            self._emit("error", msg, kv)


def _scalar(v):
    if isinstance(v, bytes):
        return v.hex()[:16]
    if isinstance(v, float):
        return round(v, 6)
    return v


def logger(module: str, **ctx) -> Logger:
    return Logger(module, ctx)
