"""Logging with a pluggable callback and levels — the ggml_log_set analogue
(the port of ggml_gfx906_tpu/utils/log.py).

ref: include/ggml.h:589-596 (levels NONE/DEBUG/INFO/WARN/ERROR/CONT),
ggml_log_set src/ggml.c:7065 (global callback, default stderr).

The threshold is config "log_level" (env GGML_TORCH_LOG_LEVEL), read once
at import; `set_level` changes it afterwards.
"""
from __future__ import annotations

import enum
import os
import sys
import time
from typing import Callable

from . import config


class LogLevel(enum.IntEnum):
    NONE = 0
    DEBUG = 1
    INFO = 2
    WARN = 3
    ERROR = 4


def _initial_level() -> LogLevel:
    """config "log_level" as a LogLevel; an env value that names no level
    gives INFO, as the reference's reading of its env key does."""
    raw = os.environ.get(config._env_key("log_level"))
    name = (raw if raw is not None else config.get("log_level")).strip().upper()
    return LogLevel[name] if name in LogLevel.__members__ else LogLevel.INFO


_callback: Callable[[LogLevel, str], None] | None = None
_min_level = _initial_level()


def log_set(callback: Callable[[LogLevel, str], None] | None):
    """Install a global log callback (None restores the stderr default)."""
    global _callback
    _callback = callback


def set_level(level: LogLevel):
    global _min_level
    _min_level = level


def _emit(level: LogLevel, msg: str):
    if level < _min_level:
        return
    if _callback is not None:
        _callback(level, msg)
    else:
        ts = time.strftime("%H:%M:%S")
        print(f"[{ts}] {level.name:5s} {msg}", file=sys.stderr)


def debug(msg: str):
    _emit(LogLevel.DEBUG, msg)


def info(msg: str):
    _emit(LogLevel.INFO, msg)


def warn(msg: str):
    _emit(LogLevel.WARN, msg)


def error(msg: str):
    _emit(LogLevel.ERROR, msg)
