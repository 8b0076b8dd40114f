"""ANSI-colored logging (the port's copy of ``bpvo_tpu/utils/debug.py``;
reference ``bpvo/debug.h``: Info/Warn/Fatal/dprintf)."""
from __future__ import annotations

import os
import sys

_COLORS = {"info": "\033[32m", "warn": "\033[33m", "fatal": "\033[31m"}
_RESET = "\033[0m"
_USE_COLOR = sys.stderr.isatty()
DEBUG = bool(int(os.environ.get("BPVO_DEBUG", "0")))


def _emit(level: str, msg: str):
    prefix = f"[{level.upper()}]"
    if _USE_COLOR:
        prefix = _COLORS[level] + prefix + _RESET
    print(f"{prefix} {msg}", file=sys.stderr)


def info(msg: str, *args):
    _emit("info", msg % args if args else msg)


def warn(msg: str, *args):
    _emit("warn", msg % args if args else msg)


def fatal(msg: str, *args):
    _emit("fatal", msg % args if args else msg)
    raise SystemExit(1)


def dprintf(msg: str, *args):
    """Debug-only print (reference debug.h dprintf, compiled out in release)."""
    if DEBUG:
        print(msg % args if args else msg, file=sys.stderr)
