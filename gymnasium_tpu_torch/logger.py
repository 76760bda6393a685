"""Minimal leveled logger with colorized output.

Behavioral parity with reference gymnasium/logger.py:17-47 (min-level
warn/deprecation/error with ANSI colors), implemented on top of a tiny
colorize helper (see gymnasium_tpu_torch/utils/colorize.py).
"""

from __future__ import annotations

import sys
import warnings

from gymnasium_tpu_torch.utils.colorize import colorize

__all__ = [
    "DEBUG",
    "INFO",
    "WARN",
    "ERROR",
    "DISABLED",
    "set_level",
    "debug",
    "info",
    "warn",
    "deprecation",
    "error",
]

DEBUG = 10
INFO = 20
WARN = 30
ERROR = 40
DISABLED = 50

min_level = 30


def set_level(level: int) -> None:
    """Set the minimum level at which messages are emitted."""
    global min_level
    min_level = level


def debug(msg: str, *args: object) -> None:
    """Emit a debug message to stderr when the level permits."""
    if min_level <= DEBUG:
        print(f"DEBUG: {msg % args}", file=sys.stderr)


def info(msg: str, *args: object) -> None:
    """Emit an info message to stderr when the level permits."""
    if min_level <= INFO:
        print(f"INFO: {msg % args}", file=sys.stderr)


def warn(msg: str, *args: object, category: type[Warning] = UserWarning, stacklevel: int = 1) -> None:
    """Emit a yellow warning through the warnings machinery."""
    if min_level <= WARN:
        warnings.warn(
            colorize(f"WARN: {msg % args}", "yellow"),
            category=category,
            stacklevel=stacklevel + 1,
        )


def deprecation(msg: str, *args: object) -> None:
    """Emit a DeprecationWarning-flavored warning."""
    warn(msg, *args, category=DeprecationWarning, stacklevel=2)


def error(msg: str, *args: object) -> None:
    """Emit a red error through the warnings machinery (reference
    logger.py:44-47) so callers can capture it programmatically."""
    if min_level <= ERROR:
        warnings.warn(colorize(f"ERROR: {msg % args}", "red"), stacklevel=3)
