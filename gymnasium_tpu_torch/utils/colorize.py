"""ANSI terminal color helper (reference: gymnasium/utils/colorize.py)."""

from __future__ import annotations

__all__ = ["colorize", "color2num"]

color2num = {
    "gray": 30,
    "red": 31,
    "green": 32,
    "yellow": 33,
    "blue": 34,
    "magenta": 35,
    "cyan": 36,
    "white": 37,
    "crimson": 38,
}


def colorize(string: str, color: str, bold: bool = False, highlight: bool = False) -> str:
    """Wrap ``string`` in ANSI escape codes for ``color``."""
    attr = []
    num = color2num[color]
    if highlight:
        num += 10
    attr.append(str(num))
    if bold:
        attr.append("1")
    return f"\x1b[{';'.join(attr)}m{string}\x1b[0m"
