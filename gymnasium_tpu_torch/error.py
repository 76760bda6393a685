"""Exceptions of the torch port (the subset of the JAX package's taxonomy it raises)."""

from __future__ import annotations

__all__ = ["Error"]


class Error(Exception):
    """Error superclass."""
