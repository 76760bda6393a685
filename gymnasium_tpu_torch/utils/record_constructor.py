"""RecordConstructorArgs: remember wrapper constructor args for spec rebuild.

Parity with reference gymnasium/utils/record_constructor.py:10 — wrappers
inheriting this mixin can be reconstructed from an ``EnvSpec``'s
``additional_wrappers`` stack.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any


class RecordConstructorArgs:
    """Records the arguments passed to the constructor for later spec export."""

    def __init__(self, *, _disable_deepcopy: bool = False, **kwargs: Any):
        # First caller wins: a subclass calling this before delegating to a
        # parent wrapper keeps ITS kwargs, so FlattenObservation records {}
        # rather than TransformObservation's func (reference
        # record_constructor.py:30-34).
        if not hasattr(self, "_saved_kwargs"):
            if _disable_deepcopy is False:
                kwargs = deepcopy(kwargs)
            self._saved_kwargs = kwargs
