"""EzPickle: pickle objects by their constructor arguments.

Parity with reference gymnasium/utils/ezpickle.py:6-37 (same pickle payload
keys, so snapshots interoperate). Needed for envs whose live state holds
unpicklable native handles — renderers, device buffers, jitted callables.
"""

from __future__ import annotations

from typing import Any


class EzPickle:
    """Mixin that round-trips an object as ``type(self)(*args, **kwargs)``.

    A subclass records its own constructor call by invoking
    ``EzPickle.__init__(self, <the exact args>)`` inside ``__init__``;
    unpickling then REBUILDS the object from scratch instead of restoring a
    ``__dict__`` snapshot, so everything derived (compiled steps, render
    contexts) is freshly re-created on load.
    """

    def __init__(self, *args: Any, **kwargs: Any):
        self._ezpickle_args = args
        self._ezpickle_kwargs = kwargs

    def __getstate__(self):
        # payload layout pinned to the reference's, for cross-package loads
        return {
            "_ezpickle_args": self._ezpickle_args,
            "_ezpickle_kwargs": self._ezpickle_kwargs,
        }

    def __setstate__(self, d):
        rebuilt = type(self)(*d["_ezpickle_args"], **d["_ezpickle_kwargs"])
        self.__dict__.update(rebuilt.__dict__)
