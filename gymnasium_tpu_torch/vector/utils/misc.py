"""Multiprocessing helpers (copy of the JAX package's ``vector/utils/misc.py``,
which follows Gymnasium's gymnasium/vector/utils/misc.py:14-61)."""

from __future__ import annotations

import contextlib
import os
import pickle

from gymnasium_tpu_torch import error

__all__ = ["CloudpickleWrapper", "clear_mpi_env_vars"]

_MPI_PREFIXES = ("OMPI_", "PMI_")


class CloudpickleWrapper:
    """Wrap a callable so it crosses process boundaries via cloudpickle.

    Plain pickle rejects lambdas and locally-defined env factories; routing
    the payload through cloudpickle on the sending side (the receiving side
    unpickles with the stdlib, since cloudpickle output is stdlib-loadable)
    lets AsyncVectorEnv ship arbitrary ``env_fns`` to its workers.

    Where cloudpickle is not installed the callable is pickled with the
    standard library, which takes module-level functions and objects (such
    as the factory ``make_vec`` builds) and raises :class:`error.Error` for
    the rest.
    """

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __call__(self):
        return self.fn()

    def __getstate__(self):
        try:
            import cloudpickle
        except ImportError:
            try:
                return pickle.dumps(self.fn)
            except (pickle.PicklingError, AttributeError, TypeError) as e:
                raise error.Error(
                    f"Cannot pickle the env factory {self.fn!r} for a worker process: cloudpickle is not "
                    "installed and the standard library pickles only module-level callables. Pass a "
                    "module-level factory (make_vec's own is one), install cloudpickle, or use a "
                    "context that forks."
                ) from e
        return cloudpickle.dumps(self.fn)

    def __setstate__(self, payload):
        self.fn = pickle.loads(payload)


@contextlib.contextmanager
def clear_mpi_env_vars():
    """Temporarily strip MPI environment variables around process spawn.

    Forked children inheriting OMPI_/PMI_ vars confuse MPI setups that
    expect to manage process trees themselves (``MPI_Init`` mistakes the
    worker for an MPI rank and can hang it).
    """
    stashed = {
        key: os.environ.pop(key)
        for key in list(os.environ)
        if key.startswith(_MPI_PREFIXES)
    }
    try:
        yield
    finally:
        os.environ.update(stashed)
