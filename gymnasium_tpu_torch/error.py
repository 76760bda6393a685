"""Exception taxonomy for gymnasium_tpu_torch.

Copy of the JAX package's ``error.py``, which mirrors Gymnasium's error
surface (gymnasium/error.py:4-98) so downstream code that catches these by
name keeps working, with errors of its own for the device-resident path.
"""

from __future__ import annotations

__all__ = [
    "Error",
    "Unregistered",
    "UnregisteredEnv",
    "NamespaceNotFound",
    "NameNotFound",
    "VersionNotFound",
    "DeprecatedEnv",
    "DeprecatedWrapper",
    "RegistrationError",
    "UnseedableEnv",
    "DependencyNotInstalled",
    "UnsupportedMode",
    "InvalidMetadata",
    "ResetNeeded",
    "ResetNotAllowed",
    "InvalidAction",
    "MissingArgument",
    "InvalidProbability",
    "InvalidBound",
    "AlreadyPendingCallError",
    "NoAsyncCallError",
    "ClosedEnvironmentError",
    "CustomSpaceError",
    "InvalidInfoFormat",
    "RetriesExceededError",
    "DeviceMismatchError",
    "ShardingError",
]


class Error(Exception):
    """Base class for all gymnasium_tpu_torch errors."""


# --- registry -------------------------------------------------------------


class Unregistered(Error):
    """Raised when the user requests an item from the registry that does not exist."""


class UnregisteredEnv(Unregistered):
    """Raised when the user requests an env from the registry that does not exist."""


class NamespaceNotFound(UnregisteredEnv):
    """A namespace was requested that does not exist in the registry."""


class NameNotFound(UnregisteredEnv):
    """An env name was requested that does not exist in its namespace."""


class VersionNotFound(UnregisteredEnv):
    """An env version was requested that does not exist for that name."""


class DeprecatedEnv(Error):
    """Raised when the user requests an env whose version is deprecated."""


class DeprecatedWrapper(ImportError):
    """Raised when importing an old version of a wrapper (reference error.py:67)."""


class RegistrationError(Error):
    """Raised when the user attempts to register an invalid env spec."""


# --- environment behavior -------------------------------------------------


class UnseedableEnv(Error):
    """Raised when the user seeds an env that cannot be seeded."""


class DependencyNotInstalled(Error):
    """Raised when an optional dependency is required but not installed."""


class UnsupportedMode(Error):
    """Raised when the user requests a render mode not supported by the env."""


class InvalidMetadata(Error):
    """Raised when the metadata of an environment is invalid."""


class ResetNeeded(Error):
    """Raised when the env needs a reset before step/render can be called."""


class ResetNotAllowed(Error):
    """Raised when the env is reset mid-episode while that is disallowed."""


class InvalidAction(Error):
    """Raised when the user submits an action outside the action space."""


class MissingArgument(Error):
    """Raised when a required argument to a function is missing."""


class InvalidProbability(Error):
    """Raised when a probability argument is not within [0, 1]."""


class InvalidBound(Error):
    """Raised when the bounds of a space are invalid."""


# --- async vector env -----------------------------------------------------


class AlreadyPendingCallError(Error):
    """Raised when an async call is made while another is pending."""

    def __init__(self, message: str, name: str):
        super().__init__(message)
        self.name = name


class NoAsyncCallError(Error):
    """Raised when a *_wait is called without a matching *_async."""

    def __init__(self, message: str, name: str):
        super().__init__(message)
        self.name = name


class ClosedEnvironmentError(Error):
    """Raised when a method is called on an env that has been closed."""


class CustomSpaceError(Error):
    """Raised when a custom space is used where a built-in space is required."""


class InvalidInfoFormat(Error):
    """Raised when an info dict does not follow the expected vector format."""


class RetriesExceededError(Error):
    """Raised when an operation exceeds its retry budget."""


# --- device-path additions -------------------------------------------------


class DeviceMismatchError(Error):
    """Raised when arrays from incompatible devices are mixed in one step."""


class ShardingError(Error):
    """Raised when an env-state pytree cannot be laid out on the requested mesh."""
