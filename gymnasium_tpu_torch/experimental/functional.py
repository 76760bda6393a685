"""Alias of the functional env API (Gymnasium's
gymnasium/experimental/functional.py:21-131): the implementation is
``gymnasium_tpu_torch.functional``; this module mirrors Gymnasium's import
path.
"""

from gymnasium_tpu_torch.functional import *  # noqa: F401,F403
from gymnasium_tpu_torch.functional import __all__  # noqa: F401
