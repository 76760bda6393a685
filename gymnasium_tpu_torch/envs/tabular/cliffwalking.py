"""CliffWalking as a tabular functional env.

Counterpart of ``CliffWalkingFunctional`` in the JAX package's
``envs/tabular/cliffwalking.py``, with its raster board drawn on the host
and its named adapter :class:`CliffWalkingTorchEnv`.
"""

from __future__ import annotations

from typing import Any

import torch

from gymnasium_tpu_torch.envs.tabular.core import TabularFuncEnv
from gymnasium_tpu_torch.envs.toy_text.cliffwalking import build_cliffwalking_model
from gymnasium_tpu_torch.utils.device import to_host

__all__ = ["CliffWalkingFunctional", "CliffWalkingTorchEnv"]


class CliffWalkingFunctional(TabularFuncEnv):
    """CliffWalking (4x12). Option ``is_slippery``."""

    def __init__(self, options: dict[str, Any] | None = None):
        options = dict(options or {})
        is_slippery = options.pop("is_slippery", False)
        super().__init__(build_cliffwalking_model(is_slippery), options)

    # -- host-side rgb rendering (reference tabular/cliffwalking.py renders
    # the same 4x12 board via pygame sprites; this is a raster schematic) --

    def render_init(self, cell: int = 40, **kwargs: Any):
        return {"cell": cell}

    def render_image(self, state, render_state, params: Any = None):
        from gymnasium_tpu_torch.utils.raster import Canvas

        cell = render_state["cell"]
        rows, cols = 4, 12
        canvas = Canvas(cols * cell, rows * cell, (235, 235, 235))
        for r in range(rows):
            for c in range(cols):
                if r == 3 and 1 <= c <= 10:
                    color = (120, 60, 50)  # the cliff
                elif (r, c) == (3, 11):
                    color = (90, 170, 90)  # goal
                else:
                    color = (250, 250, 250) if (r + c) % 2 else (225, 225, 230)
                canvas.polygon(
                    [
                        (c * cell + 1, r * cell + 1),
                        ((c + 1) * cell - 1, r * cell + 1),
                        ((c + 1) * cell - 1, (r + 1) * cell - 1),
                        (c * cell + 1, (r + 1) * cell - 1),
                    ],
                    color,
                )
        s = int(to_host(state["s"]))
        r, c = divmod(s, cols)
        canvas.circle(((c + 0.5) * cell, (r + 0.5) * cell), cell * 0.3, (60, 80, 180))
        return render_state, canvas.rgb_array()

    def render_close(self, render_state) -> None:
        return None


from gymnasium_tpu_torch.envs.functional_torch_env import FunctionalTorchEnv  # noqa: E402


class CliffWalkingTorchEnv(FunctionalTorchEnv):
    """Stateful CliffWalking on ``device`` (JAX's ``CliffWalkingJaxEnv``)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 50, "torch": True}

    def __init__(self, render_mode: str | None = None, device: str | torch.device | None = None, **kwargs: Any):
        super().__init__(
            CliffWalkingFunctional(kwargs or None),
            metadata=self.metadata,
            render_mode=render_mode,
            device=device,
        )
