"""The one generator of the benchmark's traffic: it reads a traffic file's
parameters and drives the program with the loop the file names.

A traffic file ``traffic/<mix>.json`` names its ``loop``, a module
``portbench/loops/<loop>.py``, and a configuration names its ``reference``,
a task class ``portbench/reference/<module>.py::<Class>``; both are found
by name, so a new loop or reference engine is a new file. A loop module
provides:

- ``setup(cell) -> handle``: the program built and warmed; its end starts
  the window;
- ``window(cell, handle) -> dict``: ``seconds`` of host time, closed on a
  synchronise or a read to the host; ``units``, ``window_s`` and the
  end-to-end ``metrics`` measured by the host's clock;
- ``trace(cell, handle) -> dict``: a traced window (:func:`trace.capture`),
  ``units`` and ``trace``;
- ``keep(cell, handle) -> kept``: what the check needs, the program's
  state freed;
- ``readings(cell, kept, control=False) -> dict``: the numbers the limits
  judge, of the program's outputs or, with ``control``, of the reference
  one precision lower put in the program's place.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import statistics
import sys
import time

import torch


@dataclasses.dataclass
class Cell:
    """What one run of a cell is given."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: torch.device
    started: float  # the host clock at the process's start
    counts: dict | None = None
    peaks: dict | None = None

    def task(self):
        """The configuration's reference task, ``"<module>.<Class>"`` under
        ``portbench/reference/``."""
        module, name = self.config["reference"].rsplit(".", 1)
        return getattr(importlib.import_module(f"portbench.reference.{module}"), name)(self.config)

    def loop(self):
        return importlib.import_module(f"portbench.loops.{self.traffic['loop']}")

    def context(self, steps: int, units: int) -> dict:
        return {"steps": steps, "units": units, "num_envs": self.config["num_envs"],
                "counts": self.counts, "peaks": self.peaks}


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup_mark(cell: Cell, what: str) -> None:
    """Where set-up has got to, on standard error."""
    print(json.dumps({"setup": what, "s": round(time.perf_counter() - cell.started, 3)}), file=sys.stderr)


def report_times(key: str, times: list) -> None:
    """The quartiles of a window's unit times, in ms, on standard error."""
    quartiles = [1e3 * q for q in statistics.quantiles(times, n=4)] if len(times) > 1 else None
    print(json.dumps({f"{key}_ms_quartiles": quartiles, "units": len(times)}), file=sys.stderr)


def run(cell: Cell, traced: bool) -> dict:
    """Set-up, the window (or the traced window) and the readings of one run."""
    loop = cell.loop()
    handle = loop.setup(cell)
    setup_s = time.perf_counter() - cell.started
    result = loop.trace(cell, handle) if traced else loop.window(cell, handle)
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    kept = loop.keep(cell, handle)
    del handle
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checked = time.perf_counter()
    readings = loop.readings(cell, kept)
    readings["_reference_s"] = time.perf_counter() - checked
    result.update(setup_s=setup_s, memory_peak_bytes=peak, readings=readings, kept=kept)
    return result
