"""Start one process a rank, each in the default process group, and collect
what each returns.

JAX drives every device from one process; the port runs one process a
device. :func:`start` spawns ``world_size`` ranks with
``torch.multiprocessing.start_processes``; they meet through a file in a
fresh temporary directory (NCCL with one card a rank for ``device="cuda"``,
the default; gloo on the CPU for ``device="cpu"``), call ``fn(rank,
world_size, *args)`` and send back its result. :meth:`Ranks.join` waits for
them up to a deadline; a rank that raises, dies or outlives the deadline
fails the whole group, and no rank outlives the call. A failed
``init_process_group`` raises in its rank; ``device="cuda"`` never falls
back to gloo.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["Ranks", "run_ranks", "start"]

GROUP_TIMEOUT_S = 60


def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str, device: str, args: tuple,
               results) -> None:
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=init_method,
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    try:
        out = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


@dataclass
class Ranks:
    """A started group of ranks; :meth:`join` returns their results in rank order."""

    context: mp.ProcessContext
    results: Any
    rendezvous: str
    deadline: float
    timeout: float

    def join(self) -> list:
        """Every rank's result; raises if a rank failed, died or missed the deadline."""
        out: dict[int, Any] = {}
        try:
            # a rank's result is read while it runs: a large one fills the pipe
            while not self.context.join(timeout=self._left(0.5), grace_period=1.0):
                self._drain(out, block=False)
            while len(out) < len(self.context.processes):
                self._drain(out, block=True)
        finally:
            self.kill()
        return [out[rank] for rank in range(len(self.context.processes))]

    def _left(self, at_most: float) -> float:
        left = self.deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"the ranks did not finish within {self.timeout} s")
        return min(left, at_most)

    def _drain(self, out: dict, block: bool) -> None:
        try:
            while True:
                rank, value = self.results.get(timeout=self._left(1.0)) if block else self.results.get_nowait()
                out[rank] = value
                block = False
        except queue.Empty:
            if block:
                raise RuntimeError("every rank exited, but not every rank sent its result") from None

    def kill(self) -> None:
        """End every rank still running."""
        for proc in self.context.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(5)
        shutil.rmtree(self.rendezvous, ignore_errors=True)


def start(fn: Callable, world_size: int, *args: Any, device: str = "cuda", timeout: float = 120.0) -> Ranks:
    """Spawn ``world_size`` ranks running ``fn(rank, world_size, *args)``.
    ``fn`` and ``args`` must pickle (a module-level function)."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if world_size < 1:
        raise ValueError(f"world_size must be at least 1, got {world_size}")
    if device == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks need {world_size} cards, found {torch.cuda.device_count()}")
    results = mp.get_context("spawn").Queue()
    rendezvous = tempfile.mkdtemp(prefix="ranks-")
    init_method = "file://" + os.path.join(rendezvous, "store")
    context = mp.start_processes(
        _rank_main,
        args=(fn, world_size, init_method, device, args, results),
        nprocs=world_size,
        join=False,
        daemon=True,
        start_method="spawn",
    )
    return Ranks(context, results, rendezvous, time.monotonic() + timeout, timeout)


def run_ranks(fn: Callable, world_size: int, *args: Any, device: str = "cuda", timeout: float = 120.0) -> list:
    """:func:`start`, then :meth:`Ranks.join`."""
    return start(fn, world_size, *args, device=device, timeout=timeout).join()
