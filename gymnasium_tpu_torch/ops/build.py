"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under the
package's ``build/`` directory (named by a hash of the source and flags, so an
edited source is rebuilt) and loaded with ``ctypes``. Nothing is built when a
module is imported: the first launch builds, or a caller builds every kernel
up front with :func:`build`, one ``nvcc`` process per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "KERNELS", "build", "load"]

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "build"

#: Every kernel source of the port, by name (``csrc/<name>.cu``).
KERNELS = ("cartpole_rollout",)

# -fmad=false keeps each float operation rounded where the plain PyTorch
# version rounds it; -Xptxas -v reports registers and spills in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc was not found on PATH or under CUDA_HOME (/usr/local/cuda)")


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is built."""
    digest = hashlib.sha256((SOURCE_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, in parallel.

    Returns ``{name: {"seconds": wall time, "log": nvcc's output}}`` for the
    libraries it compiled. Raises with nvcc's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, out, start) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        built[name] = {"seconds": time.perf_counter() - start, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
