"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under the
package's ``build/`` directory (named by a hash of the source, the headers of
``csrc/`` it includes and the flags, so an edit rebuilds) and loaded with
``ctypes``. Generated sources (the articulated substep emitted per model, the
planar solver step emitted per world) are written under ``build/gen/`` first
and built the same way. Nothing is built when a
module is imported: the first launch builds, or a caller builds every kernel
up front with :func:`build`, one ``nvcc`` process per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "KERNELS", "build", "load"]

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "build"
GEN_DIR = BUILD_DIR / "gen"

#: Every hand-written kernel source of the port, by name (``csrc/<name>.cu``).
KERNELS = ("cartpole_rollout", "walker_terrain")

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


_INCLUDE = re.compile(rb'^#include "([\w.]+\.cuh)"', re.MULTILINE)


def _digest(text: bytes) -> str:
    """Hash of a source, the ``csrc/`` headers it includes and the flags."""
    digest = hashlib.sha256(text)
    for header in sorted(set(_INCLUDE.findall(text))):
        digest.update((SOURCE_DIR / header.decode()).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def library_path(name: str, text: str | None = None) -> Path:
    """Where the shared library of ``csrc/<name>.cu``, or of the generated
    source ``text`` when given, is built."""
    if text is not None:
        return generated_source_path(name, text).with_suffix(".so")
    return BUILD_DIR / f"lib{name}-{_digest((SOURCE_DIR / f'{name}.cu').read_bytes())}.so"


def generated_source_path(name: str, text: str) -> Path:
    """Where the generated source ``text`` named ``name`` is written."""
    return GEN_DIR / f"{name}-{_digest(text.encode())}.cu"


def build(names=KERNELS, generated: dict[str, str] | None = None) -> dict[str, dict]:
    """Compile every library not built yet, in parallel.

    ``names`` are sources under ``csrc/``; ``generated`` maps a name to a
    generated source text, written under ``build/gen/`` and compiled with
    ``csrc/`` on the include path. Returns ``{name: {"seconds": wall time,
    "log": nvcc's output}}`` for the libraries it compiled. Raises with
    nvcc's output if any compile fails.
    """
    GEN_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = {name: (SOURCE_DIR / f"{name}.cu", library_path(name)) for name in names}
    for name, text in (generated or {}).items():
        src = generated_source_path(name, text)
        if not src.exists():
            tmp_src = src.with_name(f"{src.stem}.{os.getpid()}.tmp.cu")
            tmp_src.write_text(text)
            os.replace(tmp_src, src)
        sources[name] = (src, src.with_suffix(".so"))

    jobs = {}
    for name, (src, out) in sources.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(SOURCE_DIR), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, out, start) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {sources[name][0]} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        built[name] = {"seconds": time.perf_counter() - start, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def load(name: str, text: str | None = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, or of the generated source
    ``text`` when given, built first if needed."""
    key = name if text is None else f"{name}-{_digest(text.encode())}"
    lib = _loaded.get(key)
    if lib is None:
        if text is None:
            build((name,))
        else:
            build((), {name: text})
        lib = _loaded[key] = ctypes.CDLL(str(library_path(name, text)))
    return lib
