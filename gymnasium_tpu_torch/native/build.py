"""Build the port's host C++ components on first use.

Compiles the C++ sources of this directory with the system ``g++`` into a
shared library under the package's ``build/`` directory, named by a hash of
the sources, and loads it with ``ctypes``. The source directory is never
written to. Without a compiler the callers fall back to their numpy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import gymnasium_tpu_torch.logger as logger

__all__ = ["SOURCE_DIR", "BUILD_DIR", "build_library", "library_path"]

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parent / "build"


def library_path(
    name: str,
    sources: list[str],
    source_dir: str | os.PathLike = SOURCE_DIR,
    build_dir: str | os.PathLike = BUILD_DIR,
) -> Path:
    """Where :func:`build_library` puts the library of ``sources``: named by
    a hash of their bytes, so an edit rebuilds."""
    h = hashlib.sha256()
    for src in sources:
        h.update((Path(source_dir) / src).read_bytes())
    return Path(build_dir) / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(
    name: str,
    sources: list[str],
    source_dir: str | os.PathLike = SOURCE_DIR,
    build_dir: str | os.PathLike = BUILD_DIR,
) -> ctypes.CDLL | None:
    """Compile ``sources`` (names in ``source_dir``) into
    ``build_dir/lib<name>-<digest>.so`` unless it is there, and load it."""
    srcs = [Path(source_dir) / s for s in sources]
    build_dir = Path(build_dir)
    out = library_path(name, sources, source_dir, build_dir)
    if not out.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        # compile to a private name and rename, so that processes building at
        # once never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", *map(str, srcs), "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
            logger.warn(f"native build of {name} failed ({e}); using the numpy path")
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    try:
        return ctypes.CDLL(str(out))
    except OSError as e:
        logger.warn(f"failed to load native {name} ({e}); using the numpy path")
        return None
