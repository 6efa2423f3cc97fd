"""Build and load the port's CUDA kernel libraries.

Each library is one ``csrc/<name>.cu`` with a plain C interface (which
may include the headers ``csrc/*.cuh``), compiled by ``nvcc`` for Hopper
(``sm_90a``) into
``build/repro_torch/<hash of the sources>/lib<name>.so`` at the root of
the checkout and loaded with ``ctypes``; what ``ptxas -v`` said of each
kernel (registers, shared memory, spills) is kept beside it in
``lib<name>.log``. Nothing is compiled or loaded
at import: the first caller builds, and a lock per library makes
concurrent first callers build it once, while two libraries build side
by side. A changed source or header hashes to a new directory, so a
stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parents[1] / "build" / "repro_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
PTXAS_FLAGS = ["-Xptxas", "-v"]   # report registers and spills

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}   # guarded-by: _LOCK
_BUILDING: Dict[str, threading.Lock] = {}   # guarded-by: _LOCK


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources(name: str) -> List[Path]:
    """What ``nvcc`` compiles for library ``name``."""
    return [CSRC / f"{name}.cu"]


def headers() -> List[Path]:
    """The headers the sources may include: hashed with each library,
    never compiled on their own."""
    return sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sources(name) + headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + PTXAS_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def build_log(name: str) -> Path:
    """The compiler's report of the build of ``lib<name>.so``."""
    return library_path(name).with_suffix(".log")


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> List[str]:
    """The compile command for library ``name`` (nothing is run)."""
    return [nvcc, *ARCH_FLAGS, *PTXAS_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(out),
            *(str(s) for s in sources(name))]


def load_library(name: str) -> ctypes.CDLL:
    """Build ``lib<name>.so`` if this checkout has not yet, then load it
    (once per process)."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        build_lock = _BUILDING.setdefault(name, threading.Lock())
    with build_lock:
        with _LOCK:
            lib = _LOADED.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(nvcc_command(name, tmp, _nvcc()),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name}:\n{proc.stdout}{proc.stderr}"
                )
            build_log(name).write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)   # another process may build the same file
        lib = ctypes.CDLL(str(out))
        with _LOCK:
            _LOADED[name] = lib
        return lib
