"""Builds the port's CUDA kernels at first use and counts their launches.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` functions. The first
call to ``library(name)`` compiles it with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/kernels/`` at the root of the checkout, named
by a hash of the source, the flags and ``nvcc --version``, and loads it
with ``ctypes``; a later process with the same toolkit finds the library
there and skips the build. Importing this
module compiles and loads nothing, so it imports on machines without CUDA.

``LAUNCHES[name]`` counts the kernel launches a wrapper has made: the
wrapper adds one after each launch that its launcher reported as accepted,
and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

LAUNCHES: dict[str, int] = {"flat_topk": 0}

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills into BUILD_LOGS
)

BUILD_LOGS: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin):"
        " the CUDA kernels are compiled at first use and need the CUDA toolkit"
    )


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source,
    flags and compiler version is already built; return the library's
    path."""
    src = CSRC_DIR / f"{name}.cu"
    nvcc = nvcc_path()
    version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout
    digest = hashlib.sha256(
        src.read_bytes() + "\0".join((*NVCC_FLAGS, version)).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[name] = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {src.name} (exit {res.returncode}):\n"
            f"{' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib
