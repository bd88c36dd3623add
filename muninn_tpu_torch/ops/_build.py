"""Builds the port's CUDA kernels at first use and counts their launches.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` functions. The first
call to ``library(name)`` compiles it with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/kernels/`` at the root of the checkout, named
by a hash of the source, the package's headers (``csrc/*.cuh``), the flags
and ``nvcc --version``, and loads it
with ``ctypes``; a later process with the same toolkit finds the library
there and skips the build. ``load_all(names)`` starts one ``nvcc`` for
each missing library at once and waits for all of them. Importing this
module compiles and loads nothing, so it imports on machines without CUDA.

``LAUNCHES[name]`` counts the kernel launches a wrapper has made: the
wrapper adds one after each launch that its launcher reported as accepted,
and nowhere else. It is ``tracing.LAUNCHES``, bound here under its old
name, as ``reset_launches`` is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from muninn_tpu_torch.tracing import LAUNCHES, reset_launches  # noqa: F401

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
HEADER_DIR = CSRC_DIR  # csrc/*.cuh, found with -I wherever a source lies
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills into BUILD_LOGS
)

BUILD_LOGS: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


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


def build(names: list[str]) -> dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` unless a library of the same source,
    flags and compiler version is already built, all missing ones at once
    (one ``nvcc`` each); return each library's path. Raises after every
    build has ended if any failed."""
    nvcc = nvcc_path()
    version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout
    headers = b"".join(h.read_bytes() for h in sorted(HEADER_DIR.glob("*.cuh")))
    paths, todo = {}, []
    for name in names:
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + headers
            + "\0".join((*NVCC_FLAGS, version)).encode()
        ).hexdigest()[:16]
        out = paths[name] = BUILD_DIR / f"{name}-{digest}.so"
        if not out.is_file():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(HEADER_DIR), "-o", str(tmp),
                   str(src)]
            todo.append((name, cmd, tmp, out))
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    failed, running = [], []
    try:
        for name, cmd, tmp, out in todo:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            running.append((proc, name, cmd, tmp, out))
        for proc, name, cmd, tmp, out in running:
            stdout, stderr = proc.communicate()
            BUILD_LOGS[name] = stdout + stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed to build {name}.cu (exit"
                              f" {proc.returncode}):\n{' '.join(cmd)}\n{stderr}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:  # on an error, stop every compiler still running
        for proc, *_ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load_all(names: list[str]) -> None:
    """Build the missing libraries of ``names`` in parallel and load them."""
    with _LOCK:
        missing = [n for n in names if n not in _LIBS]
        if missing:
            for name, path in build(missing).items():
                _LIBS[name] = ctypes.CDLL(str(path))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    load_all([name])
    return _LIBS[name]
