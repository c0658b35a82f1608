"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by ``nvcc`` (found on ``PATH``) for Hopper (``sm_90a``) into a
shared library and loaded with ``ctypes``.  Libraries are built at first
use from the sources in the package, into ``build/torch_kernels/`` beside
the package (listed in ``.gitignore``), named by a hash of their source so
an edited kernel is never served from a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
#: Kernel name → CUDA source, relative to the package.
KERNEL_SOURCES = {
    "counters_merge": "csrc/counters_merge.cu",
    "counters_update": "csrc/counters_update.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: "dict[str, ctypes.PyDLL]" = {}


def build_dir() -> Path:
    return _PKG.parent / "build" / "torch_kernels"


def library_path(name: str) -> Path:
    src = (_PKG / KERNEL_SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> str:
    """Build kernel ``name``'s library if it is missing; returns the
    compiler output (``-Xptxas -v`` register and spill report; empty for a
    library already built).  Raises if ``nvcc`` is absent or fails."""
    out = library_path(name)
    if out.exists():
        return ""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH: the CUDA kernels are built from source "
            "at first use"
        )
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_PKG / KERNEL_SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"CUDA kernel build failed: {name} (nvcc exit "
                f"{proc.returncode}):\n{proc.stdout}"
            )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return proc.stdout


def load(name: str) -> ctypes.PyDLL:
    """The loaded library of kernel ``name``, built first if missing.  It
    is loaded as a ``PyDLL``: its calls keep the GIL, which a launch of a
    few microseconds does not need released and taken again."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.PyDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
