"""Build a C source of the generator into a shared library at first use.

The library goes into ``build/benchmark/`` of the checkout, named by a hash
of its source and flags, and is renamed into place so runs that build at
once never load half a file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "benchmark"


def flags() -> "list[str]":
    out = ["-O2", "-shared", "-fPIC"]
    if platform.machine() in ("x86_64", "AMD64"):
        out.append("-msse4.2")
    return out


def library(src: Path) -> ctypes.CDLL:
    """``src`` built with the host's C compiler, loaded."""
    fl = flags()
    digest = hashlib.sha256(src.read_bytes() + " ".join(fl).encode()).hexdigest()
    out = BUILD_DIR / f"libbench_{src.stem}-{digest[:16]}.so"
    if not out.exists():
        cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
        if cc is None:
            raise RuntimeError(f"no C compiler on PATH to build {src.name}")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run([cc, *fl, "-o", str(tmp), str(src)], check=True,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return ctypes.CDLL(str(out))
