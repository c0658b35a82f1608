"""Build and load the port's native code.

Each CUDA kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by ``nvcc`` (found on ``PATH``) for Hopper (``sm_90a``) into a
shared library and loaded with ``ctypes``; every kernel's source includes
``csrc/kta_launch.cuh``, the entries' shared prelude, and `Kernel` binds
and launches its entry.  The host ingest shim,
``native/ingest.cpp``, is compiled by ``g++`` (found on ``PATH``) with the
flags of the reference's ``native/Makefile``; ``io/native.py`` loads it.
Libraries are built at first use from the sources in the package, into
``build/torch_kernels/`` and ``build/torch_native/`` beside the package
(both under ``build/``, listed in ``.gitignore``), named by a hash of
their source and flags so an edited source is never served from a stale
build.  A build writes a temporary file and renames it into place, so
processes building at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
#: Kernel name → CUDA source, relative to the package.
KERNEL_SOURCES = {
    "counters_merge": "csrc/counters_merge.cu",
    "counters_update": "csrc/counters_update.cu",
    "bitmap_pairs": "csrc/bitmap_pairs.cu",
    "alive_set": "csrc/alive_set.cu",
}
#: The header every kernel's source includes, relative to the package.
LAUNCH_HEADER = "csrc/kta_launch.cuh"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: The ingest shim's source, relative to the package, and its g++ flags.
NATIVE_SOURCE = "native/ingest.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_loaded: "dict[str, ctypes.PyDLL]" = {}


def build_dir() -> Path:
    return _PKG.parent / "build" / "torch_kernels"


def library_path(name: str) -> Path:
    """Kernel ``name``'s library, named by a hash of its source, the shared
    header and the flags, so an edit to either source rebuilds it."""
    src = (_PKG / KERNEL_SOURCES[name]).read_bytes()
    header = (_PKG / LAUNCH_HEADER).read_bytes()
    digest = hashlib.sha256(
        src + header + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


class BuildError(RuntimeError):
    """A compiler is missing or failed."""


def _compile(compiler: str, flags, src: Path, out: Path, what: str) -> str:
    """Compile ``src`` into ``out`` unless it exists; returns the
    compiler's output (empty for a library already built).  Writes a file
    named for this process and thread, then renames it into place."""
    if out.exists():
        return ""
    exe = shutil.which(compiler)
    if exe is None:
        raise BuildError(
            f"{compiler} not found on PATH: {what} is built from source at "
            "first use"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(
            [exe, *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise BuildError(
                f"{what} build failed ({compiler} exit {proc.returncode}):"
                f"\n{proc.stdout}"
            )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return proc.stdout


def build(name: str) -> str:
    """Build kernel ``name``'s library if it is missing; returns the
    compiler output (``-Xptxas -v`` register and spill report; empty for a
    library already built).  Raises `BuildError` if ``nvcc`` is absent or
    fails."""
    return _compile("nvcc", NVCC_FLAGS, _PKG / KERNEL_SOURCES[name],
                    library_path(name), f"CUDA kernel {name}")


def native_build_dir() -> Path:
    return _PKG.parent / "build" / "torch_native"


@functools.lru_cache(maxsize=1)
def _native_target() -> bytes:
    """What ``-march=native`` selects on this host (g++'s resolved target
    options; empty without g++, when no build can exist), so a build
    directory carried to another CPU rebuilds instead of loading code
    that may use instructions this CPU lacks."""
    gxx = shutil.which("g++")
    if gxx is None:
        return b""
    return subprocess.run(
        [gxx, "-march=native", "-Q", "--help=target"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
    ).stdout


def native_library_path() -> Path:
    """The ingest shim's library, named by a hash of its source, its flags
    and the host's native target, and under a file name of its own (not
    the reference shim's), so ``dlopen`` never hands back the reference's
    copy when both are loaded in one process."""
    src = (_PKG / NATIVE_SOURCE).read_bytes()
    digest = hashlib.sha256(
        src + " ".join(GXX_FLAGS).encode() + _native_target()
    ).hexdigest()
    return native_build_dir() / f"libkta_ingest_torch-{digest[:16]}.so"


def build_native() -> str:
    """Build the ingest shim if it is missing; returns g++'s output.
    Raises `BuildError` if ``g++`` is absent or fails."""
    return _compile("g++", GXX_FLAGS, _PKG / NATIVE_SOURCE,
                    native_library_path(), "the native ingest shim")


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


#: The C entries' return code for tensors off the current device
#: (``kWrongDevice`` in ``csrc/kta_launch.cuh``).
WRONG_DEVICE = -1


class Kernel:
    """One hand-written kernel's C entry, bound at its first launch.

    ``args`` is the entry's argument record (a ``struct.Struct`` of
    little-endian fields) whose last two fields are the CUDA stream and
    the device index: `launch` packs the caller's fields with PyTorch's
    current stream on ``device`` and the device's index, passes the record
    as one pointer (one ctypes conversion instead of one per argument) and
    raises on a nonzero return.  The first launch builds and loads the
    library and sets the C signatures, once per process under one lock:
    the fleet's concurrent topic scans can reach their first launch
    together.  Nothing is built or loaded before a launch, so CPU tensors,
    which the wrappers route to their plain versions, never load one."""

    def __init__(self, name: str, entry: str, args: struct.Struct):
        self.name = name
        self.args = args
        self._entry = entry
        self._pack = args.pack
        #: ``(entry, kta_cuda_error_string, raw stream getter)``.
        self._bound = None
        self._bind_lock = threading.Lock()

    def _bind(self):
        import torch  # not at import: io/native loads this module too

        with self._bind_lock:
            if self._bound is None:
                lib = load(self.name)
                fn = getattr(lib, self._entry)
                fn.argtypes = [ctypes.c_char_p]
                fn.restype = ctypes.c_int
                lib.kta_cuda_error_string.argtypes = [ctypes.c_int]
                lib.kta_cuda_error_string.restype = ctypes.c_char_p
                # The current stream's handle as an int, without building
                # a Stream object (CUDA builds of torch only).
                self._bound = (fn, lib.kta_cuda_error_string,
                               torch._C._cuda_getCurrentRawStream)
        return self._bound

    def launch(self, device: "torch.device", *fields) -> None:
        """Launch on ``device`` (a CUDA device) on its current stream.  A
        device that is not the current one raises `ValueError`; any other
        failure raises `RuntimeError` with CUDA's error string."""
        fn, error_string, raw_stream = self._bound or self._bind()
        index = device.index
        err = fn(self._pack(*fields, raw_stream(index), index))
        if err != 0:
            text = error_string(err).decode()
            if err == WRONG_DEVICE:
                import torch

                raise ValueError(
                    f"{self.name}: {text} (current device "
                    f"cuda:{torch.cuda.current_device()}, tensors on {device})"
                )
            raise RuntimeError(f"{self.name} kernel launch failed: {text}")
