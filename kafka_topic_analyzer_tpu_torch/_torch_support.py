"""Device selection and the int32-as-u32 helpers.

Counterpart of the reference's ``jax_support.py``.  There is no x64 switch
to flip (torch has native int64) and no accelerator probe: the device is
resolved once, explicitly, and a missing CUDA device is an error — never a
silent move to the host.

Bitmap words and other u32 quantities live on the device as **int32 bit
patterns**: CPU torch has no uint32 arithmetic (no ``bitwise_not``, add,
compare or shift on ``torch.uint32``), while int32 bitwise ops are exact
on both CPU and CUDA and give the same bits.  The patterns become uint32
again only at the numpy boundary (`u32_to_i32` / `i32_to_u32`).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(name: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and not available."""
    if isinstance(name, torch.device):
        dev = name
    else:
        name = "cuda" if name in (None, "gpu") else str(name)
        dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI: --device cpu) to run on "
                "the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (expected gpu or cpu)")
    return dev


def u32_to_i32(arr: np.ndarray) -> np.ndarray:
    """Reinterpret uint32 words as int32 bit patterns (no copy)."""
    return np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)


def i32_to_u32(arr: np.ndarray) -> np.ndarray:
    """Reinterpret int32 bit patterns as uint32 words (no copy)."""
    return np.ascontiguousarray(arr, dtype=np.int32).view(np.uint32)


def u32_low_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern → the int64 value of its uint32 reading."""
    return x.to(torch.int64) & 0xFFFFFFFF


def bit_i32(pos: torch.Tensor) -> torch.Tensor:
    """``1 << pos`` as an int32 bit pattern for ``pos`` in [0, 31].

    Bit 31 is ``INT32_MIN`` in two's complement; it is still a single
    set bit, so masks built from it OR, AND and NOT exactly like the
    reference's uint32 ``jnp.uint32(1) << pos``."""
    one = torch.ones_like(pos, dtype=torch.int32)
    return torch.bitwise_left_shift(one, pos.to(torch.int32))
