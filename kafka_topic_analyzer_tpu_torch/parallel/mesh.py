"""Mesh construction and partition placement (port of the reference's
``parallel/mesh.py``, single-controller).

The reference's mesh is a ``(data, space)`` grid of JAX devices that its
collectives reduce.  The port's is a ``(data, space)`` grid of
``torch.device``s: by default the visible CUDA devices, or the CPU when
the caller asks for it.  Shards are placed round-robin over the devices
given, so a grid larger than the device count stacks several shards on
one device (on a host with one card, every shard lands on ``cuda:0``).
The reference refuses such a mesh instead; the port's rule is its form of
the reference tests' forced host devices, and proves correctness, not
multi-card speed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from kafka_topic_analyzer_tpu_torch._torch_support import resolve_device

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[d][s]`` is the device of shard (d, s); shard (d, s) is
    the ``d * S + s``-th row of every record-parallel state leaf."""

    devices: "tuple[tuple[torch.device, ...], ...]"
    axis_names: "tuple[str, str]" = (DATA_AXIS, SPACE_AXIS)

    @property
    def shape(self) -> "tuple[int, int]":
        return len(self.devices), len(self.devices[0])

    def device_of(self, d: int, s: int) -> torch.device:
        return self.devices[d][s]


def make_mesh(
    data: int, space: int = 1, devices: Optional[Sequence] = None
) -> Mesh:
    """A (data, space) mesh over ``devices`` (names or ``torch.device``s;
    default: every visible CUDA device, which raises when there is none),
    shard ``d * space + s`` on ``devices[(d * space + s) % len(devices)]``."""
    if data < 1 or space < 1:
        raise ValueError(f"mesh {data}x{space}: device counts must be positive")
    if devices is None:
        resolve_device("cuda")  # raises without CUDA: no move to the host
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    return Mesh(tuple(
        tuple(devs[(d * space + s) % len(devs)] for s in range(space))
        for d in range(data)
    ))


def local_data_rows(mesh: Mesh) -> List[int]:
    """Data rows this process feeds: every row (one controller)."""
    return list(range(mesh.shape[0]))


def assign_partitions(partitions: List[int], data_shards: int) -> List[List[int]]:
    """Round-robin partitions over data shards (shard d gets partitions[d::D]).

    Any partition→shard assignment is correct (states merge associatively);
    round-robin balances retained-message skew reasonably without needing
    per-partition sizes up front.
    """
    parts = sorted(partitions)
    return [parts[d::data_shards] for d in range(data_shards)]
