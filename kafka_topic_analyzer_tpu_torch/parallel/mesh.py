"""Mesh construction, partition placement and the multi-controller
bring-up (port of the reference's ``parallel/mesh.py``).

The reference's mesh is a ``(data, space)`` grid of JAX devices that its
collectives reduce.  The port's is a ``(data, space)`` grid of
``torch.device``s: by default the visible CUDA devices, or the CPU when
the caller asks for it.  Shards are placed round-robin over the devices
given, so a grid larger than the device count stacks several shards on
one device (on a host with one card, every shard lands on ``cuda:0``).
The reference refuses such a mesh instead; the port's rule is its form of
the reference tests' forced host devices, and proves correctness, not
multi-card speed.

Several controllers (``--distributed COORD:PORT,PID,NPROCS``): every
process runs the same command and joins one ``torch.distributed`` process
group (`initialize_distributed`).  Process ``p`` of ``N`` owns the
contiguous block of ``D / N`` data rows starting at ``p · D / N``
(`local_data_rows`), feeds only their partitions and places only their
shards, round-robin on its own visible devices.  The group's backend is
gloo, and every collective runs on host tensors: NCCL refuses two ranks
on one card, and has no bitwise OR for the alive bitmap.  The reference
derives ownership from where JAX placed each device; with its test layout
(4 devices per process, ``--mesh 8,1``) that gives the same rows.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from kafka_topic_analyzer_tpu_torch._torch_support import resolve_device

DATA_AXIS = "data"
SPACE_AXIS = "space"

#: Seconds a collective (or the group's rendezvous) may wait on a peer
#: before it raises: a peer that died or stopped between collectives must
#: fail the survivors, not hang them.  ``KTA_DISTRIBUTED_TIMEOUT_S``
#: overrides it.
DEFAULT_TIMEOUT_S = 600.0


def initialize_distributed(spec: str) -> None:
    """Multi-controller bring-up: ``"coordinator:port,process_id,
    num_processes"`` (the reference's spec and message).  Joins the gloo
    process group at ``tcp://coordinator:port`` as rank ``process_id`` of
    ``num_processes``; blocks until every process has joined, or raises
    once the timeout (`DEFAULT_TIMEOUT_S`) passes."""
    parts = spec.split(",")
    if len(parts) != 3:
        raise ValueError(
            f"bad --distributed {spec!r}: expected coordinator:port,pid,nprocs"
        )
    coordinator, pid, nprocs = parts[0], int(parts[1]), int(parts[2])
    timeout = float(os.environ.get("KTA_DISTRIBUTED_TIMEOUT_S", DEFAULT_TIMEOUT_S))
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}",
        rank=pid,
        world_size=nprocs,
        timeout=datetime.timedelta(seconds=timeout),
    )


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _owned_rows(data: int) -> List[int]:
    """The contiguous block of data rows this process owns: all of them
    with one controller.  A row that would straddle two processes has no
    single feeding host, so ``data`` must divide by the process count
    (the reference's message; every process raises it)."""
    n, me = process_count(), process_index()
    if n == 1:
        return list(range(data))
    for d in range(data):
        # Row d spans [d·N, (d+1)·N) and process p [p·D, (p+1)·D), in
        # units of 1/(D·N) of the data axis.
        owners = [p for p in range(n)
                  if p * data < (d + 1) * n and (p + 1) * data > d * n]
        if len(owners) > 1:
            raise ValueError(
                f"mesh data row {d} spans processes {owners}; "
                "choose data_shards divisible by the process count so "
                "every data shard has one feeding host"
            )
    per = data // n
    return list(range(me * per, (me + 1) * per))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[d][s]`` is the device of shard (d, s), None for a row
    another process owns; shard (d, s) is the ``d * S + s``-th row of
    every record-parallel state leaf."""

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
    default: every visible CUDA device, which raises when there is none).
    The ``i``-th shard of this process's rows (`local_data_rows`: every
    row with one controller), in shard order, goes on
    ``devices[i % len(devices)]``; other processes' rows get None."""
    if data < 1 or space < 1:
        raise ValueError(f"mesh {data}x{space}: device counts must be positive")
    if devices is None:
        resolve_device("cuda")  # raises without CUDA: no move to the host
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    rows = _owned_rows(data)
    return Mesh(tuple(
        tuple(
            devs[((d - rows[0]) * space + s) % len(devs)] if d in rows else None
            for s in range(space)
        )
        for d in range(data)
    ))


def local_data_rows(mesh: Mesh) -> List[int]:
    """Data rows this process feeds: every row with one controller, else
    its contiguous block of ``D / N`` rows."""
    return _owned_rows(mesh.shape[0])


def assign_partitions(partitions: List[int], data_shards: int) -> List[List[int]]:
    """Round-robin partitions over data shards (shard d gets partitions[d::D]).

    Any partition→shard assignment is correct (states merge associatively);
    round-robin balances retained-message skew reasonably without needing
    per-partition sizes up front.
    """
    parts = sorted(partitions)
    return [parts[d::data_shards] for d in range(data_shards)]
