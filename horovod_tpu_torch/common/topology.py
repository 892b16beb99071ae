"""Rank layout of a one-process-per-device world, read from the launcher.

The launcher (``torchrun`` or any tool that sets the same variables)
exports ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE``; the cross (node) rank and size follow from them,
as in ``horovod_tpu.common.topology.multiprocess_topology``.  A process
started without that environment is a world of one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class Topology:
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int

    def is_homogeneous(self) -> bool:
        return self.size == self.local_size * self.cross_size


def multiprocess_topology(rank: int, size: int,
                          local_rank: Optional[int] = None,
                          local_size: Optional[int] = None,
                          cross_rank: Optional[int] = None,
                          cross_size: Optional[int] = None) -> Topology:
    local_size = local_size if local_size is not None else 1
    local_rank = local_rank if local_rank is not None else 0
    if cross_size is None:
        cross_size = max(size // max(local_size, 1), 1)
    if cross_rank is None:
        cross_rank = rank // max(local_size, 1)
    return Topology(rank=rank, size=size, local_rank=local_rank,
                    local_size=local_size, cross_rank=cross_rank,
                    cross_size=cross_size)


def launched(env: Mapping[str, str] = os.environ) -> bool:
    """Whether a launcher exported this process's rank and world size."""
    return "RANK" in env and "WORLD_SIZE" in env


def topology_from_env(env: Mapping[str, str] = os.environ) -> Topology:
    if not launched(env):
        return multiprocess_topology(0, 1)

    def opt(name):
        return int(env[name]) if name in env else None

    rank, size = int(env["RANK"]), int(env["WORLD_SIZE"])
    if not 0 <= rank < size:
        raise ValueError("RANK=%d is outside WORLD_SIZE=%d" % (rank, size))
    return multiprocess_topology(rank, size,
                                 local_rank=opt("LOCAL_RANK"),
                                 local_size=opt("LOCAL_WORLD_SIZE"))
