"""Runtime bootstrap: one rank per process over ``torch.distributed``.

``init`` starts the default process group from the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``),
or as a world of one process when that environment is missing.  The
backend is NCCL on CUDA and gloo for ``device="cpu"``.  Counterpart of
``horovod_tpu.common.basics`` (``init``, ``shutdown``, the rank and size
queries and the ``*_built`` probes).
"""

from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.distributed as dist

from . import process_sets
from .topology import Topology, launched, topology_from_env


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.topology: Optional[Topology] = None
        self.device: Optional[torch.device] = None


_state = _State()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and there is none: the port
    never carries on on the CPU without being asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be 'cuda' or 'cpu', got %r" % (device,))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch runs on CUDA and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def init(device=None, comm=None):
    """Start the world (``hvd.init``).  ``device``: None or "cuda" for
    NCCL on ``cuda:local_rank``, "cpu" for gloo.  ``comm`` exists for
    Horovod's signature and must be None."""
    if comm is not None:
        raise ValueError("MPI communicators are not supported; launch one "
                         "process per device instead")
    with _state.lock:
        if _state.topology is not None:
            return
        dev = resolve_device(device)
        topo = topology_from_env()
        if dev.type == "cuda":
            dev = torch.device("cuda", topo.local_rank
                               if dev.index is None else dev.index)
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if launched():
            dist.init_process_group(backend, init_method="env://",
                                    rank=topo.rank, world_size=topo.size)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        _state.topology, _state.device = topo, dev


def shutdown():
    """Tear the world down (``hvd.shutdown``)."""
    with _state.lock:
        if _state.topology is None:
            return
        process_sets.reset()
        dist.destroy_process_group()
        _state.topology = _state.device = None


def is_initialized() -> bool:
    return _state.topology is not None


def _require_init() -> Topology:
    topo = _state.topology
    if topo is None:
        raise ValueError("horovod_tpu_torch has not been initialized; "
                         "call hvd.init() first")
    return topo


def topology() -> Topology:
    return _require_init()


def device() -> torch.device:
    """The device this rank's collectives run on."""
    _require_init()
    return _state.device


def rank() -> int:
    return _require_init().rank


def size() -> int:
    return _require_init().size


def local_rank() -> int:
    return _require_init().local_rank


def local_size() -> int:
    return _require_init().local_size


def cross_rank() -> int:
    return _require_init().cross_rank


def cross_size() -> int:
    return _require_init().cross_size


def is_homogeneous() -> bool:
    return _require_init().is_homogeneous()


# -- capability probes: what this torch build can do ------------------------

def cuda_built() -> bool:
    return torch.version.cuda is not None


def nccl_built() -> bool:
    return dist.is_available() and dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_available() and dist.is_gloo_available()


def mpi_built() -> bool:
    return dist.is_available() and dist.is_mpi_available()
