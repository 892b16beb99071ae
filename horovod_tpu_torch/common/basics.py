"""Runtime bootstrap: one rank per process over ``torch.distributed``.

``init`` starts the default process group from the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``),
or as a world of one process when that environment is missing.  The
data group is NCCL on CUDA and gloo for ``device="cpu"``; a world of
more than one rank also gets a gloo group for the controller.  Then it
starts the engine (``ops/engine.py``), whose cycle thread alone issues
collectives from then on, configured from the environment
(``common/config.py``).  ``shutdown`` asks the engine to stop (a
negotiated stop: every rank must call it; a frozen fast-path schedule
thaws first, reason ``membership``), joins its thread and destroys
the groups; ``init`` registers it with ``atexit``, and a later ``init``
starts a new world.  ``init`` also learns every rank's node (its rank
less its ``LOCAL_RANK``: a launcher numbers a node's ranks together) and
gives the global set its hierarchical plane when the layout has one
(``ops/multihost.py``).  Counterpart of ``horovod_tpu.common.basics``
(``init``, ``shutdown``, the rank and size queries and the ``*_built``
probes).
"""

from __future__ import annotations

import atexit
import logging
import threading
from typing import Optional

import torch
import torch.distributed as dist

from . import process_sets
from .config import Config
from .topology import Topology, launched, topology_from_env


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.topology: Optional[Topology] = None
        self.device: Optional[torch.device] = None
        self.engine = None
        self.control = None  # the controller's gloo group
        self.nodes = None  # world rank -> its node's first rank
        self.worlds = 0  # worlds started in this process
        self.atexit_registered = False


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
            # The launcher's store, with this world's keys under a prefix
            # of their own: a world started after shutdown() on the same
            # address may find the last world's store still serving, and
            # its keys (group names restart with each world) stale.
            store, _, _ = next(dist.rendezvous(
                "env://", rank=topo.rank, world_size=topo.size))
            dist.init_process_group(
                backend, store=dist.PrefixStore(
                    "horovod_tpu_torch.world%d" % _state.worlds, store),
                rank=topo.rank, world_size=topo.size)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        config = Config.from_env()
        logging.getLogger("horovod_tpu_torch").setLevel(
            config.log_level.upper())
        control = dist.new_group(backend="gloo") if topo.size > 1 else None
        from ..ops import multihost
        from ..ops.engine import Engine
        try:
            nodes = _nodes(topo, control)
            process_sets.global_process_set.hierarchy = multihost.build(
                range(topo.size), nodes, topo.rank, config,
                "the global process set")
            engine = Engine(config, topo.rank, topo.size, dev, control)
        except BaseException:
            process_sets.global_process_set.hierarchy = None
            dist.destroy_process_group()
            raise
        _state.worlds += 1
        _state.topology, _state.device = topo, dev
        _state.control, _state.engine = control, engine
        _state.nodes = nodes
        engine.start()
        if not _state.atexit_registered:
            atexit.register(shutdown)
            _state.atexit_registered = True


def shutdown():
    """Tear the world down (``hvd.shutdown``): every rank calls it."""
    with _state.lock:
        if _state.topology is None:
            return
        _state.engine.shutdown()
        if _state.control is not None:
            # Every rank is past its last use of this world before any
            # destroys it.
            dist.barrier(group=_state.control)
        process_sets.reset()
        dist.destroy_process_group()
        _state.topology = _state.device = _state.engine = None
        _state.control = _state.nodes = None


def _nodes(topo: Topology, control) -> list:
    """Every world rank's node, named by the node's first rank (its rank
    less its local rank), gathered over the controller's group."""
    mine = torch.tensor([topo.rank - topo.local_rank], dtype=torch.int64)
    if control is None:
        return mine.tolist()
    out = torch.empty(topo.size, dtype=torch.int64)
    dist.all_gather_into_tensor(out, mine, group=control)
    return out.tolist()


def is_initialized() -> bool:
    return _state.topology is not None


def _require_init() -> Topology:
    topo = _state.topology
    if topo is None:
        raise ValueError("horovod_tpu_torch has not been initialized; "
                         "call hvd.init() first")
    return topo


def engine():
    """The running engine (``ops/engine.py``)."""
    _require_init()
    return _state.engine


def topology() -> Topology:
    return _require_init()


def nodes() -> list:
    """Every world rank's node (the node's first rank), by world rank."""
    _require_init()
    return _state.nodes


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
