"""Process sets: the ranks a collective runs over.

Counterpart of ``horovod_tpu.common.process_sets``: the global set of all
ranks, mapped onto ``torch.distributed``'s default group, and sets of a
subset of ranks, each over a ``torch.distributed.new_group``.  Every rank
of the world calls ``add_process_set`` with the same ranks in the same
order (the reference's contract; ``new_group`` needs every rank of the
world), so the ids agree across the world: every collective carries its
set's id through the engine's negotiation (``process_set_by_id``).
Adding or removing a set thaws a frozen fast-path schedule
(``ops/fastpath.thaw_all``, reason ``membership``) on every rank.  A set
whose ranks span the same number k >= 2 on every node it touches also
gets its hierarchical plane (``hierarchy``: a local group per node and a
cross group per local index, ``ops/multihost.build``), created in the
same order on every rank; any other set stays flat.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

GLOBAL_PROCESS_SET_ID = 0


class ProcessSet:
    """A set of ranks; ``ranks=None`` is the whole world."""

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.ranks: Optional[List[int]] = (
            sorted(set(int(r) for r in ranks)) if ranks is not None else None)
        self.process_set_id: Optional[int] = None
        self._group = None
        # ops/multihost.Hierarchy, or None: every collective flat.
        self.hierarchy = None

    @property
    def group(self):
        """The ``torch.distributed`` group; None is the default group."""
        if self.ranks is not None and self._group is None:
            raise ValueError("%r is not registered; call "
                             "hvd.add_process_set first" % self)
        return self._group

    def included(self) -> bool:
        return self.ranks is None or basics.rank() in self.ranks

    def rank(self) -> int:
        """The caller's rank within the set."""
        if self.ranks is None:
            return basics.rank()
        if basics.rank() not in self.ranks:
            raise ValueError(
                "rank %d is not part of this process set" % basics.rank())
        return self.ranks.index(basics.rank())

    def size(self) -> int:
        return basics.size() if self.ranks is None else len(self.ranks)

    def global_rank(self, set_rank: int) -> int:
        """The world rank of the set's member ``set_rank``."""
        return set_rank if self.ranks is None else self.ranks[set_rank]

    def __eq__(self, other):
        return isinstance(other, ProcessSet) and self.ranks == other.ranks

    def __hash__(self):
        return hash(tuple(self.ranks) if self.ranks is not None else None)

    def __repr__(self):
        return "ProcessSet(id=%s, ranks=%s)" % (
            self.process_set_id,
            "ALL" if self.ranks is None else self.ranks)


global_process_set = ProcessSet(None)
global_process_set.process_set_id = GLOBAL_PROCESS_SET_ID

_lock = threading.Lock()
_registered: Dict[int, ProcessSet] = {}
_next_id = [1]


def add_process_set(process_set) -> ProcessSet:
    """Register a set (a ``ProcessSet`` or a list of ranks) on every rank
    of the world, in the same order everywhere; returns the set."""
    if not isinstance(process_set, ProcessSet):
        process_set = ProcessSet(process_set)
    if process_set.ranks is None:
        raise ValueError("the global process set is always registered")
    world = basics.size()
    fastpath.thaw_all("membership", "process set %s added"
                      % process_set.ranks)
    with _lock:
        for existing in _registered.values():
            if existing == process_set:
                raise ValueError("A process set with the same ranks already "
                                 "exists: %r" % existing)
        bad = [r for r in process_set.ranks if r < 0 or r >= world]
        if bad:
            raise ValueError("Process set ranks %s out of range for world "
                             "size %d" % (bad, world))
        process_set._group = dist.new_group(process_set.ranks)
        process_set.hierarchy = multihost.build(
            process_set.ranks, basics.nodes(), basics.rank(),
            basics.engine().config, "process set %s" % process_set.ranks)
        process_set.process_set_id = _next_id[0]
        _registered[process_set.process_set_id] = process_set
        _next_id[0] += 1
    return process_set


def remove_process_set(process_set: ProcessSet) -> bool:
    """Deregister a set; False for the global set or one not registered."""
    fastpath.thaw_all("membership", "process set %s removed"
                      % process_set.ranks)
    with _lock:
        if _registered.get(process_set.process_set_id) is not process_set:
            return False
        del _registered[process_set.process_set_id]
        group, process_set._group = process_set._group, None
        hier, process_set.hierarchy = process_set.hierarchy, None
        process_set.process_set_id = None
    for g in [group] + ([hier.local_group, hier.cross_group]
                        if hier is not None else []):
        if g is not dist.GroupMember.NON_GROUP_MEMBER:
            dist.destroy_process_group(g)
    return True


def process_set_by_id(process_set_id: int) -> Optional[ProcessSet]:
    """The registered set with this id (0: the global set), or None."""
    if process_set_id == GLOBAL_PROCESS_SET_ID:
        return global_process_set
    with _lock:
        return _registered.get(process_set_id)


def process_set_ids() -> List[int]:
    """The ids of the global set and every registered set."""
    with _lock:
        return [GLOBAL_PROCESS_SET_ID] + sorted(_registered)


def members(process_set_id: int, world: int) -> Optional[List[int]]:
    """The world ranks of set ``process_set_id``, or None when it is not
    registered on this rank."""
    ps = process_set_by_id(process_set_id)
    if ps is None:
        return None
    return list(range(world)) if ps.ranks is None else list(ps.ranks)


def reset():
    """Forget every registered set (the world they belong to is gone)."""
    with _lock:
        for ps in _registered.values():
            ps.process_set_id, ps._group, ps.hierarchy = None, None, None
        _registered.clear()
        _next_id[0] = 1
        global_process_set.hierarchy = None


# Last: ``basics`` imports this module.  A set's rank and size queries
# run per collective on the cycle thread, so not an import each call.
from . import basics  # noqa: E402
from ..ops import fastpath, multihost  # noqa: E402
