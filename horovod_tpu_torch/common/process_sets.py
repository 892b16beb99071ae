"""Process sets: the ranks a collective runs over.

The global part of ``horovod_tpu.common.process_sets``: the set of all
ranks, mapped onto ``torch.distributed``'s default group.  Sets of a
subset of ranks (``torch.distributed.new_group``) come with a later
slice.
"""

from __future__ import annotations


class ProcessSet:
    """All ranks of the world (``ranks=None``)."""

    process_set_id = 0
    ranks = None

    @property
    def group(self):
        """The ``torch.distributed`` group; None is the default group."""
        return None

    def included(self) -> bool:
        return True

    def rank(self) -> int:
        from . import basics
        return basics.rank()

    def size(self) -> int:
        from . import basics
        return basics.size()

    def __repr__(self):
        return "ProcessSet(id=0, ranks=ALL)"


global_process_set = ProcessSet()
