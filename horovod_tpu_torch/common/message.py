"""The negotiation's messages.

Counterpart of ``horovod_tpu/core/src/message.h:46-110``.  A ``Request``
says "this tensor is ready on this rank"; a ``Response`` says "run this
collective now" (several tensors for a fused allreduce); each cycle every
rank sends one ``CycleRequest`` to the coordinator (rank 0), which
answers every rank with one ``CycleResponse``.  They cross the
controller's gloo group pickled (``ops/engine.py``).  The fast path
(``ops/fastpath.py``) rides the same messages: a rank's round report,
thaw request and bucket tokens; rank 0's freeze verdict, go count and
thaw.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

ALLREDUCE = "allreduce"
ALLGATHER = "allgather"
BROADCAST = "broadcast"
ALLTOALL = "alltoall"
REDUCESCATTER = "reducescatter"
BARRIER = "barrier"
JOIN = "join"

# Reduction ops (Horovod's ReduceOp names).
SUM = "Sum"
AVERAGE = "Average"
MIN = "Min"
MAX = "Max"
PRODUCT = "Product"
ADASUM = "Adasum"


class Request:
    """One rank's tensor, ready for a collective.  ``group`` names the
    grouped call a member belongs to (None for none) and ``group_size``
    its member count: a group is negotiated as a whole."""

    __slots__ = ("name", "op_type", "dtype", "shape", "red_op", "prescale",
                 "postscale", "root_rank", "splits", "process_set_id",
                 "group", "group_size", "numel", "nbytes")

    def __init__(self, name: str, op_type: str, dtype=None,
                 shape: Sequence[int] = (), red_op: Optional[str] = None,
                 prescale: float = 1.0, postscale: float = 1.0,
                 root_rank: int = 0, splits: Optional[Sequence[int]] = None,
                 process_set_id: int = 0, group: Optional[str] = None,
                 group_size: int = 0):
        self.name = name
        self.op_type = op_type
        self.dtype = dtype
        self.shape = tuple(shape)
        self.red_op = red_op
        self.prescale = float(prescale)
        self.postscale = float(postscale)
        self.root_rank = int(root_rank)
        self.splits = None if splits is None else [int(s) for s in splits]
        self.process_set_id = int(process_set_id)
        self.group = group
        self.group_size = int(group_size)
        self.numel = math.prod(self.shape)
        self.nbytes = 0 if dtype is None else self.numel * dtype.itemsize

    def signature(self) -> tuple:
        """What every rank must agree on, besides the shape."""
        return (self.op_type, self.dtype, self.red_op, self.process_set_id,
                self.root_rank, self.prescale, self.postscale)

    def __repr__(self):
        return "Request(%s %r %s %s)" % (self.op_type, self.name,
                                         self.dtype, self.shape)


class Response:
    """A negotiated collective: the canonical request of each tensor (one
    per tensor, in execution order), or an error for all of them.
    ``aux``: an allgather's first dimensions in member order, an
    alltoall's splits matrix (row r: what member r sends to each).
    ``join_rewrite``: an Average rewritten to a Sum over the live
    contributors because a joined member did not submit the tensor;
    ``red_op`` and ``postscale`` then differ from the requests'."""

    __slots__ = ("op_type", "requests", "error", "red_op", "postscale",
                 "aux", "last_joined", "join_rewrite")

    def __init__(self, op_type: str, requests: List[Request],
                 error: Optional[str] = None):
        self.op_type = op_type
        self.requests = list(requests)
        self.error = error
        q = requests[0] if requests else None
        self.red_op = q.red_op if q else None
        self.postscale = q.postscale if q else 1.0
        self.aux: List[int] = []
        self.last_joined = -1
        self.join_rewrite = False

    @property
    def names(self) -> List[str]:
        return [q.name for q in self.requests]

    @property
    def process_set_id(self) -> int:
        return self.requests[0].process_set_id if self.requests else 0

    def __repr__(self):
        return "Response(%s %s%s)" % (self.op_type, self.names,
                                      " error" if self.error else "")


class CycleRequest:
    """One rank's message of a cycle: the cache ids of its newly ready
    tensors that the cache knows (a bit each in ``cache_bits``), full
    requests for the rest, and its join and shutdown flags.  The fast
    path's fields: ``round_report``, (index, signature or None) of the
    round that ended last; ``thaw``, (reason, detail) when this rank asks
    for a thaw; ``staging``, whether it stages a frozen round;
    ``buckets``, the tokens of its filled, undispatched buckets, oldest
    first.  ``route_check``: this rank waits in
    ``hvd.check_degraded_routes()``."""

    __slots__ = ("rank", "shutdown", "joined", "cache_bits", "requests",
                 "round_report", "thaw", "staging", "buckets", "route_check")

    def __init__(self, rank: int, shutdown: bool = False,
                 joined: bool = False, cache_bits: int = 0,
                 requests: Optional[List[Request]] = None,
                 round_report: Optional[Tuple[int, Optional[str]]] = None,
                 thaw: Optional[Tuple[str, str]] = None,
                 staging: bool = False,
                 buckets: Optional[List[tuple]] = None):
        self.rank = rank
        self.shutdown = shutdown
        self.joined = joined
        self.cache_bits = cache_bits
        self.requests = requests if requests is not None else []
        self.round_report = round_report
        self.thaw = thaw
        self.staging = staging
        self.buckets = buckets if buckets is not None else []
        self.route_check = False


class CycleResponse:
    """The coordinator's answer of a cycle, the same on every rank:
    responses to execute in order; ``shutdown`` once every rank asked
    for it; ``abort`` (a message) when the engine must fail everything
    outstanding and stop.  The fast path's verdicts: ``freeze``, (the
    round every rank stages from, the schedule's signature); ``go``, how
    many of the oldest frozen buckets every rank dispatches now (0: not
    yet); ``thaw``, (reason, detail) when every rank thaws.  ``routes``:
    once every rank asked for a degraded-route check, rank 0's verdicts
    (``common/resilience.py``; a list, maybe empty), which every rank
    applies before anything else in the cycle; None otherwise."""

    __slots__ = ("responses", "shutdown", "abort", "freeze", "go", "thaw",
                 "routes")

    def __init__(self, responses: Optional[List[Response]] = None,
                 shutdown: bool = False, abort: Optional[str] = None):
        self.responses = responses if responses is not None else []
        self.shutdown = shutdown
        self.abort = abort
        self.freeze: Optional[Tuple[int, str]] = None
        self.go = 0
        self.thaw: Optional[Tuple[str, str]] = None
        self.routes: Optional[List[dict]] = None
