"""The negotiation controller: rank 0 joins readiness across ranks.

Counterpart of ``horovod_tpu/core/src/controller.{h,cc}`` with the group
table of ``process_set.h``.  Each cycle every rank sends a
``CycleRequest``; the coordinator (rank 0) absorbs them
(``Controller::Absorb``, ``:121``), checks that the ranks agree on each
tensor's op, dtype, reduce op, scales, root, process set and shape (an
allgather's first dimension and an alltoall's rows may differ), and
answers every rank with the same ``CycleResponse``
(``ComputeResponseList``, ``:202``):

* a tensor is ready once every member of its process set has submitted
  it or joined; a grouped call's members only all at once; cache bits
  and full requests of one name negotiate as one (a rank that changed a
  cached tensor's shape alone meets the others' bits and fails them);
* a joined member that did not submit a tensor contributes zeros to a
  Sum, turns an Average into a Sum divided by the live contributors, and
  makes every other op an error (``ApplyJoinPolicy``, ``:22-55``);
* an allgather's response carries the members' first dimensions, an
  alltoall's the members' splits;
* ready allreduces of one dtype, reduce op, scales and process set fuse,
  in order, while their bytes stay within the fusion threshold
  (``FuseResponses``, ``:330``), a grouped call's members only with each
  other; errors never fuse, and Adasum allreduces of one key go out as
  one response whatever their bytes, executed tensor by tensor (no
  shared buffer);
* ``join`` completes when every rank has joined, with the last rank to
  join; ``shutdown`` when every rank has asked for it;
* the stall inspector's abort message rides the response as ``abort``;
* the degraded-route check (``hvd.check_degraded_routes``) completes when
  every rank has asked for it: rank 0's verdicts ride the response as
  ``routes`` (the reference publishes them through its rendezvous KV);
* the fast path's verdicts (``ops/fastpath.py``): rank 0 freezes once
  every rank reported the same freezable round signature for ``warm``
  rounds in a row (a round index completes when every rank has reported
  it) and no join is in progress, naming the round two after the one
  that completed the streak; while frozen it answers go for the bucket
  tokens every rank presented, not yet when some rank has not filled
  its next bucket (the stall inspector watches such a bucket as it
  watches a tensor), and thaw on a thaw request, a join, a shutdown,
  tokens that disagree, or negotiated requests once any rank stages.

In a one-rank world nothing is sent (``controller.cc:86-91``).  The wire
is a gloo group: ``GlooTransport`` gathers the ranks' messages on rank 0
and broadcasts its answer, pickled into fixed frames.
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, List, Optional, Sequence

from .message import (ADASUM, ALLGATHER, ALLREDUCE, ALLTOALL, AVERAGE,
                      BARRIER, BROADCAST, JOIN, REDUCESCATTER, SUM,
                      CycleRequest, CycleResponse, Request, Response)
from . import resilience
from .response_cache import ResponseCache
from ..utils.stall_inspector import StallInspector


def _bucket_name(token: tuple) -> str:
    return "fastpath.round%d.bucket%d" % token[:2]


class _FpCycle:
    """What this cycle's messages said to the fast path."""

    __slots__ = ("thaw", "joined", "shutdown", "negotiated", "staging",
                 "tokens")

    def __init__(self):
        self.thaw = None
        self.joined = self.shutdown = False
        self.negotiated = self.staging = False
        self.tokens: Dict[int, list] = {}


class _Pending:
    __slots__ = ("request", "ranks", "shapes", "splits", "error")

    def __init__(self, request: Request):
        self.request = request
        self.ranks = set()
        self.shapes: Dict[int, tuple] = {}
        self.splits: Dict[int, List[int]] = {}
        self.error: Optional[str] = None


def _disagreement(q: Request, c: Request) -> Optional[str]:
    """Why ``q`` (one rank's request) cannot join ``c`` (the first
    rank's), or None."""
    if q.signature() != c.signature() or \
            (q.group, q.group_size) != (c.group, c.group_size):
        return ("Mismatched collective for tensor %r: ranks disagree on "
                "op, dtype, reduce op, scales, root, process set or group "
                "(%s vs %s)" % (q.name, q.signature(), c.signature()))
    if q.op_type in (ALLREDUCE, REDUCESCATTER, BROADCAST):
        if q.shape != c.shape:
            return "Mismatched shape for tensor %r: %s vs %s" % (
                q.name, list(q.shape), list(c.shape))
    elif q.op_type in (ALLGATHER, ALLTOALL):
        if len(q.shape) != len(c.shape) or q.shape[1:] != c.shape[1:]:
            return ("Mismatched %s trailing dims for tensor %r: %s vs %s"
                    % (q.op_type, q.name, list(q.shape), list(c.shape)))
    return None


class Controller:
    """Negotiation state.  ``members_of(process_set_id)`` gives a set's
    world ranks, or None for an id not (yet) registered on this rank;
    ``transport`` carries the cycle messages (None in a one-rank
    world)."""

    def __init__(self, rank: int, size: int, cache: ResponseCache,
                 stall: StallInspector, fusion_threshold: int,
                 members_of: Callable[[int], Optional[Sequence[int]]],
                 transport=None, freezer=None):
        self.rank, self.size = rank, size
        self.cache = cache
        self.stall = stall
        self.fusion_threshold = int(fusion_threshold)
        self._members_of = members_of
        self._transport = transport
        self._pending: Dict[str, _Pending] = {}
        self._cache_ready: Dict[int, set] = {}
        self._joined: List[int] = []
        self._shutdown = set()
        self._route_checks = set()  # ranks waiting for a route check
        # Fast path (rank 0): ``freezer`` counts the world's warm streak
        # (``ops/fastpath.ScheduleFreezer``; None: no fast path).
        self._fp = freezer
        self._fp_reports: Dict[int, Dict[int, Optional[str]]] = {}
        self._fp_world: Optional[tuple] = None  # (start, sig) in force
        self._fp_staging = False  # a rank stages the frozen schedule
        self._fp_watched = set()  # bucket names in the stall inspector
        self._fp_cycle = _FpCycle()

    # -- one cycle ------------------------------------------------------------

    def run_cycle(self, mine: CycleRequest) -> CycleResponse:
        if self.size == 1:
            self.absorb(mine)
            return self.compute_response_list()
        if self.rank == 0:
            for msg in self._transport.gather(mine):
                self.absorb(msg)
            resp = self.compute_response_list()
            self._transport.broadcast(resp)
            return resp
        self._transport.gather(mine)
        return self._transport.broadcast(None)

    # -- coordinator ----------------------------------------------------------

    def _record_ready(self, q: Request, rank: int):
        if self.stall.enabled:
            members = self._members_of(q.process_set_id)
            self.stall.record_ready(q.name, rank, members if members
                                    is not None else [rank])

    def absorb(self, req: CycleRequest):
        """Fold one rank's cycle message into the pending state."""
        cyc = self._fp_cycle
        if req.round_report is not None:
            index, sig = req.round_report
            mine = self._fp_reports.setdefault(req.rank, {})
            mine[index] = sig
            for old in [i for i in mine if i < index - 8]:
                del mine[old]
        if req.thaw is not None and cyc.thaw is None:
            cyc.thaw = (req.thaw[0], "rank %d: %s" % (req.rank, req.thaw[1]))
        cyc.joined |= req.joined
        cyc.shutdown |= req.shutdown
        cyc.negotiated |= bool(req.requests or req.cache_bits)
        cyc.staging |= req.staging
        cyc.tokens[req.rank] = req.buckets
        if req.shutdown:
            self._shutdown.add(req.rank)
        if req.joined and req.rank not in self._joined:
            self._joined.append(req.rank)
        if req.route_check:
            self._route_checks.add(req.rank)
        bits = req.cache_bits
        while bits:
            low = bits & -bits
            bits ^= low
            cid = low.bit_length() - 1
            q = self.cache.get(cid)
            if q is None:
                raise RuntimeError("rank %d sent cache id %d, which this "
                                   "rank's cache does not hold"
                                   % (req.rank, cid))
            self._cache_ready.setdefault(cid, set()).add(req.rank)
            self._record_ready(q, req.rank)
        for q in req.requests:
            p = self._pending.get(q.name)
            if p is None:
                p = self._pending[q.name] = _Pending(q)
            p.ranks.add(req.rank)
            p.shapes[req.rank] = q.shape
            if q.splits is not None:
                p.splits[req.rank] = q.splits
            self._record_ready(q, req.rank)
            if p.error is None:
                p.error = _disagreement(q, p.request)

    def evicted(self, cid: int, q: Request):
        """The cache reused id ``cid``, which held ``q``: bits already
        absorbed for it become full requests of ``q``."""
        ranks = self._cache_ready.pop(cid, None)
        if not ranks:
            return
        p = self._pending.get(q.name)
        if p is None:
            p = self._pending[q.name] = _Pending(q)
        for r in ranks:
            p.ranks.add(r)
            p.shapes[r] = q.shape

    def _ready(self, have, members) -> bool:
        """Every member submitted or joined, and one submitted."""
        return members is not None and bool(have) and all(
            m in have or m in self._joined for m in members)

    def apply_join_policy(self, q: Request, members: Sequence[int],
                          contributed, r: Response):
        """``ApplyJoinPolicy``: a joined member that did not submit ``q``
        contributes zeros, which only Sum and Average (over the live
        contributors) can take."""
        missing = sum(1 for m in members
                      if m in self._joined and m not in contributed)
        if not missing or q.op_type == BARRIER:
            return
        if q.op_type != ALLREDUCE:
            r.error = ("Join supports allreduce only: %s %r has joined "
                       "members that did not submit it"
                       % (q.op_type, q.name))
        elif q.red_op == AVERAGE:
            r.red_op = SUM
            r.postscale = q.postscale / (len(members) - missing)
            r.join_rewrite = True
        elif q.red_op != SUM:
            r.error = ("Join zero-contribution supports Sum/Average "
                       "allreduce only (tensor %r, op %s)"
                       % (q.name, q.red_op))

    def compute_response_list(self) -> CycleResponse:
        out = CycleResponse(shutdown=len(self._shutdown) == self.size)
        responses: List[Response] = []
        sets: Dict[int, Optional[Sequence[int]]] = {}

        def members_of(psid):
            if psid not in sets:
                sets[psid] = self._members_of(psid)
            return sets[psid]

        for cid, ranks in list(self._cache_ready.items()):
            q = self.cache.get(cid)
            p = self._pending.get(q.name)
            if p is not None:
                # Other ranks sent this name in full (another shape or
                # signature): their requests and these bits negotiate as
                # one, so the disagreement fails every rank's handle.
                del self._cache_ready[cid]
                for r in ranks:
                    p.ranks.add(r)
                    p.shapes[r] = q.shape
                if p.error is None:
                    p.error = _disagreement(q, p.request)
                continue
            members = members_of(q.process_set_id)
            if members is None or not self._ready(ranks, members):
                continue
            del self._cache_ready[cid]
            self.cache.hits += 1
            r = Response(q.op_type, [q])
            self.apply_join_policy(q, members, ranks, r)
            self.stall.record_done(q.name)
            responses.append(r)

        group_ready: Dict[str, bool] = {}

        def whole(group: str, size: int) -> bool:
            if group not in group_ready:
                mates = [p for p in self._pending.values()
                         if p.request.group == group]
                group_ready[group] = len(mates) == size and all(
                    p.error is not None or self._ready(
                        p.ranks, members_of(p.request.process_set_id))
                    for p in mates)
            return group_ready[group]

        done = []
        for name, p in self._pending.items():
            q = p.request
            members = members_of(q.process_set_id)
            if members is None:
                continue
            if q.group is not None:
                if not whole(q.group, q.group_size):
                    continue
            elif p.error is None and not self._ready(p.ranks, members):
                continue
            r = Response(q.op_type, [q], p.error)
            if r.error is None:
                self.apply_join_policy(q, members, p.ranks, r)
            if r.error is None and q.op_type == ALLGATHER:
                r.aux = [p.shapes[m][0] if p.shapes.get(m) else 0
                         for m in members]
            elif r.error is None and q.op_type == ALLTOALL:
                r.aux = [s for m in members
                         for s in p.splits.get(m, [0] * len(members))]
            self.cache.misses += 1
            self.stall.record_done(name)
            responses.append(r)
            done.append(name)
        for name in done:
            del self._pending[name]

        out.responses = self.fuse_responses(responses)
        # The join completes after the tensors it made ready.
        if self._joined and len(self._joined) == self.size:
            r = Response(JOIN, [])
            r.last_joined = self._joined[-1]
            out.responses.append(r)
            self._joined = []
        out.abort = self.stall.check()
        if len(self._route_checks) == self.size:
            # Rank 0's own streaks and re-probe clock decide for the world.
            out.routes = resilience.decide_routes()
            self._route_checks.clear()
        self._fp_verdict(out)
        return out

    def _fp_verdict(self, out: CycleResponse):
        """The fast path's part of this cycle's answer (rank 0)."""
        cyc, self._fp_cycle = self._fp_cycle, _FpCycle()
        thaw = cyc.thaw
        if thaw is None and self._fp_world is not None:
            self._fp_staging |= cyc.staging
            if cyc.joined or self._joined:
                thaw = ("membership", "a rank joined")
            elif cyc.shutdown:
                thaw = ("membership", "a rank shuts down")
            elif self._fp_staging and (cyc.negotiated or self._pending
                                       or self._cache_ready):
                thaw = ("membership", "negotiated requests while frozen")
            else:
                thaw = self._fp_disagreement(cyc.tokens)
        elif thaw is None and any(cyc.tokens.values()):
            thaw = ("shape", "bucket tokens while not frozen")
        if thaw is not None:
            out.thaw = thaw
            self._fp_world, self._fp_staging = None, False
            self._fp_reports.clear()
            for name in self._fp_watched:
                self.stall.record_done(name)
            self._fp_watched.clear()
            if self._fp is not None:
                self._fp.reset_streak()
            return
        if self._fp_world is not None:
            lists = [cyc.tokens.get(r, []) for r in range(self.size)]
            out.go = min(len(t) for t in lists)
            # A bucket some ranks filled and others have not is watched
            # as a tensor some ranks submitted: a rank that stops filling
            # its buckets is named, and past the shutdown threshold the
            # world aborts.
            for tok in lists[0][:out.go]:
                self._fp_watched.discard(_bucket_name(tok))
                self.stall.record_done(_bucket_name(tok))
            for r, t in enumerate(lists):
                for tok in t[out.go:]:
                    self._fp_watched.add(_bucket_name(tok))
                    self.stall.record_ready(_bucket_name(tok), r,
                                            range(self.size))
            return
        if self._fp is None:
            return
        # A round index completes when every rank has reported it; at
        # most one completes a cycle (a rank's report of the next round
        # follows the slowest rank's requests for it).
        done = None
        while self._fp_reports and len(self._fp_reports) == self.size:
            common = set.intersection(*(set(m) for m in
                                        self._fp_reports.values()))
            if not common:
                break
            index = min(common)
            sigs = {m.pop(index) for m in self._fp_reports.values()}
            for m in self._fp_reports.values():
                for old in [i for i in m if i < index]:
                    del m[old]
            sig = sigs.pop() if len(sigs) == 1 else None
            done = (index, sig, self._fp.observe(sig))
        if done is None or not done[2]:
            return
        if cyc.joined or self._joined or cyc.shutdown:
            self._fp.reset_streak()  # a refused freeze re-warms
            return
        self._fp_world = (done[0] + 2, done[1])
        self._fp_reports.clear()
        out.freeze = self._fp_world

    def _fp_disagreement(self, tokens: Dict[int, list]) -> Optional[tuple]:
        """A thaw when the ranks' bucket tokens differ where every rank
        has one."""
        lists = [tokens.get(r, []) for r in range(self.size)]
        for k in range(min(len(t) for t in lists)):
            if any(t[k] != lists[0][k] for t in lists):
                bad = next(r for r, t in enumerate(lists)
                           if t[k] != lists[0][k])
                return ("shape", "rank %d presented bucket %s, rank 0 %s"
                        % (bad, lists[bad][k], lists[0][k]))
        return None

    def fuse_responses(self, responses: List[Response]) -> List[Response]:
        """Pack ready allreduces of one key into fused responses, in
        order, while the cumulative bytes stay within the threshold (a
        tensor larger than it goes alone); the others pass through
        first, as ``FuseResponses`` orders them.  A grouped call's
        members fuse only with each other (upstream Horovod's
        ``HOROVOD_DISABLE_GROUP_FUSION``), so a group's buffers do not
        depend on what else was ready in its cycle.  Adasum builds no
        buffer (each tensor is reduced alone), so its allreduces of one
        key join one response past the threshold: the executor then
        pays its per-response work once for them, not per tensor."""
        out: List[Response] = []
        open_: Dict[tuple, list] = {}
        for r in responses:
            if r.op_type != ALLREDUCE or r.error:
                out.append(r)
                continue
            q = r.requests[0]
            key = (q.process_set_id, q.dtype, r.red_op, q.prescale,
                   r.postscale, r.join_rewrite, q.group)
            cur = open_.get(key)
            if cur is not None and (
                    r.red_op == ADASUM
                    or cur[1] + q.nbytes <= self.fusion_threshold):
                cur[0].requests.append(q)
                cur[1] += q.nbytes
            else:
                if cur is not None:
                    out.append(cur[0])
                open_[key] = [r, q.nbytes]
        out.extend(r for r, _ in open_.values())
        return out


class GlooTransport:
    """The controller's wire over a gloo group of the whole world.  A
    message is pickled into a fixed frame (an 8-byte length, then the
    first bytes); one that does not fit sends the rest in a second
    collective, which every rank can tell from the frames' lengths."""

    FRAME = 4096

    def __init__(self, rank: int, size: int, group):
        self.rank, self.size, self.group = rank, size, group

    def _frame(self, data: bytes):
        import torch
        head = len(data).to_bytes(8, "little") + data[:self.FRAME - 8]
        frame = torch.zeros(self.FRAME, dtype=torch.uint8)
        frame[:len(head)] = torch.frombuffer(bytearray(head),
                                             dtype=torch.uint8)
        return frame

    @staticmethod
    def _length(frame) -> int:
        return int.from_bytes(frame[:8].numpy().tobytes(), "little")

    def gather(self, obj) -> Optional[list]:
        """Every rank's ``obj`` on rank 0 (None elsewhere)."""
        import torch
        import torch.distributed as dist
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        frames = [torch.empty(self.FRAME, dtype=torch.uint8)
                  for _ in range(self.size)]
        dist.all_gather(frames, self._frame(data), group=self.group)
        lens = [self._length(f) for f in frames]
        extra = max(lens) - (self.FRAME - 8)
        rests = None
        if extra > 0:
            rest = torch.zeros(extra, dtype=torch.uint8)
            tail = data[self.FRAME - 8:]
            if tail:
                rest[:len(tail)] = torch.frombuffer(bytearray(tail),
                                                    dtype=torch.uint8)
            rests = ([torch.empty(extra, dtype=torch.uint8)
                      for _ in range(self.size)] if self.rank == 0 else None)
            dist.gather(rest, rests, dst=0, group=self.group)
        if self.rank != 0:
            return None
        out = []
        for i, (f, n) in enumerate(zip(frames, lens)):
            b = f[8:8 + min(n, self.FRAME - 8)].numpy().tobytes()
            if n > self.FRAME - 8:
                b += rests[i][:n - (self.FRAME - 8)].numpy().tobytes()
            out.append(pickle.loads(b))
        return out

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank."""
        import torch
        import torch.distributed as dist
        if self.rank == 0:
            data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
            frame = self._frame(data)
        else:
            frame = torch.empty(self.FRAME, dtype=torch.uint8)
        dist.broadcast(frame, src=0, group=self.group)
        n = self._length(frame)
        inline = self.FRAME - 8
        if n <= inline:
            return obj if self.rank == 0 else pickle.loads(
                frame[8:8 + n].numpy().tobytes())
        if self.rank == 0:
            rest = torch.frombuffer(bytearray(data[inline:]),
                                    dtype=torch.uint8)
        else:
            rest = torch.empty(n - inline, dtype=torch.uint8)
        dist.broadcast(rest, src=0, group=self.group)
        if self.rank == 0:
            return obj
        return pickle.loads(frame[8:].numpy().tobytes()
                            + rest.numpy().tobytes())
