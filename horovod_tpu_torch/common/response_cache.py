"""The response cache: after a tensor's first negotiation, a rank sends
one bit for it instead of its full request.

Counterpart of ``horovod_tpu/core/src/response_cache.{h,cc}``.  The key
is the request's name and every field the ranks must agree on, but not
its shape: a lookup hits only when the shape is the cached one, and a
miss renegotiates in full.  Every rank puts the requests of the executed
responses in the order the coordinator broadcast them, so the ids agree
on every rank; at capacity the least recently put id is evicted and
reused.  Only allreduce, broadcast and reducescatter are cached (the
others carry per-call sizes); the engine keeps grouped members and
join rewrites out (``operations.cc:373-392``, ``:414-444``).
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

from .message import ALLREDUCE, BROADCAST, REDUCESCATTER, Request

CACHEABLE = (ALLREDUCE, BROADCAST, REDUCESCATTER)


class ResponseCache:
    def __init__(self, capacity: int = 1024):
        self.capacity = int(capacity)
        self._ids = {}                       # key -> id
        self._slots = []                     # id -> (key, Request)
        self._lru = collections.OrderedDict()  # id, least recent first
        self.hits = self.misses = 0

    @staticmethod
    def key(q: Request) -> tuple:
        return (q.name,) + q.signature()

    def __len__(self) -> int:
        return len(self._slots)

    def lookup(self, q: Request) -> Optional[int]:
        """The id of a cached request with ``q``'s key and shape."""
        if q.op_type not in CACHEABLE:
            return None
        cid = self._ids.get(self.key(q))
        if cid is None or self._slots[cid][1].shape != q.shape:
            return None
        return cid

    def get(self, cid: int) -> Optional[Request]:
        if 0 <= cid < len(self._slots):
            return self._slots[cid][1]
        return None

    def put(self, q: Request) -> Tuple[int, Optional[Request]]:
        """Cache ``q``; returns its id and the request it evicted."""
        key = self.key(q)
        cid = self._ids.get(key)
        evicted = None
        if cid is None:
            if len(self._slots) < self.capacity:
                cid = len(self._slots)
                self._slots.append(None)
            else:
                cid, _ = self._lru.popitem(last=False)
                old_key, evicted = self._slots[cid]
                del self._ids[old_key]
            self._ids[key] = cid
        self._slots[cid] = (key, q)
        self._lru[cid] = None
        self._lru.move_to_end(cid)
        return cid, evicted
