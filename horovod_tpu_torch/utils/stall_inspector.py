"""Stall inspector: names the tensors some ranks submitted and others did
not, and the ranks missing them.

Counterpart of ``horovod_tpu.utils.stall_inspector.StallInspector`` and
``core/src/stall_inspector.cc``.  It runs on the coordinator (rank 0):
the controller records each rank's readiness as it absorbs the ranks'
cycle messages, and a tensor's record goes when its response is sent.
``check()`` runs once a cycle.  Past ``warning_secs`` it warns, once per
``warning_secs`` for each tensor; past ``shutdown_secs`` (when above 0)
it returns the abort message, "stall shutdown threshold exceeded", with
which every rank's engine fails its outstanding collectives and stops
(``operations.cc:484-493``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

LOG = logging.getLogger("horovod_tpu_torch")


class _Pending:
    __slots__ = ("first_seen", "members", "ready", "last_warn")

    def __init__(self, members: Sequence[int]):
        self.first_seen = time.monotonic()
        self.members = list(members)
        self.ready = set()
        self.last_warn = None


class StallInspector:
    def __init__(self, warning_secs: float = 60.0,
                 shutdown_secs: float = 0.0, enabled: bool = True,
                 reporter: Optional[Callable[[str], None]] = None):
        self.warning_secs = warning_secs
        self.shutdown_secs = shutdown_secs
        self.enabled = enabled and warning_secs > 0
        self._report = reporter or LOG.warning
        self._pending: Dict[str, _Pending] = {}

    def record_ready(self, name: str, rank: int, members: Sequence[int]):
        if not self.enabled:
            return
        p = self._pending.get(name)
        if p is None:
            p = self._pending[name] = _Pending(members)
        p.ready.add(rank)

    def record_done(self, name: str):
        self._pending.pop(name, None)

    def missing(self, name: str) -> List[int]:
        p = self._pending.get(name)
        return [] if p is None else [m for m in p.members
                                     if m not in p.ready]

    def check(self, now: Optional[float] = None) -> Optional[str]:
        """Warn about stalled tensors; the abort message once one is past
        the shutdown threshold, else None."""
        if not self.enabled:
            return None
        now = time.monotonic() if now is None else now
        fatal = None
        for name, p in self._pending.items():
            age = now - p.first_seen
            if age < self.warning_secs:
                continue
            if p.last_warn is None or now - p.last_warn >= self.warning_secs:
                p.last_warn = now
                self._report(
                    "Stalled collective: tensor %r waited %.0f s; ranks %s "
                    "have not submitted it. A rank may have died, or ranks "
                    "may be issuing different collectives."
                    % (name, age, self.missing(name)))
            if self.shutdown_secs > 0 and age >= self.shutdown_secs \
                    and fatal is None:
                fatal = ("stall shutdown threshold exceeded: tensor %r "
                         "waited %.0f s for ranks %s"
                         % (name, age, self.missing(name)))
        return fatal
