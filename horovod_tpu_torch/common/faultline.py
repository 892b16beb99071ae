"""Fault-injection plane: named injection sites at the failure-critical
seams of the data plane.

Counterpart of ``horovod_tpu.common.faultline`` (``Spec``, ``parse``,
``armed``, ``site``, ``reset``).  A test arms a site through one env
var and the code at the seam misbehaves on demand:

    HVD_TPU_FAULT=<site>:<action>[:<arg>][@<cond>=<val>...][,<spec>...]

Actions: ``delay`` sleeps ``arg`` seconds (0.25); ``drop`` makes
``site()`` return True, and the caller skips the guarded operation;
``die`` is ``os._exit(arg)`` (43); ``wedge`` sleeps ``arg`` seconds
(3600).  Conditions select the process that fires: ``@rank``,
``@slot``, ``@host``, ``@epoch``, ``@tenant``, ``@shard`` compare with
an environment variable at fire time; ``@times=N`` fires at most N
times and ``@after=N`` skips the first N eligible fires, both counted
per site in this process and reset when the value is re-armed.

The whole ``SITES`` table and ``DROP_SITES`` are the reference's, so
that one ``HVD_TPU_FAULT`` value parses the same in both packages,
errors included; the port plants the data plane's sites only
(``mh.leg.*``, ``mh.deadline.wedge``, ``mh.drain.record``,
``mh.enqueue.pre_register``, ``engine.cycle.pre``,
``engine.fastpath.stale_dispatch``, ``hvd.shutdown.*``).  One
difference: ``@rank`` reads ``HOROVOD_RANK`` and, when that is unset,
``RANK``, which torch launchers set.  Parsing is strict: an unknown
site, action or condition key raises at first use.  The
``fault_injections_total{site,action}`` counter and the ``fault_fire``
event are written before the action runs, so that a ``die`` still
shows.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Dict, Optional, Tuple

from . import metrics

LOG = logging.getLogger("horovod_tpu_torch")

# The reference's canonical site table, whole (its C++ sites included):
# a spec naming any of them parses here as it does there.
SITES: Dict[str, str] = {
    "core.enqueue.pre_insert":
        "C++ core, CoreState::Enqueue: after the handle is parked, "
        "before the tensor-queue insert makes the Request visible to "
        "the controller (post-fix seam; a delay here must be harmless)",
    "core.enqueue.legacy_order":
        "C++ core, CoreState::Enqueue: arming this REVERSES the "
        "enqueue ordering to the pre-fix race (Request visible to the "
        "controller before the handle is parked); the action fires in "
        "the vulnerability window",
    "engine.cycle.pre":
        "in-process engine, CollectiveEngine._run_cycle entry: before "
        "a negotiated batch executes",
    "mh.enqueue.pre_register":
        "multihost engine, MultihostEngine._enqueue: inside the engine "
        "lock, before the control-plane registration (enqueue+park "
        "atomicity window)",
    "mh.drain.record":
        "multihost engine, executor drain loop: a negotiated record "
        "was popped but not yet dispatched (drop = negotiated-but-"
        "never-dispatched member, the watchdog scenario)",
    "mh.leg.drop":
        "data-plane leg guard, resilience.run_hier_leg: one attempt of "
        "a hier cross-host leg (drop = the attempt fails with a "
        "synthetic transport fault before dispatch, exercising the "
        "retry/backoff path; a drop without @times proves retry "
        "exhaustion -> flat fallback -> demotion streaks)",
    "mh.leg.delay":
        "data-plane leg guard, resilience.run_hier_leg: latency "
        "injection at the top of each hier leg attempt (delay = a "
        "slow-but-healthy DCN leg; the leg must complete with a "
        "bounded latency hit and no retry)",
    "mh.leg.corrupt":
        "data-plane leg guard, resilience.run_hier_leg: the wire-"
        "integrity verify of a quantized hier leg (drop = the observed "
        "CRC32 diverges from the staged one, a simulated in-flight bit "
        "flip; the guard must re-stage exactly once, then escalate "
        "loudly — never absorb silently)",
    "engine.fastpath.stale_dispatch":
        "steady-state fast path, the frozen-schedule bucket-dispatch "
        "seam (CollectiveEngine._fp_stage and MultihostEngine."
        "_fp_stage): a completed overlap bucket is about to dispatch "
        "off the frozen schedule (drop = the schedule is treated as "
        "stale at dispatch time: the engine thaws loudly with "
        "reason=staleness and pushes the bucket's tensors back "
        "through full negotiation — values must stay correct and "
        "nothing may hang)",
    "mh.deadline.wedge":
        "multihost engine, MultihostEngine._execute: after the group "
        "is deadline-stamped and watched, before dispatch (drop = the "
        "dispatch is withheld so the group wedges until its "
        "per-collective deadline expires -> error-complete -> poison "
        "-> elastic restore, never a stall-inspector abort)",
    "hvd.shutdown.pre_barrier":
        "common/multihost.py shutdown_jax_distributed: before the "
        "synchronized teardown barrier",
    "hvd.shutdown.post_barrier":
        "common/multihost.py shutdown_jax_distributed: after the "
        "barrier, before jax.distributed.shutdown()",
    "elastic.rendezvous.poll":
        "elastic worker, WorkerNotificationManager.rendezvous: top of "
        "each driver poll iteration (drop = skip this poll)",
    "elastic.rejoin.reinit":
        "elastic state, run() retry loop: before each "
        "_reset_and_reinit attempt",
    "elastic.state.commit":
        "elastic state, State.commit entry: the per-batch checkpoint "
        "seam (die here = mid-training hardware failure)",
    "runner.rpc.request":
        "runner control-plane RPC, request_with_retry: each attempt of "
        "a retried rendezvous-KV or message-service call (drop = the "
        "attempt fails with a synthetic transient connection reset, "
        "exercising the backoff path; a drop without @times proves "
        "retry exhaustion)",
    "elastic.discovery.run":
        "elastic driver, HostManager.update_available_hosts entry: one "
        "discovery pass (drop = the pass raises DiscoveryFailure, a "
        "transient discovery flake; the driver keeps the last good "
        "host view up to HOROVOD_DISCOVERY_FAILURE_THRESHOLD)",
    "driver.spawn.attempt":
        "elastic driver, _spawn_workers: one worker-spawn attempt for "
        "one slot (drop = the carrier declines the spawn, exercising "
        "the exponential respawn backoff)",
    "worker.preempt.sigterm":
        "elastic state, State.check_drain: the preemption-notice seam "
        "(drop = a synthetic SIGTERM/preemption notice arrives at this "
        "worker right now, entering the drain protocol exactly as a "
        "real cloud preemption would)",
    "driver.drain.ack":
        "elastic driver, _handle drain message: the drain-ack seam "
        "(drop = the driver loses the worker's drain notice; the "
        "distinguished drain exit code is then the only planned-"
        "removal signal)",
    "elastic.state.spill":
        "elastic spill, write: one durable commit spill for one rank "
        "(drop = the write is torn mid-blob, leaving a truncated file "
        "the CRC-checked restore must detect and skip)",
    "elastic.state.shard":
        "sharded spill, shardspill.write_commit: one shard blob of one "
        "sharded durable commit (drop = that shard's copy lands torn "
        "mid-payload; target one shard index with @shard= — the "
        "per-shard CRC fallback must adopt a buddy copy of the SAME "
        "commit instead of discarding it)",
    "scheduler.admit":
        "pod scheduler, PodScheduler.admit entry: one tenant admission "
        "request (drop = the admission is refused as if the pod had no "
        "capacity; running tenants must be untouched by the refusal)",
    "scheduler.preempt.notice":
        "pod scheduler, the scheduler->tenant-driver preemption seam "
        "(drop = the preemption order is lost this scheduling tick; "
        "the replanner must re-issue it on the next tick — preemption "
        "application is idempotent)",
    "tenant.worker.die":
        "elastic state, State.commit: the tenant-targeted kill seam "
        "(die/wedge conditioned @tenant=<id> takes down one tenant's "
        "workers at the commit boundary; isolation certification "
        "asserts the OTHER tenants' worlds keep advancing)",
    "serving.request.drop":
        "serving router, Router.submit: one inference request at the "
        "admission seam (drop = the request is refused before it ever "
        "queues, outcome=dropped; certifies the router's terminal-"
        "outcome accounting and that refused admissions never disturb "
        "queued traffic)",
    "serving.replica.die":
        "serving replica, the batch-execution seam (in-process replica "
        "loop AND the process-mode serve_from_queue loop): die/wedge "
        "takes a replica down mid-service — the hot-swap e2e certifies "
        "no request is lost (claimed work is requeued and served by "
        "survivors, who elect the newest model version)",
    "serving.swap.stall":
        "serving replica, the weight hot-swap seam (swap_to / replica "
        "swap check): delay/wedge stalls a replica's version load — "
        "requests must keep queueing (zero downtime) and the other "
        "replicas must keep serving while one swap drags",
    "kv.server.die":
        "rendezvous KV server, the per-request seam (every KV verb): "
        "drop = the request is answered 503 (a transient the client's "
        "retry layer must absorb); die = the KV server process dies "
        "mid-service — the HA e2e certifies the warm standby promotes "
        "within the lease and clients rotate to it",
    "kv.journal.torn":
        "control-plane journal, ControlJournal.append: one WAL record "
        "(drop = the record lands truncated mid-payload, the shape a "
        "power loss mid-fsync leaves; replay must skip it loudly and "
        "resync at the next magic boundary)",
    "kv.standby.partition":
        "KV standby, the journal-tail poll loop (drop = one "
        "replication poll is lost; sustained loss past "
        "HOROVOD_CONTROL_LEASE_SECS promotes the standby, exercising "
        "the split-brain term fencing when the old leader resurfaces)",
}

ACTIONS = ("delay", "drop", "die", "wedge")

# Sites whose plant honors site()'s return value (the guarded
# operation is actually skipped on True).  ``drop`` anywhere else is
# rejected at parse time: it would fire, return True into the void,
# and the test arming it would pass vacuously — exactly the silent
# no-op this module exists to forbid.
DROP_SITES = frozenset({
    "engine.fastpath.stale_dispatch",
    "mh.drain.record",
    "mh.leg.drop",
    "mh.leg.corrupt",
    "mh.deadline.wedge",
    "elastic.rendezvous.poll",
    "runner.rpc.request",
    "elastic.discovery.run",
    "driver.spawn.attempt",
    "worker.preempt.sigterm",
    "driver.drain.ack",
    "elastic.state.spill",
    "elastic.state.shard",
    "scheduler.admit",
    "scheduler.preempt.notice",
    "serving.request.drop",
    "kv.server.die",
    "kv.journal.torn",
    "kv.standby.partition",
})

_COND_ENV = {
    "rank": "HOROVOD_RANK",
    "slot": "HOROVOD_ELASTIC_SLOT",
    "host": "HOROVOD_HOSTNAME",
    "epoch": "HOROVOD_ELASTIC_EPOCH",
    # Multi-tenant pods: one env value travels to EVERY tenant's
    # workers; @tenant= selects one tenant's processes (the scheduler
    # exports HOROVOD_TENANT_ID per tenant) so isolation tests can
    # kill tenant A while asserting tenant B's progress.
    "tenant": "HOROVOD_TENANT_ID",
    # Sharded spills: the writer stamps HVD_TPU_SHARD_INDEX just
    # before each shard blob write (elastic/shardspill.py), so
    # @shard=<idx> tears exactly one shard of a multi-shard commit —
    # the per-shard-fallback certification needs the buddy copy of the
    # SAME shard index to survive.
    "shard": "HVD_TPU_SHARD_INDEX",
}

_DEFAULT_ARG = {"delay": 0.25, "die": 43.0, "wedge": 3600.0}
# Torch launchers export RANK, Horovod's HOROVOD_RANK.
_RANK_FALLBACK = "RANK"


def _cond_value(key: str) -> Optional[str]:
    value = os.environ.get(_COND_ENV[key])
    if value is None and key == "rank":
        value = os.environ.get(_RANK_FALLBACK)
    return value


@dataclasses.dataclass(frozen=True)
class Spec:
    site: str
    action: str
    arg: float
    conds: Tuple[Tuple[str, str], ...] = ()
    # Fire-count gates over this process's count of eligible fires at
    # the site: skip the first ``after``, then fire at most ``times``
    # (None: no bound).
    times: Optional[int] = None
    after: int = 0

    def conditions_met(self) -> bool:
        return all(_cond_value(key) == want for key, want in self.conds)


def parse(text: str) -> Dict[str, Spec]:
    """Parse an ``HVD_TPU_FAULT`` value; strict (raises ValueError)."""
    specs: Dict[str, Spec] = {}
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        head, _, cond_text = raw.partition("@")
        parts = head.split(":")
        if len(parts) < 2 or len(parts) > 3:
            raise ValueError(
                "HVD_TPU_FAULT spec %r: expected "
                "<site>:<action>[:<arg>][@cond=val...]" % raw)
        site_name, action = parts[0].strip(), parts[1].strip()
        if site_name not in SITES:
            raise ValueError(
                "HVD_TPU_FAULT names unknown site %r (known: %s)"
                % (site_name, sorted(SITES)))
        if action not in ACTIONS:
            raise ValueError(
                "HVD_TPU_FAULT site %r: unknown action %r (known: %s)"
                % (site_name, action, list(ACTIONS)))
        if action == "drop" and site_name not in DROP_SITES:
            raise ValueError(
                "HVD_TPU_FAULT site %r does not implement drop (skip) "
                "semantics; drop-capable sites: %s"
                % (site_name, sorted(DROP_SITES)))
        arg = _DEFAULT_ARG.get(action, 0.0)
        if len(parts) == 3 and parts[2].strip():
            try:
                arg = float(parts[2])
            except ValueError:
                raise ValueError(
                    "HVD_TPU_FAULT site %r: non-numeric arg %r"
                    % (site_name, parts[2]))
        conds = []
        times: Optional[int] = None
        after = 0
        if cond_text:
            for tok in cond_text.split("@"):
                key, eq, val = tok.partition("=")
                key = key.strip()
                if eq and key in ("times", "after"):
                    try:
                        count = int(val)
                    except ValueError:
                        count = -1
                    if count < 0:
                        raise ValueError(
                            "HVD_TPU_FAULT site %r: @%s wants a "
                            "non-negative integer, got %r"
                            % (site_name, key, val))
                    if key == "times":
                        times = count
                    else:
                        after = count
                    continue
                if not eq or key not in _COND_ENV:
                    raise ValueError(
                        "HVD_TPU_FAULT site %r: bad condition %r "
                        "(known keys: %s)"
                        % (site_name, tok,
                           sorted(_COND_ENV) + ["after", "times"]))
                conds.append((key, val.strip()))
        if site_name in specs:
            raise ValueError(
                "HVD_TPU_FAULT arms site %r twice" % site_name)
        specs[site_name] = Spec(site_name, action, arg, tuple(conds),
                                times, after)
    return specs


_cache: Optional[Dict[str, Spec]] = None
_cache_env: Optional[str] = None
# Per-site count of eligible fires, for @times/@after; reset when the
# value is re-armed.  Locked: sites fire from the caller's, the cycle and
# the watchdog threads.
_fired: Dict[str, int] = {}
_fired_lock = threading.Lock()


def _specs() -> Dict[str, Spec]:
    """The specs of the current ``HVD_TPU_FAULT`` value (parsed again
    when it changes: tests arm and disarm within one process)."""
    global _cache, _cache_env
    env = os.environ.get("HVD_TPU_FAULT")
    if env != _cache_env:
        _cache = parse(env) if env else {}
        _cache_env = env
        _fired.clear()
    return _cache or {}


def reset():
    """Drop the parse cache and the fire counters (tests)."""
    global _cache, _cache_env
    _cache = None
    _cache_env = None
    _fired.clear()


def armed(name: str) -> Optional[Spec]:
    """The spec arming ``name`` in this process now, else None; fires
    nothing."""
    if name not in SITES:
        raise KeyError(
            "faultline.site(%r): not in the canonical SITES table; "
            "register it (and document it) before planting" % name)
    spec = _specs().get(name)
    if spec is None or not spec.conditions_met():
        return None
    return spec


def site(name: str) -> bool:
    """Fire the injection point ``name``: True when the caller must skip
    the guarded operation (``drop``); otherwise runs the armed action
    (delay, die, wedge) and returns False.  An unarmed site costs one
    dict lookup."""
    spec = armed(name)
    if spec is None:
        return False
    if spec.times is not None or spec.after:
        with _fired_lock:
            n = _fired.get(name, 0)
            _fired[name] = n + 1
        if n < spec.after or (spec.times is not None
                              and n >= spec.after + spec.times):
            return False
    LOG.warning("faultline: site %s firing action=%s arg=%s",
                name, spec.action, spec.arg)
    metrics.counter("fault_injections_total", site=name,
                    action=spec.action).inc()
    metrics.event("fault_fire", site=name, action=spec.action,
                  arg=spec.arg)
    if spec.action == "delay":
        time.sleep(spec.arg)
        return False
    if spec.action == "drop":
        return True
    if spec.action == "die":
        os._exit(int(spec.arg))
    # wedge: alive but stuck, in slices of a second
    deadline = time.monotonic() + spec.arg
    while time.monotonic() < deadline:
        time.sleep(min(1.0, deadline - time.monotonic()))
    return False
