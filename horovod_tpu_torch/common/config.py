"""Runtime configuration from environment variables.

Counterpart of ``horovod_tpu.common.config`` (``Config.from_env``) for the
knobs the engine reads.  Each knob is ``HVD_TPU_<NAME>``, or Horovod's
``HOROVOD_<NAME>`` when the first is unset:

* ``FUSION_THRESHOLD``: bytes of allreduce payload fused into one
  collective (64 MiB);
* ``CYCLE_TIME``: milliseconds from the start of one negotiation cycle
  to the start of the next (5).  New work goes out in the first cycle
  that starts a cycle time after the last one began (an enqueue wakes an
  idle cycle thread, never a pacing one); ``wait()``, ``join()`` and
  ``shutdown()`` start a cycle at once; a rank of a multi-rank world
  with work outstanding cycles at this pace with nothing new;
* ``CACHE_CAPACITY``: entries of the response cache (1024);
* ``TIMELINE``: path of the chrome-trace timeline rank 0 writes (unset:
  none), and ``TIMELINE_MARK_CYCLES`` (one instant event per cycle);
* ``STALL_CHECK_TIME_SECONDS`` (60): a tensor some ranks submitted and
  others did not is reported after this long;
  ``STALL_SHUTDOWN_TIME_SECONDS`` (0: never): after this long the engine
  fails every outstanding collective on every rank and stops;
  ``STALL_CHECK_DISABLE`` turns both off;
* ``LOG_LEVEL``: the ``horovod_tpu_torch`` logger's level (warning);
* ``FAST_PATH`` (on): freeze a schedule that repeats, after
  ``FAST_PATH_WARM_CYCLES`` (10) identical rounds on every rank, and
  dispatch its allreduces in ``OVERLAP_BUCKETS`` (4) buckets without
  negotiating them (``ops/fastpath.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
DEFAULT_CYCLE_TIME_MS = 5.0
DEFAULT_CACHE_CAPACITY = 1024
DEFAULT_STALL_WARNING_SECS = 60.0
DEFAULT_STALL_SHUTDOWN_SECS = 0.0
DEFAULT_FAST_PATH_WARM_CYCLES = 10
DEFAULT_OVERLAP_BUCKETS = 4


def _env(name: str) -> Optional[str]:
    v = os.environ.get("HVD_TPU_" + name)
    return os.environ.get("HOROVOD_" + name) if v is None else v


def _env_number(name: str, default, kind):
    v = _env(name)
    try:
        return kind(v) if v not in (None, "") else default
    except ValueError:
        raise ValueError("%s=%r is not a valid %s"
                         % (name, v, kind.__name__)) from None


def _env_bool(name: str, default: bool) -> bool:
    v = _env(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Config:
    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS
    cache_capacity: int = DEFAULT_CACHE_CAPACITY
    timeline: Optional[str] = None
    timeline_mark_cycles: bool = False
    stall_warning_secs: float = DEFAULT_STALL_WARNING_SECS
    stall_shutdown_secs: float = DEFAULT_STALL_SHUTDOWN_SECS
    stall_check_disable: bool = False
    log_level: str = "warning"
    fast_path: bool = True
    fast_path_warm_cycles: int = DEFAULT_FAST_PATH_WARM_CYCLES
    overlap_buckets: int = DEFAULT_OVERLAP_BUCKETS

    @staticmethod
    def from_env() -> "Config":
        return Config(
            fusion_threshold_bytes=_env_number(
                "FUSION_THRESHOLD", DEFAULT_FUSION_THRESHOLD, int),
            cycle_time_ms=_env_number("CYCLE_TIME", DEFAULT_CYCLE_TIME_MS,
                                      float),
            cache_capacity=max(1, _env_number(
                "CACHE_CAPACITY", DEFAULT_CACHE_CAPACITY, int)),
            timeline=_env("TIMELINE") or None,
            timeline_mark_cycles=_env_bool("TIMELINE_MARK_CYCLES", False),
            stall_warning_secs=_env_number(
                "STALL_CHECK_TIME_SECONDS", DEFAULT_STALL_WARNING_SECS,
                float),
            stall_shutdown_secs=_env_number(
                "STALL_SHUTDOWN_TIME_SECONDS", DEFAULT_STALL_SHUTDOWN_SECS,
                float),
            stall_check_disable=_env_bool("STALL_CHECK_DISABLE", False),
            log_level=(_env("LOG_LEVEL") or "warning").lower(),
            fast_path=_env_bool("FAST_PATH", True),
            fast_path_warm_cycles=max(1, _env_number(
                "FAST_PATH_WARM_CYCLES", DEFAULT_FAST_PATH_WARM_CYCLES, int)),
            overlap_buckets=max(1, _env_number(
                "OVERLAP_BUCKETS", DEFAULT_OVERLAP_BUCKETS, int)))
