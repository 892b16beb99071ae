#!/usr/bin/env python3
"""Host cost of the data plane's per-collective bookkeeping, call by call.

    python3 tools/chip_host_costs.py [--calls N]

Times, on the host with ``time.perf_counter`` (N calls each, 200,000 by
default, best of 5 rounds), what the engine does for the fault plane and
the deadline on the default path (no ``HVD_TPU_FAULT``, no
``HOROVOD_COLLECTIVE_TIMEOUT_SECS``, the execution watchdog on for the
stall warning): an unarmed ``faultline.site`` (once an enqueue, a cycle
and a frozen bucket), ``resilience.collective_deadline`` with the two
``set_group_deadline`` calls around an execution, and a watch record's
life on CUDA (``Engine._watch_register`` then ``_watch_until`` with a
recorded CUDA event, then the watchdog's sweep of a done record).  Prints
the card's name and power limit, then one line per item in
microseconds a call, then the sum an enqueue and the sum a frozen
bucket.  Needs one CUDA card (the event); imports only the port.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())


def best_us(fn, calls: int, rounds: int = 5) -> float:
    best = float("inf")
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t)
    return best / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200000)
    calls = ap.parse_args().calls
    import torch
    if not torch.cuda.is_available():
        print("chip_host_costs: no CUDA device", file=sys.stderr)
        return 2
    from horovod_tpu_torch.common import faultline, resilience
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.common.message import ALLREDUCE
    from horovod_tpu_torch.ops.engine import Engine
    for knob in ("HVD_TPU_FAULT", "HOROVOD_COLLECTIVE_TIMEOUT_SECS"):
        os.environ.pop(knob, None)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    eng = Engine(Config.from_env(), 0, 1, torch.device("cuda"))
    assert eng._watchdog is not None  # on for the stall warning
    event = torch.cuda.Event()
    event.record()
    event.synchronize()
    names = ["grad.%d" % i for i in range(16)]

    def record():
        wid = eng._watch_register(ALLREDUCE, names, (), 0.0)
        eng._watch_until([wid], event)

    def deadline():
        d = resilience.collective_deadline(64 << 20)
        resilience.set_group_deadline(
            time.monotonic() + d if d > 0 else None)
        resilience.set_group_deadline(None)

    def sweep():  # the watchdog's pass over one done record
        record()
        with eng._watch_lock:
            for wid, rec in list(eng._watched.items()):
                if rec["event"] is not None and rec["event"].query():
                    del eng._watched[wid]

    items = {
        "faultline.site, unarmed": lambda: faultline.site(
            "mh.enqueue.pre_register"),
        "collective_deadline + set_group_deadline x2": deadline,
        "watch record: register, attach event, sweep": sweep,
    }
    us = {k: best_us(f, calls) for k, f in items.items()}
    for k, v in us.items():
        print("%-46s %.3f us a call" % (k, v), flush=True)
    site = us["faultline.site, unarmed"]
    print("an enqueue: %.3f us (one site)" % site)
    print("a frozen bucket: %.3f us (one site, the deadline, the record)"
          % (site + us["collective_deadline + set_group_deadline x2"]
             + us["watch record: register, attach event, sweep"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
