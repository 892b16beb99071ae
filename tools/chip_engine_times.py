#!/usr/bin/env python3
"""Host time of the engine's parts inside the main paths' steps, with
the fast path on and off in turns.

    python3 tools/chip_engine_times.py [--runs N]

Runs ``chip_smoke.py``'s phase-4 paths (the decoder, ResNet-50,
BERT-Large and BERT-Large Adasum; each flagship's warm-up steps, then 5
timed steps and one more profiled) from the repository root, each run
in its own process, with ``HOROVOD_FAST_PATH`` 1 and 0 in turns (on,
off, off, on, on, off, ...: N runs a side, 3 by default), so that a
drift of the card or its host over the call shows as a difference
between runs of one side.  Inside a run, a wall-clock timer sits around
each of the engine's parts: the optimizer's hooks and
``synchronize()``, ``Engine.enqueue`` with the backend's event
(``producer``), its stream read (``current_stream``) and a frozen
round's staging (``fp_stage``), and on the cycle thread a cycle (``cycle``, which holds
a frozen bucket's dispatch, ``fp_dispatch``), the controller, each
executed response (``perform``, ``execute``), the fused ``allreduce``,
its parts (``flatten``, ``dist_all_reduce``, ``unflatten``),
the per-tensor ``adasum_allreduce`` and the backend's stream work
(``consume``, ``in_use``, ``produce``); also ``wait_all`` and, on the
Adasum path, the in-process ``adasum_reduce_stacked``.  Only the timed
steps count (from the engine reading ``chip_smoke.py`` takes just
before them to its ``report_engine`` just after).  Prints the card's
name and power limit, each run's step, profile, fast-path and timer
lines, then one line a path and side: median step_ms, idle share,
hooks and cycle-thread ms a step, each run's value in run order.  A
timer includes the wait for the GIL, which the autograd thread and the
cycle thread share.  Needs one CUDA card; about 8 minutes on one H100.
"""

import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

acc = {}
window = {}
state = {"open": False}


def timed(obj, name, key):
    f = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        try:
            return f(*args, **kwargs)
        finally:
            acc[key] = acc.get(key, 0.0) + (time.perf_counter() - t) * 1e3
            acc["n_" + key] = acc.get("n_" + key, 0) + 1

    setattr(obj, name, wrapper)


def one_run() -> int:
    """Every path once in this process, the timers on."""
    import torch
    import chip_smoke as cs
    from horovod_tpu_torch.common import controller
    from horovod_tpu_torch.ops import _build, collectives, engine, op_manager
    from horovod_tpu_torch.utils import adasum
    from horovod_tpu_torch import optimizer

    _build.build_all()
    opt = optimizer._DistributedOptimizer
    for obj, name, key in (
            (opt, "_hook", "hook"), (opt, "synchronize", "opt_synchronize"),
            (engine.Engine, "enqueue", "enqueue"),
            (op_manager.NcclBackend, "producer", "producer"),
            (op_manager.NcclBackend, "current_stream", "current_stream"),
            (engine.Engine, "_fp_stage", "fp_stage"),
            (engine, "wait_all", "wait_all"),
            (engine.Engine, "_cycle", "cycle"),
            (engine.Engine, "_fp_dispatch", "fp_dispatch"),
            (controller.Controller, "run_cycle", "controller"),
            (engine.Engine, "_perform", "perform"),
            (engine.Engine, "_execute", "execute"),
            (collectives, "allreduce", "allreduce"),
            (collectives, "_flatten_dense_tensors", "flatten"),
            (collectives.dist, "all_reduce", "dist_all_reduce"),
            (collectives, "_unflatten_dense_tensors", "unflatten"),
            (collectives, "adasum_allreduce", "adasum_allreduce"),
            (op_manager.NcclBackend, "consume", "consume"),
            (op_manager.NcclBackend, "in_use", "in_use"),
            (op_manager.NcclBackend, "produce", "produce"),
            (adasum, "adasum_reduce_stacked", "reduce_stacked")):
        timed(obj, name, key)

    # The window: from the first engine reading after the last path's
    # report (the one just before the timed steps) to the next report.
    counts, report = cs.engine_counts, cs.report_engine

    def counts_and_open():
        if not state["open"]:
            state["open"] = True
            acc.clear()
        return counts()

    def report_and_close(*args, **kwargs):
        state["open"] = False
        window.clear()
        window.update(acc)
        return report(*args, **kwargs)

    cs.engine_counts, cs.report_engine = counts_and_open, report_and_close

    def show(label):
        print("%s: host ms a step (calls a step): %s" % (label, json.dumps(
            {k: "%.2f (%d)" % (v / cs.STEPS,
                               window.get("n_" + k, 0) // cs.STEPS)
             for k, v in sorted(window.items()) if not k.startswith("n_")})),
            flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with cs.flash_bwd_env("pallas"):
        cs.train_flagship(torch)
    show("decoder")
    torch.cuda.empty_cache()
    cs.train_resnet_flagship(torch)
    show("resnet")
    torch.cuda.empty_cache()
    with cs.flash_bwd_env("pallas_onepass"):
        cs.train_bert_flagship(torch)
    show("bert")
    torch.cuda.empty_cache()
    with cs.flash_bwd_env("pallas_onepass"):
        cs.train_bert_adasum(torch)
    show("bert adasum")
    return 0


KEEP = ("median step", "idle share", "engine per step", "fast path over",
        "host ms a step")


def records(stdout):
    """One record a path from a run's lines, in the order printed: the
    step's median and the profile's idle share come before the path's
    timer line."""
    out, cur = [], {}
    for line in stdout.splitlines():
        m = re.search(r"median step_ms ([0-9.]+)", line)
        if m:
            cur["step_ms"] = float(m.group(1))
        m = re.search(r"idle share ([0-9.]+)%", line)
        if m:
            cur["idle"] = float(m.group(1))
        m = re.match(r"(.+): host ms a step \(calls a step\): (.*)$", line)
        if m:
            times = json.loads(m.group(2))
            ms = lambda k: float(times.get(k, "0 (0)").split()[0])
            cur.update(path=m.group(1), hook_ms=ms("hook"),
                       cycle_ms=ms("cycle"))
            out.append(cur)
            cur = {}
    return out


def main() -> int:
    if "--one" in sys.argv:
        return one_run()
    runs = int(sys.argv[sys.argv.index("--runs") + 1]) \
        if "--runs" in sys.argv else 3
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    turns = [("1", "0"), ("0", "1")] * ((runs + 1) // 2)
    order = [fp for pair in turns for fp in pair][:2 * runs]
    table, rc = {}, 0
    for k, fp in enumerate(order):
        t = time.time()
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one"],
            env=dict(os.environ, HOROVOD_FAST_PATH=fp),
            capture_output=True, text=True)
        print("=== run %d, HOROVOD_FAST_PATH=%s: exit %d, %.1f s"
              % (k, fp, out.returncode, time.time() - t), flush=True)
        for line in out.stdout.splitlines():
            if any(key in line for key in KEEP):
                print("   " + line[:2000], flush=True)
        if out.returncode:
            print(out.stderr[-3000:], flush=True)
            rc = 1
        for rec in records(out.stdout):
            row = table.setdefault((rec["path"], fp), {})
            for key in ("step_ms", "idle", "hook_ms", "cycle_ms"):
                row.setdefault(key, []).append(rec.get(key))
    for (path, fp), row in sorted(table.items()):
        print("%s, fast path %s: %s" % (path, "on" if fp == "1" else "off",
                                        json.dumps(row)), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
