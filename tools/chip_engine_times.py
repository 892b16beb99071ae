#!/usr/bin/env python3
"""Host time of the engine's parts inside the main paths' steps.

    python3 tools/chip_engine_times.py

Runs ``chip_smoke.py``'s phase-4 decoder, ResNet-50 and BERT-Large
Adasum paths (5 timed steps each, one more profiled) from the repository
root, with a wall-clock timer around each of the engine's parts: the
optimizer's hooks and ``synchronize()``, ``Engine.enqueue`` and the
backend's event at each enqueue (``producer``), and on the cycle thread
a cycle, the controller, each executed response (``perform``, its
collective ``execute``, the fused ``allreduce``, the per-tensor
``adasum_allreduce``) and the backend's stream work (``consume``,
``in_use``, ``produce``); also ``wait_all`` and, on the Adasum path,
the in-process ``adasum_reduce_stacked``.  Only the timed steps count
(between the engine readings ``chip_smoke.py`` takes before and after
them).  Prints the card's name and power limit, each path's step line,
and one line a path: host ms a step and calls a step for each part.  A
timer includes the wait for the GIL, which the autograd thread and the
cycle thread share.  Needs one CUDA card.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

acc = {}
window = {}


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


def main() -> int:
    import torch
    import chip_smoke as cs
    from horovod_tpu_torch.common import controller
    from horovod_tpu_torch.ops import _build, collectives, engine, op_manager
    from horovod_tpu_torch.utils import adasum
    from horovod_tpu_torch import optimizer

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.build_all()
    opt = optimizer._DistributedOptimizer
    for obj, name, key in (
            (opt, "_hook", "hook"), (opt, "synchronize", "opt_synchronize"),
            (engine.Engine, "enqueue", "enqueue"),
            (op_manager.NcclBackend, "producer", "producer"),
            (engine, "wait_all", "wait_all"),
            (engine.Engine, "_cycle", "cycle"),
            (controller.Controller, "run_cycle", "controller"),
            (engine.Engine, "_perform", "perform"),
            (engine.Engine, "_execute", "execute"),
            (collectives, "allreduce", "allreduce"),
            (collectives, "adasum_allreduce", "adasum_allreduce"),
            (op_manager.NcclBackend, "consume", "consume"),
            (op_manager.NcclBackend, "in_use", "in_use"),
            (op_manager.NcclBackend, "produce", "produce"),
            (adasum, "adasum_reduce_stacked", "reduce_stacked")):
        timed(obj, name, key)

    # chip_smoke reads the engine's counts just before a path's timed
    # steps and just after them: the timers' window.
    counts, calls = cs.engine_counts, [0]

    def counts_and_window():
        calls[0] += 1
        if calls[0] % 2:
            acc.clear()
        else:
            window.clear()
            window.update(acc)
        return counts()

    cs.engine_counts = counts_and_window

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
        cs.train_bert_adasum(torch)
    show("bert adasum")
    return 0


if __name__ == "__main__":
    sys.exit(main())
