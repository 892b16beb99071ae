#!/usr/bin/env python3
"""The main paths' steps of two checkouts on one card, in turns.

    python3 tools/chip_ab_steps.py BEFORE_DIR AFTER_DIR [--pairs N]
                                   [--paths decoder,resnet,bert,adasum]

Runs ``chip_smoke.py``'s phase-4 paths (the decoder, ResNet-50,
BERT-Large and BERT-Large Adasum training, each 5 timed steps, after
the fast path's warm-up steps where the tree has them, with one more
profiled; ``--paths`` picks some) from each directory in its own
process, in N pairs (2 by default) whose first side alternates: before,
after, after, before, before, after, ... so that a drift of the card or
its host over the call shows as a difference between the runs of one
tree.  Each directory is a checkout of the repository (for example a
``git archive`` of the parent commit unpacked under ``build/``); each
builds its own kernels.  Prints the card's name and power limit, then
each run's step lines (median step_ms, idle share, the engine's counts
a step and the fast path's line where the tree has them), then for
each path each side's median step_ms in run order, the median of each
side, the before side's quartile spread and the pairs the after side
won; exits non-zero if a run failed.  Needs one CUDA card.
"""

import argparse
import re
import statistics
import subprocess
import sys
import time

HEAD = r'''
import os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from horovod_tpu_torch.ops import _build
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
'''
# path -> (its code, the prefix of its "median step_ms" line)
PATHS = {
    "decoder": ("with cs.flash_bwd_env('pallas'):\n"
                "    cs.train_flagship(torch)\n", "flagship:"),
    "resnet": ("cs.train_resnet_flagship(torch)\n", "resnet flagship:"),
    "bert": ("with cs.flash_bwd_env('pallas_onepass'):\n"
             "    cs.train_bert_flagship(torch)\n", "bert flagship:"),
    "adasum": ("with cs.flash_bwd_env('pallas_onepass'):\n"
               "    cs.train_bert_adasum(torch)\n", "bert adasum:"),
}
STEP_MS = re.compile(r"median step_ms ([0-9.]+)")
KEEP = ("median step", "idle share", "engine per step", "fast path over",
        "step 1:", "step 2:", "step 3:", "step 4:")


def quartile_spread(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return q[2] - q[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args()
    paths = args.paths.split(",")
    code = HEAD + "torch.cuda.empty_cache()\n".join(
        PATHS[p][0] for p in paths)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    rc = 0
    got = {(p, side): [] for p in paths for side in ("before", "after")}
    order = []
    for i in range(args.pairs):
        pair = [("before", args.before), ("after", args.after)]
        order += pair if i % 2 == 0 else pair[::-1]
    for label, tree in order:
        t = time.time()
        out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True)
        print("=== %s (%s): exit %d, %.1f s" % (label, tree, out.returncode,
                                                time.time() - t), flush=True)
        for line in out.stdout.splitlines():
            if any(k in line for k in KEEP):
                print("   " + line[:240], flush=True)
            for p in paths:
                m = STEP_MS.search(line)
                if m and line.startswith(PATHS[p][1]):
                    got[(p, label)].append(float(m.group(1)))
        if out.returncode:
            print(out.stderr[-3000:], flush=True)
            rc = 1
    for p in paths:
        b, a = got[(p, "before")], got[(p, "after")]
        if not a or len(a) != len(b):
            continue
        wins = sum(x < y for x, y in zip(a, b))
        print("%s: before %s, after %s; medians %.2f / %.2f ms, before's "
              "quartile spread %.2f ms; after faster in %d of %d pairs"
              % (p, b, a, statistics.median(b), statistics.median(a),
                 quartile_spread(b) if len(b) > 1 else 0.0, wins, len(a)),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
