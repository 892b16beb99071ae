#!/usr/bin/env python3
"""The main paths' steps of two checkouts on one card, in turns.

    python3 tools/chip_ab_steps.py BEFORE_DIR AFTER_DIR

Runs ``chip_smoke.py``'s phase-4 paths (the decoder, ResNet-50,
BERT-Large and BERT-Large Adasum training, each 5 timed steps, after
the fast path's warm-up steps where the tree has them, with one more
profiled) from each directory in its own process, in the order before,
after, after, before, so that a drift of the card or its host over the
call shows as a difference between the two runs of one tree.  Each
directory is a checkout of the repository (for example a ``git
archive`` of the parent commit unpacked under ``build/``); each builds
its own kernels.  Prints the card's name and power limit, then each
run's step lines (median step_ms, idle share, the engine's counts a
step and the fast path's line where the tree has them), and exits
non-zero if a run failed.  Needs one CUDA card.
"""

import subprocess
import sys
import time

PHASE4 = r'''
import os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from horovod_tpu_torch.ops import _build
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
with cs.flash_bwd_env("pallas"):
    cs.train_flagship(torch)
torch.cuda.empty_cache()
cs.train_resnet_flagship(torch)
torch.cuda.empty_cache()
with cs.flash_bwd_env("pallas_onepass"):
    cs.train_bert_flagship(torch)
torch.cuda.empty_cache()
with cs.flash_bwd_env("pallas_onepass"):
    cs.train_bert_adasum(torch)
'''
KEEP = ("median step", "idle share", "engine per step", "fast path over",
        "step 1:", "step 2:", "step 3:", "step 4:")


def main() -> int:
    before, after = sys.argv[1], sys.argv[2]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    rc = 0
    for label, tree in (("before", before), ("after", after),
                        ("after", after), ("before", before)):
        t = time.time()
        out = subprocess.run([sys.executable, "-c", PHASE4], cwd=tree,
                             capture_output=True, text=True)
        print("=== %s (%s): exit %d, %.1f s" % (label, tree, out.returncode,
                                                time.time() - t), flush=True)
        for line in out.stdout.splitlines():
            if any(k in line for k in KEEP):
                print("   " + line[:240], flush=True)
        if out.returncode:
            print(out.stderr[-3000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
