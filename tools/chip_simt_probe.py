#!/usr/bin/env python3
"""A short first call for the CUDA-core flash kernels
(``horovod_tpu_torch/csrc/flash_simt.cu``) on one GPU.

    python3 tools/chip_simt_probe.py

Builds the kernels, prints the card, the build time and ``nvcc``'s
register and spill report for ``flash_simt.cu``, then every SIMT
kernel's readings against its plain version (``chip_smoke``'s
``kernel_errors``, with no limit applied: ``worst`` is then the error
over (|plain| + the row's scale)) at chip_smoke's SIMT_SHAPES and
WIDE_BH_SHAPE in f32 and f16, one bf16 shape as a check of the Hopper
path, and each SIMT kernel's device ms per call (``time_ms``, 5 calls)
at the decoder's and BERT-Large's shapes.  Exits non-zero on any
error; it judges nothing (``chip_smoke.py`` does).
"""

import json
import os
import sys
import time


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    if not torch.cuda.is_available():
        print("chip_simt_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    print("build", _build.build_all(), time.perf_counter() - t0, flush=True)
    log = (_build.build_dir() / "flash_simt.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ", line.strip()[:160])
    # Readings, not verdicts: no limit.
    cs.SIMT_TOL = {"float32": (1.0, 1.0), "float16": (1.0, 1.0)}
    cs.F16_OFF_SHARE = 1.0
    for dtype in cs.SIMT_DTYPES:
        for bh, s, d, causal in list(cs.SIMT_SHAPES) + [cs.WIDE_BH_SHAPE]:
            errs, poisoned, _, _ = cs.kernel_errors(
                fa, *cs.kernel_inputs(bh, s, d, dtype), causal)
            torch.cuda.synchronize()
            print(dtype, cs.shape_label(bh, s, d, causal), "poisoned",
                  poisoned, json.dumps(
                      {n: {o: {k: float("%.3g" % x) for k, x in e.items()}
                           for o, e in outs.items()}
                       for n, outs in errs.items()}), flush=True)
            torch.cuda.empty_cache()
    errs, _, _, _ = cs.kernel_errors(fa, *cs.kernel_inputs(4, 200, 64), False)
    print("bf16 worst", max(e["worst"] for o in errs.values()
                            for e in o.values()))
    for dtype in cs.SIMT_DTYPES:
        for shape in (cs.DECODER_SHAPE, cs.BERT_SHAPE):
            q, k, v, do = cs.kernel_inputs(*shape[:3], dtype)
            causal = shape[3]
            kern = cs.flash_kernels(fa, dtype)
            o, lse = kern["flash_fwd"](q, k, v, causal)
            delta = (do.float() * o.float()).sum(-1)
            bwd = (q, k, v, do, lse, delta, causal)
            times = {name: cs.time_ms(
                (lambda f=kern[name]: f(q, k, v, causal)) if name ==
                "flash_fwd" else (lambda f=kern[name]: f(*bwd)), reps=5)
                for name in cs.FLASH_KERNELS}
            print("times", dtype, shape, times, flush=True)
            del q, k, v, do
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
