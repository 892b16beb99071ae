#!/usr/bin/env python3
"""A short first call for the flash kernels: the CUDA-core twins
(``horovod_tpu_torch/csrc/flash_simt.cu``, f32, f16 and bf16, head dims
32 to 256 and past it in 128-column panels) and the four Hopper kernels
(``flash_fwd.cu``, ``flash_bwd.cu``, ``flash_bwd_onepass.cu``) in f16 and
bf16, on one GPU.

    python3 tools/chip_simt_probe.py

Builds the kernels, prints the card, the build time and ``nvcc``'s
register and spill report for those four sources, then each kernel's
readings against its plain version (``chip_smoke``'s ``kernel_errors``,
with no limit applied: ``worst`` is then the error over (|plain| + the
row's scale)) at chip_smoke's shapes of its family (FLASH_SHAPES for
the Hopper kernels, SIMT_SHAPES for the CUDA-core ones, in each dtype)
and WIDE_BH_SHAPE, and each kernel's device ms per call (``time_ms``, 5
calls) at the decoder's and BERT-Large's shapes (and the decoder's at
head dims 256 and 384 for the CUDA-core ones).  Exits non-zero on any
error; it judges nothing (``chip_smoke.py`` does).
"""

import json
import os
import sys
import time

PROBED = (("hopper", "float16"), ("hopper", "bfloat16"), ("simt", "float32"),
          ("simt", "float16"), ("simt", "bfloat16"))
SOURCES = ("flash_simt", "flash_fwd", "flash_bwd", "flash_bwd_onepass")


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
    for src in SOURCES:
        cs.print_ptxas((_build.build_dir() / ("%s.log" % src)).read_text())
    # Readings, not verdicts: no limit.
    cs.SIMT_TOL = dict.fromkeys(cs.SIMT_DTYPES, (1.0, 1.0))
    cs.F16_HOPPER_TOL = dict.fromkeys(cs.KERNEL_TOL, (1.0, 1.0))
    cs.F16_OFF_SHARE = 1.0
    for family, dtype in PROBED:
        shapes = cs.FLASH_SHAPES if family == "hopper" else cs.SIMT_SHAPES
        for bh, s, d, causal in list(shapes) + [cs.WIDE_BH_SHAPE]:
            errs, poisoned, _, _ = cs.kernel_errors(
                fa, *cs.kernel_inputs(bh, s, d, dtype), causal, family)
            torch.cuda.synchronize()
            print(family, dtype, cs.shape_label(bh, s, d, causal), "poisoned",
                  poisoned, json.dumps(
                      {n: {o: {k: float("%.3g" % x) for k, x in e.items()}
                           for o, e in outs.items()}
                       for n, outs in errs.items()}), flush=True)
            torch.cuda.empty_cache()
    for family, dtype in PROBED:
        kern = cs.flash_kernels(fa, dtype, family)
        shapes = [cs.DECODER_SHAPE, cs.BERT_SHAPE] + (
            [cs.WIDE_HEAD_SHAPES[0], cs.WIDER_HEAD_SHAPES[0]]
            if family == "simt" else [])
        for shape in shapes:
            q, k, v, do = cs.kernel_inputs(*shape[:3], dtype)
            causal = shape[3]
            o, lse = kern["flash_fwd"](q, k, v, causal)
            delta = (do.float() * o.float()).sum(-1)
            bwd = (q, k, v, do, lse, delta, causal)
            times = {name: cs.time_ms(
                (lambda f=f: f(q, k, v, causal)) if name == "flash_fwd"
                else (lambda f=f: f(*bwd)), reps=5)
                for name, f in kern.items()}
            print("times", family, dtype, shape, times, flush=True)
            del q, k, v, do
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
