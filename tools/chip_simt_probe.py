#!/usr/bin/env python3
"""A short first call for the flash kernels: the CUDA-core twins
(``horovod_tpu_torch/csrc/flash_simt.cu``, f32, f16 and bf16, head dims
32 to 256 and past it in 128-column panels) and the four Hopper kernels
(``flash_fwd.cu``, ``flash_bwd.cu``, ``flash_bwd_onepass.cu``) in f16 and
bf16, on one GPU.

    python3 tools/chip_simt_probe.py [--wide-fwd] [--sdpa-kernels] [--watchdog]

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

``--wide-fwd`` probes the Hopper forward from head dim 256 on alone:
``flash_fwd.cu``'s report, its readings in bf16 and f16 at
HOPPER_FWD_SHAPES (past 256 with the panel agreement) and
WIDE_BH_D256_SHAPE (``worst`` against chip_smoke's Hopper limits), and at the decoder's shape at 256 and 384 the device
ms of the Hopper forward, its CUDA-core twin and SDPA (20 calls each).
``--sdpa-kernels`` names the kernels that the yardstick, SDPA (forward
and backward, one call each under ``torch.profiler``), launches in f32
and bf16 at the decoder's shape at head dims 128 and 256, with their
device us and the backends SDPA may pick; it builds nothing.
``--watchdog`` runs on a copy of the package under ``build/probe/`` whose
mbarrier waits trap after seconds (``HVD_SM90_WATCHDOG``), so that a
new kernel's lost arrival ends its launch with an error instead of
hanging the card; its ptxas report and times are the watchdog build's
(whose clock spills the producer's 24 registers), not the shipped
kernels'.
"""

import json
import os
import shutil
import sys
import time

PROBED = (("hopper", "float16"), ("hopper", "bfloat16"), ("simt", "float32"),
          ("simt", "float16"), ("simt", "bfloat16"))
SOURCES = ("flash_simt", "flash_fwd", "flash_bwd", "flash_bwd_onepass")


def watchdog_copy(repo):
    """A copy of the package and chip_smoke.py under build/probe/ whose
    sm90.cuh defines HVD_SM90_WATCHDOG -> the copy's root."""
    work = os.path.join(repo, "build", "probe")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(repo, "horovod_tpu_torch"),
                    os.path.join(work, "horovod_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(repo, "chip_smoke.py"), work)
    header = os.path.join(work, "horovod_tpu_torch", "csrc", "sm90.cuh")
    with open(header) as f:
        text = f.read()
    with open(header, "w") as f:
        f.write("#define HVD_SM90_WATCHDOG 1\n" + text)
    return work


def wide_fwd(cs, fa, torch):
    """The Hopper forward from 256 on: readings, then times beside its
    CUDA-core twin and SDPA."""
    import torch.nn.functional as F
    for dtype in ("bfloat16", "float16"):
        for bh, s, d, causal in (list(cs.HOPPER_FWD_SHAPES)
                                 + [cs.WIDE_BH_D256_SHAPE]):
            errs, _, _, _ = cs.kernel_errors(
                fa, *cs.kernel_inputs(bh, s, d, dtype), causal)
            torch.cuda.synchronize()
            print("hopper", dtype, cs.shape_label(bh, s, d, causal),
                  json.dumps({o: {k: float("%.3g" % x) for k, x in e.items()}
                              for o, e in errs["flash_fwd"].items()}),
                  flush=True)
            torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float16"):
        for bh, s, d, causal in (cs.WIDE_HEAD_SHAPES[0],
                                 cs.WIDER_HEAD_SHAPES[0]):
            q, k, v, _ = cs.kernel_inputs(bh, s, d, dtype)
            q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
            times = {
                "hopper": cs.time_ms(
                    lambda: fa.flash_fwd_kernel(q, k, v, causal), reps=20),
                "simt": cs.time_ms(
                    lambda: fa.flash_fwd_simt_kernel(q, k, v, causal)),
                "sdpa": cs.time_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, scale=1.0), reps=20)}
            print("times forward", dtype, cs.shape_label(bh, s, d, causal),
                  times, flush=True)
            del q, k, v, q4, k4, v4
            torch.cuda.empty_cache()


def sdpa_kernels(cs, torch):
    """The kernels of one SDPA forward and backward, by profile."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    print("sdpa backends enabled: flash %s, mem_efficient %s, cudnn %s, "
          "math %s; tf32 matmul %s" % (
              torch.backends.cuda.flash_sdp_enabled(),
              torch.backends.cuda.mem_efficient_sdp_enabled(),
              torch.backends.cuda.cudnn_sdp_enabled(),
              torch.backends.cuda.math_sdp_enabled(),
              torch.backends.cuda.matmul.allow_tf32), flush=True)
    for dtype in ("float32", "bfloat16"):
        for bh, s, d, causal in (cs.DECODER_SHAPE, cs.WIDE_HEAD_SHAPES[0]):
            q, k, v, do = cs.kernel_inputs(bh, s, d, dtype)
            q4, k4, v4 = (t.view(1, bh, s, d).detach().requires_grad_()
                          for t in (q, k, v))
            do4 = do.view(1, bh, s, d)

            def call():
                out = F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, scale=1.0)
                torch.autograd.grad(out, (q4, k4, v4), do4)

            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            names = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    names[e.name] = (names.get(e.name, 0.0)
                                     + e.time_range.elapsed_us())
            print("sdpa kernels", dtype, cs.shape_label(bh, s, d, causal),
                  json.dumps({n[:160]: round(us, 1) for n, us in sorted(
                      names.items(), key=lambda kv: -kv[1])[:8]}),
                  flush=True)
            del q, k, v, do, q4, k4, v4, do4
            torch.cuda.empty_cache()


def main(argv) -> int:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, watchdog_copy(repo) if "--watchdog" in argv
                    else repo)
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
    if "--sdpa-kernels" in argv:
        sdpa_kernels(cs, torch)
        return 0
    t0 = time.perf_counter()
    print("build", _build.build_all(), time.perf_counter() - t0, flush=True)
    for src in ("flash_fwd",) if "--wide-fwd" in argv else SOURCES:
        cs.print_ptxas((_build.build_dir() / ("%s.log" % src)).read_text())
    if "--wide-fwd" in argv:
        wide_fwd(cs, fa, torch)
        return 0
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
    sys.exit(main(sys.argv[1:]))
