#!/usr/bin/env python3
"""A short first call for the flash kernels: the CUDA-core twins
(``horovod_tpu_torch/csrc/flash_simt.cu``, f32, f16 and bf16, head dims
32 to 256 and past it in 128-column panels), the four Hopper kernels
(``flash_fwd.cu``, ``flash_bwd.cu``, ``flash_bwd_onepass.cu``) in f16 and
bf16, and the f32 forward, dq and dk/dv on Hopper (``flash_fwd_f32.cu``,
``flash_bwd_f32.cu``), on one GPU.

    python3 tools/chip_simt_probe.py [--wide-fwd] [--wide-bwd] [--wider-bwd]
                                     [--wide-onepass] [--wider-onepass]
                                     [--f32-fwd] [--f32-split] [--f32-bwd]
                                     [--f32-onepass]
                                     [--sdpa-kernels] [--watchdog]
                                     [--head-major]
    python3 tools/chip_simt_probe.py --narrow-bwd [--tree DIR]
    python3 tools/chip_simt_probe.py --f32-bwd-times [--tree DIR]
    python3 tools/chip_simt_probe.py --f32-bwd-parts
    python3 tools/chip_simt_probe.py --wider-onepass-times [--tree DIR]
    python3 tools/chip_simt_probe.py --wider-onepass-parts

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
``--wide-bwd`` probes the Hopper dq and dk/dv at head dim 256 alone:
``flash_bwd.cu``'s report, their readings in bf16 and f16 at
WIDE_HEAD_SHAPES and WIDE_BH_D256_SHAPE (``worst`` against chip_smoke's
Hopper limits), and at the decoder's shape at 256 the device ms of each,
its CUDA-core twin and SDPA's whole backward (20 calls each).
``--wider-bwd`` does the same past 256: readings at WIDER_HEAD_SHAPES
(with the panel agreement) and WIDE_BH_D384_SHAPE, times at the decoder's
shape at 384 and at DECODER_D512_SHAPE.
``--wide-onepass`` probes the Hopper one-pass at head dim 256 alone (64-row
partial slots): ``flash_bwd_onepass.cu``'s report, its readings in bf16
and f16 at WIDE_HEAD_SHAPES and WIDE_BH_D256_SHAPE (``worst`` against
chip_smoke's Hopper limits, the partials in a NaN-poisoned block), and at
the decoder's shape at 256 the device ms of the kernel, of the kernel
with the partials' sum (``flash_bwd`` under ``pallas_onepass``), of its
CUDA-core twin and of SDPA's whole backward.
``--wider-onepass`` does the same past 256 (128-row partial slots):
readings at WIDER_HEAD_SHAPES (with the panel agreement and a second
launch bit for bit) and WIDE_BH_D384_SHAPE, times at the decoder's shape
at 384 and at DECODER_D512_SHAPE, beside the Hopper dq and dk/dv too.
``--f32-fwd`` probes the f32 forward on Hopper (``flash_fwd_f32.cu``,
split TF32) alone: its report, its readings at chip_smoke's
F32_FWD_SHAPES (past 256 with the panel agreement) and WIDE_BH_SHAPE
(``worst`` against chip_smoke's f32 limits), and at the decoder's shape
at head dims 128, 256 and 384 and at BERT-Large's the device ms of the
kernel (its V^T copy included), of that copy alone (``f32_vt``), of its
CUDA-core twin and of SDPA in f32 (20 calls each, the twin 3), beside
the three-pass TF32 bound and the CUDA cores' f32 bound.
``--f32-split`` runs ``tests/test_torch_port_hopper_f32_fwd.py``'s
emulation of the kernel's split on the card (TF32 off, so torch's f32
products are exact f32 ones) at BH 32, S 2048, D 384, causal: the
worst reading of o and lse against the f32 plain version under the f32
limits for the truncating split, the round-to-nearest one, the
truncating split with either small term dropped, and the truncating
split summed as the tensor core sums (each sum truncated toward zero)
in the kernel's chains and in one chain each; it builds nothing.
``--f32-bwd`` probes the f32 dq and dk/dv on Hopper (``flash_bwd_f32.cu``:
split TF32, dP on the CUDA cores) alone: its report (registers, spills),
their readings at chip_smoke's F32_FWD_SHAPES (past 256 with their panel
agreement) and WIDE_BH_SHAPE (``worst`` against chip_smoke's f32 limits),
at the decoder's shape at head dims 128, 256 and 384 and at BERT-Large's
the device ms of each kernel (its transposed copies included), of those
copies alone (``f32_vt``), of the CUDA-core twins and of SDPA's f32
backward (20 calls each, the twins 3), beside each kernel's split-TF32
bound and this design's (dP at the CUDA cores' 67 TFLOP/s), then
``tests/test_torch_port_hopper_f32_bwd.py``'s emulation on the card (TF32
off) at BH 4096, S 64, D 32 and at the decoder's shape, both causal: the
worst reading of dq, dk and dv against the f32 plain version under the
f32 limits for the design, for dP in split TF32 and correctly rounded,
and for one truncating chain each.
``--f32-onepass`` probes the f32 one-pass on Hopper (``flash_bwd_f32.cu``:
dk/dv's body plus dS K per k block, split TF32, dP on the CUDA cores)
alone: its report (registers, spills), its readings at chip_smoke's
F32_FWD_SHAPES and WIDE_BH_SHAPE (``worst`` against chip_smoke's f32
limits; the partials in a NaN-poisoned block, past 256 the panel
agreement, and a second launch against the first, bit for bit), and at
the decoder's shape, BERT-Large's and the decoder's at head dims 256 and
384 the device ms of the kernel (its three transposed copies included),
of it with the partials' sum (``flash_bwd`` under ``pallas_onepass``), of
the copies alone, of its CUDA-core twin and of SDPA's f32 backward (20
calls each, the twin 3), beside its split-TF32 bound (five passes of
products) and this design's (four, and dP at the CUDA cores' 67
TFLOP/s).
``--sdpa-kernels`` names the kernels that the yardstick, SDPA (forward
and backward, one call each under ``torch.profiler``), launches in f32
and bf16 at the decoder's shape at head dims 128 and 256, with their
device us and the backends SDPA may pick; it builds nothing.
``--watchdog`` runs on a copy of the package under ``build/probe/`` whose
mbarrier waits trap after seconds (``HVD_SM90_WATCHDOG``), so that a
new kernel's lost arrival ends its launch with an error instead of
hanging the card; its ptxas report and times are the watchdog build's
(whose clock spills the producer's 24 registers), not the shipped
kernels'.  ``--head-major`` runs on a copy under
``build/probe-head-major/`` whose dq and dk/dv blocks at D 256 take
their (bh, tile) head-major (block b in launch order: head b div tiles,
tile b mod tiles) instead of bh first (head b mod BH, tile b div BH);
with ``--wide-bwd`` it times that order in a build that is the shipped
one in all else.  A copy keeps its build from one run to the next.

``--narrow-bwd`` times only the Hopper dq, dk/dv and one-pass in bf16
and f16 at the decoder's shape (D 128) and BERT's (D 64), 20 calls each,
with no readings and no report; ``--f32-bwd-times`` times only the f32
dq and dk/dv on Hopper at the decoder's shape at head dims 128, 256 and
384 and at BERT-Large's, 20 calls each, likewise; ``--f32-bwd-parts`` runs
that in turns on this checkout and on copies under ``build/`` whose f32
dq and dk/dv leave out dP (``no_dp``), the split-TF32 score products
(``no_scores``: S and S^T from their fragments' bits) or the output
products (``no_outputs``), and this checkout again, each in a process of
its own: what each part costs (their outputs are not held);
``--wider-onepass-times`` times only the Hopper one-pass past 256 (alone
and with the partials' sum, where the tree's one-pass takes the width)
and the Hopper dq and dk/dv in bf16 at the decoder's shape at 384 and at
DECODER_D512_SHAPE, 20 calls each, and ``--wider-onepass-parts`` runs it
in turns on this checkout and on copies whose one-pass past 256 leaves
out the second k block's read-back (``no_readback``), the partial's
stores (``no_stores``) or its product and stores (``no_partial``), and
this checkout again; ``--tree DIR`` takes
``chip_smoke.py``
and the package from another checkout (an unpacked parent commit, say,
under ``build/``), so that one call can time two trees in turns.
"""

import json
import os
import shutil
import subprocess
import sys
import time

PROBED = (("hopper", "float16"), ("hopper", "bfloat16"), ("simt", "float32"),
          ("simt", "float16"), ("simt", "bfloat16"))
SOURCES = ("flash_simt", "flash_fwd", "flash_bwd", "flash_bwd_onepass")


# flash_bwd.cu's block decodes (dq's, then dk/dv's at D 256), bh first,
# and head-major in their place: block b = x + BH y in launch order
BH_FIRST = ("  const int bh = blockIdx.x;\n"
            "  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;",
            "  const int bh = blockIdx.x, k0 = blockIdx.y * BK;")
_HM = "  const int b = blockIdx.x + gridDim.x * blockIdx.y, bh = b / gridDim.y"
HEAD_MAJOR = (_HM + ";\n  const int q0 = (gridDim.y - 1 - b % gridDim.y) * BQ;",
              _HM + ", k0 = b % gridDim.y * BK;")


def probe_copy(repo, name, source, old, new):
    """A copy of the package and chip_smoke.py under build/<name>/ with
    each text of `old` replaced by its twin in `new` in csrc/<source> ->
    the copy's root.  The copy's own build directory stays, so an
    unchanged copy builds once."""
    work = os.path.join(repo, "build", name)
    shutil.copytree(os.path.join(repo, "horovod_tpu_torch"),
                    os.path.join(work, "horovod_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"),
                    dirs_exist_ok=True)
    shutil.copy(os.path.join(repo, "chip_smoke.py"), work)
    path = os.path.join(work, "horovod_tpu_torch", "csrc", source)
    with open(path) as f:
        text = f.read()
    for o, n in zip(old, new):
        if text.count(o) != 1:
            raise SystemExit("chip_simt_probe: %r is not in %s once"
                             % (o, source))
        text = text.replace(o, n)
    with open(path, "w") as f:
        f.write(text)
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


def wide_bwd(cs, fa, torch, wider=False):
    """The Hopper dq and dk/dv at 256 (past it with ``wider``: at 384 and
    640, their panels too): readings, then times beside their CUDA-core
    twins and SDPA's backward at the decoder's shape at that width (past
    256 also at the hd512 decoder's attention, D 512)."""
    import torch.nn.functional as F
    held = ([*cs.WIDER_HEAD_SHAPES, cs.WIDE_BH_D384_SHAPE] if wider else
            [*cs.WIDE_HEAD_SHAPES, cs.WIDE_BH_D256_SHAPE])
    timed = ([cs.WIDER_HEAD_SHAPES[0], cs.DECODER_D512_SHAPE] if wider else
             [cs.WIDE_HEAD_SHAPES[0]])
    for dtype in ("bfloat16", "float16"):
        for bh, s, d, causal in held:
            errs, _, _, _ = cs.kernel_errors(
                fa, *cs.kernel_inputs(bh, s, d, dtype), causal)
            torch.cuda.synchronize()
            print("hopper", dtype, cs.shape_label(bh, s, d, causal),
                  json.dumps({n: {o: {k: float("%.3g" % x)
                                      for k, x in e.items()}
                                  for o, e in errs[n].items()}
                              for n in ("flash_bwd_dq", "flash_bwd_dkv")}),
                  flush=True)
            torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float16"):
        for bh, s, d, causal in timed:
            q, k, v, do = cs.kernel_inputs(bh, s, d, dtype)
            o, lse = fa.flash_fwd_kernel(q, k, v, causal)
            delta = (do.float() * o.float()).sum(-1)
            bwd = (q, k, v, do, lse, delta, causal)
            q4, k4, v4 = (t.view(1, bh, s, d).detach().requires_grad_()
                          for t in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal, scale=1.0)
            do4 = do.view(1, bh, s, d)
            times = {name: cs.time_ms(lambda f=f: f(*bwd), reps=reps)
                     for name, f, reps in (
                         ("dq", fa.flash_bwd_dq_kernel, 20),
                         ("dkv", fa.flash_bwd_dkv_kernel, 20),
                         ("dq_simt", fa.flash_bwd_dq_simt_kernel, 3),
                         ("dkv_simt", fa.flash_bwd_dkv_simt_kernel, 3))}
            times["sdpa_bwd"] = cs.time_ms(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True), reps=20)
            print("times backward", dtype, cs.shape_label(bh, s, d, causal),
                  times, flush=True)
            del q, k, v, do, o, q4, k4, v4, out4, do4
            torch.cuda.empty_cache()


def wide_onepass(cs, fa, torch, wider=False):
    """The Hopper one-pass at 256 (past it with ``wider``: at 384 and 640,
    its panels and a second launch too): readings, then times beside the
    variant with the partials' sum, its CUDA-core twin and SDPA's backward
    at the decoder's shape at that width (past 256 also beside the Hopper
    dq and dk/dv, and at the hd512 decoder's attention, D 512)."""
    import torch.nn.functional as F
    held = ([*cs.WIDER_HEAD_SHAPES, cs.WIDE_BH_D384_SHAPE] if wider else
            [*cs.WIDE_HEAD_SHAPES, cs.WIDE_BH_D256_SHAPE])
    timed = ([cs.WIDER_HEAD_SHAPES[0], cs.DECODER_D512_SHAPE] if wider else
             [cs.WIDE_HEAD_SHAPES[0]])
    for dtype in ("bfloat16", "float16"):
        for bh, s, d, causal in held:
            errs, poisoned, _, _ = cs.kernel_errors(
                fa, *cs.kernel_inputs(bh, s, d, dtype), causal)
            torch.cuda.synchronize()
            print("hopper", dtype, cs.shape_label(bh, s, d, causal),
                  "poisoned", poisoned,
                  json.dumps({o: {k: float("%.3g" % x) for k, x in e.items()}
                              for o, e in errs["flash_bwd_onepass"].items()}),
                  flush=True)
            torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float16"):
        for bh, s, d, causal in timed:
            q, k, v, do = cs.kernel_inputs(bh, s, d, dtype)
            o, lse = fa.flash_fwd_kernel(q, k, v, causal)
            delta = (do.float() * o.float()).sum(-1)
            bwd = (q, k, v, do, lse, delta, causal)
            q4, k4, v4 = (t.view(1, bh, s, d).detach().requires_grad_()
                          for t in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal, scale=1.0)
            do4 = do.view(1, bh, s, d)
            times = {"onepass": cs.time_ms(
                lambda: fa.flash_bwd_onepass_kernel(*bwd), reps=20)}
            with cs.flash_bwd_env("pallas_onepass"):
                times["onepass_and_sum"] = cs.time_ms(
                    lambda: fa.flash_bwd(*bwd), reps=20)
            if wider:
                times["dq"] = cs.time_ms(
                    lambda: fa.flash_bwd_dq_kernel(*bwd), reps=20)
                times["dkv"] = cs.time_ms(
                    lambda: fa.flash_bwd_dkv_kernel(*bwd), reps=20)
            times["onepass_simt"] = cs.time_ms(
                lambda: fa.flash_bwd_onepass_simt_kernel(*bwd), reps=3)
            times["sdpa_bwd"] = cs.time_ms(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True), reps=20)
            print("times one-pass", dtype, cs.shape_label(bh, s, d, causal),
                  times, flush=True)
            del q, k, v, do, o, q4, k4, v4, out4, do4, bwd
            torch.cuda.empty_cache()


def f32_fwd(cs, fa, torch):
    """The f32 forward on Hopper: readings, then times beside its V^T
    copy, its CUDA-core twin and SDPA, and its two bounds."""
    import torch.nn.functional as F
    for bh, s, d, causal in list(cs.F32_FWD_SHAPES) + [cs.WIDE_BH_SHAPE]:
        errs, _, _, _ = cs.kernel_errors(
            fa, *cs.kernel_inputs(bh, s, d, "float32"), causal, "hopper_f32")
        torch.cuda.synchronize()
        print("hopper_f32", cs.shape_label(bh, s, d, causal),
              json.dumps({o: {k: float("%.3g" % x) for k, x in e.items()}
                          for o, e in errs["flash_fwd"].items()}), flush=True)
        torch.cuda.empty_cache()
    for bh, s, d, causal in (cs.DECODER_SHAPE, cs.WIDE_HEAD_SHAPES[0],
                             cs.WIDER_HEAD_SHAPES[0], cs.BERT_SHAPE):
        q, k, v, _ = cs.kernel_inputs(bh, s, d, "float32")
        q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
        times = {
            "hopper_f32": cs.time_ms(
                lambda: fa.flash_fwd_f32_kernel(q, k, v, causal), reps=20),
            "vt_copy": cs.time_ms(lambda: fa.f32_vt(v), reps=20),
            "simt": cs.time_ms(
                lambda: fa.flash_fwd_simt_kernel(q, k, v, causal), reps=3),
            "sdpa": cs.time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=1.0), reps=20)}
        flops = 4 * d * bh * (s * (s + 1) // 2 if causal else s * s)
        print("times f32 forward", cs.shape_label(bh, s, d, causal), times,
              "bound ms: split TF32 %.4g, f32 on the CUDA cores %.4g" % (
                  cs.SPLIT_TF32_TERMS * flops / cs.PEAK_TF32_FLOPS * 1e3,
                  flops / cs.PEAK_F32_FLOPS * 1e3), flush=True)
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()


def f32_split(cs, torch):
    """The kernel's split emulated on the card at the decoder's shape at
    384: each split's worst reading."""
    from horovod_tpu_torch.ops import flash_attention as fa
    from tests import test_torch_port_hopper_f32_fwd as emu
    bh, s, d, causal = cs.WIDER_HEAD_SHAPES[0]
    q, k, v, _ = cs.kernel_inputs(bh, s, d, "float32")
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
    tol = cs.SIMT_TOL["float32"]
    three = emu.SMALL + ("hi_hi",)
    for label, form, terms, chains in (
            ("truncating", "trunc", three, None),
            ("round-to-nearest", "rna", three, None),
            ("truncating without lo hi", "trunc", ("hi_lo", "hi_hi"), None),
            ("truncating without hi lo", "trunc", ("lo_hi", "hi_hi"), None),
            ("truncating, the tensor core's sums chained as the kernel's",
             "trunc", three, emu.KERNEL_CHAINS),
            ("truncating, the tensor core's sums in one chain each", "trunc",
             three, ("all", "all"))):
        o, lse = emu.emulated_fwd(q, k, v, causal, form, terms, chains)
        print("f32 split %s at %s: worst o %.4g, lse %.4g (limits rtol, atol "
              "%s)" % (label, cs.shape_label(bh, s, d, causal),
                       cs.compare(o, o_ref, *tol)["worst"],
                       cs.compare(lse, lse_ref, *tol)["worst"], tol),
              flush=True)
        del o, lse
        torch.cuda.empty_cache()


def f32_bwd(cs, fa, torch):
    """The f32 dq and dk/dv on Hopper: readings, times beside their
    transposed copies, their CUDA-core twins and SDPA's backward, and
    their bounds, then the emulation of their arithmetic on the card."""
    import torch.nn.functional as F
    for bh, s, d, causal in list(cs.F32_FWD_SHAPES) + [cs.WIDE_BH_SHAPE]:
        errs, _, _, _ = cs.kernel_errors(
            fa, *cs.kernel_inputs(bh, s, d, "float32"), causal, "hopper_f32")
        torch.cuda.synchronize()
        print("hopper_f32", cs.shape_label(bh, s, d, causal),
              json.dumps({n: {o: {k: float("%.3g" % x) for k, x in e.items()}
                              for o, e in errs[n].items()}
                          for n in ("flash_bwd_dq", "flash_bwd_dkv")}),
              flush=True)
        torch.cuda.empty_cache()
    peak = cs.PEAK_TF32_FLOPS / cs.SPLIT_TF32_TERMS
    for bh, s, d, causal in (cs.DECODER_SHAPE, cs.WIDE_HEAD_SHAPES[0],
                             cs.WIDER_HEAD_SHAPES[0], cs.BERT_SHAPE):
        q, k, v, do = cs.kernel_inputs(bh, s, d, "float32")
        o, lse = fa.flash_fwd_f32_kernel(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta, causal)
        q4, k4, v4 = (t.view(1, bh, s, d).detach().requires_grad_()
                      for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=1.0)
        do4 = do.view(1, bh, s, d)
        times = {name: cs.time_ms(lambda f=f: f(*bwd), reps=reps)
                 for name, f, reps in (
                     ("dq", fa.flash_bwd_dq_f32_kernel, 20),
                     ("dkv", fa.flash_bwd_dkv_f32_kernel, 20),
                     ("dq_simt", fa.flash_bwd_dq_simt_kernel, 3),
                     ("dkv_simt", fa.flash_bwd_dkv_simt_kernel, 3))}
        times["kt_copy"] = cs.time_ms(lambda: fa.f32_vt(k), reps=20)
        times["qt_gt_copies"] = cs.time_ms(
            lambda: (fa.f32_vt(q), fa.f32_vt(do)), reps=20)
        times["sdpa_bwd"] = cs.time_ms(lambda: torch.autograd.grad(
            out4, (q4, k4, v4), do4, retain_graph=True), reps=20)
        pass_flops = 2 * d * bh * (s * (s + 1) // 2 if causal else s * s)
        print("times f32 backward", cs.shape_label(bh, s, d, causal), times,
              "bound ms (split TF32; this design, dP at %.0f TFLOP/s): dq "
              "%.4g, %.4g; dk/dv %.4g, %.4g" % (
                  cs.PEAK_F32_FLOPS / 1e12,
                  3 * pass_flops / peak * 1e3,
                  (2 * pass_flops / peak + pass_flops / cs.PEAK_F32_FLOPS)
                  * 1e3,
                  4 * pass_flops / peak * 1e3,
                  (3 * pass_flops / peak + pass_flops / cs.PEAK_F32_FLOPS)
                  * 1e3), flush=True)
        del q, k, v, do, o, q4, k4, v4, out4, do4, bwd
        torch.cuda.empty_cache()
    f32_bwd_emulation(cs, torch)


def f32_bwd_emulation(cs, torch):
    """The f32 backward's arithmetic emulated on the card: each variant's
    worst reading of dq, dk and dv."""
    from tests import test_torch_port_hopper_f32_bwd as emu
    for bh, s, d, causal in ((4096, 64, 32, True), cs.DECODER_SHAPE):
        q, k, v, g = cs.kernel_inputs(bh, s, d, "float32")
        o, lse = emu.fa.flash_fwd_reference(q, k, v, causal)
        args = (q, k, v, g, lse, (g * o).sum(-1))
        for label, kw in (("the design", {}),
                          ("dP in split TF32", {"dp": "split"}),
                          ("dP correctly rounded", {"dp": "rounded"}),
                          ("one truncating chain each",
                           {"chains": ("all", "all")})):
            got = emu.emulated_bwd(*args, causal, **kw)
            print("f32 backward emulated, %s at %s: worst dq, dk, dv %s"
                  % (label, cs.shape_label(bh, s, d, causal),
                     ["%.4g" % w for w in emu.worst(got, args, causal)]),
                  flush=True)
            del got
            torch.cuda.empty_cache()


def f32_onepass(cs, fa, torch):
    """The f32 one-pass on Hopper: readings (partials poisoned, panels and
    a second launch bit for bit), then times alone and with the partials'
    sum beside its CUDA-core twin and SDPA's backward, and its bounds."""
    import torch.nn.functional as F
    for bh, s, d, causal in list(cs.F32_FWD_SHAPES) + [cs.WIDE_BH_SHAPE]:
        errs, poisoned, _, _ = cs.kernel_errors(
            fa, *cs.kernel_inputs(bh, s, d, "float32"), causal, "hopper_f32")
        torch.cuda.synchronize()
        print("hopper_f32", cs.shape_label(bh, s, d, causal), "poisoned",
              poisoned, json.dumps(
                  {o: {k: float("%.3g" % x) for k, x in e.items()}
                   for o, e in errs["flash_bwd_onepass"].items()}),
              flush=True)
        torch.cuda.empty_cache()
    peak = cs.PEAK_TF32_FLOPS / cs.SPLIT_TF32_TERMS
    for bh, s, d, causal in (cs.DECODER_SHAPE, cs.BERT_SHAPE,
                             cs.WIDE_HEAD_SHAPES[0], cs.WIDER_HEAD_SHAPES[0]):
        q, k, v, do = cs.kernel_inputs(bh, s, d, "float32")
        o, lse = fa.flash_fwd_f32_kernel(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta, causal)
        q4, k4, v4 = (t.view(1, bh, s, d).detach().requires_grad_()
                      for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=1.0)
        do4 = do.view(1, bh, s, d)
        times = {"onepass": cs.time_ms(
            lambda: fa.flash_bwd_onepass_f32_kernel(*bwd), reps=20)}
        with cs.flash_bwd_env("pallas_onepass"):
            times["onepass_and_sum"] = cs.time_ms(lambda: fa.flash_bwd(*bwd),
                                                  reps=20)
        times["copies"] = cs.time_ms(
            lambda: (fa.f32_vt(q), fa.f32_vt(do), fa.f32_vt(k)), reps=20)
        times["onepass_simt"] = cs.time_ms(
            lambda: fa.flash_bwd_onepass_simt_kernel(*bwd), reps=3)
        times["sdpa_bwd"] = cs.time_ms(lambda: torch.autograd.grad(
            out4, (q4, k4, v4), do4, retain_graph=True), reps=20)
        pass_flops = 2 * d * bh * (s * (s + 1) // 2 if causal else s * s)
        print("times f32 one-pass", cs.shape_label(bh, s, d, causal), times,
              "bound ms: split TF32 %.4g; this design (dP at %.0f TFLOP/s) "
              "%.4g" % (5 * pass_flops / peak * 1e3, cs.PEAK_F32_FLOPS / 1e12,
                        (4 * pass_flops / peak
                         + pass_flops / cs.PEAK_F32_FLOPS) * 1e3),
              flush=True)
        del q, k, v, do, o, q4, k4, v4, out4, do4, bwd
        torch.cuda.empty_cache()


def narrow_bwd(cs, fa, torch):
    """The Hopper backward kernels up to D 128: device ms, nothing else
    (every name used here is in the trees it compares)."""
    for dtype in ("bfloat16", "float16"):
        for bh, s, d, causal in (cs.DECODER_SHAPE, cs.BERT_SHAPE):
            q, k, v, do = cs.kernel_inputs(bh, s, d, dtype)
            o, lse = fa.flash_fwd_kernel(q, k, v, causal)
            delta = (do.float() * o.float()).sum(-1)
            bwd = (q, k, v, do, lse, delta, causal)
            times = {name: cs.time_ms(lambda f=f: f(*bwd), reps=20)
                     for name, f in (("dq", fa.flash_bwd_dq_kernel),
                                     ("dkv", fa.flash_bwd_dkv_kernel),
                                     ("onepass", fa.flash_bwd_onepass_kernel))}
            print("times narrow", dtype, "BH%d S%d D%d %s" % (
                bh, s, d, "causal" if causal else "full"), times, flush=True)
            del q, k, v, do, o, lse, delta, bwd
            torch.cuda.empty_cache()


def f32_bwd_times(cs, fa, torch):
    """The f32 dq and dk/dv on Hopper: device ms, nothing else."""
    for bh, s, d, causal in (cs.DECODER_SHAPE, cs.WIDE_HEAD_SHAPES[0],
                             cs.WIDER_HEAD_SHAPES[0], cs.BERT_SHAPE):
        q, k, v, do = cs.kernel_inputs(bh, s, d, "float32")
        o, lse = fa.flash_fwd_reference(q, k, v, causal)
        bwd = (q, k, v, do, lse, (do * o).sum(-1), causal)
        print("times f32 backward", cs.shape_label(bh, s, d, causal), {
            name: cs.time_ms(lambda f=f: f(*bwd), reps=20)
            for name, f in (("dq", fa.flash_bwd_dq_f32_kernel),
                            ("dkv", fa.flash_bwd_dkv_f32_kernel))},
            flush=True)
        del q, k, v, do, o, lse, bwd
        torch.cuda.empty_cache()


# flash_bwd_f32.cu with one part of the work left out: (copy, old, new)
F32_BWD_PARTS = (
    ("no_dp",
     "                                           int a0, const unsigned char* sb, int lane) {\n",
     "                                           int a0, const unsigned char* sb, int lane) {\n"
     "  if (lane >= 0) return;\n"),
    ("no_scores",
     "  wgmma_fence();\n#pragma unroll\n  for (int kk = 0; kk < CW / 8; ++kk)\n"
     "    mma3<64>(",
     "  if (cq >= 0) {\n#pragma unroll\n    for (int i = 0; i < 32; ++i)\n"
     "      d[i] = __uint_as_float(ah[i / 8][i % 4] ^ al[i / 8][(i + 1) % 4]);\n"
     "    return;\n  }\n"
     "  wgmma_fence();\n#pragma unroll\n  for (int kk = 0; kk < CW / 8; ++kk)\n"
     "    mma3<64>("),
    ("no_outputs",
     "    wgmma_fence();\n#pragma unroll\n    for (int jj = 0; jj < 4; ++jj)\n"
     "      mma3<W>(",
     "    if (lo > 0) {\n#pragma unroll\n      for (int i = 0; i < W / 2; ++i)\n"
     "        part[i] = (g ? part[i] : 0.f) + __uint_as_float(\n"
     "            h[i / 4 % 4][i % 4] ^ l[(i + 3) / 4 % 4][i % 4]);\n"
     "      continue;\n    }\n"
     "    wgmma_fence();\n#pragma unroll\n    for (int jj = 0; jj < 4; ++jj)\n"
     "      mma3<W>("))


# The Hopper one-pass past 256 with a part of its dq partial left out, in
# copies of flash_bwd_kv.cuh: the second k block's read-back (it stores
# over the first's partial), the partial's stores (and so the read-back),
# the partial's product and stores (the dS^T hand-over and K's panel
# stay).
WIDER_ONEPASS_PARTS = (
    ("no_readback", "            if (b > 0) {", "            if (b < 0) {"),
    ("no_stores", "              if (q0 + row < S) {",
     "              if (q0 + row < 0) {"),
    ("no_partial", "          for (int pc = 0; pc < PN / 64; ++pc) {",
     "          for (int pc = 0; pc < 0; ++pc) {"),
)


def wider_onepass_times(cs, fa, torch):
    """Device ms (20 calls each) in bf16 at the decoder's shape at 384 and
    at DECODER_D512_SHAPE of the Hopper one-pass, alone and with the
    partials' sum, where the tree's one-pass takes the width, and of the
    Hopper dq and dk/dv; no readings, no report."""
    for bh, s, d, causal in (cs.WIDER_HEAD_SHAPES[0], cs.DECODER_D512_SHAPE):
        q, k, v, do = cs.kernel_inputs(bh, s, d, "bfloat16")
        o, lse = fa.flash_fwd_kernel(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta, causal)
        times = {}
        if d in fa.flash_bwd_onepass_kernel.widths:
            times["onepass"] = cs.time_ms(
                lambda: fa.flash_bwd_onepass_kernel(*bwd), reps=20)
            with cs.flash_bwd_env("pallas_onepass"):
                times["onepass_and_sum"] = cs.time_ms(
                    lambda: fa.flash_bwd(*bwd), reps=20)
        times["dq"] = cs.time_ms(lambda: fa.flash_bwd_dq_kernel(*bwd),
                                 reps=20)
        times["dkv"] = cs.time_ms(lambda: fa.flash_bwd_dkv_kernel(*bwd),
                                  reps=20)
        print("times bfloat16", cs.shape_label(bh, s, d, causal), times,
              flush=True)
        del q, k, v, do, o, lse, delta, bwd
        torch.cuda.empty_cache()


def wider_onepass_parts(repo):
    """``--wider-onepass-times`` on this checkout, on each
    WIDER_ONEPASS_PARTS copy and on this checkout again, each in a process
    of its own."""
    trees = [repo] + [probe_copy(repo, "onepass-" + name, "flash_bwd_kv.cuh",
                                 (old,), (new,))
                      for name, old, new in WIDER_ONEPASS_PARTS] + [repo]
    rc = 0
    for tree in trees:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--wider-onepass-times", "--tree", tree]
                             ).returncode
    return rc


def f32_bwd_parts(repo):
    """``--f32-bwd-times`` on this checkout, on each F32_BWD_PARTS copy
    and on this checkout again, each in a process of its own."""
    trees = [repo] + [probe_copy(repo, "f32-bwd-" + name, "flash_bwd_f32.cu",
                                 (old,), (new,))
                      for name, old, new in F32_BWD_PARTS] + [repo]
    rc = 0
    for tree in trees:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--f32-bwd-times", "--tree", tree]).returncode
    return rc


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
    if "--watchdog" in argv:  # sm90.cuh's first line
        repo = probe_copy(repo, "probe", "sm90.cuh", ("#pragma once",),
                          ("#pragma once\n#define HVD_SM90_WATCHDOG 1",))
    if "--head-major" in argv:
        repo = probe_copy(repo, "probe-head-major", "flash_bwd.cu", BH_FIRST,
                          HEAD_MAJOR)
    if "--f32-bwd-parts" in argv:
        return f32_bwd_parts(repo)
    if "--wider-onepass-parts" in argv:
        return wider_onepass_parts(repo)
    if "--tree" in argv:
        repo = os.path.abspath(argv[argv.index("--tree") + 1])
    sys.path.insert(0, repo)
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
    if "--f32-split" in argv:
        f32_split(cs, torch)
        if "--f32-fwd" not in argv:
            return 0
    t0 = time.perf_counter()
    print("build", _build.build_all(), time.perf_counter() - t0, flush=True)
    times = {"--narrow-bwd": narrow_bwd, "--f32-bwd-times": f32_bwd_times,
             "--wider-onepass-times": wider_onepass_times}
    for arg, run in times.items():
        if arg in argv:
            print("tree", repo, flush=True)
            run(cs, fa, torch)
            return 0
    wide = {"--wide-fwd": ("flash_fwd", wide_fwd),
            "--wide-bwd": ("flash_bwd", wide_bwd),
            "--wider-bwd": ("flash_bwd", lambda cs, fa, torch: wide_bwd(
                cs, fa, torch, wider=True)),
            "--wide-onepass": ("flash_bwd_onepass", wide_onepass),
            "--wider-onepass": ("flash_bwd_onepass",
                                lambda cs, fa, torch: wide_onepass(
                                    cs, fa, torch, wider=True)),
            "--f32-fwd": ("flash_fwd_f32", f32_fwd),
            "--f32-bwd": ("flash_bwd_f32", f32_bwd),
            "--f32-onepass": ("flash_bwd_f32", f32_onepass)}
    wide = [wide[a] for a in wide if a in argv]
    for src in [src for src, _ in wide] or SOURCES:
        cs.print_ptxas((_build.build_dir() / ("%s.log" % src)).read_text())
    for _, probe in wide:
        probe(cs, fa, torch)
    if wide:
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
