#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the TF32 flags, and builds the kernels from
   ``horovod_tpu_torch/csrc`` (timed, as set-up).
2. Holds every kernel against its plain PyTorch version, run on the card
   in f32 on the same inputs, at the flagship attention shape (BH 32,
   S 2048, D 128, bf16, causal) and at a ragged non-causal one (BH 4,
   S 200, D 64); times kernel, plain version and the library yardstick
   (``scaled_dot_product_attention``, forward and backward) with CUDA
   events, and computes each kernel's bound.
3. Holds the decoder's loss and gradient on the card (bf16, kernels)
   against the same weights in f32 on the CPU (plain versions), at a
   small width.
4. The main path: ``hvd.init()`` as a one-rank NCCL world, the d1024 L12
   decoder of ``bench.py`` at full width from a numpy seed, broadcast of
   its parameters, and training steps of batch 4 at seq 2048 through
   ``DistributedOptimizer(Adam)`` and its fused allreduce.  Each kernel
   must launch 12 times a step.
5. Prints one JSON line of kernel records, then as the last line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line.  Needs a CUDA device
and the rest of the repository beside this file.
"""

import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# Each kernel output against its plain version, element by element:
#   |got - plain| <= rtol * |plain| + atol * scale(plain's row)
# (rtol, atol) per output; a row is one (bh, position) vector of D, or
# one bh row of lse, and its scale is its RMS (see ``compare``).  P and
# ds are rounded to bf16 before a product at another running max in the
# kernel than in the plain version, which moves a sum by a fraction of
# its row's scale rather than of its own value, hence the row term; rtol
# is one bf16 ulp.  lse is f32 throughout.  The limits sit above the
# readings of the correct kernels and far below planted faults
# (tools/chip_fault_check.py, PERF.md).
KERNEL_TOL = {"o": (2 ** -7, 2 ** -5), "lse": (2 ** -16, 2 ** -16),
              "dq": (2 ** -7, 2 ** -5), "dk": (2 ** -7, 2 ** -5),
              "dv": (2 ** -7, 2 ** -5)}
# The small decoder on the card (bf16, kernels) against f32 on the CPU:
# loss relative error, and each parameter gradient's relative norm error
# ||g_card - g_cpu|| / ||g_cpu||; readings 1.7e-4 and 2.5e-2 at worst.
LOSS_TOL, LEAF_TOL = 5e-4, 5e-2
STEPS = 5


def say(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps=10, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_inputs(bh, s, d):
    """q (pre-scaled), k, v and the output gradient, bf16, from a seed."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(bh * 100003 + s)

    def rnd(scale=1.0):
        return (torch.randn(bh, s, d, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    return rnd(1 / math.sqrt(d)), rnd(), rnd(), rnd()


def compare(got, want, rtol, atol):
    """Element-wise error of ``got`` against ``want``; ``worst`` is the
    largest |err| / (rtol |want| + atol scale(want's row)), at most 1
    to pass."""
    import torch
    got, want = got.float(), want.float()
    err = (got - want).abs()
    sq = want.square()
    # A row that cancels to almost nothing (dq's first causal row) keeps
    # the rounding of its terms: its scale is at least 1/16 of the
    # tensor's RMS.
    scale = torch.maximum(sq.mean(-1, keepdim=True).sqrt(),
                          sq.mean().sqrt() / 16)
    worst = (err / (rtol * want.abs() + atol * scale)).max()
    return {"max_abs_err": err.max().item(), "worst": worst.item(),
            "max_abs_plain": want.abs().max().item()}


def kernel_errors(fa, q, k, v, do, causal):
    """Every kernel's outputs against its plain version on the same
    inputs: {kernel: {output: compare(...)}}, plus lse and delta for
    the timings."""
    import torch
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(q, k, v, do, lse_ref,
                                                    delta, causal)
    o, lse = fa.flash_fwd_kernel(q, k, v, causal)
    dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse_ref, delta, causal)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    outputs = {"flash_fwd": {"o": (o, o_ref), "lse": (lse, lse_ref)},
               "flash_bwd_dq": {"dq": (dq, dq_ref)},
               "flash_bwd_dkv": {"dk": (dk, dk_ref), "dv": (dv, dv_ref)}}
    errs = {name: {out: compare(got, want, *KERNEL_TOL[out])
                   for out, (got, want) in outs.items()}
            for name, outs in outputs.items()}
    return errs, lse_ref, delta


def check_kernels(fa, bh, s, d, causal):
    """One shape: every kernel against its plain version, timed beside
    the plain version and SDPA; returns one record per kernel, whose
    ``launches`` counts this check's launches (not the main path's)."""
    import torch
    import torch.nn.functional as F
    q, k, v, do = kernel_inputs(bh, s, d)
    fa.reset_launch_counts()
    errs, lse_ref, delta = kernel_errors(fa, q, k, v, do, causal)
    for name, outs in errs.items():
        for out, e in outs.items():
            say("  %s %s: %s (rtol %.3g, atol %.3g x row scale)" % (
                name, out, json.dumps({k: float("%.4g" % x)
                                       for k, x in e.items()}),
                *KERNEL_TOL[out]))
    bad = ["%s %s" % (name, out) for name, outs in errs.items()
           for out, e in outs.items() if not e["worst"] <= 1.0]
    if bad:
        raise AssertionError("kernel output off its plain version: %s"
                             % ", ".join(bad))
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    io, rows = bh * s * d * 2, bh * s * 4
    work = {  # (FLOP, bytes): each input read once, each output written once
        "flash_fwd": (4 * d * pairs, 4 * io + rows),
        "flash_bwd_dq": (6 * d * pairs, 4 * io + 2 * rows + 2 * io),
        "flash_bwd_dkv": (8 * d * pairs, 6 * io + 2 * rows),
    }
    records = {}
    for name, outs in errs.items():
        rec = {"max_abs_err": max(e["max_abs_err"] for e in outs.values()),
               "worst": max(e["worst"] for e in outs.values())}
        rec["bound_ms"], rec["bound_by"] = bound(*work[name])
        records[name] = rec

    runs = {
        "flash_fwd": (lambda: fa.flash_fwd_kernel(q, k, v, causal),
                      lambda: fa.flash_fwd_reference(q, k, v, causal)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq_kernel(q, k, v, do, lse_ref, delta, causal),
            lambda: fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, causal)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv_kernel(q, k, v, do, lse_ref, delta, causal),
            lambda: fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, causal)),
    }
    # The yardstick, never called by the port: SDPA at the same shape
    # (q is pre-scaled, so scale=1).  Its backward computes dq, dk and
    # dv together and stands beside both backward kernels.
    q4, k4, v4 = (t.view(1, bh, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                                  scale=1.0)
    out4 = sdpa()
    do4 = do.view(1, bh, s, d)
    lib_fwd = time_ms(lambda: sdpa().detach())
    lib_bwd = time_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                  retain_graph=True))
    for name, (kern, plain) in runs.items():
        records[name]["ms"] = time_ms(kern, reps=20)
        records[name]["plain_ms"] = time_ms(plain)
        records[name]["library_ms"] = lib_fwd if name == "flash_fwd" else lib_bwd
    for name, wrapper in (("flash_fwd", fa.flash_fwd_kernel),
                          ("flash_bwd_dq", fa.flash_bwd_dq_kernel),
                          ("flash_bwd_dkv", fa.flash_bwd_dkv_kernel)):
        records[name]["launches"] = wrapper.launches
    return records


def model_errors():
    """Loss and gradients of a small decoder on the card (bf16, kernels)
    against the same weights in f32 on the CPU (plain versions): the
    loss's relative error and each parameter's relative gradient norm
    error."""
    import dataclasses
    import torch
    from horovod_tpu_torch.models.convert import init_params, params_from_jax
    from horovod_tpu_torch.models.transformer import TransformerConfig, loss_fn
    from horovod_tpu_torch.train import synthetic_batch

    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=2, n_kv_heads=1, d_ff=512, max_seq=256)
    cfg32 = dataclasses.replace(cfg, dtype="float32", logits_dtype="f32")
    params, batch = init_params(cfg, seed=1), synthetic_batch(cfg, 2, seed=1)
    out = []
    for c, dev in ((cfg, "cuda"), (cfg32, "cpu")):
        model = params_from_jax(params, c, dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss = loss_fn(model, b)
        loss.backward()
        out.append((loss.item(), {n: p.grad.float().cpu()
                                  for n, p in model.named_parameters()}))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out
    leaves = {n: ((g_gpu[n] - g).norm() / g.norm()).item()
              for n, g in g_cpu.items()}
    return abs(l_gpu - l_cpu) / abs(l_cpu), leaves


def check_model():
    loss_err, leaves = model_errors()
    worst = max(leaves, key=leaves.get)
    say("model check: loss relative error %.3g (tol %.3g); gradient "
        "relative norm error per parameter: worst %s %.3g (tol %.3g), %s"
        % (loss_err, LOSS_TOL, worst, leaves[worst], LEAF_TOL,
           json.dumps({n: float("%.3g" % e) for n, e in leaves.items()})))
    bad = [n for n, e in leaves.items() if not e <= LEAF_TOL]
    if not loss_err <= LOSS_TOL or bad:
        raise AssertionError("small decoder on the card disagrees with the "
                             "f32 CPU reference: loss %.3g, gradients of %s"
                             % (loss_err, bad))


def print_ptxas(text: str):
    """One line per kernel instantiation from nvcc's -Xptxas=-v report:
    registers, spills and shared memory."""
    name = None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            spills = ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "registers" in line:
            # _ZN8hvdflash16flash_fwd_kernelILi128ELb1EEEv... -> kernel<128, 1>
            k = re.search(r"hvdflash\d+(\w+?)ILi(\d+)ELb(\d)E", name)
            label = "%s<%s, %s>" % k.groups() if k else name
            say("  ptxas %-26s %s; %s" % (
                label, line.split(":", 1)[-1].strip(), spills))
            name = None


FAMILIES = (("flash_fwd", ("flash_fwd_kernel",)),
            ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
            ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
            ("allreduce (nccl)", ("nccl",)),
            ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
            ("optimizer (foreach)", ("multi_tensor_apply",)))


def profile_step(torch, step, data, step_ms):
    """Device time of one more flagship step by kernel family, from
    torch.profiler's kernel events.  The device's busy time is the union
    of the kernels' intervals; its idle share is taken against
    ``step_ms``, the unprofiled median step, since the profiled step's
    host time includes the profiler's own overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(data)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        say("profile: the profiler recorded no device time (not measured)")
        return
    busy, end = 0.0, -1.0
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    totals: dict = {}
    by_name: dict = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        low = e.name.lower()
        fam = next((f for f, keys in FAMILIES
                    if any(k in low for k in keys)), "other (elementwise, "
                                                    "reductions, copies)")
        totals[fam] = totals.get(fam, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    say("profile: one step, device busy %.2f ms, idle share %.1f%% of the "
        "%.2f ms median step (profiled step's host time %.2f ms)"
        % (busy / 1e3, 100 * (1 - busy / 1e3 / step_ms), step_ms,
           wall_us / 1e3))
    for fam, us in sorted(totals.items(), key=lambda kv: -kv[1]):
        say("  %-40s %9.3f ms  %5.1f%% of kernel time"
            % (fam, us / 1e3, 100 * us / sum(totals.values())))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say("  top kernel %9.3f ms  %s" % (us / 1e3, name[:110]))


def train_flagship(torch):
    import horovod_tpu_torch as hvd
    import torch.distributed as dist
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import TransformerConfig
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import make_train_step, synthetic_batch

    hvd.init()
    say("world: rank %d of %d, backend %s, device %s"
        % (hvd.rank(), hvd.size(), dist.get_backend(), hvd.device()))
    # bench.py:86-91, the d1024 L12 flagship at full width and depth.
    d, L, seq, batch = 1024, 12, 2048, 4
    cfg = TransformerConfig(vocab_size=8192, d_model=d, n_layers=L,
                            n_heads=d // 128, n_kv_heads=d // 128,
                            d_ff=d * 3, max_seq=seq)
    t0 = time.perf_counter()
    build, shard_batch = make_train_step(
        cfg, lambda params: torch.optim.Adam(params, 1e-3))
    step, model, opt = build(init_params(cfg, seed=0))
    data = shard_batch(synthetic_batch(cfg, batch, seed=0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say("flagship: d%d L%d hd%d seq %d batch %d, %d parameters, %d fused "
        "allreduce group(s); set-up %.1f s"
        % (d, L, cfg.head_dim, seq, batch, n_params, len(opt._groups),
           time.perf_counter() - t0))

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, times = [], []
    for i in range(STEPS):
        t = time.perf_counter()
        loss = step(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
        say("step %d: loss %.6f, %.2f ms" % (i, losses[-1], times[-1] * 1e3))
    counts = fa.launch_counts()
    med = statistics.median(times)
    say("flagship: median step_ms %.2f, tok/s %.1f, peak memory %.2f GB"
        % (med * 1e3, batch * seq / med,
           torch.cuda.max_memory_allocated() / 1e9))
    say("launches on the main path (%d steps): %s" % (STEPS, counts))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss: %s" % losses)
    for name, n in counts.items():
        if n != L * STEPS:
            raise AssertionError("%s launched %d times, expected %d"
                                 % (name, n, L * STEPS))
    profile_step(torch, step, data, med * 1e3)
    hvd.shutdown()
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    # -- 1: card, versions, flags, build
    say(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("torch %s, CUDA %s, device %s; tf32 matmul %s, tf32 cudnn %s"
        % (torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0),
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))
    t0 = time.perf_counter()
    built = _build.build_all()
    say("build: %.1f s wall, per source %s, into %s"
        % (time.perf_counter() - t0,
           {k: round(v, 1) for k, v in built.items()}, _build.build_dir()))
    for src in _build.sources():
        log = _build.build_dir() / ("%s.log" % src.stem)
        if log.exists():
            print_ptxas(log.read_text())

    # -- 2: kernels against their plain versions
    for bh, s, d, causal in ((4, 200, 64, False), (32, 2048, 128, True)):
        records = check_kernels(fa, bh, s, d, causal)
        for name, rec in records.items():
            say("kernel %s BH%d S%d D%d %s: %s" % (
                name, bh, s, d, "causal" if causal else "full",
                json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                            for k, v in rec.items()})))

    # -- 3: a small decoder against the f32 CPU reference
    check_model()

    # -- 4: the main path
    counts = train_flagship(torch)

    # -- 5: results
    sources = {"flash_fwd": ("horovod_tpu_torch/csrc/flash_fwd.cu",
                             "horovod_tpu/ops/pallas_kernels.py:51",
                             "flash_fwd_kernel"),
               "flash_bwd_dq": ("horovod_tpu_torch/csrc/flash_bwd.cu",
                                "horovod_tpu/ops/pallas_kernels.py:329",
                                "flash_bwd_dq_kernel"),
               "flash_bwd_dkv": ("horovod_tpu_torch/csrc/flash_bwd.cu",
                                 "horovod_tpu/ops/pallas_kernels.py:376",
                                 "flash_bwd_dkv_kernel")}
    say("kernels: " + "; ".join(
        "%s held at BH4 S200 D64 full and BH32 S2048 D128 causal (phase 2), "
        "launched %d times in training (phase 4)" % (name, counts[w])
        for name, (_, _, w) in sources.items()))
    out = []
    for name, (src, replaces, wrapper) in sources.items():
        rec = records[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": counts[wrapper],
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"]})
    say(json.dumps({"kernels": out}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
