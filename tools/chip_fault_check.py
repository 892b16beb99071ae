#!/usr/bin/env python3
"""Planted kernel faults against the checks of ``chip_smoke.py``.

    python3 tools/chip_fault_check.py [fault ...]

Each fault is a one-line edit to a kernel source (or a few lines, in
one or two files, that make one fault): a dropped part of the attention
sum, a mask off by one, lse in log2 units, V's or K's transpose bit
flipped, a one-pass slot left unwritten or written past its rows, dq
rows past S written, a stale ring stage, partial stores not awaited, a
dropped row chunk, mask term or channel tile of the BatchNorm kernels,
or a dropped ragged tail, a coefficient on the wrong operand or a
contracted FMA in the scale-sum kernel.  The dk/dv and one-pass kernels
share one body (``csrc/flash_bwd_kv.cuh``): a fault planted there is in
both.  For each, the
script copies ``horovod_tpu_torch/`` and ``chip_smoke.py`` into
``build/fault_check/<fault>/`` (ignored by git; the sources in the
checkout are not touched), defines ``HVD_SM90_WATCHDOG`` there (an
mbarrier wait of seconds traps, so a lost arrival ends its launch with
an error instead of hanging the card), applies the edit, and in a fresh
process builds the kernels and runs chip_smoke's checks: the flash
kernels at its five attention shapes (two ragged full ones at S 200 and
S 130, the decoder's causal one, BERT-Large's full one, a ragged causal
one at S 200 and D 32; the one-pass partials land in a NaN-poisoned
block), the BN kernels at its four BN shapes, the small decoder, the
small ResNet-50 and the small BERT under both backward choices, the
scale-sum kernel at every case of its bit check (its outputs in a
NaN-poisoned block), and the Adasum reduction of the small BERT's
gradients over four 2-row shards against the same reduction with the
plain version, bit for bit (the BERT-Large path's check at a size that
builds in seconds), then the codec phase's check of the fp8 edge values
(``codec_edge_mismatches``: the plain e4m3 cast's bytes on the card
against the reference's).  One fault is a codec's, planted in
``compression.py``: an fp8 cast that saturates instead of giving NaN;
its case runs the codec check alone.  The first case, ``none``, applies
no edit; names on the command line run ``none`` and those faults only.

A check process that dies is recorded at the shape (or at the model
checks) it was in, and a fresh process runs the rest, so that every
shape is held.  A death counts as a failed check (chip_smoke would exit
non-zero) only if its error is one of a kernel's execution (an illegal
address or instruction, a launch failure); any other death voids the
case.

It prints each case's readings, and for comparison whether the kernel
outputs would also pass a tolerance scaled by the tensor's largest
value, |err| <= 1e-3 + 1e-2 max|plain|.  Exits non-zero unless the
unedited kernels pass every check and every fault fails the check of
its kernel family (flash, BN, or scale-sum, whose faults must also fail
the Adasum bit check), at each shape that ``MUST_FAIL_AT`` names for
it.  Needs a CUDA device.
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WORK = REPO / "build" / "fault_check"

# name -> (source, text as it stands, text with the fault, what it drops);
# a fault of several edits gives tuples of texts, and a tuple of sources
# where they lie in more than one file
_KV = "flash_bwd_kv.cuh"
_KV_MASK = "if (!(q < S && kr < S && (!CAUSAL || kr <= q))) p[e] = 0.f;"
_KV_P = "p[e] = exp2f(fmaf(st[x], LOG2E, -(e ? ls.y : ls.x) * LOG2E));"
_DQ_STORE = ("tma_store_3d(mdq, so + p * 64 * PF::SWZ, p * PF::PC, "
             "q0 + 64 * wg, bh);")
_DQ_MAP = "panel_map<D, 4>(&mdq, dq, s, bh, 64)"
FAULTS = {
    "none": None,
    "fp8_cast_saturates": (
        "../compression.py",
        "    return torch.where(overflow, nan, wire).view(FP8_WIRE_DTYPE)",
        "    return x.clamp(-E4M3_MAX, E4M3_MAX).to(FP8_WIRE_DTYPE)",
        "codec: the plain e4m3 cast saturates at +-448 past its range and "
        "for infinities, where the reference gives NaN"),
    "fwd_diagonal_tile": (
        "flash_fwd.cu",
        "  const int kend = CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;",
        "  const int kend = CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1 - (2 * q0 >= S)) : nk;",
        "forward: the diagonal k tile skipped for q rows in the second half"),
    "dkv_last_q_tile": (
        _KV, _KV_P,
        _KV_P[:-1] + " * (CAUSAL && 2 * k0 < S && qstart + i + 1 == nq "
        "? 0.f : 1.f);",
        "dk/dv: the last q tile dropped (its P zero) for k rows in the first "
        "half"),
    "fwd_mask_off_by_one": (
        "flash_fwd.cu",
        "            if (!(col < S && (!CAUSAL || col <= row))) sc[4 * j + e] = NEG_INF;",
        "            if (!(col < S && (!CAUSAL || col < row + (2 * row < S)))) "
        "sc[4 * j + e] = NEG_INF;",
        "forward: causal mask drops the diagonal key in the second half"),
    "fwd_lse_log2": (
        "flash_fwd.cu",
        "lse[(size_t)bh * S + row] = m[h] + logf(lc[h]);",
        "lse[(size_t)bh * S + row] = m[h] * LOG2E + log2f(lc[h]);",
        "forward: lse left in log2 units"),
    "fwd_v_transpose_bit": (
        "flash_fwd.cu",
        "MmaRS<D, 1>::run(o, a, desc_mnmajor<D, BK>(sv, kk), 1);",
        "MmaRS<D, 0>::run(o, a, desc_mnmajor<D, BK>(sv, kk), 1);",
        "forward: V read K-major (its transpose bit flipped)"),
    "dq_mask_off_by_one": (
        "flash_bwd.cu",
        "if (!(col < S && (!CAUSAL || col <= row))) p = 0.f;",
        "if (!(col < S && (!CAUSAL || col < row + (2 * row < S)))) p = 0.f;",
        "dq: causal mask drops the diagonal key in the second half"),
    "dkv_mask_off_by_one": (
        _KV, _KV_MASK,
        "if (!(q < S && kr < S && (!CAUSAL || kr < q + (2 * q < S)))) "
        "p[e] = 0.f;",
        "dk/dv: causal mask drops the diagonal key in the second half"),
    "dq_diagonal_tile": (
        "flash_bwd.cu",
        "  const int kend = CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;",
        "  const int kend = CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1 - (2 * q0 >= S)) : nk;",
        "dq: the diagonal k tile skipped for q rows in the second half"),
    "dq_k_transpose_bit": (
        "flash_bwd.cu",
        "MmaRS<D, 1>::run(acc, a, desc_mnmajor<D, BK>(sk, kk), 1);",
        "MmaRS<D, 0>::run(acc, a, desc_mnmajor<D, BK>(sk, kk), 1);",
        "dq: K read K-major in dS K (its transpose bit flipped)"),
    "dq_stale_ring_stage": (
        "flash_bwd.cu",
        "      mbar_wait(&full[s], (i / STAGES) & 1);",
        "      mbar_wait(&full[s], ((i / STAGES) & 1) ^ (i >= STAGES));",
        "dq: a ring stage read again before its next k tile lands (wrong "
        "parity)"),
    "dq_ragged_rows_written": (
        "flash_bwd.cu",
        (_DQ_MAP, _DQ_STORE, "dl[h] = row < S ? delta[at] : 0.f;"),
        ("panel_map<D, 4>(&mdq, dq, (uint64_t)s * bh, 1, 64)",
         _DQ_STORE.replace("q0 + 64 * wg, bh);", "bh * S + q0 + 64 * wg, 0);"),
         "dl[h] = row < S ? delta[at] : 1.f;"),
        "dq: rows past S written (dq's map flattened, so the next head's "
        "first rows take them; their delta 1, so that they are not zeros)"),
    "onepass_dead_tiles_not_zeroed": (
        _KV,
        "      for (size_t i = t + 128 * wg; i < (size_t)qstart * BQ * D / 4; i += 256)",
        "      for (size_t i = t + 128 * wg; i < (size_t)0 * BQ * D / 4; i += 256)",
        "one-pass: the dead causal tiles' partial rows left unwritten"),
    "onepass_dead_slot_last_tile": (
        _KV,
        "      for (size_t i = t + 128 * wg; i < (size_t)qstart * BQ * D / 4; i += 256)",
        "      for (size_t i = t + 128 * wg; i < (size_t)max(qstart - 1, 0) * BQ * D "
        "/ 4; i += 256)",
        "one-pass: the last dead q tile's rows of a slot left unwritten"),
    "onepass_dkv_last_q_tile": (
        _KV,
        "      for (int kk = 0; kk < BQ / 16; ++kk) {\n"
        "        const uint32_t a[4] = {pp[",
        "      for (int kk = 0; kk < BQ / 16 * (qstart + i + 1 < nq); ++kk) {\n"
        "        const uint32_t a[4] = {pp[",
        "one-pass and dk/dv: the last q tile left out of dv"),
    "onepass_last_k_partial": (
        _KV,
        "        for (int kk = 0; kk < BK / 16; ++kk)\n"
        "          MmaSS<D / 2, 1, 1>",
        "        for (int kk = 0; kk < BK / 16 * (kt + 1 < nk); ++kk)\n"
        "          MmaSS<D / 2, 1, 1>",
        "one-pass: the last k tile's dq partial dropped (its registers unset)"),
    "onepass_ragged_rows_written": (
        ("flash_bwd_onepass.cu", _KV, _KV),
        ("panel_map<D / 2, 4>(&mdqp, dqp, s, (uint64_t)bh * nk, kv::BQ, D)",
         "q0,\n                         bh * nk + kt);",
         _KV_MASK),
        ("panel_map<D / 2, 4>(&mdqp, dqp, (uint64_t)s * bh * nk, 1, kv::BQ, D)",
         "(bh * nk + kt) * S + q0,\n                         0);",
         "if (!(kr < S && (!CAUSAL || kr <= q))) p[e] = 0.f;"),
        "one-pass: partial rows past S written (the partials' map flattened, "
        "so the next slot takes them; the rows past S unmasked, so that "
        "they are not zeros)"),
    "onepass_stale_ring_stage": (
        _KV,
        "      mbar_wait(&full[s], (i / STAGES) & 1);",
        "      mbar_wait(&full[s], ((i / STAGES) & 1) ^ (i >= STAGES));",
        "one-pass and dk/dv: a ring stage read again before its next tile "
        "lands (wrong parity)"),
    "onepass_partial_store_unawaited": (
        _KV,
        "      if (t == 0) tma_store_wait_read<0>();\n      named_sync(1, 256);",
        "      named_sync(1, 256);",
        "one-pass: the last partial TMA stores not awaited before the "
        "epilogue reuses their buffers"),
    "bn_stats_last_chunk": (
        "batch_norm.cu",
        "      static_cast<float*>(sq), (int)grid.y, c);",
        "      static_cast<float*>(sq), (int)grid.y - 1, c);",
        "BN stats: the last row chunk left out of the sums"),
    "bn_bwd_red_last_chunk": (
        "batch_norm.cu",
        "      static_cast<float*>(dgamma), (int)grid.y, c);",
        "      static_cast<float*>(dgamma), (int)grid.y - 1, c);",
        "BN bwd_red: the last row chunk left out of the sums"),
    "bn_bwd_red_mask_residual": (
        "batch_norm.cu",
        "        const float de = xhat_dy<RELU, RES>(",
        "        const float de = xhat_dy<RELU, false>(",
        "BN bwd_red: the residual left out of the recomputed ReLU mask"),
    "scale_sum_tail_dropped": (
        "scale_sum.cu",
        "    done = nv * V;",
        "    done = n;",
        "scale-sum: the elements past the last whole vector left unwritten"),
    "scale_sum_beta_on_a": (
        "scale_sum.cu",
        "__fmul_rn(beta, widen(b))",
        "__fmul_rn(beta, widen(a))",
        "scale-sum: beta applied to a"),
    "scale_sum_fma": (
        "scale_sum.cu",
        "__fadd_rn(__fmul_rn(alpha, widen(a)), __fmul_rn(beta, widen(b)))",
        "alpha * widen(a) + beta * widen(b)",
        "scale-sum: compiled with FMA contraction"),
    "bn_bwd_dx_last_tile": (
        "batch_norm.cu",
        "  float k[VEC], dbm[VEC], dgm[VEC];\n",
        "  if (blockIdx.x + 1 == gridDim.x) return;\n"
        "  float k[VEC], dbm[VEC], dgm[VEC];\n",
        "BN bwd_dx: the last channel tile skipped"),
}
# Faults that must fail their family's check at these shapes themselves:
# at the stem a dropped BN chunk is 1 of 1024, the smallest share of any
# held shape; a flash fault at each attention shape where its code runs
# (a dead causal tile, the diagonal and the causal mask only at the
# causal shapes, rows past S only at the ragged ones; every shape has a
# k-tile block with three q tiles or more, so a second round of its ring,
# but only the decoder's and BERT's have a dq block with three k tiles).
# The unawaited partial stores are a race: it shows where thousands of
# blocks run, at the decoder's and BERT's shapes, not at the three small
# ones.  So are dq rows past S, which land in the next head's first q
# tile: they show where that tile's block ends first, at the ragged
# causal shape, whose last q tile has twice the k tiles of its first.
RAGGED, DECODER, BERT = "BH4 S200 D64 full", "BH32 S2048 D128 causal", \
    "BH512 S384 D64 full"
RAGGED32, RAGGED128 = "BH4 S200 D32 causal", "BH2 S130 D128 full"
ALL = {RAGGED, DECODER, BERT, RAGGED32, RAGGED128}
CAUSAL = {DECODER, RAGGED32}
RAGGED_S = {RAGGED, RAGGED32, RAGGED128}
MUST_FAIL_AT = {"bn_stats_last_chunk": {"stem"},
                "bn_bwd_red_last_chunk": {"stem"},
                "fwd_diagonal_tile": CAUSAL,
                "fwd_mask_off_by_one": CAUSAL,
                "fwd_lse_log2": ALL,
                "fwd_v_transpose_bit": ALL,
                "dq_mask_off_by_one": CAUSAL,
                "dq_diagonal_tile": CAUSAL,
                "dq_k_transpose_bit": ALL,
                "dq_stale_ring_stage": {DECODER, BERT},
                "dq_ragged_rows_written": {RAGGED32},
                "dkv_last_q_tile": CAUSAL,
                "dkv_mask_off_by_one": CAUSAL,
                "onepass_dead_tiles_not_zeroed": CAUSAL,
                "onepass_dead_slot_last_tile": CAUSAL,
                "onepass_dkv_last_q_tile": ALL,
                "onepass_last_k_partial": ALL,
                "onepass_ragged_rows_written": RAGGED_S,
                "onepass_stale_ring_stage": ALL,
                "onepass_partial_store_unawaited": {DECODER, BERT}}
# What a check process that dies must have said: an error of a kernel's
# execution (cudaErrorIllegalAddress 700, 714-719: hardware stack error,
# illegal instruction, misaligned address, invalid address space, invalid
# program counter, launch failure), not a build or Python error.
CUDA_FAULT = re.compile(
    r"CUDA error (700|71[4-9])\b|CUDA error: (an illegal memory access|an "
    r"illegal instruction|misaligned address|unspecified launch failure|"
    r"hardware stack error|operation not supported on global/shared address "
    r"space|invalid program counter)")
MODELS = "the model checks"
CODECS = "the codec check"
CODEC_FAULTS = {"fp8_cast_saturates"}

CHILD = """
import json, sys, torch, chip_smoke as cs
from horovod_tpu_torch.ops import batch_norm as bn
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import scale_sum as ss
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
nf, nb = len(cs.FLASH_SHAPES), len(cs.BN_SHAPES)
for unit in json.loads(sys.argv[1]):
    print("AT %d" % unit, flush=True)
    if unit < nf:
        bh, s, d, causal = cs.FLASH_SHAPES[unit]
        errs, poisoned, _, _ = cs.kernel_errors(
            fa, *cs.kernel_inputs(bh, s, d), causal)
        res = {"errs": errs, "poisoned": poisoned}
    elif unit < nf + nb:
        label, m, c, relu, residual = cs.BN_SHAPES[unit - nf]
        x, dy, r, g, b = cs.bn_inputs(m, c, residual)
        res = {"errs": cs.bn_errors(bn, x, dy, r, g, b, relu)[0]}
        del x, dy, r
    elif unit == nf + nb + 1:
        res = {"edge": cs.codec_edge_mismatches()}
    else:
        loss, leaves = cs.model_errors()
        rn_loss, rn_leaves, rn_bf16 = cs.resnet_model_errors()
        res = {"loss": loss, "leaves": leaves, "rn_loss": rn_loss,
               "rn_leaves": rn_leaves, "rn_bf16": rn_bf16,
               "bert": {c: cs.bert_model_errors(c)
                        for c in ("pallas", "pallas_onepass")},
               "scale_sum": cs.scale_sum_errors(ss),
               "adasum": cs.small_bert_adasum_errors(ss)}
    print("RESULT " + json.dumps(res), flush=True)
    torch.cuda.empty_cache()
"""


def unit_labels(cs):
    """The check units of a case, in the order a check process runs them:
    each attention shape, each BN shape, the model checks, then the codec
    check."""
    return ([cs.shape_label(*shape) for shape in cs.FLASH_SHAPES]
            + [shape[0] for shape in cs.BN_SHAPES] + [MODELS, CODECS])


def run_case(name, fault, labels, units=None):
    """Copy the package, plant ``fault`` (and the mbarrier watchdog, so a
    lost arrival traps instead of hanging) and run the check units
    ``units`` (indices into ``labels``; every one if None).  A process
    that dies is recorded at the unit it was in, and a fresh one runs the
    units after it.  -> ({label: readings}, {label: the dead process's
    stderr})."""
    work = WORK / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(REPO / "horovod_tpu_torch", work / "horovod_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", work / "chip_smoke.py")
    csrc = work / "horovod_tpu_torch" / "csrc"
    header = csrc / "sm90.cuh"
    header.write_text("#define HVD_SM90_WATCHDOG 1\n" + header.read_text())
    if fault:
        src, old, new, _ = fault
        if not isinstance(old, tuple):
            src, old, new = (src,), (old,), (new,)
        elif not isinstance(src, tuple):
            src = (src,) * len(old)
        for s, o, n in zip(src, old, new):
            path = csrc / s
            text = path.read_text()
            if text.count(o) != 1:
                raise RuntimeError("%s: the text to edit is not in %s once"
                                   % (name, s))
            path.write_text(text.replace(o, n))
    readings, died = {}, {}
    todo = list(range(len(labels))) if units is None else list(units)
    while todo:
        try:
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, json.dumps(todo)], cwd=work,
                capture_output=True, text=True, timeout=900)
            out, err, rc = proc.stdout, proc.stderr, proc.returncode
        except subprocess.TimeoutExpired as e:
            out = (e.stdout or b"").decode(errors="replace")
            err, rc = "the check process timed out after 900 s", None
        at = None
        for line in out.splitlines():
            if line.startswith("AT "):
                at = int(line[3:])
            elif line.startswith("RESULT "):
                readings[labels[at]] = json.loads(line[7:])
        if rc == 0:
            break
        if at is None:  # before the first unit: the build or an import
            died["set-up"] = err[-2000:]
            break
        readings.pop(labels[at], None)
        died[labels[at]] = err[-2000:]
        todo = todo[todo.index(at) + 1:]
    return readings, died


def check_family(readings, labels):
    """Print each kernel output's readings at ``labels``; -> (the labels
    where an output is past its limit, whether an output would also fail
    the max-scaled rule)."""
    failed_at, max_rule_fail = set(), False
    for label in labels:
        if label not in readings:
            continue
        for kern, outs in readings[label]["errs"].items():
            for out, e in outs.items():
                max_rule = 1e-3 + 1e-2 * e["max_abs_plain"]
                max_rule_fail |= not e["max_abs_err"] <= max_rule
                if not e["worst"] <= 1.0:
                    failed_at.add(label)
                print("  %s %s at %s: worst %.4g, max abs err %.4g, "
                      "max-scaled limit %.4g" % (kern, out, label, e["worst"],
                                                 e["max_abs_err"], max_rule))
    return failed_at, max_rule_fail


def model_verdicts(cs, res):
    """Print the model, scale-sum and Adasum readings; -> whether the
    decoder, ResNet, BERT, scale-sum and Adasum checks fail."""
    leaves = res["leaves"]
    worst_leaf = max(leaves, key=leaves.get)
    model_fail = (not res["loss"] <= cs.LOSS_TOL
                  or not leaves[worst_leaf] <= cs.LEAF_TOL)
    rn_leaves = res["rn_leaves"]
    rn_worst = max(rn_leaves, key=rn_leaves.get)
    rn_fail = (not res["rn_loss"] <= cs.RN_LOSS_TOL
               or not rn_leaves[rn_worst] <= cs.RN_LEAF_TOL
               or not res["rn_bf16"] <= cs.RN_BF16_LOSS_TOL)
    bert_fail = False
    print("  decoder: loss rel err %.4g, worst leaf %s %.4g"
          % (res["loss"], worst_leaf, leaves[worst_leaf]))
    print("  resnet: f32 loss rel err %.4g, worst leaf %s %.4g, bf16 loss "
          "rel err %.4g" % (res["rn_loss"], rn_worst, rn_leaves[rn_worst],
                            res["rn_bf16"]))
    for choice, (b_loss, b_leaves) in res["bert"].items():
        b_worst = max(b_leaves, key=b_leaves.get)
        bert_fail |= (not b_loss <= cs.BERT_LOSS_TOL
                      or not b_leaves[b_worst] <= cs.BERT_LEAF_TOL)
        print("  bert (%s): loss rel err %.4g, worst leaf %s %.4g"
              % (choice, b_loss, b_worst, b_leaves[b_worst]))
    ss_bad = {k: v for k, v in res["scale_sum"].items() if v[0]}
    print("  scale_sum: %d of %d cases with any bit off; %s"
          % (len(ss_bad), len(res["scale_sum"]), json.dumps(
              dict(list(ss_bad.items())[:6]))))
    n_t, n_el, worst, total = res["adasum"]
    print("  adasum (small BERT, 4 shards): %d tensors and %d of %d "
          "elements with any bit off the plain reduction, max abs err %.4g"
          % (n_t, n_el, total, worst))
    return model_fail, rn_fail, bert_fail, bool(ss_bad), n_t > 0


def main(argv) -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device", file=sys.stderr)
        return 2
    unknown = set(argv) - set(FAULTS)
    if unknown:
        print("chip_fault_check: no fault named %s" % ", ".join(sorted(unknown)),
              file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    labels = unit_labels(cs)
    nf = len(cs.FLASH_SHAPES)
    flash_labels, bn_labels = labels[:nf], labels[nf:-2]
    ok = True
    for name, fault in FAULTS.items():
        if argv and name != "none" and name not in argv:
            continue
        if name in CODEC_FAULTS:
            readings, died = run_case(name, fault, labels,
                                      [labels.index(CODECS)])
            edge = readings.get(CODECS, {}).get("edge")
            print("%s: %s\n  fp8 edge values off the reference's bytes: %s"
                  "\n  verdict: codec check %s" % (
                      name, fault[3], edge,
                      "fails" if edge or died else "passes"), flush=True)
            ok &= bool(edge) and not died
            continue
        readings, died = run_case(name, fault, labels)
        print("%s: %s" % (name, fault[3] if fault else "kernels as they are"))
        cuda_deaths = set()
        for label, err in died.items():
            valid = bool(CUDA_FAULT.search(err))
            print("  the check process died at %s (%s):\n%s" % (
                label, "a CUDA fault, a failed check" if valid else
                "NOT a kernel's fault: the case is void", err))
            ok &= valid
            if valid:
                cuda_deaths.add(label)
        print("  one-pass partials in a NaN-poisoned block: %s"
              % {label: readings[label]["poisoned"]
                 for label in flash_labels if label in readings})
        flash_at, flash_max = check_family(readings, flash_labels)
        bn_at, bn_max = check_family(readings, bn_labels)
        flash_at |= cuda_deaths & set(flash_labels)
        bn_at |= cuda_deaths & set(bn_labels)
        if MODELS in readings:
            models = model_verdicts(cs, readings[MODELS])
        else:
            models = (MODELS in cuda_deaths,) * 5
        print("  verdict: flash check %s (max-scaled rule %s), BN check %s "
              "(max-scaled rule %s), decoder check %s, resnet check %s, bert "
              "check %s, scale_sum check %s, adasum check %s"
              % tuple("fails" if f else "passes"
                      for f in (bool(flash_at), flash_max, bool(bn_at),
                                bn_max) + models), flush=True)
        failed_at = flash_at | bn_at
        if failed_at:
            print("  failing at: %s" % ", ".join(sorted(failed_at)))
        if fault is None:
            edge = readings.get(CODECS, {}).get("edge")
            print("  codec check: fp8 edge values off the reference's "
                  "bytes: %s" % edge)
            ok &= not (died or failed_at or any(models) or edge
                       or CODECS not in readings)
        elif fault[0] == "scale_sum.cu":
            ok &= models[3] and models[4]
        else:
            family_at = bn_at if fault[0] == "batch_norm.cu" else flash_at
            must = MUST_FAIL_AT.get(name, set())
            ok &= bool(family_at) and must <= family_at
            if must - family_at:
                print("  MISSED at: %s" % ", ".join(sorted(must - family_at)))
    shutil.rmtree(WORK, ignore_errors=True)
    print("fault check: %s" % ("ok" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
