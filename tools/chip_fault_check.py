#!/usr/bin/env python3
"""Planted kernel faults against the checks of ``chip_smoke.py``.

    python3 tools/chip_fault_check.py

Each fault is a one-line edit to a kernel source: a dropped part of the
attention sum, a one-pass slot left unwritten or written past its rows,
or a dropped row chunk, mask term or channel tile of the BatchNorm
kernels.  For each, the script copies ``horovod_tpu_torch/`` and
``chip_smoke.py`` into ``build/fault_check/<fault>/`` (ignored by git;
the sources in the checkout are not touched), applies the edit there,
and in a fresh process builds the kernels and runs chip_smoke's checks:
the flash kernels at its three attention shapes (a ragged full one, the
decoder's causal one, BERT-Large's full one; the one-pass partials land
in a NaN-poisoned block), the BN kernels at its four BN shapes, the
small decoder, the small ResNet-50 and the small BERT under both
backward choices.  The first case, ``none``, applies no edit.

It prints each case's readings, and for comparison whether the kernel
outputs would also pass a tolerance scaled by the tensor's largest
value, |err| <= 1e-3 + 1e-2 max|plain|.  Exits non-zero unless the
unedited kernels pass every check and every fault fails the check of
its kernel family (flash or BN); a dropped BN row chunk must fail it at
the stem's shape itself, and each one-pass fault at every attention
shape where its code runs (a dead causal tile exists only at the causal
shape, a ragged tail only at S 200).  A check process that dies counts
as a failed check: chip_smoke would exit non-zero.  Needs a CUDA device.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WORK = REPO / "build" / "fault_check"

# name -> (source, text as it stands, text with the fault, what it drops)
_DQ_ROW = "      const int row = q0 + r, col = kt * BK + c;\n"
_DKV_ROW = "      const int row = q0 + r, col = k0 + c;\n"
_MASK = "      const bool ok = row < S && col < S && (!CAUSAL || col <= row);"
_MASK_OFF_BY_ONE = ("      const bool ok = row < S && col < S && "
                    "(!CAUSAL || col < row + (2 * row < S));")
FAULTS = {
    "none": None,
    "fwd_diagonal_tile": (
        "flash_fwd.cu",
        "  for (int kt = 0; kt < kend; ++kt) {",
        "  for (int kt = 0; kt < kend - (CAUSAL && 2 * q0 >= S); ++kt) {",
        "forward: the diagonal k tile skipped for q rows in the second half"),
    "dkv_last_q_tile": (
        "flash_bwd.cu",
        "  for (int qt = qstart; qt < nq; ++qt) {",
        "  for (int qt = qstart; qt < nq - (CAUSAL && 2 * k0 < S); ++qt) {",
        "dk/dv: the last q tile skipped for k rows in the first half"),
    "fwd_mask_off_by_one": (
        "flash_fwd.cu",
        "        const bool ok = col < S && (!CAUSAL || col <= row);",
        "        const bool ok = col < S && (!CAUSAL || col < row + (2 * row < S));",
        "forward: causal mask drops the diagonal key in the second half"),
    "dq_mask_off_by_one": (
        "flash_bwd.cu", _DQ_ROW + _MASK, _DQ_ROW + _MASK_OFF_BY_ONE,
        "dq: causal mask drops the diagonal key in the second half"),
    "dkv_mask_off_by_one": (
        "flash_bwd.cu", _DKV_ROW + _MASK, _DKV_ROW + _MASK_OFF_BY_ONE,
        "dk/dv: causal mask drops the diagonal key in the second half"),
    "onepass_dead_tiles_not_zeroed": (
        "flash_bwd_onepass.cu",
        "  for (size_t i = threadIdx.x; i < (size_t)qstart * BQ * D / 4; i += 256)",
        "  for (size_t i = threadIdx.x; i < (size_t)0 * BQ * D / 4; i += 256)",
        "one-pass: the dead causal tiles' partial rows left unwritten"),
    "onepass_dkv_last_q_tile": (
        "flash_bwd_onepass.cu",
        "    for (int kk = 0; kk < BQ; kk += 16) {",
        "    for (int kk = 0; kk < BQ * (qt + 1 < nq); kk += 16) {",
        "one-pass: the last q tile left out of dk and dv"),
    "onepass_last_k_partial": (
        "flash_bwd_onepass.cu",
        "    for (int kk = 0; kk < BK; kk += 16) {",
        "    for (int kk = 0; kk < BK * (kt + 1 < nk); kk += 16) {",
        "one-pass: the last k tile's dq partial dropped (written as zeros)"),
    "onepass_ragged_rows_written": (
        "flash_bwd_onepass.cu",
        "    if (row0 + r < S)\n",
        "    if (true)\n",
        "one-pass: partial rows past S written (into the next slot)"),
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
    "bn_bwd_dx_last_tile": (
        "batch_norm.cu",
        "  float k[VEC], dbm[VEC], dgm[VEC];\n",
        "  if (blockIdx.x + 1 == gridDim.x) return;\n"
        "  float k[VEC], dbm[VEC], dgm[VEC];\n",
        "BN bwd_dx: the last channel tile skipped"),
}
# Faults that must fail their family's check at these shapes themselves:
# at the stem a dropped BN chunk is 1 of 1024, the smallest share of any
# held shape; a one-pass fault at each attention shape where its code
# runs.
RAGGED, DECODER, BERT = "BH4 S200 D64 full", "BH32 S2048 D128 causal", \
    "BH512 S384 D64 full"
MUST_FAIL_AT = {"bn_stats_last_chunk": {"stem"},
                "bn_bwd_red_last_chunk": {"stem"},
                "onepass_dead_tiles_not_zeroed": {DECODER},
                "onepass_dkv_last_q_tile": {RAGGED, DECODER, BERT},
                "onepass_last_k_partial": {RAGGED, DECODER, BERT},
                "onepass_ragged_rows_written": {RAGGED}}

CHILD = """
import json, torch, chip_smoke as cs
from horovod_tpu_torch.ops import batch_norm as bn
from horovod_tpu_torch.ops import flash_attention as fa
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
errs, poisoned = {}, {}
for bh, s, d, causal in cs.FLASH_SHAPES:
    label = "BH%d S%d D%d %s" % (bh, s, d, "causal" if causal else "full")
    e, poisoned[label], _, _ = cs.kernel_errors(
        fa, *cs.kernel_inputs(bh, s, d), causal)
    for name, outs in e.items():
        for out, v in outs.items():
            errs.setdefault(name, {})["%s at %s" % (out, label)] = v
    del e
    torch.cuda.empty_cache()
bn_errs = {}
for label, m, c, relu, residual in cs.BN_SHAPES:
    x, dy, res, g, b = cs.bn_inputs(m, c, residual)
    for name, outs in cs.bn_errors(bn, x, dy, res, g, b, relu)[0].items():
        for out, e in outs.items():
            bn_errs.setdefault(name, {})["%s at %s" % (out, label)] = e
loss, leaves = cs.model_errors()
rn_loss, rn_leaves, rn_bf16 = cs.resnet_model_errors()
bert = {c: cs.bert_model_errors(c) for c in ("pallas", "pallas_onepass")}
print(json.dumps({"kernels": errs, "poisoned": poisoned, "bn": bn_errs,
                  "loss": loss, "leaves": leaves, "rn_loss": rn_loss,
                  "rn_leaves": rn_leaves, "rn_bf16": rn_bf16,
                  "bert": bert}))
"""


def run_case(name, fault):
    work = WORK / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(REPO / "horovod_tpu_torch", work / "horovod_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", work / "chip_smoke.py")
    if fault:
        src, old, new, _ = fault
        path = work / "horovod_tpu_torch" / "csrc" / src
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError("%s: the line to edit is not in %s once"
                               % (name, src))
        path.write_text(text.replace(old, new))
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=work,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        return {"died": proc.stderr[-2000:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    ok = True
    for name, fault in FAULTS.items():
        res = run_case(name, fault)
        print("%s: %s" % (name, fault[3] if fault else "kernels as they are"))
        if "died" in res:
            print("  the check process died (a failed check):\n%s"
                  % res["died"])
            ok &= fault is not None
            continue
        print("  one-pass partials in a NaN-poisoned block: %s"
              % res["poisoned"])
        fails, failed_at = {}, set()
        for family in ("kernels", "bn"):
            kernel_fail = max_rule_fail = False
            for kern, outs in res[family].items():
                for out, e in outs.items():
                    max_rule = 1e-3 + 1e-2 * e["max_abs_plain"]
                    kernel_fail |= not e["worst"] <= 1.0
                    max_rule_fail |= not e["max_abs_err"] <= max_rule
                    if not e["worst"] <= 1.0:
                        failed_at.add(out.split(" at ", 1)[1])
                    print("  %s %s: worst %.4g, max abs err %.4g, max-scaled "
                          "limit %.4g" % (kern, out, e["worst"],
                                          e["max_abs_err"], max_rule))
            fails[family] = (kernel_fail, max_rule_fail)
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
        print("  verdict: flash check %s (max-scaled rule %s), BN check %s "
              "(max-scaled rule %s), decoder check %s, resnet check %s, bert "
              "check %s" % tuple("fails" if f else "passes"
                                 for f in fails["kernels"] + fails["bn"]
                                 + (model_fail, rn_fail, bert_fail)),
              flush=True)
        if failed_at:
            print("  failing at: %s" % ", ".join(sorted(failed_at)))
        if fault is None:
            ok &= not (fails["kernels"][0] or fails["bn"][0] or model_fail
                       or rn_fail or bert_fail)
        else:
            ok &= fails["bn" if fault[0] == "batch_norm.cu" else "kernels"][0]
            ok &= MUST_FAIL_AT.get(name, set()) <= failed_at
    shutil.rmtree(WORK, ignore_errors=True)
    print("fault check: %s" % ("ok" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
