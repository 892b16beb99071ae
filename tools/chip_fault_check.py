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
its case runs the codec check alone.  Five are the CUDA-core flash
kernels' (``flash_simt.cu``: a causal mask off by one, the last live k
tile skipped, P not cast to V's dtype, the last 32-row tile of a D 256
one-pass slot skipped, a 128-column panel left out of the scores past
256); their cases run chip_smoke's CUDA-core checks alone, at
SIMT_SHAPES in f32, f16 and bf16, and the other faults' cases leave
those checks out.  A fault in a source of the Hopper kernels, which all
run in f16 too, is held at the f16 units as well (the four kernels in
f16 at the five attention shapes); four faults are f16's own: f16 read
as bf16 (the tensor map's type and the products'), the same in dq alone
and in dk/dv alone (their f16 entries launching the bf16 instances), and
the forward's causal mask off by one in f16 only.  A fault in the Hopper
forward's sources (``flash_fwd.cu``, ``sm90.cuh``) is also held at its
units from head dim 256 on (chip_smoke's HOPPER_FWD_SHAPES and
WIDE_BH_D256_SHAPE in bf16 and f16; past 256 with the panel agreement,
o's panels bit for bit against panel 0's on a V whose later panels copy
its first); two faults are its own: the last 64-column chunk of Q K^T
dropped at D 256, and past 256 the panel blocks after panel 0 streaming
the score chunks in another order (and writing lse).  The Hopper dq,
dk/dv and one-pass at D 256 (the dq kernel's wide plan, and the dk/dv and
one-pass kernels on ``flash_bwd_kv.cuh``'s ``kv256::kblock_body``) run at
the D 256 ones of those units, so a fault in any of their sources is held
there too; six faults are theirs alone and must fail nowhere else
(``ONLY_AT``): the last 64-column chunk of Q K^T dropped from dq's
scores, the last 16 q rows of every tile left out of dK (in dk/dv and
the one-pass), and four in the one-pass's dq partials at 256, which must
also fail no kernel but the one-pass (``ONLY_KERNEL``): a block's partial
stored into the next block's slot, dS^T read without consumer 1's
barrier (a race, held at the decoder's shape), consumer 1's 128 columns
left unwritten, and a slot's rows above the causal diagonal left
unwritten.  The f32 kernels on Hopper (the forward, ``flash_fwd_f32.cu``,
and dq and dk/dv, ``flash_bwd_f32.cu``, sharing ``tf32.cuh``'s split,
and their transposed copies, ``ops/flash_attention.py f32_vt``) are held
at their own units (chip_smoke's F32_FWD_SHAPES and WIDE_BH_SHAPE in
f32, past 256 with the panel agreement); a fault in any of those files
runs the first units and those, and their faults must fail there and
nowhere else (``ONLY_AT``): one small term of the shared split left out
(two TF32 terms, off by about 2^-11 a product), V^T's keys one off (a
roll before the key order), the last 32-column chunk of the forward's
Q K^T left out past 256, the forward's causal mask off by one; five of
dq and dk/dv, which must also fail no kernel but those two and the f32
one-pass, whose body is dk/dv's (``ONLY_KERNEL``): a small term left out
of their output products, K^T's, Q^T's and dO^T's rows one off, the last
panel block past 256 not launched, their causal mask off by one, and the
P^T hand-over read before its barrier; and four of the f32 one-pass,
which must fail no kernel but it: a 128-row slot's second k block
stored over the first's partial instead of added to it, a causal slot's
rows above its diagonal left unwritten, the last panel's partial columns
past 256 left unwritten, and dS read from the exchange tile before its
barrier (a race, held at BERT-Large's shape and at S 2048 at D 256 and
384).  Past 256 the Hopper dq, dk/dv and one-pass are their panel
kernels (``flash_bwd_dq_wide_kernel``, and ``flash_bwd_dkv_wide_kernel``
and ``flash_bwd_onepass_wide_kernel`` on ``flash_bwd_kv.cuh``'s
``wide::kv_body``), held at the Hopper units past 256
(HOPPER_FWD_SHAPES at 384 and 640, and WIDE_BH_D384_SHAPE, in bf16 and
f16, with the panel agreement, the one-pass's partials also in a
NaN-poisoned block and over a second launch); eight faults are theirs
and must fail there alone (``ONLY_AT``) and in no other kernel
(``ONLY_KERNEL``): the panel blocks after panel 0 streaming the score
chunks in another order (which must fail the panel agreement and no
other output, ``ONLY_OUTPUT``), the last 128-column panel not launched,
dq's last 64-column chunk of dP dropped, consumer 1 of the shared body
reading P^T before its barrier (dk/dv and the one-pass), and four of the
one-pass's, which must fail no kernel but it: a 128-row slot's second k
block stored over the first's partial instead of added to it, the last
128-column panel's partial columns left unwritten, consumer 0 reading
dS^T before its barrier (a race, made to lose by a sleep in consumer 1
before its write), and a causal slot's rows above its diagonal left
unwritten.  The older
dq and dk/dv faults (the masks, the diagonal tile, K's transpose bit,
rows past S, the last q tile, f16 read as bf16) lie in code that every
width runs (dq's row reads, live tiles and dS are ``dqtile``'s helpers,
which its panel kernel shares; the f16 entries' macro launches all
plans), or are planted in both dk/dv kernels.  The first case,
``none``,
applies no edit; names on the command line run ``none`` and those faults
only.

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
# the mask of both dk/dv kernels and the one-pass (kv::dead), and the
# dk/dv kernels' P (in both files)
_KV_MASK = "return !(q < S && k < S && (!CAUSAL || k <= q));"
_KV_P = "exp2f(fmaf(st[x], LOG2E, -(e ? ls.y : ls.x) * LOG2E));"
_DQ_STORE = ("tma_store_3d(mdq, so + p * 64 * PF::SWZ, p * PF::PC, "
             "q0 + 64 * wg, bh);")
_DQ_MAP = "panel_map<D>(&mdq, dq, s, bh, 64)"
# dq's row stores at D 256
_DQ256_STORE = ("        if (row < S) {\n#pragma unroll\n"
                "          for (int j = 0; j < D / 8; ++j)")
# the comment above the Hopper dk/dv and one-pass consumers' lse and delta
# reads past 256
_DKV_WIDE_ROWS = ("        // lse (consumer 0, in log2 units) or delta (consumer 1) "
                  "of this")
# the CUDA-core kernels' loops over the 128-column panels of the scores
_SIMT_PANELS = tuple("for (int p = 0; p < np; ++p) {  // " + c for c in (
    "S = Q K^T over every panel", "S again, V's panel with the last",
    "S = Q K^T, dP = dO V^T over every panel",
    "S^T = K Q^T, dP^T = V dO^T, every panel"))
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
        "  return CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;",
        "  return CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1 - (2 * q0 >= S)) : nk;",
        "forward: the diagonal k tile skipped for q rows in the second half"),
    "dkv_last_q_tile": (
        _KV, ("p[e] = " + _KV_P, "st[x] = " + _KV_P),
        tuple(lhs + _KV_P[:-1] + " * (CAUSAL && 2 * k0 < S && qstart + i + 1 "
              "== nq ? 0.f : 1.f);" for lhs in ("p[e] = ", "st[x] = ")),
        "dk/dv and one-pass (both bodies): the last q tile dropped (its P "
        "zero) for k rows in the first half"),
    "fwd_mask_off_by_one": (
        "flash_fwd.cu",
        "        if (!(col < S && (!CAUSAL || col <= row))) sc[4 * j + e] = NEG_INF;",
        "        if (!(col < S && (!CAUSAL || col < row + (2 * row < S)))) "
        "sc[4 * j + e] = NEG_INF;",
        "forward: causal mask drops the diagonal key in the second half"),
    "fwd_lse_log2": (
        "flash_fwd.cu",
        "lse[(size_t)bh * S + row] = m[h] + logf(lc[h]);",
        "lse[(size_t)bh * S + row] = m[h] * LOG2E + log2f(lc[h]);",
        "forward: lse left in log2 units"),
    "fwd_v_transpose_bit": (
        "flash_fwd.cu",
        "MmaRS<N, 1, T>::run(o, a, desc_mnmajor<N, BK>(sv, kk), 1);",
        "MmaRS<N, 0, T>::run(o, a, desc_mnmajor<N, BK>(sv, kk), 1);",
        "forward: V read K-major (its transpose bit flipped)"),
    "dq_mask_off_by_one": (
        "flash_bwd.cu",
        "if (!(col < S && (!CAUSAL || col <= row))) p = 0.f;",
        "if (!(col < S && (!CAUSAL || col < row + (2 * row < S)))) p = 0.f;",
        "dq (both plans): causal mask drops the diagonal key in the second "
        "half"),
    "dkv_mask_off_by_one": (
        _KV, _KV_MASK,
        "return !(q < S && k < S && (!CAUSAL || k < q + (2 * q < S)));",
        "dk/dv (both kernels) and one-pass (one mask, kv::dead): causal mask "
        "drops the diagonal key in the second half"),
    "dq_diagonal_tile": (
        "flash_bwd.cu",
        "  const int kend = CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;",
        # after the cap, which S 130 at D 256 reaches
        "  const int kend = CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) - (2 * q0 >= S) "
        ": nk;",
        "dq (both plans): the diagonal k tile skipped for q rows in the "
        "second half"),
    "dq_k_transpose_bit": (
        "flash_bwd.cu",
        "MmaRS<D, 1, T>::run(acc, a, desc_mnmajor<D, BK>(sk, kk), 1);",
        "MmaRS<D, 0, T>::run(acc, a, desc_mnmajor<D, BK>(sk, kk), 1);",
        "dq (both plans): K read K-major in dS K (its transpose bit "
        "flipped)"),
    "dq_d256_last_chunk": (
        "flash_bwd.cu",
        "      for (int kk = 0; kk < D / 16; ++kk)  // S, over every 64-column panel",
        "      for (int kk = 0; kk < D / 16 - 4 * L::WIDE; ++kk)  // S, over every "
        "64-column panel",
        "dq at D 256: the last 64-column chunk of Q K^T left out of the "
        "scores"),
    "dkv_d256_dk_last_rows": (
        _KV,
        "      for (int kk = 0; kk < BQ / 16; ++kk) {  // every 16 q rows of the tile",
        "      for (int kk = 0; kk < BQ / 16 - wg; ++kk) {  // every 16 q rows of the tile",
        "dk/dv and one-pass at D 256: the last 16 q rows of every q tile "
        "left out of dK (consumer 1's last k-step)"),
    "onepass_d256_neighbour_slot": (
        _KV, "        float* out = slot + (size_t)q0 * D + c2;",
        "        float* out = slot + (size_t)(q0 + S * (kt + 1 < nk)) * D + c2;",
        "one-pass at D 256: a k block's dq partial stored into the next "
        "64-row block's slot (the last block's into its own)"),
    "onepass_d256_ds_before_barrier": (
        _KV, "\n        mbar_wait(dsfull, i & 1);",
        "\n        if (wg == 1) mbar_wait(dsfull, i & 1);",
        "one-pass at D 256: consumer 0 reads the dS^T tile without waiting "
        "for consumer 1's barrier (a race: the last tile's dS, or a half "
        "written one)"),
    "onepass_d256_last_chunk": (
        _KV, "\n            for (int j = 0; j < PN / 8; ++j)",
        "\n            for (int j = 0; j < PN / 8 - 8 * wg; ++j)",
        "one-pass at D 256: the last 64-column chunk of the dq partial "
        "(consumer 1's store of columns 192-255) left unwritten"),
    "onepass_d256_dead_rows": (
        _KV,
        "      const size_t dead = (size_t)qstart * BQ * D / 4;  // in float4s",
        "      const size_t dead = (size_t)0 * BQ * D / 4;  // in float4s",
        "one-pass at D 256: the rows of a slot above the causal diagonal "
        "left unwritten"),
    "dq_stale_ring_stage": (
        "flash_bwd.cu",
        "      mbar_wait(&full[jv % SLOTS], (jv / SLOTS) & 1);",
        # the narrower plan's: the D 256 ring hands a slot over a tile's
        # time before its use, so there a stale parity reads landed data
        "      mbar_wait(&full[jv % SLOTS], ((jv / SLOTS) & 1) ^ (!L::WIDE && jv >= "
        "SLOTS));",
        "dq up to D 128: a ring stage read again before its next k tile "
        "lands (wrong parity)"),
    "dq_ragged_rows_written": (
        "flash_bwd.cu",
        (_DQ_MAP, _DQ_STORE, "dl[h] = row < S ? delta[at] : 0.f;",
         _DQ256_STORE),
        ("panel_map<D>(&mdq, dq, (uint64_t)s * bh, 1, 64)",
         _DQ_STORE.replace("q0 + 64 * wg, bh);", "bh * S + q0 + 64 * wg, 0);"),
         "dl[h] = row < S ? delta[at] : 1.f;",
         _DQ256_STORE.replace("row < S", "bh * S + row < (int)gridDim.x * S")),
        "dq (both plans): rows past S written (dq's map flattened, or the "
        "D 256 row stores bounded by the tensor's end, so the next head's "
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
        "          MmaSS<D / 2, 1, 1, T>",
        "        for (int kk = 0; kk < BK / 16 * (kt + 1 < nk); ++kk)\n"
        "          MmaSS<D / 2, 1, 1, T>",
        "one-pass: the last k tile's dq partial dropped (its registers unset)"),
    "onepass_ragged_rows_written": (
        ("flash_bwd_onepass.cu", _KV, _KV),
        ("static_cast<const float*>(dqp), s,\n"
         "                              (uint64_t)bh * nk, kv::BQ, D)",
         "q0,\n                         bh * nk + kt);",
         _KV_MASK),
        ("static_cast<const float*>(dqp),\n"
         "                              (uint64_t)s * bh * nk, 1, kv::BQ, D)",
         "(bh * nk + kt) * S + q0,\n                         0);",
         "return !(k < S && (!CAUSAL || k <= q));"),
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
    "simt_mask_off_by_one": (
        "flash_simt.cu",
        "  return row < S && col < S && (!causal || col <= row);",
        "  return row < S && col < S && (!causal || col < row + (2 * row < S));",
        "CUDA-core kernels (f32, f16): the causal mask drops the diagonal "
        "key in the second half of the rows"),
    "simt_last_k_tile": (
        "flash_simt.cu",
        "  for (int t = 0; t < tiles; ++t) {  // pass 2",
        "  for (int t = 0; t < tiles - (tiles > 1); ++t) {  // pass 2",
        "CUDA-core forward: the last live k tile left out of PV and the row "
        "sum"),
    "simt_p_not_cast": (
        "flash_simt.cu",
        "        Ps[(ty + 16 * i) * LP + tx + 16 * j] = rnd<T>(p);",
        "        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;",
        "CUDA-core forward: P not cast to V's dtype before PV (under f16)"),
    "f16_read_as_bf16": (
        "sm90.cuh",
        "  static constexpr CUtensorMapDataType map = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;\n"
        "  static constexpr bool f16 = true;",
        "  static constexpr CUtensorMapDataType map = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;\n"
        "  static constexpr bool f16 = false;",
        "f16 Hopper kernels: f16 read through a BFLOAT16 tensor map and "
        "multiplied as bf16 (a map's type sets only its element size and "
        "out-of-range fill, the same for both, so the products' type is "
        "what reads the bits)"),
    "fwd_f16_mask_off_by_one": (
        "flash_fwd.cu",
        "        if (!(col < S && (!CAUSAL || col <= row))) sc[4 * j + e] = NEG_INF;",
        "        if (!(col < S && (!CAUSAL || col < row + (2 * row < S || "
        "!Elem<T>::f16)))) sc[4 * j + e] = NEG_INF;",
        "f16 Hopper forward: causal mask drops the diagonal key in the "
        "second half (bf16 untouched)"),
    "simt_d256_last_tile": (
        "flash_simt.cu",
        "  for (int h = 0; h < parts && k0 + h * M < S; ++h)",
        "  for (int h = 0; h < parts - (D > 128) && k0 + h * M < S; ++h)",
        "CUDA-core one-pass at D 256: the last 32-row k tile of each "
        "64-row slot skipped (its dk, dv unwritten, its partial left out)"),
    "dq_f16_read_as_bf16": (
        "flash_bwd.cu",
        "  if (dtype == 1) HVD_BWD_WIDTHS(HVD_DQ, HVD_DQ_WIDE, __half)",
        "  if (dtype == 1) HVD_BWD_WIDTHS(HVD_DQ, HVD_DQ_WIDE, __nv_bfloat16)",
        "f16 Hopper dq: f16 inputs run through the bf16 instance (a bf16 "
        "tensor map, bf16 products, dS packed to bf16)"),
    "dkv_f16_read_as_bf16": (
        "flash_bwd.cu",
        "  if (dtype == 1) HVD_BWD_WIDTHS(HVD_DKV, HVD_DKV_WIDE, __half)",
        "  if (dtype == 1) HVD_BWD_WIDTHS(HVD_DKV, HVD_DKV_WIDE, "
        "__nv_bfloat16)",
        "f16 Hopper dk/dv: f16 inputs run through the bf16 instance (bf16 "
        "tensor maps, products, P and dS packed to bf16)"),
    "simt_wide_panel_skipped": (
        "flash_simt.cu", _SIMT_PANELS,
        tuple(t.replace("++p", "p += 1 + (np > 2 && p == 0)")
              for t in _SIMT_PANELS),
        "CUDA-core kernels past 256: the second 128-column panel left out of "
        "the scores (S, and dP in the backward) in every kernel"),
    "fwd_d256_last_chunk": (
        "flash_fwd.cu",
        "      for (int kk = 0; kk < D / 16; ++kk)",
        "      for (int kk = 0; kk < D / 16 - 4 * (D == 256); ++kk)",
        "Hopper forward at D 256: the last 64-column chunk of Q K^T left out "
        "of the scores"),
    "fwd_wide_panel_chunk_order": (
        "flash_fwd.cu",
        ("          const int s = n % SA, col = CW * c;",
         "row_stats(m, l, lc, lse, bh, q0 + rl, S, lane % 4 == 0 && z == 0);"),
        ("          const int s = n % SA, col = CW * ((c + z) % nc);",
         "row_stats(m, l, lc, lse, bh, q0 + rl, S, lane % 4 == 0);"),
        "Hopper forward past 256: a panel block other than panel 0 streams "
        "the score chunks from chunk z on (S summed in another order, so P "
        "off in its last bits) and writes lse too"),
    "f32_fwd_two_term_split": (
        "tf32.cuh", "  MmaTF32<N>::run(d, ahi, blo, 1);\n",
        "  (void)blo;\n",
        "f32 kernels on Hopper (the shared split, tf32.cuh): the hi lo term "
        "left out of every product (two TF32 terms, about 2^-11 off each "
        "product)"),
    "f32_fwd_vt_key_off_by_one": (
        "../ops/flash_attention.py",
        "    return vp.view(bh, s8 // 8, 4, 2, d)",
        "    return vp.roll(1, 1).view(bh, s8 // 8, 4, 2, d)",
        "f32 forward on Hopper: V^T's keys one off (V rolled by one key "
        "before the key order, so key j reads V's row j - 1)"),
    "f32_fwd_last_chunk_past_256": (
        "flash_fwd_f32.cu",
        "        for (int x = 0; x < BK / 2; ++x) sc[x] = c > 0 ? sc[x] + scc[x] "
        ": scc[x];",
        "        if (DW <= 256 || c + 1 < nc) for (int x = 0; x < BK / 2; ++x) "
        "sc[x] = c > 0 ? sc[x] + scc[x] : scc[x];",
        "f32 forward on Hopper past 256: the last 32-column chunk of Q K^T "
        "left out of the scores"),
    "f32_fwd_mask_off_by_one": (
        "flash_fwd_f32.cu",
        "        if (!(col < S && (!CAUSAL || col <= row))) sc[4 * j + e] = NEG_INF;",
        "        if (!(col < S && (!CAUSAL || col < row + (2 * row < S)))) "
        "sc[4 * j + e] = NEG_INF;",
        "f32 forward on Hopper: causal mask drops the diagonal key in the "
        "second half"),
    "f32_bwd_two_term_split": (
        "flash_bwd_f32.cu",
        "      split(x[4 * j + 3], h[jj][3], l[jj][3]);\n    }\n",
        "      split(x[4 * j + 3], h[jj][3], l[jj][3]);\n"
        "      l[jj][0] = l[jj][1] = l[jj][2] = l[jj][3] = 0u;\n    }\n",
        "f32 dq, dk/dv and one-pass on Hopper: the lo hi term left out of dS "
        "K, P^T dO and dS^T Q (two TF32 terms; the one-pass's partial keeps "
        "its three)"),
    "f32_bwd_t_rows_off_by_one": (
        "../ops/flash_attention.py",
        ("    kt = f32_vt(k)\n", "    qt, gt = f32_vt(q), f32_vt(g)\n",
         "    qt, gt, kt = f32_vt(q), f32_vt(g), f32_vt(k)\n"),
        ("    kt = f32_vt(k.roll(1, 1))\n",
         "    qt, gt = f32_vt(q.roll(1, 1)), f32_vt(g.roll(1, 1))\n",
         "    qt, gt, kt = (f32_vt(t.roll(1, 1)) for t in (q, g, k))\n"),
        "f32 dq, dk/dv and one-pass on Hopper: K^T's, Q^T's and dO^T's rows "
        "one off (rolled by one before the copy, so row j reads row j - 1)"),
    "f32_bwd_last_panel_past_256": (
        "flash_bwd_f32.cu",
        ("  dim3 grid(bh, (s + dq::BQ - 1) / dq::BQ, d / W);",
         "  dim3 grid(bh, (s + bk - 1) / bk, d / W);"),
        ("  dim3 grid(bh, (s + dq::BQ - 1) / dq::BQ, d / W - (d > 256));",
         "  dim3 grid(bh, (s + bk - 1) / bk, d / W - (d > 256));"),
        "f32 dq, dk/dv and one-pass on Hopper past 256: the last 128-column "
        "panel block not launched (its columns of dq, dk, dv and the "
        "partials left unwritten)"),
    "f32_bwd_mask_off_by_one": (
        "flash_bwd_f32.cu", "  return !(k < S && (!CAUSAL || k <= q));",
        "  return !(k < S && (!CAUSAL || k < q + (2 * q < S)));",
        "f32 dq, dk/dv and one-pass on Hopper: causal mask drops the "
        "diagonal key in the second half"),
    "f32_bwd_pt_before_barrier": (
        "flash_bwd_f32.cu",
        ("        float dpl[4][8] = {};  // dP^T = V dO^T on the CUDA cores",
         "x[4 * j + e] = xp[(4 * j + e) * 128 + t] * ("),
        ("        float dpl[4][8] = {};  // dP^T = V dO^T on the CUDA cores\n"
         "        float pt[BQ / 2];\n#pragma unroll\n"
         "        for (int y = 0; y < BQ / 2; ++y) pt[y] = xp[y * 128 + t];",
         "x[4 * j + e] = pt[4 * j + e] * ("),
        "f32 dk/dv and one-pass on Hopper: consumer 1 reads the P^T "
        "hand-over before its barrier (at the start of each q tile, before "
        "its dP^T: the last tile's P^T or dS, or whatever the tile held)"),
    "f32_onepass_second_block_stored_over": (
        "flash_bwd_f32.cu", "                if (b > 0) {",
        "                if (b < 0) {",
        "f32 one-pass on Hopper: a 128-row slot's second k block stores its "
        "partial over the first's instead of adding to it"),
    "f32_onepass_dead_rows": (
        "flash_bwd_f32.cu",
        "      if (CAUSAL)\n        for (int e = t + 128 * wg;",
        "      if (!CAUSAL)\n        for (int e = t + 128 * wg;",
        "f32 one-pass on Hopper: a causal slot's rows above its diagonal "
        "left unwritten (zeroed in a full one instead, where the partial "
        "then overwrites them)"),
    "f32_onepass_last_panel_past_256": (
        "flash_bwd_f32.cu", "            if (q0 + row < S) {",
        "            if (q0 + row < S && (DW <= 256 || z + 1 < gridDim.z)) {",
        "f32 one-pass on Hopper past 256: the last 128-column panel's "
        "partial columns left unwritten (dk and dv whole)"),
    "f32_onepass_ds_before_barrier": (
        "flash_bwd_f32.cu", "          mbar_wait(dsfull, i & 1);",
        "          if (wg) mbar_wait(dsfull, i & 1);",
        "f32 one-pass on Hopper: consumer 0 reads dS from the exchange tile "
        "without waiting for consumer 1 to write it (a race: P^T or a part "
        "of dS)"),
    "bwd_wide_panel_chunk_order": (
        ("flash_bwd.cu", _KV),
        ("          const int s = n % SA, col = CW * (c % nc);",
         "            const int s = n % SR, col = CW * c, "
         "par = ((n / SR) & 1) ^ 1;"),
        ("          const int s = n % SA, col = CW * ((c + z) % nc);",
         "            const int s = n % SR, col = CW * ((c + z) % nc), "
         "par = ((n / SR) & 1) ^ 1;"),
        "Hopper dq, dk/dv and one-pass past 256: a panel block other than "
        "panel 0 streams the score chunks from chunk z on (S and dP summed "
        "in another order, so P and dS off in their last bits)"),
    "bwd_wide_last_panel": (
        _KV,
        "  if (err == cudaSuccess && d % 256) err = launch128(d / 256, 1);",
        "  (void)launch128;",
        "Hopper dq, dk/dv and one-pass past 256: the last 128-column panel "
        "not launched (its columns of dq, dk, dv and the partials left "
        "unwritten)"),
    "dq_wide_dp_last_chunk": (
        "flash_bwd.cu",
        "          tma_load_3d(sc, c < nc ? mq : mg, &cfull[s], col, q0, bh);",
        "          tma_load_3d(sc, c < nc ? mq : mg, &cfull[s], "
        "col + (c == 2 * nc - 1) * DW, q0, bh);",
        "Hopper dq past 256: dP's last 64-column chunk dropped (dO's chunk "
        "read past the tensor's width: zeros)"),
    "dkv_wide_pt_before_barrier": (
        _KV,
        (_DKV_WIDE_ROWS,
         "                d[e] = xp[x * 128 + t] * (st[x] - rv[2 * j + e]);"),
        ("        float pt[BQ / 2];\n#pragma unroll\n"
         "        for (int x = 0; x < BQ / 2; ++x) pt[x] = wg ? xp[x * 128 + t] "
         ": 0.f;\n"
         + _DKV_WIDE_ROWS,
         "                d[e] = pt[x] * (st[x] - rv[2 * j + e]);"),
        "Hopper dk/dv and one-pass past 256 (one body): consumer 1 reads "
        "the P^T hand-over before its barrier (at the start of each q tile, "
        "before its dP^T: the last tile's P^T, or whatever the tile held)"),
    "onepass_wide_second_block_stored_over": (
        _KV, "            if (b > 0) {", "            if (b < 0) {",
        "Hopper one-pass past 256: a 128-row slot's second k block stores "
        "its partial over the first's instead of adding to it"),
    "onepass_wide_last_panel": (
        _KV, "              if (q0 + row < S) {",
        "              if (q0 + row < S && W == 256) {",
        "Hopper one-pass past 256: the last 128-column panel's partial "
        "columns left unwritten (dk and dv whole)"),
    "onepass_wide_ds_before_barrier": (
        _KV,
        ("            // dS^T (k rows, q columns) to shared memory: both "
         "consumers'",
         "          mbar_wait(dsfull, i & 1);"),
        ("            __nanosleep(10000);\n"
         "            // dS^T (k rows, q columns) to shared memory: both "
         "consumers'",
         "          if (wg) mbar_wait(dsfull, i & 1);"),
        "Hopper one-pass past 256: consumer 0 reads dS^T for its partial "
        "without waiting for consumer 1 to write it (a race, made to lose "
        "by 10 us of sleep in consumer 1 before its write: the last tile's "
        "dS^T, or whatever the tile held)"),
    "onepass_wide_dead_rows": (
        _KV, "      if (CAUSAL)\n        for (int e = t + 128 * wg;",
        "      if (!CAUSAL)\n        for (int e = t + 128 * wg;",
        "Hopper one-pass past 256: a causal slot's rows above its diagonal "
        "left unwritten (zeroed in a full one instead, where the partial "
        "then overwrites them)"),
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
# The CUDA-core kernels' units: chip_smoke's SIMT_SHAPES in each dtype.
WIDE = ("BH32 S2048 D256 causal", "BH2 S130 D256 causal",
        "BH4 S200 D256 full")
WIDER = ("BH32 S2048 D384 causal", "BH2 S130 D384 causal",
         "BH4 S200 D384 full", "BH2 S130 D640 causal", "BH4 S200 D640 full")
SIMT_CAUSAL = ("BH32 S2048 D128 causal", "BH4 S200 D32 causal",
               "BH2 S130 D64 causal") + WIDE[:2] + WIDER[:2] + WIDER[3:4]
SIMT_ALL = (RAGGED, DECODER, BERT, RAGGED32, RAGGED128,
            "BH2 S130 D64 causal") + WIDE + WIDER
# The Hopper forward's units from 256 on: chip_smoke's HOPPER_FWD_SHAPES
# and WIDE_BH_D256_SHAPE in bf16 and f16.
WIDE_BH_D256 = "BH65600 S64 D256 causal"
WIDE_BH_D384 = "BH65600 S64 D384 causal"
WIDE_DTYPES = ("bfloat16", "float16")


def simt_labels(shapes, dtypes=("float32", "float16", "bfloat16")):
    return {"%s %s" % (shape, dtype) for shape in shapes for dtype in dtypes}


def f16_labels(shapes):
    """The f16 Hopper kernels' units: FLASH_SHAPES in f16."""
    return {"%s float16 hopper" % shape for shape in shapes}


def f32_labels(shapes):
    """The f32 kernels on Hopper's units (the forward, dq and dk/dv):
    F32_FWD_SHAPES and WIDE_BH_SHAPE in f32."""
    return {"%s float32 hopper_f32" % shape for shape in shapes}


# Its shapes (chip_smoke's F32_FWD_SHAPES, the CUDA-core twins'), and BH
# 65,600.
F32_ALL = SIMT_ALL + ("BH65600 S64 D32 causal",)
F32_CAUSAL = SIMT_CAUSAL + ("BH65600 S64 D32 causal",)


def wide_labels(shapes, dtypes=WIDE_DTYPES):
    """The Hopper units from 256 on (the forward's, and at 256 dq's and
    dk/dv's too), in bf16 and f16."""
    return {"%s %s hopper" % (shape, dtype) for shape in shapes
            for dtype in dtypes}


# The Hopper dq and dk/dv at 256: the D 256 units, and the causal ones;
# past 256 (their panel kernels): the D 384 and 640 units.
D256 = WIDE + (WIDE_BH_D256,)
D256_CAUSAL = WIDE[:2] + (WIDE_BH_D256,)
PAST256 = WIDER + (WIDE_BH_D384,)
MUST_FAIL_AT = {"bn_stats_last_chunk": {"stem"},
                "bn_bwd_red_last_chunk": {"stem"},
                "fwd_diagonal_tile": CAUSAL,
                "fwd_mask_off_by_one": CAUSAL,
                "fwd_lse_log2": ALL,
                "fwd_v_transpose_bit": ALL,
                # the mask: at every causal D 256 unit too (S 64's rows
                # 32-63 hold the diagonal the plant drops)
                "dq_mask_off_by_one": CAUSAL | wide_labels(D256_CAUSAL),
                "dkv_mask_off_by_one": CAUSAL | wide_labels(D256_CAUSAL),
                # S 64 has one q tile, at q0 0: nothing to skip there
                "dq_diagonal_tile": CAUSAL | wide_labels(WIDE[:2]),
                "dq_k_transpose_bit": ALL | wide_labels(D256),
                "dq_stale_ring_stage": {DECODER, BERT},
                # at S 130 the block of head 0's last q tile (3 k tiles)
                # writes past S into head 1's first, whose block (2 k tiles)
                # ends first
                "dq_ragged_rows_written": {RAGGED32} | wide_labels(WIDE[1:2]),
                "dkv_last_q_tile": CAUSAL | wide_labels(D256_CAUSAL),
                # every D 256 unit sums four chunks, and every one has q
                # rows 48-63 in some tile
                "dq_d256_last_chunk": wide_labels(D256),
                "dkv_d256_dk_last_rows": wide_labels(D256),
                # S 64 has one slot: no neighbour, no dead rows
                "onepass_d256_neighbour_slot": wide_labels(WIDE),
                # a race: it shows where thousands of blocks run
                "onepass_d256_ds_before_barrier": wide_labels(WIDE[:1]),
                "onepass_d256_last_chunk": wide_labels(D256),
                "onepass_d256_dead_rows": wide_labels(WIDE[:2]),
                "onepass_dead_tiles_not_zeroed": CAUSAL,
                "onepass_dead_slot_last_tile": CAUSAL,
                "onepass_dkv_last_q_tile": ALL,
                "onepass_last_k_partial": ALL,
                "onepass_ragged_rows_written": RAGGED_S,
                "onepass_stale_ring_stage": ALL,
                "onepass_partial_store_unawaited": {DECODER, BERT},
                # every kernel keeps by the one mask
                "simt_mask_off_by_one": simt_labels(SIMT_CAUSAL),
                # every shape has more than one k tile on most q tiles
                "simt_last_k_tile": simt_labels(SIMT_ALL),
                # an identity cast under f32
                "simt_p_not_cast": simt_labels(SIMT_ALL,
                                               ("float16", "bfloat16")),
                # every D 256 shape has a slot of two 32-row tiles
                "simt_d256_last_tile": simt_labels(WIDE),
                # every shape past 256 has three panels or more
                "simt_wide_panel_skipped": simt_labels(WIDER),
                "f16_read_as_bf16": f16_labels(ALL),
                "dq_f16_read_as_bf16": f16_labels(ALL)
                | wide_labels(D256 + PAST256, ("float16",)),
                "dkv_f16_read_as_bf16": f16_labels(ALL)
                | wide_labels(D256 + PAST256, ("float16",)),
                "fwd_f16_mask_off_by_one": f16_labels(CAUSAL),
                # every D 256 shape sums four chunks
                "fwd_d256_last_chunk": wide_labels(WIDE + (WIDE_BH_D256,)),
                # a last bit of P off shows in o's bf16 or f16 columns where
                # thousands of rows hold thousands of keys: the decoder's
                # shape, not the ragged ones
                "fwd_wide_panel_chunk_order": wide_labels(WIDER[:1]),
                "f32_fwd_two_term_split": f32_labels(F32_ALL),
                "f32_fwd_vt_key_off_by_one": f32_labels(F32_ALL),
                # every shape past 256 sums 12 or 20 chunks
                "f32_fwd_last_chunk_past_256": f32_labels(WIDER),
                "f32_fwd_mask_off_by_one": f32_labels(F32_CAUSAL),
                "f32_bwd_two_term_split": f32_labels(F32_ALL),
                "f32_bwd_t_rows_off_by_one": f32_labels(F32_ALL),
                # every shape past 256 has three panels or more
                "f32_bwd_last_panel_past_256": f32_labels(WIDER),
                "f32_bwd_mask_off_by_one": f32_labels(F32_CAUSAL),
                # a stale or unwritten P^T at every timed shape
                "f32_bwd_pt_before_barrier": f32_labels(SIMT_ALL),
                # every shape whose first slot has two live k blocks (not
                # D 256's 64-row slots, nor S 64)
                "f32_onepass_second_block_stored_over": f32_labels(
                    ALL | {"BH2 S130 D64 causal"} | set(WIDER)),
                # the causal shapes with more than one slot whose partials
                # land in the poisoned block (S 2048, and S 130 at 640)
                "f32_onepass_dead_rows": f32_labels(
                    {DECODER, WIDE[0], WIDER[0], WIDER[3]}),
                "f32_onepass_last_panel_past_256": f32_labels(WIDER),
                # a race: it lost at BERT's shape and at S 2048 from D 256
                # on, not at the decoder's (consumer 0 reaches dS there
                # after waiting for the second half-tile's load)
                "f32_onepass_ds_before_barrier": f32_labels(
                    {BERT, WIDE[0], WIDER[0]}),
                # a last bit of P or dS off shows in dq's f32 columns, and
                # in dk's and dv's, where thousands of rows hold thousands
                # of keys: the decoder's shape
                "bwd_wide_panel_chunk_order": wide_labels(WIDER[:1]),
                # every unit past 256 ends in a 128-column panel
                "bwd_wide_last_panel": wide_labels(PAST256),
                # and sums six or ten dP chunks
                "dq_wide_dp_last_chunk": wide_labels(PAST256),
                # a stale P^T from the second q tile on
                "dkv_wide_pt_before_barrier": wide_labels(WIDER[:1]),
                # every unit past 256 but S 64 (one k block) has a slot
                # whose second k block adds to the first's partial
                "onepass_wide_second_block_stored_over": wide_labels(WIDER),
                "onepass_wide_last_panel": wide_labels(PAST256),
                "onepass_wide_ds_before_barrier": wide_labels(WIDER[:1]),
                # the causal units with a second slot (S 2048, S 130)
                "onepass_wide_dead_rows": wide_labels(
                    (WIDER[0], WIDER[1], WIDER[3]))}
# Faults that must fail nowhere but at these units: the D 256 code's own;
# the one-pass's at 256 also in no kernel but the one-pass.
ONLY_AT = {"dq_d256_last_chunk": wide_labels(D256),
           "dkv_d256_dk_last_rows": wide_labels(D256),
           "onepass_d256_neighbour_slot": wide_labels(D256),
           "onepass_d256_ds_before_barrier": wide_labels(D256),
           "onepass_d256_last_chunk": wide_labels(D256),
           "onepass_d256_dead_rows": wide_labels(D256),
           "f32_fwd_two_term_split": f32_labels(F32_ALL),
           "f32_fwd_vt_key_off_by_one": f32_labels(F32_ALL),
           "f32_fwd_last_chunk_past_256": f32_labels(WIDER),
           "f32_fwd_mask_off_by_one": f32_labels(F32_ALL)}
ONLY_AT.update({name: f32_labels(F32_ALL) for name in FAULTS
                if name.startswith(("f32_bwd", "f32_onepass"))})
# The Hopper dq's, dk/dv's and one-pass's plants past 256 fail nowhere but
# there (the dk/dv and one-pass kernels past 256 share a body).
_WIDE_KV = {"flash_bwd_dkv", "flash_bwd_onepass"}
PAST256_FAULTS = {"bwd_wide_panel_chunk_order": {"flash_bwd_dq"} | _WIDE_KV,
                  "bwd_wide_last_panel": {"flash_bwd_dq"} | _WIDE_KV,
                  "dq_wide_dp_last_chunk": {"flash_bwd_dq"},
                  "dkv_wide_pt_before_barrier": _WIDE_KV}
PAST256_FAULTS.update({name: {"flash_bwd_onepass"} for name in FAULTS
                       if name.startswith("onepass_wide")})
ONLY_AT.update({name: wide_labels(PAST256) for name in PAST256_FAULTS})
# The one-pass's plants at 256 and in f32 fail no kernel but the one-pass;
# the f32 backward's none but the f32 dq, dk/dv and one-pass (whose body
# is dk/dv's).
ONLY_KERNEL = {name: {"flash_bwd_onepass"} for name in ONLY_AT
               if name.startswith(("onepass_d256", "f32_onepass"))}
ONLY_KERNEL.update({name: {"flash_bwd_dq", "flash_bwd_dkv",
                           "flash_bwd_onepass"}
                    for name in ONLY_AT if name.startswith("f32_bwd")})
ONLY_KERNEL.update(PAST256_FAULTS)
# Faults whose failing outputs must all be these: the chunk-order plant
# passes every plain-version limit and fails the panel agreement alone.
ONLY_OUTPUT = {"bwd_wide_panel_chunk_order": {"panels"}}
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
SIMT_SOURCE = "flash_simt.cu"
# Sources of the kernels that also run in f16: a fault there is held at
# the f16 units too; one in the sources of the Hopper kernels from 256 on
# (the forward's, and dq's and dk/dv's at 256, whose P is the k-tile
# body's) also at those units.
F16_SOURCES = {"flash_fwd.cu", "flash_bwd.cu", _KV, "flash_bwd_onepass.cu",
               "sm90.cuh"}
WIDE_SOURCES = F16_SOURCES
# The f32 kernels on Hopper, their shared split and their transposed
# copies: a fault there runs the first units and the f32 kernels'.
F32_SOURCES = {"flash_fwd_f32.cu", "flash_bwd_f32.cu", "tf32.cuh",
               "../ops/flash_attention.py"}


def fault_sources(fault):
    """The sources a fault edits."""
    return set(fault[0]) if isinstance(fault[0], tuple) else {fault[0]}

CHILD = """
import json, sys, torch, chip_smoke as cs
from horovod_tpu_torch.ops import batch_norm as bn
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import scale_sum as ss
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
nf, nb = len(cs.FLASH_SHAPES), len(cs.BN_SHAPES)
ns, nd = len(cs.SIMT_SHAPES), len(cs.SIMT_DTYPES)
wide = cs.HOPPER_FWD_SHAPES + (cs.WIDE_BH_D256_SHAPE, cs.WIDE_BH_D384_SHAPE)
f32 = cs.F32_FWD_SHAPES + (cs.WIDE_BH_SHAPE,)
for unit in json.loads(sys.argv[1]):
    print("AT %d" % unit, flush=True)
    if unit >= nf + nb + 2 + ns * nd + nf + 2 * len(wide):
        bh, s, d, causal = f32[unit - (nf + nb + 2 + ns * nd + nf
                                       + 2 * len(wide))]
        errs, poisoned, _, _ = cs.kernel_errors(
            fa, *cs.kernel_inputs(bh, s, d, "float32"), causal, "hopper_f32")
        res = {"errs": errs, "poisoned": poisoned}
    elif unit >= nf + nb + 2 + ns * nd + nf:
        k = unit - (nf + nb + 2 + ns * nd + nf)
        bh, s, d, causal = wide[k % len(wide)]
        errs, poisoned, _, _ = cs.kernel_errors(
            fa, *cs.kernel_inputs(bh, s, d, ("bfloat16", "float16")[
                k // len(wide)]), causal)
        res = {"errs": errs, "poisoned": poisoned}
    elif unit >= nf + nb + 2 + ns * nd:
        bh, s, d, causal = cs.FLASH_SHAPES[unit - (nf + nb + 2 + ns * nd)]
        errs, poisoned, _, _ = cs.kernel_errors(
            fa, *cs.kernel_inputs(bh, s, d, "float16"), causal)
        res = {"errs": errs, "poisoned": poisoned}
    elif unit >= nf + nb + 2:
        k = unit - (nf + nb + 2)
        bh, s, d, causal = cs.SIMT_SHAPES[k % ns]
        errs, poisoned, _, _ = cs.kernel_errors(
            fa, *cs.kernel_inputs(bh, s, d, cs.SIMT_DTYPES[k // ns]), causal,
            "simt")
        res = {"errs": errs, "poisoned": poisoned}
    elif unit < nf:
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
    each attention shape, each BN shape, the model checks, the codec
    check, the CUDA-core units (each dtype at each of SIMT_SHAPES), the
    f16 Hopper units (FLASH_SHAPES in f16), the Hopper forward's units
    from 256 on (HOPPER_FWD_SHAPES and WIDE_BH_D256_SHAPE in bf16, then in
    f16), then the f32 forward on Hopper's (F32_FWD_SHAPES and
    WIDE_BH_SHAPE in f32)."""
    return ([cs.shape_label(*shape) for shape in cs.FLASH_SHAPES]
            + [shape[0] for shape in cs.BN_SHAPES] + [MODELS, CODECS]
            + ["%s %s" % (cs.shape_label(*shape), dtype)
               for dtype in cs.SIMT_DTYPES for shape in cs.SIMT_SHAPES]
            + ["%s float16 hopper" % cs.shape_label(*shape)
               for shape in cs.FLASH_SHAPES]
            + ["%s %s hopper" % (cs.shape_label(*shape), dtype)
               for dtype in WIDE_DTYPES
               for shape in cs.HOPPER_FWD_SHAPES + (cs.WIDE_BH_D256_SHAPE,
                                                    cs.WIDE_BH_D384_SHAPE)]
            + ["%s float32 hopper_f32" % cs.shape_label(*shape)
               for shape in cs.F32_FWD_SHAPES + (cs.WIDE_BH_SHAPE,)])


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


def check_family(readings, labels, failed_kernels=None, failed_outputs=None):
    """Print each kernel output's readings at ``labels``; -> (the labels
    where an output is past its limit, whether an output would also fail
    the max-scaled rule).  The kernels with an output past its limit, and
    those outputs, are added to ``failed_kernels`` and ``failed_outputs``
    when given."""
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
                    if failed_kernels is not None:
                        failed_kernels.add(kern)
                    if failed_outputs is not None:
                        failed_outputs.add(out)
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
    nf, nb = len(cs.FLASH_SHAPES), len(cs.BN_SHAPES)
    flash_labels, bn_labels = labels[:nf], labels[nf:nf + nb]
    ns = len(cs.SIMT_SHAPES) * len(cs.SIMT_DTYPES)
    simt_units = list(range(nf + nb + 2, nf + nb + 2 + ns))
    f16_units = list(range(nf + nb + 2 + ns, nf + nb + 2 + ns + nf))
    nw = 2 * (len(cs.HOPPER_FWD_SHAPES) + 2)
    wide_units = list(range(nf + nb + 2 + ns + nf, nf + nb + 2 + ns + nf + nw))
    f32_units = list(range(nf + nb + 2 + ns + nf + nw, len(labels)))
    simt_labels_ = [labels[u] for u in simt_units]
    f16_labels_ = [labels[u] for u in f16_units]
    wide_labels_ = [labels[u] for u in wide_units]
    f32_labels_ = [labels[u] for u in f32_units]
    old_units = list(range(nf + nb + 2))
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
        simt = fault is not None and fault[0] == SIMT_SOURCE
        f16 = fault is not None and bool(fault_sources(fault) & F16_SOURCES)
        wide = fault is not None and bool(fault_sources(fault) & WIDE_SOURCES)
        f32 = fault is not None and bool(fault_sources(fault) & F32_SOURCES)
        readings, died = run_case(
            name, fault, labels,
            None if fault is None else simt_units if simt else
            old_units + (f16_units if f16 else [])
            + (wide_units if wide else []) + (f32_units if f32 else []))
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
        simt_at, _ = check_family(readings, simt_labels_)
        failed_kernels, failed_outputs = set(), set()
        f16_at, _ = check_family(readings, f16_labels_)
        wide_at, _ = check_family(readings, wide_labels_, failed_kernels,
                                  failed_outputs)
        f32_at, _ = check_family(readings, f32_labels_, failed_kernels)
        flash_at |= cuda_deaths & set(flash_labels)
        f16_at |= cuda_deaths & set(f16_labels_)
        wide_at |= cuda_deaths & set(wide_labels_)
        f32_at |= cuda_deaths & set(f32_labels_)
        bn_at |= cuda_deaths & set(bn_labels)
        simt_at |= cuda_deaths & set(simt_labels_)
        if MODELS in readings:
            models = model_verdicts(cs, readings[MODELS])
        else:
            models = (MODELS in cuda_deaths,) * 5
        print("  verdict: flash check %s (max-scaled rule %s), BN check %s "
              "(max-scaled rule %s), decoder check %s, resnet check %s, bert "
              "check %s, scale_sum check %s, adasum check %s, CUDA-core "
              "flash check %s, f16 Hopper flash check %s, Hopper forward "
              "from 256 on check %s, f32 Hopper check %s"
              % tuple("fails" if f else "passes"
                      for f in (bool(flash_at), flash_max, bool(bn_at),
                                bn_max) + models + (bool(simt_at),
                                                    bool(f16_at),
                                                    bool(wide_at),
                                                    bool(f32_at))),
              flush=True)
        failed_at = flash_at | bn_at | simt_at | f16_at | wide_at | f32_at
        if failed_at:
            print("  failing at: %s" % ", ".join(sorted(failed_at)))
        if fault is None:
            edge = readings.get(CODECS, {}).get("edge")
            print("  CUDA-core units held: %d of %d; f16 Hopper units held: "
                  "%d of %d; Hopper forward units from 256 on held: %d of "
                  "%d; f32 Hopper units held: %d of %d"
                  % (len(set(simt_labels_) & set(readings)),
                     len(simt_labels_),
                     len(set(f16_labels_) & set(readings)),
                     len(f16_labels_),
                     len(set(wide_labels_) & set(readings)),
                     len(wide_labels_),
                     len(set(f32_labels_) & set(readings)),
                     len(f32_labels_)))
            print("  codec check: fp8 edge values off the reference's "
                  "bytes: %s" % edge)
            ok &= not (died or failed_at or any(models) or edge
                       or CODECS not in readings
                       or not set(simt_labels_) <= set(readings)
                       or not set(f16_labels_) <= set(readings)
                       or not set(wide_labels_) <= set(readings)
                       or not set(f32_labels_) <= set(readings))
        elif fault[0] == "scale_sum.cu":
            ok &= models[3] and models[4]
        else:
            family_at = (bn_at if fault[0] == "batch_norm.cu" else
                         simt_at if simt else f32_at if f32 else
                         flash_at | f16_at | wide_at)
            must = MUST_FAIL_AT.get(name, set())
            ok &= bool(family_at) and must <= family_at
            if must - family_at:
                print("  MISSED at: %s" % ", ".join(sorted(must - family_at)))
            if name in ONLY_AT:
                stray = failed_at - ONLY_AT[name]
                ok &= not stray
                if stray:
                    print("  FAILED OUTSIDE its units at: %s"
                          % ", ".join(sorted(stray)))
            if name in ONLY_KERNEL:
                others = failed_kernels - ONLY_KERNEL[name]
                ok &= not others
                print("  kernels failing at its units: %s%s" % (
                    ", ".join(sorted(failed_kernels)) or "none",
                    "; FAILED OUTSIDE its kernel" if others else ""))
            if name in ONLY_OUTPUT:
                others = failed_outputs - ONLY_OUTPUT[name]
                ok &= not others
                print("  outputs failing at its units: %s%s" % (
                    ", ".join(sorted(failed_outputs)) or "none",
                    "; FAILED OUTSIDE its outputs" if others else ""))
    shutil.rmtree(WORK, ignore_errors=True)
    print("fault check: %s" % ("ok" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
