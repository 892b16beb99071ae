#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the TF32 flags (both off), and builds the kernels
   from ``horovod_tpu_torch/csrc`` (timed, as set-up).
2. Holds every kernel against its plain PyTorch version, run on the card
   in f32 on the same inputs, and times kernel, plain version and the
   library yardstick on the device (``time_ms``) beside each kernel's
   bound: the four flash kernels (forward, dq, dk/dv, one-pass backward,
   whose dq partials are held slot by slot in a NaN-poisoned block) at
   a ragged full shape (BH 4, S 200, D 64), the decoder's attention
   (BH 32, S 2048, D 128, causal) and BERT-Large's (BH 512, S 384, D 64,
   full), against ``scaled_dot_product_attention``, with both whole
   backward variants timed, and untimed at BH 65,600 (past the 65,535
   blocks of a grid's y axis; S 64, D 32, causal); the four Hopper
   kernels again in f16 at the same shapes (f16 operands, f32
   accumulation; SDPA in f16 their yardstick); the Hopper forward in bf16
   and f16 at head dim 256 (the three shapes below, and untimed at BH
   65,600, S 64) and past it (the five shapes at 384 and 640 below, each
   also with V's later panels copies of its first, whose outputs must
   agree bit for bit); the Hopper dq, dk/dv and one-pass (64-row dq
   partial slots, held slot by slot) in bf16 and f16 at head dim 256 (the
   same three shapes, and untimed at BH 65,600); the four
   BatchNorm
   kernels at four NormAct
   shapes of ResNet-50 (the stem, stage 4's last, a projection, and a
   ragged M 997, C 101), against ``F.batch_norm(training=True)``; the
   four flash kernels' CUDA-core twins (``csrc/flash_simt.cu``) in f32,
   f16 and bf16 at the same attention shapes, a ragged causal one (BH 2,
   S 130, D 64), three at head dim 256 (the decoder's, BH 32 S 2048
   causal; BH 2 S 130 causal; BH 4 S 200 full), the same three at 384
   and the two ragged ones at 640 (128-column panels), and untimed at
   BH 65,600,
   against SDPA in the same dtype (f16 and bf16 outputs also by the share
   of elements off the plain version's); the f32 forward on Hopper
   (``csrc/flash_fwd_f32.cu``, split TF32) and the f32 dq, dk/dv and
   one-pass on Hopper (``csrc/flash_bwd_f32.cu``, split TF32 with dP on
   the CUDA cores; the one-pass's partials in a NaN-poisoned block and
   bit for bit over two launches) at the same shapes as those twins and
   untimed at BH 65,600, under their f32 limits, past 256 also each
   against itself panel against panel, bit for bit (o's on a V whose
   panels repeat; dq's, dk's, dv's and the partials' on a Q, K, V and dO
   whose 128-column panels repeat), against SDPA in f32 (its backward
   beside each backward kernel); the
   scale-sum kernel bit for bit at five lengths up to BERT-Large's
   word-embedding gradient, three coefficient pairs and three dtypes,
   aligned and offset by one element, with an inf and a NaN and with
   coefficients read on the device, timed beside the two-call ATen form
   (no one PyTorch call computes it).
3. Holds three small models on the card against the same weights in f32
   on the CPU (plain versions): the decoder (bf16; at head_dim 128, at
   96, which ``flash_attention`` zero-pads to the Hopper kernels' 128,
   at 192, which it zero-pads to 256 (the Hopper forward, dq and dk/dv),
   and at 320, padded to 384: the Hopper forward and the CUDA-core
   backward),
   ResNet-50 (image 64, batch 4; f32 for the gradients, bf16 for the
   loss) and BERT (bf16, under both backward choices).  Then the small
   decoder at dtype float32 (the Hopper f32 forward, dq, dk/dv and
   one-pass) with 2 heads of 128, of 192 (padded to 256) and of 320
   (padded to 384), trained 3 Adam steps (one step past 128) through
   ``make_train_step`` on a one-rank world under each backward choice,
   against the same steps in f32 on the CPU.
4. The main paths, each run with every launch count set to 0 just
   before it and read just after, from numpy seeds at full width and
   depth.  Through ``hvd.init()`` (a one-rank NCCL world),
   ``broadcast_parameters`` and ``DistributedOptimizer``, whose gradient
   hooks enqueue named allreduces into the negotiating engine (each
   path prints the engine's cycles, executed groups and fused bytes a
   step, and fails unless every gradient byte was submitted to it).
   The engine's fast path is on, its default: the decoder, ResNet-50
   and BERT-Large each take ``WARMUP_STEPS`` steps, by which their
   schedule must have frozen, then their 5 timed steps, which must all
   run frozen, with no negotiated cycle and no thaw (each prints its
   frozen rounds, buckets a step and ``fastpath.describe()``):
   the d1024 L12 decoder of ``bench.py`` (batch 4, seq 2048,
   Adam, ``HVD_TPU_FLASH_BWD=pallas``; flash forward, dq and dk/dv 12
   launches a step each), ResNet-50 of ``bench.py:274-321`` (batch 128,
   224^2, SGD 0.1 with momentum 0.9; each BN kernel 53 launches a step),
   then BERT-Large fine-tuning (batch 32, seq 384, AdamW with 8 groups
   and the fp16 wire, ``HVD_TPU_FLASH_BWD=pallas_onepass``; flash
   forward and one-pass backward 24 launches a step each, every
   allreduce fp16).  Then the main paths of the f16 Hopper kernels: the
   decoder flagship at dtype float16 (f32 parameters, a GradScaler), one
   step through ``make_train_step`` under ``pallas`` (12 launches each of
   the f16 Hopper forward, dq and dk/dv, none on the CUDA cores); the
   same BERT-Large step at dtype float16, one step through
   ``make_bert_train_step`` under each backward choice from the same
   weights (24 launches each of the f16 Hopper forward and one-pass, then
   of the forward, dq and dk/dv); the decoder flagship with 4 heads of
   256 (Gemma 7B's head width) in bf16, one step under each backward
   choice from the same weights (12 Hopper forwards, then 12 Hopper dq
   and dk/dv or 12 Hopper one-pass backwards at D 256, no CUDA-core
   kernel); each step's loss and gradients against the same model's on
   the plain attention path on the card, then 5 more steps timed (under
   each choice for BERT and the hd256 decoder).  Between the decoder and
   ResNet-50, the main path
   of the f32 kernels: the decoder at the same width and depth at dtype
   float32, one step through ``make_train_step`` under each backward
   choice from the same weights (the Hopper f32 forward 2 x 12 launches,
   the Hopper f32 dq, dk/dv and one-pass 12 each, no CUDA-core kernel), each step's loss and gradients
   against the same model's on the plain attention path on the card.
   Then BERT-Large Adasum fine-tuning, the in-process
   form of Adasum allreduce: the gradients of four 8-row shards of the
   same batch 32, one after another, stacked and reduced by
   ``adasum_reduce_stacked`` (the scale-sum kernel 3 times per gradient
   tensor a step), the results then one grouped Adasum allreduce through
   the engine over the world's one rank, all with no host
   synchronisation, then AdamW; step 0's reduced gradients bit for bit
   against the plain reduction; its rounds stay negotiated (Adasum
   cannot freeze).  No path launches another family's
   kernels.  Each profiles one more step by kernel family; the BN and
   BERT flash kernels' device time in that step is printed beside the
   step's bound for them, and the Adasum step's reduction is split into
   the scale-sum kernel and the rest.  Then each collective of the
   surface once on the one-rank NCCL world, the flat Average's
   arithmetic at 3, 5, 6 and 7 ranks on the card against the CPU, bit for
   bit (f32, f16, bf16, int32), and the engine on the card:
   64 named CUDA tensors (f32, bf16, f16, i32; every reduce op, pre- and
   post-scaled) under a 1 MiB fusion threshold, each result bit for bit,
   in more than one fused group, none above the threshold; one decoder
   step (d1024, 2 layers) whose backward and reduction run under
   ``torch.cuda.set_sync_debug_mode("error")``, its gradients bit for
   bit against the same backward's local ones; ``hvd.join()``; and the
   ``HOROVOD_TIMELINE`` trace, which must parse and name every gradient.
   Then the fast path on the card (``HOROVOD_FAST_PATH_WARM_CYCLES=3``):
   a d1024 L2 decoder step run frozen and with ``HOROVOD_FAST_PATH=0``
   on the same weights and inputs, backward and reduction under
   ``set_sync_debug_mode("error")``, every reduced gradient bit for bit
   between the two and against the local one; the 64 named tensors
   frozen, then one of them changing its shape (a thaw, reason shape)
   and the schedule frozen again before ``join()`` (a thaw, reason
   membership), every result bit for bit.
   Then the cross-node wire codecs and the hierarchical legs
   (``ops/multihost.py``), which one card can run only on one-member
   groups: the codec phase takes the decoder's 10 frozen gradient
   buckets of one step (171,992,064 f32 gradients, recorded from a
   frozen flagship step) through every codec and ``ErrorFeedback`` over
   3 steps under ``set_sync_debug_mode("error")``, bit for bit against
   the same functions on the CPU copies, holds the plain fp8 cast's
   bytes at e4m3's overflow edge to the reference's (NaN past +-464,
   where torch's cast saturates) and times each codec against its byte
   bound; the leg phase calls each of the five legs directly with
   one-member NCCL local and cross groups under every codec (none, fp16,
   bf16, int8, fp8) on those buckets, with no host synchronisation,
   bit for bit against one-member gloo groups on the CPU, each timed
   with CUDA events; the gate phase reruns the fast-path phase's decoder
   steps under ``HOROVOD_CROSS_HOST_COMPRESSION=int8``: one local rank,
   so every collective flat, none compressed, one warning, and the
   reduced gradients bit for bit against the same step without it.
   The guard phase runs the decoder's buckets through ``mh.allreduce``
   with the global set's hierarchy on one-member NCCL groups under int8:
   one dropped leg attempt bit for bit the unarmed call (outputs and
   residuals), an unbounded drop the flat result, demotion after the
   threshold through ``check_degraded_routes()`` and the re-probe.  Last,
   the deadline phase: a one-rank engine under
   ``HOROVOD_COLLECTIVE_TIMEOUT_SECS=1`` with ``mh.deadline.wedge:drop``
   must raise ``CollectiveDeadlineExceeded`` within 5 s, reject the next
   enqueue and shut down.
5. Prints one JSON line of kernel records (thirty-one: the thirteen
   kernels, the f16 forms of the four Hopper ones, the Hopper forward at
   D 256 and at D 384, the Hopper dq, dk/dv and one-pass at D 256, and the
   f32 forward, dq and dk/dv on Hopper at D 128, 256 and 384),
   then as the last line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line.  Needs a CUDA device
and the rest of the repository beside this file.
"""

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12    # H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 tensor cores
# TF32 products per f32 product in the split-TF32 f32 kernels
# (csrc/tf32.cuh: a_lo b_hi + a_hi b_lo + a_hi b_hi)
SPLIT_TF32_TERMS = 3
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# Each kernel output against its plain version, element by element:
#   |got - plain| <= rtol * |plain| + atol * scale(plain's row)
# (rtol, atol) per output; a row is one (bh, position) vector of D, or
# one bh row of lse, and its scale is its RMS (see ``compare``).  P and
# ds are rounded to bf16 before a product at another running max in the
# kernel than in the plain version, which moves a sum by a fraction of
# its row's scale rather than of its own value, hence the row term; rtol
# is one bf16 ulp.  lse is f32 throughout.  The Hopper kernels' backward
# outputs are held to the plain version with dP - delta formed in f64
# (``exact_dp``): where it cancels to nothing (q row 0 of a causal head,
# one live key) an f32 plain version keeps only its own rounding noise,
# in another summation order than the tensor cores'.  The limits sit above the
# readings of the correct kernels and far below planted faults
# (tools/chip_fault_check.py, PERF.md).
# The one-pass kernel's dq partials ("dqp") are held slot by slot, a row
# being one (bh, k block, position) vector, under dq's limits (a slot per
# ``fa.onepass_block_k(D)`` rows of k: 128, and 64 at D 256).
KERNEL_TOL = {"o": (2 ** -7, 2 ** -5), "lse": (2 ** -16, 2 ** -16),
              "dq": (2 ** -7, 2 ** -5), "dqp": (2 ** -7, 2 ** -5),
              "dk": (2 ** -7, 2 ** -5), "dv": (2 ** -7, 2 ** -5)}
# (BH, S, D, causal) of phase 2: a ragged full shape, the decoder's
# attention (batch 4 x 8 heads, seq 2048), BERT-Large's (batch 32 x 16
# heads, seq 384), a ragged causal D 32 shape (the kernels' 64-byte
# swizzle) and a ragged full D 128 shape (two 128-byte panels, a last
# tile of 2 rows).
DECODER_SHAPE, BERT_SHAPE = (32, 2048, 128, True), (512, 384, 64, False)
FLASH_SHAPES = ((4, 200, 64, False), DECODER_SHAPE, BERT_SHAPE,
                (4, 200, 32, True), (2, 130, 128, False))
# More (batch x head) rows than a grid's y axis holds (65,535): every
# flash kernel puts bh on x.  Held, not timed (about 270 MB a tensor).
WIDE_BH_SHAPE = (65600, 64, 32, True)
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_bwd_onepass")
# The four Hopper kernels in f16 at FLASH_SHAPES and WIDE_BH_SHAPE: they
# cast P at the running max, as the bf16 kernels and the TPU kernels do,
# where the plain version casts it at the final max, so they are held to
# the bf16 rule scaled by f16's 8x finer unit; lse stays f32.  dS
# underflows in f16 sooner than in bf16, and the plain version casts it
# at the same values, so dq, dk and dv are held to the plain version in
# f16, not to f32.
F16_HOPPER_TOL = dict({out: (2 ** -10, 2 ** -8) for out in KERNEL_TOL},
                      lse=(2 ** -16, 2 ** -16))
F16_HOPPER = FLASH_KERNELS
# The CUDA-core flash kernels (csrc/flash_simt.cu) in f32, f16 and bf16
# against their plain versions on the same inputs, by compare's rule, every
# output under one (rtol, atol) per dtype: f32 (2^-16, 2^-16), f16 one f16
# unit (2^-10), bf16 one bf16 unit (2^-7).  Both cast P and dS at the same
# values (the forward takes the row max first), so they differ by the
# order of f32 sums alone.  Held at FLASH_SHAPES, a ragged causal D 64
# shape, WIDE_HEAD_SHAPES and WIDER_HEAD_SHAPES, and untimed at
# WIDE_BH_SHAPE.
# f16 and bf16 outputs (o, dk, dv) are also held to the share of their
# elements that differ at all from the plain version's, F16_OFF_SHARE at
# most: a sum whose f32 value moved by its summation order rounds to
# another f16 value about once in thousands of elements, while a cast
# left out moves it by about half an f16 ulp and so flips a large share of
# them, below what one ulp of tolerance on each element can see.
SIMT_DTYPES = ("float32", "float16", "bfloat16")
SIMT_TOL = {"float32": (2 ** -16, 2 ** -16), "float16": (2 ** -10, 2 ** -10),
            "bfloat16": (2 ** -7, 2 ** -7)}
F16_OFF_SHARE = 2 ** -6
# Head dim 256 (Gemma 7B's attention, and any head dim in 129-255 padded
# to it): the decoder's attention at that width, a ragged causal and a
# ragged full shape (64-row one-pass slots, the last partly past S: 2 rows
# of S 130's third, 8 of S 200's fourth; two 32-row tiles each on the CUDA
# cores).  All four run on Hopper in bf16 and f16 (64-row k tiles; dk/dv
# and the one-pass 64-row k blocks); in f32 the forward on Hopper (split
# TF32, two 128-column panels) and the backward on the CUDA cores.
WIDE_HEAD_SHAPES = ((32, 2048, 256, True), (2, 130, 256, True),
                    (4, 200, 256, False))
# Past 256 (any head dim, padded to a multiple of 128) the CUDA-core
# kernels split the width into 128-column panels, one block each: three
# panels at 384 (the decoder's attention at that width, timed; a ragged
# causal and a ragged full shape), five at 640 (the two ragged ones).
# Each ragged shape ends in a partial tile (S 130: 2 rows past two 64-row
# tiles and one 128-row slot; S 200: 8 rows).  The Hopper forward splits
# o into panels of 256 columns and a last one of 128 (384 = 256 + 128,
# 640 = 256 + 256 + 128), one block each, every block summing the scores
# over every 64-column chunk in one order.
WIDER_HEAD_SHAPES = ((32, 2048, 384, True), (2, 130, 384, True),
                     (4, 200, 384, False), (2, 130, 640, True),
                     (4, 200, 640, False))
SIMT_SHAPES = (FLASH_SHAPES + ((2, 130, 64, True),) + WIDE_HEAD_SHAPES
               + WIDER_HEAD_SHAPES)
# The f32 kernels on Hopper (``F32_KERNELS``: the forward, dq, dk/dv and
# one-pass, split TF32) against the f32 plain version at the CUDA-core
# twins' shapes under their f32 limits (SIMT_TOL["float32"]: each product
# within about 2^-19 of its f32 value, the rest the order of f32 sums; the
# backward kernels form dP on the CUDA cores in the plain version's order,
# so they are held to it, not to ``exact_dp``), untimed at WIDE_BH_SHAPE,
# and past 256 also held to themselves panel against panel
# (``panel_agreement``); the one-pass's partials also against a second
# launch's, bit for bit (a slot is one block's, summed in one order).
F32_FWD_SHAPES = SIMT_SHAPES
# The f32 dq, dk/dv and one-pass split their outputs into panels of this
# many columns past 256 (the forward's panel agreement keeps the Hopper
# forward's 256, which its 128-column panels also meet).
F32_BWD_PANEL = 128
# The Hopper forward from 256 on, held in bf16 and f16 under the Hopper
# family's limits (KERNEL_TOL, F16_HOPPER_TOL: it casts P at the running
# max), and untimed at WIDE_BH_SHAPE's BH and S at D 256; at D 256 (the
# first three shapes and WIDE_BH_D256_SHAPE) the Hopper dq, dk/dv and
# one-pass too, under the same limits and timed beside SDPA's backward.  Past 256 it is
# also held to itself: with V's later panels copies of its first
# (``panel_agreement``), every panel block must give o's columns bit for
# bit as panel 0's block does, which it can only when all of them formed
# the same P.
HOPPER_FWD_SHAPES = WIDE_HEAD_SHAPES + WIDER_HEAD_SHAPES
WIDE_BH_D256_SHAPE = (65600, 64, 256, True)
# The small decoder on the card (bf16, kernels) against f32 on the CPU:
# loss relative error, and each parameter gradient's relative norm error
# ||g_card - g_cpu|| / ||g_cpu||; readings 1.7e-4 and 2.5e-2 at worst.
# Held at head_dim 128 and at 96, which the Hopper kernels take
# zero-padded to 128, at 192, zero-padded to 256 (the Hopper forward, dq
# and dk/dv), and at 320, zero-padded to 384 (the Hopper forward, whose
# panels there are 256 and 128 columns, and the CUDA-core backward,
# 128-column panels).
LOSS_TOL, LEAF_TOL = 5e-4, 5e-2
MODEL_HEAD_DIMS = (128, 96, 192, 320)
# The small decoder at dtype float32 (the Hopper f32 forward, dq, dk/dv and
# one-pass) trained on the card through make_train_step (Adam, a
# one-rank world) against the same steps in f32 on the CPU (plain
# versions, torch.optim.Adam): each step's loss and the last step's
# gradients, relative, under each backward choice.  f32 on both sides:
# summation order and the split-TF32 products' 2^-19.  At 2 heads of 128
# F32_STEPS steps; at 2 heads of 192 (padded to 256) and of 320 (padded to
# 384: three O panels) one step, whose loss and gradients are the
# kernels' alone: Adam's first step moves each weight by lr times the
# sign of its gradient, so an element whose gradient is near zero moves
# the other way under any rounding difference, and by the third step
# those flips, not the kernels, set the worst leaf (at 320 it read
# 1.43e-4 and 1.45e-4 on the card, with every f32 forward reading at most
# 0.55 of its limits in phase 2).
F32_STEPS = 3
F32_HEAD_DIMS = (128, 192, 320)
F32_LOSS_TOL, F32_LEAF_TOL = 1e-5, 1e-4
# The decoder flagship's width and depth at dtype float32: one step under
# each backward choice from the same weights, through make_train_step,
# each held against the same model's loss and gradients on the plain
# attention path (HOROVOD_FLASH_ATTENTION=0) on the card.  Only attention
# differs and both are f32, so summation order only: the small decoder's
# tolerances.
F32_FLAGSHIP = dict(d=1024, layers=12, seq=2048, batch=4)
# BERT-Large's step at dtype float16 under each backward choice (the f16
# Hopper kernels' main path at D 64), and the decoder flagship's under
# pallas (the f16 dq and dk/dv's at D 128), each against the same step's
# plain attention path on the card, from the same weights: the small
# BERT's limits (loss, gradient leaves; f16 against f32 attention).
F16_BERT = dict(batch=32, seq=384)
# At random weights BERT-Large's late layers are nearly rank-one (their
# tokens nearly one vector), so dP - delta cancels in their attention
# backward and their q/k gradients fall far below the first layers' (the
# plain path read 4.6e-7 at layer 23 against 0.218 at layer 0 for wq):
# below the rounding of flash attention in f16, which forms delta from
# the rounded o and rounds P and dS, where the plain softmax backward
# does neither.  So each leaf's error is taken over the larger of its
# own plain norm and F16_BERT_LEAF_FLOOR times the largest plain norm of
# its kind (the same leaf in any layer), as the kernel check floors a
# row's scale at a share of the tensor's.
F16_BERT_LEAF_FLOOR = 2 ** -3
STEPS = 5
# Untimed steps before a flagship's timed ones: its rounds (a step each,
# after the broadcast rounds of its set-up) warm the fast path for
# HOROVOD_FAST_PATH_WARM_CYCLES (10), the report of the tenth reaches
# rank 0 during the eleventh, and the verdict names the round after it.
WARMUP_STEPS = 12

# The BatchNorm kernels against their plain versions (f32 arithmetic, the
# kernels' casts) on the same bf16 inputs, element by element:
#   |got - plain| <= rtol * |plain| + atol * scale
# Elementwise outputs (y, dx, dres): scale is the RMS of the plain
# output's channel (floored at 1/16 of the tensor's RMS).  The kernels
# repeat the plain versions' rounded f32 operations in their order, so
# these should agree bit for bit; rtol allows one bf16 ulp.  Sums (mean,
# var, dgamma, dbeta) are added in another order than the plain
# versions'.  The rounding error of an f32 sum of terms of random sign
# grows like the root of the sum of the terms' squares, so there scale is
# sqrt(sum of squares) (over M for mean and var) and atol 2^-12 sits about
# two orders above that rounding; rtol holds sums whose terms share a
# sign (mean, var).  A row chunk dropped from a sum of K chunks moves it
# by about scale / sqrt(K): at the stem's 1024 chunks, 2^-5 of the scale,
# 128 times the limit.
BN_TOL = {"y": (2 ** -7, 2 ** -8), "dx": (2 ** -7, 2 ** -8),
          "dres": (2 ** -7, 2 ** -8), "mean": (2 ** -16, 2 ** -12),
          "var": (2 ** -16, 2 ** -12), "dgamma": (2 ** -16, 2 ** -12),
          "dbeta": (2 ** -16, 2 ** -12)}
# (name, M, C, relu, residual) of NormActs of ResNet-50 at batch 128,
# 224^2, and a ragged shape the TPU plan rejects, whose odd C runs the
# kernels' one-element (VEC 1) loads.
BN_SHAPES = (("stem", 1605632, 64, True, False),
             ("stage-4 last", 6272, 2048, True, True),
             ("projection", 100352, 512, False, False),
             ("ragged", 997, 101, True, True))
BN_EPS = 1e-5
BN_KERNELS = ("bn_stats", "bn_apply", "bn_bwd_red", "bn_bwd_dx")
# The small ResNet-50 on the card (kernels) against f32 on the CPU (plain
# versions), image 64 and batch 4 (16 values a channel at the last
# stage): in f32 (TF32 off), the loss's relative error and each
# parameter's relative gradient norm error; in bf16, the loss's relative
# error.  (bf16 against f32 gradients differ by a median 66% per leaf on
# the CPU alone, plain versions on both sides, so they hold nothing.)
# Readings 3.1e-7, 5.1e-3 and 0.032; limits about 30x, 4x and 3x those.
RN_IMAGE, RN_BATCH = 64, 4
RN_LOSS_TOL, RN_LEAF_TOL, RN_BF16_LOSS_TOL = 1e-5, 2e-2, 0.1
# The small BERT in bf16 on the card against f32 on the CPU, per backward
# choice: the loss's relative error and each gradient leaf's relative
# norm error (bk: its norm over bq's).  Set before the first card run
# from the same comparison run on the CPU (plain versions in bf16 against
# f32), whose readings were 2.7e-4 and 1.7e-2 (layers.1.wq; bk 1.5e-2)
# under either choice: about 4x and 3x, as the decoder's limits sit.
BERT_LOSS_TOL, BERT_LEAF_TOL = 1e-3, 5e-2
# The scale-sum kernel against its plain version: bit for bit (a NaN
# matches a NaN), at these lengths (one element, a tail shorter than one
# 16-byte vector, a tail past 4096 vectors, past 2^19 elements, and
# BERT-Large's word-embedding gradient, 30522 x 1024), coefficient pairs
# (Adasum-like: about 1 and 0.5) and dtypes; aligned and offset by one
# element (the scalar path).
SS_LENGTHS = (1, 7, 4097, 524289, 31254528)
SS_COEFS = ((0.5, 2.0), (1 - 2 ** -20, 0.5 + 2 ** -20), (1.0, 0.0))
SS_DTYPES = ("float32", "bfloat16", "float16")
# BERT-Large (google-research/bert BERT-Large, Uncased), the Adasum path's
# ranks (four shards of the global batch 32 on the one card).
BERT_LARGE = dict(vocab_size=30522, d_model=1024, n_layers=24, n_heads=16,
                  d_ff=4096, max_seq=512, type_vocab=2, n_classes=2,
                  norm_eps=1e-12)
ADASUM_RANKS = 4


def say(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps=10, warmup=3):
    """Device time of one call of ``fn()``: ``reps`` calls back to back
    between one CUDA event pair, over ``reps``.  A sleep kernel ahead of
    the pair holds the device while the host queues the calls, so the
    pair reads the device's work, not the host's time to launch it (which
    exceeds a small kernel's); the sleep starts near the host time of the
    fastest warm-up call (at about 2e6 cycles a ms) and doubles until the
    host's queueing ends inside it.  A call that waits on the device
    never does: the error then gives the caching allocator's retries in
    the attempts (under memory pressure it frees cached blocks, and
    cudaFree waits for the device)."""
    import torch
    fastest = math.inf
    for _ in range(warmup):
        t = time.perf_counter()
        fn()
        fastest = min(fastest, time.perf_counter() - t)
    torch.cuda.synchronize()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    cycles = 1 << 21
    while cycles < min(fastest * 1e3 * reps * 2e6, 1 << 30):
        cycles *= 2
    while cycles < 1 << 34:
        torch.cuda.synchronize()
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t = time.perf_counter()
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        host_ms = (time.perf_counter() - t) * 1e3
        b.synchronize()
        if host_ms < s.elapsed_time(a):
            return a.elapsed_time(b) / reps
        cycles *= 2
    raise RuntimeError(
        "time_ms: the host did not queue %d calls within a sleep of 2^34 "
        "cycles (%d allocator retries meanwhile)" % (
            reps, torch.cuda.memory_stats().get("num_alloc_retries", 0)
            - retries))


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_inputs(bh, s, d, dtype="bfloat16"):
    """q (pre-scaled), k, v and the output gradient in ``dtype``, from a
    seed."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(bh * 100003 + s)

    def rnd(scale=1.0):
        return (torch.randn(bh, s, d, generator=g, device="cuda")
                * scale).to(getattr(torch, dtype))

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


def flash_kernels(fa, dtype, family="hopper", width=128):
    """FLASH_KERNELS' wrappers of ``family`` ("hopper", "simt", the
    CUDA-core twins, or "hopper_f32", the f32 forward, dq and dk/dv on
    Hopper) that take inputs of ``dtype`` at head dim ``width``: the four
    Hopper ones in bf16 and f16 up to 256 and the forward alone past it,
    the four CUDA-core ones in any dtype, the three f32 ones in f32 at
    every padded width."""
    import torch
    kernels = {"hopper": fa.HOPPER_KERNELS, "simt": fa.SIMT_KERNELS,
               "hopper_f32": fa.F32_KERNELS}[family]
    return {name: k for name, k in zip(FLASH_KERNELS, kernels)
            if getattr(torch, dtype) in k.dtypes and width in k.widths}


def flash_tol(dtype, family="hopper"):
    """(rtol, atol) per output for ``family``'s kernels on inputs of
    ``dtype``."""
    if family in ("simt", "hopper_f32"):
        return dict.fromkeys(KERNEL_TOL, SIMT_TOL[dtype])
    return KERNEL_TOL if dtype == "bfloat16" else F16_HOPPER_TOL


def dtype_name(t) -> str:
    return str(t.dtype).split(".")[-1]


def panel_agreement(fa, kern, q, k, v, do, causal, period=256):
    """A Hopper kernel past 256 (``kern``) against itself, its inputs'
    columns from ``period`` on replaced by copies of their first ones
    (column j of panel z is column j of panel 0): the forward's v, so
    every O panel block must give o's columns bit for bit as panel 0's
    block does, which it does only when all of them formed the same S, m, l
    and P; a backward kernel's q, k, v and do (lse and delta the plain
    forward's on them), so every panel block of dq, dk, dv and the
    one-pass's partials must give its columns as panel 0's does, which it
    does only when all of them formed the same P and dS.  -> compare's
    keys over every output,
    ``worst`` 0 when every element agrees and 1 + the count of those that
    do not."""
    import torch
    width, n = v.shape[-1], -(-v.shape[-1] // period)

    def repeat(t):
        return torch.cat([t[..., :period]] * n, -1)[..., :width].contiguous()

    if kern.__name__.startswith("flash_fwd"):
        outs = kern(q, k, repeat(v), causal)[:1]
    else:
        q, k, v, do = (repeat(t) for t in (q, k, v, do))
        o, lse = fa.flash_fwd_reference(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        outs = kern(q, k, v, do, lse, delta, causal)
        outs = outs if isinstance(outs, tuple) else (outs,)
    return bits_agreement(outs, [repeat(out) for out in outs])


def bits_agreement(outs, bases):
    """Each of ``outs`` against its twin in ``bases``, element for element
    -> compare's keys, ``worst`` 0 when every element agrees and 1 + the
    count of those that do not."""
    off, err, plain = 0, 0.0, 0.0
    for out, base in zip(outs, bases):
        off += (out != base).sum().item()
        err = max(err, (out.float() - base.float()).abs().max().item())
        plain = max(plain, base.float().abs().max().item())
    return {"max_abs_err": err, "worst": 0.0 if off == 0 else 1.0 + off,
            "max_abs_plain": plain}


def kernel_errors(fa, q, k, v, do, causal, family="hopper"):
    """The outputs of each of ``family``'s kernels that take the inputs'
    dtype and width against its plain version on the same inputs (and a
    Hopper forward past 256 against itself, ``panel_agreement``, as its
    output "panels"): ({kernel: {output: compare(...)}}, whether the
    one-pass partials landed in a NaN-poisoned block, None where the
    family has no one-pass kernel at the width), plus lse and delta for
    the timings."""
    import torch
    kern = flash_kernels(fa, dtype_name(q), family, q.shape[-1])
    tol = flash_tol(dtype_name(q), family)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    bwd = (q, k, v, do, lse_ref, delta, causal)
    o, lse = kern["flash_fwd"](q, k, v, causal)
    outputs = {"flash_fwd": {"o": (o, o_ref), "lse": (lse, lse_ref)}}
    # The Hopper kernels sum dP in the tensor cores' order, so they are
    # held to dP - delta formed in f64 (``exact_dp``); the CUDA-core twins
    # follow the f32 plain version's order and are held to it.
    exact = family == "hopper"
    if "flash_bwd_dq" in kern:
        dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(*bwd, exact_dp=exact)
        outputs["flash_bwd_dq"] = {"dq": (kern["flash_bwd_dq"](*bwd), dq_ref)}
        dk, dv = kern["flash_bwd_dkv"](*bwd)
        outputs["flash_bwd_dkv"] = {"dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    poisoned = None
    if "flash_bwd_onepass" in kern:
        dqp_ref, dk1_ref, dv1_ref = fa.flash_bwd_onepass_reference(
            *bwd, exact_dp=exact)
        # Poison the allocator: the partials' block comes back full of
        # NaN, so a slot the kernel leaves unwritten reads NaN, not a stale
        # zero.
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        poison = torch.full(dqp_ref.shape, float("nan"), device=q.device)
        poisoned_ptr = poison.data_ptr()
        del poison
        dqp, dk1, dv1 = kern["flash_bwd_onepass"](*bwd)
        torch.cuda.synchronize()
        poisoned = dqp.data_ptr() == poisoned_ptr
        outputs["flash_bwd_onepass"] = {"dqp": (dqp, dqp_ref),
                                        "dk": (dk1, dk1_ref),
                                        "dv": (dv1, dv1_ref)}
    errs = {name: {out: compare(got, want, *tol[out])
                   for out, (got, want) in outs.items()}
            for name, outs in outputs.items()}
    if family == "hopper_f32" and "flash_bwd_onepass" in kern:
        # A slot is one block's, summed in one order: its bits repeat.
        again = kern["flash_bwd_onepass"](*bwd)
        errs["flash_bwd_onepass"]["repeat"] = bits_agreement(
            again, (dqp, dk1, dv1))
        del again
    if family in ("hopper", "hopper_f32") and q.shape[-1] > 256:
        errs["flash_fwd"]["panels"] = panel_agreement(
            fa, kern["flash_fwd"], q, k, v, do, causal)
        for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_onepass"):
            if family == "hopper_f32":
                errs[name]["panels"] = panel_agreement(
                    fa, kern[name], q, k, v, do, causal, F32_BWD_PANEL)
    if family == "simt":
        for name, outs in outputs.items():
            for out, (got, want) in outs.items():
                if got.dtype in (torch.float16, torch.bfloat16):
                    e = errs[name][out]
                    e["off_share"] = (got != want).float().mean().item()
                    e["worst"] = max(e["worst"],
                                     e["off_share"] / F16_OFF_SHARE)
    return errs, poisoned, lse_ref, delta


@contextlib.contextmanager
def flash_bwd_env(value):
    """``HVD_TPU_FLASH_BWD`` set to ``value`` inside the block, restored
    after it."""
    old = os.environ.get("HVD_TPU_FLASH_BWD")
    os.environ["HVD_TPU_FLASH_BWD"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("HVD_TPU_FLASH_BWD", None)
        else:
            os.environ["HVD_TPU_FLASH_BWD"] = old


def held_errors(fa, q, k, v, do, causal, label, family="hopper"):
    """``kernel_errors``, printed; raises if any output is past its
    limit."""
    errs, poisoned, lse_ref, delta = kernel_errors(fa, q, k, v, do, causal,
                                                   family)
    tol = flash_tol(dtype_name(q), family)
    for name, outs in errs.items():
        for out, e in outs.items():
            say("  %s %s at %s: %s (%s)" % (
                name, out, label, json.dumps({k: float("%.4g" % x)
                                              for k, x in e.items()}),
                "rtol %.3g, atol %.3g x row scale" % tol[out] if out in tol
                else "panels against panel 0's, bit for bit" if out == "panels"
                else "a second launch against the first, bit for bit"))
    if poisoned is not None:
        say("  flash_bwd_onepass partials in a NaN-poisoned block: %s"
            % poisoned)
    bad = ["%s %s" % (name, out) for name, outs in errs.items()
           for out, e in outs.items() if not e["worst"] <= 1.0]
    if bad:
        raise AssertionError("kernel output off its plain version at %s: %s"
                             % (label, ", ".join(bad)))
    return errs, lse_ref, delta


def shape_label(bh, s, d, causal):
    return "BH%d S%d D%d %s" % (bh, s, d, "causal" if causal else "full")


def check_kernels(fa, bh, s, d, causal, dtype="bfloat16", family="hopper"):
    """One shape: each of ``family``'s kernels for inputs of ``dtype`` at
    head dim ``d`` against its plain version, timed beside the plain
    version and SDPA, and, where the family has backward kernels at ``d``,
    both whole backward variants as the port routes them timed (dq +
    dk/dv kernels; one-pass kernel + the partials' sum); returns one
    record per kernel, whose ``launches`` counts this check's launches
    (not the main path's), and the variants' times (empty without
    backward kernels).  Bounds: bf16 and f16 at the tensor cores' 989
    TFLOP/s; f32 on the CUDA cores at their 67; the f32 kernels on Hopper
    at the TF32 tensor cores' 495 for SPLIT_TF32_TERMS TF32 products per
    f32 one (the least time for the f32 function on this card: an exact
    f32 product is not tensor-core work); each bound is the function's (4,
    6, 8 and 10 d FLOP a live pair), whatever the kernel recomputes."""
    import torch
    import torch.nn.functional as F
    q, k, v, do = kernel_inputs(bh, s, d, dtype)
    wrappers = flash_kernels(fa, dtype, family, d)
    peak = (PEAK_TF32_FLOPS / SPLIT_TF32_TERMS if family == "hopper_f32"
            else PEAK_F32_FLOPS if dtype == "float32" else PEAK_BF16_FLOPS)
    fa.reset_launch_counts()
    errs, lse_ref, delta = held_errors(fa, q, k, v, do, causal,
                                       shape_label(bh, s, d, causal), family)
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    io, rows = bh * s * d * q.element_size(), bh * s * 4
    partials = bh * -(-s // fa.onepass_block_k(d)) * s * d * 4
    work = {  # (FLOP, bytes): each input read once, each output written once
        "flash_fwd": (4 * d * pairs, 4 * io + rows),
        "flash_bwd_dq": (6 * d * pairs, 4 * io + 2 * rows + 2 * io),
        "flash_bwd_dkv": (8 * d * pairs, 6 * io + 2 * rows),
        "flash_bwd_onepass": (10 * d * pairs, 6 * io + 2 * rows + partials),
    }
    records = {}
    for name, outs in errs.items():
        rec = {"max_abs_err": max(e["max_abs_err"] for e in outs.values()),
               "worst": max(e["worst"] for e in outs.values())}
        rec["bound_ms"], rec["bound_by"] = bound(*work[name], peak=peak)
        records[name] = rec

    bwd = (q, k, v, do, lse_ref, delta, causal)
    runs = {
        "flash_fwd": (lambda: wrappers["flash_fwd"](q, k, v, causal),
                      lambda: fa.flash_fwd_reference(q, k, v, causal)),
        "flash_bwd_dq": (lambda: wrappers["flash_bwd_dq"](*bwd),
                         lambda: fa.flash_bwd_reference(*bwd)),
        "flash_bwd_dkv": (lambda: wrappers["flash_bwd_dkv"](*bwd),
                          lambda: fa.flash_bwd_reference(*bwd)),
        "flash_bwd_onepass": (lambda: wrappers["flash_bwd_onepass"](*bwd),
                              lambda: fa.flash_bwd_onepass_reference(*bwd)),
    }
    # The yardstick, never called by the port: SDPA at the same shape
    # (q is pre-scaled, so scale=1).  Its backward computes dq, dk and
    # dv together and stands beside every backward kernel.
    q4, k4, v4 = (t.view(1, bh, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                                  scale=1.0)
    out4 = sdpa()
    do4 = do.view(1, bh, s, d)
    lib_fwd = time_ms(lambda: sdpa().detach())
    backward = "flash_bwd_dq" in wrappers
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do4, retain_graph=True)) if backward else None
    for name, (kern, plain) in runs.items():
        if name not in wrappers:
            continue
        records[name]["ms"] = time_ms(kern, reps=20)
        records[name]["plain_ms"] = time_ms(plain)
        records[name]["library_ms"] = lib_fwd if name == "flash_fwd" else lib_bwd
    variants = {}
    if backward:
        for choice in ("pallas", "pallas_onepass"):
            with flash_bwd_env(choice):
                variants[choice] = time_ms(lambda: fa.flash_bwd(*bwd), reps=20)
        variants["sdpa"] = lib_bwd
    counts = fa.launch_counts()
    for name, wrapper in wrappers.items():
        records[name]["launches"] = counts[wrapper.__name__]
    return records, variants


def check_flash_kernels(fa, dtype="bfloat16", family="hopper"):
    """``family``'s flash kernels for ``dtype`` at their shapes (on Hopper
    FLASH_SHAPES, and HOPPER_FWD_SHAPES for the forward; SIMT_SHAPES on
    the CUDA cores; F32_FWD_SHAPES for the f32 kernels on Hopper) ->
    {shape: records}, then held at WIDE_BH_SHAPE (on Hopper also at
    WIDE_BH_D256_SHAPE)."""
    import torch
    out = {}
    hopper = family == "hopper"
    shapes = {"hopper": FLASH_SHAPES + HOPPER_FWD_SHAPES,
              "simt": SIMT_SHAPES, "hopper_f32": F32_FWD_SHAPES}[family]
    for bh, s, d, causal in shapes:
        label = "%s %s %s" % (shape_label(bh, s, d, causal), dtype, family)
        records, variants = check_kernels(fa, bh, s, d, causal, dtype,
                                          family)
        for name, rec in records.items():
            say("kernel %s %s: %s" % (name, label, json.dumps(
                {k: (round(v, 6) if isinstance(v, float) else v)
                 for k, v in rec.items()})))
        if variants:
            say("backward %s, device ms per call as the port routes it: dq "
                "+ dk/dv kernels %.6g, one-pass kernel + partials' sum %.6g, "
                "SDPA backward %.6g" % (label, variants["pallas"],
                                        variants["pallas_onepass"],
                                        variants["sdpa"]))
        out[(bh, s, d, causal)] = records
    for shape in (WIDE_BH_SHAPE,) + ((WIDE_BH_D256_SHAPE,) if hopper else ()):
        *wide, causal = shape
        held_errors(fa, *kernel_inputs(*wide, dtype), causal,
                    "%s %s %s (untimed)" % (shape_label(*shape), dtype,
                                            family), family)
        torch.cuda.empty_cache()
    return out


def model_errors(head_dim=128):
    """Loss and gradients of a small decoder (2 heads of ``head_dim``) on
    the card (bf16, kernels) against the same weights in f32 on the CPU
    (plain versions): the loss's relative error and each parameter's
    relative gradient norm error."""
    import dataclasses
    import torch
    from horovod_tpu_torch.models.convert import init_params, params_from_jax
    from horovod_tpu_torch.models.transformer import TransformerConfig, loss_fn
    from horovod_tpu_torch.train import synthetic_batch

    cfg = TransformerConfig(vocab_size=512, d_model=2 * head_dim, n_layers=2,
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


def train_f32_decoder(torch):
    """The f32 kernels' main path at small size: the small decoder (2
    heads of each of F32_HEAD_DIMS, 2 layers) at dtype float32 takes
    Adam steps (F32_STEPS at 128, one past it) through
    ``make_train_step`` on a one-rank world on the card, under each
    backward choice, and the same steps run in f32 on the CPU; every
    launch count set to 0 just before each head dim's steps, read just
    after -> {head_dim: counts}."""
    import horovod_tpu_torch as hvd
    hvd.init()
    counts = {hd: f32_decoder_steps(torch, hd) for hd in F32_HEAD_DIMS}
    hvd.shutdown()
    return counts


def f32_decoder_steps(torch, head_dim):
    """``train_f32_decoder``'s steps at one head dim (in a world already
    initialised) -> the launch counts."""
    from horovod_tpu_torch.models.convert import init_params, params_from_jax
    from horovod_tpu_torch.models.transformer import TransformerConfig, loss_fn
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import make_train_step, synthetic_batch

    cfg = TransformerConfig(vocab_size=512, d_model=2 * head_dim, n_layers=2,
                            n_heads=2, n_kv_heads=1, d_ff=512, max_seq=256,
                            dtype="float32", logits_dtype="f32")
    params, batch = init_params(cfg, seed=1), synthetic_batch(cfg, 2, seed=1)
    adam = lambda ps: torch.optim.Adam(ps, 1e-3)  # noqa: E731
    steps = F32_STEPS if head_dim == 128 else 1
    fa.reset_launch_counts()
    bad = []
    for choice in ("pallas", "pallas_onepass"):
        with flash_bwd_env(choice):
            build, shard_batch = make_train_step(cfg, adam)
            step, model, _ = build(params)
            data = shard_batch(batch)
            card = [step(data).item() for _ in range(steps)]
            ref = params_from_jax(params, cfg, "cpu")
            opt = adam(ref.parameters())
            b = {k: torch.as_tensor(v) for k, v in batch.items()}
            cpu = []
            for _ in range(steps):
                opt.zero_grad()
                loss = loss_fn(ref, b)
                loss.backward()
                opt.step()
                cpu.append(loss.item())
        losses = [abs(a - c) / abs(c) for a, c in zip(card, cpu)]
        got = dict(model.named_parameters())
        leaves = {n: ((got[n].grad.cpu() - p.grad).norm() / p.grad.norm())
                  .item() for n, p in ref.named_parameters()}
        worst = max(leaves, key=leaves.get)
        say("f32 decoder training (head_dim %d, %s): %d Adam steps on the "
            "card against the CPU, loss relative errors %s (tol %.3g); last "
            "step's gradients' relative norm error: worst %s %.3g (tol %.3g)"
            % (head_dim, choice, steps, ["%.3g" % e for e in losses],
               F32_LOSS_TOL, worst, leaves[worst], F32_LEAF_TOL))
        if max(losses) > F32_LOSS_TOL or leaves[worst] > F32_LEAF_TOL:
            bad.append(choice)
    counts = fa.launch_counts()
    say("launches on the f32 decoder path (head_dim %d): %s"
        % (head_dim, counts))
    n = cfg.n_layers * steps
    check_counts(counts, {"flash_fwd_f32_kernel": 2 * n,
                          "flash_bwd_dq_f32_kernel": n,
                          "flash_bwd_dkv_f32_kernel": n,
                          "flash_bwd_onepass_f32_kernel": n})
    if bad:
        raise AssertionError("the f32 decoder (head_dim %d) on the card "
                             "disagrees with the CPU under %s"
                             % (head_dim, bad))
    return counts


def train_f32_flagship(torch):
    """The f32 kernels' main path at the decoder flagship's width
    (bench.py:86-91, as ``train_flagship``) in float32, the Hopper f32
    forward, dq, dk/dv and one-pass: every launch count
    set to 0 just before its two steps, read just after -> the counts."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import init_params, params_from_jax
    from horovod_tpu_torch.models.transformer import TransformerConfig, loss_fn
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import make_train_step, synthetic_batch

    hvd.init()
    d, L = F32_FLAGSHIP["d"], F32_FLAGSHIP["layers"]
    seq, batch = F32_FLAGSHIP["seq"], F32_FLAGSHIP["batch"]
    cfg = TransformerConfig(vocab_size=8192, d_model=d, n_layers=L,
                            n_heads=d // 128, n_kv_heads=d // 128,
                            d_ff=d * 3, max_seq=seq, dtype="float32",
                            logits_dtype="f32")
    t0 = time.perf_counter()
    build, shard_batch = make_train_step(
        cfg, lambda params: torch.optim.Adam(params, 1e-3))
    params = init_params(cfg, seed=0)
    step, model, _ = build(params)
    data = shard_batch(synthetic_batch(cfg, batch, seed=0))
    start = [p.detach().clone() for p in model.parameters()]
    # The plain path on a copy of the weights with no gradient hooks.
    ref = params_from_jax(params, cfg, start[0].device)
    fa.reset_launch_counts()
    with env_set(HOROVOD_FLASH_ATTENTION="0"):
        loss = loss_fn(ref, data)
        loss.backward()
    want = loss.item()
    plain = {n: p.grad for n, p in ref.named_parameters()}
    del ref, loss
    if any(fa.launch_counts().values()):
        raise AssertionError("the plain attention path launched flash "
                             "kernels: %s" % fa.launch_counts())
    say("f32 flagship: d%d L%d hd%d seq %d batch %d, %d parameters; set-up "
        "and the plain path's loss and gradients %.1f s"
        % (d, L, cfg.head_dim, seq, batch, sum(p.numel() for p in start),
           time.perf_counter() - t0))
    fa.reset_launch_counts()
    bad = []
    for choice in ("pallas", "pallas_onepass"):
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), start):
                p.copy_(p0)
        with flash_bwd_env(choice):
            t = time.perf_counter()
            got = step(data).item()
            took = time.perf_counter() - t
        loss_err = abs(got - want) / abs(want)
        leaves = {n: ((p.grad - plain[n]).norm() / plain[n].norm()).item()
                  for n, p in model.named_parameters()}
        worst = max(leaves, key=leaves.get)
        say("f32 flagship step (%s): %.2f ms (its first step, negotiation "
            "included); loss relative error against the plain path %.3g "
            "(tol %.3g); gradients' relative norm error: worst %s %.3g "
            "(tol %.3g)" % (choice, took * 1e3, loss_err, F32_LOSS_TOL,
                            worst, leaves[worst], F32_LEAF_TOL))
        if not (loss_err <= F32_LOSS_TOL and leaves[worst] <= F32_LEAF_TOL):
            bad.append(choice)
    counts = fa.launch_counts()
    hvd.shutdown()
    say("launches on the f32 flagship path (2 steps): %s" % counts)
    check_counts(counts, {"flash_fwd_f32_kernel": 2 * L,
                          "flash_bwd_dq_f32_kernel": L,
                          "flash_bwd_dkv_f32_kernel": L,
                          "flash_bwd_onepass_f32_kernel": L})
    if bad:
        raise AssertionError("the f32 flagship on the card disagrees with "
                             "its plain attention path under %s" % bad)
    return counts


def check_model():
    """The small decoder at each of MODEL_HEAD_DIMS against the CPU, its
    flash launches counted -> {head_dim: counts}.  From head_dim 129 on,
    bf16 takes the Hopper forward, never the CUDA-core one; padded to 256,
    also the Hopper dq and dk/dv."""
    from horovod_tpu_torch.ops import flash_attention as fa
    counts = {}
    for head_dim in MODEL_HEAD_DIMS:
        fa.reset_launch_counts()
        loss_err, leaves = model_errors(head_dim)
        counts[head_dim] = fa.launch_counts()
        if head_dim > 128:
            say("model check (head_dim %d): flash launches %s" % (
                head_dim, {k: n for k, n in counts[head_dim].items() if n}))
            hopper = ("flash_fwd",) + (
                ("flash_bwd_dq", "flash_bwd_dkv")
                if fa.padded_head_dim(head_dim) == 256 else ())
            if not all(counts[head_dim][n + "_kernel"] == 2
                       and counts[head_dim][n + "_simt_kernel"] == 0
                       for n in hopper):
                raise AssertionError(
                    "the small decoder at head_dim %d did not take the Hopper "
                    "%s in each of its 2 layers: %s"
                    % (head_dim, ", ".join(hopper), counts[head_dim]))
        worst = max(leaves, key=leaves.get)
        say("model check (head_dim %d): loss relative error %.3g (tol %.3g); "
            "gradient relative norm error per parameter: worst %s %.3g (tol "
            "%.3g), %s" % (head_dim, loss_err, LOSS_TOL, worst, leaves[worst],
                           LEAF_TOL, json.dumps({n: float("%.3g" % e)
                                                 for n, e in leaves.items()})))
        bad = [n for n, e in leaves.items() if not e <= LEAF_TOL]
        if not loss_err <= LOSS_TOL or bad:
            raise AssertionError(
                "small decoder (head_dim %d) on the card disagrees with the "
                "f32 CPU reference: loss %.3g, gradients of %s"
                % (head_dim, loss_err, bad))
    return counts


def bn_inputs(m, c, residual):
    """x (mean 0.3, sd 1.5), dy and the residual in bf16, gamma about 1
    and beta about 0 in f32, from a seeded generator on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(m * 7919 + c)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    x = rnd(m, c, scale=1.5, shift=0.3).to(torch.bfloat16)
    dy = rnd(m, c).to(torch.bfloat16)
    res = rnd(m, c).to(torch.bfloat16) if residual else None
    return x, dy, res, rnd(c, scale=0.5, shift=1.0), rnd(c, scale=0.5)


def bn_compare(got, want, rtol, atol, scale):
    """Element-wise error of ``got`` against ``want``; ``worst`` is the
    largest |err| / (rtol |want| + atol scale), at most 1 to pass."""
    import torch
    got, want = got.float(), want.float()
    err = (got - want).abs()
    # A channel whose ReLU masks every row sums to exactly 0 on both
    # sides, with a scale of 0: an exact match reads 0, not 0/0.
    ratio = err / (rtol * want.abs() + atol * scale)
    worst = torch.where(err == 0, torch.zeros_like(ratio), ratio).max()
    return {"max_abs_err": err.max().item(), "worst": worst.item(),
            "max_abs_plain": want.abs().max().item()}


def bn_plain(bn, x, dy, res, gamma, beta, relu):
    """The plain versions in a row, as batch_norm_act chains them:
    (mean, var, y, dbeta, dgamma, dx, dres)."""
    import torch
    m = x.shape[0]
    s, q = bn.bn_stats_reference(x)
    mean, var = s / m, torch.clamp_min(q / m - torch.square(s / m), 0.0)
    y = bn.bn_apply_reference(x, mean, var, gamma, beta, res, BN_EPS, relu)
    db, dg = bn.bn_bwd_reductions_reference(x, dy, mean, var, gamma, beta,
                                            res, BN_EPS, relu)
    dx, dres = bn.bn_bwd_dx_reference(x, dy, mean, var, gamma, beta, db, dg,
                                      res, BN_EPS, relu)
    return mean, var, y, db, dg, dx, dres


def bn_errors(bn, x, dy, res, gamma, beta, relu):
    """Every BN kernel's outputs against its plain version on the same
    inputs; each kernel gets the plain versions' statistics and sums
    where it takes them.  -> ({kernel: {output: bn_compare(...)}}, the
    plain (mean, var, dbeta, dgamma))."""
    import torch
    m = x.shape[0]
    mean, var, y_ref, db_ref, dg_ref, dx_ref, dres_ref = bn_plain(
        bn, x, dy, res, gamma, beta, relu)
    s, q = bn.bn_stats_kernel(x)
    k_mean, k_var = s / m, torch.clamp_min(q / m - torch.square(s / m), 0.0)
    y = bn.bn_apply_kernel(x, mean, var, gamma, beta, res, BN_EPS, relu)
    db, dg = bn.bn_bwd_reductions_kernel(x, dy, mean, var, gamma, beta, res,
                                         BN_EPS, relu)
    dx, dres = bn.bn_bwd_dx_kernel(x, dy, mean, var, gamma, beta, db_ref,
                                   dg_ref, res, BN_EPS, relu)
    torch.cuda.synchronize()
    xf = x.float()
    xh, dye = bn._xhat_dy(x, dy, mean, var, gamma, beta, res, BN_EPS, relu)
    root = lambda t: t.square().sum(0).sqrt()
    sums = {"mean": root(xf) / m, "var": root(xf * xf) / m,
            "dbeta": root(dye), "dgamma": root(dye * xh)}

    def column(t):
        sq = t.float().square()
        return torch.maximum(sq.mean(0).sqrt(), sq.mean().sqrt() / 16)

    outputs = {"bn_stats": {"mean": (k_mean, mean), "var": (k_var, var)},
               "bn_apply": {"y": (y, y_ref)},
               "bn_bwd_red": {"dbeta": (db, db_ref), "dgamma": (dg, dg_ref)},
               "bn_bwd_dx": {"dx": (dx, dx_ref)}}
    if res is not None:
        outputs["bn_bwd_dx"]["dres"] = (dres, dres_ref)
    errs = {name: {out: bn_compare(got, want, *BN_TOL[out],
                                   sums[out] if out in sums else column(want))
                   for out, (got, want) in outs.items()}
            for name, outs in outputs.items()}
    return errs, (mean, var, db_ref, dg_ref)


def bn_work(m, c, residual):
    """(FLOP, bytes) of each BN kernel at one bf16 shape: each input read
    once, each output written once; a few f32 operations per element."""
    act, r, vec = m * c * 2, int(residual), c * 4
    return {"bn_stats": (3 * m * c, act + 2 * vec),
            "bn_apply": (7 * m * c, (2 + r) * act + 4 * vec),
            "bn_bwd_red": (10 * m * c, (2 + r) * act + 6 * vec),
            "bn_bwd_dx": (12 * m * c, (3 + 2 * r) * act + 8 * vec)}


def bn_times(bn, x, dy, res, gamma, beta, relu, stats):
    """{kernel: {ms, plain_ms, bound_ms, bound_by, library_ms}} at one
    shape.  The library yardstick, never called by the port, is
    ``F.batch_norm(training=True)`` on the same channels_last bf16
    tensor: its forward stands beside bn_stats and bn_apply, its
    backward beside bn_bwd_red and bn_bwd_dx; it fuses neither the
    residual add nor the ReLU."""
    import torch
    import torch.nn.functional as F
    m, c = x.shape
    mean, var, db, dg = stats
    runs = {
        "bn_stats": (lambda: bn.bn_stats_kernel(x),
                     lambda: bn.bn_stats_reference(x)),
        "bn_apply": (
            lambda: bn.bn_apply_kernel(x, mean, var, gamma, beta, res,
                                       BN_EPS, relu),
            lambda: bn.bn_apply_reference(x, mean, var, gamma, beta, res,
                                          BN_EPS, relu)),
        "bn_bwd_red": (
            lambda: bn.bn_bwd_reductions_kernel(x, dy, mean, var, gamma,
                                                beta, res, BN_EPS, relu),
            lambda: bn.bn_bwd_reductions_reference(x, dy, mean, var, gamma,
                                                   beta, res, BN_EPS, relu)),
        "bn_bwd_dx": (
            lambda: bn.bn_bwd_dx_kernel(x, dy, mean, var, gamma, beta, db, dg,
                                        res, BN_EPS, relu),
            lambda: bn.bn_bwd_dx_reference(x, dy, mean, var, gamma, beta, db,
                                           dg, res, BN_EPS, relu)),
    }
    x4 = x.view(1, m, 1, c).permute(0, 3, 1, 2).detach().requires_grad_()
    w, b = (t.clone().requires_grad_() for t in (gamma, beta))
    lib = lambda: F.batch_norm(x4, None, None, w, b, training=True,
                               eps=BN_EPS)
    out4, dy4 = lib(), dy.view(1, m, 1, c).permute(0, 3, 1, 2)
    lib_ms = {"fwd": time_ms(lambda: lib().detach()),
              "bwd": time_ms(lambda: torch.autograd.grad(
                  out4, (x4, w, b), dy4, retain_graph=True))}
    work = bn_work(m, c, res is not None)
    out = {}
    for name, (kern, plain) in runs.items():
        rec = {"ms": time_ms(kern, reps=20), "plain_ms": time_ms(plain),
               "library_ms": lib_ms["fwd" if name in ("bn_stats", "bn_apply")
                                    else "bwd"]}
        rec["bound_ms"], rec["bound_by"] = bound(*work[name],
                                                 peak=PEAK_F32_FLOPS)
        out[name] = rec
    return out


def check_bn_kernels(bn):
    """The four BN kernels against their plain versions at BN_SHAPES,
    timed there; returns the largest error of each kernel's outputs and
    the timings ``{shape label: bn_times(...)}``."""
    max_err = dict.fromkeys(BN_KERNELS, 0.0)
    bad, all_times = [], {}
    for label, m, c, relu, residual in BN_SHAPES:
        x, dy, res, gamma, beta = bn_inputs(m, c, residual)
        errs, stats = bn_errors(bn, x, dy, res, gamma, beta, relu)
        times = all_times[label] = bn_times(bn, x, dy, res, gamma, beta,
                                            relu, stats)
        what = "%s M%d C%d%s%s" % (label, m, c, " relu" if relu else "",
                                   " residual" if residual else "")
        for name, outs in errs.items():
            for out, e in outs.items():
                max_err[name] = max(max_err[name], e["max_abs_err"])
                if not e["worst"] <= 1.0:
                    bad.append("%s %s at %s" % (name, out, what))
            say("bn kernel %s %s: %s; %s" % (
                name, what, json.dumps({
                    out: {k: float("%.4g" % v) for k, v in e.items()}
                    for out, e in outs.items()}),
                json.dumps({k: (float("%.6g" % v) if isinstance(v, float)
                                else v) for k, v in times[name].items()})))
    say("bn tolerances (rtol, atol x scale): %s; library_ms is "
        "F.batch_norm(training=True) on the same channels_last bf16 tensor, "
        "forward beside bn_stats and bn_apply, backward beside bn_bwd_red "
        "and bn_bwd_dx, without the residual add or the ReLU"
        % json.dumps(BN_TOL))
    if bad:
        raise AssertionError("BN kernel output off its plain version: %s"
                             % ", ".join(bad))
    return max_err, all_times


def resnet_model_errors(image=RN_IMAGE, batch=RN_BATCH):
    """Loss and gradients of a small ResNet-50 (10 classes) on the card,
    with the kernels, against the same weights in f32 on the CPU, with
    the plain versions: f32 on the card (TF32 off) gives the loss's
    relative error and each parameter's relative gradient norm error;
    bf16 on the card gives the loss's relative error.  The blocks'
    last-norm scales are random in [0.2, 0.5], so that the residual
    branches pass gradient.  -> (loss_f32, leaves_f32, loss_bf16)."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models.convert_resnet import (init_params,
                                                         params_from_flax)
    from horovod_tpu_torch.models.resnet import ResNetConfig, resnet_loss_fn
    from horovod_tpu_torch.train import synthetic_images

    variables = init_params(50, 10, seed=1)
    rng = np.random.RandomState(1)
    for block in variables["params"].values():
        for mod in block.values():
            if isinstance(mod, dict) and "scale" in mod \
                    and not mod["scale"].any():
                mod["scale"][...] = rng.uniform(0.2, 0.5, mod["scale"].shape)
    data = synthetic_images(batch, image, 10, seed=1)
    out = {}
    for dtype, dev in (("float32", "cuda"), ("bfloat16", "cuda"),
                       ("float32", "cpu")):
        cfg = ResNetConfig(50, 10, dtype)
        model = params_from_flax(variables, cfg, dev)
        b = {"x": torch.as_tensor(data["x"], device=dev).to(cfg.act_dtype)
             .permute(0, 3, 1, 2),
             "y": torch.as_tensor(data["y"], device=dev)}
        loss = resnet_loss_fn(model, b)
        loss.backward()
        out[dtype, dev] = (loss.item(), {n: p.grad.float().cpu()
                                         for n, p in model.named_parameters()})
    l_cpu, g_cpu = out["float32", "cpu"]
    l_gpu, g_gpu = out["float32", "cuda"]
    leaves = {n: ((g_gpu[n] - g).norm() / g.norm()).item()
              for n, g in g_cpu.items()}
    l_bf16 = out["bfloat16", "cuda"][0]
    return (abs(l_gpu - l_cpu) / abs(l_cpu), leaves,
            abs(l_bf16 - l_cpu) / abs(l_cpu))


def check_resnet_model():
    loss_err, leaves, bf16_err = resnet_model_errors()
    worst = max(leaves, key=leaves.get)
    ranked = sorted(leaves.items(), key=lambda kv: -kv[1])
    say("resnet model check (ResNet-50, image %d, batch %d, 10 classes; "
        "card against f32 CPU): f32 loss relative error %.3g (tol %.3g), "
        "gradient relative norm error per parameter: worst %s %.3g (tol "
        "%.3g), median %.3g, top 5 %s; bf16 loss relative error %.3g (tol "
        "%.3g)" % (RN_IMAGE, RN_BATCH, loss_err, RN_LOSS_TOL, worst,
                   leaves[worst], RN_LEAF_TOL,
                   statistics.median(leaves.values()),
                   json.dumps({n: float("%.3g" % e) for n, e in ranked[:5]}),
                   bf16_err, RN_BF16_LOSS_TOL))
    bad = [n for n, e in leaves.items() if not e <= RN_LEAF_TOL]
    if (not loss_err <= RN_LOSS_TOL or bad
            or not bf16_err <= RN_BF16_LOSS_TOL):
        raise AssertionError("small ResNet-50 on the card disagrees with the "
                             "f32 CPU reference: loss %.3g (bf16 %.3g), "
                             "gradients of %s" % (loss_err, bf16_err, bad))


def bert_model_errors(choice, device="cuda"):
    """Loss and gradients of a small BERT (vocab 512, d 256, 2 layers, 4
    heads of 64, d_ff 1024, batch 2, seq 128, 2 classes; classification)
    in bf16 on ``device``, with the kernels there and HVD_TPU_FLASH_BWD =
    ``choice``, against the same weights in f32 on the CPU (plain
    versions): the loss's relative error and each parameter's relative
    gradient norm error.  bk's gradient is zero in exact arithmetic, so
    its norm on the card over bq's stands in for its error; the MLM head,
    which the objective does not reach, is left out."""
    import torch
    from horovod_tpu_torch.models.bert import BertConfig, classification_loss
    from horovod_tpu_torch.models.convert_bert import (init_params,
                                                       params_from_jax)
    from horovod_tpu_torch.train import synthetic_bert_batch

    cfg = BertConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                     d_ff=1024, max_seq=128)
    params = init_params(cfg, seed=1)
    batch = synthetic_bert_batch(cfg, 2, 128, seed=1)
    out = []
    with flash_bwd_env(choice):
        for dtype, dev in (("bfloat16", device), ("float32", "cpu")):
            c = BertConfig(**{**cfg.__dict__, "dtype": dtype})
            model = params_from_jax(params, c, dev)
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            loss = classification_loss(model, b)
            loss.backward()
            out.append((loss.item(), {n: p.grad.float().cpu()
                                      for n, p in model.named_parameters()
                                      if p.grad is not None}))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out
    leaves = {}
    for n, g in g_cpu.items():
        if n.endswith(".bk"):
            ref = g_cpu[n[:-2] + "bq"].norm()
            leaves[n] = (g_gpu[n].norm() / ref).item()
        else:
            leaves[n] = ((g_gpu[n] - g).norm() / g.norm()).item()
    return abs(l_gpu - l_cpu) / abs(l_cpu), leaves


def check_bert_model():
    """The small BERT under both backward choices (phase 3)."""
    for choice in ("pallas", "pallas_onepass"):
        loss_err, leaves = bert_model_errors(choice)
        ranked = sorted(leaves.items(), key=lambda kv: -kv[1])
        say("bert model check (%s backward; bf16 card against f32 CPU): "
            "loss relative error %.3g (tol %.3g); gradient relative norm "
            "error per parameter: worst %s %.3g (tol %.3g), median %.3g, "
            "top 5 %s" % (choice, loss_err, BERT_LOSS_TOL, ranked[0][0],
                          ranked[0][1], BERT_LEAF_TOL,
                          statistics.median(leaves.values()),
                          json.dumps({n: float("%.3g" % e)
                                      for n, e in ranked[:5]})))
        bad = [n for n, e in leaves.items() if not e <= BERT_LEAF_TOL]
        if not loss_err <= BERT_LOSS_TOL or bad:
            raise AssertionError(
                "small BERT (%s) on the card disagrees with the f32 CPU "
                "reference: loss %.3g, gradients of %s"
                % (choice, loss_err, bad))


# The kernels' element types as the Itanium ABI mangles them.
_TYPES = "f|6__half|13__nv_bfloat16"


def _type_name(mangled) -> str:
    return {"f": "float", "6__half": "half",
            "13__nv_bfloat16": "bf16"}[mangled]


def print_ptxas(text: str):
    """nvcc's -Xptxas=-v report: one line per flash kernel
    instantiation (registers, spills, shared memory); the BN kernels'
    instantiations (type x vector width x ReLU x residual) summed up per
    kernel as a register range and the largest spill."""
    name, bn_regs = None, {}
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            spills = ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "registers" in line:
            # _ZN8hvdflash16flash_fwd_kernelI6__halfLi128ELb1EEEv... ->
            # flash_fwd_kernel<half, 128, 1>: every flash kernel, Hopper
            # and CUDA-core, is one instance per element type
            k = re.search(r"hvdflash\d+(\w+?)I(%s)Li(\d+)ELb(\d)E" % _TYPES,
                          name)
            # the CUDA-core ones: <type, D, causal, panels past 256>
            t = re.search(r"hvdsimt\d+(\w+?)I(%s)Li(\d+)ELb(\d)ELb(\d)E"
                          % _TYPES, name)
            # the f32 forward on Hopper: <panel width W, causal>
            f = re.search(r"hvdf32\d+(\w+?)ILi(\d+)ELb(\d)E", name)
            b = re.search(r"hvdbn\d+(bn_\w+?_kernel)", name)
            if b:
                regs = int(re.search(r"Used (\d+) registers", line).group(1))
                spill = int(re.search(r"(\d+) bytes spill stores", spills)
                            .group(1)) if spills else 0
                bn_regs.setdefault(b.group(1), []).append((regs, spill))
            else:
                label = ("%s<%s, %s, %s>" % (
                    k.group(1), _type_name(k.group(2)), *k.groups()[2:])
                    if k else "simt %s<%s, %s, %s, %s>" % (
                        t.group(1), _type_name(t.group(2)), *t.groups()[2:])
                    if t else "%s<%s, %s>" % f.groups() if f else name)
                say("  ptxas %-26s %s; %s" % (
                    label, line.split(":", 1)[-1].strip(), spills))
            name = None
    for kern, vals in sorted(bn_regs.items()):
        say("  ptxas %-26s %d instantiation(s), %d-%d registers, largest "
            "spill %d bytes" % (kern, len(vals), min(v[0] for v in vals),
                                max(v[0] for v in vals),
                                max(v[1] for v in vals)))


FAMILIES = (("flash_fwd", ("flash_fwd_kernel", "flash_fwd_wide_kernel")),
            ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
            ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",
                               "flash_bwd_dkv_d256")),
            ("flash_bwd_onepass", ("flash_bwd_onepass_kernel",
                                   "flash_bwd_onepass_d256")),
            ("bn_stats", ("bn_stats_",)),
            ("bn_apply", ("bn_apply_kernel",)),
            ("bn_bwd_red", ("bn_bwd_red_",)),
            ("bn_bwd_dx", ("bn_bwd_dx_kernel",)),
            ("scale_sum", ("scale_sum_kernel",)),
            ("adasum dots (cuBLAS dot)", ("dot_kernel", "reduce_1block")),
            ("allreduce (nccl)", ("nccl",)),
            ("conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                              "winograd")),
            ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
            ("optimizer (foreach)", ("multi_tensor_apply",)))


def profile_step(torch, step, data, step_ms, annotation=None):
    """Device time of one more flagship step by kernel family, from
    torch.profiler's kernel events -> {family: ms}; prints each family's
    largest kernels (8 of the "other" family, 3 of the rest).  The device's busy
    time is the union of the kernels' intervals; its idle share is taken
    against ``step_ms``, the unprofiled median step, since the profiled
    step's host time includes the profiler's own overhead.  With
    ``annotation`` (a ``record_function`` name inside the step), the kernels
    inside that range's device span are also summed apart and printed:
    the scale-sum kernel and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(data)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if annotation and e.name == annotation
             and e.device_type == DeviceType.CUDA]
    if not kernels:
        say("profile: the profiler recorded no device time (not measured)")
        return {}
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
        by_name.setdefault(fam, {})
        by_name[fam][e.name] = by_name[fam].get(e.name, 0.0) + us
    say("profile: one step, device busy %.2f ms, idle share %.1f%% of the "
        "%.2f ms median step (profiled step's host time %.2f ms)"
        % (busy / 1e3, 100 * (1 - busy / 1e3 / step_ms), step_ms,
           wall_us / 1e3))
    for fam, us in sorted(totals.items(), key=lambda kv: -kv[1]):
        say("  %-40s %9.3f ms  %5.1f%% of kernel time"
            % (fam, us / 1e3, 100 * us / sum(totals.values())))
        top = 8 if fam.startswith("other") else 3
        for name, t in sorted(by_name[fam].items(),
                              key=lambda kv: -kv[1])[:top]:
            say("      %9.3f ms  %s" % (t / 1e3, name[:100]))
    if annotation:
        inside = [e for e in kernels if any(
            a <= e.time_range.start and e.time_range.end <= b
            for a, b in spans)]
        ss_us = sum(e.time_range.elapsed_us() for e in inside
                    if "scale_sum_kernel" in e.name)
        rest_us = sum(e.time_range.elapsed_us() for e in inside) - ss_us
        say("  %s, device span %s: %d kernels, scale_sum %.3f ms, dots and "
            "coefficient ops %.3f ms" % (
                annotation, "%.3f ms" % (sum(b - a for a, b in spans) / 1e3)
                if spans else "not measured (no device span recorded)",
                len(inside), ss_us / 1e3, rest_us / 1e3))
    return {fam: us / 1e3 for fam, us in totals.items()}


def train_flagship(torch):
    import horovod_tpu_torch as hvd
    import torch.distributed as dist
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import TransformerConfig
    from horovod_tpu_torch.ops import batch_norm as bn
    from horovod_tpu_torch.ops import fastpath
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import scale_sum as ss
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
    say("flagship: d%d L%d hd%d seq %d batch %d, %d parameters, one named "
        "allreduce per parameter (%d) through the engine; set-up %.1f s"
        % (d, L, cfg.head_dim, seq, batch, n_params,
           len(list(model.parameters())), time.perf_counter() - t0))

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    bn.reset_launch_counts()
    ss.reset_launch_counts()
    warm_up("flagship", step, data)
    losses, times = [], []
    fp_before = fastpath.describe()
    before = engine_counts()
    for i in range(STEPS):
        t = time.perf_counter()
        loss = step(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
        say("step %d: loss %.6f, %.2f ms" % (i, losses[-1], times[-1] * 1e3))
    per_step = report_engine("flagship", before, engine_counts(), STEPS,
                             sum(p.grad.numel() * p.grad.element_size()
                                 for p in model.parameters()))
    report_fastpath("flagship", fp_before, per_step, STEPS)
    counts = {**fa.launch_counts(), **ss.launch_counts()}
    if any(bn.launch_counts().values()):
        raise AssertionError("the decoder launched BN kernels: %s"
                             % bn.launch_counts())
    med = statistics.median(times)
    say("flagship: median step_ms %.2f, tok/s %.1f, peak memory %.2f GB"
        % (med * 1e3, batch * seq / med,
           torch.cuda.max_memory_allocated() / 1e9))
    n = WARMUP_STEPS + STEPS
    say("launches on the main path (%d steps): %s" % (n, counts))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss: %s" % losses)
    check_counts(counts, {"flash_fwd_kernel": L * n,
                          "flash_bwd_dq_kernel": L * n,
                          "flash_bwd_dkv_kernel": L * n,
                          "flash_bwd_onepass_kernel": 0,
                          "scale_sum_kernel": 0})
    buckets = capture_buckets(torch, step, data)
    profile_step(torch, step, data, med * 1e3)
    hvd.shutdown()
    return counts, buckets


def capture_buckets(torch, step, data):
    """One more frozen step of the flagship, recording the buffers its
    fused allreduces reduce: the gradient buckets of a real step (at size 1
    the buffer holds the gradients, prescale 1, nothing to divide)."""
    import torch.distributed as dist
    seen, all_reduce = [], dist.all_reduce

    def record(tensor, *args, **kwargs):
        seen.append(tensor.detach().clone())
        return all_reduce(tensor, *args, **kwargs)

    dist.all_reduce = record
    try:
        step(data)
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
    # Cloned on the caller's stream, after the executor's work is done.
    buckets = [b.clone() for b in seen]
    torch.cuda.synchronize()
    say("flagship: %d frozen gradient buckets of one step, %d f32 elements "
        "(%s)" % (len(buckets), sum(b.numel() for b in buckets),
                  [b.numel() for b in buckets]))
    if len(buckets) != DECODER_BUCKETS or any(
            b.dtype != torch.float32 for b in buckets) or sum(
            b.numel() for b in buckets) != DECODER_GRADS:
        raise AssertionError("the flagship's buckets are not its %d f32 "
                             "buckets of %d gradients" % (DECODER_BUCKETS,
                                                          DECODER_GRADS))
    return buckets


def check_counts(counts, expected):
    """Every count as ``expected`` says; a kernel it does not name must
    not have launched."""
    for name, n in counts.items():
        if n != expected.get(name, 0):
            raise AssertionError("%s launched %d times, expected %d"
                                 % (name, n, expected.get(name, 0)))


ENGINE_SERIES = {"cycles": "engine_cycles_total",
                 "groups": "engine_last_group_id",
                 "fused_tensors": "engine_tensors_fused_total",
                 "fused_bytes": "engine_bytes_fused_total",
                 "submitted": "engine_bytes_submitted_total"}


def engine_counts():
    """The engine's counters now (``hvd.metrics_snapshot``); ``groups``
    is the id of the last executed collective group of the running
    engine, so its difference counts the groups executed between two
    readings."""
    import horovod_tpu_torch as hvd
    snap = hvd.metrics_snapshot()
    return {k: snap.get(v, {}).get("value", 0.0)
            for k, v in ENGINE_SERIES.items()}


def report_engine(label, before, after, steps, grad_bytes):
    """Prints the engine's cycles, executed groups, fused tensors and
    fused bytes per step over ``steps`` steps, and fails unless every
    gradient byte of every step (``grad_bytes`` a step) was submitted."""
    d = {k: after[k] - before[k] for k in after}
    say("%s: engine per step (%d steps): %.1f cycles, %.1f executed "
        "collective groups, %.1f tensors in multi-tensor fused groups, "
        "%.0f fused bytes; %.0f bytes submitted a step, %d gradient bytes "
        "a step" % (label, steps, d["cycles"] / steps, d["groups"] / steps,
                    d["fused_tensors"] / steps, d["fused_bytes"] / steps,
                    d["submitted"] / steps, grad_bytes))
    if d["submitted"] != steps * grad_bytes:
        raise AssertionError("%s: %d bytes submitted to the engine in %d "
                             "steps, expected %d" % (
                                 label, d["submitted"], steps,
                                 steps * grad_bytes))
    return {k: v / steps for k, v in d.items()}


def warm_up(label, step, data):
    """``WARMUP_STEPS`` untimed steps (the fast path freezes in them);
    prints their losses and ms on one line."""
    import torch
    out = []
    for _ in range(WARMUP_STEPS):
        t = time.perf_counter()
        loss = step(data)
        torch.cuda.synchronize()
        out.append("%.4f/%.1f" % (loss.item(), (time.perf_counter() - t) * 1e3))
    say("%s: %d warm-up steps (loss/ms): %s" % (label, WARMUP_STEPS,
                                                " ".join(out)))


def report_fastpath(label, before, per_step, steps, frozen=True):
    """Prints the fast path over the timed steps (``before``: its
    ``describe()`` just before them; ``per_step``: ``report_engine``'s
    counts a step) and fails unless every timed step ran frozen (one
    frozen round a step, no negotiated cycle, no thaw), or, with
    ``frozen`` False or the fast path off (``HOROVOD_FAST_PATH=0``),
    unless none did."""
    from horovod_tpu_torch.ops import fastpath
    after = fastpath.describe()
    rounds = after["frozen_cycles_total"] - before["frozen_cycles_total"]
    thaws = {r: n - before["thaws_by_reason"].get(r, 0.0)
             for r, n in after["thaws_by_reason"].items()
             if n != before["thaws_by_reason"].get(r, 0.0)}
    cycles = per_step["cycles"] * steps
    say("%s: fast path over the %d timed steps: %d frozen rounds, %.1f "
        "buckets a step, %d negotiated cycles, thaws by reason %s; "
        "describe() %s" % (label, steps, rounds, per_step["groups"], cycles,
                           json.dumps(thaws), json.dumps(after)))
    plane = after["planes"].get("engine", {})
    frozen = frozen and plane.get("enabled")
    if frozen and (rounds != steps or cycles or thaws
                   or not plane.get("frozen")):
        raise AssertionError("%s: the fast path did not run every timed "
                             "step frozen" % label)
    if not frozen and (rounds or plane.get("frozen")):
        raise AssertionError("%s: a round froze that must stay negotiated"
                             % label)


def train_resnet_flagship(torch, batch=128, image=224):
    """ResNet-50 of bench.py:274-321 through the port's entry points:
    batch 128, 224^2, 1000 classes, bf16, SGD(0.1, momentum 0.9), from
    numpy seed 0; each BN kernel must launch 53 times a step, flash none.
    Returns the launch counts, one step's NormAct shapes and the profiled
    step's device time by kernel family."""
    import collections
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert_resnet import init_params
    from horovod_tpu_torch.models.resnet import NormAct, ResNetConfig
    from horovod_tpu_torch.ops import batch_norm as bn
    from horovod_tpu_torch.ops import fastpath
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import scale_sum as ss
    from horovod_tpu_torch.train import (make_resnet_train_step,
                                         synthetic_images)

    hvd.init()
    cfg = ResNetConfig(depth=50, num_classes=1000, dtype="bfloat16")
    t0 = time.perf_counter()
    build, shard_batch = make_resnet_train_step(
        cfg, lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9))
    step, model, opt = build(init_params(50, 1000, seed=0))
    data = shard_batch(synthetic_images(batch, image, 1000, seed=0))
    torch.cuda.synchronize()
    norms = [m for m in model.modules() if isinstance(m, NormAct)]
    say("resnet flagship: ResNet-50 batch %d, %dx%d, %d parameters, %d "
        "NormActs, one named allreduce per parameter (%d) through the "
        "engine; set-up %.1f s"
        % (batch, image, image, sum(p.numel() for p in model.parameters()),
           len(norms), len(list(model.parameters())),
           time.perf_counter() - t0))

    # The NormAct input shapes of one step, read by forward pre-hooks
    # during the first timed step (they launch nothing): they give the
    # step's BN byte bound, beside which the profile's BN time is read.
    shapes = collections.Counter()

    def record(mod, args):
        x = args[0]
        shapes[(x.numel() // x.shape[1], x.shape[1], mod.relu,
                len(args) > 1 and args[1] is not None)] += 1

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    bn.reset_launch_counts()
    ss.reset_launch_counts()
    warm_up("resnet flagship", step, data)
    hooks = [m.register_forward_pre_hook(record) for m in norms]
    losses, times = [], []
    fp_before = fastpath.describe()
    before = engine_counts()
    for i in range(STEPS):
        t = time.perf_counter()
        loss = step(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
        for h in hooks:
            h.remove()
        hooks = []
        say("resnet step %d: loss %.6f, %.2f ms"
            % (i, losses[-1], times[-1] * 1e3))
    per_step = report_engine("resnet flagship", before, engine_counts(),
                             STEPS, sum(p.grad.numel() * p.grad.element_size()
                                        for p in model.parameters()))
    report_fastpath("resnet flagship", fp_before, per_step, STEPS)
    counts = bn.launch_counts()
    flash = {**fa.launch_counts(), **ss.launch_counts()}
    med = statistics.median(times)
    say("resnet flagship: median step_ms %.2f, img/s %.1f, peak memory "
        "%.2f GB" % (med * 1e3, batch / med,
                     torch.cuda.max_memory_allocated() / 1e9))
    n = WARMUP_STEPS + STEPS
    say("launches on the resnet path (%d steps): %s, flash %s"
        % (n, counts, flash))
    n_norm = sum(shapes.values())
    elems = sum(n * m * c for (m, c, _, _), n in shapes.items())
    res_elems = sum(n * m * c for (m, c, _, r), n in shapes.items() if r)
    say("resnet NormAct shapes of one step: %d layers, sum M*C %d, of them "
        "with a residual %d; %s" % (n_norm, elems, res_elems, json.dumps(
            ["M%d C%d%s%s x%d" % (m, c, " relu" if rl else "",
                                  " res" if r else "", n)
             for (m, c, rl, r), n in sorted(shapes.items())])))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss: %s" % losses)
    if n_norm != len(norms) or any(flash.values()):
        raise AssertionError("%d NormActs seen in a step of %d; flash %s"
                             % (n_norm, len(norms), flash))
    for name, k in counts.items():
        if k != len(norms) * n:
            raise AssertionError("%s launched %d times, expected %d"
                                 % (name, k, len(norms) * n))
    prof = profile_step(torch, step, data, med * 1e3)
    hvd.shutdown()
    return counts, shapes, prof


def train_bert_flagship(torch, batch=32, seq=384):
    """BERT-Large fine-tuning through the port's entry points, the recipe
    of examples/pytorch_bert_finetune.py: hvd.init, broadcast of the
    parameters and the optimizer state, DistributedOptimizer(AdamW(5e-5,
    weight decay 0.01), num_groups=8, compression=Compression.fp16),
    classification loss, bf16 activations, f32 parameters; weights and
    data from numpy seed 0; HVD_TPU_FLASH_BWD=pallas_onepass as set by
    the caller.  Each step must launch flash_fwd and flash_bwd_onepass
    once per layer, no other flash kernel and no BN kernel, and every
    allreduce of the step must carry an fp16 buffer.  Returns the launch
    counts and the profiled step's device time by kernel family."""
    import horovod_tpu_torch as hvd
    import torch.distributed as dist
    from horovod_tpu_torch.models.bert import BertConfig
    from horovod_tpu_torch.models.convert_bert import init_params
    from horovod_tpu_torch.ops import batch_norm as bn
    from horovod_tpu_torch.ops import fastpath
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import scale_sum as ss
    from horovod_tpu_torch.train import (make_bert_train_step,
                                         synthetic_bert_batch)

    hvd.init()
    # google-research/bert BERT-Large, Uncased (bert_config.json); batch
    # 32 (arXiv:1810.04805 section 4.2, SQuAD) at run_squad.py's
    # max_seq_length 384.
    cfg = BertConfig(vocab_size=30522, d_model=1024, n_layers=24, n_heads=16,
                     d_ff=4096, max_seq=512, type_vocab=2, n_classes=2,
                     norm_eps=1e-12)
    L = cfg.n_layers
    t0 = time.perf_counter()
    build, shard_batch = make_bert_train_step(
        cfg, lambda ps: torch.optim.AdamW(ps, lr=5e-5, weight_decay=0.01),
        objective="classification", compression=hvd.Compression.fp16,
        num_groups=8)
    step, model, opt = build(init_params(cfg, seed=0))
    data = shard_batch(synthetic_bert_batch(cfg, batch, seq, seed=0))
    torch.cuda.synchronize()
    say("bert flagship: BERT-Large d%d L%d %d heads of %d, d_ff %d, batch "
        "%d, seq %d, %d parameters, %d grouped allreduces through the "
        "engine, fp16 wire, backward %s; set-up %.1f s"
        % (cfg.d_model, L, cfg.n_heads, cfg.head_dim, cfg.d_ff, batch, seq,
           sum(p.numel() for p in model.parameters()), len(opt._groups),
           fa.bwd_choice(), time.perf_counter() - t0))

    wires, all_reduce = [], dist.all_reduce

    def record(tensor, *args, **kwargs):
        wires.append((str(tensor.dtype), tensor.numel()))
        return all_reduce(tensor, *args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    bn.reset_launch_counts()
    ss.reset_launch_counts()
    warm_up("bert flagship", step, data)
    losses, times = [], []
    fp_before = fastpath.describe()
    before = engine_counts()
    for i in range(STEPS):
        dist.all_reduce = record if i == 0 else all_reduce
        try:
            t = time.perf_counter()
            loss = step(data)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        finally:
            dist.all_reduce = all_reduce
        if i == 0:
            step0_groups = engine_counts()["groups"] - before["groups"]
        losses.append(loss.item())
        say("bert step %d: loss %.6f, %.2f ms" % (i, losses[-1],
                                                 times[-1] * 1e3))
    # fp16 wire: two bytes per gradient element.
    per_step = report_engine("bert flagship", before, engine_counts(),
                             STEPS, sum(2 * p.grad.numel()
                                        for p in model.parameters()
                                        if p.grad is not None))
    report_fastpath("bert flagship", fp_before, per_step, STEPS)
    counts = {**fa.launch_counts(), **ss.launch_counts()}
    med = statistics.median(times)
    say("bert flagship: median step_ms %.2f, tok/s %.1f, peak memory %.2f GB"
        % (med * 1e3, batch * seq / med,
           torch.cuda.max_memory_allocated() / 1e9))
    n = WARMUP_STEPS + STEPS
    say("launches on the bert path (%d steps): %s, bn %s; allreduces of "
        "timed step 0 (dtype, elements): %s" % (n, counts,
                                                bn.launch_counts(), wires))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss: %s" % losses)
    if any(bn.launch_counts().values()):
        raise AssertionError("BERT launched BN kernels: %s"
                             % bn.launch_counts())
    # Each of the 8 groups goes out in buckets of its own (the frozen
    # schedule is cut where a group begins).
    if len(wires) != step0_groups or len(wires) < len(opt._groups) or any(
            dt != "torch.float16" for dt, _ in wires):
        raise AssertionError("expected %d fp16 allreduces (the engine's "
                             "groups) in a step, at least %d, got %s"
                             % (step0_groups, len(opt._groups), wires))
    check_counts(counts, {"flash_fwd_kernel": L * n,
                          "flash_bwd_dq_kernel": 0,
                          "flash_bwd_dkv_kernel": 0,
                          "flash_bwd_onepass_kernel": L * n,
                          "scale_sum_kernel": 0})
    prof = profile_step(torch, step, data, med * 1e3)
    hvd.shutdown()
    return counts, prof


def f16_leaf_errors(grads, plain):
    """Each gradient leaf of an f16 step against the plain attention path's
    (``plain``, unscaled): its error over the larger of its own plain norm
    and F16_BERT_LEAF_FLOOR times the largest plain norm of its kind (the
    same leaf in any layer; a top-level leaf is its own kind).  A bias
    ``bk``, zero in exact arithmetic, by its norm over ``bq``'s scale.
    -> (floored errors, unfloored errors, plain norms)."""
    def kind(name):  # "layers.6.wq" -> "wq"
        return name.split(".")[-1] if name.startswith("layers.") else name

    norms = {n: g.norm().item() for n, g in plain.items()}
    largest = {}
    for n, v in norms.items():
        largest[kind(n)] = max(largest.get(kind(n), 0.0), v)
    leaves, raw = {}, {}
    for n, g in grads.items():
        ref = n[:-2] + "bq" if n.endswith(".bk") else n
        err = (g.norm() if n.endswith(".bk") else (g - plain[n]).norm()).item()
        raw[n] = err / norms[ref]
        leaves[n] = err / max(norms[ref],
                              F16_BERT_LEAF_FLOOR * largest[kind(ref)])
    return leaves, raw, norms


def held_f16_step(label, took, got, want, grads, plain, layers):
    """Prints a step's loss and gradients (f16, or bf16 with 256-wide
    heads) against its plain attention path's (``f16_leaf_errors``; the q
    and k projections layer by layer) and raises past BERT_LOSS_TOL or
    BERT_LEAF_TOL."""
    loss_err = abs(got - want) / abs(want)
    leaves, raw, norms = f16_leaf_errors(grads, plain)
    say("%s q and k projections by layer (plain norm, card norm, relative "
        "error unfloored / floored): %s" % (label, "; ".join(
            "%d: wq %.3g %.3g %.3g/%.3g, wk %.3g %.3g %.3g/%.3g" % (
                i, *(x for leaf in ("wq", "wk") for x in (
                    norms["layers.%d.%s" % (i, leaf)],
                    grads["layers.%d.%s" % (i, leaf)].norm().item(),
                    raw["layers.%d.%s" % (i, leaf)],
                    leaves["layers.%d.%s" % (i, leaf)])))
            for i in range(layers))))
    worst_raw = sorted(raw.items(), key=lambda kv: -kv[1])[:5]
    say("%s: leaves' relative errors over their own plain norm, worst 5: %s"
        % (label, json.dumps({n: float("%.3g" % e) for n, e in worst_raw})))
    ranked = sorted(leaves.items(), key=lambda kv: -kv[1])
    say("%s step: %.2f ms (its first step, negotiation included); loss "
        "%.6f, relative error against the plain path %.3g (tol %.3g); "
        "gradients' relative norm error (floored at %g of the kind's "
        "largest): worst %s %.3g (tol %.3g), median %.3g, top 5 %s"
        % (label, took * 1e3, got, loss_err, BERT_LOSS_TOL,
           F16_BERT_LEAF_FLOOR, ranked[0][0], ranked[0][1], BERT_LEAF_TOL,
           statistics.median(leaves.values()),
           json.dumps({n: float("%.3g" % e) for n, e in ranked[:5]})))
    if not math.isfinite(got):
        raise AssertionError("%s: non-finite loss %s" % (label, got))
    if not (loss_err <= BERT_LOSS_TOL and ranked[0][1] <= BERT_LEAF_TOL):
        raise AssertionError("the %s step disagrees with its plain attention "
                             "path: loss %.3g, worst leaf %s %.3g"
                             % (label, loss_err, *ranked[0]))


def timed_steps(torch, step, data, choice):
    """STEPS steps under HVD_TPU_FLASH_BWD=``choice`` -> (their ms, the
    last loss, how many ran frozen)."""
    from horovod_tpu_torch.ops import fastpath
    before = fastpath.describe()["frozen_cycles_total"]
    times = []
    with flash_bwd_env(choice):
        for _ in range(STEPS):
            t = time.perf_counter()
            loss = step(data)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    frozen = fastpath.describe()["frozen_cycles_total"] - before
    return times, loss.item(), frozen


def train_decoder_f16(torch):
    """The f16 Hopper dq and dk/dv kernels' main path: the decoder flagship
    (``train_flagship``'s configuration, bench.py:86-91, and its Adam) at
    dtype float16 with f32 parameters and a ``torch.amp.GradScaler`` (2^16),
    one step through ``make_train_step(grad_scaler=)`` and the engine under
    HVD_TPU_FLASH_BWD=pallas, every launch count set to 0 just before it
    and read just after: 12 f16 Hopper forwards, dq and dk/dv, nothing on
    the CUDA cores.  Its loss and gradients are held against the same
    model's on the plain attention path (HOROVOD_FLASH_ATTENTION=0) on the
    card, from the same weights and data under the same scale, then
    unscaled, by the f16 BERT-Large step's rules (``held_f16_step``).  Then
    STEPS more steps, timed, and one profiled.  -> the counts."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import init_params, params_from_jax
    from horovod_tpu_torch.models.transformer import TransformerConfig, loss_fn
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import make_train_step, synthetic_batch

    hvd.init()
    d, L, seq, batch = 1024, 12, 2048, 4
    cfg = TransformerConfig(vocab_size=8192, d_model=d, n_layers=L,
                            n_heads=d // 128, n_kv_heads=d // 128,
                            d_ff=d * 3, max_seq=seq, dtype="float16")
    t0 = time.perf_counter()
    scaler = torch.amp.GradScaler("cuda")
    scale = scaler.get_scale()
    build, shard_batch = make_train_step(
        cfg, lambda ps: torch.optim.Adam(ps, 1e-3), grad_scaler=scaler)
    params = init_params(cfg, seed=0)
    step, model, _ = build(params)
    data = shard_batch(synthetic_batch(cfg, batch, seed=0))
    # The plain path on a copy of the weights with no gradient hooks.
    ref = params_from_jax(params, cfg, next(model.parameters()).device)
    fa.reset_launch_counts()
    with env_set(HOROVOD_FLASH_ATTENTION="0"):
        loss = loss_fn(ref, data)
        (loss * scale).backward()
    want = loss.item()
    plain = {n: p.grad * (1.0 / scale) for n, p in ref.named_parameters()}
    del ref, loss
    if any(fa.launch_counts().values()):
        raise AssertionError("the plain attention path launched flash "
                             "kernels: %s" % fa.launch_counts())
    say("f16 decoder: d%d L%d %d heads of %d, seq %d, batch %d, dtype "
        "float16, f32 parameters; set-up and the plain path's loss and "
        "gradients %.1f s" % (d, L, cfg.n_heads, cfg.head_dim, seq, batch,
                              time.perf_counter() - t0))
    fa.reset_launch_counts()
    with flash_bwd_env("pallas"):
        t = time.perf_counter()
        got = step(data).item()
        torch.cuda.synchronize()
        took = time.perf_counter() - t
    counts = fa.launch_counts()
    say("launches on the f16 decoder path (1 step): %s; loss scale %g, "
        "after the step %g" % (counts, scale, scaler.get_scale()))
    if scaler.get_scale() != scale:
        raise AssertionError("f16 decoder: a scaled gradient overflowed (the "
                             "scaler backed off to %g)" % scaler.get_scale())
    check_counts(counts, {"flash_fwd_kernel": L, "flash_bwd_dq_kernel": L,
                          "flash_bwd_dkv_kernel": L})
    held_f16_step("f16 decoder", took, got, want,
                  {n: p.grad for n, p in model.named_parameters()}, plain, L)
    del plain
    times, last, frozen = timed_steps(torch, step, data, "pallas")
    med = statistics.median(times)
    say("f16 decoder: %d more steps (pallas), ms %s, median step_ms %.2f, "
        "tok/s %.1f, %d of them frozen, last loss %.6f" % (
            STEPS, ["%.2f" % x for x in times], med, batch * seq / med * 1e3,
            frozen, last))
    with flash_bwd_env("pallas"):
        profile_step(torch, step, data, med)
    hvd.shutdown()
    return counts


def train_decoder_hd256(torch):
    """The main path of the Hopper kernels at head dim 256: the decoder
    flagship (``train_flagship``'s configuration, bench.py:86-91, and its
    Adam) with n_heads = n_kv_heads = d // 256 = 4 (Gemma 7B's head
    width), bf16, one step through ``make_train_step`` and the engine under
    HVD_TPU_FLASH_BWD=pallas (12 Hopper forwards, 12 Hopper dq and 12
    Hopper dk/dv), STEPS more timed and one profiled, then one step from
    the same weights under pallas_onepass (12 Hopper forwards and 12
    Hopper one-pass backwards, their 64-row dq partial slots summed), STEPS
    more timed and one profiled; every launch count set to 0 just before
    each held step and read just after, no CUDA-core kernel.  Each held
    step's loss and gradients are held against the same model's on the
    plain attention path (HOROVOD_FLASH_ATTENTION=0) on the card, from the
    same weights and data, by the flagship steps' rules
    (``held_f16_step``); the logits take bf16 operands on both paths, so
    that only attention differs.  -> {backward choice: its step's
    counts}."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import init_params, params_from_jax
    from horovod_tpu_torch.models.transformer import TransformerConfig, loss_fn
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import make_train_step, synthetic_batch

    hvd.init()
    d, L, seq, batch = 1024, 12, 2048, 4
    cfg = TransformerConfig(vocab_size=8192, d_model=d, n_layers=L,
                            n_heads=d // 256, n_kv_heads=d // 256,
                            d_ff=d * 3, max_seq=seq, logits_dtype="bf16")
    t0 = time.perf_counter()
    build, shard_batch = make_train_step(
        cfg, lambda ps: torch.optim.Adam(ps, 1e-3))
    params = init_params(cfg, seed=0)
    step, model, _ = build(params)
    start = [p.detach().clone() for p in model.parameters()]
    data = shard_batch(synthetic_batch(cfg, batch, seed=0))
    # The plain path on a copy of the weights with no gradient hooks.
    ref = params_from_jax(params, cfg, next(model.parameters()).device)
    fa.reset_launch_counts()
    with env_set(HOROVOD_FLASH_ATTENTION="0"):
        loss = loss_fn(ref, data)
        loss.backward()
    want = loss.item()
    plain = {n: p.grad for n, p in ref.named_parameters()}
    del ref, loss
    if any(fa.launch_counts().values()):
        raise AssertionError("the plain attention path launched flash "
                             "kernels: %s" % fa.launch_counts())
    say("hd256 decoder: d%d L%d %d heads of %d, seq %d, batch %d, bf16; "
        "set-up and the plain path's loss and gradients %.1f s"
        % (d, L, cfg.n_heads, cfg.head_dim, seq, batch,
           time.perf_counter() - t0))
    expected = {"pallas": {"flash_fwd_kernel": L, "flash_bwd_dq_kernel": L,
                           "flash_bwd_dkv_kernel": L},
                "pallas_onepass": {"flash_fwd_kernel": L,
                                   "flash_bwd_onepass_kernel": L}}
    counts = {}
    for choice, want_counts in expected.items():
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), start):
                p.copy_(p0)
        fa.reset_launch_counts()
        with flash_bwd_env(choice):
            t = time.perf_counter()
            got = step(data).item()
            torch.cuda.synchronize()
            took = time.perf_counter() - t
        counts[choice] = fa.launch_counts()
        say("launches on the hd256 decoder path (1 step, %s): %s"
            % (choice, counts[choice]))
        check_counts(counts[choice], want_counts)
        held_f16_step("hd256 decoder (%s)" % choice, took, got, want,
                      {n: p.grad for n, p in model.named_parameters()},
                      plain, L)
        times, last, frozen = timed_steps(torch, step, data, choice)
        med = statistics.median(times)
        say("hd256 decoder: %d more steps (%s), ms %s, median step_ms %.2f, "
            "tok/s %.1f, %d of them frozen, last loss %.6f" % (
                STEPS, choice, ["%.2f" % x for x in times], med,
                batch * seq / med * 1e3, frozen, last))
        with flash_bwd_env(choice):
            profile_step(torch, step, data, med)
    del plain, start
    hvd.shutdown()
    return counts


def train_bert_f16(torch):
    """The f16 Hopper kernels' main path at BERT-Large:
    ``train_bert_flagship``'s configuration and recipe (AdamW(5e-5, weight
    decay 0.01), 8 groups, the fp16 wire, batch 32, seq 384) at dtype
    float16 with f32 parameters and a ``torch.amp.GradScaler`` (its default
    scale, 2^16: unscaled, most of BERT's gradients at random weights lie
    below f16's normal range).  One step through ``make_bert_train_step`` and the engine under
    HVD_TPU_FLASH_BWD=pallas_onepass (24 f16 Hopper forwards and one-pass
    backwards), then one from the same weights under pallas (24 forwards,
    dq and dk/dv), every launch count set to 0 just before each and read
    just after, nothing on the CUDA cores.  Each step's loss and gradients
    are held against the same model's on the plain attention path
    (HOROVOD_FLASH_ATTENTION=0) on the card, from the same weights and
    data under the same scale, the plain gradients rounded to f16 as the
    one-rank fp16 wire rounds the step's, then unscaled
    (``held_f16_step``).  Then STEPS more steps under each backward, timed.
    -> {backward choice: its step's counts}."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.bert import BertConfig, classification_loss
    from horovod_tpu_torch.models.convert_bert import (init_params,
                                                       params_from_jax)
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import (make_bert_train_step,
                                         synthetic_bert_batch)

    hvd.init()
    cfg = BertConfig(**{**BERT_LARGE, "dtype": "float16"})
    L = cfg.n_layers
    t0 = time.perf_counter()
    scaler = torch.amp.GradScaler("cuda")
    scale = scaler.get_scale()
    build, shard_batch = make_bert_train_step(
        cfg, lambda ps: torch.optim.AdamW(ps, lr=5e-5, weight_decay=0.01),
        objective="classification", compression=hvd.Compression.fp16,
        num_groups=8, grad_scaler=scaler)
    params = init_params(cfg, seed=0)
    step, model, _ = build(params)
    start = [p.detach().clone() for p in model.parameters()]
    data = shard_batch(synthetic_bert_batch(cfg, F16_BERT["batch"],
                                            F16_BERT["seq"], seed=0))
    # The plain path on a copy of the weights with no gradient hooks.
    ref = params_from_jax(params, cfg, next(model.parameters()).device)
    fa.reset_launch_counts()
    with env_set(HOROVOD_FLASH_ATTENTION="0"):
        loss = classification_loss(ref, data)
        (loss * scale).backward()
    want = loss.item()
    plain = {n: p.grad.half().float() * (1.0 / scale)
             for n, p in ref.named_parameters() if p.grad is not None}
    del ref, loss
    if any(fa.launch_counts().values()):
        raise AssertionError("the plain attention path launched flash "
                             "kernels: %s" % fa.launch_counts())
    say("f16 bert: BERT-Large d%d L%d %d heads of %d, batch %d, seq %d, "
        "dtype float16, f32 parameters; set-up and the plain path's loss and "
        "gradients %.1f s" % (cfg.d_model, L, cfg.n_heads, cfg.head_dim,
                              F16_BERT["batch"], F16_BERT["seq"],
                              time.perf_counter() - t0))
    expected = {"pallas_onepass": {"flash_fwd_kernel": L,
                                   "flash_bwd_onepass_kernel": L},
                "pallas": {"flash_fwd_kernel": L, "flash_bwd_dq_kernel": L,
                           "flash_bwd_dkv_kernel": L}}
    counts = {}
    for choice, want_counts in expected.items():
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), start):
                p.copy_(p0)
        fa.reset_launch_counts()
        with flash_bwd_env(choice):
            t = time.perf_counter()
            got = step(data).item()
            torch.cuda.synchronize()
            took = time.perf_counter() - t
        counts[choice] = fa.launch_counts()
        say("launches on the f16 bert path (1 step, %s): %s; loss scale %g, "
            "after the step %g" % (choice, counts[choice], scale,
                                   scaler.get_scale()))
        if scaler.get_scale() != scale:
            raise AssertionError("f16 bert: a scaled gradient overflowed (the "
                                 "scaler backed off to %g)"
                                 % scaler.get_scale())
        check_counts(counts[choice], want_counts)
        held_f16_step("f16 bert (%s)" % choice, took, got, want,
                      {n: p.grad for n, p in model.named_parameters()
                       if n in plain}, plain, L)
    del plain, start
    for choice in expected:
        times, last, frozen = timed_steps(torch, step, data, choice)
        med = statistics.median(times)
        say("f16 bert: %d more steps (%s), ms %s, median step_ms %.2f, tok/s "
            "%.1f, %d of them frozen, last loss %.6f" % (
                STEPS, choice, ["%.2f" % x for x in times], med,
                F16_BERT["batch"] * F16_BERT["seq"] / med * 1e3, frozen,
                last))
    hvd.shutdown()
    return counts


def check_average_on_card(torch):
    """The flat Average (``ops/collectives.py average``) of the same sums
    on the card and on the CPU, bit for bit, at 3, 5, 6 and 7 ranks: f32,
    f16 and bf16 (multiplied by the reciprocal in f32, as the reference's
    compiled ``r / size``) and int32 (floor division)."""
    from horovod_tpu_torch.ops import collectives
    g = torch.Generator().manual_seed(11)
    x = torch.randn(1 << 20, generator=g) * 1000
    bad = []
    for dtype in (torch.float32, torch.float16, torch.bfloat16, torch.int32):
        cpu = x.to(dtype)
        card = cpu.cuda()
        for n in (3, 5, 6, 7):
            want = collectives.average(cpu, n)
            got = collectives.average(card, n).cpu()
            off, _ = bit_mismatches(got, want)
            if off:
                bad.append("%s n=%d: %d elements" % (dtype, n, off))
    say("flat Average on the card against the CPU (2^20 elements, f32, f16, "
        "bf16, int32; n 3, 5, 6, 7): %s" % (bad or "bit for bit"))
    if bad:
        raise AssertionError("flat Average differs on the card: %s" % bad)


def bit_mismatches(got, want):
    """Elements of ``got`` whose bits differ from ``want``'s (a NaN
    matches a NaN), and the largest |got - want| among the rest."""
    import torch
    ints = {4: torch.int32, 2: torch.int16}[got.element_size()]
    both_nan = torch.isnan(got) & torch.isnan(want)
    differ = (got.view(ints) != want.view(ints)) & ~both_nan
    err = (got.float() - want.float()).abs()
    err = torch.where(both_nan, torch.zeros_like(err), err)
    return int(differ.sum().item()), float(err.max().item())


def scale_sum_inputs(n, dtype, seed):
    """a and b of n + 1 elements (so that a view offset by one exists),
    normal and normal times 3, from a seeded generator on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(n + 1, generator=g, device="cuda").to(dtype)
    b = (3 * torch.randn(n + 1, generator=g, device="cuda")).to(dtype)
    return a, b


def scale_sum_errors(ss):
    """The scale-sum kernel against its plain version at every SS_LENGTHS
    x SS_COEFS x SS_DTYPES, aligned and offset by one element, plus an inf
    and a NaN in a and coefficients read on the device; each kernel output
    lands in a NaN-poisoned block, so an unwritten element reads NaN.
    -> {case: (mismatching elements, max abs err)}."""
    import torch
    out = {}
    for dname in SS_DTYPES:
        dtype = getattr(torch, dname)
        for n in SS_LENGTHS:
            a_full, b_full = scale_sum_inputs(n, dtype, n)
            cases = [("%s n%d (%.9g, %.9g) %s" % (dname, n, al, be, view),
                      a_full[:n] if view == "aligned" else a_full[1:],
                      b_full[:n] if view == "aligned" else b_full[1:],
                      al, be)
                     for al, be in SS_COEFS
                     for view in ("aligned", "offset")]
            special = a_full[:n].clone()
            special[0] = float("inf")
            special[n // 2] = float("nan")
            coef = torch.tensor([0.75, -1.5], device="cuda")
            cases.append(("%s n%d inf+nan in a, device coefficients"
                          % (dname, n), special, b_full[:n], coef[0],
                          coef[1]))
            for label, a, b, al, be in cases:
                want = ss.scale_sum_plain(a, b, al, be)
                poison = torch.full_like(a, float("nan"))
                del poison
                got = ss.scale_sum_kernel(a, b, al, be)
                torch.cuda.synchronize()
                out[label] = bit_mismatches(got, want)
            del a_full, b_full, cases
    return out


def check_scale_sum_kernel(ss):
    """Phase 2 for the scale-sum kernel: every case of scale_sum_errors
    bit for bit, then device times at BERT-Large's word-embedding length
    for each dtype: the kernel, the plain version and, as context, the
    two-call ATen form ``torch.add(a.mul(alpha), b, alpha=beta)`` (no one
    PyTorch call computes the function).  -> {dtype: record}."""
    import torch
    errs = scale_sum_errors(ss)
    bad = {k: v for k, v in errs.items() if v[0]}
    say("scale_sum kernel: %d cases (lengths %s, coefficients %s, dtypes "
        "%s, aligned and offset by one, inf/NaN with device coefficients), "
        "%d with any bit off the plain version; max abs err %.3g"
        % (len(errs), SS_LENGTHS, SS_COEFS, SS_DTYPES, len(bad),
           max(e for _, e in errs.values())))
    if bad:
        raise AssertionError("scale_sum kernel off its plain version: %s"
                             % json.dumps(dict(list(bad.items())[:12])))
    n = SS_LENGTHS[-1]
    records = {}
    for dname in SS_DTYPES:
        dtype = getattr(torch, dname)
        a, b = (t[:n] for t in scale_sum_inputs(n, dtype, 1))
        al, be = SS_COEFS[0]
        elem = a.element_size()
        rec = {"max_abs_err": max(e for k, (_, e) in errs.items()
                                  if k.startswith(dname)),
               "ms": time_ms(lambda: ss.scale_sum_kernel(a, b, al, be),
                             reps=20),
               "plain_ms": time_ms(lambda: ss.scale_sum_plain(a, b, al, be)),
               "aten_two_call_ms": time_ms(
                   lambda: torch.add(a.mul(al), b, alpha=be)),
               "library_ms": None}
        rec["bound_ms"], rec["bound_by"] = bound(3 * n, 3 * n * elem,
                                                 peak=PEAK_F32_FLOPS)
        records[dname] = rec
        say("kernel scale_sum %s n%d: %s" % (dname, n, json.dumps(
            {k: (float("%.6g" % v) if isinstance(v, float) else v)
             for k, v in rec.items()})))
        del a, b
    return records


def adasum_mismatches(got, stacked, ss):
    """Each reduced gradient in ``got`` against ``adasum_reduce_stacked``
    of its stacked [ranks, ...] gradients with scale_sum_plain, on the
    card -> (tensors with any bit off, elements off, max abs err,
    elements)."""
    from horovod_tpu_torch.utils.adasum import adasum_reduce_stacked
    tensors = elements = 0
    worst = 0.0
    for g, s in zip(got, stacked):
        want = adasum_reduce_stacked(s, scale_sum=ss.scale_sum_plain)
        n, e = bit_mismatches(g, want)
        tensors += n > 0
        elements += n
        worst = max(worst, e)
    return tensors, elements, worst, sum(g.numel() for g in got)


def bert_shard_grads(model, shards, loss_fn, stacked=None):
    """Each shard's gradients, one after another, into rank-major stacked
    f32 buffers (allocated on the first call, for the parameters the loss
    reaches) -> (stacked {parameter: [ranks, ...]}, the shards' losses)."""
    import torch
    losses = []
    for r, shard in enumerate(shards):
        for p in model.parameters():
            p.grad = None
        loss = loss_fn(model, shard)
        loss.backward()
        losses.append(loss.detach())
        if stacked is None:
            stacked = {p: torch.empty((len(shards),) + tuple(p.shape),
                                      dtype=p.grad.dtype, device=p.device)
                       for p in model.parameters() if p.grad is not None}
        for p, s in stacked.items():
            s[r].copy_(p.grad)
    return stacked, losses


def small_bert_adasum_errors(ss):
    """The small BERT (vocab 512, d 256, 2 layers, 4 heads of 64, d_ff
    1024, seq 128, bf16) on the card: the gradients of four 2-row shards
    of a batch of 8, reduced with the kernel and with the plain version
    -> adasum_mismatches(...)."""
    import torch
    from horovod_tpu_torch.models.bert import BertConfig, classification_loss
    from horovod_tpu_torch.models.convert_bert import (init_params,
                                                       params_from_jax)
    from horovod_tpu_torch.train import synthetic_bert_batch
    from horovod_tpu_torch.utils.adasum import adasum_reduce_stacked

    cfg = BertConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                     d_ff=1024, max_seq=128)
    model = params_from_jax(init_params(cfg, seed=1), cfg, "cuda")
    batch = synthetic_bert_batch(cfg, 2 * ADASUM_RANKS, 128, seed=1)
    shards = [{k: torch.as_tensor(v[2 * r:2 * r + 2], device="cuda")
               for k, v in batch.items()} for r in range(ADASUM_RANKS)]
    with flash_bwd_env("pallas_onepass"):
        stacked, _ = bert_shard_grads(model, shards, classification_loss)
    got = [adasum_reduce_stacked(s) for s in stacked.values()]
    return adasum_mismatches(got, stacked.values(), ss)


def train_bert_adasum(torch, batch=32, seq=384):
    """BERT-Large Adasum fine-tuning, the in-process form of the JAX
    package's Adasum allreduce (``op_manager.py``): each step computes the
    gradients of ADASUM_RANKS shards of the global batch (rows r*8 ...
    r*8+7, what ``shard_batch`` gives rank r of a 4-rank world) one after
    another on the one card, stacks each parameter's gradients, reduces
    them with ``adasum_reduce_stacked`` (the scale-sum kernel; no host
    synchronisation, held by ``torch.cuda.set_sync_debug_mode("error")``),
    sets ``.grad`` and steps AdamW(5e-5, weight decay 0.01).  Classification
    loss, bf16 activations, f32 parameters, HVD_TPU_FLASH_BWD=pallas_onepass
    as set by the caller; weights and data from numpy seed 0.  The
    reduced gradients then go through the engine as one grouped Adasum
    allreduce over the one-rank NCCL world (``hvd.init()``; the world's
    ranks, where the shards are the in-process ones), inside the same
    no-synchronisation region.  Step 0's reduced gradients must equal,
    bit for bit, the same reduction with scale_sum_plain on the same
    stacked gradients.  Each step must launch the scale-sum kernel 3
    times per gradient tensor, flash_fwd and flash_bwd_onepass once per
    layer per shard, and nothing else of the port.  Returns the launch
    counts and the profiled step's device time by kernel family."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.bert import BertConfig, classification_loss
    from horovod_tpu_torch.models.convert_bert import (init_params,
                                                       params_from_jax)
    from horovod_tpu_torch.ops import batch_norm as bn
    from horovod_tpu_torch.ops import fastpath
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import scale_sum as ss
    from horovod_tpu_torch.train import synthetic_bert_batch
    from horovod_tpu_torch.utils.adasum import adasum_reduce_stacked

    hvd.init()
    cfg = BertConfig(**BERT_LARGE)
    L, per = cfg.n_layers, batch // ADASUM_RANKS
    t0 = time.perf_counter()
    model = params_from_jax(init_params(cfg, seed=0), cfg, "cuda")
    opt = torch.optim.AdamW(model.parameters(), lr=5e-5, weight_decay=0.01)
    data = synthetic_bert_batch(cfg, batch, seq, seed=0)
    shards = [{k: torch.as_tensor(v[r * per:(r + 1) * per], device="cuda")
               for k, v in data.items()} for r in range(ADASUM_RANKS)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    box = {"stacked": None}
    reduce_times = []

    def step(_data=None):
        stacked, losses = bert_shard_grads(model, shards, classification_loss,
                                           box["stacked"])
        box["stacked"] = stacked
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        a.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.profiler.record_function("adasum_reduce"):
                params = list(stacked)
                reduced = hvd.grouped_allreduce_async(
                    [adasum_reduce_stacked(stacked[p]) for p in params],
                    name="adasum", op=hvd.Adasum).wait()
                for p, g in zip(params, reduced):
                    p.grad = g
        finally:
            torch.cuda.set_sync_debug_mode("default")
        b.record()
        host_ms = (time.perf_counter() - t) * 1e3
        opt.step()
        reduce_times.append((a, b, host_ms))
        return torch.stack(losses).mean()

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    bn.reset_launch_counts()
    ss.reset_launch_counts()
    losses, times = [], []
    fp_before = fastpath.describe()
    before = engine_counts()
    for i in range(STEPS):
        t = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
        say("bert adasum step %d: mean shard loss %.6f, %.2f ms"
            % (i, losses[-1], times[-1] * 1e3))
        if i == 0:
            launched = ss.launch_counts()["scale_sum_kernel"]
            stacked = box["stacked"]
            n_bad, n_el, worst, total = adasum_mismatches(
                [p.grad for p in stacked], stacked.values(), ss)
            say("bert adasum step 0: %d gradient tensors (%d elements) "
                "reduced over %d shards; against the plain version on the "
                "same stacked gradients: %d tensors and %d elements with any "
                "bit off, max abs err %.3g" % (len(stacked), total,
                                               ADASUM_RANKS, n_bad, n_el,
                                               worst))
            if n_bad or ss.launch_counts()["scale_sum_kernel"] != launched:
                raise AssertionError("Adasum reduction off its plain "
                                     "version in %d tensors" % n_bad)
    per_step = report_engine("bert adasum", before, engine_counts(), STEPS,
                             sum(s[0].numel() * s.element_size()
                                 for s in box["stacked"].values()))
    # Adasum shares no buffer: its rounds stay negotiated.
    report_fastpath("bert adasum", fp_before, per_step, STEPS, frozen=False)
    counts = {**fa.launch_counts(), **ss.launch_counts()}
    n_grads = len(box["stacked"])
    med = statistics.median(times)
    red = [(a.elapsed_time(b), h) for a, b, h in reduce_times]
    say("bert adasum: BERT-Large d%d L%d, %d shards of %d rows, seq %d, %d "
        "parameters, %d gradient tensors; set-up %.1f s; median step_ms "
        "%.2f, tok/s %.1f, peak memory %.2f GB; reduction (CUDA events / "
        "host launch time) median %.3f / %.3f ms"
        % (cfg.d_model, L, ADASUM_RANKS, per, seq,
           sum(p.numel() for p in model.parameters()), n_grads, setup_s,
           med * 1e3,
           batch * seq / med, torch.cuda.max_memory_allocated() / 1e9,
           statistics.median(r[0] for r in red),
           statistics.median(r[1] for r in red)))
    say("launches on the bert adasum path (%d steps): %s, bn %s"
        % (STEPS, counts, bn.launch_counts()))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss: %s" % losses)
    if any(bn.launch_counts().values()):
        raise AssertionError("the Adasum path launched BN kernels: %s"
                             % bn.launch_counts())
    shard_layers = L * ADASUM_RANKS * STEPS
    check_counts(counts, {"flash_fwd_kernel": shard_layers,
                          "flash_bwd_dq_kernel": 0,
                          "flash_bwd_dkv_kernel": 0,
                          "flash_bwd_onepass_kernel": shard_layers,
                          "scale_sum_kernel": 3 * n_grads * STEPS})
    prof = profile_step(torch, step, None, med * 1e3,
                        annotation="adasum_reduce")
    hvd.shutdown()
    return counts, prof


def check_collectives_on_card(torch):
    """Each collective of the surface once on the one-rank NCCL world with
    CUDA tensors, checked against its input: Adasum allreduce (the
    identity at size 1, pre- and post-scaled), a grouped Adasum allreduce,
    allgather, reducescatter, alltoall with splits, barrier and
    allgather_object.  Proves they launch on the card; says nothing of
    transport between cards."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import scale_sum as ss

    hvd.init()
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(6, 5, generator=g, device="cuda")
    h = x.half()
    ss.reset_launch_counts()
    checks = {
        "adasum allreduce": torch.equal(
            hvd.allreduce(x, op=hvd.Adasum, prescale_factor=0.5,
                          postscale_factor=2.0), x * 0.5 * 2.0),
        "grouped adasum allreduce": all(
            torch.equal(a, b) for a, b in zip(
                hvd.grouped_allreduce([x, h], op=hvd.Adasum), [x, h])),
        "allgather": torch.equal(hvd.allgather(x), x),
        "reducescatter": torch.equal(hvd.reducescatter(x, op=hvd.Sum), x),
        "alltoall": (lambda out: torch.equal(out[0], x)
                     and out[1].tolist() == [6])(
            hvd.alltoall(x, splits=[6])),
        "barrier": hvd.barrier() is None,
        "allgather_object": hvd.allgather_object({"rank": hvd.rank()})
        == [{"rank": 0}],
    }
    torch.cuda.synchronize()
    hvd.shutdown()
    say("collectives on the card (one-rank NCCL world): %s; scale_sum "
        "launches %d (none at size 1)"
        % (json.dumps(checks), ss.launch_counts()["scale_sum_kernel"]))
    if not all(checks.values()):
        raise AssertionError("collectives on the card: %s" % checks)


# The engine phase: 64 named CUDA tensors (16 of each dtype, the five
# reduce ops in turn, ragged lengths up to 128K elements) under a fusion
# threshold of 1 MiB, so that they fuse into many groups.
ENGINE_THRESHOLD = 1 << 20
ENGINE_DTYPES = ("float32", "bfloat16", "float16", "int32")
ENGINE_OPS = ("Sum", "Average", "Min", "Max", "Product")
ENGINE_TENSORS = 64


@contextlib.contextmanager
def env_set(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def engine_named_tensors(torch):
    """The phase's named tensors and their wanted results at size 1: the
    input times the pre-scale, then the post-scale, each cast to the
    tensor's dtype first (Average divides by one)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    out = []
    for i in range(ENGINE_TENSORS):
        dtype = getattr(torch, ENGINE_DTYPES[i % 4])
        n = 16384 * (1 + i % 8) + i
        if dtype == torch.int32:
            x = torch.randint(-50, 50, (n,), generator=g, device="cuda",
                              dtype=dtype)
            pre, post = 2, 3
        else:
            x = (torch.rand(n, generator=g, device="cuda") + 0.5).to(dtype)
            pre, post = 0.3, 1.7
        cast = lambda f: torch.tensor(f, device="cuda").to(dtype)
        out.append(("engine.%02d" % i, x, ENGINE_OPS[i % 5], pre, post,
                    x * cast(pre) * cast(post)))
    return out


def engine_waits_on_the_enqueue(torch, hvd):
    """Prints the seconds from an allreduce's enqueue to its result on
    the device, while a sleep kernel of about a second, queued on the caller's stream
    right after the enqueue, still runs; raises if the result waited for
    the sleep.  The executor's stream waits on an event recorded at the
    enqueue, so work the caller queues later (the rest of a backward) does
    not hold a reduction back."""
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    h = hvd.allreduce_async(x, name="engine.after_enqueue", op=hvd.Sum)
    torch.cuda._sleep(1 << 31)
    while not h.poll():
        time.sleep(1e-4)
    done = h._entries[0].out_token  # the result's event on the executor
    while not done.query() and time.perf_counter() - t < 10:
        time.sleep(1e-4)
    secs = time.perf_counter() - t
    sleeping = not torch.cuda.current_stream().query()
    ok = torch.equal(h.wait(), x)
    torch.cuda.synchronize()
    say("engine on the card: an allreduce's result on the device %.4f s "
        "after its enqueue, the sleep queued after the enqueue %s"
        % (secs, "still running" if sleeping else "over"))
    if not (done.query() and sleeping and ok):
        raise AssertionError("engine on the card: the executor waited for "
                             "work queued after the enqueue")


def check_engine_on_card(torch):
    """The negotiating engine on the one-rank NCCL world, with CUDA
    tensors: (1) the 64 named tensors under HVD_TPU_FUSION_THRESHOLD=1 MiB,
    enqueued at once, each result bit for bit against its wanted value,
    in more than one fused group, no all_reduce buffer above the
    threshold, and one more allreduce whose result does not wait for work
    queued after its enqueue (``engine_waits_on_the_enqueue``); (2) under
    HOROVOD_TIMELINE, one step of the decoder at the
    flagship's width (2 layers) whose backward and
    ``DistributedOptimizer.synchronize()`` run under
    ``torch.cuda.set_sync_debug_mode("error")``, its gradients bit for bit
    equal to the same backward's local gradients (Average at size 1),
    ``hvd.join()`` returning 0, and the trace parsing and naming every
    gradient's negotiation and execution."""
    import horovod_tpu_torch as hvd
    import torch.distributed as dist
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      loss_fn)
    from horovod_tpu_torch.train import make_train_step, synthetic_batch

    with env_set(HVD_TPU_FUSION_THRESHOLD=str(ENGINE_THRESHOLD)):
        hvd.init()
    cases = engine_named_tensors(torch)
    buffers, all_reduce = [], dist.all_reduce

    def record(tensor, *args, **kwargs):
        buffers.append(tensor.numel() * tensor.element_size())
        return all_reduce(tensor, *args, **kwargs)

    before = engine_counts()
    dist.all_reduce = record
    try:
        handles = [hvd.allreduce_async(x, name=name, op=op,
                                       prescale_factor=pre,
                                       postscale_factor=post)
                   for name, x, op, pre, post, _ in cases]
        got = [h.wait() for h in handles]
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
    d = {k: v - before[k] for k, v in engine_counts().items()}
    engine_waits_on_the_enqueue(torch, hvd)
    hvd.shutdown()
    bad = [name for (name, _, _, _, _, want), g in zip(cases, got)
           if g.dtype != want.dtype or not torch.equal(g, want)]
    say("engine on the card: %d named tensors (%s), threshold %d bytes: %d "
        "cycles, %d executed groups (%d all_reduce buffers, largest %d "
        "bytes), %d tensors in fused groups; %d results off their inputs "
        "pre- and post-scaled, bit for bit%s" % (
            len(cases), "/".join(ENGINE_DTYPES), ENGINE_THRESHOLD,
            d["cycles"], d["groups"], len(buffers), max(buffers),
            d["fused_tensors"], len(bad), (": %s" % bad) if bad else ""))
    if bad or len(buffers) < 2 or len(buffers) != d["groups"] \
            or max(buffers) > ENGINE_THRESHOLD or d["fused_tensors"] < 2:
        raise AssertionError("engine on the card: fusion or results off")

    trace_path = _build.build_dir().parent / "engine_timeline.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    with env_set(HOROVOD_TIMELINE=str(trace_path)):
        hvd.init()
    cfg = TransformerConfig(vocab_size=8192, d_model=1024, n_layers=2,
                            n_heads=8, n_kv_heads=8, d_ff=3072, max_seq=2048)
    build, shard_batch = make_train_step(
        cfg, lambda params: torch.optim.Adam(params, 1e-3))
    step, model, opt = build(init_params(cfg, seed=0))
    data = shard_batch(synthetic_batch(cfg, 4, seed=0))
    step(data)
    local = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p: local.__setitem__(p, p.grad.clone()))
        for p in model.parameters()]
    opt.zero_grad()
    loss = loss_fn(model, data)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss.backward()
        opt.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    off = [n for n, p in model.named_parameters()
           if not torch.equal(p.grad, local[p])]
    last = hvd.join()
    hvd.shutdown()
    records = json.loads(trace_path.read_text())
    phases = {}
    for rec in records:
        if "name" in rec:
            phases.setdefault(rec["tid"], set()).add(rec["name"])
    names = ["allreduce." + n for n, _ in model.named_parameters()]
    untraced = [n for n in names if "NEGOTIATE_ALLREDUCE" not in
                phases.get(n, ()) or not phases[n] & {
                    "EXEC_ALLREDUCE", "EXEC_FUSED_ALLREDUCE"}]
    say("engine on the card: decoder d%d L%d step, backward and "
        "synchronize() under sync debug mode 'error': %d of %d gradients "
        "off the local ones bit for bit; join() returned %d; timeline %d "
        "records, %d of %d gradients without a negotiate and an execute "
        "record" % (cfg.d_model, cfg.n_layers, len(off), len(names), last,
                    len(records), len(untraced),
                    len(names)))
    if off or last != 0 or untraced:
        raise AssertionError("engine on the card: gradients %s, join %d, "
                             "untraced %s" % (off[:4], last, untraced[:4]))


# The fast-path phase warms in 3 rounds (HOROVOD_FAST_PATH_WARM_CYCLES).
FP_WARM = 3


def fastpath_decoder_grads(torch, on):
    """One d1024 L2 decoder step (SGD at lr 0, so every step sees the
    initial weights) after ``FP_WARM + 2`` steps, with the fast path on
    (the step then runs frozen) or off: its backward and
    ``synchronize()`` under ``set_sync_debug_mode("error")``.  Returns
    the reduced gradients, the names of those that differ from the
    step's local gradients bit for bit, and the frozen rounds and
    negotiated cycles of the step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import metrics
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      loss_fn)
    from horovod_tpu_torch.train import make_train_step, synthetic_batch

    with env_set(HOROVOD_FAST_PATH="1" if on else "0",
                 HOROVOD_FAST_PATH_WARM_CYCLES=str(FP_WARM)):
        hvd.init()
    cfg = TransformerConfig(vocab_size=8192, d_model=1024, n_layers=2,
                            n_heads=8, n_kv_heads=8, d_ff=3072, max_seq=2048)
    build, shard_batch = make_train_step(
        cfg, lambda params: torch.optim.SGD(params, lr=0.0))
    step, model, opt = build(init_params(cfg, seed=0))
    data = shard_batch(synthetic_batch(cfg, 4, seed=0))
    for _ in range(FP_WARM + 2):
        step(data)
    local = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p: local.__setitem__(p, p.grad.clone()))
        for p in model.parameters()]
    opt.zero_grad()
    loss = loss_fn(model, data)
    torch.cuda.synchronize()
    frozen0 = metrics.series_sum("fastpath_frozen_cycles_total")
    cycles0 = metrics.series_sum("engine_cycles_total")
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss.backward()
        opt.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    frozen = metrics.series_sum("fastpath_frozen_cycles_total") - frozen0
    cycles = metrics.series_sum("engine_cycles_total") - cycles0
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    off = [n for n, p in model.named_parameters()
           if not torch.equal(p.grad, local[p])]
    hvd.shutdown()
    return grads, off, frozen, cycles


def fastpath_named_rounds(torch, hvd, cases, rounds, change=None):
    """``rounds`` rounds of the engine phase's named tensors, each
    enqueued at once and then waited for (``change(x, want)`` may give
    the first tensor another shape in every round); the names of the
    results off their wanted values bit for bit, and the frozen rounds
    of the last round."""
    from horovod_tpu_torch.common import metrics
    bad = set()
    for _ in range(rounds):
        frozen0 = metrics.series_sum("fastpath_frozen_cycles_total")
        todo = list(cases)
        if change is not None:
            name, x, op, pre, post, want = todo[0]
            todo[0] = (name, x[:-1], op, pre, post, want[:-1])
        handles = [hvd.allreduce_async(x, name=name, op=op,
                                       prescale_factor=pre,
                                       postscale_factor=post)
                   for name, x, op, pre, post, _ in todo]
        got = [h.wait() for h in handles]
        bad.update(name for (name, _, _, _, _, want), g in zip(todo, got)
                   if g.dtype != want.dtype or not torch.equal(g, want))
    torch.cuda.synchronize()
    return sorted(bad), metrics.series_sum(
        "fastpath_frozen_cycles_total") - frozen0


def check_fastpath_on_card(torch):
    """The fast path on the one-rank NCCL world (warm in FP_WARM rounds):
    (1) the d1024 L2 decoder's reduced gradients, frozen and with the fast
    path off, bit for bit between the two and against the local ones, no
    host synchronisation inside the step; (2) the engine phase's 64 named
    tensors under a 1 MiB threshold frozen, then the first changing its
    shape (a thaw, reason shape), frozen again and ``join()`` (a thaw,
    reason membership), every result bit for bit."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fastpath

    on, off_on, frozen_on, cycles_on = fastpath_decoder_grads(torch, True)
    off, off_off, frozen_off, cycles_off = fastpath_decoder_grads(torch,
                                                                  False)
    differ = [n for n in on if not torch.equal(on[n], off[n])]
    say("fast path on the card: decoder d1024 L2 step frozen (%d frozen "
        "rounds, %d negotiated cycles) against HOROVOD_FAST_PATH=0 (%d, %d): "
        "%d of %d reduced gradients differ bit for bit; against the local "
        "ones %d frozen, %d negotiated; backward and synchronize() under "
        "sync debug mode 'error'" % (frozen_on, cycles_on, frozen_off,
                                     cycles_off, len(differ), len(on),
                                     len(off_on), len(off_off)))
    if differ or off_on or off_off or (frozen_on, cycles_on) != (1, 0) \
            or frozen_off:
        raise AssertionError("fast path on the card: decoder gradients "
                             "%s, local %s / %s" % (differ[:4], off_on[:4],
                                                    off_off[:4]))

    with env_set(HVD_TPU_FUSION_THRESHOLD=str(ENGINE_THRESHOLD),
                 HOROVOD_FAST_PATH_WARM_CYCLES=str(FP_WARM)):
        hvd.init()
    cases = engine_named_tensors(torch)
    thaws0 = fastpath.describe()["thaws_by_reason"]
    bad, frozen = fastpath_named_rounds(torch, hvd, cases, FP_WARM + 2)
    plane = fastpath.describe()["planes"]["engine"]
    bad_shape, frozen_shape = fastpath_named_rounds(torch, hvd, cases, 1,
                                                    change=True)
    bad_again, frozen_again = fastpath_named_rounds(torch, hvd, cases,
                                                    FP_WARM + 2)
    last = hvd.join()
    after = fastpath.describe()
    hvd.shutdown()
    thaws = {r: n - thaws0.get(r, 0.0)
             for r, n in after["thaws_by_reason"].items()
             if n != thaws0.get(r, 0.0)}
    say("fast path on the card: %d named tensors frozen in %d buckets "
        "(last warm round frozen %d), results off bit for bit %s; a shape "
        "change: frozen %d, off %s; frozen again %d, off %s; join() "
        "returned %d; thaws by reason %s" % (
            len(cases), plane["buckets"], frozen, bad, frozen_shape,
            bad_shape, frozen_again, bad_again, last, json.dumps(thaws)))
    if bad or bad_shape or bad_again or frozen != 1 or frozen_shape or \
            frozen_again != 1 or last != 0 or \
            thaws != {"shape": 1.0, "membership": 1.0}:
        raise AssertionError("fast path on the card: named tensors off")
    return on


# The codec, leg and gate phases: the cross-node wire codecs, the five
# hierarchical legs on one-member groups, and the gate on one card.
DECODER_BUCKETS, DECODER_GRADS = 10, 171992064
CODEC_STEPS = 3
LEG_CODECS = ("none", "fp16", "bf16", "int8", "fp8")
LEGS = ("allreduce", "reducescatter", "allgather", "broadcast", "alltoall")
# e4m3's overflow edge and what the reference's cast gives each value:
# NaN (0x7F, with the sign 0xFF) past +-464 and for infinities, where
# torch's vectorised CPU cast saturates at +-448 (0x7E, 0xFE).
FP8_EDGE = (464.0, 464.01, 465.0, 1e6, -464.0, -464.01, -465.0, -1e6,
            math.inf, -math.inf, math.nan, 448.0, -448.0, 0.0, -0.0, 1e-10,
            2.0 ** -10, 240.0, 1.0 / 3)
FP8_EDGE_BYTES = (0x7E, 0x7F, 0x7F, 0x7F, 0xFE, 0xFF, 0xFF, 0xFF, 0x7F, 0xFF,
                  0x7F, 0x7E, 0xFE, 0x00, 0x80, 0x00, 0x00, 0x77, 0x2B)


def codec_edge_mismatches(device="cuda"):
    """The fp8 edge values whose plain-cast byte on ``device`` is not the
    reference's: [(value, byte got, byte wanted)]."""
    import torch
    from horovod_tpu_torch import compression as pc
    x = torch.tensor(FP8_EDGE, dtype=torch.float32, device=device)
    got = pc.FP8Compressor.compress(x)[0].view(torch.uint8).tolist()
    return [(v, g, w) for v, g, w in zip(FP8_EDGE, got, FP8_EDGE_BYTES)
            if g != w]


def bytes_equal(a, b) -> bool:
    """Bit for bit (a NaN matches only the same NaN bits)."""
    import torch
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def run_codecs(buckets):
    """Every codec on every bucket, and ErrorFeedback over CODEC_STEPS
    steps: {name: [tensors]} (wires, scales, dequantized values, the
    residuals after the last step)."""
    from horovod_tpu_torch import compression as pc
    out = {}
    for name, codec in (("int8", pc.Int8Quantizer),
                        ("fp8", pc.ScaledFP8Quantizer)):
        enc = [codec.compress(b) for b in buckets]
        out[name + " wire"] = [w for w, _ in enc]
        out[name + " scale"] = [c[0] for _, c in enc]
        out[name + " back"] = [codec.decompress(w, c) for w, c in enc]
        ef = pc.ErrorFeedback(codec, max_buckets=len(buckets))
        for step in range(CODEC_STEPS):
            enc = [ef.compress(b, bucket=i) for i, b in enumerate(buckets)]
            out["ef %s wire %d" % (name, step)] = [w for w, _ in enc]
            out["ef %s scale %d" % (name, step)] = [c[0] for _, c in enc]
        out["ef %s residual" % name] = [ef._residuals[i]
                                        for i in range(len(buckets))]
    out["fp8 cast"] = [pc.FP8Compressor.compress(b)[0] for b in buckets]
    for name in ("fp16", "bf16"):
        out[name] = [getattr(pc.Compression, name).compress(b)[0]
                     for b in buckets]
    return out


def check_codecs_on_card(torch, buckets):
    """The codec phase: every codec, and ErrorFeedback over CODEC_STEPS
    steps, on the decoder's frozen gradient buckets on the card under
    ``set_sync_debug_mode("error")``, bit for bit against the same
    functions on their CPU copies; the fp8 edge values on the card against
    the reference's bytes; each codec's time against its byte bound."""
    from horovod_tpu_torch import compression as pc
    n = sum(b.numel() for b in buckets)
    cpu = [b.cpu() for b in buckets]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run_codecs(buckets)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t = time.perf_counter()
    want = run_codecs(cpu)
    cpu_s = time.perf_counter() - t
    n_out = len(want)
    off = [name for name in want
           if not all(bytes_equal(g.cpu(), w)
                      for g, w in zip(got[name], want[name]))]
    del got, want
    edge = codec_edge_mismatches()
    saturated = torch.tensor(FP8_EDGE, device="cuda").to(
        torch.float8_e4m3fn).view(torch.uint8)[1].item()
    # Time: each codec on every bucket, one time_ms call a bucket, summed
    # (the calls on all ten buckets would queue more launches behind the
    # sleep than the device's launch queue holds).
    ef = {name: pc.ErrorFeedback(codec, max_buckets=len(buckets))
          for name, codec in (("int8", pc.Int8Quantizer),
                              ("fp8", pc.ScaledFP8Quantizer))}
    enc = [pc.Int8Quantizer.compress(b) for b in buckets]
    # (label, call on bucket i, bytes read and written per element)
    cases = (
        ("int8 encode", lambda i: pc.Int8Quantizer.compress(buckets[i]), 5),
        ("int8 decode", lambda i: pc.Int8Quantizer.decompress(*enc[i]), 5),
        ("fp8 (scaled) encode",
         lambda i: pc.ScaledFP8Quantizer.compress(buckets[i]), 5),
        ("fp8 plain cast", lambda i: pc.FP8Compressor.compress(buckets[i]),
         5),
        ("error feedback int8 encode",
         lambda i: ef["int8"].compress(buckets[i], bucket=i), 13),
        ("error feedback fp8 encode",
         lambda i: ef["fp8"].compress(buckets[i], bucket=i), 13))
    times = {}
    for label, fn, per_elem in cases:
        times[label] = (sum(time_ms(lambda: fn(i), reps=5, warmup=2)
                            for i in range(len(buckets))),
                        bound(0, per_elem * n)[0], per_elem)
    del enc, ef
    torch.cuda.empty_cache()
    say("codecs on the card: %d buckets, %d f32 elements; %d outputs "
        "(wires, scales, dequantized, error feedback over %d steps and its "
        "residuals) bit for bit against the CPU (%.1f s there), off: %s; "
        "fp8 edge values off the reference's bytes: %s (torch's own cast "
        "on the card gives 0x%02X for 464.01); run under sync debug mode "
        "'error'"
        % (len(buckets), n, n_out, CODEC_STEPS, cpu_s, off, edge,
           saturated))
    for label, (ms, bound_ms, per_elem) in times.items():
        say("codec time: %s, %d f32 elements in %d buckets: %.6g ms "
            "(time_ms a bucket, summed), byte bound %.6g ms (%d bytes an element read and "
            "written, at %.3g B/s), %.1f%% of it"
            % (label, n, len(buckets), ms, bound_ms, per_elem, PEAK_BYTES,
               100 * bound_ms / ms))
    if off or edge:
        raise AssertionError("codecs on the card: off the CPU %s, fp8 edge "
                             "%s" % (off, edge))


def run_leg(h, leg, tensors, first=0):
    """One leg of ``h`` on each tensor, the i-th's residuals named
    ``bucket<first + i>`` (an allreduce twice, so that both residuals
    count): the outputs."""
    c = h.wire_codec(tensors[0].dtype, "Sum")
    out = []
    for i, t in enumerate(tensors, first):
        if leg == "allreduce":
            for _ in range(2):
                r = h.allreduce(t, "Sum", 1.0, 1.0, c, "bucket%d" % i)
        elif leg == "reducescatter":
            r = h.reducescatter(t, "Sum", c, "bucket%d" % i)
        elif leg == "allgather":
            r = h.allgather(t, [t.shape[0]], c)
        elif leg == "broadcast":
            r = h.broadcast(t, 0, c)
        else:
            r = h.alltoall(t, [t.shape[0]], c)
        out.append(r)
    return out


def check_legs_on_card(torch, buckets):
    """The leg phase: each of the five hierarchical legs called directly
    with one-member NCCL local and cross groups, under every codec, on the
    decoder's buckets, under ``set_sync_debug_mode("error")``; against the
    same calls with one-member gloo groups on the buckets' CPU copies, bit
    for bit (after a first run that starts the communicators); each leg's
    device time by ``time_ms``, whose sleep kernel a leg that waited on
    the device would not finish queueing behind."""
    import horovod_tpu_torch as hvd
    import torch.distributed as dist
    from horovod_tpu_torch.ops import multihost as mh

    hvd.init()
    nccl = (dist.new_group([0]), dist.new_group([0]))
    gloo = (dist.new_group([0], backend="gloo"),
            dist.new_group([0], backend="gloo"))
    cpu = [b.cpu() for b in buckets]
    n = sum(b.numel() for b in buckets)
    off, times = [], {}
    for name in LEG_CODECS:
        codec = mh._resolve_codec(name)

        def fresh(groups=nccl):
            # A new plane: no residual carried from another run.
            return mh.Hierarchy(*groups, [[0]], 0, 0, codec=codec,
                                mode="on")

        card, host = fresh(), fresh(gloo)
        for leg in LEGS:
            run_leg(fresh(), leg, buckets)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = run_leg(card, leg, buckets)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = run_leg(host, leg, cpu)
            if not all(bytes_equal(g.cpu(), w) for g, w in zip(got, want)):
                off.append("%s %s" % (name, leg))
            del got, want
            timer = fresh()
            times[(name, leg)] = sum(
                time_ms(lambda: run_leg(timer, leg, [b], i), reps=2,
                        warmup=2) for i, b in enumerate(buckets))
        torch.cuda.empty_cache()
    hvd.shutdown()
    say("legs on the card: 5 legs x %d codecs on one-member NCCL groups "
        "against one-member gloo groups on the CPU, %d buckets of %d f32 "
        "elements, bit for bit; off: %s; run under sync debug mode 'error'"
        % (len(LEG_CODECS), len(buckets), n, off))
    for (name, leg), ms in times.items():
        twice = ", allreduce twice" if leg == "allreduce" else ""
        say("leg time: %s under %s, %d f32 elements in %d buckets: %.6g ms "
            "(time_ms a bucket, summed%s)"
            % (leg, name, n, len(buckets), ms, twice))
    if off:
        raise AssertionError("legs on the card: %s differ from the CPU"
                             % off)


def check_gate_on_card(torch, frozen_grads):
    """The gate phase: the fast-path phase's decoder steps again with
    ``HOROVOD_CROSS_HOST_COMPRESSION=int8`` on the one-rank world (one
    local rank: no hierarchy): every collective flat, none compressed,
    the one warning logged, and the step's reduced gradients bit for bit
    against the same step without the setting."""
    import logging
    from horovod_tpu_torch.common import metrics
    caught = []

    class Catch(logging.Handler):
        def emit(self, record):
            caught.append(record.getMessage())

    handler = Catch(level=logging.WARNING)
    log = logging.getLogger("horovod_tpu_torch")
    log.addHandler(handler)
    def counts():
        return {"hier": metrics.series_sum("mh_collective_path_total",
                                           path="hier"),
                "flat": metrics.series_sum("mh_collective_path_total",
                                           path="flat"),
                "compressed": metrics.series_sum(
                    "mh_compressed_collectives_total")}

    before = counts()
    try:
        with env_set(HOROVOD_CROSS_HOST_COMPRESSION="int8"):
            grads, off_local, frozen, cycles = fastpath_decoder_grads(
                torch, True)
    finally:
        log.removeHandler(handler)
    moved = {k: v - before[k] for k, v in counts().items()}
    warned = [w for w in caught if "HOROVOD_CROSS_HOST_COMPRESSION=int8" in w]
    differ = [k for k in frozen_grads
              if not bytes_equal(grads[k], frozen_grads[k])]
    say("gate on the card: decoder d1024 L2 steps under "
        "HOROVOD_CROSS_HOST_COMPRESSION=int8 on one rank: %s; warnings %s; "
        "%d of %d reduced gradients differ bit for bit from the step without "
        "the setting (%d frozen rounds, %d negotiated cycles)"
        % (json.dumps(moved), warned, len(differ), len(grads), frozen,
           cycles))
    if (differ or off_local or len(warned) != 1 or moved["hier"]
            or not moved["flat"] or moved["compressed"]):
        raise AssertionError("gate on the card: %s, warnings %s, differ %s"
                             % (moved, warned, differ[:4]))


GUARD_DEMOTE_THRESHOLD = 2


def check_guard_on_card(torch, buckets):
    """The leg guard on the card: the decoder's frozen gradient buckets
    through ``mh.allreduce`` (the engine's entry) with the global set's
    hierarchy on one-member NCCL groups under int8 and error feedback
    (``HOROVOD_LEG_RETRY_BACKOFF=0``): one dropped attempt gives outputs
    and residuals bit for bit the unarmed call's; an unbounded drop the
    flat result, bit for bit, every residual untouched;
    ``GUARD_DEMOTE_THRESHOLD`` exhaustions of one size class and
    ``check_degraded_routes()`` (a one-rank world decides locally) route
    its next call flat with no leg attempt, and a re-probe routes it back.
    Host ms of each run (10 buckets, synchronised) are printed."""
    import horovod_tpu_torch as hvd
    import torch.distributed as dist
    from horovod_tpu_torch.common import faultline, metrics, resilience
    from horovod_tpu_torch.common.process_sets import global_process_set as ps
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import multihost as mh

    hvd.init()
    groups = (dist.new_group([0]), dist.new_group([0]))
    codec = mh._resolve_codec("int8")

    def counts():
        return [metrics.series_sum("mh_collective_path_total", op="allreduce",
                                   path=p) for p in ("hier", "flat")] + [
            metrics.series_sum("fault_injections_total"),
            metrics.series_sum("mh_leg_retries_total")]

    def run(fault, which=None):
        """Each bucket (or bucket ``which``) once through mh.allreduce on
        a fresh plane -> (outputs, residuals, ms, count deltas)."""
        h = ps.hierarchy = mh.Hierarchy(*groups, [[0]], 0, 0, codec=codec,
                                        mode="on")
        pick = (list(enumerate(buckets)) if which is None
                else [(which, buckets[which])])
        with env_set(HVD_TPU_FAULT=fault) if fault else \
                contextlib.nullcontext():
            faultline.reset()
            before = counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs = [mh.allreduce([b], "Sum", 1.0, 1.0, ps, "bucket%d" % i)[0]
                    for i, b in pick]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        faultline.reset()
        res = [v for lru in (h._res2, h.ef._residuals) for v in lru.values()]
        return outs, res, ms, [a - b for a, b in zip(counts(), before)]

    off = []
    with env_set(HOROVOD_LEG_RETRY_BACKOFF="0",
                 HOROVOD_LEG_DEMOTE_THRESHOLD=str(GUARD_DEMOTE_THRESHOLD),
                 HOROVOD_LEG_REPROBE_SECS="1000"):
        run(None)  # the groups' communicators start on first use
        clean, clean_res, clean_ms, clean_n = run(None)
        got, got_res, retry_ms, retry_n = run("mh.leg.drop:drop@times=1")
        if not (all(bytes_equal(a, b) for a, b in zip(got, clean))
                and len(got_res) == len(clean_res)
                and all(bytes_equal(a, b) for a, b in zip(got_res, clean_res))
                and retry_n == [len(buckets), 0, 1, 1]):
            off.append("one dropped attempt: %s" % retry_n)
        del got, got_res, clean_res
        flat = [C.allreduce([b], "Sum", 1.0, 1.0, 1, ps.group)[0]
                for b in buckets]
        got, got_res, degraded_ms, degraded_n = run("mh.leg.drop:drop")
        if not (all(bytes_equal(a, b) for a, b in zip(got, flat))
                and not got_res
                and degraded_n == [0, len(buckets), 3 * len(buckets),
                                   2 * len(buckets)]):
            off.append("unbounded drop: %s" % degraded_n)
        del got
        resilience.reset()
        for _ in range(GUARD_DEMOTE_THRESHOLD):
            run("mh.leg.drop:drop", 0)
        verdict = resilience.check_degraded_routes()
        got, _, demoted_ms, demoted_n = run("mh.leg.drop:drop", 0)
        cls = mh._size_class(buckets[0].numel() * 4)
        if not (verdict and verdict["action"] == "demote"
                and verdict["size_class"] == cls
                and bytes_equal(got[0], flat[0])
                and demoted_n == [0, 1, 0, 0]):
            off.append("demotion: %s, %s" % (verdict, demoted_n))
        os.environ["HOROVOD_LEG_REPROBE_SECS"] = "0.1"
        time.sleep(0.2)
        promoted = resilience.check_degraded_routes()
        got, _, _, promoted_n = run(None, 0)
        if not (promoted and promoted["action"] == "promote"
                and bytes_equal(got[0], clean[0])
                and promoted_n == [1, 0, 0, 0]):
            off.append("re-probe: %s, %s" % (promoted, promoted_n))
        del got, flat, clean
    ps.hierarchy = None
    hvd.shutdown()
    say("guard on the card: %d decoder buckets (%d f32) through mh.allreduce, "
        "int8 with error feedback on one-member NCCL groups: unarmed %.6g ms, "
        "one dropped attempt %.6g ms (bit for bit), unbounded drop %.6g ms "
        "(3 attempts and the flat call a bucket; the flat result bit for "
        "bit); bucket 0 (class %s) demoted after %d exhaustions: %s, then "
        "flat in %.6g ms with %s, re-probe %s: %s; host ms, synchronised, "
        "HOROVOD_LEG_RETRY_BACKOFF=0; off: %s"
        % (len(buckets), sum(b.numel() for b in buckets), clean_ms, retry_ms,
           degraded_ms, cls, GUARD_DEMOTE_THRESHOLD, json.dumps(verdict),
           demoted_ms, demoted_n, json.dumps(promoted), promoted_n, off))
    if off:
        raise AssertionError("guard on the card: %s" % off)


DEADLINE_RAISE_S = 5.0


def check_deadline_on_card(torch):
    """The deadline on the card, last (its world is poisoned): a one-rank
    engine under ``HOROVOD_COLLECTIVE_TIMEOUT_SECS=1`` and
    ``mh.deadline.wedge:drop``; an allreduce of a CUDA tensor must raise
    ``CollectiveDeadlineExceeded`` within DEADLINE_RAISE_S, the next
    enqueue must raise, and ``shutdown()`` must return."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics, faultline

    with env_set(HOROVOD_COLLECTIVE_TIMEOUT_SECS="1",
                 HVD_TPU_FAULT="mh.deadline.wedge:drop"):
        faultline.reset()
        hvd.init()
        eng = basics.engine()
        x = torch.ones(1 << 20, device="cuda")
        t0 = time.monotonic()
        raised = nxt = None
        try:
            hvd.allreduce(x, name="wedged")
        except hvd.HorovodInternalError as exc:
            raised = exc
        t_raise = time.monotonic()
        rec = next(iter(eng._watched.values()), None)
        try:
            hvd.allreduce(x, name="after")
        except hvd.HorovodInternalError as exc:
            nxt = exc
        t1 = time.monotonic()
        hvd.shutdown()
        shutdown_s = time.monotonic() - t1
    faultline.reset()
    expiry = (t_raise - rec["start"] - rec["deadline_secs"]
              if rec is not None else float("nan"))
    say("deadline on the card: allreduce of %d f32 withheld; raised %s after "
        "%.3f s (%.3f s after its deadline expired; the watchdog ticks "
        "every second), next enqueue raised %s, shutdown() returned in %.3f s"
        % (x.numel(), type(raised).__name__, t_raise - t0, expiry,
           type(nxt).__name__, shutdown_s))
    if not (isinstance(raised, hvd.CollectiveDeadlineExceeded)
            and t_raise - t0 <= DEADLINE_RAISE_S
            and isinstance(nxt, hvd.CollectiveDeadlineExceeded)
            and shutdown_s <= DEADLINE_RAISE_S):
        raise AssertionError("deadline on the card: %r, %r" % (raised, nxt))


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import batch_norm as bn
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import scale_sum as ss

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
    flash = check_flash_kernels(fa)
    flash16 = check_flash_kernels(fa, "float16")
    simt = {dtype: check_flash_kernels(fa, dtype, "simt")
            for dtype in SIMT_DTYPES}
    f32hopper = check_flash_kernels(fa, "float32", "hopper_f32")
    bn_err, bn_shape_times = check_bn_kernels(bn)
    ss_records = check_scale_sum_kernel(ss)

    # -- 3: small models against the f32 CPU reference
    model_counts = check_model()
    check_resnet_model()
    check_bert_model()
    f32_counts = train_f32_decoder(torch)

    # -- 4: the main paths, each with every count set to 0 just before
    with flash_bwd_env("pallas"):
        counts, buckets = train_flagship(torch)
    torch.cuda.empty_cache()
    simt_counts = train_f32_flagship(torch)
    torch.cuda.empty_cache()
    bn_counts, shapes, prof = train_resnet_flagship(torch)
    for name in BN_KERNELS:
        step_bound = sum(n * bound(*bn_work(m, c, r)[name],
                                   peak=PEAK_F32_FLOPS)[0]
                         for (m, c, _, r), n in shapes.items())
        say("bn kernel %s, one ResNet-50 step's %d NormActs (b128, 224^2): "
            "device %s ms (profile), bound %.6g ms" % (
                name, sum(shapes.values()),
                "%.6g" % prof[name] if name in prof else "not measured",
                step_bound))
    torch.cuda.empty_cache()
    with flash_bwd_env("pallas_onepass"):
        bert_counts, bert_prof = train_bert_flagship(torch)
    for name in ("flash_fwd", "flash_bwd_onepass"):
        say("%s, one BERT-Large step's 24 layers: device %s ms (profile), "
            "bound %.6g ms" % (
                name, "%.6g" % bert_prof[name] if name in bert_prof
                else "not measured",
                24 * flash[BERT_SHAPE][name]["bound_ms"]))
    torch.cuda.empty_cache()
    f16_dec_counts = train_decoder_f16(torch)
    torch.cuda.empty_cache()
    f16_counts = train_bert_f16(torch)
    torch.cuda.empty_cache()
    hd256_counts = train_decoder_hd256(torch)
    hd256_fwd = sum(c["flash_fwd_kernel"] for c in hd256_counts.values())
    torch.cuda.empty_cache()
    with flash_bwd_env("pallas_onepass"):
        adasum_counts, adasum_prof = train_bert_adasum(torch)
    say("scale_sum, one BERT-Large Adasum step's %d launches: device %s ms "
        "(profile)" % (adasum_counts["scale_sum_kernel"] // STEPS,
                       "%.6g" % adasum_prof["scale_sum"]
                       if "scale_sum" in adasum_prof else "not measured"))
    torch.cuda.empty_cache()
    check_collectives_on_card(torch)
    check_average_on_card(torch)
    check_engine_on_card(torch)
    frozen_grads = check_fastpath_on_card(torch)
    check_codecs_on_card(torch, buckets)
    check_legs_on_card(torch, buckets)
    check_guard_on_card(torch, buckets)
    del buckets
    torch.cuda.empty_cache()
    check_gate_on_card(torch, frozen_grads)
    check_deadline_on_card(torch)

    # -- 5: results
    # (source, TPU kernel, wrapper, the phase-2 shape of its record, the
    # phase-4 paths that launch it)
    sources = {"flash_fwd": ("horovod_tpu_torch/csrc/flash_fwd.cu",
                             "horovod_tpu/ops/pallas_kernels.py:51",
                             "flash_fwd_kernel", DECODER_SHAPE,
                             (counts, bert_counts)),
               "flash_bwd_dq": ("horovod_tpu_torch/csrc/flash_bwd.cu",
                                "horovod_tpu/ops/pallas_kernels.py:329",
                                "flash_bwd_dq_kernel", DECODER_SHAPE,
                                (counts, bert_counts)),
               "flash_bwd_dkv": ("horovod_tpu_torch/csrc/flash_bwd.cu",
                                 "horovod_tpu/ops/pallas_kernels.py:376",
                                 "flash_bwd_dkv_kernel", DECODER_SHAPE,
                                 (counts, bert_counts)),
               "flash_bwd_onepass": (
                   "horovod_tpu_torch/csrc/flash_bwd_onepass.cu",
                   "horovod_tpu/ops/pallas_kernels.py:476",
                   "flash_bwd_onepass_kernel", BERT_SHAPE,
                   (counts, bert_counts))}
    bn_sources = {"bn_stats": ("horovod_tpu/ops/pallas_bn.py:96",
                               "bn_stats_kernel"),
                  "bn_apply": ("horovod_tpu/ops/pallas_bn.py:119",
                               "bn_apply_kernel"),
                  "bn_bwd_red": ("horovod_tpu/ops/pallas_bn.py:147",
                                 "bn_bwd_reductions_kernel"),
                  "bn_bwd_dx": ("horovod_tpu/ops/pallas_bn.py:177",
                                "bn_bwd_dx_kernel")}
    # The f16 Hopper kernels' paths, and each kernel's record: its phase-2
    # shape and the path whose launches it reports (the forward and the
    # one-pass at BERT's shape in the f16 BERT-Large one-pass step, dq and
    # dk/dv at the decoder's in the f16 decoder step).
    f16_paths = {"the f16 decoder step": f16_dec_counts,
                 "the f16 BERT-Large step under pallas_onepass":
                     f16_counts["pallas_onepass"],
                 "the f16 BERT-Large step under pallas": f16_counts["pallas"]}
    f16_record = {name: (BERT_SHAPE,
                         "the f16 BERT-Large step under pallas_onepass")
                  for name in ("flash_fwd", "flash_bwd_onepass")}
    f16_record.update({name: (DECODER_SHAPE, "the f16 decoder step")
                       for name in ("flash_bwd_dq", "flash_bwd_dkv")})
    # The f32 kernels on Hopper: their records at the decoder's shape with
    # their launches in the f32 flagship's two steps, at 256 and 384 with
    # those in the small f32 decoder at head_dim 192 and 320 (phase 3; no
    # phase-4 path runs f32 past 128).
    f32_records = [
        (name + suffix, name, shape, launches[wrapper])
        for name, wrapper in (("flash_fwd_f32", "flash_fwd_f32_kernel"),
                              ("flash_bwd_dq_f32", "flash_bwd_dq_f32_kernel"),
                              ("flash_bwd_dkv_f32",
                               "flash_bwd_dkv_f32_kernel"),
                              ("flash_bwd_onepass_f32",
                               "flash_bwd_onepass_f32_kernel"))
        for suffix, shape, launches in (
            ("", DECODER_SHAPE, simt_counts),
            ("_d256", WIDE_HEAD_SHAPES[0], f32_counts[192]),
            ("_d384", WIDER_HEAD_SHAPES[0], f32_counts[320]))]
    say("kernels: " + "; ".join(
        "%s held at %s and %s (phase 2; its record at %s), launched %d "
        "times in decoder training and %d in BERT-Large training (phase 4)"
        % (name, ", ".join(shape_label(*s) for s in FLASH_SHAPES),
           shape_label(*WIDE_BH_SHAPE), shape_label(*shape), paths[0][w],
           paths[1][w])
        for name, (_, _, w, shape, paths) in sources.items()) + "; " +
        "; ".join(
        "%s held at %s (phase 2), launched %d times in ResNet-50 training "
        "(phase 4); its ms, plain_ms, bound_ms and library_ms are one call's "
        "device time at the stem's shape" % (name, ", ".join(
            "M%d C%d" % (m, c) for _, m, c, _, _ in BN_SHAPES),
            bn_counts[w]) for name, (_, w) in bn_sources.items()) + "; "
        "scale_sum held at %d cases (phase 2), launched %d times in "
        "BERT-Large Adasum training (phase 4); its ms, plain_ms and bound_ms "
        "are one call's device time on %d f32 elements; no single PyTorch "
        "call computes it (library_ms null; the two-call "
        "torch.add(a.mul(alpha), b, alpha=beta) took %.6g ms)" % (
            len(SS_LENGTHS) * len(SS_DTYPES) * (2 * len(SS_COEFS) + 1),
            adasum_counts["scale_sum_kernel"], SS_LENGTHS[-1],
            ss_records["float32"]["aten_two_call_ms"]) + "; " + "; ".join(
        "%s_simt (f32, f16 and bf16) held at %s and %s (phase 2; its "
        "record: f32 at %s, SDPA in f32 its library_ms), launched %d times "
        "in the f32 decoder flagship's two steps (phase 4)" % (
            name, ", ".join(shape_label(*s) for s in SIMT_SHAPES),
            shape_label(*WIDE_BH_SHAPE), shape_label(*shape),
            simt_counts[name + "_simt_kernel"])
        for name, (_, _, _, shape, _) in sources.items()) + "; " + "; ".join(
        "%s_f16 (the Hopper kernel in f16) held at %s and %s (phase 2; its "
        "record at %s, SDPA in f16 its library_ms), launched %s (phase 4; "
        "the record's launches are %s's)" % (
            name, ", ".join(shape_label(*s) for s in FLASH_SHAPES),
            shape_label(*WIDE_BH_SHAPE), shape_label(*f16_record[name][0]),
            ", ".join("%d times in %s" % (c[sources[name][2]], label)
                      for label, c in f16_paths.items()),
            f16_record[name][1]) for name in F16_HOPPER) + "; " +
        "flash_fwd_d256 and flash_fwd_d384 (the Hopper forward from 256 on, "
        "bf16 and f16) held at %s and %s (phase 2; their records bf16 at %s "
        "and %s, SDPA in bf16 their library_ms), launched %d times in the "
        "hd256 decoder's two steps (phase 4; flash_fwd_d256's launches) and "
        "%d times in the small decoder at head_dim 320 (phase 3, padded to "
        "384; flash_fwd_d384's launches: no phase-4 path runs a head dim "
        "past 256)" % (", ".join(shape_label(*s) for s in HOPPER_FWD_SHAPES),
                       shape_label(*WIDE_BH_D256_SHAPE),
                       shape_label(*HOPPER_FWD_SHAPES[0]),
                       shape_label(*WIDER_HEAD_SHAPES[0]),
                       hd256_fwd, model_counts[320]["flash_fwd_kernel"])
        + "; flash_bwd_dq_d256, flash_bwd_dkv_d256 and "
        "flash_bwd_onepass_d256 (the Hopper dq, dk/dv and one-pass at 256, "
        "bf16 and f16; the one-pass's partials in 64-row slots) held at %s "
        "and %s (phase 2; their records bf16 at %s, SDPA's bf16 backward "
        "their library_ms), launched %d and %d times in the hd256 decoder "
        "step under pallas and %d in its step under pallas_onepass (phase "
        "4)" % (", ".join(shape_label(*s) for s in WIDE_HEAD_SHAPES),
                shape_label(*WIDE_BH_D256_SHAPE),
                shape_label(*WIDE_HEAD_SHAPES[0]),
                hd256_counts["pallas"]["flash_bwd_dq_kernel"],
                hd256_counts["pallas"]["flash_bwd_dkv_kernel"],
                hd256_counts["pallas_onepass"]["flash_bwd_onepass_kernel"])
        + "; " + "; ".join(
            "%s, %s_d256 and %s_d384 (the f32 %s on Hopper, split TF32) held "
            "at %s and %s (phase 2; their records at %s, %s and %s, SDPA in "
            "f32 their library_ms, their bound %d TF32 products an f32 one at "
            "495 TFLOP/s), launched %d times in the f32 decoder flagship's "
            "two steps (phase 4) and %d and %d times in the small f32 decoder "
            "at head_dim 192 and 320 (phase 3)" % (
                name, name, name, what,
                ", ".join(shape_label(*s) for s in F32_FWD_SHAPES),
                shape_label(*WIDE_BH_SHAPE), shape_label(*DECODER_SHAPE),
                shape_label(*WIDE_HEAD_SHAPES[0]),
                shape_label(*WIDER_HEAD_SHAPES[0]), SPLIT_TF32_TERMS,
                *(n for _, kern, _, n in f32_records if kern == name))
            for name, what in (("flash_fwd_f32", "forward"),
                               ("flash_bwd_dq_f32", "dq"),
                               ("flash_bwd_dkv_f32", "dk/dv"),
                               ("flash_bwd_onepass_f32", "one-pass"))))
    out = []
    for name, (src, replaces, wrapper, shape, paths) in sources.items():
        rec = flash[shape][name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": sum(c[wrapper] for c in paths),
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"]})
    for name, (replaces, wrapper) in bn_sources.items():
        rec = bn_shape_times["stem"][name]
        out.append({"name": name, "route": "cuda",
                    "source": "horovod_tpu_torch/csrc/batch_norm.cu",
                    "replaces": replaces, "launches": bn_counts[wrapper],
                    "max_abs_err": bn_err[name], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"]})
    for name, (_, replaces, _, shape, _) in sources.items():
        rec = simt["float32"][shape][name]
        wrapper = name + "_simt_kernel"
        out.append({"name": name + "_simt", "route": "cuda",
                    "source": "horovod_tpu_torch/csrc/flash_simt.cu",
                    "replaces": replaces, "launches": simt_counts[wrapper],
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"]})
    for name, kern, shape, launches in f32_records:
        rec = f32hopper[shape][kern.replace("_f32", "")]
        out.append({"name": name, "route": "cuda",
                    "source": "horovod_tpu_torch/csrc/%s.cu" % (
                        "flash_fwd_f32" if kern == "flash_fwd_f32"
                        else "flash_bwd_f32"),
                    "replaces": sources[kern.replace("_f32", "")][1],
                    "launches": launches,
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"]})
    for name in F16_HOPPER:
        src, replaces, wrapper, _, _ = sources[name]
        shape, path = f16_record[name]
        rec = flash16[shape][name]
        out.append({"name": name + "_f16", "route": "cuda", "source": src,
                    "replaces": replaces, "launches": f16_paths[path][wrapper],
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"]})
    for name, kern, shape, launches in (
            ("flash_fwd_d256", "flash_fwd", HOPPER_FWD_SHAPES[0], hd256_fwd),
            ("flash_fwd_d384", "flash_fwd", WIDER_HEAD_SHAPES[0],
             model_counts[320]["flash_fwd_kernel"]),
            ("flash_bwd_dq_d256", "flash_bwd_dq", WIDE_HEAD_SHAPES[0],
             hd256_counts["pallas"]["flash_bwd_dq_kernel"]),
            ("flash_bwd_dkv_d256", "flash_bwd_dkv", WIDE_HEAD_SHAPES[0],
             hd256_counts["pallas"]["flash_bwd_dkv_kernel"]),
            ("flash_bwd_onepass_d256", "flash_bwd_onepass",
             WIDE_HEAD_SHAPES[0],
             hd256_counts["pallas_onepass"]["flash_bwd_onepass_kernel"])):
        rec = flash[shape][kern]
        out.append({"name": name, "route": "cuda",
                    "source": sources[kern][0],
                    "replaces": sources[kern][1], "launches": launches,
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"]})
    rec = ss_records["float32"]
    out.append({"name": "scale_sum", "route": "cuda",
                "source": "horovod_tpu_torch/csrc/scale_sum.cu",
                "replaces": "horovod_tpu/ops/pallas_kernels.py:838",
                "launches": adasum_counts["scale_sum_kernel"],
                "max_abs_err": max(r["max_abs_err"]
                                   for r in ss_records.values()),
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": None})
    say("chip_smoke: %.1f s wall, the build included"
        % (time.perf_counter() - t_start))
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
