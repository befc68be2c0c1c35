#!/usr/bin/env python3
"""Smoke run of treemorph_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Card and build: the card's name and power limit, torch and CUDA
   versions; every CUDA kernel of the port is built from ``csrc/`` (one
   ``nvcc`` per source, in parallel) and the QSM core with ``g++``; each
   kernel instantiation's registers, shared memory and spills as ptxas
   reports them.
2. Kernel against plain: ``band_conv_padded`` against its plain PyTorch
   version on the card, bf16 and f32, at the level shapes of the e2e cloud
   (level 0 ~P/2 rows: 7->32, 32->32, 64->32; level 1: 64->64, 128->64;
   level 2: 96->96), with CUDA-event times, the bound at the f32 rate and
   the bound at the kernel's tensor-core passes (which term sets each),
   and, in each row's log line only, the time of the SIMT kernel this one
   replaced, a historical constant (``SIMT_HISTORICAL_MS``).
3. Stage 1 on the card against the CPU: the same model and weights on a
   ~20k-point cut of the e2e cloud; offsets and noise argmax must agree.
4. End to end at full width: the pipeline's TreeLearn (channels 32, three
   levels, band engine, bf16, voxel_capacity_divisor 2, seeded weights) on
   the ~500k-point synthetic plot, through ``run_pipeline`` (counting the
   kernel's launches), each stage timed inside that call.

Training (three synthetic plots of 30 labeled trees x 16,384 points, the
reference's training batch, written to a temporary directory):

5. Backward kernel against plain: ``band_conv_bwd_padded`` against its plain
   version on the card, bf16 and f32, at the level shapes of the first
   30-tree batch (every (level, Cin, Cout) of the 20 convs that take it),
   with CUDA-event times of the call and of its two launches apart
   (``d_feats``: the forward kernel; ``d_w``: ``band_conv_dw_padded``),
   both bounds and, in each row's log line only, the SIMT kernels' times
   (``SIMT_HISTORICAL_MS``); the forward kernel is timed at the same
   shapes. Then the same at K = 125, the level plans of
   ``TreeLearn(kernel_size=5)`` on the same batch (every conv 5x5x5).
   The bounds count the bytes of the rows the kernels read: the rows an
   in-window entry names (features in the forward, the gradient in the
   backward) and, for ``d_w``, the rows that own one; so do phases 2 and
   11a.
6. Training on the card: each band conv of a full-width f32 train step
   differentiated alone through autograd against the gather engine's
   backward, with the step's own cotangents and with random ones; one
   train step on a 2-tree cut, band engine against gather engine (f32,
   both also against the same step in float64 on the CPU) and card
   against CPU (bf16); then the training CLI at full width (one CV fold,
   3 epochs of 2 steps, band engine, bf16), counting the kernels'
   launches; then a timed step split into forward, backward and
   optimizer, and one more step under ``torch.profiler`` (device busy
   share, top operators and kernels). 6d: ``TreeLearn(kernel_size=5,
   engine="band")``: the f32 step band against gather on the card (as
   6a) and the bf16 step card against CPU, on 2 trees x 4,096 points, and
   full-width bf16 steps on the 30-tree batch with
   their launches counted (``band_conv_bwd``, the K = 125 forward).

PTv3 serving (the pipeline's ``pointtransformerv3`` family at full width,
seeded weights, f32, on the e2e cloud given seeded per-point features):

7a. Window attention against plain: ``window_attention`` on the card at each
    distinct (W, H, 1024, 16) shape of the plot's forward, on the inputs the
    main path gives it (f32, and the same cast to bf16) and on random ones
    with three segments and padding rows, and on random three-segment
    inputs at each head dim of ``HEAD_DIMS`` (K = 1088), against its plain
    version on a spread of the windows; the training forward
    (``window_attention_fwd``) gives the same output and a log-sum-exp
    within 1e-5 of scale of the plain one's; a second call of either gives
    the same bits; CUDA-event times (f32, bf16) beside the windows that
    hold rows, the bound at the f32 rate, the bound at the kernel's own
    arithmetic (its TF32 passes, one exp per pair on the special function
    units at the card's maximum SM clock, or the bytes: q, k and v of the
    rows that hold a segment, the segment ids, the whole output), the plain
    version and ``scaled_dot_product_attention`` with the same mask.
7b. Stage 1 on the card against the CPU: the forward ``predict_single``
    runs, on the cloud's first 16,384 points.
7c. End to end: ``run_pipeline`` with ``model_type: pointtransformerv3``
    (44 kernel launches: 22 blocks x 2 models), its stages timed, then
    one forward under ``torch.profiler`` (device busy share, top operators
    and kernels, and the port's own kernels).

PTv3 training (the CLI's ``pointtransformerv3`` family at full width, f32,
on the training plots above, at the reference's PTv3 batch of 4 trees x
16,384 points, scripts/bench_training.py:27-31):

8a. Backward kernel against plain: ``window_attention_bwd`` on the card at
    each distinct (W, H, 1024, 16) shape of a full-width train step, on the
    inputs and output cotangents captured from that step (f32, and the same
    cast to bf16) and on random ones with three segments and padding rows,
    fed the forward kernel's output and log-sum-exp, against its plain
    version (which recomputes the probabilities); dq, dk and dv each within
    1e-5 of their scale, padding rows exactly 0; CUDA-event times in f32
    and bf16 against the bound (f32 rate, and TF32 in the kernel's passes),
    the plain version and the backward of ``scaled_dot_product_attention``
    with the same mask (f32 and bf16).
8b. Training on the card: each of the step's 22 attentions differentiated
    alone through autograd (``window_attention``'s ``autograd.Function``
    and the backward kernel) on the step's own cotangent, against the plain
    backward; one train step on a cut of 2 trees x 4,096 points, card
    against CPU (f32, the same weights and order permutations,
    ``drop_path`` 0).
8c. The training CLI at full width: one CV fold, 2 epochs of 15 steps,
    counting both attention kernels' launches (22 backward per step); its
    checkpoint through ``load_model`` serves one ``predict_single``.
8d. A timed step split into forward, backward and optimizer, with peak
    device memory, and one more step under ``torch.profiler``.

The z-band conv (z-band plans over the profile workload of
``python -m treemorph_tpu_torch.scripts.profile_zband`` and over the
TreeLearn plot's levels 0-2):

9a. ``zband_conv_padded`` (the z-band instances of ``csrc/band_conv.cu``)
    against its plain version, bf16 and f32, at the profile's three convs
    and at every 3x3x3 conv shape of the plot's levels; residual rows,
    route, CUDA-event times against both bounds, the plain version, the
    band kernel on the same conv (K = 27 or 125) and the gather engine,
    and the replaced SIMT kernel's time, a historical constant
    (``ZBAND_SIMT_HISTORICAL_MS``).
9b. ``zband_subm_conv_apply`` through autograd against the gather engine
    (f32, random cotangent): output, ``d_feats`` and ``d_w``; the backward
    launches the kernel.
9c. The profile script's ``main()`` on the card, its launches counted;
    z-band against gather within 1e-5 of scale in f32, 1e-2 in bf16.

The brick conv (the plot's levels 0-2 in 4^3 bricks, capped at M / 4):

10a. ``brick_conv_cells``, core and full variants, against its plain
     version on each level's halo'd bricks and on a dense random tensor of
     the same shape (all-zero bricks exactly 0), timed beside the bounds
     (f32 rate and TF32 in three passes, over every brick and over the
     bricks whose input is not zero, counted and printed), the plain
     version and ``F.conv3d`` (TF32 off; and on, logged).
10b. The level-0 brick path (``brickize`` -> ``to_dense`` -> ``_halo_pad``
     -> ``brick_conv`` forward and backward), its two launches counted,
     against autograd of ``F.conv3d`` in float64 (cuDNN's f32 weight
     gradient is logged beside it).
10c. ``brick_subm_conv`` (``F.conv3d`` and x-slab schedules) against the
     gather engine on the level-0 voxels.

The bench PTv3 configuration (``PTV3_BENCH``: the JAX package's bench.py
PTv3 forward, token dedup, the band stem at K = 125 and band xCPEs, bf16;
full width, seeded weights), on the bench tree (bench.py:86-100's first
tree, 131,072 points, seeded features):

11a. ``band_conv_padded`` against its plain version at every (K, rows, Cin,
     Cout) of one forward: the main path's own inputs (bf16) and random
     f32 features of the same rows; every band plan's ``ok`` and residual
     rows (the stem's K = 125 plan among them); CUDA-event times beside
     the bounds (f32 rate; the kernel's passes) and the plain version.
11b. The forward ``predict_single`` runs, card against CPU: offsets within
     1e-2 of their scale, noise argmax agreement, no dedup or pool
     overflow, band launches per forward by K (1 at K = 125, 22 at K = 27
     where every plan is ``ok``); then ``predict_single`` with both
     predictors on the card, launches counted.
11c. The same configuration through ``run_pipeline`` on the PTv3 plot,
     its stages timed; one forward's wall time (median of 3) and one forward
     under ``torch.profiler``.

PointNet2 serving (the pipeline's ``pointnet2`` family, depth 5, seeded
weights, f32), on the e2e cloud cut into 1 m rasters:

12a. Two rasters cut to 4,096 points each, card against CPU: offsets within
     1e-3 of their scale, semantic argmax agreement; the shares of
     identical FPS and ball-query indices.
12b. The plot through ``run_pipeline`` with ``model_type: pointnet2`` (one
     (60, max_pts) minibatch per model), its stages timed, with peak
     device memory.
12c. Exact FPS at the first set abstraction's shape (CUDA events), and one
     minibatch forward under ``torch.profiler``: wall, device busy share,
     and the spans on the device of FPS, ball queries, 3-NN
     interpolation, MLPs and heads.

Training the other families (13a-13d, on the training plots above):

13a. PointNet2 training at the reference's batch (60 rasters x 4,096
     points, scripts/bench_training.py:27-31, depth 5, exact FPS, f32):
     one ``make_train_step`` and one ``make_accum_steps`` group of two
     minibatches, card against CPU with the same weights, batches and FPS
     starts (loss, every gradient against the largest, BN running
     statistics); the step split into forward, backward and optimizer, peak
     device memory, and one step under ``torch.profiler`` with the device
     spans of FPS, ball queries, 3-NN interpolation, MLPs and heads.
13b. The training plots rasterized (1 m, stride 0.5, metadata JSON and
     raster files), then the training CLI's ``pointnet2`` with
     ``--hierarchical_json`` (minibatches of 60 rasters, gradients
     accumulated over 4 trees a step, 2 epochs) and with ``--raster_dir``
     (1 epoch): losses finite and falling, one optimizer step per tree
     group, the checkpoints through ``load_model``.
13c. The PTv3 CLI's band configuration (``--engine band --dedup_divisor 4
     --conv_dtype bfloat16``, 4 trees x 16,384 points a step, one epoch):
     launches per step by kernel (the K = 125 stem, 22 K = 27 xCPEs and
     their 22 ``d_feats``, 22 ``band_conv_bwd``, 22 of each attention
     kernel), every band plan's ``ok`` and GATHER_ROUTES; the 22
     ``band_conv_bwd`` calls of one bf16 card step, each against its plain
     version on the step's own and on random cotangents; one f32 step band
     against gather on the card, one bf16 step card against CPU (2 trees
     x 4,096 points); the step split and one step profiled.
13d. ``python -m treemorph_tpu_torch.scripts.exec_pipeline --config``
     once per family, the three processes started together (JSON for
     TreeLearn, YAML for PointNet2 and PTv3),
     ``model_dirs`` naming the checkpoints of 6b, 13b and 13c, on one
     held-out tree with stage 2's target lowered: points kept, cylinders,
     the CSV written (PointNet2's stage-2 cloud kept for 17c).

The JAX package's checkpoints and labeling (14a-14c, run after phase 4,
whose cylinder CSV 14b takes):

14a. The JAX package's TreeLearn checkpoint committed under
     ``tests/data/jax_treelearn_P3/`` (orbax, the pipeline's width, the
     noise head's final bias at [5, -5]) read by the port's orbax reader,
     every leaf's SHA-256 against ``arrays.sha256.json``; copied as
     ``offset/TreeLearn_O_P3`` and ``noise/TreeLearn_N_P3``, loaded by
     ``load_model`` (card and CPU), then served as phase 4 serves (band,
     bf16, voxel capacity P / 2): stage 1 card against CPU at phase 3's
     limits, and the plot through ``run_pipeline`` (kept points, >= 1M
     upsampled, > 0 cylinders, 42 band launches a ``predict_single``);
     the reader's and ``load_model``'s seconds.
14b. The plot labeled against phase 4's fitted cylinders:
     ``generate_offset_cloud`` and ``add_features`` on the card (twice),
     then on a seeded 65,536-point cut on the card and on the CPU: ids,
     offsets, normals and heights card against CPU on the cut;
     seconds, pairs per second, peak device memory, the projection's
     bound.
14c. ``python -m treemorph_tpu_torch.scripts.preprocess`` ``label`` and
     ``noise`` (both on the card, started together), then ``split`` (its
     ``main``, in-process) over 30 raw synthetic
     trees and their QSM CSVs, then the TreeLearn training CLI (band,
     bf16, ``--noise_root``) for one epoch on what they wrote: files of
     11 finite columns, manifests naming every tree, finite losses,
     ``band_conv_bwd`` launches counted.

Evaluation and tooling (15a-15f; 15b after 14c, on phase 4's cylinders,
the rest after 13d, on the training plots and 13c's and 13d's
checkpoints):

15a. ``python -m treemorph_tpu_torch.scripts.evaluate nn`` on the card for
     TreeLearn (13d's checkpoint, ``--engine band --conv_dtype bfloat16``)
     and PTv3 (13c's, at the family's defaults) over held-out trees of
     plot 1, its band and attention launches per tree (non-zero); the same
     command with ``--device cpu`` on the same trees: ``mean_after``
     within 1 % of the CPU's, ``shrinkage`` within one percentage point.
15b. ``evaluate predict`` (phase 4's TreeLearn saved as checkpoints, band,
     bf16; 63 band launches) and ``evaluate qsm-distance`` of the plot
     against phase 4's cylinders on the card; the projection's ids and
     distances card against CPU on every 20th refined point (14b's
     limits), the CLI's statistics against the same projection.
15c. ``diagnostics.model_diagnostics`` (``test_model``'s forwards: one
     offset, two noise) on plot 1's first tree, card against CPU within
     phase 3's limits; ``test_model``'s figures only where matplotlib is
     installed (a line says when they are not run).
15d. A full-width TreeLearn and PointNet2 written as the reference
     system's ``state_dict`` (:func:`reference_state_dict`), through
     ``python -m treemorph_tpu_torch.scripts.import_checkpoint`` and
     ``load_model`` on the card: weights and outputs bit for bit.
15e. ``utils/flops.py``'s ``mfu_report`` of one serving forward (phase 4's
     TreeLearn) and one PTv3 forward (the cloud's first 65,536 points),
     each printed on a line
     ``MFU {json}`` with the card's name and power limit; the band
     ``kernel_flops`` equal to phase 2's operations for the same forward;
     outside the log the forward's launches and host synchronizations
     (``serving_syncs.py``) as on the log's parent commit.
15f. ``python -m treemorph_tpu_torch.scripts.sanity_check
     pointtransformerv3`` for SANITY_EPOCHS epochs on the card: the loss
     falls, the attention forward and backward launches counted.

PTv3's reference-partitioning options and the non-default conv engines
(16a-16f; 16c after 6d, on its 30-tree batch; 16a, 16b and 16e after 8d;
16f after 10c; 16d after 11b):

16a. PTv3 with ``pad_per_element`` at full width: the serving forward card
     against CPU (``num_elements`` 1, 7b's limits, a 16,384-point cut); the
     attention inputs of one forward on that layout, each shape's kernel
     against its plain version (dead windows and slots logged, dead rows
     exactly 0); each of a 4-tree train step's 22 attention calls
     (``num_elements`` 4, its own cotangents), the backward kernel against
     its plain version; launches: 22 forward in a ``predict_single``, 22
     forward and 22 backward in the step; one f32 step card against CPU on
     2 trees x 1,024 points and one block a stage (8b's limits; the CPU
     bounds the cut).
16b. PTv3 with RPE, ``pad_per_element`` and PDNorm (BatchNorms and
     LayerNorms, conditions TreeSet / Other, condition 1), without and with
     ``adaptive`` (a seeded context): three steps at 2 x 16,384 on the card
     (the loss falls; peak device memory; 4 trees overflow the card with
     RPE), the eval forward card against CPU on 2 trees x 1,024 points at
     one block a stage, and (adaptive) one step card against CPU there.
     Attention with the RPE
     bias takes the plain version on every device, as the JAX package
     routes it (the kernels take no bias): no attention launch.
16c. The pipeline's TreeLearn width (seeded, f32, voxel capacity P / 2) on
     the zpack, pencil and brick (``F.conv3d`` with TF32 off, and x-slab)
     engines: the plot's forward against the gather engine on the card, a
     10,000-point cut card against CPU, seconds beside the gather and band
     engines', dropped voxels; one f32 step at 30 x 16,384 per engine
     against the gather step (6a's limits; brick at 5 trees: at 10 the
     x-slab step's dense bricks overflow the card).
16d. The bench PTv3 configuration with ``stem_engine="zpack"`` on the
     bench tree's first 32,768 points (token cap P / 2): card against CPU
     (11b's bf16 limit), no band launch, 22
     attention launches, no overflow; against the band stem, logged.
16e. The training CLI for one epoch on a cut of the training plots:
     ``treelearn --engine`` zpack, pencil, brick, and ``pointtransformerv3
     --engine zpack --dedup_divisor 4`` (attention launches counted).
16f. The plot's level 0 in 8^3 tiles: ``tile_subm_conv`` (``F.conv3d``
     and 27 slices) against the gather conv; the octant-run rulebook equal
     to ``build_rulebook`` (k = 3, 5).

Data parallelism and the QSM options (17a-17c, after phase 15; 17c's
process and 17a's rank processes start together, and this process
computes 17a's references and runs 17b while they run):

17a. The data-parallel TreeLearn train step (``make_train_step(mesh=...)``,
     band engine, seeded weights broadcast from rank 0) on the first
     30-tree training batch, in rank processes on the one card: two gloo
     ranks (CUDA tensors) at bf16 and f32, four at f32 (the batch padded to
     32), one NCCL rank at f32. Each rank's loss, gradients (summed over
     the ranks, before the clip) and state after the step against the
     plain emulation of the step in this process (each shard's forward,
     its numerators over the global denominators, autograd's sum, BN
     statistics averaged, the optimizer), the NCCL rank against the
     one-device step; the band kernels' launches counted in every rank.
17b. ``predict_rasterized_sharded`` on the PointNet2 plot (the pipeline's
     seeded PointNet2, 1 m rasters) over two slots on the card against
     ``predict_rasterized``: offsets within 1e-5 of their scale, at least
     99.9 % of the kept points the same, one reduction per accumulator.
17c. ``fit_qsm`` on 13d's PointNet2 stage-2 cloud with euclidean shells:
     agglomerative clustering with weighted merging, and DBSCAN with
     enclosed merging (scipy, no scikit-learn): cylinders, seconds.

The last two lines are the ``kernels`` JSON record and
``{"ok": true, "device": {...}}``. Float32 matmuls and convolutions run
without TF32 (set below) so f32 comparisons are full precision.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, the
#: float32 rate outside the tensor cores, for products with f32 weights
#: (the forward, and the feature gradient), and the bf16 tensor-core rate,
#: for the weight gradient's bf16 x bf16 products (features times output
#: gradient, summed in f32) in bf16 mode
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
#: the TF32 tensor-core rate, which the brick conv and the attention
#: backward run on (in three passes for f32 operands, 3xTF32)
TF32_FLOPS = 495e12
#: the band kernels' arithmetic on the tensor cores: (rate, passes) per
#: feature type. Forward and d_feats: bf16 features by three bf16 weight
#: pieces, or 3xTF32; d_w: bf16 by bf16 in one pass, or 3xTF32
BAND_TC = {"torch.bfloat16": (BF16_FLOPS, 3), "torch.float32": (TF32_FLOPS, 3)}
DW_TC = {"torch.bfloat16": (BF16_FLOPS, 1), "torch.float32": (TF32_FLOPS, 3)}
#: the attention forward's TF32 passes per (scores, P V) product: 3xTF32
#: for f32 inputs; bf16 q, k, v are exact in TF32, so one pass for the
#: scores and two (P split hi/lo) for P V
ATTN_FWD_PASSES = {"torch.float32": (3, 3), "torch.bfloat16": (1, 2)}
#: exps per clock on one SM's special function units (ex2)
SFU_PER_CLOCK = 16
#: historical, not measured by this script: ms per call of the SIMT f32
#: band kernels these kernels replaced (commit ddf01be), at each (part,
#: level, Cin, Cout, type): "fwd" the forward on the e2e plot's levels
#: (phase 2), "train_fwd", "bwd" (the whole band_conv_bwd_padded) and
#: "bwd_d_feats" (its forward launch) on the training batch's (phase 5);
#: the mean of two runs of time_kernels.py (then time_band_kernels.py)
#: on a checkout of that commit, in one call on one NVIDIA H100 80GB HBM3
#: at 700 W. Printed beside each row's own time as ``simt_historical_*``;
#: never in a record
SIMT_HISTORICAL_MS: dict = {
    ('fwd', 0, 7, 32, 'torch.bfloat16'): 0.2522,
    ('fwd', 0, 7, 32, 'torch.float32'): 0.2600,
    ('fwd', 0, 32, 32, 'torch.bfloat16'): 0.5458,
    ('fwd', 0, 32, 32, 'torch.float32'): 0.5400,
    ('fwd', 0, 64, 32, 'torch.bfloat16'): 0.9457,
    ('fwd', 0, 64, 32, 'torch.float32'): 0.9527,
    ('fwd', 1, 64, 64, 'torch.bfloat16'): 0.5655,
    ('fwd', 1, 64, 64, 'torch.float32'): 0.5532,
    ('fwd', 1, 128, 64, 'torch.bfloat16'): 1.0703,
    ('fwd', 1, 128, 64, 'torch.float32'): 1.0517,
    ('fwd', 2, 96, 96, 'torch.bfloat16'): 0.8635,
    ('fwd', 2, 96, 96, 'torch.float32'): 0.8589,
    ('train_fwd', 0, 7, 32, 'torch.bfloat16'): 0.6106,
    ('train_fwd', 0, 7, 32, 'torch.float32'): 0.6225,
    ('train_fwd', 0, 32, 32, 'torch.bfloat16'): 1.9630,
    ('bwd', 0, 32, 32, 'torch.bfloat16'): 3.4578,
    ('bwd_d_feats', 0, 32, 32, 'torch.bfloat16'): 1.9410,
    ('train_fwd', 0, 32, 32, 'torch.float32'): 1.9333,
    ('bwd', 0, 32, 32, 'torch.float32'): 3.4711,
    ('bwd_d_feats', 0, 32, 32, 'torch.float32'): 1.9250,
    ('train_fwd', 0, 64, 32, 'torch.bfloat16'): 3.7582,
    ('bwd', 0, 64, 32, 'torch.bfloat16'): 5.7071,
    ('bwd_d_feats', 0, 64, 32, 'torch.bfloat16'): 2.8672,
    ('train_fwd', 0, 64, 32, 'torch.float32'): 3.7288,
    ('bwd', 0, 64, 32, 'torch.float32'): 5.8060,
    ('bwd_d_feats', 0, 64, 32, 'torch.float32'): 2.8577,
    ('train_fwd', 1, 64, 64, 'torch.bfloat16'): 2.3591,
    ('bwd', 1, 64, 64, 'torch.bfloat16'): 5.0109,
    ('bwd_d_feats', 1, 64, 64, 'torch.bfloat16'): 2.3578,
    ('train_fwd', 1, 64, 64, 'torch.float32'): 2.3131,
    ('bwd', 1, 64, 64, 'torch.float32'): 5.0560,
    ('bwd_d_feats', 1, 64, 64, 'torch.float32'): 2.3621,
    ('train_fwd', 1, 128, 64, 'torch.bfloat16'): 4.6167,
    ('bwd', 1, 128, 64, 'torch.bfloat16'): 9.8312,
    ('bwd_d_feats', 1, 128, 64, 'torch.bfloat16'): 4.5845,
    ('train_fwd', 1, 128, 64, 'torch.float32'): 4.5173,
    ('bwd', 1, 128, 64, 'torch.float32'): 10.0322,
    ('bwd_d_feats', 1, 128, 64, 'torch.float32'): 4.5078,
    ('train_fwd', 2, 96, 96, 'torch.bfloat16'): 2.8066,
    ('bwd', 2, 96, 96, 'torch.bfloat16'): 5.4367,
    ('bwd_d_feats', 2, 96, 96, 'torch.bfloat16'): 2.7875,
    ('train_fwd', 2, 96, 96, 'torch.float32'): 2.7579,
    ('bwd', 2, 96, 96, 'torch.float32'): 5.5856,
    ('bwd_d_feats', 2, 96, 96, 'torch.float32'): 2.7628,
}
#: historical, not measured by this script: ms per call of the SIMT
#: z-band kernel that the z-band instances of csrc/band_conv.cu replaced
#: (csrc/zband_conv.cu, commit c838477), at each 9a (conv, type); the mean
#: of two runs of time_kernels.py on a checkout of that commit, in one call
#: on one NVIDIA H100 80GB HBM3 at 700 W. Printed beside each 9a row's own
#: time as ``simt_historical_ms``; never in a record
ZBAND_SIMT_HISTORICAL_MS: dict = {
    ('profile stem k=5 4->32', 'torch.bfloat16'): 0.1552,
    ('profile stem k=5 4->32', 'torch.float32'): 0.1615,
    ('profile xcpe k=3 32->32', 'torch.bfloat16'): 0.2431,
    ('profile xcpe k=3 32->32', 'torch.float32'): 0.2382,
    ('profile k=3 64->64', 'torch.bfloat16'): 0.5230,
    ('profile k=3 64->64', 'torch.float32'): 0.5243,
    ('L0 7->32', 'torch.bfloat16'): 0.2325,
    ('L0 7->32', 'torch.float32'): 0.2323,
    ('L0 32->32', 'torch.bfloat16'): 0.3868,
    ('L0 32->32', 'torch.float32'): 0.3872,
    ('L0 64->32', 'torch.bfloat16'): 0.6603,
    ('L0 64->32', 'torch.float32'): 0.6665,
    ('L1 64->64', 'torch.bfloat16'): 0.5264,
    ('L1 64->64', 'torch.float32'): 0.5465,
    ('L1 128->64', 'torch.bfloat16'): 1.0370,
    ('L1 128->64', 'torch.float32'): 1.0504,
    ('L2 96->96', 'torch.bfloat16'): 0.8191,
    ('L2 96->96', 'torch.float32'): 0.7949,
}

#: (level, Cin, Cout, launches per forward) of every band conv of the
#: pipeline's TreeLearn (channels 32, num_blocks 3): level 0 has the input
#: conv, 7 C->C convs and the tail's 2C->C; level 1 likewise; level 2
#: (deepest) its two residual blocks
LEVEL_CONVS = [
    (0, 7, 32, 1), (0, 32, 32, 7), (0, 64, 32, 1),
    (1, 64, 64, 7), (1, 128, 64, 1),
    (2, 96, 96, 4),
]
#: kernel vs plain: products are exact in both and summed in f32 in
#: another order, so |err| stays near 1e-6 of the output scale
KERNEL_RTOL = 1e-5
#: card vs CPU stage 1: bf16 roundings that flip under another f32 sum
#: order (and atomic voxel means) move outputs by ~1e-3 of their scale
STAGE1_OFFSET_RTOL = 1e-2
STAGE1_ARGMAX_AGREEMENT = 0.999
#: stage 2's target size (configs/pipeline_config.yaml)
MIN_POINTS = 1_000_000

#: PTv3: attention blocks per forward (encoder 2+2+2+6+2, decoder 2+2+2+2),
#: the cut of the e2e cloud its kernels and MFU are measured on, and the
#: cut stage 1 is compared on, card against CPU (the CPU's forward of the
#: larger cut took 28 s)
PTV3_BLOCKS = 22
PTV3_CUT, PTV3_CPU_CUT = 65_536, 16_384
#: points of each of the 2 trees of a PTv3 train step card against CPU:
#: f32 (8b) and the band configuration's bf16 (13c); the CPU's f32 step on
#: whole trees took 36 s, its bf16 step 41 s (27 s on 8,192 points)
PTV3_CPU_STEP_POINTS = 4096
#: card vs CPU PTv3 forward, f32 throughout: the same roundings in another
#: sum order (cuBLAS, atomic pooled sums) through 22 blocks
PTV3_OFFSET_RTOL = 1e-3
#: windows of a level the plain attention is checked on
ATTN_CHECK_WINDOWS = 48

#: PTv3 training: the reference's PTv3 batch (scripts/bench_training.py:
#: 27-31), one backward launch per attention block, the CLI run's epochs
#: (test plot 1 leaves 60 training trees: 15 steps per epoch and 8
#: validation batches)
PTV3_TRAIN_TREES, PTV3_TRAIN_EPOCHS = 4, 2
PTV3_BWD_PER_STEP = PTV3_BLOCKS
#: card vs CPU, one f32 PTv3 train step: the loss, and every gradient
#: against the step's largest (sum order, cuBLAS against the CPU's GEMMs,
#: atomic pooled sums, through 22 blocks and back)
PTV3_STEP_LOSS_RTOL = 1e-5
PTV3_STEP_GRAD_RTOL = 1e-4

#: the training workload: plots of 30 trees x 16,384 points, one 30-tree
#: batch per step (scripts/bench_training.py:27-31, the reference's
#: published TreeLearn training shape); test plot 1 leaves 60 training
#: trees, so 2 steps per epoch
TRAIN_TREES, TRAIN_POINTS, TRAIN_PLOTS, TRAIN_EPOCHS = 30, 16384, 3, 3
#: band convs per step that take the backward kernel: every one but the
#: stem, whose input (raw voxel features) needs no gradient, so its weight
#: gradient takes the gather formulation
BWD_PER_STEP = 20
#: band vs gather engine, one f32 train step on the card: the losses to
#: ENGINE_LOSS_RTOL and every gradient within ENGINE_RTOL of the step's
#: largest. A leaf is not held to its own scale there: at initialization
#: some leaves are sums that cancel (a BatchNorm's backward leaves gradients
#: of zero mean), and a ReLU whose input rounds to the other side of zero in
#: one step and not the other moves them by a large share of their scale,
#: whatever the sum order. Both steps' errors against the same step in
#: float64 (gather engine, CPU) are logged per leaf; each conv's backward is
#: held to its own scale on this step's own cotangents in phase 6a
ENGINE_LOSS_RTOL = 1e-5
ENGINE_RTOL = 1e-4
#: card vs CPU, one bf16 train step: the same bf16 roundings, of which a
#: few flip under another f32 sum order (and the atomic voxel sums)
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_RTOL = 1e-2

#: z-band plans take the profile script's residual cap, m // 2 rows (the
#: default m // 4 overflows on surface clouds, whose column ends leave ~40 %
#: of rows with a missing anchor)
ZBAND_RES_DIVISOR = 2
#: z-band against the gather engine in the profile: f32 differs in sum
#: order; in bf16 the gather engine also rounds the weights to bf16
PROFILE_F32_RTOL, PROFILE_BF16_RTOL = 1e-5, 1e-2
#: brick engine: bricks per level capped at M / 4 (the JAX TreeLearn's
#: ``brick_divisor``), each level's (Cin = Cout) width
BRICK_DIVISOR = 4
BRICK_WIDTHS = (32, 64, 96)
#: autograd and engine checks of phases 9b, 10b and 10c: f32, sum order
AUTOGRAD_RTOL = 1e-5
#: the JAX package's bench PTv3 configuration (bench.py:51-54, :745-750):
#: one token per voxel, level-0 dedup cap P / 4, the band stem (K = 125)
#: and band xCPEs (K = 27), bf16
PTV3_BENCH = dict(pool_shrink=2, dedup_divisor=4, dedup_tokens=True,
                  stem_engine="band", compute_dtype="bfloat16")
#: card vs CPU in that configuration: bf16 roundings that flip under
#: another f32 sum order (cuBLAS, atomic pooled sums) through 22 blocks
PTV3_BENCH_OFFSET_RTOL = 1e-2


#: the script's start; every log line opens with the seconds since then
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def e2e_cloud():
    """The e2e workload's raw cloud (the JAX package's bench workload)."""
    import numpy as np

    from treemorph_tpu_torch.fixtures import (
        synthetic_qsm,
        synthetic_tree_cloud,
    )

    rng = np.random.default_rng(17)
    qsm = synthetic_qsm(n_branches=4, rng=rng)
    points, _ = synthetic_tree_cloud(
        qsm=qsm, points_per_m2=50000, noise_scale=0.004,
        outlier_fraction=0.02, rng=rng,
    )
    return points


def pipeline_models(device):
    """Offset and noise predictors of the pipeline's TreeLearn. The noise
    model shares the weights except its semantic head's final bias, which
    prefers class 0 (keep): a random head would drop ~96% of the cloud and
    starve stages 2-3, unlike a trained one."""
    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import (
        Predictor,
        build_model,
    )

    model = build_model(
        "treelearn", voxel_capacity_divisor=2, engine="band",
        conv_dtype="bfloat16", device=device, seed=0,
    )
    noise = model.clone()
    with torch.no_grad():
        noise.semantic_head.Dense_1.bias.copy_(torch.tensor([5.0, -5.0]))
    return (
        Predictor("treelearn", model, device),
        Predictor("treelearn", noise, device),
    )


def phase_card_and_build():
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from treemorph_tpu_torch import native
    from treemorph_tpu_torch.ops.cuda import build_all, kernel_names

    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"CPUs {len(os.sched_getaffinity(0))}, torch threads "
        f"{torch.get_num_threads()} (the CPU references)")
    with ThreadPoolExecutor() as pool:
        t0 = time.perf_counter()
        reports = {n: pool.submit(ptxas_report, n) for n in kernel_names()}
        secs = build_all()
        t1 = time.perf_counter()
        native.load()
        log(f"phase 1 ok: nvcc build {secs:.2f} s, g++ build "
            f"{time.perf_counter() - t1:.2f} s")
        log_register_use({n: f.result() for n, f in reports.items()})
    log(f"  register report {time.perf_counter() - t0:.1f} s, compiled "
        f"beside the build")


def kernel_label(mangled: str) -> str:
    """``name<type, D>`` of a mangled kernel instantiation such as
    ``..._12dk_dv_kernelIfLi16EE...`` (the name's length precedes it, and
    may follow hex digits of the file's hash)."""
    import re

    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            name = mangled[m.end():m.end() + int(m.group()[i:])]
            if not name.endswith("_kernel"):
                continue
            rest = mangled[m.end() + len(name):]
            args = re.match(r"I((?:13__nv_bfloat16|f|Lb[01]E|Li\d+E)+)E",
                            rest)
            if not args:
                return name
            words = {"f": "f32", "13__nv_bfloat16": "bf16", "Lb1E": "true",
                     "Lb0E": "false"}
            return name + "<" + ", ".join(
                words.get(a, a[2:-1]) for a in re.findall(
                    r"13__nv_bfloat16|Lb[01]E|Li\d+E|f", args.group(1))
            ) + ">"
    return mangled[:60]


def ptxas_report(name: str) -> str:
    """ptxas's report of ``csrc/{name}.cu`` (``nvcc -Xptxas -v -c``)."""
    from treemorph_tpu_torch.ops.cuda import CSRC_DIR, _nvcc

    with tempfile.TemporaryDirectory() as tmp:
        return subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "k.o"), os.path.join(CSRC_DIR, f"{name}.cu")],
            capture_output=True, text=True, check=True).stderr


def log_register_use(reports: dict):
    """Registers, shared memory and spills of every kernel instantiation as
    ptxas reports them (``reports``: :func:`ptxas_report` by source)."""
    import re

    for name, text in reports.items():
        entry, spills = "", ""
        for line in text.splitlines():
            found = re.search(r"entry function '(\S+)'", line)
            if found:
                entry = kernel_label(found.group(1))
            elif "spill" in line:
                spills = line.strip()
            elif "Used" in line and entry:
                log(f"  ptxas {name}: {entry}: {line.split(':', 1)[1].strip()}"
                    f"; {spills}")


def level_sets(coords, batch_ids, valid, batch_size, capacity):
    """(coords, valid) of the three voxel levels TreeLearn builds for these
    points (level capacities as ``UBlock`` sets them), and the level-0
    voxel count."""
    import torch

    from treemorph_tpu_torch.ops.sparse import build_downsample
    from treemorph_tpu_torch.ops.voxelize import voxelize_treelearn_features

    vox = voxelize_treelearn_features(
        coords, torch.zeros((coords.shape[0], 4), device=coords.device),
        batch_ids, valid, 0.02, batch_size, capacity=capacity,
    )
    c, v = vox.voxel_coords, vox.voxel_valid
    levels = []
    for level in range(3):
        levels.append((c, v))
        if level < 2:
            m = c.shape[0]
            ds = build_downsample(c, v, min(max(m // 2, 256), m))
            c, v = ds.coarse_coords, ds.coarse_valid
    return levels, int(vox.num_voxels)


def band_plans(levels, kernel_size=3):
    """One band plan per (coords, valid) level."""
    from treemorph_tpu_torch.ops.bandconv import build_band_plan
    from treemorph_tpu_torch.ops.sparse import build_rulebook

    return [build_band_plan(build_rulebook(c, v, kernel_size), v)
            for c, v in levels]


def level_plans(coords, batch_ids, valid, batch_size, capacity,
                kernel_size=3):
    """Band plans of the three levels TreeLearn builds for these points
    (``kernel_size`` 3: K = 27; 5: K = 125), and the level-0 voxel
    count."""
    levels, n_voxels = level_sets(coords, batch_ids, valid, batch_size,
                                  capacity)
    return band_plans(levels, kernel_size), n_voxels


def e2e_levels(points, device):
    """(coords, valid) of the three levels the e2e cloud's stage 1
    builds."""
    import torch

    from treemorph_tpu_torch.pipeline.predict import pad_to_bucket

    p = pad_to_bucket(len(points))
    coords = torch.zeros((p, 3), dtype=torch.float32, device=device)
    coords[: len(points)] = torch.from_numpy(points).to(device)
    valid = torch.arange(p, device=device) < len(points)
    batch_ids = torch.zeros(p, dtype=torch.int32, device=device)
    return level_sets(coords, batch_ids, valid, 1, p // 2)[0]


def e2e_level_plans(points, device):
    """Band plans of the three levels the e2e cloud's stage 1 builds."""
    return band_plans(e2e_levels(points, device))


def window_counts(rb_tiles, starts, m, win) -> tuple[int, int, int]:
    """What the band kernels do and read on a plan: the rulebook entries
    they apply (found and inside the window of their (tile, group)), the
    distinct rows those entries name (the feature rows the forward reads;
    the gradient rows the backward reads) and the rows that own one (the
    feature rows the weight gradient reads). Every other row of the
    padded tile grid is never read."""
    import torch

    from treemorph_tpu_torch.ops.bandconv import in_window

    idx, ok = in_window(rb_tiles, starts, m, win)
    return (int(ok.sum()), int(torch.unique(idx[ok]).numel()),
            int(ok.any(dim=1).sum()))


def plan_counts(plan) -> tuple[int, int, int]:
    """:func:`window_counts` of a band plan."""
    return window_counts(plan.rb_tiles, plan.starts, plan.rulebook.shape[0],
                         plan.win)


def phase_kernel_vs_plain(points, device):
    """Returns the per-forward kernel record (bf16, the main path's type)
    and the per-shape rows."""
    import torch

    from treemorph_tpu_torch.ops.bandconv import (
        TILE,
        band_conv_padded,
        band_conv_padded_plain,
    )

    plans = e2e_level_plans(points, device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows, worst = [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "bytes": 0.0, "flops": 0.0, "bound_tc_ms": 0.0}
    for level, cin, cout, count in LEVEL_CONVS:
        plan = plans[level]
        m = plan.rulebook.shape[0]
        mp = plan.rb_tiles.shape[0] * TILE
        # found in-window entries: the kernel's multiply-adds per
        # (input, output) channel pair on this level's data; the feature
        # rows they name are all the kernel reads of the features
        nnz, rows_named, _ = plan_counts(plan)
        w = torch.randn((27, cin, cout), device=device, generator=gen)
        w /= (27 * cin) ** 0.5
        for dtype in (torch.bfloat16, torch.float32):
            feats = torch.zeros((mp, cin), device=device)
            feats[:m] = torch.randn((m, cin), device=device, generator=gen)
            feats = (feats * torch.nn.functional.pad(
                plan.valid, (0, mp - m))[:, None]).to(dtype)
            args = (plan.rb_tiles, plan.starts, feats, w, m, plan.win)
            out = band_conv_padded(*args)
            torch.cuda.synchronize()
            ref = band_conv_padded_plain(*args)
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            if not (err <= KERNEL_RTOL * scale and torch.isfinite(out).all()):
                raise AssertionError(
                    f"band_conv L{level} {cin}->{cout} {dtype}: max |err| "
                    f"{err:.3e} > {KERNEL_RTOL} x {scale:.3e}"
                )
            worst = max(worst, err)
            repeats = bool(torch.equal(out, band_conv_padded(*args)))
            ms = cuda_ms(lambda: band_conv_padded(*args), 20)
            plain_ms = cuda_ms(lambda: band_conv_padded_plain(*args), 5)
            nbytes = (mp * 27 * 4 + 9 * plan.rb_tiles.shape[0] * 4
                      + rows_named * cin * feats.element_size()
                      + 27 * cin * cout * 4 + mp * cout * 4)
            flops = 2.0 * nnz * cin * cout
            bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                 flops / F32_FLOPS)
            row = dict(level=level, cin=cin, cout=cout, dtype=str(dtype),
                       m=m, nnz=nnz, rows_read=rows_named,
                       launches_per_forward=count,
                       max_abs_err=err, err_over_scale=err / scale,
                       repeats_bit_for_bit=repeats, ms=ms,
                       simt_historical_ms=SIMT_HISTORICAL_MS.get(
                           ("fwd", level, cin, cout, str(dtype))),
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                       > flops / F32_FLOPS else "operations",
                       **tc_bound(nbytes, flops, BAND_TC[str(dtype)]))
            rows.append(row)
            log("kernel " + json.dumps(row))
            if dtype == torch.bfloat16:
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("bound_ms", bound_ms), ("bytes", nbytes),
                                 ("flops", flops),
                                 ("bound_tc_ms", row["bound_tc_ms"])):
                    totals[key] += count * val
    shape = "; ".join(
        f"L{level} ({plans[level].rb_tiles.shape[0] * TILE}, {cin})->"
        f"({plans[level].rb_tiles.shape[0] * TILE}, {cout}) x{count}"
        for level, cin, cout, count in LEVEL_CONVS
    )
    record = {
        "name": "band_conv",
        "route": "cuda",
        "source": "treemorph_tpu_torch/csrc/band_conv.cu",
        "replaces": "treemorph_tpu/ops/bandconv.py:190",
        "shape": shape,
        "max_abs_err": worst,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if totals["bytes"] / HBM_BYTES_PER_S
        > totals["flops"] / F32_FLOPS else "operations",
        "library_ms": None,
        "bound_tc_ms": totals["bound_tc_ms"],
        "max_err_over_scale": max(r["err_over_scale"] for r in rows),
    }
    log(f"phase 2 ok: band_conv within {KERNEL_RTOL} x scale of plain at "
        f"{len(rows)} shape/type cases (a second call bit-identical in "
        f"{sum(r['repeats_bit_for_bit'] for r in rows)}); one forward's "
        f"21 launches (bf16): "
        f"kernel {totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, "
        f"bound {totals['bound_ms']:.3f} ms at the f32 rate, "
        f"{totals['bound_tc_ms']:.3f} ms in the kernel's passes")
    return record, rows


def tc_bound(nbytes: float, flops: float, rate_passes) -> dict:
    """The bound at the tensor-core arithmetic a kernel uses: the bytes at
    the HBM rate against ``passes`` times the multiply-adds at ``rate``,
    and which of the two sets it."""
    rate, passes = rate_passes
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, passes * flops / rate
    return {"bound_tc_ms": 1e3 * max(bytes_s, ops_s),
            "bound_tc_by": "bytes" if bytes_s > ops_s else "operations"}


def phase_stage1_card_vs_cpu(points, device, models=None, name="phase 3"):
    """Stage 1's offset forward on a 20,000-point cut, card against CPU:
    ``models(device)`` gives the (offset, noise) predictors on a device
    (default :func:`pipeline_models`)."""
    import numpy as np

    models = models or pipeline_models

    from treemorph_tpu_torch.pipeline.predict import _pad_flat

    rng = np.random.default_rng(3)
    cut = points[rng.choice(len(points), min(20_000, len(points)),
                            replace=False)]
    feats = np.zeros((len(cut), 4), np.float32)
    outs = []
    for dev in (device, "cpu"):
        offset_model, _ = models(dev)
        coords, f, b, v, n = _pad_flat(cut, feats, device=dev)
        res = offset_model.predict_flat(coords, f, b, v)
        outs.append({
            k: res[k][:n].float().cpu().numpy()
            for k in ("offset_predictions", "semantic_prediction_logits")
        })
    card, cpu = outs
    off_err = float(np.abs(card["offset_predictions"]
                           - cpu["offset_predictions"]).max())
    off_scale = float(np.abs(cpu["offset_predictions"]).max())
    agree = float((card["semantic_prediction_logits"].argmax(1)
                   == cpu["semantic_prediction_logits"].argmax(1)).mean())
    finite = all(np.isfinite(o[k]).all() for o in outs for k in o)
    log(f"stage 1 card vs cpu on {len(cut)} points: offsets max |err| "
        f"{off_err:.3e} (scale {off_scale:.3e}, limit "
        f"{STAGE1_OFFSET_RTOL} x scale), noise argmax agreement {agree:.5f} "
        f"(limit {STAGE1_ARGMAX_AGREEMENT})")
    if not (finite and off_err <= STAGE1_OFFSET_RTOL * off_scale
            and agree >= STAGE1_ARGMAX_AGREEMENT):
        raise AssertionError("stage 1 on the card disagrees with the CPU")
    log(f"{name} ok")


class _RetryCounter(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.retries = 0

    def emit(self, record):
        if "retrying" in record.getMessage():
            self.retries += 1


def plot_end_to_end(cloud, model_type, models, device, kernel, per_forward,
                    overflow_routes=None, csv_out=None):
    """``run_pipeline`` on ``cloud`` with ``model_type``'s offset and noise
    predictors ``models``, each of its three stages timed inside that call
    (the device synchronized at each stage's ends), with the run's peak
    device memory. Checks the run and that ``kernel`` launched
    ``per_forward`` times in each forward, less the calls that
    ``overflow_routes`` (a counter the run adds to, such as the band convs'
    ``GATHER_ROUTES``) sent elsewhere (``kernel`` None: a family whose
    path has no hand kernel); returns its launches and the stage record.
    ``csv_out``: a path the run's cylinder CSV is copied to."""
    import numpy as np
    import torch

    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.pipeline import run as pipeline_run

    offset_model, noise_model = models
    stage_s = {}

    def timed(stage, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_s[stage] = stage_s.get(stage, 0.0) + time.perf_counter() - t
            return out
        return call

    stages = {"stage1": "make_predictions", "upsample": "upsample",
              "qsm": "fit_qsm"}
    saved = {attr: getattr(pipeline_run, attr) for attr in stages.values()}
    predict_log = logging.getLogger("treemorph_tpu_torch.pipeline.predict")
    retries = _RetryCounter()
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "input")
        os.makedirs(inp)
        np.save(os.path.join(inp, "plot.npy"), cloud)
        cfg = pipeline_config(inp, os.path.join(tmp, "output"), model_type)

        predict_log.addHandler(retries)
        if overflow_routes is not None:
            overflow_routes.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        for stage, attr in stages.items():
            setattr(pipeline_run, attr, timed(stage, saved[attr]))
        t0 = time.perf_counter()
        try:
            results = pipeline_run.run_pipeline(cfg, offset_model,
                                                noise_model, device=device)
        finally:
            for attr, fn in saved.items():
                setattr(pipeline_run, attr, fn)
        e2e_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        predict_log.removeHandler(retries)
        launches = LAUNCHES[kernel] if kernel else 0
        routes = sum((overflow_routes or {}).values())
        expected = per_forward * (2 + retries.retries) - routes
        log(f"run_pipeline ({model_type}): {e2e_s:.2f} s, peak device "
            f"memory {peak_gb:.2f} GB, results {results}")
        log(f"{kernel} launches {launches}, expected {expected} "
            f"({2 * per_forward} per predict_single; retries "
            f"{retries.retries}, routed elsewhere {routes}); "
            f"all launches {dict(LAUNCHES)}")
        out_dir = os.path.join(tmp, "output", model_type)
        stage1 = np.load(os.path.join(out_dir, "plot_pred_denoised.npy"))
        csv = os.path.join(out_dir, "plot_qsm_depth_cylinders.csv")
        checks = {
            "one result": len(results) == 1,
            "kept points > 0": len(stage1) > 0,
            "finite stage 1": bool(np.isfinite(stage1).all()),
            f">= {MIN_POINTS} upsampled points": len(results) == 1
            and results[0]["points"] >= MIN_POINTS,
            "cylinders > 0": len(results) == 1
            and results[0]["cylinders"] > 0,
            "CSV written": os.path.exists(csv),
            "launch count": kernel is None
            or (launches == expected and launches > 0),
        }
        for name, ok in checks.items():
            log(f"  {'ok ' if ok else 'FAIL'} {name}")
        if not all(checks.values()):
            raise AssertionError(f"{model_type} end-to-end checks failed")
        if csv_out is not None:
            shutil.copyfile(csv, csv_out)
        record = {
            "model_type": model_type,
            "e2e_raw_points": len(cloud),
            "e2e_stage1_kept_points": len(stage1),
            "e2e_upsampled_points": results[0]["points"],
            "e2e_cylinders": results[0]["cylinders"],
            "e2e_stage1_seconds": stage_s.get("stage1", 0.0),
            "e2e_upsample_seconds": stage_s.get("upsample", 0.0),
            "e2e_qsm_seconds": stage_s.get("qsm", 0.0),
            "e2e_plot_seconds": results[0]["seconds"],
            "run_pipeline_seconds": e2e_s,
            "run_pipeline_peak_memory_gb": peak_gb,
        }
        log(json.dumps(record))
    return launches, record


def phase_end_to_end(points, device, csv_out=None):
    from treemorph_tpu_torch.ops import bandconv

    launches, _ = plot_end_to_end(points, "treelearn",
                                  pipeline_models(device), device,
                                  "band_conv", 21, bandconv.GATHER_ROUTES,
                                  csv_out=csv_out)
    log("phase 4 ok")
    return launches


def synthetic_labeled_trees(rng, trees: int, n: int):
    """``trees`` labeled trees of ``n`` points each, built as
    scripts/bench_training.py:35-63 builds its elements: a synthetic tree
    at 4,000 points/m^2, cut to ``n`` or tiled with N(0, 0.005) jitter;
    (points, N(0, 0.02) offsets, random features), float32, drawn from
    ``rng`` in turn."""
    import numpy as np

    from treemorph_tpu_torch.fixtures import (
        synthetic_qsm,
        synthetic_tree_cloud,
    )

    for _ in range(trees):
        qsm = synthetic_qsm(rng=rng)
        pts, _ = synthetic_tree_cloud(qsm=qsm, points_per_m2=4000, rng=rng)
        if len(pts) >= n:
            pts = pts[:n]
        else:
            reps = -(-n // len(pts))
            pts = np.tile(pts, (reps, 1))[:n] + rng.normal(
                0, 0.005, (n, 3)
            ).astype(np.float32)
        offsets = rng.normal(0, 0.02, (n, 3)).astype(np.float32)
        feats = rng.normal(size=(n, 4)).astype(np.float32)
        yield pts.astype(np.float32), offsets, feats


def write_training_plots(root: str) -> None:
    """Three plots of 30 synthetic labeled trees (the (N, 11) layout,
    :func:`synthetic_labeled_trees`) and their ``plot_{n}.json`` manifests
    under ``root``, from numpy seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    for plot in range(1, TRAIN_PLOTS + 1):
        paths = []
        trees = synthetic_labeled_trees(rng, TRAIN_TREES, TRAIN_POINTS)
        for tree, (pts, offsets, feats) in enumerate(trees):
            cloud = np.zeros((TRAIN_POINTS, 11), np.float32)
            cloud[:, :3] = pts
            cloud[:, 3:6] = offsets
            cloud[:, 7:11] = feats
            path = os.path.join(root, f"{plot}_{tree}_labeled.npy")
            np.save(path, cloud)
            paths.append(path)
        with open(os.path.join(root, f"plot_{plot}.json"), "w") as f:
            json.dump(paths, f)


def first_training_batch(root: str, device):
    """The first 30-tree batch of the CV fold that holds out plot 1, as
    tensors on ``device``, and the level-0 voxel capacity the training CLI
    works out for that fold."""
    from treemorph_tpu_torch.data import batch_iterator, get_plot_split
    from treemorph_tpu_torch.train.cli import level0_capacity
    from treemorph_tpu_torch.train.harness import to_device

    trainset, valset = get_plot_split(root, 1)
    capacity = level0_capacity((trainset, valset), TRAIN_TREES, 0.02)
    batch = next(batch_iterator(trainset, TRAIN_TREES, TRAIN_POINTS,
                                shuffle=False))
    return to_device(batch, device), capacity


def training_model(capacity, batch_size, engine="band",
                   conv_dtype="bfloat16", kernel_size=3):
    """The training CLI's TreeLearn (channels 32, num_blocks 3, dim_feat 4,
    voxel 0.02) with seeded weights, on the CPU; ``kernel_size`` 5 makes
    every conv 5x5x5 (K = 125)."""
    from treemorph_tpu_torch.models.treelearn import TreeLearn
    from treemorph_tpu_torch.train.families import init_treelearn

    model = TreeLearn(channels=32, num_blocks=3, dim_feat=4, voxel_size=0.02,
                      batch_size=batch_size, engine=engine,
                      conv_dtype=conv_dtype, voxel_capacity=capacity,
                      kernel_size=kernel_size)
    return init_treelearn(model, 0)


def phase_bwd_kernel_vs_plain(batch, capacity, device, kernel_size=3):
    """Returns the per-step backward kernel record (bf16) and the band
    forward and backward kernel ms per training step at these shapes, for
    the training model's convs at ``kernel_size`` (3: K = 27; 5: K = 125,
    ``TreeLearn(kernel_size=5)``)."""
    import torch

    from treemorph_tpu_torch.ops.bandconv import (
        TILE,
        band_conv_bwd_padded,
        band_conv_bwd_padded_plain,
        band_conv_dw_padded,
        band_conv_padded,
    )
    from treemorph_tpu_torch.train.families import _flatten_padded

    k = kernel_size ** 3
    flat = _flatten_padded(batch)
    plans, n_voxels = level_plans(flat["coords"], flat["batch_ids"],
                                  flat["mask_valid"], TRAIN_TREES, capacity,
                                  kernel_size)
    log(f"training batch, K = {k}: {int(flat['mask_valid'].sum())} points, "
        f"{n_voxels} level-0 voxels in capacity {capacity}; level rows "
        + ", ".join(
            f"L{i} {p.rulebook.shape[0]} ({int(p.valid.sum())} voxels, "
            f"{int(p.res_valid.sum())} residual rows, ok {bool(p.ok)})"
            for i, p in enumerate(plans)
        ))
    if n_voxels > capacity:
        raise AssertionError(f"capacity {capacity} drops voxels ({n_voxels})")
    gen = torch.Generator(device=device).manual_seed(1)

    def rows_of(plan, width, dtype):
        m = plan.rulebook.shape[0]
        x = torch.zeros((plan.rb_tiles.shape[0] * TILE, width), device=device)
        x[:m] = torch.randn((m, width), device=device, generator=gen)
        x[:m] *= plan.valid[:, None]
        return x.to(dtype)

    rows, worst, worst_rel = [], 0.0, 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_s": 0.0,
              "ops_s": 0.0, "fwd_ms": 0.0, "fwd_bound_ms": 0.0,
              "d_feats_ms": 0.0, "d_w_ms": 0.0, "bound_tc_ms": 0.0,
              "fwd_bound_tc_ms": 0.0}
    for level, cin, cout, count in LEVEL_CONVS:
        plan = plans[level]
        m = plan.rulebook.shape[0]
        mp = plan.rb_tiles.shape[0] * TILE
        plan_bytes = (plan.rb_tiles.numel() + plan.starts.numel()) * 4
        # in-window entries; the rows they name (the features the forward
        # reads, the gradient rows both backward launches read) and the
        # rows that own one (the features d_w reads)
        nnz, rows_named, rows_owning = plan_counts(plan)
        w = torch.randn((k, cin, cout), device=device, generator=gen)
        w /= (k * cin) ** 0.5
        w_bwd = w.flip(0).transpose(1, 2).contiguous()
        for dtype in (torch.bfloat16, torch.float32):
            feats = rows_of(plan, cin, dtype)
            elem = feats.element_size()
            fwd_ms = cuda_ms(lambda: band_conv_padded(
                plan.rb_tiles, plan.starts, feats, w, m, plan.win), 20)
            fwd_bytes = (plan_bytes + rows_named * cin * elem
                         + k * cin * cout * 4 + mp * cout * 4)
            fwd_flops = 2.0 * nnz * cin * cout
            fwd_bound_ms = 1e3 * max(fwd_bytes / HBM_BYTES_PER_S,
                                     fwd_flops / F32_FLOPS)
            fwd_tc = tc_bound(fwd_bytes, fwd_flops, BAND_TC[str(dtype)])
            if dtype == torch.bfloat16:
                totals["fwd_ms"] += count * fwd_ms
                totals["fwd_bound_ms"] += count * fwd_bound_ms
                totals["fwd_bound_tc_ms"] += count * fwd_tc["bound_tc_ms"]
            if cin == 7:  # the stem takes the gather formulation backward
                continue
            grad = rows_of(plan, cout, dtype)
            args = (plan.rb_tiles, plan.starts, grad, feats, w_bwd, m,
                    plan.win)
            d_f, d_w = band_conv_bwd_padded(*args)
            torch.cuda.synchronize()
            r_f, r_w = band_conv_bwd_padded_plain(*args)
            errs = {}
            for name, out, ref in (("d_feats", d_f, r_f), ("d_w", d_w, r_w)):
                err = float((out - ref).abs().max())
                scale = float(ref.abs().max())
                errs[name] = err
                worst_rel = max(worst_rel, err / scale)
                if not (err <= KERNEL_RTOL * scale
                        and torch.isfinite(out).all()):
                    raise AssertionError(
                        f"band_conv_bwd K={k} {name} L{level} {cin}->{cout} "
                        f"{dtype}: max |err| {err:.3e} > {KERNEL_RTOL} x "
                        f"{scale:.3e}"
                    )
            worst = max(worst, *errs.values())
            again = band_conv_bwd_padded(*args)
            repeats = bool(torch.equal(d_f, again[0])
                           and torch.equal(d_w, again[1]))
            ms = cuda_ms(lambda: band_conv_bwd_padded(*args), 20)
            d_feats_ms = cuda_ms(lambda: band_conv_padded(
                plan.rb_tiles, plan.starts, grad, w_bwd, m, plan.win), 20)
            d_w_ms = cuda_ms(lambda: band_conv_dw_padded(
                plan.rb_tiles, plan.starts, grad, feats, m, plan.win), 20)
            plain_ms = cuda_ms(lambda: band_conv_bwd_padded_plain(*args), 3)
            # each input read once (rulebook, anchors, the gradient rows
            # and feature rows the kernels read, filters), each output
            # written once (d_feats, d_w)
            nbytes = (plan_bytes + rows_named * cout * elem
                      + rows_owning * cin * elem + k * cin * cout * 4
                      + mp * cin * 4 + k * cin * cout * 4)
            # d_feats and d_w: one multiply-add per entry and channel pair
            # each. d_feats multiplies by f32 weights (f32 rate); d_w
            # multiplies features by the output gradient, both bf16 in
            # bf16 mode (tensor-core rate)
            flops = 2.0 * nnz * cin * cout
            dw_rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
            ops_s = flops / F32_FLOPS + flops / dw_rate
            bytes_s = nbytes / HBM_BYTES_PER_S
            bound_ms = 1e3 * max(bytes_s, ops_s)
            # at the kernels' own arithmetic: d_feats in the forward's
            # passes, d_w in its own
            (f_rate, f_passes), (w_rate, w_passes) = (BAND_TC[str(dtype)],
                                                      DW_TC[str(dtype)])
            tc = tc_bound(nbytes, flops, (1.0, f_passes / f_rate
                                          + w_passes / w_rate))
            # the SIMT kernels' historical times exist for K = 27 only
            key = (level, cin, cout, str(dtype)) if k == 27 else None
            row = dict(k=k, level=level, cin=cin, cout=cout,
                       dtype=str(dtype), m=m, nnz=nnz,
                       gradient_rows_read=rows_named,
                       feature_rows_read=rows_owning,
                       launches_per_step=count,
                       err_d_feats=errs["d_feats"], err_d_w=errs["d_w"],
                       repeats_bit_for_bit=repeats,
                       ms=ms, d_feats_ms=d_feats_ms, d_w_ms=d_w_ms,
                       simt_historical_ms=SIMT_HISTORICAL_MS.get(
                           key and ("bwd",) + key),
                       simt_historical_d_feats_ms=SIMT_HISTORICAL_MS.get(
                           key and ("bwd_d_feats",) + key),
                       simt_historical_fwd_ms=SIMT_HISTORICAL_MS.get(
                           key and ("train_fwd",) + key),
                       fwd_ms=fwd_ms, fwd_bound_ms=fwd_bound_ms,
                       fwd_bound_tc_ms=fwd_tc["bound_tc_ms"],
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by="bytes" if bytes_s > ops_s
                       else "operations", **tc)
            rows.append(row)
            log("kernel " + json.dumps(row))
            if dtype == torch.bfloat16:
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("bound_ms", bound_ms), ("bytes_s", bytes_s),
                                 ("ops_s", ops_s), ("d_feats_ms", d_feats_ms),
                                 ("d_w_ms", d_w_ms),
                                 ("bound_tc_ms", tc["bound_tc_ms"])):
                    totals[key] += count * val
    shape = "; ".join(
        f"L{level} ({plans[level].rb_tiles.shape[0] * TILE}, {cout}) grad, "
        f"({plans[level].rb_tiles.shape[0] * TILE}, {cin}) feats x{count}"
        for level, cin, cout, count in LEVEL_CONVS if cin != 7
    )
    record = {
        "name": "band_conv_bwd",
        "route": "cuda",
        "source": "treemorph_tpu_torch/csrc/band_conv_bwd.cu",
        "replaces": "treemorph_tpu/ops/bandconv.py:244",
        "k": k,
        "plans_ok": [bool(p.ok) for p in plans],
        "shape": shape,
        "max_abs_err": worst,
        "max_err_over_scale": worst_rel,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if totals["bytes_s"] > totals["ops_s"]
        else "operations",
        "library_ms": None,
        "bound_tc_ms": totals["bound_tc_ms"],
        "d_feats_ms": totals["d_feats_ms"],
        "d_w_ms": totals["d_w_ms"],
    }
    per_step = {"band_forward_ms_per_step": totals["fwd_ms"],
                "band_forward_bound_ms_per_step": totals["fwd_bound_ms"],
                "band_forward_bound_tc_ms_per_step":
                    totals["fwd_bound_tc_ms"],
                "band_backward_ms_per_step": totals["ms"],
                "band_backward_d_feats_ms_per_step": totals["d_feats_ms"],
                "band_backward_d_w_ms_per_step": totals["d_w_ms"]}
    log(f"phase 5 ok, K = {k}: band_conv_bwd within {KERNEL_RTOL} x scale "
        f"of plain at {len(rows)} shape/type cases (worst {worst_rel:.2e} "
        f"of scale; "
        f"a second call bit-identical in "
        f"{sum(r['repeats_bit_for_bit'] for r in rows)}); "
        f"one step's {BWD_PER_STEP} calls (bf16): {totals['ms']:.3f} ms "
        f"(d_feats {totals['d_feats_ms']:.3f} ms, d_w "
        f"{totals['d_w_ms']:.3f} ms), plain {totals['plain_ms']:.3f} ms, "
        f"bound "
        f"{totals['bound_ms']:.3f} ms at the f32 rate, "
        f"{totals['bound_tc_ms']:.3f} ms in the kernels' passes; the step's "
        f"21 forward launches {totals['fwd_ms']:.3f} ms, bound "
        f"{totals['fwd_bound_ms']:.3f} ms at the f32 rate, "
        f"{totals['fwd_bound_tc_ms']:.3f} ms in the kernel's passes")
    return record, per_step


def one_train_step(batch, engine, conv_dtype, device, kernel_size=3):
    """Loss and parameter gradients (clipped as the step clips them) of one
    ``make_train_step`` of the training model on ``batch``, on ``device``;
    ``conv_dtype="float64"`` runs the whole model in float64."""
    import torch

    from treemorph_tpu_torch.train import families, harness

    model = training_model(None, batch.batch_size, engine, conv_dtype,
                           kernel_size).to(device)
    if conv_dtype == "float64":
        model = model.to(torch.float64)
    forward_fn, loss_fn = families.treelearn_family()
    state = harness.TrainState(model, harness.make_optimizer(model))
    step = harness.make_train_step(forward_fn, loss_fn)
    _, metrics = step(state, batch.map(lambda a: a.to(device)), 1e-2)
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    return float(metrics["loss"]), grads


def compare_steps(label, a, b, loss_rtol, grad_rtol, zero_grad=None):
    """Raise unless the losses of two steps agree to ``loss_rtol`` and
    every parameter gradient to ``grad_rtol`` of the step's largest
    gradient; logs the worst error relative to its own parameter's scale
    too. The parameters ``zero_grad`` names (exact gradient 0: a BatchNorm
    removes their shift) are rounding noise that grows with the rows
    summed; they are held below ZERO_GRAD_RTOL of the largest in both."""
    (loss_a, grads_a), (loss_b, grads_b) = a, b
    top = max(float(g.abs().max()) for g in grads_b.values())
    worst, worst_own, own_name, noise = 0.0, 0.0, "", 0.0
    for name, ref in grads_b.items():
        if zero_grad is not None and zero_grad(name):
            noise = max(noise, float(ref.abs().max()) / top,
                        float(grads_a[name].abs().max()) / top)
            continue
        err = float((grads_a[name] - ref).abs().max())
        worst = max(worst, err / top)
        own = err / max(float(ref.abs().max()), 1e-30)
        if own > worst_own:
            worst_own, own_name = own, name
    loss_rel = abs(loss_a - loss_b) / abs(loss_b)
    log(f"{label}: loss {loss_a:.7f} vs {loss_b:.7f} (rel {loss_rel:.2e}, "
        f"limit {loss_rtol}); gradients within {worst:.2e} of the largest "
        f"{top:.3e} (limit {grad_rtol}) over {len(grads_b)} parameters; "
        f"worst against its own scale {worst_own:.2e} ({own_name})"
        + (f"; zero-gradient parameters within {noise:.2e} of the largest "
           f"(limit {ZERO_GRAD_RTOL})" if zero_grad is not None else ""))
    if not (loss_rel <= loss_rtol and worst <= grad_rtol
            and noise <= ZERO_GRAD_RTOL):
        raise AssertionError(f"{label} disagree")


def phase_conv_backward_in_autograd(batch, capacity, device):
    """Each band conv of a full-width f32 train step, differentiated alone
    through ``subm_conv_apply`` (the autograd Function and the backward
    kernel) against the gather formulation's backward on the same inputs,
    twice: with the cotangent the step's own backward gave it (whose terms
    largely cancel: BatchNorms surround the conv) and with a random one.
    ``d_feats`` and ``d_w`` each within ``KERNEL_RTOL`` of their scale."""
    import torch

    from treemorph_tpu_torch.models.treelearn import SubMConv
    from treemorph_tpu_torch.ops.bandconv import BandPlan
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.ops.sparse import _gather_grads, subm_conv_apply
    from treemorph_tpu_torch.train.families import treelearn_family
    from treemorph_tpu_torch.train.harness import LOSS_BACKWARD_SCALE

    model = training_model(capacity, TRAIN_TREES, "band",
                           "float32").to(device)
    captured = []  # [module, (feats, plan, valid), the step's cotangent]

    def keep(mod, args, out):
        entry = [mod, args, None]
        captured.append(entry)
        out.register_hook(lambda g: entry.__setitem__(2, g))

    handles = [
        m.register_forward_hook(keep) for m in model.modules()
        if isinstance(m, SubMConv) and m is not model.backbone.input_conv
    ]
    forward_fn, loss_fn = treelearn_family()
    loss, _ = loss_fn(forward_fn(model, batch, True), batch)
    (loss * LOSS_BACKWARD_SCALE).backward()
    for handle in handles:
        handle.remove()
    gen = torch.Generator(device=device).manual_seed(2)
    torch.cuda.synchronize()
    reset_launches()
    worst, planned = {"step": 0.0, "random": 0.0}, 0
    for mod, (x, ctx, valid), g_step in captured:
        planned += isinstance(ctx, BandPlan) and bool(ctx.ok)
        g_random = torch.randn(g_step.shape, device=device, generator=gen)
        for kind, g in (("step", g_step), ("random", g_random)):
            x = x.detach().requires_grad_()
            w = mod.kernel.detach().clone().requires_grad_()
            subm_conv_apply(x, w, ctx, valid,
                            compute_dtype=torch.float32).backward(g)
            rulebook = ctx.rulebook if isinstance(ctx, BandPlan) else ctx
            ref_x, ref_w = _gather_grads(torch.float32, x.detach(),
                                         w.detach(), rulebook, valid, g)
            for label, got, ref in (("d_feats", x.grad, ref_x),
                                    ("d_w", w.grad, ref_w)):
                err = float((got - ref).abs().max())
                scale = float(ref.abs().max())
                worst[kind] = max(worst[kind], err / scale)
                if not (err <= KERNEL_RTOL * scale
                        and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"{label} of a {tuple(w.shape)} conv, {kind} "
                        f"cotangent: max |err| {err:.3e} > {KERNEL_RTOL} x "
                        f"{scale:.3e}")
    launches = LAUNCHES["band_conv_bwd"]
    log(f"phase 6a: {len(captured)} convs of a full-width f32 train step, "
        f"each differentiated alone: band backward within "
        f"{worst['step']:.2e} of scale of the gather backward with the "
        f"step's own cotangents and {worst['random']:.2e} with random ones "
        f"(limit {KERNEL_RTOL}); band_conv_bwd launches {launches} for "
        f"{planned} band plans, twice each")
    if not (len(captured) == BWD_PER_STEP and launches == 2 * planned > 0):
        raise AssertionError("the band backward did not run for every conv")


def leaf_error(a, b) -> dict:
    """Max |a - b| per gradient leaf of two steps."""
    return {n: float((a[1][n].double() - b[1][n].double()).abs().max())
            for n in b[1]}


def compare_engine_steps(band, gather, ref):
    """Raise unless the band and gather f32 steps on the card agree: the
    losses to ENGINE_LOSS_RTOL and every gradient within ENGINE_RTOL of the
    step's largest. Logs both steps' errors against the float64 step
    ``ref``, relative to each leaf's own scale, on the leaves where the
    band step's is largest."""
    band_err, gather_err = leaf_error(band, ref), leaf_error(gather, ref)
    diff = leaf_error(band, gather)
    top = max(float(g.abs().max()) for g in ref[1].values())
    scale = {n: max(float(g.abs().max()), 1e-30) for n, g in ref[1].items()}
    worst = max(diff.values()) / top
    loss_rel = abs(band[0] - gather[0]) / abs(gather[0])
    log(f"train step, band vs gather engine on the card, f32: loss "
        f"{band[0]:.7f} vs {gather[0]:.7f} (rel {loss_rel:.2e}, limit "
        f"{ENGINE_LOSS_RTOL}), float64 {ref[0]:.7f}; gradients within "
        f"{worst:.2e} of the largest {top:.3e} (limit {ENGINE_RTOL}) over "
        f"{len(diff)} parameters")
    # leaves whose float64 gradient is below 1e-8 of the largest are zero
    # but for rounding (a BatchNorm follows them): no scale of their own
    rows = sorted((n for n in band_err if scale[n] > 1e-8 * top),
                  key=lambda n: band_err[n] / scale[n], reverse=True)
    log(f"  errors against float64 over the leaf's own scale, band / gather, "
        f"over {len(rows)} leaves that are not zero but for rounding (worst "
        f"gather {max(gather_err[n] / scale[n] for n in rows):.2e}; worst "
        f"band leaves):")
    for name in rows[:6]:
        log(f"  {band_err[name] / scale[name]:.2e} / "
            f"{gather_err[name] / scale[name]:.2e} {name} "
            f"(scale {scale[name]:.3e})")
    tails = [n for n in rows if "tail" in n]
    if tails:
        band_tail = max(tails, key=lambda n: band_err[n] / scale[n])
        gather_tail = max(tails, key=lambda n: gather_err[n] / scale[n])
        log(f"  tail convs against float64, worst over the leaf's own "
            f"scale: band {band_err[band_tail] / scale[band_tail]:.2e} "
            f"({band_tail}), gather "
            f"{gather_err[gather_tail] / scale[gather_tail]:.2e} "
            f"({gather_tail})")
    if not (loss_rel <= ENGINE_LOSS_RTOL and worst <= ENGINE_RTOL):
        raise AssertionError("band and gather train steps disagree")


def log_repeat(label, a, b) -> None:
    """Log whether two runs of one seeded step gave bit-identical losses
    and gradients, and if not, how many leaves differ and by how much of
    their own scale."""
    import torch

    differ = sorted(
        (float((a[1][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30),
         n) for n, g in b[1].items() if not torch.equal(a[1][n], g))
    log(f"{label}: loss {a[0]!r} / {b[0]!r} "
        f"({'equal' if a[0] == b[0] else 'differ'}); {len(differ)} of "
        f"{len(b[1])} gradient leaves differ"
        + (f", most {differ[-1][0]:.2e} of its scale ({differ[-1][1]})"
           if differ else ": bit-identical"))


def deterministic_only(prefix):
    """A dispatch mode that runs the aten ops whose names start with
    ``prefix`` (forward and backward) with deterministic algorithms on and
    every other op as it is; ``.seen`` collects the ops it switched."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class DeterministicOnly(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not str(func).startswith(prefix):
                return func(*args, **(kwargs or {}))
            self.seen.add(str(func))
            torch.use_deterministic_algorithms(True, warn_only=True)
            out = func(*args, **(kwargs or {}))
            torch.use_deterministic_algorithms(False)
            return out

    return DeterministicOnly()


def phase_step_repeats(cut, device):
    """Not a gate: whether the f32 step repeats bit for bit on the card,
    band and gather engines, as it runs and with
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, which
    takes the deterministic version of every op that has one and warns
    once for each op that has none (those ops are logged); then the band
    step with one family of the ops that sum with atomics made
    deterministic at a time, to find the one that breaks repetition."""
    import warnings

    import torch

    for engine in ("band", "gather"):
        log_repeat(f"  repeat, {engine} engine f32 step, two runs",
                   one_train_step(cut, engine, "float32", device),
                   one_train_step(cut, engine, "float32", device))
    # the deterministic mode also fills new tensors with NaN by default,
    # which would change what is compared rather than the order of sums
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runs = [one_train_step(cut, "band", "float32", device)
                for _ in range(2)]
    torch.use_deterministic_algorithms(False)
    log_repeat("  repeat, band engine f32 step, deterministic algorithms",
               *runs)
    ops = sorted({str(w.message).split(" does not have")[0][:90]
                  for w in caught if "deterministic" in str(w.message)})
    log(f"  ops without a deterministic version in the step: {ops}")
    for prefix in ("aten.index_add", "aten.index_put", "aten.scatter"):
        runs = []
        for _ in range(2):
            with deterministic_only(prefix) as mode:
                runs.append(one_train_step(cut, "band", "float32", device))
        log_repeat(f"  repeat, band engine f32 step, only {prefix}* "
                   f"deterministic ({sorted(mode.seen)})", *runs)
    torch.utils.deterministic.fill_uninitialized_memory = True


def phase_train_step_checks(batch, capacity, device):
    import torch

    phase_conv_backward_in_autograd(batch, capacity, device)
    cut = batch.map(lambda a: a[:2])
    compare_engine_steps(one_train_step(cut, "band", "float32", device),
                         one_train_step(cut, "gather", "float32", device),
                         one_train_step(cut, "gather", "float64", "cpu"))
    phase_step_repeats(cut, device)
    compare_steps("train step, card vs CPU, bf16 band engine",
                  one_train_step(cut, "band", "bfloat16", device),
                  one_train_step(cut, "band", "bfloat16", "cpu"),
                  STEP_LOSS_RTOL, STEP_GRAD_RTOL)
    torch.cuda.synchronize()
    log("phase 6a ok")


def phase_training_cli(root, device):
    """The training CLI at full width; returns the backward kernel's
    launches and the run's record."""
    import math

    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import load_model
    from treemorph_tpu_torch.ops import bandconv
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.train import cli

    save_dir = os.path.join(root, "saves")
    argv = ["treelearn", "--data_root", root, "--test_plots", "1",
            "--epochs", str(TRAIN_EPOCHS), "--batch_size", str(TRAIN_TREES),
            "--bucket", str(TRAIN_POINTS), "--engine", "band",
            "--conv_dtype", "bfloat16", "--save_dir", save_dir,
            "--device", str(device)]
    log("training CLI: python -m treemorph_tpu_torch.train.cli "
        + " ".join(argv))
    bandconv.GATHER_ROUTES.clear()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    history = cli.main(argv)[1]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    routes = dict(bandconv.GATHER_ROUTES)
    steps = TRAIN_EPOCHS * (TRAIN_PLOTS - 1)
    for r in history:
        log("epoch " + json.dumps(r))
    log(f"training CLI: {secs:.2f} s for {TRAIN_EPOCHS} epochs, launches "
        f"{launches}, GATHER_ROUTES {routes}")
    ckpt = os.path.join(save_dir, "treelearn_CV")
    losses = [r[k] for r in history for k in ("train_loss", "val_loss")]
    checks = {
        f"{TRAIN_EPOCHS} epochs": len(history) == TRAIN_EPOCHS,
        "every loss finite": all(math.isfinite(x) for x in losses),
        "last train loss below the first":
            history[-1]["train_loss"] < history[0]["train_loss"],
        "checkpoint written and loadable": "O_P1" in load_model(
            "treelearn", ckpt, device=device),
        f"{BWD_PER_STEP} band_conv_bwd launches per step":
            launches.get("band_conv_bwd", 0) == BWD_PER_STEP * steps
            if not routes else
            0 < launches.get("band_conv_bwd", 0) <= BWD_PER_STEP * steps,
    }
    for name, ok in checks.items():
        log(f"  {'ok ' if ok else 'FAIL'} {name}")
    if not all(checks.values()):
        raise AssertionError("training CLI checks failed")
    log("phase 6b ok")
    return launches.get("band_conv_bwd", 0), {
        "train_cli_seconds": secs, "train_steps": steps,
        "train_losses": [r["train_loss"] for r in history],
        "val_losses": [r["val_loss"] for r in history],
        "gather_routes": routes, "launches": launches,
    }


def phase_step_split(batch, capacity, device, reps=3):
    """Seconds of a full-width training step, split into forward (with the
    loss), backward and optimizer, host clock around synchronized work;
    median of ``reps`` steps after one warm-up step; then one more step
    under ``torch.profiler``."""
    import torch

    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.train import families, harness

    model = training_model(capacity, TRAIN_TREES).to(device)
    forward_fn, loss_fn = families.treelearn_family()
    opt = harness.make_optimizer(model)
    torch.cuda.reset_peak_memory_stats(device)

    def step(times=None):
        t0 = time.perf_counter()
        out = forward_fn(model, batch, True)
        loss, _ = loss_fn(out, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        (loss * harness.LOSS_BACKWARD_SCALE).backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        harness.optimizer_step(opt, 1e-2)
        torch.cuda.synchronize()
        if times is not None:
            times.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        if not torch.isfinite(loss):
            raise AssertionError("non-finite loss in the timed steps")

    splits = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        reset_launches()
        step(splits)
    fwd, bwd, optim = (statistics.median(x) for x in zip(*splits[1:]))
    record = {
        "train_step_seconds": fwd + bwd + optim,
        "train_forward_seconds": fwd,
        "train_backward_seconds": bwd,
        "train_optimizer_seconds": optim,
        "train_points_per_step": int(batch.mask_valid.sum()),
        "train_peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "launches_per_step": dict(LAUNCHES),
    }
    log(json.dumps(record))
    record["train_step_profile"] = profile_device(step, "TreeLearn train step")
    log("phase 6c ok")
    return record


def ptv3_cloud(points):
    """The e2e cloud in the (N, 11) layout with seeded per-point features in
    columns 7:11, which ``predict_single`` hands PTv3 (dim_feat 4,
    use_feats). Without features the seeded model, whose biases start at 0,
    computes zeros everywhere."""
    import numpy as np

    cloud = np.zeros((len(points), 11), np.float32)
    cloud[:, :3] = points
    cloud[:, 7:11] = np.random.default_rng(18).normal(size=(len(points), 4))
    return cloud


def ptv3_models(device, **overrides):
    """Offset and noise predictors of the pipeline's PTv3 (seeded weights,
    ``overrides`` to its options); the noise model's semantic head prefers
    class 0 (keep), as ``pipeline_models`` does for TreeLearn."""
    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import (
        Predictor,
        build_model,
    )

    model = build_model("pointtransformerv3", device=device, seed=0,
                        **overrides)
    noise = model.clone()
    with torch.no_grad():
        noise.semantic_head.Dense_1.bias.copy_(torch.tensor([5.0, -5.0]))
    return (
        Predictor("pointtransformerv3", model, device),
        Predictor("pointtransformerv3", noise, device),
    )


def capture_attention_inputs(predictor, cloud):
    """One forward of ``predictor`` on ``cloud`` as ``predict_single`` pads
    it; returns, per distinct (W, H, K, D) shape of ``window_attention``,
    the first call's (q, k, v, seg) and the number of calls, and the
    forward's seconds (host clock, synchronized)."""
    import torch

    from treemorph_tpu_torch.ops import attention
    from treemorph_tpu_torch.pipeline.predict import _pad_flat

    calls = {}
    kernel = attention.window_attention

    def recording(q, k, v, seg):
        entry = calls.setdefault(tuple(q.shape), [(q, k, v, seg), 0])
        entry[1] += 1
        return kernel(q, k, v, seg)

    coords, f, b, valid, _ = _pad_flat(cloud[:, :3], cloud[:, 7:11],
                                       device=predictor.device)
    attention.window_attention = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict_flat(coords, f, b, valid)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        attention.window_attention = kernel
    return calls, secs


def segmented_inputs(shape, device, gen):
    """Random q, k, v of ``shape`` and seg ids of three segments per window
    in sorted runs, a tenth of the rows padding (-1) and one window all
    padding."""
    import torch

    w, h, kk, d = shape
    q, k, v = (torch.randn(shape, device=device, generator=gen)
               for _ in range(3))
    seg = torch.sort(torch.randint(0, 3, (w, kk), device=device,
                                   generator=gen), dim=1).values
    pad = torch.rand((w, kk), device=device, generator=gen) < 0.1
    seg = torch.where(pad, -1, seg).to(torch.int32)
    seg[-1] = -1
    return q, k, v, seg


def allowed_pair_count(seg) -> int:
    """Allowed (query, key) pairs per head of the windows ``seg`` (W, K):
    the work of this input, sum over windows and segments of the
    segment's rows squared."""
    import torch

    seg_runs = seg.long() + 1  # 0 = padding
    n_seg = torch.zeros((seg.shape[0], int(seg_runs.max()) + 1),
                        device=seg.device, dtype=torch.long).scatter_add_(
                            1, seg_runs, torch.ones_like(seg_runs))
    return int((n_seg[:, 1:] ** 2).sum())


def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi``), in Hz."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def phase_attention_vs_plain(cloud, device):
    """Returns the per-forward kernel record (f32, the main path's type)
    and the per-shape rows."""
    import torch
    import torch.nn.functional as F

    from treemorph_tpu_torch.ops.attention import (
        HEAD_DIMS,
        allowed_pairs,
        window_attention,
        window_attention_fwd,
        window_attention_reference,
    )

    offset_model, _ = ptv3_models(device)
    captured, fwd_s = capture_attention_inputs(offset_model, cloud)
    n_calls = sum(c for _, c in captured.values())
    if n_calls != PTV3_BLOCKS:
        raise AssertionError(f"{n_calls} window_attention calls per forward, "
                             f"expected {PTV3_BLOCKS}")
    gen = torch.Generator(device=device).manual_seed(4)
    clock = sm_clock_hz()
    exps_per_s = (SFU_PER_CLOCK * clock
                  * torch.cuda.get_device_properties(device)
                  .multi_processor_count)
    rows, worst, worst_rel, worst_lse = [], 0.0, 0.0, 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bound_ms": 0.0, "bound_tc_ms": 0.0, "bytes_s": 0.0,
              "ops_s": 0.0, "bf16_ms": 0.0, "library_bf16_ms": 0.0,
              "bound_tc_bf16_ms": 0.0}

    def check(label, args, subset):
        """The inference kernel (no log-sum-exp) against plain, and a second
        call bit for bit; the training forward gives the same output, and
        its log-sum-exp (a second call bit for bit) within 1e-5 of scale of
        the plain one's (padding rows 0)."""
        nonlocal worst_lse
        out = window_attention(*args)
        out_t, lse = window_attention_fwd(*args)
        again = window_attention(*args)
        _, lse_again = window_attention_fwd(*args)
        torch.cuda.synchronize()
        if not (torch.equal(out, again) and torch.equal(lse, lse_again)):
            raise AssertionError(f"window_attention {label}: a second call "
                                 f"differs")
        ref, ref_lse = window_attention_reference(
            *(a[subset] for a in args), return_lse=True)
        got = out[subset]
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        pad = (args[3][subset] < 0)[:, None, :, None].expand_as(got)
        if not (err <= KERNEL_RTOL * scale and torch.isfinite(out).all()
                and bool((got[pad] == 0).all())):
            raise AssertionError(
                f"window_attention {label}: max |err| {err:.3e} > "
                f"{KERNEL_RTOL} x {scale:.3e}, or padding rows not 0")
        if not torch.equal(out, out_t):
            raise AssertionError(f"window_attention {label}: the forward "
                                 f"that writes the log-sum-exp differs")
        lse_err = share_of_scale(f"window_attention {label} lse",
                                 lse[subset], ref_lse, KERNEL_RTOL)
        if not bool((lse[subset][pad[..., 0]] == 0).all()):
            raise AssertionError(f"window_attention {label}: lse of padding "
                                 f"rows not 0")
        worst_lse = max(worst_lse, lse_err)
        return err, scale

    # every compiled instantiation; K = 17 x 64, so at D <= 16 (128 rows a
    # block) each window ends in a block of 64 rows
    for d in HEAD_DIMS:
        shape = (ATTN_CHECK_WINDOWS // 4, 2, 1088, d)
        for dtype in (torch.float32, torch.bfloat16):
            args = tuple(x.to(dtype) if x.is_floating_point() else x for x in
                         segmented_inputs(shape, device, gen))
            err, scale = check(f"{shape} {dtype} random, 3 segments", args,
                               slice(None))
            worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
    for shape, ((q, k, v, seg), count) in sorted(captured.items()):
        w, h, kk, d = shape
        subset = torch.linspace(0, w - 1, min(w, ATTN_CHECK_WINDOWS),
                                device=device).round().long().unique()
        pairs = allowed_pair_count(seg)
        mask = allowed_pairs(seg)[:, None]
        err_rand, scale_rand = check(f"{shape} random, 3 segments",
                                     segmented_inputs(shape, device, gen),
                                     subset)
        for dtype in (torch.float32, torch.bfloat16):
            args = (q.to(dtype), k.to(dtype), v.to(dtype), seg)
            err, scale = check(f"{shape} {dtype}", args, subset)
            worst = max(worst, err, err_rand)
            worst_rel = max(worst_rel, err / max(scale, 1e-30),
                            err_rand / max(scale_rand, 1e-30))
            ms = cuda_ms(lambda: window_attention(*args), 20)
            plain_ms = cuda_ms(lambda: window_attention_reference(*args), 3)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                *args[:3], attn_mask=mask), 5)
            # each input read once: q, k and v of the rows that hold a
            # segment (no output depends on a padding row's), every segment
            # id; the whole f32 output written once
            live = int((seg >= 0).sum())
            nbytes = (3 * live * h * d * args[0].element_size()
                      + w * kk * 4 + w * h * kk * d * 4)
            # 2 D multiply-adds per allowed pair and head for the scores and
            # 2 D for the values: bf16 x bf16 score products take the
            # tensor cores' rate, the f32 probabilities times the values
            # the f32 rate
            half = 2.0 * d * h * pairs
            qk_rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
            ops_s = half / qk_rate + half / F32_FLOPS
            bytes_s = nbytes / HBM_BYTES_PER_S
            bound_ms = 1e3 * max(bytes_s, ops_s)
            # the kernel's own arithmetic: its TF32 passes of both products
            # at the tensor cores' rate, one exp per allowed pair and head
            # on the special function units at the maximum SM clock
            mma_s = half * sum(ATTN_FWD_PASSES[str(dtype)]) / TF32_FLOPS
            exp_s = h * pairs / exps_per_s
            tc_terms = {"bytes": bytes_s, "mma passes": mma_s, "exps": exp_s}
            bound_tc_ms = 1e3 * max(tc_terms.values())
            row = dict(shape=list(shape), dtype=str(dtype), calls=count,
                       valid_rows=live,
                       windows_with_rows=int((seg >= 0).any(1).sum()),
                       allowed_pairs=pairs, exps=h * pairs,
                       max_abs_err=err, output_scale=scale,
                       max_abs_err_random=err_rand, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms,
                       bound_by="bytes" if bytes_s > ops_s else "operations",
                       bound_tc_ms=bound_tc_ms,
                       bound_tc_by=max(tc_terms, key=tc_terms.get))
            rows.append(row)
            log("kernel " + json.dumps(row))
            if dtype == torch.float32:
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", library_ms),
                                 ("bound_ms", bound_ms),
                                 ("bound_tc_ms", bound_tc_ms),
                                 ("bytes_s", bytes_s), ("ops_s", ops_s)):
                    totals[key] += count * val
            else:
                totals["bf16_ms"] += count * ms
                totals["library_bf16_ms"] += count * library_ms
                totals["bound_tc_bf16_ms"] += count * bound_tc_ms
    record = {
        "name": "window_attention",
        "route": "cuda",
        "source": "treemorph_tpu_torch/csrc/window_attention.cu",
        "replaces": "treemorph_tpu/ops/attention.py:29",
        "shape": "; ".join(f"({w}, {h}, {kk}, {d}) x{count}" for
                           (w, h, kk, d), (_, count) in
                           sorted(captured.items())),
        "max_abs_err": worst,
        "max_err_over_scale": worst_rel,
        "lse_max_err_over_scale": worst_lse,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if totals["bytes_s"] > totals["ops_s"]
        else "operations",
        "library_ms": totals["library_ms"],
        "bound_tc_ms": totals["bound_tc_ms"],
        "bf16_ms": totals["bf16_ms"],
        "library_bf16_ms": totals["library_bf16_ms"],
        "bound_tc_bf16_ms": totals["bound_tc_bf16_ms"],
        "sm_clock_mhz": clock / 1e6,
    }
    log(f"phase 7a ok: window_attention within {KERNEL_RTOL} x scale of "
        f"plain at {len(rows)} shape/type cases, on three-segment inputs and "
        f"at D = {HEAD_DIMS}, its log-sum-exp within {worst_lse:.2e} of "
        f"scale, every second call bit-identical; one forward's "
        f"{PTV3_BLOCKS} launches: kernel f32 {totals['ms']:.3f} ms (bound "
        f"{totals['bound_ms']:.3f} at the f32 rate, "
        f"{totals['bound_tc_ms']:.3f} at its TF32 passes and exps, SM clock "
        f"{clock / 1e6:.0f} MHz), bf16 {totals['bf16_ms']:.3f} ms (TC bound "
        f"{totals['bound_tc_bf16_ms']:.3f}); plain (f32) "
        f"{totals['plain_ms']:.3f} ms; scaled_dot_product_attention f32 "
        f"{totals['library_ms']:.3f} ms, bf16 "
        f"{totals['library_bf16_ms']:.3f} ms; the capturing forward "
        f"{fwd_s:.3f} s")
    return record, rows


def phase_ptv3_card_vs_cpu(cloud, device, name="phase 7b", cut=PTV3_CPU_CUT,
                           **overrides):
    """The forward ``predict_single`` runs (offset model: offsets and
    logits), on the card and on the CPU, on the cloud's first ``cut``
    points (``overrides``: the model's options)."""
    import numpy as np

    from treemorph_tpu_torch.pipeline.predict import _pad_flat

    cut = cloud[:cut]
    outs = []
    for dev in (device, "cpu"):
        offset_model, _ = ptv3_models(dev, **overrides)
        coords, f, b, v, n = _pad_flat(cut[:, :3], cut[:, 7:11], device=dev)
        t0 = time.perf_counter()
        res = offset_model.predict_flat(coords, f, b, v)
        outs.append({
            k: res[k][:n].float().cpu().numpy()
            for k in ("offset_predictions", "semantic_prediction_logits")
        })
        log(f"  PTv3 forward on {dev}: {time.perf_counter() - t0:.2f} s, "
            f"pool_overflow {int(res['pool_overflow'])}")
    card, cpu = outs
    off_err = float(np.abs(card["offset_predictions"]
                           - cpu["offset_predictions"]).max())
    off_scale = float(np.abs(cpu["offset_predictions"]).max())
    # the argmax as the head gives it, and with the class-1 bias set at the
    # CPU's median margin, where half the points sit on each side
    margin = {k: o["semantic_prediction_logits"] @ np.array([-1.0, 1.0])
              for k, o in zip(("card", "cpu"), outs)}
    median = float(np.median(margin["cpu"]))
    agree = float(((margin["card"] > 0) == (margin["cpu"] > 0)).mean())
    balanced = float(((margin["card"] > median)
                      == (margin["cpu"] > median)).mean())
    finite = all(np.isfinite(o[k]).all() for o in outs for k in o)
    log(f"{name}: PTv3 {overrides or ''} stage 1 card vs cpu on "
        f"{len(cut)} points: offsets max |err| "
        f"{off_err:.3e} (scale {off_scale:.3e}, limit {PTV3_OFFSET_RTOL} x "
        f"scale), noise argmax agreement {agree:.5f} (class 1 on "
        f"{(margin['cpu'] > 0).mean():.3f}), {balanced:.5f} at the median "
        f"margin (limit {STAGE1_ARGMAX_AGREEMENT} for both)")
    if not (finite and off_err <= PTV3_OFFSET_RTOL * off_scale
            and min(agree, balanced) >= STAGE1_ARGMAX_AGREEMENT):
        raise AssertionError("PTv3 stage 1 on the card disagrees with the CPU")
    log(f"{name} ok")


def profile_forward(predictor, cloud, top=10):
    """One forward of ``predictor`` on ``cloud`` under ``torch.profiler``
    after a warm-up forward (:func:`profile_device`)."""
    from treemorph_tpu_torch.pipeline.predict import _pad_flat

    args = _pad_flat(cloud[:, :3], cloud[:, 7:11],
                     device=predictor.device)[:4]
    predictor.predict_flat(*args)
    return profile_device(lambda: predictor.predict_flat(*args),
                          "PTv3 forward", top)


def profile_device(fn, label, top=10, ranges=()):
    """One call of ``fn`` under ``torch.profiler``: the wall seconds (host
    clock, synchronized), the summed device time of the kernels (the
    device's busy share), and the operators and kernels that take the most
    device time; for each name of ``ranges`` (``record_function`` scopes
    the call opens), its span on the device's timeline (its kernels and
    the gaps between them; the profiler records a scope as a device-side
    annotation, which is not a kernel and is left out of the busy time)
    and that span's share of the wall time."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from treemorph_tpu_torch.ops.cuda import KERNEL_FUNCTIONS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and e.key not in ranges]
    ops = [e for e in rows if e.device_type == DeviceType.CPU]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6

    def table(events):
        events = sorted(events, key=lambda e: e.self_device_time_total,
                        reverse=True)[:top]
        return [(e.key[:90], e.count, e.self_device_time_total / 1e3)
                for e in events]

    # the port's own kernels, whatever their rank
    names = {f for fns in KERNEL_FUNCTIONS.values() for f in fns}
    hand = [e for e in kernels
            if (m := re.search(r"::(\w+)[<(]", e.key)) and m.group(1) in names]
    record = {"seconds": wall_s, "device_busy_seconds": busy_s,
              "device_idle_share": 1.0 - busy_s / wall_s,
              "top_ops_device_ms": table(ops),
              "top_kernels_device_ms": table(kernels),
              "hand_kernels_device_ms": table(hand)}
    if ranges:
        spans = {e.key: e.self_device_time_total / 1e6 for e in rows
                 if e.device_type == DeviceType.CUDA and e.key in ranges}
        record["ranges_device_span_ms"] = {
            name: 1e3 * spans.get(name, 0.0) for name in ranges}
        record["ranges_wall_share"] = {
            name: spans.get(name, 0.0) / wall_s for name in ranges}
    log(f"{label} profile: " + json.dumps(record))
    return record


def phase_ptv3_end_to_end(cloud, device):
    """The PTv3 plot end to end (44 attention launches), then one forward
    profiled; returns the kernel's launches."""
    models = ptv3_models(device)
    launches, _ = plot_end_to_end(cloud, "pointtransformerv3", models,
                                  device, "window_attention", PTV3_BLOCKS)
    profile_forward(models[0], cloud)
    log("phase 7c ok")
    return launches


def ptv3_training_batch(root: str, device, trees=PTV3_TRAIN_TREES):
    """The first ``trees``-tree batch of the CV fold that holds out plot 1
    (the CLI's batches are these trees, shuffled), on ``device``."""
    from treemorph_tpu_torch.data import batch_iterator, get_plot_split
    from treemorph_tpu_torch.train.harness import to_device

    trainset, _ = get_plot_split(root, 1)
    batch = next(batch_iterator(trainset, trees, TRAIN_POINTS,
                                shuffle=False))
    return to_device(batch, device)


def ptv3_training_model(device, drop_path=0.3, **overrides):
    """The training CLI's PTv3 (full width, dim_feat 4, features, voxel
    0.02, f32; ``overrides`` to its options) with seeded weights, on
    ``device``."""
    from treemorph_tpu_torch.models.ptv3 import PointTransformerWithHeads
    from treemorph_tpu_torch.train.families import init_ptv3

    model = PointTransformerWithHeads(dim_feat=4, use_feats=True,
                                      voxel_size=0.02, drop_path=drop_path,
                                      **overrides)
    return init_ptv3(model, 0).to(device)


def capture_ptv3_step(batch, device, **overrides):
    """The forward and backward of one full-width PTv3 train step (the
    family's ``forward_fn`` on step generator seed 0, the x50 loss;
    ``overrides``: the model's options); per ``window_attention`` call, its
    inputs (q, k, v, seg) and the output cotangent the step's backward gave
    it."""
    import torch

    from treemorph_tpu_torch.ops import attention
    from treemorph_tpu_torch.train import families, harness

    model = ptv3_training_model(device, **overrides)
    calls = []
    kernel = attention.window_attention

    def recording(q, k, v, seg):
        out = kernel(q, k, v, seg)
        entry = [q.detach(), k.detach(), v.detach(), seg, None]
        calls.append(entry)
        out.register_hook(
            lambda g: entry.__setitem__(4, g.detach().float().contiguous()))
        return out

    forward_fn, loss_fn = families.ptv3_family()
    attention.window_attention = recording
    try:
        out = forward_fn(model, batch, True, torch.Generator().manual_seed(0))
        loss, _ = loss_fn(out, batch)
        (loss * harness.LOSS_BACKWARD_SCALE).backward()
    finally:
        attention.window_attention = kernel
    torch.cuda.synchronize()
    if len(calls) != PTV3_BLOCKS or any(c[4] is None for c in calls):
        raise AssertionError(f"{len(calls)} attention calls with cotangents "
                             f"in a train step, expected {PTV3_BLOCKS}")
    return calls


def sdpa_backward_ms(args, mask) -> float:
    """CUDA-event ms of the backward of ``scaled_dot_product_attention``
    with the boolean ``mask``, on ``args``' q, k, v and cotangent (rows
    with no allowed key give NaN there: a yardstick of time only)."""
    import torch
    import torch.nn.functional as F

    leaves = [x.detach().clone().requires_grad_() for x in args[:3]]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    g = args[4].to(out.dtype)
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, g,
                                               retain_graph=True), 5)


def phase_attention_bwd_vs_plain(calls, device):
    """Returns the per-step backward kernel record (f32, the main path's
    type) and the per-shape rows."""
    import torch

    from treemorph_tpu_torch.ops.attention import (
        allowed_pairs,
        window_attention_bwd,
        window_attention_bwd_reference,
        window_attention_fwd,
    )

    by_shape = {}
    for call in calls:
        entry = by_shape.setdefault(tuple(call[0].shape), [call, 0])
        entry[1] += 1
    gen = torch.Generator(device=device).manual_seed(5)
    rows, worst, worst_rel = [], 0.0, 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "library_bf16_ms": 0.0, "bf16_ms": 0.0, "bound_ms": 0.0,
              "bound_tf32_ms": 0.0, "bound_tf32_bf16_ms": 0.0,
              "bytes_s": 0.0, "ops_s": 0.0}

    def check(label, args):
        """The kernel, fed the forward kernel's output and log-sum-exp,
        against the plain backward (which recomputes P); returns the errors
        and the saved (out, lse)."""
        saved = window_attention_fwd(*args[:4])
        grads = window_attention_bwd(*args, *saved)
        torch.cuda.synchronize()
        refs = window_attention_bwd_reference(*args)
        pad = (args[3] < 0)[:, None, :, None].expand_as(grads[0])
        errs = {}
        for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            if not (err <= KERNEL_RTOL * scale and torch.isfinite(got).all()
                    and bool((got[pad] == 0).all())):
                raise AssertionError(
                    f"window_attention_bwd {label} {name}: max |err| "
                    f"{err:.3e} > {KERNEL_RTOL} x {scale:.3e}, or padding "
                    f"rows not 0")
            errs[name] = (err, scale)
        return errs, saved

    for shape, ((q, k, v, seg, g), count) in sorted(by_shape.items()):
        w, h, kk, d = shape
        pairs = allowed_pair_count(seg)
        mask = allowed_pairs(seg)[:, None]
        rand = segmented_inputs(shape, device, gen) + (
            torch.randn(shape, device=device, generator=gen),)
        errs_rand, _ = check(f"{shape} random, 3 segments", rand)
        for dtype in (torch.float32, torch.bfloat16):
            args = (q.to(dtype), k.to(dtype), v.to(dtype), seg, g)
            errs, saved = check(f"{shape} {dtype}", args)
            for err, scale in (*errs.values(), *errs_rand.values()):
                worst = max(worst, err)
                worst_rel = max(worst_rel, err / max(scale, 1e-30))
            ms = cuda_ms(lambda: window_attention_bwd(*args, *saved), 20)
            plain_ms = cuda_ms(lambda: window_attention_bwd_reference(*args),
                               3)
            library_ms = sdpa_backward_ms(args, mask)
            # each input read once (q, k, v and the f32 cotangent of the
            # rows that hold a segment, every segment id), each output
            # written once (dq, dk, dv in f32)
            live = int((seg >= 0).sum())
            nbytes = (3 * live * h * d * args[0].element_size()
                      + w * kk * 4 + live * h * d * 4
                      + 3 * w * h * kk * d * 4)
            # 5 D multiply-adds per allowed pair and head (the scores, dp,
            # dv, dq, dk) in f32; the same on the TF32 tensor cores in the
            # kernel's passes: 3 per product in f32, in bf16 1 (scores),
            # 2 (dp, dq, dk) and 3 (dv)
            flops = 2.0 * 5 * d * h * pairs
            ops_s = flops / F32_FLOPS
            bytes_s = nbytes / HBM_BYTES_PER_S
            bound_ms = 1e3 * max(bytes_s, ops_s)
            passes = 15 if dtype == torch.float32 else 10
            bound_tf32_ms = 1e3 * max(
                bytes_s, flops / 5 * passes / TF32_FLOPS)
            row = dict(shape=list(shape), dtype=str(dtype), calls=count,
                       valid_rows=live,
                       windows_with_rows=int((seg >= 0).any(1).sum()),
                       allowed_pairs=pairs,
                       err_over_scale={n: e / max(sc, 1e-30)
                                       for n, (e, sc) in errs.items()},
                       random_err_over_scale={
                           n: e / max(sc, 1e-30)
                           for n, (e, sc) in errs_rand.items()},
                       ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_tf32_ms=bound_tf32_ms,
                       bound_by="bytes" if bytes_s > ops_s else "operations")
            rows.append(row)
            log("kernel " + json.dumps(row))
            if dtype == torch.float32:
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", library_ms),
                                 ("bound_ms", bound_ms),
                                 ("bound_tf32_ms", bound_tf32_ms),
                                 ("bytes_s", bytes_s), ("ops_s", ops_s)):
                    totals[key] += count * val
            else:
                totals["library_bf16_ms"] += count * library_ms
                totals["bf16_ms"] += count * ms
                totals["bound_tf32_bf16_ms"] += count * bound_tf32_ms
    record = {
        "name": "window_attention_bwd",
        "route": "cuda",
        "source": "treemorph_tpu_torch/csrc/window_attention_bwd.cu",
        "replaces": "treemorph_tpu/ops/attention.py:71",
        "shape": "; ".join(f"({w}, {h}, {kk}, {d}) x{count}" for
                           (w, h, kk, d), (_, count) in
                           sorted(by_shape.items())),
        "max_abs_err": worst,
        "max_err_over_scale": worst_rel,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if totals["bytes_s"] > totals["ops_s"]
        else "operations",
        "library_ms": totals["library_ms"],
        "bound_tf32_ms": totals["bound_tf32_ms"],
        "bf16_ms": totals["bf16_ms"],
        "library_bf16_ms": totals["library_bf16_ms"],
        "bound_tf32_bf16_ms": totals["bound_tf32_bf16_ms"],
    }
    log(f"phase 8a ok: window_attention_bwd within {KERNEL_RTOL} x scale of "
        f"plain at {len(rows)} shape/type cases and on three-segment inputs; "
        f"one train step's {PTV3_BWD_PER_STEP} launches: kernel f32 "
        f"{totals['ms']:.3f} ms (bound {totals['bound_ms']:.3f} at the f32 "
        f"rate, {totals['bound_tf32_ms']:.3f} at TF32 in 3 passes), bf16 "
        f"{totals['bf16_ms']:.3f} ms (TF32 bound "
        f"{totals['bound_tf32_bf16_ms']:.3f}); plain (f32) "
        f"{totals['plain_ms']:.3f} ms; scaled_dot_product_attention backward "
        f"f32 {totals['library_ms']:.3f} ms, bf16 "
        f"{totals['library_bf16_ms']:.3f} ms")
    return record, rows


def ptv3_one_step(batch, device, **overrides):
    """Loss and parameter gradients (clipped as the step clips them) of one
    ``make_train_step`` of the training PTv3 at ``drop_path`` 0 on
    ``batch``, on ``device``, with step generator seed 1 (the same order
    permutations on every device); ``overrides``: the model's options."""
    import torch

    from treemorph_tpu_torch.train import families, harness

    model = ptv3_training_model(device, drop_path=0.0, **overrides)
    state = harness.TrainState(model, harness.make_optimizer(model))
    step = harness.make_train_step(*families.ptv3_family())
    _, metrics = step(state, batch.map(lambda a: a.to(device)), 1e-2,
                      torch.Generator().manual_seed(1))
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    return float(metrics["loss"]), grads


def phase_ptv3_train_checks(root, calls, device):
    """Each attention of the captured step differentiated alone through
    ``window_attention`` (autograd Function and backward kernel) on the
    step's own cotangent, against the plain backward; then one train step
    on a 2-tree cut, card against CPU."""
    import torch

    from treemorph_tpu_torch.ops.attention import (
        window_attention,
        window_attention_bwd_reference,
    )
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    worst = 0.0
    for q, k, v, seg, g in calls:
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        window_attention(*leaves, seg).backward(g)
        refs = window_attention_bwd_reference(q, k, v, seg, g)
        for name, leaf, ref in zip(("dq", "dk", "dv"), leaves, refs):
            if leaf.grad is None:
                raise AssertionError(f"{name} of a {tuple(q.shape)} "
                                     f"attention: no gradient")
            err = float((leaf.grad - ref).abs().max())
            scale = float(ref.abs().max())
            worst = max(worst, err / max(scale, 1e-30))
            if not err <= KERNEL_RTOL * scale:
                raise AssertionError(
                    f"{name} of a {tuple(q.shape)} attention through "
                    f"autograd: max |err| {err:.3e} > {KERNEL_RTOL} x "
                    f"{scale:.3e}")
    launches = LAUNCHES["window_attention_bwd"]
    log(f"phase 8b: {len(calls)} attentions of a full-width f32 train step, "
        f"each differentiated alone through autograd on the step's own "
        f"cotangent: within {worst:.2e} of scale of the plain backward "
        f"(limit {KERNEL_RTOL}); window_attention_bwd launches {launches}")
    if launches != len(calls):
        raise AssertionError("the backward kernel did not run for every "
                             "attention")
    cut = ptv3_training_batch(root, "cpu", 2).map(
        lambda a: a[:, :PTV3_CPU_STEP_POINTS].contiguous())
    t0 = time.perf_counter()
    card = ptv3_one_step(cut, device)
    t1 = time.perf_counter()
    cpu = ptv3_one_step(cut, "cpu")
    log(f"  2-tree step ({PTV3_CPU_STEP_POINTS} points a tree): card "
        f"{t1 - t0:.2f} s, CPU "
        f"{time.perf_counter() - t1:.2f} s")
    compare_steps("PTv3 train step, card vs CPU, f32", card, cpu,
                  PTV3_STEP_LOSS_RTOL, PTV3_STEP_GRAD_RTOL)
    log("phase 8b ok")


def phase_ptv3_training_cli(root, device):
    """The training CLI's pointtransformerv3 family at full width; returns
    the backward kernel's launches and the run's record."""
    import math

    import numpy as np
    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import load_model
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.pipeline.predict import predict_single
    from treemorph_tpu_torch.train import cli

    save_dir = os.path.join(root, "ptv3_saves")
    argv = ["pointtransformerv3", "--data_root", root, "--test_plots", "1",
            "--epochs", str(PTV3_TRAIN_EPOCHS), "--batch_size",
            str(PTV3_TRAIN_TREES), "--bucket", str(TRAIN_POINTS),
            "--save_dir", save_dir, "--device", str(device)]
    log("training CLI: python -m treemorph_tpu_torch.train.cli "
        + " ".join(argv))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    history = cli.main(argv)[1]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    per_epoch = -(-TRAIN_TREES * (TRAIN_PLOTS - 1) // PTV3_TRAIN_TREES)
    val_batches = -(-TRAIN_TREES // PTV3_TRAIN_TREES)
    steps = PTV3_TRAIN_EPOCHS * per_epoch
    forwards = steps + PTV3_TRAIN_EPOCHS * val_batches
    for r in history:
        log("epoch " + json.dumps(r))
    log(f"training CLI (PTv3): {secs:.2f} s for {PTV3_TRAIN_EPOCHS} epochs "
        f"of {per_epoch} steps, launches {launches}")
    ckpt = os.path.join(save_dir, "pointtransformerv3_CV")
    predictors = load_model("pointtransformerv3", ckpt, device=device)
    with open(os.path.join(root, "plot_1.json")) as f:
        cloud = np.load(json.load(f)[0])
    served = (predict_single(cloud, predictors["O_P1"], None, device=device)
              if "O_P1" in predictors else None)
    losses = [r[k] for r in history for k in ("train_loss", "val_loss")]
    checks = {
        f"{PTV3_TRAIN_EPOCHS} epochs": len(history) == PTV3_TRAIN_EPOCHS,
        "every loss finite": all(math.isfinite(x) for x in losses),
        "last train loss below the first":
            history[-1]["train_loss"] < history[0]["train_loss"],
        "checkpoint loads and serves predict_single": served is not None
            and served.shape == (len(cloud), 3)
            and bool(np.isfinite(served).all()),
        f"{PTV3_BWD_PER_STEP} window_attention_bwd launches per step":
            launches.get("window_attention_bwd", 0)
            == PTV3_BWD_PER_STEP * steps,
        f"{PTV3_BLOCKS} window_attention launches per forward":
            launches.get("window_attention", 0) == PTV3_BLOCKS * forwards,
    }
    for name, ok in checks.items():
        log(f"  {'ok ' if ok else 'FAIL'} {name}")
    if not all(checks.values()):
        raise AssertionError("PTv3 training CLI checks failed")
    log("phase 8c ok")
    return launches.get("window_attention_bwd", 0), {
        "ptv3_train_cli_seconds": secs, "ptv3_train_steps": steps,
        "ptv3_train_losses": [r["train_loss"] for r in history],
        "ptv3_val_losses": [r["val_loss"] for r in history],
        "ptv3_launches": launches,
    }


def seeded_step_split(model, family, batch, device, reps=3):
    """Seconds of a train step of ``model`` (``family``'s forward with a
    step generator seeded by the step's number, the x50 loss, lr 1e-2),
    split into forward (with the loss), backward and optimizer, host clock
    around synchronized work: medians of ``reps`` steps after one warm-up
    step, LAUNCHES reset before each. Returns ``(record, step)``: the
    record (the split, peak device memory, the last step's launches and
    each timed step's overflow counts, where its outputs have them) and
    ``step(seed)``, which runs one more."""
    import torch

    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.train import harness

    forward_fn, loss_fn = family
    opt = harness.make_optimizer(model)
    torch.cuda.reset_peak_memory_stats(device)
    overflows = []

    def step(seed, times=None):
        t0 = time.perf_counter()
        out = forward_fn(model, batch, True,
                         torch.Generator().manual_seed(seed))
        loss, _ = loss_fn(out, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        (loss * harness.LOSS_BACKWARD_SCALE).backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        harness.optimizer_step(opt, 1e-2)
        torch.cuda.synchronize()
        if times is not None:
            times.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
            overflows.append({k: int(out[k]) for k in (
                "dedup_overflow", "pool_overflow") if k in out})
        if not torch.isfinite(loss):
            raise AssertionError("non-finite loss in the timed steps")

    splits = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        reset_launches()
        step(i, splits)
    fwd, bwd, optim = (statistics.median(x) for x in zip(*splits[1:]))
    return {"step_seconds": fwd + bwd + optim, "forward_seconds": fwd,
            "backward_seconds": bwd, "optimizer_seconds": optim,
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "launches_per_step": dict(LAUNCHES),
            "overflows": overflows}, step


def phase_ptv3_step_split(batch, device, reps=3):
    """8d: the full-width PTv3 step split (:func:`seeded_step_split`) with
    peak device memory, then one more step under ``torch.profiler``."""
    from treemorph_tpu_torch.train import families

    split, step = seeded_step_split(ptv3_training_model(device),
                                    families.ptv3_family(), batch, device,
                                    reps)
    record = {
        "ptv3_train_step_seconds": split["step_seconds"],
        "ptv3_train_forward_seconds": split["forward_seconds"],
        "ptv3_train_backward_seconds": split["backward_seconds"],
        "ptv3_train_optimizer_seconds": split["optimizer_seconds"],
        "ptv3_train_points_per_step": int(batch.mask_valid.sum()),
        "ptv3_train_peak_memory_gb": split["peak_memory_gb"],
        "ptv3_launches_per_step": split["launches_per_step"],
    }
    log(json.dumps(record))
    record["ptv3_train_step_profile"] = profile_device(
        lambda: step(reps + 1), "PTv3 train step")
    log("phase 8d ok")
    return record


def within_scale(label, got, ref, rtol):
    """max |got - ref| and max |ref|; raises unless the first is within
    ``rtol`` of the second and ``got`` is finite."""
    import torch

    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not (err <= rtol * scale and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{label}: max |err| {err:.3e} > {rtol} x "
                             f"{scale:.3e}, or not finite")
    return err, scale


def share_of_scale(label, got, ref, rtol) -> float:
    """max |got - ref| / max |ref|, checked by :func:`within_scale`."""
    err, scale = within_scale(label, got, ref, rtol)
    return err / max(scale, 1e-30)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Bound in ms (bytes at the HBM rate, f32 operations at the f32 rate)
    and which of the two sets it."""
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s > ops_s
                                        else "operations")


def profile_rulebooks(device):
    """(label, rulebook, valid, Cin, Cout) of the z-band profile workload's
    convs (``treemorph_tpu_torch/scripts/profile_zband.py``: the bench
    cloud deduplicated to 32,768 voxels)."""
    import torch

    from treemorph_tpu_torch.ops.sparse import build_dedup, build_rulebook
    from treemorph_tpu_torch.scripts.profile_zband import SHAPES, bench_coords

    coords = torch.from_numpy(bench_coords()).to(device)
    dd = build_dedup(coords, torch.ones(len(coords), dtype=torch.bool,
                                        device=device), cap=32768)
    return [(f"profile {label}", build_rulebook(dd.coords, dd.valid, k),
             dd.valid, cin, cout) for k, cin, cout, label in SHAPES]


def phase_zband_vs_plain(profile, levels, device):
    """9a: ``zband_conv_padded`` against its plain version, bf16 and f32,
    at the profile workload's three convs and at every K = 27 conv shape of
    the TreeLearn plot's levels 0-2 (z-band plans over their rulebooks),
    timed beside both bounds, the plain version, the band kernel on the
    same conv (K = 27 or 125) and the gather engine; the replaced SIMT
    kernel's time is logged beside each row as a historical constant
    (``ZBAND_SIMT_HISTORICAL_MS``). Returns the kernel record (one pass of
    the profile workload: its 3 convs in bf16 and f32) and the rows."""
    import torch

    from treemorph_tpu_torch.ops.bandconv import (
        TILE,
        ZALIGN,
        band_conv_padded,
        build_band_plan,
        build_zband_plan,
        zband_conv_padded,
        zband_conv_padded_plain,
        zband_pack,
    )
    from treemorph_tpu_torch.ops.sparse import _subm_conv_impl, build_rulebook

    cases = [(*case, True) for case in profile]
    for level, (c, v) in enumerate(levels):
        rb = build_rulebook(c, v)
        cases += [(f"L{level} {cin}->{cout}", rb, v, cin, cout, False)
                  for lvl, cin, cout, _ in LEVEL_CONVS if lvl == level]
    gen = torch.Generator(device=device).manual_seed(9)
    rows, worst = [], 0.0
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_tc_ms=0.0,
                  band_ms=0.0, gather_ms=0.0, bytes=0.0, flops=0.0)
    for label, rb, valid, cin, cout, profiled in cases:
        m, k = rb.shape
        ksize = round(k ** (1 / 3))
        plan = build_zband_plan(rb, valid, res_divisor=ZBAND_RES_DIVISOR)
        bplan = build_band_plan(rb, valid)
        mp = plan.anchors.shape[0] * TILE
        # found anchors inside their windows (the kernel's work) and
        # outside them (the residual repair's: the kernel must skip them)
        anchors = plan.anchors.long()
        local = anchors - (plan.starts.long() * ZALIGN).T[:, :, None]
        inside = (local >= 0) & (local < plan.win)
        covered = int(((anchors < m) & inside).sum())
        outside = int(((anchors < m) & ~inside).sum())
        # the packed rows the kernel reads: the distinct covered anchors
        # (the rest of zq's mp rows, padding and rows no anchor names, are
        # never read)
        zq_rows = int(torch.unique(anchors[(anchors < m) & inside]).numel())
        w = torch.randn((k, cin, cout), device=device, generator=gen)
        w /= (k * cin) ** 0.5
        w2 = w.reshape(ksize * ksize, ksize * cin, cout).contiguous()
        feats = torch.randn((m, cin), device=device, generator=gen)
        feats *= valid[:, None]
        for dtype in (torch.bfloat16, torch.float32):
            zq = zband_pack(feats.to(dtype), plan.zoff, ksize, mp)
            args = (plan.anchors, plan.starts, zq, w2, m, plan.win)
            out = zband_conv_padded(*args)
            torch.cuda.synchronize()
            err, scale = within_scale(f"zband_conv {label} {dtype}", out,
                                      zband_conv_padded_plain(*args),
                                      KERNEL_RTOL)
            worst = max(worst, err)
            ms = cuda_ms(lambda: zband_conv_padded(*args), 20)
            plain_ms = cuda_ms(lambda: zband_conv_padded_plain(*args), 5)
            fpad = torch.zeros((bplan.rb_tiles.shape[0] * TILE, cin),
                               dtype=dtype, device=device)
            fpad[:m] = feats
            band_ms = cuda_ms(lambda: band_conv_padded(
                bplan.rb_tiles, bplan.starts, fpad, w, m, bplan.win), 20)
            gather_ms = cuda_ms(
                lambda: _subm_conv_impl(dtype, feats, w, rb, valid), 5)
            nbytes = ((plan.anchors.numel() + plan.starts.numel()) * 4
                      + zq_rows * zq.shape[1] * zq.element_size()
                      + w2.numel() * 4 + mp * cout * 4)
            flops = 2.0 * covered * ksize * cin * cout
            bound_ms, bound_by = bound(nbytes, flops)
            row = dict(conv=label, k=k, cin=cin, cout=cout, dtype=str(dtype),
                       m=m, valid=int(valid.sum()), covered_anchors=covered,
                       zq_rows_read=zq_rows,
                       found_anchors_outside_window=outside,
                       residual_rows=int(plan.res_valid.sum()),
                       route="zband" if bool(plan.ok)
                       else "gather (residual overflow)",
                       max_abs_err=err, output_scale=scale, ms=ms,
                       simt_historical_ms=ZBAND_SIMT_HISTORICAL_MS.get(
                           (label, str(dtype))),
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by,
                       **tc_bound(nbytes, flops, BAND_TC[str(dtype)]),
                       band_kernel_ms=band_ms, gather_ms=gather_ms)
            rows.append(row)
            log("kernel " + json.dumps(row))
            if profiled:
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("bound_ms", bound_ms),
                                 ("bound_tc_ms", row["bound_tc_ms"]),
                                 ("band_ms", band_ms),
                                 ("gather_ms", gather_ms), ("bytes", nbytes),
                                 ("flops", flops)):
                    totals[key] += val
    record = {
        "name": "zband_conv",
        "route": "cuda",
        "source": "treemorph_tpu_torch/csrc/band_conv.cu",
        "replaces": "treemorph_tpu/ops/bandconv.py:851",
        "shape": "the profile workload's 3 convs (k=5 4->32, k=3 32->32, "
                 "k=3 64->64 over 32,768 rows) x (bf16, f32), one launch "
                 "each",
        "max_abs_err": worst,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": bound(totals["bytes"], totals["flops"])[1],
        "bound_tc_ms": totals["bound_tc_ms"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a windowed sparse "
                        "conv; the band kernel and the gather engine on the "
                        "same convs:",
        "band_kernel_ms": totals["band_ms"],
        "gather_ms": totals["gather_ms"],
    }
    log(f"phase 9a ok: zband_conv within {KERNEL_RTOL} x scale of plain at "
        f"{len(rows)} conv/type cases; the profile workload's 6 launches: "
        f"kernel {totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, "
        f"bound {totals['bound_ms']:.3f} ms (TC {totals['bound_tc_ms']:.3f}), "
        f"band kernel {totals['band_ms']:.3f} ms, gather "
        f"{totals['gather_ms']:.3f} ms")
    return record, rows


def phase_zband_autograd(profile, device):
    """9b: ``zband_subm_conv_apply`` through autograd against the gather
    engine (its custom VJP) in f32 on the profile's k=3 32->32 conv and a
    random cotangent; one kernel launch forward and one backward."""
    import torch

    from treemorph_tpu_torch.ops.bandconv import (
        build_zband_plan,
        zband_subm_conv_apply,
    )
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.ops.sparse import _subm_conv

    label, rb, valid, cin, cout = profile[1]
    plan = build_zband_plan(rb, valid, res_divisor=ZBAND_RES_DIVISOR)
    if not bool(plan.ok):
        raise AssertionError(f"{label}: the z-band plan overflowed")
    gen = torch.Generator(device=device).manual_seed(10)
    feats = torch.randn((rb.shape[0], cin), device=device, generator=gen)
    w = torch.randn((27, cin, cout), device=device, generator=gen) * 0.1
    cot = torch.randn((rb.shape[0], cout), device=device, generator=gen)
    results = []
    for engine in ("zband", "gather"):
        f = feats.clone().requires_grad_()
        wl = w.clone().requires_grad_()
        torch.cuda.synchronize()
        reset_launches()
        out = (zband_subm_conv_apply(f, wl, plan, valid) if engine == "zband"
               else _subm_conv(torch.float32, f, wl, rb, valid))
        fwd = LAUNCHES["zband_conv"]
        out.backward(cot)
        torch.cuda.synchronize()
        results.append((out.detach(), f.grad, wl.grad, fwd,
                        LAUNCHES["zband_conv"] - fwd))
    (out, d_f, d_w, fwd, bwd), (ref, r_f, r_w, _, _) = results
    errs = {name: share_of_scale(f"9b {name}", a, b, AUTOGRAD_RTOL)
            for name, a, b in (("out", out, ref), ("d_feats", d_f, r_f),
                               ("d_w", d_w, r_w))}
    if (fwd, bwd) != (1, 1):
        raise AssertionError(f"9b: zband_conv launches forward {fwd}, "
                             f"backward {bwd}; expected 1 and 1")
    log(f"phase 9b ok: {label} through autograd against the gather engine, "
        f"f32: max |err| / scale {errs} (limit {AUTOGRAD_RTOL}); "
        f"zband_conv launches forward {fwd}, backward {bwd}")


def phase_profile_zband(device):
    """9c: the port's ``profile_zband`` on the card, its launches counted;
    z-band against gather within 1e-5 of scale in f32, 1e-2 in bf16."""
    import torch

    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.scripts import profile_zband

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    records = profile_zband.main([])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = LAUNCHES["zband_conv"]
    expected = sum(r["zband_calls"] for r in records if r["route"] == "zband")
    for r in records:
        log("profile_zband " + json.dumps(r))
    bad = [r for r in records if not r["max_abs_diff"] <= r["scale"] * (
        PROFILE_F32_RTOL if r["dtype"] == "f32" else PROFILE_BF16_RTOL)]
    if bad or launches != expected or launches == 0:
        raise AssertionError(
            f"9c: zband against gather out of bounds in {bad}, or zband_conv "
            f"launches {launches} != {expected} calls on the z-band route")
    log(f"phase 9c ok: profile_zband in {secs:.1f} s, zband_conv launches "
        f"{launches} (= its calls on the z-band route), all launches "
        f"{dict(LAUNCHES)}")
    return launches


def brick_inputs(levels, level, device, seed):
    """Level ``level``'s voxels in bricks (cap M / BRICK_DIVISOR, as the JAX
    TreeLearn sets it) with seeded features and weights of that level's
    width: (coords, valid, structure, feats, weights)."""
    import torch

    from treemorph_tpu_torch.ops.bricks import brickize

    c, v = levels[level]
    width = BRICK_WIDTHS[level]
    cap = max(c.shape[0] // BRICK_DIVISOR, 64)
    bs = brickize(c, v, cap)
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn((c.shape[0], width), device=device, generator=gen)
    feats *= v[:, None]
    w = torch.randn((27, width, width), device=device, generator=gen)
    return c, v, bs, feats, w / (27 * width) ** 0.5


def brick_bounds(h, w, cells, live):
    """Bounds in ms of one brick conv call on ``h`` (B, 216, Cin) x ``w``:
    the bytes (input read once, output written once) against the multiply-
    adds of every brick (``all``) and of the ``live`` bricks (those whose
    input is not all zero, what this input needs), each at the f32 rate
    (``f32``) and on the TF32 tensor cores in the kernel's three passes
    (``tf32``); and which of bytes or operations sets the f32 bound over
    the live bricks."""
    cap, _, cin = h.shape
    cout = w.shape[-1]
    nbytes = (h.numel() + w.numel() + cap * cells * cout) * 4
    per_brick = 2.0 * cells * 27 * cin * cout
    bounds = {}
    for count_name, count in (("all", cap), ("live", live)):
        bounds[f"{count_name}_f32"], by = bound(nbytes, per_brick * count)
        bounds[f"{count_name}_tf32"] = 1e3 * max(
            nbytes / HBM_BYTES_PER_S, 3 * per_brick * count / TF32_FLOPS)
        if count_name == "live":
            bounds["by"] = by
    return bounds


def phase_brick_vs_plain(levels, device):
    """10a: ``brick_conv_cells``, core and full variants, against its plain
    version on the halo'd bricks of the TreeLearn plot's levels 0-2 and on
    a dense random tensor of the same shape (every brick live, so the
    arithmetic shows apart from the zero-brick skip), timed beside the
    bounds, the plain version and ``F.conv3d`` (TF32 off, and once on).
    Returns the kernel record (level 0 of the plot: the core variant, the
    path's forward, with the full variant, its backward, beside it) and the
    rows."""
    import torch
    import torch.nn.functional as F

    from treemorph_tpu_torch.ops.brick_conv import (
        CELLS6,
        brick_conv_cells,
        brick_conv_cells_plain,
    )
    from treemorph_tpu_torch.ops.bricks import (
        _halo_pad,
        conv3d_kernel,
        to_dense,
    )

    rows, worst = [], 0.0
    for level in range(3):
        c, v, bs, feats, w = brick_inputs(levels, level, device, 11 + level)
        cap, width = bs.brick_coords.shape[0], w.shape[1]
        plot = _halo_pad(to_dense(feats, bs), bs).reshape(cap, CELLS6, width)
        dense = torch.randn(plot.shape, device=device,
                            generator=torch.Generator(device=device)
                            .manual_seed(21 + level))
        kernel5 = conv3d_kernel(w).contiguous()
        dropped = int((v & (bs.brick_id >= cap)).sum())
        for source, h in (("plot", plot.contiguous()), ("dense", dense)):
            live = int((h != 0).flatten(1).any(1).sum())
            h5 = h.view(cap, 6, 6, 6, width).permute(0, 4, 1, 2, 3)
            for core_only in (True, False):
                variant = "core" if core_only else "full"
                label = f"brick_conv L{level} {source} {variant}"
                out = brick_conv_cells(h, w, core_only)
                torch.cuda.synchronize()
                err, scale = within_scale(
                    label, out, brick_conv_cells_plain(h, w, core_only),
                    KERNEL_RTOL)
                worst = max(worst, err)
                dead = (h == 0).flatten(1).all(1)
                if not bool((out[dead] == 0).all()):
                    raise AssertionError(f"{label}: an all-zero brick's "
                                         f"output is not exactly 0")
                ms = cuda_ms(lambda: brick_conv_cells(h, w, core_only), 20)
                plain_ms = cuda_ms(
                    lambda: brick_conv_cells_plain(h, w, core_only), 3)
                library_ms = library_tf32_ms = None
                if core_only:
                    # the yardstick computes the same function
                    within_scale(f"F.conv3d L{level} {source} against the "
                                 f"core variant",
                                 F.conv3d(h5, kernel5).permute(0, 2, 3, 4, 1)
                                 .reshape(out.shape), out, KERNEL_RTOL)
                    library_ms = cuda_ms(lambda: F.conv3d(h5, kernel5), 20)
                    torch.backends.cudnn.allow_tf32 = True
                    library_tf32_ms = cuda_ms(
                        lambda: F.conv3d(h5, kernel5), 20)
                    torch.backends.cudnn.allow_tf32 = False
                bounds = brick_bounds(h, w, out.shape[1], live)
                row = dict(level=level, input=source, variant=variant,
                           bricks=cap, live_bricks=live,
                           valid_bricks=int(bs.brick_valid.sum()),
                           valid_voxels=int(v.sum()), dropped_voxels=dropped,
                           cin=width, cout=width, max_abs_err=err,
                           output_scale=scale, ms=ms, plain_ms=plain_ms,
                           bound_ms=bounds["all_f32"],
                           bound_tf32_ms=bounds["all_tf32"],
                           live_bound_ms=bounds["live_f32"],
                           live_bound_tf32_ms=bounds["live_tf32"],
                           live_bound_by=bounds["by"],
                           conv3d_ms=library_ms,
                           conv3d_tf32_ms=library_tf32_ms)
                rows.append(row)
                log("kernel " + json.dumps(row))
            del h5
        del plot, dense, out
    core, full = rows[0], rows[1]  # level 0 of the plot
    dense_core, dense_full = rows[2], rows[3]
    record = {
        "name": "brick_conv",
        "route": "cuda",
        "source": "treemorph_tpu_torch/csrc/brick_conv.cu",
        "replaces": "treemorph_tpu/ops/brick_conv.py:57",
        "also_replaces": "treemorph_tpu/ops/brick_conv.py:75",
        "shape": f"level 0: ({core['bricks']}, 216, {core['cin']}) halo'd "
                 f"bricks ({core['live_bricks']} with a non-zero input) x "
                 f"(27, {core['cin']}, {core['cout']}); ms, plain, bound and "
                 f"library are the core variant's (the forward), full_* the "
                 f"full variant's (the backward's d_h), dense_* both on a "
                 f"dense random tensor of the same shape",
        "max_abs_err": worst,
        "ms": core["ms"],
        "plain_ms": core["plain_ms"],
        "bound_ms": core["live_bound_ms"],
        "bound_by": core["live_bound_by"],
        "bound_note": "bound_ms counts the multiply-adds of the bricks "
                      "whose input is not all zero (this input's work) at "
                      "the f32 rate; bound_all_bricks_ms counts every brick "
                      "(PR 5's basis); *_tf32_ms the same on the TF32 "
                      "tensor cores in three passes",
        "bound_tf32_ms": core["live_bound_tf32_ms"],
        "bound_all_bricks_ms": core["bound_ms"],
        "bound_all_bricks_tf32_ms": core["bound_tf32_ms"],
        "library_ms": core["conv3d_ms"],
        "library_tf32_ms": core["conv3d_tf32_ms"],
        "library_note": "F.conv3d on the halo'd tensor's channels-first "
                        "view (a permute, no copy; cuDNN's layout handling "
                        "is inside the timed call), TF32 off; "
                        "library_tf32_ms with TF32 allowed",
        "full_ms": full["ms"],
        "full_plain_ms": full["plain_ms"],
        "full_bound_ms": full["live_bound_ms"],
        "dense_ms": dense_core["ms"],
        "dense_bound_ms": dense_core["live_bound_ms"],
        "dense_bound_tf32_ms": dense_core["live_bound_tf32_ms"],
        "dense_library_ms": dense_core["conv3d_ms"],
        "dense_full_ms": dense_full["ms"],
        "dense_full_bound_ms": dense_full["live_bound_ms"],
    }
    log(f"phase 10a ok: brick_conv within {KERNEL_RTOL} x scale of plain at "
        f"{len(rows)} level/input/variant cases, all-zero bricks exactly 0; "
        f"level 0 of the plot ({core['live_bricks']} of {core['bricks']} "
        f"bricks live): core {record['ms']:.3f} ms (bound "
        f"{record['bound_ms']:.3f} live / {record['bound_all_bricks_ms']:.3f}"
        f" all, f32; plain {record['plain_ms']:.3f}, F.conv3d "
        f"{record['library_ms']:.3f}), full {record['full_ms']:.3f} ms; "
        f"dense: core {record['dense_ms']:.3f} ms (bound "
        f"{record['dense_bound_ms']:.3f} f32, "
        f"{record['dense_bound_tf32_ms']:.3f} TF32; F.conv3d "
        f"{record['dense_library_ms']:.3f}), full "
        f"{record['dense_full_ms']:.3f} ms")
    return record, rows


def phase_brick_autograd(levels, device):
    """10b: the brick path at level 0 (``brickize`` -> ``to_dense`` ->
    ``_halo_pad`` -> ``brick_conv`` forward and backward), its launches
    counted, against autograd of ``F.conv3d`` on the same halo'd tensor in
    float64: the output, ``d_h`` and ``d_w`` within 1e-5 of scale. The
    reference is float64 because cuDNN's f32 weight gradient at this level
    (4.3M cells summed) sits 7-9e-6 of scale off float64 (the port's
    5-8e-7), too near the gate to referee it; its f32 errors are logged."""
    import torch
    import torch.nn.functional as F

    from treemorph_tpu_torch.ops.brick_conv import brick_conv
    from treemorph_tpu_torch.ops.bricks import (
        _halo_pad,
        brickize,
        conv3d_kernel,
        to_dense,
    )
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches

    c, v, _, feats, w = brick_inputs(levels, 0, device, 14)
    cap = max(c.shape[0] // BRICK_DIVISOR, 64)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    bs = brickize(c, v, cap)
    padded = _halo_pad(to_dense(feats, bs), bs).requires_grad_()
    wl = w.clone().requires_grad_()
    out = brick_conv(padded, wl)
    cot = torch.randn(out.shape, device=device,
                      generator=torch.Generator(device=device).manual_seed(15))
    out.backward(cot)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = LAUNCHES["brick_conv"]
    refs = {}
    for dtype in (torch.float64, torch.float32):
        p2 = padded.detach().to(dtype).requires_grad_()
        w2 = w.to(dtype).requires_grad_()
        ref = F.conv3d(p2.permute(0, 4, 1, 2, 3), conv3d_kernel(w2))
        ref = ref.permute(0, 2, 3, 4, 1)
        ref.backward(cot.to(dtype))
        refs[dtype] = (ref.detach(), p2.grad, w2.grad)
    names = ("out", "d_h", "d_w")
    errs = {name: share_of_scale(f"10b {name}", a, b, AUTOGRAD_RTOL)
            for name, a, b in zip(names, (out.detach(), padded.grad,
                                          wl.grad), refs[torch.float64])}
    cudnn_f32 = {name: float((a - b).abs().max() / b.abs().max())
                 for name, a, b in zip(names, refs[torch.float32],
                                       refs[torch.float64])}
    if launches != 2:
        raise AssertionError(f"10b: brick_conv launches {launches}, expected "
                             "2 (core forward, full backward)")
    log(f"phase 10b ok: level-0 brick path ({cap} bricks) forward and "
        f"backward in {secs:.3f} s (first call), against F.conv3d autograd "
        f"in float64: max |err| / scale {errs} (limit {AUTOGRAD_RTOL}); "
        f"F.conv3d's own f32 autograd against it {cudnn_f32}; brick_conv "
        f"launches {launches}")
    return launches


def phase_brick_engine(levels, device):
    """10c: ``brick_subm_conv`` (both schedules) on the card against the
    gather engine on the same level-0 voxels, valid voxels within 1e-5 of
    scale."""
    import torch

    from treemorph_tpu_torch.ops.bricks import (
        brick_subm_conv,
        from_dense,
        to_dense,
    )
    from treemorph_tpu_torch.ops.sparse import _subm_conv_impl, build_rulebook

    c, v, bs, feats, w = brick_inputs(levels, 0, device, 16)
    dense = to_dense(feats, bs)
    active = to_dense(v.float()[:, None], bs)
    ref = _subm_conv_impl(torch.float32, feats, w, build_rulebook(c, v), v)[v]
    errs = {}
    for impl in ("conv", "xslab"):
        flat = from_dense(brick_subm_conv(dense, w, bs, active, impl=impl),
                          bs)[v]
        errs[impl] = share_of_scale(f"10c brick_subm_conv {impl}", flat,
                                    ref, AUTOGRAD_RTOL)
    log(f"phase 10c ok: brick_subm_conv on {int(v.sum())} level-0 voxels "
        f"against the gather engine: max |err| / scale {errs} (limit "
        f"{AUTOGRAD_RTOL})")


def bench_tree_cloud():
    """The bench tree of the JAX package's PTv3 measurement (bench.py:86-100,
    its first tree: 131,072 points, ``profile_zband.bench_points``) in the
    (N, 11) layout, with seeded features (numpy seed 19) in columns 7:11."""
    import numpy as np

    from treemorph_tpu_torch.scripts.profile_zband import bench_points

    pts = bench_points()
    cloud = np.zeros((len(pts), 11), np.float32)
    cloud[:, :3] = pts
    cloud[:, 7:11] = np.random.default_rng(19).normal(size=(len(pts), 4))
    return cloud


def ptv3_bench_models(device, **overrides):
    """Offset and noise predictors of the pipeline's PTv3 in the bench
    configuration (``PTV3_BENCH`` with ``overrides``, seeded weights, full
    width); the noise model's semantic head prefers class 0 (keep), as
    ``ptv3_models``'."""
    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import (
        Predictor,
        build_model,
    )

    model = build_model("pointtransformerv3", device=device, seed=0,
                        **dict(PTV3_BENCH, **overrides))
    noise = model.clone()
    with torch.no_grad():
        noise.semantic_head.Dense_1.bias.copy_(torch.tensor([5.0, -5.0]))
    return (
        Predictor("pointtransformerv3", model, device),
        Predictor("pointtransformerv3", noise, device),
    )


def capture_band_inputs(predictor, cloud):
    """One forward of ``predictor`` on ``cloud`` as ``predict_single`` pads
    it; returns, per distinct (K, rows, Cin, Cout) of ``band_conv_padded``,
    the first call's arguments and the number of calls; every band plan the
    model chose (K, rows, ok, residual rows, valid rows); and the forward's
    seconds (host clock, synchronized)."""
    import torch

    from treemorph_tpu_torch.models import ptv3
    from treemorph_tpu_torch.ops import bandconv
    from treemorph_tpu_torch.pipeline.predict import _pad_flat

    calls, plans = {}, []
    kernel, choose = bandconv.band_conv_padded, ptv3.choose_band_plan

    def recording(rb_tiles, starts, feats, weights, m, win):
        key = (rb_tiles.shape[1], feats.shape[0], feats.shape[1],
               weights.shape[2])
        entry = calls.setdefault(
            key, [(rb_tiles, starts, feats, weights.detach(), m, win), 0])
        entry[1] += 1
        return kernel(rb_tiles, starts, feats, weights, m, win)

    def choosing(rulebook, valid, *args):
        plan = choose(rulebook, valid, *args)
        plans.append(dict(k=rulebook.shape[1], rows=rulebook.shape[0],
                          valid_rows=int(valid.sum()), ok=bool(plan.ok),
                          residual_rows=int(plan.res_valid.sum())))
        return plan

    coords, f, b, valid, _ = _pad_flat(cloud[:, :3], cloud[:, 7:11],
                                       device=predictor.device)
    bandconv.band_conv_padded, ptv3.choose_band_plan = recording, choosing
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = predictor.predict_flat(coords, f, b, valid)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        bandconv.band_conv_padded, ptv3.choose_band_plan = kernel, choose
    log(f"bench PTv3 forward (capturing): {secs:.3f} s, dedup_overflow "
        f"{int(res['dedup_overflow'])}, pool_overflow "
        f"{int(res['pool_overflow'])}")
    return calls, plans, secs


def phase_bench_kernels(cloud, device):
    """11a: ``band_conv_padded`` against its plain version at every
    (K, rows, Cin, Cout) of the bench configuration's forward on the bench
    tree: the main path's own inputs (bf16) and random features of the same
    rows in f32; CUDA-event times, both bounds and the plain version.
    Returns the K = 125 record, the K = 27 totals per forward and the
    rows."""
    import torch

    from treemorph_tpu_torch.ops.bandconv import (
        band_conv_padded,
        band_conv_padded_plain,
    )

    offset_model, _ = ptv3_bench_models(device)
    captured, plans, _ = capture_band_inputs(offset_model, cloud)
    for plan in plans:
        log("bench band plan " + json.dumps(plan))
    stem = [p for p in plans if p["k"] == 125]
    if len(stem) != 1:
        raise AssertionError(f"11a: {len(stem)} K = 125 plans per forward")
    gen = torch.Generator(device=device).manual_seed(11)
    rows, worst_rel = [], 0.0
    totals = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_tc_ms=0.0,
                      bytes=0.0, flops=0.0, f32_ms=0.0, calls=0)
              for k in (27, 125)}
    for (k, mp, cin, cout), (args, count) in sorted(captured.items()):
        rb_tiles, starts, feats, w, m, win = args
        nnz, rows_named, _ = window_counts(rb_tiles, starts, m, win)
        live = (torch.arange(mp, device=device) < m)[:, None]
        random_f32 = torch.randn((mp, cin), device=device,
                                 generator=gen) * live
        for dtype, f in ((torch.bfloat16, feats), (torch.float32,
                                                   random_f32)):
            call = (rb_tiles, starts, f.to(dtype).contiguous(), w, m, win)
            out = band_conv_padded(*call)
            torch.cuda.synchronize()
            err, scale = within_scale(
                f"11a band_conv K={k} ({mp}, {cin})->({mp}, {cout}) {dtype}",
                out, band_conv_padded_plain(*call), KERNEL_RTOL)
            worst_rel = max(worst_rel, err / max(scale, 1e-30))
            repeats = bool(torch.equal(out, band_conv_padded(*call)))
            ms = cuda_ms(lambda: band_conv_padded(*call), 20)
            plain_ms = cuda_ms(lambda: band_conv_padded_plain(*call), 5)
            # each input read once (the tiled rulebook, the anchors, the
            # feature rows in-window entries name, the weights), the f32
            # output written once; the in-window entries' multiply-adds
            nbytes = (rb_tiles.numel() * 4 + starts.numel() * 4
                      + rows_named * cin * call[2].element_size()
                      + k * cin * cout * 4 + mp * cout * 4)
            flops = 2.0 * nnz * cin * cout
            bound_ms, bound_by = bound(nbytes, flops)
            row = dict(k=k, rows=mp, m=m, cin=cin, cout=cout,
                       dtype=str(dtype), inputs="main path" if dtype ==
                       torch.bfloat16 else "random", calls_per_forward=count,
                       in_window_entries=nnz, rows_read=rows_named,
                       max_abs_err=err,
                       output_scale=scale, repeats_bit_for_bit=repeats,
                       ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by,
                       **tc_bound(nbytes, flops, BAND_TC[str(dtype)]))
            rows.append(row)
            log("kernel " + json.dumps(row))
            t = totals[k]
            if dtype == torch.bfloat16:
                t["calls"] += count
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("bound_ms", bound_ms), ("bytes", nbytes),
                                 ("flops", flops),
                                 ("bound_tc_ms", row["bound_tc_ms"])):
                    t[key] += count * val
            else:
                t["f32_ms"] += count * ms
    if totals[125]["calls"] != 1 or totals[27]["calls"] != PTV3_BLOCKS:
        raise AssertionError(
            f"11a: band_conv calls per forward K=125 {totals[125]['calls']}, "
            f"K=27 {totals[27]['calls']}; expected 1 and {PTV3_BLOCKS}")
    records = {}
    for k, t in totals.items():
        records[k] = {
            "shape": "; ".join(
                f"({mp}, {cin})->({mp}, {cout}) x{count}"
                for (kk, mp, cin, cout), (_, count) in sorted(
                    captured.items()) if kk == k),
            "ms": t["ms"], "f32_ms": t["f32_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": bound(t["bytes"], t["flops"])[1],
            "bound_tc_ms": t["bound_tc_ms"],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["k"] == k),
            "max_err_over_scale": max(r["max_abs_err"] / r["output_scale"]
                                      for r in rows if r["k"] == k),
            "library_ms": None,
        }
    stem_plan = stem[0]
    records[125].update(plan_ok=stem_plan["ok"],
                        residual_rows=stem_plan["residual_rows"],
                        valid_rows=stem_plan["valid_rows"])
    log(f"phase 11a ok: band_conv within {KERNEL_RTOL} x scale of plain at "
        f"{len(rows)} shape/type cases of the bench PTv3 forward (worst "
        f"{worst_rel:.2e} of scale); stem plan ok {stem_plan['ok']}, "
        f"{stem_plan['residual_rows']} residual rows of "
        f"{stem_plan['valid_rows']}; per forward (bf16): K=125 "
        f"{totals[125]['ms']:.4f} ms (bound {totals[125]['bound_ms']:.4f}, "
        f"plain {totals[125]['plain_ms']:.3f}), K=27 x{PTV3_BLOCKS} "
        f"{totals[27]['ms']:.3f} ms (bound {totals[27]['bound_ms']:.3f}, "
        f"TC {totals[27]['bound_tc_ms']:.3f}, plain "
        f"{totals[27]['plain_ms']:.3f})")
    return records, rows


def bench_forward(cloud, device, perturb=0.0, **overrides):
    """The offset model's forward (the one ``predict_single`` runs) in the
    bench configuration on ``device``: its offsets and logits on the cloud's
    points, seconds, overflow counts and band launches by K. ``perturb``
    moves every weight by that share of itself (seeded), to read how far
    the outputs move under a change below any rounding of the inputs."""
    import torch

    from treemorph_tpu_torch.ops import bandconv
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.pipeline.predict import _pad_flat

    offset_model, _ = ptv3_bench_models(device, **overrides)
    if perturb:
        gen = torch.Generator(device=device).manual_seed(12)
        with torch.no_grad():
            for p in offset_model.model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, device=device,
                                                 generator=gen))
    coords, f, b, v, n = _pad_flat(cloud[:, :3], cloud[:, 7:11],
                                   device=device)
    bandconv.GATHER_ROUTES.clear()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = offset_model.predict_flat(coords, f, b, v)
    out = {k: res[k][:n].float().cpu().numpy()
           for k in ("offset_predictions", "semantic_prediction_logits")}
    out.update(seconds=time.perf_counter() - t0,
               dedup_overflow=int(res["dedup_overflow"]),
               pool_overflow=int(res["pool_overflow"]),
               k125=LAUNCHES["band_conv_k125"], k27=LAUNCHES["band_conv_k27"],
               routes=dict(bandconv.GATHER_ROUTES))
    log(f"  bench PTv3 forward on {device} ({overrides or 'bf16'}"
        f"{f', weights moved by {perturb}' if perturb else ''}): "
        f"{out['seconds']:.2f} s, dedup_overflow {out['dedup_overflow']}, "
        f"pool_overflow {out['pool_overflow']}, band_conv launches K=125 "
        f"{out['k125']}, K=27 {out['k27']}, GATHER_ROUTES {out['routes']}")
    return out


def compare_forwards(label, a, b):
    """Offsets' max |a - b| over b's scale, and the agreement of the
    semantic argmax as the head gives it and at the median margin of b
    (half the points on each side)."""
    import numpy as np

    err = float(np.abs(a["offset_predictions"]
                       - b["offset_predictions"]).max())
    scale = float(np.abs(b["offset_predictions"]).max())
    ma, mb = (o["semantic_prediction_logits"] @ np.array([-1.0, 1.0])
              for o in (a, b))
    median = float(np.median(mb))
    row = {"offset_err_over_scale": err / scale, "offset_scale": scale,
           "argmax_agreement": float(((ma > 0) == (mb > 0)).mean()),
           "class1_share": float((mb > 0).mean()),
           "median_margin_agreement": float(((ma > median)
                                             == (mb > median)).mean()),
           "finite": bool(all(np.isfinite(o[k]).all() for o in (a, b)
                              for k in ("offset_predictions",
                                        "semantic_prediction_logits")))}
    log(f"{label}: " + json.dumps(row))
    return row


def phase_bench_card_vs_cpu(cloud, device):
    """11b: the bench configuration's forward on the card and on the CPU,
    the same seeded weights, on the bench tree. bf16 (the configuration;
    the CPU's forward is the offset model's inside its ``predict_single``):
    offsets within PTV3_BENCH_OFFSET_RTOL of their scale, the keep decision
    of ``predict_single``'s noise model agreeing on >= 99.9 % of points (its
    ``predict_single`` run below); the
    offset head's own argmax is logged beside the card against itself with
    every weight moved by 1e-6 of its value (how far bf16 roundings move
    under any change of sum order). The same configuration in f32: offsets
    within PTV3_OFFSET_RTOL and the argmax, as given and at the median
    margin, on >= 99.9 %. No dedup or pool overflow; band launches per
    forward by K. Then ``predict_single`` with both predictors on the card
    and on the CPU (the same kept points within the agreement above, their
    refined positions within the offset limit), launches counted. Returns
    the K = 125 and K = 27 launches of the card's call."""
    import numpy as np
    import torch

    from treemorph_tpu_torch.ops import bandconv
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.pipeline.predict import predict_single

    card = bench_forward(cloud, device)
    floor = compare_forwards(
        "bench PTv3 bf16, card vs card with every weight moved by 1e-6",
        bench_forward(cloud, device, perturb=1e-6), card)
    f32_card = bench_forward(cloud, device, compute_dtype="float32")
    f32 = compare_forwards("bench PTv3 f32, card vs cpu", f32_card,
                           bench_forward(cloud, "cpu",
                                         compute_dtype="float32"))

    refined, keep, launches, retries = {}, {}, None, _RetryCounter()
    cpu = {}
    predict_log = logging.getLogger("treemorph_tpu_torch.pipeline.predict")
    for dev in (device, "cpu"):
        offset, noise = ptv3_bench_models(dev)
        if dev == device:
            offset_model = offset
        offset_forward = offset.predict_flat
        noise_forward = noise.predict_flat

        def offset_recording(*args, forward=offset_forward):
            # the CPU offset model's forward, as bench_forward returns it:
            # the bf16 reference of the card's forward above
            res = forward(*args)
            cpu.update({
                **{k: res[k][:len(cloud)].float().cpu().numpy()
                   for k in ("offset_predictions",
                             "semantic_prediction_logits")},
                "dedup_overflow": int(res["dedup_overflow"]),
                "pool_overflow": int(res["pool_overflow"])})
            return res

        def recording(*args, dev=dev, forward=noise_forward):
            # the noise model's logits: predict_single keeps class 0
            res = forward(*args)
            logits = res["semantic_prediction_logits"][:len(cloud)]
            keep[dev] = logits.float().cpu().numpy().argmax(1) == 0
            return res

        if dev == "cpu":
            offset.predict_flat = offset_recording
        noise.predict_flat = recording
        predict_log.addHandler(retries)
        if dev == device:
            torch.cuda.synchronize()
        reset_launches()
        bandconv.GATHER_ROUTES.clear()
        t0 = time.perf_counter()
        refined[dev] = predict_single(cloud, offset, noise, device=dev)
        if dev == device:
            torch.cuda.synchronize()
            launches = {125: LAUNCHES["band_conv_k125"],
                        27: LAUNCHES["band_conv_k27"]}
            single_routes = sum(bandconv.GATHER_ROUTES.values())
        predict_log.removeHandler(retries)
        log(f"bench PTv3 predict_single on {dev}: "
            f"{time.perf_counter() - t0:.2f} s, {len(refined[dev])} of "
            f"{len(cloud)} points kept, routed to the gather engine "
            f"{dict(bandconv.GATHER_ROUTES)}, retries so far "
            f"{retries.retries}, all launches {dict(LAUNCHES)}")
    bf16 = compare_forwards("bench PTv3 bf16, card vs cpu (the CPU's "
                            "forward inside its predict_single)", card, cpu)
    walls = forward_walls(offset_model, cloud)
    keep_agreement = float((keep[device] == keep["cpu"]).mean())
    both = keep[device] & keep["cpu"]
    rows = {dev: np.cumsum(k)[both] - 1 for dev, k in keep.items()}
    limit = PTV3_BENCH_OFFSET_RTOL * bf16["offset_scale"]
    moved = float(np.abs(refined[device][rows[device]]
                         - refined["cpu"][rows["cpu"]]).max())
    log(f"bench PTv3 predict_single card vs cpu: keep decisions agree on "
        f"{keep_agreement:.5f} of the points, {int(both.sum())} kept by "
        f"both, refined positions max |diff| {moved:.3e} (limit "
        f"{limit:.3e}); "
        f"band_conv launches on the card K=125 {launches[125]}, K=27 "
        f"{launches[27]}")
    routed = sum(card["routes"].values())
    checks = {
        "finite": bf16["finite"] and f32["finite"],
        f"bf16 offsets within {PTV3_BENCH_OFFSET_RTOL} x scale":
            bf16["offset_err_over_scale"] <= PTV3_BENCH_OFFSET_RTOL,
        f"f32 offsets within {PTV3_OFFSET_RTOL} x scale":
            f32["offset_err_over_scale"] <= PTV3_OFFSET_RTOL,
        "f32 argmax agreement": min(f32["argmax_agreement"],
                                    f32["median_margin_agreement"])
        >= STAGE1_ARGMAX_AGREEMENT,
        "no dedup or pool overflow": all(
            o[k] == 0 for o in (card, cpu, f32_card)
            for k in ("dedup_overflow", "pool_overflow")),
        "band launches per forward": card["k125"] + card["k27"] + routed
        == PTV3_BLOCKS + 1 and card["k27"] > 0,
        "band launches in predict_single": launches[125] + launches[27]
        + single_routes == 2 * (PTV3_BLOCKS + 1) and launches[27] > 0
        and retries.retries == 0,
        "predict_single keeps the points its noise model says":
            all(len(refined[d]) == int(keep[d].sum()) > 0 for d in keep),
        "predict_single keep decisions agree":
            keep_agreement >= STAGE1_ARGMAX_AGREEMENT,
        "predict_single refined positions within the offset limit":
            moved <= limit,
    }
    for name, ok in checks.items():
        log(f"  {'ok ' if ok else 'FAIL'} {name}")
    if not all(checks.values()):
        raise AssertionError("11b: the bench PTv3 configuration failed")
    log(f"phase 11b ok (the offset head's argmax, bf16: card vs cpu "
        f"{bf16['argmax_agreement']:.5f}, card vs itself with weights moved "
        f"by 1e-6 {floor['argmax_agreement']:.5f}); one forward on the card "
        f"{statistics.median(walls):.4f} s (median of {len(walls)}: {walls})")
    return launches


def forward_walls(predictor, cloud, reps=3) -> list:
    """Wall seconds of ``reps`` forwards of ``predictor`` on ``cloud`` as
    ``predict_single`` pads it (host clock around synchronized work)."""
    import torch

    from treemorph_tpu_torch.pipeline.predict import _pad_flat

    args = _pad_flat(cloud[:, :3], cloud[:, 7:11],
                     device=predictor.device)[:4]
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict_flat(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def phase_bench_end_to_end(cloud, device, reps=3):
    """11c: the bench configuration through ``run_pipeline`` on the PTv3
    plot (band launches counted), its stages timed; the wall time of one
    forward (host clock around synchronized work, median of ``reps``); one
    forward under ``torch.profiler``."""
    from treemorph_tpu_torch.ops import bandconv

    models = ptv3_bench_models(device)
    plot_end_to_end(cloud, "pointtransformerv3", models, device, "band_conv",
                    PTV3_BLOCKS + 1, bandconv.GATHER_ROUTES)
    walls = forward_walls(models[0], cloud, reps)
    log(f"bench PTv3 forward on the plot ({len(cloud)} points): wall "
        f"{statistics.median(walls):.4f} s (median of {reps}: {walls})")
    profile_forward(models[0], cloud)
    log("phase 11c ok")


#: 6d's steps card against CPU (and in float64) take the first points of
#: 2 trees of the batch: on whole trees the CPU's two steps took 23-36 s
K5_CUT_POINTS = 4096


def phase_k5_train_step(batch, capacity, device, plans_ok):
    """6d: ``TreeLearn(kernel_size=5, engine="band")`` training, every conv
    5x5x5 (K = 125). One f32 train step on a cut of 2 trees x
    K5_CUT_POINTS points, band engine
    against gather engine on the card (held as 6a holds K = 27), both
    logged against the same step in float64 on the CPU; the bf16 band step
    card against CPU; then full-width bf16 steps on the 30-tree batch,
    launches counted on one: ``band_conv_bwd`` once per conv whose
    features need a gradient and the K = 125 forward kernel once per
    forward conv and per ``d_feats``, on the levels whose plan is ``ok``
    (``plans_ok``, phase 5 at K = 125). Returns the step's launches."""
    import torch

    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.train import families, harness

    cut = batch.map(lambda a: a[:2, :K5_CUT_POINTS].contiguous())
    compare_engine_steps(
        one_train_step(cut, "band", "float32", device, 5),
        one_train_step(cut, "gather", "float32", device, 5),
        one_train_step(cut, "gather", "float64", "cpu", 5))
    compare_steps("K = 125 train step, card vs CPU, bf16 band engine",
                  one_train_step(cut, "band", "bfloat16", device, 5),
                  one_train_step(cut, "band", "bfloat16", "cpu", 5),
                  STEP_LOSS_RTOL, STEP_GRAD_RTOL)

    model = training_model(capacity, TRAIN_TREES, kernel_size=5).to(device)
    state = harness.TrainState(model, harness.make_optimizer(model))
    step = harness.make_train_step(*families.treelearn_family())
    torch.cuda.reset_peak_memory_stats(device)
    seconds = []
    for _ in range(2):  # the second step is timed without first-call costs
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        _, metrics = step(state, batch, 1e-2)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if not torch.isfinite(torch.as_tensor(metrics["loss"])):
            raise AssertionError("K = 125 step: non-finite loss")
    launches = dict(LAUNCHES)
    want_bwd = sum(count for level, cin, _, count in LEVEL_CONVS
                   if cin != 7 and plans_ok[level])
    want_fwd = want_bwd + sum(count for level, _, _, count in LEVEL_CONVS
                              if plans_ok[level])
    record = {"k5_train_step_seconds": seconds[1],
              "k5_train_first_step_seconds": seconds[0],
              "k5_train_peak_memory_gb":
                  torch.cuda.max_memory_allocated(device) / 1e9,
              "k5_plans_ok": plans_ok, "k5_launches_per_step": launches,
              "k5_expected_band_conv_bwd": want_bwd,
              "k5_expected_band_conv_k125": want_fwd}
    log(json.dumps(record))
    if not (launches.get("band_conv_bwd") == want_bwd > 0
            and launches.get("band_conv_k125") == want_fwd
            and not launches.get("band_conv_k27")):
        raise AssertionError("K = 125 step: launches differ from the plans")
    log("phase 6d ok")
    return launches


#: PointNet2, the pipeline's third family: 12a compares two rasters of the
#: plot, each cut to this many points, card against CPU (f32 throughout:
#: the MLPs' matmuls sum in another order on the card; sampling rounds
#: alike on both)
PN2_CHECK_POINTS = 4096
PN2_OFFSET_RTOL = 1e-3
PN2_ARGMAX_AGREEMENT = 0.999


def pointnet2_models(device):
    """Offset and noise predictors of the pipeline's PointNet2 (depth 5,
    seeded weights); as in :func:`pipeline_models`, the noise model's
    semantic head prefers class 0 (keep)."""
    import copy

    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import (
        Predictor,
        build_model,
    )

    model = build_model("pointnet2", device=device, seed=0)
    noise = copy.deepcopy(model)
    with torch.no_grad():
        noise.semantic_head.Dense_1.bias.copy_(torch.tensor([5.0, -5.0]))
    return (Predictor("pointnet2", model, device),
            Predictor("pointnet2", noise, device))


class _SamplingRecorder:
    """Swaps PointNet2's sampling functions for ones that keep a CPU copy
    of every index tensor they return, in call order."""

    names = ("bucketed_farthest_point_sample", "query_ball_point")

    def __enter__(self):
        from treemorph_tpu_torch.models import pointnet2

        self.module, self.saved = pointnet2, {}
        self.seen = {name: [] for name in self.names}
        for name in self.names:
            fn = self.saved[name] = getattr(pointnet2, name)
            setattr(pointnet2, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.seen[name].append(out.cpu())
            return out
        return recorded

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def phase_pointnet2_card_vs_cpu(points, device):
    """12a: the pipeline's PointNet2 (depth 5, seeded) on two rasters of the
    plot cut to PN2_CHECK_POINTS points, card against CPU: offsets within
    PN2_OFFSET_RTOL of their scale, the semantic argmax agreeing on
    PN2_ARGMAX_AGREEMENT of the points; the shares of identical FPS and
    ball-query indices are reported."""
    import numpy as np
    import torch

    from treemorph_tpu_torch.pipeline.predict import raster_assignments

    idx = [i for _, i in raster_assignments(points, 1.0, 1.0)
           if len(i) >= PN2_CHECK_POINTS][:2]
    coords = np.stack([points[i[:PN2_CHECK_POINTS], :3]
                       for i in idx]).astype(np.float32)
    feats = np.zeros((*coords.shape[:2], 4), np.float32)
    valid = np.ones(coords.shape[:2], bool)
    outs, seen = [], []
    for dev in (device, "cpu"):
        model, _ = pointnet2_models(dev)
        with _SamplingRecorder() as rec:
            res = model.predict_padded(coords, feats, valid)
        outs.append({k: v.float().cpu().numpy() for k, v in res.items()})
        seen.append(rec.seen)
    card, cpu = outs
    err, scale = within_scale(
        "12a PointNet2 offsets, card vs cpu",
        torch.from_numpy(card["offset_predictions"]),
        torch.from_numpy(cpu["offset_predictions"]), PN2_OFFSET_RTOL)
    agree = float((card["semantic_prediction_logits"].argmax(-1)
                   == cpu["semantic_prediction_logits"].argmax(-1)).mean())
    shares = {}
    for name in _SamplingRecorder.names:
        pairs = list(zip(seen[0][name], seen[1][name]))
        same = sum(int((a == b).sum()) for a, b in pairs)
        shares[name] = same / sum(a.numel() for a, _ in pairs)
    record = {"pn2_check_shape": list(coords.shape),
              "pn2_offset_err": err, "pn2_offset_scale": scale,
              "pn2_argmax_agreement": agree,
              "pn2_identical_index_share": shares}
    log(json.dumps(record))
    if agree < PN2_ARGMAX_AGREEMENT:
        raise AssertionError(f"12a: argmax agreement {agree:.5f}")
    log("phase 12a ok")
    return record


#: PointNet2's parts, timed in its profiles as ``record_function``
#: scopes: the sampling functions (by their names in models/pointnet2.py)
#: and the modules (by class)
PN2_SCOPES = {"fps": "bucketed_farthest_point_sample",
              "ball query": "query_ball_point",
              "3-NN interpolation": "three_nn_interpolate"}
PN2_MODULE_SCOPES = ("MLPs", "heads")


def pn2_profile(fn, label):
    """:func:`profile_device` of ``fn`` with PointNet2's sampling
    functions, its MLPs and its heads each inside a ``record_function``
    scope (PN2_SCOPES, PN2_MODULE_SCOPES), so that the profile gives their
    spans on the device."""
    from torch.profiler import record_function

    from treemorph_tpu_torch.models import pointnet2

    classes = dict(zip(PN2_MODULE_SCOPES,
                       (pointnet2.PointwiseMLP, pointnet2.Head)))
    saved = ({a: getattr(pointnet2, a) for a in PN2_SCOPES.values()},
             {c: c.forward for c in classes.values()})

    def scoped(label, fn):
        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return run

    try:
        for label_, attr in PN2_SCOPES.items():
            setattr(pointnet2, attr, scoped(label_, getattr(pointnet2, attr)))
        for label_, cls in classes.items():
            cls.forward = scoped(label_, cls.forward)
        return profile_device(fn, label,
                              ranges=(*PN2_SCOPES, *PN2_MODULE_SCOPES))
    finally:
        for attr, f in saved[0].items():
            setattr(pointnet2, attr, f)
        for cls, f in saved[1].items():
            cls.forward = f


def raster_minibatch(points):
    """The first minibatch ``predict_rasterized`` builds for the plot:
    (coords, feats, valid) numpy arrays of (60, max_pts) points, the
    rasters' count and max_pts."""
    import numpy as np

    from treemorph_tpu_torch.pipeline.predict import (
        pad_to_bucket,
        raster_assignments,
    )

    rasters = raster_assignments(points, 1.0, 1.0)
    max_pts = pad_to_bucket(max(len(i) for _, i in rasters), 512)
    coords = np.zeros((60, max_pts, 3), np.float32)
    valid = np.zeros((60, max_pts), bool)
    for i, (_, idx) in enumerate(rasters[:60]):
        coords[i, :len(idx)] = points[idx, :3]
        valid[i, :len(idx)] = True
    log(f"plot rasters: {len(rasters)} (1 m, stride 1 m), points "
        f"{min(len(i) for _, i in rasters)}..{max(len(i) for _, i in rasters)}"
        f", padded to {max_pts}; valid share of a (60, {max_pts}) minibatch "
        f"{valid.mean():.4f}")
    return (coords, np.zeros((60, max_pts, 4), np.float32), valid,
            len(rasters), max_pts)


def phase_pointnet2_end_to_end(points, device):
    """12b: the plot through ``run_pipeline`` with the pointnet2 family,
    its stages timed, with peak device memory; 12c: exact FPS at the
    first set abstraction's shape timed with CUDA events, and one
    minibatch forward under ``torch.profiler`` with the spans on the
    device of FPS, the ball queries, the 3-NN interpolations, the MLPs
    and the heads."""
    import torch

    from treemorph_tpu_torch.models.pointnet2 import SA_CONFIGS
    from treemorph_tpu_torch.ops.sampling import farthest_point_sample

    models = pointnet2_models(device)
    _, record = plot_end_to_end(points, "pointnet2", models, device, None, 0)
    log("phase 12b ok")

    coords, feats, valid, n_rasters, max_pts = raster_minibatch(points)
    xyz = torch.from_numpy(coords).to(device)
    mask = torch.from_numpy(valid).to(device)
    npoint = SA_CONFIGS[5][0][0]
    fps_ms = cuda_ms(lambda: farthest_point_sample(xyz, mask, npoint), 5)
    models[0].predict_padded(coords, feats, valid)  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    profile = pn2_profile(
        lambda: models[0].predict_padded(coords, feats, valid),
        "PointNet2 minibatch forward")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    record.update(pn2_rasters=n_rasters, pn2_max_points=max_pts,
                  pn2_fps_ms=fps_ms, pn2_fps_shape=[60, max_pts, npoint],
                  pn2_minibatch_forward_seconds=profile["seconds"],
                  pn2_minibatch_peak_memory_gb=peak_gb,
                  pn2_minibatch_profile=profile)
    log(json.dumps({k: v for k, v in record.items()
                    if k != "pn2_minibatch_profile"}))
    log("phase 12c ok")
    return record


#: PointNet2 training (13a): the reference's batch, 60 rasters x 4,096
#: points (scripts/bench_training.py:27-31, its elements built as
#: :35-63 builds them), the pipeline's depth 5, exact FPS, f32. Card
#: against CPU with the same weights, batch and FPS starts: the loss, every
#: gradient against the step's largest, the BN running statistics against
#: their scale (the MLPs' matmuls sum in another order on the card)
PN2_TRAIN_RASTERS, PN2_TRAIN_POINTS, PN2_DEPTH = 60, 4096, 5
PN2_STEP_LOSS_RTOL = 1e-5
#: the gradients' f32 sum-order noise at this batch (max-pool winners and
#: ReLUs that flip, BatchNorm sums over 245,760 rows): the port against
#: itself on the CPU with the batch's rasters reversed (the same function,
#: other sum orders) moves a gradient by up to 5.0e-4 of the largest
#: (2.1e-2 of its own leaf's scale); card and CPU differ by 3.8e-4 (an
#: NVIDIA H100 80GB HBM3 at 700 W)
PN2_STEP_GRAD_RTOL = 2e-3
PN2_BN_RTOL = 1e-5
#: parameters whose exact gradient is 0 (a BatchNorm follows and removes
#: their shift) carry rounding noise that grows with the rows summed: on
#: the 13a step (60 x 4,096 points) up to 3.8e-4 of the largest gradient
#: apart card vs CPU, on the 13c step 2.3e-4 band vs gather; they are held
#: near 0 in both steps, not to each other
ZERO_GRAD_RTOL = 1e-3
#: PTv3's stage depths at full width (encoder, decoder)
PTV3_DEPTHS = ((2, 2, 2, 6, 2), (2, 2, 2, 2))
#: 13b: the training plots rasterized at 1 m, stride 0.5; the reference's
#: minibatch of 60 rasters; trees per optimizer step (the CLI's default
#: --batch_size); epochs of the hierarchical run and of the raster run
PN2_RASTER, PN2_STRIDE, PN2_MINIBATCH, PN2_TREES_PER_STEP = 1.0, 0.5, 60, 4
PN2_HIER_EPOCHS, PN2_RASTER_EPOCHS = 2, 1
#: 13c: the PTv3 CLI's band configuration (--engine band --dedup_divisor 4
#: --conv_dtype bfloat16, scripts/train.py:130-143); band vs gather in
#: f32 on the card; card vs CPU in bf16 on a 2-tree cut
PTV3_CLI_BAND = dict(dedup_divisor=4, stem_engine="band")
#: band against gather in f32 on the card, the gradients: the two engines
#: differ by 1.3e-4-2.3e-4 of the largest gradient (NVIDIA H100 80GB HBM3,
#: 700 W), above ENGINE_RTOL, while the f32 step on a 2-tree cut moves its
#: gradients by 7.6e-4 of the largest when every weight moves by 1e-6 of
#: itself (max-pool winners that flip; on the CPU); the band step
#: run twice on the card is logged beside it
PTV3_BAND_ENGINE_RTOL = 1e-3
PTV3_BAND_EPOCHS = 1
#: card vs CPU, one bf16 step in that configuration (2-tree cut): the loss
#: to STEP_LOSS_RTOL; the gradients are chaotic in bf16 (max-pool winners
#: and bf16 roundings that flip under another sum order): the same CPU
#: step with every weight moved by 1e-6 of itself moves them by 4.6e-2 of
#: the largest gradient (4.9e-2 in L2 over all of them), card and CPU
#: differ by 5.9e-2-9.9e-2 (NVIDIA H100 80GB HBM3, 700 W); the card's own
#: floor (weights moved by 1e-6) is logged beside it. This bound only
#: catches a step gone wrong as a whole: the bf16 band backward's calls are
#: held one by one to KERNEL_RTOL (:func:`phase_ptv3_band_bwd_calls`)
PTV3_BF16_GRAD_RTOL = 0.2
#: 13d: stage 2's target for the pipeline CLI's held-out tree (16,384
#: points): the shipped 1,000,000 would make stage 3 fit a million-point
#: cloud three times over
PIPELINE_CLI_MIN_POINTS = 40_000


def pn2_zero_grad(name: str) -> bool:
    """PointNet2's parameters of exact gradient 0: every Dense bias that a
    BatchNorm follows (all but each head's output Dense)."""
    return (name.endswith(".bias") and ".Dense_" in name
            and "head.Dense_1" not in name)


def ptv3_zero_grad(name: str) -> bool:
    """PTv3's parameters of exact gradient 0: each head's hidden Dense
    bias, the Dense biases that feed the pooling's and unpooling's
    BatchNorms, and each stage's last block's MLP output bias (only
    Dense + BatchNorm pairs read that level next)."""
    import re

    m = re.fullmatch(r"backbone\.(enc|dec)(\d+)_block(\d+)\.mlp\.Dense_1"
                     r"\.bias", name)
    if m:
        depths = PTV3_DEPTHS[m.group(1) == "dec"]
        return int(m.group(3)) == depths[int(m.group(2))] - 1
    return name.endswith(("head.Dense_0.bias", "_down.proj.bias",
                          "_up.proj.bias", "_up.proj_skip.bias"))


def pn2_training_samples(n, seed=0):
    """``n`` TreeSamples of PN2_TRAIN_POINTS points each
    (:func:`synthetic_labeled_trees`, numpy seed ``seed``), labeled as the
    data layer labels them."""
    import numpy as np

    from treemorph_tpu_torch.data.treeset import TreeSample

    samples = []
    for pts, offs, feats in synthetic_labeled_trees(
            np.random.default_rng(seed), n, PN2_TRAIN_POINTS):
        norm = np.linalg.norm(offs, axis=1)
        samples.append(TreeSample(
            points=pts, feats=feats, offsets=offs,
            semantic_label=(norm > 0.05).astype(np.int32),
            offset_mask=norm <= 0.05, path="bench"))
    return samples


def pn2_train_state(device):
    """The training CLI's PointNet2 (depth 5, dim_feat 4) with seeded
    weights on ``device``, and its optimizer."""
    from treemorph_tpu_torch.models.pointnet2 import PointNet2
    from treemorph_tpu_torch.train import families, harness

    model = families.init_pointnet2(
        PointNet2(depth=PN2_DEPTH, dim_feat=4), 0).to(device)
    return harness.TrainState(model, harness.make_optimizer(model))


def watch_optimizer_step(keep_grads: bool):
    """Swap ``harness.optimizer_step`` for one that first notes its call:
    a CPU copy of the gradients it is handed (before its clip), by
    position, when ``keep_grads``, else the learning rate. Returns the
    list of notes and the original, to put back."""
    from treemorph_tpu_torch.train import harness

    seen, step = [], harness.optimizer_step

    def watching(optimizer, lr):
        params = (p for g in optimizer.param_groups for p in g["params"])
        seen.append({i: p.grad.detach().cpu().clone()
                     for i, p in enumerate(params)} if keep_grads else lr)
        step(optimizer, lr)

    harness.optimizer_step = watching
    return seen, step


def pn2_steps_on(device, batches):
    """One ``make_train_step`` on ``batches[0]`` (step generator seed 1),
    then one ``make_accum_steps`` group of all ``batches`` (seeds 2, 3,
    ...), each from the same seeded weights, on ``device``: per run the
    losses, the gradients the optimizer saw (named) and the BN running
    statistics after it."""
    import torch

    from treemorph_tpu_torch.train import families, harness

    family = families.pointnet2_family()
    runs = []
    seen, step = watch_optimizer_step(keep_grads=True)
    try:
        state = pn2_train_state(device)
        names = [n for n, _ in state.model.named_parameters()]
        _, m = harness.make_train_step(*family)(
            state, batches[0].map(lambda a: a.to(device)), 1e-2,
            torch.Generator().manual_seed(1))
        runs.append(([float(m["loss"])], state))
        state = pn2_train_state(device)
        accum_step, apply_step = harness.make_accum_steps(*family)
        losses = []
        for i, batch in enumerate(batches):
            _, m = accum_step(state, batch.map(lambda a: a.to(device)),
                              torch.Generator().manual_seed(2 + i))
            losses.append(float(m["loss"]))
        apply_step(state, 1e-2)
        runs.append((losses, state))
    finally:
        harness.optimizer_step = step
    if len(seen) != 2:
        raise AssertionError(f"{len(seen)} optimizer steps, expected 2")
    return [(losses, {names[i]: g for i, g in grads.items()},
             {n: b.cpu() for n, b in state.model.named_buffers()})
            for (losses, state), grads in zip(runs, seen)]


def phase_pointnet2_train_step(device):
    """13a: one PointNet2 train step and one accumulation group of two
    minibatches at the reference's batch (60 rasters x 4,096 points, depth
    5, exact FPS, f32), card against CPU with the same weights, batches and
    FPS starts; then the card's step split into forward, backward and
    optimizer (host clock around synchronized work, median of 3 after a
    warm-up), peak device memory, and one step under ``torch.profiler``
    with the device spans of FPS, ball queries, 3-NN interpolation, MLPs
    and heads."""
    from treemorph_tpu_torch.data import make_padded_batch
    from treemorph_tpu_torch.train import families, harness

    t0 = time.perf_counter()
    samples = pn2_training_samples(2 * PN2_TRAIN_RASTERS)
    batches = [harness.to_device(make_padded_batch(
        samples[i:i + PN2_TRAIN_RASTERS], PN2_TRAIN_POINTS), "cpu")
        for i in (0, PN2_TRAIN_RASTERS)]
    log(f"13a batches: 2 x {tuple(batches[0].coords.shape)} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    card = pn2_steps_on(device, batches)
    t1 = time.perf_counter()
    cpu = pn2_steps_on("cpu", batches)
    log(f"13a: card {t1 - t0:.2f} s, CPU {time.perf_counter() - t1:.2f} s "
        f"(one step and one 2-minibatch group each, from fresh weights)")
    again = pn2_steps_on(device, batches)[0]
    compare_steps("13a PointNet2 train step, card twice (atomic sum order; "
                  "logged, not a gate)", (sum(again[0]), again[1]),
                  (sum(card[0][0]), card[0][1]), 1.0, 1.0, pn2_zero_grad)
    record = {}
    for label, (lc, gc, bc), (lr, gr, br) in zip(
            ("train step", "accumulation group"), card, cpu):
        compare_steps(f"13a PointNet2 {label}, card vs CPU",
                      (sum(lc), gc), (sum(lr), gr),
                      PN2_STEP_LOSS_RTOL, PN2_STEP_GRAD_RTOL, pn2_zero_grad)
        worst = 0.0
        for name, ref in br.items():
            if not name.endswith(("running_mean", "running_var")):
                continue
            worst = max(worst, share_of_scale(
                f"13a {label} BN {name}", bc[name], ref, PN2_BN_RTOL))
        losses = [float(x) for x in lc]
        record[label.replace(" ", "_")] = {
            "losses_card": losses, "losses_cpu": [float(x) for x in lr],
            "bn_stats_worst_share_of_scale": worst}
        log(f"  {label}: BN running statistics within {worst:.2e} of "
            f"their scale (limit {PN2_BN_RTOL})")

    batch = batches[0].map(lambda a: a.to(device))
    split, step = seeded_step_split(pn2_train_state(device).model,
                                    families.pointnet2_family(), batch,
                                    device)
    record.update({f"pn2_train_{k}": split[k] for k in (
        "step_seconds", "forward_seconds", "backward_seconds",
        "optimizer_seconds", "peak_memory_gb")},
        pn2_train_points_per_step=int(batch.mask_valid.sum()))
    log(json.dumps(record))
    record["pn2_train_step_profile"] = pn2_profile(
        lambda: step(9), "PointNet2 train step")
    log("phase 13a ok")
    return record


def phase_pointnet2_training_cli(root, device):
    """13b: the training plots rasterized (1 m, stride 0.5; metadata JSON
    and raster files), then the training CLI's ``pointnet2`` on them:
    ``--hierarchical_json`` (minibatches of 60 rasters, gradients
    accumulated over PN2_TREES_PER_STEP trees a step) for PN2_HIER_EPOCHS
    epochs, then ``--raster_dir`` (60 rasters a step) for
    PN2_RASTER_EPOCHS; losses finite and falling, optimizer steps counted
    against tree groups, the checkpoint loaded through ``load_model``.
    Returns the record and the checkpoint directory."""
    import glob
    import math

    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import load_model
    from treemorph_tpu_torch.preprocess import rasterize_clouds
    from treemorph_tpu_torch.train import cli, harness

    paths = sorted(glob.glob(os.path.join(root, "*_labeled.npy")))
    meta_path = os.path.join(root, "rasters.json")
    t0 = time.perf_counter()
    meta = rasterize_clouds(paths, output_dir=root, json_path=meta_path,
                            raster_size=PN2_RASTER, stride=PN2_STRIDE,
                            store_metadata=True)
    raster_dir = os.path.join(root,
                              f"rasterized_R{PN2_RASTER}_S{PN2_STRIDE}")
    n_files = len(os.listdir(raster_dir))
    per_tree = [len(v["rasters"]) for v in meta.values()]
    rasterize_s = time.perf_counter() - t0
    log(f"13b rasterized {len(paths)} trees in {rasterize_s:.1f} s: "
        f"{n_files} raster files, {min(per_tree)}..{max(per_tree)} rasters "
        f"a tree")
    train_keys = [k for k in meta if not k.startswith("1_")]
    groups = -(-len(train_keys) // PN2_TREES_PER_STEP)
    minibatches = sum(-(-len(meta[k]["rasters"]) // PN2_MINIBATCH)
                      for k in train_keys)
    save_dir = os.path.join(root, "pn2_saves")
    common = ["pointnet2", "--test_plots", "1", "--depth", str(PN2_DEPTH),
              "--bucket", "1024", "--save_dir", save_dir,
              "--device", str(device)]
    runs = {
        "hierarchical": (common + [
            "--hierarchical_json", meta_path, "--minibatch_size",
            str(PN2_MINIBATCH), "--batch_size", str(PN2_TREES_PER_STEP),
            "--epochs", str(PN2_HIER_EPOCHS), "--name", "pointnet2"],
            PN2_HIER_EPOCHS * groups),
        "raster": (common + [
            "--raster_dir", raster_dir, "--batch_size", str(PN2_MINIBATCH),
            "--epochs", str(PN2_RASTER_EPOCHS), "--name", "pointnet2_raster"],
            None),
    }
    record = {"pn2_rasterize_seconds": rasterize_s,
              "pn2_raster_files": n_files,
              "pn2_train_minibatches_per_epoch": minibatches,
              "pn2_train_groups_per_epoch": groups}
    checks = {}
    for label, (argv, want_steps) in runs.items():
        log("training CLI: python -m treemorph_tpu_torch.train.cli "
            + " ".join(argv))
        steps, step = watch_optimizer_step(keep_grads=False)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            history = cli.main(argv)[1]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            harness.optimizer_step = step
        for r in history:
            log("epoch " + json.dumps(r))
        losses = [r[k] for r in history for k in ("train_loss", "val_loss")]
        name = argv[argv.index("--name") + 1]
        ckpt = os.path.join(save_dir, f"{name}_CV")
        checks[f"{label}: every loss finite"] = all(
            math.isfinite(x) for x in losses)
        checks[f"{label}: checkpoint loads"] = "O_P1" in load_model(
            "pointnet2", ckpt, device=device)
        if want_steps is not None:
            checks[f"{label}: {want_steps} optimizer steps (tree groups, "
                   f"not {PN2_HIER_EPOCHS * minibatches} minibatches)"] = (
                len(steps) == want_steps)
            checks[f"{label}: train loss falls"] = (
                history[-1]["train_loss"] < history[0]["train_loss"])
        record[f"pn2_cli_{label}"] = {
            "seconds": secs, "optimizer_steps": len(steps),
            "train_losses": [r["train_loss"] for r in history],
            "val_losses": [r["val_loss"] for r in history]}
        log(f"13b {label}: {secs:.2f} s, {len(steps)} optimizer steps")
    for name, ok in checks.items():
        log(f"  {'ok ' if ok else 'FAIL'} {name}")
    if not all(checks.values()):
        raise AssertionError("13b PointNet2 training CLI checks failed")
    log(json.dumps(record))
    log("phase 13b ok")
    return record, os.path.join(save_dir, "pointnet2_CV")


def ptv3_band_step(batch, device, compute_dtype, stem_engine="band",
                   perturb=0.0):
    """Loss and parameter gradients (clipped as the step clips them) of one
    ``make_train_step`` of the training CLI's PTv3 with dedup_divisor 4 and
    ``stem_engine`` at ``drop_path`` 0 (step generator seed 1, seeded
    weights, each moved by ``perturb`` of itself times N(0, 1) from seed 7)
    on ``device``."""
    import torch

    from treemorph_tpu_torch.models.ptv3 import PointTransformerWithHeads
    from treemorph_tpu_torch.train import families, harness

    model = families.init_ptv3(PointTransformerWithHeads(
        dim_feat=4, use_feats=True, voxel_size=0.02, drop_path=0.0,
        compute_dtype=compute_dtype, **dict(PTV3_CLI_BAND,
                                            stem_engine=stem_engine)), 0)
    if perturb:
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=gen))
    model = model.to(device)
    state = harness.TrainState(model, harness.make_optimizer(model))
    _, metrics = harness.make_train_step(*families.ptv3_family())(
        state, batch.map(lambda a: a.to(device)), 1e-2,
        torch.Generator().manual_seed(1))
    return float(metrics["loss"]), {n: p.grad.float().cpu()
                                    for n, p in model.named_parameters()}


def phase_ptv3_band_bwd_calls(batch, device) -> dict:
    """13c: every ``band_conv_bwd_padded`` call of one bf16 card step in
    the CLI's band configuration (the 22 K = 27 xCPEs; the stem's weight
    gradient takes the gather formulation) held against its plain version
    on the same inputs, twice: with the step's own cotangent (what the
    step used) and with a random one of its shape and type. ``d_feats``
    and ``d_w`` each within KERNEL_RTOL of their own scale."""
    import torch

    from treemorph_tpu_torch.ops import bandconv

    kernel, calls = bandconv.band_conv_bwd_padded, []

    def keep(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out

    bandconv.band_conv_bwd_padded = keep
    try:
        ptv3_band_step(batch, device, "bfloat16")
    finally:
        bandconv.band_conv_bwd_padded = kernel
    gen = torch.Generator(device=device).manual_seed(3)
    worst, shapes = {"step": 0.0, "random": 0.0}, set()
    for args, out in calls:
        rb_tiles, starts, grad, feats, w_bwd, m, win = args
        shape = (rb_tiles.shape[1], feats.shape[1], grad.shape[1],
                 str(grad.dtype).removeprefix("torch."))
        shapes.add(shape)
        g_random = torch.zeros_like(grad)
        g_random[:m] = torch.randn((m, grad.shape[1]), device=device,
                                   generator=gen).to(grad.dtype)
        for kind, g in (("step", grad), ("random", g_random)):
            got = out if kind == "step" else kernel(
                rb_tiles, starts, g, feats, w_bwd, m, win)
            ref = bandconv.band_conv_bwd_padded_plain(
                rb_tiles, starts, g, feats, w_bwd, m, win)
            for label, a, b in zip(("d_feats", "d_w"), got, ref):
                worst[kind] = max(worst[kind], share_of_scale(
                    f"13c band_conv_bwd {label}, K, Cin, Cout, type {shape}, "
                    f"{kind} cotangent", a, b, KERNEL_RTOL))
    log(f"13c: {len(calls)} band_conv_bwd calls of one bf16 card step "
        f"((K, Cin, Cout, type): {sorted(shapes)}), each against its plain "
        f"version: within {worst['step']:.2e} of scale with the step's own "
        f"cotangents, {worst['random']:.2e} with random ones (limit "
        f"{KERNEL_RTOL})")
    if not (len(calls) == PTV3_BLOCKS and {k for k, *_ in shapes} == {27}):
        raise AssertionError("13c: the band backward did not run once for "
                             "each xCPE at K = 27")
    return {"ptv3_band_bwd_calls": len(calls),
            "ptv3_band_bwd_worst_step_share": worst["step"],
            "ptv3_band_bwd_worst_random_share": worst["random"]}


def phase_ptv3_band_cli(root, device):
    """13c: the PTv3 CLI's band configuration at full width (4 trees x
    16,384 points a step): one epoch of ``pointtransformerv3 --engine band
    --dedup_divisor 4 --conv_dtype bfloat16`` with its launches counted per
    step and per validation forward, every band plan's ``ok``, and
    GATHER_ROUTES; each band backward call of one bf16 card step against
    its plain version (:func:`phase_ptv3_band_bwd_calls`); one f32 step
    band against gather on the card; one bf16 step card against CPU on a
    2-tree cut; the step split and one step under ``torch.profiler``. Returns the record (launches per step) and
    the checkpoint directory."""
    import math

    import torch

    from treemorph_tpu_torch.models import ptv3
    from treemorph_tpu_torch.ops import bandconv
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.train import cli, families

    save_dir = os.path.join(root, "ptv3_band_saves")
    argv = ["pointtransformerv3", "--data_root", root, "--test_plots", "1",
            "--epochs", str(PTV3_BAND_EPOCHS), "--batch_size",
            str(PTV3_TRAIN_TREES), "--bucket", str(TRAIN_POINTS),
            "--engine", "band", "--dedup_divisor", "4", "--conv_dtype",
            "bfloat16", "--save_dir", save_dir, "--device", str(device)]
    log("training CLI: python -m treemorph_tpu_torch.train.cli "
        + " ".join(argv))
    plans, choose = [], ptv3.choose_band_plan

    def choosing(rulebook, valid, *args):
        plan = choose(rulebook, valid, *args)
        plans.append((rulebook.shape[1], bool(getattr(plan, "ok", False))))
        return plan

    bandconv.GATHER_ROUTES.clear()
    ptv3.choose_band_plan = choosing
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        history = cli.main(argv)[1]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        ptv3.choose_band_plan = choose
    launches, routes = dict(LAUNCHES), dict(bandconv.GATHER_ROUTES)
    per_epoch = -(-TRAIN_TREES * (TRAIN_PLOTS - 1) // PTV3_TRAIN_TREES)
    val_batches = -(-TRAIN_TREES // PTV3_TRAIN_TREES)
    steps = PTV3_BAND_EPOCHS * per_epoch
    forwards = steps + PTV3_BAND_EPOCHS * val_batches
    for r in history:
        log("epoch " + json.dumps(r))
    plans_ok = all(ok for _, ok in plans)
    log(f"13c training CLI: {secs:.2f} s for {PTV3_BAND_EPOCHS} epoch of "
        f"{steps} steps and {forwards - steps} validation forwards; "
        f"launches {launches}; band plans {len(plans)}, all ok {plans_ok} "
        f"(by K: {sorted(set(k for k, _ in plans))}); GATHER_ROUTES "
        f"{routes}")
    # per train step: the K = 125 stem forward; 22 K = 27 xCPE forwards and
    # their 22 d_feats launches (the forward kernel on the transposed
    # weights); 22 band_conv_bwd; 22 of each attention kernel. Per
    # validation forward: the stem, 22 K = 27 and 22 attention launches
    want = {
        "band_conv_k125": forwards,
        "band_conv_k27": 2 * PTV3_BLOCKS * steps + PTV3_BLOCKS * (
            forwards - steps),
        "band_conv_bwd": PTV3_BLOCKS * steps,
        "window_attention": PTV3_BLOCKS * forwards,
        "window_attention_bwd": PTV3_BLOCKS * steps,
    }
    exact = plans_ok and not routes
    losses = [r[k] for r in history for k in ("train_loss", "val_loss")]
    checks = {"every loss finite": all(math.isfinite(x) for x in losses)}
    for key, n in want.items():
        got = launches.get(key, 0)
        checks[f"{key}: {n} launches"] = (
            got == n if exact or key.startswith("window") else 0 < got <= n)
    for name, ok in checks.items():
        log(f"  {'ok ' if ok else 'FAIL'} {name}")
    if not all(checks.values()):
        raise AssertionError("13c PTv3 band CLI checks failed")

    batch = ptv3_training_batch(root, device)
    bwd_calls = phase_ptv3_band_bwd_calls(batch, device)
    band = ptv3_band_step(batch, device, "float32")
    gather = ptv3_band_step(batch, device, "float32", "gather")
    compare_steps("13c PTv3 band configuration, band vs gather, f32, card",
                  band, gather, ENGINE_LOSS_RTOL, PTV3_BAND_ENGINE_RTOL,
                  ptv3_zero_grad)
    compare_steps("13c PTv3 band configuration, band twice, f32, card "
                  "(atomic sum order; logged, not a gate)",
                  ptv3_band_step(batch, device, "float32"), band, 1.0, 1.0,
                  ptv3_zero_grad)
    cut = ptv3_training_batch(root, "cpu", 2).map(
        lambda a: a[:, :PTV3_CPU_STEP_POINTS].contiguous())
    t0 = time.perf_counter()
    card = ptv3_band_step(cut, device, "bfloat16")
    t1 = time.perf_counter()
    cpu = ptv3_band_step(cut, "cpu", "bfloat16")
    log(f"  2-tree bf16 step ({PTV3_CPU_STEP_POINTS} points a tree): "
        f"card {t1 - t0:.2f} s, CPU "
        f"{time.perf_counter() - t1:.2f} s")
    compare_steps("13c PTv3 band configuration, card vs CPU, bf16", card,
                  cpu, STEP_LOSS_RTOL, PTV3_BF16_GRAD_RTOL, ptv3_zero_grad)
    compare_steps("13c PTv3 band configuration, bf16, card with every weight "
                  "moved by 1e-6 (the chaos floor; logged, not a gate)",
                  ptv3_band_step(cut, device, "bfloat16", perturb=1e-6),
                  card, 1.0, 1.0, ptv3_zero_grad)

    model = families.init_ptv3(ptv3.PointTransformerWithHeads(
        dim_feat=4, use_feats=True, voxel_size=0.02,
        compute_dtype="bfloat16", **PTV3_CLI_BAND), 0).to(device)
    split, step = seeded_step_split(model, families.ptv3_family(), batch,
                                    device)
    record = {
        "ptv3_band_cli_seconds": secs, "ptv3_band_cli_steps": steps,
        "ptv3_band_cli_losses": [r["train_loss"] for r in history],
        "ptv3_band_cli_launches": launches,
        "ptv3_band_cli_plans": len(plans),
        "ptv3_band_cli_plans_ok": plans_ok,
        "ptv3_band_cli_gather_routes": routes,
        **{f"ptv3_band_{k}": split[k] for k in (
            "step_seconds", "forward_seconds", "backward_seconds",
            "optimizer_seconds", "peak_memory_gb", "launches_per_step")},
        # points whose voxel missed the level-0 dedup cap (P / 4 rows),
        # and pooled rows over their caps, per timed step
        "ptv3_band_dedup_and_pool_overflow": [
            (o["dedup_overflow"], o["pool_overflow"])
            for o in split["overflows"]],
        "ptv3_band_valid_points": int(batch.mask_valid.sum()),
        **bwd_calls,
    }
    log(json.dumps(record))
    record["ptv3_band_step_profile"] = profile_device(
        lambda: step(4), "PTv3 band-configuration train step")
    log("phase 13c ok")
    return record, os.path.join(save_dir, "pointtransformerv3_CV")


def yaml_text(value, indent=0) -> str:
    """``value`` (dicts, lists of scalars, str, bool, int, float, None) as
    block YAML, strings double-quoted (JSON strings are YAML double-quoted
    scalars): the card's machine has no YAML library."""
    pad = " " * indent
    lines = []
    for key, v in value.items():
        if isinstance(v, dict):
            lines.append(f"{pad}{key}:\n{yaml_text(v, indent + 2)}")
        elif isinstance(v, list):
            lines.append(f"{pad}{key}:")
            lines.extend(f"{pad}  - {json.dumps(x)}" for x in v)
        else:
            lines.append(f"{pad}{key}: {json.dumps(v)}")
    return "\n".join(lines)


def pipeline_treelearn_checkpoint(root, device) -> str:
    """13d's TreeLearn checkpoint: the training CLI (band engine, bf16) at
    2 trees a step for one epoch, 30 steps, so that its BatchNorms' running
    statistics (momentum 0.1) settle. 6b's 6 steps leave them near their
    initial values, and its eval-mode offsets are metres (a CPU run of 3
    steps on a cut: mean 5.5 m; 30 steps: 2.7 mm)."""
    from treemorph_tpu_torch.train import cli

    save_dir = os.path.join(root, "pipeline_saves")
    argv = ["treelearn", "--data_root", root, "--test_plots", "1",
            "--epochs", "1", "--batch_size", "2", "--bucket",
            str(TRAIN_POINTS), "--engine", "band", "--conv_dtype", "bfloat16",
            "--save_dir", save_dir, "--device", str(device)]
    log("training CLI: python -m treemorph_tpu_torch.train.cli "
        + " ".join(argv))
    t0 = time.perf_counter()
    (record,) = cli.main(argv)[1]
    log(f"13d TreeLearn checkpoint: {time.perf_counter() - t0:.2f} s, "
        f"epoch {json.dumps(record)}")
    return os.path.join(save_dir, "treelearn_CV")


def phase_pipeline_cli(root, checkpoints, device):
    """13d: ``python -m treemorph_tpu_torch.scripts.exec_pipeline
    --config`` with no injected model, once per family, its ``model_dirs``
    naming the training CLI's checkpoints (``checkpoints``: family ->
    directory: 13b's, 13c's and :func:`pipeline_treelearn_checkpoint`'s),
    a JSON config for TreeLearn, YAML for PointNet2 and PTv3,
    on one held-out tree's cloud (plot 1's first tree), stage 2's target
    lowered to PIPELINE_CLI_MIN_POINTS; per family: points kept, > 0
    cylinders, the CSV written."""
    import re

    import numpy as np

    with open(os.path.join(root, "plot_1.json")) as f:
        tree = json.load(f)[0]
    inp = os.path.join(root, "pipeline_in")
    os.makedirs(inp, exist_ok=True)
    np.save(os.path.join(inp, "tree.npy"), np.load(tree))
    record, checks, calls = {}, {}, []
    for family, ckpt in checkpoints.items():
        cfg = pipeline_config(inp, os.path.join(root, "pipeline_out"),
                              family)
        cfg["general"]["save_model_predictions"] = False
        cfg["stage2"]["min_points"] = PIPELINE_CLI_MIN_POINTS
        # PointNet2's stage-2 cloud feeds 17c
        cfg["general"]["save_upsampling"] = family == "pointnet2"
        cfg["model_dirs"] = {family: [ckpt, ckpt]}
        if family == "treelearn":
            path = os.path.join(root, f"pipeline_{family}.json")
            text = json.dumps(cfg, indent=2)
        else:
            path = os.path.join(root, f"pipeline_{family}.yaml")
            text = yaml_text(cfg) + "\n"
        with open(path, "w") as f:
            f.write(text)
        calls.append(("exec_pipeline",
                      ["--config", path, "--device", str(device)]))
    # one process per family, all started together
    runs = run_modules(calls)
    for family, (_, args), (stdout, secs, stderr) in zip(checkpoints, calls,
                                                         runs):
        m = re.search(r"tree\.npy: (\d+) pts, (\d+) cylinders", stdout)
        csv = os.path.join(root, "pipeline_out", family,
                           "tree_qsm_depth_cylinders.csv")
        points, cylinders = (int(m.group(1)), int(m.group(2))) if m else (0,
                                                                          0)
        record[family] = {"seconds": secs, "points": points,
                          "cylinders": cylinders,
                          "config": os.path.splitext(args[1])[1][1:]}
        log(f"13d {family}: {stdout.strip()} ({secs:.1f} s with the "
            f"process start, the three started together)")
        if not cylinders:
            log(f"13d {family}: no cylinder; the process's stderr ends "
                f"{stderr[-3000:]}")
        checks[f"{family}: points kept"] = points > 0
        checks[f"{family}: cylinders"] = cylinders > 0
        checks[f"{family}: CSV written"] = os.path.exists(csv)
    for name, ok in checks.items():
        log(f"  {'ok ' if ok else 'FAIL'} {name}")
    if not all(checks.values()):
        raise AssertionError("13d pipeline CLI checks failed")
    log(json.dumps({"pipeline_cli": record}))
    log("phase 13d ok")
    return record


#: 14a: the JAX package's TreeLearn deployment checkpoint (orbax, written by
#: ``treemorph_tpu/train/checkpoints.py::save_model_checkpoint`` at the
#: pipeline's width, the noise head's final bias at [5, -5]) and the
#: SHA-256 of each of its leaves, committed under tests/data
JAX_CHECKPOINT = os.path.join(REPO, "tests", "data", "jax_treelearn_P3")
#: 14b: labeling the plot on the card against the CPU (the same port
#: functions): cylinder ids agree on this share of the points, and offsets
#: within LABEL_OFFSET_RTOL of the cloud's extent where they do; normals
#: |dot| >= NORMAL_MIN_DOT on NORMAL_AGREEMENT of the points (a point
#: whose two smallest covariance eigenvalues nearly tie has no settled
#: normal); relative heights within HEIGHT_ATOL
LABEL_ID_AGREEMENT = 0.999
#: 14b's card-against-CPU comparison runs on this many points of the plot
#: (seeded, in the plot's order): the CPU's projection of the whole plot
#: took 39 s
LABEL_CPU_POINTS = 65_536
LABEL_OFFSET_RTOL = 1e-4
NORMAL_MIN_DOT, NORMAL_AGREEMENT = 0.999, 0.999
HEIGHT_ATOL = 1e-6
#: 14c: raw synthetic trees drawn as scripts/bench_training.py:39-44 draws
#: them (``default_rng(0)``, 4,000 points/m^2), written as plots 1 and 2 of
#: 15 trees each (the CV fold trains on plot 1 and validates on plot 2);
#: trees per training step
LABEL_TREES, LABEL_PLOT_TREES, LABEL_TRAIN_BATCH = 30, 15, 5
#: f32 operations per point-cylinder pair of ``ops/projection.py::
#: _project_tile`` (its subtractions, products, sums, clamps, square
#: roots, divisions, selects and the argmin, counted from the code), and
#: the bytes per point (xyz in; id, distance and offset out) and per
#: cylinder (start, unit axis, length, radius, id, valid) of
#: ``closest_cylinder``: the projection's bound in 14b
PROJECTION_OPS_PER_PAIR = 69
PROJECTION_BYTES_PER_POINT, PROJECTION_BYTES_PER_CYLINDER = 12 + 20, 37


def leaf_sha256(tree, path=()) -> dict:
    """SHA-256 of each leaf's bytes of a checkpoint the orbax reader read,
    keyed by its '/'-joined key path (a bfloat16 tensor as its 16-bit
    patterns, a Python number as its repr)."""
    import hashlib

    import numpy as np
    import torch

    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = path + (str(k),)
        if isinstance(v, (dict, list)):
            out.update(leaf_sha256(v, key))
            continue
        if isinstance(v, torch.Tensor):
            data = v.view(torch.int16).numpy().tobytes()
        elif isinstance(v, (int, float)):
            data = repr(v).encode()
        else:
            data = np.ascontiguousarray(v).tobytes()
        out["/".join(key)] = hashlib.sha256(data).hexdigest()
    return out


def jax_serving_models(loaded, device):
    """Phase 4's serving TreeLearn (band engine, bf16, voxel capacity P / 2)
    on ``device``, holding the weights ``load_model`` read from the JAX
    checkpoint: the (offset, noise) predictors of plot 3."""
    from treemorph_tpu_torch.evaluation.model_loaders import (
        Predictor,
        build_model,
    )

    out = []
    for key in ("O_P3", "N_P3"):
        model = build_model("treelearn", voxel_capacity_divisor=2,
                            engine="band", conv_dtype="bfloat16",
                            device=device)
        model.load_state_dict(loaded[key].model.state_dict())
        out.append(Predictor("treelearn", model, device))
    return tuple(out)


def phase_jax_checkpoint(points, device):
    """14a: the committed JAX checkpoint read by the port's orbax reader
    (every leaf's SHA-256 as recorded), copied as the offset and noise
    model directories of plot 3 (``TreeLearn_{O,N}_P3``), loaded by
    ``load_model`` on the card and on the CPU, then served as phase 4
    serves: stage 1 card against CPU at phase 3's limits, and the plot
    through ``run_pipeline`` (kept points, >= MIN_POINTS upsampled, > 0
    cylinders, 21 band launches a forward)."""
    import numpy as np

    from treemorph_tpu_torch.evaluation.model_loaders import load_model
    from treemorph_tpu_torch.ops import bandconv
    from treemorph_tpu_torch.train.orbax_reader import read_checkpoint

    src = os.path.join(JAX_CHECKPOINT, "checkpoint")
    t0 = time.perf_counter()
    tree = read_checkpoint(src)
    read_s = time.perf_counter() - t0
    with open(os.path.join(JAX_CHECKPOINT, "arrays.sha256.json")) as f:
        want = json.load(f)
    got = leaf_sha256(tree)
    mismatched = sorted(k for k in want.keys() | got.keys()
                        if want.get(k) != got.get(k))
    params = sum(np.asarray(v).size
                 for v in leaf_arrays(tree["params"]))
    log(f"14a: orbax reader {read_s:.3f} s, {len(got)} leaves, {params} "
        f"parameters, SHA-256 mismatches {len(mismatched)} "
        f"{mismatched[:5]}")
    if mismatched or not got:
        raise AssertionError("14a: the checkpoint's leaves differ from "
                             "arrays.sha256.json")
    loaded, load_s = {}, {}
    with tempfile.TemporaryDirectory() as root:
        dirs = []
        for role, tag in (("offset", "O"), ("noise", "N")):
            dst = os.path.join(root, role, f"TreeLearn_{tag}_P3")
            shutil.copytree(src, dst)
            shutil.copyfile(src + ".metadata.json", dst + ".metadata.json")
            dirs.append(os.path.dirname(dst))
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            loaded[str(dev)] = load_model("treelearn", *dirs, device=dev)
            load_s[str(dev)] = time.perf_counter() - t0
    log(f"14a: load_model {json.dumps(load_s)} s, predictors "
        f"{sorted(loaded[str(device)])}")
    if sorted(loaded[str(device)]) != ["N_P3", "O_P3"]:
        raise AssertionError("14a: load_model found no O_P3 / N_P3")

    def models(dev):
        return jax_serving_models(loaded["cpu" if str(dev) == "cpu"
                                         else str(device)], dev)

    phase_stage1_card_vs_cpu(points, device, models, "phase 14a stage 1")
    _, record = plot_end_to_end(points, "treelearn", models(device), device,
                                "band_conv", 21, bandconv.GATHER_ROUTES)
    record.update(reader_seconds=read_s, load_model_seconds=load_s,
                  leaves=len(got), params=params)
    log(json.dumps({"jax_checkpoint": record}))
    log("phase 14a ok")
    return record


def leaf_arrays(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, list)):
            yield from leaf_arrays(v)
        else:
            yield v


def phase_label_plot(points, csv_path, device):
    """14b: phase 4's raw plot labeled against the cylinders its stage 3
    fitted: ``generate_offset_cloud`` (the (N, M) projection in 4,096-point
    tiles) and ``add_features`` (normals from the 15-NN covariance, relative
    height), on the card (twice: the first call and a second one); then on
    a seeded cut of LABEL_CPU_POINTS points on the card and on the CPU:
    ids, offsets, normals and heights held card against CPU;
    seconds, point-cylinder pairs per second and peak device memory."""
    import numpy as np
    import torch

    from treemorph_tpu_torch.ops.features import add_features
    from treemorph_tpu_torch.ops.projection import generate_offset_cloud
    from treemorph_tpu_torch.utils.table import Table

    qsm = Table.read_csv(csv_path)
    pairs = len(points) * len(qsm)
    bytes_ms = 1e3 * (len(points) * PROJECTION_BYTES_PER_POINT
                      + len(qsm) * PROJECTION_BYTES_PER_CYLINDER) \
        / HBM_BYTES_PER_S
    ops_ms = 1e3 * pairs * PROJECTION_OPS_PER_PAIR / F32_FLOPS
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"14b: {len(points)} points x {len(qsm)} cylinders = {pairs} "
        f"point-cylinder pairs; the projection's bound {bound_ms:.4f} ms "
        f"({bound_by})")
    rng = np.random.default_rng(14)
    cut = points[np.sort(rng.choice(len(points), LABEL_CPU_POINTS,
                                    replace=False))]
    record = {"points": len(points), "cylinders": len(qsm), "pairs": pairs,
              "projection_bound_ms": bound_ms, "projection_bound_by":
              bound_by, "cpu_cut_points": len(cut)}
    # the whole plot twice on the card (timed), then the cut on the card
    # and on the CPU (compared)
    out = []
    for tag, dev, cloud in (("card0", device, points),
                            ("card1", device, points),
                            ("card_cut", device, cut),
                            ("cpu_cut", "cpu", cut)):
        card = dev != "cpu"
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        labeled = generate_offset_cloud(cloud, qsm, device=dev)
        if card:
            torch.cuda.synchronize()
            proj_peak = torch.cuda.max_memory_allocated(dev) / 1e9
            torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        out.append(add_features(labeled, device=dev))
        if card:
            torch.cuda.synchronize()
            feat_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        t2 = time.perf_counter()
        cloud_pairs = len(cloud) * len(qsm)
        record[tag] = {
            "projection_seconds": t1 - t0,
            "pairs_per_second": cloud_pairs / (t1 - t0),
            "features_seconds": t2 - t1,
            **({"projection_peak_gb": proj_peak,
                "features_peak_gb": feat_peak} if card else {}),
        }
        log(f"14b {tag}: {json.dumps(record[tag])}")
    plot, card, cpu = out[1], out[2], out[3]
    same = card[:, 6] == cpu[:, 6]
    extent = float(np.ptp(cut, axis=0).max())
    off_err = float(np.abs(card[same, 3:6] - cpu[same, 3:6]).max())
    dots = np.abs((card[:, 7:10] * cpu[:, 7:10]).sum(axis=1))
    height_err = float(np.abs(card[:, 10] - cpu[:, 10]).max())
    record.update(id_agreement=float(same.mean()), offset_max_err=off_err,
                  extent=extent,
                  normal_agreement=float((dots >= NORMAL_MIN_DOT).mean()),
                  normal_min_dot=float(dots.min()), height_max_err=height_err)
    checks = {
        "11 finite columns": plot.shape == (len(points), 11)
        and bool(np.isfinite(plot).all()),
        f"ids agree on >= {LABEL_ID_AGREEMENT}":
            same.mean() >= LABEL_ID_AGREEMENT,
        f"offsets within {LABEL_OFFSET_RTOL} x extent":
            off_err <= LABEL_OFFSET_RTOL * extent,
        f"normals |dot| >= {NORMAL_MIN_DOT} on >= {NORMAL_AGREEMENT}":
            (dots >= NORMAL_MIN_DOT).mean() >= NORMAL_AGREEMENT,
        f"heights within {HEIGHT_ATOL}": height_err <= HEIGHT_ATOL,
    }
    for name, ok in checks.items():
        log(f"  {'ok ' if ok else 'FAIL'} {name}")
    log(json.dumps({"label_plot": record}))
    if not all(checks.values()):
        raise AssertionError("14b labeling checks failed")
    log("phase 14b ok")
    return record


def write_raw_training_trees(raw_dir, qsm_dir):
    """14c's raw trees (:data:`LABEL_TREES`) and their QSM CSVs, named
    ``{plot}_{tree}``."""
    import numpy as np

    from treemorph_tpu_torch.fixtures import (
        synthetic_qsm,
        synthetic_tree_cloud,
    )

    os.makedirs(raw_dir)
    os.makedirs(qsm_dir)
    rng = np.random.default_rng(0)
    sizes = []
    for i in range(LABEL_TREES):
        qsm = synthetic_qsm(rng=rng)
        pts, _ = synthetic_tree_cloud(qsm=qsm, points_per_m2=4000, rng=rng)
        stem = f"{1 + i // LABEL_PLOT_TREES}_{i}"
        np.save(os.path.join(raw_dir, f"{stem}.npy"), pts)
        qsm.to_csv(os.path.join(qsm_dir, f"{stem}_000000.csv"))
        sizes.append(len(pts))
    return sizes


def phase_preprocess_cli(device):
    """14c: ``python -m treemorph_tpu_torch.scripts.preprocess`` ``label``
    and ``noise`` (on the card; two processes started together), then its
    ``main`` with ``split`` in this process, over raw synthetic
    trees and their QSMs, then the TreeLearn training CLI (band engine,
    bf16, the noise clouds as ``--noise_root``) for one epoch on what they
    wrote: every labeled and noise file (N, 11) and finite, the manifests
    naming every tree, the losses finite, ``band_conv_bwd`` launched
    ``BWD_PER_STEP`` times per backbone pass (two a step: the cloud and its
    noise cloud)."""
    import math

    import numpy as np
    import torch

    from treemorph_tpu_torch.ops import bandconv
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.scripts import preprocess as preprocess_cli
    from treemorph_tpu_torch.train import cli

    record, checks = {}, {}
    with tempfile.TemporaryDirectory() as root:
        raw, qsm, data = (os.path.join(root, d)
                          for d in ("raw", "qsm", "data"))
        t0 = time.perf_counter()
        sizes = write_raw_training_trees(raw, qsm)
        record["raw_trees"] = {"seconds": time.perf_counter() - t0,
                               "points": sizes}
        commands = {
            "label": ["--cloudDir", raw, "--cylinderDir", qsm, "--labelDir",
                      os.path.join(data, "cloud"), "--device", str(device)],
            "noise": ["--cylinderDir", qsm, "--labelDir",
                      os.path.join(data, "noise"), "--device", str(device)],
            "split": ["--data_root", data],
        }
        # label and noise read only the raw trees and QSMs: two processes
        # started together; split (file lists alone) in this one
        runs = run_modules([("preprocess", [c, *commands[c]])
                            for c in ("label", "noise")])
        for command, (stdout, secs, _) in zip(("label", "noise"), runs):
            record[command] = {"seconds": secs, "stdout": stdout.strip()}
            log(f"14c {command}: {stdout.strip()} ({secs:.1f} s with the "
                "process start)")
        log("14c: preprocess split " + " ".join(commands["split"]))
        t0 = time.perf_counter()
        preprocess_cli.main(["split", *commands["split"]])
        record["split"] = {"seconds": time.perf_counter() - t0}
        for kind in ("cloud", "noise"):
            names = sorted(os.listdir(os.path.join(data, kind)))
            arrays = [np.load(os.path.join(data, kind, n)) for n in names]
            checks[f"{kind}: {LABEL_TREES} files"] = \
                len(names) == LABEL_TREES
            checks[f"{kind}: (N, 11), no NaN"] = all(
                a.ndim == 2 and a.shape[1] == 11 and np.isfinite(a).all()
                for a in arrays)
            record[f"{kind}_points"] = [len(a) for a in arrays]
        labeled = sorted(os.path.join(data, "cloud", n)
                         for n in os.listdir(os.path.join(data, "cloud")))
        manifests = {}
        for name in ("plot_1", "plot_2", "trainset", "testset"):
            with open(os.path.join(data, f"{name}.json")) as f:
                manifests[name] = json.load(f)
        checks["plot manifests name every tree"] = sorted(
            manifests["plot_1"] + manifests["plot_2"]) == labeled
        checks["train and test sets name every tree"] = sorted(
            manifests["trainset"] + manifests["testset"]) == labeled

        argv = ["treelearn", "--data_root", data, "--test_plots", "2",
                "--epochs", "1", "--batch_size", str(LABEL_TRAIN_BATCH),
                "--bucket", str(TRAIN_POINTS), "--engine", "band",
                "--conv_dtype", "bfloat16", "--noise_root",
                os.path.join(data, "noise"), "--save_dir",
                os.path.join(root, "saves"), "--device", str(device)]
        log("14c: python -m treemorph_tpu_torch.train.cli " + " ".join(argv))
        bandconv.GATHER_ROUTES.clear()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        history = cli.main(argv)[2]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        routes = dict(bandconv.GATHER_ROUTES)
    steps = -(-LABEL_PLOT_TREES // LABEL_TRAIN_BATCH)
    expected = 2 * BWD_PER_STEP * steps
    bwd = launches.get("band_conv_bwd", 0)
    losses = [r[k] for r in history for k in ("train_loss", "val_loss")]
    record["train"] = {"seconds": secs, "steps": steps, "history": history,
                       "launches": launches, "gather_routes": routes}
    log(f"14c training CLI: {secs:.2f} s, {steps} steps, launches "
        f"{launches}, GATHER_ROUTES {routes}, history {history}")
    checks["one epoch, losses finite"] = len(history) == 1 and all(
        math.isfinite(x) for x in losses)
    checks[f"band_conv_bwd launches {expected}"] = (
        bwd == expected if not routes else 0 < bwd <= expected)
    for name, ok in checks.items():
        log(f"  {'ok ' if ok else 'FAIL'} {name}")
    log(json.dumps({"preprocess_cli": record}))
    if not all(checks.values()):
        raise AssertionError("14c preprocessing chain checks failed")
    log("phase 14c ok")
    return bwd, record


#: 15d: the reference system's state-dict names for the port's modules
#: (the inverse of ``train/import_torch.py``'s converters, test code):
#: (port key pattern, reference key) rewrites tried in order, ``{p}`` the
#: TreeLearn U-Net prefix, and the tensor layout each takes
_TREELEARN_BLOCK_NAMES = {
    "MaskedBatchNorm_0": "conv_branch.0", "SubMConv_0.kernel":
    "conv_branch.2.weight", "MaskedBatchNorm_1": "conv_branch.3",
    "SubMConv_1.kernel": "conv_branch.5.weight", "shortcut":
    "i_branch.0.weight",
}
_PTV3_BLOCK_NAMES = {
    "cpe.kernel": "cpe.0.weight", "cpe.bias": "cpe.0.bias",
    "cpe.Dense_0": "cpe.1", "cpe.LayerNorm_0": "cpe.2", "norm1": "norm1.0",
    "norm2": "norm2.0", "mlp.Dense_0": "mlp.0.fc1", "mlp.Dense_1":
    "mlp.0.fc2", "attn.qkv": "attn.qkv", "attn.proj": "attn.proj",
    "attn.rpe_table": "attn.rpe.rpe_table",
}
_HEAD_NAMES = {"Dense_0": "0", "MaskedBatchNorm_0": "1", "BatchNorm_0": "1",
               "Dense_1": "3"}


def _rename(rest: str, table: dict) -> str:
    """``rest`` with the longest matching module prefix of ``table``
    renamed."""
    for old in sorted(table, key=len, reverse=True):
        if rest == old or rest.startswith(old + "."):
            return table[old] + rest[len(old):]
    raise KeyError(rest)


def _reference_key(family: str, key: str, n_fp: int = 0) -> str:
    """The reference system's state-dict key of a port ``key`` (``n_fp``:
    PointNet2's feature-propagation modules; ``FeaturePropagation_j`` is
    the reference's ``fp{n_fp - j}``, ``SetAbstraction_j`` its
    ``sa{j + 1}``)."""
    import re

    parts = key.split(".")
    if parts[0] in ("semantic_head", "offset_head"):
        head = {"semantic_head": "semantic_linear",
                "offset_head": "offset_linear"}[parts[0]]
        sub = _rename(".".join(parts[1:]), _HEAD_NAMES)
        return f"{head}.{'net.' if family == 'pointnet2' else ''}{sub}"
    if family == "pointnet2":
        kind, j = parts[0].rsplit("_", 1)
        layer = int(parts[2].rsplit("_", 1)[1])
        kind_name, k = (("sa", int(j) + 1) if kind == "SetAbstraction"
                        else ("fp", n_fp - int(j)))
        return (f"{kind_name}{k}.mlp_"
                f"{'convs' if parts[2].startswith('Dense') else 'bns'}."
                f"{layer}.{parts[3]}")
    if family == "treelearn":
        rest = ".".join(parts[1:])
        if rest.startswith("input_conv."):
            return "input_conv.0.weight"
        if rest.startswith("output_norm."):
            return "output_layer.0." + parts[-1]
        m = re.match(r"(unet(?:\.u)*)\.(.*)", rest)
        prefix, sub = m.group(1), m.group(2)
        block = re.match(r"(block|tail)(\d)\.(.*)", sub)
        if block:
            group = "blocks" if block.group(1) == "block" else "blocks_tail"
            return (f"{prefix}.{group}.block{block.group(2)}."
                    f"{_rename(block.group(3), _TREELEARN_BLOCK_NAMES)}")
        return f"{prefix}." + _rename(sub, {
            "MaskedBatchNorm_0": "conv.0", "down_kernel": "conv.2.weight",
            "MaskedBatchNorm_1": "deconv.0", "up_kernel": "deconv.2.weight"})
    rest = ".".join(parts[1:])
    if rest.startswith("embedding."):
        return "backbone.embedding.stem." + _rename(
            rest[len("embedding."):],
            {"kernel": "conv.weight", "MaskedBatchNorm_0": "norm"})
    name, sub = rest.split(".", 1)
    block = re.match(r"(enc|dec)(\d+)_block(\d+)$", name)
    if block:
        kind, s, i = block.groups()
        return (f"backbone.{kind}.{kind}{s}.block{i}."
                f"{_rename(sub, _PTV3_BLOCK_NAMES)}")
    if name.endswith("_down"):
        return f"backbone.enc.{name[:-5]}.down." + _rename(
            sub, {"proj": "proj", "norm": "norm.0"})
    return f"backbone.dec.{name[:-3]}.up." + _rename(sub, {
        "proj": "proj.0", "norm": "proj.1", "proj_skip": "proj_skip.0",
        "norm_skip": "proj_skip.1"})


def reference_state_dict(family: str, model) -> dict:
    """``model``'s weights (a port ``treelearn``, ``pointnet2`` or
    ``pointtransformerv3``) as the reference system's ``state_dict`` of
    numpy arrays: its names, spconv kernels as ``(Cout, k, k, k, Cin)``
    (KRSC, offsets row-major in (dx, dy, dz)), 1x1 convs and the TreeLearn
    shortcut as ``(Cout, Cin, 1...)``, linears as they are. The inverse of
    the port's importer (``train/import_torch.py``), which is what 15d and
    the CPU tests hold it to."""
    out = {}
    n_fp = sum(name.startswith("FeaturePropagation_")
               for name, _ in model.named_children())
    for key, value in model.state_dict().items():
        a = value.detach().cpu().numpy()
        ref = _reference_key(family, key, n_fp)
        leaf = key.rsplit(".", 1)[1]
        if a.ndim == 3:  # (K, Cin, Cout) kernel-offset layout
            k = round(a.shape[0] ** (1 / 3))
            a = a.transpose(2, 0, 1).reshape(a.shape[2], k, k, k, a.shape[1])
        elif leaf == "shortcut":  # (Cin, Cout) 1x1x1 conv
            a = a.T.reshape(a.shape[1], 1, 1, 1, a.shape[0])
        elif family == "pointnet2" and ".mlp_convs." in ref and a.ndim == 2:
            a = a.reshape(*a.shape, *([1, 1] if ref.startswith("sa")
                                      else [1]))
        out[ref] = a.copy()
    return out


#: phase 15: trees ``evaluate nn`` takes per family on the card and on the
#: CPU (the CPU's full-width PTv3 forward on 16,384 points takes seconds),
#: and the limits of card against CPU: mean_after within 1 % of the CPU's,
#: shrinkage within one percentage point (the same 1 % of mean_after over
#: mean_before)
EVAL_NN_TREES = {"treelearn": 3, "pointtransformerv3": 2}
EVAL_NN_RTOL = 1e-2
#: 15f: epochs of the PTv3 sanity check (one train and one eval forward
#: of the 10,000-point cylinder each)
SANITY_EPOCHS = 5
#: 15e: the launches and host synchronizations of one serving forward
#: (phases 2-4's TreeLearn on the e2e plot) outside the kernel-FLOP log, as
#: ``serving_syncs.py`` counted them on a checkout of the log's parent
#: commit (ebad624), the same in both of its runs, on one NVIDIA H100 80GB
#: HBM3 at 700 W; historical, not measured by this script
PARENT_SERVING_COUNTS = {
    "launches": {"band_conv": 21, "band_conv_k27": 21},
    "syncs": {"cudaStreamSynchronize": 59, "cudaDeviceSynchronize": 1},
}


def has_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def run_module(module: str, args: list, timeout=600):
    """``python -m treemorph_tpu_torch.scripts.{module} args`` from the
    repository root; raises unless it exits 0. Returns (stdout, seconds
    with the process start, stderr)."""
    cmd = [sys.executable, "-m", f"treemorph_tpu_torch.scripts.{module}",
           *args]
    log("  $ " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"{module} {args[0]} exited {proc.returncode}")
    return proc.stdout, time.perf_counter() - t0, proc.stderr


def run_modules(calls: list, timeout=600) -> list:
    """Each ``(module, args)`` of ``calls`` through :func:`run_module`, all
    started together; their (stdout, seconds, stderr) in order. Raises if any
    fails, after every one has ended."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(run_module, module, args, timeout)
                   for module, args in calls]
    return [f.result() for f in futures]


def parse_nn_output(stdout: str) -> tuple[dict, dict]:
    """(summary, {"trees", "launches"}) of ``evaluate nn``'s output."""
    head, _, tail = stdout.partition("hand kernel launches: ")
    summary = json.loads(head[head.index("{"):head.rindex("}") + 1])
    return summary, json.loads(tail.splitlines()[0])


def phase_evaluate_nn(root, checkpoints, device):
    """15a: ``python -m treemorph_tpu_torch.scripts.evaluate nn`` on the
    card for TreeLearn (13d's checkpoint, ``--engine band --conv_dtype
    bfloat16``, the bench configuration) and PTv3 (13c's checkpoint at the
    family's defaults, as 13d's pipeline CLI serves it), over the held-out
    plot 1 of the training plots; its band and attention launches per tree
    (non-zero); then the same command with ``--device cpu`` on the same
    trees: mean_after within EVAL_NN_RTOL of the CPU's, shrinkage within
    EVAL_NN_RTOL absolute."""
    from treemorph_tpu_torch.scripts import evaluate

    from concurrent.futures import ThreadPoolExecutor

    kernel = {"treelearn": "band_conv", "pointtransformerv3":
              "window_attention"}
    record, checks, family_args = {}, {}, {}
    for family, ckpt in checkpoints.items():
        args = ["nn", family, "--data_root", root, "--test_plot", "1",
                "--offset_model_dir", ckpt, "--max_trees",
                str(EVAL_NN_TREES[family])]
        if family == "treelearn":
            args += ["--engine", "band", "--conv_dtype", "bfloat16"]
        family_args[family] = args
    # the card's processes run while this one evaluates on the CPU
    with ThreadPoolExecutor(1) as pool:
        card_runs = pool.submit(run_modules, [
            ("evaluate", args + ["--device", str(device)])
            for args in family_args.values()])
        cpu_runs = {}
        for family, args in family_args.items():
            t0 = time.perf_counter()
            cpu_runs[family] = (evaluate.main(args + ["--device", "cpu"]),
                                time.perf_counter() - t0)
    for (family, args), (stdout, secs, _) in zip(family_args.items(),
                                                 card_runs.result()):
        card, launched = parse_nn_output(stdout)
        per_tree = {k: v / launched["trees"]
                    for k, v in launched["launches"].items()}
        cpu, cpu_s = cpu_runs[family]
        err_after = abs(card["mean_after"] - cpu["mean_after"])
        err_shrink = abs(card["shrinkage"] - cpu["shrinkage"])
        record[family] = {"card": card, "cpu": cpu,
                          "launches_per_tree": per_tree,
                          "card_seconds_with_process_start": secs,
                          "cpu_seconds": cpu_s}
        log(f"15a {family}: card {json.dumps(card)}; cpu "
            f"{json.dumps(cpu)}; launches per tree {per_tree} "
            f"({secs:.1f} s with the process start, CPU {cpu_s:.1f} s; "
            f"all four run together)")
        checks[f"{family}: {EVAL_NN_TREES[family]} trees"] = (
            launched["trees"] == EVAL_NN_TREES[family])
        checks[f"{family}: {kernel[family]} launched every tree"] = (
            per_tree.get(kernel[family], 0) >= 1)
        checks[f"{family}: mean_after within {EVAL_NN_RTOL} of the CPU's"] = (
            err_after <= EVAL_NN_RTOL * cpu["mean_after"])
        checks[f"{family}: shrinkage within {EVAL_NN_RTOL} of the CPU's"] = (
            err_shrink <= EVAL_NN_RTOL)
        checks[f"{family}: same points"] = card["n_points"] == cpu["n_points"]
    report_checks("15a", checks)
    return record


def report_checks(name: str, checks: dict) -> None:
    for what, ok in checks.items():
        log(f"  {'ok ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"{name} checks failed")
    log(f"phase {name} ok")


def save_port_checkpoint(predictor, directory, meta) -> str:
    """``predictor``'s weights as the training CLI saves them
    (``{directory}/P{plot}/model.pt`` and the metadata manifest)."""
    import torch

    from treemorph_tpu_torch.train.checkpoints import MODEL_FILE

    path = os.path.join(directory, "P4")
    os.makedirs(path)
    torch.save({k: v.cpu() for k, v in predictor.model.state_dict().items()},
               os.path.join(path, MODEL_FILE))
    with open(path + ".metadata.json", "w") as f:
        json.dump(meta, f)
    return directory


def phase_evaluate_qsm(points, csv_path, device):
    """15b: ``evaluate predict`` (phase 4's offset and noise TreeLearn,
    saved as checkpoints, served with ``--engine band --conv_dtype
    bfloat16``) on the e2e plot, then ``evaluate qsm-distance`` of the plot
    and its refined cloud against phase 4's fitted cylinders, on the card.
    The distances and cylinder ids of ``project_on_qsm``'s projection on
    the card against the CPU's on every 20th point (14b's limits: ids on
    LABEL_ID_AGREEMENT of the points, distances within HEIGHT_ATOL of the
    extent), and the CLI's statistics against the same projection run
    in-process on the card."""
    import numpy as np
    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import FAMILY_DEFAULTS
    from treemorph_tpu_torch.evaluation.qsm_eval import (
        compare_distance_distributions,
        project_on_qsm,
    )
    from treemorph_tpu_torch.ops.cuda import LAUNCHES
    from treemorph_tpu_torch.ops.projection import (
        closest_cylinder,
        cylinders_from_table,
    )
    from treemorph_tpu_torch.scripts import evaluate
    from treemorph_tpu_torch.utils.table import Table

    offset, noise = pipeline_models(device)
    meta = {"model": "treelearn", **FAMILY_DEFAULTS["treelearn"]}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [save_port_checkpoint(p, os.path.join(tmp, role), meta)
                for p, role in ((offset, "offset"), (noise, "noise"))]
        cloud = os.path.join(tmp, "plot.npy")
        np.save(cloud, points)
        manifest = os.path.join(tmp, "manifest.json")
        with open(manifest, "w") as f:
            json.dump([cloud], f)
        out = os.path.join(tmp, "pred")
        torch.cuda.synchronize()
        launched = dict(LAUNCHES)
        t0 = time.perf_counter()
        evaluate.main(["predict", "treelearn", "--manifest", manifest,
                       "--offset_model_dir", dirs[0], "--noise_model_dir",
                       dirs[1], "--outputDir", out, "--save_type", "npy",
                       "--engine", "band", "--conv_dtype", "bfloat16",
                       "--device", str(device)])
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        band = LAUNCHES["band_conv"] - launched.get("band_conv", 0)
        pred = os.path.join(out, "plot_pred.npy")
        t0 = time.perf_counter()
        stats = evaluate.main(["qsm-distance", "--cloud", cloud,
                               "--pred_cloud", pred, "--qsm_csv", csv_path,
                               "--device", str(device)])
        distance_s = time.perf_counter() - t0
        refined = np.load(pred)
        denoised = np.load(os.path.join(out, "plot_pred_denoised.npy"))
    qsm = Table.read_csv(csv_path)
    card = [project_on_qsm(c, qsm, device=device) for c in (points, refined)]
    again = compare_distance_distributions(*card)
    cut = refined[::20]
    ids, dists = [], []
    for dev in (device, "cpu"):
        cyl = cylinders_from_table(qsm, device=dev)
        i, d, _ = closest_cylinder(
            torch.from_numpy(np.ascontiguousarray(cut)).to(dev), cyl)
        ids.append(i.cpu().numpy())
        dists.append(d.cpu().numpy())
    extent = float(np.ptp(points, axis=0).max())
    id_share = float((ids[0] == ids[1]).mean())
    dist_err = float(np.abs(dists[0] - dists[1]).max())
    record = {"predict_seconds": predict_s, "qsm_distance_seconds":
              distance_s, "band_launches": band, "stats": stats,
              "refined_points": len(refined), "denoised_points":
              len(denoised), "cylinders": len(qsm), "cpu_cut": len(cut),
              "id_agreement": id_share, "distance_max_err": dist_err,
              "extent": extent}
    log("15b " + json.dumps(record))
    report_checks("15b", {
        "refined cloud of every point": len(refined) == len(points),
        "denoised cloud kept points": 0 < len(denoised) <= len(points),
        "63 band launches (offset; offset and noise)": band == 63,
        f"ids on >= {LABEL_ID_AGREEMENT} of the cut": (
            id_share >= LABEL_ID_AGREEMENT),
        f"distances within {HEIGHT_ATOL} x extent": (
            dist_err <= HEIGHT_ATOL * extent),
        "the CLI's statistics are the projection's": all(
            abs(stats[k] - again[k]) <= 1e-6 * max(1.0, abs(again[k]))
            for k in again),
    })
    return record


def phase_test_model(root, ckpt, device):
    """15c: ``test_model``'s device work on one held-out labeled tree
    (plot 1's first, 16,384 points) with 13d's TreeLearn checkpoint (band,
    bf16) as offset and noise predictor: ``model_diagnostics`` (one
    ``predict_single`` forward, then ``make_noise_prediction``'s two noise
    forwards) on the card and on the CPU, the offsets, ``nn_after_mean``
    and ``offset_mae`` within phase 3's STAGE1_OFFSET_RTOL, the noise
    masks on STAGE1_ARGMAX_AGREEMENT of the points. The figures only where
    matplotlib is installed."""
    import numpy as np

    from treemorph_tpu_torch.evaluation import diagnostics
    from treemorph_tpu_torch.evaluation.model_loaders import load_model
    from treemorph_tpu_torch.ops.cuda import LAUNCHES

    with open(os.path.join(root, "plot_1.json")) as f:
        labeled = np.load(json.load(f)[0])
    runs, launches = {}, 0
    for dev in (device, "cpu"):
        predictor = load_model("treelearn", ckpt, device=dev, engine="band",
                               conv_dtype="bfloat16")["O_P1"]
        before = LAUNCHES["band_conv"]
        t0 = time.perf_counter()
        runs[str(dev)] = diagnostics.model_diagnostics(
            predictor, labeled, predictor, device=dev)
        runs[str(dev)]["seconds"] = time.perf_counter() - t0
        if dev != "cpu":
            launches = LAUNCHES["band_conv"] - before
    card, cpu = runs[str(device)], runs["cpu"]
    off_err = float(np.abs(card["pred_offsets"] - cpu["pred_offsets"]).max())
    off_scale = float(np.abs(cpu["pred_offsets"]).max())
    masks = [float((a == b).mean()) for a, b in zip(card["noise_masks"],
                                                   cpu["noise_masks"])]
    metrics = {dev: {k: runs[dev][k] for k in diagnostics.METRICS}
               for dev in runs}
    log("15c " + json.dumps({"metrics": metrics, "offsets_max_err": off_err,
                             "offsets_scale": off_scale,
                             "noise_mask_agreement": masks,
                             "band_launches": launches,
                             "seconds": {d: runs[d]["seconds"]
                                         for d in runs}}))
    if has_matplotlib():
        with tempfile.TemporaryDirectory() as tmp:
            predictor = load_model("treelearn", ckpt, device=device,
                                   engine="band",
                                   conv_dtype="bfloat16")["O_P1"]
            out = diagnostics.test_model(predictor, labeled, tmp,
                                         noise_predictor=predictor,
                                         device=device)
            log(f"15c figures: {len(out['slice_plots'])} slice, "
                f"{len(out['noise_plots'])} noise figures written")
    else:
        log("15c figures: not run: matplotlib is not installed on this "
            "machine")
    report_checks("15c", {
        f"offsets within {STAGE1_OFFSET_RTOL} x scale":
            off_err <= STAGE1_OFFSET_RTOL * off_scale,
        **{f"{k} within {STAGE1_OFFSET_RTOL} of the CPU's":
           abs(card[k] - cpu[k]) <= STAGE1_OFFSET_RTOL * abs(cpu[k])
           for k in ("nn_after_mean", "offset_mae")},
        f"noise masks on >= {STAGE1_ARGMAX_AGREEMENT} of the points":
            min(masks) >= STAGE1_ARGMAX_AGREEMENT,
        "63 band launches (offset; noise twice)": launches == 63,
    })
    return metrics


def phase_import_round_trip(points, device):
    """15d: a TreeLearn (the pipeline's width) and a PointNet2 (depth 5)
    of the port with seeded weights, written as the reference system's
    ``state_dict`` (:func:`reference_state_dict`) to a ``.pt``, through
    ``python -m treemorph_tpu_torch.scripts.import_checkpoint`` on the
    card and ``load_model``: the same weights bit for bit, and the same
    outputs bit for bit on the same cloud (a 20,000-point cut of the plot;
    PointNet2 on one 4,096-point raster), both forwards under
    ``torch.use_deterministic_algorithms``."""
    import warnings

    import numpy as np
    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import (
        Predictor,
        build_model,
        load_model,
    )
    from treemorph_tpu_torch.pipeline.predict import _pad_flat

    rng = np.random.default_rng(5)
    cut = points[rng.choice(len(points), 20_000, replace=False)]
    feats = rng.normal(size=(len(cut), 4)).astype(np.float32)
    checks, record = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        models, calls = {}, []
        for family, flags in (("treelearn", []),
                              ("pointnet2", ["--depth", "5"])):
            model = models[family] = build_model(family, device=device,
                                                 seed=7)
            pt = os.path.join(tmp, f"{family}.pt")
            torch.save({"state_dict": {
                k: torch.from_numpy(v)
                for k, v in reference_state_dict(family, model).items()}},
                pt)
            out = os.path.join(tmp, family, f"{family}_O_P3")
            calls.append(("import_checkpoint", [
                family, pt, out, *flags, "--device", str(device)]))
        # both imports started together
        for (family, model), (_, cmd), (stdout, secs, _) in zip(
                models.items(), calls, run_modules(calls)):
            out = cmd[2]
            loaded = load_model(family, os.path.dirname(out),
                                device=device)["O_P3"]
            same_weights = all(
                torch.equal(v, loaded.model.state_dict()[k])
                for k, v in model.state_dict().items())
            if family == "treelearn":
                args = _pad_flat(cut, feats, device=device)[:4]
            else:
                n = 4096
                args = (torch.from_numpy(cut[None, :n]).to(device),
                        torch.from_numpy(feats[None, :n]).to(device),
                        torch.ones((1, n), dtype=torch.bool, device=device))
            torch.utils.deterministic.fill_uninitialized_memory = False
            torch.use_deterministic_algorithms(True, warn_only=True)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                outs = [Predictor(family, m, device)._forward(*args)
                        for m in (model, loaded.model)]
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = True
            same = all(torch.equal(outs[0][k], outs[1][k])
                       for k in ("offset_predictions",
                                 "semantic_prediction_logits"))
            record[family] = {"import_seconds_with_process_start": secs,
                              "same_weights": same_weights,
                              "same_outputs": same,
                              "printed": stdout.strip()}
            log(f"15d {family}: {stdout.strip()} ({secs:.1f} s); weights "
                f"identical {same_weights}, outputs identical {same}")
            checks[f"{family}: weights bit for bit"] = same_weights
            checks[f"{family}: outputs bit for bit"] = same
    report_checks("15d", checks)
    return record


def phase_mfu(points, rows, device):
    """15e: ``utils/flops.py``'s ``mfu_report`` of one TreeLearn serving
    forward (phase 2-4's: band, bf16, the e2e plot) and one PTv3 forward
    (the pipeline's PTv3 on the cloud's first 65,536 points):
    ``torch_flops``,
    ``kernel_flops``, ``device_ms`` and MFU against the card's bf16 peak.
    The serving forward's band ``kernel_flops`` must equal the operations
    phase 2 counts for the same forward's 21 launches (``rows``: 2 x
    in-window entries x Cin x Cout per conv, times its launches). Outside
    the log the forward's launches and host synchronizations
    (``serving_syncs.py``'s count) must be the parent's
    (PARENT_SERVING_COUNTS), and twice the same."""
    import numpy as np

    from serving_syncs import forward_counts
    from treemorph_tpu_torch.pipeline.predict import _pad_flat
    from treemorph_tpu_torch.utils import flops

    offset, _ = pipeline_models(device)
    args = _pad_flat(points, np.zeros((len(points), 4), np.float32),
                     device=device)[:4]
    offset.predict_flat(*args)
    outside = [forward_counts(offset, args) for _ in range(2)]
    serving = flops.mfu_report(offset.predict_flat, args)
    phase2 = sum(2.0 * r["nnz"] * r["cin"] * r["cout"]
                 * r["launches_per_forward"] for r in rows
                 if r["dtype"] == "torch.bfloat16")
    cloud = ptv3_cloud(points)[:PTV3_CUT]
    ptv3, _ = ptv3_models(device)
    ptv3_args = _pad_flat(cloud[:, :3], cloud[:, 7:11], device=device)[:4]
    ptv3_report = flops.mfu_report(ptv3.predict_flat, ptv3_args)
    smi = card_line()
    for name, rep in (("treelearn serving forward", serving),
                      ("ptv3 forward", ptv3_report)):
        print("MFU " + json.dumps({"forward": name, "card": smi, **rep}),
              flush=True)
    log(f"15e serving forward outside the log: {json.dumps(outside)}; "
        f"parent {json.dumps(PARENT_SERVING_COUNTS)}")
    report_checks("15e", {
        "band kernel_flops = phase 2's operations for 21 launches":
            serving["kernel_flops_by_tag"].get("band_conv") == phase2,
        "attention kernel_flops logged":
            ptv3_report["kernel_flops_by_tag"].get("window_attention", 0) > 0,
        "21 band launches a forward outside the log":
            outside[0]["launches"] == {"band_conv": 21, "band_conv_k27": 21},
        "outside the log twice the same": outside[0] == outside[1],
        "outside the log as on the parent":
            outside[0] == PARENT_SERVING_COUNTS,
        "MFU finite and below 1": all(0 < r["mfu"] < 1
                                      for r in (serving, ptv3_report)),
    })
    return {"treelearn": serving, "ptv3": ptv3_report, "phase2_flops": phase2,
            "outside": outside}


def phase_sanity_check(device):
    """15f: ``python -m treemorph_tpu_torch.scripts.sanity_check
    pointtransformerv3`` (its defaults: f32, gather stem, no drop path) on
    the card for SANITY_EPOCHS epochs, run in-process so that its
    launches are counted: the train loss falls, and each epoch launches
    the attention forward 22 times in its train step and 22 in its eval
    step, and the backward 22 times (and the figure's forward 22 more,
    where matplotlib is installed)."""
    from treemorph_tpu_torch.ops.cuda import LAUNCHES
    from treemorph_tpu_torch.scripts import sanity_check

    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    figure = has_matplotlib()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sanity.png") if figure else ""
        history = sanity_check.main([
            "pointtransformerv3", "--epochs", str(SANITY_EPOCHS), "--out",
            out, "--device", str(device)])
    secs = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] - before.get(k, 0)
                for k in ("window_attention", "window_attention_bwd")}
    losses = [r["train_loss"] for r in history]
    log(f"15f: {secs:.1f} s, train losses {losses}, launches {launches}")
    if not figure:
        log("15f figure: not run: matplotlib is not installed on this "
            "machine")
    report_checks("15f", {
        "train loss falls": losses[-1] < losses[0],
        f"{2 * PTV3_BLOCKS} attention forwards an epoch":
            launches["window_attention"]
            == PTV3_BLOCKS * (2 * SANITY_EPOCHS + figure),
        f"{PTV3_BLOCKS} attention backwards an epoch":
            launches["window_attention_bwd"] == PTV3_BLOCKS * SANITY_EPOCHS,
    })
    return {"seconds": secs, "losses": losses, "launches": launches}


#: phase 16: PTv3's reference-partitioning options and the non-default
#: conv engines. The PDNorm conditions (the reference's prompt names are
#: its datasets'; two here, condition 1 selected) and the context's width
#: (PDNormSpec's default). 16a's step trains on the reference's PTv3 batch
#: of OPTIONS_TRAIN_TREES trees; 16b's RPE steps on OPTIONS_RPE_TREES of
#: them (at 4 the biased plain attention's saved scores and indices peaked
#: at 82.9 GB with plain PDNorm and overflowed the card with the adaptive
#: one); each card against CPU check runs on the first OPTIONS_CPU_POINTS
#: points of the first OPTIONS_CPU_TREES trees (the CPU's full-width steps
#: bound the phase's time, as in 8b)
OPTIONS_CONDITIONS = ("TreeSet", "Other")
OPTIONS_CONTEXT = 256
OPTIONS_TRAIN_TREES, OPTIONS_RPE_TREES = PTV3_TRAIN_TREES, 2
OPTIONS_CPU_TREES, OPTIONS_CPU_POINTS = 2, 1024
#: the card against CPU steps' depth: one block a stage at full width (the
#: CPU's time goes into each block's 1024-row windows, whatever the points)
OPTIONS_CPU_DEPTHS = dict(enc_depths=(1, 1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
#: points of 16a's serving forward card against CPU, and of 16c's cut
ENGINE_CPU_CUT = 10_000
#: 16d: the bench tree's first points, card against CPU, and their token
#: cap P / 2 (at the bench's P / 4 the cut's tokens overflow it: 2,112
#: points in the first chip run of phase 16)
ZPACK_CPU_CUT, ZPACK_DEDUP_DIVISOR = 32_768, 2
#: card steps whose losses must fall (the same batch, lr 1e-3)
OPTIONS_STEPS, OPTIONS_LR = 3, 1e-3
#: TreeLearn engines of 16c (engine, brick schedule)
ENGINE_CASES = (("zpack", "conv"), ("pencil", "conv"), ("brick", "conv"),
                ("brick", "xslab"))
#: TreeLearn engines card against CPU, and against the gather engine on
#: the card, f32: sum order through three levels (and atomic voxel means)
TREELEARN_F32_RTOL = 1e-4
#: the 30-tree step's pencil cap, 3 M / 2 rows (the JAX package's "2 is
#: safe in practice"; 3 M at M ~ 370k level-0 rows does not fit the card's
#: 80 GB in a train step)
ENGINE_PENCIL_DIVISOR = 2
#: the brick steps' trees: at 30 the dense halo'd bricks (M / 4 of them,
#: 216 cells each) and what autograd keeps of them overflow the card (10:
#: 58 GB on F.conv3d, over 79 GB on the x-slab schedule)
ENGINE_BRICK_TREES = 5
#: 16f: tiles of 8^3 at the plot's level 0, capped at TILE_CAP
TILE, TILE_CAP = 8, 8192


def pad_layout_counts(seg) -> dict:
    """Windows, wholly dead windows and dead slots of a per-element
    attention layout ``seg`` (W, K)."""
    dead = seg < 0
    return {"windows": int(seg.shape[0]),
            "dead_windows": int(dead.all(1).sum()),
            "dead_slots": int(dead.sum()), "slots": int(seg.numel())}


def attention_bound_ms(q, seg, per_pair, out_rows) -> tuple[float, str]:
    """The f32-rate bound of one attention call (forward ``per_pair`` = 4,
    backward 5 multiply-add FLOPs per D, allowed pair and head): q, k, v
    of the rows that hold a segment read once, ``out_rows`` (W, H, K, D)
    f32 tensors written once."""
    w, h, kk, d = q.shape
    live = int((seg >= 0).sum())
    nbytes = (3 * live * h * d * q.element_size() + w * kk * 4
              + out_rows * w * h * kk * d * 4)
    return bound(nbytes, per_pair * d * h * allowed_pair_count(seg))


def phase_pad_per_element(cloud, root, device):
    """16a: PTv3 with ``pad_per_element`` at full width. The serving
    forward card against CPU (7b's cut and limits, num_elements 1); the
    attention inputs of one forward on that layout, each shape's kernel
    against its plain version (forward), and the backward kernel against
    its plain version on each of a full-width 4-tree train step's 22 calls
    (num_elements 4, its own cotangents), within KERNEL_RTOL of scale, with
    dead windows and slots; launches: 22 forward in a ``predict_single``,
    22 forward and 22 backward in a train step; one f32 step card against
    CPU on the CPU cut (:func:`cpu_cut`). Returns the sub-records of the
    forward and backward kernels' records for this layout."""
    import torch

    from treemorph_tpu_torch.ops import attention
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.pipeline.predict import predict_single

    t0 = time.perf_counter()
    pad1 = dict(pad_per_element=True, num_elements=1)
    phase_ptv3_card_vs_cpu(cloud, device, "phase 16a serving",
                           PTV3_CPU_CUT, **pad1)
    cut = cloud[:PTV3_CUT]
    offset_model, _ = ptv3_models(device, **pad1)
    torch.cuda.synchronize()
    reset_launches()
    predict_single(cut, offset_model, None, device=device)
    torch.cuda.synchronize()
    serve_launches = LAUNCHES["window_attention"]
    captured, _ = capture_attention_inputs(offset_model, cut)
    fwd = {"launches": serve_launches, "ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "worst_err_over_scale": 0.0, "shapes": []}
    for shape, ((q, k, v, seg), count) in sorted(captured.items()):
        out = attention.window_attention(q, k, v, seg)
        ref = attention.window_attention_reference(q, k, v, seg)
        rel = share_of_scale(f"16a window_attention {shape}", out, ref,
                             KERNEL_RTOL)
        if not bool((out[(seg < 0)[:, None, :, None].expand_as(out)] == 0)
                    .all()):
            raise AssertionError(f"16a {shape}: dead slots not 0")
        ms = cuda_ms(lambda: attention.window_attention(q, k, v, seg), 10)
        plain = cuda_ms(lambda: attention.window_attention_reference(
            q, k, v, seg), 2)
        bnd, by = attention_bound_ms(q, seg, 4, 1)
        row = dict(shape=list(shape), calls=count, **pad_layout_counts(seg),
                   err_over_scale=rel, ms=ms, plain_ms=plain, bound_ms=bnd,
                   bound_by=by)
        log("16a forward " + json.dumps(row))
        fwd["shapes"].append(row)
        fwd["worst_err_over_scale"] = max(fwd["worst_err_over_scale"], rel)
        for key, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", bnd)):
            fwd[key] += count * val

    # the packed layout's kernel on the same cut, for comparison
    packed, _ = capture_attention_inputs(ptv3_models(device)[0], cut)
    fwd["packed_ms"] = sum(
        count * cuda_ms(lambda a=args: attention.window_attention(*a), 10)
        for args, count in packed.values())
    del packed
    batch = ptv3_training_batch(root, device, OPTIONS_TRAIN_TREES)
    pad4 = dict(pad_per_element=True, num_elements=OPTIONS_TRAIN_TREES)
    torch.cuda.synchronize()
    reset_launches()
    calls = capture_ptv3_step(batch, device, **pad4)
    torch.cuda.synchronize()
    step_launches = dict(LAUNCHES)
    bwd = {"launches": step_launches.get("window_attention_bwd", 0),
           "forward_launches": step_launches.get("window_attention", 0),
           "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "worst_err_over_scale": 0.0}
    dead = {"dead_windows": 0, "windows": 0, "dead_slots": 0, "slots": 0}
    for q, k, v, seg, g in calls:
        out, lse = attention.window_attention_fwd(q, k, v, seg)
        grads = attention.window_attention_bwd(q, k, v, seg, g, out, lse)
        refs = attention.window_attention_bwd_reference(q, k, v, seg, g)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            bwd["worst_err_over_scale"] = max(
                bwd["worst_err_over_scale"], share_of_scale(
                    f"16a window_attention_bwd {tuple(q.shape)} {name}",
                    got, ref, KERNEL_RTOL))
        bwd["ms"] += cuda_ms(lambda: attention.window_attention_bwd(
            q, k, v, seg, g, out, lse), 5)
        bwd["plain_ms"] += cuda_ms(
            lambda: attention.window_attention_bwd_reference(
                q, k, v, seg, g), 1)
        bwd["bound_ms"] += attention_bound_ms(q, seg, 5, 3)[0]
        for key, val in pad_layout_counts(seg).items():
            dead[key] += val
    bwd.update(dead)
    del calls
    log("16a backward on the 4-tree step's layout: " + json.dumps(bwd))
    if not (serve_launches == PTV3_BLOCKS
            and bwd["launches"] == bwd["forward_launches"] == PTV3_BLOCKS):
        raise AssertionError(f"16a launches: serving {serve_launches}, "
                             f"step {step_launches}, expected {PTV3_BLOCKS}")
    cut2 = cpu_cut(root)
    pad2 = dict(pad_per_element=True, num_elements=OPTIONS_CPU_TREES,
                **OPTIONS_CPU_DEPTHS)
    t1 = time.perf_counter()
    card = ptv3_one_step(cut2, device, **pad2)
    t2 = time.perf_counter()
    cpu = ptv3_one_step(cut2, "cpu", **pad2)
    log(f"  16a step on {OPTIONS_CPU_TREES} trees x {OPTIONS_CPU_POINTS} "
        f"points, one block a stage (the CPU's time bounds the cut): card "
        f"{t2 - t1:.2f} s, CPU {time.perf_counter() - t2:.2f} s")
    compare_steps("16a PTv3 pad_per_element train step, card vs CPU, f32",
                  card, cpu, PTV3_STEP_LOSS_RTOL, PTV3_STEP_GRAD_RTOL)
    log(f"phase 16a ok ({card_line()}): the hand attention kernels on the "
        f"per-element layout, forward {fwd['ms']:.3f} ms per serving "
        f"forward of {PTV3_CUT} points ({fwd['launches']} launches; plain "
        f"{fwd['plain_ms']:.3f}, bound {fwd['bound_ms']:.3f}, the packed "
        f"layout {fwd['packed_ms']:.3f}), backward {bwd['ms']:.3f} ms per "
        f"4-tree step ({bwd['launches']} launches; plain "
        f"{bwd['plain_ms']:.3f}, bound {bwd['bound_ms']:.3f}); "
        f"{time.perf_counter() - t0:.1f} s")
    return fwd, bwd


def cpu_cut(root):
    """The card-against-CPU batch of phase 16: the first OPTIONS_CPU_POINTS
    points of the first OPTIONS_CPU_TREES trees of the training batch, on
    the CPU."""
    batch = ptv3_training_batch(root, "cpu", OPTIONS_CPU_TREES)
    return batch.map(lambda a: a[:, :OPTIONS_CPU_POINTS].contiguous())


def options_model(device, adaptive, trees, **overrides):
    """The training PTv3 at full width with ``pad_per_element`` over
    ``trees`` elements, RPE, and PDNorm on BatchNorms and LayerNorms
    (OPTIONS_CONDITIONS; ``adaptive`` with an OPTIONS_CONTEXT context),
    ``drop_path`` 0, seeded weights; ``overrides``: other options."""
    from treemorph_tpu_torch.models.ptv3 import PDNormSpec

    spec = PDNormSpec(bn=True, ln=True, conditions=OPTIONS_CONDITIONS,
                      adaptive=adaptive, context_channels=OPTIONS_CONTEXT)
    return ptv3_training_model(device, drop_path=0.0, pad_per_element=True,
                               num_elements=trees, enable_rpe=True,
                               pdnorm=spec, **overrides)


def options_steps(model, batch, device, context, steps, lr=OPTIONS_LR):
    """``steps`` train steps of ``model`` on ``batch`` under condition 1
    (and ``context``), each with the order permutations of generator seed
    1 (the same on every device), the x50 loss, the harness's clip and
    AdamW; returns the losses and the first step's gradients."""
    import torch

    from treemorph_tpu_torch.models.ptv3 import draw_order_perms, ptv3_loss
    from treemorph_tpu_torch.train import families, harness

    flat = families._flatten_padded(batch.map(lambda a: a.to(device)))
    args = (flat["coords"], flat["feats"], flat["batch_ids"],
            flat["mask_valid"])
    optimizer = harness.make_optimizer(model)
    ctx = None if context is None else context.to(device)
    losses, grads = [], None
    for _ in range(steps):
        perms = draw_order_perms(torch.Generator().manual_seed(1),
                                 len(model.backbone.enc_depths))
        optimizer.zero_grad(set_to_none=True)
        out = model.train()(*args, order_perms=perms, condition=1,
                            context=ctx)
        loss, _ = ptv3_loss(out, flat)
        (loss * harness.LOSS_BACKWARD_SCALE).backward()
        if grads is None:
            grads = {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p)).detach().cpu().clone()
                     for n, p in model.named_parameters()}
        harness.optimizer_step(optimizer, lr)
        losses.append(float(loss.detach()))
    return losses, grads


def phase_rpe_pdnorm(root, device):
    """16b: PTv3 with RPE, ``pad_per_element`` and PDNorm (BatchNorms and
    LayerNorms, conditions OPTIONS_CONDITIONS, condition 1), without and
    with ``adaptive`` (a seeded context): OPTIONS_STEPS steps on the card
    at OPTIONS_RPE_TREES trees x 16,384 points, the loss falling, peak
    device memory; the eval forward's offsets card against CPU on the CPU
    cut, and (adaptive, which holds every option) one step card against
    CPU there (loss and every gradient). RPE's biased attention takes the
    plain version on every device, as in the JAX package (the kernels take
    no bias): no attention kernel launches."""
    import numpy as np
    import torch

    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.train import families

    t0 = time.perf_counter()
    batch = ptv3_training_batch(root, device, OPTIONS_RPE_TREES)
    cut = cpu_cut(root)
    context = torch.randn(OPTIONS_CONTEXT,
                          generator=torch.Generator().manual_seed(20))
    record = {}
    for adaptive in (False, True):
        label = f"16b RPE + pad_per_element + PDNorm (adaptive {adaptive})"
        ctx = context if adaptive else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        t1 = time.perf_counter()
        model = options_model(device, adaptive, OPTIONS_RPE_TREES)
        losses, _ = options_steps(model, batch, device, ctx, OPTIONS_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        launches = dict(LAUNCHES)
        del model
        torch.cuda.empty_cache()
        cpu_s = None
        if adaptive:
            card = options_steps(options_model(
                device, adaptive, OPTIONS_CPU_TREES, **OPTIONS_CPU_DEPTHS),
                cut, device, ctx, 1)
            t2 = time.perf_counter()
            cpu = options_steps(options_model(
                "cpu", adaptive, OPTIONS_CPU_TREES, **OPTIONS_CPU_DEPTHS),
                cut, "cpu", ctx, 1)
            cpu_s = time.perf_counter() - t2
            compare_steps(f"{label}, step on {OPTIONS_CPU_TREES} trees x "
                          f"{OPTIONS_CPU_POINTS} points, one block a stage, "
                          f"card vs CPU, f32",
                          (card[0][0], card[1]), (cpu[0][0], cpu[1]),
                          PTV3_STEP_LOSS_RTOL, PTV3_STEP_GRAD_RTOL)
        outs = []
        for dev in (device, "cpu"):
            model = options_model(dev, adaptive, OPTIONS_CPU_TREES,
                                  **OPTIONS_CPU_DEPTHS).eval()
            flat = families._flatten_padded(cut.map(lambda a: a.to(dev)))
            with torch.inference_mode():
                out = model(flat["coords"], flat["feats"],
                            flat["batch_ids"], flat["mask_valid"],
                            condition=1,
                            context=None if ctx is None else ctx.to(dev))
            valid = flat["mask_valid"].cpu().numpy()
            outs.append(out["offset_predictions"].float().cpu().numpy()
                        [valid])
        err = float(np.abs(outs[0] - outs[1]).max())
        scale = float(np.abs(outs[1]).max())
        row = {"adaptive": adaptive, "trees": OPTIONS_RPE_TREES,
               "trees_cut_from": OPTIONS_TRAIN_TREES, "losses": losses,
               "seconds": secs, "peak_gb": peak,
               "cpu_trees": OPTIONS_CPU_TREES,
               "cpu_points_per_tree": OPTIONS_CPU_POINTS,
               "cpu_step_seconds": cpu_s,
               "eval_offset_err_over_scale": err / scale,
               "launches": launches}
        log(f"{label} ({card_line()}; {OPTIONS_RPE_TREES} of the batch's "
            f"{OPTIONS_TRAIN_TREES} trees: the card holds no more with "
            f"RPE): " + json.dumps(row))
        checks = {
            "losses finite and falling": all(np.isfinite(losses))
            and losses[-1] < losses[0],
            f"eval offsets card vs CPU within {PTV3_OFFSET_RTOL} x scale":
                err <= PTV3_OFFSET_RTOL * scale and np.isfinite(outs[0]).all(),
            "no attention kernel launch (RPE takes the plain version on "
            "every device, the JAX package's own routing: no kernel takes "
            "a bias)":
                launches.get("window_attention", 0) == 0,
        }
        for name, ok in checks.items():
            log(f"  {'ok ' if ok else 'FAIL'} {name}")
        if not all(checks.values()):
            raise AssertionError(f"{label} failed")
        record[f"adaptive_{adaptive}"] = row
    log(f"phase 16b ok: {time.perf_counter() - t0:.1f} s")
    return record


def engine_model(base, engine, impl="conv"):
    """A TreeLearn like ``base`` on ``engine`` (``impl``: the brick
    schedule) with its weights: the gather names, renamed to the brick
    blocks' (``bn0``, ``conv0``, ...) for the brick engine."""
    from treemorph_tpu_torch.models.treelearn import TreeLearn

    model = TreeLearn(**dict(base.config, engine=engine, brick_impl=impl))
    state = base.state_dict()
    if engine == "brick":
        state = {brick_name(k): v for k, v in state.items()}
    model.load_state_dict(state)
    ref = next(base.parameters())
    return model.to(ref.device).train(base.training)


def brick_name(key: str) -> str:
    """The brick engine's name of a gather TreeLearn's parameter."""
    import re

    m = re.match(r"(.*\.(?:block|tail)\d+)\.(.*)", key)
    if not m or ".input_conv" in key:
        return key
    sub = {"MaskedBatchNorm_0": "bn0", "MaskedBatchNorm_1": "bn1",
           "SubMConv_0.kernel": "conv0", "SubMConv_1.kernel": "conv1"}
    rest = m.group(2)
    for old, new in sub.items():
        if rest == old or rest.startswith(old + "."):
            return f"{m.group(1)}.{new}{rest[len(old):]}"
    return key


def treelearn_forward(model, points, device):
    """The offset forward ``predict_single`` runs of ``model`` on
    ``points`` (no features): outputs, the dropped voxels and the seconds
    of a second call (host clock, synchronized)."""
    import numpy as np
    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import Predictor
    from treemorph_tpu_torch.pipeline.predict import _pad_flat

    pred = Predictor("treelearn", model, device)
    args = _pad_flat(points, np.zeros((len(points), 4), np.float32),
                     device=device)
    n = args[-1]
    pred.predict_flat(*args[:4])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pred.predict_flat(*args[:4])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    out = {k: res[k][:n].float().cpu().numpy()
           for k in ("offset_predictions", "semantic_prediction_logits")}
    out.update(seconds=time.perf_counter() - t0,
               dropped_voxels=int(res["dropped_voxels"]))
    return out


def engine_agreement(label, a, b, rtol) -> dict:
    """Offsets of ``a`` against ``b`` within ``rtol`` of b's scale, and the
    noise head's argmax at b's median margin on >= 99.9 % (raises)."""
    row = compare_forwards(label, a, b)
    if not (row["finite"] and row["offset_err_over_scale"] <= rtol
            and row["median_margin_agreement"] >= STAGE1_ARGMAX_AGREEMENT):
        raise AssertionError(f"{label} disagree")
    return row


def engine_step(batch, capacity, engine, impl, device):
    """Loss and gradients (gather names) of one f32 ``make_train_step`` of
    the training TreeLearn (the CLI's level-0 ``capacity``) on ``engine``,
    from the gather model's seeded weights; the pencil engine at
    ``pencil_divisor`` ENGINE_PENCIL_DIVISOR."""
    import torch

    from treemorph_tpu_torch.train import families, harness

    base = training_model(capacity, batch.batch_size, "gather", "float32")
    model = engine_model(base, engine, impl)
    if engine == "pencil":
        model = model.clone(pencil_divisor=ENGINE_PENCIL_DIVISOR)
    model = model.to(device)
    state = harness.TrainState(model, harness.make_optimizer(model))
    step = harness.make_train_step(*families.treelearn_family())
    _, metrics = step(state, batch.map(lambda a: a.to(device)), 1e-2)
    params = dict(model.named_parameters())
    grads = {}
    for name in base.state_dict():
        p = params.get(brick_name(name) if engine == "brick" else name)
        if p is not None:
            grads[name] = (p.grad if p.grad is not None
                           else torch.zeros_like(p)).cpu()
    return float(metrics["loss"]), grads


def phase_treelearn_engines(points, batch, capacity, device):
    """16c: the pipeline's TreeLearn width (seeded weights, f32,
    ``voxel_capacity_divisor`` 2) on each engine of ENGINE_CASES: the
    plot's offset forward on the card against the gather engine's, and a
    ENGINE_CPU_CUT-point cut card against CPU (TREELEARN_F32_RTOL of scale, the
    argmax at the median margin), with seconds beside the gather and band
    engines' and the dropped voxels; then one f32 train step at 30 x
    16,384 per engine against the gather step on the card (ENGINE_*), at
    the CLI's level-0 ``capacity``."""
    import numpy as np
    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import build_model

    t0 = time.perf_counter()
    base = build_model("treelearn", voxel_capacity_divisor=2,
                       engine="gather", conv_dtype="float32", device="cpu",
                       seed=0)
    rng = np.random.default_rng(3)
    cut = points[rng.choice(len(points), min(ENGINE_CPU_CUT, len(points)),
                            replace=False)]
    gather = treelearn_forward(base.to(device), points, device)
    band = treelearn_forward(engine_model(base, "band"), points, device)
    rows = {"gather": gather["seconds"], "band": band["seconds"]}
    for engine, impl in ENGINE_CASES:
        name = engine if engine != "brick" else f"brick-{impl}"
        model = engine_model(base, engine, impl)
        card = treelearn_forward(model, points, device)
        engine_agreement(f"16c {name} vs gather on the card, plot", card,
                         gather, TREELEARN_F32_RTOL)
        card_cut = treelearn_forward(model, cut, device)
        cpu_cut = treelearn_forward(model.to("cpu"), cut, "cpu")
        engine_agreement(f"16c {name} card vs CPU, {len(cut)}-point cut",
                         card_cut, cpu_cut, TREELEARN_F32_RTOL)
        rows[name] = card["seconds"]
        log(f"  16c {name}: forward {card['seconds']:.4f} s on the card "
            f"(gather {gather['seconds']:.4f}, band f32 "
            f"{band['seconds']:.4f}), dropped voxels "
            f"{card['dropped_voxels']} (plot), {card_cut['dropped_voxels']} "
            f"card / {cpu_cut['dropped_voxels']} CPU (cut, level caps)")
        # the random cut barely coarsens, so its level caps drop voxels on
        # every engine alike; the plot's drop none
        if card["dropped_voxels"] or (card_cut["dropped_voxels"]
                                      != cpu_cut["dropped_voxels"]):
            raise AssertionError(f"16c {name} dropped voxels")
    bricks = batch.map(lambda a: a[:ENGINE_BRICK_TREES])
    gather_steps = {
        False: engine_step(batch, capacity, "gather", "conv", device),
        True: engine_step(bricks, None, "gather", "conv", device)}
    for engine, impl in ENGINE_CASES:
        cut = engine == "brick"
        torch.cuda.reset_peak_memory_stats(device)
        t1 = time.perf_counter()
        step = engine_step(bricks if cut else batch, None if cut else
                           capacity, engine, impl, device)
        torch.cuda.synchronize()
        trees = ENGINE_BRICK_TREES if cut else batch.batch_size
        log(f"  16c {engine}-{impl} step on {trees} trees x 16,384 points"
            f"{' (cut: the card holds no more on this engine)' if cut else ''}"
            f": {time.perf_counter() - t1:.2f} s with its set-up, peak "
            f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
        compare_steps(f"16c train step, {engine}-{impl} vs gather on the "
                      f"card, f32, {trees} trees", step, gather_steps[cut],
                      ENGINE_LOSS_RTOL, ENGINE_RTOL)
    log(f"phase 16c ok ({card_line()}): forward seconds on the plot "
        f"{json.dumps(rows)} (brick-conv: F.conv3d with cuDNN's TF32 off "
        f"for the call, forward and backward); "
        f"{time.perf_counter() - t0:.1f} s")
    return rows


def phase_ptv3_zpack(cloud, device):
    """16d: the bench PTv3 configuration with ``stem_engine="zpack"`` on
    the bench tree's first ZPACK_CPU_CUT points (bf16, tokens,
    ``dedup_divisor`` 4; the CPU's forward bounds the cut): card against CPU
    within PTV3_BENCH_OFFSET_RTOL of scale, no band launch and 22
    attention launches a forward, no overflow; against the band stem on
    the card, logged (the engines round the weights differently: z-pack
    to bf16 as the gather engine, the band kernel in three bf16 pieces)."""
    from treemorph_tpu_torch.ops.cuda import LAUNCHES

    t0 = time.perf_counter()
    cloud = cloud[:ZPACK_CPU_CUT]
    card = bench_forward(cloud, device, stem_engine="zpack",
                         dedup_divisor=ZPACK_DEDUP_DIVISOR)
    attn = LAUNCHES["window_attention"]
    cpu = bench_forward(cloud, "cpu", stem_engine="zpack",
                        dedup_divisor=ZPACK_DEDUP_DIVISOR)
    band = bench_forward(cloud, device, dedup_divisor=ZPACK_DEDUP_DIVISOR)
    row = compare_forwards("16d zpack stem, card vs CPU, bf16", card, cpu)
    compare_forwards("16d zpack stem against the band stem, card", card,
                     band)
    checks = {
        f"offsets within {PTV3_BENCH_OFFSET_RTOL} x scale":
            row["finite"]
            and row["offset_err_over_scale"] <= PTV3_BENCH_OFFSET_RTOL,
        "no band launch, 22 attention launches":
            card["k125"] == card["k27"] == 0 and attn == PTV3_BLOCKS,
        "no dedup or pool overflow": all(
            o[k] == 0 for o in (card, cpu)
            for k in ("dedup_overflow", "pool_overflow")),
    }
    for name, ok in checks.items():
        log(f"  {'ok ' if ok else 'FAIL'} {name}")
    if not all(checks.values()):
        raise AssertionError("16d: the z-pack stem failed")
    log(f"phase 16d ok ({card_line()}): zpack forward {card['seconds']:.3f}"
        f" s, band {band['seconds']:.3f} s on the card; "
        f"{time.perf_counter() - t0:.1f} s")


def phase_engine_clis(root, device):
    """16e: the training CLI, one epoch each, on a cut of the training
    plots (plot 1's first 4 trees held out, 8 of plot 2 to train on):
    TreeLearn with ``--engine`` zpack, pencil and brick (f32, 8 trees a
    step), and PTv3 with ``--engine zpack --dedup_divisor 4`` (4 trees a
    step; both attention kernels' launches counted): finite losses, the
    checkpoints written."""
    import math

    import torch

    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.train import cli

    t0 = time.perf_counter()
    sub = os.path.join(root, "engines")
    os.makedirs(sub, exist_ok=True)
    for plot, trees in ((1, 4), (2, 8)):
        with open(os.path.join(root, f"plot_{plot}.json")) as f:
            paths = json.load(f)[:trees]
        with open(os.path.join(sub, f"plot_{plot}.json"), "w") as f:
            json.dump(paths, f)
    runs = [("treelearn", e, ["--batch_size", "8", "--conv_dtype",
                              "float32"]) for e in ("zpack", "pencil",
                                                    "brick")]
    runs.append(("pointtransformerv3", "zpack",
                 ["--batch_size", "4", "--dedup_divisor", "4"]))
    record = {}
    for model, engine, extra in runs:
        save = os.path.join(sub, f"saves_{model}_{engine}")
        argv = [model, "--data_root", sub, "--test_plots", "1", "--epochs",
                "1", "--bucket", str(TRAIN_POINTS), "--engine", engine,
                "--save_dir", save, "--device", str(device), *extra]
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        (rec,) = cli.main(argv)[1]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches = dict(LAUNCHES)
        ok = (math.isfinite(rec["train_loss"]) and math.isfinite(
            rec["val_loss"]) and os.path.exists(os.path.join(
                save, f"{model}_CV", "P1", "model.pt")))
        if model == "pointtransformerv3":
            steps = 2  # 8 training trees, 4 a step
            ok = ok and launches.get("window_attention_bwd", 0) == (
                PTV3_BLOCKS * steps)
        log(f"  16e python -m treemorph_tpu_torch.train.cli "
            f"{' '.join(argv)}: {secs:.2f} s, losses {rec['train_loss']:.5f}"
            f" / {rec['val_loss']:.5f}, launches {launches}")
        if not ok:
            raise AssertionError(f"16e {model} --engine {engine} failed")
        record[f"{model}_{engine}_seconds"] = secs
    log(f"phase 16e ok: {time.perf_counter() - t0:.1f} s")
    return record


def phase_tiles_and_runs(levels, device):
    """16f: the plot's level-0 voxels in 8^3 tiles (cap TILE_CAP, none
    dropped): ``tile_subm_conv`` (``F.conv3d`` in f32, and 27 slices)
    against the gather conv within AUTOGRAD_RTOL of scale; the octant-run
    rulebook equal to ``build_rulebook`` at k = 3 and 5."""
    import torch

    from treemorph_tpu_torch.ops import tiles
    from treemorph_tpu_torch.ops.sparse import (
        _subm_conv_impl,
        build_rulebook,
        build_rulebook_runs,
    )

    c, v = levels[0]
    gen = torch.Generator(device=device).manual_seed(21)
    feats = torch.randn((c.shape[0], 16), device=device, generator=gen)
    feats = feats * v[:, None]
    w = torch.randn((27, 16, 16), device=device, generator=gen) / 20.0
    ts = tiles.build_tiles(c, v, TILE_CAP, tile=TILE)
    ref = _subm_conv_impl(torch.float32, feats, w, build_rulebook(c, v), v)
    errs = {}
    for impl in ("conv", "slice"):
        out = tiles.tile_subm_conv(tiles.to_dense(feats, ts, TILE), w, ts,
                                   impl=impl)
        errs[impl] = share_of_scale(
            f"16f tile_subm_conv {impl}", tiles.from_dense(out, ts, v)[v],
            ref[v], AUTOGRAD_RTOL)
    same = {k: bool(torch.equal(build_rulebook_runs(c, v, k),
                                build_rulebook(c, v, k))) for k in (3, 5)}
    log(f"16f: {int(ts.num_tiles)} tiles of {TILE}^3 over {int(v.sum())} "
        f"voxels (overflow {int(ts.overflow)}), tile conv against gather "
        f"{errs}; run-table rulebook equal {same}")
    if int(ts.overflow) or not all(same.values()):
        raise AssertionError("16f: tiles overflowed or the run-table "
                             "rulebook differs")
    log("phase 16f ok")


#: phase 17: data parallelism and the QSM options. The data-parallel steps'
#: gates against their plain emulation in one process, by family and
#: compute dtype: (gradients and updated parameters within this share of
#: the largest, BN running statistics of their own scale; the loss). The
#: per-shard work is the same in both, only the gradients' sum order
#: differs: TreeLearn f32 1e-5; bf16 1e-2 and its loss 1e-4 (a forward's
#: bf16 roundings flip where the f32 atomic sums before them land in
#: another order); PTv3 and PointNet2 at their card-vs-CPU step gates
#: (phases 8b and 13a: atomic pooled sums, max-pool winners)
DP_GATES = {
    "treelearn": {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-4)},
    "pointtransformerv3": {"float32": (PTV3_STEP_GRAD_RTOL,
                                       PTV3_STEP_LOSS_RTOL)},
    "pointnet2": {"float32": (PN2_STEP_GRAD_RTOL, PN2_STEP_LOSS_RTOL)},
}
DP_LR = 1e-2
#: 17a's worlds on the one card, gloo ranks on cuda:0 (NCCL refuses two
#: ranks on one device): two ranks at both dtypes; four at f32, which pad
#: the 30-tree batch to 32 (30 divides by 2 and by 3, so three ranks would
#: not pad)
DP_WORLDS = ((2, ("bfloat16", "float32")), (4, ("float32",)))
#: 17a's world of one: NCCL, the backend of ranks on cards of their own
DP_ONE_RANK_BACKEND = "nccl"
#: 17b: sharded PointNet2 inference against the single-device path on the
#: PointNet2 plot (f32 sums on the devices against float64 on the host)
SHARDED_OFFSET_RTOL = 1e-5
SHARDED_ARGMAX_AGREEMENT = 0.999
#: 17c: the QSM options without scikit-learn, on 13d's PointNet2 stage-2
#: cloud (written by 13d): euclidean shells with agglomerative clustering
#: and weighted merging, and euclidean DBSCAN shells with enclosed merging
QSM_OPTION_CASES = {
    "agglomerative_weighted": dict(clustering_type="euclidian",
                                   clustering_algorithm="agglomerative",
                                   merging_procedure="weighted"),
    "dbscan_enclosed": dict(clustering_type="euclidian",
                            clustering_algorithm="dbscan",
                            merging_procedure="enclosed"),
}


def dp_batch(root, family):
    """The family's training batch, numpy: TreeLearn's first 30-tree batch
    of the fold that holds out plot 1, PTv3's first 4 trees, PointNet2's 60
    rasters x 4,096 points (13a's)."""
    from treemorph_tpu_torch.data import (
        batch_iterator,
        get_plot_split,
        make_padded_batch,
    )

    if family == "pointnet2":
        return make_padded_batch(pn2_training_samples(PN2_TRAIN_RASTERS),
                                 PN2_TRAIN_POINTS)
    trees = TRAIN_TREES if family == "treelearn" else PTV3_TRAIN_TREES
    trainset, _ = get_plot_split(root, 1)
    return next(batch_iterator(trainset, trees, TRAIN_POINTS,
                               shuffle=False))


def dp_capacity(root, world) -> int:
    """The training CLI's level-0 voxel capacity for one rank's share of a
    30-tree batch over ``world`` ranks."""
    from treemorph_tpu_torch.data import get_plot_split
    from treemorph_tpu_torch.train.cli import level0_capacity

    return level0_capacity(get_plot_split(root, 1), -(-TRAIN_TREES // world),
                           0.02)


def dp_model(family, batch_size, capacity, dtype, device, group=None):
    """The family's training model (seeded weights, on ``device``) and its
    (forward_fn, loss_fn), the loss reducing over ``group``: the CLI's
    TreeLearn on the band engine at ``dtype``, the CLI's PTv3 (f32,
    ``drop_path`` 0.3), PointNet2 at depth 5."""
    from treemorph_tpu_torch.train import families

    if family == "treelearn":
        return (training_model(capacity, batch_size, "band", dtype).to(device),
                families.treelearn_family(group=group))
    if family == "pointtransformerv3":
        return ptv3_training_model(device), families.ptv3_family(group=group)
    return pn2_train_state(device).model, families.pointnet2_family(
        group=group)


def recorded_step(step, state, batch, generator):
    """``step(state, batch, DP_LR, generator)`` with the gradients the
    optimizer receives (summed over the ranks, before the clip) copied to
    the host; returns (metrics, gradients)."""
    from treemorph_tpu_torch.train import harness

    grads = {}
    clip_and_step = harness.optimizer_step

    def recording(optimizer, lr):
        grads.update({n: p.grad.detach().cpu().clone()
                      for n, p in state.model.named_parameters()})
        clip_and_step(optimizer, lr)

    harness.optimizer_step = recording
    try:
        _, metrics = step(state, batch, DP_LR, generator)
    finally:
        harness.optimizer_step = clip_and_step
    return {k: float(v) for k, v in metrics.items()}, grads


def timed_steps(step, state, batch, device, reps) -> list:
    """Host seconds of ``reps`` more synchronized steps."""
    import torch

    seconds = []
    for i in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step(state, batch, DP_LR, torch.Generator().manual_seed(2 + i))
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
    return seconds


def dp_rank_main(mesh, family, root, capacity, dtypes, out_dir, reps=0):
    """One rank of 17a (and of ``chip_multichip.py``): per compute dtype,
    the family's model (seeded weights, broadcast from rank 0) takes one
    data-parallel ``make_train_step`` (step generator seed 1) on this
    rank's rows of :func:`dp_batch`, padded to the world size; then
    ``reps`` more steps, timed. Saves the loss, the gradients the
    optimizer received, the state after the first step, the hand kernels'
    launches in it and the seconds to ``out_dir/rank{r}.pt``."""
    import torch

    from treemorph_tpu_torch.ops.cuda import LAUNCHES
    from treemorph_tpu_torch.parallel import (
        pad_batch_to_multiple,
        replicate,
        shard_batch,
    )
    from treemorph_tpu_torch.train import harness

    local = shard_batch(pad_batch_to_multiple(dp_batch(root, family),
                                              mesh.size), mesh)
    out = {}
    for dtype in dtypes:
        model, (forward_fn, loss_fn) = dp_model(
            family, local.batch_size, capacity, dtype, mesh.device, mesh)
        state = harness.TrainState(model, harness.make_optimizer(model))
        replicate(state, mesh)
        step = harness.make_train_step(forward_fn, loss_fn, mesh=mesh)
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        metrics, grads = recorded_step(step, state, local,
                                       torch.Generator().manual_seed(1))
        torch.cuda.synchronize(mesh.device)
        first = time.perf_counter() - t0
        launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                    if v != before.get(k, 0)}
        after = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
        out[dtype] = {"metrics": metrics, "grads": grads, "state": after,
                      "launches": launches, "first_step_seconds": first,
                      "step_seconds": timed_steps(step, state, local,
                                                  mesh.device, reps),
                      "rows": int(local.coords.shape[0]),
                      "peak_memory_gb":
                          torch.cuda.max_memory_allocated(mesh.device) / 1e9}
        del model, state
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def dp_emulated_step(family, batch, world, capacity, dtype, device):
    """The data-parallel step in one process, without collectives: the
    batch padded to ``world`` shards; each shard's forward in train mode
    with its rank's generator (BN running statistics from the same start,
    then averaged over the shards), each loss term's numerator over the
    global denominator, summed and differentiated by autograd, then the
    optimizer. Returns the loss, the gradients before the clip and the
    state after the step."""
    import torch

    from treemorph_tpu_torch.parallel import Mesh, pad_batch_to_multiple
    from treemorph_tpu_torch.parallel.mesh import rank_generator
    from treemorph_tpu_torch.train import harness

    padded = pad_batch_to_multiple(batch, world)
    n = padded.batch_size // world
    model, (forward_fn, loss_fn) = dp_model(family, n, capacity, dtype,
                                            device)
    model.train()
    start = {k: b.clone() for k, b in model.named_buffers()}
    shards = [padded.map(lambda a, r=r: torch.as_tensor(
        a[r * n:(r + 1) * n]).to(device)) for r in range(world)]
    sem = [float(s.mask_valid.sum()) for s in shards]
    off = [float((s.mask_valid & s.mask_off).sum()) for s in shards]
    total, stats = 0.0, []
    for r, (shard, d_sem, d_off) in enumerate(zip(shards, sem, off)):
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(start[k])
        generator = rank_generator(torch.Generator().manual_seed(1),
                                   Mesh(r, world, device))
        _, terms = loss_fn(forward_fn(model, shard, True, generator), shard)
        total = (total + terms["semantic_loss"] * (d_sem / max(sum(sem), 1))
                 + terms["offset_loss"] * (d_off / max(sum(off), 1)))
        stats.append({k: b.clone() for k, b in model.named_buffers()})
    with torch.no_grad():
        for k, b in model.named_buffers():
            if b.is_floating_point():
                b.copy_(torch.stack([s[k] for s in stats]).mean(0))
    (total * harness.LOSS_BACKWARD_SCALE).backward()
    grads = {k: p.grad.detach().cpu().clone()
             for k, p in model.named_parameters()}
    harness.optimizer_step(harness.make_optimizer(model), DP_LR)
    return (float(total.detach()), grads,
            {k: v.detach().cpu().clone() for k, v in model.state_dict().items()})


def dp_plain_step(family, batch, capacity, dtype, device, reps=0):
    """The one-device ``make_train_step`` on the whole batch (step
    generator seed 1): loss, gradients before the clip, state after the
    step; then ``reps`` more steps, timed (returned fourth)."""
    import torch

    from treemorph_tpu_torch.train import harness

    model, (forward_fn, loss_fn) = dp_model(family, batch.batch_size,
                                            capacity, dtype, device)
    state = harness.TrainState(model, harness.make_optimizer(model))
    step = harness.make_train_step(forward_fn, loss_fn)
    on_device = batch.map(lambda a: torch.as_tensor(a).to(device))
    metrics, grads = recorded_step(step, state, on_device,
                                   torch.Generator().manual_seed(1))
    after = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return (metrics["loss"], grads, after,
            timed_steps(step, state, on_device, device, reps))


def dp_compare(label, family, rank, ref, dtype) -> dict:
    """Raise unless a rank's step agrees with ``ref`` (loss, gradients,
    state after the step; :func:`dp_emulated_step`'s or
    :func:`dp_plain_step`'s) within DP_GATES. The gradients are held to
    the gate; the parameters after the step are held to it beyond what
    the gradients' own difference moves them by: Adam's first update of an
    entry is ``lr * g / (|g| + eps)`` of its clipped gradient ``g``, so an
    entry whose gradient is near 0 (rounding noise, as where a BatchNorm
    removes a bias's shift) may move by up to twice the learning rate.
    Returns the errors read."""
    import torch

    from treemorph_tpu_torch.train import harness

    loss, grads, state = ref[:3]
    rtol, loss_rtol = DP_GATES[family][dtype]
    compare_steps(label, (rank["metrics"]["loss"], rank["grads"]),
                  (loss, grads), loss_rtol, rtol)

    def adam_first_updates(gradients):
        norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in gradients.values())))
        clip = min(1.0, harness.GRAD_CLIP_NORM / norm)
        return {k: DP_LR * (g.double() * clip) / (
            (g.double() * clip).abs() + harness.ADAM_EPS)
            for k, g in gradients.items()}

    explained = {k: (a - b).abs() for (k, a), b in zip(
        adam_first_updates(rank["grads"]).items(),
        adam_first_updates(grads).values())}
    top = max(float(state[k].abs().max()) for k in grads)
    worst = {"parameters": 0.0, "buffers": 0.0, "explained_entries": 0}
    for key, want in state.items():
        got = rank["state"][key]
        if not want.is_floating_point():
            assert torch.equal(got, want), key
            continue
        err = (got - want).abs().double()
        if key in grads:
            worst["explained_entries"] += int(
                ((err > rtol * top) & (err <= explained[key] * 1.01)).sum())
            err = torch.clamp(err - explained[key] * 1.01, min=0.0)
            worst["parameters"] = max(worst["parameters"],
                                      float(err.max()) / top)
        else:
            worst["buffers"] = max(worst["buffers"], float(err.max()) / max(
                float(want.abs().max()), 1e-30))
    log(f"{label}: state after the step: parameters within "
        f"{worst['parameters']:.2e} of the largest beyond what the "
        f"gradients' difference moves through Adam "
        f"({worst['explained_entries']} entries moved by it), BN "
        f"statistics within {worst['buffers']:.2e} of their scale "
        f"(limit {rtol})")
    if max(worst["parameters"], worst["buffers"]) > rtol:
        raise AssertionError(f"{label}: states disagree")
    return worst


def qsm_options_main(path):
    """17c's process: ``fit_qsm`` on the cloud at ``path`` with each of
    QSM_OPTION_CASES; prints one ``QSM_OPTIONS {json}`` line (cylinders and
    seconds per case)."""
    import numpy as np

    from treemorph_tpu_torch.pipeline.qsm import QSMParams, fit_qsm

    cloud = np.load(path)
    out = {"points": len(cloud)}
    for name, options in QSM_OPTION_CASES.items():
        t0 = time.perf_counter()
        table, _, _, _ = fit_qsm(cloud, params=QSMParams(seed=0, **options),
                                 save_csv=False)
        out[name] = {"cylinders": 0 if table is None else len(table),
                     "seconds": time.perf_counter() - t0}
    print("QSM_OPTIONS " + json.dumps(out), flush=True)


def start_qsm_options(path):
    """Start 17c's process (host work) beside the card phases."""
    code = (f"import chip_smoke; chip_smoke.qsm_options_main({path!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def kept_mask(points, kept):
    """Which rows of ``points`` the order-preserving subset ``kept`` holds
    (a denoised cloud): by row value where no row repeats, else by walking
    both in order."""
    import numpy as np

    pts = np.ascontiguousarray(points[:, :3], np.float32)
    kept = np.ascontiguousarray(kept, np.float32)
    rows = pts.view(np.dtype((np.void, 12))).ravel()
    if len(np.unique(rows)) == len(rows):
        return np.isin(rows, kept.view(np.dtype((np.void, 12))).ravel())
    mask = np.zeros(len(pts), bool)
    j = 0
    for i in range(len(pts)):
        if j < len(kept) and (pts[i] == kept[j]).all():
            mask[i] = True
            j += 1
    return mask


def phase_sharded_predict(points, device, mesh=None) -> dict:
    """17b: ``predict_rasterized_sharded`` on the PointNet2 plot (1 m
    rasters, the pipeline's seeded PointNet2, the offset and the noise
    model) over ``mesh`` (default: two slots on ``device``) against
    ``predict_rasterized`` on ``device``: offsets within
    SHARDED_OFFSET_RTOL of their scale, the kept points' agreement at least
    SHARDED_ARGMAX_AGREEMENT, each accumulator reduced once."""
    import numpy as np
    import torch

    from treemorph_tpu_torch.parallel import make_local_mesh
    from treemorph_tpu_torch.pipeline import predict

    mesh = mesh or make_local_mesh(devices=[device, device])
    offset, noise = pointnet2_models(device)
    cloud = np.asarray(points, np.float32)
    record = {"devices": [str(d) for d in mesh.devices]}
    for what, kw in (("offsets", dict(offset_model=offset, denoise=False)),
                     ("denoise", dict(noise_model=noise,
                                      predict_offset=False))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = predict.predict_rasterized(cloud, device=device, **kw)
        t1 = time.perf_counter()
        before = predict.REDUCTIONS["reduce_scatter"]
        sharded = predict.predict_rasterized_sharded(cloud, mesh=mesh,
                                                     device=device, **kw)
        t2 = time.perf_counter()
        reductions = predict.REDUCTIONS["reduce_scatter"] - before
        record[what] = {"single_seconds": t1 - t0,
                        "sharded_seconds": t2 - t1,
                        "reductions": reductions}
        if what == "offsets":
            moved = single - cloud[:, :3]
            err = float(np.abs(sharded - single).max()
                        / np.abs(moved).max())
            record[what]["max_err_of_scale"] = err
            ok = err <= SHARDED_OFFSET_RTOL
        else:
            agree = float((kept_mask(cloud, single)
                           == kept_mask(cloud, sharded)).mean())
            record[what].update(agreement=agree, kept_single=len(single),
                                kept_sharded=len(sharded))
            ok = agree >= SHARDED_ARGMAX_AGREEMENT
        # one reduction per accumulator: the sums and the counts
        ok = ok and reductions == 2
        log(f"17b {what}: {json.dumps(record[what])}")
        if not ok:
            raise AssertionError(f"17b sharded inference ({what}) failed")
    log("phase 17b ok")
    return record


def phase_data_parallel(root, points, device, qsm_cloud) -> dict:
    """17: 17c's process starts (host work), then 17a's rank processes
    (gloo on the one card, DP_WORLDS; and a world of one over
    DP_ONE_RANK_BACKEND), all together; while they run, this process
    computes their references and runs 17b. 17a: each rank's step against
    :func:`dp_emulated_step` (the world of one against
    :func:`dp_plain_step`), the band kernels' launches counted in every
    rank."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from treemorph_tpu_torch.parallel import spawn_ranks

    # the rank processes share the card with this one: hand back what the
    # earlier phases left in this process's cache
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qsm = start_qsm_options(qsm_cloud)
    batch = dp_batch(root, "treelearn")
    runs = [(world, dtypes, "gloo") for world, dtypes in DP_WORLDS]
    runs.append((1, ("float32",), DP_ONE_RANK_BACKEND))
    caps = {world: dp_capacity(root, world) for world, _, _ in runs}
    tmp = tempfile.mkdtemp(dir=root)
    dirs = {}
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = []
        for world, dtypes, backend in runs:
            out = dirs[world] = os.path.join(tmp, f"world{world}")
            os.makedirs(out)
            futures.append(pool.submit(
                spawn_ranks, dp_rank_main, world, "treelearn", root,
                caps[world], dtypes, out, backend=backend,
                devices=[device] * world, store_dir=out))
        refs = {}
        for world, dtypes in DP_WORLDS:
            for dtype in dtypes:
                refs[(world, dtype)] = dp_emulated_step(
                    "treelearn", batch, world, caps[world], dtype, device)
                torch.cuda.empty_cache()
        refs[(1, "float32")] = dp_plain_step("treelearn", batch, caps[1],
                                             "float32", device)
        torch.cuda.empty_cache()
        sharded = phase_sharded_predict(points, device)
        for f in futures:
            f.result()
    log(f"17a rank processes and references: {time.perf_counter() - t0:.1f}"
        " s")
    record = {"sharded_predict": sharded, "steps": {}}
    for world, dtypes, backend in runs:
        ranks = [torch.load(os.path.join(dirs[world], f"rank{r}.pt"))
                 for r in range(world)]
        for dtype in dtypes:
            label = f"17a {world} {backend} rank(s), {dtype}"
            errors = []
            for r, res in enumerate(ranks):
                errors.append(dp_compare(f"{label}, rank {r}", "treelearn",
                                         res[dtype], refs[(world, dtype)],
                                         dtype))
                launches = res[dtype]["launches"]
                log(f"{label}, rank {r}: {res[dtype]['rows']} rows, "
                    f"launches {json.dumps(launches)}, first step "
                    f"{res[dtype]['first_step_seconds']:.2f} s")
                if not (launches.get("band_conv", 0)
                        and launches.get("band_conv_bwd", 0)):
                    raise AssertionError(f"{label}, rank {r}: the band "
                                         "kernels did not launch")
            record["steps"][f"{world}_{backend}_{dtype}"] = {
                "launches_per_rank": [res[dtype]["launches"]
                                      for res in ranks],
                "errors": errors}
    log("phase 17a ok")
    stdout, stderr = qsm.communicate(timeout=600)
    if qsm.returncode != 0:
        log(stderr[-3000:])
        raise AssertionError(f"17c exited {qsm.returncode}")
    line = [x for x in stdout.splitlines() if x.startswith("QSM_OPTIONS ")]
    options = json.loads(line[-1].split(" ", 1)[1])
    log(f"17c {json.dumps(options)}")
    record["qsm_options"] = options
    if not all(options[name]["cylinders"] > 0 for name in QSM_OPTION_CASES):
        raise AssertionError("17c fitted no cylinder with an option")
    log("phase 17c ok")
    shutil.rmtree(tmp)
    return record


def pipeline_config(input_dir: str, output_dir: str,
                    model_type: str = "treelearn") -> dict:
    """``configs/pipeline_config.yaml`` as a dict (no YAML parser needed),
    with the smoke run's directories and the stage-1 cloud saved."""
    return {
        "general": {
            "input_dir": input_dir, "output_dir": output_dir,
            "save_model_predictions": True, "save_upsampling": False,
            "save_qsm_cyl_ply": False, "save_qsm_sphere_ply": False,
            "save_qsm_cyl_csv": True, "cloud_save_type": "npy",
        },
        "stage1": {"predict_offset": True, "denoise": True,
                   "model_type": model_type},
        "stage2": {"upsampling": True, "k_init": 10, "max_iterations": 10,
                   "min_height": 0.0, "use_only_original_points": True,
                   "min_points": MIN_POINTS},
        "stage3": {
            "qsm_fitting": True, "qsm_verbose": False, "qsm_debug": False,
            "qsm_params": {
                "eps_deg": 20, "min_samples": 5, "sphere_factor": 2.0,
                "radius_min": 0.15, "radius_max": 0.4,
                "min_growth_points": 10, "min_points_threshold": 4,
                "max_spread_growth": 1.05, "min_spread_growth": 0.33,
                "smallest_search_radius": 0.1, "search_radius_step": 0.1,
                "max_search_radius": 0.3, "max_dist": 0.4, "max_angle": 30,
                "distance_type": "center", "sphere_radius": 0.15,
                "sphere_thickness": 0.1,
                "sphere_thickness_type": "absolute",
                "clustering_algorithm": "agglomerative",
                "merging_procedure": "none",
                "clustering_linkage": "single",
                "clustering_type": "angular", "eps_cylinder": 0.1,
                "segmentation_type": "cylinder",
                "only_correct_connections": True, "priority_alpha": 0.5,
                "ransac_iterations": 10, "ransac_subset_percentage": 0.8,
            },
        },
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "treemorph_tpu_torch")):
        print("chip_smoke: treemorph_tpu_torch/ not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN: f32 comparisons are full f32")
    logging.basicConfig(level=logging.WARNING)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    phase_card_and_build()
    points = e2e_cloud()
    log(f"e2e cloud: {len(points)} raw points")
    fwd_record, fwd_rows = phase_kernel_vs_plain(points, device)
    phase_stage1_card_vs_cpu(points, device)
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "plot_cylinders.csv")
        fwd_launches = phase_end_to_end(points, device, csv_out=csv)
        t1 = time.perf_counter()
        phase_jax_checkpoint(points, device)
        phase_label_plot(points, csv, device)
        phase_preprocess_cli(device)
        log(f"phases 14a-14c: {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        phase_evaluate_qsm(points, csv, device)
        phase15_s = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as root:
        t1 = time.perf_counter()
        write_training_plots(root)
        batch, capacity = first_training_batch(root, device)
        log(f"training data: {TRAIN_PLOTS} plots x {TRAIN_TREES} trees x "
            f"{TRAIN_POINTS} points in {time.perf_counter() - t1:.1f} s; "
            f"level-0 voxel capacity {capacity}")
        bwd_record, per_step = phase_bwd_kernel_vs_plain(batch, capacity,
                                                         device)
        bwd125_record, per_step125 = phase_bwd_kernel_vs_plain(
            batch, capacity, device, kernel_size=5)
        phase_train_step_checks(batch, capacity, device)
        bwd_launches, cli_record = phase_training_cli(root, device)
        split = phase_step_split(batch, capacity, device)
        k5_launches = phase_k5_train_step(batch, capacity, device,
                                          bwd125_record["plans_ok"])
        t16 = time.perf_counter()
        engine_seconds = phase_treelearn_engines(points, batch, capacity,
                                                 device)
        phase16_s = time.perf_counter() - t16
        del batch
        log(json.dumps({**per_step, **split, **cli_record}))
        log(json.dumps({"k125": per_step125}))
        bwd_record["k125"] = {
            **{k: v for k, v in bwd125_record.items()
               if k not in ("name", "route", "source", "replaces")},
            "launches": k5_launches["band_conv_bwd"],
            "forward_kernel_launches_k125": k5_launches["band_conv_k125"],
            "launches_counted_on": "TreeLearn(kernel_size=5) train step"}
        cloud = ptv3_cloud(points)
        attn_record, _ = phase_attention_vs_plain(cloud, device)
        phase_ptv3_card_vs_cpu(cloud, device)
        attn_launches = phase_ptv3_end_to_end(cloud, device)

        ptv3_batch = ptv3_training_batch(root, device)
        calls = capture_ptv3_step(ptv3_batch, device)
        attn_bwd_record, _ = phase_attention_bwd_vs_plain(calls, device)
        phase_ptv3_train_checks(root, calls, device)
        del calls
        attn_bwd_launches, ptv3_cli_record = phase_ptv3_training_cli(
            root, device)
        ptv3_split = phase_ptv3_step_split(ptv3_batch, device)
        log(json.dumps({**ptv3_split, **ptv3_cli_record}))
        del ptv3_batch
        t16 = time.perf_counter()
        pad_fwd, pad_bwd = phase_pad_per_element(cloud, root, device)
        options_record = phase_rpe_pdnorm(root, device)
        cli16_record = phase_engine_clis(root, device)
        phase16_s += time.perf_counter() - t16
        t1 = time.perf_counter()
        pn2_train_record = phase_pointnet2_train_step(device)
        pn2_cli_record, pn2_ckpt = phase_pointnet2_training_cli(root, device)
        band_cli_record, band_ckpt = phase_ptv3_band_cli(root, device)
        tl_ckpt = pipeline_treelearn_checkpoint(root, device)
        phase_pipeline_cli(root, {
            "treelearn": tl_ckpt, "pointnet2": pn2_ckpt,
            "pointtransformerv3": band_ckpt}, device)
        log(f"phases 13a-13d: {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        phase_evaluate_nn(root, {"treelearn": tl_ckpt,
                                 "pointtransformerv3": band_ckpt}, device)
        phase_test_model(root, tl_ckpt, device)
        phase_import_round_trip(points, device)
        phase_mfu(points, fwd_rows, device)
        phase_sanity_check(device)
        phase15_s += time.perf_counter() - t1
        log(f"phase 15: {phase15_s:.1f} s")
        t1 = time.perf_counter()
        dp_record = phase_data_parallel(
            root, points, device, os.path.join(
                root, "pipeline_out", "pointnet2", "tree_supsamp.npy"))
        log(f"phase 17: {time.perf_counter() - t1:.1f} s")
    levels = e2e_levels(points, device)
    profile = profile_rulebooks(device)
    zband_record, _ = phase_zband_vs_plain(profile, levels, device)
    phase_zband_autograd(profile, device)
    zband_launches = phase_profile_zband(device)
    del profile
    brick_record, _ = phase_brick_vs_plain(levels, device)
    brick_launches = phase_brick_autograd(levels, device)
    phase_brick_engine(levels, device)
    t16 = time.perf_counter()
    phase_tiles_and_runs(levels, device)
    phase16_s += time.perf_counter() - t16
    bench_cloud = bench_tree_cloud()
    bench_records, _ = phase_bench_kernels(bench_cloud, device)
    bench_launches = phase_bench_card_vs_cpu(bench_cloud, device)
    t16 = time.perf_counter()
    phase_ptv3_zpack(bench_cloud, device)
    phase16_s += time.perf_counter() - t16
    log(f"phase 16: {phase16_s:.1f} s")
    log(json.dumps({"phase16": {"treelearn_engine_seconds": engine_seconds,
                                "options": options_record,
                                **cli16_record}}))
    del bench_cloud
    phase_bench_end_to_end(ptv3_cloud(points), device)
    phase_pointnet2_card_vs_cpu(points, device)
    phase_pointnet2_end_to_end(points, device)
    path = "ptv3 bench serving (predict_single on the bench tree)"
    fwd_record["k125"] = {
        **bench_records[125], "launches": bench_launches[125],
        "launches_counted_on": path}
    fwd_record["ptv3_bench_k27"] = {
        **bench_records[27], "launches": bench_launches[27],
        "launches_counted_on": path}
    # the PTv3 CLI's band configuration (13c): launches per train step
    per_step = band_cli_record["ptv3_band_launches_per_step"]
    band_path = ("ptv3 training CLI, --engine band --dedup_divisor 4 "
                 "--conv_dtype bfloat16, one train step (13c)")
    path16 = ("ptv3 pad_per_element (16a): a predict_single forward; a "
              "4-tree train step")
    attn_record["pad_per_element"] = {**pad_fwd,
                                      "launches_counted_on": path16}
    attn_bwd_record["pad_per_element"] = {**pad_bwd,
                                          "launches_counted_on": path16}
    dp_path = ("data-parallel TreeLearn train step (17a), per rank, "
               "gloo ranks on one card")
    for record, key in ((fwd_record, "band_conv"),
                        (bwd_record, "band_conv_bwd")):
        record["data_parallel_step"] = {
            world: [r.get(key, 0) for r in step["launches_per_rank"]]
            for world, step in dp_record["steps"].items()}
        record["data_parallel_step"]["launches_counted_on"] = dp_path
    for record, keys in ((fwd_record, ("band_conv_k125", "band_conv_k27")),
                         (bwd_record, ("band_conv_bwd",)),
                         (attn_record, ("window_attention",)),
                         (attn_bwd_record, ("window_attention_bwd",))):
        record["ptv3_band_cli"] = {
            **{f"launches_{k}": per_step.get(k, 0) for k in keys},
            "launches_counted_on": band_path}
    log(json.dumps({"pn2_train": {k: v for k, v in pn2_train_record.items()
                                  if k != "pn2_train_step_profile"},
                    **pn2_cli_record}))
    log(f"total {time.perf_counter() - t0:.1f} s")
    head = ("name", "route", "source", "replaces")
    kernels = []
    for record, launches, path in (
        (fwd_record, fwd_launches, "serving"),
        (bwd_record, bwd_launches, "training"),
        (attn_record, attn_launches, "ptv3 serving"),
        (attn_bwd_record, attn_bwd_launches, "ptv3 training"),
        (zband_record, zband_launches,
         "z-band profile (python -m treemorph_tpu_torch.scripts."
         "profile_zband)"),
        (brick_record, brick_launches,
         "level-0 brick path, forward and backward"),
    ):
        kernels.append({
            **{k: record[k] for k in head}, "launches": launches,
            "launches_counted_on": path,
            **{k: v for k, v in record.items() if k not in head},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
