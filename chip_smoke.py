#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`egt_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure makes the exit code non-zero and suppresses the
final result line):
  1. host record: `nvidia-smi` name and power limit, torch and CUDA versions,
     `nvcc --version`;
  2. build the nine CUDA kernels from `egt_torch/csrc` (one nvcc each, in
     parallel); the HMMA (tensor-core) instruction count of K1's, K2's,
     K3's, K4's, K5's, K7's, K6's and K8's libraries per kernel function from
     `cuobjdump -sass` ("not available" without it): non-zero in the bf16
     tensor-core bodies, zero in the f32 ones;
  3. each kernel against its plain PyTorch version on the card, at the
     ZINC-500k shapes in f32 and bf16 with ragged node masks, plus one
     awkward shape: the forwards K1 and K3 at inference and in training mode
     (random mask 0.1 and dropout 0.1 live, h_hat out), the backwards K4, K5,
     K7 (merged: K4's and K5's bodies, de_mid and dhh handed over in f32),
     K6 (mono: a head kernel recomputes h_hat and the clip's in-range flags,
     then K7's bodies, K5's under the mono switch; the head kernel also
     alone against its plain version, flags equal; K7 and K6 bit-identical
     across two launches, and in f32 equal to their parts run in turn bit
     for bit) and K2 with the same draws (awkward: l 37, ew 32, h 4, hard
     mask; K1 and K2 tagged with the body their geometry queries name, q
     and k scaled by 2 on a 1/8 grid so that the clip binds on a share of
     pairs and q.k is exact in any summation order); the edge block's K8 and K9 with h_hat head-major, as
     path C hands it over, and as rows (awkward: ew 32, hidden 64, h 4,
     rows, a pair count that is no multiple of the 32-pair tile; ew 128,
     hidden 256, h 16, l 11 head-major: K8's bf16 body at fewer warps a
     block; ew 160, hidden 160: K8's CUDA-core body; both bf16 only and
     without K9, whose bodies do not fit there),
     each tagged with the body K8's geometry query names, K8's bf16 output
     bit-identical across two launches; K3, K4 and K9 (and K5-
     K7) also at the other shipped edge widths, 8 (hidden 16) and 48
     (hidden 96), with 8 heads and 6845 pairs (no multiple of the bf16
     128-pair tile); K5 alone at the flagship batch with ragged l (9, 41:
     a cluster's last block with fewer rows, keys padded to 16) at ew 8,
     48 and 80, gated and ungated, constrained, and at l 150 (several rows
     a warp), and through its general body at h 32 gated (the PCQM4Mv2
     large config's heads), h 64, h 6, ew 136, odd dh and one warp a
     block; two launches of K4, K5 and K9 give bit-identical weight
     gradients (and K5's dk, dv); errors, kernel / plain
     times (CUDA events, median of 30 launches with L2 flushed before each)
     and the reckoned bound; then (3d) the SBM shapes of the PATTERN /
     CLUSTER 500k configs: K3 (inference and training), K4 and K5 at 128
     graphs, l 128 and 192, ew 8, hidden 16, 8 heads, width 64, f32 and
     bf16, each bucket's graphs of its node range (44-128, 129-188), with
     K5's layout printed; K1 and K2 at the SBM tile (h 8, lq = lk = 192,
     d 8, their CUDA-core bodies), each timed beside its bound; then (3e)
     K3 (inference and training), K4 and K5 at the superpixel pads, 128
     graphs, l 75 (MNIST: 40-75 nodes) and l 150 (CIFAR10: 85-150), ew 8,
     hidden 16, 8 heads, width 64, f32 and bf16, timed beside their
     bounds, with the layouts `bwd_attn_geometry` and `bwd_tail_geometry`
     name at both pads; then (3f) K3 (inference and training), K4 and K5
     at the TSP batch of 8, l 128, 256 and 512 (50-128, 129-256, 257-500
     points), ew 8, hidden 16, 8 heads, width 64, f32 and bf16, timed
     beside their bounds (a call past 100 ms over 5 launches, not 30), K5
     also ungated at l 512, and the layouts at each pad, K5's bf16 body
     asserted to keep k, v, dk and dv in device memory (`kv_global`), one
     block a graph, at l 256 and 512; then (3g) K1 (inference and
     training) and K2 at the `egt_simple` shapes (the `bias` edge channel's
     main path, 8 heads): ZINC 128 graphs, l 40, d 10 (the tensor-core
     bodies, asserted), the superpixel pads 75 / 150 and the SBM buckets
     128 / 192 at 128 graphs and the TSP buckets at 8, d 8 (the CUDA-core
     bodies, asserted; K2's block 164,608 B at l 512), f32 and bf16, timed
     beside their bounds, K2's dk and dv bit-identical across two launches
     at l 512, and a general-valued bf16 case there; then (3h) K1
     (inference and training) and K2 at the PCQM4Mv2 EGT-Large tile: 128
     graphs, 32 heads of 24 (the CUDA-core bodies, asserted), l 36 (pad 32
     and 4 virtual nodes) and l 60 (pad 56, the real data's largest
     molecules), attention dropout 0.3 live, gated with the degree output,
     f32 and bf16, timed beside their bounds, K2's dk and dv bit-identical
     across two launches at l 60; then (3i) K1 (inference and training)
     and K2 on the row blocks of edge partitioning over 2 shards (ROW_TILES:
     one shard's query rows against every key): ZINC 128 graphs, lq 20 /
     lk 40, 8 heads of 8 (the tensor-core bodies in bf16, asserted), TSP 8
     graphs, lq 256 / lk 512 and PCQM4Mv2 128 graphs, 32 heads of 24, lq 4
     + 16 / lk 36 (the CUDA-core bodies), f32 and bf16, timed beside their
     bounds;
  4. serving paths: `load_predictor` on configs/main/zinc/500k/egt.json with
     seeded weights under the JAX names answers 4 requests of 128 synthetic
     ZINC-shaped graphs, checked against the model's plain path (bf16 and
     f32): path A through the whole-layer kernel K3 (10 launches a request);
     path B (use_pallas true, use_pallas_layer false) through the attention
     kernel K1; path C (also use_pallas_edge true) through K1 and the edge
     block K8 (10 launches each a request); then (4b) `load_predictor` on
     configs/main/pattern/500k/egt.json with seeded weights answers 2
     requests of 128 synthetic PATTERN graphs in each length bucket (l
     128: 44-128 nodes, l 192: 129-188) through K3 (16 launches a
     request), its (b, l, 2) node logits checked on the valid nodes
     against the model's plain path (bf16: each logit within 5e-2 + 2e-2
     |plain|, the kernels' bf16 tolerance, as a logit a node is no mean
     over a graph; f32: 5e-4), and both paths' bf16 distance from the f32
     plain path printed; (4c) MNIST and CIFAR10 `egt_spe_do`, 4 requests of
     128 graphs; (4d) configs/main/tsp/500k/egt.json, 2 requests of 24
     graphs (the prediction batch) in each length bucket, K3 16 launches a
     request, the (b, l, l, 2) edge logits on the valid pairs checked as
     PATTERN's node logits are, the median latency printed; then (4e) the
     `egt_simple` configs as shipped, through K1 (one launch a layer a
     request, K3 none): ZINC 4 x 128 graphs (predictions within 5e-2 of
     the plain path), PATTERN 2 x 128 at l 128 and 192, TSP 2 x 24 in each
     bucket (the pairwise-cat edge readout); then (4f)
     configs/pcqm4mv2/egt_large.json (30 layers, width 768) with `use_pallas`
     true, through K1 (30 launches a request), 4 requests of the shipped
     1,024 synthetic molecules at l 36 and 2 at l 60, the (b, 1)
     predictions within 5e-4 of the plain path (as shipped) in f32, and in
     bf16 at most 1.5 times as far from the f32 plain path as the bf16
     plain path; then (4j, with 5j and 5k after phase 5) two ranks on this
     one card over gloo (`egt_torch.parallel.launch`): ZINC 500k and TSP
     500k `egt.json` with `edge_partition` 2 and `use_pallas` true through
     `load_predictor(..., mesh=)`, 4 requests in f32 and bf16, K1 one launch
     a layer a request on each rank, the predictions against the unsharded
     port's on the card (f32 5e-4, bf16 5e-2 + 2e-2 |unsharded|);
  5. training paths: `load_trainer` on the same config and weights takes a
     warm-up step, then 4 timed steps on 128-graph batches (bf16, random
     mask 0.1 live); each path's launches a step are checked, its
     first-step gradients of every parameter and its losses over 3 steps
     agree with the plain path's (f32 and bf16, same weights and seeds, the
     same draws), and 20 steps on one batch lower the loss. Path A (K3; K4
     and K5), path B (K1; K2), path C (K1, K8; K9, K2: 9 K9 launches a step,
     as the last layer's edge output feeds no loss and autograd never runs
     its backward), A-merged (K3; K7) and A-mono (K3; K6), the last two with
     `fused_layer.BWD_IMPL` set as `EGT_FUSED_BWD` would set it; then
     (5b) `load_trainer` on the PATTERN config takes a warm-up step and 4
     timed steps at l 192, and 1 + 2 at l 128 (bf16, random mask 0.1
     live), K3 / K4 / K5 16 launches each a step; its 3 losses and
     step-1 gradients agree with the plain path's (f32 and bf16) on 32
     graphs a batch (the plain path's autograd at 128 graphs and l 192
     would not fit the card), and 20 steps on one batch of 128 lower the
     loss; the same step checks for CLUSTER at l 192; then (5c) CIFAR10 and
     MNIST `egt_spe_do` take 1 + 4 steps (random mask, SVD sign flips and
     the distance head live; K3 / K4 / K5 4 each a step), agree with the
     plain path (3 losses, every step-1 gradient, f32 and bf16) with the
     last layer's edge tail and `edge_norm_final` reached on both paths,
     and lower the loss over 20 steps on one batch; the same agreement for
     configs/main/pattern/500k/egt_epe.json (eigenvector PE) at l 128 on
     32 graphs a batch, cut to 8 of its 16 layers (PE_AGREE_DEPTH), and
     configs/main/zinc/500k/egt_spe_do.json at pad 40 on 128; each bf16
     agreement also prints both paths' distance from the f32 plain path;
     then (5d) the TSP 500k `egt.json` takes a warm-up step and 4 timed
     steps at l 512, 1 + 2 at l 256 and at l 128 (random mask live), K3 /
     K4 / K5 16 each a step; its 3 losses and step-1 gradients agree with
     the plain path's at l 512 and l 128 on 8 graphs a batch, the last
     layer's edge tail and `edge_norm_final` reached on both paths (the
     edge readout reads them), the peak device memory printed; 20 steps on
     one batch at l 128 lower the loss; the same agreement for
     `tsp/500k/egt_spe.json` at l 256 with the SVD sign flips live; then
     (5e) the `egt_simple` configs: ZINC 1 + 4 steps, PATTERN 1 + 4 at l
     192 and 1 + 2 at l 128, TSP 1 + 4 at l 512 and 1 + 2 at l 256 and 128,
     MNIST and CIFAR10 1 + 2 (random mask live), K1 and K2 one launch each a
     layer a step and K3-K9 none; agreement with the plain path (3 losses,
     every step-1 gradient, f32 and bf16) at ZINC, PATTERN l 192 on 32
     graphs, TSP l 512 on 8 and CIFAR10 l 150, the edge embeddings'
     gradients non-zero on both paths; a falling ZINC loss; then (5f)
     EGT-Large with `use_pallas` true: 1 + 4 optimizer steps of 8
     micro-batches of 128 at l 36 (the shipped batch of 1,024), K1 / K2 30
     each a micro-batch and K3-K9 never, one micro-batch at l 60, the peak
     device memory at micro-batches of 128 and 256, the 3 losses and
     step-1 gradients of 3 micro-batch steps against the plain path's (f32
     and bf16), 20 steps on one micro-batch lowering the loss under a
     10-step warmup; and ZINC `egt.json` with a virtual node through K3 /
     K4 / K5 (10 each a step) against its plain path; then (5j) the same
     two ranks' `load_trainer(..., mesh=)` of phase 4j's configs: one f32
     step with the draws off against the unsharded step (loss and every
     gradient at phase 5's f32 tolerance), 1 + 4 steps as shipped (bf16,
     random mask live), K1 and K2 10 (ZINC) or 16 (TSP) launches each a
     step a rank and K3-K9 none, the step time beside the unsharded
     port's and the collective bytes and host ms a step; and (5k) data
     parallelism over the two ranks on path A (K3 / K4 / K5 10 each a step
     at 64 graphs a rank), the draws off: the loss and every parameter
     after one step against one process's step on the same 128 graphs
     (f32 1e-5; elements whose exact gradient is 0 to 2 x the learning
     rate, the bound of a first Adam step), the draws on: the ranks' seeds
     and random-mask bits differ;
  6. the engine: the CLI triple on the flagship ZINC config over 10,000 /
     1,000 / 1,000 synthetic ZINC graphs (2 epochs, a resume to 3,
     evaluation, final weights; launches counted, the saved weights
     served, steps under `set_sync_debug_mode("error")`); then (6b) on the
     PATTERN config over 1,280 / 256 / 256 synthetic PATTERN graphs (the
     published splits are 10,000 / 2,000 / 2,000; 1 epoch of the shipped
     200), only `dataset_path`, `cache_dir`, `save_path`, `num_epochs` and
     `log_tensorboard` overridden: both length buckets in every split
     (the larger cut to the split's largest graph, rounded up to 8, as the
     reader does), K3 / K4 / K5 launches = 16 x steps (K3 also 16 x
     evaluation batches), the SBM evaluation lines of all three splits,
     the weights written, each epoch's seconds, graphs/s and wait share;
     then (6c) the CLI triple of configs/main/mnist/100k/egt_spe.json over
     2,560 / 512 / 512 synthetic superpixel graphs (of the published
     55,000 / 5,000 / 10,000; the reader's SVD cache built from the
     records), 1 epoch of the shipped 200, the evaluation lines, the epoch
     line and its share waiting for data; then (6d) the CLI triple of
     configs/main/tsp/100k/egt_spe.json over 240 / 48 / 48 synthetic TSP
     graphs (`synthetic.tsp_records`; of the published 10,000 / 1,000 /
     1,000; the SVD cache built from the records), 1 epoch of the shipped
     100, all three length buckets in every split, K3 / K4 / K5 launches =
     4 x steps, the accuracy, precision, recall and F1 lines of each split,
     the epoch line and its wait share; then (6e) the CLI triple of
     `ablation/egt_simple/zinc_full/500k/egt_simple.json` over 10,000 /
     1,000 / 1,000 synthetic ZINC-full graphs (of the published 220,011 /
     24,445 / 5,000), 1 epoch of the shipped 200 and a resume to 2, K1 /
     K2 launches = 10 x steps (K1 also 10 x validation and evaluation
     batches), the MAE lines, the epoch lines and their wait share; then
     (6f) the CLI triple of EGT-Large (`use_pallas` true, micro-batches of
     128, 8 a step) over 8,192 / 1,024 / 1,024 synthetic PCQM4Mv2 molecules
     (`synthetic.pcqm_records`; of the published 3,378,606 / 73,545 /
     147,037), 1 epoch of the shipped 300 and a resume to 2, K1 / K2
     launches = 30 x micro-batches (K1 also 30 x validation and evaluation
     batches), the MAE lines, the epoch lines and their wait share; and
     (6g, on phase 6's run directory right after it) the remaining entry
     points: `make_predictions` on the run's final weights (K3 10 launches
     a batch; every split's predictions finite, the test split's equal to
     `predict_split`'s); `export_serving` of the flagship config on path A
     (K3), of `ablation/egt_simple/zinc/500k/egt_simple.json` on path B
     (K1, seeded weights) and of the flagship config with
     `use_pallas_edge` on path C (K1, K8), each in bf16 and f32 (no launch
     while tracing), the six artifacts loaded in one fresh process that
     imports no `egt_torch.models`, `.schemes`, `.training`, `.utils` or
     jax, each serving 4 requests of the test split's 256-graph prediction
     batches: the graph's kernel op nodes and the launches a request (10
     of its kernels), the outputs against `load_predictor`'s live ones (f32
     1e-6, bf16 5e-2), the request latency of both beside the card's name
     and power limit; `do_analysis` in bf16 and f32 on the card and in f32
     on the CPU (no kernel launch under capture; the 40 keys of 10 layers,
     (256, 40, 40, 8) each; the f32 captures of the card within 1e-4 of
     the CPU's); and (6j) `torchrun --standalone --nproc_per_node 2 -m
     egt_torch.run_training` of the flagship config on phase 6's data with
     `distributed` true and `edge_partition` 2 (both ranks on this card,
     gloo): one epoch of 20 steps, rank 0's checkpoint, and a resume to
     epoch 2;
  7. one JSON line listing every kernel with its launches on its training
     path, its times and its bound, and K3, K4 and K5 again at the SBM
     shapes (bf16, training) with PATTERN's launches in each bucket and at
     the superpixel pads with MNIST's (l 75) and CIFAR10's (l 150)
     launches, at the TSP pads with TSP 500k's launches in each
     bucket, K1 and K2 at the `egt_simple` shapes with the launches of
     phase 5e's timed steps there, at the PCQM4Mv2 tile with phase
     5f's, and K3, K1 and K8 (their inference cases at the flagship and
     `egt_simple` ZINC tiles) with the launches of the bf16 serving
     artifacts of paths A, B and C in phase 6g, and K1 and K2 at the
     ZINC and TSP row blocks of phase 3i with rank 0's launches in phase
     5j's timed steps;
  8. last line: {"ok": true, "device": {...}}.
TF32 is off for matrix products and convolutions (full f32 references).
Exits non-zero without a result when no CUDA device is present or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import importlib.util
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "main" / "zinc" / "500k" / "egt.json"
N_REQUESTS, GRAPHS, PAD = 4, 128, 40
N_STEPS, N_FALL = 4, 20          # timed training steps; the loss-falls run
# the SBM node-classification configs (PATTERN, CLUSTER 500k: 16 layers,
# width 64, edge width 8, 8 heads) and their length buckets with the node
# counts each takes (the data: 44-188 nodes for PATTERN, 40-190 CLUSTER)
SBM_CONFIGS = {kind: REPO / "configs" / "main" / kind / "500k" / "egt.json"
               for kind in ("pattern", "cluster")}
SBM_BUCKETS = {128: (44, 128), 192: (129, 188)}
N_SBM_STEPS = {192: 4, 128: 2}    # timed SBM training steps a bucket
# graphs a batch in the SBM agreement with the plain path: the plain path's
# autograd keeps some 3-4 GB of pair tensors a layer at 128 graphs and
# l 192, 16 layers of which would not fit the card's memory
SBM_AGREE = 32
# the superpixel configs (MNIST / CIFAR10 100k `egt_spe_do`: 4 layers, width
# 64, edge width 8, 8 heads, the SVD PE, the distance head), their pads and
# the node counts of their graphs (Dwivedi et al.: 40-75, 85-150)
SP_CONFIGS = {kind: REPO / "configs" / "main" / kind / "100k" /
              "egt_spe_do.json" for kind in ("mnist", "cifar10")}
SP_PADS = {75: (40, 75), 150: (85, 150)}
SP_KIND = {75: "mnist", 150: "cifar10"}
# depth of the PATTERN `egt_epe` agreement with the plain path (of the
# shipped 16): at 16 layers the random-weight model's first Adam step is
# chaotic (the f32 loss goes 0.22 -> 0.83): each bf16 path's later losses
# lie 3-5% and its gradients 13-16% from the f32 plain path's, so the two
# bf16 paths differ there by 1-2% in loss, past the 0.5% of TRAIN_TOL
# (`python -m egt_torch.precision_drift` prints these); at 8 both lie
# within 0.7% of f32 and within 0.2% of each other
PE_AGREE_DEPTH = 8
# the TSP edge-classification configs (500k `egt.json`, `egt_spe.json`: 16
# layers; 100k `egt_spe.json`: 4; width 64, edge width 8, 8 heads, batch 8,
# prediction batch 24) and their length buckets with the node counts each
# takes (the data: 50-500 points)
TSP_DIR = REPO / "configs" / "main" / "tsp"
TSP_BUCKETS = {128: (50, 128), 256: (129, 256), 512: (257, 500)}
TSP_BATCH = 8
N_TSP_STEPS = {512: 4, 256: 2, 128: 2}   # timed TSP training steps a bucket
# graphs a batch in the TSP agreement with the plain path: 8 x 512^2 = 2.1 M
# pairs, whose autograd through 16 layers the card holds
TSP_AGREE = 8
# the `egt_simple` ablations (the `bias` edge channel, no edge update: the
# attention kernel K1 forward and K2 backward in every layer, K3-K5 never):
# the configs a family, and their attention shapes at 8 heads, (graphs, l,
# d, node range) by family and pad: ZINC at width 80 (d 10, the tensor-core
# bodies, rows of 20 bytes), the others at width 64 (d 8, past 64 keys the
# CUDA-core bodies)
SIMPLE_DIR = REPO / "configs" / "ablation" / "egt_simple"
SIMPLE_CONFIGS = {kind: SIMPLE_DIR / kind / size / "egt_simple.json"
                  for kind, size in (("zinc", "500k"), ("pattern", "500k"),
                                     ("tsp", "500k"), ("mnist", "100k"),
                                     ("cifar10", "100k"))}
SIMPLE_SHAPES = {
    "ZINC": (GRAPHS, PAD, 10, (9, 38)),
    **{f"SP l {l}": (GRAPHS, l, 8, n) for l, n in SP_PADS.items()},
    **{f"SBM l {l}": (GRAPHS, l, 8, n) for l, n in SBM_BUCKETS.items()},
    **{f"TSP l {l}": (TSP_BATCH, l, 8, n) for l, n in TSP_BUCKETS.items()}}
# the run whose timed steps give each shape's launches (phase 5e)
SIMPLE_RUNS = {"ZINC": ("zinc", PAD), "SP l 75": ("mnist", 75),
               "SP l 150": ("cifar10", 150),
               **{f"SBM l {l}": ("pattern", l) for l in SBM_BUCKETS},
               **{f"TSP l {l}": ("tsp", l) for l in TSP_BUCKETS}}
# PCQM4Mv2 EGT-Large (30 layers, width 768, edge width 64, 32 heads of 24, 4
# virtual nodes, the degree scaler, attention dropout 0.3): with the kernel
# knob on, K1 forward and K2 backward in every layer (the scaler refuses the
# whole-layer kernel). Its attention lengths with the virtual rows: l 36 (the
# synthetic corpus pads to 32, as the reader pads it) and l 60 (the real
# data's largest molecules, about 51 atoms, pad 56), each with the valid
# rows' range (virtual nodes and atoms) and the molecules' largest size
PCQM_CONFIG = REPO / "configs" / "pcqm4mv2" / "egt_large.json"
PCQM_HEADS, PCQM_D, PCQM_K, PCQM_DROP = 32, 24, 4, 0.3
PCQM_PADS = {36: ((8, 36), 32), 60: ((37, 55), 51)}
# a training micro-batch and the micro-batches an optimizer step: the
# shipped batch of 1,024 as JAX's own rehearsal runs it (one micro-batch of
# 1,024 would not fit the card); a request is the shipped batch
PCQM_MICRO, PCQM_ACCUM, PCQM_REQUEST = 128, 8, 1024
# the falling-loss run's warmup, in place of the shipped 15,000 steps, whose
# rate stays near zero through it
PCQM_FALL_WARMUP = 10
# the row blocks of edge partitioning over 2 shards (phase 3i): (graphs,
# heads, query rows, keys, d, the graphs' node range, the draws (random
# mask, dropout), the bf16 bodies on the tensor cores); PCQM4Mv2's query
# rows are its 4 virtual rows and half of its 32 atom rows
ROW_TILES = {
    "ZINC": (GRAPHS, 8, PAD // 2, PAD, 8, (9, 38), (0.1, 0.1), True),
    "TSP": (TSP_BATCH, 8, 256, 512, 8, TSP_BUCKETS[512], (0.1, 0.1), False),
    "PCQM4Mv2": (PCQM_MICRO, PCQM_HEADS, PCQM_K + 16, 36, PCQM_D,
                 PCQM_PADS[36][0], (0.0, PCQM_DROP), False)}
# a kernel call past SLOW_MS is timed over SLOW_ITERS launches, not 30
SLOW_MS, SLOW_ITERS = 100.0, 5
SOURCES = ("fused_layer_fwd", "egt_attention_fwd", "fused_layer_bwd_tail",
           "fused_layer_bwd_attn", "egt_attention_bwd", "fused_layer_bwd_merged",
           "fused_layer_bwd_mono", "edge_block_fwd", "edge_block_bwd")

# published dense peaks (NVIDIA data sheets): memory B/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores; matched on the device name
CARDS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),          # SXM
    "H200": (4.8e12, 989e12, 67e12),
}

# kernel-vs-plain tolerances: f32 sums are taken in another order (1e-4);
# bf16 is compared in the working type, where that order can flip one
# rounding of an intermediate: about two bf16 ulps of the output
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}   # (atol, rtol)
# whole-model agreement of a kernel path with the plain model path on the
# card, on predictions of magnitude ~1: f32 differs only by summation order;
# in bf16 the plain path rounds the gates, the edge bias and h_hat to bf16
# where the kernels keep f32, and 10 layers compound it
MODEL_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
# training agreement with the plain path (same weights, seeds and draws):
# losses relative; each parameter's step-1 gradient by max |kernel - plain|
# over max(max |plain|, 1e-2 G), G the largest gradient of the model, so a
# parameter whose gradient is only rounding noise (the key bias: softmax is
# shift-invariant) is held in absolute terms. f32: summation order, and a
# pair whose logit sits at the clip edge may fall on the other side of the
# whole-layer backward's strict in-range test on the saved h_hat. bf16: the
# plain path rounds the gates, the edge bias and h_hat where the kernels keep
# f32, through 10 layers forward and back.
TRAIN_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (5e-3, 5e-2)}  # loss, grad

failures: list[str] = []

# phase 6g's artifact loader, run in a fresh process: it imports
# `egt_torch.serving` (torch, numpy and the kernel ops) alone, loads each
# artifact, serves the requests after a warm-up, and reports the kernel op
# nodes of each graph, the kernel launches and the latency of each request,
# and the modules of the model, scheme, training or config code (or jax)
# that were imported
ARTIFACT_LOADER = """
import json, sys, time
import numpy as np
import torch
from egt_torch import serving
from egt_torch.ops import edge_block, egt_attention, fused_layer
torch.backends.cuda.matmul.allow_tf32 = False
arts = json.loads(open(sys.argv[1]).read())
n = int(sys.argv[4])
with np.load(sys.argv[2]) as data:
    reqs = [{k.split("/", 1)[1]: data[k] for k in data.files
             if k.startswith(f"{i}/")} for i in range(n)]
kernels = {"K3": fused_layer.KERNEL, "K1": egt_attention.KERNEL,
           "K8": edge_block.KERNEL}
out, report = {}, {}
for name, path in arts.items():
    fn = serving.load_serving(path)
    fn(reqs[0])
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    lat = []
    for i, r in enumerate(reqs):
        t = time.perf_counter()
        out[f"{name}/{i}"] = fn(r)
        lat.append(time.perf_counter() - t)
    report[name] = {"graph_ops": serving.kernel_ops(fn.program),
                    "launches": {k: v.launches for k, v in kernels.items()},
                    "latency_s": lat}
np.savez(sys.argv[3], **out)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "egt_tpu")
             or m.startswith(("egt_torch.models", "egt_torch.schemes",
                              "egt_torch.training", "egt_torch.utils")))
print(json.dumps({"artifacts": report, "imported": bad}))
"""


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def run(cmd) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return (res.stdout + res.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"


def card_peaks(name: str):
    for key, peaks in CARDS.items():
        if key in name:
            return peaks
    return CARDS["H100"]


def _parallel_rank(init: dict, plan: dict) -> dict:
    """One rank of phases 4j / 5j / 5k (`egt_torch.parallel.launch` starts
    two on the one card): the `edge_partition` 2 runs of `plan["sp"]`
    (requests in f32 and bf16, one f32 step with the draws off, then 1 + 4
    steps as shipped) on a mesh of 1 x 2, then the data-parallel step of
    `plan["dp"]` on a mesh of 2 x 1 (the draws off, then the draws' seeds
    and bits with them on). Returns the kernel launches, collective bytes,
    times and results of each."""
    import numpy as np
    import torch

    from egt_torch import serving
    from egt_torch.ops import edge_block as eb
    from egt_torch.ops import egt_attention as att
    from egt_torch.ops import fused_layer as fl
    from egt_torch.ops import rng
    from egt_torch.parallel import collectives as C
    from egt_torch.parallel import mesh as meshlib
    from egt_torch.training.steps import load_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {"K1": att.KERNEL, "K2": att.BWD_KERNEL, "K3": fl.KERNEL,
               "K4": fl.BWD_TAIL_KERNEL, "K5": fl.BWD_ATTN_KERNEL,
               "K6": fl.BWD_MONO_KERNEL, "K7": fl.BWD_MERGED_KERNEL,
               "K8": eb.KERNEL, "K9": eb.BWD_KERNEL}

    def counted(fn):
        """fn() with every launch count and the collective counters set to
        0: (its result, the launches, the collectives)."""
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        C.STATS.reset()
        res = fn()
        torch.cuda.synchronize()
        return res, {k: v.launches for k, v in kernels.items()}, \
            C.STATS.summary()

    def grads_of(model):
        return {k.replace(".", "/"): p.grad.float().cpu().numpy()
                for k, p in model.named_parameters() if p.grad is not None}

    def serve_all(predict, requests):
        preds, lat = [], []
        for r in requests:
            t = time.perf_counter()
            preds.append(predict(r))                   # host numpy: synced
            lat.append(time.perf_counter() - t)
        return preds, lat

    def timed_steps(tr, batches):
        times, losses = [], []
        for bt in batches:
            t = time.perf_counter()
            losses.append(tr.train_step(bt)["loss"])   # .item(): synced
            times.append(time.perf_counter() - t)
        return times, losses

    out = {}
    mesh = meshlib.make_mesh(2, model_parallel=2, **init)
    out["backend"] = mesh.backend
    for fam, p in plan["sp"].items():
        res = out[fam] = {}
        for dtype in ("float32", "bfloat16"):
            predict = serving.load_predictor(
                {**p["config"], "compute_dtype": dtype}, p["flat"],
                mesh=mesh)
            predict(p["requests"][0])                  # warm-up
            (preds, lat), launches, coll = counted(
                lambda: serve_all(predict, p["requests"]))
            res[f"serve {dtype}"] = dict(preds=preds, lat=lat,
                                         launches=launches, coll=coll)
        tr = load_trainer({**p["config"], "compute_dtype": "float32",
                           "random_mask_prob": 0.0}, p["flat"], mesh=mesh)
        loss = tr.train_step(p["train"][0])["loss"]
        res["agree"] = dict(loss=loss, grads=grads_of(tr.model))
        del tr
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = load_trainer(p["config"], p["flat"], mesh=mesh)
        tr.train_step(p["train"][0])                       # warm-up
        (times, losses), launches, coll = counted(
            lambda: timed_steps(tr, p["train"][1:]))
        res["steps"] = dict(times=times, losses=losses, launches=launches,
                            coll=coll,
                            peak=torch.cuda.max_memory_allocated())
        del tr
        torch.cuda.empty_cache()
    d = plan["dp"]
    dmesh = meshlib.make_mesh(2, model_parallel=1)
    tr = load_trainer({**d["config"], "compute_dtype": "float32",
                       "random_mask_prob": 0.0}, d["flat"], mesh=dmesh)
    shard = meshlib.batch_shard(d["batch"], dmesh)
    rep, launches, coll = counted(lambda: tr.train_step(shard))
    out["dp"] = dict(report=rep, launches=launches, coll=coll,
                     grads=grads_of(tr.model), params=tr.flat_params())
    del tr
    drawn = load_trainer(d["config"], d["flat"], mesh=dmesh)
    seeds = drawn.layer_seeds(0)
    l = d["batch"]["graph_matrix"].shape[1]
    out["dp"]["seeds"] = seeds
    out["dp"]["bits"] = rng.pair_uniform(
        seeds[0], (1, l, l, 8), rng.RANDOM_MASK, dmesh.device).cpu().numpy()
    out["dp"]["drawn"] = drawn.train_step(shard)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "egt_torch").is_dir() or not CONFIG.is_file():
        print("chip_smoke: run from a checkout of the repository "
              "(egt_torch/ and configs/ are missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from egt_torch import schemes, serving, synthetic
    from egt_torch.ops import _cuda
    from egt_torch.ops import edge_block as eb
    from egt_torch.ops import egt_attention as att
    from egt_torch.ops import fused_layer as fl
    from egt_torch.training import metrics as M
    from egt_torch.training import schedules
    from egt_torch.training.steps import load_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. host record
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    nvcc = run([_cuda._nvcc(), "--version"]).splitlines()
    print("nvcc: " + " | ".join(x for x in nvcc if "release" in x or
                                "Build" in x))
    print("host packages: " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("h5py", "scipy")) + " (the engine phase starts from the "
        "reader's cache either way)")
    name = torch.cuda.get_device_name(0)
    mem_bw, peak_bf16, peak_f32 = card_peaks(name)
    print(f"device {name}: bound rates {mem_bw / 1e12} TB/s, "
          f"{peak_bf16 / 1e12} TFLOP/s bf16, {peak_f32 / 1e12} TFLOP/s f32")

    # ---- 2. build
    t0 = time.perf_counter()
    logs = _cuda.build(SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'})")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    # tensor-core instructions in the SASS of K1's, K2's, K3's, K4's, K5's,
    # K7's, K6's and K8's libraries, per kernel function: the bf16 bodies
    # run mma.sync (HMMA), the f32 ones none (exact f32, no TF32)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for src in ("egt_attention_fwd", "egt_attention_bwd",
                "fused_layer_fwd", "fused_layer_bwd_tail",
                "fused_layer_bwd_attn", "fused_layer_bwd_merged",
                "fused_layer_bwd_mono", "edge_block_fwd"):
        if not Path(cuobjdump).exists():
            print(f"  {src}: HMMA count not available (no cuobjdump)")
            continue
        sass = run([cuobjdump, "-sass", str(_cuda.library_path(src))])
        counts = {}
        for part in sass.split("Function : ")[1:]:
            counts[part.split()[0]] = part.count("HMMA")
        print(f"  {src}: HMMA {sum(counts.values())} in all; " + ", ".join(
            f"{fn} {n}" for fn, n in counts.items()))
        mma = [n for fn, n in counts.items() if "mma_kernel" in fn]
        f32 = [n for fn, n in counts.items() if "kernelIf" in fn]
        check(bool(mma) and all(mma) and not any(f32),
              f"{src}: the bf16 body runs HMMA ({mma}), the f32 body "
              f"none ({f32})")

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters=30, warmup=3):
        """(median ms of `iters` launches, iters); a call that takes more
        than SLOW_MS is timed SLOW_ITERS times."""
        for _ in range(warmup):
            fn()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        if s.elapsed_time(e) > SLOW_MS:
            iters = SLOW_ITERS
        times = []
        for _ in range(iters):
            # a ~1 ms spin keeps the card busy while the host enqueues the
            # launch, so the events time the device work and not the Python
            # wrapper's overhead
            torch.cuda._sleep(2_000_000)
            flush.zero_()                    # the caller finds L2 cold
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            times.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in times), iters

    def bound_ms(nbytes, mm_flops, ew_flops, dtype):
        peak_mm = peak_bf16 if dtype == torch.bfloat16 else peak_f32
        t_bytes = nbytes / mem_bw
        t_ops = mm_flops / peak_mm + ew_flops / peak_f32
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def max_err(out, ref, dtype, scaled=False):
        """Largest |kernel - plain| and whether every element is within
        atol + rtol |plain|; `scaled` multiplies atol by max(1, max |plain|)
        (sums over many pairs: weight gradients, dk, dv)."""
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        out, ref = out.float(), ref.float()
        if scaled:
            atol *= max(1.0, float(ref.abs().max()))
        err = (out - ref).abs()
        ok = bool(torch.all(err <= atol + rtol * ref.abs())) and \
            bool(torch.isfinite(out).all())
        return float(err.max()), ok

    def off_clip(spec, e, w, hh):
        """hh with every pair at least 0.05 from the clip's edges in
        hh - E (moved by 0.25 where it is not): at an edge, K5's strict
        in-range test follows E's last bits, and E moves by ~1e-3 where the
        kernel and its plain version, which take LN1's sums in another
        order, round one element of e_ln to neighbouring bf16 values."""
        lo, hi = spec.clip
        d = hh.float() - fl._edge_head(spec, e, w)[5]
        near = ((d - lo).abs() < 0.05) | ((d - hi).abs() < 0.05)
        return torch.where(near, hh.float() + 0.25, hh.float()).to(hh.dtype)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def ragged_mask(b, l, lo=9, hi=38):
        n = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev)
        return (torch.arange(l, device=dev)[None, :] < n[:, None]).float()

    results = {}

    def timed(tag, errs, kernel_fn, plain_fn, nbytes, mm, elementwise, dtype,
              timing=True):
        """Check the errors; with `timing`, time kernel and plain version
        and print them beside the bound."""
        err = max(x[0] for x in errs)
        check(all(x[1] for x in errs), f"{tag}: max |kernel - plain| {err:.3g}")
        if not timing:
            return None
        (ms, n), (plain, n_plain) = time_ms(kernel_fn), time_ms(plain_fn)
        bnd, by = bound_ms(nbytes, mm, elementwise, dtype)
        reps = "" if n == n_plain == 30 else \
            f" (medians of {n} and {n_plain} launches)"
        print(f"  {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bnd:.4f} ms ({by}); {mm / 1e9:.3f} GFLOP in products, "
              f"{nbytes / 1e6:.1f} MB{reps}", flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by)

    # ---- 3a. attention kernels (K1 forward, K2 backward)
    def attention_case(b, h, l, d, dtype, gated=True, hard=False,
                       training=False, timing=True, qk_scale=2.0, grid=True,
                       nodes=(9, 38), rerun=False, drops=(0.1, 0.1),
                       lq=None):
        # q and k scaled so that the clip binds on a share of pairs; with
        # `grid`, on a 1/8 grid: q.k is then exact in f32 in any summation
        # order, and K2's inclusive clip test on the recomputed raw logit
        # falls alike in kernel and plain version at the clip's edges.
        # Without it, general values: K2's test may fall otherwise on a
        # pair whose raw logit lies within a few ulps of an edge, and such
        # pairs are left out of K2's comparison with their rows' dq and
        # their columns' dk. `lq` < l: a row block of lq queries against
        # all l keys (edge partitioning)
        lq = l if lq is None else lq
        if grid:
            q, k = (torch.round(randn(b, h, n, d, scale=8 * qk_scale)) / 8
                    for n in (lq, l))
        else:
            q, k = (randn(b, h, n, d, scale=qk_scale) for n in (lq, l))
        q, k, v = q.to(dtype), k.to(dtype), randn(b, h, l, d).to(dtype)
        e = randn(b, h, lq, l).to(dtype)
        g = randn(b, h, lq, l).to(dtype) if gated else None
        madd = (ragged_mask(b, l, lo=min(nodes[0], l), hi=min(nodes[1], l))
                - 1.0) * 1e9
        maddf = ((torch.rand((b, lq, l), generator=gen, device=dev) < 0.6)
                 .float() - 1.0) * 1e9 if hard else None
        # the random mask's and dropout's rates in training mode
        draws = att.Draws(123, *drops) if training else att.OFF
        args = (q, k, v, e, g, madd, maddf, (-5.0, 5.0), draws)
        out = att._egt_core_fwd_cuda(*args)
        ref = att.egt_core_fwd_plain(*args)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype) for o, r in zip(out, ref)
                if r is not None]
        raw = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * d ** -0.5
        binds = float((raw.abs() > 5.0).float().mean())
        shape = (f"b{b} h{h} {f'lq{lq} lk' if lq != l else 'l'}{l} d{d} "
                 f"{str(dtype)[6:]}" +
                 (" hard-mask" if hard else "") + ("" if gated else " ungated")
                 + ("" if grid else " general q, k")
                 + f" clip binds {binds:.2f}")

        def body(geo):
            return " [tensor cores]" if geo["tensor_cores"] else \
                " [CUDA cores]"
        it = q.element_size()
        pairs = b * h * lq * l
        # q, k, v, e (and g) read; v_att, h_hat (and the degrees) written
        nbytes = (b * h * (lq + 2 * l) * d + (2 if gated else 1) * pairs
                  + b * h * lq * d + pairs) * it + b * l * 4 + \
            (b * h * lq * 4 if gated else 0) + (b * lq * l * 4 if hard else 0)
        res = {"fwd": timed(
            f"attention_fwd{' training' if training else ''} {shape}"
            + body(att.fwd_geometry(dtype, lq, l, d)), errs,
            lambda: att._egt_core_fwd_cuda(*args),
            lambda: att.egt_core_fwd_plain(*args), nbytes, 4 * pairs * d,
            15 * pairs, dtype, timing)}
        if not training:
            return res
        # K2 from the forward's h_hat, with the cotangents of v_att, h_hat
        # and (gated) the degrees
        h_hat = ref[1]
        gv, gh = randn(b, h, lq, d).to(dtype), randn(b, h, lq, l).to(dtype)
        gdeg = randn(b, h, lq) if gated else None
        bargs = (q, k, v, g, madd, maddf, h_hat, gv, gh, gdeg, (-5.0, 5.0),
                 draws)
        out = att._egt_core_bwd_cuda(*bargs)
        ref = att.egt_core_bwd_plain(*bargs)
        torch.cuda.synchronize()
        if rerun:
            again = att._egt_core_bwd_cuda(*bargs)
            check(torch.equal(out[1], again[1]) and
                  torch.equal(out[2], again[2]),
                  f"attention_bwd {shape}: dk and dv bit-identical across "
                  "two launches")
        if not grid:
            # the pairs within 16 f32 ulps of a clip edge: their row's dq
            # and their column's dk take the plain version's values
            ulp = 16 * float(np.spacing(np.float32(5.0)))
            near = ((raw - 5.0).abs() <= ulp) | ((raw + 5.0).abs() <= ulp)
            rows, cols = near.any(-1, keepdim=True), near.any(-2)[..., None]
            out = (torch.where(rows, ref[0], out[0]),
                   torch.where(cols, ref[1], out[1]), *out[2:])
            n_near = int(near.sum())
            check(n_near <= 1e-4 * near.numel(),
                  f"attention_bwd {shape}: {n_near} of {near.numel()} pairs "
                  f"within 16 ulps of a clip edge left out ({int(rows.sum())} "
                  f"dq rows, {int(cols.sum())} dk rows)")
        # dk, dv (indices 1, 2) are sums over query rows: scaled absolute
        # part; dq, de and dg are per-element values
        errs = [max_err(o, r, dtype, scaled=i in (1, 2))
                for i, (o, r) in enumerate(zip(out, ref)) if r is not None]
        # q, k, v, gv, h_hat, gh (and g, gdeg) read; dq, de (and dg), and
        # dk, dv in f32 written
        nbytes = (b * h * (2 * lq + 2 * l) * d + (3 if gated else 2) * pairs
                  + b * h * lq * d + (2 if gated else 1) * pairs) * it + \
            2 * b * h * l * d * 4 + b * l * 4 + \
            (b * h * lq * 4 if gated else 0) + (b * lq * l * 4 if hard else 0)
        res["bwd"] = timed(f"attention_bwd {shape}"
                           + body(att.bwd_geometry(dtype, lq, l, d)), errs,
                           lambda: att._egt_core_bwd_cuda(*bargs),
                           lambda: att.egt_core_bwd_plain(*bargs), nbytes,
                           10 * pairs * d, 30 * pairs, dtype, timing)
        return res

    # ---- 3b. whole-layer kernels (K3 forward, K4 and K5 backward)
    def layer_case(b, l, ew, h, dh, dtype, constrained=False, training=False,
                   timing=True, nodes=(9, 38), alternatives=True):
        """K3 (and in training K4, K5 and, with `alternatives`, K6's head,
        K7 and K6) against their plain versions; graphs of nodes[0] to
        nodes[1] nodes."""
        hid = 2 * ew
        spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=hid, gated=True,
                            constrained=constrained, clip=(-5.0, 5.0),
                            edge_act=None, act="elu",
                            scale=float(dh // h) ** -0.5,
                            random_mask_prob=0.1, attn_dropout=0.1,
                            training=training)

        def dense(i, o):
            lim = (6.0 / (i + o)) ** 0.5
            return {"kernel": (torch.rand((i, o), generator=gen, device=dev)
                               * 2 - 1) * lim, "bias": randn(o, scale=0.1)}

        def ln(n):
            return {"gamma": 1 + randn(n, scale=0.1), "beta": randn(n, scale=0.1)}

        p = {"attention_gates": dense(ew, h), "dense_edge_b": dense(ew, h),
             "norm_edge": ln(ew), "dense_edge_r": dense(h, ew),
             "edge_ffn": {"norm": ln(ew), "lr1": dense(ew, hid),
                          "lr2": dense(hid, ew)}}
        w = fl.layer_weights(p, dtype)
        e = randn(b, l, l, ew).to(dtype)
        qkv = randn(b, l, 3 * dh).to(dtype)
        mask = ragged_mask(b, l, lo=min(nodes[0], l), hi=min(nodes[1], l))
        am = ((torch.rand((b, l, l), generator=gen, device=dev) < 0.3)
              .float() if constrained else None)
        args = (spec, e, qkv, mask, am, w, 77, training)
        out = fl._fused_layer_cuda(*args)
        ref = fl.fused_layer_plain(*args)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype) for o, r in zip(out, ref)]
        shape = (f"b{b} l{l} ew{ew} h{h} dh{dh} {str(dtype)[6:]}"
                 + (" constrained" if constrained else ""))
        it = e.element_size()
        pairs = b * l * l
        wbytes = (2 * ew * h + h * ew + 2 * ew * hid) * it
        nbytes = (2 * pairs * ew + b * l * 3 * dh + b * l * dh) * it + \
            wbytes + b * l * 4 + (pairs * 4 if constrained else 0) + \
            (pairs * h * it if training else 0)
        mm = pairs * (2 * ew * 2 * h + 2 * dh + 2 * dh + 2 * h * ew
                      + 2 * 2 * ew * hid)
        res = {"fwd": timed(
            f"fused_layer_fwd{' training' if training else ''} {shape}", errs,
            lambda: fl._fused_layer_cuda(*args),
            lambda: fl.fused_layer_plain(*args), nbytes, mm,
            pairs * (20 * ew + hid + 15 * h), dtype, timing)}
        if not training:
            return res
        # K4 and K5 from an h_hat drawn on its own (3 sigma): many pairs lie
        # beyond the clip, none at its edge. (A forward's own h_hat puts
        # every clipped pair at hh - E = lo or hi up to an ulp, where the
        # strict in-range test of K5 follows the last bit of E, which the
        # kernel and its plain version sum in another order.)
        hh = off_clip(spec, e, w, randn(b, l, l, h, scale=3.0).to(dtype))
        ge, gv = randn(b, l, l, ew).to(dtype), randn(b, l, dh).to(dtype)
        targs = (spec, e, hh, ge, w)
        out = fl._bwd_tail_cuda(*targs)
        tref = fl.fused_layer_bwd_tail_plain(*targs)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype) for o, r in zip(out[:2], tref[:2])]
        errs += [max_err(out[2][k], r, dtype, scaled=True)
                 for k, r in tref[2].items()]
        rerun = fl._bwd_tail_cuda(*targs)
        check(all(torch.equal(out[2][k], rerun[2][k]) for k in out[2]),
              f"fused_layer_bwd_tail {shape}: weight gradients bit-identical "
              "across two launches")
        nw = h * ew + 3 * ew + 2 * ew * hid + hid + ew
        nbytes = (3 * pairs * ew + 2 * pairs * h) * it + \
            (h * ew + 2 * ew * hid) * it + (4 * ew + hid) * 4 + nw * 4
        mm = pairs * 2 * (3 * h * ew + 5 * ew * hid)
        res["tail"] = timed(f"fused_layer_bwd_tail {shape}", errs,
                            lambda: fl._bwd_tail_cuda(*targs),
                            lambda: fl.fused_layer_bwd_tail_plain(*targs),
                            nbytes, mm, pairs * (30 * ew + 5 * hid), dtype,
                            timing)
        # K5 from h_hat, K4's outputs and a cotangent of v_att
        de_mid, dhh = tref[0], tref[1]
        aargs = (spec, e, qkv, mask, am, w, hh, dhh, de_mid, gv, 77)
        out = fl._bwd_attn_cuda(*aargs)
        aref = fl.fused_layer_bwd_attn_plain(*aargs)
        torch.cuda.synchronize()
        # de, dq per element; dk, dv sums over query rows (scaled)
        errs = [max_err(o, r, dtype, scaled=i >= 2)
                for i, (o, r) in enumerate(zip(out[:4], aref[:4]))]
        errs += [max_err(out[4][k], r, dtype, scaled=True)
                 for k, r in aref[4].items()]
        check_attn_rerun(f"fused_layer_bwd_attn {shape}", out, aargs)
        if dtype == torch.bfloat16:
            g = fl.bwd_attn_geometry(spec)
            print(f"  fused_layer_bwd_attn {shape}: "
                  f"{'general' if g['general'] else 'register'} body, "
                  f"{g['warps']} warps x {g['cluster']} blocks a graph, "
                  f"{g['rows_per_block']} rows a block, {g['smem']} B, "
                  f"kv_global {g['kv_global']}", flush=True)
        nproj = 2 * h
        nbytes = (3 * pairs * ew + 2 * pairs * h + b * l * 3 * dh
                  + 2 * b * l * dh + 2 * ew * h) * it + \
            (2 * b * l * dh + ew * nproj + nproj + 2 * ew) * 4 + b * l * 4 + \
            (pairs * 4 if constrained else 0)
        mm = pairs * (6 * ew * nproj + 8 * dh)
        res["attn"] = timed(f"fused_layer_bwd_attn {shape}", errs,
                            lambda: fl._bwd_attn_cuda(*aargs),
                            lambda: fl.fused_layer_bwd_attn_plain(*aargs),
                            nbytes, mm, pairs * (20 * ew + 40 * h), dtype,
                            timing)
        if not alternatives:
            return res
        # K6's head kernel alone: h_hat recomputed, the clip's flags equal
        # to the plain version's (random q, k: no raw logit within an ulp
        # of the clip)
        hargs = (spec, e, qkv, w)
        out, ref = fl._mono_head_cuda(*hargs), fl.mono_head_plain(*hargs)
        torch.cuda.synchronize()
        check(torch.equal(out[2], ref[2]),
              f"mono_head {shape}: in-range flags equal the plain "
              f"version's ({int(ref[2].sum())} of {ref[2].numel()} in range)")
        res["mono_head"] = timed(
            f"mono_head {shape}", [max_err(o, r, dtype)
                                   for o, r in zip(out[:2], ref[:2])],
            lambda: fl._mono_head_cuda(*hargs),
            lambda: fl.mono_head_plain(*hargs),
            (pairs * ew + b * l * 2 * dh + ew * h) * it + (h + 2 * ew) * 4
            + pairs * h * (4 + (it if it == 2 else 0) + 1),
            pairs * (2 * ew * h + 2 * dh), pairs * (10 * ew + 10 * h), dtype,
            timing)
        # K7 from the same h_hat and cotangents; K6 recomputes h_hat from
        # q.k (random q, k: no raw logit within an ulp of the clip)
        bytes_k6 = (3 * pairs * ew + b * l * 3 * dh + 2 * b * l * dh) * it + \
            (h * ew + 2 * ew * hid + 2 * ew * h) * it + \
            (2 * b * l * dh + nw + ew * nproj + nproj + 2 * ew) * 4 + \
            b * l * 4 + (pairs * 4 if constrained else 0)
        mm_k6 = pairs * 2 * (3 * h * ew + 5 * ew * hid) + \
            pairs * (6 * ew * nproj + 8 * dh)
        for key, name, kfn, pfn, rargs, nbytes, mm in (
                ("merged", "fused_layer_bwd_merged", fl._bwd_merged_cuda,
                 fl.fused_layer_bwd_merged_plain,
                 (spec, e, qkv, mask, am, w, hh, ge, gv, 77),
                 bytes_k6 + pairs * h * it, mm_k6),
                ("mono", "fused_layer_bwd_mono", fl._bwd_mono_cuda,
                 fl.fused_layer_bwd_mono_plain,
                 (spec, e, qkv, mask, am, w, ge, gv, 77), bytes_k6,
                 mm_k6 + pairs * 2 * dh)):
            out, ref = kfn(*rargs), pfn(*rargs)
            torch.cuda.synchronize()
            errs = [max_err(o, r, dtype, scaled=i >= 2)
                    for i, (o, r) in enumerate(zip(out[:4], ref[:4]))]
            errs += [max_err(out[4][k], r, dtype, scaled=True)
                     for k, r in ref[4].items()]
            check(same_bwd(out, kfn(*rargs)),
                  f"{name} {shape}: every output bit-identical across two "
                  "launches")
            if dtype == torch.float32:
                # K7: K4 then K5; K6: its head kernel, K4 from the head's
                # h_hat, then K5 under the mono switch
                hh_, flags = (hh, None) if key == "merged" else \
                    fl._mono_head_cuda(spec, e, qkv, w)[::2]
                t4 = fl._bwd_tail_cuda(spec, e, hh_, ge, w)
                s5 = fl._bwd_attn_cuda(spec, e, qkv, mask, am, w, hh_, t4[1],
                                       t4[0], gv, 77, inrange=flags)
                check(same_bwd(out, (*s5[:4], {**t4[2], **s5[4]})),
                      f"{name} {shape}: equals " + (
                          "K4 then K5" if key == "merged" else
                          "its head kernel, K4, then K5 under the mono "
                          "switch") + " bit for bit")
            res[key] = timed(f"{name} {shape}", errs,
                             lambda: kfn(*rargs), lambda: pfn(*rargs),
                             nbytes, mm, pairs * (50 * ew + 5 * hid + 40 * h),
                             dtype, timing)
        return res

    def same_bwd(a, b):
        """(de, dq, dk, dv, dw) a and b equal bit for bit."""
        return (all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
                and sorted(a[4]) == sorted(b[4])
                and all(torch.equal(a[4][k], b[4][k]) for k in a[4]))

    def check_attn_rerun(tag, out, aargs):
        rerun = fl._bwd_attn_cuda(*aargs)
        check(torch.equal(out[2], rerun[2]) and torch.equal(out[3], rerun[3])
              and all(torch.equal(out[4][k], rerun[4][k]) for k in out[4]),
              f"{tag}: dk, dv and the weight gradients bit-identical across "
              "two launches")

    def attn_bwd_case(b, l, ew, h, dh, dtype, gated, constrained):
        """K5 alone against its plain version (draws live, edge
        activation elu), and its sums across two launches."""
        spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=2 * ew,
                            gated=gated, constrained=constrained,
                            clip=(-5.0, 5.0), edge_act="elu", act="elu",
                            scale=float(dh // h) ** -0.5,
                            random_mask_prob=0.1, attn_dropout=0.1,
                            training=True)
        lim = (6.0 / (ew + h)) ** 0.5
        w = dict(wb=(randn(ew, h) * lim).to(dtype), bb=randn(h, scale=0.1),
                 g1=1 + randn(ew, scale=0.1), b1=randn(ew, scale=0.1),
                 wg=(randn(ew, h) * lim).to(dtype) if gated else None,
                 bg=randn(h, scale=0.1) if gated else None)
        mask = ragged_mask(b, l, lo=1, hi=l)
        am = ((torch.rand((b, l, l), generator=gen, device=dev) < 0.3)
              .float() if constrained else None)
        e = randn(b, l, l, ew).to(dtype)
        aargs = (spec, e, randn(b, l, 3 * dh).to(dtype), mask, am, w,
                 off_clip(spec, e, w, randn(b, l, l, h, scale=3.0).to(dtype)),
                 randn(b, l, l, h).to(dtype), randn(b, l, l, ew).to(dtype),
                 randn(b, l, dh).to(dtype), 77)
        out = fl._bwd_attn_cuda(*aargs)
        ref = fl.fused_layer_bwd_attn_plain(*aargs)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype, scaled=i >= 2)
                for i, (o, r) in enumerate(zip(out[:4], ref[:4]))]
        errs += [max_err(out[4][k], r, dtype, scaled=True)
                 for k, r in ref[4].items()]
        tag = (f"fused_layer_bwd_attn b{b} l{l} ew{ew} h{h} dh{dh} "
               f"{str(dtype)[6:]}{'' if gated else ' ungated'}"
               f"{' constrained' if constrained else ''}")
        if dtype == torch.bfloat16:
            g = fl.bwd_attn_geometry(spec)
            tag += (f" ({'general' if g['general'] else 'register'} body, "
                    f"{g['warps']} warps x {g['cluster']} blocks)")
        check(all(x[1] for x in errs),
              f"{tag}: max |kernel - plain| {max(x[0] for x in errs):.3g}")
        check_attn_rerun(tag, out, aargs)

    # ---- 3c. edge block (K8 forward, K9 backward)
    def edge_case(b, l, ew, h, dtype, head_major, timing=True, hid=None,
                  bwd=True):
        hid = hid or 2 * ew
        w = dict(wr=randn(h, ew, scale=0.3).to(dtype), br=randn(ew, scale=0.1),
                 g2=1 + randn(ew, scale=0.1), b2=randn(ew, scale=0.1),
                 w1=randn(ew, hid, scale=0.2).to(dtype),
                 bb1=randn(hid, scale=0.1),
                 w2=randn(hid, ew, scale=0.2).to(dtype),
                 bb2=randn(ew, scale=0.1))
        # path C hands K8 the attention kernel's head-major h_hat
        hh = randn(b, h, l, l, scale=2.0).to(dtype).permute(0, 2, 3, 1)
        if not head_major:
            hh = hh.contiguous()
        e, g = randn(b, l, l, ew).to(dtype), randn(b, l, l, ew).to(dtype)
        shape = (f"n{b * l * l} ew{ew} h{h} hidden{hid} {str(dtype)[6:]} "
                 + ("head-major" if head_major else "rows"))
        it = e.element_size()
        n = b * l * l
        wbytes = (h * ew + 2 * ew * hid) * it + (4 * ew + hid) * 4
        geo = eb.fwd_geometry(dtype, ew, h, hid, head_major)
        body = (f"{'tensor-core' if geo['tensor_cores'] else 'CUDA-core'} "
                f"body, {geo['warps']} warps, {geo['smem']} B")
        out = eb._edge_block_fwd_cuda(hh, e, w)
        ref = eb.edge_block_fwd_plain(hh, e, w)
        torch.cuda.synchronize()
        if geo["tensor_cores"]:
            check(torch.equal(out, eb._edge_block_fwd_cuda(hh, e, w)),
                  f"edge_block_fwd {shape} ({body}): output bit-identical "
                  "across two launches")
        res = {"fwd": timed(
            f"edge_block_fwd {shape} ({body})", [max_err(out, ref, dtype)],
            lambda: eb._edge_block_fwd_cuda(hh, e, w),
            lambda: eb.edge_block_fwd_plain(hh, e, w),
            n * (h + 2 * ew) * it + wbytes,
            n * 2 * (h * ew + 2 * ew * hid), n * (12 * ew + 2 * hid), dtype,
            timing)}
        if not bwd:
            return res
        out = eb._edge_block_bwd_cuda(hh, e, g, w)
        ref = eb.edge_block_bwd_plain(hh, e, g, w)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype) for o, r in zip(out[:2], ref[:2])]
        errs += [max_err(out[2][k], r, dtype, scaled=True)
                 for k, r in ref[2].items()]
        check(out[0].stride() == hh.stride(),
              f"edge_block_bwd {shape}: dhh in h_hat's layout")
        rerun = eb._edge_block_bwd_cuda(hh, e, g, w)
        check(all(torch.equal(out[2][k], rerun[2][k]) for k in out[2]),
              f"edge_block_bwd {shape}: weight gradients bit-identical "
              "across two launches")
        nw = h * ew + 3 * ew + 2 * ew * hid + hid + ew
        res["bwd"] = timed(
            f"edge_block_bwd {shape}", errs,
            lambda: eb._edge_block_bwd_cuda(hh, e, g, w),
            lambda: eb.edge_block_bwd_plain(hh, e, g, w),
            n * (2 * h + 3 * ew) * it + wbytes + nw * 4,
            n * 2 * (3 * h * ew + 5 * ew * hid), n * (30 * ew + 5 * hid),
            dtype, timing)
        return res

    try:
        for dtype in (torch.float32, torch.bfloat16):
            for training in (False, True):
                results[("attention", dtype, training)] = attention_case(
                    GRAPHS, 8, PAD, 8, dtype, training=training)
                results[("layer", dtype, training)] = layer_case(
                    GRAPHS, PAD, 64, 8, 64, dtype, training=training)
            results[("edge", dtype)] = edge_case(GRAPHS, PAD, 64, 8, dtype,
                                                 head_major=True)
            edge_case(GRAPHS, PAD, 64, 8, dtype, head_major=False)
            edge_case(5, 7, 32, 4, dtype, head_major=False, timing=False)
            if dtype == torch.bfloat16:
                # the f32 CUDA-core body's weights pass 227 KB at these
                # widths, as do K9's weight-gradient sums in bf16
                edge_case(3, 11, 128, 16, dtype, head_major=True,
                          timing=False, hid=256, bwd=False)
                edge_case(2, 6, 160, 8, dtype, head_major=False,
                          timing=False, hid=160, bwd=False)
            # the other shipped edge widths (ZINC-100k: 48, hidden 96;
            # PATTERN, CLUSTER, MNIST, CIFAR10, TSP: 8, hidden 16) with 8
            # heads, over 5 * 37 * 37 = 6845 pairs: no multiple of K4's and
            # K9's 128-pair tile in bf16, nor of 32 in f32
            for ew, dh in ((8, 64), (48, 48)):
                layer_case(5, 37, ew, 8, dh, dtype, training=True,
                           timing=False)
                edge_case(5, 37, ew, 8, dtype, head_major=True, timing=False)
            # K5 alone: ragged l at the flagship batch, ew 8 / 48 / 80,
            # gated and ungated, constrained; l 150 loops rows in a warp;
            # then shapes of its general body (2h past 16, h 64 two heads a
            # lane, h 6 no divisor of 32, ew 136 three edge chunks, odd dh,
            # one warp a block at h 64, ew 96, l 4)
            for b, l, ew, h, dh, gated, constrained in (
                    (GRAPHS, 41, 8, 8, 64, True, False),
                    (GRAPHS, 41, 48, 8, 48, False, True),
                    (GRAPHS, 9, 48, 8, 48, True, True),
                    (GRAPHS, 41, 80, 8, 64, True, True),
                    (16, 150, 8, 8, 64, False, False),
                    (16, 20, 64, 32, 64, True, False),
                    (16, 12, 16, 64, 64, False, True),
                    (16, 13, 24, 6, 18, True, True),
                    (16, 23, 136, 8, 64, True, False),
                    (16, 11, 10, 1, 7, False, False),
                    (16, 4, 96, 64, 64, True, True)):
                attn_bwd_case(b, l, ew, h, dh, dtype, gated, constrained)
            if dtype == torch.bfloat16:
                # K1 and K2 on general-valued q and k, through each body:
                # the tensor cores (d 8) and the CUDA cores (d 24)
                for d in (8, 24):
                    attention_case(16, 4, PAD, d, dtype, training=True,
                                   timing=False, grid=False)
            for training in (False, True):
                attention_case(16, 4, 37, 8, dtype, gated=False, hard=True,
                               training=training, timing=False)
                attention_case(16, 4, 37, 8, dtype, hard=True,
                               training=training, timing=False)
                layer_case(16, 37, 32, 4, 32, dtype, constrained=True,
                           training=training, timing=False)
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 3: kernels against their plain versions")

    # ---- 3d. the SBM shapes: K3, K4 and K5 at the full batch in both
    # length buckets (ew 8, hidden 16, 8 heads, width 64; each bucket's
    # graphs of its node range), and K1 and K2 at the SBM tile (h 8, lq =
    # lk = 192, d 8: path B's kernels at the shape the SBM schemes bring,
    # through the bodies their geometry queries name)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for l, nodes in SBM_BUCKETS.items():
                for training in (False, True):
                    results[("layer_sbm", l, dtype, training)] = layer_case(
                        GRAPHS, l, 8, 8, 64, dtype, training=training,
                        nodes=nodes, alternatives=False)
            results[("attention_sbm", dtype)] = attention_case(
                GRAPHS, 8, 192, 8, dtype, training=True,
                nodes=SBM_BUCKETS[192])
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 3d: the kernels at the SBM shapes")

    # ---- 3e. the superpixel pads: K3 (inference and training), K4 and K5
    # at 128 graphs, l 75 (MNIST: no multiple of 8, a partial last 16-row
    # tile) and l 150 (CIFAR10), ew 8, hidden 16, 8 heads, width 64, each
    # pad's graphs of its dataset's node range; the layouts that K5's and
    # K4's bf16 bodies take there
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for l, nodes in SP_PADS.items():
                for training in (False, True):
                    results[("layer_sp", l, dtype, training)] = layer_case(
                        GRAPHS, l, 8, 8, 64, dtype, training=training,
                        nodes=nodes, alternatives=False)
        for l in SP_PADS:
            spec = fl.LayerSpec(l=l, ew=8, h=8, dh=64, hidden=16, gated=True,
                                constrained=False, clip=(-5.0, 5.0),
                                edge_act=None, act="elu", scale=8 ** -0.5,
                                training=True)
            print(f"  superpixel l {l}: bwd_attn_geometry "
                  f"{fl.bwd_attn_geometry(spec)}, bwd_tail_geometry "
                  f"{fl.bwd_tail_geometry(spec, torch.bfloat16)}",
                  flush=True)
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 3e: the kernels at the superpixel pads")

    # ---- 3f. the TSP shapes: K3 (inference and training), K4 and K5 at the
    # TSP batch of 8 in the three length buckets (ew 8, hidden 16, 8 heads,
    # width 64; each bucket's graphs of its node range), timed beside their
    # bounds; K5 also ungated at l 512 (the `ungated` ablation); the layouts
    # of K5's and K4's bf16 bodies at each pad, K5's `kv_global` with one
    # block a graph asserted at l 256 and 512
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for l, nodes in TSP_BUCKETS.items():
                for training in (False, True):
                    results[("layer_tsp", l, dtype, training)] = layer_case(
                        TSP_BATCH, l, 8, 8, 64, dtype, training=training,
                        nodes=nodes, alternatives=False)
            attn_bwd_case(TSP_BATCH, 512, 8, 8, 64, dtype, gated=False,
                          constrained=False)
        for l in TSP_BUCKETS:
            for gated in (True, False):
                spec = fl.LayerSpec(l=l, ew=8, h=8, dh=64, hidden=16,
                                    gated=gated, constrained=False,
                                    clip=(-5.0, 5.0), edge_act=None,
                                    act="elu", scale=8 ** -0.5, training=True)
                g = fl.bwd_attn_geometry(spec)
                print(f"  TSP l {l}{'' if gated else ' ungated'}: "
                      f"bwd_attn_geometry {g}, bwd_tail_geometry "
                      f"{fl.bwd_tail_geometry(spec, torch.bfloat16)}",
                      flush=True)
                if l > 128:
                    check(g is not None and bool(g["kv_global"])
                          and g["cluster"] == 1,
                          f"TSP l {l}{'' if gated else ' ungated'}: K5's bf16 "
                          "body keeps k, v, dk and dv in device memory, one "
                          "block a graph")
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 3f: the kernels at the TSP shapes")

    # ---- 3g. the `egt_simple` shapes: K1 (inference and training) and K2
    # at the attention shapes of the `bias` channel's configs (8 heads; each
    # shape's graphs of its node range), gated, draws live, f32 and bf16,
    # each timed beside its bound; the bodies their geometry queries name
    # printed and asserted (the tensor cores at ZINC's d 10, the CUDA cores
    # past 64 keys, K2's 164,608 B block at l 512); K2's dk and dv
    # bit-identical across two launches at l 512; a general-valued bf16
    # case at l 512
    try:
        for fam, (b, l, d, nodes) in SIMPLE_SHAPES.items():
            geo = {dt: (att.fwd_geometry(dt, l, l, d),
                        att.bwd_geometry(dt, l, l, d))
                   for dt in (torch.float32, torch.bfloat16)}
            print(f"  egt_simple {fam} (b {b}, h 8, l {l}, d {d}): "
                  + "; ".join(f"{str(dt)[6:]} fwd_geometry {f}, bwd_geometry "
                              f"{g}" for dt, (f, g) in geo.items()),
                  flush=True)
            mma = fam == "ZINC"
            check(all(x["tensor_cores"] == mma
                      for x in geo[torch.bfloat16]),
                  f"egt_simple {fam}: K1 and K2 take their "
                  f"{'tensor-core' if mma else 'CUDA-core'} bodies in bf16")
            if l == 512:
                check(geo[torch.bfloat16][1]["smem"] == 164_608,
                      f"egt_simple {fam}: K2's CUDA-core block holds "
                      f"{geo[torch.bfloat16][1]['smem']} B of shared memory "
                      "(164,608 expected), one block a SM")
            for dtype in (torch.float32, torch.bfloat16):
                for training in (False, True):
                    results[("attention_simple", fam, dtype, training)] = \
                        attention_case(b, 8, l, d, dtype, training=training,
                                       nodes=nodes,
                                       rerun=training and l == 512)
        attention_case(TSP_BATCH, 8, 512, 8, torch.bfloat16, training=True,
                       timing=False, grid=False, nodes=TSP_BUCKETS[512])
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 3g: the attention kernels at the egt_simple "
              "shapes")

    # ---- 3h. the PCQM4Mv2 tile: K1 (inference and training) and K2 at
    # EGT-Large's attention shape, a micro-batch of 128 graphs, 32 heads of
    # 24 (the CUDA-core bodies, asserted: d 24 is past the tensor-core
    # bodies' 16), l 36 and l 60, gated with the degree output, the shipped
    # draws (attention dropout 0.3, no random mask), f32 and bf16, each held
    # to its plain version and timed beside its bound; K2's dk and dv
    # bit-identical across two launches at l 60
    try:
        for l, (nodes, _) in PCQM_PADS.items():
            geo = {dt: (att.fwd_geometry(dt, l, l, PCQM_D),
                        att.bwd_geometry(dt, l, l, PCQM_D))
                   for dt in (torch.float32, torch.bfloat16)}
            print(f"  pcqm4mv2 l {l} (b {PCQM_MICRO}, h {PCQM_HEADS}, d "
                  f"{PCQM_D}): " + "; ".join(
                      f"{str(dt)[6:]} fwd_geometry {f}, bwd_geometry {g}"
                      for dt, (f, g) in geo.items()), flush=True)
            check(all(x is not None and not x["tensor_cores"]
                      for pair in geo.values() for x in pair),
                  f"pcqm4mv2 l {l}: K1 and K2 take their CUDA-core bodies")
            for dtype in (torch.float32, torch.bfloat16):
                for training in (False, True):
                    results[("attention_pcqm", l, dtype, training)] = \
                        attention_case(PCQM_MICRO, PCQM_HEADS, l, PCQM_D,
                                       dtype, training=training, nodes=nodes,
                                       rerun=training and l == 60,
                                       drops=(0.0, PCQM_DROP))
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 3h: the attention kernels at the PCQM4Mv2 tile")

    # ---- 3i. the row blocks of edge partitioning (ROW_TILES): K1
    # (inference and training) and K2 on one of 2 shards' query rows
    # against every key, at the tiles the `edge_partition` 2 paths of
    # phases 4j / 5j hand them (ZINC lq 20 / lk 40: the tensor-core bodies
    # in bf16; TSP lq 256 / lk 512 and PCQM4Mv2 lq 4 + 16 / lk 36: the
    # CUDA-core bodies), the draws live, f32 and bf16, each held to its
    # plain version and timed beside its bound, the bodies their geometry
    # queries name asserted
    try:
        for fam, (b, h, lq, l, d, nodes, drops, mma) in ROW_TILES.items():
            geo = {dt: (att.fwd_geometry(dt, lq, l, d),
                        att.bwd_geometry(dt, lq, l, d))
                   for dt in (torch.float32, torch.bfloat16)}
            print(f"  row block {fam} (b {b}, h {h}, lq {lq}, lk {l}, d {d})"
                  ": " + "; ".join(f"{str(dt)[6:]} fwd_geometry {f}, "
                                   f"bwd_geometry {g}"
                                   for dt, (f, g) in geo.items()), flush=True)
            check(all(x is not None and x["tensor_cores"] == (
                mma and dt == torch.bfloat16)
                for dt, pair in geo.items() for x in pair),
                f"row block {fam}: K1 and K2 take their "
                f"{'tensor-core' if mma else 'CUDA-core'} bodies in bf16")
            for dtype in (torch.float32, torch.bfloat16):
                for training in (False, True):
                    results[("attention_rows", fam, dtype, training)] = \
                        attention_case(b, h, l, d, dtype, training=training,
                                       nodes=nodes, drops=drops, lq=lq)
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 3i: the attention kernels at the row blocks")

    # ---- 4. the serving paths
    raw = json.loads(CONFIG.read_text())
    # seeded weights under the JAX flat names: loading them exercises the
    # weight transfer
    flat = synthetic.random_flat_params(schemes.model_config_from_config(raw))
    rng = np.random.default_rng(0)
    requests = [synthetic.zinc_batch(rng, GRAPHS, PAD)
                for _ in range(N_REQUESTS)]
    plain_cfg = {**raw, "use_pallas": False, "use_pallas_layer": False}
    plain_bf16 = serving.load_predictor(plain_cfg, flat)
    ref_out = [plain_bf16(r) for r in requests]

    kernels = {"K1": att.KERNEL, "K2": att.BWD_KERNEL, "K3": fl.KERNEL,
               "K4": fl.BWD_TAIL_KERNEL, "K5": fl.BWD_ATTN_KERNEL,
               "K6": fl.BWD_MONO_KERNEL, "K7": fl.BWD_MERGED_KERNEL,
               "K8": eb.KERNEL, "K9": eb.BWD_KERNEL}

    def counted(run, want, what):
        """Run `run` with every count set to 0; check the launches against
        `want` ({kernel: launches}, the others 0) and return them."""
        for kern in kernels.values():
            kern.launches = 0
        out = run()
        launches = {k: kern.launches for k, kern in kernels.items()}
        full = {k: want.get(k, 0) for k in kernels}
        check(launches == full, f"{what}: launches {launches} "
              f"(expected {full})")
        return out, launches

    def serve(tag, overrides, on):
        """Serve N_REQUESTS requests; check launches (10 a request for each
        kernel in `on`), outputs and agreement with the plain path."""
        predict = serving.load_predictor(
            {**raw, **overrides} if overrides else str(CONFIG), flat)
        predict(requests[0])                       # warm-up
        torch.cuda.synchronize()

        def run():
            lat, outs = [], []
            for r in requests:
                t = time.perf_counter()
                outs.append(predict(r))            # returns host numpy: synced
                lat.append(time.perf_counter() - t)
            return lat, outs

        (lat, outs), _ = counted(run, {k: 10 * N_REQUESTS for k in on},
                                 f"{tag}, {N_REQUESTS} requests")
        ok_shape = all(o.shape == (GRAPHS, 1) and np.isfinite(o).all()
                       for o in outs)
        check(ok_shape, f"{tag}: outputs finite, shape ({GRAPHS}, 1)")
        diff = max(float(np.abs(o - r).max()) for o, r in zip(outs, ref_out))
        check(diff <= MODEL_TOL["bfloat16"],
              f"{tag}: bf16 max |kernel path - plain path| {diff:.4g} "
              f"(tol {MODEL_TOL['bfloat16']}, |plain| max "
              f"{max(float(np.abs(r).max()) for r in ref_out):.3g})")
        # f32 run of the same weights: only the summation order differs
        f32 = serving.load_predictor({**raw, **overrides,
                                      "compute_dtype": "float32"}, flat)
        pf32 = serving.load_predictor({**plain_cfg,
                                       "compute_dtype": "float32"}, flat)
        d32 = float(np.abs(f32(requests[1]) - pf32(requests[1])).max())
        check(d32 <= MODEL_TOL["float32"],
              f"{tag}: f32 max |kernel path - plain path| {d32:.4g} "
              f"(tol {MODEL_TOL['float32']})")
        med = statistics.median(lat)
        print(f"  {tag}: request latency ms {[round(x * 1e3, 3) for x in lat]}"
              f", median {med * 1e3:.3f} ms, {GRAPHS / med:.1f} graphs/s "
              f"(batch {GRAPHS}, 10 layers, bf16)", flush=True)

    path_b = {"use_pallas": True, "use_pallas_layer": False}
    path_c = {**path_b, "use_pallas_edge": True}
    try:
        serve("serving path A (whole-layer kernel)", {}, ("K3",))
        serve("serving path B (attention kernel)", path_b, ("K1",))
        serve("serving path C (attention kernel, edge block)", path_c,
              ("K1", "K8"))
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 4: serving paths")

    # ---- 4b. SBM serving: PATTERN's node readout through K3 in both length
    # buckets, against the model's plain path on the valid nodes
    sbm_raw = {k: json.loads(p.read_text()) for k, p in SBM_CONFIGS.items()}
    sbm_flat = {k: synthetic.random_flat_params(
        schemes.model_config_from_config(r), seed=1)
        for k, r in sbm_raw.items()}

    def sbm_requests(kind, l, n, seed):
        lo = SBM_BUCKETS[l][0]
        srng = np.random.default_rng(seed)
        return [synthetic.sbm_batch(srng, GRAPHS, l, kind, above=lo - 1)
                for _ in range(n)]

    def valid_nodes(q):
        return q["node_features"] >= 0

    def valid_pairs(q):
        return q["feature_matrix"][..., 0] >= 0

    def valid_diff(outs, refs, reqs, valid, rtol=0.0):
        """max over the valid nodes or pairs (`valid(request)`) of the
        requests of |a - b| - rtol |b|."""
        return max(float((np.abs(o - r) - rtol * np.abs(r))[valid(q)].max())
                   for o, r, q in zip(outs, refs, reqs))

    def serve_buckets(kind, raw_k, flat_k, buckets, requests_of, valid, what,
                      kernel="K3", path="path A", out_shape=None, rtol=None,
                      drift_ratio=None):
        """Serve the config as shipped on the requests `requests_of(l)` in
        each length bucket: `kernel`'s launches, one a layer a request (K3
        on path A), and no other kernel's; finite logits of the targets'
        shape (`out_shape`: a graph readout's); agreement with the plain
        path on the valid nodes or pairs (`what`), in bf16 each within the
        kernels' tolerance, atol + rtol |plain| (`rtol` 0: ZINC's absolute
        one), or, with `drift_ratio`, the bf16 kernel path at most that
        many times as far from the f32 plain path as the bf16 plain path
        (a model whose bf16 rounding alone moves its outputs past the
        kernels' tolerance)."""
        layers, classes = raw_k["model_height"], \
            schemes.model_config_from_config(raw_k).num_targets
        plain_k = {**raw_k, "use_pallas": False, "use_pallas_layer": False}
        predict = serving.load_predictor(raw_k, flat_k)
        plain = serving.load_predictor(plain_k, flat_k)
        f32 = serving.load_predictor({**raw_k, "compute_dtype": "float32"},
                                     flat_k)
        pf32 = serving.load_predictor({**plain_k, "compute_dtype": "float32"},
                                      flat_k)
        atol = TOL["bfloat16"][0]
        rtol = TOL["bfloat16"][1] if rtol is None else rtol
        for l in buckets:
            reqs = requests_of(l)
            predict(reqs[0])                       # warm-up
            torch.cuda.synchronize()

            def run():
                lat, outs = [], []
                for r in reqs:
                    t = time.perf_counter()
                    outs.append(predict(r))
                    lat.append(time.perf_counter() - t)
                return lat, outs

            tag = f"{kind} serving {path}, l {l}"
            (lat, outs), _ = counted(run, {kernel: layers * len(reqs)},
                                     f"{tag}, {len(reqs)} requests")
            shape = out_shape or reqs[0]["target"].shape + (classes,)
            check(all(o.shape == shape and np.isfinite(o).all()
                      for o in outs), f"{tag}: outputs finite, shape {shape}")
            refs = [plain(r) for r in reqs]
            # a logit a node or pair, not a mean over a graph's nodes as
            # ZINC's prediction, through 16 layers: bf16 is held element by
            # element to the kernels' bf16 tolerance, atol + rtol |plain|
            # (the plain path rounds the gates, the edge bias and h_hat to
            # bf16 where the kernels keep f32); f32 as ZINC's predictions
            diff = valid_diff(outs, refs, reqs, valid)
            excess = valid_diff(outs, refs, reqs, valid, rtol)
            big = max(float(np.abs(r).max()) for r in refs)
            if drift_ratio is None:
                check(excess <= atol,
                      f"{tag}: bf16 max |kernel path - plain path| on the "
                      f"valid {what} {diff:.4g}, every logit within {atol} + "
                      f"{rtol} |plain| (|plain| max {big:.3g})")
            else:
                refs32 = [pf32(r) for r in reqs]
                dk = valid_diff(outs, refs32, reqs, valid)
                dp = valid_diff(refs, refs32, reqs, valid)
                check(dk <= drift_ratio * dp,
                      f"{tag}: bf16 max distance from the f32 plain path on "
                      f"the valid {what}: kernel path {dk:.4g}, plain path "
                      f"{dp:.4g} (at most {drift_ratio}x); max |kernel path "
                      f"- plain path| {diff:.4g} (|plain| max {big:.3g})")
            ref32 = pf32(reqs[1])
            d32 = valid_diff([f32(reqs[1])], [ref32], reqs[1:], valid)
            check(d32 <= MODEL_TOL["float32"],
                  f"{tag}: f32 max |kernel path - plain path| on the valid "
                  f"{what} {d32:.4g} (tol {MODEL_TOL['float32']})")
            print(f"  {tag}: bf16 distance from the f32 plain path on the "
                  f"valid {what}: kernel path "
                  f"{valid_diff([outs[1]], [ref32], reqs[1:], valid):.4g}, "
                  f"plain path "
                  f"{valid_diff([refs[1]], [ref32], reqs[1:], valid):.4g}",
                  flush=True)
            med = statistics.median(lat)
            graphs = shape[0]
            print(f"  {tag}: request latency ms "
                  f"{[round(x * 1e3, 3) for x in lat]}, median "
                  f"{med * 1e3:.3f} ms, {graphs / med:.1f} graphs/s (batch "
                  f"{graphs}, {layers} layers, bf16) [{smi}]", flush=True)

    try:
        serve_buckets("pattern", sbm_raw["pattern"], sbm_flat["pattern"],
                      SBM_BUCKETS,
                      lambda l: sbm_requests("pattern", l, 2, seed=l),
                      valid_nodes, "nodes")
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 4b: SBM serving")

    # ---- 4c. superpixel serving: MNIST and CIFAR10 `egt_spe_do` at full
    # width and depth on path A (dense node and edge inputs, the SVD PE),
    # N_REQUESTS requests of 128 synthetic superpixel graphs, their (b, 10)
    # class logits against the model's plain path: bf16 each within 5e-2 +
    # 2e-2 |plain| (a logit a graph through 4 layers, held as the kernels'
    # bf16 outputs), f32 5e-4
    sp_raw = {k: json.loads(p.read_text()) for k, p in SP_CONFIGS.items()}
    sp_flat = {k: synthetic.random_flat_params(
        schemes.model_config_from_config(r), seed=2)
        for k, r in sp_raw.items()}

    def sp_requests(kind, n, seed):
        srng = np.random.default_rng(seed)
        return [synthetic.superpixel_batch(srng, GRAPHS, kind)
                for _ in range(n)]

    def serve_sp(kind):
        raw_k, flat_k = sp_raw[kind], sp_flat[kind]
        layers = raw_k["model_height"]
        plain_k = {**raw_k, "use_pallas": False, "use_pallas_layer": False}
        predict = serving.load_predictor(raw_k, flat_k)
        plain = serving.load_predictor(plain_k, flat_k)
        reqs = sp_requests(kind, N_REQUESTS, seed=20)
        predict(reqs[0])                           # warm-up
        torch.cuda.synchronize()

        def run():
            lat, outs = [], []
            for r in reqs:
                t = time.perf_counter()
                outs.append(predict(r))
                lat.append(time.perf_counter() - t)
            return lat, outs

        l = reqs[0]["graph_matrix"].shape[1]
        tag = f"{kind} serving path A, l {l}"
        (lat, outs), _ = counted(run, {"K3": layers * len(reqs)},
                                 f"{tag}, {len(reqs)} requests")
        check(all(o.shape == (GRAPHS, 10) and np.isfinite(o).all()
                  for o in outs), f"{tag}: outputs finite, shape "
              f"({GRAPHS}, 10)")
        refs = [plain(r) for r in reqs]
        atol, rtol = TOL["bfloat16"]
        diff = max(float(np.abs(o - r).max()) for o, r in zip(outs, refs))
        excess = max(float((np.abs(o - r) - rtol * np.abs(r)).max())
                     for o, r in zip(outs, refs))
        check(excess <= atol,
              f"{tag}: bf16 max |kernel path - plain path| {diff:.4g}, every "
              f"logit within {atol} + {rtol} |plain| (|plain| max "
              f"{max(float(np.abs(r).max()) for r in refs):.3g})")
        f32 = serving.load_predictor({**raw_k, "compute_dtype": "float32"},
                                     flat_k)
        pf32 = serving.load_predictor({**plain_k, "compute_dtype": "float32"},
                                      flat_k)
        d32 = float(np.abs(f32(reqs[1]) - pf32(reqs[1])).max())
        check(d32 <= MODEL_TOL["float32"],
              f"{tag}: f32 max |kernel path - plain path| {d32:.4g} (tol "
              f"{MODEL_TOL['float32']})")
        med = statistics.median(lat)
        print(f"  {tag}: request latency ms {[round(x * 1e3, 3) for x in lat]}"
              f", median {med * 1e3:.3f} ms, {GRAPHS / med:.1f} graphs/s "
              f"(batch {GRAPHS}, {layers} layers, bf16) [{smi}]", flush=True)

    for kind in SP_CONFIGS:
        try:
            serve_sp(kind)
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 4c: {kind} serving")

    # ---- 4d. TSP serving: the 500k `egt.json` at full width and depth on
    # path A, 2 requests of 24 graphs (the scheme's prediction batch) in each
    # length bucket through K3 (16 launches a request), the (b, l, l, 2) edge
    # logits on the valid pairs against the model's plain path (bf16 each
    # within 5e-2 + 2e-2 |plain|, f32 5e-4)
    tsp_raw = json.loads((TSP_DIR / "500k" / "egt.json").read_text())
    tsp_flat = synthetic.random_flat_params(
        schemes.model_config_from_config(tsp_raw), seed=4)

    def tsp_batches(l, n, graphs, seed, pe=None):
        srng = np.random.default_rng(seed)
        above = TSP_BUCKETS[l][0] - 1
        return [synthetic.tsp_batch(srng, graphs, l, above, pe=pe)
                for _ in range(n)]

    try:
        c = schemes.resolve_config(tsp_raw)
        graphs = c.batch_size * c.prediction_bmult
        serve_buckets("tsp", tsp_raw, tsp_flat, TSP_BUCKETS,
                      lambda l: tsp_batches(l, 2, graphs, seed=50 + l),
                      valid_pairs, "pairs")
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 4d: TSP serving")

    # ---- 4e. `egt_simple` serving at full width and depth, in bf16, as
    # shipped (`use_pallas` "auto": the `bias` channel takes the attention
    # kernel, K1 one launch a layer a request, K3 none): ZINC (10 layers,
    # width 80) 4 requests of 128 graphs, its (b, 1) predictions within
    # ZINC's 5e-2 of the plain path; PATTERN (16 layers) 2 x 128 graphs at l
    # 128 and 192, node logits on the valid nodes; TSP (16 layers, the
    # pairwise-cat edge readout) 2 x 24 graphs in each bucket, the (b, l, l,
    # 2) edge logits on the valid pairs
    simple_raw = {k: json.loads(p.read_text())
                  for k, p in SIMPLE_CONFIGS.items()}
    simple_flat = {k: synthetic.random_flat_params(
        schemes.model_config_from_config(r), seed=6)
        for k, r in simple_raw.items()}
    simple = dict(kernel="K1", path="(bias channel, attention kernel)")
    for kind, buckets, requests_of, valid, what, extra in (
            ("zinc", {PAD: None},
             lambda l: [synthetic.zinc_batch(np.random.default_rng(90),
                                             GRAPHS, PAD)
                        for _ in range(N_REQUESTS)],
             lambda q: np.ones((len(q["target"]), 1), bool), "graphs",
             dict(out_shape=(GRAPHS, 1), rtol=0.0)),
            ("pattern", SBM_BUCKETS,
             lambda l: sbm_requests("pattern", l, 2, seed=91 + l),
             valid_nodes, "nodes", {}),
            ("tsp", TSP_BUCKETS,
             lambda l: tsp_batches(l, 2, TSP_BATCH * schemes.resolve_config(
                 simple_raw["tsp"]).prediction_bmult, seed=92 + l),
             valid_pairs, "pairs", {})):
        try:
            serve_buckets(f"{kind} egt_simple", simple_raw[kind],
                          simple_flat[kind], buckets, requests_of, valid,
                          what, **simple, **extra)
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 4e: {kind} egt_simple serving")

    # ---- 4f. PCQM4Mv2 EGT-Large serving at full width and depth, in bf16,
    # with the kernel knob on (`use_pallas` true: K1 one launch a layer a
    # request, K3 none): 4 requests of the shipped batch of 1,024 synthetic
    # molecules at l 36 and 2 at l 60 (molecules of up to 51 atoms), the
    # (b, 1) predictions in f32 within 5e-4 of the plain path (`use_pallas`
    # false, as shipped); in bf16 the kernel path at most 1.5 times as far
    # from the f32 plain path as the bf16 plain path is. Through 30 layers
    # of width 768 the bf16 rounding alone moves each path 0.063-0.076
    # from f32 at predictions up to 2, and the two paths, which round at
    # other points, 0.072-0.080 from each other: past ZINC's 5e-2 (10
    # layers) and the logits' 5e-2 + 2e-2 |plain|
    pcqm_raw = json.loads(PCQM_CONFIG.read_text())
    pcqm_flat = synthetic.random_flat_params(
        schemes.model_config_from_config(pcqm_raw), seed=8)

    def pcqm_requests(l):
        prng = np.random.default_rng(100 + l)
        return [synthetic.pcqm_batch(prng, PCQM_REQUEST, PCQM_PADS[l][1])
                for _ in range(N_REQUESTS if l == min(PCQM_PADS) else 2)]

    try:
        serve_buckets("pcqm4mv2 egt_large", {**pcqm_raw, "use_pallas": True},
                      pcqm_flat, PCQM_PADS, pcqm_requests,
                      lambda q: np.ones((len(q["target"]), 1), bool),
                      "graphs", kernel="K1", path="(use_pallas, K1)",
                      out_shape=(PCQM_REQUEST, 1), drift_ratio=1.5)
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 4f: pcqm4mv2 serving")

    # ---- 4h. the model API's variants at the flagship ZINC widths (10
    # layers, width 64, edge width 64, 8 heads, pad 40, 128 graphs), seeded
    # weights, through `EGTGraphModel` as a user of the model API builds
    # it: variant X (cross-talk 0.5 / 0.5, node and edge BatchNorm reading
    # the moving statistics, gelu; `use_pallas`, so K1 in every layer, as
    # `can_fuse_layer` refuses each of the three) and variant E (degree
    # encoding 8 both ways, diffusion 2, node2edge, transposed hops,
    # `readout_edges`) on path A (K3) and path C (K1, K8); 4 requests each
    # against the plain path (bf16 5e-2, f32 5e-4), launches counted.
    # Variant X in bf16 is held as phase 4f holds EGT-Large, by drift: the
    # kernel path at most DRIFT times as far from the f32 plain path as the
    # bf16 plain path. Its BatchNorms read seeded moving statistics, which
    # scale but do not normalise the residual stream, so its predictions
    # reach about 20 and bf16 rounding alone moves the plain path 0.43 from
    # f32 (the CPU's plain path at 32 graphs), past 5e-2; f32 carries the
    # kernels' agreement there (5e-4, and 1e-3 for the gradients)
    DRIFT = 1.5
    from dataclasses import replace as cfg_replace

    from egt_torch.models.graph_model import EGTGraphModel
    from egt_torch.weights import load_flat_params

    zinc_cfg = schemes.model_config_from_config(raw)
    off = dict(fused_attention=False, fused_layer=False,
               fused_edge_block=False)
    var_x = cfg_replace(zinc_cfg, node2edge_xtalk=0.5, edge2node_xtalk=0.5,
                        node_normalization="batch",
                        edge_normalization="batch", activation="gelu")
    var_e = cfg_replace(zinc_cfg, max_degree_enc=8, bidir_degree=True,
                        max_diffuse_t=2, node2edge_embed=True,
                        include_xpose=True, readout_edges=True)
    # (tag, kernel path's config, plain path's config, weights, kernels on
    # the serving path, kernels a training step launches, one a layer,
    # whether bf16 is held by drift)
    variants = [
        ("variant X (cross-talk, BatchNorm, gelu; K1; K2)",
         cfg_replace(var_x, **{**off, "fused_attention": True}),
         cfg_replace(var_x, **off),
         synthetic.random_flat_params(var_x, seed=11), ("K1",),
         dict(K1=10, K2=10), True),
        ("variant E path A (encodings, readout_edges; K3; K4, K5)",
         cfg_replace(var_e, **{**off, "fused_layer": True}),
         cfg_replace(var_e, **off),
         synthetic.random_flat_params(var_e, seed=12), ("K3",),
         dict(K3=10, K4=10, K5=10), False),
        # the readout reads the last layer's edge output: K9 10 a step
        ("variant E path C (K1, K8; K9, K2)",
         cfg_replace(var_e, **{**off, "fused_attention": True,
                               "fused_edge_block": True}),
         cfg_replace(var_e, **off),
         synthetic.random_flat_params(var_e, seed=12), ("K1", "K8"),
         dict(K1=10, K8=10, K9=10, K2=10), False)]

    def api_model(cfg, flat_v, dtype=None):
        if dtype is not None:
            cfg = cfg_replace(cfg, compute_dtype=dtype)
        model = load_flat_params(EGTGraphModel(cfg, device=dev), flat_v)
        model.eval()

        def predict(batch):
            with torch.inference_mode():
                out = model({k: batch[k] for k in model.input_keys})
            return out.cpu().numpy()
        return predict

    def serve_variant(tag, cfg_k, cfg_p, flat_v, on, _want, drift):
        predict = api_model(cfg_k, flat_v)
        predict(requests[0])                       # warm-up
        torch.cuda.synchronize()

        def run():
            lat, outs = [], []
            for r in requests:
                t = time.perf_counter()
                outs.append(predict(r))
                lat.append(time.perf_counter() - t)
            return lat, outs

        (lat, outs), _ = counted(run, {k: 10 * N_REQUESTS for k in on},
                                 f"{tag} serving, {N_REQUESTS} requests")
        refs = [api_model(cfg_p, flat_v)(r) for r in requests]
        ref32 = [api_model(cfg_p, flat_v, "float32")(r) for r in requests]
        ok = all(o.shape == (GRAPHS, 1) and np.isfinite(o).all()
                 for o in outs)
        diff = max(float(np.abs(o - r).max()) for o, r in zip(outs, refs))
        dk, dp = (max(float(np.abs(o - r).max()) for o, r in zip(x, ref32))
                  for x in (outs, refs))
        what = (f"{tag} serving: outputs finite, shape ({GRAPHS}, 1), bf16 "
                f"max |kernel path - plain path| {diff:.4g}; from the f32 "
                f"plain path (|x| max {max(np.abs(r).max() for r in ref32):.3g})"
                f": kernel path {dk:.4g}, plain path {dp:.4g}")
        if drift:
            check(ok and dk <= DRIFT * dp, f"{what} (at most {DRIFT}x)")
        else:
            check(ok and diff <= MODEL_TOL["bfloat16"],
                  f"{what} (tol {MODEL_TOL['bfloat16']})")
        d32 = float(np.abs(api_model(cfg_k, flat_v, "float32")(requests[1])
                           - api_model(cfg_p, flat_v, "float32")(requests[1])
                           ).max())
        check(d32 <= MODEL_TOL["float32"],
              f"{tag} serving: f32 max |kernel path - plain path| {d32:.4g} "
              f"(tol {MODEL_TOL['float32']})")
        med = statistics.median(lat)
        print(f"  {tag} serving: request latency median {med * 1e3:.3f} ms, "
              f"{GRAPHS / med:.1f} graphs/s (batch {GRAPHS}, 10 layers, "
              f"bf16) [{smi}]", flush=True)

    for v in variants:
        try:
            serve_variant(*v)
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 4h: {v[0]} serving")

    # ---- 5. the training paths
    trng = np.random.default_rng(1)
    train_batches = [synthetic.zinc_batch(trng, GRAPHS, PAD)
                     for _ in range(N_STEPS + 1)]

    def run_steps(overrides, dtype, n=3, base=None, weights=None,
                  batches=None):
        """Losses of n steps on `batches` (train_batches) and the first
        step's gradients, from the seeded weights (`weights` of `base`: the
        ZINC config's by default)."""
        base = raw if base is None else base
        batches = train_batches if batches is None else batches
        tr = load_trainer({**base, **overrides, "compute_dtype": dtype},
                          flat if weights is None else weights)
        losses, grads = [], None
        for i in range(n):
            losses.append(tr.train_step(batches[i])["loss"])
            if i == 0:
                grads = {k: (None if p.grad is None else p.grad.clone())
                         for k, p in tr.model.named_parameters()}
        return losses, grads

    plain_ref = {}

    def agreement(tag, overrides, dtype, kind="zinc", **ctx):
        """The kernel path's 3 losses and step-1 gradients against the
        plain path's; `ctx` (base, weights, batches) names another config
        than ZINC's, `kind` its key. Returns both paths' step-1 gradients
        (plain, kernel)."""
        if (kind, dtype) not in plain_ref:
            plain_ref[(kind, dtype)] = run_steps(
                {"use_pallas": False, "use_pallas_layer": False}, dtype,
                **ctx)
        (lp, gp), (lk, gk) = plain_ref[(kind, dtype)], \
            run_steps(overrides, dtype, **ctx)
        ltol, gtol = TRAIN_TOL[dtype]
        dl = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(lk, lp))
        check(dl <= ltol and np.all(np.isfinite(lk)),
              f"{tag} {dtype}: losses {[round(x, 6) for x in lk]} vs plain "
              f"{[round(x, 6) for x in lp]}, max rel diff {dl:.3g} "
              f"(tol {ltol})")
        top = max(float(g.abs().max()) for g in gp.values() if g is not None)
        worst, where = 0.0, ""
        for k, g in gp.items():
            if g is None:
                # no loss reaches it: the kernel path may hand back zeros
                # (the last layer's unused edge output); both leave the
                # parameter unchanged
                if gk[k] is not None and bool(gk[k].any()):
                    check(False, f"{tag}: {k} has a nonzero gradient only "
                          "on the kernel path")
                continue
            e = float((gk[k] - g).abs().max()) / max(float(g.abs().max()),
                                                     1e-2 * top)
            if not e <= worst:
                worst, where = e, k
        check(worst <= gtol,
              f"{tag} {dtype}: step-1 gradients of every parameter, worst "
              f"normalised |kernel - plain| {worst:.3g} at {where} "
              f"(tol {gtol}; largest gradient {top:.3g})")
        if dtype == "bfloat16" and (kind, "float32") in plain_ref:
            # how far each bf16 path lies from the f32 plain path, by the
            # same measures: the rounding both carry, beside their distance
            lr, gr = plain_ref[(kind, "float32")]
            top32 = max(float(g.abs().max()) for g in gr.values()
                        if g is not None)

            def drift(ls, gs):
                dl = max(abs(a - b) / max(abs(b), 1e-6)
                         for a, b in zip(ls, lr))
                dg = max(float((gs[k] - g).abs().max())
                         / max(float(g.abs().max()), 1e-2 * top32)
                         for k, g in gr.items() if g is not None)
                return f"losses {dl:.3g}, gradients {dg:.3g}"
            print(f"  {tag}: bf16 distance from the f32 plain path: kernel "
                  f"path {drift(lk, gk)}; plain path {drift(lp, gp)}",
                  flush=True)
        return gp, gk

    def train(tag, overrides, want, impl="split"):
        """Timed steps with the launches a step in `want`, agreement with
        the plain path, and a falling loss; the whole-layer backward is
        `impl` (fused_layer.BWD_IMPL) for the phase."""
        fl.BWD_IMPL = impl
        try:
            tr = load_trainer({**raw, **overrides}, flat)  # bf16, as shipped
            tr.train_step(train_batches[0])                # warm-up
            torch.cuda.synchronize()

            def run():
                times, losses = [], []
                for bt in train_batches[1:]:
                    t = time.perf_counter()
                    losses.append(tr.train_step(bt)["loss"])  # .item(): synced
                    times.append(time.perf_counter() - t)
                return times, losses

            (times, losses), launches = counted(
                run, {k: n * N_STEPS for k, n in want.items()},
                f"{tag}, {N_STEPS} steps")
            check(bool(np.all(np.isfinite(losses))),
                  f"{tag}: losses finite {[round(x, 5) for x in losses]}")
            med = statistics.median(times)
            print(f"  {tag}: step ms {[round(x * 1e3, 3) for x in times]}, "
                  f"median {med * 1e3:.3f} ms, {GRAPHS / med:.1f} graphs/s "
                  f"(batch {GRAPHS}, 10 layers, bf16)", flush=True)
            for dtype in ("float32", "bfloat16"):
                agreement(tag, overrides, dtype)
            fall = load_trainer({**raw, **overrides}, flat)
            fl_losses = [fall.train_step(train_batches[0])["loss"]
                         for _ in range(N_FALL)]
            first, last = np.mean(fl_losses[:5]), np.mean(fl_losses[-5:])
            check(last < first, f"{tag}: {N_FALL} steps on one batch, mean "
                  f"loss of the first 5 {first:.5f} -> last 5 {last:.5f}")
            return launches
        finally:
            fl.BWD_IMPL = "split"

    # each kernel's launches on the training path that runs it; path C
    # launches K9 9 times a step: the last layer's edge output feeds no loss,
    # so autograd never runs that layer's edge-block backward (its tail
    # parameters get no gradient, as on the plain path)
    train_launches = {}
    for tag, overrides, want, impl in (
            ("training path A (K3; K4, K5)", {},
             dict(K3=10, K4=10, K5=10), "split"),
            ("training path B (K1; K2)", path_b, dict(K1=10, K2=10), "split"),
            ("training path C (K1, K8; K9, K2)", path_c,
             dict(K1=10, K8=10, K9=9, K2=10), "split"),
            ("training path A-merged (K3; K7)", {}, dict(K3=10, K7=10),
             "merged"),
            ("training path A-mono (K3; K6)", {}, dict(K3=10, K6=10),
             "mono")):
        try:
            launches = train(tag, overrides, want, impl)
            train_launches.update({k: launches[k] for k in want
                                   if k not in train_launches})
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 5: {tag}")

    # ---- 5b. SBM training: PATTERN in both buckets (warm-up, then timed
    # steps: 4 at l 192, 2 at l 128), CLUSTER at l 192; each step's K3 / K4
    # / K5 launches (one each a layer: the last layer's edge output feeds
    # no loss, but its backward still runs K4 for the node stream's v_att),
    # agreement with the plain path on SBM_AGREE graphs a batch, and a
    # falling loss over 20 steps on one batch of 128 at l 192
    sbm_launches = {}

    def train_buckets(kind, raw_k, flat_k, batches,
                      kernels=("K3", "K4", "K5"), path="path A"):
        """One trainer (bf16, as shipped) over the length buckets of
        `batches` ({l: [warm-up batch, timed batches...]}): each of
        `kernels` once a layer a step (path A: K3 / K4 / K5) and no other,
        finite losses, the step times; returns the launches a bucket."""
        layers = raw_k["model_height"]
        tr = load_trainer(raw_k, flat_k)
        out = {}
        for l, bs in batches.items():
            tag = f"{kind} training {path}, l {l}"
            tr.train_step(bs[0])                   # warm-up at this shape
            torch.cuda.synchronize()

            def run():
                times, losses = [], []
                for bt in bs[1:]:
                    t = time.perf_counter()
                    losses.append(tr.train_step(bt)["loss"])
                    times.append(time.perf_counter() - t)
                return times, losses

            n = len(bs) - 1
            (times, losses), out[l] = counted(
                run, {k: layers * n for k in kernels}, f"{tag}, {n} steps")
            check(bool(np.all(np.isfinite(losses))),
                  f"{tag}: losses finite {[round(x, 5) for x in losses]}")
            med = statistics.median(times)
            graphs = len(bs[0]["target"])
            print(f"  {tag}: step ms {[round(x * 1e3, 3) for x in times]}, "
                  f"median {med * 1e3:.3f} ms, {graphs / med:.1f} graphs/s "
                  f"(batch {graphs}, {layers} layers, bf16) [{smi}]",
                  flush=True)
        return out

    def loss_falls(kind, raw_k, flat_k, batch, path="path A"):
        fall = load_trainer(raw_k, flat_k)
        fl_losses = [fall.train_step(batch)["loss"] for _ in range(N_FALL)]
        first, last = np.mean(fl_losses[:5]), np.mean(fl_losses[-5:])
        check(last < first, f"{kind} training {path}, l "
              f"{batch['graph_matrix'].shape[1]}: {N_FALL} steps on one "
              f"batch, mean loss of the first 5 {first:.5f} -> last 5 "
              f"{last:.5f}")

    def train_sbm(kind, lengths):
        raw_k, flat_k = sbm_raw[kind], sbm_flat[kind]
        batches = {l: sbm_requests(kind, l, 1 + n, seed=10 + l)
                   for l, n in lengths.items()}
        sbm_launches[kind] = train_buckets(kind, raw_k, flat_k, batches)
        l = max(lengths)
        small = [{k: v[:SBM_AGREE] for k, v in bt.items()}
                 for bt in batches[l]]
        for dtype in ("float32", "bfloat16"):
            agreement(f"{kind} training path A, l {l}, {SBM_AGREE} graphs",
                      {}, dtype, kind=kind, base=raw_k, weights=flat_k,
                      batches=small)
        loss_falls(kind, raw_k, flat_k, batches[l][0])

    for kind, lengths in (("pattern", N_SBM_STEPS),
                          ("cluster", {192: N_SBM_STEPS[192]})):
        try:
            train_sbm(kind, lengths)
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 5b: {kind} training")

    # ---- 5c. training with the positional encodings and the distance head:
    # CIFAR10 and MNIST `egt_spe_do` (random mask 0.1, the SVD sign flips
    # and the distance head live) take a warm-up step and N_STEPS timed
    # steps on 128 graphs, K3 / K4 / K5 once each a layer a step; their 3
    # losses and step-1 gradients agree with the plain path's (f32 and
    # bf16), the last layer's edge tail and the final edge norm among them,
    # non-zero on both paths (the distance head reads them); 20 steps on
    # one batch lower the loss. Then the same agreement for the PATTERN
    # `egt_epe` config (eigenvectors) at l 128 on SBM_AGREE graphs a batch,
    # cut from 16 layers to PE_AGREE_DEPTH, and the ZINC `egt_spe_do` config
    # (10 layers, edge width 64) at pad 40 on 128 graphs
    sp_launches = {}
    reached = ("edge_ffn.lr1.kernel", "edge_ffn.lr2.kernel",
               "edge_ffn.norm.gamma", "dense_edge_r.kernel",
               "norm_edge.gamma")

    def edge_tail_reached(tag, layers, grads):
        """The last layer's edge tail and the final edge norm have a
        non-zero gradient on both paths (`grads`: (plain, kernel))."""
        names = [f"stack.layers.{layers - 1}.{n}" for n in reached] + [
            "stack.edge_norm_final.gamma", "stack.edge_norm_final.beta"]
        for path, g in zip(("plain", "kernel"), grads):
            nz = [n for n in names if g[n] is not None and bool(g[n].any())]
            check(len(nz) == len(names), f"{tag}: the last layer's edge tail "
                  f"and edge_norm_final reached on the {path} path "
                  f"({len(nz)} of {len(names)} gradients non-zero)")

    def train_pe(kind, raw_k, flat_k, batches, agree, timed=True):
        layers = raw_k["model_height"]
        l = batches[0]["graph_matrix"].shape[1]
        tag = f"{kind} training path A, l {l}"
        if timed:
            tr = load_trainer(raw_k, flat_k)       # bf16, as shipped
            tr.train_step(batches[0])              # warm-up
            torch.cuda.synchronize()

            def run():
                times, losses, dist = [], [], []
                for bt in batches[1:]:
                    t = time.perf_counter()
                    res = tr.train_step(bt)
                    times.append(time.perf_counter() - t)
                    losses.append(res["loss"])
                    dist.append(res.get("distance_loss"))
                return times, losses, dist

            n = len(batches) - 1
            (times, losses, dist), launches = counted(
                run, {k: layers * n for k in ("K3", "K4", "K5")},
                f"{tag}, {n} steps")
            sp_launches[kind] = launches
            check(bool(np.all(np.isfinite(losses))) and all(
                d is not None and np.isfinite(d) for d in dist),
                f"{tag}: losses finite {[round(x, 5) for x in losses]}, "
                f"distance losses {[round(x, 3) for x in dist]}")
            med = statistics.median(times)
            print(f"  {tag}: step ms {[round(x * 1e3, 3) for x in times]}, "
                  f"median {med * 1e3:.3f} ms, {GRAPHS / med:.1f} graphs/s "
                  f"(batch {GRAPHS}, {layers} layers, bf16) [{smi}]",
                  flush=True)
        for dtype in ("float32", "bfloat16"):
            grads = agreement(f"{tag}, {len(agree[0]['target'])} graphs",
                              {}, dtype, kind=kind, base=raw_k,
                              weights=flat_k, batches=agree)
            if raw_k.get("distance_loss", 0) > 0:
                edge_tail_reached(f"{tag} {dtype}", layers, grads)
        if timed:
            fall = load_trainer(raw_k, flat_k)
            fl_losses = [fall.train_step(batches[0])["loss"]
                         for _ in range(N_FALL)]
            first, last = np.mean(fl_losses[:5]), np.mean(fl_losses[-5:])
            check(last < first, f"{tag}: {N_FALL} steps on one batch, mean "
                  f"loss of the first 5 {first:.5f} -> last 5 {last:.5f}")

    for kind in ("cifar10", "mnist"):
        try:
            bs = sp_requests(kind, N_STEPS + 1, seed=30)
            train_pe(kind, sp_raw[kind], sp_flat[kind], bs, bs[:3])
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 5c: {kind} training")
    for kind, path, make in (
            ("pattern-epe", REPO / "configs/main/pattern/500k/egt_epe.json",
             lambda r: synthetic.add_pe(synthetic.sbm_batch(
                 r, SBM_AGREE, 128, "pattern", above=43), "eig", 20)),
            ("zinc-spe-do", REPO / "configs/main/zinc/500k/egt_spe_do.json",
             lambda r: synthetic.add_pe(synthetic.zinc_batch(r, GRAPHS, PAD),
                                        "svd", 16))):
        try:
            raw_k = json.loads(path.read_text())
            if kind == "pattern-epe":
                raw_k["model_height"] = PE_AGREE_DEPTH
            flat_k = synthetic.random_flat_params(
                schemes.model_config_from_config(raw_k), seed=3)
            prng = np.random.default_rng(40)
            bs = [make(prng) for _ in range(3)]
            train_pe(kind, raw_k, flat_k, bs, bs, timed=False)
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 5c: {kind} agreement")

    # ---- 5d. TSP training: the 500k `egt.json` takes a warm-up step and 4
    # timed steps at l 512, then 1 + 2 at l 256 and at l 128 (bf16, random
    # mask 0.1 live), K3 / K4 / K5 16 launches each a step (the last layer's
    # K4 with a live edge cotangent: the edge readout reads its edge
    # output); its 3 losses and step-1 gradients agree with the plain path's
    # (f32 and bf16) at l 512 and l 128 on TSP_AGREE graphs a batch, the last
    # layer's edge tail and `edge_norm_final` reached on both paths; 20 steps
    # on one batch at l 128 lower the loss; the same agreement for the 500k
    # `egt_spe.json` (the SVD PE, its sign flips live) at l 256
    tsp_launches = {}

    def train_tsp():
        layers = tsp_raw["model_height"]
        batches = {l: tsp_batches(l, 1 + n, TSP_BATCH, seed=60 + l)
                   for l, n in N_TSP_STEPS.items()}
        tsp_launches.update(train_buckets("tsp", tsp_raw, tsp_flat, batches))
        for l in (512, 128):
            agree = [{k: v[:TSP_AGREE] for k, v in bt.items()}
                     for bt in batches[l][:3]]
            tag = f"tsp training path A, l {l}, {TSP_AGREE} graphs"
            for dtype in ("float32", "bfloat16"):
                torch.cuda.reset_peak_memory_stats()
                grads = agreement(tag, {}, dtype, kind=f"tsp-{l}",
                                  base=tsp_raw, weights=tsp_flat,
                                  batches=agree)
                edge_tail_reached(f"{tag} {dtype}", layers, grads)
                print(f"  {tag} {dtype}: peak device memory "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
                      flush=True)
        loss_falls("tsp", tsp_raw, tsp_flat, batches[128][0])

    def agree_tsp_spe():
        raw_k = json.loads((TSP_DIR / "500k" / "egt_spe.json").read_text())
        c = schemes.resolve_config(raw_k)
        flat_k = synthetic.random_flat_params(
            schemes.model_config_from_config(raw_k), seed=5)
        agree = tsp_batches(256, 3, TSP_AGREE, seed=70, pe="svd")
        tag = f"tsp-spe training path A, l 256, {TSP_AGREE} graphs"
        check(bool(c.random_neg), f"{tag}: the SVD sign flips live")
        for dtype in ("float32", "bfloat16"):
            grads = agreement(tag, {}, dtype, kind="tsp-spe", base=raw_k,
                              weights=flat_k, batches=agree)
            edge_tail_reached(f"{tag} {dtype}", raw_k["model_height"], grads)

    for what, fn in (("training", train_tsp), ("egt_spe agreement",
                                               agree_tsp_spe)):
        try:
            fn()
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 5d: TSP {what}")

    # ---- 5e. `egt_simple` training as shipped (bf16, random mask 0.1
    # live): ZINC 1 + 4 steps of 128 graphs at pad 40, PATTERN 1 + 4 at l
    # 192 and 1 + 2 at l 128, TSP 1 + 4 at l 512 and 1 + 2 at l 256 and
    # 128, MNIST and CIFAR10 1 + 2 at their pads; K1 and K2 once each a
    # layer a step, K3-K9 never; the 3 losses and every step-1 gradient
    # agree with the plain path's (f32 and bf16) at ZINC (128 graphs),
    # PATTERN l 192 (SBM_AGREE graphs), TSP l 512 (TSP_AGREE) and CIFAR10 l
    # 150 (128), the edge embeddings' gradients (each the sum of every
    # layer's de and dg: the raw e feeds every layer) non-zero on both
    # paths; 20 steps on one ZINC batch lower the loss
    simple_launches = {}

    def embeddings_reached(tag, grads):
        """The edge embeddings' step-1 gradients (`grads`: plain, kernel)
        are non-zero on both paths; their distance normalised as the
        agreement normalises it."""
        plain, kern = grads
        top = max(float(g.abs().max()) for g in plain.values()
                  if g is not None)
        for n in ("fm_emb.table", "fm_emb.kernel", "adj_emb.kernel"):
            if n not in plain:
                continue
            nz = all(g[n] is not None and bool(g[n].any()) for g in grads)
            err = float((kern[n] - plain[n]).abs().max()) / max(
                float(plain[n].abs().max()), 1e-2 * top) if nz else math.nan
            check(nz, f"{tag}: {n}'s gradient non-zero on both paths, "
                  f"normalised |kernel - plain| {err:.3g}")

    def train_simple(kind, batches, agree_l, agree_n):
        raw_k, flat_k = simple_raw[kind], simple_flat[kind]
        simple_launches[kind] = train_buckets(
            f"{kind} egt_simple", raw_k, flat_k, batches,
            kernels=("K1", "K2"), path=simple["path"])
        if agree_l is None:
            return
        agree = [{k: v[:agree_n] for k, v in bt.items()}
                 for bt in batches[agree_l][:3]]
        tag = (f"{kind} egt_simple training {simple['path']}, l {agree_l}, "
               f"{agree_n} graphs")
        for dtype in ("float32", "bfloat16"):
            torch.cuda.reset_peak_memory_stats()
            grads = agreement(tag, {}, dtype, kind=f"{kind}-simple",
                              base=raw_k, weights=flat_k, batches=agree)
            embeddings_reached(f"{tag} {dtype}", grads)
            print(f"  {tag} {dtype}: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
                  flush=True)

    srng = np.random.default_rng(95)
    for kind, make, agree_l, agree_n in (
            ("zinc", lambda: {PAD: [synthetic.zinc_batch(srng, GRAPHS, PAD)
                                    for _ in range(N_STEPS + 1)]},
             PAD, GRAPHS),
            ("pattern", lambda: {l: sbm_requests("pattern", l, 1 + n,
                                                 seed=96 + l)
                                 for l, n in N_SBM_STEPS.items()},
             192, SBM_AGREE),
            ("tsp", lambda: {l: tsp_batches(l, 1 + n, TSP_BATCH, seed=97 + l)
                             for l, n in N_TSP_STEPS.items()},
             512, TSP_AGREE),
            ("cifar10", lambda: {150: sp_requests("cifar10", 3, seed=98)},
             150, GRAPHS),
            ("mnist", lambda: {75: sp_requests("mnist", 3, seed=99)},
             None, None)):
        try:
            batches = make()
            train_simple(kind, batches, agree_l, agree_n)
            if kind == "zinc":
                loss_falls("zinc egt_simple", simple_raw[kind],
                           simple_flat[kind], batches[PAD][0],
                           path=simple["path"])
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 5e: {kind} egt_simple training")

    # ---- 5f. PCQM4Mv2 EGT-Large training at full width and depth, in bf16,
    # with the kernel knob on (K1 forward, K2 backward in every layer, K3-K9
    # never): micro-batches of 128 at l 36, 8 an optimizer step (the shipped
    # batch of 1,024); a warm-up step and 4 timed, K1 / K2 30 each a
    # micro-batch; one micro-batch at l 60; the peak device memory of a
    # micro-batch of 128 and of 256; the 3 losses and step-1 gradients of 3
    # micro-batch steps against the plain path's (f32 and bf16); 20 steps on
    # one micro-batch lower the loss under the warmup-cosine schedule with a
    # 10-step warmup (the shipped 15,000 keep the rate near zero for all
    # 20). Then agreement only: ZINC `egt.json` with a virtual node, whose
    # rows ride the whole-layer kernels K3 / K4 / K5 (no degree scaler)
    pcqm_launches = {}
    pcqm_train = {**pcqm_raw, "use_pallas": True, "batch_size": PCQM_MICRO,
                  "grad_accum_steps": PCQM_ACCUM}
    pcqm_tag = "pcqm4mv2 egt_large training (use_pallas, K1; K2)"

    def peak(what):
        print(f"  {pcqm_tag}: peak device memory {what} "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({torch.cuda.max_memory_allocated()} B) [{smi}]", flush=True)

    def train_pcqm():
        layers, A = pcqm_raw["model_height"], PCQM_ACCUM
        prng = np.random.default_rng(110)
        micro = [synthetic.pcqm_batch(prng, PCQM_MICRO)
                 for _ in range((1 + N_STEPS) * A)]
        groups = [micro[i * A:(i + 1) * A] for i in range(1 + N_STEPS)]
        torch.cuda.reset_peak_memory_stats()
        tr = load_trainer(pcqm_train, pcqm_flat)
        acc = M.DeviceAccumulator()
        tr.train_into(acc, groups[0])               # warm-up
        torch.cuda.synchronize()

        def run():
            times = []
            for g in groups[1:]:
                t = time.perf_counter()
                tr.train_into(acc, g)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            return times

        n = layers * A * N_STEPS
        times, pcqm_launches[36] = counted(
            run, {"K1": n, "K2": n},
            f"{pcqm_tag}, l 36, {N_STEPS} steps of {A} x {PCQM_MICRO} graphs")
        res = acc.result()
        check(all(np.isfinite(v) for v in res.values()),
              f"{pcqm_tag}: {1 + N_STEPS} steps, mean loss {res['loss']:.5f}, "
              f"mae {res['mae']:.5f}")
        med = statistics.median(times)
        print(f"  {pcqm_tag}, l 36: step ms {[round(x * 1e3, 3) for x in times]}"
              f", median {med * 1e3:.3f} ms ({med * 1e3 / A:.3f} ms a "
              f"micro-batch), {A * PCQM_MICRO / med:.1f} graphs/s (batch {A} "
              f"x {PCQM_MICRO}, {layers} layers, bf16) [{smi}]", flush=True)
        peak(f"of {1 + N_STEPS} steps of micro-batches of {PCQM_MICRO}, "
             "model and optimizer state included,")
        long = synthetic.pcqm_batch(prng, PCQM_MICRO, PCQM_PADS[60][1])
        tr.train_step(long)                         # warm-up at l 60
        torch.cuda.synchronize()
        _, pcqm_launches[60] = counted(
            lambda: tr.train_step(long)["loss"], {"K1": layers, "K2": layers},
            f"{pcqm_tag}, l 60, one micro-batch of {PCQM_MICRO}")
        big = synthetic.pcqm_batch(prng, 2 * PCQM_MICRO)
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(big)
        peak(f"of one micro-batch of {2 * PCQM_MICRO} at l 36,")
        del tr
        for dtype in ("float32", "bfloat16"):
            torch.cuda.reset_peak_memory_stats()
            agreement(f"{pcqm_tag}, l 36, {PCQM_MICRO} graphs",
                      {"use_pallas": True}, dtype, kind="pcqm",
                      base={**pcqm_raw, "batch_size": PCQM_MICRO},
                      weights=pcqm_flat, batches=micro[:3])
            peak(f"of the {dtype} agreement (both paths, 3 steps each),")
        fall = load_trainer(pcqm_train, pcqm_flat)
        losses = []
        for i in range(N_FALL):
            lr, _ = schedules.warmup_cosine_lr(
                i, warmup_steps=PCQM_FALL_WARMUP,
                max_lr=float(pcqm_raw["initial_lr"]),
                total_steps=int(pcqm_raw["total_steps"]))
            fall.set_learning_rate(lr)
            losses.append(fall.train_step(micro[0])["loss"])
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        check(last < first, f"{pcqm_tag}: {N_FALL} steps on one micro-batch "
              f"with a {PCQM_FALL_WARMUP}-step warmup (the shipped "
              f"{pcqm_raw['warmup_steps']} hold the rate near zero), mean "
              f"loss of the first 5 {first:.5f} -> last 5 {last:.5f}")

    def agree_zinc_vn():
        raw_k = {**raw, "num_virtual_nodes": 1}
        flat_k = synthetic.random_flat_params(
            schemes.model_config_from_config(raw_k), seed=9)
        tag = "zinc egt.json with a virtual node, training path A"
        tr = load_trainer(raw_k, flat_k)
        counted(lambda: tr.train_step(train_batches[0])["loss"],
                dict(K3=10, K4=10, K5=10), f"{tag}, one step at l {PAD + 1}")
        for dtype in ("float32", "bfloat16"):
            agreement(tag, {}, dtype, kind="zinc-vn", base=raw_k,
                      weights=flat_k)

    for what, fn in (("pcqm4mv2 training", train_pcqm),
                     ("zinc virtual-node agreement", agree_zinc_vn)):
        try:
            fn()
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 5f: {what}")

    # ---- 5h. the variants of phase 4h in training (`load_trainer` with
    # the variant as its model): a warm-up step and 4 timed (bf16, random
    # mask 0.1 live), the launches a step counted; against the plain path
    # from the same weights and draws, f32 and bf16: the losses of 3 steps,
    # every step-1 gradient, and the BatchNorm moving statistics after 4
    # steps at a learning rate of 0 (f32 1e-5 of their scale, bf16 the
    # gradients' tolerance). At the shipped rate Adam moves a weight whose
    # gradient is rounding noise by about the rate, in a direction the noise
    # picks, so after 4 steps the two paths' statistics lie about 1e-4
    # apart in f32 (the CPU's plain versions show 1.7e-4): that distance is
    # printed and held to the gradients' tolerance
    def variant_steps(cfg, flat_v, dtype, n=4, lr=None):
        tr = load_trainer(raw, flat_v,
                          model_config=cfg_replace(cfg, compute_dtype=dtype))
        if lr is not None:
            tr.set_learning_rate(lr)
        losses, grads = [], None
        for i in range(n):
            losses.append(tr.train_step(train_batches[i])["loss"])
            if i == 0:
                grads = {k: p.grad.clone() for k, p in
                         tr.model.named_parameters() if p.grad is not None}
        stats = {k: torch.from_numpy(v) for k, v in tr.flat_params().items()
                 if "/moving_" in k}
        return losses, grads, stats

    def norm_diff(a, b, floor=0.0):
        return float((a - b).abs().max()) / max(float(b.abs().max()), floor)

    def train_variant(tag, cfg_k, cfg_p, flat_v, _on, want, drift):
        tr = load_trainer(raw, flat_v, model_config=cfg_k)
        tr.train_step(train_batches[0])             # warm-up
        torch.cuda.synchronize()

        def run():
            times, losses = [], []
            for bt in train_batches[1:]:
                t = time.perf_counter()
                losses.append(tr.train_step(bt)["loss"])
                times.append(time.perf_counter() - t)
            return times, losses

        (times, losses), launches = counted(
            run, {k: n * N_STEPS for k, n in want.items()},
            f"{tag} training, {N_STEPS} steps")
        med = statistics.median(times)
        check(bool(np.all(np.isfinite(losses))),
              f"{tag} training: losses finite {[round(x, 5) for x in losses]}"
              f", step median {med * 1e3:.3f} ms, {GRAPHS / med:.1f} graphs/s"
              f" (batch {GRAPHS}, 10 layers, bf16) [{smi}]")
        g32 = None
        for dtype in ("float32", "bfloat16"):
            lk, gk, sk = variant_steps(cfg_k, flat_v, dtype)
            lp, gp, sp_ = variant_steps(cfg_p, flat_v, dtype)
            g32 = gp if g32 is None else g32
            ltol, gtol = TRAIN_TOL[dtype]
            dl = max(abs(a - b) / max(abs(b), 1e-6)
                     for a, b in zip(lk[:3], lp[:3]))
            check(dl <= ltol, f"{tag} {dtype}: 3 losses {lk[:3]} vs plain "
                  f"{lp[:3]}, max rel diff {dl:.3g} (tol {ltol})")
            top = max(float(g.abs().max()) for g in gp.values())
            worst = max((norm_diff(gk.get(k, torch.zeros_like(g)), g,
                                   1e-2 * top), k) for k, g in gp.items())
            # a parameter no loss reaches on the plain path may get zeros
            # from a kernel's backward; both leave it unchanged
            extra = [k for k in gk if k not in gp and bool(gk[k].any())]
            top32 = max(float(g.abs().max()) for g in g32.values())
            dk, dp = (max(norm_diff(x.get(k, torch.zeros_like(g)), g,
                                    1e-2 * top32) for k, g in g32.items())
                      for x in (gk, gp))
            what = (f"{tag} {dtype}: step-1 gradients of every parameter, "
                    f"worst normalised |kernel - plain| {worst[0]:.3g} at "
                    f"{worst[1]}; from the f32 plain path: kernel path "
                    f"{dk:.3g}, plain path {dp:.3g}; nonzero only on the "
                    f"kernel path: {extra}")
            if drift and dtype == "bfloat16":
                check(not extra and dk <= DRIFT * dp,
                      f"{what} (at most {DRIFT}x)")
            else:
                check(not extra and worst[0] <= gtol, f"{what} (tol {gtol})")
            if not sp_:
                continue
            ws = max((norm_diff(sk[k], v, 1e-3), k) for k, v in sp_.items())
            check(ws[0] <= gtol,
                  f"{tag} {dtype}: the {len(sp_)} moving statistics after 4 "
                  f"steps, worst normalised |kernel - plain| {ws[0]:.3g} at "
                  f"{ws[1]} (tol {gtol})")
            sk = variant_steps(cfg_k, flat_v, dtype, lr=0.0)[2]
            sp_ = variant_steps(cfg_p, flat_v, dtype, lr=0.0)[2]
            stol = 1e-5 if dtype == "float32" else gtol
            ws = max((norm_diff(sk[k], v, 1e-3), k) for k, v in sp_.items())
            check(ws[0] <= stol,
                  f"{tag} {dtype}: the moving statistics after 4 steps at a "
                  f"learning rate of 0, worst normalised |kernel - plain| "
                  f"{ws[0]:.3g} at {ws[1]} (tol {stol})")
        return launches

    variant_launches = {}
    for v in variants:
        try:
            variant_launches[v[0]] = train_variant(*v)
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 5h: {v[0]} training")

    # ---- 5i. `remat` on ZINC path A (the config as shipped, K3; K4, K5):
    # one f32 step each without it, with True and with "dots" (random mask
    # live), from the same weights on the same batch: the loss and every
    # gradient equal to the step without it bit for bit (or, where a
    # library product were to sum in another order, within 1e-6 of each
    # gradient's scale), K3 20 launches a step (10 in the forward, 10 in the
    # recompute), the peak device memory of each. Then EGT-Large (30
    # layers, `use_pallas`: K1 / K2) with `remat` true at the shipped batch
    # of 1,024 as ONE micro-batch at l 36 (phase 5f runs it as 8 x 128):
    # 1 + 2 steps, K1 60 and K2 30 a step, the peak and the step time; a
    # smaller micro-batch where 1,024 does not fit, and "dots" only where
    # it fits
    remat_runs = {}

    def remat_zinc():
        for mode in (False, True, "dots"):
            tr = load_trainer({**raw, "compute_dtype": "float32",
                               "remat": mode}, flat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss, launches = counted(
                lambda: tr.train_step(train_batches[0])["loss"],
                dict(K3=20 if mode else 10, K4=10, K5=10),
                f"remat {mode!r}, zinc path A, one f32 step")
            grads = {k: p.grad.clone() for k, p in
                     tr.model.named_parameters() if p.grad is not None}
            remat_runs[mode] = (loss, grads, launches,
                                torch.cuda.max_memory_allocated())
            del tr
        l0, g0, _, m0 = remat_runs[False]
        for mode in (True, "dots"):
            l1, g1, n1, m1 = remat_runs[mode]
            equal = l1 == l0 and sorted(g1) == sorted(g0) and all(
                torch.equal(g1[k], g0[k]) for k in g0)
            worst = max(norm_diff(g1[k], g0[k], 1e-30) for k in g0)
            check(equal or (worst <= 1e-6 and abs(l1 - l0) <= 1e-6 * abs(l0)),
                  f"remat {mode!r}: loss {l1!r} vs {l0!r}, every gradient "
                  f"{'bit-equal' if equal else f'within {worst:.3g}'} to the "
                  f"step without remat; K3 {n1['K3']} launches a step; peak "
                  f"device memory {m1 / 2**30:.3f} GiB ({m1} B) vs "
                  f"{m0 / 2**30:.3f} GiB ({m0} B) without [{smi}]")

    def remat_pcqm():
        layers = pcqm_raw["model_height"]
        prng = np.random.default_rng(120)
        for micro in (PCQM_REQUEST, PCQM_REQUEST // 2, PCQM_REQUEST // 4):
            for mode in (True, "dots"):
                tag = (f"pcqm4mv2 egt_large remat {mode!r}, one micro-batch "
                       f"of {micro} at l 36")
                tr = None
                try:
                    batches = [synthetic.pcqm_batch(prng, micro)
                               for _ in range(3)]
                    tr = load_trainer({**pcqm_raw, "use_pallas": True,
                                       "batch_size": micro, "remat": mode},
                                      pcqm_flat)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    tr.train_step(batches[0])       # warm-up
                    torch.cuda.synchronize()

                    def run():
                        times, losses = [], []
                        for bt in batches[1:]:
                            t = time.perf_counter()
                            losses.append(tr.train_step(bt)["loss"])
                            times.append(time.perf_counter() - t)
                        return times, losses

                    (times, losses), _ = counted(
                        run, dict(K1=2 * 2 * layers, K2=2 * layers),
                        f"{tag}, 2 steps")
                except torch.cuda.OutOfMemoryError:
                    print(f"  {tag}: does not fit the card's memory "
                          f"[{smi}]", flush=True)
                    del tr
                    torch.cuda.empty_cache()
                    if mode is True:
                        break                       # a smaller micro-batch
                    continue
                finite = all(p.grad is None or bool(torch.isfinite(
                    p.grad).all()) for p in tr.model.parameters())
                peak_b = torch.cuda.max_memory_allocated()
                check(bool(np.all(np.isfinite(losses))) and finite,
                      f"{tag}: losses {[round(x, 5) for x in losses]} and "
                      f"every gradient finite; step ms "
                      f"{[round(x * 1e3, 3) for x in times]}, peak device "
                      f"memory {peak_b / 2**30:.2f} GiB ({peak_b} B), model "
                      f"and optimizer state included [{smi}]")
                del tr
                torch.cuda.empty_cache()
            else:
                return
        check(False, "pcqm4mv2 egt_large remat: no micro-batch of 256 or "
              "more fits")

    for what, fn in (("remat on zinc path A", remat_zinc),
                     ("remat on pcqm4mv2 egt_large", remat_pcqm)):
        try:
            fn()
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 5i: {what}")

    # ---- 4j / 5j / 5k. the parallel paths on two ranks of this one card
    # (`egt_torch.parallel.launch`; gloo, which stages CUDA tensors through
    # the host: NCCL takes one card a rank). 4j / 5j: ZINC 500k `egt.json`
    # (10 layers, 128 graphs, pad 40) and TSP 500k `egt.json` (16 layers, 8
    # graphs, l 512) with `edge_partition` 2 and the attention kernel knob
    # (`use_pallas` true): each rank holds half the query rows, K1 and K2
    # run on its row block in every layer (10 / 16 launches each a step a
    # rank), K3-K9 never. 4 requests in f32 and bf16 against the unsharded
    # port's predictions on the card (f32 5e-4; bf16 5e-2 + 2e-2 |plain|,
    # the kernels' tolerance: the paths differ by the order of sums), one
    # f32 step with the draws off against the unsharded step (loss and every
    # gradient at phase 5's f32 tolerance), then 1 + 4 steps as shipped
    # (bf16, random mask 0.1 live) timed beside the unsharded port's, with
    # the collective bytes and host ms a step. 5k: data parallelism over
    # the two ranks on path A (K3; K4, K5 at 64 graphs a rank) with the
    # draws off: one step's loss and every parameter against one process's
    # step on the same 128 graphs (f32 1e-5; an element whose exact
    # gradient is 0, held by rounding noise alone, to the learning rate,
    # which bounds a first Adam step), every gradient at phase 5's f32
    # tolerance; with the draws on the ranks' seeds and bits differ
    from egt_torch.parallel import launch

    sp_over = {"use_pallas": True, "use_pallas_layer": False,
               "edge_partition": 2}
    plan = {"sp": {
        "ZINC": dict(config={**raw, **sp_over}, flat=flat,
                     requests=requests, train=train_batches, layers=10),
        "TSP": dict(config={**tsp_raw, **sp_over}, flat=tsp_flat,
                    requests=tsp_batches(512, N_REQUESTS, TSP_BATCH, 93),
                    train=tsp_batches(512, N_STEPS + 1, TSP_BATCH, 94),
                    layers=16)},
        "dp": dict(config=raw, flat=flat, batch=train_batches[0])}

    def grad_err(gk, gp):
        """The worst normalised |sharded - unsharded| over the parameters
        (phase 5's measure) and where."""
        top = max(float(np.abs(g).max()) for g in gp.values())
        worst, where = 0.0, ""
        for k, g in gp.items():
            e = float(np.abs(gk[k] - g).max()) / max(float(np.abs(g).max()),
                                                     1e-2 * top)
            if not e <= worst:
                worst, where = e, k
        return worst, where, top

    def unsharded(fam, p):
        """The unsharded port's predictions (f32, bf16), f32 step (draws
        off) and median step ms as shipped, on the card."""
        ref = {}
        for dtype in ("float32", "bfloat16"):
            pr = serving.load_predictor(
                {**p["config"], "compute_dtype": dtype}, p["flat"])
            ref[dtype] = [pr(r) for r in p["requests"]]
        tr = load_trainer({**p["config"], "compute_dtype": "float32",
                           "random_mask_prob": 0.0}, p["flat"])
        ref["loss"] = tr.train_step(p["train"][0])["loss"]
        ref["grads"] = {k.replace(".", "/"): q.grad.float().cpu().numpy()
                        for k, q in tr.model.named_parameters()
                        if q.grad is not None}
        del tr
        torch.cuda.empty_cache()
        tr = load_trainer(p["config"], p["flat"])
        tr.train_step(p["train"][0])
        torch.cuda.synchronize()
        times = []
        for bt in p["train"][1:]:
            t = time.perf_counter()
            tr.train_step(bt)
            times.append(time.perf_counter() - t)
        ref["step_ms"] = 1e3 * statistics.median(times)
        del tr
        torch.cuda.empty_cache()
        return ref

    ep_launches: dict = {}
    try:
        refs = {fam: unsharded(fam, p) for fam, p in plan["sp"].items()}
        dtr = load_trainer({**raw, "compute_dtype": "float32",
                            "random_mask_prob": 0.0}, flat)
        dref = dict(report=dtr.train_step(train_batches[0]),
                    grads={k.replace(".", "/"): q.grad.float().cpu().numpy()
                           for k, q in dtr.model.named_parameters()
                           if q.grad is not None},
                    params=dtr.flat_params())
        del dtr
        torch.cuda.empty_cache()
        t = time.perf_counter()
        ranks = launch.spawn_ranks(_parallel_rank, 2, plan, timeout=900)
        print(f"  parallel phases: 2 ranks on {name}, backend "
              f"{ranks[0]['backend']}, {time.perf_counter() - t:.1f} s "
              f"[{smi}]", flush=True)
        check(all(r["backend"] == "gloo" for r in ranks),
              "parallel: two ranks on one card talk over gloo")
        for fam, p in plan["sp"].items():
            ref, n = refs[fam], p["layers"]
            for r, rk in enumerate(ranks):
                res = rk[fam]
                for dtype, (atol, rtol) in (("float32", (5e-4, 0.0)),
                                            ("bfloat16", (5e-2, 2e-2))):
                    sv = res[f"serve {dtype}"]
                    want = {k: 0 for k in sv["launches"]}
                    want["K1"] = n * N_REQUESTS
                    check(sv["launches"] == want,
                          f"4j {fam} sp 2 rank {r} {dtype}: launches "
                          f"{sv['launches']} for {N_REQUESTS} requests "
                          f"(expected {want})")
                    err = max(float(np.abs(o - q).max())
                              for o, q in zip(sv["preds"], ref[dtype]))
                    ok = all(o.shape == q.shape and np.all(
                        np.abs(o - q) <= atol + rtol * np.abs(q))
                        for o, q in zip(sv["preds"], ref[dtype]))
                    check(ok, f"4j {fam} sp 2 rank {r} {dtype}: predictions "
                          f"against the unsharded port, max diff {err:.3g} "
                          f"(tol {atol} + {rtol} |unsharded|); request ms "
                          f"{[round(x * 1e3, 3) for x in sv['lat']]}; "
                          f"collectives {sv['coll']}")
                ag = res["agree"]
                ltol, gtol = TRAIN_TOL["float32"]
                dl = abs(ag["loss"] - ref["loss"]) / max(abs(ref["loss"]),
                                                         1e-6)
                worst, where, top = grad_err(ag["grads"], ref["grads"])
                # a parameter no loss reaches: None unsharded, zeros from
                # the ranks' gradient sum
                unreached = [k for k in ag["grads"] if k not in ref["grads"]]
                check(dl <= ltol and worst <= gtol and
                      ref["grads"].keys() <= ag["grads"].keys() and
                      not any(np.any(ag["grads"][k]) for k in unreached),
                      f"5j {fam} sp 2 rank {r} f32 draws off: loss "
                      f"{ag['loss']:.6f} vs unsharded {ref['loss']:.6f} (rel "
                      f"{dl:.3g}, tol {ltol}); gradients worst normalised "
                      f"diff {worst:.3g} at {where} (tol {gtol}; largest "
                      f"{top:.3g})")
                st = res["steps"]
                want = {k: 0 for k in st["launches"]}
                want.update(K1=n * N_STEPS, K2=n * N_STEPS)
                check(st["launches"] == want and
                      bool(np.all(np.isfinite(st["losses"]))),
                      f"5j {fam} sp 2 rank {r}: {N_STEPS} steps as shipped "
                      f"(bf16, draws live), launches {st['launches']} "
                      f"(expected {want}), losses "
                      f"{[round(x, 5) for x in st['losses']]}")
                coll = {k: {"bytes": v["bytes"] // N_STEPS,
                            "calls": v["calls"] // N_STEPS,
                            "ms": round(v["ms"] / N_STEPS, 3)}
                        for k, v in st["coll"].items()}
                print(f"  5j {fam} sp 2 rank {r}: step ms "
                      f"{[round(x * 1e3, 3) for x in st['times']]}, median "
                      f"{1e3 * statistics.median(st['times']):.3f} ms (the "
                      f"unsharded port {ref['step_ms']:.3f} ms), collectives "
                      f"a step {coll}, peak device memory "
                      f"{st['peak'] / 2**30:.2f} GiB [{smi}]", flush=True)
            ep_launches[fam] = ranks[0][fam]["steps"]["launches"]
        lr = float(schemes.resolve_config(raw).initial_lr)
        for r, rk in enumerate(ranks):
            dp = rk["dp"]
            want = {k: 0 for k in dp["launches"]}
            want.update(K3=10, K4=10, K5=10)
            check(dp["launches"] == want,
                  f"5k dp 2 rank {r}: launches {dp['launches']} a step "
                  f"(expected {want}); collectives {dp['coll']}")
            dl = abs(dp["report"]["loss"] - dref["report"]["loss"]) / abs(
                dref["report"]["loss"])
            worst, where, top = grad_err(dp["grads"], dref["grads"])
            pmax, nmax, noisy = 0.0, 0.0, 0
            ok = dl <= 1e-5 and worst <= TRAIN_TOL["float32"][1]
            for k, v in dref["params"].items():
                g = dref["grads"].get(k)
                noise = (np.zeros(v.shape, bool) if g is None
                         else np.abs(g) <= 1e-6 * top)
                diff = np.abs(dp["params"][k] - v)
                ok = ok and bool(np.all(diff[~noise] <= 1e-5 + 1e-5 * np.abs(
                    v[~noise]))) and bool(np.all(diff[noise] <= 2 * lr))
                pmax = max(pmax, float(diff[~noise].max(initial=0.0)))
                nmax = max(nmax, float(diff[noise].max(initial=0.0)))
                noisy += int(noise.sum())
            check(ok, f"5k dp 2 rank {r} path A f32 draws off: loss "
                  f"{dp['report']['loss']:.7f} vs one process "
                  f"{dref['report']['loss']:.7f} (rel {dl:.3g}, tol 1e-5); "
                  f"parameters after the step max diff {pmax:.3g} (tol 1e-5 "
                  f"+ 1e-5 |one process|; the {noisy} elements of gradient "
                  f"<= 1e-6 x {top:.3g}, rounding noise, {nmax:.3g}, held "
                  f"to 2 x lr {2 * lr}); gradients worst normalised diff "
                  f"{worst:.3g} at {where}")
        check(set(ranks[0]["dp"]["seeds"]).isdisjoint(ranks[1]["dp"]["seeds"])
              and not np.array_equal(ranks[0]["dp"]["bits"],
                                     ranks[1]["dp"]["bits"])
              and all(np.isfinite(rk["dp"]["drawn"]["loss"]) for rk in ranks),
              "5k dp 2 draws on: the ranks' layer seeds and random-mask bits "
              "for their graph 0 differ, losses "
              f"{[rk['dp']['drawn']['loss'] for rk in ranks]}")
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phases 4j / 5j / 5k: the parallel paths")

    # ---- 6. the engine: the CLI triple on synthetic ZINC at the ZINC-12k
    # split sizes, the flagship config as shipped (path A: K3; K4, K5)
    from egt_torch import do_evaluations, end_training, native, run_training
    from egt_torch.data import datasets as D
    from egt_torch.data.dataset import GraphDataset

    def engine(tmp: Path):
        sizes = {"training": 10_000, "validation": 1_000, "test": 1_000}
        erng = np.random.default_rng(2)
        cache = tmp / "cache"
        t = time.perf_counter()
        ds = GraphDataset(D.ZINC, str(tmp / "ZINC.h5"), str(cache),
                          splits=list(sizes))
        # no HDF5 file: the reader starts from its cache, written from
        # records (h5py need not be on the host)
        for split, n in sizes.items():
            ds.write_cache(split, synthetic.zinc_records(erng, n))
        print(f"  engine: wrote the cache of {sum(sizes.values())} synthetic "
              f"ZINC graphs in {time.perf_counter() - t:.1f} s", flush=True)

        # the native batch builder loaded, and its batch equals numpy's
        check(native.available(), "engine: the native batch builder loaded")
        first = next(ds.batches("training", raw["batch_size"], shuffle=True))
        swap, native.available = native.available, lambda: False
        try:
            ref = next(ds.batches("training", raw["batch_size"], shuffle=True))
        finally:
            native.available = swap
        check(sorted(first) == sorted(ref) and all(
            first[k].dtype == ref[k].dtype and np.array_equal(first[k], ref[k])
            for k in ref), "engine: the native batch equals the numpy batch")

        cfg = {**raw, "dataset_path": str(tmp / "ZINC.h5"),
               "cache_dir": str(cache), "save_path": str(tmp / "run"),
               "num_epochs": 2, "log_tensorboard": True}
        path = tmp / "config.json"

        def cli(main, **over):
            path.write_text(json.dumps({**cfg, **over}))
            return main([str(path)])

        bs = raw["batch_size"]
        steps = math.ceil(sizes["training"] / bs)
        val = math.ceil(sizes["validation"] / bs)
        evals = sum(math.ceil(n / (2 * bs)) for n in sizes.values())
        s1, _ = counted(lambda: cli(run_training.main),
                        dict(K3=20 * (steps + val), K4=20 * steps,
                             K5=20 * steps),
                        f"engine run_training, 2 epochs of {steps} steps and "
                        f"{val} validation batches")
        s2, _ = counted(lambda: cli(run_training.main, num_epochs=3),
                        dict(K3=10 * (steps + val), K4=10 * steps,
                             K5=10 * steps), "engine run_training, resumed "
                        "to epoch 3")
        s3, _ = counted(lambda: cli(do_evaluations.main, num_epochs=3,
                                    weight_file=""), dict(K3=10 * evals),
                        f"engine do_evaluations, {evals} batches")
        s4, _ = counted(lambda: cli(end_training.main, num_epochs=3), {},
                        "engine end_training")

        run_dir = tmp / "run"
        name = raw["model_name"]
        for rel in ("config/config.json", "config/config_input.json",
                    "summary.txt", f"saved/{name}.npz", "logs/metrics.jsonl",
                    "checkpoint/ckpt_3.pt", "checkpoint/train_state_3.json"):
            check((run_dir / rel).is_file(), f"engine: run dir holds {rel}")
        check(bool(list((run_dir / "logs").glob("events.out.tfevents.*"))),
              "engine: TensorBoard events written")
        check(s2.state["current_epoch"] == 3 and
              s2.state["global_step"] == 3 * steps and
              s2.state["save_best_value"] < float("inf"),
              f"engine: resumed to epoch 3 ({s2.state})")
        recs = [json.loads(x) for x in
                (run_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
        check(len(recs) == 3 and recs[2]["mae"] < recs[0]["mae"],
              "engine: training MAE by epoch "
              f"{[round(r['mae'], 5) for r in recs]}, val MAE "
              f"{[round(r['val_mae'], 5) for r in recs]}")
        for r in recs:
            check(all(np.isfinite(r[k]) for k in
                      ("loss", "mae", "val_loss", "val_mae")),
                  f"engine: epoch {r['epoch']} metrics finite")
        for split in ("trainset", "valset", "testset"):
            text = (run_dir / "predictions" / f"{split}_evals.txt").read_text()
            check("MAE = " in text, f"engine: {split}_evals.txt: "
                  f"{text.strip()}")

        # the saved weights serve, and predict what the trainer's model does
        predict = serving.load_predictor(str(path),
                                         str(run_dir / "saved" / f"{name}.npz"))
        batch = next(ds.batches("test", bs))
        served = predict(batch)
        with torch.inference_mode():
            own = s4.model({k: batch[k] for k in (
                "node_features", "feature_matrix", "graph_matrix")})
        diff = float(np.abs(served - own.float().cpu().numpy()).max())
        check(served.shape == (bs, 1) and np.isfinite(served).all()
              and diff <= MODEL_TOL["bfloat16"],
              f"engine: load_predictor on the saved npz against the "
              f"trainer's model, max diff {diff:.3g} (tol "
              f"{MODEL_TOL['bfloat16']})")

        # a step of the engine reads nothing back from the card
        tr = s4.trainer
        dbatch = s4._to_device(first)
        acc = M.DeviceAccumulator()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                tr.train_into(acc, [dbatch])
            tr.eval_into(acc, dbatch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(np.isfinite(acc.result()["loss"]),
              "engine: train_into and eval_into ran with CUDA synchronization "
              "as an error")

        for st in s1.epoch_stats + s2.epoch_stats:
            print(f"  engine epoch {st['epoch']}: {st['seconds']:.3f} s "
                  f"({st['train_seconds']:.3f} s training, {st['steps']} steps,"
                  f" {1e3 * st['train_seconds'] / st['steps']:.2f} ms a step),"
                  f" {st['graphs_per_s']:.1f} graphs/s, "
                  f"{st['wait_share']:.4f} of the training time waiting for "
                  f"the next batch [{smi}]", flush=True)
        return {**cfg, "num_epochs": 3}, sizes, evals

    # ---- 6h. `profile_dir` on phase 6's data: `run_training` of the
    # flagship config, 17 steps and one validation batch, traces global
    # steps 10 to 15 (JAX's window) with `torch.profiler`; the trace holds
    # K3's kernel 10 times a step for those 6 steps and nothing else of K3
    # (none from before step 10, none of the validation after step 16)
    def profile_run(tmp: Path, cfg: dict):
        trace = tmp / "trace"
        path = tmp / "profile.json"
        path.write_text(json.dumps({
            **cfg, "save_path": str(tmp / "profile_run"), "num_epochs": 1,
            "steps_per_epoch": 17, "validation_steps": 1,
            "log_tensorboard": False, "profile_dir": str(trace)}))
        t = time.perf_counter()
        counted(lambda: run_training.main([str(path)]),
                dict(K3=10 * 18, K4=10 * 17, K5=10 * 17),
                "profile_dir run_training, 17 steps and 1 validation batch")
        files = sorted(trace.glob("*.json"))
        check(len(files) == 1, f"profile_dir: trace files {files}")
        events = json.loads(files[0].read_text())["traceEvents"]
        k3 = [ev for ev in events if ev.get("cat") == "kernel"
              and "fused_layer_fwd" in ev.get("name", "")]
        busy = sum(ev.get("dur", 0) for ev in events
                   if ev.get("cat") == "kernel")
        check(len(k3) == 6 * 10,
              f"profile_dir: {len(k3)} K3 kernels in the trace of steps "
              f"10-15 (expected 60; {len(events)} events, "
              f"{busy / 1e3:.3f} ms of kernels; {files[0].name}, "
              f"{files[0].stat().st_size} B; the run "
              f"{time.perf_counter() - t:.1f} s) [{smi}]")

    # ---- 6j. the engine on two ranks: `torchrun --standalone
    # --nproc_per_node 2 -m egt_torch.run_training` of the flagship config
    # on phase 6's data with `distributed` true and `edge_partition` 2 (a
    # mesh of 1 x 2: each rank holds half the edge rows; both on this card,
    # over gloo): one epoch of 20 steps and 4 validation batches, rank 0's
    # checkpoint, logs and weights, then a resume to epoch 2
    def torchrun_run(tmp: Path, cfg: dict):
        path = tmp / "sp2.json"
        run_dir = tmp / "sp2_run"

        def launch(epochs):
            path.write_text(json.dumps({
                **cfg, "save_path": str(run_dir), "num_epochs": epochs,
                "steps_per_epoch": 20, "validation_steps": 4,
                "log_tensorboard": False, "distributed": True,
                "edge_partition": 2}))
            t = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", "2", "-m",
                 "egt_torch.run_training", str(path)],
                cwd=REPO, capture_output=True, text=True, timeout=600)
            text = res.stdout + res.stderr
            lines = [x for x in text.splitlines()
                     if x.startswith(("rank ", "Epoch ", "CHECKPOINT"))]
            print("\n".join(f"  torchrun: {x}" for x in lines), flush=True)
            check(res.returncode == 0, f"6j torchrun 2 ranks, {epochs} "
                  f"epoch(s): exit code {res.returncode} in "
                  f"{time.perf_counter() - t:.1f} s [{smi}]"
                  + ("" if res.returncode == 0 else "\n" + text[-4000:]))
            return text

        text = launch(1)
        check("backend gloo" in text and "1 data x 2 model" in text,
              "6j: both ranks on the card, gloo, a mesh of 1 data x 2 model")
        check((run_dir / "checkpoint" / "ckpt_1.pt").is_file(),
              "6j: rank 0 wrote checkpoint/ckpt_1.pt")
        launch(2)
        state = json.loads((run_dir / "checkpoint" /
                            "train_state_2.json").read_text())
        recs = [json.loads(x) for x in
                (run_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
        check(state["current_epoch"] == 2 and state["global_step"] == 40
              and len(recs) == 2 and all(np.isfinite(r["loss"]) and
                                         np.isfinite(r["val_loss"])
                                         for r in recs)
              and (run_dir / "saved" / f"{raw['model_name']}.npz").is_file(),
              f"6j: resumed to epoch 2 (state {state}), metrics "
              f"{[(round(r['loss'], 5), round(r['val_loss'], 5)) for r in recs]}"
              ", final weights written")

    # ---- 6g. the remaining entry points on the engine's ZINC run (its
    # final weights): the prediction dump, the serving artifacts of paths A
    # (K3), B (the `egt_simple` config: K1) and C (K1, K8) in bf16 and f32,
    # loaded in a fresh process, and the analysis capture
    from egt_torch.training.schemes import import_scheme

    def entry_points(tmp: Path, cfg: dict, sizes: dict, evals: int):
        run_dir = tmp / "run"
        final = run_dir / "saved" / f"{raw['model_name']}.npz"

        def scheme(over=(), device=None):
            c = {**cfg, **dict(over)}
            return import_scheme(c["scheme"])(c, device=device)

        # the prediction dump: K3 10 a batch; the test split's rows equal
        # predict_split's
        sp = scheme({"weight_file": ""})
        counted(sp.make_predictions, dict(K3=10 * evals),
                f"make_predictions, {evals} batches of the three splits")
        dumps = {}
        for split, n in zip(("trainset", "valset", "testset"),
                            sizes.values()):
            with np.load(run_dir / "predictions" /
                         f"{split}_predictions.npz") as data:
                dumps[split] = data["predictions"]
            check(dumps[split].shape == (n, 1)
                  and np.isfinite(dumps[split]).all(),
                  f"make_predictions: {split}_predictions.npz holds ({n}, 1) "
                  "finite predictions")
        rows = np.concatenate([out[b["sample_mask"] > 0]
                               for b, out in sp.predict_split("test")])
        diff = float(np.abs(dumps["testset"] - rows).max())
        check(diff <= 1e-6, f"make_predictions: the test split against "
              f"predict_split's outputs, max diff {diff:.3g}")

        # the serving artifacts: the requests are the test split's
        # prediction batches, at the artifact's shapes
        requests = list(sp._batches("test", shuffle=False))[:N_REQUESTS]
        req_path = tmp / "requests.npz"
        np.savez(req_path, **{f"{i}/{k}": v for i, r in enumerate(requests)
                              for k, v in r.items()})
        simple_raw = json.loads(SIMPLE_CONFIGS["zinc"].read_text())
        simple_npz = tmp / "egt_simple.npz"
        np.savez(simple_npz, **synthetic.random_flat_params(
            schemes.model_config_from_config(simple_raw)))
        simple = {**simple_raw, **{k: cfg[k] for k in (
            "dataset_path", "cache_dir", "log_tensorboard")}}
        paths = {"A": ({}, final, ("K3",)),
                 "B": (simple, simple_npz, ("K1",)),
                 "C": ({"use_pallas": True, "use_pallas_layer": False,
                        "use_pallas_edge": True}, final, ("K1", "K8"))}
        arts, live = {}, {}
        for tag, (over, npz, on) in paths.items():
            for dt in ("bfloat16", "float32"):
                name = f"{tag}_{dt}"
                econf = {**over, "compute_dtype": dt, "weight_file": str(npz),
                         "save_path": str(tmp / f"export_{name}")}
                t = time.perf_counter()
                art, _ = counted(
                    lambda: scheme(econf).export_serving(
                        str(tmp / f"{name}.pt2")), {},
                    f"export_serving, path {tag} {dt}: no launch while "
                    "tracing")
                print(f"  export path {tag} {dt}: "
                      f"{time.perf_counter() - t:.1f} s", flush=True)
                arts[name] = dict(path=art, on=on)
                predict = serving.load_predictor({**cfg, **econf}, str(npz))
                predict(requests[0])                       # warm-up
                torch.cuda.synchronize()

                def serve_live():
                    lat, outs = [], []
                    for r in requests:
                        t = time.perf_counter()
                        outs.append(predict(r))
                        lat.append(time.perf_counter() - t)
                    return lat, outs

                (lat, outs), _ = counted(
                    serve_live, {k: 10 * N_REQUESTS for k in on},
                    f"load_predictor, path {tag} {dt}, {N_REQUESTS} requests")
                live[name] = (lat, outs)
        spec_path = tmp / "artifacts.json"
        spec_path.write_text(json.dumps({n: a["path"] for n, a in
                                         arts.items()}))
        t = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", ARTIFACT_LOADER, str(spec_path),
             str(req_path), str(tmp / "served.npz"), str(N_REQUESTS)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        print(f"  artifact loader process: {time.perf_counter() - t:.1f} s, "
              f"exit {res.returncode}", flush=True)
        check(res.returncode == 0, "artifact loader process ran"
              + ("" if res.returncode == 0 else ": " + res.stderr[-2000:]))
        report = json.loads(res.stdout.strip().splitlines()[-1])
        check(report["imported"] == [], "artifact loader: no egt_torch."
              "models / schemes / training / utils and no jax imported "
              f"({report['imported']})")
        served = np.load(tmp / "served.npz")
        for name, art in arts.items():
            tag, dt = name.split("_")
            r = report["artifacts"][name]
            want = {k: 10 for k in art["on"]}
            check(r["graph_ops"] == {k: want.get(k, 0)
                                     for k in ("K3", "K1", "K8")},
                  f"artifact path {tag} {dt}: the exported graph holds "
                  f"{r['graph_ops']} kernel op nodes")
            per_request = {k: n / N_REQUESTS for k, n in r["launches"].items()
                           if n}
            check(per_request == want, f"artifact path {tag} {dt}: launches "
                  f"a request {per_request} (expected {want})")
            lat, outs = live[name]
            diff = max(float(np.abs(served[f"{name}/{i}"] - o).max())
                       for i, o in enumerate(outs))
            tol = 1e-6 if dt == "float32" else MODEL_TOL["bfloat16"]
            ok = all(served[f"{name}/{i}"].shape == o.shape
                     and np.isfinite(served[f"{name}/{i}"]).all()
                     for i, o in enumerate(outs))
            check(ok and diff <= tol, f"artifact path {tag} {dt}: served "
                  f"against load_predictor's live outputs, max diff "
                  f"{diff:.3g} (tol {tol})")
            art_lat = r["latency_s"]
            print(f"  request latency path {tag} {dt} ({len(requests[0]['node_features'])}"
                  f" graphs, 10 layers): artifact ms "
                  f"{[round(x * 1e3, 3) for x in art_lat]}, median "
                  f"{statistics.median(art_lat) * 1e3:.3f}; load_predictor ms "
                  f"{[round(x * 1e3, 3) for x in lat]}, median "
                  f"{statistics.median(lat) * 1e3:.3f} [{smi}]", flush=True)
            artifact_launches[name] = r["launches"]

        # analysis capture: the plain path, no kernel; as shipped (bf16)
        # the keys and shapes, then f32 on the card against the CPU
        keys = sorted(f"{k}_{i:0>2d}.{v}" for i in range(10) for k, v in (
            ("mha", "e"), ("mha", "mat"), ("attention_gates", "gates"),
            ("dense_edge_b", "e")))
        graphs = len(requests[0]["node_features"])
        pad = requests[0]["node_features"].shape[1]
        caps = {}
        for dt, device in (("bfloat16", None), ("float32", None),
                           ("float32", "cpu")):
            over = {"compute_dtype": dt, "weight_file": str(final),
                    "save_path": str(tmp / f"analysis_{dt}_{device}")}
            sa = scheme(over, device)
            path, _ = counted(lambda: sa.do_analysis("test", 1), {},
                              f"do_analysis {dt} on {device or 'the card'}: "
                              "no kernel launch under capture")
            with np.load(path) as data:
                caps[(dt, device)] = {k: data[k] for k in data.files}
            c = caps[(dt, device)]
            check(sorted(c) == keys and all(
                v.shape == (graphs, pad, pad, 8) and np.isfinite(v).all()
                for v in c.values()),
                  f"do_analysis {dt} on {device or 'the card'}: {len(c)} "
                  f"keys of ({graphs}, {pad}, {pad}, 8), finite")
        card, cpu = caps[("float32", None)], caps[("float32", "cpu")]
        diff = max(float(np.abs(card[k] - cpu[k]).max()) for k in keys)
        check(diff <= 1e-4, f"do_analysis f32: the card's captures against "
              f"the CPU's, max diff {diff:.3g} (tol 1e-4)")

    artifact_launches: dict = {}
    try:
        (REPO / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="engine-",
                                         dir=REPO / "build") as tmp:
            engine_out = engine(Path(tmp))
            try:
                entry_points(Path(tmp), *engine_out)
            except Exception:                       # noqa: BLE001 - report
                traceback.print_exc()
                check(False, "phase 6g: the remaining entry points")
            try:
                profile_run(Path(tmp), engine_out[0])
            except Exception:                       # noqa: BLE001 - report
                traceback.print_exc()
                check(False, "phase 6h: profile_dir")
            try:
                torchrun_run(Path(tmp), engine_out[0])
            except Exception:                       # noqa: BLE001 - report
                traceback.print_exc()
                check(False, "phase 6j: torchrun on two ranks")
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 6: engine")

    # ---- 6b. the engine on PATTERN: the CLI triple over synthetic PATTERN
    # graphs, cut from the published 10,000 / 2,000 / 2,000 to 1,280 / 256
    # / 256 and from 200 epochs to 1; both length buckets in every split
    # (the largest is cut to the split's largest graph, rounded up to 8)
    def engine_sbm(tmp: Path):
        kind, raw_k = "pattern", sbm_raw["pattern"]
        sizes = {"training": 1280, "validation": 256, "test": 256}
        erng = np.random.default_rng(6)
        cache = tmp / "cache"
        ds = GraphDataset(D.SBM_PATTERN, str(tmp / "SBM_PATTERN.h5"),
                          str(cache), splits=list(sizes))
        t = time.perf_counter()
        for split, n in sizes.items():
            ds.write_cache(split, synthetic.sbm_records(erng, n, kind))
        print(f"  engine (PATTERN): wrote the cache of "
              f"{sum(sizes.values())} synthetic PATTERN graphs in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        bs = raw_k["batch_size"]
        buckets = schemes.resolve_config(raw_k).length_buckets

        def pads(split, size):
            return [b["node_features"].shape[1] for b in
                    ds.batches(split, size, buckets=buckets)]

        for split in sizes:
            got = sorted(set(pads(split, bs)))
            check(len(got) == 2 and got[0] == min(buckets),
                  f"engine (PATTERN): {split} batches in both length "
                  f"buckets, pads {got}")
        steps, val = len(pads("training", bs)), len(pads("validation", bs))
        evals = sum(len(pads(split, 2 * bs)) for split in sizes)
        cfg = {**raw_k, "dataset_path": str(tmp / "SBM_PATTERN.h5"),
               "cache_dir": str(cache), "save_path": str(tmp / "run"),
               "num_epochs": 1, "log_tensorboard": False}
        path = tmp / "config.json"
        path.write_text(json.dumps(cfg))
        layers = raw_k["model_height"]
        s1, _ = counted(lambda: run_training.main([str(path)]),
                        dict(K3=layers * (steps + val), K4=layers * steps,
                             K5=layers * steps),
                        f"engine (PATTERN) run_training, 1 epoch of {steps} "
                        f"steps and {val} validation batches")
        path.write_text(json.dumps({**cfg, "weight_file": ""}))
        counted(lambda: do_evaluations.main([str(path)]),
                dict(K3=layers * evals),
                f"engine (PATTERN) do_evaluations, {evals} batches")
        counted(lambda: end_training.main([str(path)]), {},
                "engine (PATTERN) end_training")
        run_dir = tmp / "run"
        for rel in (f"saved/{raw_k['model_name']}.npz", "logs/metrics.jsonl",
                    "checkpoint/ckpt_1.pt"):
            check((run_dir / rel).is_file(),
                  f"engine (PATTERN): run dir holds {rel}")
        rec = json.loads((run_dir / "logs" / "metrics.jsonl").read_text())
        check(all(np.isfinite(rec[k]) for k in ("loss", "xent", "acc",
                                                 "val_loss", "val_xent",
                                                 "val_acc")),
              "engine (PATTERN): epoch 1 " + ", ".join(
                  f"{k} {rec[k]:.5f}" for k in ("loss", "acc", "val_xent",
                                                 "val_acc")))
        heads = ["Accuracy", "Micro Recall", "Macro Recall",
                 "Weighted Accuracy", "Log loss"]
        for split in ("trainset", "valset", "testset"):
            text = (run_dir / "predictions" / f"{split}_evals.txt").read_text()
            got = [ln.split(" =")[0].split(":")[0] for ln in text.splitlines()]
            check(got == heads, f"engine (PATTERN): {split}_evals.txt: "
                  + " | ".join(text.strip().splitlines()))
        for st in s1.epoch_stats:
            print(f"  engine (PATTERN) epoch {st['epoch']}: "
                  f"{st['seconds']:.3f} s ({st['train_seconds']:.3f} s "
                  f"training, {st['steps']} steps, "
                  f"{1e3 * st['train_seconds'] / st['steps']:.2f} ms a step),"
                  f" {st['graphs_per_s']:.1f} graphs/s, "
                  f"{st['wait_share']:.4f} of the training time waiting for "
                  f"the next batch [{smi}]", flush=True)

    try:
        with tempfile.TemporaryDirectory(prefix="engine-sbm-",
                                         dir=REPO / "build") as tmp:
            engine_sbm(Path(tmp))
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 6b: engine on PATTERN")

    # ---- 6c. the engine on MNIST: the CLI triple of `egt_spe.json` (the
    # SVD PE, 16 hops) over synthetic superpixel graphs, cut from the
    # published 55,000 / 5,000 / 10,000 to 2,560 / 512 / 512 and from 200
    # epochs to 1; the reader's SVD cache built here from the records
    # (numpy), as `run_training` would build it from HDF5
    def engine_sp(tmp: Path):
        path_k = REPO / "configs" / "main" / "mnist" / "100k" / "egt_spe.json"
        raw_k = json.loads(path_k.read_text())
        sizes = {"training": 2560, "validation": 512, "test": 512}
        erng = np.random.default_rng(7)
        cache = tmp / "cache"
        c = schemes.resolve_config(raw_k)
        ds = GraphDataset(D.MNIST, str(tmp / "MNIST.h5"), str(cache),
                          splits=list(sizes), pe="svd",
                          num_features=c.num_svd_features)
        t = time.perf_counter()
        for split, n in sizes.items():
            ds.write_cache(split, synthetic.superpixel_records(erng, n,
                                                               "mnist"))
        print(f"  engine (MNIST): wrote the SVD cache of "
              f"{sum(sizes.values())} synthetic superpixel graphs in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        bs = raw_k["batch_size"]
        steps = math.ceil(sizes["training"] / bs)
        val = math.ceil(sizes["validation"] / bs)
        evals = sum(math.ceil(n / (2 * bs)) for n in sizes.values())
        cfg = {**raw_k, "dataset_path": str(tmp / "MNIST.h5"),
               "cache_dir": str(cache), "save_path": str(tmp / "run"),
               "num_epochs": 1, "log_tensorboard": False}
        path = tmp / "config.json"
        path.write_text(json.dumps(cfg))
        layers = raw_k["model_height"]
        s1, _ = counted(lambda: run_training.main([str(path)]),
                        dict(K3=layers * (steps + val), K4=layers * steps,
                             K5=layers * steps),
                        f"engine (MNIST) run_training, 1 epoch of {steps} "
                        f"steps and {val} validation batches")
        check(s1.pad_len == 75, f"engine (MNIST): pad {s1.pad_len}")
        path.write_text(json.dumps({**cfg, "weight_file": ""}))
        counted(lambda: do_evaluations.main([str(path)]),
                dict(K3=layers * evals),
                f"engine (MNIST) do_evaluations, {evals} batches")
        counted(lambda: end_training.main([str(path)]), {},
                "engine (MNIST) end_training")
        run_dir = tmp / "run"
        for rel in (f"saved/{raw_k['model_name']}.npz", "logs/metrics.jsonl",
                    "checkpoint/ckpt_1.pt"):
            check((run_dir / rel).is_file(),
                  f"engine (MNIST): run dir holds {rel}")
        rec = json.loads((run_dir / "logs" / "metrics.jsonl").read_text())
        keys = ("loss", "xent", "acc", "val_loss", "val_xent", "val_acc")
        check(all(np.isfinite(rec[k]) for k in keys),
              "engine (MNIST): epoch 1 " + ", ".join(
                  f"{k} {rec[k]:.5f}" for k in keys))
        for split, name in (("trainset", "training"),
                            ("valset", "validation"), ("testset", "test")):
            text = (run_dir / "predictions" / f"{split}_evals.txt").read_text()
            got = [ln.split(" =")[0] for ln in text.splitlines()]
            check(got == [f"{name} accuracy", f"{name} crossentropy"],
                  f"engine (MNIST): {split}_evals.txt: "
                  + " | ".join(text.strip().splitlines()))
        for st in s1.epoch_stats:
            print(f"  engine (MNIST) epoch {st['epoch']}: "
                  f"{st['seconds']:.3f} s ({st['train_seconds']:.3f} s "
                  f"training, {st['steps']} steps, "
                  f"{1e3 * st['train_seconds'] / st['steps']:.2f} ms a step),"
                  f" {st['graphs_per_s']:.1f} graphs/s, "
                  f"{st['wait_share']:.4f} of the training time waiting for "
                  f"the next batch (Prefetcher.waited) [{smi}]", flush=True)

    try:
        with tempfile.TemporaryDirectory(prefix="engine-sp-",
                                         dir=REPO / "build") as tmp:
            engine_sp(Path(tmp))
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 6c: engine on MNIST")

    # ---- 6d. the engine on TSP: the CLI triple of the 100k `egt_spe.json`
    # (4 layers, the SVD PE) over synthetic TSP graphs, cut from the
    # published 10,000 / 1,000 / 1,000 to 240 / 48 / 48 and from 100 epochs
    # to 1; every length bucket in every split (the largest cut to the
    # split's largest graph, rounded up to 8, as the reader does); the
    # reader's SVD cache built here from the records
    def engine_tsp(tmp: Path):
        raw_k = json.loads((TSP_DIR / "100k" / "egt_spe.json").read_text())
        sizes = {"training": 240, "validation": 48, "test": 48}
        erng = np.random.default_rng(8)
        cache = tmp / "cache"
        c = schemes.resolve_config(raw_k)
        ds = GraphDataset(D.TSP, str(tmp / "TSP.h5"), str(cache),
                          splits=list(sizes), pe="svd",
                          num_features=c.num_svd_features)
        t = time.perf_counter()
        for split, n in sizes.items():
            ds.write_cache(split, synthetic.tsp_records(erng, n))
        print(f"  engine (TSP): wrote the SVD cache of {sum(sizes.values())} "
              f"synthetic TSP graphs in {time.perf_counter() - t:.1f} s",
              flush=True)
        bs, buckets = c.batch_size, c.length_buckets

        def pads(split, size):
            return [b["node_features"].shape[1] for b in
                    ds.batches(split, size, buckets=buckets)]

        for split in sizes:
            got = sorted(set(pads(split, bs)))
            check(len(got) == 3 and got[:2] == buckets[:2],
                  f"engine (TSP): {split} batches in all three length "
                  f"buckets, pads {got}")
        steps, val = len(pads("training", bs)), len(pads("validation", bs))
        evals = sum(len(pads(split, c.prediction_bmult * bs))
                    for split in sizes)
        cfg = {**raw_k, "dataset_path": str(tmp / "TSP.h5"),
               "cache_dir": str(cache), "save_path": str(tmp / "run"),
               "num_epochs": 1, "log_tensorboard": False}
        path = tmp / "config.json"
        path.write_text(json.dumps(cfg))
        layers = raw_k["model_height"]
        s1, _ = counted(lambda: run_training.main([str(path)]),
                        dict(K3=layers * (steps + val), K4=layers * steps,
                             K5=layers * steps),
                        f"engine (TSP) run_training, 1 epoch of {steps} "
                        f"steps and {val} validation batches")
        path.write_text(json.dumps({**cfg, "weight_file": ""}))
        counted(lambda: do_evaluations.main([str(path)]),
                dict(K3=layers * evals),
                f"engine (TSP) do_evaluations, {evals} batches")
        counted(lambda: end_training.main([str(path)]), {},
                "engine (TSP) end_training")
        run_dir = tmp / "run"
        for rel in (f"saved/{raw_k['model_name']}.npz", "logs/metrics.jsonl",
                    "checkpoint/ckpt_1.pt"):
            check((run_dir / rel).is_file(),
                  f"engine (TSP): run dir holds {rel}")
        rec = json.loads((run_dir / "logs" / "metrics.jsonl").read_text())
        keys = ("loss", "xent", "acc", "val_loss", "val_xent", "val_acc")
        check(all(np.isfinite(rec[k]) for k in keys),
              "engine (TSP): epoch 1 " + ", ".join(
                  f"{k} {rec[k]:.5f}" for k in keys))
        for split in ("trainset", "valset", "testset"):
            text = (run_dir / "predictions" / f"{split}_evals.txt").read_text()
            got = [ln.split(" = ")[0] for ln in text.splitlines()]
            check(got == ["Accuracy", "Precision", "Recall", "f1"],
                  f"engine (TSP): {split}_evals.txt: "
                  + " | ".join(text.strip().splitlines()))
        for st in s1.epoch_stats:
            print(f"  engine (TSP) epoch {st['epoch']}: "
                  f"{st['seconds']:.3f} s ({st['train_seconds']:.3f} s "
                  f"training, {st['steps']} steps, "
                  f"{1e3 * st['train_seconds'] / st['steps']:.2f} ms a step),"
                  f" {st['graphs_per_s']:.1f} graphs/s, "
                  f"{st['wait_share']:.4f} of the training time waiting for "
                  f"the next batch (Prefetcher.waited) [{smi}]", flush=True)

    try:
        with tempfile.TemporaryDirectory(prefix="engine-tsp-",
                                         dir=REPO / "build") as tmp:
            engine_tsp(Path(tmp))
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 6d: engine on TSP")

    def engine_triple(tag, tmp, cfg, name, pad, steps, val, evals, layers,
                      micro=1):
        """The CLI triple of `cfg` (its reader's cache written in `tmp`):
        run_training for 1 epoch of `steps` optimizer steps of `micro`
        micro-batches and `val` validation batches, again to epoch 2
        (resume), do_evaluations (`evals` batches) and end_training; K1 /
        K2 launches one a layer a micro-batch (K1 also a validation and
        evaluation batch); the dataset and pad, the resumed state, the run
        directory, finite metrics, the MAE lines and each epoch's seconds,
        graphs/s and wait share."""
        path = tmp / "config.json"

        def cli(main, **over):
            path.write_text(json.dumps({**cfg, **over}))
            return main([str(path)])

        n = steps * micro
        epoch = dict(K1=layers * (n + val), K2=layers * n)
        s1, _ = counted(lambda: cli(run_training.main), epoch,
                        f"engine ({tag}) run_training, 1 epoch of {steps} "
                        f"steps of {micro} x {cfg['batch_size']} graphs and "
                        f"{val} validation batches")
        s2, _ = counted(lambda: cli(run_training.main, num_epochs=2), epoch,
                        f"engine ({tag}) run_training, resumed to epoch 2")
        check(s1.DATASET_SPEC.name == name and s1.pad_len == pad,
              f"engine ({tag}): dataset {s1.DATASET_SPEC.name}, pad "
              f"{s1.pad_len}")
        check(s2.state["current_epoch"] == 2 and
              s2.state["global_step"] == 2 * steps,
              f"engine ({tag}): resumed to epoch 2 ({s2.state})")
        counted(lambda: cli(do_evaluations.main, num_epochs=2,
                            weight_file=""), dict(K1=layers * evals),
                f"engine ({tag}) do_evaluations, {evals} batches")
        counted(lambda: cli(end_training.main, num_epochs=2), {},
                f"engine ({tag}) end_training")
        run_dir = Path(cfg["save_path"])
        for rel in (f"saved/{cfg['model_name']}.npz", "logs/metrics.jsonl",
                    "checkpoint/ckpt_2.pt"):
            check((run_dir / rel).is_file(),
                  f"engine ({tag}): run dir holds {rel}")
        recs = [json.loads(x) for x in
                (run_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
        keys = ("loss", "mae", "val_loss", "val_mae")
        check(len(recs) == 2 and all(np.isfinite(r[k]) for r in recs
                                     for k in keys),
              f"engine ({tag}): " + "; ".join(
                  f"epoch {r['epoch']} " + ", ".join(
                      f"{k} {r[k]:.5f}" for k in keys) for r in recs))
        for split in ("trainset", "valset", "testset"):
            text = (run_dir / "predictions" / f"{split}_evals.txt").read_text()
            check(" MAE = " in text, f"engine ({tag}): {split}_evals.txt: "
                  f"{text.strip()}")
        for st in s1.epoch_stats + s2.epoch_stats:
            print(f"  engine ({tag}) epoch {st['epoch']}: "
                  f"{st['seconds']:.3f} s ({st['train_seconds']:.3f} s "
                  f"training, {st['steps']} steps, "
                  f"{1e3 * st['train_seconds'] / st['steps']:.2f} ms a step),"
                  f" {st['graphs_per_s']:.1f} graphs/s, "
                  f"{st['wait_share']:.4f} of the training time waiting for "
                  f"the next batch (Prefetcher.waited) [{smi}]", flush=True)

    def write_caches(tag, tmp, spec, sizes, records):
        """The reader's cache of each split, written from `records(n)`."""
        ds = GraphDataset(spec, str(tmp / f"{spec.name}.h5"),
                          str(tmp / "cache"), splits=list(sizes))
        t = time.perf_counter()
        for split, n in sizes.items():
            ds.write_cache(split, records(n))
        print(f"  engine ({tag}): wrote the cache of {sum(sizes.values())} "
              f"synthetic graphs in {time.perf_counter() - t:.1f} s",
              flush=True)
        return {"dataset_path": str(tmp / f"{spec.name}.h5"),
                "cache_dir": str(tmp / "cache"),
                "save_path": str(tmp / "run"), "log_tensorboard": False,
                "num_epochs": 1}

    # ---- 6e. the engine on ZINC-full: the CLI triple of the `egt_simple`
    # config (the `bias` channel: K1 forward, K2 backward) over synthetic
    # ZINC-full graphs, cut from the published 220,011 / 24,445 / 5,000 to
    # 10,000 / 1,000 / 1,000 and from 200 epochs to 1, resumed to 2,
    # evaluated and finalized
    def engine_zinc_full(tmp: Path):
        raw_k = json.loads((SIMPLE_DIR / "zinc_full" / "500k" /
                            "egt_simple.json").read_text())
        sizes = {"training": 10_000, "validation": 1_000, "test": 1_000}
        erng = np.random.default_rng(9)
        paths = write_caches("ZINC-full", tmp, D.ZINC_FULL, sizes,
                             lambda n: synthetic.zinc_records(erng, n))
        bs = raw_k["batch_size"]
        engine_triple(
            "ZINC-full", tmp, {**raw_k, **paths}, "ZINC_full", PAD,
            math.ceil(sizes["training"] / bs),
            math.ceil(sizes["validation"] / bs),
            sum(math.ceil(n / (2 * bs)) for n in sizes.values()),
            raw_k["model_height"])

    try:
        with tempfile.TemporaryDirectory(prefix="engine-zinc-full-",
                                         dir=REPO / "build") as tmp:
            engine_zinc_full(Path(tmp))
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 6e: engine on ZINC-full")

    # ---- 6f. the engine on PCQM4Mv2: the CLI triple of EGT-Large with the
    # kernel knob on, micro-batches of 128, 8 an optimizer step, over
    # synthetic molecules cut from the published 3,378,606 / 73,545 / 147,037
    # to 8,192 / 1,024 / 1,024 and from 300 epochs to 1, resumed to 2,
    # evaluated and finalized
    def engine_pcqm(tmp: Path):
        sizes = {"training": 8_192, "validation": 1_024, "test": 1_024}
        erng = np.random.default_rng(12)
        paths = write_caches("PCQM4Mv2", tmp, D.PCQM4MV2, sizes,
                             lambda n: synthetic.pcqm_records(erng, n))
        bs, A = PCQM_MICRO, PCQM_ACCUM
        engine_triple(
            "PCQM4Mv2", tmp, {**pcqm_train, **paths}, "PCQM4MV2",
            synthetic.PCQM_NODES[1], sizes["training"] // (bs * A),
            math.ceil(sizes["validation"] / bs),
            sum(math.ceil(n / (2 * bs)) for n in sizes.values()),
            pcqm_raw["model_height"], micro=A)

    try:
        with tempfile.TemporaryDirectory(prefix="engine-pcqm-",
                                         dir=REPO / "build") as tmp:
            engine_pcqm(Path(tmp))
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 6f: engine on PCQM4Mv2")

    # ---- 7. kernels line: the training-mode cases at the flagship shape,
    # bf16, each kernel's launches on its training path
    rows = []
    for key, case, part, source, replaces in (
            ("K1", "attention", "fwd", "egt_torch/csrc/egt_attention_fwd.cu",
             "egt_tpu/ops/egt_pallas.py:116"),
            ("K2", "attention", "bwd", "egt_torch/csrc/egt_attention_bwd.cu",
             "egt_tpu/ops/egt_pallas.py:184"),
            ("K3", "layer", "fwd", "egt_torch/csrc/fused_layer_fwd.cu",
             "egt_tpu/ops/fused_layer_pallas.py:373"),
            ("K4", "layer", "tail", "egt_torch/csrc/fused_layer_bwd_tail.cu",
             "egt_tpu/ops/fused_layer_pallas.py:789"),
            ("K5", "layer", "attn", "egt_torch/csrc/fused_layer_bwd_attn.cu",
             "egt_tpu/ops/fused_layer_pallas.py:868"),
            ("K6", "layer", "mono", "egt_torch/csrc/fused_layer_bwd_mono.cu",
             "egt_tpu/ops/fused_layer_pallas.py:438"),
            ("K7", "layer", "merged",
             "egt_torch/csrc/fused_layer_bwd_merged.cu",
             "egt_tpu/ops/fused_layer_pallas.py:1021"),
            ("K8", "edge", "fwd", "egt_torch/csrc/edge_block_fwd.cu",
             "egt_tpu/ops/edge_block_pallas.py:92"),
            ("K9", "edge", "bwd", "egt_torch/csrc/edge_block_bwd.cu",
             "egt_tpu/ops/edge_block_pallas.py:101")):
        key_ = (case, torch.bfloat16) if case == "edge" else \
            (case, torch.bfloat16, True)
        r = results.get(key_, {}).get(part)
        if r is None or key not in train_launches:
            continue
        rows.append({"name": Path(source).stem, "route": "cuda",
                     "source": source, "replaces": replaces,
                     "launches": train_launches[key], **r,
                     "library_ms": None})
    # K3, K4 and K5 at the SBM shapes: the bf16 training-mode cases of
    # phase 3d, with PATTERN's launches in that bucket (phase 5b)
    for l in SBM_BUCKETS:
        for key, part, source, replaces in (
                ("K3", "fwd", "egt_torch/csrc/fused_layer_fwd.cu",
                 "egt_tpu/ops/fused_layer_pallas.py:373"),
                ("K4", "tail", "egt_torch/csrc/fused_layer_bwd_tail.cu",
                 "egt_tpu/ops/fused_layer_pallas.py:789"),
                ("K5", "attn", "egt_torch/csrc/fused_layer_bwd_attn.cu",
                 "egt_tpu/ops/fused_layer_pallas.py:868")):
            r = results.get(("layer_sbm", l, torch.bfloat16, True),
                            {}).get(part)
            n = sbm_launches.get("pattern", {}).get(l, {}).get(key)
            if r is None or n is None:
                continue
            rows.append({"name": f"{Path(source).stem} (PATTERN, l {l})",
                         "route": "cuda", "source": source,
                         "replaces": replaces, "launches": n, **r,
                         "library_ms": None})
    # K3, K4 and K5 at the superpixel pads: the bf16 training-mode cases of
    # phase 3e, with MNIST's (l 75) and CIFAR10's (l 150) launches in their
    # timed steps (phase 5c)
    for l, kind in SP_KIND.items():
        for key, part, source, replaces in (
                ("K3", "fwd", "egt_torch/csrc/fused_layer_fwd.cu",
                 "egt_tpu/ops/fused_layer_pallas.py:373"),
                ("K4", "tail", "egt_torch/csrc/fused_layer_bwd_tail.cu",
                 "egt_tpu/ops/fused_layer_pallas.py:789"),
                ("K5", "attn", "egt_torch/csrc/fused_layer_bwd_attn.cu",
                 "egt_tpu/ops/fused_layer_pallas.py:868")):
            r = results.get(("layer_sp", l, torch.bfloat16, True),
                            {}).get(part)
            n = sp_launches.get(kind, {}).get(key)
            if r is None or n is None:
                continue
            rows.append({"name": f"{Path(source).stem} ({kind.upper()}, "
                                 f"l {l})",
                         "route": "cuda", "source": source,
                         "replaces": replaces, "launches": n, **r,
                         "library_ms": None})
    # K3, K4 and K5 at the TSP pads: the bf16 training-mode cases of phase
    # 3f, with TSP 500k's launches in that bucket's timed steps (phase 5d)
    for l in TSP_BUCKETS:
        for key, part, source, replaces in (
                ("K3", "fwd", "egt_torch/csrc/fused_layer_fwd.cu",
                 "egt_tpu/ops/fused_layer_pallas.py:373"),
                ("K4", "tail", "egt_torch/csrc/fused_layer_bwd_tail.cu",
                 "egt_tpu/ops/fused_layer_pallas.py:789"),
                ("K5", "attn", "egt_torch/csrc/fused_layer_bwd_attn.cu",
                 "egt_tpu/ops/fused_layer_pallas.py:868")):
            r = results.get(("layer_tsp", l, torch.bfloat16, True),
                            {}).get(part)
            n = tsp_launches.get(l, {}).get(key)
            if r is None or n is None:
                continue
            rows.append({"name": f"{Path(source).stem} (TSP, l {l})",
                         "route": "cuda", "source": source,
                         "replaces": replaces, "launches": n, **r,
                         "library_ms": None})
    # K1 and K2 at the `egt_simple` shapes: the bf16 training-mode cases of
    # phase 3g, with the launches of phase 5e's timed steps at that shape
    for fam, (kind, l) in SIMPLE_RUNS.items():
        for key, part, source, replaces in (
                ("K1", "fwd", "egt_torch/csrc/egt_attention_fwd.cu",
                 "egt_tpu/ops/egt_pallas.py:116"),
                ("K2", "bwd", "egt_torch/csrc/egt_attention_bwd.cu",
                 "egt_tpu/ops/egt_pallas.py:184")):
            r = results.get(("attention_simple", fam, torch.bfloat16, True),
                            {}).get(part)
            n = simple_launches.get(kind, {}).get(l, {}).get(key)
            if r is None or n is None:
                continue
            rows.append({"name": f"{Path(source).stem} (egt_simple {fam})",
                         "route": "cuda", "source": source,
                         "replaces": replaces, "launches": n, **r,
                         "library_ms": None})
    # K1 and K2 at the PCQM4Mv2 tile: the bf16 training-mode cases of phase
    # 3h, with the launches of phase 5f's timed steps (l 36) and of its
    # micro-batch at l 60
    for l in PCQM_PADS:
        for key, part, source, replaces in (
                ("K1", "fwd", "egt_torch/csrc/egt_attention_fwd.cu",
                 "egt_tpu/ops/egt_pallas.py:116"),
                ("K2", "bwd", "egt_torch/csrc/egt_attention_bwd.cu",
                 "egt_tpu/ops/egt_pallas.py:184")):
            r = results.get(("attention_pcqm", l, torch.bfloat16, True),
                            {}).get(part)
            n = pcqm_launches.get(l, {}).get(key)
            if r is None or n is None:
                continue
            rows.append({"name": f"{Path(source).stem} (PCQM4Mv2, l {l})",
                         "route": "cuda", "source": source,
                         "replaces": replaces, "launches": n, **r,
                         "library_ms": None})
    # K1 and K2 on the row blocks of edge partitioning: the bf16
    # training-mode cases of phase 3i, with rank 0's launches in phase 5j's
    # timed steps (ZINC and TSP with `edge_partition` 2)
    for fam, n in ep_launches.items():
        for key, part, source, replaces in (
                ("K1", "fwd", "egt_torch/csrc/egt_attention_fwd.cu",
                 "egt_tpu/ops/egt_pallas.py:116"),
                ("K2", "bwd", "egt_torch/csrc/egt_attention_bwd.cu",
                 "egt_tpu/ops/egt_pallas.py:184")):
            r = results.get(("attention_rows", fam, torch.bfloat16, True),
                            {}).get(part)
            if r is None or not n.get(key):
                continue
            rows.append({"name": f"{Path(source).stem} ({fam} row block, "
                                 "edge_partition 2)",
                         "route": "cuda", "source": source,
                         "replaces": replaces, "launches": n[key], **r,
                         "library_ms": None})
    # K3, K1 and K8 in the bf16 serving artifacts of phase 6g: their
    # inference cases of phase 3 (128 graphs; K1 at the `egt_simple` ZINC
    # tile of phase 3g), with the artifact's launches in its requests
    for key, tag, part, res_key, source, replaces in (
            ("K3", "A", "fwd", ("layer", torch.bfloat16, False),
             "egt_torch/csrc/fused_layer_fwd.cu",
             "egt_tpu/ops/fused_layer_pallas.py:373"),
            ("K1", "B", "fwd",
             ("attention_simple", "ZINC", torch.bfloat16, False),
             "egt_torch/csrc/egt_attention_fwd.cu",
             "egt_tpu/ops/egt_pallas.py:116"),
            ("K8", "C", "fwd", ("edge", torch.bfloat16),
             "egt_torch/csrc/edge_block_fwd.cu",
             "egt_tpu/ops/edge_block_pallas.py:92")):
        r = results.get(res_key, {}).get(part)
        n = artifact_launches.get(f"{tag}_bfloat16", {}).get(key)
        if r is None or not n:
            continue
        rows.append({"name": f"{Path(source).stem} (serving artifact, path "
                             f"{tag})", "route": "cuda", "source": source,
                     "replaces": replaces, "launches": n, **r,
                     "library_ms": None})
    # the variants of phases 4h / 5h and `remat` (phase 5i) at the flagship
    # ZINC shapes: phase 3's bf16 training-mode cases (their shapes are the
    # variants'), with the launches of each variant's timed steps, and K3's
    # a step under `remat` (the forward's and the recompute's)
    flagship = {
        "K1": (("attention", torch.bfloat16, True), "fwd",
               "egt_torch/csrc/egt_attention_fwd.cu",
               "egt_tpu/ops/egt_pallas.py:116"),
        "K2": (("attention", torch.bfloat16, True), "bwd",
               "egt_torch/csrc/egt_attention_bwd.cu",
               "egt_tpu/ops/egt_pallas.py:184"),
        "K3": (("layer", torch.bfloat16, True), "fwd",
               "egt_torch/csrc/fused_layer_fwd.cu",
               "egt_tpu/ops/fused_layer_pallas.py:373"),
        "K4": (("layer", torch.bfloat16, True), "tail",
               "egt_torch/csrc/fused_layer_bwd_tail.cu",
               "egt_tpu/ops/fused_layer_pallas.py:789"),
        "K5": (("layer", torch.bfloat16, True), "attn",
               "egt_torch/csrc/fused_layer_bwd_attn.cu",
               "egt_tpu/ops/fused_layer_pallas.py:868"),
        "K8": (("edge", torch.bfloat16), "fwd",
               "egt_torch/csrc/edge_block_fwd.cu",
               "egt_tpu/ops/edge_block_pallas.py:92"),
        "K9": (("edge", torch.bfloat16), "bwd",
               "egt_torch/csrc/edge_block_bwd.cu",
               "egt_tpu/ops/edge_block_pallas.py:101")}
    runs = [(tag.split(" (")[0], n) for tag, n in variant_launches.items()]
    if True in remat_runs:
        runs.append(("remat, f32 step", {"K3": remat_runs[True][2]["K3"]}))
    for what, launches in runs:
        for key, (res_key, part, source, replaces) in flagship.items():
            r = results.get(res_key, {}).get(part)
            if r is None or not launches.get(key):
                continue
            rows.append({"name": f"{Path(source).stem} ({what})",
                         "route": "cuda", "source": source,
                         "replaces": replaces, "launches": launches[key],
                         **r, "library_ms": None})
    print(json.dumps({"kernels": rows}))

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
