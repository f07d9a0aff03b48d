#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: require CUDA, print the card's name and power limit, turn TF32
     off, build the CUDA kernels from point_cloud_reid_tpu_torch/csrc;
  2. kernels: every kernel against its plain PyTorch version at the shapes
     its main path gives it, with errors, tolerances and times (`ms`:
     CUDA events around calls from Python, tools/timing.time_ms, for every
     row; the kNN, attention and FPS rows, which the host paces, also give
     the device time of a CUDA graph of calls, `device_ms`):
     the serving path's (SA stages at B=128 crops, the 128 x 128 grid, a
     512-pair list) and the training path's (kNN at the three SA shapes of
     512 crops, linear attention at 256 pairs with its gradients), and kNN
     at the serving shapes (B=128 and 256 crops) beside the tracker's
     knn_indices(..., "argsort");
  3. serving path: the flagship model (full widths, seeded random weights)
     behind TrackingManager.step over two synthetic scenes of 10 frames
     (96 objects x 600 points): gated sparse scoring ('auto', pair kernel)
     and dense scoring ('never', 128 x 128 grid kernel). Checks finite
     logits, launch counts, and one frame's logits against the plain
     composition;
  4. training path: the flagship with knn_method 'pallas' and both cross
     stages 'linear-pallas' (the CUDA kernels), losses match + kl + triplet,
     256 pairs of 128 points a step through Trainer.fit. Checks finite
     losses and gradient norms, that weights and BatchNorm statistics moved,
     3 kNN and 4 attention launches per forward, and step 1 against the same
     step with both knobs off;
  5. image kernels and image path: the image instantiation of the match
     kernel (no position term, S tokens) on 64 x 64 grids at S=197 and
     S=198, on the dense frame's 128 x 64 grid at S=197 and on a 512-pair
     list, each against its plain version, and farthest point sampling
     at FPS_SHAPES (the three SA shapes of 128 and 512 crops, N = 1024 and
     1025, dense crops of 2048 points, 16,384 and 20,000 points), indices
     equal to the plain loop's, one device kernel a call; then the image
     model (deit-tiny-no-pt at full width) behind TrackingManager.step over
     the bench's six-camera scene (64 objects, six 900 x 1600 uint8 frames,
     10 frames), dense ('never', image grid kernel) and sparse ('always',
     image pair kernel), the frame's upload inside the clock. Checks launch
     counts, finite logits, one frame's logits against plain scoring and a
     CPU plain crop + embed of 4 detections;
  6. FPS path: 128 crops of 128 points through three SetAbstractionEdgeSA
     stages of the flagship's widths built with sampling="FPS" and
     knn_method="pallas". Checks 3 FPS and 3 kNN launches and no SA-kernel
     launch, and centres and features against the same stages on plain FPS;
  7. tracker host path: the flagship behind TrackingManager(device_cache=
     False) over the serving scene (the host FeatureCache frame, timed
     beside phase 3's device-cache frame); tools/track.py over an .npz
     scene with gt ids and near-duplicate detections, from a checkpoint
     written by Trainer.save_checkpoint, with BEV NMS (timed), Hungarian
     matching and sparse 'auto'; 10 frames of the image tracker on the host
     cache. Checks SA, grid and image-grid launches, the last host frames'
     logits against plain scoring, that NMS dropped exactly the duplicates,
     one tracks.jsonl line a frame.
  8. data path: the native crop loader built (g++) from the port's copy and
     its 512-crop batch equal to the plain numpy version bit for bit; an
     on-disk store written by tools/make_synthetic_data.py (nuScenes
     classes, 2,500 objects x 6 frames); tools/train.py --root for one epoch
     (5 steps of 256 pairs, the three kernel knobs set by --set) and
     tools/test.py over the store's ValEvenPairs from its checkpoint. Checks
     that every train batch came through PairDataset.sample_batch and the
     native reader, 3 kNN and 4 attention launches a step, finite losses,
     moved weights and BatchNorm statistics, the checkpoint, the eval
     report's metrics and strata, 3 SA launches an eval batch, and the val
     logits against the same checkpoint's plain run on the card (knobs off,
     the SA stages' plain version) to EVAL_TOL; prints the step time, the
     loader waits, the loader's own pairs/s and the eval's.
  9. the rest of the flagship family: kNN past 128 points (tiers S and G
     of csrc/knn.cu) at FAMILY_KNN on exact, duplicated and random clouds
     beside cdist + topk; the match chain's rows tier (csrc/match_rows.cu:
     the wgmma tier of csrc/match_rows_wg.cuh) at C = 128 (a 128 x 128 grid
     and 512 pairs of the 7M model's embeddings) and at C = 64, N = 2048 (a
     16 x 16 grid and 512 pairs of the 2048-point ablation's), pairs equal
     to their grid cells, with the tier's name, shared bytes a block and
     ptxas's registers and spills; the SA
     kernel at SA1 of 512 crops of 2048 points and at the 7M model's
     widths; linear attention at L = S = 2048 and at d_model 128. Then,
     with every count at 0: the 7M leaf behind TrackingManager.step over
     the serving scene, dense ('never', the 128 x 128 grid at C = 128) and
     sparse ('auto'), step ms, device ms and busy share of two profiled
     frames, one frame against plain scoring; tools/track.py serving the
     2048-point ablation with --subsample 2048 (sparse 'auto', the rows
     tier), one frame against plain scoring; no launch of the first rows
     kernel (tier rows_mma, kept for C = 16); FAMILY_STEPS train steps of
     the ablation and of the 7M leaf with both kernel knobs on, at the
     largest pair count up to 256 that fits, 3 kNN and 4 attention
     launches a step, step 1 against the knobs off to TRAIN_TOL, step ms
     and peak memory.
 10. bf16 serving: the flagship, the DeiT-tiny leaf, the 7M leaf and the
     2048-point ablation built at a bf16 compute dtype from the same seeded
     float32 weights; the bf16 kernels (csrc/sa_stage_bf16.cu,
     csrc/match_grid_bf16.cu, csrc/match_rows_bf16.cu) against their bf16
     plain versions to BF16_TOL at the serving shapes (SA1-3 at B=128, the
     128 x 128 grid, 512 pairs, the image grid 128 x 64 at S=197, 512
     image pairs; the rows tier's 128 x 128 grid and 512 pairs at C = 128
     and its 16 x 16 grid and 512 pairs at C = 64, N = 2048; pairs equal
     to their grid cells bit for bit); then, with every count at 0, the
     point scene dense and sparse and the image scene dense and sparse
     through TrackingManager at bf16 (step ms), the 7M leaf two frames
     dense and two sparse, and tools/track.py --bf16 serving the 2048-point
     ablation at --subsample 2048 (5 frames, 16 objects): the bf16 kernels
     launched (the wgmma rows tier by the last two), no float32 kernel and
     no first rows kernel, and each
     scene's last frame against the float32 port on the same crops
     (BF16_LOGIT_TOL).
 11. training at bf16 and the image leaves, with every count at 0: the
     flagship at bf16 with the knobs on, TRAIN_STEPS steps of phase 4's
     pairs (finite logs, moved weights and statistics, float32 parameters,
     3 kNN and 4 attention launches a step; median step ms and peak memory
     beside phase 4's float32 ones; step 1 against the same bf16 step with
     the knobs off to BF16_TRAIN_TOL and against phase 4's float32 step 1
     to BF16_F32_TRAIN_TOL); the rgb_ DeiT-tiny leaf at the JAX bench's 60
     pairs, float32 and bf16, with its full loss set (step ms, peak);
     tools/train.py --bf16 for one epoch on phase 8's store and
     tools/test.py --bf16 from its checkpoint (the bf16 SA kernel 3 times
     an eval batch, no float32 SA launch), then the image leaf through
     tools/train.py --root on an image store at --bf16; one --remat step
     of the flagship (its peak below phase 4's, its step-1 logs phase 4's
     to REMAT_TOL).
 12. the rest of the registry, with every count at 0: the PointNet and
     DGCNN leaves (seed-0 weights, float32 and bf16) behind
     TrackingManager.step over ZOO_FRAMES frames of the serving scene,
     dense ('never') and sparse ('auto'): one match-kernel launch a scored
     frame on the cluster tier (C = 64, N = 128) and none of another tier;
     tools/track.py serving the PointNet 2048-point ablation at
     --subsample 2048 (the rows tier); one dense frame of each baseline
     leaf (concat, xcorr-baseline) with no match-kernel launch (the gate,
     kernels/match_grid.fused_head_ok, sends them to plain torch);
     ZOO_TRAIN_STEPS train steps of each of the four families at 256 pairs,
     float32 and bf16, with the kernel knobs each takes (step ms, forward /
     backward / optimizer ms, peak GiB). Then the checks: each PointNet /
     DGCNN frame's logits against the model's plain match_logits_grid /
     match_logits on the same padded inputs (MATCH_TOL) at float32; at
     bf16 the kernel's pooled features on the frame's inputs against the
     chain's plain version (BF16_TOL), the frame's logits equal to them
     through the head, and its logits against the float32 port's on the
     same crops (BF16_LOGIT_TOL); each baseline
     frame's logits against match_logits on all its pairs (MATCH_TOL); the
     grid kernel's and the embed's ms on the dense frames' inputs.
 13. the tracker-era zoo (configs/zoo.py, the JAX CLIs' --set heads and
     backbones), with every count at 0: xcorr with its local stages on the
     linear-attention kernel, ReIDNetCosine, LoFTR ('full'), VN-DGCNN and
     the 'add' combine at full width, float32 (xcorr and cosine at bf16
     too), behind TrackingManager.step over TRACKER_ZOO_FRAMES frames of
     the serving scene, sparse ('auto') and dense ('never', the 128 x 128
     grid; xcorr's in chunks of pairs): step ms, the last frame's device
     ms under the profiler, peak GiB and launches, where the match kernels
     (rows 2-4) take VN-DGCNN's head alone (fused_head_ok, as JAX's
     _pallas_grid_ok) and read 0 for the rest; one train step of 256 pairs
     of each with the knobs on (step ms, peak GiB, loss against the knobs
     off to TRAIN_TOL); tools/track.py serving xcorr and cosine through
     --set. Then the checks: each float32 frame's logits against the
     model's own plain scoring (MATCH_TOL), each bf16 frame's against the
     float32 port's (BF16_LOGIT_TOL; BF16_XCORR_LOGIT_TOL for the xcorr
     head), and the attention kernel at the local
     stages' shape (one query, 32 keys; LOCAL_ATTN_ROWS rows) against its
     plain version, forward and gradients (ATTN_TOL), with its times and
     bound: the kernels line's row `linear_attention/one_query`.
 14. the reference-checkpoint path: the flagship testing leaf from a
     seeded reference .pth through tools/convert_checkpoint.py, tools/
     test.py and tools/parity_eval.py, DeiT-tiny from HF names, and the op
     library at realistic sizes against the same calls on the CPU;
 15. multi-GPU on one card, with every count at 0: (a) two gloo ranks on
     cuda:0 (torch.multiprocessing.spawn, a FileStore in a temporary
     directory, DP_TIMEOUT on init and join) train the flagship with the
     knobs on through Trainer.fit, DP_PAIRS pairs a rank, DP_STEPS steps,
     against one process on the same global batches (step 1's loss and
     grad_norm to TRAIN_TOL, the running statistics after step 1 to
     DP_STAT_TOL; after the last step the weights' updates to
     DP_UPDATE_TOL, the SA convs' biases to 2 x the learning rates spent,
     the running variances to DP_VAR_TOL); rank 0 alone writes
     the checkpoint; the two ranks' eval of it against one process's
     (EVAL_TOL, the same pair count); each rank's kNN, attention and SA
     launches; (b) tools/train.py under torchrun --standalone
     --nproc_per_node 1 for one epoch on phase 8's store: its process
     group is NCCL; (c) a scorer on a two-entry mesh (cuda:0 twice) behind
     TrackingManager.step, point scene dense and sparse at float32 and
     bf16, image scene dense and sparse: each frame's logits against the
     unsharded scoring of the frame's own inputs (MATCH_TOL, BF16_TOL at
     bf16), the sharded embed against the unsharded one, step ms beside the
     unsharded scorer's, launches per mesh entry; (d) fused_train and
     remat_stages [0, 1, 2] steps of the flagship at TRAIN_PAIRS pairs,
     step 1 against phase 4's (TRAIN_TOL; REMAT_TOL for remat_stages), step
     ms and peak GiB beside phase 4's.
 16. the widths (ROADMAP.md K6, K3): the match kernels in the padded layout
     (kernels/match_grid.pad_side) at both dtypes against their plain
     versions at the true width (MATCH_TOL, BF16_TOL; pairs equal to their
     grid cells bit for bit): the point head at WIDTH_POINT (C = 32 and 48
     on the cluster tier's C = 64; C = 96 in 2 and 3 heads, at N = 128 and
     2048, and C = 120 in 8 heads on the rows tier's C = 128), the image
     head at WIDTH_IMAGE (C = 96 at S = 197 and C = 64 at S = 256, past the
     cluster tier's rows, on the rows tier's padded entry point), each with
     its tier, time, plain time and bound at the true and the padded width;
     FPS over 6 channels (csrc/fps.cu's channel kernels) at three clouds,
     indices equal to the plain loop's. Then, with every count at 0: the
     three --set models of point_cloud_reid_tpu_torch/configs/widths.py
     (the flagship at conv_out 96 and 32, DeiT-tiny at downsample_dim 96)
     through tools/track.py at float32 and --bf16, dense ('never') and
     sparse ('always'), every frame's pooled features against the chain's
     plain version on its padded inputs, its logits equal to them through
     the head and, at float32, against the model's own plain scoring
     (FRAME_TOL), the launches by tier; FPS of points with normals through
     ops.geometry.farthest_point_sample.
 17. the last shape gaps (ROADMAP.md K5, K6b): the SA kernels at both
     dtypes against their plain versions (SA_TOL, BF16_TOL) at C = 48 (the
     padded layout at 64), 992 (at bf16 the mma_sync tier), 1024, 1,056,
     1,536 and the mul16 model's three SA stages at B = 128 (C = 512,
     1024, 2048: the wide layout of csrc/sa_wide_wg.cuh from 928 channels
     at float32 and past 1024 at bf16), each with its time over its bound,
     and the match kernels at
     WIDE_MATCH (the point grid 128 x 128 and 512 pairs at C = 256 in 2
     heads, the wide kernel, and at C = 128 in 16 heads; DeiT's 128 x 64
     grid and 512 pairs at C = 256), each with its tier, time, plain time
     and bound at the true and the kernel's width, pairs equal to their
     grid cells bit for bit. Then, with every count at 0: the five --set
     models conv_out256, heads16, mul16, mul6 (SA widths 192 / 384 / 768:
     the row tiles, at bf16 the mma_sync tier) and image256 of
     configs/widths.py through tools/track.py at float32 and --bf16, dense
     and sparse, each frame held as in phase 16, the launches of the new
     rows; the phase's seconds on a line of its own.
 18. past the wide layouts' first bounds (ROADMAP.md K7): the SA kernels
     at 2,080-8192 channels and the match chain at 384-1024 channels and
     32 heads against their plain versions, a sharded launch at 512
     channels, then the four --set models of configs/widths.py K7_MODELS
     through tools/track.py at float32 and --bf16, dense and sparse.
 19. the DGCNN 2048-point ablations at their registered 256 pairs: the
     kNN kernel's channel tier (csrc/knn_channels.cu) at KNN_CHANNELS,
     float32 and bf16, indices equal to the plain version's on exact and
     duplicated inputs, near-ties only on random ones (their count and
     largest gap), with its time, device time, plain and cdist + topk times
     and the bound of its products' route (bf16 or FFMA), ptxas's registers and spills of every instantiation, the shared bytes
     of each plan; DGCNN conv1's kNN over xyz (C = 3) through tier S as
     routed and tier C forced, both against plain and both timed; then,
     with every count at 0, DGCNN_ABLATION's train step at 256 pairs
     through tools/profile_train.py (float32 and bf16, each with and
     without --remat: step ms, peak GiB, the kNN launches a step by tier,
     the kNN's device ms a step and its share of the step), one eval batch
     of 256 pairs at both dtypes, and the chunked
     EdgeConv step against one chunk at CHUNK_PAIRS pairs (loss, grad_norm,
     gradients and the weights after the step); rows `knn/channels` and
     `knn/channels_bf16`.
Each kernel's bound is the least time the card could take for the call: the
larger of its bytes (inputs once, outputs once) over 3.35 TB/s and its
operations over the peak of the unit that runs them, the H100's published
peaks: 67 TFLOP/s for float32 outside the tensor cores; for the SA and
match kernels, whose products run on the tensor cores in three TF32 passes,
their operations x 3 over 495 TFLOP/s (their rows keep the float32
CUDA-core bound of earlier versions as `simt_fp32_bound_ms`); the bf16
kernels' rows (`kernel/bf16`), one pass over 989 TFLOP/s. Rows named
`kernel/tier` are a kernel's tiers past its first shapes, with launches of
those tiers alone; a row's `shapes` lists its measurements at further
shapes. The line before the last is a JSON summary of the kernels and of
phases 8 and 9; the last
line is
{"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import sys
import time

import numpy as np

SEED = 0
N_OBJ, PTS_PER_OBJ, FRAMES = 96, 600, 10
# kernels vs float32 plain versions, max |kernel - plain| / max(1, max
# |plain|). The SA stages' products run in three TF32 passes: 1.7e-6 to
# 3.2e-6 on the card, one pass 1.7e-4 to 3.2e-4 (emulated,
# tests/test_torch_sa_tf32.py)
SA_TOL = 2e-5
# the same for the match chain (two LayerNorm stacks): three TF32 passes
# read 1.1e-6 to 1.7e-6 on the card, one pass 2.7e-4 / 3.2e-4 (emulated,
# tests/test_torch_match_tf32.py)
MATCH_TOL = 1e-5
FRAME_TOL = 1e-3       # frame logits vs the plain composition, abs + rel
# float32 kernels on the CUDA cores: only the summation order differs
ATTN_TOL = 1e-4        # linear attention and its gradients
KNN_TIE = 1e-6         # kNN: a swap needs plain distances this close (rel.)
TRAIN_TOL = 1e-3       # step 1, kernels on vs off: loss and grad norm, rel.
TRAIN_PAIRS, TRAIN_STEPS = 256, 6
IMG_OBJ, IMG_FRAMES = 64, 10
# the CLI scene of the tracker host phase: a 12 x 8 grid of objects 5 m
# apart, a near-duplicate (lower score, IoU about 0.62) of every fifth
N_CLI, CLI_FRAMES, CLI_DUP_EVERY, NMS_THRESHOLD = 96, 6, 5, 0.5
HOST_IMG_FRAMES = 10
# median steady-state step ms of the serving scenes, by phase_main_path
STEP_MS = {}
FPS_CROPS = 128
# (B, N, npoint) of the FPS kernel's checks: the FPS path's three SA stages
# at 128 crops (the kernels line's sums), the same at 512 (the train batch),
# past the first kernel's 1024 points, dense crops of 2048 points, and raw
# sweep-sized clouds
FPS_SHAPES = ((128, 128, 128), (128, 128, 64), (128, 64, 32),
              (512, 128, 128), (512, 128, 64), (512, 64, 32),
              (2, 1025, 64), (128, 1024, 256), (512, 2048, 512),
              (4, 16384, 256), (4, 20000, 1024))
# phase 8: an on-disk store of nuScenes classes, 6 frames an object, 8-400
# points a frame. Three of the ten classes (construction_vehicle, barrier,
# traffic_cone) are not in the tracking map, so the sampler trains on 7/10
# of the 75 % TP objects: 2,500 objects give 1,313, 5 steps of 256 pairs
# (2,000 would give 1,050: 4 steps)
FLAGSHIP = "pts_point-transformer_point-cat_nus_det_4x256_500e"
KNOBS = ("model.knn_method=pallas",
         "model.cross_stage1.attention=linear-pallas",
         "model.cross_stage2.attention=linear-pallas")
PLAIN_KNOBS = ("model.knn_method=argsort",
               "model.cross_stage1.attention=linear",
               "model.cross_stage2.attention=linear")
STORE_OBJECTS, STORE_FRAMES, STORE_STEPS, DATA_PAIRS = 2500, 6, 5, 256
DATA_WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_data")
# eval logits with the kernels vs the plain run, max |d| / max(1, max |plain|)
EVAL_TOL = 1e-4
# median train-step ms of phase 4, by phase_training
TRAIN_MS = {}
# phase 8's tools/train.py run: median step ms and mean loader wait ms
DATA_MS = {}
DEVICE = "cuda"
PEAK_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores
PEAK_TF32 = 495e12     # H100 SXM, TF32 on the tensor cores, dense
PEAK_BYTES = 3.35e12   # H100 SXM, HBM3
# the SA and match kernels run each product in three TF32 passes (3xTF32)
TF32_PASSES = 3
# phase 10, bf16 serving: the bf16 kernels against their bf16 plain versions
# (the same bf16-rounded operands, float32 accumulation: only the summation
# order differs, and a value next to a rounding boundary may round one ulp
# apart), relative to max(1, |plain|). One bf16 ulp is at most 2^-7 = 7.8e-3
# of that; the card read 3.9e-3 to 7.2e-3 at the serving shapes (first set
# at 2e-2, two ulps at order-1 values)
BF16_TOL = 1e-2
# a bf16 frame's logits against the float32 port's on the same crops,
# relative to max(1, |logit|): on the CPU at the flagship's width JAX's bf16
# logits lie 0.030 from its float32 ones and its two bf16 routes 0.043 apart
BF16_LOGIT_TOL = 6e-2
PEAK_BF16 = 989e12     # H100 SXM, bf16 on the tensor cores, dense
BF16_STEP_MS = {}
# phase 9, the rest of the flagship family: the 2048-point ablation and the
# 7M model (C = 128, mul 8), each trained FAMILY_STEPS steps and served
ABLATION = "pts_point-transformer_point-cat_waymo_det_4x256_400e_2048pts"
SCALED = "pts_point-transformer-7M_point-cat_nus_det_4x256_500e"
FAMILY_STEPS = 3
# kNN past 128 points, (B, N) at S = 128 queries and k = 32: 512 crops (256
# pairs) up to SA1 of the 2048-point ablation, and clouds past the shared
# tier's 14,528 points
FAMILY_KNN = ((512, 129), (512, 256), (512, 1024), (512, 2048), (8, 20000))
# the N <= 128 tier at SA1-3 of 512 crops in PR 7 (PERF.md section 6, kNN)
PR7_KNN_MS = (0.0602, 0.0441, 0.0350)
# phase 11, training at bf16 and the image leaves. Step 1 of the bf16
# flagship against the same step with both knobs off (the attention's
# rounding differs: the kernel computes in float32, the composite in bf16),
# relative, at the JAX suite's bf16 bar; and against phase 4's float32 step
# 1: on the CPU at tiny widths the JAX package's own bf16 step 1 lies 5e-4
# (loss) and 1.8e-2 (grad_norm) from its float32 one
BF16_TRAIN_TOL = 3e-2
BF16_F32_TRAIN_TOL = 1e-1
# the image leaf the JAX bench trains (image_train_step_ms), at its batch,
# and the on-disk image store of the CLI run (240 objects x 4 frames of
# 224 x 224 crops: two train steps of 60 pairs; its eval at 2 combinations
# an object)
IMAGE_LEAF = "rgb_deit-tiny_point-cat_r_nus_det_4x60_200e"
IMAGE_PAIRS, IMAGE_STEPS = 60, 6
IMAGE_STORE_OBJECTS, IMAGE_STORE_FRAMES = 240, 4
# a remat step against phase 4's first step: the same kernels, so float32
# summation order alone (the backward's scatter-adds are atomic on the card)
REMAT_TOL = 1e-5
# phase 12, the rest of the registry: the PointNet and DGCNN leaves (their
# xcorr_eff head on the match kernels at d = 64), the PointNet 2048-point
# ablation, the two baselines (plain torch by design) and a train step of
# each family
ZOO = {"PointNet": "pts_pointnet_point-cat_nus_det_4x256_500e",
       "DGCNN": "pts_dgcnn_point-cat_nus_det_4x256_500e"}
BASELINES = {
    "concat": "pts_point-transformer_baseline_nus_det_4x256_500e",
    "xcorr-baseline": "pts_point-transformer_baseline-stnet_nus_det_4x256_500e"}
ZOO_ABLATION = "pts_pointnet_point-cat_waymo_det_4x256_400e_2048pts"
ZOO_FRAMES, ZOO_TRAIN_STEPS = 4, 3
# phase 13, the tracker-era zoo (point_cloud_reid_tpu_torch/configs/zoo.py):
# the heads and backbones the JAX CLIs reach through --set, at full width.
# 'xcorr-pallas' runs its local stages on the linear-attention kernel (one
# query and 32 keys a point); its training twin is 'xcorr' with the knobs
TRACKER_ZOO = ("xcorr-pallas", "cosine", "loftr", "vn_dgcnn", "add")
TRACKER_ZOO_BF16 = ("xcorr-pallas", "cosine")
TRACKER_ZOO_CLI = ("xcorr-pallas", "cosine")
TRACKER_ZOO_FRAMES = 3
# the pairs of a dense frame held against one batch of match_logits
TRACKER_ZOO_CHECK_PAIRS = 256
# the local stages' shape of the linear-attention kernel, (rows, keys) at
# one query a row and d_model 64 in two heads: 256 pairs of 128-point crops
# (a train step, and a chunk of a dense frame) and all 16,384 pairs of a
# 128 x 128 dense frame at once
LOCAL_ATTN_ROWS, LOCAL_ATTN_KEYS = (256 * 128, 16384 * 128), 32
# the xcorr head's bf16 frames against the float32 port's: its local stages
# pick neighbours by bf16 feature distances, and the JAX package's own bf16
# logits of the head lie 0.053 from its float32 ones on 144 pairs at full
# width (`python -m tests._torch_zoo_bf16_gap`), against 0.030 for the
# flagship's head (BF16_LOGIT_TOL); a 128 x 128 frame takes the max over
# 16,384 pairs
BF16_XCORR_LOGIT_TOL = 1e-1
# phase 14, the reference-checkpoint path: the flagship testing leaf at full
# width from a seeded reference .pth, evaluated with the kernel knobs on a
# SyntheticStore of REF_OBJECTS objects (525 train samples, so the CLIs keep
# batches of REF_BATCH pairs; 10,500 val pairs, 41 batches); parity_eval's
# bar (BASELINE.md)
REF_LEAF = "testing_" + FLAGSHIP
REF_OBJECTS, REF_BATCH = 1000, 256
REF_TOLERANCE = 0.5
# the op library at realistic sizes: a 10-sweep nuScenes cloud's size at
# the lidar voxelization of BEVFusion's nuScenes TransFusion-L config
# (voxel 0.075 x 0.075 x 0.2 m, range [-54, -54, -5, 54, 54, 3] m, 10
# points a voxel, 120,000 voxels), 16 channels on the voxels, the
# flagship's SA1 shape at OPS_CROPS crops; card against CPU, floats within
# OPS_TOL of max(1, |CPU|), indices equal
OPS_POINTS = 300_000
OPS_VOXEL = (0.075, 0.075, 0.2)
OPS_RANGE = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
OPS_MAX_PTS, OPS_MAX_VOXELS, OPS_CHANNELS = 10, 120_000, 16
OPS_CROPS, OPS_RADIUS = 256, 0.4
OPS_TOL = 1e-5
OPS_ITERS = 3
# phase 15, multi-GPU on one card. Two gloo ranks share cuda:0 (NCCL does
# not put two ranks of one communicator on one card): DP_PAIRS pairs a rank
# a step, the flagship at full width with the kernel knobs on. Against one
# process on the same global batches, in float32 (dp_gaps): step 1's loss
# and grad_norm at TRAIN_TOL, the running statistics after step 1 at
# DP_STAT_TOL of max(1, |one process|). After the last step, every weight
# but the SA convs' biases through the updates' gap (the 2-norm of the two
# runs' difference over that of one process's update) at DP_UPDATE_TOL,
# and the running variances at DP_VAR_TOL of max(1, |one process|). Adam
# moves an entry by about lr a step whatever its gradient's size, so an
# entry whose gradient is mostly rounding may move either way: one entry in
# a thousand does (7.3e-3 of max(1, |w|) at most), as much in a world-1
# group (the data-parallel step on one rank, no collective that can be
# wrong: gap 2.1e-2, running variances 4.5e-4) as on two ranks (2.9e-2,
# 4.6e-4), and one process against itself, which is not bit-reproducible,
# gives 2.2e-3 (H100, 700 W). A wrong shard or reduction moves most
# entries: rank 0's rows alone with no reduction give a gap of 0.94 (4.8M of
# 7.3M entries off by more than lr spent / 10, running variances 3.9e-2).
# The SA convs' biases each feed a BatchNorm, which
# cancels them, so all of their gradient is rounding: they are held within
# 2 x the learning rates spent, and the running means, which such a move
# shifts, are printed.
DP_RANKS, DP_PAIRS, DP_STEPS, DP_EVAL_BATCHES = 2, 128, 3, 2
DP_TIMEOUT = 240        # s, each rank's process-group init and the join
DP_STAT_TOL = 1e-4
DP_UPDATE_TOL = 0.1     # measured 2.9e-2; no reduction 0.94
DP_VAR_TOL = 1e-3       # measured 4.6e-4, a world-1 group 4.5e-4
DP_WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_dp")
MESH_ENTRIES = 2
# phase 16, the widths (ROADMAP.md K6, K3): the match chain at head widths
# the kernels' tiles have no instantiation for, in the padded layout
# (kernels/match_grid.pad_side), point head (C, heads, N) and image head
# (C, heads, S), the first of each tier the dense frame's shape (a 128 x 128
# grid of 128-point crops; DeiT's 128 x 64 grid at S = 197), the rest on
# WIDTH_SMALL x WIDTH_SMALL grids (8 x 8 at N = 2048); the three --set models
# of point_cloud_reid_tpu_torch/configs/widths.py through tools/track.py,
# WIDTH_FRAMES frames a run; FPS over (B, N, npoint, C) points with normals
WIDTH_POINT = {"cluster": ((32, 2, 128), (48, 4, 128)),
               "rows": ((96, 2, 128), (96, 3, 128), (96, 2, 2048),
                        (120, 8, 128))}
WIDTH_IMAGE = ((96, 2, 197), (64, 2, 256))
WIDTH_SMALL, WIDTH_PAIRS = 16, 512
WIDTH_FRAMES = 3
WIDTH_FPS = (128, 1024, 256, 6)
# phase 17, the last shape gaps (ROADMAP.md K5, K6b): the SA kernels at
# (C, B, N, S, K) off the first kernels' widths (the mul16 model's stages
# come from tools/ab_sa.stage_inputs at B = 128), the match kernels at
# (head, C, heads, N, nt, nd), and the configs/widths.py models served
WIDE_SA = ((48, 128, 128, 128, 32), (992, 128, 64, 32, 48),
           (1024, 128, 64, 32, 48), (1056, 128, 64, 32, 48),
           (1536, 128, 64, 32, 48))
WIDE_MATCH = (("point", 256, 2, 128, 128, 128),
              ("point", 128, 16, 128, 128, 128),
              ("image", 256, 2, 197, 128, 64))
WIDE_MODELS = ("conv_out256", "heads16", "mul16", "mul6", "image256")
# phase 18, past the wide layouts' first bounds (ROADMAP.md K7): the SA
# kernels at (C, B, N, S, K) past 2048 channels (2,080 runs at 2,112), the
# match chain at (head, C, heads, N, nt, nd) past 256 channels and 16 heads
# (384 in three heads of 128, 512, 1024, 256 in 32 heads of 8, DeiT's 768
# in two heads of 384), the configs/widths.py models served, and a sharded
# launch of the conv_out512 model over a mesh of K7_SHARDS entries
K7_SA = ((2080, 128, 64, 32, 48), (3072, 128, 64, 32, 48),
         (4096, 128, 64, 32, 48), (8192, 8, 64, 32, 48))
K7_MATCH = (("point", 384, 3, 128, 16, 16), ("point", 512, 2, 128, 16, 16),
            ("point", 1024, 8, 128, 16, 16), ("point", 256, 32, 128, 16, 16),
            ("image", 768, 2, 197, 16, 16))
K7_MODELS = ("mul24", "conv_out512", "heads32", "image768")
K7_SHARDS = 2
# phase 19, the DGCNN 2048-point ablations at their registered 256 pairs
# (ROADMAP.md section 1 item 5): the kNN kernel's channel tier (tier C,
# csrc/knn_channels.cu) at (B, S, N, C, k): DGCNN's feature-space kNN of
# blocks 2-3 and 4 at 256 pairs of 2048-point crops (512 clouds, every
# point a query), the 1024-point ablation's, a cloud past shared memory
# and small shapes off the kernel's tiles (C = 5 element by element, k past
# 32), float32 and bf16; the leaf's train step through
# tools/profile_train.py, an eval batch, and the chunked EdgeConv step
# against one chunk at CHUNK_PAIRS pairs (float32 summation order alone:
# loss, grad_norm and gradients at CHUNK_TOL, the weights after the step
# through the updates' gap at DP_UPDATE_TOL, as phase 15 holds them)
DGCNN_ABLATION = "pts_dgcnn_point-cat_waymo_det_4x256_400e_2048pts"
KNN_CHANNELS = ((512, 2048, 2048, 64, 20), (512, 2048, 2048, 128, 20),
                (512, 1024, 1024, 64, 20), (4, 2048, 20000, 64, 20),
                (3, 70, 130, 5, 7), (2, 33, 97, 64, 40))
# a bf16 swap needs plain distances this close (relative): each pick's
# float32 sums may round to the neighbouring bf16 value twice
KNN_BF16_TIE = 2 ** -5
DGCNN_STEPS, DGCNN_WARMUP, CHUNK_PAIRS = 2, 1, 32
# relative: the card read 3.0e-7 (loss), 1.05e-6 (grad_norm) and 2.7e-5
# (gradients) between the chunked step and one chunk, and 0, 0 and 1.3e-7
# between one chunk and itself
CHUNK_TOL = 1e-4
DGCNN_TRACES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke_dgcnn")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(flops: float, nbyte: float, peak: float = PEAK_FLOPS) -> tuple:
    """(least ms the card could take, what bounds it)."""
    by_ops, by_bytes = flops / peak * 1e3, nbyte / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def tensor_core_bound(flops: float, nbyte: float) -> tuple:
    """(bound ms, what bounds it, float32 CUDA-core bound ms) of a kernel
    whose products, `flops` operations, run on the tensor cores in three
    TF32 passes; the elementwise work beside them is not counted."""
    ms, by = bound_ms(flops * TF32_PASSES, nbyte, PEAK_TF32)
    return ms, by, bound_ms(flops, nbyte)[0]


def match_bound(n_pairs: int, n_rows: int, width: int, nbyte: float
                ) -> tuple:
    """tensor_core_bound of the match kernel: 80 N C^2 operations a pair
    (per direction 14 N C^2 in stage 1 and 26 N C^2 in stage 2, the
    head-masked zeros of k^T v included, as the kernel computes them)."""
    return tensor_core_bound(80.0 * n_pairs * n_rows * width * width, nbyte)


def rel_err(got, want) -> tuple:
    err = (got - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    from point_cloud_reid_tpu_torch.tools.scenes import card_name
    card = card_name()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from point_cloud_reid_tpu_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.LIBRARY.get()
    print(f"[device] {torch.cuda.get_device_name(0)}; kernels built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    entry = ""
    for line in _lib.LIBRARY.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            print("[ptxas]", entry, line.strip())
    return card


def phase_kernels(model):
    """Kernel vs plain at the main path's shapes; returns the JSON rows."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    from point_cloud_reid_tpu_torch.ops.geometry import knn_indices
    from point_cloud_reid_tpu_torch.tools.timing import time_ms

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    crops = torch.randn((128, 128, 3), generator=gen, device=DEVICE) * 0.6
    rows = []

    # SA stages at B=128 crops: each stage's inputs are the previous
    # stage's outputs, as in the backbone
    xyz, points = crops, None
    sa_err = sa_ms = sa_plain_ms = sa_bound = sa_simt = 0.0
    sa_by = []
    for i, (mod, S) in enumerate(zip(model.backbone.SA_modules,
                                     model.backbone_list)):
        cidx = torch.arange(S, device=DEVICE).clamp(max=xyz.shape[1] - 1)
        idx = knn_indices(mod.nsample, xyz, xyz[:, cidx])
        args = sa.sa_stage_args(
            xyz, points, idx, [(c.weight, c.bias) for c in mod.mlp_convs],
            [(b.weight, b.bias, b.running_mean, b.running_var)
             for b in mod.mlp_bns], mod.mlp_bns[0].eps)
        got = sa.fused_sa_convmax(*args)
        want = sa.sa_convmax_reference(*args)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        k_ms = time_ms(lambda: sa.fused_sa_convmax(*args), 10)
        p_ms = time_ms(lambda: sa.sa_convmax_reference(*args), 5)
        B, N, C = args[0].shape
        # two C x C convs over B*S*K rows; the first layer's gather and the
        # affines are O(rows * C)
        b_ms, b_by, b_simt = tensor_core_bound(
            4.0 * B * S * mod.nsample * C * C, nbytes(*args, got))
        print(f"[sa_stage] SA{i + 1} B={B} N={N} S={S} K={mod.nsample} C={C}:"
              f" max_abs_err={err:.3e} rel={rel:.3e} (tol {SA_TOL:g})"
              f" kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by}; float32 CUDA-core bound "
              f"{b_simt:.3f} ms)", flush=True)
        if not rel <= SA_TOL:
            raise RuntimeError(f"sa_stage SA{i + 1} disagrees: rel {rel}")
        sa_err, sa_ms, sa_plain_ms = max(sa_err, err), sa_ms + k_ms, \
            sa_plain_ms + p_ms
        sa_bound, sa_simt = sa_bound + b_ms, sa_simt + b_simt
        sa_by.append((b_ms, b_by))
        xyz, points = mod(xyz, points, S)
    # its launches: the row tiles' alone (the wide layout has its row)
    rows.append(dict(name="fused_sa_convmax", route="cuda",
                     counter="fused_sa_convmax/two_buffers",
                     source="point_cloud_reid_tpu_torch/csrc/sa_stage.cu",
                     replaces="point_cloud_reid_tpu/ops/pallas/sa_stage.py:78",
                     max_abs_err=sa_err, ms=sa_ms, plain_ms=sa_plain_ms,
                     bound_ms=sa_bound, bound_by=max(sa_by)[1],
                     simt_fp32_bound_ms=sa_simt, library_ms=None))

    # grid 128 x 128 and a 512-pair list, on flagship embeddings
    with torch.no_grad():
        xyz_t, h_t = model.embed(crops)
        crops_d = torch.randn((128, 128, 3), generator=gen,
                              device=DEVICE) * 0.6
        xyz_d, h_d = model.embed(crops_d)
        t, d, w1, w2, nhead = mg.match_factors(model, h_t, xyz_t, h_d, xyz_d)
    nt, nd = h_t.shape[0], h_d.shape[0]
    n_pts, width = h_t.shape[1], h_t.shape[2]
    weights = list(w1.values()) + list(w2.values())

    def bounds(n_pairs, *extra):
        return match_bound(n_pairs, n_pts, width,
                           nbytes(*t, *d, *weights, *extra))

    ti = torch.arange(nt, device=DEVICE).repeat_interleave(nd)
    di = torch.arange(nd, device=DEVICE).repeat(nt)
    grid = mg.fused_match_grid(t, d, w1, w2, nhead)
    want = mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di
                                     ).reshape(nt, nd, -1)
    torch.cuda.synchronize()
    g_err, g_rel = rel_err(grid, want)
    g_ms = time_ms(lambda: mg.fused_match_grid(t, d, w1, w2, nhead), 5)
    g_plain = time_ms(lambda: mg.match_pooled_reference(
        t, d, w1, w2, nhead, ti, di), 2, warmup=1)
    g_bound, g_by, g_simt = bounds(nt * nd, grid)
    print(f"[match_grid] grid {nt}x{nd} N={h_t.shape[1]} C={h_t.shape[2]}: "
          f"max_abs_err={g_err:.3e} rel={g_rel:.3e} (tol {MATCH_TOL:g}) "
          f"kernel {g_ms:.3f} ms, plain {g_plain:.3f} ms, bound "
          f"{g_bound:.3f} ms ({g_by}; float32 CUDA-core bound "
          f"{g_simt:.3f} ms)", flush=True)
    if not g_rel <= MATCH_TOL:
        raise RuntimeError(f"fused_match_grid disagrees: rel {g_rel}")
    rows.append(dict(name="fused_match_grid", route="cuda",
                     source="point_cloud_reid_tpu_torch/csrc/match_grid.cu",
                     replaces="point_cloud_reid_tpu/ops/pallas/match_grid.py:250",
                     max_abs_err=g_err, ms=g_ms, plain_ms=g_plain,
                     bound_ms=g_bound, bound_by=g_by,
                     simt_fp32_bound_ms=g_simt, library_ms=None))

    P = 512
    t_idx = torch.randint(0, nt, (P,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    d_idx = torch.randint(0, nd, (P,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    pairs = mg.fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    want = mg.match_pooled_reference(t, d, w1, w2, nhead, t_idx, d_idx)
    torch.cuda.synchronize()
    p_err, p_rel = rel_err(pairs, want)
    at_grid = grid[t_idx.long(), d_idx.long()]
    pg_err, _ = rel_err(pairs, at_grid)
    p_ms = time_ms(lambda: mg.fused_match_pairs(t, d, w1, w2, nhead, t_idx,
                                                d_idx), 10)
    p_plain = time_ms(lambda: mg.match_pooled_reference(
        t, d, w1, w2, nhead, t_idx, d_idx), 3)
    p_bound, p_by, p_simt = bounds(P, t_idx, d_idx, pairs)
    print(f"[match_grid] pairs P={P}: max_abs_err={p_err:.3e} rel={p_rel:.3e}"
          f" vs plain (tol {MATCH_TOL:g}), {pg_err:.3e} vs the grid kernel at "
          f"the same indices (want 0); kernel {p_ms:.3f} ms, "
          f"plain {p_plain:.3f} ms, bound {p_bound:.3f} ms ({p_by}; float32 "
          f"CUDA-core bound {p_simt:.3f} ms)", flush=True)
    if not (p_rel <= MATCH_TOL and torch.equal(pairs, at_grid)):
        raise RuntimeError(f"fused_match_pairs disagrees: {p_rel}, {pg_err}")
    rows.append(dict(name="fused_match_pairs", route="cuda",
                     source="point_cloud_reid_tpu_torch/csrc/match_grid.cu",
                     replaces="point_cloud_reid_tpu/ops/pallas/match_grid.py:355",
                     max_abs_err=p_err, ms=p_ms, plain_ms=p_plain,
                     bound_ms=p_bound, bound_by=p_by,
                     simt_fp32_bound_ms=p_simt, library_ms=None))
    return rows


def knn_cloud(kind: str, B: int, N: int, seed: int):
    """tools/scenes.knn_cloud on the card: crops for the kNN and FPS checks,
    'exact' (multiples of 1/64, every distance exact and full of ties),
    'duplicates' (those resampled with replacement, as crops are) or
    'random' (Gaussian floats)."""
    import torch
    from point_cloud_reid_tpu_torch.tools.scenes import knn_cloud as cloud
    return torch.from_numpy(cloud(kind, B, N, seed)).to(DEVICE)


def knn_serving(shapes) -> dict:
    """The tracker's embed at B=128 and B=256 crops runs
    knn_indices(..., "argsort") at each SA stage: its time beside the
    kernel's at those shapes on random clouds, both as a call from Python
    (CUDA events around back-to-back calls, which the host can pace), and
    the kernel's device time; indices equal on exact inputs. Returns {B:
    times} summed over the three stages."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.ops.geometry import knn_indices
    from point_cloud_reid_tpu_torch.tools.timing import graph_ms, time_ms
    out = {}
    for B in (128, 256):
        ms = [0.0, 0.0, 0.0]
        for i, (S, N, k) in enumerate(shapes):
            xyz = knn_cloud("exact", B, N, SEED + i)
            q = xyz[:, :S].contiguous()
            if not torch.equal(kk.knn(q, xyz, k),
                               knn_indices(k, xyz, q, "argsort")):
                raise RuntimeError(f"knn B={B} S={S}: indices differ from "
                                   "the argsort path on exact inputs")
            xyz = knn_cloud("random", B, N, SEED + i)
            q = xyz[:, :S].contiguous()
            k_ms = time_ms(lambda: kk.knn(q, xyz, k), 20)
            a_ms = time_ms(lambda: knn_indices(k, xyz, q, "argsort"), 20)
            d_ms = graph_ms(lambda: kk.knn(q, xyz, k), 20)
            print(f"[knn:serving] B={B} S={S} N={N} k={k}: a call from "
                  f"Python: kernel {k_ms:.4f} ms, knn_indices(argsort) "
                  f"{a_ms:.4f} ms; kernel device time {d_ms:.4f} ms",
                  flush=True)
            ms = [ms[0] + k_ms, ms[1] + a_ms, ms[2] + d_ms]
        print(f"[knn:serving] B={B}, three SA stages: kernel {ms[0]:.4f} ms "
              f"(device {ms[2]:.4f}), argsort {ms[1]:.4f} ms: "
              f"{ms[1] - ms[0]:.4f} ms a point frame with "
              "knn_method='pallas'", flush=True)
        out[B] = dict(kernel_ms=ms[0], argsort_ms=ms[1],
                      kernel_device_ms=ms[2])
    return out


def phase_train_kernels(model):
    """The training path's two kernels against their plain versions."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.kernels import linear_attention as la
    from point_cloud_reid_tpu_torch.tools.timing import graph_ms, time_ms
    rows = []

    # kNN at the three SA stages' shapes for 256 pairs = 512 crops
    B = 2 * TRAIN_PAIRS
    shapes = [(s, n, mod.nsample) for s, n, mod in zip(
        model.backbone_list, [128] + list(model.backbone_list),
        model.backbone.SA_modules)]
    k_ms = k_plain = k_lib = k_bound = k_device = 0.0
    k_by, k_err, exact_bad, swaps_total = [], 0.0, 0, 0
    for i, (S, N, k) in enumerate(shapes):
        swaps = {}
        for kind in ("exact", "duplicates", "random"):
            xyz = knn_cloud(kind, B, N, SEED + i)
            q = xyz[:, :S].contiguous()
            got, want = kk.knn(q, xyz, k), kk.knn_reference(q, xyz, k)
            torch.cuda.synchronize()
            bad = got != want
            swaps[kind] = int(bad.sum().item())
            # the error of an index is the plain distance between the point
            # chosen and the point wanted at that rank
            dist = kk.square_distance(q, xyz)
            dg, dw = dist.gather(-1, got), dist.gather(-1, want)
            k_err = max(k_err, (dg - dw).abs().max().item())
            if kind != "random":
                exact_bad += swaps[kind]
                if swaps[kind]:
                    raise RuntimeError(f"knn {kind} S={S} N={N} k={k}: "
                                       f"{swaps[kind]} indices differ")
                continue
            far = (dg - dw).abs()[bad] > KNN_TIE * dw.abs()[bad].clamp(min=1.0)
            if bool(far.any()):
                raise RuntimeError(f"knn random S={S} N={N} k={k}: "
                                   f"{int(far.sum())} indices differ beyond "
                                   "a near-tie")
        # a call from Python, as every row, and the device time (a CUDA
        # graph of calls: the host's enqueue of a call takes longer than
        # the kernel)
        ms = time_ms(lambda: kk.knn(q, xyz, k), 20)
        device = graph_ms(lambda: kk.knn(q, xyz, k), 20)
        plain = time_ms(lambda: kk.knn_reference(q, xyz, k), 10)
        # one PyTorch call pair for the same function, but not tie-stable
        lib = time_ms(lambda: torch.cdist(q, xyz).topk(
            k, dim=-1, largest=False).indices, 10)
        # 8 flops a distance; the selection (about N + k log N comparisons
        # a row) is not counted, the k rounds of this kernel are its own;
        # the output is the int64 the function returns
        b_ms, b_by = bound_ms(8.0 * B * S * N, nbytes(q, xyz, got))
        print(f"[knn] B={B} S={S} N={N} k={k}: indices equal on exact and "
              f"duplicated inputs; random floats: {swaps['random']} of "
              f"{got.numel()} differ, all near-ties (< {KNN_TIE:g} rel.; "
              f"largest distance gap so far {k_err:.3e}); "
              f"kernel {ms:.4f} ms (device time {device:.4f}), plain "
              f"{plain:.3f} ms, cdist+topk (not "
              f"tie-stable) {lib:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"tier R in PR 7: {PR7_KNN_MS[i]:.4f} ms", flush=True)
        k_ms, k_plain, k_lib = k_ms + ms, k_plain + plain, k_lib + lib
        k_device += device
        k_bound += b_ms
        k_by.append((b_ms, b_by))
        swaps_total += swaps["random"]
    rows.append(dict(name="knn", route="cuda",
                     source="point_cloud_reid_tpu_torch/csrc/knn.cu",
                     replaces="point_cloud_reid_tpu/ops/pallas/knn.py:51",
                     max_abs_err=k_err, mismatches_exact=exact_bad,
                     near_tie_swaps=swaps_total, ms=k_ms,
                     plain_ms=k_plain, bound_ms=k_bound,
                     bound_by=max(k_by)[1], library_ms=k_lib,
                     device_ms=k_device, serving=knn_serving(shapes)))

    # linear attention: the cross stages' shape and one with L != S
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    a_err = 0.0
    for (Bp, L, S, H, D, V) in ((TRAIN_PAIRS, 128, 128, 2, 32, 32),
                                (64, 128, 48, 2, 32, 16)):
        # several input sets, more than the 50 MB L2 together, as views of
        # fused projections (non-contiguous) like the model's
        sets = []
        for _ in range(3):
            q = torch.randn((Bp, L, H, D), generator=gen, device=DEVICE,
                            requires_grad=True)
            kv = torch.randn((Bp, S, H, D + V), generator=gen, device=DEVICE)
            sets.append((q, kv[..., :D].detach().requires_grad_(True),
                         kv[..., D:].detach().requires_grad_(True)))
        q, k, v = sets[0]
        got = la.fused_linear_attention(q, k, v)
        want = la.linear_attention_reference(q, k, v)
        go = torch.randn(got.shape, generator=gen, device=DEVICE)
        g_got = torch.autograd.grad(got, (q, k, v), go)
        g_want = torch.autograd.grad(want, (q, k, v), go)
        torch.cuda.synchronize()
        err, rel = rel_err(got.detach(), want.detach())
        g_rel = max(rel_err(a, b)[1] for a, b in zip(g_got, g_want))
        turn = iter(range(10 ** 9))

        def run(fn):
            with torch.no_grad():
                fn(*sets[next(turn) % 3])
        ms = time_ms(lambda: run(la.linear_attention_forward), 30)
        device = graph_ms(lambda: run(la.linear_attention_forward), 30)
        plain = time_ms(lambda: run(la.linear_attention_reference), 30)
        flops = Bp * H * (2.0 * S * D * V + 2.0 * L * D * V + 2.0 * L * D
                          + S * D)
        b_ms, b_by = bound_ms(flops, nbytes(q, k, v, got))
        print(f"[linear_attention] B={Bp} L={L} S={S} H={H} D={D} V={V}: "
              f"max_abs_err={err:.3e} rel={rel:.3e}, gradients rel="
              f"{g_rel:.3e} (tol {ATTN_TOL:g}); forward kernel {ms:.4f} ms "
              f"(device time {device:.4f}), "
              f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        if not (rel <= ATTN_TOL and g_rel <= ATTN_TOL):
            raise RuntimeError(f"linear_attention disagrees: {rel}, {g_rel}")
        a_err = max(a_err, err)
        if L == S:      # the main path's shape gives the row its times
            row = dict(ms=ms, device_ms=device, plain_ms=plain,
                       bound_ms=b_ms, bound_by=b_by)
    rows.append(dict(
        name="linear_attention", route="cuda",
        source="point_cloud_reid_tpu_torch/csrc/linear_attention.cu",
        replaces="point_cloud_reid_tpu/ops/pallas/linear_attention.py:107",
        max_abs_err=a_err, library_ms=None, **row))
    return rows


def run_scene(model, sparse: str, frames: int = FRAMES, **manager_kw):
    """`frames` frames of the bench's drifting-objects scene; returns
    (per-frame ms, the scorer, which holds the last frame, the manager)."""
    import torch
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.tools.scenes import bench_scene
    from point_cloud_reid_tpu_torch.tracking import TrackingManager
    scorer = PairScorer(model)
    # random weights give arbitrary logits: accept every gated pair so the
    # track set stays at the scene's objects (96 -> a 128 x 128 grid)
    mgr = TrackingManager(scorer, subsample_number=128, match_threshold=1.0,
                          seed=SEED, sparse_scoring=sparse, **manager_kw)
    times = []
    for frame in bench_scene(N_OBJ, PTS_PER_OBJ, frames, SEED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.step(*frame)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        last = scorer.last_frame
        if last is not None and not bool(torch.isfinite(last["logits"]).all()):
            raise RuntimeError(f"non-finite logits in scene '{sparse}'")
    return times, scorer, mgr


def check_frame(model, rec, label: str):
    """Last frame's logits vs the plain composition: plain hoisted scoring
    (ReIDNet.match_logits_grid, no kernel) on the card over the frame's own
    embeddings, plus a CPU plain embed + score of 8 detections' crops."""
    import torch
    h_t, xyz_t, h_d, xyz_d = (rec[k] for k in ("h_t", "xyz_t", "h_d",
                                               "xyz_d"))
    with torch.no_grad():
        plain = model.match_logits_grid(h_t, xyz_t, h_d, xyz_d)
        if rec["pairs"] is not None:
            pt, pd = rec["pairs"]
            plain = plain[pt.long(), pd.long()]
        got = rec["logits"]
        err = (got - plain).abs().max().item()
        bound = FRAME_TOL * (1.0 + plain.abs().max().item())
        cpu = copy.deepcopy(model).cpu()
        n = 8
        _, h_cpu = cpu.embed(xyz_d[:n].cpu())
        e_err = (h_cpu - h_d[:n].cpu()).abs().max().item()
        e_bound = FRAME_TOL * (1.0 + h_cpu.abs().max().item())
        s_err = s_bound = 0.0
        if rec["pairs"] is None:     # dense frame: an 8 x 8 corner on CPU
            sub = cpu.match_logits_grid(h_t[:n].cpu(), xyz_t[:n].cpu(),
                                        h_cpu, xyz_d[:n].cpu())
            s_err = (sub - got[:n, :n].cpu()).abs().max().item()
            s_bound = FRAME_TOL * (1.0 + sub.abs().max().item())
    print(f"[frame:{label}] logits vs plain scoring: max_abs_err={err:.3e} "
          f"(bound {bound:.3e}); CPU plain embed of {n} crops: {e_err:.3e} "
          f"(bound {e_bound:.3e}); CPU plain {n}x{n} logits: {s_err:.3e} "
          f"(bound {s_bound:.3e})", flush=True)
    if not (err <= bound and e_err <= e_bound and s_err <= s_bound):
        raise RuntimeError(f"frame check failed in scene '{label}'")


class Bf16Count:
    """The bf16 kernel's launches of a wrapper (its `bf16_launches`), read
    and zeroed as a wrapper's `launches` are."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self) -> int:
        return self.fn.bf16_launches

    @launches.setter
    def launches(self, value: int) -> None:
        if value != 0:
            raise ValueError("a bf16 count is only ever reset to 0")
        self.fn.bf16_launches = 0


class TierCount:
    """The launches of some of a wrapper's tiers (its `tier_launches`, or
    the dict named `attr`), read and zeroed as a wrapper's `launches` are."""

    def __init__(self, fn, tiers, attr: str = "tier_launches"):
        self.fn, self.tiers, self.attr = fn, tiers, attr

    @property
    def launches(self) -> int:
        return sum(getattr(self.fn, self.attr)[t] for t in self.tiers)

    @launches.setter
    def launches(self, value: int) -> None:
        if value != 0:
            raise ValueError("a tier count is only ever reset to 0")
        for t in self.tiers:
            getattr(self.fn, self.attr)[t] = 0


def all_counters() -> dict:
    """name in the kernels line -> the wrapper that carries `launches`; the
    tiers past the first kernels' shapes count on their own: kNN past 128
    points and the match chain's rows tier; the float32 SA kernel counts
    in all and by layout (`/two_buffers`, `/wide`); the bf16 kernels count
    apart from the float32 ones, the match chain's by tier (`/bf16` the
    cluster tier, `/rows_bf16` the rows tier), the SA kernel's in all
    (`/bf16`) and by tier (`/wgmma_bf16`, `/mma_sync_bf16`,
    `/wide_bf16`)."""
    from point_cloud_reid_tpu_torch.kernels import fps as kf
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.kernels import linear_attention as la
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    return dict(fused_sa_convmax=sa.fused_sa_convmax,
                fused_match_grid=mg.fused_match_grid,
                fused_match_pairs=mg.fused_match_pairs, knn=kk.knn,
                linear_attention=la.linear_attention_forward,
                fused_image_match_grid=mg.fused_image_match_grid,
                fused_image_match_pairs=mg.fused_image_match_pairs,
                fps=kf.fps,
                **{"knn/scan": TierCount(kk.knn, ("shared", "global")),
                   "knn/channels": TierCount(kk.knn, ("channels",),
                                             "f32_launches"),
                   "knn/channels_bf16": TierCount(kk.knn, ("channels",),
                                                  "bf16_launches"),
                   "linear_attention/one_query": TierCount(
                       la.linear_attention_forward, ("one_query",),
                       "shape_launches"),
                   "fused_match_grid/rows": TierCount(mg.fused_match_grid,
                                                      ("rows",)),
                   "fused_match_pairs/rows": TierCount(mg.fused_match_pairs,
                                                       ("rows",))},
                # the first rows kernel, kept for C = 16: off every path here
                **{f"{fn.__name__}/rows_mma{b}": TierCount(fn, (f"rows_mma{b}",))
                   for fn in (mg.fused_match_grid, mg.fused_match_pairs)
                   for b in ("", "_bf16")},
                **{"fused_sa_convmax/bf16": Bf16Count(sa.fused_sa_convmax)},
                **{f"fused_sa_convmax/{tier}_bf16": TierCount(
                    sa.fused_sa_convmax, (tier,), "bf16_tiers")
                   for tier in sa.BF16_TIERS},
                **{f"{fn.__name__}/bf16": TierCount(fn, ("cluster_bf16",))
                   for fn in (mg.fused_match_grid, mg.fused_match_pairs,
                              mg.fused_image_match_grid,
                              mg.fused_image_match_pairs)},
                **{f"{fn.__name__}/rows_bf16": TierCount(fn, ("rows_bf16",))
                   for fn in (mg.fused_match_grid, mg.fused_match_pairs)},
                # the padded layout's launches by tier and dtype (phase 16)
                **{f"{fn.__name__}/padded_{t}{b}": TierCount(
                    fn, (f"{t}{b}",), "padded_launches")
                   for fn in (mg.fused_match_grid, mg.fused_match_pairs,
                              mg.fused_image_match_grid,
                              mg.fused_image_match_pairs)
                   for t in ("cluster", "rows") for b in ("", "_bf16")},
                **{"fps/channels": TierCount(kf.fps, ("channels",),
                                             "shape_launches")},
                # phases 17-18: the rows tier's wide kernel, on it past 256
                # channels, its launches past 8 and past 16 heads, the
                # float32 SA kernel's wide layout
                **{f"{fn.__name__}/{k}{b}": TierCount(
                    fn, (f"{k}{b}",), "shape_launches")
                   for fn in (mg.fused_match_grid, mg.fused_match_pairs,
                              mg.fused_image_match_grid,
                              mg.fused_image_match_pairs)
                   for k in mg.SHAPE_KEYS for b in ("", "_bf16")},
                **{f"fused_sa_convmax/{lay}": TierCount(
                    sa.fused_sa_convmax, (lay,), "f32_layouts")
                   for lay in sa.F32_LAYOUTS})


def zero_counters() -> dict:
    every = all_counters()
    for fn in every.values():
        fn.launches = 0
    return every


def phase_main_path(model, card: str):
    every = zero_counters()
    counters = tuple(every[k] for k in ("fused_sa_convmax",
                                        "fused_match_grid",
                                        "fused_match_pairs"))
    sparse_ms, sparse_rec, sparse_mgr = run_scene(model, "auto")
    after_sparse = [fn.launches for fn in counters]
    dense_ms, dense_rec, dense_mgr = run_scene(model, "never")
    launches = [fn.launches for fn in counters]
    scenes = {name: fn.launches for name, fn in every.items()}
    in_dense = [b - a for a, b in zip(after_sparse, launches)]
    print(f"[main] launches sparse scene (sa, grid, pairs) = {after_sparse}, "
          f"dense scene = {in_dense}", flush=True)
    if not (after_sparse[0] > 0 and after_sparse[2] > 0
            and in_dense[0] > 0 and in_dense[1] > 0):
        raise RuntimeError("a kernel of the main path was not launched")
    for label, ms, mgr in (("sparse", sparse_ms, sparse_mgr),
                           ("dense", dense_ms, dense_mgr)):
        STEP_MS[label] = float(np.median(ms[3:]))
        print(f"[main] {label}: {len(mgr.store.active())} active tracks, "
              f"median steady-state step {np.median(ms[3:]):.3f} ms "
              f"(frames 4-10; all: {[round(x, 1) for x in ms]}) on {card}",
              flush=True)
    check_frame(model, sparse_rec.last_frame, "sparse")
    check_frame(model, dense_rec.last_frame, "dense")
    return scenes


def train_flagship(kernels: bool, pairs: int, steps: int, work_dir,
                   cfg=None, num_points: int = 128, num_classes: int = 10,
                   spec=None, dtype=None, remat: bool = False):
    """`steps` optimizer steps of the flagship (or of the model config
    `cfg`, or of what a profile_train.train_spec `spec` trains: its model,
    losses, triplet margin and batch shape, images included) through
    Trainer.fit on seeded synthetic pair batches of `num_points`-point
    crops, at compute dtype `dtype` (float32 when None), with or without
    remat. Returns (per-step logs, per-step ms, which weights and
    statistics changed, peak bytes)."""
    import torch
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.tools.profile_train import (
        LOSSES, flagship_train_cfg)
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig,
                                                  SyntheticPairLoader,
                                                  Trainer, TrainState)
    from point_cloud_reid_tpu_torch.utils.logging import MetricLogger
    if spec is None:
        spec = dict(model=cfg or flagship_train_cfg(kernels), losses=LOSSES,
                    alpha={}, triplet_margin=0.2, num_points=num_points,
                    num_classes=num_classes, image_size=0)
    model = build_model(spec["model"], device=DEVICE,
                        generator=torch.Generator().manual_seed(SEED),
                        dtype=dtype or torch.float32)
    loader = SyntheticPairLoader(pairs, steps, num_points=spec["num_points"],
                                 num_classes=spec["num_classes"], seed=SEED,
                                 image_size=spec["image_size"])
    runtime = dict(work_dir=work_dir, seed=SEED, max_epochs=1,
                   eval_interval=0, checkpoint_interval=0, log_interval=1,
                   losses_to_use=spec["losses"], alpha=spec["alpha"],
                   triplet_margin=spec["triplet_margin"], remat=remat)
    trainer = Trainer(model, loader, loader, runtime,
                      logger=MetricLogger(None, quiet=True))
    state = TrainState.create(model, ScheduleConfig(max_epochs=1), steps)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logs, times = [], []
    step = trainer.train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        logs.append({k: float(v) for k, v in out[1].items()})
        torch.cuda.synchronize()      # the optimizer runs after the logs
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    state = trainer.fit(state)
    if state.step != steps:
        raise RuntimeError(f"trainer took {state.step} steps, not {steps}")
    changed = {k for k, v in model.state_dict().items()
               if not torch.equal(v, before[k])}
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise RuntimeError("training left a parameter outside float32")
    return logs, times, changed, torch.cuda.max_memory_allocated()


def phase_training(card: str):
    import tempfile

    import torch
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.kernels import linear_attention as la
    with tempfile.TemporaryDirectory() as work_dir:
        for pairs in (TRAIN_PAIRS, TRAIN_PAIRS // 2):
            counters = zero_counters()
            try:
                logs, times, changed, peak = train_flagship(
                    True, pairs, TRAIN_STEPS, work_dir)
                break
            except torch.cuda.OutOfMemoryError:
                # retried below, outside the handler, which keeps the failed
                # step's tensors alive
                pass
            print(f"[train] {pairs} pairs do not fit in float32 (peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB): "
                  f"halving", flush=True)
            torch.cuda.empty_cache()
        else:
            raise RuntimeError("the flagship does not train at "
                               f"{TRAIN_PAIRS // 2} pairs either")
        launches = {name: fn.launches for name, fn in counters.items()}
        if not os.path.exists(os.path.join(work_dir, "ckpt_final.pt")):
            raise RuntimeError("the trainer wrote no final checkpoint")
    for i, log in enumerate(logs):
        if not all(np.isfinite(v) for v in log.values()):
            raise RuntimeError(f"step {i + 1}: non-finite value in {log}")
    if not (any(k.endswith("running_var") for k in changed)
            and any(k.endswith("q_proj.weight") for k in changed)
            and any("mlp_convs" in k for k in changed)):
        raise RuntimeError("training left weights or BatchNorm statistics "
                           "unchanged")
    if (launches["knn"] != 3 * TRAIN_STEPS
            or launches["linear_attention"] != 4 * TRAIN_STEPS):
        raise RuntimeError(f"want 3 kNN and 4 attention launches per "
                           f"forward over {TRAIN_STEPS} steps, got {launches}")
    print(f"[train] kernels on: {TRAIN_STEPS} steps of {pairs} pairs x 128 "
          f"points; launches {launches}; loss "
          f"{[round(x['reid_loss'], 4) for x in logs]}; grad_norm "
          f"{[round(x['grad_norm'], 3) for x in logs]}", flush=True)
    TRAIN_MS.update(median=float(np.median(times[2:])), step1=logs[0],
                    peak_gib=peak / 2 ** 30, pairs=pairs)
    print(f"[train] median step {np.median(times[2:]):.1f} ms (steps 3-"
          f"{TRAIN_STEPS}; all: {[round(x, 1) for x in times]}), peak memory "
          f"{peak / 2 ** 30:.2f} GiB on {card}", flush=True)

    # the same first step with both knobs off: plain kNN and attention
    torch.cuda.empty_cache()
    plain_logs, plain_times, _, plain_peak = train_flagship(False, pairs, 3,
                                                            None)
    if kk.knn.launches != launches["knn"] or (
            la.linear_attention_forward.launches
            != launches["linear_attention"]):
        raise RuntimeError("the plain run launched a kernel")
    for key in ("reid_loss", "grad_norm"):
        a, b = logs[0][key], plain_logs[0][key]
        rel = abs(a - b) / max(abs(b), 1e-12)
        print(f"[train] step 1 {key}: kernels {a:.6f}, plain {b:.6f}, rel "
              f"{rel:.2e} (tol {TRAIN_TOL:g})", flush=True)
        if not rel <= TRAIN_TOL:
            raise RuntimeError(f"step 1 {key} differs with the kernels on")
    print(f"[train] knobs off: step 3 {plain_times[2]:.1f} ms, peak memory "
          f"{plain_peak / 2 ** 30:.2f} GiB on {card}", flush=True)
    return launches


def image_model(variant: str):
    """The image model of the tools (deit-tiny-no-pt, 197 tokens) or its
    distilled twin (deit-tiny, 198 tokens), full width, seeded weights."""
    import torch
    from point_cloud_reid_tpu_torch.configs import image_deit_point_cat
    from point_cloud_reid_tpu_torch.models import build_model
    return build_model(image_deit_point_cat(variant), device=DEVICE,
                       generator=torch.Generator().manual_seed(SEED))


def phase_image_kernels():
    """The image instantiation of the match kernel against its plain
    version, on the model's own token features: grids of 64 x 64 at S=198
    (deit-tiny) and of 64 x 64 and 128 x 64 (the dense frame's shape once
    its tracks pad to 128) at S=197 (deit-tiny-no-pt, the main path's
    model), and a 512-pair list at S=197, equal to the grid at the same
    indices bit for bit."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.timing import time_ms
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    n = IMG_OBJ
    sizes = {198: ((n, n),), 197: ((n, n), (2 * n, n))}
    for variant, want_s in (("deit-tiny", 198), ("deit-tiny-no-pt", 197)):
        model = image_model(variant)
        nt_max = max(a for a, _ in sizes[want_s])
        with torch.no_grad():
            crops = torch.rand((nt_max + n, 3, 224, 224), generator=gen,
                               device=DEVICE)
            h = model.downsample_tokens(model.embed(crops))
            t, d, w1, w2, nhead = mg.image_match_factors(
                model, h[:nt_max].contiguous(), h[nt_max:].contiguous())
        S, width = h.shape[1], h.shape[2]
        if S != want_s:
            raise RuntimeError(f"{variant}: {S} tokens, want {want_s}")
        weights = list(w1.values()) + list(w2.values())
        for nt, nd in sizes[S]:
            ts = tuple(x[:nt].contiguous() for x in t)
            ti = torch.arange(nt, device=DEVICE).repeat_interleave(nd)
            di = torch.arange(nd, device=DEVICE).repeat(nt)
            grid = mg.fused_image_match_grid(ts, d, w1, w2, nhead)
            want = mg.match_pooled_reference(ts, d, w1, w2, nhead, ti, di
                                             ).reshape(nt, nd, -1)
            torch.cuda.synchronize()
            g_err, g_rel = rel_err(grid, want)
            g_ms = time_ms(lambda: mg.fused_image_match_grid(
                ts, d, w1, w2, nhead), 5)
            g_plain = time_ms(lambda: mg.match_pooled_reference(
                ts, d, w1, w2, nhead, ti, di), 3, warmup=1)
            g_bound, g_by, g_simt = match_bound(
                nt * nd, S, width, nbytes(*ts, *d, *weights, grid))
            print(f"[image_match] grid {nt}x{nd} S={S} C={width} ({variant}):"
                  f" max_abs_err={g_err:.3e} rel={g_rel:.3e} (tol "
                  f"{MATCH_TOL:g}) kernel {g_ms:.3f} ms, plain {g_plain:.3f}"
                  f" ms, bound {g_bound:.3f} ms ({g_by}; float32 CUDA-core "
                  f"bound {g_simt:.3f} ms)", flush=True)
            if not g_rel <= MATCH_TOL:
                raise RuntimeError(f"fused_image_match_grid disagrees at "
                                   f"{nt}x{nd}, S={S}: rel {g_rel}")
            if nt == n:
                ms_square = g_ms
    # the grid row carries the main path's shape, 128 x 64 at S=197, and the
    # 64 x 64 time beside it; no one PyTorch call computes the chain (two
    # attention stages, three LayerNorms and two FFNs a direction): no
    # library time
    rows = [dict(name="fused_image_match_grid", route="cuda",
                 source="point_cloud_reid_tpu_torch/csrc/match_grid.cu",
                 replaces="point_cloud_reid_tpu/ops/pallas/match_grid.py:686",
                 max_abs_err=g_err, ms=g_ms, ms_64x64=ms_square,
                 plain_ms=g_plain, bound_ms=g_bound, bound_by=g_by,
                 simt_fp32_bound_ms=g_simt, library_ms=None)]

    P = 512
    t_idx = torch.randint(0, 2 * n, (P,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    d_idx = torch.randint(0, n, (P,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    pairs = mg.fused_image_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    want = mg.match_pooled_reference(t, d, w1, w2, nhead, t_idx, d_idx)
    torch.cuda.synchronize()
    p_err, p_rel = rel_err(pairs, want)
    at_grid = grid[t_idx.long(), d_idx.long()]
    pg_err, _ = rel_err(pairs, at_grid)
    p_ms = time_ms(lambda: mg.fused_image_match_pairs(
        t, d, w1, w2, nhead, t_idx, d_idx), 10)
    p_plain = time_ms(lambda: mg.match_pooled_reference(
        t, d, w1, w2, nhead, t_idx, d_idx), 3)
    p_bound, p_by, p_simt = match_bound(
        P, S, width, nbytes(*t, *d, *weights, t_idx, d_idx, pairs))
    print(f"[image_match] pairs P={P} S={S}: max_abs_err={p_err:.3e} "
          f"rel={p_rel:.3e} vs plain (tol {MATCH_TOL:g}), {pg_err:.3e} vs "
          f"the grid kernel at the same indices (want 0); kernel "
          f"{p_ms:.3f} ms, plain {p_plain:.3f} ms, bound {p_bound:.3f} ms "
          f"({p_by}; float32 CUDA-core bound {p_simt:.3f} ms)", flush=True)
    if not (p_rel <= MATCH_TOL and torch.equal(pairs, at_grid)):
        raise RuntimeError(f"fused_image_match_pairs disagrees: {p_rel}, "
                           f"{pg_err}")
    rows.append(dict(name="fused_image_match_pairs", route="cuda",
                     source="point_cloud_reid_tpu_torch/csrc/match_grid.cu",
                     replaces="point_cloud_reid_tpu/ops/pallas/match_grid.py:514",
                     max_abs_err=p_err, ms=p_ms, plain_ms=p_plain,
                     bound_ms=p_bound, bound_by=p_by,
                     simt_fp32_bound_ms=p_simt, library_ms=None))
    return rows, model


def phase_fps_kernel():
    """Farthest point sampling from random start indices at FPS_SHAPES:
    indices equal to the plain loop's on exact-arithmetic, duplicated and
    random inputs, int64 and int32 start indices; a call's time from Python
    and its device time (a CUDA graph of calls) and time a round; one
    device kernel a call. The row's sums are the FPS path's three SA
    shapes."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import fps as kf
    from point_cloud_reid_tpu_torch.tools.timing import (device_kernels,
                                                         graph_ms, time_ms)
    shapes, mismatches = {}, 0
    for i, (B, N, npoint) in enumerate(FPS_SHAPES):
        start = torch.from_numpy(np.random.RandomState(SEED + i).randint(
            0, N, B)).to(DEVICE)
        for kind in ("exact", "duplicates", "random"):
            xyz = knn_cloud(kind, B, N, SEED + i)
            want = kf.fps_reference(xyz, npoint, start)
            for first in (start, start.int()):
                got = kf.fps(xyz, npoint, first)
                torch.cuda.synchronize()
                bad = int((got != want).sum().item())
                mismatches += bad
                if bad or got.dtype != torch.int64 or not torch.equal(
                        got[:, 0], start):
                    raise RuntimeError(
                        f"fps {kind} B={B} N={N} npoint={npoint} start "
                        f"{first.dtype}: {bad} indices differ from the plain "
                        "loop")
        k_ms = time_ms(lambda: kf.fps(xyz, npoint, start), 20)
        d_ms = graph_ms(lambda: kf.fps(xyz, npoint, start), 20)
        p_ms = time_ms(lambda: kf.fps_reference(xyz, npoint, start), 3,
                       warmup=1)
        # 8 flops a distance, N distances a round; the arg-max is not counted
        b_ms, b_by = bound_ms(8.0 * B * npoint * N,
                              nbytes(xyz, start) + B * npoint * 8)
        plan = kf.plan(N)
        shapes[f"B{B}_N{N}_np{npoint}"] = dict(
            tier=kf.TIER_NAMES[plan.tier], ms=k_ms, device_ms=d_ms,
            round_us=d_ms / max(npoint - 1, 1) * 1e3, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by)
        print(f"[fps] B={B} N={N} npoint={npoint} (tier "
              f"{kf.TIER_NAMES[plan.tier]}): indices equal on exact, "
              f"duplicated and random inputs, int64 and int32 starts; a call "
              f"{k_ms:.4f} ms, device {d_ms:.5f} ms "
              f"({d_ms / max(npoint - 1, 1) * 1e3:.4f} us a round), plain "
              f"{p_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by})", flush=True)
    B, N, npoint = FPS_SHAPES[0]
    xyz = knn_cloud("random", B, N, SEED)
    start = torch.zeros(B, dtype=torch.int64, device=DEVICE)
    names = device_kernels(lambda: kf.fps(xyz, npoint, start))
    print(f"[fps] device kernels in one call: {len(names)} {names}",
          flush=True)
    if len(names) != 1:
        raise RuntimeError(f"an FPS call ran {len(names)} device kernels")
    path = [shapes[f"B{B}_N{N}_np{npoint}"] for B, N, npoint in
            FPS_SHAPES[:3]]

    def total(key):
        return sum(r[key] for r in path)
    # PyTorch has no farthest-point-sampling call: no library time
    return [dict(name="fps", route="cuda",
                 source="point_cloud_reid_tpu_torch/csrc/fps.cu",
                 replaces="point_cloud_reid_tpu/ops/pallas/fps.py:58",
                 max_abs_err=0.0, mismatches=mismatches, ms=total("ms"),
                 device_ms=total("device_ms"),
                 round_us=[r["round_us"] for r in path],
                 plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                 bound_by=max((r["bound_ms"], r["bound_by"])
                              for r in path)[1],
                 kernels_a_call=len(names), library_ms=None, shapes=shapes)]


def run_image_scene(model, sparse: str):
    """10 frames of the bench's six-camera scene; the frame's images are
    uploaded inside the step's clock. Returns (per-frame ms, scorer,
    manager, the last frame's inputs)."""
    import torch
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.tools.scenes import image_scene
    from point_cloud_reid_tpu_torch.tracking import TrackingManager
    scorer = PairScorer(model, image_mode=True)
    mgr = TrackingManager(scorer, match_threshold=1.0, seed=SEED,
                          sparse_scoring=sparse)
    times, frame = [], None
    for frame in image_scene(IMG_OBJ, IMG_FRAMES, SEED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.step(*frame)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        last = scorer.last_frame
        if last is not None and not bool(torch.isfinite(last["logits"]).all()):
            raise RuntimeError(f"non-finite logits in image scene '{sparse}'")
    return times, scorer, mgr, frame


def check_image_frame(model, rec, frame, label: str):
    """Last frame's logits vs plain hoisted scoring
    (ImageReIDNet.match_logits_grid, no kernel) on the card over the frame's
    own token features, plus a CPU plain crop + embed of 4 detections."""
    import torch
    from point_cloud_reid_tpu_torch.tracking.image_crops import (
        crops_per_frame)
    (images, l2cs, Ks), boxes = frame[0], frame[1]
    with torch.no_grad():
        plain = model.match_logits_grid(rec["h_t"], rec["h_d"])
        if rec["pairs"] is not None:
            pt, pd = rec["pairs"]
            plain = plain[pt.long(), pd.long()]
        got = rec["logits"]
        err = (got - plain).abs().max().item()
        bound = FRAME_TOL * (1.0 + plain.abs().max().item())
        n = 4
        cpu = copy.deepcopy(model).cpu()
        crops, valid = crops_per_frame(
            torch.from_numpy(images), torch.from_numpy(l2cs),
            torch.from_numpy(Ks), torch.from_numpy(boxes[:n]),
            image_size=(images.shape[3], images.shape[2]))
        h_cpu = cpu.downsample_tokens(cpu.embed(crops))
        e_err = (h_cpu - rec["h_d"][:n].cpu()).abs().max().item()
        e_bound = FRAME_TOL * (1.0 + h_cpu.abs().max().item())
    print(f"[image_frame:{label}] logits vs plain scoring: max_abs_err="
          f"{err:.3e} (bound {bound:.3e}); CPU plain crop + embed of {n} "
          f"detections ({int(valid.sum())} visible): {e_err:.3e} (bound "
          f"{e_bound:.3e})", flush=True)
    if not (err <= bound and e_err <= e_bound and bool(valid.all())):
        raise RuntimeError(f"image frame check failed in scene '{label}'")


def phase_image_path(model, card: str):
    every = zero_counters()
    names = ("fused_image_match_grid", "fused_image_match_pairs")
    dense_ms, dense_rec, dense_mgr, dense_frame = run_image_scene(model,
                                                                  "never")
    after_dense = [every[k].launches for k in names]
    sparse_ms, sparse_rec, sparse_mgr, sparse_frame = run_image_scene(
        model, "always")
    launches = {name: fn.launches for name, fn in every.items()}
    in_sparse = [launches[k] - a for k, a in zip(names, after_dense)]
    print(f"[image] launches dense scene (grid, pairs) = {after_dense}, "
          f"sparse scene = {in_sparse}", flush=True)
    # one launch per frame with tracks (all but the first), nothing rerouted
    if after_dense != [IMG_FRAMES - 1, 0] or in_sparse != [0, IMG_FRAMES - 1]:
        raise RuntimeError("the image scenes did not launch the image grid "
                           "kernel (dense) and the image pair kernel (sparse) "
                           "once per frame with tracks")
    other = {k: v for k, v in launches.items() if k not in names and v}
    if other:
        raise RuntimeError(f"the image path launched {other}")
    for label, ms, mgr in (("dense", dense_ms, dense_mgr),
                           ("sparse", sparse_ms, sparse_mgr)):
        print(f"[image] {label}: {len(mgr.store.active())} active tracks, "
              f"median steady-state step {np.median(ms[3:]):.3f} ms "
              f"(frames 4-10, upload of "
              f"{dense_frame[0][0].nbytes / 1e6:.1f} MB of uint8 frames "
              f"inside; all: {[round(x, 1) for x in ms]}) on {card}",
              flush=True)
    check_image_frame(model, dense_rec.last_frame, dense_frame, "dense")
    check_image_frame(model, sparse_rec.last_frame, sparse_frame, "sparse")
    return launches


def phase_fps_path():
    """Three SA stages of the flagship's widths with FPS-sampled centres,
    eval mode, on 128 crops of 128 points; against the same stages with the
    plain FPS loop in the kernel's place."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import fps as kf
    from point_cloud_reid_tpu_torch.models.build import init_weights
    from point_cloud_reid_tpu_torch.models.point_transformer import (
        SetAbstractionEdgeSA)
    specs = (([3, 128, 128, 128], 32, 128), ([259, 256, 256, 256], 48, 64),
             ([515, 512, 512, 512], 48, 32))
    stages = torch.nn.ModuleList(
        SetAbstractionEdgeSA(mlp, k, knn_method="pallas", sampling="FPS")
        for mlp, k, _ in specs)
    init_weights(stages, torch.Generator().manual_seed(SEED))
    stages.to(DEVICE).eval().requires_grad_(False)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    crops = torch.randn((FPS_CROPS, 128, 3), generator=gen,
                        device=DEVICE) * 0.6

    def run():
        xyz, points, outs = crops, None, []
        with torch.no_grad():
            for stage, (_, _, S) in zip(stages, specs):
                xyz, points = stage(xyz, points, S)
                outs.append((xyz, points))
        torch.cuda.synchronize()
        return outs

    every = zero_counters()
    got = run()
    launches = {name: fn.launches for name, fn in every.items()}
    want_launches = dict(fps=3, knn=3)
    if {k: v for k, v in launches.items() if v} != want_launches:
        raise RuntimeError(f"FPS path: want launches {want_launches} and no "
                           f"other, got {launches}")
    kernel = kf.fps
    try:     # the same stages with the plain loop in the kernel's place
        kf.fps = kf.fps_reference
        want = run()
    finally:
        kf.fps = kernel
    if kernel.launches != 3:
        raise RuntimeError("the plain FPS run launched the kernel")
    worst = 0.0
    for i, ((gx, gh), (wx, wh)) in enumerate(zip(got, want)):
        if not torch.equal(gx, wx):
            raise RuntimeError(f"FPS stage {i + 1}: centres differ")
        err, rel = rel_err(gh, wh)
        worst = max(worst, rel)
        if not (rel <= SA_TOL and bool(torch.isfinite(gh).all())):
            raise RuntimeError(f"FPS stage {i + 1}: features differ, rel "
                               f"{rel}")
    first = not torch.equal(got[0][0][:, :8], crops[:, :8])
    print(f"[fps_path] {FPS_CROPS} crops x 128 points through 3 FPS-sampled "
          f"SA stages: launches fps=3 knn=3 sa_convmax=0; centres equal "
          f"plain FPS (and are not the first points: {first}); features "
          f"rel {worst:.3e} (tol {SA_TOL:g}); shapes "
          f"{[tuple(h.shape) for _, h in got]}", flush=True)
    if not first:
        raise RuntimeError("FPS centres are the first points")
    return launches


def check_host_logits(model, rec, label: str):
    """A host-cache frame's logits (the padded grid) against plain hoisted
    scoring of the same inputs: rel_err within MATCH_TOL."""
    import torch
    with torch.no_grad():
        if rec["xyz_t"] is None:
            plain = model.match_logits_grid(rec["h_t"], rec["h_d"])
        else:
            plain = model.match_logits_grid(rec["h_t"], rec["xyz_t"],
                                            rec["h_d"], rec["xyz_d"])
    err, rel = rel_err(rec["logits"], plain)
    print(f"[tracker_host:{label}] {tuple(plain.shape)} logits vs plain "
          f"scoring: max_abs_err={err:.3e} rel={rel:.3e} (tol {MATCH_TOL:g})",
          flush=True)
    if not (rel <= MATCH_TOL and bool(torch.isfinite(rec["logits"]).all())):
        raise RuntimeError(f"host-cache logits disagree ({label}): {rel}")


def cli_scene(path: str):
    """Write the CLI's .npz scene (tools/track.py format) of CLI_FRAMES
    frames; returns the per-frame indices of the original detections."""
    rs = np.random.RandomState(SEED + 1)
    gx, gy = np.meshgrid(np.arange(12) * 5.0 - 27.5, np.arange(8) * 5.0 - 17.5)
    centers = np.stack([gx.ravel(), gy.ravel(), np.zeros(N_CLI)],
                       axis=1).astype(np.float32)
    n = N_CLI
    dup_of = np.arange(0, n, CLI_DUP_EVERY)
    scene, originals = {}, []
    for t in range(CLI_FRAMES):
        centers[:, :2] += rs.randn(n, 2).astype(np.float32) * 0.2
        boxes = np.concatenate([centers, np.full((n, 3), 2.0, np.float32),
                                np.zeros((n, 1), np.float32)], axis=1)
        dups = boxes[dup_of] + np.array([0.3, 0.2, 0, 0, 0, 0, 0.05],
                                        np.float32)
        # duplicates interleaved at seeded places among the originals
        order = rs.permutation(n + len(dup_of))
        all_boxes = np.concatenate([boxes, dups])[order]
        scene[f"boxes_{t}"] = all_boxes
        scene[f"scores_{t}"] = np.where(order < n, 1.0, 0.5).astype(
            np.float32)
        scene[f"labels_{t}"] = np.zeros(len(order), np.int64)
        scene[f"gt_ids_{t}"] = np.where(order < n, order, -1)
        scene[f"points_{t}"] = (np.repeat(centers, PTS_PER_OBJ, axis=0)
                                + rs.randn(n * PTS_PER_OBJ, 3).astype(
                                    np.float32) * 0.5)
        originals.append(np.flatnonzero(order < n))
    np.savez(path, **scene)
    return originals


def phase_tracker_host(card: str, image):
    """The rest of the tracker on the card: the host-cache point frame, the
    CLI over an .npz scene from a port checkpoint, and the image tracker on
    the host cache. Returns the launch counts."""
    import contextlib
    import io
    import shutil
    import torch
    from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.ops.boxes import boxes_iou_bev, nms_bev
    from point_cloud_reid_tpu_torch.tools import track
    from point_cloud_reid_tpu_torch.tools.scenes import image_scene
    from point_cloud_reid_tpu_torch.tools.timing import time_ms
    from point_cloud_reid_tpu_torch.tracking import TrackingManager
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig, Trainer,
                                                  TrainState)
    t_phase = time.perf_counter()
    every = zero_counters()
    sa, grid = every["fused_sa_convmax"], every["fused_match_grid"]
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_tracker")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # 1. point frames on the host FeatureCache
    model = build_model(point_transformer_point_cat(), device=DEVICE,
                        generator=torch.Generator().manual_seed(SEED))
    host_ms, scorer, mgr = run_scene(model, "never", device_cache=False)
    print(f"[tracker_host] point host cache: {len(mgr.store.active())} "
          f"active tracks, launches sa={sa.launches} grid={grid.launches}; "
          f"median steady-state step {np.median(host_ms[3:]):.3f} ms against "
          f"the device cache's {STEP_MS['dense']:.3f} ms (dense) / "
          f"{STEP_MS['sparse']:.3f} ms (sparse) (frames 4-10; all: "
          f"{[round(x, 1) for x in host_ms]}) on {card}", flush=True)
    if not (sa.launches > 0 and grid.launches == FRAMES - 1
            and len(mgr.cache) == len(mgr.store) and mgr._dc.h_buf is None):
        raise RuntimeError("the host-cache scene did not run the SA and grid "
                           "kernels on the FeatureCache path")
    check_host_logits(model, scorer.last_frame, "point")
    check_frame(model, scorer.last_frame, "host")

    # 2. the CLI from a Trainer checkpoint over an .npz scene, with NMS
    state = TrainState.create(model, ScheduleConfig(max_epochs=1), 1)
    ckpt = Trainer(model, None, None, dict(work_dir=work)).save_checkpoint(
        state, tag="best")
    del state, model, scorer, mgr
    os.makedirs(os.path.join(work, "scenes"))
    originals = cli_scene(os.path.join(work, "scenes", "scene0.npz"))
    kept, nms_ms = [], []
    nms = TrackingManager._nms

    def counted_nms(self, boxes, scores):
        t0 = time.perf_counter()
        keep = nms(self, boxes, scores)      # ends in a fetch: synchronous
        nms_ms.append((time.perf_counter() - t0) * 1e3)
        kept.append(np.sort(keep))
        return keep
    before = {k: fn.launches for k, fn in every.items()}
    out = io.StringIO()
    TrackingManager._nms = counted_nms
    try:
        with contextlib.redirect_stdout(out):
            track.main(["--checkpoint", ckpt, "--scene-dir",
                        os.path.join(work, "scenes"), "--nms-threshold",
                        str(NMS_THRESHOLD), "--method", "hungarian",
                        "--sparse", "auto", "--match-threshold", "1.0",
                        "--work-dir", os.path.join(work, "out")])
    finally:
        TrackingManager._nms = nms
    headline = json.loads(out.getvalue().strip().splitlines()[-1])
    with open(headline["outputs"]["tracks"]) as f:
        lines = [json.loads(line) for line in f]
    cli = {k: fn.launches - before[k] for k, fn in every.items()}
    n_det = N_CLI + len(range(0, N_CLI, CLI_DUP_EVERY))
    print(f"[tracker_host:cli] NMS at {NMS_THRESHOLD} kept "
          f"{[len(k) for k in kept]} of {n_det} detections a frame "
          f"(removed {sum(n_det - len(k) for k in kept)}) in "
          f"{[round(x, 2) for x in nms_ms]} ms; launches {cli}; "
          f"{len(lines)} tracks.jsonl lines; headline "
          f"{json.dumps(headline)}", flush=True)
    if not (len(kept) == CLI_FRAMES and all(
            np.array_equal(k, o) for k, o in zip(kept, originals))):
        raise RuntimeError("NMS did not drop exactly the duplicates")
    if not (len(lines) == CLI_FRAMES and headline["frames"] == CLI_FRAMES
            and all(len(r["tracks"]) == N_CLI for r in lines)
            and cli["fused_sa_convmax"] > 0 and cli["fused_match_pairs"] > 0):
        raise RuntimeError("the CLI run did not track the scene through the "
                           "SA and pair kernels")

    # BEV NMS alone at larger frames: a call ends in its fetch
    rs = np.random.RandomState(SEED)
    nms_at, same = {}, {}
    for D in (128, 256, 512):
        b = np.concatenate([rs.rand(D, 2) * 60 - 30, np.zeros((D, 1)),
                            rs.rand(D, 3) * 2 + 1, rs.rand(D, 1) * 3],
                           axis=1).astype(np.float32)
        bt = torch.from_numpy(b).to(DEVICE)
        st = torch.from_numpy(rs.rand(D).astype(np.float32)).to(DEVICE)
        keep = nms_bev(bt, st, NMS_THRESHOLD, D)
        want = nms_bev(bt.cpu(), st.cpu(), NMS_THRESHOLD, D)
        # rounding may flip only an IoU within 1e-5 of the threshold
        margin = (boxes_iou_bev(bt.cpu(), bt.cpu()) - NMS_THRESHOLD).abs()
        same[D] = torch.equal(keep, want)
        if not (same[D] or margin.min() < 1e-5):
            raise RuntimeError(f"nms_bev at D={D}: card and CPU keep lists "
                               "differ")
        nms_at[D] = time_ms(lambda: nms_bev(bt, st, NMS_THRESHOLD, D), 5)
    print(f"[tracker_host:nms] nms_bev ms a call "
          f"{({d: round(v, 3) for d, v in nms_at.items()})}, keep list equal "
          f"to the CPU's {same} on {card}", flush=True)

    # 3. the image tracker on the host cache (camera crops + cost_matrix)
    iscorer = PairScorer(image, image_mode=True)
    imgr = TrackingManager(iscorer, match_threshold=1.0, seed=SEED,
                           device_cache=False)
    img_grid = every["fused_image_match_grid"]
    g0, img_ms = img_grid.launches, []
    for frame in image_scene(IMG_OBJ, HOST_IMG_FRAMES, SEED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgr.step(*frame)
        torch.cuda.synchronize()
        img_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[tracker_host:image] host cache, {HOST_IMG_FRAMES} frames of "
          f"{IMG_OBJ} objects: {len(imgr.store.active())} active tracks, "
          f"image grid launches {img_grid.launches - g0}, median "
          f"steady-state step {np.median(img_ms[3:]):.3f} ms (frames 4-10, "
          f"upload inside; all: {[round(x, 1) for x in img_ms]}) on {card}",
          flush=True)
    if not (img_grid.launches - g0 == HOST_IMG_FRAMES - 1
            and len(imgr.cache) == len(imgr.store) >= IMG_OBJ):
        raise RuntimeError("the image host cache did not run the image grid "
                           "kernel once per frame with tracks")
    check_host_logits(image, iscorer.last_frame, "image")
    check_image_frame(image, iscorer.last_frame, frame, "host")
    shutil.rmtree(work, ignore_errors=True)
    print(f"[tracker_host] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {name: fn.launches for name, fn in every.items()}


def data_path_hooks():
    """Wrap what the CLIs run, to watch them: sample_batch and the native
    strided read (counted), the train step (timed around a synchronise,
    its kernel launches and losses kept, the weights before step 1 kept)
    and the eval step and Trainer.evaluate (logits and wall time kept).
    Returns (record dict, undo)."""
    import torch
    from point_cloud_reid_tpu_torch import native
    from point_cloud_reid_tpu_torch.data import PairDataset
    from point_cloud_reid_tpu_torch.train import loop
    rec = dict(sample_batch=[], native=0, steps=[], logits=[], evals=[],
               before=None)
    counters = all_counters()
    saved = (PairDataset.sample_batch, native.load_point_batch_strided,
             loop.make_train_step, loop.make_eval_step,
             loop.Trainer.evaluate)

    def sample_batch(self, indices):
        rec["sample_batch"].append(type(self).__name__)
        return saved[0](self, indices)

    def strided(*args, **kw):
        rec["native"] += 1
        return saved[1](*args, **kw)

    def make_train_step(*args, **kw):
        step = saved[2](*args, **kw)

        def timed(state, *a, **k):
            if rec["before"] is None:
                rec["before"] = {n: v.clone() for n, v in
                                 state.model.state_dict().items()}
            torch.cuda.synchronize()
            n0 = {n: fn.launches for n, fn in counters.items()}
            t0 = time.perf_counter()
            out = step(state, *a, **k)
            log = {n: float(v) for n, v in out[1].items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec["steps"].append(dict(t0=t0, t1=t1, log=log, launches={
                n: fn.launches - n0[n] for n, fn in counters.items()}))
            return out
        return timed

    def make_eval_step(*args, **kw):
        step = saved[3](*args, **kw)

        def kept(*a, **k):
            res = step(*a, **k)
            rec["logits"].append(res["val_match_preds"])
            return res
        return kept

    def evaluate(self, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = saved[4](self, state)
        rec["evals"].append(dict(s=time.perf_counter() - t0,
                                 batches=len(self.val_loader),
                                 pairs=len(self.val_loader)
                                 * self.val_loader.batch_size))
        return metrics

    PairDataset.sample_batch = sample_batch
    native.load_point_batch_strided = strided
    loop.make_train_step, loop.make_eval_step = make_train_step, \
        make_eval_step
    loop.Trainer.evaluate = evaluate

    def undo():
        (PairDataset.sample_batch, native.load_point_batch_strided,
         loop.make_train_step, loop.make_eval_step,
         loop.Trainer.evaluate) = saved
    return rec, undo


def quiet(fn, *args):
    """fn(*args) with its standard output (the CLIs' metric dumps) held."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def check_native_batch(root: str) -> dict:
    """The train set's first batch of 2 x 256 crops: the native read equal
    to the plain numpy version bit for bit, both timed."""
    from point_cloud_reid_tpu_torch import native
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.data import CropStore, build_pair_dataset
    from point_cloud_reid_tpu_torch.native import plain
    from point_cloud_reid_tpu_torch.tools.profile_loader import crop_reads
    spec = get_experiment(FLAGSHIP)["dataset"]["train"]
    ds = build_pair_dataset(spec, CropStore(root))
    rows, seeds = crop_reads(ds, np.arange(DATA_PAIRS))
    k = spec["subsample_sparse"]
    t0 = time.perf_counter()
    got = native.load_point_batch_strided(rows, k, seeds)
    t1 = time.perf_counter()
    want = plain.load_point_batch([r.decode() for r in rows], k, seeds)
    t2 = time.perf_counter()
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    out = dict(crops=len(rows), equal=same, native_ms=(t1 - t0) * 1e3,
               plain_ms=(t2 - t1) * 1e3)
    print(f"[data:native] {len(rows)} crops x {k} points: native "
          f"{out['native_ms']:.2f} ms, plain numpy {out['plain_ms']:.1f} ms, "
          f"equal bit for bit: {same}", flush=True)
    if not same:
        raise RuntimeError("the native loader's batch differs from the plain "
                           "numpy version")
    return out


def loader_rate(root: str, card: str) -> dict:
    """The BatchLoaders of tools/train.py with no model: pairs/s over the
    train set's epochs 0-2 and over one pass of the val set."""
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.data import (BatchLoader, CropStore,
                                                 build_pair_dataset)
    from point_cloud_reid_tpu_torch.train import pin_batch
    dcfg = get_experiment(FLAGSHIP)["dataset"]
    store = CropStore(root)
    out = {}
    for split in ("train", "val"):
        ds = build_pair_dataset(dcfg[split], store)
        loader = BatchLoader(ds, DATA_PAIRS, shuffle=split == "train",
                             seed=66, num_threads=2, transform=pin_batch)
        rates = []
        for epoch in range(3 if split == "train" else 1):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            n = sum(len(b["id_1"]) for b in loader)
            rates.append(n / (time.perf_counter() - t0))
        out[split] = dict(batches=len(loader), pairs_per_s=rates)
    print(f"[data:loader] BatchLoader alone (2 threads, pinned): train "
          f"{out['train']['batches']} batches of {DATA_PAIRS} pairs, "
          f"{[round(r) for r in out['train']['pairs_per_s']]} pairs/s "
          f"(epochs 0-2); val {out['val']['batches']} batches, "
          f"{round(out['val']['pairs_per_s'][0])} pairs/s; on {card}",
          flush=True)
    return out


def phase_data_path(card: str):
    """Phase 8: the native loader, an on-disk store, tools/train.py --root
    for one epoch and tools/test.py from its checkpoint, at full width.
    Returns (launch counts, summary)."""
    import shutil

    import torch
    from point_cloud_reid_tpu_torch import native
    from point_cloud_reid_tpu_torch.kernels import sa_stage
    from point_cloud_reid_tpu_torch.models import point_transformer
    from point_cloud_reid_tpu_torch.tools import make_synthetic_data
    from point_cloud_reid_tpu_torch.tools import test as test_cli
    from point_cloud_reid_tpu_torch.tools import train as train_cli
    t_phase = time.perf_counter()
    work = DATA_WORK
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "store")
    t0 = time.perf_counter()
    if not native.available():
        native.LOADER.get()               # raises with the compiler's output
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    quiet(make_synthetic_data.main, [root, "--objects", str(STORE_OBJECTS),
                                     "--frames", str(STORE_FRAMES), "--seed",
                                     str(SEED)])
    print(f"[data] native loader built in {build_s:.1f} s; store of "
          f"{STORE_OBJECTS} objects x {STORE_FRAMES} frames written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    summary = dict(native=check_native_batch(root))
    sets, plain_sets = [], []
    for knob in KNOBS:
        sets += ["--set", knob]
    for knob in PLAIN_KNOBS:
        plain_sets += ["--set", knob]

    # train one epoch through the CLI
    rec, undo = data_path_hooks()
    every = zero_counters()
    try:
        train_dir = os.path.join(work, "train")
        quiet(train_cli.main, [FLAGSHIP, "--root", root, "--epochs", "1",
                               "--work-dir", train_dir, *sets])
        ckpt = os.path.join(train_dir, "ckpt_final.pt")
        trained = dict(rec)
        n_train = rec["sample_batch"].count("PairDataset")
        steps = rec["steps"]
        rec.update(sample_batch=[], native=0, logits=[], evals=[])
        after_train = {name: fn.launches for name, fn in every.items()}
        test_dir = os.path.join(work, "test")
        quiet(test_cli.main, ["testing_" + FLAGSHIP, "--root", root,
                              "--checkpoint", ckpt, "--work-dir", test_dir,
                              *sets])
        launches = {name: fn.launches for name, fn in every.items()}
        in_eval = {n: launches[n] - after_train[n] for n in launches}
        kernel_logits = torch.cat(rec["logits"]).cpu()
        kernel_eval = rec["evals"][-1]
        n_val = rec["sample_batch"].count("ValEvenPairs")
        with open(os.path.join(test_dir, "eval_results_full.json")) as f:
            report = json.load(f)
        # the same checkpoint's plain run on the card: knobs off and the SA
        # stages' plain version
        rec.update(logits=[], evals=[])
        stage = point_transformer.sa_stage_inference
        point_transformer.sa_stage_inference = sa_stage.sa_stage_reference
        try:
            quiet(test_cli.main, ["testing_" + FLAGSHIP, "--root", root,
                                  "--checkpoint", ckpt, "--work-dir",
                                  os.path.join(work, "plain"), *plain_sets])
        finally:
            point_transformer.sa_stage_inference = stage
        plain_logits = torch.cat(rec["logits"]).cpu()
        plain_eval = rec["evals"][-1]
        with open(os.path.join(work, "plain",
                               "eval_results_full.json")) as f:
            plain_report = json.load(f)
        if {n: fn.launches for n, fn in every.items()} != launches:
            raise RuntimeError("the plain eval launched a kernel")
    finally:
        undo()

    # the training run
    n_steps = len(steps)
    logs = [s["log"] for s in steps]
    waits = [(b["t0"] - a["t1"]) * 1e3 for a, b in zip(steps, steps[1:])]
    step_ms = [(s["t1"] - s["t0"]) * 1e3 for s in steps]
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    moved = {k for k, v in trained["before"].items()
             if not torch.equal(v.cpu(), saved[k])}
    print(f"[data:train] tools/train.py --root, 1 epoch: {n_steps} steps of "
          f"{DATA_PAIRS} pairs x 128 points; {n_train} train batches through "
          f"PairDataset.sample_batch, {trained['native']} native reads in the "
          f"train command (train + its closing eval); launches a step "
          f"{[s['launches'] for s in steps][:1]}; loss "
          f"{[round(x['reid_loss'], 4) for x in logs]}", flush=True)
    if not (n_steps == STORE_STEPS and n_train == n_steps
            and trained["native"] == len(trained["sample_batch"])):
        raise RuntimeError(f"want {STORE_STEPS} train batches through "
                           "sample_batch and the native reader")
    for s in steps:
        if (s["launches"]["knn"], s["launches"]["linear_attention"]) != (3, 4):
            raise RuntimeError(f"want 3 kNN and 4 attention launches a "
                               f"train step, got {s['launches']}")
        if not all(np.isfinite(v) for v in s["log"].values()):
            raise RuntimeError(f"non-finite value in {s['log']}")
    if not (any(k.endswith("running_var") for k in moved)
            and any(k.endswith("q_proj.weight") for k in moved)
            and any("mlp_convs" in k for k in moved)):
        raise RuntimeError("training left weights or BatchNorm statistics "
                           "unchanged")
    train = dict(steps=n_steps, step_ms=step_ms,
                 median_step_ms=float(np.median(step_ms[2:])),
                 loader_wait_ms=waits,
                 mean_loader_wait_ms=float(np.mean(waits)),
                 phase4_median_step_ms=TRAIN_MS.get("median"))
    DATA_MS.update(step=train["median_step_ms"],
                   wait=train["mean_loader_wait_ms"])
    print(f"[data:train] median step {train['median_step_ms']:.1f} ms (steps "
          f"3-{n_steps}; all {[round(x, 1) for x in step_ms]}) against phase "
          f"4's {TRAIN_MS.get('median', float('nan')):.1f} ms on synthetic "
          f"batches; waited on the loader {[round(x, 2) for x in waits]} ms "
          f"between steps (mean {train['mean_loader_wait_ms']:.2f}); on "
          f"{card}", flush=True)
    summary["train"] = train
    summary["loader"] = loader_rate(root, card)

    # the evaluation
    keys = {"val_match_acc", "val_match_f1_pos", "val_match_precision_pos",
            "val_match_recall_pos"}
    strata = {"per_class", "results_per_points", "results_per_visibility",
              "results_per_distance"}
    if not (keys <= set(report) and strata == set(report["stratified"])):
        raise RuntimeError(f"eval_results_full.json lacks metrics: "
                           f"{sorted(report)}")
    nb = kernel_eval["batches"]
    if not (n_val == nb and in_eval["fused_sa_convmax"] == 3 * nb
            and in_eval["knn"] == 3 * nb
            and in_eval["linear_attention"] == 4 * nb):
        raise RuntimeError(f"want {nb} val batches through sample_batch "
                           f"and 3 SA, 3 kNN, 4 attention launches each, got "
                           f"{n_val} and {in_eval}")
    err = (kernel_logits - plain_logits).abs().max().item()
    bound = EVAL_TOL * max(1.0, plain_logits.abs().max().item())
    near = plain_logits.abs() <= bound
    flips = ((kernel_logits > 0) != (plain_logits > 0)) & ~near
    same_acc = report["val_match_acc"] == plain_report["val_match_acc"]
    evaluation = dict(
        batches=nb, pairs=kernel_eval["pairs"],
        ms_per_batch=kernel_eval["s"] * 1e3 / nb,
        pairs_per_s=kernel_eval["pairs"] / kernel_eval["s"],
        plain_ms_per_batch=plain_eval["s"] * 1e3 / nb,
        max_abs_err=err, bound=bound, near_zero_pairs=int(near.sum()),
        val_match_acc=report["val_match_acc"],
        plain_val_match_acc=plain_report["val_match_acc"])
    print(f"[data:eval] tools/test.py: {nb} batches of {DATA_PAIRS} pairs "
          f"(ValEvenPairs), launches {in_eval}; "
          f"{evaluation['ms_per_batch']:.1f} ms a batch, "
          f"{evaluation['pairs_per_s']:.0f} pairs/s (plain on the card "
          f"{evaluation['plain_ms_per_batch']:.1f} ms a batch); logits vs "
          f"plain max_abs_err {err:.3e} (bound {bound:.3e}), "
          f"{int(near.sum())} pairs with |plain logit| within it; "
          f"val_match_acc {report['val_match_acc']:.6f} (plain "
          f"{plain_report['val_match_acc']:.6f}); on {card}", flush=True)
    if not (err <= bound and not bool(flips.any())
            and (same_acc or int(near.sum()) > 0)):
        raise RuntimeError("eval logits or accuracy differ from the plain "
                           "run")
    summary["eval"] = evaluation
    # the store stays for phase 11's bf16 CLI run, which removes it
    for name in os.listdir(work):
        if name != "store":
            shutil.rmtree(os.path.join(work, name), ignore_errors=True)
    print(f"[data] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, summary


def family_knn() -> dict:
    """kNN past 128 points (tiers S and G) against its plain version at
    FAMILY_KNN: indices equal on exact and duplicated clouds, only near-tie
    swaps on random ones; times on the random ones. The row's own numbers
    are SA1's of the 2048-point ablation (512 crops)."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.tools.timing import graph_ms, time_ms
    S, k = 128, 32
    shapes, err, swaps_total = [], 0.0, 0
    for i, (B, N) in enumerate(FAMILY_KNN):
        how = kk.plan(N, k)
        swaps = {}
        for kind in ("exact", "duplicates", "random"):
            xyz = knn_cloud(kind, B, N, SEED + 10 + i)
            q = xyz[:, :S].contiguous()
            got, want = kk.knn(q, xyz, k), kk.knn_reference(q, xyz, k)
            torch.cuda.synchronize()
            bad = got != want
            swaps[kind] = int(bad.sum().item())
            dist = kk.square_distance(q, xyz)
            dg, dw = dist.gather(-1, got), dist.gather(-1, want)
            err = max(err, (dg - dw).abs().max().item())
            if kind != "random":
                if swaps[kind]:
                    raise RuntimeError(f"knn {kind} B={B} N={N}: "
                                       f"{swaps[kind]} indices differ")
                continue
            far = (dg - dw).abs()[bad] > KNN_TIE * dw.abs()[bad].clamp(min=1.0)
            if bool(far.any()):
                raise RuntimeError(f"knn random B={B} N={N}: {int(far.sum())}"
                                   " indices differ beyond a near-tie")
            del dist, dg, dw
        ms = time_ms(lambda: kk.knn(q, xyz, k), 10)
        device = graph_ms(lambda: kk.knn(q, xyz, k), 10)
        plain = time_ms(lambda: kk.knn_reference(q, xyz, k), 3)
        lib = time_ms(lambda: torch.cdist(q, xyz).topk(
            k, dim=-1, largest=False).indices, 3)
        b_ms, b_by = bound_ms(8.0 * B * S * N, nbytes(q, xyz, got))
        swaps_total += swaps["random"]
        shapes.append(dict(B=B, S=S, N=N, k=k, tier=kk.TIER_NAMES[how.tier],
                           ms=ms, device_ms=device, plain_ms=plain,
                           library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                           near_tie_swaps=swaps["random"]))
        print(f"[family:knn] B={B} S={S} N={N} k={k} tier "
              f"{kk.TIER_NAMES[how.tier]}: indices equal on exact and "
              f"duplicated inputs; random floats: {swaps['random']} of "
              f"{got.numel()} differ, all near-ties; kernel "
              f"{ms:.4f} ms (device {device:.4f}), plain {plain:.3f} ms, "
              f"cdist+topk {lib:.3f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
    sa1 = next(s for s in shapes if (s["B"], s["N"]) == (512, 2048))
    return dict(name="knn/scan", route="cuda",
                source="point_cloud_reid_tpu_torch/csrc/knn.cu",
                replaces="point_cloud_reid_tpu/ops/pallas/knn.py:51",
                max_abs_err=err, mismatches_exact=0,
                near_tie_swaps=swaps_total,
                **{key: sa1[key] for key in ("ms", "device_ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "library_ms")},
                shapes=shapes)


def family_match(model, n_obj: int, n_pts: int, P: int) -> tuple:
    """The match chain's rows tier at `model`'s width and compute dtype on
    n_obj x n_obj embeddings of n_pts-point crops: the grid and a P-pair
    list against the plain version (MATCH_TOL; a bf16 model's against the
    bf16 plain version, BF16_TOL), pairs equal to their grid cells bit for
    bit. Returns the grid's and the pairs' measurements."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.timing import time_ms
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + n_pts)
    with torch.no_grad():
        xyz_t, h_t = model.embed(torch.randn((n_obj, n_pts, 3), generator=gen,
                                             device=DEVICE) * 0.6)
        xyz_d, h_d = model.embed(torch.randn((n_obj, n_pts, 3), generator=gen,
                                             device=DEVICE) * 0.6)
        t, d, w1, w2, nhead = mg.match_factors(model, h_t, xyz_t, h_d, xyz_d)
    C = h_t.shape[2]
    bf16 = h_t.dtype == torch.bfloat16
    how = mg.plan(n_pts, C, nhead, dtype=h_t.dtype)
    if how.tier != mg.ROWS:
        raise RuntimeError(f"N={n_pts} C={C}: plan {how}, not the rows tier")
    tol = BF16_TOL if bf16 else MATCH_TOL

    def bound(pairs, nbyte):
        """(bound ms, what bounds it, float32 CUDA-core bound or None)."""
        if bf16:
            return (*bf16_bound(80.0 * pairs * n_pts * C * C, nbyte), None)
        return match_bound(pairs, n_pts, C, nbyte)
    weights = list(w1.values()) + list(w2.values())
    ti = torch.arange(n_obj, device=DEVICE).repeat_interleave(n_obj)
    di = torch.arange(n_obj, device=DEVICE).repeat(n_obj)
    grid = mg.fused_match_grid(t, d, w1, w2, nhead)
    want = mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di
                                     ).reshape(n_obj, n_obj, -1)
    torch.cuda.synchronize()
    g_err, g_rel = rel_err(grid.float(), want.float())
    del want
    g_ms = time_ms(lambda: mg.fused_match_grid(t, d, w1, w2, nhead), 2,
                   warmup=1)
    g_plain = time_ms(lambda: mg.match_pooled_reference(
        t, d, w1, w2, nhead, ti, di), 1, warmup=0)
    g_bound, g_by, g_simt = bound(n_obj * n_obj, nbytes(*t, *d, *weights,
                                                        grid))
    t_idx = torch.randint(0, n_obj, (P,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    d_idx = torch.randint(0, n_obj, (P,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    pairs = mg.fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    want = mg.match_pooled_reference(t, d, w1, w2, nhead, t_idx, d_idx)
    torch.cuda.synchronize()
    p_err, p_rel = rel_err(pairs.float(), want.float())
    same = torch.equal(pairs, grid[t_idx.long(), d_idx.long()])
    p_ms = time_ms(lambda: mg.fused_match_pairs(t, d, w1, w2, nhead, t_idx,
                                                d_idx), 3, warmup=1)
    p_plain = time_ms(lambda: mg.match_pooled_reference(
        t, d, w1, w2, nhead, t_idx, d_idx), 1, warmup=0)
    p_bound, p_by, p_simt = bound(P, nbytes(*t, *d, *weights, t_idx, d_idx,
                                            pairs))
    tag = "bf16 rows tier" if bf16 else "rows tier"
    simt = ("" if bf16 else f", float32 CUDA-core bounds {g_simt:.3f} / "
            f"{p_simt:.3f}")
    usage = rows_kernel_usage(C, nhead, bf16)
    print(f"[family:match] {tag}, C={C} N={n_pts} nhead={nhead}: grid "
          f"{n_obj}x{n_obj} max_abs_err={g_err:.3e} rel={g_rel:.3e}, pairs "
          f"P={P} max_abs_err={p_err:.3e} rel={p_rel:.3e} (tol {tol:g}), "
          f"pairs equal to their grid cells: {same}; grid {g_ms:.3f} ms "
          f"(plain {g_plain:.3f}, bound {g_bound:.4f} {g_by}), pairs "
          f"{p_ms:.3f} ms (plain {p_plain:.3f}, bound {p_bound:.4f} {p_by})"
          f"{simt}; tier {mg.TIER_NAMES[how.tier]}, {how.smem} shared bytes "
          f"a block, ptxas {usage}", flush=True)
    if not (g_rel <= tol and p_rel <= tol and same):
        raise RuntimeError(f"the {tag} disagrees at C={C} N={n_pts}: "
                           f"{g_rel}, {p_rel}, pairs equal {same}")
    shape = dict(C=C, N=n_pts, nhead=nhead, tier=mg.TIER_NAMES[how.tier],
                 smem_bytes=how.smem, ptxas=usage)
    return (dict(shape, grid=f"{n_obj}x{n_obj}", max_abs_err=g_err, ms=g_ms,
                 plain_ms=g_plain, bound_ms=g_bound, bound_by=g_by,
                 library_ms=None,
                 **({} if bf16 else dict(simt_fp32_bound_ms=g_simt))),
            dict(shape, P=P, max_abs_err=p_err, ms=p_ms, plain_ms=p_plain,
                 bound_ms=p_bound, bound_by=p_by, library_ms=None,
                 **({} if bf16 else dict(simt_fp32_bound_ms=p_simt))))


def family_sa(model, B: int, n_pts: int, stages: int) -> list:
    """The SA kernel at the family's shapes: the first `stages` SA stages of
    `model` on B crops of n_pts points, each against its plain version."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    from point_cloud_reid_tpu_torch.ops.geometry import knn_indices
    from point_cloud_reid_tpu_torch.tools.timing import time_ms
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    xyz = torch.randn((B, n_pts, 3), generator=gen, device=DEVICE) * 0.6
    points, out = None, []
    for i, (mod, S) in enumerate(zip(model.backbone.SA_modules[:stages],
                                     model.backbone_list)):
        cidx = torch.arange(S, device=DEVICE).clamp(max=xyz.shape[1] - 1)
        idx = knn_indices(mod.nsample, xyz, xyz[:, cidx])
        args = sa.sa_stage_args(
            xyz, points, idx, [(c.weight, c.bias) for c in mod.mlp_convs],
            [(b.weight, b.bias, b.running_mean, b.running_var)
             for b in mod.mlp_bns], mod.mlp_bns[0].eps)
        got = sa.fused_sa_convmax(*args)
        want = sa.sa_convmax_reference(*args)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        ms = time_ms(lambda: sa.fused_sa_convmax(*args), 5)
        plain = time_ms(lambda: sa.sa_convmax_reference(*args), 2)
        N, C = args[0].shape[1:]
        b_ms, b_by, b_simt = tensor_core_bound(
            4.0 * B * S * mod.nsample * C * C, nbytes(*args, got))
        print(f"[family:sa] SA{i + 1} B={B} N={N} S={S} K={mod.nsample} "
              f"C={C}: max_abs_err={err:.3e} rel={rel:.3e} (tol {SA_TOL:g}) "
              f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}; float32 CUDA-core bound {b_simt:.3f} ms)",
              flush=True)
        if not rel <= SA_TOL:
            raise RuntimeError(f"sa_stage SA{i + 1} at B={B} N={N} C={C} "
                               f"disagrees: rel {rel}")
        out.append(dict(stage=i + 1, B=B, N=N, S=S, K=mod.nsample, C=C,
                        max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by))
        with torch.no_grad():
            xyz, points = mod(xyz, points, S)
    return out


def family_attention() -> list:
    """Linear attention at the family's training shapes: 256 pairs of the
    2048-point ablation (L = S = 2048, D = 32) and of the 1.5M / 7M models'
    cross stages (d_model 128: D = 64), forward and gradients against the
    plain version."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import linear_attention as la
    from point_cloud_reid_tpu_torch.tools.timing import graph_ms, time_ms
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    out = []
    for (B, L, S, H, D, V) in ((TRAIN_PAIRS, 2048, 2048, 2, 32, 32),
                               (TRAIN_PAIRS, 128, 128, 2, 64, 64)):
        q = torch.randn((B, L, H, D), generator=gen, device=DEVICE,
                        requires_grad=True)
        kv = torch.randn((B, S, H, D + V), generator=gen, device=DEVICE)
        k = kv[..., :D].detach().requires_grad_(True)
        v = kv[..., D:].detach().requires_grad_(True)
        got = la.fused_linear_attention(q, k, v)
        want = la.linear_attention_reference(q, k, v)
        go = torch.randn(got.shape, generator=gen, device=DEVICE)
        g_got = torch.autograd.grad(got, (q, k, v), go)
        g_want = torch.autograd.grad(want, (q, k, v), go)
        torch.cuda.synchronize()
        err, rel = rel_err(got.detach(), want.detach())
        g_rel = max(rel_err(a, b)[1] for a, b in zip(g_got, g_want))
        with torch.no_grad():
            ms = time_ms(lambda: la.linear_attention_forward(q, k, v), 10)
            device = graph_ms(lambda: la.linear_attention_forward(q, k, v),
                              10)
            plain = time_ms(lambda: la.linear_attention_reference(q, k, v),
                            5)
        flops = B * H * (2.0 * S * D * V + 2.0 * L * D * V + 2.0 * L * D
                         + S * D)
        b_ms, b_by = bound_ms(flops, nbytes(q, k, v, got))
        print(f"[family:linear_attention] B={B} L={L} S={S} H={H} D={D} "
              f"V={V}: max_abs_err={err:.3e} rel={rel:.3e}, gradients rel="
              f"{g_rel:.3e} (tol {ATTN_TOL:g}); forward kernel {ms:.4f} ms "
              f"(device {device:.4f}), plain {plain:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        if not (rel <= ATTN_TOL and g_rel <= ATTN_TOL):
            raise RuntimeError(f"linear_attention disagrees: {rel}, {g_rel}")
        out.append(dict(B=B, L=L, S=S, H=H, D=D, V=V, max_abs_err=err,
                        ms=ms, device_ms=device, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by))
    return out


def serve_profiled(model, sparse: str, label: str, card: str,
                   profiled: int = 2) -> tuple:
    """FRAMES frames of the serving scene behind TrackingManager.step, the
    last `profiled` of them under torch.profiler. Returns (step ms, the
    scorer, device ms a profiled frame, the device's busy share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.tools.profile_tracker import _busy_us
    from point_cloud_reid_tpu_torch.tools.scenes import bench_scene
    from point_cloud_reid_tpu_torch.tracking import TrackingManager
    scorer = PairScorer(model)
    mgr = TrackingManager(scorer, subsample_number=128, match_threshold=1.0,
                          seed=SEED, sparse_scoring=sparse)
    frames = list(bench_scene(N_OBJ, PTS_PER_OBJ, FRAMES, SEED))
    times = []

    def step(frame):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.step(*frame)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        last = scorer.last_frame
        if last is not None and not bool(torch.isfinite(last["logits"]).all()):
            raise RuntimeError(f"non-finite logits in scene '{label}'")

    for frame in frames[:-profiled]:
        step(frame)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for frame in frames[-profiled:]:
            step(frame)
        window_us = (time.perf_counter() - t0) * 1e6
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         f"chip_smoke_{label}.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(trace)
    spans = [(ev["ts"], ev["dur"]) for ev in events
             if ev.get("cat") == "kernel"]
    if not spans:
        raise RuntimeError("the profiler recorded no device kernels")
    device_ms = sum(dur for _, dur in spans) / 1e3 / profiled
    busy = _busy_us(spans) / window_us
    print(f"[family:serve] {label}: {len(mgr.store.active())} active tracks, "
          f"median steady-state step {np.median(times[3:]):.3f} ms (frames "
          f"4-{FRAMES}; all: {[round(x, 1) for x in times]}), device "
          f"{device_ms:.3f} ms a frame and busy {100 * busy:.1f} % over the "
          f"last {profiled} (profiled) on {card}", flush=True)
    return times, scorer, device_ms, busy


def serve_ablation(card: str, every: dict, bf16: bool = False,
                   leaf: str = ABLATION) -> tuple:
    """tools/track.py serves a 2048-point ablation (`leaf`) at its crop
    size (--subsample 2048, sparse 'auto'; with `bf16`, --bf16) over a
    small synthetic scene; a float32 run's last frame is held against plain
    scoring. Returns (the CLI's headline, its scorer)."""
    import contextlib
    import io
    import shutil
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.tools import track
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ablation")
    shutil.rmtree(work, ignore_errors=True)
    scorers, init = [], PairScorer.__init__

    def kept_init(self, *a, **k):
        init(self, *a, **k)
        scorers.append(self)
    before = {k: fn.launches for k, fn in every.items()}
    out = io.StringIO()
    PairScorer.__init__ = kept_init
    try:
        with contextlib.redirect_stdout(out):
            track.main([leaf, "--subsample", "2048", "--sparse", "auto",
                        "--scenes", "1", "--frames", "5", "--objects", "16",
                        "--pts-per-obj", "2400", "--match-threshold", "1.0",
                        "--work-dir", work] + (["--bf16"] if bf16 else []))
    finally:
        PairScorer.__init__ = init
    headline = json.loads(out.getvalue().strip().splitlines()[-1])
    cli = {k: fn.launches - before[k] for k, fn in every.items()}
    flag = " --bf16" if bf16 else ""
    print(f"[family:ablation] tools/track.py {leaf} --subsample 2048"
          f"{flag}: launches { {k: v for k, v in cli.items() if v} }; "
          f"headline {json.dumps(headline)} on {card}", flush=True)
    sa, rows = (("fused_sa_convmax/bf16", "rows_bf16") if bf16
                else ("fused_sa_convmax", "rows"))
    # PointNet and DGCNN embed without the SA kernel
    with_sa = "point-transformer" in leaf
    if not ((cli[sa] > 0 or not with_sa) and cli[f"fused_match_pairs/{rows}"]
            + cli[f"fused_match_grid/{rows}"] > 0):
        raise RuntimeError(f"{leaf}{flag} was not served through the "
                           f"SA kernel and the match chain's {rows} tier")
    scorer = scorers[-1]
    if scorer.last_frame["h_t"].shape[1] != 2048:
        raise RuntimeError("the CLI did not score 2048 rows a side")
    if not bf16:
        check_frame(scorer.model, scorer.last_frame, "ablation")
    shutil.rmtree(work, ignore_errors=True)
    return headline, scorer


def train_leaf(card: str, name: str) -> dict:
    """FAMILY_STEPS steps of a leaf through Trainer.fit with the kernel
    knobs on, at the largest pair count up to TRAIN_PAIRS that fits; step
    1 against the same step with the knobs off."""
    import tempfile

    import torch
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.kernels import linear_attention as la

    def run(kernels, pairs, steps, work_dir):
        cfg = get_experiment(name, set_options=list(
            KNOBS if kernels else PLAIN_KNOBS))
        return train_flagship(
            kernels, pairs, steps, work_dir, cfg=cfg["model"],
            num_points=cfg["dataset"]["train"]["subsample_sparse"],
            num_classes=cfg["dataset"]["num_classes"])

    knn0, attn0 = kk.knn.launches, la.linear_attention_forward.launches
    with tempfile.TemporaryDirectory() as work_dir:
        pairs = TRAIN_PAIRS
        while True:
            try:
                logs, times, changed, peak = run(True, pairs, FAMILY_STEPS,
                                                 work_dir)
                break
            except torch.cuda.OutOfMemoryError:
                pass
            print(f"[family:train] {name}: {pairs} pairs do not fit (peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB): "
                  "halving", flush=True)
            torch.cuda.empty_cache()
            pairs //= 2
            if pairs < 16:
                raise RuntimeError(f"{name} does not train at 16 pairs")
    knn_n = kk.knn.launches - knn0
    attn_n = la.linear_attention_forward.launches - attn0
    if (knn_n != 3 * FAMILY_STEPS or attn_n != 4 * FAMILY_STEPS
            or not all(np.isfinite(v) for log in logs for v in log.values())
            or not any("mlp_convs" in k for k in changed)):
        raise RuntimeError(f"{name}: want 3 kNN and 4 attention launches a "
                           f"step, finite logs and moved weights; got "
                           f"{knn_n}, {attn_n}, {logs}")
    torch.cuda.empty_cache()
    plain_logs, _, _, plain_peak = run(False, pairs, 1, None)
    rels = {}
    for key in ("reid_loss", "grad_norm"):
        a, b = logs[0][key], plain_logs[0][key]
        rels[key] = abs(a - b) / max(abs(b), 1e-12)
    print(f"[family:train] {name}: {FAMILY_STEPS} steps of {pairs} pairs, "
          f"launches knn {knn_n} attention {attn_n}; step ms "
          f"{[round(x, 1) for x in times]}, peak memory "
          f"{peak / 2 ** 30:.2f} GiB (knobs off: "
          f"{plain_peak / 2 ** 30:.2f} GiB); step 1 against the knobs off: "
          f"reid_loss {logs[0]['reid_loss']:.6f} / "
          f"{plain_logs[0]['reid_loss']:.6f}, grad_norm "
          f"{logs[0]['grad_norm']:.4f} / {plain_logs[0]['grad_norm']:.4f}, "
          f"rel {rels} (tol {TRAIN_TOL:g}) on {card}", flush=True)
    if not all(r <= TRAIN_TOL for r in rels.values()):
        raise RuntimeError(f"{name}: step 1 differs with the kernels on")
    torch.cuda.empty_cache()
    return dict(leaf=name, pairs=pairs, step_ms=times,
                peak_gib=peak / 2 ** 30, step1_rel=rels)


def rows_kernel_usage(C: int, nhead: int, bf16: bool, pad: bool = False
                      ) -> dict:
    """ptxas's registers and spills of the wgmma rows tier's instantiation
    for width C in nhead heads (csrc/match_rows_wg.cuh rows_wg_kernel<policy,
    C, KVN, PAD, HD>; `pad`: the padded layout's, KVN = C; HD the
    normalisers' heads, 16 padded or past 8 heads, else 8; past 128 channels
    rows_wide_kernel<policy, CC>: CC = 256 at 256, else 0, the width at run
    time), from the kernels' build log."""
    from point_cloud_reid_tpu_torch.kernels import _lib
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    kvn = mg.rows_layout(C, 1 if pad else nhead).kvn
    hd = mg.ROWS_MAX_HEADS if pad or nhead > 8 else 8
    policy = "Bf16" if bf16 else "Tf32"
    want = (f"rows_wide_kernelINS_4{policy}ELi{C if C == 256 else 0}EE"
            if C > 128 else
            f"rows_wg_kernelINS_4{policy}ELi{C}ELi{kvn}ELb{int(pad)}ELi{hd}E")
    found = [v for k, v in _lib.ptxas_usage(_lib.LIBRARY.build_log).items()
             if want in k]
    if len(found) != 1:
        raise RuntimeError(f"no ptxas account of {want} in the build log")
    return found[0]


def rows_tier_rows(scaled, ablation, tier: str, source: str) -> list:
    """Kernels-line rows of a rows tier (`tier` "rows" or "rows_bf16"): the
    grid row's numbers are the 7M model's 128 x 128 grid, the pairs row's
    the 2048-point ablation's 512 pairs; each lists both shapes."""
    grid128, pairs128 = family_match(scaled, 128, 128, 512)
    grid64, pairs64 = family_match(ablation, 16, 2048, 512)
    return [dict(name=f"{name}/{tier}", route="cuda",
                 source=f"point_cloud_reid_tpu_torch/csrc/{source}",
                 replaces="point_cloud_reid_tpu/ops/pallas/match_grid.py:"
                          + line, **head, shapes=[head, extra])
            for name, line, head, extra in (
                ("fused_match_grid", "250", grid128, grid64),
                ("fused_match_pairs", "355", pairs64, pairs128))]


def phase_family(card: str):
    """Phase 9: the rest of the flagship family. The new kernel tiers and
    the kernels at the family's shapes against their plain versions; then,
    with every count at 0, the 7M leaf served dense and sparse, the
    2048-point ablation served by tools/track.py at its crop size, and both
    trained. Returns (rows of the new tiers, extra shapes of earlier rows
    by name, the path's launches, a summary)."""
    import torch
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.models import build_model
    t_phase = time.perf_counter()

    def build(name):
        return build_model(get_experiment(name)["model"], device=DEVICE,
                           generator=torch.Generator().manual_seed(SEED))
    rows = [family_knn()]
    scaled, ablation = build(SCALED), build(ABLATION)
    rows += rows_tier_rows(scaled, ablation, "rows", "match_rows.cu")
    extra = dict(fused_sa_convmax=family_sa(ablation, 512, 2048, 1)
                 + family_sa(scaled, 128, 128, 3),
                 linear_attention=family_attention())
    del ablation
    torch.cuda.empty_cache()
    print(f"[family] kernel checks took {time.perf_counter() - t_phase:.1f} "
          "s", flush=True)

    every = zero_counters()
    summary = {}
    for sparse, label in (("never", "7M dense"), ("auto", "7M sparse")):
        grid0 = every["fused_match_grid/rows"].launches
        pairs0 = every["fused_match_pairs/rows"].launches
        times, scorer, device_ms, busy = serve_profiled(scaled, sparse,
                                                        label, card)
        grid_n = every["fused_match_grid/rows"].launches - grid0
        pairs_n = every["fused_match_pairs/rows"].launches - pairs0
        if (grid_n if sparse == "never" else pairs_n) <= 0:
            raise RuntimeError(f"{label}: the rows tier was not launched")
        check_frame(scaled, scorer.last_frame, label)
        summary[label] = dict(median_step_ms=float(np.median(times[3:])),
                              device_ms=device_ms, busy=busy,
                              rows_launches=grid_n + pairs_n)
    del scaled, scorer
    torch.cuda.empty_cache()
    summary["ablation_cli"] = serve_ablation(card, every)[0]
    torch.cuda.empty_cache()
    summary["train"] = [train_leaf(card, ABLATION), train_leaf(card, SCALED)]
    launches = {name: fn.launches for name, fn in every.items()}
    if any(v for k, v in launches.items() if "/rows_mma" in k):
        raise RuntimeError(f"the first rows kernel ran at C = 64 / 128: "
                           f"{launches}")
    print(f"[family] launches {launches}; phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows, extra, launches, summary


def bf16_bound(flops: float, nbyte: float) -> tuple:
    """(bound ms, what bounds it) of a bf16 kernel: its products in one
    bf16 pass on the tensor cores, or its bytes."""
    return bound_ms(flops, nbyte, PEAK_BF16)


def bf16_row(name: str, source: str, replaces: str, got, want, ms: float,
             plain_ms: float, bound: tuple, label: str) -> dict:
    """Check a bf16 kernel's output against its bf16 plain version to
    BF16_TOL, print the measurements and return the kernels-line row."""
    err, rel = rel_err(got.float(), want.float())
    print(f"[bf16] {label}: max_abs_err={err:.3e} rel={rel:.3e} (tol "
          f"{BF16_TOL:g}) kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}, one bf16 pass)", flush=True)
    if not (got.dtype == want.dtype and rel <= BF16_TOL):
        raise RuntimeError(f"{name} disagrees with its bf16 plain version: "
                           f"rel {rel}, {got.dtype} vs {want.dtype}")
    return dict(name=name, route="cuda",
                source=f"point_cloud_reid_tpu_torch/csrc/{source}",
                replaces=f"point_cloud_reid_tpu/ops/pallas/{replaces}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=None)


def bf16_match_rows(model, t, d, w1, w2, nhead, head: str, gen) -> list:
    """The bf16 match kernel's grid and a 512-pair list on `model`'s
    factors against the plain version; pairs equal to their grid cells bit
    for bit."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.timing import time_ms
    grid_fn, pairs_fn = ((mg.fused_match_grid, mg.fused_match_pairs)
                         if head == "point" else
                         (mg.fused_image_match_grid,
                          mg.fused_image_match_pairs))
    nt, nd = t[0].shape[0], d[0].shape[0]
    S, C = t[0].shape[1], t[0].shape[2]
    weights = list(w1.values()) + list(w2.values())
    ti = torch.arange(nt, device=DEVICE).repeat_interleave(nd)
    di = torch.arange(nd, device=DEVICE).repeat(nt)
    grid = grid_fn(t, d, w1, w2, nhead)
    want = mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di
                                     ).reshape(nt, nd, -1)
    torch.cuda.synchronize()
    g_ms = time_ms(lambda: grid_fn(t, d, w1, w2, nhead), 5)
    g_plain = time_ms(lambda: mg.match_pooled_reference(
        t, d, w1, w2, nhead, ti, di), 2, warmup=1)
    flops = 80.0 * S * C * C
    rows = [bf16_row(
        f"{grid_fn.__name__}/bf16", "match_grid_bf16.cu",
        "match_grid.py:" + ("250" if head == "point" else "686"), grid, want,
        g_ms, g_plain, bf16_bound(flops * nt * nd,
                                  nbytes(*t, *d, *weights, grid)),
        f"{head} grid {nt}x{nd} N={S} C={C}")]
    P = 512
    t_idx = torch.randint(0, nt, (P,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    d_idx = torch.randint(0, nd, (P,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    pairs = pairs_fn(t, d, w1, w2, nhead, t_idx, d_idx)
    want = mg.match_pooled_reference(t, d, w1, w2, nhead, t_idx, d_idx)
    torch.cuda.synchronize()
    if not torch.equal(pairs, grid[t_idx.long(), d_idx.long()]):
        raise RuntimeError(f"{pairs_fn.__name__} at bf16: pairs differ from "
                           "their grid cells")
    p_ms = time_ms(lambda: pairs_fn(t, d, w1, w2, nhead, t_idx, d_idx), 10)
    p_plain = time_ms(lambda: mg.match_pooled_reference(
        t, d, w1, w2, nhead, t_idx, d_idx), 3)
    rows.append(bf16_row(
        f"{pairs_fn.__name__}/bf16", "match_grid_bf16.cu",
        "match_grid.py:" + ("355" if head == "point" else "514"), pairs,
        want, p_ms, p_plain,
        bf16_bound(flops * P, nbytes(*t, *d, *weights, t_idx, d_idx, pairs)),
        f"{head} pairs P={P} (equal to their grid cells bit for bit)"))
    return rows


def bf16_sa_row(model, crops, name: str, label: str) -> dict:
    """The bf16 SA kernel at `model`'s three eval SA stages on the B = 128
    crops, each stage's input the previous stage's output: each stage's
    kernel ms, plain ms, one-pass bound and plan tier, and the kernels-line
    row of the three in all against their bf16 plain versions."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    from point_cloud_reid_tpu_torch.ops.geometry import knn_indices
    from point_cloud_reid_tpu_torch.tools.timing import time_ms
    xyz, points = crops, None
    ms = plain = flops = nbyte = 0.0
    got_all, want_all, stages = [], [], []
    with torch.no_grad():
        for i, (mod, S) in enumerate(zip(model.backbone.SA_modules,
                                         model.backbone_list)):
            cidx = torch.arange(S, device=DEVICE).clamp(max=xyz.shape[1] - 1)
            idx = knn_indices(mod.nsample, xyz, xyz[:, cidx])
            args = sa.sa_stage_args(
                xyz, points, idx, [(c.weight, c.bias) for c in mod.mlp_convs],
                [(b.weight, b.bias, b.running_mean, b.running_var)
                 for b in mod.mlp_bns], mod.mlp_bns[0].eps, torch.bfloat16)
            got = sa.fused_sa_convmax(*args)
            want = sa.sa_convmax_reference(*args)
            torch.cuda.synchronize()
            got_all.append(got.flatten())
            want_all.append(want.flatten())
            k_ms = time_ms(lambda: sa.fused_sa_convmax(*args), 10)
            p_ms = time_ms(lambda: sa.sa_convmax_reference(*args), 5)
            B, N, C = args[0].shape
            K = mod.nsample
            f = 4.0 * B * S * K * C * C
            b_ms, b_by = bf16_bound(f, nbytes(*args, got))
            how = sa.plan_bf16(C, K, B * S * K)
            print(f"[bf16] {label} SA{i + 1} B={B} N={N} S={S} K={K} C={C}: "
                  f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}); tier {how.tier} ({how.tile_rows} "
                  f"rows a weight tile, {how.warpgroups} warpgroups, ring "
                  f"{how.ring}, {how.smem} shared bytes)", flush=True)
            stages.append(dict(C=C, K=K, ms=k_ms, plain_ms=p_ms,
                               bound_ms=b_ms, tier=how.tier))
            ms, plain = ms + k_ms, plain + p_ms
            flops, nbyte = flops + f, nbyte + nbytes(*args, got)
            xyz, points = mod(xyz, points, S)
    row = bf16_row(name, "sa_stage_bf16.cu", "sa_stage.py:78",
                   torch.cat(got_all), torch.cat(want_all), ms, plain,
                   bf16_bound(flops, nbyte), f"{label} SA1-3 at B=128 in all")
    row["stages"] = stages
    return row


def phase_bf16_kernels(model, image, scaled, ablation):
    """The bf16 kernels at the serving shapes against their bf16 plain
    versions (kernels line rows `kernel/bf16`; the SA kernel at the 7M
    model's widths too, row `fused_sa_convmax/7M_bf16`), and the bf16 rows
    tier at the 7M model's and the 2048-point ablation's shapes (rows
    `kernel/rows_bf16`)."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    crops = torch.randn((128, 128, 3), generator=gen, device=DEVICE) * 0.6
    # SA1-3 at B=128 crops: the flagship's widths, then the 7M model's
    rows = [bf16_sa_row(model, crops, "fused_sa_convmax/bf16", "flagship"),
            bf16_sa_row(scaled, crops, "fused_sa_convmax/7M_bf16", "7M")]
    # the point grid 128 x 128 and 512 pairs on the flagship's embeddings
    with torch.no_grad():
        xyz_t, h_t = model.embed(crops)
        xyz_d, h_d = model.embed(torch.randn((128, 128, 3), generator=gen,
                                             device=DEVICE) * 0.6)
        factors = mg.match_factors(model, h_t, xyz_t, h_d, xyz_d)
    rows += bf16_match_rows(model, *factors, "point", gen)
    # the image grid 128 x 64 at S=197 and 512 pairs on the leaf's tokens
    with torch.no_grad():
        images = torch.rand((192, 3, 224, 224), generator=gen, device=DEVICE)
        h = image.downsample_tokens(image.embed(images.to(torch.bfloat16)))
        factors = mg.image_match_factors(image, h[:128].contiguous(),
                                         h[128:].contiguous())
    rows += bf16_match_rows(image, *factors, "image", gen)
    # the bf16 rows tier: the 7M model (C = 128) and the 2048-point ablation
    # (past the bf16 cluster tier's 208 rows at C = 64)
    rows += rows_tier_rows(scaled, ablation, "rows_bf16",
                           "match_rows_bf16.cu")
    return rows


def bf16_point_gap(model32, rec, label: str,
                   tol: float = BF16_LOGIT_TOL) -> float:
    """A bf16 point frame's logits against the float32 port's on the same
    crops (a frame's xyz are its crops), to `tol`."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    with torch.no_grad():
        xyz_t, h_t = model32.embed(rec["xyz_t"])
        xyz_d, h_d = model32.embed(rec["xyz_d"])
        if rec["pairs"] is None:
            want = mg.grid_logits(model32, h_t, xyz_t, h_d, xyz_d)
        else:
            want = mg.pair_logits(model32, h_t, xyz_t, h_d, xyz_d,
                                  *rec["pairs"])
    return bf16_logit_gap(rec["logits"], want, label, tol)


def bf16_image_gap(image16, image32, frame, label: str) -> float:
    """A frame's detections cropped once (float32), embedded by the bf16
    and the float32 image models and scored against each other by the
    image grid kernel of each dtype."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tracking.image_crops import (
        crops_per_frame)
    (images, l2cs, Ks), boxes = frame[0], frame[1]
    with torch.no_grad():
        crops, _ = crops_per_frame(
            *[torch.from_numpy(np.asarray(x)).to(DEVICE)
              for x in (images, l2cs, Ks, boxes)],
            image_size=(images.shape[3], images.shape[2]))
        h16 = image16.downsample_tokens(image16.embed(crops.to(
            torch.bfloat16)))
        h32 = image32.downsample_tokens(image32.embed(crops))
        got = mg.image_grid_logits(image16, h16, h16)
        want = mg.image_grid_logits(image32, h32, h32)
    return bf16_logit_gap(got, want, label)


def bf16_logit_gap(got, want, label: str,
                   tol: float = BF16_LOGIT_TOL) -> float:
    import torch
    if got.dtype != torch.bfloat16 or want.dtype != torch.float32:
        raise RuntimeError(f"{label}: logits {got.dtype}, float32 port's "
                           f"{want.dtype}")
    err, rel = rel_err(got.float(), want)
    print(f"[bf16:{label}] logits vs the float32 port on the same crops: "
          f"max_abs_err={err:.4f} rel={rel:.4f} (bar {tol}; "
          f"|logits| up to {want.abs().max().item():.3f})", flush=True)
    if not rel <= tol:
        raise RuntimeError(f"{label}: bf16 logits {rel} from float32")
    return rel


def phase_bf16(card: str):
    """Phase 10: bf16 serving. Returns (kernels-line rows, the path's
    launches, a summary)."""
    import torch
    from point_cloud_reid_tpu_torch.configs import (get_experiment,
                                                    image_deit_point_cat,
                                                    point_transformer_point_cat)
    from point_cloud_reid_tpu_torch.models import build_model
    t_phase = time.perf_counter()

    def build(cfg, dtype):
        return build_model(cfg, device=DEVICE, dtype=dtype,
                           generator=torch.Generator().manual_seed(SEED))
    point16 = build(point_transformer_point_cat(), torch.bfloat16)
    image16 = build(image_deit_point_cat("deit-tiny-no-pt"), torch.bfloat16)
    scaled16 = build(get_experiment(SCALED)["model"], torch.bfloat16)
    ablation16 = build(get_experiment(ABLATION)["model"], torch.bfloat16)
    rows = phase_bf16_kernels(point16, image16, scaled16, ablation16)
    del ablation16
    torch.cuda.empty_cache()
    print(f"[bf16] kernel checks took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # the scenes with every count at 0; the comparisons after
    every = zero_counters()
    names = [n for n in every if n.endswith("bf16")]
    # the SA stages of every leaf here on the wgmma tier alone
    scenes = (("point dense", "never", ("fused_sa_convmax/bf16",
                                        "fused_sa_convmax/wgmma_bf16",
                                        "fused_match_grid/bf16")),
              ("point sparse", "auto", ("fused_sa_convmax/bf16",
                                        "fused_sa_convmax/wgmma_bf16",
                                        "fused_match_pairs/bf16")),
              ("image dense", "never", ("fused_image_match_grid/bf16",)),
              ("image sparse", "always", ("fused_image_match_pairs/bf16",)))
    runs, summary = {}, {}
    for label, sparse, want in scenes:
        before = {n: every[n].launches for n in names}
        if label.startswith("point"):
            ms, scorer, mgr = run_scene(point16, sparse)
            frame = None
        else:
            ms, scorer, mgr, frame = run_image_scene(image16, sparse)
        used = {n: every[n].launches - before[n] for n in names}
        if not (all(used[n] > 0 for n in want)
                and used["fused_sa_convmax/mma_sync_bf16"] == 0):
            raise RuntimeError(f"bf16 {label}: launches {used}")
        runs[label] = (scorer.last_frame, frame)
        BF16_STEP_MS[label] = float(np.median(ms[3:]))
        summary[label] = dict(median_step_ms=BF16_STEP_MS[label],
                              launches={n: v for n, v in used.items() if v})
        print(f"[bf16] {label}: {len(mgr.store.active())} active tracks, "
              f"median steady-state step {BF16_STEP_MS[label]:.3f} ms "
              f"(frames 4-10; all: {[round(x, 1) for x in ms]}) on {card}; "
              f"bf16 launches {summary[label]['launches']}", flush=True)
    # the 7M leaf (C = 128: the bf16 rows tier), two frames dense and two
    # sparse, and the 2048-point ablation served by tools/track.py --bf16
    sa_7m = 0
    for label, sparse, want in (
            ("7M dense", "never", "fused_match_grid/rows_bf16"),
            ("7M sparse", "auto", "fused_match_pairs/rows_bf16")):
        before = {n: every[n].launches for n in names}
        ms, scorer, mgr = run_scene(scaled16, sparse, frames=2)
        used = {n: every[n].launches - before[n] for n in names}
        if not (used[want] > 0 and used["fused_sa_convmax/wgmma_bf16"] > 0
                and used["fused_sa_convmax/mma_sync_bf16"] == 0):
            raise RuntimeError(f"bf16 {label}: launches {used}")
        sa_7m += used["fused_sa_convmax/bf16"]
        runs[label] = (scorer.last_frame, None)
        summary[label] = dict(step_ms=ms, launches={
            n: v for n, v in used.items() if v})
        print(f"[bf16] {label}: {len(mgr.store.active())} active tracks, "
              f"steps {[round(x, 1) for x in ms]} ms on {card}; bf16 "
              f"launches {summary[label]['launches']}", flush=True)
    headline, ablation_scorer = serve_ablation(card, every, bf16=True)
    summary["ablation_cli"] = headline
    launches = {name: fn.launches for name, fn in every.items()}
    f32 = {k: v for k, v in launches.items() if v and not k.endswith("bf16")}
    if f32:
        raise RuntimeError(f"the bf16 path launched float32 kernels {f32}")
    if any(v for k, v in launches.items() if "/rows_mma" in k):
        raise RuntimeError(f"the first bf16 rows kernel ran at C = 64 / 128: "
                           f"{launches}")
    # the 7M row's launches: the bf16 SA kernel's in the 7M leaf's frames
    launches["fused_sa_convmax/7M_bf16"] = sa_7m
    point32 = build(point_transformer_point_cat(), torch.float32)
    image32 = build(image_deit_point_cat("deit-tiny-no-pt"), torch.float32)
    scaled32 = build(get_experiment(SCALED)["model"], torch.float32)
    ablation32 = build(get_experiment(ABLATION)["model"], torch.float32)
    ablation32.load_state_dict(ablation_scorer.model.state_dict())
    for label, (rec, frame) in runs.items():
        summary[label]["logit_gap"] = (
            bf16_point_gap(scaled32 if label.startswith("7M") else point32,
                           rec, label) if frame is None
            else bf16_image_gap(image16, image32, frame, label))
    summary["ablation_cli"]["logit_gap"] = bf16_point_gap(
        ablation32, ablation_scorer.last_frame, "ablation")
    print(f"[bf16] path launches {launches}; float32 steps of phases 3 and 5:"
          f" {STEP_MS}; phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows, launches, summary


def train_rel(a: dict, b: dict) -> dict:
    """Relative gaps of step-1 reid_loss and grad_norm between two runs."""
    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
            for k in ("reid_loss", "grad_norm")}


def check_trained(label: str, logs, changed, want) -> None:
    """Finite logs and, for each name fragment in `want`, a changed entry."""
    if not all(np.isfinite(v) for log in logs for v in log.values()):
        raise RuntimeError(f"{label}: non-finite value in {logs}")
    missing = [w for w in want if not any(w in k for k in changed)]
    if missing:
        raise RuntimeError(f"{label}: training left {missing} unchanged")


def cli_bf16_runs(every: dict, card: str) -> dict:
    """tools/train.py --bf16 for one epoch on phase 8's store, tools/test.py
    --bf16 from its checkpoint, and an image leaf through tools/train.py
    --root on an image store. Returns what each command launched and
    measured."""
    import shutil

    import torch
    from point_cloud_reid_tpu_torch.tools import make_synthetic_data
    from point_cloud_reid_tpu_torch.tools import test as test_cli
    from point_cloud_reid_tpu_torch.tools import train as train_cli
    root = os.path.join(DATA_WORK, "store")
    sets = [a for knob in KNOBS for a in ("--set", knob)]
    out = {}

    def run(label, fn, argv):
        before = {n: c.launches for n, c in every.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = quiet(fn, argv)
        torch.cuda.synchronize()
        used = {n: c.launches - before[n] for n, c in every.items()
                if c.launches - before[n]}
        out[label] = dict(s=time.perf_counter() - t0, launches=used,
                          val_match_acc=metrics["val_match_acc"])
        if not np.isfinite(metrics["val_match_acc"]):
            raise RuntimeError(f"{label}: no val_match_acc")
        print(f"[bf16-train:cli] {label}: {out[label]['s']:.1f} s, "
              f"val_match_acc {metrics['val_match_acc']:.4f}, launches "
              f"{used} on {card}", flush=True)
        return used

    train_dir = os.path.join(DATA_WORK, "train_bf16")
    for label, fn, argv in (
            ("tools/train.py --bf16", train_cli.main,
             [FLAGSHIP, "--root", root, "--epochs", "1", "--bf16",
              "--work-dir", train_dir, *sets]),
            ("tools/test.py --bf16", test_cli.main,
             ["testing_" + FLAGSHIP, "--root", root, "--bf16",
              "--checkpoint", os.path.join(train_dir, "ckpt_final.pt"),
              "--work-dir", os.path.join(DATA_WORK, "test_bf16"), *sets])):
        used = run(label, fn, argv)
        sa = used.get("fused_sa_convmax/bf16", 0)
        if not (sa > 0 and sa % 3 == 0 and "fused_sa_convmax" not in used):
            raise RuntimeError(f"{label}: want the bf16 SA kernel 3 times "
                               f"an eval batch and no float32 one, got "
                               f"{used}")
    saved = torch.load(os.path.join(train_dir, "ckpt_final.pt"),
                       map_location="cpu", weights_only=True)
    if any(v.dtype != torch.float32 for v in saved["model"].values()
           if v.is_floating_point()):
        raise RuntimeError("the bf16 CLI run saved non-float32 weights")

    image_root = os.path.join(DATA_WORK, "image_store")
    t0 = time.perf_counter()
    quiet(make_synthetic_data.main, [
        image_root, "--objects", str(IMAGE_STORE_OBJECTS), "--frames",
        str(IMAGE_STORE_FRAMES), "--images", "--seed", str(SEED)])
    print(f"[bf16-train:cli] image store of {IMAGE_STORE_OBJECTS} objects x "
          f"{IMAGE_STORE_FRAMES} frames written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    image_dir = os.path.join(DATA_WORK, "train_image")
    run("tools/train.py <rgb_ leaf> --root --bf16", train_cli.main,
        [IMAGE_LEAF, "--root", image_root, "--epochs", "1", "--bf16",
         "--work-dir", image_dir, "--set", "dataset.val.max_combinations=2"])
    with open(os.path.join(image_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    steps = [r for r in steps if r["kind"] == "train"]
    if not (steps and all(np.isfinite(r["vis_loss"])
                          and np.isfinite(r["triplet_loss"]) for r in steps)):
        raise RuntimeError(f"the image leaf's CLI run logged {steps}")
    # the store stays for phase 15's torchrun run, which removes it
    for name in ("train_bf16", "test_bf16", "image_store", "train_image"):
        shutil.rmtree(os.path.join(DATA_WORK, name), ignore_errors=True)
    return out


def phase_bf16_training(card: str):
    """Phase 11: training at bf16 and the image leaves, with every count at
    0 before it. Returns (the path's launches, a summary)."""
    import torch
    from point_cloud_reid_tpu_torch.tools.profile_train import train_spec
    t_phase = time.perf_counter()
    every = zero_counters()
    summary = {}
    pairs = TRAIN_MS["pairs"]
    f32 = dict(median_step_ms=TRAIN_MS["median"],
               peak_gib=TRAIN_MS["peak_gib"])

    # a) the flagship at bf16, knobs on, then its first step with them off
    knn0, attn0 = every["knn"].launches, every["linear_attention"].launches
    logs, times, changed, peak = train_flagship(
        True, pairs, TRAIN_STEPS, None, dtype=torch.bfloat16)
    knn_n = every["knn"].launches - knn0
    attn_n = every["linear_attention"].launches - attn0
    check_trained("bf16 flagship", logs, changed,
                  ("running_var", "q_proj.weight", "mlp_convs"))
    if (knn_n, attn_n) != (3 * TRAIN_STEPS, 4 * TRAIN_STEPS):
        raise RuntimeError(f"bf16 flagship: want 3 kNN and 4 attention "
                           f"launches a step, got {knn_n}, {attn_n}")
    torch.cuda.empty_cache()
    plain_logs, _, _, _ = train_flagship(False, pairs, 1, None,
                                         dtype=torch.bfloat16)
    if (every["knn"].launches - knn0, every["linear_attention"].launches
            - attn0) != (knn_n, attn_n):
        raise RuntimeError("the bf16 run with the knobs off launched a "
                           "kernel")
    vs_plain = train_rel(logs[0], plain_logs[0])
    vs_f32 = train_rel(logs[0], TRAIN_MS["step1"])
    bf16 = dict(median_step_ms=float(np.median(times[2:])),
                peak_gib=peak / 2 ** 30, step_ms=times, step1=logs[0],
                step1_rel_knobs_off=vs_plain, step1_rel_float32=vs_f32)
    summary["flagship"] = dict(pairs=pairs, bf16=bf16, float32=f32)
    print(f"[bf16-train] flagship, {TRAIN_STEPS} steps of {pairs} pairs at "
          f"bf16, knobs on: launches knn {knn_n} attention {attn_n}; median "
          f"step {bf16['median_step_ms']:.1f} ms (all "
          f"{[round(x, 1) for x in times]}), peak {bf16['peak_gib']:.2f} GiB"
          f" against phase 4's float32 {f32['median_step_ms']:.1f} ms, "
          f"{f32['peak_gib']:.2f} GiB; step 1 reid_loss "
          f"{logs[0]['reid_loss']:.5f} grad_norm {logs[0]['grad_norm']:.4f}: "
          f"rel to knobs off {vs_plain} (tol {BF16_TRAIN_TOL:g}), to float32 "
          f"{vs_f32} (tol {BF16_F32_TRAIN_TOL:g}) on {card}", flush=True)
    if not (all(v <= BF16_TRAIN_TOL for v in vs_plain.values())
            and all(v <= BF16_F32_TRAIN_TOL for v in vs_f32.values())):
        raise RuntimeError("bf16 step 1 is off the knobs-off or float32 run")
    torch.cuda.empty_cache()

    # b) the image leaf at the JAX bench's batch, float32 and bf16
    spec = train_spec(IMAGE_LEAF, kernels=False)
    summary["image"] = {}
    for name, dtype in (("float32", torch.float32), ("bf16", torch.bfloat16)):
        logs, times, changed, peak = train_flagship(
            False, IMAGE_PAIRS, IMAGE_STEPS, None, spec=spec, dtype=dtype)
        check_trained(f"image {name}", logs, changed,
                      ("backbone.blocks.0.attn.qkv.weight",
                       "backbone.patch_embed", "match_head", "vis_head"))
        run = dict(median_step_ms=float(np.median(times[2:])),
                   peak_gib=peak / 2 ** 30, step_ms=times,
                   step1={k: logs[0][k] for k in (
                       "reid_loss", "grad_norm", "vis_loss",
                       "triplet_loss")})
        summary["image"][name] = run
        print(f"[bf16-train] {IMAGE_LEAF} at {name}: {IMAGE_STEPS} steps of "
              f"{IMAGE_PAIRS} pairs (match, cls, fp, vis, triplet margin "
              f"{spec['triplet_margin']:g}); median step "
              f"{run['median_step_ms']:.1f} ms (all "
              f"{[round(x, 1) for x in times]}), peak {run['peak_gib']:.2f} "
              f"GiB; step 1 {run['step1']} on {card}", flush=True)
        torch.cuda.empty_cache()

    # c) the CLIs at bf16, the image leaf from an image store
    summary["cli"] = cli_bf16_runs(every, card)
    torch.cuda.empty_cache()

    # d) one remat step of the flagship against phase 4's first step
    knn0 = every["knn"].launches
    logs, times, _, peak = train_flagship(True, pairs, 1, None, remat=True)
    rel = train_rel(logs[0], TRAIN_MS["step1"])
    summary["remat"] = dict(step_ms=times[0], peak_gib=peak / 2 ** 30,
                            knn_launches=every["knn"].launches - knn0,
                            step1_rel=rel,
                            plain_peak_gib=TRAIN_MS["peak_gib"])
    print(f"[bf16-train] remat: one step of {pairs} pairs, {times[0]:.1f} ms "
          f"(cold), peak {peak / 2 ** 30:.2f} GiB against phase 4's "
          f"{TRAIN_MS['peak_gib']:.2f} GiB; kNN launches "
          f"{summary['remat']['knn_launches']} (forward and recompute); "
          f"step 1 rel to phase 4 {rel} (tol {REMAT_TOL:g}) on {card}",
          flush=True)
    if not (peak / 2 ** 30 < TRAIN_MS["peak_gib"]
            and all(v <= REMAT_TOL for v in rel.values())):
        raise RuntimeError("the remat step is not the plain step in less "
                           "memory")
    launches = {name: fn.launches for name, fn in every.items()}
    print(f"[bf16-train] path launches "
          f"{ {k: v for k, v in launches.items() if v} }; phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, summary


def zoo_model(leaf: str, dtype):
    import torch
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.models import build_model
    return build_model(get_experiment(leaf)["model"], device=DEVICE,
                       dtype=dtype,
                       generator=torch.Generator().manual_seed(SEED))


def match_tier_counts() -> dict:
    """{(wrapper name, tier key): launches} of the point match kernels."""
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    return {(fn.__name__, tier): n
            for fn in (mg.fused_match_grid, mg.fused_match_pairs)
            for tier, n in fn.tier_launches.items()}


def zoo_frames(card: str) -> tuple:
    """The PointNet and DGCNN leaves behind TrackingManager.step, float32
    and bf16, dense and sparse: one launch a scored frame on the cluster
    tier of the frame's dtype. Returns (summary, [(label, family, dtype,
    the last frame)], {family: {dtype: model}})."""
    import torch
    summary, records, models = {}, [], {}
    for family, leaf in ZOO.items():
        models[family] = {}
        for dtype in (torch.float32, torch.bfloat16):
            model = models[family][dtype] = zoo_model(leaf, dtype)
            name = "bf16" if dtype == torch.bfloat16 else "float32"
            tier = "cluster_bf16" if dtype == torch.bfloat16 else "cluster"
            for sparse, kind in (("never", "dense"), ("auto", "sparse")):
                label = f"{family} {name} {kind}"
                before = match_tier_counts()
                ms, scorer, mgr = run_scene(model, sparse, frames=ZOO_FRAMES)
                used = {k: v - before[k]
                        for k, v in match_tier_counts().items()
                        if v != before[k]}
                want = ("fused_match_grid" if sparse == "never"
                        else "fused_match_pairs", tier)
                ours = sum(v for (_, t), v in used.items() if t == tier)
                if not (scorer.fused and ours == ZOO_FRAMES - 1
                        and used.get(want, 0) > 0
                        and set(used) <= {("fused_match_grid", tier),
                                          ("fused_match_pairs", tier)}):
                    raise RuntimeError(f"{label}: want one {tier} launch a "
                                       f"scored frame, got {used}")
                records.append((label, family, dtype, scorer.last_frame))
                summary[label] = dict(step_ms=ms, launches={
                    f"{fn}/{t}": v for (fn, t), v in used.items()})
                print(f"[zoo] {label}: {len(mgr.store.active())} active "
                      f"tracks, h {tuple(scorer.last_frame['h_d'].shape)} "
                      f"{scorer.last_frame['h_d'].dtype}; steps "
                      f"{[round(x, 1) for x in ms]} ms; launches "
                      f"{summary[label]['launches']} on {card}", flush=True)
    return summary, records, models


def bf16_chain_check(model, rec) -> tuple:
    """A bf16 frame against the fused chain's plain version on its padded
    inputs: the kernel's pooled features again (a comparison launch) and
    the plain version's, their rel_err (the kernel's bar, BF16_TOL: a bf16
    logit after the head may sit two ulps from the plain one), and whether
    the frame's logits are the kernel's pooled features through the head
    bit for bit. Returns (max_abs_err, rel_err, equal)."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    h_t, xyz_t, h_d, xyz_d = (rec[k] for k in ("h_t", "xyz_t", "h_d",
                                               "xyz_d"))
    nt, nd = h_t.shape[0], h_d.shape[0]
    with torch.no_grad():
        t, d, w1, w2, nhead = mg.match_factors(model, h_t, xyz_t, h_d, xyz_d)
        if rec["pairs"] is None:
            ti = torch.arange(nt, device=DEVICE).repeat_interleave(nd)
            di = torch.arange(nd, device=DEVICE).repeat(nt)
            pooled = mg.fused_match_grid(t, d, w1, w2, nhead).reshape(
                nt * nd, -1)
        else:
            ti, di = rec["pairs"]
            pooled = mg.fused_match_pairs(t, d, w1, w2, nhead, ti, di)
        plain = mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di)
        logits = model.match_head(pooled)[:, 0]
    err, rel = rel_err(pooled.float(), plain.float())
    return err, rel, torch.equal(logits, rec["logits"].reshape(-1))


def model_plain_logits(model, rec):
    """A frame's logits by the model itself over its padded inputs:
    match_logits_grid for a dense frame, match_logits on the listed pairs
    for a sparse one."""
    import torch
    h_t, xyz_t, h_d, xyz_d = (rec[k] for k in ("h_t", "xyz_t", "h_d",
                                               "xyz_d"))
    with torch.no_grad():
        if rec["pairs"] is None:
            return model.match_logits_grid(h_t, xyz_t, h_d, xyz_d)
        pt, pd = (p.long() for p in rec["pairs"])
        return model.match_logits(h_t[pt], xyz_t[pt], h_d[pd], xyz_d[pd])[0]


def zoo_baselines(card: str, every: dict) -> tuple:
    """One dense frame of each baseline leaf: no match-kernel launch.
    Returns (summary, [(label, model, the frame)])."""
    import torch
    summary, records = {}, []
    match = [k for k in every if k.startswith(("fused_match_",
                                               "fused_image_match_"))]
    for name, leaf in BASELINES.items():
        model = zoo_model(leaf, torch.float32)
        before = {k: every[k].launches for k in every}
        ms, scorer, _ = run_scene(model, "never", frames=2)
        used = {k: every[k].launches - before[k] for k in every}
        if scorer.fused or any(used[k] for k in match):
            raise RuntimeError(f"{name}: the baseline head reached the match "
                               f"kernels: {used}")
        records.append((name, model, scorer.last_frame))
        summary[name] = dict(step_ms=ms, launches={k: v for k, v in
                                                   used.items() if v})
        print(f"[zoo] {name} ({leaf}): a dense frame of "
              f"{tuple(scorer.last_frame['logits'].shape)} pairs on plain "
              f"torch, steps {[round(x, 1) for x in ms]} ms; launches "
              f"{summary[name]['launches']} (no match kernel) on {card}",
              flush=True)
    return summary, records


def zoo_train(card: str, every: dict) -> dict:
    """ZOO_TRAIN_STEPS steps of each family's leaf at TRAIN_PAIRS pairs,
    float32 and bf16, with the kernel knobs it takes (profile_train.
    model_knobs), then one step split by CUDA events."""
    import torch
    from point_cloud_reid_tpu_torch.tools.profile_train import (
        _phases_ms, train_setup, train_spec)
    summary = {}
    families = dict(ZOO, **BASELINES)
    for family, leaf in families.items():
        spec = train_spec(leaf, kernels=True)
        for dtype in (torch.float32, torch.bfloat16):
            name = "bf16" if dtype == torch.bfloat16 else "float32"
            knn0 = every["knn"].launches
            attn0 = every["linear_attention"].launches
            run = train_setup(spec, torch.device(DEVICE), TRAIN_PAIRS,
                              ZOO_TRAIN_STEPS + 1,
                              bf16=dtype == torch.bfloat16)
            torch.cuda.reset_peak_memory_stats()
            times, logs = [], []
            for batch in run["batches"][:ZOO_TRAIN_STEPS]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, log = run["step"](run["state"], batch, run["generator"])
                logs.append({k: float(v) for k, v in log.items()})
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            fwd, bwd, opt = _phases_ms(run, run["batches"][ZOO_TRAIN_STEPS])
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            knn_n = every["knn"].launches - knn0
            attn_n = every["linear_attention"].launches - attn0
            # the point-transformer backbone (the baselines) runs kNN, and
            # DGCNN its feature-space kNN (tiers S and C); every leaf but
            # concat has cross stages
            want_knn = family in BASELINES or family == "DGCNN"
            want_attn = family != "concat"
            if not (all(np.isfinite(v) for log in logs for v in log.values())
                    and (knn_n > 0) == want_knn
                    and (attn_n > 0) == want_attn):
                raise RuntimeError(f"{family} {name} training: logs {logs}, "
                                   f"kNN {knn_n}, attention {attn_n}")
            summary[f"{family} {name}"] = dict(
                leaf=leaf, pairs=TRAIN_PAIRS, step_ms=times,
                forward_ms=fwd, backward_ms=bwd, optimizer_ms=opt,
                peak_gib=peak, step1_loss=logs[0]["reid_loss"],
                knn_launches=knn_n, attention_launches=attn_n)
            print(f"[zoo:train] {family} {name}, {TRAIN_PAIRS} pairs: steps "
                  f"{[round(x, 1) for x in times]} ms, fwd / bwd / opt "
                  f"{fwd:.1f} / {bwd:.1f} / {opt:.1f} ms, peak {peak:.2f} "
                  f"GiB, loss {[round(x['reid_loss'], 4) for x in logs]}, "
                  f"launches knn {knn_n} attention {attn_n} on {card}",
                  flush=True)
            del run
            torch.cuda.empty_cache()
    return summary


def zoo_checks(frames, models, baselines, summary: dict) -> None:
    """The phase's comparisons, after its launches were read: the launches
    they make do not count."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.timing import time_ms
    for label, family, dtype, rec in frames:
        out = summary["frames"][label]
        if dtype == torch.float32:
            err, rel = rel_err(rec["logits"], model_plain_logits(
                models[family][dtype], rec))
            out.update(max_abs_err=err, rel_err=rel)
            ok = rel <= MATCH_TOL
            bar = f"tol {MATCH_TOL:g} against the model's plain scoring"
        else:
            err, rel, equal = bf16_chain_check(models[family][dtype], rec)
            out.update(pooled_max_abs_err=err, pooled_rel_err=rel,
                       logits_are_the_kernels=equal,
                       logit_gap=bf16_point_gap(
                           models[family][torch.float32], rec, label))
            ok = rel <= BF16_TOL and equal
            bar = (f"the kernel's pooled features against the chain's bf16 "
                   f"plain version, tol {BF16_TOL:g}; the frame's logits "
                   f"are the kernel's through the head bit for bit: "
                   f"{equal}")
        print(f"[zoo:{label}] logits {tuple(rec['logits'].shape)}: "
              f"max_abs_err={err:.3e} rel={rel:.3e} ({bar})", flush=True)
        if not (ok and bool(torch.isfinite(rec["logits"]).all())):
            raise RuntimeError(f"{label}: off plain scoring ({rel})")
        if rec["pairs"] is None:
            # the dense frame's grid kernel and the embed, on its inputs
            model = models[family][dtype]
            t, d, w1, w2, nhead = mg.match_factors(
                model, rec["h_t"], rec["xyz_t"], rec["h_d"], rec["xyz_d"])
            with torch.no_grad():
                out["grid_ms"] = time_ms(
                    lambda: mg.fused_match_grid(t, d, w1, w2, nhead), 5)
                out["embed_ms"] = time_ms(
                    lambda: model.embed(rec["xyz_d"]), 5)
            print(f"[zoo:{label}] grid kernel {out['grid_ms']:.3f} ms "
                  f"({t[0].shape[0]} x {d[0].shape[0]}, N={t[0].shape[1]}, "
                  f"C={t[0].shape[2]}), embed of {rec['xyz_d'].shape[0]} "
                  f"crops {out['embed_ms']:.3f} ms", flush=True)
    for name, model, rec in baselines:
        nt, nd = rec["logits"].shape
        ti = torch.arange(nt, device=DEVICE).repeat_interleave(nd)
        di = torch.arange(nd, device=DEVICE).repeat(nt)
        with torch.no_grad():
            want = model.match_logits(rec["h_t"][ti], rec["xyz_t"][ti],
                                      rec["h_d"][di], rec["xyz_d"][di])[0]
        err, rel = rel_err(rec["logits"].reshape(-1), want)
        summary["baselines"][name].update(max_abs_err=err, rel_err=rel)
        print(f"[zoo:{name}] {nt} x {nd} logits against match_logits on its "
              f"{nt * nd} pairs: max_abs_err={err:.3e} rel={rel:.3e} (tol "
              f"{MATCH_TOL:g})", flush=True)
        if not rel <= MATCH_TOL:
            raise RuntimeError(f"{name}: logits off match_logits ({rel})")


def phase_zoo(card: str):
    """Phase 12: the rest of the registry. Returns (the path's launches, a
    summary)."""
    import torch
    t_phase = time.perf_counter()
    every = zero_counters()
    summary = {}
    summary["frames"], frames, models = zoo_frames(card)
    headline, scorer = serve_ablation(card, every, leaf=ZOO_ABLATION)
    summary["ablation_cli"] = headline
    del scorer
    torch.cuda.empty_cache()
    summary["baselines"], baselines = zoo_baselines(card, every)
    torch.cuda.empty_cache()
    summary["train"] = zoo_train(card, every)
    launches = {name: fn.launches for name, fn in every.items()}
    zoo_checks(frames, models, baselines, summary)
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"[zoo] path launches "
          f"{ {k: v for k, v in launches.items() if v} }; phase took "
          f"{summary['seconds']:.1f} s", flush=True)
    return launches, summary


def tracker_zoo_model(name: str, dtype):
    """A zoo config (configs/zoo.py: a leaf and its --set list) at full
    width with seeded weights."""
    import torch
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.configs.zoo import ZOO as TRACKER
    from point_cloud_reid_tpu_torch.models import build_model
    leaf, sets = TRACKER[name]
    return build_model(get_experiment(leaf, set_options=sets)["model"],
                       device=DEVICE, dtype=dtype,
                       generator=torch.Generator().manual_seed(SEED))


def tracker_zoo_serve(model, sparse: str, label: str, card: str,
                      every: dict) -> dict:
    """TRACKER_ZOO_FRAMES frames of the serving scene behind
    TrackingManager.step, the last one under torch.profiler: step ms,
    device ms and busy share of the profiled frame, peak memory, the
    kernels' launches, the scorer (which holds the last frame)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.tools.profile_tracker import _busy_us
    from point_cloud_reid_tpu_torch.tools.scenes import bench_scene
    from point_cloud_reid_tpu_torch.tracking import TrackingManager
    before = {k: fn.launches for k, fn in every.items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    scorer = PairScorer(model)
    mgr = TrackingManager(scorer, subsample_number=128, match_threshold=1.0,
                          seed=SEED, sparse_scoring=sparse)
    frames = list(bench_scene(N_OBJ, PTS_PER_OBJ, TRACKER_ZOO_FRAMES, SEED))
    times = []

    def step(frame):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.step(*frame)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    for frame in frames[:-1]:
        step(frame)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(frames[-1])
        window_us = (time.perf_counter() - t0) * 1e6
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_tracker_zoo.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(trace)
    spans = [(ev["ts"], ev["dur"]) for ev in events
             if ev.get("cat") == "kernel"]
    if not spans:
        raise RuntimeError(f"{label}: the profiler recorded no device kernels")
    rec = scorer.last_frame
    if not bool(torch.isfinite(rec["logits"]).all()):
        raise RuntimeError(f"{label}: non-finite logits")
    used = {k: fn.launches - before[k] for k, fn in every.items()}
    out = dict(step_ms=times, device_ms=sum(d for _, d in spans) / 1e3,
               busy=_busy_us(spans) / window_us,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               fused=scorer.fused, pairs=None if rec["pairs"] is None
               else int(rec["pairs"][0].shape[0]),
               grid=tuple(rec["logits"].shape),
               launches={k: v for k, v in used.items() if v})
    print(f"[tracker_zoo] {label}: {len(mgr.store.active())} active tracks, "
          f"logits {out['grid']}; steps {[round(x, 1) for x in times]} ms, "
          f"the last frame {out['device_ms']:.2f} device ms (busy "
          f"{100 * out['busy']:.1f} %), peak {out['peak_gib']:.2f} GiB; "
          f"launches {out['launches']} on {card}", flush=True)
    return dict(out, scorer=scorer)


def tracker_zoo_rows_used(launches: dict) -> int:
    """Launches of the match kernels (kernel rows 2-4) in a launch dict."""
    return sum(v for k, v in launches.items()
               if k.startswith(("fused_match_", "fused_image_match_")))


def tracker_zoo_check(model, model32, rec, label: str) -> dict:
    """A frame's logits against the model's own plain scoring on the same
    crops: a fused head's against match_logits_grid / match_logits on the
    card (MATCH_TOL); any other head's (the frame then ran the model's own
    chunked scoring) against one unchunked batch of match_logits over the
    frame's listed pairs, or TRACKER_ZOO_CHECK_PAIRS pairs of a dense grid;
    a bf16 frame's against the float32 port's (BF16_LOGIT_TOL)."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    if model.dtype == torch.bfloat16:
        return dict(logit_gap=bf16_point_gap(
            model32, rec, label, BF16_XCORR_LOGIT_TOL
            if model.match_type == "xcorr" else BF16_LOGIT_TOL))
    h_t, xyz_t, h_d, xyz_d = (rec[k] for k in ("h_t", "xyz_t", "h_d",
                                               "xyz_d"))
    got = rec["logits"].reshape(-1)
    with torch.no_grad():
        if mg.fused_head_ok(model):
            want = model_plain_logits(model, rec).reshape(-1)
        else:
            if rec["pairs"] is None:
                nt, nd = rec["logits"].shape
                gen = torch.Generator().manual_seed(SEED + 13)
                pick = torch.randperm(nt * nd, generator=gen)[
                    :TRACKER_ZOO_CHECK_PAIRS].to(DEVICE)
                ti, di = pick // nd, pick % nd
                got = got[pick]
            else:
                ti, di = (p.long() for p in rec["pairs"])
            want = model.match_logits(h_t[ti], xyz_t[ti], h_d[di],
                                      xyz_d[di])[0]
    err, rel = rel_err(got, want)
    print(f"[tracker_zoo:{label}] {got.numel()} logits against the model's "
          f"plain scoring: max_abs_err={err:.3e} rel={rel:.3e} (tol "
          f"{MATCH_TOL:g})", flush=True)
    if not rel <= MATCH_TOL:
        raise RuntimeError(f"{label}: off plain scoring ({rel})")
    return dict(max_abs_err=err, rel_err=rel)


def tracker_zoo_train(card: str, name: str, every: dict) -> dict:
    """One step of 256 pairs with the kernel knobs on (profile_train.
    model_knobs: kNN, and the cross and local stages' attention where
    'linear-pallas' names the kernel), step ms and peak memory, and its
    loss against the same step with the knobs off."""
    import torch
    from point_cloud_reid_tpu_torch.configs.zoo import ZOO as TRACKER
    from point_cloud_reid_tpu_torch.tools.profile_train import (
        train_setup, train_spec)
    leaf, sets = TRACKER["xcorr" if name == "xcorr-pallas" else name]
    logs, out = {}, {}
    for kernels in (True, False):
        before = {k: fn.launches for k, fn in every.items()}
        run = train_setup(train_spec(leaf, kernels, sets),
                          torch.device(DEVICE), TRAIN_PAIRS, 1)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, log = run["step"](run["state"], run["batches"][0],
                             run["generator"])
        logs[kernels] = {k: float(v) for k, v in log.items()}
        torch.cuda.synchronize()
        if kernels:
            used = {k: fn.launches - before[k] for k, fn in every.items()}
            out = dict(step_ms=(time.perf_counter() - t0) * 1e3,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       launches={k: v for k, v in used.items() if v})
        del run
        torch.cuda.empty_cache()
    on, off = logs[True]["reid_loss"], logs[False]["reid_loss"]
    rel = abs(on - off) / max(1.0, abs(off))
    out.update(loss=on, loss_knobs_off=off, rel=rel,
               grad_norm=logs[True]["grad_norm"])
    print(f"[tracker_zoo:train] {name}, {TRAIN_PAIRS} pairs, knobs on: step "
          f"{out['step_ms']:.1f} ms (cold), peak {out['peak_gib']:.2f} GiB, "
          f"loss {on:.6f} against {off:.6f} knobs off (rel {rel:.2e}, tol "
          f"{TRAIN_TOL:g}); launches {out['launches']} on {card}",
          flush=True)
    want_attn = name in ("xcorr-pallas", "vn_dgcnn", "add")
    if not (all(np.isfinite(v) for v in logs[True].values())
            and rel <= TRAIN_TOL
            and (out["launches"].get("linear_attention", 0) > 0)
            == want_attn):
        raise RuntimeError(f"{name} training: {logs}, {out['launches']}")
    if name == "xcorr-pallas" and not out["launches"].get(
            "linear_attention/one_query"):
        raise RuntimeError("xcorr training ran its local stages off the "
                           "kernel")
    return out


def tracker_zoo_cli(card: str, name: str, every: dict) -> dict:
    """tools/track.py serves a zoo config through --set over a small
    synthetic scene. Returns its headline and launches."""
    import contextlib
    import io
    import shutil
    from point_cloud_reid_tpu_torch.configs.zoo import ZOO as TRACKER
    from point_cloud_reid_tpu_torch.tools import track
    leaf, sets = TRACKER[name]
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_tracker_zoo")
    shutil.rmtree(work, ignore_errors=True)
    before = {k: fn.launches for k, fn in every.items()}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        track.main([leaf, "--scenes", "1", "--frames", "4", "--objects",
                    "16", "--match-threshold", "1.0", "--work-dir", work]
                   + [a for s in sets for a in ("--set", s)])
    headline = json.loads(out.getvalue().strip().splitlines()[-1])
    used = {k: fn.launches - before[k] for k, fn in every.items()}
    used = {k: v for k, v in used.items() if v}
    print(f"[tracker_zoo:cli] tools/track.py {leaf} ({name} through --set): "
          f"launches {used}; headline {json.dumps(headline)} on {card}",
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    if headline.get("frames") != 4 or not used.get("fused_sa_convmax") or (
            name == "xcorr-pallas"
            and not used.get("linear_attention/one_query")):
        raise RuntimeError(f"tools/track.py {name}: {headline}, {used}")
    return dict(headline=headline, launches=used)


def local_attention_row(card: str) -> dict:
    """The linear-attention kernel at the local stages' shape (one query,
    LOCAL_ATTN_KEYS keys a row, two heads of 32) against its plain
    version: forward and gradients at the first row count, forward at the
    second (the plain version there in chunks of the first's rows, its
    times summed). Returns the kernels-line row (launches from the
    phase's path)."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import linear_attention as la
    from point_cloud_reid_tpu_torch.tools.timing import graph_ms, time_ms
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    H, D, S = 2, 32, LOCAL_ATTN_KEYS
    shapes, err_max = [], 0.0
    for R in LOCAL_ATTN_ROWS:
        q = torch.randn((R, 1, H, D), generator=gen, device=DEVICE)
        k = torch.randn((R, S, H, D), generator=gen, device=DEVICE)
        v = torch.randn((R, S, H, D), generator=gen, device=DEVICE)
        chunk = LOCAL_ATTN_ROWS[0]
        g_rel = None
        if R == chunk:
            q, k, v = (t.requires_grad_(True) for t in (q, k, v))
            got = la.fused_linear_attention(q, k, v)
            want = la.linear_attention_reference(q, k, v)
            go = torch.randn(got.shape, generator=gen, device=DEVICE)
            g_got = torch.autograd.grad(got, (q, k, v), go)
            g_want = torch.autograd.grad(want, (q, k, v), go)
            g_rel = max(rel_err(a, b)[1] for a, b in zip(g_got, g_want))
            got, want = got.detach(), want.detach()
            q, k, v = (t.detach() for t in (q, k, v))
            del g_got, g_want, go
        with torch.no_grad():
            if R != chunk:
                got = la.linear_attention_forward(q, k, v)
                want = torch.cat([la.linear_attention_reference(
                    q[a:a + chunk], k[a:a + chunk], v[a:a + chunk])
                    for a in range(0, R, chunk)])
            err, rel = rel_err(got, want)
            iters = 20 if R == chunk else 3
            ms = time_ms(lambda: la.linear_attention_forward(q, k, v), iters)
            device = graph_ms(lambda: la.linear_attention_forward(q, k, v),
                              iters)
            plain = sum(time_ms(lambda: la.linear_attention_reference(
                q[a:a + chunk], k[a:a + chunk], v[a:a + chunk]), 3)
                for a in range(0, R, chunk))
        flops = R * H * (2.0 * S * D * D + 2.0 * D * D + 2.0 * D + S * D)
        b_ms, b_by = bound_ms(flops, nbytes(q, k, v, got))
        print(f"[tracker_zoo:linear_attention] rows={R} L=1 S={S} H={H} "
              f"D={D}: max_abs_err={err:.3e} rel={rel:.3e}, gradients rel="
              f"{g_rel if g_rel is None else format(g_rel, '.3e')} (tol "
              f"{ATTN_TOL:g}); kernel {ms:.4f} ms (device {device:.4f}), "
              f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}) on {card}",
              flush=True)
        if not (rel <= ATTN_TOL and (g_rel is None or g_rel <= ATTN_TOL)):
            raise RuntimeError(f"linear_attention at one query disagrees: "
                               f"{rel}, {g_rel}")
        err_max = max(err_max, err)
        shapes.append(dict(rows=R, L=1, S=S, H=H, D=D, V=D, max_abs_err=err,
                           grad_rel=g_rel, ms=ms, device_ms=device,
                           plain_ms=plain, bound_ms=b_ms, bound_by=b_by))
        del q, k, v, got, want
        torch.cuda.empty_cache()
    first = shapes[0]
    return dict(name="linear_attention/one_query", route="cuda",
                source="point_cloud_reid_tpu_torch/csrc/linear_attention.cu",
                replaces="point_cloud_reid_tpu/ops/pallas/linear_attention.py"
                         ":107",
                max_abs_err=err_max, ms=first["ms"],
                device_ms=first["device_ms"], plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                library_ms=None, shapes=shapes)


def phase_tracker_zoo(card: str):
    """Phase 13: the tracker-era zoo. Returns (the path's launches, the
    kernels-line row of the attention kernel's local shape, a summary)."""
    import torch
    t_phase = time.perf_counter()
    every = zero_counters()
    summary = dict(frames={}, train={}, cli={})
    records = []
    models32 = {}
    for name in TRACKER_ZOO:
        for dtype in ((torch.float32, torch.bfloat16)
                      if name in TRACKER_ZOO_BF16 else (torch.float32,)):
            model = tracker_zoo_model(name, dtype)
            if dtype == torch.float32:
                models32[name] = model
            kind = "bf16" if dtype == torch.bfloat16 else "float32"
            for sparse, mode in (("auto", "sparse"), ("never", "dense")):
                label = f"{name} {kind} {mode}"
                got = tracker_zoo_serve(model, sparse, label, card, every)
                scorer = got.pop("scorer")
                # the match kernels take vn_dgcnn's head alone, as JAX's
                # _pallas_grid_ok; rows 2-4 read 0 for every other head
                rows24 = tracker_zoo_rows_used(got["launches"])
                if scorer.fused != (name == "vn_dgcnn") or (
                        (rows24 > 0) != scorer.fused) or (
                        name != "vn_dgcnn"
                        and not got["launches"].get("fused_sa_convmax", 0)
                        + got["launches"].get("fused_sa_convmax/bf16", 0)):
                    raise RuntimeError(f"{label}: gate {scorer.fused}, "
                                       f"launches {got['launches']}")
                if name == "xcorr-pallas" and not got["launches"].get(
                        "linear_attention/one_query"):
                    raise RuntimeError(f"{label}: the local stages ran off "
                                       "the kernel")
                got["match_kernel_launches"] = rows24
                summary["frames"][label] = got
                records.append((label, name, model, scorer.last_frame))
            if dtype == torch.bfloat16:
                del model
    for name in TRACKER_ZOO:
        summary["train"][name] = tracker_zoo_train(card, name, every)
    for name in TRACKER_ZOO_CLI:
        summary["cli"][name] = tracker_zoo_cli(card, name, every)
    launches = {name: fn.launches for name, fn in every.items()}
    # the comparisons, after the launches were read
    for label, name, model, rec in records:
        summary["frames"][label].update(tracker_zoo_check(
            model, models32[name], rec, label))
    records.clear()
    models32.clear()
    torch.cuda.empty_cache()
    row = local_attention_row(card)
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"[tracker_zoo] path launches "
          f"{ {k: v for k, v in launches.items() if v} }; phase took "
          f"{summary['seconds']:.1f} s", flush=True)
    return launches, [row], summary


# ---- phase 14: the reference-checkpoint path and the rest of the ops -------

def write_reference_pth(model, path: str) -> None:
    """The model's weights as a released reference checkpoint would hold
    them: reference names and layouts (Conv2d SA convs, a Conv1d
    cov_final), BatchNorm's num_batches_tracked, the FP modules' convs and
    BatchNorms that the reference builds and never runs, DDP's 'module.'
    prefixes, mmcv's envelope."""
    import torch
    from point_cloud_reid_tpu_torch.convert import reference_state_dict
    sd = {k: v.cpu() for k, v in reference_state_dict(model).items()}
    g = torch.Generator().manual_seed(SEED)
    for i in range(3):
        sd[f"backbone.FP_modules.{i}.mlp_convs.0.weight"] = torch.randn(
            64, 64, 1, generator=g)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"backbone.FP_modules.{i}.mlp_bns.0.{leaf}"] = torch.rand(
                64, generator=g)
        sd[f"backbone.FP_modules.{i}.mlp_bns.0.num_batches_tracked"] = \
            torch.tensor(0)
    torch.save({"meta": {"epoch": 500}, "state_dict": {
        "module." + k: v for k, v in sd.items()}}, path)


def timed_evaluations():
    """Time each Trainer.evaluate (synchronised) and its pairs; returns
    (the list of (seconds, pairs), undo)."""
    import torch
    from point_cloud_reid_tpu_torch.train import loop
    saved = loop.Trainer.evaluate
    runs = []

    def evaluate(self, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved(self, state)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0,
                     len(self.val_loader) * self.val_loader.batch_size))
        return out

    loop.Trainer.evaluate = evaluate

    def undo():
        loop.Trainer.evaluate = saved
    return runs, undo


def parity_call(*argv) -> tuple:
    """tools.parity_eval in this process: (exit code, its JSON)."""
    import contextlib
    import io
    from point_cloud_reid_tpu_torch.tools import parity_eval
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            parity_eval.main(list(argv))
        except SystemExit as e:
            code = e.code
    text = buf.getvalue()
    return code, json.loads(text[text.rfind("{\n"):])


def reference_flagship(card: str, every: dict, work: str) -> dict:
    """The flagship testing leaf at full width from a seeded reference
    .pth: tools.convert_checkpoint, the loaded model's logits on an eval
    batch against the seeded model's (equal bit for bit), tools.test from
    the converted checkpoint, and tools.parity_eval --pth at tools.test's
    accuracy (delta 0, exit 0) and past the tolerance (exit 1)."""
    import torch
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.data import (BatchLoader, SyntheticStore,
                                                 build_pair_dataset)
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.tools import convert_checkpoint
    from point_cloud_reid_tpu_torch.tools import test as test_cli
    from point_cloud_reid_tpu_torch.train import to_device

    cfg = get_experiment(REF_LEAF, set_options=list(KNOBS))
    seeded = build_model(cfg["model"], device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED + 14))
    pth = os.path.join(work, "reference.pth")
    write_reference_pth(seeded, pth)
    t0 = time.perf_counter()
    ckpt = quiet(convert_checkpoint.main, [pth, REF_LEAF,
                                           os.path.join(work, "converted")])
    convert_s = time.perf_counter() - t0
    loaded = build_model(cfg["model"], device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED + 15))
    loaded.load_state_dict(torch.load(ckpt, map_location=DEVICE,
                                      weights_only=True)["model"])
    dcfg = cfg["dataset"]
    store = SyntheticStore(num_objects=REF_OBJECTS, crop_size=(32, 32),
                           class_names=list(dcfg["train"]["classes"]))
    val = build_pair_dataset(dcfg["val"], store, store)
    batch = to_device(next(iter(BatchLoader(val, REF_BATCH, shuffle=False))),
                      DEVICE)
    with torch.no_grad():
        want = seeded(batch)["match_logits"]
        got = loaded(batch)["match_logits"]
    if not (torch.equal(got, want) and bool(torch.isfinite(got).all())):
        raise RuntimeError("reference path: the converted flagship's logits "
                           "are not the seeded model's")
    del seeded, loaded
    torch.cuda.empty_cache()

    data = ["--synthetic-objects", str(REF_OBJECTS), "--batch-size",
            str(REF_BATCH), "--device", DEVICE]
    for s in KNOBS:
        data += ["--set", s]
    runs, undo = timed_evaluations()
    zero_counters()
    try:
        metrics = quiet(test_cli.main, [REF_LEAF, "--checkpoint", ckpt,
                                        "--work-dir",
                                        os.path.join(work, "test"), *data])
        acc = 100.0 * metrics["val_match_acc"]
        code, out = parity_call(REF_LEAF, "--pth", pth, "--expected-acc",
                                repr(acc), "--work-dir",
                                os.path.join(work, "parity"), *data)
        bad_code, bad = parity_call(REF_LEAF, "--pth", pth, "--expected-acc",
                                    repr(acc + 2 * REF_TOLERANCE), *data)
    finally:
        undo()
    launches = {k: every[k].launches for k in ("fused_sa_convmax", "knn",
                                               "linear_attention")}
    if code != 0 or out.get("delta_pct") != 0.0 or not out.get("parity"):
        raise RuntimeError(f"parity_eval at tools.test's accuracy: exit "
                           f"{code}, {out}")
    if bad_code != 1 or bad.get("parity") is not False:
        raise RuntimeError(f"parity_eval past the tolerance: exit "
                           f"{bad_code}, {bad}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"reference path: a kernel was not launched "
                           f"{launches}")
    seconds = [s for s, _ in runs]
    pairs = runs[0][1]
    summary = dict(val_pairs=pairs, val_match_acc_pct=out["val_match_acc_pct"],
                   delta_pct=out["delta_pct"], exit=code,
                   exit_past_tolerance=bad_code,
                   eval_seconds=seconds,
                   eval_pairs_per_s=[pairs / s for s in seconds],
                   convert_seconds=convert_s, launches=launches)
    print(f"[reference] flagship from a reference .pth: logits equal the "
          f"seeded model's on {REF_BATCH} pairs; tools.test "
          f"{acc:.3f} %, parity_eval delta {out['delta_pct']} (exit {code}), "
          f"past the tolerance exit {bad_code}; eval {pairs} pairs, "
          f"{[round(pairs / s, 1) for s in seconds]} pairs/s (tools.test, "
          f"parity_eval x2); convert {convert_s:.2f} s; launches {launches} "
          f"on {card}", flush=True)
    return summary


def reference_deit(card: str) -> dict:
    """DeiT-tiny at full width from a seeded HF-named state dict under
    backbone.deit. (with the teacher's classifier and pooler and the cross
    stages' dead pos_mlp): load_image_reference_state_dict, then the
    loaded model's logits against the seeded model's, bit for bit."""
    import torch
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.convert import (
        load_image_reference_state_dict, reference_state_dict)
    from point_cloud_reid_tpu_torch.models import build_model
    cfg = get_experiment(IMAGE_LEAF)["model"]
    seeded = build_model(cfg, device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED + 16))
    sd = {k.replace("backbone.", "backbone.deit.", 1): v.cpu().numpy()
          for k, v in reference_state_dict(seeded).items()}
    rs = np.random.RandomState(SEED)
    dim, d = 192, cfg["cross_lin_attn"]["d_model"]
    for name, shape in (("cls_classifier.weight", (1000, dim)),
                        ("cls_classifier.bias", (1000,)),
                        ("distillation_classifier.weight", (1000, dim)),
                        ("distillation_classifier.bias", (1000,)),
                        ("deit.pooler.dense.weight", (dim, dim))):
        sd["backbone." + name] = rs.randn(*shape).astype(np.float32)
    for i in (1, 2):
        sd[f"cross_stage{i}.pos_mlp.0.weight"] = rs.randn(d, 3).astype(
            np.float32)
        sd[f"cross_stage{i}.pos_mlp.2.weight"] = rs.randn(d, d).astype(
            np.float32)
    loaded = build_model(cfg, device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED + 17))
    t0 = time.perf_counter()
    report = load_image_reference_state_dict(loaded, sd)
    load_s = time.perf_counter() - t0
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    size = cfg.get("image_size", 224)
    batch = {k: torch.randn((IMAGE_PAIRS, 3, size, size), generator=g,
                            device=DEVICE) for k in ("sparse_1", "sparse_2")}
    with torch.no_grad():
        want = seeded(batch)["match_logits"]
        got = loaded(batch)["match_logits"]
    if report != {"unmatched_torch": [], "unfilled_flax": []} or not (
            torch.equal(got, want) and bool(torch.isfinite(got).all())):
        raise RuntimeError(f"reference path: DeiT-tiny from HF names: "
                           f"report {report}, logits equal "
                           f"{torch.equal(got, want)}")
    print(f"[reference] DeiT-tiny from {len(sd)} HF-named tensors: logits "
          f"equal the seeded model's on {IMAGE_PAIRS} pairs; load "
          f"{load_s:.2f} s on {card}", flush=True)
    return dict(tensors=len(sd), pairs=IMAGE_PAIRS, load_seconds=load_s)


def lidar_cloud(n: int, seed: int) -> np.ndarray:
    """(n, 5) x, y, z, intensity, sweep lag of ten aggregated sweeps: half
    the points are a static scene seen in every sweep (each sweep's return
    within 1 cm of the last, so a voxel collects up to ten returns of a
    point and more of its neighbours'), half are seen once (moving objects,
    new returns). Ground returns are denser near the sensor (some past the
    range), the rest fall in 300 car-sized clusters, a few above and below
    the z range."""
    rs = np.random.RandomState(seed)

    def scene(m):
        n_obj = m * 3 // 10
        r = 1.5 + 60.0 * rs.rand(m - n_obj) ** 1.6
        a = rs.rand(m - n_obj) * 2 * np.pi
        ground = np.stack([r * np.cos(a), r * np.sin(a),
                           -1.8 + 0.05 * rs.randn(m - n_obj)], 1)
        centers = rs.uniform(-50, 50, (300, 2))
        obj = np.concatenate([centers[rs.randint(0, 300, n_obj)],
                              np.full((n_obj, 1), -0.95)], 1) \
            + (rs.rand(n_obj, 3) - 0.5) * [4.5, 2.0, 1.7]
        return np.concatenate([ground, obj])

    sweeps = 10
    static = scene(n // 2 // sweeps)
    xyz = np.concatenate(
        [static + 0.01 * rs.randn(*static.shape) for _ in range(sweeps)]
        + [scene(n - sweeps * len(static))])
    lag = np.concatenate([np.full(len(static), k * 0.05)
                          for k in range(sweeps)]
                         + [rs.randint(0, sweeps, n - sweeps * len(static))
                            * 0.05])
    xyz[rs.randint(0, n, 200), 2] = rs.choice([-6.0, 4.0], 200)
    return np.concatenate([xyz, np.stack([rs.rand(n), lag], 1)],
                          1).astype(np.float32)


def op_check(label: str, fn, cpu_args, dev_args, results: dict) -> tuple:
    """fn on the CPU and on the card on the same inputs: every output equal
    (integer and bool) or within OPS_TOL of max(1, |CPU|) (float); the
    card's call timed (CUDA events around calls from Python). Returns
    (the CPU outputs, the card's outputs)."""
    import torch
    from point_cloud_reid_tpu_torch.tools.timing import time_ms
    want = fn(*cpu_args)
    got = fn(*dev_args)
    many = isinstance(want, tuple)
    pairs = zip(want, got) if many else [(want, got)]
    err = 0.0
    for w, g in pairs:
        g = g.cpu()
        if w.shape != g.shape or w.dtype != g.dtype:
            raise RuntimeError(f"ops: {label}: {tuple(g.shape)} {g.dtype} "
                               f"against {tuple(w.shape)} {w.dtype}")
        if w.dtype.is_floating_point:
            e = ((g.double() - w.double()).abs()
                 / w.double().abs().clamp(min=1.0))
            e = e.max().item() if e.numel() else 0.0
            if not e <= OPS_TOL:
                raise RuntimeError(f"ops: {label}: error {e:.3g} > {OPS_TOL}")
            err = max(err, e)
        elif not torch.equal(g, w):
            raise RuntimeError(f"ops: {label}: indices differ from the CPU's")
    ms = time_ms(lambda: fn(*dev_args), OPS_ITERS, warmup=1)
    results[label] = dict(ms=ms, max_rel_err=err)
    return want, got


def reference_ops(card: str) -> dict:
    """The ops of items 4-8 at realistic sizes on the card against the
    same call on the CPU."""
    import torch
    from point_cloud_reid_tpu_torch import ops
    results: dict = {}
    dev = torch.device(DEVICE)

    def both(*arrays):
        cpu = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(
            a, np.ndarray) else a for a in arrays]
        return cpu, [a.to(dev) if torch.is_tensor(a) else a for a in cpu]

    # voxels: a 10-sweep cloud at TransFusion-L's nuScenes lidar settings
    pts = lidar_cloud(OPS_POINTS, SEED)
    c, d = both(pts)
    vox, vox_dev = op_check("voxelize_hard", ops.voxelize_hard,
                            c + [OPS_VOXEL, OPS_RANGE, OPS_MAX_PTS,
                                 OPS_MAX_VOXELS],
                            d + [OPS_VOXEL, OPS_RANGE, OPS_MAX_PTS,
                                 OPS_MAX_VOXELS], results)
    voxels, coords, num_points, num_voxels = vox
    pts_t = torch.from_numpy(pts)
    lo = torch.tensor(OPS_RANGE[:3])
    hi = torch.tensor(OPS_RANGE[3:])
    vs = torch.tensor(OPS_VOXEL)
    grid = torch.floor((hi - lo) / vs).long()
    cell = torch.floor((pts_t[:, :3] - lo) / vs).long()
    inside = ((cell >= 0) & (cell < grid)).all(1)
    lin = (cell[:, 2] * grid[1] + cell[:, 1]) * grid[0] + cell[:, 0]
    uniq, inv = torch.unique(lin[inside], return_inverse=True)
    ids = torch.full((OPS_POINTS,), -1, dtype=torch.long)
    ids[inside] = inv
    c, d = both(pts, ids)
    op_check("dynamic_scatter_mean", ops.dynamic_scatter_mean,
             c + [uniq.numel()], d + [uniq.numel()], results)
    occupied = int(uniq.numel())

    # sparse convs on those voxels, 16 channels
    rs = np.random.RandomState(SEED + 1)
    valid = num_points > 0
    feats = torch.from_numpy(rs.randn(OPS_MAX_VOXELS, OPS_CHANNELS).astype(
        np.float32)) * valid[:, None]
    w_sub, w_str = (
        (rs.randn(27, OPS_CHANNELS, OPS_CHANNELS) / np.sqrt(
            27 * OPS_CHANNELS)).astype(np.float32) for _ in range(2))
    bias = rs.randn(OPS_CHANNELS).astype(np.float32)
    shape = tuple(int(v) for v in grid.flip(0))             # (z, y, x)
    c, d = both(feats, coords, valid, w_sub, bias)
    op_check("submanifold_conv3d", ops.submanifold_conv3d, c, d, results)
    c, d = both(feats, coords, valid, w_str)
    strided, strided_dev = op_check(
        "sparse_conv3d", lambda f, co, v, w: ops.sparse_conv3d(
            f, co, v, w, stride=2, padding=1, spatial_shape=shape), c, d,
        results)
    op_check("sparse_maxpool3d", lambda f, co, v: ops.sparse_maxpool3d(
        f, co, v, 2), c[:3], d[:3], results)
    pooled = ops.sparse_maxpool3d(*c[:3], 8)
    pooled_dev = ops.sparse_maxpool3d(*d[:3], 8)
    dense_shape = tuple((s - 1) // 8 + 1 for s in shape)
    op_check("to_dense", lambda f, co, v: ops.to_dense(f, co, v, dense_shape),
             list(pooled), list(pooled_dev), results)
    ranks = torch.where(valid, coords[:, 1].long() * shape[2]
                        + coords[:, 2].long(), -1)
    c, d = both(feats, ranks)
    op_check("bev_pool", ops.bev_pool, c + [shape[1] * shape[2]],
             d + [shape[1] * shape[2]], results)

    # the flagship's SA1 shape at OPS_CROPS crops of 128 points, on a grid
    # of 1/8 m: squared distances are exact on both sides, so ties and the
    # radius test decide alike
    crops = np.round(rs.randn(OPS_CROPS, 128, 3) * 0.6 * 8) / 8
    crops = crops.astype(np.float32)
    feats64 = rs.randn(OPS_CROPS, 128, 64).astype(np.float32)
    c, d = both(crops)
    idx, idx_dev = op_check(
        "query_ball_point", lambda x: ops.query_ball_point(
            OPS_RADIUS, 32, x, x), c, d, results)
    c, d = both(feats64, idx)
    c[1], d[1] = idx, idx_dev
    op_check("group_points", ops.group_points, c, d, results)
    c, d = both(crops, np.ascontiguousarray(crops[:, :64]))
    (dist, nn), (dist_dev, nn_dev) = op_check("three_nn", ops.three_nn, c, d,
                                              results)
    inv_d = 1.0 / (dist * dist + 1e-8)
    weight = inv_d / inv_d.sum(-1, keepdim=True)
    feats128 = rs.randn(OPS_CROPS, 64, 128).astype(np.float32)
    c, d = both(feats128, nn, weight)
    c[1], d[1], d[2] = nn, nn_dev, weight.to(dev)
    op_check("three_interpolate", ops.three_interpolate, c, d, results)

    # the shape loss's shape: 2 x 256 crops of 128 predicted points against
    # 2048-point dense targets
    x = (np.round(rs.randn(2 * OPS_CROPS, 128, 3) * 8) / 8).astype(np.float32)
    y = (np.round(rs.randn(2 * OPS_CROPS, 2048, 3) * 8) / 8).astype(np.float32)
    c, d = both(x, y)
    op_check("chamfer_distance", ops.chamfer_distance, c, d, results)

    # Boxes3D at 512 boxes
    boxes = np.concatenate([rs.uniform(-50, 50, (512, 2)),
                            rs.uniform(-2, 0, (512, 1)),
                            rs.uniform(1, 5, (512, 3)),
                            rs.uniform(-np.pi, np.pi, (512, 1))], 1)
    boxes[256:, :2] = boxes[:256, :2] + rs.randn(256, 2)   # overlaps
    scores = rs.rand(512).astype(np.float32)
    c, d = both(boxes.astype(np.float32), scores)
    op_check("Boxes3D.iou_bev", lambda b: ops.Boxes3D(b).iou_bev(
        ops.Boxes3D(b)), c[:1], d[:1], results)
    op_check("Boxes3D.iou_3d", lambda b: ops.Boxes3D(b).iou_3d(
        ops.Boxes3D(b)), c[:1], d[:1], results)
    op_check("Boxes3D.nms", lambda b, s: ops.Boxes3D(b).nms(s, 0.5), c, d,
             results)

    summary = dict(points=OPS_POINTS, occupied_voxels=occupied,
                   kept_voxels=int(num_voxels),
                   full_voxels=int((num_points == OPS_MAX_PTS).sum()),
                   strided_sites=int(strided[2].sum()), ops=results)
    print(f"[reference] ops on {card} against the CPU (ms on the card): "
          f"{OPS_POINTS} points, {occupied} occupied voxels, "
          f"{int(num_voxels)} kept, {summary['full_voxels']} full, "
          f"{summary['strided_sites']} strided sites; "
          + ", ".join(f"{k} {v['ms']:.3f}" for k, v in results.items()),
          flush=True)
    return summary


def phase_reference(card: str):
    """Phase 14: the reference-checkpoint path and the rest of the op
    library. Returns (the path's launches, a summary)."""
    import shutil
    import torch
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_reference")
    os.makedirs(work, exist_ok=True)
    every = zero_counters()
    try:
        flagship = reference_flagship(card, every, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {name: fn.launches for name, fn in every.items()}
    torch.cuda.empty_cache()
    deit = reference_deit(card)
    torch.cuda.empty_cache()
    op_summary = reference_ops(card)
    torch.cuda.empty_cache()
    summary = dict(flagship=flagship, deit=deit, ops=op_summary,
                   seconds=time.perf_counter() - t_phase)
    print(f"[reference] path launches "
          f"{ {k: v for k, v in launches.items() if v} }; phase took "
          f"{summary['seconds']:.1f} s", flush=True)
    return launches, summary


# ---- phase 15: multi-GPU on one card -------------------------------------------

def _dp_trainer(model, work_dir, loader, val_loader):
    from point_cloud_reid_tpu_torch.tools.profile_train import LOSSES
    from point_cloud_reid_tpu_torch.train import Trainer
    from point_cloud_reid_tpu_torch.utils.logging import MetricLogger
    runtime = dict(work_dir=work_dir, seed=SEED, max_epochs=1,
                   eval_interval=0, checkpoint_interval=0, log_interval=1,
                   losses_to_use=LOSSES, alpha={}, triplet_margin=0.2)
    return Trainer(model, loader, val_loader, runtime,
                   logger=MetricLogger(work_dir, quiet=True))


def dp_run(work_dir: str, rank: int = 0, world: int = 1) -> dict:
    """DP_STEPS flagship steps through Trainer.fit (knobs on) on the global
    batches of DP_PAIRS x world pairs, this process's shard of each, then
    the eval of the final checkpoint in a fresh model: the step logs and
    ms, the launches, the eval metrics and its pair count. The same code
    serves one process and each of the ranks."""
    import torch
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.tools.profile_train import (
        flagship_train_cfg)
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig,
                                                  SyntheticPairLoader,
                                                  TrainState, loop)
    every = zero_counters()
    pairs = DP_PAIRS * DP_RANKS

    def loader(n, seed):
        return SyntheticPairLoader(pairs, n, num_points=128, seed=seed,
                                   shard_id=rank, num_shards=world)

    def model():
        return build_model(flagship_train_cfg(True), device=DEVICE,
                           generator=torch.Generator().manual_seed(SEED))

    net = model()
    init = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    trainer = _dp_trainer(net, work_dir, loader(DP_STEPS, SEED),
                          loader(DP_EVAL_BATCHES, SEED + 1))
    state = TrainState.create(net, ScheduleConfig(max_epochs=1), DP_STEPS)
    times, logs, step, stats1 = [], [], trainer.train_step, {}

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        logs.append({k: float(v) for k, v in out[1].items()})
        if not stats1:
            stats1.update({k: v.detach().cpu().clone() for k, v in
                           net.state_dict().items() if "running_" in k})
        return out
    trainer.train_step = timed_step
    state = trainer.fit(state)
    trained = {k: every[k].launches for k in ("knn", "linear_attention")}
    lr_spent = sum(state.optimizer.lr_fn(i) for i in range(DP_STEPS))

    # the eval of the written checkpoint, in a fresh model
    net = model()
    evaluator = _dp_trainer(net, None, None, loader(DP_EVAL_BATCHES,
                                                    SEED + 1))
    fresh = TrainState.create(net, ScheduleConfig(max_epochs=1), 1)
    evaluator.load_weights(fresh, os.path.join(work_dir, "ckpt_final.pt"))
    seen = []
    gather = loop.allgather_results

    def counted(results):
        out = gather(results)
        seen.append(len(out["val_match_gt"]))
        return out
    loop.allgather_results = counted
    sa0 = every["fused_sa_convmax"].launches
    rows0 = every["fused_sa_convmax/two_buffers"].launches
    try:
        metrics = evaluator.evaluate(fresh)
    finally:
        loop.allgather_results = gather
    trained["fused_sa_convmax"] = every["fused_sa_convmax"].launches - sa0
    trained["fused_sa_convmax/two_buffers"] = every[
        "fused_sa_convmax/two_buffers"].launches - rows0
    return dict(step_ms=times, launches=trained, lr_spent=lr_spent,
                stats1=stats1, init=init, logs=logs,
                metrics={k: v for k, v in metrics.items()
                         if not isinstance(v, dict)}, eval_pairs=seen[0],
                state={k: v.detach().cpu() for k, v in
                       state.model.state_dict().items()})


def dp_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of phase 15 (a): join the gloo group through the FileStore
    at `store`, run dp_run on this rank's shards, save what it returns to
    out_dir/rank{rank}.pt."""
    import datetime

    import torch
    from point_cloud_reid_tpu_torch.parallel import init_distributed
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = init_distributed(backend="gloo", init_method="file://" + store,
                            world_size=world, rank=rank, device="cuda",
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT))
    out = dp_run(os.path.join(out_dir, "fit"), rank, world)
    out["info"] = info
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def dp_gaps(run: dict, one: dict) -> dict:
    """How far a data-parallel dp_run lies from one process's: the running
    statistics after step 1 (stat1) and after the last step (var, mean),
    as max |diff| over max(1, |one process|); over every weight but the
    SA convs' biases, the updates' gap (|run's update - one process's| /
    |one process's update|, the 2-norms over all entries), the entries off
    by more than lr spent / 10 (far of entries), the largest entry gap
    (weight, of max(1, |w|)) and the tensors that hold it (worst); the SA
    convs' biases' max |diff| (sa_bias); each step's reid_loss gap, rel."""
    def gap(a, want):
        return (a.double() - want.double()).abs().max().item() / max(
            1.0, want.abs().max().item())
    out = dict(stat1=0.0, var=0.0, mean=0.0, sa_bias=0.0, far=0, entries=0)
    errs, upd = {}, [0.0, 0.0]
    for k, want in one["state"].items():
        if not want.is_floating_point():
            continue
        a = run["state"][k]
        if "running_" in k:
            out["stat1"] = max(out["stat1"], gap(run["stats1"][k],
                                                 one["stats1"][k]))
            key = "var" if k.endswith("running_var") else "mean"
            out[key] = max(out[key], gap(a, want))
            continue
        diff = (a.double() - want.double()).abs()
        if "mlp_convs" in k and k.endswith(".bias"):
            out["sa_bias"] = max(out["sa_bias"], diff.max().item())
            continue
        errs[k] = gap(a, want)
        step = want.double() - one["init"][k].double()
        upd[0] += float((diff ** 2).sum())
        upd[1] += float((step ** 2).sum())
        out["far"] += int((diff > one["lr_spent"] / 10).sum())
        out["entries"] += a.numel()
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    out.update(update_gap=(upd[0] / upd[1]) ** 0.5, weight=worst[0][1],
               worst=[k for k, _ in worst],
               losses=[abs(a["reid_loss"] - b["reid_loss"])
                       / abs(b["reid_loss"])
                       for a, b in zip(run["logs"], one["logs"])])
    return out


def multi_gpu_ranks(card: str) -> dict:
    """Phase 15 (a): two gloo ranks on cuda:0 against one process."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp
    from point_cloud_reid_tpu_torch.tools.profile_train import LOSSES
    one_dir = os.path.join(DP_WORK, "one")
    one = dp_run(one_dir)
    # the ranks share the card with this process: give its cache back
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join(DP_WORK, "ranks")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(dp_rank, args=(DP_RANKS,
                                                os.path.join(tmp, "store"),
                                                out_dir),
                                 nprocs=DP_RANKS, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + 2 * DP_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise RuntimeError(f"the {DP_RANKS} ranks did not finish "
                                   f"in {2 * DP_TIMEOUT} s")
        ranks_s = time.perf_counter() - t0
    got = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                      weights_only=False) for r in range(DP_RANKS)]
    fit_dir = os.path.join(out_dir, "fit")
    files = sorted(os.listdir(fit_dir))
    with open(os.path.join(fit_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(one_dir, "metrics.jsonl")) as f:
        one_records = [json.loads(line) for line in f]
    # rank 0 alone wrote: one record a step and the epoch's, one checkpoint
    if not (files == sorted(os.listdir(one_dir))
            and "ckpt_final.pt" in files
            and len(records) == len(one_records) == DP_STEPS + 1):
        raise RuntimeError(f"the ranks wrote {files} and {len(records)} "
                           f"records; one process {len(one_records)}")
    rel = train_rel(records[0], one_records[0])
    for k, want in one["state"].items():
        if not torch.equal(got[0]["state"][k], got[1]["state"][k]):
            raise RuntimeError(f"the ranks hold different {k}")
    gaps = dp_gaps(got[0], one)
    b_tol = 2 * one["lr_spent"]
    m_err = max(abs(got[0]["metrics"][k] - v) for k, v in
                one["metrics"].items())
    launches = [g["launches"] for g in got]
    summary = dict(
        step1_rel=rel, gaps=gaps, sa_bias_tol=b_tol, eval_err=m_err,
        eval_pairs=[g["eval_pairs"] for g in got],
        one_eval_pairs=one["eval_pairs"], launches=launches,
        one_launches=one["launches"], files=files,
        step_ms=got[0]["step_ms"], one_step_ms=one["step_ms"],
        median_step_ms=float(np.median(got[0]["step_ms"][1:])),
        one_median_step_ms=float(np.median(one["step_ms"][1:])),
        ranks_s=ranks_s, info=[g["info"] for g in got])
    print(f"[multi-gpu:a] {DP_RANKS} gloo ranks on cuda:0, {DP_PAIRS} pairs "
          f"a rank, {DP_STEPS} steps (losses {sorted(LOSSES)}), against one "
          f"process on the same {DP_PAIRS * DP_RANKS}-pair batches: step 1 "
          f"rel {rel} (tol {TRAIN_TOL:g}); running statistics after step "
          f"1 {gaps['stat1']:.3e} (tol {DP_STAT_TOL:g}); after step "
          f"{DP_STEPS} the updates' gap {gaps['update_gap']:.3e} (tol "
          f"{DP_UPDATE_TOL:g}), {gaps['far']} of {gaps['entries']} weight "
          f"entries off by more than lr spent / 10, the largest "
          f"{gaps['weight']:.3e} of max(1, |w|) in {gaps['worst']}, the SA "
          f"convs' biases {gaps['sa_bias']:.3e} (tol {b_tol:.3e}, 2 x lr "
          f"spent), running variances {gaps['var']:.3e} (tol "
          f"{DP_VAR_TOL:g}), running means {gaps['mean']:.3e}, losses of "
          f"steps 1-{DP_STEPS} {[f'{x:.1e}' for x in gaps['losses']]} rel; "
          f"eval of the checkpoint {m_err:.3e} "
          f"(tol {EVAL_TOL:g}), pairs {summary['eval_pairs']} against "
          f"{one['eval_pairs']}; launches per rank {launches} (one process "
          f"{one['launches']}); step ms ranks {summary['median_step_ms']:.1f}"
          f" (all {[round(x, 1) for x in got[0]['step_ms']]}) against one "
          f"process {summary['one_median_step_ms']:.1f} (all "
          f"{[round(x, 1) for x in one['step_ms']]}); the ranks took "
          f"{ranks_s:.1f} s, start-up included, on {card}", flush=True)
    want_launch = dict(knn=3 * DP_STEPS, linear_attention=4 * DP_STEPS)
    if not (all(v <= TRAIN_TOL for v in rel.values())
            and gaps["stat1"] <= DP_STAT_TOL
            and gaps["update_gap"] <= DP_UPDATE_TOL
            and gaps["sa_bias"] <= b_tol and gaps["var"] <= DP_VAR_TOL
            and m_err <= EVAL_TOL
            and all(g["eval_pairs"] == one["eval_pairs"] for g in got)
            and all(all(lc[k] == n for k, n in want_launch.items())
                    and lc["fused_sa_convmax"] == 3 * DP_EVAL_BATCHES
                    for lc in launches)):
        raise RuntimeError("the two ranks' training or eval is not the one "
                           "process's")
    shutil.rmtree(DP_WORK, ignore_errors=True)
    return summary


def multi_gpu_torchrun(card: str) -> dict:
    """Phase 15 (b): tools/train.py under torchrun, one NCCL rank, one
    epoch on phase 8's store."""
    import shutil
    import subprocess
    root = os.path.join(DATA_WORK, "store")
    work = os.path.join(DATA_WORK, "torchrun")
    sets = [a for knob in KNOBS for a in ("--set", knob)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m",
           "point_cloud_reid_tpu_torch.tools.train", FLAGSHIP, "--root", root,
           "--epochs", "1", "--work-dir", work, *sets, "--set",
           "runtime.log_interval=1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=DP_TIMEOUT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun tools.train exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    with open(os.path.join(work, "config.json")) as f:
        group = json.load(f)["process_group"]
    with open(os.path.join(work, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if r["kind"] == "train"
             and "epoch_time_s" not in r]
    walls = [r["wall_s"] for r in steps]
    step_ms = [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    metrics = json.loads(proc.stdout[proc.stdout.index("{"):])
    summary = dict(process_group=group, steps=len(steps), seconds=seconds,
                   step_ms=step_ms,
                   median_step_ms=float(np.median(step_ms[1:])),
                   phase8_step_and_wait_ms=DATA_MS.get("step", np.nan)
                   + DATA_MS.get("wait", np.nan),
                   val_match_acc=metrics["val_match_acc"])
    print(f"[multi-gpu:b] torchrun --standalone --nproc_per_node 1 "
          f"tools.train on phase 8's store: process group {group}; "
          f"{len(steps)} steps of {DATA_PAIRS} pairs, ms between steps (the "
          f"log's clock, loader waits included) "
          f"{[round(x, 1) for x in step_ms]} against phase 8's step + wait "
          f"{summary['phase8_step_and_wait_ms']:.1f}; val_match_acc "
          f"{metrics['val_match_acc']:.4f}; {seconds:.1f} s in all on "
          f"{card}", flush=True)
    shutil.rmtree(DATA_WORK, ignore_errors=True)
    if not (group == dict(backend="nccl", world=1, rank=0)
            and len(steps) == STORE_STEPS
            and all(np.isfinite(r["reid_loss"]) for r in steps)):
        raise RuntimeError(f"the torchrun run logged {group} and {steps}")
    return summary


@contextlib.contextmanager
def uncounted():
    """Kernel launches inside the block (a check's reference scoring) leave
    every count as it was."""
    fns = {id(c.fn if hasattr(c, "fn") else c): (c.fn if hasattr(c, "fn")
                                                 else c)
           for c in all_counters().values()}
    names = ("launches", "bf16_launches", "f32_launches", "tier_launches",
             "bf16_tiers", "shape_launches", "padded_launches", "f32_layouts")
    saved = {k: {n: copy.deepcopy(getattr(f, n)) for n in names
                 if hasattr(f, n)} for k, f in fns.items()}
    try:
        yield
    finally:
        for k, f in fns.items():
            for n, v in saved[k].items():
                setattr(f, n, v)


def _mesh_scene(model, image: bool, sparse: str, mesh):
    """The serving (or image) scene behind TrackingManager.step with a
    scorer on `mesh` (None: unsharded); with a mesh each frame with tracks
    is checked against the unsharded scoring of its own inputs. Returns
    (step ms, the worst logit gap, the worst embed gap, frames checked)."""
    import torch
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.scenes import (bench_scene,
                                                         image_scene)
    from point_cloud_reid_tpu_torch.tracking import TrackingManager
    scorer = PairScorer(model, image_mode=image, mesh=mesh)
    if image:
        mgr = TrackingManager(scorer, match_threshold=1.0, seed=SEED,
                              sparse_scoring=sparse)
        frames = image_scene(IMG_OBJ, IMG_FRAMES, SEED)
    else:
        mgr = TrackingManager(scorer, subsample_number=128,
                              match_threshold=1.0, seed=SEED,
                              sparse_scoring=sparse)
        frames = bench_scene(N_OBJ, PTS_PER_OBJ, FRAMES, SEED)
    times, gap, e_gap, checked = [], 0.0, 0.0, 0
    for frame in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.step(*frame)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        rec = scorer.last_frame
        if mesh is None or rec is None:
            continue
        with torch.no_grad(), uncounted():
            if image:
                want = mg.image_grid_logits(model, rec["h_t"], rec["h_d"])
            else:
                want = mg.grid_logits(model, rec["h_t"], rec["xyz_t"],
                                      rec["h_d"], rec["xyz_d"])
                # the crops are the embed's xyz: the unsharded embed of them
                _, h_d = model.embed(rec["xyz_d"])
                e_gap = max(e_gap, ((h_d.float() - rec["h_d"].float()).abs()
                                    .max().item()) / max(
                    1.0, h_d.float().abs().max().item()))
            if rec["pairs"] is not None:
                pt, pd = rec["pairs"]
                want = want[pt.long(), pd.long()]
        got = rec["logits"].float()
        gap = max(gap, (got - want.float()).abs().max().item() / max(
            1.0, want.float().abs().max().item()))
        checked += 1
    return times, gap, e_gap, checked


def multi_gpu_mesh(card: str) -> dict:
    """Phase 15 (c): a two-entry mesh on cuda:0 behind TrackingManager."""
    import torch
    from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.parallel import make_mesh
    out = {}
    point = {dt: build_model(point_transformer_point_cat(), device=DEVICE,
                             generator=torch.Generator().manual_seed(SEED),
                             dtype=dt)
             for dt in (torch.float32, torch.bfloat16)}
    cases = [(f"point/{name}/{sparse}", m, False, sparse)
             for name, m in (("float32", point[torch.float32]),
                             ("bf16", point[torch.bfloat16]))
             for sparse in ("never", "auto")]
    image = image_model("deit-tiny-no-pt")
    cases += [(f"image/float32/{sparse}", image, True, sparse)
              for sparse in ("never", "always")]
    for label, model, is_image, sparse in cases:
        mesh = make_mesh(data=MESH_ENTRIES,
                         devices=[torch.device("cuda", 0)] * MESH_ENTRIES)
        ms, gap, e_gap, checked = _mesh_scene(model, is_image, sparse, mesh)
        plain_ms, *_ = _mesh_scene(model, is_image, sparse, None)
        tol = BF16_TOL if "bf16" in label else MATCH_TOL
        out[label] = dict(
            max_rel_gap=gap, embed_rel_gap=e_gap, tol=tol, frames=checked,
            median_step_ms=float(np.median(ms[3:])),
            unsharded_median_step_ms=float(np.median(plain_ms[3:])),
            launches_per_entry=mesh.launches)
        print(f"[multi-gpu:c] {label}: {MESH_ENTRIES}-entry mesh on cuda:0, "
              f"{checked} frames; logits against unsharded scoring of the "
              f"same inputs {gap:.3e}, embed {e_gap:.3e} (tol {tol:g}); "
              f"median step {out[label]['median_step_ms']:.2f} ms against "
              f"unsharded {out[label]['unsharded_median_step_ms']:.2f} ms; "
              f"launches per entry {mesh.launches} on {card}", flush=True)
        if not (checked == FRAMES - 1 and gap <= tol and e_gap <= tol
                and all(e["match"] > 0 and (is_image or e["sa"] > 0)
                        for e in mesh.launches)):
            raise RuntimeError(f"{label}: the sharded frames are not the "
                               "unsharded ones, or an entry ran no kernel")
    del point, image
    torch.cuda.empty_cache()
    return out


def multi_gpu_knobs(card: str, every: dict) -> dict:
    """Phase 15 (d): fused_train and remat_stages steps of the flagship."""
    import torch
    from point_cloud_reid_tpu_torch.tools.profile_train import (
        flagship_train_cfg)
    pairs = TRAIN_MS["pairs"]
    out = {}
    for label, knobs, tol in (
            ("fused_train", dict(fused_train=True), TRAIN_TOL),
            ("remat_stages=[0,1,2]", dict(remat_stages=[0, 1, 2]),
             REMAT_TOL)):
        cfg = flagship_train_cfg(True)
        cfg["backbone"] = dict(cfg["backbone"], **knobs)
        knn0 = every["knn"].launches
        torch.cuda.empty_cache()
        logs, times, changed, peak = train_flagship(True, pairs, 3, None,
                                                    cfg=cfg)
        check_trained(label, logs, changed,
                      ("running_var", "q_proj.weight", "mlp_convs"))
        rel = train_rel(logs[0], TRAIN_MS["step1"])
        out[label] = dict(step1_rel=rel, step_ms=times,
                          median_step_ms=float(np.median(times[1:])),
                          peak_gib=peak / 2 ** 30,
                          knn_launches=every["knn"].launches - knn0)
        print(f"[multi-gpu:d] {label}: 3 steps of {pairs} pairs, step ms "
              f"{[round(x, 1) for x in times]} against phase 4's median "
              f"{TRAIN_MS['median']:.1f}; peak {peak / 2 ** 30:.2f} GiB "
              f"against {TRAIN_MS['peak_gib']:.2f}; step 1 rel to phase 4 "
              f"{rel} (tol {tol:g}); kNN launches "
              f"{out[label]['knn_launches']} on {card}", flush=True)
        if not all(v <= tol for v in rel.values()):
            raise RuntimeError(f"{label}: step 1 is not phase 4's")
    return out


def phase_multi_gpu(card: str):
    """Phase 15: multi-GPU on one card, with every count at 0. Returns (the
    path's launches, the ranks' included, and a summary)."""
    t_phase = time.perf_counter()
    every = zero_counters()
    summary = dict(ranks=multi_gpu_ranks(card))
    summary["torchrun"] = multi_gpu_torchrun(card)
    summary["mesh"] = multi_gpu_mesh(card)
    summary["knobs"] = multi_gpu_knobs(card, every)
    launches = {name: fn.launches for name, fn in every.items()}
    # the ranks launched in their own processes
    for rank in summary["ranks"]["launches"]:
        for name, n in rank.items():
            launches[name] += n
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"[multi-gpu] path launches "
          f"{ {k: v for k, v in launches.items() if v} }; phase took "
          f"{summary['seconds']:.1f} s", flush=True)
    return launches, summary


# ---- phase 16: the widths -------------------------------------------------------

def width_case(head: str, C: int, H: int, N: int, dtype, nt: int, nd: int,
               P: int, gen) -> dict:
    """The match kernels at one shape (phase 16's in the padded layout): an
    nt x nd grid and a P-pair list against the plain version at the true
    width (MATCH_TOL; bf16: BF16_TOL), pairs equal to their grid cells bit
    for bit, one launch of the plan's tier (in the padded layout where the
    wrapper takes it); ms, plain ms, the bound at the true C and at the
    kernel's W, the tier. Returns the grid's and the pairs' measurements."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.ab_match import inputs
    from point_cloud_reid_tpu_torch.tools.timing import time_ms
    bf16 = dtype == torch.bfloat16
    t, d, w1, w2, H = inputs(head, nt, nd, N, C, H, seed=C + N, device=DEVICE,
                             dtype=dtype)
    point = head == "point"
    grid_fn = mg.fused_match_grid if point else mg.fused_image_match_grid
    pair_fn = mg.fused_match_pairs if point else mg.fused_image_match_pairs
    how = mg.plan(N, C, H, pos=point, dtype=dtype)
    W = mg.kernel_width(C, how.tier)
    tol = BF16_TOL if bf16 else MATCH_TOL
    weights = list(w1.values()) + list(w2.values())
    ti = torch.arange(nt, device=DEVICE).repeat_interleave(nd)
    di = torch.arange(nd, device=DEVICE).repeat(nt)
    key = mg.tier_key(how.tier, bf16)
    padded = W != C or (how.tier == mg.ROWS
                        and mg.rows_padded(C, H, 5 if point else 4))
    before = (grid_fn.tier_launches[key], grid_fn.padded_launches[key])
    grid = grid_fn(t, d, w1, w2, H)
    if (grid_fn.tier_launches[key], grid_fn.padded_launches[key]) != (
            before[0] + 1, before[1] + padded):
        raise RuntimeError(f"{head} C={C} nhead={H}: not one {key} launch "
                           f"(padded: {padded})")
    want = mg.match_pooled_reference(t, d, w1, w2, H, ti, di).reshape(
        nt, nd, -1)
    torch.cuda.synchronize()
    g_err, g_rel = rel_err(grid.float(), want.float())
    del want
    g_ms = time_ms(lambda: grid_fn(t, d, w1, w2, H), 2, warmup=1)
    g_plain = time_ms(lambda: mg.match_pooled_reference(t, d, w1, w2, H, ti,
                                                        di), 1, warmup=0)
    t_idx = torch.randint(0, nt, (P,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    d_idx = torch.randint(0, nd, (P,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    pairs = pair_fn(t, d, w1, w2, H, t_idx, d_idx)
    want = mg.match_pooled_reference(t, d, w1, w2, H, t_idx, d_idx)
    torch.cuda.synchronize()
    p_err, p_rel = rel_err(pairs.float(), want.float())
    same = torch.equal(pairs, grid[t_idx.long(), d_idx.long()])
    p_ms = time_ms(lambda: pair_fn(t, d, w1, w2, H, t_idx, d_idx), 3,
                   warmup=1)
    p_plain = time_ms(lambda: mg.match_pooled_reference(t, d, w1, w2, H,
                                                        t_idx, d_idx), 1,
                      warmup=0)

    def bound(pairs_n, width, nbyte):
        flops = 80.0 * pairs_n * N * width * width
        return (bf16_bound(flops, nbyte) if bf16
                else match_bound(pairs_n, N, width, nbyte)[:2])
    g_nbyte = nbytes(*t, *d, *weights, grid)
    p_nbyte = nbytes(*t, *d, *weights, t_idx, d_idx, pairs)
    g_bound, g_pad = bound(nt * nd, C, g_nbyte), bound(nt * nd, W, g_nbyte)
    p_bound, p_pad = bound(P, C, p_nbyte), bound(P, W, p_nbyte)
    tier = mg.TIER_NAMES[how.tier]
    usage = (rows_kernel_usage(W, 1 if padded else H, bf16, pad=padded)
             if how.tier == mg.ROWS else None)
    print(f"[widths:kernels] {head} C={C} nhead={H} N={N} "
          f"{'bf16' if bf16 else 'float32'}: tier {tier} at W={W} "
          f"({'padded layout' if padded else 'exact width'}), {how.smem} "
          f"shared bytes a block; grid {nt}x{nd} "
          f"max_abs_err={g_err:.3e} rel={g_rel:.3e}, pairs P={P} "
          f"max_abs_err={p_err:.3e} rel={p_rel:.3e} (tol {tol:g}), pairs "
          f"equal to their grid cells: {same}; grid {g_ms:.3f} ms (plain "
          f"{g_plain:.3f}, bound {g_bound[0]:.4f} {g_bound[1]} at C, "
          f"{g_pad[0]:.4f} at W, {g_ms / g_bound[0]:.2f}x the bound), pairs "
          f"{p_ms:.3f} ms (plain {p_plain:.3f}, bound {p_bound[0]:.4f} at C, "
          f"{p_pad[0]:.4f} at W, {p_ms / p_bound[0]:.2f}x the bound)"
          + (f"; ptxas {usage}" if usage else ""), flush=True)
    if not (g_rel <= tol and p_rel <= tol and same):
        raise RuntimeError(f"the {tier} tier disagrees at {head} "
                           f"C={C} H={H} N={N}: {g_rel}, {p_rel}, {same}")
    shape = dict(head=head, C=C, nhead=H, N=N, W=W, tier=tier,
                 smem_bytes=how.smem, **({"ptxas": usage} if usage else {}))
    return dict(
        grid=dict(shape, grid=f"{nt}x{nd}", max_abs_err=g_err, ms=g_ms,
                  plain_ms=g_plain, bound_ms=g_bound[0], bound_by=g_bound[1],
                  bound_padded_ms=g_pad[0], library_ms=None),
        pairs=dict(shape, P=P, max_abs_err=p_err, ms=p_ms, plain_ms=p_plain,
                   bound_ms=p_bound[0], bound_by=p_bound[1],
                   bound_padded_ms=p_pad[0], library_ms=None))


def width_fps_row() -> dict:
    """FPS over C channels (csrc/fps.cu's channel kernels) at WIDTH_FPS and
    a small and a large cloud: indices equal to the plain loop's; ms,
    device ms, plain ms and bound; the kernels line's row `fps/channels`."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import fps as kf
    from point_cloud_reid_tpu_torch.tools.timing import graph_ms, time_ms
    shapes = {}
    for i, (B, N, npoint, C) in enumerate((WIDTH_FPS, (128, 128, 64, 6),
                                           (4, 20000, 256, 6))):
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + i)
        pts = torch.randn((B, N, C), generator=gen, device=DEVICE)
        start = torch.randint(0, N, (B,), generator=gen, device=DEVICE)
        got = kf.fps(pts, npoint, start)
        want = kf.fps_reference(pts, npoint, start)
        bad = int((got != want).sum().item())
        k_ms = time_ms(lambda: kf.fps(pts, npoint, start), 10)
        d_ms = graph_ms(lambda: kf.fps(pts, npoint, start), 10)
        p_ms = time_ms(lambda: kf.fps_reference(pts, npoint, start), 1,
                       warmup=1)
        # 3 C - 1 flops a distance (C differences, squares, C - 1 sums)
        b_ms, b_by = bound_ms((3.0 * C - 1) * B * npoint * N,
                              nbytes(pts, start) + B * npoint * 8)
        plan = kf.plan(N, C=C)
        shapes[f"B{B}_N{N}_np{npoint}_C{C}"] = dict(
            tier=kf.TIER_NAMES[plan.tier], smem_bytes=plan.smem, ms=k_ms,
            device_ms=d_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            mismatches=bad)
        print(f"[widths:fps] B={B} N={N} npoint={npoint} C={C} (tier "
              f"{kf.TIER_NAMES[plan.tier]}, {plan.smem} shared bytes): "
              f"{bad} indices differ from the plain loop; a call {k_ms:.4f} "
              f"ms, device {d_ms:.5f} ms, plain {p_ms:.3f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})", flush=True)
        if bad:
            raise RuntimeError(f"fps over C={C} channels disagrees")
    head = shapes["B{}_N{}_np{}_C{}".format(*WIDTH_FPS)]
    return dict(name="fps/channels", route="cuda",
                source="point_cloud_reid_tpu_torch/csrc/fps.cu",
                replaces="point_cloud_reid_tpu/ops/pallas/fps.py:58",
                max_abs_err=0.0, **{k: head[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
                library_ms=None, shapes=shapes)


def width_rows() -> list:
    """The kernels-line rows of the padded layout, both dtypes: the point
    head's cluster and rows tiers and the image head's rows tier, grid and
    pairs, each row's numbers its first shape's, every shape listed."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = []
    plans = [("fused_match", "point", tier, shapes)
             for tier, shapes in WIDTH_POINT.items()]
    plans.append(("fused_image_match", "image", "rows", WIDTH_IMAGE))
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        for prefix, head, tier, shapes in plans:
            cases = []
            for i, (C, H, N) in enumerate(shapes):
                if i == 0:
                    nt, nd = (128, 128) if head == "point" else (128, 64)
                else:
                    nt = nd = WIDTH_SMALL if N < 2048 else 8
                cases.append(width_case(head, C, H, N, dtype, nt, nd,
                                        WIDTH_PAIRS if i == 0 else 64, gen))
            src = ("match_grid_pad" if tier == "cluster"
                   else "match_rows_pad") + sfx + ".cu"
            for kind, line in (("grid", "250" if head == "point" else "686"),
                               ("pairs", "355" if head == "point"
                                else "514")):
                first = cases[0][kind]
                rows.append(dict(
                    name=f"{prefix}_{kind}/padded_{tier}{sfx}", route="cuda",
                    source=f"point_cloud_reid_tpu_torch/csrc/{src}",
                    replaces="point_cloud_reid_tpu/ops/pallas/match_grid.py:"
                             + line,
                    **{k: first[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "bound_padded_ms", "library_ms")},
                    shapes=[c[kind] for c in cases]))
    return rows


def width_frame_check(model, rec, label: str) -> dict:
    """One tracker frame against the chain's plain version on its padded
    inputs: the kernel's pooled features again (a comparison launch)
    against match_pooled_reference (MATCH_TOL; bf16: BF16_TOL), the frame's
    logits equal to them through the head bit for bit, and at float32 the
    logits against the model's own plain scoring (FRAME_TOL)."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    image = rec["xyz_t"] is None
    h_t, h_d = rec["h_t"], rec["h_d"]
    nt, nd = h_t.shape[0], h_d.shape[0]
    bf16 = h_t.dtype == torch.bfloat16
    with torch.no_grad():
        if image:
            t, d, w1, w2, H = mg.image_match_factors(model, h_t, h_d)
            grid_fn, pair_fn = (mg.fused_image_match_grid,
                                mg.fused_image_match_pairs)
        else:
            t, d, w1, w2, H = mg.match_factors(model, h_t, rec["xyz_t"], h_d,
                                               rec["xyz_d"])
            grid_fn, pair_fn = mg.fused_match_grid, mg.fused_match_pairs
        if rec["pairs"] is None:
            ti = torch.arange(nt, device=DEVICE).repeat_interleave(nd)
            di = torch.arange(nd, device=DEVICE).repeat(nt)
            pooled = grid_fn(t, d, w1, w2, H).reshape(nt * nd, -1)
        else:
            ti, di = rec["pairs"]
            pooled = pair_fn(t, d, w1, w2, H, ti, di)
        plain = mg.match_pooled_reference(t, d, w1, w2, H, ti, di)
        logits = model.match_head(pooled)[:, 0]
        same = torch.equal(logits, rec["logits"].reshape(-1))
        err, rel = rel_err(pooled.float(), plain.float())
        own_err = own_bound = 0.0
        if not bf16:
            if image:
                own = model.match_logits_grid(h_t, h_d).reshape(-1)
                if rec["pairs"] is not None:
                    own = own.reshape(nt, nd)[ti.long(), di.long()]
            else:
                own = model_plain_logits(model, rec).reshape(-1)
            own_err = (rec["logits"].reshape(-1) - own).abs().max().item()
            own_bound = FRAME_TOL * (1.0 + own.abs().max().item())
    tol = BF16_TOL if bf16 else MATCH_TOL
    ok = rel <= tol and same and own_err <= own_bound and bool(
        torch.isfinite(rec["logits"]).all())
    if not ok:
        raise RuntimeError(f"{label}: pooled rel {rel} (tol {tol}), logits "
                           f"through the head equal {same}, against the "
                           f"model's plain scoring {own_err} (bound "
                           f"{own_bound})")
    return dict(rel=rel, own_err=own_err)


def width_cli(card: str, name: str, bf16: bool, sparse: str,
              every: dict, want=None) -> dict:
    """tools/track.py serves configs/widths.py's `name` through its --set
    lines (WIDTH_FRAMES frames of a synthetic scene, 16 objects; sparse
    'never' or 'always'; --bf16): its launches by tier, then every frame
    against the chain's plain version (width_frame_check). `want`: the
    counters that must have launched (by default any padded one)."""
    import contextlib
    import io
    import shutil
    from point_cloud_reid_tpu_torch.configs.widths import WIDTHS
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.tools import track
    leaf, sets = WIDTHS[name]
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_widths")
    shutil.rmtree(work, ignore_errors=True)
    frames, scorers = [], []

    def kept(self, value):      # every frame the scorer scores, kept
        self.__dict__["_kept_frame"] = value
        if value is not None:
            frames.append(value)
        elif self not in scorers:
            scorers.append(self)
    before = {k: fn.launches for k, fn in every.items()}
    out = io.StringIO()
    t0 = time.perf_counter()
    PairScorer.last_frame = property(
        lambda self: self.__dict__.get("_kept_frame"), kept)
    try:
        with contextlib.redirect_stdout(out):
            track.main([leaf, "--scenes", "1", "--frames", str(WIDTH_FRAMES),
                        "--objects", "16", "--sparse", sparse,
                        "--match-threshold", "1.0", "--work-dir", work]
                       + (["--bf16"] if bf16 else [])
                       + [a for x in sets for a in ("--set", x)])
    finally:
        del PairScorer.last_frame
    seconds = time.perf_counter() - t0
    used = {k: fn.launches - before[k] for k, fn in every.items()}
    headline = json.loads(out.getvalue().strip().splitlines()[-1])
    label = f"{name}{' --bf16' if bf16 else ''} --sparse {sparse}"
    checks = [width_frame_check(scorers[-1].model, rec, label)
              for rec in frames]
    padded = {k: v for k, v in used.items()
              if v and ("/padded_" in k if want is None else k in want)}
    print(f"[widths:cli] tools/track.py {leaf} ({label}): {len(frames)} "
          f"frames scored, each against the plain chain: pooled rel <= "
          f"{max(c['rel'] for c in checks):.3e}, logits against the model's "
          f"plain scoring <= {max(c['own_err'] for c in checks):.3e}; "
          f"launches by tier {padded}; {seconds:.1f} s, headline "
          f"{json.dumps(headline)} on {card}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    if (not frames or not padded or headline.get("frames") != WIDTH_FRAMES
            or (want is not None and set(padded) != set(want))):
        raise RuntimeError(f"tools/track.py {label}: {len(frames)} frames, "
                           f"padded launches {padded}, {headline}")
    return used


def phase_widths(card: str):
    """Phase 16: the match chain at head widths the kernels' tiles have no
    instantiation for (the padded layout) and FPS over C channels; the
    kernels against their plain versions, then, with every count at 0, the
    three --set models of configs/widths.py through tools/track.py at
    float32 and --bf16, dense ('never') and sparse ('always'), and FPS of
    points with normals through ops.geometry.farthest_point_sample.
    Returns (the kernels-line rows, the path's launches, a summary)."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import fps as kf
    from point_cloud_reid_tpu_torch.ops.geometry import farthest_point_sample
    t_phase = time.perf_counter()
    rows = width_rows() + [width_fps_row()]
    t_kernels = time.perf_counter() - t_phase
    every = zero_counters()
    launches = {k: 0 for k in every}
    for name in ("conv_out96", "conv_out32", "image96"):
        for bf16 in (False, True):
            for sparse in ("never", "always"):
                used = width_cli(card, name, bf16, sparse, every)
                for k, v in used.items():
                    launches[k] += v
                torch.cuda.empty_cache()
    B, N, npoint, C = WIDTH_FPS
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    xyz = torch.randn((B, N, 3), generator=gen, device=DEVICE)
    normals = torch.nn.functional.normalize(
        torch.randn((B, N, 3), generator=gen, device=DEVICE), dim=-1)
    pts = torch.cat([xyz, normals], dim=-1)
    before = every["fps/channels"].launches
    idx = farthest_point_sample(pts, npoint)
    launches["fps/channels"] += every["fps/channels"].launches - before
    launches["fps"] += every["fps/channels"].launches - before
    if not torch.equal(idx, kf.fps_reference(
            pts, npoint, torch.zeros(B, dtype=torch.long, device=DEVICE))):
        raise RuntimeError("FPS of points with normals disagrees")
    seconds = time.perf_counter() - t_phase
    print(f"[widths] path launches "
          f"{ {k: v for k, v in launches.items() if v} }; kernels "
          f"{t_kernels:.1f} s, phase took {seconds:.1f} s", flush=True)
    return rows, launches, dict(seconds=seconds, kernels_seconds=t_kernels)


# ---- phase 17: the last shape gaps ----------------------------------------------

def wide_sa_case(args, dtype, label: str) -> dict:
    """fused_sa_convmax on `args` (a stage of C channels) against its plain
    version (SA_TOL; bf16: BF16_TOL): ms, plain ms, the bound at the true C
    and at the kernel's width, the layout or tier the kernel takes."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    from point_cloud_reid_tpu_torch.tools.timing import time_ms
    bf16 = dtype == torch.bfloat16
    B, N, C = args[0].shape
    S, K = args[2].shape[1:]
    W = sa.run_width(C, bf16)
    got = sa.fused_sa_convmax(*args)
    want = sa.sa_convmax_reference(*args)
    torch.cuda.synchronize()
    err, rel = rel_err(got.float(), want.float())
    del want
    k_ms = time_ms(lambda: sa.fused_sa_convmax(*args), 3)
    p_ms = time_ms(lambda: sa.sa_convmax_reference(*args), 1, warmup=1)
    nbyte = nbytes(*args, got)
    R = B * S * K

    def bound(width):
        flops = 4.0 * R * width * width
        return (bf16_bound(flops, nbyte) if bf16
                else tensor_core_bound(flops, nbyte)[:2])
    b_c, b_w = bound(C), bound(W)
    if bf16:
        how = sa.plan_bf16(W, K, R)
        tier, smem = how.tier, how.smem
    else:
        how = sa.plan_f32(W, K)
        tier, smem = how.layout, how.smem
    tol = BF16_TOL if bf16 else SA_TOL
    ratio = k_ms / b_c[0]
    print(f"[wide:sa] {label} B={B} N={N} S={S} K={K} C={C} "
          f"{'bf16' if bf16 else 'float32'}: {tier} at W={W} ({smem} shared "
          f"bytes a block): max_abs_err={err:.3e} rel={rel:.3e} (tol "
          f"{tol:g}) kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
          f"{b_c[0]:.4f} ms ({b_c[1]}) at C, {b_w[0]:.4f} at W: "
          f"{ratio:.2f}x the bound", flush=True)
    if not rel <= tol:
        raise RuntimeError(f"fused_sa_convmax disagrees at {label}: {rel}")
    return dict(C=C, W=W, B=B, N=N, S=S, K=K, tier=tier, smem_bytes=smem,
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_c[0],
                bound_by=b_c[1], bound_padded_ms=b_w[0], bound_ratio=ratio,
                library_ms=None)


def wide_sa_rows() -> list:
    """The SA kernels past their first widths at both dtypes: WIDE_SA (C =
    48 in the padded layout, 992, 1024, 1,056, 1,536) and the mul16
    model's three stages at B = 128; the kernels-line rows of the wide
    layout, `fused_sa_convmax/wide` (float32) and
    `fused_sa_convmax/wide_bf16`, each row's numbers its C = 2048 stage's,
    every shape listed with the layout or tier it took, and of the bf16
    mma_sync tier, `fused_sa_convmax/mma_sync_bf16`, its numbers C =
    992's."""
    import torch
    from point_cloud_reid_tpu_torch.tools.ab_sa import stage_inputs
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        cases = []
        for C, B, N, S, K in WIDE_SA:
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + C)

            def r(*shape):
                return torch.randn(shape, generator=gen, device=DEVICE)
            idx = torch.randint(0, N, (B, S, K), generator=gen,
                                device=DEVICE, dtype=torch.int32)
            args = (r(B, N, C).to(dtype), r(B, S, C).to(dtype), idx,
                    r(C, C) / C ** 0.5, r(C, C) / C ** 0.5) + tuple(
                        r(C) for _ in range(6))
            cases.append(wide_sa_case(args, dtype, f"random C={C}"))
            del args
        for i, args in enumerate(stage_inputs(128, SEED, DEVICE, dtype,
                                              mul=16)):
            cases.append(wide_sa_case(args, dtype, f"mul16 SA{i + 1}"))
        torch.cuda.empty_cache()
        heads = [("wide", "sa_wide_wg.cuh", cases[-1])]
        if bf16:
            heads.append(("mma_sync", "sa_stage_bf16.cu", next(
                c for c in cases if c["C"] == 992)))
        for tier, src, head in heads:
            if head["tier"] != tier:
                raise RuntimeError(f"fused_sa_convmax at C={head['C']}: "
                                   f"{head['tier']}, not {tier}")
            rows.append(dict(
                name=f"fused_sa_convmax/{tier}" + ("_bf16" if bf16 else ""),
                route="cuda", source="point_cloud_reid_tpu_torch/csrc/" + src,
                replaces="point_cloud_reid_tpu/ops/pallas/sa_stage.py:78",
                **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "bound_padded_ms", "bound_ratio",
                                        "library_ms")},
                shapes=cases if tier == "wide" else [head]))
    return rows


def wide_match_rows() -> list:
    """The match kernels at WIDE_MATCH, both dtypes (width_case): the
    kernels-line rows of the rows tier's wide kernel (point and image,
    grid and pairs, `.../wide`) and of its launches past 8 heads (point,
    `.../many_heads`)."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        for head, C, H, N, nt, nd in WIDE_MATCH:
            case = width_case(head, C, H, N, dtype, nt, nd, WIDTH_PAIRS, gen)
            torch.cuda.empty_cache()
            kind_name = "wide" if C > 128 else "many_heads"
            src = ("match_rows_pad" if C > 128 else "match_rows") + sfx
            prefix = "fused_match" if head == "point" else "fused_image_match"
            for kind, line in (("grid", "250" if head == "point" else "686"),
                               ("pairs", "355" if head == "point"
                                else "514")):
                m = case[kind]
                rows.append(dict(
                    name=f"{prefix}_{kind}/{kind_name}{sfx}", route="cuda",
                    source=f"point_cloud_reid_tpu_torch/csrc/{src}.cu",
                    replaces="point_cloud_reid_tpu/ops/pallas/match_grid.py:"
                             + line,
                    **{k: m[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "bound_padded_ms", "library_ms")},
                    shapes=[m]))
    return rows


def wide_want(name: str, bf16: bool, sparse: str) -> list:
    """The counters a configs/widths.py model of phase 17 must launch
    through tools/track.py: the match kernels' new rows (the wide kernel,
    or past 8 heads), at mul16 the SA kernel's wide layout, at mul6 its row
    tiles (at bf16 the mma_sync tier)."""
    sfx = "_bf16" if bf16 else ""
    if name == "mul16":
        return ["fused_sa_convmax/wide" + sfx]
    if name == "mul6":
        return ["fused_sa_convmax/" + ("mma_sync_bf16" if bf16
                                       else "two_buffers")]
    fn = (("fused_image_match" if name.startswith("image")
           else "fused_match") + ("_grid" if sparse == "never" else "_pairs"))
    return [f"{fn}/{'many_heads' if name == 'heads16' else 'wide'}{sfx}"]


def phase_wide(card: str):
    """Phase 17: the SA kernels past 1024 channels and off the multiples of
    32, the match chain past 128 channels and 8 heads; the kernels against
    their plain versions, then, with every count at 0, the five --set
    models conv_out256, heads16, mul16, mul6 and image256 of configs/widths.py
    through tools/track.py at float32 and --bf16, dense ('never') and
    sparse ('always'), each frame against the chain's plain version.
    Returns (the kernels-line rows, the path's launches, a summary)."""
    import torch
    t_phase = time.perf_counter()
    rows = wide_sa_rows() + wide_match_rows()
    t_kernels = time.perf_counter() - t_phase
    every = zero_counters()
    launches = {k: 0 for k in every}
    runs = {}
    for name in WIDE_MODELS:
        for bf16 in (False, True):
            for sparse in ("never", "always"):
                t0 = time.perf_counter()
                used = width_cli(card, name, bf16, sparse, every,
                                 want=wide_want(name, bf16, sparse))
                runs[f"{name}{' --bf16' if bf16 else ''} {sparse}"] = (
                    time.perf_counter() - t0)
                for k, v in used.items():
                    launches[k] += v
                torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[wide] path launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"[wide] phase 17 took {seconds:.1f} s (kernels {t_kernels:.1f} s,"
          f" tools/track.py runs {seconds - t_kernels:.1f} s)", flush=True)
    return rows, launches, dict(seconds=seconds, kernels_seconds=t_kernels,
                                cli_seconds=runs)


# ---- phase 18: past the wide layouts' first bounds (ROADMAP.md K7) -----------------

def k7_sa_cases() -> dict:
    """The SA kernels at K7_SA, both dtypes (wide_sa_case: the plain
    version, ms, plain ms, the bound and its ratio, the layout), with the
    wide layout's scratch bytes a block and in all. Returns the cases by
    dtype ("float32", "bf16")."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        cases = []
        for C, B, N, S, K in K7_SA:
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + C)

            def r(*shape):
                return torch.randn(shape, generator=gen, device=DEVICE)
            idx = torch.randint(0, N, (B, S, K), generator=gen,
                                device=DEVICE, dtype=torch.int32)
            args = (r(B, N, C).to(dtype), r(B, S, C).to(dtype), idx,
                    r(C, C) / C ** 0.5, r(C, C) / C ** 0.5) + tuple(
                        r(C) for _ in range(6))
            case = wide_sa_case(args, dtype, f"K7 random C={C}")
            del args
            torch.cuda.empty_cache()
            if case["tier"] != sa.WIDE:
                raise RuntimeError(f"fused_sa_convmax at C={C}: "
                                   f"{case['tier']}, not the wide layout")
            stride = sa.wide_scratch_bytes(case["W"], bf16)
            blocks = sa.wide_blocks(B * S, DEVICE)
            case.update(scratch_bytes_per_block=stride,
                        scratch_bytes=stride * blocks, blocks=blocks)
            print(f"[k7:sa] C={C} {'bf16' if bf16 else 'float32'}: scratch "
                  f"{stride} bytes a block x {blocks} blocks = "
                  f"{stride * blocks} bytes", flush=True)
            cases.append(case)
        out["bf16" if bf16 else "float32"] = cases
    return out


def k7_match_rows() -> list:
    """The match kernels at K7_MATCH, both dtypes (width_case: grid and
    pairs against the plain version, pairs equal to their grid cells bit
    for bit, ms, plain ms, the bound and the tier, ptxas's account of the
    wide kernel), with the scratch of the launch (bytes a block, blocks
    under kernels/match_grid.ROWS_SCRATCH_BUDGET, bytes in all); the
    kernels-line rows of the wide kernel past 256 channels (point and
    image, grid and pairs, `.../past_256`) and past 16 heads (point,
    `.../past_16_heads`), each row's numbers its widest shape's."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows, largest = [], (0, None)
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        by_row = {}
        for head, C, H, N, nt, nd in K7_MATCH:
            case = width_case(head, C, H, N, dtype, nt, nd, WIDTH_PAIRS, gen)
            torch.cuda.empty_cache()
            W = case["grid"]["W"]
            stride = mg.rows_scratch_bytes(N, W, 1, dtype)
            for kind, P in (("grid", nt * nd), ("pairs", WIDTH_PAIRS)):
                blocks = mg.rows_blocks(P, case[kind]["smem_bytes"], DEVICE,
                                        stride)
                case[kind].update(scratch_bytes_per_block=stride,
                                  blocks=blocks,
                                  scratch_bytes=stride * blocks)
                print(f"[k7:match] {head} C={C} nhead={H} {kind} {dtype}: "
                      f"scratch {stride} bytes a block x {blocks} blocks = "
                      f"{stride * blocks} bytes", flush=True)
                if stride * blocks > largest[0]:
                    largest = (stride * blocks, f"{head} C={C} nhead={H} "
                               f"N={N} {kind} {dtype}")
            kind_name = "past_16_heads" if H > 16 else "past_256"
            prefix = "fused_match" if head == "point" else "fused_image_match"
            for kind, line in (("grid", "250" if head == "point" else "686"),
                               ("pairs", "355" if head == "point"
                                else "514")):
                by_row.setdefault((prefix, kind, kind_name, line), []).append(
                    case[kind])
        for (prefix, kind, kind_name, line), shapes in by_row.items():
            head = max(shapes, key=lambda m: m["C"])
            rows.append(dict(
                name=f"{prefix}_{kind}/{kind_name}{sfx}", route="cuda",
                source=f"point_cloud_reid_tpu_torch/csrc/match_rows_pad{sfx}"
                       ".cu",
                replaces="point_cloud_reid_tpu/ops/pallas/match_grid.py:"
                         + line,
                **{k: head[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_padded_ms", "library_ms")},
                shapes=shapes))
    print(f"[k7:match] the largest launch's scratch: {largest[0]} bytes "
          f"({largest[1]}; budget {mg.ROWS_SCRATCH_BUDGET})", flush=True)
    return rows, largest[0]


def k7_want(name: str, bf16: bool, sparse: str) -> list:
    """The counters a configs/widths.py model of phase 18 must launch
    through tools/track.py: the SA kernel's wide layout at mul24 (SA3 at
    3,072 channels), the wide match kernel past 256 channels, or past 16
    heads at heads32."""
    sfx = "_bf16" if bf16 else ""
    if name == "mul24":
        return ["fused_sa_convmax/wide" + sfx]
    fn = (("fused_image_match" if name.startswith("image")
           else "fused_match") + ("_grid" if sparse == "never" else "_pairs"))
    return [f"{fn}/{'past_16_heads' if name == 'heads32' else 'past_256'}"
            f"{sfx}"]


def k7_sharded(card: str) -> dict:
    """The conv_out512 model's grid and pair scoring through the sharded
    wrappers (kernels/match_grid.sharded_grid_logits / sharded_pair_logits)
    on a mesh of K7_SHARDS entries of cuda:0, against the unsharded
    scoring (MATCH_TOL), each entry past 256 channels at least once."""
    import torch
    from point_cloud_reid_tpu_torch import configs as tcfg
    from point_cloud_reid_tpu_torch.configs.widths import WIDTHS
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.parallel import make_mesh
    leaf, sets = WIDTHS["conv_out512"]
    model = build_model(tcfg.get_experiment(leaf, sets)["model"],
                        device=DEVICE,
                        generator=torch.Generator().manual_seed(SEED))
    model.eval()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    mesh = make_mesh(data=K7_SHARDS,
                     devices=[torch.device("cuda", 0)] * K7_SHARDS)
    before = mg.fused_match_grid.shape_launches["past_256"]
    with torch.no_grad():
        xt, ht = model.embed(torch.randn((12, 128, 3), generator=gen,
                                         device=DEVICE))
        xd, hd = model.embed(torch.randn((10, 128, 3), generator=gen,
                                         device=DEVICE))
        ti = torch.randint(0, 12, (64,), generator=gen, device=DEVICE)
        di = torch.randint(0, 10, (64,), generator=gen, device=DEVICE)
        grid = mg.sharded_grid_logits(model, ht, xt, hd, xd, mesh)
        pairs = mg.sharded_pair_logits(model, ht, xt, hd, xd, ti, di, mesh)
        want = mg.grid_logits(model, ht, xt, hd, xd)
    g_gap = rel_err(grid, want)[1]
    p_gap = rel_err(pairs, want[ti, di])[1]
    wide = mg.fused_match_grid.shape_launches["past_256"] - before
    print(f"[k7:sharded] conv_out512 on a {K7_SHARDS}-entry mesh of cuda:0: "
          f"grid 12x10 against unsharded {g_gap:.3e}, 64 pairs {p_gap:.3e} "
          f"(tol {MATCH_TOL:g}); launches per entry {mesh.launches}; grid "
          f"launches past 256 channels {wide} on {card}", flush=True)
    if not (g_gap <= MATCH_TOL and p_gap <= MATCH_TOL and wide >= K7_SHARDS
            and all(e["match"] > 0 for e in mesh.launches)):
        raise RuntimeError("the sharded wrappers at 512 channels disagree "
                           "with unsharded scoring, or an entry ran no "
                           "kernel")
    del model
    torch.cuda.empty_cache()
    return dict(grid_rel_gap=g_gap, pairs_rel_gap=p_gap,
                launches_per_entry=mesh.launches)


def phase_k7(card: str):
    """Phase 18: the SA kernels past 2048 channels, the match chain past
    256 channels and 16 heads (ROADMAP.md K7); the kernels against their
    plain versions and a sharded launch at 512 channels, then, with every
    count at 0, the four --set models mul24, conv_out512, heads32 and
    image768 of configs/widths.py through tools/track.py at float32 and
    --bf16, dense ('never') and sparse ('always'), each frame against the
    chain's plain version. Returns (the SA cases by dtype, the kernels-line
    rows of the match kernels, the path's launches, a summary)."""
    import torch
    t_phase = time.perf_counter()
    sa_cases = k7_sa_cases()
    rows, scratch = k7_match_rows()
    sharded = k7_sharded(card)
    t_kernels = time.perf_counter() - t_phase
    every = zero_counters()
    launches = {k: 0 for k in every}
    runs = {}
    for name in K7_MODELS:
        for bf16 in (False, True):
            for sparse in ("never", "always"):
                t0 = time.perf_counter()
                used = width_cli(card, name, bf16, sparse, every,
                                 want=k7_want(name, bf16, sparse))
                runs[f"{name}{' --bf16' if bf16 else ''} {sparse}"] = (
                    time.perf_counter() - t0)
                for k, v in used.items():
                    launches[k] += v
                torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[k7] path launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"[k7] phase 18 took {seconds:.1f} s (kernels {t_kernels:.1f} s, "
          f"tools/track.py runs {seconds - t_kernels:.1f} s)", flush=True)
    return sa_cases, rows, launches, dict(
        seconds=seconds, kernels_seconds=t_kernels, cli_seconds=runs,
        largest_match_scratch_bytes=scratch, sharded=sharded)


def widest_sa(rows: list, sa_cases: dict) -> None:
    """The kernels line's SA wide-layout rows (phase 17) report their
    widest stage: phase 18's cases join their shapes and the widest case's
    numbers become the row's."""
    for key, cases in sa_cases.items():
        sfx = "_bf16" if key == "bf16" else ""
        row = next(r for r in rows if r["name"] == "fused_sa_convmax/wide"
                   + sfx)
        row["shapes"] = row["shapes"] + cases
        widest = max(row["shapes"], key=lambda c: c["C"])
        row.update({k: widest[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_padded_ms", "bound_ratio", "library_ms")})


def knn_channel_case(B, S, N, C, k, dtype, seed: int) -> dict:
    """Tier C against its plain version (kernels/knn.knn_reference in the
    inputs' dtype) on exact, duplicated (indices equal) and random inputs
    (near-ties only: KNN_TIE, KNN_BF16_TIE), then timed on the random ones:
    a call from Python, the device time of a CUDA graph of calls, the plain
    version, torch.cdist + topk in float32 (not tie-stable) and the bound
    of the products the tier runs: 2 B S N C flops at one bf16 pass over
    989 TFLOP/s at bf16, on FFMA over 67 at float32; the FFMA bound kept
    as `simt_fp32_bound_ms`; or the inputs and int64 indices over 3.35
    TB/s."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.tools.scenes import knn_cloud as cloud
    from point_cloud_reid_tpu_torch.tools.timing import graph_ms, time_ms
    swaps, gap = 0, 0.0
    for kind in ("exact", "duplicates", "random"):
        xyz = torch.from_numpy(cloud(kind, B, N, seed, C)).to(DEVICE, dtype)
        q = xyz[:, :S]
        got = kk.knn(q, xyz, k, keep_dtype=True)
        want = kk.knn_reference(q, xyz, k)
        bad = got != want
        n_bad = int(bad.sum().item())
        if kind != "random":
            if n_bad:
                raise RuntimeError(f"knn/channels {kind} {dtype} B={B} S={S} "
                                   f"N={N} C={C} k={k}: {n_bad} indices "
                                   "differ")
            continue
        d = kk.square_distance(q, xyz).float()
        diff = (d.gather(-1, got) - d.gather(-1, want)).abs()[bad]
        scale = d.gather(-1, want)[bad].abs().clamp(min=1.0)
        del d
        tie = KNN_TIE if dtype == torch.float32 else KNN_BF16_TIE
        if bool((diff > tie * scale).any()):
            raise RuntimeError(f"knn/channels random {dtype} B={B} N={N} "
                               f"C={C}: indices differ beyond a near-tie")
        swaps = n_bad
        gap = float((diff / scale).max()) if n_bad else 0.0
    ms = time_ms(lambda: kk.knn(q, xyz, k, keep_dtype=True), 5)
    device = graph_ms(lambda: kk.knn(q, xyz, k, keep_dtype=True), 5, 2)
    plain = time_ms(lambda: kk.knn_reference(q, xyz, k), 2, 1)
    qf, xf = q.float(), xyz.float()
    lib = time_ms(lambda: torch.cdist(qf, xf).topk(
        k, dim=-1, largest=False).indices, 2, 1)
    del qf, xf
    flops, nbyte = 2.0 * B * S * N * C, nbytes(q, xyz) + 8 * B * S * k
    how = kk.plan(N, k, C=C, bf16=dtype == torch.bfloat16)
    route = "bf16" if dtype == torch.bfloat16 else "ffma"
    b_ms, b_by = bound_ms(flops, nbyte, PEAK_BF16 if route == "bf16"
                          else PEAK_FLOPS)
    simt = bound_ms(flops, nbyte)[0]
    torch.cuda.empty_cache()
    case = dict(B=B, S=S, N=N, C=C, k=k, dtype=str(dtype).split(".")[-1],
                width=how.points, route=route, smem_bytes=how.smem,
                near_tie_swaps=swaps, indices=got.numel(), max_gap_rel=gap,
                ms=ms, device_ms=device, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by, bound_ratio=device / b_ms,
                simt_fp32_bound_ms=simt)
    print(f"[dgcnn:knn] {case['dtype']} B={B} S={S} N={N} C={C} k={k} "
          f"(stage {case['width']} channels, {route} products, "
          f"{how.smem} shared bytes): indices equal on exact and "
          f"duplicated inputs; random: {swaps} of {got.numel()} near-tie "
          f"swaps (largest gap {gap:.2e} rel.); kernel {ms:.3f} ms (device "
          f"{device:.3f}), plain {plain:.3f} ms, cdist+topk {lib:.3f} ms, "
          f"bound {b_ms:.3f} ms ({b_by}), {device / b_ms:.2f}x (FFMA bound "
          f"{simt:.3f} ms, {device / simt:.2f}x)", flush=True)
    return case


def knn_conv1_case(seed: int) -> dict:
    """DGCNN's first kNN, over xyz (512 clouds of 2048 points, C = 3, k =
    20, float32): tier S as kernels/knn routes it, and tier C forced
    through plan(..., tier=CHANNELS), each against the plain version on
    exact, duplicated (indices equal) and random inputs (near-ties only),
    each timed (a call from Python and a CUDA graph's device time). The
    routing does not change."""
    import torch
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.tools.scenes import knn_cloud as cloud
    from point_cloud_reid_tpu_torch.tools.timing import graph_ms, time_ms
    B, N, C, k = 512, 2048, 3, 20
    routed = kk.plan(N, k, C=C)
    forced = kk.plan(N, k, C=C, tier=kk.CHANNELS)
    out = {}
    for name, how in (("routed", routed), ("channels", forced)):
        swaps = 0
        for kind in ("exact", "duplicates", "random"):
            xyz = torch.from_numpy(cloud(kind, B, N, seed, C)).to(DEVICE)
            got = kk.launch(xyz, xyz, k, how)
            want = kk.knn_reference(xyz, xyz, k)
            bad = got != want
            n_bad = int(bad.sum().item())
            if kind != "random" and n_bad:
                raise RuntimeError(f"knn conv1 {name} {kind}: {n_bad} "
                                   "indices differ")
            if kind == "random" and n_bad:
                d = kk.square_distance(xyz, xyz)
                diff = (d.gather(-1, got) - d.gather(-1, want)).abs()[bad]
                scale = d.gather(-1, want)[bad].abs().clamp(min=1.0)
                del d
                if bool((diff > KNN_TIE * scale).any()):
                    raise RuntimeError(f"knn conv1 {name}: indices differ "
                                       "beyond a near-tie")
                swaps = n_bad
        ms = time_ms(lambda: kk.launch(xyz, xyz, k, how), 5)
        device = graph_ms(lambda: kk.launch(xyz, xyz, k, how), 5, 2)
        out[name] = dict(tier=kk.TIER_NAMES[how.tier], smem_bytes=how.smem,
                         near_tie_swaps=swaps, ms=ms, device_ms=device)
    plain = time_ms(lambda: kk.knn_reference(xyz, xyz, k), 2, 1)
    b_ms, b_by = bound_ms(2.0 * B * N * N * C, nbytes(xyz) + 8 * B * N * k)
    case = dict(B=B, S=N, N=N, C=C, k=k, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, **out)
    print(f"[dgcnn:knn] conv1 xyz B={B} N={N} k={k}: routed tier "
          f"{out['routed']['tier']} {out['routed']['ms']:.3f} ms (device "
          f"{out['routed']['device_ms']:.3f}), tier C forced "
          f"{out['channels']['ms']:.3f} ms (device "
          f"{out['channels']['device_ms']:.3f}); both equal to plain on "
          f"exact and duplicated inputs, near-tie swaps "
          f"{out['routed']['near_tie_swaps']} / "
          f"{out['channels']['near_tie_swaps']}; plain {plain:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    torch.cuda.empty_cache()
    return case


def knn_channel_usage() -> dict:
    """ptxas's registers and spills of every tier C instantiation
    (knn_channels_kernel<T, multi, two lists, vector copies>), from the
    kernels' build log, by a short name."""
    import re
    from point_cloud_reid_tpu_torch.kernels import _lib
    out = {}
    for entry, use in _lib.ptxas_usage(_lib.LIBRARY.build_log).items():
        m = re.search(r"knn_channels_kernelI(f|13__nv_bfloat16)Lb(\d)ELb(\d)"
                      r"ELb(\d)E", entry)
        if m:
            name = ("float32/ffma" if m.group(1) == "f" else "bf16/bf16") + (
                "/stages" * (m.group(2) == "1")) + (
                "/k>32" * (m.group(3) == "1")) + ("/vec" * (m.group(4) == "1"))
            out[name] = use
    if not out:
        raise RuntimeError("no ptxas account of knn_channels_kernel")
    spilled = {k: v for k, v in out.items() if v["spill_stores"]}
    print(f"[dgcnn:knn] ptxas: {len(out)} instantiations, registers "
          f"{sorted({v['registers'] for v in out.values()})}, spilled "
          f"{spilled or 'none'}", flush=True)
    return out


def knn_channel_rows() -> tuple:
    """The kernels line's rows of tier C, float32 and bf16: each summed over
    a DGCNN forward's three feature-space calls at 256 pairs (C = 64 twice,
    128 once), the other shapes under `shapes`, ptxas's account of the
    dtype's instantiations under `ptxas`."""
    import torch
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    # the plain bf16 path's products summed in float32 alone, as the kernel
    # sums them
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rows, cases = [], []
    usage = knn_channel_usage()
    try:
        for dtype in (torch.float32, torch.bfloat16):
            mine = [knn_channel_case(*shape, dtype, SEED + i)
                    for i, shape in enumerate(KNN_CHANNELS)]
            cases += mine
            path = [mine[0], mine[0], mine[1]]
            sfx = "" if dtype == torch.float32 else "_bf16"
            rows.append(dict(
                name="knn/channels" + sfx, route="cuda",
                source="point_cloud_reid_tpu_torch/csrc/knn_channels.cu",
                replaces="point_cloud_reid_tpu/ops/pallas/knn.py:51",
                max_abs_err=max(c["max_gap_rel"] for c in mine),
                near_tie_swaps=sum(c["near_tie_swaps"] for c in mine),
                mismatches_exact=0,
                **{key: sum(c[key] for c in path) for key in (
                    "ms", "device_ms", "plain_ms", "bound_ms",
                    "simt_fp32_bound_ms", "library_ms")},
                bound_by=path[-1]["bound_by"], shapes=mine,
                ptxas={key: v for key, v in usage.items()
                       if key.startswith(sfx[1:] or "float32")}))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            flag)
    return rows, cases


def dgcnn_train_runs(card: str) -> dict:
    """The ablation leaf's train step at 256 pairs through
    tools/profile_train.py (its kernel knobs on; DGCNN takes none):
    float32 and bf16, each with and without remat."""
    import argparse
    import torch
    from point_cloud_reid_tpu_torch.tools import profile_train as pt
    runs = {}
    for bf16 in (False, True):
        for remat in (False, True):
            held = torch.cuda.memory_allocated() / 2 ** 30
            args = argparse.Namespace(
                experiment=DGCNN_ABLATION, batch=TRAIN_PAIRS,
                steps=DGCNN_STEPS, warmup=DGCNN_WARMUP,
                trace_dir=DGCNN_TRACES, bf16=bf16, remat=remat)
            res = pt.profile_config(True, args)
            label = ("bf16" if bf16 else "float32") + (" --remat" * remat)
            if not all(np.isfinite([res["loss"], res["grad_norm"]])):
                raise RuntimeError(f"dgcnn {label}: loss {res['loss']}, "
                                   f"grad_norm {res['grad_norm']}")
            knn_tiers = {t: v for t, v in res["knn_launches_per_step"].items()
                         if v}
            knn_ms = sum(v for name, v in res["hand_kernels_ms_per_step"]
                         .items() if "knn" in name)
            print(f"[dgcnn:train] {DGCNN_ABLATION} {label}, {TRAIN_PAIRS} "
                  f"pairs: step {res['median_step_ms']:.1f} ms (steps "
                  f"{[round(x, 1) for x in res['step_ms']]}), forward "
                  f"{res['forward_ms']:.1f} / backward "
                  f"{res['backward_ms']:.1f} / optimizer "
                  f"{res['optimizer_ms']:.1f} ms, peak "
                  f"{res['peak_memory_gib']:.2f} GiB ("
                  f"{res['peak_memory_gib'] - held:.2f} above the {held:.2f} "
                  f"GiB held before the run), device busy "
                  f"{res['device_busy_share']:.1%}, kNN launches a step "
                  f"{knn_tiers}, kNN device {knn_ms:.2f} ms a step ("
                  f"{knn_ms / res['median_step_ms']:.1%} of the step), loss "
                  f"{res['loss']:.4f}, grad_norm "
                  f"{res['grad_norm']:.4f} on {card}", flush=True)
            runs[label] = {k: res[k] for k in (
                "median_step_ms", "step_ms", "forward_ms", "backward_ms",
                "optimizer_ms", "peak_memory_gib", "device_busy_share",
                "knn_launches_per_step", "hand_kernels_ms_per_step", "loss",
                "grad_norm")}
            runs[label]["held_gib"] = held
            runs[label]["knn_ms_per_step"] = knn_ms
            runs[label]["knn_share"] = knn_ms / res["median_step_ms"]
            torch.cuda.empty_cache()
    return runs


def dgcnn_eval_batches(card: str) -> dict:
    """One eval batch (train/loop.make_eval_step) of the leaf at 256 pairs,
    float32 and bf16: ms (host clock around a synchronised call, the second
    of two) and peak GiB; finite logits, one a pair."""
    import torch
    from point_cloud_reid_tpu_torch.tools import profile_train as pt
    from point_cloud_reid_tpu_torch.train.loop import make_eval_step
    out = {}
    spec = pt.train_spec(DGCNN_ABLATION, True)
    for bf16 in (False, True):
        held = torch.cuda.memory_allocated() / 2 ** 30
        run = pt.train_setup(spec, torch.device(DEVICE), TRAIN_PAIRS, 1,
                             bf16=bf16)
        step = make_eval_step(run["model"], spec["losses"], spec["alpha"])
        batch = run["batches"][0]
        step(run["state"], batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = step(run["state"], batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        logits = res["val_match_preds"]
        if logits.shape[0] != TRAIN_PAIRS or not bool(
                torch.isfinite(logits.float()).all()):
            raise RuntimeError(f"dgcnn eval: logits {tuple(logits.shape)}")
        label = "bf16" if bf16 else "float32"
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[dgcnn:eval] {DGCNN_ABLATION} {label}, one batch of "
              f"{TRAIN_PAIRS} pairs: {ms:.1f} ms, peak {peak:.2f} GiB "
              f"({peak - held:.2f} above the {held:.2f} GiB held before), "
              f"logits finite on {card}", flush=True)
        out[label] = dict(ms=ms, peak_memory_gib=peak, held_gib=held)
        del run, step, res
        torch.cuda.empty_cache()
    return out


def dgcnn_chunk_check(card: str) -> dict:
    """One float32 train step of the leaf at CHUNK_PAIRS pairs with
    EdgeConv's chunks as the shapes give them, against the same step with
    each block in one chunk (the whole edge tensor, as before chunking),
    run twice: float32 summation order alone separates them (the sums over
    chunks, cuBLAS's and index_add_'s atomics, which also separate one
    chunk from itself). Loss, grad_norm and the gradients (the 2-norm of
    the difference over the one-chunk gradient's) at CHUNK_TOL, the
    weights after the step through the updates' gap (|chunked - one
    chunk| / |one chunk's update|, 2-norms over every weight) at
    DP_UPDATE_TOL, as phase 15 holds two routes of a step (Adam moves an
    entry by about lr whatever its gradient's size, so an entry whose
    gradient is rounding may move either way); the one chunk's gaps to
    itself printed beside them."""
    import torch
    from point_cloud_reid_tpu_torch.models import dgcnn
    from point_cloud_reid_tpu_torch.tools import profile_train as pt
    spec = pt.train_spec(DGCNN_ABLATION, True)
    default = dgcnn.EDGE_CHUNK_BYTES
    held = torch.cuda.memory_allocated() / 2 ** 30
    got = []
    try:
        for budget in (default, 1 << 62, 1 << 62):
            dgcnn.EDGE_CHUNK_BYTES = budget
            run = pt.train_setup(spec, torch.device(DEVICE), CHUNK_PAIRS, 1)
            model = run["model"]
            chunks = [len(dgcnn.edge_chunks(
                2 * CHUNK_PAIRS * spec["num_points"], m.k,
                m[0].out_features))
                for m in model.modules() if isinstance(m, dgcnn.EdgeConv)]
            opt = run["state"].optimizer
            before = [p.detach().clone() for p in opt.params]
            seen = {}
            apply = opt.step

            def step(reduce=None):
                # the step's raw gradients, before the update clears them
                seen["grads"] = [g.detach().clone() for g in opt.gradients()]
                return apply(reduce)
            opt.step = step
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, log = run["step"](run["state"], run["batches"][0],
                                 run["generator"])
            torch.cuda.synchronize()
            got.append(dict(
                loss=float(log["reid_loss"]),
                grad_norm=float(log["grad_norm"]), chunks=chunks,
                peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                grads=seen["grads"],
                update=[p.detach() - b for p, b in zip(opt.params, before)]))
            del run, model, opt, before, seen
            torch.cuda.empty_cache()
    finally:
        dgcnn.EDGE_CHUNK_BYTES = default

    def gaps(a, b):
        rel = {k: abs(a[k] - b[k]) / max(1.0, abs(b[k]))
               for k in ("loss", "grad_norm")}
        for key in ("grads", "update"):
            num = sum(float(((u - w) ** 2).sum())
                      for u, w in zip(a[key], b[key]))
            den = sum(float((w ** 2).sum()) for w in b[key])
            rel[key] = (num / den) ** 0.5
        return rel
    rel, noise = gaps(got[0], got[1]), gaps(got[2], got[1])
    a, b = got[0], got[1]
    print(f"[dgcnn:chunks] {CHUNK_PAIRS} pairs, float32: chunks a block "
          f"{a['chunks']} against {b['chunks']}: loss {a['loss']:.6f} / "
          f"{b['loss']:.6f}, grad_norm {a['grad_norm']:.6f} / "
          f"{b['grad_norm']:.6f}; rel loss {rel['loss']:.2e}, grad_norm "
          f"{rel['grad_norm']:.2e}, gradients {rel['grads']:.2e} (tol "
          f"{CHUNK_TOL:g}), updates' gap {rel['update']:.2e} (tol "
          f"{DP_UPDATE_TOL:g}); one chunk against itself: loss "
          f"{noise['loss']:.2e}, grad_norm {noise['grad_norm']:.2e}, "
          f"gradients {noise['grads']:.2e}, updates' gap "
          f"{noise['update']:.2e}; peak {a['peak']:.2f} against "
          f"{b['peak']:.2f} GiB (each with the {held:.2f} GiB held before) "
          f"on {card}", flush=True)
    if (max(rel["loss"], rel["grad_norm"], rel["grads"]) > CHUNK_TOL
            or rel["update"] > DP_UPDATE_TOL):
        raise RuntimeError(f"dgcnn: the chunked step differs: {rel}")
    return dict(chunks=a["chunks"], one_chunk=b["chunks"], rel=rel,
                one_chunk_noise=noise, peak_gib=[a["peak"], b["peak"]],
                held_gib=held)


def phase_dgcnn_ablation(card: str):
    """Phase 19: tier C of the kNN kernel against its plain version, then,
    with every count at 0, the DGCNN 2048-point ablation's train step at 256
    pairs (float32, bf16, each with and without remat), an eval batch of
    256 pairs and the chunked step against one chunk. Returns (the kernels
    line's rows, the path's launches, a summary)."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rows, cases = knn_channel_rows()
    conv1 = knn_conv1_case(SEED)
    t_kernels = time.perf_counter() - t_phase
    every = zero_counters()
    train = dgcnn_train_runs(card)
    evals = dgcnn_eval_batches(card)
    chunks = dgcnn_chunk_check(card)
    launches = {k: fn.launches for k, fn in every.items()}
    if not launches["knn/channels"] or not launches["knn/channels_bf16"]:
        raise RuntimeError(f"dgcnn: tier C not launched: {launches}")
    seconds = time.perf_counter() - t_phase
    print(f"[dgcnn] path launches {({k: v for k, v in launches.items() if v})}"
          f"; phase 19 took {seconds:.1f} s (kernel checks {t_kernels:.1f} s)",
          flush=True)
    return rows, launches, dict(seconds=seconds, kernels_seconds=t_kernels,
                                knn_cases=cases, knn_conv1=conv1,
                                knn_ptxas=rows[0]["ptxas"] | rows[1]["ptxas"],
                                train=train, eval=evals,
                                chunks=chunks)


def main():
    import torch
    card = phase_device()
    from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
    from point_cloud_reid_tpu_torch.models import build_model
    model = build_model(point_transformer_point_cat(), device=DEVICE,
                        generator=torch.Generator().manual_seed(SEED))
    rows = phase_kernels(model) + phase_train_kernels(model)
    serving = phase_main_path(model, card)
    del model
    torch.cuda.empty_cache()
    training = phase_training(card)
    torch.cuda.empty_cache()
    image_rows, image = phase_image_kernels()
    rows += image_rows + phase_fps_kernel()
    image_path = phase_image_path(image, card)
    tracker_host = phase_tracker_host(card, image)
    del image
    torch.cuda.empty_cache()
    fps_path = phase_fps_path()
    torch.cuda.empty_cache()
    data_path, data_summary = phase_data_path(card)
    torch.cuda.empty_cache()
    family_rows, family_shapes, family, family_summary = phase_family(card)
    for row in rows:
        row["shapes"] = family_shapes.get(row["name"], [])
    rows += family_rows
    torch.cuda.empty_cache()
    bf16_rows, bf16_path, bf16_summary = phase_bf16(card)
    rows += bf16_rows
    torch.cuda.empty_cache()
    bf16_training, bf16_training_summary = phase_bf16_training(card)
    torch.cuda.empty_cache()
    zoo, zoo_summary = phase_zoo(card)
    torch.cuda.empty_cache()
    tracker_zoo, tracker_zoo_rows, tracker_zoo_summary = phase_tracker_zoo(
        card)
    rows += tracker_zoo_rows
    torch.cuda.empty_cache()
    reference, reference_summary = phase_reference(card)
    torch.cuda.empty_cache()
    multi_gpu, multi_gpu_summary = phase_multi_gpu(card)
    torch.cuda.empty_cache()
    width_kernel_rows, widths, widths_summary = phase_widths(card)
    rows += width_kernel_rows
    torch.cuda.empty_cache()
    wide_kernel_rows, wide, wide_summary = phase_wide(card)
    rows += wide_kernel_rows
    torch.cuda.empty_cache()
    k7_sa, k7_rows, k7, k7_summary = phase_k7(card)
    widest_sa(rows, k7_sa)
    rows += k7_rows
    torch.cuda.empty_cache()
    dgcnn_rows, dgcnn, dgcnn_summary = phase_dgcnn_ablation(card)
    rows += dgcnn_rows
    for row in rows:
        # each path was driven with every count at 0 just before it
        counter = row.pop("counter", row["name"])
        row["launches"] = sum(path.get(counter, 0) for path in (
            serving, training, image_path, tracker_host, fps_path,
            data_path, family, bf16_path, bf16_training, zoo, tracker_zoo,
            reference, multi_gpu, widths, wide, k7, dgcnn))
        if row["launches"] <= 0:
            raise RuntimeError(f"{row['name']} was never launched on a "
                               "main path")
    print(json.dumps({"kernels": rows, "data_path": data_summary,
                      "family": family_summary, "bf16": bf16_summary,
                      "bf16_training": bf16_training_summary,
                      "zoo": zoo_summary,
                      "tracker_zoo": tracker_zoo_summary,
                      "reference": reference_summary,
                      "multi_gpu": multi_gpu_summary,
                      "widths": widths_summary, "wide": wide_summary,
                      "k7": k7_summary, "dgcnn_ablation": dgcnn_summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
