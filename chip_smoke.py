#!/usr/bin/env python3
"""Drive the PyTorch port (nl_vsgg_tpu_torch) on NVIDIA GPUs.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card
    python3 chip_smoke.py --cards 4  # phases 1 and 19 alone: needs 4 cards

Phases, in order; any failure exits non-zero before the result line:
  1. build every CUDA kernel from csrc/ with nvcc (timed), print the card's
     name and power limit;
  2. every kernel against its plain PyTorch version at the main paths'
     shapes (B=64 videos, H=8 heads, head dim 242; 96x96, 192x192, 96x192;
     float32 and bfloat16; with fully masked rows): the eval forward, and
     the train forward (dropout rate 0 and 0.1, with the log-sum-exp) with
     both backward kernels, rows and key columns with no allowed pair
     exactly 0; then the dQ kernel's edges on both of its routes (route
     printed, dropout off and on): a 192x192 mask at 3% with fully
     allowed and empty rows, a view 2 bytes off 16-byte alignment, odd
     D = 241 at 8 and at 4 heads, 8 heads of 240, 3 heads of 242 and of 64;
     then the forward's and dK/dV's edges on both routes (`ROUTE_EDGES`,
     route printed, one launch a call, dropout off and on, the forward with
     and without lse): path-structured and random 3% masks with fully
     allowed and empty rows and unseen keys, tiles that do not divide L,
     96x192 and 192x96, 3 heads, odd D, a misaligned view;
  3. the serving path: STTran sgdet at full width (feat 2048, 1 encoder + 3
     decoder layers, 8 heads, random weights from a seeded torch.Generator)
     serving 64 synthetic videos at bench.py's shapes (32 frames, 128 box and
     96 relation slots) through `serve.predict`, with the kernels' launch
     counts set to 0 just before and read just after; then the kernel path
     against the plain-attention path on the same weights, float32 and
     bfloat16, and the bfloat16 eval step's frames/s;
  4. the eval forward timed on the inputs the serving path gave it (its
     route printed: the staged one, or the run fails), beside its plain
     version, one PyTorch library call and the card's bound; a
     torch.profiler table of the eval step's device time;
  5. the training path: one train-mode forward and backward at full width
     (dropout 0.1), kernel path against plain-attention path on the same
     weights and generator seed, parameter gradients compared in float32
     and bfloat16; then bfloat16 `train_step`s at B=64 (clipped AdamW, the
     NaN/empty guard) with the launch counts set to 0 just before and read
     just after (4 forward and 4 + 4 backward launches a step), finite
     losses and no skip, ms/step and frames/s, peak memory;
  6. the train forward and both backward kernels timed on the inputs one
     train step gave them (their routes printed: staged, or the run fails),
     beside their plain versions, the library call and the bound; a
     torch.profiler table of the train step;
  7. the detector kernels against their plain versions at the detector
     path's shapes, float32 and bfloat16: RoIAlign on a (4, 38, 64, 1024) C4
     map with 300 rois a frame (degenerate, clamped and fully outside rois
     among them), and at its edges (the whole map, wholly outside on each
     side, degenerate, past the far edge, straddling each border, in random
     frame order; S = 1, 2, 4; C = 1020 and a misaligned map on the scalar
     route, C = 1000 on the vector route; a single roi), the grouped 3x3
     conv at its four geometry classes (c = 8
     at 152x256, 16 at 76x128, 32 at 38x64, 64 at 7x7 over 1200 crops) and
     at the edges of the bf16 kernel's tiles (1201 crops, a 38x50 map), with
     and without the bias + ReLU epilogue, float32 (on the 3xtf32 route),
     bfloat16 (on the tc route), and bfloat16 in with a float32 output,
     each call's route printed (or the run fails); bf16 storage off 16-byte
     alignment refused;
  8. the detector path: `AttrRCNNTorch` (VinVL X152-C4 at full width and
     depth, random weights from a seeded generator) on 480x800 BGR frames
     (600x1000 after the resize, bucket 608x1024): in float32 on 4 frames
     the kernel path against the plain path on the same weights (C4 map,
     RPN logits and deltas, box-head logits, deltas and features at the same
     proposals, relative to each tensor's largest magnitude; the detections
     matched by frame, label and corners), with the launch counts of the
     trunk (45 grouped convs) and the box head (1 RoIAlign, 2 grouped
     convs), every grouped conv on the 3xtf32 route; then the bf16
     `detect_video` as a server answering two 32-frame requests and
     `extract_box_features_frames` for 96 union boxes
     a video, each with the counts set to 0 just before and read just after
     (1 RoIAlign and 47 grouped convs a pass), ms per video, frames/s, peak
     memory, and bf16 union features against fp32 by correlation;
  9. both detector kernels timed on the inputs one bf16 `detect_video` gave
     them, beside their plain versions, cuDNN's grouped conv and the bound;
     a torch.profiler table of one bf16 `detect_video`; then the float32
     route (`fp32_conv_phase`): float32 `detect_video`s of a 32-frame
     video with its 47 grouped convs on the 3xtf32 route and, patched in,
     on the first kernel (fma), ms per video and frames/s for both (cuDNN's
     TF32 on, as `preprocess features` runs); the 47 calls each held to the
     plain version on both routes (1e-5 of the max, TF32 off), one a shape
     class timed on both routes, the plain version and cuDNN with TF32 off
     and on, beside the bound by bytes and by operations at TF32's rate, with
     the CUDA-core term and the 3xtf32 design's three TF32 products logged;
 10. the probe path (`nl_vsgg_tpu_torch.tools.probe_overhead` and
     `probe_ablate`): its four kernels against their plain versions at the
     probes' full shapes (the copy exact in float32 and bfloat16 at (256,
     128), (8, 40, 64, 128), (1001,) and (1,) as 1, 8 and 3 units; the (M,
     128) @ (128, 128) mma kernel at M = 20480, 1000, 4255, 5 and 1, and
     every conv variant at every tile size in bfloat16 to KERNEL_TOL on the
     (8, 40, 64, 1024) stage-4 input; `full` and `bt-full` in float32
     against cuDNN's groups-8 conv to 1e-5 of its largest magnitude), the
     packed conv's edges (`ABLATE_EDGES` and H = 38 with tiles that do not
     divide its parts, every variant and layout, route printed; misaligned
     storage refused), then both probe entry points with small `--iters`,
     the launch counts set to 0 just before and read just after (each
     kernel's count equal to the calls its rows made), every copy and conv
     row on the new route (printed); the three copies' times beside their
     bounds and `x * 2` on each row's own input;
 11. the evaluation path at full width on phase 3's 64 videos (a bf16 STTran
     drawn from the same seed): seeded AG_Test GT from each Entry's box
     table (`data.synthetic.make_synthetic_gt`), the eval step (4 forward
     launches), `entry_to_eval_pred`, the host `SceneGraphEvaluator` and
     `device_eval_batch` on the card (every with/no/semi row equal to the
     host's within 1e-6, no GT dropped), mR@K from `mean_recall_video`
     equal to the host collectors', R@K printed; `evaluate_epoch` over the
     64 videos in batches of 16 with a `DeviceEvalPromotion` (it must
     promote, its score(20) equal the host's, 4 launches a batch); the
     sgcls two-stage flow on 8 videos (stage 1, `sgcls_assign`,
     `build_infer_entry` with the mask sentinel and zero union features,
     stage 2: 8 launches) and the sgdet flow from seeded detections
     (`sgdet_assign`, `build_infer_entry`, one forward), each evaluator's
     R@K finite and in [0, 1]; `nms_mask` and `batched_nms_mask` keep the
     same boxes on the card as on the CPU; host and device ms per video,
     the device scorer alone, the loop's `place_entries` times and fetch
     waits, the loop traced once more by `torch.profiler` (the card's busy
     time, kernels and copies, and idle share over the traced span) and the
     phase's wall time, beside the card's name and power limit;
 12. DSG-DETR at full width (sgdet: 1 local + 3 global encoder layers, 8
     heads, feat 2048, bf16, random weights from a seeded generator) on
     phase 3's 64 videos (set (a): a new class per object and frame) and on
     a copy of them whose object slots keep one class through the clip (set
     (b), tracklets, as an Action Genome clip follows a few objects), the
     local and global masks' allowed-pair densities printed (about 3% and
     3% on (a), 3% and 1/3 on (b)): `serve.predict` on both sets with the
     launch counts set to 0 just before and read just after (4 forward
     launches), the kernel path against the plain path (MODEL_TOL, float32
     and bfloat16), the bf16 eval step's frames/s; on set (b) train
     gradients of both paths (TRAIN_GRAD_TOL) and 5 bf16 `train_step`s at
     B=64 (4 + 4 + 4 launches a step, finite losses, no skip, ms/step,
     frames/s, peak memory); the forward, dQ and dK/dV on the inputs of one
     eval step and one train step on each set, each against its plain
     version on the staged route (or the run fails), timed beside SDPA and
     the bound, with the time per allowed pair; the sgcls tracklet
     encoder's 8 heads of 297, float32 on the tiled route and bfloat16 on
     the per-element route (or the run fails; forward with and without
     dropout and lse, dQ, dK/dV, rows with no allowed key exactly 0), an
     sgcls train forward and backward (boxes grouped by label, as training
     groups them), kernel against plain path, its launches counted by head
     dim (3 + 3 + 3 at D = 297), and the encoder's 3 train calls' forward,
     dQ and dK/dV timed on their own inputs beside the per-element entries
     (called directly), their plain versions, SDPA and the bounds;
     `evaluate_epoch` on set (b) with a `DeviceEvalPromotion`
     (promoted, score(20) equal to the host's); the
     sgcls two-stage flow on 8 videos with `sgcls_group_ids` from the
     tracker feeding both stages (3 tracklet-encoder launches a forward,
     counted around the encoder's own calls, and 4 relation launches),
     R@K finite and in [0, 1];
     `solve_lsap_auction` on the card against scipy on the tracker's
     non-degenerate cost matrices; the phase's wall time and the card;
 13. the data path at full width (`data_phases`): a synthetic Action
     Genome split written to disk (128 videos x 32 frames, 36 detections a
     frame: a person, 3 objects and 32 of classes outside Action Genome that
     grounding drops; feat 2048: the 128-box / 96-relation bucket), read by
     `AGTrain` / `AGTest`; the native grounding engine against the python
     path on 8 videos in train and in test mode (every Entry field equal);
     STTran sgdet at full width (bf16, seeded) trained for a cold epoch
     (`ground_video` on 4 prefetch workers, `bucket_events`,
     `place_entries` with a width-0 union, the train step, each batch
     adopted by a `DeviceEntryStore`) and a warm epoch gathered from the
     store, the launch counts set to 0 just before and read just after (4 +
     4 + 4 a step), every video on the native engine, no truncation, every
     loss finite and valid, walls, frames/s and host seconds printed; a
     stored gather equal to `place_entries` over the same videos; the train
     gradients of that grounded batch through the kernels against plain
     attention (TRAIN_GRAD_TOL); each epoch again under the profiler for the
     card's busy and idle share; live union features for 2 videos from phase
     8's bf16 detector on 480x640 frames (RoIAlign and grouped-conv launches
     equal to those the calls imply, the first call of each shape held
     against its plain version on its own inputs, the union cache's second
     call extracting nothing) and a train step on them; `evaluate_epoch` through
     the prefetcher on 64 test videos (promoted, score(20) equal to the
     host's);
 14. the entry points at full width on phase 13's dataset
     (`entry_point_phases`, on 32 of its videos): STTran sgdet (bf16, 1 + 3
     layers, 8 heads, embed 1936) trained by `tools.train_sttran.run_training` for 2 epochs
     (cold, filling the device Entry store; warm, gathering), each evaluated
     with the device-eval promotion and checkpointed (epoch walls, frames/s,
     the PhaseTimer summary, store and checkpoint bytes, save ms, mean R@20
     and lr printed; 4 + 4 + 4 launches a step, 4 an eval batch); a resume
     (1 epoch, then a second run to 2) against that straight run
     (parameters and AdamW moments equal, or within RESUME_REL); the test
     CLI on its checkpoint (sgdet rows = a host evaluation of the same
     weights; predcls and sgcls on 2 videos with phase 8's seeded detector
     saved as a VinVL .pth, RoIAlign and grouped-conv launches counted and
     the first call of each shape held against its plain version);
     DSG-DETR trained 1 epoch and its sgcls test flow (6 tiled launches a
     video at D = 297); `predict` = `serve.predict` (PREDICT_TOL); the
     relation-checkpoint converter round trip, and a removed key refused;
 15. the offline label pipeline (`offline_phases`): a synthetic DAC
     LLM_cp.pt (CLIP ViT-B/32, about 151 M weights, rank-4 LoRA adapters in
     all three spellings, seeded) converted with the LoRA merged, both towers
     on the card in float32; `encode_for_adv` on 8 videos x 32 frames (256
     images of 224x224x3) and 3 caption groups a video of 1-3 sentences,
     tokenised to 77 by the port's SimpleTokenizer over a synthetic merge
     table, once through the attention kernel (12 resident launches an
     image forward and a text forward, counted by route and head count, or
     the run fails) and once through plain attention (unit embeddings
     within CLIP_TOL); the towers' images/s and sentences/s on both paths,
     one attention launch at each tower's shape beside its plain version,
     SDPA, the bound and the routes it had before (the per-element entry;
     for the text tower also the tiled one, `row_order` included: the
     `kernels` rows' `parent_route_ms`); the resident route's edge
     (`RESIDENT_EDGE`: 16 heads of 128, 200 x 128, a random mask with
     empty rows, dropout off and on, with and without lse);
     `validate_ckpt clip` on the file (_ok 1) and on a copy
     with an orphan adapter (_ok 0); `preprocess` tcs -> triplets -> adv ->
     negatives and img-info with stub LLMs and a frame reader, every pickle
     in its schema; phase 8's detector weights as a VinVL .pth ->
     `convert_vinvl` -> .npz -> `preprocess features` on 2 videos x 4 frames,
     equal to `detect_video` with the state dict bitwise, with its RoIAlign
     and grouped-conv launches counted (float32: all on the 3xtf32 route);
     the DAC checkpoint and the .pth come from the caller
     (`write_standins`, shared with phase 18) and the .npz from phase 18's
     convert_vinvl stage (alone: `write_standins(..., npz=True)`);
 16. the parallel layer (`parallel_phases`, on phase 13's dataset, so it
     runs after phase 14 and before phase 15): STTran sgdet at full width
     (bf16, seeded, dropout off) trained under DDP (a) at world size 1 over
     NCCL in this process, 3 steps on phase 5's batch against the plain step
     (P16_WORLD1_LOSS_RTOL, 2 lr a step); (b) in 2 spawned gloo ranks
     sharing the card, 32 videos each, against the one-process steps over
     all 64 (P16_LOSS_RTOL, P16_BUF_REL), BatchNorm buffers identical on
     both ranks, a NaN in rank 0's block skipped by both, one DSG-DETR sgdet
     DDP step on set (b), which gloo collectives take CUDA tensors (the ops
     in 2 pairs of spawned processes); (c) `run_training` with a data axis
     runs in phase 17 (c), bf16 on a data axis, then float32 on a model
     axis;
     (d) on the ranks of
     (b), STTran's frame-sharded transformer (bf16 and float32, one 32-frame
     video) and DSG-DETR's token-sharded one (set (b)) against the dense
     modules (MODEL_TOL), the attention kernel on both sides; the backend,
     ms per step of 2 ranks beside 1 rank, bytes all-reduced a step and the
     host-staged bytes printed;
 17. the model axis and remat (`model_axis_phases`, after phase 16 on the
     same dataset): STTran sgdet at full width (bf16, seeded) sliced over
     a 1 x 2 mesh of 2 spawned gloo ranks sharing the card (parallel/
     tensor.py), (a) 3 train steps (dropout off) on phase 5's 64 videos
     against the one-process steps (phase 16 (b)'s tolerances), each rank's
     resident parameter, gradient and AdamW bytes beside one process's, the
     bytes gathered and all-reduced a step, ms a step; (b) one DSG-DETR
     sgdet step on set (b) the same way; (c) `run_training` with mesh
     {data 2, model 1} (2 spawned ranks), bf16, for 2 epochs on all 128 of
     phase 13's videos in batches of 64, then with mesh {data 1, model 2},
     float32, for 1 epoch on one batch of 16, the device store on: only the
     primary checkpoints and
     logs, the warm epoch gathers from each data index's store, the merged
     R@20 of the sharded evals equal to the checkpoint's restored into a 1
     x 1 model (P16_R20_ATOL); (d)
     one full-width train step with remat on and off, dropout on, one
     generator seed: equal losses and generator state, parameters within
     P17_REMAT_ATOL, the step's peak memory printed both ways, the
     relation transformer's own (held after its forward, peak through its
     backward) lower with remat; (e)
     `roi_pool` on the card equal to the CPU at the C4 shape, RoIAlign on
     the same rois;
 18. the acceptance runbook (`acceptance_phases`, after phase 17 on the
     same dataset, its test split cut to 16 videos): seeded stand-ins
     (`write_standins`: phase 8's detector weights as a VinVL .pth, phase
     15's DAC LLM_cp.pt; an STTran sgdet .tar saved from the port's module),
     then `tools.acceptance.run` with --vinvl --clip --relation_ckpt --train_e2e
     3 --oracle_videos 50 at full width, bf16, batches of 64: every stage
     passes (validate_vinvl on the 3xtf32 route, convert_vinvl, validate_clip
     on the resident route, the oracle's R@20 >= 0.3, train_e2e, the
     converter, the eval with live union features from the converted .npz
     on a bf16 detector); its launches counted by kernel row (every row on
     the runbook's path at least once, each on its route); each train_e2e
     epoch's frames equal its grounded videos' frames, the warm epochs
     wholly from the device store, no skip, finite losses; the eval's rows
     equal `tools.test_sttran.main` run directly on the same checkpoint and
     config; the parity gate rerun on an expected.json of those numbers (rc
     0) and on one moved 1 point (rc 1, parity_gate the one failed stage);
     the numbers read from the stages `run` returns (walls, oracle, epoch
     counts, the evaluator); phase 15 then reads the same DAC checkpoint and
     .pth, and the .npz of the runbook's convert_vinvl stage;
 19. only with `--cards N` (after phase 1, in place of phases 2-18; fewer
     than N cards visible fails before the build): the parallel layer with
     one rank a card over NCCL (`multicard_phases`), at full width (STTran
     sgdet bf16, 1 + 3 layers, 8 heads, embed 1936, feat 2048, seeded,
     dropout off; phase 3's 64 videos x 32 frames, 64 / N a card), printing
     `nvidia-smi topo -m` and every card's name and power limit: (e) every
     kernel on every card cuda:0 .. N-1 from this process, the current
     device left at cuda:0 (phase 2's attention forward, dQ and dK/dV,
     RoIAlign at phase 9's 32-frame pass shape, the grouped conv at its
     four classes on the "tc" and "3xtf32" routes; routes printed); the
     one-process references on cuda:0 (3 STTran steps over all 64 videos,
     one DSG-DETR step on set (b)); then N spawned ranks (`p19_rank`,
     `p19_body`) held by `p19_verdicts`: each rank on NCCL on its own card,
     (a) mesh N x 1: 3 DDP steps against the references (P19_* tolerances,
     phase 16's and 17's), parameters and BatchNorm buffers equal on every
     rank, a NaN in rank 0's block skipped everywhere, one DSG-DETR DDP
     step on set (b), the bytes DDP all-reduces a step, the gradient's
     bytes all-reduced over NCCL (CUDA events) and over the gloo host group
     (median of P19_AR_REPS after a warm-up, bus bandwidth), NCCL's own log
     of its transports and tuning; (b) STTran's frame-sharded transformer
     (bf16, float32) and DSG-DETR's token-sharded one over the N ranks
     against the dense modules, no byte staged through the host; (c) 3
     sliced AdamW steps on each mesh of `p19_meshes` (N / 2 x 2, and 1 x N
     where `tensor.check_widths` admits it), the gathered state in the one
     process's layout, resident bytes a rank; (d) `run_training` on phase
     13's synthetic Action Genome with mesh.data -1 (it spawns a rank a
     card): bf16 for 2 epochs on 128 videos with the device store, then a
     store-off run and its resume from a copy of its epoch-0 checkpoint
     (`p19_resume`), then float32 on {data 2, model 2}, each rank's
     `distributed:` line on NCCL on its own card, merged R@20 = one
     evaluation of the checkpoint; the `kernels_multicard` line (each
     row's launches on the ranks' runs and its error on each card);
 20. the `kernels` JSON line (each row with `launches_entry_points`, phase
     14's launches, `launches_offline`, phase 15's, `launches_parallel`,
     phase 16's, `launches_model_axis`, phase 17's, `launches_acceptance`,
     phase 18's, and `launches_multicard`, 0: phase 19 runs only with
     `--cards`; the grouped conv has a bf16 row and a float32 row), then
     the device JSON line, last (with `--cards`, its `count` the cards
     visible); the lines before them print each phase's wall, the card and
     the script's total wall time.

float32 checks run with TF32 off (torch.backends.cudnn.allow_tf32 and
torch.backends.cuda.matmul.allow_tf32 set False at start): cuDNN would
otherwise run float32 convolutions in TF32. The bfloat16 path is the
serving configuration of bench.py.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
B, N_FRAMES, OBJS, N_BOXES, N_RELS, FEAT = 64, 32, 3, 128, 96, 2048
H, HEAD_DIM = 8, 242
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {"torch.bfloat16": 989e12,           # dense tensor-core bf16
            "torch.float32": 67e12}             # float32 outside the tensor cores
# kernel vs plain version on the same inputs:
#   float32: sums in another order + __expf -> |err| <= 1e-4
#   bfloat16: both round an fp32 result to bf16, so they may differ by one
#   bf16 ulp: |err| <= 2^-7 |ref| + 1e-3
KERNEL_TOL = {"torch.float32": (1e-4, 0.0), "torch.bfloat16": (1e-3, 2.0 ** -7)}
# gradients, kernel vs plain on the same inputs: float32 sums in another
# order over up to 192 keys of products of O(10) -> |err| <= 2e-4 + 1e-5 |ref|;
# bfloat16 as above (one rounding of an fp32 result on each side)
GRAD_TOL = {"torch.float32": (2e-4, 1e-5), "torch.bfloat16": (1e-3, 2.0 ** -7)}
# whole model, kernel path vs plain-attention path on the same weights:
#   float32: the same math in another order through 4 layers -> 1e-3
#   bfloat16: one-ulp attention differences carried through bf16
#   projections, LayerNorms and FFNs -> 5e-2 on logits and probabilities
MODEL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# parameter gradients of one train-mode forward and backward, kernel path vs
# plain-attention path, as ||g_kernel - g_plain|| / ||g_plain|| per tensor:
#   float32: reduction-order noise through 4 layers and their backward -> 1e-3
#   bfloat16: one-ulp attention differences in the forward and in dq/dk/dv,
#   carried through bf16 layers both ways -> 5e-2
TRAIN_GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
RATE = 0.1                                      # STTran's dropout
# the detector path (VinVL X152-C4): 480x800 BGR frames resize to 600x1000
# (bucket 608x1024, C4 map 38x64); the float32 kernel-vs-plain checks run on
# DET_CHECK_FRAMES frames, the bf16 server on two videos of DET_FRAMES
DET_FRAMES, DET_CHECK_FRAMES, DET_HW, UNION_BOXES = 32, 4, (480, 800), 96
# a detector kernel against its plain version in float32: sums in another
# order (16 products in RoIAlign, up to 9 * 64 in the conv) -> 1e-5 of the
# output's largest magnitude (bfloat16 as KERNEL_TOL)
DET_KERNEL_REL = 1e-5
# the float32 detector, kernel path vs plain path on the same weights and
# frames: the same math in another order through 50 residual blocks, the
# RPN and the C5 head -> 1e-4 of each tensor's largest magnitude
DET_PATH_TOL = 1e-4
# final detections, plain path's valid ones found in the kernel path's list
# (same frame and label, every corner within DET_MATCH_PX): random weights
# give near-tied candidate scores, so float32 noise may flip a few top-k or
# NMS decisions among them; at least 90% must match
DET_MATCH, DET_MATCH_PX = 0.9, 0.5
SLEEP_CYCLES = 50_000_000                       # about 25 ms at the H100's clocks
TRAIN_STEPS = 5
HEADS = ("attention_distribution", "spatial_distribution", "contacting_distribution",
         "distribution")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Device time per call: CUDA events around `iters` calls. A sleep
    kernel queued first keeps the card busy while the host queues the
    calls, so a call shorter than its Python wrapper is timed by its device
    work, not by the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def attention_bound_ms(q, k, v, allow, with_lse: bool = False) -> tuple[float, str]:
    """Least time for masked attention on these inputs: read q, k, v and
    the mask once, write out (and the fp32 lse) once; 4 * H * D operations
    per allowed (query, key) pair (two multiply-adds per dim)."""
    Bq, Lq, Hh, D = q.shape
    el = q.element_size()
    nbytes = (2 * Bq * Lq * Hh * D + 2 * k.shape[0] * k.shape[1] * Hh * D) * el + allow.numel()
    nbytes += Bq * Hh * Lq * 4 if with_lse else 0
    ops = 4.0 * Hh * D * float(allow.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_bwd_bound_ms(q, k, allow, kind: str) -> tuple[float, str]:
    """Least time for one backward kernel on these inputs. dQ reads q, k, v,
    g, the mask and lse and writes dq and r, with 6 * H * D operations per
    allowed pair (q.k, g.v, dS k); dK/dV reads q, k, v, g, the transposed
    mask, lse and r and writes dk and dv, with 8 * H * D (q.k, g.v, P~ g,
    dS q)."""
    Bq, Lq, Hh, D = q.shape
    el, Lk = q.element_size(), k.shape[1]
    rows_q, rows_k = Bq * Lq * Hh * D, Bq * Lk * Hh * D
    stats = Bq * Hh * Lq * 4
    if kind == "dq":
        nbytes = (2 * rows_q + 2 * rows_k + rows_q) * el + allow.numel() + 2 * stats
        ops = 6.0 * Hh * D * float(allow.sum())
    else:
        nbytes = (2 * rows_q + 2 * rows_k + 2 * rows_k) * el + allow.numel() + 2 * stats
        ops = 8.0 * Hh * D * float(allow.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_err(out, ref, tol=None) -> tuple[float, bool]:
    atol, rtol = (tol or KERNEL_TOL)[str(ref.dtype)]
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    return float(err.max()), bool((err <= atol + rtol * r.abs()).all()) and bool(o.isfinite().all())


def profile_table(fn, step_ms: float, label: str, n: int = 3) -> None:
    """Device time by kernel over `n` calls of `fn` (torch.profiler); a
    diagnostic: reports, never fails."""
    import torch
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        # kernel rows only: operator rows and user annotations on the device
        # (the optimizer's step) repeat their kernels' device time
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and not e.key.startswith("Optimizer.")),
                      key=lambda e: -e.self_device_time_total)
        dev_total = sum(e.self_device_time_total for e in rows)
        if dev_total <= 0:
            log(f"profile {label}: the profiler recorded no device time (not measured)")
            return
        per = dev_total / n / 1e3
        log(f"profile: {label}, kernel time {per:.3f} ms/step (busy "
            f"{per / step_ms * 100:.1f}% of the timed step); top kernels by self device time:")
        for e in rows[:14]:
            t = e.self_device_time_total
            log(f"  {t / dev_total * 100:5.1f}%  {t / n / 1e3:8.3f} ms/step  "
                f"{e.count // n:4d}/step  {e.key[:90]}")
    except Exception as ex:  # the profiler is a diagnostic: report, never fail
        log(f"profile {label}: unavailable ({ex!r})")


def device_busy(fn, label: str) -> dict | None:
    """One call of `fn` under torch.profiler, the card synchronized inside
    the traced span: the span's wall ms, the union of its kernel, copy and
    memset intervals on the card (busy ms), and kernel, host-to-device and
    device-to-host copy ms summed. A diagnostic: None, reported, where the
    trace holds no device events or the profiler fails; never fails."""
    import torch
    try:
        from torch.profiler import ProfilerActivity, profile, record_function
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("device_busy_span"):
                fn()
                torch.cuda.synchronize()
        path = os.path.join(HERE, "build", "device_busy_trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        span = next(e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == "device_busy_span")
        t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
        dev_ev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if not dev_ev:
            log(f"trace {label}: the profiler recorded no device events (not measured)")
            return None
        busy, end = 0.0, t0
        for a, b in sorted((max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1))
                           for e in dev_ev):
            if b > end:
                busy += b - max(a, end)
                end = b

        def total(cat, key=""):
            return sum(float(e["dur"]) for e in dev_ev
                       if e["cat"] == cat and key in e.get("name", "")) / 1e3
        return {"span_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
                "kernel_ms": total("kernel"), "htod_ms": total("gpu_memcpy", "HtoD"),
                "dtoh_ms": total("gpu_memcpy", "DtoH")}
    except Exception as ex:  # the trace is a diagnostic: report, never fail
        log(f"trace {label}: unavailable ({ex!r})")
        return None


def eval_kernel_checks(ma, g, dev, timed: bool = True, label: str = "") -> float:
    """Phase 2's eval forward against its plain version at the path's shapes
    (B videos, H heads of HEAD_DIM; 96x96, 192x192, 96x192; float32 and
    bfloat16; fully masked rows exactly 0), each call timed when `timed`;
    `label` prefixes each line (phase 19 (e): the card). Returns the largest
    error."""
    import torch
    scale = HEAD_DIM ** -0.5
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lk in ((96, 96), (192, 192), (96, 192)):
            q = torch.randn(B, lq, H, HEAD_DIM, device=dev, generator=g).to(dtype)
            kv = torch.randn(B, lk, 2 * H * HEAD_DIM, device=dev, generator=g).to(dtype)
            k = kv[..., :H * HEAD_DIM].unflatten(-1, (H, HEAD_DIM))  # strided, as on the path
            v = kv[..., H * HEAD_DIM:].unflatten(-1, (H, HEAD_DIM))
            allow = torch.rand(B, lq, lk, device=dev, generator=g) < 0.3
            allow[:, ::7] = False                    # fully masked rows
            out = ma.masked_mha(q, k, v, allow, scale)
            torch.cuda.synchronize(dev)
            err, ok = kernel_err(out, ma.masked_mha_reference(q, k, v, allow, scale))
            worst = max(worst, err)
            zero_rows = float(out[:, ::7].float().abs().max())
            if timed:
                kms = cuda_ms(lambda: ma.masked_mha(q, k, v, allow, scale))
                what = f"{kms:.4f} ms on dense random masks (every key tile live)"
            else:
                what = f"route {ma.fwd_route(q, k, v)}"
            log(f"{label}masked_mha {str(dtype)[6:]} {lq}x{lk}: max_abs_err {err:.3e} "
                f"(tol {KERNEL_TOL[str(dtype)]}), masked rows max |out| {zero_rows}, {what}")
            if not ok or zero_rows != 0.0:
                fail(f"{label}masked_mha disagrees with its plain version at {dtype} {lq}x{lk}")
    return worst


def train_kernel_checks(ma, g, dev, label: str = "") -> dict:
    """Phase 2's train forward (dropout rate 0 and RATE, with the
    log-sum-exp) and both backward kernels against their plain versions at
    the path's shapes, rows and key columns with no allowed pair exactly 0,
    and the autograd path against the wrappers; `label` prefixes each line
    and adds the routes. Returns the largest error by `kernels` row."""
    import torch
    # with dropout on, one pair whose keep bit differed from the plain
    # version's would move the output by about p |v|, far above the tolerance
    scale = HEAD_DIM ** -0.5
    rows = {"masked_mha_fwd_train": 0.0, "masked_mha_bwd_dq": 0.0, "masked_mha_bwd_dkv": 0.0}
    row_of = {"out": "masked_mha_fwd_train", "lse": "masked_mha_fwd_train",
              "dq": "masked_mha_bwd_dq", "r": "masked_mha_bwd_dq", "dk": "masked_mha_bwd_dkv",
              "dv": "masked_mha_bwd_dkv"}
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B,), generator=g, device=dev, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lk in ((96, 96), (192, 192), (96, 192)):
            q = torch.randn(B, lq, H, HEAD_DIM, device=dev, generator=g).to(dtype)
            kv = torch.randn(B, lk, 2 * H * HEAD_DIM, device=dev, generator=g).to(dtype)
            k = kv[..., :H * HEAD_DIM].unflatten(-1, (H, HEAD_DIM))
            v = kv[..., H * HEAD_DIM:].unflatten(-1, (H, HEAD_DIM))
            gout = torch.randn(B, lq, H, HEAD_DIM, device=dev, generator=g).to(dtype)
            allow = torch.rand(B, lq, lk, device=dev, generator=g) < 0.3
            allow[:, ::7] = False                    # rows with no allowed key
            allow[:, :, 5::11] = False               # keys no query may see
            allow_t = allow.transpose(1, 2).contiguous()
            for rate in (0.0, RATE):
                sd = seeds if rate else None
                out, lse = ma.masked_mha_forward(q, k, v, allow, scale, rate, sd)
                dq, r = ma.masked_mha_bwd_dq(q, k, v, allow, scale, gout, lse, rate, sd)
                dk, dv = ma.masked_mha_bwd_dkv(q, k, v, allow_t, scale, gout, lse, r, rate, sd)
                torch.cuda.synchronize(dev)
                what = f"{str(dtype)[6:]} {lq}x{lk} rate {rate}"
                errs = {}
                for name, got, ref, tol in (
                        ("out", out, ma.masked_mha_reference(q, k, v, allow, scale, rate, sd),
                         KERNEL_TOL),
                        ("lse", lse, ma.masked_mha_lse_reference(q, k, allow, scale), GRAD_TOL),
                        *zip(("dq", "r"), (dq, r),
                             ma.masked_mha_bwd_dq_reference(q, k, v, allow, scale, gout, rate,
                                                            sd), (GRAD_TOL, GRAD_TOL)),
                        *zip(("dk", "dv"), (dk, dv),
                             ma.masked_mha_bwd_dkv_reference(q, k, v, allow, scale, gout, r,
                                                             rate, sd), (GRAD_TOL, GRAD_TOL))):
                    errs[name], ok = kernel_err(got, ref, tol)
                    rows[row_of[name]] = max(rows[row_of[name]], errs[name])
                    if not ok:
                        fail(f"{label}train kernels: {name} disagrees with its plain version at "
                             f"{what} (max_abs_err {errs[name]:.3e})")
                empty = [float(t.float().abs().max()) for t in
                         (out[:, ::7], dq[:, ::7], dk[:, 5::11], dv[:, 5::11])]
                if any(empty) or not bool((lse.transpose(1, 2)[:, ::7] == ma.LSE_EMPTY).all()):
                    fail(f"{label}train kernels: rows or keys with no allowed pair are not 0 at "
                         f"{what}")
                # the autograd path launches the same kernels on the same inputs
                q2, kv2 = q.detach().requires_grad_(), kv.detach().requires_grad_()
                k2 = kv2[..., :H * HEAD_DIM].unflatten(-1, (H, HEAD_DIM))
                v2 = kv2[..., H * HEAD_DIM:].unflatten(-1, (H, HEAD_DIM))
                ma.masked_mha(q2, k2, v2, allow, scale, rate, sd).backward(gout)
                same = (torch.equal(q2.grad, dq)
                        and torch.equal(kv2.grad, torch.cat([dk, dv], -2).flatten(-2)))
                if not same:
                    fail(f"{label}train kernels: the autograd path differs from the wrappers at "
                         f"{what}")
                routes = (f"; routes fwd {ma.fwd_route(q, k, v)}, dq "
                          f"{ma.dq_route(q, k, v, gout)}, dkv {ma.dkv_route(q, k, v, gout)}"
                          if label else "")
                log(f"{label}train kernels {what}: max_abs_err " + ", ".join(
                    f"{n} {e:.3e}" for n, e in errs.items()) + "; empty rows/keys exactly 0"
                    + routes)
    return rows


def dq_edge_checks(ma, g, dev) -> None:
    """Phase 2's dQ edge cases, each against the plain version (dq and r to
    GRAD_TOL, rows with no allowed key exactly 0), dropout off and on, with
    the route the wrapper took: a 192x192 mask at the path's 3% with some
    rows fully allowed (more keys than one cp.async chunk) and some empty;
    a view 2 bytes off 16-byte alignment; odd D = 241 at 8 and at 4 heads;
    8 heads of 240; 3 heads of 242 and of 64."""
    import torch
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B,), generator=g, device=dev, dtype=torch.int32)
    cases = (("192x192 full and empty rows", 192, H, HEAD_DIM, 0, "staged"),
             ("misaligned view", 96, H, HEAD_DIM, 1, "per-element"),
             ("odd D, 8 heads", 96, H, 241, 0, "per-element"),
             ("8 heads of 240", 96, H, 240, 0, "staged"),
             ("odd D, 4 heads", 96, 4, 241, 0, "per-element"),
             ("3 heads of 242", 96, 3, HEAD_DIM, 0, "per-element"),
             ("3 heads of 64", 96, 3, 64, 0, "staged"))
    for what, L, Hh, D, pad, want in cases:
        E = Hh * D
        x = torch.randn(B, L, 3 * E + pad, device=dev, generator=g).bfloat16()[..., pad:]
        q, k, v = (x[..., i * E:(i + 1) * E].unflatten(-1, (Hh, D)) for i in range(3))
        gout = torch.randn(B, L, Hh, D, device=dev, generator=g).bfloat16()
        allow = torch.rand(B, L, L, device=dev, generator=g) < 0.03
        allow[:, ::9] = True                      # fully allowed rows
        allow[:, 4::9] = False                    # rows with no allowed key
        route = ma.dq_route(q, k, v, gout)
        if route != want:
            fail(f"dQ {what}: route {route}, expected {want}")
        scale = D ** -0.5
        errs = []
        for rate in (0.0, RATE):
            sd = seeds if rate else None
            _, lse = ma.masked_mha_forward(q, k, v, allow, scale, rate, sd)
            dq, r = ma.masked_mha_bwd_dq(q, k, v, allow, scale, gout, lse, rate, sd)
            torch.cuda.synchronize()
            ref_dq, ref_r = ma.masked_mha_bwd_dq_reference(q, k, v, allow, scale, gout, rate, sd)
            for name, got, ref in (("dq", dq, ref_dq), ("r", r, ref_r)):
                err, ok = kernel_err(got, ref, GRAD_TOL)
                errs.append(f"{name} rate {rate} {err:.3e}")
                if not ok:
                    fail(f"dQ {what} ({route}): {name} disagrees with its plain version at rate "
                         f"{rate} (max_abs_err {err:.3e})")
            if float(dq[:, 4::9].float().abs().max()) != 0.0:
                fail(f"dQ {what}: rows with no allowed key are not 0")
        log(f"bwd_dq {what} {(B, L, Hh, D)} x Lk={L}: route {route}; max_abs_err "
            + ", ".join(errs) + "; empty rows exactly 0")



def path_mask(b, lq, lk, dev):
    """The path's mask structure at (b, lq, lk): query i in frame i // 3, key
    j in window (j // 3) mod ceil(lq / 3), allowed when they agree (the
    spatial mask at lq = lk, two frames' keys a window at lk = 2 lq,
    queries with no window at lq > lk)."""
    import torch
    fq = torch.arange(lq, device=dev) // 3
    fk = (torch.arange(lk, device=dev) // 3) % -(-lq // 3)
    return (fq[:, None] == fk[None, :]).expand(b, lq, lk).clone()


# (what, Lq, Lk, heads, head dim, columns off 16 bytes, mask, route): the
# edges of the forward and dK/dV routes, as tests/test_torch_kernels_gpu.py
ROUTE_EDGES = (("frames 96x96", 96, 96, H, HEAD_DIM, 0, "frames", "staged"),
               ("frames 192x192", 192, 192, H, HEAD_DIM, 0, "frames", "staged"),
               ("frames 96x192", 96, 192, H, HEAD_DIM, 0, "frames", "staged"),
               ("frames 192x96", 192, 96, H, HEAD_DIM, 0, "frames", "staged"),
               ("random 192x192", 192, 192, H, HEAD_DIM, 0, "random", "staged"),
               ("random 97x101", 97, 101, H, HEAD_DIM, 0, "random", "staged"),
               ("random 1x5", 1, 5, H, HEAD_DIM, 0, "random", "staged"),
               ("3 heads of 64", 96, 96, 3, 64, 0, "random", "staged"),
               ("misaligned view", 96, 96, H, HEAD_DIM, 1, "random", "per-element"),
               ("odd D", 97, 96, H, 241, 0, "random", "per-element"),
               ("3 heads of 242", 96, 96, 3, HEAD_DIM, 0, "random", "per-element"))


def route_edge_checks(ma, g, dev) -> None:
    """Phase 2's edge cases of the forward and dK/dV routes, each against
    its plain version with the route the wrapper took and one launch a
    call: path-structured and random 3% masks (some query rows fully
    allowed, some empty, some key columns empty), tiles that do not divide
    Lq or Lk, 96x192 and 192x96, 3 heads, odd D, a view 2 bytes off 16-byte
    alignment; dropout off and on, the forward with and without lse. out
    to KERNEL_TOL, lse, dk and dv to GRAD_TOL; rows and key columns with no
    allowed pair exactly 0 (lse LSE_EMPTY)."""
    import torch
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B,), generator=g, device=dev, dtype=torch.int32)
    for what, lq, lk, Hh, D, pad, mask, want in ROUTE_EDGES:
        E = Hh * D
        xq = torch.randn(B, lq, 3 * E + pad, device=dev, generator=g).bfloat16()[..., pad:]
        xk = torch.randn(B, lk, 3 * E + pad, device=dev, generator=g).bfloat16()[..., pad:]
        q = xq[..., :E].unflatten(-1, (Hh, D))
        k, v = (xk[..., i * E:(i + 1) * E].unflatten(-1, (Hh, D)) for i in (1, 2))
        gout = torch.randn(B, lq, Hh, D, device=dev, generator=g).bfloat16()
        if mask == "frames":
            allow = path_mask(B, lq, lk, dev)
        else:
            allow = torch.rand(B, lq, lk, device=dev, generator=g) < 0.03
            allow[:, ::9] = True
            allow[:, 4::9] = False
            allow[:, :, 5::11] = False
        routes = (ma.fwd_route(q, k, v), ma.dkv_route(q, k, v, gout))
        if routes != (want, want):
            fail(f"{what}: forward and dK/dV routes {routes}, expected {want}")
        empty, unseen = ~allow.any(-1), ~allow.any(1)
        allow_t = allow.transpose(1, 2).contiguous()
        scale = D ** -0.5
        errs = {}
        for rate in (0.0, RATE):
            sd = seeds if rate else None
            for with_lse in (False, True):
                ma.reset_launches()
                out, lse = ma.masked_mha_forward(q, k, v, allow, scale, rate, sd, with_lse)
                torch.cuda.synchronize()
                checks = [("out", out, ma.masked_mha_reference(q, k, v, allow, scale, rate, sd),
                           KERNEL_TOL)]
                if with_lse:
                    checks.append(("lse", lse, ma.masked_mha_lse_reference(q, k, allow, scale),
                                   GRAD_TOL))
                    if not bool((lse.transpose(1, 2)[empty] == ma.LSE_EMPTY).all()):
                        fail(f"forward {what}: rows with no allowed key lack the lse sentinel")
                if ma.LAUNCHES["fwd"] != 1 or not bool((out[empty] == 0).all()):
                    fail(f"forward {what}: launches {ma.LAUNCHES} or empty rows not 0")
                for name, got, ref, tol in checks:
                    err, ok = kernel_err(got, ref, tol)
                    errs[name] = max(errs.get(name, 0.0), err)
                    if not ok:
                        fail(f"forward {what} ({want}): {name} disagrees with its plain version "
                             f"at rate {rate} (max_abs_err {err:.3e})")
            _, r = ma.masked_mha_bwd_dq(q, k, v, allow, scale, gout, lse, rate, sd)
            ma.reset_launches()
            dk, dv = ma.masked_mha_bwd_dkv(q, k, v, allow_t, scale, gout, lse, r, rate, sd)
            torch.cuda.synchronize()
            ref_dk, ref_dv = ma.masked_mha_bwd_dkv_reference(q, k, v, allow, scale, gout, r,
                                                             rate, sd)
            if ma.LAUNCHES["bwd_dkv"] != 1 or not bool((dk[unseen] == 0).all()
                                                       and (dv[unseen] == 0).all()):
                fail(f"dK/dV {what}: launches {ma.LAUNCHES} or unseen key rows not 0")
            for name, got, ref in (("dk", dk, ref_dk), ("dv", dv, ref_dv)):
                err, ok = kernel_err(got, ref, GRAD_TOL)
                errs[name] = max(errs.get(name, 0.0), err)
                if not ok:
                    fail(f"dK/dV {what} ({want}): {name} disagrees with its plain version at "
                         f"rate {rate} (max_abs_err {err:.3e})")
        log(f"fwd / bwd_dkv {what} {(B, lq, Hh, D)} x Lk={lk}: routes {want}; max_abs_err "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + "; empty rows and unseen keys exactly 0, one launch a call")


def train_grads(model, batch, seed: int, dev) -> dict:
    """Parameter gradients of one train-mode forward and backward (the
    train step's loss), BatchNorm updates dropped."""
    import torch

    from nl_vsgg_tpu_torch.models.layers import MaskedBatchNorm
    from nl_vsgg_tpu_torch.models.losses import sttran_losses
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.zero_grad(set_to_none=True)
    per_video = sttran_losses(model(batch, train=True, generator=gen), batch, gen)
    w = batch.box_mask.any(-1).float()
    (torch.where(w > 0, per_video["total"] * w, 0.0).sum() / w.sum().clamp(min=1.0)).backward()
    for mod in model.modules():
        if isinstance(mod, MaskedBatchNorm):
            mod.discard()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return grads


def compare_grads(ker: dict, pln: dict, what: str, tol: float) -> tuple[float, str, int]:
    """Worst ||g_kernel - g_plain|| / ||g_plain|| over the parameters, its
    parameter and how many denominators the floor below raised; fails
    past `tol`, on non-finite kernel gradients or different parameter sets.
    A gradient that is 0 in exact arithmetic is rounding noise on both
    paths (a bias whose output a train-mode BatchNorm re-centres, as the
    sgcls tracklet head's `decoder_fc1.bias` and its last LayerNorm's bias:
    about 1e-8 against norms of 0.1-7), so the denominator is at least 1e-6
    of the largest gradient norm."""
    if ker.keys() != pln.keys():
        fail(f"{what}: the two paths gave gradients to different parameters")
    floor = 1e-6 * max(float(g.norm()) for g in pln.values())
    worst, worst_name, floored = 0.0, "", 0
    for name, gp in pln.items():
        gk = ker[name]
        if not bool(gk.isfinite().all()):
            fail(f"{what} gradient {name} is not finite")
        floored += float(gp.norm()) < floor
        rel = float((gk - gp).norm() / gp.norm().clamp(min=max(floor, 1e-30)))
        if rel > worst:
            worst, worst_name = rel, name
    if worst > tol:
        fail(f"{what}: kernel path differs from plain by {worst} at {worst_name}")
    return worst, worst_name, floored


# ---------------------------------------------------------------- detector
def rel_err(out, ref) -> float:
    """max |out - ref| over the largest |ref|."""
    o, r = out.float(), ref.float()
    return float((o - r).abs().max() / r.abs().max().clamp(min=1e-30))


def det_kernel_err(out, ref) -> tuple[float, bool]:
    """A detector kernel against its plain version: float32 within
    DET_KERNEL_REL of the output's largest magnitude; bfloat16 as
    KERNEL_TOL (one rounding of an fp32 sum on each side)."""
    if str(ref.dtype) == "torch.float32":
        err = float((out - ref).abs().max())
        ok = err <= DET_KERNEL_REL * float(ref.abs().max()) and bool(out.isfinite().all())
        return err, ok
    return kernel_err(out, ref)


def detector_weights(seed: int, dev) -> dict:
    """Random full-width AttrRCNN weights from a generator on the card
    (`detector.attr_rcnn.random_state_dict`): convs at fan-in scale (He),
    the residual branches' last FrozenBN scales (bn3, downsample) 0.2 so
    that the C4 map stays O(1) through 50 blocks, other FrozenBN scales 1,
    biases 0, predictor weights N(0, 0.01^2)."""
    from nl_vsgg_tpu_torch.detector.attr_rcnn import random_state_dict
    return random_state_dict(seed, dev)


def path_rois(g, n_frames: int, per_frame: int, H: int, W: int, dev):
    """(rois (R, 4), frame_idx (R,)) in image coordinates of an (H, W) C4
    map at stride 16: random boxes, and in each frame a degenerate, a
    fully outside, a whole-map and a past-the-edge roi."""
    import torch
    rois = []
    for _ in range(n_frames):
        xy = torch.rand(per_frame, 2, generator=g, device=dev) * torch.tensor(
            [W * 16.0, H * 16.0], device=dev)
        wh = 8 + torch.rand(per_frame, 2, generator=g, device=dev) * 400
        r = torch.cat([xy - 20, xy + wh], 1)
        r[:4] = torch.tensor([[0, 0, 0, 0], [-500, -500, -400, -400],
                              [0, 0, W * 16 - 1, H * 16 - 1],
                              [W * 16 - 8, H * 16 - 8, W * 16 + 40, H * 16 + 40]], device=dev)
        rois.append(r)
    fidx = torch.arange(n_frames, device=dev, dtype=torch.int32).repeat_interleave(per_frame)
    return torch.cat(rois), fidx


def edge_rois(H: int, W: int, dev):
    """Rois at the RoIAlign kernel's edges on an (H, W) map at stride 16:
    the whole map and beyond it, wholly outside on each side (indices 2-5),
    degenerate and inverted, past the far edge, one row tall, straddling
    each border."""
    import torch
    w, h = W * 16.0, H * 16.0
    return torch.tensor([[0, 0, w - 1, h - 1], [-16, -16, w + 15, h + 15],
                         [-500, -500, -400, -400], [w + 40, 10, w + 90, 50],
                         [10, h + 40, 50, h + 90], [10, -90, 50, -40],
                         [0, 0, 0, 0], [30, 20, 29, 19], [w - 8, h - 8, w + 40, h + 40],
                         [5, 33, w - 5, 34], [-30, 20, 40, 60], [w - 40, 20, w + 30, 60],
                         [20, -30, 60, 40], [20, h - 40, 60, h + 30]], device=dev)


def roi_align_edge_checks(ra, g, dev) -> None:
    """Phase 7's RoIAlign edge cases on (4, 38, 64, C) maps, each against the
    plain version (DET_KERNEL_REL in float32, one bf16 ulp in bfloat16),
    wholly outside rois exactly 0: the edge rois beside 300 random ones in
    random frame order, at S = 1, 2 and 4; C = 1020 (the scalar route) and
    C = 1000 (a multiple of 8: the vector route); a map 2 bytes off 16-byte
    alignment (scalar); a single roi over the whole map."""
    import torch
    Hm, Wm = 38, 64
    edges = edge_rois(Hm, Wm, dev)
    rand, _ = path_rois(g, 1, 300, Hm, Wm, dev)
    rois = torch.cat([edges, rand])
    fidx = torch.randint(0, DET_CHECK_FRAMES, (rois.shape[0],), generator=g, device=dev,
                         dtype=torch.int32)
    base = torch.randn(DET_CHECK_FRAMES * Hm * Wm * 1024 + 8, generator=g, device=dev)
    cases = [(1024, torch.bfloat16, S, 0, rois, fidx) for S in (1, 2, 4)]
    cases += [(1024, torch.float32, 2, 0, rois, fidx), (1020, torch.float32, 2, 0, rois, fidx),
              (1020, torch.bfloat16, 2, 0, rois, fidx), (1000, torch.bfloat16, 2, 0, rois, fidx),
              (1024, torch.bfloat16, 2, 1, rois, fidx),
              (1024, torch.bfloat16, 2, 0, edges[:1], fidx[:1])]
    for C, dtype, S, off, r, fi in cases:
        fm = base.to(dtype)[off:off + DET_CHECK_FRAMES * Hm * Wm * C].view(
            DET_CHECK_FRAMES, Hm, Wm, C)
        route = ra.kernel_plan(C, (14, 14), S, aligned=fm.data_ptr() % 16 == 0)["route"]
        out = ra.roi_align(fm, r, fi, (14, 14), 1 / 16, S)
        torch.cuda.synchronize()
        err, ok = det_kernel_err(out, ra.roi_align_reference(fm, r, fi, (14, 14), 1 / 16, S))
        outside = float(out[2:6].float().abs().max()) if r.shape[0] > 6 else 0.0
        log(f"roi_align edges {str(dtype)[6:]} C={C} S={S} {r.shape[0]} rois"
            f"{' (map 2 bytes off)' if off else ''}, random frame order: route {route}, "
            f"max_abs_err {err:.3e}, outside rois max |out| {outside}")
        if not ok or outside != 0.0:
            fail(f"roi_align edge case disagrees with its plain version: {dtype} C={C} S={S}")


# the grouped conv's four geometry classes on the detector path (c = 8, 16,
# 32 and 64 channels a group), then the edges of the bf16 kernel's tiles: a
# crop count not a multiple of its 5 crops, a width not a multiple of its 64
# columns
CONV_CLASSES = ((DET_CHECK_FRAMES, 152, 256, 256), (DET_CHECK_FRAMES, 76, 128, 512),
                (DET_CHECK_FRAMES, 38, 64, 1024), (DET_CHECK_FRAMES * 300, 7, 7, 2048))
CONV_EDGES = ((1201, 7, 7, 2048), (DET_CHECK_FRAMES, 38, 50, 1024))


def roi_align_checks(ra, g, dev, frames: int, label: str = "") -> float:
    """RoIAlign against its plain version on a (frames, 38, 64, 1024) C4
    map with 300 rois a frame (`path_rois`), float32 and bfloat16, the fully
    outside roi exactly 0; `label` prefixes each line. Returns the largest
    error."""
    import torch
    fmap = torch.randn(frames, 38, 64, 1024, generator=g, device=dev)
    rois, fidx = path_rois(g, frames, 300, 38, 64, dev)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        fm = fmap.to(dtype)
        out = ra.roi_align(fm, rois, fidx, (14, 14), 1 / 16)
        torch.cuda.synchronize(dev)
        err, ok = det_kernel_err(out, ra.roi_align_reference(fm, rois, fidx, (14, 14), 1 / 16))
        worst = max(worst, err)
        outside = float(out[1].float().abs().max())
        route = ra.kernel_plan(1024, (14, 14), 2, fm.data_ptr() % 16 == 0)["route"]
        log(f"{label}roi_align {str(dtype)[6:]} ({frames}, 38, 64, 1024) x "
            f"{rois.shape[0]} rois 14x14: max_abs_err {err:.3e}, fully outside roi max |out| "
            f"{outside}" + (f", route {route}" if label else ""))
        if not ok or outside != 0.0:
            fail(f"{label}roi_align disagrees with its plain version at {dtype}")
    return worst


def grouped_conv_checks(gc, g, dev, shapes, label: str = "") -> tuple:
    """The grouped 3x3 conv against its plain version at each (N, H, W, C)
    of `shapes` (32 groups), float32 on the 3xtf32 route, bfloat16 on the tc
    route and bfloat16 in with a float32 output, with and without the bias
    + ReLU epilogue, each call's route printed (another route fails);
    `label` prefixes each line. Returns the last (x, w) and the largest
    error by `kernels` row (bf16 in: grouped_conv3x3, float32:
    grouped_conv3x3_fp32)."""
    import torch
    worst = {"grouped_conv3x3": 0.0, "grouped_conv3x3_fp32": 0.0}
    for N, Hc, Wc, C in shapes:
        c = C // 32
        x32 = torch.randn(N, Hc, Wc, C, generator=g, device=dev)
        w32 = torch.randn(3, 3, c, C, generator=g, device=dev) * (9 * c) ** -0.5
        bias = torch.randn(C, generator=g, device=dev)
        for dtype, out_dtype in ((torch.float32, None), (torch.bfloat16, None),
                                 (torch.bfloat16, torch.float32)):
            x, w = x32.to(dtype), w32.to(dtype)
            route = gc.conv_route(x, w)
            if route != ("tc" if dtype == torch.bfloat16 else "3xtf32"):
                fail(f"{label}grouped_conv3x3 {dtype} ({N}, {Hc}, {Wc}, {C}) takes route {route}")
            row = "grouped_conv3x3" if dtype == torch.bfloat16 else "grouped_conv3x3_fp32"
            for b, relu in ((None, False), (bias, True)):
                out = gc.grouped_conv3x3(x, w, 32, b, relu, out_dtype)
                torch.cuda.synchronize(dev)
                err, ok = det_kernel_err(out, gc.grouped_conv3x3_reference(x, w, 32, b, relu,
                                                                           out_dtype))
                worst[row] = max(worst[row], err)
                log(f"{label}grouped_conv3x3 {str(dtype)[6:]} -> {str(out.dtype)[6:]} ({N}, "
                    f"{Hc}, {Wc}, {C}) c={c} bias+relu={relu}: route {route}, max_abs_err "
                    f"{err:.3e}")
                if not ok:
                    fail(f"{label}grouped_conv3x3 disagrees with its plain version at {dtype} -> "
                         f"{out.dtype} ({N}, {Hc}, {Wc}, {C}) relu={relu}")
    return x, w, worst


# TF32 on the tensor cores of one H100 SXM: the card's fastest rate for
# float32 inputs, where the 3xtf32 route forms each product as three
PEAK_TF32 = 495e12


def fma_conv(x, w, groups, bias=None, relu=False, out_dtype=None):
    """The first float32 grouped-conv kernel (route "fma", scalar FMAs on
    the CUDA cores) through its own C entry, as the wrapper launches a
    route: phase 9 times it beside the 3xtf32 route, which the path takes."""
    import torch

    from nl_vsgg_tpu_torch.ops import grouped_conv as gc
    x, w = x.contiguous(), w.contiguous()
    N, H, W, C = x.shape
    out = torch.empty(x.shape, dtype=out_dtype or x.dtype, device=x.device)
    b = None if bias is None else bias.float().contiguous()
    rc = gc._fn("fma")(gc._DTYPES[out.dtype], x.data_ptr(), w.data_ptr(),
                       None if b is None else b.data_ptr(), out.data_ptr(), N, H, W, C,
                       C // groups, int(relu), 0, 0, 0, 0,
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail(f"the fma grouped-conv entry failed at {tuple(x.shape)}: cudaError {rc}")
    return out


def fp32_conv_phase(det32, video, card) -> dict:
    """Phase 9's float32 block: full-width float32 `detect_video`s of a
    32-frame video on each grouped-conv route (3xtf32, the path's, and the
    first kernel, fma, patched in; host clock after a warm-up, three each
    in turns, with cuDNN's TF32 on as `preprocess features` runs it, at
    PyTorch's default), then its 47 grouped-conv calls recorded, each held
    to its plain version (DET_KERNEL_REL, TF32 off) on the 3xtf32 route and
    on the fma entry, and one call a shape class timed on both, the plain
    version and cuDNN `F.conv2d(groups=32)` with TF32 off (the same function
    at the same accuracy) and on (PyTorch's default, about 3 digits). The
    bound is the function's: its bytes, or its 18 c operations an output
    element at TF32's rate, the card's fastest for float32 inputs; the
    CUDA-core term and the 3xtf32 design's own (three TF32 products) are
    logged beside it. Returns the `kernels` row of the float32 route."""
    import torch
    import torch.nn.functional as F

    import nl_vsgg_tpu_torch.detector.resnet as dresnet
    from nl_vsgg_tpu_torch.ops import grouped_conv as gc

    orig = dresnet.grouped_conv3x3
    torch.backends.cudnn.allow_tf32 = True                   # the CLI's default
    det32.detect_video(video[:2])                            # warm-up, both routes
    dresnet.grouped_conv3x3 = fma_conv
    try:
        det32.detect_video(video[:2])
    finally:
        dresnet.grouped_conv3x3 = orig
    video_ms = {"3xtf32": [], "fma": []}
    for route in ("3xtf32", "fma", "fma", "3xtf32", "3xtf32", "fma"):
        gc.reset_launches()
        dresnet.grouped_conv3x3 = orig if route == "3xtf32" else fma_conv
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = det32.detect_video(video)
            video_ms[route].append((time.perf_counter() - t0) * 1e3)
        finally:
            dresnet.grouped_conv3x3 = orig
        want = {**dict.fromkeys(gc.ROUTES, 0), "3xtf32": 47 if route == "3xtf32" else 0}
        if dict(gc.ROUTE_LAUNCHES) != want or len(out) != len(video):
            fail(f"fp32 detect_video on the {route} route launched {dict(gc.ROUTE_LAUNCHES)}, "
                 f"expected {want}")
        if route == "3xtf32":
            launches = gc.ROUTE_LAUNCHES["3xtf32"]
    torch.backends.cudnn.allow_tf32 = False
    for route, ms in video_ms.items():
        log(f"detect_video fp32 (cuDNN TF32 on), grouped convs on {route}: "
            f"{[round(t, 3) for t in ms]} ms per video of {len(video)} frames (host clock), "
            f"{len(ms) * len(video) / sum(ms) * 1e3:.1f} frames/s")

    # the pass's 47 calls, each against its plain version; one a class kept
    classes = {}

    def rec(x, w, groups, bias=None, relu=False, out_dtype=None):
        out = orig(x, w, groups, bias, relu, out_dtype)
        ref = gc.grouped_conv3x3_reference(x, w, groups, bias, relu, out_dtype)
        err, ok = det_kernel_err(out, ref)
        fma_err, fma_ok = det_kernel_err(fma_conv(x, w, groups, bias, relu, out_dtype), ref)
        if not ok or not fma_ok:
            fail(f"fp32 grouped_conv3x3 disagrees with its plain version on path inputs "
                 f"{tuple(x.shape)} (max_abs_err 3xtf32 {err:.3e}, fma {fma_err:.3e})")
        key = (tuple(x.shape), groups, relu, bias is not None)
        if key not in classes:
            classes[key] = [0, 0.0, 0.0, (x.clone(), w.clone(), None if bias is None else
                                          bias.clone())]
        classes[key][0] += 1
        classes[key][1] = max(classes[key][1], err)
        classes[key][2] = max(classes[key][2], fma_err)
        return out

    dresnet.grouped_conv3x3 = rec
    try:
        det32.detect_video(video)
    finally:
        dresnet.grouped_conv3x3 = orig
    if sum(v[0] for v in classes.values()) != 47:
        fail(f"recorded {sum(v[0] for v in classes.values())} fp32 grouped convs in a pass")

    keys = ("ms", "fma_ms", "plain_ms", "library_ms", "library_tf32_ms", "bytes_ms",
            "ops_ms", "fma_bound_ms", "tf32_bound_ms")
    row = dict.fromkeys(keys, 0.0)
    row["max_abs_err"] = row["fma_max_abs_err"] = 0.0
    for (shape, groups, relu, _), (n, err, fma_err, (x, w, b)) in classes.items():
        c = shape[3] // groups
        if gc.conv_route(x, w) != "3xtf32":
            fail(f"fp32 grouped conv {shape} off the 3xtf32 route")
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        t = {"ms": cuda_ms(lambda: gc.grouped_conv3x3(x, w, groups, b, relu), iters=3,
                           warmup=1),
             "fma_ms": cuda_ms(lambda: fma_conv(x, w, groups, b, relu), iters=2, warmup=1),
             "plain_ms": cuda_ms(lambda: gc.grouped_conv3x3_reference(x, w, groups, b, relu),
                                 iters=2, warmup=1)}
        for tf32, key in ((False, "library_ms"), (True, "library_tf32_ms")):
            torch.backends.cudnn.allow_tf32 = tf32
            t[key] = cuda_ms(lambda: F.conv2d(xl, wl, b, padding=1, groups=groups), iters=3,
                             warmup=1)
        torch.backends.cudnn.allow_tf32 = False
        ops = 18.0 * c * x.numel()
        t["bytes_ms"] = ((2 * x.numel() + w.numel() + shape[3]) * 4) / HBM_BYTES_PER_S * 1e3
        t["ops_ms"] = ops / PEAK_TF32 * 1e3
        t["fma_bound_ms"] = ops / PEAK_OPS["torch.float32"] * 1e3
        t["tf32_bound_ms"] = 3 * ops / PEAK_TF32 * 1e3
        for key in keys:
            row[key] += n * t[key]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["fma_max_abs_err"] = max(row["fma_max_abs_err"], fma_err)
        log(f"grouped_conv3x3 fp32 {shape} x {n}: 3xtf32 {n * t['ms']:.4f} ms "
            f"({n * ops / (n * t['ms']) / 1e9:.1f} TFLOP/s of fp32 work), fma (first kernel) "
            f"{n * t['fma_ms']:.4f}, plain {n * t['plain_ms']:.4f}, cuDNN TF32 off "
            f"{n * t['library_ms']:.4f}, cuDNN TF32 on {n * t['library_tf32_ms']:.4f}; bound "
            f"bytes {n * t['bytes_ms']:.4f}, operations at TF32's rate {n * t['ops_ms']:.4f}; "
            f"CUDA-core operations {n * t['fma_bound_ms']:.4f}, three TF32 products "
            f"{n * t['tf32_bound_ms']:.4f} ms; max_abs_err 3xtf32 {err:.3e}, fma {fma_err:.3e} "
            f"(sums over the pass's {n} calls)")
    bound = max(row["bytes_ms"], row["ops_ms"])
    per_video = sum(video_ms["3xtf32"]) / len(video_ms["3xtf32"])
    log(f"per fp32 pass (47 calls): 3xtf32 {row['ms']:.3f} ms "
        f"({row['ms'] / per_video * 100:.1f}% of the {per_video:.3f} ms fp32 video), fma "
        f"{row['fma_ms']:.3f}, plain {row['plain_ms']:.3f}, cuDNN TF32 off "
        f"{row['library_ms']:.3f}, on {row['library_tf32_ms']:.3f}; bound {bound:.3f} ms "
        f"(bytes {row['bytes_ms']:.3f}, operations at TF32's rate {row['ops_ms']:.3f}); "
        f"CUDA-core operations {row['fma_bound_ms']:.3f}, the 3xtf32 design's three TF32 "
        f"products {row['tf32_bound_ms']:.3f}; max_abs_err 3xtf32 {row['max_abs_err']:.3e}, "
        f"fma {row['fma_max_abs_err']:.3e}; card {card}")
    return {
        "name": "grouped_conv3x3_fp32", "route": "cuda",
        "source": "nl_vsgg_tpu_torch/csrc/grouped_conv.cu",
        "replaces": "nl_vsgg_tpu/ops/pallas_grouped_conv.py:148",
        "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": bound,
        "bound_by": "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations",
        "algorithm_bound_ms": row["tf32_bound_ms"], "library_ms": row["library_ms"],
        "library_tf32_ms": row["library_tf32_ms"], "fma_ms": row["fma_ms"],
        "fma_max_abs_err": row["fma_max_abs_err"], "video_ms": video_ms,
    }


def detector_phases(dev, card) -> list[dict]:
    """Phases 7-9: the detector kernels against their plain versions, the
    detector path (fp32 kernel vs plain, bf16 serving), the kernels timed on
    the path's own inputs. Returns the bf16 detector (phase 13's union
    features reuse it) and the two `kernels` rows."""
    import torch
    import torch.nn.functional as F

    import nl_vsgg_tpu_torch.detector.resnet as dresnet
    import nl_vsgg_tpu_torch.detector.roi_box as droi
    from nl_vsgg_tpu_torch.detector.attr_rcnn import AttrRCNNTorch
    from nl_vsgg_tpu_torch.detector.anchors import grid_anchors
    from nl_vsgg_tpu_torch.detector.rpn import select_proposals
    from nl_vsgg_tpu_torch.ops import grouped_conv as gc, roi_align as ra

    def reset():
        ra.reset_launches()
        gc.reset_launches()

    def launches():
        return {"roi_align": ra.LAUNCHES["roi_align"],
                "grouped_conv3x3": gc.launches()}

    # ---- 7. detector kernels vs plain versions at the path's shapes ----
    g = torch.Generator(device=dev).manual_seed(3)
    roi_align_checks(ra, g, dev, DET_CHECK_FRAMES)
    roi_align_edge_checks(ra, g, dev)
    x, w, _ = grouped_conv_checks(gc, g, dev, CONV_CLASSES + CONV_EDGES)
    flat = torch.zeros(1 + x.numel(), device=dev, dtype=torch.bfloat16)
    try:
        gc.grouped_conv3x3(flat[1:].view(x.shape), w, 32)
        fail("grouped_conv3x3 took bf16 storage that is not 16-byte aligned")
    except ValueError:
        log("grouped_conv3x3 bf16: storage 2 bytes off 16-byte alignment refused")
    del x, w, flat

    # ---- 8. the detector path at full width ----
    t0 = time.perf_counter()
    sd = detector_weights(5, dev)
    rng = np.random.default_rng(2000)
    videos = [[rng.integers(0, 256, (*DET_HW, 3), dtype=np.uint8) for _ in range(DET_FRAMES)]
              for _ in range(2)]
    det32 = AttrRCNNTorch(sd, device=dev)
    plain32 = AttrRCNNTorch(sd, device=dev, fused=False)
    log(f"detector: VinVL X152-C4, {sum(v.numel() for v in sd.values())} weights (seeded), "
        f"2 synthetic videos of {DET_FRAMES} BGR frames {DET_HW[0]}x{DET_HW[1]} in "
        f"{time.perf_counter() - t0:.3f} s")

    # float32: kernel path vs plain path on the same weights and frames
    images, _, sizes = det32._prep(videos[0][:DET_CHECK_FRAMES])
    im_hw = torch.as_tensor(sizes, device=dev)
    with torch.inference_mode():
        reset()
        c4k = det32.module.features(images)
        trunk = launches()
        trunk_routes = dict(gc.ROUTE_LAUNCHES)
        c4p = plain32.module.features(images)
        lk, dk = det32.module.rpn(c4k)
        lp, dp = plain32.module.rpn(c4p)
        anchors = torch.as_tensor(grid_anchors(c4k.shape[1], c4k.shape[2]), device=dev)
        props, _ = select_proposals(anchors, lk, dk, im_hw)
        pidx = torch.arange(DET_CHECK_FRAMES, device=dev, dtype=torch.int32).repeat_interleave(
            props.shape[1])
        reset()
        box_k = det32.module.box(c4k, props.reshape(-1, 4), pidx)
        head = launches()
        head_routes = dict(gc.ROUTE_LAUNCHES)
        box_p = plain32.module.box(c4p, props.reshape(-1, 4), pidx)
        if any(launches()[k] != head[k] for k in head):
            fail("the plain detector path launched a kernel")
        errs = {"c4": rel_err(c4k, c4p), "rpn logits": rel_err(lk, lp),
                "rpn deltas": rel_err(dk, dp)}
        errs.update({n: rel_err(a, b) for n, a, b in zip(("cls logits", "box deltas",
                                                          "features"), box_k, box_p)})
        pk = det32.detect_packed(images, im_hw)
        pp = plain32.detect_packed(images, im_hw)
    log(f"detector fp32 kernel vs plain ({DET_CHECK_FRAMES} frames {tuple(images.shape)}, C4 "
        f"{tuple(c4k.shape)}, |C4| max {float(c4k.abs().max()):.3f}), error / max |ref|: "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f"; launches: trunk {trunk}, box head {head}; grouped-conv routes: trunk "
        f"{trunk_routes}, box head {head_routes}")
    if trunk != {"roi_align": 0, "grouped_conv3x3": 45} or \
            head != {"roi_align": 1, "grouped_conv3x3": 2}:
        fail(f"detector launches: trunk {trunk} (want 45 grouped convs), box head {head} "
             f"(want 1 roi_align + 2 grouped convs)")
    if trunk_routes["3xtf32"] != 45 or head_routes["3xtf32"] != 2:
        fail(f"fp32 grouped convs off the 3xtf32 route: trunk {trunk_routes}, head "
             f"{head_routes}")
    worst = max(errs, key=errs.get)
    if errs[worst] > DET_PATH_TOL or not bool(pk.isfinite().all()):
        fail(f"detector fp32 kernel path differs from plain: {worst} {errs[worst]:.3e}")
    matched = total = 0
    for f in range(DET_CHECK_FRAMES):
        a, b = pp[f][pp[f, :, 7] > 0.5], pk[f][pk[f, :, 7] > 0.5]
        near = (a[:, None, :4] - b[None, :, :4]).abs().amax(-1) < DET_MATCH_PX
        matched += int((near & (a[:, None, 5] == b[None, :, 5])).any(1).sum())
        total += a.shape[0]
    share = matched / max(total, 1)
    log(f"detections fp32 kernel vs plain path: {matched}/{total} valid detections matched "
        f"(same frame and label, corners within {DET_MATCH_PX} px) = {share:.4f}")
    if total < 10 * DET_CHECK_FRAMES or share < DET_MATCH:
        fail(f"detections: {matched}/{total} matched, need {DET_MATCH}")
    del c4k, c4p, box_k, box_p, plain32

    # bfloat16: a server answering two requests (one video each)
    det16 = AttrRCNNTorch(sd, compute_dtype="bfloat16", device=dev)
    det16.detect_video(videos[0][:2])                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    video_ms = []
    outs = []
    for v in videos:
        t0 = time.perf_counter()
        outs.append(det16.detect_video(v))
        video_ms.append((time.perf_counter() - t0) * 1e3)
    served = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"detect_video bf16: {[round(t, 3) for t in video_ms]} ms per video of {DET_FRAMES} "
        f"frames (host clock, frames in and detections out), "
        f"{2 * DET_FRAMES / sum(video_ms) * 1e3:.1f} frames/s, launches {served}, "
        f"peak device memory {peak:.2f} GiB")
    if served != {"roi_align": 2, "grouped_conv3x3": 2 * 47}:
        fail(f"two detect_video calls launched {served}, expected 2 roi_align and 94 "
             f"grouped convs")
    for out in outs:
        if len(out) != DET_FRAMES or any(
                d["features"].shape != (100, 2048) or not np.isfinite(d["features"]).all()
                or not np.isfinite(d["boxes"]).all() or d["valid"].sum() < 10 for d in out):
            fail("detect_video: a frame lacks 100 finite detections with >= 10 valid")

    # union features: 96 boxes a video spread over its frames
    ub = []
    for _ in videos:
        xy = rng.uniform(0, [DET_HW[1] - 60, DET_HW[0] - 60], (UNION_BOXES, 2))
        wh = rng.uniform(20, 300, (UNION_BOXES, 2))
        ub.append((np.concatenate([xy, xy + wh], 1).astype(np.float32),
                   rng.integers(0, DET_FRAMES, UNION_BOXES)))
    reset()
    t0 = time.perf_counter()
    feats = [det16.extract_box_features_frames(v, b, fi) for v, (b, fi) in zip(videos, ub)]
    union_ms = (time.perf_counter() - t0) * 1e3 / 2
    unioned = launches()
    log(f"extract_box_features_frames bf16: {UNION_BOXES} boxes a video, {union_ms:.3f} ms "
        f"per video, launches {unioned}")
    if unioned != {"roi_align": 2, "grouped_conv3x3": 2 * 47} or any(
            f.shape != (UNION_BOXES, 7, 7, 2048) or not np.isfinite(f).all() for f in feats):
        fail(f"extract_box_features_frames: launches {unioned} or bad features")
    sel = ub[0][1] < DET_CHECK_FRAMES
    f32 = det32.extract_box_features_frames(videos[0][:DET_CHECK_FRAMES], ub[0][0][sel],
                                            ub[0][1][sel]).ravel()
    f16 = det16.extract_box_features_frames(videos[0][:DET_CHECK_FRAMES], ub[0][0][sel],
                                            ub[0][1][sel]).ravel()
    corr = float(np.corrcoef(f32, f16)[0, 1])
    ratio = float(np.abs(f16).mean() / np.abs(f32).mean())
    log(f"union features bf16 vs fp32 ({int(sel.sum())} boxes): correlation {corr:.5f}, "
        f"mean |f| ratio {ratio:.4f}")
    if corr < 0.99 or not 0.9 < ratio < 1.1:
        fail("bf16 union features do not track fp32")

    # ---- 9. detector kernels timed on one bf16 detect_video's own inputs ----
    convs, aligns = [], []
    orig_conv, orig_align = dresnet.grouped_conv3x3, droi.roi_align

    def conv_rec(x, w, groups, bias=None, relu=False, out_dtype=None):
        convs.append((x, w, groups, bias, relu))
        return orig_conv(x, w, groups, bias, relu, out_dtype)

    def align_rec(*args, **kw):
        aligns.append((args, kw))
        return orig_align(*args, **kw)

    dresnet.grouped_conv3x3, droi.roi_align = conv_rec, align_rec
    try:
        det16.detect_video(videos[1])
    finally:
        dresnet.grouped_conv3x3, droi.roi_align = orig_conv, orig_align
    if len(convs) != 47 or len(aligns) != 1:
        fail(f"recorded {len(convs)} grouped convs and {len(aligns)} roi_aligns in one pass")

    conv_row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0,
                    terms={"bytes": 0.0, "operations": 0.0})
    classes = {}
    for x, w, groups, b, relu in convs:
        err, ok = det_kernel_err(gc.grouped_conv3x3(x, w, groups, b, relu),
                                 gc.grouped_conv3x3_reference(x, w, groups, b, relu))
        if not ok:
            fail(f"grouped_conv3x3 disagrees with its plain version on path inputs "
                 f"{tuple(x.shape)}")
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bl = b.to(x.dtype)
        kms = cuda_ms(lambda: gc.grouped_conv3x3(x, w, groups, b, relu), iters=5, warmup=1)
        pms = cuda_ms(lambda: gc.grouped_conv3x3_reference(x, w, groups, b, relu), iters=3,
                      warmup=1)
        lms = cuda_ms(lambda: F.conv2d(xl, wl, bl, padding=1, groups=groups), iters=5,
                      warmup=1)
        c = x.shape[3] // groups
        el = x.element_size()
        t_bytes = ((2 * x.numel() + w.numel()) * el + b.numel() * 4) / HBM_BYTES_PER_S
        t_ops = 18.0 * c * x.numel() / PEAK_OPS[str(x.dtype)]
        bms = max(t_bytes, t_ops) * 1e3
        conv_row["terms"]["bytes" if t_bytes >= t_ops else "operations"] += bms
        conv_row["max_abs_err"] = max(conv_row["max_abs_err"], err)
        for key, val in (("ms", kms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bms)):
            conv_row[key] += val
        cl = classes.setdefault(tuple(x.shape), [0, 0.0, 0.0, 0.0, 0.0])
        for i, val in enumerate((1, kms, pms, lms, bms)):
            cl[i] += val
    for shape, (n, kms, pms, lms, bms) in classes.items():
        log(f"grouped_conv3x3 bf16 {shape} x {n}: kernel {kms:.4f} ms, plain {pms:.4f}, cuDNN "
            f"{lms:.4f}, bound {bms:.4f} ms (sums over the pass's {n} calls)")

    args, kw = aligns[0]
    out = ra.roi_align(*args, **kw)
    ref = ra.roi_align_reference(*args, **kw)
    align_err, ok = det_kernel_err(out, ref)
    if not ok:
        fail("roi_align disagrees with its plain version on path inputs")
    fm, rois_p, fidx_p = args[:3]
    ams = cuda_ms(lambda: ra.roi_align(*args, **kw), iters=10, warmup=2)
    apl = cuda_ms(lambda: ra.roi_align_reference(*args, **kw), iters=2, warmup=1)
    sr = kw.get("sampling_ratio", 2)
    t_bytes = (fm.numel() * fm.element_size() + (rois_p.numel() + fidx_p.numel()) * 4
               + out.numel() * out.element_size()) / HBM_BYTES_PER_S
    t_ops = 8.0 * sr * sr * out.numel() / PEAK_OPS["torch.float32"]  # 4 taps x (mul, add)
    abound = max(t_bytes, t_ops) * 1e3
    route = ra.kernel_plan(fm.shape[3], out.shape[1:3], sr, fm.data_ptr() % 16 == 0)["route"]
    log(f"roi_align path inputs: map {tuple(fm.shape)} {str(fm.dtype)[6:]}, "
        f"{rois_p.shape[0]} rois -> {tuple(out.shape)} {str(out.dtype)[6:]}, route {route}: "
        f"kernel {ams:.4f} "
        f"ms, plain {apl:.4f} ms, bound {abound:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}), max_abs_err {align_err:.3e}")
    per_video = sum(video_ms) / 2
    log(f"per bf16 video: grouped convs {conv_row['ms']:.3f} ms "
        f"({conv_row['ms'] / per_video * 100:.1f}% of {per_video:.3f} ms), roi_align "
        f"{ams:.4f} ms; card {card}")
    profile_table(lambda: det16.detect_video(videos[1]), per_video, "bf16 detect_video", n=1)

    # the float32 route (3xtf32) on one fp32 detect_video's own inputs
    del convs, aligns, args, kw, out, ref
    torch.cuda.empty_cache()
    fp32_row = fp32_conv_phase(det32, videos[1], card)
    del det32
    torch.cuda.empty_cache()

    return det16, [{
        "name": "roi_align", "route": "cuda", "source": "nl_vsgg_tpu_torch/csrc/roi_align.cu",
        "replaces": "nl_vsgg_tpu/ops/pallas_roi_align.py:163",
        "launches": served["roi_align"], "max_abs_err": align_err, "ms": ams, "plain_ms": apl,
        "bound_ms": abound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }, {
        "name": "grouped_conv3x3", "route": "cuda",
        "source": "nl_vsgg_tpu_torch/csrc/grouped_conv.cu",
        "replaces": "nl_vsgg_tpu/ops/pallas_grouped_conv.py:148",
        "launches": served["grouped_conv3x3"], "max_abs_err": conv_row["max_abs_err"],
        "ms": conv_row["ms"], "plain_ms": conv_row["plain_ms"],
        "bound_ms": conv_row["bound_ms"],
        "bound_by": max(conv_row["terms"], key=conv_row["terms"].get),
        "library_ms": conv_row["library_ms"],
    }, fp32_row]


# ------------------------------------------------------------------ probes
PROBE_ITERS = {"overhead": 20, "ablate": 5}
# the packed conv's edges, as tests/test_torch_kernels_gpu.py: (tile_rows, W,
# route) at H = 7 (no tile above 1 row divides it): the ring at 64 to 256
# pixels a tile, the tile route where the ring refuses (32 or 96 pixels; 256
# pixels of W = 128, whose row ring does not fit shared memory)
ABLATE_EDGES = ((1, 64, "ring"), (2, 64, "ring"), (3, 64, "ring"), (4, 64, "ring"),
                (2, 32, "ring"), (8, 32, "ring"), (1, 128, "ring"), (2, 128, "tile"),
                (1, 32, "tile"), (3, 32, "tile"), (4, 32, "ring"))


def ablate_edge_checks(ga, g, dev) -> None:
    """Phase 10's packed-conv edges: every variant and layout against its
    plain version (KERNEL_TOL) on the route `kernel_plan` picks, at
    ABLATE_EDGES and at the probe's H = 38 (parts of 19 rows) with tiles of
    2, 3 and 4 rows; storage 2 bytes off 16-byte alignment refused on both
    routes."""
    import torch
    probe_h = ((2, 64, "ring"), (3, 64, "ring"), (4, 64, "ring"))
    for (N, Hx, C), cases in (((2, 9, 512), ABLATE_EDGES), ((1, 40, 256), probe_h)):
        for th, W, route in cases:
            x = torch.randn(N, Hx, W, C, generator=g, device=dev).bfloat16()
            w = (torch.randn(3, 3, 128, C, generator=g, device=dev) * 0.05).bfloat16()
            xt, wt = ga.to_block_major(x, w)
            got = (ga.route(x, th), ga.route(xt, th, block_major=True))
            if got != (route, route):
                fail(f"grouped_conv_ablate rows{th} W={W} took routes {got}, expected {route}")
            worst = 0.0
            for v in ga.VARIANTS + ga.BT_VARIANTS:
                bt = v in ga.BT_VARIANTS
                out = (ga.grouped_conv_ablate_bt(xt, wt, v, th) if bt
                       else ga.grouped_conv_ablate(x, w, v, th))
                torch.cuda.synchronize()
                ref = (ga.grouped_conv_ablate_bt_reference(xt, wt, v) if bt
                       else ga.grouped_conv_ablate_reference(x, w, v))
                err, ok = kernel_err(out, ref)
                worst = max(worst, err)
                if not ok:
                    fail(f"{v} rows{th} at ({N}, {Hx}, {W}, {C}) on the {route} route disagrees "
                         f"with its plain version (max_abs_err {err:.3e})")
            log(f"grouped_conv_ablate edge ({N}, {Hx}, {W}, {C}) rows{th}: route {route}, every "
                f"variant and layout max_abs_err {worst:.3e}")
    flat = torch.randn(1 + 2 * 12 * 32 * 128, generator=g, device=dev).bfloat16()
    w = torch.zeros(3, 3, 128, 128, device=dev, dtype=torch.bfloat16)
    for th in (1, 2):                          # the tile route, then the ring
        try:
            ga.grouped_conv_ablate(flat[1:].view(2, 12, 32, 128), w, "full", th)
        except ValueError:
            continue
        fail(f"grouped_conv_ablate took storage off 16-byte alignment at rows{th}")
    log("grouped_conv_ablate: storage off 16-byte alignment refused on both routes")


def probe_phases(dev, card) -> list[dict]:
    """Phase 10: the probe kernels against their plain versions at the
    probes' full shapes, then both probe entry points with the launch counts
    set to 0 just before and read just after. Returns the four `kernels`
    rows."""
    import torch
    import torch.nn.functional as F

    from nl_vsgg_tpu_torch.ops import grouped_conv as gc
    from nl_vsgg_tpu_torch.ops import grouped_conv_ablate as ga
    from nl_vsgg_tpu_torch.ops import probe_copy as pc
    from nl_vsgg_tpu_torch.ops import probe_matmul as pm
    from nl_vsgg_tpu_torch.tools import probe_ablate, probe_overhead

    g = torch.Generator(device=dev).manual_seed(4)
    errs = {"probe_copy": 0.0, "probe_matmul": 0.0, "grouped_conv_ablate": 0.0,
            "grouped_conv_ablate_bt": 0.0}
    # the copy at the probes' shapes, a tail past the vectors (1001) and one
    # element, at the probes' unit counts (1, 8) and an uneven 3
    for shape in ((256, 128), (8, 40, 64, 128), (1001,), (1,)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            for units in (1, 8, 3):
                y = pc.probe_copy(x, units)
                torch.cuda.synchronize()
                if not torch.equal(y, pc.probe_copy_reference(x)):
                    fail(f"probe_copy differs from x * 2 at {shape} {dtype} units={units}")
    log("probe_copy: exact (x * 2) at (256, 128), (8, 40, 64, 128), (1001,), (1,) in float32 "
        "and bfloat16 as 1, 8 and 3 units")

    w = (torch.randn(128, 128, generator=g, device=dev) * 0.05).bfloat16()
    for m in (20480, 1000, 4255, 5, 1):   # 4255: a ragged last 32-row tile
        x = torch.randn(m, 128, generator=g, device=dev).bfloat16()
        out = pm.probe_matmul(x, w)
        torch.cuda.synchronize()
        err, ok = kernel_err(out, pm.probe_matmul_reference(x, w))
        errs["probe_matmul"] = max(errs["probe_matmul"], err)
        log(f"probe_matmul ({m}, 128) @ (128, 128) bf16: max_abs_err {err:.3e}")
        if not ok:
            fail(f"probe_matmul disagrees with its plain version at M={m}")

    N, Hc, Wc, C = 8, 38, 64, 1024
    x32 = torch.randn(N, Hc + 2, Wc, C, generator=g, device=dev)
    w32 = torch.randn(3, 3, 128, C, generator=g, device=dev) * 0.05
    for dtype in (torch.bfloat16, torch.float32):
        x, w = x32.to(dtype), w32.to(dtype)
        xt, wt = ga.to_block_major(x, w)
        if dtype == torch.float32:   # the real conv against cuDNN, TF32 off
            ref = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=(0, 1),
                           groups=C // 128).permute(0, 2, 3, 1)
            tol = DET_KERNEL_REL * float(ref.abs().max())
            for th in (1, 2):
                for key, out in (
                        ("grouped_conv_ablate", ga.grouped_conv_ablate(x, w, "full", th)),
                        ("grouped_conv_ablate_bt", ga.from_block_major(
                            ga.grouped_conv_ablate_bt(xt, wt, "bt-full", th)))):
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    log(f"{key} full fp32 rows{th} vs cuDNN groups-8: max_abs_err {err:.3e} "
                        f"(tol {tol:.3e})")
                    if not err <= tol:
                        fail(f"{key} full fp32 rows{th} disagrees with cuDNN")
            continue
        refs = {v: ga.grouped_conv_ablate_reference(x, w, v) for v in ga.VARIANTS}
        refs.update({v: ga.grouped_conv_ablate_bt_reference(xt, wt, v) for v in ga.BT_VARIANTS})
        for th in probe_ablate.TILE_ROWS:
            line = []
            for v, ref in refs.items():
                bt = v in ga.BT_VARIANTS
                out = (ga.grouped_conv_ablate_bt(xt, wt, v, th) if bt
                       else ga.grouped_conv_ablate(x, w, v, th))
                torch.cuda.synchronize()
                err, ok = kernel_err(out, ref)
                key = "grouped_conv_ablate_bt" if bt else "grouped_conv_ablate"
                errs[key] = max(errs[key], err)
                line.append(f"{v} {err:.3e}")
                if not ok:
                    fail(f"{v} rows{th} bf16 disagrees with its plain version "
                         f"(max_abs_err {err:.3e})")
            log(f"grouped_conv_ablate bf16 ({N}, {Hc + 2}, {Wc}, {C}) rows{th}: max_abs_err "
                + ", ".join(line))
    del x32, w32, x, w, xt, wt, refs, ref, out
    ablate_edge_checks(ga, g, dev)

    # the probe path: both entry points, launch counts from 0
    pc.reset_launches()
    pm.reset_launches()
    ga.reset_launches()
    gc.reset_launches()
    t0 = time.perf_counter()
    over = probe_overhead.run(iters=PROBE_ITERS["overhead"], device=dev, log=log)
    abl = probe_ablate.run(iters=PROBE_ITERS["ablate"], device=dev, log=log)
    probe_s = time.perf_counter() - t0
    got = {**pc.LAUNCHES, **pm.LAUNCHES, **ga.LAUNCHES, "grouped_conv3x3": gc.launches()}
    want = {k: sum(r["calls"] for r in over + abl if r["kernel"] == k) for k in got}
    log(f"probe entry points: {probe_s:.3f} s; launches {got}")
    if got != want or not all(got.values()):
        fail(f"probe launches {got}, expected {want} (each kernel's count equal to the calls "
             f"its rows made, none zero)")
    new_route = {"probe_copy": pc.ROUTE, "grouped_conv_ablate": "ring",
                 "grouped_conv_ablate_bt": "ring"}
    routes = {r["name"]: r["route"] for r in over + abl if r["kernel"] in new_route}
    log(f"probe rows' routes: {routes}")
    off = [r["name"] for r in over + abl
           if r["kernel"] in new_route and r["route"] != new_route[r["kernel"]]]
    if off:
        fail(f"probe rows off the new routes: {off}")

    # plain versions timed on the probes' main inputs
    rows = {r["name"]: r for r in over + abl}
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((8, 40, 64, 128)).astype(np.float32)).to(
        dev, torch.bfloat16)
    xm = torch.from_numpy(rng.standard_normal((20480, 128)).astype(np.float32)).to(
        dev, torch.bfloat16)
    wm = torch.from_numpy((rng.standard_normal((128, 128)) * 0.05).astype(np.float32)).to(
        dev, torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((N, Hc + 2, Wc, C)).astype(np.float32)).to(
        dev, torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((3, 3, 128, C)) * 0.05).astype(np.float32)).to(
        dev, torch.bfloat16)
    xtiny = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32)).to(dev)
    xt, wt = ga.to_block_major(x, w)
    tiny_pl = cuda_ms(lambda: pc.probe_copy_reference(xtiny))
    copy_pl = cuda_ms(lambda: pc.probe_copy_reference(xs))
    mm_pl = cuda_ms(lambda: pm.probe_matmul_reference(xm, wm))
    full_pl = cuda_ms(lambda: ga.grouped_conv_ablate_reference(x, w, "full"), iters=5)
    bt_pl = cuda_ms(lambda: ga.grouped_conv_ablate_bt_reference(xt, wt, "bt-full"), iters=5)

    def best(prefix):
        return min((r for r in abl if r["name"].startswith(prefix)), key=lambda r: r["device_ms"])

    full, bt_full = best("full "), best("bt-full ")
    cudnn8 = rows[f"cudnn(g{C // 128})"]["device_ms"]
    for name, lib_ms in (("tiny-copy", tiny_pl), ("slab-copy", copy_pl),
                         ("slab-copy-g8", copy_pl)):
        r = rows[name]
        log(f"probe {name}: kernel {r['device_us']:.3f} us, bound {r['bound_us']:.3f} us "
            f"({r['bound_by']}), x * 2 (the plain version and the library call) "
            f"{lib_ms * 1e3:.3f} us; card {card}")
    log(f"probe kernels: mm {rows['mm-kernel']['device_us']:.3f} us (plain {mm_pl * 1e3:.3f}, "
        f"torch.matmul {rows['mm-torch']['device_us']:.3f}), {full['name']} "
        f"{full['device_ms']:.4f} ms, {bt_full['name']} {bt_full['device_ms']:.4f} ms (plain "
        f"{full_pl:.4f} / {bt_pl:.4f}, cuDNN g8 {cudnn8:.4f}); card {card}")

    def row(name, replaces, ms, plain_ms, bound_ms, bound_by, library_ms):
        source = f"nl_vsgg_tpu_torch/csrc/{name.removesuffix('_bt')}.cu"
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": got[name], "max_abs_err": errs[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    # the copy's row: the three probe rows summed, each beside x * 2 on its
    # own input (the plain version and the library call)
    copies = [(name, rows[name], pl) for name, pl in
              (("tiny-copy", tiny_pl), ("slab-copy", copy_pl), ("slab-copy-g8", copy_pl))]
    copy_row = row("probe_copy", "tools/probe_pallas_overhead.py:67",
                   sum(r["device_us"] for _, r, _ in copies) / 1e3,
                   sum(pl for _, _, pl in copies), sum(r["bound_us"] for _, r, _ in copies) / 1e3,
                   "bytes", sum(pl for _, _, pl in copies))
    copy_row["rows"] = [{"name": name, "replaces": f"tools/probe_pallas_overhead.py:{line}",
                         "ms": r["device_us"] / 1e3, "x2_ms": pl, "bound_ms": r["bound_us"] / 1e3,
                         "calls": r["calls"]}
                        for (name, r, pl), line in zip(copies, (67, 75, 84))]
    mm = rows["mm-kernel"]
    return [
        copy_row,
        row("probe_matmul", "tools/probe_pallas_overhead.py:105", mm["device_us"] / 1e3, mm_pl,
            mm["bound_us"] / 1e3, mm["bound_by"], rows["mm-torch"]["device_us"] / 1e3),
        row("grouped_conv_ablate", "tools/probe_pallas_ablate.py:87", full["device_ms"], full_pl,
            full["bound_ms"], full["bound_by"], cudnn8),
        row("grouped_conv_ablate_bt", "tools/probe_pallas_ablate.py:135", bt_full["device_ms"],
            bt_pl, bt_full["bound_ms"], bt_full["bound_by"], cudnn8),
    ]


# --------------------------------------------------------------- evaluation
EVAL_BATCH = 16                  # evaluate_epoch's batch of videos
SGCLS_VIDEOS, SGDET_VIDEOS = 8, 4
# device rows against host rows: the same hit counts over the same GT counts,
# divided in float32 on the card and in float64 on the host -> 1e-6
EVAL_ATOL = 1e-6
NMS_BOXES = 300


def detections(rng, n_frames: int, feat: int):
    """Seeded raw sgdet detections of one video and its AG_Test GT: a frame
    holds a person, three objects (labels drawn from 5, 8, 17 and the rest,
    so `clean_class` duplicates fire) and a near-copy of one object of the
    same class (so NMS suppresses); 36-way softmax rows with the true class
    leading; GT boxes jittered from the detections."""
    boxes, frames, logits, gt = [], [], [], []
    for f in range(n_frames):
        person = np.array([rng.uniform(0, 300), rng.uniform(0, 100)])
        pb = np.concatenate([person, person + rng.uniform(150, 300, 2)])
        objs = []
        for _ in range(3):
            xy = rng.uniform(0, 500, 2)
            cls = int(rng.choice([5, 8, 17])) if rng.uniform() < 0.5 else int(rng.integers(2, 37))
            objs.append((np.concatenate([xy, xy + rng.uniform(40, 200, 2)]), cls))
        dup_box, dup_cls = objs[0]
        rows = [(pb, 1)] + objs + [(dup_box + rng.uniform(-3, 3, 4), dup_cls)]
        for b, cls in rows:
            lg = rng.standard_normal(36)
            lg[cls - 1] += 4.0
            boxes.append(b)
            frames.append(f)
            logits.append(lg)
        frame = [{"person_bbox": (pb + rng.uniform(-6, 6, 4)).astype(np.float32)[None]}]
        for b, cls in objs:
            frame.append({"bbox": (b + rng.uniform(-6, 6, 4)).astype(np.float32), "class": cls,
                          "attention_relationship": np.array([rng.integers(0, 3)]),
                          "spatial_relationship": np.array([rng.integers(0, 6)]),
                          "contacting_relationship": np.array([rng.integers(0, 17)])})
        gt.append(frame)
    logits = np.asarray(logits, np.float32)
    dist = np.exp(logits - logits.max(1, keepdims=True))
    dist /= dist.sum(1, keepdims=True)
    feats = (rng.standard_normal((len(boxes), feat)) * 0.1).astype(np.float32)
    return (np.asarray(boxes, np.float32), np.asarray(frames, np.int64), dist, feats, gt)


def recall_line(ev) -> str:
    ev.calculate_mean_recall()
    parts = [f"{name} " + "/".join(f"{float(np.mean(sink[k])):.4f}" for k in (10, 20, 50))
             for name, sink in (("with", ev.recall), ("no", ev.recall_nogc),
                                ("semi", ev.semi_recall))]
    parts.append("mR " + "/".join(f"{v:.4f}" for v in ev.mean_recall.mean_recall.values()))
    parts.append("ng-mR " + "/".join(f"{v:.4f}" for v in ev.ng_mean_recall.mean_recall.values()))
    return "R@10/20/50 " + ", ".join(parts)


def check_recalls(ev, what: str) -> None:
    for name in ("recall", "recall_nogc", "semi_recall"):
        vals = np.asarray([v for k in (10, 20, 50) for v in getattr(ev, name)[k]])
        if not len(vals) or not np.isfinite(vals).all() or (vals < 0).any() or (vals > 1).any():
            fail(f"{what}: {name} rows empty, non-finite or outside [0, 1]")


def eval_phases(dev, card, entries) -> None:
    """Phase 11: the evaluation path at full width on the phase-3 videos:
    the bf16 eval step, the host evaluator and the device scorers (rows
    equal, mR@K equal), the streaming `evaluate_epoch` with its device-eval
    promotion, the sgcls two-stage flow, the sgdet flow from raw detections,
    and NMS on the card against the CPU."""
    import torch

    from nl_vsgg_tpu_torch.data.entry import to_numpy
    from nl_vsgg_tpu_torch.data.grounding import entry_to_eval_pred
    from nl_vsgg_tpu_torch.data.infer_entry import build_infer_entry
    from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_gt
    from nl_vsgg_tpu_torch.eval import epoch as epoch_mod
    from nl_vsgg_tpu_torch.eval import recall_device as rd
    from nl_vsgg_tpu_torch.eval.recall import SceneGraphEvaluator
    from nl_vsgg_tpu_torch.models.sgcls_infer import sgcls_assign
    from nl_vsgg_tpu_torch.models.sgdet_infer import sgdet_assign
    from nl_vsgg_tpu_torch.models.sttran import STTran
    from nl_vsgg_tpu_torch.ops import masked_attention as ma
    from nl_vsgg_tpu_torch.ops.nms import batched_nms_mask, nms_mask
    from nl_vsgg_tpu_torch.train.step import eval_step, place_entries

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    kw = dict(feat_dim=FEAT, enc_layer_num=1, dec_layer_num=3, dtype=bf16, device=dev)
    model = STTran(mode="sgdet", generator=torch.Generator().manual_seed(0), **kw)
    rng = np.random.default_rng(2000)
    gts = [make_synthetic_gt(e, rng) for e in entries]
    one_fwd = {"fwd": 4, "bwd_dq": 0, "bwd_dkv": 0}

    # ---- the eval step, then both scorers on the same 64 videos ----
    batch = place_entries(entries, rel_bf16=True, device=dev)
    ma.reset_launches()
    out = eval_step(model, batch)
    torch.cuda.synchronize()
    if dict(ma.LAUNCHES) != one_fwd:
        fail(f"the eval step launched {dict(ma.LAUNCHES)}, expected {one_fwd}")
    host_out = {k: to_numpy(out[k]) for k in epoch_mod.EVAL_KEYS}
    preds = [entry_to_eval_pred(e, {k: v[i] for k, v in host_out.items()})
             for i, e in enumerate(entries)]
    del out, batch

    ev = SceneGraphEvaluator("sgdet")
    t0 = time.perf_counter()
    for gt, p in zip(gts, preds):
        ev.evaluate_scene_graph(gt, p)
    host_ms = (time.perf_counter() - t0) / len(entries) * 1e3

    rd.device_eval_batch(entries[:2], preds[:2], gts[:2], ev, f_bucket=N_FRAMES, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = rd.device_eval_batch(entries, preds, gts, ev, f_bucket=N_FRAMES, device=dev)
    batch_ms = (time.perf_counter() - t0) / len(entries) * 1e3
    if any(r["gt_dropped"] for r in rows):
        fail(f"device_eval_batch dropped GT: {[r['gt_dropped'] for r in rows]}")
    worst = 0.0
    for name, sink in (("recall", ev.recall), ("recall_nogc", ev.recall_nogc),
                       ("semi", ev.semi_recall)):
        host_rows = np.stack([sink[k] for k in (10, 20, 50)], -1)
        dev_rows = np.concatenate([r[name] for r in rows])
        if dev_rows.shape != host_rows.shape:
            fail(f"device {name} rows {dev_rows.shape} against host rows {host_rows.shape}")
        err = float(np.abs(dev_rows - host_rows).max())
        worst = max(worst, err)
        if err > EVAL_ATOL:
            fail(f"device {name} rows differ from the host's by {err} > {EVAL_ATOL}")

    packed = [rd.pack_gt_video(g, ev, 32, N_FRAMES) for g in gts]
    args = [rd.host_args(e, p, pk) for e, p, pk in zip(entries, preds, packed)]
    stacked = [torch.from_numpy(np.stack([a[j] for a in args])).to(dev) for j in range(12)]
    scorer_ms = cuda_ms(lambda: rd._recall_batch_all(*stacked), iters=10)
    hits, counts = (t.cpu().numpy().astype(np.float64) for t in rd.mean_recall_video(*stacked))
    del stacked
    log(recall_line(ev) + f"  (sgdet, {len(entries)} videos x {N_FRAMES} frames)")
    mr_err = 0.0
    for ki, k in enumerate((10, 20, 50)):
        per_class = [[] for _ in range(hits.shape[-1])]
        for b, f, c in zip(*np.nonzero(counts > 0)):
            per_class[c].append(hits[b, f, ki, c] / counts[b, f, c])
        mr = sum(float(np.mean(v)) if v else 0.0 for v in per_class) / len(per_class)
        mr_err = max(mr_err, abs(mr - ev.mean_recall.mean_recall[k]))
    if mr_err > EVAL_ATOL:
        fail(f"mR@K from mean_recall_video differs from the host's by {mr_err}")
    log(f"device scorers vs host evaluator: {len(rows)} videos, rows max |diff| {worst:.3e}, "
        f"mR@K max |diff| {mr_err:.3e} (tol {EVAL_ATOL}), gt_dropped 0")
    log(f"eval timing: host evaluator {host_ms:.3f} ms/video; device_eval_batch {batch_ms:.3f} "
        f"ms/video wall (pack, upload, score, fetch); device scorer alone {scorer_ms:.4f} ms "
        f"for {len(entries)} videos = {scorer_ms / len(entries):.4f} ms/video (CUDA events); "
        f"card {card}")

    # ---- the streaming loop with the device-eval promotion ----
    promo = epoch_mod.DeviceEvalPromotion(burnin=16, recheck_every=64)
    batches = [list(zip(gts[s:s + EVAL_BATCH], entries[s:s + EVAL_BATCH]))
               for s in range(0, len(entries), EVAL_BATCH)]
    waits = []
    start_fetch = epoch_mod.start_fetch

    def timed_fetch(out, device):
        wait = start_fetch(out, device)

        def timed():
            t = time.perf_counter()
            host = wait()
            waits.append((time.perf_counter() - t) * 1e3)
            return host
        return timed

    places = []
    place = epoch_mod.place_entries

    def timed_place(*a, **kw):
        t = time.perf_counter()
        b = place(*a, **kw)
        places.append((time.perf_counter() - t) * 1e3)
        return b

    epoch_mod.start_fetch, epoch_mod.place_entries = timed_fetch, timed_place
    try:
        ma.reset_launches()
        t0 = time.perf_counter()
        epoch_mod.evaluate_epoch(model, batches, promotion=promo, device=dev)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
    finally:
        epoch_mod.start_fetch, epoch_mod.place_entries = start_fetch, place
    want = {"fwd": 4 * len(batches), "bwd_dq": 0, "bwd_dkv": 0}
    if dict(ma.LAUNCHES) != want:
        fail(f"evaluate_epoch launched {dict(ma.LAUNCHES)}, expected {want}")
    diff = abs(promo.score(20) - ev.mean_score(20))
    if not promo.promoted or diff > EVAL_ATOL:
        fail(f"evaluate_epoch: promoted {promo.promoted} (checked {promo.checked}), "
             f"score(20) {promo.score(20)} against the host's {ev.mean_score(20)}")
    placed = place_entries(entries[:EVAL_BATCH], rel_bf16=True, device=dev)
    fwd16_ms = cuda_ms(lambda: eval_step(model, placed), iters=5)
    del placed
    log(f"evaluate_epoch: {len(entries)} videos in batches of {EVAL_BATCH}, promoted after "
        f"{promo.checked} host-checked videos, score(20) {promo.score(20):.6f} = host "
        f"{ev.mean_score(20):.6f}; wall {epoch_s:.3f} s; place_entries (stacking and upload) "
        f"{[round(t, 3) for t in places]} ms host wall; fetch waits in the loop "
        f"{[round(w, 3) for w in waits[:-1]]} ms, after the last batch {waits[-1]:.3f} ms, "
        f"against a {fwd16_ms:.3f} ms forward of {EVAL_BATCH} videos (CUDA events); "
        f"card {card}")
    # the same loop once more, traced: the card's busy time in it
    tr = device_busy(lambda: epoch_mod.evaluate_epoch(
        model, batches, promotion=epoch_mod.DeviceEvalPromotion(burnin=16, recheck_every=64),
        device=dev), "evaluate_epoch")
    if tr is not None:
        log(f"evaluate_epoch traced (torch.profiler): span {tr['span_ms']:.3f} ms against "
            f"{epoch_s * 1e3:.3f} ms untraced, card busy "
            f"{tr['busy_ms']:.3f} ms (kernels {tr['kernel_ms']:.3f}, copies to the card "
            f"{tr['htod_ms']:.3f}, to the host {tr['dtoh_ms']:.3f}), idle share "
            f"{1 - tr['busy_ms'] / tr['span_ms']:.4f}; card {card}")

    # ---- the sgcls two-stage flow (tools/test_STTran.py:150-170) ----
    sg_model = STTran(mode="sgcls", generator=torch.Generator().manual_seed(1), **kw)
    sub, sub_gts = entries[:SGCLS_VIDEOS], gts[:SGCLS_VIDEOS]
    ma.reset_launches()
    stage1 = to_numpy(eval_step(sg_model, place_entries(sub, rel_bf16=True, device=dev))["distribution"])
    stage2_entries = []
    for i, e in enumerate(sub):
        nb = int(e.box_mask.sum())
        frames = e.box_frame[:nb].numpy()
        assign = sgcls_assign(stage1[i, :nb], frames)
        assign.update(boxes=e.boxes[:nb].numpy(), box_frame=frames,
                      features=e.features[:nb].numpy())
        e2 = build_infer_entry(assign, int(e.num_frames), e.n_boxes, e.n_rels, feat_dim=FEAT,
                               compute_spatial_masks=False)
        if e2 is None:
            fail(f"sgcls: video {i} has no person-object pair after assignment")
        stage2_entries.append(e2)
    out2 = eval_step(sg_model, place_entries(stage2_entries, rel_bf16=True, device=dev))
    torch.cuda.synchronize()
    want = {"fwd": 8, "bwd_dq": 0, "bwd_dkv": 0}
    if dict(ma.LAUNCHES) != want:
        fail(f"sgcls two stages launched {dict(ma.LAUNCHES)}, expected {want}")
    out2 = {k: to_numpy(out2[k]) for k in epoch_mod.EVAL_KEYS}
    ev_cls = SceneGraphEvaluator("sgcls")
    for i, (gt, e2) in enumerate(zip(sub_gts, stage2_entries)):
        ev_cls.evaluate_scene_graph(gt, entry_to_eval_pred(e2, {k: v[i] for k, v in out2.items()}))
    check_recalls(ev_cls, "sgcls")
    log(recall_line(ev_cls) + f"  (sgcls two-stage, {SGCLS_VIDEOS} videos, launches "
        f"{dict(ma.LAUNCHES)})")

    # ---- the sgdet flow from raw detections ----
    drng = np.random.default_rng(3000)
    assigns, det_gts = [], []
    for _ in range(SGDET_VIDEOS):
        boxes, frames, dist, feats, gt = detections(drng, N_FRAMES, FEAT)
        assigns.append(sgdet_assign(boxes, frames, dist, feats))
        det_gts.append(gt)
    n_b = -(-max(len(a["boxes"]) for a in assigns) // 16) * 16
    n_r = -(-max(len(a["pair_idx"]) for a in assigns) // 16) * 16
    det_entries = [build_infer_entry(a, N_FRAMES, n_b, n_r, feat_dim=FEAT,
                                     compute_spatial_masks=False) for a in assigns]
    ma.reset_launches()
    out3 = eval_step(model, place_entries(det_entries, rel_bf16=True, device=dev))
    torch.cuda.synchronize()
    if dict(ma.LAUNCHES) != one_fwd:
        fail(f"the sgdet flow's forward launched {dict(ma.LAUNCHES)}, expected {one_fwd}")
    out3 = {k: to_numpy(out3[k]) for k in epoch_mod.EVAL_KEYS}
    ev_det = SceneGraphEvaluator("sgdet")
    for i, (gt, e3) in enumerate(zip(det_gts, det_entries)):
        ev_det.evaluate_scene_graph(gt, entry_to_eval_pred(e3, {k: v[i] for k, v in out3.items()}))
    check_recalls(ev_det, "sgdet flow")
    log(recall_line(ev_det) + f"  (sgdet_assign flow, {SGDET_VIDEOS} videos, bucket "
        f"{n_b} boxes / {n_r} relations, launches {dict(ma.LAUNCHES)})")

    # ---- NMS on the card against the CPU, exact ties ----
    nrng = np.random.default_rng(5000)
    xy = nrng.uniform(0, 400, (4, NMS_BOXES, 2))
    nb_ = np.concatenate([xy, xy + nrng.uniform(10, 120, (4, NMS_BOXES, 2))], -1)
    ns_ = nrng.uniform(0, 1, (4, NMS_BOXES))
    ns_[:, ::3] = ns_[:, 1::3]
    ns_[:, ::7] = 0.5
    nv_ = nrng.uniform(size=(4, NMS_BOXES)) > 0.1
    nc_ = nrng.integers(0, 4, (4, NMS_BOXES))
    cpu_args = [torch.from_numpy(a) for a in (nb_.astype(np.float32), ns_.astype(np.float32),
                                               nv_, nc_)]
    gpu_args = [a.to(dev) for a in cpu_args]
    kept = []
    for what, fn in (("nms_mask", lambda b, s, v, c: nms_mask(b, s, 0.5, valid=v)),
                     ("batched_nms_mask", lambda b, s, v, c: batched_nms_mask(b, s, c, 0.5,
                                                                               valid=v))):
        on_cpu, on_gpu = fn(*cpu_args), fn(*gpu_args).cpu()
        if not torch.equal(on_cpu, on_gpu):
            fail(f"{what} keeps other boxes on the card than on the CPU")
        kept.append(int(on_gpu.sum()))
    log(f"nms on the card = on the CPU: 4 x {NMS_BOXES} boxes with exact ties, nms_mask keeps "
        f"{kept[0]}, batched_nms_mask (4 classes) keeps {kept[1]}")
    log(f"evaluation phase wall {time.perf_counter() - t_phase:.3f} s; card {card}")


# ----------------------------------------------------------------- DSG-DETR
IM_SIZE = (600.0, 1000.0)        # the synthetic frames' (height, width), the tracker's im_size
# the tracker's cost matrices on the card's auction solver: a small eps and
# twice the rows / eps rounds it needs to finish on bounded costs (the
# tracker's 4-row matrices, costs 0.9-3.8, finish in 25); a matrix counts as
# non-degenerate when scipy's optimum beats every other assignment by more
# than rows * eps
AUCTION_EPS, AUCTION_MATRICES = 0.02, 8
TRACKLET_D = (FEAT + 200 + 128) // 8  # the sgcls tracklet encoder's head dim, 297
TRACKLET_ROUTE = "tiled"              # its float32 calls' route


def tracklet_entries(entries, rng) -> list:
    """Set (b): the videos with each object slot keeping one class, drawn
    once a video, through every frame (its detector distribution peaked on
    that class as make_synthetic_entry peaks one), as an Action Genome clip
    follows a person and a few objects through its frames."""
    import torch

    from nl_vsgg_tpu_torch.data import schema
    out = []
    for e in entries:
        nb = int(e.box_mask.sum())
        slot = np.arange(nb) % (OBJS + 1)        # make_synthetic_entry: person, then OBJS objects
        obj = slot > 0
        classes = rng.integers(2, schema.NUM_OBJ_CLASSES, OBJS + 1)
        labels, dist = e.labels.numpy().copy(), e.distribution.numpy().copy()
        labels[:nb][obj] = classes[slot[obj]]
        d = rng.uniform(0, 0.1, (nb, dist.shape[1]))
        d[np.arange(nb), labels[:nb] - 1] = rng.uniform(0.6, 1.0, nb)
        dist[:nb][obj] = (d / d.sum(1, keepdims=True))[obj]
        out.append(e.replace(labels=torch.from_numpy(labels), distribution=torch.from_numpy(dist)))
    return out


def dsg_masks(batch):
    """DSG-DETR's two allow masks on a batch: local (the relations of one
    frame) and global (the relations whose object has one class)."""
    from nl_vsgg_tpu_torch.models.dsg_detr import _same_group, _take
    obj = batch.pair_idx[..., 1]
    return (_same_group(_take(batch.box_frame, obj), batch.rel_mask),
            _same_group(_take(batch.labels, obj), batch.rel_mask))


def capture_attention(model, run) -> list:
    """The attention core's inputs (q, k, v, allow, scale) of every
    MaskedMHA call one `run()` makes through `model`, rebuilt from each
    call's own arguments (forward pre-hooks)."""
    import torch

    from nl_vsgg_tpu_torch.models.layers import MaskedMHA
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, kwargs: calls.append((mod, args, kwargs)), with_kwargs=True)
        for m in model.modules() if isinstance(m, MaskedMHA)]
    try:
        run()
    finally:
        for hk in hooks:
            hk.remove()
    with torch.inference_mode():
        out = []
        for mod, args, kwargs in calls:
            q, k, v = mod.heads(*args[:3], dup2_pos=kwargs.get("dup2_pos"))
            out.append((q, k, v, args[3], q.shape[-1] ** -0.5))
    return out


def record_train_attention(ma, run) -> list:
    """The attention inputs and output gradient of every masked_mha call of
    one `run()` (a train step)."""
    records = []
    orig = ma.masked_mha

    def recording(q, k, v, allow, s, rate=0.0, seeds=None):
        out = orig(q, k, v, allow, s, rate, seeds)
        rec = {"q": q.detach(), "k": k.detach(), "v": v.detach(), "allow": allow, "s": s,
               "rate": rate, "seeds": seeds}
        records.append(rec)
        out.register_hook(lambda gr, rec=rec: rec.__setitem__("g", gr.detach()))
        return out

    ma.masked_mha = recording
    try:
        run()
    finally:
        ma.masked_mha = orig
    return records


def attention_row(name: str, line: int, launches: int, r: dict) -> dict:
    """A `kernels` row of the attention kernels from summed timings `r`
    (`time_eval_calls`, `time_train_records`); `line` is the TPU kernel's
    call site in nl_vsgg_tpu/ops/pallas_attention.py."""
    return {"name": name, "route": "cuda", "source": "nl_vsgg_tpu_torch/csrc/masked_attention.cu",
            "replaces": f"nl_vsgg_tpu/ops/pallas_attention.py:{line}",
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": max(r["terms"], key=r["terms"].get), "library_ms": r["library_ms"]}


def _row_sums():
    return dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0,
                pairs=0.0, terms={"bytes": 0.0, "operations": 0.0})


def _add(row, err, kms, pms, bound, lms, pairs):
    row["max_abs_err"] = max(row["max_abs_err"], err)
    for key, val in (("ms", kms), ("plain_ms", pms), ("library_ms", lms), ("pairs", pairs)):
        row[key] += val
    row["bound_ms"] += bound[0]
    row["terms"][bound[1]] += bound[0]


def per_element_calls(ma, q, k, v, allow, s, rate, sd, gout=None, lse=None, r=None) -> dict:
    """Callables that launch the per-element C entries directly on these
    inputs, bypassing the wrappers' route choice (the route the tiled one
    replaced, timed beside it): "fwd eval" (no dropout, no lse) always;
    with `gout`, `lse` and `r` also "fwd" (dropout at `rate`, lse), "bwd_dq"
    and "bwd_dkv". Not counted in LAUNCHES."""
    import torch
    Bq, Lq, Hh, D = q.shape
    dt, dev = ma._DTYPES[q.dtype], q.device
    thr, keep = (ma.drop_threshold(rate), 1.0 / (1.0 - rate)) if rate else (0, 1.0)
    sdp = sd.data_ptr() if rate else None
    out = torch.empty(Bq, Lq, Hh, D, dtype=q.dtype, device=dev)
    lse_o = torch.empty(Bq, Hh, Lq, device=dev)
    dims = (Bq, Lq, k.shape[1], Hh, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1))

    def launch(name, *args):
        if ma._fn(name)(*args, torch.cuda.current_stream().cuda_stream):
            fail(f"the per-element entry {name} failed to launch on {tuple(q.shape)}")

    calls = {"fwd eval": lambda: launch("masked_mha_fwd", dt, q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), allow.data_ptr(), None, out.data_ptr(),
                                        None, *dims, s, 0, 1.0)}
    if gout is None:
        return calls
    g = gout.contiguous()
    allow_t = allow.transpose(1, 2).contiguous()
    dq, r_o = torch.empty_like(out), torch.empty_like(lse_o)
    dk = torch.empty(Bq, k.shape[1], Hh, D, dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    bdims = (*dims, g.stride(0), g.stride(1), s, thr, keep)
    calls["fwd"] = lambda: launch("masked_mha_fwd", dt, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  allow.data_ptr(), sdp, out.data_ptr(), lse_o.data_ptr(), *dims,
                                  s, thr, keep)
    calls["bwd_dq"] = lambda: launch("masked_mha_bwd_dq", dt, q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), g.data_ptr(), allow.data_ptr(), lse.data_ptr(),
                                     sdp, dq.data_ptr(), r_o.data_ptr(), *bdims)
    calls["bwd_dkv"] = lambda: launch("masked_mha_bwd_dkv", dt, q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), g.data_ptr(), allow_t.data_ptr(),
                                      lse.data_ptr(), r.data_ptr(), sdp, dk.data_ptr(),
                                      dv.data_ptr(), *bdims)
    return calls


def launches_by_head_dim(ma, run) -> dict:
    """The kernel launches one `run()` makes, by the head dim of the call
    that made them: {D: {"fwd": n, "bwd_dq": n, "bwd_dkv": n}}, read from
    LAUNCHES around each call of the forward launch (`_forward_cuda`, which
    the autograd function and the no-grad path both reach) and of the two
    backward wrappers."""
    counts = {}
    names = {"_forward_cuda": "fwd", "masked_mha_bwd_dq": "bwd_dq",
             "masked_mha_bwd_dkv": "bwd_dkv"}
    orig = {n: getattr(ma, n) for n in names}

    def counting(n):
        def call(q, *args, **kw):
            before = ma.LAUNCHES[names[n]]
            res = orig[n](q, *args, **kw)
            by = counts.setdefault(q.shape[-1], {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0})
            by[names[n]] += ma.LAUNCHES[names[n]] - before
            return res
        return call

    for n in names:
        setattr(ma, n, counting(n))
    try:
        run()
    finally:
        for n, fn in orig.items():
            setattr(ma, n, fn)
    return counts


def tiled_fwd_call(ma, q, k, v, allow, s):
    """A callable that runs the tiled eval forward as its wrapper does,
    `row_order` and the C entry, bypassing the wrappers' route choice (the
    route the resident one replaced at CLIP's text tower, timed beside it).
    Not counted in LAUNCHES."""
    import torch
    Bq, Lq, Hh, D = q.shape
    out = torch.empty(Bq, Lq, Hh, D, dtype=q.dtype, device=q.device)

    def launch():
        order = ma.row_order(allow)
        if ma._fn("masked_mha_fwd_tiled")(
                ma._DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), allow.data_ptr(),
                order.data_ptr(), None, out.data_ptr(), None, Bq, Lq, k.shape[1], Hh, D,
                q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1), s,
                0, 1.0, torch.cuda.current_stream().cuda_stream):
            fail(f"the tiled entry failed to launch on {tuple(q.shape)}")
    return launch


def time_eval_calls(ma, calls, want_route: str, what: str) -> dict:
    """Each captured eval forward against its plain version (KERNEL_TOL),
    on `want_route` or the run fails; kernel, plain, SDPA and bound times
    summed over the calls. Beside them, on the same inputs, the routes
    this one replaced (`parent_ms`, by route): on the tiled and resident
    routes the per-element entry, on the resident route also the tiled
    wrapper's work where the tiled rule takes the inputs."""
    import torch.nn.functional as F
    row = _row_sums()
    row["parent_ms"] = {}
    for q, k, v, allow, s in calls:
        route = ma.fwd_route(q, k, v)
        if route != want_route:
            fail(f"{what}: the forward {tuple(q.shape)} took the {route} route, not {want_route}")
        err, ok = kernel_err(ma.masked_mha(q, k, v, allow, s),
                             ma.masked_mha_reference(q, k, v, allow, s))
        if not ok:
            fail(f"{what}: masked_mha disagrees with its plain version on {tuple(q.shape)} "
                 f"(max_abs_err {err:.3e})")
        kms = cuda_ms(lambda: ma.masked_mha(q, k, v, allow, s))
        pms = cuda_ms(lambda: ma.masked_mha_reference(q, k, v, allow, s))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allow[:, None],
                                                             scale=s))
        bound = attention_bound_ms(q, k, v, allow)
        pairs = float(allow.sum())
        _add(row, err, kms, pms, bound, lms, pairs)
        parents = {}
        if route in ("tiled", "resident"):
            parents["per-element"] = per_element_calls(ma, q, k, v, allow, s, 0.0,
                                                       None)["fwd eval"]
        if route == "resident" and ma._tiled("fwd", (q, k, v)):
            parents["tiled"] = tiled_fwd_call(ma, q, k, v, allow, s)
        extra = ""
        for name, call in parents.items():
            t_parent = cuda_ms(call)
            row["parent_ms"][name] = row["parent_ms"].get(name, 0.0) + t_parent
            extra += f", {name} {t_parent:.4f} ms"
        log(f"{what} {tuple(q.shape)} x Lk={k.shape[1]} {str(q.dtype)[6:]}, route {route}: "
            f"kernel {kms:.4f} ms{extra}, plain {pms:.4f} ms, sdpa {lms:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), allowed pairs {pairs / allow.numel():.4f} "
            f"({kms * 1e6 / pairs:.3f} ns a pair), max_abs_err {err:.3e}")
    return row


def time_train_records(ma, records, what: str, want_route: str) -> dict:
    """Each recorded train call's forward and both backward kernels against
    their plain versions (KERNEL_TOL / GRAD_TOL) on `want_route` (or the
    run fails), timed beside the plain versions, SDPA and the bounds; on
    the tiled route also beside the per-element entries on the same inputs
    (`per_element_ms`)."""
    import torch
    import torch.nn.functional as F
    rows = {n: _row_sums() for n in ("fwd", "bwd_dq", "bwd_dkv")}
    for row in rows.values():
        row["per_element_ms"] = 0.0
    for rec in records:
        q, k, v, allow, s, rate, sd, gout = (rec[n] for n in
                                             ("q", "k", "v", "allow", "s", "rate", "seeds", "g"))
        allow_t = allow.transpose(1, 2).contiguous()
        routes = {"fwd": ma.fwd_route(q, k, v), "dQ": ma.dq_route(q, k, v, gout),
                  "dK/dV": ma.dkv_route(q, k, v, gout)}
        if set(routes.values()) != {want_route}:
            fail(f"{what}: the attention {tuple(q.shape)} took the routes {routes}, not "
                 f"{want_route}")
        out, lse = ma.masked_mha_forward(q, k, v, allow, s, rate, sd)
        dq, r = ma.masked_mha_bwd_dq(q, k, v, allow, s, gout, lse, rate, sd)
        dk, dv = ma.masked_mha_bwd_dkv(q, k, v, allow_t, s, gout, lse, r, rate, sd)
        ref_dq, ref_r = ma.masked_mha_bwd_dq_reference(q, k, v, allow, s, gout, rate, sd)
        ref_dk, ref_dv = ma.masked_mha_bwd_dkv_reference(q, k, v, allow, s, gout, ref_r, rate, sd)
        errs = {}
        for name, got, ref, tol in (
                ("fwd", out, ma.masked_mha_reference(q, k, v, allow, s, rate, sd), KERNEL_TOL),
                ("bwd_dq", dq, ref_dq, GRAD_TOL), ("bwd_dq r", r, ref_r, GRAD_TOL),
                ("bwd_dkv", dk, ref_dk, GRAD_TOL), ("bwd_dkv v", dv, ref_dv, GRAD_TOL)):
            err, ok = kernel_err(got, ref, tol)
            if not ok:
                fail(f"{what}: {name} disagrees with its plain version on {tuple(q.shape)} "
                     f"(max_abs_err {err:.3e})")
            errs[name.split()[0]] = max(errs.get(name.split()[0], 0.0), err)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        gt, mask = gout.transpose(1, 2), allow[:, None]

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, dropout_p=rate,
                                                  scale=s)

        lib_fwd = cuda_ms(sdpa)
        lib_bwd = max(cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), gt)) - lib_fwd,
                      0.0)
        t = {"fwd": (cuda_ms(lambda: ma.masked_mha_forward(q, k, v, allow, s, rate, sd)),
                     cuda_ms(lambda: ma.masked_mha_reference(q, k, v, allow, s, rate, sd)),
                     attention_bound_ms(q, k, v, allow, True), lib_fwd),
             "bwd_dq": (cuda_ms(lambda: ma.masked_mha_bwd_dq(q, k, v, allow, s, gout, lse, rate,
                                                              sd)),
                        cuda_ms(lambda: ma.masked_mha_bwd_dq_reference(q, k, v, allow, s, gout,
                                                                       rate, sd)),
                        attention_bwd_bound_ms(q, k, allow, "dq"), lib_bwd),
             "bwd_dkv": (cuda_ms(lambda: ma.masked_mha_bwd_dkv(q, k, v, allow_t, s, gout, lse, r,
                                                                rate, sd)),
                         cuda_ms(lambda: ma.masked_mha_bwd_dkv_reference(q, k, v, allow, s, gout,
                                                                         ref_r, rate, sd)),
                         attention_bwd_bound_ms(q, k, allow, "dkv"), lib_bwd)}
        pairs = float(allow.sum())
        for n, (kms, pms, bound, lms) in t.items():
            _add(rows[n], errs[n], kms, pms, bound, lms, pairs)
        pe = {}
        if want_route == "tiled":
            calls = per_element_calls(ma, q, k, v, allow, s, rate, sd, gout, lse, r)
            for n in rows:
                pe[n] = cuda_ms(calls[n])
                rows[n]["per_element_ms"] += pe[n]
        beside = {n: f", per-element {pe[n]:.4f}" if n in pe else "" for n in rows}
        log(f"{what} {tuple(q.shape)} x Lk={k.shape[1]} {str(q.dtype)[6:]} rate {rate}, routes "
            f"{want_route}: fwd {t['fwd'][0]:.4f} (plain {t['fwd'][1]:.4f}, sdpa {lib_fwd:.4f}"
            f"{beside['fwd']}), bwd dQ {t['bwd_dq'][0]:.4f} (plain {t['bwd_dq'][1]:.4f}"
            f"{beside['bwd_dq']}), bwd dK/dV {t['bwd_dkv'][0]:.4f} (plain {t['bwd_dkv'][1]:.4f}"
            f"{beside['bwd_dkv']}), sdpa backward {lib_bwd:.4f} ms; bounds fwd "
            f"{t['fwd'][2][0]:.4f}, dQ {t['bwd_dq'][2][0]:.4f}, dK/dV {t['bwd_dkv'][2][0]:.4f} ms; "
            f"allowed pairs {pairs / allow.numel():.4f}; max_abs_err "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    return rows


def tracklet_kernel_checks(ma, calls, g, dev) -> None:
    """The tracklet encoder's D = 297 on its own inputs (set (b) boxes
    grouped by class): float32 (the encoder's type) on TRACKLET_ROUTE,
    bfloat16 on the per-element route; the forward with and without
    dropout and lse, dQ and dK/dV against their plain versions (KERNEL_TOL
    / GRAD_TOL) on the first call, the eval forward on the others; every
    17th query row given no allowed key, whose outputs and dQ must be
    exactly 0."""
    import torch
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B,), generator=g, device=dev, dtype=torch.int32)
    for i, (q0, k0, v0, allow0, s) in enumerate(calls):
        allow = allow0.clone()
        allow[:, ::17] = False
        for dtype, route in ((torch.float32, TRACKLET_ROUTE), (torch.bfloat16, "per-element")):
            q, k, v = (t.to(dtype) for t in (q0, k0, v0))  # float32: the encoder's own views
            gout = torch.randn(q.shape, device=dev, generator=g).to(dtype)
            routes = (ma.fwd_route(q, k, v), ma.dq_route(q, k, v, gout),
                      ma.dkv_route(q, k, v, gout))
            if set(routes) != {route} or q.shape[-1] != TRACKLET_D:
                fail(f"tracklet attention {tuple(q.shape)} {dtype}: routes {routes}, "
                     f"expected {route}")
            errs = {}
            for rate in ((0.0, RATE) if i == 0 else (0.0,)):
                sd = seeds if rate else None
                ref = ma.masked_mha_reference(q, k, v, allow, s, rate, sd)
                for with_lse in ((False, True) if i == 0 else (False,)):
                    out, lse = ma.masked_mha_forward(q, k, v, allow, s, rate, sd, with_lse)
                    checks = [("out", out, ref, KERNEL_TOL)]
                    if with_lse:
                        checks.append(("lse", lse, ma.masked_mha_lse_reference(q, k, allow, s),
                                       GRAD_TOL))
                    if float(out[:, ::17].float().abs().max()) != 0.0:
                        fail(f"tracklet forward {dtype}: rows with no allowed key are not 0")
                    for name, got, want, tol in checks:
                        err, ok = kernel_err(got, want, tol)
                        errs[name] = max(errs.get(name, 0.0), err)
                        if not ok:
                            fail(f"tracklet {name} {dtype} rate {rate} disagrees with its plain "
                                 f"version (max_abs_err {err:.3e})")
                if i:
                    continue
                dq, r = ma.masked_mha_bwd_dq(q, k, v, allow, s, gout, lse, rate, sd)
                dk, dv = ma.masked_mha_bwd_dkv(q, k, v, allow.transpose(1, 2).contiguous(), s,
                                               gout, lse, r, rate, sd)
                torch.cuda.synchronize()
                ref_dq, ref_r = ma.masked_mha_bwd_dq_reference(q, k, v, allow, s, gout, rate, sd)
                ref_dk, ref_dv = ma.masked_mha_bwd_dkv_reference(q, k, v, allow, s, gout, ref_r,
                                                                 rate, sd)
                for name, got, want in (("dq", dq, ref_dq), ("r", r, ref_r), ("dk", dk, ref_dk),
                                        ("dv", dv, ref_dv)):
                    err, ok = kernel_err(got, want, GRAD_TOL)
                    errs[name] = max(errs.get(name, 0.0), err)
                    if not ok:
                        fail(f"tracklet {name} {dtype} rate {rate} disagrees with its plain "
                             f"version (max_abs_err {err:.3e})")
                if float(dq[:, ::17].float().abs().max()) != 0.0:
                    fail(f"tracklet dQ {dtype}: rows with no allowed key are not 0")
            log(f"tracklet attention call {i} {tuple(q.shape)} {str(dtype)[6:]}, routes "
                f"{route}: max_abs_err " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + "; empty rows exactly 0")


def auction_checks(costs, dev) -> str:
    """`solve_lsap_auction` on the card against scipy on the tracker's cost
    matrices (rows <= columns, transposed where needed) whose optimum beats
    every other assignment by more than rows * AUCTION_EPS (found by brute
    force; larger matrices skipped): the same assignment, or the run fails."""
    import itertools
    import math

    import torch

    from nl_vsgg_tpu_torch.models.matcher import solve_lsap_auction, solve_lsap_host
    checked = degenerate = large = rounds_run = 0
    t0 = time.perf_counter()
    for cost in costs:
        c = cost if cost.shape[0] <= cost.shape[1] else cost.T
        n, m = c.shape
        if n == 0 or math.perm(m, n) > 5040:
            large += 1
            continue
        totals = sorted(float(c[np.arange(n), list(p)].sum())
                        for p in itertools.permutations(range(m), n))
        if len(totals) > 1 and totals[1] - totals[0] <= n * AUCTION_EPS:
            degenerate += 1
            continue
        rounds = 2 * math.ceil(n / AUCTION_EPS)
        got = solve_lsap_auction(torch.from_numpy(np.ascontiguousarray(c)).to(dev),
                                 n_iter=rounds, eps=AUCTION_EPS).cpu().numpy()
        _, col = solve_lsap_host(c)
        if not np.array_equal(got, col):
            fail(f"solve_lsap_auction on the card assigned {got}, scipy {col} on a {n}x{m} "
                 f"tracker cost matrix")
        checked += 1
        rounds_run += rounds
        if checked == AUCTION_MATRICES:
            break
    if checked == 0:
        fail("no non-degenerate tracker cost matrix to hold the auction solver against")
    return (f"solve_lsap_auction on the card = scipy on {checked} tracker cost matrices "
            f"(eps {AUCTION_EPS}, {rounds_run} rounds; {degenerate} degenerate and {large} "
            f"large ones skipped of {len(costs)} recorded), "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall")


def dsg_detr_phases(dev, card, entries) -> list[dict]:
    """Phase 12: DSG-DETR at full width on phase 3's 64 videos (set (a),
    random classes) and the same videos with tracklets (set (b), one class
    a slot through every frame): serving, the kernel path against the
    plain path, training, the attention kernels on its own inputs (per
    allowed pair), the tracklet encoder's D = 297 calls on the tiled route
    (eval and train, timed beside the per-element entries), the epoch eval
    with its promotion, the sgcls two-stage flow with tracker
    ids and the auction solver. Returns the phase's `kernels` rows."""
    import torch

    from nl_vsgg_tpu_torch.data.entry import to_numpy
    from nl_vsgg_tpu_torch.data.grounding import entry_to_eval_pred
    from nl_vsgg_tpu_torch.data.infer_entry import build_infer_entry
    from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_gt
    from nl_vsgg_tpu_torch.eval import epoch as epoch_mod
    from nl_vsgg_tpu_torch.eval.recall import SceneGraphEvaluator
    from nl_vsgg_tpu_torch.models import matcher as matcher_mod
    from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR
    from nl_vsgg_tpu_torch.models.sgcls_infer import sgcls_assign
    from nl_vsgg_tpu_torch.models.track import sgcls_group_ids
    from nl_vsgg_tpu_torch.ops import masked_attention as ma
    from nl_vsgg_tpu_torch.ops.boxes import center_size
    from nl_vsgg_tpu_torch.serve import predict
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.train.step import eval_step, make_train_step, place_entries

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    dtypes = {"float32": None, "bfloat16": bf16}
    sets = {"a": entries, "b": tracklet_entries(entries, np.random.default_rng(4000))}
    batches = {(n, d): place_entries(es, rel_bf16=dt == bf16, device=dev) for n, es in sets.items()
               for d, dt in dtypes.items()}
    for n in sets:
        local, glob = dsg_masks(batches[n, "bfloat16"])
        dens = (float(local.float().mean()), float(glob.float().mean()))
        log(f"DSG-DETR set ({n}) {'random classes' if n == 'a' else 'tracklets'}: {B} videos x "
            f"{N_FRAMES} frames, {N_RELS} relation slots; allowed pairs local {dens[0]:.4f}, "
            f"global {dens[1]:.4f}")
        if n == "b" and dens[1] < 0.2:
            fail(f"set (b)'s global masks allow {dens[1]:.4f} of the pairs: not tracklets")
    kw = dict(mode="sgdet", feat_dim=FEAT, device=dev)
    t0 = time.perf_counter()
    models = {(d, fused): DSGDETR(dtype=dt, fused=fused, generator=torch.Generator().manual_seed(0),
                                  **kw)
              for d, dt in dtypes.items() for fused in (True, False)}
    log(f"models: 4 x DSG-DETR sgdet in {time.perf_counter() - t0:.3f} s")
    one_fwd = {"fwd": 4, "bwd_dq": 0, "bwd_dkv": 0}

    # ---- serving, kernel path against plain path, eval step rate ----
    serve_launches = {}
    for n, es in sets.items():
        ma.reset_launches()
        t0 = time.perf_counter()
        graphs = predict(models["bfloat16", True], es, batch=B, device=dev)
        torch.cuda.synchronize()
        serve_launches[n] = dict(ma.LAUNCHES)
        log(f"DSG-DETR serve.predict set ({n}): {len(graphs)} scene graphs in "
            f"{time.perf_counter() - t0:.3f} s wall; launches {serve_launches[n]}")
        if serve_launches[n] != one_fwd:
            fail(f"DSG-DETR serving launched {serve_launches[n]}, expected {one_fwd}")
        if len(graphs) != B or any(not gr["triplets"] for gr in graphs) or not all(
                np.isfinite(t["score"]) for gr in graphs for t in gr["triplets"]):
            fail("DSG-DETR serve.predict did not return one finite scene graph per video")
    for n in sets:
        for d in dtypes:
            ker = eval_step(models[d, True], batches[n, d])
            pln = eval_step(models[d, False], batches[n, d])
            diffs = {}
            for key in HEADS + ("global_output",):
                a, b = ker[key], pln[key]
                if a.shape[0] != B or not bool(a.isfinite().all()):
                    fail(f"DSG-DETR {d} {key}: shape {tuple(a.shape)} or non-finite values")
                diffs[key] = float((a.float() - b.float()).abs().max())
                if key in HEADS and diffs[key] > MODEL_TOL[d]:
                    fail(f"DSG-DETR set ({n}) {d} {key}: kernel path differs from plain by "
                         f"{diffs[key]} > {MODEL_TOL[d]}")
            log(f"DSG-DETR set ({n}) {d} kernel vs plain max_abs_diff: "
                + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()))
    del ker, pln
    frames = B * N_FRAMES
    eval_ms = {}
    for n in sets:
        for fused in (True, False):
            m, batch = models["bfloat16", fused], batches[n, "bfloat16"]
            eval_ms[n, fused] = cuda_ms(lambda: eval_step(m, batch), iters=10)
            log(f"DSG-DETR eval_step bf16 set ({n}) {'kernel' if fused else 'plain'} attention: "
                f"{eval_ms[n, fused]:.3f} ms/step, {frames / eval_ms[n, fused] * 1e3:.1f} "
                f"frames/s (B={B} x {N_FRAMES} frames); card {card}")

    # ---- training on set (b) ----
    for d in dtypes:
        ma.reset_launches()
        ker = train_grads(models[d, True], batches["b", d], 7, dev)
        torch.cuda.synchronize()
        got = dict(ma.LAUNCHES)
        ma.reset_launches()
        pln = train_grads(models[d, False], batches["b", d], 7, dev)
        if got != {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4} or any(ma.LAUNCHES.values()):
            fail(f"DSG-DETR {d} train forward/backward launched {got} (kernel path) and "
                 f"{dict(ma.LAUNCHES)} (plain path)")
        worst, name, floored = compare_grads(ker, pln, f"DSG-DETR {d} train gradients",
                                             TRAIN_GRAD_TOL[d])
        log(f"DSG-DETR train grads {d} set (b) kernel vs plain attention (dropout {RATE}, same "
            f"generator seed): {len(pln)} tensors, worst ||dg||/||g|| {worst:.3e} at {name} "
            f"(tol {TRAIN_GRAD_TOL[d]}); {floored} denominators under the floor")
    del ker, pln
    batch_b = batches["b", "bfloat16"]
    train_ms, train_launches, kept = {}, {}, None
    for fused in (True, False):
        m = models["bfloat16", fused]
        st = create_train_state(m, lr=1e-5)
        step = make_train_step(m, st.optimizer)
        gen = torch.Generator(device=dev).manual_seed(11)
        for _ in range(2):                        # warm-up
            st, met = step(st, batch_b, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ma.reset_launches()
        t0 = time.perf_counter()
        totals_t = []
        for _ in range(TRAIN_STEPS):
            st, met = step(st, batch_b, gen)
            totals_t.append(met["total"])
        torch.cuda.synchronize()
        train_ms[fused] = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        train_launches[fused] = dict(ma.LAUNCHES)
        losses = [float(t) for t in totals_t]
        label = "kernel" if fused else "plain"
        log(f"DSG-DETR train_step bf16 set (b) {label} attention: {train_ms[fused]:.3f} ms/step, "
            f"{frames / train_ms[fused] * 1e3:.1f} frames/s (B={B} x {N_FRAMES} frames, "
            f"{TRAIN_STEPS} steps after 2 warm-up), losses {[round(x, 4) for x in losses]}, "
            f"skipped {st.skipped}, launches {train_launches[fused]}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; card {card}")
        if not all(np.isfinite(losses)) or st.skipped != 0:
            fail(f"DSG-DETR bf16 train steps ({label}): losses {losses}, skipped {st.skipped}")
        want = ({"fwd": 4 * TRAIN_STEPS, "bwd_dq": 4 * TRAIN_STEPS, "bwd_dkv": 4 * TRAIN_STEPS}
                if fused else {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0})
        if train_launches[fused] != want:
            fail(f"DSG-DETR train steps ({label}) launched {train_launches[fused]}, "
                 f"expected {want}")
        if fused:
            kept = (st, step, gen)
        del st, step

    # ---- the kernels on DSG-DETR's own inputs, per allowed pair ----
    eval_rows, train_rows = {}, {}
    st, step, gen = kept
    for n in sets:
        calls = capture_attention(models["bfloat16", True],
                                  lambda: eval_step(models["bfloat16", True],
                                                    batches[n, "bfloat16"]))
        eval_rows[n] = time_eval_calls(ma, calls, "staged", f"DSG-DETR eval set ({n})")
        del calls
        holder = {}

        def one_step():
            holder["st"], _ = step(st, batches[n, "bfloat16"], gen)
        records = record_train_attention(ma, one_step)
        st = holder["st"]
        if len(records) != 4 or not all("g" in r for r in records):
            fail(f"recorded {len(records)} DSG-DETR attention calls with gradients in one step")
        train_rows[n] = time_train_records(ma, records, f"DSG-DETR train set ({n})", "staged")
        del records
    for n in sets:
        e, t = eval_rows[n], train_rows[n]
        log(f"DSG-DETR set ({n}) per step: eval forward {e['ms']:.4f} ms (plain "
            f"{e['plain_ms']:.4f}, sdpa {e['library_ms']:.4f}, bound {e['bound_ms']:.4f}) = "
            f"{e['ms'] / eval_ms[n, True] * 100:.1f}% of the eval step; train fwd "
            f"{t['fwd']['ms']:.4f}, dQ {t['bwd_dq']['ms']:.4f}, dK/dV {t['bwd_dkv']['ms']:.4f} ms; "
            f"ns per allowed (query, key) pair, 8 heads: eval fwd "
            f"{e['ms'] * 1e6 / e['pairs']:.3f}, train fwd "
            f"{t['fwd']['ms'] * 1e6 / t['fwd']['pairs']:.3f}, dQ "
            f"{t['bwd_dq']['ms'] * 1e6 / t['bwd_dq']['pairs']:.3f}, dK/dV "
            f"{t['bwd_dkv']['ms'] * 1e6 / t['bwd_dkv']['pairs']:.3f}; card {card}")
    del kept, st, step, gen
    for m in models.values():
        m.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # ---- the tracklet encoder: sgcls, D = 297 float32 on the tiled route ----
    # its box-position BatchNorm is given the running statistics of the
    # boxes it reads, as a trained head's would hold: drawn near (0, 1)
    # against pixel coordinates of ~400, it would give the first layer
    # logits of ~2400, where any two float32 summation orders disagree
    # (a check of conditioning, not of the kernel)
    cz = center_size(batch_b.boxes)[batch_b.box_mask].float()
    sg = {}
    for fused in (True, False):
        sg[fused] = DSGDETR(mode="sgcls", feat_dim=FEAT, dtype=bf16, fused=fused, device=dev,
                            generator=torch.Generator().manual_seed(1))
        bn = sg[fused].object_classifier.pos_bn
        bn.running_mean.copy_(cz.mean(0))
        bn.running_var.copy_(cz.var(0))
    calls = capture_attention(sg[True].object_classifier, lambda: eval_step(sg[True], batch_b))
    if len(calls) != 3:
        fail(f"the tracklet encoder made {len(calls)} attention calls, expected 3")
    tracklet_kernel_checks(ma, calls, torch.Generator(device=dev).manual_seed(5), dev)
    d297 = time_eval_calls(ma, calls, TRACKLET_ROUTE, "tracklet encoder eval")
    del calls
    # boxes grouped by their labels, as training groups them: the tracker's
    # ids serve evaluation only (tools/train_DSG_DETR.py:5-9)
    ma.reset_launches()
    held = {}
    by_dim = launches_by_head_dim(
        ma, lambda: held.update(ker=train_grads(sg[True], batch_b, 7, dev)))
    torch.cuda.synchronize()
    got, ker = dict(ma.LAUNCHES), held.pop("ker")
    pln = train_grads(sg[False], batch_b, 7, dev)
    enc_train = by_dim.get(TRACKLET_D)
    if got != {"fwd": 7, "bwd_dq": 7, "bwd_dkv": 7} or enc_train != {"fwd": 3, "bwd_dq": 3,
                                                                     "bwd_dkv": 3}:
        fail(f"the sgcls train forward/backward launched {got}, {enc_train} of them at "
             f"D = {TRACKLET_D}; expected 7 of each, 3 at D = {TRACKLET_D}")
    worst, name, floored = compare_grads(ker, pln, "DSG-DETR sgcls bf16 train gradients",
                                         TRAIN_GRAD_TOL["bfloat16"])
    log(f"DSG-DETR sgcls train grads set (b), boxes grouped by label, kernel vs plain "
        f"attention: {len(pln)} tensors, worst ||dg||/||g|| {worst:.3e} at {name} "
        f"(tol {TRAIN_GRAD_TOL['bfloat16']}); {floored} denominators under the floor; "
        f"launches {got}, {enc_train} of them in the tracklet encoder")
    del ker, pln, sg[False]
    # the tracklet encoder's train calls (D = 297, float32, dropout 0.1) on
    # their own inputs and output gradients
    records = [rec for rec in record_train_attention(
        ma, lambda: train_grads(sg[True], batch_b, 7, dev)) if rec["q"].shape[-1] == TRACKLET_D]
    if len(records) != 3 or not all("g" in rec for rec in records):
        fail(f"recorded {len(records)} tracklet-encoder attention calls with gradients")
    d297_train = time_train_records(ma, records, "tracklet encoder train", TRACKLET_ROUTE)
    del records
    log("tracklet encoder per sgcls train step (3 + 3 + 3 launches, D = "
        f"{TRACKLET_D}, route {TRACKLET_ROUTE}): " + "; ".join(
            f"{n} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, "
            f"library {r['library_ms']:.4f}"
            + (f", per-element {r['per_element_ms']:.4f}" if r["per_element_ms"] else "") + ")"
            for n, r in d297_train.items())
        + f"; eval forward {d297['ms']:.4f} ms"
        + (f" (per-element {d297['parent_ms']['per-element']:.4f})" if d297["parent_ms"]
           else "")
        + f"; card {card}")

    # ---- evaluation: evaluate_epoch with its promotion, set (b) ----
    # the host evaluator scores the eval step's outputs on the batches the
    # epoch loop forms, so both score the same predictions
    model = models["bfloat16", True]
    gts = [make_synthetic_gt(e, np.random.default_rng(6000 + i)) for i, e in enumerate(sets["b"])]
    ebatches = [list(zip(gts[s:s + EVAL_BATCH], sets["b"][s:s + EVAL_BATCH]))
                for s in range(0, B, EVAL_BATCH)]
    ev = SceneGraphEvaluator("sgdet")
    ma.reset_launches()
    for items in ebatches:
        out = eval_step(model, place_entries([e for _, e in items], rel_bf16=True, device=dev))
        host_out = {k: to_numpy(out[k]) for k in epoch_mod.EVAL_KEYS}
        for i, (gt, e) in enumerate(items):
            ev.evaluate_scene_graph(gt, entry_to_eval_pred(e, {k: v[i]
                                                               for k, v in host_out.items()}))
    torch.cuda.synchronize()
    want = {"fwd": 4 * len(ebatches), "bwd_dq": 0, "bwd_dkv": 0}
    if dict(ma.LAUNCHES) != want:
        fail(f"the DSG-DETR eval steps launched {dict(ma.LAUNCHES)}, expected {want}")
    check_recalls(ev, "DSG-DETR sgdet")
    log(recall_line(ev) + f"  (DSG-DETR sgdet, set (b), {B} videos x {N_FRAMES} frames)")
    promo = epoch_mod.DeviceEvalPromotion(burnin=16, recheck_every=64)
    ma.reset_launches()
    t0 = time.perf_counter()
    epoch_mod.evaluate_epoch(model, ebatches, promotion=promo, device=dev)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    if dict(ma.LAUNCHES) != want:
        fail(f"DSG-DETR evaluate_epoch launched {dict(ma.LAUNCHES)}, expected {want}")
    if not promo.promoted or abs(promo.score(20) - ev.mean_score(20)) > EVAL_ATOL:
        fail(f"DSG-DETR evaluate_epoch: promoted {promo.promoted} (checked {promo.checked}), "
             f"score(20) {promo.score(20)} against the host's {ev.mean_score(20)}")
    log(f"DSG-DETR evaluate_epoch: {B} videos in batches of {EVAL_BATCH}, promoted after "
        f"{promo.checked} host-checked videos, score(20) {promo.score(20):.6f} = host "
        f"{ev.mean_score(20):.6f}; wall {epoch_s:.3f} s; card {card}")

    # ---- the sgcls two-stage flow with tracker ids (test_DSG_DETR.py:53-60) ----
    sub, sub_gts = sets["b"][:SGCLS_VIDEOS], gts[:SGCLS_VIDEOS]
    costs = []
    host_solver = matcher_mod.solve_lsap_host

    def recording_solver(cost):
        costs.append(np.array(cost))
        return host_solver(cost)

    matcher_mod.solve_lsap_host = recording_solver
    t0 = time.perf_counter()
    try:
        gid_np = np.stack([sgcls_group_ids(e, IM_SIZE) for e in sub])
    finally:
        matcher_mod.solve_lsap_host = host_solver
    track_ms = (time.perf_counter() - t0) / len(sub) * 1e3
    gid = torch.from_numpy(gid_np).to(dev)
    tracklets = [len(set(g[:int(e.box_mask.sum())].tolist())) for g, e in zip(gid_np, sub)]
    # the tracklet encoder's own launches: the forward launches made while
    # the object classifier runs, read around each of its calls
    enc = {"calls": 0, "fwd": 0}

    def enc_before(*_):
        enc["calls"] += 1
        enc["fwd"] -= ma.LAUNCHES["fwd"]

    def enc_after(*_):
        enc["fwd"] += ma.LAUNCHES["fwd"]

    oc = sg[True].object_classifier
    hooks = [oc.register_forward_pre_hook(enc_before), oc.register_forward_hook(enc_after)]
    ma.reset_launches()
    with torch.inference_mode():
        stage1 = to_numpy(sg[True](place_entries(sub, rel_bf16=True, device=dev), group_id=gid)["distribution"])
    stage2_entries = []
    for i, e in enumerate(sub):
        nb = int(e.box_mask.sum())
        frames_i = e.box_frame[:nb].numpy()
        assign = sgcls_assign(stage1[i, :nb], frames_i)
        assign.update(boxes=e.boxes[:nb].numpy(), box_frame=frames_i,
                      features=e.features[:nb].numpy())
        e2 = build_infer_entry(assign, int(e.num_frames), e.n_boxes, e.n_rels, feat_dim=FEAT,
                               compute_spatial_masks=False)
        if e2 is None:
            fail(f"DSG-DETR sgcls: video {i} has no person-object pair after assignment")
        stage2_entries.append(e2)
    with torch.inference_mode():
        out2 = sg[True](place_entries(stage2_entries, rel_bf16=True, device=dev), group_id=gid)
    torch.cuda.synchronize()
    sg_launches = dict(ma.LAUNCHES)
    for h in hooks:
        h.remove()
    want = {"fwd": 14, "bwd_dq": 0, "bwd_dkv": 0}
    if sg_launches != want or enc != {"calls": 2, "fwd": 6}:
        fail(f"the DSG-DETR sgcls two stages launched {sg_launches}, {enc['fwd']} of them in "
             f"{enc['calls']} tracklet-encoder calls; expected {want}, 3 a call in 2 calls")
    out2 = {k: to_numpy(out2[k]) for k in epoch_mod.EVAL_KEYS}
    ev_cls = SceneGraphEvaluator("sgcls")
    for i, (gt, e2) in enumerate(zip(sub_gts, stage2_entries)):
        ev_cls.evaluate_scene_graph(gt, entry_to_eval_pred(e2, {k: v[i] for k, v in out2.items()}))
    check_recalls(ev_cls, "DSG-DETR sgcls")
    log(recall_line(ev_cls) + f"  (DSG-DETR sgcls two-stage, {SGCLS_VIDEOS} videos of set (b), "
        f"tracker ids on both stages: {tracklets} tracklets of {N_BOXES} boxes, tracker "
        f"{track_ms:.1f} ms/video on the host; launches {sg_launches}, tracklet encoder "
        f"{enc['fwd']} in {enc['calls']} calls, relation {sg_launches['fwd'] - enc['fwd']})")
    log(auction_checks(costs, dev))
    log(f"DSG-DETR phase wall {time.perf_counter() - t_phase:.3f} s; card {card}")

    tb = train_rows["b"]
    return [attention_row("masked_mha_dsg_detr", 143, serve_launches["b"]["fwd"], eval_rows["b"]),
            attention_row("masked_mha_fwd_train_dsg_detr", 143, train_launches[True]["fwd"],
                          tb["fwd"]),
            attention_row("masked_mha_bwd_dq_dsg_detr", 157, train_launches[True]["bwd_dq"],
                          tb["bwd_dq"]),
            attention_row("masked_mha_bwd_dkv_dsg_detr", 157, train_launches[True]["bwd_dkv"],
                          tb["bwd_dkv"]),
            attention_row("masked_mha_d297_tracklet", 143, enc["fwd"], d297),
            attention_row("masked_mha_fwd_train_d297_tracklet", 143, enc_train["fwd"],
                          d297_train["fwd"]),
            attention_row("masked_mha_bwd_dq_d297_tracklet", 157, enc_train["bwd_dq"],
                          d297_train["bwd_dq"]),
            attention_row("masked_mha_bwd_dkv_d297_tracklet", 157, enc_train["bwd_dkv"],
                          d297_train["bwd_dkv"])]


# ------------------------------------------------------------- data engine
AG_VIDEOS, AG_OBJS, AG_SEED = 128, 3, 4000  # bench_train_e2e's split (128 videos x 32
# frames, a person and 3 objects a frame): it fills the 128-box / 96-relation bucket
AG_DETS = 36                     # detections a frame (VinVL gives 10-100; 36 is the fixed
# count of bottom-up features): the person, the AG_OBJS objects and detections of
# OpenImages classes outside Action Genome, which grounding reads and drops
PARITY_VIDEOS = 8                # videos grounded by both paths, in train and in test mode
UNION_VIDEOS, UNION_HW = 2, (480, 640)  # videos given frames for live union features
EVAL_VIDEOS = 64                 # test videos in phase 13's evaluate_epoch
TRUNK_CONVS, HEAD_CONVS = 45, 2  # grouped convs of a C4 pass / of a C5 head pass
STORE_GB = 10.0                  # the device Entry store's budget


def write_synthetic_ag(root: str, n_videos: int, n_frames: int, feat_dim: int, n_objs: int,
                       n_dets: int, seed: int) -> str:
    """An Action Genome split on disk in the reference's schema (the test
    fixture's, tests/fixtures.build_micro_ag, plus the dets_f32.npy sidecars
    the native engine reads): frame_features/{video}/{frame}/dets.npy,
    dets_f32.npy and feat.npy; final_ag_data_w_neg.pkl, triplets_LLM4SGG.pkl,
    ag_img_info_{train,test}.pkl; annotations/person_bbox.pkl and
    object_bbox_and_relationship(_filtersmall).pkl, every frame of the test
    set, the videos written on threads, each from its own child generator
    of `seed`. Each frame: `n_dets` detections in random order, a person,
    `n_objs` objects of classes the OI -> AG map sends to one AG class, each
    annotated with one relation of each kind, and the rest of classes the
    map sends to no AG class (grounding drops them in train and test mode).
    Returns the AG directory."""
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    from nl_vsgg_tpu_torch.data import schema
    from nl_vsgg_tpu_torch.data.grounding import DETS_F32, dets_to_f32

    seeds = np.random.SeedSequence(seed)
    rng = np.random.default_rng(seeds)
    tax = schema.load_taxonomy()
    oi_to_ag, ag_to_oi = schema.load_oi_ag_maps()
    person_ids = list(ag_to_oi[1])
    single = [(k, v[0]) for k, v in oi_to_ag.items()
              if len(v) == 1 and k not in set(person_ids) and v[0] >= 2]
    unmapped = np.array(sorted(k for k, v in oi_to_ag.items() if not v), np.int64)
    n_other = n_dets - 1 - n_objs
    pool = rng.standard_normal((4096, feat_dim), dtype=np.float32)  # the others' features
    ag = os.path.join(root, "AG")
    ann_dir = os.path.join(ag, "annotations")
    os.makedirs(ann_dir, exist_ok=True)

    def video(v: int, rng) -> tuple:
        """Video v's frames written, from its own generator; returns its
        pseudo labels, frame list and annotation records."""
        vid = f"vid{v:03d}.mp4"
        frames = [f"{i:06d}.png" for i in range(n_frames)]
        video_gt, person_bbox, object_bbox = [], {}, {}
        for i, fr in enumerate(frames):
            fdir = os.path.join(ag, "frame_features", vid, fr)
            os.makedirs(fdir)
            person_rect = np.array([20 + i, 30, 120 + i, 260], np.float32)
            dets = [{"class": person_ids[0], "conf": np.float32(0.95), "rect": person_rect}]
            frame_gt = [{"person_bbox": person_rect[None]}]
            objs = []
            for j, p in enumerate(rng.choice(len(single), size=n_objs, replace=False)):
                oi_cls, ag_cls = single[int(p)]
                rect = np.array([40 + 50 * j, 60, 110 + 50 * j, 150], np.float32)
                dets.append({"class": oi_cls, "conf": np.float32(0.7 + 0.1 * j), "rect": rect})
                rels = {"attention_relationship": np.array([int(rng.integers(0, 3))]),
                        "spatial_relationship": np.array([int(rng.integers(0, 6))]),
                        "contacting_relationship": np.array([int(rng.integers(0, 17))])}
                frame_gt.append(dict({"class": int(ag_cls), "bbox": rect}, **rels))
                objs.append((ag_cls, rect, rels))
            xy = rng.uniform(0, (560, 400), (n_other, 2)).astype(np.float32)
            wh = rng.uniform(16, 80, (n_other, 2)).astype(np.float32)
            dets += [{"class": int(c), "conf": np.float32(q), "rect": r} for c, q, r in zip(
                rng.choice(unmapped, n_other), rng.uniform(0.2, 0.9, n_other),
                np.concatenate([xy, xy + wh], 1))]
            o = int(rng.integers(0, len(pool) - n_other))
            feat = np.concatenate([rng.standard_normal((1 + n_objs, feat_dim), dtype=np.float32),
                                   pool[o:o + n_other]])
            order = rng.permutation(n_dets)
            dets = [dets[k] for k in order]
            np.save(os.path.join(fdir, "dets.npy"), np.asarray(dets, object), allow_pickle=True)
            np.save(os.path.join(fdir, DETS_F32), dets_to_f32(dets))
            np.save(os.path.join(fdir, "feat.npy"), feat[order])
            video_gt.append(frame_gt)
            key = f"{vid}/{fr}"
            person_bbox[key] = {"bbox": person_rect[None], "bbox_size": (640, 480)}
            object_bbox[key] = [{
                "class": tax.object_classes[cls],
                "bbox": [float(r[0]), float(r[1]), float(r[2] - r[0]), float(r[3] - r[1])],
                "visible": True, "metadata": {"set": "test"},
                "attention_relationship": [tax.attention_relationships[
                    int(rel["attention_relationship"][0])]],
                "spatial_relationship": [tax.spatial_relationships[
                    int(rel["spatial_relationship"][0])]],
                "contacting_relationship": [tax.contacting_relationships[
                    int(rel["contacting_relationship"][0])]],
            } for cls, r, rel in objs]
        return vid, video_gt, {"frame_list": frames}, person_bbox, object_bbox

    # the videos on threads, each from its own child generator of the seed (numpy's
    # draws and the file writes release the GIL)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        made = list(ex.map(video, range(n_videos),
                           map(np.random.default_rng, seeds.spawn(n_videos))))
    pseudo, frame_lists, img_info, person_bbox, object_bbox = {}, {}, {}, {}, {}
    for vid, video_gt, frame_list, persons, objects in made:
        pseudo[vid], frame_lists[vid], img_info[vid] = video_gt, frame_list, [480.0, 640.0, 1.0]
        person_bbox.update(persons)
        object_bbox.update(objects)
    for path, obj in ((os.path.join(ag, "final_ag_data_w_neg.pkl"), pseudo),
                      (os.path.join(ag, "triplets_LLM4SGG.pkl"), frame_lists),
                      (os.path.join(ag, "ag_img_info_train.pkl"), img_info),
                      (os.path.join(ag, "ag_img_info_test.pkl"), img_info),
                      (os.path.join(ann_dir, "person_bbox.pkl"), person_bbox),
                      (os.path.join(ann_dir, "object_bbox_and_relationship_filtersmall.pkl"),
                       object_bbox),
                      (os.path.join(ann_dir, "object_bbox_and_relationship.pkl"), object_bbox)):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    return ag


def same_entries(a, b) -> str | None:
    """The first Entry field whose dtype, shape or bits differ, else None."""
    import dataclasses
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype != y.dtype or x.shape != y.shape or not bool((x == y).all()):
            return f.name
    return None


def record_detector_kernels(run):
    """(run(), recorded): `run` with the detector's RoIAlign and grouped-conv
    calls recorded, the first call of each (kernel, input shapes) kept with
    its inputs and output for `check_recorded`."""
    import torch

    import nl_vsgg_tpu_torch.detector.resnet as dresnet
    import nl_vsgg_tpu_torch.detector.roi_box as droi

    recorded = {}

    def recorder(kind, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            key = (kind,) + tuple(tuple(a.shape) for a in args if torch.is_tensor(a))
            if key not in recorded:
                recorded[key] = ([a.clone() if torch.is_tensor(a) else a for a in args],
                                 kw, out.clone())
            return out
        return wrapped

    ra_fn, gc_fn = droi.roi_align, dresnet.grouped_conv3x3
    droi.roi_align = recorder("roi_align", ra_fn)
    dresnet.grouped_conv3x3 = recorder("grouped_conv3x3", gc_fn)
    try:
        return run(), recorded
    finally:
        droi.roi_align, dresnet.grouped_conv3x3 = ra_fn, gc_fn


def check_recorded(recorded, what: str) -> list[str]:
    """Each call `record_detector_kernels` kept against its plain version on
    the same inputs (det_kernel_err); fails on a disagreement. Returns one
    line a call."""
    from nl_vsgg_tpu_torch.ops import grouped_conv as gc, roi_align as ra

    checked = []
    for key, (args, kw, out) in recorded.items():
        plain_fn = ra.roi_align_reference if key[0] == "roi_align" else \
            gc.grouped_conv3x3_reference
        ref = plain_fn(*args, **kw)
        err, ok = det_kernel_err(out, ref)
        checked.append(f"{key[0]} {key[1]} {str(out.dtype)[6:]}: max_abs_err {err:.3e}, "
                       f"max |ref| {float(ref.float().abs().max()):.3e}")
        if not ok:
            fail(f"{what}: {key[0]} at {key[1:]} disagrees with its plain version "
                 f"(max_abs_err {err:.3e})")
    return checked


def data_phases(dev, card, det, then=None) -> None:
    """Phase 13: the data path at full width. A synthetic Action Genome
    split on disk (AG_VIDEOS videos x N_FRAMES frames, feat FEAT) grounded
    by the native engine (equal to the python path on PARITY_VIDEOS videos
    in train and in test mode), prefetched, bucketed, placed and trained
    (STTran sgdet, bf16, full width) for a cold epoch that fills the device
    Entry store and a warm epoch gathered from it; a stored gather against
    `place_entries`, the train gradients of a grounded batch through the
    kernels against plain attention, each epoch traced for the card's busy
    share; live union features from `det` (phase 8's bf16 detector) with
    the union cache, and a train step on them; `evaluate_epoch` on the test
    split through the prefetcher. `then(ag, root)` (phase 14) runs on the
    same dataset before it is removed."""
    import shutil
    import tempfile
    import threading

    import torch

    from nl_vsgg_tpu_torch.data import grounding as gr
    from nl_vsgg_tpu_torch.data.action_genome import AGTest, AGTrain
    from nl_vsgg_tpu_torch.data.device_store import DeviceEntryStore
    from nl_vsgg_tpu_torch.data.pipeline import (GroundingPrefetcher, TruncationCounter,
                                                 bucket_events)
    from nl_vsgg_tpu_torch.eval import epoch as epoch_mod
    from nl_vsgg_tpu_torch.models.sttran import STTran
    from nl_vsgg_tpu_torch.ops import grouped_conv as gc, masked_attention as ma, roi_align as ra
    from nl_vsgg_tpu_torch.tools import train_sttran as ts
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.train.step import make_train_step, place_entries
    from nl_vsgg_tpu_torch.utils import native_io
    from nl_vsgg_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="phase13_", dir=os.path.join(HERE, "build"))
    nat_fn, py_fn = ts.wk_forward_native, ts.wk_forward
    try:
        t0 = time.perf_counter()
        ag = write_synthetic_ag(root, AG_VIDEOS, N_FRAMES, FEAT, AG_OBJS, AG_DETS, AG_SEED)
        log(f"dataset: {AG_VIDEOS} videos x {N_FRAMES} frames ({AG_DETS} detections a frame: a "
            f"person, {AG_OBJS} objects and {AG_DETS - 1 - AG_OBJS} of classes outside Action "
            f"Genome; feat {FEAT}) written in {time.perf_counter() - t0:.3f} s")
        cfg = load_config(None, {
            "data_path": ag, "frame_features_path": os.path.join(ag, "frame_features"),
            "feat_dim": FEAT, "dtype": "bfloat16", "batch_videos": B, "num_workers": 4,
            "use_native_grounding": True, "use_native_io": True,
            "device_spatial_masks": True, "entry_cache": os.path.join(root, "entry_cache"),
            "device_entry_store_gb": STORE_GB,
            "buckets": {"max_frames": [N_FRAMES], "max_boxes": [N_BOXES],
                        "max_rels": [N_RELS]}})
        ds = AGTrain(ag, remove_one_frame_video=False)
        ds_test = AGTest(os.path.join(ag, "annotations"))
        if len(ds) != AG_VIDEOS or len(ds_test) != AG_VIDEOS:
            fail(f"AGTrain / AGTest read {len(ds)} / {len(ds_test)} videos of {AG_VIDEOS}")
        if native_io.get_lib() is None:
            fail("the native host library did not build")

        # ---- the native engine against the python path ----
        ms = {}
        for is_train, split in ((True, ds), (False, ds_test)):
            for path in ("native", "python"):
                ms[path, is_train] = []
            for i in range(-1, PARITY_VIDEOS):          # -1: an untimed warm-up
                paths = [os.path.join(cfg.frame_features_path, f)
                         for f in split.video_list[max(i, 0)]]
                gt = split.gt_annotations[max(i, 0)]
                t0 = time.perf_counter()
                e_nat = gr.wk_forward_native(paths, gt, is_train, cfg.buckets.max_boxes,
                                             cfg.buckets.max_rels, feat_dim=FEAT)
                t1 = time.perf_counter()
                e_py = gr.wk_forward(gr.load_frame_features(paths, use_native=False,
                                                            feat_dim=FEAT),
                                     gt, is_train, cfg.buckets.max_boxes, cfg.buckets.max_rels,
                                     feat_dim=FEAT, compute_spatial_masks=False)
                t2 = time.perf_counter()
                if e_nat is gr._NATIVE_UNAVAILABLE or e_nat is None or e_py is None:
                    fail(f"grounding video {i} (train {is_train}): native {e_nat}, python "
                         f"{e_py}")
                diff = same_entries(e_nat, e_py)
                if diff is not None:
                    fail(f"native and python grounding differ in {diff} (video {i}, train "
                         f"{is_train})")
                if i >= 0:
                    ms["native", is_train].append((t1 - t0) * 1e3)
                    ms["python", is_train].append((t2 - t1) * 1e3)
        log(f"grounding, native = python on {PARITY_VIDEOS} videos in train and in test mode "
            f"(every field, exact): ms/video (host clock, one thread, feature reads included) "
            + ", ".join(f"{p} {'train' if t else 'test'} {np.mean(v):.3f}"
                        for (p, t), v in ms.items()))

        # ---- the composed loop: ground -> prefetch -> bucket -> place -> step ----
        model = STTran(mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=3,
                       dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                       device=dev)
        st = create_train_state(model, lr=cfg.lr)
        step = make_train_step(model, st.optimizer)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        nocache = cfg.replace(entry_cache="")
        warm = place_entries([ts.ground_video(ds, 0, nocache, True, cfg.buckets)] * B,
                             zero_union=True, rel_bf16=True, device=dev)
        st, _ = step(st, warm, gen)                  # warm-up, outside the epochs
        torch.cuda.synchronize()
        del warm

        lock = threading.Lock()
        calls = {"native": 0, "python": 0}

        def count_native(*a, **kw):
            e = nat_fn(*a, **kw)
            with lock:
                calls["native"] += e is not gr._NATIVE_UNAVAILABLE
            return e

        def count_python(*a, **kw):
            with lock:
                calls["python"] += 1
            return py_fn(*a, **kw)

        ts.wk_forward_native, ts.wk_forward = count_native, count_python
        store = DeviceEntryStore(budget_bytes=int(cfg.device_entry_store_gb * 1e9), device=dev)
        trunc = TruncationCounter()
        frames_of: dict[int, int] = {}
        state = {"st": st}

        def run_epoch(epoch: int, c, use_store: bool, fill: bool) -> dict:
            host = {"ground": 0.0, "place": 0.0, "store": 0.0}
            mets = []
            order = np.random.default_rng(cfg.seed + epoch).permutation(len(ds)).tolist()
            stored, misses = store.plan_batches(order, B) if use_store else ([], order)

            def timed_ground(i):
                t = time.perf_counter()
                e = ts.ground_video(ds, int(i), c, True, c.buckets, on_truncate=trunc.add)
                with lock:
                    host["ground"] += time.perf_counter() - t
                return e

            n_frames = 0
            t0 = time.perf_counter()
            for idxs in stored:                       # the device store: indices only
                t = time.perf_counter()
                batch = store.gather(idxs)
                host["store"] += time.perf_counter() - t
                state["st"], m = step(state["st"], batch, gen)
                mets.append(m)
                n_frames += sum(frames_of[i] for i in idxs)
            pre = GroundingPrefetcher(timed_ground, misses, num_workers=c.num_workers)
            for kind, payload in bucket_events(iter(pre), B):
                if kind == "skip":
                    fail(f"video {payload} grounded to no relation")
                t = time.perf_counter()
                batch = place_entries([e for _, e in payload], zero_union=True, rel_bf16=True,
                                      device=dev)
                host["place"] += time.perf_counter() - t
                state["st"], m = step(state["st"], batch, gen)
                mets.append(m)
                if fill and not store.overflow:
                    t = time.perf_counter()
                    store.add_batch([i for i, _ in payload], batch)
                    host["store"] += time.perf_counter() - t
                for i, e in payload:
                    frames_of[i] = int(e.num_frames)
                    n_frames += frames_of[i]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            losses = [float(m["total"]) for m in mets]
            if not all(np.isfinite(losses)) or any(float(m["valid"]) != 1.0 for m in mets):
                fail(f"epoch {epoch}: losses {losses}, valid "
                     f"{[float(m['valid']) for m in mets]}")
            return {"wall": wall, "frames": n_frames, "host": host, "steps": len(mets),
                    "stored": len(stored), "losses": losses}

        ma.reset_launches()
        runs = [run_epoch(0, cfg, True, True), run_epoch(1, cfg, True, False)]
        launched = dict(ma.LAUNCHES)
        n_steps = sum(r["steps"] for r in runs)
        want = {"fwd": 4 * n_steps, "bwd_dq": 4 * n_steps, "bwd_dkv": 4 * n_steps}
        if launched != want:
            fail(f"the two epochs' {n_steps} train steps launched {launched}, expected {want}")
        if calls != {"native": AG_VIDEOS, "python": 0}:
            fail(f"the cold epoch grounded {calls}: every video must take the native engine")
        if runs[1]["stored"] * B != AG_VIDEOS or runs[1]["host"]["ground"] != 0.0:
            fail(f"the warm epoch gathered {runs[1]['stored']} batches from the store")
        dropped = trunc.take()
        if dropped != (0, 0, 0):
            fail(f"bucket truncation dropped (videos, boxes, relations) {dropped}")
        for epoch, r in enumerate(runs):
            h = r["host"]
            log(f"epoch {epoch} ({'cold: ground, place, fill the store' if epoch == 0 else 'warm: gather from the store'}): "
                f"{r['wall']:.3f} s wall, {r['frames'] / r['wall']:.1f} frames/s "
                f"({r['frames']} frames, {r['steps']} steps of {B} videos); host s: ground "
                f"{h['ground']:.3f} (summed over {cfg.num_workers} workers), place {h['place']:.3f}, "
                f"store {h['store']:.3f}; losses {[round(x, 4) for x in r['losses']]}")
        log(f"device store: {store.bytes} bytes for {AG_VIDEOS} videos "
            f"({store.bytes / AG_VIDEOS / 1e6:.3f} MB a video, width-0 union, bf16 rel "
            f"arrays); launches over both epochs {launched}; truncation 0; native engine on "
            f"{calls['native']} of {AG_VIDEOS} videos, python path on 0")

        # ---- a stored gather against place_entries over the same videos ----
        idxs = np.random.default_rng(7).permutation(AG_VIDEOS)[:B].tolist()
        cache = getattr(ds, "_entry_cache_train")
        hits = cache.hits
        t0 = time.perf_counter()
        host_entries = [ts.ground_video(ds, i, cfg, True, cfg.buckets) for i in idxs]
        hit_ms = (time.perf_counter() - t0) / B * 1e3
        if cache.hits - hits != B:
            fail(f"entry cache: {cache.hits - hits} hits of {B} warm loads")
        gathered = store.gather(idxs)
        diff = same_entries(gathered, place_entries(host_entries, zero_union=True,
                                                    rel_bf16=True, device=dev))
        if diff is not None:
            fail(f"the stored gather differs from place_entries in {diff}")
        log(f"store gather = place_entries over the same {B} videos (every field, dtype and "
            f"bits); entry-cache hits {hit_ms:.3f} ms/video (host clock, one thread)")

        # ---- train gradients of a grounded batch: kernels against plain attention ----
        plain = STTran(mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=3,
                       dtype=torch.bfloat16, fused=False, device=dev)
        plain.load_state_dict(model.state_dict())
        ma.reset_launches()
        ker = train_grads(model, gathered, 7, dev)
        torch.cuda.synchronize()
        got = dict(ma.LAUNCHES)
        ma.reset_launches()
        pln = train_grads(plain, gathered, 7, dev)
        if got != {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4} or any(ma.LAUNCHES.values()):
            fail(f"grounded batch forward/backward launched {got} (kernel path) and "
                 f"{dict(ma.LAUNCHES)} (plain path)")
        worst, worst_name, floored = compare_grads(ker, pln, "grounded batch train gradients",
                                                   TRAIN_GRAD_TOL["bfloat16"])
        log(f"train grads on a grounded batch, kernel vs plain attention (bf16, dropout "
            f"{RATE}): {len(pln)} tensors, worst ||dg||/||g|| {worst:.3e} at {worst_name} "
            f"(tol {TRAIN_GRAD_TOL['bfloat16']}); {floored} denominators under the floor")
        del ker, pln, plain, gathered, host_entries

        # ---- each epoch again, traced: the card's busy share ----
        ma.reset_launches()
        traced = []
        for epoch, c, use_store in ((2, nocache, False), (3, cfg, True)):
            box = {}
            tr = device_busy(lambda: box.update(run_epoch(epoch, c, use_store, False)),
                             f"epoch {epoch}")
            traced.append((box, tr))
        n_steps = sum(b["steps"] for b, _ in traced)
        want = {"fwd": 4 * n_steps, "bwd_dq": 4 * n_steps, "bwd_dkv": 4 * n_steps}
        if dict(ma.LAUNCHES) != want or trunc.take() != (0, 0, 0):
            fail(f"the traced epochs launched {dict(ma.LAUNCHES)}, expected {want}")
        for (box, tr), kind in zip(traced, ("cold (grounded again, no entry cache)",
                                            "warm (store)")):
            if tr is not None:
                log(f"epoch traced, {kind}: span {tr['span_ms']:.3f} ms ({box['wall']:.3f} s "
                    f"inside), card busy {tr['busy_ms']:.3f} ms (kernels {tr['kernel_ms']:.3f}, "
                    f"copies to the card {tr['htod_ms']:.3f}, to the host {tr['dtoh_ms']:.3f}), "
                    f"idle share {1 - tr['busy_ms'] / tr['span_ms']:.4f}; card {card}")
        st = state["st"]

        # ---- live union features from phase 8's detector ----
        urng = np.random.default_rng(AG_SEED + 1)
        frames_u = {i: [urng.integers(0, 256, (*UNION_HW, 3), dtype=np.uint8)
                        for _ in range(N_FRAMES)] for i in range(UNION_VIDEOS)}
        base = ts.detector_union_provider(lambda: det, lambda _ds, i: frames_u.get(i))
        ucalls = {"c4": 0, "fn": 0}

        def provider(ds_, i):
            ucalls["c4"] += 1
            fn = base(ds_, i)

            def counted(f, boxes):
                ucalls["fn"] += 1
                return fn(f, boxes)
            return counted

        cfg_u = nocache.replace(union_feat_cache=os.path.join(root, "union_cache"),
                                union_feat_cache_dtype="float32", vinvl_dtype="bfloat16")

        def ground_union():
            ra.reset_launches()
            gc.reset_launches()
            t0 = time.perf_counter()
            es = [ts.ground_video(ds, i, cfg_u, True, cfg.buckets, union_provider=provider)
                  for i in range(UNION_VIDEOS)]
            torch.cuda.synchronize()
            return es, (time.perf_counter() - t0) / UNION_VIDEOS * 1e3, {
                "roi_align": ra.LAUNCHES["roi_align"],
                "grouped_conv3x3": gc.launches()}

        # the first kernel call of each shape on this path (the C4 pass's
        # three conv classes, the head's, one frame's RoIAlign), held against
        # the plain version
        (ues, union_ms, got), recorded = record_detector_kernels(ground_union)
        if sorted(k[0] for k in recorded) != ["grouped_conv3x3"] * 4 + ["roi_align"]:
            fail(f"union path: recorded kernel calls {sorted(recorded)}")
        log(f"union path kernels vs plain on the path's own inputs (tol "
            f"{KERNEL_TOL['torch.bfloat16']} in bf16): "
            + "; ".join(check_recorded(recorded, "union path")))
        del recorded
        want = {"roi_align": ucalls["fn"],
                "grouped_conv3x3": TRUNK_CONVS * ucalls["c4"] + HEAD_CONVS * ucalls["fn"]}
        if got != want or ucalls != {"c4": UNION_VIDEOS, "fn": UNION_VIDEOS * N_FRAMES}:
            fail(f"union features: launches {got}, expected {want} from the calls {ucalls}")
        for e in ues:
            uf = e.union_feat
            live = uf[e.rel_mask].abs().amax(dim=(1, 2, 3))
            if uf.shape != (N_RELS, 7, 7, FEAT) or not bool(uf.isfinite().all()) \
                    or not bool((live > 0).all()):
                fail(f"union features: shape {tuple(uf.shape)}, a relation row without "
                     f"features or non-finite values")
        counted = dict(ucalls)
        ucalls.update(c4=0, fn=0)
        again, hit_union_ms, got = ground_union()
        if any(ucalls.values()) or any(got.values()) or any(
                not torch.equal(a.union_feat, b.union_feat) for a, b in zip(ues, again)):
            fail(f"union cache: the second call extracted ({ucalls}, launches {got}) or "
                 f"differs")
        ma.reset_launches()
        st, m = step(st, place_entries(ues, zero_union=False, rel_bf16=True, device=dev), gen)
        torch.cuda.synchronize()
        if not np.isfinite(float(m["total"])) or float(m["valid"]) != 1.0 \
                or dict(ma.LAUNCHES) != {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}:
            fail(f"train step on union features: loss {float(m['total'])}, valid "
                 f"{float(m['valid'])}, launches {dict(ma.LAUNCHES)}")
        log(f"union features (bf16 detector of phase 8, {UNION_VIDEOS} videos of {N_FRAMES} "
            f"frames {UNION_HW[0]}x{UNION_HW[1]}): {union_ms:.3f} ms/video grounding with the "
            f"provider (host clock), calls {counted}, launches "
            f"{want}; union cache hit {hit_union_ms:.3f} ms/video, no extraction; a train "
            f"step on them (full-width union_feat): loss {float(m['total']):.4f}")
        del ues, again

        # ---- evaluate_epoch through the prefetcher on the test split ----
        trunc_eval = TruncationCounter()

        def get_entry(i):
            return ts.ground_video(ds_test, int(i), cfg, False, cfg.buckets,
                                   on_truncate=trunc_eval.add)

        def batches():
            return epoch_mod.grounded_batches(get_entry, ds_test.gt_annotations,
                                              range(EVAL_VIDEOS), EVAL_BATCH, cfg.num_workers)

        promo = epoch_mod.DeviceEvalPromotion(burnin=16, recheck_every=64)
        ma.reset_launches()
        t0 = time.perf_counter()
        epoch_mod.evaluate_epoch(model, batches(), promotion=promo, device=dev, zero_union=True)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        want = {"fwd": 4 * (-(-EVAL_VIDEOS // EVAL_BATCH)), "bwd_dq": 0, "bwd_dkv": 0}
        if dict(ma.LAUNCHES) != want or trunc_eval.take() != (0, 0, 0):
            fail(f"evaluate_epoch on grounded batches launched {dict(ma.LAUNCHES)}, expected "
                 f"{want}")
        host_ev = epoch_mod.evaluate_epoch(model, batches(), device=dev, zero_union=True)
        diff = abs(promo.score(20) - host_ev.mean_score(20))
        if not promo.promoted or diff > EVAL_ATOL:
            fail(f"evaluate_epoch on grounded batches: promoted {promo.promoted}, score(20) "
                 f"{promo.score(20)} against the host's {host_ev.mean_score(20)}")
        log(recall_line(host_ev) + f"  (sgdet, {EVAL_VIDEOS} grounded test videos)")
        log(f"evaluate_epoch through the prefetcher ({EVAL_VIDEOS} test videos, eval-mode "
            f"grounding, batches of {EVAL_BATCH}): promoted after {promo.checked} videos, "
            f"score(20) {promo.score(20):.6f} = host {host_ev.mean_score(20):.6f}; wall "
            f"{eval_s:.3f} s (grounding and caching the split included)")
        ts.wk_forward_native, ts.wk_forward = nat_fn, py_fn
        log(f"data phase wall {time.perf_counter() - t_phase:.3f} s; card {card}")
        if then is not None:
            state.clear()
            del model, st, step, store
            torch.cuda.empty_cache()
            then(ag, root)
    finally:
        ts.wk_forward_native, ts.wk_forward = nat_fn, py_fn
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------- entry points
P14_GT_VIDEOS = 2                # test videos of the predcls / sgcls CLI runs
P14_VIDEOS = B // 2              # --max_videos of run_training (one partial batch an
#                                  epoch), test_sttran sgdet and the converter's eval
PREDICT_BATCH = 16               # predict's --batch
PREDICT_TOL = 1e-3               # predict (features uploaded bf16) against serve.predict
# a resumed run's final tensors against a straight run's, when not equal: the
# card may sum in another order (the embedding-gather backward's atomics), and
# 4 AdamW steps carry that into the moments -> 1e-3 of each tensor's largest
# magnitude
RESUME_REL = 1e-3
ROWS_ATOL = 1e-6             # R@K rows of two host evaluations of the same weights


def sorted_rows(ev) -> dict:
    """A host evaluator's R@K rows by (sink, K), sorted: the prefetch
    workers score videos in completion order."""
    return {(name, k): np.sort(np.asarray(getattr(ev, name)[k], np.float64))
            for name in ("recall", "recall_nogc", "semi_recall") for k in (10, 20, 50)}


def same_rows(a, b, what: str) -> float:
    """The largest difference of two evaluators' sorted rows; fails past
    ROWS_ATOL or on another row count."""
    ra, rb = sorted_rows(a), sorted_rows(b)
    worst = 0.0
    for key in ra:
        if ra[key].shape != rb[key].shape:
            fail(f"{what}: {key} has {len(ra[key])} rows against {len(rb[key])}")
        worst = max(worst, float(np.abs(ra[key] - rb[key]).max(initial=0.0)))
    if worst > ROWS_ATOL:
        fail(f"{what}: R@K rows differ by {worst:.3e} > {ROWS_ATOL}")
    return worst


def tensors_apart(a: dict, b: dict, what: str) -> str:
    """'equal', or the largest difference relative to each tensor's
    largest magnitude (fails past RESUME_REL)."""
    worst, where = 0.0, ""
    for k, v in b.items():
        w = a[k]
        if torch_equal(w, v):
            continue
        rel = float((w.double() - v.double()).abs().max()) / max(float(v.double().abs().max()),
                                                                 1e-30)
        if rel > worst:
            worst, where = rel, k
    if worst > RESUME_REL:
        fail(f"{what}: {where} differs by {worst:.3e} of its largest magnitude > {RESUME_REL}")
    return "equal" if worst == 0.0 else f"largest difference {worst:.3e} at {where}"


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and bool(torch.equal(a, b))


def entry_point_phases(dev, card, ag: str, root: str) -> dict:
    """Phase 14: the entry points at full width on phase 13's synthetic
    Action Genome, P14_VIDEOS of its videos. STTran sgdet (bf16, 1 + 3
    layers, embed 1936) trained by `run_training` for 2 epochs (cold, filling the device Entry store; warm,
    gathering), each evaluated with the device-eval promotion and
    checkpointed; a resume (1 epoch, then a second run to 2) against that
    straight run; `test_sttran` on its checkpoint (sgdet: rows equal to a
    host evaluation of the same weights; predcls and sgcls on
    P14_GT_VIDEOS videos with phase 8's seeded detector saved as a VinVL
    .pth, frames from an injected reader); DSG-DETR trained 1 epoch and its
    sgcls test flow with tracker ids; `predict` against `serve.predict`;
    the relation-checkpoint converter. Returns the phase's launch counts by
    `kernels` row name."""
    import dataclasses
    import json
    import logging
    import types

    import torch

    import nl_vsgg_tpu_torch.detector.attr_rcnn as attr
    from nl_vsgg_tpu_torch import serve
    from nl_vsgg_tpu_torch.data import schema
    from nl_vsgg_tpu_torch.data.action_genome import AGTest
    from nl_vsgg_tpu_torch.detector.convert import to_maskrcnn_state_dict
    from nl_vsgg_tpu_torch.eval import epoch as epoch_mod
    from nl_vsgg_tpu_torch.ops import grouped_conv as gc, masked_attention as ma, roi_align as ra
    from nl_vsgg_tpu_torch.tools import convert_relation_ckpt as conv
    from nl_vsgg_tpu_torch.tools import predict, test_dsg_detr, test_sttran, train_dsg_detr
    from nl_vsgg_tpu_torch.tools import train_sttran as ts
    from nl_vsgg_tpu_torch.utils.checkpoint import STATE_FILE, load_meta, load_state
    from nl_vsgg_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    ff = os.path.join(ag, "frame_features")
    base = {
        "data_path": ag, "frame_features_path": ff,
        "pseudo_localized_SG_path": os.path.join(ag, "final_ag_data_w_neg.pkl"),
        "feat_dim": FEAT, "enc_layer": 1, "dec_layer": 3, "dtype": "bfloat16",
        "batch_videos": B, "num_workers": 4, "remove_one_frame_video": False,
        "union_box_feature": False, "entry_cache": os.path.join(root, "p14_entry_cache"),
        "device_entry_store_gb": STORE_GB, "device_eval_promote": True, "nepoch": 2,
        "buckets": {"max_frames": [N_FRAMES], "max_boxes": [N_BOXES], "max_rels": [N_RELS]}}
    args = types.SimpleNamespace(max_videos=P14_VIDEOS, device=None)
    ds_test = AGTest(os.path.join(ag, "annotations"))
    n_test = min(P14_VIDEOS, len(ds_test))
    n_eval_batches = -(-n_test // B)
    counts = {}

    def add(name, n):
        counts[name] = counts.get(name, 0) + n

    # the loop instrumented from outside: the train step's readiness, each
    # epoch eval, each checkpoint save, the Entry store
    marks = {"ready": [], "evals": [], "saves": [], "stores": []}
    real = {n: getattr(ts, n) for n in ("make_train_step", "evaluate_epoch", "save_checkpoint",
                                        "DeviceEntryStore")}

    def make_train_step(*a, **kw):
        marks["ready"].append(time.perf_counter())
        return real["make_train_step"](*a, **kw)

    def evaluate_epoch(model, batches, **kw):
        t = time.perf_counter()
        ev = real["evaluate_epoch"](model, batches, **kw)
        torch.cuda.synchronize()
        marks["evals"].append({"t0": t, "t1": time.perf_counter(), "ev": ev,
                               "promotion": kw.get("promotion")})
        return ev

    def save_checkpoint(directory, step, state, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = real["save_checkpoint"](directory, step, state, **kw)
        t1 = time.perf_counter()
        marks["saves"].append({"t0": t, "t1": t1, "path": path,
                               "bytes": os.path.getsize(os.path.join(path, STATE_FILE)),
                               "lr": state.optimizer.param_groups[0]["lr"],
                               "store": marks["stores"][-1].bytes if marks["stores"] else 0})
        return path

    class RecordedStore(real["DeviceEntryStore"]):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            marks["stores"].append(self)

    records: list[str] = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    # the tools' logger: captured (the lines this phase reads are printed)
    logger = logging.getLogger("nl_vsgg_tpu_torch")
    saved = (list(logger.handlers), logger.level, logger.propagate)
    logger.handlers, logger.propagate = [Capture()], False
    logger.setLevel(logging.INFO)
    ts.make_train_step, ts.evaluate_epoch, ts.save_checkpoint, ts.DeviceEntryStore = (
        make_train_step, evaluate_epoch, save_checkpoint, RecordedStore)
    try:
        def train(save_path, build, **over) -> tuple:
            """run_training on `save_path`; returns (state, its epochs'
            marks, wall s)."""
            for v in marks.values():
                v.clear()
            records.clear()
            cfg = load_config(None, dict(base, save_path=save_path, **over))
            t0 = time.perf_counter()
            st = ts.run_training(cfg, args, build)
            torch.cuda.synchronize()
            return st, cfg, time.perf_counter() - t0

        # ---- 1. train: 2 epochs, each evaluated and checkpointed ----
        run_b = os.path.join(root, "p14_B")
        ma.reset_launches()
        st_b, cfg_b, wall_b = train(run_b, ts.build_model)
        got = dict(ma.LAUNCHES)
        want = {"fwd": 4 * st_b.step + 4 * n_eval_batches * 2, "bwd_dq": 4 * st_b.step,
                "bwd_dkv": 4 * st_b.step}
        if st_b.step != 2 * -(-min(P14_VIDEOS, AG_VIDEOS) // B) or st_b.skipped or got != want:
            fail(f"run_training: step {st_b.step}, skipped {st_b.skipped}, launches {got}, "
                 f"expected {want}")
        add("masked_mha", got["fwd"] - 4 * st_b.step)
        add("masked_mha_fwd_train", 4 * st_b.step)
        add("masked_mha_bwd_dq", got["bwd_dq"])
        add("masked_mha_bwd_dkv", got["bwd_dkv"])
        ckpt_b = os.path.join(run_b, "ckpt")
        with open(os.path.join(run_b, "metrics.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "epoch" in r]
        if sorted(os.listdir(ckpt_b)) != ["0", "0.meta.json", "1", "1.meta.json",
                                          "configs.json"] or [r["epoch"] for r in epochs] != [0, 1]:
            fail(f"run_training wrote {sorted(os.listdir(ckpt_b))}, epochs {epochs}")
        phases = [m for m in records if m.startswith("host phases:")]
        start = marks["ready"][0]
        for e in range(2):
            ev, sv = marks["evals"][e], marks["saves"][e]
            train_s = ev["t0"] - start
            promo = ev["promotion"]
            log(f"run_training epoch {e} ({'cold: ground, place, fill the store' if e == 0 else 'warm: gather from the store'}): "
                f"{sv['t1'] - start:.3f} s wall = train {train_s:.3f} s "
                f"({min(P14_VIDEOS, AG_VIDEOS) * N_FRAMES / train_s:.1f} frames/s) + eval "
                f"{ev['t1'] - ev['t0']:.3f} s "
                f"(promoted {promo.promoted} after {promo.checked} videos) + checkpoint "
                f"{(sv['t1'] - sv['t0']) * 1e3:.1f} ms ({sv['bytes']} bytes); mean R@20 "
                f"{epochs[e]['mean_r20']:.6f}, lr after the scheduler {sv['lr']:.3e}; device "
                f"store {sv['store']} bytes; card {card}")
            log("  PhaseTimer (cumulative): " + phases[e].split("\n", 1)[1].replace("\n", "; "))
            start = sv["t1"]
        log(f"run_training: {wall_b:.3f} s in all (datasets, model, {st_b.step} steps, 2 evals, "
            f"2 checkpoints); launches {got} = 4 + 4 + 4 a step and 4 an eval batch")
        last_eval = marks["evals"][1]

        # ---- 2. resume: 1 epoch, then a second run to 2 ----
        run_a = os.path.join(root, "p14_A")
        _, _, wall_1 = train(run_a, ts.build_model, nepoch=1)
        meta_1 = load_meta(os.path.join(run_a, "ckpt"))
        st_a, _, wall_a = train(run_a, ts.build_model)
        resumed = [m for m in records if m.startswith("resumed from checkpoint")]
        epoch_steps = st_b.step // 2
        if resumed != [f"resumed from checkpoint epoch 0 (step {epoch_steps})"] \
                or any("Inference in Epoch (0)" in m for m in records) \
                or len(marks["saves"]) != 1 or st_a.step != st_b.step:
            fail(f"resume: logged {resumed}, step {st_a.step}, saves {len(marks['saves'])}")
        sched_a = load_meta(os.path.join(run_a, "ckpt"))["scheduler"]
        sched_b = load_meta(ckpt_b)["scheduler"]
        if (sched_a["lr"], sched_a["num_bad"]) != (sched_b["lr"], sched_b["num_bad"]) \
                or abs(sched_a["best"] - sched_b["best"]) > ROWS_ATOL \
                or marks["saves"][0]["lr"] != st_b.optimizer.param_groups[0]["lr"]:
            fail(f"resume: scheduler {sched_a} against the straight run's {sched_b} (restored "
                 f"from {meta_1['scheduler']})")
        a, b = load_state(os.path.join(run_a, "ckpt")), load_state(ckpt_b)
        params = tensors_apart(a["model"], b["model"], "resume: parameters")
        moments = tensors_apart(
            {f"{i}.{k}": s[k] for i, s in a["optimizer"]["state"].items()
             for k in ("exp_avg", "exp_avg_sq")},
            {f"{i}.{k}": s[k] for i, s in b["optimizer"]["state"].items()
             for k in ("exp_avg", "exp_avg_sq")}, "resume: AdamW moments")
        log(f"resume: 1 epoch ({wall_1:.3f} s), then a second run logged 'resumed from "
            f"checkpoint epoch 0 (step {epoch_steps})', ran epoch 1 only (step counter "
            f"{epoch_steps} -> {st_a.step}, the scheduler "
            f"{meta_1['scheduler']} restored, after epoch 1 {sched_a} = the straight run's "
            f"{sched_b}) in {wall_a:.3f} s; its final "
            f"checkpoint against the straight run's: parameters {params}, AdamW moments "
            f"{moments} (tol {RESUME_REL} of each tensor's largest magnitude)")
        del a, b, st_a

        # ---- 3. the test CLI, sgdet, on the straight run's checkpoint ----
        ma.reset_launches()
        t0 = time.perf_counter()
        ev_cli = test_sttran.main(["--model_path", ckpt_b, "--device_eval", "--max_videos",
                                   str(P14_VIDEOS)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        add("masked_mha", ma.LAUNCHES["fwd"])
        if last_eval["promotion"].promoted:   # its host rows cover the burn-in only
            ref_ev = epoch_mod.evaluate_epoch(st_b.model, epoch_mod.grounded_batches(
                lambda i: ts.ground_video(ds_test, i, cfg_b, False, cfg_b.buckets),
                ds_test.gt_annotations, range(n_test), B, 4), device=dev,
                zero_union=True)
            against = "a host evaluation of the same weights (the last epoch was promoted)"
        else:
            ref_ev, against = last_eval["ev"], "the last training epoch's evaluator"
        diff = same_rows(ev_cli, ref_ev, "test_sttran sgdet")
        log(f"test_sttran sgdet ({n_test} videos, --device_eval): {cli_s:.3f} s; "
            + recall_line(ev_cli) + f"; rows = {against} (largest difference {diff:.1e})")

        # ---- 4. predcls and sgcls with the VinVL detector ----
        pth = os.path.join(root, "vinvl_phase8.pth")
        t0 = time.perf_counter()
        torch.save(to_maskrcnn_state_dict(detector_weights(5, dev)), pth)
        log(f"phase 8's detector weights (seed 5) saved as a VinVL .pth ({os.path.getsize(pth)} "
            f"bytes) in {time.perf_counter() - t0:.3f} s")

        def read_frames(ds, idx):
            rng = np.random.default_rng(AG_SEED + 100 + idx)
            return [rng.integers(0, 256, (*UNION_HW, 3), dtype=np.uint8)
                    for _ in ds.video_list[idx]]

        calls = {"c4": 0, "head": 0}
        real_union, real_box = attr.AttrRCNNTorch.make_union_feature_fn, \
            attr.AttrRCNNTorch.extract_box_features

        def union_counted(self, frames, bucket_hw=None):
            calls["c4"] += 1
            fn = real_union(self, frames, bucket_hw)

            def counted(f, boxes):
                calls["head"] += 1
                return fn(f, boxes)
            return counted

        def box_counted(self, image, boxes, preprocessed=False):
            calls["c4"] += 1
            calls["head"] += 1
            return real_box(self, image, boxes, preprocessed)

        def gt_cli(mode, tool, extra):
            cfg = load_config(os.path.join(ckpt_b, "configs.json")).replace(
                mode=mode, ckpt=pth, vinvl_dtype="bfloat16")
            path = os.path.join(root, f"p14_{mode}.json")
            with open(path, "w") as f:
                f.write(cfg.to_json())
            calls.update(c4=0, head=0)
            ra.reset_launches()
            gc.reset_launches()
            ma.reset_launches()
            t0 = time.perf_counter()
            ev, rec = record_detector_kernels(lambda: tool.main(
                ["--cfg", path, "--max_videos", str(P14_GT_VIDEOS), *extra],
                read_frames=read_frames))
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            launched = {"roi_align": ra.LAUNCHES["roi_align"],
                        "grouped_conv3x3": gc.launches()}
            want = {"roi_align": calls["head"],
                    "grouped_conv3x3": TRUNK_CONVS * calls["c4"] + HEAD_CONVS * calls["head"]}
            if launched != want or not calls["c4"]:
                fail(f"{tool.__name__} {mode}: launches {launched}, expected {want} from "
                     f"{calls}")
            lines = check_recorded(rec, f"{tool.__name__} {mode}")
            rows = sorted_rows(ev)
            if not all(np.isfinite(r).all() and ((r >= 0) & (r <= 1)).all()
                       for r in rows.values()) or len(rows["recall", 20]) != \
                    P14_GT_VIDEOS * N_FRAMES:
                fail(f"{tool.__name__} {mode}: R@K rows out of range or miscounted")
            add("roi_align", launched["roi_align"])
            add("grouped_conv3x3", launched["grouped_conv3x3"])
            log(f"{tool.__name__.rsplit('.', 1)[1]} {mode} ({P14_GT_VIDEOS} videos, GT boxes, "
                f"VinVL bf16 features from frames of the injected reader): {s:.3f} s; "
                + recall_line(ev) + f"; detector calls {calls}, launches {launched}; attention "
                f"{dict(ma.LAUNCHES)}")
            log(f"  first call of each shape vs plain (tol {KERNEL_TOL['torch.bfloat16']}): "
                + "; ".join(lines))
            return dict(ma.LAUNCHES)

        attr.AttrRCNNTorch.make_union_feature_fn = union_counted
        attr.AttrRCNNTorch.extract_box_features = box_counted
        try:
            got = gt_cli("predcls", test_sttran, ["--model_path", ckpt_b])
            add("masked_mha", got["fwd"])
            got = gt_cli("sgcls", test_sttran, ["--model_path", ckpt_b])
            if got["fwd"] != 4 * 2 * P14_GT_VIDEOS:
                fail(f"test_sttran sgcls launched {got}: 4 a stage, 2 stages a video")
            add("masked_mha", got["fwd"])

            # ---- 5. DSG-DETR: train 1 epoch, then its sgcls test flow ----
            ma.reset_launches()
            st_d, _, wall_d = train(os.path.join(root, "p14_dsg"), train_dsg_detr.build_model,
                                    nepoch=1)
            got = dict(ma.LAUNCHES)
            want = {"fwd": 4 * st_d.step + 4 * n_eval_batches, "bwd_dq": 4 * st_d.step,
                    "bwd_dkv": 4 * st_d.step}
            if got != want or st_d.skipped:
                fail(f"train_dsg_detr: launches {got}, expected {want}; skipped {st_d.skipped}")
            add("masked_mha_dsg_detr", got["fwd"] - 4 * st_d.step)
            add("masked_mha_fwd_train_dsg_detr", 4 * st_d.step)
            add("masked_mha_bwd_dq_dsg_detr", got["bwd_dq"])
            add("masked_mha_bwd_dkv_dsg_detr", got["bwd_dkv"])
            log(f"train_dsg_detr (1 local + 3 global layers, 1 epoch): {wall_d:.3f} s, "
                f"{st_d.step} steps, launches {got}; mean R@20 "
                f"{marks['evals'][0]['promotion'].score(20):.6f}")
            del st_d
            by_dim = {}

            def dsg_sgcls():
                by_dim.update(launches_by_head_dim(ma, lambda: gt_cli(
                    "sgcls", test_dsg_detr, [])))
            dsg_sgcls()
            d297, d242 = by_dim.get(TRACKLET_D, {}), by_dim.get(HEAD_DIM, {})
            if d297.get("fwd") != 6 * P14_GT_VIDEOS or d242.get("fwd") != 8 * P14_GT_VIDEOS:
                fail(f"test_dsg_detr sgcls launches by head dim {by_dim}: expected "
                     f"{6 * P14_GT_VIDEOS} at {TRACKLET_D} (3 tracklet layers, 2 stages a "
                     f"video) and {8 * P14_GT_VIDEOS} at {HEAD_DIM}")
            add("masked_mha_d297_tracklet", d297["fwd"])
            add("masked_mha_dsg_detr", d242["fwd"])
            log(f"test_dsg_detr sgcls launches by head dim {by_dim} (6 tiled a video at "
                f"D = {TRACKLET_D})")
        finally:
            attr.AttrRCNNTorch.make_union_feature_fn = real_union
            attr.AttrRCNNTorch.extract_box_features = real_box

        # ---- 6. predict against serve.predict ----
        out = os.path.join(root, "p14_predict.jsonl")
        ma.reset_launches()
        t0 = time.perf_counter()
        n = predict.main(["--model_path", ckpt_b, "--features_dir", ff, "--batch",
                          str(PREDICT_BATCH), "--out", out])
        torch.cuda.synchronize()
        pred_s = time.perf_counter() - t0
        want = {"fwd": 4 * -(-AG_VIDEOS // PREDICT_BATCH), "bwd_dq": 0, "bwd_dkv": 0}
        if dict(ma.LAUNCHES) != want:
            fail(f"predict launched {dict(ma.LAUNCHES)}, expected {want}")
        add("masked_mha", want["fwd"])
        with open(out) as f:
            lines = {g["video"]: g for g in map(json.loads, f)}
        ds_u = predict.UnlabeledVideos(ff)
        if n != AG_VIDEOS or sorted(lines) != sorted(ds_u.video_ids):
            fail(f"predict wrote {n} lines for {len(set(lines))} videos of {AG_VIDEOS}")
        cfg_p = dataclasses.replace(cfg_b, mode="sgdet", frame_features_path=ff)
        entries = [ts.ground_video(ds_u, i, cfg_p, False, cfg_p.buckets)
                   for i in range(len(ds_u))]
        model = test_sttran.load_weights(ts.build_model(cfg_p, schema.load_taxonomy(), dev),
                                         ckpt_b)
        graphs = serve.predict(model, entries, PREDICT_BATCH, device=dev,
                               video_ids=ds_u.video_ids)
        worst = 0.0
        for g in graphs:
            p = lines[g["video"]]
            if p["objects"] != g["objects"] or p["num_frames"] != g["num_frames"]:
                fail(f"predict {g['video']}: objects differ from serve.predict's")
            key = lambda t: (t["frame"], t["subject"], t["object"], t["predicate"])  # noqa: E731
            ref = {key(t): t["ranking_score"] for t in g["triplets"]}
            cut = min(ref.values())
            seen_scores = []
            for t in p["triplets"]:
                r = ref.get(key(t))
                if r is None:   # past serve.predict's cut: a tie at the cut only
                    r = cut
                worst = max(worst, abs(r - t["ranking_score"]))
                seen_scores.append(r)
            # the order: serve.predict's scores along predict's list fall but
            # for steps within the tolerance
            rises = max((b - a for a, b in zip(seen_scores, seen_scores[1:])), default=0.0)
            if worst > PREDICT_TOL or rises > PREDICT_TOL or len(p["triplets"]) != \
                    len(g["triplets"]):
                fail(f"predict {g['video']}: ranking scores {worst:.3e} from serve.predict's, "
                     f"order rises {rises:.3e} (tol {PREDICT_TOL})")
        log(f"predict ({AG_VIDEOS} videos, --batch {PREDICT_BATCH}, features uploaded bf16): "
            f"{pred_s:.3f} s, {AG_VIDEOS / pred_s:.2f} videos/s (grounding from the entry "
            f"cache, checkpoint load and model build included); one line a video = "
            f"serve.predict on the same entries and weights: objects equal, ranking scores "
            f"within {worst:.3e} (tol {PREDICT_TOL}), the same order")
        del model, graphs, entries

        # ---- 7. the relation-checkpoint converter ----
        ref_path = os.path.join(root, "p14_reference.tar")
        sd = {k: v.detach().cpu() for k, v in st_b.model.state_dict().items()}
        torch.save({"state_dict": sd}, ref_path)
        conv_dir = os.path.join(root, "p14_converted")
        conv.main(["--ckpt", ref_path, "--out", conv_dir, "--cfg",
                   os.path.join(ckpt_b, "configs.json")])
        ma.reset_launches()
        ev_conv = test_sttran.main(["--model_path", conv_dir, "--max_videos", str(P14_VIDEOS)])
        add("masked_mha", ma.LAUNCHES["fwd"])
        diff = same_rows(ev_conv, ev_cli, "converted checkpoint")
        gone = "subj_fc.bias"
        torch.save({"state_dict": {k: v for k, v in sd.items() if k != gone}}, ref_path)
        try:
            conv.main(["--ckpt", ref_path, "--out", conv_dir + "_bad", "--cfg",
                       os.path.join(ckpt_b, "configs.json")])
            fail("the converter took a state dict without subj_fc.bias")
        except ValueError as e:
            if gone not in str(e):
                fail(f"the converter's error does not name {gone}: {e}")
        log(f"convert_relation_ckpt: the trained STTran as {{'state_dict': ...}} -> step-0 "
            f"checkpoint; test_sttran on it = step 3's rows (largest difference {diff:.1e}); "
            f"without {gone}: refused, naming it")
    finally:
        ts.make_train_step, ts.evaluate_epoch, ts.save_checkpoint, ts.DeviceEntryStore = (
            real["make_train_step"], real["evaluate_epoch"], real["save_checkpoint"],
            real["DeviceEntryStore"])
        logger.handlers, logger.level, logger.propagate = saved
    log(f"phase 14 launches by kernels row: {counts}")
    log(f"entry-point phase wall {time.perf_counter() - t_phase:.3f} s; card {card}")
    return counts


P15_VIDEOS, P15_FRAMES = 8, 32   # encode_for_adv's videos x frames (256 images of 224x224x3)
P15_GROUPS = 3                   # caption groups a video, of 1-3 sentences each
P15_DET_VIDEOS, P15_DET_FRAMES = 2, 4  # `preprocess features` from the converted .npz
CLIP_TOL = 1e-4                  # unit embeddings, kernel path vs plain path, float32
P15_PREDICATES = ("holding", "looking at", "touching", "sitting on", "in front of", "wearing",
                  "beneath", "carrying")


def dac_checkpoint(path: str, seed: int) -> dict:
    """A synthetic DAC LLM_cp.pt at ViT-B/32's full width (about 151 M
    weights) written with torch.save under 'state_dict': open_clip's keys,
    LayerNorms at 1 and 0, zero biases, weights N(0, 0.02^2) from a seeded
    CPU generator, and rank-4 LoRA adapters N(0, 0.1^2) in all three
    spellings on every block (out_proj.lora_A, c_fc.lora_A.weight,
    in_proj.lora_A; tests/test_validate_ckpt.py's key set). Returns it."""
    import torch

    from nl_vsgg_tpu_torch.pipelines import clip as C
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=0.02):
        return torch.randn(shape, generator=g) * s

    sd = {"visual.conv1.weight": rnd(C.VISION_WIDTH, 3, C.PATCH, C.PATCH),
          "visual.class_embedding": rnd(C.VISION_WIDTH),
          "visual.positional_embedding": rnd(50, C.VISION_WIDTH),
          "visual.proj": rnd(C.VISION_WIDTH, C.EMBED_DIM),
          "token_embedding.weight": rnd(C.VOCAB, C.TEXT_WIDTH),
          "positional_embedding": rnd(C.CONTEXT, C.TEXT_WIDTH),
          "text_projection": rnd(C.TEXT_WIDTH, C.EMBED_DIM)}
    for key, w in (("visual.ln_pre", C.VISION_WIDTH), ("visual.ln_post", C.VISION_WIDTH),
                   ("ln_final", C.TEXT_WIDTH)):
        sd[key + ".weight"], sd[key + ".bias"] = torch.ones(w), torch.zeros(w)
    for prefix, w, n in (("visual.transformer.resblocks", C.VISION_WIDTH, C.VISION_LAYERS),
                         ("transformer.resblocks", C.TEXT_WIDTH, C.TEXT_LAYERS)):
        for i in range(n):
            p = f"{prefix}.{i}"
            for ln in ("ln_1", "ln_2"):
                sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = torch.ones(w), torch.zeros(w)
            sd.update({p + ".attn.in_proj_weight": rnd(3 * w, w),
                       p + ".attn.in_proj_bias": torch.zeros(3 * w),
                       p + ".attn.out_proj.weight": rnd(w, w),
                       p + ".attn.out_proj.bias": torch.zeros(w),
                       p + ".mlp.c_fc.weight": rnd(4 * w, w), p + ".mlp.c_fc.bias": torch.zeros(4 * w),
                       p + ".mlp.c_proj.weight": rnd(w, 4 * w), p + ".mlp.c_proj.bias": torch.zeros(w),
                       p + ".attn.out_proj.lora_A": rnd(4, w, s=0.1),
                       p + ".attn.out_proj.lora_B": rnd(w, 4, s=0.1),
                       p + ".mlp.c_fc.lora_A.weight": rnd(4, w, s=0.1),
                       p + ".mlp.c_fc.lora_B.weight": rnd(4 * w, 4, s=0.1),
                       p + ".attn.in_proj.lora_A": rnd(4, w, s=0.1),
                       p + ".attn.in_proj.lora_B": rnd(3 * w, 4, s=0.1)})
    torch.save({"state_dict": sd}, path)
    return sd


def merge_table(words) -> list[tuple[str, str]]:
    """A synthetic BPE merge table that builds each word left to right
    (the real CLIP vocabulary file is not in the repository)."""
    merges, seen = [], set()
    for w in words:
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        cur = parts[0]
        for p in parts[1:]:
            if (cur, p) not in seen:
                seen.add((cur, p))
                merges.append((cur, p))
            cur += p
    return merges


def launches_by_route(ma, run) -> dict:
    """The forward launches one `run()` makes, by (route, heads): route
    "staged", "resident", "tiled" or "per-element" and the call's head
    count (12 at CLIP's image tower, 8 at its text tower), read from
    LAUNCHES around each call of the forward launch (`_forward_cuda`)."""
    counts = {}
    orig = ma._forward_cuda

    def counting(q, k, v, *args, **kw):
        before = ma.LAUNCHES["fwd"]
        res = orig(q, k, v, *args, **kw)
        key = (ma.fwd_route(q, k, v), q.shape[2])
        counts[key] = counts.get(key, 0) + ma.LAUNCHES["fwd"] - before
        return res

    ma._forward_cuda = counting
    try:
        run()
    finally:
        ma._forward_cuda = orig
    return counts


RESIDENT_EDGE = (8, 200, 128, 16, 128)  # videos, Lq (four 64-row tiles), Lk, heads, head dim


def resident_edge_checks(ma, g, dev) -> None:
    """The resident forward at the edge of its rule, RESIDENT_EDGE: float32
    column blocks of a fused projection, a random 3% mask with some rows
    fully allowed, some empty and some key columns unseen; dropout off and
    on, with and without lse, against the plain version (out to KERNEL_TOL,
    lse to GRAD_TOL), rows with no allowed key exactly 0 and LSE_EMPTY, one
    launch a call."""
    import torch
    Bv, lq, lk, Hh, D = RESIDENT_EDGE
    E = Hh * D
    q = torch.randn(Bv, lq, 3 * E, device=dev, generator=g)[..., :E].unflatten(-1, (Hh, D))
    kv = torch.randn(Bv, lk, 3 * E, device=dev, generator=g)
    k, v = (kv[..., i * E:(i + 1) * E].unflatten(-1, (Hh, D)) for i in (1, 2))
    allow = torch.rand(Bv, lq, lk, device=dev, generator=g) < 0.03
    allow[:, ::9] = True
    allow[:, 4::9] = False
    allow[:, :, 5::11] = False
    seeds = torch.randint(-2 ** 31, 2 ** 31, (Bv,), generator=g, device=dev, dtype=torch.int32)
    route = ma.fwd_route(q, k, v)
    if route != "resident":
        fail(f"resident edge {(Bv, lq, Hh, D)} x Lk={lk}: route {route}")
    empty, scale, errs = ~allow.any(-1), D ** -0.5, {}
    for rate in (0.0, RATE):
        sd = seeds if rate else None
        for with_lse in (False, True):
            ma.reset_launches()
            out, lse = ma.masked_mha_forward(q, k, v, allow, scale, rate, sd, with_lse)
            torch.cuda.synchronize()
            checks = [("out", out, ma.masked_mha_reference(q, k, v, allow, scale, rate, sd),
                       KERNEL_TOL)]
            if with_lse:
                checks.append(("lse", lse, ma.masked_mha_lse_reference(q, k, allow, scale),
                               GRAD_TOL))
                if not bool((lse.transpose(1, 2)[empty] == ma.LSE_EMPTY).all()):
                    fail("resident edge: rows with no allowed key lack the lse sentinel")
            if ma.LAUNCHES["fwd"] != 1 or not bool((out[empty] == 0).all()):
                fail(f"resident edge: launches {ma.LAUNCHES} or empty rows not 0")
            for name, got, ref, tol in checks:
                err, ok = kernel_err(got, ref, tol)
                errs[name] = max(errs.get(name, 0.0), err)
                if not ok:
                    fail(f"resident edge: {name} disagrees with its plain version at rate "
                         f"{rate}, lse {with_lse} (max_abs_err {err:.3e})")
    log(f"fwd resident edge {(Bv, lq, Hh, D)} x Lk={lk} float32, random 3% mask: dropout "
        f"off and on, with and without lse; max_abs_err "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + "; empty rows exactly 0 and LSE_EMPTY, one launch a call")


def offline_phases(dev, card, standins: dict) -> tuple[dict, list[dict]]:
    """Phase 15: the offline label pipeline. A synthetic DAC LLM_cp.pt
    (ViT-B/32, rank-4 LoRA) converted and run at full width on the card:
    `encode_for_adv` on P15_VIDEOS videos x P15_FRAMES frames and
    P15_GROUPS caption groups a video, tokenised by the port's
    SimpleTokenizer, through the attention kernel (12 resident launches
    an image forward and a text forward, or the run fails) and through
    plain attention (unit embeddings within CLIP_TOL); the towers and one
    attention launch of each timed beside the routes it had before; the
    resident route's edge (`resident_edge_checks`); `validate_ckpt clip` on the
    file (and an orphan adapter refused); the preprocess chain tcs ->
    triplets -> adv -> negatives and img-info with stub LLMs and a frame
    reader; a VinVL .pth -> `convert_vinvl` -> .npz -> `preprocess
    features` equal to `detect_video` bitwise. The checkpoints come from
    the caller: `standins` is `write_standins`' dict (the DAC "dac", the
    VinVL "pth") with the "npz" converted from that .pth and its wall
    "npz_s" and its writer "npz_by" (in the whole script, phase 18's
    convert_vinvl stage; alone, `write_standins(..., npz=True)`). Returns the phase's launch counts by
    `kernels` row name and the two CLIP attention rows."""
    import pickle
    import re
    import shutil
    import tempfile

    import torch

    from nl_vsgg_tpu_torch.data import schema
    from nl_vsgg_tpu_torch.detector.attr_rcnn import AttrRCNNTorch
    from nl_vsgg_tpu_torch.ops import grouped_conv as gc, masked_attention as ma, roi_align as ra
    from nl_vsgg_tpu_torch.pipelines import clip as C
    from nl_vsgg_tpu_torch.pipelines.tokenizer import SimpleTokenizer
    from nl_vsgg_tpu_torch.tools import preprocess, validate_ckpt

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phase15_", dir=os.path.join(HERE, "build"))
    counts = {}
    try:
        # ---- 1. CLIP at full width: the DAC checkpoint, converted, both towers ----
        t0 = time.perf_counter()
        ckpt = standins["dac"]
        raw = torch.load(ckpt, map_location="cpu", weights_only=False)["state_dict"]
        n_weights = sum(v.numel() for k, v in raw.items() if ".lora_" not in k)
        log(f"synthetic DAC LLM_cp.pt (seed 15, `write_standins`): {n_weights} weights + "
            f"{sum(v.numel() for k, v in raw.items() if '.lora_' in k)} LoRA, "
            f"{os.path.getsize(ckpt)} bytes, read in {time.perf_counter() - t0:.3f} s")
        del raw
        t0 = time.perf_counter()
        loaded = torch.load(ckpt, map_location="cpu", weights_only=False)["state_dict"]
        visual_sd, text_sd = C.convert_clip_state_dict(loaded)
        del loaded
        towers = {fused: C.build_towers(visual_sd, text_sd, dev, fused=fused)
                  for fused in (True, False)}
        torch.cuda.synchronize()
        log(f"convert_clip_state_dict (LoRA merged) and both towers on the card, kernel and "
            f"plain attention: {time.perf_counter() - t0:.3f} s")

        tax = schema.load_taxonomy()
        oi_to_ag, ag_to_oi = schema.load_oi_ag_maps()
        names = list(tax.object_classes_pipeline)
        objects = [n for i, n in enumerate(names) if i >= 2 and "/" not in n and ag_to_oi.get(i)
                   and oi_to_ag[ag_to_oi[i][0]][:1] == [i]]
        words = sorted({w for p in P15_PREDICATES for w in p.split()} | set(objects)
                       | {"the", "person", "is", "a"})
        tok = SimpleTokenizer(merges=merge_table(words))
        rng = np.random.default_rng(15)
        videos = [f"p15_{v:03d}.mp4" for v in range(P15_VIDEOS)]
        pairs = [(p, o) for p in P15_PREDICATES for o in objects]
        groups = {}
        for vid in videos:          # distinct sentences within a video, 1-3 a group
            sizes = rng.integers(1, 4, P15_GROUPS)
            picked = iter(rng.choice(len(pairs), int(sizes.sum()), replace=False))
            groups[vid] = [["The person is {} a {}".format(*pairs[next(picked)])
                            for _ in range(n)] for n in sizes]
        tokens = {vid: [tok.tokenize(g) for g in groups[vid]] for vid in videos}
        images = {vid: rng.standard_normal((P15_FRAMES, C.IMAGE_SIZE, C.IMAGE_SIZE, 3),
                                           dtype=np.float32) for vid in videos}
        n_sent = sum(len(g) for vid in videos for g in groups[vid])
        log(f"captions: {n_sent} sentences in {P15_VIDEOS * P15_GROUPS} groups, "
            f"tokenised to {C.CONTEXT} over a {len(tok.bpe_ranks)}-merge table (EOT id "
            f"{tok.eot}); images: {P15_VIDEOS} x {P15_FRAMES} of {C.IMAGE_SIZE}x{C.IMAGE_SIZE}x3")

        emb, walls, routes = {}, {}, {}
        for fused in (True, False):
            image_tower, text_tower = towers[fused]
            out = {}

            def encode():
                for vid in videos:
                    out[vid] = C.encode_for_adv(image_tower, text_tower, images[vid], tokens[vid])

            ma.reset_launches()
            t0 = time.perf_counter()
            routes[fused] = launches_by_route(ma, encode)
            torch.cuda.synchronize()
            walls[fused] = time.perf_counter() - t0
            if sum(routes[fused].values()) != ma.LAUNCHES["fwd"]:
                fail(f"CLIP launches by route {routes[fused]} do not sum to {dict(ma.LAUNCHES)}")
            emb[fused] = out
        want = {("resident", C.VISION_HEADS): 12 * P15_VIDEOS,
                ("resident", C.TEXT_HEADS): 12 * P15_VIDEOS * P15_GROUPS}
        log(f"encode_for_adv (fp32, TF32 off: kernel and plain paths' linears in full float32): "
            f"kernel path {walls[True]:.3f} s wall, attention launches by route {routes[True]}; "
            f"plain path {walls[False]:.3f} s, launches {routes[False]}")
        if routes[True] != want or routes[False]:
            fail(f"CLIP attention launched {routes[True]} (kernel path) and {routes[False]} "
                 f"(plain path); expected {want}: 12 resident an image forward and a text "
                 f"forward, none on the plain path")
        worst = 0.0
        for vid in videos:
            (fk, tk), (fp, tp) = emb[True][vid], emb[False][vid]
            if fk.shape != (P15_FRAMES, C.EMBED_DIM) or [t.shape[0] for t in tk] != \
                    [len(g) for g in groups[vid]]:
                fail(f"encode_for_adv shapes {fk.shape}, {[t.shape for t in tk]}")
            for a, b in zip([fk] + tk, [fp] + tp):
                if not np.isfinite(a).all() or np.abs(np.linalg.norm(a, axis=1) - 1).max() > 1e-5:
                    fail("encode_for_adv gave non-finite or non-unit embeddings")
                worst = max(worst, float(np.abs(a - b).max()))
        log(f"CLIP unit embeddings, kernel vs plain attention: max |d| {worst:.3e} "
            f"(tol {CLIP_TOL})")
        if worst > CLIP_TOL:
            fail(f"CLIP kernel path differs from the plain path by {worst:.3e} > {CLIP_TOL}")
        counts["masked_mha_clip_vision"] = routes[True][("resident", C.VISION_HEADS)]
        counts["masked_mha_clip_text"] = routes[True][("resident", C.TEXT_HEADS)]

        # ---- 2. times: the towers, and one attention launch at each tower's shape ----
        x32 = torch.as_tensor(images[videos[0]], device=dev)
        big = max((t for vid in videos for t in tokens[vid]), key=len)
        t3 = torch.as_tensor(big, device=dev)
        with torch.inference_mode():
            for fused in (True, False):
                image_tower, text_tower = towers[fused]
                ims = cuda_ms(lambda: image_tower(x32), iters=10)
                tms = cuda_ms(lambda: text_tower(t3), iters=10)
                log(f"CLIP {'kernel' if fused else 'plain'} attention: image tower {ims:.3f} ms "
                    f"a {P15_FRAMES}-frame forward = {P15_FRAMES / ims * 1e3:.1f} images/s; "
                    f"text tower {tms:.3f} ms a {len(big)}-sentence forward = "
                    f"{len(big) / tms * 1e3:.1f} sentences/s")
            vis_calls = capture_attention(towers[True][0], lambda: towers[True][0](x32))
            txt_calls = capture_attention(towers[True][1], lambda: towers[True][1](t3))
        if len(vis_calls) != 12 or len(txt_calls) != 12:
            fail(f"captured {len(vis_calls)} / {len(txt_calls)} CLIP attention calls, expected 12")
        rows = {"vision": time_eval_calls(ma, vis_calls[:1], "resident", "CLIP vision attention"),
                "text": time_eval_calls(ma, txt_calls[:1], "resident", "CLIP text attention")}
        clip_rows = [attention_row("masked_mha_clip_vision", 143, counts["masked_mha_clip_vision"],
                                   rows["vision"]),
                     attention_row("masked_mha_clip_text", 143, counts["masked_mha_clip_text"],
                                   rows["text"])]
        for row, r in zip(clip_rows, rows.values()):
            row["parent_route_ms"] = r["parent_ms"]
        for name, r in rows.items():
            log(f"CLIP {name} attention, one launch: resident {r['ms']:.4f} ms, at "
                f"{r['bound_ms'] / r['ms'] * 100:.1f}% of its bound {r['bound_ms']:.4f} ms, "
                f"parent routes {r['parent_ms']} (same inputs, this run), SDPA "
                f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
        del towers
        resident_edge_checks(ma, torch.Generator(device=dev).manual_seed(15), dev)

        # ---- 3. validate_ckpt clip on the card ----
        t0 = time.perf_counter()
        diffs = C.validate_checkpoint(ckpt, device=dev, log=log)
        if diffs.pop("_ok") != 1.0 or validate_ckpt.main(["clip", ckpt]) != 0:
            fail(f"validate_ckpt clip refused the synthetic DAC checkpoint: {diffs}")
        orphan = torch.load(ckpt, map_location="cpu", weights_only=False)
        orphan["state_dict"]["visual.unknown_module.lora_A"] = torch.zeros(4, C.VISION_WIDTH)
        bad = os.path.join(root, "LLM_cp_orphan.pt")
        torch.save(orphan, bad)
        del orphan
        bad_diffs = C.validate_checkpoint(bad, device=dev, log=lambda m: None)
        if bad_diffs["_ok"] != 0.0 or bad_diffs.get("unconsumed_lora_keys") != 1.0:
            fail(f"validate_ckpt clip took an orphan LoRA adapter: {bad_diffs}")
        log(f"validate_ckpt clip on the card: {diffs}, _ok 1; the orphan-adapter file _ok 0 "
            f"({time.perf_counter() - t0:.3f} s)")

        # ---- 4. the CLI chain with stub LLMs ----
        t0 = time.perf_counter()
        frame_names = [f"{i + 1:06d}.png" for i in range(P15_FRAMES)]
        with open(os.path.join(root, "captions.csv"), "w") as f:
            f.write("id,descriptions\n" + "".join(
                f"{vid[:-4]},{';'.join(' then '.join(g) for g in groups[vid])}\n"
                for vid in videos))
        with open(os.path.join(root, "ids.pkl"), "wb") as f:
            pickle.dump({vid: frame_names for vid in videos}, f)
        with open(os.path.join(root, "emb.pkl"), "wb") as f:
            pickle.dump({vid: {"text": emb[True][vid][1], "frames": emb[True][vid][0]}
                         for vid in videos}, f)
        sentence = re.compile(r"Input: The person is (.+?) a (\S+?)\. Output: ")

        def tcs_llm(prompt):
            caption = prompt.rsplit("Input: ", 1)[1].rsplit(". \n", 1)[0]
            return "Output:  " + " >> ".join(s + "." for s in caption.split(" then "))

        def triplet_llm(prompt):
            return "\n".join(
                f"Input: The person is {p} a {o}. Output: Step 1: <person, {p}, {o}>. "
                f"Step 2: <1.person, 1.{p}, 1.{o}>." for p, o in sentence.findall(prompt))

        def out(name):
            return os.path.join(root, name)

        preprocess.main(["tcs", "--captions", out("captions.csv"), "--frame_ids", out("ids.pkl"),
                         "--output", out("split.pkl")], llm=tcs_llm)
        preprocess.main(["triplets", "--split_actions", out("split.pkl"), "--frame_ids",
                         out("ids.pkl"), "--output", out("tri.pkl")], llm=triplet_llm)
        preprocess.main(["adv", "--triplets", out("tri.pkl"), "--embeddings", out("emb.pkl"),
                         "--semi_output", out("semi.pkl"), "--output", out("final.pkl")])
        for vid in videos:                   # a person, each triplet object leaving it
            objs = sorted({o for g in groups[vid] for s in g for o in [s.rsplit(" ", 1)[1]]})
            for i, fr in enumerate(frame_names):
                d = os.path.join(root, "frame_features", vid, fr)
                os.makedirs(d)
                dets = [{"class": ag_to_oi[1][0], "conf": np.float32(0.9),
                         "rect": np.array([10, 10, 100, 200], np.float32)}]
                for j, o in enumerate(objs):
                    x0 = 10 + (20 + 5 * j) * i
                    dets.append({"class": ag_to_oi[names.index(o)][0], "conf": np.float32(0.8),
                                 "rect": np.array([x0, 10, x0 + 90, 200], np.float32)})
                np.save(os.path.join(d, "dets.npy"), np.asarray(dets, object), allow_pickle=True)
        preprocess.main(["negatives", "--final", out("final.pkl"), "--semi", out("semi.pkl"),
                         "--features", out("frame_features"), "--output", out("neg.pkl")])
        for vid in videos:
            os.makedirs(os.path.join(root, "frames", vid))
            open(os.path.join(root, "frames", vid, frame_names[0]), "w").close()
        preprocess.main(["img-info", "--frames", out("frames"), "--output", out("info.pkl")],
                        read_image=lambda p: np.zeros((480, 640, 3), np.uint8))
        got = {n: pickle.load(open(out(n + ".pkl"), "rb"))
               for n in ("split", "tri", "semi", "final", "neg", "info")}
        problems = []
        if got["split"] != {vid: groups[vid] for vid in videos}:
            problems.append("split_action_dict is not the caption groups")
        for vid in videos:
            rec = got["tri"].get(vid, {})
            if rec.get("frame_list") != frame_names or not all(
                    t for g in rec.get("triplets", []) for t in g):
                problems.append(f"{vid}: triplets record {sorted(rec)}")
            semi = got["semi"].get(vid, {})
            if len(semi.get("mapped_frame", [])) != sum(len(g) for g in groups[vid]):
                problems.append(f"{vid}: semi record {sorted(semi)}")
            if len(got["neg"].get(vid, [])) != P15_FRAMES or not any(
                    {"class", "bbox", "attention_relationship", "spatial_relationship",
                     "contacting_relationship"} <= set(d) for fr in got["neg"][vid] for d in fr):
                problems.append(f"{vid}: final_ag_data_w_neg frames")
            info = got["info"].get(vid)
            if info is None or tuple(info.shape) != (1, 3) or info.dtype != torch.float32 or \
                    info.tolist() != [[600.0, 800.0, 1.25]]:
                problems.append(f"{vid}: ag_img_info {info}")
        if problems:
            fail(f"the preprocess chain: {problems[:4]}")
        negs = sum(1 in d["attention_relationship"] for vid in videos for fr in got["neg"][vid]
                   for d in fr if "class" in d)
        log(f"preprocess tcs -> triplets -> adv -> negatives, img-info ({P15_VIDEOS} videos, "
            f"stub LLMs, a frame reader): every pickle in schema, {negs} negative "
            f"'not looking at' labels; {time.perf_counter() - t0:.3f} s")

        # ---- 5. detector checkpoints: .pth -> convert_vinvl -> .npz -> features ----
        sd = detector_weights(5, dev)
        pth, npz = standins["pth"], standins["npz"]
        with np.load(npz) as f:
            n_arrays = len(f.files)
        frames = {vid: [rng.integers(0, 256, (*DET_HW, 3), dtype=np.uint8)
                        for _ in range(P15_DET_FRAMES)]
                  for vid in (f"det_{v}.mp4" for v in range(P15_DET_VIDEOS))}
        for vid, imgs in frames.items():
            os.makedirs(os.path.join(root, "det_frames", vid))
            for i in range(len(imgs)):
                open(os.path.join(root, "det_frames", vid, f"{i:06d}.png"), "w").close()

        def read_image(path):
            return frames[os.path.basename(os.path.dirname(path))][int(path[-10:-4])]

        ra.reset_launches()
        gc.reset_launches()
        t0 = time.perf_counter()
        preprocess.main(["features", "--frames", out("det_frames"), "--output", out("features"),
                         "--checkpoint", npz], read_image=read_image)
        torch.cuda.synchronize()
        t_feat = time.perf_counter() - t0
        launched = {"roi_align": ra.LAUNCHES["roi_align"],
                    "grouped_conv3x3_fp32": gc.ROUTE_LAUNCHES["3xtf32"]}
        want = {"roi_align": P15_DET_VIDEOS,
                "grouped_conv3x3_fp32": P15_DET_VIDEOS * (TRUNK_CONVS + HEAD_CONVS)}
        if launched != want or gc.launches() != launched["grouped_conv3x3_fp32"]:
            fail(f"preprocess features launched {launched} ({dict(gc.ROUTE_LAUNCHES)} by "
                 f"route), expected {want}, every grouped conv on the 3xtf32 route")
        counts.update(launched)
        det = AttrRCNNTorch(sd, device=dev)
        for vid, imgs in frames.items():
            for i, d in enumerate(det.detect_video(imgs)):
                fdir = os.path.join(root, "features", vid, f"{i:06d}.png")
                dets = np.load(os.path.join(fdir, "dets.npy"), allow_pickle=True).tolist()
                v = d["valid"]
                same = (len(dets) == int(v.sum())
                        and [x["class"] for x in dets] == d["labels"][v].tolist()
                        and np.array_equal([x["conf"] for x in dets], d["scores"][v])
                        and np.array_equal(np.stack([x["rect"] for x in dets]), d["boxes"][v])
                        and np.array_equal(np.load(os.path.join(fdir, "feat.npy")),
                                           d["features"][v])
                        and np.array_equal(np.load(os.path.join(fdir, "dets_f32.npy"))[:, 2:],
                                           d["boxes"][v]))
                if not same:
                    fail(f"preprocess features from the .npz differs from detect_video with the "
                         f"state dict at {vid} frame {i}")
        log(f"detector checkpoints: phase 8's weights (seed 5) as a VinVL .pth "
            f"({os.path.getsize(pth)} bytes, `write_standins`, written in "
            f"{standins['pth_s']:.3f} s), convert_vinvl -> {n_arrays} arrays "
            f"({os.path.getsize(npz)} bytes, written in {standins['npz_s']:.3f} s by "
            f"{standins['npz_by']}); "
            f"preprocess features --checkpoint "
            f".npz on {P15_DET_VIDEOS} x {P15_DET_FRAMES} frames of {DET_HW[0]}x{DET_HW[1]} "
            f"in {t_feat:.3f} s (fp32), launches {launched}; dets.npy / dets_f32.npy / "
            f"feat.npy = detect_video with the state dict, bitwise")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 15 launches by kernels row: {counts}")
    log(f"offline phase wall {time.perf_counter() - t_phase:.3f} s; card {card}")
    return counts, clip_rows


# ------------------------------------------------------------- the parallel layer
P16_STEPS = 3                    # DDP train steps in parts (a) and (b)
P16_LR = 1e-5
P16_TIMEOUT_S = 300              # every collective of phase 16, and a rank's join
# Parameters after P16_STEPS AdamW steps of two runs whose gradients differ
# by rounding noise: Adam's update of an element is lr m^/sqrt(v^), at most
# 1.002 lr in each of the first three steps, so an element whose gradient is
# noise may move a full step either way in each run: 2 lr a step apart, and
# 2.5 lr a step leaves room for the float32 arithmetic of the update.
P16_PARAM_ATOL = 2.5 * P16_LR * P16_STEPS
# (a) DDP at world size 1 against the plain step, same weights and batch: a
# one-rank all-reduce copies the gradient and the step divides by 1, so the
# two runs take the same operations in the same order; only a kernel that is
# not deterministic may part them, by rounding noise. Losses within 1e-5
# relative, parameters within P16_PARAM_ATOL, BatchNorm buffers within 1e-5
# of their largest magnitude.
P16_WORLD1_LOSS_RTOL = 1e-5
# (b) 2 ranks x 32 videos against 1 process x 64: the two halves' gradients
# are summed in another order and each half's bf16 GEMMs run at half the
# rows (cuBLAS may tile them otherwise: one bf16 ulp on an activation):
# losses within 1e-2 relative (one-ulp bf16 differences through 4 layers, as
# MODEL_TOL), parameters within P16_PARAM_ATOL, BatchNorm buffers within
# 1e-3 of their largest magnitude (statistics of bf16 activations)
P16_LOSS_RTOL = 1e-2
P16_BUF_REL = 1e-3
# phase 17 (c): merged R@20 of the ranks' epoch eval against one evaluation of
# the saved checkpoint: the same weights, but each rank batches its own shard,
# and a bf16 GEMM's rounding may depend on the batch's rows, which can flip
# a near-tie in the ranking: within 5e-3 (half a point; tools/acceptance.py
# gates at 0.5 points)
P16_R20_ATOL = 5e-3
# (d) sharded against dense forwards, relative to the dense output's largest
# magnitude: the same layers, but the dense first decoder layer projects x
# once and adds the projected slot embedding where the sharded one projects
# x + pos, and the token-sharded attention projects its keys from gathered
# rows: in bf16 one ulp (2^-8) a rounding, carried through 4 layers and
# their residual adds, a few ulps of the largest output (2^-5); in float32
# reduction-order noise (1e-4)
P16_SP_REL = {"bfloat16": 2.0 ** -5, "float32": 1e-4}


def p16_params_apart(a: dict, b: dict, steps: int) -> tuple[float, str, float]:
    """(max |a - b| over the parameters, its tensor, the largest
    difference of the BatchNorm buffers relative to their magnitude)."""
    worst, name, buf = 0.0, "", 0.0
    for k, v in b.items():
        d = float((a[k].float().cpu() - v.float().cpu()).abs().max()) if v.numel() else 0.0
        if "running_" in k:
            buf = max(buf, d / max(float(v.float().abs().max()), 1e-30))
        elif not k.endswith("num_batches_tracked") and not d <= worst:
            worst, name = (d if d == d else float("inf")), k
    return worst, name, buf


def p16_digest(model) -> str:
    import hashlib

    h = hashlib.sha1()
    for k, v in model.state_dict().items():
        h.update(k.encode() + v.detach().contiguous().view(-1).view(__import__("torch").uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def p16_sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def p16_rank(r: int, n: int, url: str, work: str, conf: dict) -> None:
    """Part (b) and (d) on one rank of a gloo group whose ranks share the
    card (spawned by `parallel_phases`): 3 DDP steps on the rank's half of
    phase 5's batch, a NaN in rank 0's block, one DSG-DETR sgdet DDP step
    on set (b), the gloo collectives that take CUDA tensors, then the
    frame- and token-sharded forwards against their dense modules. `conf`
    carries the shapes and constants (a spawned rank imports this file
    anew). Writes <work>/rank<r>.pt."""
    import types

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from nl_vsgg_tpu_torch.data.entry import Entry
    from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR
    from nl_vsgg_tpu_torch.models.sttran import STTran, relation_features
    from nl_vsgg_tpu_torch.ops import masked_attention as ma
    from nl_vsgg_tpu_torch.parallel import comm, distributed as pd
    from nl_vsgg_tpu_torch.parallel.dsg_detr_sp import dsg_detr_transformer_sharded
    from nl_vsgg_tpu_torch.parallel.mesh import ALLREDUCE, data_parallel
    from nl_vsgg_tpu_torch.parallel.sttran_sp import sttran_transformer_sharded
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.train.step import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pd.init_distributed(types.SimpleNamespace(coordinator_address=url, num_processes=n,
                                              process_id=r), device=conf["device"],
                        timeout_s=conf["timeout"])
    dev = pd.rank_device()
    payload = torch.load(os.path.join(work, f"in{r}.pt"), weights_only=False)
    out = {"backend": pd.backend(), "device": str(dev)}
    block = Entry(**{k: v.to(dev) for k, v in payload["block"].items()})
    kw = dict(mode="sgdet", feat_dim=conf["feat"], enc_layer_num=1, dec_layer_num=3,
              dtype=torch.bfloat16, dropout=0.0, device=dev)

    # ---- (b) 3 DDP steps on this rank's 32 videos ----
    model = STTran(generator=torch.Generator().manual_seed(0), **kw)
    st = create_train_state(model, lr=conf["lr"])
    step = make_train_step(data_parallel(model), st.optimizer)
    ma.reset_launches()
    ALLREDUCE["bytes"] = ALLREDUCE["calls"] = 0
    comm.reset_staged()
    losses, ms = [], []
    for i in range(conf["steps"]):
        dist.barrier()
        p16_sync(dev)
        t0 = time.perf_counter()
        st, met = step(st, block, torch.Generator(device=dev).manual_seed(100 + i))
        p16_sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in met.items()})
    out["launches_steps"] = dict(ma.LAUNCHES)
    out["staged_steps"] = comm.STAGED["bytes"] / conf["steps"]
    out["allreduce"] = (ALLREDUCE["bytes"] / conf["steps"], ALLREDUCE["calls"] / conf["steps"])
    out["losses"], out["ms"], out["skipped"] = losses, ms, st.skipped
    out["digest"] = p16_digest(model)
    if r == 0:
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   os.path.join(work, "final0.pt"))
    out["buffers"] = {k: v.cpu() for k, v in model.state_dict().items() if "running_" in k}

    # ---- a NaN in rank 0's block: every rank skips ----
    bad = Entry(**{k: v.clone() if k == "features" else v for k, v in vars(block).items()})
    if r == 0:
        bad.features[0, 0, 0] = float("nan")
    ma.reset_launches()
    st, met = step(st, bad, torch.Generator(device=dev).manual_seed(200))
    out["launches_nan"] = dict(ma.LAUNCHES)
    out["nan"] = (float(met["valid"]), st.skipped, p16_digest(model) == out["digest"])
    del bad, step, st, model

    # ---- one DSG-DETR sgdet DDP step on set (b) ----
    dsg = DSGDETR(mode="sgdet", feat_dim=conf["feat"], enc_layer_num=1, dec_layer_num=3,
                  dtype=torch.bfloat16, dropout=0.0, device=dev,
                  generator=torch.Generator().manual_seed(0))
    blk_b = Entry(**dict(vars(block), labels=payload["labels_b"].to(dev),
                         distribution=payload["dist_b"].to(dev)))
    dst = create_train_state(dsg, lr=conf["lr"])
    ma.reset_launches()
    dst, met = make_train_step(data_parallel(dsg), dst.optimizer)(
        dst, blk_b, torch.Generator(device=dev).manual_seed(300))
    out["launches_dsg"] = dict(ma.LAUNCHES)
    out["dsg"] = ({k: float(v) for k, v in met.items()}, dst.skipped, p16_digest(dsg))

    # ---- (d) the sharded forwards against their dense modules ----
    video = Entry(**{k: v.to(dev)[None] for k, v in payload["video"].items()})
    video_b = Entry(**dict(vars(video), labels=payload["video_labels_b"].to(dev)[None],
                           distribution=payload["video_dist_b"].to(dev)[None]))
    comm.reset_staged()
    sp = {}
    for dname, dt in (("bfloat16", torch.bfloat16), ("float32", None)):
        m = STTran(generator=torch.Generator().manual_seed(0), **dict(kw, dtype=dt))
        with torch.no_grad():
            rel = relation_features(m, video, video.labels, False)
        dist.broadcast(rel, 0)           # one input on both ranks, bit for bit
        im, rm = video.im_idx[0], video.rel_mask[0]
        counts = torch.bincount(im[rm].long(), minlength=conf["frames"])
        ma.reset_launches()
        got = sttran_transformer_sharded(m.glocal_transformer, rel[0], im, rm, conf["frames"],
                                         int(counts.max()))
        launches = dict(ma.LAUNCHES)
        with torch.no_grad():
            dense = m.glocal_transformer(rel, video.im_idx, video.rel_mask)[0]
        sp[f"sttran {dname}"] = (float((got.float() - dense.float()).abs().max()),
                                 float(dense.float().abs().max()), launches,
                                 bool(got.isfinite().all()))
        del m
    dsg.eval()
    with torch.no_grad():
        h, fo, oc, rk = dsg.segment_inputs(video_b)
        dense = dsg(video_b)["global_output"][0]
    ma.reset_launches()
    got = dsg_detr_transformer_sharded(dsg, h[0], fo[0], oc[0], rk[0], video_b.rel_mask[0])
    sp["dsg-detr bfloat16"] = (float((got - dense.float()).abs().max()),
                               float(dense.float().abs().max()), dict(ma.LAUNCHES),
                               bool(got.isfinite().all()))
    out["sp"], out["staged"] = sp, comm.STAGED["bytes"]
    torch.save(out, os.path.join(work, f"rank{r}.pt"))
    pd.shutdown()


P16_GLOO_OPS = ("all_reduce", "all_reduce 104 MB", "all_reduce async", "broadcast",
               "all_gather", "send/recv")
# the ops in pairs of processes: the five that take CUDA tensors share one, in order;
# send/recv, which aborts its processes, has its own
P16_GLOO_PAIRS = (P16_GLOO_OPS[:5], P16_GLOO_OPS[5:])


def p16_gloo_probe(r: int, ops: tuple, url: str, out: str) -> None:
    """One rank of a 2-rank gloo group on the card running each of `ops` on
    CUDA tensors in turn, its result checked; writes <out><op index>_<r>.json
    after each op, so an op that aborts the process leaves the answers
    before it and none after (`p16_gloo_answers`: "not reached")."""
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=url, rank=r, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    for op in ops:
        t = torch.full((26_000_000 if "104 MB" in op else 1024,), float(r + 1), device=dev)
        if op.startswith("all_reduce"):
            if "async" in op:  # as DDP's comm hooks call it
                t = dist.all_reduce(t, async_op=True).get_future().wait()[0]
            else:
                dist.all_reduce(t)
            ok = bool((t == 3).all())
        elif op == "broadcast":
            dist.broadcast(t, 0)
            ok = bool((t == 1).all())
        elif op == "all_gather":
            got = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(got, t)
            ok = bool((got[0] == 1).all() and (got[1] == 2).all())
        else:
            if r == 0:
                dist.send(t, 1)
                ok = True
            else:
                dist.recv(t, 0)
                ok = bool((t == 1).all())
        torch.cuda.synchronize()
        with open(f"{out}{P16_GLOO_OPS.index(op)}_{r}.json", "w") as f:
            json.dump({"ok": ok}, f)
    dist.destroy_process_group()


def p16_gloo_cuda(work: str):
    """Which gloo collectives take CUDA tensors on this card and build:
    each group of `P16_GLOO_PAIRS` in its own pair of spawned processes,
    the pairs at once. Returns a function that waits for them and returns
    the answers."""
    import torch.multiprocessing as mp

    ctxs = {}
    for i, ops in enumerate(P16_GLOO_PAIRS):
        url = f"file://{os.path.join(work, f'gloo_store{i}')}"
        ctxs[ops] = mp.start_processes(p16_gloo_probe, args=(ops, url,
                                                             os.path.join(work, "gloo")),
                                       nprocs=2, join=False, start_method="spawn")
    return lambda: p16_gloo_answers(work, ctxs)


def p16_gloo_answers(work: str, ctxs: dict) -> dict:
    takes = {}
    for ops, ctx in ctxs.items():
        why = ""
        try:
            while not ctx.join(timeout=120):
                pass
        except Exception as e:  # noqa: BLE001 - a rank that died is the probe's answer
            why = f" ({type(e).__name__}: {str(e).splitlines()[0][:100]})"
        reached = True
        for op in ops:
            got = []
            for r in range(2):
                path = os.path.join(work, f"gloo{P16_GLOO_OPS.index(op)}_{r}.json")
                got.append(json.load(open(path))["ok"] if os.path.isfile(path) else None)
            if not reached:
                takes[op] = "not reached: an op before it ended the processes"
                continue
            takes[op] = "yes" if got == [True, True] else f"no: results {got}{why}"
            reached = got == [True, True]
    return takes


def p16_build_model(cfg, tax, device=None):
    """`tools.train_sttran.build_model`, and on a rank of run_training's
    group its `distributed:` line (<save_path>/describe<rank>.txt) and a
    report of the rank's attention launches when the group shuts down
    (<save_path>/launches<rank>.json): `run_training_check`'s counts."""
    from nl_vsgg_tpu_torch.ops import masked_attention as ma
    from nl_vsgg_tpu_torch.parallel import distributed as pd
    from nl_vsgg_tpu_torch.tools import train_sttran as ts

    if pd.initialized() and not getattr(pd.shutdown, "reports", False):
        with open(os.path.join(cfg.save_path, f"describe{pd.rank()}.txt"), "w") as f:
            f.write(pd.describe())
        real, path = pd.shutdown, os.path.join(cfg.save_path, f"launches{pd.rank()}.json")

        def shutdown():
            with open(path, "w") as f:
                json.dump(dict(ma.LAUNCHES), f)
            real()
        shutdown.reports = True
        pd.shutdown = shutdown
        ma.reset_launches()
    return ts.build_model(cfg, tax, device)


def parallel_phases(dev, card, entries, ag: str, root: str) -> dict:
    """Phase 16: the parallel layer at full width (STTran sgdet bf16, 1 + 3
    layers, 8 heads, feat 2048, seeded weights, dropout off; the synthetic
    attention GT is one-hot). (a) NCCL at world size 1 in this process: 3
    DDP train steps on phase 5's batch (64 videos x 32 frames) against the
    plain step on the same weights and batch; (b) 2 gloo ranks sharing the
    card, 32 of those videos each: 3 steps against the one-process steps
    over all 64, BatchNorm buffers equal on both ranks, a NaN in rank 0's
    block skipped on both, one DSG-DETR sgdet DDP step on set (b), the
    gloo collectives that take CUDA tensors; (c), `run_training` with a
    data axis, runs in phase 17 (c) on a mesh of both axes; (d) on the
    ranks of (b), STTran's
    frame-sharded transformer (bf16 and float32) on one 32-frame video and
    DSG-DETR's token-sharded transformer on set (b) against the dense
    modules, the attention kernel on both sides. Returns the phase's
    launch counts by `kernels` row name."""
    import shutil
    import types

    import torch
    import torch.multiprocessing as mp

    from nl_vsgg_tpu_torch.data.entry import stack_entries
    from nl_vsgg_tpu_torch.models.sttran import STTran
    from nl_vsgg_tpu_torch.ops import masked_attention as ma
    from nl_vsgg_tpu_torch.parallel import distributed as pd
    from nl_vsgg_tpu_torch.parallel.mesh import ALLREDUCE, data_parallel
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.train.step import make_train_step, place_entries

    t_phase = time.perf_counter()
    counts: dict = {}

    def add(launches: dict, train: bool, model: str = "") -> None:
        """Count launches under the `kernels` rows: STTran's, or DSG-DETR's
        (`model` "_dsg_detr")."""
        fwd = "masked_mha_fwd_train" if train else "masked_mha"
        for name, n in ((fwd, launches["fwd"]), ("masked_mha_bwd_dq", launches["bwd_dq"]),
                        ("masked_mha_bwd_dkv", launches["bwd_dkv"])):
            counts[name + model] = counts.get(name + model, 0) + n

    # ---- (a) NCCL at world size 1: DDP against the plain step ----
    batch = place_entries(entries, rel_bf16=True, device=dev)   # phase 5's batch
    kw = dict(mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=3,
              dtype=torch.bfloat16, dropout=0.0, device=dev)
    runs = {}
    for kind in ("plain", "ddp"):
        model = STTran(generator=torch.Generator().manual_seed(0), **kw)
        st = create_train_state(model, lr=P16_LR)
        if kind == "ddp":
            pd.init_distributed(types.SimpleNamespace(
                coordinator_address=f"file://{os.path.join(root, 'p16a_store')}",
                num_processes=1, process_id=0), device=dev.type, timeout_s=P16_TIMEOUT_S)
            if pd.backend() != ("nccl" if dev.type == "cuda" else "gloo"):
                fail(f"phase 16 (a): backend {pd.backend()} for one rank on one card")
            step = make_train_step(data_parallel(model), st.optimizer)
            ma.reset_launches()
            ALLREDUCE["bytes"] = ALLREDUCE["calls"] = 0
        else:
            step = make_train_step(model, st.optimizer)
        losses, ms = [], []
        for i in range(P16_STEPS):
            p16_sync(dev)
            t0 = time.perf_counter()
            st, met = step(st, batch, torch.Generator(device=dev).manual_seed(100 + i))
            p16_sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v) for k, v in met.items()})
        if kind == "ddp":
            a_launch, a_bytes = dict(ma.LAUNCHES), ALLREDUCE["bytes"] / P16_STEPS
            add(a_launch, True)
            pd.shutdown()
        runs[kind] = (losses, ms, st.skipped,
                      {k: v.detach().clone() for k, v in model.state_dict().items()})
        del model, st, step
    (pl, pms, psk, psd), (dl, dms, dsk, dsd) = runs["plain"], runs["ddp"]
    worst, name, buf = p16_params_apart(dsd, psd, P16_STEPS)
    loss_rel = max(abs(a["total"] - b["total"]) / abs(b["total"]) for a, b in zip(dl, pl))
    bitwise = all(torch.equal(dsd[k], psd[k]) for k in psd)
    want = {"fwd": 4 * P16_STEPS, "bwd_dq": 4 * P16_STEPS, "bwd_dkv": 4 * P16_STEPS}
    log(f"phase 16 (a) NCCL, world size 1, DDP over a file-store group: {P16_STEPS} bf16 train "
        f"steps at B={B} x {N_FRAMES} frames against the plain step on the same weights: "
        f"losses {[round(x['total'], 5) for x in dl]} (plain {[round(x['total'], 5) for x in pl]}, "
        f"largest relative difference {loss_rel:.2e}, tol {P16_WORLD1_LOSS_RTOL}); parameters "
        f"{'bitwise equal' if bitwise else f'apart by at most {worst:.3e} at {name}'} (tol "
        f"{P16_PARAM_ATOL:.1e}), BatchNorm buffers {buf:.2e} (tol 1e-5); skipped "
        f"{dsk}/{psk}; launches {a_launch}; ms/step DDP {[round(x, 3) for x in dms]}, plain "
        f"{[round(x, 3) for x in pms]}; all-reduced {a_bytes:.0f} bytes a step; card {card}")
    if loss_rel > P16_WORLD1_LOSS_RTOL or worst > P16_PARAM_ATOL or buf > 1e-5 \
            or dsk or psk or a_launch != want:
        fail("phase 16 (a): DDP at world size 1 differs from the plain step")

    # ---- (b) + (d): 2 gloo ranks on the one card ----
    work = os.path.join(root, "p16_ranks")
    os.makedirs(work, exist_ok=True)
    sets_b = tracklet_entries(entries, np.random.default_rng(4000))    # phase 12's set (b)
    host = {k: v.cpu() for k, v in vars(batch).items()}
    half = B // 2
    v0 = stack_entries([entries[0]])
    for r in range(2):
        sl = slice(r * half, (r + 1) * half)
        torch.save({"block": {k: v[sl] for k, v in host.items()},
                    "labels_b": torch.stack([e.labels for e in sets_b[sl]]),
                    "dist_b": torch.stack([e.distribution for e in sets_b[sl]]),
                    "video": {k: v[0] for k, v in vars(v0).items()},
                    "video_labels_b": sets_b[0].labels, "video_dist_b": sets_b[0].distribution},
                   os.path.join(work, f"in{r}.pt"))
    del batch, host
    torch.cuda.empty_cache()
    gloo_answers = p16_gloo_cuda(work) if dev.type == "cuda" else None  # beside (b)
    t0 = time.perf_counter()
    conf = {"device": dev.type, "feat": FEAT, "frames": N_FRAMES, "steps": P16_STEPS,
            "lr": P16_LR, "timeout": P16_TIMEOUT_S}
    pd.join_processes(mp.start_processes(
        p16_rank, args=(2, f"file://{os.path.join(work, 'store')}", work, conf), nprocs=2,
        join=False, start_method="spawn"), timeout_s=P16_TIMEOUT_S * 2)
    ranks_s = time.perf_counter() - t0
    if gloo_answers is not None:
        log(f"phase 16 gloo collectives on CUDA tensors (2 ranks on the card, the ops in "
            f"{len(P16_GLOO_PAIRS)} pairs of processes {P16_GLOO_PAIRS}, beside part (b)): "
            f"{gloo_answers()}; the port's point-to-point "
            f"exchange goes through pinned host memory under gloo (parallel/comm.py)")
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    final0 = torch.load(os.path.join(work, "final0.pt"))
    worst, name, buf = p16_params_apart(final0, psd, P16_STEPS)
    loss_rel = max(abs(a["total"] - b["total"]) / abs(b["total"])
                   for a, b in zip(res[0]["losses"], pl))
    same = (res[0]["digest"] == res[1]["digest"]
            and all(torch.equal(res[0]["buffers"][k], res[1]["buffers"][k])
                    for k in res[0]["buffers"]))
    nan_ok = all(x["nan"] == (0.0, 1, True) for x in res)
    dsg_ok = (res[0]["dsg"][2] == res[1]["dsg"][2] and res[0]["dsg"][1] == 0
              and res[0]["dsg"][0]["valid"] == 1.0 and np.isfinite(res[0]["dsg"][0]["total"]))
    two_ms = [max(a, b) for a, b in zip(res[0]["ms"], res[1]["ms"])]
    log(f"phase 16 (b) 2 gloo ranks sharing the card (backends {[x['backend'] for x in res]}, "
        f"devices {[x['device'] for x in res]}), {half} videos each: {P16_STEPS} DDP steps, "
        f"losses {[round(x['total'], 5) for x in res[0]['losses']]} against the one-process "
        f"steps over all {B} {[round(x['total'], 5) for x in pl]} (largest relative difference "
        f"{loss_rel:.2e}, tol {P16_LOSS_RTOL}); parameters apart by at most {worst:.3e} at "
        f"{name} (tol {P16_PARAM_ATOL:.1e}); BatchNorm buffers "
        f"{'identical on both ranks' if same else 'DIFFER between the ranks'}, {buf:.2e} of "
        f"their magnitude from the one-process run (tol {P16_BUF_REL}); NaN in rank 0's block: "
        f"(valid, skipped, unchanged) {[x['nan'] for x in res]}; DSG-DETR sgdet DDP step on "
        f"set (b): loss {res[0]['dsg'][0]['total']:.5f}, equal parameters on both ranks "
        f"{res[0]['dsg'][2] == res[1]['dsg'][2]}; launches a rank: steps "
        f"{res[0]['launches_steps']}, NaN step {res[0]['launches_nan']}, DSG-DETR step "
        f"{res[0]['launches_dsg']}; {ranks_s:.3f} s for the spawned ranks")
    log(f"phase 16 ms per train step: 2 ranks x {half} videos (one step of the global batch "
        f"of {B}) {[round(x, 3) for x in two_ms]} beside 1 rank x {B} (part (a)) "
        f"{[round(x, 3) for x in dms]}; the 2 ranks share one card, so this is not a scaling "
        f"figure; all-reduced a step: {res[0]['allreduce'][0]:.0f} bytes in "
        f"{res[0]['allreduce'][1]:.0f} DDP buckets (gloo, CUDA tensors; "
        f"{res[0]['staged_steps']:.0f} bytes staged by the port) and {a_bytes:.0f} bytes "
        f"(NCCL, world 1); card {card}")
    if loss_rel > P16_LOSS_RTOL or worst > P16_PARAM_ATOL or not same \
            or buf > P16_BUF_REL or not nan_ok or not dsg_ok \
            or any(x["skipped"] for x in res) \
            or res[0]["launches_steps"] != want \
            or res[0]["launches_nan"] != {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}:
        fail("phase 16 (b): the 2-rank steps differ from the one-process steps, or the "
             "ranks disagree")
    for x in res:
        add(x["launches_steps"], True)
        add(x["launches_nan"], True)
        add(x["launches_dsg"], True, "_dsg_detr")
    for what, (err, mag, launches, finite) in res[0]["sp"].items():
        tol = P16_SP_REL["float32" if "float32" in what else "bfloat16"] * mag
        log(f"phase 16 (d) {what} sharded over 2 ranks against the dense module: max_abs_diff "
            f"{err:.3e} (tol {tol:.3e}: {P16_SP_REL['float32' if 'float32' in what else 'bfloat16']:.2e} "
            f"of the largest output, {mag:.3f}), launches a rank {launches}, finite {finite}; "
            f"rank 1 {res[1]['sp'][what][0]:.3e}")
        if not (err <= tol and res[1]["sp"][what][0] <= tol and finite) or not launches["fwd"]:
            fail(f"phase 16 (d): the sharded {what} forward differs from the dense module")
        for x in res:
            add(x["sp"][what][2], False, "_dsg_detr" if what.startswith("dsg") else "")
    log(f"phase 16 host-staged bytes of the sharded forwards (gloo point-to-point of CUDA "
        f"tensors through pinned host memory, down and up): {[x['staged'] for x in res]} a rank")
    del final0, res, runs, psd, dsd
    shutil.rmtree(work, ignore_errors=True)

    log(f"parallel phase wall {time.perf_counter() - t_phase:.3f} s; card {card}")
    return counts


# ------------------------------------------------------------- the model axis
P17_RANKS = 2                    # the model axis of parts (a) - (c): mesh 1 x 2
# (a) 2 ranks x 64 videos, the model sliced over them, against one process
# over the same 64: the same math, but each rank's bf16 GEMMs run at half the
# output columns (cuBLAS may tile them otherwise: one bf16 ulp on an
# activation) and the input gradients are summed over the ranks in float32:
# phase 16 (b)'s tolerances, P16_LOSS_RTOL, P16_PARAM_ATOL and P16_BUF_REL.
# (b) one DSG-DETR step the same way: parameters within 2.5 lr (one step).
# (c) the checkpoint in a 1x1 model: R@20 within P16_R20_ATOL. The bf16 run
# has a data axis only (phase 16 (c) of earlier slices): each data index
# scores a whole batch of its shard, as the 1x1 evaluation does, with the
# whole model. The model-axis run is float32: the two evaluations batch the
# same videos, and only the sliced GEMMs' rounding parts them; in bf16 that
# rounding ties and unties the random weights' scores and moves R@20 by
# whole triplets. Each run: (mesh, dtype, --max_videos, epochs, batch_videos).
P17_RUNS = (({"data": 2, "model": 1}, "bfloat16", 2 * B, 2, B),     # two steps an epoch
            ({"data": 1, "model": P17_RANKS}, "float32", B // 4, 1, B // 4))   # one step
# (d) remat against the dense step, same weights and generator: the forward
# is the same launches on the same inputs, so the losses are equal; the
# backward recomputes the wrapped layers' activations, equal if the kernels
# and cuBLAS are deterministic, so the parameters within 2.5 lr (Adam's first
# step moves an element whose gradient is rounding noise a full lr).
P17_REMAT_ATOL = 2.5 * P16_LR
# (e) roi_pool on the card against the CPU: a max of the same values, exact.


def p17_digest(sd: dict) -> str:
    import hashlib

    import torch
    h = hashlib.sha1()
    for k, v in sd.items():
        h.update(k.encode() + v.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def p17_rank(r: int, n: int, url: str, work: str, conf: dict) -> None:
    """Parts (a) and (b) on one rank of a 1 x n mesh whose ranks share the
    card (spawned by `model_axis_phases`): STTran sliced over the model
    axis, `conf["steps"]` train steps on all of phase 5's videos, then one
    DSG-DETR step on set (b); each model's gathered one-rank state written
    by rank 0, the rank's resident bytes, its collectives' bytes, its ms a
    step and its launches in <work>/rank<r>.pt."""
    import types

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from nl_vsgg_tpu_torch.data.entry import Entry
    from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR
    from nl_vsgg_tpu_torch.models.sttran import STTran
    from nl_vsgg_tpu_torch.ops import masked_attention as ma
    from nl_vsgg_tpu_torch.parallel import distributed as pd
    from nl_vsgg_tpu_torch.parallel import tensor as tpar
    from nl_vsgg_tpu_torch.parallel.mesh import ALLREDUCE, data_parallel, make_mesh
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.train.step import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pd.init_distributed(types.SimpleNamespace(coordinator_address=url, num_processes=n,
                                              process_id=r), device=conf["device"],
                        timeout_s=conf["timeout"])
    mesh = make_mesh(1, n)
    dev = pd.rank_device()
    cuda = dev.type == "cuda"
    payload = torch.load(os.path.join(work, "in.pt"), weights_only=False)
    batch = Entry(**{k: v.to(dev) for k, v in payload["batch"].items()})
    kw = dict(mode="sgdet", feat_dim=conf["feat"], enc_layer_num=1, dec_layer_num=3,
              dtype=torch.bfloat16, dropout=0.0, device=dev)
    out = {"backend": pd.backend(), "device": str(dev),
           "mesh": (mesh.data_index, mesh.model_index, pd.data_size())}

    # ---- (a) the model axis: 3 steps over all the videos ----
    model = tpar.shard_module(STTran(generator=torch.Generator().manual_seed(0), **kw), mesh)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    st = create_train_state(model, lr=conf["lr"])
    step = make_train_step(data_parallel(model, mesh), st.optimizer)
    ma.reset_launches()
    ALLREDUCE["bytes"] = ALLREDUCE["calls"] = 0
    losses, ms, comm = [], [], []
    for i in range(conf["steps"]):
        dist.barrier()
        p16_sync(dev)
        tpar.reset_comm()
        t0 = time.perf_counter()
        st, met = step(st, batch, torch.Generator(device=dev).manual_seed(100 + i))
        p16_sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        comm.append(dict(tpar.COMM))
        losses.append({k: float(v) for k, v in met.items()})
    out["launches_steps"] = dict(ma.LAUNCHES)
    out["losses"], out["ms"], out["comm"], out["skipped"] = losses, ms, comm, st.skipped
    out["ddp_bytes"] = ALLREDUCE["bytes"] / conf["steps"]
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    out["resident"] = {"params": params, "grads": params, "adamw": sum(
        t.numel() * t.element_size() for s in st.optimizer.adamw.state.values()
        for k, t in s.items() if k != "step")}
    out["peak"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    full = tpar.full_state_dict(model)             # a collective: both ranks
    out["digest"] = p17_digest(full)
    if r == 0:
        torch.save({k: v.cpu() for k, v in full.items()}, os.path.join(work, "final_sttran.pt"))
    del full, step, st, model
    if cuda:
        torch.cuda.empty_cache()

    # ---- (b) one DSG-DETR sgdet step on set (b) ----
    dsg = tpar.shard_module(DSGDETR(mode="sgdet", feat_dim=conf["feat"], enc_layer_num=1,
                                    dec_layer_num=3, dtype=torch.bfloat16, dropout=0.0,
                                    device=dev, generator=torch.Generator().manual_seed(0)),
                            mesh)
    blk_b = Entry(**dict(vars(batch), labels=payload["labels_b"].to(dev),
                         distribution=payload["dist_b"].to(dev)))
    dst = create_train_state(dsg, lr=conf["lr"])
    ma.reset_launches()
    dst, met = make_train_step(data_parallel(dsg, mesh), dst.optimizer)(
        dst, blk_b, torch.Generator(device=dev).manual_seed(300))
    out["launches_dsg"] = dict(ma.LAUNCHES)
    out["dsg"] = ({k: float(v) for k, v in met.items()}, dst.skipped)
    full = tpar.full_state_dict(dsg)
    out["dsg_digest"] = p17_digest(full)
    if r == 0:
        torch.save({k: v.cpu() for k, v in full.items()}, os.path.join(work, "final_dsg.pt"))
    torch.save(out, os.path.join(work, f"rank{r}.pt"))
    pd.shutdown()


def model_axis_phases(dev, card, entries, ag: str, root: str) -> dict:
    """Phase 17: the model axis (tensor parallel over a 1 x 2 mesh, gloo
    ranks sharing the card) and remat, at full width (STTran sgdet bf16,
    1 + 3 layers, 8 heads, feat 2048, seeded weights). (a) 3 train steps,
    dropout off, on phase 5's 64 videos, the model sliced over 2 ranks,
    against the one-process steps over the same videos: each rank's resident
    parameter and AdamW bytes beside one process's, the bytes gathered and
    all-reduced a step, ms a step; (b) one DSG-DETR sgdet step on set (b) the
    same way; (c) `run_training` on each mesh of P17_RUNS (its own ranks),
    the device store on: {data 2, model 1} in bf16 for 2 epochs on 2 B of
    phase 13's videos in batches of B, then {data 1, model 2} in float32
    for 1 epoch on one batch of B / 4:
    only the primary checkpoints and logs, the warm epoch gathers from each
    data index's store, the merged R@20 of the sharded evals against the
    checkpoint restored into a 1 x 1 model; (d) one
    train step with remat on and off, dropout on, from one generator seed:
    the same losses and generator state, the parameters within
    P17_REMAT_ATOL, the step's peak memory each way, and the relation
    transformer's alone over the step's relation features (held after its
    forward, peak through its backward), lower with remat; (e) `roi_pool`
    on the card against the CPU at the detector's C4 shape (one 38 x 64 x
    1024 map, 300 rois), RoIAlign on the same rois beside it. Returns the phase's launch counts by `kernels` row name."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR
    from nl_vsgg_tpu_torch.models.sttran import STTran, relation_features
    from nl_vsgg_tpu_torch.ops import masked_attention as ma
    from nl_vsgg_tpu_torch.ops import roi_align as ra
    from nl_vsgg_tpu_torch.parallel import distributed as pd
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.train.step import make_train_step, place_entries

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    counts: dict = {}

    def add(launches: dict, train: bool, model: str = "") -> None:
        fwd = "masked_mha_fwd_train" if train else "masked_mha"
        for name, n in ((fwd, launches["fwd"]), ("masked_mha_bwd_dq", launches["bwd_dq"]),
                        ("masked_mha_bwd_dkv", launches["bwd_dkv"])):
            counts[name + model] = counts.get(name + model, 0) + n

    def peak_reset():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    # ---- the one-process references of (a) and (b) ----
    batch = place_entries(entries, rel_bf16=True, device=dev)   # phase 5's batch
    sets_b = tracklet_entries(entries, np.random.default_rng(4000))    # phase 12's set (b)
    labels_b = torch.stack([e.labels for e in sets_b])
    dist_b = torch.stack([e.distribution for e in sets_b])
    kw = dict(mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=3,
              dtype=torch.bfloat16, dropout=0.0, device=dev)
    model = STTran(generator=torch.Generator().manual_seed(0), **kw)
    n_params = sum(p.numel() for p in model.parameters())
    peak_reset()
    st = create_train_state(model, lr=P16_LR)
    step = make_train_step(model, st.optimizer)
    one_losses, one_ms = [], []
    for i in range(P16_STEPS):
        p16_sync(dev)
        t0 = time.perf_counter()
        st, met = step(st, batch, torch.Generator(device=dev).manual_seed(100 + i))
        p16_sync(dev)
        one_ms.append((time.perf_counter() - t0) * 1e3)
        one_losses.append({k: float(v) for k, v in met.items()})
    one_adamw = sum(t.numel() * t.element_size() for s in st.optimizer.adamw.state.values()
                    for k, t in s.items() if k != "step")
    one_peak = torch.cuda.max_memory_allocated() if cuda else 0
    one_sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model, st, step
    dsg = DSGDETR(mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=3,
                  dtype=torch.bfloat16, dropout=0.0, device=dev,
                  generator=torch.Generator().manual_seed(0))
    batch_b = type(batch)(**dict(vars(batch), labels=labels_b.to(dev),
                                 distribution=dist_b.to(dev)))
    dst = create_train_state(dsg, lr=P16_LR)
    dst, dmet = make_train_step(dsg, dst.optimizer)(
        dst, batch_b, torch.Generator(device=dev).manual_seed(300))
    one_dsg = ({k: float(v) for k, v in dmet.items()},
               {k: v.detach().cpu().clone() for k, v in dsg.state_dict().items()})
    del dsg, dst, batch_b

    # ---- (a) + (b): 2 gloo ranks on the card, the model sliced over them ----
    work = os.path.join(root, "p17_ranks")
    os.makedirs(work, exist_ok=True)
    torch.save({"batch": {k: v.cpu() for k, v in vars(batch).items()}, "labels_b": labels_b,
                "dist_b": dist_b}, os.path.join(work, "in.pt"))
    peak_reset()
    conf = {"device": dev.type, "feat": FEAT, "steps": P16_STEPS, "lr": P16_LR,
            "timeout": P16_TIMEOUT_S}
    t0 = time.perf_counter()
    pd.join_processes(mp.start_processes(
        p17_rank, args=(P17_RANKS, f"file://{os.path.join(work, 'store')}", work, conf),
        nprocs=P17_RANKS, join=False, start_method="spawn"), timeout_s=P16_TIMEOUT_S * 2)
    ranks_s = time.perf_counter() - t0
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(P17_RANKS)]
    final = torch.load(os.path.join(work, "final_sttran.pt"))
    worst, name, buf = p16_params_apart(final, one_sd, P16_STEPS)
    loss_rel = max(abs(a["total"] - b["total"]) / abs(b["total"])
                   for a, b in zip(res[0]["losses"], one_losses))
    same = len({x["digest"] for x in res}) == 1 and len({x["dsg_digest"] for x in res}) == 1
    full_bytes = {"params": 4 * n_params, "grads": 4 * n_params, "adamw": one_adamw}
    rank_bytes = [x["resident"] for x in res]
    comm = res[0]["comm"][-1]
    two_ms = [max(a, b) for a, b in zip(res[0]["ms"], res[1]["ms"])]
    want = {"fwd": 4 * P16_STEPS, "bwd_dq": 4 * P16_STEPS, "bwd_dkv": 4 * P16_STEPS}
    log(f"phase 17 (a) the model axis, mesh 1 x {P17_RANKS} (gloo ranks sharing the card, "
        f"backends {[x['backend'] for x in res]}, (data index, model index, data size) "
        f"{[x['mesh'] for x in res]}): {P16_STEPS} bf16 train steps on all {B} videos, "
        f"losses {[round(x['total'], 5) for x in res[0]['losses']]} against one process's "
        f"{[round(x['total'], 5) for x in one_losses]} (largest relative difference "
        f"{loss_rel:.2e}, tol {P16_LOSS_RTOL}); the gathered parameters apart by at most "
        f"{worst:.3e} at {name} (tol {P16_PARAM_ATOL:.1e}); BatchNorm buffers {buf:.2e} of "
        f"their magnitude (tol {P16_BUF_REL}); every rank's gathered state equal: {same}; "
        f"launches a rank {res[0]['launches_steps']}; {ranks_s:.3f} s for the spawned ranks")
    log(f"phase 17 (a) resident bytes a rank (parameters, gradients, AdamW moments): "
        f"{rank_bytes} against one process's {full_bytes} ({n_params} parameters); "
        f"{sum(rank_bytes[0].values()) / sum(full_bytes.values()):.4f} of one process's; "
        f"peak device memory a rank {[round(x['peak'] / 2**30, 3) for x in res]} GiB, one "
        f"process {one_peak / 2**30:.3f} GiB")
    log(f"phase 17 (a) collectives a step a rank: gathered {comm['gather_bytes']} bytes in "
        f"{comm['gathers']} all-gathers, all-reduced {comm['allreduce_bytes']} bytes in "
        f"{comm['allreduces']} all-reduces (the model group), DDP all-reduced "
        f"{res[0]['ddp_bytes']:.0f} bytes (a data group of one rank); ms a step "
        f"{[round(x, 3) for x in two_ms]} (both ranks on one card over gloo: not a speed "
        f"figure) beside one process's {[round(x, 3) for x in one_ms]}; card {card}")
    if loss_rel > P16_LOSS_RTOL or worst > P16_PARAM_ATOL or buf > P16_BUF_REL or not same \
            or any(x["skipped"] for x in res) or res[0]["launches_steps"] != want \
            or not sum(rank_bytes[0].values()) < sum(full_bytes.values()):
        fail("phase 17 (a): the 1 x 2 steps differ from the one-process steps, or the ranks "
             "disagree")
    final = torch.load(os.path.join(work, "final_dsg.pt"))
    dworst, dname, dbuf = p16_params_apart(final, one_dsg[1], 1)
    dloss = abs(res[0]["dsg"][0]["total"] - one_dsg[0]["total"]) / abs(one_dsg[0]["total"])
    log(f"phase 17 (b) one DSG-DETR sgdet step on set (b), mesh 1 x {P17_RANKS}: loss "
        f"{res[0]['dsg'][0]['total']:.5f} against one process's {one_dsg[0]['total']:.5f} "
        f"(relative {dloss:.2e}, tol {P16_LOSS_RTOL}); parameters apart by at most "
        f"{dworst:.3e} at {dname} (tol {P16_PARAM_ATOL / P16_STEPS:.1e}), buffers {dbuf:.2e}; "
        f"launches a rank {res[0]['launches_dsg']}")
    if dloss > P16_LOSS_RTOL or dworst > P16_PARAM_ATOL / P16_STEPS or dbuf > P16_BUF_REL \
            or any(x["dsg"][1] for x in res) \
            or res[0]["launches_dsg"] != {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}:
        fail("phase 17 (b): the 1 x 2 DSG-DETR step differs from the one-process step")
    for x in res:
        add(x["launches_steps"], True)
        add(x["launches_dsg"], True, "_dsg_detr")
    del final, one_sd, one_dsg, res
    shutil.rmtree(work, ignore_errors=True)

    # ---- (d) remat on and off, dropout on ----
    runs = {}
    for remat in (False, True):
        m = STTran(generator=torch.Generator().manual_seed(0), remat=remat,
                   **dict(kw, dropout=RATE))
        st = create_train_state(m, lr=P16_LR)
        step = make_train_step(m, st.optimizer)
        g = torch.Generator(device=dev).manual_seed(500)
        peak_reset()
        base = torch.cuda.memory_allocated() if cuda else 0
        ma.reset_launches()
        t0 = time.perf_counter()
        st, met = step(st, batch, g)
        p16_sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3
        step_peak = (torch.cuda.max_memory_allocated() if cuda else 0) - base
        launched = dict(ma.LAUNCHES)
        # the remat region alone: the relation transformer over the step's own
        # relation features, its activations held after the forward and its
        # peak through the backward
        with torch.no_grad():
            rel = relation_features(m, batch, batch.labels, False)
        rel.requires_grad_()
        m.zero_grad(set_to_none=True)
        peak_reset()
        base = torch.cuda.memory_allocated() if cuda else 0
        out = m.glocal_transformer(rel, batch.im_idx, batch.rel_mask,
                                   generator=torch.Generator(device=dev).manual_seed(501))
        held = (torch.cuda.memory_allocated() if cuda else 0) - base
        out.float().square().mean().backward()
        p16_sync(dev)
        region = (torch.cuda.max_memory_allocated() if cuda else 0) - base
        runs[remat] = ({k: float(v) for k, v in met.items()},
                       {k: v.detach().cpu().clone() for k, v in m.state_dict().items()},
                       g.get_state(), step_peak, launched, step_ms, held, region)
        del m, st, step, rel, out
    (dl, dsd, dg, dpeak, dlaunch, dms, dheld, dregion) = runs[False]
    (rl, rsd, rg, rpeak, rlaunch, rms, rheld, rregion) = runs[True]
    rworst, rname, rbuf = p16_params_apart(rsd, dsd, 1)
    same_g = torch.equal(dg, rg)
    gib = 2.0 ** 30
    log(f"phase 17 (d) remat, one bf16 train step at B={B} x {N_FRAMES} frames, dropout "
        f"{RATE}, one generator seed: losses {rl['total']:.6f} (dense {dl['total']:.6f}, equal "
        f"{rl == dl}); parameters apart by at most {rworst:.3e} at {rname} (tol "
        f"{P17_REMAT_ATOL:.1e}), buffers {rbuf:.2e}; generator state equal {same_g}; "
        f"launches {rlaunch} with remat (the 3 wrapped layers' forwards run again in the "
        f"backward), {dlaunch} without; ms a step {rms:.3f} / {dms:.3f} (first steps of fresh "
        f"models)")
    log(f"phase 17 (d) device memory above the resident state (torch.cuda.max_memory_allocated "
        f"after reset_peak_memory_stats), remat / dense: the train step's peak "
        f"{rpeak / gib:.3f} / {dpeak / gib:.3f} GiB (its peak sits outside the wrapped layers); "
        f"the relation transformer over the step's relation features: activations held after "
        f"its forward {rheld / gib:.3f} / {dheld / gib:.3f} GiB, peak through its backward "
        f"{rregion / gib:.3f} / {dregion / gib:.3f} GiB")
    want_d = {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}
    if rl != dl or not same_g or rworst > P17_REMAT_ATOL or rbuf > 1e-5 \
            or not (rheld < dheld and rregion < dregion) or dlaunch != want_d \
            or rlaunch != dict(want_d, fwd=7):
        fail("phase 17 (d): the remat step differs from the dense step, or saves no memory")
    add(dlaunch, True)
    add(rlaunch, True)
    del runs, dsd, rsd

    # ---- (e) roi_pool on the card against the CPU, RoIAlign beside it ----
    g = torch.Generator(device=dev).manual_seed(17)
    fmap = torch.randn(38, 64, 1024, generator=g, device=dev)
    rois, fidx = path_rois(g, 1, 300, 38, 64, dev)
    got = ra.roi_pool(fmap, rois)
    p16_sync(dev)
    want_e = ra.roi_pool(fmap.cpu(), rois.cpu())
    exact = torch.equal(got.cpu(), want_e)
    pms = cuda_ms(lambda: ra.roi_pool(fmap, rois), iters=5) if cuda else 0.0
    ra.reset_launches()
    aligned = ra.roi_align_frames(fmap[None], rois, fidx)
    p16_sync(dev)
    a_launch = ra.LAUNCHES["roi_align"]
    aerr = float((aligned.cpu() - ra.roi_align_reference(fmap[None].cpu(), rois.cpu(),
                                                         fidx.cpu())).abs().max())
    amag = float(aligned.abs().max())
    log(f"phase 17 (e) roi_pool (plain torch, the JAX package's XLA function) on the card, "
        f"map (38, 64, 1024) float32, {rois.shape[0]} rois, 7 x 7: equal to the CPU result "
        f"{exact}, {pms:.3f} ms; roi_align_frames on the same rois (the RoIAlign kernel, "
        f"{a_launch} launch): max_abs_err {aerr:.3e} (tol {DET_KERNEL_REL:.0e} of {amag:.3f})")
    if not exact or a_launch != 1 or aerr > DET_KERNEL_REL * amag \
            or not bool(got.isfinite().all()):
        fail("phase 17 (e): roi_pool on the card differs from the CPU, or RoIAlign from its "
             "plain version")
    counts["roi_align"] = counts.get("roi_align", 0) + a_launch
    del fmap, rois, got, aligned, batch

    # ---- (c) run_training on a data axis (bf16), then on a model axis (float32) ----
    for mesh_c, dtype_c, videos_c, nepoch_c, batch_c in P17_RUNS:
        launches, steps, _ = run_training_check(dev, card, ag, root, os.path.join(root, "p17_run"),
                                                mesh_c, dtype_c, videos_c, nepoch_c, batch_c,
                                                "phase 17 (c)")
        for x in launches:
            add({"fwd": 4 * steps, "bwd_dq": x["bwd_dq"], "bwd_dkv": x["bwd_dkv"]}, True)
            add({"fwd": x["fwd"] - 4 * steps, "bwd_dq": 0, "bwd_dkv": 0}, False)
    log(f"phase 17 launches by kernels row: {counts}")
    log(f"model axis phase wall {time.perf_counter() - t_phase:.3f} s; card {card}")
    return counts


def run_training_cfg(ag: str, root: str, out: str, mesh_c: dict, dtype_c: str, nepoch_c: int,
                     batch_c: int, store: bool = True):
    """The config of `run_training_check` (phase 13's dataset, full width,
    the device store on unless `store` is False, the Entry cache under
    `root`)."""
    from nl_vsgg_tpu_torch.utils.config import load_config

    return load_config(None, {
        "data_path": ag, "frame_features_path": os.path.join(ag, "frame_features"),
        "pseudo_localized_SG_path": os.path.join(ag, "final_ag_data_w_neg.pkl"),
        "feat_dim": FEAT, "enc_layer": 1, "dec_layer": 3, "dtype": dtype_c,
        "batch_videos": batch_c, "num_workers": 4, "remove_one_frame_video": False,
        "union_box_feature": False, "entry_cache": os.path.join(root, "p14_entry_cache"),
        "device_entry_store_gb": STORE_GB if store else 0.0, "nepoch": nepoch_c,
        "save_path": out,
        "mesh": mesh_c,
        "buckets": {"max_frames": [N_FRAMES], "max_boxes": [N_BOXES], "max_rels": [N_RELS]}})


def run_training_check(dev, card, ag: str, root: str, out: str, mesh_c: dict, dtype_c: str,
                       videos_c: int, nepoch_c: int, batch_c: int, what: str,
                       backend: str = "gloo", keep: bool = False,
                       store: bool = True) -> tuple[list, int, str]:
    """`run_training` on phase 13's dataset `ag` into `out` with the mesh
    `mesh_c` (its own ranks; data -1 takes a rank a card), `dtype_c`,
    `videos_c` videos in batches of `batch_c`, `nepoch_c` epochs, the device
    store on unless `store` is False, held to: only the primary checkpoints
    and logs, every rank's `distributed:` line naming `backend` and the
    rank's card (rank r on cuda:(r % cards)), the model axis logged, the
    store sharded over the data axis and the warm epoch gathering from it,
    the merged R@20 of the sharded evals against the checkpoint restored
    into a 1 x 1 model (P16_R20_ATOL), each rank's launches. Returns (each
    rank's launches, the train steps, `out`), `out` removed unless
    `keep`."""
    import shutil
    import types

    import torch

    from nl_vsgg_tpu_torch.data import schema
    from nl_vsgg_tpu_torch.data.action_genome import AGTest
    from nl_vsgg_tpu_torch.eval.epoch import evaluate_epoch, grounded_batches
    from nl_vsgg_tpu_torch.tools import train_sttran as ts
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.utils.checkpoint import restore_checkpoint

    cuda = dev.type == "cuda"
    cfg = run_training_cfg(ag, root, out, mesh_c, dtype_c, nepoch_c, batch_c, store)
    n_ranks = ts.local_ranks(cfg, dev)
    n_data = n_ranks // mesh_c["model"]
    os.environ["NL_VSGG_DIST_TIMEOUT_S"] = str(P16_TIMEOUT_S)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    st = ts.run_training(cfg, types.SimpleNamespace(
        max_videos=videos_c, device=None if cuda else "cpu"), p16_build_model)
    p16_sync(dev)
    run_s = time.perf_counter() - t0
    ckpt = sorted(os.listdir(os.path.join(out, "ckpt")))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "epoch" in r]
    log_txt = open(os.path.join(out, "log.txt")).read()
    gathered = [ln for ln in log_txt.splitlines() if "gathered batches this epoch" in ln]
    launches, lines = [], []
    for r in range(n_ranks):
        with open(os.path.join(out, f"launches{r}.json")) as f:
            launches.append(json.load(f))
        with open(os.path.join(out, f"describe{r}.txt")) as f:
            lines.append(f.read())
    cards = torch.cuda.device_count() if cuda else 0
    own = all(f"process {r}/{n_ranks}, backend {backend}, device "
              f"{f'cuda:{r % cards}' if cuda else 'cpu'}," in ln for r, ln in enumerate(lines))
    one = ts.build_model(cfg, schema.load_taxonomy(), dev)       # never sharded
    st = restore_checkpoint(os.path.join(out, "ckpt"), create_train_state(one))
    ds_test = AGTest(os.path.join(ag, "annotations"))
    n_run, n_test = min(videos_c, AG_VIDEOS), min(videos_c, len(ds_test))
    ev = evaluate_epoch(st.model, grounded_batches(
        lambda i: ts.ground_video(ds_test, i, cfg, False, cfg.buckets),
        ds_test.gt_annotations, range(n_test), batch_c, 4, ordered=True), device=dev,
        zero_union=True)
    diff = abs(ev.mean_score(20) - epochs[-1]["mean_r20"])
    steps = nepoch_c * (n_run // batch_c)
    # each data index scores its shard of the test videos, every rank of its model group
    eval_batches = nepoch_c * -(-(n_test // n_data) // batch_c)
    want_c = {"fwd": 4 * steps + 4 * eval_batches, "bwd_dq": 4 * steps,
              "bwd_dkv": 4 * steps}
    want_ckpt = sorted([str(e) for e in range(nepoch_c)]
                       + [f"{e}.meta.json" for e in range(nepoch_c)] + ["configs.json"])
    log(f"{what} run_training, mesh {mesh_c} (its own {n_ranks} ranks, {backend}), "
        f"{dtype_c}, {n_run} of the {AG_VIDEOS} videos x {N_FRAMES} frames "
        f"in batches of {batch_c} and {n_test} test videos, {nepoch_c} epochs, the device "
        f"store {'on' if store else 'off'}: {run_s:.3f} s "
        f"wall (spawn, datasets, models, {steps} steps, {nepoch_c} sharded evals, "
        f"{nepoch_c} checkpoints gathered by a model group and written by the primary); "
        f"checkpoints {ckpt}; metrics epochs {[r['epoch'] for r in epochs]}; log lines "
        f"from other ranks: {'process 1/' in log_txt}; store: {gathered}; merged mean R@20 "
        f"{epochs[-1]['mean_r20']:.6f} against the checkpoint restored into a 1 x 1 model "
        f"{ev.mean_score(20):.6f} (difference {diff:.2e}, tol {P16_R20_ATOL}); launches a "
        f"rank {launches}; each rank's line {[ln.strip() for ln in lines]}; card {card}")
    if ckpt != want_ckpt or [r["epoch"] for r in epochs] != list(range(nepoch_c)) \
            or "process 1/" in log_txt \
            or f"process 0/{n_ranks}, backend {backend}" not in log_txt or not own \
            or (mesh_c["model"] > 1
                and f"model axis: {mesh_c['model']} ranks a replica" not in log_txt) \
            or (store and n_data > 1 and f"device entry store sharded over "
                f"{n_data} ranks" not in log_txt) \
            or (store and nepoch_c > 1 and (not gathered or " 0 gathered" in gathered[0])) \
            or diff > P16_R20_ATOL or any(x != want_c for x in launches):
        fail(f"{what}: run_training on mesh {mesh_c} ({dtype_c}) did not train, "
             f"gather, evaluate and checkpoint as expected (launches {launches}, expected "
             f"{want_c} a rank)")
    del st, one, ev
    if not keep:
        shutil.rmtree(out, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    return launches, steps, out


# ------------------------------------------------------- the acceptance runbook
P18_EPOCHS = 3                   # --train_e2e: a cold epoch and two warm ones, each over
#                                  the whole train split (--max_videos 0), so that every
#                                  warm epoch (a new permutation of it) is in the store
P18_ORACLE = 50                  # --oracle_videos
P18_TEST_VIDEOS = 16             # the test split's videos (the eval with live union
#                                  features, the oracle: --oracle_videos 50 scores all 16):
#                                  a view of phase 13's dataset with the first 16 annotated
P18_TAR_SEED = 18                # the reference-layout STTran .tar's generator
P18_STAGES = ("validate_vinvl", "convert_vinvl", "validate_clip", "oracle_grounding",
              "train_e2e", "convert_relation", "eval")
P18_ROWS = ("masked_mha", "masked_mha_fwd_train", "masked_mha_bwd_dq", "masked_mha_bwd_dkv",
            "masked_mha_clip_vision", "masked_mha_clip_text", "roi_align", "grouped_conv3x3",
            "grouped_conv3x3_fp32")


def test_split_view(ag: str, dst: str, n: int) -> str:
    """A view of the synthetic Action Genome at `ag` whose test split holds
    its first `n` videos: the train split's files linked, the test
    annotations cut to those videos. Returns its directory."""
    import pickle

    os.makedirs(os.path.join(dst, "annotations"))
    for name in os.listdir(ag):
        if name != "annotations":
            os.symlink(os.path.join(ag, name), os.path.join(dst, name))
    keep = {f"vid{v:03d}.mp4" for v in range(n)}
    for name in os.listdir(os.path.join(ag, "annotations")):
        with open(os.path.join(ag, "annotations", name), "rb") as f:
            table = pickle.load(f)
        with open(os.path.join(dst, "annotations", name), "wb") as f:
            pickle.dump({k: v for k, v in table.items() if k.split("/")[0] in keep}, f)
    return dst


def write_standins(work: str, dev, npz: bool = False) -> dict:
    """The seeded checkpoints phases 18 and 15 share, written to `work`:
    phase 8's detector weights (seed 5) as a VinVL .pth and the synthetic
    DAC LLM_cp.pt (seed 15). With `npz`, also the .pth through
    `tools.convert_vinvl` (phase 18 leaves that to the runbook's
    convert_vinvl stage). Returns {"pth", "dac", "n_dac", "pth_s", and with
    npz "npz", "npz_s", "npz_by"}: paths, the DAC's weights, seconds, the
    writer's name."""
    import torch

    from nl_vsgg_tpu_torch.detector.convert import to_maskrcnn_state_dict
    from nl_vsgg_tpu_torch.tools import convert_vinvl

    os.makedirs(work, exist_ok=True)
    made = {"pth": os.path.join(work, "vinvl.pth"), "dac": os.path.join(work, "LLM_cp.pt")}
    t0 = time.perf_counter()
    torch.save(to_maskrcnn_state_dict(detector_weights(5, dev)), made["pth"])
    made["pth_s"] = time.perf_counter() - t0
    made["n_dac"] = sum(v.numel() for v in dac_checkpoint(made["dac"], seed=15).values())
    if npz:
        made["npz"] = os.path.join(work, "vinvl.npz")
        t0 = time.perf_counter()
        convert_vinvl.main([made["pth"], made["npz"]])
        made["npz_s"] = time.perf_counter() - t0
        made["npz_by"] = "write_standins"
    return made


def acceptance_phases(dev, card, ag: str, work: str, standins: dict) -> tuple[dict, dict]:
    """Phase 18: the acceptance runbook (`tools.acceptance.run`) at full
    width on seeded stand-ins: `write_standins`' VinVL .pth and DAC
    LLM_cp.pt, a reference-layout STTran sgdet .tar (wk, 1 + 3 layers, feat
    2048, embed 1936, saved from the port's module) and phase 13's
    synthetic Action Genome, its test split cut to P18_TEST_VIDEOS videos
    (`test_split_view`), all in `work`. Run 1 (the convert_vinvl stage's
    .npz written without zlib, np.savez): --vinvl --clip
    --relation_ckpt --train_e2e P18_EPOCHS --oracle_videos P18_ORACLE over
    the whole splits, bf16, batches of B, the eval with live union features
    from the converted .npz (bf16 detector, frames from an injected
    reader), its Entries kept in an Entry cache with float32 union
    features; every stage must pass, the kernels' launch counts set to 0
    just before and read just after. Its eval's rows against
    `tools.test_sttran.main` run directly on the converted checkpoint with
    the eval's own config (exact, sorted); each train_e2e epoch's frames
    against the sum of its grounded videos'; the warm epochs wholly from
    the device store. Run 2: an expected.json of run 1's numbers, rc 0; run
    3: each moved 1 point, rc 1 and parity_gate the one failed stage. The
    numbers come from the stages `run` returns. Returns (launch counts by
    `kernels` row name, {"npz": the converted .npz, "npz_s": its stage's
    wall, "npz_by"})."""
    import torch

    from nl_vsgg_tpu_torch.data.action_genome import AGTrain
    from nl_vsgg_tpu_torch.models.sttran import STTran
    from nl_vsgg_tpu_torch.ops import grouped_conv as gc, masked_attention as ma, roi_align as ra
    from nl_vsgg_tpu_torch.tools import acceptance, test_sttran
    from nl_vsgg_tpu_torch.tools import train_sttran as ts
    from nl_vsgg_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    # ---- the stand-ins: the shared checkpoints, the .tar, the test split's view ----
    t0 = time.perf_counter()
    pth, dac, tar = standins["pth"], standins["dac"], os.path.join(work, "sttran.tar")
    model = STTran(mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=3, device=dev,
                   generator=torch.Generator().manual_seed(P18_TAR_SEED))
    torch.save({"state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                "epoch": 1}, tar)
    del model
    ff = os.path.join(ag, "frame_features")
    ag = test_split_view(ag, os.path.join(work, "AG"), P18_TEST_VIDEOS)
    conf = {"mode": "sgdet", "feat_dim": FEAT, "enc_layer": 1, "dec_layer": 3,
            "dtype": "bfloat16", "data_path": ag, "frame_features_path": ff,
            "pseudo_localized_SG_path": os.path.join(ag, "final_ag_data_w_neg.pkl"),
            "save_path": os.path.join(work, "out"), "batch_videos": B, "num_workers": 4,
            "remove_one_frame_video": False, "union_box_feature": True,
            "vinvl_dtype": "bfloat16", "union_feat_cache_dtype": "float32",
            "entry_cache": os.path.join(work, "entries"),
            "buckets": {"max_frames": [N_FRAMES], "max_boxes": [N_BOXES],
                        "max_rels": [N_RELS]}}
    cfg_path = os.path.join(work, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(conf, f)
    log(f"phase 18 stand-ins: VinVL .pth {os.path.getsize(pth)} bytes (written in "
        f"{standins['pth_s']:.3f} s), DAC LLM_cp.pt {standins['n_dac']} weights "
        f"({os.path.getsize(dac)} bytes), STTran .tar {os.path.getsize(tar)} bytes and the "
        f"test split's view written in {time.perf_counter() - t0:.3f} s")

    def read_frames(ds, idx):
        rng = np.random.default_rng(AG_SEED + 200 + idx)
        return [rng.integers(0, 256, (*UNION_HW, 3), dtype=np.uint8) for _ in ds.video_list[idx]]

    def run(argv):
        """acceptance.run on `argv`: (rc, {stage: Stage}, failed stages, wall s)."""
        t0 = time.perf_counter()
        rc, stages = acceptance.run(argv, read_frames=read_frames)
        torch.cuda.synchronize()
        return (rc, {st.name: st for st in stages}, [st.name for st in stages if not st.ok],
                time.perf_counter() - t0)

    def walls(stages) -> dict:
        return {n: round(st.wall_s, 3) for n, st in stages.items()}

    # ---- run 1: every stage ----
    out1 = os.path.join(work, "run1")
    argv1 = ["--cfg", cfg_path, "--vinvl", pth, "--clip", dac, "--relation_ckpt", tar,
             "--out_dir", out1, "--train_e2e", str(P18_EPOCHS), "--oracle_videos",
             str(P18_ORACLE)]
    ma.reset_launches()
    ra.reset_launches()
    gc.reset_launches()
    box = {}
    # the convert_vinvl stage writes its .npz uncompressed, as the CPU tests
    # do: zlib over 146 M random weights took 28.8-39.1 s and is not under test
    savez_compressed, np.savez_compressed = np.savez_compressed, np.savez
    try:
        by_route = launches_by_route(ma, lambda: box.update(zip(("rc", "stages", "failed", "s"),
                                                                run(argv1))))
    finally:
        np.savez_compressed = savez_compressed
    got_ma, got_ra, got_gc = dict(ma.LAUNCHES), ra.LAUNCHES["roi_align"], \
        dict(gc.ROUTE_LAUNCHES)
    rc1, stages1 = box["rc"], box["stages"]
    verdicts = {n: "PASS" if st.ok else "FAIL" for n, st in stages1.items()}
    log(f"phase 18 run 1 ({AG_VIDEOS} train and {P18_TEST_VIDEOS} test videos, "
        f"{P18_EPOCHS} train_e2e epochs, {P18_ORACLE} oracle videos): rc {rc1} in "
        f"{box['s']:.3f} s; stages {verdicts}; stage walls (s) {walls(stages1)}; card {card}")
    if rc1 != 0 or verdicts != dict.fromkeys(P18_STAGES, "PASS"):
        fail(f"phase 18 run 1: rc {rc1}, stages {verdicts}")

    # the train_e2e epochs: each step's 4 training forwards are each followed by
    # one dQ and one dK/dV launch, the warm-up step included
    epochs = stages1["train_e2e"].data["epochs"]
    steps = 1 + sum(e["stored"] + e["streamed"] for e in epochs)
    staged = by_route.get(("staged", H), 0)
    counts = {"masked_mha": staged - 4 * steps, "masked_mha_fwd_train": 4 * steps,
              "masked_mha_bwd_dq": got_ma["bwd_dq"], "masked_mha_bwd_dkv": got_ma["bwd_dkv"],
              "masked_mha_clip_vision": by_route.get(("resident", 12), 0),
              "masked_mha_clip_text": by_route.get(("resident", 8), 0),
              "roi_align": got_ra, "grouped_conv3x3": got_gc["tc"],
              "grouped_conv3x3_fp32": got_gc["3xtf32"]}
    routes = {f"{r} x{h}": n for (r, h), n in by_route.items()}
    log(f"phase 18 run 1 launches by kernels row: {counts}; attention forwards by route and "
        f"heads {routes}; grouped conv by route {got_gc}; {steps} train steps")
    other = sum(by_route.values()) - staged - counts["masked_mha_clip_vision"] \
        - counts["masked_mha_clip_text"]
    if any(counts[n] < 1 for n in P18_ROWS) or other or got_gc["fma"] \
            or got_ma["bwd_dq"] != 4 * steps or got_ma["bwd_dkv"] != 4 * steps:
        fail(f"phase 18: a kernel row of the runbook's path launched no time, or off its "
             f"route: {counts}, forwards by route {routes}, grouped conv {got_gc}")

    # the oracle's ceiling, the train_e2e epochs against the grounded frames
    oracle = stages1["oracle_grounding"].data
    if oracle["r20"] < 0.3:
        fail(f"phase 18: the oracle's ceiling R@20 {oracle['r20']} under --oracle_min 0.3")
    cfg = load_config(cfg_path)
    ds = AGTrain(ag, pseudo_label_path=cfg.pseudo_localized_SG_path,
                 remove_one_frame_video=False)
    n_vid = len(ds) - len(ds) % B
    want = []
    for e in range(P18_EPOCHS):   # each video's own grounded frames (Entry-cache hits)
        order = np.random.default_rng(cfg.seed + e).permutation(len(ds))[:n_vid]
        got = [ts.ground_video(ds, int(i), cfg, True, cfg.buckets) for i in order]
        want.append(sum(int(x.num_frames) for x in got if x is not None))
    log(f"phase 18 train_e2e: {epochs}; grounded frames an epoch {want}; oracle "
        f"{oracle['videos']} videos, ceiling R@20 {oracle['r20']:.4f}")
    if len(epochs) != P18_EPOCHS or [x["frames"] for x in epochs] != want \
            or any(x["stored"] != n_vid // B or x["streamed"] for x in epochs[1:]) \
            or any(x["skipped"] or not x["finite"] for x in epochs):
        fail(f"phase 18 train_e2e: epochs {epochs}, grounded frames {want}, expected "
             f"{n_vid // B} stored batches and none streamed in each warm epoch")
    log(f"phase 18 train_e2e frames/s: cold {epochs[0]['frames_per_s']:.1f}, warm "
        f"{[round(x['frames_per_s'], 1) for x in epochs[1:]]}; card {card}")

    # the eval against test_sttran.main run directly on the same config
    ev1 = stages1["eval"].data["evaluator"]
    conv = os.path.join(out1, "relation_ckpt")
    t0 = time.perf_counter()
    direct = test_sttran.main(["--cfg", os.path.join(out1, "eval_config.json"),
                               "--model_path", conv], read_frames=read_frames)
    direct_s = time.perf_counter() - t0
    a, b = sorted_rows(ev1), sorted_rows(direct)
    if any(not np.array_equal(a[k], b[k]) for k in a) or not len(a["recall", 20]):
        fail("phase 18: the runbook's eval rows differ from test_sttran.main's on the same "
             "checkpoint and config")
    log(f"phase 18 eval: " + recall_line(ev1) + f"; test_sttran.main directly "
        f"({direct_s:.3f} s, its Entries from the cache run 1 filled): every R@K row equal")

    # ---- runs 2 and 3: the parity gate ----
    ks = (10, 20, 50)
    exact = {"recall": {str(k): float(np.mean(ev1.recall[k])) for k in ks},
             "recall_nogc": {str(k): float(np.mean(ev1.recall_nogc[k])) for k in ks},
             "mean_recall": {str(k): float(v) for k, v in ev1.mean_recall.mean_recall.items()}}
    npz = os.path.join(out1, "vinvl_converted.npz")
    cfg2 = os.path.join(work, "cfg2.json")
    with open(cfg2, "w") as f:
        json.dump(dict(conf, vinvl_ckpt=npz, ckpt=npz), f)
    for n, moved, want_rc in ((2, 0.0, 0), (3, 0.01, 1)):
        exp = os.path.join(work, f"expected{n}.json")
        with open(exp, "w") as f:
            json.dump({g: {k: v + moved for k, v in d.items()} for g, d in exact.items()}, f)
        rc, stages, failed, s = run(["--cfg", cfg2, "--relation_ckpt", conv, "--out_dir",
                                     os.path.join(work, f"run{n}"), "--oracle_videos", "0",
                                     "--expected_json", exp])
        log(f"phase 18 run {n} (expected {'moved 1 point' if moved else 'from run 1'}): rc "
            f"{rc}, failed stages {failed} in {s:.3f} s; stage walls (s) {walls(stages)}")
        if rc != want_rc or list(stages) != ["eval", "parity_gate"] \
                or failed != (["parity_gate"] if moved else []):
            fail(f"phase 18 run {n}: rc {rc}, failed stages {failed}, expected rc {want_rc}")
    log(f"phase 18 launches by kernels row: {counts}")
    log(f"acceptance phase wall {time.perf_counter() - t_phase:.3f} s; card {card}")
    return counts, {"npz": npz, "npz_s": stages1["convert_vinvl"].wall_s,
                    "npz_by": "phase 18's convert_vinvl stage"}


# ------------------------------------------------- the parallel layer across cards
# Phase 19 runs with `--cards N`: one rank a card over NCCL. Its tolerances
# are phase 16's and 17's, restated here. N ranks x B / N videos against one
# process x B: each rank's bf16 GEMMs run at a quarter of the rows and NCCL
# sums the ranks' gradients in its own order (ring or tree), where phase 16
# (b)'s gloo summed two halves; rounding noise either way.
P19_LOSS_RTOL = P16_LOSS_RTOL    # (a), (c): losses, relative
# (a), (c): parameters, 2.5 lr for each AdamW step taken (P16_PARAM_ATOL at
# its P16_STEPS steps; DSG-DETR's one step, 2.5 lr)
P19_PARAM_ATOL_STEP = P16_PARAM_ATOL / P16_STEPS
P19_BUF_REL = P16_BUF_REL        # (a), (c): BatchNorm buffers, of their largest magnitude
P19_SP_REL = P16_SP_REL          # (b): sharded against dense forwards, of the largest output
P19_AR_REPS = 5                  # (a): timed all-reduces of the gradient's bytes, after one
#                                  warm-up; the median is reported
# (d), each run (mesh, dtype, --max_videos, epochs, batch_videos, the device
# store), held by `run_training_check` as phase 17 (c) (R@20 to
# P16_R20_ATOL): run_training with mesh.data -1 (a rank a card), bf16, 2 epochs on
# phase 13's 128 videos in batches of B, the store on; the straight run of
# the resume, one batch an epoch, the store off (`p19_resume` says why);
# the model axis {data 2, model 2}, float32, 1 epoch on one batch of B / 4
# (phase 17 (c)'s run)
P19_RUNS = (({"data": -1, "model": 1}, "bfloat16", AG_VIDEOS, 2, B, True),
            ({"data": -1, "model": 1}, "bfloat16", B, 2, B, False),
            ({"data": 2, "model": 2}, "float32", B // 4, 1, B // 4, True))


def p19_conf(device: str) -> dict:
    """Phase 19's widths and constants for its ranks (a spawned rank imports
    this file anew): full width, as phase 16."""
    return {"device": device, "feat": FEAT, "frames": N_FRAMES, "enc": 1, "dec": 3,
            "steps": P16_STEPS, "lr": P16_LR, "timeout": P16_TIMEOUT_S, "ar_reps": P19_AR_REPS}


def p19_model(conf: dict, dev, cls: str = "STTran", float32: bool = False):
    """The seeded model of phase 19 at `conf`'s widths on `dev`: STTran or
    DSG-DETR sgdet, dropout off, computing in bf16 (float32 if asked)."""
    import torch

    from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR
    from nl_vsgg_tpu_torch.models.sttran import STTran
    return {"STTran": STTran, "DSGDETR": DSGDETR}[cls](
        mode="sgdet", feat_dim=conf["feat"], enc_layer_num=conf["enc"],
        dec_layer_num=conf["dec"], dtype=None if float32 else torch.bfloat16, dropout=0.0,
        device=dev, generator=torch.Generator().manual_seed(0))


def p19_payload(entries) -> dict:
    """The ranks' inputs, one file for all: the global batch of `entries`
    on the host (a rank takes its data index's block), set (b)'s labels and
    distributions (`tracklet_entries`), the first video alone for the
    sharded forwards."""
    import torch

    from nl_vsgg_tpu_torch.data.entry import stack_entries
    from nl_vsgg_tpu_torch.train.step import place_entries

    sets_b = tracklet_entries(entries, np.random.default_rng(4000))   # phase 12's set (b)
    batch = place_entries(entries, rel_bf16=True, device="cpu")
    v0 = stack_entries([entries[0]])
    return {"batch": dict(vars(batch)),
            "labels_b": torch.stack([e.labels for e in sets_b]),
            "dist_b": torch.stack([e.distribution for e in sets_b]),
            "video": {k: v[0] for k, v in vars(v0).items()},
            "video_labels_b": sets_b[0].labels, "video_dist_b": sets_b[0].distribution}


def p19_references(dev, conf: dict, payload: dict) -> dict:
    """The one-process references, in this process on `dev` before any rank
    starts: conf["steps"] AdamW steps of STTran over the whole global
    batch (phase 16's seeds) and one DSG-DETR step on set (b) over it; the
    losses, the final states on the host, the layout of the state, the
    resident bytes and ms a step."""
    import torch

    from nl_vsgg_tpu_torch.data.entry import Entry
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.train.step import make_train_step

    batch = Entry(**{k: v.to(dev) for k, v in payload["batch"].items()})
    model = p19_model(conf, dev)
    st = create_train_state(model, lr=conf["lr"])
    step = make_train_step(model, st.optimizer)
    losses, ms = [], []
    for i in range(conf["steps"]):
        p16_sync(dev)
        t0 = time.perf_counter()
        st, met = step(st, batch, torch.Generator(device=dev).manual_seed(100 + i))
        p16_sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in met.items()})
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    sd = model.state_dict()
    out = {"losses": losses, "ms": ms, "skipped": st.skipped,
           "state": {k: v.detach().cpu().clone() for k, v in sd.items()},
           "layout": {k: (tuple(v.shape), str(v.dtype)) for k, v in sd.items()},
           "resident": {"params": params, "grads": params, "adamw": sum(
               t.numel() * t.element_size() for s in st.optimizer.adamw.state.values()
               for k, t in s.items() if k != "step")}}
    del model, st, step, sd
    dsg = p19_model(conf, dev, "DSGDETR")
    batch_b = Entry(**dict(vars(batch), labels=payload["labels_b"].to(dev),
                           distribution=payload["dist_b"].to(dev)))
    dst = create_train_state(dsg, lr=conf["lr"])
    dst, met = make_train_step(dsg, dst.optimizer)(
        dst, batch_b, torch.Generator(device=dev).manual_seed(300))
    out["dsg"] = {k: float(v) for k, v in met.items()}
    out["dsg_state"] = {k: v.detach().cpu().clone() for k, v in dsg.state_dict().items()}
    return out


def p19_meshes(n: int) -> list[tuple[int, int]]:
    """Part (c)'s meshes over n ranks: n / 2 x 2, and 1 x n past 2 ranks."""
    meshes = [(n // 2, 2)] if n >= 2 and n % 2 == 0 else []
    return meshes + ([(1, n)] if n > 2 else [])


def p19_body(payload: dict, conf: dict) -> dict:
    """Phase 19's parts (a)-(c) on one rank of a started process group; the
    device is the rank's (`rank_device`), the widths `conf`'s. (a) mesh n x
    1: conf["steps"] DDP steps on the rank's block of the global batch, a
    NaN in rank 0's block, one DSG-DETR step on set (b), the gradient's
    bytes all-reduced and timed on the group and on the host group; (b) the
    frame- and token-sharded forwards over the n ranks against the dense
    modules; (c) each mesh of `p19_meshes`: conf["steps"] sliced AdamW steps
    on the data index's block, the resident bytes, `full_state_dict`.
    Every rank returns its numbers and digests, rank 0 also the final
    states on the host (`p19_verdicts` holds them against the one-process
    references)."""
    import copy
    import statistics

    import torch
    import torch.distributed as dist

    from nl_vsgg_tpu_torch.data.entry import Entry
    from nl_vsgg_tpu_torch.models.sttran import relation_features
    from nl_vsgg_tpu_torch.ops import masked_attention as ma
    from nl_vsgg_tpu_torch.parallel import comm, distributed as pd
    from nl_vsgg_tpu_torch.parallel import tensor as tpar
    from nl_vsgg_tpu_torch.parallel.dsg_detr_sp import dsg_detr_transformer_sharded
    from nl_vsgg_tpu_torch.parallel.mesh import ALLREDUCE, data_parallel, make_mesh
    from nl_vsgg_tpu_torch.parallel.sttran_sp import sttran_transformer_sharded
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.train.step import make_train_step

    t_mark = time.perf_counter()
    walls: dict = {}

    def part_done(name: str) -> None:
        nonlocal t_mark
        walls[name] = round(time.perf_counter() - t_mark, 3)
        t_mark = time.perf_counter()

    r, n = pd.rank(), pd.world_size()
    dev = pd.rank_device()
    cuda = dev.type == "cuda"
    out = {"rank": r, "backend": pd.backend(), "device": str(dev), "describe": pd.describe(),
           "current": torch.cuda.current_device() if cuda else None}
    glob = payload["batch"]
    n_videos = glob["box_mask"].shape[0]

    def block(d: int, nd: int, **over) -> Entry:
        per = n_videos // nd
        fields = dict(glob, **over)
        return Entry(**{k: v[d * per:(d + 1) * per].to(dev) for k, v in fields.items()})

    def steps(st, step, blk) -> tuple:
        losses, ms, comms = [], [], []
        for i in range(conf["steps"]):
            pd.barrier()
            p16_sync(dev)
            tpar.reset_comm()
            t0 = time.perf_counter()
            st, met = step(st, blk, torch.Generator(device=dev).manual_seed(100 + i))
            p16_sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            comms.append(dict(tpar.COMM))
            losses.append({k: float(v) for k, v in met.items()})
        return st, losses, ms, comms

    def buffers(sd: dict) -> str:
        return p17_digest({k: v for k, v in sd.items() if "running_" in k})

    # the bf16 STTran, built once; each part steps a copy of its seeded weights
    base = p19_model(conf, dev)
    part_done("payload and model")

    # ---- (a) the data axis, mesh n x 1 ----
    mesh = make_mesh(-1, 1)
    blk = block(r, n)
    model = copy.deepcopy(base)
    st = create_train_state(model, lr=conf["lr"])
    step = make_train_step(data_parallel(model, mesh), st.optimizer)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ma.reset_launches()
    ALLREDUCE["bytes"] = ALLREDUCE["calls"] = 0
    comm.reset_staged()
    st, losses, ms, _ = steps(st, step, blk)
    a = {"losses": losses, "ms": ms, "launches": dict(ma.LAUNCHES), "skipped": st.skipped,
         "allreduce": (ALLREDUCE["bytes"] / conf["steps"], ALLREDUCE["calls"] / conf["steps"]),
         "staged": comm.STAGED["bytes"], "digest": p17_digest(model.state_dict()),
         "buffers": buffers(model.state_dict()),
         "peak": torch.cuda.max_memory_allocated(dev) if cuda else 0,
         "grad_bytes": sum(p.numel() * p.element_size() for p in model.parameters()
                           if p.requires_grad)}
    if r == 0:
        a["state"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    # a NaN in rank 0's block: every rank skips
    features = glob["features"].clone()
    if r == 0:
        features[0, 0, 0] = float("nan")
    ma.reset_launches()
    st, met = step(st, block(r, n, features=features), torch.Generator(device=dev).manual_seed(200))
    a["nan_launches"] = dict(ma.LAUNCHES)
    a["nan"] = (float(met["valid"]), st.skipped, p17_digest(model.state_dict()) == a["digest"])
    del step, st, model, features
    part_done("(a) steps")

    # the gradient's bytes all-reduced: on the group (NCCL on the cards),
    # CUDA events; on the host group (gloo), the host clock; median of the
    # timed calls after one warm-up
    buf = torch.empty(a["grad_bytes"] // 4, device=dev)
    host = np.empty(a["grad_bytes"] // 4, np.float32)
    times = {"group": [], "host": []}
    ok = True
    for i in range(conf["ar_reps"] + 1):
        buf.fill_(1.0)
        pd.barrier()
        p16_sync(dev)
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            dist.all_reduce(buf)
            e1.record()
            e1.synchronize()
            times["group"].append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            dist.all_reduce(buf)
            times["group"].append((time.perf_counter() - t0) * 1e3)
        ok = ok and float(buf[0]) == n and float(buf[-1]) == n
        host.fill(1.0)
        pd.barrier()
        t0 = time.perf_counter()
        got = pd.all_reduce_host(host)
        times["host"].append((time.perf_counter() - t0) * 1e3)
        ok = ok and got[0] == n and got[-1] == n
    a["ar"] = {"group_ms": statistics.median(times["group"][1:]),
               "host_ms": statistics.median(times["host"][1:]), "times": times, "ok": ok}
    del buf, host, got
    part_done("(a) all-reduces")

    # one DSG-DETR sgdet DDP step on set (b)
    dsg = p19_model(conf, dev, "DSGDETR")
    dst = create_train_state(dsg, lr=conf["lr"])
    ma.reset_launches()
    dst, met = make_train_step(data_parallel(dsg, mesh), dst.optimizer)(
        dst, block(r, n, labels=payload["labels_b"], distribution=payload["dist_b"]),
        torch.Generator(device=dev).manual_seed(300))
    a["dsg_launches"] = dict(ma.LAUNCHES)
    a["dsg"] = ({k: float(v) for k, v in met.items()}, dst.skipped,
                p17_digest(dsg.state_dict()))
    if r == 0:
        a["dsg_state"] = {k: v.detach().cpu().clone() for k, v in dsg.state_dict().items()}
    del dst
    out["a"] = a
    part_done("(a) DSG-DETR")
    if cuda:
        torch.cuda.empty_cache()

    # ---- (b) the sharded forwards over the n ranks ----
    video = Entry(**{k: v.to(dev)[None] for k, v in payload["video"].items()})
    video_b = Entry(**dict(vars(video), labels=payload["video_labels_b"].to(dev)[None],
                           distribution=payload["video_dist_b"].to(dev)[None]))
    comm.reset_staged()
    sp = {}
    for dname in ("bfloat16", "float32"):
        m = copy.deepcopy(base) if dname == "bfloat16" else p19_model(conf, dev, float32=True)
        with torch.no_grad():
            rel = relation_features(m, video, video.labels, False)
        dist.broadcast(rel, 0)           # one input on every rank, bit for bit
        im, rm = video.im_idx[0], video.rel_mask[0]
        counts = torch.bincount(im[rm].long(), minlength=conf["frames"])
        ma.reset_launches()
        got = sttran_transformer_sharded(m.glocal_transformer, rel[0], im, rm, conf["frames"],
                                         int(counts.max()))
        launches = dict(ma.LAUNCHES)
        with torch.no_grad():
            dense = m.glocal_transformer(rel, video.im_idx, video.rel_mask)[0]
        sp[f"sttran {dname}"] = (float((got.float() - dense.float()).abs().max()),
                                 float(dense.float().abs().max()), launches,
                                 bool(got.isfinite().all()))
        del m
    dsg.eval()
    with torch.no_grad():
        h, fo, oc, rk = dsg.segment_inputs(video_b)
        dense = dsg(video_b)["global_output"][0]
    ma.reset_launches()
    got = dsg_detr_transformer_sharded(dsg, h[0], fo[0], oc[0], rk[0], video_b.rel_mask[0])
    sp["dsg-detr bfloat16"] = (float((got - dense.float()).abs().max()),
                               float(dense.float().abs().max()), dict(ma.LAUNCHES),
                               bool(got.isfinite().all()))
    out["b"] = {"sp": sp, "staged": comm.STAGED["bytes"]}
    del dsg, got, dense, video, video_b
    part_done("(b)")
    if cuda:
        torch.cuda.empty_cache()

    # ---- (c) the model axis over model groups ----
    out["c"] = {}
    for d, m_ in p19_meshes(n):
        name = f"{d}x{m_}"
        model = copy.deepcopy(base)
        try:
            tpar.check_widths(model, m_)
        except ValueError as e:       # the same answer on every rank: no group is made
            out["c"][name] = {"refused": str(e)}
            continue
        mesh = make_mesh(d, m_)
        model = tpar.shard_module(model, mesh)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        st = create_train_state(model, lr=conf["lr"])
        step = make_train_step(data_parallel(model, mesh), st.optimizer)
        ma.reset_launches()
        ALLREDUCE["bytes"] = 0
        st, losses, ms, comms = steps(st, step, block(mesh.data_index, d))
        params = sum(p.numel() * p.element_size() for p in model.parameters())
        c = {"mesh": (mesh.data_index, mesh.model_index, pd.data_size(), pd.model_size()),
             "losses": losses, "ms": ms, "comm": comms[-1], "skipped": st.skipped,
             "launches": dict(ma.LAUNCHES), "ddp_bytes": ALLREDUCE["bytes"] / conf["steps"],
             "resident": {"params": params, "grads": params, "adamw": sum(
                 t.numel() * t.element_size() for s in st.optimizer.adamw.state.values()
                 for k, t in s.items() if k != "step")},
             "peak": torch.cuda.max_memory_allocated(dev) if cuda else 0}
        full = tpar.full_state_dict(model)           # a collective over each model group
        c["digest"] = p17_digest(full)
        if r == 0:
            c["state"] = {k: v.detach().cpu().clone() for k, v in full.items()}
        out["c"][name] = c
        del full, step, st, model
        if cuda:
            torch.cuda.empty_cache()
        part_done(f"(c) {name}")
    out["walls"] = walls
    return out


def p19_rank(r: int, n: int, url: str, work: str, conf: dict) -> None:
    """One rank of phase 19 (spawned by `multicard_phases`): the process
    group over the rank's card (NCCL when each rank has its own), then
    `p19_body` on <work>/in.pt; writes <work>/rank<r>.pt."""
    import types

    import torch

    sys.path.insert(0, HERE)
    from nl_vsgg_tpu_torch.parallel import distributed as pd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    payload = torch.load(os.path.join(work, "in.pt"), weights_only=False)
    pd.init_distributed(types.SimpleNamespace(coordinator_address=url, num_processes=n,
                                              process_id=r), device=conf["device"],
                        timeout_s=conf["timeout"])
    out = p19_body(payload, conf)
    torch.save(out, os.path.join(work, f"rank{r}.pt"))
    pd.shutdown()


def p19_verdicts(res: list, refs: dict, conf: dict) -> list[str]:
    """Phase 19 (a)-(c) from every rank's `p19_body` result against the
    one-process references: each part logged, and the failures returned
    (empty when all passed). On the cards each rank must run NCCL on its own
    card and launch 4 + 4 + 4 attention kernels a train step; on the CPU
    gloo and none."""
    n = len(res)
    cuda = conf["device"] == "cuda"
    bad: list[str] = []
    k = 4 if cuda else 0
    per_step = {"fwd": k, "bwd_dq": k, "bwd_dkv": k}
    want = {key: v * conf["steps"] for key, v in per_step.items()}
    patol = P19_PARAM_ATOL_STEP * conf["steps"]
    ref_losses = refs["losses"]

    def failing(checks: dict) -> str:
        """The names of the checks that failed, comma-separated."""
        return ", ".join(k for k, failed in checks.items() if failed)

    def loss_rel(losses) -> float:
        return max(abs(a["total"] - b["total"]) / abs(b["total"])
                   for a, b in zip(losses, ref_losses))

    # ---- the ranks: backend and card ----
    where = [(x["backend"], x["device"], x["current"]) for x in res]
    own = [("nccl", f"cuda:{r}", r) if cuda else ("gloo", "cpu", None) for r in range(n)]
    log(f"phase 19 ranks (backend, device, current device): {where}; lines "
        f"{[x['describe'] for x in res]}; walls (s) of rank 0's parts {res[0]['walls']}")
    if where != own:
        bad.append(f"(ranks): on {where}, expected {own}")

    # ---- (a) ----
    a = [x["a"] for x in res]
    worst, name, buf = p16_params_apart(a[0]["state"], refs["state"], conf["steps"])
    rel = loss_rel(a[0]["losses"])
    same = len({x["digest"] for x in a}) == 1 and len({x["buffers"] for x in a}) == 1
    nan_ok = all(x["nan"] == (0.0, 1, True) for x in a)
    dsg_loss = abs(a[0]["dsg"][0]["total"] - refs["dsg"]["total"]) / abs(refs["dsg"]["total"])
    dworst, dname, dbuf = p16_params_apart(a[0]["dsg_state"], refs["dsg_state"], 1)
    step_ms = [max(x["ms"][i] for x in a) for i in range(conf["steps"])]
    log(f"phase 19 (a) mesh {n} x 1, {conf['steps']} DDP steps, "
        f"{res[0]['a']['grad_bytes']} gradient bytes: losses "
        f"{[round(x['total'], 5) for x in a[0]['losses']]} against one process's "
        f"{[round(x['total'], 5) for x in ref_losses]} (largest relative difference {rel:.2e}, "
        f"tol {P19_LOSS_RTOL}); parameters apart by at most {worst:.3e} at {name} (tol "
        f"{patol:.1e}); BatchNorm buffers {buf:.2e} of their magnitude (tol "
        f"{P19_BUF_REL}), parameters and buffers equal on all {n} ranks: {same}; NaN in rank "
        f"0's block (valid, skipped, unchanged) {[x['nan'] for x in a]}; launches a rank "
        f"{a[0]['launches']}, NaN step {a[0]['nan_launches']}")
    log(f"phase 19 (a) ms a step of the global batch (slowest rank) "
        f"{[round(x, 3) for x in step_ms]} beside one process's "
        f"{[round(x, 3) for x in refs['ms']]}; all-reduced a step a rank "
        f"{a[0]['allreduce'][0]:.0f} bytes in {a[0]['allreduce'][1]:.0f} DDP buckets; "
        f"host-staged {[x['staged'] for x in a]}; peak device memory a rank "
        f"{[round(x['peak'] / 2 ** 30, 3) for x in a]} GiB")
    log(f"phase 19 (a) DSG-DETR sgdet DDP step on set (b): loss {a[0]['dsg'][0]['total']:.5f} "
        f"against one process's {refs['dsg']['total']:.5f} (relative {dsg_loss:.2e}, tol "
        f"{P19_LOSS_RTOL}); parameters apart by at most {dworst:.3e} at {dname} (tol "
        f"{P19_PARAM_ATOL_STEP:.1e}), buffers {dbuf:.2e}; equal on all ranks "
        f"{len({x['dsg'][2] for x in a}) == 1}; launches a rank {a[0]['dsg_launches']}")
    gb = a[0]["grad_bytes"]
    g_ms, h_ms = (max(x["ar"]["group_ms"] for x in a), max(x["ar"]["host_ms"] for x in a))
    busbw = 2 * (n - 1) / n
    log(f"phase 19 (a) all-reduce of the gradient's {gb} bytes (float32) over {n} ranks, "
        f"median of {conf['ar_reps']} after a warm-up, slowest rank: "
        f"{res[0]['backend']} {g_ms:.3f} ms ({'CUDA events' if cuda else 'host clock'}; "
        f"algorithm bandwidth {gb / g_ms / 1e6:.2f} GB/s, bus bandwidth "
        f"{gb / g_ms / 1e6 * busbw:.2f} GB/s as nccl-tests count it, x 2(n-1)/n), gloo on the "
        f"host group {h_ms:.3f} ms ({gb / h_ms / 1e6:.2f} GB/s algorithm, "
        f"{gb / h_ms / 1e6 * busbw:.2f} GB/s bus; host memory, ring); sums right "
        f"{all(x['ar']['ok'] for x in a)}; every call (ms) "
        f"{[{k2: [round(t, 3) for t in v] for k2, v in x['ar']['times'].items()} for x in a]}")
    failed = failing({"losses": rel > P19_LOSS_RTOL, "parameters": worst > patol,
                      "buffers": buf > P19_BUF_REL, "ranks equal": not same,
                      "NaN skip": not nan_ok, "skips": any(x["skipped"] for x in a),
                      "launches": any(x["launches"] != want or x["nan_launches"] != per_step
                                      for x in a)})
    if failed:
        bad.append(f"(a): the DDP steps differ from the one-process steps, or the ranks "
                   f"disagree ({failed})")
    if dsg_loss > P19_LOSS_RTOL or dworst > P19_PARAM_ATOL_STEP \
            or dbuf > P19_BUF_REL or len({x["dsg"][2] for x in a}) != 1 \
            or any(x["dsg"][1] for x in a) or any(x["dsg_launches"] != per_step for x in a):
        bad.append("(a): the DSG-DETR DDP step differs from the one-process step")
    if not all(x["ar"]["ok"] for x in a) or not all(x["allreduce"][0] > 0 for x in a) \
            or any(x["staged"] for x in a):
        bad.append("(a): an all-reduce summed wrong, DDP all-reduced nothing, or bytes went "
                   "through the host")

    # ---- (b) ----
    for what in res[0]["b"]["sp"]:
        tol = P19_SP_REL["float32" if "float32" in what else "bfloat16"]
        errs = [x["b"]["sp"][what] for x in res]
        log(f"phase 19 (b) {what} sharded over {n} ranks against the dense module: "
            f"max_abs_diff by rank {[f'{e[0]:.3e}' for e in errs]} (tol {tol:.2e} of the "
            f"largest output, {errs[0][1]:.3f}); launches a rank {errs[0][2]}; finite "
            f"{all(e[3] for e in errs)}")
        if not all(e[0] <= tol * e[1] and e[3] and (e[2]["fwd"] > 0) == cuda for e in errs):
            bad.append(f"(b): the sharded {what} forward differs from the dense module")
    staged = [x["b"]["staged"] for x in res]
    log(f"phase 19 (b) bytes staged through host memory a rank: {staged}")
    if any(staged):
        bad.append(f"(b): {staged} bytes went through host memory")

    # ---- (c) ----
    for name in [f"{d}x{m}" for d, m in p19_meshes(n)]:
        cs = [x["c"][name] for x in res]
        if "refused" in cs[0]:
            log(f"phase 19 (c) mesh {name}: tensor.check_widths refuses it: {cs[0]['refused']}")
            if not name.startswith("1x"):
                bad.append(f"(c): mesh {name} refused")
            continue
        worst, wname, buf = p16_params_apart(cs[0]["state"], refs["state"], conf["steps"])
        layout = {k: (tuple(v.shape), str(v.dtype)) for k, v in cs[0]["state"].items()} \
            == refs["layout"]
        rel = loss_rel(cs[0]["losses"])
        same = len({x["digest"] for x in cs}) == 1
        total = sum(cs[0]["resident"].values())
        one = sum(refs["resident"].values())
        log(f"phase 19 (c) mesh {name} ((data index, model index, data size, model size) "
            f"{[x['mesh'] for x in cs]}): {conf['steps']} sliced AdamW steps, losses "
            f"{[round(x['total'], 5) for x in cs[0]['losses']]} (largest relative difference "
            f"{rel:.2e}, tol {P19_LOSS_RTOL}); gathered parameters apart by at most "
            f"{worst:.3e} at {wname} (tol {patol:.1e}), buffers {buf:.2e} (tol "
            f"{P19_BUF_REL}); every rank's gathered state equal {same}; its layout the one "
            f"process's {layout}; resident bytes a rank {cs[0]['resident']} = "
            f"{total / one:.4f} of one process's {refs['resident']}; collectives a step a "
            f"rank {cs[0]['comm']}, DDP {cs[0]['ddp_bytes']:.0f} bytes; ms a step "
            f"{[round(max(x['ms'][i] for x in cs), 3) for i in range(conf['steps'])]}; peak "
            f"device memory a rank {[round(x['peak'] / 2 ** 30, 3) for x in cs]} GiB; "
            f"launches a rank {cs[0]['launches']}")
        failed = failing({"losses": rel > P19_LOSS_RTOL, "parameters": worst > patol,
                          "buffers": buf > P19_BUF_REL, "ranks equal": not same,
                          "layout": not layout, "skips": any(x["skipped"] for x in cs),
                          "launches": any(x["launches"] != want for x in cs),
                          "resident bytes": not total < one})
        if failed:
            bad.append(f"(c): the {name} steps differ from the one-process steps, or the ranks "
                       f"disagree ({failed})")
    return bad


def card_kernel_checks(n: int) -> dict:
    """Phase 19 (e): every kernel of the path on each card cuda:0 .. n-1, in
    this process, the current device left at cuda:0 (each wrapper's device
    guard and its per-device shared-memory attribute must reach the card):
    the attention forward, dQ and dK/dV at phase 2's shapes, RoIAlign at
    phase 9's pass shape (DET_FRAMES frames x 300 rois), the grouped conv at
    its four classes, bf16 ("tc") and float32 ("3xtf32"), each against its
    plain version with phase 2's and phase 7's tolerances, the routes
    printed. Returns each `kernels` row's largest error by card."""
    import torch

    from nl_vsgg_tpu_torch.ops import grouped_conv as gc, masked_attention as ma, roi_align as ra

    errs: dict = {}
    for r in range(n):
        dev = torch.device("cuda", r)
        label = f"card {r}: "
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(0)
        rows = {"masked_mha": eval_kernel_checks(ma, g, dev, timed=False, label=label)}
        rows.update(train_kernel_checks(ma, g, dev, label))
        g = torch.Generator(device=dev).manual_seed(3)
        rows["roi_align"] = roi_align_checks(ra, g, dev, DET_FRAMES, label)
        rows.update(grouped_conv_checks(gc, g, dev, CONV_CLASSES, label)[2])
        for name, err in rows.items():
            errs.setdefault(name, []).append(err)
        with torch.cuda.device(dev):
            torch.cuda.empty_cache()
        log(f"phase 19 (e) card {r} ({torch.cuda.get_device_name(dev)}): every kernel held "
            f"against its plain version in {time.perf_counter() - t0:.3f} s; current device "
            f"{torch.cuda.current_device()}")
    return errs


def nccl_log_lines(work: str, limit: int = 40) -> list[str]:
    """The lines of NCCL's own log (NCCL_DEBUG_FILE, one file a rank) that
    name its version, its transports, rings and trees and its tuning, without
    the host:pid prefixes, each once."""
    keys = ("NCCL version", " via ", "Channel 00", "Connected all", "NVLS", "CollNet",
            "Algorithm", "Max NThreads", "Trees", "Rings", "Pattern", "comm 0x")
    seen: list[str] = []
    for fn in sorted(os.listdir(work)):
        if not fn.startswith("nccl."):
            continue
        with open(os.path.join(work, fn), errors="replace") as f:
            for ln in f:
                body = ln.split("NCCL INFO", 1)[-1].strip()[:200]
                if any(k in body for k in keys) and body not in seen:
                    seen.append(body)
        break                         # one rank's file: the others say the same
    return seen[:limit]


def p19_resume(dev, card, ag: str, root: str, straight: str, mesh_c: dict, dtype_c: str,
               videos_c: int, nepoch_c: int, batch_c: int) -> list:
    """Part (d)'s resume: a copy of the straight run's epoch-0 checkpoint in
    a new directory, then `run_training` to `nepoch_c` epochs there (its own
    ranks), held as phase 14 holds its resume: it logs the resume, runs the
    later epochs only, its scheduler and its final parameters and AdamW
    moments equal the straight run's (RESUME_REL). Both runs keep the
    device store off: a sharded store gathers each rank's own rows, so a
    straight run's warm epoch batches its videos otherwise than the cold
    epoch of a run resumed with an empty store. Returns each rank's
    launches."""
    import shutil
    import types

    from nl_vsgg_tpu_torch.tools import train_sttran as ts
    from nl_vsgg_tpu_torch.utils.checkpoint import load_meta, load_state

    out = os.path.join(root, "p19_resumed")
    os.makedirs(os.path.join(out, "ckpt"))
    for fn in ("0", "0.meta.json", "configs.json"):
        src = os.path.join(straight, "ckpt", fn)
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, os.path.join(out, "ckpt",
                                                                                   fn))
    cfg = run_training_cfg(ag, root, out, mesh_c, dtype_c, nepoch_c, batch_c, store=False)
    n_ranks = ts.local_ranks(cfg, dev)
    t0 = time.perf_counter()
    st = ts.run_training(cfg, types.SimpleNamespace(
        max_videos=videos_c, device=None if dev.type == "cuda" else "cpu"), p16_build_model)
    p16_sync(dev)
    wall = time.perf_counter() - t0
    log_txt = open(os.path.join(out, "log.txt")).read()
    epoch_steps = min(videos_c, AG_VIDEOS) // batch_c
    resumed = [ln for ln in log_txt.splitlines() if "resumed from checkpoint" in ln]
    ckpt = sorted(os.listdir(os.path.join(out, "ckpt")))
    sched_a = load_meta(os.path.join(out, "ckpt"))["scheduler"]
    sched_b = load_meta(os.path.join(straight, "ckpt"))["scheduler"]
    a, b = load_state(os.path.join(out, "ckpt")), load_state(os.path.join(straight, "ckpt"))
    params = tensors_apart(a["model"], b["model"], "phase 19 (d) resume: parameters")
    moments = tensors_apart(
        {f"{i}.{k}": s[k] for i, s in a["optimizer"]["state"].items()
         for k in ("exp_avg", "exp_avg_sq")},
        {f"{i}.{k}": s[k] for i, s in b["optimizer"]["state"].items()
         for k in ("exp_avg", "exp_avg_sq")}, "phase 19 (d) resume: AdamW moments")
    launches = []
    for r in range(n_ranks):
        with open(os.path.join(out, f"launches{r}.json")) as f:
            launches.append(json.load(f))
    log(f"phase 19 (d) resume ({n_ranks} ranks): from a copy of the straight run's epoch-0 "
        f"checkpoint, {wall:.3f} s; logged {[ln.split('INFO', 1)[-1].strip() for ln in resumed]}"
        f"; checkpoints {ckpt}; step {st.step}; scheduler {sched_a} against the straight "
        f"run's {sched_b}; final parameters {params}, AdamW moments {moments} (tol "
        f"{RESUME_REL} of each tensor's largest magnitude); launches a rank {launches}; "
        f"card {card}")
    if not any(f"resumed from checkpoint epoch 0 (step {epoch_steps})" in ln for ln in resumed) \
            or "Inference in Epoch (0)" in log_txt \
            or ckpt != sorted(["0", "0.meta.json", "configs.json"]
                              + [x for e in range(1, nepoch_c) for x in (str(e),
                                                                          f"{e}.meta.json")]) \
            or st.step != nepoch_c * epoch_steps \
            or (sched_a["lr"], sched_a["num_bad"]) != (sched_b["lr"], sched_b["num_bad"]) \
            or abs(sched_a["best"] - sched_b["best"]) > ROWS_ATOL \
            or any(x["bwd_dq"] != 4 * (nepoch_c - 1) * epoch_steps for x in launches):
        fail("phase 19 (d): the resumed run differs from the straight run")
    del a, b, st
    shutil.rmtree(out, ignore_errors=True)
    return launches


def p19_runs(n: int, card: str, work: str, walls: dict, dev) -> dict:
    """Phase 19 (d): each run of P19_RUNS that n cards hold, a rank a card,
    on phase 13's synthetic Action Genome written under `work`
    (`run_training_check`: backend NCCL on the cards, each rank on its own,
    the merged R@20 against one evaluation of the checkpoint on `dev`), the
    store-off run followed by its resume (`p19_resume`). Adds each part's
    wall to `walls`; returns the ranks' launches by `kernels` row."""
    import shutil

    counts: dict = {}

    def add(launches: list, steps: int) -> None:
        """Each rank's launches: 4 train forwards a step, the rest the evals'."""
        for x in launches:
            for name, k in (("masked_mha_fwd_train", 4 * steps),
                            ("masked_mha", x["fwd"] - 4 * steps),
                            ("masked_mha_bwd_dq", x["bwd_dq"]),
                            ("masked_mha_bwd_dkv", x["bwd_dkv"])):
                counts[name] = counts.get(name, 0) + k

    def ranks(mesh_c: dict) -> int:
        return n if mesh_c["data"] == -1 else mesh_c["data"] * mesh_c["model"]

    runs = [run for run in P19_RUNS if 1 < ranks(run[0]) <= n]
    if not runs:
        log(f"phase 19 (d): every run needs 2 or more cards, {n} asked for")
        return counts
    t0 = time.perf_counter()
    ag = write_synthetic_ag(work, AG_VIDEOS, N_FRAMES, FEAT, AG_OBJS, AG_DETS, AG_SEED)
    walls["19 (d) dataset"] = round(time.perf_counter() - t0, 1)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    for mesh_c, dtype_c, videos_c, nepoch_c, batch_c, store in runs:
        what = f"{mesh_c} {dtype_c} store {'on' if store else 'off'}"
        t0 = time.perf_counter()
        launches, steps, out = run_training_check(
            dev, card, ag, work, os.path.join(work, "p19_run"), mesh_c, dtype_c, videos_c,
            nepoch_c, batch_c, "phase 19 (d)", backend=backend, keep=not store, store=store)
        add(launches, steps)
        walls[f"19 (d) run {what}"] = round(time.perf_counter() - t0, 1)
        if not store:        # the straight run of the resume
            t0 = time.perf_counter()
            add(p19_resume(dev, card, ag, work, out, mesh_c, dtype_c, videos_c, nepoch_c,
                           batch_c), (nepoch_c - 1) * (min(videos_c, AG_VIDEOS) // batch_c))
            shutil.rmtree(out, ignore_errors=True)
            walls["19 (d) resume"] = round(time.perf_counter() - t0, 1)
    return counts


def multicard_phases(n: int, card: str) -> tuple[dict, dict, dict]:
    """Phase 19, the parallel layer with one rank a card over NCCL
    (`--cards n`): (e) every kernel on every card; the one-process
    references on cuda:0; (a)-(c) in n spawned ranks (`p19_rank`); (d)
    `run_training` on phase 13's synthetic Action Genome with mesh.data -1
    (it spawns a rank a card), its merged R@20 against one evaluation of its
    checkpoint, a resume from its epoch-0 checkpoint, then the float32 {data
    2, model 2} run. Returns the launches by `kernels` row, (e)'s errors by
    row and card, and the parts' walls."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
    from nl_vsgg_tpu_torch.parallel import distributed as pd

    counts: dict = {}
    walls: dict = {}

    def add(launches: dict, train: bool, model: str = "") -> None:
        fwd = "masked_mha_fwd_train" if train else "masked_mha"
        for name, k in ((fwd, launches["fwd"]), ("masked_mha_bwd_dq", launches["bwd_dq"]),
                        ("masked_mha_bwd_dkv", launches["bwd_dkv"])):
            counts[name + model] = counts.get(name + model, 0) + k

    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60).stdout.rstrip()
    log("nvidia-smi topo -m:\n" + topo)
    peer = [[int(i == j or torch.cuda.can_device_access_peer(i, j)) for j in range(n)]
            for i in range(n)]
    log(f"peer access (torch.cuda.can_device_access_peer, row to column): {peer}")

    # ---- (e) every kernel on every card ----
    t0 = time.perf_counter()
    errs = card_kernel_checks(n)
    walls["19 (e) kernels on every card"] = round(time.perf_counter() - t0, 1)

    work = tempfile.mkdtemp(prefix="phase19_", dir=os.path.join(HERE, "build"))
    nccl_env = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,GRAPH,TUNING",
                "NCCL_DEBUG_FILE": os.path.join(work, "nccl.%h.%p")}
    try:
        # ---- the one-process references on cuda:0 ----
        t0 = time.perf_counter()
        rng = np.random.default_rng(1000)                # phase 3's videos
        entries = [make_synthetic_entry(rng, n_frames=N_FRAMES, objs_per_frame=OBJS,
                                        bucket_boxes=N_BOXES, bucket_rels=N_RELS,
                                        feat_dim=FEAT) for _ in range(B)]
        payload = p19_payload(entries)
        conf = p19_conf("cuda")
        refs = p19_references(torch.device("cuda", 0), conf, payload)
        torch.save(payload, os.path.join(work, "in.pt"))
        del entries
        torch.cuda.empty_cache()
        walls["19 references"] = round(time.perf_counter() - t0, 1)
        log(f"phase 19 references in this process on cuda:0: {conf['steps']} bf16 STTran steps "
            f"over all {B} videos, losses {[round(x['total'], 5) for x in refs['losses']]}, ms "
            f"{[round(x, 3) for x in refs['ms']]}; one DSG-DETR step on set (b), loss "
            f"{refs['dsg']['total']:.5f}")

        # ---- (a)-(c) in n ranks, one a card ----
        t0 = time.perf_counter()
        os.environ.update(nccl_env)
        try:
            pd.join_processes(mp.start_processes(
                p19_rank, args=(n, f"file://{os.path.join(work, 'store')}", work, conf),
                nprocs=n, join=False, start_method="spawn"), timeout_s=P16_TIMEOUT_S * 2)
        finally:
            for key in nccl_env:
                os.environ.pop(key, None)
        res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
               for r in range(n)]
        walls["19 (a)-(c) ranks"] = round(time.perf_counter() - t0, 1)
        log(f"phase 19 (a)-(c): {n} spawned ranks in {walls['19 (a)-(c) ranks']} s; NCCL's "
            f"log (NCCL_DEBUG=INFO, INIT,GRAPH,TUNING):\n  "
            + "\n  ".join(nccl_log_lines(work) or ["(no line read)"]))
        bad = p19_verdicts(res, refs, conf)
        if bad:
            fail("phase 19: " + "; ".join(bad))
        for x in res:
            add(x["a"]["launches"], True)
            add(x["a"]["nan_launches"], True)
            add(x["a"]["dsg_launches"], True, "_dsg_detr")
            for what, (_, _, launches, _) in x["b"]["sp"].items():
                add(launches, False, "_dsg_detr" if what.startswith("dsg") else "")
            for c in x["c"].values():
                if "launches" in c:
                    add(c["launches"], True)
        del res, refs, payload

        # ---- (d) the entry point: run_training, a rank a card ----
        for name, k in p19_runs(n, card, work, walls, torch.device("cuda", 0)).items():
            counts[name] = counts.get(name, 0) + k
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 19 launches by kernels row (the ranks' main-path runs, summed over ranks): "
        f"{counts}")
    return counts, errs, walls


# the multi-card `kernels` rows: each kernel's source and the TPU call it replaces
P19_ROWS = {"masked_mha": ("masked_attention.cu", "pallas_attention.py:143"),
            "masked_mha_fwd_train": ("masked_attention.cu", "pallas_attention.py:143"),
            "masked_mha_bwd_dq": ("masked_attention.cu", "pallas_attention.py:157"),
            "masked_mha_bwd_dkv": ("masked_attention.cu", "pallas_attention.py:157"),
            "masked_mha_dsg_detr": ("masked_attention.cu", "pallas_attention.py:143"),
            "masked_mha_fwd_train_dsg_detr": ("masked_attention.cu", "pallas_attention.py:143"),
            "masked_mha_bwd_dq_dsg_detr": ("masked_attention.cu", "pallas_attention.py:157"),
            "masked_mha_bwd_dkv_dsg_detr": ("masked_attention.cu", "pallas_attention.py:157"),
            "roi_align": ("roi_align.cu", "pallas_roi_align.py:163"),
            "grouped_conv3x3": ("grouped_conv.cu", "pallas_grouped_conv.py:148"),
            "grouped_conv3x3_fp32": ("grouped_conv.cu", "pallas_grouped_conv.py:148")}


def multicard_rows(counts: dict, errs: dict) -> list[dict]:
    """Phase 19's `kernels_multicard` rows: each kernel's launches on the
    ranks' main-path runs and its largest error against its plain version
    on each card (part (e))."""
    return [{"name": name, "route": "cuda", "source": f"nl_vsgg_tpu_torch/csrc/{src}",
             "replaces": f"nl_vsgg_tpu/ops/{tpu}", "launches_multicard": counts.get(name, 0),
             "max_abs_err_by_card": errs.get(name)} for name, (src, tpu) in P19_ROWS.items()]


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Drive the PyTorch port on the GPU.")
    parser.add_argument("--cards", type=int, default=0,
                        help="run phase 19 alone (after the build): the parallel layer with "
                             "one rank on each of this many cards, over NCCL")
    args = parser.parse_args()
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if args.cards and torch.cuda.device_count() < args.cards:
        fail(f"--cards {args.cards}: {torch.cuda.device_count()} CUDA card(s) visible")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on the GPU")
    sys.path.insert(0, HERE)
    try:
        import nl_vsgg_tpu_torch  # noqa: F401
    except ImportError:
        fail(f"package nl_vsgg_tpu_torch not found beside {__file__}")
    from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
    from nl_vsgg_tpu_torch.models.sttran import STTran
    from nl_vsgg_tpu_torch.ops import _build, masked_attention as ma
    from nl_vsgg_tpu_torch.serve import predict
    from nl_vsgg_tpu_torch.train.step import eval_step, place_entries

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. build ----
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {json.dumps(built)} total {time.perf_counter() - t0:.3f} s")
    for name in built:
        report = open(_build.library_path(name) + ".log").read()
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    log(f"card: {card}")

    walls = {"1 build": round(time.perf_counter() - t_start, 1)}
    if args.cards:
        log(f"cards: {smi}")
        counts, errs, p19_walls = multicard_phases(args.cards, "; ".join(smi) or "not read")
        walls.update(p19_walls)
        log(f"phase walls (s): {json.dumps(walls)}")
        log(f"cards: {smi}; chip_smoke wall {time.perf_counter() - t_start:.1f} s")
        log(json.dumps({"kernels_multicard": multicard_rows(counts, errs)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    t_mark = time.perf_counter()

    def phase_done(name: str) -> None:
        """The wall since the last mark, under `name`."""
        nonlocal t_mark
        walls[name] = round(time.perf_counter() - t_mark, 1)
        t_mark = time.perf_counter()

    # ---- 2. kernel vs plain version at the path's shapes ----
    g = torch.Generator(device=dev).manual_seed(0)
    eval_kernel_checks(ma, g, dev)
    train_kernel_checks(ma, g, dev)

    dq_edge_checks(ma, g, dev)
    route_edge_checks(ma, g, dev)

    phase_done("2 kernels")
    # ---- 3. the main path at full width ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(1000)
    entries = [make_synthetic_entry(rng, n_frames=N_FRAMES, objs_per_frame=OBJS,
                                    bucket_boxes=N_BOXES, bucket_rels=N_RELS,
                                    feat_dim=FEAT) for _ in range(B)]
    log(f"requests: {B} synthetic videos in {time.perf_counter() - t0:.3f} s (host)")
    t0 = time.perf_counter()
    kw = dict(mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=3, device=dev)
    models = {}
    for dname, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        for fused in (True, False):
            models[dname, fused] = STTran(dtype=dtype, fused=fused,
                                          generator=torch.Generator().manual_seed(0), **kw)
    log(f"models: 4 x STTran in {time.perf_counter() - t0:.3f} s")

    ma.reset_launches()
    t0 = time.perf_counter()
    graphs = predict(models["bfloat16", True], entries, batch=B, device=dev)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(ma.LAUNCHES)
    log(f"serve.predict: {len(graphs)} scene graphs in {serve_s:.3f} s wall "
        f"(host stacking, upload, one bf16 forward, JSON); launches {launches}")
    if launches != {"fwd": 4, "bwd_dq": 0, "bwd_dkv": 0}:
        fail(f"serving launched {launches} in one forward, expected 4 forward launches")
    if len(graphs) != B or any(not gr["triplets"] for gr in graphs):
        fail("serve.predict did not return one non-empty scene graph per video")
    if not all(np.isfinite(t["score"]) for gr in graphs for t in gr["triplets"]):
        fail("non-finite triplet scores")

    batches = {"float32": place_entries(entries, device=dev),
               "bfloat16": place_entries(entries, rel_bf16=True, device=dev)}
    for dname, batch in batches.items():
        ker = eval_step(models[dname, True], batch)
        pln = eval_step(models[dname, False], batch)
        for key in HEADS + ("global_output",):
            a, b = ker[key], pln[key]
            if a.shape[0] != B or not bool(a.isfinite().all()):
                fail(f"{dname} {key}: shape {tuple(a.shape)} or non-finite values")
            d = float((a.float() - b.float()).abs().max())
            log(f"model {dname} kernel vs plain {key}: max_abs_diff {d:.3e}")
            if key in HEADS and d > MODEL_TOL[dname]:
                fail(f"{dname} {key}: kernel path differs from plain by {d} "
                     f"> {MODEL_TOL[dname]}")
    del ker, pln

    frames = B * N_FRAMES
    step_ms = {}
    for dname in ("bfloat16", "float32"):
        for fused in (True, False):
            m, batch = models[dname, fused], batches[dname]
            step_ms[dname, fused] = cuda_ms(lambda: eval_step(m, batch), iters=10)
            log(f"eval_step {dname} {'kernel' if fused else 'plain'} attention: "
                f"{step_ms[dname, fused]:.3f} ms/step, "
                f"{frames / step_ms[dname, fused] * 1e3:.1f} frames/s "
                f"(B={B} x {N_FRAMES} frames)")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 4. kernel timings on the main path's own inputs ----
    # the attention core's inputs of one bf16 forward, rebuilt from each
    # MaskedMHA call's own arguments (forward pre-hooks record them)
    captured = capture_attention(models["bfloat16", True],
                                 lambda: eval_step(models["bfloat16", True],
                                                   batches["bfloat16"]))
    totals = time_eval_calls(ma, captured, "staged", "masked_mha main path")
    log(f"masked_mha per forward (4 launches): kernel {totals['ms']:.4f} ms = "
        f"{totals['ms'] / step_ms['bfloat16', True] * 100:.1f}% of the bf16 eval step")

    profile_table(lambda: eval_step(models["bfloat16", True], batches["bfloat16"]),
                  step_ms["bfloat16", True], "bf16 eval step")

    # ---- 5. the training path at full width ----
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.train.step import make_train_step

    for dname in ("float32", "bfloat16"):
        ma.reset_launches()
        ker = train_grads(models[dname, True], batches[dname], 7, dev)
        torch.cuda.synchronize()
        got = dict(ma.LAUNCHES)
        ma.reset_launches()
        pln = train_grads(models[dname, False], batches[dname], 7, dev)
        if got != {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4} or any(ma.LAUNCHES.values()):
            fail(f"{dname} train forward/backward launched {got} (kernel path) and "
                 f"{dict(ma.LAUNCHES)} (plain path)")
        worst, worst_name, floored = compare_grads(ker, pln, f"{dname} train gradients",
                                                   TRAIN_GRAD_TOL[dname])
        log(f"train grads {dname} kernel vs plain attention (dropout {RATE}, same generator "
            f"seed): {len(pln)} tensors, worst ||dg||/||g|| {worst:.3e} at {worst_name} "
            f"(tol {TRAIN_GRAD_TOL[dname]}); {floored} denominators under the floor")
    del ker, pln

    batch = batches["bfloat16"]
    train_ms, train_launches, steps = {}, {}, {}
    for fused in (True, False):
        m = models["bfloat16", fused]
        st = create_train_state(m, lr=1e-5)
        step = make_train_step(m, st.optimizer)
        gen = torch.Generator(device=dev).manual_seed(11)
        for _ in range(2):                        # warm-up
            st, met = step(st, batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ma.reset_launches()
        t0 = time.perf_counter()
        totals_t = []
        for _ in range(TRAIN_STEPS):
            st, met = step(st, batch, gen)
            totals_t.append(met["total"])
        torch.cuda.synchronize()
        train_ms[fused] = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        train_launches[fused] = dict(ma.LAUNCHES)
        losses = [float(t) for t in totals_t]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        label = "kernel" if fused else "plain"
        log(f"train_step bf16 {label} attention: {train_ms[fused]:.3f} ms/step, "
            f"{frames / train_ms[fused] * 1e3:.1f} frames/s (B={B} x {N_FRAMES} frames, "
            f"{TRAIN_STEPS} steps after 2 warm-up), losses {[round(x, 4) for x in losses]}, "
            f"skipped {st.skipped}, launches {train_launches[fused]}, "
            f"peak device memory {peak:.2f} GiB")
        if not all(np.isfinite(losses)) or st.skipped != 0:
            fail(f"bf16 train steps ({label}): losses {losses}, skipped {st.skipped}")
        want = ({"fwd": 4 * TRAIN_STEPS, "bwd_dq": 4 * TRAIN_STEPS, "bwd_dkv": 4 * TRAIN_STEPS}
                if fused else {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0})
        if train_launches[fused] != want:
            fail(f"train steps ({label}) launched {train_launches[fused]}, expected {want}")
        steps[fused] = (st, step, gen)

    # ---- 6. train kernels timed on one train step's own inputs ----
    st, step, gen = steps[True]
    holder = {}

    def one_step():
        holder["st"], _ = step(st, batch, gen)
    records = record_train_attention(ma, one_step)
    st = holder["st"]
    if len(records) != 4 or not all("g" in r for r in records):
        fail(f"recorded {len(records)} attention calls with gradients in one train step")
    train_rows = time_train_records(ma, records, "train path", "staged")
    for n, r in train_rows.items():
        log(f"{n} per train step (4 launches): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms = {r['ms'] / train_ms[True] * 100:.2f}% of the step")
    profile_table(lambda: step(st, batch, gen)[0], train_ms[True], "bf16 train step")

    phase_done("3-6 serving and training")
    # ---- 7-9. the detector path ----
    del models, batches, batch, steps, st, step, records, captured
    torch.cuda.empty_cache()
    det16, det_rows = detector_phases(dev, card)

    phase_done("7-9 detector")
    # ---- 10. the probe path ----
    torch.cuda.empty_cache()
    probe_rows = probe_phases(dev, card)
    phase_done("10 probes")

    # ---- 11. the evaluation path ----
    torch.cuda.empty_cache()
    eval_phases(dev, card, entries)
    phase_done("11 evaluation")

    # ---- 12. DSG-DETR ----
    torch.cuda.empty_cache()
    dsg_rows = dsg_detr_phases(dev, card, entries)
    phase_done("12 DSG-DETR")

    # ---- 13. the data path: Action Genome on disk -> grounding -> training, ----
    # ---- 14. then the entry points on the same dataset ----
    import shutil
    import tempfile

    torch.cuda.empty_cache()
    p14, p16, p17, p18 = {}, {}, {}, {}
    # phase 18's checkpoints outlive phase 13's dataset: phase 15 reads them too
    shared = tempfile.mkdtemp(prefix="phase18_", dir=os.path.join(HERE, "build"))
    artifacts = {}

    def on_dataset(ag, root):   # phases 14, 16, 17 and 18 on the same dataset
        phase_done("13 data path")
        p14.update(entry_point_phases(dev, card, ag, root))
        phase_done("14 entry points")
        torch.cuda.empty_cache()
        p16.update(parallel_phases(dev, card, entries, ag, root))
        phase_done("16 parallel")
        torch.cuda.empty_cache()
        p17.update(model_axis_phases(dev, card, entries, ag, root))
        phase_done("17 model axis")
        torch.cuda.empty_cache()
        artifacts.update(write_standins(shared, dev))
        counts, made = acceptance_phases(dev, card, ag, shared, artifacts)
        p18.update(counts)
        artifacts.update(made)
        phase_done("18 acceptance")
    try:
        data_phases(dev, card, det16, then=on_dataset)
        del det16
        phase_done("13 data path, after its callbacks")

        # ---- 15. the offline label pipeline ----
        torch.cuda.empty_cache()
        p15, clip_rows = offline_phases(dev, card, artifacts)
        phase_done("15 offline")
    finally:
        shutil.rmtree(shared, ignore_errors=True)

    # ---- 20. result lines ----
    kernels = [attention_row("masked_mha", 143, launches["fwd"], totals),
               attention_row("masked_mha_fwd_train", 143, train_launches[True]["fwd"],
                             train_rows["fwd"]),
               attention_row("masked_mha_bwd_dq", 157, train_launches[True]["bwd_dq"],
                             train_rows["bwd_dq"]),
               attention_row("masked_mha_bwd_dkv", 157, train_launches[True]["bwd_dkv"],
                             train_rows["bwd_dkv"])]
    kernels += det_rows + probe_rows + dsg_rows + clip_rows
    for row in kernels:       # phases 14's to 18's launches, 0 off their paths
        row["launches_entry_points"] = p14.get(row["name"], 0)
        row["launches_offline"] = p15.get(row["name"], 0)
        row["launches_parallel"] = p16.get(row["name"], 0)
        row["launches_model_axis"] = p17.get(row["name"], 0)
        row["launches_acceptance"] = p18.get(row["name"], 0)
        row["launches_multicard"] = 0        # phase 19 runs only with --cards
    log(f"phase walls (s): {json.dumps(walls)}")
    log(f"card: {card}; chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
