"""Smoke run of lightglue_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py             # the smoke run below
    python3 chip_smoke.py --profile   # only the profiles (phase P)
    python3 chip_smoke.py --mesh      # only the data-parallel mesh (3i)
    python3 chip_smoke.py --weights   # only the released-checkpoint path (3j)

Phases, any failure raising (non-zero exit, no result line):
  0. device: the card's name and power limit, versions; the TF32 flags
     stay at torch's defaults (cuDNN's on), so the checks below hold the
     library's own fp32 scoping of its convs;
  1. build: nvcc compiles csrc/*.cu into _build/, one process per source
     (timed), each kernel's registers and spills (a spilling tensor-core
     kernel of B5, B6, K2, B2, B7, B8 or B10, the bf16 walk, tile
     product and conv on wgmma among them, or a spilling B9, B11 or B12,
     fails the
     run, as does a setmaxnreg that ptxas ignores; the score head's line
     names its tile);
  2. each kernel against its plain PyTorch version at the main paths'
     shapes, then at tiny and ragged shapes and, for the matcher's kernels,
     at 2048 keypoints; B4 (lin1 + lin2 on the tile product) at (4, 1024,
     256), (1, 2048, 256), (16, 1024, 256), ragged (2, 200) at D 256 and
     128, and over both images of a cross block in one call (B 1 at 2048,
     B 16 at 1024, ragged), each call twice, bit for bit; the whole-block
     kernels (B5, B6) exact and with shift 12 at B 1, 4 and 16, ragged
     and at 2048 keypoints (B5), masked and with a batch entry that has no
     valid point, each launched twice
     (bit for bit), and each of their tensor-core launches (projection,
     out_proj, lin1 with its LayerNorm partials, lin2, the tail chain)
     against its plain version at B 1 and 16, twice; the
     constant-shift variants (B1s, B3s) exact and with shift 12; ALIKED's
     kernels at RGB 768 x 1024 images (B10 at aliked-n16 and aliked-t16
     widths, B 1, 2 and 8, each launched twice, bit for bit; B11, B12 at B
     1, 2 and 8, each launched twice, bit for bit, and their blocks an SM;
     B9 at r 2 on ALIKED's score maps, bit for bit) and at edge shapes
     (a branch dimension of 1, ragged tiles, aliked-t16 widths), with
     random batch-norm statistics; head_dim 128 (K1 exact and shift, B1',
     B5 at two heads of 128, from the trained layers regrouped by
     two_head_params) and the row gather S1 (bf16, fp32, ragged); the
     attention walk where it splits its keys (B 1, ragged key counts, one
     key, an all-masked batch entry), each launch repeated bit for bit;
     K2 on the walk in its three modes (exact, B6's attention, shift 12) at
     B 1, 4 and 16 and ragged, masked and with either image of a batch
     entry all masked, and at B 1 at every split count, and B2 on the tile
     product at B 1, 4 and 16, M != N and ragged, masked, with exact ties
     inside a tile and across tile boundaries (lowest index), each launch
     repeated bit for bit; B7, B8 and B8's conv2a launch alone at B 1, 2
     and 8 (768 x 1024) and at ragged 8x8, 24x40, 72x136 and 12x52 images
     (the last with half-size rows not 16-byte aligned), each launched
     twice (bit for bit), and B8 and its conv2a launch on an input 4 bytes
     past a 16-byte boundary (equal to the bit to the same input aligned);
     B9 at r 4 on SuperPoint's score maps at B 1, 2
     and 8, and at every radius 0-8 on a 61 x 83 edge map (plateaus,
     all-negative scores), each bit for bit;
  3. the main paths, each with the kernels' launch counts set to 0 just
     before it and read just after (a CUDA graph replay adds the counts
     its capture made):
     a. pipeline.LightGlue with the trained matcher weights on planted pairs
        (single pairs, one through padding buckets, and a batch of 8; fixed
        and adaptive), one pair of each held against the same call on CPU
        tensors, in five block configurations: the composed blocks, exact
        (B1, B3, B4); the default, exact (B5, B6); the default with shift
        12 at 1024 keypoints (B5, B6) and at 2048 (B5, B3s); the composed
        blocks with shift 12 (B1s, B3s); and with two heads of 128
        (two_head_params), default exact and shift 12 at 1024 and 2048
        keypoints (B5, B1', never B6 or K2), composed with shift 12 (B1s
        at d 128, B1');
     on each matcher path's fixed call, every K2, B2 and attention-walk
     launch (K1 inside B5 or alone, at head_dim 64 and 128, and B1') is
     held against float64 on the path's own inputs (path_kernel_trace);
     b. images to matches at the default configuration:
        pipeline.match_pair(SuperPoint, LightGlue) on generated 768 x 1024
        pairs (one needing padding, one a 2x area downscale) and
        end_to_end.make_end_to_end at B 4, SuperPoint at its published
        widths with seeded random weights (conv weights times 3, see
        models.superpoint.init_params), one pair held against the CPU port;
        then the same matcher on a planted pair at 2048 keypoints, where it
        has matches to find, held against the CPU port; then one
        match_pair with the two-head matcher (B5, B1');
     c. images to matches through ALIKED: match_pair(ALIKED,
        LightGlue("aliked")) on generated 768 x 1024 RGB pairs and
        make_end_to_end at B 4 (B 2 for the dense map), 1024 keypoints,
        aliked-n16 and the matcher with seeded random weights (ALIKED's
        conv weights scaled, see aliked_params), in three extractor
        configurations (default; fused_score_head; lazy_fm=False with
        fused_score_head), each launching its kernels and not the others',
        one pair of each held against the CPU port; then the "aliked"
        preset built from the trained matcher on a planted pair of 128-d
        descriptors, where it has matches to find, held against the CPU
        port (matches, prune, stop and matching scores);
     g. images to matches through DISK and SIFT (768 x 1024 generated
        pairs): match_pair(DISK, LightGlue("disk")) at 2048 keypoints (B5,
        K2 + B4, B2) and make_end_to_end B 4 at 1024 (B5, B6, B2), in fp32
        and at mp (the bf16 forms), DISK at its published widths with
        seeded random weights, one pair against the CPU port (fp32:
        keypoints, descriptors, matches; mp: phase 5f's rule) and every
        keypoint the two do not share a near-tie (scripts/keypoint_margins.
        py), then the "disk" preset built from the trained matcher on a
        planted pair; SIFTDevice -> LightGlue("sift", trained weights)
        through match_pair at 4096 keypoints (K1 + B4, K2 + B4, B2),
        make_end_to_end B 2 and match_sequence (window 1) at 1024 (B5, B6,
        B2), precision against each pair's homography, one pair against the
        CPU port (its pyramid, then its slots paired by position over
        scale and orientation, each one side lacks printed with its margins
        to the top-k's cut and the contrast threshold);
        SIFT(backend="opencv") through match_pair (4096 slots), its matches
        against the CPU port's matcher on the same features;
        DoGHardNetDevice -> LightGlue("doghardnet", the trained SIFT
        layers) through match_pair at 4096 keypoints, make_end_to_end B 2
        and match_sequence (window 1) at 1024, HardNet with seeded stand-in
        weights (synthetic.hardnet_params), the card's patches and
        descriptors against the CPU port's at the card's own detections;
        DoGHardNet (OpenCV on the host, HardNet on the card) through
        match_pair, its features against the CPU port's DoGHardNet and its
        matches against the CPU port's matcher on the same features; each
        path's launch counts read on their own, none of the other
        extractors' kernels launched;
     d. the row-gather study, lightglue_tpu_torch.scripts.micro_gather2,
        at its shapes (S1 against tbl[idx], index_select and the one-hot
        product);
     e. serving: BatchMatcher (parallel/batching.py) with the trained
        weights, buckets (512, 1024, 2048), max_batch 16, fixed and
        adaptive, on 40 planted pairs of 300-2048 keypoints after warmup
        (one CUDA graph set per bucket, batch and signature,
        parallel/graphs.py): every padded batch's graph replay equal to
        the bit to the eager forward on the card, each bucket's kernels
        from the graphs' launch counts (B5, B6 and B2 up to 1024; B5, K2,
        B4 and B2 at 2048), no capture during the traffic, precision
        against the planted truth, one pair per bucket held against the
        CPU port (matches, stop, prune, scores); then the default grid (8
        buckets to 4096, batch 16, with and without image_size) captured,
        its device memory printed, and a request at bucket 4096;
     f. pipeline.match_sequence on 8 generated 768 x 1024 frames (1024
        keypoints, fixed, threshold 0), windows 1 and 4: SuperPoint's
        kernels once per image, each pair against make_end_to_end on that
        pair alone (keypoints, valid and matches equal to the bit;
        descriptors and matching scores within their tolerances), and the
        first three frames through the CPU port;
     h. training and the host runtime (run after the mp and two-stage
        paths): one training step (train.matcher_loss, backward,
        OptaxAdamW) on the card against the CPU port at the superpoint
        preset's full width, B 2, m 256, one batch drawn on the CPU and one
        initial tree (the loss within 1e-4 relative, each leaf's gradient
        within 1e-3 of its largest |grad|); train.train_synthetic on the
        card, B 16, m 512, 200 steps (ms a step by CUDA events from step
        20, its FLOPs and bound, the loss at each logged step beside the
        JAX trainer's curve, peak memory; the last loss under half the
        first); the trained tree through LightGlue(params=tree) at the
        default configuration on a planted pair at 1024 keypoints, fixed
        and adaptive (B5, B6, B2 launched; held against the CPU port as in
        a.; the adaptive call exits before the last layer; these launches
        stay out of the kernels line); the C++ host runtime (native.py)
        built and each entry point equal to its numpy form on e.'s
        traffic;
     i. the data-parallel mesh (parallel/mesh.py; run after 5h's path):
        BatchMatcher at the JAX headline (trained weights, adaptive, mp,
        shift 12, 1024 keypoints) on B 16 planted pairs and 13 ragged
        requests over a mesh of every visible card, of two slots on card 0
        and a (2, 1) hosts x cards mesh, each against the one-slot
        BatchMatcher (matches0 agreement 0.999 and the same stop; the
        one-slot mesh's scores within 1e-4, a larger mesh's within 6.4e-2
        and their 99.9th percentile within 3.2e-2, and for both the B 16
        and the ragged chunk each slot's rows to the bit against the
        one-slot runner at the slot's batch on them alone, at least one
        slot a chunk), every slot launching B5, B6 (bf16) and B2; a training
        backward and three steps at 3h's size over two slots on card 0
        against one slot (3h's tolerances); make_windowed_sequence_
        end_to_end (SuperPoint, the trained matcher adaptive) on 8 frames
        at window 2 over two slots against one slot, every slot launching
        B7-B9, B5, B6 and B2; each slot's launches and the host ms of one
        slot and two slots, in turns;
     j. the released-checkpoint path (run after 3i): one seeded stand-in a
        weights.REGISTRY entry (12) saved as {name}.pth in a temporary
        cache, each resolved by weights.fetch (its download made to raise)
        and again from the npz it cached, both equal to the bit to the
        direct conversion (host ms of each); with that cache as the
        default, SuperPoint(pretrained=True) + LightGlue("superpoint",
        pretrained=True) through match_pair (768 x 1024, 2048 keypoints:
        B7, B8, B9, B5, K2 + B4, B2), that matcher on a planted pair at
        1024 keypoints (B5, B6, B2; precision >= 0.8), ALIKED (B10, B9) and
        DISK (pretrained=True) on one image, each equal to the bit to the
        same call with the directly converted params; then
        scripts/compaction_accuracy.py's functions for one row (1024
        keypoints, prefix 3, bucket 512, B 8, one seed) in fp32 and at mp
        on the trained weights, the masked path's gt_precision >= 0.95;
  4. timing with CUDA events and host clocks: each kernel beside its plain
     version (and the one PyTorch call that computes the same function,
     where there is one), K1 and B5 at head_dim 128 too, the attention
     walk (K1, B1s, B1') at B 1 too and its device time from CUDA-graph
     replays beside SDPA's; B4 at (4, 1024, 256), (1, 2048, 256) and (16,
     1024, 256) and over both images of a cross block in one call against
     two calls (B 1 at 2048, B 16 at 1024), with device time from CUDA
     graphs and the 3xTF32 bound; B5 and B6 at B 1, 4 and 16 with their
     projection (beside cuBLAS addmm) and tail, and K2 (exact and as B6's
     attention) and B2 at B 1, 4 and 16, as events and as CUDA-graph
     device time, B7 and B8 at B 2 likewise, and B9 (r 4 and r 2) and B10
     at B 2 with their device time, B11 and B12 at B 1, 2 and 8 with their
     device time and bound; extraction ms per image (ALIKED with and
     without fused_score_head), the matcher in its default and composed
     configurations and
     with two heads of 128, end-to-end pairs/s and
     match_pair ms per pair, for SuperPoint and for ALIKED; BatchMatcher
     (graphs) against pipeline.LightGlue (eager) at 1024 keypoints, fixed
     and adaptive, B 1 and B 16, in turns, and match_sequence against
     make_end_to_end once per pair on 8 frames, windows 1 and 4 (phase 4d);
     K2's rows (B3, B3s, B6's attention) beside two SDPA calls, one a
     direction, as B1''s; DISK (B 1, B 8, fp32 and mp), SIFTDevice (B 1)
     and DoGHardNetDevice (B 1, B 2; HardNet's patches and CNN apart, the
     CNN beside its bound) ms per image, make_end_to_end DISK B 8,
     SIFTDevice and DoGHardNetDevice B 2 pairs/s and match_pair ms a pair
     with SIFTDevice and opencv SIFT (phase 4e);
  5. the matcher's bf16 path (mp=True): a. each bf16 kernel (B5, B6 at B 1,
     4 and 16, 1024 keypoints; B4 at (4, 1024, 256) and over both images at
     B 16; B1 / B1s at (4, 4, 4096, 64), (1, 4, 4096, 64) and (4, 4, 1024,
     64); B3 / B3s at (4, 4, M 2048 / N 1536, 64) and (4, 4, 1024 / 768),
     exact and shift 12, masked as phase 2) against its bf16 plain version
     within 2e-2 max(1, |plain|) and within 2^-6 (|plain| + rms(plain
     row)), each launch twice bit for bit, and what both bounds read for a
     K1 or K2 that skips a key tile or leaves its weights unrounded; b.
     pipeline.LightGlue(mp=True), fixed and adaptive, exact and shift 12, B
     1 and B 16 at 1024 keypoints: B5 and B6 in bf16 and no fp32 block or
     attention kernel launched, planted precision and recall within 0.01 of
     the fp32 path on the card, matches0 >= 0.99 equal to the CPU port at
     mp with the same stop; c. BatchMatcher at mp
     (fixed exact, adaptive shift 12) at buckets 512-4096, batches 1 and
     16: replays equal to the bit to the eager mp forward, each bucket's
     bf16 kernels (B1, B3, B4 above 1024 and 2048), precision, each
     bucket's batch-1 pair against the CPU port at mp; d.
     match_pair and make_end_to_end with fp32 SuperPoint features into the
     mp matcher; e. each bf16 kernel beside its plain version and its fp32
     form (events and CUDA-graph device time, the bf16 bound: FLOPs / 989
     TFLOP/s, bytes at 2 a bf16 element / 3.35 TB/s), and BatchMatcher at
     mp (exact and shift 12) against fp32 at B 1 and B 16, fixed and
     adaptive; the extractors' bf16 forms likewise (B7, B8, B10 at B 2;
     B11, B12 at B 1, 2 and 8, their bound the fp32 form's), K2's bf16 rows
     and B6's attention in bf16 (B 1, 4, 16) beside two SDPA calls in bf16,
     SuperPoint and ALIKED ms per image at mp and fp32 (B 1, B 8) and
     make_end_to_end pairs/s at mp and fp32 (B 8), in turns, and cuDNN's
     bf16 conv on conv1b's and conv2a's shapes as a yardstick; f. the
     extractors at mp: the bf16 forms of B7 (csrc/conv_wgmma.cuh) at B 2,
     1 and 8 (768 x 1024) and at widths that leave the last 128-column
     strip part full, and B8 (and B8's conv2a launch) on each of those maps
     NHWC as B7 wrote it and contiguous NCHW, at B 2 also on inputs 1 and 8
     elements off a 16-byte boundary, B10 at aliked-n16 and t16, B11 and
     B12 at B 1, 2 and 8, each against its bf16 plain version under both
     bf16 bounds at all but 1e-4 of the outputs and equal at all but 1e-2
     (flip_check: a sum rounded before a bias that cancels it flips by one
     bf16 step of the sum), each launch twice bit for bit, with two probes
     the check must fail (B7 with a tap dropped; rounded only at its
     output); SuperPoint(mp=True) -> LightGlue(mp=True) through match_pair
     (2048 keypoints) and make_end_to_end (B 8, 1024), ALIKED(mp=True) ->
     LightGlue("aliked", mp=True) in three configurations: only bf16
     extractor kernels launched, each against the CPU port at mp; then the
     margins of every keypoint that the card's mp extraction keeps and the
     CPU port's does not, or the reverse (SuperPoint on two images, ALIKED
     in the three configurations; scripts/keypoint_margins.py): a keypoint
     that clears both the top-k's cut and its NMS window's runner-up by
     more than 4 steps of its score fails the run (ALIKED: with its two
     deformable blocks' outputs from the CPU, the deformable conv held to
     the bit on its own; the whole chain's count printed); g.
     head_dim 128 at mp: the bf16 forms of K1 (exact and shift 12 at (4,
     2, 1024, 128), (1, 2, 1024, 128), (4, 2, 4096, 128) masked and ragged
     shapes), B1' ((4, 2, M 1024 / N 768, 128), B 1, ragged) and B5 at two
     heads of 128 (B 1, 4 and 16 x 1024) against their bf16 plain versions
     within both bounds, the share of outputs not equal printed, each
     launch twice bit for bit, and a skipped 32-key tile read by the scaled
     bound; then the two-head matcher at mp (the trained layers
     regrouped): pipeline.LightGlue default and composed, exact and shift
     12, B 1 and B 16, BatchMatcher at buckets 1024 and 4096 (replays equal
     to the bit to the eager forward) and match_pair, each against the CPU
     port at mp, the d-128 bf16 kernels launched and no fp32 or d-64 block
     kernel; their timing beside the fp32 forms and SDPA in bf16; h.
     two-stage compaction (prefix 3, bucket 640, shift 12) in fp32 and at
     mp through BatchMatcher (the prefix at 1024, one compaction graph, the
     suffix at 640; adaptive and with width pruning only, B 8 and B 1,
     every replay equal to the bit to the eager forward, matches0 against
     the CPU port) and make_end_to_end (SuperPoint, B 8), and its timing
     beside the masked adaptive forward, with the two-head matcher at mp;
     i. the bf16 walk and tile product on wgmma + TMA at their edges (K1,
     B1s and B1' at d 64 and 128, K2's three walks, B4, B5, B6): one key,
     query and key counts no multiple of the tiles, an all-masked batch
     entry, B 1 at every split count, rows 16 bytes past a 128-byte
     boundary inside a larger allocation, each against its bf16 plain
     version under both bounds and twice bit for bit.
A JSON object of the kernels (with each one's bound, from its shapes, and
the 3xTF32 bound of the tensor-core kernels: the walk, B5, B6, K2, B2, B7,
B8, B10; the bf16 forms' rows bounded by the bf16 tensor cores) and
the card's name and power limit come before the last line,
{"ok": true, "device": {...}}.

Phase P (``--profile``, after phases 0 and 1): torch.profiler over the
matcher at 1024 keypoints (planted pairs, trained weights; B 1 and B 16,
fixed and adaptive, default and composed blocks, and the default with two
heads of 128), over SuperPoint at B 1 and B 8 (fp32 and mp), match_pair
at 2048 keypoints (fixed) and images -> SuperPoint -> LightGlue fixed at
B 8 (fp32 and mp), over
ALIKED at B 1 and B 8 and over images -> ALIKED -> LightGlue fixed at B 8,
each at the default configuration and with fused_score_head (B11), over
BatchMatcher (CUDA graphs) fixed and adaptive at B 1 and B 16 (fp32, and
at mp exact and with shift 12), over match_sequence (8 frames, windows
1 and 4) beside make_end_to_end once per pair, and over a training step
(superpoint preset, B 16, m 512): wall ms per call (timed without the
profiler, whose host tracing slows the host; the wall under it beside),
device ms per call, the device's busy share (device over that wall),
device ops per call and the largest device items.
"""

from __future__ import annotations

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lightglue_tpu_torch import (  # noqa: E402
    ALIKED, DISK, SIFT, ALIKEDConfig, BatchMatcher, DISKConfig, DoGHardNet,
    DoGHardNetDevice, LightGlue, SIFTConfig, SIFTDevice, SuperPoint,
    SuperPointConfig, _build, lightglue_config, match_pair, match_sequence)
from lightglue_tpu_torch import end_to_end, native, nn, train  # noqa: E402
from lightglue_tpu_torch.models import lightglue as lg  # noqa: E402
from lightglue_tpu_torch.parallel import batching, graphs  # noqa: E402
from lightglue_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from lightglue_tpu_torch import weights as weights_lib  # noqa: E402
from lightglue_tpu_torch.models import aliked as al  # noqa: E402
from lightglue_tpu_torch.models import disk, hardnet, sift_device  # noqa: E402
from lightglue_tpu_torch.models import superpoint as sp  # noqa: E402
from lightglue_tpu_torch.ops import assignment as asg  # noqa: E402
from lightglue_tpu_torch.ops import assignment_fused as af  # noqa: E402
from lightglue_tpu_torch.ops import ffn, flash, flash_cross  # noqa: E402
from lightglue_tpu_torch.ops import block_tc  # noqa: E402
from lightglue_tpu_torch.ops import flash_cross_block, flash_self  # noqa: E402
from lightglue_tpu_torch.ops import aliked_stem, deform, score_head  # noqa: E402
from lightglue_tpu_torch.ops import gather, nms, stem, stem2  # noqa: E402
from lightglue_tpu_torch.scripts import attn_split, extract_times  # noqa: E402
from lightglue_tpu_torch.scripts import compaction_accuracy as ca  # noqa: E402
from lightglue_tpu_torch.scripts import micro_gather2, walk_sums  # noqa: E402
from lightglue_tpu_torch.scripts import keypoint_margins as km  # noqa: E402
from lightglue_tpu_torch.scripts import train_synthetic as train_script  # noqa: E402
from lightglue_tpu_torch.synthetic import (  # noqa: E402
    hardnet_params, image_pair, planted_pairs, warp_points)

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "weights", "synthetic_superpoint_lightglue.npz")
# The kernels sum in another order than the plain versions (tiles, online
# softmax, fma): fp32 outputs of O(1-10) agree to ~1e-6, checked at 1e-4.
TOL = 1e-4
KERNELS = {
    "flash_sdpa": ("lightglue_tpu_torch/csrc/flash_sdpa.cu",
                   "lightglue_tpu/ops/flash.py:94"),
    "fused_cross_attention": ("lightglue_tpu_torch/csrc/flash_cross.cu",
                              "lightglue_tpu/ops/flash_cross.py:44"),
    "fused_ffn_residual": ("lightglue_tpu_torch/csrc/blocks.cu",
                           "lightglue_tpu/ops/ffn.py:40"),
    "fused_filter_matches": ("lightglue_tpu_torch/csrc/assignment_fused.cu",
                             "lightglue_tpu/ops/assignment_fused.py:39"),
    "fused_stem": ("lightglue_tpu_torch/csrc/stem.cu",
                   "lightglue_tpu/ops/stem.py:77"),
    "fused_block2": ("lightglue_tpu_torch/csrc/stem2.cu",
                     "lightglue_tpu/ops/stem2.py:46"),
    "simple_nms": ("lightglue_tpu_torch/csrc/nms.cu",
                   "lightglue_tpu/ops/nms.py:77"),
    "fused_self_block": ("lightglue_tpu_torch/csrc/blocks.cu",
                         "lightglue_tpu/ops/flash_self.py:84"),
    "fused_cross_block": ("lightglue_tpu_torch/csrc/blocks.cu",
                          "lightglue_tpu/ops/flash_cross_block.py:94"),
    "flash_sdpa_shift": ("lightglue_tpu_torch/csrc/flash_sdpa.cu",
                         "lightglue_tpu/ops/flash.py:63"),
    "fused_cross_attention_shift": ("lightglue_tpu_torch/csrc/flash_cross.cu",
                                    "lightglue_tpu/ops/flash_cross.py:116"),
    "fused_aliked_stem": ("lightglue_tpu_torch/csrc/aliked_stem.cu",
                          "lightglue_tpu/ops/aliked_stem.py:56"),
    "score_head_lazy": ("lightglue_tpu_torch/csrc/score_head.cu",
                        "lightglue_tpu/ops/score_head.py:161"),
    "score_head_cplane": ("lightglue_tpu_torch/csrc/score_head.cu",
                          "lightglue_tpu/ops/score_head.py:119"),
    "flash_cross_pair": ("lightglue_tpu_torch/csrc/flash_sdpa.cu",
                         "lightglue_tpu/ops/flash.py:220"),
    "gather_rows": ("lightglue_tpu_torch/csrc/gather.cu",
                    "scripts/micro_gather2.py:73"),
    # the bf16 forms (mp): the same TPU kernels fed bf16 operands
    "flash_sdpa_bf16": ("lightglue_tpu_torch/csrc/flash_sdpa.cu",
                        "lightglue_tpu/ops/flash.py:94"),
    "flash_sdpa_shift_bf16": ("lightglue_tpu_torch/csrc/flash_sdpa.cu",
                              "lightglue_tpu/ops/flash.py:63"),
    "fused_cross_attention_bf16": ("lightglue_tpu_torch/csrc/flash_cross.cu",
                                   "lightglue_tpu/ops/flash_cross.py:44"),
    "fused_cross_attention_shift_bf16": (
        "lightglue_tpu_torch/csrc/flash_cross.cu",
        "lightglue_tpu/ops/flash_cross.py:116"),
    "fused_ffn_residual_bf16": ("lightglue_tpu_torch/csrc/blocks.cu",
                                "lightglue_tpu/ops/ffn.py:40"),
    "fused_self_block_bf16": ("lightglue_tpu_torch/csrc/blocks.cu",
                              "lightglue_tpu/ops/flash_self.py:84"),
    "fused_cross_block_bf16": ("lightglue_tpu_torch/csrc/blocks.cu",
                               "lightglue_tpu/ops/flash_cross_block.py:94"),
    # the extractors' bf16 forms (mp)
    "fused_stem_bf16": ("lightglue_tpu_torch/csrc/conv_wgmma.cuh",
                        "lightglue_tpu/ops/stem.py:77"),
    "fused_block2_bf16": ("lightglue_tpu_torch/csrc/conv_wgmma.cuh",
                          "lightglue_tpu/ops/stem2.py:46"),
    "fused_aliked_stem_bf16": ("lightglue_tpu_torch/csrc/aliked_wgmma.cuh",
                               "lightglue_tpu/ops/aliked_stem.py:56"),
    "score_head_lazy_bf16": ("lightglue_tpu_torch/csrc/score_wgmma.cuh",
                             "lightglue_tpu/ops/score_head.py:161"),
    "score_head_cplane_bf16": ("lightglue_tpu_torch/csrc/score_wgmma.cuh",
                               "lightglue_tpu/ops/score_head.py:119"),
    # the matcher's bf16 forms at head_dim 128 (two heads under mp)
    "flash_sdpa_bf16_d128": ("lightglue_tpu_torch/csrc/flash_sdpa.cu",
                             "lightglue_tpu/ops/flash.py:94"),
    "flash_sdpa_shift_bf16_d128": ("lightglue_tpu_torch/csrc/flash_sdpa.cu",
                                   "lightglue_tpu/ops/flash.py:63"),
    "flash_cross_pair_bf16": ("lightglue_tpu_torch/csrc/flash_sdpa.cu",
                              "lightglue_tpu/ops/flash.py:220"),
    "fused_self_block_bf16_d128": ("lightglue_tpu_torch/csrc/blocks.cu",
                                   "lightglue_tpu/ops/flash_self.py:84"),
}
# Rows of the redesigned attention walk (K1, B1s, B1') in phase 4
ATTENTION_ROWS = ("flash_sdpa", "flash_sdpa_shift", "flash_sdpa d 128",
                  "flash_sdpa_shift d 128", "flash_cross_pair", "flash_sdpa B 1",
                  "flash_sdpa_shift B 1", "flash_sdpa d 128 B 1",
                  "flash_sdpa_shift d 128 B 1", "flash_cross_pair B 1")
# Rows of the redesigned B5 and B6 in phase 4: the whole ops (B 4 under
# their kernel names) and their projection and tail launches
BLOCK_ROWS = tuple(
    [f"fused_self_block{'' if b == 4 else f' B {b}'}" for b in (1, 4, 16)]
    + [f"fused_cross_block{'' if b == 4 else f' B {b}'}" for b in (1, 4, 16)]
    + [f"{blk} {part} B {b}" for blk in ("B5", "B6")
       for part in ("projection", "tail") for b in (1, 4, 16)])
# Rows of the redesigned K2 (mode 0: fused_cross_attention; mode 1: B6's
# attention) and B2 in phase 4 (B 4 under the kernel names), and B3s at B 4
CROSS_ROWS = tuple(
    [f"fused_cross_attention{'' if b == 4 else f' B {b}'}" for b in (1, 4, 16)]
    + [f"B6 attention B {b}" for b in (1, 4, 16)]
    + [f"fused_filter_matches{'' if b == 4 else f' B {b}'}" for b in (1, 4, 16)]
    + ["fused_cross_attention_shift"])
# Rows of the redesigned B7 and B8 in phase 4 (B 2, 768 x 1024)
CONV_ROWS = ("fused_stem", "fused_block2")
# Rows of the redesigned B4 in phase 4: one image at B 4 (under the kernel
# name), at match_pair's 2048 keypoints and at B 16; both images of a
# composed cross block in one call (pair) and in two
FFN_PAIRS = {"B 1 2048": "pair B 1, 2048 / 2048",
             "B 16": "pair B 16, 1024 / 1024"}
FFN_ROWS = (("fused_ffn_residual", "fused_ffn_residual B 1 2048",
             "fused_ffn_residual B 16")
            + tuple(f"fused_ffn_residual {form} {b}" for b in FFN_PAIRS
                    for form in ("pair", "two calls")))
MATCHER_KERNELS = ("flash_sdpa", "fused_cross_attention", "fused_ffn_residual",
                   "fused_filter_matches")
BLOCK_BATCHES = (1, 4, 16)  # B5 and B6 in phases 2c and 4
SHIFT = 12.0  # the JAX bench's self_ and cross_softmax_shift (bench.py:279)
COMPOSED = dict(fused_self=False, fused_cross=False)
SHIFTED = dict(self_softmax_shift=SHIFT, cross_softmax_shift=SHIFT)
TWO_HEADS = dict(num_heads=2)  # head_dim 128, the trained layers regrouped
# At head_dim 128: B5 (or K1) for the self blocks, B1' for the cross blocks,
# never B6 or K2 (their ones column in V needs head_dim <= 64)
HEAD128_KERNELS = ("fused_self_block", "flash_cross_pair", "fused_ffn_residual",
                   "fused_filter_matches")
NOT_HEAD128 = ("fused_cross_block", "fused_cross_attention",
               "fused_cross_attention_shift")
# Matcher paths of phase 3a: (name, config, keypoints, kernels it must
# launch, kernels it must not)
MATCHER_PATHS = (
    ("composed, exact", COMPOSED, 1024, MATCHER_KERNELS, ()),
    ("default, exact", {}, 1024,
     ("fused_self_block", "fused_cross_block", "fused_filter_matches"), ()),
    ("default, shift 12", SHIFTED, 1024,
     ("fused_self_block", "fused_cross_block", "fused_filter_matches"), ()),
    ("default, shift 12", SHIFTED, 2048,
     ("fused_self_block", "fused_cross_attention_shift", "fused_ffn_residual",
      "fused_filter_matches"), ()),
    ("composed, shift 12", dict(COMPOSED, **SHIFTED), 1024,
     ("flash_sdpa_shift", "fused_cross_attention_shift", "fused_ffn_residual",
      "fused_filter_matches"), ()),
    ("2 heads, default, exact", TWO_HEADS, 1024, HEAD128_KERNELS, NOT_HEAD128),
    ("2 heads, default, shift 12", dict(TWO_HEADS, **SHIFTED), 1024,
     HEAD128_KERNELS, NOT_HEAD128),
    ("2 heads, default, exact", TWO_HEADS, 2048, HEAD128_KERNELS, NOT_HEAD128),
    ("2 heads, default, shift 12", dict(TWO_HEADS, **SHIFTED), 2048,
     HEAD128_KERNELS, NOT_HEAD128),
    ("2 heads, composed, shift 12", dict(TWO_HEADS, **COMPOSED, **SHIFTED),
     1024, ("flash_sdpa_shift", "flash_cross_pair", "fused_ffn_residual",
            "fused_filter_matches"), NOT_HEAD128 + ("fused_self_block",)),
)
# Precision floor against the planted truth, a floor that catches wrong
# matches: the trained 4-head matcher reaches 0.95-1.0 on planted pairs;
# regrouped to two heads it was never trained so, and reaches 0.39-0.93 on
# the CPU port at 1024 and 2048 keypoints (random matches give ~0)
MIN_PRECISION = {4: 0.8, 2: 0.3}
# Images to matches at the default configuration and 2048 keypoints: B5 for
# the self blocks, the composed cross block (max(M, N) > 1024)
EXTRACTION_KERNELS = ("fused_stem", "fused_block2", "simple_nms",
                      "fused_self_block", "fused_cross_attention",
                      "fused_ffn_residual", "fused_filter_matches")
# H100 SXM peaks (NVIDIA's data sheet): fp32 CUDA cores and HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# dense TF32 tensor cores: the attention walk's fp32 products as 3xTF32 are
# three tf32 products each, a second bound of its rows
PEAK_TF32 = 495e12
# dense bf16 tensor cores: the bound of the bf16 (mp) rows, beside bytes at
# 2 a bf16 element
PEAK_BF16 = 989e12
# the score head's FLOPs a pixel: the three 3x3 convs' products (8 -> 4, 4
# -> 4, 4 -> 1), and B11's three 8-channel two-point lerps each way and sums
SCORE_CONV, SCORE_LERP = 2 * 9 * (32 + 16 + 4), 3 * 8 * 7


def ops_ms(name, flops):
    """The least ms of a row's operations at the card's peak: fp32 rows on
    the CUDA cores; the bf16 rows' products on the bf16 tensor cores, and
    B11's bf16 lerps (fp32 arithmetic) on the CUDA cores."""
    if "_bf16" not in name:
        return flops / PEAK_FLOPS * 1e3
    if name.startswith("score_head"):
        per = SCORE_CONV + (SCORE_LERP if name.startswith("score_head_lazy") else 0)
        conv = flops * SCORE_CONV / per
        return (conv / PEAK_BF16 + (flops - conv) / PEAK_FLOPS) * 1e3
    return flops / PEAK_BF16 * 1e3

BF16 = torch.bfloat16
# the bf16 kernels against their bf16 plain versions (phase 5): the JAX
# package's bf16 envelope (docs/PARITY.md), elementwise, relative to
# max(1, |plain|); the two sum in another order, so an fp32 product near a
# bf16 rounding boundary can round to the other neighbour
MP_REL = 2e-2
# That envelope is a fixed 0.02 for attention outputs, which lie far below
# 1; so each output is held, besides, to its own scale: |kernel - plain| <=
# 2^-6 (|plain| + rms(the plain row)), two bf16 steps of the larger. The
# rms term is the floor of the walk's own rounding: it rounds each weight
# against the running row maximum where the plain version (and the TPU
# kernel) rounds against the final one, one bf16 unit apart per weight, a
# random sum that reaches 2^-7.6 rms at the largest of K1's 4M outputs at
# 4096 keys (0.65 of the bound). A skipped 64-key tile reads 78-91 of it.
MP_SCALED = 2.0 ** -6
# The extractors' bf16 forms (phase 5f): the share of outputs allowed over
# either bound, where an fp32 sum rounded to bf16 before a bias or a
# batch-norm shift flips to the other neighbour and the shift cancels it
# (flip_check; on an H100 80GB HBM3 at 700 W, B8 at B 2 had 7-9 of 6.3M
# outputs over the scaled bound). A dropped tap moves most outputs (the
# probe in phase 5f).
MP_FLIPS = 1e-4
# ... and the share of bf16 outputs allowed to differ at all (one in 1e3 on
# B8 at B 2: the sums that round to the other neighbour)
MP_DIFFER = 1e-2
# The extractors at mp against the CPU port at mp (phase 5f): matches0
# equal on the keypoints in common, and those keypoints' share. Two correct
# bf16 extractions that sum in other orders part on the keypoints whose
# scores sit within bf16 noise of the cut (an H100 80GB HBM3 at 700 W,
# 768 x 1024, 2048 keypoints: 0.983 of SuperPoint's in common with the CPU
# port at mp, 0.961 with the card's own fp32 path; ALIKED's stand-in
# weights give a nearly flat score map, 0.53-0.64 and 0.38-0.43), so the
# share is held at a floor (MP_KPT: SuperPoint's, ALIKED's) and, besides,
# above the share in common with the card's fp32 extraction of the pair
MP_AGREE = 0.99
MP_KPT = (0.97, 0.45)
# ALIKED's soft-argmax (temperature 0.1) moves a keypoint by a few 1e-2 px
# when bf16 moves its scores: keypoints pair within half a pixel at mp
MP_KPT_TOL = 0.5
# The extractors' fp32 kernels, none of which an mp extractor launches
FP32_EXTRACT = ("fused_stem", "fused_block2", "fused_aliked_stem",
                "score_head_lazy", "score_head_cplane")
# ALIKED at mp in phase 5f: (name, extractor options, bf16 kernels it must
# launch), besides B9
MP_ALIKED_PATHS = (
    ("default (lazy, fused_stem)", {}, ("fused_aliked_stem_bf16",)),
    ("fused_score_head", dict(fused_score_head=True),
     ("fused_aliked_stem_bf16", "score_head_lazy_bf16")),
    ("dense, fused_score_head", dict(lazy_fm=False, fused_score_head=True),
     ("score_head_cplane_bf16",)),
)
# The conv kernels sum each output over (input channel, tap) in another
# order than cuDNN may: held to a bound relative to the output's size.
CONV_TOL = 1e-4
H, W = 768, 1024  # the extraction path's image size
MIN_KEYPOINTS = 500  # per image at H x W: a floor that catches a dead detector
# The score maps are sigmoids of a short conv chain: held to 1e-5 absolute.
SCORE_TOL = 1e-5
# ALIKED -> LightGlue("aliked") configurations of phase 3c: (name, extractor
# options, kernels it must launch, kernels it must not), besides the
# matcher's (B5 and the composed cross block at match_pair's 2048
# keypoints, B5 and B6 at make_end_to_end's 1024) and never SuperPoint's
ALIKED_PATHS = (
    ("default (lazy, fused_stem)", {}, ("fused_aliked_stem", "simple_nms"),
     ("score_head_lazy", "score_head_cplane")),
    ("fused_score_head", dict(fused_score_head=True),
     ("fused_aliked_stem", "score_head_lazy", "simple_nms"),
     ("score_head_cplane",)),
    ("dense, fused_score_head", dict(lazy_fm=False, fused_score_head=True),
     ("score_head_cplane", "simple_nms"),
     ("fused_aliked_stem", "score_head_lazy")),
)
ALIKED_MATCHER_KERNELS = ("fused_self_block", "fused_cross_attention",
                          "fused_ffn_residual", "fused_filter_matches",
                          "fused_cross_block")
KPT_TOL = 1e-3  # px: keypoints of card and CPU paired within this distance
# Matching scores (exp of a log-assignment entry, in [0, 1]) of card and
# CPU port on the same inputs: about 8e-6 apart, checked at 1e-4.
MATCH_SCORE_TOL = 1e-4
FIXED = dict(depth_confidence=-1.0, width_confidence=-1.0)
# Serving (phase 3e): BatchMatcher's buckets, each with the kernels its
# graphs must launch and must not, in MATCHER_PATHS' form: B5, B6 and B2 up
# to 1024 keypoints; at 2048 B5 and the composed cross block (K2, B4)
SERVING_BUCKETS = (
    (512, ("fused_self_block", "fused_cross_block", "fused_filter_matches"),
     ("fused_cross_attention", "fused_ffn_residual", "flash_sdpa")),
    (1024, ("fused_self_block", "fused_cross_block", "fused_filter_matches"),
     ("fused_cross_attention", "fused_ffn_residual", "flash_sdpa")),
    (2048, ("fused_self_block", "fused_cross_attention", "fused_ffn_residual",
            "fused_filter_matches"), ("fused_cross_block", "flash_sdpa")),
)
SERVING_PAIRS, SERVING_KEYPOINTS = 40, (300, 2048)
# match_sequence (phase 3f) at 1024 keypoints: SuperPoint's kernels once per
# image, then B5, B6 and B2
SEQUENCE_KERNELS = ("fused_stem", "fused_block2", "simple_nms",
                    "fused_self_block", "fused_cross_block",
                    "fused_filter_matches")
SEQUENCE_FRAMES, SEQUENCE_WINDOWS = 8, (1, 4)


def phase(name):
    print(f"== {name}", flush=True)


def max_err(a, b, rows=None):
    d = (a.float() - b.float()).abs()
    if rows is not None:
        d = d[rows]
    return float(d.max())


def check(name, err, tol=TOL):
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol:g})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: {err} > {tol}")
    return err


def device_phase():
    phase("0 device")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    # TF32 flags stay at torch's defaults (matmul off, cuDNN on): the
    # library keeps its own convs in fp32 (nn.fp32_convs), and this run
    # shows that it does
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}")
    print(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    return smi


def kernel_name(mangled):
    """The function name in a mangled kernel symbol, with its template
    arguments as mangled (ILb0ELi64E: <false, 64>)."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):  # the length is a digit suffix
            ident = mangled[m.end():m.end() + int(mangled[i:m.end()])]
            if re.fullmatch(r"[A-Za-z_]\w*(kernel|splits)", ident):
                args = re.match(r"I\w*?E(?=E*v)",
                                mangled[m.end() + len(ident):])
                return ident + (args.group() if args else "")
    return mangled


def build_phase():
    phase("1 build")
    t0 = time.time()
    path, log = _build.build()
    _build.library()
    # ptxas -v, one line a kernel: its name (and template arguments, as
    # mangled; the tile kernels' tile as rows x channels / warp), registers
    # and spills; a tensor-core kernel (blocks.cu's tile kernels, the
    # attention walks of K1, B1' and K2, and B2's) that spills or has a stack
    # frame fails the run
    # (the wgmma kernels too: the bf16 walk and tile product; and a
    # setmaxnreg that ptxas ignores fails it)
    name, spills = "?", ""
    tc = ("_tc_kernel", "cross_rows", "cross_cols", "cross_shift",
          "assign_tile", "flash_sdpa_kernel", "flash_cross_pair_kernel",
          "conv_tc_kernel", "nms_kernel", "score_head_kernel", "_wg_kernel",
          "conv_wg_kernel", "aliked_wg_kernel", "score_wg_kernel")
    for line in log.splitlines():
        if "setmaxnreg" in line and "ignored" in line:
            raise AssertionError(f"ptxas: {line.strip()}")
        if "Compiling entry function" in line:
            name = re.sub(r"IN2lg4gemm4TileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                          r"<\1x\2 / \3x\4>", kernel_name(line.split("'")[1]))
            name = re.sub(r"IN2lg5wgemm4TileILi(\d+)EEE", r"<128x\1>", name)
            # B7's and B8's bf16 forms: source (image, map), epilogue
            name = re.sub(r"conv_wg_kernelILi(\d)ELi(\d)E+",
                          lambda m: "conv_wg_kernel<{}, {}>".format(
                              ("image", "map")[int(m.group(1))],
                              ("pool NHWC", "NHWC", "pool NCHW")[int(m.group(2))]),
                          name)
            # B10's bf16 form: its width C1
            name = re.sub(r"aliked_wg_kernelILi(\d+)E+", r"aliked_wg_kernel<C1 \1>",
                          name)
            # B11's (lazy 1) and B12's bf16 forms
            name = re.sub(r"score_wg_kernelILb(\d)E+", r"score_wg_kernel<lazy \1>",
                          name)
            name = re.sub(r"INS0_4TileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                          r"EEELb(\d)ELb(\d)E",
                          r"<\1x\2, NQ \3, \4 stages, image \5, pool \6>", name)
            name = re.sub(r"INS_3GeoILi(\d+)ELi(\d+)ELi(\d+)ELi(\d)E+",
                          r"<r \1, \2x\3, step \4>", name)
            name = re.sub(r"INS_8StemTileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                          r"ELi(\d+)ELi(\d+)E+",
                          r"<C1 \1, CY \2, \3x\4, \5 m16 a warp, run \6>", name)
            name = re.sub(r"ILb(\d)ENS_9ScoreTileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                          r"ELi(\d+)E+",
                          r"<lazy \1, \2x\3, micro-tile rows \4 / \5 / \6>", name)
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line:
            print(f"  {name}: {line.split(':', 1)[1].strip()}; {spills}")
            if any(k in name for k in tc) and not spills.startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"):
                raise AssertionError(f"{name} spills: {spills}")
    print(f"  built {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s",
          flush=True)


def rand(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda")


def kernel_inputs():
    """Main-path shapes of every kernel (B 4, 1024 keypoints, D 256)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, n = 4, 4, 1024
    mask1000 = torch.rand(b, 1000, generator=g, device="cuda") < 0.8
    mask1000[1] = False  # one batch row with every key masked
    p = kernel_inputs_ffn(g)
    pairs = planted_pairs(np.random.default_rng(1), b, n)
    mdesc = [torch.from_numpy(pairs[f"descriptors{i}"]).cuda() * 3.0
             for i in (0, 1)]
    masks = [torch.rand(b, n, generator=g, device="cuda") < 0.9
             for _ in range(2)]
    z = [rand(g, b, n), rand(g, b, n)]
    # planted exact ties (copies with the same matchability): row 5 of
    # image 0 is a dominant match of column 100 of image 1, which is copied
    # to 700 and 900, and row 5 is copied to 800; the lowest index must win
    mdesc[0][:, 5] = mdesc[1][:, 100] * 4.0
    z[0][:, 5] = z[1][:, 100] = 5.0
    for j in (700, 900):
        mdesc[1][:, j] = mdesc[1][:, 100]
        z[1][:, j] = z[1][:, 100]
    mdesc[0][:, 800] = mdesc[0][:, 5]
    z[0][:, 800] = z[0][:, 5]
    masks[0][:, [5, 800]] = True
    masks[1][:, [100, 700, 900]] = True
    return {
        "k1": (rand(g, b, h, n, 64), rand(g, b, h, n, 64),
               rand(g, b, h, n, 64)),
        "k1_ragged": (rand(g, b, h, 1000, 64), rand(g, b, h, 1000, 64),
                      rand(g, b, h, 1000, 64), mask1000),
        "k2": (rand(g, b, h, 1024, 64), rand(g, b, h, 768, 64),
               rand(g, b, h, 1024, 64), rand(g, b, h, 768, 64),
               torch.rand(b, 1024, generator=g, device="cuda") < 0.9,
               torch.rand(b, 768, generator=g, device="cuda") < 0.9),
        "k3": (rand(g, b, n, 256), rand(g, b, n, 256), p),
        "k4": (mdesc[0], mdesc[1], z[0], z[1], *masks),
    }


def ffn_cases(k3):
    """B4's cases of phase 2: label -> (xs, msgs, params), one image or
    two (fused_ffn_residual_pair, the composed cross block): the main
    paths' shapes (B 4, 1024 keypoints; match_pair's 2048; B 16), ragged
    rows, D 128, and both images of a cross block at 2048 and at B 16."""
    g = torch.Generator(device="cuda").manual_seed(17)
    xx, msg, p = k3
    p128 = {"lin1": {"w": rand(g, 256, 256) / 16.0, "b": rand(g, 256) * 0.1},
            "ln": {"scale": 1 + rand(g, 256) * 0.1, "bias": rand(g, 256) * 0.1},
            "lin2": {"w": rand(g, 256, 128) / 16.0, "b": rand(g, 128) * 0.1}}
    cases = {"(4, 1024, 256)": ([xx], [msg], p)}
    for b, n, d, pp in ((1, 2048, 256, p), (16, 1024, 256, p),
                        (2, 200, 256, p), (2, 200, 128, p128)):
        cases[f"({b}, {n}, {d})"] = ([rand(g, b, n, d)], [rand(g, b, n, d)], pp)
    for b, m, n in ((1, 2048, 2048), (16, 1024, 1024), (2, 200, 72)):
        cases[f"pair B {b}, {m} / {n}"] = (
            [rand(g, b, m, 256), rand(g, b, n, 256)],
            [rand(g, b, m, 256), rand(g, b, n, 256)], p)
    return cases


def ffn_call(xs, msgs, p):
    """One B4 call over the segments: fused_ffn_residual or _pair."""
    if len(xs) == 1:
        return [ffn.fused_ffn_residual(xs[0], msgs[0], p)]
    return list(ffn.fused_ffn_residual_pair(xs[0], msgs[0], xs[1], msgs[1], p))


def ffn_checks(k3):
    """B4 (lin1 + lin2 on the tile product) against its plain version at
    each of ffn_cases, each call made twice, bit for bit."""
    err = 0.0
    for label, (xs, msgs, p) in ffn_cases(k3).items():
        got = ffn_call(xs, msgs, p)
        same(f"fused_ffn_residual {label}", got, ffn_call(xs, msgs, p))
        err = max(err, check(f"fused_ffn_residual {label}, twice, equal to "
                             "the bit", max(
                                 max_err(a, ffn.fused_ffn_residual_plain(x, m, p))
                                 for a, x, m in zip(got, xs, msgs))))
    return err


def k4_margin_rows(mdesc0, mdesc1, ls0, ls1, mask0, mask1):
    """Rows/columns whose top-two gap of the argmax score exceeds 1e-3."""
    b, m, _ = mdesc0.shape
    n = mdesc1.shape[1]
    bias0 = af._bias(mask0, b, m, "cuda")[:, :, None]
    bias1 = af._bias(mask1, b, n, "cuda")[:, None, :]
    sim = mdesc0 @ mdesc1.transpose(1, 2)
    s = sim + bias1 + bias0
    rterm = af._terms(ls0, torch.logsumexp(s, 2), mask0)
    cterm = af._terms(ls1, torch.logsumexp(s, 1), mask1)
    s2 = sim * 2.0 + bias1 + bias0
    top0 = (s2 + cterm[:, None, :]).topk(2, dim=2).values
    top1 = (s2 + rterm[:, :, None]).topk(2, dim=1).values
    return ((top0[..., 0] - top0[..., 1]) > 1e-3) & mask0, \
        ((top1[:, 0] - top1[:, 1]) > 1e-3) & mask1


def kernel_phase(x):
    phase("2 kernels against their plain versions")
    errs = {}
    q, k, v = x["k1"]
    e1 = check("flash_sdpa (4,4,1024,64)",
               max_err(flash.flash_sdpa(q, k, v), flash.flash_sdpa_plain(q, k, v)))
    q, k, v, valid = x["k1_ragged"]
    got = flash.flash_sdpa(q, k, v, valid)
    e2 = check("flash_sdpa (4,4,1000,64) masked",
               max_err(got, flash.flash_sdpa_plain(q, k, v, valid)))
    if not bool((got[1] == 0).all()):
        raise AssertionError("flash_sdpa: the all-masked batch row is not 0")
    errs["flash_sdpa"] = max(e1, e2)

    qk0, qk1, v0, v1, va0, va1 = x["k2"]
    m0, m1 = flash_cross.fused_cross_attention(qk0, qk1, v0, v1, va0, va1)
    r0, r1 = flash_cross.fused_cross_attention_plain(qk0, qk1, v0, v1, va0, va1)
    rows0 = va0[:, None, :].expand(-1, 4, -1)  # compared on valid rows
    errs["fused_cross_attention"] = max(
        check("fused_cross_attention m0 (M 1024, N 768) masked",
              max_err(m0, r0, rows0)),
        check("fused_cross_attention m1", max_err(m1, r1)))

    errs["fused_ffn_residual"] = ffn_checks(x["k3"])

    d0, d1, z0, z1, mk0, mk1 = x["k4"]
    ls0, ls1 = torch.nn.functional.logsigmoid(z0), torch.nn.functional.logsigmoid(z1)
    km0, kv0, km1, kv1 = af._filter_reductions_kernel(d0, d1, ls0, ls1, mk0, mk1)
    pm0, pv0, pm1, pv1 = af.filter_reductions_plain(d0, d1, ls0, ls1, mk0, mk1)
    errs["fused_filter_matches"] = max(
        check("fused_filter_matches row max (4,1024,1024,256)",
              max_err(kv0, pv0, mk0)),
        check("fused_filter_matches column max", max_err(kv1, pv1, mk1)))
    sure0, sure1 = k4_margin_rows(d0, d1, ls0, ls1, mk0, mk1)
    eq0 = km0.long() == pm0
    eq1 = km1.long() == pm1
    print(f"  fused_filter_matches argmax agreement: rows "
          f"{float(eq0[mk0].float().mean()):.6f}, columns "
          f"{float(eq1[mk1].float().mean()):.6f}; on the "
          f"{int(sure0.sum())}+{int(sure1.sum())} with top-two gap > 1e-3: "
          f"{int(eq0[sure0].sum())}+{int(eq1[sure1].sum())} equal")
    if not (bool(eq0[sure0].all()) and bool(eq1[sure1].all())):
        raise AssertionError("fused_filter_matches: argmax differs on a "
                             "row with a clear maximum")
    ties = (km0[:, 5] == 100) & (km0[:, 800] == 100) & (km1[:, 100] == 5)
    print(f"  fused_filter_matches planted exact ties: lowest index wins in "
          f"{int(ties.sum())}/{len(ties)} pairs")
    if not bool(ties.all()):
        raise AssertionError("fused_filter_matches: a tie went to a higher index")
    torch.cuda.synchronize()
    return errs


def block_inputs(params):
    """Inputs of B5, B6, B1s and B3s: layer 0 of the trained matcher, B 4
    at 1024 keypoints (768 in image 1 of B6) with one batch entry that has
    no valid point (image 1 for B6), and one image at 2048 keypoints."""
    g = torch.Generator(device="cuda").manual_seed(4)
    layer = nn.index_params(nn.params_to(params["transformers"], "cuda"), 0)

    def enc(b, n):  # rotary tables (2, B, 1, N, 32)
        ang = torch.rand(b, 1, n, 32, generator=g, device="cuda") * 6 - 3
        return torch.stack([ang.cos(), ang.sin()])

    def mask(b, n, p=0.85):
        return torch.rand(b, n, generator=g, device="cuda") < p

    valid = mask(4, 1024)
    valid[1] = False
    va1 = mask(4, 768, 0.9)
    va1[1] = False
    bx = {
        "layer": layer,
        "b5": {4: (rand(g, 4, 1024, 256), enc(4, 1024), valid)},
        "b5_2048": (rand(g, 1, 2048, 256), enc(1, 2048), mask(1, 2048)),
        "b6": {4: (rand(g, 4, 1024, 256), rand(g, 4, 768, 256),
                   mask(4, 1024, 0.9), va1)},
        "k_2048": (rand(g, 1, 4, 2048, 64), rand(g, 1, 4, 2048, 64),
                   rand(g, 1, 4, 2048, 64), mask(1, 2048), mask(1, 2048)),
    }
    # B 1 and B 16 and the ragged B5, from a generator of their own, so
    # that the inputs above (and the other kernels' checks on them) keep
    # their draws; batch entry 1 without a valid point
    g = torch.Generator(device="cuda").manual_seed(14)

    def mask_empty(b, n, p=0.85):
        m = mask(b, n, p)
        if b > 1:
            m[1] = False
        return m

    for b in (1, 16):
        bx["b5"][b] = (rand(g, b, 1024, 256), enc(b, 1024), mask_empty(b, 1024))
        bx["b6"][b] = (rand(g, b, 1024, 256), rand(g, b, 768, 256),
                       mask(b, 1024, 0.9), mask_empty(b, 768, 0.9))
    bx["b5_1000"] = (rand(g, 4, 1000, 256), enc(4, 1000), mask_empty(4, 1000))
    return bx


def block_weights(bx, shift):
    layer = bx["layer"]
    return (flash_self.prepare(layer["self_attn"], 4, shift),
            flash_cross_block.prepare(layer["cross_attn"], 4, shift))


def block_phase(x, bx):
    """B5 and B6 (exact and shift 12) and B1s and B3s against their plain
    versions at the main paths' shapes and at 2048 keypoints."""
    phase("2c whole-block kernels and constant-shift variants against their "
          "plain versions")
    errs = {"fused_self_block": 0.0, "fused_cross_block": 0.0}

    def note(name, label, err):
        errs[name] = max(errs[name], check(label, err))

    for shift in (None, SHIFT):
        w5, w6 = block_weights(bx, shift)
        b5_cases = [(f"B {b}", bx["b5"][b]) for b in BLOCK_BATCHES] + [
            ("ragged", bx["b5_1000"]), ("2048", bx["b5_2048"])]
        for label, (xx, enc, valid) in b5_cases:
            for mk in (None, valid):
                got = flash_self.fused_self_block(w5, xx, enc, mk)
                same(f"fused_self_block {label}", (got,),
                     (flash_self.fused_self_block(w5, xx, enc, mk),))
                note("fused_self_block",
                     f"fused_self_block {tuple(xx.shape)} shift {shift}"
                     f"{' masked' if mk is not None else ''}"
                     f"{', entry 1 all masked' if mk is not None and xx.shape[0] > 1 else ''}",
                     max_err(got, flash_self.fused_self_block_plain(w5, xx, enc, mk)))
        for b in BLOCK_BATCHES:
            x0, x1, va0, va1 = bx["b6"][b]
            got = flash_cross_block.fused_cross_block(w6, x0, x1, va0, va1)
            same(f"fused_cross_block B {b}", got,
                 flash_cross_block.fused_cross_block(w6, x0, x1, va0, va1))
            ref = flash_cross_block.fused_cross_block_plain(w6, x0, x1, va0, va1)
            note("fused_cross_block",
                 f"fused_cross_block B {b}, M 1024 / N 768 masked"
                 f"{' (image 1 of entry 1 empty)' if b > 1 else ''}, shift "
                 f"{shift}, valid rows",
                 max(max_err(got[0], ref[0], va0), max_err(got[1], ref[1], va1)))
        if shift is None:  # the launches do not depend on the shift
            for b in (1, 16):
                for name, w, xs, groups, enc in (
                        ("fused_self_block", w5, bx["b5"][b][:1], 3, bx["b5"][b][1]),
                        ("fused_cross_block", w6, bx["b6"][b][:2], 2, None)):
                    for label, err in launch_errors(w, xs, groups, enc).items():
                        note(name, f"{name} B {b}: {label}", err)

    q, k, v = x["k1"]
    e1 = check("flash_sdpa_shift (4,4,1024,64)",
               max_err(flash.flash_sdpa(q, k, v, shift=SHIFT),
                       flash.flash_sdpa_plain(q, k, v, shift=SHIFT)))
    q, k, v, valid = x["k1_ragged"]
    got = flash.flash_sdpa(q, k, v, valid, shift=SHIFT)
    e2 = check("flash_sdpa_shift (4,4,1000,64) masked",
               max_err(got, flash.flash_sdpa_plain(q, k, v, valid, SHIFT)))
    if not bool((got[1] == 0).all()):
        raise AssertionError("flash_sdpa_shift: the all-masked row is not 0")
    q, k, v, va0, va1 = bx["k_2048"]
    e3 = check("flash_sdpa_shift (1,4,2048,64) masked",
               max_err(flash.flash_sdpa(q, k, v, va0, shift=SHIFT),
                       flash.flash_sdpa_plain(q, k, v, va0, SHIFT)))
    errs["flash_sdpa_shift"] = max(e1, e2, e3)

    ce = []
    for name, (qk0, qk1, v0, v1, a0, a1) in (
            ("B 4, M 1024 / N 768", x["k2"]),
            ("B 1, M = N = 2048", (q, k, v, q, va0, va1))):
        got = flash_cross.fused_cross_attention(qk0, qk1, v0, v1, a0, a1,
                                                shift=SHIFT)
        ref = flash_cross.fused_cross_attention_plain(qk0, qk1, v0, v1, a0,
                                                      a1, SHIFT)
        ce.append(check(f"fused_cross_attention_shift {name} masked, all rows",
                        max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))))
    errs["fused_cross_attention_shift"] = max(ce)
    torch.cuda.synchronize()
    return errs


def same(name, a, b):
    """Raise unless two launches' outputs are equal bit for bit."""
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two launches differ")


def launch_errors(w, xs, groups, enc):
    """Each launch of B5's or B6's projection and tail (ops/block_tc.py)
    against its plain version on the same inputs (lin1 and lin2 from the
    plain version's msg and h), each launched twice, bit for bit; B6's over
    the rows of both images. Returns {launch: max abs error}; the
    LayerNorm partials' M2 relative to max(M2, 1)."""
    g = torch.Generator(device="cuda").manual_seed(15)
    b, h = xs[0].shape[0], w["num_heads"]
    ctxs = [rand(g, b, h, x.shape[1], x.shape[2] // h) for x in xs]
    errs = {}

    def run(name, fn, plain):
        got, again = fn(), fn()
        got, again = ((got, again) if isinstance(got, (list, tuple))
                      else ((got,), (again,)))
        same(name, got, again)
        want = plain()
        want = want if isinstance(want, (list, tuple)) else (want,)
        return got, want

    got, want = run("project", lambda: block_tc.project(w, xs, groups, enc),
                    lambda: block_tc.project_plain(w, xs, groups, enc))
    errs["project"] = max(max_err(a, c) for a, c in zip(got, want))
    (msg,), (msg_p,) = run("tail_out_proj", lambda: block_tc.tail_out_proj(w, ctxs),
                           lambda: block_tc.tail_out_proj_plain(w, ctxs))
    errs["tail_out_proj"] = max_err(msg, msg_p)
    msgs_p = list(torch.split(msg_p, [x.shape[0] * x.shape[1] for x in xs]))
    (hh, st), (hp, sp) = run("tail_lin1",
                             lambda: block_tc.tail_lin1(w, xs, msgs_p),
                             lambda: block_tc.tail_lin1_plain(w, xs, msgs_p))
    errs["tail_lin1 h"] = max_err(hh, hp)
    errs["tail_lin1 partial means"] = max_err(st[..., 0], sp[..., 0])
    errs["tail_lin1 partial M2 (relative)"] = float(
        ((st[..., 1] - sp[..., 1]).abs() / sp[..., 1].clamp(min=1.0)).max())
    got, want = run("tail_lin2", lambda: block_tc.tail_lin2(w, hp, sp, xs),
                    lambda: block_tc.tail_lin2_plain(w, hp, sp, xs))
    errs["tail_lin2"] = max(max_err(a, c) for a, c in zip(got, want))
    got, want = run("tail_chain", lambda: block_tc.tail_chain(w, ctxs, xs),
                    lambda: block_tc.tail_chain_plain(w, ctxs, xs))
    errs["tail_chain"] = max(max_err(a, c) for a, c in zip(got, want))
    return errs


def head128_phase(bx):
    """Phase 2e: K1 (exact and shift 12) and B1' at head_dim 128, and B5 at
    two heads of 128 (layer 0 of the trained matcher regrouped, exact and
    shift 12), at the two-head paths' shapes (B 4 at 1024 keypoints, 768 in
    image 1 of B1'), at 2048 and at tiny and ragged ones; then S1 at the
    gather study's shapes and ragged ones, bf16 and fp32, bit for bit.
    Returns (errors, the inputs for timing)."""
    phase("2e head_dim 128 (K1, B1', B5) and the row gather S1 against their "
          "plain versions")
    g = torch.Generator(device="cuda").manual_seed(8)
    errs = {}

    def note(name, label, err, tol=TOL):
        errs[name] = max(errs.get(name, 0.0), check(label, err, tol))

    def mask(b, n, p=0.85):
        m = torch.rand(b, n, generator=g, device="cuda") < p
        m[:, 0] = True
        if b > 1:
            m[1] = False  # batch entry 1 without a valid point
        return m

    def rows(valid, h):
        return valid[:, None, :].expand(-1, h, -1)

    shapes = ((4, 1024, 1024), (4, 1000, 1000), (1, 2048, 2048), (2, 1, 1),
              (2, 65, 63), (2, 3, 130))
    for shift, name in ((None, "flash_sdpa"), (SHIFT, "flash_sdpa_shift")):
        for b, nq, nk in shapes:
            q, k, v = (rand(g, b, 2, n, 128) for n in (nq, nk, nk))
            valid = mask(b, nk)
            got = flash.flash_sdpa(q, k, v, valid, shift=shift)
            note(name, f"{name} d 128 {(b, 2, nq, nk)} masked",
                 max_err(got, flash.flash_sdpa_plain(q, k, v, valid, shift)))
            if b > 1 and not bool((got[1] == 0).all()):
                raise AssertionError(f"{name} d 128: an all-masked row is not 0")
        q, k, v = (rand(g, 4, 2, 1024, 128) for _ in range(3))
        note(name, f"{name} d 128 (4, 2, 1024, 1024) unmasked",
             max_err(flash.flash_sdpa(q, k, v, shift=shift),
                     flash.flash_sdpa_plain(q, k, v, shift=shift)))

    pair_in = None
    for b, m, n in ((4, 1024, 768), (1, 2048, 2048), (2, 1, 1), (2, 65, 130),
                    (1, 130, 3)):
        qk0, v0 = rand(g, b, 2, m, 128), rand(g, b, 2, m, 128)
        qk1, v1 = rand(g, b, 2, n, 128), rand(g, b, 2, n, 128)
        va0, va1 = mask(b, m), mask(b, n)
        if pair_in is None:
            pair_in = (qk0, qk1, v0, v1, va0, va1)
        for masks in ((va0, va1), (None, va1), (va0, None), (None, None)):
            got = flash.flash_cross_pair(qk0, qk1, v0, v1, *masks)
            ref = flash.flash_cross_pair_plain(qk0, qk1, v0, v1, *masks)
            r0 = None if masks[0] is None else rows(masks[0], 2)
            r1 = None if masks[1] is None else rows(masks[1], 2)
            note("flash_cross_pair",
                 f"flash_cross_pair d 128 B {b}, M {m} / N {n}, masks "
                 f"{tuple(x is not None for x in masks)}, valid rows",
                 max(max_err(got[0], ref[0], r0), max_err(got[1], ref[1], r1)))

    layer = bx["layer"]  # two_head_params leaves the layers as they are
    w5 = {shift: flash_self.prepare(layer["self_attn"], 2, shift)
          for shift in (None, SHIFT)}
    b5_in = None
    for b, n in ((4, 1024), (1, 2048), (2, 70), (2, 1)):
        x = rand(g, b, n, 256)
        ang = torch.rand(b, 1, n, 64, generator=g, device="cuda") * 6 - 3
        enc = torch.stack([ang.cos(), ang.sin()])
        valid = mask(b, n)
        if b5_in is None:
            b5_in = (x, enc)
        for shift, w in w5.items():
            for mk in (None, valid):
                note("fused_self_block",
                     f"fused_self_block 2 heads x 128 {(b, n, 256)} shift "
                     f"{shift}{' masked' if mk is not None else ''}",
                     max_err(flash_self.fused_self_block(w, x, enc, mk),
                             flash_self.fused_self_block_plain(w, x, enc, mk)))

    tbl, idx = micro_gather2.make_inputs(0)
    ragged = ((100, 3, 7), (33, 130, 1001), (5, 6, 1), (7, 2, 0))
    for dtype in (torch.bfloat16, torch.float32):
        cases = [(tbl.to(dtype), idx)] + [
            (rand(g, r, c).to(dtype),
             torch.randint(0, r, (k,), generator=g, device="cuda",
                           dtype=torch.int32)) for r, c, k in ragged]
        for t, ix in cases:
            got = gather.gather_rows(t, ix)
            if not torch.equal(got, gather.gather_rows_plain(t, ix)):
                raise AssertionError(f"gather_rows differs at {dtype} "
                                     f"{tuple(t.shape)}, {ix.numel()} rows")
    try:
        gather.gather_rows(tbl, torch.tensor([0, tbl.shape[0]], device="cuda",
                                             dtype=torch.int32))
        raise AssertionError("gather_rows took an index past the table")
    except IndexError:
        pass
    errs["gather_rows"] = 0.0
    print(f"  gather_rows ({tbl.shape[0]}, {tbl.shape[1]}) x {idx.numel()} "
          f"and ragged {ragged}, bf16 and fp32: equal to the plain version; "
          "an index past the table raises")
    torch.cuda.synchronize()
    return errs, {"pair": pair_in, "b5": (w5[None], *b5_in),
                  "gather": (tbl, idx)}


def split_phase():
    """Phase 2f: K1 (exact and shift 12, head_dim 64 and 128) and B1' at
    shapes where the walk splits its keys (B 1), at key counts that are no
    multiple of the key tile or of the splits, fewer keys than a tile per
    split, one key, and a batch entry with every key masked; each launched
    twice on the same inputs, which must give the same bits."""
    phase("2f the key-split walk (K1, B1') against the plain versions, "
          "bitwise repeats")
    g = torch.Generator(device="cuda").manual_seed(12)
    errs = {}

    def mask(b, n, all_masked):
        m = torch.rand(b, n, generator=g, device="cuda") < 0.85
        m[:, 0] = True
        if all_masked:
            m[1] = False
        return m

    # (B, H, Nq, Nk, d, batch entry 1 all masked)
    k1_shapes = ((1, 4, 1024, 1024, 64, False), (1, 2, 1024, 1024, 128, False),
                 (1, 4, 1000, 1000, 64, False), (1, 2, 333, 333, 128, False),
                 (1, 4, 64, 100, 64, False), (1, 2, 64, 100, 128, False),
                 (2, 4, 70, 1, 64, False), (2, 2, 300, 500, 128, True),
                 (2, 4, 300, 500, 64, True))
    for b, h, nq, nk, d, empty in k1_shapes:
        q, k, v = rand(g, b, h, nq, d), rand(g, b, h, nk, d), rand(g, b, h, nk, d)
        valid = mask(b, nk, empty)
        (splits,) = flash.planned_splits([(q, k)])
        if (b, nq, nk) == (1, 1024, 1024) and splits == 1:
            raise AssertionError(f"K1 {(b, h, nq, nk, d)} is not split")
        for shift, name in ((None, "flash_sdpa"), (SHIFT, "flash_sdpa_shift")):
            for mk in ((valid,) if empty else (None, valid)):
                got = flash.flash_sdpa(q, k, v, mk, shift=shift)
                same(name, (got,), (flash.flash_sdpa(q, k, v, mk, shift=shift),))
                errs[name] = max(errs.get(name, 0.0), check(
                    f"{name} {(b, h, nq, nk, d)} S {splits}"
                    f"{' masked' if mk is not None else ''}"
                    f"{', entry 1 all masked' if empty else ''}",
                    max_err(got, flash.flash_sdpa_plain(q, k, v, mk, shift))))
                if empty and not bool((got[1] == 0).all()):
                    raise AssertionError(f"{name}: the all-masked entry is not 0")
    for b, m, n, empty in ((1, 1024, 768, False), (1, 1024, 30, False),
                           (2, 130, 300, True)):
        qk0, v0 = rand(g, b, 2, m, 128), rand(g, b, 2, m, 128)
        qk1, v1 = rand(g, b, 2, n, 128), rand(g, b, 2, n, 128)
        va0, va1 = mask(b, m, False), mask(b, n, empty)
        splits = flash.planned_splits([(qk0, qk1), (qk1, qk0)])
        if m == 1024 and (splits[1] == 1 or (splits[0] > 1) != (n == 768)):
            raise AssertionError(f"B1' M {m} / N {n}: splits {splits}")
        got = flash.flash_cross_pair(qk0, qk1, v0, v1, va0, va1)
        same("flash_cross_pair", got,
             flash.flash_cross_pair(qk0, qk1, v0, v1, va0, va1))
        ref = flash.flash_cross_pair_plain(qk0, qk1, v0, v1, va0, va1)
        errs["flash_cross_pair"] = max(errs.get("flash_cross_pair", 0.0), check(
            f"flash_cross_pair d 128 B {b}, M {m} / N {n}, S {splits}"
            f"{', entry 1 of image 1 all masked' if empty else ''}, valid rows",
            max(max_err(got[0], ref[0], va0[:, None].expand(-1, 2, -1)),
                max_err(got[1], ref[1], va1[:, None].expand(-1, 2, -1)))))
        if empty and not bool((got[0][1] == 0).all()):
            raise AssertionError("flash_cross_pair: the all-masked entry is not 0")
    print("  the B 1 shapes split their keys (B1' M 1024 / N 30: direction 1 "
          "only); every repeat bitwise equal")
    torch.cuda.synchronize()
    return errs


def b2_inputs(rng, g, b, m, n):
    """B2's inputs at (b, m, n), D 256: planted pairs (descriptors times 3,
    the roles swapped where m > n), random matchability logits, masks at
    0.9 with image 1 of entry 1 all masked but for the tied columns, and
    planted exact ties (copies with the same logit): within a tile, row 5 a
    dominant match of column 100, copied to 700 and 900, row 5 copied to
    800 (where they exist); across the tile boundaries of every tile of
    gemm_tc.cuh, row 63 a dominant match of column 127, copied to 128, and
    row 63 copied to 64. The lowest index must win. Returns (mdesc0,
    mdesc1, ls0, ls1, mask0, mask1, [(row, column) of each tie])."""
    pr = planted_pairs(rng, b, min(m, n), max(m, n))
    d = [torch.from_numpy(pr[f"descriptors{i}"]).cuda() * 3.0 for i in (0, 1)]
    if m > n:
        d = d[::-1]
    z = [rand(g, b, m), rand(g, b, n)]
    masks = [torch.rand(b, k, generator=g, device="cuda") < 0.9
             for k in (m, n)]
    if b > 1:
        masks[1][1] = False
    ties = []
    for r, c, cols, rows in ((5, 100, (700, 900), (800,)),
                             (63, 127, (128,), (64,))):
        d[0][:, r] = d[1][:, c] * 4.0
        z[0][:, r] = z[1][:, c] = 5.0
        for j in (j for j in cols if j < n):
            d[1][:, j] = d[1][:, c]
            z[1][:, j] = z[1][:, c]
            masks[1][:, j] = True
        for i in (i for i in rows if i < m):
            d[0][:, i] = d[0][:, r]
            z[0][:, i] = z[0][:, r]
            masks[0][:, i] = True
        masks[0][:, r] = masks[1][:, c] = True
        ties.append((r, c, [i for i in rows if i < m]))
    ls = [torch.nn.functional.logsigmoid(t) for t in z]
    return (*d, *ls, *masks, ties)


def b2_check(label, x):
    """B2 on x (b2_inputs) masked and unmasked against its plain version:
    the maxima within TOL on valid rows and columns, the argmax equal on
    every row and column with a top-two gap over 1e-3, every planted tie to
    the lowest index, two launches bit for bit. Returns the largest
    error."""
    d0, d1, ls0, ls1, mk0, mk1, ties = x
    err = 0.0
    for masks in ((None, None), (mk0, mk1)):
        got = af._filter_reductions_kernel(d0, d1, ls0, ls1, *masks)
        same(f"fused_filter_matches {label}", got,
             af._filter_reductions_kernel(d0, d1, ls0, ls1, *masks))
        m0, v0, m1, v1 = af.filter_reductions_plain(d0, d1, ls0, ls1, *masks)
        tag = f"{label}{' masked' if masks[0] is not None else ''}"
        err = max(err, check(f"fused_filter_matches {tag}, maxima",
                             max(max_err(got[1], v0, masks[0]),
                                 max_err(got[3], v1, masks[1]))))
        ones = [torch.ones_like(t, dtype=torch.bool) for t in (ls0, ls1)]
        sure0, sure1 = k4_margin_rows(
            d0, d1, ls0, ls1, *(mk if mk is not None else o
                                for mk, o in zip(masks, ones)))
        eq0, eq1 = got[0].long() == m0, got[2].long() == m1
        if not (bool(eq0[sure0].all()) and bool(eq1[sure1].all())):
            raise AssertionError(f"fused_filter_matches {tag}: argmax differs "
                                 "on a row with a clear maximum")
        for r, c, rows in ties:
            if not (bool((got[0][:, [r] + rows] == c).all())
                    and bool((got[2][:, c] == r).all())):
                raise AssertionError(f"fused_filter_matches {tag}: the tie "
                                     f"at ({r}, {c}) went to a higher index")
        print(f"    argmax equal on the {int(sure0.sum())}+{int(sure1.sum())} "
              f"rows and columns with a clear maximum; ties {ties} to the "
              "lowest index; repeats bitwise equal")
    return err


def cross_assign_phase():
    """Phase 2g: K2 in its three modes (0: fused_cross_attention, exact; 1:
    B6's attention, launch_cross in mode EXACT_BLOCK on qk scaled as B6
    folds it, held against flash_cross_block.cross_block_attention_plain;
    2: with shift 12) at B 1, 4 and 16 (M 1024 / N 768) and ragged (1000 /
    700), unmasked, masked, and with image 0 or image 1 of entry 1 all
    masked, then at B 1 at every split count of both directions; and B2 at
    B 1, 4, 16 (1024 x 1024), 1024 x 768 and ragged 1000 x 700 (b2_check).
    Every launch twice, bit for bit."""
    phase("2g K2 (modes 0, 1, 2) and B2 on the tensor cores against their "
          "plain versions, bitwise repeats")
    g = torch.Generator(device="cuda").manual_seed(21)
    errs = {}

    def note(name, label, err):
        errs[name] = max(errs.get(name, 0.0), check(label, err))

    def rows(valid, h=4):
        return None if valid is None else valid[:, None, :].expand(-1, h, -1)

    def modes(qk0, qk1, v0, v1, va0, va1, label, splits=None):
        # mode 0 and 2 through fused_cross_attention (planned splits) or
        # launch_cross (given splits); mode 1 on B6's scale
        for name, shift in (("fused_cross_attention", None),
                            ("fused_cross_attention_shift", SHIFT)):
            if splits is None:
                run = lambda: flash_cross.fused_cross_attention(  # noqa
                    qk0, qk1, v0, v1, va0, va1, shift)
            else:
                run = lambda: flash_cross.launch_cross(  # noqa
                    qk0, qk1, v0, v1, va0, va1,
                    flash_cross.EXACT if shift is None else flash_cross.SHIFT,
                    0.125 * (1.0 if shift is None else flash.LOG2E),
                    0.0 if shift is None else shift * flash.LOG2E, splits)
            got = run()
            same(f"{name} {label}", got, run())
            ref = flash_cross.fused_cross_attention_plain(
                qk0, qk1, v0, v1, va0, va1, shift)
            note(name, f"{name} {label}",
                 max(max_err(got[0], ref[0], rows(va0) if shift is None
                             else None), max_err(got[1], ref[1])))
        q0, q1 = qk0 * 64 ** -0.25, qk1 * 64 ** -0.25
        run = lambda: flash_cross.launch_cross(  # noqa
            q0, q1, v0, v1, va0, va1, flash_cross.EXACT_BLOCK, 1.0,
            splits=splits)
        got = run()
        same(f"B6 attention {label}", got, run())
        ref = flash_cross_block.cross_block_attention_plain(q0, q1, v0, v1,
                                                            va0, va1)
        note("fused_cross_block", f"B6 attention (mode 1) {label}, valid rows",
             max(max_err(got[0], ref[0], rows(va0)),
                 max_err(got[1], ref[1], rows(va1))))

    def mask(b, n, empty):
        m = torch.rand(b, n, generator=g, device="cuda") < 0.85
        m[:, 0] = True
        if empty:
            m[1] = False
        return m

    for b, m, n in ((1, 1024, 768), (4, 1024, 768), (16, 1024, 768),
                    (2, 1000, 700)):
        qk0, v0 = rand(g, b, 4, m, 64), rand(g, b, 4, m, 64)
        qk1, v1 = rand(g, b, 4, n, 64), rand(g, b, 4, n, 64)
        cases = [("unmasked", None, None),
                 ("masked", mask(b, m, False), mask(b, n, False))]
        if b > 1:
            cases += [("image 0 of entry 1 all masked", mask(b, m, True),
                       mask(b, n, False)),
                      ("image 1 of entry 1 all masked", mask(b, m, False),
                       mask(b, n, True))]
        print(f"  B {b}, M {m} / N {n}: splits (row, column walks) "
              f"{flash_cross.cross_splits(qk0.device, b, 4, m, n, 0)} exact, "
              f"{flash_cross.cross_splits(qk0.device, b, 4, m, n, 2)} shift")
        for case, va0, va1 in cases:
            modes(qk0, qk1, v0, v1, va0, va1, f"B {b}, M {m} / N {n}, {case}")
    # every split count either walk can take at B 1 (12 and 16 key tiles)
    b, m, n = 1, 1024, 768
    qk0, v0 = rand(g, b, 4, m, 64), rand(g, b, 4, m, 64)
    qk1, v1 = rand(g, b, 4, n, 64), rand(g, b, 4, n, 64)
    va0, va1 = mask(b, m, False), mask(b, n, False)
    for s in range(1, flash.MAX_SPLITS + 1):
        modes(qk0, qk1, v0, v1, va0, va1, f"B 1 masked, splits ({s}, {s})",
              (s, s))

    rng = np.random.default_rng(22)
    errs["fused_filter_matches"] = 0.0
    for b, m, n in ((1, 1024, 1024), (4, 1024, 1024), (16, 1024, 1024),
                    (4, 1024, 768), (2, 1000, 700)):
        tile = af.tile_plan(b, m, n, block_tc.sms(0))
        errs["fused_filter_matches"] = max(
            errs["fused_filter_matches"],
            b2_check(f"B {b}, {m} x {n}, D 256, tile "
                     f"{block_tc.TILES[tile]}", b2_inputs(rng, g, b, m, n)))
    torch.cuda.synchronize()
    return errs


def edge_phase():
    """Tiny and ragged shapes: single rows, partial tiles, D 128."""
    g = torch.Generator(device="cuda").manual_seed(2)
    errs = dict.fromkeys(KERNELS, 0.0)

    def mask(b, n):
        m = torch.rand(b, n, generator=g, device="cuda") < 0.7
        m[:, 0] = True
        return m

    for nq, nk in ((1, 1), (65, 63), (3, 130)):
        q, k, v = rand(g, 2, 1, nq, 64), rand(g, 2, 1, nk, 64), rand(g, 2, 1, nk, 64)
        valid = mask(2, nk)
        errs["flash_sdpa"] = max(errs["flash_sdpa"], max_err(
            flash.flash_sdpa(q, k, v, valid), flash.flash_sdpa_plain(q, k, v, valid)))
    for m, n in ((1, 1), (65, 130), (130, 3)):
        qk0, v0 = rand(g, 1, 2, m, 64), rand(g, 1, 2, m, 64)
        qk1, v1 = rand(g, 1, 2, n, 64), rand(g, 1, 2, n, 64)
        va0, va1 = mask(1, m), mask(1, n)
        got = flash_cross.fused_cross_attention(qk0, qk1, v0, v1, va0, va1)
        ref = flash_cross.fused_cross_attention_plain(qk0, qk1, v0, v1, va0, va1)
        rows0 = va0[:, None, :].expand(-1, 2, -1)
        errs["fused_cross_attention"] = max(
            errs["fused_cross_attention"], max_err(got[0], ref[0], rows0),
            max_err(got[1], ref[1]))
    for d, rows in ((256, 1), (128, 33)):
        x, msg = rand(g, 1, rows, d), rand(g, 1, rows, d)
        p = {"lin1": {"w": rand(g, 2 * d, 2 * d) / (2 * d) ** 0.5,
                      "b": rand(g, 2 * d) * 0.1},
             "ln": {"scale": 1 + rand(g, 2 * d) * 0.1, "bias": rand(g, 2 * d) * 0.1},
             "lin2": {"w": rand(g, 2 * d, d) / (2 * d) ** 0.5, "b": rand(g, d) * 0.1}}
        errs["fused_ffn_residual"] = max(errs["fused_ffn_residual"], max_err(
            ffn.fused_ffn_residual(x, msg, p), ffn.fused_ffn_residual_plain(x, msg, p)))
    for m, n, d in ((1, 1, 64), (65, 129, 64), (3, 70, 256)):
        d0, d1 = rand(g, 2, m, d) * 0.3, rand(g, 2, n, d) * 0.3
        ls0 = torch.nn.functional.logsigmoid(rand(g, 2, m))
        ls1 = torch.nn.functional.logsigmoid(rand(g, 2, n))
        mk0, mk1 = mask(2, m), mask(2, n)
        km0, kv0, km1, kv1 = af._filter_reductions_kernel(d0, d1, ls0, ls1, mk0, mk1)
        pm0, pv0, pm1, pv1 = af.filter_reductions_plain(d0, d1, ls0, ls1, mk0, mk1)
        if not (bool((km0.long() == pm0)[mk0].all())
                and bool((km1.long() == pm1)[mk1].all())):
            raise AssertionError(f"fused_filter_matches argmax at {(m, n, d)}")
        errs["fused_filter_matches"] = max(
            errs["fused_filter_matches"], max_err(kv0, pv0, mk0),
            max_err(kv1, pv1, mk1))
    # the matcher's kernels at 2048 keypoints, match_pair's default
    n = 2048
    q, k, v = rand(g, 1, 4, n, 64), rand(g, 1, 4, n, 64), rand(g, 1, 4, n, 64)
    valid = mask(1, n)
    errs["flash_sdpa"] = max(errs["flash_sdpa"], max_err(
        flash.flash_sdpa(q, k, v, valid), flash.flash_sdpa_plain(q, k, v, valid)))
    va0, va1 = mask(1, n), mask(1, n)
    got = flash_cross.fused_cross_attention(q, k, v, q, va0, va1)
    ref = flash_cross.fused_cross_attention_plain(q, k, v, q, va0, va1)
    errs["fused_cross_attention"] = max(
        errs["fused_cross_attention"],
        max_err(got[0], ref[0], va0[:, None, :].expand(-1, 4, -1)),
        max_err(got[1], ref[1]))
    x, msg, p = rand(g, 1, n, 256), rand(g, 1, n, 256), kernel_inputs_ffn(g)
    errs["fused_ffn_residual"] = max(errs["fused_ffn_residual"], max_err(
        ffn.fused_ffn_residual(x, msg, p), ffn.fused_ffn_residual_plain(x, msg, p)))
    d0, d1 = rand(g, 1, n, 256) * 0.2, rand(g, 1, n, 256) * 0.2
    ls0 = torch.nn.functional.logsigmoid(rand(g, 1, n))
    ls1 = torch.nn.functional.logsigmoid(rand(g, 1, n))
    km0, kv0, km1, kv1 = af._filter_reductions_kernel(d0, d1, ls0, ls1, va0, va1)
    pm0, pv0, pm1, pv1 = af.filter_reductions_plain(d0, d1, ls0, ls1, va0, va1)
    sure0, sure1 = k4_margin_rows(d0, d1, ls0, ls1, va0, va1)
    if not (bool((km0.long() == pm0)[sure0].all())
            and bool((km1.long() == pm1)[sure1].all())):
        raise AssertionError("fused_filter_matches argmax at 2048 keypoints")
    errs["fused_filter_matches"] = max(
        errs["fused_filter_matches"], max_err(kv0, pv0, va0),
        max_err(kv1, pv1, va1))
    print(f"  matcher kernels at {n} keypoints: done")

    # the extractor's kernels at tiny and ragged sizes (multiples of 8), and
    # at 12 x 52, whose half (6 x 26) has rows that are not 16-byte aligned
    params = superpoint_params()
    for h, w in ((8, 8), (24, 40), (72, 136), (12, 52)):
        img = torch.rand(2, 1, h, w, generator=g, device="cuda")
        e1, e2, e3 = conv_pair_errors(params, img)
        errs["fused_stem"] = max(errs["fused_stem"], e1)
        errs["fused_block2"] = max(errs["fused_block2"], e2, e3)
        print(f"  stem / block2 / conv2a at {h}x{w}: max_abs_err {e1:.3e} / "
              f"{e2:.3e} / {e3:.3e} (tol {CONV_TOL:g} x max(1, max|plain|)), "
              "each twice, equal to the bit")
    # B8 on an input one float past a 16-byte boundary: staged through an
    # aligned copy, equal to the bit to the same input aligned
    p2 = {"conv2a": params["conv2a"], "conv2b": params["conv2b"]}
    xa = torch.rand(2, 64, 24, 40, generator=g, device="cuda")
    buf = torch.empty(xa.numel() + 1, device="cuda")
    xu = buf[1:].view(xa.shape)
    xu.copy_(xa)
    if xu.data_ptr() % 16 != 4:
        raise AssertionError("the unaligned B8 input is aligned")
    for name, kern, plain, pp in (
            ("fused_block2", stem2.fused_block2, stem2.fused_block2_plain, p2),
            ("conv2a", stem2.conv3x3_relu, stem2.conv3x3_relu_plain,
             params["conv2a"])):
        got, ref = kern(pp, xu), plain(pp, xu)
        if not torch.equal(got, kern(pp, xa)):
            raise AssertionError(f"{name}: the unaligned input differs from "
                                 "the same input aligned")
        err = max_err(got, ref)
        bound = CONV_TOL * max(1.0, float(ref.abs().max()))
        if not err <= bound:
            raise AssertionError(f"{name} unaligned: {err} > {bound}")
        errs["fused_block2"] = max(errs["fused_block2"], err)
        print(f"  {name} at (2, 64, 24, 40), x 4 bytes past a 16-byte "
              f"boundary: max_abs_err {err:.3e} (tol {CONV_TOL:g} x max(1, "
              "max|plain|)), equal to the bit to the aligned input")
    for r in range(nms.MAX_RADIUS + 1):
        s = torch.rand(2, 61, 83, generator=g, device="cuda")
        s[0, 10:25, 20:50] = 0.75  # a plateau of tied scores
        s[0, 40, 40] = 1.0
        s[1] = -s[1]  # all negative
        s[1, 30:, :10] = -0.25
        nms_equal("61x83 edge map", s, r)
    print(f"  simple_nms at radii 0-{nms.MAX_RADIUS} (plateau, negative "
          "scores, 83 columns): equal to the bit")
    # the block kernels at D 128 (2 heads) and ragged lengths
    for shift in (None, SHIFT):
        for n, m in ((70, 130), (1, 65)):
            lin = lambda i, o: {"w": rand(g, i, o) / i ** 0.5, "b": rand(g, o) * 0.1}
            ffn_p = {"lin1": lin(256, 256), "ln": {"scale": 1 + rand(g, 256) * 0.1,
                                                   "bias": rand(g, 256) * 0.1},
                     "lin2": lin(256, 128)}
            w5 = flash_self.prepare({"Wqkv": lin(128, 384), "out_proj": lin(128, 128),
                                     "ffn": ffn_p}, 2, shift)
            w6 = flash_cross_block.prepare(
                {"to_qk": lin(128, 128), "to_v": lin(128, 128),
                 "to_out": lin(128, 128), "ffn": ffn_p}, 2, shift)
            x0, x1 = rand(g, 2, n, 128), rand(g, 2, m, 128)
            ang = torch.rand(2, 1, n, 32, generator=g, device="cuda") * 6
            enc = torch.stack([ang.cos(), ang.sin()])
            va0, va1 = mask(2, n), mask(2, m)
            errs["fused_self_block"] = max(errs.get("fused_self_block", 0.0), max_err(
                flash_self.fused_self_block(w5, x0, enc, va0),
                flash_self.fused_self_block_plain(w5, x0, enc, va0)))
            got = flash_cross_block.fused_cross_block(w6, x0, x1, va0, va1)
            ref = flash_cross_block.fused_cross_block_plain(w6, x0, x1, va0, va1)
            errs["fused_cross_block"] = max(
                errs.get("fused_cross_block", 0.0), max_err(got[0], ref[0], va0),
                max_err(got[1], ref[1], va1))
    for name in MATCHER_KERNELS + ("fused_self_block", "fused_cross_block"):
        check(f"{name} edge shapes", errs[name])
    torch.cuda.synchronize()
    return errs


def kernel_inputs_ffn(g):
    return {
        "lin1": {"w": rand(g, 512, 512) / 512**0.5, "b": rand(g, 512) * 0.1},
        "ln": {"scale": 1 + rand(g, 512) * 0.1, "bias": rand(g, 512) * 0.1},
        "lin2": {"w": rand(g, 512, 256) / 512**0.5, "b": rand(g, 256) * 0.1},
    }


def superpoint_params(device="cuda"):
    """SuperPoint at its published widths, seeded random weights with the
    conv weights times 3, the stand-in for the release weights (not in the
    repository; models.superpoint.init_params says why 3)."""
    params = sp.init_params(SuperPointConfig(), torch.Generator().manual_seed(0))
    return {k: {"w": v["w"].to(device) * 3.0, "b": v["b"].to(device)}
            for k, v in params.items()}


def conv_pair_errors(params, img):
    """(stem, block 2, conv2a alone) kernel-vs-plain max-abs errors, each
    checked against CONV_TOL * max(1, max |plain|) and launched twice (equal
    to the bit); block 2 and conv2a run on the plain stem's output."""
    p1 = {"conv1a": params["conv1a"], "conv1b": params["conv1b"]}
    p2 = {"conv2a": params["conv2a"], "conv2b": params["conv2b"]}
    x = stem.fused_stem_plain(p1, img)
    errs = []
    for name, kern, plain, p, inp in (
            ("fused_stem", stem.fused_stem, stem.fused_stem_plain, p1, img),
            ("fused_block2", stem2.fused_block2, stem2.fused_block2_plain, p2,
             x),
            ("conv2a", stem2.conv3x3_relu, stem2.conv3x3_relu_plain,
             params["conv2a"], x)):
        ref, got, again = plain(p, inp), kern(p, inp), kern(p, inp)
        err = max_err(got, ref)
        bound = CONV_TOL * max(1.0, float(ref.abs().max()))
        if not err <= bound:
            raise AssertionError(f"{name} at {tuple(inp.shape)}: {err} > {bound}")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} at {tuple(inp.shape)}: two launches "
                                 "differ")
        errs.append(err)
    return tuple(errs)


def nms_equal(label, scores, r):
    """B9 against its plain version, to the bit; returns the maxima kept."""
    got = nms.simple_nms_kernel(scores, r)
    want = nms.simple_nms_plain(scores, r)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"simple_nms {label} r {r} differs from its plain "
                             f"version at {int((got != want).sum())} pixels")
    return int((got > 0).sum())


def sp_kernel_phase(sp_params):
    """B7, B8 (and B8's conv2a launch alone) at B 1, 2 and 8 and B9 at the
    extraction path's shapes: 768 x 1024 images, block 2 on the stem's
    output, NMS (r 4) on their SuperPoint score maps at B 1, 2 and 8.
    Returns (errors, the B 2 inputs for timing)."""
    phase("2b extraction kernels against their plain versions")
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(np.stack([image_pair(rng, H, W)[0] for _ in range(8)])
                            ).cuda()[:, None]
    e_stem = e_b2 = 0.0
    for b in (2, 1, 8):
        e1, e2, e3 = conv_pair_errors(sp_params, imgs[:b])
        print(f"  B {b}: fused_stem ({b},1,{H},{W}) max_abs_err {e1:.3e}; "
              f"fused_block2 ({b},64,{H // 2},{W // 2}) {e2:.3e}; its conv2a "
              f"launch {e3:.3e} (tol {CONV_TOL:g} x max(1, max|plain|)); each "
              "twice, equal to the bit")
        e_stem, e_b2 = max(e_stem, e1), max(e_b2, e2, e3)
    img = imgs[:2]
    with torch.inference_mode():
        maps, _ = sp.dense_forward(sp_params, imgs.permute(0, 2, 3, 1))
    for b in (1, 2, 8):
        kept = nms_equal(f"B {b}", maps[:b].contiguous(), 4)
        print(f"  simple_nms ({b},{H},{W}) r 4 on SuperPoint's score maps: "
              f"equal to the plain version to the bit, {kept} maxima")
    scores = maps[:2].contiguous()
    p1 = {"conv1a": sp_params["conv1a"], "conv1b": sp_params["conv1b"]}
    torch.cuda.synchronize()
    return ({"fused_stem": e_stem, "fused_block2": e_b2, "simple_nms": 0.0},
            {"img": img, "stem_out": stem.fused_stem_plain(p1, img),
             "scores": scores})


def common_keypoints(fa, fb, tol=0.0):
    """(i, j) index pairs of valid keypoints of feats fa and fb (batch dims
    removed) that are each other's nearest valid keypoint and lie within
    tol px of each other (0: at the same location); one to one."""
    ia, ib = np.nonzero(fa["valid"])[0], np.nonzero(fb["valid"])[0]
    if not (len(ia) and len(ib)):
        return np.zeros((0, 2), np.int64)
    d = np.linalg.norm(fa["keypoints"][ia][:, None].astype(np.float32)
                       - fb["keypoints"][ib][None], axis=-1)
    near_b, near_a = d.argmin(1), d.argmin(0)
    rows = np.arange(len(ia))
    k = np.nonzero((near_a[near_b] == rows) & (d[rows, near_b] <= tol))[0]
    return np.stack([ia[k], ib[near_b[k]]], 1).astype(np.int64)


def check_pair_output(name, f0, f1, m, size0, size1):
    for f, (w, h) in ((f0, size0), (f1, size1)):
        k, v = f["keypoints"], f["valid"]
        if not (np.isfinite(k).all() and np.isfinite(f["descriptors"]).all()):
            raise AssertionError(f"{name}: keypoints or descriptors not finite")
        kv = k[v]
        if not ((kv >= -0.5).all() and (kv[:, 0] <= w - 0.5).all()
                and (kv[:, 1] <= h - 0.5).all()):
            raise AssertionError(f"{name}: a keypoint outside the image")
        norms = np.linalg.norm(f["descriptors"][v], axis=-1)
        if not np.allclose(norms, 1.0, atol=1e-4):
            raise AssertionError(f"{name}: descriptors not unit length")
        if v.sum() < MIN_KEYPOINTS:
            raise AssertionError(f"{name}: only {v.sum()} keypoints")
    m0, m1 = m["matches0"], m["matches1"]
    idx = np.nonzero(m0 >= 0)[0]
    if not (m1[m0[idx]] == idx).all() or not np.isfinite(
            m["matching_scores0"]).all():
        raise AssertionError(f"{name}: matches not mutual or scores not finite")
    if not (f0["valid"][idx].all() and f1["valid"][m0[idx]].all()):
        raise AssertionError(f"{name}: a match on an invalid keypoint")
    print(f"  {name}: {int(f0['valid'].sum())} + {int(f1['valid'].sum())} "
          f"keypoints, {len(idx)} matches, stop {m['stop']}")


def extraction_path_phase(mparams, sp_params):
    phase("3b main path: images -> SuperPoint -> LightGlue (match_pair, "
          "make_end_to_end), default configuration, 2048 keypoints")
    rng = np.random.default_rng(21)
    pairs = {
        f"{H}x{W}": image_pair(rng, H, W),
        "760x1000 (padded)": image_pair(rng, 760, 1000),
        f"{2 * H}x{2 * W} (2x area downscale)": image_pair(rng, 2 * H, 2 * W),
    }
    e2e_pairs = [pairs[f"{H}x{W}"]] + [image_pair(rng, H, W) for _ in range(3)]
    ext = SuperPoint(params=sp_params, device="cuda")
    matcher = LightGlue("superpoint", params=mparams, device="cuda")
    run = end_to_end.make_end_to_end(sp.forward, ext.params, ext.conf,
                                     matcher.params, matcher.conf)
    im0, im1 = (torch.from_numpy(np.stack([p[i] for p in e2e_pairs]))[..., None]
                .cuda() for i in (0, 1))
    sizes = torch.tensor([[W, H]] * 4, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    outs = {name: match_pair(ext, matcher, a, b)
            for name, (a, b, _) in pairs.items()}
    e2e = run(im0, im1, sizes, sizes)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"  launch counts: { {k: c for k, c in counts.items() if c} }")
    for kname in EXTRACTION_KERNELS:
        if counts[kname] < 1:
            raise AssertionError(f"{kname} was not launched on the main path")

    for name, (a, b, _) in pairs.items():
        check_pair_output(name, *outs[name], a.shape[::-1], b.shape[::-1])
    for i in range(4):
        f = [{"keypoints": getattr(e2e, f"feats{s}").keypoints[i].cpu().numpy(),
              "descriptors": getattr(e2e, f"feats{s}").descriptors[i].cpu().numpy(),
              "valid": getattr(e2e, f"feats{s}").valid[i].cpu().numpy()}
             for s in (0, 1)]
        m = {"matches0": e2e.matches.matches0[i].cpu().numpy(),
             "matches1": e2e.matches.matches1[i].cpu().numpy(),
             "matching_scores0": e2e.matches.matching_scores0[i].cpu().numpy(),
             "stop": e2e.matches.stop}
        check_pair_output(f"make_end_to_end B 4, pair {i}", *f, m, (W, H), (W, H))
        if i == 0:  # the same pair as match_pair's first, batched with others
            g0 = outs[f"{H}x{W}"][0]
            share = len(common_keypoints(g0, f[0])) / g0["valid"].sum()
            print(f"    keypoints shared with match_pair's: {share:.6f}")
            if share < 0.99:
                raise AssertionError("make_end_to_end and match_pair disagree")

    # the same pair through the CPU port (plain versions, oneDNN convs)
    a, b, _ = pairs[f"{H}x{W}"]
    cpu_ext = SuperPoint(params={k: {kk: vv.cpu() for kk, vv in v.items()}
                                 for k, v in sp_params.items()}, device="cpu")
    cpu_matcher = LightGlue("superpoint", params=mparams, device="cpu")
    cpu = match_pair(cpu_ext, cpu_matcher, a, b)
    gpu = outs[f"{H}x{W}"]
    shares, derr, common = [], 0.0, []
    for s in (0, 1):
        c = common_keypoints(gpu[s], cpu[s])
        common.append(c)
        shares.append(len(c) / gpu[s]["valid"].sum())
        derr = max(derr, float(np.abs(gpu[s]["descriptors"][c[:, 0]]
                                      - cpu[s]["descriptors"][c[:, 1]]).max()))
    differ = matches_differ(gpu, cpu, common)
    print(f"  against the CPU port: keypoints shared {shares[0]:.6f} / "
          f"{shares[1]:.6f}, descriptor max_abs_err at shared keypoints "
          f"{derr:.3e}, {int((gpu[2]['matches0'] >= 0).sum())} vs "
          f"{int((cpu[2]['matches0'] >= 0).sum())} matches, {differ} shared "
          f"keypoints whose match or prune differs, stop {gpu[2]['stop']} vs "
          f"{cpu[2]['stop']}")
    if (min(shares) < 0.99 or derr > 1e-3 or differ
            or gpu[2]["stop"] != cpu[2]["stop"]):
        raise AssertionError("the card disagrees with the CPU port")
    if torch.backends.cudnn.allow_tf32 is not True:
        raise AssertionError("the library changed cuDNN's global TF32 flag")

    # With random SuperPoint weights the descriptors are near-parallel and
    # the trained matcher finds nothing, so the same matcher also takes a
    # planted pair at match_pair's 2048 keypoints, where it must match
    planted_pair_check("LightGlue('superpoint')", matcher, cpu_matcher, 256)
    return counts


def two_head_pair_phase(params2, sp_params):
    """One match_pair from generated images with the two-head matcher
    (head_dim 128: B5 and B1', never B6 or K2), its matches held against
    the CPU port's matcher on the same features."""
    phase("3b main path: images -> SuperPoint -> LightGlue('superpoint', "
          "num_heads=2) (match_pair), 2048 keypoints")
    a, b, _ = image_pair(np.random.default_rng(22), H, W)
    ext = SuperPoint(params=sp_params, device="cuda")
    matcher = LightGlue("superpoint", params=params2, device="cuda", **TWO_HEADS)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    f0, f1, m = match_pair(ext, matcher, a, b)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"  launch counts: { {k: c for k, c in counts.items() if c} }")
    for kname in ("fused_stem", "fused_block2", "simple_nms") + HEAD128_KERNELS:
        if counts[kname] < 1:
            raise AssertionError(f"{kname} was not launched on the path")
    for kname in NOT_HEAD128:
        if counts[kname]:
            raise AssertionError(f"{kname} was launched on the path")
    check_pair_output(f"match_pair {H}x{W}, two heads", f0, f1, m,
                      (W, H), (W, H))
    cpu = LightGlue("superpoint", params=params2, device="cpu", **TWO_HEADS)(
        {"image0": {k: v[None] for k, v in f0.items()},
         "image1": {k: v[None] for k, v in f1.items()}})
    same = all(np.array_equal(m[f], cpu[f][0]) for f in
               ("matches0", "matches1", "prune0", "prune1"))
    print(f"  the CPU port's matcher on the same features: matches, prune "
          f"{'equal' if same else 'DIFFER'}, stop {m['stop']} vs {cpu['stop']}")
    if not same or m["stop"] != cpu["stop"]:
        raise AssertionError("two heads: the card disagrees with the CPU port")
    return counts


def gather_path_phase():
    """Phase 3d: the row-gather study at its shapes, through S1."""
    phase("3d main path: the row-gather study (lightglue_tpu_torch.scripts."
          "micro_gather2, seed 0)")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    micro_gather2.main(["--seed", "0", "--reps", "5"])
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"  launch counts: { {k: c for k, c in counts.items() if c} }")
    if counts["gather_rows"] < 1:
        raise AssertionError("gather_rows was not launched on the path")
    return counts


def planted_pair_check(label, matcher, cpu_matcher, desc_dim):
    """The matcher on a planted pair of desc_dim-d descriptors at 2048
    keypoints, where it must match: precision against the planted truth,
    and the same matches, prune and stop as the CPU port, with matching
    scores within MATCH_SCORE_TOL of its."""
    pr = planted_pairs(np.random.default_rng(23), 1, 2048, desc_dim=desc_dim)
    data = {"image0": feats(pr, 0), "image1": feats(pr, 1)}
    got, ref = matcher(data), cpu_matcher(data)
    k, prec = precision(got, pr["gt_matches0"])
    serr = max(float(np.abs(got[f] - ref[f]).max())
               for f in ("matching_scores0", "matching_scores1"))
    print(f"  {label}, planted pair at 2048 keypoints: {k} matches, precision "
          f"{prec:.3f}, stop {got['stop']} vs {ref['stop']} on the CPU port, "
          f"matching scores max_abs_err {serr:.3e} (tol {MATCH_SCORE_TOL:g})")
    if (prec < 0.8 or serr > MATCH_SCORE_TOL or got["stop"] != ref["stop"]
            or not all(np.array_equal(got[f], ref[f]) for f in
                       ("matches0", "matches1", "prune0", "prune1"))):
        raise AssertionError(f"{label}, planted pair: precision low or the "
                             "card disagrees with the CPU port")


def aliked_preset_params(mparams):
    """The "aliked" preset (input_dim 128; otherwise the superpoint
    preset's) from the trained synthetic matcher and an orthonormal
    128 -> 256 input_proj, which keeps the descriptors' dot products: the
    trained layers see planted 128-d pairs as they saw 256-d ones."""
    q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((256, 128)))
    return dict(mparams, input_proj={
        "w": torch.from_numpy(q.T.astype(np.float32).copy()),
        "b": torch.zeros(256)})


def two_head_params(params):
    """The trained 4 x 64 matcher as 2 x 128 heads (head_dim 128, the only
    configuration that reaches B1'): the packed Wqkv column of head h,
    channel j is (h hd + j) 3 + which, so both groupings use the same
    columns, and tiling the rotary frequencies [Wr | Wr] gives every
    channel pair its old frequency. Only the softmax grouping changes."""
    w = params["posenc"]["Wr"]["w"]
    return dict(params, posenc={"Wr": {"w": torch.cat([w, w], 1)}})


def matches_differ(gpu, cpu, common):
    """Number of keypoints shared by the card's and the CPU port's
    (feats0, feats1, matches) whose match or prune count differs: a match
    agrees when both sides have none or their partners are a shared pair
    (keypoints are paired by location, as the two sides may order
    near-equal scores differently)."""
    n = 0
    for s, o in ((0, 1), (1, 0)):
        other = {int(i): int(j) for i, j in common[o]}
        gm, cm = gpu[2][f"matches{s}"], cpu[2][f"matches{s}"]
        gp, cp = gpu[2][f"prune{s}"], cpu[2][f"prune{s}"]
        for i, j in common[s]:
            partner = -1 if gm[i] < 0 else other.get(int(gm[i]), -2)
            n += partner != int(cm[j]) or gp[i] != cp[j]
    return n


def feats(pairs, i):
    return {
        "keypoints": pairs[f"keypoints{i}"],
        "descriptors": pairs[f"descriptors{i}"],
        "image_size": pairs["image_size"],
    }


def precision(out, gt):
    """(number of matches, share of them that are planted pairs)."""
    m0 = out["matches0"]
    pred = m0 >= 0
    if not pred.any():
        return 0, 0.0
    return int(pred.sum()), float((m0[pred] == gt[pred]).mean())


def main_path_phase(params, params2):
    """Phase 3a: each matcher path of MATCHER_PATHS, fixed and adaptive
    (params2: the two-head regrouping, for the paths with two heads).
    Returns the launch counts summed over the paths."""
    total = dict.fromkeys(KERNELS, 0)
    for name, conf, n, kernels, must_not in MATCHER_PATHS:
        counts = matcher_path(params2 if conf.get("num_heads") == 2 else params,
                              f"{name}, {n} keypoints", conf, n, kernels,
                              must_not, seed=7)
        for k, c in counts.items():
            total[k] += c
    return total


def matcher_path(params, label, conf, n, kernels, must_not, seed):
    phase(f"3a main path: pipeline.LightGlue, trained weights, {label}")
    rng = np.random.default_rng(seed)
    singles = [planted_pairs(rng, 1, n) for _ in range(3)]
    singles.append(planted_pairs(rng, 1, n * 900 // 1024, n))  # unequal counts
    batch8 = planted_pairs(rng, 8, n)
    matchers = {
        "fixed": dict(conf, depth_confidence=-1.0, width_confidence=-1.0),
        "adaptive": conf,
    }
    gpu = {k: LightGlue("superpoint", params=params, device="cuda", **c)
           .compile((n // 2, n)) for k, c in matchers.items()}
    # an image without valid keypoints degrades to no matches, no NaN
    empty = {"image0": dict(feats(singles[0], 0), valid=np.zeros((1, n), bool)),
             "image1": feats(singles[0], 1)}
    for name, matcher in gpu.items():
        out = matcher(empty)
        if not ((out["matches0"] == -1).all() and (out["matches1"] == -1).all()
                and np.isfinite(out["matching_scores1"]).all()):
            raise AssertionError(f"{name}: an empty image 0 still matched")
    print("  image 0 without valid keypoints: no matches, finite scores")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    outs = {}
    for name, matcher in gpu.items():
        for i, pr in enumerate(singles):
            outs[name, i] = matcher({"image0": feats(pr, 0),
                                     "image1": feats(pr, 1)})
        outs[name, "b8"] = matcher({"image0": feats(batch8, 0),
                                    "image1": feats(batch8, 1)})
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"  launch counts: { {k: c for k, c in counts.items() if c} }")
    for kname in kernels:
        if counts[kname] < 1:
            raise AssertionError(f"{kname} was not launched on the path")
    for kname in must_not:
        if counts[kname]:
            raise AssertionError(f"{kname} was launched on the path")

    floor = MIN_PRECISION[conf.get("num_heads", 4)]
    for (name, i), out in outs.items():
        pr = batch8 if i == "b8" else singles[i]
        b, m = pr["gt_matches0"].shape
        nn_ = pr["keypoints1"].shape[1]
        if out["matches0"].shape != (b, m) or out["matches1"].shape != (b, nn_):
            raise AssertionError(f"{name} {i}: bad output shapes")
        for f in ("matching_scores0", "matching_scores1"):
            if not np.isfinite(out[f]).all():
                raise AssertionError(f"{name} {i}: {f} not finite")
        k, prec = precision(out, pr["gt_matches0"])
        print(f"  {name} pair {i}: {m}x{nn_} kpts, stop {out['stop']}, "
              f"{k} matches, precision {prec:.3f} against the planted truth")
        if prec < floor:  # a floor that catches wrong matches, not a target
            raise AssertionError(f"{name} {i}: precision {prec} < {floor}")

    data = {"image0": feats(singles[0], 0), "image1": feats(singles[0], 1)}
    for name, c in matchers.items():
        cpu = LightGlue("superpoint", params=params, device="cpu", **c)
        ref = cpu(data)
        got = outs[name, 0]
        agree = float((ref["matches0"] == got["matches0"]).mean())
        pruned = sum(int((ref[f] != got[f]).sum()) for f in ("prune0", "prune1"))
        print(f"  {name} pair 0 against the CPU port (plain versions): "
              f"matches0 agreement {agree:.6f}, stop {got['stop']} vs "
              f"{ref['stop']}, {pruned} points whose prune differs, score diff "
              f"{score_gap(got, ref):.2e}")
        if agree < 0.999 or ref["stop"] != got["stop"] or pruned:
            raise AssertionError(f"{name}: the card disagrees with the CPU port")
        if name == "fixed":
            path_kernel_trace(gpu[name], ref, data)
    return counts


def score_gap(got, ref):
    return max(float(np.abs(got[f] - ref[f]).max())
               for f in ("matching_scores0", "matching_scores1"))


def valid_rows_err(got, ref, valid):
    """Largest |got - ref| over the rows (B, n) that ``valid`` keeps (all
    when None) of (B, n) values or (B, H, n, d) messages; 0 if none."""
    d = (got.float() - ref.float()).abs()
    if d.dim() == 4:
        d = d.amax((1, 3))
    d = d if valid is None else d[valid]
    return float(d.max()) if d.numel() else 0.0


def path_kernel_trace(matcher, ref, data):
    """One call of ``matcher`` on ``data`` with every K2 launch
    (``launch_cross``: B3, B3s and B6's attention), every B2 launch and
    every walk of K1 (inside B5 or alone, head_dim 64 or 128) and B1'
    (``launch_attention``) held against its plain version in float64 on
    the inputs the path produces (valid rows; the fp32 plain version's own
    gap printed beside it; B2's argmax against the fp32 plain one on the
    rows and columns with a clear top-two gap). Then the
    same call with K2, B2 or both swapped for their plain versions on the
    card, each beside the CPU port's matching scores ``ref``: how much of
    the path's gap to the CPU port each kernel brings. Launches here are
    not counted: the path's counts are read before."""
    cross, assign = flash_cross.launch_cross, af._filter_reductions_kernel
    attn = flash.launch_attention
    errs = {"K2": [], "B2": [], "K1 d 64": [], "K1 d 128": [], "B1'": []}
    f64 = lambda *x: [t.double() if torch.is_tensor(t) and t.is_floating_point()
                      else t for t in x]  # noqa: E731

    def cross_checked(qk0, qk1, v0, v1, valid0, valid1, mode, scale,
                      shift2=0.0, splits=None):
        out = cross(qk0, qk1, v0, v1, valid0, valid1, mode, scale, shift2,
                    splits)
        x = (qk0, qk1, v0, v1, valid0, valid1, mode, scale, shift2)
        plain = flash_cross.cross_launches_plain(*x)
        ref = flash_cross.cross_launches_plain(*f64(*x))
        errs["K2"].append(tuple(
            max(valid_rows_err(a[0], ref[0], valid0),
                valid_rows_err(a[1], ref[1], valid1)) for a in (out, plain)))
        return out

    def assign_checked(mdesc0, mdesc1, ls0, ls1, mask0, mask1):
        out = assign(mdesc0, mdesc1, ls0, ls1, mask0, mask1)
        x = (mdesc0, mdesc1, ls0, ls1, mask0, mask1)
        plain = af.filter_reductions_plain(*x)
        ref = af.filter_reductions_plain(*f64(*x))
        va0, va1 = (torch.ones(v.shape, dtype=torch.bool, device=v.device)
                    if m is None else m
                    for m, v in ((mask0, out[1]), (mask1, out[3])))
        keep0, keep1 = k4_margin_rows(mdesc0, mdesc1, ls0, ls1, va0, va1)
        if not (torch.equal(out[0][keep0], plain[0][keep0])
                and torch.equal(out[2][keep1], plain[2][keep1])):
            raise AssertionError("B2 on the path: argmax differs from the "
                                 "plain version on a row with a clear gap")
        errs["B2"].append(tuple(
            max(valid_rows_err(a[1], ref[1], va0),
                valid_rows_err(a[3], ref[3], va1)) for a in (out, plain)))
        return out

    def attn_checked(dev, walks, scale, shift2, splits=None):
        attn(dev, walks, scale, shift2, splits)
        kind = "B1'" if len(walks) == 2 else f"K1 d {walks[0][0].shape[-1]}"
        # B1' walk 0 queries image 0, whose keys are walk 1's
        qvalid = ([walks[1][3], walks[0][3]] if len(walks) == 2
                  else [walks[0][3]])
        e = [0.0, 0.0]
        for (q, k, v, valid, out), qv in zip(walks, qvalid):
            x = (q, k, v, valid, scale, shift2)
            ref = walk_sums.walk_plain(*f64(*x))
            e[0] = max(e[0], valid_rows_err(out, ref, qv))
            e[1] = max(e[1], valid_rows_err(walk_sums.walk_plain(*x), ref, qv))
        errs[kind].append(tuple(e))

    def plain_cross(qk0, qk1, v0, v1, valid0, valid1, mode, scale, shift2=0.0,
                    splits=None):
        return flash_cross.cross_launches_plain(qk0, qk1, v0, v1, valid0,
                                                valid1, mode, scale, shift2)

    def run(k2, b2, walk=attn):
        saved = (flash_cross.launch_cross, flash_cross_block.launch_cross,
                 af._filter_reductions_kernel, flash.launch_attention,
                 flash_self.launch_attention)
        flash_cross.launch_cross = flash_cross_block.launch_cross = k2
        af._filter_reductions_kernel = b2
        flash.launch_attention = flash_self.launch_attention = walk
        try:
            return matcher(data)
        finally:
            (flash_cross.launch_cross, flash_cross_block.launch_cross,
             af._filter_reductions_kernel, flash.launch_attention,
             flash_self.launch_attention) = saved

    got = run(cross_checked, assign_checked, attn_checked)
    for k, e in errs.items():
        if e:
            check(f"{k} on the path against float64, {len(e)} launches (the "
                  f"fp32 plain version {max(p for _, p in e):.3e}), largest",
                  max(g for g, _ in e))
        else:
            print(f"  {k} on the path: no launch")
    gaps = [score_gap(run(*fns), ref) for fns in (
        (cross, assign), (plain_cross, assign),
        (cross, af.filter_reductions_plain),
        (plain_cross, af.filter_reductions_plain))]
    print(f"  matching scores against the CPU port: the kernels "
          f"{score_gap(got, ref):.2e} (again {gaps[0]:.2e}), K2 plain "
          f"{gaps[1]:.2e}, B2 plain {gaps[2]:.2e}, both plain {gaps[3]:.2e}",
          flush=True)


def aliked_params(model_name="aliked-n16", device="cuda"):
    """ALIKED at its published widths with seeded random weights, the
    stand-in for the release weights (not in the repository):
    lightglue_tpu_torch.scripts.extract_times.aliked_params says how they
    are drawn and scaled (tests/test_torch_aliked.py uses the same gains)."""
    return extract_times.aliked_params(model_name, device)


def rgb(gray):
    """(H, W) in [0, 1] -> (H, W, 3) with three distinct channels."""
    return np.stack([gray, np.sqrt(gray), gray * gray], -1).astype(np.float32)


def stem_errors(label, p, img):
    """B10 against its plain version: max-abs errors of y1 and x1p, each
    checked against CONV_TOL * max(1, max |plain|), and a second launch
    equal to the first to the bit."""
    got = aliked_stem.fused_aliked_stem_kernel(p, img)
    again = aliked_stem.fused_aliked_stem_kernel(p, img)
    ref = aliked_stem.fused_aliked_stem_plain(p, img)
    errs = []
    for name, g, a, r in zip(("y1", "x1p"), got, again, ref):
        err = max_err(g, r)
        bound = CONV_TOL * max(1.0, float(r.abs().max()))
        if not err <= bound:
            raise AssertionError(f"fused_aliked_stem {name} {label}: {err} > {bound}")
        if not torch.equal(g, a):
            raise AssertionError(f"fused_aliked_stem {name} {label}: two "
                                 "launches differ")
        errs.append(err)
    return max(errs)


def score_errors(label, sh, parts):
    """B11 on the four branch parts and B12 on their upsampled sum, each
    against its plain version (SCORE_TOL), each launched twice and equal to
    the bit."""
    s0 = score_head.upsampled_sum(*parts)
    errs = []
    for name, kern, plain in (
            ("score_head_lazy", lambda: score_head.score_head_lazy_kernel(sh, *parts),
             lambda: score_head.score_head_lazy_plain(sh, *parts)),
            ("score_head_cplane", lambda: score_head.score_head_cplane_kernel(sh, s0),
             lambda: score_head.score_tail_plain(sh, s0))):
        got, again = kern(), kern()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {label}: two launches differ")
        errs.append(check(f"{name} {label} (twice, equal to the bit)",
                          max_err(got, plain()), SCORE_TOL))
    return tuple(errs)


def aliked_kernel_phase(ap):
    """B10 (aliked-n16 and aliked-t16 at B 1, 2 and 8), B11, B12 at the
    ALIKED path's shapes (RGB 768 x 1024 images; the score head on the
    branch parts of 1, 2 and 8 images), B9 at r 2 on two images' score
    maps, then at edge shapes: a branch dimension of 1 (H or W 32), ragged
    tiles, aliked-t16 widths. Returns (errors, the inputs for timing)."""
    phase("2d ALIKED kernels against their plain versions")
    rng = np.random.default_rng(41)
    imgs = torch.from_numpy(np.stack([rgb(image_pair(rng, H, W)[0])
                                      for _ in range(8)])).cuda()
    imgs = imgs.permute(0, 3, 1, 2).contiguous()
    img = imgs[:2]
    stem_p = {"block1": ap["block1"], "conv1": ap["conv1"]}
    t16 = aliked_params("aliked-t16")
    e_stem = 0.0
    for name, p in (("aliked-n16", stem_p),
                    ("aliked-t16", {"block1": t16["block1"], "conv1": t16["conv1"]})):
        for b in (2, 1, 8):
            e = stem_errors(f"{name} ({b}, 3, {H}, {W})", p, imgs[:b])
            e_stem = max(e_stem, e)
            print(f"  fused_aliked_stem {name} ({b}, 3, {H}, {W}): max_abs_err "
                  f"{e:.3e} (tol {CONV_TOL:g} x max(1, max|plain|)), twice, "
                  "equal to the bit", flush=True)
    with torch.inference_mode():
        ys, smap = al._dense_branches(ap, imgs, fused_score=False, fused_stem=False)
        parts8 = al._score_parts(ap["score_head"], ys, True)
    parts = [p[:2].contiguous() for p in parts8]
    smap = smap[:2].contiguous()
    kept = nms_equal("on ALIKED's score maps", smap, 2)
    print(f"  simple_nms (2,{H},{W}) r 2 on ALIKED's score maps: equal to the "
          f"plain version to the bit, {kept} maxima")
    sh = ap["score_head"]
    e_lazy, e_cplane = score_errors(f"(2, 8, {H}, {W}) from those images",
                                    sh, parts)
    for b in (1, 8):
        el, ec = score_errors(f"({b}, 8, {H}, {W})", sh,
                              [p[:b].contiguous() for p in parts8])
        e_lazy, e_cplane = max(e_lazy, el), max(e_cplane, ec)
    dev = torch.device("cuda")
    print(f"  score_head blocks an SM: {score_head.blocks_per_sm(True, dev)} "
          f"(B11), {score_head.blocks_per_sm(False, dev)} (B12)", flush=True)
    g = torch.Generator(device="cuda").manual_seed(6)
    for name, p in (("aliked-n16", ap), ("aliked-t16", t16)):
        for b, h, w in ((1, 32, 96), (2, 64, 96), (1, 96, 32), (1, 40, 72)):
            x = torch.rand(b, 3, h, w, generator=g, device="cuda")
            e_stem = max(e_stem, stem_errors(
                f"{name} {(b, h, w)}", {"block1": p["block1"], "conv1": p["conv1"]}, x))
    print("  fused_aliked_stem aliked-n16 and aliked-t16 at 32x96, 64x96, "
          f"96x32, 40x72 (twice, equal to the bit): max_abs_err over all "
          f"{e_stem:.3e}")
    for b, h, w in ((1, 32, 96), (2, 64, 96), (1, 96, 32), (1, 32, 32)):
        edge = [torch.randn(b, 8, max(1, h // f), max(1, w // f), generator=g,
                            device="cuda") for f in (1, 2, 8, 32)]
        el, ec = score_errors(f"{(b, h, w)} (branch dims {tuple(edge[3].shape[2:])})",
                              sh, edge)
        e_lazy, e_cplane = max(e_lazy, el), max(e_cplane, ec)
    torch.cuda.synchronize()
    return ({"fused_aliked_stem": e_stem, "score_head_lazy": e_lazy,
             "score_head_cplane": e_cplane},
            {"img": img, "stem_p": stem_p, "parts": parts, "smap": smap,
             "s0": score_head.upsampled_sum(*parts), "parts8": parts8})


def aliked_path_phase(ap, mparams):
    """Phase 3c: images -> ALIKED -> LightGlue("aliked") in the three
    extractor configurations of ALIKED_PATHS; the matcher at the "aliked"
    preset's full width with seeded random weights (the trained one is not
    in the repository), as the JAX bench runs it; then that preset built
    from mparams on a planted pair. Returns the launch counts summed over
    the three configurations."""
    rng = np.random.default_rng(43)
    pairs = [image_pair(rng, H, W) for _ in range(4)]
    views = [(rgb(a), rgb(b)) for a, b, _ in pairs]
    matcher = LightGlue("aliked", device="cuda")
    cpu_matcher = LightGlue("aliked", device="cpu")
    cpu_params = nn.params_to(ap, "cpu")
    total = dict.fromkeys(KERNELS, 0)
    for label, cfg, must, must_not in ALIKED_PATHS:
        phase(f"3c main path: images -> ALIKED ({label}) -> LightGlue('aliked'): "
              "match_pair at 2048 keypoints, make_end_to_end at 1024")
        bsz = 2 if cfg.get("lazy_fm") is False else 4  # the dense map: 400 MB/image
        ext = ALIKED(params=ap, device="cuda", **cfg)
        run = end_to_end.make_end_to_end(
            al.forward, ext.params, ext.conf.replace(max_num_keypoints=1024),
            matcher.params, matcher.conf)
        im0, im1 = (torch.from_numpy(np.stack([v[i] for v in views[:bsz]])).cuda()
                    for i in (0, 1))
        sizes = torch.tensor([[W, H]] * bsz, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        outs = [match_pair(ext, matcher, a, b) for a, b in views[:2]]
        e2e = run(im0, im1, sizes, sizes)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        print(f"  launch counts: { {k: c for k, c in counts.items() if c} }")
        for k in must + ALIKED_MATCHER_KERNELS:
            if counts[k] < 1:
                raise AssertionError(f"{label}: {k} was not launched")
        for k in must_not + ("fused_stem", "fused_block2"):
            if counts[k]:
                raise AssertionError(f"{label}: {k} was launched")
        for k, c in counts.items():
            total[k] += c

        for i, out in enumerate(outs):
            check_pair_output(f"match_pair pair {i}", *out, (W, H), (W, H))
        for i in range(bsz):
            f = [{"keypoints": getattr(e2e, f"feats{s}").keypoints[i].cpu().numpy(),
                  "descriptors": getattr(e2e, f"feats{s}").descriptors[i].cpu().numpy(),
                  "valid": getattr(e2e, f"feats{s}").valid[i].cpu().numpy()}
                 for s in (0, 1)]
            m = {"matches0": e2e.matches.matches0[i].cpu().numpy(),
                 "matches1": e2e.matches.matches1[i].cpu().numpy(),
                 "matching_scores0": e2e.matches.matching_scores0[i].cpu().numpy(),
                 "stop": e2e.matches.stop}
            check_pair_output(f"make_end_to_end B {bsz}, pair {i}", *f, m, (W, H), (W, H))

        # pair 0 through the CPU port (plain versions, oneDNN convs)
        cpu = match_pair(ALIKED(params=cpu_params, device="cpu", **cfg),
                         cpu_matcher, *views[0])
        gpu = outs[0]
        shares, derr, common = [], 0.0, []
        for s in (0, 1):
            c = common_keypoints(gpu[s], cpu[s], KPT_TOL)
            common.append(c)
            shares.append(len(c) / gpu[s]["valid"].sum())
            derr = max(derr, float(np.abs(gpu[s]["descriptors"][c[:, 0]]
                                          - cpu[s]["descriptors"][c[:, 1]]).max()))
        differ = matches_differ(gpu, cpu, common)
        print(f"  against the CPU port: keypoints shared within {KPT_TOL} px "
              f"{shares[0]:.6f} / {shares[1]:.6f}, descriptor max_abs_err at "
              f"them {derr:.3e}, {int((gpu[2]['matches0'] >= 0).sum())} vs "
              f"{int((cpu[2]['matches0'] >= 0).sum())} matches, {differ} shared "
              f"keypoints whose match or prune differs, stop {gpu[2]['stop']} "
              f"vs {cpu[2]['stop']}")
        if (min(shares) < 0.99 or derr > 1e-3 or differ
                or gpu[2]["stop"] != cpu[2]["stop"]):
            raise AssertionError(f"{label}: the card disagrees with the CPU port")
    if torch.backends.cudnn.allow_tf32 is not True:
        raise AssertionError("the library changed cuDNN's global TF32 flag")

    # The random matcher finds no match between random-weight ALIKED views
    # (nine random layers collapse the descriptors to one direction), so
    # the "aliked" preset also takes a planted pair of 128-d descriptors,
    # built from the trained weights, through input_proj on the card
    trained = aliked_preset_params(mparams)
    planted_pair_check("LightGlue('aliked'), trained layers", LightGlue(
        "aliked", params=trained, device="cuda"), LightGlue(
        "aliked", params=trained, device="cpu"), 128)
    return total


# --- phase 3g: DISK and SIFT --------------------------------------------------------

SIFT_WEIGHTS = os.path.join(ROOT, "weights", "synthetic_sift_lightglue.npz")
# The matcher's kernels by keypoint count at the default configuration
# (kernels it must launch, kernels it must not): up to 1024 B5 and B6; to
# 2048 B5 and the composed cross block (K2 + B4); above, the composed self
# block too (K1 + B4). B2 on every path.
MATCHER_BY_KPTS = {
    1024: (("fused_self_block", "fused_cross_block", "fused_filter_matches"),
           ("fused_cross_attention", "fused_ffn_residual", "flash_sdpa")),
    2048: (("fused_self_block", "fused_cross_attention", "fused_ffn_residual",
            "fused_filter_matches"), ("fused_cross_block", "flash_sdpa")),
    4096: (("flash_sdpa", "fused_cross_attention", "fused_ffn_residual",
            "fused_filter_matches"), ("fused_self_block", "fused_cross_block")),
}
# every extractor kernel: DISK and SIFT launch none of them
EXTRACTOR_KERNELS = ("fused_stem", "fused_block2", "simple_nms",
                     "fused_aliked_stem", "score_head_lazy", "score_head_cplane")
# DISK at mp against the CPU port at mp (phase 3g): a bf16 U-Net of nine
# blocks whose instance norms carry a conv's one-step flips on, so the
# keypoints in common are held at a floor (the port against the JAX
# package at mp: 0.93 at 96 x 128, tests/test_torch_disk.py) and above the
# share in common with the card's fp32 extraction, as phase 5f holds
# SuperPoint and ALIKED
MP_DISK_KPT = 0.85
# SIFT's trained matcher on SIFT's own features of a pair related by a
# known homography: a match is right within 3 px of the warped keypoint
# (the CPU port: 0.985-0.986 of 68-74 matches at 768 x 1024)
SIFT_PRECISION, SIFT_PX = 0.8, 3.0
# SIFTDevice on the card against the CPU port: the card blurs by fp32
# convolutions, the CPU by XLA's fused tap chain (an ulp or two apart a
# blur, tests/test_torch_sift.py), so the pyramids are held within
# SIFT_PYR_TOL of the plane's largest value, and a slot pairs with the
# other side's within KPT_TOL of the keypoint's scale (OpenCV's size: an
# octave's offsets scale with it) and SIFT_ORI_TOL rad (a point with two
# orientation peaks is two slots at one location). Those ulps decide a few
# orientation peaks (the 0.8 ratio) otherwise: the two blur forms on the
# CPU at 384 x 512 share 0.998-1.000 of 1024 slots, every other slot
# another orientation of a shared point. A point one side lacks lies
# within SIFT_MARGIN (relative) of the top-k's cut or the contrast
# threshold. A descriptor sample on a rounding edge moves a pixel: the
# card's RootSIFT descriptors lie up to 1.8e-2 from the CPU port's in L2
# (99th percentile 3.1e-3; H100, 768 x 1024), held at SIFT_DESC_TOL (unit
# descriptors: a wrong one lies about 1 away).
SIFT_PYR_TOL, SIFT_ORI_TOL, SIFT_SHARE, SIFT_MARGIN = 1e-5, 1e-3, 0.99, 1e-3
SIFT_DESC_TOL = 0.05


def matcher_kernels(n, mp=False):
    """(must, must not) of MATCHER_BY_KPTS at n keypoints, in the bf16
    forms under mp (B2 stays fp32; no fp32 block kernel then)."""
    must, must_not = MATCHER_BY_KPTS[n]
    if not mp:
        return must, must_not + tuple(f"{k}_bf16" for k in must + must_not
                                      if k != "fused_filter_matches")
    bf = lambda ks: tuple(k if k == "fused_filter_matches" else f"{k}_bf16"  # noqa: E731
                          for k in ks)
    return bf(must), bf(must_not) + FP32_MATCHER


def counted(label, fn, must, must_not):
    """fn() with the launch counts set to 0 just before it and read just
    after: each of must launched, none of must_not nor of the extractor
    kernels (in either form). Returns (fn's result, the counts)."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"  {label}: launch counts { {k: c for k, c in counts.items() if c} }",
          flush=True)
    for k in must:
        if counts[k] < 1:
            raise AssertionError(f"{label}: {k} was not launched")
    for k in must_not + EXTRACTOR_KERNELS + tuple(
            f"{k}_bf16" for k in EXTRACTOR_KERNELS if f"{k}_bf16" in counts):
        if counts.get(k):
            raise AssertionError(f"{label}: {k} was launched")
    return out, counts


def add_counts(total, counts):
    for k, c in counts.items():
        total[k] += c


def disk_params(device="cuda"):
    """DISK at its published widths with seeded random weights, the
    stand-in for the release checkpoint (not in the repository): the
    init's own scale, as its instance norms keep the activations at unit
    scale and the heatmap spread (about -3.5 to 4)."""
    return nn.params_to(disk.init_params(DISKConfig(),
                                         torch.Generator().manual_seed(0)), device)


def disk_margins(label, dp, conf, img):
    """The keypoints that the card's DISK keeps and the CPU port's does
    not, or the reverse, on one image: none clears both margins (the
    top-k's cut, the window's runner-up) by more than 4 steps of its score
    (bf16 steps of the heatmap; scripts/keypoint_margins.py)."""
    maps = []
    for dev, p in (("cuda", dp), ("cpu", nn.params_to(dp, "cpu"))):
        x = torch.from_numpy(np.repeat(img[None, ..., None], 3, -1)).to(dev)
        x = x.permute(0, 3, 1, 2).contiguous()
        if conf.mp:
            x = x.to(BF16)
        with torch.inference_mode(), nn.fp32_convs():
            heat = disk.heatmap(p, disk.unet_trunk(p, x), conf.desc_dim).cpu()
        maps.append((heat, disk.detection_map(heat, conf), km.ulp(heat)))
    m = km.unshared_margins(maps[0], maps[1], conf.max_num_keypoints,
                            conf.detection_threshold, conf.nms_window_size // 2)
    print(f"  {label}, card against the CPU port: {km.summary(m)}", flush=True)
    if km.faults(m["a"]) or km.faults(m["b"]):
        raise AssertionError(f"{label}: a keypoint differs by more than 4 steps")


def disk_path_phase(mparams):
    """Phase 3g, DISK: images -> DISK -> LightGlue("disk") in fp32 and at mp
    through match_pair (2048 keypoints: B5, K2 + B4, B2) and
    make_end_to_end (B 4, 1024: B5, B6, B2), each path's launch counts
    read on their own; one pair against the CPU port (fp32: keypoints in
    common >= 0.99, descriptors within 1e-3, matches, prune and stop
    equal; mp: phase 5f's rule, floor MP_DISK_KPT) and every keypoint the
    two do not share a near-tie; then the "disk" preset built from the
    trained matcher on a planted pair. Returns the counts summed."""
    rng = np.random.default_rng(81)
    pairs = [image_pair(rng, H, W) for _ in range(4)]
    dp = disk_params()
    cpu_dp = nn.params_to(dp, "cpu")
    sizes = torch.tensor([[W, H]] * 4, dtype=torch.float32, device="cuda")
    im0, im1 = (torch.from_numpy(np.stack([p[i] for p in pairs]))[..., None]
                .cuda() for i in (0, 1))
    total = dict.fromkeys(KERNELS, 0)
    fp32_out = None
    for mp in (False, True):
        tag = " at mp" if mp else ""
        phase(f"3g main path: images -> DISK{tag} -> LightGlue('disk'{tag}): "
              "match_pair at 2048 keypoints, make_end_to_end B 4 at 1024")
        ext = DISK(params=dp, device="cuda", mp=mp)
        matcher = LightGlue("disk", device="cuda", mp=mp)
        outs, counts = counted(f"match_pair{tag}", lambda: [
            match_pair(ext, matcher, a, b) for a, b, _ in pairs[:2]],
            *matcher_kernels(2048, mp))
        add_counts(total, counts)
        run = end_to_end.make_end_to_end(
            disk.forward, ext.params, ext.conf.replace(max_num_keypoints=1024),
            matcher.params, matcher.conf)
        e2e, counts = counted(f"make_end_to_end B 4{tag}",
                              lambda: run(im0, im1, sizes, sizes),
                              *matcher_kernels(1024, mp))
        add_counts(total, counts)
        for i, out in enumerate(outs):
            check_pair_output(f"DISK{tag} match_pair pair {i}", *out, (W, H), (W, H))
        for i in range(4):
            check_pair_output(f"DISK{tag} make_end_to_end B 4, pair {i}",
                              *e2e_feats(e2e, i), (W, H), (W, H))
        a, b, _ = pairs[0]
        cpu = match_pair(DISK(params=cpu_dp, device="cpu", mp=mp),
                         LightGlue("disk", device="cpu", mp=mp), a, b)
        gpu = outs[0]
        if mp:
            mp_agree("DISK", gpu, cpu, fp32_out, 0.0, MP_DISK_KPT)
            disk_margins(f"DISK{tag}", dp, ext.conf, a)
        else:
            fp32_out = gpu
            shares, derr, common = [], 0.0, []
            for s in (0, 1):
                c = common_keypoints(gpu[s], cpu[s])
                common.append(c)
                shares.append(len(c) / gpu[s]["valid"].sum())
                derr = max(derr, float(np.abs(gpu[s]["descriptors"][c[:, 0]]
                                              - cpu[s]["descriptors"][c[:, 1]]).max()))
            differ = matches_differ(gpu, cpu, common)
            print(f"  DISK against the CPU port: keypoints shared "
                  f"{shares[0]:.6f} / {shares[1]:.6f}, descriptor max_abs_err "
                  f"at them {derr:.3e}, {differ} shared keypoints whose match "
                  f"or prune differs, stop {gpu[2]['stop']} vs {cpu[2]['stop']}")
            if (min(shares) < 0.99 or derr > 1e-3 or differ
                    or gpu[2]["stop"] != cpu[2]["stop"]):
                raise AssertionError("DISK: the card disagrees with the CPU port")
    # the random "disk" matcher finds no match between random-weight DISK
    # views; the preset built from the trained layers on a planted pair
    trained = aliked_preset_params(mparams)
    planted_pair_check("LightGlue('disk'), trained layers", LightGlue(
        "disk", params=trained, device="cuda"), LightGlue(
        "disk", params=trained, device="cpu"), 128)
    return total


def sift_precision(f0, f1, m, hom):
    """(matches, share within SIFT_PX of the keypoint warped by hom)."""
    idx = np.nonzero(m["matches0"] >= 0)[0]
    if not len(idx):
        return 0, 0.0
    p = warp_points(hom, f0["keypoints"][idx].astype(np.float64))
    d = np.linalg.norm(p - f1["keypoints"][m["matches0"][idx]], axis=1)
    return len(idx), float((d < SIFT_PX).mean())


def sift_common(fa, fb):
    """(i, j) pairs of valid slots of feats fa and fb within KPT_TOL of the
    scale and SIFT_ORI_TOL rad of each other, one to one, the closest
    first (two candidates can refine to one point: equal slots)."""
    ia, ib = np.nonzero(fa["valid"])[0], np.nonzero(fb["valid"])[0]
    dk = np.linalg.norm(fa["keypoints"][ia][:, None] - fb["keypoints"][ib][None],
                        axis=-1) / np.maximum(fa["scales"][ia], 1.0)[:, None]
    do = np.abs(fa["oris"][ia][:, None] - fb["oris"][ib][None])
    do = np.minimum(do, 2 * np.pi - do)
    r, c = np.nonzero((dk <= KPT_TOL) & (do <= SIFT_ORI_TOL))
    used_a, used_b, out = set(), set(), []
    for k in np.argsort(dk[r, c] + do[r, c], kind="stable"):
        if r[k] not in used_a and c[k] not in used_b:
            used_a.add(r[k])
            used_b.add(c[k])
            out.append((ia[r[k]], ib[c[k]]))
    return np.array(out, np.int64).reshape(-1, 2)


def sift_lone(f, common_idx, other, conf):
    """The valid slots of feats f that the other side lacks: (their count,
    how many are another orientation of a point both sides have (a slot of
    the other side within KPT_TOL of the scale: an orientation peak or its
    interpolation decided otherwise), and for the rest, their margins to
    the other side's weakest kept score when it kept max_num_keypoints
    (the top-k's cut) or to the contrast threshold, relative, the least of
    the two)."""
    lone = np.setdiff1d(np.nonzero(f["valid"])[0], common_idx)
    kv = other["keypoints"][other["valid"]]
    dk = np.linalg.norm(f["keypoints"][lone][:, None] - kv[None], axis=-1)
    at_shared = (dk <= KPT_TOL * np.maximum(f["scales"][lone], 1.0)[:, None]
                 ).any(1) if len(kv) else np.zeros(len(lone), bool)
    score = f["keypoint_scores"][lone[~at_shared]]
    m = np.abs(score - conf.detection_threshold * 255.0
               / conf.num_scales_per_octave) / (
                   conf.detection_threshold * 255.0 / conf.num_scales_per_octave)
    if other["valid"].sum() == conf.max_num_keypoints:
        cut = other["keypoint_scores"][other["valid"]].min()
        m = np.minimum(m, np.abs(score - cut) / cut)
    return len(lone), int(at_shared.sum()), np.sort(m)


def sift_pyramid_err(img):
    """The largest difference between the card's and the CPU port's
    Gaussian layers of every octave of img, over each octave's largest
    value."""
    conf = SIFTConfig(backend="device")
    t = torch.from_numpy(img)
    g_gpu = sift_device.build_pyramid(t.cuda(), conf)[0]
    g_cpu = sift_device.build_pyramid(t, conf)[0]
    err = 0.0
    for a, b in zip(g_gpu, g_cpu):
        a, b = torch.stack(a).cpu(), torch.stack(b)
        err = max(err, float((a - b).abs().max() / b.abs().max()))
    return err


def sift_agree(gpu, cpu, conf):
    """SIFTDevice's pair on the card against the CPU port's: slots in
    common (sift_common) >= SIFT_SHARE of the card's on each image, their
    unit descriptors within SIFT_DESC_TOL of each other (L2; a sample on a
    rounding edge moves a pixel), matches0 equal on
    them >= MP_AGREE (a partner the other side lacks counts as unequal),
    the same stop; the slots one side lacks printed (sift_lone), and a
    point one side lacks must lie within SIFT_MARGIN of the top-k's cut or
    the contrast threshold (the extremum, Newton and edge tests are not
    measured: a point that one of them decides otherwise fails here)."""
    shares, derr, common, far = [], [], [], 0
    for s in (0, 1):
        c = sift_common(gpu[s], cpu[s])
        common.append(c)
        shares.append(len(c) / gpu[s]["valid"].sum())
        derr.append(np.linalg.norm(gpu[s]["descriptors"][c[:, 0]]
                                   - cpu[s]["descriptors"][c[:, 1]], axis=-1))
        for side, f, idx, other in (("card", gpu[s], c[:, 0], cpu[s]),
                                    ("CPU", cpu[s], c[:, 1], gpu[s])):
            n, at_shared, m = sift_lone(f, idx, other, conf)
            far += int((m >= SIFT_MARGIN).sum())
            print(f"  image {s}: {n} slots only on the {side}, {at_shared} of "
                  f"them another orientation of a point both have; the "
                  f"points only on the {side}: margins {m.tolist()}")
    d50, d99, dmax = np.quantile(np.concatenate(derr), [0.5, 0.99, 1.0])
    other = {int(i): int(j) for i, j in common[1]}
    gm, cm = gpu[2]["matches0"], cpu[2]["matches0"]
    same = [(-1 if gm[i] < 0 else other.get(int(gm[i]), -2)) == int(cm[j])
            for i, j in common[0]]
    same = float(np.mean(same)) if same else 1.0
    print(f"  SIFTDevice against the CPU port: slots in common "
          f"{shares[0]:.6f} / {shares[1]:.6f} (tol {SIFT_SHARE:g}), L2 between "
          f"their descriptors: median {d50:.3e}, 99th percentile {d99:.3e}, "
          f"largest {dmax:.3e} (tol {SIFT_DESC_TOL:g}); {far} points one side lacks away from the cut and the "
          f"threshold; {int((gm >= 0).sum())} vs {int((cm >= 0).sum())} "
          f"matches, matches0 equal on the common slots {same:.6f} (tol "
          f"{MP_AGREE:g}), stop {gpu[2]['stop']} vs {cpu[2]['stop']}", flush=True)
    if (min(shares) < SIFT_SHARE or dmax > SIFT_DESC_TOL or far or same < MP_AGREE
            or gpu[2]["stop"] != cpu[2]["stop"]):
        raise AssertionError("SIFTDevice: the card disagrees with the CPU port")


def sift_path_phase():
    """Phase 3g, SIFT: images -> SIFTDevice -> LightGlue("sift", trained
    weights) through match_pair (4096 keypoints: K1 + B4, K2 + B4, B2),
    make_end_to_end (B 2, 1024: B5, B6, B2) and match_sequence (window 1,
    1024), and SIFT(backend="opencv") through match_pair (4096 slots),
    each path's launch counts read on their own; precision against the
    pair's homography; one pair of SIFTDevice against the CPU port (the
    pyramids, then sift_agree) and the opencv pair's matches against
    the CPU port's matcher on the same features. Returns the counts
    summed."""
    rng = np.random.default_rng(83)
    pairs = [image_pair(rng, H, W) for _ in range(2)]
    total = dict.fromkeys(KERNELS, 0)
    matcher = LightGlue("sift", params=SIFT_WEIGHTS, device="cuda")
    cpu_matcher = LightGlue("sift", params=SIFT_WEIGHTS, device="cpu")
    phase("3g main path: images -> SIFTDevice -> LightGlue('sift'): match_pair "
          "at 4096 keypoints, make_end_to_end B 2 and match_sequence at 1024")
    ext = SIFTDevice(device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    outs, counts = counted("SIFTDevice match_pair", lambda: [
        match_pair(ext, matcher, a, b) for a, b, _ in pairs],
        *matcher_kernels(4096))
    print(f"  two match_pair calls (first calls): {time.perf_counter() - t0:.1f}"
          f" s; device memory above the {gib(base)} held before: peak "
          f"{gib(torch.cuda.max_memory_allocated() - base)}", flush=True)
    add_counts(total, counts)
    for i, (out, (_, _, hom)) in enumerate(zip(outs, pairs)):
        check_pair_output(f"SIFTDevice match_pair pair {i}", *out, (W, H), (W, H))
        k, prec = sift_precision(*out, hom)
        print(f"  SIFTDevice pair {i}: {k} matches, precision {prec:.3f} "
              f"against the homography (within {SIFT_PX:g} px)")
        if k < 10 or prec < SIFT_PRECISION:
            raise AssertionError("SIFTDevice -> LightGlue('sift'): precision low")
    conf = ext.conf.replace(max_num_keypoints=1024)
    run = end_to_end.make_end_to_end(sift_device.forward, None, conf,
                                     matcher.params, matcher.conf)
    im0, im1 = (torch.from_numpy(np.stack([p[i] for p in pairs]))[..., None]
                .cuda() for i in (0, 1))
    sizes = torch.tensor([[W, H]] * 2, dtype=torch.float32, device="cuda")
    e2e, counts = counted("SIFT make_end_to_end B 2",
                          lambda: run(im0, im1, sizes, sizes),
                          *matcher_kernels(1024))
    add_counts(total, counts)
    for i in range(2):
        out = e2e_feats(e2e, i)
        check_pair_output(f"SIFT make_end_to_end B 2, pair {i}", *out, (W, H),
                          (W, H))
        print(f"  pair {i}: precision {sift_precision(*out, pairs[i][2])[1]:.3f}")
    frames = np.stack([pairs[0][0], pairs[0][1], pairs[1][0]])
    (feats, seq), counts = counted(
        "SIFT match_sequence window 1",
        lambda: match_sequence(SIFTDevice(device="cuda", max_num_keypoints=1024),
                               matcher, frames, window=1),
        *matcher_kernels(1024))
    add_counts(total, counts)
    e2e0 = e2e.feats0.keypoints[0].cpu().numpy()
    if (feats["scales"].shape != (3, 1024)
            or not np.array_equal(feats["keypoints"][0], e2e0)
            or not np.isfinite(seq["matching_scores0"]).all()):
        raise AssertionError("match_sequence: its first frame's keypoints "
                             "differ from make_end_to_end's, or scores not "
                             "finite")
    same = np.array_equal(seq["matches0"][0], e2e.matches.matches0[0].cpu().numpy())
    print(f"  match_sequence: {[int((m >= 0).sum()) for m in seq['matches0']]} "
          f"matches; frame 0's keypoints equal to make_end_to_end's, pair 0's "
          f"matches {'equal' if same else 'not equal'} (batches of 2 and 2 "
          "pairs, adaptive)")

    a, b, _ = pairs[0]
    t0 = time.perf_counter()
    pyr = sift_pyramid_err(a)
    print(f"  SIFTDevice's pyramid, card (convolutions) against the CPU port "
          f"(fused tap chain): max_abs_err over the octave's largest value "
          f"{pyr:.3e} (tol {SIFT_PYR_TOL:g})", flush=True)
    if not pyr <= SIFT_PYR_TOL:
        raise AssertionError("SIFTDevice: the card's pyramid disagrees with "
                             "the CPU port's")
    cpu = match_pair(SIFTDevice(device="cpu"), cpu_matcher, a, b)
    print(f"  the CPU port's pair: {time.perf_counter() - t0:.1f} s on the host")
    sift_agree(outs[0], cpu, ext.conf)

    phase("3g main path: images -> SIFT(backend='opencv') -> LightGlue('sift'): "
          "match_pair, 4096 slots")
    host = SIFT(backend="opencv", device="cuda")
    out, counts = counted("SIFT opencv match_pair",
                          lambda: match_pair(host, matcher, a, b),
                          *matcher_kernels(4096))
    add_counts(total, counts)
    check_pair_output("SIFT opencv match_pair", *out, (W, H), (W, H))
    k, prec = sift_precision(*out, pairs[0][2])
    ref = cpu_matcher({"image0": {k_: v[None] for k_, v in out[0].items()},
                       "image1": {k_: v[None] for k_, v in out[1].items()}})
    same = all(np.array_equal(out[2][f], ref[f][0]) for f in
               ("matches0", "matches1", "prune0", "prune1"))
    serr = float(np.abs(out[2]["matching_scores0"] - ref["matching_scores0"][0]).max())
    print(f"  opencv: {int(out[0]['valid'].sum())} + {int(out[1]['valid'].sum())} "
          f"keypoints, {k} matches, precision {prec:.3f}; the CPU port's "
          f"matcher on the same features: matches, prune "
          f"{'equal' if same else 'DIFFER'}, scores max_abs_err {serr:.3e}, "
          f"stop {out[2]['stop']} vs {ref['stop']}", flush=True)
    if (not same or serr > MATCH_SCORE_TOL or out[2]["stop"] != ref["stop"]
            or k < 10 or prec < SIFT_PRECISION):
        raise AssertionError("SIFT opencv: precision low or the card disagrees "
                             "with the CPU port")
    return total


# DoGHardNet's HardNet on the card against the CPU port fed the card's own
# detections (so that SIFT's near-tie slots, above, stay out): the patches
# within HARDNET_PATCH_TOL (values in [0, 1]; the card's cos, sin and
# products round on their own, which moves a sample by about 1e-5 px: the
# CPU port against the JAX package 8e-6, tests/test_torch_hardnet.py), the
# unit descriptors within HARDNET_DESC_TOL on valid slots (cuDNN's fp32
# convolutions, TF32 off, against oneDNN's: sums in another order, over
# the standardized patches).
HARDNET_PATCH_TOL, HARDNET_DESC_TOL = 1e-4, 1e-3


def hardnet_flops_bytes(n):
    """HardNet on n patches: (FLOPs of its convolutions, bytes of the
    patches read, the weights read and the descriptors written)."""
    size, flops, weights = hardnet.PATCH_SIZE, 0, 0
    for ci, co, ks, stride, pad, _ in hardnet.LAYERS:
        size = size - ks + 1 if pad == "VALID" else size // stride
        flops += 2 * co * ci * ks * ks * size * size
        weights += co * ci * ks * ks + 4 * co
    return n * flops, 4 * (n * hardnet.PATCH_SIZE ** 2 + weights
                           + n * hardnet.DESC_DIM)


def hardnet_agree(label, hp, image, conf):
    """The card's patches and HardNet descriptors at the card's detections
    of one (H, W) image against the CPU port's on the same detections."""
    img = torch.from_numpy(image)
    with torch.inference_mode():
        det = sift_device.extract_batch(img.cuda()[None], conf)
        args = (det["keypoints"], hardnet.LAF_SCALE * det["scales"],
                det["oris"])
        patches = hardnet.extract_laf_patches_batch(img.cuda()[None], *args)
        cpu_patches = hardnet.extract_laf_patches_batch(
            img[None], *(a.cpu() for a in args))
        v = det["valid"][0].cpu()
        desc = hardnet.describe_patches(hp, patches[0][v.cuda()]).cpu()
        cpu_desc = hardnet.describe_patches(nn.params_to(hp, "cpu"),
                                            cpu_patches[0][v])
    perr = float((patches[0].cpu()[v] - cpu_patches[0][v]).abs().max())
    derr = float((desc - cpu_desc).abs().max())
    l2 = torch.linalg.vector_norm(desc - cpu_desc, dim=-1).numpy()
    print(f"  {label}, card against the CPU port on the card's {int(v.sum())} "
          f"detections: patches max_abs_err {perr:.3e} (tol "
          f"{HARDNET_PATCH_TOL:g}), descriptors max_abs_err {derr:.3e} (tol "
          f"{HARDNET_DESC_TOL:g}), L2 median {np.median(l2):.3e}, largest "
          f"{l2.max():.3e}", flush=True)
    if not (perr <= HARDNET_PATCH_TOL and derr <= HARDNET_DESC_TOL):
        raise AssertionError(f"{label}: the card's HardNet disagrees with the "
                             "CPU port's")


def doghardnet_path_phase():
    """Phase 3g, DoGHardNet: images -> DoGHardNetDevice ->
    LightGlue("doghardnet", the trained SIFT layers, which have the
    preset's shapes) through match_pair (4096 keypoints: K1 + B4, K2 + B4,
    B2), make_end_to_end (B 2, 1024: B5, B6, B2) and match_sequence
    (window 1, 1024), and DoGHardNet (OpenCV on the host, HardNet on the
    card) through match_pair (4096 slots), each path's launch counts read
    on their own; HardNet's seeded stand-in weights
    (synthetic.hardnet_params); the card's HardNet against the CPU port
    fed the card's own detections (hardnet_agree); the host path's
    features against the CPU port's DoGHardNet (the OpenCV detections
    equal, descriptors within HARDNET_DESC_TOL) and its matches against
    the CPU port's matcher on the same features. Returns the counts
    summed."""
    rng = np.random.default_rng(89)
    pairs = [image_pair(rng, H, W) for _ in range(2)]
    total = dict.fromkeys(KERNELS, 0)
    sconf = SIFTConfig(backend="device")
    hp = hardnet_params(torch.from_numpy(np.stack([p[0] for p in pairs])).cuda(),
                        sconf)
    matcher = LightGlue("doghardnet", params=SIFT_WEIGHTS, device="cuda")
    cpu_matcher = LightGlue("doghardnet", params=SIFT_WEIGHTS, device="cpu")
    phase("3g main path: images -> DoGHardNetDevice -> LightGlue('doghardnet'): "
          "match_pair at 4096 keypoints, make_end_to_end B 2 and "
          "match_sequence at 1024")
    ext = DoGHardNetDevice(params=hp, device="cuda")
    outs, counts = counted("DoGHardNetDevice match_pair", lambda: [
        match_pair(ext, matcher, a, b) for a, b, _ in pairs],
        *matcher_kernels(4096))
    add_counts(total, counts)
    for i, (out, (_, _, hom)) in enumerate(zip(outs, pairs)):
        check_pair_output(f"DoGHardNetDevice match_pair pair {i}", *out, (W, H),
                          (W, H))
        k, prec = sift_precision(*out, hom)
        print(f"  pair {i}: {k} matches, precision {prec:.3f} against the "
              f"homography (within {SIFT_PX:g} px; random HardNet weights, a "
              "matcher trained on SIFT)")
    run = end_to_end.make_end_to_end(
        hardnet.forward, ext.params, sconf.replace(max_num_keypoints=1024),
        matcher.params, matcher.conf)
    im0, im1 = (torch.from_numpy(np.stack([p[i] for p in pairs]))[..., None]
                .cuda() for i in (0, 1))
    sizes = torch.tensor([[W, H]] * 2, dtype=torch.float32, device="cuda")
    e2e, counts = counted("DoGHardNet make_end_to_end B 2",
                          lambda: run(im0, im1, sizes, sizes),
                          *matcher_kernels(1024))
    add_counts(total, counts)
    for i in range(2):
        check_pair_output(f"DoGHardNet make_end_to_end B 2, pair {i}",
                          *e2e_feats(e2e, i), (W, H), (W, H))
    frames = np.stack([pairs[0][0], pairs[0][1], pairs[1][0]])
    (feats, seq), counts = counted(
        "DoGHardNet match_sequence window 1",
        lambda: match_sequence(DoGHardNetDevice(params=hp, device="cuda",
                                                max_num_keypoints=1024),
                               matcher, frames, window=1),
        *matcher_kernels(1024))
    add_counts(total, counts)
    derr = float(np.abs(feats["descriptors"][0]
                        - e2e.feats0.descriptors[0].cpu().numpy()).max())
    if (feats["scales"].shape != (3, 1024)
            or not np.array_equal(feats["keypoints"][0],
                                  e2e.feats0.keypoints[0].cpu().numpy())
            or derr > HARDNET_DESC_TOL
            or not np.isfinite(seq["matching_scores0"]).all()):
        raise AssertionError("DoGHardNet match_sequence: frame 0's features "
                             "differ from make_end_to_end's, or scores not "
                             "finite")
    same = np.array_equal(seq["matches0"][0], e2e.matches.matches0[0].cpu().numpy())
    print(f"  match_sequence: {[int((m >= 0).sum()) for m in seq['matches0']]} "
          f"matches; frame 0's keypoints equal to make_end_to_end's, its "
          f"descriptors within {derr:.3e}, pair 0's matches "
          f"{'equal' if same else 'not equal'} (batches of 3 and 2 images)")
    a, b, _ = pairs[0]
    hardnet_agree("DoGHardNetDevice", hp, a, sconf)

    phase("3g main path: images -> DoGHardNet (OpenCV on the host, HardNet on "
          "the card) -> LightGlue('doghardnet'): match_pair, 4096 slots")
    host = DoGHardNet(params=hp, device="cuda")
    out, counts = counted("DoGHardNet opencv match_pair",
                          lambda: match_pair(host, matcher, a, b),
                          *matcher_kernels(4096))
    add_counts(total, counts)
    check_pair_output("DoGHardNet opencv match_pair", *out, (W, H), (W, H))
    cpu_f = DoGHardNet(params=nn.params_to(hp, "cpu"), device="cpu").extract(a)
    v = cpu_f["valid"][0]
    equal = all(np.array_equal(out[0][k], cpu_f[k][0]) for k in
                ("keypoints", "keypoint_scores", "scales", "oris", "valid"))
    derr = float(np.abs(out[0]["descriptors"][v] - cpu_f["descriptors"][0][v]).max())
    ref = cpu_matcher({"image0": {k_: v_[None] for k_, v_ in out[0].items()},
                       "image1": {k_: v_[None] for k_, v_ in out[1].items()}})
    same = all(np.array_equal(out[2][f], ref[f][0]) for f in
               ("matches0", "matches1", "prune0", "prune1"))
    serr = float(np.abs(out[2]["matching_scores0"] - ref["matching_scores0"][0]).max())
    k, prec = sift_precision(*out, pairs[0][2])
    print(f"  DoGHardNet opencv: detections {'equal' if equal else 'DIFFER'} "
          f"to the CPU port's, descriptors max_abs_err {derr:.3e} (tol "
          f"{HARDNET_DESC_TOL:g}); {k} matches, precision {prec:.3f}; the CPU "
          f"port's matcher on the same features: matches, prune "
          f"{'equal' if same else 'DIFFER'}, scores max_abs_err {serr:.3e}, "
          f"stop {out[2]['stop']} vs {ref['stop']}", flush=True)
    if (not equal or derr > HARDNET_DESC_TOL or not same
            or serr > MATCH_SCORE_TOL or out[2]["stop"] != ref["stop"]):
        raise AssertionError("DoGHardNet opencv: the card disagrees with the "
                             "CPU port")
    return total


def disk_sift_timing_phase():
    """Phase 4e: extraction ms an image (DISK B 1 and B 8 in fp32 and at
    mp, SIFTDevice B 1, DoGHardNetDevice B 1 and B 2 with HardNet's patches
    and CNN apart beside the CNN's bound; CUDA events), images to matches
    pairs/s (make_end_to_end fixed at 1024: DISK B 8 in fp32 and at mp,
    SIFTDevice and DoGHardNetDevice B 2) and match_pair ms a pair (host
    clock; SIFTDevice and opencv at 4096)."""
    phase("4e timing: DISK, SIFT and DoGHardNet extraction, images -> matches")
    rng = np.random.default_rng(87)
    pool = [image_pair(rng, H, W) for _ in range(8)]
    im0 = torch.from_numpy(np.stack([p[0] for p in pool]))[..., None].cuda()
    im1 = torch.from_numpy(np.stack([p[1] for p in pool]))[..., None].cuda()
    sizes = torch.tensor([[W, H]] * 8, dtype=torch.float32, device="cuda")
    dp = disk_params()
    for mp in (False, True):
        conf = DISKConfig(mp=mp)
        for bsz in (1, 8):
            ms = time_cuda(lambda: disk.forward(dp, conf, im0[:bsz]), iters=5) / bsz
            print(f"  DISK extraction{' at mp' if mp else ''}, B {bsz}: "
                  f"{ms:.3f} ms per {H}x{W} image (2048 keypoints)", flush=True)
    sconf = SIFTConfig(backend="device")
    ms = time_cuda(lambda: sift_device.forward(None, sconf, im0[:1]), iters=5,
                   warmup=2)
    print(f"  SIFTDevice extraction, B 1: {ms:.3f} ms per {H}x{W} image (4096 "
          "keypoints)", flush=True)
    # its parts: the pyramid (9 octaves, the first 1536 x 2048 x 7 layers),
    # the first octave's candidates (a stable sort over its 4 x 1536 x 2048
    # DoG entries, most 0) and that sort alone on as many values
    img = im0[0, ..., 0]
    ms_p = time_cuda(lambda: sift_device.build_pyramid(img, sconf), iters=3)
    dog = torch.stack(sift_device.build_pyramid(img, sconf)[1][0])
    thr = float(np.floor(0.5 * sconf.detection_threshold
                         / sconf.num_scales_per_octave * 255.0))
    n_cand = 4 * sconf.max_num_keypoints
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms_c = time_cuda(lambda: sift_device.extrema_candidates(dog, n_cand, thr),
                     iters=5)
    peak = torch.cuda.max_memory_allocated() - base
    g = torch.Generator(device="cuda").manual_seed(3)
    vals = dog[1:-1].reshape(-1)
    sparse = torch.where(torch.rand(vals.shape, generator=g, device="cuda") < 1e-3,
                         torch.rand(vals.shape, generator=g, device="cuda"), 0.0)
    ms_s = time_cuda(lambda: sift_device.stable_topk(sparse, n_cand), iters=5)
    print(f"  SIFTDevice parts: pyramid {ms_p:.3f} ms; first octave's "
          f"candidates {ms_c:.3f} ms ({vals.numel()} entries, device memory "
          f"peak {gib(peak)} above the inputs); the stable sort alone "
          f"{ms_s:.3f} ms", flush=True)

    def rate(label, run, bsz, reps=5):
        for _ in range(2):
            run(im0[:bsz], im1[:bsz], sizes[:bsz], sizes[:bsz])
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = run(im0[:bsz], im1[:bsz], sizes[:bsz], sizes[:bsz])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        print(f"  make_end_to_end {label} fixed B {bsz}, {H}x{W}, 1024 "
              f"keypoints: {bsz * 1e3 / med:.1f} pairs/s (median {med:.2f} ms "
              f"per call, quartiles {q1:.2f}-{q3:.2f}, {reps} calls, stop "
              f"{out.matches.stop})", flush=True)

    for mp in (False, True):
        mconf = lightglue_config("disk", mp=mp, **FIXED)
        rate(f"DISK{' at mp' if mp else ''}", end_to_end.make_end_to_end(
            disk.forward, dp, DISKConfig(max_num_keypoints=1024, mp=mp),
            LightGlue("disk", device="cuda", mp=mp).params, mconf), 8)
    sm = LightGlue("sift", params=SIFT_WEIGHTS, device="cuda", **FIXED)
    rate("SIFTDevice", end_to_end.make_end_to_end(
        sift_device.forward, None, sconf.replace(max_num_keypoints=1024),
        sm.params, sm.conf), 2, reps=3)
    a, b = pool[0][0], pool[0][1]
    for label, ext in (("SIFTDevice", SIFTDevice(device="cuda")),
                       ("SIFT opencv", SIFT(backend="opencv", device="cuda"))):
        match_pair(ext, sm, a, b)
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            match_pair(ext, sm, a, b)
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"  match_pair {label} -> LightGlue('sift') fixed, {H}x{W}, 4096 "
              f"keypoints: median {np.median(ms):.2f} ms per pair (3 calls)",
              flush=True)

    # DoGHardNetDevice: SIFTDevice's detections, then HardNet's patches and
    # CNN, these two timed apart on one image's 4096 slots beside the CNN's
    # bound (fp32 on the CUDA cores)
    hp = hardnet_params(im0[:2, ..., 0], sconf)
    for bsz in (1, 2):
        ms = time_cuda(lambda: hardnet.forward(hp, sconf, im0[:bsz]), iters=3,
                       warmup=1) / bsz
        print(f"  DoGHardNetDevice extraction, B {bsz}: {ms:.3f} ms per {H}x{W} "
              "image (4096 keypoints)", flush=True)
    with torch.inference_mode():
        det = sift_device.extract_batch(im0[:1, ..., 0], sconf)
        args = (im0[:1, ..., 0], det["keypoints"],
                hardnet.LAF_SCALE * det["scales"], det["oris"])
        ms_p = time_cuda(lambda: hardnet.extract_laf_patches_batch(*args),
                         iters=10)
        patches = hardnet.extract_laf_patches_batch(*args).flatten(0, 1)
        ms_c = time_cuda(lambda: hardnet.describe_patches(hp, patches), iters=10)
    flops, nbytes = hardnet_flops_bytes(patches.shape[0])
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"  DoGHardNetDevice parts, B 1: LAF patches {ms_p:.3f} ms, HardNet "
          f"{ms_c:.3f} ms on {patches.shape[0]} patches ({flops / 1e12:.3f} "
          f"TFLOP, bound {max(t_ops, t_bytes):.3f} ms by "
          f"{'operations' if t_ops >= t_bytes else 'bytes'}: "
          f"{flops / ms_c / 1e9:.1f} TFLOP/s achieved)", flush=True)
    # the matcher on one pair of these features (4096 slots, fixed), the
    # yardstick for HardNet's share
    hm = LightGlue("doghardnet", params=SIFT_WEIGHTS, device="cuda", **FIXED)
    with torch.inference_mode():
        f0, f1 = (hardnet.forward(hp, sconf, im[:1]) for im in (im0, im1))
        ms_m = time_cuda(lambda: lg.forward(
            hm.params, hm.conf, kpts0=f0.keypoints, kpts1=f1.keypoints,
            desc0=f0.descriptors, desc1=f1.descriptors, size0=sizes[:1],
            size1=sizes[:1], mask0=f0.valid, mask1=f1.valid,
            **end_to_end._scale_ori_kw(f0, f1)), iters=5, warmup=2)
    print(f"  LightGlue('doghardnet') fixed on one pair of these features, "
          f"4096 slots: {ms_m:.3f} ms", flush=True)
    rate("DoGHardNetDevice", end_to_end.make_end_to_end(
        hardnet.forward, hp, sconf.replace(max_num_keypoints=1024),
        hm.params, hm.conf), 2, reps=3)


def serving_traffic(rng, n):
    """n planted pairs for the serving phases: image 1's keypoint count
    drawn from SERVING_KEYPOINTS, image 0's from its low end to it. Returns (pairs of
    unbatched feats dicts, planted truths)."""
    pairs, gts = [], []
    lo, hi = SERVING_KEYPOINTS
    for _ in range(n):
        k1 = int(rng.integers(lo, hi + 1))
        pr = planted_pairs(rng, 1, int(rng.integers(lo, k1 + 1)), k1)
        pairs.append(tuple({"keypoints": pr[f"keypoints{s}"][0],
                            "descriptors": pr[f"descriptors{s}"][0],
                            "image_size": pr["image_size"][0]} for s in (0, 1)))
        gts.append(pr["gt_matches0"][0])
    return pairs, gts


def eager_forward(bm, f0, f1):
    """models.lightglue.forward on the card on one of bm's padded batches."""
    kw = batching.batch_inputs(bm.conf, f0, f1)
    with torch.inference_mode():
        out = lg.forward(bm.params, bm.conf, **{
            k: None if v is None else torch.from_numpy(v).cuda()
            for k, v in kw.items()})
    return lg.MatchOutput(*(o if isinstance(o, int) else o.cpu().numpy()
                            for o in out))


def gib(nbytes):
    return f"{nbytes / 2 ** 30:.2f} GiB"


def serving_phase(params, traffic):
    """Phase 3e: BatchMatcher on CUDA graphs, fixed and adaptive. Returns
    the launch counts of the traffic (graph replays); ``traffic`` receives
    the pairs ("pairs") and each padded batch's (matches0, scores0)
    ("outputs") for phase 3h."""
    buckets = tuple(b for b, _, _ in SERVING_BUCKETS)
    total = dict.fromkeys(KERNELS, 0)
    pairs, gts = serving_traffic(np.random.default_rng(41), SERVING_PAIRS)
    traffic.update(pairs=pairs, outputs=[])
    by_bucket = {b: [i for i, (f0, f1) in enumerate(pairs) if batching.next_bucket(
        max(f0["keypoints"].shape[0], f1["keypoints"].shape[0]), buckets) == b]
                 for b in buckets}
    if not all(by_bucket.values()):
        raise AssertionError(f"a bucket gets no traffic: {by_bucket}")
    for mode, c in (("fixed", FIXED), ("adaptive", {})):
        phase(f"3e main path: BatchMatcher, {mode}, trained weights, "
              f"{SERVING_PAIRS} planted pairs of {SERVING_KEYPOINTS} keypoints, buckets "
              f"{buckets}, max_batch 16 (CUDA graphs captured by warmup)")
        conf = lightglue_config("superpoint", **c)
        bm = BatchMatcher(conf, params, buckets=buckets, max_batch=16)
        batches = sorted({f0["keypoints"].shape[0]
                          for _, f0, _ in bm.padded_batches(pairs)} | {1})
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        n = bm.warmup(batches)
        torch.cuda.synchronize()
        print(f"  warmup: {n} programs (batches {batches}) in "
              f"{time.perf_counter() - t0:.1f} s, {gib(torch.cuda.memory_allocated() - base)}"
              f" allocated; pairs per bucket "
              f"{ {b: len(i) for b, i in by_bucket.items()} }", flush=True)
        captured = dict(bm._matcher.sets)
        # every replay equal to the bit to the eager forward on the card
        for chunk, f0, f1 in bm.padded_batches(pairs):
            got, ref = bm.match_batch(f0, f1), eager_forward(bm, f0, f1)
            traffic["outputs"].append((got.matches0, got.matching_scores0))
            differ = [f for f in graphs.OUTPUTS
                      if not np.array_equal(getattr(got, f), getattr(ref, f))]
            b, k = f0["keypoints"].shape[:2]
            print(f"  bucket {k}, batch {b} ({len(chunk)} pairs): graph replay "
                  f"{'equal to the bit to' if not differ else 'DIFFERS from'} "
                  f"eager lg.forward, stop {got.stop} vs {ref.stop}")
            if differ or got.stop != ref.stop:
                raise AssertionError(f"{mode} bucket {k} batch {b}: the graphs "
                                     f"and the eager forward differ in {differ}")
        # the traffic, bucket by bucket, with the graphs' launch counts
        for bucket, kernels, must_not in SERVING_BUCKETS:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            res = bm.match_pairs([pairs[i] for i in by_bucket[bucket]])
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            print(f"  bucket {bucket}: launch counts "
                  f"{ {k: c for k, c in counts.items() if c} }")
            for kname in kernels:
                if counts[kname] < 1:
                    raise AssertionError(f"{kname} was not launched at {bucket}")
            for kname in must_not:
                if counts[kname]:
                    raise AssertionError(f"{kname} was launched at {bucket}")
            for k, c in counts.items():
                total[k] += c
            # precision over the bucket's matches: one skewed pair (400
            # against 1211 keypoints) reaches 0.667 on the CPU port too
            hits = []
            for i, r in zip(by_bucket[bucket], res):
                pred = r["matches0"] >= 0
                if not np.isfinite(r["matching_scores0"]).all() or not pred.any():
                    raise AssertionError(f"pair {i}: no matches or scores not finite")
                hits.append((int(pred.sum()), int((r["matches0"][pred] == gts[i][pred]).sum())))
            prec = sum(h for _, h in hits) / sum(k for k, _ in hits)
            k, h = min(hits, key=lambda kh: kh[1] / kh[0])
            print(f"    {len(res)} pairs, stop {sorted({r['stop'] for r in res})}, "
                  f"{sum(k for k, _ in hits)} matches, precision against the "
                  f"planted truth {prec:.3f} (lowest pair {h}/{k})")
            if prec < MIN_PRECISION[4]:
                raise AssertionError(f"bucket {bucket}: precision {prec}")
        if bm._matcher.sets != captured:
            raise AssertionError("the traffic captured a program after warmup")
        # one pair of each bucket (the batch-1 graphs) against the CPU port
        cpu = BatchMatcher(conf, params, buckets=buckets, max_batch=16,
                           device="cpu")
        for bucket, idx in by_bucket.items():
            (_, f0, f1), = bm.padded_batches([pairs[idx[0]]])
            got, ref = bm.match_batch(f0, f1), cpu.match_batch(f0, f1)
            eager = eager_forward(bm, f0, f1)
            if eager.stop != got.stop or not all(
                    np.array_equal(getattr(got, f), getattr(eager, f))
                    for f in graphs.OUTPUTS):
                raise AssertionError(f"{mode} bucket {bucket} batch 1: the "
                                     "graphs and the eager forward differ")
            agree = float((got.matches0 == ref.matches0).mean())
            pruned = sum(int((getattr(got, f) != getattr(ref, f)).sum())
                         for f in ("prune0", "prune1"))
            gap = max(float(np.abs(getattr(got, f) - getattr(ref, f)).max())
                      for f in ("matching_scores0", "matching_scores1"))
            print(f"  bucket {bucket}, pair {idx[0]} (batch 1, its replay equal "
                  f"to the bit to eager lg.forward) against the CPU port: "
                  f"matches0 agreement {agree:.6f}, stop {got.stop} vs "
                  f"{ref.stop}, {pruned} points whose prune differs, score "
                  f"diff {gap:.2e} (tol {MATCH_SCORE_TOL:g})")
            if (agree < 0.999 or got.stop != ref.stop or pruned
                    or gap > MATCH_SCORE_TOL):
                raise AssertionError(f"{mode} bucket {bucket}: the card "
                                     "disagrees with the CPU port")
        del bm, captured
        gc.collect()
        torch.cuda.empty_cache()
    return total


def serving_memory_phase(params):
    """The default grid (8 buckets up to 4096, max_batch 16, with and
    without image_size) captured and held on the card, fixed and adaptive,
    with one request at the largest bucket."""
    phase("3e the default serving grid: BatchMatcher(DEFAULT_BUCKETS, "
          "max_batch 16).warmup(), device memory")
    rng = np.random.default_rng(47)
    (pair,), _ = serving_traffic(rng, 1)
    pr = planted_pairs(rng, 1, 3000, 4000)
    big = tuple({"keypoints": pr[f"keypoints{s}"][0],
                 "descriptors": pr[f"descriptors{s}"][0]} for s in (0, 1))
    for mode, c in (("fixed", FIXED), ("adaptive", {})):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bm = BatchMatcher(lightglue_config("superpoint", **c), params)
        t0 = time.perf_counter()
        n = bm.warmup()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"  {mode}: {n} programs in {secs:.1f} s; allocated "
              f"{gib(torch.cuda.memory_allocated() - base)}, reserved "
              f"{gib(torch.cuda.memory_reserved())}, peak "
              f"{gib(torch.cuda.max_memory_allocated() - base)} of "
              f"{gib(total)}", flush=True)
        if n != len(batching.DEFAULT_BUCKETS) * 2 or len(bm._matcher.sets) != n:
            raise AssertionError(f"{mode}: warmup built {n} programs")
        # batch 1 was not warmed: these requests capture on first sight
        out = bm.match_pairs([pair, big])
        torch.cuda.synchronize()
        k = max(f["keypoints"].shape[0] for f in pair)
        print(f"    then a request at bucket {batching.next_bucket(k)} and "
              f"one at 4096 (no image_size), each captured on first sight: "
              f"{[int((r['matches0'] >= 0).sum()) for r in out]} matches, "
              f"stop {[r['stop'] for r in out]}, peak "
              f"{gib(torch.cuda.max_memory_allocated() - base)}", flush=True)
        if len(bm._matcher.sets) != n + 2:
            raise AssertionError(f"{mode}: the requests did not capture")
        if not all(np.isfinite(r["matching_scores0"]).all() for r in out):
            raise AssertionError(f"{mode}: scores not finite")
        del bm, out
        gc.collect()
        torch.cuda.empty_cache()


# --- phase 3h: training and the host runtime -----------------------------------

TRAIN_CONF = dict(flash=False, mp=False, depth_confidence=-1.0,
                  width_confidence=-1.0, compaction_bucket=0)
TRAIN_STEPS, TRAIN_LOG_EVERY = 200, 20
# the card's fp32 sums against the CPU's: the loss within 1e-4 relative,
# each leaf's gradient within 1e-3 of that leaf's largest |grad|
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
TRAIN_HISTORY = os.path.join(ROOT, "benchmarks", "train_synthetic_history.json")


def train_step_phase():
    """One training step (matcher_loss, backward, the optax chain) on the
    card against the CPU port: the superpoint preset at full width (9
    layers, d 256), B 2, m 256, one batch drawn on the CPU (the CPU's and
    the card's generators draw different streams) and one initial tree."""
    phase("3h training: one step on the card against the CPU port (matcher_loss, "
          "backward, OptaxAdamW), superpoint preset, 9 layers, B 2, m 256")
    conf = lightglue_config("superpoint").replace(**TRAIN_CONF)
    init = lg.init_params(conf, torch.Generator().manual_seed(5))
    batch = train.synthetic_batch(torch.Generator().manual_seed(6), 2, 256)
    res = {}
    for dev in ("cpu", "cuda"):
        params = nn.map_params(init, lambda t: t.to(dev, copy=True))
        opt = train.make_optimizer(params, 2e-4, 1500)
        with train.fp32_math():
            loss, aux = train.matcher_loss(params, conf, batch.to(dev))
            loss.backward()
        # copied before the step, which clips the gradients in place
        grads = {k: v.copy() for k, v in weights_lib.flatten_params(
            nn.map_params(params, lambda t: t.grad)).items()}
        norm = float(opt.step())
        res[dev] = (float(loss.detach()),
                    {k: float(v.detach()) for k, v in aux.items()}, grads, norm)
    (l_cpu, a_cpu, g_cpu, n_cpu), (l_gpu, a_gpu, g_gpu, n_gpu) = (
        res["cpu"], res["cuda"])
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    errs = {k: float(np.abs(g_gpu[k] - g_cpu[k]).max() / np.abs(g_cpu[k]).max())
            for k in g_cpu}
    worst = max(errs, key=errs.get)
    print(f"  loss {l_gpu:.7f} (card) vs {l_cpu:.7f} (CPU): relative {rel:.3e} "
          f"(tol {TRAIN_LOSS_TOL:g}); nll {a_gpu['nll']:.7f} vs {a_cpu['nll']:.7f}, "
          f"confidence_bce {a_gpu['confidence_bce']:.7f} vs "
          f"{a_cpu['confidence_bce']:.7f}; gradient norm {n_gpu:.6f} vs {n_cpu:.6f}")
    print(f"  gradients, {len(errs)} leaves: largest error {errs[worst]:.3e} of "
          f"its leaf's largest |grad| ({worst}; tol {TRAIN_GRAD_TOL:g}), median "
          f"{statistics.median(errs.values()):.3e}", flush=True)
    if not (rel <= TRAIN_LOSS_TOL and errs[worst] <= TRAIN_GRAD_TOL):
        raise AssertionError("training step: the card disagrees with the CPU port")


def train_run_phase():
    """train_synthetic on the card at full width: the superpoint preset, 9
    layers, B 16, m 512, TRAIN_STEPS steps. Returns the trained tree."""
    phase(f"3h training: train_synthetic on the card, superpoint preset, 9 layers, "
          f"B 16, m 512, {TRAIN_STEPS} steps (fp32, TF32 off)")
    conf = lightglue_config("superpoint")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step_ms = []
    t0 = time.perf_counter()
    tree, tconf, hist = train.train_synthetic(
        conf, steps=TRAIN_STEPS, batch=16, m=512, log_every=TRAIN_LOG_EVERY,
        verbose=False, device="cuda", step_ms=step_ms)
    wall = time.perf_counter() - t0
    flops = train_script.step_flops(tconf, 16, 512)
    ms = statistics.median(step_ms[20:])
    print(f"  {TRAIN_STEPS} steps in {wall:.1f} s; {ms:.3f} ms a step (median of "
          f"steps 20-{TRAIN_STEPS - 1}, CUDA events; min {min(step_ms[20:]):.3f}, "
          f"max {max(step_ms[20:]):.3f}); {flops / 1e12:.4f} TFLOP a step "
          f"(step_flops): {flops / ms / 1e9:.1f} TFLOP/s, bound "
          f"{flops / PEAK_FLOPS * 1e3:.3f} ms at the fp32 peak; peak device memory "
          f"{gib(torch.cuda.max_memory_allocated() - base)} above the "
          f"{gib(base)} held before", flush=True)
    with open(TRAIN_HISTORY) as f:
        ref = {h["step"]: h for h in json.load(f)["history"]}
    for h in hist:
        r = ref.get(h["step"])
        print(f"  step {h['step']:4d}: loss {h['loss']:.4f} (nll {h['nll']:.4f}, "
              f"confidence_bce {h['confidence_bce']:.4f})"
              + ("" if r is None else
                 f"; the JAX trainer's curve {r['loss']:.4f} (another random "
                 f"stream and its 2500-step schedule: context, not a gate)"))
    if not hist[-1]["loss"] < 0.5 * hist[0]["loss"]:
        raise AssertionError(f"training: loss {hist[0]['loss']} -> "
                             f"{hist[-1]['loss']}, not halved")
    return tree


def trained_serving_phase(tree):
    """The tree train_synthetic returned, served through LightGlue(params=)
    at the default configuration on a planted pair at 1024 keypoints, fixed
    and adaptive: B5, B6 and B2 launched, and held against the CPU port on
    the same tree as phase 3a holds its pairs; the adaptive call exits
    before the last layer. Its launch counts stay out of the kernels
    line."""
    pr = planted_pairs(np.random.default_rng(29), 1, 1024)
    data = {"image0": feats(pr, 0), "image1": feats(pr, 1)}
    for mode, c in (("fixed", FIXED), ("adaptive", {})):
        phase(f"3h main path: the trained tree through LightGlue(params=tree), "
              f"default configuration, {mode}, a planted pair at 1024 keypoints")
        gpu = LightGlue("superpoint", params=tree, device="cuda", **c)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = gpu(data)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        print(f"  launch counts: { {k: n for k, n in counts.items() if n} }")
        for kname in ("fused_self_block", "fused_cross_block",
                      "fused_filter_matches"):
            if counts[kname] < 1:
                raise AssertionError(f"{kname} was not launched")
        ref = LightGlue("superpoint", params=tree, device="cpu", **c)(data)
        k, prec = precision(got, pr["gt_matches0"])
        agree = float((ref["matches0"] == got["matches0"]).mean())
        pruned = sum(int((ref[f] != got[f]).sum()) for f in ("prune0", "prune1"))
        gap = score_gap(got, ref)
        print(f"  stop {got['stop']} vs {ref['stop']} on the CPU port, {k} matches, "
              f"precision {prec:.3f} against the planted truth; matches0 agreement "
              f"{agree:.6f}, {pruned} points whose prune differs, score diff "
              f"{gap:.2e} (tol {MATCH_SCORE_TOL:g})", flush=True)
        if (agree < 0.999 or got["stop"] != ref["stop"] or pruned
                or gap > MATCH_SCORE_TOL):
            raise AssertionError(f"trained tree, {mode}: the card disagrees "
                                 "with the CPU port")
        if mode == "adaptive" and got["stop"] >= gpu.conf.n_layers:
            raise AssertionError(f"trained tree, adaptive: stop {got['stop']}, "
                                 "no early exit")


def host_runtime_phase(params, traffic):
    """The C++ host runtime (native.py): built and loaded, each entry point
    equal to its numpy form on phase 3e's traffic: compact_matches on every
    padded batch's outputs, pack_ragged on the pairs' descriptors, and
    filter_matches_host on the trained matcher's last log assignment of the
    first pair (on the card, the plain ops)."""
    phase("3h the C++ host runtime (native.py) against its numpy forms on "
          "phase 3e's traffic")
    t0 = time.perf_counter()
    path = native.build()
    native.library()
    print(f"  {path.relative_to(ROOT)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    n = 0
    for m0, ms0 in traffic["outputs"]:
        got, want = native.compact_matches(m0, ms0), native.compact_matches_numpy(m0, ms0)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                raise AssertionError("compact_matches differs from its numpy form")
        n += sum(len(p) for p in got[0])
    m0, ms0 = max(traffic["outputs"], key=lambda o: o[0].size)
    t_lib = host_ms(lambda: native.compact_matches(m0, ms0), 50)[1]
    t_np = host_ms(lambda: native.compact_matches_numpy(m0, ms0), 50)[1]
    print(f"  compact_matches: {len(traffic['outputs'])} batches, {n} matches, "
          f"equal to numpy; at {m0.shape} {t_lib:.4f} ms against numpy's "
          f"{t_np:.4f} (host clock)")
    arrays = [f0["descriptors"] for f0, _ in traffic["pairs"]]
    for k in (1024, 2048):
        got, want = native.pack_ragged(arrays, k), native.pack_ragged_numpy(arrays, k)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("pack_ragged differs from its numpy form")
    print(f"  pack_ragged: {len(arrays)} descriptor arrays at K 1024 and 2048, "
          "equal to numpy")
    f0, f1 = traffic["pairs"][0]
    conf = lightglue_config("superpoint").replace(**TRAIN_CONF)
    dev = {k: torch.from_numpy(np.asarray(v, np.float32))[None].cuda()
           for k, v in (("k0", f0["keypoints"]), ("k1", f1["keypoints"]),
                        ("d0", f0["descriptors"]), ("d1", f1["descriptors"]),
                        ("s0", f0["image_size"]), ("s1", f1["image_size"]))}
    cuda_params = nn.params_to(params, torch.device("cuda"))
    with torch.no_grad():
        all0, all1 = train.forward_all_layers(cuda_params, conf, train.SyntheticBatch(
            dev["k0"], dev["k1"], dev["d0"], dev["d1"], dev["s0"], dev["s1"], None))
        la = nn.index_params(cuda_params["log_assignment"], conf.n_layers - 1)
        scores = asg.match_assignment(la, all0[-1], all1[-1])[0]
        m0_dev = asg.filter_matches(scores, conf.filter_threshold)[0]
    inner = scores[0, :-1, :-1].cpu().numpy()
    got = native.filter_matches_host(inner, conf.filter_threshold)
    want = native.filter_matches_host_numpy(inner, conf.filter_threshold)
    serr = float(np.abs(got[1] - want[1]).max())
    if not np.array_equal(got[0], want[0]) or serr > 1e-6:
        raise AssertionError("filter_matches_host differs from its numpy form")
    agree = float((got[0] == m0_dev[0].cpu().numpy()).mean())
    print(f"  filter_matches_host on {inner.shape}: matches0 equal to numpy "
          f"({int((got[0] >= 0).sum())} matches), scores within {serr:.1e}; "
          f"agreement with the device's filter_matches {agree:.6f}", flush=True)


def training_phase(params, traffic):
    """Phase 3h."""
    train_step_phase()
    tree = train_run_phase()
    trained_serving_phase(tree)
    host_runtime_phase(params, traffic)
    del tree
    gc.collect()
    torch.cuda.empty_cache()


def train_profile_phase():
    """Where a training step's time goes: the superpoint preset, 9 layers,
    B 16, m 512, from the seeded initial tree."""
    phase("P profile: a training step, superpoint preset, 9 layers, B 16, "
          "m 512 (torch.profiler; fp32, TF32 off)")
    conf = lightglue_config("superpoint").replace(**TRAIN_CONF)
    params = nn.map_params(lg.init_params(conf, torch.Generator().manual_seed(0)),
                           lambda t: t.cuda())
    opt = train.make_optimizer(params, 2e-4, TRAIN_STEPS)
    step = train.make_train_step(conf, opt, 16, 512,
                                 torch.Generator("cuda").manual_seed(1))
    profile_call("a training step, B 16, m 512", step, calls=3, top=10)


# --- phase 3i: the data-parallel mesh -------------------------------------------

# The JAX bench's headline (bench.py:658-660) with the trained weights:
# adaptive, mp, shift 12, 1024 keypoints, B 16; and 13 ragged requests (the
# JAX dry run's count, __graft_entry__.py:226-239) of 900-1024 keypoints
MESH_CONF = dict(mp=True, **SHIFTED)
MESH_KPTS, MESH_BATCH, MESH_RAGGED = 1024, 16, 13
# the kernels every slot's graphs launch at the headline (B5, B6 in bf16,
# B2), and every slot of the windowed pipeline (B7-B9, then B5, B6, B2)
MESH_KERNELS = ("fused_self_block_bf16", "fused_cross_block_bf16",
                "fused_filter_matches")
MESH_PIPELINE_KERNELS = SEQUENCE_KERNELS
MESH_TRAIN_STEPS, MESH_REPS = 3, 10
# A slot runs its block of the batch at a smaller batch, where tile_plan,
# bf16_plan and the walk's split plan may pick other tiles and splits (sums
# in another order): each mesh run is held against the one-slot run of the
# same call by matches0's agreement share (phase 3e's) and the same stop.
# Its matching scores are held within MATCH_SCORE_TOL in fp32 and on one
# slot. At mp each bf16 rounding of another tile plan moves them (an H100
# 80GB HBM3 at 700 W, the headline at B 8 a slot against B 16, where the
# matches agree: up to 3.17e-2 (B 16) and 2.67e-2 (the 13 ragged
# requests), 99.9th percentile 1.26e-2 and 1.57e-2, median 0; phase 5c
# gates no mp score either): there they are held within twice the largest
# reading and the 99.9th percentile within twice its largest, and each
# slot's rows are held to the bit against the one-slot runner at the
# slot's batch on the same rows, which picks the same plans
MESH_AGREE = 0.999
MESH_MP_SCORE_TOL, MESH_MP_SCORE_P999_TOL = 6.4e-2, 3.2e-2


def mesh_meshes():
    """(label, mesh): every visible card, two slots on card 0, and a (2, 1)
    hosts x cards mesh (two cards where there are, else card 0 twice)."""
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return (("every visible card", make_mesh()),
            ("two slots on card 0", make_mesh(devices=["cuda:0"] * 2)),
            ("(2, 1) hosts x cards", make_mesh(
                devices=(cards * 2)[:2], axis_names=("dcn", "data"),
                shape=(2, 1))))


def slot_launches(runner):
    """Each slot's launch counts of a batched runner (one slot: its own)."""
    counts = runner.launches
    return counts if isinstance(counts, list) else [counts]


def mesh_agree(label, got, want, tol, p999_tol=None):
    """BatchMatcher results of a mesh against the one-slot run's, pair by
    pair: matches0's agreement share, the stops, the largest score gap
    where matches0 agree (held within ``tol``) and its 99.9th percentile
    (held within ``p999_tol``; None: printed)."""
    same = [g["matches0"] == w["matches0"] for g, w in zip(got, want)]
    agree = float(np.concatenate(same).mean())
    stops = sorted({(g["stop"], w["stop"]) for g, w in zip(got, want)})
    gaps = np.concatenate([np.abs(g["matching_scores0"] - w["matching_scores0"])[e]
                           for g, w, e in zip(got, want, same)])
    p999 = float(np.percentile(gaps, 99.9))
    print(f"  {label} against one slot: matches0 agreement {agree:.6f}, "
          f"stops (mesh, one slot) {stops}, score diff where matches0 agree "
          f"{gaps.max():.2e} (tol {tol:g}; 99.9th percentile {p999:.2e}, tol "
          f"{'none' if p999_tol is None else f'{p999_tol:g}'})", flush=True)
    if (agree < MESH_AGREE or any(a != b for a, b in stops)
            or gaps.max() > tol or (p999_tol is not None and p999 > p999_tol)):
        raise AssertionError(f"{label}: the mesh run disagrees with one slot")


def mesh_slot_rows(label, conf, params, mesh, batch, got):
    """Each slot's rows of a mesh run of ``batch`` (the chunk as the mesh
    ran it, dummy pairs included; ``got``: the results of its first
    len(got) pairs) against the one-slot runner at the slot's batch on
    those rows alone (the same kernels and plans), to the bit where that
    run's own stop is the pooled one. Raises if no slot could be
    compared."""
    per = len(batch) // mesh.size
    solo = BatchMatcher(conf, params, buckets=(MESH_KPTS,), max_batch=per)
    compared = 0
    for k in range(mesh.size):
        rows = range(k * per, (k + 1) * per)
        ref = solo.match_pairs([batch[i] for i in rows])
        if ref[0]["stop"] != got[0]["stop"]:
            print(f"  {label}, slot {k}: its rows alone stop at {ref[0]['stop']}, "
                  f"the pooled batch at {got[0]['stop']}: not compared")
            continue
        mine = [(i, r) for i, r in zip(rows, ref) if i < len(got)]
        differ = sorted({f for i, r in mine for f in r
                         if not np.array_equal(got[i][f], r[f])})
        print(f"  {label}, slot {k}: rows {rows.start}-{rows.stop - 1} "
              f"({len(mine)} requests) {'equal to the bit to' if not differ else 'DIFFER from'} "
              f"the one-slot runner at B {per} on them alone {differ or ''}")
        if differ:
            raise AssertionError(f"{label} slot {k}: its rows differ in {differ}")
        compared += 1
    del solo
    if not compared:
        raise AssertionError(f"{label}: no slot's rows stop alone where the "
                             "pooled batch stops: nothing compared")


def mesh_serving_phase(params, smi):
    """Phase 3i's serving part: BatchMatcher at the headline over each mesh
    of mesh_meshes, against the one-slot BatchMatcher on the same B 16
    planted pairs and 13 ragged requests; each slot's launches of B5, B6
    and B2; host ms of a B 16 call on one slot and on two slots of card 0,
    in turns. Returns the launch counts of the mesh runs."""
    total = dict.fromkeys(KERNELS, 0)
    conf = lightglue_config("superpoint", **MESH_CONF)
    rng = np.random.default_rng(47)
    pr = planted_pairs(rng, MESH_BATCH, MESH_KPTS)
    pairs = [tuple({"keypoints": pr[f"keypoints{s}"][i],
                    "descriptors": pr[f"descriptors{s}"][i],
                    "image_size": pr["image_size"][i]} for s in (0, 1))
             for i in range(MESH_BATCH)]
    ragged = []
    for _ in range(MESH_RAGGED):
        k1 = int(rng.integers(900, MESH_KPTS + 1))
        r = planted_pairs(rng, 1, int(rng.integers(900, k1 + 1)), k1)
        ragged.append(tuple({"keypoints": r[f"keypoints{s}"][0],
                             "descriptors": r[f"descriptors{s}"][0],
                             "image_size": r["image_size"][0]} for s in (0, 1)))
    one = BatchMatcher(conf, params, buckets=(MESH_KPTS,), max_batch=MESH_BATCH)
    want = {"b16": one.match_pairs(pairs), "ragged": one.match_pairs(ragged)}
    k, prec = precision({"matches0": np.stack([r["matches0"] for r in want["b16"]])},
                        pr["gt_matches0"])
    print(f"  one slot (no mesh): B {MESH_BATCH} stop {want['b16'][0]['stop']}, "
          f"{k} matches, precision {prec:.3f}; {MESH_RAGGED} ragged requests "
          f"stop {want['ragged'][0]['stop']}", flush=True)
    matchers = {}
    for label, mesh in mesh_meshes():
        phase(f"3i main path: BatchMatcher over a mesh ({label}: "
              f"{[str(d) for d in mesh.slots]}, shape {mesh.shape}), trained "
              f"weights, adaptive, mp, shift 12, {MESH_KPTS} keypoints, B "
              f"{MESH_BATCH} and {MESH_RAGGED} ragged requests")
        bm = BatchMatcher(conf, params, buckets=(MESH_KPTS,),
                          max_batch=MESH_BATCH, mesh=mesh)
        bm.match_pairs(pairs)  # the first sight captures every slot's graphs
        for counts in slot_launches(bm._matcher):
            counts.clear()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = {"b16": bm.match_pairs(pairs), "ragged": bm.match_pairs(ragged)}
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        for kname, c in counts.items():
            total[kname] += c
        per_slot = slot_launches(bm._matcher)
        for i, c in enumerate(per_slot):
            print(f"  slot {i} ({mesh.slots[i]}): launches "
                  f"{ {k_: v for k_, v in sorted(c.items()) if v} }")
            for kname in MESH_KERNELS:
                if not c.get(kname):
                    raise AssertionError(f"{label} slot {i}: {kname} not launched")
        print(f"  batches rounded to {bm._round_batch(MESH_RAGGED, MESH_BATCH)} "
              f"for {MESH_RAGGED} requests ({mesh.size} slots), the dummies "
              "copies of the first request")
        rounded = bm._round_batch(MESH_RAGGED, MESH_BATCH)
        batches = {"b16": pairs,
                   "ragged": ragged + [ragged[0]] * (rounded - MESH_RAGGED)}
        for part in ("b16", "ragged"):
            if mesh.size == 1:
                mesh_agree(f"{label}, {part}", got[part], want[part],
                           MATCH_SCORE_TOL)
                continue
            mesh_agree(f"{label}, {part}", got[part], want[part],
                       MESH_MP_SCORE_TOL, MESH_MP_SCORE_P999_TOL)
            mesh_slot_rows(f"{label}, {part}", conf, params, mesh,
                           batches[part], got[part])
        matchers[label] = bm
    phase(f"3i timing: BatchMatcher B {MESH_BATCH} at the headline, one slot "
          f"against two slots on card 0 (host clock, {MESH_REPS} calls a turn, "
          f"in turns); {smi}")
    runs = {"one slot": one, "two slots": matchers["two slots on card 0"]}
    ms = {k: [] for k in runs}
    for label in ("one slot", "two slots", "two slots", "one slot"):
        ms[label].append(float(np.median(serving_ms(runs[label], pairs,
                                                    MESH_REPS)[0])))
    for label, v in ms.items():
        print(f"  BatchMatcher {label}: {v[0]:.3f} / {v[1]:.3f} ms a call of "
              f"{MESH_BATCH} pairs ({MESH_BATCH / min(v) * 1e3:.1f} pairs/s at "
              f"the faster turn)", flush=True)
    del one, matchers, runs
    gc.collect()
    torch.cuda.empty_cache()
    return total


def mesh_train_phase(smi):
    """Phase 3i's training part: phase 3h's size (superpoint preset, 9 layers,
    B 16, m 512, fp32) over two slots on card 0 against one slot: the
    loss and every leaf's gradient of one backward (phase 3h's
    tolerances), then MESH_TRAIN_STEPS steps, their losses and ms a step,
    in turns."""
    phase(f"3i main path: a training step over two slots on card 0, superpoint "
          f"preset, 9 layers, B 16, m 512, fp32 (TF32 off), against one slot")
    conf = lightglue_config("superpoint").replace(**TRAIN_CONF)
    init = lg.init_params(conf, torch.Generator().manual_seed(7))
    gen = torch.Generator("cuda").manual_seed(8)
    batches = [train.synthetic_batch(gen, 16, 512)
               for _ in range(MESH_TRAIN_STEPS + 1)]
    mesh = make_mesh(devices=["cuda:0"] * 2)
    home = torch.device("cuda", 0)
    res = {}
    for label, m in (("one slot", None), ("two slots", mesh)):
        params = nn.map_params(init, lambda t: t.to(home, copy=True)
                               .requires_grad_(True))
        with train.fp32_math():
            if m is None:
                loss, _ = train.matcher_loss(params, conf, batches[0])
                loss.backward()
            else:
                loss = train.mesh_backward({home: params}, conf, batches[0],
                                           m)["loss"]
        res[label] = (float(loss.detach()), weights_lib.flatten_params(
            nn.map_params(params, lambda t: t.grad)))
    (l1, g1), (l2, g2) = res["one slot"], res["two slots"]
    rel = abs(l2 - l1) / abs(l1)
    errs = {k: float(np.abs(g2[k] - g1[k]).max() / np.abs(g1[k]).max()) for k in g1}
    worst = max(errs, key=errs.get)
    print(f"  loss {l2:.7f} (two slots) vs {l1:.7f} (one slot): relative "
          f"{rel:.3e} (tol {TRAIN_LOSS_TOL:g}); gradients, {len(errs)} leaves: "
          f"largest error {errs[worst]:.3e} of its leaf's largest |grad| "
          f"({worst}; tol {TRAIN_GRAD_TOL:g})", flush=True)
    if not (rel <= TRAIN_LOSS_TOL and errs[worst] <= TRAIN_GRAD_TOL):
        raise AssertionError("the two-slot training step disagrees with one slot")
    losses, ms = {}, {"one slot": [], "two slots": []}
    for label in ("one slot", "two slots", "two slots", "one slot"):
        params = nn.map_params(init, lambda t: t.to(home, copy=True))
        step = train.make_feed_train_step(
            conf, train.make_optimizer(params, 2e-4, 1500),
            None if label == "one slot" else mesh)
        out, times = [], []
        for b in batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(float(step(b)["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        losses[label] = out
        ms[label].append(float(np.median(times[1:])))
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses["two slots"],
                                               losses["one slot"])]
    print(f"  {MESH_TRAIN_STEPS} steps: losses {losses['two slots']} (two slots) "
          f"vs {losses['one slot']}: largest relative gap {max(gaps):.3e}; ms a "
          f"step (host clock, median of steps 2-{MESH_TRAIN_STEPS}, in turns): "
          f"one slot {ms['one slot'][0]:.3f} / {ms['one slot'][1]:.3f}, two "
          f"slots {ms['two slots'][0]:.3f} / {ms['two slots'][1]:.3f}; {smi}",
          flush=True)
    if max(gaps) > TRAIN_LOSS_TOL:
        raise AssertionError("the two-slot steps' losses disagree with one slot")


def mesh_pipeline_phase(mparams, sp_params, smi):
    """Phase 3i's pipeline part: make_windowed_sequence_end_to_end
    (SuperPoint at its published widths, 1024 keypoints, the trained
    matcher, adaptive, fp32) on SEQUENCE_FRAMES generated frames at window
    2 (13 pairs) over two slots on card 0, each slot extracting its 4
    frames and matching its 7 or 6 pairs, against the one-slot program:
    keypoints, descriptors and matches as phase 3f holds match_sequence
    against make_end_to_end, the same stop, and each slot's launches of
    B7-B9, B5, B6 and B2. Returns the launch counts of the mesh run."""
    phase(f"3i main path: make_windowed_sequence_end_to_end over two slots on "
          f"card 0, SuperPoint -> LightGlue (trained, adaptive), "
          f"{SEQUENCE_FRAMES} generated {H}x{W} frames, 1024 keypoints, window 2")
    frames = sequence_frames(np.random.default_rng(43))
    imgs = torch.from_numpy(frames)[..., None].cuda()
    sizes = torch.tensor([[W, H]] * SEQUENCE_FRAMES, dtype=torch.float32,
                         device="cuda")
    conf = lightglue_config("superpoint")
    sconf = SuperPointConfig(max_num_keypoints=1024)
    mcuda = nn.params_to(mparams, "cuda")
    mesh = make_mesh(devices=["cuda:0"] * 2)
    runs = {m: end_to_end.make_windowed_sequence_end_to_end(
        sp.forward, sp_params, sconf, mcuda, conf, window=2, mesh=m)
        for m in (None, mesh)}
    ref = runs[None](imgs, sizes)
    runs[mesh](imgs, sizes)  # warm
    for counts in runs[mesh].launches:
        counts.clear()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = runs[mesh](imgs, sizes)
    torch.cuda.synchronize()
    total = _build.launch_counts()
    for i, c in enumerate(runs[mesh].launches):
        print(f"  slot {i} ({mesh.slots[i]}): launches "
              f"{ {k: v for k, v in sorted(c.items()) if v} }")
        for kname in MESH_PIPELINE_KERNELS:
            if not c.get(kname):
                raise AssertionError(f"pipeline slot {i}: {kname} not launched")
    feats = lambda e, side, i: {  # noqa: E731
        k: getattr(getattr(e, side), k)[i].cpu().numpy()
        for k in ("keypoints", "descriptors", "valid")}
    i0, i1 = end_to_end.sequence_window_pairs(SEQUENCE_FRAMES, 2)
    shared, derr, serr, differ, total_pts = 1.0, 0.0, 0.0, 0, 0
    for p in range(len(i0)):
        common = [common_keypoints(feats(got, s, p), feats(ref, s, p))
                  for s in ("feats0", "feats1")]
        shared = min([shared] + [len(cm) / feats(got, s, p)["valid"].sum()
                                 for s, cm in zip(("feats0", "feats1"), common)])
        derr = max([derr] + [float(np.abs(feats(got, s, p)["descriptors"][cm[:, 0]]
                                          - feats(ref, s, p)["descriptors"][cm[:, 1]]).max())
                             for s, cm in zip(("feats0", "feats1"), common)])
        gm = got.matches.matches0[p].cpu().numpy()
        rm = ref.matches.matches0[p].cpu().numpy()
        gs = got.matches.matching_scores0[p].cpu().numpy()
        rs = ref.matches.matching_scores0[p].cpu().numpy()
        other = {int(i): int(j) for i, j in common[1]}
        for i, j in common[0]:
            total_pts += 1
            differ += (-1 if gm[i] < 0 else other.get(int(gm[i]), -2)) != int(rm[j])
            if gm[i] >= 0 and rm[j] >= 0:
                serr = max(serr, abs(float(gs[i] - rs[j])))
    agree = 1 - differ / max(total_pts, 1)
    print(f"  {len(i0)} pairs against the one-slot program: keypoints shared "
          f"{shared:.6f}, descriptor max_abs_err at shared keypoints {derr:.3e}, "
          f"matches0 agreement {agree:.6f} over {total_pts} shared keypoints, "
          f"matching scores max_abs_err {serr:.3e}, stop {got.matches.stop} vs "
          f"{ref.matches.stop}", flush=True)
    if (shared < 0.99 or derr > 1e-3 or agree < MESH_AGREE
            or serr > MATCH_SCORE_TOL or got.matches.stop != ref.matches.stop):
        raise AssertionError("the sharded pipeline disagrees with one slot")
    ms = {"one slot": [], "two slots": []}
    for label in ("one slot", "two slots", "two slots", "one slot"):
        run = runs[None if label == "one slot" else mesh]
        ms[label].append(float(host_ms(lambda: run(imgs, sizes), 5)[1]))
    print(f"  ms a call of {SEQUENCE_FRAMES} frames (host clock, median of 5, "
          f"in turns): one slot {ms['one slot'][0]:.3f} / {ms['one slot'][1]:.3f}, "
          f"two slots {ms['two slots'][0]:.3f} / {ms['two slots'][1]:.3f}; {smi}",
          flush=True)
    return total


def mesh_phase(params, sp_params, smi):
    """Phase 3i: the data-parallel mesh (parallel/mesh.py) on every path it
    shards. Returns the launch counts of its mesh runs."""
    total = mesh_serving_phase(params, smi)
    mesh_train_phase(smi)
    for k, c in mesh_pipeline_phase(params, sp_params, smi).items():
        total[k] += c
    return total


# --- phase 3j: the released-checkpoint path --------------------------------------

# compaction_accuracy's row in 3j, in fp32 and at mp; the masked adaptive
# path's gt_precision there is held at a floor (the JAX package's
# benchmarks/compaction_accuracy.json reads 0.979 at this row)
WEIGHTS_ROW = dict(kpts=1024, prefix=3, bucket=512, batch=8, seeds=1)
MIN_GT_PRECISION = 0.95


def release_stand_ins(mparams, sp_params, al_params):
    """{registry name: checkpoint}, one seeded state dict an entry of
    weights.REGISTRY in the release file's layout, inside the wrapper its
    unwrap keys expect: the trained matcher as superpoint_lightglue, the
    smoke's SuperPoint, ALIKED (each model at its widths) and DISK
    stand-ins, seeded matchers of the other presets and a seeded HardNet."""
    sds = {
        "superpoint_lightglue": weights_lib.to_state_dict(mparams),
        "superpoint_v1": weights_lib.superpoint_to_state_dict(sp_params),
        "disk_depth": weights_lib.disk_to_state_dict(disk_params("cpu")),
        "hardnet_liberty_aug": weights_lib.hardnet_to_state_dict(
            hardnet.init_params(None, torch.Generator().manual_seed(5))),
    }
    for i, f in enumerate(("disk", "aliked", "sift", "doghardnet")):
        conf = lightglue_config(f)
        sds[f"{f}_lightglue"] = weights_lib.to_state_dict(
            lg.init_params(conf, torch.Generator().manual_seed(10 + i)), conf)
    for name in ("aliked-t16", "aliked-n16", "aliked-n16rot", "aliked-n32"):
        p = al_params if name == "aliked-n16" else aliked_params(name, "cpu")
        sds[name] = weights_lib.aliked_to_state_dict(
            p, ALIKEDConfig(model_name=name))
    out = {}
    for name, sd in sds.items():
        sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
        unwrap = weights_lib.REGISTRY[name].unwrap
        out[name] = {unwrap[0]: sd} if unwrap else sd
    return out


def bits_equal(a, b) -> bool:
    """Nested dicts, lists and tuples of numpy arrays and numbers equal,
    arrays in dtype, shape and every bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bits_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(bits_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b


def fetch_phase(ckpts, cache):
    """Each stand-in saved as {name}.pth in ``cache`` and resolved by
    weights.fetch twice: converted and cached, then (the .pth removed) from
    its npz, each equal to the bit to the direct conversion. Returns the
    direct conversions."""
    direct = {}
    for name, ckpt in ckpts.items():
        spec = weights_lib.REGISTRY[name]
        torch.save(ckpt, cache / f"{name}.pth")
        from_sd = weights_lib._CONVERTERS[spec.converter][0]
        direct[name] = from_sd(weights_lib._unwrap_state_dict(ckpt, spec.unwrap),
                               weights_lib._entry_conf(name))
        want = weights_lib.flatten_params(direct[name])
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = weights_lib.fetch(name)
            ms.append((time.perf_counter() - t0) * 1e3)
            (cache / f"{name}.pth").unlink(missing_ok=True)
            if not bits_equal(weights_lib.flatten_params(got), want):
                raise AssertionError(f"fetch({name!r}) differs from the direct "
                                     "conversion")
        print(f"  fetch {name}: {sum(v.size for v in want.values())} parameters,"
              f" {(cache / f'{name}.npz').stat().st_size / 1e6:.1f} MB npz; host "
              f"ms: convert and cache {ms[0]:.1f}, from the npz {ms[1]:.1f}",
              flush=True)
    return direct


def pretrained_paths(direct):
    """SuperPoint + LightGlue("superpoint") through match_pair (2048
    keypoints: B7, B8, B9, B5, K2 + B4, B2), the same matcher on a planted
    pair at 1024 keypoints (B5, B6, B2; the random SuperPoint's
    descriptors give it nothing to match), ALIKED and
    DISK on one image, each built with pretrained=True and held to the bit
    against the same call with the directly converted params. Returns the
    pretrained calls' launch counts."""
    a, b, _ = image_pair(np.random.default_rng(61), H, W)
    pr = planted_pairs(np.random.default_rng(23), 1, 1024, desc_dim=256)
    planted = {"image0": feats(pr, 0), "image1": feats(pr, 1)}
    total = dict.fromkeys(KERNELS, 0)
    # (label, kernels it must launch, the call given each wrapper's weights
    # argument by registry name)
    runs = (
        ("SuperPoint + LightGlue('superpoint'): match_pair", EXTRACTION_KERNELS,
         lambda kw: match_pair(SuperPoint(**kw("superpoint_v1")),
                               LightGlue("superpoint", **kw("superpoint_lightglue")),
                               a, b)),
        ("LightGlue('superpoint'): a planted pair", MATCHER_BY_KPTS[1024][0],
         lambda kw: LightGlue("superpoint", **kw("superpoint_lightglue"))(planted)),
        ("ALIKED (aliked-n16): extract", ("fused_aliked_stem", "simple_nms"),
         lambda kw: ALIKED(**kw("aliked-n16")).extract(rgb(a))),
        ("DISK: extract", (), lambda kw: DISK(**kw("disk_depth")).extract(a)),
    )
    for label, must, run in runs:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = run(lambda name: {"pretrained": True})
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        add_counts(total, counts)
        want = run(lambda name: {"params": direct[name]})
        print(f"  pretrained=True, {label}: launch counts "
              f"{ {k: c for k, c in counts.items() if c} }", flush=True)
        for k in must:
            if counts[k] < 1:
                raise AssertionError(f"{label}: {k} was not launched")
        if not bits_equal(got, want):
            raise AssertionError(f"{label}: pretrained=True differs from the "
                                 "directly converted params")
        if isinstance(got, tuple):
            print(f"    {int((got[2]['matches0'] >= 0).sum())} matches, stop "
                  f"{got[2]['stop']}; equal to the bit", flush=True)
        elif "matches0" in got:
            k, prec = precision(got, pr["gt_matches0"])
            print(f"    {k} matches, precision {prec:.3f}, stop {got['stop']}; "
                  "equal to the bit", flush=True)
            if prec < 0.8:
                raise AssertionError(f"{label}: precision {prec} < 0.8")
    return total


def compaction_phase(mparams, smi):
    """compaction_accuracy's functions for WEIGHTS_ROW on the card, in fp32
    and at mp (the trained matcher); the masked path's gt_precision held
    at MIN_GT_PRECISION."""
    r = WEIGHTS_ROW
    batches = ca.batches([r["kpts"]], r["batch"], r["seeds"], torch.device("cuda"))
    params = nn.params_to(mparams, "cuda")
    for mp in (False, True):
        tag = "mp" if mp else "fp32"
        t0 = time.perf_counter()
        (row,) = ca.grid(params, lightglue_config("superpoint", mp=mp), batches,
                         [r["prefix"]], [r["bucket"]],
                         log=lambda line: print(f"  {tag}: {line}", flush=True))
        print(f"  {tag}: {time.perf_counter() - t0:.2f} s; {smi}", flush=True)
        if row["exact_masked"]["gt_precision"] < MIN_GT_PRECISION:
            raise AssertionError(f"{tag}: the masked path's gt_precision "
                                 f"{row['exact_masked']['gt_precision']} < "
                                 f"{MIN_GT_PRECISION}")


def weights_phase(mparams, sp_params, al_params, smi):
    """Phase 3j: every registry entry through weights.fetch in a temporary
    cache (no download: _download raises), then pretrained=True on
    SuperPoint, LightGlue, ALIKED and DISK with that cache as the default,
    and compaction_accuracy's row. Returns the pretrained calls' counts."""
    phase("3j the released-checkpoint path: weights.fetch for every registry "
          "entry (a seeded stand-in a release file), pretrained=True through "
          "the cache, compaction_accuracy's row")
    t0 = time.perf_counter()
    ckpts = release_stand_ins(mparams, sp_params, al_params)
    download, cache_dir = weights_lib._download, weights_lib.default_cache_dir

    def offline(url, dest, retries=2, timeout=30.0):
        raise weights_lib.WeightsUnavailableError(f"{url}: no network here")

    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp)
        weights_lib._download = offline
        weights_lib.default_cache_dir = lambda: cache
        try:
            counts = pretrained_paths(fetch_phase(ckpts, cache))
        finally:
            weights_lib._download, weights_lib.default_cache_dir = download, cache_dir
    compaction_phase(mparams, smi)
    print(f"  phase 3j: {time.perf_counter() - t0:.1f} s", flush=True)
    return counts

def sequence_frames(rng):
    """SEQUENCE_FRAMES generated H x W frames: textures and their warps."""
    return np.stack([img for _ in range(SEQUENCE_FRAMES // 2)
                     for img in image_pair(rng, H, W)[:2]])


def sequence_phase(mparams, sp_params):
    """Phase 3f: pipeline.match_sequence on the card, each pair against
    make_end_to_end on that pair, and the first frames against the CPU
    port. Returns the launch counts of the sequence calls."""
    phase(f"3f main path: match_sequence(SuperPoint, LightGlue), "
          f"{SEQUENCE_FRAMES} generated {H}x{W} frames, 1024 keypoints, "
          f"windows {SEQUENCE_WINDOWS}, fixed, filter_threshold 0")
    frames = sequence_frames(np.random.default_rng(43))
    ext = SuperPoint(params=sp_params, max_num_keypoints=1024, device="cuda")
    mconf = dict(FIXED, filter_threshold=0.0)  # every mutual pair: matches
    matcher = LightGlue("superpoint", params=mparams, device="cuda", **mconf)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    outs = {w: match_sequence(ext, matcher, frames, window=w)
            for w in SEQUENCE_WINDOWS}
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"  launch counts: { {k: c for k, c in counts.items() if c} }")
    for kname in SEQUENCE_KERNELS:
        if counts[kname] < 1:
            raise AssertionError(f"{kname} was not launched on the path")
    if counts["fused_stem"] != len(SEQUENCE_WINDOWS):
        raise AssertionError("an image was extracted more than once")

    # the composition, to the bit: the features are SuperPoint's forward on
    # the whole sequence, each window's matches one matcher call on them
    imgs = torch.from_numpy(frames)[..., None].cuda()
    sizes = torch.tensor([[W, H]] * SEQUENCE_FRAMES, dtype=torch.float32,
                         device="cuda")
    with torch.inference_mode():
        fs = sp.forward(ext.params, ext.conf, imgs, sizes)
        for w, (f, pr) in outs.items():
            i0, i1 = (torch.from_numpy(i).cuda().long() for i in (pr["i0"], pr["i1"]))
            m = lg.forward(matcher.params, matcher.conf,
                           kpts0=fs.keypoints[i0], kpts1=fs.keypoints[i1],
                           desc0=fs.descriptors[i0], desc1=fs.descriptors[i1],
                           size0=sizes[i0], size1=sizes[i1],
                           mask0=fs.valid[i0], mask1=fs.valid[i1])
            differ = [k for k, a, b in (
                ("keypoints", f["keypoints"], fs.keypoints),
                ("descriptors", f["descriptors"], fs.descriptors),
                ("valid", f["valid"], fs.valid),
                ("matches0", pr["matches0"], m.matches0),
                ("matching_scores0", pr["matching_scores0"], m.matching_scores0))
                if not np.array_equal(a, b.cpu().numpy())]
            print(f"  window {w}: {len(pr['i0'])} pairs, "
                  f"{sum(len(x) for x in pr['matches'])} matches; features and "
                  f"matches {'equal to the bit to' if not differ else 'DIFFER from'}"
                  f" one SuperPoint forward and one matcher call on its "
                  f"gathered features {differ or ''}")
            if differ:
                raise AssertionError(f"window {w}: match_sequence differs in {differ}")

    # each pair against make_end_to_end on that pair alone (B 1)
    run = end_to_end.make_end_to_end(sp.forward, ext.params, ext.conf,
                                     matcher.params, matcher.conf)
    size = sizes[:1]
    for w, (f, pr) in outs.items():
        same = dict.fromkeys(("keypoints", "descriptors", "matches0",
                              "matching_scores0"), True)
        shared, derr, serr, differ = 1.0, 0.0, 0.0, 0
        for p, (a, c) in enumerate(zip(pr["i0"], pr["i1"])):
            ref = run(imgs[a:a + 1], imgs[c:c + 1], size, size)
            side = [{k: getattr(getattr(ref, f"feats{s}"), k)[0].cpu().numpy()
                     for k in ("keypoints", "descriptors", "valid")} for s in (0, 1)]
            mine = [{k: f[k][i] for k in ("keypoints", "descriptors", "valid")}
                    for i in (a, c)]
            rm0 = ref.matches.matches0[0].cpu().numpy()
            rs0 = ref.matches.matching_scores0[0].cpu().numpy()
            for k in ("keypoints", "descriptors"):
                same[k] &= all(np.array_equal(x[k], y[k]) for x, y in zip(mine, side))
            same["matches0"] &= bool(np.array_equal(pr["matches0"][p], rm0))
            same["matching_scores0"] &= bool(np.array_equal(pr["matching_scores0"][p], rs0))
            common = [common_keypoints(x, y) for x, y in zip(mine, side)]
            shared = min([shared] + [len(cm) / x["valid"].sum()
                                     for cm, x in zip(common, mine)])
            derr = max([derr] + [float(np.abs(x["descriptors"][cm[:, 0]]
                                              - y["descriptors"][cm[:, 1]]).max())
                                 for cm, x, y in zip(common, mine, side)])
            other = {int(i): int(j) for i, j in common[1]}
            gm = pr["matches0"][p]
            for i, j in common[0]:
                differ += (-1 if gm[i] < 0 else other.get(int(gm[i]), -2)) != int(rm0[j])
                if gm[i] >= 0 and rm0[j] >= 0:
                    serr = max(serr, abs(float(pr["matching_scores0"][p][i] - rs0[j])))
        print(f"  window {w} against make_end_to_end on each pair alone: "
              + ", ".join(f"{k} {'equal to the bit' if v else 'not to the bit'}"
                          for k, v in same.items())
              + f"; keypoints shared {shared:.6f}, descriptor max_abs_err at "
              f"shared keypoints {derr:.3e}, {differ} shared keypoints whose "
              f"match differs, matching scores max_abs_err {serr:.3e}", flush=True)
        if shared < 0.99 or derr > 1e-3 or differ or serr > MATCH_SCORE_TOL:
            raise AssertionError(f"window {w}: match_sequence and "
                                 "make_end_to_end disagree")

    # the first three frames through the CPU port: shared keypoints, their
    # descriptors and matches against the card's window-1 pairs
    cpu_ext = SuperPoint(params={k: {kk: vv.cpu() for kk, vv in v.items()}
                                 for k, v in sp_params.items()},
                         max_num_keypoints=1024, device="cpu")
    cpu_m = LightGlue("superpoint", params=mparams, device="cpu", **mconf)
    cf, cpr = match_sequence(cpu_ext, cpu_m, frames[:3], window=1)
    gf, gpr = outs[1]
    img = lambda fd, i: {"keypoints": fd["keypoints"][i],
                         "descriptors": fd["descriptors"][i],
                         "valid": fd["valid"][i]}
    for p in range(2):
        common = [common_keypoints(img(gf, p + s), img(cf, p + s)) for s in (0, 1)]
        shares = [len(cm) / gf["valid"][p + s].sum() for s, cm in enumerate(common)]
        derr = max(float(np.abs(gf["descriptors"][p + s][cm[:, 0]]
                                - cf["descriptors"][p + s][cm[:, 1]]).max())
                   for s, cm in enumerate(common))
        other = {int(i): int(j) for i, j in common[1]}
        gm, cm0 = gpr["matches0"][p], cpr["matches0"][p]
        differ = sum((-1 if gm[i] < 0 else other.get(int(gm[i]), -2)) != int(cm0[j])
                     for i, j in common[0])
        print(f"  pair ({p}, {p + 1}) against the CPU port: keypoints shared "
              f"{shares[0]:.6f} / {shares[1]:.6f}, descriptor max_abs_err "
              f"{derr:.3e}, {int((gm >= 0).sum())} vs {int((cm0 >= 0).sum())} "
              f"matches, {differ} shared keypoints whose match differs")
        if min(shares) < 0.99 or derr > 1e-3 or differ:
            raise AssertionError("the card disagrees with the CPU port")
    return counts


def time_cuda(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timing_phase(x, bx, hx, params, params2):
    phase("4a timing (CUDA events; plain = the same function in plain PyTorch; "
          "library = one PyTorch call computing it)")
    q, k, v = x["k1"]
    qk0, qk1, v0, v1, va0, va1 = x["k2"]
    xx, msg, p = x["k3"]
    d0, d1, z0, z1, mk0, mk1 = x["k4"]
    ls0, ls1 = torch.nn.functional.logsigmoid(z0), torch.nn.functional.logsigmoid(z1)
    w5, w6 = block_weights(bx, None)
    x5, enc5, _ = bx["b5"][4]
    x60, x61, m60, m61 = bx["b6"][4]
    g = torch.Generator(device="cuda").manual_seed(9)
    q2, k2, v2 = (rand(g, 4, 2, 1024, 128) for _ in range(3))
    pq0, pq1, pv0, pv1, pva0, pva1 = hx["pair"]
    q_1, k_1, v_1 = (t[:1].contiguous() for t in (q, k, v))
    q2_1, k2_1, v2_1 = (t[:1].contiguous() for t in (q2, k2, v2))
    pair1 = tuple(t[:1].contiguous() for t in hx["pair"])
    w52, x52, enc52 = hx["b5"]
    tbl, idx = hx["gather"]
    idx_long = idx.long()
    pairs = {
        "flash_sdpa": (lambda: flash.flash_sdpa(q, k, v),
                       lambda: flash.flash_sdpa_plain(q, k, v)),
        "fused_cross_attention": (
            lambda: flash_cross.fused_cross_attention(qk0, qk1, v0, v1, va0, va1),
            lambda: flash_cross.fused_cross_attention_plain(qk0, qk1, v0, v1, va0, va1)),
        "fused_ffn_residual": (lambda: ffn.fused_ffn_residual(xx, msg, p),
                               lambda: ffn.fused_ffn_residual_plain(xx, msg, p)),
        "fused_filter_matches": (
            lambda: af._filter_reductions_kernel(d0, d1, ls0, ls1, mk0, mk1),
            lambda: af.filter_reductions_plain(d0, d1, ls0, ls1, mk0, mk1)),
        "fused_self_block": (
            lambda: flash_self.fused_self_block(w5, x5, enc5),
            lambda: flash_self.fused_self_block_plain(w5, x5, enc5)),
        "fused_cross_block": (
            lambda: flash_cross_block.fused_cross_block(w6, x60, x61, m60, m61),
            lambda: flash_cross_block.fused_cross_block_plain(w6, x60, x61, m60, m61)),
        "flash_sdpa_shift": (
            lambda: flash.flash_sdpa(q, k, v, shift=SHIFT),
            lambda: flash.flash_sdpa_plain(q, k, v, shift=SHIFT)),
        "fused_cross_attention_shift": (
            lambda: flash_cross.fused_cross_attention(qk0, qk1, v0, v1, va0, va1,
                                                      shift=SHIFT),
            lambda: flash_cross.fused_cross_attention_plain(qk0, qk1, v0, v1, va0,
                                                            va1, SHIFT)),
        "flash_cross_pair": (
            lambda: flash.flash_cross_pair(pq0, pq1, pv0, pv1, pva0, pva1),
            lambda: flash.flash_cross_pair_plain(pq0, pq1, pv0, pv1, pva0, pva1)),
        # the launch alone: gather_rows adds a host read of the index range
        "gather_rows": (lambda: gather.launch_gather(tbl, idx),
                        lambda: gather.gather_rows_plain(tbl, idx)),
        # head_dim 128 lines of K1 (both variants) and B5
        "flash_sdpa d 128": (lambda: flash.flash_sdpa(q2, k2, v2),
                             lambda: flash.flash_sdpa_plain(q2, k2, v2)),
        "flash_sdpa_shift d 128": (
            lambda: flash.flash_sdpa(q2, k2, v2, shift=SHIFT),
            lambda: flash.flash_sdpa_plain(q2, k2, v2, shift=SHIFT)),
        "fused_self_block 2 x 128": (
            lambda: flash_self.fused_self_block(w52, x52, enc52),
            lambda: flash_self.fused_self_block_plain(w52, x52, enc52)),
        # the attention walk at B 1, the single-pair cells, where it splits
        # its keys
        "flash_sdpa B 1": (lambda: flash.flash_sdpa(q_1, k_1, v_1),
                           lambda: flash.flash_sdpa_plain(q_1, k_1, v_1)),
        "flash_sdpa_shift B 1": (
            lambda: flash.flash_sdpa(q_1, k_1, v_1, shift=SHIFT),
            lambda: flash.flash_sdpa_plain(q_1, k_1, v_1, shift=SHIFT)),
        "flash_sdpa d 128 B 1": (lambda: flash.flash_sdpa(q2_1, k2_1, v2_1),
                                 lambda: flash.flash_sdpa_plain(q2_1, k2_1, v2_1)),
        "flash_sdpa_shift d 128 B 1": (
            lambda: flash.flash_sdpa(q2_1, k2_1, v2_1, shift=SHIFT),
            lambda: flash.flash_sdpa_plain(q2_1, k2_1, v2_1, shift=SHIFT)),
        "flash_cross_pair B 1": (
            lambda: flash.flash_cross_pair(*pair1),
            lambda: flash.flash_cross_pair_plain(*pair1)),
    }
    # the one PyTorch call computing B1's function (both variants): SDPA
    # with the additive key bias (0: every key valid), in fp32; B1' is two
    # such calls, one per direction, with the other image's key bias
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kb = torch.zeros(q.shape[0], 1, 1, q.shape[2], device="cuda")
    bias0 = flash.key_bias(pva0)[:, None, None, :]
    bias1 = flash.key_bias(pva1)[:, None, None, :]
    libraries = {
        "flash_sdpa": ("SDPA", lambda: sdpa(q, k, v, attn_mask=kb)),
        "flash_sdpa_shift": ("SDPA", lambda: sdpa(q, k, v, attn_mask=kb)),
        "flash_sdpa d 128": ("SDPA", lambda: sdpa(q2, k2, v2, attn_mask=kb)),
        "flash_sdpa_shift d 128": ("SDPA",
                                   lambda: sdpa(q2, k2, v2, attn_mask=kb)),
        "flash_cross_pair": ("2 SDPA calls", lambda: (
            sdpa(pq0, pq1, pv1, attn_mask=bias1),
            sdpa(pq1, pq0, pv0, attn_mask=bias0))),
        "gather_rows": ("tbl[idx]", lambda: tbl[idx_long]),
        "flash_sdpa B 1": ("SDPA", lambda: sdpa(q_1, k_1, v_1, attn_mask=kb[:1])),
        "flash_sdpa_shift B 1": ("SDPA",
                                 lambda: sdpa(q_1, k_1, v_1, attn_mask=kb[:1])),
        "flash_sdpa d 128 B 1": ("SDPA",
                                 lambda: sdpa(q2_1, k2_1, v2_1, attn_mask=kb[:1])),
        "flash_sdpa_shift d 128 B 1": (
            "SDPA", lambda: sdpa(q2_1, k2_1, v2_1, attn_mask=kb[:1])),
        "flash_cross_pair B 1": ("2 SDPA calls", lambda: (
            sdpa(pair1[0], pair1[1], pair1[3], attn_mask=bias1[:1]),
            sdpa(pair1[1], pair1[0], pair1[2], attn_mask=bias0[:1]))),
        # K2's function: two SDPA calls, one a direction, each with the
        # other image's key bias
        "fused_cross_attention": ("2 SDPA calls", cross_sdpa(x["k2"])),
        "fused_cross_attention_shift": ("2 SDPA calls", cross_sdpa(x["k2"])),
    }
    block_pairs, block_libs = block_rows(bx)
    pairs.update(block_pairs)
    libraries.update(block_libs)
    cross_pairs, cross_libs = cross_rows()
    pairs.update(cross_pairs)
    libraries.update(cross_libs)
    pairs.update(ffn_rows(x["k3"]))
    times, graph_times = {}, {}
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: report the mean of each pair
        a = time_cuda(plain)
        b = time_cuda(kern)
        c = time_cuda(kern)
        d = time_cuda(plain)
        lib_name, lib_fn = libraries.get(name, (None, None))
        lib = None if lib_fn is None else time_cuda(lib_fn)
        times[name] = ((b + c) / 2, (a + d) / 2, lib)
        print(f"  {name}: kernel {times[name][0]:.4f} ms, plain "
              f"{times[name][1]:.4f} ms (runs {b:.4f}/{c:.4f}, {a:.4f}/{d:.4f})"
              + ("" if lib is None else f", library ({lib_name}) {lib:.4f} ms"),
              flush=True)

    # the attention and block rows' device time: CUDA-graph replays,
    # kernel, library, library, kernel (the eager times above include the
    # wrappers' host work, which a B 1 launch does not hide); a row without
    # a library call: kernel, kernel
    for name in ATTENTION_ROWS + BLOCK_ROWS + CROSS_ROWS + FFN_ROWS:
        kern = pairs[name][0]
        lib_name, lib_fn = libraries.get(name, (None, None))
        if lib_fn is None:
            a, d = (attn_split.graph_ms(kern) for _ in range(2))
            graph_times[name] = ((a + d) / 2, None)
            print(f"  {name}, device time (CUDA graph): kernel {(a + d) / 2:.4f} "
                  f"ms (runs {a:.4f}/{d:.4f})", flush=True)
            continue
        a, b, c, d = (attn_split.graph_ms(f) for f in (kern, lib_fn, lib_fn, kern))
        graph_times[name] = ((a + d) / 2, (b + c) / 2)
        print(f"  {name}, device time (CUDA graph): kernel {(a + d) / 2:.4f} ms, "
              f"library ({lib_name}) {(b + c) / 2:.4f} ms (runs {a:.4f}/{d:.4f}, "
              f"{b:.4f}/{c:.4f})", flush=True)

    # end to end: host clock per call (each call ends in a device-to-host
    # copy of its outputs), median over the calls after two warm-up calls;
    # the default (B5, B6), the composed block configuration and the
    # default with two heads of 128 (B5, B1') in turns
    matchers = {"composed": (params, COMPOSED), "default": (params, {}),
                "2 heads": (params2, TWO_HEADS)}
    order = ("composed", "default", "2 heads", "2 heads", "default", "composed")
    rng = np.random.default_rng(11)
    for bsz, reps in ((1, 20), (16, 6)):
        pr = planted_pairs(rng, bsz, 1024)
        data = {"image0": feats(pr, 0), "image1": feats(pr, 1)}
        for name, c in (("fixed", dict(depth_confidence=-1.0,
                                       width_confidence=-1.0)),
                        ("adaptive", {})):
            ms = {blocks: [] for blocks in matchers}
            stops = {}
            for blocks in order:
                mp, extra = matchers[blocks]
                matcher = LightGlue("superpoint", params=mp, device="cuda",
                                    **c, **extra)
                for _ in range(2):
                    matcher(data)
                for _ in range(reps):
                    t0 = time.perf_counter()
                    out = matcher(data)
                    ms[blocks].append((time.perf_counter() - t0) * 1e3)
                stops[blocks] = out["stop"]
            for blocks, m in ms.items():
                q1, med, q3 = np.percentile(m, [25, 50, 75])
                print(f"  end to end {name} B={bsz} 1024 kpts, {blocks}"
                      f"{' (4 heads)' if blocks != '2 heads' else ''}: "
                      f"{bsz * 1e3 / med:.1f} pairs/s (median {med:.2f} ms per "
                      f"call, quartiles {q1:.2f}-{q3:.2f}, {len(m)} calls, stop "
                      f"{stops[blocks]})", flush=True)
    return times, graph_times


def block_rows(bx):
    """Phase 4's rows of B5 and B6 besides the B 4 ones: at B 1 and 16, and
    their projection and tail at B 1, 4 and 16 (exact, no mask; B6: M 1024
    / N 768, masked, the projection and tail over the rows of both images).
    The projection's library call: torch.addmm in fp32 (cuBLAS SGEMM) at
    the same shape. Returns ({row: (kernel, plain)}, {row: (library name,
    call)})."""
    w5, w6 = block_weights(bx, None)
    g = torch.Generator(device="cuda").manual_seed(16)
    pairs, libs = {}, {}
    for b in BLOCK_BATCHES:
        x5, enc5, _ = bx["b5"][b]
        x60, x61, m60, m61 = bx["b6"][b]
        if b != 4:
            pairs[f"fused_self_block B {b}"] = (
                lambda x5=x5, enc5=enc5: flash_self.fused_self_block(w5, x5, enc5),
                lambda x5=x5, enc5=enc5: flash_self.fused_self_block_plain(
                    w5, x5, enc5))
            pairs[f"fused_cross_block B {b}"] = (
                lambda a=(x60, x61, m60, m61): flash_cross_block.fused_cross_block(w6, *a),
                lambda a=(x60, x61, m60, m61): flash_cross_block.fused_cross_block_plain(
                    w6, *a))
        for blk, w, xs, groups, enc in (("B5", w5, [x5], 3, enc5),
                                        ("B6", w6, [x60, x61], 2, None)):
            pairs[f"{blk} projection B {b}"] = (
                lambda w=w, xs=xs, gr=groups, e=enc: block_tc.project(w, xs, gr, e),
                lambda w=w, xs=xs, gr=groups, e=enc: block_tc.project_plain(
                    w, xs, gr, e))
            rows = torch.cat([x.reshape(-1, 256) for x in xs])
            libs[f"{blk} projection B {b}"] = (
                "addmm", lambda w=w, rows=rows: torch.addmm(
                    w["b_in"], rows, w["w_in"].t()).reshape(rows.shape[0], -1))
            ctxs = [rand(g, b, 4, x.shape[1], 64) for x in xs]
            pairs[f"{blk} tail B {b}"] = (
                lambda w=w, c=ctxs, xs=xs: block_tc.tail_chain(w, c, xs),
                lambda w=w, c=ctxs, xs=xs: block_tc.tail_chain_plain(w, c, xs))
    return pairs, libs


def cross_sdpa(x, scale=None):
    """K2's function on x = (qk0, qk1, v0, v1, valid0, valid1) as one
    PyTorch call a direction: SDPA of image 0's queries over image 1's
    keys (image 1's key bias) and the reverse; ``scale`` None is SDPA's
    1 / sqrt(head_dim), B6's attention folds it into qk (1.0)."""
    qk0, qk1, v0, v1, va0, va1 = x
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b0, b1 = (flash.key_bias(va).to(qk0.dtype)[:, None, None, :]
              for va in (va0, va1))
    return lambda: (sdpa(qk0, qk1, v1, attn_mask=b1, scale=scale),
                    sdpa(qk1, qk0, v0, attn_mask=b0, scale=scale))


def cross_rows():
    """Phase 4's rows of K2 and B2 besides the B 4 ones under the kernel
    names: K2 exact (fused_cross_attention) at B 1 and 16, B6's attention
    (launch_cross in mode EXACT_BLOCK on qk scaled as B6 folds it) at B 1,
    4 and 16, both at (B, 4, M 1024 / N 768, 64) masked; B2 at B 1 and 16,
    1024 x 1024, D 256, masked. Returns ({row: (kernel, plain)}, {row:
    (library name, call)}: K2's rows two SDPA calls)."""
    g = torch.Generator(device="cuda").manual_seed(23)
    rng = np.random.default_rng(24)
    pairs, libs = {}, {}
    for b in BLOCK_BATCHES:
        qk0, v0 = rand(g, b, 4, 1024, 64), rand(g, b, 4, 1024, 64)
        qk1, v1 = rand(g, b, 4, 768, 64), rand(g, b, 4, 768, 64)
        va0 = torch.rand(b, 1024, generator=g, device="cuda") < 0.9
        va1 = torch.rand(b, 768, generator=g, device="cuda") < 0.9
        x = (qk0, qk1, v0, v1, va0, va1)
        if b != 4:
            pairs[f"fused_cross_attention B {b}"] = (
                lambda x=x: flash_cross.fused_cross_attention(*x),
                lambda x=x: flash_cross.fused_cross_attention_plain(*x))
            libs[f"fused_cross_attention B {b}"] = ("2 SDPA calls",
                                                    cross_sdpa(x))
        xs = (qk0 * 64 ** -0.25, qk1 * 64 ** -0.25, v0, v1, va0, va1)
        pairs[f"B6 attention B {b}"] = (
            lambda x=xs: flash_cross.launch_cross(
                *x, flash_cross.EXACT_BLOCK, 1.0),
            lambda x=xs: flash_cross_block.cross_block_attention_plain(*x))
        libs[f"B6 attention B {b}"] = ("2 SDPA calls", cross_sdpa(xs, 1.0))
        if b != 4:
            x = b2_inputs(rng, g, b, 1024, 1024)[:6]
            pairs[f"fused_filter_matches B {b}"] = (
                lambda x=x: af._filter_reductions_kernel(*x),
                lambda x=x: af.filter_reductions_plain(*x))
    return pairs, libs


def ffn_rows(k3):
    """Phase 4's rows of B4 besides the B 4 one: {row: (kernel, plain)}
    on ffn_cases' inputs; a pair row's plain version is two plain calls."""
    cases = ffn_cases(k3)
    pairs = {"fused_ffn_residual B 1 2048": cases["(1, 2048, 256)"],
             "fused_ffn_residual B 16": cases["(16, 1024, 256)"]}
    for b, label in FFN_PAIRS.items():
        pairs[f"fused_ffn_residual pair {b}"] = cases[label]
    rows = {name: (lambda c=c: ffn_call(*c),
                   lambda c=c: [ffn.fused_ffn_residual_plain(x, m, c[2])
                                for x, m in zip(c[0], c[1])])
            for name, c in pairs.items()}
    for b, label in FFN_PAIRS.items():
        xs, msgs, p = cases[label]
        rows[f"fused_ffn_residual two calls {b}"] = (
            lambda c=(xs, msgs, p): [ffn.fused_ffn_residual(x, m, c[2])
                                     for x, m in zip(c[0], c[1])],
            rows[f"fused_ffn_residual pair {b}"][1])
    return rows


def ffn_bounds():
    """(FLOPs, bytes) of FFN_ROWS, as kernel_bounds: rows x (lin1 2D x 2D
    and lin2 2D x D products); x, msg in, out written, the weights read
    once a call."""
    f, d = 4, 256
    ffn_w = (2 * d * 2 * d + 2 * d * d + 3 * 2 * d + d) * f
    bound = lambda rows: (rows * 2 * (2 * d * 2 * d + 2 * d * d),  # noqa
                          3 * rows * d * f + ffn_w)
    out = {"fused_ffn_residual": bound(4 * 1024),
           "fused_ffn_residual B 1 2048": bound(2048),
           "fused_ffn_residual B 16": bound(16 * 1024)}
    for b, rows in (("B 1 2048", 2 * 2048), ("B 16", 2 * 16 * 1024)):
        out[f"fused_ffn_residual pair {b}"] = bound(rows)
        two = bound(rows // 2)
        out[f"fused_ffn_residual two calls {b}"] = (2 * two[0], 2 * two[1])
    return out


def cross_bounds():
    """(FLOPs, bytes) of CROSS_ROWS, as kernel_bounds: K2 and B6's
    attention at (B, 4, M 1024 / N 768, 64), the key masks as bytes; B2's
    one score product at (B, 1024, 1024, 256), descriptors, logits and
    masks in, indices and maxima out."""
    f, n, m1, d = 4, 1024, 768, 256
    out = {}
    for b in BLOCK_BATCHES:
        cross = (6 * b * 4 * n * m1 * 64,
                 3 * b * 4 * (n + m1) * 64 * f + b * (n + m1))
        out[f"fused_cross_attention{'' if b == 4 else f' B {b}'}"] = cross
        out[f"B6 attention B {b}"] = cross
        out[f"fused_filter_matches{'' if b == 4 else f' B {b}'}"] = (
            2 * b * n * n * d, (2 * b * n * d + 2 * b * n) * f + 2 * b * n
            + 4 * b * n * f)
    return out


def kernel_bounds():
    """(FLOPs, bytes) of each kernel's function at the shapes timed in
    phase 4: the products it must compute (fp32) and each input read and
    output written once."""
    f = 4  # bytes of fp32
    b, h, n, m1, d = 4, 4, 1024, 768, 256
    ffn_w = (2 * d * 2 * d + 2 * d * d + 3 * 2 * d + d) * f
    attn = (4 * b * h * n * n * 64, 4 * b * h * n * 64 * f)
    attn1 = (attn[0] // b, attn[1] // b)
    # the shared-QK cross attention needs three M N 64 products a (batch,
    # head): the scores once, then P V1 and P^T V0
    cross = (6 * b * h * n * m1 * 64, 3 * b * h * (n + m1) * 64 * f + b * (n + m1))
    self_flops = b * (2 * n * d * 3 * d + 4 * h * n * n * 64 + 2 * n * d * d
                      + 2 * n * (2 * d * 2 * d + 2 * d * d))
    cross_flops = b * (2 * (n + m1) * d * 2 * d + 6 * n * m1 * d
                       + 2 * (n + m1) * d * d
                       + 2 * (n + m1) * (2 * d * 2 * d + 2 * d * d))
    img = 2 * H * W
    return {
        "flash_sdpa": attn,
        "flash_sdpa_shift": attn,
        "fused_cross_attention": cross,
        "fused_cross_attention_shift": cross,
        "fused_filter_matches": (2 * b * n * n * d,
                                 (2 * b * n * d + 2 * b * n) * f + 2 * b * n
                                 + 4 * b * n * f),
        "fused_self_block": (self_flops, (2 * b * n * d + 2 * b * n * 32) * f
                             + (d * 3 * d + 3 * d + d * d + d) * f + ffn_w),
        "fused_cross_block": (cross_flops, 2 * b * (n + m1) * d * f + b * (n + m1)
                              + (d * 2 * d + 2 * d + d * d + d) * f + ffn_w),
        "fused_stem": (img * 2 * 9 * (64 + 64 * 64),
                       (img + img // 4 * 64) * f + (64 * 9 + 64 * 64 * 9 + 128) * f),
        "fused_block2": (img // 4 * 2 * 9 * (64 * 64 + 64 * 64),
                         (img // 4 * 64 + img // 16 * 64) * f
                         + (2 * 64 * 64 * 9 + 128) * f),
        # five (2r + 1)-wide max pools, separable, r 4 (SuperPoint) and r 2
        # (ALIKED): compares, not FLOPs
        "simple_nms": (img * 5 * 2 * 9, 2 * img * f),
        "simple_nms r 2": (img * 5 * 2 * 5, 2 * img * f),
        # aliked-n16 at B 2: conv1 3 -> 16, conv2 16 -> 16 (3x3), 1x1 16 -> 32
        # per pixel; image in, y1 and the pooled map out
        "fused_aliked_stem": (img * 2 * (27 * 16 + 9 * 16 * 16 + 16 * 32),
                              img * (3 + 32 + 16 / 4) * f
                              + (27 * 16 + 9 * 16 * 16 + 16 * 32 + 64) * f),
        # the tail's three 3x3 convs (8 -> 4, 4 -> 4, 4 -> 1) per pixel, plus
        # for B11 three 8-channel two-point lerps in each direction and sums
        "score_head_lazy": (img * (SCORE_CONV + SCORE_LERP),
                            img * (8 + 8 / 4 + 8 / 64 + 8 / 1024 + 1) * f
                            + 468 * f),
        "score_head_cplane": (img * SCORE_CONV, img * (8 + 1) * f + 468 * f),
        # the same at B 1 and B 8
        **{f"{k} B {b}": (v[0] * b / 2, (v[1] - 468 * f) * b / 2 + 468 * f)
           for k, v in (
               ("score_head_lazy", (img * (SCORE_CONV + SCORE_LERP),
                                    img * (8 + 8 / 4 + 8 / 64 + 8 / 1024 + 1) * f
                                    + 468 * f)),
               ("score_head_cplane", (img * SCORE_CONV,
                                      img * (8 + 1) * f + 468 * f)))
           for b in (1, 8)},
        # both directions at (4, 2, M 1024 / N 768, 128): the same products
        # as B3 at four heads of 64
        "flash_cross_pair": (8 * b * 2 * n * m1 * 128,
                             3 * b * 2 * (n + m1) * 128 * f + b * (n + m1)),
        # a copy: the rows out, the table and the indices in, bf16 rows
        "gather_rows": (0, (micro_gather2.N_IDX + micro_gather2.N_ROWS)
                        * micro_gather2.WIDTH * 2 + micro_gather2.N_IDX * 4),
        # the head_dim 128 lines: (4, 2, 1024, 128) and two heads at D 256
        # do the same products and move the same bytes as at four of 64
        "flash_sdpa d 128": attn,
        "flash_sdpa_shift d 128": attn,
        # the B 1 lines: a quarter of the work and of the bytes
        "flash_sdpa B 1": attn1,
        "flash_sdpa_shift B 1": attn1,
        "flash_sdpa d 128 B 1": attn1,
        "flash_sdpa_shift d 128 B 1": attn1,
        "flash_cross_pair B 1": (8 * 2 * n * m1 * 128,
                                 3 * 2 * (n + m1) * 128 * f + (n + m1)),
        "fused_self_block 2 x 128": (self_flops, (2 * b * n * d
                                                  + 2 * b * n * 64) * f
                                     + (d * 3 * d + 3 * d + d * d + d) * f
                                     + ffn_w),
        **block_bounds(),
        **cross_bounds(),
        **ffn_bounds(),
    }


def block_bounds():
    """(FLOPs, bytes) of BLOCK_ROWS, as kernel_bounds: B5 at N 1024, B6 at
    M 1024 / N 768 (its key masks as bytes), D 256, four heads of 64; the
    projection (x, w_in, b_in, rotary tables in; q, k, v or qk, v out) and
    the tail (context and x in, weights, x's shape out)."""
    f, n, m1, d, h = 4, 1024, 768, 256, 4
    ffn_w = (2 * d * 2 * d + 2 * d * d + 3 * 2 * d + d) * f
    tail_w = (d * d + d) * f + ffn_w
    out = {}
    for b in BLOCK_BATCHES:
        r5, r6 = b * n, b * (n + m1)
        proj5 = (2 * r5 * d * 3 * d, (r5 * d + d * 3 * d + 3 * d + 2 * r5 * 32
                                      + 3 * r5 * d) * f)
        proj6 = (2 * r6 * d * 2 * d, (r6 * d + d * 2 * d + 2 * d + 2 * r6 * d) * f)
        tail_flops = 2 * d * d + 2 * (2 * d * 2 * d + 2 * d * d)
        tail5 = (r5 * tail_flops, 3 * r5 * d * f + tail_w)
        tail6 = (r6 * tail_flops, 3 * r6 * d * f + tail_w)
        attn5 = 4 * b * h * n * n * 64
        attn6 = 6 * b * n * m1 * d
        out[f"fused_self_block B {b}"] = (
            proj5[0] + attn5 + tail5[0],
            (2 * r5 * d + 2 * r5 * 32) * f + (d * 3 * d + 3 * d) * f + tail_w)
        out[f"fused_cross_block B {b}"] = (
            proj6[0] + attn6 + tail6[0],
            2 * r6 * d * f + r6 + (d * 2 * d + 2 * d) * f + tail_w)
        out[f"B5 projection B {b}"], out[f"B6 projection B {b}"] = proj5, proj6
        out[f"B5 tail B {b}"], out[f"B6 tail B {b}"] = tail5, tail6
    return out


def sp_timing_phase(sx, mparams, sp_params):
    phase("4b timing: extraction kernels, SuperPoint, end to end")
    img, x2, scores = sx["img"], sx["stem_out"], sx["scores"]
    p1 = {"conv1a": sp_params["conv1a"], "conv1b": sp_params["conv1b"]}
    p2 = {"conv2a": sp_params["conv2a"], "conv2b": sp_params["conv2b"]}
    pairs = {
        "fused_stem": (lambda: stem.fused_stem(p1, img),
                       lambda: stem.fused_stem_plain(p1, img)),
        "fused_block2": (lambda: stem2.fused_block2(p2, x2),
                         lambda: stem2.fused_block2_plain(p2, x2)),
        "simple_nms": (lambda: nms.simple_nms_kernel(scores, 4),
                       lambda: nms.simple_nms_plain(scores, 4)),
    }
    times, graph_times = {}, {}
    for name, (kern, plain) in pairs.items():
        a, b, c, d = (time_cuda(f, iters=10) for f in (plain, kern, kern, plain))
        times[name] = ((b + c) / 2, (a + d) / 2, None)
        print(f"  {name} (B 2, {H}x{W}): kernel {times[name][0]:.4f} ms, "
              f"plain {times[name][1]:.4f} ms (runs {b:.4f}/{c:.4f}, "
              f"{a:.4f}/{d:.4f})", flush=True)
    # the tensor-core convolutions' and B9's device time: CUDA-graph
    # replays, kernel, kernel (B8: both launches, B9 its three)
    for name in CONV_ROWS + ("simple_nms",):
        a, d = (attn_split.graph_ms(pairs[name][0], calls=10) for _ in range(2))
        graph_times[name] = ((a + d) / 2, None)
        print(f"  {name}, device time (CUDA graph): kernel {(a + d) / 2:.4f} "
              f"ms (runs {a:.4f}/{d:.4f})", flush=True)

    rng = np.random.default_rng(31)
    pool = [image_pair(rng, H, W) for _ in range(8)]
    imgs = torch.from_numpy(np.stack([p[0] for p in pool]))[..., None].cuda()
    for fused in (True, False):
        conf = SuperPointConfig(fused_stem=fused)
        for bsz in (1, 8):
            ms = time_cuda(lambda: sp.forward(sp_params, conf, imgs[:bsz]),
                           iters=10) / bsz
            print(f"  SuperPoint extraction, fused_stem={fused}, B {bsz}: "
                  f"{ms:.3f} ms per {H}x{W} image (2048 keypoints)", flush=True)

    # end to end at the JAX bench's e2e shape: both images extracted and
    # matched in one call, host clock around calls that end in a sync
    conf = SuperPointConfig(max_num_keypoints=1024)
    im1 = torch.from_numpy(np.stack([p[1] for p in pool]))[..., None].cuda()
    sizes = torch.tensor([[W, H]] * 8, dtype=torch.float32, device="cuda")
    mp = LightGlue("superpoint", params=mparams, device="cuda").params
    for name, c in (("fixed", dict(depth_confidence=-1.0,
                                   width_confidence=-1.0)), ("adaptive", {})):
        run = end_to_end.make_end_to_end(sp.forward, sp_params, conf, mp,
                                         lightglue_config("superpoint", **c))
        for _ in range(2):
            run(imgs, im1, sizes, sizes)
        torch.cuda.synchronize()
        ms = []
        for _ in range(8):
            t0 = time.perf_counter()
            out = run(imgs, im1, sizes, sizes)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        print(f"  make_end_to_end {name} B 8, {H}x{W}, 1024 keypoints: "
              f"{8 * 1e3 / med:.1f} pairs/s (median {med:.2f} ms per call, "
              f"quartiles {q1:.2f}-{q3:.2f}, 8 calls, stop "
              f"{out.matches.stop})", flush=True)

    ext = SuperPoint(params=sp_params, device="cuda")
    matcher = LightGlue("superpoint", params=mparams, device="cuda")
    a, b, _ = pool[0]
    for _ in range(2):
        match_pair(ext, matcher, a, b)
    ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        match_pair(ext, matcher, a, b)
        ms.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(f"  match_pair B 1, {H}x{W}, 2048 keypoints, adaptive: median "
          f"{med:.2f} ms per pair (quartiles {q1:.2f}-{q3:.2f}, 10 calls)",
          flush=True)
    return times, graph_times


def aliked_timing_phase(ax, ap):
    phase("4c timing: ALIKED kernels, ALIKED, images -> ALIKED -> LightGlue")
    img, stem_p, parts, s0 = ax["img"], ax["stem_p"], ax["parts"], ax["s0"]
    smap = ax["smap"]
    sh = ap["score_head"]
    by_batch = {b: [p[:b].contiguous() for p in ax["parts8"]] for b in (1, 8)}
    pairs = {
        "fused_aliked_stem": (
            lambda: aliked_stem.fused_aliked_stem_kernel(stem_p, img),
            lambda: aliked_stem.fused_aliked_stem_plain(stem_p, img)),
        "simple_nms r 2": (lambda: nms.simple_nms_kernel(smap, 2),
                           lambda: nms.simple_nms_plain(smap, 2)),
        "score_head_lazy": (
            lambda: score_head.score_head_lazy_kernel(sh, *parts),
            lambda: score_head.score_head_lazy_plain(sh, *parts)),
        "score_head_cplane": (
            lambda: score_head.score_head_cplane_kernel(sh, s0),
            lambda: score_head.score_tail_plain(sh, s0)),
    }
    for b, pb in by_batch.items():
        sb = score_head.upsampled_sum(*pb)
        pairs[f"score_head_lazy B {b}"] = (
            lambda pb=pb: score_head.score_head_lazy_kernel(sh, *pb),
            lambda pb=pb: score_head.score_head_lazy_plain(sh, *pb))
        pairs[f"score_head_cplane B {b}"] = (
            lambda sb=sb: score_head.score_head_cplane_kernel(sh, sb),
            lambda sb=sb: score_head.score_tail_plain(sh, sb))
    times, graph_times = {}, {}
    for name, (kern, plain) in pairs.items():
        a, b, c, d = (time_cuda(f, iters=10) for f in (plain, kern, kern, plain))
        times[name] = ((b + c) / 2, (a + d) / 2, None)
        at = "" if " B " in name else " (B 2"
        print(f"  {name}{at}, {H}x{W}{')' if at else ''}: kernel "
              f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms (runs "
              f"{b:.4f}/{c:.4f}, {a:.4f}/{d:.4f})", flush=True)
    for name in pairs:
        a, d = (attn_split.graph_ms(pairs[name][0], calls=10) for _ in range(2))
        graph_times[name] = ((a + d) / 2, None)
        print(f"  {name}, device time (CUDA graph): kernel {(a + d) / 2:.4f} "
              f"ms (runs {a:.4f}/{d:.4f})", flush=True)

    rng = np.random.default_rng(47)
    pool = [image_pair(rng, H, W) for _ in range(8)]
    imgs = torch.from_numpy(np.stack([rgb(p[0]) for p in pool])).cuda()
    im1 = torch.from_numpy(np.stack([rgb(p[1]) for p in pool])).cuda()
    conf = ALIKEDConfig()
    for bsz in (1, 8):
        for label, c in (("default configuration", conf),
                         ("fused_score_head", conf.replace(fused_score_head=True))):
            ms = time_cuda(lambda: al.forward(ap, c, imgs[:bsz]), iters=5) / bsz
            print(f"  ALIKED extraction, {label}, B {bsz}: {ms:.3f} ms per "
                  f"{H}x{W} image (2048 keypoints)", flush=True)

    # end to end at the JAX bench's ALIKED e2e shape (bench.py:230-239)
    sizes = torch.tensor([[W, H]] * 8, dtype=torch.float32, device="cuda")
    mp = LightGlue("aliked", device="cuda").params
    for name, c in (("fixed", dict(depth_confidence=-1.0,
                                   width_confidence=-1.0)), ("adaptive", {})):
        run = end_to_end.make_end_to_end(
            al.forward, ap, ALIKEDConfig(max_num_keypoints=1024), mp,
            lightglue_config("aliked", **c))
        for _ in range(2):
            run(imgs, im1, sizes, sizes)
        torch.cuda.synchronize()
        ms = []
        for _ in range(6):
            t0 = time.perf_counter()
            out = run(imgs, im1, sizes, sizes)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        print(f"  make_end_to_end ALIKED {name} B 8, {H}x{W}, 1024 keypoints: "
              f"{8 * 1e3 / med:.1f} pairs/s (median {med:.2f} ms per call, "
              f"quartiles {q1:.2f}-{q3:.2f}, 6 calls, stop {out.matches.stop}"
              + ("; random matcher weights: not representative" if c == {}
                 else "") + ")", flush=True)

    ext = ALIKED(params=ap, device="cuda")
    matcher = LightGlue("aliked", device="cuda")
    a, b = rgb(pool[0][0]), rgb(pool[0][1])
    for _ in range(2):
        match_pair(ext, matcher, a, b)
    ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        match_pair(ext, matcher, a, b)
        ms.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(f"  match_pair ALIKED B 1, {H}x{W}, 2048 keypoints, adaptive: median "
          f"{med:.2f} ms per pair (quartiles {q1:.2f}-{q3:.2f}, 10 calls)",
          flush=True)
    return times, graph_times


def host_ms(fn, reps, warmup=2):
    """Host-clock ms of fn (which ends in a host copy or a sync): median
    and quartiles over reps calls after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return np.percentile(ms, [25, 50, 75])


def serving_timing_phase(params, sp_params):
    phase("4d timing: BatchMatcher (CUDA graphs) against pipeline.LightGlue "
          "(eager) at 1024 keypoints, and match_sequence against "
          "make_end_to_end once per pair (host clocks)")
    rng = np.random.default_rng(11)
    for bsz, reps in ((1, 40), (16, 10)):
        pr = planted_pairs(rng, bsz, 1024)
        data = {"image0": feats(pr, 0), "image1": feats(pr, 1)}
        pairs = [tuple({k: v[i] for k, v in feats(pr, s).items()} for s in (0, 1))
                 for i in range(bsz)]
        for mode, c in (("fixed", FIXED), ("adaptive", {})):
            bm = BatchMatcher(lightglue_config("superpoint", **c), params,
                              buckets=(1024,), max_batch=16)
            bm.warmup([bsz])
            eager = LightGlue("superpoint", params=params, device="cuda", **c)
            runs = {"graphs": lambda: bm.match_pairs(pairs),
                    "eager": lambda: eager(data)}
            q = {}
            for name in ("graphs", "eager", "eager", "graphs"):
                q.setdefault(name, []).append(host_ms(runs[name], reps))
            stop = bm.match_pairs(pairs)[0]["stop"]
            for name, qs in q.items():
                q1, med, q3 = np.mean(qs, 0)
                print(f"  {'BatchMatcher.match_pairs' if name == 'graphs' else 'pipeline.LightGlue'}"
                      f" {mode} B {bsz}, 1024 kpts: {med:.2f} ms per request "
                      f"(quartiles {q1:.2f}-{q3:.2f}; medians "
                      f"{', '.join(f'{x[1]:.2f}' for x in qs)}), "
                      f"{bsz * 1e3 / med:.1f} pairs/s, stop {stop}", flush=True)
            del bm
            gc.collect()

    frames = sequence_frames(np.random.default_rng(31))
    ext = SuperPoint(params=sp_params, max_num_keypoints=1024, device="cuda")
    imgs = torch.from_numpy(frames)[..., None].cuda()
    size = torch.tensor([[W, H]], dtype=torch.float32, device="cuda")
    for mode, c in (("fixed", FIXED), ("adaptive", {})):
        matcher = LightGlue("superpoint", params=params, device="cuda", **c)
        run = end_to_end.make_end_to_end(sp.forward, ext.params, ext.conf,
                                         matcher.params, matcher.conf)
        for w in SEQUENCE_WINDOWS:
            i0, i1 = end_to_end.sequence_window_pairs(SEQUENCE_FRAMES, w)
            seq = host_ms(lambda: match_sequence(ext, matcher, frames, window=w), 5)
            per_pair = host_ms(lambda: [
                run(imgs[a:a + 1], imgs[b:b + 1], size, size).matches.matches0.cpu()
                for a, b in zip(i0, i1)], 3)
            print(f"  {mode}, {SEQUENCE_FRAMES} frames {H}x{W}, window {w} "
                  f"({len(i0)} pairs): match_sequence {len(i0) * 1e3 / seq[1]:.1f}"
                  f" pairs/s (median {seq[1]:.2f} ms, quartiles {seq[0]:.2f}-"
                  f"{seq[2]:.2f}), make_end_to_end per pair "
                  f"{len(i0) * 1e3 / per_pair[1]:.1f} pairs/s (median "
                  f"{per_pair[1]:.2f} ms, quartiles {per_pair[0]:.2f}-"
                  f"{per_pair[2]:.2f})", flush=True)


def profile_call(label, fn, calls=5, warmup=3, top=6):
    """torch.profiler over ``calls`` calls of fn after ``warmup``: wall and
    device ms per call, busy share, device ops per call, largest items.
    The wall is timed over ``calls`` calls without the profiler, whose
    tracing of host activity slows the host (the wall under it is printed
    beside), and the busy share is device time over that wall. Returns
    fn's last output."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3 / calls
    by_name, n_ops = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_ops += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / calls
    dev = sum(by_name.values())
    print(f"  {label}: wall {wall:.2f} ms/call ({traced:.2f} under the profiler), "
          f"device {dev:.2f} ms/call, busy {100 * dev / wall:.1f} %, "
          f"{n_ops / calls:.0f} device ops/call", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:8.3f} ms  {name[:90]}")
    return out


def profile_phase(params):
    phase("P profile: the matcher at 1024 keypoints (torch.profiler; device "
          "time = kernels and copies)")
    rng = np.random.default_rng(11)
    for bsz in (1, 16):
        pr = planted_pairs(rng, bsz, 1024)
        data = {"image0": feats(pr, 0), "image1": feats(pr, 1)}
        for mode, c in (("fixed", dict(depth_confidence=-1.0,
                                       width_confidence=-1.0)),
                        ("adaptive", {})):
            for blocks, mp, bc in (("default", params, {}),
                                   ("composed", params, COMPOSED),
                                   ("2 heads, default", two_head_params(params),
                                    TWO_HEADS)):
                matcher = LightGlue("superpoint", params=mp,
                                    device="cuda", **c, **bc)
                out = profile_call(f"{mode} B {bsz}, {blocks} blocks",
                                   lambda: matcher(data))
                print(f"    (stop {out['stop']})")

    phase("P profile: SuperPoint at 768 x 1024 (2048 keypoints), fp32 and "
          "mp, and images -> SuperPoint -> LightGlue at B 8 (fixed, 1024 "
          "keypoints), fp32 and mp")
    sp_params = superpoint_params()
    rng = np.random.default_rng(31)
    pool = [image_pair(rng, H, W) for _ in range(8)]
    im0, im1 = (torch.from_numpy(np.stack([p[i] for p in pool]))[..., None].cuda()
                for i in (0, 1))
    for bsz in (1, 8):
        for label, mp in (("", False), (" at mp", True)):
            profile_call(f"SuperPoint B {bsz}{label}", lambda: sp.forward(
                sp_params, SuperPointConfig(mp=mp), im0[:bsz]), calls=3,
                warmup=2, top=10)
    # match_pair at the extractor's default 2048 keypoints, fixed: B5 and
    # the composed cross block (K2's walks, B4 over both images)
    ext = SuperPoint(params=sp_params, device="cuda")
    fixed = LightGlue("superpoint", params=params, device="cuda",
                      depth_confidence=-1.0, width_confidence=-1.0)
    a, b = pool[0][0], pool[0][1]
    profile_call("match_pair fixed B 1, 768 x 1024, 2048 keypoints",
                 lambda: match_pair(ext, fixed, a, b), calls=3, warmup=2,
                 top=10)
    sizes = torch.tensor([[W, H]] * 8, dtype=torch.float32, device="cuda")
    run = end_to_end.make_end_to_end(
        sp.forward, sp_params, SuperPointConfig(max_num_keypoints=1024),
        LightGlue("superpoint", params=params, device="cuda").params,
        lightglue_config("superpoint", depth_confidence=-1.0,
                         width_confidence=-1.0))
    profile_call("make_end_to_end fixed B 8, 1024 keypoints",
                 lambda: run(im0, im1, sizes, sizes), calls=3, warmup=2, top=10)
    # images to matches at mp: SuperPoint(mp=True) into the mp matcher
    mp_lg = LightGlue("superpoint", params=params, device="cuda", mp=True)
    run_mp = end_to_end.make_end_to_end(
        sp.forward, sp_params, SuperPointConfig(max_num_keypoints=1024, mp=True),
        mp_lg.params, mp_lg.conf.replace(**FIXED))
    profile_call("make_end_to_end fixed B 8, 1024 keypoints, at mp",
                 lambda: run_mp(im0, im1, sizes, sizes), calls=3, warmup=2,
                 top=10)

    phase("P profile: ALIKED at 768 x 1024 (default configuration, 2048 "
          "keypoints) and images -> ALIKED -> LightGlue('aliked') at B 8")
    ap = aliked_params()
    rng = np.random.default_rng(47)
    pool = [image_pair(rng, H, W) for _ in range(8)]
    im0, im1 = (torch.from_numpy(np.stack([rgb(p[i]) for p in pool])).cuda()
                for i in (0, 1))
    for bsz in (1, 8):
        for label, fused in (("", False), (", fused_score_head", True)):
            profile_call(f"ALIKED B {bsz}{label}", lambda: al.forward(
                ap, ALIKEDConfig(fused_score_head=fused), im0[:bsz]),
                calls=3, warmup=2, top=10)
    sizes = torch.tensor([[W, H]] * 8, dtype=torch.float32, device="cuda")
    matcher_params = LightGlue("aliked", device="cuda").params
    for label, fused in (("", False), (", fused_score_head", True)):
        run = end_to_end.make_end_to_end(
            al.forward, ap, ALIKEDConfig(max_num_keypoints=1024,
                                         fused_score_head=fused), matcher_params,
            lightglue_config("aliked", depth_confidence=-1.0, width_confidence=-1.0))
        profile_call(f"make_end_to_end ALIKED fixed B 8, 1024 keypoints{label}",
                     lambda: run(im0, im1, sizes, sizes), calls=3, warmup=2, top=10)


def serving_profile_phase(params, sp_params):
    phase("P profile: BatchMatcher (CUDA graphs) at 1024 keypoints, B 1 and "
          "B 16, and match_sequence against make_end_to_end per pair")
    rng = np.random.default_rng(11)
    for bsz in (1, 16):
        pr = planted_pairs(rng, bsz, 1024)
        pairs = [tuple({k: v[i] for k, v in feats(pr, s).items()} for s in (0, 1))
                 for i in range(bsz)]
        for mode, c in (("fixed", FIXED), ("adaptive", {})):
            bm = BatchMatcher(lightglue_config("superpoint", **c), params,
                              buckets=(1024,), max_batch=16)
            bm.warmup([bsz])
            out = profile_call(f"BatchMatcher {mode} B {bsz}, 1024 keypoints",
                               lambda: bm.match_pairs(pairs))
            print(f"    (stop {out[0]['stop']})")
            del bm
            gc.collect()
    frames = sequence_frames(np.random.default_rng(31))
    ext = SuperPoint(params=sp_params, max_num_keypoints=1024, device="cuda")
    matcher = LightGlue("superpoint", params=params, device="cuda", **FIXED)
    run = end_to_end.make_end_to_end(sp.forward, ext.params, ext.conf,
                                     matcher.params, matcher.conf)
    imgs = torch.from_numpy(frames)[..., None].cuda()
    size = torch.tensor([[W, H]], dtype=torch.float32, device="cuda")
    for w in SEQUENCE_WINDOWS:
        i0, i1 = end_to_end.sequence_window_pairs(SEQUENCE_FRAMES, w)
        profile_call(f"match_sequence fixed, {SEQUENCE_FRAMES} frames, window "
                     f"{w} ({len(i0)} pairs)",
                     lambda: match_sequence(ext, matcher, frames, window=w),
                     calls=3, warmup=2, top=10)
        profile_call(f"make_end_to_end fixed once per pair, the same {len(i0)} "
                     "pairs", lambda: [
                         run(imgs[a:a + 1], imgs[b:b + 1], size, size)
                         .matches.matches0.cpu() for a, b in zip(i0, i1)],
                     calls=2, warmup=1, top=10)


# --- phase 5: the matcher's bf16 path (mp) ------------------------------------


def rel_err(got, ref, rows=None):
    """(largest |got - ref| / max(1, |ref|), largest |got - ref|) over the
    rows that ``rows`` keeps ((B, n) of (B, n, ...) values), in fp32."""
    g, r = got.float(), ref.float()
    if rows is not None:
        g, r = g[rows], r[rows]
    d = (g - r).abs()
    if not d.numel():
        return 0.0, 0.0
    return float((d / r.abs().clamp(min=1.0)).max()), float(d.max())


def scaled_err(got, ref, rows=None):
    """Largest |got - ref| / (MP_SCALED (|ref| + rms(ref's row))) over
    the rows that ``rows`` keeps, the rms over the last axis."""
    g, r = got.float(), ref.float()
    rms = r.square().mean(-1, keepdim=True).sqrt().expand_as(r)
    if rows is not None:
        g, r, rms = g[rows], r[rows], rms[rows]
    d = (g - r).abs()
    if not d.numel():
        return 0.0
    ratio = torch.where(d == 0, torch.zeros_like(d),
                        d / (MP_SCALED * (r.abs() + rms)))
    return float(ratio.max())


def mp_check(errs, name, label, got, ref, rows=None):
    """Hold a bf16 launch to its bf16 plain version within MP_REL and
    within the output's own scale; note its largest absolute error under
    ``name``."""
    if got.dtype != BF16 or ref.dtype != BF16:
        raise AssertionError(f"{label}: {got.dtype} / {ref.dtype}, not bf16")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{label}: not finite")
    rel, ab = rel_err(got, ref, rows)
    scaled = scaled_err(got, ref, rows)
    print(f"  {label}: |kernel - plain| / max(1, |plain|) {rel:.3e} (tol "
          f"{MP_REL:g}), of the scaled bound {scaled:.3f} (tol 1), "
          f"max_abs_err {ab:.3e}", flush=True)
    if not rel <= MP_REL:
        raise AssertionError(f"{label}: {rel} > {MP_REL}")
    if not scaled <= 1.0:
        raise AssertionError(f"{label}: {scaled} of the scaled bound")
    errs[name] = max(errs.get(name, 0.0), ab)


def mp_bound_reach(mx):
    """What the two bounds read for faults the bf16 attention kernels
    could have, on phase 5a's inputs: one 64-key tile skipped (the plain
    version with it masked out, against it whole; the scaled bound must
    read over 1) and the weights left unrounded (the fp32 plain version on
    the same bf16 values, rounded at the end)."""
    for shift in (None, SHIFT):
        tag = "" if shift is None else " shift 12"
        q, k, v, valid = mx["k1"]
        ref = flash.flash_sdpa_plain(q, k, v, valid, shift)
        drop = valid.clone()
        drop[:, 64:128] = False
        faults = {
            "K1 (4,4,4096,64), a key tile skipped":
                flash.flash_sdpa_plain(q, k, v, drop, shift),
            "K1 (4,4,4096,64), the weights unrounded":
                flash.flash_sdpa_plain(q.float(), k.float(), v.float(), valid,
                                       shift).to(BF16)}
        qk0, qk1, v0, v1, va0, va1 = mx["k2"]
        ref2 = flash_cross.fused_cross_attention_plain(
            qk0, qk1, v0, v1, va0, va1, shift)[0]
        drop = va1.clone()
        drop[:, 64:128] = False
        faults["K2 (4,4,M 2048 / N 1536) m0, a key tile skipped"] = \
            flash_cross.fused_cross_attention_plain(
                qk0, qk1, v0, v1, va0, drop, shift)[0]
        faults["K2 (4,4,M 2048 / N 1536) m0, the weights unrounded"] = \
            flash_cross.fused_cross_attention_plain(
                *(t.float() for t in (qk0, qk1, v0, v1)), va0, va1,
                shift)[0].to(BF16)
        for label, bad in faults.items():
            r = ref if label.startswith("K1") else ref2
            rel, _ = rel_err(bad, r)
            scaled = scaled_err(bad, r)
            print(f"  bound reach{tag}: {label}: {rel / MP_REL:.3f} of "
                  f"MP_REL's bound, {scaled:.3f} of the scaled bound",
                  flush=True)
            if "skipped" in label and not scaled > 1.0:
                raise AssertionError(f"{label}: the scaled bound cannot "
                                     "fail it")


def mp_inputs(x, bx):
    """Phase 5's kernel inputs: phase 2's in bf16 (B5 and B6 at B 1, 4 and
    16, B4 at (4, 1024, 256) and both images at B 16, K2 at (4, 4, M 1024 /
    N 768)) and the composed paths' larger shapes: K1 at (4, 4, 4096, 64)
    and (1, 4, 4096, 64), K2 at (4, 4, M 2048 / N 1536), masked, batch
    entry 1 without a valid key."""
    g = torch.Generator(device="cuda").manual_seed(51)

    def mask(b, n, p=0.85):
        m = torch.rand(b, n, generator=g, device="cuda") < p
        if b > 1:
            m[1] = False
        return m

    def bf(*t):
        return tuple(u.to(BF16) if torch.is_tensor(u) and u.is_floating_point()
                     else u for u in t)

    k1 = bf(*(rand(g, 4, 4, 4096, 64) for _ in range(3))) + (mask(4, 4096),)
    k2 = bf(rand(g, 4, 4, 2048, 64), rand(g, 4, 4, 1536, 64),
            rand(g, 4, 4, 2048, 64), rand(g, 4, 4, 1536, 64)) + (
        mask(4, 2048, 0.9), mask(4, 1536, 0.9))
    xx, msg, p = x["k3"]
    x16 = bf(bx["b6"][16][0], bx["b6"][16][1],
             rand(g, 16, 1024, 256), rand(g, 16, 768, 256))
    return {
        "b5": {b: bf(*bx["b5"][b][:1]) + tuple(bx["b5"][b][1:])
               for b in BLOCK_BATCHES},
        "b6": {b: bf(*bx["b6"][b]) for b in BLOCK_BATCHES},
        "k1": k1,
        "k1_b1": tuple(t[:1].contiguous() for t in k1),
        "k1_1024": bf(*x["k1"]),
        "k2": k2,
        "k2_1024": bf(*x["k2"]),
        "k3": bf(xx, msg) + (p,),
        "k3_pair16": x16,
        "layer": bx["layer"],
    }


def mp_block_weights(layer, shift):
    return (flash_self.prepare(layer["self_attn"], 4, shift, mp=True),
            flash_cross_block.prepare(layer["cross_attn"], 4, shift, mp=True))


def mp_kernel_phase(mx):
    """Each bf16 kernel against its bf16 plain version on the card, each
    launch twice, bit for bit. Returns {kernel: largest absolute error}."""
    phase("5a the bf16 kernels (mp) against their bf16 plain versions "
          f"(|kernel - plain| <= {MP_REL:g} max(1, |plain|) and <= 2^-6 "
          "(|plain| + rms(plain row)))")
    errs = {}
    for shift in (None, SHIFT):
        w5, w6 = mp_block_weights(mx["layer"], shift)
        tag = "" if shift is None else " shift 12"
        for b in BLOCK_BATCHES:
            xx, enc, valid = mx["b5"][b]
            for mk in (None, valid):
                got = flash_self.fused_self_block(w5, xx, enc, mk)
                same(f"fused_self_block_bf16 B {b}", (got,),
                     (flash_self.fused_self_block(w5, xx, enc, mk),))
                mp_check(errs, "fused_self_block_bf16",
                         f"fused_self_block_bf16 {tuple(xx.shape)}{tag}"
                         f"{' masked' if mk is not None else ''}", got,
                         flash_self.fused_self_block_plain(w5, xx, enc, mk))
            x0, x1, va0, va1 = mx["b6"][b]
            got = flash_cross_block.fused_cross_block(w6, x0, x1, va0, va1)
            same(f"fused_cross_block_bf16 B {b}", got,
                 flash_cross_block.fused_cross_block(w6, x0, x1, va0, va1))
            ref = flash_cross_block.fused_cross_block_plain(w6, x0, x1, va0,
                                                            va1)
            for i, va in ((0, va0), (1, va1)):
                mp_check(errs, "fused_cross_block_bf16",
                         f"fused_cross_block_bf16 B {b}, M 1024 / N 768{tag}, "
                         f"image {i}, valid rows", got[i], ref[i], va)
        name = "flash_sdpa" + ("" if shift is None else "_shift") + "_bf16"
        for label, (q, k, v, valid) in (("(4,4,4096,64)", mx["k1"]),
                                        ("(1,4,4096,64)", mx["k1_b1"])):
            for mk in (None, valid):
                got = flash.flash_sdpa(q, k, v, mk, shift=shift)
                same(f"{name} {label}", (got,),
                     (flash.flash_sdpa(q, k, v, mk, shift=shift),))
                mp_check(errs, name, f"{name} {label}"
                         f"{' masked' if mk is not None else ''}", got,
                         flash.flash_sdpa_plain(q, k, v, mk, shift))
        q, k, v = mx["k1_1024"]
        mp_check(errs, name, f"{name} (4,4,1024,64)",
                 flash.flash_sdpa(q, k, v, shift=shift),
                 flash.flash_sdpa_plain(q, k, v, shift=shift))
        name = ("fused_cross_attention" + ("" if shift is None else "_shift")
                + "_bf16")
        for label, args in (("(4,4,M 2048 / N 1536)", mx["k2"]),
                            ("(4,4,M 1024 / N 768)", mx["k2_1024"])):
            got = flash_cross.fused_cross_attention(*args, shift=shift)
            same(f"{name} {label}", got,
                 flash_cross.fused_cross_attention(*args, shift=shift))
            ref = flash_cross.fused_cross_attention_plain(*args, shift=shift)
            for i in (0, 1):
                mp_check(errs, name, f"{name} {label} masked, m{i}", got[i],
                         ref[i])
    xx, msg, p = mx["k3"]
    got = ffn.fused_ffn_residual(xx, msg, p)
    same("fused_ffn_residual_bf16", (got,), (ffn.fused_ffn_residual(xx, msg, p),))
    mp_check(errs, "fused_ffn_residual_bf16", "fused_ffn_residual_bf16 "
             "(4, 1024, 256)", got, ffn.fused_ffn_residual_plain(xx, msg, p))
    x0, x1, m0, m1 = mx["k3_pair16"]
    got = ffn.fused_ffn_residual_pair(x0, m0, x1, m1, p)
    for i, (xi, mi) in enumerate(((x0, m0), (x1, m1))):
        mp_check(errs, "fused_ffn_residual_bf16", "fused_ffn_residual_bf16 "
                 f"both images at B 16 (M 1024 / N 768), image {i}", got[i],
                 ffn.fused_ffn_residual_plain(xi, mi, p))
    mp_bound_reach(mx)
    torch.cuda.synchronize()
    return errs


# The mp matcher's kernels: B5 and B6 at 1024 keypoints; nothing of the
# fp32 matcher's block and attention kernels (B2 stays fp32)
MP_DEFAULT_KERNELS = ("fused_self_block_bf16", "fused_cross_block_bf16",
                      "fused_filter_matches")
FP32_MATCHER = ("fused_self_block", "fused_cross_block", "flash_sdpa",
                "flash_sdpa_shift", "fused_cross_attention",
                "fused_cross_attention_shift", "fused_ffn_residual")
# BatchMatcher at mp (phase 5c): the bf16 kernels each bucket's graphs must
# launch (B5 and B6 up to 1024; B5 and the composed cross block, K2 and B4,
# to 2048; above, K1 and the composed blocks), by softmax form
MP_SERVING_BUCKETS = (512, 1024, 2048, 4096)


def mp_bucket_kernels(bucket, shift):
    s = "" if shift is None else "_shift"
    if bucket <= 1024:
        return MP_DEFAULT_KERNELS
    cross = (f"fused_cross_attention{s}_bf16", "fused_ffn_residual_bf16",
             "fused_filter_matches")
    if bucket <= 2048:
        return ("fused_self_block_bf16",) + cross
    return (f"flash_sdpa{s}_bf16",) + cross


def recall(out, gt):
    """Share of the planted pairs (gt >= 0) that were matched correctly."""
    m0 = out["matches0"]
    return float(((m0 == gt) & (gt >= 0)).sum() / max(1, (gt >= 0).sum()))


def mp_matcher_phase(params):
    """Phase 5b: pipeline.LightGlue at mp=True on the card (B5 and B6 in
    bf16), fixed and adaptive, exact and shift 12, B 1 and B 16 at 1024
    keypoints: the bf16 kernels and no fp32 block kernel launched; against
    the CPU port at mp matches0 >= 99 % equal and the same stop; against
    the card's fp32 path planted precision and recall within 0.01.
    Returns the counts."""
    total = dict.fromkeys(KERNELS, 0)
    rng = np.random.default_rng(53)
    data = {}
    for bsz in (1, 16):
        pr = planted_pairs(rng, bsz, 1024)
        data[bsz] = (pr, {"image0": feats(pr, 0), "image1": feats(pr, 1)})
    for (mode, c), shift in ((m, s) for m in (("fixed", FIXED), ("adaptive", {}))
                             for s in (None, SHIFT)):
        sh = dict(self_softmax_shift=shift, cross_softmax_shift=shift)
        phase(f"5b main path at mp: pipeline.LightGlue(mp=True), {mode}, "
              f"{'exact' if shift is None else 'shift 12'}, 1024 keypoints")
        gpu = LightGlue("superpoint", params=params, device="cuda", mp=True,
                        **c, **sh)
        f32 = LightGlue("superpoint", params=params, device="cuda", **c, **sh)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        outs = {b: gpu(d) for b, (_, d) in data.items()}
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        print(f"  launch counts: { {k: v for k, v in counts.items() if v} }")
        for k in MP_DEFAULT_KERNELS:
            if counts[k] < 1:
                raise AssertionError(f"{k} was not launched at mp")
        for k in FP32_MATCHER:
            if counts[k]:
                raise AssertionError(f"{k} (fp32) was launched at mp")
        for k, v in counts.items():
            total[k] += v
        for b, (pr, d) in data.items():
            out, ref32 = outs[b], f32(d)
            gt = pr["gt_matches0"]
            for f in ("matching_scores0", "matching_scores1"):
                if not np.isfinite(out[f]).all():
                    raise AssertionError(f"B {b}: {f} not finite")
            (k16, p16), (k32, p32) = precision(out, gt), precision(ref32, gt)
            r16, r32 = recall(out, gt), recall(ref32, gt)
            print(f"  B {b}: stop {out['stop']} (fp32 {ref32['stop']}), "
                  f"{k16} matches, precision {p16:.4f} recall {r16:.4f} "
                  f"against the planted truth; fp32 on the card {k32}, "
                  f"{p32:.4f}, {r32:.4f}")
            if abs(p16 - p32) > 0.01 or abs(r16 - r32) > 0.01:
                raise AssertionError(f"B {b}: mp precision / recall off fp32's")
            cpu = LightGlue("superpoint", params=params, device="cpu",
                            mp=True, **c, **sh)(d)
            agree = float((cpu["matches0"] == out["matches0"]).mean())
            print(f"  B {b} against the CPU port at mp: matches0 agreement "
                  f"{agree:.6f}, stop {out['stop']} vs {cpu['stop']}, score "
                  f"diff {score_gap(out, cpu):.2e}")
            if agree < 0.99 or cpu["stop"] != out["stop"]:
                raise AssertionError("mp: the card disagrees with the CPU port")
        del gpu, f32
    return total


def mp_serving_phase(params):
    """Phase 5c: BatchMatcher on an mp=True configuration, fixed (exact)
    and adaptive (shift 12, the JAX headline), buckets 512-4096, batches 1
    and 16: every replay equal to the bit to the eager mp forward, each
    bucket's bf16 kernels from the graphs' counts and no fp32 block or
    attention kernel, precision against the planted truth; each bucket's
    batch-1 pair against the CPU port at mp (matches0 >= 99 % equal, the
    same stop). This is the path that reaches K1, K2 and B4 in bf16.
    Returns the counts."""
    total = dict.fromkeys(KERNELS, 0)
    rng = np.random.default_rng(57)
    traffic = {}
    for bucket in MP_SERVING_BUCKETS:
        reqs = []
        for bsz in (1, 16):  # just under the bucket: padded, ragged
            pr = planted_pairs(rng, bsz, bucket - 7, bucket - 3)
            reqs.append(([tuple({"keypoints": pr[f"keypoints{s}"][i],
                                 "descriptors": pr[f"descriptors{s}"][i],
                                 "image_size": pr["image_size"][i]}
                                for s in (0, 1)) for i in range(bsz)],
                         pr["gt_matches0"]))
        traffic[bucket] = reqs
    for mode, c, shift in (("fixed", FIXED, None), ("adaptive", {}, SHIFT)):
        phase(f"5c BatchMatcher(mp=True), {mode}, "
              f"{'exact' if shift is None else 'shift 12'}, buckets "
              f"{MP_SERVING_BUCKETS}, batches 1 and 16 (CUDA graphs)")
        conf = lightglue_config("superpoint", mp=True, self_softmax_shift=shift,
                                cross_softmax_shift=shift, **c)
        bm = BatchMatcher(conf, params, buckets=MP_SERVING_BUCKETS,
                          max_batch=16)
        cpu = BatchMatcher(conf, params, buckets=MP_SERVING_BUCKETS,
                           max_batch=16, device="cpu")
        for bucket, reqs in traffic.items():
            for pairs, gt in reqs:
                res = bm.match_pairs(pairs)  # the first sight captures
                torch.cuda.synchronize()
                _build.reset_launch_counts()
                res = bm.match_pairs(pairs)
                torch.cuda.synchronize()
                counts = _build.launch_counts()
                for k in mp_bucket_kernels(bucket, shift):
                    if counts[k] < 1:
                        raise AssertionError(f"{k} not launched at {bucket}")
                for k in FP32_MATCHER:
                    if counts[k]:
                        raise AssertionError(f"{k} (fp32) launched at {bucket}")
                for k, v in counts.items():
                    total[k] += v
                (_, f0, f1), = bm.padded_batches(pairs)
                got, ref = bm.match_batch(f0, f1), eager_forward(bm, f0, f1)
                differ = [f for f in graphs.OUTPUTS
                          if not np.array_equal(getattr(got, f), getattr(ref, f))]
                out = {"matches0": np.stack([r["matches0"] for r in res])}
                k, prec = precision(out, gt)
                print(f"  bucket {bucket}, batch {len(pairs)}: replay "
                      f"{'equal to the bit to' if not differ else 'DIFFERS from'}"
                      f" eager lg.forward, stop {got.stop} vs {ref.stop}; "
                      f"{k} matches, precision {prec:.3f}; launches "
                      f"{ {n: v for n, v in counts.items() if v} }", flush=True)
                if differ or got.stop != ref.stop:
                    raise AssertionError(f"mp {mode} bucket {bucket}: the "
                                         f"graphs and eager differ in {differ}")
                if prec < MIN_PRECISION[4]:
                    raise AssertionError(f"mp bucket {bucket}: precision {prec}")
                if len(pairs) > 1:
                    continue
                # the batch-1 pair against the CPU port at mp
                want = cpu.match_batch(f0, f1)
                agree = float((got.matches0 == want.matches0).mean())
                gap = max(float(np.abs(getattr(got, f) - getattr(want, f)).max())
                          for f in ("matching_scores0", "matching_scores1"))
                print(f"  bucket {bucket}, batch 1 against the CPU port at mp: "
                      f"matches0 agreement {agree:.6f}, stop {got.stop} vs "
                      f"{want.stop}, score diff {gap:.2e}", flush=True)
                if agree < 0.99 or got.stop != want.stop:
                    raise AssertionError(f"mp {mode} bucket {bucket}: the card "
                                         "disagrees with the CPU port")
        del bm, cpu
        gc.collect()
        torch.cuda.empty_cache()
    return total


def mp_extraction_phase(sp_params):
    """Phase 5d: images -> SuperPoint (fp32) -> LightGlue(mp=True) through
    match_pair (2048 keypoints: B5 and the composed cross block in bf16)
    and make_end_to_end (B 2, 1024 keypoints: B5 and B6 in bf16), the
    matcher casting the fp32 features. Returns the counts."""
    phase("5d main path at mp: match_pair and make_end_to_end, SuperPoint "
          "(fp32) -> LightGlue(mp=True), generated 768 x 1024 pairs")
    rng = np.random.default_rng(59)
    a, b, _ = image_pair(rng, H, W)
    ext = SuperPoint(params=sp_params, device="cuda")
    matcher = LightGlue("superpoint", device="cuda", mp=True, **FIXED)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    f0, f1, out = match_pair(ext, matcher, a, b)
    sizes = torch.tensor([[W, H]] * 2, dtype=torch.float32, device="cuda")
    im0, im1 = (torch.from_numpy(np.stack(p))[..., None].cuda()
                for p in ((a, b), (b, a)))
    run = end_to_end.make_end_to_end(
        sp.forward, sp_params, SuperPointConfig(max_num_keypoints=1024),
        matcher.params, matcher.conf)
    e2e = run(im0, im1, sizes, sizes)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"  match_pair: {f0['keypoints'].shape[0]} / "
          f"{f1['keypoints'].shape[0]} keypoints, {len(out['matches'])} "
          f"matches; make_end_to_end B 2: matches0 "
          f"{tuple(e2e.matches.matches0.shape)}; launch counts "
          f"{ {k: v for k, v in counts.items() if v} }")
    need = ("fused_stem", "fused_block2", "simple_nms", "fused_self_block_bf16",
            "fused_cross_attention_bf16", "fused_ffn_residual_bf16",
            "fused_cross_block_bf16", "fused_filter_matches")
    for k in need:
        if counts[k] < 1:
            raise AssertionError(f"{k} was not launched at mp")
    for k in FP32_MATCHER:
        if counts[k]:
            raise AssertionError(f"{k} (fp32) was launched at mp")
    if not np.isfinite(out["matching_scores0"]).all() or not bool(
            torch.isfinite(e2e.matches.matching_scores0).all()):
        raise AssertionError("mp match_pair / make_end_to_end: not finite")
    return counts


def mp_rows(mx, x, bx):
    """Phase 5e's rows: {row: (bf16 kernel, bf16 plain version, fp32 form
    on the same values, library call or None, (FLOPs, bytes))}. The bound
    counts bf16 activations and weights at 2 bytes, fp32 biases, tables
    and masks as stored; FLOPs as phase 4's."""
    f, h, n, m1, d = 4, 4, 1024, 768, 256
    w5, w6 = mp_block_weights(mx["layer"], None)
    v5, v6 = block_weights(bx, None)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ffn_w = (2 * d * 2 * d + 2 * d * d) * 2 + (3 * 2 * d + d) * f
    rows = {}

    def attn(label, q, k, v, mk, shift, key):
        b, _, nn_, _ = q.shape
        q32, k32, v32 = q.float(), k.float(), v.float()
        kb = torch.zeros(b, 1, 1, nn_, device="cuda", dtype=BF16) if mk is None \
            else flash.key_bias(mk).to(BF16)[:, None, None, :]
        rows[label] = (
            lambda: flash.flash_sdpa(q, k, v, mk, shift=shift),
            lambda: flash.flash_sdpa_plain(q, k, v, mk, shift),
            lambda: flash.flash_sdpa(q32, k32, v32, mk, shift=shift),
            ("SDPA bf16", lambda: sdpa(q, k, v, attn_mask=kb)),
            (4 * b * h * nn_ * nn_ * 64,
             4 * b * h * nn_ * 64 * 2 + (0 if mk is None else b * nn_)))

    q, k, v = mx["k1_1024"]
    attn("flash_sdpa_bf16", q, k, v, None, None, 0)
    attn("flash_sdpa_shift_bf16", q, k, v, None, SHIFT, 0)
    q, k, v, mk = mx["k1"]
    attn("flash_sdpa_bf16 (4,4,4096,64) masked", q, k, v, mk, None, 0)
    attn("flash_sdpa_shift_bf16 (4,4,4096,64) masked", q, k, v, mk, SHIFT, 0)
    for label, args in (("", mx["k2_1024"]),
                        (" (4,4,M 2048 / N 1536)", mx["k2"])):
        a32 = tuple(t.float() if t.is_floating_point() else t for t in args)
        b, _, mm, _ = args[0].shape
        nn_ = args[1].shape[2]
        bound = (6 * b * h * mm * nn_ * 64,
                 3 * b * h * (mm + nn_) * 64 * 2 + b * (mm + nn_))
        for shift in (None, SHIFT):
            name = ("fused_cross_attention" + ("" if shift is None else
                                               "_shift") + "_bf16" + label)
            rows[name] = (
                lambda a=args, s=shift: flash_cross.fused_cross_attention(*a, shift=s),
                lambda a=args, s=shift: flash_cross.fused_cross_attention_plain(*a, shift=s),
                lambda a=a32, s=shift: flash_cross.fused_cross_attention(*a, shift=s),
                ("2 SDPA bf16 calls", cross_sdpa(args)), bound)
    # B6's attention in bf16 (launch_cross mode EXACT_BLOCK, qk scaled as
    # B6 folds it) at B 1, 4 and 16, (B, 4, M 1024 / N 768, 64) masked
    g = torch.Generator(device="cuda").manual_seed(29)
    for b in BLOCK_BATCHES:
        qk0, v0 = (rand(g, b, h, n, 64).to(BF16) for _ in range(2))
        qk1, v1 = (rand(g, b, h, m1, 64).to(BF16) for _ in range(2))
        va0 = torch.rand(b, n, generator=g, device="cuda") < 0.9
        va1 = torch.rand(b, m1, generator=g, device="cuda") < 0.9
        xs = ((qk0.float() * 64 ** -0.25).to(BF16),
              (qk1.float() * 64 ** -0.25).to(BF16), v0, v1, va0, va1)
        x32 = tuple(t.float() if t.is_floating_point() else t for t in xs)
        rows[f"B6 attention bf16 B {b}"] = (
            lambda x=xs: flash_cross.launch_cross(*x, flash_cross.EXACT_BLOCK, 1.0),
            lambda x=xs: flash_cross_block.cross_block_attention_plain(*x),
            lambda x=x32: flash_cross.launch_cross(*x, flash_cross.EXACT_BLOCK, 1.0),
            ("2 SDPA bf16 calls", cross_sdpa(xs, 1.0)),
            (6 * b * h * n * m1 * 64, 3 * b * h * (n + m1) * 64 * 2 + b * (n + m1)))
    x4, msg4, p = mx["k3"]
    x4f, msg4f = x4.float(), msg4.float()
    rows["fused_ffn_residual_bf16"] = (
        lambda: ffn.fused_ffn_residual(x4, msg4, p),
        lambda: ffn.fused_ffn_residual_plain(x4, msg4, p),
        lambda: ffn.fused_ffn_residual(x4f, msg4f, p), None,
        (4 * n * 2 * (2 * d * 2 * d + 2 * d * d), 3 * 4 * n * d * 2 + ffn_w))
    pair16 = tuple(mx["k3_pair16"][i] for i in (0, 2, 1, 3))  # x0 m0 x1 m1
    p32 = tuple(t.float() for t in pair16)
    rows["fused_ffn_residual_bf16 pair B 16, 1024 / 768"] = (
        lambda: ffn.fused_ffn_residual_pair(*pair16, p),
        lambda: (ffn.fused_ffn_residual_plain(*pair16[:2], p),
                 ffn.fused_ffn_residual_plain(*pair16[2:], p)),
        lambda: ffn.fused_ffn_residual_pair(*p32, p), None,
        (16 * (n + m1) * 2 * (2 * d * 2 * d + 2 * d * d),
         3 * 16 * (n + m1) * d * 2 + ffn_w))
    tail_w = (d * d) * 2 + d * f + ffn_w
    for b in BLOCK_BATCHES:
        xx, enc, _ = mx["b5"][b]
        x32 = xx.float()
        sfx = "" if b == 4 else f" B {b}"
        r5, r6 = b * n, b * (n + m1)
        rows["fused_self_block_bf16" + sfx] = (
            lambda xx=xx, enc=enc: flash_self.fused_self_block(w5, xx, enc),
            lambda xx=xx, enc=enc: flash_self.fused_self_block_plain(w5, xx, enc),
            lambda x32=x32, enc=enc: flash_self.fused_self_block(v5, x32, enc),
            None,
            (b * (2 * n * d * 3 * d + 4 * h * n * n * 64 + 2 * n * d * d
                  + 2 * n * (2 * d * 2 * d + 2 * d * d)),
             2 * r5 * d * 2 + 2 * r5 * 32 * f + d * 3 * d * 2 + 3 * d * f
             + tail_w))
        x0, x1, va0, va1 = mx["b6"][b]
        c32 = (x0.float(), x1.float(), va0, va1)
        rows["fused_cross_block_bf16" + sfx] = (
            lambda a=(x0, x1, va0, va1): flash_cross_block.fused_cross_block(w6, *a),
            lambda a=(x0, x1, va0, va1): flash_cross_block.fused_cross_block_plain(w6, *a),
            lambda a=c32: flash_cross_block.fused_cross_block(v6, *a), None,
            (b * (2 * (n + m1) * d * 2 * d + 6 * n * m1 * d
                  + 2 * (n + m1) * d * d + 2 * (n + m1) * (2 * d * 2 * d
                                                           + 2 * d * d)),
             2 * r6 * d * 2 + r6 + d * 2 * d * 2 + 2 * d * f + tail_w))
    return rows


def mp_timing_phase(mx, x, bx, params):
    """Phase 5e: each bf16 row beside its bf16 plain version and its fp32
    form on the same values (CUDA events, plain, kernel, fp32, fp32,
    kernel, plain; device time from CUDA-graph replays, kernel, fp32 (and
    the library call), in turns), then BatchMatcher at mp against fp32 at
    1024 keypoints (host clock, in turns). Returns ({row: (kernel ms,
    plain ms, library ms)}, {row: (FLOPs, bytes)})."""
    phase("5e timing at mp: the bf16 kernels beside their plain versions "
          "and their fp32 forms (CUDA events; device time by CUDA graphs)")
    rows = mp_rows(mx, x, bx)
    times, bounds = {}, {}
    for name, (kern, plain, f32, lib, bound) in rows.items():
        a, b, c, d, e, g = (time_cuda(fn) for fn in
                            (plain, kern, f32, f32, kern, plain))
        lib_ms = None if lib is None else time_cuda(lib[1])
        kd, fd, fd2, kd2 = (attn_split.graph_ms(fn) for fn in (kern, f32, f32, kern))
        lib_dev = None if lib is None else attn_split.graph_ms(lib[1])
        times[name] = ((b + e) / 2, (a + g) / 2, lib_ms)
        bounds[name] = bound
        t_ops, t_bytes = bound[0] / PEAK_BF16 * 1e3, bound[1] / PEAK_BYTES * 1e3
        print(f"  {name}: kernel {(b + e) / 2:.4f} ms, plain {(a + g) / 2:.4f}"
              f" ms, fp32 form {(c + d) / 2:.4f} ms (runs {b:.4f}/{e:.4f}, "
              f"{a:.4f}/{g:.4f}, {c:.4f}/{d:.4f})"
              + ("" if lib is None else f", library ({lib[0]}) {lib_ms:.4f} ms")
              + f"; device time: kernel {(kd + kd2) / 2:.4f}, fp32 form "
              f"{(fd + fd2) / 2:.4f}"
              + ("" if lib is None else f", library {lib_dev:.4f}")
              + f" ms; bound {max(t_ops, t_bytes):.4f} ms ("
              f"{'operations' if t_ops >= t_bytes else 'bytes'}; bf16 "
              f"operations {t_ops:.4f}, bytes {t_bytes:.4f})", flush=True)

    phase("5e end to end at mp: BatchMatcher (CUDA graphs), 1024 keypoints, "
          "planted pairs, host clock per call, in turns with fp32")
    rng = np.random.default_rng(61)
    for bsz, reps in ((1, 40), (16, 10)):
        pr = planted_pairs(rng, bsz, 1024)
        pairs = [tuple({k: v[i] for k, v in feats(pr, s).items()}
                       for s in (0, 1)) for i in range(bsz)]
        for mode, c in (("fixed", FIXED), ("adaptive", {})):
            confs = {"fp32": dict(c), "mp": dict(c, mp=True),
                     "mp, shift 12": dict(c, mp=True, **SHIFTED)}
            bms = {}
            for label, cc in confs.items():
                bms[label] = BatchMatcher(lightglue_config("superpoint", **cc),
                                          params, buckets=(1024,), max_batch=16)
                bms[label].warmup([bsz])
            ms = {label: [] for label in confs}
            stops = {}
            for label in list(confs) + list(confs)[::-1]:
                bm = bms[label]
                for _ in range(2):
                    bm.match_pairs(pairs)
                for _ in range(reps):
                    t0 = time.perf_counter()
                    res = bm.match_pairs(pairs)
                    ms[label].append((time.perf_counter() - t0) * 1e3)
                stops[label] = res[0]["stop"]
            for label, m in ms.items():
                q1, med, q3 = np.percentile(m, [25, 50, 75])
                print(f"  BatchMatcher {mode} B {bsz}, {label}: "
                      f"{bsz * 1e3 / med:.1f} pairs/s (median {med:.2f} ms a "
                      f"call, quartiles {q1:.2f}-{q3:.2f}, {len(m)} calls, "
                      f"stop {stops[label]})", flush=True)
            del bms
            gc.collect()
            torch.cuda.empty_cache()
    return times, bounds


# --- phase 5f: the extractors' bf16 path (mp) ----------------------------------


def flip_stats(got, ref):
    """(largest reach of MP_REL, of the scaled bound, share of outputs over
    either, share of outputs not equal, largest |got - ref|)."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    rms = r.square().mean(-1, keepdim=True).sqrt()
    rel = d / (MP_REL * r.abs().clamp(min=1.0))
    scaled = torch.where(d == 0, torch.zeros_like(d),
                         d / (MP_SCALED * (r.abs() + rms)))
    n = d.numel()
    return (float(rel.max()), float(scaled.max()),
            int(((rel > 1) | (scaled > 1)).sum()) / n, int((d > 0).sum()) / n,
            float(d.max()))


def flip_faults(stats, dtype):
    """What fails flip_check: outputs over either bound beyond MP_FLIPS, or
    (bf16 outputs) outputs that differ at all beyond MP_DIFFER."""
    return stats[2] > MP_FLIPS or (dtype == BF16 and stats[3] > MP_DIFFER)


def flip_check(errs, name, label, got, ref, dtype=BF16):
    """An extractor's bf16 form against its bf16 plain version: both of
    mp_check's bounds, at all but MP_FLIPS of the outputs, and (bf16
    outputs) equal at all but MP_DIFFER of them. Each rounds an fp32 sum to
    bf16 before a bias or a batch-norm shift (as the TPU kernel does); a sum
    within fp32 noise of a rounding boundary rounds to either neighbour, and
    where the shift cancels most of it the one bf16 step is large against
    the output."""
    if got.dtype != dtype or ref.dtype != dtype:
        raise AssertionError(f"{label}: {got.dtype} / {ref.dtype}, not {dtype}")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{label}: not finite")
    stats = flip_stats(got, ref)
    print(f"  {label}: of |kernel - plain| <= {MP_REL:g} max(1, |plain|) "
          f"{stats[0]:.3f}, of the scaled bound {stats[1]:.3f}; outputs over "
          f"either {stats[2]:.2e} (tol {MP_FLIPS:g}), not equal {stats[3]:.2e}"
          + (f" (tol {MP_DIFFER:g})" if dtype == BF16 else "")
          + f", max_abs_err {stats[4]:.3e}", flush=True)
    if flip_faults(stats, dtype):
        raise AssertionError(f"{label}: {stats}")
    errs[name] = max(errs.get(name, 0.0), stats[4])


def twice(label, fn):
    """fn() launched twice: the outputs (a tensor or a tuple), equal to the
    bit."""
    a, b = fn(), fn()
    for x, y in zip(*(t if isinstance(t, tuple) else (t,) for t in (a, b))):
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: two launches differ")
    return a


def mp_extract_kernel_phase(sp_params, ap, ax):
    """Phase 5f, kernels: each bf16 form against its bf16 plain version
    (flip_check), each launch twice equal to the bit: B7 at B 2, 1 and 8
    (768 x 1024) and at widths that leave the last 128-column strip part
    full (36 x 76, 2 x 40 x 200), its map NHWC; B8 (and B8's conv2a launch)
    on each of those maps as B7 wrote it (NHWC) and as the plain version's
    contiguous NCHW, and at B 2 on NCHW inputs 1 and 8 elements off a
    16-byte boundary; B10 at aliked-n16 and
    t16 at B 2, 1 and 8 (768 x 1024) and at widths that leave the last strip
    part full (34 x 70, which TMA reads through a padded copy, and 2 x 40 x
    200), B11 and B12 at B 1, 2 and 8 on the ALIKED images' branch parts
    and on random parts at 40 x 70, 40 x 72, 61 x 83 (B 2) and 32 x 100 (s4
    one row), B12 also on an s0 one element off a 16-byte boundary.
    Probes: B7 with one of conv1b's taps zeroed, and rounded only at its
    output, and B12 with a tap of conv 4->4 zeroed, must break the check.
    Returns (errors, the B 2 inputs for timing)."""
    phase("5f the extractors' bf16 kernels (mp) against their bf16 plain "
          "versions")
    errs = {}
    rng = np.random.default_rng(67)
    img = torch.from_numpy(np.stack([image_pair(rng, H, W)[0] for _ in range(2)])
                           ).cuda()[:, None]
    g = torch.Generator(device="cuda").manual_seed(68)
    p1 = {"conv1a": sp_params["conv1a"], "conv1b": sp_params["conv1b"]}
    p2 = {"conv2a": sp_params["conv2a"], "conv2b": sp_params["conv2b"]}
    # B 2, 1 and 8 at 768 x 1024, and widths that leave the last 128-column
    # strip part full (76: one strip of 76, 200: 128 + 72)
    rng8 = np.random.default_rng(69)
    eight = torch.from_numpy(np.stack([image_pair(rng8, H, W)[0] for _ in range(6)])
                             ).cuda()[:, None]
    eight = torch.cat([img, eight])
    for x in (img, eight[:1].contiguous(), eight,
              torch.rand(1, 1, 36, 76, generator=g, device="cuda"),
              torch.rand(2, 1, 40, 200, generator=g, device="cuda")):
        shape = tuple(x.shape)
        got = twice("fused_stem_bf16", lambda: stem.fused_stem(p1, x, mp=True))
        ref = stem.fused_stem_plain(p1, x, mp=True)
        flip_check(errs, "fused_stem_bf16", f"fused_stem_bf16 {shape}", got, ref)
        if not got.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError("fused_stem_bf16: its map is not NHWC")
        # B8 on B7's own NHWC map (no copy) and on the contiguous NCHW plain
        # one (one copy), and at B 2 on NCHW inputs 1 and 8 elements off a
        # 16-byte boundary
        inputs = [("NHWC", got), ("NCHW", ref)]
        if shape[0] == 2 and shape[2] == H:
            for off in (1, 8):
                buf = torch.empty(ref.numel() + off, device="cuda", dtype=BF16)
                y = buf[off:].view_as(ref)
                y.copy_(ref)
                inputs.append((f"NCHW, {off} elements off 16 bytes", y))
        for tag, y in inputs:
            for name, kern, plain, p in (
                    ("fused_block2_bf16", stem2.fused_block2,
                     stem2.fused_block2_plain, p2),
                    ("fused_block2_bf16", stem2.conv3x3_relu,
                     stem2.conv3x3_relu_plain, p2["conv2a"])):
                label = name if kern is stem2.fused_block2 else "its conv2a launch"
                out = twice(label, lambda: kern(p, y))
                flip_check(errs, name, f"{label} {tuple(y.shape)} {tag}", out,
                           plain(p, y))
    # probes: what the check reads for a kernel that drops one of conv1b's
    # taps, or rounds only at its output
    cut = {"conv1a": p1["conv1a"], "conv1b": {
        "w": p1["conv1b"]["w"].clone(), "b": p1["conv1b"]["b"]}}
    cut["conv1b"]["w"][:, :, 1, 1] = 0
    ref = stem.fused_stem_plain(p1, img, mp=True)
    for what, bad in (("a tap dropped", stem.fused_stem_plain(cut, img, mp=True)),
                      ("rounded only at the output",
                       stem.fused_stem_plain(p1, img).to(BF16))):
        stats = flip_stats(bad, ref)
        print(f"  probe, B7 {what}: outputs over either bound {stats[2]:.3e}, "
              f"not equal {stats[3]:.3e} (flip_check fails above {MP_FLIPS:g} "
              f"and {MP_DIFFER:g})", flush=True)
        if not flip_faults(stats, BF16):
            raise AssertionError(f"the bf16 check cannot see B7 {what}")

    rgbs = torch.from_numpy(np.stack([rgb(image_pair(rng, H, W)[0])
                                      for _ in range(2)])).cuda()
    rgbs = rgbs.permute(0, 3, 1, 2).contiguous().to(BF16)
    rgb8 = torch.from_numpy(np.stack([rgb(image_pair(rng8, H, W)[0])
                                      for _ in range(6)])).cuda()
    rgb8 = torch.cat([rgbs, rgb8.permute(0, 3, 1, 2).to(BF16)]).contiguous()
    t16 = aliked_params("aliked-t16")
    small = (torch.rand(1, 3, 34, 70, generator=g, device="cuda").to(BF16),
             torch.rand(2, 3, 40, 200, generator=g, device="cuda").to(BF16))
    for name, p in (("aliked-n16", ap), ("aliked-t16", t16)):
        sp_ = {"block1": p["block1"], "conv1": p["conv1"]}
        for x in (rgbs, rgb8[:1].contiguous(), rgb8, *small):
            got = twice("fused_aliked_stem_bf16",
                        lambda: aliked_stem.fused_aliked_stem_kernel(sp_, x))
            ref = aliked_stem.fused_aliked_stem_plain(sp_, x)
            for part, a, b in (("y1", got[0], ref[0]), ("x1p", got[1], ref[1])):
                flip_check(errs, "fused_aliked_stem_bf16",
                           f"fused_aliked_stem_bf16 {name} {tuple(x.shape)} {part}",
                           a, b)
    sh = ap["score_head"]
    for b in (2, 1, 8):
        parts = [p[:b].contiguous() for p in ax["parts8"]]
        s0 = score_head.upsampled_sum(*parts)
        for name, kern, plain in (
                ("score_head_lazy_bf16",
                 lambda: score_head.score_head_lazy_kernel(sh, *parts, mp=True),
                 lambda: score_head.score_head_lazy_plain(sh, *parts, mp=True)),
                ("score_head_cplane_bf16",
                 lambda: score_head.score_head_cplane_kernel(sh, s0, mp=True),
                 lambda: score_head.score_tail_plain(sh, s0, mp=True))):
            got = twice(name, kern)
            flip_check(errs, name, f"{name} ({b}, 8, {H}, {W})", got, plain(),
                       torch.float32)
    # ragged: widths that are not a multiple of 8 or of 4 (TMA reads a
    # padded copy), an odd height, a branch of one row (H 32: s4 is 1 x 3),
    # and s0 one element off a 16-byte boundary
    for b, h, w in ((1, 40, 70), (1, 40, 72), (2, 61, 83), (1, 32, 100)):
        parts = [torch.randn(b, 8, max(1, h // k), max(1, w // k), generator=g,
                             device="cuda") for k in (1, 2, 8, 32)]
        s0 = score_head.upsampled_sum(*parts)
        inputs = [("", s0)]
        if w == 72:
            buf = torch.empty(s0.numel() + 1, device="cuda")
            off = buf[1:].view_as(s0)
            off.copy_(s0)
            inputs.append((", s0 one element off 16 bytes", off))
        got = twice("score_head_lazy_bf16",
                    lambda: score_head.score_head_lazy_kernel(sh, *parts, mp=True))
        flip_check(errs, "score_head_lazy_bf16",
                   f"score_head_lazy_bf16 ({b}, 8, {h}, {w}), s4 {tuple(parts[3].shape[2:])}",
                   got, score_head.score_head_lazy_plain(sh, *parts, mp=True),
                   torch.float32)
        for tag, x in inputs:
            got = twice("score_head_cplane_bf16",
                        lambda: score_head.score_head_cplane_kernel(sh, x, mp=True))
            flip_check(errs, "score_head_cplane_bf16",
                       f"score_head_cplane_bf16 ({b}, 8, {h}, {w}){tag}", got,
                       score_head.score_tail_plain(sh, s0, mp=True), torch.float32)
    # probe: what the check reads for a score head that drops one tap of
    # conv 4->4
    s0 = score_head.upsampled_sum(*[p[:2].contiguous() for p in ax["parts8"]])
    cut = {**sh, "4": {"w": sh["4"]["w"].clone()}}
    cut["4"]["w"][:, :, 1, 1] = 0
    stats = flip_stats(score_head.score_tail_plain(cut, s0, mp=True),
                       score_head.score_tail_plain(sh, s0, mp=True))
    print(f"  probe, B12 with a tap dropped: outputs over either bound "
          f"{stats[2]:.3e}, not equal {stats[3]:.3e} (flip_check fails above "
          f"{MP_FLIPS:g} and {MP_DIFFER:g})", flush=True)
    if not flip_faults(stats, torch.float32):
        raise AssertionError("the bf16 check cannot see B12 with a tap dropped")
    torch.cuda.synchronize()
    # B8's rows read B7's own map, NHWC, as the main path hands it on
    return errs, {"img": img, "stem_out": stem.fused_stem(p1, img, mp=True),
                  "rgb": rgbs[:2], "parts8": ax["parts8"]}


def mp_common(gpu, cpu, tol):
    """(keypoints in common (least of the two images), matches0 equal on
    the common keypoints): two (feats0, feats1, matches) of one pair, the
    card's and the CPU port's."""
    common = [common_keypoints(gpu[s], cpu[s], tol) for s in (0, 1)]
    shares = [len(common[s]) / max(1, gpu[s]["valid"].sum()) for s in (0, 1)]
    other = {int(i): int(j) for i, j in common[1]}
    gm, cm = gpu[2]["matches0"], cpu[2]["matches0"]
    same = [(-1 if gm[i] < 0 else other.get(int(gm[i]), -2)) == int(cm[j])
            for i, j in common[0]]
    return min(shares), float(np.mean(same)) if same else 1.0


def e2e_feats(e2e, i):
    """Pair i of an E2EOutput as match_pair's (feats0, feats1, matches)."""
    f = [{"keypoints": getattr(e2e, f"feats{s}").keypoints[i].cpu().numpy(),
          "descriptors": getattr(e2e, f"feats{s}").descriptors[i].cpu().numpy(),
          "valid": getattr(e2e, f"feats{s}").valid[i].cpu().numpy()}
         for s in (0, 1)]
    m = {k: getattr(e2e.matches, k)[i].cpu().numpy()
         for k in ("matches0", "matches1", "matching_scores0")}
    m["stop"] = e2e.matches.stop
    return (*f, m)


def mp_extract_path_phase(mparams, sp_params, ap):
    """Phase 5f, main paths at mp: images -> SuperPoint(mp=True) ->
    LightGlue("superpoint", mp=True) through match_pair (2048 keypoints)
    and make_end_to_end (B 8, 1024 keypoints, fixed), and images ->
    ALIKED(mp=True) -> LightGlue("aliked", mp=True) in MP_ALIKED_PATHS'
    configurations: only bf16 extractor kernels launched, each against the
    CPU port at mp (matches0 on the keypoints in common >= MP_AGREE; their
    share >= MP_KPT and above the share in common with the card's fp32
    extraction of the same pair). Returns the launch counts."""
    rng = np.random.default_rng(71)
    pairs = [image_pair(rng, H, W) for _ in range(8)]
    total = dict.fromkeys(KERNELS, 0)
    phase("5f main path at mp: images -> SuperPoint(mp=True) -> "
          "LightGlue(mp=True), match_pair and make_end_to_end (B 8, 1024)")
    ext = SuperPoint(params=sp_params, device="cuda", mp=True)
    matcher = LightGlue("superpoint", params=mparams, device="cuda", mp=True)
    run = end_to_end.make_end_to_end(
        sp.forward, sp_params, SuperPointConfig(max_num_keypoints=1024, mp=True),
        matcher.params, matcher.conf.replace(**FIXED))
    im0, im1 = (torch.from_numpy(np.stack([p[i] for p in pairs]))[..., None].cuda()
                for i in (0, 1))
    sizes = torch.tensor([[W, H]] * 8, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = match_pair(ext, matcher, *pairs[0][:2])
    e2e = run(im0, im1, sizes, sizes)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"  launch counts: { {k: c for k, c in counts.items() if c} }")
    for k in ("fused_stem_bf16", "fused_block2_bf16", "simple_nms",
              "fused_self_block_bf16", "fused_filter_matches"):
        if counts[k] < 1:
            raise AssertionError(f"{k} was not launched at mp")
    for k in FP32_EXTRACT + FP32_MATCHER:
        if counts[k]:
            raise AssertionError(f"{k} (fp32) was launched at mp")
    for k, c in counts.items():
        total[k] += c
    check_pair_output("match_pair at mp", *out, (W, H), (W, H))
    for i in range(8):
        check_pair_output(f"make_end_to_end at mp B 8, pair {i}",
                          *e2e_feats(e2e, i), (W, H), (W, H))
    cpu_sp = nn.params_to(sp_params, "cpu")
    cpu_ext = SuperPoint(params=cpu_sp, device="cpu", mp=True)
    cpu_matcher = LightGlue("superpoint", params=mparams, device="cpu", mp=True)
    cpu = match_pair(cpu_ext, cpu_matcher, *pairs[0][:2])
    crun = end_to_end.make_end_to_end(
        sp.forward, cpu_sp, SuperPointConfig(max_num_keypoints=1024, mp=True),
        cpu_matcher.params, cpu_matcher.conf.replace(**FIXED))
    ce2e = crun(im0[:1].cpu(), im1[:1].cpu(), sizes[:1].cpu(), sizes[:1].cpu())
    f32 = match_pair(SuperPoint(params=sp_params, device="cuda"), matcher,
                     *pairs[0][:2])
    fe2e = end_to_end.make_end_to_end(
        sp.forward, sp_params, SuperPointConfig(max_num_keypoints=1024),
        matcher.params, matcher.conf.replace(**FIXED))(im0[:1], im1[:1],
                                                       sizes[:1], sizes[:1])
    for label, a, b, c in (("match_pair", out, cpu, f32),
                           ("make_end_to_end pair 0", e2e_feats(e2e, 0),
                            e2e_feats(ce2e, 0), e2e_feats(fe2e, 0))):
        mp_agree(label, a, b, c, 0.0, MP_KPT[0])

    views = [(rgb(a), rgb(b)) for a, b, _ in pairs[:2]]
    amatcher = LightGlue("aliked", device="cuda", mp=True)
    cpu_amatcher = LightGlue("aliked", device="cpu", mp=True)
    cpu_ap = nn.params_to(ap, "cpu")
    for label, cfg, must in MP_ALIKED_PATHS:
        phase(f"5f main path at mp: images -> ALIKED(mp=True, {label}) -> "
              "LightGlue('aliked', mp=True), match_pair at 2048 keypoints")
        ext = ALIKED(params=ap, device="cuda", mp=True, **cfg)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = match_pair(ext, amatcher, *views[0])
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        print(f"  launch counts: { {k: c for k, c in counts.items() if c} }")
        for k in must + ("simple_nms", "fused_self_block_bf16"):
            if counts[k] < 1:
                raise AssertionError(f"ALIKED {label} at mp: {k} not launched")
        for k in FP32_EXTRACT + FP32_MATCHER:
            if counts[k]:
                raise AssertionError(f"ALIKED {label} at mp: {k} (fp32) launched")
        for k, c in counts.items():
            total[k] += c
        check_pair_output(f"ALIKED {label} at mp", *out, (W, H), (W, H))
        cpu = match_pair(ALIKED(params=cpu_ap, device="cpu", mp=True, **cfg),
                         cpu_amatcher, *views[0])
        f32 = match_pair(ALIKED(params=ap, device="cuda", **cfg), amatcher,
                         *views[0])
        mp_agree(f"ALIKED {label}", out, cpu, f32, MP_KPT_TOL, MP_KPT[1])
    return total


def mp_agree(label, gpu, cpu, fp32, tol, floor):
    """The card at mp against the CPU port at mp on one pair: matches0 on
    the keypoints in common >= MP_AGREE, their share >= floor and above
    the share the card's mp keypoints have in common with its fp32 ones."""
    share, same = mp_common(gpu, cpu, tol)
    ref = mp_common(gpu, fp32, tol)[0]
    print(f"  {label} against the CPU port at mp: keypoints in common within "
          f"{tol} px {share:.6f} (tol {floor:g}, and above {ref:.6f}, the "
          f"share in common with the card's fp32 keypoints), matches0 equal on "
          f"them {same:.6f} (tol {MP_AGREE:g})", flush=True)
    if share < floor or share <= ref or same < MP_AGREE:
        raise AssertionError(f"{label} at mp: the card disagrees with the CPU "
                             "port")


def mp_extract_rows(mx5, sp_params, ap):
    """Phase 5e's extractor rows: {row: (bf16 form, its plain version, its
    fp32 form on the same values, (FLOPs, bytes))} at B 2, 768 x 1024 (B11
    and B12 also at B 1 and 8). The bf16 bound counts the convolutions'
    products and bf16 maps at 2 bytes (the image of B7 and the score maps
    fp32); B11's and B12's bytes are the fp32 form's (fp32 maps in and out),
    their products on the tensor cores (``ops_ms``)."""
    img, x2, rgbs = mx5["img"], mx5["stem_out"], mx5["rgb"]
    p1 = {"conv1a": sp_params["conv1a"], "conv1b": sp_params["conv1b"]}
    p2 = {"conv2a": sp_params["conv2a"], "conv2b": sp_params["conv2b"]}
    stem_p = {"block1": ap["block1"], "conv1": ap["conv1"]}
    x2f, rgbf = x2.float().contiguous(), rgbs.float()
    sh = ap["score_head"]
    n = 2 * H * W
    fb = kernel_bounds()
    rows = {
        "fused_stem_bf16": (
            lambda: stem.fused_stem(p1, img, mp=True),
            lambda: stem.fused_stem_plain(p1, img, mp=True),
            lambda: stem.fused_stem(p1, img),
            (fb["fused_stem"][0], n * 4 + n // 4 * 64 * 2)),
        "fused_block2_bf16": (
            lambda: stem2.fused_block2(p2, x2),
            lambda: stem2.fused_block2_plain(p2, x2),
            lambda: stem2.fused_block2(p2, x2f),
            (fb["fused_block2"][0], n // 4 * 64 * 2 + n // 16 * 64 * 2)),
        "fused_aliked_stem_bf16": (
            lambda: aliked_stem.fused_aliked_stem_kernel(stem_p, rgbs),
            lambda: aliked_stem.fused_aliked_stem_plain(stem_p, rgbs),
            lambda: aliked_stem.fused_aliked_stem_kernel(stem_p, rgbf),
            (fb["fused_aliked_stem"][0], n * (3 + 32 + 16 / 4) * 2)),
    }
    for b in (2, 1, 8):
        parts = [p[:b].contiguous() for p in mx5["parts8"]]
        s0 = score_head.upsampled_sum(*parts)
        sfx = "" if b == 2 else f" B {b}"
        rows["score_head_lazy_bf16" + sfx] = (
            lambda parts=parts: score_head.score_head_lazy_kernel(sh, *parts, mp=True),
            lambda parts=parts: score_head.score_head_lazy_plain(sh, *parts, mp=True),
            lambda parts=parts: score_head.score_head_lazy_kernel(sh, *parts),
            fb["score_head_lazy" + sfx])
        rows["score_head_cplane_bf16" + sfx] = (
            lambda s0=s0: score_head.score_head_cplane_kernel(sh, s0, mp=True),
            lambda s0=s0: score_head.score_tail_plain(sh, s0, mp=True),
            lambda s0=s0: score_head.score_head_cplane_kernel(sh, s0),
            fb["score_head_cplane" + sfx])
    return rows


def mp_extract_timing_phase(mx5, mparams, sp_params, ap):
    """Phase 5e, extractors: each bf16 form beside its plain version and
    its fp32 form (CUDA events: plain, kernel, fp32, fp32, kernel, plain;
    device time from CUDA-graph replays, kernel, fp32, fp32, kernel) and
    its bound; SuperPoint and ALIKED ms per image at mp and fp32, B 1 and
    8; make_end_to_end pairs/s at mp and fp32, B 8 (host clock, in turns).
    Returns ({row: (kernel ms, plain ms, None)}, {row: (FLOPs, bytes)},
    {row: (device ms, None)})."""
    phase("5e timing at mp: the extractors' bf16 kernels beside their plain "
          "versions and fp32 forms (CUDA events; device time by CUDA graphs)")
    times, bounds, graph_times = {}, {}, {}
    for name, (kern, plain, f32, bound) in mp_extract_rows(
            mx5, sp_params, ap).items():
        a, b, c, d, e, g = (time_cuda(fn, iters=10) for fn in
                            (plain, kern, f32, f32, kern, plain))
        kd, fd, fd2, kd2 = (attn_split.graph_ms(fn, calls=10)
                            for fn in (kern, f32, f32, kern))
        times[name] = ((b + e) / 2, (a + g) / 2, None)
        bounds[name] = bound
        graph_times[name] = ((kd + kd2) / 2, None)
        t_ops, t_bytes = ops_ms(name, bound[0]), bound[1] / PEAK_BYTES * 1e3
        print(f"  {name}: kernel {(b + e) / 2:.4f} ms, plain {(a + g) / 2:.4f}"
              f" ms, fp32 form {(c + d) / 2:.4f} ms (runs {b:.4f}/{e:.4f}, "
              f"{a:.4f}/{g:.4f}, {c:.4f}/{d:.4f}); device time: kernel "
              f"{(kd + kd2) / 2:.4f}, fp32 form {(fd + fd2) / 2:.4f} ms (runs "
              f"{kd:.4f}/{kd2:.4f}, {fd:.4f}/{fd2:.4f}); bound "
              f"{max(t_ops, t_bytes):.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}"
              f"; operations {t_ops:.4f}, bytes {t_bytes:.4f})", flush=True)
    # a yardstick the port never calls: cuDNN's bf16 3x3 conv (channels_last)
    # on conv1b's and conv2a's shapes at B 2, the same products without the
    # rounding before the bias (so not the function B7 or B8 computes)
    for label, shape, w in (
            ("conv1b", (2, 64, H, W), sp_params["conv1b"]["w"]),
            ("conv2a", (2, 64, H // 2, W // 2), sp_params["conv2a"]["w"])):
        xa = torch.rand(shape, device="cuda").to(BF16).contiguous(
            memory_format=torch.channels_last)
        wa = w.to(BF16).contiguous(memory_format=torch.channels_last)
        dev = attn_split.graph_ms(
            lambda: torch.nn.functional.conv2d(xa, wa, padding=1), calls=10)
        print(f"  cuDNN bf16 conv2d (channels_last) on {label}'s shape "
              f"{shape}: device {dev:.4f} ms (a yardstick, not the same "
              "function)", flush=True)
        del xa

    phase("5e end to end at mp: SuperPoint and ALIKED ms per image, "
          "make_end_to_end pairs/s, mp against fp32 (in turns)")
    rng = np.random.default_rng(73)
    pool = [image_pair(rng, H, W) for _ in range(8)]
    gray = torch.from_numpy(np.stack([p[0] for p in pool]))[..., None].cuda()
    colour = torch.from_numpy(np.stack([rgb(p[0]) for p in pool])).cuda()
    for label, fwd, params, conf, imgs in (
            ("SuperPoint", sp.forward, sp_params, SuperPointConfig(), gray),
            ("ALIKED", al.forward, ap, ALIKEDConfig(), colour)):
        for bsz in (1, 8):
            ms = {}
            for mp in (False, True, True, False):
                c = conf.replace(mp=mp)
                ms.setdefault(mp, []).append(time_cuda(
                    lambda: fwd(params, c, imgs[:bsz]), iters=5) / bsz)
            print(f"  {label} extraction B {bsz}, {H}x{W}: fp32 "
                  f"{np.mean(ms[False]):.3f} ms per image (runs "
                  f"{ms[False][0]:.3f}/{ms[False][1]:.3f}), mp "
                  f"{np.mean(ms[True]):.3f} (runs {ms[True][0]:.3f}/"
                  f"{ms[True][1]:.3f})", flush=True)
    im1 = torch.from_numpy(np.stack([p[1] for p in pool]))[..., None].cuda()
    sizes = torch.tensor([[W, H]] * 8, dtype=torch.float32, device="cuda")
    lgp = LightGlue("superpoint", params=mparams, device="cuda").params
    runs = {mp: end_to_end.make_end_to_end(
        sp.forward, sp_params, SuperPointConfig(max_num_keypoints=1024, mp=mp),
        lgp, lightglue_config("superpoint", mp=mp, **FIXED)) for mp in (False, True)}
    ms = {False: [], True: []}
    for mp in (False, True, True, False):
        run = runs[mp]
        for _ in range(2):
            run(gray, im1, sizes, sizes)
        torch.cuda.synchronize()
        for _ in range(6):
            t0 = time.perf_counter()
            run(gray, im1, sizes, sizes)
            torch.cuda.synchronize()
            ms[mp].append((time.perf_counter() - t0) * 1e3)
    for mp in (False, True):
        q1, med, q3 = np.percentile(ms[mp], [25, 50, 75])
        print(f"  make_end_to_end fixed B 8, {H}x{W}, 1024 keypoints, "
              f"{'mp' if mp else 'fp32'}: {8 * 1e3 / med:.1f} pairs/s (median "
              f"{med:.2f} ms a call, quartiles {q1:.2f}-{q3:.2f}, "
              f"{len(ms[mp])} calls)", flush=True)
    return times, bounds, graph_times


def mp_profile_phase(params):
    phase("P profile at mp: BatchMatcher(mp=True) (CUDA graphs) at 1024 "
          "keypoints, B 1 and B 16, beside fp32")
    rng = np.random.default_rng(11)
    for bsz in (1, 16):
        pr = planted_pairs(rng, bsz, 1024)
        pairs = [tuple({k: v[i] for k, v in feats(pr, s).items()} for s in (0, 1))
                 for i in range(bsz)]
        for mode, c in (("fixed", FIXED), ("adaptive", {})):
            for label, cc in (("mp", dict(c, mp=True)),
                              ("mp, shift 12", dict(c, mp=True, **SHIFTED))):
                bm = BatchMatcher(lightglue_config("superpoint", **cc), params,
                                  buckets=(1024,), max_batch=16)
                bm.warmup([bsz])
                out = profile_call(f"BatchMatcher {mode} B {bsz}, {label}, "
                                   "1024 keypoints", lambda: bm.match_pairs(pairs))
                print(f"    (stop {out[0]['stop']})")
                del bm
                gc.collect()


# --- phase 5i: the bf16 walk and tile product at TMA's edges -------------------


def off128(t):
    """t's values in a tensor of its own whose data starts 16 bytes past a
    128-byte boundary inside a larger allocation (TMA takes 16-byte aligned
    rows; the tiles land 128-byte swizzled all the same)."""
    buf = torch.empty(t.numel() + 128, dtype=t.dtype, device=t.device)
    e = ((16 - buf.data_ptr() % 128) % 128) // t.element_size()
    out = buf[e:e + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 128 == 16
    return out


def mp_tma_edge_phase(bx):
    """The wgmma walk (K1, B1s, B1', K2's three walks) and the wgmma tile
    product (B4, B5, B6) where TMA and the tiles have edges: one key; query
    and key counts that are no multiple of the tiles; a batch entry with no
    valid key; B 1 at every split count; rows 16 bytes past a 128-byte
    boundary inside a larger allocation. Each against its bf16 plain
    version under both bounds, each launch twice bit for bit."""
    phase("5i the bf16 walk and tile product (wgmma, TMA) at their edges: "
          "one key, ragged counts, an all-masked entry, B 1 at every split "
          "count, rows off a 128-byte boundary")
    g = torch.Generator(device="cuda").manual_seed(61)
    errs = {}

    def r(*shape):
        return rand(g, *shape).to(BF16)

    def mask(b, n):
        m = torch.rand(b, n, generator=g, device="cuda") < 0.8
        m[:, 0] = True
        if b > 1:
            m[1] = False
        return m

    def twice(label, fn):
        got = fn()
        same(label, got, fn())
        return got

    def rows(valid, h):
        return None if valid is None else valid[:, None].expand(
            -1, h, -1)

    for d in (64, 128):
        dtag = "" if d == 64 else "_d128"
        for b, nq, nk in ((2, 5, 1), (2, 200, 77), (3, 129, 1000)):
            q, k, v = r(b, 2, nq, d), r(b, 2, nk, d), r(b, 2, nk, d)
            for valid in (None, mask(b, nk)):
                for shift in (None, SHIFT):
                    name = ("flash_sdpa" + ("" if shift is None else "_shift")
                            + "_bf16" + dtag)
                    label = (f"{name} {(b, 2, nq, nk)}"
                             f"{'' if valid is None else ' masked'}")
                    got, = twice(label, lambda: (flash.flash_sdpa(
                        q, k, v, valid, shift=shift),))
                    mp_check(errs, name, label, got,
                             flash.flash_sdpa_plain(q, k, v, valid, shift))
            v0, va0, va1 = r(b, 2, nq, d), mask(b, nq), mask(b, nk)
            label = f"flash_cross_pair_bf16 d {d} {(b, 2, nq, nk)} masked"
            got = twice(label, lambda: flash.flash_cross_pair(
                q, k, v0, v, va0, va1))
            ref = flash.flash_cross_pair_plain(q, k, v0, v, va0, va1)
            for i, va in ((0, va0), (1, va1)):
                mp_check(errs, "flash_cross_pair_bf16", f"{label}, m{i}, "
                         "valid rows", got[i], ref[i], rows(va, 2))
        # rows off a 128-byte boundary
        q, k, v = (off128(r(2, 2, n, d)) for n in (300, 333, 333))
        valid = mask(2, 333)
        name = "flash_sdpa_bf16" + dtag
        label = f"{name} (2, 2, 300, 333), rows off a 128-byte boundary"
        got, = twice(label, lambda: (flash.flash_sdpa(q, k, v, valid),))
        mp_check(errs, name, label, got, flash.flash_sdpa_plain(q, k, v,
                                                                valid))
        v0 = off128(r(2, 2, 300, d))
        label = f"flash_cross_pair_bf16 d {d}, rows off a 128-byte boundary"
        got = twice(label, lambda: flash.flash_cross_pair(q, k, v0, v, None,
                                                          valid))
        ref = flash.flash_cross_pair_plain(q, k, v0, v, None, valid)
        for i in (0, 1):
            mp_check(errs, "flash_cross_pair_bf16", f"{label}, m{i}", got[i],
                     ref[i])
        # B 1 at every split count
        q, k, v = r(1, 2, 256, d), r(1, 2, 1000, d), r(1, 2, 1000, d)
        valid = mask(1, 1000)
        key_tile = flash.walk_shape(0, d, BF16).key_tile
        ref = flash.flash_sdpa_plain(q, k, v, valid)
        for sp in range(1, min(flash.MAX_SPLITS, -(-1000 // key_tile)) + 1):
            def split_call():
                o = torch.empty_like(q)
                flash.launch_attention(q.device, [(q, k, v, valid, o)],
                                       flash.bf16_value(d ** -0.5), None, [sp])
                return (o,)
            label = f"flash_sdpa_bf16{dtag} (1, 2, 256, 1000), {sp} splits"
            got, = twice(label, split_call)
            mp_check(errs, "flash_sdpa_bf16" + dtag, label, got, ref)
    # K2's three walks: launch_cross in each mode, against its plain launches
    scale = 64 ** -0.5
    for b, m, n in ((2, 5, 1), (2, 200, 77), (3, 129, 1000), (1, 1000, 300)):
        qk0, qk1, v0, v1 = r(b, 4, m, 64), r(b, 4, n, 64), r(b, 4, m, 64), \
            r(b, 4, n, 64)
        va0, va1 = mask(b, m), mask(b, n)
        if b == 1 and m == 1000:
            qk0, qk1, v0, v1 = map(off128, (qk0, qk1, v0, v1))
        tiles0 = -(-n // flash.walk_shape(0, 64, BF16).key_tile)
        tiles1 = -(-m // flash.walk_shape(0, 64, BF16).key_tile)
        splits = [None] + ([(s0, s1) for s0 in range(1, min(8, tiles0) + 1)
                            for s1 in (1, min(8, tiles1))] if b == 1 else [])
        for mode, name in ((flash_cross.EXACT, "fused_cross_attention_bf16"),
                           (flash_cross.EXACT_BLOCK, "fused_cross_block_bf16"),
                           (flash_cross.SHIFT,
                            "fused_cross_attention_shift_bf16")):
            s2 = SHIFT * flash.LOG2E if mode == flash_cross.SHIFT else 0.0
            sc = scale * (flash.LOG2E if mode == flash_cross.SHIFT else 1.0)
            q0 = (qk0.float() * flash.bf16_value(sc)).to(BF16)
            for sp in splits:
                label = (f"K2 mode {mode} {(b, 4, m, n)}"
                         + ("" if sp is None else f", splits {sp}")
                         + (", rows off a 128-byte boundary"
                            if b == 1 and m == 1000 else ""))
                got = twice(label, lambda: flash_cross.launch_cross(
                    q0, qk1, v0, v1, va0, va1, mode, 1.0, s2, splits=sp))
                if mode == flash_cross.EXACT_BLOCK:
                    ref = flash_cross_block.cross_block_attention_plain(
                        q0, qk1, v0, v1, va0, va1)
                else:
                    ref = flash_cross.fused_cross_attention_plain(
                        qk0, qk1, v0, v1, va0, va1,
                        None if mode == flash_cross.EXACT else SHIFT)
                for i, va in ((0, va0), (1, va1)):
                    mp_check(errs, name, f"{label}, m{i}, valid rows", got[i],
                             ref[i], rows(va, 4))
    # the tile product: B4, B5 and B6 at ragged rows and rows off 128 bytes
    layer = bx["layer"]
    pf = layer["self_attn"]["ffn"]
    w5 = flash_self.prepare(layer["self_attn"], 4, None, mp=True)
    w6 = flash_cross_block.prepare(layer["cross_attn"], 4, None, mp=True)
    for b, n, off in ((1, 77, False), (3, 1000, False), (2, 333, True)):
        x, msg = r(b, n, 256), r(b, n, 256)
        if off:
            x, msg = off128(x), off128(msg)
        tag = f"{(b, n, 256)}{', rows off a 128-byte boundary' if off else ''}"
        got, = twice(f"B4 {tag}", lambda: (ffn.fused_ffn_residual(x, msg, pf),))
        mp_check(errs, "fused_ffn_residual_bf16", f"fused_ffn_residual_bf16 "
                 f"{tag}", got, ffn.fused_ffn_residual_plain(x, msg, pf))
        ang = torch.rand(b, 1, n, 32, generator=g, device="cuda") * 6 - 3
        enc = torch.stack([ang.cos(), ang.sin()])
        valid = mask(b, n)
        got, = twice(f"B5 {tag}", lambda: (flash_self.fused_self_block(
            w5, x, enc, valid),))
        mp_check(errs, "fused_self_block_bf16", f"fused_self_block_bf16 {tag}",
                 got, flash_self.fused_self_block_plain(w5, x, enc, valid))
        x1 = r(b, 129, 256)
        va1 = mask(b, 129)
        got = twice(f"B6 {tag}", lambda: flash_cross_block.fused_cross_block(
            w6, x, x1, valid, va1))
        ref = flash_cross_block.fused_cross_block_plain(w6, x, x1, valid, va1)
        for i, va in ((0, valid), (1, va1)):
            mp_check(errs, "fused_cross_block_bf16", f"fused_cross_block_bf16 "
                     f"{tag} / N 129, image {i}, valid rows", got[i], ref[i],
                     va)
    torch.cuda.synchronize()
    return errs


# --- phase 5g: head_dim 128 at mp -----------------------------------------------


# The bf16 forms at head_dim 128 and the matcher paths that launch them
HEAD128_MP = ("flash_sdpa_bf16_d128", "flash_sdpa_shift_bf16_d128",
              "flash_cross_pair_bf16", "fused_self_block_bf16_d128")
# pipeline.LightGlue(mp=True, num_heads=2) in phase 5g: (name, config,
# kernels it must launch), never an fp32 matcher kernel or B6 / K2
MP_HEAD128_PATHS = (
    ("default, exact, fixed", FIXED,
     ("fused_self_block_bf16_d128", "flash_cross_pair_bf16",
      "fused_ffn_residual_bf16", "fused_filter_matches")),
    ("default, shift 12, adaptive", SHIFTED,
     ("fused_self_block_bf16_d128", "flash_cross_pair_bf16",
      "fused_ffn_residual_bf16", "fused_filter_matches")),
    ("composed, exact, fixed", dict(FIXED, **COMPOSED),
     ("flash_sdpa_bf16_d128", "flash_cross_pair_bf16",
      "fused_ffn_residual_bf16", "fused_filter_matches")),
    ("composed, shift 12, fixed", dict(FIXED, **COMPOSED, **SHIFTED),
     ("flash_sdpa_shift_bf16_d128", "flash_cross_pair_bf16",
      "fused_ffn_residual_bf16", "fused_filter_matches")),
)
NOT_HEAD128_MP = FP32_MATCHER + ("flash_cross_pair", "fused_cross_block_bf16",
                                 "fused_cross_attention_bf16",
                                 "fused_cross_attention_shift_bf16",
                                 "fused_self_block_bf16", "flash_sdpa_bf16",
                                 "flash_sdpa_shift_bf16")


def differ_share(got, ref):
    """Share of outputs not equal to the plain version's (the flips of a
    sum that rounds to the other bf16 neighbour)."""
    return float((got != ref).float().mean())


def mp_head128_kernel_phase(params2):
    """Phase 5g: the bf16 forms at head_dim 128 against their bf16 plain
    versions on the card (both bounds of mp_check, the share of outputs
    not equal printed), each launch twice bit for bit: K1 exact and shift
    12 at (4, 2, 1024, 128) masked and not, (1, 2, 1024, 128), (4, 2, 4096,
    128) masked and ragged shapes; B1' at (4, 2, M 1024 / N 768, 128)
    masked, B 1 and ragged; B5 at two heads of 128 (the trained layer 0)
    at B 1, 4 and 16 x 1024, exact and shift 12, masked and not. Then what
    both bounds read for K1 at d 128 with one 32-key tile skipped (the
    scaled bound must fail it). Returns (errors, the inputs for timing)."""
    phase("5g the bf16 kernels at head_dim 128 (mp, two heads) against their "
          f"bf16 plain versions (|kernel - plain| <= {MP_REL:g} max(1, "
          "|plain|) and <= 2^-6 (|plain| + rms(plain row)))")
    g = torch.Generator(device="cuda").manual_seed(57)
    errs = {}

    def mask(b, n, p=0.85):
        m = torch.rand(b, n, generator=g, device="cuda") < p
        m[:, 0] = True
        if b > 1:
            m[1] = False  # batch entry 1 without a valid point
        return m

    def note(name, label, got, ref, rows=None):
        mp_check(errs, name, label, got, ref, rows)
        print(f"    {differ_share(got, ref):.2e} of the outputs not equal",
              flush=True)

    inputs = {}
    for shift, name in ((None, "flash_sdpa_bf16_d128"),
                        (SHIFT, "flash_sdpa_shift_bf16_d128")):
        for b, nq, nk, masked in ((4, 1024, 1024, True),
                                  (4, 1024, 1024, False),
                                  (1, 1024, 1024, False),
                                  (4, 4096, 4096, True), (2, 65, 130, True),
                                  (2, 1, 1, True), (1, 130, 3, False)):
            q, k, v = (rand(g, b, 2, n, 128).to(BF16) for n in (nq, nk, nk))
            mk = mask(b, nk) if masked else None
            inputs.setdefault((b, nq, masked), (q, k, v, mk))
            got = flash.flash_sdpa(q, k, v, mk, shift=shift)
            same(f"{name} {(b, nq, nk)}", (got,),
                 (flash.flash_sdpa(q, k, v, mk, shift=shift),))
            note(name, f"{name} {(b, 2, nq, nk)}{' masked' if masked else ''}",
                 got, flash.flash_sdpa_plain(q, k, v, mk, shift))
    q, k, v, mk = inputs[(4, 4096, True)]
    for shift in (None, SHIFT):
        ref = flash.flash_sdpa_plain(q, k, v, mk, shift)
        drop = mk.clone()
        drop[:, 32:64] = False
        bad = flash.flash_sdpa_plain(q, k, v, drop, shift)
        rel, _ = rel_err(bad, ref)
        scaled = scaled_err(bad, ref)
        print(f"  bound reach{'' if shift is None else ' shift 12'}: K1 "
              f"(4,2,4096,128), a 32-key tile skipped: {rel / MP_REL:.3f} of "
              f"MP_REL's bound, {scaled:.3f} of the scaled bound", flush=True)
        if not scaled > 1.0:
            raise AssertionError("d 128: the scaled bound cannot fail a "
                                 "skipped key tile")
    for b, m, n in ((4, 1024, 768), (1, 1024, 768), (2, 65, 130), (1, 130, 3)):
        qk0, v0 = (rand(g, b, 2, m, 128).to(BF16) for _ in range(2))
        qk1, v1 = (rand(g, b, 2, n, 128).to(BF16) for _ in range(2))
        va0, va1 = mask(b, m), mask(b, n)
        inputs.setdefault(("pair", b), (qk0, qk1, v0, v1, va0, va1))
        for masks in ((va0, va1), (None, None)):
            got = flash.flash_cross_pair(qk0, qk1, v0, v1, *masks)
            same(f"flash_cross_pair_bf16 B {b}", got,
                 flash.flash_cross_pair(qk0, qk1, v0, v1, *masks))
            ref = flash.flash_cross_pair_plain(qk0, qk1, v0, v1, *masks)
            for i, va in ((0, masks[0]), (1, masks[1])):
                rows = None if va is None else va[:, None, :].expand(-1, 2, -1)
                note("flash_cross_pair_bf16",
                     f"flash_cross_pair_bf16 B {b}, M {m} / N {n}"
                     f"{' masked' if va is not None else ''}, m{i}"
                     f"{', valid rows' if va is not None else ''}",
                     got[i], ref[i], rows)
    layer = nn.params_to(nn.index_params(params2["transformers"], 0), "cuda")
    w5 = {shift: flash_self.prepare(layer["self_attn"], 2, shift, mp=True)
          for shift in (None, SHIFT)}
    for b in BLOCK_BATCHES:
        x = rand(g, b, 1024, 256).to(BF16)
        ang = torch.rand(b, 1, 1024, 64, generator=g, device="cuda") * 6 - 3
        enc = torch.stack([ang.cos(), ang.sin()])
        valid = mask(b, 1024)
        inputs[("b5", b)] = (x, enc)
        for shift, w in w5.items():
            for mk in (None, valid):
                got = flash_self.fused_self_block(w, x, enc, mk)
                same(f"fused_self_block_bf16_d128 B {b}", (got,),
                     (flash_self.fused_self_block(w, x, enc, mk),))
                note("fused_self_block_bf16_d128",
                     f"fused_self_block_bf16_d128 2 x 128 {(b, 1024, 256)}"
                     f"{'' if shift is None else ' shift 12'}"
                     f"{' masked' if mk is not None else ''}", got,
                     flash_self.fused_self_block_plain(w, x, enc, mk))
    torch.cuda.synchronize()
    inputs["w5"] = w5
    inputs["w5_32"] = flash_self.prepare(layer["self_attn"], 2, None)
    return errs, inputs


def mp_head128_rows(hx):
    """Phase 5g's timing rows, in mp_rows' form: K1 at d 128 (B 4 and B 1
    at 1024 keys, B 4 at 4096 masked; shift 12 at B 4), B1' (B 4 and B 1,
    M 1024 / N 768; the library: two SDPA calls in bf16), B5 at two heads
    of 128 at B 1, 4 and 16. The bound counts bf16 elements at 2 bytes."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}

    def bias(mk, b, n):
        return (torch.zeros(b, 1, 1, n, device="cuda", dtype=BF16)
                if mk is None else flash.key_bias(mk).to(BF16)[:, None, None, :])

    for key, label, shift in (((4, 1024, False), "", None),
                              ((1, 1024, False), " B 1", None),
                              ((4, 4096, True), " (4,2,4096,128) masked", None),
                              ((4, 1024, False), "", SHIFT)):
        q, k, v, mk = hx[key]
        b, _, n, _ = q.shape
        q32, k32, v32 = q.float(), k.float(), v.float()
        kb = bias(mk, b, n)
        name = ("flash_sdpa_bf16_d128" if shift is None
                else "flash_sdpa_shift_bf16_d128") + label
        rows[name] = (
            lambda q=q, k=k, v=v, mk=mk, s=shift: flash.flash_sdpa(q, k, v, mk, shift=s),
            lambda q=q, k=k, v=v, mk=mk, s=shift: flash.flash_sdpa_plain(q, k, v, mk, s),
            lambda a=(q32, k32, v32, mk), s=shift: flash.flash_sdpa(*a, shift=s),
            ("SDPA bf16", lambda q=q, k=k, v=v, kb=kb: sdpa(q, k, v, attn_mask=kb)),
            (4 * b * 2 * n * n * 128, 4 * b * 2 * n * 128 * 2
             + (0 if mk is None else b * n)))
    for b, label in ((4, ""), (1, " B 1")):
        qk0, qk1, v0, v1, va0, va1 = hx[("pair", b)]
        a32 = (qk0.float(), qk1.float(), v0.float(), v1.float(), va0, va1)
        m, n = qk0.shape[2], qk1.shape[2]
        b0, b1 = bias(va0, b, m), bias(va1, b, n)
        rows["flash_cross_pair_bf16" + label] = (
            lambda a=(qk0, qk1, v0, v1, va0, va1): flash.flash_cross_pair(*a),
            lambda a=(qk0, qk1, v0, v1, va0, va1): flash.flash_cross_pair_plain(*a),
            lambda a=a32: flash.flash_cross_pair(*a),
            ("2 SDPA bf16", lambda a=(qk0, qk1, v0, v1, b0, b1): (
                sdpa(a[0], a[1], a[3], attn_mask=a[5]),
                sdpa(a[1], a[0], a[2], attn_mask=a[4]))),
            (2 * 4 * b * 2 * m * n * 128,
             3 * b * 2 * (m + n) * 128 * 2 + b * (m + n) * 2
             + b * 2 * (m + n) * 128 * 2))
    n, d, f = 1024, 256, 4
    ffn_w = (2 * d * 2 * d + 2 * d * d) * 2 + (3 * 2 * d + d) * f
    tail_w = (d * d) * 2 + d * f + ffn_w
    w5, w5_32 = hx["w5"][None], hx["w5_32"]
    for b in BLOCK_BATCHES:
        xx, enc = hx[("b5", b)]
        x32 = xx.float()
        r5 = b * n
        rows["fused_self_block_bf16_d128" + ("" if b == 4 else f" B {b}")] = (
            lambda xx=xx, enc=enc: flash_self.fused_self_block(w5, xx, enc),
            lambda xx=xx, enc=enc: flash_self.fused_self_block_plain(w5, xx, enc),
            lambda x32=x32, enc=enc: flash_self.fused_self_block(w5_32, x32, enc),
            None,
            (b * (2 * n * d * 3 * d + 4 * 2 * n * n * 128 + 2 * n * d * d
                  + 2 * n * (2 * d * 2 * d + 2 * d * d)),
             2 * r5 * d * 2 + 2 * r5 * 64 * f + d * 3 * d * 2 + 3 * d * f
             + tail_w))
    return rows


def mp_head128_timing_phase(hx):
    """Phase 5g timing: each d-128 bf16 row beside its plain version, its
    fp32 form on the same values and the library call (CUDA events,
    plain, kernel, fp32, fp32, kernel, plain; device time by CUDA graphs,
    kernel, fp32, fp32, kernel, and the library). Returns ({row: (kernel
    ms, plain ms, library ms)}, {row: (FLOPs, bytes)}, {row: (device ms,
    library device ms)})."""
    phase("5g timing: the bf16 kernels at head_dim 128 beside their plain "
          "versions, fp32 forms and SDPA in bf16 (CUDA events; device time "
          "by CUDA graphs)")
    times, bounds, graph_times = {}, {}, {}
    for name, (kern, plain, f32, lib, bound) in mp_head128_rows(hx).items():
        a, b, c, d, e, g = (time_cuda(fn, iters=10) for fn in
                            (plain, kern, f32, f32, kern, plain))
        lib_ms = None if lib is None else time_cuda(lib[1], iters=10)
        kd, fd, fd2, kd2 = (attn_split.graph_ms(fn, calls=10)
                            for fn in (kern, f32, f32, kern))
        lib_dev = None if lib is None else attn_split.graph_ms(lib[1], calls=10)
        times[name] = ((b + e) / 2, (a + g) / 2, lib_ms)
        bounds[name] = bound
        graph_times[name] = ((kd + kd2) / 2, lib_dev)
        t_ops, t_bytes = bound[0] / PEAK_BF16 * 1e3, bound[1] / PEAK_BYTES * 1e3
        print(f"  {name}: kernel {(b + e) / 2:.4f} ms, plain {(a + g) / 2:.4f}"
              f" ms, fp32 form {(c + d) / 2:.4f} ms (runs {b:.4f}/{e:.4f}, "
              f"{a:.4f}/{g:.4f}, {c:.4f}/{d:.4f})"
              + ("" if lib is None else f", library ({lib[0]}) {lib_ms:.4f} ms")
              + f"; device time: kernel {(kd + kd2) / 2:.4f}, fp32 form "
              f"{(fd + fd2) / 2:.4f}"
              + ("" if lib is None else f", library {lib_dev:.4f}")
              + f" ms; bound {max(t_ops, t_bytes):.4f} ms ("
              f"{'operations' if t_ops >= t_bytes else 'bytes'}; bf16 "
              f"operations {t_ops:.4f}, bytes {t_bytes:.4f})", flush=True)
    return times, bounds, graph_times


def mp_head128_path_phase(params2, sp_params):
    """Phase 5g main paths: the two-head matcher at mp (the trained layers
    regrouped) through pipeline.LightGlue in MP_HEAD128_PATHS'
    configurations (B 1 and B 16 at 1024 keypoints), BatchMatcher (CUDA
    graphs, adaptive, shift 12, buckets 1024 and 4096: every replay equal
    to the bit to the eager forward) and match_pair from generated images:
    the d-128 bf16 kernels launched and no fp32 matcher kernel, B6 or K2;
    one pair of each against the CPU port at mp (matches0 >= MP_AGREE,
    the same stop). Returns the launch counts."""
    total = dict.fromkeys(KERNELS, 0)
    rng = np.random.default_rng(77)
    data = {}
    for bsz in (1, 16):
        pr = planted_pairs(rng, bsz, 1024)
        data[bsz] = (pr, {"image0": feats(pr, 0), "image1": feats(pr, 1)})

    def tally(label, counts, must):
        print(f"  launch counts: { {k: c for k, c in counts.items() if c} }")
        for k in must:
            if counts[k] < 1:
                raise AssertionError(f"{label}: {k} was not launched")
        for k in NOT_HEAD128_MP:
            if counts[k]:
                raise AssertionError(f"{label}: {k} was launched")
        for k, c in counts.items():
            total[k] += c

    def against_cpu(label, out, cpu):
        agree = float((cpu["matches0"] == out["matches0"]).mean())
        print(f"  {label} against the CPU port at mp: matches0 agreement "
              f"{agree:.6f}, stop {out['stop']} vs {cpu['stop']}, score diff "
              f"{score_gap(out, cpu):.2e}", flush=True)
        if agree < MP_AGREE or cpu["stop"] != out["stop"]:
            raise AssertionError(f"{label}: the card disagrees with the CPU "
                                 "port")

    for label, c, must in MP_HEAD128_PATHS:
        phase(f"5g main path at mp, two heads of 128: pipeline.LightGlue("
              f"mp=True, num_heads=2), {label}, 1024 keypoints")
        gpu = LightGlue("superpoint", params=params2, device="cuda", mp=True,
                        **TWO_HEADS, **c)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        outs = {b: gpu(d) for b, (_, d) in data.items()}
        torch.cuda.synchronize()
        tally(label, _build.launch_counts(), must)
        for b, (pr, _) in data.items():
            k, p = precision(outs[b], pr["gt_matches0"])
            print(f"  B {b}: stop {outs[b]['stop']}, {k} matches, precision "
                  f"{p:.4f}")
            if p < MIN_PRECISION[2]:
                raise AssertionError(f"{label} B {b}: precision {p}")
        cpu = LightGlue("superpoint", params=params2, device="cpu", mp=True,
                        **TWO_HEADS, **c)(data[1][1])
        against_cpu(f"{label}, B 1", outs[1], cpu)
        del gpu

    phase("5g main path at mp, two heads of 128: BatchMatcher (CUDA graphs), "
          "adaptive, shift 12, buckets 1024 and 4096")
    conf = lightglue_config("superpoint", mp=True, **TWO_HEADS, **SHIFTED)
    bm = BatchMatcher(conf, params2, buckets=(1024, 4096), max_batch=16)
    pr = planted_pairs(rng, 2, 1000)
    big = planted_pairs(rng, 1, 3000)
    pairs = [tuple({k: v[i] for k, v in feats(pr, s).items()} for s in (0, 1))
             for i in range(2)]
    pairs.append(tuple({k: v[0] for k, v in feats(big, s).items()}
                       for s in (0, 1)))
    bm.warmup([1, 2])
    for chunk, f0, f1 in bm.padded_batches(pairs):
        got, ref = bm.match_batch(f0, f1), eager_forward(bm, f0, f1)
        differ = [f for f in graphs.OUTPUTS
                  if not np.array_equal(getattr(got, f), getattr(ref, f))]
        print(f"  bucket {f0['keypoints'].shape[1]}, batch {len(chunk)}: graph "
              f"replay {'equal to the bit to' if not differ else 'DIFFERS from'}"
              f" eager lg.forward, stop {got.stop} vs {ref.stop}")
        if differ or got.stop != ref.stop:
            raise AssertionError(f"two heads at mp: the graphs and the eager "
                                 f"forward differ in {differ}")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    res = bm.match_pairs(pairs)
    torch.cuda.synchronize()
    tally("BatchMatcher at mp, two heads", _build.launch_counts(),
          ("fused_self_block_bf16_d128", "flash_sdpa_shift_bf16_d128",
           "flash_cross_pair_bf16", "fused_ffn_residual_bf16"))
    (_, f0, f1), = bm.padded_batches(pairs[:1])
    cpu = BatchMatcher(conf, params2, buckets=(1024, 4096), max_batch=16,
                       device="cpu").match_batch(f0, f1)
    got = bm.match_batch(f0, f1)
    against_cpu("BatchMatcher pair 0 (batch 1)",
                {"matches0": got.matches0, "stop": got.stop,
                 "matching_scores0": got.matching_scores0,
                 "matching_scores1": got.matching_scores1},
                {"matches0": cpu.matches0, "stop": cpu.stop,
                 "matching_scores0": cpu.matching_scores0,
                 "matching_scores1": cpu.matching_scores1})
    print(f"  stops {[r['stop'] for r in res]}")
    del bm

    phase("5g main path at mp, two heads of 128: images -> SuperPoint -> "
          "LightGlue('superpoint', mp=True, num_heads=2) (match_pair), 2048 "
          "keypoints")
    a, b, _ = image_pair(np.random.default_rng(23), H, W)
    ext = SuperPoint(params=sp_params, device="cuda")
    matcher = LightGlue("superpoint", params=params2, device="cuda", mp=True,
                        **TWO_HEADS)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    f0, f1, m = match_pair(ext, matcher, a, b)
    torch.cuda.synchronize()
    tally("match_pair, two heads at mp", _build.launch_counts(),
          ("fused_self_block_bf16_d128", "flash_cross_pair_bf16",
           "fused_filter_matches"))
    check_pair_output(f"match_pair {H}x{W}, two heads at mp", f0, f1, m,
                      (W, H), (W, H))
    cpu = LightGlue("superpoint", params=params2, device="cpu", mp=True,
                    **TWO_HEADS)({"image0": {k: v[None] for k, v in f0.items()},
                                  "image1": {k: v[None] for k, v in f1.items()}})
    against_cpu("match_pair, the same features",
                m, {k: v[0] if isinstance(v, np.ndarray) else v
                    for k, v in cpu.items()})
    return total


# --- phase 5h: two-stage compaction ---------------------------------------------


# the JAX bench's headline configuration at 1024 keypoints: prefix 3, bucket
# 640 (benchmarks/compaction_accuracy.json, bench.py:194), shift 12
TWOSTAGE = dict(compaction_bucket=640, compaction_prefix=3, **SHIFTED)


def twostage_serving(params, pr, pairs, tag, mode, conf, total):
    """Phase 5h's BatchMatcher part for one configuration: B 8 and B 1 of
    ``pairs`` through the two-stage graph set, each replay equal to the
    bit to the eager forward, the batch of one against the CPU port
    (matches0 equal in fp32, >= MP_AGREE at mp; the same stop); its
    launch counts added to ``total``."""
    phase(f"5h main path: two-stage compaction ({tag}, {mode}, prefix 3, "
          "bucket 640, shift 12), BatchMatcher (CUDA graphs) at 1024 "
          "keypoints, B 8 and B 1")
    bm = BatchMatcher(conf, params, buckets=(1024,), max_batch=8)
    t0 = time.perf_counter()
    bm.warmup([1, 8])
    gs = bm._matcher.sets[graphs.Signature(8, 1024, 1024, True, False)]
    print(f"  warmup {time.perf_counter() - t0:.1f} s; graph set: "
          f"{len(gs.segments)} layer graphs (prefix {gs.prefix} at 1024, the "
          f"suffix at {gs.states[-1].desc0.shape[1]}), {len(gs.compaction)} "
          f"compaction graph, {len(gs.exits)} exits")
    if gs.prefix != 3 or gs.states[-1].desc0.shape[1] != 640:
        raise AssertionError("the graph set is not two-stage")
    for sel in (pairs, pairs[:1]):
        (_, f0, f1), = bm.padded_batches(sel)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = bm.match_batch(f0, f1)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        print(f"  launch counts: { {k: c for k, c in counts.items() if c} }")
        for k, c in counts.items():
            total[k] += c
        ref = eager_forward(bm, f0, f1)
        differ = [f for f in graphs.OUTPUTS
                  if not np.array_equal(getattr(got, f), getattr(ref, f))]
        hits = precision({"matches0": got.matches0[0]}, pr["gt_matches0"][0])
        print(f"  B {len(sel)}: replay {'equal to the bit to' if not differ else 'DIFFERS from'}"
              f" eager lg.forward, stop {got.stop} vs {ref.stop}; pair 0 "
              f"{hits[0]} matches, precision {hits[1]:.4f}", flush=True)
        if differ or got.stop != ref.stop:
            raise AssertionError(f"two-stage {tag} {mode}: the graphs and the "
                                 f"eager forward differ in {differ}")
        if hits[1] < MIN_PRECISION[4]:
            raise AssertionError(f"two-stage {tag} {mode}: precision {hits[1]}")
    want = BatchMatcher(conf, params, buckets=(1024,), max_batch=8,
                        device="cpu").match_batch(f0, f1)  # B 1
    agree = float((got.matches0 == want.matches0).mean())
    print(f"  B 1 against the CPU port: matches0 agreement {agree:.6f}, stop "
          f"{got.stop} vs {want.stop}, prune differs at "
          f"{int((got.prune0 != want.prune0).sum())} points", flush=True)
    if agree < (1.0 if tag == "fp32" else MP_AGREE) or got.stop != want.stop:
        raise AssertionError(f"two-stage {tag} {mode}: the card disagrees "
                             "with the CPU port")


def twostage_path_phase(params, sp_params):
    """Phase 5h: two-stage compaction (prefix 3, bucket 640, shift 12) at
    1024 keypoints, fp32 and mp, through BatchMatcher (CUDA graphs: the
    prefix layers at 1024, one compaction graph, the suffix at 640; B 8
    and B 1 of planted pairs, adaptive and with width pruning only, every
    replay equal to the bit to the eager forward, matches0 equal to the
    CPU port's: twostage_serving) and make_end_to_end
    (SuperPoint at B 8, the card's matcher output against the CPU port's
    on the card's features). Returns the launch counts."""
    total = dict.fromkeys(KERNELS, 0)
    rng = np.random.default_rng(79)
    pr = planted_pairs(rng, 8, 1024)
    pairs = [tuple({k: v[i] for k, v in feats(pr, s).items()} for s in (0, 1))
             for i in range(8)]
    imgs = [image_pair(rng, H, W) for _ in range(8)]
    im0, im1 = (torch.from_numpy(np.stack([p[i] for p in imgs]))[..., None].cuda()
                for i in (0, 1))
    sizes = torch.tensor([[W, H]] * 8, dtype=torch.float32, device="cuda")
    for mp in (False, True):
        tag = "mp" if mp else "fp32"
        # the headline stops inside the prefix on these pairs; without the
        # depth exit every suffix layer runs at 640
        for mode, extra in (("adaptive", {}),
                            ("prune only", dict(depth_confidence=-1.0))):
            twostage_serving(params, pr, pairs, tag, mode,
                             lightglue_config("superpoint", mp=mp,
                                              **TWOSTAGE, **extra), total)
        phase(f"5h main path: two-stage compaction ({tag}), images -> "
              "SuperPoint -> LightGlue (make_end_to_end), B 8, 1024 keypoints")
        mconf = lightglue_config("superpoint", mp=mp, **TWOSTAGE)
        lgp = nn.params_to(params, "cuda")
        run = end_to_end.make_end_to_end(
            sp.forward, sp_params, SuperPointConfig(max_num_keypoints=1024,
                                                    mp=mp), lgp, mconf)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        e2e = run(im0, im1, sizes, sizes)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        print(f"  launch counts: { {k: c for k, c in counts.items() if c} }")
        for k, c in counts.items():
            total[k] += c
        valid = int(min(e2e.feats0.valid.sum(1).min(), e2e.feats1.valid.sum(1).min()))
        if not lg.twostage(mconf, 1024, 1024) or valid < 700:
            raise AssertionError(f"two-stage {tag}: {valid} keypoints")
        for i in range(8):
            check_pair_output(f"make_end_to_end two-stage {tag} pair {i}",
                              *e2e_feats(e2e, i), (W, H), (W, H))
        kw = dict(kpts0=e2e.feats0.keypoints, kpts1=e2e.feats1.keypoints,
                  desc0=e2e.feats0.descriptors, desc1=e2e.feats1.descriptors,
                  size0=sizes, size1=sizes, mask0=e2e.feats0.valid,
                  mask1=e2e.feats1.valid)
        # all eight pairs: the stop is the batch's
        with torch.inference_mode():
            want = lg.forward(params, mconf, **{k: v.cpu()
                                                 for k, v in kw.items()})
        agree = float((e2e.matches.matches0.cpu() == want.matches0)
                      .float().mean())
        print(f"  against the CPU port's matcher on the card's features: "
              f"matches0 agreement {agree:.6f}, stop {e2e.matches.stop} vs "
              f"{want.stop}", flush=True)
        if agree < (1.0 if not mp else MP_AGREE) \
                or e2e.matches.stop != want.stop:
            raise AssertionError(f"two-stage {tag} e2e: the card disagrees "
                                 "with the CPU port")
    return total


def serving_ms(bm, pairs, reps):
    """Host ms per BatchMatcher call on ``pairs`` (after two warm calls):
    the median and quartiles of ``reps`` calls, and the stop."""
    for _ in range(2):
        bm.match_pairs(pairs)
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = bm.match_pairs(pairs)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, res[0]["stop"]


def twostage_timing_phase(params, params2, sp_params):
    """Phase 5h timing (host clock, in turns): BatchMatcher at 1024
    keypoints, B 1 and B 16, shift 12, the masked adaptive forward against
    two-stage compaction (prefix 3, bucket 640), adaptive and with width
    pruning only, fp32 and mp; the two-head matcher at mp (fixed and
    adaptive) beside the four-head one; make_end_to_end (SuperPoint, B 8, 1024 keypoints,
    adaptive, shift 12) masked against two-stage, fp32 and mp."""
    phase("5h timing: BatchMatcher (CUDA graphs), 1024 keypoints, planted "
          "pairs, host clock per call, in turns: two-stage compaction and "
          "two heads at mp")
    rng = np.random.default_rng(89)
    for bsz, reps in ((1, 30), (16, 8)):
        pr = planted_pairs(rng, bsz, 1024)
        pairs = [tuple({k: v[i] for k, v in feats(pr, s).items()}
                       for s in (0, 1)) for i in range(bsz)]
        confs = {}
        for tag, mp in (("fp32", False), ("mp", True)):
            for mode, c in (("adaptive", {}),
                            ("prune only", dict(depth_confidence=-1.0))):
                confs[f"{tag}, {mode}, masked"] = (
                    params, dict(mp=mp, **SHIFTED, **c))
                confs[f"{tag}, {mode}, two-stage"] = (
                    params, dict(mp=mp, **TWOSTAGE, **c))
        confs["mp, two heads, adaptive"] = (params2, dict(
            mp=True, **TWO_HEADS, **SHIFTED))
        confs["mp, two heads, fixed"] = (params2, dict(
            mp=True, **TWO_HEADS, **SHIFTED, **FIXED))
        confs["mp, fixed"] = (params, dict(mp=True, **SHIFTED, **FIXED))
        bms = {}
        for label, (p, c) in confs.items():
            bms[label] = BatchMatcher(lightglue_config("superpoint", **c), p,
                                      buckets=(1024,), max_batch=16)
            bms[label].warmup([bsz])
        ms, stops = {label: [] for label in confs}, {}
        for label in list(confs) + list(confs)[::-1]:
            m, stops[label] = serving_ms(bms[label], pairs, reps)
            ms[label] += m
        for label, m in ms.items():
            q1, med, q3 = np.percentile(m, [25, 50, 75])
            print(f"  BatchMatcher shift 12, B {bsz}, {label}: "
                  f"{bsz * 1e3 / med:.1f} pairs/s (median {med:.2f} ms a call, "
                  f"quartiles {q1:.2f}-{q3:.2f}, {len(m)} calls, stop "
                  f"{stops[label]})", flush=True)
        del bms
        gc.collect()
        torch.cuda.empty_cache()
    phase("5h timing: make_end_to_end (SuperPoint, B 8, 768 x 1024, 1024 "
          "keypoints, adaptive, shift 12), masked against two-stage, in turns")
    imgs = [image_pair(rng, H, W) for _ in range(8)]
    im0, im1 = (torch.from_numpy(np.stack([p[i] for p in imgs]))[..., None].cuda()
                for i in (0, 1))
    sizes = torch.tensor([[W, H]] * 8, dtype=torch.float32, device="cuda")
    lgp = nn.params_to(params, "cuda")
    runs = {}
    for tag, mp in (("fp32", False), ("mp", True)):
        for form, c in (("masked", SHIFTED), ("two-stage", TWOSTAGE)):
            runs[f"{tag}, {form}"] = end_to_end.make_end_to_end(
                sp.forward, sp_params,
                SuperPointConfig(max_num_keypoints=1024, mp=mp), lgp,
                lightglue_config("superpoint", mp=mp, **c))
    ms, stops = {label: [] for label in runs}, {}
    for label in list(runs) + list(runs)[::-1]:
        run = runs[label]
        for _ in range(2):
            run(im0, im1, sizes, sizes)
        torch.cuda.synchronize()
        for _ in range(4):
            t0 = time.perf_counter()
            stops[label] = run(im0, im1, sizes, sizes).matches.stop
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t0) * 1e3)
    for label, m in ms.items():
        q1, med, q3 = np.percentile(m, [25, 50, 75])
        print(f"  make_end_to_end B 8, {label}: {8 * 1e3 / med:.1f} pairs/s "
              f"(median {med:.2f} ms a call, quartiles {q1:.2f}-{q3:.2f}, "
              f"{len(m)} calls, stop {stops[label]})", flush=True)


# --- phase 5f: keypoint margins -------------------------------------------------


def margin_phase(sp_params, ap):
    """Phase 5f margins: the keypoints that the card's extraction at mp
    keeps and the CPU port's at mp does not (and the reverse), SuperPoint
    (two 768 x 1024 images, 2048 keypoints) and ALIKED in MP_ALIKED_PATHS'
    configurations (one image, 2048), each with its margins against the
    top-k's cut and its NMS window's runner-up (scripts/keypoint_margins):
    the counts above 1, 2 and 4 steps of the score (one bf16 step, or what
    one bf16 step of SuperPoint's logits or of ALIKED's sigmoid input
    moves it) and of bf16 steps of the score alone. A keypoint that clears
    both margins by more than 4 steps of its score is a fault, and fails
    the run: SuperPoint's whole chain; ALIKED's with the outputs of its two
    deformable blocks taken from the CPU (every kernel and every other
    layer run on the card), its whole chain's count printed beside. The
    deformable blocks are held on their own: the card's deformable conv,
    given the CPU's input and offsets, equal to the CPU's to the bit."""
    rng = np.random.default_rng(83)
    imgs = [image_pair(rng, H, W)[0] for _ in range(2)]
    gray = torch.from_numpy(np.stack(imgs))[..., None]
    cases = [("SuperPoint", "superpoint", sp_params,
              SuperPointConfig(max_num_keypoints=2048, mp=True), gray)]
    cases += [(f"ALIKED {label}", "aliked", ap,
               ALIKEDConfig(max_num_keypoints=2048, mp=True, **cfg),
               torch.from_numpy(rgb(imgs[0]))[None])
              for label, cfg, _ in MP_ALIKED_PATHS]
    for label, kind, p, conf, img in cases:
        phase(f"5f keypoint margins at mp: {label}, the card against the CPU "
              "port")
        record = []
        with km.deformable_blocks(record=record):
            cpu = km.detection_maps(kind, nn.params_to(p, "cpu"), conf, img)
        card = km.detection_maps(kind, p, conf, img.cuda())
        args = (conf.max_num_keypoints, conf.detection_threshold,
                conf.nms_radius)
        m = km.unshared_margins(card, cpu, *args)
        moved = (card[0].cpu() - cpu[0]).abs()
        print(f"  {km.summary(m)}", flush=True)
        print(f"  score maps: |card - CPU| mean {float(moved.mean()):.3e}, "
              f"largest {float(moved.max()):.3e}, "
              f"{float((moved / cpu[2]).max()):.2f} steps of the score at "
              "most", flush=True)
        if kind == "aliked":
            with km.deformable_blocks(outputs=record[0][1]):
                card = km.detection_maps(kind, p, conf, img.cuda())
            m = km.unshared_margins(card, cpu, *args)
            moved = (card[0].cpu() - cpu[0]).abs()
            print(f"  blocks 3 and 4 from the CPU: {km.summary(m)}; score "
                  f"maps mean {float(moved.mean()):.3e}, largest "
                  f"{float(moved.max()):.3e}", flush=True)
            x3in = nn.avg_pool(record[0][0], 4)
            dp = nn.params_to(p, "cpu")["block3"]["conv1"]
            with torch.inference_mode(), nn.fp32_convs():
                off = nn.conv2d(dp["offset_conv"], x3in).clamp(
                    -max(x3in.shape[2:]) / 4.0, max(x3in.shape[2:]) / 4.0)
                rc = p["block3"]["conv1"]["regular_conv"]
                want = deform.deform_conv2d(x3in, off, dp["regular_conv"]["w"],
                                            dp["regular_conv"].get("b"))
                got = deform.deform_conv2d(x3in.cuda(), off.cuda(), rc["w"],
                                           rc.get("b")).cpu()
            print(f"  block 3's deformable conv on the card, given the CPU's "
                  f"input and offsets: equal to the bit "
                  f"{bool(torch.equal(got, want))}", flush=True)
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: the deformable conv differs")
        if km.faults(m["a"]) or km.faults(m["b"]):
            raise AssertionError(f"{label}: a keypoint lost beyond 4 steps "
                                 "of its score on both margins")


def main():
    smi = device_phase()
    build_phase()
    params = weights_lib.load_params(WEIGHTS)
    if sys.argv[1:] == ["--mesh"]:
        mesh_phase(params, superpoint_params(), smi)
        return
    if sys.argv[1:] == ["--weights"]:
        weights_phase(params, superpoint_params(), aliked_params(), smi)
        return
    if sys.argv[1:] == ["--profile"]:
        profile_phase(params)
        serving_profile_phase(params, superpoint_params())
        mp_profile_phase(params)
        train_profile_phase()
        return
    if sys.argv[1:]:
        raise SystemExit(f"unknown arguments {sys.argv[1:]}; see the docstring")
    params2 = two_head_params(params)
    x = kernel_inputs()
    bx = block_inputs(params)
    errs = kernel_phase(x)
    errs.update(block_phase(x, bx))
    h_errs, hx = head128_phase(bx)
    for name, err in (list(h_errs.items()) + list(split_phase().items())
                      + list(cross_assign_phase().items())):
        errs[name] = max(errs.get(name, 0.0), err)
    sp_params = superpoint_params()
    sp_errs, sx = sp_kernel_phase(sp_params)
    errs.update(sp_errs)
    al_params = aliked_params()
    al_errs, ax = aliked_kernel_phase(al_params)
    errs.update(al_errs)
    mx = mp_inputs(x, bx)
    errs.update(mp_kernel_phase(mx))
    h16_errs, hx16 = mp_head128_kernel_phase(params2)
    errs.update(h16_errs)
    for name, err in mp_tma_edge_phase(bx).items():
        errs[name] = max(errs.get(name, 0.0), err)
    e_errs, mx5 = mp_extract_kernel_phase(sp_params, al_params, ax)
    errs.update(e_errs)
    for name, err in edge_phase().items():
        errs[name] = max(errs[name], err)
    counts = main_path_phase(params, params2)
    traffic = {}
    for path in (lambda: extraction_path_phase(params, sp_params),
                 lambda: two_head_pair_phase(params2, sp_params),
                 lambda: aliked_path_phase(al_params, params),
                 lambda: disk_path_phase(params),
                 sift_path_phase,
                 doghardnet_path_phase,
                 gather_path_phase,
                 lambda: serving_phase(params, traffic),
                 lambda: sequence_phase(params, sp_params),
                 lambda: mp_matcher_phase(params),
                 lambda: mp_serving_phase(params),
                 lambda: mp_extraction_phase(sp_params),
                 lambda: mp_extract_path_phase(params, sp_params, al_params),
                 lambda: mp_head128_path_phase(params2, sp_params),
                 lambda: twostage_path_phase(params, sp_params),
                 lambda: mesh_phase(params, sp_params, smi),
                 lambda: weights_phase(params, sp_params, al_params, smi)):
        for k, c in path().items():
            counts[k] += c
    training_phase(params, traffic)
    margin_phase(sp_params, al_params)
    serving_memory_phase(params)
    times, graph_times = timing_phase(x, bx, hx, params, params2)
    sp_times, sp_graph = sp_timing_phase(sx, params, sp_params)
    times.update(sp_times)
    graph_times.update(sp_graph)
    al_times, al_graph = aliked_timing_phase(ax, al_params)
    times.update(al_times)
    graph_times.update(al_graph)
    serving_timing_phase(params, sp_params)
    disk_sift_timing_phase()
    mp_times, mp_bounds = mp_timing_phase(mx, x, bx, params)
    times.update(mp_times)
    e_times, e_bounds, e_graph = mp_extract_timing_phase(mx5, params, sp_params,
                                                         al_params)
    times.update(e_times)
    graph_times.update(e_graph)
    h_times, h_bounds, h_graph = mp_head128_timing_phase(hx16)
    times.update(h_times)
    graph_times.update(h_graph)
    twostage_timing_phase(params, params2, sp_params)
    kernels, bounds = [], {**kernel_bounds(), **mp_bounds, **e_bounds,
                           **h_bounds}
    # the tensor-core kernels: their 3xTF32 bound beside the fp32 one
    tc_rows = (ATTENTION_ROWS + BLOCK_ROWS + CROSS_ROWS + FFN_ROWS
               + CONV_ROWS + ("fused_aliked_stem",))
    rows = (("fused_self_block 2 x 128",) + tc_rows + ("simple_nms", "simple_nms r 2")
            + tuple(f"{k}{b}" for b in ("", " B 1", " B 8")
                    for k in ("score_head_lazy", "score_head_cplane")))
    for name in rows:
        flops, nbytes = bounds[name]
        dev = graph_times.get(name)
        print(f"  {name}: bound {max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3:.4f} ms"
              f" ({'operations' if flops / PEAK_FLOPS >= nbytes / PEAK_BYTES else 'bytes'}"
              f"; bytes {nbytes / PEAK_BYTES * 1e3:.4f})"
              + (f", 3xTF32 bound {3 * flops / PEAK_TF32 * 1e3:.4f} ms"
                 if name in tc_rows else "")
              + ("" if dev is None else
                 f", device time {dev[0]:.4f}"
                 + ("" if dev[1] is None else f" (library {dev[1]:.4f})"))
              + f", kernel {times[name][0]:.4f}, plain {times[name][1]:.4f}"
              + ("" if times[name][2] is None else f", library {times[name][2]:.4f}"))
    for name, (src, rep) in KERNELS.items():
        flops, nbytes = bounds[name]
        # fp32: the CUDA cores' peak; the bf16 forms: the bf16 tensor cores'
        # (B11's lerps the CUDA cores')
        t_ops, t_bytes = ops_ms(name, flops), nbytes / PEAK_BYTES * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": times[name][2],
            # the tensor-core bound of the redesigned kernels (3xTF32)
            "bound_3xtf32_ms": (3 * flops / PEAK_TF32 * 1e3
                                if name in tc_rows else None)})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
